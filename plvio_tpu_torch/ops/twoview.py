"""Two-view geometry of the mapping step (port of plvio_tpu/ops/twoview.py:
`triangulate_dlt` :146)."""
from __future__ import annotations

import torch


def triangulate_dlt(R: torch.Tensor, t: torch.Tensor, x1n: torch.Tensor,
                    x2n: torch.Tensor) -> torch.Tensor:
    """Batched DLT with P1 = [I|0], P2 = [R|t] on normalized coordinates
    [N,2] -> points [N,3] in the first camera's frame: the right singular
    vector of the smallest singular value of each 4x4 system (a batched
    SVD, as the reference's jnp.linalg.svd), dehomogenized with the same
    1e-12 guard."""
    P2 = torch.cat([R, t[:, None]], 1)                        # [3,4]
    n = x1n.shape[0]
    z = torch.zeros(n, dtype=x1n.dtype, device=x1n.device)
    one = torch.ones_like(z)
    row0 = torch.stack([-one, z, x1n[:, 0], z], -1)           # a0 e2 - e0
    row1 = torch.stack([z, -one, x1n[:, 1], z], -1)           # a1 e2 - e1
    row2 = x2n[:, 0:1] * P2[2] - P2[0]
    row3 = x2n[:, 1:2] * P2[2] - P2[1]
    A = torch.stack([row0, row1, row2, row3], 1)              # [N,4,4]
    _, _, Vh = torch.linalg.svd(A)
    X = Vh[:, -1]
    w = X[:, 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[:, :3] / w[:, None]
