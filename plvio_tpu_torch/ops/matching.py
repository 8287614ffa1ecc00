"""Descriptor matching (port of plvio_tpu/ops/matching.py; the epipolar
gate of plvio_tpu/models/kernels.py:845-867, the line pair gate of
`make_line_pair_matcher` :618-631 and `rotation_histogram_filter` :115).

The port keeps binary descriptors PACKED: [N,8] torch.int32 holding the
same bits as the reference's uint32 rows (`pack_bits_u32`): bit j of word
w is descriptor bit 32w+j.  The plain versions below unpack to +-1 and use
the reference's matmul form; `hamming_match` is the hand-written CUDA
kernel (csrc/hamming_match.cu) for the fused gate + popcount + ratio test +
mutual check, which never forms the N x M matrix; `rot_hist` is the
hand-written CUDA kernel (csrc/epipolar_match.cu) of the rotation
histogram filter, beside its plain version
`rotation_histogram_filter`.  `hamming_dist` is `hamming_match`'s matrix
mode: the whole distance matrix, which the loop closer reads on the
host.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import cuda

DESC_BITS = 256
_SHIFTS = torch.arange(32, dtype=torch.int64)
# float32 1.2 ** octave as the reference computes it (jnp.power of the
# float32 octave): the octave scale of the projection and stereo gates
OCTAVE_SCALE = np.float32(np.float64(np.float32(1.2)) ** np.arange(8))


def pack_bits_u32(pm1_or_bits: torch.Tensor) -> torch.Tensor:
    """[...,256] descriptor ({-1,+1} or {0,1}) -> [...,8] int32 packed."""
    bits = (pm1_or_bits > 0).to(torch.int64)
    b = bits.reshape(bits.shape[:-1] + (8, 32))
    words = (b << _SHIFTS.to(b.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_u32_to_pm1(packed: torch.Tensor) -> torch.Tensor:
    """[...,8] int32 packed -> [...,256] float32 {-1,+1}."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> _SHIFTS.to(packed.device)) & 1
    bits = bits.reshape(packed.shape[:-1] + (DESC_BITS,))
    return bits.to(torch.float32) * 2.0 - 1.0


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances [N,M] float32 from {-1,+1} descriptors
    (exact: the float32 dot of +-1 vectors is an integer below 2^24)."""
    return 0.5 * (DESC_BITS - desc_a @ desc_b.T)


def match_nn_ratio(dist: torch.Tensor, valid_a: torch.Tensor,
                   valid_b: torch.Tensor, gate: Optional[torch.Tensor] = None,
                   max_dist: float = 50.0, ratio: float = 0.9,
                   mutual: bool = True):
    """Nearest neighbour with Lowe ratio test and mutual check on a
    distance matrix; first index on ties (torch.argmin's documented rule,
    as jnp.argmin).  Returns (idx_b [N] int32, ok [N] bool)."""
    mask = valid_a[:, None] & valid_b[None, :]
    if gate is not None:
        mask = mask & gate
    d = torch.where(mask, dist, torch.full_like(dist, 1e9))
    idx1 = torch.argmin(d, dim=1)
    best1 = torch.gather(d, 1, idx1[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    d2 = torch.where(cols[None, :] == idx1[:, None],
                     torch.full_like(d, 1e9), d)
    best2 = d2.min(dim=1).values
    ok = (best1 <= max_dist) & (best1 < ratio * best2)
    if mutual:
        idx_back = torch.argmin(d, dim=0)
        ok = ok & (idx_back[idx1] == torch.arange(d.shape[0],
                                                  device=d.device))
    return idx1.to(torch.int32), ok


def window_gate(uv_a: torch.Tensor, uv_b: torch.Tensor,
                radius: float) -> torch.Tensor:
    """[N,2] x [M,2] -> bool [N,M] of pairs within `radius`."""
    d2 = ((uv_a[:, None, :] - uv_b[None, :, :]) ** 2).sum(-1)
    return d2 <= radius ** 2


def line_gate(mid_a: torch.Tensor, ang_a: torch.Tensor, mid_b: torch.Tensor,
              ang_b: torch.Tensor, radius: float,
              angle_tol: float) -> torch.Tensor:
    """Midpoint-window and angle gate of the line projection match
    (plvio_tpu/models/kernels.py:377-380)."""
    d2 = ((mid_a[:, None] - mid_b[None, :]) ** 2).sum(-1)
    dang = torch.remainder(torch.abs(ang_a[:, None] - ang_b[None, :]),
                           torch.pi)
    dang = torch.minimum(dang, torch.pi - dang)
    return (d2 < radius ** 2) & (dang < angle_tol)


def _seg_mid_len(ep: torch.Tensor):
    """Midpoints [N,2] and lengths [N] of segments ep [N,4] = (xs, ys, xe,
    ye), in the reference's operation order."""
    mid = (ep[:, :2] + ep[:, 2:]) / 2
    d = ep[:, 2:] - ep[:, :2]
    return mid, torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])


def line_pair_gate(ep_a: torch.Tensor, ang_a: torch.Tensor,
                   ep_b: torch.Tensor, ang_b: torch.Tensor, radius: float,
                   angle_tol: float) -> torch.Tensor:
    """[N,4] x [M,4] segments -> bool [N,M]: the gates of the keyframe line
    pair matcher (plvio_tpu/models/kernels.py:618-631): squared midpoint
    distance < radius^2, wrapped angle difference < angle_tol, length ratio
    len_a / max(len_b, 1e-6) in (0.5, 2) and both lengths > 40 px."""
    mid_a, len_a = _seg_mid_len(ep_a)
    mid_b, len_b = _seg_mid_len(ep_b)
    d2 = ((mid_a[:, None] - mid_b[None, :]) ** 2).sum(-1)
    dang = torch.remainder(torch.abs(ang_a[:, None] - ang_b[None, :]),
                           torch.pi)
    dang = torch.minimum(dang, torch.pi - dang)
    lr = len_a[:, None] / torch.clamp_min(len_b[None, :], 1e-6)
    return (d2 < radius ** 2) & (dang < angle_tol) & (lr > 0.5) \
        & (lr < 2.0) & (len_a[:, None] > 40.0) & (len_b[None, :] > 40.0)


def epipolar_gate(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                  th: torch.Tensor) -> torch.Tensor:
    """[N,2] x [M,2] -> bool [N,M]: the distance of each uv2 to the
    epipolar line F (uv1, 1) below th [M] (the reference's `d_epi < th`,
    models/kernels.py:852-867), in the operation order of the kernel's
    epipolar mode."""
    x, y = uv1[:, 0], uv1[:, 1]
    l0 = (F[0, 0] * x + F[0, 1] * y) + F[0, 2]
    l1 = (F[1, 0] * x + F[1, 1] * y) + F[1, 2]
    l2 = (F[2, 0] * x + F[2, 1] * y) + F[2, 2]
    den = torch.clamp_min(torch.sqrt(l0 * l0 + l1 * l1), 1e-9)
    num = torch.abs((l0[:, None] * uv2[None, :, 0]
                     + l1[:, None] * uv2[None, :, 1]) + l2[:, None])
    return num / den[:, None] < th[None, :]


def rotation_histogram_filter(angles_a: torch.Tensor, angles_b: torch.Tensor,
                              idx_b: torch.Tensor, ok: torch.Tensor,
                              n_bins: int = 30,
                              keep_top: int = 3) -> torch.Tensor:
    """Keep the matches whose orientation difference (angles in degrees)
    falls in the `keep_top` fullest of `n_bins` bins, each at least 10% of
    the fullest (ORBmatcher HISTO_LENGTH and ComputeThreeMaxima).  Ties
    among equal counts go to the lower bin, as lax.top_k orders them.
    The plain version of `rot_hist`; returns the updated ok [N]."""
    rot = angles_a - angles_b[idx_b.long()]
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.clamp((rot / (360.0 / n_bins)).to(torch.int32), 0,
                       n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.int64, device=ok.device)
    hist.scatter_add_(0, bins, ok.long())
    vals, order = torch.sort(hist, descending=True, stable=True)
    thresh = 0.1 * vals[0].to(torch.float32)
    keep = torch.zeros(n_bins, dtype=torch.bool, device=ok.device)
    keep[order[:keep_top]] = vals[:keep_top].to(torch.float32) >= thresh
    return ok & keep[bins]


# --------------------------------------------------------------------------
# Kernel 3: hamming_match
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
HAMMING_MATCH = cuda.Kernel(
    "hamming_match", "hamming_match",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
     _P, _P, _P, _P])


def hamming_match_plain(map_desc, obs_desc, row_ok, col_ok, a_xy, b_xy,
                        radius, max_dist, ratio, a_ang=None, b_ang=None,
                        angle_tol=None, epi_F=None, epi_th=None,
                        pair: bool = False):
    """Plain PyTorch version of `hamming_match` (the reference's
    unpack + matmul + dense gate + match_nn_ratio)."""
    dist = hamming_matrix(unpack_u32_to_pm1(map_desc),
                          unpack_u32_to_pm1(obs_desc))
    if epi_F is not None:
        gate = epipolar_gate(epi_F, a_xy, b_xy, epi_th)
    elif pair:
        gate = line_pair_gate(a_xy, a_ang, b_xy, b_ang, radius, angle_tol)
    elif a_ang is None:
        gate = window_gate(a_xy, b_xy, radius)
    else:
        gate = line_gate(a_xy, a_ang, b_xy, b_ang, radius, angle_tol)
    return match_nn_ratio(dist, row_ok, col_ok, gate, max_dist=max_dist,
                          ratio=ratio, mutual=True)


def hamming_match(map_desc, obs_desc, row_ok, col_ok, a_xy, b_xy,
                  radius: float, max_dist: float, ratio: float,
                  a_ang=None, b_ang=None, angle_tol=None, epi_F=None,
                  epi_th=None, pair: bool = False):
    """Gated Hamming nearest neighbour with ratio test and mutual check.

    map_desc [N,8] / obs_desc [M,8] int32 packed; row_ok [N] / col_ok [M]
    bool; a_xy [N,2] / b_xy [M,2] float32 predicted / observed positions.
    Point gate (a_ang None): squared distance <= radius^2.  Line gate
    (a_ang [N], b_ang [M], angle_tol): squared midpoint distance < radius^2
    and wrapped angle difference < angle_tol.  Epipolar gate (epi_F
    [3,3] float32 fundamental matrix, epi_th [M] thresholds; radius
    unused): the distance of b_xy to the epipolar line of a_xy < epi_th.
    Line pair gate (pair True; a_xy [N,4] / b_xy [M,4] are segment
    endpoints, a_ang / b_ang their angles): `line_pair_gate`.
    Returns (idx [N] int32, ok [N] bool); idx 0 where no column admits.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if map_desc.device.type == "cpu":
        return hamming_match_plain(map_desc, obs_desc, row_ok, col_ok, a_xy,
                                   b_xy, radius, max_dist, ratio, a_ang,
                                   b_ang, angle_tol, epi_F, epi_th, pair)
    epi = epi_F is not None
    line = a_ang is not None and not epi
    mode = 2 if epi else 3 if pair else int(line)
    n, m = map_desc.shape[0], obs_desc.shape[0]
    ts = [map_desc, obs_desc, row_ok, col_ok, a_xy, b_xy]
    if line:
        ts += [a_ang, b_ang]
    if epi:
        ts += [epi_F, epi_th]
    cuda.check_cuda("hamming_match", *ts)
    if map_desc.dtype != torch.int32 or obs_desc.dtype != torch.int32 \
            or map_desc.shape[1:] != (8,) or obs_desc.shape[1:] != (8,):
        raise ValueError("hamming_match: descriptors must be [*,8] int32")
    if row_ok.dtype != torch.bool or col_ok.dtype != torch.bool \
            or row_ok.shape != (n,) or col_ok.shape != (m,):
        raise ValueError("hamming_match: row_ok [N] / col_ok [M] bool")
    w = 4 if pair else 2
    if a_xy.dtype != torch.float32 or b_xy.dtype != torch.float32 \
            or a_xy.shape != (n, w) or b_xy.shape != (m, w):
        raise ValueError(f"hamming_match: a_xy [N,{w}] / b_xy [M,{w}] "
                         "float32")
    if pair and not line:
        raise ValueError("hamming_match: the line pair gate needs angles")
    if line and (a_ang.shape != (n,) or b_ang.shape != (m,)
                 or a_ang.dtype != torch.float32
                 or b_ang.dtype != torch.float32):
        raise ValueError("hamming_match: a_ang [N] / b_ang [M] float32")
    if epi and (epi_F.shape != (3, 3) or epi_th.shape != (m,)
                or epi_F.dtype != torch.float32
                or epi_th.dtype != torch.float32):
        raise ValueError("hamming_match: epi_F [3,3] / epi_th [M] float32")
    if n >= 1 << 16 or m > (2800 if pair else 3600):
        # row ids share a 32-bit word with the distance; the columns'
        # positions, angles, flags (and lengths) fit the 48 KB of dynamic
        # shared memory a block gets without opting in
        raise ValueError("hamming_match: needs N < 65536 rows and "
                         "M <= 3600 columns (2800 for line pairs)")
    idx = torch.empty(n, dtype=torch.int32, device=map_desc.device)
    ok = torch.empty(n, dtype=torch.bool, device=map_desc.device)
    if n == 0:
        return idx, ok
    col_best = torch.empty(max(m, 1), dtype=torch.int32,
                           device=map_desc.device)
    HAMMING_MATCH.launch(
        cuda.ptr(map_desc), cuda.ptr(obs_desc), cuda.ptr(row_ok),
        cuda.ptr(col_ok), cuda.ptr(a_xy), cuda.ptr(b_xy),
        cuda.ptr(a_ang) if line else None,
        cuda.ptr(epi_th) if epi else (cuda.ptr(b_ang) if line else None),
        cuda.ptr(epi_F) if epi else None,
        n, m, mode, float(radius) ** 2,
        float(angle_tol) if line else 0.0, float(max_dist), float(ratio),
        cuda.ptr(idx), cuda.ptr(ok), cuda.ptr(col_best), cuda.stream())
    return idx, ok


HAMMING_MATRIX = cuda.Kernel("hamming_match", "hamming_matrix",
                             [_P, _P, _I, _I, _P, _P])


def hamming_dist_plain(desc_a: torch.Tensor, desc_b: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of `hamming_dist`: the reference's unpack + matmul."""
    return hamming_matrix(unpack_u32_to_pm1(desc_a),
                          unpack_u32_to_pm1(desc_b))


def hamming_dist(desc_a: torch.Tensor, desc_b: torch.Tensor
                 ) -> torch.Tensor:
    """The whole Hamming distance matrix [N,M] float32 of packed
    descriptors desc_a [N,8] / desc_b [M,8] int32 (`hamming_match`'s
    matrix mode).  CPU tensors take the plain version; CUDA tensors launch
    csrc/hamming_match.cu's `hamming_matrix`."""
    if desc_a.device.type == "cpu":
        return hamming_dist_plain(desc_a, desc_b)
    n, m = desc_a.shape[0], desc_b.shape[0]
    cuda.check_cuda("hamming_dist", desc_a, desc_b)
    if desc_a.dtype != torch.int32 or desc_b.dtype != torch.int32 \
            or desc_a.shape[1:] != (8,) or desc_b.shape[1:] != (8,):
        raise ValueError("hamming_dist: descriptors must be [*,8] int32")
    dist = torch.empty(n, m, dtype=torch.float32, device=desc_a.device)
    if n and m:
        HAMMING_MATRIX.launch(cuda.ptr(desc_a), cuda.ptr(desc_b), n, m,
                              cuda.ptr(dist), cuda.stream())
    return dist


# --------------------------------------------------------------------------
# Kernel 10: rot_hist
# --------------------------------------------------------------------------

ROT_HIST = cuda.Kernel("epipolar_match", "rot_hist",
                       [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P])


def rot_hist(angles_a, angles_b, idx_b, ok, n_bins: int = 30,
             keep_top: int = 3):
    """`rotation_histogram_filter` (angles_a [N], angles_b [M] float32,
    idx_b [N] int32, ok [N] bool -> ok [N]).  CPU tensors take the plain
    version; CUDA tensors launch csrc/epipolar_match.cu (one block)."""
    if ok.device.type == "cpu":
        return rotation_histogram_filter(angles_a, angles_b, idx_b, ok,
                                         n_bins, keep_top)
    n, m = angles_a.shape[0], angles_b.shape[0]
    cuda.check_cuda("rot_hist", angles_a, angles_b, idx_b, ok)
    if angles_a.dtype != torch.float32 or angles_b.dtype != torch.float32 \
            or idx_b.dtype != torch.int32 or ok.dtype != torch.bool \
            or idx_b.shape != (n,) or ok.shape != (n,):
        raise ValueError("rot_hist: float32 angles, int32 idx [N], bool ok "
                         "[N]")
    if not (1 <= keep_top <= min(n_bins, 8) and n_bins <= 256):
        raise ValueError("rot_hist: needs 1 <= keep_top <= min(n_bins, 8) "
                         "and n_bins <= 256")
    out = torch.empty_like(ok)
    bins = torch.empty(n, dtype=torch.int32, device=ok.device)
    if n == 0:
        return out
    ROT_HIST.launch(cuda.ptr(angles_a), cuda.ptr(angles_b), cuda.ptr(idx_b),
                    cuda.ptr(ok), n, n_bins, keep_top,
                    float(360.0 / n_bins), cuda.ptr(out), cuda.ptr(bins),
                    cuda.stream())
    return out
