"""SO(3)/SE(3) helpers of the pose IRLS and the VI pose optimizer (port
of plvio_tpu/utils/lie.py: `hat`, `vee`, `so3_exp`, `so3_log`,
`so3_right_jacobian(_inv)`, `_so3_left_V`, `se3_exp`, `so3_normalize`,
`rot_to_quat`).
Same conventions: tangent order (rho, phi), arbitrary leading batch
dimensions, Taylor guards below `_EPS`."""
from __future__ import annotations

import math

import torch

_EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _theta_terms(w: torch.Tensor):
    """(theta2, t2, t, W, W^2, small).  t2 and t are theta^2 and theta for
    the large-angle branch, replaced by 1 where `small` so that the
    unselected branch stays finite: the values are unchanged, and
    reverse-mode derivatives at w = 0 do not turn 0 * (0/0) into NaN."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS
    one = torch.ones_like(theta2)
    theta = torch.where(small, one, torch.sqrt(torch.clamp_min(theta2,
                                                               1e-24)))
    W = hat(w)
    return theta2, torch.where(small, one, theta2), theta, W, W @ W, small


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, [...,3] -> [...,3,3]."""
    theta2, t2, theta, W, W2, small = _theta_terms(w)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def _so3_left_V(phi: torch.Tensor) -> torch.Tensor:
    theta2, t2, theta, W, W2, small = _theta_terms(phi)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * W2


def se3_exp(xi: torch.Tensor):
    """[...,6] (rho, phi) -> (R [...,3,3], t [...,3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), (_so3_left_V(phi) @ rho[..., None])[..., 0]


def so3_normalize(R: torch.Tensor) -> torch.Tensor:
    """Closest rotation by Gram-Schmidt on the rows (cross products)."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.clamp_min(torch.linalg.vector_norm(r0, dim=-1,
                                                       keepdim=True), 1e-12)
    r1 = R[..., 1, :] - (R[..., 1, :] * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.clamp_min(torch.linalg.vector_norm(r1, dim=-1,
                                                       keepdim=True), 1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """[...,3,3] skew -> [...,3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3], differentiable at the identity: atan2 of
    (|w|, cos) with guarded square roots, a small-angle surrogate
    theta/sin ~= 1 + (1 - cos)/3, and the axis from the largest diagonal
    entry of R + I within 1e-3 of pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    w2 = (w * w).sum(-1)
    small = w2 < 1e-12
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(w2), w2))
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(small, 1.0 + (1.0 - cos_t) / 3.0, theta / sin_t)
    generic = w * scale[..., None]
    near_pi = theta > (math.pi - 1e-3)
    Rp = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], -1)
    k = torch.argmax(diag, -1)
    col = torch.take_along_dim(
        Rp, k[..., None, None].expand(*k.shape, 3, 1), -1)[..., 0]
    axis = col / torch.clamp_min(torch.linalg.vector_norm(col, dim=-1,
                                                          keepdim=True),
                                 1e-12)
    sgn = torch.where((axis * w).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.where(near_pi[..., None], axis * sgn * theta[..., None],
                       generic)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w): [...,3] -> [...,3,3]."""
    theta2, t2, theta, W, W2, small = _theta_terms(w)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return _eye_like(W) - B[..., None, None] * W + C[..., None, None] * W2


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Jr^{-1}(w): [...,3] -> [...,3,3]."""
    theta2, t2, theta, W, W2, small = _theta_terms(w)
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / t2 - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.clamp_min(torch.sin(theta), 1e-12)))
    return _eye_like(W) + 0.5 * W + cot[..., None, None] * W2


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,4] (x, y, z, w), w >= 0: Shepperd's method, the
    candidate of the largest trace term (the first on ties), normalized
    (utils/lie.py:160)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20,
                      m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22,
                      m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1 - m00 - m11 + m22], -1)
    trace = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                         1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(trace, -1)
    cands = torch.stack([qw, qx, qy, qz], -2)       # [...,4,4] (w,x,y,z)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q_wxyz = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.stack([q_wxyz[..., 1], q_wxyz[..., 2], q_wxyz[..., 3],
                     q_wxyz[..., 0]], -1)
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True),
                            1e-12)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[...,4] (x, y, z, w) -> [...,3,3] (utils/lie.py:146)."""
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True), 1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _so3_left_V_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2, t2, theta, W, W2, small = _theta_terms(phi)
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / t2 - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.clamp_min(torch.sin(theta), 1e-12)))
    return _eye_like(W) - 0.5 * W + cot[..., None, None] * W2


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [...,6] (rho, phi)."""
    phi = so3_log(R)
    rho = (_so3_left_V_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inv(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_mul(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, p):
    """Points p [...,3] under (R, t)."""
    return (R @ p[..., None])[..., 0] + t


def se3_matrix(R, t):
    """(R, t) -> [...,4,4]."""
    M = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    M[..., 3, 3] = 1.0
    return M


# --------------------------------------------------------------------------
# Sim(3): (R, t, s), tangent order (rho, phi, sigma), sigma = log s (the
# loop closer's welds and essential graph; utils/lie.py:260-329)
# --------------------------------------------------------------------------

SIM3_EPS = 1e-4


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W = int_0^1 e^{sigma u} Exp(u phi) du = a0 I + a1 phi^ + a2 phi^^2,
    with the reference's Taylor guards (|sigma| and theta below 1e-4) and
    its 1e-24 floors.  Where a guard holds, the other branch is evaluated
    at a safe stand-in (theta, theta^2 and the denominator 1), so that
    reverse-mode derivatives stay finite; the values are the reference's."""
    eps = SIM3_EPS
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-24))
    s = torch.exp(sigma)
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    one = torch.ones_like(theta)
    sig_safe = torch.where(sig_small, one, sigma)
    th_safe = torch.where(th_small, one, theta)
    th2_safe = torch.where(th_small, one, theta2)
    denom = torch.clamp_min(sigma * sigma + th2_safe, 1e-24)
    a0 = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                     (s - 1.0) / sig_safe)
    int_sin = (s * (sigma * torch.sin(th_safe) - th_safe
                    * torch.cos(th_safe)) + th_safe) / denom
    int_cos = (s * (sigma * torch.cos(th_safe) + th_safe
                    * torch.sin(th_safe)) - sigma) / denom
    int_u = torch.where(sig_small, 0.5 + sigma / 3.0,
                        (s * (sigma - 1.0) + 1.0) / (sig_safe * sig_safe))
    a1 = torch.where(th_small, int_u, int_sin / th_safe)
    int_u2h = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 8.0,
        (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0)
        / (2.0 * sig_safe ** 3))
    a2 = torch.where(th_small, int_u2h,
                     (a0 - int_cos) / torch.clamp_min(th2_safe, 1e-24))
    Wh = hat(phi)
    return a0[..., None, None] * _eye_like(Wh) + a1[..., None, None] * Wh \
        + a2[..., None, None] * (Wh @ Wh)


def sim3_exp(xi: torch.Tensor):
    """[...,7] (rho, phi, sigma) -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return so3_exp(phi), t, torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    """(R, t, s) -> [...,7] (rho, phi, sigma), the inverse of sim3_exp."""
    sigma = torch.log(torch.clamp_min(s, 1e-12))
    phi = so3_log(R)
    rho = torch.linalg.solve(_sim3_W(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, \
        sa * sb


def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t
