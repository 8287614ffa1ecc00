"""Two-view geometry: the monocular bootstrap's H / F RANSAC, model choice
and motion recovery, and the DLT triangulation of the mapping step (port
of plvio_tpu/ops/twoview.py: `TwoViewResult`, `_normalize_pixels` :32,
`_sample_indices` :37, `_dlt_homography` :49, `_eight_point_F` :62,
`_dlt_homography_w` :91, `score_F` :109, `score_H` :127,
`triangulate_dlt` :146, `_check_rt` :166, `recover_from_E` :188,
`recover_from_H` :219 and `reconstruct_two_views` :278).

The functions below are the plain PyTorch versions, in the dtype of their
inputs (float32 as the reference; float64 for a reference run of the same
algorithm), with batched `torch.linalg.svd` where the reference vmaps
`jnp.linalg.svd`.  `reconstruct_two_views` on CUDA tensors runs the two
hand-written kernels of csrc/twoview.cu instead: `twoview_hypotheses`
(the 200 H and 200 F minimal-set models and their scores over all
matches, one block each) and `twoview_recover` (the refits, the model
choice and the motion hypotheses of the chosen model, one block).

The reference draws its RANSAC samples with `jax.random.choice`; the port
cannot reproduce that stream, so `reconstruct_two_views` takes the sample
indices from the caller, or draws them from the same distribution
(uniform without replacement over the valid rows) with the caller's
`torch.Generator`.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cuda
from ..solver.residuals import PinholeK


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # bool
    R: torch.Tensor                # [3,3] camera2-from-camera1
    t: torch.Tensor                # [3] unit norm
    points3d: torch.Tensor         # [N,3] in camera1's frame
    is_triangulated: torch.Tensor  # [N] bool
    used_homography: torch.Tensor  # bool


def _normalize_pixels(K: PinholeK, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - K.cx) / K.fx,
                        (uv[..., 1] - K.cy) / K.fy], -1)


def sample_indices(valid: torch.Tensor, iters: int, k: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """[iters,k] int64 indices, each row drawn uniformly without
    replacement from the valid rows (the distribution of the reference's
    `_sample_indices`; at least k rows must be valid).  Runs on the
    generator's device."""
    return torch.multinomial(valid.to(torch.float64).expand(iters, -1), k,
                             replacement=False, generator=generator)


def _dlt_homography(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """4-point DLT, batched: x1, x2 [...,4,2] -> H [...,3,3], x2 ~ H x1."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    A = torch.stack([r1, r2], -2).flatten(-3, -2)          # rows r1_0, r2_0..
    _, _, Vh = torch.linalg.svd(A)
    return Vh[..., -1, :].reshape(x.shape[:-1] + (3, 3))


def _eight_point_F(x1: torch.Tensor, x2: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized 8-point algorithm, batched: [...,M,2] x 2 -> F [...,3,3],
    rank 2 enforced; optional row weights w [...,M] (0 rows ignored)."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    wn = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

    def hartley(x):
        mu = (x * wn[..., None]).sum(-2)
        d = (torch.sqrt(((x - mu[..., None, :]) ** 2).sum(-1)) * wn).sum(-1)
        s = math.sqrt(2.0) / torch.clamp_min(d, 1e-9)
        z, o = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([torch.stack([s, z, -s * mu[..., 0]], -1),
                         torch.stack([z, s, -s * mu[..., 1]], -1),
                         torch.stack([z, z, o], -1)], -2)
        return (x - mu[..., None, :]) * s[..., None, None], T

    x1n, T1 = hartley(x1)
    x2n, T2 = hartley(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], -1) * w[..., None]
    _, _, Vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)
    F = Vh[..., -1, :].reshape(u1.shape[:-1] + (3, 3))
    U, S, Vh2 = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = U @ torch.diag_embed(S) @ Vh2
    return T2.transpose(-1, -2) @ F @ T1


def _dlt_homography_w(x1: torch.Tensor, x2: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT homography over all inliers (the refit), [M,2]."""
    x, y = x1[:, 0], x1[:, 1]
    u, v = x2[:, 0], x2[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], 1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], 1)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]])
    _, _, Vh = torch.linalg.svd(A, full_matrices=A.shape[0] < 9)
    return Vh[-1].reshape(3, 3)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], -1)


def score_F(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
            valid: torch.Tensor, sigma: float = 1.0):
    """Symmetric epipolar scoring of F [...,3,3] over the N matches:
    (robust score [...], inlier mask [...,N])."""
    th, th_score = 3.841, 5.991
    x1, x2 = _homog(uv1), _homog(uv2)
    l2 = x1 @ F.transpose(-1, -2)
    l1 = x2 @ F
    d2 = (l2 * x2).sum(-1) ** 2 / torch.clamp_min(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d1 = (l1 * x1).sum(-1) ** 2 / torch.clamp_min(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    inv_s2 = 1.0 / sigma ** 2
    c1, c2 = d1 * inv_s2, d2 * inv_s2
    ok = (c1 < th) & (c2 < th) & valid
    zero = torch.zeros_like(c1)
    score = (torch.where(valid & (c1 < th), th_score - c1, zero)
             + torch.where(valid & (c2 < th), th_score - c2, zero)).sum(-1)
    return score, ok


def _dehomog(p):
    w = p[..., 2:3]
    return p[..., :2] / torch.where(torch.abs(w) < 1e-9,
                                    torch.full_like(w, 1e-9), w)


def score_H(H: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
            valid: torch.Tensor, sigma: float = 1.0):
    """Symmetric transfer scoring of H [...,3,3] over the N matches:
    (robust score [...], inlier mask [...,N])."""
    th = 5.991
    Hinv = torch.linalg.inv(H)
    x1, x2 = _homog(uv1), _homog(uv2)
    p2 = _dehomog(x1 @ H.transpose(-1, -2))
    p1 = _dehomog(x2 @ Hinv.transpose(-1, -2))
    inv_s2 = 1.0 / sigma ** 2
    c1 = ((p1 - uv1) ** 2).sum(-1) * inv_s2
    c2 = ((p2 - uv2) ** 2).sum(-1) * inv_s2
    ok = (c1 < th) & (c2 < th) & valid
    zero = torch.zeros_like(c1)
    score = (torch.where(valid & (c1 < th), th - c1, zero)
             + torch.where(valid & (c2 < th), th - c2, zero)).sum(-1)
    return score, ok


def triangulate_dlt(R: torch.Tensor, t: torch.Tensor, x1n: torch.Tensor,
                    x2n: torch.Tensor) -> torch.Tensor:
    """Batched DLT with P1 = [I|0], P2 = [R|t] on normalized coordinates
    [...,N,2] (R [...,3,3], t [...,3]) -> points [...,N,3] in the first
    camera's frame: the right singular vector of the smallest singular
    value of each 4x4 system (a batched SVD, as the reference's
    jnp.linalg.svd), dehomogenized with the same 1e-12 guard."""
    P2 = torch.cat([R, t[..., None]], -1)                     # [...,3,4]
    shape = torch.broadcast_shapes(x1n.shape[:-1], P2.shape[:-2] + (1,))
    a = x1n.expand(shape + (2,))
    b = x2n.expand(shape + (2,))
    z = torch.zeros_like(a[..., 0])
    one = torch.ones_like(z)
    row0 = torch.stack([-one, z, a[..., 0], z], -1)           # a0 e2 - e0
    row1 = torch.stack([z, -one, a[..., 1], z], -1)           # a1 e2 - e1
    P2e = P2[..., None, :, :]
    row2 = b[..., 0:1] * P2e[..., 2, :] - P2e[..., 0, :]
    row3 = b[..., 1:2] * P2e[..., 2, :] - P2e[..., 1, :]
    A = torch.stack([row0, row1, row2, row3], -2)             # [...,N,4,4]
    _, _, Vh = torch.linalg.svd(A)
    X = Vh[..., -1, :]
    w = X[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def _check_rt(R, t, x1n, x2n, inliers, min_parallax_cos: float = 0.99998):
    """Points with positive depth in both views, enough parallax and a
    small normalized reprojection error: (count, good mask, points3d),
    batched over the leading dims of R [...,3,3] and t [...,3]."""
    X = triangulate_dlt(R, t, x1n, x2n)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    r1 = X / torch.clamp_min(torch.linalg.vector_norm(X, dim=-1,
                                                      keepdim=True), 1e-12)
    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    d2 = X - C2[..., None, :]
    r2 = d2 / torch.clamp_min(torch.linalg.vector_norm(d2, dim=-1,
                                                       keepdim=True), 1e-12)
    cosp = (r1 * r2).sum(-1)
    finite = torch.isfinite(X).all(-1)
    good = inliers & finite & (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos)
    e1 = ((X[..., :2] / torch.clamp_min(z1[..., None], 1e-9) - x1n) ** 2
          ).sum(-1)
    e2 = ((X2[..., :2] / torch.clamp_min(z2[..., None], 1e-9) - x2n) ** 2
          ).sum(-1)
    good = good & (e1 < 1e-4) & (e2 < 1e-4)
    return good.sum(-1), good, X


def _pick(cands_R, cands_t, x1n, x2n, inliers, second_frac: float):
    """Check every (R, t) candidate and take the first with the most good
    points; a clear winner (second best < second_frac of it, > 75% of
    the inliers, >= 8) is a success."""
    counts, goods, Xs = _check_rt(cands_R, cands_t, x1n, x2n, inliers)
    best = torch.argmax(counts)
    n_best = counts[best]
    second = torch.sort(counts).values[-2]
    ok = (n_best > 0.75 * torch.clamp_min(inliers.sum(), 1)) \
        & (second < second_frac * n_best) & (n_best >= 8)
    return ok, cands_R[best], cands_t[best], Xs[best], goods[best]


def recover_from_E(E, x1n, x2n, inliers):
    """The 4 (R, t) hypotheses of E and the cheirality test."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0., -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    tt = U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([tt, -tt, tt, -tt])
    return _pick(Rs, ts, x1n, x2n, inliers, 0.7)


def recover_from_H(Hn, x1n, x2n, inliers):
    """Faugeras' decomposition of a calibrated homography into 8 motion
    hypotheses and the cheirality test."""
    U, S, Vh = torch.linalg.svd(Hn)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = S[0], S[1], S[2]
    den = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / den, 0.0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / den, 0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    root = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2)
                                      * (d2 * d2 - d3 * d3), 0.0))
    # case d' > 0
    sin_t = root / torch.clamp_min((d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, 1e-12)
    Rs, ts = [], []
    for i in range(4):
        # the reference's first assignment (:239), overwritten at :242
        st = torch.where(x1s[i] * x3s[i] >= 0, sin_t, -sin_t) \
            * torch.sign(x1s[i] * x3s[i] + 1e-30)
        eps13 = torch.sign(x1s[i]) * torch.sign(x3s[i])
        st = eps13 * sin_t
        Rp = torch.stack([torch.stack([cos_t, zero, -st]),
                          torch.stack([zero, one, zero]),
                          torch.stack([st, zero, cos_t])])
        Rs.append(s * U @ Rp @ Vh)
        t = U @ ((d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]]))
        ts.append(t / torch.clamp_min(torch.linalg.vector_norm(t), 1e-12))
    # case d' < 0
    sin_p = root / torch.clamp_min((d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp_min((d1 - d3) * d2, 1e-12)
    for i in range(4):
        eps13 = torch.sign(x1s[i]) * torch.sign(x3s[i])
        sp = eps13 * sin_p
        Rp = torch.stack([torch.stack([cos_p, zero, sp]),
                          torch.stack([zero, -one, zero]),
                          torch.stack([sp, zero, -cos_p])])
        Rs.append(s * U @ Rp @ Vh)
        t = U @ ((d1 + d3) * torch.stack([x1s[i], zero, x3s[i]]))
        ts.append(t / torch.clamp_min(torch.linalg.vector_norm(t), 1e-12))
    return _pick(torch.stack(Rs), torch.stack(ts), x1n, x2n, inliers, 0.75)


def _kmat(K: PinholeK, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[K.fx, 0, K.cx], [0, K.fy, K.cy], [0, 0, 1.0]],
                        dtype=like.dtype, device=like.device)


class TwoViewOut(NamedTuple):
    """`reconstruct_two_views`' result and the best minimal models, which
    the tests hold the kernels to."""
    result: TwoViewResult
    b_h: torch.Tensor        # best minimal-set H (index into idx_h)
    b_f: torch.Tensor        # best minimal-set F (index into idx_f)


def twoview_hypotheses_plain(uv1, uv2, valid, idx_h, idx_f):
    """Plain version of `twoview_hypotheses`, in the dtype of uv1 / uv2:
    (Hs [I,3,3], Fs [I,3,3], their scores sH, sF [I])."""
    Hs = _dlt_homography(uv1[idx_h], uv2[idx_h])
    Fs = _eight_point_F(uv1[idx_f], uv2[idx_f])
    sH, _ = score_H(Hs, uv1, uv2, valid)
    sF, _ = score_F(Fs, uv1, uv2, valid)
    return Hs, Fs, sH, sF


def twoview_recover_plain(K: PinholeK, uv1, uv2, valid, Hs, Fs, sH,
                          sF) -> TwoViewOut:
    """Plain version of `twoview_recover`: the best of each model, the
    refits and their scores, the model choice and the chosen model's
    motion recovery (the other model's recovery does not change the
    result, so it is not run)."""
    bH = torch.argmax(sH)
    bF = torch.argmax(sF)
    _, inlH = score_H(Hs[bH], uv1, uv2, valid)
    _, inlF = score_F(Fs[bF], uv1, uv2, valid)
    Fbest = _eight_point_F(uv1, uv2, inlF.to(uv1.dtype))
    Hbest = _dlt_homography_w(uv1, uv2, inlH.to(uv1.dtype))
    SF, inlF = score_F(Fbest, uv1, uv2, valid)
    SH, inlH = score_H(Hbest, uv1, uv2, valid)
    ratio = SH / torch.clamp_min(SH + SF, 1e-9)
    use_H = ratio > 0.45
    x1n = _normalize_pixels(K, uv1)
    x2n = _normalize_pixels(K, uv2)
    Km = _kmat(K, uv1)
    if bool(use_H):
        Hn = torch.linalg.inv(Km) @ Hbest @ Km
        ok, R, t, X, g = recover_from_H(Hn, x1n, x2n, inlH)
    else:
        E = Km.T @ Fbest @ Km
        ok, R, t, X, g = recover_from_E(E, x1n, x2n, inlF)
    res = TwoViewResult(success=ok, R=R, t=t, points3d=X, is_triangulated=g,
                        used_homography=use_H)
    return TwoViewOut(res, bH, bF)


def twoview_plain(K: PinholeK, uv1, uv2, valid, idx_h, idx_f) -> TwoViewOut:
    """Plain version of the two kernels, in the dtype of uv1 / uv2."""
    return twoview_recover_plain(K, uv1, uv2, valid, *twoview_hypotheses_plain(
        uv1, uv2, valid, idx_h, idx_f))


# --------------------------------------------------------------------------
# Kernels: twoview_hypotheses, twoview_recover
# --------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
TWOVIEW_HYPOTHESES = cuda.Kernel(
    "twoview", "twoview_hypotheses", [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P])
TWOVIEW_RECOVER = cuda.Kernel(
    "twoview", "twoview_recover",
    [_P, _P, _P, _I, _P, _P, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P])

# layout of twoview_recover's int32 `info`
INFO = ("success", "used_h", "b_h", "b_f", "n_best", "second", "best",
        "n_inliers")
N_INFO = len(INFO) + 8                 # then the candidates' counts


def twoview_hypotheses(uv1, uv2, valid, idx_h, idx_f):
    """The minimal-set models and their scores: (models [2*iters,9]
    float64, the iters H models then the iters F models, row-major;
    scores [2*iters] float64).  CUDA tensors only (csrc/twoview.cu, one
    block a hypothesis); `twoview_plain` is the plain version."""
    n, iters = uv1.shape[0], idx_h.shape[0]
    cuda.check_cuda("twoview_hypotheses", uv1, uv2, valid, idx_h, idx_f)
    if uv1.dtype != torch.float32 or uv2.dtype != torch.float32 \
            or uv1.shape != (n, 2) or uv2.shape != (n, 2) \
            or valid.dtype != torch.bool or valid.shape != (n,) \
            or idx_h.dtype != torch.int32 or idx_f.dtype != torch.int32 \
            or idx_h.shape != (iters, 4) or idx_f.shape != (iters, 8):
        raise ValueError("twoview_hypotheses: float32 uv [N,2], bool valid "
                         "[N], int32 idx_h [I,4] and idx_f [I,8]")
    models = torch.empty(2 * iters, 9, dtype=torch.float64,
                         device=uv1.device)
    scores = torch.empty(2 * iters, dtype=torch.float64, device=uv1.device)
    if iters == 0:
        return models, scores
    TWOVIEW_HYPOTHESES.launch(
        cuda.ptr(uv1), cuda.ptr(uv2), cuda.ptr(valid), n, cuda.ptr(idx_h),
        cuda.ptr(idx_f), iters, cuda.ptr(models), cuda.ptr(scores),
        cuda.stream())
    return models, scores


def twoview_recover(K: PinholeK, uv1, uv2, valid, models, scores):
    """From the minimal-set models and scores: the best of each model, the
    weighted refits and their scores, the choice SH / (SH + SF) > 0.45
    and the chosen model's 4 (E) or 8 (H) motion hypotheses, each checked
    over all N matches.  Returns (TwoViewOut, info [N_INFO] int32, the
    layout of `INFO` then the hypotheses' counts, -1 past the last).
    CUDA tensors only (csrc/twoview.cu, one block)."""
    n, iters = uv1.shape[0], scores.shape[0] // 2
    cuda.check_cuda("twoview_recover", uv1, uv2, valid, models, scores)
    if models.dtype != torch.float64 or scores.dtype != torch.float64 \
            or models.shape != (2 * iters, 9) or iters == 0:
        raise ValueError("twoview_recover: float64 models [2I,9] and scores "
                         "[2I], I > 0")
    dev = uv1.device
    masks = torch.empty(2, n, dtype=torch.bool, device=dev)
    Rt = torch.empty(12, dtype=torch.float32, device=dev)
    X = torch.empty(n, 3, dtype=torch.float32, device=dev)
    good = torch.empty(n, dtype=torch.bool, device=dev)
    info = torch.empty(N_INFO, dtype=torch.int32, device=dev)
    TWOVIEW_RECOVER.launch(
        cuda.ptr(uv1), cuda.ptr(uv2), cuda.ptr(valid), n, cuda.ptr(models),
        cuda.ptr(scores), iters, K.fx, K.fy, K.cx, K.cy, cuda.ptr(masks),
        cuda.ptr(Rt), cuda.ptr(X), cuda.ptr(good), cuda.ptr(info),
        cuda.stream())
    res = TwoViewResult(success=info[0] != 0, R=Rt[:9].view(3, 3),
                        t=Rt[9:], points3d=X, is_triangulated=good,
                        used_homography=info[1] != 0)
    return TwoViewOut(res, info[2].long(), info[3].long()), info


class Float64Gaps(NamedTuple):
    """The two kernels beside the plain version in float64 on the same
    inputs and minimal sets (`kernels_against_float64`)."""
    out: TwoViewOut     # the kernels'
    info: torch.Tensor  # twoview_recover's
    ref: TwoViewOut     # the plain version's, float64
    score_gap: float    # largest |score - plain score| / largest plain score
    best_equal: bool    # the best H and F the plain version's, but for ties
    gaps: tuple         # (R, t) entries, common points / their magnitude
    flips: int          # is_triangulated rows that differ


def kernels_against_float64(K: PinholeK, uv1, uv2, valid, idx_h,
                            idx_f) -> Float64Gaps:
    """Run `twoview_hypotheses` + `twoview_recover` on CUDA tensors and the
    plain version in float64 on the same device and int64 minimal sets.
    Scores count only H models whose condition number is below 1e6 (a
    minimal DLT on raw pixels can be near singular, and then both float64
    solutions are rounding); a best model may differ where the plain
    version's top two scores lie within 1e-9 of the best.  The gaps and
    flips are 0 unless both succeed."""
    dev = uv1.device
    models, scores = twoview_hypotheses(uv1, uv2, valid,
                                        idx_h.to(dev, torch.int32),
                                        idx_f.to(dev, torch.int32))
    out, info = twoview_recover(K, uv1, uv2, valid, models, scores)
    q1, q2 = uv1.double(), uv2.double()
    Hs, Fs, sH, sF = twoview_hypotheses_plain(q1, q2, valid, idx_h.to(dev),
                                              idx_f.to(dev))
    ref = twoview_recover_plain(K, q1, q2, valid, Hs, Fs, sH, sF)
    best_equal = True
    for s_ref, bk, bp in ((sH, out.b_h, ref.b_h), (sF, out.b_f, ref.b_f)):
        top2 = torch.topk(s_ref, 2).values
        tie = float(top2[0] - top2[1]) <= 1e-9 * float(top2[0].abs())
        best_equal = best_equal and (tie or int(bk) == int(bp))
    well = torch.linalg.cond(Hs) < 1e6
    score_gap = max(
        float((scores[:len(sH)] - sH).abs()[well].max())
        / float(sH.abs().max()),
        float((scores[len(sH):] - sF).abs().max()) / float(sF.abs().max()))
    r, rp = out.result, ref.result
    gaps, flips = (0.0, 0.0, 0.0), 0
    if bool(r.success) and bool(rp.success):
        gk, gp = r.is_triangulated, rp.is_triangulated
        flips = int((gk != gp).sum())
        both = gk & gp
        gaps = (float((r.R.double() - rp.R).abs().max()),
                float((r.t.double() - rp.t).abs().max()),
                float((r.points3d.double()[both] - rp.points3d[both]).abs()
                      .max() / rp.points3d[both].abs().max()))
    return Float64Gaps(out, info, ref, score_gap, best_equal, gaps, flips)


def reconstruct_two_views(K: PinholeK, uv1, uv2, valid, idx_h=None,
                          idx_f=None, generator=None, iters: int = 200,
                          plain: bool = False) -> TwoViewResult:
    """The two-view bootstrap: uv1 / uv2 [N,2] undistorted pixel matches,
    valid [N] bool.  idx_h [iters,4] / idx_f [iters,8] (int64) are the
    minimal sets; without them they are drawn with `generator` (see
    `sample_indices`), H's first.  CPU tensors (or `plain`) take the
    plain version; CUDA tensors launch the two kernels."""
    if idx_h is None or idx_f is None:
        vs = valid.to(generator.device if generator is not None
                      else valid.device)
        idx_h = sample_indices(vs, iters, 4, generator)
        idx_f = sample_indices(vs, iters, 8, generator)
    dev = uv1.device
    idx_h, idx_f = (torch.from_numpy(np.array(i, np.int64))
                    if not torch.is_tensor(i) else i for i in (idx_h, idx_f))
    idx_h, idx_f = idx_h.to(dev), idx_f.to(dev)
    if plain or dev.type == "cpu":
        return twoview_plain(K, uv1, uv2, valid, idx_h.long(),
                             idx_f.long()).result
    models, scores = twoview_hypotheses(
        uv1.contiguous(), uv2.contiguous(), valid.contiguous(),
        idx_h.to(torch.int32).contiguous(), idx_f.to(torch.int32).contiguous())
    out, _ = twoview_recover(K, uv1.contiguous(), uv2.contiguous(),
                             valid.contiguous(), models, scores)
    return out.result
