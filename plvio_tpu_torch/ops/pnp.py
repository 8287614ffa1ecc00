"""PnP for relocalization and the loop closer's Sim3 RANSAC (port of
plvio_tpu/ops/pnp.py: `_dlt_pose` :22, `pnp_ransac` :49, `sim3_horn`
:143, `sim3_ransac` :165, `mlpnp_refine` :217).

`pnp_ransac` scores iters minimal six-point DLT hypotheses (the 12-column
null vector, its 3x3 block polar-decomposed onto SO(3)) against all N
matches with a loose gate (4 chi2), refits the best one's loose inliers
by a weighted DLT, polishes it with two Huber-weighted refits, re-scores
strictly and falls back to the raw hypothesis when the refit scores
fewer.  `mlpnp_refine` runs 8 Gauss-Newton steps on the residuals in the
tangent plane of each observed bearing, Huber-weighted, then re-scores
strictly.

The RANSAC samples are an input, [iters, 6] indices of valid rows: the
caller draws them (`twoview.sample_indices` with a `torch.Generator`, as
the tracker does, one draw per attempt) or gives the reference's.

The plain versions follow the reference's operations in the dtype of
their inputs (a float64 run is the reference the float32 runs are held
to: the DLT on raw world coordinates is ill-conditioned, and float32
SVDs lie far from it).  On CUDA tensors `pnp_ransac` launches
csrc/pnp.cu's `pnp_hypotheses` (one block a hypothesis) and
`pnp_refine` (one block), and `mlpnp_refine` its `mlpnp_refine` (one
block); the kernels solve in float64.

`sim3_ransac` scores iters three-point Horn similarities (X2 ~ s R X1 +
t) against all N matched 3D points under the relative gate th x
scale_ref (scale_ref the mean distance of the X2 rows, padding included,
from their mean) and 0.1 < s < 10, takes the first hypothesis of the
most inliers, and refits the similarity on its inliers; the samples are
an input [iters,3] as for `pnp_ransac`.  On CUDA tensors it launches
csrc/sim3.cu's `sim3_ransac` (one block: a warp a hypothesis, then the
argmax and the refit), in float64.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cuda
from ..solver.residuals import PinholeK
from ..utils import lie


class PnPResult(NamedTuple):
    R: torch.Tensor        # [3,3] T_cw rotation
    t: torch.Tensor        # [3]
    inliers: torch.Tensor  # [N] bool
    n: torch.Tensor        # [] int32 inlier count
    best: torch.Tensor     # [] int32 the hypothesis the loose scores chose
    counts: torch.Tensor   # [iters] int32 each hypothesis' loose inliers


def _normalized(K: PinholeK, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - K.cx) / K.fx,
                        (uv[..., 1] - K.cy) / K.fy], -1)


def _dlt_pose(xn: torch.Tensor, X: torch.Tensor, w=None):
    """6+ point DLT pose from [...,n,2] normalized image points and
    [...,n,3] world points (rows weighted by w [...,n] where given): the
    12-column null vector P, its sign made det(P[:, :3]) > 0, the 3x3
    block's polar factor and the translation over its mean singular
    value: (R [...,3,3], t [...,3])."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -xn[..., 0:1] * Xh], -1)
    r2 = torch.cat([z, Xh, -xn[..., 1:2] * Xh], -1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], -2)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    P = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 4))
    neg = torch.linalg.det(P[..., :3]) < 0
    P = torch.where(neg[..., None, None], -P, P)
    U, S, Vt2 = torch.linalg.svd(P[..., :3])
    R = U @ Vt2
    scale = S.mean(-1)
    t = P[..., 3] / torch.clamp_min(scale, 1e-9)[..., None]
    return R, t


def _chi2(K: PinholeK, uv, X, R, t):
    """(chi2 [...,N] px^2, depth [...,N]) of the matches under (R, t)."""
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    pred = torch.stack([K.fx * pc[..., 0] / z + K.cx,
                        K.fy * pc[..., 1] / z + K.cy], -1)
    return ((pred - uv) ** 2).sum(-1), pc[..., 2]


def _score(K, uv, X, valid, R, t, th):
    chi2, depth = _chi2(K, uv, X, R, t)
    inl = valid & (chi2 < th) & (depth > 0.05)
    return inl.sum(-1), inl


def pnp_ransac_plain(K: PinholeK, uv, X, valid, samples,
                     chi2_th: float = 5.991) -> PnPResult:
    """Plain version of `pnp_ransac`, in the inputs' dtype."""
    xn = _normalized(K, uv)
    s = samples.long()
    Rs, ts = _dlt_pose(xn[s], X[s])                       # [it,3,3], [it,3]
    counts, inls = _score(K, uv[None], X[None], valid[None], Rs, ts,
                          4 * chi2_th)
    best = torch.argmax(counts)
    w_in = inls[best].to(uv.dtype)
    R_ref, t_ref = _dlt_pose(xn, X, w_in)
    for _ in range(2):
        chi2, depth = _chi2(K, uv, X, R_ref, t_ref)
        w_h = torch.clamp(torch.sqrt(chi2_th / torch.clamp_min(chi2, 1e-9)),
                          max=1.0)
        w_irls = valid.to(uv.dtype) * (depth > 0.05) * w_h \
            * (chi2 < 4 * chi2_th)
        R_i, t_i = _dlt_pose(xn, X, w_irls)
        n_i, _ = _score(K, uv, X, valid, R_i, t_i, chi2_th)
        n_cur, _ = _score(K, uv, X, valid, R_ref, t_ref, chi2_th)
        if bool(n_i >= n_cur):
            R_ref, t_ref = R_i, t_i
    n_ref, inl_ref = _score(K, uv, X, valid, R_ref, t_ref, chi2_th)
    n_raw, inl_raw = _score(K, uv, X, valid, Rs[best], ts[best], chi2_th)
    better = bool(n_ref >= n_raw)
    return PnPResult(R_ref if better else Rs[best],
                     t_ref if better else ts[best],
                     inl_ref if better else inl_raw,
                     torch.maximum(n_ref, n_raw).to(torch.int32),
                     best.to(torch.int32), counts.to(torch.int32))


def _tangent_bases(K: PinholeK, uv):
    """Each observed bearing v and two unit vectors r, s spanning the
    plane normal to it."""
    xn = torch.stack([(uv[:, 0] - K.cx) / K.fx, (uv[:, 1] - K.cy) / K.fy,
                      torch.ones_like(uv[:, 0])], -1)
    v = xn / torch.linalg.vector_norm(xn, dim=-1, keepdim=True)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=uv.dtype, device=uv.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=uv.dtype, device=uv.device)
    e = torch.where(torch.abs(v[:, 2:3]) < 0.9, ez, ex)
    r = torch.linalg.cross(v, e)
    r = r / torch.clamp_min(torch.linalg.vector_norm(r, dim=-1,
                                                     keepdim=True), 1e-9)
    return r, torch.linalg.cross(v, r)


def mlpnp_refine_plain(K: PinholeK, uv, X, inliers, R0, t0, iters: int = 8,
                       chi2_th: float = 5.991):
    """Plain version of `mlpnp_refine`, in the inputs' dtype: the
    residual's Jacobian at xi = 0 in closed form (d mu / d pc =
    (I - mu mu^T) / |pc|, d pc / d omega = -[R X]x, d pc / d t = I)."""
    r, s = _tangent_bases(K, uv)
    w = inliers.to(uv.dtype)
    R, t = R0, t0
    eye3 = torch.eye(3, dtype=uv.dtype, device=uv.device)
    for _ in range(iters):
        RX = X @ R.T
        pc = RX + t
        nrm = torch.clamp_min(torch.linalg.vector_norm(pc, dim=-1,
                                                       keepdim=True), 1e-9)
        mu = pc / nrm
        res = torch.stack([(r * mu).sum(-1), (s * mu).sum(-1)], -1)
        dmu = (eye3 - mu[:, :, None] * mu[:, None, :]) / nrm[..., None]
        dpc = torch.cat([-lie.hat(RX), eye3.expand(len(X), 3, 3)], -1)
        J = torch.stack([r, s], 1)[:, :, None, :] @ dmu[:, None] \
            @ dpc[:, None]                                  # [N,2,1,6]
        J = J[:, :, 0, :]
        rn2 = (res ** 2).sum(-1) * (K.fx * K.fx)
        hub = torch.where(rn2 > chi2_th,
                          torch.sqrt(chi2_th / torch.clamp_min(rn2, 1e-12)),
                          torch.ones_like(rn2))
        ww = (w * hub)[:, None]
        Jf = (J * ww[..., None]).reshape(-1, 6)
        rf = (res * ww).reshape(-1)
        H = Jf.T @ Jf + 1e-8 * torch.eye(6, dtype=uv.dtype, device=uv.device)
        g = Jf.T @ rf
        xi = -torch.linalg.solve(H, g)
        R = lie.so3_exp(xi[:3]) @ R
        t = t + xi[3:]
    n, inl = _score(K, uv, X, inliers, R, t, chi2_th)
    return R, t, inl, n.to(torch.int32)


class Sim3Result(NamedTuple):
    s: torch.Tensor        # [] scale
    R: torch.Tensor        # [3,3]
    t: torch.Tensor        # [3]
    inliers: torch.Tensor  # [N] bool, the best hypothesis' inliers
    n: torch.Tensor        # [] int32 their count
    best: torch.Tensor     # [] int32 the best hypothesis
    counts: torch.Tensor   # [iters] int32 each hypothesis' inliers


def _horn_from_cov(cov, var1, fix_scale: bool):
    """(s, R) of Horn's alignment from the cross-covariance [...,3,3] and
    the source variance: R = U diag(1, 1, sign(det U det Vt)) Vt."""
    U, D, Vt = torch.linalg.svd(cov)
    sg = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(sg), torch.ones_like(sg), sg], -1)
    R = U @ (diag[..., :, None] * Vt)
    if fix_scale:
        s = torch.ones_like(sg)
    else:
        s = (D * diag).sum(-1) / torch.clamp_min(var1, 1e-12)
    return s, R


def sim3_horn(X1: torch.Tensor, X2: torch.Tensor, fix_scale: bool = False):
    """Closed-form Horn alignment of [...,n,3] point sets (n >= 3):
    (s, R, t) with X2 ~ s R X1 + t."""
    mu1, mu2 = X1.mean(-2), X2.mean(-2)
    x1, x2 = X1 - mu1[..., None, :], X2 - mu2[..., None, :]
    cov = x2.transpose(-1, -2) @ x1 / X1.shape[-2]
    var1 = (x1 * x1).sum(-1).mean(-1)
    s, R = _horn_from_cov(cov, var1, fix_scale)
    t = mu2 - s[..., None] * (R @ mu1[..., None])[..., 0]
    return s, R, t


def sim3_ransac_plain(X1, X2, valid, samples, th: float = 0.05,
                      fix_scale: bool = False) -> Sim3Result:
    """Plain version of `sim3_ransac`, in the inputs' dtype."""
    scale_ref = torch.sqrt(torch.clamp_min(
        ((X2 - X2.mean(0)) ** 2).sum(-1), 1e-9)).mean()
    idx = samples.long()
    ss, Rs, ts = sim3_horn(X1[idx], X2[idx], fix_scale)
    pred = ss[:, None, None] * (X1[None] @ Rs.transpose(-1, -2)) \
        + ts[:, None, :]
    d = torch.linalg.vector_norm(pred - X2[None], dim=-1)
    inls = valid[None] & (d < th * scale_ref) & (ss[:, None] > 0.1) \
        & (ss[:, None] < 10.0)
    counts = inls.sum(-1)
    best = torch.argmax(counts)
    inl = inls[best]
    w = inl.to(X1.dtype)[:, None]
    nw = torch.clamp_min(w.sum(), 1.0)
    mu1 = (X1 * w).sum(0) / nw
    mu2 = (X2 * w).sum(0) / nw
    x1 = (X1 - mu1) * w
    x2 = (X2 - mu2) * w
    cov = x2.T @ x1 / nw
    s, R = _horn_from_cov(cov, (x1 * x1).sum(-1).sum() / nw, fix_scale)
    t = mu2 - s * (R @ mu1)
    return Sim3Result(s, R, t, inl, counts[best].to(torch.int32),
                      best.to(torch.int32), counts.to(torch.int32))


# --------------------------------------------------------------------------
# Kernels: pnp_hypotheses + pnp_refine, mlpnp_refine (csrc/pnp.cu)
# --------------------------------------------------------------------------

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
PNP_RANSAC = cuda.Kernel(
    "pnp", "pnp_ransac",
    [_P, _P, _P, _I, _P, _I, _D, _D, _D, _D, _D, _P, _P, _P, _P, _P, _P, _P,
     _P])
MLPNP_REFINE = cuda.Kernel(
    "pnp", "mlpnp_refine",
    [_P, _P, _P, _I, _P, _P, _I, _D, _D, _D, _D, _D, _P, _P, _P, _P, _P])

MAX_N = 4096


def _check(name, uv, X, mask):
    n = uv.shape[0]
    cuda.check_cuda(name, uv, X, mask)
    if uv.dtype != torch.float32 or X.dtype != torch.float32 \
            or uv.shape != (n, 2) or X.shape != (n, 3) \
            or mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"{name}: uv [N,2] / X [N,3] float32, mask [N] "
                         "bool")
    if not 6 <= n <= MAX_N:
        raise ValueError(f"{name}: needs 6 <= N <= {MAX_N} matches")
    return n


def pnp_ransac(K: PinholeK, uv: torch.Tensor, X: torch.Tensor,
               valid: torch.Tensor, samples: torch.Tensor,
               chi2_th: float = 5.991, stats: dict = None) -> PnPResult:
    """Robust pose T_cw = (R, t) from 2D-3D matches uv [N,2] pixels, X
    [N,3] world points, valid [N], samples [iters,6] (rows of valid
    matches, each row's 6 distinct).  CPU tensors take the plain
    version; CUDA tensors launch csrc/pnp.cu (two kernels), and then
    `stats`, where given, gets "rotations": the Jacobi rotations the
    kernels' 12x12 eigenproblems applied ([] int32 tensor)."""
    if uv.device.type == "cpu":
        return pnp_ransac_plain(K, uv, X, valid, samples.to(uv.device),
                                chi2_th)
    n = _check("pnp_ransac", uv, X, valid)
    samples = samples.to(device=uv.device, dtype=torch.int32).contiguous()
    iters = samples.shape[0]
    if samples.shape != (iters, 6) or iters < 1:
        raise ValueError("pnp_ransac: samples [iters,6]")
    dev = uv.device
    R = torch.empty(3, 3, dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    ints = torch.zeros(3, dtype=torch.int32, device=dev)   # n, best, rot.
    counts = torch.empty(iters, dtype=torch.int32, device=dev)
    hyp = torch.empty(iters, 12, dtype=torch.float64, device=dev)
    work = torch.empty(n, dtype=torch.float64, device=dev)
    PNP_RANSAC.launch(
        cuda.ptr(uv), cuda.ptr(X), cuda.ptr(valid), n, cuda.ptr(samples),
        iters, K.fx, K.fy, K.cx, K.cy, float(chi2_th), cuda.ptr(hyp),
        cuda.ptr(counts), cuda.ptr(work), cuda.ptr(R), cuda.ptr(t),
        cuda.ptr(inl), cuda.ptr(ints), cuda.stream(), kernels=2)
    if stats is not None:
        stats["rotations"] = ints[2]
    return PnPResult(R, t, inl, ints[0], ints[1], counts)


def mlpnp_refine(K: PinholeK, uv: torch.Tensor, X: torch.Tensor,
                 inliers: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                 iters: int = 8, chi2_th: float = 5.991):
    """Maximum-likelihood PnP refinement on bearing vectors from (R0, t0)
    over the inlier set; returns (R, t, inl, n_inl) with a strict chi2
    re-score.  CPU tensors take the plain version; CUDA tensors launch
    csrc/pnp.cu (one block)."""
    if uv.device.type == "cpu":
        return mlpnp_refine_plain(K, uv, X, inliers, R0, t0, iters, chi2_th)
    n = _check("mlpnp_refine", uv, X, inliers)
    R0 = R0.to(torch.float32).contiguous()
    t0 = t0.to(torch.float32).contiguous()
    cuda.check_cuda("mlpnp_refine", R0, t0)
    if R0.shape != (3, 3) or t0.shape != (3,):
        raise ValueError("mlpnp_refine: R0 [3,3], t0 [3]")
    dev = uv.device
    R = torch.empty(3, 3, dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    MLPNP_REFINE.launch(
        cuda.ptr(uv), cuda.ptr(X), cuda.ptr(inliers), n, cuda.ptr(R0),
        cuda.ptr(t0), iters, K.fx, K.fy, K.cx, K.cy, float(chi2_th),
        cuda.ptr(R), cuda.ptr(t), cuda.ptr(inl), cuda.ptr(cnt),
        cuda.stream())
    return R, t, inl, cnt


SIM3_RANSAC = cuda.Kernel("sim3", "sim3_ransac",
                          [_P, _P, _P, _I, _P, _I, _D, _I, _P, _P, _P, _P])
SIM3_MAX_N = 1024


def sim3_ransac(X1: torch.Tensor, X2: torch.Tensor, valid: torch.Tensor,
                samples: torch.Tensor, th: float = 0.05,
                fix_scale: bool = False) -> Sim3Result:
    """Robust similarity X2 ~ s R X1 + t between matched 3D points X1 / X2
    [N,3] float32 (valid [N]) from the hypotheses of samples [iters,3]
    (valid rows, each row's 3 distinct).  CPU tensors take the plain
    version; CUDA tensors launch csrc/sim3.cu (one block, float64)."""
    if X1.device.type == "cpu":
        return sim3_ransac_plain(X1, X2, valid, samples.to(X1.device), th,
                                 fix_scale)
    n = X1.shape[0]
    cuda.check_cuda("sim3_ransac", X1, X2, valid)
    if X1.dtype != torch.float32 or X2.dtype != torch.float32 \
            or X1.shape != (n, 3) or X2.shape != (n, 3) \
            or valid.dtype != torch.bool or valid.shape != (n,):
        raise ValueError("sim3_ransac: X1 / X2 [N,3] float32, valid [N] "
                         "bool")
    if not 3 <= n <= SIM3_MAX_N:
        raise ValueError(f"sim3_ransac: needs 3 <= N <= {SIM3_MAX_N}")
    samples = samples.to(device=X1.device, dtype=torch.int32).contiguous()
    iters = samples.shape[0]
    if samples.shape != (iters, 3) or not 1 <= iters <= 1024:
        raise ValueError("sim3_ransac: samples [iters,3], iters <= 1024")
    dev = X1.device
    out = torch.empty(13, dtype=torch.float32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    ints = torch.empty(2 + iters, dtype=torch.int32, device=dev)
    SIM3_RANSAC.launch(cuda.ptr(X1), cuda.ptr(X2), cuda.ptr(valid), n,
                       cuda.ptr(samples), iters, float(th), int(fix_scale),
                       cuda.ptr(out), cuda.ptr(inl), cuda.ptr(ints),
                       cuda.stream())
    return Sim3Result(out[12], out[:9].view(3, 3), out[9:12], inl, ints[0],
                      ints[1], ints[2:])


# a float32 floor of a pose entry's gap to float64: the DLT's null vector
# on raw world coordinates is ill-conditioned (1.4e-5 on the MH replay's
# hall, tests/test_torch_pnp.py)
FLOOR = 1e-5
GATE_PX2 = 1e-3         # rows this close to the chi2 gate may flip
FLIPS = 0.01            # ... at most this share of the rows


def _gap(R, t, R64, t64) -> float:
    P = torch.cat([R.double().cpu(), t.double().cpu()[:, None]], 1)
    P64 = torch.cat([R64.cpu(), t64.cpu()[:, None]], 1)
    return float((P - P64).abs().max())


def _mask_flips(mask, mask64, chi2_64, th) -> list:
    """Rows where mask differs from the float64 run's, unless within
    GATE_PX2 of the gate th (and at most FLIPS of the rows)."""
    diff = torch.nonzero(mask.cpu() != mask64.cpu())[:, 0]
    near = (chi2_64[diff] - th).abs() < GATE_PX2
    if len(diff) > FLIPS * len(mask) or not bool(near.all()):
        return diff.tolist()
    return []


def kernels_against_float64(K: PinholeK, uv, X, valid, samples,
                            chi2_th: float = 5.991) -> dict:
    """`pnp_ransac` and `mlpnp_refine` on the card against the plain
    version's float64 run on the CPU, on the same inputs and samples (the
    refinement from that run's pose and inliers cast to float32), beside
    the plain float32 run on the CPU.  The rule (the one chip_smoke.py and
    the card test hold): the best hypothesis equal, inlier masks equal
    but for rows within GATE_PX2 of the gate (FLIPS of them at most), each
    pose within 2x the plain float32 run's largest pose-entry gap to
    float64 plus FLOOR.  Returns dict(failures, ransac_gap, ransac_plain_gap,
    ml_gap, ml_plain_gap, n, n_ml, best)."""
    cpu = [t.detach().cpu() for t in (uv, X, valid, samples)]
    u, x, v, s = cpu
    k = pnp_ransac(K, uv, X, valid, samples, chi2_th)
    p32 = pnp_ransac_plain(K, u, x, v, s, chi2_th)
    p64 = pnp_ransac_plain(K, u.double(), x.double(), v, s, chi2_th)
    chi2, _ = _chi2(K, u.double(), x.double(), p64.R, p64.t)
    out = dict(ransac_gap=_gap(k.R, k.t, p64.R, p64.t),
               ransac_plain_gap=_gap(p32.R, p32.t, p64.R, p64.t),
               n=int(k.n), best=int(k.best), failures=[])
    fail = out["failures"]
    if int(k.best) != int(p64.best):
        fail.append(f"pnp_ransac best {int(k.best)} != {int(p64.best)}")
    flips = _mask_flips(k.inliers, p64.inliers, chi2, chi2_th)
    if flips:
        fail.append(f"pnp_ransac inliers differ on rows {flips}")
    if out["ransac_gap"] > 2 * out["ransac_plain_gap"] + FLOOR:
        fail.append(f"pnp_ransac pose gap {out['ransac_gap']:.2e} > 2 x "
                    f"{out['ransac_plain_gap']:.2e} + {FLOOR}")
    R0, t0 = p64.R.float(), p64.t.float()
    Rk, tk, ik, nk = mlpnp_refine(K, uv, X, p64.inliers.to(uv.device),
                                  R0.to(uv.device), t0.to(uv.device),
                                  chi2_th=chi2_th)
    R32, t32, _, _ = mlpnp_refine_plain(K, u, x, p64.inliers, R0, t0,
                                        chi2_th=chi2_th)
    R64, t64, i64, _ = mlpnp_refine_plain(K, u.double(), x.double(),
                                          p64.inliers, R0.double(),
                                          t0.double(), chi2_th=chi2_th)
    chi2m, _ = _chi2(K, u.double(), x.double(), R64, t64)
    out.update(ml_gap=_gap(Rk, tk, R64, t64),
               ml_plain_gap=_gap(R32, t32, R64, t64), n_ml=int(nk))
    flips = _mask_flips(ik, i64, chi2m, chi2_th)
    if flips:
        fail.append(f"mlpnp_refine inliers differ on rows {flips}")
    if out["ml_gap"] > 2 * out["ml_plain_gap"] + FLOOR:
        fail.append(f"mlpnp_refine pose gap {out['ml_gap']:.2e} > 2 x "
                    f"{out['ml_plain_gap']:.2e} + {FLOOR}")
    return out


def sim3_against_float64(X1, X2, valid, samples, th: float = 0.08,
                         fix_scale: bool = False) -> dict:
    """`sim3_ransac` on the card against the plain version's float32 and
    float64 runs on the CPU with the same samples, launched twice.  The
    rule (chip_smoke.py and the card test): the best hypothesis and its
    count equal to the float64 run's, the inlier masks equal but for rows
    within 1e-6 (relative) of the gate, (s, R, t) within 2x the plain
    float32 run's largest gap to float64 + 1e-6, the same bits on the
    second launch.  Returns dict(gap, plain_gap, n, best, failures)."""
    k = sim3_ransac(X1, X2, valid, samples, th, fix_scale)
    k2 = sim3_ransac(X1, X2, valid, samples, th, fix_scale)
    u1, u2, v, s = (t.detach().cpu() for t in (X1, X2, valid, samples))
    p = sim3_ransac_plain(u1, u2, v, s, th, fix_scale)
    p64 = sim3_ransac_plain(u1.double(), u2.double(), v, s, th, fix_scale)

    def gap(r):
        return max(abs(float(r.s) - float(p64.s)),
                   float((r.R.double().cpu() - p64.R).abs().max()),
                   float((r.t.double().cpu() - p64.t).abs().max()))
    out = dict(gap=gap(k), plain_gap=gap(p), n=int(k.n), best=int(k.best))
    fail = []
    if not all(torch.equal(a, b) for a, b in zip(k, k2)):
        fail.append("a second launch gave other bits")
    if int(k.best) != int(p64.best) or int(k.n) != int(p64.n):
        fail.append(f"best {int(k.best)} / {int(k.n)} inliers != "
                    f"{int(p64.best)} / {int(p64.n)}")
    A, B = u1.double(), u2.double()
    idx = s[int(p64.best)].long()
    hs, hR, ht = sim3_horn(A[idx], B[idx], fix_scale)
    d = torch.linalg.vector_norm(hs * A @ hR.T + ht - B, dim=-1)
    scale_ref = torch.sqrt(torch.clamp_min(
        ((B - B.mean(0)) ** 2).sum(-1), 1e-9)).mean()
    gate = th * scale_ref
    near = (d - gate).abs() <= 1e-6 * gate
    diff = k.inliers.cpu() != p64.inliers
    if bool((diff & ~near).any()):
        fail.append(f"inlier masks differ on rows "
                    f"{torch.nonzero(diff & ~near)[:, 0].tolist()}")
    if out["gap"] > 2 * out["plain_gap"] + 1e-6:
        fail.append(f"(s, R, t) {out['gap']:.2e} from float64 > 2x the "
                    f"plain run's {out['plain_gap']:.2e} + 1e-6")
    out["failures"] = fail
    return out
