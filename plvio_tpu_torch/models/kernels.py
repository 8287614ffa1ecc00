"""Tracking, mapping and loop-closing kernels (port of
plvio_tpu/models/kernels.py: `make_pose_optimizer` :88, `fast_pose_opt`
:111, `fast_pose_opt_pl` :179, `make_fast_pose_optimizer_pl` :312,
`make_line_projection_matcher` :334, `line_proj_match_core` :355,
`make_line_triangulator` :389, `make_pose_graph_optimizer` :488,
`make_sim3_reproj_optimizer` :524, `make_line_pair_matcher` :605,
`make_local_ba_pl` :641,
`make_projection_matcher` :767,
`make_epipolar_matcher` :828, `make_triangulator` :878,
`make_vi_pose_optimizer` :932, `make_local_ba` :1307,
`make_pose_optimizer_stereo` :687, `make_projection_matcher_kb8` :1443,
`make_pose_optimizer_kb8` :1493, and the line-only modes'
`make_pose_opt_line_only` :1344 and `make_local_ba_lines_only` :1394).

`pose_lm` is the hand-written CUDA kernel (csrc/pose_lm.cu) of the
pose-only LM of STEREO / RGB-D without lines (`stereo_pose_lm`, counted
as `POSE_LM_STEREO`) and of the KB8 fisheye (`kb8_pose_lm`,
`POSE_LM_KB8`); their plain versions run the same problems on the engine
(`stereo_pose_lm_plain`, `kb8_pose_lm_plain`), and
`pose_lm_against_float64` holds the kernel to their float64 runs.  Its
line families solve SLAM modes 1-3's pose from lines alone
(`line_only_pose_lm`, `POSE_LM_LINE`; plain `line_only_pose_lm_plain`).
A KB8K camera takes `proj_match`'s and `ba_linearize`'s KB8 modes
(`PROJ_MATCH_KB8`; `BA_LINEARIZE_KB8` in the point-only window,
`BA_LINEARIZE_KB8_BODY` in the inertial ones, `BA_LINEARIZE_KB8_LINES`
beside the line family); the line-only window BA of SLAM modes 1-3
(`local_ba_lines_only`) runs `ba_linearize`'s line-only mode
(`BA_LINEARIZE_LINE_ONLY`) with no point family.
`against_float64` holds a solver's kernel path (a pose solve, a window
BA) to float64 runs of its plain version; `linearization_against_plain`
holds one linearization of a window BA to the plain engine's normal
equations.

`pose_irls` is the hand-written CUDA kernel (csrc/pose_irls.cu) for the
fused point+line pose IRLS, with the stereo / RGB-D right-eye rows where
a u_R column is given (its launches counted as `POSE_IRLS_STEREO`);
`pose_irls_plain` beside it is the same algorithm in plain PyTorch with
an exact Cholesky solve where the reference runs 6 CG steps (equivalent
for this damped 6x6 system).

`vi_pose_lm` is the hand-written CUDA kernel (csrc/vi_pose_lm.cu) of the
VI frame's 30-DoF pose optimization, with IMU_STEREO's 3-row stereo term
where a u_R column is given (`VI_POSE_LM_STEREO`); `vi_pose_opt_plain`
beside it runs the same problem on the dense LM engine
(solver/engine.py).  `pose_irls_against_float64` and
`vi_pose_lm_against_float64` hold the kernels to float64 runs of the
plain versions for the card.

The keyframe mapping step: `make_epipolar_matcher` (the `hamming_match`
kernel in its epipolar gate mode, then `rot_hist`), `make_triangulator`
(csrc/triangulate.cu beside `triangulate_plain`) and `make_local_ba_pl`,
whose kernel path runs every LM iteration on csrc/ba_linearize.cu and
csrc/schur_solve.cu with the accept/reject and early exit on the device;
its plain version `local_ba_pl_plain` runs the engine's Schur path.

The keyframe step's neighbourhood work: `make_line_pair_matcher` (the
`hamming_match` kernel's line pair mode), `make_line_triangulator`
(csrc/line_triangulate.cu beside `line_triangulate_plain`),
`make_projection_matcher` (csrc/proj_match.cu beside `proj_match_plain`;
the fuse's and the tracker's matcher) and `make_local_ba`, the point-only
window BA (`local_ba_pl`'s kernel path with an empty line family).

Loop closing: `make_sim3_reproj_optimizer` (csrc/sim3.cu's `sim3_reproj`
beside `sim3_reproj_plain` on the engine) and `make_pose_graph_optimizer`
(csrc/pose_graph.cu beside `pose_graph_plain`, the engine's dense LM with
its Cholesky), with their float64 checks for the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda
from ..ops import matching as M
from ..ops import twoview as TV
from ..solver import engine as E
from ..solver import residuals as RES
from ..solver.residuals import PinholeK
from ..utils import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def project(K: PinholeK, pc: torch.Tensor) -> torch.Tensor:
    """Pinhole projection [N,3] -> [N,2] with the depth clamped at 1e-4."""
    z = torch.clamp_min(pc[:, 2], 1e-4)
    return torch.stack([K.fx * pc[:, 0] / z + K.cx,
                        K.fy * pc[:, 1] / z + K.cy], -1)


def _proj_jac(K: PinholeK, pc: torch.Tensor):
    """d(u,v)/dpc rows (ju, jv) with the reference's clamped depth."""
    z = torch.clamp_min(pc[:, 2], 1e-4)
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    ju = torch.stack([K.fx * inv_z, zero, -K.fx * pc[:, 0] * inv_z ** 2], -1)
    jv = torch.stack([zero, K.fy * inv_z, -K.fy * pc[:, 1] * inv_z ** 2], -1)
    return ju, jv


def pose_irls_plain(K: PinholeK, pose0, uv, X, valid, inv_sigma2,
                    l_obs, Xs, Xe, valid_l, is2_l, rounds: int = 4,
                    iters: int = 3, w_line: float = 1.0, ur=None,
                    bf: float = 0.0):
    """Plain version of `pose_irls`.  Returns (pose [3,4], inlier_pt [N],
    inlier_ln [L], n_inliers int32 scalar)."""
    delta = float(math.sqrt(CHI2_MONO))
    eye6 = torch.eye(6, dtype=pose0.dtype, device=pose0.device)
    stereo = ur is not None
    chi2_pt_th = CHI2_MONO
    if stereo:
        has_r = (ur > 0).to(pose0.dtype)
        chi2_pt_th = torch.where(ur > 0, CHI2_STEREO, CHI2_MONO).to(
            pose0.dtype)
        bf_t = torch.tensor(bf, dtype=pose0.dtype, device=pose0.device)

    def point_part(Rt):
        pc = X @ Rt[:, :3].T + Rt[:, 3]
        uvp = project(K, pc)
        r = uvp - uv
        if stereo:
            z = torch.clamp_min(pc[:, 2], 1e-4)
            r3 = (uvp[:, 0] - bf_t / z - ur) * has_r
            r = torch.cat([r, r3[:, None]], 1)
        return r, pc, (r * r).sum(-1) * inv_sigma2

    def line_endpoint(Rt, Xep):
        pc = Xep @ Rt[:, :3].T + Rt[:, 3]
        uvp = project(K, pc)
        r = l_obs[:, 0] * uvp[:, 0] + l_obs[:, 1] * uvp[:, 1] + l_obs[:, 2]
        ju, jv = _proj_jac(K, pc)
        jp = l_obs[:, 0:1] * ju + l_obs[:, 1:2] * jv
        jphi = -torch.einsum("ni,nik->nk", jp, lie.hat(pc))
        return r, torch.cat([jp, jphi], -1), pc[:, 2]

    def line_chi2(Rt):
        rs, _, zs = line_endpoint(Rt, Xs)
        re, _, ze = line_endpoint(Rt, Xe)
        return (rs * rs + re * re) * is2_l, (zs > 0.05) & (ze > 0.05)

    Rt = pose0
    gate_p = valid.to(pose0.dtype)
    gate_l = valid_l.to(pose0.dtype)
    for i in range(rounds * iters):
        r, pc, chi2 = point_part(Rt)
        chi2_l, depth_ok = line_chi2(Rt)
        if i % iters == 0 and i > 0:
            gate_p = (valid & (chi2 < chi2_pt_th)).to(pose0.dtype)
            gate_l = (valid_l & (chi2_l < CHI2_MONO)).to(pose0.dtype)
        w_h = torch.clamp_max(delta / torch.sqrt(torch.clamp_min(chi2, 1e-12)),
                              1.0)
        w = gate_p * (pc[:, 2] > 0.05).to(pose0.dtype) * w_h * inv_sigma2
        ju, jv = _proj_jac(K, pc)
        rows = [ju, jv]
        if stereo:
            # d(u - bf/z)/dpc, masked to the stereo rows
            iz = 1.0 / torch.clamp_min(pc[:, 2], 1e-4)
            rows.append(torch.stack([
                K.fx * iz, torch.zeros_like(iz),
                (-K.fx * pc[:, 0] + bf) * iz ** 2], -1) * has_r[:, None])
        Jp = torch.stack(rows, 1)                           # [N,2|3,3]
        Jphi = -torch.einsum("nij,njk->nik", Jp, lie.hat(pc))
        J = torch.cat([Jp, Jphi], -1)                       # [N,2|3,6]
        Jw = J * w[:, None, None]
        H = torch.einsum("ndi,ndj->ij", Jw, J)
        g = torch.einsum("ndi,nd->i", Jw, r)
        wl_h = torch.clamp_max(
            delta / torch.sqrt(torch.clamp_min(chi2_l, 1e-12)), 1.0)
        wl = gate_l * depth_ok.to(pose0.dtype) * wl_h * is2_l * w_line
        for Xep in (Xs, Xe):
            rl, Jl, _ = line_endpoint(Rt, Xep)
            Jlw = Jl * wl[:, None]
            H = H + Jlw.T @ Jl
            g = g + Jlw.T @ rl
        H = H + torch.diag(torch.diagonal(H)) * 1e-3 + eye6 * 1e-6
        Lc, _ = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve(g[:, None], Lc)[:, 0]
        Rn, tn = lie.se3_exp(dx)
        Rt = torch.cat([lie.so3_normalize(Rn @ Rt[:, :3]),
                        (Rn @ Rt[:, 3] + tn)[:, None]], 1)
    _, _, chi2 = point_part(Rt)
    chi2_l, _ = line_chi2(Rt)
    inl_p = valid & (chi2 < chi2_pt_th)
    inl_l = valid_l & (chi2_l < CHI2_MONO)
    return Rt, inl_p, inl_l, (inl_p.sum() + inl_l.sum()).to(torch.int32)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_POSE_IRLS_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _F,
                   _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P]
# one library entry; the launches with the stereo rows are counted apart
POSE_IRLS = cuda.Kernel("pose_irls", "pose_irls", _POSE_IRLS_ARGS)
POSE_IRLS_STEREO = cuda.Kernel("pose_irls", "pose_irls", _POSE_IRLS_ARGS)


def pose_irls(K: PinholeK, pose0, uv, X, valid, inv_sigma2,
              l_obs, Xs, Xe, valid_l, is2_l, rounds: int = 4,
              iters: int = 3, w_line: float = 1.0, ur=None,
              bf: float = 0.0):
    """Fused point+line pose-only IRLS.  pose0 [3,4] T_cw; points uv
    [N,2], X [N,3], valid [N] bool, inv_sigma2 [N]; lines l_obs [L,3],
    Xs/Xe [L,3], valid_l [L] bool, is2_l [L] (L may be 0); stereo / RGB-D
    (ur given, bf = baseline * fx > 0): ur [N] the right-eye u_R of each
    point, <= 0 for a mono one.  Returns (pose, inlier_pt, inlier_ln,
    n_inliers int32 scalar).  CPU tensors take the plain version; CUDA
    tensors launch csrc/pose_irls.cu."""
    if pose0.device.type == "cpu":
        return pose_irls_plain(K, pose0, uv, X, valid, inv_sigma2, l_obs, Xs,
                               Xe, valid_l, is2_l, rounds, iters, w_line, ur,
                               bf)
    n, L = X.shape[0], Xs.shape[0]
    cuda.check_cuda("pose_irls", pose0, uv, X, valid, inv_sigma2, l_obs, Xs,
                    Xe, valid_l, is2_l)
    f32 = [pose0, uv, X, inv_sigma2, l_obs, Xs, Xe, is2_l]
    if any(t.dtype != torch.float32 for t in f32) \
            or valid.dtype != torch.bool or valid_l.dtype != torch.bool:
        raise ValueError("pose_irls: float32 inputs and bool masks")
    if pose0.shape != (3, 4) or uv.shape != (n, 2) or X.shape != (n, 3) \
            or valid.shape != (n,) or inv_sigma2.shape != (n,) \
            or l_obs.shape != (L, 3) or Xe.shape != (L, 3) \
            or Xs.shape != (L, 3) or valid_l.shape != (L,) \
            or is2_l.shape != (L,):
        raise ValueError("pose_irls: shape mismatch")
    if ur is not None:
        cuda.check_cuda("pose_irls", pose0, ur)
        if ur.dtype != torch.float32 or ur.shape != (n,) or not bf > 0:
            raise ValueError("pose_irls: ur [N] float32 with bf > 0")
    if n + L > 200_000:
        raise ValueError("pose_irls: the gates of N + L rows must fit in "
                         "shared memory (N + L <= 200000)")
    dev = pose0.device
    pose = torch.empty(3, 4, dtype=torch.float32, device=dev)
    inl_p = torch.empty(n, dtype=torch.bool, device=dev)
    inl_l = torch.empty(L, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    (POSE_IRLS if ur is None else POSE_IRLS_STEREO).launch(
        cuda.ptr(pose0), cuda.ptr(uv), cuda.ptr(X), cuda.ptr(valid),
        cuda.ptr(inv_sigma2), n, cuda.ptr(l_obs), cuda.ptr(Xs), cuda.ptr(Xe),
        cuda.ptr(valid_l), cuda.ptr(is2_l), L,
        None if ur is None else cuda.ptr(ur), float(bf), K.fx, K.fy, K.cx,
        K.cy, float(w_line), float(math.sqrt(CHI2_MONO)), rounds, iters,
        cuda.ptr(pose), cuda.ptr(inl_p), cuda.ptr(inl_l), cuda.ptr(n_inl),
        cuda.stream())
    return pose, inl_p, inl_l, n_inl


def fast_pose_opt_pl(K: PinholeK, pose0, uv, X, valid, inv_sigma2,
                     l_obs, Xs, Xe, valid_l, is2_l, rounds: int = 4,
                     iters: int = 3, w_line: float = 1.0, plain: bool = False,
                     ur=None, bf: float = 0.0):
    """Point+line pose IRLS (with the stereo third row where ur is given).
    Returns (pose, inlier_pt, inlier_ln, n_inliers)."""
    fn = pose_irls_plain if plain else pose_irls
    return fn(K, pose0, uv, X, valid, inv_sigma2, l_obs, Xs, Xe, valid_l,
              is2_l, rounds, iters, w_line, ur, bf)


def fast_pose_opt(K: PinholeK, pose0, uv, X, valid, inv_sigma2,
                  rounds: int = 4, iters: int = 3, plain: bool = False):
    """Point-only pose IRLS (the L = 0 case).  Returns (pose, inlier,
    n_inliers)."""
    e3 = torch.zeros(0, 3, dtype=X.dtype, device=X.device)
    e1 = torch.zeros(0, dtype=X.dtype, device=X.device)
    pose, inl, _, n = fast_pose_opt_pl(
        K, pose0, uv, X, valid, inv_sigma2, e3, e3, e3,
        torch.zeros(0, dtype=torch.bool, device=X.device), e1, rounds, iters,
        plain=plain)
    return pose, inl, n


def make_pose_optimizer(K: PinholeK, rounds: int = 4, iters: int = 3,
                        plain: bool = False):
    """run(pose0 [3,4], uv [cap,2], X [cap,3], valid, inv_sigma2) ->
    (pose, inlier, n_inliers): the tracker's point-only pose IRLS
    (models/kernels.py:88, `pose_irls` with no lines)."""
    def run(pose0, uv, X, valid, is2):
        return fast_pose_opt(K, pose0.contiguous(), uv.contiguous(),
                             X.contiguous(), valid, is2.contiguous(), rounds,
                             iters, plain=plain)
    return run


def make_fast_pose_optimizer_pl(K: PinholeK, rounds: int = 4,
                                iters: int = 3, plain: bool = False,
                                bf: float = 0.0):
    """run(pose0 [3,4], uv [cap,2], X [cap,3], valid, is2, l_obs [L,3],
    Xs [L,3], Xe [L,3], valid_l, is2_l) -> (pose, inlier_pt, inlier_ln,
    n_inliers): the tracker's point+line pose IRLS (models/kernels.py:312),
    on `pose_irls`.  bf > 0 builds the stereo / RGB-D flavour, whose run
    takes a trailing ur [cap] (u_R; <= 0 marks a mono point)."""
    def run(pose0, uv, X, valid, is2, l_obs, Xs, Xe, valid_l, is2_l,
            *ur):
        if (len(ur) == 1) != (bf > 0):
            raise TypeError("the stereo flavour (bf > 0) takes ur, the mono "
                            "one does not")
        c = [t.contiguous() for t in (pose0, uv, X, is2, l_obs, Xs, Xe,
                                       is2_l)]
        return fast_pose_opt_pl(K, c[0], c[1], c[2], valid, c[3], c[4], c[5],
                                c[6], valid_l, c[7], rounds, iters,
                                plain=plain,
                                ur=ur[0].contiguous() if ur else None, bf=bf)
    return run


# --------------------------------------------------------------------------
# The pose-only LM of STEREO / RGB-D without lines and of the KB8 fisheye
# --------------------------------------------------------------------------

def _pose_lm_run(terms, pose0, rounds: int, iters: int, gate_key=None):
    """`rounds` x `iters` LM iterations of the engine on one pose block,
    each round's masks re-gated on the chi2 at its result.  terms: [(name,
    res_fn, rdim, const, gate, chi2 gate, info)], gate the rows a term
    holds (its first round's mask), the Huber delta the chi2 gate's
    square root.  With `gate_key` every term's mask is re-gated on that
    term's chi2 (the terms then share their rows).  Returns (pose, {name:
    mask})."""
    cap = terms[0][4].shape[0]
    zero = torch.zeros(cap, dtype=torch.long, device=pose0.device)
    masks = {t[0]: t[4] for t in terms}
    states = {"pose": pose0[None]}
    for _ in range(rounds):
        prob = E.Problem()
        prob.add_dense("pose", 1, 6, RES.retract_pose_cw)
        for name, res_fn, rdim, const, _, chi2_th, is2 in terms:
            prob.add_term(E.Term(
                name=name, res_fn=res_fn, rdim=rdim,
                dense_refs=[("pose", zero)], const=const, mask=masks[name],
                info=is2, robust_delta=float(math.sqrt(chi2_th))))
        states, _, chi2s = E.optimize(prob, states, iters=iters)
        for name, _, _, _, gate, chi2_th, _ in terms:
            masks[name] = gate & (chi2s[gate_key or name] < chi2_th)
    return states["pose"][0], masks


def stereo_pose_lm_plain(K: PinholeK, bf: float, pose0, uvr, X, valid, is2,
                         rounds: int = 4, iters: int = 10):
    """Plain version of `pose_lm`'s stereo mode on the engine, in the
    inputs' dtype: a stereo term of (u, v, u_R) rows (Huber sqrt(7.815))
    where u_R > 0 and a mono term of (u, v) rows (sqrt(5.991)) elsewhere.
    Returns (pose [3,4], inlier [cap], n int32)."""
    has_r = uvr[:, 2] > 0
    pose, masks = _pose_lm_run([
        ("stereo", RES.make_stereo_reproj_fixed(K, bf), 3,
         {"uvr": uvr, "X": X}, valid & has_r, CHI2_STEREO, is2),
        ("mono", RES.make_point_reproj_fixed(K), 2,
         {"uv": uvr[:, :2].contiguous(), "X": X}, valid & ~has_r, CHI2_MONO,
         is2)], pose0, rounds, iters)
    inlier = masks["stereo"] | masks["mono"]
    return pose, inlier, inlier.sum().to(torch.int32)


def kb8_pose_lm_plain(K8: RES.KB8K, pose0, uv, X, valid, is2,
                      rounds: int = 3, iters: int = 6):
    """Plain version of `pose_lm`'s KB8 mode on the engine, in the inputs'
    dtype: KB8 (u, v) rows on raw pixels, Huber sqrt(5.991).  Returns
    (pose [3,4], inlier [cap], n int32)."""
    pose, masks = _pose_lm_run([
        ("reproj", RES.make_point_reproj_kb8_fixed(K8), 2,
         {"uv": uv, "X": X}, valid, CHI2_MONO, is2)], pose0, rounds, iters)
    return pose, masks["reproj"], masks["reproj"].sum().to(torch.int32)


def line_only_pose_lm_plain(K: PinholeK, mode: int, pose0, l_obs, dir_obs,
                            Xs, Xe, valid, is2, rounds: int = 3,
                            iters: int = 6):
    """Plain version of `pose_lm`'s line-only families on the engine, in
    the inputs' dtype (models/kernels.py:1344-1391): mode 1 the two
    endpoint-to-line rows of each line (Huber sqrt(5.991)), mode 2 the
    angle row (information ANG_INFO x is2), mode 3 both, every term on
    the rows of one mask re-gated at 5.991 on the endpoint term's chi2
    (modes 1, 3) or the angle term's (mode 2).  Returns (pose [3,4],
    inlier [cap], n int32)."""
    if mode not in (1, 2, 3):
        raise ValueError("line-only pose LM: mode 1, 2 or 3")
    terms = []
    if mode in (1, 3):
        terms.append(("ep", RES.make_line_reproj_fixed(K), 2,
                      {"l": l_obs, "Xs": Xs, "Xe": Xe}, valid, CHI2_MONO,
                      is2))
    if mode in (2, 3):
        terms.append(("ang", RES.make_line_angle_fixed(K), 1,
                      {"dir": dir_obs, "Xs": Xs, "Xe": Xe}, valid,
                      CHI2_MONO, is2 * ANG_INFO))
    key = "ep" if mode in (1, 3) else "ang"
    pose, masks = _pose_lm_run(terms, pose0, rounds, iters, gate_key=key)
    return pose, masks[key], masks[key].sum().to(torch.int32)


_POSE_LM_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I] \
    + [ctypes.c_double] * 9 + [_P, _P, _P, _P, _P, _P]
# one library entry, its residual families counted apart: stereo, KB8 and
# the three line-only families (counted as one)
POSE_LM_STEREO = cuda.Kernel("pose_lm", "pose_lm", _POSE_LM_ARGS)
POSE_LM_KB8 = cuda.Kernel("pose_lm", "pose_lm", _POSE_LM_ARGS)
POSE_LM_LINE = cuda.Kernel("pose_lm", "pose_lm", _POSE_LM_ARGS)
# csrc/pose_lm.cu's family of line-only mode 1, 2, 3
LINE_FAMILY = {1: 2, 2: 3, 3: 4}


def _pose_lm(family: int, K, bf: float, pose0, obs, X, valid, is2,
             rounds: int, iters: int, Xe=None, dir_obs=None):
    cap = X.shape[0]
    w = 3 if family in (0, 2, 3, 4) else 2
    line = family >= 2
    if line != (Xe is not None and dir_obs is not None):
        raise ValueError("pose_lm: the line families take Xe and dir_obs, "
                         "the others neither")
    extra = (Xe, dir_obs) if line else ()
    cuda.check_cuda("pose_lm", pose0, obs, X, valid, is2, *extra)
    if line and (Xe.shape != (cap, 3) or dir_obs.shape != (cap, 2)
                 or Xe.dtype != torch.float32
                 or dir_obs.dtype != torch.float32):
        raise ValueError("pose_lm: float32 Xe [cap,3] and dir_obs [cap,2]")
    if any(t.dtype != torch.float32 for t in (pose0, obs, X, is2)) \
            or valid.dtype != torch.bool or pose0.shape != (3, 4) \
            or obs.shape != (cap, w) or X.shape != (cap, 3) \
            or valid.shape != (cap,) or is2.shape != (cap,):
        raise ValueError(f"pose_lm: float32 pose0 [3,4], obs [cap,{w}], X "
                         "[cap,3], is2 [cap] and bool valid [cap]")
    if not 1 <= cap <= 32768:
        raise ValueError("pose_lm: 1 <= cap <= 32768 (the masks live in "
                         "shared memory)")
    dev = pose0.device
    pose = torch.empty(3, 4, dtype=torch.float32, device=dev)
    inlier = torch.empty(cap, dtype=torch.bool, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    ks = (K.k1, K.k2, K.k3, K.k4) if family == 1 else (0.0,) * 4
    kern = POSE_LM_STEREO if family == 0 else POSE_LM_KB8 if family == 1 \
        else POSE_LM_LINE
    kern.launch(
        family, cuda.ptr(pose0), cuda.ptr(obs), cuda.ptr(X), cuda.ptr(valid),
        cuda.ptr(is2), cap, rounds, iters, K.fx, K.fy, K.cx, K.cy,
        float(bf), *ks, cuda.ptr(pose), cuda.ptr(inlier), cuda.ptr(n),
        *[cuda.ptr(t) if line else None for t in (Xe, dir_obs)],
        cuda.stream())
    return pose, inlier, n


def line_only_pose_lm(K: PinholeK, mode: int, pose0, l_obs, dir_obs, Xs, Xe,
                      valid, is2, rounds: int = 3, iters: int = 6):
    """The line-only pose LM of SLAM modes 1-3 (pose0 [3,4] T_cw, l_obs
    [cap,3] the observed line equations, dir_obs [cap,2] their unit
    directions, Xs, Xe [cap,3] the map lines' endpoints, valid [cap] bool,
    is2 [cap]) -> (pose, inlier, n_inliers).  CPU tensors take the plain
    version; CUDA tensors launch csrc/pose_lm.cu in its line family of
    the mode (one block, float64)."""
    if pose0.device.type == "cpu":
        return line_only_pose_lm_plain(K, mode, pose0, l_obs, dir_obs, Xs,
                                       Xe, valid, is2, rounds, iters)
    if mode not in LINE_FAMILY:
        raise ValueError("line-only pose LM: mode 1, 2 or 3")
    return _pose_lm(LINE_FAMILY[mode], K, 0.0, pose0, l_obs, Xs, valid, is2,
                    rounds, iters, Xe=Xe, dir_obs=dir_obs)


def make_pose_opt_line_only(K: PinholeK, mode: int, rounds: int = 3,
                            iters: int = 6, plain: bool = False):
    """run(pose0 [3,4], l_obs [cap,3], dir_obs [cap,2], Xs [cap,3], Xe
    [cap,3], valid, is2) -> (pose, inlier, n_inliers): the tracker's pose
    solve from lines alone under SLAM mode 1, 2 or 3 (reference
    PoseOptimizationOnlyLine / OnlyLineAngles / OnlyLineWithAngles;
    models/kernels.py:1344), 3 rounds x 6 LM iterations, on
    `line_only_pose_lm`.  `plain` runs the plain version on any device."""
    fn = line_only_pose_lm_plain if plain else line_only_pose_lm

    def run(pose0, l_obs, dir_obs, Xs, Xe, valid, is2):
        return fn(K, mode, *[t.contiguous() for t in (
            pose0, l_obs, dir_obs, Xs, Xe)], valid, is2.contiguous(),
            rounds, iters)
    return run


def stereo_pose_lm(K: PinholeK, bf: float, pose0, uvr, X, valid, is2,
                   rounds: int = 4, iters: int = 10):
    """The pose-only LM of STEREO / RGB-D without lines (pose0 [3,4] T_cw,
    uvr [cap,3] = (u, v, u_R), u_R <= 0 for a row without depth, X
    [cap,3], valid [cap] bool, is2 [cap]) -> (pose, inlier, n_inliers).
    CPU tensors take the plain version; CUDA tensors launch
    csrc/pose_lm.cu in its stereo mode (one block, float64)."""
    if pose0.device.type == "cpu":
        return stereo_pose_lm_plain(K, bf, pose0, uvr, X, valid, is2, rounds,
                                    iters)
    return _pose_lm(0, K, bf, pose0, uvr, X, valid, is2, rounds, iters)


def kb8_pose_lm(K8: RES.KB8K, pose0, uv, X, valid, is2, rounds: int = 3,
                iters: int = 6):
    """The KB8 fisheye's pose-only LM on raw pixels (uv [cap,2]) ->
    (pose, inlier, n_inliers).  CPU tensors take the plain version; CUDA
    tensors launch csrc/pose_lm.cu in its KB8 mode."""
    if pose0.device.type == "cpu":
        return kb8_pose_lm_plain(K8, pose0, uv, X, valid, is2, rounds, iters)
    return _pose_lm(1, K8, 0.0, pose0, uv, X, valid, is2, rounds, iters)


def make_pose_optimizer_stereo(K: PinholeK, bf: float, rounds: int = 4,
                               iters: int = 10, plain: bool = False):
    """run(pose0 [3,4], uvr [cap,3], X [cap,3], valid, is2) -> (pose,
    inlier, n_inliers): the tracker's pose solve of STEREO / RGB-D without
    lines (models/kernels.py:687), 4 rounds x 10 LM iterations, on
    `stereo_pose_lm`.  `plain` runs the plain version on any device."""
    fn = stereo_pose_lm_plain if plain else stereo_pose_lm

    def run(pose0, uvr, X, valid, is2):
        return fn(K, bf, pose0.contiguous(), uvr.contiguous(),
                  X.contiguous(), valid, is2.contiguous(), rounds, iters)
    return run


def make_pose_optimizer_kb8(K8: RES.KB8K, rounds: int = 3, iters: int = 6,
                            plain: bool = False):
    """run(pose0 [3,4], uv [cap,2] raw pixels, X [cap,3], valid, is2) ->
    (pose, inlier, n_inliers): the KB8 tracker's pose solve
    (models/kernels.py:1493), 3 rounds x 6 LM iterations, on
    `kb8_pose_lm`.  `plain` runs the plain version on any device."""
    fn = kb8_pose_lm_plain if plain else kb8_pose_lm

    def run(pose0, uv, X, valid, is2):
        return fn(K8, pose0.contiguous(), uv.contiguous(), X.contiguous(),
                  valid, is2.contiguous(), rounds, iters)
    return run


def make_line_projection_matcher(K: PinholeK, plain: bool = False):
    """run(pose [3,4], ln_ep [cap,6], ln_desc [cap,8] int32, ln_valid,
    obs_ep [F,4], obs_desc [F,8] int32, obs_angle [F], obs_valid,
    obs_lineq [F,3], radius=40.0, angle_tol=0.25) -> (ln_feat [cap] int32,
    matched [cap], l_obs_eq [cap,3]): the tracker's line projection match
    (models/kernels.py:334) on `hamming_match`'s line mode."""
    def run(pose, ln_ep, ln_desc, ln_valid, obs_ep, obs_desc, obs_angle,
            obs_valid, obs_lineq, radius: float = 40.0,
            angle_tol: float = 0.25):
        return line_proj_match_core(K, pose.contiguous(),
                                    ln_ep.contiguous(), ln_desc, ln_valid,
                                    obs_ep.contiguous(), obs_desc,
                                    obs_angle.contiguous(), obs_valid,
                                    obs_lineq, radius, angle_tol, plain)
    return run


def line_proj_match_core(K: PinholeK, pose, ln_ep, ln_desc, ln_valid,
                         obs_ep, obs_desc, obs_angle, obs_valid, obs_lineq,
                         radius: float = 40.0, angle_tol: float = 0.25,
                         plain: bool = False):
    """Project map-line endpoints, gate observed segments by midpoint
    window and angle, match LBD (ratio 0.95, mutual).  Descriptors are
    packed [*,8] int32.  Returns (idx [cap] int32, matched [cap] bool,
    l_eq [cap,3])."""
    R, t = pose[:, :3], pose[:, 3]
    pcs = ln_ep[:, :3] @ R.T + t
    pce = ln_ep[:, 3:] @ R.T + t
    zok = (pcs[:, 2] > 0.05) & (pce[:, 2] > 0.05)
    us, ue = project(K, pcs), project(K, pce)
    mid_pred = (us + ue) / 2
    ang_pred = torch.remainder(
        torch.atan2(ue[:, 1] - us[:, 1], ue[:, 0] - us[:, 0]), math.pi)
    mid_obs = (obs_ep[:, :2] + obs_ep[:, 2:]) / 2
    match = M.hamming_match_plain if plain else M.hamming_match
    idx, ok = match(ln_desc, obs_desc, ln_valid & zok, obs_valid,
                    mid_pred.contiguous(), mid_obs.contiguous(),
                    radius=radius, max_dist=110.0, ratio=0.95,
                    a_ang=ang_pred.contiguous(),
                    b_ang=obs_angle.contiguous(), angle_tol=angle_tol)
    return idx, ok, obs_lineq[idx.to(torch.int64)]


# --------------------------------------------------------------------------
# Visual-inertial pose optimization of the tracked frame
# --------------------------------------------------------------------------

# dense layout of the VI problem (declaration order pose, vel, bg, ba, two
# states each): pose [0:12), vel [12:18), bg [18:24), ba [24:30); the
# per-state 15-vector is (pose6, vel3, bg3, ba3), as make_prior15 orders it
IDX_PREV = torch.tensor(list(range(0, 6)) + list(range(12, 15))
                        + list(range(18, 21)) + list(range(24, 27)))
IDX_CUR = torch.tensor(list(range(6, 12)) + list(range(15, 18))
                       + list(range(21, 24)) + list(range(27, 30)))
PRE_KEYS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
            "bg0", "ba0")
PRIOR_KEYS = ("R0", "p0", "v0", "bg0", "ba0")


def _vi_problem(K, Rcb, tcb, gravity, cap, mask, consts, stereo=None):
    """The engine's problem in the reference's term order: reproj, (the
    stereo term when `stereo` = (bf, ur, mask_s)), inertial, the random
    walks, prior."""
    (uv, X, is2, pre_const, imu_info, bias_rw_info, prior_const,
     prior_info_safe, have_prior) = consts
    dev = uv.device
    z1 = torch.zeros(1, dtype=torch.int64, device=dev)
    o1 = torch.ones(1, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    prob = E.Problem()
    prob.add_dense("pose", 2, 6, RES.retract_pose_wb)
    prob.add_dense("vel", 2, 3, RES.retract_additive)
    prob.add_dense("bg", 2, 3, RES.retract_additive)
    prob.add_dense("ba", 2, 3, RES.retract_additive)
    prob.add_term(E.Term(
        name="reproj", res_fn=RES.make_point_reproj_body(K, Rcb, tcb),
        rdim=2, dense_refs=[("pose", torch.ones(cap, dtype=torch.int64,
                                                device=dev))],
        const={"uv": uv, "X": X}, mask=mask, info=is2,
        robust_delta=float(math.sqrt(CHI2_MONO))))
    if stereo is not None:
        bf, ur, mask_s = stereo
        prob.add_term(E.Term(
            name="stereo",
            res_fn=RES.make_stereo_reproj_body(K, bf, Rcb, tcb), rdim=3,
            dense_refs=[("pose", torch.ones(cap, dtype=torch.int64,
                                            device=dev))],
            const={"uvr": torch.cat([uv, ur[:, None]], 1), "X": X},
            mask=mask_s, info=is2,
            robust_delta=float(math.sqrt(CHI2_STEREO))))
    prob.add_term(E.Term(
        name="inertial", res_fn=RES.make_inertial(gravity), rdim=9,
        dense_refs=[("pose", z1), ("vel", z1), ("bg", o1), ("ba", o1),
                    ("pose", o1), ("vel", o1)],
        const={k: v[None] for k, v in pre_const.items()}, mask=one,
        info=imu_info[None]))
    prob.add_term(E.Term(
        name="bg_rw", res_fn=RES.bias_rw, rdim=3,
        dense_refs=[("bg", z1), ("bg", o1)], mask=one,
        info=bias_rw_info[None, :3]))
    prob.add_term(E.Term(
        name="ba_rw", res_fn=RES.bias_rw, rdim=3,
        dense_refs=[("ba", z1), ("ba", o1)], mask=one,
        info=bias_rw_info[None, 3:]))
    prob.add_term(E.Term(
        name="prior", res_fn=RES.make_prior15(), rdim=15,
        dense_refs=[("pose", z1), ("vel", z1), ("bg", z1), ("ba", z1)],
        const={k: v[None] for k, v in prior_const.items()},
        mask=have_prior[None], info=prior_info_safe[None]))
    return prob


def vi_pose_opt_plain(K: PinholeK, Rcb, tcb, gravity: float, pose_wb0, v0,
                      bg0, ba0, uv, X, valid, is2, prev_pose_wb, prev_v,
                      pre_const, imu_info, bias_rw_info, prior_const,
                      prior_info, have_prior: bool, rounds: int = 3,
                      iters: int = 6, stats=None, ur=None, bf: float = 0.0):
    """Plain version of `vi_pose_lm` on the dense engine: the
    current (pose_wb, v, bg, ba) against the previous state through the
    body-frame reprojection edges, one 9-dim inertial edge, the bias
    random walks and (have_prior) the 15-DoF prior on the previous state,
    `rounds` x <= `iters` LM with early exit and chi2 re-gating, then the
    next prior: the previous state marginalized out of the 30x30 H
    (eigh pseudo-inverse), or the current block when have_prior is False.
    With ur [cap] and bf > 0 (IMU_STEREO), the rows with ur > 0 form the
    3-row stereo term (u, v, u_R; Huber delta sqrt(7.815), re-gated at
    7.815) and the mono term keeps the others.
    Returns (pose_wb [3,4], v, bg, ba, inlier [cap], n_inliers int32,
    H15 [15,15]); `stats` (a list) gets each round's iteration count."""
    dev = pose_wb0.device
    cap = X.shape[0]
    hp = torch.as_tensor(have_prior, dtype=torch.bool, device=dev)
    eye15 = torch.eye(15, dtype=torch.float32, device=dev)
    prior_info_safe = torch.where(hp, prior_info, eye15)
    mask = valid
    states = {"pose": torch.stack([prev_pose_wb, pose_wb0]),
              "vel": torch.stack([prev_v, v0]),
              "bg": torch.stack([bg0, bg0]), "ba": torch.stack([ba0, ba0])}
    t = torch.ones((), dtype=torch.bool, device=dev)
    free = {k: torch.stack([hp, t]) for k in states}
    consts = (uv, X, is2, pre_const, imu_info, bias_rw_info, prior_const,
              prior_info_safe, hp)
    stereo = ur is not None and bf > 0
    has_r = ur > 0 if stereo else torch.zeros(cap, dtype=torch.bool,
                                              device=dev)
    mask = valid & ~has_r
    mask_s = valid & has_r

    def problem():
        return _vi_problem(K, Rcb, tcb, gravity, cap, mask, consts,
                           (bf, ur, mask_s) if stereo else None)
    for _ in range(rounds):
        states, _, chi2s = E.optimize(problem(), states, iters=iters,
                                      dense_free_mask=free, early_tol=1e-2,
                                      stats=stats)
        mask = valid & ~has_r & (chi2s["reproj"] < CHI2_MONO)
        if stereo:
            mask_s = valid & has_r & (chi2s["stereo"] < CHI2_STEREO)
    prob = problem()
    _, H, _, _, _, _ = prob.build_normal_equations(states)
    ip, ic = IDX_PREV.to(dev), IDX_CUR.to(dev)
    Hpp = H[ip][:, ip]
    Hpc = H[ip][:, ic]
    Hcc = H[ic][:, ic]
    # a NaN prior (the carried H15 can lose definiteness in float32, and
    # its Cholesky is then NaN, as in the reference) gives NaN, not an
    # exception: eigh of a NaN matrix raises in torch
    Hs = 0.5 * (Hpp + Hpp.T)
    fin = torch.isfinite(Hs).all()
    w, V = torch.linalg.eigh(torch.where(fin, Hs, eye15))
    thr = 1e-6 * torch.clamp_min(w.abs().max(), 1e-12)
    w_inv = torch.where(w > thr, 1.0 / w, torch.zeros_like(w))
    marg = Hcc - Hpc.T @ ((V * w_inv[None, :]) @ V.T) @ Hpc
    marg = torch.where(fin, marg, torch.full_like(marg, float("nan")))
    H15 = torch.where(hp, marg, Hcc)
    H15 = 0.5 * (H15 + H15.T)
    inlier = mask | mask_s
    return (states["pose"][1], states["vel"][1], states["bg"][1],
            states["ba"][1], inlier, inlier.sum().to(torch.int32), H15)


_VI_POSE_LM_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                    _F, _F, _F, _F, _P, _P, _P, _P, _P]
# `vi_pose_lm(..., prof=)`: ns by stage in this order, then the LM
# iterations run, then ns by part (parts overlap the stages: the dense
# warps' terms, the solve's pieces; csrc/vi_pose_lm.cu kStages, kParts)
VI_STAGES = ("points", "dense", "solve", "final", "marg", "init", "regate")
VI_PARTS = ("inertial_eval", "inertial_whiten", "prior_eval",
            "prior_whiten", "cholesky", "forward", "back", "retract")
# one library entry; the launches with the stereo term are counted apart
VI_POSE_LM = cuda.Kernel("vi_pose_lm", "vi_pose_lm", _VI_POSE_LM_ARGS)
VI_POSE_LM_STEREO = cuda.Kernel("vi_pose_lm", "vi_pose_lm",
                                _VI_POSE_LM_ARGS)


def _pack(d, keys):
    return torch.cat([d[k].reshape(-1) for k in keys]).contiguous()


def vi_pose_lm(K: PinholeK, Rcb, tcb, gravity: float, pose_wb0, v0, bg0,
               ba0, uv, X, valid, is2, prev_pose_wb, prev_v, pre_const,
               imu_info, bias_rw_info, prior_const, prior_info,
               have_prior: bool, rounds: int = 3, iters: int = 6, ur=None,
               bf: float = 0.0, prof=None):
    """VI pose optimization of the tracked frame, see `vi_pose_opt_plain`
    (mono, or with ur [cap] and bf > 0 the stereo term).  CPU tensors take
    the plain version; CUDA tensors launch csrc/vi_pose_lm.cu, which runs
    every round, LM iteration, early exit and the marginalization on the
    device (no host sync).  `prof` (an int64 CUDA tensor of
    len(VI_STAGES) + 1 + len(VI_PARTS)) receives the kernel's nanoseconds
    by stage of `VI_STAGES`, the LM iterations run and the nanoseconds by
    part of `VI_PARTS`."""
    if pose_wb0.device.type == "cpu":
        return vi_pose_opt_plain(K, Rcb, tcb, gravity, pose_wb0, v0, bg0,
                                 ba0, uv, X, valid, is2, prev_pose_wb,
                                 prev_v, pre_const, imu_info, bias_rw_info,
                                 prior_const, prior_info, have_prior,
                                 rounds, iters, ur=ur, bf=bf)
    if not isinstance(have_prior, bool):
        raise ValueError("vi_pose_lm: have_prior must be a Python bool")
    cap = X.shape[0]
    dev = pose_wb0.device
    f32 = torch.float32
    # [0:12) pose_wb0, [12:15) v0, [15:18) bg0, [18:21) ba0, [21:33)
    # prev pose, [33:36) prev v, [36:103) pre_const, [103:184) imu_info,
    # [184:190) rw info, [190:211) prior const, [211:436) prior info,
    # [436:448) Rcb | tcb
    state = torch.cat([
        pose_wb0.reshape(-1), v0, bg0, ba0, prev_pose_wb.reshape(-1), prev_v,
        _pack(pre_const, PRE_KEYS), imu_info.reshape(-1), bias_rw_info,
        _pack(prior_const, PRIOR_KEYS), prior_info.reshape(-1),
        torch.as_tensor(Rcb, dtype=f32, device=dev).reshape(-1),
        torch.as_tensor(tcb, dtype=f32, device=dev).reshape(-1)])
    cuda.check_cuda("vi_pose_lm", state, uv, X, valid, is2)
    if state.dtype != f32 or state.numel() != 448 or uv.shape != (cap, 2) \
            or X.shape != (cap, 3) or valid.shape != (cap,) \
            or is2.shape != (cap,) or valid.dtype != torch.bool \
            or uv.dtype != f32 or X.dtype != f32 or is2.dtype != f32:
        raise ValueError("vi_pose_lm: shape or dtype mismatch")
    if ur is not None:
        cuda.check_cuda("vi_pose_lm", state, ur)
        if ur.dtype != f32 or ur.shape != (cap,) or not bf > 0:
            raise ValueError("vi_pose_lm: ur [cap] float32 with bf > 0")
    if cap > 32768:
        raise ValueError("vi_pose_lm: the edge gates of cap rows must fit "
                         "in shared memory (cap <= 32768)")
    if prof is not None:
        cuda.check_cuda("vi_pose_lm", state, prof)
        if prof.dtype != torch.int64 or prof.shape != (
                len(VI_STAGES) + 1 + len(VI_PARTS),):
            raise ValueError("vi_pose_lm: prof int64 [len(VI_STAGES) + 1 + "
                             "len(VI_PARTS)]")
    out = torch.empty(21 + 225, dtype=f32, device=dev)
    inlier = torch.empty(cap, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    (VI_POSE_LM if ur is None else VI_POSE_LM_STEREO).launch(
        cuda.ptr(state), cuda.ptr(uv), cuda.ptr(X), cuda.ptr(valid),
        cuda.ptr(is2), None if ur is None else cuda.ptr(ur), cap,
        int(have_prior), rounds, iters, K.fx, K.fy, K.cx, K.cy,
        float(gravity), float(math.sqrt(CHI2_MONO)), float(bf),
        float(math.sqrt(CHI2_STEREO)), cuda.ptr(out), cuda.ptr(inlier),
        cuda.ptr(n_inl), None if prof is None else cuda.ptr(prof),
        cuda.stream())
    pose = out[:12].view(3, 4)
    return (pose, out[12:15], out[15:18], out[18:21], inlier, n_inl,
            out[21:].view(15, 15))


def make_vi_pose_optimizer(K: PinholeK, cap: int, Rcb, tcb, gravity: float,
                           rounds: int = 3, iters: int = 6,
                           plain: bool = False, bf: float = 0.0):
    """run(pose_wb0 [3,4], v0, bg0, ba0, uvr [cap,3], X [cap,3], valid,
    is2, prev_pose_wb, prev_v, pre_const dict, imu_info [9,9],
    bias_rw_info [6], prior_const {R0,p0,v0,bg0,ba0}, prior_info [15,15],
    have_prior bool) -> (pose_wb, v, bg, ba, inlier, n_inliers, H15): the
    reference's make_vi_pose_optimizer.  With bf = 0 (mono) uvr's third
    column is ignored; with bf > 0 (IMU_STEREO) the rows with uvr[:, 2] > 0
    take the stereo term.  `plain` runs the plain version on any device."""
    fn = vi_pose_opt_plain if plain else vi_pose_lm
    Rcb = torch.as_tensor(np.asarray(Rcb, np.float32))
    tcb = torch.as_tensor(np.asarray(tcb, np.float32))
    on_dev = {}

    def extrinsics(dev):
        # moved once a device and without blocking: a blocking copy from
        # pageable host memory synchronizes the host with the card
        c = on_dev.get(dev)
        if c is None:
            c = on_dev[dev] = (Rcb.to(dev, non_blocking=True),
                               tcb.to(dev, non_blocking=True))
        return c

    def run(pose_wb0, v0, bg0, ba0, uvr, X, valid, is2, prev_pose_wb,
            prev_v, pre_const, imu_info, bias_rw_info, prior_const,
            prior_info, have_prior):
        return fn(K, *extrinsics(pose_wb0.device), gravity, pose_wb0, v0,
                  bg0, ba0, uvr[:, :2].contiguous(), X, valid, is2,
                  prev_pose_wb, prev_v, pre_const, imu_info, bias_rw_info,
                  prior_const, prior_info, have_prior, rounds, iters,
                  ur=uvr[:, 2].contiguous() if bf > 0 else None, bf=bf)
    return run


# --------------------------------------------------------------------------
# Keyframe mapping: epipolar matcher, triangulator, windowed point+line BA
# --------------------------------------------------------------------------

def _kmat(K: PinholeK, dev):
    return torch.tensor([[K.fx, 0.0, K.cx], [0.0, K.fy, K.cy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)


def fundamental(K: PinholeK, pose1, pose2):
    """F of the pair (T_21 = T2 T1^-1): E = hat(t21) R21, F = K^-T E K^-1
    (models/kernels.py:845-851)."""
    R1, t1 = pose1[:, :3], pose1[:, 3]
    R2, t2 = pose2[:, :3], pose2[:, 3]
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    Kinv = torch.linalg.inv(_kmat(K, pose1.device))
    return (Kinv.T @ (lie.hat(t21) @ R21) @ Kinv).contiguous()


def make_epipolar_matcher(K: PinholeK, plain: bool = False):
    """run(pose1, pose2, uv1 [F,2], d1 [F,8], ok1, uv2 [F,2], d2 [F,8],
    ok2, ang1=None, ang2=None, th_epi=2.0, oct2=None) -> (idx2 [F] int32,
    ok [F]): features of KF1 matched to KF2 under the epipolar gate
    (octave-scaled with oct2), NN with ratio 0.8, max 60, mutual, then the
    rotation histogram when angles are given.  Descriptors are packed
    [F,8] int32.  CUDA tensors run the `hamming_match` kernel in its
    epipolar mode and `rot_hist`; `plain` runs their plain versions."""
    match = M.hamming_match_plain if plain else M.hamming_match
    hist = M.rotation_histogram_filter if plain else M.rot_hist

    def run(pose1, pose2, uv1, d1, ok1, uv2, d2, ok2, ang1=None, ang2=None,
            th_epi: float = 2.0, oct2=None):
        F = fundamental(K, pose1, pose2)
        if oct2 is not None:
            th = th_epi * torch.pow(1.2, oct2.to(torch.float32))
        else:
            th = torch.full((uv2.shape[0],), th_epi, dtype=torch.float32,
                            device=uv2.device)
        idx, ok = match(d1, d2, ok1, ok2, uv1.contiguous(),
                        uv2.contiguous(), radius=0.0, max_dist=60.0,
                        ratio=0.8, epi_F=F, epi_th=th.contiguous())
        if ang1 is not None and ang2 is not None:
            ok = hist(ang1.contiguous(), ang2.contiguous(), idx, ok)
        return idx, ok
    return run


def triangulate_plain(K: PinholeK, pose1, pose2, uv1, uv2, valid, th1, th2,
                      min_parallax_cos: float = 0.99995):
    """Plain version of `triangulate` (models/kernels.py:886-927): DLT by a
    batched SVD, the gates in float32.  Returns (X_world [N,3], good)."""
    R1, t1 = pose1[:, :3], pose1[:, 3]
    R2, t2 = pose2[:, :3], pose2[:, 3]
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    x1n = torch.stack([(uv1[:, 0] - K.cx) / K.fx,
                       (uv1[:, 1] - K.cy) / K.fy], -1)
    x2n = torch.stack([(uv2[:, 0] - K.cx) / K.fx,
                       (uv2[:, 1] - K.cy) / K.fy], -1)
    X1 = TV.triangulate_dlt(R21, t21, x1n, x2n)
    z1 = X1[:, 2]
    X2 = X1 @ R21.T + t21
    z2 = X2[:, 2]
    C2_in1 = -R21.T @ t21
    r1 = X1 / torch.clamp_min(torch.linalg.vector_norm(X1, dim=-1,
                                                       keepdim=True), 1e-9)
    d2v = X1 - C2_in1
    r2 = d2v / torch.clamp_min(torch.linalg.vector_norm(d2v, dim=-1,
                                                        keepdim=True), 1e-9)
    cosp = (r1 * r2).sum(-1)

    def reproj2(X, z, uv):
        zc = torch.clamp_min(z, 1e-9)
        e = torch.stack([K.fx * X[:, 0] / zc + K.cx,
                         K.fy * X[:, 1] / zc + K.cy], -1) - uv
        return (e * e).sum(-1)

    good = valid & (z1 > 0.02) & (z2 > 0.02) & (cosp < min_parallax_cos) \
        & (reproj2(X1, z1, uv1) < th1) & (reproj2(X2, z2, uv2) < th2) \
        & torch.isfinite(X1).all(-1)
    Xw = (X1 - t1) @ R1
    return Xw, good


TRIANGULATE = cuda.Kernel(
    "triangulate", "triangulate",
    [_P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _P, _P, _P])


def triangulate(K: PinholeK, pose1, pose2, uv1, uv2, valid, th1, th2,
                min_parallax_cos: float = 0.99995):
    """DLT triangulation of matched pairs (pose1/pose2 [3,4] T_cw, uv1/uv2
    [N,2], valid [N] bool, th1/th2 [N] reprojection gates in px^2) with
    the depth (> 0.02 in both views), parallax (cos < min_parallax_cos),
    reprojection and finiteness gates.  Returns (X_world [N,3], good
    [N]).  CPU tensors take the plain version; CUDA tensors launch
    csrc/triangulate.cu."""
    if valid.device.type == "cpu":
        return triangulate_plain(K, pose1, pose2, uv1, uv2, valid, th1, th2,
                                 min_parallax_cos)
    n = uv1.shape[0]
    cuda.check_cuda("triangulate", pose1, pose2, uv1, uv2, valid, th1, th2)
    f32 = torch.float32
    if any(t.dtype != f32 for t in (pose1, pose2, uv1, uv2, th1, th2)) \
            or valid.dtype != torch.bool or pose1.shape != (3, 4) \
            or pose2.shape != (3, 4) or uv1.shape != (n, 2) \
            or uv2.shape != (n, 2) or valid.shape != (n,) \
            or th1.shape != (n,) or th2.shape != (n,):
        raise ValueError("triangulate: float32 poses [3,4], uv [N,2], "
                         "thresholds [N] and a bool valid [N]")
    Xw = torch.empty(n, 3, dtype=f32, device=uv1.device)
    good = torch.empty(n, dtype=torch.bool, device=uv1.device)
    TRIANGULATE.launch(
        cuda.ptr(pose1), cuda.ptr(pose2), cuda.ptr(uv1), cuda.ptr(uv2),
        cuda.ptr(valid), cuda.ptr(th1), cuda.ptr(th2), n, K.fx, K.fy, K.cx,
        K.cy, float(min_parallax_cos), cuda.ptr(Xw), cuda.ptr(good),
        cuda.stream())
    return Xw, good


def make_triangulator(K: PinholeK, plain: bool = False):
    """run(pose1, pose2, uv1 [cap,2], uv2 [cap,2], valid,
    min_parallax_cos=0.99995, max_reproj_err=5.991, oct1=None, oct2=None)
    -> (X_world [cap,3], good [cap]); the reprojection gates scale by
    1.2^(2 octave) where octaves are given."""
    fn = triangulate_plain if plain else triangulate

    def run(pose1, pose2, uv1, uv2, valid, min_parallax_cos=0.99995,
            max_reproj_err=5.991, oct1=None, oct2=None):
        def th(octv):
            if octv is None:
                return torch.full((uv1.shape[0],), max_reproj_err,
                                  dtype=torch.float32, device=uv1.device)
            return max_reproj_err * torch.pow(1.2,
                                              2.0 * octv.to(torch.float32))
        return fn(K, pose1.contiguous(), pose2.contiguous(),
                  uv1.contiguous(), uv2.contiguous(), valid, th(oct1),
                  th(oct2), min_parallax_cos)
    return run


def _ba_problem(K, n_kf, n_pt, n_ln, obs_kf, obs_pt, obs_uv, mask, obs_is2,
                lobs_kf=None, lobs_ln=None, lobs_eq=None, mask_l=None,
                lobs_is2=None):
    """The windowed BA's problem: keyframe poses, Schur-eliminated points
    and (lobs_kf given) line endpoints."""
    prob = E.Problem(linear_solver="cg")
    prob.add_dense("pose", n_kf, 6, RES.retract_pose_cw)
    prob.add_landmarks("pt", n_pt, 3, RES.retract_additive)
    delta = float(math.sqrt(CHI2_MONO))
    prob.add_term(E.Term(
        name="reproj", res_fn=RES.point_reproj_ba_for(K), rdim=2,
        dense_refs=[("pose", obs_kf)], lm_ref=("pt", obs_pt),
        const={"uv": obs_uv}, mask=mask, info=obs_is2, robust_delta=delta))
    if lobs_kf is None:
        return prob
    prob.add_landmarks("ln", n_ln, 6, RES.retract_additive)
    prob.add_term(E.Term(
        name="line", res_fn=RES.make_line_reproj(K), rdim=2,
        dense_refs=[("pose", lobs_kf)], lm_ref=("ln", lobs_ln),
        const={"l": lobs_eq}, mask=mask_l, info=lobs_is2,
        robust_delta=delta))
    return prob


def local_ba_pl_plain(K: PinholeK, kf_poses, kf_free, pt_xyz, pt_free,
                      obs_kf, obs_pt, obs_uv, obs_valid, obs_is2, ln_ep,
                      ln_free, lobs_kf, lobs_ln, lobs_eq, lobs_valid,
                      lobs_is2, rounds: int = 2, iters: int = 8,
                      early_tol: float = 1e-2, stats=None):
    """Plain version of the windowed point+line BA on the engine: `rounds`
    x <= `iters` LM iterations (CG reduced solve, early exit at
    early_tol), the chi2 gate re-applied between rounds.  Returns
    (kf_poses, pt_xyz, ln_ep, inlier [n_obs], inlier_l [n_lobs]);
    `stats` (a list) gets each round's iteration count."""
    n_kf, n_pt, n_ln = kf_poses.shape[0], pt_xyz.shape[0], ln_ep.shape[0]
    idx = [t.long() for t in (obs_kf, obs_pt, lobs_kf, lobs_ln)]
    states = {"pose": kf_poses, "pt": pt_xyz, "ln": ln_ep}
    mask, mask_l = obs_valid, lobs_valid
    for _ in range(rounds):
        prob = _ba_problem(K, n_kf, n_pt, n_ln, idx[0], idx[1], obs_uv, mask,
                           obs_is2, idx[2], idx[3], lobs_eq, mask_l,
                           lobs_is2)
        states, _, chi2s = E.optimize(
            prob, states, iters=iters, early_tol=early_tol,
            dense_free_mask={"pose": kf_free},
            lm_free_mask={"pt": pt_free, "ln": ln_free}, stats=stats)
        mask = obs_valid & (chi2s["reproj"] < CHI2_MONO)
        mask_l = lobs_valid & (chi2s["line"] < CHI2_MONO)
    return states["pose"], states["pt"], states["ln"], mask, mask_l


# the pointer table of csrc/ba_common.cuh (enum ba::Ptr), in order
_BA_PTRS = (
    "poses", "pts", "lns", "cposes", "cpts", "clns",
    "obs_kf", "obs_pt", "obs_uv", "obs_is2", "obs_valid", "mask",
    "lobs_kf", "lobs_ln", "lobs_eq", "lobs_is2", "lobs_valid", "mask_l",
    "kf_free", "pt_free", "ln_free",
    "kf_order", "kf_start", "pt_order", "pt_start", "ln_order", "ln_start",
    "obs_c", "p_l", "p_w", "l_l", "l_w", "chi2", "wchi2",
    "hcc", "hpt", "hln", "fpt", "fln", "occ_pt", "occ_ln",
    "gpt", "gln", "rr", "ff", "dx", "ctrl",
    "kfx", "ckfx", "kf_free_bias", "pre", "imu_info", "edge_valid", "rw_g",
    "rw_a", "link", "link_cost", "ccost", "cgw", "lobs_dir", "mcost",
    "kf_col_order", "cost_part", "prof")
BA_LINEARIZE = cuda.Kernel("ba_linearize", "ba_linearize",
                           [_P, _P, _P, _I, _P])
# the same library entry in its other modes, counted apart: the KB8 point
# edge of the point-only window, of the inertial window (body frame, with
# or without lines) and beside the line family of the point+line window,
# and the line-only window of SLAM modes 1-3
BA_LINEARIZE_KB8 = cuda.Kernel("ba_linearize", "ba_linearize",
                               [_P, _P, _P, _I, _P])
BA_LINEARIZE_KB8_BODY = cuda.Kernel("ba_linearize", "ba_linearize",
                                    [_P, _P, _P, _I, _P])
BA_LINEARIZE_KB8_LINES = cuda.Kernel("ba_linearize", "ba_linearize",
                                     [_P, _P, _P, _I, _P])
BA_LINEARIZE_LINE_ONLY = cuda.Kernel("ba_linearize", "ba_linearize",
                                     [_P, _P, _P, _I, _P])
# the angle edge's information factor (models/kernels.py:1362, 1410): the
# chi2 gate at 5.991 then holds the angle to ~7 deg
ANG_INFO = 400.0
SCHUR_SOLVE = cuda.Kernel("schur_solve", "schur_solve", [_P, _P, _P, _P])


# schur_solve's launches whose reduced solve took the global path (the
# kernel reports its path, `_BAWork.solve` counts it; csrc/schur_solve.cu
# `solve_global_kernel`)
SCHUR_SOLVE.global_launches = 0
BA_MODE_LINEARIZE, BA_MODE_DECIDE, BA_MODE_INIT, BA_MODE_REGATE = range(4)
_PROF = _BA_PTRS.index("prof")
# ba_linearize's %globaltimer stamps (ns), csrc/ba_linearize.cu `Prof`:
# the earliest block's start, the last block's end of its observations,
# the earliest block past the linearization's grid barrier, the last end
# of a keyframe's sums and of the landmarks' (linearization); the last
# block's ticket, its cost sums and decision, its copy (the other modes)
BA_PROF_STAMPS = ("start", "observations", "barrier", "keyframes",
                  "landmarks", "ticket", "decision", "copy")


def ba_prof_reset(stamps: torch.Tensor) -> None:
    """Stamps before a launch: the minima (start, barrier) at the largest
    int64, the maxima at 0."""
    stamps.zero_()
    stamps[0] = stamps[2] = (1 << 63) - 1
# ba_linearize's mesh modes (the landmark-sharded window BA): a shard's
# partial cost of the candidate / of the state into ctrl[2]; the start of a
# round / the accept-reject from the mesh's summed cost in `mcost`
(BA_MODE_PARTIAL_CAND, BA_MODE_PARTIAL_STATE, BA_MODE_MESH_INIT,
 BA_MODE_MESH_DECIDE) = range(4, 8)


def _pad_row(n: int) -> int:
    """csrc/schur_solve.cu `pad_row`: the smallest length >= n that is 1
    (mod 32)."""
    return (n + 30) // 32 * 32 + 1


def row_layout(n_kf: int, body: bool):
    """csrc/schur_solve.cu `RowLayout` of the reduced system of n_kf
    keyframes (S = 6 n_kf, or 15 n_kf with `body`) in full rows: (sp, sn,
    floats), the stride of a pose row (the longest's padded length), of a
    velocity or bias row, and the system's floats."""
    S6, m = 6 * n_kf, min(n_kf, 3)
    S = (15 if body else 6) * n_kf
    sp = _pad_row(S6 + (9 * m if body else 0))
    sn = _pad_row(15 * m)
    return sp, sn, S6 * sp + ((S - S6) * sn if body else 0)


def row_segs(i: int, n_kf: int, body: bool):
    """csrc/schur_solve.cu `row_segs`: row i's stored columns as [(first,
    length)] in increasing order: every column of a point+line window; in
    the 15-DoF window (pose rows, then velocity, gyro and accelerometer
    bias rows by keyframe) a pose row's every pose column, a velocity or
    bias row's pose columns of keyframes k-1..k+1, then in each family
    (velocity, gyro bias, accelerometer bias) the columns of keyframes
    k-1..k+1."""
    S6 = 6 * n_kf
    if not body:
        return [(0, S6)]
    k = i // 6 if i < S6 else ((i - S6) % (3 * n_kf)) // 3
    lo, hi = max(k - 1, 0), min(k + 1, n_kf - 1)
    m = hi - lo + 1
    first = [(0, S6)] if i < S6 else [(6 * lo, 6 * m)]
    return first + [(S6 + 3 * n_kf * f + 3 * lo, 3 * m) for f in range(3)]


def stored_pattern(n_kf: int, body: bool) -> torch.Tensor:
    """[S, S] bool: the entries the reduced solve stores and walks, from
    `row_segs` (the kernel's rule; `cg_pattern` states the system's
    structural non-zeros, which it must equal)."""
    S = (15 if body else 6) * n_kf
    out = torch.zeros(S, S, dtype=torch.bool)
    for i in range(S):
        for c0, n in row_segs(i, n_kf, body):
            out[i, c0:c0 + n] = True
    return out


CLUSTER_CTAS = 16      # csrc/schur_solve.cu kCluster


def cluster_rows(n_kf: int, body: bool):
    """The global path's split of the reduced system over its thread-block
    cluster of CLUSTER_CTAS (csrc/schur_solve.cu `launch_solve_global`):
    CTA c owns the 32-row warps [c w, (c + 1) w), w = ceil(ceil(S / 32) /
    CLUSTER_CTAS).  Returns (w, [floats of each CTA's rows in
    `row_layout`]); a CTA holds its rows in shared memory where they, p
    [S], two [ceil(S / 32)] rows of warp sums and 64 bytes of mbarriers
    fit 232448 bytes."""
    S = (15 if body else 6) * n_kf
    sp, sn, _ = row_layout(n_kf, body)
    S6 = 6 * n_kf

    def off(i):
        return i * sp if i < S6 else S6 * sp + (i - S6) * sn
    nw = -(-S // 32)
    w = -(-nw // CLUSTER_CTAS)
    return w, [off(min(S, 32 * w * (c + 1))) - off(min(S, 32 * w * c))
               for c in range(CLUSTER_CTAS)]


def solve_fits(n_kf: int, body: bool) -> bool:
    """Whether schur_solve takes its one-block solve for the reduced
    system of n_kf keyframes (S = 6 n_kf, or 15 n_kf with `body`): S <=
    330 and its full rows and CG vectors fit shared memory
    (csrc/schur_solve.cu `one_block`, `RowLayout`: at most 232448 bytes),
    so up to 37 keyframes without a body and 22 with one; beyond it the
    kernel takes its global path."""
    S = (15 if body else 6) * n_kf
    return S <= 330 and (row_layout(n_kf, body)[2] + 2 * S + 2 * 8) * 4 \
        <= 232448


def cg_pattern(n_kf: int, body: bool) -> torch.Tensor:
    """The structural non-zeros [S, S] bool of the reduced system: every
    entry of a point+line window (S = 6 n_kf); in the 15-DoF window (S =
    15 n_kf, pose rows, then velocity, gyro and accelerometer bias rows by
    keyframe) the dense pose block and, for every other pair of rows,
    those of keyframes at most one apart (the chain couples neighbouring
    keyframes only, the fill-in and the visual blocks the pose rows
    only)."""
    S6 = 6 * n_kf
    if not body:
        return torch.ones(S6, S6, dtype=torch.bool)
    kf = torch.cat([torch.arange(S6) // 6,
                    (torch.arange(9 * n_kf) % (3 * n_kf)) // 3])
    pose = torch.arange(15 * n_kf) < S6
    near = (kf[:, None] - kf[None, :]).abs() <= 1
    return near | (pose[:, None] & pose[None, :])


def cg_workspace_floats(n_kf: int, body: bool) -> int:
    """Floats of the global path's workspace (csrc/ba_common.cuh `cgw`):
    the reduced system in full rows (`row_layout`); 1 when the one-block
    solve fits."""
    if solve_fits(n_kf, body):
        return 1
    return row_layout(n_kf, body)[2]


def _segments(keys: torch.Tensor, n: int, valid: torch.Tensor):
    """(order int32, start int32 [n+1]): one stable sort of `keys`, the
    rows whose `valid` is False left out of every segment (placed after
    start[n]).  Those rows are the windows' padding (keyframe 0, landmark
    0, weight 0): they add +-0 to every segment sum, so leaving them out
    changes no result, and the kernels' per-segment loops no longer walk
    them serially on keyframe 0 and landmark 0.  Rows the chi2 gate masks
    stay in: they are real observations and may come back."""
    keys = torch.where(valid, keys.long(), n)
    order = torch.sort(keys, stable=True).indices.to(torch.int32)
    start = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    start[1:] = torch.cumsum(torch.bincount(keys, minlength=n + 1)[:n], 0)
    return order.contiguous(), start.to(torch.int32)


class _BAWork:
    """Device buffers and the pointer table of one kernel-path BA call:
    the point+line window BA (keyframe poses T_cw), or with `inertial`
    (a dict of kfx [n_kf,9] = (vel, bg, ba), kf_free_bias, pre, imu_info
    [n_kf-1,81], edge_valid, rw_g, rw_a, Rcb, tcb, gravity) the inertial
    window BA (body poses pose_wb, 15-DoF keyframe states), or with
    `line_mode` 1-3 the line-only window of SLAM modes 1-3 (no points;
    lobs_dir [n_lobs,2] the observed unit directions of the angle edge).
    A KB8K camera's point edges project through the lens; its line edges
    through the pinhole fx, fy, cx, cy."""

    def __init__(self, K, kf_poses, kf_free, pt_xyz, pt_free, obs_kf, obs_pt,
                 obs_uv, obs_valid, obs_is2, ln_ep, ln_free, lobs_kf,
                 lobs_ln, lobs_eq, lobs_valid, lobs_is2, lam0, early_tol,
                 cg_iters, inertial=None, line_mode: int = 0,
                 lobs_dir=None):
        dev = kf_poses.device
        f32 = torch.float32
        n_kf, n_pt, n_ln = kf_poses.shape[0], pt_xyz.shape[0], ln_ep.shape[0]
        n_obs, n_lobs = obs_kf.shape[0], lobs_kf.shape[0]
        N = n_obs + n_lobs
        S = 6 * n_kf
        n_e = n_kf - 1

        def buf(*shape, dtype=f32):
            return torch.zeros(*[max(s, 1) for s in shape], dtype=dtype,
                               device=dev)
        t = {}
        t["poses"] = kf_poses.reshape(n_kf, 12).clone()
        t["pts"] = pt_xyz.clone()
        t["lns"] = ln_ep.clone()
        t["cposes"], t["cpts"], t["clns"] = (torch.empty_like(t["poses"]),
                                             torch.empty_like(t["pts"]),
                                             torch.empty_like(t["lns"]))
        t.update(obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=obs_uv,
                 obs_is2=obs_is2, obs_valid=obs_valid,
                 mask=obs_valid.clone(), lobs_kf=lobs_kf, lobs_ln=lobs_ln,
                 lobs_eq=lobs_eq, lobs_is2=lobs_is2, lobs_valid=lobs_valid,
                 mask_l=lobs_valid.clone(), kf_free=kf_free, pt_free=pt_free,
                 ln_free=ln_free)
        t["kf_order"], t["kf_start"] = _segments(
            torch.cat([obs_kf, lobs_kf]), n_kf,
            torch.cat([obs_valid, lobs_valid]))
        t["pt_order"], t["pt_start"] = _segments(obs_pt, n_pt, obs_valid)
        t["ln_order"], t["ln_start"] = _segments(lobs_ln, n_ln, lobs_valid)
        # each keyframe's observations by their landmark's column of the
        # coupling (points, then lines; kf_start's segments), the order
        # the fill-in sums in
        C = 3 * n_pt + 6 * n_ln
        key = torch.cat([obs_kf, lobs_kf]).long() * C + torch.cat(
            [obs_pt.long() * 3, 3 * n_pt + lobs_ln.long() * 6])
        key = torch.where(torch.cat([obs_valid, lobs_valid]), key,
                          n_kf * C)
        t["kf_col_order"] = torch.sort(key, stable=True).indices.to(
            torch.int32).contiguous()
        t.update(obs_c=buf(N, 27), p_l=buf(n_obs, 9), p_w=buf(n_obs, 18),
                 l_l=buf(n_lobs, 27), l_w=buf(n_lobs, 36), chi2=buf(N),
                 wchi2=buf(N), hcc=buf(n_kf, 27), hpt=buf(n_pt, 9),
                 hln=buf(n_ln, 27), fpt=buf(n_pt, 9), fln=buf(n_ln, 36),
                 occ_pt=buf(n_pt, dtype=torch.uint8),
                 occ_ln=buf(n_ln, dtype=torch.uint8), gpt=buf(n_obs, 18),
                 gln=buf(n_lobs, 36), rr=buf(N + n_kf, 6),
                 dx=buf(S if inertial is None else 15 * n_kf), ctrl=buf(8))
        t["ff"] = buf(S, S)
        t["cgw"] = buf(cg_workspace_floats(n_kf, inertial is not None))
        t["lobs_dir"] = buf(1) if lobs_dir is None else lobs_dir
        t["mcost"] = buf(1)
        t["cost_part"] = buf(2 * 1024)
        # ba_linearize's stage stamps: none (a null pointer) unless
        # `ba_prof` gives a buffer
        t["prof"] = torch.zeros(0, dtype=torch.int64, device=dev)
        if inertial is None:
            for name in _LIBA_PTRS:
                t[name] = buf(1)
            rcb, tcb, grav = [0.0] * 9, [0.0] * 3, 0.0
        else:
            t.update({k: inertial[k] for k in (
                "kfx", "kf_free_bias", "pre", "imu_info", "edge_valid",
                "rw_g", "rw_a")})
            t["kfx"] = t["kfx"].clone()
            t["ckfx"] = torch.empty_like(t["kfx"])
            t.update(link=buf(n_e, LINK_FLOATS), link_cost=buf(n_e, 3),
                     ccost=buf(1))
            rcb = inertial["Rcb"].reshape(-1).tolist()
            tcb = inertial["tcb"].reshape(-1).tolist()
            grav = float(inertial["gravity"])
        for name in _BA_PTRS:
            if t[name].numel() and not t[name].is_contiguous():
                raise ValueError(f"local BA: {name} is not contiguous")
        self.device = dev
        self.S = S if inertial is None else 15 * n_kf
        kb8 = isinstance(K, RES.KB8K)
        if line_mode and (n_obs or inertial is not None or kb8
                          or lobs_dir is None):
            raise ValueError("the line-only BA takes no points, no inertial "
                             "states, a pinhole camera and lobs_dir")
        ks = (K.k1, K.k2, K.k3, K.k4) if kb8 else (0.0,) * 4
        self.t = t
        self.n_obs = n_obs
        self.body = inertial is not None
        self.kb8 = kb8
        if line_mode:
            self.counter = BA_LINEARIZE_LINE_ONLY
        elif kb8:
            self.counter = BA_LINEARIZE_KB8_BODY if self.body \
                else BA_LINEARIZE_KB8_LINES if n_lobs else BA_LINEARIZE_KB8
        else:
            self.counter = BA_LINEARIZE
        self._keep = (
            (ctypes.c_void_p * len(_BA_PTRS))(
                *[t[name].data_ptr() for name in _BA_PTRS]),
            (ctypes.c_int * 11)(n_kf, n_pt, n_obs, n_ln, n_lobs, cg_iters,
                                int(self.body), t["cgw"].numel(), 0,
                                int(kb8), int(line_mode)),
            (ctypes.c_float * 26)(K.fx, K.fy, K.cx, K.cy,
                                  float(math.sqrt(CHI2_MONO)), CHI2_MONO,
                                  lam0, early_tol, grav, *rcb, *tcb, *ks,
                                  ANG_INFO))
        self._keep[0][_PROF] = None
        self.args = [ctypes.cast(a, ctypes.c_void_p) for a in self._keep]

    def linearize(self, mode: int):
        self.counter.launch(*self.args, mode, cuda.stream())

    def prof(self, stamps=None):
        """Point ba_linearize's stage stamps at `stamps` (int64 CUDA [8],
        `BA_PROF_STAMPS`; set it to `ba_prof_reset()`'s values before a
        launch), or turn them off (None)."""
        self._keep[0][_PROF] = None if stamps is None else stamps.data_ptr()

    def chain(self, mode: int):
        INERTIAL_CHAIN.launch(*self.args, mode, cuda.stream())

    def solve(self):
        """One damped Schur step (csrc/schur_solve.cu), its reduced solve
        in one block or, beyond one block's shared memory, on the global
        path (counted in SCHUR_SOLVE.global_launches)."""
        SCHUR_SOLVE.launch(*self.args, cuda.stream())
        SCHUR_SOLVE.global_launches += self.solve_path()

    def solve_path(self) -> int:
        """The path of the last schur_solve launch: 0 one block, 1 the
        global path (as the kernel library reported it)."""
        return self._keep[1][8]

    def step(self):
        """One LM iteration, decided on the device."""
        self.linearize(BA_MODE_LINEARIZE)
        if self.body:
            self.chain(CHAIN_LINEARIZE)
        self.solve()
        if self.body:
            self.chain(CHAIN_COST_CAND)
        self.linearize(BA_MODE_DECIDE)


def local_ba_pl(K: PinholeK, kf_poses, kf_free, pt_xyz, pt_free, obs_kf,
                obs_pt, obs_uv, obs_valid, obs_is2, ln_ep, ln_free, lobs_kf,
                lobs_ln, lobs_eq, lobs_valid, lobs_is2, rounds: int = 2,
                iters: int = 8, early_tol: float = 1e-2, stats=None):
    """The windowed point+line BA (see `local_ba_pl_plain`).  CPU tensors
    take the plain version; CUDA tensors run every LM iteration on
    csrc/ba_linearize.cu and csrc/schur_solve.cu (the Schur fill-in
    included), with accept/reject, the damping, the early exit and the chi2 re-gating on the device: no host
    sync inside the call.  `stats` (a list) gets, per round, a device
    tensor holding the iterations run."""
    args = (kf_poses, kf_free, pt_xyz, pt_free, obs_kf, obs_pt, obs_uv,
            obs_valid, obs_is2, ln_ep, ln_free, lobs_kf, lobs_ln, lobs_eq,
            lobs_valid, lobs_is2)
    if kf_poses.device.type == "cpu":
        return local_ba_pl_plain(K, *args, rounds=rounds, iters=iters,
                                 early_tol=early_tol, stats=stats)
    cuda.check_cuda("local_ba_pl", *args)
    n_kf, n_pt, n_ln = kf_poses.shape[0], pt_xyz.shape[0], ln_ep.shape[0]
    n_obs, n_lobs = obs_kf.shape[0], lobs_kf.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    want = [(kf_poses, f32, (n_kf, 3, 4)), (kf_free, b8, (n_kf,)),
            (pt_xyz, f32, (n_pt, 3)), (pt_free, b8, (n_pt,)),
            (obs_kf, i32, (n_obs,)), (obs_pt, i32, (n_obs,)),
            (obs_uv, f32, (n_obs, 2)), (obs_valid, b8, (n_obs,)),
            (obs_is2, f32, (n_obs,)), (ln_ep, f32, (n_ln, 6)),
            (ln_free, b8, (n_ln,)), (lobs_kf, i32, (n_lobs,)),
            (lobs_ln, i32, (n_lobs,)), (lobs_eq, f32, (n_lobs, 3)),
            (lobs_valid, b8, (n_lobs,)), (lobs_is2, f32, (n_lobs,))]
    for i, (x, dt, shape) in enumerate(want):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"local_ba_pl: argument {i} must be {dt} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    S = 6 * n_kf
    w = _BAWork(K, *args, lam0=1e-4, early_tol=early_tol,
                cg_iters=min(max(S // 2, 16), 128))
    for _ in range(rounds):
        w.linearize(BA_MODE_INIT)
        for _ in range(iters):
            w.step()
        w.linearize(BA_MODE_REGATE)
        if stats is not None:
            stats.append(w.t["ctrl"][4].clone())
    t = w.t
    return (t["poses"].view(n_kf, 3, 4), t["pts"], t["lns"], t["mask"],
            t["mask_l"])


def make_local_ba_pl(K: PinholeK, rounds: int = 2, iters: int = 8,
                     early_tol: float = 1e-2, plain: bool = False):
    """run(kf_poses [n_kf,3,4] T_cw, kf_free, pt_xyz [n_pt,3], pt_free,
    obs_kf, obs_pt [n_obs] int32, obs_uv, obs_valid, obs_is2, ln_ep
    [n_ln,6], ln_free, lobs_kf, lobs_ln [n_lobs] int32, lobs_eq [n_lobs,3],
    lobs_valid, lobs_is2, stats=None) -> (kf_poses, pt_xyz, ln_ep, inlier,
    inlier_l): local BA over keyframe poses, points and line endpoints
    (reference LocalBundleAdjustmentwithLine), 2 rounds x <= 8 LM
    iterations, CG reduced solve, early exit at 1e-2.  `plain` runs the
    plain version on any device."""
    fn = local_ba_pl_plain if plain else local_ba_pl

    def run(*args, stats=None):
        return fn(K, *args, rounds=rounds, iters=iters, early_tol=early_tol,
                  stats=stats)
    return run


def local_ba_plain(K: PinholeK, kf_poses, kf_free, pt_xyz, pt_free, obs_kf,
                   obs_pt, obs_uv, obs_valid, obs_is2, rounds: int = 2,
                   iters: int = 8, early_tol: float = 1e-2, stats=None):
    """Plain version of the point-only windowed BA (models/kernels.py:1307)
    on the engine, as `local_ba_pl_plain` without the line family.
    Returns (kf_poses, pt_xyz, inlier [n_obs])."""
    n_kf, n_pt = kf_poses.shape[0], pt_xyz.shape[0]
    okf, opt = obs_kf.long(), obs_pt.long()
    states = {"pose": kf_poses, "pt": pt_xyz}
    mask = obs_valid
    for _ in range(rounds):
        prob = _ba_problem(K, n_kf, n_pt, 0, okf, opt, obs_uv, mask, obs_is2)
        states, _, chi2s = E.optimize(
            prob, states, iters=iters, early_tol=early_tol,
            dense_free_mask={"pose": kf_free}, lm_free_mask={"pt": pt_free},
            stats=stats)
        mask = obs_valid & (chi2s["reproj"] < CHI2_MONO)
    return states["pose"], states["pt"], mask


def local_ba(K: PinholeK, kf_poses, kf_free, pt_xyz, pt_free, obs_kf, obs_pt,
             obs_uv, obs_valid, obs_is2, rounds: int = 2, iters: int = 8,
             early_tol: float = 1e-2, stats=None):
    """The point-only windowed BA (see `local_ba_plain`).  CPU tensors take
    the plain version; CUDA tensors run `local_ba_pl`'s kernel path with
    an empty line family (csrc/ba_linearize.cu and csrc/schur_solve.cu
    skip their line loops at n_ln = n_lobs = 0)."""
    if kf_poses.device.type == "cpu":
        return local_ba_plain(K, kf_poses, kf_free, pt_xyz, pt_free, obs_kf,
                              obs_pt, obs_uv, obs_valid, obs_is2, rounds,
                              iters, early_tol, stats)
    out = local_ba_pl(K, kf_poses, kf_free, pt_xyz, pt_free, obs_kf, obs_pt,
                      obs_uv, obs_valid, obs_is2, *no_lines(kf_poses.device),
                      rounds=rounds, iters=iters, early_tol=early_tol,
                      stats=stats)
    return out[0], out[1], out[3]


def no_lines(dev):
    """An empty line family for the point+line BA's arguments: (ln_ep
    [0,6], ln_free, lobs_kf, lobs_ln, lobs_eq [0,3], lobs_valid,
    lobs_is2)."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    return (torch.zeros(0, 6, dtype=f32, device=dev),
            torch.zeros(0, dtype=b8, device=dev),
            torch.zeros(0, dtype=i32, device=dev),
            torch.zeros(0, dtype=i32, device=dev),
            torch.zeros(0, 3, dtype=f32, device=dev),
            torch.zeros(0, dtype=b8, device=dev),
            torch.zeros(0, dtype=f32, device=dev))


def make_local_ba(K: PinholeK, rounds: int = 2, iters: int = 8,
                  early_tol: float = 1e-2, plain: bool = False):
    """run(kf_poses [n_kf,3,4] T_cw, kf_free, pt_xyz [n_pt,3], pt_free,
    obs_kf, obs_pt [n_obs] int32, obs_uv, obs_valid, obs_is2, stats=None)
    -> (kf_poses, pt_xyz, inlier): the point-only windowed BA (reference
    LocalBundleAdjustment), 2 rounds x <= 8 LM iterations, CG reduced
    solve with min(max(6 n_kf // 2, 16), 128) steps, early exit at 1e-2,
    the chi2 gate re-applied between rounds.  `plain` runs the plain
    version on any device."""
    fn = local_ba_plain if plain else local_ba

    def run(*args, stats=None):
        return fn(K, *args, rounds=rounds, iters=iters, early_tol=early_tol,
                  stats=stats)
    return run


# --------------------------------------------------------------------------
# The line-only window BA of SLAM modes 1-3
# --------------------------------------------------------------------------

def _lines_only_problem(K, n_kf, n_ln, lobs_kf, lobs_ln, lobs_eq, lobs_dir,
                        mask, lobs_is2, mode: int):
    """The line-only window BA's problem (models/kernels.py:1412-1430):
    keyframe poses and Schur-eliminated line endpoints, the line edge
    (modes 1, 3) and the angle edge (modes 2, 3) on the rows of one
    mask."""
    prob = E.Problem(linear_solver="cg")
    prob.add_dense("pose", n_kf, 6, RES.retract_pose_cw)
    prob.add_landmarks("ln", n_ln, 6, RES.retract_additive)
    delta = float(math.sqrt(CHI2_MONO))
    if mode in (1, 3):
        prob.add_term(E.Term(
            name="line", res_fn=RES.make_line_reproj(K), rdim=2,
            dense_refs=[("pose", lobs_kf)], lm_ref=("ln", lobs_ln),
            const={"l": lobs_eq}, mask=mask, info=lobs_is2,
            robust_delta=delta))
    if mode in (2, 3):
        prob.add_term(E.Term(
            name="ang", res_fn=RES.make_line_angle(K), rdim=1,
            dense_refs=[("pose", lobs_kf)], lm_ref=("ln", lobs_ln),
            const={"dir": lobs_dir}, mask=mask, info=lobs_is2 * ANG_INFO,
            robust_delta=delta))
    return prob


def local_ba_lines_only_plain(K: PinholeK, mode: int, kf_poses, kf_free,
                              ln_ep, ln_free, lobs_kf, lobs_ln, lobs_eq,
                              lobs_dir, lobs_valid, lobs_is2,
                              rounds: int = 2, iters: int = 8, stats=None):
    """Plain version of the line-only window BA of SLAM modes 1-3 on the
    engine: `rounds` x `iters` LM iterations (CG reduced solve, no early
    exit, as the reference's optimize default), the mask re-gated at 5.991
    on the line edge's chi2 (modes 1, 3) or the angle edge's (mode 2)
    between rounds.  Returns (kf_poses, ln_ep, inlier_l [n_lobs])."""
    if mode not in (1, 2, 3):
        raise ValueError("line-only BA: mode 1, 2 or 3")
    n_kf, n_ln = kf_poses.shape[0], ln_ep.shape[0]
    lkf, lln = lobs_kf.long(), lobs_ln.long()
    states = {"pose": kf_poses, "ln": ln_ep}
    mask = lobs_valid
    key = "line" if mode in (1, 3) else "ang"
    for _ in range(rounds):
        prob = _lines_only_problem(K, n_kf, n_ln, lkf, lln, lobs_eq,
                                   lobs_dir, mask, lobs_is2, mode)
        states, _, chi2s = E.optimize(
            prob, states, iters=iters, dense_free_mask={"pose": kf_free},
            lm_free_mask={"ln": ln_free}, stats=stats)
        mask = lobs_valid & (chi2s[key] < CHI2_MONO)
    return states["pose"], states["ln"], mask


def local_ba_lines_only(K: PinholeK, mode: int, kf_poses, kf_free, ln_ep,
                        ln_free, lobs_kf, lobs_ln, lobs_eq, lobs_dir,
                        lobs_valid, lobs_is2, rounds: int = 2,
                        iters: int = 8, stats=None):
    """The line-only window BA (see `local_ba_lines_only_plain`).  CPU
    tensors take the plain version; CUDA tensors run `local_ba_pl`'s
    kernel path with no point family and csrc/ba_linearize.cu in its
    line-only mode (the angle edge in modes 2 and 3): every LM iteration,
    accept/reject and the re-gate on the device."""
    args = (kf_poses, kf_free, ln_ep, ln_free, lobs_kf, lobs_ln, lobs_eq,
            lobs_dir, lobs_valid, lobs_is2)
    if kf_poses.device.type == "cpu":
        return local_ba_lines_only_plain(K, mode, *args, rounds=rounds,
                                         iters=iters, stats=stats)
    if mode not in (1, 2, 3):
        raise ValueError("line-only BA: mode 1, 2 or 3")
    cuda.check_cuda("local_ba_lines_only", *args)
    n_kf, n_ln, n_lobs = kf_poses.shape[0], ln_ep.shape[0], lobs_kf.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    want = [(kf_poses, f32, (n_kf, 3, 4)), (kf_free, b8, (n_kf,)),
            (ln_ep, f32, (n_ln, 6)), (ln_free, b8, (n_ln,)),
            (lobs_kf, i32, (n_lobs,)), (lobs_ln, i32, (n_lobs,)),
            (lobs_eq, f32, (n_lobs, 3)), (lobs_dir, f32, (n_lobs, 2)),
            (lobs_valid, b8, (n_lobs,)), (lobs_is2, f32, (n_lobs,))]
    for i, (x, dt, shape) in enumerate(want):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"local_ba_lines_only: argument {i} must be "
                             f"{dt} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    w = lines_only_work(K, mode, *args)
    for _ in range(rounds):
        w.linearize(BA_MODE_INIT)
        for _ in range(iters):
            w.step()
        w.linearize(BA_MODE_REGATE)
        if stats is not None:
            stats.append(w.t["ctrl"][4].clone())
    t = w.t
    return t["poses"].view(n_kf, 3, 4), t["lns"], t["mask_l"]


def lines_only_work(K: PinholeK, mode: int, kf_poses, kf_free, ln_ep,
                    ln_free, lobs_kf, lobs_ln, lobs_eq, lobs_dir, lobs_valid,
                    lobs_is2) -> "_BAWork":
    """The kernel path's buffers of one line-only window BA call: an
    empty point family, ba_linearize in the line-only mode `mode`, no
    early exit."""
    dev, f32 = kf_poses.device, torch.float32
    i32, b8 = torch.int32, torch.bool
    no_pts = (torch.zeros(0, 3, dtype=f32, device=dev),
              torch.zeros(0, dtype=b8, device=dev),
              torch.zeros(0, dtype=i32, device=dev),
              torch.zeros(0, dtype=i32, device=dev),
              torch.zeros(0, 2, dtype=f32, device=dev),
              torch.zeros(0, dtype=b8, device=dev),
              torch.zeros(0, dtype=f32, device=dev))
    S = 6 * kf_poses.shape[0]
    return _BAWork(K, kf_poses, kf_free, *no_pts, ln_ep, ln_free, lobs_kf,
                   lobs_ln, lobs_eq, lobs_valid, lobs_is2, lam0=1e-4,
                   early_tol=0.0, cg_iters=min(max(S // 2, 16), 128),
                   line_mode=mode, lobs_dir=lobs_dir)


def make_local_ba_lines_only(K: PinholeK, mode: int, rounds: int = 2,
                             iters: int = 8, plain: bool = False):
    """run(kf_poses [n_kf,3,4] T_cw, kf_free, ln_ep [n_ln,6], ln_free,
    lobs_kf, lobs_ln [n_lobs] int32, lobs_eq [n_lobs,3], lobs_dir
    [n_lobs,2], lobs_valid, lobs_is2, stats=None) -> (kf_poses, ln_ep,
    inlier_l): the line-only window BA of SLAM mode 1, 2 or 3 (reference
    LocalBundleAdjustmentOnlyLines / ...Angle / ...WithAngle;
    models/kernels.py:1394), 2 rounds x 8 LM iterations, CG reduced
    solve.  `plain` runs the plain version on any device."""
    fn = local_ba_lines_only_plain if plain else local_ba_lines_only

    def run(*args, stats=None):
        return fn(K, mode, *args, rounds=rounds, iters=iters, stats=stats)
    return run


# --------------------------------------------------------------------------
# The keyframe step's neighbourhood work: the line pair matcher, the line
# triangulator and the fuse / tracker projection matcher
# --------------------------------------------------------------------------

def make_line_pair_matcher(plain: bool = False):
    """run(ep1 [F,4], d1 [F,8] int32, ang1 [F], ok1, ep2 [F,4], d2, ang2,
    ok2, radius=80.0, angle_tol=0.25) -> (idx2 [F] int32, ok [F]): line
    observations of two keyframes matched by LBD NN (ratio 0.95, max 110,
    mutual) under the midpoint, angle, length-ratio and 40 px gates
    (`ops.matching.line_pair_gate`).  CUDA tensors run the
    `hamming_match` kernel in its line pair mode; `plain` runs its plain
    version."""
    match = M.hamming_match_plain if plain else M.hamming_match

    def run(ep1, d1, ang1, ok1, ep2, d2, ang2, ok2, radius: float = 80.0,
            angle_tol: float = 0.25):
        return match(d1, d2, ok1, ok2, ep1.contiguous(), ep2.contiguous(),
                     radius=radius, max_dist=110.0, ratio=0.95,
                     a_ang=ang1.contiguous(), b_ang=ang2.contiguous(),
                     angle_tol=angle_tol, pair=True)
    return run


def _v3(a):
    """[N,3] -> its three columns."""
    return [a[:, 0], a[:, 1], a[:, 2]]


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _norm3(a):
    return torch.sqrt((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2])


def _centre(R, t):
    """-R^T t, each entry summed in row order."""
    return [-((R[0, c] * t[0] + R[1, c] * t[1]) + R[2, c] * t[2])
            for c in range(3)]


def line_triangulate_plain(K: PinholeK, pose1, pose2, ep1, ep2, valid,
                           max_depth: float = 40.0):
    """Plain version of `line_triangulate` (models/kernels.py:400-483),
    column by column in the reference's operation order (each 3-vector
    product summed as (x0 y0 + x1 y1) + x2 y2).  Returns (Xs_w [N,3], Xe_w
    [N,3], good [N])."""
    R1, t1 = pose1[:, :3], pose1[:, 3]
    R2, t2 = pose2[:, :3], pose2[:, 3]
    C1, C2 = _centre(R1, t1), _centre(R2, t2)
    one = torch.ones_like(ep1[:, 0])

    def times_R(x, R):              # row vector x times R
        return [(x[0] * R[0, c] + x[1] * R[1, c]) + x[2] * R[2, c]
                for c in range(3)]

    def ray(R, ep, k):
        return times_R([(ep[:, k] - K.cx) / K.fx,
                        (ep[:, k + 1] - K.cy) / K.fy, one], R)

    def plane_n(R, ep):
        rs = [(ep[:, 0] - K.cx) / K.fx, (ep[:, 1] - K.cy) / K.fy, one]
        re = [(ep[:, 2] - K.cx) / K.fx, (ep[:, 3] - K.cy) / K.fy, one]
        return times_R([rs[1] * re[2] - rs[2] * re[1],
                        rs[2] * re[0] - rs[0] * re[2],
                        rs[0] * re[1] - rs[1] * re[0]], R)

    def intersect(Cf, d, n, Con):
        denom = _dot3(n, d)
        tt = _dot3(n, [Con[i] - Cf[i] for i in range(3)]) / torch.where(
            torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
        return [Cf[i] + tt * d[i] for i in range(3)]

    n2 = plane_n(R2, ep2)
    XsA = intersect(C1, ray(R1, ep1, 0), n2, C2)
    XeA = intersect(C1, ray(R1, ep1, 2), n2, C2)
    n1 = plane_n(R1, ep1)
    XsB = intersect(C2, ray(R2, ep2, 0), n1, C1)
    XeB = intersect(C2, ray(R2, ep2, 2), n1, C1)

    def depth(R, t, X):
        return ((X[0] * R[2, 0] + X[1] * R[2, 1]) + X[2] * R[2, 2]) + t[2]

    good = valid
    for X in (XsA, XeA, XsB, XeB):
        za, zb = depth(R1, t1, X), depth(R2, t2, X)
        good = good & (za > 0.05) & (zb > 0.05) & (za < max_depth) \
            & (zb < max_depth)
    for X in (XsA, XeA, XsB, XeB):
        good = good & torch.isfinite(X[0]) & torch.isfinite(X[1]) \
            & torch.isfinite(X[2])

    def unit(a):
        nrm = torch.clamp_min(_norm3(a), 1e-9)
        return [a[i] / nrm for i in range(3)]

    good = good & (torch.abs(_dot3(unit(n1), unit(n2))) < 0.99995)
    uA = unit([XeA[i] - XsA[i] for i in range(3)])
    uB = unit([XeB[i] - XsB[i] for i in range(3)])
    good = good & (torch.abs(_dot3(uA, uB)) > 0.996)

    def perp(X):
        v = [X[i] - XsA[i] for i in range(3)]
        s = _dot3(v, uA)
        return _norm3([v[i] - s * uA[i] for i in range(3)])

    scale = torch.clamp_min(
        depth(R1, t1, [(XsA[i] + XeA[i]) / 2 for i in range(3)]), 0.1)
    tol = 0.02 * scale
    good = good & (perp(XsB) < tol) & (perp(XeB) < tol)
    seg = _norm3([XeA[i] - XsA[i] for i in range(3)])
    good = good & (seg > 0.05) & (seg < 20.0)
    return torch.stack(XsA, -1), torch.stack(XeA, -1), good


LINE_TRIANGULATE = cuda.Kernel(
    "line_triangulate", "line_triangulate",
    [_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _P, _P, _P, _P])


def line_triangulate(K: PinholeK, pose1, pose2, ep1, ep2, valid,
                     max_depth: float = 40.0):
    """Line triangulation by interpretation-plane intersection (pose1 /
    pose2 [3,4] T_cw, ep1 / ep2 [N,4] matched segments, valid [N] bool):
    view 1's endpoint rays on view 2's plane, and the reverse, with the
    depth, finiteness, plane-angle, agreement, perpendicular-distance and
    length gates.  Returns (Xs_w [N,3], Xe_w [N,3], good [N]).  CPU tensors
    take the plain version; CUDA tensors launch csrc/line_triangulate.cu."""
    if valid.device.type == "cpu":
        return line_triangulate_plain(K, pose1, pose2, ep1, ep2, valid,
                                      max_depth)
    n = ep1.shape[0]
    cuda.check_cuda("line_triangulate", pose1, pose2, ep1, ep2, valid)
    f32 = torch.float32
    if any(t.dtype != f32 for t in (pose1, pose2, ep1, ep2)) \
            or valid.dtype != torch.bool or pose1.shape != (3, 4) \
            or pose2.shape != (3, 4) or ep1.shape != (n, 4) \
            or ep2.shape != (n, 4) or valid.shape != (n,):
        raise ValueError("line_triangulate: float32 poses [3,4], segments "
                         "[N,4] and a bool valid [N]")
    dev = ep1.device
    Xs = torch.empty(n, 3, dtype=f32, device=dev)
    Xe = torch.empty(n, 3, dtype=f32, device=dev)
    good = torch.empty(n, dtype=torch.bool, device=dev)
    LINE_TRIANGULATE.launch(
        cuda.ptr(pose1), cuda.ptr(pose2), cuda.ptr(ep1), cuda.ptr(ep2),
        cuda.ptr(valid), n, K.fx, K.fy, K.cx, K.cy, float(max_depth),
        cuda.ptr(Xs), cuda.ptr(Xe), cuda.ptr(good), cuda.stream())
    return Xs, Xe, good


def make_line_triangulator(K: PinholeK, plain: bool = False):
    """run(pose1, pose2, ep1 [N,4], ep2 [N,4], valid, max_depth=40.0) ->
    (Xs_w [N,3], Xe_w [N,3], good [N]) (see `line_triangulate`); `plain`
    runs the plain version on any device."""
    fn = line_triangulate_plain if plain else line_triangulate

    def run(pose1, pose2, ep1, ep2, valid, max_depth: float = 40.0):
        return fn(K, pose1.contiguous(), pose2.contiguous(),
                  ep1.contiguous(), ep2.contiguous(), valid, max_depth)
    return run


# 1.2 ** octave for octaves 0..7 as the reference's float32 power gives it
# (float32(1.2) raised in float64, rounded to float32; a CPU test holds it
# to JAX's `1.2 ** feat_octave.astype(float32)`)
OCTAVE_SCALE = M.OCTAVE_SCALE


def project_gates(K: PinholeK, pose, pt_xyz, pt_valid, pt_normal=None,
                  pt_min_dist=None, pt_max_dist=None):
    """Map points into the frame (models/kernels.py:780-805): (uv_proj
    [P,2], proj_ok [P]) with the depth guard z > 0.05, the image gate u in
    [0, 2 cx), v in [0, 2 cy), and with pt_min_dist / pt_max_dist the
    distance-range gate (0.8 min, 1.2 max; off where max <= 1e-6), with
    pt_normal too the viewing-angle gate cos > 0.5 (off where the normal is
    zero).  Every 3-vector product summed as (x0 y0 + x1 y1) + x2 y2.  A
    KB8K camera projects through `kb8_project_single` onto raw pixels and
    takes no viewing-angle gate, as the reference's fisheye matcher."""
    R, t = pose[:, :3], pose[:, 3]
    X = _v3(pt_xyz)
    pc = [_dot3([R[i, 0], R[i, 1], R[i, 2]], X) + t[i] for i in range(3)]
    z = pc[2]
    if isinstance(K, RES.KB8K):
        # the fisheye matcher (models/kernels.py:1443): raw pixels, and no
        # viewing-angle gate
        u, v = RES.kb8_project_single(K, torch.stack(pc, -1)).unbind(-1)
        pt_normal = None
    else:
        zc = torch.clamp_min(z, 1e-6)
        u = K.fx * pc[0] / zc + K.cx
        v = K.fy * pc[1] / zc + K.cy
    ok = pt_valid & (z > 0.05) & (u >= 0) & (u < 2 * K.cx) & (v >= 0) \
        & (v < 2 * K.cy)
    if pt_min_dist is not None:
        C = _centre(R, t)
        view = [X[i] - C[i] for i in range(3)]
        d_cam = _norm3(view)
        has_range = pt_max_dist > 1e-6
        ok = ok & (~has_range | ((d_cam > 0.8 * pt_min_dist)
                                 & (d_cam < 1.2 * pt_max_dist)))
        if pt_normal is not None:
            nrm = _v3(pt_normal)
            nn = _norm3(nrm)
            cos_v = _dot3(view, nrm) / torch.clamp_min(d_cam * nn, 1e-9)
            ok = ok & (~(nn > 1e-6) | (cos_v > 0.5))
    return torch.stack([u, v], -1), ok


def feat_back_map(idx, ok, n_feat: int):
    """feat_pt [n_feat] int32 of the reference's scatter
    `full(-1).at[where(ok, idx, 0)].set(where(ok, arange(P), -1))`
    (models/kernels.py:819-822) under its last-write-wins rule on
    duplicate indices: feature f takes the value of the highest row that
    writes it, so feat_pt[0] is -1 unless the last row writing 0 matched
    feature 0."""
    dev = idx.device
    rows = torch.arange(idx.shape[0], device=dev)
    safe = torch.where(ok, idx.long(), torch.zeros_like(rows))
    last = torch.full((n_feat,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, safe, rows, "amax")
    wrote_ok = (last >= 0) & ok[last.clamp_min(0)]
    return torch.where(wrote_ok, last, torch.full_like(last, -1)).to(
        torch.int32)


def proj_match_plain(K: PinholeK, pose, pt_xyz, pt_desc, pt_valid, feat_uv,
                     feat_desc, feat_octave, feat_valid, radius: float,
                     max_dist: float = 80.0, pt_normal=None,
                     pt_min_dist=None, pt_max_dist=None):
    """Plain version of `proj_match` (models/kernels.py:776-823): the
    projection and its gates (`project_gates`), the octave-scaled window
    d2 <= (radius 1.2^octave)^2, the Hamming NN (ratio 0.9, mutual,
    max_dist) and the feature back map.  Returns (uv_m [P,2], pt_feat [P]
    int32, matched [P], feat_pt [F] int32)."""
    uv, proj_ok = project_gates(K, pose, pt_xyz, pt_valid, pt_normal,
                                pt_min_dist, pt_max_dist)
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(pt_desc),
                            M.unpack_u32_to_pm1(feat_desc))
    scale = torch.from_numpy(OCTAVE_SCALE).to(feat_uv.device)[
        feat_octave.long().clamp(0, 7)]
    d2 = ((uv[:, None, :] - feat_uv[None, :, :]) ** 2).sum(-1)
    r = radius * scale
    idx, ok = M.match_nn_ratio(dist, proj_ok, feat_valid, d2 <= r * r,
                               max_dist=max_dist, ratio=0.9, mutual=True)
    return (feat_uv[idx.long()], idx, ok,
            feat_back_map(idx, ok, feat_uv.shape[0]))


_PROJ_MATCH_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _F, _F, _F, _F, _F, _F, _F, _F, _F] + [_F] * 8 \
    + [_I, _F, _F, _F, _F] + [_P] * 6
PROJ_MATCH = cuda.Kernel("proj_match", "proj_match", _PROJ_MATCH_ARGS)
# the same library entry in its KB8 mode, counted apart
PROJ_MATCH_KB8 = cuda.Kernel("proj_match", "proj_match", _PROJ_MATCH_ARGS)


def proj_match(K: PinholeK, pose, pt_xyz, pt_desc, pt_valid, feat_uv,
               feat_desc, feat_octave, feat_valid, radius: float,
               max_dist: float = 80.0, pt_normal=None, pt_min_dist=None,
               pt_max_dist=None):
    """Map points matched to a frame's features by projection (pose [3,4]
    T_cw, pt_xyz [P,3], pt_desc [P,8] int32, pt_valid [P]; feat_uv [F,2],
    feat_desc [F,8] int32, feat_octave [F] int32 in 0..7, feat_valid [F];
    the tracker's frustum gates when pt_min_dist / pt_max_dist [P] (and
    pt_normal [P,3]) are given).  Returns (uv_m [P,2], pt_feat [P] int32,
    matched [P], feat_pt [F] int32).  With a KB8K camera the points project
    onto raw pixels (feat_uv raw) and pt_normal is not read.  CPU tensors
    take the plain version; CUDA tensors launch csrc/proj_match.cu (its
    KB8 mode for a KB8K camera)."""
    if pose.device.type == "cpu":
        return proj_match_plain(K, pose, pt_xyz, pt_desc, pt_valid, feat_uv,
                                feat_desc, feat_octave, feat_valid, radius,
                                max_dist, pt_normal, pt_min_dist, pt_max_dist)
    P, F = pt_xyz.shape[0], feat_uv.shape[0]
    kb8 = isinstance(K, RES.KB8K)
    if kb8:
        pt_normal = None
    frustum = 0 if pt_min_dist is None else (1 if pt_normal is None else 2)
    ts = [pose, pt_xyz, pt_desc, pt_valid, feat_uv, feat_desc, feat_octave,
          feat_valid]
    want = [(pose, torch.float32, (3, 4)), (pt_xyz, torch.float32, (P, 3)),
            (pt_desc, torch.int32, (P, 8)), (pt_valid, torch.bool, (P,)),
            (feat_uv, torch.float32, (F, 2)),
            (feat_desc, torch.int32, (F, 8)),
            (feat_octave, torch.int32, (F,)), (feat_valid, torch.bool, (F,))]
    if frustum:
        ts += [pt_min_dist, pt_max_dist]
        want += [(pt_min_dist, torch.float32, (P,)),
                 (pt_max_dist, torch.float32, (P,))]
    if frustum == 2:
        ts.append(pt_normal)
        want.append((pt_normal, torch.float32, (P, 3)))
    cuda.check_cuda("proj_match", *ts)
    for i, (x, dt, shape) in enumerate(want):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"proj_match: argument {i} must be {dt} {shape},"
                             f" got {x.dtype} {tuple(x.shape)}")
    if P >= 1 << 16 or F > 3600:
        # row ids share a 32-bit word with the distance; the columns'
        # positions, windows and flags fit 48 KB of shared memory
        raise ValueError("proj_match: needs P < 65536 points and F <= 3600 "
                         "features")
    dev = pose.device
    uv_m = torch.empty(P, 2, dtype=torch.float32, device=dev)
    pt_feat = torch.empty(P, dtype=torch.int32, device=dev)
    matched = torch.empty(P, dtype=torch.bool, device=dev)
    feat_pt = torch.empty(F, dtype=torch.int32, device=dev)
    col_best = torch.empty(max(F, 1), dtype=torch.int32, device=dev)
    if P == 0 or F == 0:
        feat_pt.fill_(-1)
        pt_feat.zero_()
        matched.zero_()
        uv_m.zero_()
        return uv_m, pt_feat, matched, feat_pt
    opt = [cuda.ptr(x) if x is not None else None
           for x in (pt_normal, pt_min_dist, pt_max_dist)]
    ks = (K.k1, K.k2, K.k3, K.k4) if kb8 else (0.0,) * 4
    (PROJ_MATCH_KB8 if kb8 else PROJ_MATCH).launch(
        cuda.ptr(pose), cuda.ptr(pt_xyz), cuda.ptr(pt_desc),
        cuda.ptr(pt_valid), *opt, cuda.ptr(feat_uv), cuda.ptr(feat_desc),
        cuda.ptr(feat_octave), cuda.ptr(feat_valid), P, F, frustum, K.fx,
        K.fy, K.cx, K.cy, float(2 * K.cx), float(2 * K.cy), float(radius),
        float(max_dist), 0.9, *[float(s) for s in OCTAVE_SCALE], int(kb8),
        *ks, cuda.ptr(uv_m), cuda.ptr(pt_feat), cuda.ptr(matched),
        cuda.ptr(feat_pt), cuda.ptr(col_best), cuda.stream())
    return uv_m, pt_feat, matched, feat_pt


def make_projection_matcher(K: PinholeK, plain: bool = False):
    """run(pose [3,4], pt_xyz [P,3], pt_desc [P,8] int32, pt_valid,
    feat_uv [F,2], feat_desc [F,8] int32, feat_octave [F] int32,
    feat_valid, radius, max_dist=80.0, pt_normal=None, pt_min_dist=None,
    pt_max_dist=None) -> (uv_m [P,2], pt_feat [P], matched [P], feat_pt
    [F]): the projection matcher of the fuse (radius 2, max_dist 50) and
    of the tracker (frustum gates, radius 6, max_dist 80), see
    `proj_match`.  `plain` runs the plain version on any device."""
    fn = proj_match_plain if plain else proj_match

    def run(pose, pt_xyz, pt_desc, pt_valid, feat_uv, feat_desc, feat_octave,
            feat_valid, radius, max_dist: float = 80.0, pt_normal=None,
            pt_min_dist=None, pt_max_dist=None):
        return fn(K, pose.contiguous(), pt_xyz.contiguous(), pt_desc,
                  pt_valid, feat_uv.contiguous(), feat_desc, feat_octave,
                  feat_valid, float(radius), float(max_dist), pt_normal,
                  pt_min_dist, pt_max_dist)
    return run


def make_projection_matcher_kb8(K8: RES.KB8K, plain: bool = False):
    """`make_projection_matcher` of a KB8 fisheye (models/kernels.py:1443):
    the points project through the equidistant model onto raw pixels,
    feat_uv are raw pixels, and pt_normal is not read (range gate only).
    `plain` runs the plain version on any device."""
    return make_projection_matcher(K8, plain=plain)


# --------------------------------------------------------------------------
# The inertial back end of the keyframe step: the sliding-window VI BA,
# IMU initialization and scale refinement
# --------------------------------------------------------------------------

def _liba_problem(K, Rcb, tcb, gravity, n_kf, n_pt, n_ln, obs, mask, lobs,
                  mask_l, chain):
    """The inertial window BA's problem (models/kernels.py:1260-1291):
    per-KF (pose_wb, vel, bg, ba), body-frame point and line edges to
    Schur-eliminated landmarks, the inertial edge and the two bias random
    walks along the chain."""
    obs_kf, obs_pt, obs_uv, obs_is2 = obs
    pre_const, imu_info, edge_valid, rw_g, rw_a = chain
    dev = obs_kf.device
    delta = float(math.sqrt(CHI2_MONO))
    prob = E.Problem(linear_solver="cg")
    prob.add_dense("pose", n_kf, 6, RES.retract_pose_wb)
    prob.add_dense("vel", n_kf, 3, RES.retract_additive)
    prob.add_dense("bg", n_kf, 3, RES.retract_additive)
    prob.add_dense("ba", n_kf, 3, RES.retract_additive)
    prob.add_landmarks("pt", n_pt, 3, RES.retract_additive)
    prob.add_term(E.Term(
        name="reproj", res_fn=RES.point_reproj_body_ba_for(K, Rcb, tcb),
        rdim=2, dense_refs=[("pose", obs_kf)], lm_ref=("pt", obs_pt),
        const={"uv": obs_uv}, mask=mask, info=obs_is2, robust_delta=delta))
    if lobs is not None:
        lobs_kf, lobs_ln, lobs_eq = lobs
        prob.add_landmarks("ln", n_ln, 6, RES.retract_additive)
        prob.add_term(E.Term(
            name="line", res_fn=RES.make_line_reproj_body_ba(K, Rcb, tcb),
            rdim=2, dense_refs=[("pose", lobs_kf)], lm_ref=("ln", lobs_ln),
            const={"l": lobs_eq}, mask=mask_l,
            info=torch.ones(lobs_kf.shape[0], dtype=obs_uv.dtype,
                            device=dev),
            robust_delta=delta))
    i1 = torch.arange(n_kf - 1, device=dev)
    i2 = i1 + 1
    prob.add_term(E.Term(
        name="inertial", res_fn=RES.make_inertial(gravity), rdim=9,
        dense_refs=[("pose", i1), ("vel", i1), ("bg", i1), ("ba", i1),
                    ("pose", i2), ("vel", i2)],
        const=pre_const, mask=edge_valid, info=imu_info))
    prob.add_term(E.Term(name="bg_rw", res_fn=RES.bias_rw, rdim=3,
                         dense_refs=[("bg", i1), ("bg", i2)],
                         mask=edge_valid, info=rw_g))
    prob.add_term(E.Term(name="ba_rw", res_fn=RES.bias_rw, rdim=3,
                         dense_refs=[("ba", i1), ("ba", i2)],
                         mask=edge_valid, info=rw_a))
    return prob


def local_inertial_ba_plain(K: PinholeK, Rcb, tcb, gravity: float,
                            kf_pose_wb, kf_vel, kf_bg, kf_ba, kf_free,
                            kf_free_bias, pt_xyz, pt_free, obs_kf, obs_pt,
                            obs_uv, obs_valid, obs_is2, pre_const, imu_info,
                            edge_valid, rw_info_g, rw_info_a, ln_ep=None,
                            ln_free=None, lobs_kf=None, lobs_ln=None,
                            lobs_eq=None, lobs_valid=None, rounds: int = 2,
                            iters: int = 8, early_tol: float = 1e-2,
                            stats=None):
    """Plain version of the sliding-window VI BA on the engine: `rounds`
    x <= `iters` LM iterations (CG reduced solve, early exit at
    early_tol), the chi2 gate re-applied to the point and line edges
    between rounds.  Returns (pose_wb, vel, bg, ba, pt_xyz, inlier,
    ln_ep, inlier_l), the last two None without lines; `stats` (a list)
    gets each round's iteration count."""
    n_kf, n_pt = kf_pose_wb.shape[0], pt_xyz.shape[0]
    Rcb = torch.as_tensor(Rcb).to(kf_pose_wb.device, kf_pose_wb.dtype)
    tcb = torch.as_tensor(tcb).to(kf_pose_wb.device, kf_pose_wb.dtype)
    with_lines = ln_ep is not None and ln_ep.shape[0] > 0 \
        and lobs_kf.shape[0] > 0
    n_ln = ln_ep.shape[0] if with_lines else 0
    obs = (obs_kf.long(), obs_pt.long(), obs_uv, obs_is2)
    lobs = (lobs_kf.long(), lobs_ln.long(), lobs_eq) if with_lines else None
    chain = (pre_const, imu_info, edge_valid, rw_info_g, rw_info_a)
    states = {"pose": kf_pose_wb, "vel": kf_vel, "bg": kf_bg, "ba": kf_ba,
              "pt": pt_xyz}
    lm_free = {"pt": pt_free}
    if with_lines:
        states["ln"] = ln_ep
        lm_free["ln"] = ln_free
    free = {"pose": kf_free, "vel": kf_free, "bg": kf_free_bias,
            "ba": kf_free_bias}
    mask, mask_l = obs_valid, lobs_valid
    for _ in range(rounds):
        prob = _liba_problem(K, Rcb, tcb, gravity, n_kf, n_pt, n_ln, obs,
                             mask, lobs, mask_l, chain)
        states, _, chi2s = E.optimize(prob, states, iters=iters,
                                      early_tol=early_tol,
                                      dense_free_mask=free,
                                      lm_free_mask=lm_free, stats=stats)
        mask = obs_valid & (chi2s["reproj"] < CHI2_MONO)
        if with_lines:
            mask_l = lobs_valid & (chi2s["line"] < CHI2_MONO)
    return (states["pose"], states["vel"], states["bg"], states["ba"],
            states["pt"], mask, states["ln"] if with_lines else None,
            mask_l if with_lines else None)


def _stack_pre(pre_const, n_e: int) -> torch.Tensor:
    """The stacked preintegration constants -> [n_e, 67] (PRE_KEYS order,
    each row-major), the layout of csrc/inertial.cuh `Pre`."""
    return torch.cat([pre_const[k].reshape(n_e, -1) for k in PRE_KEYS],
                     1).contiguous()


# pointer-table entries of the inertial window (csrc/ba_common.cuh, after
# the point+line BA's)
_LIBA_PTRS = ("kfx", "ckfx", "kf_free_bias", "pre", "imu_info",
              "edge_valid", "rw_g", "rw_a", "link", "link_cost", "ccost")
INERTIAL_CHAIN = cuda.Kernel("inertial_chain", "inertial_chain",
                             [_P, _P, _P, _I, _P])
CHAIN_LINEARIZE, CHAIN_COST_CAND, CHAIN_COST_STATE = range(3)
LINK_FLOATS = 465 + 30     # a link's packed 30x30 upper triangle and g


def inertial_work(K: PinholeK, Rcb, tcb, gravity: float, kf_pose_wb,
                  kf_vel, kf_bg, kf_ba, kf_free, kf_free_bias, pt_xyz,
                  pt_free, obs_kf, obs_pt, obs_uv, obs_valid, obs_is2,
                  pre_const, imu_info, edge_valid, rw_info_g, rw_info_a,
                  ln_ep=None, ln_free=None, lobs_kf=None, lobs_ln=None,
                  lobs_eq=None, lobs_valid=None, early_tol: float = 1e-2):
    """The kernel path's buffers of one inertial window BA call
    (`_BAWork` in its inertial configuration), after checking every
    argument's device, dtype, shape and contiguity."""
    dev = kf_pose_wb.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    n_kf, n_pt, n_obs = kf_pose_wb.shape[0], pt_xyz.shape[0], obs_kf.shape[0]
    if ln_ep is None:
        ln_ep = torch.zeros(0, 6, dtype=f32, device=dev)
        ln_free = lobs_valid = torch.zeros(0, dtype=b8, device=dev)
        lobs_kf = lobs_ln = torch.zeros(0, dtype=i32, device=dev)
        lobs_eq = torch.zeros(0, 3, dtype=f32, device=dev)
    n_ln, n_lobs = ln_ep.shape[0], lobs_kf.shape[0]
    if n_kf < 2:
        raise ValueError("local_inertial_ba: at least 2 keyframes")
    n_e = n_kf - 1
    pre = _stack_pre(pre_const, n_e)
    want = [(kf_pose_wb, f32, (n_kf, 3, 4)), (kf_vel, f32, (n_kf, 3)),
            (kf_bg, f32, (n_kf, 3)), (kf_ba, f32, (n_kf, 3)),
            (kf_free, b8, (n_kf,)), (kf_free_bias, b8, (n_kf,)),
            (pt_xyz, f32, (n_pt, 3)), (pt_free, b8, (n_pt,)),
            (obs_kf, i32, (n_obs,)), (obs_pt, i32, (n_obs,)),
            (obs_uv, f32, (n_obs, 2)), (obs_valid, b8, (n_obs,)),
            (obs_is2, f32, (n_obs,)), (pre, f32, (n_e, 67)),
            (imu_info, f32, (n_e, 9, 9)), (edge_valid, b8, (n_e,)),
            (rw_info_g, f32, (n_e,)), (rw_info_a, f32, (n_e,)),
            (ln_ep, f32, (n_ln, 6)), (ln_free, b8, (n_ln,)),
            (lobs_kf, i32, (n_lobs,)), (lobs_ln, i32, (n_lobs,)),
            (lobs_eq, f32, (n_lobs, 3)), (lobs_valid, b8, (n_lobs,))]
    for i, (x, dt, shape) in enumerate(want):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"local_inertial_ba: argument {i} must be {dt} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    cuda.check_cuda("local_inertial_ba", *[x for x, _, _ in want])
    S = 15 * n_kf
    extra = dict(
        kfx=torch.cat([kf_vel, kf_bg, kf_ba], 1).contiguous(),
        kf_free_bias=kf_free_bias, pre=pre,
        imu_info=imu_info.reshape(n_e, 81).contiguous(),
        edge_valid=edge_valid, rw_g=rw_info_g, rw_a=rw_info_a,
        Rcb=Rcb, tcb=tcb, gravity=gravity)
    lobs_is2 = torch.ones(n_lobs, dtype=f32, device=dev)
    w = _BAWork(K, kf_pose_wb, kf_free, pt_xyz, pt_free, obs_kf, obs_pt,
                obs_uv, obs_valid, obs_is2, ln_ep, ln_free, lobs_kf, lobs_ln,
                lobs_eq, lobs_valid, lobs_is2, lam0=1e-4,
                early_tol=early_tol, cg_iters=min(max(S // 2, 16), 128),
                inertial=extra)
    return w


def local_inertial_ba(K: PinholeK, Rcb, tcb, gravity: float, kf_pose_wb,
                      kf_vel, kf_bg, kf_ba, kf_free, kf_free_bias, pt_xyz,
                      pt_free, obs_kf, obs_pt, obs_uv, obs_valid, obs_is2,
                      pre_const, imu_info, edge_valid, rw_info_g, rw_info_a,
                      ln_ep=None, ln_free=None, lobs_kf=None, lobs_ln=None,
                      lobs_eq=None, lobs_valid=None, rounds: int = 2,
                      iters: int = 8, early_tol: float = 1e-2, stats=None):
    """The sliding-window VI BA (see `local_inertial_ba_plain`).  CPU
    tensors take the plain version; CUDA tensors run every LM iteration on
    csrc/ba_linearize.cu (body-frame point and line edges),
    csrc/inertial_chain.cu (inertial and bias random-walk edges) and
    csrc/schur_solve.cu (the 15-DoF Schur step), with accept/reject, the
    damping, the early exit and the chi2 re-gating on the device.  `stats`
    (a list) gets, per round, a device tensor holding the iterations
    run."""
    args = (kf_pose_wb, kf_vel, kf_bg, kf_ba, kf_free, kf_free_bias, pt_xyz,
            pt_free, obs_kf, obs_pt, obs_uv, obs_valid, obs_is2, pre_const,
            imu_info, edge_valid, rw_info_g, rw_info_a, ln_ep, ln_free,
            lobs_kf, lobs_ln, lobs_eq, lobs_valid)
    if kf_pose_wb.device.type == "cpu":
        return local_inertial_ba_plain(K, Rcb, tcb, gravity, *args,
                                       rounds=rounds, iters=iters,
                                       early_tol=early_tol, stats=stats)
    w = inertial_work(K, Rcb, tcb, gravity, *args, early_tol=early_tol)
    n_kf = kf_pose_wb.shape[0]
    with_lines = ln_ep is not None and ln_ep.shape[0] > 0 \
        and lobs_kf.shape[0] > 0
    for _ in range(rounds):
        w.chain(CHAIN_COST_STATE)
        w.linearize(BA_MODE_INIT)
        for _ in range(iters):
            w.step()
        w.chain(CHAIN_COST_STATE)
        w.linearize(BA_MODE_REGATE)
        if stats is not None:
            stats.append(w.t["ctrl"][4].clone())
    t = w.t
    kfx = t["kfx"]
    return (t["poses"].view(n_kf, 3, 4), kfx[:, 0:3].contiguous(),
            kfx[:, 3:6].contiguous(), kfx[:, 6:9].contiguous(), t["pts"],
            t["mask"], t["lns"] if with_lines else None,
            t["mask_l"] if with_lines else None)


# the argument order of make_local_inertial_ba's run, by the names of
# inputs.build_inertial_window's dict
LIBA_KEYS = ("kf_pose_wb", "kf_vel", "kf_bg", "kf_ba", "kf_free",
             "kf_free_bias", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
             "obs_uv", "obs_valid", "obs_is2", "pre_const", "imu_info",
             "edge_valid", "rw_info_g", "rw_info_a", "ln_ep6", "ln_free",
             "lobs_kf", "lobs_ln", "lobs_eq", "lobs_valid")


def make_local_inertial_ba(K: PinholeK, n_kf: int, n_pt: int, n_obs: int,
                           Rcb, tcb, gravity: float, rounds: int = 2,
                           iters: int = 8, n_ln: int = 0, n_lobs: int = 0,
                           early_tol: float = 1e-2, plain: bool = False):
    """run(kf_pose_wb [n_kf,3,4], kf_vel, kf_bg, kf_ba, kf_free,
    kf_free_bias, pt_xyz [n_pt,3], pt_free, obs_kf, obs_pt [n_obs] int32,
    obs_uv, obs_valid, obs_is2, pre_const (stacked [n_kf-1, ...]),
    imu_info [n_kf-1,9,9], edge_valid, rw_info_g, rw_info_a [, ln_ep
    [n_ln,6], ln_free, lobs_kf, lobs_ln [n_lobs] int32, lobs_eq, lobs_valid],
    stats=None) -> (pose_wb, vel, bg, ba, pt_xyz, inlier, ln_ep, inlier_l)
    (the last two None without lines):
    the sliding-window visual-inertial BA (reference LocalInertialBA /
    FullInertialBAwithLine), 2 rounds x <= 8 LM iterations, CG reduced
    solve, early exit at 1e-2, the chi2 re-gate on the point and line
    edges between rounds; the line edges have information 1.  The sizes
    are checked against the arguments' shapes.  `plain` runs the plain
    version on any device."""
    fn = local_inertial_ba_plain if plain else local_inertial_ba
    Rcb = torch.as_tensor(np.asarray(Rcb, np.float32))
    tcb = torch.as_tensor(np.asarray(tcb, np.float32))
    sizes = {"n_kf": n_kf, "n_pt": n_pt, "n_obs": n_obs, "n_ln": n_ln,
             "n_lobs": n_lobs}

    def run(*args, stats=None):
        got = {"n_kf": args[0].shape[0], "n_pt": args[6].shape[0],
               "n_obs": args[8].shape[0],
               "n_ln": args[18].shape[0] if len(args) > 18 else 0,
               "n_lobs": args[20].shape[0] if len(args) > 18 else 0}
        if got != sizes:
            raise ValueError(f"local inertial BA built for {sizes}, called "
                             f"with {got}")
        # the extrinsic stays on the host: the kernel path reads it as
        # launch parameters, the plain path moves it to the states' device
        dt = args[0].dtype
        return fn(K, Rcb.to(dtype=dt), tcb.to(dtype=dt), gravity, *args,
                  rounds=rounds, iters=iters, early_tol=early_tol,
                  stats=stats)
    return run



# the point+line window BA's argument order (local_ba_pl), by the names of
# inputs.build_mapping_inputs's dict
BA_KEYS = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
           "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free", "lobs_kf",
           "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")


def global_window(kind: str, n_kf: int, device, dtype=torch.float32,
                  kb8: bool = False):
    """A perturbed window at the full-map BAs' caps (beyond one block's
    shared memory at their keyframe counts, see `solve_fits`): `inertial`,
    the full-map inertial BA's caps at n_kf keyframes (8192 points /
    16384 observations, 512 lines / 1024; with `kb8` seen by the fisheye
    room's camera, `build_inertial_window(kb8=True)`), or
    `points`, the global point-only BA's (8192 points / 32768
    observations).  Returns (inputs, argument list, plain problem, states,
    free masks) at `dtype` on `device`; the inputs stay on the CPU."""
    from ..inputs import (build_inertial_window, build_mapping_inputs,
                          perturb_window)
    K = _window_camera(kb8)
    dev = torch.device(device)
    if kind == "inertial":
        A = build_inertial_window(8192, 16384, 512, 1024, n_kf=n_kf,
                                  perturbed=True, device="cpu", kb8=kb8)
        keys = LIBA_KEYS
    else:
        A = build_mapping_inputs(n_kf, 8192, 32768, n_ln=0, n_lobs=0,
                                 device="cpu")
        P, X = perturb_window(A["kf_poses"].numpy(), A["pt_xyz"].numpy())
        A["kf_poses"], A["pt_xyz"] = torch.from_numpy(P), torch.from_numpy(X)
        keys = BA_KEYS

    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        v = v.to(dev)
        return v.to(dtype) if v.is_floating_point() else v
    args = [cast(A[k]) for k in keys]
    return (A, args) + _window_problem(kind, K, args, A.get("Rcb"),
                                       A.get("tcb"))


def _window_problem(kind: str, K, args, Rcb=None, tcb=None):
    """The plain engine's (problem, states, free masks) of a `global_window`
    argument list (`inertial`: LIBA_KEYS, with the extrinsic Rcb, tcb;
    `points`: BA_KEYS), at the arguments' device and dtype."""
    n_kf = args[0].shape[0]
    if kind == "inertial":
        dt, dev = args[0].dtype, args[0].device
        prob = _liba_problem(
            K, Rcb.to(dev, dt), tcb.to(dev, dt), 9.81, n_kf,
            args[6].shape[0], args[18].shape[0],
            (args[8].long(), args[9].long(), args[10], args[12]), args[11],
            (args[20].long(), args[21].long(), args[22]), args[23],
            (args[13], args[14], args[15], args[16], args[17]))
        st = {"pose": args[0], "vel": args[1], "bg": args[2], "ba": args[3],
              "pt": args[6], "ln": args[18]}
        free = ({"pose": args[4], "vel": args[4], "bg": args[5],
                 "ba": args[5]}, {"pt": args[7], "ln": args[19]})
    else:
        prob = _ba_problem(K, n_kf, args[2].shape[0], 0,
                           args[4].long(), args[5].long(), args[6], args[7],
                           args[8])
        st = {"pose": args[0], "pt": args[2]}
        free = ({"pose": args[1]}, {"pt": args[3]})
    return prob, st, free


class StepGap(NamedTuple):
    """One dense state's largest entry gaps after one Schur step: kernel -
    float64, plain - float64, kernel - plain, and the float64 step's own
    largest entry |new - old|."""
    kernel: float
    plain: float
    kernel_plain: float
    step: float


class GlobalSolveCheck(NamedTuple):
    """`global_solve_against_float64`'s result: S, the path the kernel
    reported (0 one block, 1 global) and the one `solve_fits` names,
    whether a second launch gave the same bits, a StepGap per dense state,
    and `case` (the kernel path's work, the window's inputs and the plain
    problem, for timing)."""
    S: int
    path: int
    want_path: int
    same_bits: bool
    gaps: dict
    case: dict

    def failures(self) -> list:
        """What breaks the rule the reduced solve is held to: the path
        `solve_fits` names ran (the global one beyond one block); a
        second launch repeats bit for bit; per state the kernel lies
        within 2x the plain float32 step's distance to float64 and no
        farther from the plain step than that step lies from float64 (each
        + 1e-6); and its pose lies within a quarter of the float64 step's
        largest pose entry of the float64 step.  Empty when it holds."""
        bad = []
        if self.path != self.want_path:
            bad.append(f"S = {self.S} took path {self.path}, not "
                       f"{self.want_path}")
        if not self.same_bits:
            bad.append("a second launch gave other bits")
        for name, g in self.gaps.items():
            if g.kernel > 2 * g.plain + 1e-6:
                bad.append(f"{name}: kernel {g.kernel:.2e} from float64 > "
                           f"2x the plain step's {g.plain:.2e} + 1e-6")
            if g.kernel_plain > g.plain + 1e-6:
                bad.append(f"{name}: kernel - plain {g.kernel_plain:.2e} > "
                           f"the plain step's {g.plain:.2e} from float64 "
                           "+ 1e-6")
        g = self.gaps["pose"]
        if g.kernel > 0.25 * g.step:
            bad.append(f"pose: kernel {g.kernel:.2e} from float64 > a "
                       f"quarter of the step's {g.step:.2e}")
        return bad

    def summary(self) -> str:
        return ", ".join(
            f"{k} {g.kernel:.2e} / {g.plain:.2e} / {g.kernel_plain:.2e} "
            f"(step {g.step:.2e})" for k, g in self.gaps.items())


def _window_camera(kb8: bool):
    """The EuRoC pinhole of the synthetic windows, or the fisheye room's
    KB8 camera."""
    from ..entry import K_EUROC
    from ..inputs import kb8_camera
    return kb8_camera() if kb8 else K_EUROC


def global_work(kind: str, n_kf: int, device, kb8: bool = False):
    """`global_window(kind, n_kf, device, kb8=kb8)` and its kernel path's
    `_BAWork`, linearized at the perturbed start (damping 1e-4, the
    reference engine's initial lambda), ready for a Schur step: (inputs,
    argument list, plain problem, states, free masks, work)."""
    K = _window_camera(kb8)
    A, args, prob, st, free = global_window(kind, n_kf, device, kb8=kb8)
    if kind == "inertial":
        w = inertial_work(K, A["Rcb"], A["tcb"], 9.81, *args)
        w.chain(CHAIN_COST_STATE)
    else:
        S = 6 * n_kf
        w = _BAWork(K, *args, lam0=1e-4, early_tol=1e-2,
                    cg_iters=min(max(S // 2, 16), 128))
    w.linearize(BA_MODE_INIT)
    w.linearize(BA_MODE_LINEARIZE)
    if w.body:
        w.chain(CHAIN_LINEARIZE)
    return A, args, prob, st, free, w


def global_solve_against_float64(kind: str, n_kf: int, device="cuda",
                                 kb8: bool = False) -> GlobalSolveCheck:
    """schur_solve's reduced solve on `global_window(kind, n_kf,
    kb8=kb8)`, on the path `solve_fits` names (the global path beyond one
    block, the windows this is made for): one damped Schur step from the
    perturbed start, launched twice, against the plain engine's step in
    float32 on the same device and in float64 on the CPU (damping 1e-4,
    the reference engine's initial lambda)."""
    dev = cuda.resolve_device(device)
    lam = 1e-4
    A, args, prob, st, free, w = global_work(kind, n_kf, dev, kb8=kb8)
    S = w.S
    t = w.t

    def cand():
        w.solve()
        out = {"pose": t["cposes"].view(n_kf, 3, 4).clone()}
        if w.body:
            kfx = t["ckfx"]
            out.update(vel=kfx[:, :3].clone(), bg=kfx[:, 3:6].clone(),
                       ba=kfx[:, 6:].clone())
        return out
    with torch.no_grad():
        ck, ck2 = cand(), cand()
        plain = prob.solve_step(st, torch.tensor(lam, device=dev), *free)[0]
        _, _, p64, s64, f64 = global_window(kind, n_kf, "cpu", torch.float64,
                                            kb8=kb8)
        ref = p64.solve_step(s64, torch.tensor(lam, dtype=torch.float64),
                             *f64)[0]
    gaps = {}
    for name in ck:
        k, p = ck[name].double().cpu(), plain[name].double().cpu()
        gaps[name] = StepGap(float((k - ref[name]).abs().max()),
                             float((p - ref[name]).abs().max()),
                             float((k - p).abs().max()),
                             float((ref[name] - s64[name]).abs().max()))
    return GlobalSolveCheck(
        S, w.solve_path(), int(not solve_fits(n_kf, w.body)),
        all(torch.equal(ck[k], ck2[k]) for k in ck), gaps,
        dict(inputs=A, work=w, prob=prob, states=st, free=free, lam=lam))

def global_step_against_float64(kind: str, n_kf: int,
                                device="cuda") -> dict:
    """One damped Schur step (damping 1e-4) from `global_window(kind,
    n_kf)`'s perturbed start: the kernel path on the card against the
    plain engine's step in float32 on FLOAT32_ORDERS observation orders
    and in float64, both on the CPU, by `against_float64`'s rule on each
    keyframe state apart (pose; velocity and biases in a 15-DoF window).
    Returns {state: `against_float64`'s dict}."""
    dev = cuda.resolve_device(device)
    K = _window_camera(False)
    A, args, _, _, _ = global_window(kind, n_kf, dev)
    body = kind == "inertial"
    names = ("pose", "vel", "bg", "ba") if body else ("pose",)

    def kernel(*a):
        if body:
            w = inertial_work(K, A["Rcb"], A["tcb"], 9.81, *a)
            w.chain(CHAIN_COST_STATE)
        else:
            w = _BAWork(K, *a, lam0=1e-4, early_tol=1e-2,
                        cg_iters=min(max(3 * n_kf, 16), 128))
        w.linearize(BA_MODE_INIT)
        w.linearize(BA_MODE_LINEARIZE)
        if body:
            w.chain(CHAIN_LINEARIZE)
        w.solve()
        out = (w.t["cposes"].view(n_kf, 3, 4).clone(),)
        if body:
            kfx = w.t["ckfx"]
            out += (kfx[:, :3].clone(), kfx[:, 3:6].clone(),
                    kfx[:, 6:].clone())
        return out

    def plain(*a):
        prob, st, free = _window_problem(kind, K, a, A.get("Rcb"),
                                         A.get("tcb"))
        with torch.no_grad():
            got = prob.solve_step(st, torch.tensor(
                1e-4, dtype=a[0].dtype), *free)[0]
        return tuple(got[k] for k in names)
    rows = LIBA_ROWS if body else ((4, 5, 6, 7, 8),)
    return {name: against_float64(kernel, plain, args, (j,), rows=rows)
            for j, name in enumerate(names)}


def _gs_problem(gravity, n_kf, pre_const, pose_R, pose_p, imu_info,
                edge_valid, prior_g=None, prior_a=None, order=None):
    """The IMU-initialization problem (models/kernels.py:1162-1195):
    gravity direction, scale, shared biases and per-KF velocities with the
    poses fixed; the bias priors when prior_g / prior_a are given.  `order`
    (a permutation of the n_kf - 1 edges) lists the edges in another
    order: the same problem, its sums taken in that order."""
    dev = pose_p.device
    n_e = n_kf - 1
    i1 = torch.arange(n_e, device=dev) if order is None else order.to(dev)
    z = torch.zeros(n_e, dtype=torch.int64, device=dev)
    const = {k: v[i1] for k, v in pre_const.items()}
    const.update(R1=pose_R[i1], p1=pose_p[i1], R2=pose_R[i1 + 1],
                 p2=pose_p[i1 + 1])
    imu_info, edge_valid = imu_info[i1], edge_valid[i1]
    prob = E.Problem()
    prob.add_dense("gdir", 1, 2, RES.retract_gdir)
    prob.add_dense("scale", 1, 1, RES.retract_scale)
    prob.add_dense("bg", 1, 3, RES.retract_additive)
    prob.add_dense("ba", 1, 3, RES.retract_additive)
    prob.add_dense("vel", n_kf, 3, RES.retract_additive)
    prob.add_term(E.Term(
        name="gs", res_fn=RES.make_inertial_gs(gravity), rdim=9,
        dense_refs=[("gdir", z), ("scale", z), ("bg", z), ("ba", z),
                    ("vel", i1), ("vel", i1 + 1)],
        const=const, mask=edge_valid, info=imu_info))
    if prior_g is not None:
        z1 = torch.zeros(1, dtype=torch.int64, device=dev)
        one = torch.ones(1, dtype=torch.bool, device=dev)
        x0 = torch.zeros(1, 3, dtype=pose_p.dtype, device=dev)
        for name, info in (("bg", prior_g), ("ba", prior_a)):
            prob.add_term(E.Term(
                name=f"prior_{name}", res_fn=RES.state_prior, rdim=3,
                dense_refs=[(name, z1)], const={"x0": x0}, mask=one,
                info=torch.full((1,), info, dtype=pose_p.dtype, device=dev)))
    return prob


def inertial_init_plain(gravity: float, Rwg0, vel0, pre_const, pose_R,
                        pose_p, imu_info, edge_valid, iters: int = 20,
                        prior_g: float = 1e2, prior_a: float = 1e10,
                        order=None):
    """Plain version of the IMU initialization on the dense engine: every
    state free from scale 1 and zero biases, `iters` LM iterations (no
    early exit), Cholesky solve (`order`: the edges' order in the sums,
    `_gs_problem`).  Returns (Rwg, scale, bg, ba, vel)."""
    n_kf = vel0.shape[0]
    dt_ = vel0.dtype
    prob = _gs_problem(gravity, n_kf, pre_const, pose_R, pose_p, imu_info,
                       edge_valid, prior_g, prior_a, order)
    z = torch.zeros(1, 3, dtype=dt_, device=vel0.device)
    states = {"gdir": Rwg0[None], "scale": torch.ones(1, 1, dtype=dt_,
                                                      device=vel0.device),
              "bg": z, "ba": z.clone(), "vel": vel0}
    states, _, _ = E.optimize(prob, states, iters=iters)
    return (states["gdir"][0], states["scale"][0, 0], states["bg"][0],
            states["ba"][0], states["vel"])


def scale_refine_plain(gravity: float, Rwg0, vel, bg, ba, pre_const, pose_R,
                       pose_p, imu_info, edge_valid, iters: int = 12,
                       order=None):
    """Plain version of the scale/gravity refinement: the same edges with
    only the gravity direction and the scale free (`order` as
    `inertial_init_plain`'s).  Returns (Rwg, scale)."""
    n_kf = vel.shape[0]
    dev = vel.device
    prob = _gs_problem(gravity, n_kf, pre_const, pose_R, pose_p, imu_info,
                       edge_valid, order=order)
    states = {"gdir": Rwg0[None], "scale": torch.ones(1, 1, dtype=vel.dtype,
                                                      device=dev),
              "bg": bg[None], "ba": ba[None], "vel": vel}
    t = torch.ones(1, dtype=torch.bool, device=dev)
    free = {"gdir": t, "scale": t, "bg": ~t, "ba": ~t,
            "vel": torch.zeros(n_kf, dtype=torch.bool, device=dev)}
    states, _, _ = E.optimize(prob, states, iters=iters,
                              dense_free_mask=free)
    return states["gdir"][0], states["scale"][0, 0]


INERTIAL_GS_LM = cuda.Kernel(
    "inertial_gs_lm", "inertial_gs_lm",
    [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P])


def inertial_gs_lm(gravity: float, Rwg0, vel0, bg0, ba0, pre_const, pose_R,
                   pose_p, imu_info, edge_valid, iters: int, refine: bool,
                   prior_g: float = 0.0, prior_a: float = 0.0):
    """The dense LM of the IMU initialization (refine False: every state
    free, the bias priors prior_g / prior_a) or of the scale refinement
    (refine True: only the gravity direction and the scale free) in one
    launch of csrc/inertial_gs_lm.cu.  Returns (Rwg [3,3], scale, bg, ba,
    vel [n_kf,3])."""
    n = vel0.shape[0]
    dev = vel0.device
    f32 = torch.float32
    if n < 2:
        raise ValueError("inertial_gs_lm: at least 2 keyframes")
    state = torch.cat([Rwg0.reshape(-1), torch.ones(1, dtype=f32,
                                                    device=dev),
                       bg0, ba0, vel0.reshape(-1)]).contiguous()
    pre = _stack_pre(pre_const, n - 1)
    poses = torch.cat([pose_R.reshape(n, 9), pose_p], 1).contiguous()
    info = imu_info.reshape(n - 1, 81).contiguous()
    cuda.check_cuda("inertial_gs_lm", state, pre, poses, info, edge_valid)
    if any(x.dtype != f32 for x in (state, pre, poses, info)) \
            or edge_valid.dtype != torch.bool \
            or state.numel() != 16 + 3 * n or pre.shape != (n - 1, 67) \
            or pose_p.shape != (n, 3) or pose_R.shape != (n, 3, 3) \
            or info.shape != (n - 1, 81) or edge_valid.shape != (n - 1,):
        raise ValueError("inertial_gs_lm: shape or dtype mismatch")
    if 9 + 3 * n > 160:
        raise ValueError("inertial_gs_lm: the dense system must fit in "
                         "shared memory (n_kf <= 50)")
    out = torch.empty(16 + 3 * n, dtype=f32, device=dev)
    INERTIAL_GS_LM.launch(
        cuda.ptr(state), cuda.ptr(pre), cuda.ptr(poses), cuda.ptr(info),
        cuda.ptr(edge_valid), n, iters, int(refine), float(gravity),
        float(prior_g), float(prior_a), cuda.ptr(out), cuda.stream())
    return (out[:9].view(3, 3), out[9], out[10:13], out[13:16],
            out[16:].view(n, 3))


def make_inertial_init(gravity: float, n_kf: int, iters: int = 20,
                       prior_g: float = 1e2, prior_a: float = 1e10,
                       plain: bool = False):
    """run(Rwg0 [3,3], vel0 [n_kf,3], pre_const (stacked [n_kf-1, ...]),
    pose_R [n_kf,3,3], pose_p [n_kf,3], imu_info [n_kf-1,9,9], edge_valid
    [n_kf-1]) -> (Rwg, scale, bg, ba, vel): the IMU initialization
    (reference InertialOptimization): gravity direction, scale, shared
    biases and velocities with the poses fixed, bias priors prior_g /
    prior_a, `iters` LM iterations.  CUDA tensors launch
    csrc/inertial_gs_lm.cu; CPU tensors or `plain` run the plain
    version."""
    def run(Rwg0, vel0, pre_const, pose_R, pose_p, imu_info, edge_valid):
        if vel0.shape[0] != n_kf:
            raise ValueError(f"inertial init built for {n_kf} keyframes, "
                             f"called with {vel0.shape[0]}")
        if plain or vel0.device.type == "cpu":
            return inertial_init_plain(gravity, Rwg0, vel0, pre_const,
                                       pose_R, pose_p, imu_info, edge_valid,
                                       iters, prior_g, prior_a)
        z = torch.zeros(3, dtype=torch.float32, device=vel0.device)
        return inertial_gs_lm(gravity, Rwg0, vel0, z, z, pre_const, pose_R,
                              pose_p, imu_info, edge_valid, iters, False,
                              prior_g, prior_a)
    return run


def make_scale_refine(gravity: float, n_kf: int, iters: int = 12,
                      plain: bool = False):
    """run(Rwg0, vel [n_kf,3], bg [3], ba [3], pre_const, pose_R, pose_p,
    imu_info, edge_valid) -> (Rwg, scale): the periodic scale / gravity
    refinement (reference ScaleRefinement), the initialization's edges
    with only the gravity direction and the scale free, `iters` LM
    iterations.  CUDA tensors launch csrc/inertial_gs_lm.cu; CPU tensors
    or `plain` run the plain version."""
    def run(Rwg0, vel, bg, ba, pre_const, pose_R, pose_p, imu_info,
            edge_valid):
        if vel.shape[0] != n_kf:
            raise ValueError(f"scale refinement built for {n_kf} keyframes, "
                             f"called with {vel.shape[0]}")
        if plain or vel.device.type == "cpu":
            return scale_refine_plain(gravity, Rwg0, vel, bg, ba, pre_const,
                                      pose_R, pose_p, imu_info, edge_valid,
                                      iters)
        out = inertial_gs_lm(gravity, Rwg0, vel, bg, ba, pre_const, pose_R,
                             pose_p, imu_info, edge_valid, iters, True)
        return out[0], out[1]
    return run


def inertial_dense_system(t, n_kf: int):
    """(H [15n,15n], g [15n]) float64 of the inertial window as
    csrc/schur_solve.cu assembles them (undamped, before the fill-in) from
    the kernel path's buffers `t` (`_BAWork.t` after `ba_linearize`'s and
    `inertial_chain`'s linearization): the keyframes' visual pose blocks
    and each link's 30x30 block.  For holding the kernels to the plain
    engine's `build_normal_equations`."""
    n = n_kf
    S = 15 * n
    dev = t["hcc"].device
    iu = torch.triu_indices(6, 6, device=dev)
    Hk = torch.zeros(n, 6, 6, dtype=torch.float64, device=dev)
    Hk[:, iu[0], iu[1]] = t["hcc"][:, :21].double()
    Hk[:, iu[1], iu[0]] = t["hcc"][:, :21].double()
    H = torch.zeros(S, S, dtype=torch.float64, device=dev)
    H[:6 * n, :6 * n] = torch.block_diag(*Hk.unbind(0))
    g = torch.zeros(S, dtype=torch.float64, device=dev)
    g[:6 * n] = t["hcc"][:, 21:].double().reshape(-1)
    iu = torch.triu_indices(30, 30, device=dev)
    lk = t["link"][:, :465].double()
    Hl = torch.zeros(n - 1, 30, 30, dtype=torch.float64, device=dev)
    Hl[:, iu[0], iu[1]] = lk
    Hl[:, iu[1], iu[0]] = lk
    ar3 = torch.arange(3, device=dev)
    for i in range(n - 1):
        idx = []
        for k in (i, i + 1):
            idx += [6 * k + torch.arange(6, device=dev)]
            idx += [(6 + 3 * f) * n + 3 * k + ar3 for f in range(3)]
        idx = torch.cat(idx)
        H.index_put_((idx[:, None], idx[None, :]), Hl[i], accumulate=True)
        g.index_put_((idx,), t["link"][i, 465:].double(), accumulate=True)
    return H, g


# --------------------------------------------------------------------------
# Loop closing: the Sim3 reprojection refinement and the essential graph
# --------------------------------------------------------------------------
CHI2_SIM3 = 9.21       # the reference's chi2 gate of the Sim3 edges


def _sim3_reproj_problem(K: PinholeK, cap: int, dmask, consts, mask_f,
                         mask_b):
    X1, uv2, is2_f, X2, uv1, is2_b, Pk, Pc = consts

    def retract(S, d):
        return RES.retract_sim3(S, d * dmask)

    def proj(pc):
        z = torch.clamp_min(pc[2], 1e-4)
        return torch.stack([K.fx * pc[0] / z + K.cx, K.fy * pc[1] / z + K.cy])

    def fwd(blocks, deltas, const):
        Rw, tw, sw = RES.retract_sim3_single(blocks[0], deltas[0] * dmask)
        X2p = sw * (Rw @ const["X"]) + tw
        return proj(const["P"][:, :3] @ X2p + const["P"][:, 3]) - const["uv"]

    def bwd(blocks, deltas, const):
        Rw, tw, sw = RES.retract_sim3_single(blocks[0], deltas[0] * dmask)
        X1p = (Rw.T @ (const["X"] - tw)) / torch.clamp_min(sw, 1e-9)
        return proj(const["P"][:, :3] @ X1p + const["P"][:, 3]) - const["uv"]

    z_idx = torch.zeros(cap, dtype=torch.long, device=X1.device)
    delta = math.sqrt(CHI2_SIM3)
    prob = E.Problem()
    prob.add_dense("sim3", 1, 7, retract)
    prob.add_term(E.Term(name="fwd", res_fn=fwd, rdim=2,
                         dense_refs=[("sim3", z_idx)],
                         const={"X": X1, "uv": uv2,
                                "P": Pc.expand(cap, 3, 4)},
                         mask=mask_f, info=is2_f, robust_delta=delta))
    prob.add_term(E.Term(name="bwd", res_fn=bwd, rdim=2,
                         dense_refs=[("sim3", z_idx)],
                         const={"X": X2, "uv": uv1,
                                "P": Pk.expand(cap, 3, 4)},
                         mask=mask_b, info=is2_b, robust_delta=delta))
    return prob


def sim3_reproj_plain(K: PinholeK, S13, X1, uv2, valid_f, is2_f, X2, uv1,
                      valid_b, is2_b, pose_kf, pose_cand,
                      fix_scale: bool = False, rounds: int = 3,
                      iters: int = 8):
    """Plain version of `sim3_reproj` on the dense engine, in the inputs'
    dtype: `rounds` x `iters` LM iterations on the forward and backward
    edges, each round's masks re-gated on the chi2 at its result.  Returns
    (S13 [13], inlier_f [cap], inlier_b [cap], n int32)."""
    cap = X1.shape[0]
    dmask = torch.ones(7, dtype=S13.dtype, device=S13.device)
    if fix_scale:
        dmask[6] = 0.0
    consts = (X1, uv2, is2_f, X2, uv1, is2_b, pose_kf, pose_cand)
    mask_f, mask_b = valid_f, valid_b
    states = {"sim3": S13[None]}
    for _ in range(rounds):
        prob = _sim3_reproj_problem(K, cap, dmask, consts, mask_f, mask_b)
        states, _, chi2s = E.optimize(prob, states, iters=iters)
        mask_f = valid_f & (chi2s["fwd"] < CHI2_SIM3)
        mask_b = valid_b & (chi2s["bwd"] < CHI2_SIM3)
    return (states["sim3"][0], mask_f, mask_b,
            (mask_f.sum() + mask_b.sum()).to(torch.int32))


SIM3_REPROJ = cuda.Kernel(
    "sim3", "sim3_reproj",
    [_P] * 11 + [_I, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                 ctypes.c_double, _I, _I, _I, _P, _P, _P, _P])


def sim3_reproj(K: PinholeK, S13, X1, uv2, valid_f, is2_f, X2, uv1, valid_b,
                is2_b, pose_kf, pose_cand, fix_scale: bool = False,
                rounds: int = 3, iters: int = 8):
    """The welding similarity S13 [13] (R, t, s; X2 ~ s R X1 + t) refined
    on reprojection edges in both keyframes (the reference's
    OptimizeSim3): forward edges X1 [cap,3] observed at uv2 in the
    candidate keyframe (pose_cand [3,4] T_cw), backward edges X2 observed
    at uv1 in the current one (pose_kf), each with a validity mask and
    its octave information is2.  CPU tensors take the plain version; CUDA
    tensors launch csrc/sim3.cu's `sim3_reproj` (one block, float64)."""
    if S13.device.type == "cpu":
        return sim3_reproj_plain(K, S13, X1, uv2, valid_f, is2_f, X2, uv1,
                                 valid_b, is2_b, pose_kf, pose_cand,
                                 fix_scale, rounds, iters)
    cap = X1.shape[0]
    ts = [S13, X1, uv2, valid_f, is2_f, X2, uv1, valid_b, is2_b,
          pose_kf.contiguous(), pose_cand.contiguous()]
    cuda.check_cuda("sim3_reproj", *ts)
    f32 = torch.float32
    if S13.shape != (13,) or X1.shape != (cap, 3) or X2.shape != (cap, 3) \
            or uv1.shape != (cap, 2) or uv2.shape != (cap, 2) \
            or is2_f.shape != (cap,) or is2_b.shape != (cap,) \
            or valid_f.shape != (cap,) or valid_b.shape != (cap,) \
            or valid_f.dtype != torch.bool or valid_b.dtype != torch.bool \
            or any(t.dtype != f32 for t in (S13, X1, uv2, is2_f, X2, uv1,
                                            is2_b, pose_kf, pose_cand)) \
            or pose_kf.shape != (3, 4) or pose_cand.shape != (3, 4):
        raise ValueError("sim3_reproj: S13 [13], X [cap,3], uv [cap,2], "
                         "valid [cap] bool, is2 [cap], poses [3,4] float32")
    if not 1 <= cap <= 16384:
        raise ValueError("sim3_reproj: 1 <= cap <= 16384")
    dev = S13.device
    out = torch.empty(13, dtype=f32, device=dev)
    masks = torch.empty(2 * cap, dtype=torch.bool, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    SIM3_REPROJ.launch(*(cuda.ptr(t) for t in ts), cap, K.fx, K.fy, K.cx,
                       K.cy, int(fix_scale), rounds, iters, cuda.ptr(out),
                       cuda.ptr(masks), cuda.ptr(n), cuda.stream())
    return out, masks[:cap], masks[cap:], n


def make_sim3_reproj_optimizer(K: PinholeK, cap: int, rounds: int = 3,
                               iters: int = 8, fix_scale: bool = False,
                               plain: bool = False):
    """run(S13 [13], X1 [cap,3], uv2 [cap,2], valid_f, is2_f [cap], X2,
    uv1, valid_b, is2_b, pose_kf [3,4], pose_cand [3,4]) -> (S13,
    inlier_f, inlier_b, n_inliers); `plain` runs the plain version on any
    device."""
    fn = sim3_reproj_plain if plain else sim3_reproj

    def run(S13, X1, uv2, valid_f, is2_f, X2, uv1, valid_b, is2_b, pose_kf,
            pose_cand):
        if X1.shape[0] != cap:
            raise ValueError(f"sim3_reproj: built for cap {cap}")
        return fn(K, S13, X1, uv2, valid_f, is2_f, X2, uv1, valid_b, is2_b,
                  pose_kf, pose_cand, fix_scale, rounds, iters)
    return run


def pose_graph_plain(states13, kf_free, edge_i, edge_j, Rji, tji, sji,
                     edge_valid, edge_info, four_dof: bool = False,
                     iters: int = 15):
    """Plain version of `pose_graph`: the engine's dense LM with the
    Cholesky solve (`Problem()`), in the states' dtype."""
    retract = RES.retract_sim3_4dof if four_dof else RES.retract_sim3
    edge_fn = RES.sim3_edge_4dof if four_dof else RES.sim3_edge
    prob = E.Problem()
    prob.add_dense("sim3", states13.shape[0], 7, retract)
    prob.add_term(E.Term(
        name="sim3", res_fn=edge_fn, rdim=7,
        dense_refs=[("sim3", edge_i.long()), ("sim3", edge_j.long())],
        const={"Rji": Rji, "tji": tji, "sji": sji},
        mask=edge_valid, info=edge_info))
    out, _, _ = E.optimize(prob, {"sim3": states13}, iters=iters,
                           dense_free_mask={"sim3": kf_free})
    return out["sim3"]


def pose_graph_compacted_plain(states13, kf_free, edge_i, edge_j, Rji, tji,
                               sji, edge_valid, edge_info,
                               four_dof: bool = False, iters: int = 15,
                               n_active=None):
    """`pose_graph_plain` on the graph compacted to its first `n_active`
    keyframes and the edges between them (on the tensors' device)."""
    n_kf = states13.shape[0]
    n = n_kf if n_active is None else int(n_active)
    ok = edge_valid & (edge_i < n) & (edge_j < n)
    out = pose_graph_plain(states13[:n], kf_free[:n], edge_i[ok], edge_j[ok],
                           Rji[ok], tji[ok], sji[ok], edge_valid[ok],
                           edge_info[ok], four_dof, iters)
    return out if n == n_kf else torch.cat([out, states13[n:]], 0)


POSE_GRAPH = cuda.Kernel("pose_graph", "pose_graph",
                         [_P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                          _I, _I, _I, _I, _P, _P, _P, _P, _P])
# launches whose normal matrix's factor did not fit shared memory: path 1
# of `pg_path` (one block streams it) and path 2 (the whole grid on it)
POSE_GRAPH.global_launches = 0
POSE_GRAPH.grid_launches = 0
# csrc/pose_graph.cu: (kSmemMax - kStaticSmem) / 8 doubles of dynamic
# shared memory, the streamed path's staging buffers (kNBuf x kChunk
# doubles) and the least window of 7x7 blocks (kMinCap) beside which the
# pattern's tables stay there
PG_SMEM_DOUBLES = (232448 - 256) // 8
PG_STAGE = 5 * 512
PG_MIN_CAP = 96
# block updates a level of the elimination tree from which the whole grid
# factors (path 2): a grid barrier costs about what block 0 alone takes
# for this many updates
PG_GRID_UPDATES = 20


def graph_tables(edge_i: np.ndarray, edge_j: np.ndarray, n: int):
    """The fixed summation order of the normal matrix's blocks: each
    keyframe's incident edges (CSR, 2 e + side) and each keyframe pair's
    edges (a < b; 2 e + flip), in edge order."""
    ei, ej = np.asarray(edge_i, np.int64), np.asarray(edge_j, np.int64)
    E_ = len(ei)
    node = np.concatenate([ei, ej])
    code = np.concatenate([2 * np.arange(E_), 2 * np.arange(E_) + 1])
    order = np.lexsort((code, node))
    inc = code[order].astype(np.int32)
    inc_ptr = np.searchsorted(node[order], np.arange(n + 1)).astype(np.int32)
    a, b = np.minimum(ei, ej), np.maximum(ei, ej)
    key = a * n + b
    order = np.lexsort((np.arange(E_), key))
    uk, start = np.unique(key[order], return_index=True)
    pair_ab = np.stack([uk // n, uk % n], 1).astype(np.int32)
    pair_ptr = np.append(start, E_).astype(np.int32)
    pair_list = (2 * order + (ei[order] > ej[order])).astype(np.int32)
    return inc_ptr, inc, pair_ab, pair_ptr, pair_list


def pg_symbolic(pairs: np.ndarray, n: int):
    """The symbolic Cholesky of a symmetric block pattern over n block
    columns: `pairs` [P,2] the off-diagonal blocks (a, b), a != b.  Returns
    (struct, parent, level): struct[j] the sorted rows i > j of L's
    nonzero blocks in column j, fill included; parent the elimination
    tree (-1 at a root); level 0 at the leaves, 1 + the highest child's
    above them."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    low = [set() for _ in range(n)]
    for a, b in zip(pairs.min(1).tolist(), pairs.max(1).tolist()):
        low[a].add(b)
    parent = [-1] * n
    level = [0] * n
    for j in range(n):
        if low[j]:
            p = min(low[j])
            parent[j] = p
            low[p] |= low[j]
            low[p].discard(p)
            level[p] = max(level[p], level[j] + 1)
    return ([sorted(s) for s in low], np.asarray(parent, np.int64),
            np.asarray(level, np.int64))


def pg_pattern(edge_i: np.ndarray, edge_j: np.ndarray, kf_free: np.ndarray,
               n: int, pair_ab: np.ndarray = None) -> dict:
    """The fill pattern and the schedule that csrc/pose_graph.cu walks, for
    the essential graph's normal matrix over n keyframes with 7x7 blocks.

    The off-diagonal blocks are the keyframe pairs that an edge joins
    between two free keyframes (a fixed keyframe's row and column are
    zero but for its unit diagonal).  `pg_symbolic` gives the elimination
    tree and L's nonzero blocks, fill included.  The kernel factors the
    columns level by level (a topological order of the tree, so the fill is
    the same; columns of one level are independent and run side by side):
    kernel column k holds keyframe `col_kf[k]`.  Each column's blocks are
    stored diagonal first, the rows below ascending, then the border: one
    more block row (index n) whose first row carries the right-hand side,
    so that the forward solve runs as part of the factorization.

    The schedule: for each level, every target block that the level's
    columns update, L_ij -= sum_k L_ik L_jk^T over the level's columns k
    in ascending order, with i, j in column k's structure (or i the
    border), j not the border; a diagonal target's upper triangle is not
    used.  A level's targets in the next level's columns come first
    (`lvl_mid` starts the rest).  Returns a dict of numpy arrays (int32
    unless named): colptr [n+1], rowidx [nb], bcol [nb], bsrc [nb] (-1
    diagonal, -2 border, -3 fill, else 2 p + t for the edges of keyframe
    pair p of `pair_ab`, t = 1 where the block stores the pair's (smaller,
    larger) side), col_kf [n], kf_col [n], lvl_col [levels+1], lvl_tgt
    [levels+1], lvl_mid [levels], tgt [T], tgt_ptr [T+1], src [U,2]; and
    struct (list, kernel order), parent (int64, keyframe order), level,
    nb, n_updates."""
    ei = np.asarray(edge_i, np.int64)
    ej = np.asarray(edge_j, np.int64)
    free = np.asarray(kf_free, bool)[:n]
    keep = (ei != ej) & free[ei] & free[ej]
    a, b = np.minimum(ei, ej)[keep], np.maximum(ei, ej)[keep]
    struct, parent, level = pg_symbolic(np.stack([a, b], 1), n)
    col_kf = np.lexsort((np.arange(n), level))
    kf_col = np.empty(n, np.int64)
    kf_col[col_kf] = np.arange(n)
    level_k = level
    if (col_kf != np.arange(n)).any():
        struct, _, level_k = pg_symbolic(
            np.stack([kf_col[a], kf_col[b]], 1), n)
    # column k: the diagonal, the rows below, the border
    counts = np.array([len(s) + 2 for s in struct], np.int64)
    colptr = np.concatenate([[0], np.cumsum(counts)])
    nb = int(colptr[-1])
    rows = []
    for k, s in enumerate(struct):
        rows += [k, *s, n]
    rowidx = np.asarray(rows, np.int64)
    bcol = np.repeat(np.arange(n), counts)
    bsrc = np.full(nb, -3, np.int64)
    bsrc[colptr[:-1]] = -1
    bsrc[colptr[1:] - 1] = -2
    if pair_ab is None:
        pair_ab = graph_tables(ei, ej, n)[2]
    pair_ab = np.asarray(pair_ab, np.int64).reshape(-1, 2)
    blk_of = np.full((n + 1, n), -1, np.int64)
    blk_of[rowidx, bcol] = np.arange(nb)
    if len(pair_ab):
        ra, rb = kf_col[pair_ab[:, 0]], kf_col[pair_ab[:, 1]]
        ok = free[pair_ab[:, 0]] & free[pair_ab[:, 1]]
        flip = (ra > rb).astype(np.int64)       # row on the smaller side
        blk = blk_of[np.maximum(ra, rb), np.minimum(ra, rb)]
        assert (blk[ok] >= 0).all()
        bsrc[blk[ok]] = 2 * np.nonzero(ok)[0] + flip[ok]
    # every update: blocks x >= y below the diagonal of one column, y not
    # the border, target (row x, row y)
    below = np.nonzero(bsrc != -1)[0]
    pos = below - colptr[bcol[below]] - 1
    X = np.repeat(below, pos + 1)
    first = np.repeat(colptr[bcol[below]] + 1, pos + 1)
    start = np.repeat(np.cumsum(pos + 1) - (pos + 1), pos + 1)
    Y = first + np.arange(len(X)) - start
    ok = rowidx[Y] != n
    X, Y = X[ok], Y[ok]
    T_ = blk_of[rowidx[X], rowidx[Y]]
    assert (T_ >= 0).all()
    lv = level_k[bcol[X]]
    # a level's targets in the next level's columns first: the kernel
    # applies the rest while it factors the next level
    key = 2 * lv + (level_k[bcol[T_]] > lv + 1)
    order = np.lexsort((bcol[X], T_, key))
    X, Y, T_, key = X[order], Y[order], T_[order], key[order]
    new = np.ones(len(T_), bool)
    new[1:] = (T_[1:] != T_[:-1]) | (key[1:] != key[:-1])
    tgt = T_[new]
    tgt_ptr = np.append(np.nonzero(new)[0], len(T_))
    assert (np.diff(level_k) >= 0).all()
    n_lvl = int(level_k.max()) + 1
    lvl_col = np.searchsorted(level_k, np.arange(n_lvl + 1))
    lvl_tgt = np.searchsorted(key[new], 2 * np.arange(n_lvl + 1))
    lvl_mid = np.searchsorted(key[new], 2 * np.arange(n_lvl) + 1)
    i32 = np.int32
    return dict(colptr=colptr.astype(i32), rowidx=rowidx.astype(i32),
                bcol=bcol.astype(i32), bsrc=bsrc.astype(i32),
                col_kf=col_kf.astype(i32), kf_col=kf_col.astype(i32),
                lvl_col=lvl_col.astype(i32), lvl_tgt=lvl_tgt.astype(i32),
                lvl_mid=lvl_mid.astype(i32),
                tgt=tgt.astype(i32), tgt_ptr=tgt_ptr.astype(i32),
                src=np.stack([X, Y], 1).astype(i32), struct=struct,
                parent=parent, level=level_k, nb=nb, n_updates=len(X))


def pg_resident(pat: dict) -> bool:
    """Whether csrc/pose_graph.cu keeps the whole factor of `pg_pattern`'s
    pattern in shared memory (path 0) or streams its blocks through a
    window there (path 1): beside the solution and a partial (14 n
    doubles) and the pattern's tables (where they leave room for
    PG_MIN_CAP blocks), 49 doubles a block."""
    n, nb = len(pat["colptr"]) - 1, pat["nb"]
    meta = (len(pat["colptr"]) + len(pat["rowidx"]) + len(pat["bcol"])
            + len(pat["lvl_col"]) + len(pat["lvl_tgt"]) + len(pat["lvl_mid"])
            + len(pat["tgt"]) + len(pat["tgt_ptr"]) + pat["src"].size
            + 1) // 2
    if 14 * n + meta + PG_STAGE + 49 * PG_MIN_CAP > PG_SMEM_DOUBLES:
        meta = 0
    return 49 * nb <= PG_SMEM_DOUBLES - 14 * n - meta


def pg_path(pat: dict) -> int:
    """The path csrc/pose_graph.cu takes for `pg_pattern`'s pattern: 0 the
    factor resident in block 0's shared memory (`pg_resident`); else 2, the
    whole grid on the factor in global memory, where the fill gives a level
    of the elimination tree PG_GRID_UPDATES block updates or more on
    average (a graph whose long-range edges fill the factor), and 1, block 0
    streaming the factor through shared memory (a band: the chains)."""
    if pg_resident(pat):
        return 0
    n_lvl = len(pat["lvl_col"]) - 1
    return 2 if pat["n_updates"] >= PG_GRID_UPDATES * n_lvl else 1


_PG_TABLES = ("inc_ptr", "inc", "pair_ptr", "pair_list", "colptr", "rowidx",
              "bcol", "bsrc", "col_kf", "kf_col", "lvl_col", "lvl_tgt",
              "lvl_mid", "tgt", "tgt_ptr", "src")


def pose_graph(states13, kf_free, edge_i, edge_j, Rji, tji, sji, edge_valid,
               edge_info, four_dof: bool = False, iters: int = 15,
               n_active=None, stats: dict = None, profile: bool = False,
               path: int = None):
    """Essential-graph LM over Sim(3) keyframe states [n_kf,13] (R, t, s;
    kf_free [n_kf]) and relative-similarity edges (edge_i / edge_j
    [n_edges], Rji [n_edges,3,3], tji [n_edges,3], sji, edge_valid,
    edge_info [n_edges]), compacted to its first `n_active` keyframes (the
    rest fixed and unreferenced by valid edges; default all) and its valid
    edges, which gives the same solve: the reference's padding slots are
    fixed, so their rows decouple with a unit diagonal, and masked edges
    add nothing.  CPU tensors take the plain version; CUDA tensors launch
    csrc/pose_graph.cu once for all `iters` iterations, with the block
    pattern of `pg_pattern`, on the path `pg_path` chooses (or `path`,
    where given: the same solve on another path, for measurement); `stats`,
    where given, gets "path" (the path the launch reported, a device
    tensor), "want" (the path asked for), "S", "nb" (the
    factor's 7x7 blocks, border included), "n_updates" and, with
    `profile`, "phases_ns" (int64 [5], a device tensor: the kernel's
    nanoseconds in linearize, assemble, forward, backward, update and
    cost, summed over the iterations).  Returns the states [n_kf,13]."""
    n_kf = states13.shape[0]
    n = n_kf if n_active is None else int(n_active)
    if states13.device.type == "cpu":
        return pose_graph_compacted_plain(
            states13, kf_free, edge_i, edge_j, Rji, tji, sji, edge_valid,
            edge_info, four_dof, iters, n_active)
    dev = states13.device
    cuda.check_cuda("pose_graph", states13, kf_free, edge_i, edge_j, Rji,
                    tji, sji, edge_valid, edge_info)
    if states13.dtype != torch.float32 or states13.shape != (n_kf, 13) \
            or not 1 <= n <= n_kf:
        raise ValueError("pose_graph: states [n_kf,13] float32, 1 <= "
                         "n_active <= n_kf")
    if Rji.dtype != torch.float32 or tji.dtype != torch.float32 \
            or sji.dtype != torch.float32 or edge_info.dtype != torch.float32:
        raise ValueError("pose_graph: edge measurements float32")
    # the graph's integers to the host in one read
    ins = (edge_valid, edge_i, edge_j, kf_free[:n])
    raw = torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                     for t in ins]).cpu().numpy()
    got, at = [], 0
    for t in ins:
        nbytes = t.numel() * t.element_size()
        got.append(raw[at:at + nbytes].view(
            np.dtype(str(t.dtype).replace("torch.", ""))))
        at += nbytes
    ok, free_np = got[0], got[3]
    ei, ej = got[1][ok], got[2][ok]
    if len(ei) and (max(ei.max(), ej.max()) >= n or (ei == ej).any()):
        raise ValueError("pose_graph: valid edges join two distinct active "
                         "keyframes")
    if 14 * n + PG_STAGE + 49 * PG_MIN_CAP > PG_SMEM_DOUBLES:
        raise ValueError("pose_graph: at most 1554 active keyframes (the "
                         "solution's shared memory)")
    inc_ptr, inc, pair_ab, pair_ptr, pair_list = graph_tables(ei, ej, n)
    pat = pg_pattern(ei, ej, free_np, n, pair_ab)
    want = pg_path(pat) if path is None else int(path)
    if want not in (0, 1, 2) or want == 0 and not pg_resident(pat):
        raise ValueError(f"pose_graph: path {want} (0 only where the factor "
                         "fits shared memory, 1, 2)")
    # every table in one upload; the kernel reads the edges' measurements
    # in their padded slots (`sel`, the valid edges' slots)
    tabs = dict(inc_ptr=inc_ptr, inc=inc, pair_ptr=pair_ptr,
                pair_list=pair_list, ei=ei, ej=ej, sel=np.nonzero(ok)[0],
                **pat)
    parts = [np.asarray(tabs[k], np.int32).reshape(-1)
             for k in ("ei", "ej", "sel") + _PG_TABLES]
    offs = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    ints = torch.from_numpy(np.concatenate(parts)).to(dev)
    E_, nb, S = len(ei), pat["nb"], 7 * n
    work = torch.empty(26 * n + 105 * E_ + 49 * nb + S + 1024,
                       dtype=torch.float64, device=dev)
    st = states13[:n].contiguous()
    free = kf_free[:n].contiguous()
    out = torch.empty_like(st)
    taken = torch.empty((), dtype=torch.int32, device=dev)
    prof = torch.zeros(5, dtype=torch.int64, device=dev) if profile \
        else None
    offs_c = (ctypes.c_int * len(offs))(*offs.tolist())
    POSE_GRAPH.launch(
        cuda.ptr(st), cuda.ptr(free), n, cuda.ptr(Rji), cuda.ptr(tji),
        cuda.ptr(sji), cuda.ptr(edge_info), cuda.ptr(ints), E_,
        ctypes.cast(offs_c, ctypes.c_void_p), nb, len(pat["lvl_col"]) - 1,
        len(pat["tgt"]), pat["n_updates"], int(four_dof), iters, want,
        cuda.ptr(work), cuda.ptr(out), cuda.ptr(taken),
        None if prof is None else cuda.ptr(prof), cuda.stream())
    if want == 1:
        POSE_GRAPH.global_launches += 1
    elif want == 2:
        POSE_GRAPH.grid_launches += 1
    if stats is not None:
        stats.update(path=taken, want=want, S=S, nb=nb,
                     n_updates=pat["n_updates"], phases_ns=prof)
    if n == n_kf:
        return out
    return torch.cat([out, states13[n:]], 0)


def make_pose_graph_optimizer(n_kf: int, n_edges: int, iters: int = 15,
                              four_dof: bool = False, plain: bool = False):
    """run(sim3_states [n_kf,13], kf_free [n_kf], edge_i, edge_j,
    edge_Rji [n_edges,3,3], edge_tji [n_edges,3], edge_sji, edge_valid,
    edge_info [n_edges], n_active=None) -> sim3_states: Sim(3) (or, with
    four_dof, translation + yaw) essential-graph optimization; `plain`
    runs the plain version on any device."""
    def run(states13, kf_free, edge_i, edge_j, Rji, tji, sji, edge_valid,
            edge_info, n_active=None):
        if states13.shape[0] != n_kf or edge_i.shape[0] != n_edges:
            raise ValueError(f"pose_graph: built for {n_kf} keyframes and "
                             f"{n_edges} edges")
        if plain:
            return pose_graph_compacted_plain(
                states13, kf_free, edge_i, edge_j, Rji, tji, sji, edge_valid,
                edge_info, four_dof, iters, n_active)
        return pose_graph(states13, kf_free, edge_i, edge_j, Rji, tji, sji,
                          edge_valid, edge_info, four_dof, iters, n_active)
    return run


def _f64(ts):
    return [t.double() if t.is_floating_point() else t for t in ts]


def pose_graph_against_float64(args, four_dof: bool = False,
                               n_active=None, iters: int = 15,
                               path: int = None) -> dict:
    """`pose_graph` on the card against its plain version on the same
    device in float32 and in float64, on the graph `args` (the arguments
    of `make_pose_graph_optimizer`'s run, CUDA tensors), launched twice
    (on `path`, where given, else `pg_path`'s).  Returns dict(S, path,
    want, nb, n_updates, same_bits, kernel,
    plain, kernel_plain, step, failures): the largest state gaps to
    float64 of the kernel and of the plain float32 run, and between them.
    The rule (chip_smoke.py and the card test): the kernel within 2x the
    plain float32 run's distance to float64 + 1e-6, the same bits on the
    second launch."""
    st = {}
    k = pose_graph(*args, four_dof=four_dof, iters=iters, n_active=n_active,
                   stats=st, path=path)
    k2 = pose_graph(*args, four_dof=four_dof, iters=iters, n_active=n_active,
                    path=path)
    p = pose_graph_compacted_plain(*args, four_dof=four_dof, iters=iters,
                                   n_active=n_active).cpu()
    p64 = pose_graph_compacted_plain(*_f64(args), four_dof=four_dof,
                                     iters=iters, n_active=n_active).cpu()
    n = args[0].shape[0] if n_active is None else n_active
    kd, pd = k[:n].double().cpu(), p[:n].double()
    out = dict(S=st["S"], path=int(st["path"]), nb=st["nb"],
               want=st["want"], n_updates=st["n_updates"],
               same_bits=bool(torch.equal(k, k2)),
               kernel=float((kd - p64[:n]).abs().max()),
               plain=float((pd - p64[:n]).abs().max()),
               kernel_plain=float((kd - pd).abs().max()),
               step=float((p64[:n] - args[0][:n].double().cpu()).abs()
                          .max()))
    fail = []
    if not out["same_bits"]:
        fail.append("a second launch gave other bits")
    if out["kernel"] > 2 * out["plain"] + 1e-6:
        fail.append(f"kernel {out['kernel']:.2e} from float64 > 2x the "
                    f"plain float32 run's {out['plain']:.2e} + 1e-6")
    out["failures"] = fail
    return out


def sim3_reproj_against_float64(K: PinholeK, args,
                                fix_scale: bool = False) -> dict:
    """`sim3_reproj` on the card against its plain version in float32 and
    float64 on the CPU (args: CUDA tensors), launched twice; the rule of
    `pose_graph_against_float64` and the inlier count equal to the float64
    run's.  Returns dict(kernel, plain, same_bits, n, n64, failures)."""
    k = sim3_reproj(K, *args, fix_scale=fix_scale)
    k2 = sim3_reproj(K, *args, fix_scale=fix_scale)
    cpu = [a.cpu() for a in args]
    p = sim3_reproj_plain(K, *cpu, fix_scale=fix_scale)
    p64 = sim3_reproj_plain(K, *_f64(cpu), fix_scale=fix_scale)
    out = dict(kernel=float((k[0].double().cpu() - p64[0]).abs().max()),
               plain=float((p[0].double() - p64[0]).abs().max()),
               same_bits=bool(torch.equal(k[0], k2[0])),
               n=int(k[3]), n64=int(p64[3]))
    fail = []
    if not out["same_bits"]:
        fail.append("a second launch gave other bits")
    if out["n"] != out["n64"]:
        fail.append(f"inliers {out['n']} != {out['n64']}")
    if out["kernel"] > 2 * out["plain"] + 1e-6:
        fail.append(f"S13 {out['kernel']:.2e} from float64 > 2x the plain "
                    f"run's {out['plain']:.2e} + 1e-6")
    out["failures"] = fail
    return out


def _to64_cpu(x):
    if isinstance(x, (list, tuple)):
        return [_to64_cpu(v) for v in x]
    if isinstance(x, dict):
        return {k: _to64_cpu(v) for k, v in x.items()}
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return x.double() if x.is_floating_point() else x
    return x


FLOAT32_ORDERS = 4      # row orders of the plain float32 runs


def _cpu(x):
    if isinstance(x, (list, tuple)):
        return [_cpu(v) for v in x]
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x.detach().cpu() if torch.is_tensor(x) else x


def pose_irls_against_float64(K: PinholeK, args, ur=None,
                              bf: float = 0.0) -> dict:
    """`pose_irls` (args: its CUDA tensors after K, the point rows uv, X,
    valid, is2 second to fifth; the stereo rows with ur and bf) against
    float64, `against_float64`'s rule on the pose."""
    return against_float64(
        lambda *a, **k: pose_irls(K, *a, **k),
        lambda *a, **k: pose_irls_plain(K, *a, **k), args, (0,),
        rows=((1, 2, 3, 4),), kw=dict(ur=ur, bf=bf), n_idx=3)


def pose_lm_against_float64(args, kb8: bool) -> dict:
    """`pose_lm` (args: K, bf, then the stereo LM's CUDA tensors pose0,
    uvr, X, valid, is2; with kb8: K8, then pose0, uv, X, valid, is2)
    against float64 runs of its plain version, `against_float64`'s rule on
    the pose."""
    if kb8:
        K8, rest = args[0], list(args[1:])
        return against_float64(
            lambda *a: kb8_pose_lm(K8, *a),
            lambda *a: kb8_pose_lm_plain(K8, *a), rest, (0,),
            rows=((1, 2, 3, 4),), n_idx=2)
    K, bf, rest = args[0], args[1], list(args[2:])
    return against_float64(
        lambda *a: stereo_pose_lm(K, bf, *a),
        lambda *a: stereo_pose_lm_plain(K, bf, *a), rest, (0,),
        rows=((1, 2, 3, 4),), n_idx=2)


def vi_pose_lm_against_float64(K: PinholeK, args, have_prior: bool,
                               ur=None, bf: float = 0.0) -> dict:
    """`vi_pose_lm` (args: Rcb, tcb, gravity and its CUDA tensors up to
    prior_info, the point rows uv, X, valid, is2 at 7-10; the stereo term
    with ur and bf) against float64, `against_float64`'s rule on the pose,
    velocity and biases."""
    return against_float64(
        lambda *a, **k: vi_pose_lm(K, *a, have_prior, **k),
        lambda *a, **k: vi_pose_opt_plain(K, *a, have_prior, **k), args,
        (0, 1, 2, 3), rows=((7, 8, 9, 10),), kw=dict(ur=ur, bf=bf),
        n_idx=5)


def line_pose_lm_against_float64(K: PinholeK, mode: int, args) -> dict:
    """`pose_lm`'s line family of SLAM mode 1, 2 or 3 (args: its CUDA
    tensors pose0, l_obs, dir_obs, Xs, Xe, valid, is2) against float64
    runs of its plain version, `against_float64`'s rule on the pose."""
    return against_float64(
        lambda *a: line_only_pose_lm(K, mode, *a),
        lambda *a: line_only_pose_lm_plain(K, mode, *a), list(args), (0,),
        rows=((1, 2, 3, 4, 5, 6),), n_idx=2)


def against_float64(kernel_fn, plain_fn, args, state_idx, rows=(),
                    kw=None, n_idx=None, launches: int = 3) -> dict:
    """A solver's kernel path on the card against its plain version in
    float32 and in float64 on the CPU (args, kw: the CUDA tensors and
    options of both): the largest entry gaps to float64 of the outputs
    `state_idx` (a pose, keyframe states, landmarks), of the kernel and of
    the plain float32 runs.  The kernel sums its rows in another order
    than the plain version, and on an ill-conditioned problem (a weakly
    observed bias under a carried prior; 120 CG steps of a window) float32
    rounding alone moves the state by several times one run's distance,
    so the plain version runs on FLOAT32_ORDERS row orders: the given one
    and seeded permutations of each group of per-row arguments in `rows`
    (tuples of argument indices permuted together; kw's `ur` with the
    first group).  The rule: the kernel within 2x the plain runs' largest
    distance + 1e-6, the same bits on every one of `launches` launches,
    and where `n_idx` names the inlier count among the outputs, the
    kernel's within max(2, 1%) of the float64 run's.  Returns dict(kernel,
    plain, plain_orders, kernel_plain (the largest kernel - plain float32
    gap, given order), same_bits, n, n64 (None without n_idx), failures,
    out)."""
    kw = kw or {}
    ks = [kernel_fn(*args, **kw) for _ in range(launches)]
    a32, kw32 = _cpu(list(args)), _cpu(kw)
    p32 = plain_fn(*a32, **kw32)
    p64 = plain_fn(*_to64_cpu(list(args)), **_to64_cpu(kw))

    def gap(a, b):
        return max(float((a[i].detach().cpu().double() - b[i].double())
                         .abs().max()) for i in state_idx)
    orders = [gap(p32, p64)]
    for o in range(1, FLOAT32_ORDERS if rows else 1):
        a, kk = list(a32), dict(kw32)
        for g, group in enumerate(rows):
            perm = torch.from_numpy(np.random.default_rng(
                [o, g]).permutation(a32[group[0]].shape[0]))
            for i in group:
                a[i] = a32[i][perm].contiguous()
            if g == 0 and kk.get("ur") is not None:
                kk["ur"] = kw32["ur"][perm].contiguous()
        orders.append(gap(plain_fn(*a, **kk), p64))
    out = dict(kernel=gap(ks[0], p64), plain=max(orders), plain_orders=orders,
               kernel_plain=gap(ks[0], p32),
               same_bits=all(torch.equal(k[i], ks[0][i]) for k in ks[1:]
                             for i in state_idx),
               n=None if n_idx is None else int(ks[0][n_idx]),
               n64=None if n_idx is None else int(p64[n_idx]), out=ks[0])
    fail = []
    if not out["same_bits"]:
        fail.append("another launch gave other bits")
    if n_idx is not None and abs(out["n"] - out["n64"]) > max(
            2, 0.01 * out["n64"]):
        fail.append(f"inliers {out['n']} against {out['n64']}")
    if out["kernel"] > 2 * out["plain"] + 1e-6:
        fail.append(f"state {out['kernel']:.2e} from float64 > 2x the plain "
                    f"float32 runs' {out['plain']:.2e} + 1e-6")
    out["failures"] = fail
    return out


def unpack_sym(packed, d: int):
    """[..., d(d+1)/2] upper triangles (row by row) -> [..., d, d]."""
    iu = torch.triu_indices(d, d, device=packed.device)
    out = packed.new_zeros(*packed.shape[:-1], d, d)
    out[..., iu[0], iu[1]] = packed
    out[..., iu[1], iu[0]] = packed
    return out


def rel_err(a, b) -> float:
    """The largest entry gap of a to b, relative to b's largest entry."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def schur_dense_operand(w: "_BAWork") -> torch.Tensor:
    """The fill-in's dense operand Gm [6 n_kf, 3 n_pt + 6 n_ln] of the last
    `schur_solve` launch on `w`, assembled from its per-observation
    factors G_o = W_o F (t["gpt"], t["gln"]) at the window's valid
    observations: each G_o added at its keyframe's rows and its landmark's
    columns, so that Gm Gm^T is the fill-in in the engine's Gram form
    (solver/engine.py `_schur_reduce`).  For checking the kernel's
    fill-in."""
    t = w.t
    n_kf, n_pt = t["hcc"].shape[0], t["pts"].shape[0]
    dev = t["ff"].device
    gm = torch.zeros(6 * n_kf, 3 * n_pt + 6 * t["lns"].shape[0],
                     device=dev)
    for G, okf, olm, ok, D, c0 in (
            (t["gpt"], "obs_kf", "obs_pt", "obs_valid", 3, 0),
            (t["gln"], "lobs_kf", "lobs_ln", "lobs_valid", 6, 3 * n_pt)):
        n = t[okf].shape[0]
        if n == 0:
            continue
        rows = t[okf].long()[:, None, None] * 6 \
            + torch.arange(6, device=dev)[None, :, None]
        cols = c0 + t[olm].long()[:, None, None] * D \
            + torch.arange(D, device=dev)[None, None, :]
        g = G[:n].view(n, 6, D) * t[ok][:, None, None]
        gm.index_put_((rows.expand(n, 6, D), cols.expand(n, 6, D)), g,
                      accumulate=True)
    return gm


def linearization_against_plain(w: "_BAWork", prob, st) -> dict:
    """One linearization of a window BA's kernel path (`w`, with its
    inertial chain's cost state set where it has one) against the plain
    engine's normal equations of the same visual terms (`prob` at the
    states `st`, on the window's masks): the largest entry gaps, relative
    to the plain block's largest entry, of the keyframes' pose blocks and
    gradient, and per landmark family of its Hpp, gp and the couplings B
    (the per-observation blocks summed per keyframe and landmark).
    Returns {name: gap}."""
    w.linearize(BA_MODE_INIT)
    w.linearize(BA_MODE_LINEARIZE)
    t = w.t
    n_kf = t["hcc"].shape[0]
    S6 = 6 * n_kf
    _, H, g, lm_sys, _, _ = prob.build_normal_equations(st)
    Hk = torch.block_diag(*unpack_sym(t["hcc"][:, :21], 6).unbind(0))
    errs = {"pose blocks": rel_err(Hk, H[:S6, :S6]),
            "g": rel_err(t["hcc"][:, 21:].reshape(-1), g[:S6])}
    for fam, d, hkey, wkey, okf, olm in (
            ("pt", 3, "hpt", "p_w", "obs_kf", "obs_pt"),
            ("ln", 6, "hln", "l_w", "lobs_kf", "lobs_ln")):
        if fam not in lm_sys:
            continue
        Hpp, gp, Bp = lm_sys[fam]
        n = Hpp.shape[0]
        nt = d * (d + 1) // 2
        errs[f"Hpp {fam}"] = rel_err(unpack_sym(t[hkey][:n, :nt], d), Hpp)
        errs[f"gp {fam}"] = rel_err(t[hkey][:n, nt:nt + d], gp)
        n_o = t[okf].shape[0]
        Bk = torch.zeros(n_kf, n, 6, d, dtype=torch.float64, device=H.device)
        Bk.index_put_((t[okf].long(), t[olm].long()),
                      t[wkey][:n_o].double().view(-1, 6, d), accumulate=True)
        errs[f"B {fam}"] = rel_err(Bk.permute(0, 2, 1, 3).reshape(S6, -1),
                                    Bp[:S6].double())
    return errs


# the per-observation argument groups of the window BAs' argument lists
# (against_float64's `rows`): the point and line observations of
# local_ba_pl / local_inertial_ba, the line observations of
# local_ba_lines_only
BA_ROWS = ((4, 5, 6, 7, 8), (11, 12, 13, 14, 15))
LIBA_ROWS = ((8, 9, 10, 11, 12), (20, 21, 22, 23))
LINES_ONLY_ROWS = ((4, 5, 6, 7, 8, 9),)


# --------------------------------------------------------------------------
# The sharded step of the landmark-sharded and chained window BAs
# (plvio_tpu_torch/parallel/): one shard's partial reduced system, then the
# mesh's sum, its solve and each shard's back-substitution
# --------------------------------------------------------------------------

SCHUR_REDUCE = cuda.Kernel("schur_solve", "schur_reduce",
                           [_P, _P, _P, _P, _P, _I, _P])
_SSR_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P]
# the same entry in its two solves, counted apart: CG (dist_liba) and
# Cholesky (dist_ba, chain_ba)
SCHUR_SOLVE_REDUCED_CG = cuda.Kernel("schur_solve", "schur_solve_reduced",
                                     _SSR_ARGS)
SCHUR_SOLVE_REDUCED_CHOL = cuda.Kernel("schur_solve", "schur_solve_reduced",
                                       _SSR_ARGS)
SCHUR_SOLVE_REDUCED_CG.global_launches = 0
CHOL_MAX_S = 240     # csrc/schur_solve.cu chol_kernel: S x S + 2 S floats


def _system_bufs(w: "_BAWork", h: str, r: str):
    """A reduced system's buffers [S, S] and [S] in w's table under the
    names h and r (made at first use)."""
    t = w.t
    if h not in t:
        t[h] = torch.zeros(w.S, w.S, dtype=torch.float32, device=w.device)
        t[r] = torch.zeros(w.S, dtype=torch.float32, device=w.device)
    return t[h], t[r]


def schur_reduce(w: "_BAWork", raw: bool = False):
    """One shard's partial reduced system (csrc/schur_solve.cu
    `schur_reduce`) after its linearization: (H [S,S], rhs [S]) in the
    shard's buffers, in engine mode damped by the shard's own diagonal and
    its fixed rows frozen, in raw mode neither (the plain version:
    `solver/engine.Problem.reduce_system` on the shard's problem, engine
    mode; `parallel/dist_ba.local_reduce_plain`, raw mode)."""
    H, rhs = _system_bufs(w, "hred", "rred")
    with torch.cuda.device(w.device):
        SCHUR_REDUCE.launch(*w.args, cuda.ptr(H), cuda.ptr(rhs), int(raw),
                            cuda.stream())
    return H, rhs


def schur_solve_reduced(works, parts, mesh=None, raw: bool = False,
                        chol: bool = False) -> None:
    """The sharded step after the shards' reductions (csrc/schur_solve.cu
    `schur_solve_reduced`): the partials `parts` [(H_d, rhs_d)] of the
    local shards `works` summed in shard order on the first shard's
    device (partials on another device copied there first), all-reduced
    across the mesh's processes where it has several, solved there (CG, or
    with `chol` Cholesky; `raw` damps and freezes the sum first) into the
    first shard's dx, and every shard back-substituted and retracted with
    it into its candidate state.  One launch counted a call."""
    kern = SCHUR_SOLVE_REDUCED_CHOL if chol else SCHUR_SOLVE_REDUCED_CG
    w0 = works[0]
    if chol and w0.S > CHOL_MAX_S:
        raise ValueError(f"schur_solve_reduced: Cholesky takes S <= "
                         f"{CHOL_MAX_S}, not {w0.S}")
    hs = [h if h.device == w0.device else h.to(w0.device) for h, _ in parts]
    rs = [r if r.device == w0.device else r.to(w0.device) for _, r in parts]
    n = len(hs)
    hp = (ctypes.c_void_p * n)(*[h.data_ptr() for h in hs])
    rp = (ctypes.c_void_p * n)(*[r.data_ptr() for r in rs])
    H, rhs = _system_bufs(w0, "hsum", "rsum")
    none = ctypes.c_void_p(0)
    with torch.cuda.device(w0.device):
        kern.launch(*w0.args, ctypes.cast(hp, ctypes.c_void_p),
                    ctypes.cast(rp, ctypes.c_void_p), n, cuda.ptr(H),
                    cuda.ptr(rhs), 0, int(raw), int(chol), cuda.stream(),
                    kernels=0)
        if mesh is not None and mesh.world > 1:
            mesh._all_reduce(H)
            mesh._all_reduce(rhs)
        kern.launch(*w0.args, none, none, 0, cuda.ptr(H), cuda.ptr(rhs), 1,
                    int(raw), int(chol), cuda.stream())
    if not chol:
        SCHUR_SOLVE_REDUCED_CG.global_launches += w0.solve_path()
    for w in works[1:]:
        w.t["dx"].copy_(w0.t["dx"])
    for w in works:
        with torch.cuda.device(w.device):
            kern.launch(*w.args, none, none, 0, none, none, 2, int(raw),
                        int(chol), cuda.stream(), kernels=0)


def reduced_solve_plain(H, rhs, free, lam, raw: bool, chol: bool):
    """Plain version of schur_solve_reduced's solve of a summed system:
    raw mode damps, H + diag(diag(H) lam + 1e-6), and freezes the fixed
    rows first; CG with the engine's count or Cholesky; dx times free."""
    S = H.shape[0]
    if raw:
        H = H + torch.diag(torch.diagonal(H) * lam + 1e-6)
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        rhs = rhs * free
    if chol:
        L, info = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(rhs[:, None], L)[:, 0]
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
    else:
        dx = E._cg_solve(H, rhs, iters=min(max(S // 2, 16), 128))
    return dx * free
