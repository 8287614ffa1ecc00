"""Tracking and mapping kernels (port of plvio_tpu/models/kernels.py:
`fast_pose_opt` :111, `fast_pose_opt_pl` :179, `line_proj_match_core`
:355, `make_line_triangulator` :389, `make_line_pair_matcher` :605,
`make_local_ba_pl` :641, `make_projection_matcher` :767,
`make_epipolar_matcher` :828, `make_triangulator` :878,
`make_vi_pose_optimizer` :932, `make_local_ba` :1307).

`pose_irls` is the hand-written CUDA kernel (csrc/pose_irls.cu) for the
fused point+line pose IRLS; `pose_irls_plain` beside it is the same
algorithm in plain PyTorch with an exact Cholesky solve where the
reference runs 6 CG steps (equivalent for this damped 6x6 system).

`vi_pose_lm` is the hand-written CUDA kernel (csrc/vi_pose_lm.cu) of the
VI frame's 30-DoF pose optimization; `vi_pose_opt_plain` beside it runs
the same problem on the dense LM engine (solver/engine.py).

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
                    iters: int = 3, w_line: float = 1.0):
    """Plain version of `pose_irls`.  Returns (pose [3,4], inlier_pt [N],
    inlier_ln [L], n_inliers int32 scalar)."""
    delta = float(math.sqrt(CHI2_MONO))
    eye6 = torch.eye(6, dtype=pose0.dtype, device=pose0.device)

    def point_part(Rt):
        pc = X @ Rt[:, :3].T + Rt[:, 3]
        r = project(K, pc) - uv
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
            gate_p = (valid & (chi2 < CHI2_MONO)).to(pose0.dtype)
            gate_l = (valid_l & (chi2_l < CHI2_MONO)).to(pose0.dtype)
        w_h = torch.clamp_max(delta / torch.sqrt(torch.clamp_min(chi2, 1e-12)),
                              1.0)
        w = gate_p * (pc[:, 2] > 0.05).to(pose0.dtype) * w_h * inv_sigma2
        ju, jv = _proj_jac(K, pc)
        Jp = torch.stack([ju, jv], 1)                       # [N,2,3]
        Jphi = -torch.einsum("nij,njk->nik", Jp, lie.hat(pc))
        J = torch.cat([Jp, Jphi], -1)                       # [N,2,6]
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
    inl_p = valid & (chi2 < CHI2_MONO)
    inl_l = valid_l & (chi2_l < CHI2_MONO)
    return Rt, inl_p, inl_l, (inl_p.sum() + inl_l.sum()).to(torch.int32)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
POSE_IRLS = cuda.Kernel(
    "pose_irls", "pose_irls",
    [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
     _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P])


def pose_irls(K: PinholeK, pose0, uv, X, valid, inv_sigma2,
              l_obs, Xs, Xe, valid_l, is2_l, rounds: int = 4,
              iters: int = 3, w_line: float = 1.0):
    """Fused point+line pose-only IRLS (mono).  pose0 [3,4] T_cw; points
    uv [N,2], X [N,3], valid [N] bool, inv_sigma2 [N]; lines l_obs [L,3],
    Xs/Xe [L,3], valid_l [L] bool, is2_l [L] (L may be 0).  Returns (pose,
    inlier_pt, inlier_ln, n_inliers int32 scalar).  CPU tensors take the
    plain version; CUDA tensors launch csrc/pose_irls.cu."""
    if pose0.device.type == "cpu":
        return pose_irls_plain(K, pose0, uv, X, valid, inv_sigma2, l_obs, Xs,
                               Xe, valid_l, is2_l, rounds, iters, w_line)
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
    if n + L > 200_000:
        raise ValueError("pose_irls: the gates of N + L rows must fit in "
                         "shared memory (N + L <= 200000)")
    dev = pose0.device
    pose = torch.empty(3, 4, dtype=torch.float32, device=dev)
    inl_p = torch.empty(n, dtype=torch.bool, device=dev)
    inl_l = torch.empty(L, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    POSE_IRLS.launch(
        cuda.ptr(pose0), cuda.ptr(uv), cuda.ptr(X), cuda.ptr(valid),
        cuda.ptr(inv_sigma2), n, cuda.ptr(l_obs), cuda.ptr(Xs), cuda.ptr(Xe),
        cuda.ptr(valid_l), cuda.ptr(is2_l), L, K.fx, K.fy, K.cx, K.cy,
        float(w_line), float(math.sqrt(CHI2_MONO)), rounds, iters,
        cuda.ptr(pose), cuda.ptr(inl_p), cuda.ptr(inl_l), cuda.ptr(n_inl),
        cuda.stream())
    return pose, inl_p, inl_l, n_inl


def fast_pose_opt_pl(K: PinholeK, pose0, uv, X, valid, inv_sigma2,
                     l_obs, Xs, Xe, valid_l, is2_l, rounds: int = 4,
                     iters: int = 3, w_line: float = 1.0, plain: bool = False):
    """Point+line pose IRLS.  Returns (pose, inlier_pt, inlier_ln,
    n_inliers)."""
    fn = pose_irls_plain if plain else pose_irls
    return fn(K, pose0, uv, X, valid, inv_sigma2, l_obs, Xs, Xe, valid_l,
              is2_l, rounds, iters, w_line)


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


def _vi_problem(K, Rcb, tcb, gravity, cap, mask, consts):
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
                      iters: int = 6, stats=None):
    """Plain version of `vi_pose_lm` on the dense engine (mono): the
    current (pose_wb, v, bg, ba) against the previous state through the
    body-frame reprojection edges, one 9-dim inertial edge, the bias
    random walks and (have_prior) the 15-DoF prior on the previous state,
    `rounds` x <= `iters` LM with early exit and chi2 re-gating, then the
    next prior: the previous state marginalized out of the 30x30 H
    (eigh pseudo-inverse), or the current block when have_prior is False.
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
    for _ in range(rounds):
        prob = _vi_problem(K, Rcb, tcb, gravity, cap, mask, consts)
        states, _, chi2s = E.optimize(prob, states, iters=iters,
                                      dense_free_mask=free, early_tol=1e-2,
                                      stats=stats)
        mask = valid & (chi2s["reproj"] < CHI2_MONO)
    prob = _vi_problem(K, Rcb, tcb, gravity, cap, mask, consts)
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
    return (states["pose"][1], states["vel"][1], states["bg"][1],
            states["ba"][1], mask, mask.sum().to(torch.int32), H15)


VI_POSE_LM = cuda.Kernel(
    "vi_pose_lm", "vi_pose_lm",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
     _P, _P, _P, _P])


def _pack(d, keys):
    return torch.cat([d[k].reshape(-1) for k in keys]).contiguous()


def vi_pose_lm(K: PinholeK, Rcb, tcb, gravity: float, pose_wb0, v0, bg0,
               ba0, uv, X, valid, is2, prev_pose_wb, prev_v, pre_const,
               imu_info, bias_rw_info, prior_const, prior_info,
               have_prior: bool, rounds: int = 3, iters: int = 6):
    """VI pose optimization of the tracked frame (mono), see
    `vi_pose_opt_plain`.  CPU tensors take the plain version; CUDA tensors
    launch csrc/vi_pose_lm.cu, which runs every round, LM iteration, early
    exit and the marginalization on the device (no host sync)."""
    if pose_wb0.device.type == "cpu":
        return vi_pose_opt_plain(K, Rcb, tcb, gravity, pose_wb0, v0, bg0,
                                 ba0, uv, X, valid, is2, prev_pose_wb,
                                 prev_v, pre_const, imu_info, bias_rw_info,
                                 prior_const, prior_info, have_prior,
                                 rounds, iters)
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
    if cap > 32768:
        raise ValueError("vi_pose_lm: the edge gates of cap rows must fit "
                         "in shared memory (cap <= 32768)")
    out = torch.empty(21 + 225, dtype=f32, device=dev)
    inlier = torch.empty(cap, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    VI_POSE_LM.launch(
        cuda.ptr(state), cuda.ptr(uv), cuda.ptr(X), cuda.ptr(valid),
        cuda.ptr(is2), cap, int(have_prior), rounds, iters, K.fx, K.fy,
        K.cx, K.cy, float(gravity), float(math.sqrt(CHI2_MONO)),
        cuda.ptr(out), cuda.ptr(inlier), cuda.ptr(n_inl), cuda.stream())
    pose = out[:12].view(3, 4)
    return (pose, out[12:15], out[15:18], out[18:21], inlier, n_inl,
            out[21:].view(15, 15))


def make_vi_pose_optimizer(K: PinholeK, cap: int, Rcb, tcb, gravity: float,
                           rounds: int = 3, iters: int = 6,
                           plain: bool = False):
    """run(pose_wb0 [3,4], v0, bg0, ba0, uvr [cap,3], X [cap,3], valid,
    is2, prev_pose_wb, prev_v, pre_const dict, imu_info [9,9],
    bias_rw_info [6], prior_const {R0,p0,v0,bg0,ba0}, prior_info [15,15],
    have_prior bool) -> (pose_wb, v, bg, ba, inlier, n_inliers, H15): the
    mono flavour (bf = 0) of the reference's make_vi_pose_optimizer; uvr's
    third column is ignored.  `plain` runs the plain version on any
    device."""
    fn = vi_pose_opt_plain if plain else vi_pose_lm
    Rcb = torch.as_tensor(np.asarray(Rcb, np.float32))
    tcb = torch.as_tensor(np.asarray(tcb, np.float32))

    def run(pose_wb0, v0, bg0, ba0, uvr, X, valid, is2, prev_pose_wb,
            prev_v, pre_const, imu_info, bias_rw_info, prior_const,
            prior_info, have_prior):
        dev = pose_wb0.device
        return fn(K, Rcb.to(dev), tcb.to(dev), gravity, pose_wb0, v0, bg0,
                  ba0, uvr[:, :2].contiguous(), X, valid, is2, prev_pose_wb,
                  prev_v, pre_const, imu_info, bias_rw_info, prior_const,
                  prior_info, have_prior, rounds, iters)
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
    "gm", "gpart", "rr", "ff", "dx", "ctrl",
    "kfx", "ckfx", "kf_free_bias", "pre", "imu_info", "edge_valid", "rw_g",
    "rw_a", "link", "link_cost", "ccost", "cgw")
# column chunks of schur_solve's Gram fill-in (partial tiles summed in order)
GRAM_SPLIT = 24
BA_LINEARIZE = cuda.Kernel("ba_linearize", "ba_linearize",
                           [_P, _P, _P, _I, _P])
SCHUR_SOLVE = cuda.Kernel("schur_solve", "schur_solve", [_P, _P, _P, _P])


# schur_solve's launches whose reduced solve took the global path (the
# kernel reports its path, `_BAWork.solve` counts it; csrc/schur_solve.cu
# `solve_global_kernel`)
SCHUR_SOLVE.global_launches = 0
BA_MODE_LINEARIZE, BA_MODE_DECIDE, BA_MODE_INIT, BA_MODE_REGATE = range(4)


def solve_fits(S: int) -> bool:
    """Whether schur_solve's one-block solve holds the S x S reduced system
    (packed upper triangle) and its CG vectors in shared memory
    (csrc/schur_solve.cu `solve_smem`, at most 232448 bytes); beyond it
    the kernel takes its global path."""
    return (S * (S + 1) // 2 + 5 * S + 32) * 4 <= 232448


def cg_workspace_floats(S: int) -> int:
    """Floats of the global path's workspace (csrc/ba_common.cuh `cgw`):
    the full S x S system, p [S] and two partial-sum rows of one float per
    128-row block; 1 when the one-block solve fits."""
    if solve_fits(S):
        return 1
    return S * S + S + 2 * (-(-S // 128))


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
    window BA (body poses pose_wb, 15-DoF keyframe states)."""

    def __init__(self, K, kf_poses, kf_free, pt_xyz, pt_free, obs_kf, obs_pt,
                 obs_uv, obs_valid, obs_is2, ln_ep, ln_free, lobs_kf,
                 lobs_ln, lobs_eq, lobs_valid, lobs_is2, lam0, early_tol,
                 cg_iters, inertial=None):
        dev = kf_poses.device
        f32 = torch.float32
        n_kf, n_pt, n_ln = kf_poses.shape[0], pt_xyz.shape[0], ln_ep.shape[0]
        n_obs, n_lobs = obs_kf.shape[0], lobs_kf.shape[0]
        N = n_obs + n_lobs
        S, C = 6 * n_kf, 3 * n_pt + 6 * n_ln
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
        t.update(obs_c=buf(N, 27), p_l=buf(n_obs, 9), p_w=buf(n_obs, 18),
                 l_l=buf(n_lobs, 27), l_w=buf(n_lobs, 36), chi2=buf(N),
                 wchi2=buf(N), hcc=buf(n_kf, 27), hpt=buf(n_pt, 9),
                 hln=buf(n_ln, 27), fpt=buf(n_pt, 9), fln=buf(n_ln, 36),
                 occ_pt=buf(n_pt, dtype=torch.uint8),
                 occ_ln=buf(n_ln, dtype=torch.uint8), gm=buf(S, C),
                 gpart=buf(GRAM_SPLIT, S, S), rr=buf(N, 6),
                 dx=buf(S if inertial is None else 15 * n_kf), ctrl=buf(8))
        t["ff"] = buf(S, S)
        t["cgw"] = buf(cg_workspace_floats(
            S if inertial is None else 15 * n_kf))
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
        self.t = t
        self.n_obs = n_obs
        self.body = inertial is not None
        self._keep = (
            (ctypes.c_void_p * len(_BA_PTRS))(
                *[t[name].data_ptr() for name in _BA_PTRS]),
            (ctypes.c_int * 10)(n_kf, n_pt, n_obs, n_ln, n_lobs, cg_iters,
                                GRAM_SPLIT, int(self.body),
                                t["cgw"].numel(), 0),
            (ctypes.c_float * 21)(K.fx, K.fy, K.cx, K.cy,
                                  float(math.sqrt(CHI2_MONO)), CHI2_MONO,
                                  lam0, early_tol, grav, *rcb, *tcb))
        self.args = [ctypes.cast(a, ctypes.c_void_p) for a in self._keep]

    def linearize(self, mode: int):
        BA_LINEARIZE.launch(*self.args, mode, cuda.stream())

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
        return self._keep[1][9]

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
    csrc/ba_linearize.cu and csrc/schur_solve.cu (the Gram fill-in
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
OCTAVE_SCALE = np.float32(np.float64(np.float32(1.2)) ** np.arange(8))


def project_gates(K: PinholeK, pose, pt_xyz, pt_valid, pt_normal=None,
                  pt_min_dist=None, pt_max_dist=None):
    """Map points into the frame (models/kernels.py:780-805): (uv_proj
    [P,2], proj_ok [P]) with the depth guard z > 0.05, the image gate u in
    [0, 2 cx), v in [0, 2 cy), and with pt_min_dist / pt_max_dist the
    distance-range gate (0.8 min, 1.2 max; off where max <= 1e-6), with
    pt_normal too the viewing-angle gate cos > 0.5 (off where the normal is
    zero).  Every 3-vector product summed as (x0 y0 + x1 y1) + x2 y2."""
    R, t = pose[:, :3], pose[:, 3]
    X = _v3(pt_xyz)
    pc = [_dot3([R[i, 0], R[i, 1], R[i, 2]], X) + t[i] for i in range(3)]
    z = pc[2]
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


PROJ_MATCH = cuda.Kernel(
    "proj_match", "proj_match",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
     _F, _F, _F, _F, _F, _F, _F, _F, _F] + [_F] * 8 + [_P, _P, _P, _P, _P,
                                                       _P])


def proj_match(K: PinholeK, pose, pt_xyz, pt_desc, pt_valid, feat_uv,
               feat_desc, feat_octave, feat_valid, radius: float,
               max_dist: float = 80.0, pt_normal=None, pt_min_dist=None,
               pt_max_dist=None):
    """Map points matched to a frame's features by projection (pose [3,4]
    T_cw, pt_xyz [P,3], pt_desc [P,8] int32, pt_valid [P]; feat_uv [F,2],
    feat_desc [F,8] int32, feat_octave [F] int32 in 0..7, feat_valid [F];
    the tracker's frustum gates when pt_min_dist / pt_max_dist [P] (and
    pt_normal [P,3]) are given).  Returns (uv_m [P,2], pt_feat [P] int32,
    matched [P], feat_pt [F] int32).  CPU tensors take the plain version;
    CUDA tensors launch csrc/proj_match.cu."""
    if pose.device.type == "cpu":
        return proj_match_plain(K, pose, pt_xyz, pt_desc, pt_valid, feat_uv,
                                feat_desc, feat_octave, feat_valid, radius,
                                max_dist, pt_normal, pt_min_dist, pt_max_dist)
    P, F = pt_xyz.shape[0], feat_uv.shape[0]
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
    PROJ_MATCH.launch(
        cuda.ptr(pose), cuda.ptr(pt_xyz), cuda.ptr(pt_desc),
        cuda.ptr(pt_valid), *opt, cuda.ptr(feat_uv), cuda.ptr(feat_desc),
        cuda.ptr(feat_octave), cuda.ptr(feat_valid), P, F, frustum, K.fx,
        K.fy, K.cx, K.cy, float(2 * K.cx), float(2 * K.cy), float(radius),
        float(max_dist), 0.9, *[float(s) for s in OCTAVE_SCALE],
        cuda.ptr(uv_m), cuda.ptr(pt_feat), cuda.ptr(matched),
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


def global_window(kind: str, n_kf: int, device, dtype=torch.float32):
    """A perturbed window whose reduced system exceeds one block's shared
    memory: `inertial`, the full-map inertial BA's caps at n_kf keyframes
    (8192 points / 16384 observations, 512 lines / 1024), or `points`,
    the global point-only BA's (8192 points / 32768 observations).
    Returns (inputs, argument list, plain problem, states, free masks) at
    `dtype` on `device`; the inputs stay on the CPU."""
    from ..entry import K_EUROC
    from ..inputs import (build_inertial_window, build_mapping_inputs,
                          perturb_window)
    dev = torch.device(device)
    if kind == "inertial":
        A = build_inertial_window(8192, 16384, 512, 1024, n_kf=n_kf,
                                  perturbed=True, device="cpu")
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
    if kind == "inertial":
        prob = _liba_problem(
            K_EUROC, cast(A["Rcb"]), cast(A["tcb"]), 9.81, n_kf,
            args[6].shape[0], args[18].shape[0],
            (args[8].long(), args[9].long(), args[10], args[12]), args[11],
            (args[20].long(), args[21].long(), args[22]), args[23],
            (args[13], args[14], args[15], args[16], args[17]))
        st = {"pose": args[0], "vel": args[1], "bg": args[2], "ba": args[3],
              "pt": args[6], "ln": args[18]}
        free = ({"pose": args[4], "vel": args[4], "bg": args[5],
                 "ba": args[5]}, {"pt": args[7], "ln": args[19]})
    else:
        prob = _ba_problem(K_EUROC, n_kf, args[2].shape[0], 0,
                           args[4].long(), args[5].long(), args[6], args[7],
                           args[8])
        st = {"pose": args[0], "pt": args[2]}
        free = ({"pose": args[1]}, {"pt": args[3]})
    return A, args, prob, st, free


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
    reported (1 global), whether a second launch gave the same bits, a
    StepGap per dense state, and `case` (the kernel path's work, the
    window's inputs and the plain problem, for timing)."""
    S: int
    path: int
    same_bits: bool
    gaps: dict
    case: dict

    def failures(self) -> list:
        """What breaks the rule the global path is held to: it ran; a
        second launch repeats bit for bit; per state the kernel lies
        within 2x the plain float32 step's distance to float64 and no
        farther from the plain step than that step lies from float64 (each
        + 1e-6); and its pose lies within a quarter of the float64 step's
        largest pose entry of the float64 step.  Empty when it holds."""
        bad = []
        if self.path != 1:
            bad.append(f"S = {self.S} took the one-block path")
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


def global_solve_against_float64(kind: str, n_kf: int,
                                 device="cuda") -> GlobalSolveCheck:
    """schur_solve's global path (the reduced solve beyond one block) on
    `global_window(kind, n_kf)`: one damped Schur step from the perturbed
    start, launched twice, against the plain engine's step in float32 on
    the same device and in float64 on the CPU (damping 1e-4, the reference
    engine's initial lambda)."""
    from ..entry import K_EUROC
    dev = cuda.resolve_device(device)
    lam = 1e-4
    A, args, prob, st, free = global_window(kind, n_kf, dev)
    if kind == "inertial":
        w = inertial_work(K_EUROC, A["Rcb"], A["tcb"], 9.81, *args)
        w.chain(CHAIN_COST_STATE)
        S = 15 * n_kf
    else:
        S = 6 * n_kf
        w = _BAWork(K_EUROC, *args, lam0=lam, early_tol=1e-2,
                    cg_iters=min(max(S // 2, 16), 128))
    w.linearize(BA_MODE_INIT)
    w.linearize(BA_MODE_LINEARIZE)
    if w.body:
        w.chain(CHAIN_LINEARIZE)
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
        _, _, p64, s64, f64 = global_window(kind, n_kf, "cpu", torch.float64)
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
        S, w.solve_path(), all(torch.equal(ck[k], ck2[k]) for k in ck), gaps,
        dict(inputs=A, work=w, prob=prob, states=st, free=free, lam=lam))

def _gs_problem(gravity, n_kf, pre_const, pose_R, pose_p, imu_info,
                edge_valid, prior_g=None, prior_a=None):
    """The IMU-initialization problem (models/kernels.py:1162-1195):
    gravity direction, scale, shared biases and per-KF velocities with the
    poses fixed; the bias priors when prior_g / prior_a are given."""
    dev = pose_p.device
    n_e = n_kf - 1
    i1 = torch.arange(n_e, device=dev)
    z = torch.zeros(n_e, dtype=torch.int64, device=dev)
    const = dict(pre_const)
    const.update(R1=pose_R[:-1], p1=pose_p[:-1], R2=pose_R[1:],
                 p2=pose_p[1:])
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
                        prior_g: float = 1e2, prior_a: float = 1e10):
    """Plain version of the IMU initialization on the dense engine: every
    state free from scale 1 and zero biases, `iters` LM iterations (no
    early exit), Cholesky solve.  Returns (Rwg, scale, bg, ba, vel)."""
    n_kf = vel0.shape[0]
    dt_ = vel0.dtype
    prob = _gs_problem(gravity, n_kf, pre_const, pose_R, pose_p, imu_info,
                       edge_valid, prior_g, prior_a)
    z = torch.zeros(1, 3, dtype=dt_, device=vel0.device)
    states = {"gdir": Rwg0[None], "scale": torch.ones(1, 1, dtype=dt_,
                                                      device=vel0.device),
              "bg": z, "ba": z.clone(), "vel": vel0}
    states, _, _ = E.optimize(prob, states, iters=iters)
    return (states["gdir"][0], states["scale"][0, 0], states["bg"][0],
            states["ba"][0], states["vel"])


def scale_refine_plain(gravity: float, Rwg0, vel, bg, ba, pre_const, pose_R,
                       pose_p, imu_info, edge_valid, iters: int = 12):
    """Plain version of the scale/gravity refinement: the same edges with
    only the gravity direction and the scale free.  Returns (Rwg,
    scale)."""
    n_kf = vel.shape[0]
    dev = vel.device
    prob = _gs_problem(gravity, n_kf, pre_const, pose_R, pose_p, imu_info,
                       edge_valid)
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
