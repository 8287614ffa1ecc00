"""Tracking and mapping kernels (port of plvio_tpu/models/kernels.py:
`fast_pose_opt` :111, `fast_pose_opt_pl` :179, `line_proj_match_core`
:355, `make_local_ba_pl` :641, `make_epipolar_matcher` :828,
`make_triangulator` :878, `make_vi_pose_optimizer` :932).

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
"""
from __future__ import annotations

import ctypes
import math

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
                lobs_kf, lobs_ln, lobs_eq, mask_l, lobs_is2):
    prob = E.Problem(linear_solver="cg")
    prob.add_dense("pose", n_kf, 6, RES.retract_pose_cw)
    prob.add_landmarks("pt", n_pt, 3, RES.retract_additive)
    prob.add_landmarks("ln", n_ln, 6, RES.retract_additive)
    delta = float(math.sqrt(CHI2_MONO))
    prob.add_term(E.Term(
        name="reproj", res_fn=RES.point_reproj_ba_for(K), rdim=2,
        dense_refs=[("pose", obs_kf)], lm_ref=("pt", obs_pt),
        const={"uv": obs_uv}, mask=mask, info=obs_is2, robust_delta=delta))
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
    "gm", "gpart", "rr", "ff", "dx", "ctrl")
# column chunks of schur_solve's Gram fill-in (partial tiles summed in order)
GRAM_SPLIT = 24
BA_LINEARIZE = cuda.Kernel("ba_linearize", "ba_linearize",
                           [_P, _P, _P, _I, _P])
SCHUR_SOLVE = cuda.Kernel("schur_solve", "schur_solve", [_P, _P, _P, _P])
BA_MODE_LINEARIZE, BA_MODE_DECIDE, BA_MODE_INIT, BA_MODE_REGATE = range(4)


def _segments(keys: torch.Tensor, n: int):
    """(order int32, start int32 [n+1]): one stable sort of `keys`."""
    keys = keys.long()
    order = torch.sort(keys, stable=True).indices.to(torch.int32)
    start = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    start[1:] = torch.cumsum(torch.bincount(keys, minlength=n), 0)
    return order.contiguous(), start.to(torch.int32)


class _BAWork:
    """Device buffers and the pointer table of one kernel-path BA call."""

    def __init__(self, K, kf_poses, kf_free, pt_xyz, pt_free, obs_kf, obs_pt,
                 obs_uv, obs_valid, obs_is2, ln_ep, ln_free, lobs_kf,
                 lobs_ln, lobs_eq, lobs_valid, lobs_is2, lam0, early_tol,
                 cg_iters):
        dev = kf_poses.device
        f32 = torch.float32
        n_kf, n_pt, n_ln = kf_poses.shape[0], pt_xyz.shape[0], ln_ep.shape[0]
        n_obs, n_lobs = obs_kf.shape[0], lobs_kf.shape[0]
        N = n_obs + n_lobs
        S, C = 6 * n_kf, 3 * n_pt + 6 * n_ln

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
        t["kf_order"], t["kf_start"] = _segments(torch.cat([obs_kf, lobs_kf]),
                                                 n_kf)
        t["pt_order"], t["pt_start"] = _segments(obs_pt, n_pt)
        t["ln_order"], t["ln_start"] = _segments(lobs_ln, n_ln)
        t.update(obs_c=buf(N, 27), p_l=buf(n_obs, 9), p_w=buf(n_obs, 18),
                 l_l=buf(n_lobs, 27), l_w=buf(n_lobs, 36), chi2=buf(N),
                 wchi2=buf(N), hcc=buf(n_kf, 27), hpt=buf(n_pt, 9),
                 hln=buf(n_ln, 27), fpt=buf(n_pt, 9), fln=buf(n_ln, 36),
                 occ_pt=buf(n_pt, dtype=torch.uint8),
                 occ_ln=buf(n_ln, dtype=torch.uint8), gm=buf(S, C),
                 gpart=buf(GRAM_SPLIT, S, S), rr=buf(N, 6), ff=buf(S, S),
                 dx=buf(S), ctrl=buf(8))
        for name in _BA_PTRS:
            if t[name].numel() and not t[name].is_contiguous():
                raise ValueError(f"local BA: {name} is not contiguous")
        self.t = t
        self.n_obs = n_obs
        self._keep = (
            (ctypes.c_void_p * len(_BA_PTRS))(
                *[t[name].data_ptr() for name in _BA_PTRS]),
            (ctypes.c_int * 7)(n_kf, n_pt, n_obs, n_ln, n_lobs, cg_iters,
                               GRAM_SPLIT),
            (ctypes.c_float * 8)(K.fx, K.fy, K.cx, K.cy,
                                 float(math.sqrt(CHI2_MONO)), CHI2_MONO,
                                 lam0, early_tol))
        self.args = [ctypes.cast(a, ctypes.c_void_p) for a in self._keep]

    def linearize(self, mode: int):
        BA_LINEARIZE.launch(*self.args, mode, cuda.stream())

    def step(self):
        """One LM iteration, decided on the device."""
        self.linearize(BA_MODE_LINEARIZE)
        SCHUR_SOLVE.launch(*self.args, cuda.stream())
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
    if 6 * n_kf > 200:
        raise ValueError("local_ba_pl: the reduced system must fit in "
                         "shared memory (n_kf <= 33)")
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
