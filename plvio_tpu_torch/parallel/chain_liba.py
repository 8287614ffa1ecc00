"""Keyframe-chain partitioned visual-inertial window BA with lines (port
of plvio_tpu/parallel/chain_liba.py: `ChainLIBAData`, `_route_landmarks`
:75, `_pack_obs` :96, `partition_chain_vi` :111, `gather_results_vi` :257,
`make_chain_liba` :286-442).

The chain is cut into contiguous blocks of W keyframes with `halo` frozen
15-DoF copies of the neighbours' edge keyframes on each side; point and
line landmarks live on the shard of the middle of their observing span.
Each outer sweep is red-black: the even shards solve their windows while
the odd ones hold, the halos are refreshed, then the odd shards, the
halos again.  A shard's solve is the inertial window BA's own problem (the
body-frame point and line edges, the inertial and bias random-walk edges)
for one LM round of `iters` iterations with the early exit, its chi2 masks
carried from sweep to sweep; the halo states (pose, velocity, biases)
travel by `Mesh.ppermute`.  No global sum.

The reference's docstring routes `LoopCloser.run_global_ba` and the VIBA
pulses through this module; its code does not (nothing calls it but its
tests), and neither does the port's.

`make_chain_liba(...)(data)` runs the plain version (the engine) on a mesh
of CPU shards and the kernel path on a mesh of cards: each shard's round
on the inertial window's existing kernels (csrc/ba_linearize.cu,
csrc/inertial_chain.cu, csrc/schur_solve.cu).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..solver import engine as E
from .chain_ba import refresh_halos
from .mesh import Mesh

CHI2_MONO = 5.991


class ChainLIBAData(NamedTuple):
    """The host-partitioned VI problem: D shards x Wh-keyframe windows (W
    owned + 2 halo); the leading axis is the shard's."""
    kf_pose: torch.Tensor     # [D, Wh, 3, 4] body poses T_wb
    kf_vel: torch.Tensor      # [D, Wh, 3]
    kf_bg: torch.Tensor       # [D, Wh, 3]
    kf_ba: torch.Tensor       # [D, Wh, 3]
    kf_free: torch.Tensor     # [D, Wh] pose + velocity free
    kf_free_bias: torch.Tensor  # [D, Wh]
    pt_xyz: torch.Tensor      # [D, Pl, 3]
    pt_free: torch.Tensor     # [D, Pl]
    obs_kf: torch.Tensor      # [D, Ol] window slot
    obs_pt: torch.Tensor      # [D, Ol] local landmark slot
    obs_uv: torch.Tensor      # [D, Ol, 2]
    obs_valid: torch.Tensor   # [D, Ol]
    obs_is2: torch.Tensor     # [D, Ol]
    ln_ep: torch.Tensor       # [D, Ll, 6]
    ln_free: torch.Tensor     # [D, Ll]
    lobs_kf: torch.Tensor     # [D, Lo]
    lobs_ln: torch.Tensor     # [D, Lo]
    lobs_eq: torch.Tensor     # [D, Lo, 3]
    lobs_valid: torch.Tensor  # [D, Lo]
    pre_const: dict           # each [D, Wh-1, ...]
    imu_info: torch.Tensor    # [D, Wh-1, 9, 9]
    edge_valid: torch.Tensor  # [D, Wh-1]
    rw_info_g: torch.Tensor   # [D, Wh-1]
    rw_info_a: torch.Tensor   # [D, Wh-1]


def _route_landmarks(D, W, Wh, halo, n_lm, obs_kf_pos, obs_pt):
    """Each landmark on the shard of the middle chain position of its
    span: (shard_of_lm, local_of_lm, shard_of_obs, local_kf, keep)."""
    C_hint = obs_kf_pos.max() + 1 if len(obs_kf_pos) else 1
    first = np.full(n_lm, C_hint, np.int64)
    np.minimum.at(first, obs_pt, obs_kf_pos)
    last = np.zeros(n_lm, np.int64)
    np.maximum.at(last, obs_pt, obs_kf_pos)
    mid = (first + last) // 2
    shard_of = np.clip(mid // W, 0, D - 1)
    local_of = np.zeros(n_lm, np.int64)
    for d in range(D):
        sel = np.nonzero(shard_of == d)[0]
        local_of[sel] = np.arange(len(sel))
    shard_of_obs = shard_of[obs_pt]
    lo = shard_of_obs * W - halo
    local_kf = obs_kf_pos - lo
    keep = (local_kf >= 0) & (local_kf < Wh)
    return shard_of, local_of, shard_of_obs, local_kf, keep


def _pack_obs(D, cap, sel_shard, keep, cols):
    """The kept observations in [D, cap, ...] padded tables; cols: [(array,
    fill, dtype), ...]."""
    outs = [np.full((D, cap) + a.shape[1:], fill, dtype)
            for a, fill, dtype in cols]
    valid = np.zeros((D, cap), bool)
    for d in range(D):
        sel = np.nonzero(keep & (sel_shard == d))[0][:cap]
        k = len(sel)
        for o, (a, _, _) in zip(outs, cols):
            o[d, :k] = a[sel]
        valid[d, :k] = True
    return outs, valid


def partition_chain_vi(n_shards: int, halo: int, chain_pos_count: int,
                       pose_wb, vel, bg, ba, obs_kf, obs_pt, obs_uv,
                       obs_is2, pt_xyz, pre_stack: dict, imu_info,
                       edge_valid, rw_g, rw_a, lobs_kf=None, lobs_ln=None,
                       lobs_eq=None, ln_ep=None, fixed_pos=(0,),
                       free_all_biases: bool = True):
    """Host-side partitioner (numpy).  `*_kf` are chain positions; the
    chain's C-1 edges join positions i and i+1.  An edge's information is
    scaled down to a largest diagonal of 1e6 and the walks' to 1e6 (the
    reference's float32 conditioning bound).  Returns (ChainLIBAData,
    layout)."""
    C = chain_pos_count
    D = n_shards
    W = -(-C // D)
    Wh = W + 2 * halo
    n_pts = len(pt_xyz)
    sp, lp, s_obs, lkf, keep = _route_landmarks(D, W, Wh, halo, n_pts,
                                                obs_kf, obs_pt)
    Pl = max(int(np.bincount(sp, minlength=D).max()), 1)
    Ol = max(int(np.bincount(s_obs[keep], minlength=D).max()), 1)
    (okf_t, opt_t, ouv_t, ois_t), ovalid = _pack_obs(
        D, Ol, s_obs, keep,
        [(lkf.astype(np.int32), 0, np.int32),
         (lp[obs_pt].astype(np.int32), 0, np.int32),
         (obs_uv.astype(np.float32), 0, np.float32),
         (obs_is2.astype(np.float32), 1, np.float32)])
    data_pt = np.zeros((D, Pl, 3), np.float32)
    data_ptfree = np.zeros((D, Pl), bool)
    for d in range(D):
        sel = np.nonzero(sp == d)[0]
        data_pt[d, :len(sel)] = pt_xyz[sel]
        data_ptfree[d, :len(sel)] = True
    have_lines = ln_ep is not None and len(ln_ep) > 0 \
        and lobs_kf is not None and len(lobs_kf) > 0
    if have_lines:
        n_lns = len(ln_ep)
        spl, lpl, s_lobs, llkf, lkeep = _route_landmarks(
            D, W, Wh, halo, n_lns, lobs_kf, lobs_ln)
        Ll = max(int(np.bincount(spl, minlength=D).max()), 1)
        Lo = max(int(np.bincount(s_lobs[lkeep], minlength=D).max()), 1)
        (lkf_t, lln_t, leq_t), lvalid = _pack_obs(
            D, Lo, s_lobs, lkeep,
            [(llkf.astype(np.int32), 0, np.int32),
             (lpl[lobs_ln].astype(np.int32), 0, np.int32),
             (lobs_eq.astype(np.float32), 0, np.float32)])
        data_ln = np.zeros((D, Ll, 6), np.float32)
        data_lnfree = np.zeros((D, Ll), bool)
        for d in range(D):
            sel = np.nonzero(spl == d)[0]
            data_ln[d, :len(sel)] = ln_ep[sel]
            data_lnfree[d, :len(sel)] = True
    else:
        spl = lpl = None
        data_ln = np.zeros((D, 1, 6), np.float32)
        data_lnfree = np.zeros((D, 1), bool)
        lkf_t = np.zeros((D, 1), np.int32)
        lln_t = np.zeros((D, 1), np.int32)
        leq_t = np.zeros((D, 1, 3), np.float32)
        lvalid = np.zeros((D, 1), bool)

    data_pose = np.tile(np.eye(3, 4, dtype=np.float32), (D, Wh, 1, 1))
    data_vel = np.zeros((D, Wh, 3), np.float32)
    data_bg = np.zeros((D, Wh, 3), np.float32)
    data_ba = np.zeros((D, Wh, 3), np.float32)
    data_free = np.zeros((D, Wh), bool)
    data_free_b = np.zeros((D, Wh), bool)
    fixed_pos = set(int(f) for f in np.atleast_1d(fixed_pos))
    for d in range(D):
        for j in range(Wh):
            pos = d * W - halo + j
            if 0 <= pos < C:
                data_pose[d, j] = pose_wb[pos]
                data_vel[d, j] = vel[pos]
                data_bg[d, j] = bg[pos]
                data_ba[d, j] = ba[pos]
                own = (halo <= j < halo + W) and (d * W + (j - halo) < C)
                fr = own and pos not in fixed_pos
                data_free[d, j] = fr
                data_free_b[d, j] = (own if free_all_biases else fr)
    data_pre = {k: np.zeros((D, Wh - 1) + np.asarray(v).shape[1:],
                            np.float32) for k, v in pre_stack.items()}
    data_info = np.tile(np.eye(9, dtype=np.float32), (D, Wh - 1, 1, 1))
    data_ev = np.zeros((D, Wh - 1), bool)
    data_rwg = np.zeros((D, Wh - 1), np.float32)
    data_rwa = np.zeros((D, Wh - 1), np.float32)
    INFO_MAX = 1e6
    for d in range(D):
        for j in range(Wh - 1):
            pos = d * W - halo + j
            if 0 <= pos < C - 1 and bool(edge_valid[pos]):
                for k in data_pre:
                    data_pre[k][d, j] = np.asarray(pre_stack[k][pos])
                info = np.asarray(imu_info[pos])
                s = max(1.0, float(np.abs(np.diag(info)).max()) / INFO_MAX)
                data_info[d, j] = info / s
                data_ev[d, j] = True
                data_rwg[d, j] = min(float(rw_g[pos]), INFO_MAX)
                data_rwa[d, j] = min(float(rw_a[pos]), INFO_MAX)
    layout = {"W": W, "Wh": Wh, "halo": halo, "C": C, "D": D,
              "shard_of_pt": sp, "local_of_pt": lp,
              "shard_of_ln": spl, "local_of_ln": lpl,
              "have_lines": have_lines}
    t = torch.from_numpy
    data = ChainLIBAData(
        kf_pose=t(data_pose), kf_vel=t(data_vel), kf_bg=t(data_bg),
        kf_ba=t(data_ba), kf_free=t(data_free), kf_free_bias=t(data_free_b),
        pt_xyz=t(data_pt), pt_free=t(data_ptfree), obs_kf=t(okf_t),
        obs_pt=t(opt_t), obs_uv=t(ouv_t), obs_valid=t(ovalid),
        obs_is2=t(ois_t), ln_ep=t(data_ln), ln_free=t(data_lnfree),
        lobs_kf=t(lkf_t), lobs_ln=t(lln_t), lobs_eq=t(leq_t),
        lobs_valid=t(lvalid),
        pre_const={k: t(v) for k, v in data_pre.items()},
        imu_info=t(data_info), edge_valid=t(data_ev), rw_info_g=t(data_rwg),
        rw_info_a=t(data_rwa))
    return data, layout


def gather_results_vi(layout, pose_out, vel_out, bg_out, ba_out, pts_out,
                      lns_out=None, n_pts: int = 0, n_lns: int = 0):
    """The sharded results (numpy) back in chain order and landmark
    order: (pose, vel, bg, ba, pts, lns or None)."""
    W, Wh, halo, C, D = (layout["W"], layout["Wh"], layout["halo"],
                         layout["C"], layout["D"])
    pose = np.zeros((C, 3, 4), np.float32)
    vel = np.zeros((C, 3), np.float32)
    bg = np.zeros((C, 3), np.float32)
    ba = np.zeros((C, 3), np.float32)
    for d in range(D):
        for j in range(halo, halo + W):
            pos = d * W + (j - halo)
            if pos < C:
                pose[pos] = pose_out[d, j]
                vel[pos] = vel_out[d, j]
                bg[pos] = bg_out[d, j]
                ba[pos] = ba_out[d, j]
    pts = np.zeros((n_pts, 3), np.float32)
    if n_pts:
        pts = np.asarray(pts_out)[layout["shard_of_pt"],
                                  layout["local_of_pt"]]
    lns = None
    if n_lns and layout["have_lines"]:
        lns = np.asarray(lns_out)[layout["shard_of_ln"],
                                  layout["local_of_ln"]]
    return pose, vel, bg, ba, pts, lns


_STATE = ("pose", "vel", "bg", "ba")


def make_chain_liba(K, mesh: Mesh, Wh: int, Pl: int, Ol: int, Ll: int,
                    Lo: int, Rcb, tcb, gravity: float, halo: int = 2,
                    outer_sweeps: int = 3, iters: int = 6,
                    early_tol: float = 1e-2, plain: bool = False,
                    dtype=torch.float32):
    """run(data) -> (pose, vel, bg, ba, pts, lns), each [n_local, ...] in
    the input's sharded layout (this process's shards).  A mesh of CPU
    shards (or `plain`) runs the plain version, a mesh of cards the kernel
    path."""
    from ..models import kernels as KN
    W = Wh - 2 * halo
    Rcb = torch.as_tensor(np.asarray(Rcb, np.float32))
    tcb = torch.as_tensor(np.asarray(tcb, np.float32))
    kernel = not plain and mesh.first.type == "cuda"

    def shard(data, i):
        dev = mesh.devices[i]
        g = mesh.axis_index(i)

        def mv(x):
            x = x[g].to(dev).contiguous()
            return x.to(dtype) if x.is_floating_point() else x
        sd = {f: mv(getattr(data, f)) for f in ChainLIBAData._fields
              if f != "pre_const"}
        sd["pre_const"] = {k: mv(v) for k, v in data.pre_const.items()}
        sd["pose"], sd["vel"] = sd.pop("kf_pose"), sd.pop("kf_vel")
        sd["bg"], sd["ba"] = sd.pop("kf_bg"), sd.pop("kf_ba")
        sd["mask"], sd["mask_l"] = sd["obs_valid"], sd["lobs_valid"]
        return sd

    def solve_plain(sd):
        """One engine round on the shard's window (reference :303-352)."""
        Rc, tc = Rcb.to(sd["pose"]), tcb.to(sd["pose"])
        obs = (sd["obs_kf"].long(), sd["obs_pt"].long(), sd["obs_uv"],
               sd["obs_is2"])
        lobs = (sd["lobs_kf"].long(), sd["lobs_ln"].long(), sd["lobs_eq"])
        chain = (sd["pre_const"], sd["imu_info"], sd["edge_valid"],
                 sd["rw_info_g"], sd["rw_info_a"])
        prob = KN._liba_problem(K, Rc, tc, gravity, Wh, Pl, Ll, obs,
                                sd["mask"], lobs, sd["mask_l"], chain)
        states = {"pose": sd["pose"], "vel": sd["vel"], "bg": sd["bg"],
                  "ba": sd["ba"], "pt": sd["pt_xyz"], "ln": sd["ln_ep"]}
        free = {"pose": sd["kf_free"], "vel": sd["kf_free"],
                "bg": sd["kf_free_bias"], "ba": sd["kf_free_bias"]}
        states, _, chi2s = E.optimize(
            prob, states, iters=iters, early_tol=early_tol,
            dense_free_mask=free,
            lm_free_mask={"pt": sd["pt_free"], "ln": sd["ln_free"]})
        sd.update(pose=states["pose"], vel=states["vel"], bg=states["bg"],
                  ba=states["ba"], pt_xyz=states["pt"], ln_ep=states["ln"],
                  mask=sd["obs_valid"] & (chi2s["reproj"] < CHI2_MONO),
                  mask_l=sd["lobs_valid"] & (chi2s["line"] < CHI2_MONO))

    def solve_kernel(sd):
        """The same round on the inertial window's kernels."""
        with torch.cuda.device(sd["pose"].device):
            w = KN.inertial_work(
                K, Rcb, tcb, gravity, sd["pose"], sd["vel"], sd["bg"],
                sd["ba"], sd["kf_free"], sd["kf_free_bias"], sd["pt_xyz"],
                sd["pt_free"], sd["obs_kf"], sd["obs_pt"], sd["obs_uv"],
                sd["obs_valid"], sd["obs_is2"], sd["pre_const"],
                sd["imu_info"], sd["edge_valid"], sd["rw_info_g"],
                sd["rw_info_a"], sd["ln_ep"], sd["ln_free"], sd["lobs_kf"],
                sd["lobs_ln"], sd["lobs_eq"], sd["lobs_valid"],
                early_tol=early_tol)
            w.t["mask"].copy_(sd["mask"])
            w.t["mask_l"].copy_(sd["mask_l"])
            w.chain(KN.CHAIN_COST_STATE)
            w.linearize(KN.BA_MODE_INIT)
            for _ in range(iters):
                w.step()
            w.chain(KN.CHAIN_COST_STATE)
            w.linearize(KN.BA_MODE_REGATE)
        t = w.t
        kfx = t["kfx"]
        sd.update(pose=t["poses"].view(Wh, 3, 4), vel=kfx[:, 0:3],
                  bg=kfx[:, 3:6], ba=kfx[:, 6:9], pt_xyz=t["pts"],
                  ln_ep=t["lns"], mask=t["mask"].clone(),
                  mask_l=t["mask_l"].clone())

    solve = solve_kernel if kernel else solve_plain

    def run(data: ChainLIBAData):
        sds = [shard(data, i) for i in range(mesh.n_local)]
        for _ in range(outer_sweeps):
            for parity in (0, 1):
                for i, sd in enumerate(sds):
                    if mesh.axis_index(i) % 2 == parity:
                        solve(sd)
                for k in _STATE:
                    xs = refresh_halos(mesh, [sd[k] for sd in sds], halo, W)
                    for sd, x in zip(sds, xs):
                        sd[k] = x.contiguous()
        return tuple(torch.stack([sd[k].to(mesh.first) for sd in sds])
                     for k in _STATE + ("pt_xyz", "ln_ep"))
    return run
