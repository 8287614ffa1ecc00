"""Keyframe-chain partitioned point BA with halo exchange (port of
plvio_tpu/parallel/chain_ba.py: `ChainBAData`, `partition_chain` :61,
`gather_results` :152, `make_chain_ba` :170-320).

The keyframe chain is cut into contiguous blocks of W keyframes, one a
shard, each with `halo` frozen copies of its neighbours' edge keyframes on
both sides (Wh = W + 2 halo); a landmark lives on the shard of the middle
of its observing span, and observations from outside that shard's window
are dropped.  Each outer iteration every shard takes one damped GN step on
its window (its own points eliminated, the reduced system damped locally,
H + diag(diag(H) lam + 1e-6), its fixed and halo rows frozen, Cholesky),
then the halos are refreshed from the neighbours by `Mesh.ppermute` both
ways (the chain's ends keep their frozen start).  No global sum.

`make_chain_ba(...)(data)` runs the plain version on a mesh of CPU shards
and the kernel path on a mesh of cards: per shard csrc/ba_linearize.cu,
`schur_reduce` (raw mode) and `schur_solve_reduced` on that shard alone
(Cholesky, damped after the reduction).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..solver import residuals as RES
from .dist_ba import local_reduce_plain
from .mesh import Mesh

CHI2_MONO = 5.991


class ChainBAData(NamedTuple):
    """The host-partitioned problem: D shards, Wh = W + 2 halo keyframes a
    shard, Pl landmarks and Ol observations a shard."""
    kf_pose: torch.Tensor    # [D, Wh, 3, 4]
    kf_free: torch.Tensor    # [D, Wh] halo and fixed keyframes False
    pt_xyz: torch.Tensor     # [D, Pl, 3]
    pt_free: torch.Tensor    # [D, Pl]
    obs_kf: torch.Tensor     # [D, Ol] window slot 0..Wh-1
    obs_pt: torch.Tensor     # [D, Ol] local landmark slot
    obs_uv: torch.Tensor     # [D, Ol, 2]
    obs_valid: torch.Tensor  # [D, Ol]
    obs_is2: torch.Tensor    # [D, Ol]


def partition_chain(n_shards: int, halo: int, chain: np.ndarray,
                    kf_pose: np.ndarray, obs_kf: np.ndarray,
                    obs_pt: np.ndarray, obs_uv: np.ndarray,
                    obs_is2: np.ndarray, pt_xyz: np.ndarray,
                    fixed_kf: np.ndarray = None):
    """Host-side partitioner: contiguous chain blocks and halos.  obs_kf
    holds chain positions (0..C-1).  Returns (ChainBAData, layout)."""
    C = len(chain)
    W = -(-C // n_shards)
    Wh = W + 2 * halo
    D = n_shards
    n_pts = len(pt_xyz)
    first_pos = np.full(n_pts, C - 1, np.int64)
    np.minimum.at(first_pos, obs_pt, obs_kf)
    last_pos = np.zeros(n_pts, np.int64)
    np.maximum.at(last_pos, obs_pt, obs_kf)
    mid_pos = (first_pos + last_pos) // 2
    shard_of_pt = np.clip(mid_pos // W, 0, D - 1)
    Pl = max(int(np.bincount(shard_of_pt, minlength=D).max()), 1)
    local_of_pt = np.zeros(n_pts, np.int64)
    for d in range(D):
        sel = np.nonzero(shard_of_pt == d)[0]
        local_of_pt[sel] = np.arange(len(sel))
    shard_of_obs = shard_of_pt[obs_pt]
    lo = shard_of_obs * W - halo
    local_kf = obs_kf - lo
    keep = (local_kf >= 0) & (local_kf < Wh)
    n_drop = int((~keep).sum())
    counts = np.bincount(shard_of_obs[keep], minlength=D)
    Ol = max(int(counts.max()), 1)
    data_obs_kf = np.zeros((D, Ol), np.int32)
    data_obs_pt = np.zeros((D, Ol), np.int32)
    data_obs_uv = np.zeros((D, Ol, 2), np.float32)
    data_obs_is2 = np.ones((D, Ol), np.float32)
    data_obs_valid = np.zeros((D, Ol), bool)
    for d in range(D):
        sel = np.nonzero(keep & (shard_of_obs == d))[0]
        k = len(sel)
        data_obs_kf[d, :k] = local_kf[sel]
        data_obs_pt[d, :k] = local_of_pt[obs_pt[sel]]
        data_obs_uv[d, :k] = obs_uv[sel]
        data_obs_is2[d, :k] = obs_is2[sel]
        data_obs_valid[d, :k] = True
    data_pose = np.tile(np.eye(3, 4, dtype=np.float32), (D, Wh, 1, 1))
    data_free = np.zeros((D, Wh), bool)
    for d in range(D):
        for j in range(Wh):
            pos = d * W - halo + j
            if 0 <= pos < C:
                data_pose[d, j] = kf_pose[pos]
                own = (halo <= j < halo + W) and (d * W + (j - halo) < C)
                data_free[d, j] = own
                if fixed_kf is not None and pos in fixed_kf:
                    data_free[d, j] = False
    data_pt = np.zeros((D, Pl, 3), np.float32)
    data_ptfree = np.zeros((D, Pl), bool)
    for d in range(D):
        sel = np.nonzero(shard_of_pt == d)[0]
        data_pt[d, :len(sel)] = pt_xyz[sel]
        data_ptfree[d, :len(sel)] = True
    layout = {"W": W, "Wh": Wh, "halo": halo, "C": C,
              "shard_of_pt": shard_of_pt, "local_of_pt": local_of_pt,
              "n_dropped_obs": n_drop}
    t = torch.from_numpy
    return ChainBAData(
        kf_pose=t(data_pose), kf_free=t(data_free), pt_xyz=t(data_pt),
        pt_free=t(data_ptfree), obs_kf=t(data_obs_kf),
        obs_pt=t(data_obs_pt), obs_uv=t(data_obs_uv),
        obs_valid=t(data_obs_valid), obs_is2=t(data_obs_is2)), layout


def gather_results(layout, poses_out: np.ndarray, pts_out: np.ndarray,
                   n_pts: int):
    """The sharded results [D,Wh,3,4] / [D,Pl,3] (numpy) back in chain
    order and landmark order."""
    W, Wh, halo, C = (layout["W"], layout["Wh"], layout["halo"],
                      layout["C"])
    D = poses_out.shape[0]
    chain_poses = np.zeros((C, 3, 4), np.float32)
    for d in range(D):
        for j in range(halo, halo + W):
            pos = d * W + (j - halo)
            if pos < C:
                chain_poses[pos] = poses_out[d, j]
    pts = np.zeros((n_pts, 3), np.float32)
    sp, lp = layout["shard_of_pt"], layout["local_of_pt"]
    pts[np.arange(n_pts)] = pts_out[sp, lp]
    return chain_poses, pts


def refresh_halos(mesh: Mesh, xs, halo: int, W: int):
    """The halo exchange of one [Wh, ...] state a local shard (reference
    chain_ba.py:271-296): the left halo from the left neighbour's last
    owned keyframes, the right halo from the right neighbour's first; the
    chain's ends keep theirs."""
    right_edge = [x[W:W + halo] for x in xs]         # my last owned
    left_edge = [x[halo:2 * halo] for x in xs]       # my first owned
    from_left = mesh.ppermute(right_edge, 1)
    from_right = mesh.ppermute(left_edge, -1)
    out = []
    for i, x in enumerate(xs):
        g = mesh.axis_index(i)
        x = x.clone()
        if g > 0:
            x[0:halo] = from_left[i]
        if g < mesh.size - 1:
            x[halo + W:] = from_right[i]
        out.append(x)
    return out


def make_chain_ba(K, mesh: Mesh, Wh: int, Pl: int, Ol: int,
                  outer_iters: int = 6, halo: int = 2, lam: float = 1e-3,
                  plain: bool = False, dtype=torch.float32):
    """run(data) -> (kf_pose [n_local,Wh,3,4], pt_xyz [n_local,Pl,3]) in
    the input's sharded layout (this process's shards).  A mesh of CPU
    shards (or `plain`) runs the plain version, a mesh of cards the kernel
    path."""
    W = Wh - 2 * halo
    kernel = not plain and mesh.first.type == "cuda"

    def shards(data):
        out = []
        for i, dev in enumerate(mesh.devices):
            g = mesh.axis_index(i)
            sd = {f: getattr(data, f)[g].to(dev).contiguous()
                  for f in ChainBAData._fields}
            for f in ("kf_pose", "pt_xyz", "obs_uv", "obs_is2"):
                sd[f] = sd[f].to(dtype)
            out.append(sd)
        return out

    def run_plain(data: ChainBAData):
        from ..models.kernels import reduced_solve_plain
        sds = shards(data)
        for _ in range(outer_iters):
            for sd in sds:
                H, rhs, Dinv, B3, gp = local_reduce_plain(
                    K, sd["kf_pose"], sd["pt_xyz"], sd["pt_free"],
                    sd["obs_kf"], sd["obs_pt"], sd["obs_uv"],
                    sd["obs_valid"], sd["obs_is2"], lam)
                free6 = torch.repeat_interleave(sd["kf_free"].to(dtype), 6)
                dx = reduced_solve_plain(H, rhs, free6, lam, raw=True,
                                         chol=True)
                rhs_p = gp - torch.einsum("spi,s->pi", B3, dx)
                dxp = torch.einsum("pij,pj->pi", Dinv, rhs_p) \
                    * sd["pt_free"][:, None].to(dtype)
                sd["kf_pose"] = RES.retract_pose_cw(sd["kf_pose"],
                                                    dx.reshape(Wh, 6))
                sd["pt_xyz"] = sd["pt_xyz"] + dxp
            poses = refresh_halos(mesh, [sd["kf_pose"] for sd in sds],
                                  halo, W)
            for sd, p in zip(sds, poses):
                sd["kf_pose"] = p
        return (torch.stack([sd["kf_pose"].to(mesh.first) for sd in sds]),
                torch.stack([sd["pt_xyz"].to(mesh.first) for sd in sds]))

    def run_kernel(data: ChainBAData):
        from ..models import kernels as KN
        works = []
        for sd in shards(data):
            dev = sd["kf_pose"].device
            with torch.cuda.device(dev):
                w = KN._BAWork(
                    K, sd["kf_pose"], sd["kf_free"], sd["pt_xyz"],
                    sd["pt_free"], sd["obs_kf"], sd["obs_pt"],
                    sd["obs_uv"], sd["obs_valid"], sd["obs_is2"],
                    *KN.no_lines(dev), lam0=lam, early_tol=0.0,
                    cg_iters=min(max(6 * Wh // 2, 16), 128))
                w.t["ctrl"][0] = lam
            works.append(w)
        for _ in range(outer_iters):
            for w in works:
                with torch.cuda.device(w.device):
                    w.linearize(KN.BA_MODE_LINEARIZE)
                    part = KN.schur_reduce(w, raw=True)
                    KN.schur_solve_reduced([w], [part], None, raw=True,
                                           chol=True)
                w.t["poses"].copy_(w.t["cposes"])
                w.t["pts"].copy_(w.t["cpts"])
            poses = refresh_halos(
                mesh, [w.t["poses"].view(Wh, 3, 4) for w in works], halo, W)
            for w, p in zip(works, poses):
                w.t["poses"].copy_(p.reshape(Wh, 12))
        return (torch.stack([w.t["poses"].view(Wh, 3, 4).to(mesh.first)
                             for w in works]),
                torch.stack([w.t["pts"].to(mesh.first) for w in works]))
    return run_kernel if kernel else run_plain
