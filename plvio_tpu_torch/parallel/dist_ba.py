"""Landmark-sharded point BA with replicated keyframe poses (port of
plvio_tpu/parallel/dist_ba.py: `DistBAData`, `bucket_observations` :53,
`make_dist_ba` :107-228).

The landmarks are cut into contiguous blocks, one a shard, and every
observation lives on its landmark's shard; the T_cw poses are replicated.
Each GN iteration every shard linearizes its observations (whitened by
sqrt(is2), Huber weight at sqrt(5.991), times the validity), eliminates
its own points (the engine's damping floor at the fixed lam and the
Gram-form fill-in) into an undamped partial reduced system; the mesh sums
the partials; the sum is damped once, H + diag(diag(H) lam + 1e-6) with
lam = 1e-3, its fixed rows frozen, and solved by Cholesky; every shard
back-substitutes its own points.  No LM accept: a fixed number of
iterations, every step applied.

`make_dist_ba(...)(data)` runs the plain version on a mesh of CPU shards
and the kernel path on a mesh of cards: csrc/ba_linearize.cu (the point
edge of the point+line window BA, no lines), `schur_reduce` in raw mode,
`schur_solve_reduced` in its Cholesky mode (csrc/schur_solve.cu).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..solver import engine as E
from ..solver import residuals as RES
from .mesh import Mesh

CHI2_MONO = 5.991


class DistBAData(NamedTuple):
    """The host-bucketed problem: P_total = D x pts_per_shard and O_total
    = D x obs_per_shard, shard d owning the rows [d per, (d + 1) per)."""
    kf_poses: torch.Tensor   # [C,3,4] replicated
    kf_free: torch.Tensor    # [C]
    pt_xyz: torch.Tensor     # [P_total,3]
    pt_free: torch.Tensor    # [P_total]
    obs_kf: torch.Tensor     # [O_total] keyframe index
    obs_pt: torch.Tensor     # [O_total] landmark index local to its shard
    obs_uv: torch.Tensor     # [O_total,2]
    obs_valid: torch.Tensor  # [O_total]
    obs_is2: torch.Tensor    # [O_total]


def bucket_observations(n_shards: int, n_pts: int, obs_pt: np.ndarray,
                        obs_arrays: Tuple[np.ndarray, ...],
                        pts_arrays: Tuple[np.ndarray, ...]):
    """Host-side: landmarks in contiguous blocks of pts_per_shard, the
    observations relabelled with shard-local landmark indices and padded
    to one size a shard.  Returns (pts_per_shard, obs_per_shard,
    obs_pt_local [O_total], valid [O_total], obs_arrays bucketed,
    pts_arrays padded)."""
    pts_per_shard = -(-n_pts // n_shards)
    P_total = pts_per_shard * n_shards
    shard_of_pt = np.arange(P_total) // pts_per_shard
    local_of_pt = np.arange(P_total) % pts_per_shard
    shard_of_obs = shard_of_pt[obs_pt]
    counts = np.bincount(shard_of_obs, minlength=n_shards)
    obs_per_shard = int(counts.max()) if len(obs_pt) else 1
    O_total = obs_per_shard * n_shards
    order = np.argsort(shard_of_obs, kind="stable")
    out_obs = []
    for arr in obs_arrays:
        out = np.zeros((O_total,) + arr.shape[1:], arr.dtype)
        src = arr[order]
        so = shard_of_obs[order]
        for d in range(n_shards):
            seg = src[so == d]
            out[d * obs_per_shard: d * obs_per_shard + len(seg)] = seg
        out_obs.append(out)
    valid = np.zeros(O_total, bool)
    for d in range(n_shards):
        valid[d * obs_per_shard: d * obs_per_shard + counts[d]] = True
    lp = local_of_pt[obs_pt[order]]
    obs_pt_local = np.zeros(O_total, np.int32)
    for d in range(n_shards):
        seg = lp[shard_of_obs[order] == d]
        obs_pt_local[d * obs_per_shard: d * obs_per_shard + len(seg)] = seg
    out_pts = []
    for arr in pts_arrays:
        out = np.zeros((P_total,) + arr.shape[1:], arr.dtype)
        out[:len(arr)] = arr
        out_pts.append(out)
    return pts_per_shard, obs_per_shard, obs_pt_local, valid, out_obs, out_pts


def _shard(data: DistBAData, g: int, D: int, dev):
    """Shard g's rows of the sharded fields on dev."""
    P = data.pt_xyz.shape[0] // D
    O = data.obs_kf.shape[0] // D
    sl_p, sl_o = slice(g * P, (g + 1) * P), slice(g * O, (g + 1) * O)
    return dict(pt=data.pt_xyz[sl_p].to(dev).contiguous(),
                pt_free=data.pt_free[sl_p].to(dev).contiguous(),
                obs_kf=data.obs_kf[sl_o].to(dev).contiguous(),
                obs_pt=data.obs_pt[sl_o].to(dev).contiguous(),
                obs_uv=data.obs_uv[sl_o].to(dev).contiguous(),
                obs_valid=data.obs_valid[sl_o].to(dev).contiguous(),
                obs_is2=data.obs_is2[sl_o].to(dev).contiguous())


def local_reduce_plain(K, poses, pts, pt_free, obs_kf, obs_pt, obs_uv,
                       obs_valid, obs_is2, lam: float):
    """One shard's undamped partial reduced system (reference
    dist_ba.py:136-184): (H_red [S,S], rhs [S], Dinv, B3, gp)."""
    S = 6 * poses.shape[0]
    Pl = pts.shape[0]
    res_fn = RES.make_point_reproj(K)
    prob = E.Problem()
    prob.add_dense("pose", poses.shape[0], 6, RES.retract_pose_cw)
    prob.add_landmarks("pt", Pl, 3, RES.retract_additive)
    prob.add_term(E.Term(
        name="reproj", res_fn=res_fn, rdim=2,
        dense_refs=[("pose", obs_kf.long())], lm_ref=("pt", obs_pt.long()),
        const={"uv": obs_uv}, mask=obs_valid, info=obs_is2,
        robust_delta=float(np.sqrt(CHI2_MONO))))
    layout, H, g, lm_sys, _, _ = prob.build_normal_equations(
        {"pose": poses, "pt": pts})
    Hpp, gp, B = lm_sys["pt"]
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    occupied = (dpp.sum(-1) > 1e-9) & pt_free
    eye3 = torch.eye(3, dtype=H.dtype, device=H.device)
    floor = 1e-4 * dpp.mean(-1, keepdim=True)
    Hpp_d = Hpp + torch.diag_embed(dpp * lam + floor + 1e-6)
    Hpp_d = torch.where(occupied[:, None, None], Hpp_d, eye3)
    Ffac = E.chol_invT_blocks(Hpp_d)
    blk_ok = torch.isfinite(Ffac).all(-1).all(-1) \
        & (Ffac.abs().amax((-2, -1)) < 1e3)
    occupied = occupied & blk_ok
    Ffac = torch.where(occupied[:, None, None], Ffac, torch.zeros_like(Ffac))
    Dinv = torch.einsum("pij,pkj->pik", Ffac, Ffac)
    B3 = B.reshape(S, Pl, 3)
    G = torch.einsum("spi,pij->spj", B3, Ffac)
    Gm = G.reshape(S, Pl * 3)
    H_red = H - Gm @ Gm.T
    rhs = g - torch.einsum("spj,pj->s", G,
                           torch.einsum("pij,pi->pj", Ffac, gp))
    return H_red, rhs, Dinv, B3, gp


def make_dist_ba(K, mesh: Mesh, n_cams: int, iters: int = 10,
                 lam: float = 1e-3, plain: bool = False,
                 dtype=torch.float32):
    """run(data: DistBAData) -> (kf_poses [C,3,4] on the mesh's first
    device, pt_xyz [n_local x pts_per_shard, 3] of this process's shards).
    A mesh of CPU shards (or `plain`) runs the plain version, a mesh of
    cards the kernel path."""
    kernel = not plain and mesh.first.type == "cuda"

    def run_plain(data: DistBAData):
        D = mesh.size
        free6 = torch.repeat_interleave(data.kf_free.to(mesh.first, dtype), 6)
        poses = data.kf_poses.to(mesh.first, dtype)
        sds = []
        for i, dev in enumerate(mesh.devices):
            sd = _shard(data, mesh.axis_index(i), D, dev)
            sd["pt"] = sd["pt"].to(dtype)
            sd["obs_uv"] = sd["obs_uv"].to(dtype)
            sd["obs_is2"] = sd["obs_is2"].to(dtype)
            sds.append(sd)
        for _ in range(iters):
            pose_l = mesh.replicate(poses)
            parts = [local_reduce_plain(K, pose_l[i], sd["pt"],
                                        sd["pt_free"], sd["obs_kf"],
                                        sd["obs_pt"], sd["obs_uv"],
                                        sd["obs_valid"], sd["obs_is2"], lam)
                     for i, sd in enumerate(sds)]
            H = mesh.psum([p[0] for p in parts])
            rhs = mesh.psum([p[1] for p in parts])
            from ..models.kernels import reduced_solve_plain
            dx = reduced_solve_plain(H, rhs, free6, lam, raw=True, chol=True)
            dxl = mesh.replicate(dx)
            for i, (sd, (_, _, Dinv, B3, gp)) in enumerate(zip(sds, parts)):
                rhs_p = gp - torch.einsum("spi,s->pi", B3, dxl[i])
                dxp = torch.einsum("pij,pj->pi", Dinv, rhs_p) \
                    * sd["pt_free"][:, None].to(dtype)
                sd["pt"] = sd["pt"] + dxp
            poses = RES.retract_pose_cw(poses, dx.reshape(n_cams, 6))
        return poses, torch.cat([sd["pt"].to(mesh.first) for sd in sds])

    def run_kernel(data: DistBAData):
        from ..models import kernels as KN
        works = shard_works(K, data, mesh, lam)
        for _ in range(iters):
            for w in works:
                with torch.cuda.device(w.device):
                    w.linearize(KN.BA_MODE_LINEARIZE)
            parts = [KN.schur_reduce(w, raw=True) for w in works]
            KN.schur_solve_reduced(works, parts, mesh, raw=True, chol=True)
            for w in works:
                w.t["poses"].copy_(w.t["cposes"])
                w.t["pts"].copy_(w.t["cpts"])
        return (works[0].t["poses"].view(n_cams, 3, 4),
                torch.cat([w.t["pts"].to(mesh.first) for w in works]))
    return run_kernel if kernel else run_plain


def shard_works(K, data: DistBAData, mesh: Mesh, lam: float):
    """The kernel path's buffers of every local shard: the point+line
    window BA's work with no lines (models/kernels.py `_BAWork`), its
    damping held at lam."""
    from ..models import kernels as KN
    works = []
    for i, dev in enumerate(mesh.devices):
        sd = _shard(data, mesh.axis_index(i), mesh.size, dev)
        n_cams = data.kf_poses.shape[0]
        S = 6 * n_cams
        with torch.cuda.device(dev):
            w = KN._BAWork(
                K, data.kf_poses.to(dev).contiguous(),
                data.kf_free.to(dev), sd["pt"], sd["pt_free"],
                sd["obs_kf"].int(), sd["obs_pt"].int(), sd["obs_uv"],
                sd["obs_valid"], sd["obs_is2"], *KN.no_lines(dev),
                lam0=lam, early_tol=0.0,
                cg_iters=min(max(S // 2, 16), 128))
            w.t["ctrl"][0] = lam
        works.append(w)
    return works
