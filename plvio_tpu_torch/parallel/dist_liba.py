"""The exact landmark-sharded visual-inertial window BA (port of
plvio_tpu/parallel/dist_liba.py: `DistLIBAData`, `shard_landmarks` :73,
`build_dist_liba` :111, `gather_landmarks` :174, `make_dist_liba` :186,
`_bucket` :286, `DistLIBARunner` :294-417).

The problem of the inertial window BA (per-keyframe 15-DoF states, the
inertial and bias random-walk chain edges, Schur-eliminated point and
line landmarks) on a shard mesh (parallel/mesh.py):

* the keyframe states are replicated on every shard;
* point and line landmarks are dealt round-robin to the shards, and each
  observation lives on its landmark's shard, so each shard eliminates its
  own landmarks exactly;
* the chain's terms (inertial, bias random walks) are masked to shard 0:
  the mesh's sum restores their single contribution;
* one sum of the shards' reduced 15C x 15C systems a GN iteration gives
  the global reduced system, so the step is the single-device one up to
  the damping constant: every shard damps and freezes its own partial
  (the engine's psum_axis), so the sum carries D x 1e-6 and a D diagonal
  on the fixed rows.

`make_dist_liba(...)(data)` runs the plain version (the engine's sharded
LM, `solver/engine.optimize_sharded`) on a mesh of CPU shards, and the
kernel path on a mesh of cards: per shard csrc/ba_linearize.cu (its
observations, the body-frame point and line edges), on shard 0
csrc/inertial_chain.cu, per shard `schur_reduce` (csrc/schur_solve.cu,
engine mode), then `schur_solve_reduced` (the sum in shard order, the CG
solve, each shard's back-substitution).  The LM decisions stay on the
device: each shard's cost is summed by the mesh and every shard decides on
the sum (ba_linearize's mesh modes); an early exit turns every later
launch of the round into an empty one, so the number of mesh sums does not
depend on the data.

`DistLIBARunner` is the mapper's adapter: it pads a window to stable
buckets (C = bucket(n, 8); Pl = bucket(n_pts / D, 32), Ol = bucket(2 n_obs
/ D, 64); lines likewise with 8 / 16) and caches its built solve per
(C, Pl, Ol, Ll, Lo, rounds, iters).  `shard_landmarks` keeps at most Ol
observations a shard and drops the rest, as the reference does; the
runner counts them (`n_dropped`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..solver import engine as E
from ..solver import residuals as RES
from .mesh import Mesh

CHI2_MONO = 5.991


class DistLIBAData(NamedTuple):
    """The sharded problem (host tensors): the leading axis D of the
    sharded fields is the mesh's global shard index; the dense fields are
    replicated (no shard axis)."""
    kf_pose_wb: torch.Tensor    # [C,3,4]
    kf_vel: torch.Tensor        # [C,3]
    kf_bg: torch.Tensor         # [C,3]
    kf_ba: torch.Tensor         # [C,3]
    kf_free: torch.Tensor       # [C]
    kf_free_bias: torch.Tensor  # [C]
    pt_xyz: torch.Tensor        # [D,Pl,3]
    pt_free: torch.Tensor       # [D,Pl]
    obs_kf: torch.Tensor        # [D,Ol]
    obs_pt: torch.Tensor        # [D,Ol] local landmark index
    obs_uv: torch.Tensor        # [D,Ol,2]
    obs_valid: torch.Tensor     # [D,Ol]
    obs_is2: torch.Tensor       # [D,Ol]
    ln_ep: torch.Tensor         # [D,Ll,6]
    ln_free: torch.Tensor       # [D,Ll]
    lobs_kf: torch.Tensor       # [D,Lo]
    lobs_ln: torch.Tensor       # [D,Lo]
    lobs_eq: torch.Tensor       # [D,Lo,3]
    lobs_valid: torch.Tensor    # [D,Lo]
    pre_const: dict             # [C-1,...]
    imu_info: torch.Tensor      # [C-1,9,9]
    edge_valid: torch.Tensor    # [C-1]
    rw_info_g: torch.Tensor     # [C-1]
    rw_info_a: torch.Tensor     # [C-1]


def shard_landmarks(D: int, n_lm: int, obs_lm: np.ndarray,
                    obs_cols: list, lm_cols: list,
                    Pl: int = None, Ol: int = None):
    """Round-robin landmark sharding.  obs_lm: landmark id per
    observation; obs_cols / lm_cols: [(array, fill, dtype), ...].  Pl / Ol
    force the padded table sizes; a shard's observations beyond Ol are
    dropped.  Returns (obs tables [D,Ol,...], local obs_lm, valid, lm
    tables [D,Pl,...], local free, shard_of, local_of)."""
    shard_of = np.arange(n_lm) % D if n_lm else np.zeros(0, np.int64)
    local_of = np.arange(n_lm) // D if n_lm else np.zeros(0, np.int64)
    Pl = Pl or max(-(-n_lm // D), 1)
    s_obs = shard_of[obs_lm] if len(obs_lm) else np.zeros(0, np.int64)
    Ol = Ol or max(int(np.bincount(s_obs, minlength=D).max())
                   if len(s_obs) else 1, 1)
    obs_out = [np.full((D, Ol) + a.shape[1:], fill, dtype)
               for a, fill, dtype in obs_cols]
    obs_lm_out = np.zeros((D, Ol), np.int32)
    valid = np.zeros((D, Ol), bool)
    for d in range(D):
        sel = np.nonzero(s_obs == d)[0][:Ol]
        k = len(sel)
        for o, (a, _, _) in zip(obs_out, obs_cols):
            o[d, :k] = a[sel]
        obs_lm_out[d, :k] = local_of[obs_lm[sel]]
        valid[d, :k] = True
    lm_out = [np.full((D, Pl) + a.shape[1:], fill, dtype)
              for a, fill, dtype in lm_cols]
    lm_free = np.zeros((D, Pl), bool)
    for d in range(D):
        sel = np.nonzero(shard_of == d)[0]
        for o, (a, _, _) in zip(lm_out, lm_cols):
            o[d, :len(sel)] = a[sel]
        lm_free[d, :len(sel)] = True
    return obs_out, obs_lm_out, valid, lm_out, lm_free, shard_of, local_of


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(D, pt_xyz, obs_kf, obs_pt, obs_uv, obs_is2, lobs_kf, lobs_ln,
            lobs_eq, ln_ep, Pl=None, Ol=None, Ll=None, Lo=None):
    """The sharded point and line tables and the layout (shard_landmarks
    on each family; one padded empty line a shard without lines)."""
    (obs_tabs, obs_pt_l, ovalid, lm_tabs, pt_free_l, sp, lp) = \
        shard_landmarks(
            D, len(pt_xyz), obs_pt,
            [(obs_kf.astype(np.int32), 0, np.int32),
             (obs_uv.astype(np.float32), 0, np.float32),
             (obs_is2.astype(np.float32), 1, np.float32)],
            [(pt_xyz.astype(np.float32), 0, np.float32)], Pl=Pl, Ol=Ol)
    okf_t, ouv_t, ois_t = obs_tabs
    (pt_t,) = lm_tabs
    have_lines = ln_ep is not None and len(ln_ep) > 0 \
        and lobs_kf is not None and len(lobs_kf) > 0
    if have_lines:
        (ltabs, lln_l, lvalid, lntabs, ln_free_l, spl, lpl) = \
            shard_landmarks(
                D, len(ln_ep), lobs_ln,
                [(lobs_kf.astype(np.int32), 0, np.int32),
                 (lobs_eq.astype(np.float32), 0, np.float32)],
                [(ln_ep.astype(np.float32), 0, np.float32)], Pl=Ll, Ol=Lo)
        lkf_t, leq_t = ltabs
        (ln_t,) = lntabs
        dropped_l = len(lobs_kf) - int(lvalid.sum())
    else:
        lkf_t = np.zeros((D, 1), np.int32)
        leq_t = np.zeros((D, 1, 3), np.float32)
        lln_l = np.zeros((D, 1), np.int32)
        lvalid = np.zeros((D, 1), bool)
        ln_t = np.zeros((D, 1, 6), np.float32)
        ln_free_l = np.zeros((D, 1), bool)
        spl = lpl = None
        dropped_l = 0
    layout = {"D": D, "shard_of_pt": sp, "local_of_pt": lp,
              "shard_of_ln": spl, "local_of_ln": lpl,
              "have_lines": have_lines,
              "dropped_obs": len(obs_kf) - int(ovalid.sum()),
              "dropped_lobs": dropped_l}
    tabs = dict(pt_xyz=_t(pt_t), pt_free=_t(pt_free_l), obs_kf=_t(okf_t),
                obs_pt=_t(obs_pt_l), obs_uv=_t(ouv_t), obs_valid=_t(ovalid),
                obs_is2=_t(ois_t), ln_ep=_t(ln_t), ln_free=_t(ln_free_l),
                lobs_kf=_t(lkf_t), lobs_ln=_t(lln_l), lobs_eq=_t(leq_t),
                lobs_valid=_t(lvalid))
    return tabs, layout


def build_dist_liba(D: int, pose_wb, vel, bg, ba, kf_free, kf_free_bias,
                    obs_kf, obs_pt, obs_uv, obs_is2, pt_xyz,
                    pre_stack, imu_info, edge_valid, rw_g, rw_a,
                    lobs_kf=None, lobs_ln=None, lobs_eq=None,
                    ln_ep=None):
    """Host-side builder (numpy inputs; indices are chain positions
    0..C-1).  Returns (DistLIBAData, layout); layout's `dropped_obs` /
    `dropped_lobs` count the observations no shard kept."""
    tabs, layout = _tables(D, pt_xyz, obs_kf, obs_pt, obs_uv, obs_is2,
                           lobs_kf, lobs_ln, lobs_eq, ln_ep)
    f32 = np.float32
    data = DistLIBAData(
        kf_pose_wb=_t(np.asarray(pose_wb, f32)), kf_vel=_t(np.asarray(vel, f32)),
        kf_bg=_t(np.asarray(bg, f32)), kf_ba=_t(np.asarray(ba, f32)),
        kf_free=_t(np.asarray(kf_free, bool)),
        kf_free_bias=_t(np.asarray(kf_free_bias, bool)),
        pre_const={k: _t(np.asarray(v, f32)) for k, v in pre_stack.items()},
        imu_info=_t(np.asarray(imu_info, f32)),
        edge_valid=_t(np.asarray(edge_valid, bool)),
        rw_info_g=_t(np.asarray(rw_g, f32)),
        rw_info_a=_t(np.asarray(rw_a, f32)), **tabs)
    return data, layout


def gather_landmarks(layout, pts_out, lns_out=None, n_pts=0, n_lns=0):
    """The sharded landmark outputs [D,Pl,3] / [D,Ll,6] (numpy) back in
    landmark order."""
    pts = np.zeros((n_pts, 3), np.float32)
    if n_pts:
        pts = np.asarray(pts_out)[layout["shard_of_pt"],
                                  layout["local_of_pt"]]
    lns = None
    if n_lns and layout["have_lines"]:
        lns = np.asarray(lns_out)[layout["shard_of_ln"],
                                  layout["local_of_ln"]]
    return pts, lns


def _problem(K, Rcb, tcb, gravity, C, Pl, Ll, Lo, sd, mask, mask_l):
    """One shard's partial problem (reference dist_liba.py:227-260)."""
    delta = float(np.sqrt(CHI2_MONO))
    dev = sd["obs_kf"].device
    idx1 = torch.arange(C - 1, device=dev)
    idx2 = idx1 + 1
    prob = E.Problem(linear_solver="cg")
    prob.add_dense("pose", C, 6, RES.retract_pose_wb)
    prob.add_dense("vel", C, 3, RES.retract_additive)
    prob.add_dense("bg", C, 3, RES.retract_additive)
    prob.add_dense("ba", C, 3, RES.retract_additive)
    prob.add_landmarks("pt", Pl, 3, RES.retract_additive)
    prob.add_landmarks("ln", Ll, 6, RES.retract_additive)
    prob.add_term(E.Term(
        name="reproj", res_fn=RES.point_reproj_body_ba_for(K, Rcb, tcb),
        rdim=2, dense_refs=[("pose", sd["obs_kf"])],
        lm_ref=("pt", sd["obs_pt"]), const={"uv": sd["obs_uv"]}, mask=mask,
        info=sd["obs_is2"], robust_delta=delta))
    prob.add_term(E.Term(
        name="line", res_fn=RES.make_line_reproj_body_ba(K, Rcb, tcb),
        rdim=2, dense_refs=[("pose", sd["lobs_kf"])],
        lm_ref=("ln", sd["lobs_ln"]), const={"l": sd["lobs_eq"]},
        mask=mask_l, info=torch.ones(Lo, dtype=Rcb.dtype, device=dev),
        robust_delta=delta))
    prob.add_term(E.Term(
        name="inertial", res_fn=RES.make_inertial(gravity), rdim=9,
        dense_refs=[("pose", idx1), ("vel", idx1), ("bg", idx1),
                    ("ba", idx1), ("pose", idx2), ("vel", idx2)],
        const=sd["pre"], mask=sd["ev"], info=sd["imu_info"]))
    prob.add_term(E.Term(name="bg_rw", res_fn=RES.bias_rw, rdim=3,
                         dense_refs=[("bg", idx1), ("bg", idx2)],
                         mask=sd["ev"], info=sd["rw_g"]))
    prob.add_term(E.Term(name="ba_rw", res_fn=RES.bias_rw, rdim=3,
                         dense_refs=[("ba", idx1), ("ba", idx2)],
                         mask=sd["ev"], info=sd["rw_a"]))
    return prob


_SHARDED = ("pt_xyz", "pt_free", "obs_kf", "obs_pt", "obs_uv", "obs_valid",
            "obs_is2", "ln_ep", "ln_free", "lobs_kf", "lobs_ln", "lobs_eq",
            "lobs_valid")


def local_shards(data: DistLIBAData, mesh: Mesh, dtype=torch.float32):
    """Per local shard, its tables and the replicated fields on its device
    (floats in dtype), the chain's edges masked to global shard 0."""
    out = []
    for i, dev in enumerate(mesh.devices):
        g = mesh.axis_index(i)

        def mv(x):
            x = x.to(dev)
            return x.to(dtype) if x.is_floating_point() else x
        sd = {k: mv(getattr(data, k)[g]).contiguous() for k in _SHARDED}
        sd.update(pose=mv(data.kf_pose_wb), vel=mv(data.kf_vel),
                  bg=mv(data.kf_bg), ba=mv(data.kf_ba),
                  free=mv(data.kf_free), free_b=mv(data.kf_free_bias),
                  pre={k: mv(v) for k, v in data.pre_const.items()},
                  imu_info=mv(data.imu_info), rw_g=mv(data.rw_info_g),
                  rw_a=mv(data.rw_info_a),
                  ev=mv(data.edge_valid) & (g == 0))
        out.append(sd)
    return out


def make_dist_liba(K, mesh: Mesh, C: int, Pl: int, Ol: int, Ll: int,
                   Lo: int, Rcb, tcb, gravity: float, rounds: int = 2,
                   iters: int = 8, early_tol: float = 1e-2,
                   plain: bool = False, dtype=torch.float32):
    """The exact sharded VI window BA.  run(data, stats=None) -> (pose,
    vel, bg, ba [replicated, on the mesh's first device], pt [n_local,Pl,3],
    ln [n_local,Ll,6]) (this process's shards).  A mesh of CPU shards (or
    `plain`) runs the plain version, a mesh of cards the kernel path;
    `stats` (a list) gets each round's LM iterations."""
    dt = dtype
    Rcb = torch.as_tensor(np.asarray(Rcb, np.float32))
    tcb = torch.as_tensor(np.asarray(tcb, np.float32))
    kernel = not plain and mesh.first.type == "cuda"
    if kernel and dtype != torch.float32:
        raise ValueError("the kernel path runs in float32")

    def run_plain(data: DistLIBAData, stats=None):
        sds = local_shards(data, mesh, dt)
        states = [{"pose": sd["pose"], "vel": sd["vel"], "bg": sd["bg"],
                   "ba": sd["ba"], "pt": sd["pt_xyz"], "ln": sd["ln_ep"]}
                  for sd in sds]
        free = [{"pose": sd["free"], "vel": sd["free"], "bg": sd["free_b"],
                 "ba": sd["free_b"]} for sd in sds]
        lm_free = [{"pt": sd["pt_free"], "ln": sd["ln_free"]} for sd in sds]
        masks = [(sd["obs_valid"], sd["lobs_valid"]) for sd in sds]
        for _ in range(rounds):
            probs = [_problem(K, Rcb.to(sd["pose"]), tcb.to(sd["pose"]),
                              gravity, C, Pl, Ll, Lo, sd, m, ml)
                     for sd, (m, ml) in zip(sds, masks)]
            states, _, chi2s = E.optimize_sharded(
                mesh, probs, states, iters=iters, early_tol=early_tol,
                dense_free_mask=free, lm_free_mask=lm_free, stats=stats)
            masks = [(sd["obs_valid"] & (c["reproj"] < CHI2_MONO),
                      sd["lobs_valid"] & (c["line"] < CHI2_MONO))
                     for sd, c in zip(sds, chi2s)]
        st0 = states[0]
        return (st0["pose"], st0["vel"], st0["bg"], st0["ba"],
                torch.stack([s["pt"].to(mesh.first) for s in states]),
                torch.stack([s["ln"].to(mesh.first) for s in states]))

    def run_kernel(data: DistLIBAData, stats=None):
        works = shard_works(K, Rcb, tcb, gravity, data, mesh, early_tol)
        dist_liba_rounds(works, mesh, rounds, iters, stats)
        w0 = works[0].t
        kfx = w0["kfx"]
        return (w0["poses"].view(C, 3, 4), kfx[:, 0:3].contiguous(),
                kfx[:, 3:6].contiguous(), kfx[:, 6:9].contiguous(),
                torch.stack([w.t["pts"].to(mesh.first) for w in works]),
                torch.stack([w.t["lns"].to(mesh.first) for w in works]))
    return run_kernel if kernel else run_plain


def shard_works(K, Rcb, tcb, gravity, data: DistLIBAData, mesh: Mesh,
                early_tol: float = 1e-2):
    """The kernel path's buffers of every local shard (models/kernels.py
    `inertial_work`, the chain's edges masked off every shard but 0)."""
    from ..models import kernels as KN
    works = []
    for sd in local_shards(data, mesh):
        with torch.cuda.device(sd["pose"].device):
            works.append(KN.inertial_work(
                K, Rcb, tcb, gravity, sd["pose"], sd["vel"], sd["bg"],
                sd["ba"], sd["free"], sd["free_b"], sd["pt_xyz"],
                sd["pt_free"], sd["obs_kf"], sd["obs_pt"], sd["obs_uv"],
                sd["obs_valid"], sd["obs_is2"], sd["pre"], sd["imu_info"],
                sd["ev"], sd["rw_g"], sd["rw_a"], sd["ln_ep"],
                sd["ln_free"], sd["lobs_kf"], sd["lobs_ln"], sd["lobs_eq"],
                sd["lobs_valid"], early_tol=early_tol))
    return works


def mesh_cost(works, mesh: Mesh) -> None:
    """The mesh's sum of the shards' partial costs (ctrl[2]) into every
    shard's `mcost`."""
    tot = mesh.psum([w.t["ctrl"][2:3] for w in works])
    for w in works:
        w.t["mcost"].copy_(tot)


def dist_liba_rounds(works, mesh: Mesh, rounds: int, iters: int,
                     stats=None) -> None:
    """The kernel path's LM rounds over the shards' works: the reference's
    `rounds` x `iters` with its early exit and chi2 re-gate, every decision
    taken on the device from the mesh's summed cost."""
    from ..models import kernels as KN
    chain0 = works[0] if mesh.offset == 0 else None

    def each(fn):
        for w in works:
            with torch.cuda.device(w.device):
                fn(w)
    for _ in range(rounds):
        if chain0 is not None:
            chain0.chain(KN.CHAIN_COST_STATE)
        each(lambda w: w.linearize(KN.BA_MODE_PARTIAL_STATE))
        mesh_cost(works, mesh)
        each(lambda w: w.linearize(KN.BA_MODE_MESH_INIT))
        for _ in range(iters):
            each(lambda w: w.linearize(KN.BA_MODE_LINEARIZE))
            if chain0 is not None:
                chain0.chain(KN.CHAIN_LINEARIZE)
            parts = []
            each(lambda w: parts.append(KN.schur_reduce(w)))
            KN.schur_solve_reduced(works, parts, mesh)
            if chain0 is not None:
                chain0.chain(KN.CHAIN_COST_CAND)
            each(lambda w: w.linearize(KN.BA_MODE_PARTIAL_CAND))
            mesh_cost(works, mesh)
            each(lambda w: w.linearize(KN.BA_MODE_MESH_DECIDE))
        if chain0 is not None:
            chain0.chain(KN.CHAIN_COST_STATE)
        each(lambda w: w.linearize(KN.BA_MODE_REGATE))
        if stats is not None:
            stats.append(works[0].t["ctrl"][4].clone())


def _bucket(n: int, base: int = 64) -> int:
    """Round up to a stable bucket (power-of-two-ish)."""
    b = base
    while b < n:
        b *= 2
    return b


class DistLIBARunner:
    """The mapper's adapter: pads every window to stable buckets and
    caches the built solve per (C, Pl, Ol, Ll, Lo, rounds, iters).
    `n_solves` counts the solves, `n_dropped` the point and line
    observations `shard_landmarks` dropped over all of them."""

    def __init__(self, K, Rcb, tcb, gravity: float, mesh: Mesh = None,
                 device="cuda", plain: bool = False,
                 dtype=torch.float32):
        if mesh is None:
            from .mesh import default_mesh
            mesh = default_mesh(device) or Mesh([device])
        self.K = K
        self.mesh = mesh
        self.D = mesh.size
        self.Rcb = np.asarray(Rcb, np.float32)
        self.tcb = np.asarray(tcb, np.float32)
        self.gravity = float(gravity)
        self.plain = plain
        self.dtype = dtype
        self._cache = {}
        self.n_solves = 0
        self.n_dropped = 0
        self.last_stats: list = []

    def solve(self, pose_wb, vel, bg, ba, kf_free, kf_free_bias,
              obs_kf, obs_pt, obs_uv, obs_is2, pt_xyz,
              pre_stack, imu_info, edge_valid, rw_g, rw_a,
              lobs_kf=None, lobs_ln=None, lobs_eq=None, ln_ep=None,
              rounds: int = 2, iters: int = 8):
        """All inputs unpadded numpy, chain indices 0..C-1.  Returns
        numpy (pose_wb, vel, bg, ba [n..], pt_xyz [n_pts,3], ln_ep or
        None)."""
        data, layout, run = self.prepare(
            pose_wb, vel, bg, ba, kf_free, kf_free_bias, obs_kf, obs_pt,
            obs_uv, obs_is2, pt_xyz, pre_stack, imu_info, edge_valid, rw_g,
            rw_a, lobs_kf, lobs_ln, lobs_eq, ln_ep, rounds, iters)
        self.last_stats = []
        pose_o, vel_o, bg_o, ba_o, pt_o, ln_o = run(data,
                                                    stats=self.last_stats)
        self.n_solves += 1
        n = len(pose_wb)
        pts, lns = gather_landmarks(
            layout, _np(pt_o), _np(ln_o), n_pts=len(pt_xyz),
            n_lns=len(ln_ep) if layout["have_lines"] else 0)
        return (_np(pose_o)[:n], _np(vel_o)[:n], _np(bg_o)[:n],
                _np(ba_o)[:n], pts, lns)

    def prepare(self, pose_wb, vel, bg, ba, kf_free, kf_free_bias, obs_kf,
                obs_pt, obs_uv, obs_is2, pt_xyz, pre_stack, imu_info,
                edge_valid, rw_g, rw_a, lobs_kf=None, lobs_ln=None,
                lobs_eq=None, ln_ep=None, rounds: int = 2, iters: int = 8):
        """`solve`'s padding and sharding: (DistLIBAData, layout, the
        cached run of its bucket); counts the dropped observations."""
        n = len(pose_wb)
        C = _bucket(n, 8)
        n_pts = len(pt_xyz)

        def padc(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((C,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        pose_p = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
        pose_p[:n] = pose_wb
        free_p = np.zeros(C, bool)
        free_p[:n] = kf_free
        freeb_p = np.zeros(C, bool)
        freeb_p[:n] = kf_free_bias
        pre_p = {k: np.zeros((C - 1,) + np.asarray(v).shape[1:], np.float32)
                 for k, v in pre_stack.items()}
        for k, v in pre_stack.items():
            pre_p[k][:n - 1] = np.asarray(v)[:n - 1]
        info_p = np.tile(np.eye(9, dtype=np.float32), (C - 1, 1, 1))
        info_p[:n - 1] = imu_info[:n - 1]
        ev_p = np.zeros(C - 1, bool)
        ev_p[:n - 1] = edge_valid[:n - 1]
        rwg_p = np.zeros(C - 1, np.float32)
        rwg_p[:n - 1] = rw_g[:n - 1]
        rwa_p = np.zeros(C - 1, np.float32)
        rwa_p[:n - 1] = rw_a[:n - 1]

        Pl = _bucket(-(-max(n_pts, 1) // self.D), 32)
        Ol = _bucket(-(-max(len(obs_kf), 1) // self.D) * 2, 64)
        have_lines = ln_ep is not None and len(ln_ep) > 0 \
            and lobs_kf is not None and len(lobs_kf) > 0
        if have_lines:
            Ll = _bucket(-(-len(ln_ep) // self.D), 8)
            Lo = _bucket(-(-len(lobs_kf) // self.D) * 2, 16)
        else:
            Ll = Lo = 1
        tabs, layout = _tables(self.D, pt_xyz, obs_kf, obs_pt, obs_uv,
                               obs_is2, lobs_kf, lobs_ln, lobs_eq,
                               ln_ep if have_lines else None,
                               Pl=Pl, Ol=Ol, Ll=Ll, Lo=Lo)
        self.n_dropped += layout["dropped_obs"] + layout["dropped_lobs"]
        data = DistLIBAData(
            kf_pose_wb=_t(pose_p), kf_vel=_t(padc(vel).astype(np.float32)),
            kf_bg=_t(padc(bg).astype(np.float32)),
            kf_ba=_t(padc(ba).astype(np.float32)), kf_free=_t(free_p),
            kf_free_bias=_t(freeb_p),
            pre_const={k: _t(v) for k, v in pre_p.items()},
            imu_info=_t(info_p), edge_valid=_t(ev_p), rw_info_g=_t(rwg_p),
            rw_info_a=_t(rwa_p), **tabs)
        key = (C, Pl, Ol, Ll, Lo, rounds, iters)
        run = self._cache.get(key)
        if run is None:
            run = make_dist_liba(self.K, self.mesh, C, Pl, Ol, Ll, Lo,
                                 self.Rcb, self.tcb, self.gravity,
                                 rounds=rounds, iters=iters,
                                 plain=self.plain, dtype=self.dtype)
            self._cache[key] = run
        return data, layout, run


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
