"""Loop closing and map merging (port of plvio_tpu/models/loop_closing.py:
`LoopCloser.__init__` :38, `process_keyframe` :88, `_try_merge` :123,
`_cooldown_group` :161, `_detect` :169, `_verify_sim3` :224,
`_refine_sim3_reproj` :297, `_umeyama` :390, `_refine_sim3_guided` :410,
`_inertial_gate` :482, `_correct_loop` :502, `_essential_graph` :556,
`run_global_ba` :776, `_run_gba_chained` :795, `_gba_block` :822,
`_merge_maps` :980 and `_fuse_duplicates` :1042).

Per keyframe: the cross-map merge sweep (from 5 keyframes), then, from 12,
BoW retrieval outside the covisible group and the temporal neighbourhood,
3-vote temporal consistency, Sim3 verification (descriptor matches of the
two keyframes' map points, Sim3 RANSAC, the guided 3D refinement and the
reprojection polish), the inertial gate, and the correction: the window
welded under the similarity, the essential graph (Sim3, or 4-DoF on an
inertial map) over the keyframe chain, subsampled beyond `pg_kf_cap`, and
the global BA (the full inertial BA on an inertial map).  A merge
re-expresses the active map in the candidate map's frame, appends it,
fuses duplicated points around the weld and runs the weld BA.

The host bookkeeping is the reference's numpy, line for line (the
stratified observation subsample with `np.random.default_rng(0)`
included); the device calls are the port's kernels: the ungated ratio
match (`hamming_match`'s window mode at an infinite radius), the Hamming
distance matrices (`hamming_match`'s matrix mode, `ops.matching.
hamming_dist`), `sim3_ransac` and `sim3_reproj` (csrc/sim3.cu), the
essential graph (csrc/pose_graph.cu, the graph compacted to the chain's
anchors) and the global BA (`make_local_ba_pl` / `make_local_ba` at the
reference's capacities: 128 keyframes, S = 768, on schur_solve's global
path; with a KB8 camera its point edge is the lens's on raw pixels,
`ba_linearize`'s KB8 mode).  `plain=True` runs the plain versions on any
device.

The RANSAC samples of each verification come from the closer's
`torch.Generator` (seeded with cfg.seed + 7, one draw per verification as
the reference splits its key), or from `sim3_sampler(valid)` -> [64, 3]
indices where the caller gives one.  The reference's PLVIO_TRACE prints
are counters of `metrics` here ("loop/...", "merge/...", "sim3/reject/
<why>", "gba/..."); `last_verify` holds the last verification's numbers
and `last_graph` the last essential graph's size and solve path.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..cuda import HostIO, resolve_device
from ..ops import matching as M
from ..ops import pnp as PNP
from ..ops import twoview as TV
from ..solver.residuals import PinholeK, kb8_for
from ..utils import lie
from ..utils.metrics import Metrics
from . import kernels as KN
from .mapstore import INVALID, Atlas, MapStore

RANSAC_ITERS = 64      # Sim3 hypotheses a verification (ops/pnp.py:165)
RANSAC_PAD = 256       # matched points handed to the RANSAC


def _so3_log(R: np.ndarray) -> np.ndarray:
    return lie.so3_log(torch.from_numpy(
        np.ascontiguousarray(R, np.float32))).numpy()


class LoopCloser(HostIO):
    def __init__(self, cfg: SystemConfig, atlas: Atlas, kfdb, n_feat: int,
                 pg_kf_cap: int = 512, pg_edge_cap: int = 4096,
                 gba_obs_cap: int = 32768, device="cuda",
                 plain: bool = False, sim3_sampler=None):
        self.cfg = cfg
        self.atlas = atlas
        self.kfdb = kfdb
        self.n_feat = n_feat
        self.device = resolve_device(device)
        self.plain = plain
        self.host_syncs = 0
        cam = cfg.camera
        self.K = PinholeK(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        # the KB8 fisheye: the global BA runs the lens on raw pixels (the
        # Sim3 steps stay on undistorted coordinates)
        self.kb8 = kb8_for(cfg)
        self.ba_K = self.K if self.kb8 is None else self.kb8
        self.pg_kf_cap = pg_kf_cap
        self.pg_edge_cap = pg_edge_cap
        self.pose_graph = KN.make_pose_graph_optimizer(
            pg_kf_cap, pg_edge_cap, plain=plain)
        self.pose_graph_4dof = KN.make_pose_graph_optimizer(
            pg_kf_cap, pg_edge_cap, four_dof=True, plain=plain)
        self._match = M.hamming_match_plain if plain else M.hamming_match
        self._dist = M.hamming_dist_plain if plain else M.hamming_dist
        self._ransac = PNP.sim3_ransac_plain if plain else PNP.sim3_ransac
        self._sim3_reproj_kernels = {}
        self.gba_kernel = None
        self.gba_pl_kernel = None
        self._gba_caps = (128, 8192, gba_obs_cap)
        self.mapper = None      # System wires its LocalMapper
        self.consistency: List[tuple] = []   # (candidate group, votes)
        self.merge_votes = {}                # map_id -> consecutive hits
        self.pending_merge = None            # popped by System
        self.generator = torch.Generator().manual_seed(cfg.seed + 7)
        self.sim3_sampler = sim3_sampler
        self.n_loops_closed = 0
        self.n_maps_merged = 0
        self.n_verifications = 0
        # candidates that recently failed verification: {kf: ttl}
        self._failed_cands: dict = {}
        # accumulated loop edges per map, kept in every later graph
        self._loop_edges: dict = {}     # map_id -> [(kf, cand)]
        self.metrics = Metrics()
        self.last_verify: Optional[dict] = None
        self.last_graph: Optional[dict] = None

    @property
    def map(self) -> MapStore:
        return self.atlas.current

    def _hamming(self, da: np.ndarray, db: np.ndarray) -> np.ndarray:
        """The Hamming distance matrix of two packed descriptor sets."""
        return self._host(self._dist(self._dev(da), self._dev(db)))

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int) -> bool:
        """True when a loop was closed or a map merged."""
        m = self.map
        if m.n_kf >= 5 and self._try_merge(kf):
            return True
        if m.n_kf < 12:
            return False
        cand = self._detect(kf)
        if cand is None:
            return False
        ok, s, R, t = self._verify_sim3(kf, cand)
        if not ok:
            # candidate-level cooldown: a self-similar hall would re-run
            # the verification on the same aliased area every keyframe
            self._cooldown_group(cand)
            return False
        ok, s, R, t = self._inertial_gate(s, R, t, m)
        if not ok:
            self._cooldown_group(cand)
            return False
        self._correct_loop(kf, cand, s, R, t)
        self.n_loops_closed += 1
        return True

    # ------------------------------------------------------------------
    def _try_merge(self, kf: int) -> bool:
        """Cross-map candidates, 2-vote consistency, Sim3 verification and
        the merge."""
        if not hasattr(self.kfdb, "query_other_maps"):
            return False
        m = self.map
        if len(self.atlas.maps) < 2:
            return False
        cands = self.kfdb.query_other_maps(
            m.kf_feat_desc[kf], m.kf_feat_valid[kf], m.map_id, top_n=3)
        hit_maps = {mid for mid, _, _ in cands}
        self.merge_votes = {mid: self.merge_votes.get(mid, 0) + 1
                            for mid in hit_maps}
        if cands:
            self.metrics.bump("merge/candidates", len(cands))
        for mid, cand, score in cands:
            if self.merge_votes.get(mid, 0) < 2:
                continue
            m_old = next(mm for mm in self.atlas.maps if mm.map_id == mid)
            ok, s, R, t = self._verify_sim3(kf, cand, m2=m_old)
            self.metrics.bump("merge/verify_ok" if ok else "merge/reject")
            if not ok:
                continue
            if m.imu_initialized and m_old.imu_initialized:
                ok, s, R, t = self._inertial_gate(s, R, t, m)
                if not ok:
                    continue
            self._merge_maps(kf, cand, m_old, s, R, t)
            self.merge_votes = {}
            self.n_maps_merged += 1
            return True
        return False

    def _cooldown_group(self, cand: int) -> None:
        self._failed_cands[int(cand)] = 8

    # ------------------------------------------------------------------
    def _detect(self, kf: int) -> Optional[int]:
        """BoW retrieval excluding the covisible group and the temporal
        neighbourhood, 3-vote temporal consistency."""
        m = self.map
        exclude = np.zeros(m.max_kf, bool)
        exclude[kf] = True
        covis_group = np.nonzero(m.covis[kf] >= 15)[0]
        exclude[covis_group] = True
        chain = m.kf_chain()
        pos = np.nonzero(chain == kf)[0]
        if len(pos):
            lo = max(0, int(pos[0]) - 10)
            exclude[chain[lo:]] = True
        cands, scores = self.kfdb.query_grouped(
            m.kf_feat_desc[kf], m.kf_feat_valid[kf], m.covis, m.kf_valid,
            exclude=exclude, top_n=3,
            line_desc=m.kf_line_desc[kf] if self.cfg.use_lines else None,
            line_valid=m.kf_line_valid[kf] if self.cfg.use_lines else None)
        self.metrics.bump("loop/detect")
        if len(cands) == 0:
            self.consistency = []
            return None
        self._failed_cands = {c: ttl - 1
                              for c, ttl in self._failed_cands.items()
                              if ttl > 1}
        new_consistency = []
        fired = None
        for c in cands:
            group = set(np.nonzero(m.covis[c] >= 15)[0].tolist()) | {int(c)}
            votes = 1
            for prev_group, prev_votes in self.consistency:
                if group & prev_group:
                    votes = prev_votes + 1
                    break
            new_consistency.append((group, votes))
            cooled = int(c) in self._failed_cands
            if votes >= 3 and fired is None and not cooled:
                fired = int(c)
        self.consistency = new_consistency
        return fired

    # ------------------------------------------------------------------
    def _reject(self, why: str):
        self.metrics.bump(f"sim3/reject/{why}")
        self.last_verify["rejected"] = why
        return False, None, None, None

    def _samples(self, valid: np.ndarray) -> torch.Tensor:
        if self.sim3_sampler is not None:
            return torch.as_tensor(np.array(self.sim3_sampler(valid)))
        return TV.sample_indices(torch.from_numpy(valid), RANSAC_ITERS, 3,
                                 self.generator)

    def _verify_sim3(self, kf: int, cand: int, m2: MapStore = None):
        """Descriptor matches of kf's and cand's map points (cand in this
        map, or in m2 for a merge), Sim3 RANSAC, the guided refinement and
        the reprojection polish.  (ok, s, R, t) with X2 ~ s R X1 + t
        taking current-map coordinates into cand's map."""
        m = self.map
        if m2 is None:
            m2 = m
        self.last_verify = dict(kf=int(kf), cand=int(cand))

        def kf_points(store, k):
            match = store.kf_match_pt[k]
            feat = np.nonzero(match >= 0)[0]
            return feat, match[feat]
        f1, p1 = kf_points(m, kf)
        f2, p2 = kf_points(m2, cand)
        if len(f1) < 20 or len(f2) < 20:
            return self._reject("few-bound")
        dev = self.device
        idx, ok = self._match(
            self._dev(m.kf_feat_desc[kf][f1]),
            self._dev(m2.kf_feat_desc[cand][f2]),
            torch.ones(len(f1), dtype=torch.bool, device=dev),
            torch.ones(len(f2), dtype=torch.bool, device=dev),
            torch.zeros(len(f1), 2, dtype=torch.float32, device=dev),
            torch.zeros(len(f2), 2, dtype=torch.float32, device=dev),
            radius=math.inf, max_dist=60.0, ratio=0.85)
        ok_np, idx_np = self._host_many(ok, idx)
        self.last_verify["matches"] = int(ok_np.sum())
        if ok_np.sum() < 15:
            return self._reject("few-matches")
        X1 = m.pt_xyz[p1[ok_np]]
        X2 = m2.pt_xyz[p2[idx_np[ok_np]]]
        pad = RANSAC_PAD
        Xp1 = np.zeros((pad, 3), np.float32)
        Xp2 = np.zeros((pad, 3), np.float32)
        nv = min(len(X1), pad)
        Xp1[:nv] = X1[:nv]
        Xp2[:nv] = X2[:nv]
        valid = np.zeros(pad, bool)
        valid[:nv] = True
        samples = self._samples(valid)
        fix_scale = self.cfg.sensor in (1, 2, 4) or m.imu_initialized
        self.n_verifications += 1
        self.metrics.bump("sim3/verify")
        r = self._ransac(self._dev(Xp1), self._dev(Xp2), self._dev(valid),
                         samples.to(dev), th=0.08, fix_scale=fix_scale)
        s, R, t, n, best = self._host_many(r.s, r.R, r.t, r.n, r.best)
        self.last_verify.update(ransac_inliers=int(n), ransac_best=int(best))
        if int(n) < 12:
            return self._reject("ransac-inliers")
        s = float(s)
        if not (0.5 < s < 2.0):
            return self._reject("scale")
        s, R, t, n_ref = self._refine_sim3_guided(
            kf, cand, m2, s, np.asarray(R), np.asarray(t), fix_scale)
        self.last_verify["refine_inliers"] = int(n_ref)
        if n_ref < 20:
            return self._reject("refine-inliers")
        if not (0.5 < s < 2.0):
            return self._reject("refine-scale")
        s, R, t = self._refine_sim3_reproj(kf, cand, m2, s, np.asarray(R),
                                           np.asarray(t), fix_scale)
        if not (0.5 < s < 2.0):
            return self._reject("reproj-scale")
        self.last_verify.update(s=float(s))
        return True, s, np.asarray(R), np.asarray(t)

    def _refine_sim3_reproj(self, kf: int, cand: int, m2: MapStore,
                            s: float, R: np.ndarray, t: np.ndarray,
                            fix_scale: bool, cap: int = 256):
        """The welding Sim3 refined on 2D reprojection residuals in both
        keyframes (`sim3_reproj`), on the descriptor-matched bound points
        of the two keyframes 3D-gated under the current similarity.
        Returns the inputs when matching is too thin or the refinement
        keeps fewer than 20 inliers."""
        m = self.map

        def side(store, k):
            match = store.kf_match_pt[k]
            feat = np.nonzero(match >= 0)[0]
            pts = match[feat]
            keep = store.pt_valid[pts]
            return feat[keep], pts[keep]

        f1, p1 = side(m, kf)
        f2, p2 = side(m2, cand)
        if len(f1) < 15 or len(f2) < 15:
            return s, R, t
        ham = self._hamming(m.kf_feat_desc[kf][f1],
                            m2.kf_feat_desc[cand][f2])
        X1_all = m.pt_xyz[p1].astype(np.float64)
        X2_all = m2.pt_xyz[p2].astype(np.float64)
        Y = s * X1_all @ R.T + t
        dist2 = ((Y ** 2).sum(1)[:, None] + (X2_all ** 2).sum(1)[None]
                 - 2.0 * Y @ X2_all.T)
        R_cw = m.kf_pose_cw[kf, :, :3]
        c_w = -R_cw.T @ m.kf_pose_cw[kf, :, 3]
        scene = float(np.median(np.linalg.norm(X1_all - c_w, axis=1)))
        if not np.isfinite(scene) or scene <= 0:
            scene = 5.0
        gate = (0.05 * scene) ** 2
        cost = np.where((dist2 < gate) & (ham <= 60.0), ham + dist2, np.inf)
        j = cost.argmin(1)
        ok = np.isfinite(cost[np.arange(len(f1)), j])
        i_back = cost.argmin(0)
        ok &= i_back[j] == np.arange(len(f1))
        n_pairs = int(ok.sum())
        if n_pairs < 15:
            return s, R, t
        sel1 = np.nonzero(ok)[0][:cap]
        sel2 = j[sel1]

        key = (bool(fix_scale),)
        if key not in self._sim3_reproj_kernels:
            self._sim3_reproj_kernels[key] = KN.make_sim3_reproj_optimizer(
                self.K, cap, fix_scale=fix_scale, plain=self.plain)
        opt = self._sim3_reproj_kernels[key]

        def padded(a, dim):
            out = np.zeros((cap, dim), np.float32)
            out[:len(a)] = a
            return self._dev(out)

        nv = len(sel1)
        valid = self._dev(np.arange(cap) < nv)
        is1 = 1.0 / (1.2 ** (2.0 * m.kf_feat_octave[kf][f1[sel1]]))
        is2_ = 1.0 / (1.2 ** (2.0 * m2.kf_feat_octave[cand][f2[sel2]]))
        S13 = self._dev(np.concatenate(
            [R.reshape(-1), t, [s]]).astype(np.float32))
        S13_out, _, _, n_inl = opt(
            S13,
            padded(X1_all[sel1], 3), padded(m2.kf_feat_uv[cand][f2[sel2]], 2),
            valid, padded(np.asarray(is1)[:, None], 1)[:, 0].contiguous(),
            padded(X2_all[sel2], 3), padded(m.kf_feat_uv[kf][f1[sel1]], 2),
            valid, padded(np.asarray(is2_)[:, None], 1)[:, 0].contiguous(),
            self._dev(m.kf_pose_cw[kf]), self._dev(m2.kf_pose_cw[cand]))
        out, n_inl = self._host_many(S13_out, n_inl)
        self.last_verify["reproj_inliers"] = int(n_inl)
        if int(n_inl) < 20:
            return s, R, t
        R_new = out[:9].reshape(3, 3)
        U, _, Vt = np.linalg.svd(R_new)
        R_new = U @ Vt
        s_new = float(out[12])
        if not np.isfinite(s_new) or not np.isfinite(out).all():
            return s, R, t
        return s_new, R_new.astype(np.float64), out[9:12].astype(np.float64)

    @staticmethod
    def _umeyama(X1: np.ndarray, X2: np.ndarray, fix_scale: bool = False):
        """Closed-form similarity X2 ~ s R X1 + t (Horn / Umeyama)."""
        mu1, mu2 = X1.mean(0), X2.mean(0)
        A = (X2 - mu2).T @ (X1 - mu1) / len(X1)
        U, D, Vt = np.linalg.svd(A)
        Sg = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            Sg[2, 2] = -1
        R = U @ Sg @ Vt
        if fix_scale:
            s = 1.0
        else:
            var1 = np.mean(np.sum((X1 - mu1) ** 2, -1))
            s = float((D * Sg.diagonal()).sum() / max(var1, 1e-12))
        t = mu2 - s * R @ mu1
        return s, R, t

    def _refine_sim3_guided(self, kf: int, cand: int, m2: MapStore,
                            s: float, R: np.ndarray, t: np.ndarray,
                            fix_scale: bool, cap: int = 1024):
        """Grow 3D-3D map-point correspondences of the two sides' covisible
        windows under the current similarity (gates at 10%, 5%, 2.4% of
        the scene depth, descriptor <= 60, mutual) and refit on them.
        Returns (s, R, t, n_inliers)."""
        m = self.map

        def side_points(store, k):
            win = np.unique(np.concatenate(
                [[k], store.covisible_kfs(k, n=5, min_weight=5)]))
            win = win[store.kf_valid[win]]
            ids = np.unique(store.kf_match_pt[win])
            ids = ids[ids >= 0]
            ids = ids[store.pt_valid[ids]]
            return ids[:cap]

        p1 = side_points(m, kf)
        p2 = side_points(m2, cand)
        if len(p1) < 10 or len(p2) < 10:
            return s, R, t, 0
        # one fixed [cap, cap] shape for every candidate
        d1p = np.zeros((cap, 8), np.uint32)
        d2p = np.full((cap, 8), 0xFFFFFFFF, np.uint32)
        d1p[:len(p1)] = m.pt_desc[p1]
        d2p[:len(p2)] = m2.pt_desc[p2]
        X1 = np.full((cap, 3), 1e6, np.float64)
        X2 = np.full((cap, 3), -1e6, np.float64)
        X1[:len(p1)] = m.pt_xyz[p1]
        X2[:len(p2)] = m2.pt_xyz[p2]
        ham = self._hamming(d1p, d2p)[:len(p1), :len(p2)]
        X1, X2 = X1[:len(p1)], X2[:len(p2)]
        n_inl = 0
        R_cw = m.kf_pose_cw[kf, :, :3]
        t_cw = m.kf_pose_cw[kf, :, 3]
        c_w = -R_cw.T @ t_cw
        scene = float(np.median(np.linalg.norm(X1 - c_w, axis=1)))
        if not np.isfinite(scene) or scene <= 0:
            scene = 5.0
        for frac in (0.10, 0.05, 0.024):
            radius = frac * scene
            Y = s * X1 @ R.T + t
            d2 = ((Y ** 2).sum(1)[:, None] + (X2 ** 2).sum(1)[None]
                  - 2.0 * Y @ X2.T)
            cost = np.where((d2 < radius * radius) & (ham <= 60.0),
                            ham + d2, np.inf)
            j = cost.argmin(1)
            ok = np.isfinite(cost[np.arange(len(p1)), j])
            i_back = cost.argmin(0)
            ok &= i_back[j] == np.arange(len(p1))
            if ok.sum() < 10:
                return s, R, t, int(ok.sum())
            sel1, sel2 = np.nonzero(ok)[0], j[ok]
            s, R, t = self._umeyama(X1[sel1], X2[sel2], fix_scale)
            n_inl = int(ok.sum())
        return float(s), R, t, n_inl

    # ------------------------------------------------------------------
    def _inertial_gate(self, s, R, t, m: MapStore):
        """An inertial correction may only rotate about gravity: rejected
        at roll or pitch >= 0.008 rad or yaw >= 0.349 rad; once VIBA2 has
        pinned the scale, yaw only with unit scale."""
        if not m.imu_initialized:
            return True, s, R, t
        phi = _so3_log(R)
        if (abs(phi[0]) >= 0.008 or abs(phi[1]) >= 0.008
                or abs(phi[2]) >= 0.349):
            return False, s, R, t
        if m.imu_ba2:
            Ryaw = lie.so3_exp(torch.tensor(
                [0.0, 0.0, float(phi[2])], dtype=torch.float32)).numpy()
            return True, 1.0, Ryaw, t
        return True, s, R, t

    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, cand: int, s, R, t) -> None:
        """The window around kf (and its points and lines) welded under
        X' = s R X + t, the essential graph with the loop edge, then the
        global BA (the full inertial BA on an inertial map)."""
        m = self.map
        # every chain keyframe's pre-correction pose: the graph's non-loop
        # edges are measured from these
        chain_pre = m.kf_chain()
        pre_poses = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                              m.kf_pose_cw[k, :, 3].copy())
                     for k in chain_pre}
        window = m.covisible_kfs(kf, n=15, min_weight=10)
        window = np.unique(np.concatenate([[kf], window]))
        corr_pts = np.unique(m.kf_match_pt[window])
        corr_pts = corr_pts[corr_pts >= 0]
        corr_pts = corr_pts[m.pt_valid[corr_pts]]
        m.pt_xyz[corr_pts] = (s * (m.pt_xyz[corr_pts] @ R.T) + t).astype(
            np.float32)
        if m.ln_valid.any():
            corr_lns = np.unique(m.kf_match_ln[window])
            corr_lns = corr_lns[corr_lns >= 0]
            if len(corr_lns):
                ep = m.ln_ep[corr_lns].reshape(-1, 3)
                m.ln_ep[corr_lns] = (s * (ep @ R.T) + t).reshape(
                    -1, 6).astype(np.float32)
        # T_cw' = [R_cw R^T | s t_cw - R_cw R^T t]: projections unchanged
        for k in window:
            R_cw = m.kf_pose_cw[k, :, :3].copy()
            t_cw = m.kf_pose_cw[k, :, 3].copy()
            R_new = R_cw @ R.T
            m.kf_pose_cw[k, :, :3] = R_new
            m.kf_pose_cw[k, :, 3] = s * t_cw - R_new @ t
        self._essential_graph(kf, cand, s, R, t, pre_poses,
                              set(int(k) for k in window))
        self._loop_edges.setdefault(m.map_id, []).append((int(kf),
                                                          int(cand)))
        if m.imu_initialized and self.mapper is not None:
            self.mapper.full_inertial_ba()
        else:
            self.run_global_ba(fixed_kf=cand)
        m.change_index += 1

    def _essential_graph(self, kf: int, cand: int, s, R, t,
                         pre_poses: dict, window: set) -> None:
        """The essential graph after the weld: chain, past-loop and
        covisibility edges measured from the pre-correction poses, the
        welded window starting at S_pre S_weld^{-1}, the loop-side keyframe
        fixed; beyond pg_kf_cap every stride-th chain keyframe (with the
        window and the loop edges' ends) is an anchor and the others follow
        their preceding anchor rigidly.  4-DoF on an inertial map."""
        m = self.map
        chain_full = m.kf_chain()
        if len(chain_full) < 3:
            return
        s = float(s)
        R_w = np.asarray(R, np.float64)
        t_w = np.asarray(t, np.float64)
        inv_s = 1.0 / max(s, 1e-9)
        past_loops = [e for e in self._loop_edges.get(m.map_id, [])
                      if m.kf_valid[e[0]] and m.kf_valid[e[1]]]

        required = {int(kf), int(cand), int(chain_full[0])} | \
            {int(k) for k in window}
        for a, b in past_loops:
            required |= {a, b}
        required &= {int(k) for k in chain_full}
        if len(chain_full) > self.pg_kf_cap:
            budget = max(self.pg_kf_cap - len(required), 2)
            stride = int(np.ceil(len(chain_full) / budget))
            keep = set(int(k) for k in chain_full[::stride]) | required
            chain = np.asarray([k for k in chain_full if int(k) in keep])
            if len(chain) > self.pg_kf_cap:
                chain = chain[:self.pg_kf_cap]
            self.metrics.bump("loop/graph_subsampled")
        else:
            chain = chain_full
        n = len(chain)
        slot = {int(k): i for i, k in enumerate(chain)}

        def sim3_state(k):
            Rp, tp = pre_poses[int(k)]
            if int(k) in window:
                Rn = Rp @ R_w.T
                return Rn, tp - inv_s * (Rn @ t_w), inv_s
            return Rp.astype(np.float64), tp.astype(np.float64), 1.0

        states = np.zeros((self.pg_kf_cap, 13), np.float32)
        states[:, :9] = np.eye(3).reshape(-1)
        states[:, 12] = 1.0
        st_cache = {}
        for i, k in enumerate(chain):
            Rk, tk, sk = sim3_state(k)
            st_cache[int(k)] = (Rk, tk, sk)
            states[i] = np.concatenate(
                [np.asarray(Rk).reshape(-1), tk, [sk]]).astype(np.float32)

        edge_i, edge_j, Rjis, tjis, sjis, infos = [], [], [], [], [], []

        def add_edge_pre(a, b, info=1.0):
            Ra, ta = pre_poses[int(a)]
            Rb, tb = pre_poses[int(b)]
            Rba = Rb @ Ra.T
            edge_i.append(slot[int(a)])
            edge_j.append(slot[int(b)])
            Rjis.append(Rba)
            tjis.append(tb - Rba @ ta)
            sjis.append(1.0)
            infos.append(info)

        for i in range(1, n):
            add_edge_pre(chain[i], chain[i - 1])
        for a, b in past_loops:
            if a in slot and b in slot:
                add_edge_pre(a, b, info=1.0)
        for i, k in enumerate(chain):
            for other in np.nonzero(m.covis[k] >= 30)[0]:
                if int(other) in slot and slot[int(other)] > i + 1:
                    w_cov = float(m.covis[k, other])
                    add_edge_pre(k, other,
                                 info=float(np.clip(w_cov / 100.0,
                                                    0.3, 1.0)))
                    if len(edge_i) >= self.pg_edge_cap - 1:
                        break
            if len(edge_i) >= self.pg_edge_cap - 1:
                break
        # the current loop edge between the initial states
        Rk_, tk_, sk_ = st_cache[int(kf)]
        Rc_, tc_, sc_ = st_cache[int(cand)]
        Ri_ = Rk_.T
        si_ = 1.0 / sk_
        ti_ = -si_ * (Ri_ @ tk_)
        edge_i.append(slot[int(kf)])
        edge_j.append(slot[int(cand)])
        Rjis.append(Rc_ @ Ri_)
        tjis.append(sc_ * (Rc_ @ ti_) + tc_)
        sjis.append(sc_ * si_)
        infos.append(1.0)

        ne = len(edge_i)
        cap_e = self.pg_edge_cap

        def pad(a, fill=0):
            a = np.asarray(a)
            out = np.full((cap_e,) + a.shape[1:], fill, a.dtype)
            out[:len(a)] = a
            return out

        kf_free = np.zeros(self.pg_kf_cap, bool)
        kf_free[:n] = True
        kf_free[slot[int(cand)]] = False
        four = bool(m.imu_initialized)
        pg = self.pose_graph_4dof if four else self.pose_graph
        self.last_graph = dict(n=n, edges=ne, S=7 * n, four_dof=four,
                               chain=len(chain_full))
        out = pg(
            self._dev(states), self._dev(kf_free),
            self._dev(pad(np.asarray(edge_i, np.int32))),
            self._dev(pad(np.asarray(edge_j, np.int32))),
            self._dev(pad(np.stack(Rjis).astype(np.float32))),
            self._dev(pad(np.stack(tjis).astype(np.float32))),
            self._dev(pad(np.asarray(sjis, np.float32), 1.0)),
            self._dev(np.arange(cap_e) < ne),
            self._dev(pad(np.asarray(infos, np.float32))), n_active=n)
        out = self._host(out)

        old_poses = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                              m.kf_pose_cw[k, :, 3].copy())
                     for k in chain_full}
        new_sim3 = {}
        Rn_all = lie.so3_normalize(torch.from_numpy(
            np.ascontiguousarray(out[:n, :9].reshape(n, 3, 3)))).numpy()
        for i, k in enumerate(chain):
            new_sim3[int(k)] = (Rn_all[i].astype(np.float64),
                                out[i, 9:12].astype(np.float64),
                                max(float(out[i, 12]), 1e-6))
        # rigid propagation from the nearest preceding anchor
        anchor = None
        for k in chain_full:
            ik = int(k)
            if ik in new_sim3:
                anchor = ik
                continue
            Rka, tka = pre_poses[ik]
            Raa, taa = pre_poses[anchor]
            Rrel = Rka @ Raa.T
            trel = tka - Rrel @ taa
            Rna, tna, sna = new_sim3[anchor]
            new_sim3[ik] = (Rrel @ Rna, Rrel @ tna + trel * sna, sna)
        # SE3 poses T_cw = [R | t / s]; inertial velocities rotated by the
        # per-keyframe world rotation change
        for k in chain_full:
            Rn, tn, sn = new_sim3[int(k)]
            R_oldk = old_poses[int(k)][0]
            m.kf_pose_cw[k, :, :3] = Rn.astype(np.float32)
            m.kf_pose_cw[k, :, 3] = (tn / sn).astype(np.float32)
            if m.imu_initialized and np.isfinite(m.kf_vel[k]).all():
                R_corr = Rn.T @ R_oldk
                m.kf_vel[k] = (R_corr @ m.kf_vel[k]).astype(np.float32)
        # landmarks follow their reference keyframe's change
        pt_ref = np.full(m.max_pts, -1, np.int32)
        ln_ref = np.full(m.max_lines, -1, np.int32)
        for k in chain_full:
            pts = m.kf_match_pt[k]
            pts = pts[pts >= 0]
            fresh = pt_ref[pts] < 0
            pt_ref[pts[fresh]] = k
            lns = m.kf_match_ln[k]
            lns = lns[lns >= 0]
            freshl = ln_ref[lns] < 0
            ln_ref[lns[freshl]] = k
        for k in chain_full:
            R_old, t_old = old_poses[int(k)]
            R_new = m.kf_pose_cw[k, :, :3]
            t_new = m.kf_pose_cw[k, :, 3]
            pts = np.nonzero((pt_ref == k) & m.pt_valid)[0]
            if len(pts):
                Xc = m.pt_xyz[pts] @ R_old.T + t_old
                m.pt_xyz[pts] = ((Xc - t_new) @ R_new).astype(np.float32)
            lns = np.nonzero((ln_ref == k) & m.ln_valid)[0]
            if len(lns):
                ep = m.ln_ep[lns].reshape(-1, 3)
                epc = ep @ R_old.T + t_old
                m.ln_ep[lns] = ((epc - t_new) @ R_new).reshape(
                    -1, 6).astype(np.float32)

    # ------------------------------------------------------------------
    def run_global_ba(self, fixed_kf: int, iters: int = 10) -> None:
        """Global BA over the whole map (every keyframe free but the gauge
        anchor); maps beyond the 128-keyframe capacity run the
        chain-partitioned block schedule."""
        m = self.map
        kf_cap, _, _ = self._gba_caps
        chain = m.kf_chain()
        if len(chain) < 3:
            return
        if len(chain) > kf_cap:
            self._run_gba_chained(chain, fixed_kf)
        else:
            self._gba_block(chain, {int(fixed_kf)})
        m.change_index += 1

    def _run_gba_chained(self, chain: np.ndarray, fixed_kf: int,
                         halo: int = 2, sweeps: int = 2) -> None:
        """Contiguous chain blocks with `halo` boundary keyframes frozen,
        swept block-Gauss-Seidel: every keyframe of the map is
        optimized."""
        kf_cap, _, _ = self._gba_caps
        W = kf_cap - 2 * halo
        self.metrics.bump("gba/chained")
        for _ in range(sweeps):
            for b0 in range(0, len(chain), W):
                block = chain[max(0, b0 - halo):b0 + W + halo]
                own = set(int(k) for k in chain[b0:b0 + W])
                fixed = {int(k) for k in block if int(k) not in own}
                if int(fixed_kf) in own:
                    fixed.add(int(fixed_kf))
                if not fixed:
                    fixed.add(int(block[0]))
                self._gba_block(block, fixed)

    def _gba_block(self, chain: np.ndarray, fixed_ids: set,
                   iters: int = 10) -> None:
        """One global-BA solve over `chain` (<= 128 keyframes) with the
        keyframes of `fixed_ids` held."""
        m = self.map
        kf_cap, pt_cap, obs_cap = self._gba_caps
        kf_slot = np.full(m.max_kf, -1, np.int32)
        kf_slot[chain] = np.arange(len(chain))

        pt_ids = np.unique(m.kf_match_pt[chain])
        pt_ids = pt_ids[pt_ids >= 0]
        pt_ids = pt_ids[m.pt_valid[pt_ids]]
        if len(pt_ids) > pt_cap:
            self.metrics.bump("gba/points_capped")
            order = np.argsort(-m.pt_n_obs[pt_ids])
            pt_ids = np.sort(pt_ids[order[:pt_cap]])
        if len(pt_ids) < 8:
            return
        pt_slot = np.full(m.max_pts, -1, np.int32)
        pt_slot[pt_ids] = np.arange(len(pt_ids))

        match = m.kf_match_pt[chain]
        ks, fs = np.nonzero((match >= 0)
                            & (pt_slot[np.maximum(match, 0)] >= 0))
        pts = match[ks, fs]
        if len(ks) > obs_cap:
            # stratified per-keyframe quota, then the spare budget uniform
            per_kf = max(obs_cap // max(len(chain), 1), 8)
            self.metrics.bump("gba/obs_stratified")
            r = np.random.default_rng(0)
            keep = np.zeros(len(ks), bool)
            for slot_k in np.unique(ks):
                rows = np.nonzero(ks == slot_k)[0]
                if len(rows) > per_kf:
                    rows = r.choice(rows, per_kf, replace=False)
                keep[rows] = True
            sel = np.nonzero(keep)[0]
            spare = obs_cap - len(sel)
            if spare > 0:
                rest = np.nonzero(~keep)[0]
                sel = np.concatenate(
                    [sel, r.choice(rest, min(spare, len(rest)),
                                   replace=False)])
            sel = np.sort(sel[:obs_cap])
            ks, fs, pts = ks[sel], fs[sel], pts[sel]
        obs_kf = ks.astype(np.int32)
        obs_pt = pt_slot[pts]
        uv_src = m.kf_feat_uv_raw if self.kb8 is not None else m.kf_feat_uv
        obs_uv = uv_src[chain[ks], fs]
        obs_is2 = (1.0 / 1.2 ** (2.0 * m.kf_feat_octave[chain[ks], fs])
                   ).astype(np.float32)

        def pad(a, cap, fill=0):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:len(a)] = a
            return out

        kf_poses = np.tile(np.eye(3, 4, dtype=np.float32), (kf_cap, 1, 1))
        kf_poses[:len(chain)] = m.kf_pose_cw[chain]
        kf_free = np.zeros(kf_cap, bool)
        kf_free[:len(chain)] = True
        for f in fixed_ids:
            if kf_slot[f] >= 0:
                kf_free[kf_slot[f]] = False
        pt_xyz = np.zeros((pt_cap, 3), np.float32)
        pt_xyz[:len(pt_ids)] = m.pt_xyz[pt_ids]
        pt_free = np.zeros(pt_cap, bool)
        pt_free[:len(pt_ids)] = True
        point_args = [self._dev(a) for a in (
            kf_poses, kf_free, pt_xyz, pt_free, pad(obs_kf, obs_cap),
            pad(obs_pt, obs_cap), pad(obs_uv, obs_cap),
            np.arange(obs_cap) < len(obs_kf), pad(obs_is2, obs_cap, 1.0))]

        ln_cap, lobs_cap = 1024, 4096
        ln_ids = np.zeros(0, np.int32)
        if self.cfg.use_lines:
            ln_ids = np.unique(m.kf_match_ln[chain])
            ln_ids = ln_ids[ln_ids >= 0]
            ln_ids = ln_ids[m.ln_valid[ln_ids]]
            if len(ln_ids) > ln_cap:
                self.metrics.bump("gba/lines_capped")
                order = np.argsort(-m.ln_n_obs[ln_ids])
                ln_ids = np.sort(ln_ids[order[:ln_cap]])
        use_pl = len(ln_ids) >= 8

        if use_pl:
            ln_slot = np.full(m.max_lines, -1, np.int32)
            ln_slot[ln_ids] = np.arange(len(ln_ids))
            lmatch = m.kf_match_ln[chain]
            lks, lfs = np.nonzero(
                (lmatch >= 0) & (ln_slot[np.maximum(lmatch, 0)] >= 0))
            if len(lks) > lobs_cap:
                self.metrics.bump("gba/line_obs_subsampled")
                sel = np.sort(np.random.default_rng(0).choice(
                    len(lks), lobs_cap, replace=False))
                lks, lfs = lks[sel], lfs[sel]
            lobs_kf = lks.astype(np.int32)
            lobs_ln = ln_slot[lmatch[lks, lfs]]
            ep = m.kf_line_ep[chain[lks], lfs]
            sp = np.concatenate([ep[:, :2], np.ones((len(ep), 1))], 1)
            e_ = np.concatenate([ep[:, 2:], np.ones((len(ep), 1))], 1)
            leq = np.cross(sp, e_)
            leq /= np.maximum(
                np.linalg.norm(leq[:, :2], axis=1, keepdims=True), 1e-9)
            lobs_eq = leq.astype(np.float32)
            ln_ep6 = np.zeros((ln_cap, 6), np.float32)
            ln_ep6[:len(ln_ids)] = m.ln_ep[ln_ids]
            ln_free = np.zeros(ln_cap, bool)
            ln_free[:len(ln_ids)] = True
            if self.gba_pl_kernel is None:
                self.gba_pl_kernel = KN.make_local_ba_pl(
                    self.ba_K, rounds=2, iters=5, plain=self.plain)
            poses_out, pts_out, lns_out, _, _ = self.gba_pl_kernel(
                *point_args, *(self._dev(a) for a in (
                    ln_ep6, ln_free, pad(lobs_kf, lobs_cap),
                    pad(lobs_ln, lobs_cap), pad(lobs_eq, lobs_cap),
                    np.arange(lobs_cap) < len(lobs_kf),
                    pad(np.ones(len(lobs_kf), np.float32), lobs_cap))))
            poses_out, pts_out, lns_out = self._host_many(poses_out, pts_out,
                                                          lns_out)
            okl = np.all(np.isfinite(lns_out[:len(ln_ids)]), axis=1)
            m.ln_ep[ln_ids[okl]] = lns_out[:len(ln_ids)][okl]
        else:
            if self.gba_kernel is None:
                self.gba_kernel = KN.make_local_ba(
                    self.ba_K, rounds=2, iters=5, plain=self.plain)
            poses_out, pts_out, _ = self.gba_kernel(*point_args)
            poses_out, pts_out = self._host_many(poses_out, pts_out)
        self.metrics.bump("gba/solves")
        ok = np.all(np.isfinite(poses_out[:len(chain)]), axis=(1, 2))
        m.kf_pose_cw[chain[ok]] = poses_out[:len(chain)][ok]
        okp = np.all(np.isfinite(pts_out[:len(pt_ids)]), axis=1)
        m.pt_xyz[pt_ids[okp]] = pts_out[:len(pt_ids)][okp]

    # ------------------------------------------------------------------
    def _merge_maps(self, kf: int, cand: int, m_old: MapStore,
                    s, R, t) -> None:
        """Merge the active map into `m_old`: re-express it under the
        verified similarity, append it, fuse duplicated points around the
        weld, then the weld BA anchored on the old side.  m_old becomes
        active; the transform and the slot maps wait in `pending_merge`
        for the tracker."""
        m_cur = self.map
        cur_id = m_cur.map_id
        Tbc = None
        if self.cfg.sensor in (3, 4):
            Tbc = self.cfg.imu.Tbc_matrix()
        m_cur.apply_sim3(float(s), R, t, Tbc)
        kf_map, pt_map, ln_map = m_old.absorb(m_cur)
        if hasattr(self.kfdb, "merge_maps"):
            self.kfdb.merge_maps(cur_id, m_old.map_id, kf_map)
        merged_index = self.atlas.active
        self.atlas.maps = [mm for mm in self.atlas.maps
                           if mm.map_id != cur_id]
        self.atlas.active = self.atlas.maps.index(m_old)
        m_old.imu_initialized = m_old.imu_initialized or m_cur.imu_initialized
        m_old.imu_ba1 = m_old.imu_ba1 or m_cur.imu_ba1
        m_old.imu_ba2 = m_old.imu_ba2 or m_cur.imu_ba2

        kf_new = int(kf_map[kf])
        self._fuse_duplicates(m_old, kf_new, cand)
        for k in (kf_new, cand):
            m_old.update_covisibility(int(k))
        if (m_old.imu_initialized and m_cur.imu_initialized
                and self.mapper is not None):
            n_new = int((kf_map >= 0).sum())
            # the weld solve starts far from its optimum: erase outliers
            # at 3x the plain gate
            self.mapper._erase_chi2_mult = 3.0
            try:
                self.mapper.local_inertial_ba(
                    kf_new, window=min(n_new + 6, self.mapper.ba_kf_cap))
            finally:
                self.mapper._erase_chi2_mult = 1.0
        else:
            self.run_global_ba(fixed_kf=cand)
        self.pending_merge = dict(
            s=float(s), R=np.asarray(R), t=np.asarray(t),
            kf_map=kf_map, pt_map=pt_map, ln_map=ln_map,
            merged_atlas_index=merged_index,
            new_atlas_index=self.atlas.active)
        m_old.change_index += 1

    def _fuse_duplicates(self, m: MapStore, kf_new: int, cand: int,
                         radius: float = 0.15) -> None:
        """Points of the merged-in window that coincide (3D distance within
        `radius` and descriptor <= 60) with old-side points are replaced by
        the old ones; observations rebind through a lookup table."""
        win_new = np.unique(np.concatenate(
            [[kf_new], m.covisible_kfs(kf_new, n=10, min_weight=5)]))
        win_old = np.unique(np.concatenate(
            [[cand], m.covisible_kfs(cand, n=10, min_weight=5)]))
        win_old = np.setdiff1d(win_old, win_new)
        pts_new = np.unique(m.kf_match_pt[win_new])
        pts_new = pts_new[pts_new >= 0]
        pts_new = pts_new[m.pt_valid[pts_new]]
        pts_old = np.unique(m.kf_match_pt[win_old])
        pts_old = pts_old[pts_old >= 0]
        pts_old = pts_old[m.pt_valid[pts_old]]
        pts_old = np.setdiff1d(pts_old, pts_new)
        if len(pts_new) == 0 or len(pts_old) == 0:
            return
        d2 = np.sum((m.pt_xyz[pts_new][:, None] -
                     m.pt_xyz[pts_old][None]) ** 2, -1)
        dist = np.array(self._hamming(m.pt_desc[pts_new], m.pt_desc[pts_old]))
        dist[d2 > radius * radius] = 1e9
        j = dist.argmin(1)
        dup = dist[np.arange(len(pts_new)), j] <= 60.0
        if not dup.any():
            return
        lut = np.arange(m.max_pts, dtype=np.int32)
        lut[pts_new[dup]] = pts_old[j[dup]]
        mp = m.kf_match_pt
        m.kf_match_pt = np.where(mp >= 0, lut[np.maximum(mp, 0)],
                                 INVALID).astype(np.int32)
        m.pt_n_obs[pts_old[j[dup]]] += m.pt_n_obs[pts_new[dup]]
        m.pt_valid[pts_new[dup]] = False
        m.n_pt -= int(dup.sum())
        self.metrics.bump("merge/fused", int(dup.sum()))
