"""The local mapper's keyframe step (port of
plvio_tpu/models/local_mapping.py: `LocalMapper.__init__` :31-157,
`process_keyframe` :169-238, `_replace_point` :244, `_fuse_into` :263,
`search_in_neighbors` :329, `cull_points` :361, `cull_points_pressure`
:376, `create_new_points` :408, `cull_lines` :504, `cull_lines_pressure`
:519, `create_new_lines` :541, `update_point_stats` :609, `_median_depth`
:685, `local_ba` :697, the inertial helpers `_pre_const`,
`_chain_preints`, `_push_transform`, `_chain_gs_inputs` :892-946,
`refine_scale` :948, `maybe_initialize_imu` :1012, `_reintegrate` :1125,
`local_inertial_ba` :1143, `_viba_pulse_step` :1178, `full_inertial_ba`
:1221, `_window_line_obs` :1262, `_erase_window_outliers` :1299,
`_liba_window` :1349, and the keyframe culling `_merge_imu_into_next`
:1576, `cull_keyframes` :1596, `_cullable` :1635, `_redundancy` :1649,
`_do_cull` :1670).

The host bookkeeping is the reference's, line for line, on the port's
numpy `MapStore`; only the device calls differ: the epipolar matcher (the
`hamming_match` kernel's epipolar mode and `rot_hist`), the triangulator
(csrc/triangulate.cu), the line pair matcher and line triangulator
(`hamming_match`'s line pair mode, csrc/line_triangulate.cu), the fuse's
projection matcher (csrc/proj_match.cu), the windowed BAs
(csrc/ba_linearize.cu + csrc/schur_solve.cu, point-only or point+line;
with csrc/inertial_chain.cu the inertial window and the full-map inertial
BA, whose 64-keyframe window takes schur_solve's global path), the IMU
initialization and scale refinement (csrc/inertial_gs_lm.cu) and the
reintegration of stored IMU windows (csrc/imu_preint.cu).  Kernel inputs
go to the mapper's device; their outputs come back to numpy where the
reference calls `np.asarray`, and each such read is counted in
`host_syncs`.  `plain=True` runs the kernels' plain PyTorch versions on
any device.  Each device call depends on the bookkeeping of the calls
before it, so the calls are not batched.

The sharded window solve (models/local_mapping.py:140-157, 1446-1489):
with an IMU and no KB8 lens, `dist_mesh` or the production rule of
`parallel/mesh.default_mesh` (PLVIO_DIST=1 forces it, PLVIO_DIST=0 forbids
it, otherwise more than one visible card turns it on) builds a
`parallel/dist_liba.DistLIBARunner`, and every inertial window solve (the
sliding window, the VIBA pulses, the full-map BA) goes through it; its
solves are recorded in `ba_calls` with path "dist".

Not ported: the reference's PLVIO_TRACE prints, which compute nothing
the mapper uses.  A KB8 camera (`kb8`) runs its lens through the
point edges of every window BA (`ba_K`: the point+line and the inertial
windows too, their line edges on its pinhole fx, fy, cx, cy) and the fuse
on raw pixels (`_ba_uv`).  Under SLAM modes 1-3 the window BA with 8 or
more confirmed lines is the line-only one (`make_local_ba_lines_only`,
the points held fixed).  `metrics` times the reference's stages
("mapping/cull", "/triangulate", "/lines", "/fuse", "/liba", "/lba",
"/kf_cull").
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..cuda import HostIO, resolve_device
from ..ops import imu as IMU
from ..solver.residuals import PinholeK, kb8_for
from ..utils import lie
from ..utils.metrics import Metrics
from . import kernels as KN
from .mapstore import INVALID, Atlas, MapStore


class LocalMapper(HostIO):
    """The local mapper of the reference, in the configuration the port
    runs (pinhole camera), at production's caps unless given others: the
    point BA window `ba_kf_cap` x `ba_pt_cap` x `ba_obs_cap`, 512 lines x
    1024 line observations, fuse cap 2048; with an IMU the inertial window
    (lines 256 / 512), the full-map inertial BA's 64 KF x 8192 points x
    16384 observations + 512 / 1024 lines (`viba_*_cap`, built at first
    use), and the IMU initialization's chain of `imu_init_cap` keyframes.
    `map` is the atlas's current store.

    What the last calls did, for the entry points: features bound,
    landmarks merged and merges refused by the fuse's 3D check, the point
    BA's path (`ba_path` "pt" / "pl") and LM iterations per round
    (`ba_stats`), every window solve as a dict (path "lba" / "liba" /
    "liba_half" / "viba", window keyframes, LM iterations per round as
    device tensors) in `ba_calls`, and the device-to-host reads in
    `host_syncs`."""

    def __init__(self, cfg: SystemConfig, atlas: Atlas, n_feat: int,
                 ba_kf_cap: int = 16, ba_pt_cap: int = 4096,
                 ba_obs_cap: int = 8192, imu_init_cap: int = 32,
                 device="cuda",
                 plain: bool = False, dtype=torch.float32, dist_mesh=None):
        self.cfg = cfg
        # the window solves' and the IMU init's float inputs go in this
        # dtype (float64 only for the plain versions: a reference run)
        self.dtype = dtype
        self.atlas = atlas
        self.n_feat = n_feat
        self.device = resolve_device(device)
        self.plain = plain
        cam = cfg.camera
        self.K = PinholeK(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        # the KB8 fisheye runs its lens through the window BA and the fuse
        # on raw pixels; the epipolar matcher and the triangulator stay on
        # undistorted coordinates (exact pinhole rays after the
        # unprojection)
        self.kb8 = kb8_for(cfg)
        self.ba_K = self.K if self.kb8 is None else self.kb8
        self.ba_kf_cap = ba_kf_cap
        # the outlier erasure's chi2 gate multiplier (3 around merge welds)
        self._erase_chi2_mult = 1.0
        self.ba_pt_cap = ba_pt_cap
        self.ba_obs_cap = ba_obs_cap
        self.epi_match = KN.make_epipolar_matcher(self.K, plain=plain)
        self.triangulate = KN.make_triangulator(self.K, plain=plain)
        self.local_ba_kernel = KN.make_local_ba(self.ba_K, plain=plain)
        self.recent_pts: List[np.ndarray] = []  # per-KF batches for culling
        self.fuse_cap = 2048
        self.fuse_match = KN.make_projection_matcher_kb8(self.kb8,
                                                         plain=plain) \
            if self.kb8 is not None \
            else KN.make_projection_matcher(self.K, plain=plain)
        # the keyframe database's hook (culled keyframes leave it too) and
        # the stage profiler; `System` hands over its own
        self.kfdb = None
        self.metrics = Metrics()
        self.n_culled = 0
        self.n_fused = 0

        self.use_lines = cfg.use_lines
        self.slam_mode = int(cfg.slam_mode)
        if self.use_lines:
            self.ba_ln_cap = 512
            self.ba_lobs_cap = 1024
            self.line_pair_match = KN.make_line_pair_matcher(plain=plain)
            self.line_triangulate = KN.make_line_triangulator(self.K,
                                                              plain=plain)
            self.local_ba_pl_kernel = KN.make_local_ba_pl(self.ba_K,
                                                          plain=plain)
            self.recent_lns: List[np.ndarray] = []
            # SLAM modes 1-3: the line-only window BA (pinhole K)
            self.local_ba_lines_kernel = None
            if self.slam_mode in (1, 2, 3):
                self.local_ba_lines_kernel = KN.make_local_ba_lines_only(
                    self.K, self.slam_mode, plain=plain)

        self.use_imu = cfg.sensor in (3, 4)
        self.imu_init_cap = imu_init_cap
        self.pending_transform = None  # (R_gw, scale) for the tracker
        if self.use_imu:
            self.calib = IMU.make_calib(cfg.imu)
            self.Tbc = cfg.imu.Tbc_matrix().astype(np.float32)
            R_bc, t_bc = self.Tbc[:3, :3], self.Tbc[:3, 3]
            self.R_cb = np.asarray(R_bc.T, np.float32)
            self.t_cb = np.asarray(-R_bc.T @ t_bc, np.float32)
            self.imu_init_kernel = KN.make_inertial_init(
                cfg.imu.gravity, imu_init_cap, plain=plain)
            self.scale_refine_kernel = KN.make_scale_refine(
                cfg.imu.gravity, imu_init_cap, plain=plain)
            self._preint = IMU.imu_preint_plain if plain else IMU.imu_preint
            # lines join the inertial window BA when enabled
            self.liba_ln_cap = 256 if self.use_lines else 0
            self.liba_lobs_cap = 512 if self.use_lines else 0
            self.liba_kernel = self._make_liba(ba_kf_cap, ba_pt_cap,
                                               ba_obs_cap, self.liba_ln_cap,
                                               self.liba_lobs_cap)
            self._liba_kernel_half = None    # lazy half-cap bucket
            self._kf_since_init = 0
            self._viba = {}   # map_id -> VIBA pulse state
            self._last_gfix = {}   # map_id -> time of the last gravity fix
            # the full-map inertial BA's window (built at first use)
            self.viba_kf_cap = 64
            self.viba_pt_cap = 8192
            self.viba_obs_cap = 16384
            self.viba_ln_cap = 512 if self.use_lines else 0
            self.viba_lobs_cap = 1024 if self.use_lines else 0
            self.viba_kernel = None
        # the sharded back end (models/local_mapping.py:140-157): every
        # inertial window solve goes through the landmark-sharded solver
        # when a mesh is given or the production rule asks for one; a KB8
        # map keeps the single-device kernel (the sharded point edge is
        # the pinhole's)
        self._dist_runner = None
        if self.use_imu and self.kb8 is None:
            from ..parallel.mesh import default_mesh
            mesh = dist_mesh if dist_mesh is not None \
                else default_mesh(self.device)
            if mesh is not None:
                from ..parallel.dist_liba import DistLIBARunner
                self._dist_runner = DistLIBARunner(
                    self.K, self.R_cb, self.t_cb, cfg.imu.gravity,
                    mesh=mesh, plain=plain, dtype=dtype)

        self.n_bound = 0
        self.n_merged = 0
        self.n_refused = 0
        self.n_refine = 0         # scale / gravity refinement pulses run
        self.init_scale = None    # the scale the initialization applied
        self.ba_path = None
        self.ba_stats: list = []
        self.ba_calls: list = []
        self.host_syncs = 0

    def _sol(self, a) -> torch.Tensor:
        """A window solve's input on the device, floats in `dtype`."""
        t = self._dev(a)
        return t.to(self.dtype) if t.is_floating_point() else t

    @property
    def map(self) -> MapStore:
        return self.atlas.current

    def _ba_uv(self, m: MapStore) -> np.ndarray:
        """The BA's and the fuse's observation pixels: raw when the KB8
        lens is the BA camera, undistorted otherwise."""
        return m.kf_feat_uv_raw if self.kb8 is not None else m.kf_feat_uv

    @map.setter
    def map(self, m: MapStore) -> None:
        self.atlas.maps[self.atlas.active] = m

    def _make_liba(self, n_kf, n_pt, n_obs, n_ln, n_lobs):
        return KN.make_local_inertial_ba(
            self.ba_K, n_kf, n_pt, n_obs, self.R_cb, self.t_cb,
            self.cfg.imu.gravity, n_ln=n_ln, n_lobs=n_lobs, plain=self.plain)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, protect=()) -> list:
        """The mapping step of one new keyframe: cull landmarks,
        triangulate points and lines, fuse the neighbourhood's duplicates,
        then the window BA (before IMU init the visual one; after it the
        inertial window, the scale / gravity refinement pulses and the
        full-map pulses), then cull keyframes.  `protect`: keyframes never
        culled.  Returns [(culled_kf, pose_cw, timestamp), ...]."""
        met = self.metrics
        with met.stage("mapping/cull"):
            self.cull_points()
            self.cull_points_pressure(kf)
        with met.stage("mapping/triangulate"):
            self.create_new_points(kf)
        if self.use_lines:
            with met.stage("mapping/lines"):
                self.cull_lines()
                self.cull_lines_pressure(kf)
                self.create_new_lines(kf)
        with met.stage("mapping/fuse"):
            self.search_in_neighbors(kf)
            self.update_point_stats(kf)
        if self.use_imu and not self.map.imu_initialized:
            self.maybe_initialize_imu()
        if self.use_imu and self.map.imu_initialized:
            with met.stage("mapping/liba"):
                self.local_inertial_ba(kf)
            self._kf_since_init += 1
            # refinement every 3rd keyframe until the scale converged
            # (imu_ba2), every 10th after
            if (not self.map.imu_ba2 and self._kf_since_init % 3 == 0) \
                    or self._kf_since_init % 10 == 0:
                self.refine_scale()
            # the full-map pulse every 5 s after IMU init (one block of
            # the schedule a call past viba_kf_cap); imu_ba2 15 s after
            st = self._viba.get(self.map.map_id)
            if st is not None:
                ts = float(self.map.kf_timestamp[kf])
                if ts - st["last"] > 5.0:
                    if self._viba_pulse_step(st):
                        st["last"] = ts
                if not st["v2"] and ts - st["t0"] > 15.0:
                    st["v2"] = True
                    self.map.imu_ba2 = True
        else:
            with met.stage("mapping/lba"):
                self.local_ba(kf)
        with met.stage("mapping/kf_cull"):
            culled = self.cull_keyframes(kf, protect=protect)
        self.map.change_index += 1
        return culled

    # ------------------------------------------------------------------
    # Duplicate-landmark fusion
    # ------------------------------------------------------------------
    def _replace_point(self, drop: int, keep: int) -> None:
        """Rebind every observation of `drop` to `keep` (skipping keyframes
        that already observe `keep`) and absorb its statistics."""
        m = self.map
        kfs = m.valid_kf_indices()
        rl, cols = np.nonzero(m.kf_match_pt[kfs] == drop)
        rows = kfs[rl]
        for r, c in zip(rows, cols):
            if (m.kf_match_pt[r] == keep).any():
                m.kf_match_pt[r, c] = INVALID
            else:
                m.kf_match_pt[r, c] = keep
                m.pt_n_obs[keep] += 1
        m.pt_found[keep] += m.pt_found[drop]
        m.pt_visible[keep] += m.pt_visible[drop]
        m.pt_valid[drop] = False
        m.n_pt -= 1

    def _fuse_into(self, target_kf: int, pt_ids: np.ndarray) -> int:
        """Project candidate map points into `target_kf`; bind unbound
        feature matches as new observations, and merge two landmarks that
        a matched feature binds to different points when they coincide in
        3D (keep the better-observed one)."""
        m = self.map
        cap = self.fuse_cap
        ids = pt_ids[:cap]
        n = len(ids)
        if n == 0:
            return 0
        xyz = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        live = np.zeros(cap, bool)
        xyz[:n] = m.pt_xyz[ids]
        desc[:n] = m.pt_desc[ids]
        live[:n] = m.pt_valid[ids]
        _, pt_feat, matched, _ = self.fuse_match(
            self._dev(m.kf_pose_cw[target_kf]), self._dev(xyz),
            self._dev(desc), self._dev(live),
            self._dev(self._ba_uv(m)[target_kf]),
            self._dev(m.kf_feat_desc[target_kf]),
            self._dev(m.kf_feat_octave[target_kf]),
            self._dev(m.kf_feat_valid[target_kf]), 2.0, 50.0)
        matched = self._host(matched)
        pt_feat = self._host(pt_feat)
        row = m.kf_match_pt[target_kf]
        bound = np.zeros(m.max_pts, bool)
        bound[row[row >= 0]] = True
        R_t = m.kf_pose_cw[target_kf, :, :3]
        t_t = m.kf_pose_cw[target_kf, :, 3]
        n_fused = 0
        for slot in np.nonzero(matched[:n])[0]:
            p = int(ids[slot])
            f = int(pt_feat[slot])
            if not m.pt_valid[p]:
                continue            # merged away earlier in this loop
            cur = int(m.kf_match_pt[target_kf, f])
            if cur == p:
                continue
            if cur == INVALID:
                if bound[p]:
                    continue        # p already observed on another feature
                m.kf_match_pt[target_kf, f] = p
                m.pt_n_obs[p] += 1
                bound[p] = True
                n_fused += 1
                self.n_bound += 1
            elif m.pt_valid[cur]:
                # merge only when the two landmarks coincide in 3D
                # (relative to depth)
                z = float(R_t[2] @ m.pt_xyz[p] + t_t[2])
                if np.linalg.norm(m.pt_xyz[p] - m.pt_xyz[cur]) \
                        > 0.02 * max(z, 0.5):
                    self.n_refused += 1
                    continue
                keep, drop = ((cur, p) if m.pt_n_obs[cur] >= m.pt_n_obs[p]
                              else (p, cur))
                self._replace_point(drop, keep)
                n_fused += 1
                self.n_merged += 1
        return n_fused

    def search_in_neighbors(self, kf: int) -> None:
        """Two-hop duplicate fusion around the new keyframe: the
        neighbourhood's points into it, then its points into each of the
        first 10 neighbours."""
        m = self.map
        n1 = [int(x) for x in m.covisible_kfs(kf, n=10, min_weight=5)
              if m.kf_valid[x]]
        ext = list(n1)
        for nb in n1:
            for y in m.covisible_kfs(nb, n=5, min_weight=5):
                y = int(y)
                if y != kf and m.kf_valid[y] and y not in ext:
                    ext.append(y)
        if not ext:
            return
        # forward: neighborhood points into the new KF
        cand = np.unique(m.kf_match_pt[ext])
        cand = cand[cand >= 0]
        cand = cand[m.pt_valid[cand]]
        fused = self._fuse_into(kf, cand)
        # backward: the new KF's points into each neighbor
        own = m.kf_match_pt[kf]
        own_ids = own[own >= 0]
        own_ids = own_ids[m.pt_valid[own_ids]]
        for nb in ext[:10]:
            fused += self._fuse_into(nb, own_ids)
        self.n_fused += fused
        if fused:
            m.update_covisibility(kf)

    # ------------------------------------------------------------------
    # New map lines
    # ------------------------------------------------------------------
    def create_new_lines(self, kf: int) -> None:
        """Triangulate unmatched line observations of `kf` against the
        best covisible keyframes by interpretation-plane intersection."""
        m = self.map
        neighbors = m.covisible_kfs(kf, n=10, min_weight=5)
        created = []

        def angles(ep):
            return np.arctan2(ep[:, 3] - ep[:, 1],
                              ep[:, 2] - ep[:, 0]) % np.pi

        ep_k = m.kf_line_ep[kf]
        ang_k = angles(ep_k)
        C_k = -m.kf_pose_cw[kf, :, :3].T @ m.kf_pose_cw[kf, :, 3]
        for nb in neighbors:
            if not m.kf_valid[nb]:
                continue
            C_n = -m.kf_pose_cw[nb, :, :3].T @ m.kf_pose_cw[nb, :, 3]
            med_depth = self._median_depth(nb)
            if med_depth <= 0 or np.linalg.norm(C_k - C_n) / med_depth < 0.01:
                continue
            free_k = m.kf_line_valid[kf] & (m.kf_match_ln[kf] == INVALID)
            free_n = m.kf_line_valid[nb] & (m.kf_match_ln[nb] == INVALID)
            if free_k.sum() == 0 or free_n.sum() == 0:
                continue
            ep_n = m.kf_line_ep[nb]
            idx_k, ok = self.line_pair_match(
                self._dev(ep_n), self._dev(m.kf_line_desc[nb]),
                self._dev(angles(ep_n).astype(np.float32)),
                self._dev(free_n), self._dev(ep_k),
                self._dev(m.kf_line_desc[kf]),
                self._dev(ang_k.astype(np.float32)), self._dev(free_k))
            ok_np = self._host(ok)
            if ok_np.sum() == 0:
                continue
            idx_np = self._host(idx_k)
            ep2 = ep_k[idx_np]
            Xs_w, Xe_w, good = self.line_triangulate(
                self._dev(m.kf_pose_cw[nb]), self._dev(m.kf_pose_cw[kf]),
                self._dev(ep_n), self._dev(ep2), ok)
            good_np = self._host(good)
            if good_np.sum() == 0:
                continue
            f1 = np.nonzero(good_np)[0]
            f2 = idx_np[good_np]
            fresh = m.kf_match_ln[kf][f2] == INVALID
            f1, f2 = f1[fresh], f2[fresh]
            if len(f1) == 0:
                continue
            lns = m.alloc_lines(len(f1))
            nn = len(lns)
            f1, f2 = f1[:nn], f2[:nn]
            Xs_np = self._host(Xs_w)
            Xe_np = self._host(Xe_w)
            m.ln_ep[lns] = np.concatenate([Xs_np[f1], Xe_np[f1]], -1)
            m.ln_desc[lns] = m.kf_line_desc[kf][f2]
            m.ln_first_kf[lns] = kf
            m.ln_n_obs[lns] = 2
            m.ln_found[lns] = 2
            m.ln_visible[lns] = 2
            m.kf_match_ln[nb, f1] = lns
            m.kf_match_ln[kf, f2] = lns
            created.append(lns)
        if created:
            self.recent_lns.append(np.concatenate(created))

    # ------------------------------------------------------------------
    # Landmark culling, new points and the points' statistics
    # ------------------------------------------------------------------
    def cull_points(self) -> None:
        """Remove the points of the oldest recent batch (three keyframes
        back) with a found/visible ratio below 0.25 or fewer than 2
        observations."""
        m = self.map
        if len(self.recent_pts) < 3:
            return
        batch = self.recent_pts.pop(0)
        batch = batch[m.pt_valid[batch]]
        if len(batch) == 0:
            return
        ratio = m.pt_found[batch] / np.maximum(m.pt_visible[batch], 1)
        bad = (ratio < 0.25) | (m.pt_n_obs[batch] < 2)
        if bad.any():
            m.remove_point(batch[bad])

    def cull_points_pressure(self, kf: int) -> None:
        """When the point store passes 92% of its capacity, remove the
        weakest landmarks (fewest observations, worst found/visible ratio)
        outside the new keyframe's covisibility window, down to 80%."""
        m = self.map
        if m.n_pt <= 0.92 * m.max_pts:
            return
        target = int(0.8 * m.max_pts)
        win = np.unique(np.concatenate(
            [[kf], m.covisible_kfs(kf, n=12, min_weight=5)]))
        prot = np.unique(m.kf_match_pt[win])
        prot = prot[prot >= 0]
        protected = np.zeros(m.max_pts, bool)
        protected[prot] = True
        ids = np.nonzero(m.pt_valid & ~protected)[0]
        if len(ids) == 0:
            return
        ratio = m.pt_found[ids] / np.maximum(m.pt_visible[ids], 1)
        weakness = m.pt_n_obs[ids].astype(np.float64) + ratio
        order = np.argsort(weakness)
        n_remove = min(m.n_pt - target, len(ids))
        if n_remove > 0:
            m.remove_point(ids[order[:n_remove]])

    def create_new_points(self, kf: int) -> None:
        """Triangulate unmatched features of `kf` against its 10 best
        covisible keyframes: baseline / median-depth gate, the epipolar
        matcher, then the triangulator (parallax cos 0.9998, octave-scaled
        reprojection gates)."""
        m = self.map
        neighbors = m.covisible_kfs(kf, n=10, min_weight=5)
        d = self._dev
        pose2 = d(m.kf_pose_cw[kf])
        uv2 = d(m.kf_feat_uv[kf])
        d2 = d(m.kf_feat_desc[kf])
        ang2 = d(m.kf_feat_angle[kf])
        free2 = m.kf_feat_valid[kf] & (m.kf_match_pt[kf] == INVALID)
        created = []
        C2 = -m.kf_pose_cw[kf, :, :3].T @ m.kf_pose_cw[kf, :, 3]

        for nb in neighbors:
            if not m.kf_valid[nb]:
                continue
            C1 = -m.kf_pose_cw[nb, :, :3].T @ m.kf_pose_cw[nb, :, 3]
            baseline = np.linalg.norm(C2 - C1)
            med_depth = self._median_depth(nb)
            if med_depth <= 0 or baseline / med_depth < 0.01:
                continue
            free1 = m.kf_feat_valid[nb] & (m.kf_match_pt[nb] == INVALID)
            pose1 = d(m.kf_pose_cw[nb])
            idx2, ok = self.epi_match(
                pose1, pose2, d(m.kf_feat_uv[nb]), d(m.kf_feat_desc[nb]),
                d(free1), uv2, d2, d(free2), d(m.kf_feat_angle[nb]), ang2)
            ok_np = self._host(ok)
            if ok_np.sum() == 0:
                continue
            idx2_np = self._host(idx2)
            uv_b = m.kf_feat_uv[kf][idx2_np]
            Xw, good = self.triangulate(
                pose1, pose2, d(m.kf_feat_uv[nb]), d(uv_b), ok,
                min_parallax_cos=0.9998, oct1=d(m.kf_feat_octave[nb]),
                oct2=d(m.kf_feat_octave[kf][idx2_np]))
            good_np = self._host(good)
            if good_np.sum() == 0:
                continue
            f1_ids = np.nonzero(good_np)[0]
            f2_ids = idx2_np[good_np]
            # avoid double-binding a feature in kf
            fresh = m.kf_match_pt[kf][f2_ids] == INVALID
            f1_ids, f2_ids = f1_ids[fresh], f2_ids[fresh]
            if len(f1_ids) == 0:
                continue
            pts = m.alloc_points(len(f1_ids))
            n_new = len(pts)
            f1_ids, f2_ids = f1_ids[:n_new], f2_ids[:n_new]
            m.pt_xyz[pts] = self._host(Xw)[f1_ids[:n_new]]
            m.pt_desc[pts] = m.kf_feat_desc[kf][f2_ids]
            m.pt_first_kf[pts] = kf
            m.pt_n_obs[pts] = 2
            m.pt_found[pts] = 2
            m.pt_visible[pts] = 2
            m.kf_match_pt[nb, f1_ids] = pts
            m.kf_match_pt[kf, f2_ids] = pts
            free2 = m.kf_feat_valid[kf] & (m.kf_match_pt[kf] == INVALID)
            created.append(pts)
        if created:
            self.recent_pts.append(np.concatenate(created))
            m.update_covisibility(kf)

    def cull_lines(self) -> None:
        """`cull_points`' rule on the oldest recent batch of lines."""
        m = self.map
        if len(self.recent_lns) < 3:
            return
        batch = self.recent_lns.pop(0)
        batch = batch[m.ln_valid[batch]]
        if len(batch) == 0:
            return
        ratio = m.ln_found[batch] / np.maximum(m.ln_visible[batch], 1)
        bad = (ratio < 0.25) | (m.ln_n_obs[batch] < 2)
        if bad.any():
            m.remove_line(batch[bad])

    def cull_lines_pressure(self, kf: int) -> None:
        """The line store's twin of cull_points_pressure."""
        m = self.map
        if m.n_ln <= 0.92 * m.max_lines:
            return
        target = int(0.8 * m.max_lines)
        win = np.unique(np.concatenate(
            [[kf], m.covisible_kfs(kf, n=12, min_weight=5)]))
        prot = np.unique(m.kf_match_ln[win])
        prot = prot[prot >= 0]
        protected = np.zeros(m.max_lines, bool)
        protected[prot] = True
        ids = np.nonzero(m.ln_valid & ~protected)[0]
        if len(ids) == 0:
            return
        ratio = m.ln_found[ids] / np.maximum(m.ln_visible[ids], 1)
        weakness = m.ln_n_obs[ids].astype(np.float64) + ratio
        order = np.argsort(weakness)
        n_remove = min(m.n_ln - target, len(ids))
        if n_remove > 0:
            m.remove_line(ids[order[:n_remove]])

    def update_point_stats(self, kf: int) -> None:
        """The statistics of the points bound in `kf`: the distinctive
        descriptor (least summed Hamming distance to the other
        observations, up to 8 of them), the mean viewing normal and the
        scale-invariance distance range from the newest observation's
        octave, which the projection matcher's frustum gates read."""
        m = self.map
        pt_ids = np.unique(m.kf_match_pt[kf])
        pt_ids = pt_ids[pt_ids >= 0]
        pt_ids = pt_ids[m.pt_valid[pt_ids]]
        if len(pt_ids) == 0:
            return
        kfs = m.valid_kf_indices()
        match = m.kf_match_pt[kfs]                            # [K,F]
        sel = np.isin(match, pt_ids)
        ks, fs = np.nonzero(sel)
        pts = match[ks, fs]
        order = np.argsort(pts, kind="stable")
        ks, fs, pts = ks[order], fs[order], pts[order]
        starts = np.searchsorted(pts, pt_ids, side="left")
        ends = np.searchsorted(pts, pt_ids, side="right")

        C_all = np.einsum("kji,kj->ki",
                          m.kf_pose_cw[kfs][:, :, :3],
                          -m.kf_pose_cw[kfs][:, :, 3])        # centers
        scale = 1.2
        n_levels = 8
        G = 8
        n_obs_pt = ends - starts
        use = n_obs_pt >= 2
        if not use.any():
            return
        pt_sel = pt_ids[use]
        s0 = starts[use]
        cnt = np.minimum(n_obs_pt[use], G)
        gidx = s0[:, None] + np.arange(G)[None, :]            # [N,G]
        gmask = np.arange(G)[None, :] < cnt[:, None]
        gidx = np.minimum(gidx, len(ks) - 1)
        okf = ks[gidx]                                        # [N,G]
        ofe = fs[gidx]
        X = m.pt_xyz[pt_sel]                                  # [N,3]
        v = X[:, None, :] - C_all[okf]                        # [N,G,3]
        dist = np.linalg.norm(v, axis=-1)
        v = v / np.maximum(dist[..., None], 1e-9)
        v = np.where(gmask[..., None], v, 0.0)
        nrm = v.sum(1)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                          1e-9)
        m.pt_normal[pt_sel] = nrm.astype(np.float32)
        # distance range from the newest observation's octave
        ts = np.where(gmask, m.kf_timestamp[kfs[okf]], -np.inf)
        j = np.argmax(ts, axis=1)
        ar = np.arange(len(pt_sel))
        lvl = m.kf_feat_octave[kfs[okf[ar, j]], ofe[ar, j]]
        dist_ref = dist[ar, j]
        m.pt_max_dist[pt_sel] = (dist_ref * scale ** lvl).astype(np.float32)
        m.pt_min_dist[pt_sel] = (m.pt_max_dist[pt_sel]
                                 / scale ** (n_levels - 1))
        # distinctive descriptor: least mean Hamming distance to the others
        descs = m.kf_feat_desc[kfs[okf], ofe]                 # [N,G,8] u32
        bits = np.unpackbits(
            descs.view(np.uint8).reshape(len(pt_sel), G, 32), axis=-1)
        ham = (bits[:, :, None, :] != bits[:, None, :, :]).sum(-1)
        pair_ok = gmask[:, :, None] & gmask[:, None, :]
        ham = np.where(pair_ok, ham, 0)
        med = ham.sum(-1) / np.maximum(cnt[:, None] - 1, 1)
        med = np.where(gmask, med, 1e9)
        best = np.argmin(med, axis=1)
        m.pt_desc[pt_sel] = descs[ar, best]

    def _median_depth(self, kf: int) -> float:
        m = self.map
        pts = m.kf_match_pt[kf]
        pts = pts[pts >= 0]
        if len(pts) == 0:
            return -1.0
        X = m.pt_xyz[pts]
        R, t = m.kf_pose_cw[kf, :, :3], m.kf_pose_cw[kf, :, 3]
        z = (R @ X.T).T[:, 2] + t[2]
        return float(np.median(z))

    # ------------------------------------------------------------------
    def local_ba(self, kf: int) -> None:
        """Windowed BA: covisible KFs free, their observers fixed, points
        (and multi-view lines) Schur-eliminated."""
        m = self.map
        window = m.covisible_kfs(kf, n=self.ba_kf_cap - 6, min_weight=5)
        window = np.concatenate([[kf], window[m.kf_valid[window]]])
        window = window[:self.ba_kf_cap]
        in_window = np.zeros(m.max_kf, bool)
        in_window[window] = True

        # points seen by the window
        pt_ids = np.unique(m.kf_match_pt[window])
        pt_ids = pt_ids[pt_ids >= 0]
        pt_ids = pt_ids[m.pt_valid[pt_ids]][:self.ba_pt_cap]
        pt_slot = np.full(m.max_pts, -1, np.int32)
        pt_slot[pt_ids] = np.arange(len(pt_ids))

        # fixed KFs: observers of those points outside the window
        fixed = []
        kf_slot = np.full(m.max_kf, -1, np.int32)
        slots = list(window)
        for i, w in enumerate(window):
            kf_slot[w] = i
        for other in m.valid_kf_indices():
            if in_window[other]:
                continue
            shared = np.isin(m.kf_match_pt[other], pt_ids) \
                & (m.kf_match_pt[other] >= 0)
            if shared.sum() > 0 and len(slots) < self.ba_kf_cap:
                kf_slot[other] = len(slots)
                slots.append(other)
                fixed.append(other)
        slots = np.asarray(slots)

        # gauge: always fix at least the oldest KF in the system
        free_mask = np.zeros(self.ba_kf_cap, bool)
        free_mask[:len(window)] = True
        if len(fixed) == 0:
            oldest = np.argmin(m.kf_timestamp[window])
            free_mask[oldest] = False

        # observation table
        obs_kf, obs_pt, obs_uv, obs_is2 = [], [], [], []
        for s, kfi in enumerate(slots):
            match = m.kf_match_pt[kfi]
            feat = np.nonzero((match >= 0) & np.isin(match, pt_ids))[0]
            obs_kf.append(np.full(len(feat), s, np.int32))
            obs_pt.append(pt_slot[match[feat]])
            obs_uv.append(self._ba_uv(m)[kfi, feat])
            obs_is2.append(1.0 / 1.2 ** (2.0 * m.kf_feat_octave[kfi, feat]))
        obs_kf = np.concatenate(obs_kf)[:self.ba_obs_cap]
        obs_pt = np.concatenate(obs_pt)[:self.ba_obs_cap]
        obs_uv = np.concatenate(obs_uv)[:self.ba_obs_cap]
        obs_is2 = np.concatenate(obs_is2)[:self.ba_obs_cap]
        n_obs = len(obs_kf)

        def pad(a, cap, fill=0):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:len(a)] = a
            return out

        kf_poses = np.tile(np.eye(3, 4, dtype=np.float32),
                           (self.ba_kf_cap, 1, 1))
        kf_poses[:len(slots)] = m.kf_pose_cw[slots]
        pt_xyz = np.zeros((self.ba_pt_cap, 3), np.float32)
        pt_xyz[:len(pt_ids)] = m.pt_xyz[pt_ids]
        pt_free = np.zeros(self.ba_pt_cap, bool)
        pt_free[:len(pt_ids)] = True

        ln_ids = np.zeros(0, np.int32)
        use_pl = False
        if self.use_lines:
            ln_ids = np.unique(m.kf_match_ln[window])
            ln_ids = ln_ids[ln_ids >= 0]
            ln_ids = ln_ids[m.ln_valid[ln_ids]]
            # only multi-view-confirmed lines optimize poses
            ln_ids = ln_ids[m.ln_n_obs[ln_ids] >= 3][:self.ba_ln_cap]
            use_pl = len(ln_ids) >= 8
        if use_pl:
            ln_slot = np.full(m.max_lines, -1, np.int32)
            ln_slot[ln_ids] = np.arange(len(ln_ids))
            lobs_kf, lobs_ln, lobs_eq, lobs_dir = [], [], [], []
            for s, kfi in enumerate(slots):
                match = m.kf_match_ln[kfi]
                feat = np.nonzero((match >= 0) & np.isin(match, ln_ids))[0]
                if len(feat) == 0:
                    continue
                lobs_kf.append(np.full(len(feat), s, np.int32))
                lobs_ln.append(ln_slot[match[feat]])
                ep = m.kf_line_ep[kfi, feat]
                sp = np.concatenate([ep[:, :2], np.ones((len(ep), 1))], 1)
                e_ = np.concatenate([ep[:, 2:], np.ones((len(ep), 1))], 1)
                l = np.cross(sp, e_)
                l /= np.maximum(np.linalg.norm(l[:, :2], axis=1,
                                               keepdims=True), 1e-9)
                lobs_eq.append(l.astype(np.float32))
                d = ep[:, 2:] - ep[:, :2]
                d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True),
                                1e-6)
                lobs_dir.append(d.astype(np.float32))
            lobs_kf = np.concatenate(lobs_kf)[:self.ba_lobs_cap]
            lobs_ln = np.concatenate(lobs_ln)[:self.ba_lobs_cap]
            lobs_eq = np.concatenate(lobs_eq)[:self.ba_lobs_cap]
            lobs_dir = np.concatenate(lobs_dir)[:self.ba_lobs_cap]
            n_lobs = len(lobs_kf)
            ln_ep6 = np.zeros((self.ba_ln_cap, 6), np.float32)
            ln_ep6[:len(ln_ids)] = m.ln_ep[ln_ids]
            ln_free = np.zeros(self.ba_ln_cap, bool)
            ln_free[:len(ln_ids)] = True
        d = self._sol
        self.ba_stats = []
        if use_pl and self.local_ba_lines_kernel is not None:
            # SLAM modes 1-3: the poses from the line observations alone,
            # the points held fixed
            self.ba_path = "lines"
            new_poses, new_lns, _ = self.local_ba_lines_kernel(
                d(kf_poses), d(free_mask), d(ln_ep6), d(ln_free),
                d(pad(lobs_kf, self.ba_lobs_cap)),
                d(pad(lobs_ln, self.ba_lobs_cap)),
                d(pad(lobs_eq, self.ba_lobs_cap)),
                d(pad(lobs_dir, self.ba_lobs_cap)),
                d(pad(np.ones(n_lobs, bool), self.ba_lobs_cap, False)),
                d(pad(np.ones(n_lobs, np.float32), self.ba_lobs_cap)),
                stats=self.ba_stats)
            m.ln_ep[ln_ids] = self._host(new_lns)[:len(ln_ids)]
            new_pts = pt_xyz
            inlier = np.ones(self.ba_obs_cap, bool)
        elif use_pl:
            self.ba_path = "pl"
            (new_poses, new_pts, new_lns, inlier, _) = \
                self.local_ba_pl_kernel(
                    d(kf_poses), d(free_mask), d(pt_xyz), d(pt_free),
                    d(pad(obs_kf, self.ba_obs_cap)),
                    d(pad(obs_pt, self.ba_obs_cap)),
                    d(pad(obs_uv, self.ba_obs_cap)),
                    d(pad(np.ones(n_obs, bool), self.ba_obs_cap, False)),
                    d(pad(obs_is2.astype(np.float32), self.ba_obs_cap)),
                    d(ln_ep6), d(ln_free),
                    d(pad(lobs_kf, self.ba_lobs_cap)),
                    d(pad(lobs_ln, self.ba_lobs_cap)),
                    d(pad(lobs_eq, self.ba_lobs_cap)),
                    d(pad(np.ones(n_lobs, bool), self.ba_lobs_cap, False)),
                    d(pad(np.ones(n_lobs, np.float32), self.ba_lobs_cap)),
                    stats=self.ba_stats)
            m.ln_ep[ln_ids] = self._host(new_lns)[:len(ln_ids)]
        else:
            self.ba_path = "pt"
            new_poses, new_pts, inlier = self.local_ba_kernel(
                d(kf_poses), d(free_mask), d(pt_xyz), d(pt_free),
                d(pad(obs_kf, self.ba_obs_cap)),
                d(pad(obs_pt, self.ba_obs_cap)),
                d(pad(obs_uv, self.ba_obs_cap)),
                d(pad(np.ones(n_obs, bool), self.ba_obs_cap, False)),
                d(pad(obs_is2.astype(np.float32), self.ba_obs_cap)),
                stats=self.ba_stats)

        self.ba_calls.append(dict(path="lba", window=len(slots),
                                  iters=list(self.ba_stats)))
        new_poses = self._host(new_poses)
        if torch.is_tensor(new_pts):
            new_pts, inlier = self._host(new_pts), self._host(inlier)
        wr = free_mask[:len(slots)] \
            & np.isfinite(new_poses[:len(slots)]).all((1, 2))
        m.kf_pose_cw[slots[wr]] = new_poses[:len(slots)][wr]
        okp = np.isfinite(new_pts[:len(pt_ids)]).all(1)
        m.pt_xyz[pt_ids[okp]] = new_pts[:len(pt_ids)][okp]

        # drop observations judged outliers by the BA
        bad = ~inlier[:n_obs]
        if bad.any():
            for s, kfi in enumerate(slots):
                sel = (obs_kf == s) & bad
                if sel.any():
                    # find features bound to these points and unbind
                    bad_pts = pt_ids[obs_pt[sel]]
                    match = m.kf_match_pt[kfi]
                    unbind = np.isin(match, bad_pts)
                    m.kf_match_pt[kfi, unbind] = INVALID
                    m.pt_n_obs[bad_pts] -= 1
        # points that lost all observations are bad
        orphan = pt_ids[m.pt_n_obs[pt_ids] < 1]
        if len(orphan):
            m.remove_point(orphan)

    # ------------------------------------------------------------------
    # Inertial: initialization, scale refinement and the window BAs
    # ------------------------------------------------------------------
    @staticmethod
    def _pre_const(p):
        return {"dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP,
                "JRg": p.JRg, "JVg": p.JVg, "JVa": p.JVa,
                "JPg": p.JPg, "JPa": p.JPa,
                "bg0": p.bias_gyro, "ba0": p.bias_acc}

    def _chain_preints(self, chain):
        """Preintegrations between consecutive chain KFs (stored at the
        later KF), parallel to chain[1:]; None where raw data is
        missing."""
        m = self.map
        return [m.kf_preint.get(int(k)) for k in chain[1:]]

    def _push_transform(self, R_gw, s):
        """Compose map transforms if several fire before the tracker
        consumes them."""
        if self.pending_transform is None:
            self.pending_transform = (R_gw, s)
        else:
            R0, s0 = self.pending_transform
            self.pending_transform = (R_gw @ R0, s * s0)

    def _stack_consts(self, preints, cap):
        """The stacked preintegration constants [cap-1, ...] on the device,
        identity-filled where a link has none."""
        return {key: self._sol(v)
                for key, v in self._stack_consts_np(preints, cap).items()}

    def _stack_consts_np(self, preints, cap):
        """`_stack_consts` in numpy (float32)."""
        ident = IMU.identity_preintegrated(device="cpu")
        ident = IMU.Preintegrated(*(np.asarray(v) for v in ident))
        vals = [preints[i] if i < len(preints) and preints[i] is not None
                else ident for i in range(cap - 1)]
        return {key: np.stack(
            [np.asarray(self._pre_const(p)[key], np.float32)
             for p in vals]) for key in self._pre_const(ident)}

    def _chain_gs_inputs(self, chain, cap):
        """Padded (pose_R, pose_p, stacked preint consts, infos,
        edge_valid) for the gravity/scale problems over a KF chain."""
        m = self.map
        n = len(chain)
        preints = self._chain_preints(chain)
        m.recompute_body_poses(self.Tbc)
        pose_R = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
        pose_p = np.zeros((cap, 3), np.float32)
        pose_R[:n] = m.kf_pose_wb[chain, :, :3]
        pose_p[:n] = m.kf_pose_wb[chain, :, 3]
        stack = self._stack_consts(preints, cap)
        infos = []
        edge_valid = np.zeros(cap - 1, bool)
        for i in range(cap - 1):
            p = preints[i] if i < len(preints) else None
            if p is not None and float(p.dT) > 1e-4:
                C9 = np.asarray(p.C)[:9, :9] + np.eye(9) * 1e-8
                infos.append(np.linalg.inv(C9))
                edge_valid[i] = True
            else:
                infos.append(np.eye(9))
        infos = np.stack(infos).astype(np.float32)
        return pose_R, pose_p, stack, infos, edge_valid

    def refine_scale(self) -> None:
        """One gravity / scale refinement pulse over the recent chain; the
        map is re-expressed when the scale is off (converged below 1e-3,
        or 5% off after convergence) or the gravity direction is off by
        more than 0.15 deg (then at most once in 2.5 s)."""
        m = self.map
        chain = m.kf_chain()[-self.imu_init_cap:]
        if len(chain) < 4:
            return
        n = len(chain)
        cap = self.imu_init_cap
        pose_R, pose_p, stack, infos, edge_valid = self._chain_gs_inputs(
            chain, cap)
        vel = np.zeros((cap, 3), np.float32)
        vel[:n] = m.kf_vel[chain]
        newest = chain[-1]
        d = self._sol
        Rwg, s = self.scale_refine_kernel(
            d(np.eye(3, dtype=np.float32)), d(vel),
            d(m.kf_bias_g[newest].astype(np.float32)),
            d(m.kf_bias_a[newest].astype(np.float32)), stack, d(pose_R),
            d(pose_p), d(infos), d(edge_valid))
        s = float(self._host(s))
        Rwg_np = self._host(Rwg)
        g_ang = float(np.linalg.norm(lie.so3_log(
            torch.from_numpy(np.asarray(Rwg_np, np.float32))).numpy()))
        self.n_refine += 1
        if not np.isfinite(s) or s < 0.3 or s > 3.0 \
                or not np.isfinite(g_ang):
            return
        if abs(s - 1.0) < 1e-3:
            self.map.imu_ba2 = True   # scale converged
        # the gravity direction is corrected independently of the scale
        scale_off = (not self.map.imu_ba2 and abs(s - 1.0) >= 1e-3) \
            or abs(s - 1.0) >= 0.05
        grav_off = g_ang > np.radians(0.15)
        if grav_off and not scale_off:
            # rate-limit pure-gravity corrections
            ts_new = float(m.kf_timestamp[newest])
            last = self._last_gfix.get(m.map_id, -1e18)
            if ts_new - last < 2.5:
                grav_off = False
            else:
                self._last_gfix[m.map_id] = ts_new
        if not scale_off and not grav_off:
            return
        s_apply = s if scale_off else 1.0
        R_gw = Rwg_np.T
        m.apply_scaled_rotation(R_gw, s_apply, self.Tbc)
        self._push_transform(R_gw, s_apply)

    def maybe_initialize_imu(self, min_kfs: int = 8,
                             min_span: float = 1.9) -> None:
        """Once the chain holds `min_kfs` keyframes over `min_span` s: solve
        the gravity direction, scale, biases and velocities with the poses
        fixed, re-express the map in the gravity-aligned metric frame,
        reintegrate the stored IMU windows at the biases and run the
        inertial window BA over the recent chain."""
        m = self.map
        chain = m.kf_chain()
        if len(chain) < min_kfs:
            return
        span = m.kf_timestamp[chain[-1]] - m.kf_timestamp[chain[0]]
        if span < min_span:
            return
        chain = chain[-self.imu_init_cap:]
        preints = self._chain_preints(chain)
        ok_edges = [p is not None and float(p.dT) > 1e-4 for p in preints]
        if sum(ok_edges) < min_kfs - 1:
            return

        cap = self.imu_init_cap
        n = len(chain)
        m.recompute_body_poses(self.Tbc)
        pose_R = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
        pose_p = np.zeros((cap, 3), np.float32)
        pose_R[:n] = m.kf_pose_wb[chain, :, :3]
        pose_p[:n] = m.kf_pose_wb[chain, :, 3]
        stack = self._stack_consts(preints, cap)
        infos = []
        edge_valid = np.zeros(cap - 1, bool)
        for i in range(cap - 1):
            if i < len(preints) and preints[i] is not None and ok_edges[i]:
                C9 = np.asarray(preints[i].C)[:9, :9] + np.eye(9) * 1e-8
                infos.append(np.linalg.inv(C9))
                edge_valid[i] = True
            else:
                infos.append(np.eye(9))
        infos = np.stack(infos).astype(np.float32)

        # initial velocities: position differences over the chain
        vel0 = np.zeros((cap, 3), np.float32)
        dts = np.diff(m.kf_timestamp[chain])
        dp = np.diff(pose_p[:n], axis=0)
        v = dp / np.maximum(dts[:, None], 1e-3)
        vel0[:n - 1] = v
        vel0[n - 1] = v[-1]

        # initial gravity direction: average accelerometer in world
        dirG = np.zeros(3)
        for i, p in enumerate(preints):
            if p is not None:
                dirG -= pose_R[i + 1] @ np.asarray(p.avg_a)
        nrm = np.linalg.norm(dirG)
        if nrm < 1e-6:
            return
        dirG /= nrm
        gI = np.array([0.0, 0.0, -1.0])
        vx = np.cross(gI, dirG)
        s_ = np.linalg.norm(vx)
        ang = np.arctan2(s_, float(gI @ dirG))
        Rwg0 = lie.so3_exp(torch.from_numpy(
            (vx / max(s_, 1e-9) * ang).astype(np.float32))).numpy()

        d = self._sol
        Rwg, scale, bg, ba, vel = self.imu_init_kernel(
            d(Rwg0.astype(np.float32)), d(vel0), stack, d(pose_R),
            d(pose_p), d(infos), d(edge_valid))
        scale = float(self._host(scale))
        if scale < 1e-2:   # degenerate
            return
        bg = self._host(bg)
        ba = self._host(ba)

        # velocities and biases (SLAM frame), then the map re-expressed in
        # the gravity-aligned metric frame
        m.kf_vel[chain] = self._host(vel)[:n]
        kfs = m.valid_kf_indices()
        m.kf_bias_g[kfs] = bg
        m.kf_bias_a[kfs] = ba
        R_gw = self._host(Rwg).T
        m.apply_scaled_rotation(R_gw, scale, self.Tbc)

        # reintegrate stored KF windows at the solved biases
        for k in list(m.kf_imu_raw.keys()):
            g_, a_, d_ = m.kf_imu_raw[k]
            m.kf_preint[k] = self._reintegrate(g_, a_, d_, bg, ba)

        m.imu_initialized = True
        t0_init = float(m.kf_timestamp[chain[-1]])
        self._viba[m.map_id] = {"t0": t0_init, "last": t0_init,
                                "v2": False}
        self._push_transform(R_gw, scale)
        self.init_scale = scale
        # the inertial window BA over the recent chain
        self.local_inertial_ba(int(chain[-1]), window=min(len(chain),
                                                          self.ba_kf_cap))
        m.imu_ba1 = True

    def _reintegrate(self, g, a, d, bg, ba):
        """The raw samples preintegrated at the biases (bg, ba) on
        `imu_preint`, padded to 64 samples (doubled until they fit); a
        Preintegrated of numpy arrays, read back in one transfer."""
        cap = 64
        while cap < len(g):
            cap *= 2
        gg = np.zeros((cap, 3), np.float32)
        aa = np.zeros((cap, 3), np.float32)
        dd = np.zeros((cap,), np.float32)
        mm = np.zeros((cap,), bool)
        gg[:len(g)] = g
        aa[:len(a)] = a
        dd[:len(d)] = d
        mm[:len(d)] = True
        dv = self._dev
        out = self._preint(
            dv(gg), dv(aa), dv(dd), dv(mm), self.calib,
            dv(np.asarray(bg, np.float32)), dv(np.asarray(ba, np.float32)),
            dv(np.eye(3, 4, dtype=np.float32)), dv(np.zeros(3, np.float32)))
        pre = out.pre
        flat = self._host(torch.cat([v.reshape(-1) for v in pre]))
        fields, off = [], 0
        for v in pre:
            fields.append(flat[off:off + v.numel()].reshape(tuple(v.shape)))
            off += v.numel()
        return IMU.Preintegrated(*fields)

    def local_inertial_ba(self, kf: int, window: Optional[int] = None) -> None:
        """The sliding-window VI BA over the temporal chain: the newest
        lba_window + 1 keyframes, the oldest fixed as the anchor, and the
        spare slots filled with the most covisible older keyframes as
        fixed visual observers (their inertial edges masked)."""
        m = self.map
        W = min(window or min(self.cfg.tracking.lba_window + 1,
                              self.ba_kf_cap), self.ba_kf_cap)
        chain = m.kf_chain()
        if len(chain) < 3:
            return
        win = chain[-W:]
        free = np.zeros(len(win), bool)
        free[1:] = True         # anchor = oldest window KF
        rest = chain[:-W]
        spare = self.ba_kf_cap - len(win)
        if len(rest) and spare > 0:
            wts = m.covis[np.ix_(rest, win)].sum(1)
            order = np.argsort(-wts)[:spare]
            extra = rest[order][wts[order] > 0]
            if len(extra):
                extra = extra[np.argsort(m.kf_timestamp[extra])]
                win = np.concatenate([extra, win])
                free = np.concatenate(
                    [np.zeros(len(extra), bool), free])
        self._liba_window(win, free)

    def _viba_pulse_step(self, st: dict, sweeps: int = 2,
                         halo: int = 2) -> bool:
        """One slice of the periodic full-map pulse: the whole chain in one
        solve up to viba_kf_cap keyframes; past it the sweeps x blocks
        schedule of full_inertial_ba is queued once (block starts only)
        and each call runs one block.  Returns True when the pulse
        completed."""
        m = self.map
        chain = m.kf_chain()
        if len(chain) <= self.viba_kf_cap:
            self.full_inertial_ba(sweeps=sweeps, halo=halo)
            return True
        pending = st.get("pulse_blocks")
        if pending is None:
            W = self.viba_kf_cap - 2 * halo
            pending = [b0 for _ in range(sweeps)
                       for b0 in range(0, len(chain), W)]
            st["pulse_blocks"] = pending
        W = self.viba_kf_cap - 2 * halo
        while pending:
            b0 = pending.pop(0)
            if b0 >= len(chain):
                continue
            pos_of = {int(k): i for i, k in enumerate(chain)}
            block = chain[max(0, b0 - halo):b0 + W + halo]
            free = np.array([b0 <= pos_of[int(k)] < b0 + W
                             for k in block])
            free[block == chain[0]] = False
            if free.all():
                free[0] = False
            if free.any():
                self._liba_window(block, free, big=True)
                break
        if not pending:
            st["pulse_blocks"] = None
            return True
        return False

    def full_inertial_ba(self, sweeps: int = 2, halo: int = 2) -> None:
        """The full-map visual-inertial BA: the whole chain in one window
        (the oldest keyframe fixed) up to viba_kf_cap keyframes, else
        contiguous chain blocks with frozen halo keyframes, swept `sweeps`
        times."""
        m = self.map
        chain = m.kf_chain()
        if len(chain) < 3:
            return
        if len(chain) <= self.viba_kf_cap:
            free = np.zeros(len(chain), bool)
            free[1:] = True
            self._liba_window(chain, free,
                              big=len(chain) > self.ba_kf_cap)
            return
        W = self.viba_kf_cap - 2 * halo
        pos_of = {int(k): i for i, k in enumerate(chain)}
        for _ in range(sweeps):
            for b0 in range(0, len(chain), W):
                block = chain[max(0, b0 - halo):b0 + W + halo]
                free = np.array([b0 <= pos_of[int(k)] < b0 + W
                                 for k in block])
                free[block == chain[0]] = False   # global gauge anchor
                if not free.any():
                    continue
                if free.all():
                    free[0] = False
                self._liba_window(block, free, big=True)

    def _window_line_obs(self, win: np.ndarray, ln_cap: int,
                         lobs_cap: int):
        """Line landmarks (multi-view-confirmed: >= 3 observations) and
        their endpoint-to-line observations in the keyframes `win`."""
        m = self.map
        ln_ids = np.unique(m.kf_match_ln[win])
        ln_ids = ln_ids[ln_ids >= 0]
        ln_ids = ln_ids[m.ln_valid[ln_ids]]
        ln_ids = ln_ids[m.ln_n_obs[ln_ids] >= 3][:ln_cap]
        ln_slot = np.full(m.max_lines, -1, np.int32)
        ln_slot[ln_ids] = np.arange(len(ln_ids))
        lobs_kf, lobs_ln, lobs_eq = [], [], []
        for s, kfi in enumerate(win):
            match = m.kf_match_ln[kfi]
            feat = np.nonzero((match >= 0) & np.isin(match, ln_ids))[0]
            if len(feat) == 0:
                continue
            lobs_kf.append(np.full(len(feat), s, np.int32))
            lobs_ln.append(ln_slot[match[feat]])
            ep = m.kf_line_ep[kfi, feat]
            sp = np.concatenate([ep[:, :2], np.ones((len(ep), 1))], 1)
            e_ = np.concatenate([ep[:, 2:], np.ones((len(ep), 1))], 1)
            leq = np.cross(sp, e_)
            leq /= np.maximum(np.linalg.norm(leq[:, :2], axis=1,
                                             keepdims=True), 1e-9)
            lobs_eq.append(leq.astype(np.float32))
        if lobs_kf:
            lobs_kf = np.concatenate(lobs_kf)[:lobs_cap]
            lobs_ln = np.concatenate(lobs_ln)[:lobs_cap]
            lobs_eq = np.concatenate(lobs_eq)[:lobs_cap]
        else:
            lobs_kf = np.zeros(0, np.int32)
            lobs_ln = np.zeros(0, np.int32)
            lobs_eq = np.zeros((0, 3), np.float32)
        return ln_ids, lobs_kf, lobs_ln, lobs_eq

    def _erase_window_outliers(self, win: np.ndarray,
                               pt_ids: np.ndarray, obs_kf: np.ndarray,
                               obs_pt: np.ndarray, obs_uv: np.ndarray,
                               obs_is2: np.ndarray) -> None:
        """Unbind the observations the window solve left chi2-inconsistent
        (chi2 > 5.991 x `_erase_chi2_mult`, which the loop closer raises to
        3 around a merge weld, or depth < 5 cm), recomputed on the host
        from the solved states, and remove the points left with fewer than 2
        observations (1 for stereo / RGB-D).  `pt_n_obs[bad_pts] -= 1`
        subtracts once per point of a keyframe however many of its
        features were unbound, as the reference does.  A KB8 camera's
        window erases nothing (its observations are raw pixels; the
        reference skips the pass, models/local_mapping.py:1316)."""
        m = self.map
        if len(obs_kf) == 0 or self.kb8 is not None:
            return
        T_cw = m.kf_pose_cw[win[obs_kf]]
        X = m.pt_xyz[pt_ids[obs_pt]]
        pc = np.einsum("oij,oj->oi", T_cw[:, :, :3], X) + T_cw[:, :, 3]
        z = pc[:, 2]
        K = self.K
        u = K.fx * pc[:, 0] / np.maximum(z, 1e-6) + K.cx
        v = K.fy * pc[:, 1] / np.maximum(z, 1e-6) + K.cy
        err2 = (u - obs_uv[:, 0]) ** 2 + (v - obs_uv[:, 1]) ** 2
        bad = (err2 * obs_is2 > self._erase_chi2_mult * 5.991) | (z < 0.05)
        if not bad.any():
            return
        for s_loc in np.unique(obs_kf[bad]):
            kfi = int(win[s_loc])
            bad_pts = pt_ids[obs_pt[bad & (obs_kf == s_loc)]]
            match = m.kf_match_pt[kfi]
            unbind = np.isin(match, bad_pts)
            m.kf_match_pt[kfi, unbind] = INVALID
            m.pt_n_obs[bad_pts] -= 1
        min_obs = 1 if self.cfg.sensor in (1, 2, 4) else 2
        dead = pt_ids[m.pt_n_obs[pt_ids] < min_obs]
        if len(dead):
            m.remove_point(dead)

    def _liba_window(self, win: np.ndarray, free_np: np.ndarray,
                     big: bool = False,
                     free_all_biases: bool = False) -> None:
        """One VI-BA solve over the keyframes `win` with `free_np` marking
        the optimizable ones: the sliding window's caps (its half bucket
        when the window fills at most half of them), or with `big` the
        full-map window's.  Non-finite states are never written back."""
        m = self.map
        n = len(win)
        if big:
            cap = self.viba_kf_cap
            pt_cap, obs_cap = self.viba_pt_cap, self.viba_obs_cap
            ln_cap, lobs_cap = self.viba_ln_cap, self.viba_lobs_cap
            if self.viba_kernel is None:
                self.viba_kernel = self._make_liba(cap, pt_cap, obs_cap,
                                                   ln_cap, lobs_cap)
            kernel = self.viba_kernel
            path = "viba"
        else:
            cap = self.ba_kf_cap
            pt_cap, obs_cap = self.ba_pt_cap, self.ba_obs_cap
            ln_cap, lobs_cap = self.liba_ln_cap, self.liba_lobs_cap
            kernel = self.liba_kernel
            path = "liba"
        m.recompute_body_poses(self.Tbc)

        kf_pose_wb = np.tile(np.eye(3, 4, dtype=np.float32), (cap, 1, 1))
        kf_pose_wb[:n] = m.kf_pose_wb[win]
        kf_vel = np.zeros((cap, 3), np.float32)
        kf_vel[:n] = m.kf_vel[win]
        kf_bg = np.zeros((cap, 3), np.float32)
        kf_bg[:n] = m.kf_bias_g[win]
        kf_ba = np.zeros((cap, 3), np.float32)
        kf_ba[:n] = m.kf_bias_a[win]
        kf_free = np.zeros(cap, bool)
        kf_free[:n] = free_np
        kf_free_bias = np.zeros(cap, bool)
        kf_free_bias[:n] = True if free_all_biases else free_np

        # preintegration chain
        preints = self._chain_preints(win)
        stack = self._stack_consts(preints, cap)
        infos = []
        edge_valid = np.zeros(cap - 1, bool)
        rw_g = np.zeros(cap - 1, np.float32)
        rw_a = np.zeros(cap - 1, np.float32)
        for i in range(cap - 1):
            p = preints[i] if i < len(preints) else None
            # an inertial edge only between chain-consecutive entries
            consec = i + 1 < n and int(m.kf_prev[win[i + 1]]) == int(win[i])
            if p is not None and float(p.dT) > 1e-4 and consec:
                C9 = np.asarray(p.C)[:9, :9] + np.eye(9) * 1e-8
                infos.append(np.linalg.inv(C9))
                edge_valid[i] = True
                Cb = np.asarray(p.C)
                rw_g[i] = 1.0 / max(Cb[9:12, 9:12].trace() / 3, 1e-12)
                rw_a[i] = 1.0 / max(Cb[12:15, 12:15].trace() / 3, 1e-12)
            else:
                infos.append(np.eye(9))
        infos = np.stack(infos).astype(np.float32)

        # visual observations of window KFs
        pt_ids = np.unique(m.kf_match_pt[win])
        pt_ids = pt_ids[pt_ids >= 0]
        pt_ids = pt_ids[m.pt_valid[pt_ids]][:pt_cap]
        pt_slot = np.full(m.max_pts, -1, np.int32)
        pt_slot[pt_ids] = np.arange(len(pt_ids))
        obs_kf, obs_pt, obs_uv, obs_is2 = [], [], [], []
        for s, kfi in enumerate(win):
            match = m.kf_match_pt[kfi]
            feat = np.nonzero((match >= 0) & np.isin(match, pt_ids))[0]
            obs_kf.append(np.full(len(feat), s, np.int32))
            obs_pt.append(pt_slot[match[feat]])
            obs_uv.append(self._ba_uv(m)[kfi, feat])
            obs_is2.append(1.0 / 1.2 ** (2.0 * m.kf_feat_octave[kfi, feat]))
        obs_kf = np.concatenate(obs_kf)[:obs_cap]
        obs_pt = np.concatenate(obs_pt)[:obs_cap]
        obs_uv = np.concatenate(obs_uv)[:obs_cap]
        obs_is2 = np.concatenate(obs_is2)[:obs_cap]
        n_obs = len(obs_kf)

        if self._dist_runner is not None:
            self._dist_window(win, n, cap, kf_free, kf_free_bias,
                              self._stack_consts_np(preints, cap), infos, edge_valid, rw_g, rw_a, pt_ids, obs_kf,
                              obs_pt, obs_uv, obs_is2, ln_cap, lobs_cap)
            return

        # the half-cap bucket when the window fits it
        if not big and len(pt_ids) <= pt_cap // 2 \
                and n_obs <= obs_cap // 2:
            pt_cap, obs_cap = pt_cap // 2, obs_cap // 2
            if self._liba_kernel_half is None:
                self._liba_kernel_half = self._make_liba(
                    cap, pt_cap, obs_cap, ln_cap, lobs_cap)
            kernel = self._liba_kernel_half
            path = "liba_half"

        def pad(a, capn, fill=0):
            out = np.full((capn,) + a.shape[1:], fill, a.dtype)
            out[:len(a)] = a
            return out

        pt_xyz = np.zeros((pt_cap, 3), np.float32)
        pt_xyz[:len(pt_ids)] = m.pt_xyz[pt_ids]
        pt_free = np.zeros(pt_cap, bool)
        pt_free[:len(pt_ids)] = True

        d = self._sol
        base_args = (
            d(kf_pose_wb), d(kf_vel), d(kf_bg), d(kf_ba), d(kf_free),
            d(kf_free_bias), d(pt_xyz), d(pt_free), d(pad(obs_kf, obs_cap)),
            d(pad(obs_pt, obs_cap)), d(pad(obs_uv, obs_cap)),
            d(pad(np.ones(n_obs, bool), obs_cap, False)),
            d(pad(obs_is2.astype(np.float32), obs_cap)),
            stack, d(infos), d(edge_valid), d(rw_g), d(rw_a))
        ln_ids = np.zeros(0, np.int32)
        stats = []
        if ln_cap > 0:
            ln_ids, lobs_kf, lobs_ln, lobs_eq = \
                self._window_line_obs(win, ln_cap, lobs_cap)
            ln_ep6 = np.zeros((ln_cap, 6), np.float32)
            ln_ep6[:len(ln_ids)] = m.ln_ep[ln_ids]
            ln_free = np.zeros(ln_cap, bool)
            ln_free[:len(ln_ids)] = True
            out = kernel(
                *base_args, d(ln_ep6), d(ln_free),
                d(pad(lobs_kf, lobs_cap)), d(pad(lobs_ln, lobs_cap)),
                d(pad(lobs_eq, lobs_cap)),
                d(pad(np.ones(len(lobs_kf), bool), lobs_cap, False)),
                stats=stats)
        else:
            out = kernel(*base_args, stats=stats)
        pose_out, vel_out, bg_out, ba_out, pt_out, _, ln_out, _ = out
        self.ba_calls.append(dict(path=path, window=n, iters=stats))

        # finite guards: never write non-finite states into the map
        pose_np = self._host(pose_out)[:n]
        vel_np = self._host(vel_out)[:n]
        bg_np = self._host(bg_out)[:n]
        ba_np = self._host(ba_out)[:n]
        okf = (np.isfinite(pose_np).all((1, 2)) & np.isfinite(vel_np).all(1)
               & np.isfinite(bg_np).all(1) & np.isfinite(ba_np).all(1))
        free = kf_free[:n] & okf
        m.kf_pose_wb[win[free]] = pose_np[free]
        m.kf_vel[win[free]] = vel_np[free]
        free_b = kf_free_bias[:n] & okf
        m.kf_bias_g[win[free_b]] = bg_np[free_b]
        m.kf_bias_a[win[free_b]] = ba_np[free_b]
        m.set_cam_poses_from_body(win[free], self.Tbc)
        pt_np = self._host(pt_out)[:len(pt_ids)]
        okp = np.isfinite(pt_np).all(1)
        m.pt_xyz[pt_ids[okp]] = pt_np[okp]
        if ln_cap > 0 and len(ln_ids):
            ln_new = self._host(ln_out)[:len(ln_ids)]
            okl = np.all(np.isfinite(ln_new), axis=1)
            m.ln_ep[ln_ids[okl]] = ln_new[okl]
        self._erase_window_outliers(win, pt_ids, obs_kf, obs_pt,
                                    obs_uv, obs_is2)

    def _dist_window(self, win, n, cap, kf_free, kf_free_bias, stack, infos,
                     edge_valid, rw_g, rw_a, pt_ids, obs_kf, obs_pt, obs_uv,
                     obs_is2, ln_cap, lobs_cap) -> None:
        """The window solve on the sharded back end (reference
        models/local_mapping.py:1446-1489): the same inputs unpadded,
        the same finite guards and write-back, then the outlier erase."""
        m = self.map
        if ln_cap > 0:
            ln_ids, lobs_kf, lobs_ln, lobs_eq = \
                self._window_line_obs(win, ln_cap, lobs_cap)
        else:
            ln_ids = np.zeros(0, np.int32)
            lobs_kf = lobs_ln = np.zeros(0, np.int32)
            lobs_eq = np.zeros((0, 3), np.float32)
        stack_np = {k: v[:n - 1] for k, v in stack.items()}
        runner = self._dist_runner
        dropped = runner.n_dropped
        (pose_o, vel_o, bg_o, ba_o, pts_o, lns_o) = runner.solve(
            m.kf_pose_wb[win], m.kf_vel[win], m.kf_bias_g[win],
            m.kf_bias_a[win], kf_free[:n], kf_free_bias[:n], obs_kf, obs_pt,
            obs_uv, obs_is2.astype(np.float32), m.pt_xyz[pt_ids], stack_np,
            np.asarray(infos)[:n - 1], edge_valid[:n - 1],
            np.asarray(rw_g)[:n - 1], np.asarray(rw_a)[:n - 1],
            lobs_kf=lobs_kf, lobs_ln=lobs_ln, lobs_eq=lobs_eq,
            ln_ep=m.ln_ep[ln_ids] if len(ln_ids) else None)
        self.host_syncs += 6
        self.ba_calls.append(dict(path="dist", window=n,
                                  iters=runner.last_stats,
                                  dropped=runner.n_dropped - dropped))
        okf = (np.isfinite(pose_o).all((1, 2)) & np.isfinite(vel_o).all(1)
               & np.isfinite(bg_o).all(1) & np.isfinite(ba_o).all(1))
        fr = kf_free[:n] & okf
        m.kf_pose_wb[win[fr]] = pose_o[fr]
        m.kf_vel[win[fr]] = vel_o[fr]
        frb = kf_free_bias[:n] & okf
        m.kf_bias_g[win[frb]] = bg_o[frb]
        m.kf_bias_a[win[frb]] = ba_o[frb]
        m.set_cam_poses_from_body(win[fr], self.Tbc)
        okp = np.isfinite(pts_o).all(1)
        m.pt_xyz[pt_ids[okp]] = pts_o[okp]
        if lns_o is not None and len(ln_ids):
            okl = np.all(np.isfinite(lns_o), axis=1)
            m.ln_ep[ln_ids[okl]] = lns_o[okl]
        self._erase_window_outliers(win, pt_ids, obs_kf, obs_pt, obs_uv,
                                    obs_is2)

    # ------------------------------------------------------------------
    # Keyframe culling
    # ------------------------------------------------------------------
    def _merge_imu_into_next(self, cand: int, nxt: int) -> None:
        """Keep the temporal IMU chain exact across a cull: the culled
        KF's raw window joins its successor's, reintegrated at the
        successor's biases."""
        m = self.map
        empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                 np.zeros((0,), np.float32))
        g1, a1, d1 = m.kf_imu_raw.get(cand, empty)
        g2, a2, d2 = m.kf_imu_raw.get(nxt, empty)
        g = np.concatenate([g1, g2])
        a = np.concatenate([a1, a2])
        d = np.concatenate([d1, d2])
        if len(g):
            m.kf_imu_raw[nxt] = (g, a, d)
            m.kf_preint[nxt] = self._reintegrate(
                g, a, d, m.kf_bias_g[nxt], m.kf_bias_a[nxt])
        m.kf_imu_raw.pop(cand, None)
        m.kf_preint.pop(cand, None)

    def cull_keyframes(self, kf: int, protect=()) -> list:
        """Remove covisible KFs >= 90% of whose bound points are observed
        by >= 3 other KFs at the same or finer octave (+1); inertial maps
        only cull KFs whose neighbours lie within 3 s, merging their IMU
        windows.  Near the store's capacity, the most redundant KFs of the
        chain go down to 75% of it.  Returns [(kf_id, pose_cw,
        timestamp), ...] of the removed KFs."""
        m = self.map
        chain = m.kf_chain()
        if len(chain) < 4:
            return []
        keep = set(int(x) for x in protect)
        keep.add(int(chain[0]))          # the map origin anchors the gauge
        keep.update(int(x) for x in chain[-2:])   # newest KFs still binding
        keep.add(int(kf))
        removed = []
        for cand in m.covisible_kfs(kf, n=12, min_weight=5):
            cand = int(cand)
            if self._cullable(cand, keep) and self._redundancy(cand) > 0.9:
                removed.append(self._do_cull(cand))
        if m.n_kf > 0.85 * m.max_kf:
            target = int(0.75 * m.max_kf)
            cands = [(self._redundancy(int(c)), int(c))
                     for c in m.kf_chain()
                     if self._cullable(int(c), keep, max_gap=10.0)]
            cands.sort(reverse=True)
            for red, cand in cands:
                if m.n_kf <= target or red < 0.5:
                    break
                if m.kf_valid[cand]:
                    removed.append(self._do_cull(cand))
        return removed

    def _cullable(self, cand: int, keep, max_gap: float = 3.0) -> bool:
        m = self.map
        if not m.kf_valid[cand] or cand in keep:
            return False
        if (m.kf_match_pt[cand] >= 0).sum() < 10:
            return False
        if self.use_imu:
            prev, nxt = int(m.kf_prev[cand]), int(m.kf_next[cand])
            if prev < 0 or nxt < 0 or not m.kf_valid[nxt]:
                return False
            if m.kf_timestamp[nxt] - m.kf_timestamp[prev] > max_gap:
                return False
        return True

    def _redundancy(self, cand: int) -> float:
        """Share of `cand`'s bound points observed by >= 3 other KFs at
        the same or finer octave (+1)."""
        m = self.map
        feat = np.nonzero(m.kf_match_pt[cand] >= 0)[0]
        if len(feat) == 0:
            return 0.0
        pid = m.kf_match_pt[cand, feat]
        oct_c = m.kf_feat_octave[cand, feat]
        n_good = np.zeros(len(pid), np.int32)
        for o in np.nonzero((m.covis[cand] > 0) & m.kf_valid)[0]:
            if o == cand:
                continue
            fo = np.nonzero(m.kf_match_pt[o] >= 0)[0]
            po = m.kf_match_pt[o, fo]
            oct_map = np.full(m.max_pts, 127, np.int32)
            oct_map[po] = m.kf_feat_octave[o, fo]
            n_good += oct_map[pid] <= oct_c + 1
        return float((n_good >= 3).mean())

    def _do_cull(self, cand: int):
        m = self.map
        pose = m.kf_pose_cw[cand].copy()
        ts = float(m.kf_timestamp[cand])
        if self.use_imu:
            self._merge_imu_into_next(cand, int(m.kf_next[cand]))
        m.remove_keyframe(cand)
        if self.kfdb is not None:
            self.kfdb.remove_keyframe(cand)
        self.n_culled += 1
        return (cand, pose, ts)
