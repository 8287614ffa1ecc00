"""The tracker's host state machine, as far as the monocular bootstrap runs
it (port of plvio_tpu/models/tracking.py: `TrackState`, `FrameRecord`
and of `Tracker` the state it reads and writes (:155-192), `grab_imu`
:199, `_preintegrate_batches` :208, the timestamp guards and the
NO_IMAGES_YET / NOT_INITIALIZED branch of `process_frame` :246-279,
`_make_record` :369, `_initialize_mono` :384, `_create_initial_map` :421,
`_triangulate_init_lines` :491, `_store_kf_features` :646, `_cw_to_wb`
:665, `_wb_to_cw` :674 and `_store_kf_inertial` :1424).

The host bookkeeping is the reference's, line for line, on the port's
numpy `MapStore`; the device calls are the port's kernels: the init match
(`hamming_match`'s window mode and `rot_hist`), the two-view
reconstruction (`twoview_hypotheses` and `twoview_recover`), the line
pair matcher and `line_triangulate`, and the keyframe preintegration
(`imu_preint`).  Kernel outputs come back to numpy where the reference
calls `np.asarray`, and each such read is counted in `host_syncs`.
`plain=True` runs the kernels' plain PyTorch versions on any device.

The RANSAC samples of each attempt come from the tracker's
`torch.Generator` (seeded with `cfg.seed`, drawn once per attempt as the
reference splits its key per attempt), or from `sampler(valid)` ->
(idx_h, idx_f) where the caller gives one.  The tracking branches of
`process_frame` (the state OK and after) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..cuda import HostIO, resolve_device
from ..ops import imu as IMU
from ..ops import matching as M
from ..ops import twoview as TV
from ..solver.residuals import PinholeK
from . import kernels as KN
from .mapstore import INVALID, Atlas, MapStore

_NOT_PORTED = ("is not ported yet: the tracking branches of "
               "Tracker.process_frame come with the host tracker")


class TrackState(IntEnum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class FrameRecord:
    """A tracked frame's pose relative to its reference keyframe."""
    timestamp: float
    ref_kf: int
    T_cr: np.ndarray  # [3,4] frame-from-refKF
    map_id: int = 0


class Tracker(HostIO):
    def __init__(self, cfg: SystemConfig, atlas: Atlas, n_feat: int,
                 imu_cap: int = 64, device="cuda", plain: bool = False,
                 sampler: Optional[Callable] = None):
        self.cfg = cfg
        self.atlas = atlas
        self.n_feat = n_feat
        self.imu_cap = imu_cap
        self.device = resolve_device(device)
        self.plain = plain
        cam = cfg.camera
        self.K = PinholeK(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        self._match = M.hamming_match_plain if plain else M.hamming_match
        self._hist = M.rotation_histogram_filter if plain else M.rot_hist
        self._preint = IMU.imu_preint_plain if plain else IMU.imu_preint

        self.use_lines = cfg.use_lines
        self.n_line_feat = 256
        if self.use_lines:
            self._init_line_pair = KN.make_line_pair_matcher(plain=plain)
            self._init_line_tri = KN.make_line_triangulator(self.K,
                                                            plain=plain)

        self.use_imu = cfg.sensor in (3, 4)
        self.calib = IMU.make_calib(cfg.imu)
        Tbc = cfg.imu.Tbc_matrix()
        self.Tbc = Tbc.astype(np.float32)
        R_bc, t_bc = Tbc[:3, :3], Tbc[:3, 3]
        self.R_cb = np.asarray(R_bc.T, np.float32)
        self.t_cb = np.asarray(-R_bc.T @ t_bc, np.float32)
        self.gravity_w = np.array([0, 0, -cfg.imu.gravity], np.float32)
        self.imu_since_kf: list = []
        self.last_frame_time: Optional[float] = None
        self.frame_vel = np.zeros(3, np.float32)
        self.frame_bg = np.zeros(3, np.float32)
        self.frame_ba = np.zeros(3, np.float32)

        self.state = TrackState.NO_IMAGES_YET
        self.last_feats = None
        self.last_pose_cw: Optional[np.ndarray] = None
        self.last_feat_pt: Optional[np.ndarray] = None
        self.velocity: Optional[np.ndarray] = None
        self.ref_kf: int = INVALID
        self.init_feats = None
        self.init_line_feats = None
        self.init_timestamp: float = 0.0
        self.last_kf_frame_idx = 0
        self.last_kf_time = -1e18
        self.last_created_kf: int = INVALID
        self.frame_idx = 0
        self.frames: List[FrameRecord] = []
        self.new_kf_queue: List[int] = []
        self.lost_count = 0
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.sampler = sampler
        # what the bootstrap did: two-view attempts, the last attempt's
        # matches, result and inputs, device-to-host reads (in all and per
        # attempt)
        self.attempts = 0
        self.init_matches = 0
        self.last_twoview: Optional[TV.TwoViewResult] = None
        self.last_twoview_inputs = None     # (uv0, uv1, valid, idx_h, idx_f)
        self.host_syncs = 0
        self.attempt_syncs: List[int] = []

    # ------------------------------------------------------------------
    @property
    def map(self) -> MapStore:
        return self.atlas.current

    def grab_imu(self, gyro: np.ndarray, acc: np.ndarray,
                 dts: np.ndarray) -> None:
        """Buffer the IMU samples that arrived before the next frame."""
        if len(gyro):
            self.imu_since_kf.append(
                (np.asarray(gyro, np.float32), np.asarray(acc, np.float32),
                 np.asarray(dts, np.float32)))

    def _preintegrate_batches(self, batches, bg, ba) -> IMU.Preintegrated:
        """Preintegrate a list of (gyro, acc, dt) batches, padded to a
        static capacity (doubled past `imu_cap` until the samples fit), on
        `imu_preint`; returns the Preintegrated as numpy arrays."""
        if batches:
            g = np.concatenate([b[0] for b in batches])
            a = np.concatenate([b[1] for b in batches])
            d = np.concatenate([b[2] for b in batches])
        else:
            g = np.zeros((0, 3), np.float32)
            a = np.zeros((0, 3), np.float32)
            d = np.zeros((0,), np.float32)
        cap = self.imu_cap
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
        out = self._preint(
            self._dev(gg), self._dev(aa), self._dev(dd), self._dev(mm),
            self.calib, self._dev(np.asarray(bg, np.float32)),
            self._dev(np.asarray(ba, np.float32)),
            self._dev(np.eye(3, 4, dtype=np.float32)),
            self._dev(np.zeros(3, np.float32)))
        return IMU.Preintegrated(*(self._host(v) for v in out.pre))

    def process_frame(self, feats, timestamp: float,
                      imu: Optional[tuple] = None, line_feats=None,
                      depth: Optional[np.ndarray] = None,
                      line_depth: Optional[tuple] = None
                      ) -> Optional[np.ndarray]:
        """Returns T_cw [3,4] or None while not tracking.  `feats` is the
        frame's `ops.frontend.Features` (uv_und undistorted), `imu` an
        optional (gyro [k,3], acc [k,3], dt [k]) batch since the last
        frame, `line_feats` its `ops.lines.LineFeatures` (endpoints
        undistorted)."""
        self.frame_idx += 1
        self._frame_imu = None
        self._pred_wb = None
        self._frame_lines = line_feats
        self._frame_depth = depth
        self._frame_line_depth = line_depth
        if self.last_frame_time is not None \
                and self.state in (TrackState.OK, TrackState.RECENTLY_LOST):
            dt_frame = timestamp - self.last_frame_time
            if dt_frame < 0:
                return None
            if dt_frame > 3.0:
                self.state = TrackState.LOST
                self._handle_lost()
                self.last_frame_time = timestamp
                return None
        self.last_frame_time = timestamp
        if self.use_imu and imu is not None:
            self.grab_imu(*imu)
            self._frame_imu = imu
        if self.state in (TrackState.NO_IMAGES_YET,
                          TrackState.NOT_INITIALIZED):
            if depth is not None:
                self._initialize_with_depth(feats, timestamp)
            else:
                self._initialize_mono(feats, timestamp)
            if self.state == TrackState.OK:
                return self.last_pose_cw
            return None
        raise NotImplementedError(f"tracking a frame {_NOT_PORTED}")

    def _handle_lost(self) -> None:
        raise NotImplementedError(f"the lost state {_NOT_PORTED}")

    def _initialize_with_depth(self, feats, timestamp: float) -> None:
        raise NotImplementedError("the stereo / RGB-D bootstrap is not "
                                  "ported yet: it comes with the other "
                                  "sensors")

    # ------------------------------------------------------------------
    def _make_record(self, timestamp: float) -> FrameRecord:
        m = self.map
        T_rw = m.kf_pose_cw[self.ref_kf]
        R_rw, t_rw = T_rw[:, :3], T_rw[:, 3]
        R_cw, t_cw = self.last_pose_cw[:, :3], self.last_pose_cw[:, 3]
        R_cr = R_cw @ R_rw.T
        t_cr = t_cw - R_cr @ t_rw
        return FrameRecord(timestamp, self.ref_kf,
                           np.concatenate([R_cr, t_cr[:, None]], 1),
                           map_id=self.atlas.active)

    # ------------------------------------------------------------------
    # Monocular initialization
    # ------------------------------------------------------------------
    def _initialize_mono(self, feats, timestamp: float) -> None:
        if self.init_feats is None or (timestamp - self.init_timestamp) > 1.0:
            n_valid = int(self._host(feats.valid).sum())
            if n_valid > 100:
                self.init_feats = feats
                self.init_line_feats = self._frame_lines
                self.init_timestamp = timestamp
                self.state = TrackState.NOT_INITIALIZED
                self.imu_since_kf = []
            return

        syncs0 = self.host_syncs
        f0, f1 = self.init_feats, feats
        idx, ok = self._match(f0.desc, f1.desc, f0.valid, f1.valid,
                              f0.uv_und.contiguous(), f1.uv_und.contiguous(),
                              radius=100.0, max_dist=60.0, ratio=0.9)
        # rotation consistency: the 3 dominant orientation-difference bins
        ok = self._hist(f0.angle.contiguous(), f1.angle.contiguous(), idx, ok)
        ok_np = self._host(ok)
        n_matches = int(ok_np.sum())
        self.init_matches = n_matches
        if n_matches < 80:
            self.init_feats = feats        # slide the window forward
            self.init_line_feats = self._frame_lines
            self.init_timestamp = timestamp
            self.imu_since_kf = []
            return

        uv0 = f0.uv_und
        uv1 = f1.uv_und[idx.long()]
        self.attempts += 1
        if self.sampler is not None:
            idx_h, idx_f = self.sampler(ok_np)
        else:
            valid = torch.from_numpy(ok_np)
            idx_h = TV.sample_indices(valid, 200, 4, self.generator)
            idx_f = TV.sample_indices(valid, 200, 8, self.generator)
        res = TV.reconstruct_two_views(self.K, uv0, uv1, ok, idx_h, idx_f,
                                       plain=self.plain)
        self.last_twoview = res
        self.last_twoview_inputs = (uv0, uv1, ok, idx_h, idx_f)
        success = bool(self._host(res.success))
        n_tri = int(self._host(res.is_triangulated).sum())
        if not success or n_tri < 60:
            self.attempt_syncs.append(self.host_syncs - syncs0)
            return
        self._create_initial_map(f0, f1, self._host(idx), res, timestamp)
        self.attempt_syncs.append(self.host_syncs - syncs0)

    def _create_initial_map(self, f0, f1, idx: np.ndarray,
                            res: TV.TwoViewResult, timestamp: float) -> None:
        """Two keyframes, the points scaled by their inverse median depth,
        the lines, the first preintegration; no init BA (the reference
        runs none)."""
        m = self.map
        tri = self._host(res.is_triangulated)
        X = self._host(res.points3d)[tri]          # camera-1 frame == world
        depth = X[:, 2]
        med = np.median(depth)
        X = X / med
        t10 = self._host(res.t) / med

        kf0 = m.alloc_kf()
        kf1 = m.alloc_kf()
        m.kf_timestamp[kf0] = self.init_timestamp
        m.kf_timestamp[kf1] = timestamp
        m.kf_pose_cw[kf0] = np.eye(3, 4, dtype=np.float32)
        m.kf_pose_cw[kf1] = np.concatenate(
            [self._host(res.R), t10[:, None]], 1).astype(np.float32)
        m.kf_prev[kf1] = kf0
        m.kf_next[kf0] = kf1
        self._store_kf_features(kf0, f0, self.init_line_feats)
        self._store_kf_features(kf1, f1, self._frame_lines)

        pts = m.alloc_points(tri.sum())
        m.pt_xyz[pts] = X.astype(np.float32)
        feat0_ids = np.nonzero(tri)[0]
        feat1_ids = idx[tri]
        packed0 = self._host(f0.desc).view(np.uint32)
        m.pt_desc[pts] = packed0[feat0_ids]
        m.pt_first_kf[pts] = kf0
        m.kf_match_pt[kf0, feat0_ids] = pts
        m.kf_match_pt[kf1, feat1_ids] = pts
        m.pt_n_obs[pts] = 2
        m.pt_found[pts] = 2
        m.pt_visible[pts] = 2
        m.update_covisibility(kf1)

        lf0, lf1 = self.init_line_feats, self._frame_lines
        if self.use_lines and lf0 is not None and lf1 is not None:
            self._triangulate_init_lines(kf0, kf1, lf0, lf1)

        if self.use_imu:
            self.frame_vel = np.zeros(3, np.float32)
            self.frame_bg = np.zeros(3, np.float32)
            self.frame_ba = np.zeros(3, np.float32)
            m.kf_pose_wb[kf0] = self._cw_to_wb(m.kf_pose_cw[kf0])
            self._store_kf_inertial(kf1)

        self.ref_kf = kf1
        self.last_created_kf = kf1
        self.last_feats = f1
        self.last_pose_cw = np.asarray(m.kf_pose_cw[kf1])
        feat_pt = np.full(self.n_feat, INVALID, np.int32)
        feat_pt[feat1_ids] = pts
        self.last_feat_pt = feat_pt
        self.velocity = None
        self.state = TrackState.OK
        self.last_kf_frame_idx = self.frame_idx
        self.last_kf_time = timestamp
        self.new_kf_queue += [kf0, kf1]
        self.frames.append(self._make_record(timestamp))

    def _triangulate_init_lines(self, kf0: int, kf1: int, lf0, lf1) -> None:
        """Match the two init frames' segments (the line pair matcher) and
        intersect their interpretation planes (`line_triangulate`)."""
        m = self.map
        ep0, ep1 = self._host(lf0.ep), self._host(lf1.ep)
        ang0 = np.arctan2(ep0[:, 3] - ep0[:, 1], ep0[:, 2] - ep0[:, 0]) % np.pi
        ang1 = np.arctan2(ep1[:, 3] - ep1[:, 1], ep1[:, 2] - ep1[:, 0]) % np.pi
        d0 = self._host(lf0.desc).view(np.uint32)
        idx1, ok = self._init_line_pair(
            lf0.ep, lf0.desc, self._dev(ang0.astype(np.float32)), lf0.valid,
            lf1.ep, lf1.desc, self._dev(ang1.astype(np.float32)), lf1.valid)
        if int(self._host(ok).sum()) == 0:
            return
        idx1 = self._host(idx1)
        Xs, Xe, good = self._init_line_tri(
            self._dev(m.kf_pose_cw[kf0]), self._dev(m.kf_pose_cw[kf1]),
            lf0.ep, self._dev(ep1[idx1]), ok)
        good_np = self._host(good)
        f0_ids = np.nonzero(good_np)[0]
        if len(f0_ids) == 0:
            return
        f1_ids = idx1[f0_ids]
        lns = m.alloc_lines(len(f0_ids))
        n = len(lns)
        f0_ids, f1_ids = f0_ids[:n], f1_ids[:n]
        m.ln_ep[lns] = np.concatenate(
            [self._host(Xs)[f0_ids], self._host(Xe)[f0_ids]], -1)
        m.ln_desc[lns] = d0[f0_ids]
        m.ln_first_kf[lns] = kf0
        m.ln_n_obs[lns] = 2
        m.ln_found[lns] = 2
        m.ln_visible[lns] = 2
        m.kf_match_ln[kf0, f0_ids] = lns
        m.kf_match_ln[kf1, f1_ids] = lns

    def _store_kf_features(self, kf: int, f, lf=None) -> None:
        m = self.map
        n = min(self.n_feat, f.uv.shape[0])
        m.kf_feat_uv[kf, :n] = self._host(f.uv_und)[:n]
        m.kf_feat_uv_raw[kf, :n] = self._host(f.uv)[:n]
        m.kf_feat_octave[kf, :n] = self._host(f.octave)[:n]
        m.kf_feat_angle[kf, :n] = self._host(f.angle)[:n]
        m.kf_feat_desc[kf, :n] = self._host(f.desc).view(np.uint32)[:n]
        m.kf_feat_valid[kf, :n] = self._host(f.valid)[:n]
        if lf is not None:
            nl = min(m.n_line_feat, lf.ep.shape[0])
            m.kf_line_ep[kf, :nl] = self._host(lf.ep)[:nl]
            m.kf_line_desc[kf, :nl] = self._host(lf.desc).view(np.uint32)[:nl]
            m.kf_line_valid[kf, :nl] = self._host(lf.valid)[:nl]

    # ------------------------------------------------------------------
    # Body <-> camera pose conversion (Tbc maps camera -> body)
    # ------------------------------------------------------------------
    def _cw_to_wb(self, pose_cw: np.ndarray) -> np.ndarray:
        """T_wb = T_wc o T_cb (T_cb = camera-from-body = Tbc^-1)."""
        R_cw, t_cw = pose_cw[:, :3], pose_cw[:, 3]
        R_wc = R_cw.T
        p_wc = -R_wc @ t_cw
        R_wb = R_wc @ self.R_cb
        p_wb = R_wc @ self.t_cb + p_wc
        return np.concatenate([R_wb, p_wb[:, None]], 1).astype(np.float32)

    def _wb_to_cw(self, pose_wb: np.ndarray) -> np.ndarray:
        R_wb, p_wb = pose_wb[:, :3], pose_wb[:, 3]
        R_bc = self.Tbc[:3, :3]
        t_bc = self.Tbc[:3, 3]
        R_wc = R_wb @ R_bc
        p_wc = R_wb @ t_bc + p_wb
        R_cw = R_wc.T
        t_cw = -R_cw @ p_wc
        return np.concatenate([R_cw, t_cw[:, None]], 1).astype(np.float32)

    def _store_kf_inertial(self, kf: int) -> None:
        """Preintegrate the IMU buffered since the previous keyframe and
        attach it and the raw samples to `kf`."""
        m = self.map
        if getattr(self, "_skip_next_kf_imu", False):
            self._skip_next_kf_imu = False
        else:
            m.kf_preint[kf] = self._preintegrate_batches(
                self.imu_since_kf, self.frame_bg, self.frame_ba)
            if self.imu_since_kf:
                m.kf_imu_raw[kf] = (
                    np.concatenate([b[0] for b in self.imu_since_kf]),
                    np.concatenate([b[1] for b in self.imu_since_kf]),
                    np.concatenate([b[2] for b in self.imu_since_kf]))
        self.imu_since_kf = []
        m.kf_pose_wb[kf] = self._cw_to_wb(m.kf_pose_cw[kf])
        m.kf_vel[kf] = self.frame_vel
        m.kf_bias_g[kf] = self.frame_bg
        m.kf_bias_a[kf] = self.frame_ba
