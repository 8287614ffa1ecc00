"""The tracker's host state machine (port of plvio_tpu/models/tracking.py
for the pinhole monocular and mono-inertial sensors, with or without
lines: `TrackState`, `FrameRecord`, `Tracker.__init__` :60-192,
`grab_imu` :199, `_preintegrate_batches` :208, `process_frame` :236-366,
`_make_record` :369, the monocular bootstrap `_initialize_mono` :384,
`_create_initial_map` :421, `_triangulate_init_lines` :491,
`_initialize_with_depth` :534, `_create_depth_points` :579,
`_create_depth_lines` :608,
`_store_kf_features` :646, `_cw_to_wb` :665, `_wb_to_cw` :674,
`invalidate_vi_prior` :684, `apply_map_transform` :693, `_predict_pose`
:773, `_track_reference_kf` :782, `_match_and_record_lines` :821,
`_gather_local_lines` :846, `_gather_local_points` :857, `_track_frame`
:872-1201, `_reselect_ref_kf` :1203, `_handle_lost` :1229, `_relocalize`
:1263-1326, `_need_keyframe` :1330, `_create_keyframe` :1390,
`_store_kf_inertial` :1424, `reanchor_records` :1450 and
`full_trajectory` :1478, and `on_map_merged` :722).

The host bookkeeping is the reference's, line for line, on the port's
numpy `MapStore`; the device calls are the port's kernels: the init
match (`hamming_match`'s window mode and `rot_hist`), the two-view
reconstruction (`twoview_hypotheses` and `twoview_recover`), the line
pair matcher and `line_triangulate`, the preintegration and the frame's
IMU prediction (`imu_preint`), the projection matcher in tracker mode
(`proj_match`), the line projection matcher (`hamming_match`'s line
mode), the reference-keyframe match (`hamming_match`'s window mode at an
infinite radius: no gate), the point+line pose IRLS (`pose_irls`), the
VI pose optimization (`vi_pose_lm`) and, in relocalization, the keyframe
database's query (`bow_transform`, `bow_score`), the ungated ratio match
against a candidate's bound features (`hamming_match`'s window mode at
an infinite radius), `pnp_ransac` and `mlpnp_refine`. A value the
reference keeps on the device between two device calls stays a tensor
here; kernel outputs come back to numpy where the reference calls
`np.asarray` or `int()`, and each such read is counted in `host_syncs`
(several values the reference reads at one point come back in one read).
`plain=True` runs the kernels' plain PyTorch versions on any device.

The RANSAC samples of each bootstrap attempt come from the tracker's
`torch.Generator` (seeded with `cfg.seed`, drawn once per attempt as the
reference splits its key per attempt), or from `sampler(valid)` ->
(idx_h, idx_f) where the caller gives one; those of each relocalization
PnP attempt from the same generator, or from `pnp_sampler(valid)` ->
[128, 6] indices.

`metrics` (a `utils.metrics.Metrics`; `System` hands the tracker its own)
times the reference's stages: "track/preintegrate", "track/kf_create",
and the value "track/inliers".

Stereo and RGB-D (`depth` / `line_depth` given to `process_frame`): the
one-keyframe bootstrap from depth, the depth-seeded points and lines of
each new keyframe, and the right-eye residual u_R = u - bf / z in the
point+line pose IRLS (`pose_irls` with its u_R column, sensors STEREO,
RGB-D and IMU_STEREO before IMU init) and in the VI pose optimization
(`vi_pose_lm`'s stereo term, IMU_STEREO), and without lines (STEREO or
RGB-D with bf > 0) in the point-only stereo LM (`pose_lm`'s stereo mode,
`make_pose_optimizer_stereo`).  The u_R column is computed on the device
from the frame's depths, in the reference's float32 operations (uv - bf /
max(z, 0.1) where z > 0.1, else -1).

The KB8 fisheye: the local-map matcher (`proj_match`'s KB8 mode) runs
against the frame's raw pixels (`uv`), the bootstrap and the keyframes'
undistorted coordinates stay as for the pinhole camera.  Without lines and
before the IMU initializes, the pose solve is `pose_lm`'s KB8 mode on the
raw pixels; with lines it is the pinhole point+line IRLS and, once the IMU
is initialized, the pinhole VI pose LM, on those raw pixels, as the
reference's tracker does (models/tracking.py:110-112, 145-149, 917-918: a
fault of the reference, ROADMAP Queue 3).

SLAM modes 1-3 (`cfg.slam_mode`): once 8 map lines match, the pose comes
from the lines alone (`make_pose_opt_line_only`, `pose_lm`'s line
families), the point inliers at it counted on the host.

The PLVIO_TRACE prints are left out.
"""
from __future__ import annotations

import dataclasses
import math
from enum import IntEnum
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..cuda import HostIO, resolve_device
from ..ops import imu as IMU
from ..ops import matching as M
from ..ops import pnp as PNP
from ..ops import twoview as TV
from ..solver.residuals import PinholeK, kb8_for
from ..utils import lie
from ..utils.metrics import Metrics
from . import kernels as KN
from .mapstore import INVALID, Atlas, MapStore

RELOC_ITERS = 128      # PnP RANSAC hypotheses a candidate (ops/pnp.py:49)
RELOC_CAP = 512        # matches handed to PnP a candidate
# 1 / 1.2^(2 octave) of octaves 0..7, as the reference computes it on the
# host in numpy float32 (models/tracking.py:953-954)
INV_SIGMA2 = (1.0 / (1.2 ** (2.0 * np.arange(8, dtype=np.float32)))).astype(
    np.float32)


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
                 local_pts_cap: int = 2048, imu_cap: int = 64,
                 device="cuda", plain: bool = False,
                 sampler: Optional[Callable] = None,
                 pnp_sampler: Optional[Callable] = None):
        self.cfg = cfg
        self.atlas = atlas
        self.n_feat = n_feat
        self.local_cap = local_pts_cap
        self.imu_cap = imu_cap
        self.device = resolve_device(device)
        self.plain = plain
        cam = cfg.camera
        self.K = PinholeK(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        self._match = M.hamming_match_plain if plain else M.hamming_match
        self._hist = M.rotation_histogram_filter if plain else M.rot_hist
        self._preint = IMU.imu_preint_plain if plain else IMU.imu_preint
        self.pose_opt = KN.make_pose_optimizer(self.K, plain=plain)
        self.proj_match = KN.make_projection_matcher(self.K, plain=plain)
        # the KB8 fisheye: the local-map matcher and the pose solve run
        # through the lens on raw pixels
        self.kb8 = kb8_for(cfg)
        if self.kb8 is not None:
            self.proj_match = KN.make_projection_matcher_kb8(self.kb8,
                                                             plain=plain)
            self.pose_opt = KN.make_pose_optimizer_kb8(self.kb8, plain=plain)

        self.use_lines = cfg.use_lines
        self.local_ln_cap = 256
        self.n_line_feat = 256
        # stereo / RGB-D: bf = baseline * fx; the right-eye residual joins
        # the point+line pose IRLS (sensors 1, 2, 4) and the VI pose
        # optimization (sensor 4); without lines, STEREO / RGB-D solve the
        # pose with the point-only stereo LM
        self.bf = cam.baseline * cam.fx
        self.pl_stereo = cfg.sensor in (1, 2, 4) and self.bf > 0 \
            and self.kb8 is None
        self.pose_opt_stereo = None
        if cfg.sensor in (1, 2) and self.bf > 0 and self.kb8 is None:
            self.pose_opt_stereo = KN.make_pose_optimizer_stereo(
                self.K, self.bf, plain=plain)
        if self.use_lines:
            self._init_line_pair = KN.make_line_pair_matcher(plain=plain)
            self._init_line_tri = KN.make_line_triangulator(self.K,
                                                            plain=plain)
            self.line_proj_match = KN.make_line_projection_matcher(
                self.K, plain=plain)
            self.pose_opt_pl = KN.make_fast_pose_optimizer_pl(
                self.K, plain=plain, bf=self.bf if self.pl_stereo else 0.0)
        # SLAM modes 1-3: the pose from lines alone once 8 map lines match
        self.pose_opt_line_only = None
        if self.use_lines and int(cfg.slam_mode) in (1, 2, 3):
            self.pose_opt_line_only = KN.make_pose_opt_line_only(
                self.K, int(cfg.slam_mode), plain=plain)
        self.last_line_feats = None
        self.last_feat_ln: Optional[np.ndarray] = None

        self.use_imu = cfg.sensor in (3, 4)
        self.calib = IMU.make_calib(cfg.imu)
        Tbc = cfg.imu.Tbc_matrix()
        self.Tbc = Tbc.astype(np.float32)
        R_bc, t_bc = Tbc[:3, :3], Tbc[:3, 3]
        self.R_cb = np.asarray(R_bc.T, np.float32)
        self.t_cb = np.asarray(-R_bc.T @ t_bc, np.float32)
        self.gravity_w = np.array([0, 0, -cfg.imu.gravity], np.float32)
        self.vi_pose_opt = KN.make_vi_pose_optimizer(
            self.K, local_pts_cap, self.R_cb, self.t_cb, cfg.imu.gravity,
            plain=plain,
            bf=self.bf if cfg.sensor == 4 and self.bf > 0
            and self.kb8 is None else 0.0)
        # the frame-to-frame marginalization prior carried between VI
        # solves; dropped whenever the frame state is rewritten
        self.prior_H15: Optional[np.ndarray] = None
        self._prior_frame_idx = -10
        self.imu_since_kf: list = []
        self.last_frame_time: Optional[float] = None
        self.frame_vel = np.zeros(3, np.float32)
        self.frame_bg = np.zeros(3, np.float32)
        self.frame_ba = np.zeros(3, np.float32)
        # localization-only mode: track against the frozen map
        self.only_tracking = False
        # the keyframe database (`System` hands over its own; without one,
        # relocalization fails, as the reference's) and the stage profiler
        self.kfdb = None
        self.metrics = Metrics()

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
        self.last_n_inliers = 0
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.sampler = sampler
        self.pnp_sampler = pnp_sampler
        # what relocalization did: attempts (and successes) of _relocalize,
        # the last attempt's candidates, the PnP attempts on them
        # (candidate, matches, RANSAC inliers, refined inliers, tracked)
        # and the candidate accepted (-1 when none)
        self.reloc_tries = 0
        self.reloc_ok = 0
        self.last_reloc = None
        # what the bootstrap did: two-view attempts, the last attempt's
        # matches, result and inputs, device-to-host reads (in all and per
        # attempt)
        self.attempts = 0
        self.init_matches = 0
        self.last_twoview: Optional[TV.TwoViewResult] = None
        self.last_twoview_inputs = None     # (uv0, uv1, valid, idx_h, idx_f)
        self.host_syncs = 0
        self.attempt_syncs: List[int] = []
        # what the last tracked frame did: projection matches, the branch
        # it took ("proj", "wide", "ref_kf"), whether the divergence guard
        # kept the prediction
        self.last_n_matched = 0
        self.last_match_path = ""
        self.last_guard = False

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
        static capacity (`_pad_batches`), on `imu_preint`; returns the
        Preintegrated as numpy arrays."""
        gg, aa, dd, mm = self._pad_batches(batches)
        out = self._preint(
            self._dev(gg), self._dev(aa), self._dev(dd), self._dev(mm),
            self.calib, self._dev(np.asarray(bg, np.float32)),
            self._dev(np.asarray(ba, np.float32)),
            self._dev(np.eye(3, 4, dtype=np.float32)),
            self._dev(np.zeros(3, np.float32)))
        return IMU.Preintegrated(*self._host_many(*out.pre))

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
        self._frame_depth_t = None
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
            with self.metrics.stage("track/preintegrate"):
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

        if self.state == TrackState.LOST and (self.only_tracking
                                              or self.last_pose_cw is None):
            ok = self._relocalize(feats)
        else:
            ok = self._track_frame(feats)
        vi_mode = self.use_imu and self.map.imu_initialized
        if not ok and self.state == TrackState.RECENTLY_LOST:
            if not vi_mode:
                ok = self._relocalize(feats)
            elif self.lost_count >= int(0.5 * self.cfg.camera.fps):
                # the VI bridge: an in-map relocalization from the
                # dead-reckoned state, which is kept when it fails
                snap = (None if self.last_pose_cw is None
                        else self.last_pose_cw.copy(),
                        self.ref_kf, self.velocity,
                        self.frame_vel.copy())
                imu_save = self._frame_imu
                self._frame_imu = None
                ok = self._relocalize(feats)
                self._frame_imu = imu_save
                if ok:
                    self.frame_vel = snap[3]
                    self.imu_since_kf = []
                    self._skip_next_kf_imu = True
                else:
                    (self.last_pose_cw, self.ref_kf,
                     self.velocity, self.frame_vel) = snap
        if ok:
            self.lost_count = 0
            self.state = TrackState.OK
            self.metrics.add("track/inliers", self.last_n_inliers)
            if self._need_keyframe():
                with self.metrics.stage("track/kf_create"):
                    self._create_keyframe(feats, timestamp)
            self.frames.append(self._make_record(timestamp))
            return self.last_pose_cw
        self.lost_count += 1
        if self.lost_count > int(self.cfg.tracking.recently_lost_s
                                 * self.cfg.camera.fps):
            self.state = TrackState.LOST
            self._handle_lost()
            return None
        self.state = TrackState.RECENTLY_LOST
        if vi_mode and self._pred_wb is not None:
            # hold the dead-reckoned state, so that the next frame's
            # projection search starts from a live prediction
            prev_pose = self.last_pose_cw
            self.last_pose_cw = self._wb_to_cw(self._pred_wb)
            self.frame_vel = self._pred_vel.astype(np.float32)
            R_c, t_c = self.last_pose_cw[:, :3], self.last_pose_cw[:, 3]
            R_l, t_l = prev_pose[:, :3], prev_pose[:, 3]
            R_cl = R_c @ R_l.T
            self.velocity = np.concatenate(
                [R_cl, (t_c - R_cl @ t_l)[:, None]], 1)
            self.frames.append(self._make_record(timestamp))
            return self.last_pose_cw
        return None

    def _handle_lost(self) -> None:
        """A mature map (> 10 keyframes) is kept and a fresh one started in
        the Atlas; a young one is reset in place."""
        self.invalidate_vi_prior()
        m = self.map
        if self.only_tracking:
            self.state = TrackState.LOST
            self.velocity = None
            self.lost_count = 0
            return
        if m.n_kf > 10:
            self.atlas.create_new_map(
                max_kf=m.max_kf, max_pts=m.max_pts, max_lines=m.max_lines,
                n_feat=self.n_feat)
        else:
            fresh = type(m)(max_kf=m.max_kf, max_pts=m.max_pts,
                            max_lines=m.max_lines, n_feat=self.n_feat,
                            map_id=m.map_id)
            self.atlas.maps[self.atlas.active] = fresh
        self.state = TrackState.NO_IMAGES_YET
        self.init_feats = None
        self.last_created_kf = INVALID
        self.last_feat_pt = None
        self.velocity = None
        self.lost_count = 0
        self.imu_since_kf = []

    def _relocalize(self, feats) -> bool:
        """Relocalization against the map: the keyframe database's best 3
        candidates for the frame's bag of words; for each, the ratio match
        (max 60, ratio 0.8) of the frame's features against the
        candidate's bound features, PnP RANSAC on up to 512 matches, the
        ML refinement on its inliers, then `_track_frame` against the
        candidate's local map.  Without a keyframe database it fails."""
        self.invalidate_vi_prior()
        if self.kfdb is None:
            return False
        self.reloc_tries += 1
        m = self.map
        cands, _ = self.kfdb.query(feats.desc, feats.valid, top_n=3)
        rec = dict(cands=[int(c) for c in cands], attempts=[], accepted=-1)
        self.last_reloc = rec
        uv_und = None
        for cand in cands:
            if not m.kf_valid[cand]:
                continue
            match = m.kf_match_pt[cand]
            cf = np.nonzero(match >= 0)[0]
            if len(cf) < 15:
                continue
            dev = self.device
            idx, ok = self._match(
                feats.desc, self._dev(m.kf_feat_desc[cand][cf]), feats.valid,
                torch.ones(len(cf), dtype=torch.bool, device=dev),
                torch.zeros(feats.desc.shape[0], 2, dtype=torch.float32,
                            device=dev),
                torch.zeros(len(cf), 2, dtype=torch.float32, device=dev),
                radius=math.inf, max_dist=60.0, ratio=0.8)
            ok_np, idx_np = self._host_many(ok, idx)
            if ok_np.sum() < 12:
                continue
            fsel = np.nonzero(ok_np)[0]
            pts = match[cf[idx_np[fsel]]]
            if uv_und is None:
                uv_und = self._host(feats.uv_und)
            uv_p = np.zeros((RELOC_CAP, 2), np.float32)
            X_p = np.zeros((RELOC_CAP, 3), np.float32)
            valid = np.zeros(RELOC_CAP, bool)
            nv = min(len(fsel), RELOC_CAP)
            uv_p[:nv] = uv_und[fsel[:nv]]
            X_p[:nv] = m.pt_xyz[pts[:nv]]
            valid[:nv] = True
            if self.pnp_sampler is not None:
                samples = self.pnp_sampler(valid)
            else:
                samples = TV.sample_indices(torch.from_numpy(valid),
                                            RELOC_ITERS, 6, self.generator)
            uv_t, X_t, valid_t = (self._dev(a) for a in (uv_p, X_p, valid))
            pnp = PNP.pnp_ransac_plain if self.plain else PNP.pnp_ransac
            ml = PNP.mlpnp_refine_plain if self.plain \
                else PNP.mlpnp_refine
            res = pnp(self.K, uv_t, X_t, valid_t,
                      torch.as_tensor(samples).to(dev))
            att = dict(cand=int(cand), matches=int(nv), n_ransac=0,
                       n_ml=0, tracked=False)
            rec["attempts"].append(att)
            att["n_ransac"] = int(self._host(res.n))
            if att["n_ransac"] < 10:
                continue
            R, t, inl, n = ml(self.K, uv_t, X_t, res.inliers, res.R, res.t)
            R, t, n = self._host_many(R, t, n)
            att["n_ml"] = int(n)
            if att["n_ml"] < 10:
                continue
            pose = np.concatenate([R, t[:, None]], 1).astype(np.float32)
            self.last_pose_cw = pose
            self.ref_kf = int(cand)
            self.velocity = None
            att["tracked"] = self._track_frame(feats)
            if att["tracked"]:
                rec["accepted"] = int(cand)
                self.reloc_ok += 1
                return True
        return False

    def _initialize_with_depth(self, feats, timestamp: float) -> None:
        """The stereo / RGB-D bootstrap: one keyframe at the identity, its
        map points straight from the features' depths (0.1 < z < 60), its
        map lines from the segments' endpoint depths."""
        depth = self._frame_depth
        valid, uv, desc = self._host_many(feats.valid, feats.uv_und,
                                          feats.desc)
        good = valid & (depth > 0.1) & (depth < 60.0)
        if good.sum() < 100:
            return
        m = self.map
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = timestamp
        m.kf_pose_cw[kf] = np.eye(3, 4, dtype=np.float32)
        self._store_kf_features(kf, feats, self._frame_lines)
        ids = np.nonzero(good)[0]
        pts = m.alloc_points(len(ids))
        ids = ids[:len(pts)]
        z = depth[ids]
        X = np.stack([(uv[ids, 0] - self.K.cx) / self.K.fx * z,
                      (uv[ids, 1] - self.K.cy) / self.K.fy * z, z], -1)
        m.pt_xyz[pts] = X.astype(np.float32)
        m.pt_desc[pts] = desc.view(np.uint32)[ids]
        m.pt_first_kf[pts] = kf
        m.kf_match_pt[kf, ids] = pts
        m.pt_n_obs[pts] = 1
        m.pt_found[pts] = 1
        m.pt_visible[pts] = 1
        if self._frame_line_depth is not None:
            self._create_depth_lines(kf)
        self.ref_kf = kf
        self.last_created_kf = kf
        self.last_feats = feats
        self.last_pose_cw = np.eye(3, 4, dtype=np.float32)
        feat_pt = np.full(self.n_feat, INVALID, np.int32)
        feat_pt[ids] = pts
        self.last_feat_pt = feat_pt
        self.velocity = None
        self.state = TrackState.OK
        self.last_kf_frame_idx = self.frame_idx
        self.last_kf_time = timestamp
        self.new_kf_queue.append(kf)
        if self.use_imu:
            m.kf_pose_wb[kf] = self._cw_to_wb(m.kf_pose_cw[kf])
            self.imu_since_kf = []
        self.frames.append(self._make_record(timestamp))

    def _create_depth_points(self, kf: int) -> None:
        """A new keyframe's close points from depth: up to 300 of its
        features not bound to a map point, with 0.1 < z < 40."""
        depth = self._frame_depth
        if depth is None:
            return
        m = self.map
        unbound = (m.kf_match_pt[kf] == INVALID) & m.kf_feat_valid[kf]
        good = unbound[:len(depth)] & (depth > 0.1) & (depth < 40.0)
        ids = np.nonzero(good)[0][:300]
        if len(ids) == 0:
            return
        pts = m.alloc_points(len(ids))
        ids = ids[:len(pts)]
        uv = m.kf_feat_uv[kf]
        z = depth[ids]
        Xc = np.stack([(uv[ids, 0] - self.K.cx) / self.K.fx * z,
                       (uv[ids, 1] - self.K.cy) / self.K.fy * z, z], -1)
        R_cw = m.kf_pose_cw[kf, :, :3]
        t_cw = m.kf_pose_cw[kf, :, 3]
        Xw = (Xc - t_cw) @ R_cw
        m.pt_xyz[pts] = Xw.astype(np.float32)
        m.pt_desc[pts] = m.kf_feat_desc[kf][ids]
        m.pt_first_kf[pts] = kf
        m.kf_match_pt[kf, ids] = pts
        m.pt_n_obs[pts] = 1
        m.pt_found[pts] = 1
        m.pt_visible[pts] = 1

    def _create_depth_lines(self, kf: int) -> None:
        """A keyframe's map lines from the rectified line match's endpoint
        depths: up to 128 of its segments not bound to a map line, both
        endpoints at 0.1 < z < 40, back-projected from the keyframe's
        (undistorted) endpoints."""
        lf = self._frame_lines
        if lf is None or self._frame_line_depth is None:
            return
        m = self.map
        ds, de, has = self._frame_line_depth
        nl = min(m.n_line_feat, lf.ep.shape[0])
        unbound = (m.kf_match_ln[kf, :nl] == INVALID) \
            & m.kf_line_valid[kf, :nl]

        def zok(z):
            return (z[:nl] > 0.1) & (z[:nl] < 40.0)
        good = unbound & has[:nl] & zok(ds) & zok(de)
        ids = np.nonzero(good)[0][:128]
        if len(ids) == 0:
            return
        lns = m.alloc_lines(len(ids))
        ids = ids[:len(lns)]
        ep = m.kf_line_ep[kf, :nl]      # the frame's undistorted segments

        def backproj(uv, z):
            return np.stack([(uv[:, 0] - self.K.cx) / self.K.fx * z,
                             (uv[:, 1] - self.K.cy) / self.K.fy * z, z], -1)
        Xs = backproj(ep[ids, :2], ds[ids])
        Xe = backproj(ep[ids, 2:], de[ids])
        R_cw = m.kf_pose_cw[kf, :, :3]
        t_cw = m.kf_pose_cw[kf, :, 3]
        m.ln_ep[lns] = np.concatenate(
            [(Xs - t_cw) @ R_cw, (Xe - t_cw) @ R_cw], -1).astype(np.float32)
        m.ln_desc[lns] = m.kf_line_desc[kf][ids]
        m.ln_first_kf[lns] = kf
        m.kf_match_ln[kf, ids] = lns
        m.ln_n_obs[lns] = 1
        m.ln_found[lns] = 1
        m.ln_visible[lns] = 1

    def _ur_column(self, uv_m: torch.Tensor, pt_feat: torch.Tensor
                   ) -> torch.Tensor:
        """The right-eye u_R of each local-map slot from its matched
        feature's depth: uv - bf / max(z, 0.1) where z > 0.1, else -1
        (float32, the reference's host operations on the device)."""
        depth = self._frame_depth
        n = len(depth)
        if self._frame_depth_t is None:
            self._frame_depth_t = self._dev(depth.astype(np.float32))
        pf = pt_feat.long()
        inb = (pf >= 0) & (pf < n)
        neg = torch.full_like(uv_m[:, 0], -1.0)
        z = torch.where(inb, self._frame_depth_t[pf.clamp(0, n - 1)], neg)
        bf = torch.tensor(self.bf, dtype=torch.float32, device=uv_m.device)
        return torch.where(z > 0.1, uv_m[:, 0] - bf / torch.clamp_min(z, 0.1),
                           neg).contiguous()

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
        """The frame's features (and segments) into keyframe kf's rows,
        read back in one device read."""
        m = self.map
        n = min(self.n_feat, f.uv.shape[0])
        lts = () if lf is None else (lf.ep, lf.desc, lf.valid)
        uv_und, uv, octv, ang, desc, valid, *lines = self._host_many(
            f.uv_und, f.uv, f.octave, f.angle, f.desc, f.valid, *lts)
        m.kf_feat_uv[kf, :n] = uv_und[:n]
        m.kf_feat_uv_raw[kf, :n] = uv[:n]
        m.kf_feat_octave[kf, :n] = octv[:n]
        m.kf_feat_angle[kf, :n] = ang[:n]
        m.kf_feat_desc[kf, :n] = desc.view(np.uint32)[:n]
        m.kf_feat_valid[kf, :n] = valid[:n]
        if lf is not None:
            ep, ldesc, lvalid = lines
            nl = min(m.n_line_feat, lf.ep.shape[0])
            m.kf_line_ep[kf, :nl] = ep[:nl]
            m.kf_line_desc[kf, :nl] = ldesc.view(np.uint32)[:nl]
            m.kf_line_valid[kf, :nl] = lvalid[:nl]

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

    def invalidate_vi_prior(self) -> None:
        """Drop the frame-to-frame marginalization prior: its
        linearization no longer matches the frame state (map transform, BA
        resync, relocalization, loss)."""
        self.prior_H15 = None
        self._prior_frame_idx = -10

    def apply_map_transform(self, R_gw: np.ndarray, scale: float) -> None:
        """Bring the frame state into the gravity-aligned metric frame that
        IMU init re-expressed the map in: X' = scale R_gw X."""
        self.invalidate_vi_prior()
        R_gw = np.asarray(R_gw, np.float32)
        R_cw, t_cw = self.last_pose_cw[:, :3], self.last_pose_cw[:, 3]
        self.last_pose_cw = np.concatenate(
            [R_cw @ R_gw.T, (scale * t_cw)[:, None]], 1).astype(np.float32)
        self.frame_vel = scale * (R_gw @ self.frame_vel)
        # records hold T_cr relative to their reference keyframe: under a
        # similarity the rotation stays and the translation scales (only
        # the records anchored in the active map)
        for rec in self.frames:
            if rec.map_id != self.atlas.active:
                continue
            rec.T_cr = rec.T_cr.copy()
            rec.T_cr[:, 3] *= scale
        m = self.map
        kfs = m.kf_chain()
        if len(kfs):
            newest = kfs[-1]
            self.frame_bg = m.kf_bias_g[newest].copy()
            self.frame_ba = m.kf_bias_a[newest].copy()
            self.frame_vel = m.kf_vel[newest].copy()
        self.velocity = None

    def on_map_merged(self, s: float, R: np.ndarray, t: np.ndarray,
                      kf_map: np.ndarray, pt_map: np.ndarray,
                      ln_map: np.ndarray, merged_atlas_index: int,
                      new_atlas_index: int) -> None:
        """Rebind the frame state after the loop closer merged the active
        map into an older one: the merged-in map was re-expressed as
        X' = s R X + t and its slots remapped by kf_map / pt_map /
        ln_map; the Atlas slot merged_atlas_index was removed."""
        self.invalidate_vi_prior()
        R = np.asarray(R, np.float32)
        t = np.asarray(t, np.float32)
        if self.last_pose_cw is not None:
            R_cw, t_cw = self.last_pose_cw[:, :3], self.last_pose_cw[:, 3]
            R_new = R_cw @ R.T
            self.last_pose_cw = np.concatenate(
                [R_new, (s * t_cw - R_new @ t)[:, None]], 1).astype(
                    np.float32)
        if self.velocity is not None:
            vel = self.velocity.copy()
            vel[:, 3] *= s
            self.velocity = vel
        self.frame_vel = s * (R @ self.frame_vel)
        if self.last_feat_pt is not None:
            fp = self.last_feat_pt
            self.last_feat_pt = np.where(
                fp >= 0, pt_map[np.maximum(fp, 0)], INVALID).astype(np.int32)
        if self.last_feat_ln is not None:
            fl = self.last_feat_ln
            self.last_feat_ln = np.where(
                fl >= 0, ln_map[np.maximum(fl, 0)], INVALID).astype(np.int32)
        if self.ref_kf != INVALID and kf_map[self.ref_kf] >= 0:
            self.ref_kf = int(kf_map[self.ref_kf])
        if self.last_created_kf != INVALID \
                and kf_map[self.last_created_kf] >= 0:
            self.last_created_kf = int(kf_map[self.last_created_kf])
        # the merged map's records follow their reference keyframes (the
        # relative translations scale by s); records of the maps behind
        # the removed Atlas slot shift down one index
        for rec in self.frames:
            if rec.map_id == merged_atlas_index:
                rec.map_id = new_atlas_index
                if kf_map[rec.ref_kf] >= 0:
                    rec.ref_kf = int(kf_map[rec.ref_kf])
                rec.T_cr = rec.T_cr.copy()
                rec.T_cr[:, 3] *= s
            elif rec.map_id > merged_atlas_index:
                rec.map_id -= 1

    # ------------------------------------------------------------------
    # Frame tracking
    # ------------------------------------------------------------------
    def _predict_pose(self) -> np.ndarray:
        if self.velocity is None:
            return self.last_pose_cw
        R_v, t_v = self.velocity[:, :3], self.velocity[:, 3]
        R_l, t_l = self.last_pose_cw[:, :3], self.last_pose_cw[:, 3]
        R = R_v @ R_l
        t = R_v @ t_l + t_v
        return np.concatenate([R, t[:, None]], 1)

    def _pad_batches(self, batches):
        """(gyro, acc, dt, mask) of a list of (gyro, acc, dt) batches,
        padded to `imu_cap` (doubled until the samples fit), float32."""
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
        return gg, aa, dd, mm

    def _predict_frame(self):
        """The frame's IMU batch preintegrated at the frame biases and the
        state predicted from the last frame's, in one `imu_preint` launch
        (models/tracking.py:885-896); the prediction and the covariance
        come back to the host as the reference reads them.  Returns
        (ImuFrame on the device, C [15,15], dT)."""
        gg, aa, dd, mm = self._pad_batches([self._frame_imu])
        last_wb = self._cw_to_wb(self.last_pose_cw)
        fr = self._preint(
            self._dev(gg), self._dev(aa), self._dev(dd), self._dev(mm),
            self.calib, self._dev(self.frame_bg), self._dev(self.frame_ba),
            self._dev(last_wb), self._dev(self.frame_vel))
        R2, v2, p2, C, dT = self._host_many(fr.R2, fr.v2, fr.p2, fr.pre.C,
                                            fr.pre.dT)
        self._pred_wb = np.concatenate([R2, p2[:, None]], 1).astype(
            np.float32)
        self._pred_vel = v2
        return fr, C, float(dT)

    def _track_reference_kf(self, feats, pose_pred):
        """Descriptor-only matching of the frame against the reference
        keyframe's bound map points: the ungated mutual NN-ratio match
        (ratio 0.75, max 60), `hamming_match`'s window mode at an infinite
        radius.  Returns proj_match's tuple and the gathered slots (ids,
        live, xyz on the host), or None."""
        m = self.map
        kf = self.ref_kf
        if kf < 0 or not m.kf_valid[kf]:
            return None
        bound = np.nonzero(m.kf_match_pt[kf] >= 0)[0]
        if len(bound) < 15:
            return None
        cap = self.local_cap
        n = min(len(bound), cap)
        bound = bound[:n]
        pts = m.kf_match_pt[kf, bound]
        ids = np.full(cap, -1, np.int64)
        ids[:n] = pts
        safe = np.clip(ids, 0, m.max_pts - 1)
        live = (ids >= 0) & m.pt_valid[safe]
        xyz = m.pt_xyz[safe]
        desc = np.zeros((cap, 8), np.uint32)
        desc[:n] = m.kf_feat_desc[kf, bound]
        idx, ok = self._match(
            self._dev(desc), feats.desc, self._dev(live), feats.valid,
            torch.zeros(cap, 2, dtype=torch.float32, device=self.device),
            feats.uv_und.contiguous(), radius=math.inf, max_dist=60.0,
            ratio=0.75)
        # the KB8 fisheye solves against raw pixels
        uv_m = (feats.uv if self.kb8 is not None else feats.uv_und)[
            idx.long()]
        ok_np, idx_np = self._host_many(ok, idx)
        feat_pt = np.full(self.n_feat, -1, np.int32)
        slots = np.nonzero(ok_np)[0]
        feat_pt[idx_np[slots]] = slots
        return (uv_m, idx, ok, self._dev(feat_pt), ids, live, xyz)

    def _match_and_record_lines(self, pose: np.ndarray) -> int:
        """The local map lines matched to the frame's segments at a given
        (optimized) pose, their bindings and found / visible statistics:
        the line bookkeeping of the VI branch."""
        m = self.map
        lf = self._frame_lines
        ln_ids, ln_live, (ln_ep6, ln_desc) = self._gather_local_lines()
        ln_feat_idx, ln_matched, _ = self.line_proj_match(
            self._dev(pose.astype(np.float32)), self._dev(ln_ep6),
            self._dev(ln_desc), self._dev(ln_live), lf.ep, lf.desc,
            lf.angle, lf.valid, lf.lineq)
        matched_np, ln_feat_np = self._host_many(ln_matched, ln_feat_idx)
        feat_ln = np.full(self.n_line_feat, INVALID, np.int32)
        good_l = np.nonzero(matched_np)[0]
        feat_ln[ln_feat_np[good_l]] = ln_ids[good_l]
        self.last_feat_ln = feat_ln
        self.last_line_feats = lf
        m.ln_visible[ln_ids[ln_live]] += 1
        m.ln_found[ln_ids[good_l]] += 1
        return len(good_l)

    def _gather_local_lines(self):
        """Local map lines of the reference keyframe's covisibility
        neighbourhood: (ids, live, (ln_ep [cap,6], ln_desc [cap,8]))."""
        m = self.map
        kfs = m.covisible_kfs(self.ref_kf, n=10, min_weight=5)
        kfs = np.concatenate([[self.ref_kf], kfs])
        ids = m.local_map_lines(kfs, self.local_ln_cap)
        live = ids >= 0
        safe = np.clip(ids, 0, m.max_lines - 1)
        return ids, live & m.ln_valid[safe], (m.ln_ep[safe], m.ln_desc[safe])

    def _gather_local_points(self):
        """Local map points of the reference keyframe's covisibility
        neighbourhood: (ids, live, (xyz, desc), (normal, min_dist,
        max_dist))."""
        m = self.map
        kfs = m.covisible_kfs(self.ref_kf, n=10, min_weight=5)
        kfs = np.concatenate([[self.ref_kf], kfs])
        ids = m.local_map_points(kfs, self.local_cap)
        live = ids >= 0
        safe = np.clip(ids, 0, m.max_pts - 1)
        xyz = m.pt_xyz[safe]
        desc = m.pt_desc[safe]
        stats = (m.pt_normal[safe], m.pt_min_dist[safe],
                 m.pt_max_dist[safe])
        return ids, live & m.pt_valid[safe], (xyz, desc), stats

    def _count(self, t: torch.Tensor) -> int:
        """int(t.sum()): a host read."""
        return int(self._host(t.sum()))

    def _track_frame(self, feats) -> bool:
        m = self.map
        vi_mode = self.use_imu and m.imu_initialized
        # the inertial frame state before the VI solve: a failed fit must
        # not poison the dead reckoning of RECENTLY_LOST
        bg_in, ba_in = self.frame_bg.copy(), self.frame_ba.copy()
        vel_in = self.frame_vel.copy()
        fr = None
        if vi_mode and self._frame_imu is not None:
            fr, C, dT_frame = self._predict_frame()
            pose_pred = self._wb_to_cw(self._pred_wb)
        else:
            pose_pred = self._predict_pose()
        ids, live, (xyz, desc), (nrm, dmin, dmax) = \
            self._gather_local_points()
        self.last_guard = False

        # the search window: 6 px around the IMU prediction, 15 px with a
        # motion model, 40 px without
        if vi_mode:
            radius = 6.0
        elif self.velocity is not None:
            radius = 15.0
        else:
            radius = 40.0
        pose_t = self._dev(np.asarray(pose_pred, np.float32))
        xyz_t, desc_t, live_t = (self._dev(a) for a in (xyz, desc, live))
        # the KB8 fisheye matches and solves against raw pixels
        obs = (feats.uv if self.kb8 is not None else feats.uv_und,
               feats.desc, feats.octave, feats.valid)
        uv_m, pt_feat, matched, _ = self.proj_match(
            pose_t, xyz_t, desc_t, live_t, *obs, radius,
            pt_normal=self._dev(nrm), pt_min_dist=self._dev(dmin),
            pt_max_dist=self._dev(dmax))
        n_matched = self._count(matched)
        self.last_match_path = "proj"
        if n_matched < self.cfg.tracking.min_matches_track:
            # widen the search once, without the scale and angle gates
            uv_m, pt_feat, matched, _ = self.proj_match(
                pose_t, xyz_t, desc_t, live_t, *obs, radius * 3)
            n_matched = self._count(matched)
            self.last_match_path = "wide"
            if n_matched < self.cfg.tracking.min_matches_track:
                # last resort: descriptors only, against the reference
                # keyframe's bound features
                ok_ref = self._track_reference_kf(feats, pose_pred)
                if not ok_ref:
                    self.last_n_matched = n_matched
                    return False
                uv_m, pt_feat, matched, _, ids, live, xyz = ok_ref
                xyz_t = self._dev(xyz)
                n_matched = self._count(matched)
                self.last_match_path = "ref_kf"
                if n_matched < self.cfg.tracking.min_matches_track:
                    self.last_n_matched = n_matched
                    return False
        self.last_n_matched = n_matched

        is2_table = self._dev(INV_SIGMA2)
        is2 = is2_table[feats.octave.long()][pt_feat.long()]
        if vi_mode and fr is not None:
            last_wb = self._cw_to_wb(self.last_pose_cw)
            pre = fr.pre
            pre_const = {
                "dT": pre.dT, "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
                "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
                "JPg": pre.JPg, "JPa": pre.JPa, "bg0": pre.bias_gyro,
                "ba0": pre.bias_acc}
            C9 = np.asarray(C)[:9, :9] + np.eye(9) * 1e-8
            imu_info = self._dev(np.linalg.inv(C9).astype(np.float32))
            # the bias random walks' information over this frame interval
            dT = max(dT_frame, 1e-3)
            n_samp = dT * self.cfg.imu.frequency
            rw_info = np.concatenate([
                np.full(3, 1.0 / (self.cfg.imu.gyro_walk ** 2 * n_samp)),
                np.full(3, 1.0 / (self.cfg.imu.acc_walk ** 2 * n_samp))])
            # stereo / RGB-D depth: u_R third column where available
            if self.bf > 0 and self._frame_depth is not None:
                ur = self._ur_column(uv_m, pt_feat)
            else:
                ur = torch.full_like(uv_m[:, 0], -1.0)
            uvr = torch.cat([uv_m, ur[:, None]], 1)
            # the LastFrame flavour with the previous frame's prior when it
            # is live, the LastKeyFrame one (previous state fixed) otherwise
            have_prior = (self.prior_H15 is not None
                          and self._prior_frame_idx == self.frame_idx - 1)
            self._last_have_prior = have_prior
            if have_prior:
                prior_info = self._dev(self.prior_H15.astype(np.float32))
            else:
                prior_info = torch.eye(15, dtype=torch.float32,
                                       device=self.device)
            prior_const = {
                "R0": self._dev(last_wb[:, :3]),
                "p0": self._dev(last_wb[:, 3]),
                "v0": self._dev(self.frame_vel),
                "bg0": self._dev(self.frame_bg),
                "ba0": self._dev(self.frame_ba)}
            pred_wb = torch.cat([fr.R2, fr.p2[:, None]], 1)
            pose_wb, vel, bg, ba, inlier, n_inl, H15 = self.vi_pose_opt(
                pred_wb, fr.v2, self._dev(self.frame_bg),
                self._dev(self.frame_ba), uvr, xyz_t, matched, is2,
                self._dev(last_wb), self._dev(self.frame_vel), pre_const,
                imu_info, self._dev(rw_info.astype(np.float32)),
                prior_const, prior_info, have_prior)
            pose_wb, vel, bg, ba, H15, n_inl = self._host_many(
                pose_wb, vel, bg, ba, H15, n_inl)
            pose = self._wb_to_cw(pose_wb)
            self.frame_vel, self.frame_bg, self.frame_ba = vel, bg, ba
            if np.isfinite(H15).all():
                # jitter keeps the whitening Cholesky of the carried
                # information positive definite
                self.prior_H15 = H15 + np.eye(15, dtype=np.float32) * 1e-4
                self._prior_frame_idx = self.frame_idx
            else:
                self.prior_H15 = None
            # the lines are matched all the same (their observations feed
            # the map's lines), at the inertial optimizer's pose
            if self.use_lines and self._frame_lines is not None:
                self._match_and_record_lines(pose)
        elif self.use_lines and self._frame_lines is not None:
            lf = self._frame_lines
            ln_ids, ln_live, (ln_ep6, ln_desc) = self._gather_local_lines()
            ln_ep6_t = self._dev(ln_ep6)
            ln_feat_idx, ln_matched, l_eq = self.line_proj_match(
                pose_t, ln_ep6_t, self._dev(ln_desc), self._dev(ln_live),
                lf.ep, lf.desc, lf.angle, lf.valid, lf.lineq)
            ones_l = torch.ones(self.local_ln_cap, dtype=torch.float32,
                                device=self.device)
            if self.pose_opt_line_only is not None \
                    and self._count(ln_matched) >= 8:
                pose, inlier, inl_l, n_inl = self._line_only_pose(
                    pose_t, lf, ln_feat_idx, ln_matched, l_eq, ln_ep6_t,
                    ones_l, xyz, uv_m, is2, matched)
            else:
                args = (pose_t, uv_m, xyz_t, matched, is2, l_eq,
                        ln_ep6_t[:, :3], ln_ep6_t[:, 3:], ln_matched, ones_l)
                if self.pl_stereo:
                    # the u_R residual for features with a depth
                    if self._frame_depth is not None:
                        ur = self._ur_column(uv_m, pt_feat)
                    else:
                        ur = torch.full_like(uv_m[:, 0], -1.0)
                    args = args + (ur,)
                pose, inlier, inl_l, n_inl = self.pose_opt_pl(*args)
            # line bookkeeping: observed segment -> map line
            inl_l_np, ln_feat_np = self._host_many(inl_l, ln_feat_idx)
            feat_ln = np.full(self.n_line_feat, INVALID, np.int32)
            good_l = np.nonzero(inl_l_np)[0]
            feat_ln[ln_feat_np[good_l]] = ln_ids[good_l]
            self.last_feat_ln = feat_ln
            self.last_line_feats = lf
            m.ln_visible[ln_ids[ln_live]] += 1
            m.ln_found[ln_ids[good_l]] += 1
        elif self.pose_opt_stereo is not None \
                and self._frame_depth is not None:
            # STEREO / RGB-D without lines: the u_R column where the
            # matched feature has a depth (u_R < 0 keeps the row mono)
            uvr = torch.cat([uv_m, self._ur_column(uv_m, pt_feat)[:, None]],
                            1)
            pose, inlier, n_inl = self.pose_opt_stereo(pose_t, uvr, xyz_t,
                                                       matched, is2)
        else:
            pose, inlier, n_inl = self.pose_opt(pose_t, uv_m, xyz_t, matched,
                                                is2)
        n_inliers = int(n_inl) if isinstance(n_inl, np.ndarray) \
            else int(self._host(n_inl))
        if vi_mode and n_inliers < self.cfg.tracking.min_inliers_track:
            # the VI divergence guard: when the optimizer rejected nearly
            # everything but the IMU prediction still explains the
            # matches, keep the predicted state for this frame
            pp = np.asarray(pose_pred)
            pc_ = np.asarray(xyz) @ pp[:, :3].T + pp[:, 3]
            zz = np.maximum(pc_[:, 2], 1e-4)
            prj = np.stack([self.K.fx * pc_[:, 0] / zz + self.K.cx,
                            self.K.fy * pc_[:, 1] / zz + self.K.cy], -1)
            uv_np, is2_np, matched_np = self._host_many(uv_m, is2, matched)
            c2p = np.sum((prj - uv_np) ** 2, -1) * is2_np
            inl_pred = matched_np & (c2p < 5.991) & (pc_[:, 2] > 0.05)
            nip = int(inl_pred.sum())
            if nip >= max(self.cfg.tracking.min_inliers_track, 15):
                print(f"[track] f={self.frame_idx}: pose opt diverged "
                      f"(ni={n_inliers}) but prediction holds "
                      f"(nip={nip}) — keeping predicted state",
                      flush=True)
                pose = pp
                inlier = inl_pred
                n_inliers = nip
                self.frame_vel = np.asarray(self._pred_vel)
                self.frame_bg, self.frame_ba = bg_in, ba_in
                self.invalidate_vi_prior()
                self.last_guard = True
        if n_inliers < self.cfg.tracking.min_inliers_track:
            self.frame_bg, self.frame_ba = bg_in, ba_in
            self.frame_vel = vel_in
            return False

        # bookkeeping
        dev = [x for x in (pose, inlier) if isinstance(x, torch.Tensor)]
        got = iter(self._host_many(*dev, pt_feat))
        pose = next(got) if isinstance(pose, torch.Tensor) else pose
        inlier_np = next(got) if isinstance(inlier, torch.Tensor) else inlier
        pt_feat_np = next(got)
        pose = np.asarray(pose)
        feat_pt_np = np.full(self.n_feat, INVALID, np.int32)
        good_slots = np.nonzero(inlier_np)[0]
        feat_pt_np[pt_feat_np[good_slots]] = ids[good_slots]
        # found / visible statistics for culling
        m.pt_visible[ids[live]] += 1
        m.pt_found[ids[good_slots]] += 1

        # velocity T_cl = T_cw T_lw^-1
        R_c, t_c = pose[:, :3], pose[:, 3]
        R_l, t_l = self.last_pose_cw[:, :3], self.last_pose_cw[:, 3]
        R_cl = R_c @ R_l.T
        t_cl = t_c - R_cl @ t_l
        self.velocity = np.concatenate([R_cl, t_cl[:, None]], 1)
        self.last_pose_cw = pose
        self.last_feats = feats
        self.last_feat_pt = feat_pt_np
        self.last_n_inliers = n_inliers
        self._reselect_ref_kf(ids[good_slots])
        return True

    def _line_only_pose(self, pose_t, lf, ln_feat_idx, ln_matched, l_eq,
                        ln_ep6_t, ones_l, xyz, uv_m, is2, matched):
        """SLAM modes 1-3: the pose from the matched lines alone (the
        reference's PoseOptimizationOnlyLine(+Angles)), each observed
        segment's unit direction computed on the host as the reference
        does, then the point inliers at that pose counted on the host
        (pinhole K, chi2 < 5.991, depth > 0.05; bookkeeping only).
        Returns (pose, inlier, inlier_l, n_inliers), pose and inlier in
        numpy."""
        ep, feat_idx = self._host_many(lf.ep, ln_feat_idx)
        ep_obs = ep[feat_idx]
        dirs = ep_obs[:, 2:] - ep_obs[:, :2]
        dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=-1,
                                                keepdims=True), 1e-6)
        pose, inl_l, n_inl_l = self.pose_opt_line_only(
            pose_t, l_eq, self._dev(dirs.astype(np.float32)),
            ln_ep6_t[:, :3], ln_ep6_t[:, 3:], ln_matched, ones_l)
        pose_np, n_l, uv_np, is2_np, matched_np = self._host_many(
            pose, n_inl_l, uv_m, is2, matched)
        pc = np.asarray(xyz) @ pose_np[:, :3].T + pose_np[:, 3]
        z_ = np.maximum(pc[:, 2], 1e-4)
        pred = np.stack([self.K.fx * pc[:, 0] / z_ + self.K.cx,
                         self.K.fy * pc[:, 1] / z_ + self.K.cy], -1)
        chi2 = np.sum((pred - uv_np) ** 2, -1) * is2_np
        inlier = matched_np & (chi2 < 5.991) & (pc[:, 2] > 0.05)
        return pose_np, inlier, inl_l, np.asarray(int(n_l)
                                                  + int(inlier.sum()))

    def _reselect_ref_kf(self, tracked_ids: np.ndarray) -> None:
        """The reference keyframe becomes the covisible keyframe (or one of
        the 4 newest of the chain) that shares the most tracked points;
        the first in ascending slot order on ties."""
        if len(tracked_ids) == 0:
            return
        m = self.map
        cands = m.covisible_kfs(self.ref_kf, n=10, min_weight=5)
        chain = m.kf_chain()
        recent = chain[-4:] if len(chain) else np.empty(0, np.int64)
        cands = np.unique(np.concatenate(
            [[self.ref_kf], cands, recent]).astype(np.int64))
        cands = cands[(cands >= 0)
                      & m.kf_valid[np.clip(cands, 0, m.max_kf - 1)]]
        tracked = np.unique(tracked_ids[tracked_ids >= 0])
        best_kf, best_n = self.ref_kf, -1
        for kf in cands:
            match = m.kf_match_pt[kf]
            n = int(np.isin(match[match >= 0], tracked).sum())
            if n > best_n:
                best_kf, best_n = int(kf), n
        self.ref_kf = best_kf

    # ------------------------------------------------------------------
    def _need_keyframe(self) -> bool:
        """NeedNewKeyFrame: the frame gap against the maximum interval; a
        keyframe at least every 0.5 s once the IMU is initialized; tracked
        inliers below a share of the reference keyframe's matches (0.65
        inertial, else 0.75, 0.6 with <= 2 keyframes), throttled to one
        in 3 frames while tracking is healthy."""
        if self.only_tracking:
            return False
        m = self.map
        # the reference keyframe's bound points with >= 3 observations
        # (VI mode: all of them)
        b = m.kf_match_pt[self.ref_kf]
        b = b[b >= 0]
        if m.n_kf > 2 and not (self.use_imu and m.imu_initialized):
            ref_matches = int((m.pt_n_obs[b] >= 3).sum())
        else:
            ref_matches = len(b)
        gap = self.frame_idx - self.last_kf_frame_idx
        if gap < max(self.cfg.tracking.kf_min_interval, 1):
            return False
        if gap >= self.cfg.tracking.kf_max_interval:
            return True
        if self.use_imu and m.imu_initialized \
                and self.last_frame_time is not None \
                and self.last_frame_time - self.last_kf_time >= 0.5:
            return True
        if self.use_imu and m.imu_initialized:
            ratio = 0.65
            # the inertial stress response: insert at once when the inlier
            # count itself is low
            if self.last_n_inliers < 75:
                return self.last_n_inliers > 12
        else:
            ratio = 0.75 if m.n_kf > 2 else 0.6
        weak = self.last_n_inliers < ratio * max(ref_matches, 1)
        healthy = self.last_n_inliers > 60
        if weak and healthy and gap < 3:
            return False
        return weak and self.last_n_inliers > 15

    def _create_keyframe(self, feats, timestamp: float) -> None:
        m = self.map
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = timestamp
        m.kf_pose_cw[kf] = self.last_pose_cw.astype(np.float32)
        self._store_kf_features(kf, feats, self._frame_lines)
        prev = self.last_created_kf
        if prev == INVALID or not m.kf_valid[prev]:
            prev = self.ref_kf
        m.kf_prev[kf] = prev
        m.kf_next[prev] = kf
        matched = self.last_feat_pt >= 0
        m.kf_match_pt[kf] = np.where(matched, self.last_feat_pt, INVALID)
        m.pt_n_obs[self.last_feat_pt[matched]] += 1
        if self.use_lines and self.last_feat_ln is not None \
                and self.last_line_feats is self._frame_lines:
            lm = self.last_feat_ln >= 0
            m.kf_match_ln[kf] = np.where(lm, self.last_feat_ln, INVALID)
            m.ln_n_obs[self.last_feat_ln[lm]] += 1
        m.update_covisibility(kf)
        if self.use_imu:
            self._store_kf_inertial(kf)
        if self._frame_depth is not None:
            self._create_depth_points(kf)
            m.update_covisibility(kf)
        if self._frame_line_depth is not None:
            self._create_depth_lines(kf)
        self.ref_kf = kf
        self.last_created_kf = kf
        self.last_kf_frame_idx = self.frame_idx
        self.last_kf_time = timestamp
        self.new_kf_queue.append(kf)
        m.change_index += 1

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

    # ------------------------------------------------------------------
    def reanchor_records(self, culled) -> None:
        """Re-express the frame records whose reference keyframe was culled
        relative to the surviving chain keyframe nearest in time, through
        the culled keyframe's last pose."""
        m = self.map
        chain = m.kf_chain()
        if len(chain) == 0:
            return
        for ckf, pose_cw, ts in culled:
            new_ref = int(chain[np.argmin(np.abs(m.kf_timestamp[chain]
                                                 - ts))])
            T_nw = m.kf_pose_cw[new_ref]
            # T_r_new = T_rw_old T_wn = pose_cw inv(T_nw)
            R_rn = pose_cw[:, :3] @ T_nw[:, :3].T
            t_rn = pose_cw[:, 3] - R_rn @ T_nw[:, 3]
            for rec in self.frames:
                if rec.ref_kf != ckf or rec.map_id != self.atlas.active:
                    continue
                R_cr, t_cr = rec.T_cr[:, :3], rec.T_cr[:, 3]
                R_cn = R_cr @ R_rn
                t_cn = R_cr @ t_rn + t_cr
                rec.T_cr = np.concatenate([R_cn, t_cn[:, None]], 1)
                rec.ref_kf = new_ref
            if self.ref_kf == ckf:
                self.ref_kf = new_ref

    def full_trajectory(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(timestamps, positions, quaternions x, y, z, w) of every tracked
        frame whose reference keyframe lives, through the current
        (optimized) keyframe poses."""
        ts, pos, rots = [], [], []
        for rec in self.frames:
            m = self.atlas.maps[rec.map_id]
            if not m.kf_valid[rec.ref_kf]:
                continue
            T_rw = m.kf_pose_cw[rec.ref_kf]
            R_cw = rec.T_cr[:, :3] @ T_rw[:, :3]
            t_cw = rec.T_cr[:, :3] @ T_rw[:, 3] + rec.T_cr[:, 3]
            R_wc = R_cw.T
            ts.append(rec.timestamp)
            pos.append(-R_wc @ t_cw)
            rots.append(np.asarray(R_wc, np.float32))
        quat = lie.rot_to_quat(torch.from_numpy(np.asarray(
            rots, np.float32).reshape(-1, 3, 3))).numpy()
        return np.asarray(ts), np.asarray(pos), quat
