"""The public SLAM system (port of plvio_tpu/models/system.py:34-569):
`System` builds the camera, the front ends, the Atlas, both vocabularies
and the keyframe database, the stage profiler, the tracker and the local
mapper, and runs them synchronously frame by frame (`track_monocular`,
and for a rectified pair `track_stereo`, for a depth camera
`track_rgbd`); it saves trajectories and refines the map
(`global_refine`).

Its glue is shared with the entry points: the per-frame prelude
(`frame_prelude`: ORB extraction, the keypoints' undistortion, line
extraction, the endpoints' undistortion and the segments' new line
equations, reference :160-169, :314-323) and the keyframe glue that
follows the tracker each frame (`apply_pending_transform` :325,
`drain_keyframes` :331, `process_kf` :339-388: every new keyframe into
the keyframe database and through `LocalMapper.process_keyframe`, the
frame records of culled keyframes re-anchored, the tracker's frame state
brought to the keyframe the window BA moved, then, with loop closing on
(`cfg.use_loop_closing`, the default), `LoopCloser.process_keyframe` and
a pending map merge handed to `Tracker.on_map_merged`, then, with
`cfg.reloc.enabled`, the prior-map relocalizer's
`PriorMapRelocalizer.process_keyframe`; and the IMU init's map transform
handed to the tracker).  The line front end takes `cfg.line.detector`:
0 the cell detector, 1 the ED detector.

Not ported, each raising NotImplementedError naming its ROADMAP item
where the reference would take it: the peripherals of item 9
(`async_mapping`, `change_dataset`, `save_atlas` / `load_atlas`, the live
viewer, the overlay and snapshot dumps, `export_map`).  The XLA cache
hygiene of the reference (`_host_hygiene`) has no counterpart.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SystemConfig
from ..cuda import resolve_device
from ..io import trajectory as TIO
from ..ops import cameras as CAM
from ..ops import stereo as ST
from ..utils import lie
from ..utils.metrics import Metrics

_ITEM9 = "is not ported yet (ROADMAP Queue 1 item 9)"


def frame_prelude(orb, lines, cam: CAM.Camera, img: torch.Tensor,
                  plain: bool = False, metrics: Optional[Metrics] = None):
    """One frame's features, as `System.track_monocular` hands them to the
    tracker: (Features with uv_und undistorted, LineFeatures with ep
    undistorted and lineq recomputed, or None when `lines` is None).

    `orb` / `lines` are the frame's extractors (`ops.frontend.OrbExtractor`,
    `ops.lines.LineExtractor`).  The keypoints and both endpoints of every
    segment are undistorted in one launch of the `undistort` kernel on a
    CUDA image (its plain version on the CPU or with `plain`).  A camera
    without distortion leaves the coordinates as they are (the
    reference's short-circuit), and then the segments keep the line
    equations their extractor computed from the same endpoints.

    With `metrics`, the ORB extraction is timed as the stage
    "extract_orb" and the line extraction with the one undistortion
    launch as "extract_lines" (the reference's stages)."""
    def stage(name):
        return metrics.stage(name) if metrics is not None \
            else contextlib.nullcontext()
    with stage("extract_orb"):
        feats, level1 = orb_and_line_level(orb, lines, img)
    with stage("extract_lines") if lines is not None \
            else contextlib.nullcontext():
        lf = lines(img, level1) if lines is not None else None
        return undistort_features(cam, feats, lf, plain)


def orb_and_line_level(orb, lines, img: torch.Tensor):
    """(ORB features of img, img's line level or None): where `lines` runs
    the 2-level line pyramid, the ORB pyramid's first launch also makes
    the line level, so the line extractor makes no call of its own for
    it (`lines(img, level1)`)."""
    if lines is None or getattr(lines, "levels", 1) < 2:
        return orb(img), None
    return orb.with_line_level(img)


def undistort_features(cam: CAM.Camera, feats, lf=None,
                       plain: bool = False):
    """The keypoints' undistortion (`uv_und`) and, with segments `lf`,
    their endpoints' with new line equations, in one `undistort` launch
    for CUDA features (the plain version on the CPU or with `plain`; a
    KB8 camera takes the kernel's KB8 mode); a pinhole
    camera without distortion leaves them as they are."""
    if cam.model != "kb8" and not any(cam.dist):
        return feats._replace(uv_und=feats.uv), lf
    ep = None if lf is None else lf.ep.contiguous()
    if plain or feats.uv.device.type == "cpu":
        und, ep_u, lineq = CAM.undistort_frame_plain(cam, feats.uv, ep)
    else:
        und, ep_u, lineq = CAM.undistort(cam, feats.uv.contiguous(), ep)
    feats = feats._replace(uv_und=und)
    if lf is not None:
        lf = lf._replace(ep=ep_u, lineq=lineq)
    return feats, lf


def apply_pending_transform(tracker, mapper) -> None:
    """IMU init re-expressed the map: bring the tracker's frame state into
    the new gravity-aligned metric frame."""
    if mapper.pending_transform is not None:
        R_gw, scale = mapper.pending_transform
        mapper.pending_transform = None
        tracker.apply_map_transform(R_gw, scale)


def drain_keyframes(tracker, mapper, kfdb=None, metrics=None,
                    loop_closer=None, relocalizer=None) -> list:
    """Every keyframe the tracker queued, oldest first, through
    `process_kf`.  Returns [(kf, culled), ...]."""
    done = []
    while tracker.new_kf_queue:
        kf = tracker.new_kf_queue.pop(0)
        done.append((kf, process_kf(tracker, mapper, kf, kfdb, metrics,
                                    loop_closer, relocalizer)))
    return done


def process_kf(tracker, mapper, kf: int, kfdb=None, metrics=None,
               loop_closer=None, relocalizer=None) -> list:
    """Keyframe kf into the keyframe database (where one is given), its
    mapping step (the tracker's reference keyframe protected from
    culling), the frame records of culled keyframes re-anchored, and,
    when kf is the frame just tracked, the tracker's pose (and after IMU
    init its velocity and biases) taken from the keyframe the window BA
    moved; the carried VI prior is dropped then.  Skipped while an
    IMU-init transform is pending: applying it resyncs the same state in
    the new frame.  Then, with a `loop_closer`, its
    `process_keyframe` (the stage "loop_closing" inside "mapping") and a
    merge it performed handed to the tracker; then, with a `relocalizer`
    (`models/relocalization.PriorMapRelocalizer`), its `process_keyframe`
    with the keyframe's timestamp (the stage "prior_reloc").  With
    `metrics`, all of it is the stage "mapping".  Returns the culled
    keyframes."""
    def stage(name):
        return metrics.stage(name) if metrics is not None \
            else contextlib.nullcontext()
    with stage("mapping"):
        t_kf = tracker.map.kf_timestamp[kf]
        culled = _process_kf(tracker, mapper, kf, kfdb)
        if loop_closer is not None:
            with stage("loop_closing"):
                loop_closer.process_keyframe(kf)
            merge = loop_closer.pending_merge
            if merge is not None:
                loop_closer.pending_merge = None
                tracker.on_map_merged(**merge)
        if relocalizer is not None:
            with stage("prior_reloc"):
                relocalizer.process_keyframe(kf, t_kf)
        return culled


def _process_kf(tracker, mapper, kf: int, kfdb) -> list:
    m = tracker.map
    if kfdb is not None:
        kfdb.add_keyframe(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf],
                          line_desc=m.kf_line_desc[kf],
                          line_valid=m.kf_line_valid[kf])
    culled = mapper.process_keyframe(kf, protect=(tracker.ref_kf,))
    if culled:
        tracker.reanchor_records(culled)
    t = tracker
    if kf == t.last_created_kf and m.kf_valid[kf] \
            and t.last_kf_frame_idx == t.frame_idx \
            and mapper.pending_transform is None \
            and np.isfinite(m.kf_pose_cw[kf]).all():
        t.last_pose_cw = m.kf_pose_cw[kf].copy()
        t.invalidate_vi_prior()
        if t.use_imu and m.imu_initialized \
                and np.isfinite(m.kf_vel[kf]).all():
            t.frame_vel = m.kf_vel[kf].copy()
            t.frame_bg = m.kf_bias_g[kf].copy()
            t.frame_ba = m.kf_bias_a[kf].copy()
    return culled


class System:
    """The SLAM system on the port's kernels: monocular, mono-inertial,
    rectified stereo and stereo-inertial with lines, and RGB-D.

        slam = System(cfg)                       # on the card
        for img, t, imu in frames:
            pose = slam.track_monocular(img, t, imu)
        slam.save_trajectory("CameraTrajectory.txt")

    Built as the reference builds it (`cfg.orb`, `cfg.line`, `cfg.map`,
    both vocabularies, the keyframe database on the tracker and the
    mapper, one `Metrics`), on `device` (the card unless the caller asks
    for the CPU, which runs the kernels' plain versions).  Keyword
    arguments the reference does not have: `plain` runs the plain
    versions on any device; `caps` / `viba_caps` are the LocalMapper's
    window caps (production's by default) and `local_pts_cap` the
    tracker's; `sampler` / `pnp_sampler` give the bootstrap's and
    relocalization's RANSAC samples (models/tracking.py), `sim3_sampler`
    the loop closer's (models/loop_closing.py).  `dist_mesh` is
    plumbing, not a feature: a `parallel/mesh.Mesh` handed to the mapper,
    whose inertial window solves then run on the landmark-sharded back end
    (the reference picks that back end from the devices it sees; the port
    follows the same rule, `parallel/mesh.default_mesh`, when no mesh is
    given).  `metrics_summary()` counts the sharded window solves
    ("mapping/dist_solves") and the observations their sharding dropped
    ("mapping/dist_dropped_obs")."""

    def __init__(self, cfg: SystemConfig, async_mapping: bool = False,
                 device="cuda", plain: bool = False, caps=None,
                 viba_caps=None, local_pts_cap: int = 2048, sampler=None,
                 pnp_sampler=None, sim3_sampler=None, dist_mesh=None):
        from ..ops.frontend import OrbExtractor, make_level_specs
        from ..ops.lines import LineExtractor
        from .kfdb import AtlasKeyFrameDatabase
        from .local_mapping import LocalMapper
        from .mapstore import Atlas, MapStore
        from .tracking import Tracker
        from . import vocabulary as V
        if async_mapping:
            raise NotImplementedError(f"async_mapping {_ITEM9}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plain = plain
        cam = cfg.camera
        self.camera = CAM.make_camera(cam)
        self.level_specs = make_level_specs(
            cam.height, cam.width, cfg.orb.n_features, cfg.orb.n_levels,
            cfg.orb.scale_factor)
        self.extract = OrbExtractor(self.level_specs, cfg.orb.ini_th_fast,
                                    cfg.orb.min_th_fast, plain=plain).to(
                                        self.device)
        self.n_feat = sum(s.n_keep for s in self.level_specs)
        self.atlas = Atlas([MapStore(
            max_kf=cfg.map.max_keyframes, max_pts=cfg.map.max_points,
            max_lines=cfg.map.max_lines, n_feat=self.n_feat)])
        self.extract_lines = None
        if cfg.use_lines:
            self.extract_lines = LineExtractor(
                256, levels=cfg.line.levels, plain=plain,
                detector=cfg.line.detector).to(self.device)
        self.vocabulary = V.default_vocabulary("orb", seed=cfg.seed)
        self.line_vocabulary = \
            V.default_vocabulary("lbd", seed=cfg.seed + 1) \
            if cfg.use_lines else None
        self.kfdb = AtlasKeyFrameDatabase(
            self.vocabulary, cfg.map.max_keyframes, self.n_feat, self.atlas,
            line_voc=self.line_vocabulary,
            n_line_feat=self.atlas.current.n_line_feat, device=self.device,
            plain=plain)
        self.metrics = Metrics()
        self.tracker = Tracker(cfg, self.atlas, self.n_feat, local_pts_cap,
                               device=self.device, plain=plain,
                               sampler=sampler, pnp_sampler=pnp_sampler)
        self.tracker.kfdb = self.kfdb
        self.tracker.metrics = self.metrics
        self.mapper = LocalMapper(cfg, self.atlas, self.n_feat,
                                  device=self.device, plain=plain,
                                  dist_mesh=dist_mesh, **(caps or {}))
        for k, v in (viba_caps or {}).items():
            setattr(self.mapper, k, v)
        self.mapper.kfdb = self.kfdb
        self.mapper.metrics = self.metrics
        self.loop_closer = None
        if cfg.use_loop_closing:
            from .loop_closing import LoopCloser
            self.loop_closer = LoopCloser(
                cfg, self.atlas, self.kfdb, self.n_feat, device=self.device,
                plain=plain, sim3_sampler=sim3_sampler)
            self.loop_closer.mapper = self.mapper
            self.loop_closer.metrics = self.metrics
        # the prior-map relocalizer (the reference spawns its thread when
        # bRelocalization == 1)
        self.relocalizer = None
        if cfg.reloc.enabled:
            from .relocalization import PriorMapRelocalizer
            self.relocalizer = PriorMapRelocalizer(
                cfg, self.atlas, self.vocabulary, self.n_feat,
                device=self.device, plain=plain)
            if cfg.reloc.prior_data_dir:
                self.relocalizer.load_prior_dir(cfg.reloc.prior_data_dir)
        self.async_mapping = False
        if os.environ.get("PLVIO_VIEWER_PORT"):
            raise NotImplementedError(f"the live viewer {_ITEM9}")

    # ------------------------------------------------------------------
    @property
    def host_syncs(self) -> int:
        """Device-to-host reads of the tracker, mapper and database."""
        return self.tracker.host_syncs + self.mapper.host_syncs \
            + self.kfdb.host_syncs + sum(
                x.host_syncs for x in (self.loop_closer, self.relocalizer)
                if x is not None)

    def track_monocular(self, img, timestamp: float,
                        imu: Optional[Sequence] = None
                        ) -> Optional[np.ndarray]:
        """One frame: img [H,W] grayscale (numpy or tensor), imu an
        optional (gyro [k,3], acc [k,3], dt [k]) batch of the samples since
        the previous frame.  Returns T_cw [3,4] or None while not
        tracking."""
        img_dev = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        feats, lf = frame_prelude(self.extract, self.extract_lines,
                                  self.camera, img_dev, self.plain,
                                  self.metrics)
        return self.track_features(feats, lf, timestamp, imu, img)

    def track_features(self, feats, line_feats, timestamp: float,
                       imu: Optional[Sequence] = None, img=None,
                       depth: Optional[np.ndarray] = None,
                       line_depth: Optional[tuple] = None
                       ) -> Optional[np.ndarray]:
        """`track_monocular` (and `track_stereo` / `track_rgbd`, with the
        per-feature `depth` and the segments' `line_depth`) past its front
        end, on a frame's features."""
        with self.metrics.stage("track"):
            pose = self.tracker.process_frame(feats, timestamp, imu=imu,
                                              line_feats=line_feats,
                                              depth=depth,
                                              line_depth=line_depth)
        drain_keyframes(self.tracker, self.mapper, self.kfdb, self.metrics,
                        self.loop_closer, self.relocalizer)
        self._maybe_snapshot()
        apply_pending_transform(self.tracker, self.mapper)
        self._maybe_dump_overlay(img)
        return pose

    def track_stereo(self, img_left, img_right, timestamp: float,
                     imu: Optional[Sequence] = None
                     ) -> Optional[np.ndarray]:
        """One rectified pair (the reference's System::TrackStereo): both
        views' ORB features and segments (`stereo_features`), then
        `track_stereo_features`.  Returns T_cw [3,4] or None while not
        tracking."""
        return self.track_stereo_features(
            *self.stereo_features(img_left, img_right), timestamp, imu,
            img_left)

    def stereo_features(self, img_left, img_right):
        """Both views' raw features: (left Features, right Features, left
        LineFeatures, right LineFeatures), the segments None without
        lines.  The ORB extraction of both is the stage "extract_orb"."""
        dev = self.device
        img_l = torch.as_tensor(img_left, dtype=torch.float32).to(dev)
        img_r = torch.as_tensor(img_right, dtype=torch.float32).to(dev)
        lines = self.extract_lines
        with self.metrics.stage("extract_orb"):
            f_l, l1_l = orb_and_line_level(self.extract, lines, img_l)
            f_r, l1_r = orb_and_line_level(self.extract, lines, img_r)
        if lines is None:
            return f_l, f_r, None, None
        return f_l, f_r, lines(img_l, l1_l), lines(img_r, l1_r)

    def track_stereo_features(self, f_l, f_r, lf_l, lf_r, timestamp: float,
                              imu: Optional[Sequence] = None, img=None
                              ) -> Optional[np.ndarray]:
        """`track_stereo` past its front end: the stereo match of the RAW
        left keypoints against the right ones (`ops.stereo.match_stereo`,
        a depth per left feature; the stage "stereo_match") and of the raw
        segments (`match_stereo_lines`, both endpoint depths), each read
        back once, the left view's undistortion, then the tracker with
        the depths."""
        tr = self.tracker
        bf = self.cfg.camera.baseline * self.cfg.camera.fx
        with self.metrics.stage("stereo_match"):
            _, depth, has = ST.match_stereo(
                f_l.uv.contiguous(), f_l.desc, f_l.octave, f_l.valid,
                f_r.uv.contiguous(), f_r.desc, f_r.octave, f_r.valid, bf)
            depth, has = tr._host_many(depth, has)
            depth = np.where(has, depth, -1.0).astype(np.float32)
        line_depth = None
        if lf_l is not None:
            ds, de, lhas = ST.match_stereo_lines(
                lf_l.ep.contiguous(), lf_l.desc, lf_l.angle.contiguous(),
                lf_l.valid, lf_r.ep.contiguous(), lf_r.desc,
                lf_r.angle.contiguous(), lf_r.valid, bf)
            line_depth = tuple(tr._host_many(ds, de, lhas))
        feats, lf_l = undistort_features(self.camera, f_l, lf_l, self.plain)
        return self.track_features(feats, lf_l, timestamp, imu, img,
                                   depth=depth, line_depth=line_depth)

    def track_rgbd(self, img, depth_img, timestamp: float,
                   imu: Optional[Sequence] = None) -> Optional[np.ndarray]:
        """One colour (grayscale) image and its registered depth image (the
        reference's System::TrackRGBD): the frame's features, each
        keypoint's depth (`depth_at_features`), then the tracker with the
        depths."""
        img_dev = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        feats, lf = frame_prelude(self.extract, self.extract_lines,
                                  self.camera, img_dev, self.plain,
                                  self.metrics)
        return self.track_features(feats, lf, timestamp, imu, img,
                                   depth=self.depth_at_features(feats,
                                                                depth_img))

    def depth_at_features(self, feats, depth_img) -> np.ndarray:
        """Each keypoint's depth read from the depth image at its RAW pixel
        (truncated to int, clipped to the image): [n_feat] float32."""
        depth_img = np.asarray(depth_img)
        uv = self.tracker._host(feats.uv)
        ui = np.clip(uv[:, 0].astype(int), 0, depth_img.shape[1] - 1)
        vi = np.clip(uv[:, 1].astype(int), 0, depth_img.shape[0] - 1)
        return depth_img[vi, ui].astype(np.float32)

    def _maybe_dump_overlay(self, img) -> None:
        if os.environ.get("PLVIO_OVERLAY_DIR"):
            raise NotImplementedError(f"the tracking overlay {_ITEM9}")

    def _maybe_snapshot(self) -> None:
        if os.environ.get("PLVIO_SNAPSHOT_DIR"):
            raise NotImplementedError(f"the map snapshots {_ITEM9}")

    # ------------------------------------------------------------------
    def activate_localization_mode(self) -> None:
        """Freeze the map and run tracking only."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.only_tracking = False

    def reset_active_map(self) -> None:
        """Restart the active map in place (the tracker's loss path)."""
        was = self.tracker.only_tracking
        self.tracker.only_tracking = False
        try:
            self.tracker._handle_lost()
        finally:
            self.tracker.only_tracking = was

    def change_dataset(self) -> None:
        raise NotImplementedError(f"change_dataset {_ITEM9}")

    def save_atlas(self, directory: str) -> None:
        raise NotImplementedError(f"save_atlas {_ITEM9}")

    def load_atlas(self, directory: str) -> None:
        raise NotImplementedError(f"load_atlas {_ITEM9}")

    def export_map(self, path_prefix: str, fmt: str = "all") -> None:
        raise NotImplementedError(f"export_map (the viewer) {_ITEM9}")

    def save_relocalized_trajectory(self, path: str) -> None:
        """The keyframe trajectory in the prior map's world, TUM format (the
        reference's SaveKeyFrameTrajectoryByRelocalization)."""
        if self.relocalizer is None:
            raise RuntimeError("the prior-map relocalizer is off "
                               "(cfg.reloc.enabled, bRelocalization)")
        self.relocalizer.save_trajectory(path)

    def global_refine(self) -> None:
        """One full-map refinement pass: the full inertial BA of an
        initialized VI map, else the loop closer's global BA (the oldest
        keyframe fixed)."""
        m = self.atlas.current
        if self.cfg.sensor in (3, 4) and m.imu_initialized:
            self.mapper.full_inertial_ba()
        elif self.loop_closer is not None and m.n_kf >= 3:
            chain = m.kf_chain()
            self.loop_closer.run_global_ba(fixed_kf=int(chain[0]))

    def metrics_summary(self) -> dict:
        """Per-stage wall time and counters (`Metrics.summary`), with the
        sharded back end's window solves and dropped observations."""
        out = self.metrics.summary()
        runner = self.mapper._dist_runner
        if runner is not None:
            out["mapping/dist_solves"] = {"calls": runner.n_solves}
            out["mapping/dist_dropped_obs"] = {"calls": runner.n_dropped}
        return out

    def shutdown(self) -> None:
        """PLVIO_METRICS=<path>: the stage summary written on shutdown."""
        path = os.environ.get("PLVIO_METRICS")
        if path:
            self.metrics.dump(path)

    @property
    def state(self):
        return self.tracker.state

    def trajectory(self) -> TIO.Trajectory:
        ts, pos, quat = self.tracker.full_trajectory()
        return TIO.Trajectory(ts, pos, np.asarray(quat))

    def save_trajectory(self, path: str) -> None:
        """Every frame's pose, TUM format."""
        TIO.write_tum(path, self.trajectory())

    def save_keyframe_trajectory(self, path: str) -> None:
        """The live keyframes' poses in time order, TUM format."""
        m = self.atlas.current
        kfs = m.valid_kf_indices()
        kfs = kfs[np.argsort(m.kf_timestamp[kfs])]
        R_cw = m.kf_pose_cw[kfs, :, :3]
        t_cw = m.kf_pose_cw[kfs, :, 3]
        R_wc = R_cw.transpose(0, 2, 1)
        p = -np.einsum("kij,kj->ki", R_wc, t_cw)
        q = lie.rot_to_quat(torch.from_numpy(
            np.ascontiguousarray(R_wc, np.float32))).numpy()
        TIO.write_tum(path, TIO.Trajectory(m.kf_timestamp[kfs], p, q))
