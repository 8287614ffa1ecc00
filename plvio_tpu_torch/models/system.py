"""The per-frame prelude of `System.track_monocular` (port of
plvio_tpu/models/system.py:160-169 and `_extract_frame_lines` :314-323):
ORB extraction, the keypoints' undistortion, line extraction, the
endpoints' undistortion and the segments' new line equations; and the
keyframe glue that follows the tracker each frame (`_apply_pending_transform`
:325, `_drain_keyframes` :331, `_process_kf` :339-388, synchronous
mapping): every new keyframe through `LocalMapper.process_keyframe`, the
frame records of culled keyframes re-anchored, the tracker's frame state
brought to the keyframe the window BA moved, and the IMU init's map
transform handed to the tracker.  The rest of `System` (the vocabulary
and keyframe database, loop closing, the prior-map relocalizer, the
threads, viewers and metrics) comes with the end-to-end slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import cameras as CAM


def frame_prelude(orb, lines, cam: CAM.Camera, img: torch.Tensor,
                  plain: bool = False):
    """One frame's features, as `System.track_monocular` hands them to the
    tracker: (Features with uv_und undistorted, LineFeatures with ep
    undistorted and lineq recomputed, or None when `lines` is None).

    `orb` / `lines` are the frame's extractors (`ops.frontend.OrbExtractor`,
    `ops.lines.LineExtractor`).  The keypoints and both endpoints of every
    segment are undistorted in one launch of the `undistort` kernel on a
    CUDA image (its plain version on the CPU or with `plain`).  A camera
    without distortion leaves the coordinates as they are (the
    reference's short-circuit), and then the segments keep the line
    equations their extractor computed from the same endpoints."""
    feats = orb(img)
    lf = lines(img) if lines is not None else None
    if not any(cam.dist):
        return feats._replace(uv_und=feats.uv), lf
    ep = None if lf is None else lf.ep.contiguous()
    if plain or img.device.type == "cpu":
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


def drain_keyframes(tracker, mapper) -> list:
    """Every keyframe the tracker queued, oldest first, through
    `process_kf`.  Returns [(kf, culled), ...]."""
    done = []
    while tracker.new_kf_queue:
        kf = tracker.new_kf_queue.pop(0)
        done.append((kf, process_kf(tracker, mapper, kf)))
    return done


def process_kf(tracker, mapper, kf: int) -> list:
    """The mapping step of keyframe kf (the tracker's reference keyframe
    protected from culling), the frame records of culled keyframes
    re-anchored, and, when kf is the frame just tracked, the tracker's
    pose (and after IMU init its velocity and biases) taken from the
    keyframe the window BA moved; the carried VI prior is dropped then.
    Skipped while an IMU-init transform is pending: applying it resyncs
    the same state in the new frame.  Returns the culled keyframes."""
    m = tracker.map
    # the keyframe database's add_keyframe comes with place recognition
    # (Queue 1 item 4)
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
    # the loop closer's and the prior-map relocalizer's hooks come with
    # Queue 1 items 6 and 5
    return culled
