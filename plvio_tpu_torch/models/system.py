"""The per-frame prelude of `System.track_monocular` (port of
plvio_tpu/models/system.py:160-169 and `_extract_frame_lines` :314-323):
ORB extraction, the keypoints' undistortion, line extraction, the
endpoints' undistortion and the segments' new line equations.  The rest
of `System` comes with the end-to-end slice.
"""
from __future__ import annotations

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
