"""Carry what the JAX package holds (the map, a pose, the inertial
window's state, a keyframe map store, the local mapper's, the tracker's
and the loop closer's host state, a vocabulary, the keyframe database's
banks) over to the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models import mapstore as MS
from .models.kernels import PRE_KEYS
from .ops.imu import Preintegrated
from .ops.frontend import brief_pattern
from .ops.lines import _band_pair_pattern

_BOOL = ("pt_valid", "ln_valid")
_DESC = ("pt_desc", "ln_desc")
_FLOAT = ("pt_xyz", "ln_ep6", "pose")


def from_numpy(arrays: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    """Map and pose arrays of the JAX package -> the port's tensors.

    Takes any of pt_xyz [P,3], pt_desc [P,8] uint32, pt_valid [P], ln_ep6
    [L,6], ln_desc [L,8] uint32, ln_valid [L] and pose [3,4] (T_cw).
    Descriptors become int32 with the same bits (a view, no arithmetic).
    Adds the two fixed patterns the port rebuilds from the reference's
    numpy recipes: 'brief_pattern' [256,2,2] float32 (seed 7,
    ops/frontend.py:271-281) and 'lbd_pairs' [256,2,2] int32 (seed 11,
    ops/lines.py:432-442)."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if k in _DESC:
            if a.dtype != np.uint32 or a.shape[-1] != 8:
                raise ValueError(f"{k}: expected [*,8] uint32, got "
                                 f"{a.dtype} {a.shape}")
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        elif k in _BOOL:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=bool))
        elif k in _FLOAT:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        else:
            raise KeyError(f"from_numpy: unknown array {k!r}")
        out[k] = t.to(device)
    out["brief_pattern"] = torch.from_numpy(brief_pattern()).to(device)
    out["lbd_pairs"] = torch.from_numpy(_band_pair_pattern()).to(device)
    return out


def _preint_to_numpy(p) -> Dict[str, np.ndarray]:
    """A Preintegrated (the port's or the JAX package's, or a dict of its
    fields) as a dict of numpy arrays, field by field."""
    if isinstance(p, dict):
        items = p.items()
    else:
        items = ((f, getattr(p, f)) for f in p._fields)
    return {f: np.array(v) for f, v in items}


def mapstore_to_numpy(m: MS.MapStore) -> Dict[str, np.ndarray]:
    """A map store's arrays (`models.mapstore.ARRAYS`, copies), its
    scalars (`SCALARS`, as Python ints) and its inertial fields
    (`INERTIAL`: the three flags as bools; `kf_preint` as {kf: {field of
    Preintegrated: array}}; `kf_imu_raw` as {kf: (gyro, acc, dt)}): the
    layout of the JAX package's `MapStore` attributes of the same names."""
    out = {k: np.array(getattr(m, k)) for k in MS.ARRAYS}
    out.update({k: int(getattr(m, k)) for k in MS.SCALARS})
    out.update({k: bool(getattr(m, k)) for k in MS.INERTIAL[:3]})
    out["kf_preint"] = {int(kf): _preint_to_numpy(p)
                        for kf, p in m.kf_preint.items()}
    out["kf_imu_raw"] = {int(kf): tuple(np.array(a) for a in raw)
                         for kf, raw in m.kf_imu_raw.items()}
    return out


def mapstore_from_numpy(arrays: Dict[str, np.ndarray]) -> MS.MapStore:
    """The port's map store holding `arrays`: every name of
    `models.mapstore.ARRAYS` and `SCALARS`, and those of `INERTIAL` that
    are given (the others keep their defaults), as `mapstore_to_numpy`
    gives them or as a JAX package `MapStore`'s attributes hold them.
    The arrays are copied in their store dtypes (descriptors stay uint32
    on the host; the mapper hands them to the device as int32 views);
    each `kf_preint` entry becomes a Preintegrated of numpy arrays."""
    missing = [k for k in MS.ARRAYS + MS.SCALARS if k not in arrays]
    if missing:
        raise KeyError(f"mapstore_from_numpy: missing {missing}")
    m = MS.MapStore(max_kf=int(arrays["max_kf"]),
                    max_pts=int(arrays["max_pts"]),
                    max_lines=int(arrays["max_lines"]),
                    n_feat=int(arrays["n_feat"]),
                    n_line_feat=int(arrays["n_line_feat"]),
                    map_id=int(arrays["map_id"]))
    for k in MS.ARRAYS:
        ref = getattr(m, k)
        a = np.asarray(arrays[k])
        if a.shape != ref.shape:
            raise ValueError(f"mapstore_from_numpy: {k} has shape {a.shape}, "
                             f"the store {ref.shape}")
        setattr(m, k, np.array(a, dtype=ref.dtype))
    for k in ("n_kf", "n_pt", "n_ln", "change_index"):
        setattr(m, k, int(arrays[k]))
    for k in MS.INERTIAL[:3]:
        setattr(m, k, bool(arrays.get(k, False)))
    m.kf_preint = {int(kf): Preintegrated(**_preint_to_numpy(p))
                   for kf, p in arrays.get("kf_preint", {}).items()}
    m.kf_imu_raw = {int(kf): tuple(np.array(a, np.float32) for a in raw)
                    for kf, raw in arrays.get("kf_imu_raw", {}).items()}
    return m


def mapper_state(mapper) -> dict:
    """The local mapper's host state between keyframes (the port's or the
    JAX package's `LocalMapper`): the culling batches `recent_pts` /
    `recent_lns` (lists of id arrays), `_kf_since_init`, the full-map
    pulse state `_viba` ({map_id: {"t0", "last", "v2", "pulse_blocks"}}),
    the pending map transform (R_gw [3,3], scale) or None and the last
    gravity fixes `_last_gfix` ({map_id: time}); copies."""
    pt = mapper.pending_transform
    return dict(
        recent_pts=[np.array(b) for b in mapper.recent_pts],
        recent_lns=[np.array(b) for b in getattr(mapper, "recent_lns", [])],
        kf_since_init=int(getattr(mapper, "_kf_since_init", 0)),
        viba={int(k): {f: (list(v) if isinstance(v, list) else v)
                       for f, v in st.items()}
              for k, st in getattr(mapper, "_viba", {}).items()},
        pending_transform=None if pt is None else
        (np.array(pt[0], np.float32), float(pt[1])),
        last_gfix={int(k): float(v)
                   for k, v in getattr(mapper, "_last_gfix", {}).items()})


def load_mapper_state(mapper, st: dict) -> None:
    """Set a local mapper's host state from `mapper_state`'s dict (taken
    from either package's mapper)."""
    mapper.recent_pts = [np.array(b) for b in st["recent_pts"]]
    mapper.recent_lns = [np.array(b) for b in st["recent_lns"]]
    mapper._kf_since_init = int(st["kf_since_init"])
    mapper._viba = {int(k): {f: (list(v) if isinstance(v, list) else v)
                             for f, v in s.items()}
                    for k, s in st["viba"].items()}
    pt = st["pending_transform"]
    mapper.pending_transform = None if pt is None else \
        (np.array(pt[0], np.float32), float(pt[1]))
    mapper._last_gfix = dict(st["last_gfix"])


_INERTIAL_FLOAT = ("pose_wb", "vel", "bias_g", "bias_a", "imu_info",
                   "rw_info_g", "rw_info_a")


def inertial_from_numpy(arrays: Dict[str, np.ndarray],
                        device) -> Dict[str, torch.Tensor]:
    """The JAX package's inertial window state -> the port's tensors.

    Takes any of the keyframes' pose_wb [W,3,4], vel, bias_g, bias_a
    [W,3], the stacked preintegration constants of
    `LocalMapper._pre_const` (models/local_mapping.py:892-896: dT, dR, dV,
    dP, JRg, JVg, JVa, JPg, JPa, bg0, ba0, each [W-1, ...]; top-level keys
    or a 'pre_const' dict), imu_info [W-1,9,9], edge_valid [W-1] and
    rw_info_g / rw_info_a [W-1].  Float arrays become float32, edge_valid
    bool; the constants are returned as out['pre_const']."""
    out: Dict[str, torch.Tensor] = {}
    pre = dict(arrays.get("pre_const", {}))
    for k, v in arrays.items():
        if k == "pre_const":
            continue
        if k in PRE_KEYS:
            pre[k] = v
        elif k in _INERTIAL_FLOAT:
            out[k] = torch.from_numpy(np.ascontiguousarray(
                v, dtype=np.float32)).to(device)
        elif k == "edge_valid":
            out[k] = torch.from_numpy(np.ascontiguousarray(
                v, dtype=bool)).to(device)
        else:
            raise KeyError(f"inertial_from_numpy: unknown array {k!r}")
    if pre:
        missing = [k for k in PRE_KEYS if k not in pre]
        if missing:
            raise KeyError(f"inertial_from_numpy: pre_const lacks {missing}")
        out["pre_const"] = {k: torch.from_numpy(np.ascontiguousarray(
            pre[k], dtype=np.float32)).to(device) for k in PRE_KEYS}
    return out


# the tracker's host state between frames: arrays (copied) and scalars
_TRACKER_ARRAYS = ("last_pose_cw", "velocity", "last_feat_pt",
                   "last_feat_ln", "frame_vel", "frame_bg", "frame_ba",
                   "prior_H15")
_TRACKER_SCALARS = ("frame_idx", "last_frame_time", "ref_kf",
                    "last_created_kf", "last_kf_frame_idx", "last_kf_time",
                    "lost_count", "last_n_inliers", "_prior_frame_idx",
                    "init_timestamp", "only_tracking", "_skip_next_kf_imu",
                    "reloc_tries", "reloc_ok")


def tracker_state(tracker) -> dict:
    """The tracker's host state between frames (the port's or the JAX
    package's `Tracker`): its state, the frame pose, motion model,
    feature bindings and inertial frame state, the carried VI prior, the
    keyframe bookkeeping, the IMU buffered since the last keyframe, the
    keyframe queue and the frame records (as (timestamp, ref_kf, T_cr,
    map_id)); copies.  The feature sets of the last and the bootstrap
    frames are not carried (device data of one frame)."""
    st = {k: (None if getattr(tracker, k, None) is None
              else np.array(getattr(tracker, k)))
          for k in _TRACKER_ARRAYS}
    for k in _TRACKER_SCALARS:
        v = getattr(tracker, k, None)
        st[k] = v if v is None or isinstance(v, (bool, np.bool_)) \
            else (int(v) if isinstance(v, (int, np.integer)) else float(v))
    st["_skip_next_kf_imu"] = bool(getattr(tracker, "_skip_next_kf_imu",
                                           False))
    st["state"] = int(tracker.state)
    st["imu_since_kf"] = [tuple(np.array(a) for a in b)
                          for b in tracker.imu_since_kf]
    st["new_kf_queue"] = [int(k) for k in tracker.new_kf_queue]
    st["frames"] = [(float(r.timestamp), int(r.ref_kf), np.array(r.T_cr),
                     int(r.map_id)) for r in tracker.frames]
    # relocalization's sample source (the port's tracker only)
    gen = getattr(tracker, "generator", None)
    st["generator"] = None if gen is None else gen.get_state()
    return st


def load_tracker_state(tracker, st: dict) -> None:
    """Set a tracker's host state from `tracker_state`'s dict (taken from
    either package's tracker)."""
    from .models.tracking import FrameRecord, TrackState
    for k in _TRACKER_ARRAYS:
        setattr(tracker, k, None if st[k] is None else np.array(st[k]))
    for k in _TRACKER_SCALARS:
        # the relocalization counters default to 0: states made by hand or
        # by an older tracker_state lack them
        v = st.get(k, 0) if k in ("reloc_tries", "reloc_ok") else st[k]
        if v is not None or k == "last_frame_time":
            setattr(tracker, k, v)
    tracker.state = TrackState(st["state"])
    tracker.imu_since_kf = [tuple(np.array(a) for a in b)
                            for b in st["imu_since_kf"]]
    tracker.new_kf_queue = list(st["new_kf_queue"])
    tracker.frames = [FrameRecord(t, r, np.array(T), m)
                      for t, r, T, m in st["frames"]]
    if st.get("generator") is not None:
        tracker.generator.set_state(st["generator"])


def vocabulary_from_numpy(voc):
    """The JAX package's `Vocabulary` (+-1 centroid levels) as the port's
    (packed [k^(l+1), 8] int32 levels)."""
    from .models.vocabulary import from_bits
    return from_bits([np.asarray(C, np.float32) > 0 for C in voc.centroids],
                     int(voc.k), int(voc.depth))


_KFDB_ARRAYS = ("bows", "word_ids", "present", "bows_l", "has_lines")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.array(a)


def kfdb_state(atlas_db) -> dict:
    """Every map's keyframe database banks (the port's or the JAX
    package's `AtlasKeyFrameDatabase`): {map_id: {bows, word_ids, present,
    bows_l, has_lines}} as numpy copies (the line banks None without a
    line vocabulary)."""
    return {int(mid): {k: (None if getattr(db, k, None) is None
                           else _np(getattr(db, k))) for k in _KFDB_ARRAYS}
            for mid, db in atlas_db._dbs.items()}


def load_kfdb_state(atlas_db, st: dict) -> None:
    """Set the port's `AtlasKeyFrameDatabase` banks from `kfdb_state`'s
    dict (maps it lacks are made; maps st lacks are dropped)."""
    atlas_db._dbs = {}
    for mid, arrays in st.items():
        db = atlas_db.db(int(mid))
        db.bows.copy_(torch.from_numpy(arrays["bows"]))
        db.word_ids.copy_(torch.from_numpy(
            np.asarray(arrays["word_ids"], np.int32)))
        db.present[:] = arrays["present"]
        if db.line_voc is not None and arrays["bows_l"] is not None:
            db.bows_l.copy_(torch.from_numpy(arrays["bows_l"]))
            db.has_lines[:] = arrays["has_lines"]


def loop_closer_state(lc) -> dict:
    """The loop closer's host state between keyframes (the port's or the
    JAX package's `LoopCloser`): the consistency groups and their votes,
    the merge votes, the failed-candidate cooldowns, the loop edges per
    map and the counters; copies.  The RANSAC sample source is not carried
    (the JAX key and the port's generator differ)."""
    return dict(
        consistency=[(set(int(k) for k in g), int(v))
                     for g, v in lc.consistency],
        merge_votes={int(k): int(v) for k, v in lc.merge_votes.items()},
        failed_cands={int(k): int(v) for k, v in lc._failed_cands.items()},
        loop_edges={int(k): [(int(a), int(b)) for a, b in v]
                    for k, v in lc._loop_edges.items()},
        n_loops_closed=int(lc.n_loops_closed),
        n_maps_merged=int(lc.n_maps_merged))


def load_loop_closer_state(lc, st: dict) -> None:
    """Set a loop closer's host state from `loop_closer_state`'s dict."""
    lc.consistency = [(set(g), int(v)) for g, v in st["consistency"]]
    lc.merge_votes = dict(st["merge_votes"])
    lc._failed_cands = dict(st["failed_cands"])
    lc._loop_edges = {k: list(v) for k, v in st["loop_edges"].items()}
    lc.n_loops_closed = st["n_loops_closed"]
    lc.n_maps_merged = st["n_maps_merged"]
