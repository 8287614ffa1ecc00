"""Slice 9, `System` end to end, against the JAX package on the CPU.

(a) The options the port does not carry yet raise NotImplementedError
naming their ROADMAP item; without a card the default device raises.

(b) The port's `System` (`use_loop_closing=False`, synchronous mapping,
on the CPU: the plain versions) against the JAX package's `System` built
the same way, with its vocabularies and keyframe database, over the
first N_FRAMES frames of `inputs.build_tracked_sequence` at the reduced
caps of tests/test_torch_tracked_sequence.py (500 ORB features, a store
of 64 keyframes / 4096 points / 512 lines, BA windows of 16 KF x 1024
points x 2048 observations). The port's front end makes each frame's
features once, and both sides track them. The port starts from the JAX
run's state after its bootstrap (map, mapper, tracker and the keyframe
database's banks: `state.mapstore_from_numpy`, `load_mapper_state`,
`load_tracker_state`, `load_kfdb_state`); the two bootstraps' float32
homography refits leave maps ~1e-3 apart
(tests/test_torch_bootstrap.py).

(c) Relocalization, teacher-forced from the end of (b), on both sides
with JAX's PnP samples (the reference's key split per attempt and its
`jax.random.choice` draws, replayed through the port's `pnp_sampler`):
LOST with no pose, as `System.load_atlas` leaves the tracker
(models/system.py:480-490), fed an earlier frame again; and the VI bridge
(models/tracking.py:290-330): the map marked IMU-initialized, the tracker
RECENTLY_LOST for 10 frames (0.5 s) with its pose turned about, so that
tracking from it fails and the bridge relocalizes.

(d) The port's `System` with loop closing on (the system's default)
against the JAX `System` with its `LoopCloser`, monocular at the same
reduced sizes over LC_FRAMES frames, the port from the JAX run's state
(the loop closer's too: `state.load_loop_closer_state`) once the map
holds LC_START_KF keyframes, so that `_detect` runs on every later
keyframe; teacher-forced as tests/test_torch_loop_closing.py is (the
reference's RANSAC samples and database answers, the port's own answers
held to them above the float32 noise of disjoint bags).

Tolerances, and why:
- every frame's state, inliers, the keyframes made and the map's counts
  equal, poses within 1e-4 a pose entry (the rule of
  tests/test_torch_tracked_sequence.py; counts and thresholds that
  float32 rounding does not reach here);
- every keyframe database row (word ids, bag, line bag), `present` and
  `has_lines` equal: the pipeline is exact
  (tests/test_torch_vocabulary.py);
- the `Metrics` stage names and call counts equal (times are the host's);
- relocalization's candidates, accepted candidate, state and inliers
  equal, the pose within 1e-4.

Run as a script, it prints REF_MH for chip_smoke.py: the JAX `System`
(`use_loop_closing=False`, synchronous mapping) over the 8 s MH replay
of tests/test_mh_replay_regression.py at production's sizes, with
`cfg.seed` 0..4 (one process each), then the relocalization case:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_system.py
"""
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.config import (CameraConfig, ImuConfig, MapConfig, OrbConfig,
                              Sensor, SystemConfig)
from plvio_tpu.io import synthetic as JSYN
from plvio_tpu.io import trajectory as JTIO
from plvio_tpu.models import tracking as JT
from plvio_tpu.models import vocabulary as JV
from plvio_tpu.models.kfdb import AtlasKeyFrameDatabase as JAtlasDB
from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plvio_tpu.models.mapstore import INVALID
from plvio_tpu.models.mapstore import Atlas as JAtlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu.models.system import System as JSystem
from plvio_tpu.ops import matching as JM
from plvio_tpu.ops import pnp as JP
from plvio_tpu.ops import twoview as JTV
from plvio_tpu.ops.frontend import Features as JFeatures
from plvio_tpu.ops.lines import LineFeatures as JLineFeatures
from plvio_tpu.utils import lie as JLIE
from plvio_tpu.utils.metrics import Metrics as JMetrics

N_FRAMES = 20
N_FEATURES = 500
MAP = dict(max_keyframes=64, max_points=4096, max_lines=512)
CAPS = dict(ba_kf_cap=16, ba_pt_cap=1024, ba_obs_cap=2048)
VIBA = dict(viba_kf_cap=32, viba_pt_cap=1024, viba_obs_cap=2048,
            viba_ln_cap=128, viba_lobs_cap=256)
POSE_TOL = 1e-4
RELOC_FRAME = 12        # the frame fed again to the relocalization cases


MH_SECONDS = 8.0
MH_SEED = 7
RELOC_START = 83        # the relocalization case's first frame (4.15 s)
RELOC_FRAMES = 5        # frames fed to it at most


def mh_config(seed: int = 0, **kw) -> SystemConfig:
    """tests/test_mh_replay_regression.py's configuration, loop closing
    off: IMU_MONOCULAR with lines, EuRoC K without distortion, the body
    frame the camera's, production's store and feature counts."""
    return SystemConfig(sensor=Sensor.IMU_MONOCULAR,
                        camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                        imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))),
                        use_loop_closing=False, seed=seed, **kw)


def jax_mh_inputs(seconds: float = MH_SECONDS, seed: int = MH_SEED):
    """The replay as the regression test makes it with the JAX package's
    generators: every frame rendered in order with the one generator,
    the per-frame IMU batches, the truth."""
    rng = np.random.default_rng(seed)
    scene = JSYN.make_hall_scene(rng, n_points=9000, n_lines=500)
    traj = JSYN.make_mh_trajectory(seconds + 0.3, fps=20.0)
    imu = JSYN.synthesize_imu_mh(rng, seconds + 0.3)
    frames, batches, last_t = [], [], None
    for t in traj.timestamps:
        frames.append(JSYN.render_frame_realistic(scene, JSYN._eval_mh, t,
                                                  rng))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            dts = np.diff(np.concatenate([[last_t], imu.timestamps[sel]]))
            batches.append((imu.gyro[sel], imu.acc[sel], dts))
        last_t = t
    return dict(frames=frames, timestamps=traj.timestamps, imu=batches,
                p_wc=traj.p_wb, R_wc=traj.R_wb, traj=traj)


def jit_reconstruction():
    """The JAX tracker's two-view reconstruction under jax.jit (the same
    function; eagerly it takes ~30 s to trace).  Returns the restore."""
    jitted = jax.jit(JTV.reconstruct_two_views, static_argnames=("iters",))
    orig = JTV.reconstruct_two_views
    JTV.reconstruct_two_views = lambda K, u1, u2, v, key, iters=200: \
        jitted(K, u1, u2, v, key, iters=iters)
    return orig


class _AsPort:
    """The JAX tracker with `full_trajectory` in numpy, for
    `entry.tracked_errors`."""

    def __init__(self, jt):
        self.jt = jt
        self.last_pose_cw = jt.last_pose_cw

    def full_trajectory(self):
        ts, pos, quat = self.jt.full_trajectory()
        return ts, pos, np.asarray(quat)


def recording_system(cfg) -> JSystem:
    """A JAX `System` that records the keyframes through its mapping step,
    the scales of the map transforms handed to the tracker (IMU init's
    first) and its relocalization attempts and successes."""
    s = JSystem(cfg)
    s.processed, s.scales, s.relocs = [], [], []
    process, transform = s._process_kf, s.tracker.apply_map_transform
    reloc = s.tracker._relocalize

    def recording(kf):
        s.processed.append(int(kf))
        process(kf)

    def recording_transform(R_gw, scale):
        s.scales.append(float(scale))
        transform(R_gw, scale)

    def recording_reloc(feats):
        ok = reloc(feats)
        s.relocs.append((s.tracker.frame_idx, bool(ok)))
        return ok
    s._process_kf = recording
    s.tracker.apply_map_transform = recording_transform
    s.tracker._relocalize = recording_reloc
    return s


def set_lost(t) -> None:
    """The tracker as `System.load_atlas` leaves it (models/system.py:480-
    490): LOST, no pose, re-entry through `_relocalize`."""
    t.state = t.state.__class__.LOST
    t.init_feats = None
    t.last_feats = None
    t.last_pose_cw = None
    t.last_feat_pt = None
    t.last_feat_ln = None
    t.ref_kf = INVALID
    t.last_created_kf = INVALID
    t.velocity = None
    t.lost_count = 0
    t.imu_since_kf = []


def pose_gap(P, G):
    """(camera-centre distance, rotation angle deg) between two T_cw."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    c_p = -P[:, :3].T @ P[:, 3]
    c_g = -G[:, :3].T @ G[:, 3]
    R = P[:, :3] @ G[:, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))
    return float(np.linalg.norm(c_p - c_g)), float(ang)


def reference_mh(seed: int = 0, seconds: float = MH_SECONDS) -> dict:
    """The JAX `System` over the MH replay with `cfg.seed` = seed, the
    regression's checks' quantities, the errors after `global_refine`,
    and the relocalization case on the final map."""
    from plvio_tpu_torch.entry import tracked_errors
    S = jax_mh_inputs(seconds)
    orig = jit_reconstruction()
    try:
        js = recording_system(mh_config(seed))
        jt = js.tracker
        init_frame = imu_frame = imu_kf = -1
        n_tracked, pre_scale, poses, t0 = 0, 0.0, [], time.time()
        for i, img in enumerate(S["frames"]):
            was = js.atlas.current.imu_initialized
            before = jt.state
            pose = js.track_monocular(img, float(S["timestamps"][i]),
                                      imu=S["imu"][i])
            n_tracked += pose is not None
            poses.append(None if pose is None else np.array(pose))
            if init_frame < 0 and before in (JT.TrackState.NO_IMAGES_YET,
                                             JT.TrackState.NOT_INITIALIZED) \
                    and jt.state == JT.TrackState.OK:
                init_frame = i
            if js.atlas.current.imu_initialized and not was:
                imu_frame, imu_kf = i, len(js.processed)
            elif not js.atlas.current.imu_initialized \
                    and jt.last_pose_cw is not None:
                pre_scale = tracked_errors(_AsPort(jt), S)[1]
            m = js.atlas.current
            print(f"  {i}: {jt.state.name} kf {m.n_kf} pts {m.n_pt} lines "
                  f"{m.n_ln} ({time.time() - t0:.0f} s)", file=sys.stderr,
                  flush=True)
        m = js.atlas.current
        out = {"n_frames": len(S["frames"]), "n_tracked": int(n_tracked),
               "init_frame": init_frame, "imu_init_kf": imu_kf,
               "imu_init_frame": imu_frame,
               "init_scale": js.scales[0] if js.scales else 0.0,
               "pre_init_scale": pre_scale,
               "imu_initialized": bool(m.imu_initialized),
               "ba_norm": float(np.linalg.norm(jt.frame_ba)),
               "maps": len(js.atlas.maps), "final_state": int(jt.state),
               "keyframes": int(m.n_kf), "points": int(m.n_pt),
               "lines": int(m.n_ln),
               "reloc_tried": len(js.relocs),
               "reloc_ok": sum(ok for _, ok in js.relocs)}
        js.global_refine()
        ate, scale, grav = tracked_errors(_AsPort(jt), S)
        traj = S["traj"]
        q = np.asarray(JLIE.rot_to_quat(jax.numpy.asarray(traj.R_wb,
                                                          np.float32)))
        gt = JTIO.Trajectory(traj.timestamps, traj.p_wb, q)
        est = js.trajectory()
        out.update(scale=scale, gravity_err_deg=grav, ate_sim3=ate[0],
                   ate_se3=ate[1],
                   ate_sim3_regression=JTIO.ate_rmse(est, gt, True),
                   ate_se3_regression=JTIO.ate_rmse(est, gt, False),
                   kf_bank_rows=int(js.kfdb.db().present.sum()))
        # relocalization on the final map: LOST with no pose, the frames
        # from RELOC_START fed again without IMU
        set_lost(jt)
        n0 = len(js.relocs)
        out["reloc_frames"], out["reloc_centre_m"] = -1, float("inf")
        out["reloc_rot_deg"] = float("inf")
        for j in range(RELOC_START, RELOC_START + RELOC_FRAMES):
            pose = js.track_monocular(S["frames"][j],
                                      float(S["timestamps"][j]), imu=None)
            if pose is not None:
                d = pose_gap(pose, poses[j])
                out["reloc_frames"] = j - RELOC_START + 1
                out["reloc_centre_m"], out["reloc_rot_deg"] = d
                break
        out["reloc_case_tries"] = len(js.relocs) - n0
    finally:
        JTV.reconstruct_two_views = orig
    return out


# --------------------------------------------------------------------------
# (a) what the port does not carry yet
# --------------------------------------------------------------------------

def _port_cfg(**kw):
    """The file's reduced sizes, loop closing off as `mh_config`'s unless
    kw turns it on."""
    from plvio_tpu_torch.config import MapConfig as PMap
    from plvio_tpu_torch.config import OrbConfig as POrb
    from plvio_tpu_torch.entry import system_config
    kw.setdefault("use_loop_closing", False)
    return system_config(orb=POrb(n_features=N_FEATURES), map=PMap(**MAP),
                         **kw)


def _port_system(**kw):
    from plvio_tpu_torch.models.system import System
    return System(_port_cfg(), device="cpu", caps=CAPS, viba_caps=VIBA,
                  **kw)


@pytest.mark.parametrize("what,item", [
    ("prior_reloc", 5), ("async", 9), ("kb8_imu", 7),
    ("kb8_lines", 7), ("change_dataset", 9), ("save_atlas", 9),
    ("load_atlas", 9), ("viewer", 9), ("overlay", 9), ("snapshot", 9),
    ("export_map", 9), ("ed_lines", 7)])
def test_not_ported_options_raise(what, item, monkeypatch):
    from plvio_tpu_torch.config import (CameraConfig as PCam, LineConfig,
                                        RelocConfig, Sensor as PSensor)
    from plvio_tpu_torch.models.system import System
    # the KB8 camera with an IMU or with lines, the ED line detector and
    # the prior-map relocalizer
    kb8 = PCam(model="kb8", dist=(0.0,) * 4)
    ctor = {"prior_reloc": dict(reloc=RelocConfig(enabled=True)),
            "kb8_imu": dict(camera=kb8, use_lines=False),
            "kb8_lines": dict(sensor=PSensor.MONOCULAR, camera=kb8),
            "ed_lines": dict(line=LineConfig(detector=1))}
    if what.startswith("kb8_"):
        # ported since slice 13 (item 7b'): the System builds, its mapper's
        # window BAs on the lens
        slam = System(_port_cfg(**ctor[what]), device="cpu")
        assert slam.mapper.ba_K == slam.tracker.kb8 is not None
        return
    if what in ("ed_lines", "prior_reloc"):
        # ported since slice 14 (items 7d and 5): the System builds with
        # the ED detector in its line front end, or with the relocalizer
        # (no prior directory given: no prior frame)
        slam = System(_port_cfg(**ctor[what]), device="cpu")
        if what == "ed_lines":
            assert slam.extract_lines.detector == 1
        else:
            assert slam.relocalizer is not None \
                and not slam.relocalizer.prior_frames
        return
    env = {"viewer": "PLVIO_VIEWER_PORT"}
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        if what in ctor:
            System(_port_cfg(**ctor[what]), device="cpu")
        elif what == "async":
            System(_port_cfg(), async_mapping=True, device="cpu")
        elif what in env:
            monkeypatch.setenv(env[what], "8000")
            _port_system()
        else:
            slam = _port_system()
            if what == "overlay":
                monkeypatch.setenv("PLVIO_OVERLAY_DIR", "/nonexistent")
                slam._maybe_dump_overlay(None)
            elif what == "snapshot":
                monkeypatch.setenv("PLVIO_SNAPSHOT_DIR", "/nonexistent")
                slam._maybe_snapshot()
            elif what == "export_map":
                slam.export_map("x")
            else:
                getattr(slam, what)(*(["d"] if "atlas" in what else []))


def test_default_device_is_the_card():
    """`System(cfg)` runs on the card; without one it raises (no silent
    fall back to the CPU)."""
    from plvio_tpu_torch.models.system import System
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(_port_cfg())


# --------------------------------------------------------------------------
# (b) the System against the JAX System
# --------------------------------------------------------------------------

def jax_config():
    return mh_config(orb=OrbConfig(n_features=N_FEATURES),
                     map=MapConfig(**MAP))


def jax_system_with_database(cfg):
    """A JAX `System` as its constructor builds it (models/system.py:42-
    150) with synchronous mapping, its vocabularies and keyframe database
    on the tracker and the mapper, the mapper at CAPS / VIBA; without
    the front end (the port's features are given), loop closing, the
    prior-map relocalizer, the viewer and the host's map-count tweak."""
    s = JSystem.__new__(JSystem)
    s.cfg = cfg
    from plvio_tpu.ops import frontend as JFE
    specs = JFE.make_level_specs(480, 752, cfg.orb.n_features,
                                 cfg.orb.n_levels, cfg.orb.scale_factor)
    s.n_feat = sum(sp.n_keep for sp in specs)
    s.atlas = JAtlas([JMapStore(
        max_kf=cfg.map.max_keyframes, max_pts=cfg.map.max_points,
        max_lines=cfg.map.max_lines, n_feat=s.n_feat)])
    s.vocabulary = JV.default_vocabulary("orb", seed=cfg.seed)
    s.line_vocabulary = JV.default_vocabulary("lbd", seed=cfg.seed + 1)
    s.kfdb = JAtlasDB(s.vocabulary, cfg.map.max_keyframes, s.n_feat,
                      s.atlas, line_voc=s.line_vocabulary,
                      n_line_feat=s.atlas.current.n_line_feat)
    s.metrics = JMetrics()
    s.tracker = JT.Tracker(cfg, s.atlas, s.n_feat)
    s.tracker.kfdb = s.kfdb
    s.tracker.metrics = s.metrics
    s.mapper = JLocalMapper(cfg, s.atlas, s.n_feat, **CAPS)
    for k, v in VIBA.items():
        setattr(s.mapper, k, v)
    s.mapper.kfdb = s.kfdb
    s.mapper.metrics = s.metrics
    s.loop_closer = s.relocalizer = s.live_viewer = None
    s.async_mapping = False
    s.map_lock = threading.RLock()
    s._frame_counter = 0
    s.processed = []
    process = s._process_kf

    def recording(kf):
        s.processed.append(int(kf))
        process(kf)
    s._process_kf = recording
    return s


def jax_track(s, f, lf, t, imu):
    """`System.track_monocular` past its front end (models/system.py:171-
    180), on given features."""
    with s.map_lock, s.metrics.stage("track"):
        pose = s.tracker.process_frame(f, t, imu=imu, line_feats=lf)
    s._drain_keyframes()
    with s.map_lock:
        s._apply_pending_transform()
    return pose


def jax_layout(f, lf):
    """The port's Features / LineFeatures in the JAX package's layout."""
    from plvio_tpu_torch.ops import matching as PM

    def pm1(d):
        return jnp.asarray(PM.unpack_u32_to_pm1(d).numpy(), jnp.bfloat16)

    def a(t):
        return jnp.asarray(t.numpy())

    return (JFeatures(uv=a(f.uv), uv_und=a(f.uv_und), response=a(f.response),
                      angle=a(f.angle), octave=a(f.octave), desc=pm1(f.desc),
                      valid=a(f.valid)),
            JLineFeatures(ep=a(lf.ep), angle=a(lf.angle), length=a(lf.length),
                          lineq=a(lf.lineq), desc=pm1(lf.desc),
                          valid=a(lf.valid)))


def _record(tr, made):
    m = tr.map
    return dict(state=int(tr.state), made=list(made),
                inliers=int(getattr(tr, "last_n_inliers", 0)),
                pose=None if tr.last_pose_cw is None
                else np.array(tr.last_pose_cw, np.float64),
                counts=(int(m.n_kf), int(m.n_pt), int(m.n_ln)))


def _calls(summary, base=None):
    """Stage and value names with their call counts (minus base's)."""
    out = {}
    for k, v in summary.items():
        n = v.get("calls", v.get("n"))
        n0 = 0 if base is None or k not in base else \
            base[k].get("calls", base[k].get("n"))
        if n - n0:
            out[k] = n - n0
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Both systems over N_FRAMES frames: JAX from the start, the port
    from the JAX run's state after the bootstrap."""
    from plvio_tpu_torch.inputs import build_tracked_sequence
    from plvio_tpu_torch.models.system import frame_prelude
    from plvio_tpu_torch.state import (kfdb_state, load_kfdb_state,
                                       load_mapper_state, load_tracker_state,
                                       mapper_state, mapstore_from_numpy,
                                       mapstore_to_numpy, tracker_state)
    S = build_tracked_sequence(0, N_FRAMES)
    port = _port_system()
    with torch.no_grad():
        feats = [frame_prelude(port.extract, port.extract_lines,
                               port.camera, torch.from_numpy(im))
                 for im in S["frames"]]
    orig = jit_reconstruction()
    try:
        js = jax_system_with_database(jax_config())
        assert js.n_feat == port.n_feat
        jt, pt = js.tracker, port.tracker
        made_p = []
        process = port.mapper.process_keyframe

        def recording(kf, protect=()):
            made_p.append(int(kf))
            return process(kf, protect=protect)
        port.mapper.process_keyframe = recording
        recs, start, base = [], -1, None
        for i, (f, lf) in enumerate(feats):
            t, imu = float(S["timestamps"][i]), S["imu"][i]
            if start < 0 and jt.state == JT.TrackState.OK:
                start = i
                port.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(port.mapper, mapper_state(js.mapper))
                load_tracker_state(pt, tracker_state(jt))
                load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
                base = js.metrics.summary()
            n0 = len(js.processed)
            jf, jl = jax_layout(f, lf)
            jax_track(js, jf, jl, t, imu)
            jrec = _record(jt, js.processed[n0:])
            if start >= 0:
                del made_p[:]
                with torch.no_grad():
                    port.track_features(f, lf, t, imu)
                recs.append((i, jrec, _record(pt, made_p)))
    finally:
        JTV.reconstruct_two_views = orig
    return dict(S=S, feats=feats, recs=recs, start=start, js=js, port=port,
                base=base)


def test_system_tracks_every_frame_as_reference(run):
    """From the common start: every frame's state, inliers, the keyframes
    made, the map's counts equal, the pose within POSE_TOL."""
    assert 1 <= run["start"] <= 4
    assert len(run["recs"]) == N_FRAMES - run["start"]
    worst = 0.0
    for i, j, p in run["recs"]:
        assert j["state"] == int(JT.TrackState.OK), i
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (i, k, p[k], j[k])
        d = float(np.abs(p["pose"] - j["pose"]).max())
        worst = max(worst, d)
        assert d <= POSE_TOL, (i, d)
    print(f"largest pose difference {worst:.2e}")
    assert sum(len(p["made"]) for _, _, p in run["recs"]) >= 3


def test_keyframe_database_rows_equal(run):
    """Every keyframe's bank row (word ids, bag, line bag) equal to the JAX
    database's, `present` after the culls and `has_lines` too; one row a
    live keyframe."""
    dj, dp = run["js"].kfdb.db(), run["port"].kfdb.db()
    m = run["port"].atlas.current
    np.testing.assert_array_equal(dp.present, dj.present)
    np.testing.assert_array_equal(dp.present, m.kf_valid)
    np.testing.assert_array_equal(dp.word_ids.numpy(), dj.word_ids)
    np.testing.assert_array_equal(dp.bows.numpy(), dj.bows)
    np.testing.assert_array_equal(dp.has_lines, dj.has_lines)
    np.testing.assert_array_equal(dp.bows_l.numpy(), dj.bows_l)


def test_metrics_stages_equal(run):
    """The stage profiler: the same stages and values, called as often
    (since the common start)."""
    pj = _calls(run["js"].metrics.summary(), run["base"])
    pp = _calls(run["port"].metrics_summary())
    assert pp == pj
    assert {"track", "mapping", "track/inliers", "track/preintegrate",
            "mapping/fuse", "mapping/kf_cull"} <= set(pp)


def test_trajectory_files_equal(run, tmp_path):
    """`save_trajectory` and `save_keyframe_trajectory` (TUM files) as the
    JAX System writes them: timestamps equal, positions and quaternions
    within POSE_TOL (the poses' own tolerance); each package reads the
    other's file."""
    from plvio_tpu_torch.io import trajectory as PTIO
    js, port = run["js"], run["port"]
    for save in ("save_trajectory", "save_keyframe_trajectory"):
        fj = str(tmp_path / f"j_{save}.txt")
        fp = str(tmp_path / f"p_{save}.txt")
        getattr(js, save)(fj)
        getattr(port, save)(fp)
        tj, tp = JTIO.read_tum(fj), PTIO.read_tum(fp)
        np.testing.assert_array_equal(tp.timestamps, tj.timestamps)
        assert len(tp) >= (3 if "keyframe" in save else N_FRAMES - 4)
        np.testing.assert_allclose(tp.positions, tj.positions, atol=POSE_TOL)
        np.testing.assert_allclose(tp.quaternions, tj.quaternions,
                                   atol=POSE_TOL)
        np.testing.assert_array_equal(PTIO.read_tum(fj).positions,
                                      tj.positions)


class JaxDraws:
    """The reference tracker's PnP samples (models/tracking.py:1303): its
    key split once per attempt, then `jax.random.choice` per hypothesis
    (ops/pnp.py:59-63)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, valid):
        self.key, sub = jax.random.split(self.key)
        p = valid.astype(np.float32)
        p = p / max(p.sum(), 1.0)
        keys = jax.random.split(sub, 128)
        return np.array(jax.vmap(lambda k: jax.random.choice(
            k, len(valid), shape=(6,), replace=False,
            p=jnp.asarray(p)))(keys))


def _reloc_case(run, setup, ts):
    """Put both trackers where the reference relocalizes (`setup(t)` on
    each), feed them the same frame at time ts, and return (JAX's
    candidates, the keyframes JAX's `_track_frame` ran on, the port's
    relocalization tries and record, both trackers' records)."""
    js, port = run["js"], run["port"]
    jt, pt = js.tracker, port.tracker
    f, lf = run["feats"][RELOC_FRAME]
    jf, jl = jax_layout(f, lf)
    setup(jt)
    setup(pt)
    desc = np.asarray(JM.pack_bits_u32(jf.desc))
    cands_j, _ = js.kfdb.query(desc, np.asarray(jf.valid), top_n=3)
    tried, track = [], jt._track_frame

    def recording_track(feats):
        tried.append(int(jt.ref_kf))
        return track(feats)
    jt._track_frame = recording_track
    pt.pnp_sampler = JaxDraws(jt._key)
    tries0 = pt.reloc_tries
    # the JAX tracker's PnP RANSAC under jax.jit (the same function;
    # eagerly it takes ~7 s a call)
    eager = JP.pnp_ransac
    JP.pnp_ransac = jax.jit(eager, static_argnames=("iters", "chi2_th"))
    try:
        jt.process_frame(jf, ts, line_feats=jl)
        pt.process_frame(f, ts, line_feats=lf)
    finally:
        JP.pnp_ransac = eager
        del jt._track_frame
        pt.pnp_sampler = None
    return cands_j, tried, pt.reloc_tries - tries0, pt.last_reloc, \
        _record(jt, []), _record(pt, [])


def _check_reloc(out):
    cands_j, tried_j, tries, rec, j, p = out
    assert tries >= 1 and rec is not None
    np.testing.assert_array_equal(rec["cands"], cands_j)
    assert rec["accepted"] >= 0
    # the JAX tracker's last _track_frame ran on the accepted candidate
    assert tried_j[-1] == rec["accepted"] and rec["cands"]
    for k in ("state", "inliers", "counts"):
        assert p[k] == j[k], (k, p[k], j[k])
    assert p["state"] == int(JT.TrackState.OK)
    assert float(np.abs(p["pose"] - j["pose"]).max()) <= POSE_TOL
    return rec


def test_relocalization_lost_without_pose(run):
    """LOST with no pose (System.load_atlas's state): the next frame goes
    straight to `_relocalize`, which finds its keyframe and tracks."""
    from plvio_tpu_torch.entry import lose_tracking

    def setup(t):
        if isinstance(t, JT.Tracker):
            set_lost(t)
        else:
            lose_tracking(t)

    rec = _check_reloc(_reloc_case(
        run, setup, float(run["S"]["timestamps"][RELOC_FRAME])))
    print(f"relocalized on {rec}")


def test_relocalization_vi_bridge(run):
    """The VI bridge: an IMU-initialized map, RECENTLY_LOST for 0.5 s, the
    pose turned about (tracking from it fails): the bridge relocalizes,
    keeps the dead-reckoned velocity and drops the lost period's IMU."""
    def setup(t):
        t.map.imu_initialized = True
        t.state = t.state.__class__.RECENTLY_LOST
        t.lost_count = 10
        flip = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
        t.last_pose_cw = np.concatenate(
            [flip @ t.last_pose_cw[:, :3], t.last_pose_cw[:, 3:]], 1)
        t.velocity = None
        t.frame_vel = np.array([0.1, 0.0, 0.0], np.float32)
        t.imu_since_kf = [(np.zeros((2, 3), np.float32),
                           np.zeros((2, 3), np.float32),
                           np.full(2, 0.005, np.float32))]

    ts = float(run["js"].tracker.last_frame_time) + 0.05
    assert ts == float(run["port"].tracker.last_frame_time) + 0.05
    rec = _check_reloc(_reloc_case(run, setup, ts))
    js, port = run["js"], run["port"]
    for t in (js.tracker, port.tracker):
        assert t.imu_since_kf == [] and t._skip_next_kf_imu
        np.testing.assert_array_equal(t.frame_vel,
                                      np.float32([0.1, 0.0, 0.0]))
    print(f"bridge relocalized on {rec}")


# the errors against the truth that chip_smoke.py holds to 2x the worst
# of the five seeds' (the card draws its own RANSAC samples)
MH_ERRORS = ("init_scale_err", "scale_err", "gravity_err_deg", "ate_sim3",
             "ate_se3", "reloc_centre_m", "reloc_rot_deg")


# --------------------------------------------------------------------------
# (d) the System with loop closing on (the default) against the JAX System
# --------------------------------------------------------------------------
LC_FRAMES = 56          # frames of the loop-closing run (JAX's map holds
#                         11 keyframes at frame 47, 13 by frame 55)
LC_START_KF = 11        # the port starts once the JAX map holds this many


def jax_lc_config():
    """The file's reduced sizes, monocular (no IMU), loop closing on."""
    return SystemConfig(sensor=Sensor.MONOCULAR,
                        camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                        orb=OrbConfig(n_features=N_FEATURES),
                        map=MapConfig(**MAP))


def _lc_record(lc, db):
    return dict(groups=[(sorted(int(k) for k in g), int(v))
                        for g, v in lc.consistency],
                counters=(int(lc.n_loops_closed), int(lc.n_maps_merged)),
                failed={int(k): int(v) for k, v in lc._failed_cands.items()},
                queries=None if db is None else db.queries)


@pytest.fixture(scope="module")
def run_lc():
    """Both systems with loop closing over LC_FRAMES frames: JAX from the
    start, the port from the JAX run's state (map, mapper, tracker, the
    database's banks and the loop closer) once its map holds LC_START_KF
    keyframes, so that the next keyframe runs `_detect`.  The port's
    closer draws JAX's RANSAC samples and acts on the JAX database's
    answers, its own held to them above the float32 noise
    (tests/test_torch_loop_closing.py `TeacherDB`)."""
    from plvio_tpu.models.loop_closing import LoopCloser as JLC
    from plvio_tpu_torch.config import Sensor as PSensor
    from plvio_tpu_torch.inputs import build_tracked_sequence
    from plvio_tpu_torch.models.system import System, frame_prelude
    from plvio_tpu_torch.state import (kfdb_state, load_kfdb_state,
                                       load_loop_closer_state,
                                       load_mapper_state, load_tracker_state,
                                       loop_closer_state, mapper_state,
                                       mapstore_from_numpy,
                                       mapstore_to_numpy, tracker_state)
    from test_torch_loop_closing import TeacherDB
    from test_torch_sim3 import JaxSim3Samples
    S = build_tracked_sequence(0, LC_FRAMES)
    sampler = JaxSim3Samples(0)
    port = System(_port_cfg(sensor=PSensor.MONOCULAR, use_loop_closing=True),
                  device="cpu", caps=CAPS, viba_caps=VIBA,
                  sim3_sampler=sampler)
    with torch.no_grad():
        feats = [frame_prelude(port.extract, port.extract_lines,
                               port.camera, torch.from_numpy(im))
                 for im in S["frames"]]
    orig = jit_reconstruction()
    try:
        cfg = jax_lc_config()
        js = jax_system_with_database(cfg)
        js.loop_closer = JLC(cfg, js.atlas, js.kfdb, js.n_feat)
        js.loop_closer.mapper = js.mapper
        jt, pt = js.tracker, port.tracker
        made_p = []
        process = port.mapper.process_keyframe

        def recording(kf, protect=()):
            made_p.append(int(kf))
            return process(kf, protect=protect)
        port.mapper.process_keyframe = recording
        recs, start, base, db = [], -1, None, None
        for i, (f, lf) in enumerate(feats):
            t = float(S["timestamps"][i])
            if start < 0 and js.atlas.current.n_kf >= LC_START_KF:
                start = i
                port.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(port.mapper, mapper_state(js.mapper))
                load_tracker_state(pt, tracker_state(jt))
                load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
                load_loop_closer_state(port.loop_closer,
                                       loop_closer_state(js.loop_closer))
                sampler.key = js.loop_closer._key
                db = TeacherDB(port.kfdb, js.kfdb)
                port.loop_closer.kfdb = db
                base = js.metrics.summary()
            n0 = len(js.processed)
            jf, jl = jax_layout(f, lf)
            jax_track(js, jf, jl, t, None)
            jrec = dict(_record(jt, js.processed[n0:]),
                        lc=_lc_record(js.loop_closer, None))
            if start >= 0:
                del made_p[:]
                with torch.no_grad():
                    port.track_features(f, lf, t, None)
                prec = dict(_record(pt, made_p),
                            lc=_lc_record(port.loop_closer, db))
                recs.append((i, jrec, prec))
    finally:
        JTV.reconstruct_two_views = orig
    return dict(recs=recs, start=start, js=js, port=port, base=base, db=db)


def test_system_with_loop_closing_as_reference(run_lc):
    """From the common start: every frame's state, inliers, keyframes made
    and map counts equal, the pose within POSE_TOL; after every frame the
    loop closer's consistency groups and votes, cooldowns and counters
    equal; `_detect` ran (the database was asked) on a map of >= 12
    keyframes; the loop-closing stage called as often."""
    assert run_lc["start"] > 0
    recs = run_lc["recs"]
    assert len(recs) >= 8
    for i, j, p in recs:
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (i, k, p[k], j[k])
        if j["pose"] is not None:
            assert float(np.abs(p["pose"] - j["pose"]).max()) <= POSE_TOL, i
        jl, pl = j["lc"], p["lc"]
        for k in ("groups", "counters", "failed"):
            assert pl[k] == jl[k], (i, k, pl[k], jl[k])
    assert recs[-1][2]["lc"]["queries"] > 0
    assert recs[-1][2]["counts"][0] >= 12
    pj = _calls(run_lc["js"].metrics.summary(), run_lc["base"])
    pp = _calls(run_lc["port"].metrics_summary())
    assert pp.get("loop_closing") == pj.get("loop_closing") > 0



def with_errors(r: dict) -> dict:
    """The run's scale errors: the IMU init's (the trajectory's scale just
    after it, init_scale x pre_init_scale, against 1) and the final's."""
    return {**r, "init_scale_err": abs(r["init_scale"] * r["pre_init_scale"]
                                       - 1.0),
            "scale_err": abs(r["scale"] - 1.0)}


def reference_five_seeds(n_proc: int = 5) -> dict:
    """REF_MH: seed 0's run, and each quantity's worst over the seeds
    0..4 (one process each)."""
    import os
    import subprocess
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    runs = []
    for start in range(0, 5, n_proc):
        procs = [subprocess.Popen([sys.executable, __file__, "--seed",
                                   str(k)], stdout=subprocess.PIPE,
                                  env=env,
                                  text=True)
                 for k in range(start, min(start + n_proc, 5))]
        for p in procs:
            out, _ = p.communicate()
            line = [x for x in out.splitlines() if x.startswith("MH_SEED = ")]
            runs.append(with_errors(json.loads(line[-1][len("MH_SEED = "):])))
    ref = dict(runs[0])
    for k in MH_ERRORS:
        ref[k + "_worst"] = max(r[k] for r in runs)
    ref["n_tracked_min"] = min(r["n_tracked"] for r in runs)
    ref["reloc_frames_max"] = max(r["reloc_frames"] for r in runs)
    ref["reloc_tried_max"] = max(r["reloc_tried"] for r in runs)
    ref["per_seed"] = [{k: r[k] for k in (
        "n_tracked", "imu_init_kf", "keyframes", "points", "lines", "maps",
        "ba_norm", "reloc_tried", "reloc_ok", "reloc_frames",
        "reloc_case_tries") + MH_ERRORS} for r in runs]
    return ref


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed"]:
        print("MH_SEED = " + json.dumps(reference_mh(int(sys.argv[2]))))
    else:
        print("REF_MH = " + json.dumps(reference_five_seeds()))
