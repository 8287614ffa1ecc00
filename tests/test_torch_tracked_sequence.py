"""Slice 8, the closed loop from rendered frames to the keyframe step, against
the JAX package on the CPU.

`inputs.build_tracked_sequence` renders the inputs of
scripts/run_synthetic_vi.py (the room with 4000 points and 60 segments,
the 0.6 m orbit at 20 fps, the biased 200 Hz IMU, seed 0).  The short
free run takes its first N_FRAMES frames at reduced caps: 500 ORB
features a frame, a store of 64 keyframes / 4096 points / 512 lines, the
BA windows at 16 KF x 1024 points x 2048 observations.  The port's front
end (plain, on the CPU) and its frame prelude make each frame's features
once; the JAX side gets the same arrays in its own layout, which isolates
the tracker and the keyframe step from the front end (whose parity
tests/test_torch_pyramid.py and the slice-1 tests hold).  The JAX side is
its `Tracker` and `LocalMapper` on one Atlas with `System`'s own keyframe
glue (`_drain_keyframes`, `_process_kf`, `_apply_pending_transform`,
synchronous) and no keyframe database.

The port starts from the JAX run's state at the frame after the
bootstrap (`state.mapstore_from_numpy`, `load_mapper_state`,
`load_tracker_state`): the bootstrap's homography refit is noise-dominated
in float32 (Queue 3, tests/test_torch_bootstrap.py), so two bootstraps
leave maps ~1e-3 apart and the free runs' inlier counts then differ by a
few a frame.  From the common start both run freely on the same features.

Tolerances, and why:
- every frame's state, inlier count, the keyframes it made and the
  map's keyframe, point and line counts are equal: each is a
  count or a threshold that float32 rounding does not reach here;
- every frame's pose within 1e-4 a pose entry of JAX's (the keyframe
  step's floor, tests/test_torch_keyframe_step.py;
  here the two lie ~1e-5 apart);
- at the end the stores' bindings, live sets and statistics are equal.

Run as a script, it prints REF_TRACK for chip_smoke.py: the JAX package
over the 180 frames at full width (its own front end, production's caps,
no keyframe database) on the CPU with the RANSAC key 0, and the worst of
its errors against the truth over the keys 0..4:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_tracked_sequence.py
"""
import json
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.config import (CameraConfig, ImuConfig, OrbConfig, Sensor,
                              SystemConfig)
from plvio_tpu.models import tracking as JT
from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plvio_tpu.models.mapstore import Atlas as JAtlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu.models.system import System as JSystem
from plvio_tpu.ops import twoview as JTV
from plvio_tpu.ops.frontend import Features as JFeatures
from plvio_tpu.ops.lines import LineFeatures as JLineFeatures
from plvio_tpu.utils.metrics import Metrics
from plvio_tpu_torch.entry import TrackedSequence, tracked_errors
from plvio_tpu_torch.inputs import build_tracked_sequence
from plvio_tpu_torch.models.system import (apply_pending_transform,
                                           drain_keyframes, frame_prelude)
from plvio_tpu_torch.ops import matching as PM
from plvio_tpu_torch.state import (load_mapper_state, load_tracker_state,
                                   mapper_state, mapstore_from_numpy,
                                   mapstore_to_numpy, tracker_state)

N_FRAMES = 20
N_FEATURES = 500
STORE = dict(max_kf=64, max_pts=4096, max_lines=512)
CAPS = dict(ba_kf_cap=16, ba_pt_cap=1024, ba_obs_cap=2048)
VIBA = dict(viba_kf_cap=32, viba_pt_cap=1024, viba_obs_cap=2048,
            viba_ln_cap=128, viba_lobs_cap=256)
POSE_TOL = 1e-4
EXACT = ("kf_valid", "kf_match_pt", "kf_match_ln", "kf_prev", "kf_next",
         "pt_valid", "ln_valid", "pt_n_obs", "ln_n_obs", "pt_found",
         "pt_visible", "ln_found", "ln_visible", "covis")


def jax_config(n_features=1000):
    """scripts/run_synthetic_vi.py's configuration: IMU_MONOCULAR with
    lines, EuRoC K without distortion, the body frame the camera's."""
    return SystemConfig(sensor=Sensor.IMU_MONOCULAR, use_lines=True,
                        camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                        imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))),
                        orb=OrbConfig(n_features=n_features),
                        use_loop_closing=False)


class NoDatabase:
    """`System._process_kf` hands every keyframe to the keyframe database;
    without place recognition there is none to add it to."""

    def add_keyframe(self, *args, **kw):
        pass


def jax_system(cfg, store=None, caps=None, viba=None, front_end=True):
    """A JAX `System` as its constructor builds it (models/system.py:42-
    150) for synchronous mapping, without the vocabulary, the keyframe
    database (tracker and mapper get none), loop closing, the prior-map
    relocalizer, the viewer and the host's map-count tweak; the store and
    the mapper at the given capacities (production's by default)."""
    from plvio_tpu.ops import cameras as JCAM
    from plvio_tpu.ops import frontend as JFE
    from plvio_tpu.ops import lines as JLN
    s = JSystem.__new__(JSystem)
    s.cfg = cfg
    cam = cfg.camera
    s.camera = JCAM.make_camera(cam)
    s._undistort = jax.jit(lambda uv: JCAM.undistort_pixels(s.camera, uv))
    specs = JFE.make_level_specs(cam.height, cam.width, cfg.orb.n_features,
                                 cfg.orb.n_levels, cfg.orb.scale_factor)
    s.level_specs = specs
    s.n_feat = sum(sp.n_keep for sp in specs)
    s.extract = s.extract_lines = None
    if front_end:
        s.extract, _ = JFE.make_extractor(
            cam.height, cam.width, cfg.orb.n_features, cfg.orb.n_levels,
            cfg.orb.scale_factor, cfg.orb.ini_th_fast, cfg.orb.min_th_fast)
        s.extract_lines = JLN.make_line_extractor(
            cam.height, cam.width, max_lines=256,
            detector=cfg.line.detector, levels=cfg.line.levels)
    store = {**dict(max_kf=cfg.map.max_keyframes, max_pts=cfg.map.max_points,
                    max_lines=cfg.map.max_lines), **(store or {})}
    s.atlas = JAtlas([JMapStore(n_feat=s.n_feat, **store)])
    s.kfdb = NoDatabase()
    s.metrics = Metrics()
    s.tracker = JT.Tracker(cfg, s.atlas, s.n_feat)
    s.tracker.kfdb = None
    s.tracker.metrics = s.metrics
    s.mapper = JLocalMapper(cfg, s.atlas, s.n_feat, **(caps or {}))
    for k, v in (viba or {}).items():
        setattr(s.mapper, k, v)
    s.mapper.kfdb = None
    s.mapper.metrics = s.metrics
    s.loop_closer = s.relocalizer = s.live_viewer = None
    s.async_mapping = False
    s.map_lock = threading.RLock()
    s._frame_counter = 0
    # the keyframes through the mapping step, in order, and the scales of
    # the map transforms handed to the tracker (IMU init's first)
    s.processed, s.scales = [], []
    process, transform = s._process_kf, s.tracker.apply_map_transform

    def recording(kf):
        s.processed.append(int(kf))
        process(kf)

    def recording_transform(R_gw, scale):
        s.scales.append(float(scale))
        transform(R_gw, scale)
    s._process_kf = recording
    s.tracker.apply_map_transform = recording_transform
    return s


def jax_frame(s, f, lf, t, imu):
    """`System.track_monocular` past its front end, on given features."""
    with s.map_lock:
        pose = s.tracker.process_frame(f, t, imu=imu, line_feats=lf)
    s._drain_keyframes()
    with s.map_lock:
        s._apply_pending_transform()
    return pose


def jax_layout(f, lf):
    """The port's Features / LineFeatures in the JAX package's layout."""
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


def jit_reconstruction():
    """The JAX tracker's two-view reconstruction under jax.jit (the same
    function; eagerly it takes ~30 s to trace).  Returns the restore."""
    jitted = jax.jit(JTV.reconstruct_two_views, static_argnames=("iters",))
    orig = JTV.reconstruct_two_views
    JTV.reconstruct_two_views = lambda K, u1, u2, v, key, iters=200: \
        jitted(K, u1, u2, v, key, iters=iters)
    return orig


def frame_record(tr, made):
    m = tr.map
    return dict(state=int(tr.state), made=list(made),
                inliers=int(getattr(tr, "last_n_inliers", 0)),
                pose=None if tr.last_pose_cw is None
                else np.array(tr.last_pose_cw, np.float64),
                counts=(int(m.n_kf), int(m.n_pt), int(m.n_ln)))


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
    """Both free runs over N_FRAMES frames: JAX from the start, the port
    from the JAX run's state after the bootstrap; per frame each side's
    state, inliers, keyframes made, pose and map counts."""
    S = build_tracked_sequence(0, N_FRAMES)
    step = TrackedSequence(plain=True, device="cpu", store=STORE, caps=CAPS,
                           viba_caps=VIBA, n_features=N_FEATURES)
    with torch.no_grad():
        feats = [frame_prelude(step.orb, step.lines, step.cam,
                               torch.from_numpy(im)) for im in S["frames"]]
    orig = jit_reconstruction()
    try:
        js = jax_system(jax_config(N_FEATURES), STORE, CAPS, VIBA,
                        front_end=False)
        assert js.n_feat == step.n_feat
        jt = js.tracker
        pt, pm = step.new_pipeline()
        recs, start = [], -1
        for i, (f, lf) in enumerate(feats):
            t, imu = float(S["timestamps"][i]), S["imu"][i]
            if start < 0 and jt.state == JT.TrackState.OK:
                start = i
                pt.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(pm, mapper_state(js.mapper))
                load_tracker_state(pt, tracker_state(jt))
            n0 = len(js.processed)
            jf, jl = jax_layout(f, lf)
            jax_frame(js, jf, jl, t, imu)
            jrec = frame_record(jt, js.processed[n0:])
            if start >= 0:
                with torch.no_grad():
                    pt.process_frame(f, t, imu=imu, line_feats=lf)
                    made = [k for k, _ in drain_keyframes(pt, pm)]
                    apply_pending_transform(pt, pm)
                prec = frame_record(pt, made)
                prec["matched"] = pt.last_n_matched
                recs.append((i, jrec, prec))
    finally:
        JTV.reconstruct_two_views = orig
    return dict(S=S, recs=recs, start=start, js=js, pt=pt, pm=pm)


def test_bootstrap_then_tracking(run):
    """The JAX run bootstraps within the first frames and tracks every
    frame after it; the port starts there."""
    assert 1 <= run["start"] <= 4
    assert len(run["recs"]) == N_FRAMES - run["start"]
    assert all(j["state"] == int(JT.TrackState.OK)
               for _, j, _ in run["recs"])


def test_every_frame_matches_reference(run):
    """Every frame from the common start: state, inliers, the keyframes
    made, the map counts equal, the pose within POSE_TOL."""
    worst = 0.0
    for i, j, p in run["recs"]:
        assert p["state"] == j["state"], i
        assert p["made"] == j["made"], (i, p["made"], j["made"])
        assert p["inliers"] == j["inliers"], (i, p["inliers"], j["inliers"])
        assert p["counts"] == j["counts"], (i, p["counts"], j["counts"])
        d = float(np.abs(p["pose"] - j["pose"]).max())
        worst = max(worst, d)
        assert d <= POSE_TOL, (i, d)
    print(f"largest pose difference {worst:.2e}")


def test_keyframe_decisions_and_stores_equal(run):
    """The keyframes made (slots, frames), and at the end the stores'
    bindings, live sets, statistics and covisibility equal."""
    made = [p["made"] for _, _, p in run["recs"]]
    assert sum(len(m) for m in made) >= 3
    kj = np.flatnonzero(run["js"].atlas.current.kf_valid)
    kp = np.flatnonzero(run["pt"].map.kf_valid)
    np.testing.assert_array_equal(kp, kj)
    j = mapstore_to_numpy(run["js"].atlas.current)
    p = mapstore_to_numpy(run["pt"].map)
    for k in EXACT:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    jt, pt = run["js"].tracker, run["pt"]
    assert pt.ref_kf == jt.ref_kf and pt.last_created_kf == jt.last_created_kf
    np.testing.assert_array_equal(pt.last_feat_pt, jt.last_feat_pt)
    np.testing.assert_array_equal(pt.last_feat_ln, jt.last_feat_ln)


def test_trajectory_and_errors(run):
    """The port's frame records give the same trajectory as the JAX
    tracker's (through the current keyframe poses), and its errors."""
    jt, pt = run["js"].tracker, run["pt"]
    tj, pj, qj = jt.full_trajectory()
    tp, pp, qp = pt.full_trajectory()
    np.testing.assert_array_equal(tp, tj)
    assert float(np.abs(pp - pj).max()) <= 1e-4
    assert float(np.abs(qp - np.asarray(qj)).max()) <= 1e-4
    ate, scale, grav = tracked_errors(pt, run["S"])
    assert np.isfinite(ate[0]) and ate[0] < 0.05 and scale > 0


def reference_track(n_frames: int = 180, seed: int = 0,
                    key: int = 0) -> dict:
    """The JAX package over build_tracked_sequence(seed) at full width (its
    own front end, 1000 ORB and 256 line features, production's store and
    caps, no keyframe database), its bootstrap's RANSAC key PRNGKey(key)."""
    S = build_tracked_sequence(seed, n_frames)
    orig = jit_reconstruction()
    try:
        js = jax_system(jax_config().replace(seed=key))
        init_frame = imu_frame = imu_kf = -1
        n_tracked, t0, pre_scale = 0, time.time(), 0.0
        states = []
        for i, img in enumerate(S["frames"]):
            was = js.atlas.current.imu_initialized
            before = js.tracker.state
            pose = js.track_monocular(img, float(S["timestamps"][i]),
                                      imu=S["imu"][i])
            n_tracked += pose is not None
            if init_frame < 0 and before in (JT.TrackState.NO_IMAGES_YET,
                                             JT.TrackState.NOT_INITIALIZED) \
                    and js.tracker.state == JT.TrackState.OK:
                init_frame = i
            if js.atlas.current.imu_initialized and not was:
                imu_frame, imu_kf = i, len(js.processed)
            elif not js.atlas.current.imu_initialized \
                    and js.tracker.last_pose_cw is not None:
                pre_scale = tracked_errors(_AsPort(js.tracker), S)[1]
            states.append(int(js.tracker.state))
            m = js.atlas.current
            print(f"  {i}: {js.tracker.state.name} kf {m.n_kf} pts {m.n_pt} "
                  f"lines {m.n_ln} ({time.time() - t0:.0f} s)",
                  file=sys.stderr, flush=True)
    finally:
        JTV.reconstruct_two_views = orig
    m = js.atlas.current
    ate, scale, grav = tracked_errors(_AsPort(js.tracker), S)
    return {"n_frames": n_frames, "n_tracked": int(n_tracked),
            "init_frame": init_frame, "imu_init_kf": imu_kf,
            "imu_init_frame": imu_frame,
            "init_scale": js.scales[0] if js.scales else 0.0,
            "pre_init_scale": pre_scale,
            "scale": scale, "gravity_err_deg": grav,
            "keyframes": int(m.n_kf), "points": int(m.n_pt),
            "lines": int(m.n_ln), "ate_sim3": ate[0], "ate_se3": ate[1],
            "maps": len(js.atlas.maps),
            "lost_frames": int(sum(s != int(JT.TrackState.OK)
                                   for s in states))}


class _AsPort:
    """The JAX tracker with `full_trajectory` in the port's output types,
    for `entry.tracked_errors`."""

    def __init__(self, jt):
        self.jt = jt
        self.last_pose_cw = jt.last_pose_cw

    def full_trajectory(self):
        ts, pos, quat = self.jt.full_trajectory()
        return ts, pos, np.asarray(quat)


@pytest.mark.slow
def test_reference_track_full_width():
    """The JAX package's own run at full width initializes the IMU and
    tracks the sequence (the REF_TRACK run; minutes on the CPU)."""
    ref = reference_track()
    assert ref["imu_init_frame"] > 0
    assert ref["n_tracked"] >= 0.9 * ref["n_frames"]


# the errors against the truth that chip_smoke.py holds to 2x the worst
# of the five keys' (REF_BOOT's rule: the card draws its own samples)
ERRORS = ("init_scale_err", "scale_err", "gravity_err_deg", "ate_sim3",
          "ate_se3")


def with_errors(r: dict) -> dict:
    """The run's scale errors: the IMU init's (the trajectory's scale just
    after it, init_scale x pre_init_scale, against 1) and the final's."""
    return {**r, "init_scale_err": abs(r["init_scale"] * r["pre_init_scale"]
                                       - 1.0),
            "scale_err": abs(r["scale"] - 1.0)}


def reference_five_keys() -> dict:
    """REF_TRACK: key 0's run, and each error's worst over the RANSAC keys
    0..4 (one process each, in parallel; ~10 min on 8 cores)."""
    import os
    import subprocess
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, __file__, "--key", str(k)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, env=env, text=True)
             for k in range(5)]
    runs = []
    for p in procs:
        out, _ = p.communicate()
        line = [x for x in out.splitlines() if x.startswith("TRACK_KEY = ")]
        runs.append(with_errors(json.loads(line[-1][len("TRACK_KEY = "):])))
    ref = dict(runs[0])
    for k in ERRORS:
        ref[k + "_worst"] = max(r[k] for r in runs)
    ref["n_tracked_min"] = min(r["n_tracked"] for r in runs)
    ref["per_key"] = [{k: r[k] for k in ("n_tracked", "imu_init_kf",
                                         "keyframes", "points", "lines")
                       + ERRORS} for r in runs]
    return ref


if __name__ == "__main__":
    if sys.argv[1:2] == ["--key"]:
        print("TRACK_KEY = " + json.dumps(reference_track(
            key=int(sys.argv[2]))))
    else:
        print("REF_TRACK = " + json.dumps(reference_five_keys()))
