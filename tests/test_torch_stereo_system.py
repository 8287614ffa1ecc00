"""Slice 11, `System.track_stereo` / `track_rgbd`, against the JAX package
on the CPU.

Run as a script, it prints REF_STEREO for chip_smoke.py: the JAX `System`
(IMU_STEREO with lines, rectified EuRoC geometry, baseline 0.11 m, the
system's defaults: loop closing on, synchronous mapping) over the 8 s
stereo MH replay at production's sizes with `cfg.seed` 0..4 (one process
each), and the room orbits of tests/test_stereo.py (STEREO with lines, 15
pairs; RGB-D, 12 frames):

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_stereo_system.py

With `--fed [n_pairs [carry_at,...]]` it runs both `System`s over the
replay on the port's features instead, printing their map counts,
inliers and frame-state gaps after every pair, and at each pair of
`carry_at` (107, 110, 111 by default: a one-frame pose gap, the IMU
initialization, frame 112's VI divergence guard) a second port `System`
started from the JAX System's state, at the IMU initialization also one
with the keyframe translations moved one float32 ulp
(`fed_comparison`, ~15 min).

As tests, at the reduced sizes of tests/test_torch_system.py (500 ORB
features, a store of 64 keyframes / 4096 points / 512 lines, its BA
caps), loop closing off:

(a) the port's right views and depth images equal the JAX package's
    renders from the same generator drawn in the same order (left, then
    right), as tests/test_torch_mh_inputs.py holds the replay;
(b) the port's `System` against the JAX package's `System` (built by
    tests/test_torch_system.py's `jax_system_with_database`, without its
    front end) over IMU_STEREO with lines (the first 12 pairs of
    tests/test_stereo_inertial.py's orbit), STEREO with lines (10 pairs
    of tests/test_stereo.py's) and RGB-D (10 frames, no lines): the port
    runs its public `track_stereo` / `track_rgbd`, and the JAX side
    tracks the features those computed on the port's CPU front end
    (recorded from `stereo_features` / `depth_at_features`, which the
    public methods call), running its own `match_stereo` /
    `match_stereo_lines` on them as its `track_stereo` does
    (models/system.py:180-228).  The
    depth bootstrap draws no RANSAC samples, so both sides start from
    their own bootstrap and no state is carried across.

Tolerances, and why: every frame's state, inliers, keyframes made and
the map's keyframe, point and line counts equal; poses within POSE_TOL
(1e-4) a pose entry, tests/test_torch_system.py's rule; the points and
lines each keyframe seeds from depth within 1e-5 relative (the same
float32 back-projection of the same depths; the keyframe pose they pass
through differs by the poses' float32 gap).
"""
import json
import sys
import time

import jax
import numpy as np
import pytest
import torch

from plvio_tpu.config import CameraConfig, ImuConfig, Sensor, SystemConfig
from plvio_tpu.io import synthetic as JSYN
from plvio_tpu.io import trajectory as JTIO
from plvio_tpu.models import tracking as JT
from plvio_tpu.models.system import System as JSystem
from plvio_tpu.utils import lie as JLIE

BASELINE = 0.11
STEREO_SECONDS = 8.0
STEREO_SEED = 7
IDENTITY_TBC = tuple(np.eye(4).reshape(-1).tolist())
ROOM_STEREO_PAIRS = 15
ROOM_RGBD_FRAMES = 12


def stereo_config(sensor=Sensor.IMU_STEREO, seed: int = 0, **kw):
    """The JAX package's `stereo_line_inertial_euroc3` configuration:
    rectified EuRoC K (no distortion), baseline 0.11 m, lines, the body
    frame the camera's, the system's defaults otherwise."""
    cam = dict(dist=(0.0, 0.0, 0.0, 0.0))
    if sensor != Sensor.RGBD:
        cam["baseline"] = BASELINE
    return SystemConfig(sensor=sensor, camera=CameraConfig(**cam),
                        imu=ImuConfig(Tbc=IDENTITY_TBC), seed=seed, **kw)


class _Shifted:
    """A trajectory evaluator whose camera sits `b` metres along its own x
    axis: the right eye of a rectified pair."""

    def __init__(self, ev, b):
        self.ev, self.b = ev, b

    def __call__(self, t):
        tr = self.ev(t)
        return JSYN.SyntheticTrajectory(
            tr.timestamps, tr.R_wb, tr.p_wb + tr.R_wb[:, :, 0] * self.b,
            tr.v_wb)


def jax_stereo_inputs(seconds: float = STEREO_SECONDS,
                      seed: int = STEREO_SEED, n_frames=None,
                      n_points: int = 9000, n_lines: int = 500):
    """The stereo replay with the JAX package's generators: the hall, the
    MH trajectory and IMU of tests/test_mh_replay_regression.py, then per
    frame the left view and the right view (the camera moved BASELINE
    along its x axis, every sub-exposure shifted alike), drawn from the
    one generator in that order."""
    rng = np.random.default_rng(seed)
    scene = JSYN.make_hall_scene(rng, n_points=n_points, n_lines=n_lines)
    traj = JSYN.make_mh_trajectory(seconds + 0.3, fps=20.0)
    imu = JSYN.synthesize_imu_mh(rng, seconds + 0.3)
    right = _Shifted(JSYN._eval_mh, BASELINE)
    n = len(traj.timestamps) if n_frames is None \
        else min(n_frames, len(traj.timestamps))
    left_f, right_f, batches, last_t = [], [], [], None
    for t in traj.timestamps[:n]:
        left_f.append(JSYN.render_frame_realistic(scene, JSYN._eval_mh, t,
                                                  rng))
        right_f.append(JSYN.render_frame_realistic(scene, right, t, rng))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            dts = np.diff(np.concatenate([[last_t], imu.timestamps[sel]]))
            batches.append((imu.gyro[sel], imu.acc[sel], dts))
        last_t = t
    return dict(frames=left_f, right=right_f,
                timestamps=traj.timestamps[:n], imu=batches,
                p_wc=traj.p_wb[:n], R_wc=traj.R_wb[:n])


def oracle_depth(scene, R, p, cam):
    """The depth image of tests/test_stereo.py:57-62: every visible scene
    point splatted as a 7x7 square of its depth."""
    depth = np.zeros((cam.height, cam.width), np.float32)
    uv, z, vis, _, _ = JSYN.project_scene(scene, R, p, cam.fx, cam.fy,
                                          cam.cx, cam.cy, cam.width,
                                          cam.height)
    for j in np.nonzero(vis)[0]:
        x0, y0 = int(uv[j, 0]), int(uv[j, 1])
        depth[max(0, y0 - 3):y0 + 4, max(0, x0 - 3):x0 + 4] = z[j]
    return depth


def jax_room_inputs(kind: str, n_frames: int, seed: int = 0):
    """tests/test_stereo.py's room orbits with the JAX package's
    generators: "stereo" (4000 points, 60 lines, left then right view a
    frame) or "rgbd" (4000 points, no lines, a view and its oracle depth
    image a frame)."""
    rng = np.random.default_rng(seed)
    scene = JSYN.make_room_scene(rng, n_points=4000,
                                 n_lines=60 if kind == "stereo" else 0)
    traj = JSYN.make_orbit_trajectory(duration=1.0, radius=0.6)
    cam = CameraConfig()
    frames, second = [], []
    for i in range(n_frames):
        R, p = traj.R_wb[i], traj.p_wb[i]
        frames.append(JSYN.render_frame(scene, R, p, rng=rng))
        if kind == "stereo":
            second.append(JSYN.render_frame(scene, R, p + R[:, 0] * BASELINE,
                                            rng=rng))
        else:
            second.append(oracle_depth(scene, R, p, cam))
    return dict(frames=frames, second=second,
                timestamps=traj.timestamps[:n_frames],
                p_wc=traj.p_wb[:n_frames], R_wc=traj.R_wb[:n_frames],
                traj=traj)


def _ate(js, S):
    """(Sim3, SE3) ATE of the system's trajectory against the truth."""
    q = np.asarray(JLIE.rot_to_quat(jax.numpy.asarray(S["R_wc"],
                                                      np.float32)))
    gt = JTIO.Trajectory(np.asarray(S["timestamps"]), np.asarray(S["p_wc"]),
                         q)
    est = js.trajectory()
    return JTIO.ate_rmse(est, gt, True), JTIO.ate_rmse(est, gt, False)


def reference_stereo(seed: int = 0, seconds: float = STEREO_SECONDS) -> dict:
    """The JAX `System` over the stereo replay with `cfg.seed` = seed."""
    S = jax_stereo_inputs(seconds)
    js = JSystem(stereo_config(seed=seed))
    jt = js.tracker
    n_tracked, n_kf_frames, imu_frame, t0 = 0, 0, -1, time.time()
    for i in range(len(S["frames"])):
        was = js.atlas.current.imu_initialized
        pose = js.track_stereo(S["frames"][i], S["right"][i],
                               float(S["timestamps"][i]), imu=S["imu"][i])
        n_tracked += pose is not None
        n_kf_frames += jt.last_kf_frame_idx == jt.frame_idx
        if js.atlas.current.imu_initialized and not was:
            imu_frame = i
        m = js.atlas.current
        print(f"  {i}: {jt.state.name} kf {m.n_kf} pts {m.n_pt} lines "
              f"{m.n_ln} ({time.time() - t0:.0f} s)", file=sys.stderr,
              flush=True)
    m = js.atlas.current
    out = {"n_frames": len(S["frames"]), "n_tracked": int(n_tracked),
           "imu_init_frame": imu_frame,
           "imu_initialized": bool(m.imu_initialized),
           "maps": len(js.atlas.maps), "final_state": int(jt.state),
           "keyframes": int(m.n_kf), "points": int(m.n_pt),
           "lines": int(m.n_ln)}
    js.global_refine()
    out["ate_sim3"], out["ate_se3"] = _ate(js, S)
    return out


def reference_room(kind: str) -> dict:
    """The JAX `System` over a room orbit: STEREO with lines over 15
    pairs, or RGB-D (no lines, as tests/test_stereo.py) over 12 frames."""
    n = ROOM_STEREO_PAIRS if kind == "stereo" else ROOM_RGBD_FRAMES
    S = jax_room_inputs(kind, n)
    if kind == "stereo":
        js = JSystem(stereo_config(Sensor.STEREO, use_loop_closing=False))
    else:
        js = JSystem(stereo_config(Sensor.RGBD, use_lines=False,
                                   use_loop_closing=False))
    n_ok = 0
    for i in range(n):
        fn = js.track_stereo if kind == "stereo" else js.track_rgbd
        n_ok += fn(S["frames"][i], S["second"][i],
                   float(S["timestamps"][i])) is not None
    m = js.atlas.current
    ate = _ate(js, S)
    return {"n_frames": n, "n_tracked": n_ok, "keyframes": int(m.n_kf),
            "points": int(m.n_pt), "lines": int(m.n_ln),
            "ate_sim3": ate[0], "ate_se3": ate[1],
            "final_state": int(js.tracker.state)}


def reference_five_seeds() -> dict:
    """REF_STEREO: each seed's run (one process each, all at once), the
    ranges of the counts, the worst SE3 ATE, and the room runs."""
    import os
    import subprocess
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, __file__, "--seed", str(k)],
                              stdout=subprocess.PIPE, env=env, text=True)
             for k in range(5)]
    runs = []
    for p in procs:
        out, _ = p.communicate()
        line = [x for x in out.splitlines() if x.startswith("STEREO_SEED = ")]
        runs.append(json.loads(line[-1][len("STEREO_SEED = "):]))
    ref = {"per_seed": runs}
    for k in ("n_tracked", "keyframes", "points", "lines"):
        ref[k + "_range"] = [min(r[k] for r in runs),
                             max(r[k] for r in runs)]
    ref["ate_se3_worst"] = max(r["ate_se3"] for r in runs)
    ref["maps_max"] = max(r["maps"] for r in runs)
    ref["room_stereo"] = reference_room("stereo")
    ref["room_rgbd"] = reference_room("rgbd")
    return ref


# --------------------------------------------------------------------------
# (a) the inputs
# --------------------------------------------------------------------------

def test_stereo_replay_views_equal():
    from plvio_tpu_torch.inputs import build_stereo_replay
    S = build_stereo_replay(1.0, n_points=500, n_lines=50, n_frames=3)
    J = jax_stereo_inputs(1.0, n_frames=3, n_points=500, n_lines=50)
    for k in ("frames", "right"):
        for a, b in zip(S[k], J[k]):
            assert a.dtype == np.float32 and a.shape == (480, 752)
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(S["p_wc"], J["p_wc"])


@pytest.mark.parametrize("kind", ["stereo", "rgbd"])
def test_room_views_and_depth_equal(kind):
    from plvio_tpu_torch.inputs import build_rgbd_room, build_stereo_room
    J = jax_room_inputs(kind, 3)
    if kind == "stereo":
        S = build_stereo_room(0, 3)
        second = S["right"]
    else:
        S = build_rgbd_room(0, 3)
        second = S["depth"]
    for a, b in zip(S["frames"], J["frames"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(second, J["second"]):
        assert a.dtype == np.float32 and a.shape == (480, 752)
        np.testing.assert_array_equal(a, b)
    if kind == "rgbd":
        assert (second[0] > 0).mean() > 0.01


# --------------------------------------------------------------------------
# (b) the System against the JAX System
# --------------------------------------------------------------------------

CASES = {"imu_stereo": (Sensor.IMU_STEREO, 12),
         "stereo": (Sensor.STEREO, 10),
         "rgbd": (Sensor.RGBD, 10)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(f, lf):
    """The port's Features / LineFeatures in the JAX package's layout."""
    from plvio_tpu.ops.frontend import Features as JFeatures
    from plvio_tpu.ops.lines import LineFeatures as JLineFeatures
    from plvio_tpu_torch.ops import matching as PM

    def pm1(d):
        return jax.numpy.asarray(PM.unpack_u32_to_pm1(d).numpy(),
                                 jax.numpy.bfloat16)

    def a(t):
        return jax.numpy.asarray(t.numpy())
    jf = JFeatures(uv=a(f.uv), uv_und=a(f.uv_und), response=a(f.response),
                   angle=a(f.angle), octave=a(f.octave), desc=pm1(f.desc),
                   valid=a(f.valid))
    if lf is None:
        return jf, None
    return jf, JLineFeatures(ep=a(lf.ep), angle=a(lf.angle),
                             length=a(lf.length), lineq=a(lf.lineq),
                             desc=pm1(lf.desc), valid=a(lf.valid))


def _capture_front_end(port):
    """Record what the port's public `track_stereo` / `track_rgbd` give
    the tracker, from the helpers both call: the last pair's raw features
    of both views (`stereo_features`), or the last frame's features and
    their depths (`depth_at_features`), as {name: (arguments, result)}."""
    got = {}
    for name in ("stereo_features", "depth_at_features"):
        def wrapped(*a, _fn=getattr(port, name), _name=name):
            out = _fn(*a)
            got[_name] = (a, out)
            return out
        setattr(port, name, wrapped)
    return got


def _jax_stereo_inputs(features, bf):
    """The JAX `track_stereo`'s tracker inputs (models/system.py:180-228)
    from the port's raw features of both views: the left view's features
    and segments in the JAX layout, the line equations recomputed, and the
    depths of JAX's own `match_stereo` / `match_stereo_lines`."""
    from plvio_tpu.ops import lines as JLN
    from plvio_tpu.ops import stereo as JST
    f, f_r, lf, lf_r = features
    jf, jl = _layout(f, lf)
    jr, jlr = _layout(f_r, lf_r)
    _, d, h = JST.match_stereo(jf.uv, jf.desc, jf.octave, jf.valid, jr.uv,
                               jr.desc, jr.octave, jr.valid, bf)
    ds, de, lh = JST.match_stereo_lines(jl.ep, jl.desc, jl.angle, jl.valid,
                                        jlr.ep, jlr.desc, jlr.angle,
                                        jlr.valid, bf)
    return (jf, jl._replace(lineq=JLN.line_equation(jl.ep)),
            np.where(np.asarray(h), np.asarray(d), -1.0),
            (np.asarray(ds), np.asarray(de), np.asarray(lh)))


def _jax_track(js, jf, jl, t, imu, depth, line_depth):
    """`System.track_stereo` / `track_rgbd` of the JAX package past their
    front ends (models/system.py:180-256)."""
    with js.map_lock:
        pose = js.tracker.process_frame(jf, t, imu=imu, line_feats=jl,
                                        depth=depth, line_depth=line_depth)
    js._drain_keyframes()
    with js.map_lock:
        js._apply_pending_transform()
    return pose


def _seeding_recorder(tracker, log):
    """Record the points and lines the tracker seeds from depth (its
    bootstrap and each keyframe): the new slots and their coordinates."""
    for name in ("_initialize_with_depth", "_create_keyframe"):
        fn = getattr(tracker, name)

        def wrapped(*a, _fn=fn, **kw):
            m = tracker.map
            pv, lv = m.pt_valid.copy(), m.ln_valid.copy()
            out = _fn(*a, **kw)
            m = tracker.map
            pts = np.nonzero(m.pt_valid & ~pv)[0]
            lns = np.nonzero(m.ln_valid & ~lv)[0]
            log.append((pts, m.pt_xyz[pts].copy(), lns, m.ln_ep[lns].copy()))
            return out
        setattr(tracker, name, wrapped)


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Both systems over the case's frames on the same features."""
    from plvio_tpu_torch.config import MapConfig as PMap
    from plvio_tpu_torch.config import OrbConfig as POrb
    from plvio_tpu_torch.entry import stereo_config as port_config
    from plvio_tpu_torch.inputs import build_rgbd_room, build_stereo_room
    from plvio_tpu_torch.models.system import System
    from plvio_tpu.config import MapConfig, OrbConfig
    from test_torch_system import (CAPS, MAP, N_FEATURES, VIBA, _record,
                                   jax_system_with_database)
    kind = request.param
    sensor, n = CASES[kind]
    no_lines = {"use_lines": False} if kind == "rgbd" else {}
    port = System(port_config(sensor, orb=POrb(n_features=N_FEATURES),
                              map=PMap(**MAP), use_loop_closing=False,
                              **no_lines),
                  device="cpu", caps=CAPS, viba_caps=VIBA)
    js = jax_system_with_database(stereo_config(
        sensor, orb=OrbConfig(n_features=N_FEATURES), map=MapConfig(**MAP),
        use_loop_closing=False, **no_lines))
    assert js.n_feat == port.n_feat
    if kind == "rgbd":
        S = build_rgbd_room(0, n)
    else:
        S = build_stereo_room(0, n, imu=kind == "imu_stereo")
    bf = port.cfg.camera.baseline * port.cfg.camera.fx
    made_p, seeds_j, seeds_p = [], [], []
    process = port.mapper.process_keyframe

    def recording(kf, protect=()):
        made_p.append(int(kf))
        return process(kf, protect=protect)
    port.mapper.process_keyframe = recording
    _seeding_recorder(js.tracker, seeds_j)
    _seeding_recorder(port.tracker, seeds_p)
    got = _capture_front_end(port)
    recs = []
    for i in range(n):
        t, imu = float(S["timestamps"][i]), S["imu"][i]
        del made_p[:]
        got.clear()
        with torch.no_grad():
            if kind == "rgbd":
                port.track_rgbd(S["frames"][i], S["depth"][i], t, imu)
                (f, _), depth = got["depth_at_features"]
                jf, jl = _layout(f, None)
                line_depth = None
            else:
                port.track_stereo(S["frames"][i], S["right"][i], t, imu)
                jf, jl, depth, line_depth = _jax_stereo_inputs(
                    got["stereo_features"][1], bf)
        prec = _record(port.tracker, made_p)
        n0 = len(js.processed)
        _jax_track(js, jf, jl, t, imu, depth, line_depth)
        recs.append((i, _record(js.tracker, js.processed[n0:]), prec))
    return dict(kind=kind, recs=recs, js=js, port=port, seeds=(seeds_j,
                                                               seeds_p))


def test_system_tracks_every_frame_as_reference(run):
    """Every frame's state, inliers, keyframes made and map counts equal,
    the pose within POSE_TOL; the depth bootstrap on the first frame."""
    from test_torch_system import POSE_TOL
    recs = run["recs"]
    assert recs[0][1]["state"] == int(JT.TrackState.OK)
    worst = 0.0
    for i, j, p in recs:
        assert j["state"] == int(JT.TrackState.OK), i
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (run["kind"], i, k, p[k], j[k])
        d = float(np.abs(p["pose"] - j["pose"]).max())
        worst = max(worst, d)
        assert d <= POSE_TOL, (run["kind"], i, d)
    print(f"{run['kind']}: largest pose difference {worst:.2e}")
    assert sum(len(p["made"]) for _, _, p in recs) >= 2
    m = run["port"].atlas.current
    assert m.n_pt > 500
    if run["kind"] != "rgbd":
        assert run["port"].tracker.pl_stereo


def test_depth_seeded_landmarks_as_reference(run):
    """The points and lines seeded from depth at the bootstrap and at each
    keyframe: the same slots, coordinates within 1e-5 relative."""
    seeds_j, seeds_p = run["seeds"]
    assert len(seeds_j) == len(seeds_p) >= 2
    n_pts = 0
    for (pj, xj, lj, ej), (pp, xp, lp, ep) in zip(seeds_j, seeds_p):
        np.testing.assert_array_equal(pp, pj)
        np.testing.assert_array_equal(lp, lj)
        n_pts += len(pp)
        for a, b in ((xp, xj), (ep, ej)):
            if len(b):
                gap = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
                assert gap <= 1e-5, (run["kind"], gap)
    assert n_pts >= 300
    if run["kind"] != "rgbd":
        assert sum(len(lp) for _, _, lp, _ in seeds_p) >= 1


def _carry(port, js, last):
    """Put the JAX `System`'s map, mapper, tracker, database and loop
    closer into the port's, with `last` (the port's last Features and
    LineFeatures, the same the JAX tracker saw) as the last frame's."""
    from plvio_tpu_torch.state import (kfdb_state, load_kfdb_state,
                                       load_loop_closer_state,
                                       load_mapper_state, load_tracker_state,
                                       loop_closer_state, mapper_state,
                                       mapstore_from_numpy,
                                       mapstore_to_numpy, tracker_state)
    port.atlas.maps[0] = mapstore_from_numpy(
        mapstore_to_numpy(js.atlas.current))
    load_mapper_state(port.mapper, mapper_state(js.mapper))
    load_tracker_state(port.tracker, tracker_state(js.tracker))
    load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
    load_loop_closer_state(port.loop_closer,
                           loop_closer_state(js.loop_closer))
    port.tracker.last_feats, port.tracker.last_line_feats = last


def _bound(tracker) -> int:
    """The last frame's features bound to a map point: its inliers."""
    f = tracker.last_feat_pt
    return 0 if f is None else int((np.asarray(f) >= 0).sum())


def _state_gaps(jt, pt):
    """The largest differences of the two trackers' frame states: pose,
    velocity, gyro and accelerometer biases."""
    from plvio_tpu_torch.state import tracker_state
    a, b = tracker_state(jt), tracker_state(pt)
    return {k: (None if a[k] is None or b[k] is None
                else float(np.abs(a[k] - b[k]).max()))
            for k in ("last_pose_cw", "frame_vel", "frame_bg", "frame_ba")}


def fed_comparison(n_frames=None, carry_at=(107, 110, 111),
                   perturb_at: int = 110):
    """The port's `System` and the JAX `System` (IMU_STEREO with lines,
    production's sizes) over the stereo replay on the same features: the
    port's CPU front end's (through its public `track_stereo`), the JAX
    side matching them with its own `match_stereo` /
    `match_stereo_lines`.  Prints both maps' (keyframes, points, lines)
    and the largest gaps of the trackers' frame states after every pair,
    then the port's ATE after `global_refine`.

    At each pair of `carry_at` a second port `System` starts from the
    JAX System's state after the pair before (map, mapper, tracker,
    database, loop closer) and tracks that pair: its counts and frame
    state against JAX's show whether a departure there comes from the
    state each side carries into the pair or from the pair's own
    computation (ROADMAP Queue 3).  At `perturb_at` a third starts from
    the same state with every keyframe's translation moved one float32
    ulp: how far that moves the pair's result measures the float32
    sensitivity of the pair's work."""
    from plvio_tpu_torch.entry import stereo_config as port_config
    from plvio_tpu_torch.entry import tracked_errors
    from plvio_tpu_torch.inputs import build_stereo_replay
    from plvio_tpu_torch.models.system import System
    torch.set_num_threads(4)
    S = build_stereo_replay(n_frames=n_frames)
    port = System(port_config(), device="cpu")
    js = JSystem(stereo_config())
    bf = port.cfg.camera.baseline * port.cfg.camera.fx
    got = _capture_front_end(port)
    for i in range(len(S["frames"])):
        t, imu = float(S["timestamps"][i]), S["imu"][i]
        carried = []
        if i in carry_at:
            for ulp in (False, True) if i == perturb_at else (False,):
                c = System(port_config(), device="cpu")
                _carry(c, js, (port.tracker.last_feats,
                               port.tracker.last_line_feats))
                if ulp:
                    # every keyframe's translation one float32 ulp up
                    m = c.atlas.current
                    for T in (m.kf_pose_cw, m.kf_pose_wb):
                        T[:, :, 3] = np.nextafter(T[:, :, 3],
                                                  np.float32(np.inf))
                carried.append((ulp, c))
        with torch.no_grad():
            port.track_stereo(S["frames"][i], S["right"][i], t, imu)
        jf, jl, depth, line_depth = _jax_stereo_inputs(
            got["stereo_features"][1], bf)
        _jax_track(js, jf, jl, t, imu, depth, line_depth)
        mj, mp = js.atlas.current, port.atlas.current
        print(f"{i} jax {(mj.n_kf, mj.n_pt, mj.n_ln)} port "
              f"{(mp.n_kf, mp.n_pt, mp.n_ln)} inliers "
              f"{(_bound(js.tracker), _bound(port.tracker))} (the port's "
              f"pose solve: {port.tracker.last_n_inliers}) gaps "
              f"{_state_gaps(js.tracker, port.tracker)}", flush=True)
        for ulp, c in carried:
            with torch.no_grad():
                c.track_stereo(S["frames"][i], S["right"][i], t, imu)
            mc = c.atlas.current
            print(f"{i} carried from JAX's state"
                  f"{', keyframe translations one ulp up' if ulp else ''}: "
                  f"{(mc.n_kf, mc.n_pt, mc.n_ln)}, inliers "
                  f"{_bound(c.tracker)} (JAX {_bound(js.tracker)}), "
                  f"gaps to JAX {_state_gaps(js.tracker, c.tracker)}"
                  + (f", to the unmoved carry "
                     f"{_state_gaps(carried[0][1].tracker, c.tracker)}"
                     if ulp else ""), flush=True)
        del carried
    port.global_refine()
    print(f"port ATE (Sim3, SE3) {tracked_errors(port.tracker, S)[0]}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed"]:
        print("STEREO_SEED = " + json.dumps(reference_stereo(
            int(sys.argv[2]))))
    elif sys.argv[1:2] == ["--fed"]:
        fed_comparison(*([int(sys.argv[2])] if sys.argv[2:] else [])
                         + ([tuple(int(a) for a in sys.argv[3].split(","))]
                            if sys.argv[3:] else []))
    elif sys.argv[1:2] == ["--room"]:
        print("ROOM = " + json.dumps(reference_room(sys.argv[2])))
    else:
        print("REF_STEREO = " + json.dumps(reference_five_seeds()))
