"""The port's localization mode (`System.activate_localization_mode`:
tracking only, against a frozen map) against the JAX package's `System`
on the CPU.

The scene and the assertions are tests/test_localization_mode.py's: the
room scene (4000 points, 60 lines) seen from the orbit of radius 0.6,
MONOCULAR without distortion; a map built over 20 frames, 10 frames
localized in it, then SLAM resumed on the last frame fed again three
times. Both systems track the port's features of each frame (its front
end makes them once), at tests/test_torch_system.py's reduced sizes (500
ORB features, a store of 64 keyframes / 4096 points / 512 lines, BA
windows of 16 KF x 1024 points x 2048 observations), synchronous
mapping, loop closing off (the localized frames never reach the mapper,
and the 20-frame map holds no loop). The port starts from the JAX run's
state after its bootstrap (map, mapper, tracker and the keyframe
database's banks), as tests/test_torch_system.py does: the two
bootstraps' float32 homography refits leave maps ~1e-3 apart.

Checked, as the reference test does, on the port: while localizing, no
keyframe and no landmark is added, at most 2 of the 10 frames are lost,
and after `deactivate_localization_mode` the tracker maps again
(`only_tracking` False). Against the JAX run: every frame's tracking
state, inliers, the keyframes made and the map's counts equal, and the
pose within 1e-4 a pose entry (the tracker's rule,
tests/test_torch_tracked_sequence.py).
"""
import numpy as np
import pytest
import torch

from plvio_tpu.models import tracking as JT
from plvio_tpu.ops import twoview as JTV
from test_torch_system import (CAPS, MAP, N_FEATURES, POSE_TOL, VIBA,
                               _record, jax_layout, jax_system_with_database,
                               jax_track, jit_reconstruction)

N_BUILD, N_LOC, N_RESUME = 20, 10, 3


def _configs():
    """The port's and the JAX package's SystemConfig of the reference
    test at the file's reduced sizes."""
    from plvio_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                  SystemConfig)
    from plvio_tpu_torch import config as PC
    kw = dict(use_loop_closing=False)
    port = PC.SystemConfig(camera=PC.CameraConfig(dist=(0.0,) * 4),
                           orb=PC.OrbConfig(n_features=N_FEATURES),
                           map=PC.MapConfig(**MAP), **kw)
    jax_cfg = SystemConfig(camera=CameraConfig(dist=(0.0,) * 4),
                           orb=OrbConfig(n_features=N_FEATURES),
                           map=MapConfig(**MAP), **kw)
    return port, jax_cfg


def _frames():
    """tests/test_localization_mode.py's frames, rendered with the port's
    generators (the same draws from one generator as the reference's):
    (images, timestamps) of the 20 + 10 frames, then the last frame's
    image three times more at 50 ms steps."""
    from plvio_tpu_torch.io import synthetic as syn
    rng = np.random.default_rng(0)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=60)
    n = N_BUILD + N_LOC
    traj = syn.make_orbit_trajectory(duration=n / 20.0, fps=20.0,
                                     radius=0.6)
    imgs = [syn.render_frame(scene, traj.R_wb[i], traj.p_wb[i], rng=rng)
            for i in range(n)]
    ts = [float(t) for t in traj.timestamps[:n]]
    for i in range(N_RESUME):
        imgs.append(syn.render_frame(scene, traj.R_wb[n - 1], traj.p_wb[n - 1],
                                     rng=rng))
        ts.append(float(traj.timestamps[-1]) + 0.05 * (i + 1))
    return imgs, ts


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Both systems over the frames: JAX from the start, the port from
    the JAX run's state after the bootstrap; localization mode on both
    over frames 20..29, off from frame 30."""
    from plvio_tpu_torch.models.system import System, frame_prelude
    from plvio_tpu_torch.state import (kfdb_state, load_kfdb_state,
                                       load_mapper_state, load_tracker_state,
                                       mapper_state, mapstore_from_numpy,
                                       mapstore_to_numpy, tracker_state)
    pcfg, jcfg = _configs()
    imgs, ts = _frames()
    port = System(pcfg, device="cpu", caps=CAPS, viba_caps=VIBA)
    with torch.no_grad():
        feats = [frame_prelude(port.extract, port.extract_lines,
                               port.camera, torch.from_numpy(im))
                 for im in imgs]
    orig = jit_reconstruction()
    try:
        js = jax_system_with_database(jcfg)
        jt, pt = js.tracker, port.tracker
        made_p = []
        process = port.mapper.process_keyframe

        def recording(kf, protect=()):
            made_p.append(int(kf))
            return process(kf, protect=protect)
        port.mapper.process_keyframe = recording
        recs, start, poses, phases = [], -1, [], {}
        for i, (f, lf) in enumerate(feats):
            if i == N_BUILD:
                js.activate_localization_mode()
                port.activate_localization_mode()
            if i == N_BUILD + N_LOC:
                js.deactivate_localization_mode()
                port.deactivate_localization_mode()
            if i in (N_BUILD, N_BUILD + N_LOC):
                m = port.atlas.current
                phases[i] = (int(m.n_kf), int(m.n_pt), int(m.n_ln))
            if start < 0 and jt.state == JT.TrackState.OK:
                start = i
                port.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(port.mapper, mapper_state(js.mapper))
                load_tracker_state(pt, tracker_state(jt))
                load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
            n0 = len(js.processed)
            jf, jl = jax_layout(f, lf)
            jpose = jax_track(js, jf, jl, ts[i], None)
            jrec = _record(jt, js.processed[n0:])
            if start >= 0:
                del made_p[:]
                with torch.no_grad():
                    ppose = port.track_features(f, lf, ts[i], None)
                recs.append((i, jrec, _record(pt, made_p)))
                poses.append((i, jpose is not None, ppose is not None))
    finally:
        JTV.reconstruct_two_views = orig
    m = port.atlas.current
    phases["end"] = (int(m.n_kf), int(m.n_pt), int(m.n_ln))
    return dict(recs=recs, start=start, poses=poses, phases=phases,
                port=port, js=js)


def test_localization_freezes_the_map(run):
    """The reference test's assertions on the port: the map built over 20
    frames (>= 2 keyframes) gains no keyframe and no landmark while 10
    frames are localized in it, at most 2 of which are lost; then
    `deactivate_localization_mode` leaves the tracker mapping again."""
    assert 1 <= run["start"] < N_BUILD
    kf0, pt0, ln0 = run["phases"][N_BUILD]
    assert kf0 >= 2
    assert run["phases"][N_BUILD + N_LOC][:2] == (kf0, pt0), \
        "localization mode inserted keyframes or landmarks"
    loc = [p for i, _, p in run["poses"] if N_BUILD <= i < N_BUILD + N_LOC]
    assert len(loc) == N_LOC
    assert sum(loc) >= N_LOC - 2, f"only {sum(loc)}/{N_LOC} frames localized"
    print(f"map of {kf0} keyframes, {pt0} points, {ln0} lines; "
          f"{sum(loc)}/{N_LOC} frames localized; after resuming "
          f"{run['phases']['end']}")
    for i, _, p in run["recs"]:
        if N_BUILD <= i < N_BUILD + N_LOC:
            assert p["made"] == [] and p["counts"][:2] == (kf0, pt0), i
    assert run["port"].tracker.only_tracking is False


def test_localization_decisions_as_reference(run):
    """From the common start, through the build, the localized frames and
    the resumed ones: every frame's state, inliers, keyframes made, the
    map's counts and whether a pose came back equal to the JAX System's,
    the pose within POSE_TOL."""
    worst = 0.0
    for (i, j, p), (_, jp, pp) in zip(run["recs"], run["poses"]):
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (i, k, p[k], j[k])
        assert pp == jp, i
        if j["pose"] is not None:
            d = float(np.abs(p["pose"] - j["pose"]).max())
            worst = max(worst, d)
            assert d <= POSE_TOL, (i, d)
    assert run["js"].tracker.only_tracking is False
    print(f"largest pose difference {worst:.2e}")
