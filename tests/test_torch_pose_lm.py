"""Slice 12, path A: the point-only pose LM of STEREO / RGB-D without
lines (`make_pose_optimizer_stereo`, csrc/pose_lm.cu's stereo mode) and
`System` on that path, against the JAX package on the CPU.

Run as a script, it prints REF_STEREO_PTS for chip_smoke.py: the JAX
`System` over tests/test_stereo.py's room orbits without lines, loop
closing off: STEREO (baseline 0.11 m, 15 pairs) and RGB-D with ORB-SLAM3's
`Camera.bf` 40.0 (baseline 40 / fx, 12 frames):

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_pose_lm.py

As tests (torch on one thread):

(a) the plain stereo LM (`stereo_pose_lm_plain` on the port's engine)
    against JAX's `make_pose_optimizer_stereo` on
    tests/test_stereo.py:124-160's inputs, and with 20% of the rows made
    outliers: both held to a float64 run of the plain version, within 2x
    JAX's distance + 1e-6 a pose entry; the inlier masks equal but for
    rows whose chi2 lies within 1% of its gate (7.815 stereo, 5.991
    mono).  LM near its optimum accepts or refuses a step by rounding, so
    the float32 runs are held to float64, not to each other;
(b) `System` (STEREO with the 0.11 m baseline, and RGB-D with bf 40,
    neither with lines) through the public `track_stereo` / `track_rgbd`,
    at the reduced sizes of tests/test_torch_system.py, against the JAX
    `System` fed the features the port computed, over the first frames
    through the first keyframe step: states, inliers, keyframes made and
    map counts equal, poses within 1e-4 a pose entry;
(c) `slow`: the whole rooms on the CPU at production's sizes
    (`entry.stereo_room(15, use_lines=False)`, `entry.rgbd_room(12,
    bf=40.0)`) against REF_STEREO_PTS: frames tracked and keyframes
    equal (the depth bootstrap draws no RANSAC samples), points within
    1%, SE3 ATE within 2x the JAX run's.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.config import CameraConfig, Sensor, SystemConfig
from plvio_tpu.models.system import System as JSystem

RGBD_BF = 40.0          # ORB-SLAM3 Examples/RGB-D/TUM1.yaml Camera.bf
FX = CameraConfig().fx


def rgbd_camera(bf: float = RGBD_BF) -> CameraConfig:
    """The rectified EuRoC camera with baseline bf / fx (RGB-D's virtual
    right eye, as ORB-SLAM3's settings give it)."""
    return CameraConfig(dist=(0.0, 0.0, 0.0, 0.0), baseline=bf / FX)


def reference_room_points(kind: str) -> dict:
    """The JAX `System` over a room orbit without lines: STEREO (15 pairs)
    or RGB-D with bf 40 (12 frames), loop closing off."""
    from test_torch_stereo_system import (ROOM_RGBD_FRAMES,
                                          ROOM_STEREO_PAIRS, _ate,
                                          jax_room_inputs, stereo_config)
    n = ROOM_STEREO_PAIRS if kind == "stereo" else ROOM_RGBD_FRAMES
    S = jax_room_inputs(kind, n)
    if kind == "stereo":
        js = JSystem(stereo_config(Sensor.STEREO, use_lines=False,
                                   use_loop_closing=False))
    else:
        js = JSystem(SystemConfig(sensor=Sensor.RGBD, camera=rgbd_camera(),
                                  use_lines=False, use_loop_closing=False))
    n_ok = 0
    for i in range(n):
        fn = js.track_stereo if kind == "stereo" else js.track_rgbd
        n_ok += fn(S["frames"][i], S["second"][i],
                   float(S["timestamps"][i])) is not None
    m = js.atlas.current
    ate = _ate(js, S)
    return {"n_frames": n, "n_tracked": n_ok, "keyframes": int(m.n_kf),
            "points": int(m.n_pt), "ate_sim3": ate[0], "ate_se3": ate[1],
            "final_state": int(js.tracker.state)}


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

from plvio_tpu.models import kernels as JKN  # noqa: E402
from plvio_tpu.models import tracking as JT  # noqa: E402
from plvio_tpu.solver.residuals import PinholeK as JPin  # noqa: E402
from plvio_tpu.utils import lie as JL  # noqa: E402
from plvio_tpu_torch.models import kernels as KN  # noqa: E402
from plvio_tpu_torch.solver.residuals import PinholeK  # noqa: E402

STEREO_K = (458.0, 457.0, 376.0, 240.0)
STEREO_BF = 0.11 * 458.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stereo_case(outliers: bool):
    """tests/test_stereo.py:124-160's case (default_rng(0)): 256 points
    4-10 m ahead, the pose 2 deg / 0.3 m from the identity, exact (u, v,
    u_R), every third row mono; with outliers, 20% of the rows moved up to
    30 px (u_R with u)."""
    rng = np.random.default_rng(0)
    cap = 256
    X = rng.uniform([-3, -2, 4], [3, 2, 10], (cap, 3)).astype(np.float32)
    R = np.asarray(JL.so3_exp(jnp.asarray(np.array([0.02, -0.03, 0.01],
                                                   np.float32))))
    t = np.array([0.1, -0.05, 0.3], np.float32)
    fx, fy, cx, cy = STEREO_K
    pc = X @ R.T + t
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fy * pc[:, 1] / pc[:, 2] + cy], -1)
    ur = uv[:, 0] - STEREO_BF / pc[:, 2]
    uvr = np.concatenate([uv, ur[:, None]], 1).astype(np.float32)
    uvr[::3, 2] = -1.0
    if outliers:
        shift = np.random.default_rng(11).uniform(-30, 30, (cap // 5, 2))
        uvr[: cap // 5, :2] += shift
        has = uvr[: cap // 5, 2] > 0
        uvr[: cap // 5, 2] += np.where(has, shift[:, 0], 0.0)
    return (np.eye(3, 4, dtype=np.float32), uvr, X, np.ones(cap, bool),
            np.ones(cap, np.float32), R, t)


@pytest.fixture(scope="module")
def jax_stereo_lm():
    return JKN.make_pose_optimizer_stereo(JPin(*STEREO_K), STEREO_BF, 256)


@pytest.mark.parametrize("outliers", [False, True])
def test_stereo_pose_lm_matches_reference(jax_stereo_lm, outliers):
    """(a)"""
    pose0, uvr, X, valid, is2, R, t = _stereo_case(outliers)
    jp, ji, jn = jax_stereo_lm(
        *[jnp.asarray(a) for a in (pose0, uvr, X, valid, is2)])
    K = PinholeK(*STEREO_K)
    tt = [torch.from_numpy(a) for a in (pose0, uvr, X, valid, is2)]
    pp, pi, pn = KN.make_pose_optimizer_stereo(K, STEREO_BF, plain=True)(*tt)
    p64, _, _ = KN.stereo_pose_lm_plain(
        K, STEREO_BF, *[a.double() if a.is_floating_point() else a
                        for a in tt])
    p64 = p64.numpy()
    dj = np.abs(np.asarray(jp) - p64).max()
    dp = np.abs(pp.numpy() - p64).max()
    print(f"stereo pose LM outliers={outliers}: port {dp:.2e}, JAX {dj:.2e} "
          f"from float64; inliers {int(pn)} / {int(jn)}")
    assert dp <= 2 * dj + 1e-6
    # the rows' chi2 at the float64 pose, against their gates
    pc = X.astype(np.float64) @ p64[:, :3].T + p64[:, 3]
    z = np.maximum(pc[:, 2], 1e-4)
    fx, fy, cx, cy = STEREO_K
    u, v = fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy
    has = uvr[:, 2] > 0
    r2 = (u - uvr[:, 0]) ** 2 + (v - uvr[:, 1]) ** 2 \
        + np.where(has, (u - STEREO_BF / z - uvr[:, 2]) ** 2, 0.0)
    gate = np.where(has, 7.815, 5.991)
    near = np.abs(r2 * is2 - gate) < 0.01 * gate
    assert not ((np.asarray(ji) != pi.numpy()) & ~near).any()
    if not outliers:
        err_R = np.linalg.norm(np.asarray(JL.so3_log(jnp.asarray(
            pp.numpy()[:, :3] @ R.T))))
        assert int(pn) > 200 and err_R < 1e-3
        assert np.linalg.norm(pp.numpy()[:, 3] - t) < 2e-3


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def run(request):
    """Both systems (reduced sizes, no lines, loop closing off) over the
    room's first frames, on the features the port's public `track_stereo`
    / `track_rgbd` computed, until the first keyframe step after the depth
    bootstrap."""
    from plvio_tpu.config import MapConfig, OrbConfig
    from plvio_tpu_torch.config import CameraConfig as PCam
    from plvio_tpu_torch.config import MapConfig as PMap
    from plvio_tpu_torch.config import OrbConfig as POrb
    from plvio_tpu_torch.config import Sensor as PSensor
    from plvio_tpu_torch.config import SystemConfig as PCfg
    from plvio_tpu_torch.inputs import build_rgbd_room, build_stereo_room
    from plvio_tpu_torch.models.system import System
    from plvio_tpu.ops import stereo as JST
    from test_torch_stereo_system import (_capture_front_end, _jax_track,
                                          _layout, stereo_config)
    from test_torch_system import (CAPS, MAP, N_FEATURES, VIBA, _record,
                                   jax_system_with_database)
    kind = request.param
    if kind == "stereo":
        pcam = PCam(dist=(0.0,) * 4, baseline=0.11)
        jcfg = stereo_config(Sensor.STEREO, use_lines=False,
                             use_loop_closing=False,
                             orb=OrbConfig(n_features=N_FEATURES),
                             map=MapConfig(**MAP))
        sensor = PSensor.STEREO
        S = build_stereo_room(0, 8)
    else:
        pcam = PCam(dist=(0.0,) * 4, baseline=RGBD_BF / FX)
        jcfg = SystemConfig(sensor=Sensor.RGBD, camera=rgbd_camera(),
                            use_lines=False, use_loop_closing=False,
                            orb=OrbConfig(n_features=N_FEATURES),
                            map=MapConfig(**MAP))
        sensor = PSensor.RGBD
        S = build_rgbd_room(0, 8, bf=RGBD_BF)
    port = System(PCfg(sensor=sensor, camera=pcam, use_lines=False,
                       use_loop_closing=False,
                       orb=POrb(n_features=N_FEATURES), map=PMap(**MAP)),
                  device="cpu", caps=CAPS, viba_caps=VIBA)
    js = jax_system_with_database(jcfg)
    assert port.tracker.pose_opt_stereo is not None
    assert js.tracker.pose_opt_stereo is not None
    bf = port.cfg.camera.baseline * port.cfg.camera.fx
    made_p = []
    process = port.mapper.process_keyframe

    def recording(kf, protect=()):
        made_p.append(int(kf))
        return process(kf, protect=protect)
    port.mapper.process_keyframe = recording
    got = _capture_front_end(port)
    calls = {"n": 0}
    opt = port.tracker.pose_opt_stereo

    def counting(*a):
        calls["n"] += 1
        return opt(*a)
    port.tracker.pose_opt_stereo = counting
    recs = []
    for i in range(len(S["frames"])):
        t = float(S["timestamps"][i])
        del made_p[:]
        got.clear()
        with torch.no_grad():
            if kind == "rgbd":
                port.track_rgbd(S["frames"][i], S["depth"][i], t)
                (f, _), depth = got["depth_at_features"]
                jf, _ = _layout(f, None)
                jl, line_depth = None, None
            else:
                port.track_stereo(S["frames"][i], S["right"][i], t)
                # JAX's own stereo match on the port's features of both
                # views (models/system.py:180-228, no segments)
                f, f_r = got["stereo_features"][1][:2]
                jf, _ = _layout(f, None)
                jr, _ = _layout(f_r, None)
                _, d, h = JST.match_stereo(
                    jf.uv, jf.desc, jf.octave, jf.valid, jr.uv, jr.desc,
                    jr.octave, jr.valid, bf)
                depth = np.where(np.asarray(h), np.asarray(d), -1.0)
                jl, line_depth = None, None
        prec = _record(port.tracker, made_p)
        n0 = len(js.processed)
        _jax_track(js, jf, jl, t, None, depth, line_depth)
        jrec = _record(js.tracker, js.processed[n0:])
        recs.append((i, jrec, prec))
        if i > 0 and jrec["made"]:
            break
    return dict(kind=kind, recs=recs, port=port, calls=calls["n"])


def test_system_point_stereo_tracks_as_reference(run):
    """(b): every frame's state, inliers, keyframes made and map counts
    equal, the pose within 1e-4; the stereo pose LM ran on every frame
    past the bootstrap."""
    from test_torch_system import POSE_TOL
    recs = run["recs"]
    assert recs[-1][0] > 0 and recs[-1][1]["made"], "no keyframe step"
    worst = 0.0
    for i, j, p in recs:
        assert j["state"] == int(JT.TrackState.OK), i
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (run["kind"], i, k, p[k], j[k])
        d = float(np.abs(p["pose"] - j["pose"]).max())
        worst = max(worst, d)
        assert d <= POSE_TOL, (run["kind"], i, d)
    assert run["calls"] == len(recs) - 1
    print(f"{run['kind']} without lines: frames 0..{recs[-1][0]}, largest "
          f"pose difference {worst:.2e}")


# the JAX System's runs of the whole rooms (this file as a script)
REF_STEREO_PTS = {"stereo": {"n_tracked": 15, "keyframes": 3,
                             "points": 1205,
                             "ate_se3": 0.005761990550406985},
                  "rgbd": {"n_tracked": 12, "keyframes": 3, "points": 1373,
                           "ate_se3": 0.003510777120423907}}


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["stereo", "rgbd"])
def test_room_without_lines_as_reference(kind):
    """(c)"""
    from plvio_tpu_torch.entry import rgbd_room, stereo_room
    if kind == "stereo":
        step, S = stereo_room(15, device="cpu", use_lines=False)
    else:
        step, S = rgbd_room(12, device="cpu", bf=RGBD_BF)
    with torch.no_grad():
        out = step(S)
    ref = REF_STEREO_PTS[kind]
    print(f"{kind} room without lines: tracked {out.n_tracked}, keyframes "
          f"{out.keyframes}, points {out.points}, SE3 ATE {out.ate_se3:.5f} "
          f"(JAX {ref})")
    assert out.n_tracked == ref["n_tracked"]
    assert out.keyframes == ref["keyframes"]
    assert abs(out.points - ref["points"]) <= 0.01 * ref["points"]
    assert out.ate_se3 <= 2 * ref["ate_se3"]


if __name__ == "__main__":
    print("REF_STEREO_PTS = " + json.dumps(
        {"stereo": reference_room_points("stereo"),
         "rgbd": reference_room_points("rgbd")}))
