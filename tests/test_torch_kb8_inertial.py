"""Slice 13, path A: the KB8 fisheye with an IMU and with lines
(IMU_MONOCULAR, the fork's main configuration on a fisheye lens) against
the JAX package on the CPU.

Run as a script, it prints REF_KB8_VI for chip_smoke.py: the JAX
`System` over the fisheye MH replay (`inputs.build_kb8_vi_replay`'s
world, trajectory and IMU with the JAX package's generators, every frame
through `render_frame_kb8`), IMU_MONOCULAR, loop closing on, without and
with lines, `cfg.seed` 0..9 (`N_SEEDS`; with lines 0..19,
`N_SEEDS_LINES`), three processes at a time:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_kb8_inertial.py

As tests (torch on one thread), each against the JAX package on the same
inputs:

(a) `inputs.build_kb8_vi_replay`'s first frames and IMU batches equal to
    the JAX package's generators' (bit for bit; the gyro within 1e-6 rad/s,
    tests/test_torch_mh_inputs.py's GYRO_TOL);
(b) `make_point_reproj_body_ba_kb8` against the JAX residual (within 1e-4
    px: atan2 of XLA's CPU library and of torch's may differ by an ulp),
    and its analytic Jacobian (`point_reproj_body_ba_kb8_jac`, the
    kernels' formula) against `torch.func.jacrev` in float64 within 1e-9
    relative, a point on the optical axis (r -> 0) included;
(c) `make_local_inertial_ba` with the KB8K camera on
    `inputs.build_inertial_window(kb8=True)` at tests/test_torch_inertial_
    ba.py's small sizes (8 KF, 256 points / 512 observations, 32 lines /
    64), perturbed start: keyframe states and points within 2x JAX's
    distance to a float64 run of the port + 1e-4, the point inliers equal
    but for rows whose chi2 at the float64 result lies within 1% of
    5.991; with and without lines;
(d) `make_local_ba_pl` with the KB8K camera on
    `inputs.build_kb8_window(16, 256, 512, n_ln=64, n_lobs=128)`: poses,
    points and endpoints within 2x JAX's distance to a float64 run of the
    port + 1e-4, the inlier masks equal but for rows within 1% of the
    gate;
(e) the mapper of a KB8 camera with the IMU and lines (`_kb8_world`):
    `local_ba` (the KB8 + line BA) and `local_inertial_ba` (the body-frame
    KB8 window with the line family) against the JAX mapper on the same
    store, within 2x its distance to the port's mapper in float64 + 1e-4;
(f) `slow`: `System` with the KB8 camera and the IMU at production's
    sizes from the JAX run's state after its IMU initialization;
(g) `slow`: the whole fisheye replay with the JAX package's RANSAC draws
    of cfg.seed 3 (with and without lines) and 11 (with lines, the rare
    IMU init), against those JAX runs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

from plvio_tpu.config import CameraConfig, ImuConfig, Sensor, SystemConfig
from plvio_tpu.io import synthetic as JSYN
from plvio_tpu.models import kernels as JKN
from plvio_tpu.solver import residuals as JRES
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.utils import lie

KB8_K = (0.01, -0.005, 0.002, 0.0)
KB8_INTRINSICS = dict(fx=380.0, fy=380.0, cx=376.0, cy=240.0)
KB8_VI_SECONDS = 8.0
MH_SEED = 7


def kb8_vi_config(seed: int = 0, use_lines: bool = True, **kw):
    """`entry.kb8_vi_config`'s configuration in the JAX package."""
    return SystemConfig(
        sensor=Sensor.IMU_MONOCULAR,
        camera=CameraConfig(model="kb8", dist=KB8_K, **KB8_INTRINSICS),
        imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))),
        use_lines=use_lines, seed=seed, **kw)


def jax_kb8_vi_inputs(seconds: float = KB8_VI_SECONDS, seed: int = MH_SEED,
                      n_frames=None):
    """The fisheye MH replay with the JAX package's generators, drawn in
    `build_mh_replay`'s order: the hall, the trajectory, the IMU, then
    every frame through the KB8 renderer."""
    rng = np.random.default_rng(seed)
    scene = JSYN.make_hall_scene(rng, n_points=9000, n_lines=500)
    traj = JSYN.make_mh_trajectory(seconds + 0.3, fps=20.0)
    imu = JSYN.synthesize_imu_mh(rng, seconds + 0.3)
    n = len(traj.timestamps) if n_frames is None \
        else min(n_frames, len(traj.timestamps))
    frames, batches, last_t = [], [], None
    for i in range(n):
        t = traj.timestamps[i]
        frames.append(JSYN.render_frame_kb8(
            scene, traj.R_wb[i], traj.p_wb[i], k=KB8_K, rng=rng,
            **KB8_INTRINSICS).astype(np.float32))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            dts = np.diff(np.concatenate([[last_t], imu.timestamps[sel]]))
            batches.append((imu.gyro[sel], imu.acc[sel], dts))
        last_t = t
    return dict(frames=frames, timestamps=traj.timestamps[:n], imu=batches,
                p_wc=traj.p_wb[:n], R_wc=traj.R_wb[:n], traj=traj)


def _count_calls(obj, names, counts):
    """Wrap obj's callables `names` so that each call adds one to
    counts[name] (None attributes are left alone)."""
    for name in names:
        fn = getattr(obj, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(obj, name, wrapped)


def reference_replay(cfg, S, use_imu: bool) -> dict:
    """The JAX `System` (`cfg`) over the replay S: counts, the bootstrap
    and IMU-init frames, the window solves it ran, each frame tracked or
    not, and the (Sim3, SE3) ATE after `global_refine` as `entry.SystemRun`
    reports it."""
    from plvio_tpu.models import tracking as JT
    from plvio_tpu_torch.entry import tracked_errors
    from test_torch_system import _AsPort, jit_reconstruction, \
        recording_system
    orig = jit_reconstruction()
    try:
        js = recording_system(cfg)
        jt, mp = js.tracker, js.mapper
        calls = {}
        _count_calls(mp, ("local_ba_kernel", "local_ba_pl_kernel",
                          "local_ba_lines_kernel", "liba_kernel",
                          "_liba_window", "full_inertial_ba"), calls)
        init_frame = imu_frame = imu_kf = -1
        tracked, t0 = [], time.time()
        for i, img in enumerate(S["frames"]):
            was = js.atlas.current.imu_initialized
            before = jt.state
            pose = js.track_monocular(img, float(S["timestamps"][i]),
                                      imu=S["imu"][i] if use_imu else None)
            tracked.append(pose is not None)
            if init_frame < 0 and before in (JT.TrackState.NO_IMAGES_YET,
                                             JT.TrackState.NOT_INITIALIZED) \
                    and jt.state == JT.TrackState.OK:
                init_frame = i
            if js.atlas.current.imu_initialized and not was:
                imu_frame, imu_kf = i, len(js.processed)
            m = js.atlas.current
            print(f"  {i}: {jt.state.name} kf {m.n_kf} pts {m.n_pt} lines "
                  f"{m.n_ln} ({time.time() - t0:.0f} s)", file=sys.stderr,
                  flush=True)
        m = js.atlas.current
        out = {"n_frames": len(S["frames"]), "n_tracked": int(sum(tracked)),
               "init_frame": init_frame, "imu_init_frame": imu_frame,
               "imu_init_kf": imu_kf,
               "imu_initialized": bool(m.imu_initialized),
               "keyframes": int(m.n_kf), "points": int(m.n_pt),
               "lines": int(m.n_ln), "maps": len(js.atlas.maps),
               "final_state": int(jt.state), "calls": calls,
               "tracked": "".join("1" if t else "0" for t in tracked)}
        js.global_refine()
        ate, scale, _ = tracked_errors(_AsPort(jt), S)
        out.update(ate_sim3=ate[0], ate_se3=ate[1], scale=scale)
    finally:
        from plvio_tpu.ops import twoview as JTV
        JTV.reconstruct_two_views = orig
    return out


def reference_kb8_vi(seed: int, use_lines: bool,
                     seconds: float = KB8_VI_SECONDS) -> dict:
    """The JAX `System` over the fisheye MH replay with the IMU."""
    S = jax_kb8_vi_inputs(seconds)
    return reference_replay(kb8_vi_config(seed, use_lines), S, True)


# cfg.seeds of the references: five undersample the spread of the counts
# (JAX's cfg.seed 5 initializes the fisheye replay's IMU at frame 93, its
# cfg.seeds 0..4 at 113-129; under SLAM mode 1 its cfg.seed 9 tracks 105
# frames, its 0..4 119-161).  With lines the fisheye replay hinges on a
# rare event: the IMU initializes (at frame 67, then ~100 frames tracked)
# in one of JAX's cfg.seeds 0..19 (11) and none of 0..9
N_SEEDS = 10
N_SEEDS_LINES = 20


def seed_ranges(script: str, flag_args, tag: str, n_proc: int = 3,
                n_seeds: int = N_SEEDS) -> dict:
    """Each cfg.seed 0..n_seeds-1's run of `script --seed k *flag_args`
    (one process each, n_proc at a time), the ranges of the counts and
    the worst ATE."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    runs = [None] * n_seeds
    pending = list(range(n_seeds))
    while pending:
        batch, pending = pending[:n_proc], pending[n_proc:]
        procs = {k: subprocess.Popen(
            [sys.executable, script, "--seed", str(k), *flag_args],
            stdout=subprocess.PIPE, env=env, text=True) for k in batch}
        for k, p in procs.items():
            out, _ = p.communicate()
            line = [x for x in out.splitlines() if x.startswith(tag)]
            runs[k] = json.loads(line[-1][len(tag):])
    ref = {"per_seed": runs}
    for k in ("n_tracked", "keyframes", "points", "lines", "maps",
              "init_frame", "imu_init_frame", "imu_init_kf"):
        ref[k + "_range"] = [min(r[k] for r in runs),
                             max(r[k] for r in runs)]
    for k in ("ate_sim3", "ate_se3"):
        ref[k + "_worst"] = max(r[k] for r in runs)
    return ref


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

CHI2 = 5.991
SMALL = dict(n_pt=256, n_obs=512, n_ln=32, n_lobs=64, n_kf=8, n_observers=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k8():
    from plvio_tpu_torch.inputs import kb8_camera
    K8 = kb8_camera()
    return K8, JRES.KB8K(*K8)


def test_kb8_vi_replay_matches_reference():
    """(a)"""
    from plvio_tpu_torch.inputs import build_kb8_vi_replay
    P = build_kb8_vi_replay(n_frames=3)
    J = jax_kb8_vi_inputs(n_frames=3)
    for a, b in zip(P["frames"], J["frames"]):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    for a, b in zip(P["imu"][1:], J["imu"][1:]):
        # the gyro within tests/test_torch_mh_inputs.py's GYRO_TOL: its
        # body rates come from a numerical derivative of the rotation
        assert np.abs(a[0] - b[0]).max() <= 1e-6
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert np.array_equal(P["p_wc"], J["p_wc"])


def _body_kb8_case(seed=0, n=48):
    from plvio_tpu_torch.inputs import extrinsics
    rng = np.random.default_rng(seed)
    Rcb, tcb = (torch.from_numpy(a) for a in extrinsics())
    P = torch.cat([lie.so3_exp(torch.from_numpy(rng.normal(0, 0.3, (n, 3)))),
                   torch.from_numpy(rng.normal(0, 0.5, (n, 3, 1)))], -1)
    xc = torch.from_numpy(rng.uniform([-3, -2, 0.5], [3, 2, 6], (n, 3)))
    xc[0, :2] = 0.0                       # on the optical axis: r -> 0
    Xb = (xc - tcb) @ Rcb
    X = (P[..., :3] @ Xb[..., None])[..., 0] + P[..., 3]
    uv = torch.from_numpy(rng.uniform([0, 0], [752, 480], (n, 2)))
    return Rcb, tcb, P, X, uv


def test_body_kb8_residual_and_jacobian():
    """(b)"""
    K8, JK8 = _k8()
    Rcb, tcb, P, X, uv = _body_kb8_case()
    f32 = [t.float() for t in (Rcb, tcb, P, X, uv)]
    z6, z3 = torch.zeros(len(X), 6), torch.zeros(len(X), 3)
    rp = vmap(RES.make_point_reproj_body_ba_kb8(K8, f32[0], f32[1]))(
        (f32[2], f32[3]), (z6, z3), {"uv": f32[4]})
    a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    rj = jax.vmap(JRES.make_point_reproj_body_ba_kb8(JK8, a(f32[0]),
                                                     a(f32[1])))(
        (a(f32[2]), a(f32[3])), (a(z6), a(z3)), {"uv": a(f32[4])})
    assert float((rp - torch.from_numpy(np.asarray(rj))).abs().max()) \
        <= 1e-4
    assert RES.point_reproj_body_ba_for(K8, Rcb, tcb).__qualname__ \
        .startswith("make_point_reproj_body_ba_kb8")
    f = RES.make_point_reproj_body_ba_kb8(K8, Rcb, tcb)
    z6, z3 = torch.zeros(6, dtype=torch.float64), torch.zeros(
        3, dtype=torch.float64)
    ja = vmap(lambda p, x, u: jacrev(lambda d, dx: f((p, x), (d, dx),
                                                     {"uv": u}),
                                     argnums=(0, 1))(z6, z3))(P, X, uv)
    r, Jp, Jx = RES.point_reproj_body_ba_kb8_jac(K8, Rcb, tcb, P, X, uv)
    rr = vmap(lambda p, x, u: f((p, x), (z6, z3), {"uv": u}))(P, X, uv)
    assert float((r - rr).abs().max()) <= 1e-9
    for got, want in ((Jp, ja[0]), (Jx, ja[1])):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-9


def _f64(v):
    if isinstance(v, dict):
        return {k: _f64(x) for k, x in v.items()}
    return v.double() if v.is_floating_point() else v


def _jnp(v):
    if isinstance(v, dict):
        return {k: _jnp(x) for k, x in v.items()}
    return jnp.asarray(v.numpy())


def _gaps(oj, op, o64, idx):
    out = []
    for i in idx:
        a64 = o64[i].double().numpy()
        out.append((float(np.abs(np.asarray(oj[i], np.float64) - a64).max()),
                    float(np.abs(op[i].double().numpy() - a64).max())))
    return out


@pytest.mark.parametrize("lines", [False, True])
def test_kb8_inertial_ba_matches_reference(lines):
    """(c)"""
    from plvio_tpu_torch.inputs import build_inertial_window
    K8, JK8 = _k8()
    W = build_inertial_window(**SMALL, perturbed=True, device="cpu",
                              kb8=True)
    keys = KN.LIBA_KEYS if lines else KN.LIBA_KEYS[:18]
    kw = dict(n_ln=SMALL["n_ln"], n_lobs=SMALL["n_lobs"]) if lines else {}
    Rcb, tcb = W["Rcb"].numpy(), W["tcb"].numpy()
    oj = JKN.make_local_inertial_ba(JK8, SMALL["n_kf"], SMALL["n_pt"],
                                    SMALL["n_obs"], Rcb, tcb, 9.81, **kw)(
        *[_jnp(W[k]) for k in keys])
    run = KN.make_local_inertial_ba(K8, SMALL["n_kf"], SMALL["n_pt"],
                                    SMALL["n_obs"], Rcb, tcb, 9.81, **kw)
    op = run(*[W[k] for k in keys])
    o64 = run(*[_f64(W[k]) for k in keys])
    for (gj, gp), what in zip(_gaps(oj, op, o64, (0, 1, 2, 3, 4)),
                              ("pose", "vel", "bg", "ba", "points")):
        print(f"KB8 inertial window lines={lines} {what}: port {gp:.2e}, "
              f"JAX {gj:.2e} from float64")
        assert gp <= 2 * gj + 1e-4, what
    # the point rows' chi2 at the float64 result
    P64, X64 = o64[0], o64[4]
    r, _, _ = RES.point_reproj_body_ba_kb8_jac(
        K8, W["Rcb"].double(), W["tcb"].double(), P64[W["obs_kf"].long()],
        X64[W["obs_pt"].long()], W["obs_uv"].double())
    chi2 = ((r ** 2).sum(-1) * W["obs_is2"].double()).numpy()
    diff = op[5].numpy() != np.asarray(oj[5])
    assert not (diff & (np.abs(chi2 - CHI2) > 0.01 * CHI2)).any()
    assert not op[5].numpy().all()


def test_kb8_point_line_ba_matches_reference():
    """(d)"""
    from plvio_tpu_torch.inputs import build_kb8_window
    K8, JK8 = _k8()
    A = build_kb8_window(16, 256, 512, device="cpu", n_ln=64, n_lobs=128)
    args = list(A.values())
    oj = JKN.make_local_ba_pl(JK8, 16, 256, 512, 64, 128)(
        *[_jnp(a) for a in args])
    run = KN.make_local_ba_pl(K8)
    op = run(*args)
    o64 = run(*[_f64(a) for a in args])
    for (gj, gp), what in zip(_gaps(oj, op, o64, (0, 1, 2)),
                              ("poses", "points", "endpoints")):
        print(f"KB8 point+line window {what}: port {gp:.2e}, JAX {gj:.2e} "
              "from float64")
        assert gp <= 2 * gj + 1e-4, what
    assert np.array_equal(op[3].numpy(), np.asarray(oj[3]))
    assert np.array_equal(op[4].numpy(), np.asarray(oj[4]))


def _kb8_world():
    """tests/test_torch_tracker.py's map (the keyframe sequence's first 12
    keyframes, IMU initialized, points and confirmed lines bound) seen by a
    KB8 camera with the EuRoC pinhole's fx, fy, cx, cy and KB8_K: every
    bound feature's raw pixel the lens projection of its point at the
    keyframe's pose + N(0, 0.3) px (default_rng(3)); the line observations
    stay on the pinhole four, as the reference's line edge reads a KB8K.
    Returns (arrays, the KB8K, both configurations)."""
    from plvio_tpu_torch.config import CameraConfig as PCam
    from plvio_tpu_torch.entry import K_EUROC, mapper_config
    from plvio_tpu_torch.config import Sensor as PSensor
    from plvio_tpu_torch.inputs import (build_inertial_map,
                                        build_keyframe_sequence)
    from plvio_tpu_torch.io import synthetic as syn
    from plvio_tpu_torch.state import mapstore_to_numpy
    seq = build_keyframe_sequence(0, n_kf=16)
    a = mapstore_to_numpy(build_inertial_map(seq, 12))
    K8 = RES.KB8K(*K_EUROC, *KB8_K)
    rng = np.random.default_rng(3)
    raw = np.array(a["kf_feat_uv_raw"])
    for k in np.nonzero(a["kf_valid"])[0]:
        f = np.nonzero(a["kf_match_pt"][k] >= 0)[0]
        X = a["pt_xyz"][a["kf_match_pt"][k, f]].astype(np.float64)
        P = a["kf_pose_cw"][k].astype(np.float64)
        pc = X @ P[:, :3].T + P[:, 3]
        raw[k, f] = syn._kb8_project_cam_np(pc, *K_EUROC, KB8_K) \
            + rng.normal(0, 0.3, (len(f), 2))
    a["kf_feat_uv_raw"] = raw.astype(np.float32)
    cam = dict(model="kb8", fx=K_EUROC.fx, fy=K_EUROC.fy, cx=K_EUROC.cx,
               cy=K_EUROC.cy, dist=KB8_K)
    pcfg = dataclasses.replace(
        mapper_config(PSensor.IMU_MONOCULAR, K_EUROC, identity_tbc=True),
        camera=PCam(**cam))
    jcfg = SystemConfig(sensor=Sensor.IMU_MONOCULAR, use_lines=True,
                        camera=CameraConfig(**cam),
                        imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
    return a, K8, pcfg, jcfg


MAP_CAPS = dict(ba_kf_cap=16, ba_pt_cap=1024, ba_obs_cap=2048)


@pytest.mark.parametrize("which", ["local_ba", "local_inertial_ba"])
def test_kb8_mapper_windows_match_reference(which):
    """(e) the mapper of a KB8 camera with the IMU and lines
    (`_kb8_world`, caps 16 KF / 1024 points / 2048 observations):
    `local_ba` on the newest keyframe takes the KB8 + line BA
    (`make_local_ba_pl` with `ba_K`), `local_inertial_ba` the body-frame
    KB8 window with the line family, on both sides; keyframe states,
    points and endpoints within 2x the JAX mapper's distance to the port's
    mapper in float64 + 1e-4, the bindings after the chi2 erasure equal."""
    from test_torch_tracker import jax_store
    from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
    from plvio_tpu.models.mapstore import Atlas as JAtlas
    from plvio_tpu_torch.models.local_mapping import LocalMapper
    from plvio_tpu_torch.models.mapstore import Atlas
    from plvio_tpu_torch.state import mapstore_from_numpy, mapstore_to_numpy
    a, K8, pcfg, jcfg = _kb8_world()
    kf = int(np.nonzero(a["kf_valid"])[0].max())
    n_feat = int(a["n_feat"])
    from plvio_tpu.ops.imu import Preintegrated as JPre
    jm = jax_store(a)
    jm.kf_preint = {k: JPre(**{f: jnp.asarray(v) for f, v in d.items()})
                    for k, d in a["kf_preint"].items()}
    jl = JLocalMapper(jcfg, JAtlas([jm]), n_feat, **MAP_CAPS)
    getattr(jl, which)(kf)
    j = mapstore_to_numpy(jm)
    out = {}
    for dt in (torch.float32, torch.float64):
        m = mapstore_from_numpy(a)
        mp = LocalMapper(pcfg, Atlas([m]), n_feat, **MAP_CAPS, device="cpu",
                         dtype=dt)
        assert mp.ba_K == K8
        getattr(mp, which)(kf)
        if which == "local_ba":
            assert mp.ba_path == "pl"
        out[dt] = mapstore_to_numpy(m)
    p, p64 = out[torch.float32], out[torch.float64]
    for k in ("kf_match_pt", "pt_valid", "pt_n_obs", "kf_match_ln",
              "ln_valid"):
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    kv, pv, lv = p["kf_valid"], p["pt_valid"], p["ln_valid"]
    keys = [("kf_pose_cw", kv), ("pt_xyz", pv), ("ln_ep", lv)]
    if which == "local_inertial_ba":
        keys += [("kf_vel", kv), ("kf_bias_g", kv), ("kf_bias_a", kv)]
    for key, sel in keys:
        gj = float(np.abs(j[key][sel] - p64[key][sel]).max())
        gp = float(np.abs(p[key][sel] - p64[key][sel]).max())
        print(f"{which} {key}: port {gp:.2e}, JAX {gj:.2e} from the port in "
              "float64")
        assert gp <= 2 * gj + 1e-4, key


# the JAX run's IMU initialization comes at frame 128 (cfg.seed 0, the
# reference run above); the port starts from its state after it
KB8_SYSTEM_START, KB8_SYSTEM_FRAMES = 129, 14


@pytest.mark.slow
def test_kb8_vi_system_as_reference():
    """(f) `System` with the KB8 camera and the IMU (no lines) through the
    public `track_monocular` at production's sizes (loop closing off),
    against the JAX `System` fed the port's features: JAX from frame 0,
    the port from the JAX run's state at KB8_SYSTEM_START, after the IMU
    initialization, up to the frame whose keyframe step runs the first
    body-frame KB8 window; every frame's state, inliers, keyframes made
    and the map's counts equal, poses within 1e-4 before that frame.  The
    runs part there: the frame's pose follows the keyframes the window
    moved (its float32 rounding).  Slow: ~145 JAX frames and a few of the
    port at full size."""
    from test_torch_system import _record, jax_track, jit_reconstruction
    from plvio_tpu.models.system import System as JSystem
    from plvio_tpu.ops.frontend import Features as JFeatures
    from plvio_tpu_torch.entry import kb8_vi_replay
    from plvio_tpu_torch.ops import matching as PM
    from plvio_tpu_torch.state import (load_kfdb_state, load_mapper_state,
                                       load_tracker_state, mapper_state,
                                       mapstore_from_numpy,
                                       mapstore_to_numpy, kfdb_state,
                                       tracker_state)
    n = KB8_SYSTEM_START + KB8_SYSTEM_FRAMES
    run, S = kb8_vi_replay(device="cpu", use_lines=False,
                           use_loop_closing=False,
                           replay_kw=dict(n_frames=n))
    port = run.new_system()
    feats = []

    def capture(f, lf, *a, **kw):
        feats.append(f)
    port.track_features = capture
    with torch.no_grad():
        for i in range(n):
            port.track_monocular(S["frames"][i], float(S["timestamps"][i]),
                                 imu=S["imu"][i])
    del port.track_features

    def jf_of(f):
        def a(t):
            return jnp.asarray(t.numpy())
        return JFeatures(uv=a(f.uv), uv_und=a(f.uv_und),
                         response=a(f.response), angle=a(f.angle),
                         octave=a(f.octave), desc=jnp.asarray(
                             PM.unpack_u32_to_pm1(f.desc).numpy(),
                             jnp.bfloat16), valid=a(f.valid))
    js = JSystem(kb8_vi_config(0, False, use_loop_closing=False))
    js.processed = []
    process = js._process_kf

    def recording(kf):
        js.processed.append(int(kf))
        process(kf)
    js._process_kf = recording
    made_p = []
    mp_process = port.mapper.process_keyframe

    def port_recording(kf, protect=()):
        made_p.append(int(kf))
        return mp_process(kf, protect=protect)
    port.mapper.process_keyframe = port_recording
    calls = {"liba": 0}
    window = port.mapper._liba_window

    def counted(*a, **kw):
        calls["liba"] += 1
        return window(*a, **kw)
    port.mapper._liba_window = counted
    orig = jit_reconstruction()
    worst, last = 0.0, -1
    try:
        for i, f in enumerate(feats):
            t = float(S["timestamps"][i])
            if i == KB8_SYSTEM_START:
                assert js.atlas.current.imu_initialized
                port.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(port.mapper, mapper_state(js.mapper))
                load_tracker_state(port.tracker, tracker_state(js.tracker))
                load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
            n0 = len(js.processed)
            jax_track(js, jf_of(f), None, t, S["imu"][i])
            if i < KB8_SYSTEM_START:
                continue
            j = _record(js.tracker, js.processed[n0:])
            del made_p[:]
            with torch.no_grad():
                port.track_features(f, None, t, S["imu"][i])
            p = _record(port.tracker, made_p)
            for k in ("state", "made", "inliers", "counts"):
                assert p[k] == j[k], (i, k, p[k], j[k])
            if calls["liba"]:
                # the frame whose keyframe step ran the first body-frame
                # KB8 window: the frame's pose is brought to the keyframes
                # that window moved, which carry its float32 rounding, so
                # the runs part here (as the stereo replay's at its IMU
                # init)
                last = i
                break
            if j["pose"] is not None:
                d = float(np.abs(p["pose"] - j["pose"]).max())
                worst = max(worst, d)
                assert d <= 1e-4, (i, d)
    finally:
        from plvio_tpu.ops import twoview as JTV
        JTV.reconstruct_two_views = orig
    print(f"KB8 VI System: frames {KB8_SYSTEM_START}..{last}, body-frame "
          f"KB8 windows {calls['liba']}, largest pose difference {worst:.2e}")
    assert calls["liba"] > 0
    assert port.mapper.ba_K == port.tracker.kb8 is not None


# REF_KB8_VI's runs (the JAX System over the whole fisheye replay) with
# (lines, cfg.seed): frames tracked, bootstrap frame, IMU init frame,
# keyframes, points
REF_DRAWS = {(False, 3): (131, 35, 113, 37, 5127),
             (True, 3): (7, 35, -1, 5, 388),
             (True, 11): (105, 35, 67, 9, 626)}


@pytest.mark.slow
@pytest.mark.parametrize("lines,seed", sorted(REF_DRAWS))
def test_kb8_vi_replay_with_reference_draws(lines, seed):
    """(g) the whole fisheye replay (production's sizes, loop closing on)
    on the CPU with the JAX package's RANSAC draws of a cfg.seed
    (`test_torch_bootstrap.JaxKeyChain`), against that JAX run: with lines
    and no IMU init (seed 3: the reference loses all but 7 frames, NaN
    line rows, ROADMAP Queue 3) every count equal; otherwise the frames
    tracked, the bootstrap and IMU init frames equal, and without lines
    the keyframes and points within 10% (the windows after the IMU init
    part the float32 runs; with lines, seed 11, the rare IMU init at frame
    67, they part further: the keyframes are printed, not held).  The
    port's own draws reach such outcomes on other seeds (its cfg.seed 4
    initializes the IMU with lines at frame 67); these runs show that the
    draws decide them."""
    from test_torch_bootstrap import JaxKeyChain
    from plvio_tpu_torch.entry import kb8_vi_config as port_cfg
    from plvio_tpu_torch.entry import kb8_vi_replay
    step, S = kb8_vi_replay(device="cpu", use_lines=lines,
                            sampler=JaxKeyChain(seed))
    step.cfg = port_cfg(lines, seed=seed)
    with torch.no_grad():
        o = step(S)
    got = (o.n_tracked, o.init_frame, o.imu_init_frame, o.keyframes,
           o.points)
    want = REF_DRAWS[(lines, seed)]
    print(f"fisheye replay lines={lines}, JAX's draws of cfg.seed {seed}: "
          f"{got} (JAX {want})")
    if lines and want[2] < 0:
        assert got == want
    else:
        assert got[:3] == want[:3]
    if not lines:
        assert all(abs(g - w) <= 0.1 * w for g, w in zip(got[3:], want[3:]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed"]:
        lines = "--lines" in sys.argv
        print("KB8_VI_SEED = " + json.dumps(
            reference_kb8_vi(int(sys.argv[2]), lines)))
    else:
        ref = {"points_only": seed_ranges(__file__, [], "KB8_VI_SEED = "),
               "lines": seed_ranges(__file__, ["--lines"],
                                    "KB8_VI_SEED = ",
                                    n_seeds=N_SEEDS_LINES)}
        print("REF_KB8_VI = " + json.dumps(ref))
