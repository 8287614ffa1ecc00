"""The landmark-sharded inertial window BA of the port
(plvio_tpu_torch/parallel/dist_liba.py) against the JAX package on the
CPU: the shard tables bit for bit, the solver at D = 1, 2 and 4 against
JAX's at the same D on the suite's virtual mesh, and one `_liba_window`
of the port's LocalMapper on a 2-shard mesh against the JAX mapper given a
2-device runner.

The problem is tests/test_chain_liba.py's `_build_problem` cut to 8
keyframes x 300 points x 64 lines (19 line observations; JAX compiles one shard_map program a
mesh size; 8 keyframes keep the three compiles within the file's time),
perturbed by tests/test_dist_liba.py's `_perturb` (JAX's compile of each
mesh size, ~16 s, is most of the file's time).

Tolerances, and why: a float64 run of the port at the same D is the
yardstick; poses, velocities and biases within 2x JAX's distance to it
plus float32 floors (1e-4 a pose entry and m/s, 1e-5 m/s^2 and rad/s)
and points bound in >= 3 keyframes likewise with 1e-3, the rule of
tests/test_torch_keyframe_step.py.  The port at D = 2 is held to its own
float64 D = 1 by the same rule, within 2x JAX's D = 2 distance to it (the
sharded step is the single-device one up to float rounding and the D x
1e-6 damping constant, which moves a weakly observed bias in both).  Run as a script,
this file prints REF_DIST for chip_smoke.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from plvio_tpu.io import synthetic as jsyn
from plvio_tpu.parallel import dist_liba as JDL
from plvio_tpu_torch.parallel import dist_liba as DL
from plvio_tpu_torch.parallel.mesh import Mesh

from test_chain_liba import _build_problem, K
from test_dist_liba import _perturb

N_KF = 8
ROUNDS = 2
FLOOR = {"pose": 1e-4, "vel": 1e-4, "bg": 1e-5, "ba": 1e-5, "pt": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    prob = _build_problem(rng, n_kf=N_KF, n_pts=300, n_lns=64)
    start = _perturb(rng, prob[0], prob[1], prob[2], prob[3], N_KF)
    return prob, start


def _args(prob, start):
    (pose_gt, vel_gt, X, ln_ep, obs_kf, obs_pt, obs_uv,
     lobs_kf, lobs_ln, lobs_eq, pre_stack, infos, ev, rwg, rwa) = prob
    pose0, vel0, X0, ln0 = start
    bgba = np.zeros((N_KF, 3), np.float32)
    free = np.arange(N_KF) > 0
    return (pose0, vel0, bgba, bgba, free, free, obs_kf, obs_pt, obs_uv,
            np.ones(len(obs_kf), np.float32), X0, pre_stack, infos, ev,
            rwg, rwa), dict(lobs_kf=lobs_kf, lobs_ln=lobs_ln,
                            lobs_eq=lobs_eq, ln_ep=ln0)


def test_shard_tables_bit_equal(problem):
    """shard_landmarks (with an Ol that overflows and its dropped count),
    build_dist_liba's tables, gather_landmarks and _bucket."""
    prob, start = problem
    args, kw = _args(prob, start)
    obs_pt, n_pts = args[7], len(args[10])
    cols = [(args[6].astype(np.int32), 0, np.int32),
            (args[8].astype(np.float32), 0, np.float32)]
    lm = [(args[10].astype(np.float32), 0, np.float32)]
    for D, Ol in ((3, None), (4, 8)):
        j = JDL.shard_landmarks(D, n_pts, obs_pt, cols, lm, Ol=Ol)
        p = DL.shard_landmarks(D, n_pts, obs_pt, cols, lm, Ol=Ol)
        for a, b in zip(j[0] + [j[1], j[2]] + j[3] + [j[4], j[5], j[6]],
                        p[0] + [p[1], p[2]] + p[3] + [p[4], p[5], p[6]]):
            np.testing.assert_array_equal(a, b)
        if Ol is not None:
            dropped = len(obs_pt) - int(p[2].sum())
            assert dropped == len(obs_pt) - int(j[2].sum()) > 0
    for D in (1, 2, 4):
        jd, jl = JDL.build_dist_liba(D, *args, **kw)
        pd, pl = DL.build_dist_liba(D, *args, **kw)
        for f in JDL.DistLIBAData._fields:
            a, b = getattr(jd, f), getattr(pd, f)
            if f == "pre_const":
                for k in a:
                    np.testing.assert_array_equal(np.asarray(a[k]),
                                                  b[k].numpy())
            else:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), f)
        for k in ("shard_of_pt", "local_of_pt", "shard_of_ln",
                  "local_of_ln", "have_lines"):
            np.testing.assert_array_equal(jl[k], pl[k])
        assert pl["dropped_obs"] == 0
        pts = np.arange(D * pd.pt_xyz.shape[1] * 3, dtype=np.float32
                        ).reshape(D, -1, 3)
        lns = np.arange(D * pd.ln_ep.shape[1] * 6, dtype=np.float32
                        ).reshape(D, -1, 6)
        for a, b in zip(JDL.gather_landmarks(jl, pts, lns, n_pts,
                                             len(kw["ln_ep"])),
                        DL.gather_landmarks(pl, pts, lns, n_pts,
                                            len(kw["ln_ep"]))):
            np.testing.assert_array_equal(a, b)
    for n in range(1, 300, 7):
        for base in (8, 16, 32, 64):
            assert JDL._bucket(n, base) == DL._bucket(n, base)


def _solve_jax(devs, D, args, kw):
    data, layout = JDL.build_dist_liba(D, *args, **kw)
    run = JDL.make_dist_liba(
        K, JMesh(np.array(devs[:D]), ("lm",)), "lm", N_KF,
        data.pt_xyz.shape[1], data.obs_kf.shape[1], data.ln_ep.shape[1],
        data.lobs_kf.shape[1], np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32), jsyn.GRAVITY, rounds=ROUNDS, iters=8)
    o = [np.asarray(x) for x in run(data)]
    pts, _ = JDL.gather_landmarks(layout, o[4], o[5], len(args[10]),
                                  len(kw["ln_ep"]))
    return dict(pose=o[0], vel=o[1], bg=o[2], ba=o[3], pt=pts)


def _solve_port(D, args, kw, dtype=torch.float32):
    data, layout = DL.build_dist_liba(D, *args, **kw)
    run = DL.make_dist_liba(
        K, Mesh(["cpu"] * D), N_KF, data.pt_xyz.shape[1],
        data.obs_kf.shape[1], data.ln_ep.shape[1], data.lobs_kf.shape[1],
        np.eye(3), np.zeros(3), jsyn.GRAVITY, rounds=ROUNDS, iters=8,
        dtype=dtype)
    o = [x.numpy() for x in run(data)]
    pts, lns = DL.gather_landmarks(layout, o[4], o[5], len(args[10]),
                                   len(kw["ln_ep"]))
    assert lns is not None and np.isfinite(lns).all()
    return dict(pose=o[0], vel=o[1], bg=o[2], ba=o[3], pt=pts)


def _held(p, j, r, sel_pt, tag):
    out = {}
    for k, fl in FLOOR.items():
        sel = sel_pt if k == "pt" else slice(None)
        dp = float(np.abs(p[k][sel].astype(np.float64) - r[k][sel]).max())
        dj = float(np.abs(j[k][sel].astype(np.float64) - r[k][sel]).max())
        out[k] = (dp, dj)
        assert dp <= 2 * dj + fl, (tag, k, dp, dj)
    print(tag, out)


def test_dist_liba_against_jax(problem, cpu_devices):
    """make_dist_liba at D = 1, 2, 4 against JAX's at the same D; the
    port's D = 2 against its own D = 1; the solve moves the start."""
    prob, start = problem
    args, kw = _args(prob, start)
    n_views = np.array([len(np.unique(args[6][args[7] == i]))
                        for i in range(len(args[10]))])
    sel = n_views >= 3
    runs = {}
    for D in (1, 2, 4):
        j = _solve_jax(cpu_devices, D, args, kw)
        p = _solve_port(D, args, kw)
        r = _solve_port(D, args, kw, torch.float64)
        _held(p, j, r, sel, f"D={D}")
        runs[D] = (p, j, r)
    # the port's D = 2 against its float64 D = 1, within 2x JAX's D = 2
    # distance to it: the D x 1e-6 damping moves the weakly observed
    # accelerometer bias of an 8-keyframe window by ~1e-3 in both
    _held(runs[2][0], runs[2][1], runs[1][2], sel, "D=2 against D=1")
    assert np.abs(runs[2][0]["pose"] - start[0]).max() > 1e-3


def test_liba_window_against_jax_mapper(cpu_devices):
    """One `_liba_window` of the port's LocalMapper with a 2-shard mesh
    against the JAX mapper with a runner on 2 devices, on a 16-keyframe
    window of `inputs.build_inertial_map`: the store's poses, velocities,
    biases and points by the float64 rule, the erased observations and the
    live sets equal, lines finite."""
    from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
    from plvio_tpu.models.mapstore import Atlas as JAtlas
    from plvio_tpu_torch.entry import KeyframeSequence
    from plvio_tpu_torch.inputs import (build_inertial_map,
                                        build_keyframe_sequence)
    from plvio_tpu_torch.state import mapstore_from_numpy, mapstore_to_numpy
    from test_torch_viba import JCFG, jax_store

    store = dict(max_kf=24, max_pts=4096, max_lines=1024)
    seq = build_keyframe_sequence(0, n_kf=18, n_feat=256)
    a = mapstore_to_numpy(build_inertial_map(seq, 18, store))
    jm = JLocalMapper(JCFG, JAtlas([jax_store(a)]), 256)
    jm._dist_runner = JDL.DistLIBARunner(
        jm.K, jm.R_cb, jm.t_cb, JCFG.imu.gravity,
        mesh=JMesh(np.array(cpu_devices[:2]), ("lm",)))

    def port(dtype):
        mp = KeyframeSequence(plain=True, device="cpu").new_mapper()
        mp.dtype = dtype
        mp.map = mapstore_from_numpy(a)
        mp._dist_runner = DL.DistLIBARunner(
            mp.K, mp.R_cb, mp.t_cb, JCFG.imu.gravity,
            mesh=Mesh(["cpu", "cpu"]), dtype=dtype)
        return mp
    runs = [port(torch.float32), port(torch.float64)]
    chain = jm.map.kf_chain()
    win = chain[-16:]
    free = np.arange(len(win)) > 0
    for mp in [jm] + runs:
        mp._liba_window(win, free)
    assert runs[0].ba_calls[-1]["path"] == "dist"
    assert runs[0]._dist_runner.n_solves == 1
    j, p, r = (mapstore_to_numpy(mp.map) for mp in [jm] + runs)
    for k in ("kf_valid", "kf_match_pt", "pt_valid", "pt_n_obs",
              "kf_match_ln", "ln_valid"):
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    fl = {"kf_pose_wb": 1e-4, "kf_vel": 1e-4, "kf_bias_g": 1e-5,
          "kf_bias_a": 1e-5, "pt_xyz": 1e-3}
    out = {}
    for k, f in fl.items():
        sel = win if k.startswith("kf_") else \
            j["pt_valid"] & (j["pt_n_obs"] >= 3)
        dp = float(np.abs(p[k][sel].astype(np.float64) - r[k][sel]).max())
        dj = float(np.abs(j[k][sel].astype(np.float64) - r[k][sel]).max())
        out[k] = (dp, dj)
        assert dp <= 2 * dj + f, (k, dp, dj)
    print(out)
    assert float(np.abs(p["kf_pose_wb"][win] - a["kf_pose_wb"][win]).max()
                 ) > 1e-5
    assert np.isfinite(p["ln_ep"][p["ln_valid"]]).all()


@pytest.mark.parametrize("flag,sensor,kb8,mesh,built", [
    ("1", "IMU_MONOCULAR", False, None, True),
    ("0", "IMU_MONOCULAR", False, None, False),
    ("", "IMU_MONOCULAR", False, None, False),
    ("", "IMU_MONOCULAR", False, 2, True),
    ("1", "MONOCULAR", False, None, False),
    ("1", "IMU_MONOCULAR", True, None, False)])
def test_mapper_builds_runner_by_the_rule(monkeypatch, flag, sensor, kb8,
                                          mesh, built):
    """The port's LocalMapper builds the sharded runner where the JAX rule
    does (an IMU, no KB8 lens; PLVIO_DIST=1 forces it, 0 forbids it, and
    on the CPU nothing turns it on by itself) or where it is given a mesh;
    a mesh on a card raises without one."""
    from plvio_tpu_torch.config import (CameraConfig, ImuConfig, Sensor,
                                        SystemConfig)
    from plvio_tpu_torch.models.local_mapping import LocalMapper
    from plvio_tpu_torch.models.mapstore import Atlas, MapStore
    monkeypatch.setenv("PLVIO_DIST", flag)
    cam = CameraConfig(dist=(0.0, 0.0, 0.0, 0.0))
    if kb8:
        cam = CameraConfig(model="kb8", dist=(0.01, 0.0, 0.0, 0.0))
    cfg = SystemConfig(sensor=Sensor[sensor], camera=cam,
                       imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
    m = MapStore(max_kf=4, max_pts=16, max_lines=4, n_feat=8)
    mp = LocalMapper(cfg, Atlas([m]), 8, device="cpu", plain=True,
                     dist_mesh=None if mesh is None
                     else Mesh(["cpu"] * mesh))
    assert (mp._dist_runner is not None) == built
    if built:
        assert mp._dist_runner.D == (mesh or 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Mesh(["cuda"])


@pytest.mark.parametrize("flag,device,n_shards", [
    ("1", "cpu", 1), ("", "cpu", None), ("0", "cpu", None),
    ("1", "cuda", 2), ("", "cuda", 2), ("0", "cuda", None)])
def test_default_mesh_follows_the_callers_device(monkeypatch, flag, device,
                                                 n_shards):
    """`default_mesh` on a host that shows two cards: a mesh of one shard
    a card only where the caller's device is a card; a CPU caller under
    PLVIO_DIST=1 gets one CPU shard, as JAX takes its own backend's
    devices."""
    from plvio_tpu_torch.parallel.mesh import default_mesh
    monkeypatch.setenv("PLVIO_DIST", flag)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = default_mesh(device)
    if n_shards is None:
        assert mesh is None
        return
    assert mesh.size == n_shards
    assert {d.type for d in mesh.devices} == {device}
    if device == "cuda":
        assert [d.index for d in mesh.devices] == [0, 1]


@pytest.mark.slow
def test_system_on_dist_backend():
    """tests/test_dist_production.py on the port: System (IMU_MONOCULAR,
    identity Tbc) with a 2-shard mesh over the room orbit (9 s at 10 fps):
    >= 85% of the frames tracked, ATE < 0.1 m (Sim3), and the inertial
    window solves on the sharded back end."""
    from plvio_tpu_torch.config import (CameraConfig, ImuConfig, Sensor,
                                        SystemConfig)
    from plvio_tpu_torch.inputs import synthesize_imu
    from plvio_tpu_torch.io import synthetic as syn
    from plvio_tpu_torch.io import trajectory as TIO
    from plvio_tpu_torch.models.system import System
    from plvio_tpu_torch.utils import lie
    rng = np.random.default_rng(0)
    dur, fps = 9.0, 10.0
    scene = syn.make_room_scene(rng, n_points=3000, n_lines=120)
    traj = syn.make_orbit_trajectory(duration=dur, fps=fps, radius=0.8)
    imu = synthesize_imu(rng, dur)
    cfg = SystemConfig(sensor=Sensor.IMU_MONOCULAR,
                       camera=CameraConfig(dist=(0., 0., 0., 0.)),
                       imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
    slam = System(cfg, device="cpu", dist_mesh=Mesh(["cpu", "cpu"]))
    assert slam.mapper._dist_runner is not None
    n_frames = len(traj.timestamps)
    n_ok, last_t = 0, None
    for i in range(n_frames):
        t = traj.timestamps[i]
        img = syn.render_frame(scene, traj.R_wb[i], traj.p_wb[i], rng=rng)
        batch = None
        if last_t is not None:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            ts = imu.timestamps[sel]
            batch = (imu.gyro[sel], imu.acc[sel],
                     np.diff(np.concatenate([[last_t], ts])))
        n_ok += slam.track_monocular(img, t, imu=batch) is not None
        last_t = t
    assert n_ok >= 0.85 * n_frames, f"{n_ok}/{n_frames}"
    assert slam.metrics_summary()["mapping/dist_solves"]["calls"] >= 1
    est = slam.trajectory()
    q = lie.rot_to_quat(torch.from_numpy(
        np.asarray(traj.R_wb, np.float32))).numpy()
    gt = TIO.Trajectory(traj.timestamps, traj.p_wb, q)
    ate = TIO.ate_rmse(est, gt, with_scale=True)
    assert ate < 0.1, f"ATE {ate:.3f} m"


# --------------------------------------------------------------------------
# REF_DIST: the JAX System over the MH replay on the sharded back end
# --------------------------------------------------------------------------

DIST_ENV = {"JAX_PLATFORMS": "cpu", "PLVIO_DIST": "1",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}


def reference_dist(n_proc: int = 3) -> dict:
    """REF_DIST: the JAX System with PLVIO_DIST=1 on a 2-device CPU mesh
    over the 8 s MH replay at cfg.seed 0..4 (tests/test_torch_system.py's
    `reference_mh`, one process a seed, n_proc at a time): seed 0's run
    and each quantity's worst over the seeds, as REF_MH."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, **DIST_ENV,
           "PYTHONPATH": os.path.dirname(here)}
    sys.path.insert(0, here)
    from test_torch_system import MH_ERRORS, with_errors
    runs = []
    for start in range(0, 5, n_proc):
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "test_torch_system.py"),
             "--seed", str(k)], stdout=subprocess.PIPE, env=env, text=True)
            for k in range(start, min(start + n_proc, 5))]
        for p in procs:
            out, _ = p.communicate()
            line = [x for x in out.splitlines() if x.startswith("MH_SEED = ")]
            runs.append(with_errors(json.loads(line[-1][len("MH_SEED = "):])))
    return summarize_dist(runs, MH_ERRORS)


def summarize_dist(runs, errors) -> dict:
    ref = {k: runs[0][k] for k in (
        "n_frames", "n_tracked", "init_frame", "imu_init_kf",
        "imu_init_frame", "keyframes", "points", "lines", "ate_se3",
        "ate_sim3", "scale", "gravity_err_deg")}
    for k in errors:
        ref[k + "_worst"] = max(r[k] for r in runs)
    for k in ("n_tracked", "imu_init_frame", "keyframes", "init_frame"):
        ref[k + "_min"] = min(r[k] for r in runs)
        ref[k + "_max"] = max(r[k] for r in runs)
    ref["per_seed"] = [{k: r[k] for k in (
        "n_tracked", "init_frame", "imu_init_frame", "imu_init_kf",
        "keyframes", "points", "lines", "ate_se3", "ate_sim3")}
        for r in runs]
    return ref


if __name__ == "__main__":
    print("REF_DIST = " + json.dumps(reference_dist()))
