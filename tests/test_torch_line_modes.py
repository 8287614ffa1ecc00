"""Slice 13, path B: the line-only SLAM modes 1-3 (`cfg.slam_mode`, the
reference's YAML `SLAM`) against the JAX package on the CPU.

Run as a script, it prints REF_LINE_MODES for chip_smoke.py: the JAX
`System` over the MH replay's frames (tests/test_torch_system.py
`jax_mh_inputs`), MONOCULAR with lines, the IMU batches not passed, loop
closing on, `slam_mode` 1, 2 and 3, `cfg.seed` 0..9
(tests/test_torch_kb8_inertial.py `N_SEEDS`), three processes at a time:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_line_modes.py

As tests (torch on one thread), each against the JAX package on the same
inputs:

(a) the residuals `make_line_reproj_fixed`, `make_line_angle_fixed` and
    `make_line_angle` on 64 random segments and poses: within 1e-4
    (pixels; the angle's sine within 1e-6);
(b) their analytic Jacobians (`line_reproj_fixed_jac`, `line_angle_jac`,
    the kernels' formulas) against `torch.func.jacrev` in float64,
    within 1e-9 relative, segments whose endpoints project 0.01 px apart
    (|d| -> 0) and segments of one point (d = 0, finite) included;
(c) `make_pose_opt_line_only` per mode on tests/test_slam_modes.py's case
    (40 segments at cap 64, the start moved as there) and with 10% of the
    observed lines moved 30 px: the port's plain float32 run within 2x
    JAX's distance to a float64 run of the port + 1e-6 a pose entry,
    inliers equal but for rows whose chi2 at the float64 pose lies within
    1% of 5.991;
(d) `make_local_ba_lines_only` per mode on tests/test_slam_modes.py's
    window (4 KF x 30 segments at caps 8 / 64 / 256, observations with
    0.5 px noise): poses and endpoints within 2x JAX's distance to a
    float64 run of the port + 1e-4;
(e) `System` under each mode through the public `track_monocular` over
    the first frames of the MH replay's hall (tests/test_torch_system.py's
    reduced sizes, loop closing off) against the JAX `System` fed the
    port's features, the port starting from the JAX run's state after its
    bootstrap: every frame's state, inliers, keyframes made and the map's
    counts equal, poses within 1e-4.
"""
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

from plvio_tpu.config import CameraConfig, ImuConfig, Sensor, SystemConfig
from plvio_tpu.models import kernels as JKN
from plvio_tpu.solver import residuals as JRES
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.utils import lie

LINE_MODE_SECONDS = 8.0


def line_mode_config(mode: int, seed: int = 0, **kw):
    """`entry.line_mode_config`'s configuration in the JAX package."""
    return SystemConfig(
        sensor=Sensor.MONOCULAR, camera=CameraConfig(dist=(0.0,) * 4),
        imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))), use_lines=True,
        slam_mode=mode, seed=seed, **kw)


def reference_line_mode(mode: int, seed: int,
                        seconds: float = LINE_MODE_SECONDS) -> dict:
    from test_torch_kb8_inertial import reference_replay
    from test_torch_system import jax_mh_inputs
    S = jax_mh_inputs(seconds)
    return reference_replay(line_mode_config(mode, seed), S, False)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

K = RES.PinholeK(458.0, 457.0, 367.0, 248.0)       # tests/test_slam_modes.py
JK = JRES.PinholeK(*K)
CHI2 = 5.991


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(seed, n=64):
    """Poses near the identity and segments in front of them, float64."""
    rng = np.random.default_rng(seed)
    P = torch.cat([lie.so3_exp(torch.from_numpy(rng.normal(0, 0.1, (n, 3)))),
                   torch.from_numpy(rng.normal(0, 0.2, (n, 3, 1)))], -1)
    pc = torch.from_numpy(np.stack([rng.uniform(-1, 1, (n, 2)),
                                    rng.uniform(-1, 1, (n, 2)),
                                    rng.uniform(1, 4, (n, 2))], -1))
    # camera points -> world endpoints: X = R^T (pc - t)
    L = torch.einsum("nji,nkj->nki", P[..., :3], pc - P[:, None, :, 3])
    L = L.reshape(n, 6)
    l = torch.from_numpy(rng.normal(0, 1, (n, 3)))
    l = l / l[:, :2].norm(dim=-1, keepdim=True)
    d = torch.from_numpy(rng.normal(0, 1, (n, 2)))
    return rng, P, L, l, d / d.norm(dim=-1, keepdim=True)


def test_line_residuals_match_reference():
    """(a)"""
    _, P, L, l, d = _segments(0)
    P, L, l, d = (x.float() for x in (P, L, l, d))
    z6 = torch.zeros(P.shape[0], 6)
    jz = jnp.zeros((P.shape[0], 6), jnp.float32)
    a = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    for name, c_port, c_jax, rdim, tol in (
            ("make_line_reproj_fixed", {"l": l, "Xs": L[:, :3],
                                        "Xe": L[:, 3:]},
             {"l": a(l), "Xs": a(L[:, :3]), "Xe": a(L[:, 3:])}, 2, 1e-4),
            ("make_line_angle_fixed", {"dir": d, "Xs": L[:, :3],
                                       "Xe": L[:, 3:]},
             {"dir": a(d), "Xs": a(L[:, :3]), "Xe": a(L[:, 3:])}, 1, 1e-6)):
        rp = vmap(getattr(RES, name)(K))((P,), (z6,), c_port)
        rj = jax.vmap(getattr(JRES, name)(JK))((a(P),), (jz,), c_jax)
        assert rp.shape == (P.shape[0], rdim)
        assert float((rp - torch.from_numpy(np.asarray(rj))).abs().max()) \
            <= tol, name
    rp = vmap(RES.make_line_angle(K))((P, L), (z6, z6), {"dir": d})
    rj = jax.vmap(JRES.make_line_angle(JK))((a(P), a(L)), (jz, jz),
                                             {"dir": a(d)})
    assert float((rp - torch.from_numpy(np.asarray(rj))).abs().max()) <= 1e-6


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("near_zero", [False, True])
def test_line_jacobians_match_autodiff(near_zero):
    """(b)"""
    torch.set_default_dtype(torch.float64)
    try:
        rng, P, L, l, d = _segments(1)
        if near_zero:
            # the end point 0.01 px from the start in the image (|d| -> 0;
            # nearer, both the analytic rows and jacrev lose their digits
            # to the difference of the endpoints' rows), and segments of one
            # point (d = 0, the padded rows): finite, as jacrev's
            pc = (P[..., :3] @ L[:, :3, None])[..., 0] + P[..., 3]
            off = torch.from_numpy(rng.normal(0, 1, (len(L), 2)))
            off = off / off.norm(dim=-1, keepdim=True) * 1e-2
            off[:8] = 0.0
            pe = pc.clone()
            pe[:, 0] += off[:, 0] * pc[:, 2] / K.fx
            pe[:, 1] += off[:, 1] * pc[:, 2] / K.fy
            L = torch.cat([L[:, :3], ((pe - P[..., 3])[:, None, :]
                                      @ P[..., :3])[:, 0]], -1)
            L[:8, 3:] = L[:8, :3]
        z6 = torch.zeros(6)
        f = RES.make_line_angle(K)
        ja = vmap(lambda p, x, dd: jacrev(
            lambda a, b: f((p, x), (a, b), {"dir": dd}), argnums=(0, 1))(
                z6, z6))(P, L, d)
        r, Jp, Jl = RES.line_angle_jac(K, P, L, d)
        rr = vmap(lambda p, x, dd: f((p, x), (z6, z6), {"dir": dd}))(P, L, d)
        assert float((r - rr).abs().max()) <= 1e-12
        assert bool(torch.isfinite(Jp).all() and torch.isfinite(Jl).all())
        assert _rel(Jp, ja[0]) <= 1e-9 and _rel(Jl, ja[1]) <= 1e-9
        f = RES.make_line_reproj_fixed(K)
        je = vmap(lambda p, ll, xs, xe: jacrev(
            lambda a: f((p,), (a,), {"l": ll, "Xs": xs, "Xe": xe}))(z6))(
                P, l, L[:, :3], L[:, 3:])
        _, J = RES.line_reproj_fixed_jac(K, P, L[:, :3], L[:, 3:], l)
        assert _rel(J, je) <= 1e-9
    finally:
        torch.set_default_dtype(torch.float32)


def _slam_modes_case(mode, outliers: bool):
    """tests/test_slam_modes.py `test_pose_opt_line_only_recovers_pose`'s
    inputs (cap 64), with 10% of the observed lines moved 30 px."""
    from test_slam_modes import CAP, _line_obs, _scene
    rng = np.random.default_rng(4 + mode)
    Xs, Xe = _scene(rng)
    n = len(Xs)
    pose_true = np.concatenate(
        [np.asarray(lie.so3_exp(torch.tensor([0.05, -0.1, 0.02]))),
         np.array([[0.1], [-0.05], [0.2]], np.float32)], 1).astype(
             np.float32)
    l_obs, dirs = _line_obs(pose_true, Xs, Xe)
    mag = 0.02 if mode == 2 else 0.08
    dx = rng.normal(0, mag, 6)
    Rp, tp = lie.se3_exp(torch.from_numpy(dx))
    pose0 = np.concatenate([Rp.numpy() @ pose_true[:, :3],
                            (Rp.numpy() @ pose_true[:, 3]
                             + tp.numpy())[:, None]], 1).astype(np.float32)
    if outliers:
        bad = np.random.default_rng(9).random(n) < 0.1
        l_obs[bad, 2] += 30.0

    def pad(a):
        out = np.zeros((CAP,) + a.shape[1:], np.float32)
        out[:len(a)] = a
        return out
    return (pose0, pad(l_obs), pad(dirs), pad(Xs), pad(Xe),
            np.arange(CAP) < n, np.ones(CAP, np.float32))


def _line_chi2(pose, case, mode):
    """Each row's gate chi2 (the endpoint term's, the angle term's in mode
    2) at a pose, float64."""
    P = torch.from_numpy(np.asarray(pose, np.float64))
    _, l_obs, dirs, Xs, Xe, _, _ = (torch.from_numpy(np.asarray(
        c, np.float64)) for c in case)
    n = Xs.shape[0]
    if mode == 2:
        r = RES.line_angle_jac(K, P.expand(n, 3, 4), torch.cat([Xs, Xe], -1),
                               dirs)[0] ** 2 * 400.0
    else:
        r = RES.line_reproj_fixed_jac(K, P.expand(n, 3, 4), Xs, Xe,
                                      l_obs)[0] ** 2
    return r.sum(-1).numpy()


@functools.lru_cache(maxsize=None)
def _jax_pose_opt(cap: int, mode: int):
    """The JAX line-only pose optimizer, jitted once per shape and mode."""
    return JKN.make_pose_opt_line_only(JK, cap, mode)


@pytest.mark.parametrize("outliers", [False, True])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_pose_opt_line_only_matches_reference(mode, outliers):
    """(c)"""
    case = _slam_modes_case(mode, outliers)
    cap = case[1].shape[0]
    oj = _jax_pose_opt(cap, mode)(*[jnp.asarray(c) for c in case])
    run = KN.make_pose_opt_line_only(K, mode)
    op = run(*[torch.from_numpy(c) for c in case])
    o64 = run(*[torch.from_numpy(c.astype(np.float64) if c.dtype
                                 == np.float32 else c) for c in case])
    pj, pp, p64 = (np.asarray(o[0], np.float64) for o in (oj, op, o64))
    gj, gp = np.abs(pj - p64).max(), np.abs(pp - p64).max()
    print(f"mode {mode} outliers={outliers}: port {gp:.2e}, JAX {gj:.2e} "
          f"from float64; inliers {int(op[2])} / {int(oj[2])}")
    assert gp <= 2 * gj + 1e-6
    near = np.abs(_line_chi2(p64, case, mode) - CHI2) <= 0.01 * CHI2
    diff = np.asarray(op[1]) != np.asarray(oj[1])
    assert not (diff & ~near).any()


def _slam_modes_window(seed=11):
    """tests/test_slam_modes.py `test_local_ba_lines_only_converges`'s
    window (4 KF, 30 segments, caps 8 / 64 / 256), its observations with
    N(0, 0.5) px on both endpoints."""
    from test_slam_modes import _project, _scene
    rng = np.random.default_rng(seed)
    Xs, Xe = _scene(rng, n=30)
    n, n_kf = len(Xs), 4
    poses = []
    for i in range(n_kf):
        R = lie.so3_exp(torch.tensor([0.0, 0.03 * i, 0.0])).numpy()
        t = np.array([0.15 * i, 0.0, 0.0], np.float32)
        poses.append(np.concatenate([R, t[:, None]], 1).astype(np.float32))
    nrng = np.random.default_rng(seed + 100)
    kf, ln, eq, dr = [], [], [], []
    for s, p in enumerate(poses):
        us = _project(p, Xs) + nrng.normal(0, 0.5, (n, 2))
        ue = _project(p, Xe) + nrng.normal(0, 0.5, (n, 2))
        one = np.ones((n, 1))
        l = np.cross(np.concatenate([us, one], 1),
                     np.concatenate([ue, one], 1))
        l /= np.linalg.norm(l[:, :2], axis=1, keepdims=True)
        d = ue - us
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        kf.append(np.full(n, s, np.int32))
        ln.append(np.arange(n, dtype=np.int32))
        eq.append(l.astype(np.float32))
        dr.append(d.astype(np.float32))
    KF_CAP, LN_CAP, LOBS_CAP = 8, 64, 256
    kf_poses = np.tile(np.eye(3, 4, dtype=np.float32), (KF_CAP, 1, 1))
    kf_poses[:n_kf] = np.stack(poses)
    for i in range(1, n_kf):
        dR, dt = lie.se3_exp(torch.from_numpy(rng.normal(0, 0.02, 6)))
        kf_poses[i, :, :3] = dR.numpy() @ kf_poses[i, :, :3]
        kf_poses[i, :, 3] = dR.numpy() @ kf_poses[i, :, 3] + dt.numpy()
    ln_ep = np.zeros((LN_CAP, 6), np.float32)
    ln_ep[:n] = np.concatenate([Xs, Xe], 1) + rng.normal(0, 0.03, (n, 6))

    def pad(a):
        out = np.zeros((LOBS_CAP,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out
    m = n * n_kf
    return (kf_poses, np.arange(KF_CAP) > 0, ln_ep, np.arange(LN_CAP) < n,
            pad(np.concatenate(kf)), pad(np.concatenate(ln)),
            pad(np.concatenate(eq)), pad(np.concatenate(dr)),
            np.arange(LOBS_CAP) < m, np.ones(LOBS_CAP, np.float32))


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_local_ba_lines_only_matches_reference(mode):
    """(d)"""
    W = _slam_modes_window()
    W = list(W)
    W[1] = W[1] & (np.arange(8) < 4)        # the padding slots stay fixed
    oj = JKN.make_local_ba_lines_only(JK, 8, 64, 256, mode)(
        *[jnp.asarray(w) for w in W])
    run = KN.make_local_ba_lines_only(K, mode)
    op = run(*[torch.from_numpy(w) for w in W])
    o64 = run(*[torch.from_numpy(w.astype(np.float64) if w.dtype
                                 == np.float32 else w) for w in W])
    for i, what in ((0, "poses"), (1, "endpoints")):
        pj, pp, p64 = (np.asarray(o[i], np.float64) for o in (oj, op, o64))
        gj, gp = np.abs(pj - p64).max(), np.abs(pp - p64).max()
        print(f"mode {mode} {what}: port {gp:.2e}, JAX {gj:.2e} from "
              "float64")
        assert gp <= 2 * gj + 1e-4, what


@pytest.fixture(scope="module")
def tracker_world():
    """tests/test_torch_tracker.py's teacher-forced trackers (its `world`:
    the keyframe sequence's first 12 keyframes as a map with lines, one
    tracker of each package)."""
    from test_torch_tracker import world
    return world.__wrapped__()


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_tracker_line_only_matches_reference(tracker_world, mode):
    """(e) the tracker: tests/test_torch_tracker.py's `pl` case (the IMU not
    initialized, so the point+line branch tracks the frame) under SLAM
    mode 1, 2, 3: with >= 8 map lines matched the pose comes from the
    lines alone (`make_pose_opt_line_only`) on both sides, the point
    inliers counted at it on the host; every decision, binding and count
    equal, poses within 1e-4 (test_torch_tracker.py's `assert_same`)."""
    from test_torch_tracker import (CASES, assert_same, base_state, load,
                                    mutate, run_frames)
    w = tracker_world
    jt, pt = w["jt"], w["pt"]
    a = mutate(w["base"], "pl")
    load(w, a, base_state(a, w["seq"]))
    jt.pose_opt_line_only = JKN.make_pose_opt_line_only(
        jt.K, jt.local_ln_cap, mode)
    calls = []
    run = KN.make_pose_opt_line_only(pt.K, mode, plain=True)

    def counted(*args):
        calls.append(args)
        return run(*args)
    pt.pose_opt_line_only = counted
    try:
        recs = run_frames(w, CASES["pl"])
    finally:
        jt.pose_opt_line_only = pt.pose_opt_line_only = None
    for n, (j, p) in enumerate(recs):
        assert_same(j, p, f"mode {mode} frame {n}")
    print(f"mode {mode}: states {[j['state'] for j, _ in recs]}, inliers "
          f"{[j['last_n_inliers'] for j, _ in recs]}, line-only solves "
          f"{len(calls)}")
    assert len(calls) == 1 and int(calls[0][5].sum()) >= 8


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_mapper_line_only_ba_matches_reference(mode):
    """(e) the mapper: `LocalMapper.local_ba` on the new keyframe of
    `inputs.build_keyframe_map(confirmed_lines=True)` (its window holds
    >= 8 lines seen >= 3 times) under SLAM mode 1, 2, 3 at
    tests/test_torch_neighborhood.py's small caps: the line-only window
    BA on both sides (each observation's direction computed as the
    reference does), the points held fixed; KF poses and endpoints within
    2x the JAX mapper's distance to the port's mapper in float64 + 1e-4,
    the bindings equal."""
    from test_torch_neighborhood import CFG, SMALL_CAPS, jax_store
    from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
    from plvio_tpu.models.mapstore import Atlas as JAtlas
    from plvio_tpu_torch.entry import mapper_config
    from plvio_tpu_torch.config import Sensor as PSensor
    from plvio_tpu_torch.inputs import build_keyframe_map
    from plvio_tpu_torch.models.local_mapping import LocalMapper
    from plvio_tpu_torch.models.mapstore import Atlas
    from plvio_tpu_torch.state import mapstore_from_numpy, mapstore_to_numpy
    arrays, truth = build_keyframe_map(True)
    kf = truth["new_kf"]
    jm = jax_store(arrays)
    jl = JLocalMapper(CFG.replace(slam_mode=mode), JAtlas([jm]), 1000,
                      **SMALL_CAPS)
    jl.local_ba(kf)
    j = mapstore_to_numpy(jm)
    pcfg = dataclasses.replace(mapper_config(PSensor.MONOCULAR),
                               slam_mode=mode)
    out = {}
    for dt in (torch.float32, torch.float64):
        m = mapstore_from_numpy(arrays)
        mp = LocalMapper(pcfg, Atlas([m]), 1000, **SMALL_CAPS, device="cpu",
                         dtype=dt)
        mp.local_ba(kf)
        assert mp.ba_path == "lines"
        out[dt] = mapstore_to_numpy(m)
    p, p64 = out[torch.float32], out[torch.float64]
    for k in ("kf_match_pt", "pt_valid", "pt_n_obs", "kf_match_ln",
              "ln_valid"):
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    np.testing.assert_array_equal(p["pt_xyz"], arrays["pt_xyz"])
    v = p["ln_valid"]
    for key, sel in (("kf_pose_cw", p["kf_valid"]), ("ln_ep", v)):
        gj = float(np.abs(j[key][sel] - p64[key][sel]).max())
        gp = float(np.abs(p[key][sel] - p64[key][sel]).max())
        print(f"mode {mode} {key}: port {gp:.2e}, JAX {gj:.2e} from the "
              "port in float64")
        assert gp <= 2 * gj + 1e-4, key


# SLAM mode 3 on the MH replay at production's sizes, on the port's
# features: the first line-only pose solve comes at frame 79 and the first
# line-only window BA at frame 83
SYSTEM_START, SYSTEM_FRAMES = 70, 16


@pytest.mark.slow
def test_line_mode_system_as_reference():
    """(e) `System` under SLAM mode 3 through the public `track_monocular`
    at production's sizes (loop closing off), against the JAX `System` fed
    the port's features: JAX from frame 0, the port from the JAX run's
    state at frame SYSTEM_START up to the frame whose keyframe step runs
    the first line-only window BA (on the port's features: frame 83, the
    line-only pose solves from frame 79); every frame's state, inliers,
    keyframes made and the map's counts equal, poses within 1e-4 before
    that frame.  There the runs part: the frame's pose follows the
    keyframes the BA moved, its float32 rounding ~1e-3 on either side.
    Slow: ~85 JAX frames and ~13 of the port at full size."""
    from test_torch_system import _record, jax_layout, jax_track, \
        jit_reconstruction
    from plvio_tpu.models.system import System as JSystem
    from plvio_tpu_torch.entry import line_mode_replay
    from plvio_tpu_torch.state import (load_kfdb_state, load_mapper_state,
                                       load_tracker_state, mapper_state,
                                       mapstore_from_numpy,
                                       mapstore_to_numpy, kfdb_state,
                                       tracker_state)
    n = SYSTEM_START + SYSTEM_FRAMES
    run, S = line_mode_replay(3, device="cpu", use_loop_closing=False,
                              replay_kw=dict(n_frames=n))
    port = run.new_system()
    feats = []

    def capture(f, lf, *a, **kw):
        feats.append((f, lf))
    port.track_features = capture
    with torch.no_grad():
        for i in range(n):
            port.track_monocular(S["frames"][i], float(S["timestamps"][i]))
    del port.track_features
    js = JSystem(line_mode_config(3, use_loop_closing=False))
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
    calls = {"lo": 0, "ba": 0}
    lo = port.tracker.pose_opt_line_only
    ba = port.mapper.local_ba_lines_kernel

    def lo_counted(*a):
        calls["lo"] += 1
        return lo(*a)

    def ba_counted(*a, **kw):
        calls["ba"] += 1
        return ba(*a, **kw)
    port.tracker.pose_opt_line_only = lo_counted
    port.mapper.local_ba_lines_kernel = ba_counted
    orig = jit_reconstruction()
    worst, last = 0.0, -1
    try:
        for i, (f, lf) in enumerate(feats):
            t = float(S["timestamps"][i])
            if i == SYSTEM_START:
                port.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(port.mapper, mapper_state(js.mapper))
                load_tracker_state(port.tracker, tracker_state(js.tracker))
                load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
            n0 = len(js.processed)
            jf, jl = jax_layout(f, lf)
            jax_track(js, jf, jl, t, None)
            if i < SYSTEM_START:
                continue
            j = _record(js.tracker, js.processed[n0:])
            del made_p[:]
            with torch.no_grad():
                port.track_features(f, lf, t, None)
            p = _record(port.tracker, made_p)
            d = None if j["pose"] is None else \
                float(np.abs(p["pose"] - j["pose"]).max())
            print(f"  frame {i}: made {j['made']}, inliers {j['inliers']}, "
                  f"counts {j['counts']}, line-only solves {calls['lo']}, "
                  f"pose gap {d}")
            for k in ("state", "made", "inliers", "counts"):
                assert p[k] == j[k], (i, k, p[k], j[k])
            if calls["ba"]:
                # the frame whose keyframe step ran the first line-only
                # window BA: the frame's pose is brought to the keyframes
                # that BA moved, which carry its float32 rounding (test_
                # mapper_line_only_ba_matches_reference: ~4e-3 from float64
                # on either side), so the runs part here
                last = i
                break
            if d is not None:
                worst = max(worst, d)
                assert d <= 1e-4, (i, d)
    finally:
        from plvio_tpu.ops import twoview as JTV
        JTV.reconstruct_two_views = orig
    print(f"SLAM mode 3 System: frames {SYSTEM_START}..{last}, line-only "
          f"pose solves {calls['lo']}, line-only window BAs {calls['ba']}, "
          f"largest pose difference {worst:.2e}")
    assert calls["lo"] > 0 and calls["ba"] > 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed"]:
        print("LINE_MODE_SEED = " + json.dumps(reference_line_mode(
            int(sys.argv[4]), int(sys.argv[2]))))
    else:
        from test_torch_kb8_inertial import seed_ranges
        ref = {m: seed_ranges(__file__, ["--mode", str(m)],
                              "LINE_MODE_SEED = ") for m in (1, 2, 3)}
        print("REF_LINE_MODES = " + json.dumps(ref))
