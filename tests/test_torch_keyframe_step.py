"""Slice 7, the whole keyframe step (`LocalMapper.process_keyframe`),
against the JAX package on the CPU, over a short keyframe sequence of
`inputs.build_keyframe_sequence` at a reduced size: 256 point features a
keyframe, a store of 16 keyframes / 4096 points / 1024 lines (so that the
capacity sweep of `cull_keyframes` culls keyframes, with the inertial
merge, from the 14th keyframe on), the point and inertial BA windows at 16
KF x 1024 points x 2048 observations (lines 512 / 1024 and 256 / 512),
the full-map window at 32 KF x 1024 x 2048 + 128 / 256, IMU init cap 32.

Teacher-forced: the JAX mapper runs the sequence freely (the tracker
stand-in `inputs.insert_keyframe` on its store, its pending transforms
composed); before each of its steps the JAX store and mapper state go to
the port's mapper (plain path) through `state.mapstore_from_numpy` /
`state.load_mapper_state`, both run the step, and the two stores and
mapper states after it are compared.  A float64 run of the port's plain
path from the same state (`LocalMapper(dtype=torch.float64)`) is the
yardstick at the steps that solve something inertial.  One free-running
port run over the whole sequence is held to the JAX run.

Tolerances, and why:
- counts, bindings (`kf_match_pt`, `kf_match_ln`, `pt_n_obs`,
  `ln_n_obs`), the live sets, the culled keyframes, the IMU stages and
  the mapper's host state are equal: every decision of the step is a
  count or a threshold that float32 rounding does not reach on this
  sequence (the erase gate's chi2 of 5.991 is the closest);
- at the IMU init, the first refinement and a LIBA step: keyframe
  poses, velocities and biases (and the map points bound in >= 3
  keyframes: a point left with one inlier observation has no depth but
  the damping's) within 2x JAX's own distance to the float64 run plus a
  float32 floor (1e-4 a pose entry and m/s, 1e-6 rad/s, 1e-5 m/s^2, 1e-3
  a point coordinate), the rule of the inertial window in slice 4 (120
  fixed CG steps on an ill-conditioned system put each float32 path
  ~1e-3 from float64); at every step the poses within 1e-2 of JAX's;
- the IMU init's scale and gravity rotation within 2x JAX's distance to
  the float64 run plus 1e-4, and the windows it reintegrates (at each
  run's own biases) within 2x plus 1e-5;
- free-running: the IMU initializes at the same keyframe, keyframes,
  points and lines alive at the end within 5%, the scale against the
  truth and the Sim3 ATE within 2x JAX's error plus 2 mm.

Run as a script it prints REF_SEQ for chip_smoke.py, the JAX mapper over
`build_keyframe_sequence(0)` at production's sizes on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_keyframe_step.py
"""
import json
import sys
import time

import numpy as np
import pytest
import torch

from plvio_tpu.config import CameraConfig, ImuConfig, Sensor, SystemConfig
from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plvio_tpu.models.mapstore import Atlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu_torch.entry import (KeyframeSequence, gravity_error_deg,
                                   keyframe_sequence, sequence_ate,
                                   sequence_scale)
from plvio_tpu_torch.inputs import (build_keyframe_sequence,
                                    compose_transform, insert_keyframe,
                                    start_keyframe_map)
from plvio_tpu_torch.state import (load_mapper_state, mapper_state,
                                   mapstore_from_numpy, mapstore_to_numpy)

N_KF = 17
N_FEAT = 256
STORE = dict(max_kf=16, max_pts=4096, max_lines=1024)
CAPS = dict(ba_kf_cap=16, ba_pt_cap=1024, ba_obs_cap=2048)
VIBA = dict(viba_kf_cap=32, viba_pt_cap=1024, viba_obs_cap=2048,
            viba_ln_cap=128, viba_lobs_cap=256)
JCFG = SystemConfig(sensor=Sensor.IMU_MONOCULAR, use_lines=True,
                    camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                    imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
EXACT = ("kf_valid", "kf_match_pt", "kf_match_ln", "kf_prev", "kf_next",
         "pt_valid", "ln_valid", "pt_n_obs", "ln_n_obs", "pt_found",
         "pt_visible", "ln_found", "ln_visible", "covis")
FLOOR = {"kf_pose_cw": 1e-4, "kf_vel": 1e-4, "kf_bias_g": 1e-6,
         "kf_bias_a": 1e-5, "pt_xyz": 1e-3}


def jax_mapper(n_feat, store, caps, viba):
    """The JAX LocalMapper (mono-inertial, lines, no distortion, body =
    camera) on a fresh JAX store of the given capacities."""
    jm = JMapStore(n_feat=n_feat, n_line_feat=256, **store)
    jl = JLocalMapper(JCFG, Atlas([jm]), n_feat, **caps)
    for k, v in viba.items():
        setattr(jl, k, v)
    return jl


def port_mapper(dtype=torch.float32):
    step = KeyframeSequence(plain=True, device="cpu", store=STORE, caps=CAPS,
                            viba_caps=VIBA)
    mp = step.new_mapper()
    mp.dtype = dtype
    return mp


class Calls:
    """Wraps a mapper's methods to count, in one step, their calls and
    what they removed: points and lines by the culls, bindings by the
    window's outlier erasure."""
    NAMES = ("maybe_initialize_imu", "refine_scale", "_liba_window",
             "local_ba", "cull_points", "cull_lines", "_do_cull",
             "_merge_imu_into_next", "_erase_window_outliers",
             "_viba_pulse_step")
    EFFECT = {"cull_points": lambda m: m.n_pt,
              "cull_lines": lambda m: m.n_ln,
              "_erase_window_outliers":
              lambda m: int((m.kf_match_pt >= 0).sum())}

    def __init__(self, mp):
        self.n = {}
        for name in self.NAMES:
            fn = getattr(mp, name)
            eff = self.EFFECT.get(name, lambda m: 0)

            def wrap(*a, _fn=fn, _name=name, _eff=eff, **kw):
                before = _eff(mp.map)
                out = _fn(*a, **kw)
                self.n[_name] = self.n.get(_name, 0) + 1
                key = _name + " removed"
                self.n[key] = self.n.get(key, 0) + before - _eff(mp.map)
                return out
            setattr(mp, name, wrap)


def run_forced(seq, n_f64=()):
    """The teacher-forced run: per step (i, kf, the JAX store after,
    the port's, the float64 port's (steps in n_f64), the mapper states,
    the culled ids, the JAX calls)."""
    jl = jax_mapper(N_FEAT, STORE, CAPS, VIBA)
    jm = jl.map
    jcalls = Calls(jl)
    track = start_keyframe_map(jm, seq)
    recs = []
    for i in range(2, len(seq["t_kf"])):
        kf = insert_keyframe(jm, seq, i, track)
        before, st = mapstore_to_numpy(jm), mapper_state(jl)
        outs = {}
        for name, dt in (("port", torch.float32), ("f64", torch.float64)):
            if name == "f64" and i not in n_f64:
                continue
            mp = port_mapper(dt)
            mp.map = mapstore_from_numpy(before)
            load_mapper_state(mp, st)
            culled = mp.process_keyframe(kf)
            outs[name] = (mapstore_to_numpy(mp.map), mapper_state(mp),
                          [c[0] for c in culled], mp)
        jcalls.n = {}
        culled = jl.process_keyframe(kf)
        recs.append(dict(i=i, kf=kf, jax=mapstore_to_numpy(jm),
                         jst=mapper_state(jl), jculled=[c[0] for c in culled],
                         calls=dict(jcalls.n), before=before, **outs))
        if jl.pending_transform is not None:
            compose_transform(track, jl.pending_transform)
            jl.pending_transform = None
    return recs, jm, track


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return build_keyframe_sequence(0, n_kf=N_KF, n_feat=N_FEAT)


@pytest.fixture(scope="module")
def forced(seq):
    # the float64 yardstick where something inertial is solved: IMU init
    # (13), the first refinement pulse (15) and a plain LIBA step (16)
    recs, jm, track = run_forced(seq, n_f64=(13, 15, 16))
    return dict(recs=recs, jm=jm, track=track)


def _f64_check(rec, keys=("kf_pose_cw", "kf_vel", "kf_bias_g",
                          "kf_bias_a")):
    """Every float field of `keys` within 2x JAX's distance to the float64
    run plus its floor, on the live keyframes / points."""
    j, p, r = rec["jax"], rec["port"][0], rec["f64"][0]
    kv = j["kf_valid"]
    out = {}
    for k in keys + ("pt_xyz",):
        sel = kv if k.startswith("kf_") else \
            j["pt_valid"] & (j["pt_n_obs"] >= 3)
        dj = float(np.abs(j[k][sel].astype(np.float64)
                          - r[k][sel]).max(initial=0.0))
        dp = float(np.abs(p[k][sel].astype(np.float64)
                          - r[k][sel]).max(initial=0.0))
        out[k] = (dp, dj)
        assert dp <= 2 * dj + FLOOR[k], (rec["i"], k, dp, dj)
    return out


def test_each_step_matches_reference(forced):
    """Every step: the store's decisions equal, the floats within the
    float64 rule where measured, else within 1e-2 of JAX's."""
    for rec in forced["recs"]:
        j, p = rec["jax"], rec["port"][0]
        for k in EXACT:
            np.testing.assert_array_equal(p[k], j[k],
                                          err_msg=f"{rec['i']} {k}")
        for k in ("n_kf", "n_pt", "n_ln", "imu_initialized", "imu_ba1",
                  "imu_ba2"):
            assert p[k] == j[k], (rec["i"], k)
        assert rec["port"][2] == rec["jculled"], rec["i"]
        ps, js = rec["port"][1], rec["jst"]
        assert ps["kf_since_init"] == js["kf_since_init"]
        assert ps["viba"].keys() == js["viba"].keys()
        for a, b in zip(ps["recent_pts"] + ps["recent_lns"],
                        js["recent_pts"] + js["recent_lns"]):
            np.testing.assert_array_equal(a, b)
        assert set(p["kf_preint"]) == set(j["kf_preint"])
        kv = j["kf_valid"]
        assert float(np.abs(p["kf_pose_cw"][kv]
                            - j["kf_pose_cw"][kv]).max()) <= 1e-2, rec["i"]


def test_inertial_steps_within_float64_rule(forced):
    """IMU init, the first refinement and a LIBA step: poses, velocities,
    biases and points within 2x JAX's distance to the float64 run."""
    seen = 0
    for rec in forced["recs"]:
        if "f64" in rec:
            print(rec["i"], _f64_check(rec))
            seen += 1
    assert seen == 3


def test_imu_init_step(forced):
    """The step that initializes: the init call, its map transform (scale
    and gravity rotation) and the reintegrated windows."""
    rec = next(r for r in forced["recs"] if r["jax"]["imu_initialized"]
               and not r["before"]["imu_initialized"])
    assert rec["i"] == 13
    ps, js, rs = rec["port"][1], rec["jst"], rec["f64"][1]
    pt, jt, rt = (s["pending_transform"] for s in (ps, js, rs))
    for a, b, r in ((pt[1], jt[1], rt[1]), (pt[0], jt[0], rt[0])):
        dp = float(np.abs(np.asarray(a, np.float64) - r).max())
        dj = float(np.abs(np.asarray(b, np.float64) - r).max())
        assert dp <= 2 * dj + 1e-4, (dp, dj)
    # the windows reintegrated at each run's own biases
    j, p, r = rec["jax"], rec["port"][0], rec["f64"][0]
    for kf, pre in j["kf_preint"].items():
        for f, v in pre.items():
            ref = np.asarray(r["kf_preint"][kf][f], np.float64)
            dp = float(np.abs(p["kf_preint"][kf][f] - ref).max())
            dj = float(np.abs(v - ref).max())
            assert dp <= 2 * dj + 1e-5, (kf, f, dp, dj)
    assert rec["calls"]["_liba_window"] >= 1


def test_every_branch_is_exercised(forced):
    """The short sequence reaches each method the slice ports: IMU init,
    a LIBA step with lines, a refinement pulse, keyframe culls with the
    inertial merge, point and line culls, and the window's outlier
    erasure unbinding something."""
    calls = {}
    for rec in forced["recs"]:
        for k, v in rec["calls"].items():
            calls[k] = calls.get(k, 0) + v
    print(calls)
    assert calls.get("maybe_initialize_imu", 0) >= 1
    assert calls.get("refine_scale", 0) >= 1
    assert calls.get("_do_cull", 0) >= 1
    assert calls.get("_merge_imu_into_next", 0) >= 1
    assert calls.get("cull_points removed", 0) > 0
    assert calls.get("cull_lines removed", 0) > 0
    assert calls.get("_erase_window_outliers removed", 0) > 0
    lines = [r for r in forced["recs"] if r["jax"]["imu_initialized"]
             and (r["jax"]["ln_n_obs"][r["jax"]["ln_valid"]] >= 3).sum()]
    assert lines


def test_free_running_sequence(seq, forced):
    """The port's plain path over the whole short sequence on its own,
    held to the JAX run."""
    step, _ = keyframe_sequence(0, device="cpu", plain=True, store=STORE,
                                caps=CAPS, viba_caps=VIBA,
                                seq_kw=dict(n_kf=N_KF, n_feat=N_FEAT))
    out = step(seq)
    jm, track = forced["jm"], forced["track"]
    j_init = next(r["i"] for r in forced["recs"]
                  if r["jax"]["imu_initialized"])
    assert out.init_kf == j_init
    m = out.map
    for a, b in ((m.n_kf, jm.n_kf), (m.n_pt, jm.n_pt), (m.n_ln, jm.n_ln)):
        assert abs(a - b) <= 0.05 * b, (a, b)
    j_scale = sequence_scale(jm, seq)
    j_ate = sequence_ate(jm, seq)[0]
    print(f"port scale {out.scale:.4f} ate {out.ate_sim3:.4f}; JAX scale "
          f"{j_scale:.4f} ate {j_ate:.4f}; gravity {out.gravity_err_deg:.3f}"
          f" / {gravity_error_deg(jm, seq, track):.3f} deg")
    assert abs(out.scale - 1) <= 2 * abs(j_scale - 1) + 2e-3
    assert out.ate_sim3 <= 2 * j_ate + 2e-3
    assert all(s.host_syncs == 0 for s in out.steps)   # the CPU reads none


def reference_seq():
    """REF_SEQ: the JAX mapper over build_keyframe_sequence(0) at
    production's sizes (1000 features, store 512 / 16384 / 2048, the
    windows' production caps)."""
    seq = build_keyframe_sequence(0)
    jl = jax_mapper(1000, {}, {}, {})
    jm = jl.map
    track = start_keyframe_map(jm, seq)
    init_kf, init_scale, t0 = -1, 0.0, time.time()
    viba = [0, 0]

    def count(fn):
        def wrap(win, free, big=False, **kw):
            if big:
                viba[0] += 1
                viba[1] = max(viba[1], len(win))
            return fn(win, free, big, **kw)
        return wrap
    jl._liba_window = count(jl._liba_window)
    for i in range(2, len(seq["t_kf"])):
        kf = insert_keyframe(jm, seq, i, track)
        was = jm.imu_initialized
        jl.process_keyframe(kf)
        if jm.imu_initialized and not was:
            init_kf = i
            init_scale = float(jl.pending_transform[1])
        if jl.pending_transform is not None:
            compose_transform(track, jl.pending_transform)
            jl.pending_transform = None
        print(f"  {i}: kf {jm.n_kf} pts {jm.n_pt} lines {jm.n_ln} "
              f"({time.time() - t0:.0f} s)", file=sys.stderr, flush=True)
    ate = sequence_ate(jm, seq)
    return {"init_kf": init_kf, "init_scale": init_scale,
            "inv_lam": 1.0 / seq["lam"], "keyframes": int(jm.n_kf),
            "points": int(jm.n_pt), "lines": int(jm.n_ln),
            "scale": sequence_scale(jm, seq),
            "gravity_err_deg": gravity_error_deg(jm, seq, track),
            "viba_solves": viba[0], "viba_window": viba[1],
            "ate_sim3": ate[0], "ate_se3": ate[1]}


if __name__ == "__main__":
    print("REF_SEQ = " + json.dumps(reference_seq()))
