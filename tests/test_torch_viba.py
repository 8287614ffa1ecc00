"""The full-map visual-inertial BA (`LocalMapper.full_inertial_ba` and the
pulse's `_viba_pulse_step`) against the JAX package on the CPU, on maps of
`inputs.build_inertial_map` (the sequence of `build_keyframe_sequence`
with 256 point features, in the metric gravity-aligned frame after IMU
init): a chain of 26 keyframes, above the one-block solve's 22 (the card
takes schur_solve's global path there), in one window, and a chain of 40,
longer than the window, in the block schedule with its frozen halos.  The
window is cut to 32 KF x 1024 points x 2048 observations + 128 lines /
256 line observations on both sides (`viba_*_cap`, set before the first
use).  A float64 run of the port's plain path (`LocalMapper(dtype=
torch.float64)`) from the same map is the yardstick.

Tolerances, and why: bindings, live sets and the pulse's schedule equal
(the erase gate's chi2 decisions); keyframe poses, velocities, biases and
map points bound in >= 3 keyframes within 2x JAX's distance to the
float64 run plus float32 floors (1e-4 a pose entry and m/s, 1e-6 rad/s,
1e-5 m/s^2, 1e-3 a point coordinate), the rule of the keyframe step's
tests (tests/test_torch_keyframe_step.py).  A point left with one inlier
observation after the chi2 gate (a 2-view point one of whose
observations is an outlier) has no depth but the damping's: it moves
metres, differently in every precision, so its position is not held.
"""
import numpy as np
import pytest
import torch

from plvio_tpu.config import CameraConfig, ImuConfig, Sensor, SystemConfig
from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plvio_tpu.models.mapstore import Atlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu_torch.entry import KeyframeSequence
from plvio_tpu_torch.inputs import build_inertial_map, build_keyframe_sequence
from plvio_tpu_torch.models import mapstore as MS
from plvio_tpu_torch.state import mapstore_to_numpy

STORE = dict(max_kf=48, max_pts=8192, max_lines=2048)
VIBA = dict(viba_kf_cap=32, viba_pt_cap=1024, viba_obs_cap=2048,
            viba_ln_cap=128, viba_lobs_cap=256)
JCFG = SystemConfig(sensor=Sensor.IMU_MONOCULAR, use_lines=True,
                    camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                    imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
FLOOR = {"kf_pose_cw": 1e-4, "kf_vel": 1e-4, "kf_bias_g": 1e-6,
         "kf_bias_a": 1e-5, "pt_xyz": 1e-3}
EXACT = ("kf_valid", "kf_match_pt", "pt_valid", "pt_n_obs", "kf_match_ln",
         "ln_valid")


def jax_store(a):
    m = JMapStore(max_kf=a["max_kf"], max_pts=a["max_pts"],
                  max_lines=a["max_lines"], n_feat=a["n_feat"],
                  n_line_feat=a["n_line_feat"])
    for k in MS.ARRAYS:
        setattr(m, k, np.array(a[k]))
    for k in ("n_kf", "n_pt", "n_ln", "change_index"):
        setattr(m, k, int(a[k]))
    m.imu_initialized = m.imu_ba1 = True
    from plvio_tpu_torch.ops.imu import Preintegrated
    m.kf_preint = {k: Preintegrated(**v) for k, v in a["kf_preint"].items()}
    m.kf_imu_raw = dict(a["kf_imu_raw"])
    return m


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def maps():
    seq = build_keyframe_sequence(0, n_kf=40, n_feat=256)
    return {n: mapstore_to_numpy(build_inertial_map(seq, n, STORE))
            for n in (26, 40)}


@pytest.fixture(scope="module")
def jl():
    m = JMapStore(max_kf=1, max_pts=1, max_lines=1, n_feat=1, n_line_feat=1)
    jl = JLocalMapper(JCFG, Atlas([m]), 256)
    for k, v in VIBA.items():
        setattr(jl, k, v)
    return jl


def port(a, dtype=torch.float32):
    from plvio_tpu_torch.state import mapstore_from_numpy
    mp = KeyframeSequence(plain=True, device="cpu",
                          viba_caps=VIBA).new_mapper()
    mp.dtype = dtype
    mp.map = mapstore_from_numpy(a)
    return mp


def held(p, j, r, tag):
    """The port's store against JAX's under the float64 rule."""
    for k in EXACT:
        np.testing.assert_array_equal(p[k], j[k], err_msg=f"{tag} {k}")
    out = {}
    for k, fl in FLOOR.items():
        sel = j["kf_valid"] if k.startswith("kf_") else \
            j["pt_valid"] & (j["pt_n_obs"] >= 3)
        dp = float(np.abs(p[k][sel].astype(np.float64) - r[k][sel]).max())
        dj = float(np.abs(j[k][sel].astype(np.float64) - r[k][sel]).max())
        out[k] = (dp, dj)
        assert dp <= 2 * dj + fl, (tag, k, dp, dj)
    print(tag, out)


@pytest.mark.parametrize("entry", ["full_inertial_ba", "_viba_pulse_step"])
def test_one_window(maps, jl, entry):
    """A chain of 26 keyframes in one full-map window (every keyframe free
    but the oldest): the port against JAX; the pulse step completes at
    once."""
    a = maps[26]
    jl.atlas = Atlas([jax_store(a)])
    runs = [port(a), port(a, torch.float64)]
    for mp in [jl] + runs:
        if entry == "full_inertial_ba":
            mp.full_inertial_ba()
        else:
            st = {}
            assert mp._viba_pulse_step(st) is True
    j, p, r = (mapstore_to_numpy(mp.map) for mp in [jl] + runs)
    assert float(np.abs(p["kf_pose_cw"] - a["kf_pose_cw"]).max()) > 1e-4
    held(p, j, r, entry)


def test_block_schedule(maps, jl):
    """A chain of 40, longer than the 32-keyframe window: the pulse queues
    2 sweeps x 2 blocks of 28 free keyframes with 2 frozen halo keyframes
    each side and runs one block a call; after every call the port holds
    to JAX, the queue equal; full_inertial_ba runs the same schedule in
    one call."""
    a = maps[40]
    jl.atlas = Atlas([jax_store(a)])
    runs = [port(a), port(a, torch.float64)]
    sts = [{}, {}, {}]
    done = [False] * 3
    calls = 0
    while not done[0]:
        done = [mp._viba_pulse_step(st) for mp, st in zip([jl] + runs, sts)]
        calls += 1
        assert done[1] == done[0] and sts[1].get("pulse_blocks") == \
            sts[0].get("pulse_blocks")
        j, p, r = (mapstore_to_numpy(mp.map) for mp in [jl] + runs)
        held(p, j, r, f"pulse call {calls}")
    assert calls == 4
    jl.atlas = Atlas([jax_store(a)])
    runs = [port(a), port(a, torch.float64)]
    for mp in [jl] + runs:
        mp.full_inertial_ba()
    j, p, r = (mapstore_to_numpy(mp.map) for mp in [jl] + runs)
    held(p, j, r, "full_inertial_ba blocks")
