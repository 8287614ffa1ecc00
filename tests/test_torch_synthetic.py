"""The port's own copies of the JAX package's host modules, held to them:
`plvio_tpu_torch.io.synthetic` (scene, orbit, projections, rendered frames
bit for bit) and `plvio_tpu_torch.config.ImuConfig` (every default)."""
import dataclasses

import numpy as np
import pytest

from plvio_tpu import config as JC
from plvio_tpu.io import synthetic as JS
from plvio_tpu_torch import config as TC
from plvio_tpu_torch.io import synthetic as TS

K = (458.654, 457.296, 367.215, 248.375)


@pytest.fixture(scope="module")
def scenes():
    return (JS.make_room_scene(np.random.default_rng(0), 300, 20),
            TS.make_room_scene(np.random.default_rng(0), 300, 20))


def test_imu_config_defaults_match():
    j, t = JC.ImuConfig(), TC.ImuConfig()
    names = [f.name for f in dataclasses.fields(TC.ImuConfig)]
    assert names == ["noise_gyro", "noise_acc", "gyro_walk", "acc_walk",
                     "frequency", "Tbc", "gravity"]
    for n in names:
        assert getattr(t, n) == getattr(j, n), n
    assert (t.Tbc_matrix() == j.Tbc_matrix()).all()
    assert TC.ImuConfig(gravity=9.0).gravity == 9.0


def test_room_scene_matches(scenes):
    j, t = scenes
    for f in dataclasses.fields(JS.Scene):
        assert np.array_equal(getattr(j, f.name), getattr(t, f.name)), f.name
    assert TS.GRAVITY == JS.GRAVITY


@pytest.mark.parametrize("radius", [0.6, 1.5])
def test_orbit_matches(radius):
    j = JS.make_orbit_trajectory(duration=1.0, fps=20.0, radius=radius)
    t = TS.make_orbit_trajectory(duration=1.0, fps=20.0, radius=radius)
    for f in ("timestamps", "R_wb", "p_wb", "v_wb"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    ts = np.linspace(0.0, 2.0, 7)
    assert np.array_equal(JS._eval_orbit(ts, radius, 0.3, 0.45).R_wb,
                          TS._eval_orbit(ts, radius, 0.3, 0.45).R_wb)


def test_projections_and_frames_match(scenes):
    pytest.importorskip("cv2")
    j, t = scenes
    traj = JS.make_orbit_trajectory(duration=0.3, fps=20.0, radius=0.6)
    for i in range(len(traj.timestamps)):
        R, p = traj.R_wb[i], traj.p_wb[i]
        pj = JS.project_scene(j, R, p, *K, 376, 240)
        pt = TS.project_scene(t, R, p, *K, 376, 240)
        for a, b in zip(pj, pt):
            assert np.array_equal(a, b)
        fj = JS.render_frame(j, R, p, width=376, height=240,
                             rng=np.random.default_rng(i))
        ft = TS.render_frame(t, R, p, width=376, height=240,
                             rng=np.random.default_rng(i))
        assert fj.dtype == ft.dtype and np.array_equal(fj, ft)
    assert TS.SyntheticImu.__dataclass_fields__.keys() \
        == JS.SyntheticImu.__dataclass_fields__.keys()
