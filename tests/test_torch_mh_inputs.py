"""Slice 9, the MH replay's generators, against the JAX package's.

`io/synthetic.py`'s MH part (`make_hall_scene`, `make_mh_trajectory`,
`_eval_mh`, `_eval_mh_loop`, `synthesize_imu_mh`,
`render_frame_realistic`) and `inputs.build_mh_replay` against
plvio_tpu/io/synthetic.py on the same seed, at a small size: a hall of 500
points and 50 lines, 1 s, 3 frames rendered.

Tolerances, and why:
- scene, trajectories, accelerometer, biases and images are bit-equal:
  the same numpy and cv2 calls consume the one generator in the same
  order;
- the gyro within GYRO_TOL (1e-6 rad/s): its body rates come from
  so3_log of float32 rotations, the port's torch one against JAX's; the
  two differ by float32 rounding of the rotation angle: 2.3e-8 rad/s
  here.
"""
import numpy as np
import pytest

from plvio_tpu.io import synthetic as JSYN
from plvio_tpu_torch.inputs import build_mh_replay
from plvio_tpu_torch.io import synthetic as SYN

GYRO_TOL = 1e-6


@pytest.fixture(scope="module")
def both():
    out = []
    for syn in (JSYN, SYN):
        rng = np.random.default_rng(7)
        scene = syn.make_hall_scene(rng, n_points=500, n_lines=50)
        traj = syn.make_mh_trajectory(1.3, fps=20.0)
        imu = syn.synthesize_imu_mh(rng, 1.3)
        imgs = [syn.render_frame_realistic(scene, syn._eval_mh, t, rng)
                for t in traj.timestamps[:3]]
        out.append((scene, traj, imu, imgs))
    return out


def test_scene_equal(both):
    (sj, _, _, _), (sp, _, _, _) = both
    for k in ("points", "lines", "point_polarity", "line_polarity",
              "texture_dots", "texture_intensity"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(sj, k),
                                      err_msg=k)


@pytest.mark.parametrize("fn", ["_eval_mh", "_eval_mh_loop"])
def test_trajectories_equal(fn):
    t = np.linspace(0.0, 30.0, 601)
    tj, tp = getattr(JSYN, fn)(t), getattr(SYN, fn)(t)
    for k in ("timestamps", "R_wb", "p_wb", "v_wb"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(tj, k))
    np.testing.assert_array_equal(SYN._eval_mh_loop_pos(t),
                                  JSYN._eval_mh_loop_pos(t))


def test_imu_equal(both):
    (_, _, ij, _), (_, _, ip, _) = both
    for k in ("timestamps", "acc", "bias_gyro", "bias_acc"):
        np.testing.assert_array_equal(getattr(ip, k), getattr(ij, k))
    gap = float(np.abs(ip.gyro - ij.gyro).max())
    print(f"gyro gap {gap:.3e} rad/s")
    assert gap <= GYRO_TOL


def test_frames_equal(both):
    (_, _, _, fj), (_, _, _, fp) = both
    for a, b in zip(fp, fj):
        assert a.dtype == np.float32 and a.shape == (480, 752)
        np.testing.assert_array_equal(a, b)


def test_build_mh_replay(both):
    """The replay's frames, batches and truth: the regression test's
    arrangement (tests/test_mh_replay_regression.py:26-48)."""
    (_, tj, ij, fj), _ = both
    S = build_mh_replay(1.0, n_points=500, n_lines=50, n_frames=3)
    assert len(S["frames"]) == 3 and S["imu"][0] is None
    for a, b in zip(S["frames"], fj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(S["p_wc"], tj.p_wb[:3])
    last = tj.timestamps[0]
    for i in (1, 2):
        t = tj.timestamps[i]
        sel = (ij.timestamps > last) & (ij.timestamps <= t)
        g, a, d = S["imu"][i]
        np.testing.assert_array_equal(a, ij.acc[sel])
        assert np.abs(g - ij.gyro[sel]).max() <= GYRO_TOL
        np.testing.assert_array_equal(
            d, np.diff(np.concatenate([[last], ij.timestamps[sel]])))
        last = t
