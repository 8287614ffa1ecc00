"""Trajectory evaluation of the port (`io/trajectory`: associate, umeyama,
ate_rmse) against the JAX package's on the same trajectories: a Sim3-
distorted noisy copy of an orbit with dropped and jittered timestamps, a
few non-finite estimates and the too-short case.  Equal to 1e-12
relative: both are the same float64 numpy."""
import numpy as np
import pytest

from plvio_tpu.io import trajectory as JT
from plvio_tpu_torch.io import trajectory as PT


def _case(seed, n=120):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.05
    p = np.stack([np.cos(t), np.sin(t), 0.2 * np.sin(2 * t)], -1)
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    est = 0.7 * p @ R.T + np.array([0.5, -0.2, 1.0]) \
        + rng.normal(0, 0.01, p.shape)
    keep = rng.random(n) > 0.2
    te = t[keep] + rng.uniform(-0.015, 0.015, keep.sum())
    est = est[keep]
    est[3] = np.nan
    q = np.zeros((len(te), 4))
    return (te, est, q), (t, p, np.zeros((n, 4)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_rmse_matches_reference(seed, with_scale):
    (te, est, q), (t, p, qg) = _case(seed)
    got = PT.ate_rmse(PT.Trajectory(te, est, q), PT.Trajectory(t, p, qg),
                      with_scale)
    ref = JT.ate_rmse(JT.Trajectory(te, est, q), JT.Trajectory(t, p, qg),
                      with_scale)
    assert np.isfinite(got) and abs(got - ref) <= 1e-12 * ref
    ia, ib = PT.associate(te, t)
    ja, jb = JT.associate(te, t)
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_array_equal(ib, jb)
    ok = np.isfinite(est[ia]).all(1)
    for s_p, s_j in zip(PT.umeyama(est[ia][ok], p[ib][ok], with_scale),
                        JT.umeyama(est[ia][ok], p[ib][ok], with_scale)):
        np.testing.assert_allclose(s_p, s_j, rtol=1e-12, atol=1e-12)


def test_ate_rmse_too_few_pairs():
    t = np.array([0.0, 1.0])
    p = np.zeros((2, 3))
    q = np.zeros((2, 4))
    assert PT.ate_rmse(PT.Trajectory(t, p, q), PT.Trajectory(t, p, q)) \
        == JT.ate_rmse(JT.Trajectory(t, p, q), JT.Trajectory(t, p, q)) \
        == float("inf")
