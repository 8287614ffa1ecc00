"""Parity of the port's IMU stage (plain version, CPU) with
plvio_tpu.ops.imu: `preintegrate` over padded sample windows with non-zero
biases, `predict_state`, and the inertial edge's information
inv(C[:9,:9] + 1e-8 I) as __graft_entry__._tracking_step_vi_fn forms it.

Tolerances: deltas and bias Jacobians within 1e-5 relative to each
field's largest entry (float32, the same operation order; one-ulp
differences of sin/cos between the two libraries), the covariance within
1e-5 relative, and imu_info within 1e-4 relative Frobenius (both invert
by LU in float32).

Also the VI frame's IMU windows (`inputs.build_imu_windows`, which carries
its own JAX-free copy of `synthesize_imu`) against the windows bench.py
builds with plvio_tpu.io.synthetic.synthesize_imu: gyro within 1e-6
rad/s (the two float32 rotation logs differ in the last bits, divided by
2 dt), acc, dts and the frame-0 carry equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plvio_tpu.config import ImuConfig
from plvio_tpu.io import synthetic as syn
from plvio_tpu.ops import imu as JI
from plvio_tpu.utils import lie as JL
from plvio_tpu_torch.inputs import build_imu_windows
from plvio_tpu_torch.ops import imu as TI


def _window(seed, k, n_valid):
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0, 0.5, (k, 3)).astype(np.float32)
    acc = (rng.normal(0, 1.0, (k, 3)) + [0, 0, 9.81]).astype(np.float32)
    dt = rng.uniform(0.004, 0.006, k).astype(np.float32)
    mask = np.arange(k) < n_valid
    bg = rng.normal(0, 0.02, 3).astype(np.float32)
    ba = rng.normal(0, 0.1, 3).astype(np.float32)
    return gyro, acc, dt, mask, bg, ba


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("seed,k,n_valid", [(0, 10, 10), (1, 10, 6),
                                            (2, 16, 13), (3, 10, 0)])
def test_preintegrate_matches_reference(seed, k, n_valid):
    gyro, acc, dt, mask, bg, ba = _window(seed, k, n_valid)
    pj = JI.preintegrate(jnp.asarray(gyro), jnp.asarray(acc),
                         jnp.asarray(dt), jnp.asarray(mask),
                         JI.make_calib(ImuConfig()), jnp.asarray(bg),
                         jnp.asarray(ba))
    pt = TI.preintegrate(*(torch.from_numpy(a) for a in
                           (gyro, acc, dt, mask)),
                         TI.make_calib(ImuConfig()), torch.from_numpy(bg),
                         torch.from_numpy(ba))
    for f in pj._fields:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        if not np.any(a):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert _rel(a, b) <= 1e-5, (f, _rel(a, b))


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_state_and_info_match_reference(seed):
    gyro, acc, dt, mask, bg, ba = _window(seed, 10, 10 - 3 * seed)
    rng = np.random.default_rng(10 + seed)
    R1 = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(0, 0.5, 3),
                                           jnp.float32)))
    v1 = rng.normal(0, 1, 3).astype(np.float32)
    p1 = rng.normal(0, 2, 3).astype(np.float32)
    pose = np.ascontiguousarray(np.concatenate([R1, p1[:, None]], 1),
                                dtype=np.float32)
    pj = JI.preintegrate(jnp.asarray(gyro), jnp.asarray(acc),
                         jnp.asarray(dt), jnp.asarray(mask),
                         JI.make_calib(ImuConfig()), jnp.asarray(bg),
                         jnp.asarray(ba))
    g_w = jnp.array([0.0, 0.0, -9.81], jnp.float32)
    Rj, vj, pj2 = JI.predict_state(pj, jnp.asarray(R1), jnp.asarray(v1),
                                   jnp.asarray(p1), g_w)
    info_j = jnp.linalg.inv(pj.C[:9, :9] + jnp.eye(9) * 1e-8)
    t = torch.from_numpy
    out = TI.imu_preint(t(gyro), t(acc), t(dt), t(mask),
                        TI.make_calib(ImuConfig()), t(bg), t(ba), t(pose),
                        t(v1))
    for a, b in ((Rj, out.R2), (vj, out.v2), (pj2, out.p2)):
        assert _rel(a, b.numpy()) <= 1e-5
    ij = np.asarray(info_j, np.float64)
    rel = np.linalg.norm(out.imu_info.numpy() - ij) / np.linalg.norm(ij)
    assert rel <= 1e-4, rel


def _bench_imu_windows(traj, n_frames):
    """bench.py:407-433, verbatim in substance."""
    imu = syn.synthesize_imu(np.random.default_rng(3), n_frames / 20.0 + 0.4,
                             radius=0.6, bias_gyro_mag=0.0, bias_acc_mag=0.0)
    nv = n_frames - 1
    gyro_b = np.zeros((nv, 10, 3), np.float32)
    acc_b = np.zeros((nv, 10, 3), np.float32)
    dts_b = np.full((nv, 10), 1.0 / 200.0, np.float32)
    for j in range(nv):
        m = (imu.timestamps > traj.timestamps[j]) \
            & (imu.timestamps <= traj.timestamps[j + 1])
        gg, aa = imu.gyro[m][:10], imu.acc[m][:10]
        gyro_b[j, :len(gg)] = gg
        acc_b[j, :len(aa)] = aa
    pose_wb0 = np.concatenate([traj.R_wb[0], traj.p_wb[0][:, None]], 1)
    carry0 = (pose_wb0, traj.v_wb[0], np.zeros(3), np.zeros(3), np.eye(15))
    return gyro_b, acc_b, dts_b, carry0


@pytest.mark.parametrize("n_frames", [4, 16])
def test_imu_windows_match_bench(n_frames):
    traj = syn.make_orbit_trajectory(duration=n_frames / 20.0 + 0.5,
                                     fps=20.0, radius=0.6)
    gj, aj, dj, cj = _bench_imu_windows(traj, n_frames)
    gt, at, dt, ct = build_imu_windows(traj, n_frames)
    assert gt.shape == gj.shape == (n_frames - 1, 10, 3)
    assert np.abs(gt - gj).max() <= 1e-6, np.abs(gt - gj).max()
    assert np.any(gj != 0) and np.all(np.abs(gj).sum(-1).min(-1) > 0)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(dt, dj)
    for a, b in zip(ct, cj):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
