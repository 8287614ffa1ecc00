"""IMU initialization and scale refinement against the JAX package (CPU),
on `inputs.build_imu_init_inputs`' chain (20 real keyframes padded to the
cap of 32, the "mono SLAM" frame at scale 0.5 for the initialization, a
1.03 scale error and a 0.5 deg gravity tilt for the refinement).

Tolerances, and why (both packages in float32; the port's plain engine
lies 1e-7 to 6e-7 from itself in float64 here):
- preintegration: the port's `ops/imu.preintegrate` against the
  reference's on the same samples, 5e-5 relative per constant (80
  float32 steps a link, sin / cos differing in the last bit, against 10
  in tests/test_torch_imu.py's 1e-5; 1.5e-5 seen in JVg).
- initialization: R_wg within 1e-6, scale within 1e-5, bg within 1e-7,
  ba within 1e-8, velocities within 1e-5 of the reference's; against the
  truth, scale within 0.5% of 2, gravity direction within 0.5 deg, gyro
  bias within 1e-4 rad/s.
- refinement: R_wg and scale within 1e-6 of the reference's; against the
  truth, scale within 0.2% of 1 / 1.03 and the tilt within 0.05 deg.

Run as a script, it prints REF_INIT, the guard of chip_smoke.py: the JAX
functions' scale, gravity direction and gyro bias on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_imu_init.py
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plvio_tpu.config import ImuConfig as JImuConfig
from plvio_tpu.models import kernels as JK
from plvio_tpu.ops import imu as JIMU
from plvio_tpu_torch.entry import imu_init
from plvio_tpu_torch.models.kernels import PRE_KEYS

G = 9.81
DOWN = np.array([0.0, 0.0, -1.0])


@pytest.fixture(scope="module")
def chain():
    m, B = imu_init(device="cpu")
    return m, B


def _j(v):
    if isinstance(v, dict):
        return {k: _j(x) for k, x in v.items()}
    return jnp.asarray(v.numpy())


def angle_deg(a, b):
    """Angle between two directions, from the cross and dot products."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)),
                                       a @ b)))


def jax_init(B):
    return [np.asarray(x) for x in JK.make_inertial_init(G, 32)(
        _j(B["Rwg0"]), _j(B["vel0"]), _j(B["pre_const"]), _j(B["pose_R"]),
        _j(B["pose_p"]), _j(B["imu_info"]), _j(B["edge_valid"]))]


def jax_refine(B):
    return [np.asarray(x) for x in JK.make_scale_refine(G, 32)(
        _j(B["ref_Rwg0"]), _j(B["ref_vel"]), _j(B["ref_bg"]),
        _j(B["ref_ba"]), _j(B["pre_const"]), _j(B["ref_pose_R"]),
        _j(B["ref_pose_p"]), _j(B["imu_info"]), _j(B["edge_valid"]))]


def test_chain_preintegration_matches_reference(chain):
    _, B = chain
    calib = JIMU.make_calib(JImuConfig())
    ev = B["edge_valid"].numpy()
    assert ev.sum() == 19 and not ev[19:].any()
    for i in np.nonzero(ev)[0]:
        p = JIMU.preintegrate(*[jnp.asarray(B[k][i].numpy()) for k in (
            "imu_gyro", "imu_acc", "imu_dt", "imu_mask")], calib,
            jnp.zeros(3), jnp.zeros(3))
        ref = {"dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP, "JRg": p.JRg,
               "JVg": p.JVg, "JVa": p.JVa, "JPg": p.JPg, "JPa": p.JPa,
               "bg0": p.bias_gyro, "ba0": p.bias_acc}
        for k in PRE_KEYS:
            a, b = B["pre_const"][k][i].numpy(), np.asarray(ref[k])
            assert np.abs(a - b).max() <= 5e-5 * max(np.abs(b).max(), 1.0), \
                (i, k)


def test_inertial_init_matches_reference(chain):
    m, B = chain
    oj = jax_init(B)
    ot = [x.numpy() for x in m(B)]
    for i, tol in enumerate((1e-6, 1e-5, 1e-7, 1e-8, 1e-5)):
        assert np.abs(ot[i] - oj[i]).max() <= tol, (i, np.abs(
            ot[i] - oj[i]).max())
    assert abs(float(ot[1]) - B["gt_scale"]) <= 0.005 * B["gt_scale"]
    assert angle_deg(ot[0] @ DOWN, B["gt_gdir"].numpy()) <= 0.5
    assert np.abs(ot[2] - B["gt_bg"].numpy()).max() <= 1e-4


def test_scale_refine_matches_reference(chain):
    m, B = chain
    oj = jax_refine(B)
    ot = [x.numpy() for x in m.refine(B)]
    assert np.abs(ot[0] - oj[0]).max() <= 1e-6
    assert abs(float(ot[1]) - float(oj[1])) <= 1e-6
    assert abs(float(ot[1]) - B["gt_ref_scale"]) <= 0.002
    assert angle_deg(ot[0] @ DOWN, B["gt_ref_gdir"].numpy()) <= 0.05


def test_padding_is_inert(chain):
    """The padded keyframes' velocities stay where they started and the
    masked links carry the identity constants."""
    m, B = chain
    vel = m(B)[4].numpy()
    np.testing.assert_array_equal(vel[20:], B["vel0"].numpy()[20:])
    assert (B["pre_const"]["dT"].numpy()[19:] == 0).all()


def reference_init():
    """REF_INIT: the JAX initialization's and refinement's scale, gravity
    direction (R_wg (0, 0, -1)) and the initialization's gyro bias."""
    _, B = imu_init(device="cpu")
    oi, orf = jax_init(B), jax_refine(B)
    return dict(init_scale=float(oi[1]),
                init_gdir=[float(x) for x in oi[0] @ DOWN],
                init_bg=[float(x) for x in oi[2]],
                refine_scale=float(orf[1]),
                refine_gdir=[float(x) for x in orf[0] @ DOWN])


if __name__ == "__main__":
    print(json.dumps(reference_init()))
