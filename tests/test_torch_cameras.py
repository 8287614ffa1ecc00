"""Slice 6, the pinhole camera with rad-tan distortion
(`plvio_tpu_torch/ops/cameras.py`), against the JAX package on the CPU:
the pinhole cases of tests/test_cameras.py, and the undistortion that
`System.track_monocular` runs on every frame's keypoints and line
endpoints, at EuRoC's coefficients (`CameraConfig`, k1 = -0.283).

Tolerances, and why: projection and unprojection as tests/test_cameras.py
(1e-4; the Jacobian against central differences, 1e-3 relative / 1e-2);
the round trip distort -> undistort within 1e-3 px (8 Newton steps
converge to float32 rounding, ~6e-5 px at the corners); `undistort_pixels`
and `distort_pixels` against JAX within 1e-4 px on a grid that reaches the
image's corners (the same float32 operations; XLA contracts multiply-adds
on the CPU, the port does not); the frame form (`undistort`'s plain
version) equal to `undistort_pixels` on each array, its line equations to
`ops.lines.line_equation`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plvio_tpu.config import CameraConfig as JCameraConfig
from plvio_tpu.ops import cameras as JC
from plvio_tpu_torch.config import CameraConfig
from plvio_tpu_torch.ops import cameras as C
from plvio_tpu_torch.ops.lines import line_equation


def euroc_cam():
    return C.make_camera(CameraConfig())


def grid():
    """Pixels on a 25 x 17 grid over the whole 752 x 480 image, corners
    included."""
    u, v = np.meshgrid(np.linspace(0, 751, 25), np.linspace(0, 479, 17))
    return np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)


def test_project_unproject_pinhole(rng):
    cam = euroc_cam()
    pc = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    pc[:, 2] = np.abs(pc[:, 2]) + 1.0
    pc = torch.from_numpy(pc)
    uv = C.project_pinhole(cam, pc)
    rays = C.unproject_pinhole(cam, uv)
    np.testing.assert_allclose((rays * pc[:, 2:3]).numpy(), pc.numpy(),
                               rtol=1e-4, atol=1e-4)
    jcam = JC.make_camera(JCameraConfig())
    np.testing.assert_allclose(
        uv.numpy(), np.asarray(JC.project_pinhole(jcam, jnp.asarray(pc))),
        atol=1e-4)
    inside = C.in_image(cam, uv)
    np.testing.assert_array_equal(
        inside.numpy(), np.asarray(JC.in_image(jcam, jnp.asarray(uv))))


def test_project_jac_fd():
    cam = euroc_cam()
    pc = torch.tensor([[0.3, -0.2, 2.0]])
    J = C.project_jac_pinhole(cam, pc)[0].numpy()
    eps = 1e-3
    for k in range(3):
        d = torch.zeros(3)
        d[k] = eps
        up = C.project_pinhole(cam, pc + d)[0].numpy()
        dn = C.project_pinhole(cam, pc - d)[0].numpy()
        np.testing.assert_allclose((up - dn) / (2 * eps), J[:, k], rtol=1e-3,
                                   atol=1e-2)


def test_distort_undistort_roundtrip():
    cam = euroc_cam()
    uv = torch.from_numpy(grid())
    back = C.distort_pixels(cam, C.undistort_pixels(cam, uv))
    np.testing.assert_allclose(back.numpy(), uv.numpy(), atol=1e-3)


def test_zero_distortion_short_circuits():
    """No distortion: the pixels themselves come back (the reference's
    host test on the coefficients), and the frame prelude leaves them."""
    cam = C.make_camera(CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)))
    uv = torch.from_numpy(grid())
    assert C.undistort_pixels(cam, uv) is uv


@pytest.mark.parametrize("fn", ["undistort_pixels", "distort_pixels"])
def test_pixels_match_jax_at_euroc(fn):
    cam, jcam = euroc_cam(), JC.make_camera(JCameraConfig())
    uv = grid()
    out = getattr(C, fn)(cam, torch.from_numpy(uv)).numpy()
    ref = np.asarray(getattr(JC, fn)(jcam, jnp.asarray(uv)))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_frame_form_matches_undistort_pixels(rng):
    """`undistort`'s plain version (what a CPU frame takes): keypoints and
    both endpoints as `undistort_pixels` gives them, and the line
    equations of the undistorted segments."""
    cam = euroc_cam()
    kp = torch.from_numpy(grid())
    ep = torch.from_numpy(rng.uniform([0, 0, 0, 0], [751, 479, 751, 479],
                                      (64, 4)).astype(np.float32))
    kp_u, ep_u, lineq = C.undistort(cam, kp, ep)
    np.testing.assert_array_equal(kp_u.numpy(),
                                  C.undistort_pixels(cam, kp).numpy())
    np.testing.assert_array_equal(
        ep_u.numpy(), torch.cat([C.undistort_pixels(cam, ep[:, :2]),
                                 C.undistort_pixels(cam, ep[:, 2:])],
                                -1).numpy())
    np.testing.assert_array_equal(lineq.numpy(), line_equation(ep_u).numpy())
    kp_only, none_ep, none_eq = C.undistort(cam, kp, None)
    assert none_ep is None and none_eq is None
    np.testing.assert_array_equal(kp_only.numpy(), kp_u.numpy())
