"""The pinhole camera with rad-tan distortion and the Kannala-Brandt (KB8)
fisheye (port of plvio_tpu/ops/cameras.py: `Camera`, `make_camera`,
`project_pinhole`, `unproject_pinhole`, `project_jac_pinhole`,
`distort_radtan`, `undistort_radtan` :86, `undistort_pixels` :117,
`distort_pixels` :133, `kb8_project` :150, `kb8_distort_norm` :163,
`kb8_unproject` :170, `kb8_undistort_pixels` :192, the `project` /
`unproject` dispatch :203-207 and `in_image`).

`undistort` is the hand-written CUDA kernel (csrc/undistort.cu) of
`undistort_pixels` on a frame's keypoints and both endpoints of its line
segments, with the undistorted segments' line equations, in one launch;
`undistort_frame_plain` beside it is the plain PyTorch version (on
`undistort_radtan`: 8 Newton steps with the analytic 2x2 Jacobian, the
reference's float32 operation order).  Its KB8 mode (a KB8 camera, its
launches counted as `UNDISTORT_KB8`) undistorts the keypoints and the
segments' endpoints through `kb8_unproject`'s 10 Newton steps of
theta_d(theta).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import cuda
from .lines import line_equation


def _f32(x: float) -> float:
    return float(np.float32(x))


class Camera(NamedTuple):
    """Intrinsics as float32 values (the reference's jnp.float32 leaves)
    and the static geometry."""
    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, ...]   # k1, k2, p1, p2 (pinhole) or k1..k4 (kb8)
    width: int
    height: int
    model: str = "pinhole"


def make_camera(cfg) -> Camera:
    """From a plvio_tpu_torch.config.CameraConfig ("pinhole" or "kb8")."""
    if cfg.model not in ("pinhole", "kb8"):
        raise ValueError(f"camera model {cfg.model!r}: pinhole or kb8")
    d = tuple(_f32(v) for v in cfg.dist) + (0.0,) * (4 - len(cfg.dist))
    return Camera(_f32(cfg.fx), _f32(cfg.fy), _f32(cfg.cx), _f32(cfg.cy),
                  d[:4], cfg.width, cfg.height, cfg.model)


def project_pinhole(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [...,3] -> pixels [...,2] (no distortion)."""
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                              z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], -1)


def unproject_pinhole(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [...,2] -> unit-depth rays [...,3] (no distortion)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], -1)


def project_jac_pinhole(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """d(u,v)/d(pc): [...,2,3]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                              z)
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1)
    row_v = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    return torch.stack([row_u, row_v], -2)


def distort_radtan(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    """Normalised coords [...,2] -> distorted normalised coords [...,2]."""
    k1, k2, p1, p2 = cam.dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_radtan(cam: Camera, xd: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert the rad-tan model by Newton iteration with the analytic 2x2
    Jacobian, a fixed `iters` steps from xd (the plain version of the
    `undistort` kernel)."""
    k1, k2, p1, p2 = cam.dist
    x, y = xd[..., 0], xd[..., 1]
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        fx_ = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) \
            - xd[..., 0]
        fy_ = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y \
            - xd[..., 1]
        dr_dr2 = k1 + 2.0 * k2 * r2
        j00 = radial + x * dr_dr2 * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = x * dr_dr2 * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = y * dr_dr2 * 2.0 * x + 2.0 * p1 * x + 2.0 * p2 * y
        j11 = radial + y * dr_dr2 * 2.0 * y + 6.0 * p1 * y + 2.0 * p2 * x
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9),
                          det)
        dx = (j11 * fx_ - j01 * fy_) / det
        dy = (-j10 * fx_ + j00 * fy_) / det
        x, y = x - dx, y - dy
    return torch.stack([x, y], -1)


def _undistort_pixels_plain(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    # divisors as tensors: eager CUDA divides by a Python scalar as a
    # multiply by its reciprocal, an ulp off the kernel's division, and
    # the Newton steps magnify that near the image corners
    fx, fy = (torch.tensor(f, dtype=uv.dtype, device=uv.device)
              for f in (cam.fx, cam.fy))
    xn_d = torch.stack([(uv[..., 0] - cam.cx) / fx,
                        (uv[..., 1] - cam.cy) / fy], -1)
    xn = undistort_radtan(cam, xn_d)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx,
                        cam.fy * xn[..., 1] + cam.cy], -1)


def undistort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels [...,2] -> undistorted pixels.  A pinhole camera
    whose coefficients are all zero returns `uv` itself (the reference's
    short-circuit, a host test on the camera, never on the data).  CPU
    tensors take the plain version; CUDA tensors launch the `undistort`
    kernel (its KB8 mode for a KB8 camera)."""
    if cam.model == "kb8":
        if uv.device.type == "cpu":
            return kb8_undistort_pixels(cam, uv)
        out, _, _ = undistort(cam, uv.reshape(-1, 2).contiguous(), None)
        return out.reshape(uv.shape)
    if not any(cam.dist):
        return uv
    if uv.device.type == "cpu":
        return _undistort_pixels_plain(cam, uv)
    out, _, _ = undistort(cam, uv.reshape(-1, 2).contiguous(), None)
    return out.reshape(uv.shape)


def distort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels -> raw (distorted) pixels."""
    xn = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], -1)
    xd = kb8_distort_norm(cam, xn) if cam.model == "kb8" \
        else distort_radtan(cam, xn)
    return torch.stack([cam.fx * xd[..., 0] + cam.cx,
                        cam.fy * xd[..., 1] + cam.cy], -1)


# --------------------------------------------------------------------------
# Kannala-Brandt 8 (fisheye)
# --------------------------------------------------------------------------

def _kb8_poly(t2: torch.Tensor, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """theta_d / theta = 1 + k1 t2 + k2 t2^2 + k3 t2^3 + k4 t2^4 and its
    derivative factor d theta_d / d theta = 1 + 3 k1 t2 + ... + 9 k4 t2^4,
    with the powers as jnp's integer_pow forms them (t2^3 = t2 (t2 t2),
    t2^4 = (t2 t2)(t2 t2)) and the sums left to right."""
    p2 = t2 * t2
    p3 = t2 * p2
    p4 = p2 * p2
    poly = 1.0 + k[0] * t2 + k[1] * p2 + k[2] * p3 + k[3] * p4
    dpoly = 1.0 + _f32(3.0 * k[0]) * t2 + _f32(5.0 * k[1]) * p2 \
        + _f32(7.0 * k[2]) * p3 + _f32(9.0 * k[3]) * p4
    return poly, dpoly


def kb8_project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [...,3] -> pixels [...,2] (the equidistant
    model)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-18))
    theta = torch.atan2(r, z)
    theta_d = theta * _kb8_poly(theta * theta, cam.dist)[0]
    scale = theta_d / r
    return torch.stack([cam.fx * x * scale + cam.cx,
                        cam.fy * y * scale + cam.cy], -1)


def kb8_distort_norm(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    """Normalised coordinates [...,2] -> distorted normalised
    coordinates."""
    p = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    uv = kb8_project(cam, p)
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], -1)


def kb8_unproject(cam: Camera, uv: torch.Tensor,
                  iters: int = 10) -> torch.Tensor:
    """Pixels [...,2] -> unit-depth rays [...,3]: `iters` Newton steps of
    theta_d(theta) = |m| from theta = |m|, each step divided by max(df,
    1e-6), then the ray m tan(theta) / |m| (the plain version of the
    `undistort` kernel's KB8 mode)."""
    fx, fy = (torch.tensor(f, dtype=uv.dtype, device=uv.device)
              for f in (cam.fx, cam.fy))
    mx = (uv[..., 0] - cam.cx) / fx
    my = (uv[..., 1] - cam.cy) / fy
    theta_d = torch.sqrt(torch.clamp_min(mx * mx + my * my, 1e-18))
    theta = theta_d
    for _ in range(iters):
        poly, dpoly = _kb8_poly(theta * theta, cam.dist)
        f = theta * poly - theta_d
        theta = theta - f / torch.clamp_min(dpoly, 1e-6)
    scale = torch.tan(theta) / theta_d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], -1)


def kb8_undistort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Raw fisheye pixels [...,2] -> undistorted (pinhole) pixels."""
    ray = kb8_unproject(cam, uv)
    return torch.stack([cam.fx * ray[..., 0] / ray[..., 2] + cam.cx,
                        cam.fy * ray[..., 1] / ray[..., 2] + cam.cy], -1)


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    return kb8_project(cam, pc) if cam.model == "kb8" \
        else project_pinhole(cam, pc)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return kb8_unproject(cam, uv) if cam.model == "kb8" \
        else unproject_pinhole(cam, uv)


def in_image(cam: Camera, uv: torch.Tensor,
             margin: float = 0.0) -> torch.Tensor:
    return (uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin) \
        & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin)


# --------------------------------------------------------------------------
# Kernel: undistort
# --------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_UNDISTORT_ARGS = [_P, _I, _P, _I, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P,
                   _P, _P, _P]
UNDISTORT = cuda.Kernel("undistort", "undistort", _UNDISTORT_ARGS)
# the same library entry in its KB8 mode, counted apart
UNDISTORT_KB8 = cuda.Kernel("undistort", "undistort", _UNDISTORT_ARGS)


def undistort_frame_plain(cam: Camera, kp: torch.Tensor,
                          ep: Optional[torch.Tensor]):
    """Plain version of `undistort`."""
    und = kb8_undistort_pixels if cam.model == "kb8" \
        else _undistort_pixels_plain
    kp_out = und(cam, kp)
    if ep is None:
        return kp_out, None, None
    ep_out = torch.cat([und(cam, ep[:, :2]), und(cam, ep[:, 2:])], -1)
    return kp_out, ep_out, line_equation(ep_out)


def undistort(cam: Camera, kp: torch.Tensor, ep: Optional[torch.Tensor]):
    """Undistort a frame's keypoints kp [N,2] and its segments' endpoints
    ep [L,4] = (x0, y0, x1, y1) (or None) in one launch: (kp_und [N,2],
    ep_und [L,4], lineq [L,3]) (the last two None without ep), lineq
    the normalized line equations of the undistorted segments
    (`ops.lines.line_equation`), through the KB8 lens for a KB8 camera.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/undistort.cu."""
    kb8 = cam.model == "kb8"
    if kp.device.type == "cpu":
        return undistort_frame_plain(cam, kp, ep)
    ts = [kp] if ep is None else [kp, ep]
    cuda.check_cuda("undistort", *ts)
    n = kp.shape[0]
    l = 0 if ep is None else ep.shape[0]
    if any(t.dtype != torch.float32 for t in ts) or kp.shape != (n, 2) \
            or (ep is not None and ep.shape != (l, 4)):
        raise ValueError("undistort: float32 kp [N,2] and ep [L,4]")
    kp_out = torch.empty_like(kp)
    ep_out = None if ep is None else torch.empty_like(ep)
    lineq = None if ep is None else torch.empty(l, 3, dtype=torch.float32,
                                                device=kp.device)
    c0, c1, c2, c3 = cam.dist
    (UNDISTORT_KB8 if kb8 else UNDISTORT).launch(
        cuda.ptr(kp), n, None if ep is None else cuda.ptr(ep), l, cam.fx,
        cam.fy, cam.cx, cam.cy, c0, c1, c2, c3, int(kb8), cuda.ptr(kp_out),
        None if ep is None else cuda.ptr(ep_out),
        None if ep is None else cuda.ptr(lineq), cuda.stream())
    return kp_out, ep_out, lineq
