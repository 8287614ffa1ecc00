"""Rectified stereo matching (port of plvio_tpu/ops/stereo.py:
`match_stereo` :16, `match_stereo_lines` :38, `backproject` :103).

The reference forms the whole N x M Hamming matrix as a matmul of +-1
descriptors, masks it with the pair's gates and runs `match_nn_ratio`.
The port keeps descriptors packed ([*,8] int32, `ops.matching`); the
plain versions below unpack and follow the reference's operations in its
order, and the wrappers launch csrc/hamming_match.cu's `stereo_match`:
the gated popcount matcher of `hamming_match` in its stereo point (mode
4) and stereo line (mode 5) gates, whose mutual check writes the
per-feature depths, so only those leave the kernel.  CPU tensors take the
plain version; CUDA tensors launch the kernel.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import cuda
from . import matching as M

_SCALE_ON = {}


def _octave_scale(dev: torch.device) -> torch.Tensor:
    """`ops.matching.OCTAVE_SCALE` on `dev`, copied there once."""
    if dev not in _SCALE_ON:
        _SCALE_ON[dev] = torch.from_numpy(M.OCTAVE_SCALE).to(dev)
    return _SCALE_ON[dev]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar tensor: dividing by or into a
    tensor is then a true float32 division on every device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def match_stereo_plain(uv_l, desc_l, oct_l, valid_l, uv_r, desc_r, oct_r,
                       valid_r, bf: float, min_z: float = 0.1,
                       row_tol: float = 2.0, ratio: float = 0.9,
                       max_dist: float = 60.0):
    """Plain version of `match_stereo` (the reference's matrix form)."""
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(desc_l),
                            M.unpack_u32_to_pm1(desc_r))
    scale_l = _octave_scale(uv_l.device)[oct_l.long()]
    dv = torch.abs(uv_l[:, 1:2] - uv_r[None, :, 1])
    disp = uv_l[:, 0:1] - uv_r[None, :, 0]
    max_disp = np.float32(bf / min_z)
    gate = (dv <= row_tol * scale_l[:, None]) & (disp > 0.1) \
        & (disp <= float(max_disp))
    idx, ok = M.match_nn_ratio(dist, valid_l, valid_r, gate,
                               max_dist=max_dist, ratio=ratio, mutual=True)
    u_r = uv_r[idx.long(), 0]
    d = uv_l[:, 0] - u_r
    depth = _f32(bf, d) / torch.clamp_min(d, 1e-6)
    has = ok & (d > 0.1)
    neg = torch.full_like(d, -1.0)
    return torch.where(has, u_r, neg), torch.where(has, depth, neg), has


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# one library entry, two kernels of the port's table: the point mode's
# launches and the line mode's are counted apart
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P,
         _P, _P, _P, _P, _P, _P]
STEREO_MATCH_POINTS = cuda.Kernel("hamming_match", "stereo_match", _ARGS)
STEREO_MATCH_LINES = cuda.Kernel("hamming_match", "stereo_match", _ARGS)


def _check(name, desc_l, desc_r, valid_l, valid_r, xy_l, xy_r, w):
    n, m = desc_l.shape[0], desc_r.shape[0]
    if desc_l.dtype != torch.int32 or desc_r.dtype != torch.int32 \
            or desc_l.shape[1:] != (8,) or desc_r.shape[1:] != (8,):
        raise ValueError(f"{name}: descriptors must be [*,8] int32")
    if valid_l.dtype != torch.bool or valid_r.dtype != torch.bool \
            or valid_l.shape != (n,) or valid_r.shape != (m,):
        raise ValueError(f"{name}: valid_l [N] / valid_r [M] bool")
    if xy_l.dtype != torch.float32 or xy_r.dtype != torch.float32 \
            or xy_l.shape != (n, w) or xy_r.shape != (m, w):
        raise ValueError(f"{name}: positions [N,{w}] / [M,{w}] float32")
    if n >= 1 << 16 or m > 3000:
        # row ids share a 32-bit word with the distance; the columns must
        # fit a block's shared memory
        raise ValueError(f"{name}: needs N < 65536 rows and M <= 3000 "
                         "columns")
    return n, m


def _launch(mode, desc_l, desc_r, valid_l, valid_r, xy_l, xy_r, a_ang,
            b_ang, lim, bf, max_dist, ratio, row_tol=0.0):
    n, m = desc_l.shape[0], desc_r.shape[0]
    dev = desc_l.device
    out0 = torch.empty(n, dtype=torch.float32, device=dev)
    out1 = torch.empty(n, dtype=torch.float32, device=dev)
    has = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out0, out1, has
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    stream = cuda.stream(dev.index)
    kernel = STEREO_MATCH_POINTS if mode == 4 else STEREO_MATCH_LINES
    kernel.launch(
        cuda.ptr(desc_l), cuda.ptr(desc_r), cuda.ptr(valid_l),
        cuda.ptr(valid_r), cuda.ptr(xy_l), cuda.ptr(xy_r), cuda.ptr(a_ang),
        None if b_ang is None else cuda.ptr(b_ang), n, m, mode, float(lim),
        float(bf), float(max_dist), float(ratio), float(row_tol),
        cuda.ptr(idx),
        cuda.ptr(ok), _P(M.match_workspace(dev, stream.value, m)),
        cuda.ptr(out0), cuda.ptr(out1), cuda.ptr(has), stream)
    return out0, out1, has


def match_stereo(uv_l, desc_l, oct_l, valid_l, uv_r, desc_r, oct_r,
                 valid_r, bf: float, min_z: float = 0.1,
                 row_tol: float = 2.0, ratio: float = 0.9,
                 max_dist: float = 60.0):
    """Left features against the right view's: uv_* [N,2] / [M,2] float32
    RAW pixels, desc_* packed [*,8] int32, oct_* [*] int32, valid_* bool;
    bf = baseline * fx.  Gates: |v_L - v_R| <= row_tol * 1.2^oct_L and
    0.1 < u_L - u_R <= bf / min_z; mutual nearest neighbour, Hamming
    <= max_dist, ratio test.  Returns (u_right [N], depth [N], has [N]),
    -1 where not has.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (mode 4)."""
    if uv_l.device.type == "cpu":
        return match_stereo_plain(uv_l, desc_l, oct_l, valid_l, uv_r,
                                  desc_r, oct_r, valid_r, bf, min_z,
                                  row_tol, ratio, max_dist)
    ts = (uv_l, desc_l, oct_l, valid_l, uv_r, desc_r, valid_r)
    key = M.signature(4, ts)
    if key not in M.CHECKED:
        cuda.check_cuda("match_stereo", *ts)
        _check("match_stereo", desc_l, desc_r, valid_l, valid_r, uv_l, uv_r,
               2)
        if oct_l.dtype != torch.int32 or oct_l.shape != valid_l.shape:
            raise ValueError("match_stereo: oct_l [N] int32")
        M.CHECKED.add(key)
    # the kernel forms each row's tolerance row_tol * scale[oct_l]
    return _launch(4, desc_l, desc_r, valid_l, valid_r, uv_l, uv_r, oct_l,
                   _octave_scale(uv_l.device), float(np.float32(bf / min_z)),
                   bf, max_dist, ratio, row_tol)


def match_stereo_lines_plain(ep_l, desc_l, ang_l, valid_l, ep_r, desc_r,
                             ang_r, valid_r, bf: float, min_disp: float = 1.0,
                             overlap_th: float = 0.75,
                             angle_tol: float = 0.1, max_dist: float = 110.0,
                             ratio: float = 0.9):
    """Plain version of `match_stereo_lines` (the reference's matrix
    form)."""
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(desc_l),
                            M.unpack_u32_to_pm1(desc_r))
    dang = torch.remainder(torch.abs(ang_l[:, None] - ang_r[None, :]),
                           math.pi)
    dang = torch.minimum(dang, math.pi - dang)
    ylo_l = torch.minimum(ep_l[:, 1], ep_l[:, 3])[:, None]
    yhi_l = torch.maximum(ep_l[:, 1], ep_l[:, 3])[:, None]
    ylo_r = torch.minimum(ep_r[:, 1], ep_r[:, 3])[None, :]
    yhi_r = torch.maximum(ep_r[:, 1], ep_r[:, 3])[None, :]
    inter = torch.clamp_min(torch.minimum(yhi_l, yhi_r)
                            - torch.maximum(ylo_l, ylo_r), 0.0)
    span_l = torch.clamp_min(yhi_l - ylo_l, 1e-6)
    overlap = inter / span_l
    mid_l = (ep_l[:, 0] + ep_l[:, 2]) * 0.5
    mid_r = (ep_r[:, 0] + ep_r[:, 2]) * 0.5
    gate = (dang < float(np.float32(angle_tol * math.pi))) \
        & (overlap > overlap_th) & (mid_r[None, :] <= mid_l[:, None])
    idx, ok = M.match_nn_ratio(dist, valid_l, valid_r, gate,
                               max_dist=max_dist, ratio=ratio, mutual=True)
    mr = ep_r[idx.long()]
    dy_r = mr[:, 3] - mr[:, 1]
    slope = (mr[:, 2] - mr[:, 0]) / torch.where(
        torch.abs(dy_r) < 1e-6, torch.full_like(dy_r, math.inf), dy_r)

    def x_at(y):
        return mr[:, 0] + (y - mr[:, 1]) * slope
    disp_s = ep_l[:, 0] - x_at(ep_l[:, 1])
    disp_e = ep_l[:, 2] - x_at(ep_l[:, 3])
    horiz_l = torch.abs(ep_l[:, 1] - ep_l[:, 3]) <= 0.1
    horiz_r = torch.abs(dy_r) <= 0.1
    has = ok & (disp_s >= min_disp) & (disp_e >= min_disp) & ~horiz_l \
        & ~horiz_r
    bf_t = _f32(bf, disp_s)
    neg = torch.full_like(disp_s, -1.0)
    depth_s = torch.where(has, bf_t / torch.clamp_min(disp_s, 1e-6), neg)
    depth_e = torch.where(has, bf_t / torch.clamp_min(disp_e, 1e-6), neg)
    return depth_s, depth_e, has


def match_stereo_lines(ep_l, desc_l, ang_l, valid_l, ep_r, desc_r, ang_r,
                       valid_r, bf: float, min_disp: float = 1.0,
                       overlap_th: float = 0.75, angle_tol: float = 0.1,
                       max_dist: float = 110.0, ratio: float = 0.9):
    """Rectified stereo line matching: ep_* [L,4] float32 RAW endpoints
    (x0, y0, x1, y1), desc_* packed LBD [L,8] int32, ang_* [L] float32,
    valid_* bool; bf = baseline * fx.  Gates: wrapped direction difference
    < angle_tol * pi, y-span overlap > overlap_th, mid_R <= mid_L; mutual
    nearest neighbour, Hamming <= max_dist, ratio test; per endpoint the
    disparity against the matched right line at its row.  Returns
    (depth_s [L], depth_e [L], has [L]), -1 where not has.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (mode 5)."""
    if ep_l.device.type == "cpu":
        return match_stereo_lines_plain(ep_l, desc_l, ang_l, valid_l, ep_r,
                                        desc_r, ang_r, valid_r, bf, min_disp,
                                        overlap_th, angle_tol, max_dist,
                                        ratio)
    if min_disp != 1.0 or overlap_th != 0.75:
        raise ValueError("match_stereo_lines: the kernel has min_disp 1 "
                         "and overlap_th 0.75")
    ts = (ep_l, desc_l, ang_l, valid_l, ep_r, desc_r, ang_r, valid_r)
    key = M.signature(5, ts)
    if key not in M.CHECKED:
        cuda.check_cuda("match_stereo_lines", *ts)
        n, m = _check("match_stereo_lines", desc_l, desc_r, valid_l,
                      valid_r, ep_l, ep_r, 4)
        if ang_l.shape != (n,) or ang_r.shape != (m,) \
                or ang_l.dtype != torch.float32 \
                or ang_r.dtype != torch.float32:
            raise ValueError("match_stereo_lines: ang_l [L] / ang_r [M] "
                             "float32")
        M.CHECKED.add(key)
    return _launch(5, desc_l, desc_r, valid_l, valid_r, ep_l, ep_r, ang_l,
                   ang_r, angle_tol * math.pi, bf, max_dist, ratio)


def backproject(K, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels [N,2] + depth [N] -> camera-frame points [N,3]."""
    x = (uv[:, 0] - K.cx) / K.fx * depth
    y = (uv[:, 1] - K.cy) / K.fy * depth
    return torch.stack([x, y, depth], -1)
