"""ORB point front end (port of plvio_tpu/ops/frontend.py).

Same pipeline and numbers as the reference: 8-level x1.2 pyramid, dense
FAST-16/9 at two thresholds with 3x3 NMS and a blend, one winner per 16 px
cell, a stable top-k of cell winners per level, intensity-centroid angle,
7x7 Gaussian blur of each patch and steered 256-bit BRIEF on the seed-7
numpy pattern.  Three stages are hand-written CUDA kernels:

* `pyramid` (csrc/pyramid.cu): the pyramid's levels, each
  jax.image.resize's antialiased 'linear' function of the one above
  (`pyramid_chain`: one launch a level from one host call), and the line
  front end's 2x2-mean level 1 (`line_level`);
* `orb_fast_grid` (csrc/orb_fast_grid.cu): the detector of every level in
  two launches a frame (`orb_detect`): FAST + NMS + blend + border +
  per-cell argmax, then each level's top-k cells and the keypoints'
  outputs;
* `orb_describe` (csrc/orb_describe.cu): patch, angle, blur and BRIEF of
  every keypoint of every level.

Their plain PyTorch versions sit beside them; the wrappers take the plain
version only for CPU tensors.  Descriptors are packed [N,8] int32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import cuda

# FAST circle offsets (dx, dy), radius-3 Bresenham circle in FAST-16 order
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    np.int32)

PATCH_R = 15          # orientation patch radius
EDGE = 19             # border margin
DESC_BITS = 256
PATCH_RAW = 39        # raw patch: BRIEF radius 14 + bilinear 1 + blur 3 + c
_DEG = 180.0 / math.pi
_RAD = math.pi / 180.0


class LevelSpec(NamedTuple):
    height: int
    width: int
    scale: float      # pyramid scale of this level (1.0 at level 0)
    n_keep: int       # features to keep at this level


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (the Frame analog)."""
    uv: torch.Tensor        # [N,2] level-0 pixel coords
    uv_und: torch.Tensor    # [N,2] undistorted pixel coords (caller's job)
    response: torch.Tensor  # [N]
    angle: torch.Tensor     # [N] degrees [0,360)
    octave: torch.Tensor    # [N] int32 pyramid level
    desc: torch.Tensor      # [N,8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [N] bool


def features_per_level(n_features: int, n_levels: int,
                       scale: float) -> List[int]:
    """Geometric feature budget per level."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    out, total = [], 0
    for i in range(n_levels - 1):
        k = int(round(n_first * factor ** i))
        out.append(k)
        total += k
    out.append(max(n_features - total, 0))
    return out


def make_level_specs(height: int, width: int, n_features: int = 1000,
                     n_levels: int = 8, scale: float = 1.2) -> List[LevelSpec]:
    per = features_per_level(n_features, n_levels, scale)
    specs = []
    for lv in range(n_levels):
        s = scale ** lv
        specs.append(LevelSpec(int(round(height / s)), int(round(width / s)),
                               s, per[lv]))
    return specs


# --------------------------------------------------------------------------
# Kernel 0: pyramid (the ORB pyramid's levels and the line level)
# --------------------------------------------------------------------------

_RESIZE_EPS = 1000.0 * float(np.finfo(np.float32).eps)


def resize_axis(n_in: int, n_out: int):
    """(inv_scale, kernel_scale) of one axis as jax.image.resize computes
    them (jax/_src/image/scale.py `_resize`, `compute_weight_mat`): the
    scale is out / in of this axis, inverted in float64 and used in
    float32, the triangle widened by max(1 / scale, 1) (antialias)."""
    inv = 1.0 / (n_out / n_in)
    return np.float32(inv), np.float32(max(inv, 1.0))


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of jax.image.resize 'linear' with
    antialias along one axis, as `compute_weight_mat` computes them under
    jit on the CPU: sample (o + 0.5) inv - 0.5, the triangle max(0, 1 -
    |sample - i| / ks), each column divided by its total (zero where
    |total| <= 1000 eps), columns whose sample lies outside [-0.5, n_in -
    0.5] zeroed.  XLA contracts the sample into one fused multiply-add
    where it computes a weight, but the reduction that totals a column
    recomputes it unfused (two roundings), and so does this function
    (the fused one in float64, where a product of two float32 is
    exact)."""
    inv, ks = resize_axis(n_in, n_out)
    inv_t, ks = (torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (inv, ks))
    o = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    i = torch.arange(n_in, dtype=torch.float32, device=device)

    def triangle(sample):
        x = (sample[None, :] - i[:, None]).abs() / ks
        return torch.clamp_min(1.0 - x, 0.0)

    sample = (o.double() * float(inv) - 0.5).float()
    w = triangle(sample)
    total = triangle(o * inv_t - 0.5).sum(0, keepdim=True)
    w = torch.where(total.abs() > _RESIZE_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_plain(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(img, (height, width), 'linear') of a [H,W] float32
    image: the per-axis weights contracted over the rows, then the columns,
    as XLA orders the einsum (an axis whose size stays is left as it is,
    as JAX skips it)."""
    H, W = img.shape
    out = img
    if height != H:
        out = resize_weights(H, height, img.device).T @ out
    if width != W:
        out = out @ resize_weights(W, width, img.device)
    return out


def build_pyramid_plain(img: torch.Tensor,
                        specs: Sequence[LevelSpec]) -> List[torch.Tensor]:
    """Plain version of `build_pyramid`: each level `resize_plain` of the
    one above (plvio_tpu/ops/frontend.py:98-106)."""
    out = [img]
    for spec in specs[1:]:
        out.append(resize_plain(out[-1], spec.height, spec.width))
    return out


def line_level_plain(img: torch.Tensor) -> torch.Tensor:
    """The line front end's level 1 (plvio_tpu/ops/lines.py:737-739): the
    2x2 mean of the image's even crop, summed (((a + b) + c) + d) * 0.25
    in memory order (elementwise, so the same bits on every device and
    the kernel's)."""
    h2, w2 = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    e = img[:h2, :w2]
    return (((e[0::2, 0::2] + e[0::2, 1::2]) + e[1::2, 0::2])
            + e[1::2, 1::2]) * 0.25


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
PYRAMID = cuda.Kernel("pyramid", "pyramid_levels",
                      [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P])
PYRAMID_LINE = cuda.Kernel("pyramid", "pyramid_line_level",
                           [_P, _I, _I, _P, _P])
PYRAMID_KS_MAX = 1.5        # the kernel's tap window and shared tile


def _check_level(name: str, img: torch.Tensor) -> None:
    cuda.check_cuda(name, img)
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"{name}: a [H,W] float32 image")


@functools.lru_cache(maxsize=None)
def _chain_layout(H: int, W: int, sizes: tuple):
    """The host arguments of a chain of levels (each from the one above):
    ctypes arrays of the sizes, the levels' offsets in one buffer (each
    aligned as an allocation of its own would be) and the per-axis (inv,
    ks), and the buffer's length."""
    hw, off, par, n, (h_in, w_in) = [], [], [], 0, (H, W)
    for h, w in sizes:
        iy, ky = resize_axis(h_in, h)
        ix, kx = resize_axis(w_in, w)
        if max(ky, kx, iy, ix) > PYRAMID_KS_MAX or h < 1 or w < 1:
            raise ValueError("pyramid: levels of 1/1.5 the one above a "
                             "side or more")
        hw += [h, w]
        off.append(n)
        par += [float(iy), float(ky), float(ix), float(kx)]
        n += -(-h * w // 128) * 128      # each level 512-byte aligned
        h_in, w_in = h, w
    return ((ctypes.c_int * len(hw))(*hw),
            (ctypes.c_longlong * len(off))(*off),
            (ctypes.c_float * len(par))(*par), n)


def _pyramid_chain(img: torch.Tensor, sizes, fuse_line: bool):
    """(levels, line level or None): `pyramid_chain`'s levels and, with
    `fuse_line`, img's line level where the first level's launch can make
    it (a CUDA image of at least 2 x 2 and one level) or the CPU's plain
    version."""
    sizes = tuple((int(h), int(w)) for h, w in sizes)
    if img.device.type == "cpu":
        out = [img]
        for h, w in sizes:
            out.append(resize_plain(out[-1], h, w))
        return out[1:], line_level_plain(img) if fuse_line else None
    _check_level("pyramid", img)
    H, W = img.shape
    fused = bool(fuse_line and sizes and H >= 2 and W >= 2)
    hw, off, par, n = _chain_layout(H, W, sizes)
    n_line = (H // 2) * (W // 2) if fused else 0
    # the line level after the levels, in the same allocation
    buf = torch.empty(n + n_line, dtype=torch.float32, device=img.device)
    line = buf[n:].view(H // 2, W // 2) if fused else None
    PYRAMID.launch(cuda.ptr(img), H, W, len(sizes), cuda.ptr(buf), hw, off,
                   par, cuda.ptr(line) if fused else None, cuda.stream(),
                   kernels=len(sizes))
    if fused:
        PYRAMID_LINE.launches += 1
    return [buf[o:o + h * w].view(h, w)
            for o, (h, w) in zip(off, sizes)], line


def pyramid_chain(img: torch.Tensor, sizes) -> List[torch.Tensor]:
    """Levels of `sizes` [(h, w), ...], each `resize_plain` of the one
    above, the first of img: the plain version for a CPU image,
    csrc/pyramid.cu's `pyramid_levels` for a CUDA one (one launch a level,
    all from one host call; down to at most 1/1.5 a side a level)."""
    return _pyramid_chain(img, sizes, False)[0]


def pyramid_chain_line(img: torch.Tensor, sizes):
    """(`pyramid_chain`'s levels, img's line level `line_level_plain`):
    on the card the line level is written by extra blocks of the first
    level's launch (counted in PYRAMID_LINE), or by `line_level` where
    there is no first level."""
    levels, line = _pyramid_chain(img, sizes, True)
    return levels, line if line is not None else line_level(img)


def pyramid_level(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """One pyramid level, `resize_plain`'s function (`pyramid_chain` of
    one level)."""
    return pyramid_chain(img, [(height, width)])[0]


def build_pyramid(img: torch.Tensor,
                  specs: Sequence[LevelSpec]) -> List[torch.Tensor]:
    """[H,W] float32 -> per-level images, each jax.image.resize 'linear'
    (antialiased) of the one above: `pyramid_chain` of specs[1:]."""
    return [img] + pyramid_chain(img, [(sp.height, sp.width)
                                       for sp in specs[1:]])


def build_pyramid_line(img: torch.Tensor, specs: Sequence[LevelSpec]):
    """(`build_pyramid`'s levels, the line front end's level 1 of img),
    the latter from the pyramid's first launch on the card
    (`pyramid_chain_line`)."""
    levels, line = pyramid_chain_line(
        img, [(sp.height, sp.width) for sp in specs[1:]])
    return [img] + levels, line


def line_level(img: torch.Tensor) -> torch.Tensor:
    """The line front end's level 1, `line_level_plain`'s function, for
    callers without a pyramid: the plain version for a CPU image,
    csrc/pyramid.cu's `pyramid_line_level` for a CUDA one (the body the
    pyramid's first launch runs for the frame path)."""
    if img.device.type == "cpu":
        return line_level_plain(img)
    _check_level("pyramid_line", img)
    H, W = img.shape
    out = torch.empty(H // 2, W // 2, dtype=torch.float32, device=img.device)
    if out.numel():
        PYRAMID_LINE.launch(cuda.ptr(img), H, W, cuda.ptr(out),
                            cuda.stream())
    return out


# --------------------------------------------------------------------------
# Kernel 1: orb_fast_grid (FAST + NMS + blend + border + cell argmax)
# --------------------------------------------------------------------------

def _fast_from_diff(diffs: List[torch.Tensor], t: float) -> torch.Tensor:
    brighter = torch.stack([d > t for d in diffs])
    darker = torch.stack([d < -t for d in diffs])

    def has_arc9(bits):
        acc, rolled = bits, bits
        for _ in range(8):
            rolled = torch.roll(rolled, -1, 0)
            acc = acc & rolled
        return acc.any(0)

    # scores summed term by term in circle order (the kernel's order)
    sb = torch.zeros_like(diffs[0])
    sd = torch.zeros_like(diffs[0])
    for d in diffs:
        sb = sb + torch.clamp_min(d - t, 0.0)
        sd = sd + torch.clamp_min(-d - t, 0.0)
    corner = has_arc9(brighter) | has_arc9(darker)
    return torch.where(corner, torch.maximum(sb, sd), torch.zeros_like(sb))


def fast_response2(img: torch.Tensor, th_hi: float, th_lo: float):
    """Dense FAST-16/9 responses at two thresholds from one set of shifted
    images (zero padding, so border pixels never fire)."""
    H, W = img.shape
    pad = F.pad(img, (3, 3, 3, 3))
    diffs = [pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img
             for dx, dy in _CIRCLE.tolist()]
    return _fast_from_diff(diffs, th_hi), _fast_from_diff(diffs, th_lo)


def nms3x3(resp: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima of 3x3 windows (outside counts as -inf)."""
    m = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(resp >= m, resp, torch.zeros_like(resp))


def orb_fast_grid_plain(img: torch.Tensor, th_hi: float, th_lo: float,
                        cell: int = 16, border: int = EDGE):
    """Plain version of `orb_fast_grid`: returns (cell_best [C] float32,
    cell_arg [C] int32 in-cell flat index) over the Hc x Wc cell grid."""
    H, W = img.shape
    f_hi, f_lo = fast_response2(img, th_hi, th_lo)
    r_hi, r_lo = nms3x3(f_hi), nms3x3(f_lo)
    resp = torch.where(r_hi > 0, r_hi + 1e4, r_lo)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    ok = (ys >= border) & (ys < H - border) & (xs >= border) \
        & (xs < W - border)
    r = torch.where(ok, resp, torch.zeros_like(resp))
    Hc, Wc = H // cell, W // cell
    rc = r[:Hc * cell, :Wc * cell].reshape(Hc, cell, Wc, cell) \
        .permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)
    return rc.amax(1), torch.argmax(rc, 1).to(torch.int32)


ORB_FAST_GRID = cuda.Kernel(
    "orb_fast_grid", "orb_fast_grid",
    [ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _F, _F,
     _I, _P, _P, ctypes.POINTER(_I), ctypes.POINTER(_F), _P, _P, _P, _P, _P,
     _P])
ORB_MAX_LEVELS = 8          # the kernel's level table


def _check_levels(name: str, levels: Sequence[torch.Tensor], cell: int):
    cuda.check_cuda(name, *levels)
    if not 1 <= len(levels) <= ORB_MAX_LEVELS or cell != 16 or any(
            im.dtype != torch.float32 or im.dim() != 2 for im in levels):
        raise ValueError(f"{name}: 1 to {ORB_MAX_LEVELS} [H,W] float32 "
                         "levels, 16 px cells")


def orb_fast_grid(img: torch.Tensor, th_hi: float, th_lo: float,
                  cell: int = 16, border: int = EDGE):
    """FAST at two thresholds, 3x3 NMS, blend, border mask and per-cell
    argmax of one level [H,W] float32.  CPU tensors take the plain version;
    CUDA tensors launch csrc/orb_fast_grid.cu's first kernel on this one
    level (the frame path runs `orb_detect`)."""
    if img.device.type == "cpu":
        return orb_fast_grid_plain(img, th_hi, th_lo, cell, border)
    _check_levels("orb_fast_grid", [img], cell)
    H, W = img.shape
    C = (H // cell) * (W // cell)
    best = torch.empty(C, dtype=torch.float32, device=img.device)
    arg = torch.empty(C, dtype=torch.int32, device=img.device)
    ORB_FAST_GRID.launch((_P * 1)(img.data_ptr()), (_I * 1)(H),
                         (_I * 1)(W), 1, float(th_hi), float(th_lo),
                         int(border), cuda.ptr(best), cuda.ptr(arg), None,
                         None, None, None, None, None, None, cuda.stream())
    return best, arg


def select_top_cells(cell_best: torch.Tensor, cell_arg: torch.Tensor,
                     Wc: int, k: int, cell: int = 16):
    """Global top-k over cell winners (select_grid_topk's second half).
    A stable descending sort keeps the lower cell index first on ties, as
    lax.top_k does.  Returns (xy [k,2] float32 level coords, score, valid)."""
    k = min(k, cell_best.shape[0])
    order = torch.sort(cell_best, descending=True, stable=True).indices[:k]
    top_score = cell_best[order]
    within = cell_arg[order].to(torch.int64)
    y = (order // Wc) * cell + within // cell
    x = (order % Wc) * cell + within % cell
    xy = torch.stack([x, y], -1).to(torch.float32)
    return xy, top_score, top_score > 0.0


class Detected(NamedTuple):
    """The detector's keypoints over all levels, level 0's first."""
    xy: torch.Tensor        # [N,2] float32 level coordinates
    response: torch.Tensor  # [N] score, less 1e4 where the high threshold
    valid: torch.Tensor     # [N] bool, score > 0
    octave: torch.Tensor    # [N] int32 level
    uv: torch.Tensor        # [N,2] level-0 coordinates, xy * scale


def orb_detect_plain(levels: Sequence[torch.Tensor],
                     specs: Sequence[LevelSpec], th_hi: float,
                     th_lo: float, cell: int = 16,
                     border: int = EDGE) -> Detected:
    """Plain version of `orb_detect`: per level `orb_fast_grid_plain` and
    `select_top_cells` of its n_keep cells, the response, valid, octave
    and level-0 coordinates (plvio_tpu/ops/frontend.py:346-360), then the
    levels concatenated."""
    xys, scores, valids, octs, uvs = [], [], [], [], []
    for lv, spec in enumerate(specs):
        best, arg = orb_fast_grid_plain(levels[lv], th_hi, th_lo, cell,
                                        border)
        xy, score, valid = select_top_cells(best, arg, spec.width // cell,
                                            spec.n_keep, cell)
        xys.append(xy)
        scores.append(torch.where(score > 1e4, score - 1e4, score))
        valids.append(valid)
        octs.append(torch.full((xy.shape[0],), lv, dtype=torch.int32,
                               device=xy.device))
        uvs.append(xy * spec.scale)
    return Detected(torch.cat(xys), torch.cat(scores), torch.cat(valids),
                    torch.cat(octs), torch.cat(uvs))


@functools.lru_cache(maxsize=None)
def _detect_layout(specs: tuple, cell: int):
    """The host arguments of `orb_detect` for levels of `specs`: ctypes
    arrays of the heights, widths, n_keep and float32 scales, the output
    rows N, and the float32 buffer's offsets of the cells' winners and
    winning indices (C each), xy [N,2], response [N] and uv [N,2] (each
    16-byte aligned, as an allocation of its own would be), and its
    length."""
    n = len(specs)
    cells = [(sp.height // cell) * (sp.width // cell) for sp in specs]
    C = sum(cells)
    N = sum(min(sp.n_keep, c) for sp, c in zip(specs, cells))
    off, at = [], 0
    for floats in (C, C, 2 * N, N, 2 * N):
        off.append(at)
        at += -(-floats // 4) * 4
    return ((_I * n)(*[sp.height for sp in specs]),
            (_I * n)(*[sp.width for sp in specs]),
            (_I * n)(*[sp.n_keep for sp in specs]),
            (_F * n)(*[float(sp.scale) for sp in specs]), N, off, at)


def orb_detect(levels: Sequence[torch.Tensor], specs: Sequence[LevelSpec],
               th_hi: float, th_lo: float, cell: int = 16,
               border: int = EDGE) -> Detected:
    """The ORB detector of a frame's pyramid `levels` (the image, then its
    levels, as `specs` give them): every level's cell winners and each
    level's n_keep best cells as keypoints.  CPU tensors take the plain
    version; CUDA tensors launch csrc/orb_fast_grid.cu: two kernels a
    frame, the cells' scratch and the float outputs in one allocation."""
    if levels[0].device.type == "cpu":
        return orb_detect_plain(levels, specs, th_hi, th_lo, cell, border)
    _check_levels("orb_detect", levels, cell)
    specs = tuple(specs)
    if len(specs) != len(levels) or any(
            (sp.height, sp.width) != tuple(im.shape)
            for sp, im in zip(specs, levels)):
        raise ValueError("orb_detect: a level of each spec's size")
    hs, ws, keep, scales, N, off, n = _detect_layout(specs, cell)
    dev = levels[0].device
    buf = torch.empty(n, dtype=torch.float32, device=dev)
    out = Detected(buf.as_strided((N, 2), (2, 1), off[2]),
                   buf.as_strided((N,), (1,), off[3]),
                   torch.empty(N, dtype=torch.bool, device=dev),
                   torch.empty(N, dtype=torch.int32, device=dev),
                   buf.as_strided((N, 2), (2, 1), off[4]))
    at = buf.data_ptr()
    ptrs = (_P * len(levels))(*[im.data_ptr() for im in levels])
    ORB_FAST_GRID.launch(ptrs, hs, ws, len(levels), float(th_hi),
                         float(th_lo), int(border), _P(at),
                         _P(at + 4 * off[1]), keep, scales,
                         _P(at + 4 * off[2]), _P(at + 4 * off[3]),
                         cuda.ptr(out.valid), cuda.ptr(out.octave),
                         _P(at + 4 * off[4]), cuda.stream(), kernels=2)
    return out


# --------------------------------------------------------------------------
# Kernel 2: orb_describe (patch, IC angle, blur, steered BRIEF)
# --------------------------------------------------------------------------

@functools.lru_cache()
def brief_pattern(seed: int = 7, bits: int = DESC_BITS) -> np.ndarray:
    """[bits, 2, 2] pairs of (x, y) offsets: Gaussian sigma = patch/5,
    clipped to the radius-(PATCH_R-1) disc (the reference's recipe)."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_R + 1) / 5.0
    pts = rng.normal(0.0, sigma, (bits, 2, 2))
    rad = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, (PATCH_R - 1.0) / np.maximum(rad, 1e-9))
    return (pts * scale).astype(np.float32)


def blur_taps(sigma: float = 2.0) -> np.ndarray:
    """The 7 float32 taps of the separable Gaussian."""
    xs = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    return k


def disc_moment_weights(patch: int = PATCH_RAW, radius: int = PATCH_R):
    c = patch // 2
    d = np.arange(patch) - c
    mask = d[:, None] ** 2 + d[None, :] ** 2 <= radius * radius
    return ((mask * d[None, :]).astype(np.float32),
            (mask * d[:, None]).astype(np.float32))


def extract_patches(levels: Sequence[torch.Tensor], xy: torch.Tensor,
                    level: torch.Tensor, patch: int = PATCH_RAW):
    """[K, patch, patch] patches of the bf16-rounded level images centred
    on integer keypoints, 0 outside the image: exactly what the reference's
    one-hot bf16 matmuls produce."""
    r = patch // 2
    Hm = max(im.shape[0] for im in levels) + 2 * r
    Wm = max(im.shape[1] for im in levels) + 2 * r
    canvas = torch.zeros(len(levels), Hm, Wm, dtype=torch.float32,
                         device=xy.device)
    for l, im in enumerate(levels):
        canvas[l, r:r + im.shape[0], r:r + im.shape[1]] = \
            im.to(torch.bfloat16).to(torch.float32)
    ii = torch.arange(patch, device=xy.device)
    rows = xy[:, 1].to(torch.int64)[:, None] + ii[None, :]   # canvas rows
    cols = xy[:, 0].to(torch.int64)[:, None] + ii[None, :]
    lv = level.to(torch.int64)[:, None, None]
    return canvas[lv, rows[:, :, None], cols[:, None, :]]


def ic_angle_patch(patches: torch.Tensor, wx: torch.Tensor,
                   wy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation in degrees [0, 360)."""
    m10 = torch.einsum("kij,ij->k", patches, wx)
    m01 = torch.einsum("kij,ij->k", patches, wy)
    ang = torch.atan2(m01, m10) * _DEG
    return torch.where(ang < 0, ang + 360.0, ang)


def blur_patches(patches: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian, VALID: [K,P,P] -> [K,P-6,P-6]."""
    x = F.conv2d(patches[:, None], taps.view(1, 1, 1, 7))
    x = F.conv2d(x, taps.view(1, 1, 7, 1))
    return x[:, 0]


def brief_descriptors_patch(patches_blur: torch.Tensor,
                            angle_deg: torch.Tensor,
                            pattern: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF from blurred patches: rotate the pattern by the
    keypoint angle, sample bilinearly inside the patch with the reference's
    hat weights (rows first), compare pairs.  Returns [K,8] int32 packed."""
    from .matching import pack_bits_u32
    K, P = patches_blur.shape[0], patches_blur.shape[-1]
    c = P // 2
    th = angle_deg * _RAD
    ca, sa = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px = pattern[:, :, 0].reshape(-1)[None]          # [1,512] bit-major
    py = pattern[:, :, 1].reshape(-1)[None]
    fx = (ca * px - sa * py) + c
    fy = (sa * px + ca * py) + c
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx0 = torch.clamp_min(1.0 - torch.abs(fx - x0), 0.0)
    wx1 = torch.clamp_min(1.0 - torch.abs(fx - (x0 + 1.0)), 0.0)
    wy0 = torch.clamp_min(1.0 - torch.abs(fy - y0), 0.0)
    wy1 = torch.clamp_min(1.0 - torch.abs(fy - (y0 + 1.0)), 0.0)
    flat = patches_blur.reshape(K, P * P)
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)

    def at(y, x):
        inside = (y >= 0) & (y < P) & (x >= 0) & (x < P)
        v = torch.gather(flat, 1, (y.clamp(0, P - 1) * P
                                   + x.clamp(0, P - 1)).expand(K, -1))
        return torch.where(inside, v, torch.zeros_like(v))

    g0 = wy0 * at(yi, xi) + wy1 * at(yi + 1, xi)
    g1 = wy0 * at(yi, xi + 1) + wy1 * at(yi + 1, xi + 1)
    vals = (g0 * wx0 + g1 * wx1).reshape(K, DESC_BITS, 2)
    return pack_bits_u32(vals[..., 0] < vals[..., 1])


def orb_describe_plain(levels: Sequence[torch.Tensor], xy: torch.Tensor,
                       level: torch.Tensor, taps: torch.Tensor,
                       pattern: torch.Tensor, wx: torch.Tensor,
                       wy: torch.Tensor):
    """Plain version of `orb_describe`: (angle [K] degrees, desc [K,8])."""
    patches = extract_patches(levels, xy, level)
    ang = ic_angle_patch(patches, wx, wy)
    return ang, brief_descriptors_patch(blur_patches(patches, taps), ang,
                                        pattern)


ORB_DESCRIBE = cuda.Kernel(
    "orb_describe", "orb_describe",
    [ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I), _I,
     _P, _P, _P, _P, _I, _P, _P, _P])


def orb_describe(levels: Sequence[torch.Tensor], xy: torch.Tensor,
                 level: torch.Tensor, taps: torch.Tensor,
                 pattern: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Angle and packed steered BRIEF of keypoints `xy` [K,2] (integer-
    valued level coords) on pyramid level `level` [K] int32.  CPU tensors
    take the plain version; CUDA tensors launch csrc/orb_describe.cu
    (which builds the disc weights itself, so wx/wy serve the plain path)."""
    if xy.device.type == "cpu":
        return orb_describe_plain(levels, xy, level, taps, pattern, wx, wy)
    cuda.check_cuda("orb_describe", xy, level, taps, pattern, *levels)
    K = xy.shape[0]
    if xy.dtype != torch.float32 or xy.shape != (K, 2) \
            or level.dtype != torch.int32 or level.shape != (K,):
        raise ValueError("orb_describe: xy [K,2] float32, level [K] int32")
    if taps.shape != (7,) or pattern.shape != (DESC_BITS, 2, 2) \
            or taps.dtype != torch.float32 or pattern.dtype != torch.float32:
        raise ValueError("orb_describe: taps [7], pattern [256,2,2] float32")
    if not 1 <= len(levels) <= 8 or any(
            im.dtype != torch.float32 or im.dim() != 2 for im in levels):
        raise ValueError("orb_describe: 1 to 8 [H,W] float32 levels")
    n = len(levels)
    ptrs = (_P * n)(*[im.data_ptr() for im in levels])
    hs = (_I * n)(*[im.shape[0] for im in levels])
    ws = (_I * n)(*[im.shape[1] for im in levels])
    angle = torch.empty(K, dtype=torch.float32, device=xy.device)
    desc = torch.empty(K, 8, dtype=torch.int32, device=xy.device)
    ORB_DESCRIBE.launch(ptrs, hs, ws, n, cuda.ptr(xy), cuda.ptr(level),
                        cuda.ptr(taps), cuda.ptr(pattern), K,
                        cuda.ptr(angle), cuda.ptr(desc), cuda.stream())
    return angle, desc


# --------------------------------------------------------------------------
# Full extractor
# --------------------------------------------------------------------------

class OrbExtractor(nn.Module):
    """The full ORB pipeline on one grayscale image [H,W] float32 [0,255]
    for a fixed geometry.  Holds the fixed BRIEF pattern, blur taps and
    disc weights as buffers.  `plain=True` runs the plain versions of the
    two kernels on any device (for comparing the two paths on the card)."""

    def __init__(self, specs: Sequence[LevelSpec], ini_th: float = 20.0,
                 min_th: float = 7.0, cell: int = 16, plain: bool = False):
        super().__init__()
        self.specs = tuple(specs)
        self.ini_th, self.min_th, self.cell = ini_th, min_th, cell
        self.plain = plain
        wx, wy = disc_moment_weights()
        self.register_buffer("pattern", torch.from_numpy(brief_pattern()))
        self.register_buffer("taps", torch.from_numpy(blur_taps()))
        self.register_buffer("wx", torch.from_numpy(wx))
        self.register_buffer("wy", torch.from_numpy(wy))

    def forward(self, img: torch.Tensor) -> Features:
        return self.features((build_pyramid_plain if self.plain
                              else build_pyramid)(img, self.specs))

    def with_line_level(self, img: torch.Tensor):
        """(Features of img, the line front end's level 1 of img), the
        latter made by the pyramid's first launch on the card (for
        `LineExtractor(img, level1)`)."""
        if self.plain:
            pyr = build_pyramid_plain(img, self.specs)
            level1 = line_level_plain(img)
        else:
            pyr, level1 = build_pyramid_line(img, self.specs)
        return self.features(pyr), level1

    def features(self, pyr: List[torch.Tensor]) -> Features:
        """Features of the image pyramid `pyr` (the image, then its
        levels)."""
        detect = orb_detect_plain if self.plain else orb_detect
        describe = orb_describe_plain if self.plain else orb_describe
        d = detect(pyr, self.specs, self.ini_th, self.min_th, self.cell)
        angle, desc = describe(pyr, d.xy, d.octave, self.taps, self.pattern,
                               self.wx, self.wy)
        return Features(uv=d.uv, uv_und=d.uv, response=d.response,
                        angle=angle, octave=d.octave, desc=desc,
                        valid=d.valid)


def extract_orb(img: torch.Tensor, specs: Tuple[LevelSpec, ...],
                ini_th: float = 20.0, min_th: float = 7.0,
                cell: int = 16) -> Features:
    """Functional form of `OrbExtractor` (builds its buffers per call)."""
    return OrbExtractor(specs, ini_th, min_th, cell).to(img.device)(img)


def make_extractor(height: int, width: int, n_features: int = 1000,
                   n_levels: int = 8, scale: float = 1.2,
                   ini_th: float = 20.0, min_th: float = 7.0,
                   device="cuda", plain: bool = False):
    """Extractor module for a fixed image geometry, and its level specs
    (on the card unless `device` says otherwise)."""
    specs = tuple(make_level_specs(height, width, n_features, n_levels,
                                   scale))
    return OrbExtractor(specs, ini_th, min_th, plain=plain).to(
        cuda.resolve_device(device)), specs
