"""ORB point front end (port of plvio_tpu/ops/frontend.py).

Same pipeline and numbers as the reference: 8-level x1.2 pyramid, dense
FAST-16/9 at two thresholds with 3x3 NMS and a blend, one winner per 16 px
cell, a stable top-k of cell winners per level, intensity-centroid angle,
7x7 Gaussian blur of each patch and steered 256-bit BRIEF on the seed-7
numpy pattern.  Two stages are hand-written CUDA kernels:

* `orb_fast_grid` (csrc/orb_fast_grid.cu): FAST + NMS + blend + border +
  per-cell argmax of one level;
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


def build_pyramid(img: torch.Tensor,
                  specs: Sequence[LevelSpec]) -> List[torch.Tensor]:
    """[H,W] float32 -> per-level images, each an antialiased bilinear
    resize of the one above (jax.image.resize 'linear' antialiases when it
    downsamples, so antialias=True is the matching mode)."""
    out = [img]
    for spec in specs[1:]:
        out.append(F.interpolate(out[-1][None, None],
                                 size=(spec.height, spec.width),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)[0, 0])
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


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ORB_FAST_GRID = cuda.Kernel("orb_fast_grid", "orb_fast_grid",
                            [_P, _I, _I, _F, _F, _I, _P, _P, _P])


def orb_fast_grid(img: torch.Tensor, th_hi: float, th_lo: float,
                  cell: int = 16, border: int = EDGE):
    """FAST at two thresholds, 3x3 NMS, blend, border mask and per-cell
    argmax of one level [H,W] float32.  CPU tensors take the plain version;
    CUDA tensors launch csrc/orb_fast_grid.cu."""
    if img.device.type == "cpu":
        return orb_fast_grid_plain(img, th_hi, th_lo, cell, border)
    cuda.check_cuda("orb_fast_grid", img)
    if img.dtype != torch.float32 or img.dim() != 2 or cell != 16:
        raise ValueError("orb_fast_grid: [H,W] float32 image, 16 px cells")
    H, W = img.shape
    C = (H // cell) * (W // cell)
    best = torch.empty(C, dtype=torch.float32, device=img.device)
    arg = torch.empty(C, dtype=torch.int32, device=img.device)
    ORB_FAST_GRID.launch(cuda.ptr(img), H, W, float(th_hi), float(th_lo),
                         int(border), cuda.ptr(best), cuda.ptr(arg),
                         cuda.stream())
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
        fast = orb_fast_grid_plain if self.plain else orb_fast_grid
        describe = orb_describe_plain if self.plain else orb_describe
        pyr = build_pyramid(img, self.specs)
        xys, scores, valids, octs, scales = [], [], [], [], []
        for lv, spec in enumerate(self.specs):
            best, arg = fast(pyr[lv], self.ini_th, self.min_th, self.cell)
            xy, score, valid = select_top_cells(
                best, arg, spec.width // self.cell, spec.n_keep, self.cell)
            xys.append(xy)
            scores.append(torch.where(score > 1e4, score - 1e4, score))
            valids.append(valid)
            octs.append(torch.full((xy.shape[0],), lv, dtype=torch.int32,
                                   device=img.device))
            scales.append(spec.scale)
        xy_all = torch.cat(xys)
        octave = torch.cat(octs)
        angle, desc = describe(pyr, xy_all, octave, self.taps, self.pattern,
                               self.wx, self.wy)
        uv = torch.cat([xy * s for xy, s in zip(xys, scales)])
        return Features(uv=uv, uv_und=uv, response=torch.cat(scores),
                        angle=angle, octave=octave, desc=desc,
                        valid=torch.cat(valids))


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
