"""Line segments + LBD descriptors (port of plvio_tpu/ops/lines.py, the
detector-0 path: cell structure tensors, pointer-jumping connected
components, collinear merge, sub-pixel refit, banded LBD, 2-level pyramid).

Two hand-written CUDA kernels carry a level on the card: `line_detect`
(csrc/line_detect.cu: gradients, cells, links, components, top-K) and
`line_refine_lbd` (csrc/line_refine_lbd.cu: merge, refit, angle, LBD, line
equation, level-1 dedupe).  The plain functions below (`detect_lines`,
`refine_lbd_plain` and what they call) are their plain versions and the
CPU path.  The reference's dtype flow is kept: Scharr gradients, their
magnitude and the edge weights are bfloat16, the cell statistics upcast to
float32 where the reference upcasts (plvio_tpu/ops/lines.py:93).
Descriptors are packed [L,8] int32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import cuda
from .frontend import line_level, line_level_plain
from .matching import pack_bits_u32

CELL_PX = 4
N_BANDS = 9
BAND_W = 3          # rows per band (perpendicular direction)
N_ALONG = 16        # samples along the line
_BIG = 1e9


class LineFeatures(NamedTuple):
    ep: torch.Tensor        # [L,4] (x1,y1,x2,y2) endpoints, image coords
    angle: torch.Tensor     # [L] direction in [0, pi)
    length: torch.Tensor    # [L]
    lineq: torch.Tensor     # [L,3] normalized 2D line equation (a,b,c)
    desc: torch.Tensor      # [L,8] int32 packed LBD
    valid: torch.Tensor     # [L] bool


def _linspace(a: float, b: float, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.linspace(a, b, n).astype(np.float32)).to(
        device)


def _mod_pi(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x, math.pi)


def _gradients(img: torch.Tensor, dtype=torch.bfloat16):
    """Scharr gradients [H,W] -> gx, gy in `dtype` (zero 'SAME' padding).
    The products of bf16 pixels and the bf16-exact taps are exact in
    float32, so one float32 conv rounded once to bf16 is the reference's
    bf16 conv."""
    kx = torch.tensor([[-3., 0., 3.], [-10., 0., 10.], [-3., 0., 3.]],
                      device=img.device) / 32.0
    k2 = torch.stack([kx, kx.T])[:, None]                 # [2,1,3,3]
    x = img.to(dtype).to(torch.float32)[None, None]
    g = F.conv2d(x, k2, padding=1)[0].to(dtype)
    return g[0], g[1]


def _eig_dir(sxx, sxy, syy):
    """Principal direction (unit) of a 2x2 scatter; (1, 0) if degenerate."""
    tr = sxx + syy
    disc = torch.sqrt(torch.clamp_min(tr * tr / 4 - (sxx * syy - sxy * sxy),
                                      0.0))
    lam1 = tr / 2 + disc
    vx, vy = sxy, lam1 - sxx
    return vx, vy, torch.sqrt(vx * vx + vy * vy)


def detect_lines(img: torch.Tensor, max_lines: int = 256,
                 grad_th: float = 12.0, min_cells: int = 3,
                 aniso_th: float = 4.0, angle_tol: float = 0.12,
                 dist_tol: float = 1.5, min_length: float = 12.0,
                 jump_iters: int = 7):
    """Detect up to `max_lines` segments.  Returns (ep [L,4], angle [L],
    length [L], valid [L], (gx, gy))."""
    dev = img.device
    H, W = img.shape
    Hc, Wc = H // CELL_PX, W // CELL_PX
    C = Hc * Wc
    gx, gy = _gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ys = torch.arange(H, device=dev)[:, None]
    xs_ = torch.arange(W, device=dev)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs_ >= 3) & (xs_ < W - 3)
    mag = torch.where(interior, mag, torch.zeros_like(mag))
    edge = mag > grad_th
    w = torch.where(edge, mag, torch.zeros_like(mag))

    g3 = torch.stack([w, gx, gy])
    cell3 = g3[:, :Hc * CELL_PX, :Wc * CELL_PX] \
        .reshape(3, Hc, CELL_PX, Wc, CELL_PX).permute(0, 1, 3, 2, 4) \
        .reshape(3, C, CELL_PX * CELL_PX).to(torch.float32)
    wc_, gxc, gyc = cell3[0], cell3[1], cell3[2]
    cid = torch.arange(C, device=dev)
    sub = torch.arange(CELL_PX * CELL_PX, device=dev)
    xc = ((cid % Wc)[:, None] * CELL_PX + (sub % CELL_PX)[None, :]).float()
    yc = ((cid // Wc)[:, None] * CELL_PX + (sub // CELL_PX)[None, :]).float()

    wsum = wc_.sum(-1)
    cnt = (wc_ > 0).sum(-1)
    cx = (wc_ * xc).sum(-1) / torch.clamp_min(wsum, 1e-6)
    cy = (wc_ * yc).sum(-1) / torch.clamp_min(wsum, 1e-6)
    sxx = (wc_ * gxc * gxc).sum(-1)
    sxy = (wc_ * gxc * gyc).sum(-1)
    syy = (wc_ * gyc * gyc).sum(-1)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp_min(tr * tr / 4 - det, 0.0))
    l1 = tr / 2 + disc
    l2 = tr / 2 - disc
    aniso = l1 / torch.clamp_min(l2, 1e-6)
    nx, ny = sxy, l1 - sxx
    nn_ = torch.sqrt(nx * nx + ny * ny)
    nx = torch.where(nn_ > 1e-6, nx / nn_, torch.ones_like(nx))
    ny = torch.where(nn_ > 1e-6, ny / nn_, torch.zeros_like(ny))
    dx, dy = -ny, nx
    theta = _mod_pi(torch.atan2(dy, dx))

    atom = (cnt >= min_cells) & (aniso > aniso_th) \
        & (wsum > grad_th * min_cells)

    # ---- adjacency + pointer-jumping union find -----------------------
    idx = torch.arange(C, device=dev)
    labels = torch.where(atom, idx, torch.full_like(idx, C))
    offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
               (0, 1), (1, -1), (1, 0), (1, 1)]

    def to2d(a):
        return a.reshape(Hc, Wc)

    atom2, th2 = to2d(atom), to2d(theta)
    cx2, cy2, dx2, dy2 = to2d(cx), to2d(cy), to2d(dx), to2d(dy)
    rr = torch.arange(Hc, device=dev)[:, None]
    cc = torch.arange(Wc, device=dev)[None, :]
    links = []
    for dr, dc in offsets:
        ok = (rr + dr >= 0) & (rr + dr < Hc) & (cc + dc >= 0) \
            & (cc + dc < Wc)

        def sh(a):
            return torch.roll(a, (-dr, -dc), (0, 1))

        dth = _mod_pi(torch.abs(th2 - sh(th2)))
        link = ok & atom2 & sh(atom2) \
            & (torch.minimum(dth, math.pi - dth) < angle_tol)
        ddx = sh(cx2) - cx2
        ddy = sh(cy2) - cy2
        perp_ij = torch.abs(-dy2 * ddx + dx2 * ddy)
        perp_ji = torch.abs(-sh(dy2) * ddx + sh(dx2) * ddy)
        links.append(link & (perp_ij < dist_tol) & (perp_ji < dist_tol))

    dead = torch.full((Hc, Wc), C, dtype=labels.dtype, device=dev)
    for _ in range(jump_iters):
        lab2 = to2d(labels)
        best = lab2
        for (dr, dc), link in zip(offsets, links):
            best = torch.minimum(best, torch.where(
                link, torch.roll(lab2, (-dr, -dc), (0, 1)), dead))
        best = best.reshape(C)
        best = torch.minimum(best, torch.where(
            best < C, labels[best.clamp(0, C - 1)], torch.full_like(best, C)))
        best = torch.minimum(best, torch.where(
            best < C, best[best.clamp(0, C - 1)], torch.full_like(best, C)))
        labels = best

    # ---- per-component aggregation ------------------------------------
    lbl = labels.clamp(0, C)
    wgt = torch.where(atom & (labels < C), wsum, torch.zeros_like(wsum))
    occ = (wgt > 0).float()
    pay1 = torch.stack([wgt, wgt * cx, wgt * cy, occ], -1)
    agg1 = torch.zeros(C + 1, 4, device=dev).index_add_(0, lbl, pay1)
    s_w, s_x, s_y, s_n = agg1[:, 0], agg1[:, 1], agg1[:, 2], agg1[:, 3]
    mx = s_x / torch.clamp_min(s_w, 1e-6)
    my = s_y / torch.clamp_min(s_w, 1e-6)
    ex = cx - mx[lbl]
    ey = cy - my[lbl]
    pay2 = torch.stack([wgt * ex * ex, wgt * ex * ey, wgt * ey * ey],
                       -1) * occ[:, None]
    agg2 = torch.zeros(C + 1, 3, device=dev).index_add_(0, lbl, pay2)
    vx, vy, vn = _eig_dir(agg2[:, 0], agg2[:, 1], agg2[:, 2])
    vx = torch.where(vn > 1e-6, vx / vn, torch.ones_like(vx))
    vy = torch.where(vn > 1e-6, vy / vn, torch.zeros_like(vy))

    proj = (cx - mx[lbl]) * vx[lbl] + (cy - my[lbl]) * vy[lbl]
    has = wgt > 0
    pmin = torch.full((C + 1,), _BIG, device=dev).scatter_reduce(
        0, lbl, torch.where(has, proj, torch.full_like(proj, _BIG)), "amin")
    pmax = torch.full((C + 1,), -_BIG, device=dev).scatter_reduce(
        0, lbl, torch.where(has, proj, torch.full_like(proj, -_BIG)), "amax")

    is_root = (labels == idx) & atom
    length = torch.where(is_root, pmax[:C] - pmin[:C], torch.zeros_like(wsum))
    good_root = is_root & (s_n[:C] >= min_cells) & (length >= min_length)
    score = torch.where(good_root, length, torch.zeros_like(length))
    # stable descending sort: lax.top_k keeps the lower index first on ties
    order = torch.sort(score, descending=True, stable=True).indices
    r = order[:max_lines]
    top_score = score[r]
    valid = top_score > 0.0
    x1 = mx[r] + pmin[r] * vx[r]
    y1 = my[r] + pmin[r] * vy[r]
    x2 = mx[r] + pmax[r] * vx[r]
    y2 = my[r] + pmax[r] * vy[r]
    ep = torch.stack([x1, y1, x2, y2], -1)
    ang = _mod_pi(torch.atan2(y2 - y1, x2 - x1))
    return ep, ang, top_score, valid, (gx, gy)


# --------------------------------------------------------------------------
# LBD-style banded descriptor
# --------------------------------------------------------------------------

@functools.lru_cache()
def _band_pair_pattern(seed: int = 11, bits: int = 256) -> np.ndarray:
    """[bits, 2, 2]: pairs of (band, stat) indices to compare."""
    rng = np.random.default_rng(seed)
    pat = np.stack([rng.integers(0, N_BANDS, (bits, 2)),
                    rng.integers(0, 8, (bits, 2))], axis=-1)
    same = (pat[:, 0, 0] == pat[:, 1, 0]) & (pat[:, 0, 1] == pat[:, 1, 1])
    pat[same, 1, 0] = (pat[same, 1, 0] + 1) % N_BANDS
    return pat.astype(np.int32)


def _gather2(gx: torch.Tensor, gy: torch.Tensor, yi: torch.Tensor,
             xi: torch.Tensor):
    W = gx.shape[1]
    flat = (yi * W + xi).reshape(-1)
    return (gx.reshape(-1)[flat].reshape(yi.shape),
            gy.reshape(-1)[flat].reshape(yi.shape))


def lbd_descriptors(gx: torch.Tensor, gy: torch.Tensor, ep: torch.Tensor,
                    valid: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """[L,4] endpoints -> [L,8] int32 packed LBD (band mean/std of the
    gradient projections, compared in the seed-11 band-pair pattern)."""
    H, W = gx.shape
    dev = ep.device
    x1, y1, x2, y2 = ep[:, 0], ep[:, 1], ep[:, 2], ep[:, 3]
    mxm = (x1 + x2) / 2
    mym = (y1 + y2) / 2
    dx = x2 - x1
    dy = y2 - y1
    length = torch.sqrt(dx * dx + dy * dy)
    ux = dx / torch.clamp_min(length, 1e-6)
    uy = dy / torch.clamp_min(length, 1e-6)
    nx_, ny_ = -uy, ux
    t_along = _linspace(-0.5, 0.5, N_ALONG, dev)
    half = (N_BANDS * BAND_W - 1) / 2.0
    t_perp = torch.arange(N_BANDS * BAND_W, dtype=torch.float32,
                          device=dev) - half
    sx = (mxm[:, None, None]
          + ux[:, None, None] * (t_along[None, None, :]
                                 * length[:, None, None])
          + nx_[:, None, None] * t_perp[None, :, None])
    sy = (mym[:, None, None]
          + uy[:, None, None] * (t_along[None, None, :]
                                 * length[:, None, None])
          + ny_[:, None, None] * t_perp[None, :, None])
    x0 = torch.round(sx).clamp(0, W - 1).to(torch.int64)
    y0 = torch.round(sy).clamp(0, H - 1).to(torch.int64)
    gxs, gys = _gather2(gx, gy, y0, x0)
    g_par = gxs * ux[:, None, None] + gys * uy[:, None, None]
    g_perp = gxs * nx_[:, None, None] + gys * ny_[:, None, None]
    feats = torch.stack([torch.clamp_min(g_perp, 0.0),
                         torch.clamp_min(-g_perp, 0.0),
                         torch.clamp_min(g_par, 0.0),
                         torch.clamp_min(-g_par, 0.0)], -1)
    L = ep.shape[0]
    bands = feats.reshape(L, N_BANDS, BAND_W * N_ALONG, 4)
    mean = bands.mean(2)
    std = bands.std(2, correction=0)           # jnp.std: population std
    stats = torch.cat([mean, std], -1)          # [L,9,8]
    pl = pairs.to(torch.int64)
    a = stats[:, pl[:, 0, 0], pl[:, 0, 1]]
    b = stats[:, pl[:, 1, 0], pl[:, 1, 1]]
    return pack_bits_u32(a > b)


def line_equation(ep: torch.Tensor) -> torch.Tensor:
    """[L,4] -> normalized homogeneous line eq (a,b,c), |(a,b)| = 1."""
    one = torch.ones_like(ep[:, :1])
    sp = torch.cat([ep[:, :2], one], -1)
    e = torch.cat([ep[:, 2:], one], -1)
    l = torch.linalg.cross(sp, e, dim=-1)
    n = torch.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2)
    return l / torch.clamp_min(n, 1e-9)[:, None]


def merge_collinear(ep: torch.Tensor, valid: torch.Tensor,
                    angle_tol: float = 0.20, perp_tol: float = 2.5,
                    gap_tol: float = 30.0, iters: int = 8):
    """Merge collinear fragments (min-label union over the [L,L] links,
    then a refit from the members' endpoints).  Returns (ep, length,
    valid) with merged children invalidated."""
    dev = ep.device
    L = ep.shape[0]
    d = ep[:, 2:] - ep[:, :2]
    seg_len = torch.sqrt((d * d).sum(-1))
    dn = d / torch.clamp_min(seg_len, 1e-6)[:, None]
    mid = (ep[:, :2] + ep[:, 2:]) / 2
    theta = _mod_pi(torch.atan2(dn[:, 1], dn[:, 0]))

    dth = _mod_pi(torch.abs(theta[:, None] - theta[None, :]))
    dth = torch.minimum(dth, math.pi - dth)
    dm = mid[None, :, :] - mid[:, None, :]
    perp_ij = torch.abs(-dn[:, None, 1] * dm[..., 0]
                        + dn[:, None, 0] * dm[..., 1])
    perp_ji = torch.abs(-dn[None, :, 1] * dm[..., 0]
                        + dn[None, :, 0] * dm[..., 1])
    along = torch.abs(dn[:, None, 0] * dm[..., 0]
                      + dn[:, None, 1] * dm[..., 1])
    gap = along - (seg_len[:, None] + seg_len[None, :]) / 2
    ptol = torch.clamp_max(perp_tol + 0.09 * along, 6.0)
    link = (dth < angle_tol) & (perp_ij < ptol) & (perp_ji < ptol) \
        & (gap < gap_tol) & valid[:, None] & valid[None, :]

    idx = torch.arange(L, device=dev)
    labels = torch.where(valid, idx, torch.full_like(idx, L))
    for _ in range(iters):
        cand = torch.where(link, labels[None, :].expand(L, L),
                           torch.full((L, L), L, device=dev,
                                      dtype=labels.dtype))
        best = torch.minimum(labels, cand.min(-1).values)
        labels = torch.minimum(best, torch.where(
            best < L, labels[best.clamp(0, L - 1)], torch.full_like(best, L)))
    lbl = labels.clamp(0, L)

    w = torch.where(valid & (labels < L), seg_len, torch.zeros_like(seg_len))

    def seg_sum(v):
        return torch.zeros(L + 1, device=dev).index_add_(0, lbl, v)

    wsum = seg_sum(w)
    exs = torch.stack([ep[:, 0], ep[:, 2]], -1)
    eys = torch.stack([ep[:, 1], ep[:, 3]], -1)
    we = (w / 2)[:, None].expand(L, 2)
    mx = seg_sum((we * exs).sum(-1)) / torch.clamp_min(wsum, 1e-6)
    my = seg_sum((we * eys).sum(-1)) / torch.clamp_min(wsum, 1e-6)
    dxs = exs - mx[lbl][:, None]
    dys = eys - my[lbl][:, None]
    vx, vy, vn = _eig_dir(seg_sum((we * dxs * dxs).sum(-1)),
                          seg_sum((we * dxs * dys).sum(-1)),
                          seg_sum((we * dys * dys).sum(-1)))
    own = torch.cat([dn, torch.zeros(1, 2, device=dev, dtype=dn.dtype)], 0)
    vx = torch.where(vn > 1e-6, vx / torch.clamp_min(vn, 1e-9), own[:, 0])
    vy = torch.where(vn > 1e-6, vy / torch.clamp_min(vn, 1e-9), own[:, 1])
    proj_s = (ep[:, 0] - mx[lbl]) * vx[lbl] + (ep[:, 1] - my[lbl]) * vy[lbl]
    proj_e = (ep[:, 2] - mx[lbl]) * vx[lbl] + (ep[:, 3] - my[lbl]) * vy[lbl]
    has = w > 0
    pmin = torch.full((L + 1,), _BIG, device=dev).scatter_reduce(
        0, lbl, torch.where(has, torch.minimum(proj_s, proj_e),
                            torch.full_like(proj_s, _BIG)), "amin")
    pmax = torch.full((L + 1,), -_BIG, device=dev).scatter_reduce(
        0, lbl, torch.where(has, torch.maximum(proj_s, proj_e),
                            torch.full_like(proj_s, -_BIG)), "amax")

    is_root = valid & (labels == idx)
    merged = torch.stack([(mx + pmin * vx)[:L], (my + pmin * vy)[:L],
                          (mx + pmax * vx)[:L], (my + pmax * vy)[:L]], -1)
    ep_out = torch.where(is_root[:, None], merged, ep)
    len_out = torch.where(is_root, (pmax - pmin)[:L],
                          torch.zeros_like(seg_len))
    return ep_out, len_out, is_root


def refine_segments(gx: torch.Tensor, gy: torch.Tensor, ep: torch.Tensor,
                    valid: torch.Tensor, n_samples: int = 32,
                    search_r: float = 2.5, n_search: int = 7):
    """Sub-pixel refit: snap samples along each segment to the gradient
    magnitude centroid across it, then a two-pass weighted TLS refit."""
    H, W = gx.shape
    dev = ep.device
    d = ep[:, 2:] - ep[:, :2]
    seg_len = torch.sqrt((d * d).sum(-1))
    dn = d / torch.clamp_min(seg_len, 1e-6)[:, None]
    nrm = torch.stack([-dn[:, 1], dn[:, 0]], -1)

    t = _linspace(0.05, 0.95, n_samples, dev)
    base = ep[:, None, :2] + t[None, :, None] * d[:, None, :]
    off = _linspace(-search_r, search_r, n_search, dev)
    pts = base[:, :, None, :] + off[None, None, :, None] \
        * nrm[:, None, None, :]
    xr = torch.round(pts[..., 0]).clamp(0, W - 1).to(torch.int64)
    yr = torch.round(pts[..., 1]).clamp(0, H - 1).to(torch.int64)
    gxs, gys = _gather2(gx, gy, yr, xr)                   # bf16
    gnorm = torch.sqrt(gxs * gxs + gys * gys)             # bf16
    gdot = torch.abs(gxs * nrm[:, None, None, 0] + gys * nrm[:, None, None, 1])
    align = gdot / torch.clamp_min(gnorm, 1e-6)
    # bf16 * a weak-typed float scalar stays bf16 in the reference
    w = gnorm * (align > 0.85).to(gnorm.dtype)
    wsum = w.sum(-1)                                      # bf16
    snap = (w * off[None, None, :]).sum(-1) / torch.clamp_min(wsum, 1e-6)
    good_s = wsum > 1.0
    pref = base + snap[..., None] * nrm[:, None, :]
    ws0 = torch.where(good_s, wsum, torch.zeros_like(wsum))   # bf16

    def tls(ws):
        W_ = ws.sum(-1)
        mx = (ws * pref[..., 0]).sum(-1) / torch.clamp_min(W_, 1e-6)
        my = (ws * pref[..., 1]).sum(-1) / torch.clamp_min(W_, 1e-6)
        ux = pref[..., 0] - mx[:, None]
        uy = pref[..., 1] - my[:, None]
        vx, vy, vn = _eig_dir((ws * ux * ux).sum(-1), (ws * ux * uy).sum(-1),
                              (ws * uy * uy).sum(-1))
        vx = torch.where(vn > 1e-6, vx / torch.clamp_min(vn, 1e-9), dn[:, 0])
        vy = torch.where(vn > 1e-6, vy / torch.clamp_min(vn, 1e-9), dn[:, 1])
        return mx, my, vx, vy

    mx, my, vx, vy = tls(ws0)
    resid = torch.abs(-(vy[:, None]) * (pref[..., 0] - mx[:, None])
                      + vx[:, None] * (pref[..., 1] - my[:, None]))
    ws1 = torch.where(resid < 1.0, ws0, torch.zeros_like(ws0))
    enough = ws1.sum(-1) > 0.5 * torch.clamp_min(ws0.sum(-1), 1e-6)
    mx, my, vx, vy = tls(torch.where(enough[:, None], ws1, ws0))
    p_s = (ep[:, 0] - mx) * vx + (ep[:, 1] - my) * vy
    p_e = (ep[:, 2] - mx) * vx + (ep[:, 3] - my) * vy
    ep_ref = torch.stack([mx + p_s * vx, my + p_s * vy,
                          mx + p_e * vx, my + p_e * vy], -1)
    ok = valid & (good_s.sum(-1) >= n_samples // 2)
    return torch.where(ok[:, None], ep_ref, ep)


def _level1_dedupe(f1: "LineFeatures", f0: "LineFeatures") -> "LineFeatures":
    """Level-1 segments mapped to level-0 pixel centres, dropped where a
    valid level-0 segment already covers them."""
    ep1 = f1.ep * 2.0 + 0.5
    a1 = _mod_pi(torch.atan2(ep1[:, 3] - ep1[:, 1], ep1[:, 2] - ep1[:, 0]))
    dang = _mod_pi(torch.abs(a1[:, None] - f0.angle[None, :]))
    dang = torch.minimum(dang, math.pi - dang)
    l0 = f0.lineq
    d_s = torch.abs(ep1[:, None, 0] * l0[None, :, 0]
                    + ep1[:, None, 1] * l0[None, :, 1] + l0[None, :, 2])
    d_e = torch.abs(ep1[:, None, 2] * l0[None, :, 0]
                    + ep1[:, None, 3] * l0[None, :, 1] + l0[None, :, 2])
    dup = (dang < 0.1) & (d_s < 4.0) & (d_e < 4.0) & f0.valid[None, :]
    return LineFeatures(ep=ep1, angle=a1, length=f1.length * 2.0,
                        lineq=line_equation(ep1), desc=f1.desc,
                        valid=f1.valid & ~dup.any(1))


def refine_lbd_plain(gx, gy, ep, valid, pairs, level0=None) -> LineFeatures:
    """Plain version of `line_refine_lbd`: merge + refit + angle + LBD +
    line equation of one level's detections; with `level0` (level 1 of
    the pyramid) the segments are mapped to level-0 pixels and deduped."""
    ep, length, valid = merge_collinear(ep, valid)
    ep = refine_segments(gx, gy, ep, valid)
    ang = _mod_pi(torch.atan2(ep[:, 3] - ep[:, 1], ep[:, 2] - ep[:, 0]))
    f = LineFeatures(ep=ep, angle=ang, length=length, lineq=line_equation(ep),
                     desc=lbd_descriptors(gx, gy, ep, valid, pairs),
                     valid=valid)
    return f if level0 is None else _level1_dedupe(f, level0)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LINE_DETECT = cuda.Kernel("line_detect", "line_detect",
                          [_P, _I, _I, _F, _I, _F, _F, _F, _F, _I]
                          + [_P] * 8 + [_P])
LINE_DETECT_GATHER = cuda.Kernel("line_detect", "line_detect_gather",
                                 [_P, _I, _P, _P, _P, _P, _P, _P, _P])
LINE_REFINE_LBD = cuda.Kernel("line_refine_lbd", "line_refine_lbd",
                              [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                               _P])
_SMEM_MAX = 232448          # bytes of shared memory a block may use


def line_detect(img: torch.Tensor, max_lines: int = 256,
                grad_th: float = 12.0, min_cells: int = 3,
                aniso_th: float = 4.0, angle_tol: float = 0.12,
                dist_tol: float = 1.5, min_length: float = 12.0,
                jump_iters: int = 7):
    """`detect_lines` through csrc/line_detect.cu (CPU tensors take the
    plain version).  Returns (ep [L,4], angle [L], length [L], valid [L],
    (gx, gy) bf16)."""
    if img.device.type == "cpu":
        return detect_lines(img, max_lines, grad_th, min_cells, aniso_th,
                            angle_tol, dist_tol, min_length, jump_iters)
    cuda.check_cuda("line_detect", img)
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError("line_detect: a float32 [H,W] image")
    H, W = img.shape
    C = (H // CELL_PX) * (W // CELL_PX)
    if C == 0 or 2 * 4 * C > _SMEM_MAX:
        raise ValueError(f"line_detect: {C} cells; the label grid must fit "
                         "in shared memory (1 <= cells <= 29056)")
    dev = img.device
    gx = torch.empty(H, W, dtype=torch.bfloat16, device=dev)
    gy = torch.empty_like(gx)
    cell = torch.empty(C, 3, device=dev)
    atom = torch.empty(C, dtype=torch.uint8, device=dev)
    links = torch.empty(C, dtype=torch.uint8, device=dev)
    agg = torch.empty(C + 1, 8, dtype=torch.int64, device=dev)
    comp = torch.empty(C + 1, 6, device=dev)
    score = torch.empty(C, device=dev)
    LINE_DETECT.launch(
        cuda.ptr(img), H, W, grad_th, min_cells, aniso_th, angle_tol,
        dist_tol, min_length, jump_iters, cuda.ptr(gx), cuda.ptr(gy),
        cuda.ptr(cell), cuda.ptr(atom), cuda.ptr(links), cuda.ptr(agg),
        cuda.ptr(comp), cuda.ptr(score), cuda.stream())
    # top-K: stable descending sort, lower index first on ties (lax.top_k)
    order = torch.sort(score, descending=True, stable=True).indices[
        :max_lines].contiguous()
    n = order.shape[0]
    ep = torch.empty(n, 4, device=dev)
    ang = torch.empty(n, device=dev)
    length = torch.empty(n, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    LINE_DETECT_GATHER.launch(
        cuda.ptr(order), n, cuda.ptr(comp), cuda.ptr(score), cuda.ptr(ep),
        cuda.ptr(ang), cuda.ptr(length), cuda.ptr(valid), cuda.stream())
    return ep, ang, length, valid, (gx, gy)


def line_refine_lbd(gx, gy, ep, valid, pairs, level0=None) -> LineFeatures:
    """`refine_lbd_plain` through csrc/line_refine_lbd.cu (CPU tensors take
    the plain version)."""
    if gx.device.type == "cpu":
        return refine_lbd_plain(gx, gy, ep, valid, pairs, level0)
    L = ep.shape[0]
    dev = ep.device
    pairs = pairs.to(torch.int32).contiguous()
    cuda.check_cuda("line_refine_lbd", gx, gy, ep, valid, pairs)
    if gx.dtype != torch.bfloat16 or gy.shape != gx.shape \
            or ep.shape != (L, 4) or valid.shape != (L,) \
            or valid.dtype != torch.bool or ep.dtype != torch.float32 \
            or pairs.shape != (256, 2, 2):
        raise ValueError("line_refine_lbd: shape or dtype mismatch")
    if L > 256:
        raise ValueError("line_refine_lbd: at most 256 segments a level")
    out = LineFeatures(
        ep=torch.empty(L, 4, device=dev), angle=torch.empty(L, device=dev),
        length=torch.empty(L, device=dev), lineq=torch.empty(L, 3, device=dev),
        desc=torch.empty(L, 8, dtype=torch.int32, device=dev),
        valid=torch.empty(L, dtype=torch.bool, device=dev))
    ep_m = torch.empty(L, 4, device=dev)
    len_m = torch.empty(L, device=dev)
    valid_m = torch.empty(L, dtype=torch.bool, device=dev)
    l0 = level0
    if l0 is not None:
        cuda.check_cuda("line_refine_lbd", l0.lineq, l0.angle, l0.valid)
    H, W = gx.shape
    LINE_REFINE_LBD.launch(
        cuda.ptr(gx), cuda.ptr(gy), H, W, cuda.ptr(ep), cuda.ptr(valid), L,
        cuda.ptr(pairs), cuda.ptr(ep_m), cuda.ptr(len_m), cuda.ptr(valid_m),
        *(cuda.ptr(t) for t in out), int(l0 is not None),
        *((cuda.ptr(l0.lineq), cuda.ptr(l0.angle), cuda.ptr(l0.valid),
           l0.ep.shape[0]) if l0 is not None else (None, None, None, 0)),
        cuda.stream())
    return out


def extract_lines(img: torch.Tensor, max_lines: int, pairs: torch.Tensor,
                  plain: bool = False, level0=None, **kw) -> LineFeatures:
    """Detect + merge collinear fragments + refit + LBD + line equations.
    Kernels for CUDA tensors unless `plain`."""
    if plain:
        ep, _, _, valid, (gx, gy) = detect_lines(img, max_lines, **kw)
        return refine_lbd_plain(gx, gy, ep, valid, pairs, level0)
    ep, _, _, valid, (gx, gy) = line_detect(img, max_lines, **kw)
    return line_refine_lbd(gx, gy, ep, valid, pairs, level0)


def extract_lines_pyramid(img: torch.Tensor, max_lines: int,
                          pairs: torch.Tensor, plain: bool = False,
                          **kw) -> LineFeatures:
    """2-level line pyramid: level 1 detects on a 2x box-downsampled image
    (`ops.frontend.line_level`: the `pyramid` kernel's line level on a CUDA
    image unless `plain`);
    its segments map back to level-0 pixel centres and are dropped where a
    valid level-0 segment already covers them."""
    n1 = max_lines // 4
    n0 = max_lines - n1
    img1 = (line_level_plain if plain else line_level)(img)
    f0 = extract_lines(img, n0, pairs, plain, **kw)
    f1 = extract_lines(img1, n1, pairs, plain, level0=f0, **kw)
    return LineFeatures(*(torch.cat([a, b]) for a, b in zip(f0, f1)))


class LineExtractor(nn.Module):
    """Line front end for one grayscale image; holds the LBD band-pair
    pattern as a buffer.  levels=2 is the production 2-level pyramid.
    CUDA images go through the two kernels unless `plain`."""

    def __init__(self, max_lines: int = 256, levels: int = 2,
                 plain: bool = False):
        super().__init__()
        self.max_lines, self.levels, self.plain = max_lines, levels, plain
        self.register_buffer("pairs", torch.from_numpy(_band_pair_pattern()))

    def forward(self, img: torch.Tensor) -> LineFeatures:
        if self.levels >= 2:
            return extract_lines_pyramid(img, self.max_lines, self.pairs,
                                         self.plain)
        return extract_lines(img, self.max_lines, self.pairs, self.plain)


def make_line_extractor(max_lines: int = 256, levels: int = 2,
                        device="cuda") -> LineExtractor:
    """Line extractor module on `device` (any image geometry; the card
    unless the caller asks for the CPU)."""
    return LineExtractor(max_lines, levels).to(cuda.resolve_device(device))
