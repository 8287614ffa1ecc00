#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two tracked frames at EuRoC geometry (480x752, 1000 ORB
features, 256 line features, 2048 map points, 128 map lines) and its
keyframe mapping step at both window sizes of the reference's benchmark
(16 KF x 4096 points x 8192 observations + 512 lines x 1024 observations,
and 2048 / 4096 / 256 / 512) through their user entry points, and fails
(nonzero exit, no result line) unless every phase passes:

1. the card is there (prints `nvidia-smi` name and power limit);
2. the twelve CUDA kernels build from `plvio_tpu_torch/csrc` (nvcc,
   sm_90a, one nvcc per source, all started together);
3. each kernel agrees with its plain PyTorch version on the card at the
   paths' shapes (the mapping kernels also on a perturbed window at the
   same shape in which every gate of the epipolar match and of the
   triangulation decides some rows, and the Schur step's landmarks against
   the plain step and a float64 back-substitution);
4. slice 1, `tracking_step_pl`: 16 synthetic frames with the pose carried,
   >= 80 inliers, camera centre <= 10 mm and rotation <= 0.3 deg from
   ground truth on every frame, every kernel of the path launched; the
   same frames on the plain path, and the largest pose difference;
5. slice 2, `tracking_step_vi`: frames 1..15 with their IMU windows and the
   carry (pose_wb, v, bg, ba, H15), held to a guard from the JAX reference
   run on the CPU (REF_VI below): every frame >= 90% of the reference's
   fewest inliers, body position and rotation within max(2x the
   reference's largest error, 10 mm / 0.3 deg) of ground truth, every
   kernel of the path launched; the same frames on the plain path, each
   frame's pose within 1e-4, inliers within 1% and carried H15 within 1e-3
   relative of it;
6. CUDA-event times per frame of both frames (kernel and plain paths) and
   per kernel beside its plain version, with the card's name and power
   limit;
7. slice 3, `mapping_step`, at both sizes: from the true start the
   triangulated and inlier counts within 1% of the JAX reference run on
   the CPU (REF_MAP below), from the perturbed start
   (`inputs.perturb_window`) the largest camera-centre error within
   max(2x the reference's, 10 mm), the kernel and plain paths' KF poses
   within 1e-4 and their landmarks' reprojection residuals within 0.1 px,
   every kernel of the path launched; CUDA-event times per mapping step on
   both paths, of `schur_solve` beside torch.mm of its Gram fill-in,
   and the sustained figure of bench.py's `bench_sustained` (3 point+line
   frames + 1 typical mapping step, ms per frame).

Each kernel's least time on the card (`bound_ms`) is the larger of its
bytes (inputs read once, outputs written once) over 3.35 TB/s and its
operations over 67 TFLOP/s (the float32 rate outside the tensor cores,
also used for the integer and float64 work), counted from this run's
shapes and data (`work`, beside each kernel's check).

Prints a JSON line of the kernels, then, as its last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one card and no network; JAX is never imported.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from plvio_tpu_torch import cuda
from plvio_tpu_torch.entry import (K_EUROC, LIBA_HALF, LIBA_WORST,
                                   MAPPING_TYPICAL, MAPPING_WORST, imu_init,
                                   inertial_ba_step, mapping_step,
                                   point_projection_match, project_points,
                                   tracking_step_pl, tracking_step_vi)
from plvio_tpu_torch.inputs import (build_imu_windows, build_inputs,
                                    perturb_window)
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import frontend as FE
from plvio_tpu_torch.ops import imu as IMU
from plvio_tpu_torch.ops import lines as LN
from plvio_tpu_torch.ops import matching as M
from plvio_tpu_torch.solver import engine as E
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.state import from_numpy

H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE, N_FRAMES = 480, 752, 1000, 2048, 128, \
    256, 16
KERNELS = {
    "orb_fast_grid": (FE.ORB_FAST_GRID, "plvio_tpu/ops/frontend.py:151"),
    "orb_describe": (FE.ORB_DESCRIBE, "plvio_tpu/ops/frontend.py:300"),
    "hamming_match": (M.HAMMING_MATCH, "plvio_tpu/ops/matching.py:59"),
    "pose_irls": (KN.POSE_IRLS, "plvio_tpu/models/kernels.py:179"),
    "line_detect": (LN.LINE_DETECT, "plvio_tpu/ops/lines.py:63"),
    "line_refine_lbd": (LN.LINE_REFINE_LBD, "plvio_tpu/ops/lines.py:514"),
    "imu_preint": (IMU.IMU_PREINT, "plvio_tpu/ops/imu.py:87"),
    "vi_pose_lm": (KN.VI_POSE_LM, "plvio_tpu/models/kernels.py:932"),
    "rot_hist": (M.ROT_HIST, "plvio_tpu/ops/matching.py:115"),
    "triangulate": (KN.TRIANGULATE, "plvio_tpu/models/kernels.py:878"),
    "ba_linearize": (KN.BA_LINEARIZE, "plvio_tpu/solver/engine.py:355"),
    "schur_solve": (KN.SCHUR_SOLVE, "plvio_tpu/solver/engine.py:452"),
    "inertial_chain": (KN.INERTIAL_CHAIN,
                       "plvio_tpu/models/kernels.py:1279"),
    "inertial_gs_lm": (KN.INERTIAL_GS_LM,
                       "plvio_tpu/models/kernels.py:1137"),
}
PATH_PL = ("orb_fast_grid", "orb_describe", "hamming_match", "pose_irls",
           "line_detect", "line_refine_lbd")
PATH_VI = ("orb_fast_grid", "orb_describe", "hamming_match", "line_detect",
           "line_refine_lbd", "imu_preint", "vi_pose_lm")
PATH_MAP = ("hamming_match", "rot_hist", "triangulate", "ba_linearize",
            "schur_solve")
PATH_LIBA = ("ba_linearize", "inertial_chain", "schur_solve")
PATH_INIT = ("inertial_gs_lm",)
# bench.build_mapping_step's step (with the line inliers) on the CPU in
# float32, at both sizes, from the true start and from
# inputs.perturb_window's start: triangulated pairs, inlier observations,
# the largest camera-centre errors (m) against the true KF poses; printed
# by `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_mapping_step.py`
REF_MAP = {
    "worst": {"n_good": 1024, "n_inliers": 8192, "n_inliers_l": 1024,
              "true_max_centre_m": 0.00398586260877945,
              "perturbed_start_m": 0.04400639133499479,
              "perturbed_max_centre_m": 0.011309127880816847},
    "typical": {"n_good": 1024, "n_inliers": 4096, "n_inliers_l": 512,
                "true_max_centre_m": 0.0038392607427625773,
                "perturbed_start_m": 0.04400644060011908,
                "perturbed_max_centre_m": 0.010204830494980062}}
MAP_POSE_TOL = 1e-4       # kernel against plain path, a KF pose entry
MAP_RES_TOL_PX = 0.1      # ... a reprojection residual: ~2x MAP_POSE_TOL x fx
# make_local_inertial_ba (models/kernels.py:1206) on the CPU in float32 at
# both buckets of `_liba_window` from the true and the perturbed start of
# inputs.build_inertial_window: point and line inliers, the largest
# body-position (m), velocity (m/s) and rotation (deg) errors and the
# largest bias errors against the truth; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_inertial_ba.py`
REF_LIBA = {
    "worst_true": {
        "n_inliers": 8038, "n_inliers_l": 496,
        "max_pos_m": 0.0026293746809380823,
        "max_vel_mps": 0.0034532484439772815,
        "max_rot_deg": 0.029816365572999267,
        "max_bg": 5.568144842982292e-07, "max_ba": 0.0008910135366022587},
    "worst_perturbed": {
        "n_inliers": 8033, "n_inliers_l": 496,
        "max_pos_m": 0.010273185909857693,
        "max_vel_mps": 0.014899040434813316,
        "max_rot_deg": 0.0477130791510268,
        "max_bg": 8.939823601394892e-07, "max_ba": 0.005236792610958219},
    "half_true": {
        "n_inliers": 4009, "n_inliers_l": 506,
        "max_pos_m": 0.0028285130220241307,
        "max_vel_mps": 0.003691819746046111,
        "max_rot_deg": 0.0339620684841832,
        "max_bg": 7.136550266295671e-07, "max_ba": 0.0010594059713184834},
    "half_perturbed": {
        "n_inliers": 4008, "n_inliers_l": 505,
        "max_pos_m": 0.009017411908361882,
        "max_vel_mps": 0.013520111469521458,
        "max_rot_deg": 0.051008917921994426,
        "max_bg": 1.9972212612628937e-06, "max_ba": 0.005584200611338019}}
# make_inertial_init and make_scale_refine (models/kernels.py:1137, 1092)
# on the CPU in float32 on inputs.build_imu_init_inputs: scale, gravity
# direction R_wg (0, 0, -1) and the initialization's gyro bias; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_imu_init.py`
REF_INIT = {"init_scale": 2.0023462772369385,
            "init_gdir": [0.045517437160015106, 0.4215737581253052,
                          -0.9056510329246521],
            "init_bg": [0.0003484622575342655, -0.0003937759029213339,
                        0.001889435457997024],
            "refine_scale": 0.9717907905578613,
            "refine_gdir": [-0.006310852710157633, 0.006210932042449713,
                            -0.9999608397483826]}
GRAVITY = 9.81
HBM_BPS = 3.35e12         # H100 SXM device memory, bytes/s
F32_OPS = 67e12           # H100 SXM float32 outside the tensor cores
# __graft_entry__._tracking_step_vi_fn on the CPU (float32), fed
# build_inputs(16) + build_imu_windows: frames 1..15, fewest inliers, the
# largest body-position and rotation errors against ground truth; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_tracking_step_vi.py`
REF_VI = {"min_inliers": 80, "max_pos_m": 0.00924061761037433,
          "max_rot_deg": 0.13442194971241928}
SEG_TOL_PX = 0.01          # a segment's partner within 0.01 px (endpoints)
SEG_MISS = 0.02            # share of a side's segments allowed no partner
#                            (at least one): sums in another order can move
#                            a segment across a threshold or reorder two
#                            nearly equal lengths
BITS_SHARE = 0.995         # LBD / BRIEF bit agreement


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)
    print(f"  ok: {msg}")


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device milliseconds of fn() over `reps` calls (CUDA events,
    warm-up excluded)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*objs):
    """Bytes of the tensors in objs (tuples and named tuples walked)."""
    n = 0
    for o in objs:
        if torch.is_tensor(o):
            n += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            n += nbytes(*o)
    return n


def work(nb, ops):
    """The bound of a kernel call from its bytes and operations."""
    t_b, t_o = nb / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return dict(bytes=int(nb), ops=int(ops), bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def pose_err(P, G):
    """(camera-centre distance, rotation angle deg) between two T_cw."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    c = -P[:, :3].T @ P[:, 3]
    cg = -G[:, :3].T @ G[:, 3]
    return float(np.linalg.norm(c - cg)), rot_deg(P[:, :3], G[:, :3])


def rot_deg(A, B):
    dR = np.asarray(A, np.float64) @ np.asarray(B, np.float64).T
    return math.degrees(math.acos(max(-1.0, min(1.0,
                                                (np.trace(dR) - 1) / 2))))


def rot_diff_rad(A, B):
    """Angle of A^T B from its skew part (acos of the trace cannot resolve
    angles below ~1e-4 rad in float64 of float32 rotations)."""
    dR = A[:, :3].double().cpu().T @ B[:, :3].double().cpu()
    w = torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]]) / 2
    return math.asin(min(1.0, float(w.norm())))


def h15_gap(a, b):
    """Relative Frobenius gap of two carried priors: 0 where both are
    non-finite (the reference's NaN prior), inf where only one is."""
    fa, fb = bool(torch.isfinite(a).all()), bool(torch.isfinite(b).all())
    if not (fa or fb):
        return 0.0
    if not (fa and fb):
        return math.inf
    return float((a - b).norm() / b.norm())


def seg_share(ea, va, eb, vb, tol=SEG_TOL_PX):
    """(matched, total): valid segments of a with a valid segment of b
    whose endpoints are both within tol (either orientation)."""
    ea, eb = ea.double().cpu().numpy(), eb.double().cpu().numpy()
    va, vb = va.cpu().numpy(), vb.cpu().numpy()
    n = 0
    for i in np.nonzero(va)[0]:
        same = np.maximum(np.linalg.norm(eb[:, :2] - ea[i, :2], axis=1),
                          np.linalg.norm(eb[:, 2:] - ea[i, 2:], axis=1))
        flip = np.maximum(np.linalg.norm(eb[:, :2] - ea[i, 2:], axis=1),
                          np.linalg.norm(eb[:, 2:] - ea[i, :2], axis=1))
        d = np.where(vb, np.minimum(same, flip), np.inf)
        n += int(d.min() <= tol)
    return n, int(va.sum())


def check_segments(name, ek, vk, ep, vp):
    a, na = seg_share(ek, vk, ep, vp)
    b, nb = seg_share(ep, vp, ek, vk)
    ok = all(n - m <= max(1, int(SEG_MISS * n)) for m, n in ((a, na),
                                                             (b, nb)))
    check(ok, f"{name}: {a}/{na} kernel and {b}/{nb} plain segments have a "
          f"partner within {SEG_TOL_PX} px (at most max(1, {SEG_MISS:.0%}) "
          "without)")


def bit_agreement(dk, dp):
    if dk.shape[0] == 0:
        return 1.0
    return float((M.unpack_u32_to_pm1(dk) == M.unpack_u32_to_pm1(dp))
                 .float().mean())


def check_pl_kernels(imgs, poses, st, step, report):
    """The four kernels of slice 1 against their plain versions."""
    dev = imgs[0].device
    orb = step.orb
    # -- orb_fast_grid: every level of frame 1
    pyr = FE.build_pyramid(imgs[1], orb.specs)
    same, total, err, out_b = [], [], 0.0, 0
    for im in pyr:
        bk, ak = FE.orb_fast_grid(im, 20.0, 7.0)
        bp, ap = FE.orb_fast_grid_plain(im, 20.0, 7.0)
        out_b += nbytes(bk, ak)
        eq = (ak == ap) & (bk == bp)
        same.append(int(eq.sum()))
        total.append(eq.numel())
        err = max(err, float((bk - bp).abs().max()))
    check(same[0] == total[0],
          f"orb_fast_grid level 0 winners identical ({same[0]}/{total[0]})")
    frac = sum(same[1:]) / sum(total[1:])
    check(frac >= 0.995, f"orb_fast_grid levels 1-7 winners {frac:.4%} "
          "identical (>= 99.5%)")
    # FAST at two thresholds on the 16-pixel ring, 3x3 NMS, cell argmax:
    # ~60 operations a pixel
    report["orb_fast_grid"] = dict(
        **work(nbytes(*pyr) + out_b, 60 * sum(im.numel() for im in pyr)),
        max_abs_err=err,
        ms=cuda_ms(lambda: [FE.orb_fast_grid(im, 20.0, 7.0) for im in pyr]),
        plain_ms=cuda_ms(lambda: [FE.orb_fast_grid_plain(im, 20.0, 7.0)
                                  for im in pyr]))

    # -- orb_describe: the keypoints of frame 1, all levels in one call
    xys, octs = [], []
    for lv, spec in enumerate(orb.specs):
        best, arg = FE.orb_fast_grid(pyr[lv], 20.0, 7.0)
        xy, _, _ = FE.select_top_cells(best, arg, spec.width // 16,
                                       spec.n_keep)
        xys.append(xy)
        octs.append(torch.full((xy.shape[0],), lv, dtype=torch.int32,
                               device=dev))
    xy, oc = torch.cat(xys), torch.cat(octs)
    dargs = (pyr, xy, oc, orb.taps, orb.pattern, orb.wx, orb.wy)
    ang_k, desc_k = FE.orb_describe(*dargs)
    ang_p, desc_p = FE.orb_describe_plain(*dargs)
    agree = bit_agreement(desc_k, desc_p)
    dang = (ang_k - ang_p).abs()
    dang = float(torch.minimum(dang, 360.0 - dang).max())
    check(agree >= BITS_SHARE,
          f"orb_describe bits {agree:.4%} agree (>= 99.5%)")
    check(dang <= 0.01, f"orb_describe angles within {dang:.2e} deg "
          "(<= 0.01)")
    # per keypoint: its 39x39 patch read once, a 7x7 blur of it, the
    # intensity centroid on the r=15 disc and 256 steered comparisons
    n_kp = xy.shape[0]
    report["orb_describe"] = dict(
        **work(min(n_kp * 39 * 39 * 4, nbytes(*pyr)) + nbytes(xy, oc)
               + nbytes(ang_k, desc_k),
               n_kp * (39 * 39 * 49 * 2 + 31 * 31 * 4 + 256 * 4)),
        max_abs_err=dang, ms=cuda_ms(lambda: FE.orb_describe(*dargs)),
        plain_ms=cuda_ms(lambda: FE.orb_describe_plain(*dargs)))

    # -- hamming_match: the point and line matches of frame 1 at its
    #    carried pose, and a tie-heavy random case
    with torch.no_grad():
        feats = orb(imgs[1])
        lf = step.lines(imgs[1])
    pose0 = torch.from_numpy(poses[0]).to(dev)
    uvp, row_ok = project_points(K_EUROC, pose0, st["pt_xyz"], st["pt_valid"],
                                 H, W)
    pt_case = (st["pt_desc"], feats.desc, row_ok, feats.valid, uvp, feats.uv)
    pt_kw = dict(radius=20.0, max_dist=80.0, ratio=0.9)
    g = torch.Generator(device="cpu").manual_seed(0)
    rnd_case = (
        (torch.randint(0, 4, (CAP_PTS, 8), generator=g) << 30).to(
            torch.int32).to(dev),
        (torch.randint(0, 4, (N_FEAT, 8), generator=g) << 30).to(
            torch.int32).to(dev),
        (torch.rand(CAP_PTS, generator=g) < 0.9).to(dev),
        (torch.rand(N_FEAT, generator=g) < 0.9).to(dev),
        (torch.rand(CAP_PTS, 2, generator=g) * 100).to(dev),
        (torch.rand(N_FEAT, 2, generator=g) * 100).to(dev))
    lcase = KN.line_proj_match_core
    li_k, lm_k, _ = lcase(K_EUROC, pose0, st["ln_ep6"], st["ln_desc"],
                          st["ln_valid"], lf.ep, lf.desc, lf.angle, lf.valid,
                          lf.lineq)
    li_p, lm_p, _ = lcase(K_EUROC, pose0, st["ln_ep6"], st["ln_desc"],
                          st["ln_valid"], lf.ep, lf.desc, lf.angle, lf.valid,
                          lf.lineq, plain=True)
    errs = [float((li_k != li_p).sum() + (lm_k != lm_p).sum())]
    check(errs[0] == 0, "hamming_match line mode: idx and ok identical "
          f"({int(lm_k.sum())} matched)")
    for name, case in (("points", pt_case), ("random ties", rnd_case)):
        ik, ok_k = M.hamming_match(*case, **pt_kw)
        ip, ok_p = M.hamming_match_plain(*case, **pt_kw)
        errs.append(float((ik != ip).sum() + (ok_k != ok_p).sum()))
        check(errs[-1] == 0, f"hamming_match {name}: idx and ok identical "
              f"({int(ok_k.sum())} matched)")
    # the window gate on every pair (~6 operations), then XOR + popc of 8
    # words on the pairs it admits (~17)
    gated = int((M.window_gate(uvp, feats.uv, 20.0) & row_ok[:, None]
                 & feats.valid[None, :]).sum())
    n_r, n_c = uvp.shape[0], feats.uv.shape[0]
    report["hamming_match"] = dict(
        **work(nbytes(*pt_case) + n_r * 5, 6 * n_r * n_c + 17 * gated),
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: M.hamming_match(*pt_case, **pt_kw)),
        plain_ms=cuda_ms(lambda: M.hamming_match_plain(*pt_case, **pt_kw)))

    # -- pose_irls: frame 1's matches at its carried pose
    uv_m, ok, is2 = point_projection_match(K_EUROC, feats, pose0,
                                           st["pt_xyz"], st["pt_desc"],
                                           st["pt_valid"], H, W)
    pargs = (K_EUROC, pose0, uv_m, st["pt_xyz"], ok, is2,
             lf.lineq[li_k.long()].contiguous(),
             st["ln_ep6"][:, :3].contiguous(),
             st["ln_ep6"][:, 3:].contiguous(), lm_k,
             torch.ones(CAP_LNS, device=dev))
    Pk, ipk, ilk, _ = KN.pose_irls(*pargs)
    Pp, ipp, ilp, _ = KN.pose_irls_plain(*pargs)
    drot = rot_diff_rad(Pk, Pp)
    dt = float((Pk[:, 3] - Pp[:, 3]).abs().max())
    check(drot <= 1e-5 and dt <= 1e-5, f"pose_irls rotation {drot:.2e} rad, "
          f"translation {dt:.2e} m from the plain Cholesky version "
          "(<= 1e-5)")
    r = KN.project(K_EUROC, st["pt_xyz"] @ Pp[:, :3].T + Pp[:, 3]) - uv_m
    chi2 = (r * r).sum(-1) * is2
    diff = ipk != ipp
    near = (chi2 - KN.CHI2_MONO).abs() <= 0.01 * KN.CHI2_MONO
    check(bool((~diff | near).all()) and bool((ilk == ilp).all()),
          f"pose_irls inlier masks equal but for {int(diff.sum())} rows "
          "within 1% of the gate")
    # 4 rounds x 3 Gauss-Newton steps over every point (~150 operations)
    # and both endpoints of every line (~300)
    report["pose_irls"] = dict(
        **work(nbytes(*pargs[1:]) + nbytes(Pk, ipk, ilk) + 4,
               12 * (150 * CAP_PTS + 300 * CAP_LNS)),
        max_abs_err=float((Pk - Pp).abs().max()),
        ms=cuda_ms(lambda: KN.pose_irls(*pargs)),
        plain_ms=cuda_ms(lambda: KN.pose_irls_plain(*pargs)))


def check_line_kernels(img, report):
    """line_detect and line_refine_lbd on frame 1, both pyramid levels."""
    pairs = torch.from_numpy(LN._band_pair_pattern()).to(img.device)
    img1 = img.reshape(H // 2, 2, W // 2, 2).mean((1, 3)).contiguous()
    levels = ((img, N_LINE - N_LINE // 4), (img1, N_LINE // 4))
    err, det_err = 0.0, 0.0
    dets, det_out, ref_in, ref_out, n_seg = [], 0, 0, 0, 0
    for lv, (im, n) in enumerate(levels):
        dk = LN.line_detect(im, n)
        dp = LN.detect_lines(im, n)
        det_out += nbytes(dk)
        differ = int((dk[4][0] != dp[4][0]).sum()
                     + (dk[4][1] != dp[4][1]).sum())
        check(differ == 0, f"line_detect level {lv}: bf16 Scharr gradients "
              f"identical ({differ} of {2 * im.numel()} differ)")
        check_segments(f"line_detect level {lv}", dk[0], dk[3], dp[0], dp[3])
        rows = dk[3] & dp[3]
        if bool(rows.any()):
            det_err = max(det_err, float((dk[0] - dp[0])[rows].abs().max()))
        dets.append(dp)
        # the refit on the same (plain) detections
        f0 = None
        if lv == 1:
            f0 = LN.refine_lbd_plain(dets[0][4][0], dets[0][4][1],
                                     dets[0][0], dets[0][3], pairs)
        fk = LN.line_refine_lbd(dp[4][0], dp[4][1], dp[0], dp[3], pairs, f0)
        fp = LN.refine_lbd_plain(dp[4][0], dp[4][1], dp[0], dp[3], pairs, f0)
        ref_in += nbytes(dp[4], dp[0], dp[3])
        ref_out += nbytes(fk)
        n_seg += int(dp[3].sum())
        check_segments(f"line_refine_lbd level {lv}", fk.ep, fk.valid,
                       fp.ep, fp.valid)
        # descriptors of the segments that agree (same row: the refit keeps
        # the detections' order)
        both = fk.valid & fp.valid \
            & ((fk.ep - fp.ep).abs().amax(1) <= SEG_TOL_PX)
        bits = bit_agreement(fk.desc[both], fp.desc[both])
        check(bits >= BITS_SHARE, f"line_refine_lbd level {lv}: LBD bits "
              f"{bits:.4%} agree on the {int(both.sum())} segments within "
              f"{SEG_TOL_PX} px (>= 99.5%)")
        if bool(both.any()):
            err = max(err, float((fk.ep - fp.ep)[both].abs().max()))
    lk1, lk2 = LN.LineExtractor(N_LINE).to(img.device)(img), \
        LN.LineExtractor(N_LINE).to(img.device)(img)
    check(all(torch.equal(x, y) for x, y in zip(lk1, lk2)),
          "line kernels: two runs of the pyramid give identical outputs")
    # bf16 Scharr (2 x 9 products), the cell structure tensors, links and
    # components: ~60 operations a pixel
    report["line_detect"] = dict(
        **work(nbytes(img, img1) + det_out, 60 * (img.numel() + img1.numel())),
        max_abs_err=det_err,
        ms=cuda_ms(lambda: [LN.line_detect(im, n) for im, n in levels]),
        plain_ms=cuda_ms(lambda: [LN.detect_lines(im, n)
                                  for im, n in levels], reps=5))
    dp0, dp1 = dets
    f0 = LN.refine_lbd_plain(dp0[4][0], dp0[4][1], dp0[0], dp0[3], pairs)

    def refine(fn):
        fn(dp0[4][0], dp0[4][1], dp0[0], dp0[3], pairs)
        fn(dp1[4][0], dp1[4][1], dp1[0], dp1[3], pairs, f0)
    # per segment: the refit's gradient snaps and the banded LBD, ~15k
    # operations
    report["line_refine_lbd"] = dict(
        **work(ref_in + ref_out, 15000 * n_seg),
        max_abs_err=err, ms=cuda_ms(lambda: refine(LN.line_refine_lbd)),
        plain_ms=cuda_ms(lambda: refine(LN.refine_lbd_plain), reps=5))


def vi_frame1_case(step, img, carry, xs, st):
    """The inputs of the VI optimizer on frame 1, as the step forms them."""
    pose_wb, vel, bg, ba, H15 = carry
    _, gyro, acc, dts = xs
    imu = IMU.imu_preint_plain(gyro, acc, dts, step.imu_mask, step.calib,
                               bg, ba, pose_wb, vel)
    pre = imu.pre
    pose_cw = torch.cat([imu.R2.T, (-imu.R2.T @ imu.p2)[:, None]], 1)
    with torch.no_grad():
        feats = step.orb(img)
    uv_m, ok, is2 = point_projection_match(
        K_EUROC, feats, pose_cw.contiguous(), st["pt_xyz"], st["pt_desc"],
        st["pt_valid"], H, W)
    pre_const = {"dT": pre.dT, "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
                 "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
                 "JPg": pre.JPg, "JPa": pre.JPa, "bg0": pre.bias_gyro,
                 "ba0": pre.bias_acc}
    prior_const = {"R0": pose_wb[:, :3], "p0": pose_wb[:, 3], "v0": vel,
                   "bg0": bg, "ba0": ba}
    eye = torch.eye(3, device=img.device)
    z3 = torch.zeros(3, device=img.device)
    return (K_EUROC, eye, z3, step.calib.gravity,
            torch.cat([imu.R2, imu.p2[:, None]], 1), imu.v2, bg, ba,
            uv_m.contiguous(), st["pt_xyz"], ok, is2, pose_wb, vel,
            pre_const, imu.imu_info, step.rw_info, prior_const, H15)


def check_vi_kernels(step, img, carry, xs, st, report):
    """imu_preint on window 1, vi_pose_lm on frame 1 both ways."""
    pose_wb, vel, bg, ba, _ = carry
    _, gyro, acc, dts = xs
    args = (gyro, acc, dts, step.imu_mask, step.calib, bg, ba, pose_wb, vel)
    fk = IMU.imu_preint(*args)
    fp = IMU.imu_preint_plain(*args)
    errs = {}
    for f in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"):
        a, b = getattr(fk.pre, f).double(), getattr(fp.pre, f).double()
        errs[f] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    for f in ("R2", "v2", "p2"):
        a, b = getattr(fk, f).double(), getattr(fp, f).double()
        errs[f] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-5, f"imu_preint deltas, Jacobians, covariance "
          f"and prediction within 1e-5 relative (worst {worst} "
          f"{errs[worst]:.2e})")
    fro = float((fk.imu_info - fp.imu_info).norm() / fp.imu_info.norm())
    check(fro <= 1e-4, f"imu_preint imu_info within {fro:.2e} relative "
          "Frobenius of the LU inverse (<= 1e-4)")
    # per sample the 15x15 covariance propagation A C A^T (~13.5k
    # operations), then the 9x9 inverse
    report["imu_preint"] = dict(
        **work(nbytes(gyro, acc, dts) + nbytes(fk), 13500 * gyro.shape[0]
               + 2000),
        max_abs_err=errs[worst], ms=cuda_ms(lambda: IMU.imu_preint(*args)),
        plain_ms=cuda_ms(lambda: IMU.imu_preint_plain(*args)))

    case = vi_frame1_case(step, img, carry, xs, st)
    worst_err = 0.0
    lm_iters = []
    for hp in (True, False):
        ok_ = KN.vi_pose_lm(*case, hp)
        op_ = KN.vi_pose_opt_plain(*case, hp,
                                   stats=lm_iters if hp else None)
        drot = rot_diff_rad(ok_[0], op_[0])
        dt = float((ok_[0][:, 3] - op_[0][:, 3]).abs().max())
        nk, np_ = int(ok_[5]), int(op_[5])
        hrel = float((ok_[6] - op_[6]).norm() / op_[6].norm())
        print(f"  vi_pose_lm have_prior={hp}: rotation {drot:.2e} rad, "
              f"position {dt:.2e} m, velocity "
              f"{float((ok_[1] - op_[1]).abs().max()):.2e}, biases "
              f"{float((ok_[2] - op_[2]).abs().max()):.2e} / "
              f"{float((ok_[3] - op_[3]).abs().max()):.2e}, inliers {nk} vs "
              f"{np_}, H15 {hrel:.2e} relative Frobenius")
        check(drot <= 1e-4 and dt <= 1e-4, f"vi_pose_lm have_prior={hp}: "
              "pose within 1e-4 rad / 1e-4 m of the plain version")
        check(abs(nk - np_) <= 0.01 * max(np_, 1),
              f"vi_pose_lm have_prior={hp}: inliers within 1%")
        check(hrel <= 1e-3, f"vi_pose_lm have_prior={hp}: H15 within 1e-3 "
              "relative Frobenius")
        worst_err = max(worst_err, float((ok_[0] - op_[0]).abs().max()))
    # per LM iteration (the plain version's count on the same data): the
    # linearization and the cost of every edge (~250 operations each),
    # then the 30x30 factorization
    cap = case[9].shape[0]
    report["vi_pose_lm"] = dict(
        **work(nbytes(*case[8:12]) + 448 * 4 + 246 * 4 + cap + 4,
               sum(lm_iters) * (250 * cap + 2 * 30 ** 3)),
        max_abs_err=worst_err, ms=cuda_ms(lambda: KN.vi_pose_lm(*case, True)),
        plain_ms=cuda_ms(lambda: KN.vi_pose_opt_plain(*case, True), reps=3,
                         warmup=1))


def perturbed_window(A):
    """A copy of a mapping window with inputs.perturb_window's start."""
    B = dict(A)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    B["kf_poses"] = torch.from_numpy(P).to(A["kf_poses"].device)
    B["pt_xyz"] = torch.from_numpy(X).to(A["pt_xyz"].device)
    return B


def centre_err(P, G):
    """Largest camera-centre distance (m) between two KF pose stacks."""
    P, G = P.double().cpu(), G.double().cpu()
    c = -torch.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -torch.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float((c - cg).norm(dim=1).max())


def unpack_sym(packed, d):
    """[..., d(d+1)/2] upper triangles (row by row) -> [..., d, d]."""
    iu = torch.triu_indices(d, d)
    out = torch.zeros(*packed.shape[:-1], d, d, dtype=packed.dtype,
                      device=packed.device)
    out[..., iu[0], iu[1]] = packed
    out[..., iu[1], iu[0]] = packed
    return out


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def changed(ref, idx, ok):
    """Rows whose match differs from (ref_idx, ref_ok)."""
    ri, rok = ref
    return int(((ok != rok) | (ok & rok & (idx != ri))).sum())


def epipolar_gate_case(A, dev):
    """The path's window at n_feat, reshaped so that every gate of the
    epipolar match decides some rows: 1 px noise on uv_a and mixed
    octaves (the epipolar gate), a few flipped bits everywhere, 72 flipped
    bits on 32 rows (max_dist 60), 32 columns duplicated next to their
    twin (the ratio test) and 32 rows duplicated next to their twin (the
    mutual check).  Returns the kernel's arguments and keywords."""
    g = torch.Generator().manual_seed(12)
    n = A["desc"].shape[0]
    d1 = A["desc"].cpu().clone()
    d2 = d1 ^ (torch.randint(0, 2, (n, 8), generator=g) << 7).to(torch.int32)
    uv1 = A["uv_a"].cpu() + torch.randn(n, 2, generator=g)
    uv2 = A["uv_b"].cpu().clone()
    d2[400:432] = d1[400:432] ^ 0x1FF
    d2[756:788], uv2[756:788] = d2[500:532], uv2[500:532] + 0.25
    d1[900:932], uv1[900:932] = d1[600:632], uv1[600:632] + 0.25
    th = 2.0 * torch.pow(1.2, torch.randint(0, 4, (n,), generator=g).float())
    F = KN.fundamental(K_EUROC, A["pose_a"], A["pose_b"])
    args = (d1.to(dev), d2.to(dev), A["ok"], A["ok"],
            uv1.contiguous().to(dev), uv2.to(dev))
    return args, dict(radius=0.0, max_dist=60.0, ratio=0.8, epi_F=F,
                      epi_th=th.to(dev))


def epipolar_gate_effects(args, kw, ref):
    """Rows whose match changes when one gate of the plain version is left
    out: each must be > 0 for the kernel's equality to test that gate."""
    d1, d2, ok1, ok2, uv1, uv2 = args
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(d1), M.unpack_u32_to_pm1(d2))
    gate = M.epipolar_gate(kw["epi_F"], uv1, uv2, kw["epi_th"])
    nn = M.match_nn_ratio
    return {
        "epipolar": changed(ref, *nn(dist, ok1, ok2, None, 60.0, 0.8)),
        "ratio": changed(ref, *nn(dist, ok1, ok2, gate, 60.0, 1e30)),
        "mutual": changed(ref, *nn(dist, ok1, ok2, gate, 60.0, 0.8,
                                   mutual=False)),
        "max_dist": changed(ref, *nn(dist, ok1, ok2, gate, 1e30, 0.8))}


def triangulate_gate_case(A, dev):
    """Pairs of the path's window at n_feat (float64 construction): 0.7 px
    noise on uv_b, 3 px on 32 rows (the reprojection gate), the first 10
    rows swapped, 32 rows at 1 cm from one camera (the depth gate), 32
    rows at 300 baselines (the parallax gate) and 10% invalid.  Returns
    the kernel's arguments."""
    g = torch.Generator().manual_seed(11)
    P1, P2 = A["pose_a"].double().cpu(), A["pose_b"].double().cpu()
    R21 = P2[:, :3] @ P1[:, :3].T
    t21 = P2[:, 3] - R21 @ P1[:, 3]
    uv1 = A["uv_a"].double().cpu()
    n = uv1.shape[0]
    uv2 = A["uv_b"].double().cpu() + 0.7 * torch.randn(n, 2, generator=g,
                                                        dtype=torch.float64)
    uv2[:10] = uv2[:10].flip(0)
    uv2[300:332] += 3.0 * torch.randn(32, 2, generator=g,
                                      dtype=torch.float64)
    ray = torch.stack([(uv1[:, 0] - K_EUROC.cx) / K_EUROC.fx,
                       (uv1[:, 1] - K_EUROC.cy) / K_EUROC.fy,
                       torch.ones(n, dtype=torch.float64)], -1)
    a = (ray @ R21.T)[:, 2]
    base = float((R21.T @ t21).norm())
    # depth 1 cm in view 1, or 1 cm in view 2 where view 1's would put
    # the point behind view 2
    s_near = torch.maximum(torch.full_like(a, 0.01), (0.01 - t21[2]) / a)
    for rows, s in ((slice(100, 132), s_near[100:132]),
                    (slice(200, 232), torch.full((32,), 300.0 * base,
                                                 dtype=torch.float64))):
        X2 = (s[:, None] * ray[rows]) @ R21.T + t21
        uv2[rows] = torch.stack([K_EUROC.fx * X2[:, 0] / X2[:, 2] + K_EUROC.cx,
                                 K_EUROC.fy * X2[:, 1] / X2[:, 2]
                                 + K_EUROC.cy], -1)
    valid = torch.rand(n, generator=g) < 0.9
    th = torch.full((n,), 5.991, device=dev)
    return (K_EUROC, A["pose_a"], A["pose_b"], A["uv_a"],
            uv2.float().to(dev), valid.to(dev), th, th)


def triangulate_gate_effects(targs, Xw):
    """Valid rows that fail exactly one gate of the plain version (depth,
    parallax, reprojection), recomputed from its world points: a kernel
    that skipped that gate would call them good."""
    K, P1, P2, uv1, uv2, valid, th1, th2 = [
        x.double().cpu() if torch.is_tensor(x) and x.is_floating_point()
        else x.cpu() if torch.is_tensor(x) else x for x in targs]
    Xw = Xw.double().cpu()
    X1 = Xw @ P1[:, :3].T + P1[:, 3]
    X2 = Xw @ P2[:, :3].T + P2[:, 3]
    C1, C2 = -P1[:, :3].T @ P1[:, 3], -P2[:, :3].T @ P2[:, 3]
    r1, r2 = Xw - C1, Xw - C2
    cosp = (r1 * r2).sum(-1) / (r1.norm(dim=-1) * r2.norm(dim=-1))

    def err(X, uv):
        z = X[:, 2].clamp_min(1e-9)
        e = torch.stack([K.fx * X[:, 0] / z + K.cx,
                         K.fy * X[:, 1] / z + K.cy], -1) - uv
        return (e * e).sum(-1)
    fail = {"depth": (X1[:, 2] <= 0.02) | (X2[:, 2] <= 0.02),
            "parallax": cosp >= 0.99995,
            "reprojection": (err(X1, uv1) >= th1) | (err(X2, uv2) >= th2)}
    out = {}
    for k, f in fail.items():
        others = torch.zeros_like(f)
        for k2, f2 in fail.items():
            if k2 != k:
                others |= f2
        out[k] = int((valid & f & ~others).sum())
    return out


def well_gap(cand, ref, Hpp):
    """Per landmark, |cand - ref| along the eigen-directions of Hpp whose
    eigenvalue is >= 1e-3 of the block's largest, relative to |ref|: the
    directions the observations determine (a line endpoint's slide along
    its line and a low-parallax point's depth are left out, where the
    damping floor decides).  Returns (gap [P], directions kept [P])."""
    ev, V = torch.linalg.eigh(Hpp.double())
    occ = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1) > 1e-9
    keep = (ev >= 1e-3 * ev[:, -1:].clamp_min(1e-30)) & occ[:, None]
    d = torch.einsum("pdk,pd->pk", V, cand.double() - ref.double()) * keep
    return d.norm(dim=1) / ref.double().norm(dim=1), keep.sum(1)


def backsub_reference(hp, W, lm_idx, kf_idx, free, dx, X, lam,
                      dt=torch.float64):
    """The landmark back-substitution of the engine's Schur step
    (damping floor, occupied gate, chol_invT_blocks, blk_ok, the explicit
    Dinv = F F^T) in dtype dt from the kernel's own system: hp [P, D(D+1)/2
    + D] packed Hpp and gp, W [O, 6 D] per-observation couplings, the
    kernel's pose step dx.  Returns (candidate landmarks, occupied,
    condition number of each damped block)."""
    D = X.shape[1]
    NU = D * (D + 1) // 2
    lf = free.to(dt)
    Hpp = unpack_sym(hp[:, :NU], D).to(dt) * lf[:, None, None]
    g = hp[:, NU:].to(dt) * lf[:, None]
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hd = Hpp + torch.diag_embed(dpp * lam + 1e-4 * dpp.mean(-1, keepdim=True)
                                + 1e-6)
    occ = (dpp.sum(-1) > 1e-9) & free
    Hd = torch.where(occ[:, None, None], Hd,
                     torch.eye(D, dtype=Hd.dtype, device=Hd.device))
    Fc = E.chol_invT_blocks(Hd)
    occ = occ & torch.isfinite(Fc).all(-1).all(-1) \
        & (Fc.abs().amax((-2, -1)) < 1e3)
    Wo = W.to(dt).view(-1, 6, D) * lf[lm_idx, None, None]
    d = dx.to(dt).view(-1, 6)[kf_idx]
    rhs = g.index_add(0, lm_idx, -torch.einsum("oij,oi->oj", Wo, d))
    Dinv = torch.einsum("pij,pkj->pik", Fc, Fc)
    dxp = torch.einsum("pij,pj->pi", Dinv, rhs) * occ[:, None]
    return X.to(dt) + dxp, occ, torch.linalg.cond(Hd.double())


def window_residuals(poses, pts, lns, A):
    """Reprojection residuals (px) of every point and line observation of
    a mapping window: the landmarks as the observing keyframes see them,
    so null directions (depth of a point seen once, an endpoint sliding
    along its line) do not count."""
    rp = RES.point_reproj_jac(K_EUROC, poses[A["obs_kf"].long()],
                              pts[A["obs_pt"].long()], A["obs_uv"])[0]
    rl = RES.line_reproj_jac(K_EUROC, poses[A["lobs_kf"].long()],
                             lns[A["lobs_ln"].long()], A["lobs_eq"])[0]
    return rp, rl


def check_map_kernels(report):
    """The four kernels of slice 3 (and hamming_match's epipolar mode) on
    the worst-case mapping window."""
    dev = torch.device("cuda")
    sz = MAPPING_WORST
    _, A = mapping_step(**sz, device=dev)
    n = sz["n_feat"]
    # -- hamming_match, epipolar mode: the step's match
    F = KN.fundamental(K_EUROC, A["pose_a"], A["pose_b"])
    th = torch.full((n,), 2.0, device=dev)
    ecase = (A["desc"], A["desc"], A["ok"], A["ok"], A["uv_a"], A["uv_b"])
    ekw = dict(radius=0.0, max_dist=60.0, ratio=0.8, epi_F=F, epi_th=th)
    ik, okk = M.hamming_match(*ecase, **ekw)
    ip, okp = M.hamming_match_plain(*ecase, **ekw)
    check(torch.equal(ik, ip) and torch.equal(okk, okp),
          f"hamming_match epipolar mode: idx and ok identical "
          f"({int(okk.sum())} of {n} matched)")
    ecase2, ekw2 = epipolar_gate_case(A, dev)
    ik2, okk2 = M.hamming_match(*ecase2, **ekw2)
    ip2, okp2 = M.hamming_match_plain(*ecase2, **ekw2)
    eff = epipolar_gate_effects(ecase2, ekw2, (ip2, okp2))
    check(torch.equal(ik2, ip2) and torch.equal(okk2, okp2),
          f"hamming_match epipolar mode, perturbed case: idx and ok "
          f"identical ({int(okk2.sum())} of {n} matched)")
    check(min(eff.values()) > 0, "hamming_match epipolar mode, perturbed "
          f"case: every gate decides some rows (rows that change without "
          f"it: {eff})")
    report["hamming_match"]["epipolar_ms"] = cuda_ms(
        lambda: M.hamming_match(*ecase, **ekw))
    report["hamming_match"]["epipolar_plain_ms"] = cuda_ms(
        lambda: M.hamming_match_plain(*ecase, **ekw))
    # -- rot_hist: the step's case (radians) and a tie-heavy one
    g = torch.Generator().manual_seed(1)
    rot = torch.cat([torch.tensor([18.0, 78.0, 138.0, 270.0])
                     .repeat_interleave(200), torch.rand(n - 800, generator=g)
                     * 360])
    a2 = torch.rand(n, generator=g) * 360
    hcases = [(A["ang"], A["ang"], ik, okk),
              (((a2 + rot) % 360).to(dev), a2.to(dev),
               torch.arange(n, dtype=torch.int32, device=dev),
               (torch.rand(n, generator=g) < 0.95).to(dev))]
    for i, hc in enumerate(hcases):
        hk, hp = M.rot_hist(*hc), M.rotation_histogram_filter(*hc)
        check(torch.equal(hk, hp), f"rot_hist case {i}: masks identical "
              f"({int(hk.sum())} of {int(hc[3].sum())} kept)")
    report["rot_hist"] = dict(
        **work(n * (4 + 4 + 4 + 1) + n, 8 * n), max_abs_err=0.0,
        ms=cuda_ms(lambda: M.rot_hist(*hcases[0])),
        plain_ms=cuda_ms(lambda: M.rotation_histogram_filter(*hcases[0])))
    # -- triangulate: the step's matched pairs
    targs = (K_EUROC, A["pose_a"], A["pose_b"], A["uv_a"],
             A["uv_b"][ik.long()].contiguous(), okk,
             torch.full((n,), 5.991, device=dev),
             torch.full((n,), 5.991, device=dev))
    Xk, gk = KN.triangulate(*targs)
    Xp, gp = KN.triangulate_plain(*targs)
    trel = float(((Xk - Xp).norm(dim=1) / Xp.norm(dim=1))[gk & gp].max())
    check(torch.equal(gk, gp) and trel <= 1e-4,
          f"triangulate: good masks identical ({int(gk.sum())} good), "
          f"points within {trel:.2e} relative (<= 1e-4)")
    targs2 = triangulate_gate_case(A, dev)
    Xk2, gk2 = KN.triangulate(*targs2)
    Xp2, gp2 = KN.triangulate_plain(*targs2)
    trel2 = float(((Xk2 - Xp2).norm(dim=1) / Xp2.norm(dim=1))[gk2 & gp2]
                  .max())
    eff = triangulate_gate_effects(targs2, Xp2)
    eff["invalid"] = int((~targs2[5]).sum())
    check(torch.equal(gk2, gp2) and trel2 <= 1e-4,
          f"triangulate, perturbed case: good masks identical "
          f"({int(gk2.sum())} of {n} good), points within {trel2:.2e} "
          "relative (<= 1e-4)")
    check(min(eff.values()) > 0, "triangulate, perturbed case: every gate "
          f"alone rejects some rows ({eff})")
    # per pair: A^T A, ~6 Jacobi sweeps of 6 rotations on 4x4, the gates
    report["triangulate"] = dict(
        **work(nbytes(*targs[1:]) + nbytes(Xk, gk), 3000 * n),
        max_abs_err=float((Xk - Xp)[gk].abs().max()),
        ms=cuda_ms(lambda: KN.triangulate(*targs)),
        plain_ms=cuda_ms(lambda: KN.triangulate_plain(*targs)))
    # -- ba_linearize and schur_solve: one LM step of the perturbed window
    B = perturbed_window(A)
    keys = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
            "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free",
            "lobs_kf", "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")
    S = 6 * sz["n_kf"]
    w = KN._BAWork(K_EUROC, *[B[k] for k in keys], lam0=1e-4,
                   early_tol=1e-2, cg_iters=min(max(S // 2, 16), 128))
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    prob = KN._ba_problem(
        K_EUROC, sz["n_kf"], sz["n_pt"], sz["n_ln"], B["obs_kf"].long(),
        B["obs_pt"].long(), B["obs_uv"], B["obs_valid"], B["obs_is2"],
        B["lobs_kf"].long(), B["lobs_ln"].long(), B["lobs_eq"],
        B["lobs_valid"], B["lobs_is2"])
    st = {"pose": B["kf_poses"], "pt": B["pt_xyz"], "ln": B["ln_ep6"]}
    layout, H, gv, lm_sys, cost, _ = prob.build_normal_equations(st)
    t = w.t
    Hk = torch.block_diag(*unpack_sym(t["hcc"][:, :21], 6).unbind(0))
    errs = {"H": rel_err(Hk, H), "g": rel_err(t["hcc"][:, 21:].reshape(-1),
                                              gv),
            "Hpp points": rel_err(unpack_sym(t["hpt"][:, :6], 3),
                                  lm_sys["pt"][0]),
            "gp points": rel_err(t["hpt"][:, 6:], lm_sys["pt"][1]),
            "Hpp lines": rel_err(unpack_sym(t["hln"][:, :21], 6),
                                 lm_sys["ln"][0]),
            "gp lines": rel_err(t["hln"][:, 21:], lm_sys["ln"][1]),
            "cost": abs(float(t["ctrl"][1]) - float(cost)) / float(cost)}
    # the couplings: the per-observation blocks summed per (KF, landmark)
    for fam, Wo, okf, olm in (("points", t["p_w"], B["obs_kf"], B["obs_pt"]),
                              ("lines", t["l_w"], B["lobs_kf"],
                               B["lobs_ln"])):
        Bp = lm_sys["pt" if fam == "points" else "ln"][2]
        D = Wo.shape[1] // 6
        P = Bp.shape[1] // D
        Bk = torch.zeros(sz["n_kf"], P, 6, D, dtype=torch.float64, device=dev)
        Bk.index_put_((okf.long(), olm.long()), Wo.double().view(-1, 6, D),
                      accumulate=True)
        errs[f"B {fam}"] = rel_err(Bk.permute(0, 2, 1, 3).reshape(Bp.shape),
                                   Bp.double())
    worst = max(errs, key=errs.get)
    print(f"  ba_linearize relative errors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(errs[worst] <= 1e-4, "ba_linearize: H blocks, g, Hpp, gp, the "
          "couplings B and the "
          f"cost within 1e-4 relative of the plain engine (worst {worst} "
          f"{errs[worst]:.2e})")
    n_obs, n_lobs = sz["n_obs"], sz["n_lobs"]
    n_pt, n_ln, n_kf = sz["n_pt"], sz["n_ln"], sz["n_kf"]
    lin_in = nbytes(*[B[k] for k in keys])
    lin_out = nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"])
    report["ba_linearize"] = dict(
        **work(lin_in + lin_out, 400 * n_obs + 1100 * n_lobs),
        max_abs_err=errs[worst],
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: prob.build_normal_equations(st), reps=5))
    KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    ff_ref = torch.mm(t["gm"], t["gm"].T)
    gram_err = rel_err(t["ff"], ff_ref)
    check(gram_err <= 1e-5, f"schur_solve: Gram fill-in within {gram_err:.2e}"
          " relative of torch.mm on its operand (<= 1e-5)")
    lam = torch.tensor(1e-4, device=dev)
    free = ({"pose": B["kf_free"]}, {"pt": B["pt_free"], "ln": B["ln_free"]})
    new = prob.step_from_system(layout, H, gv, lm_sys, st, lam, *free)
    dpose = float((t["cposes"].view(n_kf, 3, 4) - new["pose"]).abs().max())
    check(dpose <= 1e-4, f"schur_solve: candidate KF poses within 1e-4 of "
          f"the plain engine's step (max {dpose:.2e})")
    # the landmarks: against a float64 back-substitution from the kernel's
    # own system (held to the plain one above) and pose step on every
    # occupied landmark, in float32 ulps times the block's condition
    # number: at most the larger of 32 and 4x what the plain float32
    # formulas reach on the same inputs; and against the plain step along
    # Hpp's well-conditioned directions, to 1e-3 relative: the two pose
    # steps differ by up to ~7e-5 (the fixed-step CG in float32, summed in
    # another order), which moves the landmarks by ~4e-4 relative
    eps = 2.0 ** -24
    for fam, cand, ref, X, hp, W, obs_lm, obs_kf, lfree in (
            ("points", t["cpts"], new["pt"], B["pt_xyz"], t["hpt"], t["p_w"],
             B["obs_pt"], B["obs_kf"], B["pt_free"]),
            ("lines", t["clns"], new["ln"], B["ln_ep6"], t["hln"], t["l_w"],
             B["lobs_ln"], B["lobs_kf"], B["ln_free"])):
        rel, kept = well_gap(cand, ref,
                             lm_sys["pt" if fam == "points" else "ln"][0])
        bargs = (hp, W, obs_lm.long(), obs_kf.long(), lfree, t["dx"], X, 1e-4)
        r64, occ, cond = backsub_reference(*bargs)
        r32 = backsub_reference(*bargs, dt=torch.float32)[0]
        scale = eps * cond * (r64 - X.double()).norm(dim=1) + 1e-7

        def ulps(c):
            return float(((c.double() - r64).norm(dim=1) / scale)[occ].max())
        u_k, u_32 = ulps(cand), ulps(r32)
        lim = max(32.0, 4 * u_32)
        print(f"  schur_solve {fam}: {int((kept > 0).sum())} of {rel.numel()}"
              f" with well-conditioned directions ({int(kept.sum())} in all),"
              f" within {float(rel.max()):.2e} relative of the plain step "
              f"along them; {int(occ.sum())} occupied (largest condition "
              f"number {float(cond[occ].max()):.3g}), within {u_k:.2f} ulps "
              f"x condition number of the float64 back-substitution (the "
              f"plain float32 formulas: {u_32:.2f})")
        check(int(kept.sum()) > 0 and float(rel.max()) <= 1e-3,
              f"schur_solve: candidate {fam} within 1e-3 relative of the "
              "plain step along Hpp's well-conditioned directions")
        check(int(occ.sum()) > 0 and u_k <= lim,
              f"schur_solve: candidate {fam} within {lim:.1f} ulps x "
              "condition number of a float64 back-substitution from the "
              "kernel's own system, every occupied landmark")
        occ_k = (t["occ_pt"] if fam == "points" else t["occ_ln"]).bool()
        check(torch.equal(occ_k, occ) and bool((cand[~occ] == X[~occ]).all()),
              f"schur_solve {fam}: occupied gate as the float64 one's, and "
              "the landmarks outside it unchanged")

    def schur():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    C = 3 * n_pt + 6 * n_ln

    def gram_ops(obs_kf, obs_lm, n_lm, D):
        # the fill-in's least work: per landmark seen from m keyframes, the
        # upper triangle of its (6m x 6m) block, D multiply-adds an entry
        key = torch.unique(obs_kf.long() * n_lm + obs_lm.long())
        m = torch.bincount(key % n_lm, minlength=n_lm).double()
        return float((6 * m * (6 * m + 1) / 2 * D * 2).sum())
    # the landmark factors and the per-observation G = W F, the fill-in,
    # the CG (2 S^2 per iteration) and the back-substitution
    report["schur_solve"] = dict(
        **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"],
                      t["poses"], t["pts"], t["lns"])
               + nbytes(t["cposes"], t["cpts"], t["clns"], t["dx"]),
               300 * n_pt + 1500 * n_ln + 250 * n_obs + 1000 * n_lobs
               + gram_ops(B["obs_kf"], B["obs_pt"], n_pt, 3)
               + gram_ops(B["lobs_kf"], B["lobs_ln"], n_ln, 6)
               + w_cg(S) * 2 * S * S),
        max_abs_err=dpose, ms=cuda_ms(schur),
        plain_ms=cuda_ms(lambda: prob.step_from_system(
            layout, H, gv, lm_sys, st, lam, *free), reps=5),
        gram_ms=cuda_ms(lambda: torch.mm(t["gm"], t["gm"].T, out=ff_ref)),
        gram_work=work(nbytes(t["gm"], t["ff"]), 2 * S * S * C))


def _cast(v, dt):
    if isinstance(v, dict):
        return {k: _cast(x, dt) for k, x in v.items()}
    return v.to(dt) if torch.is_tensor(v) and v.is_floating_point() else v


def liba_problem(A, args, terms=None):
    """The plain engine's inertial window problem at the window's masks
    (only the named terms, if given) and its states and free masks."""
    dt = args[0].dtype
    prob = KN._liba_problem(
        K_EUROC, A["Rcb"].to(dt), A["tcb"].to(dt), GRAVITY,
        A["kf_pose_wb"].shape[0], A["pt_xyz"].shape[0], A["ln_ep6"].shape[0],
        (args[8].long(), args[9].long(), args[10], args[12]), args[11],
        (args[20].long(), args[21].long(), args[22]), args[23],
        (args[13], args[14], args[15], args[16], args[17]))
    if terms is not None:
        prob.terms = [t for t in prob.terms if t.name in terms]
    st = {"pose": args[0], "vel": args[1], "bg": args[2], "ba": args[3],
          "pt": args[6], "ln": args[18]}
    free = ({"pose": args[4], "vel": args[4], "bg": args[5],
             "ba": args[5]}, {"pt": args[7], "ln": args[19]})
    return prob, st, free


def check_inertial_kernels(report):
    """The kernels of slice 4 against their plain versions: ba_linearize's
    body-frame mode, inertial_chain and schur_solve's 15-DoF step on one
    LM step of the perturbed worst-case inertial window, and
    inertial_gs_lm (initialization and refinement) at the cap of 32 KF."""
    dev = torch.device("cuda")
    _, A = inertial_ba_step(**LIBA_WORST, perturbed=True, device=dev)
    args = [A[k] for k in KN.LIBA_KEYS]
    n_kf, n_pt, n_ln = 16, LIBA_WORST["n_pt"], LIBA_WORST["n_ln"]
    n_obs, n_lobs = LIBA_WORST["n_obs"], LIBA_WORST["n_lobs"]
    w = KN.inertial_work(K_EUROC, A["Rcb"], A["tcb"], GRAVITY, *args)
    w.chain(KN.CHAIN_COST_STATE)
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    w.chain(KN.CHAIN_LINEARIZE)
    t = w.t
    # -- ba_linearize (body frame): the visual terms alone
    vis, st, free = liba_problem(A, args, ("reproj", "line"))
    _, Hv, gv, lm_sys, cost_v, _ = vis.build_normal_equations(st)
    S6 = 6 * n_kf
    Hk = torch.block_diag(*unpack_sym(t["hcc"][:, :21], 6).unbind(0))
    errs = {"pose blocks": rel_err(Hk, Hv[:S6, :S6]),
            "g": rel_err(t["hcc"][:, 21:].reshape(-1), gv[:S6]),
            "Hpp points": rel_err(unpack_sym(t["hpt"][:, :6], 3),
                                  lm_sys["pt"][0]),
            "gp points": rel_err(t["hpt"][:, 6:], lm_sys["pt"][1]),
            "Hpp lines": rel_err(unpack_sym(t["hln"][:, :21], 6),
                                 lm_sys["ln"][0]),
            "gp lines": rel_err(t["hln"][:, 21:], lm_sys["ln"][1])}
    for fam, Wo, okf, olm in (("points", t["p_w"], A["obs_kf"], A["obs_pt"]),
                              ("lines", t["l_w"], A["lobs_kf"],
                               A["lobs_ln"])):
        Bp = lm_sys["pt" if fam == "points" else "ln"][2][:S6]
        D = Wo.shape[1] // 6
        P = Bp.shape[1] // D
        Bk = torch.zeros(n_kf, P, 6, D, dtype=torch.float64, device=dev)
        Bk.index_put_((okf.long(), olm.long()), Wo.double().view(-1, 6, D),
                      accumulate=True)
        errs[f"B {fam}"] = rel_err(Bk.permute(0, 2, 1, 3).reshape(Bp.shape),
                                   Bp.double())
    print("  ba_linearize body frame, relative errors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    blocks = {k: v for k, v in errs.items() if not k.startswith("B ")}
    worst = max(blocks, key=blocks.get)
    check(blocks[worst] <= 1e-5, "ba_linearize body frame: pose blocks, g, "
          f"Hpp and gp within 1e-5 relative of the plain engine (worst "
          f"{worst} {blocks[worst]:.2e})")
    # the couplings are per-observation products of two Jacobians formed
    # in another order (1.2e-5 for lines in both frames), as phase 3
    check(max(errs["B points"], errs["B lines"]) <= 1e-4,
          "ba_linearize body frame: the couplings B within 1e-4 relative of "
          "the plain engine")
    worst = max(errs, key=errs.get)
    # -- inertial_chain: the chain terms alone
    chn, _, _ = liba_problem(A, args, ("inertial", "bg_rw", "ba_rw"))
    _, Hc, gc, _, cost_c, _ = chn.build_normal_equations(st)
    Hl, gl = KN.inertial_dense_system(t, n_kf)
    Hl[:S6, :S6] -= Hk.double()
    gl[:S6] -= t["hcc"][:, 21:].double().reshape(-1)
    full, _, _ = liba_problem(A, args)
    _, H, g, lm_full, cost, _ = full.build_normal_equations(st)
    cerr = {"H": rel_err(Hl, Hc.double()), "g": rel_err(gl, gc.double()),
            "chain cost": abs(float(t["ccost"][0]) - float(cost_c))
            / float(cost_c),
            "cost": abs(float(t["ctrl"][1]) - float(cost)) / float(cost)}
    print("  inertial_chain relative errors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in cerr.items()))
    check(max(cerr.values()) <= 1e-5, "inertial_chain: H and g blocks of "
          "the inertial and bias random-walk edges, the chain's cost and the "
          "step's cost within 1e-5 relative of the plain engine's "
          "build_normal_equations")
    lin_in = nbytes(*[A[k] for k in KN.LIBA_KEYS if k != "pre_const"]) \
        + nbytes(*A["pre_const"].values())
    lin_out = nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"])
    report["ba_linearize"]["inertial"] = dict(
        **work(lin_in + lin_out, 450 * n_obs + 1200 * n_lobs),
        max_abs_err=errs[worst],
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: vis.build_normal_equations(st), reps=3))
    # per link: residual, Jacobian and the 9x9 Cholesky (~2k), the
    # whitening of 25 columns (~2.3k), 495 block entries (~9k)
    n_e = n_kf - 1
    ch_in = nbytes(t["poses"], t["kfx"], t["pre"], t["imu_info"],
                   t["edge_valid"], t["rw_g"], t["rw_a"])
    report["inertial_chain"] = dict(
        **work(ch_in + nbytes(t["link"], t["link_cost"], t["ccost"]),
               13500 * n_e),
        max_abs_err=max(cerr.values()),
        ms=cuda_ms(lambda: w.chain(KN.CHAIN_LINEARIZE)),
        plain_ms=cuda_ms(lambda: chn.build_normal_equations(st), reps=5))
    # -- schur_solve, 15-DoF: one step against the plain step and float64
    KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    lam = torch.tensor(1e-4, device=dev)
    new = full.step_from_system(*full.build_normal_equations(st)[:4], st,
                                lam, *free)
    A64 = {k: A[k].cpu() for k in ("kf_pose_wb", "pt_xyz", "ln_ep6", "Rcb",
                                   "tcb")}
    args64 = [_cast(a.cpu() if torch.is_tensor(a) else
                    {k: x.cpu() for k, x in a.items()}, torch.float64)
              for a in args]
    p64, st64, free64 = liba_problem(A64, args64)
    ref, _, _ = p64.solve_step(st64, torch.tensor(1e-4, dtype=torch.float64),
                               *free64)
    args32 = [_cast(a, torch.float32) for a in args64]
    p32, st32, free32 = liba_problem(A64, args32)
    cpu32, _, _ = p32.solve_step(st32, torch.tensor(1e-4), *free32)
    kfx = t["ckfx"]
    cand = {"pose": t["cposes"].view(n_kf, 3, 4), "vel": kfx[:, :3],
            "bg": kfx[:, 3:6], "ba": kfx[:, 6:]}
    gaps = {}
    for name in ("pose", "vel", "bg", "ba"):
        gk = float((cand[name].double().cpu() - ref[name]).abs().max())
        gp = float((new[name].double().cpu() - ref[name]).abs().max())
        gc = float((cpu32[name].double() - ref[name]).abs().max())
        kp = float((cand[name] - new[name]).abs().max())
        gaps[name] = (gk, gp, gc, kp)
    print("  schur_solve 15-DoF step, from float64 (kernel, plain on the "
          "card, plain on the CPU) and kernel - plain: " + ", ".join(
              f"{k} {a:.2e} / {b:.2e} / {c:.2e} / {d:.2e}"
              for k, (a, b, c, d) in gaps.items()))
    # the card's plain step sums by atomics, so its float32 CG lands
    # 1.5e-6 to 2.5e-4 from the kernel's from run to run; the CPU's is
    # fixed
    check(all(gaps[k][0] <= 2 * max(gaps[k][1], gaps[k][2]) + 1e-6
              for k in ("pose", "vel")),
          "schur_solve 15-DoF: candidate poses and velocities within 2x the "
          "farther plain float32 step's (card, CPU) distance to the engine "
          "in float64")
    eps = 2.0 ** -24
    for fam, cnd, X, hp, W, obs_lm, obs_kf, lfree, key in (
            ("points", t["cpts"], A["pt_xyz"], t["hpt"], t["p_w"],
             A["obs_pt"], A["obs_kf"], A["pt_free"], "pt"),
            ("lines", t["clns"], A["ln_ep6"], t["hln"], t["l_w"],
             A["lobs_ln"], A["lobs_kf"], A["ln_free"], "ln")):
        rel, kept = well_gap(cnd, new[key], lm_full[key][0])
        rel = rel[kept > 0]              # padded slots have no direction
        bargs = (hp, W, obs_lm.long(), obs_kf.long(), lfree,
                 t["dx"][:S6], X, 1e-4)
        r64, occ, cond = backsub_reference(*bargs)
        r32 = backsub_reference(*bargs, dt=torch.float32)[0]
        scale = eps * cond * (r64 - X.double()).norm(dim=1) + 1e-7

        def ulps(c):
            return float(((c.double() - r64).norm(dim=1) / scale)[occ].max())
        u_k, u_32 = ulps(cnd), ulps(r32)
        lim = max(32.0, 4 * u_32)
        print(f"  schur_solve 15-DoF {fam}: {int((kept > 0).sum())} with "
              f"well-conditioned directions, within {float(rel.max()):.2e} "
              f"relative of the plain step along them; {int(occ.sum())} "
              f"occupied, within {u_k:.2f} ulps x condition number of the "
              f"float64 back-substitution (plain float32 formulas {u_32:.2f})")
        check(int(occ.sum()) > 0 and u_k <= lim,
              f"schur_solve 15-DoF: candidate {fam} within {lim:.1f} ulps x "
              "condition number of a float64 back-substitution from the "
              "kernel's own system, every occupied landmark")
        # the plain step's pose step varies by up to 2.5e-4 (above), which
        # moves the landmarks by up to 1.4e-3 relative along these
        # directions; the ulps check above holds the back-substitution
        check(int(kept.sum()) > 0 and float(rel.max()) <= 1e-2,
              f"schur_solve 15-DoF: candidate {fam} within 1e-2 relative of "
              "the plain step along Hpp's well-conditioned directions")
    S = 15 * n_kf

    def schur():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())

    def gram_ops(okf, olm, n_lm, D):
        key = torch.unique(okf.long() * n_lm + olm.long())
        m = torch.bincount(key % n_lm, minlength=n_lm).double()
        return float((6 * m * (6 * m + 1) / 2 * D * 2).sum())
    report["schur_solve"]["inertial"] = dict(
        **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"],
                      t["link"], t["poses"], t["kfx"], t["pts"], t["lns"])
               + nbytes(t["cposes"], t["ckfx"], t["cpts"], t["clns"],
                        t["dx"]),
               300 * n_pt + 1500 * n_ln + 250 * n_obs + 1000 * n_lobs
               + gram_ops(A["obs_kf"], A["obs_pt"], n_pt, 3)
               + gram_ops(A["lobs_kf"], A["lobs_ln"], n_ln, 6)
               + w_cg(S) * 2 * S * S),
        max_abs_err=gaps["pose"][3], ms=cuda_ms(schur),
        plain_ms=cuda_ms(lambda: full.step_from_system(
            *full.build_normal_equations(st)[:4], st, lam, *free), reps=3))
    # -- inertial_gs_lm: initialization and refinement at the cap
    m, B = imu_init(device=dev)
    mp, _ = imu_init(device=dev, plain=True)
    mc, Bc = imu_init(device="cpu")
    B64 = _cast(Bc, torch.float64)
    worst_gap = 0.0
    for name, run in (("init", lambda mm, bb: mm(bb)),
                      ("refine", lambda mm, bb: mm.refine(bb))):
        ok_, op_, ref = run(m, B), run(mp, B), run(mc, B64)
        names = ("Rwg", "scale", "bg", "ba", "vel")[:len(ref)]
        gk = {n: float((a.double().cpu() - r).abs().max())
              for n, a, r in zip(names, ok_, ref)}
        gp = {n: float((a.double().cpu() - r).abs().max())
              for n, a, r in zip(names, op_, ref)}
        kp = max(float((a - b).abs().max()) for a, b in zip(ok_, op_))
        worst_gap = max(worst_gap, kp)
        print(f"  inertial_gs_lm {name}: scale kernel {float(ok_[1]):.7f}, "
              f"plain {float(op_[1]):.7f}, float64 {float(ref[1]):.7f}; "
              f"from float64 kernel {gk}, plain {gp}")
        floor = {"Rwg": 1e-5, "scale": 1e-4, "bg": 1e-6, "ba": 1e-7,
                 "vel": 1e-5}
        check(all(gk[n] <= 2 * gp[n] + floor[n] for n in names),
              f"inertial_gs_lm {name}: within 2x the plain float32 run's "
              f"distance to the engine in float64 (+ {floor})")
    n = 32
    it = 20
    report["inertial_gs_lm"] = dict(
        # per iteration: 31 links of residual, Jacobian, whitening and
        # block (~7k), the 105x105 assembly, Cholesky (S^3 / 3) and two
        # triangular solves, and the candidate's cost (~1.5k a link)
        **work(nbytes(B["Rwg0"], B["vel0"], B["pose_R"], B["pose_p"],
                      B["imu_info"], B["edge_valid"], *B["pre_const"].values())
               + (16 + 3 * n) * 4,
               it * (31 * 8500 + (9 + 3 * n) ** 3 / 3 + 3 * (9 + 3 * n) ** 2)),
        max_abs_err=worst_gap, ms=cuda_ms(lambda: m(B)),
        plain_ms=cuda_ms(lambda: mp(B), reps=3, warmup=1))


def w_cg(S):
    return min(max(S // 2, 16), 128)


def reset_counts():
    for k, _ in KERNELS.values():
        k.launches = 0


def read_counts():
    return {name: k.launches for name, (k, _) in KERNELS.items()}


def run_slice3(dev, pl_step, imgs, pose0, map_args, smi):
    """Phase 7: the mapping step at both sizes.  Returns its launches."""
    print("[7] slice 3: mapping_step at both window sizes, true and "
          "perturbed start")
    sizes = (("worst", MAPPING_WORST), ("typical", MAPPING_TYPICAL))
    runs = {}
    for name, sz in sizes:
        step, A = mapping_step(**sz, device=dev)
        plain, _ = mapping_step(**sz, device=dev, plain=True)
        runs[name] = (step, plain, A, perturbed_window(A))
    reset_counts()
    outs = {}
    with torch.no_grad():
        for name, (step, _, A, B) in runs.items():
            sk_t, sk_p = [], []
            outs[name] = (step(A, stats=sk_t), step(B, stats=sk_p), sk_t,
                          sk_p)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches: {launches}")
    check(all(launches[k] > 0 for k in PATH_MAP),
          f"every kernel of slice 3 launched ({', '.join(PATH_MAP)})")
    for name, (step, plain, A, B) in runs.items():
        ref = REF_MAP[name]
        o_t, o_p, it_t, it_p = outs[name]
        with torch.no_grad():
            sp_t, sp_p = [], []
            q_t, q_p = plain(A, stats=sp_t), plain(B, stats=sp_p)
        counts = (int(o_t.n_good), int(o_t.n_inliers), int(o_t.n_inliers_l))
        e_t = centre_err(o_t.kf_poses, A["kf_poses"])
        e0 = centre_err(B["kf_poses"], A["kf_poses"])
        e_p = centre_err(o_p.kf_poses, A["kf_poses"])
        d_t = float((o_t.kf_poses - q_t.kf_poses).abs().max())
        d_p = float((o_p.kf_poses - q_p.kf_poses).abs().max())
        print(f"  {name}: n_good / inliers / line inliers {counts} (reference "
              f"{ref['n_good']}, {ref['n_inliers']}, {ref['n_inliers_l']}); "
              f"largest camera-centre error: true start {e_t * 1e3:.3f} mm "
              f"(reference {ref['true_max_centre_m'] * 1e3:.3f}), perturbed "
              f"{e0 * 1e3:.3f} -> {e_p * 1e3:.3f} mm (reference "
              f"{ref['perturbed_max_centre_m'] * 1e3:.3f}); LM iterations "
              f"per round kernel {[int(x) for x in it_t]} / "
              f"{[int(x) for x in it_p]}, plain {sp_t} / {sp_p}; plain path "
              f"inliers {int(q_t.n_inliers)} / {int(q_p.n_inliers)}")
        check(all(bool(torch.isfinite(x).all()) for x in
                  (o_t.kf_poses, o_t.pt_xyz, o_t.ln_ep6, o_p.kf_poses,
                   o_p.pt_xyz, o_p.ln_ep6))
              and o_t.kf_poses.shape == (MAPPING_WORST["n_kf"], 3, 4),
              f"{name}: poses, points and lines finite, poses [16,3,4]")
        want = (ref["n_good"], ref["n_inliers"], ref["n_inliers_l"])
        check(all(abs(c - r) <= 0.01 * r for c, r in zip(counts, want)),
              f"{name}: triangulated and inlier counts within 1% of REF_MAP")
        lim = max(2 * ref["perturbed_max_centre_m"], 0.010)
        check(e_p <= lim, f"{name}: perturbed start's largest camera-centre "
              f"error {e_p * 1e3:.3f} mm <= {lim * 1e3:.3f} mm")
        check(max(d_t, d_p) <= MAP_POSE_TOL,
              f"{name}: kernel and plain paths' KF poses within "
              f"{MAP_POSE_TOL:g} (true {d_t:.2e}, perturbed {d_p:.2e})")
        gaps = []
        for o, q, W in ((o_t, q_t, A), (o_p, q_p, B)):
            rk = window_residuals(o.kf_poses, o.pt_xyz, o.ln_ep6, W)
            rq = window_residuals(q.kf_poses, q.pt_xyz, q.ln_ep6, W)
            gaps += [float((a - b).abs().max()) for a, b in zip(rk, rq)]
        check(max(gaps) <= MAP_RES_TOL_PX,
              f"{name}: kernel and plain paths' points and lines reproject "
              f"within {MAP_RES_TOL_PX:g} px of each other in every "
              f"observation (true start {gaps[0]:.2e} / {gaps[1]:.2e}, "
              f"perturbed {gaps[2]:.2e} / {gaps[3]:.2e} px)")
    for name, (step, plain, A, B) in runs.items():
        def go(stp, W):
            def f():
                with torch.no_grad():
                    stp(W)
            return f
        mk = cuda_ms(go(step, B), reps=10, warmup=2)
        mp = cuda_ms(go(plain, B), reps=3, warmup=1)
        print(f"  mapping_step {name} (perturbed start): kernel path "
              f"{mk:.3f} ms/step, plain path {mp:.3f} ms/step, on {smi}")
    step_t, _, A_t, _ = runs["typical"]

    def burst():
        p = pose0
        with torch.no_grad():
            for img in imgs[:3]:
                p, _ = pl_step(img, p, *map_args)
            step_t(A_t)
    sus = cuda_ms(burst, reps=5, warmup=1) / 3
    print(f"  sustained (bench_sustained: 3 point+line frames + 1 typical "
          f"mapping step): {sus:.3f} ms/frame, on {smi}")
    return launches


def liba_errors(A, out):
    """Largest body-position (m), velocity (m/s), rotation (deg) and bias
    errors of a window solve against the truth."""
    pose = out[0].double().cpu()
    gt = A["gt_pose_wb"].double().cpu()
    dR = gt[..., :3].transpose(-1, -2) @ pose[..., :3]
    w = torch.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                     dR[:, 1, 0] - dR[:, 0, 1]], -1) / 2
    return dict(
        max_pos_m=float((pose[..., 3] - gt[..., 3]).norm(dim=1).max()),
        max_vel_mps=float((out[1].double().cpu() - A["gt_vel"].double().cpu())
                          .norm(dim=1).max()),
        max_rot_deg=math.degrees(float(w.norm(dim=1).clamp_max(1.0)
                                       .asin().max())),
        max_bg=float((out[2].cpu() - A["gt_bg"].cpu()).abs().max()),
        max_ba=float((out[3].cpu() - A["gt_ba"].cpu()).abs().max()))


def gdir_deg(R, g):
    a = (R.double().cpu() @ torch.tensor([0.0, 0.0, -1.0],
                                         dtype=torch.float64))
    b = torch.as_tensor(g, dtype=torch.float64)
    return math.degrees(math.atan2(float(torch.linalg.cross(a, b).norm()),
                                   float(a @ b)))


def run_slice4(dev, smi):
    """Phase 8: the inertial window solve at both buckets and both starts,
    the IMU initialization and the scale refinement.  Returns the
    launches."""
    print("[8] slice 4: inertial_ba_step at both buckets, true and perturbed "
          "start; imu_init and its refinement")
    runs = {}
    for name, sz in (("worst", LIBA_WORST), ("half", LIBA_HALF)):
        for start in ("true", "perturbed"):
            pert = start == "perturbed"
            step, A = inertial_ba_step(**sz, perturbed=pert, device=dev)
            plain, _ = inertial_ba_step(**sz, perturbed=pert, device=dev,
                                        plain=True)
            runs[f"{name}_{start}"] = (step, plain, A)
    init, B = imu_init(device=dev)
    init_p, _ = imu_init(device=dev, plain=True)
    reset_counts()
    outs = {}
    with torch.no_grad():
        for key, (step, _, A) in runs.items():
            its = []
            outs[key] = (step(A, stats=its), its)
        o_init, o_ref = init(B), init.refine(B)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches: {launches}")
    check(all(launches[k] > 0 for k in PATH_LIBA + PATH_INIT),
          f"every kernel of slice 4 launched "
          f"({', '.join(PATH_LIBA + PATH_INIT)})")
    for key, (step, plain, A) in runs.items():
        ref = REF_LIBA[key]
        ok_, it_k = outs[key]
        with torch.no_grad():
            it_p = []
            op_ = plain(A, stats=it_p)
        ek, ep = liba_errors(A, ok_), liba_errors(A, op_)
        e0 = liba_errors(A, [A[k] for k in ("kf_pose_wb", "kf_vel", "kf_bg",
                                             "kf_ba")])
        n = (int(ok_.inlier.sum()), int(ok_.inlier_l.sum()))
        gaps = [float((a - b).abs().max()) for a, b in zip(ok_[:4], op_[:4])]
        print(f"  {key}: inliers points / lines kernel {n}, plain "
              f"{(int(op_.inlier.sum()), int(op_.inlier_l.sum()))} "
              f"(reference {ref['n_inliers']}, {ref['n_inliers_l']}); LM "
              f"iterations per round kernel {[int(x) for x in it_k]}, plain "
              f"{it_p}; start {e0['max_pos_m'] * 1e3:.3f} mm / "
              f"{e0['max_vel_mps']:.4f} m/s; errors kernel {ek}; plain {ep}; "
              f"reference {ref}; kernel - plain (pose, vel, bg, ba) {gaps}")
        check(all(bool(torch.isfinite(x).all()) for x in ok_ + op_)
              and ok_.pose_wb.shape == (16, 3, 4),
              f"{key}: states and landmarks finite on both paths, poses "
              "[16,3,4]")
        check(abs(n[0] - ref["n_inliers"]) <= 0.01 * ref["n_inliers"]
              and abs(n[1] - ref["n_inliers_l"]) <= 0.01 * ref["n_inliers_l"],
              f"{key}: point and line inliers within 1% of REF_LIBA")
        lim_p = max(2 * ref["max_pos_m"], 0.010)
        lim_v = max(2 * ref["max_vel_mps"], 0.02)
        check(ek["max_pos_m"] <= lim_p and ek["max_vel_mps"] <= lim_v,
              f"{key}: largest position error {ek['max_pos_m'] * 1e3:.3f} mm"
              f" <= {lim_p * 1e3:.3f} mm, velocity {ek['max_vel_mps']:.4f} <= "
              f"{lim_v:.4f} m/s")
        if key.endswith("perturbed"):
            rej = [int((~o.inlier).sum()) + int((~o.inlier_l).sum())
                   for o in (ok_, op_)]
            check(min(rej) > 0 and torch.equal(ok_.inlier, op_.inlier)
                  and torch.equal(ok_.inlier_l, op_.inlier_l),
                  f"{key}: the chi2 re-gate rejects {rej[0]} / {rej[1]} "
                  "observations on the kernel / plain path, point and line "
                  "masks equal")
    with torch.no_grad():
        p_init, p_ref = init_p(B), init_p.refine(B)
    for name, o, po, sc, gd in (
            ("init", o_init, p_init, REF_INIT["init_scale"],
             REF_INIT["init_gdir"]),
            ("refine", o_ref, p_ref, REF_INIT["refine_scale"],
             REF_INIT["refine_gdir"])):
        dg = gdir_deg(o[0], gd)
        print(f"  imu {name}: scale kernel {float(o[1]):.7f}, plain "
              f"{float(po[1]):.7f}, reference {sc:.7f}; gravity direction "
              f"{dg:.2e} deg from the reference's; truth: scale "
              f"{B['gt_scale'] if name == 'init' else B['gt_ref_scale']:.7f}")
        check(abs(float(o[1]) - sc) <= 0.01 * sc and dg <= 0.1,
              f"imu {name}: scale within 1% and gravity direction within 0.1 "
              "deg of REF_INIT")
    bg_gap = float((o_init[2].cpu() - torch.tensor(REF_INIT["init_bg"]))
                   .abs().max())
    check(bg_gap <= 1e-4, f"imu init: gyro bias within {bg_gap:.2e} of "
          "REF_INIT (<= 1e-4)")
    for name in ("worst", "half"):
        step, plain, A = runs[f"{name}_perturbed"]

        def go(stp):
            def f():
                with torch.no_grad():
                    stp(A)
            return f
        mk = cuda_ms(go(step), reps=10, warmup=2)
        mp = cuda_ms(go(plain), reps=2, warmup=1)
        print(f"  inertial_ba_step {name} (perturbed start): kernel path "
              f"{mk:.3f} ms/step, plain path {mp:.3f} ms/step, on {smi}")
    for name, fk, fp in (("init", lambda: init(B), lambda: init_p(B)),
                         ("refine", lambda: init.refine(B),
                          lambda: init_p.refine(B))):
        print(f"  imu_init {name}: kernel path {cuda_ms(fk):.3f} ms, plain "
              f"path {cuda_ms(fp, reps=3, warmup=1):.3f} ms, on {smi}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = f"{smi} ({torch.cuda.get_device_name(0)}, torch "\
        f"{torch.__version__}, CUDA {torch.version.cuda})"
    print(smi)
    print(f"[1] card: {card}")

    print("[2] build")
    t0 = time.perf_counter()
    msgs = cuda.build(sorted({k.name for k, _ in KERNELS.values()}),
                      ptxas_info=True)
    print(f"  built {len(msgs)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, msg in msgs.items():
        for line in msg.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3] kernels against their plain versions")
    (frames, poses, pt_xyz, pt_desc, pt_valid, ln_ep6, ln_desc, ln_valid,
     traj) = build_inputs(N_FRAMES, CAP_PTS, CAP_LNS, H, W,
                          n_features=N_FEAT, device=dev)
    st = from_numpy(dict(pt_xyz=pt_xyz, pt_desc=pt_desc, pt_valid=pt_valid,
                         ln_ep6=ln_ep6, ln_desc=ln_desc, ln_valid=ln_valid),
                    dev)
    map_args = (st["pt_xyz"], st["pt_desc"], st["pt_valid"], st["ln_ep6"],
                st["ln_desc"], st["ln_valid"])
    imgs = [torch.from_numpy(f).to(dev) for f in frames]
    print(f"  map: {int(pt_valid.sum())} points, {int(ln_valid.sum())} "
          "lines")
    gyro, acc, dts, carry0 = build_imu_windows(traj, N_FRAMES)
    carry0 = tuple(torch.from_numpy(a.copy()).to(dev) for a in carry0)
    windows = [tuple(torch.from_numpy(a[j]).to(dev) for a in (gyro, acc, dts))
               for j in range(N_FRAMES - 1)]
    step, _ = tracking_step_pl(H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE,
                               device=dev)
    vi, _ = tracking_step_vi(H, W, N_FEAT, CAP_PTS, N_LINE, device=dev)
    report = {}
    check_pl_kernels(imgs, poses, st, step, report)
    check_line_kernels(imgs[1], report)
    check_vi_kernels(vi, imgs[1], carry0, (imgs[1], *windows[0]), st, report)
    check_map_kernels(report)
    check_inertial_kernels(report)

    print(f"[4] slice 1: {N_FRAMES} frames through tracking_step_pl, pose "
          "carried")
    pose0 = torch.from_numpy(poses[0]).to(dev)
    reset_counts()
    poses_k, inls = [], []
    pose = pose0
    with torch.no_grad():
        for img in imgs:
            pose, n = step(img, pose, *map_args)
            poses_k.append(pose)
            inls.append(n)
    torch.cuda.synchronize()
    launches_pl = read_counts()
    inls = [int(n) for n in inls]
    errs = [pose_err(P.cpu().numpy(), G) for P, G in zip(poses_k, poses)]
    print(f"  inliers per frame: {inls}")
    print("  camera-centre error mm: "
          f"{[round(e[0] * 1e3, 3) for e in errs]}")
    print(f"  rotation error deg: {[round(e[1], 4) for e in errs]}")
    print(f"  launches: {launches_pl}")
    check(all(bool(torch.isfinite(P).all()) for P in poses_k)
          and all(P.shape == (3, 4) for P in poses_k),
          "poses finite, [3,4]")
    check(min(inls) >= 80, f"every frame >= 80 inliers (min {min(inls)})")
    check(max(e[0] for e in errs) <= 0.010,
          f"camera centre within 10 mm (max "
          f"{max(e[0] for e in errs) * 1e3:.3f} mm)")
    check(max(e[1] for e in errs) <= 0.3,
          f"rotation within 0.3 deg (max {max(e[1] for e in errs):.4f})")
    check(all(launches_pl[k] > 0 for k in PATH_PL),
          f"every kernel of slice 1 launched ({', '.join(PATH_PL)})")
    plain_step, _ = tracking_step_pl(H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE,
                                     device=dev, plain=True)
    pose = pose0
    dmax = []
    with torch.no_grad():
        for img, Pk_ in zip(imgs, poses_k):
            pose, _ = plain_step(img, pose, *map_args)
            dmax.append(float((pose - Pk_).abs().max()))
    print(f"  plain path: largest pose difference per frame {dmax}")

    print(f"[5] slice 2: frames 1..{N_FRAMES - 1} through tracking_step_vi, "
          "carry (pose_wb, v, bg, ba, H15)")
    vi_plain, _ = tracking_step_vi(H, W, N_FEAT, CAP_PTS, N_LINE, device=dev,
                                   plain=True)

    def run_vi(stp):
        c, out = carry0, []
        with torch.no_grad():
            for i in range(1, N_FRAMES):
                c, (n, nl) = stp(c, (imgs[i], *windows[i - 1]), *map_args)
                out.append((c, n, nl))
        return out

    reset_counts()
    out_k = run_vi(vi)
    torch.cuda.synchronize()
    launches_vi = read_counts()
    inls = [int(n) for _, n, _ in out_k]
    lmat = [int(nl) for _, _, nl in out_k]
    pos = [float(np.linalg.norm(c[0][:, 3].cpu().numpy() - traj.p_wb[i]))
           for i, (c, _, _) in enumerate(out_k, start=1)]
    rot = [rot_deg(c[0][:, :3].cpu().numpy(), traj.R_wb[i])
           for i, (c, _, _) in enumerate(out_k, start=1)]
    h_fin = [bool(torch.isfinite(c[4]).all()) for c, _, _ in out_k]
    print(f"  inliers per frame: {inls}")
    print(f"  line matches per frame: {lmat}")
    print(f"  body position error mm: {[round(e * 1e3, 3) for e in pos]}")
    print(f"  rotation error deg: {[round(e, 4) for e in rot]}")
    print(f"  H15 finite per frame: {h_fin}")
    print(f"  launches: {launches_vi}")
    min_inl = math.ceil(0.9 * REF_VI["min_inliers"])
    max_pos = max(2 * REF_VI["max_pos_m"], 0.010)
    max_rot = max(2 * REF_VI["max_rot_deg"], 0.3)
    check(all(bool(torch.isfinite(c[0]).all() and torch.isfinite(c[1]).all())
              for c, _, _ in out_k), "poses and velocities finite")
    check(min(inls) >= min_inl, f"every frame >= {min_inl} inliers (90% of "
          f"the reference's {REF_VI['min_inliers']}; min {min(inls)})")
    check(max(pos) <= max_pos, f"body position within {max_pos * 1e3:.2f} "
          f"mm (max {max(pos) * 1e3:.3f} mm)")
    check(max(rot) <= max_rot, f"rotation within {max_rot:.3f} deg (max "
          f"{max(rot):.4f})")
    check(all(launches_vi[k] > 0 for k in PATH_VI),
          f"every kernel of slice 2 launched ({', '.join(PATH_VI)})")
    out_p = run_vi(vi_plain)
    dvi = [float((ck[0] - cp[0]).abs().max())
           for (ck, _, _), (cp, _, _) in zip(out_k, out_p)]
    inls_p = [int(n) for _, n, _ in out_p]
    print(f"  plain path: largest pose difference per frame {dvi}; inliers "
          f"{inls_p}")
    check(max(dvi) <= 1e-4, f"every frame's pose within 1e-4 of the plain "
          f"path (max {max(dvi):.2e})")
    check(all(abs(k - p) <= 0.01 * max(p, 1) for k, p in zip(inls, inls_p)),
          "every frame's inliers within 1% of the plain path")
    h_rel = [h15_gap(ck[4], cp[4])
             for (ck, _, _), (cp, _, _) in zip(out_k, out_p)]
    check(max(h_rel) <= 1e-3, "every frame's carried H15 within 1e-3 "
          f"relative Frobenius of the plain path, or non-finite on both "
          f"(max {max(h_rel):.2e})")

    print("[6] times")

    def run_pl(stp):
        def go():
            p = pose0
            with torch.no_grad():
                for img in imgs:
                    p, _ = stp(img, p, *map_args)
        return go

    ms_k = cuda_ms(run_pl(step), reps=3, warmup=1) / N_FRAMES
    ms_p = cuda_ms(run_pl(plain_step), reps=2, warmup=1) / N_FRAMES
    print(f"  tracking_step_pl: kernel path {ms_k:.3f} ms/frame, plain path "
          f"{ms_p:.3f} ms/frame, on {smi}")
    vk = cuda_ms(lambda: run_vi(vi), reps=3, warmup=1) / (N_FRAMES - 1)
    vp = cuda_ms(lambda: run_vi(vi_plain), reps=1, warmup=1) / (N_FRAMES - 1)
    print(f"  tracking_step_vi: kernel path {vk:.3f} ms/frame, plain path "
          f"{vp:.3f} ms/frame, on {smi}")

    launches_map = run_slice3(dev, step, imgs, pose0, map_args, smi)
    launches_liba = run_slice4(dev, smi)

    rows = []
    for name, (k, replaces) in KERNELS.items():
        rep = report[name]
        print(f"  {name}: {rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms,"
              f" bound {rep['bound_ms']:.6f} ms ({rep['bound_by']}: "
              f"{rep['bytes']} B, {rep['ops']} ops), on {smi}")
        rows.append(dict(name=name, route="cuda", source=k.source,
                         replaces=replaces,
                         launches=launches_pl[name] + launches_vi[name]
                         + launches_map[name] + launches_liba[name],
                         max_abs_err=rep["max_abs_err"], ms=rep["ms"],
                         plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                         bound_by=rep["bound_by"], library_ms=None))
    for name in ("ba_linearize", "schur_solve"):
        rep = report[name]["inertial"]
        print(f"  {name}, inertial window (15-DoF): {rep['ms']:.4f} ms, plain "
              f"{rep['plain_ms']:.4f} ms, bound {rep['bound_ms']:.6f} ms "
              f"({rep['bound_by']}: {rep['bytes']} B, {rep['ops']} ops), on "
              f"{smi}")
    hm, ss = report["hamming_match"], report["schur_solve"]
    print(f"  hamming_match epipolar mode (1024 x 1024): {hm['epipolar_ms']:.4f}"
          f" ms, plain {hm['epipolar_plain_ms']:.4f} ms, on {smi}")
    gw = ss["gram_work"]
    print(f"  schur_solve {ss['ms']:.4f} ms (its Gram fill-in included) "
          f"beside torch.mm of the fill-in alone {ss['gram_ms']:.4f} ms "
          f"(dense bound {gw['bound_ms']:.6f} ms, {gw['bound_by']}), on "
          f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
