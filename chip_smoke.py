#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two tracked frames at EuRoC geometry (480x752, 1000 ORB
features, 256 line features, 2048 map points, 128 map lines), its
keyframe mapping step at both window sizes of the reference's benchmark
(16 KF x 4096 points x 8192 observations + 512 lines x 1024 observations,
and 2048 / 4096 / 256 / 512), the inertial back end, the keyframe step's
neighbourhood work and the monocular bootstrap through their user entry
points, and fails (nonzero exit, no result line) unless every phase
passes:

1. the card is there (prints `nvidia-smi` name and power limit);
2. the nineteen CUDA kernels build from `plvio_tpu_torch/csrc` (18
   sources: nvcc, sm_90a, one nvcc per source, all started together);
3. each kernel agrees with its plain PyTorch version on the card at the
   paths' shapes (the mapping kernels also on a perturbed window at the
   same shape in which every gate of the epipolar match and of the
   triangulation decides some rows, and the Schur step's landmarks against
   the plain step and a float64 back-substitution; slice 5's kernels on
   every call of a plain run of its path, the projection matcher also in
   the tracker's frustum mode, and `make_local_ba` against float64;
   slice 6's `undistort` at EuRoC's coefficients on the 16 frames'
   keypoints and line endpoints, the two-view kernels on the five cases
   of `inputs.build_twoview_cases` at 200 matches and the general one at
   1000, held to the plain version in float64 on the same samples, and
   `imu_preint` on a 128-sample keyframe window);
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
   frames + 1 typical mapping step, ms per frame);
8. slice 4, `inertial_ba_step` at both buckets and starts and `imu_init`
   with its refinement, held to REF_LIBA / REF_INIT;
9. slice 5, `neighborhood_step` on both maps of
   `inputs.build_keyframe_map` (with and without confirmed map lines):
   new lines, fuse binds, merges and refusals and the BA's path equal on
   the kernel and plain paths, the BA's KF poses within 2x the CPU plain
   run's distance to float64, the counts within 1% of the JAX mapper's on
   the CPU (REF_NBH below), the
   largest camera-centre error within max(2x the reference's, 10 mm),
   every kernel of the path launched; CUDA-event ms per step on both
   paths and the host syncs per step;
10. slice 6, `bootstrap_step`: the rendered frames through the frame
   prelude and the port's tracker to the initial map, held to the JAX
   tracker's run on the CPU (REF_BOOT below: the initializing frame, the
   attempts and the model equal, the counts within their tolerances, the
   second keyframe's rotation and t-direction errors against the truth
   within 2x the reference's largest over five RANSAC keys), every kernel
   of the path launched (PATH_BOOT; `undistort` not, as the renders have
   no distortion); then, as a path of its own, the EuRoC-raw case (raw
   cam0 pixels) through `undistort_pixels` and `reconstruct_two_views`,
   every kernel of it launched (PATH_RAW); ms per attempt on both paths.

Each kernel's least time on the card (`bound_ms`) is the larger of its
bytes (inputs read once, outputs written once) over 3.35 TB/s and its
operations over 67 TFLOP/s (the float32 rate outside the tensor cores,
also used for the integer work; the two-view kernels solve in float64 by
choice, but the float32 function they replace sets their bound), counted
from this run's shapes and data (`work`, beside each kernel's check).

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
from plvio_tpu_torch.config import CameraConfig, ImuConfig
from plvio_tpu_torch.entry import (K_EUROC, LIBA_HALF, LIBA_WORST,
                                   MAPPING_TYPICAL, MAPPING_WORST,
                                   bootstrap_step, imu_init,
                                   inertial_ba_step, keyframe_sequence,
                                   mapping_step,
                                   neighborhood_step, point_projection_match,
                                   project_points, tracking_step_pl,
                                   tracking_step_vi)
from plvio_tpu_torch.inputs import (TWOVIEW_CASES, build_imu_windows,
                                    build_inputs, build_keyframe_map,
                                    build_twoview_cases, perturb_window)
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import cameras as CAM
from plvio_tpu_torch.ops import frontend as FE
from plvio_tpu_torch.ops import imu as IMU
from plvio_tpu_torch.ops import lines as LN
from plvio_tpu_torch.ops import matching as M
from plvio_tpu_torch.ops import twoview as TV
from plvio_tpu_torch.solver import engine as E
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.state import from_numpy, mapstore_from_numpy

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
    "proj_match": (KN.PROJ_MATCH, "plvio_tpu/models/kernels.py:767"),
    "line_triangulate": (KN.LINE_TRIANGULATE,
                         "plvio_tpu/models/kernels.py:389"),
    "undistort": (CAM.UNDISTORT, "plvio_tpu/ops/cameras.py:86"),
    "twoview_hypotheses": (TV.TWOVIEW_HYPOTHESES,
                           "plvio_tpu/ops/twoview.py:290"),
    "twoview_recover": (TV.TWOVIEW_RECOVER, "plvio_tpu/ops/twoview.py:296"),
}
# schur_solve's launches whose reduced system exceeds one block (its
# global path, counted in KN.SCHUR_SOLVE.global_launches), and the TPU
# kernel it replaces
GLOBAL = ("schur_solve_global", "plvio_tpu/solver/engine.py:256")
PATH_PL = ("orb_fast_grid", "orb_describe", "hamming_match", "pose_irls",
           "line_detect", "line_refine_lbd")
PATH_VI = ("orb_fast_grid", "orb_describe", "hamming_match", "line_detect",
           "line_refine_lbd", "imu_preint", "vi_pose_lm")
PATH_MAP = ("hamming_match", "rot_hist", "triangulate", "ba_linearize",
            "schur_solve")
PATH_LIBA = ("ba_linearize", "inertial_chain", "schur_solve")
PATH_INIT = ("inertial_gs_lm",)
PATH_NBH = ("proj_match", "hamming_match", "line_triangulate", "ba_linearize",
            "schur_solve")
PATH_BOOT = ("orb_fast_grid", "orb_describe", "hamming_match", "rot_hist",
             "line_detect", "line_refine_lbd", "twoview_hypotheses",
             "twoview_recover", "line_triangulate", "imu_preint")
PATH_RAW = ("undistort", "twoview_hypotheses", "twoview_recover")
PATH_SEQ = ("hamming_match", "rot_hist", "triangulate", "line_triangulate",
            "proj_match", "ba_linearize", "schur_solve", "inertial_chain",
            "inertial_gs_lm", "imu_preint", "schur_solve_global")
# tests/test_torch_keyframe_step.py's JAX LocalMapper over
# build_keyframe_sequence(0) at production's sizes on the CPU (float32):
# the keyframe at which the IMU initialized and the scale it applied, 1 /
# the start's monocular scale, keyframes, points and lines alive at the
# end, the map's final scale against the truth, its gravity direction
# error (deg), the full-map solves and their largest window, and the
# keyframe centres' ATE RMSE (m); printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_keyframe_step.py`
REF_SEQ = {"init_kf": 13, "init_scale": 1.7033237218856812,
           "inv_lam": 1.7327722230765765, "keyframes": 32, "points": 6216,
           "lines": 1349, "scale": 0.9881112200492166,
           "gravity_err_deg": 0.0451966042240831, "viba_solves": 1,
           "viba_window": 26, "ate_sim3": 0.004874773026713829,
           "ate_se3": 0.012946194053327333}
# tests/test_torch_bootstrap.py's JAX tracker on build_bootstrap_inputs(0)
# (the port's CPU front end's features): the initializing frame, attempts,
# model, init matches, triangulated matches, points and lines with the
# RANSAC key of seed 0, and the second keyframe's largest rotation (deg)
# and t-direction errors against the truth over the keys 0..4; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_bootstrap.py`
REF_BOOT = {"init_frame": 2, "attempts": 2, "used_homography": True,
            "init_matches": 296, "n_triangulated": 274, "points": 274,
            "lines": 7, "rot_err_deg": 0.23840322026429564,
            "tdir_err": 0.10796273895736609}
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
# the JAX LocalMapper (models/local_mapping.py: create_new_lines,
# search_in_neighbors, local_ba) on the CPU at production caps on both maps
# of inputs.build_keyframe_map: new lines, fuse binds and merges, the BA's
# path, observations the BA's chi2 gate unbound, points and lines after,
# and the largest camera-centre error (m) before and after; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_neighborhood.py`
REF_NBH = {
    "points": {"new_lines": 109, "n_fused": 207, "n_merged": 25,
               "n_bound": 182, "ba_path": "pt", "unbound_by_ba": 128,
               "n_pt": 4646, "n_ln": 109,
               "start_max_centre_m": 0.005461366838584026,
               "max_centre_m": 0.0032463054327698656},
    "confirmed_lines": {"new_lines": 107, "n_fused": 207, "n_merged": 25,
                        "n_bound": 182, "ba_path": "pl",
                        "unbound_by_ba": 128, "n_pt": 4646, "n_ln": 131,
                        "start_max_centre_m": 0.005461366838584026,
                        "max_centre_m": 0.0031855501098876616}}
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


def work(nb, ops, rate=F32_OPS):
    """The bound of a kernel call from its bytes and operations (at
    `rate` operations a second)."""
    t_b, t_o = nb / HBM_BPS * 1e3, ops / rate * 1e3
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


def record_nbh_calls(mp):
    """Wrap the mapper's device calls so that a run records their
    arguments: the path's own inputs for holding each kernel to its plain
    version at the path's shapes."""
    rec = {}
    for attr in ("fuse_match", "line_pair_match", "line_triangulate",
                 "local_ba_kernel", "local_ba_pl_kernel"):
        fn = getattr(mp, attr)
        rec[attr] = []

        def wrap(*a, _fn=fn, _calls=rec[attr], **kw):
            out = _fn(*a, **kw)
            _calls.append((a, {k: v for k, v in kw.items() if k != "stats"},
                           out))
            return out
        setattr(mp, attr, wrap)
    return rec


def ba_float64_gaps(rec):
    """The run's window BA (point-only or point+line, as recorded) against
    the plain engine in float64 on the CPU: the largest KF pose entry gap
    of the recorded result and of the plain float32 run on the CPU."""
    pl = bool(rec["local_ba_pl_kernel"])
    args, _, out = (rec["local_ba_pl_kernel"] if pl
                    else rec["local_ba_kernel"])[0]
    cpu = [x.cpu() for x in args]
    fn = KN.local_ba_pl_plain if pl else KN.local_ba_plain
    ref = fn(K_EUROC, *[x.double() if x.is_floating_point() else x
                        for x in cpu])[0]
    c32 = fn(K_EUROC, *cpu)[0]
    return (float((out[0].cpu().double() - ref).abs().max()),
            float((c32.double() - ref).abs().max()))


def point_stats(m, ids):
    """The tracker's frustum inputs for the map points `ids`, as
    `update_point_stats` (models/local_mapping.py:609)
    forms them: the mean viewing direction of the keyframes that bind each
    point, the distance range from its newest observation's octave."""
    kfs = m.valid_kf_indices()
    R, t = m.kf_pose_cw[kfs, :, :3], m.kf_pose_cw[kfs, :, 3]
    C = -np.einsum("kji,kj->ki", R, t)
    normal = np.zeros((len(ids), 3), np.float32)
    mx = np.zeros(len(ids), np.float32)
    for i, p in enumerate(ids):
        ks, fs = np.nonzero(m.kf_match_pt[kfs] == p)
        if len(ks) < 2:
            continue
        v = m.pt_xyz[p] - C[ks]
        d = np.linalg.norm(v, axis=1)
        n = (v / d[:, None]).sum(0)
        normal[i] = n / np.linalg.norm(n)
        j = np.argmax(m.kf_timestamp[kfs[ks]])
        mx[i] = d[j] * 1.2 ** m.kf_feat_octave[kfs[ks[j]], fs[j]]
    return normal, mx / 1.2 ** 7, mx


def check_nbh_kernels(report):
    """The kernels of slice 5 against their plain versions at the path's
    shapes: every call of one plain run of `neighborhood_step` on the card
    (the fuse's 11 projection matches at 2048 points x 1000 features, the
    line pair matches at 256 x 256, the line triangulations at 256 pairs),
    the projection matcher in the tracker's frustum mode on the first
    fuse's points, and `make_local_ba` at the run's window (16 KF x 4096
    points x 8192 observations) against the plain engine in float64."""
    dev = torch.device("cuda")
    step, m = neighborhood_step(False, device=dev, plain=True)
    rec = record_nbh_calls(step.mapper)
    with torch.no_grad():
        step(m)
    # -- proj_match, fuse mode: every call of the run
    n_eq = 0
    for a, kw, _ in rec["fuse_match"]:
        ok_, op_ = KN.proj_match(K_EUROC, *a), KN.proj_match_plain(K_EUROC,
                                                                    *a)
        n_eq += all(torch.equal(x, y) for x, y in zip(ok_, op_))
    fa = rec["fuse_match"][0][0]
    fk, fp = KN.proj_match(K_EUROC, *fa), KN.proj_match_plain(K_EUROC, *fa)
    check(n_eq == len(rec["fuse_match"]),
          f"proj_match fuse mode: uv_m, pt_feat, matched and feat_pt "
          f"identical in all {len(rec['fuse_match'])} calls of the run "
          f"({int(fk[2].sum())} of {fa[1].shape[0]} matched in the first)")
    # -- proj_match, the tracker's mode: the map's points with their
    #    frustum statistics, radius 6, max_dist 80
    ids = np.unique(m.kf_match_pt[m.valid_kf_indices()])
    ids = ids[ids >= 0][:fa[1].shape[0]]
    nrm, mn, mx = point_stats(m, ids)
    P = fa[1].shape[0]

    def pad(x):
        out = np.zeros((P,) + x.shape[1:], np.float32)
        out[:len(x)] = x
        return torch.from_numpy(out).to(dev)
    xyz = pad(m.pt_xyz[ids])
    desc = torch.from_numpy(np.ascontiguousarray(
        np.pad(m.pt_desc[ids], ((0, P - len(ids)), (0, 0))).view(np.int32)
    )).to(dev)
    live = torch.zeros(P, dtype=torch.bool, device=dev)
    live[:len(ids)] = True
    ta = (fa[0], xyz, desc, live, *fa[4:8], 6.0, 80.0, pad(nrm), pad(mn),
          pad(mx))
    tk, tp = KN.proj_match(K_EUROC, *ta), KN.proj_match_plain(K_EUROC, *ta)
    check(all(torch.equal(x, y) for x, y in zip(tk, tp)),
          "proj_match tracker mode (range and viewing-angle gates, radius "
          f"6, max 80): all four outputs identical ({int(tk[2].sum())} of "
          f"{len(ids)} matched)")
    F_ = fa[4].shape[0]
    # per row the projection and gates (~60 operations), per pair the
    # window test (~8), XOR + popc of 8 words on the pairs it admits (~17)
    scale = torch.from_numpy(KN.OCTAVE_SCALE).to(dev)[fa[6].long()]
    uvp, okp = KN.project_gates(K_EUROC, fa[0], fa[1], fa[3])
    adm = int((((uvp[:, None] - fa[4][None]) ** 2).sum(-1)
               <= (2.0 * scale) ** 2)[okp].sum())
    report["proj_match"] = dict(
        **work(nbytes(*fa[:8]) + nbytes(*fk), 60 * P + 8 * P * F_
               + 17 * adm),
        max_abs_err=float((fk[0] - fp[0]).abs().max()),
        ms=cuda_ms(lambda: KN.proj_match(K_EUROC, *fa)),
        plain_ms=cuda_ms(lambda: KN.proj_match_plain(K_EUROC, *fa)),
        tracker_ms=cuda_ms(lambda: KN.proj_match(K_EUROC, *ta)),
        tracker_plain_ms=cuda_ms(lambda: KN.proj_match_plain(K_EUROC, *ta)))
    # -- hamming_match, line pair mode: every call of the run
    n_eq = 0
    for a, kw, _ in rec["line_pair_match"]:
        ep1, d1, a1, o1, ep2, d2, a2, o2 = a
        args = (d1, d2, o1, o2, ep1, ep2)
        kw = dict(radius=80.0, max_dist=110.0, ratio=0.95, a_ang=a1,
                  b_ang=a2, angle_tol=0.25, pair=True)
        ik, okk = M.hamming_match(*args, **kw)
        ip, okp_ = M.hamming_match_plain(*args, **kw)
        n_eq += torch.equal(ik[okk], ip[okp_]) and torch.equal(okk, okp_)
    ep1, d1, a1, o1, ep2, d2, a2, o2 = rec["line_pair_match"][0][0]
    pargs = (d1, d2, o1, o2, ep1, ep2)
    pkw = dict(radius=80.0, max_dist=110.0, ratio=0.95, a_ang=a1, b_ang=a2,
               angle_tol=0.25, pair=True)
    check(n_eq == len(rec["line_pair_match"]),
          "hamming_match line pair mode: idx and ok identical in all "
          f"{len(rec['line_pair_match'])} calls of the run "
          f"({int(M.hamming_match(*pargs, **pkw)[1].sum())} of "
          f"{ep1.shape[0]} matched in the first)")
    report["hamming_match"]["pair_ms"] = cuda_ms(
        lambda: M.hamming_match(*pargs, **pkw))
    report["hamming_match"]["pair_plain_ms"] = cuda_ms(
        lambda: M.hamming_match_plain(*pargs, **pkw))
    # -- line_triangulate: every call of the run
    errs, n_eq = [], 0
    for a, kw, _ in rec["line_triangulate"]:
        ok_ = KN.line_triangulate(K_EUROC, *a)
        op_ = KN.line_triangulate_plain(K_EUROC, *a)
        n_eq += torch.equal(ok_[2], op_[2])
        g = ok_[2] & op_[2]
        if bool(g.any()):
            errs += [float(((x - y).norm(dim=1) / y.norm(dim=1))[g].max())
                     for x, y in zip(ok_[:2], op_[:2])]
    ta_ = rec["line_triangulate"][0][0]
    lk, lp = KN.line_triangulate(K_EUROC, *ta_), \
        KN.line_triangulate_plain(K_EUROC, *ta_)
    check(n_eq == len(rec["line_triangulate"]) and max(errs) <= 5e-5,
          f"line_triangulate: good masks identical in all "
          f"{len(rec['line_triangulate'])} calls ({int(lk[2].sum())} of "
          f"{int(ta_[4].sum())} good in the first), endpoints within "
          f"{max(errs):.2e} relative (<= 5e-5)")
    n = ta_[2].shape[0]
    # per pair: four ray-plane intersections, 16 depths, the plane angle,
    # agreement, perpendicular distances and length (~400 operations)
    # (rows that fail a gate hold intersections of near-coincident planes,
    # where one rounding step moves the point by metres: good rows only)
    report["line_triangulate"] = dict(
        **work(nbytes(*ta_) + nbytes(*lk), 400 * n),
        max_abs_err=max(float((x - y)[lk[2]].abs().max()) for x, y in
                        zip(lk[:2], lp[:2])),
        ms=cuda_ms(lambda: KN.line_triangulate(K_EUROC, *ta_)),
        plain_ms=cuda_ms(lambda: KN.line_triangulate_plain(K_EUROC, *ta_)))
    # -- make_local_ba: the run's window against float64
    ba = rec["local_ba_kernel"][0][0]
    cpu = [x.cpu() for x in ba]
    ref = KN.local_ba_plain(K_EUROC, *[x.double() if x.is_floating_point()
                                       else x for x in cpu])[0]

    def gap(out):
        return float((out[0].cpu().double() - ref).abs().max())
    with torch.no_grad():
        gk = gap(KN.local_ba(K_EUROC, *ba))
        gp = gap(KN.local_ba_plain(K_EUROC, *ba))
        gc = gap(KN.local_ba_plain(K_EUROC, *cpu))
    print(f"  make_local_ba (16 KF x {ba[2].shape[0]} points x "
          f"{ba[4].shape[0]} observations): KF poses from the float64 run: "
          f"kernel {gk:.2e}, plain on the card {gp:.2e}, plain on the CPU "
          f"{gc:.2e}")
    check(gk <= 2 * gc + 1e-6, "make_local_ba: the kernel path's KF poses "
          "within 2x the CPU plain run's distance to the engine in float64")
    # ba_linearize and schur_solve in make_local_ba's configuration: one LM
    # step of the window, no line family
    w = KN._BAWork(K_EUROC, *ba, *KN.no_lines(dev), lam0=1e-4,
                   early_tol=1e-2, cg_iters=w_cg(6 * ba[0].shape[0]))
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    t = w.t
    n_kf, n_pt, n_obs = ba[0].shape[0], ba[2].shape[0], ba[4].shape[0]
    prob = KN._ba_problem(K_EUROC, n_kf, n_pt, 0, ba[4].long(), ba[5].long(),
                          ba[6], ba[7], ba[8])
    st = {"pose": ba[0], "pt": ba[2]}
    layout, H, gv, lm_sys, cost, _ = prob.build_normal_equations(st)
    Hk = torch.block_diag(*unpack_sym(t["hcc"][:, :21], 6).unbind(0))
    lerr = max(rel_err(Hk, H), rel_err(t["hcc"][:, 21:].reshape(-1), gv),
               rel_err(unpack_sym(t["hpt"][:, :6], 3), lm_sys["pt"][0]),
               rel_err(t["hpt"][:, 6:], lm_sys["pt"][1]))
    check(lerr <= 1e-4, f"ba_linearize, point-only window: H blocks, g, Hpp "
          f"and gp within {lerr:.2e} relative of the plain engine (<= 1e-4)")
    report["ba_linearize"]["points"] = dict(
        **work(nbytes(*ba) + nbytes(t["hcc"], t["hpt"], t["p_w"]),
               400 * n_obs),
        max_abs_err=lerr,
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: prob.build_normal_equations(st), reps=5))
    S = 6 * n_kf

    def schur():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    schur()
    lam = torch.tensor(1e-4, device=dev)
    free = ({"pose": ba[1]}, {"pt": ba[3]})
    new = prob.step_from_system(layout, H, gv, lm_sys, st, lam, *free)
    dpose = float((t["cposes"].view(n_kf, 3, 4) - new["pose"]).abs().max())
    check(dpose <= 1e-4, "schur_solve, point-only window: candidate KF poses "
          f"within {dpose:.2e} of the plain engine's step (<= 1e-4)")
    key = torch.unique(ba[4].long() * n_pt + ba[5].long())
    mm = torch.bincount(key % n_pt, minlength=n_pt).double()
    report["schur_solve"]["points"] = dict(
        **work(nbytes(t["hcc"], t["hpt"], t["p_w"], t["poses"], t["pts"])
               + nbytes(t["cposes"], t["cpts"], t["dx"]),
               300 * n_pt + 250 * n_obs
               + float((6 * mm * (6 * mm + 1) / 2 * 3 * 2).sum())
               + w_cg(S) * 2 * S * S),
        max_abs_err=dpose, ms=cuda_ms(schur),
        plain_ms=cuda_ms(lambda: prob.step_from_system(
            layout, H, gv, lm_sys, st, lam, *free), reps=5))


def twoview_inputs(name, n, dev, cases=None):
    """A case of `inputs.build_twoview_cases` on the card (raw EuRoC
    pixels undistorted by the `undistort` kernel), with 200 H and 200 F
    minimal sets drawn from a generator seeded n."""
    c = (cases or build_twoview_cases(0, n))[name]
    uv1, uv2 = (torch.from_numpy(c[k]).to(dev) for k in ("uv1", "uv2"))
    if c["raw"]:
        cam = CAM.make_camera(CameraConfig())
        uv1, uv2 = (CAM.undistort(cam, u, None)[0] for u in (uv1, uv2))
    valid = torch.from_numpy(c["valid"]).to(dev)
    g = torch.Generator().manual_seed(n)
    idx_h = TV.sample_indices(valid.cpu(), 200, 4, g)
    idx_f = TV.sample_indices(valid.cpu(), 200, 8, g)
    return c, uv1, uv2, valid, idx_h, idx_f


def twoview_against_f64(name, n, uv1, uv2, valid, idx_h, idx_f):
    """Both two-view kernels against the plain version in float64 on the
    card, on the same samples (`ops.twoview.kernels_against_float64`).
    Returns (kernel output, info, the largest R / t / point gaps)."""
    g = TV.kernels_against_float64(K_EUROC, uv1, uv2, valid, idx_h, idx_f)
    torch.cuda.synchronize()
    r, rp = g.out.result, g.ref.result
    ok = bool(r.success) == bool(rp.success) == (name != "rotation") \
        and bool(r.used_homography) == bool(rp.used_homography) \
        and g.best_equal and g.score_gap <= 1e-6 \
        and max(g.gaps) <= 1e-5 and g.flips <= 0.01 * n
    check(ok, f"two-view kernels, {name} at N = {n}: success "
          f"{bool(r.success)}, homography {bool(r.used_homography)}, best "
          f"minimal models {int(g.out.b_h)} / {int(g.out.b_f)} as the "
          f"float64 plain version's (ties excepted), scores within "
          f"{g.score_gap:.1e} (<= 1e-6), R / t / points within "
          f"{g.gaps[0]:.1e} / {g.gaps[1]:.1e} / {g.gaps[2]:.1e} (<= 1e-5), "
          f"{g.flips} triangulation flips (<= 1%)")
    return g.out, g.info, g.gaps


def check_boot_kernels(imgs, orb, lines, report):
    """The kernels of slice 6 against their plain versions: `undistort` at
    EuRoC's coefficients on the 16 frames' keypoints and segment endpoints
    (from the kernel front end), the two-view kernels on the five cases at
    200 matches and the general one at 1000 against the plain version in
    float64 on the same samples, `imu_preint` on a keyframe's window of
    128 samples (100 live)."""
    dev = imgs[0].device
    cam = CAM.make_camera(CameraConfig())
    errs, frames = [0.0, 0.0], []
    with torch.no_grad():
        for img in imgs:
            f, lf = orb(img), lines(img)
            kp, ep = f.uv.contiguous(), lf.ep.contiguous()
            uk, ek, qk = CAM.undistort(cam, kp, ep)
            up, epp, _ = CAM.undistort_frame_plain(cam, kp, ep)
            own = LN.line_equation(ek)
            errs[0] = max(errs[0], float((uk - up).abs().max()),
                          float((ek - epp).abs().max()))
            # c = (x0 y1 - y0 x1) / n cancels products of ~1e5: its
            # rounding scales with them over the length, a and b with 1
            scale = torch.stack([torch.ones_like(ek[:, 0])] * 2 + [
                ((ek[:, 0] * ek[:, 3]).abs() + (ek[:, 1] * ek[:, 2]).abs())
                / torch.linalg.vector_norm(ek[:, 2:] - ek[:, :2], dim=1)],
                1)
            errs[1] = max(errs[1], float(((qk - own).abs() / scale).max()))
            frames.append((kp, ep))
    check(errs[0] == 0 and errs[1] <= 1e-6,
          f"undistort at EuRoC's coefficients, {len(imgs)} frames' "
          f"keypoints and endpoints: within {errs[0]:.2e} px of the plain "
          f"version (== 0: the same float32 operations in the same order), "
          f"line equations those of its own endpoints "
          f"within {errs[1]:.2e} of their scale (<= 1e-6; c's scale is the "
          "products it cancels over the length)")
    kp, ep = frames[1]
    n_pts, n_seg = kp.shape[0], ep.shape[0]
    # per point 8 Newton steps of ~70 operations and the pixel maps (~8),
    # per segment its line equation (~15)
    report["undistort"] = dict(
        **work(nbytes(kp, ep) + nbytes(*CAM.undistort(cam, kp, ep)),
               (8 * 70 + 8) * (n_pts + 2 * n_seg) + 15 * n_seg),
        max_abs_err=errs[0], ms=cuda_ms(lambda: CAM.undistort(cam, kp, ep)),
        plain_ms=cuda_ms(lambda: CAM.undistort_frame_plain(cam, kp, ep)))
    # -- the two-view kernels
    cases = build_twoview_cases(0, 200)
    gaps = []
    for name in TWOVIEW_CASES:
        _, *a = twoview_inputs(name, 200, dev, cases)
        gaps.append(twoview_against_f64(name, 200, *a)[2])
    _, uv1, uv2, valid, idx_h, idx_f = twoview_inputs("general", 1000, dev)
    out, info, g1000 = twoview_against_f64("general", 1000, uv1, uv2, valid,
                                           idx_h, idx_f)
    gaps.append(g1000)
    n = uv1.shape[0]
    ih, if_ = idx_h.to(dev, torch.int32), idx_f.to(dev, torch.int32)
    models, scores = TV.twoview_hypotheses(uv1, uv2, valid, ih, if_)
    # what the function needs, at the float32 rate of the reference (the
    # kernel itself solves in float64): per model its 8x9 system (~100
    # operations) and null vector (~9^3), per F model the rank-2 cut of a
    # 3x3 (~3^3) and the denormalization (~90); per model and match the
    # symmetric transfer or epipolar terms (~45)
    report["twoview_hypotheses"] = dict(
        **work(nbytes(uv1, uv2, valid, ih, if_, models, scores),
               400 * (100 + 9 ** 3) + 200 * (3 ** 3 + 90) + 400 * n * 45),
        max_abs_err=max(g[0] for g in gaps),
        ms=cuda_ms(lambda: TV.twoview_hypotheses(uv1, uv2, valid, ih, if_)),
        plain_ms=cuda_ms(lambda: TV.twoview_hypotheses_plain(
            uv1, uv2, valid, idx_h.to(dev), idx_f.to(dev)), reps=5))
    hyp = TV.twoview_hypotheses_plain(uv1, uv2, valid, idx_h.to(dev),
                                      idx_f.to(dev))
    n_cand = int((info[8:] >= 0).sum())
    # what the function needs, at the float32 rate: per match the inlier
    # tests of the two best models (~90), both refits' A^T A rows (3 rows
    # x 45 entries x 2), their re-scores (~90), and per motion hypothesis
    # of the chosen model one 4x4 triangulation (~24 to build, ~4^3 for
    # its null vector) with the gates (~60); the refits' 9x9 null vectors
    # and the decomposition (~2 x 9^3 + 500)
    report["twoview_recover"] = dict(
        **work(nbytes(uv1, uv2, valid, models, scores)
               + nbytes(*out.result[1:5]),
               n * (90 + 270 + 90) + n_cand * n * (24 + 4 ** 3 + 60)
               + 2 * 9 ** 3 + 500),
        max_abs_err=max(max(g[1], g[2]) for g in gaps),
        ms=cuda_ms(lambda: TV.twoview_recover(K_EUROC, uv1, uv2, valid,
                                              models, scores)),
        plain_ms=cuda_ms(lambda: TV.twoview_recover_plain(
            K_EUROC, uv1, uv2, valid, *hyp), reps=5))
    # -- imu_preint on a keyframe window longer than 64 samples
    rng = np.random.default_rng(128)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dt).to(dev)
    args = (t(rng.normal(0, 0.5, (128, 3))),
            t(rng.normal(0, 1.0, (128, 3)) + [0, 0, 9.81]),
            t(np.full(128, 0.005)), t(np.arange(128) < 100, torch.bool),
            IMU.make_calib(ImuConfig()), t(np.zeros(3)), t(np.zeros(3)),
            t(np.eye(3, 4)), t(np.zeros(3)))
    fk, fp = IMU.imu_preint(*args), IMU.imu_preint_plain(*args)
    rel = max(float((getattr(fk.pre, f) - getattr(fp.pre, f)).abs().max())
              / max(float(getattr(fp.pre, f).abs().max()), 1e-30)
              for f in fk.pre._fields)
    check(rel <= 5e-5, f"imu_preint on a 128-sample keyframe window (100 "
          f"live): every preintegrated field within {rel:.2e} relative of "
          "the plain version (<= 5e-5)")


def reset_counts():
    for k, _ in KERNELS.values():
        k.launches = 0
    KN.SCHUR_SOLVE.global_launches = 0


def read_counts():
    return {**{name: k.launches for name, (k, _) in KERNELS.items()},
            GLOBAL[0]: KN.SCHUR_SOLVE.global_launches}


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


def map_centre_err(m, truth):
    """Largest camera-centre error (m) of the map's keyframes."""
    G = truth["kf_pose_cw"].astype(np.float64)
    P = m.kf_pose_cw[:len(G)].astype(np.float64)
    c = -np.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -np.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float(np.linalg.norm(c - cg, axis=1).max())


def run_slice5(dev, smi, report):
    """Phase 9: the keyframe step's neighbourhood work on both maps, kernel
    and plain paths, each from its own copy of the map.  Returns the
    launches."""
    print("[9] slice 5: neighborhood_step on both maps of "
          "build_keyframe_map, kernel and plain paths")
    runs = {}
    for name, conf in (("points", False), ("confirmed_lines", True)):
        arrays, truth = build_keyframe_map(conf)
        step, _ = neighborhood_step(conf, device=dev)
        plain, _ = neighborhood_step(conf, device=dev, plain=True)
        runs[name] = (step, plain, arrays, truth)
    reset_counts()
    outs, recs = {}, {}
    with torch.no_grad():
        for name, (step, _, arrays, _) in runs.items():
            mk = mapstore_from_numpy(arrays)
            recs[name] = record_nbh_calls(step.mapper)
            outs[name] = (step(mk), mk)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches: {launches}")
    check(all(launches[k] > 0 for k in PATH_NBH),
          f"every kernel of slice 5 launched ({', '.join(PATH_NBH)})")
    for name, (step, plain, arrays, truth) in runs.items():
        ref = REF_NBH[name]
        ok_, mk = outs[name]
        mp_ = mapstore_from_numpy(arrays)
        with torch.no_grad():
            op_ = plain(mp_)
        e0 = map_centre_err(mapstore_from_numpy(arrays), truth)
        ek, ep = map_centre_err(mk, truth), map_centre_err(mp_, truth)
        dpose = float(np.abs(mk.kf_pose_cw - mp_.kf_pose_cw).max())
        nb = int((mk.kf_match_pt >= 0).sum())
        db = int((mk.kf_match_pt != mp_.kf_match_pt).sum()
                 + (mk.kf_match_ln != mp_.kf_match_ln).sum())
        gk, gc = ba_float64_gaps(recs[name])
        print(f"  {name}: kernel {tuple(ok_)}, plain {tuple(op_)}; "
              f"reference {ref}; largest camera-centre error {e0 * 1e3:.3f} "
              f"-> kernel {ek * 1e3:.3f} / plain {ep * 1e3:.3f} mm; "
              f"kernel - plain KF poses {dpose:.2e}, bindings differing "
              f"{db} of {nb}; the BA's KF poses from a float64 run: kernel "
              f"{gk:.2e}, plain on the CPU {gc:.2e}")
        check(all(np.isfinite(x).all() for x in (mk.kf_pose_cw, mk.pt_xyz,
                                                 mk.ln_ep)),
              f"{name}: poses, points and lines finite")
        same = ("new_lines", "n_bound", "n_merged", "n_refused", "ba_path")
        check(all(getattr(ok_, k) == getattr(op_, k) for k in same),
              f"{name}: new lines, fuse binds, merges and refusals and the "
              "BA path equal on the kernel and plain paths")
        want = "pl" if name == "confirmed_lines" else "pt"
        check(ok_.ba_path == ref["ba_path"] == want,
              f"{name}: the BA took the {want!r} path, as the reference")
        # the card's plain BA sums by atomics (kernel - plain 1e-5 to
        # 1.02e-4 in a pose entry from run to run on the confirmed-lines
        # map), so the kernel path is held to float64 as in phase 3
        check(gk <= 2 * gc + 1e-6 and db <= 0.001 * nb,
              f"{name}: the BA's KF poses within 2x the CPU plain run's "
              f"distance to float64 ({gk:.2e} vs {gc:.2e}), the kernel and "
              f"plain paths' bindings equal but for 0.1% ({db})")
        got = {"new_lines": ok_.new_lines, "n_bound": ok_.n_bound,
               "n_merged": ok_.n_merged, "n_pt": mk.n_pt, "n_ln": mk.n_ln}
        check(all(abs(v - ref[k]) <= 0.01 * ref[k] for k, v in got.items()),
              f"{name}: new lines, binds, merges, points and lines {got} "
              "within 1% of REF_NBH")
        lim = max(2 * ref["max_centre_m"], 0.010)
        check(ek <= lim, f"{name}: largest camera-centre error "
              f"{ek * 1e3:.3f} mm <= {lim * 1e3:.3f} mm")
    for name, (step, plain, arrays, _) in runs.items():
        def go(stp, reps):
            maps = iter([mapstore_from_numpy(arrays) for _ in range(reps)])

            def f():
                with torch.no_grad():
                    return stp(next(maps))
            return f
        mk = cuda_ms(go(step, 7), reps=5, warmup=2)
        mp = cuda_ms(go(plain, 3), reps=2, warmup=1)
        syncs = outs[name][0].host_syncs
        print(f"  neighborhood_step {name}: kernel path {mk:.3f} ms/step, "
              f"plain path {mp:.3f} ms/step, {syncs} host syncs a step, on "
              f"{smi}")
    for k in ("proj_match", "line_triangulate"):
        r = report[k]
        print(f"  {k}: {r['ms']:.4f} ms, bound {r['bound_ms']:.6f} ms, "
              f"{launches[k]} launches on the path, on {smi}")
    hm = report["hamming_match"]
    print(f"  hamming_match line pair mode (256 x 256): {hm['pair_ms']:.4f} "
          f"ms beside its epipolar mode {hm['epipolar_ms']:.4f} ms, "
          f"{launches['hamming_match']} launches on the path, on {smi}")
    return launches


def boot_errors(out, B):
    """Rotation (deg) and t-direction errors of the second keyframe
    against the true relative motion of the two init frames."""
    m, kfs = out.map, out.tracker.new_kf_queue
    i0 = int(np.argmin(np.abs(B["timestamps"] - m.kf_timestamp[kfs[0]])))
    T0, T1 = np.eye(4), np.eye(4)
    T0[:3], T1[:3] = B["pose_cw"][i0], B["pose_cw"][out.init_frame]
    T10 = T1 @ np.linalg.inv(T0)
    P = m.kf_pose_cw[kfs[1]].astype(np.float64)
    tt = T10[:3, 3] / np.linalg.norm(T10[:3, 3])
    t = P[:, 3] / np.linalg.norm(P[:, 3])
    return rot_deg(P[:, :3], T10[:3, :3]), float(np.linalg.norm(t - tt))


def run_slice6(dev, smi, report):
    """Phase 10: the monocular bootstrap on the rendered frames, and the
    EuRoC-raw case through `undistort` and the two-view kernels, each a
    path with its own launch window.  Returns the launches of both."""
    print("[10] slice 6: bootstrap_step on the rendered frames; the "
          "EuRoC-raw case")
    step, B = bootstrap_step(device=dev)
    plain, Bp = bootstrap_step(device=dev, plain=True)
    reset_counts()
    with torch.no_grad():
        out = step(B)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches (bootstrap_step): {launches}")
    check(all(launches[k] > 0 for k in PATH_BOOT)
          and launches["undistort"] == 0,
          f"every kernel of bootstrap_step launched ({', '.join(PATH_BOOT)})"
          ", and not undistort (the renders have no distortion)")
    with torch.no_grad():
        op = plain(Bp)
    rot, tdir = boot_errors(out, B)
    prot, ptdir = boot_errors(op, Bp)
    got = {k: getattr(out, k) for k in ("init_frame", "attempts",
                                        "used_homography", "init_matches",
                                        "n_triangulated", "points", "lines")}
    print(f"  kernel path: {got}, rotation error {rot:.4f} deg, t-direction "
          f"error {tdir:.4f}, host syncs per attempt {out.host_syncs}; plain "
          f"path: frame {op.init_frame}, attempts {op.attempts}, homography "
          f"{op.used_homography}, matches {op.init_matches}, triangulated "
          f"{op.n_triangulated}, points {op.points}, lines {op.lines}, "
          f"rotation error {prot:.4f} deg, t-direction error {ptdir:.4f}; "
          f"reference {REF_BOOT}")
    ref = REF_BOOT
    check(all(np.isfinite(a).all() for a in (out.kf_pose_cw, out.kf_pose_wb,
                                              out.map.pt_xyz, out.map.ln_ep)),
          "the initial map's poses, points and lines finite")
    check(got["init_frame"] == ref["init_frame"]
          and got["attempts"] == ref["attempts"]
          and got["used_homography"] == ref["used_homography"],
          f"initialized on frame {got['init_frame']} after "
          f"{got['attempts']} attempts with the "
          f"{'homography' if got['used_homography'] else 'fundamental'}, as "
          "REF_BOOT")
    check(abs(got["init_matches"] - ref["init_matches"])
          <= 0.02 * ref["init_matches"]
          and all(abs(got[k] - ref[k]) <= 0.05 * ref[k]
                  for k in ("n_triangulated", "points"))
          and got["lines"] >= 1
          and abs(got["lines"] - ref["lines"]) <= max(3, ref["lines"] // 2),
          f"init matches {got['init_matches']} within 2%, triangulated "
          f"{got['n_triangulated']} and points {got['points']} within 5%, "
          f"lines {got['lines']} within max(3, half) of REF_BOOT (the card's "
          "own RANSAC draws)")
    check(rot <= 2 * ref["rot_err_deg"] and tdir <= 2 * ref["tdir_err"],
          f"second keyframe: rotation error {rot:.4f} deg <= "
          f"{2 * ref['rot_err_deg']:.4f}, t-direction error {tdir:.4f} <= "
          f"{2 * ref['tdir_err']:.4f} (2x the reference's largest)")
    c, *_ = twoview_inputs("euroc_raw", 1000, dev)
    cam = CAM.make_camera(CameraConfig())
    raw = [torch.from_numpy(c[k]).to(dev) for k in ("uv1", "uv2")]
    valid = torch.from_numpy(c["valid"]).to(dev)
    reset_counts()
    with torch.no_grad():
        u1, u2 = (CAM.undistort_pixels(cam, u) for u in raw)
        res = TV.reconstruct_two_views(
            K_EUROC, u1, u2, valid, generator=torch.Generator().manual_seed(0))
        success = bool(res.success)
    torch.cuda.synchronize()
    launches_raw = read_counts()
    print(f"  launches (EuRoC-raw case): {launches_raw}")
    check(all(launches_raw[k] > 0 for k in PATH_RAW),
          f"every kernel of the EuRoC-raw case launched "
          f"({', '.join(PATH_RAW)})")
    dR = res.R.double().cpu().numpy().T @ c["R"]
    ang = math.acos(max(-1.0, min(1.0, (np.trace(dR) - 1) / 2)))
    t_dir = c["t"] / np.linalg.norm(c["t"])
    t = res.t.double().cpu().numpy()
    et = float(np.linalg.norm(t / np.linalg.norm(t) - t_dir))
    check(success and not bool(res.used_homography) and ang < 0.01
          and et < 0.06,
          f"EuRoC-raw case (1000 raw cam0 matches, undistorted on the card): "
          f"success with F, rotation error {ang:.2e} rad < 0.01, "
          f"t-direction error {et:.2e} < 0.06 (tests/test_twoview.py's "
          "bounds)")

    def go(stp, BB):
        def f():
            with torch.no_grad():
                return stp(BB)
        return f
    t0 = time.perf_counter()
    go(step, B)()
    torch.cuda.synchronize()
    wk = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    go(plain, Bp)()
    torch.cuda.synchronize()
    wp = (time.perf_counter() - t0) * 1e3
    mk = cuda_ms(go(step, B), reps=3, warmup=1)
    print(f"  bootstrap_step: kernel path {mk / out.attempts:.3f} ms per "
          f"attempt ({mk:.3f} ms for {len(B['frames'][:out.init_frame + 1])} "
          f"frames, CUDA events; wall {wk:.1f} ms), plain path "
          f"{wp / max(op.attempts, 1):.3f} ms per attempt (wall {wp:.1f} "
          f"ms), on {smi}")
    for k in ("undistort", "twoview_hypotheses", "twoview_recover"):
        r = report[k]
        print(f"  {k}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms, {launches[k]} launches on "
              f"bootstrap_step, {launches_raw[k]} on the EuRoC-raw case, on "
              f"{smi}")
    return {k: launches[k] + launches_raw[k] for k in launches}


def gram_ops(okf, olm, n_lm, D):
    """Operations of the Gram fill-in: each landmark's 6m x 6m block of
    its m observing keyframes, D columns each."""
    key = torch.unique(okf.long() * n_lm + olm.long())
    m = torch.bincount(key % n_lm, minlength=n_lm).double()
    return float((6 * m * (6 * m + 1) / 2 * D * 2).sum())


def check_global_kernels(report):
    """schur_solve's global path (the reduced solve beyond one block)
    against its plain version, by `KN.global_solve_against_float64`'s
    rule: one Schur step from the perturbed start of the 64 KF inertial
    window with lines (S = 960) and of the 128 KF point-only window (S =
    768).  report["schur_solve_global"] gets the 64 KF row (the sequence's
    shape), report["schur_solve_global_128"] the 128 KF one."""
    for kind, n_kf, key in (("inertial", 64, GLOBAL[0]),
                            ("points", 128, GLOBAL[0] + "_128")):
        got = KN.global_solve_against_float64(kind, n_kf, "cuda")
        print(f"  schur_solve global path, {kind} {n_kf} KF (S = {got.S}), "
              "kernel / plain on the card from float64, kernel - plain: "
              + got.summary())
        check(not got.failures(),
              f"schur_solve global path, {kind} {n_kf} KF: the global path "
              "taken, the same bits on a second launch, each state within "
              "2x the plain float32 step's distance to float64 and no "
              "farther from the plain step than that (+1e-6), the pose "
              "within a quarter of the float64 step's largest entry "
              f"{got.failures()}")
        c = got.case
        w, A, prob, st, free = (c["work"], c["inputs"], c["prob"],
                                c["states"], c["free"])
        t, S = w.t, got.S
        lam = torch.tensor(c["lam"], device="cuda")
        n_pt, n_ln = t["pts"].shape[0], t["lns"].shape[0]
        ops = 300 * n_pt + 1500 * n_ln + 250 * w.n_obs \
            + gram_ops(A["obs_kf"], A["obs_pt"], n_pt, 3) \
            + w_cg(S) * 2 * S * S
        if w.body:
            ops += 1000 * t["lobs_kf"].shape[0] + gram_ops(
                A["lobs_kf"], A["lobs_ln"], n_ln, 6)
        report[key] = dict(
            **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"],
                          t["link"] if w.body else (), t["poses"],
                          t["kfx"] if w.body else (), t["pts"], t["lns"])
                   + nbytes(t["cposes"], t["ckfx"] if w.body else (),
                            t["cpts"], t["clns"], t["dx"]), ops),
            max_abs_err=got.gaps["pose"].kernel_plain,
            ms=cuda_ms(w.solve, reps=5, warmup=1),
            plain_ms=cuda_ms(lambda: prob.solve_step(st, lam, *free),
                             reps=2, warmup=1))


def run_slice7(dev, smi):
    """Phase 11: the whole keyframe step over the keyframe sequence
    (`keyframe_sequence`, production's sizes) in its own launch window,
    held to REF_SEQ.  Returns its launches."""
    print("[11] slice 7: keyframe_sequence, the keyframe step over "
          f"{REF_SEQ['keyframes']}+ keyframes at production's sizes")
    step, seq = keyframe_sequence(device=dev)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = step(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    m = out.map
    got = dict(init_kf=out.init_kf, init_scale=out.init_scale,
               keyframes=int(m.n_kf), points=int(m.n_pt), lines=int(m.n_ln),
               scale=out.scale, gravity_err_deg=out.gravity_err_deg,
               viba_solves=out.n_viba, viba_window=out.viba_window,
               ate_sim3=out.ate_sim3, ate_se3=out.ate_se3,
               refine=out.n_refine)
    print(f"  launches: {launches}")
    print(f"  kernel path: {got}; reference {REF_SEQ}")
    by_path = {}
    for s_ in out.steps:
        paths = [b[0] for b in s_.ba]
        key = "viba" if "viba" in paths else (paths[0] if paths else "none")
        by_path.setdefault(key, []).append(s_)
    for key, st_ in sorted(by_path.items()):
        iters = [sum(b[2]) for s_ in st_ for b in s_.ba if b[0] == key]
        print(f"  {key}: {len(st_)} steps, {np.mean([x.ms for x in st_]):.1f}"
              f" ms a step (wall; max {max(x.ms for x in st_):.1f}), "
              f"{np.mean([x.host_syncs for x in st_]):.1f} host syncs a step,"
              f" windows {sorted({b[1] for x in st_ for b in x.ba})}, LM "
              f"iterations a solve {np.mean(iters) if iters else 0:.1f}, on "
              f"{smi}")
    print(f"  the sequence: {len(out.steps)} steps in {wall:.1f} s, culled "
          f"{sum(len(x.culled) for x in out.steps)} keyframes, on {smi}")
    ref = REF_SEQ
    check(all(np.isfinite(a[m.kf_valid]).all() for a in (
        m.kf_pose_cw, m.kf_vel, m.kf_bias_g, m.kf_bias_a))
          and np.isfinite(m.pt_xyz[m.pt_valid]).all(),
          "keyframe states and map points finite")
    check(all(launches[k] > 0 for k in PATH_SEQ),
          "every kernel of the keyframe step launched "
          f"({', '.join(PATH_SEQ)})")
    check(out.viba_window > 22 and launches[GLOBAL[0]] > 0,
          f"a full-map pulse of {out.viba_window} > 22 keyframes took "
          f"schur_solve's global path ({launches[GLOBAL[0]]} launches)")
    check(got["init_kf"] == ref["init_kf"],
          f"the IMU initialized at keyframe {got['init_kf']}, as REF_SEQ")
    check(all(abs(got[k] - ref[k]) <= 0.05 * ref[k]
              for k in ("keyframes", "points", "lines")),
          f"keyframes {got['keyframes']}, points {got['points']}, lines "
          f"{got['lines']} within 5% of REF_SEQ")
    e_init = abs(got["init_scale"] - ref["inv_lam"])
    e_ref = abs(ref["init_scale"] - ref["inv_lam"])
    check(e_init <= 2 * e_ref
          and abs(got["scale"] - 1) <= 2 * abs(ref["scale"] - 1),
          f"init scale {got['init_scale']:.4f} against 1/lam "
          f"{ref['inv_lam']:.4f}: off {e_init:.4f} <= 2x the reference's "
          f"{e_ref:.4f}; final scale {got['scale']:.4f} within 2x the "
          "reference's distance to 1")
    check(got["gravity_err_deg"] <= 2 * ref["gravity_err_deg"],
          f"gravity error {got['gravity_err_deg']:.4f} deg <= 2x the "
          f"reference's {ref['gravity_err_deg']:.4f}")
    check(got["ate_sim3"] <= 2 * ref["ate_sim3"]
          and got["ate_se3"] <= 2 * ref["ate_se3"],
          f"ATE {got['ate_sim3'] * 1e3:.2f} mm (Sim3), "
          f"{got['ate_se3'] * 1e3:.2f} mm (SE3) <= 2x the reference's "
          f"{ref['ate_sim3'] * 1e3:.2f} / {ref['ate_se3'] * 1e3:.2f}")
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
    check_nbh_kernels(report)
    check_boot_kernels(imgs, step.orb, step.lines, report)
    check_global_kernels(report)

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
    launches_nbh = run_slice5(dev, smi, report)
    launches_boot = run_slice6(dev, smi, report)
    launches_seq = run_slice7(dev, smi)

    rows = []
    for name, (k, replaces) in [*KERNELS.items(),
                                (GLOBAL[0], (KN.SCHUR_SOLVE, GLOBAL[1]))]:
        rep = report[name]
        print(f"  {name}: {rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms,"
              f" bound {rep['bound_ms']:.6f} ms ({rep['bound_by']}: "
              f"{rep['bytes']} B, {rep['ops']} ops), on {smi}")
        rows.append(dict(name=name, route="cuda", source=k.source,
                         replaces=replaces,
                         launches=launches_pl[name] + launches_vi[name]
                         + launches_map[name] + launches_liba[name]
                         + launches_nbh[name] + launches_boot[name]
                         + launches_seq[name],
                         max_abs_err=rep["max_abs_err"], ms=rep["ms"],
                         plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                         bound_by=rep["bound_by"], library_ms=None))
    for key, what in ((GLOBAL[0], "64 KF inertial window with lines"),
                      (GLOBAL[0] + "_128", "128 KF point-only window")):
        rep = report[key]
        n_seq = launches_seq[GLOBAL[0]] if key == GLOBAL[0] else 0
        print(f"  schur_solve global path, {what}: {rep['ms']:.4f} ms, plain "
              f"{rep['plain_ms']:.4f} ms, bound {rep['bound_ms']:.6f} ms "
              f"({rep['bound_by']}: {rep['bytes']} B, {rep['ops']} ops), "
              f"{n_seq} launches on the sequence, on {smi}")
    for name in ("ba_linearize", "schur_solve"):
        for cfg, what in (("inertial", "inertial window (15-DoF)"),
                          ("points", "point-only window (make_local_ba)")):
            rep = report[name][cfg]
            print(f"  {name}, {what}: {rep['ms']:.4f} ms, plain "
                  f"{rep['plain_ms']:.4f} ms, bound {rep['bound_ms']:.6f} ms "
                  f"({rep['bound_by']}: {rep['bytes']} B, {rep['ops']} ops), "
                  f"on {smi}")
    hm, ss = report["hamming_match"], report["schur_solve"]
    print(f"  hamming_match epipolar mode (1024 x 1024): {hm['epipolar_ms']:.4f}"
          f" ms, plain {hm['epipolar_plain_ms']:.4f} ms; line pair mode (256"
          f" x 256): {hm['pair_ms']:.4f} ms, plain {hm['pair_plain_ms']:.4f} "
          f"ms, on {smi}")
    pm = report["proj_match"]
    print(f"  proj_match tracker mode (2048 x 1000, frustum gates): "
          f"{pm['tracker_ms']:.4f} ms, plain {pm['tracker_plain_ms']:.4f} ms, "
          f"on {smi}")
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
