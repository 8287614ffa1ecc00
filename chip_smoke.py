#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two tracked frames at EuRoC geometry (480x752, 1000 ORB
features, 256 line features, 2048 map points, 128 map lines) through their
user entry points, and fails (nonzero exit, no result line) unless every
phase passes:

1. the card is there (prints `nvidia-smi` name and power limit);
2. the eight CUDA kernels build from `plvio_tpu_torch/csrc` (nvcc, sm_90a,
   one nvcc per source, all started together);
3. each kernel agrees with its plain PyTorch version on the card at the
   paths' shapes;
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
   limit.

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
from plvio_tpu_torch.entry import (K_EUROC, point_projection_match,
                                   project_points, tracking_step_pl,
                                   tracking_step_vi)
from plvio_tpu_torch.inputs import build_imu_windows, build_inputs
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import frontend as FE
from plvio_tpu_torch.ops import imu as IMU
from plvio_tpu_torch.ops import lines as LN
from plvio_tpu_torch.ops import matching as M
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
}
PATH_PL = ("orb_fast_grid", "orb_describe", "hamming_match", "pose_irls",
           "line_detect", "line_refine_lbd")
PATH_VI = ("orb_fast_grid", "orb_describe", "hamming_match", "line_detect",
           "line_refine_lbd", "imu_preint", "vi_pose_lm")
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
    same, total, err = [], [], 0.0
    for im in pyr:
        bk, ak = FE.orb_fast_grid(im, 20.0, 7.0)
        bp, ap = FE.orb_fast_grid_plain(im, 20.0, 7.0)
        eq = (ak == ap) & (bk == bp)
        same.append(int(eq.sum()))
        total.append(eq.numel())
        err = max(err, float((bk - bp).abs().max()))
    check(same[0] == total[0],
          f"orb_fast_grid level 0 winners identical ({same[0]}/{total[0]})")
    frac = sum(same[1:]) / sum(total[1:])
    check(frac >= 0.995, f"orb_fast_grid levels 1-7 winners {frac:.4%} "
          "identical (>= 99.5%)")
    report["orb_fast_grid"] = dict(
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
    report["orb_describe"] = dict(
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
    report["hamming_match"] = dict(
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
    report["pose_irls"] = dict(
        max_abs_err=float((Pk - Pp).abs().max()),
        ms=cuda_ms(lambda: KN.pose_irls(*pargs)),
        plain_ms=cuda_ms(lambda: KN.pose_irls_plain(*pargs)))


def check_line_kernels(img, report):
    """line_detect and line_refine_lbd on frame 1, both pyramid levels."""
    pairs = torch.from_numpy(LN._band_pair_pattern()).to(img.device)
    img1 = img.reshape(H // 2, 2, W // 2, 2).mean((1, 3)).contiguous()
    levels = ((img, N_LINE - N_LINE // 4), (img1, N_LINE // 4))
    err, det_err = 0.0, 0.0
    dets = []
    for lv, (im, n) in enumerate(levels):
        dk = LN.line_detect(im, n)
        dp = LN.detect_lines(im, n)
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
    report["line_detect"] = dict(
        max_abs_err=det_err,
        ms=cuda_ms(lambda: [LN.line_detect(im, n) for im, n in levels]),
        plain_ms=cuda_ms(lambda: [LN.detect_lines(im, n)
                                  for im, n in levels], reps=5))
    dp0, dp1 = dets
    f0 = LN.refine_lbd_plain(dp0[4][0], dp0[4][1], dp0[0], dp0[3], pairs)

    def refine(fn):
        fn(dp0[4][0], dp0[4][1], dp0[0], dp0[3], pairs)
        fn(dp1[4][0], dp1[4][1], dp1[0], dp1[3], pairs, f0)
    report["line_refine_lbd"] = dict(
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
    report["imu_preint"] = dict(
        max_abs_err=errs[worst], ms=cuda_ms(lambda: IMU.imu_preint(*args)),
        plain_ms=cuda_ms(lambda: IMU.imu_preint_plain(*args)))

    case = vi_frame1_case(step, img, carry, xs, st)
    worst_err = 0.0
    for hp in (True, False):
        ok_ = KN.vi_pose_lm(*case, hp)
        op_ = KN.vi_pose_opt_plain(*case, hp)
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
    report["vi_pose_lm"] = dict(
        max_abs_err=worst_err, ms=cuda_ms(lambda: KN.vi_pose_lm(*case, True)),
        plain_ms=cuda_ms(lambda: KN.vi_pose_opt_plain(*case, True), reps=3,
                         warmup=1))


def reset_counts():
    for k, _ in KERNELS.values():
        k.launches = 0


def read_counts():
    return {name: k.launches for name, (k, _) in KERNELS.items()}


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
    rows = []
    for name, (k, replaces) in KERNELS.items():
        rep = report[name]
        print(f"  {name}: {rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms,"
              f" on {smi}")
        rows.append(dict(name=name, route="cuda", source=k.source,
                         replaces=replaces,
                         launches=launches_pl[name] + launches_vi[name],
                         max_abs_err=rep["max_abs_err"], ms=rep["ms"],
                         plain_ms=rep["plain_ms"]))
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
