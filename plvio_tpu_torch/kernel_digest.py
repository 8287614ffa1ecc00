"""SHA-256 digests of kernel outputs on fixed inputs, for showing that two
source trees give bit-identical results on one card.

    PYTHONPATH=<tree> python3 plvio_tpu_torch/kernel_digest.py

Run it once with PYTHONPATH at each tree (the script only uses entry
points both trees have) and compare the printed lines:

- `vi_pose_lm`: the VI pose optimizer on the case of
  tests/test_torch_cuda.py `test_vi_pose_lm_matches_plain` (1024 points,
  seed 7), with and without the prior: pose, velocity, biases, inliers
  and the next prior H15;
- `mapping_step`: the keyframe mapping step at the typical bucket from
  `inputs.perturb_window`'s start: KF poses, points, lines and both
  inlier masks;
- `hamming_match`: its window, line and epipolar gate modes (0-2) through
  `ops.matching.hamming_match` on fixed inputs (700 x 500, seed 4): idx
  and ok;
- `inertial_ba_step`: the inertial window BA at both buckets, true and
  perturbed start: the states, landmarks and inlier masks;
- `imu_init`: the IMU initialization and the scale refinement at 32 KF;
- `neighborhood_step`: the keyframe step's neighbourhood work on both maps
  of `inputs.build_keyframe_map`: the store's poses, points, lines and
  bindings after the step;
- `bow_transform`: the ORB (10 000 words) and LBD (1 000) pipelines on
  fixed random descriptors (1000 and 256 rows, seed 5, every 10th
  invalid): word ids and bag;
- `bow_score`: a 512-row bank of those bags' kind (seed 6): the scores;
- `pnp_ransac`, `mlpnp_refine`: both cases of `inputs.build_pnp_case`
  with 128 samples of `torch.Generator().manual_seed(0)`: pose, inliers,
  count and best hypothesis; the refinement from that pose;
- `sim3_ransac`, `sim3_reproj`, `pose_graph`, `hamming_match`'s matrix
  mode (slice 10, on a tree that has them): the Sim3 RANSAC on 256 matched
  points (seed 8, 60 outliers, 64 samples of manual_seed(0)), the
  reprojection refinement on 256 pairs a side with and without
  fix_scale, the essential graph on random chains with loop and extra
  edges at 17 keyframes (one block) and 200 (global path), Sim3 and
  4-DoF, and the distance matrix of 1024 x 700 descriptors;
- `pose_irls` mono (bf = 0; on every tree): the case of
  tests/test_torch_cuda.py `test_pose_irls_matches_plain` (1500 points,
  seed 5) without and with 64 lines;
- `stereo_match`, `pose_irls` and `vi_pose_lm` stereo (slice 11, on a
  tree that has them): `hamming_match`'s stereo point and line modes on
  synthetic rectified sets (seeds 5 and 6), the pose IRLS with a u_R
  column on two thirds of the 1500 points, the VI case with one on two
  thirds of its 1024 points (drawn after the mono case's numbers), with
  and without the prior;
- `pg_times` (not digests; a tree beside another): `pose_graph`'s ms
  on each path the tree's kernel offers, on the circle's size, the
  closer's chains, a revisited map and a randomly filled graph, beside
  the library's dense solves (`pose_graph_times`); `line_mode3 [seeds]`:
  SLAM mode 3's counts over the MH replay at those cfg.seeds
  (`line_mode_counts`);
- slice 12 (on a tree that has them; `python3 kernel_digest.py kb8` or
  `stereo_points` prints that mode's lines alone): `pose_lm` stereo on
  `stereo_lm_case` (1500 rows, a u_R column on two thirds, 20% outliers),
  `pose_lm` KB8 on `kb8_lm_case` (2048 rows of a wide-angle cloud, 20%
  outliers), `undistort` KB8 on a 40 x 25 grid of raw pixels,
  `proj_match` KB8 on `inputs.build_projection_case(kb8=True)` in the
  fuse's and the tracker's modes, and the KB8 window BA
  (`inputs.build_kb8_window`, 16 KF, perturbed start); and on every
  tree the pinhole calls of those kernels (`pinhole_digests`);
- slice 13 (on a tree that has it; `python3 kernel_digest.py slice13`
  prints these lines alone): `pose_lm`'s line families (modes 1-3) on
  `inputs.build_line_pose_case`, the line-only window BA (modes 1-3) on
  `inputs.build_line_window`, the inertial window with the KB8 lens at the
  half bucket with and without lines, the point+line window with the KB8
  lens and `undistort`'s KB8 mode with 256 segments (`slice13_digests`);
- slice 14 (`python3 kernel_digest.py ed` prints these lines alone):
  `line_detect` (on every tree: its bits must not move with the shared
  header `csrc/lines.cuh`) and, on a tree that has it, `line_detect_ed`,
  on a rendered view of the synthetic room with 200 lines (seed 0) and
  its line level, 192 / 64 segments: endpoints, angles, lengths,
  valid and the bf16 gradients (`ed_digests`).

- `schur_stages` (not digests; a tree beside another): `schur_solve`'s
  time a step by stage (torch.profiler's kernel names) and in all (CUDA
  events) on the three windows it runs on the main paths: point+line (S =
  96), 15-DoF (S = 240), point-only (`schur_stage_times`); `schur_stages
  global` the same on the global path's windows, the 64-KF inertial one
  (S = 960) and the 128-KF point-only one (S = 768).
- `global` (a tree with `KN.global_work`; a parent tree's kernels are
  read by copying its `csrc/schur_solve.cu` in): the candidate states of
  one Schur step on the global path's windows (23 and 64 KF inertial,
  128 KF point-only, 64 KF inertial with the KB8 lens).
- `orb_detect` (not digests): the ORB detector's time and launches a
  frame on a rendered 480 x 752 frame's eight levels (`orb_detect_times`).
- `slice19` (on every tree; in the default mode too): `vi_pose_lm` on
  `vi_case` with a NaN prior information, with the prior (every LM
  iteration runs, as on the VI frames from frame 2: the reference's
  carried H15 is NaN there), and `line_detect` on frame 1 of
  `inputs.build_inputs(2)` (480 x 752), its line level and the odd-size
  crop 237 x 411 of it with its line level (`slice19_digests`).
- `vi_stages` (not digests; a tree beside another): `vi_pose_lm`'s ms a
  call by CUDA events and its device time by stage from the kernel's
  `%globaltimer` stamps (`prof=`: point passes, dense terms, solve and
  retraction, final linearization, Jacobi and marginalization, set-up,
  re-gating) with the LM iterations run, on `vi_case` (mono and stereo,
  with and without the prior) and on the VI frame of `profile_frames`
  whose carried prior is NaN, where every iteration runs
  (`vi_stage_times`).
- `line_stages` (not digests): the cell line detector on both levels of a
  rendered 480 x 752 frame: ms a frame by CUDA events, the host's enqueue,
  the card's time by torch.profiler kernel name, kernels a frame, and the
  host's calls by name (`line_stage_times`).

- slice 20 (`ba_linearize` and `hamming_match` redesigned): `ba_stages`
  (not digests; a tree beside another) prints `ba_linearize`'s time on
  the window BAs of the paths (`ba_stage_windows`) by mode
  (`ba_stage_times`), `hamming_stages` each match mode's at the paths'
  shapes (`hamming_stage_times`); `slice20` (in no other mode) digests
  those matches, the worst mapping step and the 64-KF inertial and 128-KF
  point-only windows run whole (`slice20_digests`); `measure20` prints
  chip_smoke.py's measurement of both as JSON (`slice20_measure`).

- slice 15 (`python3 kernel_digest.py window` prints the single-device
  window BAs' lines alone, on every tree: `window_digests`, whose bits
  must not move with the mesh modes of ba_linearize and the sharded
  entries of schur_solve; `dist` adds, on a tree that has them, the
  sharded inertial window of `entry.dist_window` on 1, 2 and 4 shards and
  dist_ba, chain_ba and chain_liba on 2: `dist_digests`).

Needs one card; JAX is never imported.
"""
from __future__ import annotations

import hashlib
import math
import re
import sys

import numpy as np
import torch


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def vi_case(dev, stereo: bool = False):
    """The VI pose optimizer's arguments (K first, have_prior not); with
    stereo, also a u_R column (bf = 0.11 fx) on two thirds of the points,
    its numbers drawn after all of the mono case's."""
    from plvio_tpu_torch.config import ImuConfig
    from plvio_tpu_torch.entry import K_EUROC as K
    from plvio_tpu_torch.ops import imu as IMU
    from plvio_tpu_torch.utils import lie
    rng = np.random.default_rng(7)
    cap = 1024
    R0 = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3), dtype=torch.float32))
    p0 = torch.tensor(rng.normal(0, 1, 3), dtype=torch.float32)
    v0 = torch.tensor(rng.normal(0, 0.5, 3), dtype=torch.float32)
    prev = torch.cat([R0, p0[:, None]], 1)
    g = torch.tensor(rng.normal(0, 0.3, (10, 3)), dtype=torch.float32)
    a = torch.tensor(rng.normal(0, 0.5, (10, 3)), dtype=torch.float32) \
        + R0.T @ torch.tensor([0.0, 0.0, 9.81])
    f = IMU.imu_preint_plain(g, a, torch.full((10,), 0.005),
                             torch.ones(10, dtype=torch.bool),
                             IMU.make_calib(ImuConfig()), torch.zeros(3),
                             torch.zeros(3), prev, v0)
    R2, p2 = f.R2.double().numpy(), f.p2.double().numpy()
    Xc = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (cap, 3))
    X = torch.tensor(Xc @ R2.T + p2, dtype=torch.float32)
    uv = np.stack([K.fx * Xc[:, 0] / Xc[:, 2] + K.cx,
                   K.fy * Xc[:, 1] / Xc[:, 2] + K.cy], -1) \
        + rng.normal(0, 0.7, (cap, 2))
    uv[:150] += rng.uniform(-25, 25, (150, 2))
    Rp = R2 @ lie.so3_exp(torch.tensor(rng.normal(0, 0.01, 3))).numpy()
    pose0 = torch.tensor(np.c_[Rp, p2 + rng.normal(0, 0.02, 3)],
                         dtype=torch.float32)
    pre = f.pre
    pre_const = {k: getattr(pre, k) for k in ("dT", "dR", "dV", "dP", "JRg",
                                              "JVg", "JVa", "JPg", "JPa")}
    pre_const.update(bg0=pre.bias_gyro, ba0=pre.bias_acc)
    prior_const = dict(R0=R0, p0=p0, v0=v0, bg0=torch.zeros(3),
                       ba0=torch.zeros(3))
    rw = torch.tensor([1 / (1.9393e-5 ** 2 * 10)] * 3
                      + [1 / (3e-3 ** 2 * 10)] * 3)

    def d(x):
        if isinstance(x, dict):
            return {k: v.to(dev).contiguous() for k, v in x.items()}
        return x.to(dev).contiguous()

    return [K, d(torch.eye(3)), d(torch.zeros(3)), 9.81, d(pose0), d(f.v2),
            d(torch.full((3,), 1e-3)), d(torch.full((3,), 1e-2)),
            d(torch.tensor(uv, dtype=torch.float32)), d(X),
            d(torch.tensor(rng.random(cap) < 0.9)),
            d(torch.tensor(1 / 1.2 ** (2 * rng.integers(0, 3, cap)),
                           dtype=torch.float32)),
            d(prev), d(v0), d(pre_const), d(f.imu_info), d(rw),
            d(prior_const), d(torch.eye(15) * 100.0)] + (
                [d(torch.tensor(_ur(rng, uv, Xc[:, 2], K.fx * 0.11),
                                dtype=torch.float32))] if stereo else [])


def _ur(rng, uv, z, bf):
    """A u_R column: the left u less bf / z with 0.7 px noise, -1 (mono)
    on every third row."""
    ur = uv[:, 0] - bf / z + rng.normal(0, 0.7, len(z))
    ur[::3] = -1.0
    return ur


def pose_case(dev, n_lines: int, stereo: bool = False):
    """tests/test_torch_cuda.py `test_pose_irls_matches_plain`'s case (K,
    then the kernel's tensors); with stereo, also a u_R column."""
    from plvio_tpu_torch.entry import K_EUROC as K
    rng = np.random.default_rng(5)
    n = 1500
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n, 3))
    uv = np.stack([K.fx * X[:, 0] / X[:, 2] + K.cx,
                   K.fy * X[:, 1] / X[:, 2] + K.cy], -1)
    uv += rng.normal(0, 0.8, uv.shape)
    uv[: n // 5] += rng.uniform(-30, 30, (n // 5, 2))
    Xs = rng.uniform([-3, -2, 3], [3, 2, 9], (n_lines, 3))
    Xe = Xs + rng.normal(0, 0.8, (n_lines, 3))

    def pr(P):
        return np.c_[K.fx * P[:, 0] / P[:, 2] + K.cx,
                     K.fy * P[:, 1] / P[:, 2] + K.cy, np.ones(len(P))]

    ln = np.cross(pr(Xs), pr(Xe)).reshape(n_lines, 3)
    ln /= np.maximum(np.linalg.norm(ln[:, :2], axis=1, keepdims=True), 1e-9)
    pose0 = np.eye(3, 4)
    pose0[:, 3] = [0.02, -0.03, 0.05]

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(dev)

    args = [K, t(pose0), t(uv), t(X), t(rng.random(n) < 0.95, torch.bool),
            t(np.ones(n)), t(ln), t(Xs), t(Xe),
            t(np.ones(n_lines, bool), torch.bool), t(np.ones(n_lines))]
    if stereo:
        args.append(t(_ur(rng, uv, X[:, 2], K.fx * 0.11)))
    return args


def _t(dev, a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(dev)


def stereo_point_case(dev, seed: int = 5, n: int = 900):
    """`match_stereo`'s inputs (left uv, packed descriptors, octaves,
    valid; then the right view's) on a synthetic rectified set: a few
    candidates a row under the row and disparity gates, descriptors drawn
    from 60 bases (ties, the mutual check)."""
    from plvio_tpu_torch.ops import matching as M
    rng = np.random.default_rng(seed)
    uv_l = np.stack([rng.uniform(40, 700, n), rng.uniform(20, 460, n)], -1)
    perm = rng.permutation(n)
    uv_r = uv_l[perm] - np.stack([rng.uniform(-2.0, 60.0, n),
                                  rng.normal(0, 1.5, n)], -1)
    base = rng.integers(0, 2, (60, 256))
    d_l = base[rng.integers(0, 60, n)] ^ (rng.random((n, 256)) < 0.05)
    d_r = d_l[perm] ^ (rng.random((n, 256)) < 0.05)
    oct_l = rng.integers(0, 8, n)
    pk = lambda d: M.pack_bits_u32(_t(dev, d)).contiguous()  # noqa: E731
    return (_t(dev, uv_l), pk(d_l), _t(dev, oct_l, torch.int32),
            _t(dev, rng.random(n) < 0.95, torch.bool), _t(dev, uv_r),
            pk(d_r), _t(dev, oct_l[perm], torch.int32),
            _t(dev, rng.random(n) < 0.95, torch.bool))


def stereo_line_case(dev, seed: int = 6, L: int = 256):
    """`match_stereo_lines`' inputs on a synthetic rectified pair: L
    segments of 3D lines 2-8 m away seen by both eyes (0.11 m apart),
    seven eighths of the right ones shuffled, the same LBD bits on true
    pairs."""
    from plvio_tpu_torch.ops import matching as M
    rng = np.random.default_rng(seed)
    z0 = rng.uniform(2.0, 8.0, L)
    z1 = z0 + rng.uniform(-0.3, 0.3, L)
    x0, y0 = rng.uniform(-1.5, 1.5, L), rng.uniform(-1.0, 0.2, L)
    x1, y1 = x0 + rng.uniform(-0.3, 0.3, L), y0 + rng.uniform(-1.2, 1.2, L)

    def proj(X, Y, Z, tx=0.0):
        return np.stack([458.654 * (X - tx) / Z + 367.215,
                         457.296 * Y / Z + 248.375], -1)
    ep_l = np.concatenate([proj(x0, y0, z0), proj(x1, y1, z1)], 1)
    ep_r = np.concatenate([proj(x0, y0, z0, 0.11), proj(x1, y1, z1, 0.11)],
                          1)
    ep_r[L // 8:] = rng.permutation(ep_r[L // 8:])
    ang = lambda e: np.arctan2(e[:, 3] - e[:, 1],  # noqa: E731
                               e[:, 2] - e[:, 0]) % np.pi
    desc = M.pack_bits_u32(_t(dev, rng.integers(0, 2, (L, 256)))).contiguous()
    valid = _t(dev, np.ones(L, bool), torch.bool)
    return (_t(dev, ep_l), desc, _t(dev, ang(ep_l)), valid, _t(dev, ep_r),
            desc, _t(dev, ang(ep_r)), valid)


def stereo_digests(dev):
    """Slice 11's lines (see the module docstring)."""
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.ops import stereo as ST
    bf = 0.11 * 458.654
    out = ["stereo_match points " + digest(ST.match_stereo(
               *stereo_point_case(dev), bf)),
           "stereo_match lines " + digest(ST.match_stereo_lines(
               *stereo_line_case(dev), bf))]
    for nl in (0, 64):
        args = pose_case(dev, nl, stereo=True)
        out.append(f"pose_irls stereo n_lines={nl} " + digest(
            KN.pose_irls(*args[:-1], ur=args[-1], bf=bf)))
    return out + vi_stereo_digests(dev)


def vi_stereo_digests(dev):
    """`vi_pose_lm`'s stereo lines: the VI case with a u_R column on two
    thirds of its points, with and without the prior."""
    from plvio_tpu_torch.models import kernels as KN
    case = vi_case(dev, stereo=True)
    return [f"vi_pose_lm stereo have_prior={hp} " + digest(
        KN.vi_pose_lm(*case[:-1], hp, ur=case[-1], bf=0.11 * 458.654))
        for hp in (True, False)]


def stereo_lm_case(dev):
    """`make_pose_optimizer_stereo`'s arguments (K, bf, then pose0, uvr
    [1500,3], X, valid, is2) from `pose_case`'s stereo points: 20% of the
    rows outliers (up to 30 px), a u_R column (0.7 px noise) on two
    thirds."""
    K, pose0, uv, X, valid, is2, *_, ur = pose_case(dev, 0, stereo=True)
    return (K, K.fx * 0.11, pose0, torch.cat([uv, ur[:, None]], 1)
            .contiguous(), X, valid, is2)


def kb8_lm_case(dev, n: int = 2048, seed: int = 9):
    """`make_pose_optimizer_kb8`'s arguments (K8, then pose0, uv [n,2] raw
    pixels, X, valid, is2): tests/test_kb8_native.py's wide-angle cloud
    (up to 69 deg off-axis, 1.5-5 m) seen through the fisheye room's lens
    from a pose 3 deg / 0.2 m off the start, 0.3 px noise, 20% of the rows
    outliers (up to 30 px), 5% invalid, octaves 0-2."""
    from plvio_tpu_torch.inputs import kb8_camera
    from plvio_tpu_torch.io.synthetic import _kb8_project_cam_np
    from plvio_tpu_torch.utils import lie
    K8 = kb8_camera()
    rng = np.random.default_rng(seed)
    th, ph, d = (rng.uniform(0, 1.2, n), rng.uniform(0, 2 * np.pi, n),
                 rng.uniform(1.5, 5.0, n))
    X = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], -1) * d[:, None]
    R = lie.so3_exp(torch.tensor([0.03, -0.05, 0.02],
                                 dtype=torch.float64)).numpy()
    t = np.array([0.1, -0.1, 0.15])
    uv = _kb8_project_cam_np(X @ R.T + t, K8.fx, K8.fy, K8.cx, K8.cy,
                             (K8.k1, K8.k2, K8.k3, K8.k4))
    uv += rng.normal(0, 0.3, uv.shape)
    uv[: n // 5] += rng.uniform(-30, 30, (n // 5, 2))
    pose0 = np.eye(3, 4)
    return (K8, _t(dev, pose0), _t(dev, uv), _t(dev, X),
            _t(dev, rng.random(n) < 0.95, torch.bool),
            _t(dev, 1 / 1.2 ** (2 * rng.integers(0, 3, n))))


def pinhole_digests(dev):
    """The pinhole calls of the kernels that gained a KB8 mode in slice 12
    (`undistort` at EuRoC's coefficients on a 40 x 25 grid and 256
    segments, `proj_match` on `inputs.build_projection_case()` in the
    fuse's and the tracker's modes, `make_local_ba` on the typical
    window's points from the perturbed start), on entry points both
    trees have: their digests must not change."""
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.entry import K_EUROC, MAPPING_TYPICAL
    from plvio_tpu_torch.inputs import (build_mapping_inputs,
                                        build_projection_case,
                                        perturb_window)
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.ops import cameras as CAM
    out = {}
    cam = CAM.make_camera(CameraConfig())
    u, v = np.meshgrid(np.linspace(0, 751, 40), np.linspace(0, 479, 25))
    kp = _t(dev, np.stack([u.ravel(), v.ravel()], -1))
    ep = _t(dev, np.random.default_rng(6).uniform(
        [0, 0, 0, 0], [751, 479, 751, 479], (256, 4)))
    out["undistort pinhole"] = digest(CAM.undistort(cam, kp, ep))
    c = build_projection_case()
    a = [_t(dev, c[k].view(np.int32) if c[k].dtype == np.uint32 else c[k],
            torch.int32 if c[k].dtype in (np.uint32, np.int32)
            else torch.bool if c[k].dtype == bool else torch.float32)
         for k in ("pose", "pt_xyz", "pt_desc", "pt_valid", "feat_uv",
                   "feat_desc", "feat_octave", "feat_valid", "pt_normal",
                   "pt_min_dist", "pt_max_dist")]
    out["proj_match pinhole fuse"] = digest(KN.proj_match(
        K_EUROC, *a[:8], 2.0, 50.0))
    out["proj_match pinhole tracker"] = digest(KN.proj_match(
        K_EUROC, *a[:8], 6.0, 80.0, *a[8:]))
    A = build_mapping_inputs(**MAPPING_TYPICAL, device="cpu")
    P, X = perturb_window(A["kf_poses"].numpy(), A["pt_xyz"].numpy())
    A["kf_poses"], A["pt_xyz"] = torch.from_numpy(P), torch.from_numpy(X)
    with torch.no_grad():
        out["local_ba pinhole points"] = digest(KN.local_ba(
            K_EUROC, *[A[k].contiguous().to(dev) for k in (
                "kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf",
                "obs_pt", "obs_uv", "obs_valid", "obs_is2")]))
    return out


def slice12_digests(dev, which=("stereo_points", "kb8")):
    """Slice 12's lines (see the module docstring)."""
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.inputs import (KB8_INTRINSICS, KB8_K,
                                        build_kb8_window,
                                        build_projection_case, kb8_camera)
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.ops import cameras as CAM
    out = []
    if "stereo_points" in which:
        K, bf, *args = stereo_lm_case(dev)
        out.append("pose_lm stereo " + digest(KN.stereo_pose_lm(K, bf,
                                                                *args)))
    if "kb8" in which:
        K8, *args = kb8_lm_case(dev)
        out.append("pose_lm kb8 " + digest(KN.kb8_pose_lm(K8, *args)))
        cam = CAM.make_camera(CameraConfig(model="kb8", dist=KB8_K,
                                           **KB8_INTRINSICS))
        u, v = np.meshgrid(np.linspace(0, 751, 40), np.linspace(0, 479, 25))
        kp = _t(dev, np.stack([u.ravel(), v.ravel()], -1))
        out.append("undistort kb8 " + digest(CAM.undistort(cam, kp,
                                                           None)[:1]))
        c = build_projection_case(kb8=True)
        a = [_t(dev, c[k].view(np.int32) if c[k].dtype == np.uint32
                else c[k], torch.int32 if c[k].dtype in (np.uint32, np.int32)
                else torch.bool if c[k].dtype == bool else torch.float32)
             for k in ("pose", "pt_xyz", "pt_desc", "pt_valid", "feat_uv",
                       "feat_desc", "feat_octave", "feat_valid",
                       "pt_normal", "pt_min_dist", "pt_max_dist")]
        out.append("proj_match kb8 fuse " + digest(KN.proj_match(
            K8, *a[:8], 2.0, 50.0)))
        out.append("proj_match kb8 tracker " + digest(KN.proj_match(
            K8, *a[:8], 6.0, 80.0, *a[8:])))
        W = build_kb8_window(device=dev)
        with torch.no_grad():
            out.append("local_ba kb8 perturbed " + digest(KN.local_ba(
                kb8_camera(), *W.values())))
    return out


def slice13_digests(dev):
    """Slice 13's lines: `pose_lm`'s line families (modes 1-3) on
    `inputs.build_line_pose_case`, the line-only window BA (modes 1-3) on
    `inputs.build_line_window`, the inertial window with the KB8 lens
    (half bucket, with and without lines) on
    `inputs.build_inertial_window(kb8=True)`, the point+line window with
    the KB8 lens on `inputs.build_kb8_window(n_ln=256, n_lobs=512)` and
    `undistort`'s KB8 mode with 256 segments."""
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.entry import K_EUROC
    from plvio_tpu_torch.inputs import (KB8_INTRINSICS, KB8_K,
                                        build_inertial_window,
                                        build_kb8_window, build_line_pose_case,
                                        build_line_window, kb8_camera)
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.ops import cameras as CAM
    out = []
    case, _ = build_line_pose_case(device=dev)
    W = build_line_window(device=dev)
    K8 = kb8_camera()
    with torch.no_grad():
        for mode in (1, 2, 3):
            out.append(f"pose_lm line mode={mode} " + digest(
                KN.line_only_pose_lm(K_EUROC, mode, *case)))
            out.append(f"local_ba_lines_only mode={mode} " + digest(
                KN.local_ba_lines_only(K_EUROC, mode, *W.values())))
        for lines in (False, True):
            A = build_inertial_window(2048, 4096, 256 if lines else 0,
                                      512 if lines else 0, perturbed=True,
                                      device=dev, kb8=True)
            keys = KN.LIBA_KEYS if lines else KN.LIBA_KEYS[:18]
            o = KN.local_inertial_ba(K8, A["Rcb"].cpu(), A["tcb"].cpu(), 9.81,
                                     *[A[k] for k in keys])
            out.append(f"local_inertial_ba kb8 lines={lines} " + digest(
                [x for x in o if torch.is_tensor(x)]))
        out.append("local_ba_pl kb8 " + digest(KN.local_ba_pl(
            K8, *build_kb8_window(device=dev, n_ln=256,
                                  n_lobs=512).values())))
    cam = CAM.make_camera(CameraConfig(model="kb8", dist=KB8_K,
                                       **KB8_INTRINSICS))
    u, v = np.meshgrid(np.linspace(0, 751, 40), np.linspace(0, 479, 25))
    kp = _t(dev, np.stack([u.ravel(), v.ravel()], -1))
    ep = _t(dev, np.random.default_rng(6).uniform(
        [0, 0, 0, 0], [751, 479, 751, 479], (256, 4)))
    out.append("undistort kb8 segments " + digest(CAM.undistort(cam, kp,
                                                                ep)))
    return out


def ed_digests(dev):
    """Slice 14's lines: both line detectors on a rendered room view and
    its line level."""
    from plvio_tpu_torch.io import synthetic as syn
    from plvio_tpu_torch.ops import frontend as FE
    from plvio_tpu_torch.ops import lines as LN
    rng = np.random.default_rng(0)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=200)
    traj = syn.make_orbit_trajectory(duration=0.1, radius=0.6)
    img = _t(dev, syn.render_frame(scene, traj.R_wb[0], traj.p_wb[0],
                                   rng=rng))
    out = []
    for lv, (im, n) in enumerate(((img, 192), (FE.line_level(img), 64))):
        out.append(f"line_detect level={lv} " + digest(
            _flat(LN.line_detect(im, n))))
        if hasattr(LN, "line_detect_ed"):
            out.append(f"line_detect_ed level={lv} " + digest(
                _flat(LN.line_detect_ed(im, n))))
    return out


def _flat(out):
    """A detector's (ep, angle, length, valid, (gx, gy)) as one list, the
    bf16 gradients as their bits."""
    return [*out[:4], *(g.view(torch.int16) for g in out[4])]


def hamming_cases(dev):
    """(name, args, keywords) of hamming_match's modes 0-2 on fixed
    inputs: random two-bit descriptors (many ties), positions in a 120 px
    square, angles, and a fundamental matrix with per-column thresholds."""
    g = torch.Generator().manual_seed(4)
    n, m = 700, 500
    args = [(torch.randint(0, 4, (n, 8), generator=g) << 30).to(torch.int32),
            (torch.randint(0, 4, (m, 8), generator=g) << 30).to(torch.int32),
            torch.rand(n, generator=g) < 0.9, torch.rand(m, generator=g) < 0.9,
            torch.rand(n, 2, generator=g) * 120,
            torch.rand(m, 2, generator=g) * 120]
    args = [t.to(dev) for t in args]
    ang = [(torch.rand(k, generator=g) * 3.1415).to(dev) for k in (n, m)]
    F = torch.tensor([[0.0, -1e-3, 0.05], [1e-3, 0.0, -0.08],
                      [-0.05, 0.08, 1.0]], device=dev)
    th = (2.0 + torch.rand(m, generator=g) * 4).to(dev)
    return [("window", args, dict(radius=20.0, max_dist=80.0, ratio=0.9)),
            ("line", args, dict(radius=40.0, max_dist=110.0, ratio=0.95,
                                a_ang=ang[0], b_ang=ang[1], angle_tol=0.25)),
            ("epipolar", args, dict(radius=0.0, max_dist=60.0, ratio=0.8,
                                    epi_F=F, epi_th=th))]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] in (["kb8"], ["stereo_points"]):
        for line in slice12_digests(torch.device("cuda"), sys.argv[1:2]):
            print(line)
        return 0
    if sys.argv[1:2] == ["slice13"]:
        for line in slice13_digests(torch.device("cuda")):
            print(line)
        return 0
    if sys.argv[1:2] == ["ed"]:
        for line in ed_digests(torch.device("cuda")):
            print(line)
        return 0
    if sys.argv[1:2] == ["pg_times"]:
        for line in pose_graph_times(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["line_mode3"]:
        for line in line_mode_counts(torch.device("cuda"),
                                     [int(a) for a in sys.argv[2:]] or [4]):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["schur_stages"]:
        for line in schur_stage_times(torch.device("cuda"),
                                      glob=sys.argv[2:3] == ["global"]):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["global"]:
        for line in global_digests(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["slice19"]:
        for line in slice19_digests(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["vi_stages"]:
        for line in vi_stage_times(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["line_stages"]:
        for line in line_stage_times(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["ba_stages"]:
        for line in ba_stage_times(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["hamming_stages"]:
        for line in hamming_stage_times(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["measure20"]:
        import json
        print(json.dumps(slice20_measure(torch.device("cuda"))))
        return 0
    if sys.argv[1:2] == ["slice20"]:
        for line in slice20_digests(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] == ["orb_detect"]:
        for line in orb_detect_times(torch.device("cuda")):
            print(line, flush=True)
        return 0
    if sys.argv[1:2] in (["window"], ["dist"]):
        for line in window_digests(torch.device("cuda")):
            print(line)
        if sys.argv[1:2] == ["dist"]:
            for line in dist_digests(torch.device("cuda")):
                print(line)
        return 0
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    from plvio_tpu_torch.models import kernels as KN
    dev = torch.device("cuda")
    case = vi_case(dev)
    for hp in (True, False):
        print(f"vi_pose_lm have_prior={hp} "
              f"{digest(KN.vi_pose_lm(*case, hp))}")
    step, A = mapping_step(**MAPPING_TYPICAL, device=dev)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                  torch.from_numpy(X).to(dev))
    with torch.no_grad():
        o = step(A)
    print(f"mapping_step typical perturbed "
          f"{digest((o.kf_poses, o.pt_xyz, o.ln_ep6, o.inlier, o.inlier_l))}")
    from plvio_tpu_torch.ops import matching as M
    for name, args, kw in hamming_cases(dev):
        print(f"hamming_match {name} {digest(M.hamming_match(*args, **kw))}")
    from plvio_tpu_torch.entry import (LIBA_HALF, LIBA_WORST, imu_init,
                                       inertial_ba_step, neighborhood_step)
    for bucket, sz in (("worst", LIBA_WORST), ("half", LIBA_HALF)):
        for pert in (False, True):
            step, A = inertial_ba_step(**sz, perturbed=pert, device=dev)
            with torch.no_grad():
                o = step(A)
            print(f"inertial_ba_step {bucket} perturbed={pert} "
                  f"{digest([x for x in o if torch.is_tensor(x)])}")
    mod, B = imu_init(device=dev)
    print(f"imu_init {digest(mod(B))} refine {digest(mod.refine(B))}")
    for confirmed in (False, True):
        step, m = neighborhood_step(confirmed, device=dev)
        step(m)
        print(f"neighborhood_step confirmed_lines={confirmed} " + digest(
            [torch.from_numpy(getattr(m, k).copy()) for k in (
                "kf_pose_cw", "pt_xyz", "pt_valid", "kf_match_pt", "ln_ep",
                "ln_valid", "kf_match_ln")]))
    for line in bow_pnp_digests(dev) + loop_digests(dev):
        print(line)
    for nl in (0, 64):
        print(f"pose_irls mono n_lines={nl} "
              f"{digest(KN.pose_irls(*pose_case(dev, nl)))}")
    import importlib.util
    if importlib.util.find_spec("plvio_tpu_torch.ops.stereo") is not None:
        for line in stereo_digests(dev):
            print(line)
    for name, d in pinhole_digests(dev).items():
        print(f"{name} {d}")
    if hasattr(KN, "kb8_pose_lm"):
        for line in slice12_digests(dev):
            print(line)
    if hasattr(KN, "line_only_pose_lm"):
        for line in slice13_digests(dev):
            print(line)
    for line in ed_digests(dev):
        print(line)
    for line in slice19_digests(dev):
        print(line)
    return 0


def window_digests(dev):
    """The single-device window BAs' lines (the existing entries of
    ba_linearize, inertial_chain and schur_solve beside slice 15's mesh
    modes and sharded entries), on entry points both trees have: the
    mapping step (typical bucket, perturbed), the inertial window (both
    buckets and starts), the pinhole point BA and slice 13's window
    BAs."""
    from plvio_tpu_torch.entry import (LIBA_HALF, LIBA_WORST,
                                       MAPPING_TYPICAL, inertial_ba_step,
                                       mapping_step)
    from plvio_tpu_torch.inputs import perturb_window
    out = []
    step, A = mapping_step(**MAPPING_TYPICAL, device=dev)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                  torch.from_numpy(X).to(dev))
    with torch.no_grad():
        o = step(A)
    out.append("mapping_step typical perturbed " + digest(
        (o.kf_poses, o.pt_xyz, o.ln_ep6, o.inlier, o.inlier_l)))
    for bucket, sz in (("worst", LIBA_WORST), ("half", LIBA_HALF)):
        for pert in (False, True):
            step, A = inertial_ba_step(**sz, perturbed=pert, device=dev)
            with torch.no_grad():
                o = step(A)
            out.append(f"inertial_ba_step {bucket} perturbed={pert} "
                       + digest([x for x in o if torch.is_tensor(x)]))
    out.append("local_ba pinhole points "
               + pinhole_digests(dev)["local_ba pinhole points"])
    out += [line for line in slice13_digests(dev)
            if line.startswith("local_")]
    return out


def schur_windows(dev):
    """The three windows `schur_solve` runs on the main paths, each
    linearized once from its perturbed start (entry points both trees
    have): [(name, _BAWork)] for the point+line window (the mapping step's
    worst bucket, S = 96), the 15-DoF inertial window (its worst bucket, S
    = 240) and the point-only window (the mapping window's points)."""
    from plvio_tpu_torch.entry import (K_EUROC, LIBA_WORST, MAPPING_WORST,
                                       inertial_ba_step, mapping_step)
    from plvio_tpu_torch.inputs import perturb_window
    from plvio_tpu_torch.models import kernels as KN
    _, A = mapping_step(**MAPPING_WORST, device=dev)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                  torch.from_numpy(X).to(dev))
    pts = [A[k] for k in ("kf_poses", "kf_free", "pt_xyz", "pt_free",
                          "obs_kf", "obs_pt", "obs_uv", "obs_valid",
                          "obs_is2")]
    lns = [A[k] for k in ("ln_ep6", "ln_free", "lobs_kf", "lobs_ln",
                          "lobs_eq", "lobs_valid", "lobs_is2")]
    S = 6 * A["kf_poses"].shape[0]
    kw = dict(lam0=1e-4, early_tol=1e-2, cg_iters=min(max(S // 2, 16), 128))
    out = []
    for name, fam in (("point+line", lns), ("point-only", KN.no_lines(dev))):
        w = KN._BAWork(K_EUROC, *pts, *fam, **kw)
        w.linearize(KN.BA_MODE_INIT)
        w.linearize(KN.BA_MODE_LINEARIZE)
        out.append((name, w))
    _, B = inertial_ba_step(**LIBA_WORST, perturbed=True, device=dev)
    w = KN.inertial_work(K_EUROC, B["Rcb"], B["tcb"], 9.81,
                         *[B[k] for k in KN.LIBA_KEYS])
    w.chain(KN.CHAIN_COST_STATE)
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    w.chain(KN.CHAIN_LINEARIZE)
    out.insert(1, ("15-DoF", w))
    return out


def schur_stages(w, reps: int = 50, zero_cg: bool = True):
    """One Schur step of the window `w` (a `_BAWork` after its
    linearization) launched `reps` times, no LM decision between them, so
    every launch does the whole step: (ms a step by CUDA events, [(kernel,
    device ms a step, launches a step)] by torch.profiler's kernel names,
    and last, with `zero_cg`, the solve stage run with 0 CG iterations:
    its assembly of the reduced system alone)."""
    from torch.profiler import ProfilerActivity, profile
    from plvio_tpu_torch import cuda
    from plvio_tpu_torch.models import kernels as KN

    def step():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        step()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    def by_kernel(prof):
        out = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"(\w+_kernel)", e.key)
            out.append((m.group(1) if m else e.key[:40],
                        e.self_device_time_total / reps / 1e3,
                        e.count / reps))
        return out
    stages = by_kernel(prof)
    if not zero_cg:
        return ms, stages
    ints = w._keep[1]                     # [5]: the CG's iteration count
    iters, ints[5] = ints[5], 0
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
    finally:
        ints[5] = iters
    stages += [(k + " (0 CG iterations)", t, n) for k, t, n
               in by_kernel(prof) if k.startswith("solve")]
    return ms, stages


def global_windows(dev):
    """The global path's windows on the main paths, each linearized once
    from its perturbed start (`KN.global_work`): [(name, _BAWork)] for
    the 64-KF inertial window (S = 960) and the 128-KF point-only one (S =
    768)."""
    from plvio_tpu_torch.models import kernels as KN
    return [(f"{kind} {n} KF", KN.global_work(kind, n, dev)[-1])
            for kind, n in (("inertial", 64), ("points", 128))]


def global_digests(dev):
    """Digests of one Schur step's candidate states (poses; velocity and
    biases in a 15-DoF window) on the global path's windows."""
    from plvio_tpu_torch.models import kernels as KN
    out = []
    for kind, n, kb8 in (("inertial", 23, False), ("inertial", 64, False),
                         ("points", 128, False), ("inertial", 64, True)):
        w = KN.global_work(kind, n, dev, kb8=kb8)[-1]
        w.solve()
        got = [w.t["cposes"]] + ([w.t["ckfx"]] if w.body else [])
        out.append(f"schur_solve global {kind} {n} KF kb8={kb8} "
                   f"path={w.solve_path()} {digest(got)}")
    return out


def schur_stage_times(dev, reps: int = 50, glob: bool = False):
    """Lines of `schur_solve`'s time by stage (`schur_stages`) on the
    three windows of `schur_windows`, or with `glob` on the global path's
    two (`global_windows`, 20 steps a session)."""
    smi = _nvidia_smi()
    out = []
    for name, w in (global_windows(dev) if glob else schur_windows(dev)):
        ms, stages = schur_stages(w, 20 if glob else reps)
        busy = sum(st[1] for st in stages if "(0 CG" not in st[0])
        out.append(f"schur_solve {name} S={w.S}: step {ms:.4f} ms (events), "
                   f"device {busy:.4f} ms: " + ", ".join(
                       f"{k} {t:.4f} ms x{n:g}" for k, t, n in stages)
                   + f" on {smi}")
    return out


def orb_detect_times(dev, reps: int = 50):
    """The ORB detector on frame 1 of `inputs.build_inputs` (480 x 752,
    1000 features, eight levels), on the pyramid `build_pyramid` gives:
    `OrbExtractor.features` (the detector, then `orb_describe` on its
    keypoints) and `orb_describe` alone, each by CUDA events over `reps`
    calls (ms a call, the host's enqueue included where it is longer than
    the card's work) and by torch.profiler (the card's busy ms and the
    kernels launched a call); the detector's share is the difference."""
    from torch.profiler import ProfilerActivity, profile
    from plvio_tpu_torch.inputs import build_inputs
    from plvio_tpu_torch.ops import frontend as FE
    frames = build_inputs(2, device=dev)[0]
    orb, _ = FE.make_extractor(480, 752, 1000, device=dev)
    pyr = FE.build_pyramid(torch.from_numpy(frames[1]).to(dev), orb.specs)
    with torch.no_grad():
        f = orb.features(pyr)
    n_kp = f.uv.shape[0]
    scale = torch.tensor([sp.scale for sp in orb.specs], device=dev)
    xy = torch.round(f.uv / scale[f.octave.long(), None])   # level coords
    dargs = (pyr, xy, f.octave, orb.taps, orb.pattern, orb.wx, orb.wy)

    def events(fn):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def device(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        ev.sort(key=lambda e: -e.self_device_time_total)
        ms = [e.self_device_time_total / reps / 1e3 for e in ev]
        return (sum(ms), sum(e.count for e in ev) / reps,
                ", ".join(f"{e.key[:40]} {t:.4f}"
                          for e, t in zip(ev[:4], ms)))

    def features():
        with torch.no_grad():
            orb.features(pyr)

    def describe():
        FE.orb_describe(*dargs)
    smi = _nvidia_smi()
    out = []
    got = {}
    for name, fn in (("features", features), ("orb_describe", describe)):
        ms = events(fn)
        busy, n, top = device(fn)
        got[name] = (ms, busy, n)
        out.append(f"orb {name}: {ms:.4f} ms (events), device {busy:.4f} "
                   f"ms, {n:g} kernels a call (the longest, ms: {top}) on "
                   f"{smi}")
    (fm, fb, fn_), (dm, db, dn) = got["features"], got["orb_describe"]
    out.append(f"orb detector (features - orb_describe), {n_kp} keypoints: "
               f"{fm - dm:.4f} ms (events), device {fb - db:.4f} ms, "
               f"{fn_ - dn:g} kernels a frame on {smi}")
    return out


def vi_nan_case(dev):
    """`vi_case` with a NaN prior information (the reference's carried
    H15 from frame 2 on): its Cholesky is NaN, every step is rejected and
    every LM iteration runs."""
    case = vi_case(dev)
    case[-1] = torch.full((15, 15), float("nan"), device=dev)
    return case


def line_frames(dev):
    """[(name, image, n)] of `slice19_digests`' line cases: frame 1 of
    `inputs.build_inputs(2)`, its line level, the crop 237 x 411 and its
    line level."""
    from plvio_tpu_torch.inputs import build_inputs
    from plvio_tpu_torch.ops import frontend as FE
    img = torch.from_numpy(build_inputs(2, device=dev)[0][1]).to(dev)
    crop = img[:237, :411].contiguous()
    return [("480x752", img, 192), ("240x376", FE.line_level(img), 64),
            ("237x411", crop, 192), ("118x205", FE.line_level(crop), 64)]


def slice19_digests(dev):
    """PR 19's lines (see the module docstring)."""
    from plvio_tpu_torch.models import kernels as KN
    return [f"vi_pose_lm nan_prior have_prior=True "
            f"{digest(KN.vi_pose_lm(*vi_nan_case(dev), True))}"] \
        + line_digests(dev)


def line_digests(dev):
    """`line_detect` on `line_frames`' cases."""
    from plvio_tpu_torch.ops import lines as LN
    return [f"line_detect {name} n={n} "
            + digest(_flat(LN.line_detect(im, n)))
            for name, im, n in line_frames(dev)]


def _events_ms(fn, reps: int) -> float:
    """ms a call of fn by CUDA events over `reps` calls after 5."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def vi_frame_case(dev, frame: int = 4):
    """The VI optimizer's arguments (as `vi_case` gives them) on frame
    `frame` of `profile_frames`' VI pass (16 rendered frames, the
    carry from frame 1): from frame 2 the carried prior is NaN, so the
    early exit never fires and every LM iteration runs."""
    from plvio_tpu_torch import entry as E
    from plvio_tpu_torch.inputs import build_imu_windows, build_inputs
    from plvio_tpu_torch.state import from_numpy
    (frames, _, pt_xyz, pt_desc, pt_valid, ln_ep6, ln_desc, ln_valid,
     traj) = build_inputs(16, 2048, 128, 480, 752, n_features=1000,
                          device=dev)
    st = from_numpy(dict(pt_xyz=pt_xyz, pt_desc=pt_desc, pt_valid=pt_valid,
                         ln_ep6=ln_ep6, ln_desc=ln_desc, ln_valid=ln_valid),
                    dev)
    map_args = tuple(st[k] for k in ("pt_xyz", "pt_desc", "pt_valid",
                                     "ln_ep6", "ln_desc", "ln_valid"))
    gyro, acc, dts, carry = build_imu_windows(traj, 16)
    carry = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in carry)
    vi, _ = E.tracking_step_vi(480, 752, 1000, 2048, 256, device=dev)
    got = []
    run = vi.vi_opt
    vi.vi_opt = lambda *a: got.append(a) or run(*a)
    with torch.no_grad():
        for i in range(1, frame + 1):
            xs = tuple(torch.from_numpy(a[i - 1]).to(dev)
                       for a in (gyro, acc, dts))
            carry, _ = vi(carry, (torch.from_numpy(frames[i]).to(dev), *xs),
                          *map_args)
    a = got[-1]
    return [E.K_EUROC, torch.eye(3, device=dev), torch.zeros(3, device=dev),
            9.81, *a[:4], a[4][:, :2].contiguous(), *a[5:15]], a[15]


def vi_stage_times(dev, reps: int = 50):
    """Lines of `vi_pose_lm`'s time a call (events) and by stage (the
    kernel's stamps, mean over `reps` calls) on `vi_case` and on
    `vi_frame_case`."""
    from plvio_tpu_torch.models import kernels as KN
    smi = _nvidia_smi()
    bf = 0.11 * 458.654
    mono, stereo = vi_case(dev), vi_case(dev, stereo=True)
    frame, frame_hp = vi_frame_case(dev)
    cases = [(f"vi_case mono have_prior={hp}", mono, hp, {})
             for hp in (True, False)]
    cases += [(f"vi_case stereo have_prior={hp}", stereo[:-1], hp,
               dict(ur=stereo[-1], bf=bf)) for hp in (True, False)]
    cases.append((f"VI frame 4 (NaN prior) have_prior={frame_hp}", frame,
                   frame_hp, {}))
    out = []
    for name, args, hp, kw in cases:
        ms = _events_ms(lambda: KN.vi_pose_lm(*args, hp, **kw), reps)
        if not hasattr(KN, "VI_STAGES"):          # a tree without stamps
            out.append(f"vi_pose_lm {name}: {ms:.4f} ms (events) on {smi}")
            continue
        parts = getattr(KN, "VI_PARTS", ())
        n = len(KN.VI_STAGES)
        prof = torch.zeros(n + 1 + len(parts), dtype=torch.int64, device=dev)
        acc = torch.zeros_like(prof)
        for _ in range(reps):
            KN.vi_pose_lm(*args, hp, **kw, prof=prof)
            acc += prof
        a = (acc.double() / reps).tolist()
        total = sum(a[:n]) / 1e6
        out.append(f"vi_pose_lm {name}: {ms:.4f} ms (events), stamped "
                   f"{total:.4f} ms: " + ", ".join(
                       f"{k} {t / 1e6:.4f}" for k, t in zip(KN.VI_STAGES, a))
                   + f"; {a[n]:g} LM iterations" + ("; parts: " + ", ".join(
                       f"{k} {t / 1e6:.4f}" for k, t in zip(parts, a[n + 1:]))
                       if parts else "") + f" on {smi}")
    return out


def line_stage_times(dev, reps: int = 50):
    """The cell line detector on both levels of frame 1 of
    `inputs.build_inputs` (480 x 752, level 1 by `line_level`): ms a frame
    by CUDA events, the host's enqueue ms a frame (host clock over `reps`
    frames before a synchronize), the card's ms by kernel name and the
    kernels a frame (torch.profiler), and the host's calls with the most
    self time a frame (the CPU side of the same trace)."""
    from torch.profiler import ProfilerActivity, profile
    import time
    from plvio_tpu_torch.inputs import build_inputs
    from plvio_tpu_torch.ops import frontend as FE
    from plvio_tpu_torch.ops import lines as LN
    img = torch.from_numpy(build_inputs(2, device=dev)[0][1]).to(dev)
    img1 = FE.line_level(img)
    both = getattr(LN, "line_detect_levels", None)
    stages = ""
    if both is not None:
        def frame():
            both([img, img1], [192, 64])
        prof = torch.zeros(len(LN.LINE_STAGES) + 3, dtype=torch.int64,
                           device=dev)
        acc = torch.zeros_like(prof)
        for _ in range(reps):
            both([img, img1], [192, 64], prof=prof)
            acc += prof
        a = (acc.double() / reps).tolist()
        n = len(LN.LINE_STAGES)
        stages = ("  components' level-0 block by stage (ms, stamps): "
                  + ", ".join(f"{k} {t / 1e6:.4f}" for k, t in zip(
                      LN.LINE_STAGES, a)) + f"; level-1 block "
                  f"{a[n] / 1e6:.4f}; level 0: {a[n + 1]:g} labels in use, "
                  f"{a[n + 2]:g} good roots")
    else:
        def frame():
            LN.line_detect(img, 192)
            LN.line_detect(img1, 64)
    smi = _nvidia_smi()
    ms = _events_ms(frame, reps)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        frame()
    host = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            frame()
        torch.cuda.synchronize()
    cu = torch.autograd.DeviceType.CUDA
    dev_ev = sorted((e for e in prof.key_averages() if e.device_type == cu),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev_ev) / reps / 1e3
    n_k = sum(e.count for e in dev_ev) / reps
    host_ev = sorted((e for e in prof.key_averages() if e.device_type != cu
                      and e.self_cpu_time_total > 0),
                     key=lambda e: -e.self_cpu_time_total)
    return [f"line_detect both levels (n 192 + 64): {ms:.4f} ms a frame "
            f"(events), host enqueue {host:.4f} ms a frame, device "
            f"{busy:.4f} ms, {n_k:g} kernels a frame on {smi}",
            "  device by kernel (ms a frame, launches a frame): " + ", ".join(
                f"{e.key[:48]} {e.self_device_time_total / reps / 1e3:.4f} "
                f"x{e.count / reps:g}" for e in dev_ev),
            "  host by call (self ms a frame, calls a frame): " + ", ".join(
                f"{e.key[:40]} {e.self_cpu_time_total / reps / 1e3:.4f} "
                f"x{e.count / reps:g}" for e in host_ev[:14])] + (
                    [stages] if stages else [])


def _nvidia_smi() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def dist_digests(dev):
    """Slice 15's lines: the sharded inertial window (C = 16) on 1, 2 and
    4 shards of the card, dist_ba, chain_ba and chain_liba on 2."""
    from plvio_tpu_torch.entry import (chain_ba_step, chain_liba_step,
                                       dist_ba_step, dist_window)
    out = []
    with torch.no_grad():
        for D in (1, 2, 4):
            step, W, _ = dist_window(D, device=dev)
            o = step(W)
            out.append(f"dist_window D={D} " + digest(
                [torch.from_numpy(np.ascontiguousarray(x)) for x in o
                 if x is not None]))
        run, data, _ = dist_ba_step(2, device=dev)
        out.append("dist_ba D=2 " + digest(run(data)))
        run, data, _, _ = chain_ba_step(2, device=dev)
        out.append("chain_ba D=2 " + digest(run(data)))
        run, data, _, _ = chain_liba_step(2, device=dev)
        out.append("chain_liba D=2 " + digest(run(data)))
    return out


def bow_pnp_digests(dev):
    """The digests of slice 9's kernels (lines to print)."""
    from plvio_tpu_torch.inputs import PNP_CASES, build_pnp_case
    from plvio_tpu_torch.models import vocabulary as V
    from plvio_tpu_torch.ops import pnp as PNP
    from plvio_tpu_torch.ops.twoview import sample_indices
    from plvio_tpu_torch.entry import K_EUROC
    out = []
    rng = np.random.default_rng(5)
    for kind, n in (("orb", 1000), ("lbd", 256)):
        voc = V.default_vocabulary(kind)
        d = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
                             .view(np.int32)).to(dev)
        valid = (torch.arange(n) % 10 != 0).to(dev)
        out.append(f"bow_transform {kind} "
                   f"{digest(V.make_bow_pipeline(voc, n)(d, valid))}")
    rng = np.random.default_rng(6)
    W = 10000
    bank = np.zeros((512, W), np.float32)
    for r in range(512):
        np.add.at(bank[r], rng.integers(0, W, 1000), 1.0)
        bank[r] /= bank[r].sum()
    tb = torch.from_numpy(bank).to(dev)
    mask = torch.from_numpy(rng.random(512) > 0.2).to(dev)
    out.append(f"bow_score {digest([V.bow_score(tb[5].clone(), tb, mask)])}")
    for name in PNP_CASES:
        uv, X, valid, _ = build_pnp_case(name)
        s = sample_indices(torch.from_numpy(valid), 128, 6,
                           torch.Generator().manual_seed(0)).to(dev)
        uv, X, valid = (torch.from_numpy(a).to(dev) for a in (uv, X, valid))
        r = PNP.pnp_ransac(K_EUROC, uv, X, valid, s)
        out.append(f"pnp_ransac {name} {digest(r)}")
        out.append(f"mlpnp_refine {name} " + digest(PNP.mlpnp_refine(
            K_EUROC, uv, X, r.inliers, r.R, r.t)))
    return out


def _graph_states(n: int, r):
    from plvio_tpu_torch.utils import lie
    st = np.zeros((n, 13), np.float32)
    for i in range(n):
        R = lie.so3_exp(torch.tensor(r.normal(0, .5, 3))).numpy()
        st[i] = np.concatenate([R.reshape(-1), r.normal(0, 1, 3),
                                [np.exp(r.normal(0, .05))]])
    return st


def _measured_graph(st, pairs, r):
    """Edges (i, j) measured from the states st with noise, the first
    keyframe fixed: the arguments of `make_pose_graph_optimizer`'s run."""
    from plvio_tpu_torch.utils import lie
    Rs, ts, ss = [], [], []
    for i, j in pairs:
        Si = [torch.tensor(st[i, :9]).view(3, 3).double(),
              torch.tensor(st[i, 9:12]).double(),
              torch.tensor(float(st[i, 12])).double()]
        Sj = [torch.tensor(st[j, :9]).view(3, 3).double(),
              torch.tensor(st[j, 9:12]).double(),
              torch.tensor(float(st[j, 12])).double()]
        Rm, tm, sm = lie.sim3_mul(*Sj, *lie.sim3_inv(*Si))
        dR = lie.so3_exp(torch.tensor(r.normal(0, .03, 3))).double()
        Rs.append((dR @ Rm).numpy())
        ts.append(tm.numpy() + r.normal(0, .05, 3))
        ss.append(float(sm) * np.exp(r.normal(0, .02)))
    E = len(pairs)
    free = np.ones(len(st), bool)
    free[0] = False
    return [st, free, np.array([p[0] for p in pairs], np.int32),
            np.array([p[1] for p in pairs], np.int32),
            np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32),
            np.array(ss, np.float32), np.ones(E, bool),
            r.uniform(0.3, 1, E).astype(np.float32)]


def random_graph(n: int, n_extra: int, seed: int):
    """A chain of n Sim(3) keyframe states with a loop edge and n_extra
    random edges, each measured from the states with noise; the first
    keyframe fixed: the arguments of `make_pose_graph_optimizer`'s run
    (numpy)."""
    r = np.random.default_rng(seed)
    st = _graph_states(n, r)
    pairs = [(i, i - 1) for i in range(1, n)] + [(n - 1, 0)] + [
        (int(a), int(b)) for a, b in r.integers(0, n, (n_extra, 2)) if a != b]
    return _measured_graph(st, pairs, r)


def revisit_graph(n: int, m: int, seed: int):
    """A revisited map's essential graph: a chain of n Sim(3) keyframe
    states with covisibility edges one and two back, and its last m
    keyframes each joined to one of its first m (the camera passes the
    start again), measured as `random_graph`'s (numpy)."""
    r = np.random.default_rng(seed)
    st = _graph_states(n, r)
    pairs = [(i, i - 1) for i in range(1, n)] + [
        (i, i - 2) for i in range(2, n)] + [(n - m + k, k) for k in range(m)]
    return _measured_graph(st, pairs, r)


def closer_chain_graph(n_kf: int, dev):
    """The loop closer's essential graph over `inputs.build_big_chain(n_kf)`
    (its last keyframe revisiting its first), as `_essential_graph` hands
    it to the optimizer: (the run's first 9 arguments, n_active)."""
    from plvio_tpu_torch.config import CameraConfig, SystemConfig
    from plvio_tpu_torch.inputs import build_big_chain
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.models.loop_closing import LoopCloser
    from plvio_tpu_torch.models.mapstore import Atlas
    got, orig = {}, KN.pose_graph

    def rec(*a, **kw):
        got["a"] = a
        return orig(*a, **kw)
    KN.pose_graph = rec
    try:
        m, kfs, gt = build_big_chain(n_kf=n_kf)
        lc = LoopCloser(SystemConfig(camera=CameraConfig(dist=(0.0,) * 4),
                                     use_lines=False),
                        Atlas(maps=[m], active=0), None, m.n_feat, device=dev)
        pre = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                        m.kf_pose_cw[k, :, 3].copy()) for k in m.kf_chain()}
        kf, cand = int(kfs[-1]), int(kfs[0])
        R_w = gt[-1][0].T @ pre[kf][0]
        t_w = gt[-1][0].T @ (pre[kf][1] - gt[-1][1])
        lc._essential_graph(kf, cand, 1.0, R_w, t_w, pre, {kf})
    finally:
        KN.pose_graph = orig
    return list(got["a"][:9]), got["a"][11]


def pose_graph_times(dev):
    """Lines: `pose_graph`'s device ms (median, min, max of 10 launches
    timed alone with CUDA events) on graphs of every shape the closer can
    give, on each path the tree's kernel offers (`path=`), beside the
    library's 15 x `cholesky` + `cholesky_solve` at the same S (20 times).
    The host's pattern is inside the launch's time: the card waits for
    it."""
    import inspect
    from plvio_tpu_torch.models import kernels as KN

    def times(fn, reps):
        fn()
        torch.cuda.synchronize()
        got = []
        for _ in range(reps):
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            got.append(a.elapsed_time(b))
        got.sort()
        return f"{got[len(got) // 2]:.4f} ({got[0]:.4f}-{got[-1]:.4f})"
    paths = "path" in inspect.signature(KN.pose_graph).parameters
    out = []
    graphs = [("random 17+20", random_graph(17, 20, 17), None)]
    for n_kf in (600, 511):
        a, n = closer_chain_graph(n_kf, dev)
        graphs.append((f"closer chain {n_kf}", a, n))
    graphs += [("revisit 512/50", revisit_graph(512, 50, 5), None),
               ("random 200+400", random_graph(200, 400, 200), None)]
    for what, g, n in graphs:
        a = [x if torch.is_tensor(x) else torch.from_numpy(x).to(dev)
             for x in g]
        S = 7 * (a[0].shape[0] if n is None else n)
        line = f"pose_graph times {what}: S = {S}"
        if paths:
            nn = S // 7
            ok = (a[7] & (a[2] < nn) & (a[3] < nn)).cpu().numpy()
            pat = KN.pg_pattern(a[2].cpu().numpy()[ok],
                                a[3].cpu().numpy()[ok], a[1].cpu().numpy(),
                                nn)
            line += (f", {pat['nb']} blocks, {pat['n_updates']} updates, "
                     f"path {KN.pg_path(pat)}")
            for q in ((0, 1, 2) if KN.pg_resident(pat) else (1, 2)):
                line += f"; path {q} " + times(
                    lambda q=q: KN.pose_graph(*a, n_active=n, path=q), 10)
        else:
            line += "; the tree's path " + times(
                lambda: KN.pose_graph(*a, n_active=n), 10)
        H = torch.randn(S, S, device=dev)
        H = H @ H.T + S * torch.eye(S, device=dev)
        rhs = torch.randn(S, 1, device=dev)

        def library():
            for _ in range(15):
                torch.cholesky_solve(rhs, torch.linalg.cholesky(H))
        out.append(line + "; library " + times(library, 20) + " ms")
    return out


def line_mode_counts(dev, seeds):
    """Lines: SLAM mode 3 over the 8 s MH replay (as phase 17 of
    chip_smoke.py runs it) at each cfg.seed: frames tracked, keyframes,
    loops, SE3 ATE, and the `pose_graph` and `bow_score` launches."""
    from plvio_tpu_torch.entry import SystemRun, line_mode_config
    from plvio_tpu_torch.inputs import build_mh_replay
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.models import vocabulary as V
    S = build_mh_replay(8.0, 7)
    S["imu"] = [None] * len(S["frames"])
    out = []
    for seed in seeds:
        n_pg, n_bow = KN.POSE_GRAPH.launches, V.BOW_SCORE.launches
        with torch.no_grad():
            o = SystemRun(device=dev, cfg=line_mode_config(3, seed=seed))(S)
        out.append(f"SLAM mode 3 cfg.seed {seed}: tracked {o.n_tracked}, "
                   f"keyframes {o.keyframes}, loops {o.loops}, ATE "
                   f"{o.ate_se3:.4f} m, pose_graph "
                   f"{KN.POSE_GRAPH.launches - n_pg}, bow_score "
                   f"{V.BOW_SCORE.launches - n_bow}")
    return out


def loop_digests(dev):
    """The digests of slice 10's kernels (lines to print; none on a tree
    without them)."""
    from plvio_tpu_torch.models import kernels as KN
    from plvio_tpu_torch.ops import matching as M
    from plvio_tpu_torch.ops import pnp as PNP
    from plvio_tpu_torch.solver.residuals import PinholeK
    from plvio_tpu_torch.utils import lie
    if not hasattr(PNP, "sim3_ransac"):
        return []
    out = []
    rng = np.random.default_rng(8)
    n = 256
    X1 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    R = lie.so3_exp(torch.tensor([0.1, 0.2, -0.3])).numpy()
    X2 = (1.2 * X1 @ R.T + [0.3, 0.1, -0.2]).astype(np.float32)
    X2[:60] += rng.normal(0, 0.5, (60, 3)).astype(np.float32)
    valid = np.arange(n) < 200
    smp = torch.multinomial(torch.from_numpy(valid).double().expand(64, -1),
                            3, generator=torch.Generator().manual_seed(0))
    t = [torch.from_numpy(a).to(dev) for a in (X1, X2, valid)]
    out.append("sim3_ransac " + digest(PNP.sim3_ransac(*t, smp.to(dev),
                                                       0.08)))
    K = PinholeK(400., 400., 376., 240.)
    Xa = rng.uniform(-2, 2, (n, 3))
    Xa[:, 2] = rng.uniform(3, 7, n)
    Xb = 1.1 * Xa @ R.T + [0.5, -0.3, 0.2]

    def proj(X):
        return np.stack([400 * X[:, 0] / X[:, 2] + 376,
                         400 * X[:, 1] / X[:, 2] + 240], -1)
    S13 = np.concatenate([R.reshape(-1), [0.6, -0.4, 0.25], [1.0]])
    args = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
            for a, dt in ((S13, np.float32), (Xa, np.float32),
                          (proj(Xb) + rng.normal(0, .3, (n, 2)), np.float32),
                          (np.ones(n), bool), (np.ones(n), np.float32),
                          (Xb, np.float32),
                          (proj(Xa) + rng.normal(0, .3, (n, 2)), np.float32),
                          (np.ones(n), bool), (np.ones(n), np.float32),
                          (np.eye(3, 4), np.float32),
                          (np.eye(3, 4), np.float32))]
    for fix in (False, True):
        out.append(f"sim3_reproj fix_scale={fix} "
                   + digest(KN.sim3_reproj(K, *args, fix_scale=fix)))
    for n_kf, extra in ((17, 20), (200, 400)):
        g = [torch.from_numpy(a).to(dev) for a in random_graph(n_kf, extra,
                                                               n_kf)]
        for four in (False, True):
            out.append(f"pose_graph n={n_kf} four_dof={four} "
                       + digest([KN.pose_graph(*g, four_dof=four)]))
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (1024, 8)).astype(
        np.int32)).to(dev)
    b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (700, 8)).astype(
        np.int32)).to(dev)
    out.append("hamming_match matrix " + digest([M.hamming_dist(a, b)]))
    return out


# --------------------------------------------------------------------------
# ba_linearize and hamming_match by stage (`ba_stages`, `hamming_stages`)
# and their digests at the paths' shapes (`slice20`)
# --------------------------------------------------------------------------

def _by_kernel(fn, reps: int):
    """torch.profiler over `reps` calls of fn: ([(kernel or memset name,
    device ms a call, launches a call)], busy ms a call, stream
    operations a call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel|match_rows|mutual_check|stereo_epilogue"
                      r"|\w+_launch|Memset)", e.key)
        out.append((m.group(1) if m else e.key[:40],
                    e.self_device_time_total / reps / 1e3, e.count / reps))
    return (out, sum(t for _, t, _ in out), sum(n for _, _, n in out))


def _host_ms(fn, reps: int) -> float:
    """The host's ms a call of fn: its enqueue, host clock over `reps`
    calls before one synchronize."""
    import time
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def ba_stage_windows(dev):
    """The window BAs `ba_linearize` runs on the main paths, each at its
    perturbed start, linearized and given one Schur step's candidate:
    [(name, _BAWork)] for the mapping step's point+line window at the
    typical and the worst bucket (`entry.MAPPING_TYPICAL`,
    `MAPPING_WORST`: 16 KF, 4096 + 512 / 8192 + 1024 observations), the
    inertial window at its half and worst bucket (`LIBA_HALF`,
    `LIBA_WORST`) and the 64-KF inertial window of the full-map BA
    (`KN.global_work`)."""
    from plvio_tpu_torch.entry import (K_EUROC, LIBA_HALF, LIBA_WORST,
                                       MAPPING_TYPICAL, MAPPING_WORST,
                                       inertial_ba_step, mapping_step)
    from plvio_tpu_torch.inputs import perturb_window
    from plvio_tpu_torch.models import kernels as KN
    out = []
    for name, sz in (("mapping typical", MAPPING_TYPICAL),
                     ("mapping worst", MAPPING_WORST)):
        _, A = mapping_step(**sz, device=dev)
        P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                              A["pt_xyz"].cpu().numpy())
        A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                      torch.from_numpy(X).to(dev))
        S = 6 * A["kf_poses"].shape[0]
        w = KN._BAWork(K_EUROC, *[A[k] for k in KN.BA_KEYS], lam0=1e-4,
                       early_tol=1e-2, cg_iters=min(max(S // 2, 16), 128))
        w.linearize(KN.BA_MODE_INIT)
        w.linearize(KN.BA_MODE_LINEARIZE)
        out.append((name, w))
    for name, sz in (("inertial half", LIBA_HALF),
                     ("inertial worst", LIBA_WORST)):
        _, B = inertial_ba_step(**sz, perturbed=True, device=dev)
        w = KN.inertial_work(K_EUROC, B["Rcb"], B["tcb"], 9.81,
                             *[B[k] for k in KN.LIBA_KEYS])
        w.chain(KN.CHAIN_COST_STATE)
        w.linearize(KN.BA_MODE_INIT)
        w.linearize(KN.BA_MODE_LINEARIZE)
        w.chain(KN.CHAIN_LINEARIZE)
        out.append((name, w))
    out.append(("inertial 64 KF", KN.global_work("inertial", 64, dev)[-1]))
    for _, w in out:
        w.solve()
    torch.cuda.synchronize()
    return out


def ba_stages(dev, reps: int = 50, segments: bool = True):
    """`ba_linearize`'s time on `ba_stage_windows`: [dict(window, sizes,
    modes={mode: dict(ms, host_ms, device_ms, launches, kernels)},
    segments)], for the linearization, the LM decision and the round's
    re-gating: ms a call by CUDA events, the host's enqueue ms a call, the
    card's ms and launches a call (torch.profiler) and by kernel name;
    with `segments`, on the kernels before slice 20 (whose segment sums
    are a launch of their own), the segment sums of one family alone,
    keyframe, point or line (the other families' counts set to 0 in the
    launch's table); on a tree with the stamps, each mode's ms by stage
    (`_ba_stamps`).  The decision's early exit is turned off (early_tol
    -1), so every call does its whole work."""
    from plvio_tpu_torch.models import kernels as KN
    out = []
    for name, w in ba_stage_windows(dev):
        w._keep[2][7] = -1.0
        t = w.t
        row = dict(window=name, n_kf=t["poses"].shape[0], n_obs=w.n_obs,
                   n_lobs=t["chi2"].numel() - w.n_obs,
                   n_pt=t["hpt"].shape[0], n_ln=t["hln"].shape[0], modes={},
                   segments={})
        for mname, mode in (("linearize", KN.BA_MODE_LINEARIZE),
                            ("decide", KN.BA_MODE_DECIDE),
                            ("regate", KN.BA_MODE_REGATE)):
            def fn(mode=mode):
                w.linearize(mode)
            kern, busy, n_k = _by_kernel(fn, reps)
            row["modes"][mname] = dict(ms=_events_ms(fn, reps),
                                       host_ms=_host_ms(fn, reps),
                                       device_ms=busy, launches=n_k,
                                       kernels=kern,
                                       stamps=_ba_stamps(w, fn, mname, reps))
        # the segment families apart: the kernels before slice 20 only,
        # whose segment sums are a launch of their own
        split = segments and any(
            k == "reduce_kernel"
            for k, _, _ in row["modes"]["linearize"]["kernels"])
        ints = w._keep[1]
        counts = [ints[0], ints[1], ints[3]]       # n_kf, n_pt, n_ln
        for seg, keep in (("keyframe", 0), ("point", 1),
                          ("line", 2))[:3 if split else 0]:
            for j, i in enumerate((0, 1, 3)):
                ints[i] = counts[j] if j == keep else 0
            try:
                row["segments"][seg] = _by_kernel(
                    lambda: w.linearize(KN.BA_MODE_LINEARIZE), reps)[0]
            finally:
                for j, i in enumerate((0, 1, 3)):
                    ints[i] = counts[j]
        out.append(row)
    return out


def _ba_stamps(w, fn, mname: str, reps: int):
    """ba_linearize's stage ms a call from the kernel's %globaltimer stamps
    (`KN.BA_PROF_STAMPS`, a tree that has them), mean over `reps` calls,
    or {}: the linearization's observations, grid barrier, keyframe and
    landmark sums; the other modes' chains of observations, the last
    block's cost sums and decision, and its copy."""
    from plvio_tpu_torch.models import kernels as KN
    if not hasattr(KN, "BA_PROF_STAMPS"):
        return {}
    st = torch.zeros(len(KN.BA_PROF_STAMPS), dtype=torch.int64,
                     device=w.device)
    acc = torch.zeros(len(KN.BA_PROF_STAMPS), dtype=torch.float64,
                      device=w.device)
    w.prof(st)
    try:
        for _ in range(reps):
            KN.ba_prof_reset(st)
            fn()
            acc += st.double() - st[0].double()
    finally:
        w.prof(None)
    t = dict(zip(KN.BA_PROF_STAMPS, (acc / reps / 1e6).tolist()))
    if mname == "linearize":
        return {"observations": t["observations"],
                "barrier": t["barrier"] - t["observations"],
                "keyframes": t["keyframes"] - t["barrier"],
                "landmarks": t["landmarks"] - t["barrier"],
                "total": max(t["keyframes"], t["landmarks"])}
    return {"chains": t["observations"], "ticket": t["ticket"]
            - t["observations"], "decision": t["decision"] - t["ticket"],
            "copy": t["copy"] - t["decision"], "total": t["copy"]}


def ba_stage_times(dev, reps: int = 50):
    """Lines of `ba_stages`."""
    smi = _nvidia_smi()
    out = []
    for r in ba_stages(dev, reps):
        head = (f"ba_linearize {r['window']} ({r['n_kf']} KF, {r['n_obs']} "
                f"+ {r['n_lobs']} obs, {r['n_pt']} points, {r['n_ln']} "
                "lines)")
        for mname, d in r["modes"].items():
            out.append(f"{head} {mname}: {d['ms']:.4f} ms (events), host "
                       f"enqueue {d['host_ms']:.4f} ms, device "
                       f"{d['device_ms']:.4f} ms in {d['launches']:g} "
                       "launches: " + ", ".join(
                           f"{k} {t:.4f} x{n:g}" for k, t, n in d["kernels"])
                       + ("; stamped ms: " + ", ".join(
                           f"{k} {t:.4f}" for k, t in d["stamps"].items())
                          if d.get("stamps") else "")
                       + f" on {smi}")
        if r["segments"]:
            out.append(f"{head} linearize by segment family: " + "; ".join(
                f"{seg} " + ", ".join(f"{k} {t:.4f}" for k, t, _ in kern
                                      if not k.startswith("obs"))
                for seg, kern in r["segments"].items()))
    return out


def _pack(bits: np.ndarray) -> np.ndarray:
    """[n, 256] bools -> [n, 8] uint32, bit b of word w = bits[32 w + b]."""
    w = bits.reshape(len(bits), 8, 32).astype(np.uint64)
    return (w << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def hamming_stage_cases(dev):
    """(name, entry, args, keywords) of `hamming_match` and `stereo_match`
    at the shapes of the paths: the window mode at 20 px and the tracker's
    ungated reference-keyframe match (2048 map points, 1000 features, 600
    of them noisy copies of map points 3 px from their prediction), the
    line mode on 256 map lines x 256 segments, the epipolar mode on 1024 x
    1024 features of a sideways step, the line pair mode on 256 x 256
    segments, the stereo points (1000) and lines (256)."""
    from plvio_tpu_torch.ops import matching as M
    from plvio_tpu_torch.ops import stereo as ST
    rng = np.random.default_rng(11)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    def desc(a):
        return t(a.view(np.int32), torch.int32)
    n, m, k = 2048, 1000, 600
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    src = rng.choice(n, k, replace=False)
    b[:k] = a[src] ^ _pack(rng.random((k, 256)) < 0.06)
    a_xy = rng.uniform(0, 1, (n, 2)) * (752, 480)
    b_xy = rng.uniform(0, 1, (m, 2)) * (752, 480)
    b_xy[:k] = a_xy[src] + rng.normal(0, 3.0, (k, 2))
    row_ok = rng.random(n) < 0.6
    row_ok[src] = True
    pts = [desc(a), desc(b), t(row_ok, torch.bool), t(np.ones(m, bool),
                                                       torch.bool)]
    cases = [("window 20 px 2048 x 1000", M.hamming_match,
              pts + [t(a_xy), t(b_xy)],
              dict(radius=20.0, max_dist=80.0, ratio=0.9)),
             ("ungated 2048 x 1000", M.hamming_match,
              pts + [torch.zeros(n, 2, device=dev),
                     torch.zeros(m, 2, device=dev)],
              dict(radius=math.inf, max_dist=60.0, ratio=0.75))]
    L = 256
    la = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint32)
    lsrc = rng.permutation(L)
    lb = la[lsrc] ^ _pack(rng.random((L, 256)) < 0.08)
    mid = rng.uniform(0, 1, (L, 2)) * (752, 480)
    ang = rng.uniform(0, np.pi, L)
    mid_b = mid[lsrc] + rng.normal(0, 4.0, (L, 2))
    ang_b = (ang[lsrc] + rng.normal(0, 0.05, L)) % np.pi
    lok = t(rng.random(L) < 0.9, torch.bool)
    cases.append(("line 256 x 256", M.hamming_match,
                  [desc(la), desc(lb), lok, lok, t(mid), t(mid_b)],
                  dict(radius=40.0, max_dist=110.0, ratio=0.95,
                       a_ang=t(ang), b_ang=t(ang_b), angle_tol=0.25)))
    half = rng.uniform(25, 100, L)
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * half[:, None]
    ep = np.concatenate([mid - d, mid + d], 1)
    d_b = np.stack([np.cos(ang_b), np.sin(ang_b)], -1) * half[lsrc, None]
    ep_b = np.concatenate([mid_b - d_b, mid_b + d_b], 1)
    cases.append(("line pair 256 x 256", M.hamming_match,
                  [desc(la), desc(lb), lok, lok, t(ep), t(ep_b)],
                  dict(radius=80.0, max_dist=110.0, ratio=0.95,
                       a_ang=t(ang), b_ang=t(ang_b), angle_tol=0.25,
                       pair=True)))
    E = 1024
    ea = rng.integers(0, 2 ** 32, (E, 8), dtype=np.uint32)
    esrc = rng.permutation(E)
    eb = ea[esrc] ^ _pack(rng.random((E, 256)) < 0.06)
    uv1 = rng.uniform(0, 1, (E, 2)) * (752, 480)
    uv2 = uv1[esrc] + np.stack([rng.uniform(-40, -5, E),
                                rng.normal(0, 1.0, E)], -1)
    Kx = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    tx = np.array([[0, 0, 0], [0, 0, 0.1], [0, -0.1, 0]])    # [t]_x, t = x
    Kinv = np.linalg.inv(Kx)
    F = Kinv.T @ tx @ Kinv
    th = np.sqrt(3.84) * 1.2 ** rng.integers(0, 8, E)
    eok = t(rng.random(E) < 0.95, torch.bool)
    cases.append(("epipolar 1024 x 1024", M.hamming_match,
                  [desc(ea), desc(eb), eok, eok, t(uv1), t(uv2)],
                  dict(radius=0.0, max_dist=60.0, ratio=0.8,
                       epi_F=t(F / np.abs(F).max()), epi_th=t(th))))
    bf = 0.11 * 458.654
    cases.append(("stereo points 1000 x 1000", ST.match_stereo,
                  list(stereo_point_case(dev, n=1000)) + [bf], {}))
    cases.append(("stereo lines 256 x 256", ST.match_stereo_lines,
                  list(stereo_line_case(dev)) + [bf], {}))
    return cases


def hamming_stages(dev, reps: int = 50):
    """`hamming_stage_cases` timed: [dict(case, ms, host_ms, device_ms,
    ops, kernels, matches)]: ms a call by CUDA events, the wrapper's host
    ms a call (its checks, allocations and launch), the card's ms and
    stream operations a call and by operation (memset, the match kernels,
    the mutual check or stereo epilogue), torch.profiler."""
    out = []
    for name, fn, args, kw in hamming_stage_cases(dev):
        def call(fn=fn, args=args, kw=kw):
            fn(*args, **kw)
        kern, busy, n_k = _by_kernel(call, reps)
        res = fn(*args, **kw)
        out.append(dict(case=name, ms=_events_ms(call, reps),
                        host_ms=_host_ms(call, reps), device_ms=busy,
                        ops=n_k, kernels=kern,
                        matches=int(res[1].sum()) if len(res) == 2
                        else int(res[2].sum())))
    return out


def hamming_stage_times(dev, reps: int = 50):
    """Lines of `hamming_stages`."""
    smi = _nvidia_smi()
    return [f"hamming_match {r['case']}: {r['ms']:.4f} ms (events), host "
            f"{r['host_ms']:.4f} ms, device {r['device_ms']:.4f} ms in "
            f"{r['ops']:g} stream operations: " + ", ".join(
                f"{k} {t:.4f} x{n:g}" for k, t, n in r["kernels"])
            + f"; {r['matches']} matches on {smi}"
            for r in hamming_stages(dev, reps)]


def device_ops(fn, names) -> int:
    """The device operations of one call of fn whose names contain one of
    `names` (torch.profiler, after a warm call; in a process of its own:
    the profiler of a long process has been seen to drop records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(k in e.name for k in names))


# the device operations of ba_linearize (the kernels of either design)
# and of a match (its kernels, memsets and the elementwise operations its
# wrapper ran before slice 20)
BA_KERNELS = ("linearize_kernel", "cost_pass_kernel", "obs_kernel",
              "reduce_kernel", "cost_kernel", "accept_kernel",
              "regate_kernel")
MATCH_OPS = ("match_kernel", "match_rows", "mutual_check", "stereo_epilogue",
             "Memset", "elementwise")


def slice20_measure(dev, reps: int = 50) -> dict:
    """Both kernels measured for chip_smoke.py in a process of its own
    (`python3 kernel_digest.py measure20` prints it as one JSON line):
    ba_linearize's launches an LM iteration of the worst mapping window
    and each match's stream operations a call (`device_ops`), and
    `ba_stages` / `hamming_stages`' ms by events, on the card and of the
    host."""
    windows = ba_stage_windows(dev)
    cases = hamming_stage_cases(dev)
    out = {"lm_launches": device_ops(windows[1][1].step, BA_KERNELS),
           "match_ops": {name: device_ops(lambda: fn(*a, **kw), MATCH_OPS)
                         for name, fn, a, kw in cases}}
    del windows, cases
    out["ba"] = {r["window"]: {m: {k: d[k] for k in ("ms", "device_ms",
                                                     "host_ms")}
                               for m, d in r["modes"].items()}
                 for r in ba_stages(dev, reps, segments=False)}
    out["hamming"] = {r["case"]: {k: r[k] for k in ("ms", "device_ms",
                                                    "host_ms")}
                      for r in hamming_stages(dev, reps)}
    return out


def slice20_digests(dev):
    """Digests of `hamming_stage_cases` (idx and ok; the stereo modes'
    outputs), the mapping step at the worst bucket from its perturbed
    start, and the full-map windows of the global path run whole (the
    64-KF inertial window with lines, the 128-KF point-only one)."""
    from plvio_tpu_torch.entry import MAPPING_WORST, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    from plvio_tpu_torch.models import kernels as KN
    out = [f"hamming_match {name} {digest(fn(*args, **kw))}"
           for name, fn, args, kw in hamming_stage_cases(dev)]
    step, A = mapping_step(**MAPPING_WORST, device=dev)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                  torch.from_numpy(X).to(dev))
    with torch.no_grad():
        o = step(A)
    out.append("mapping_step worst perturbed " + digest(
        (o.kf_poses, o.pt_xyz, o.ln_ep6, o.inlier, o.inlier_l)))
    A, args, _, _, _ = KN.global_window("inertial", 64, dev)
    o = KN.local_inertial_ba(KN._window_camera(False), A["Rcb"].to(dev),
                             A["tcb"].to(dev), 9.81, *args)
    out.append("local_inertial_ba 64 KF " + digest(
        [x for x in o if torch.is_tensor(x)]))
    A, args, _, _, _ = KN.global_window("points", 128, dev)
    o = KN.local_ba(KN._window_camera(False), *args[:9])
    out.append("local_ba points 128 KF " + digest(list(o)))
    return out


if __name__ == "__main__":
    sys.exit(main())
