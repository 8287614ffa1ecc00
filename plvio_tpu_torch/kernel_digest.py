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
    case = vi_case(dev, stereo=True)
    for hp in (True, False):
        out.append(f"vi_pose_lm stereo have_prior={hp} " + digest(
            KN.vi_pose_lm(*case[:-1], hp, ur=case[-1], bf=bf)))
    return out


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


def random_graph(n: int, n_extra: int, seed: int):
    """A chain of n Sim(3) keyframe states with a loop edge and n_extra
    random edges, each measured from the states with noise; the first
    keyframe fixed: the arguments of `make_pose_graph_optimizer`'s run
    (numpy)."""
    from plvio_tpu_torch.utils import lie
    r = np.random.default_rng(seed)
    st = np.zeros((n, 13), np.float32)
    for i in range(n):
        R = lie.so3_exp(torch.tensor(r.normal(0, .5, 3))).numpy()
        st[i] = np.concatenate([R.reshape(-1), r.normal(0, 1, 3),
                                [np.exp(r.normal(0, .05))]])
    pairs = [(i, i - 1) for i in range(1, n)] + [(n - 1, 0)] + [
        (int(a), int(b)) for a, b in r.integers(0, n, (n_extra, 2)) if a != b]
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
    free = np.ones(n, bool)
    free[0] = False
    return [st, free, np.array([p[0] for p in pairs], np.int32),
            np.array([p[1] for p in pairs], np.int32),
            np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32),
            np.array(ss, np.float32), np.ones(E, bool),
            r.uniform(0.3, 1, E).astype(np.float32)]


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


if __name__ == "__main__":
    sys.exit(main())
