"""Entry points of the port (counterpart of __graft_entry__.py:19-125).

tracking_step(...)    -> (step, example_args): the point-only tracked frame
tracking_step_pl(...) -> (step, example_args): the flagship point+line
                         tracked frame — ORB extraction (8 levels), the
                         2-level line front end, the point and line
                         projection matches and the fused point+line pose
                         IRLS
tracking_step_vi(...) -> (step, init_carry): the production
                         mono-inertial point+line frame (port of
                         __graft_entry__._tracking_step_vi_fn :128)
mapping_step(...)     -> (step, inputs): the keyframe mapping step (port
                         of bench.build_mapping_step :201-309) —
                         epipolar matching of the new KF against its
                         neighbour, DLT triangulation and the point+line
                         windowed local BA
inertial_ba_step(...) -> (step, inputs): the inertial back end's window
                         solve (`LocalMapper._liba_window`,
                         models/local_mapping.py:1349) — the sliding-window
                         visual-inertial BA with points and lines
imu_init(...)         -> (module, inputs): IMU initialization
                         (`maybe_initialize_imu`, :1012) and, as
                         `module.refine`, the scale / gravity refinement
                         (`refine_scale`, :948)
neighborhood_step(...) -> (step, map store): the keyframe step's
                         neighbourhood work on the port's LocalMapper
                         (`create_new_lines` :541, `search_in_neighbors`
                         :329, `local_ba` :697) on a 14-keyframe map
                         from `inputs.build_keyframe_map`
bootstrap_step(...)   -> (step, inputs): the monocular bootstrap, from
                         rendered frames through the frame prelude
                         (`models/system.py:160-169`) and the port's
                         `Tracker` to the initial two-keyframe map
                         (`_initialize_mono`, models/tracking.py:384)
keyframe_sequence(...) -> (step, sequence): the whole keyframe step
                         (`LocalMapper.process_keyframe`, :169-238) over
                         the keyframes of `inputs.build_keyframe_sequence`
                         (~8.7 s of the room orbit from a two-keyframe
                         map), the tracker's keyframe insertion stood in
                         by `inputs.insert_keyframe`
tracked_sequence(...) -> (step, frames): the mono-inertial main path
                         over the rendered frames of
                         scripts/run_synthetic_vi.py, each through the
                         frame prelude
                         (`models/system.py:160-169`), the `Tracker`
                         (`process_frame`, models/tracking.py:236-366) and
                         the keyframe glue (`_drain_keyframes`,
                         models/system.py:325-388) to a gravity-aligned
                         metric map
mh_loop(...)          -> (run, circuit): the whole system with its default
                         configuration (loop closing on) over the closed
                         circuit of scripts/run_mh_loop.py
                         (`inputs.build_mh_loop`)
loop_closure(case)    -> (step, inputs): `models/loop_closing.LoopCloser`
                         at production caps over a hand-made map of the
                         reference's loop-closing tests ("circle": the
                         drifted circle closes at its revisit; "merge":
                         a young map merges into the old one)
mh_replay(...)        -> (run, replay): the whole system end to end,
                         `models/system.System.track_monocular`
                         (models/system.py:153) over the 8 s MH replay of
                         tests/test_mh_replay_regression.py
                         (`inputs.build_mh_replay`), then `global_refine`,
                         with the keyframe database and relocalization
stereo_replay(...)    -> (run, replay): the whole system over the 8 s
                         replay's rectified pairs,
                         `System.track_stereo` (models/system.py:180)
                         with IMU_STEREO and lines at EuRoC geometry
                         (baseline 0.11 m), loop closing on, then
                         `global_refine` (`inputs.build_stereo_replay`)
stereo_room(...)      -> (run, orbit): `System.track_stereo` over the room
                         orbit of tests/test_stereo.py (STEREO with lines,
                         or without: the point-only stereo LM; imu=True:
                         IMU_STEREO over tests/test_stereo_inertial.py's
                         orbit)
rgbd_room(...)        -> (run, orbit): `System.track_rgbd` (:230) over the
                         RGB-D room orbit of tests/test_stereo.py (bf > 0:
                         the depths as u_R rows of the stereo LM)
kb8_room(...)         -> (run, frames): `System.track_monocular` with the
                         KB8 fisheye over the room of
                         tests/test_kb8_native.py (`kb8_config`)
entry(device)         -> tracking_step_pl at EuRoC geometry on `device`

Every entry point runs on the card unless the caller passes
device="cpu" (the CPU runs the plain PyTorch versions of the kernels).

`step` is an nn.Module; `step(*example_args)` returns (pose [3,4],
n_inliers); the VI step is `step(carry, (img, gyro, acc, dts), *map_args)
-> (carry, (n_inl, n_line_matched))`.  Descriptors are packed [*,8] int32
(the uint32 bits of the reference, see state.from_numpy).  `plain=True`
runs the plain PyTorch versions of the kernels on any device, for
comparing the two paths.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .config import ImuConfig
from .cuda import resolve_device
from .models.kernels import (LIBA_KEYS, fast_pose_opt, fast_pose_opt_pl,
                             line_proj_match_core, make_epipolar_matcher,
                             make_inertial_init, make_local_ba_pl,
                             make_local_inertial_ba, make_scale_refine,
                             make_triangulator, make_vi_pose_optimizer)
from .ops import imu as IMU
from .ops import matching as M
from .ops.frontend import OrbExtractor, make_level_specs
from .ops.lines import LineExtractor
from .solver.residuals import PinholeK

K_EUROC = PinholeK(fx=458.654, fy=457.296, cx=367.215, cy=248.375)


def project_points(K: PinholeK, pose, pt_xyz, pt_valid, height: int,
                   width: int):
    """Local map into the frame: (uv_proj [P,2], proj_ok [P]) with the
    reference's depth guard and in-image test."""
    pc = pt_xyz @ pose[:, :3].T + pose[:, 3]
    z = pc[:, 2]
    zc = torch.clamp_min(z, 1e-6)
    uv_proj = torch.stack([K.fx * pc[:, 0] / zc + K.cx,
                           K.fy * pc[:, 1] / zc + K.cy], -1)
    proj_ok = pt_valid & (z > 0.05) \
        & (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < width) \
        & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < height)
    return uv_proj, proj_ok


def point_projection_match(K: PinholeK, feats, pose_pred, pt_xyz, pt_desc,
                           pt_valid, height: int, width: int,
                           plain: bool = False):
    """Project the local map, gate by a 20 px window, match (max 80, ratio
    0.9, mutual).  Returns (uv_m [P,2], ok [P], inv_sigma2 [P])."""
    uv_proj, proj_ok = project_points(K, pose_pred, pt_xyz, pt_valid, height,
                                      width)
    match = M.hamming_match_plain if plain else M.hamming_match
    idx, ok = match(pt_desc, feats.desc, proj_ok, feats.valid, uv_proj,
                    feats.uv, radius=20.0, max_dist=80.0, ratio=0.9)
    idx = idx.to(torch.int64)
    is2 = 1.0 / torch.pow(1.2, 2.0 * feats.octave[idx].to(torch.float32))
    return feats.uv[idx], ok, is2


class TrackingStep(nn.Module):
    """Point-only tracked frame (__graft_entry__._tracking_step_fn)."""

    def __init__(self, height: int, width: int, n_features: int,
                 plain: bool = False, K: PinholeK = K_EUROC):
        super().__init__()
        self.height, self.width, self.K, self.plain = height, width, K, plain
        self.orb = OrbExtractor(make_level_specs(height, width, n_features),
                                plain=plain)

    def forward(self, img, pose_pred, pt_xyz, pt_desc, pt_valid):
        pose_pred = pose_pred.contiguous()
        feats = self.orb(img)
        uv_m, ok, is2 = point_projection_match(
            self.K, feats, pose_pred, pt_xyz, pt_desc, pt_valid,
            self.height, self.width, self.plain)
        pose, _, n_inl = fast_pose_opt(self.K, pose_pred, uv_m, pt_xyz, ok,
                                       is2, plain=self.plain)
        return pose, n_inl


class TrackingStepPL(nn.Module):
    """The flagship point+line tracked frame
    (__graft_entry__._tracking_step_pl_fn)."""

    def __init__(self, height: int, width: int, n_features: int,
                 n_line_feat: int, plain: bool = False, K: PinholeK = K_EUROC):
        super().__init__()
        self.height, self.width, self.K, self.plain = height, width, K, plain
        self.orb = OrbExtractor(make_level_specs(height, width, n_features),
                                plain=plain)
        self.lines = LineExtractor(n_line_feat, levels=2, plain=plain)

    def forward(self, img, pose_pred, pt_xyz, pt_desc, pt_valid, ln_ep6,
                ln_desc, ln_valid):
        pose_pred = pose_pred.contiguous()
        feats, level1 = self.orb.with_line_level(img)
        lf = self.lines(img, level1)
        uv_m, ok, is2 = point_projection_match(
            self.K, feats, pose_pred, pt_xyz, pt_desc, pt_valid,
            self.height, self.width, self.plain)
        _, ln_matched, l_eq = line_proj_match_core(
            self.K, pose_pred, ln_ep6, ln_desc, ln_valid, lf.ep, lf.desc,
            lf.angle, lf.valid, lf.lineq, plain=self.plain)
        is2_l = torch.ones(ln_ep6.shape[0], dtype=torch.float32,
                           device=img.device)
        pose, _, _, n_inl = fast_pose_opt_pl(
            self.K, pose_pred, uv_m, pt_xyz, ok, is2, l_eq.contiguous(),
            ln_ep6[:, :3].contiguous(), ln_ep6[:, 3:].contiguous(),
            ln_matched, is2_l, plain=self.plain)
        return pose, n_inl


class TrackingStepVI(nn.Module):
    """The production mono-inertial point+line frame
    (__graft_entry__._tracking_step_vi_fn): ORB and 2-level line
    extraction, preintegration of the frame's IMU window at the carried
    biases and the state prediction, the point projection match at the
    predicted pose, the 15-DoF VI pose optimization with the carried
    marginalization prior (Tbc = identity), and the line projection match
    at the optimized pose.

    forward(carry, (img [H,W], gyro [n_imu,3], acc [n_imu,3], dts
    [n_imu]), pt_xyz, pt_desc, pt_valid, ln_ep6, ln_desc, ln_valid) ->
    (carry, (n_inl, n_line_matched)); carry = (pose_wb [3,4], vel [3], bg
    [3], ba [3], H15 [15,15])."""

    def __init__(self, height: int, width: int, n_features: int,
                 cap_pts: int, n_line_feat: int, n_imu: int = 10,
                 gravity: float = 9.81, plain: bool = False,
                 K: PinholeK = K_EUROC):
        super().__init__()
        self.height, self.width, self.K, self.plain = height, width, K, plain
        self.orb = OrbExtractor(make_level_specs(height, width, n_features),
                                plain=plain)
        self.lines = LineExtractor(n_line_feat, levels=2, plain=plain)
        cfg = ImuConfig(gravity=gravity)     # prediction and residual agree
        self.calib = IMU.make_calib(cfg)
        self.vi_opt = make_vi_pose_optimizer(
            K, cap_pts, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), gravity, plain=plain)
        self.register_buffer("rw_info", torch.from_numpy(np.concatenate([
            np.full(3, 1.0 / (cfg.gyro_walk ** 2 * n_imu)),
            np.full(3, 1.0 / (cfg.acc_walk ** 2 * n_imu))]).astype(
                np.float32)))
        self.register_buffer("imu_mask", torch.ones(n_imu, dtype=torch.bool))

    def forward(self, carry, frame_xs, pt_xyz, pt_desc, pt_valid, ln_ep6,
                ln_desc, ln_valid):
        pose_wb, vel, bg, ba, H15 = carry
        img, gyro, acc, dts = frame_xs
        pose_wb = pose_wb.contiguous()
        feats, level1 = self.orb.with_line_level(img)
        lf = self.lines(img, level1)
        preint = IMU.imu_preint_plain if self.plain else IMU.imu_preint
        imu = preint(gyro, acc, dts, self.imu_mask, self.calib, bg, ba,
                     pose_wb, vel)
        pre = imu.pre
        pred_wb = torch.cat([imu.R2, imu.p2[:, None]], 1)
        pose_cw = torch.cat([imu.R2.T, (-imu.R2.T @ imu.p2)[:, None]], 1)
        uv_m, ok, is2 = point_projection_match(
            self.K, feats, pose_cw, pt_xyz, pt_desc, pt_valid, self.height,
            self.width, self.plain)
        uvr = torch.cat([uv_m, -torch.ones_like(uv_m[:, :1])], 1)
        pre_const = {"dT": pre.dT, "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
                     "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
                     "JPg": pre.JPg, "JPa": pre.JPa, "bg0": pre.bias_gyro,
                     "ba0": pre.bias_acc}
        prior_const = {"R0": pose_wb[:, :3], "p0": pose_wb[:, 3], "v0": vel,
                       "bg0": bg, "ba0": ba}
        pose_out, v_out, bg_out, ba_out, _, n_inl, H15n = self.vi_opt(
            pred_wb, imu.v2, bg, ba, uvr, pt_xyz, ok, is2, pose_wb, vel,
            pre_const, imu.imu_info, self.rw_info, prior_const, H15, True)
        R_cw2 = pose_out[:, :3].T
        pose_cw2 = torch.cat([R_cw2, (-R_cw2 @ pose_out[:, 3])[:, None]], 1)
        _, ln_matched, _ = line_proj_match_core(
            self.K, pose_cw2.contiguous(), ln_ep6, ln_desc, ln_valid, lf.ep,
            lf.desc, lf.angle, lf.valid, lf.lineq, plain=self.plain)
        H15n = H15n + torch.eye(15, device=H15n.device) * 1e-4
        return ((pose_out, v_out, bg_out, ba_out, H15n),
                (n_inl, ln_matched.sum()))


def _example_points(rng, cap_pts, dev):
    xyz = torch.tensor(rng.uniform(-2, 2, (cap_pts, 3)) + [0, 0, 4],
                       dtype=torch.float32, device=dev)
    desc = torch.from_numpy(rng.integers(0, 2 ** 32, (cap_pts, 8),
                                         dtype=np.uint32).view(np.int32))
    return xyz, desc.to(dev), torch.ones(cap_pts, dtype=torch.bool,
                                          device=dev)


def tracking_step(height: int = 480, width: int = 752,
                  n_features: int = 512, cap_pts: int = 1024,
                  device="cuda", plain: bool = False):
    """Point-only step and example args (random image and map, seed 0)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.uniform(0, 255, (height, width)),
                       dtype=torch.float32, device=dev)
    pose = torch.eye(3, 4, dtype=torch.float32, device=dev)
    step = TrackingStep(height, width, n_features, plain).to(dev)
    return step, (img, pose, *_example_points(rng, cap_pts, dev))


def tracking_step_pl(height: int = 480, width: int = 752,
                     n_features: int = 1000, cap_pts: int = 2048,
                     cap_lns: int = 128, n_line_feat: int = 256,
                     device="cuda", plain: bool = False):
    """Point+line step and example args (random image and map, seed 0)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.uniform(0, 255, (height, width)),
                       dtype=torch.float32, device=dev)
    pose = torch.eye(3, 4, dtype=torch.float32, device=dev)
    xyz, desc, valid = _example_points(rng, cap_pts, dev)
    Xs = rng.uniform(-2, 2, (cap_lns, 3)) + [0, 0, 4]
    ln_ep6 = torch.tensor(np.concatenate(
        [Xs, Xs + rng.normal(0, 0.4, (cap_lns, 3))], -1),
        dtype=torch.float32, device=dev)
    ln_desc = torch.from_numpy(rng.integers(0, 2 ** 32, (cap_lns, 8),
                                            dtype=np.uint32).view(np.int32))
    ln_valid = torch.ones(cap_lns, dtype=torch.bool, device=dev)
    step = TrackingStepPL(height, width, n_features, n_line_feat,
                          plain).to(dev)
    return step, (img, pose, xyz, desc, valid, ln_ep6, ln_desc.to(dev),
                  ln_valid)


def tracking_step_vi(height: int = 480, width: int = 752,
                     n_features: int = 1000, cap_pts: int = 2048,
                     n_line_feat: int = 256, n_imu: int = 10,
                     gravity: float = 9.81, device="cuda",
                     plain: bool = False):
    """VI step and an initial carry (identity pose at rest, zero biases,
    H15 = I).  The step takes a local map of any line capacity."""
    dev = resolve_device(device)
    step = TrackingStepVI(height, width, n_features, cap_pts, n_line_feat,
                          n_imu, gravity, plain).to(dev)
    z3 = torch.zeros(3, device=dev)
    carry = (torch.eye(3, 4, device=dev), z3, z3.clone(), z3.clone(),
             torch.eye(15, device=dev))
    return step, carry


class MappingOut(NamedTuple):
    kf_poses: torch.Tensor     # [n_kf,3,4] T_cw after the BA
    pt_xyz: torch.Tensor       # [n_pt,3]
    ln_ep6: torch.Tensor       # [n_ln,6]
    n_good: torch.Tensor       # triangulated pairs that pass every gate
    n_inliers: torch.Tensor    # point observations within chi2 5.991
    n_inliers_l: torch.Tensor  # line observations within chi2 5.991
    inlier: torch.Tensor       # [n_obs] bool
    inlier_l: torch.Tensor     # [n_lobs] bool
    X_new: torch.Tensor        # [n_feat,3] triangulated points (world)
    good: torch.Tensor         # [n_feat] bool
    idx2: torch.Tensor         # [n_feat] epipolar match into the neighbour
    matched: torch.Tensor      # [n_feat] bool


class MappingStep(nn.Module):
    """The keyframe mapping step (bench.build_mapping_step's `step`,
    bench.py:294-307): the new KF's features matched to its neighbour's
    along epipolar lines (ratio 0.8, max 60, mutual, rotation histogram),
    the matches DLT-triangulated with the depth, parallax and
    reprojection gates, then 2 rounds x <= 8 LM iterations of the
    point+line windowed BA (CG reduced solve, early exit at 1e-2, chi2
    re-gating at 5.991 between rounds).

    forward(A, stats=None) -> MappingOut; A is the dict of
    `inputs.build_mapping_inputs`; `stats` (a list) gets each BA round's
    LM iteration count.  `ba_K` (a KB8K: the window BA of a fisheye
    camera, its point edges through the lens on raw pixels) replaces K in
    the BA; the matcher and the triangulator work on the undistorted
    pinhole coordinates of K."""

    def __init__(self, plain: bool = False, K: PinholeK = K_EUROC,
                 ba_K=None):
        super().__init__()
        self.epi = make_epipolar_matcher(K, plain=plain)
        self.tri = make_triangulator(K, plain=plain)
        self.lba = make_local_ba_pl(K if ba_K is None else ba_K, plain=plain)

    def forward(self, A, stats=None):
        idx2, ok2 = self.epi(A["pose_a"], A["pose_b"], A["uv_a"], A["desc"],
                             A["ok"], A["uv_b"], A["desc"], A["ok"],
                             A["ang"], A["ang"])
        Xw, good = self.tri(A["pose_a"], A["pose_b"], A["uv_a"],
                            A["uv_b"][idx2.long()], ok2)
        poses, pts, lns, inl, inl_l = self.lba(
            A["kf_poses"], A["kf_free"], A["pt_xyz"], A["pt_free"],
            A["obs_kf"], A["obs_pt"], A["obs_uv"], A["obs_valid"],
            A["obs_is2"],
            A["ln_ep6"], A["ln_free"], A["lobs_kf"], A["lobs_ln"],
            A["lobs_eq"], A["lobs_valid"], A["lobs_is2"], stats=stats)
        return MappingOut(poses, pts, lns, good.sum(), inl.sum(),
                          inl_l.sum(), inl, inl_l, Xw, good, idx2, ok2)


# the two window sizes of the reference's mapping benchmark (bench.py:457-459)
MAPPING_WORST = dict(n_kf=16, n_pt=4096, n_obs=8192, n_feat=1024, n_ln=512,
                     n_lobs=1024)
MAPPING_TYPICAL = dict(n_kf=16, n_pt=2048, n_obs=4096, n_feat=1024, n_ln=256,
                       n_lobs=512)


def mapping_step(n_kf: int = 16, n_pt: int = 4096, n_obs: int = 8192,
                 n_feat: int = 1024, n_ln: int = 512, n_lobs: int = 1024,
                 device="cuda", plain: bool = False, kb8: bool = False):
    """The keyframe mapping step at the given window size (default: the
    worst case, 16 KF x 4096 points x 8192 observations, 512 lines x 1024
    observations, 1024 features) and its inputs from
    `inputs.build_mapping_inputs` (bench.py's numpy draws, seed 1).  With
    `kb8` the step of the fisheye room's KB8 camera
    (`inputs.kb8_camera`): the window of `inputs.build_kb8_window` from the
    truth (the points' observations through the lens on raw pixels, the
    lines' on its pinhole fx, fy, cx, cy), the epipolar pair the first
    n_feat points at keyframes 0 and 1 in undistorted coordinates; the BA
    with the KB8K, the matcher and the triangulator on its pinhole four."""
    from .inputs import build_kb8_window, build_mapping_inputs, kb8_camera
    dev = resolve_device(device)
    A = build_mapping_inputs(n_kf, n_pt, n_obs, n_feat, n_ln, n_lobs,
                             device=dev)
    if not kb8:
        return MappingStep(plain=plain).to(dev), A
    K8 = kb8_camera()
    K = PinholeK(K8.fx, K8.fy, K8.cx, K8.cy)
    A.update(build_kb8_window(n_kf, n_pt, n_obs, perturbed=False, device=dev,
                              n_ln=n_ln, n_lobs=n_lobs))
    X = A["pt_xyz"][:n_feat]
    for key, P in (("uv_a", A["pose_a"]), ("uv_b", A["pose_b"])):
        pc = X @ P[:, :3].T + P[:, 3]
        A[key] = torch.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                              K.fy * pc[:, 1] / pc[:, 2] + K.cy],
                             -1).contiguous()
    return MappingStep(plain=plain, K=K, ba_K=K8).to(dev), A


class InertialBAOut(NamedTuple):
    pose_wb: torch.Tensor      # [n_kf,3,4] body poses after the BA
    vel: torch.Tensor          # [n_kf,3]
    bg: torch.Tensor           # [n_kf,3]
    ba: torch.Tensor           # [n_kf,3]
    pt_xyz: torch.Tensor       # [n_pt,3]
    inlier: torch.Tensor       # [n_obs] bool, point observations
    ln_ep6: torch.Tensor       # [n_ln,6]
    inlier_l: torch.Tensor     # [n_lobs] bool, line observations


class InertialBAStep(nn.Module):
    """One solve of the sliding-window visual-inertial BA
    (`LocalMapper._liba_window` on `make_local_inertial_ba`,
    models/kernels.py:1206): per-KF 15-DoF states (pose_wb, vel, bg, ba),
    the inertial and bias random-walk edges along the chain, body-frame
    point and line edges to Schur-eliminated landmarks (lines with
    information 1), 2 rounds x <= 8 LM iterations, CG reduced solve,
    early exit at 1e-2, the chi2 re-gate at 5.991 on the point and line
    edges between rounds.

    forward(A, stats=None) -> InertialBAOut; A is the dict of
    `inputs.build_inertial_window`; `stats` (a list) gets each round's LM
    iteration count."""

    def __init__(self, n_kf: int, n_pt: int, n_obs: int, n_ln: int,
                 n_lobs: int, Rcb, tcb, gravity: float = 9.81,
                 plain: bool = False, K: PinholeK = K_EUROC):
        super().__init__()
        self.liba = make_local_inertial_ba(K, n_kf, n_pt, n_obs, Rcb, tcb,
                                           gravity, n_ln=n_ln, n_lobs=n_lobs,
                                           plain=plain)

    def forward(self, A, stats=None):
        return InertialBAOut(*self.liba(*[A[k] for k in LIBA_KEYS],
                                        stats=stats))


# the two buckets of `_liba_window` (models/local_mapping.py:1495-1503)
LIBA_WORST = dict(n_pt=4096, n_obs=8192, n_ln=256, n_lobs=512)
LIBA_HALF = dict(n_pt=2048, n_obs=4096, n_ln=256, n_lobs=512)


def inertial_ba_step(n_pt: int = 4096, n_obs: int = 8192, n_ln: int = 256,
                     n_lobs: int = 512, perturbed: bool = True,
                     device="cuda", plain: bool = False, n_kf: int = 16,
                     n_observers: int = 5):
    """The inertial window solve at the given bucket (default: the worst
    case, 16 KF x 4096 points x 8192 observations + 256 lines x 512
    observations) and its window from `inputs.build_inertial_window`
    (seed 0; the perturbed start unless perturbed=False)."""
    from .inputs import build_inertial_window
    dev = resolve_device(device)
    A = build_inertial_window(n_pt, n_obs, n_ln, n_lobs, device=dev,
                              perturbed=perturbed, n_kf=n_kf,
                              n_observers=n_observers)
    step = InertialBAStep(n_kf, n_pt, n_obs, n_ln, n_lobs,
                          A["Rcb"].cpu().numpy(), A["tcb"].cpu().numpy(),
                          plain=plain)
    return step.to(dev), A


class ImuInit(nn.Module):
    """IMU initialization (`make_inertial_init`, models/kernels.py:1137:
    gravity direction, scale, shared biases and velocities with the poses
    fixed, 20 LM iterations, bias priors 1e2 / 1e10) as forward(A) ->
    (Rwg, scale, bg, ba, vel), and the periodic scale / gravity refinement
    (`make_scale_refine`, :1092: only the gravity direction and the scale
    free, 12 iterations) as refine(A) -> (Rwg, scale); A is the dict of
    `inputs.build_imu_init_inputs`."""

    def __init__(self, n_kf: int = 32, gravity: float = 9.81,
                 plain: bool = False):
        super().__init__()
        self.init = make_inertial_init(gravity, n_kf, plain=plain)
        self.scale_refine = make_scale_refine(gravity, n_kf, plain=plain)

    def forward(self, A):
        return self.init(A["Rwg0"], A["vel0"], A["pre_const"], A["pose_R"],
                         A["pose_p"], A["imu_info"], A["edge_valid"])

    def refine(self, A):
        return self.scale_refine(A["ref_Rwg0"], A["ref_vel"], A["ref_bg"],
                                 A["ref_ba"], A["pre_const"], A["ref_pose_R"],
                                 A["ref_pose_p"], A["imu_info"],
                                 A["edge_valid"])


def imu_init(n_kf: int = 32, device="cuda", plain: bool = False):
    """IMU initialization and refinement at the cap `imu_init_cap` (32 KF)
    and their chain from `inputs.build_imu_init_inputs` (seed 0)."""
    from .inputs import build_imu_init_inputs
    dev = resolve_device(device)
    A = build_imu_init_inputs(n_kf, device=dev)
    return ImuInit(n_kf, plain=plain).to(dev), A


def mapper_config(sensor, K: PinholeK = K_EUROC, identity_tbc=False):
    """The SystemConfig of the keyframe step's entry points: the pinhole
    camera K without distortion, lines on, `sensor`; with identity_tbc
    the body frame is the camera's (the synthetic sequences' IMU)."""
    from .config import CameraConfig, SystemConfig
    imu = ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))) if identity_tbc \
        else ImuConfig()
    return SystemConfig(sensor=sensor, use_lines=True, imu=imu,
                        camera=CameraConfig(fx=K.fx, fy=K.fy, cx=K.cx,
                                            cy=K.cy,
                                            dist=(0.0, 0.0, 0.0, 0.0)))


def _empty_store():
    """A one-slot placeholder store, until a step is handed its map."""
    from .models.mapstore import MapStore
    return MapStore(max_kf=1, max_pts=1, max_lines=1, n_feat=1,
                    n_line_feat=1)


class NeighborhoodOut(NamedTuple):
    new_lines: int             # map lines created by create_new_lines
    n_bound: int               # features bound by the fuse
    n_merged: int              # landmarks merged by the fuse
    n_refused: int             # merges the fuse's 3D check refused
    ba_path: str               # "pt" (make_local_ba), "pl" (make_local_ba_pl)
    lm_iters: list             # LM iterations per BA round
    host_syncs: int            # device-to-host reads of the mapper


class NeighborhoodStep(nn.Module):
    """The keyframe step's neighbourhood work on the port's `LocalMapper`
    (models/local_mapping.py:187-234 of the reference, in its order):
    `create_new_lines` (line pair matcher + line triangulator against up
    to 10 covisible neighbours), `search_in_neighbors` (the projection
    matcher's fuse, forward into the new keyframe and back into up to 10
    neighbours) and `local_ba` (point-only, or point+line with >= 8
    multi-view lines in the window), at production's caps: 1000 features,
    fuse cap 2048, BA window 16 KF x 4096 points x 8192 observations, 512
    lines x 1024 line observations.

    forward(m, kf=None) -> NeighborhoodOut mutates the port `MapStore` m
    as the reference mutates its store; kf defaults to the newest valid
    keyframe."""

    def __init__(self, plain: bool = False, device="cuda",
                 ba_kf_cap: int = 16, ba_pt_cap: int = 4096,
                 ba_obs_cap: int = 8192, K: PinholeK = K_EUROC):
        super().__init__()
        from .config import Sensor
        from .models.local_mapping import LocalMapper
        from .models.mapstore import Atlas
        self.mapper = LocalMapper(
            mapper_config(Sensor.MONOCULAR, K), Atlas([_empty_store()]),
            1000, ba_kf_cap, ba_pt_cap, ba_obs_cap, device=device,
            plain=plain)

    def forward(self, m, kf=None):
        mp = self.mapper
        if kf is None:
            valid = m.valid_kf_indices()
            kf = int(valid[np.argmax(m.kf_timestamp[valid])])
        mp.map = m
        mp.host_syncs = mp.n_bound = mp.n_merged = mp.n_refused = 0
        n_ln = m.n_ln
        mp.create_new_lines(kf)
        new_lines = m.n_ln - n_ln
        mp.search_in_neighbors(kf)
        mp.local_ba(kf)
        return NeighborhoodOut(new_lines, mp.n_bound, mp.n_merged,
                               mp.n_refused, mp.ba_path,
                               [int(x) for x in mp.ba_stats], mp.host_syncs)


def neighborhood_step(confirmed_lines: bool = False, seed: int = 0,
                      device="cuda", plain: bool = False, **caps):
    """The keyframe step's neighbourhood work (`NeighborhoodStep`, at
    production's caps unless `caps` names others) and a fresh port
    `MapStore` of `inputs.build_keyframe_map(confirmed_lines, seed)`:
    14 keyframes, the new one last."""
    from .inputs import build_keyframe_map
    from .state import mapstore_from_numpy
    dev = resolve_device(device)
    arrays, _ = build_keyframe_map(confirmed_lines, seed)
    return (NeighborhoodStep(plain=plain, device=dev, **caps),
            mapstore_from_numpy(arrays))


def entry(device="cuda"):
    """The flagship point+line tracked frame at EuRoC geometry
    (480x752, 1000 features, 2048 map points, 128 map lines, 256 line
    features) on `device`."""
    return tracking_step_pl(device=device)


class BootstrapOut(NamedTuple):
    init_frame: int            # index of the frame that initialized, or -1
    attempts: int              # two-view reconstructions run
    used_homography: bool      # the last attempt's model
    init_matches: int          # the last attempt's init matches
    n_triangulated: int        # the last attempt's triangulated matches
    points: int                # map points created
    lines: int                 # map lines created
    kf_pose_cw: np.ndarray     # [2,3,4] the two keyframes' T_cw
    kf_pose_wb: np.ndarray     # [2,3,4] their body poses
    host_syncs: list           # device-to-host reads per attempt
    map: object                # the port's MapStore
    tracker: object            # the port's Tracker (records, queue)


class BootstrapStep(nn.Module):
    """The monocular bootstrap of the mono-inertial point+line path: each
    frame through the frame prelude (ORB, undistortion, lines) and
    `Tracker.process_frame`, in order, until the tracker is OK; the
    initial map is two keyframes with their points, lines, bindings,
    covisibility and the first IMU preintegration.

    forward(B) -> BootstrapOut; B is the dict of
    `inputs.build_bootstrap_inputs` with its frames as tensors on the
    step's device.  `cfg` defaults to the rendered frames' camera (EuRoC
    intrinsics, no distortion), IMU_MONOCULAR with lines."""

    def __init__(self, cfg=None, plain: bool = False, device="cuda"):
        super().__init__()
        from .config import CameraConfig, Sensor, SystemConfig
        from .ops.cameras import make_camera
        if cfg is None:
            cfg = SystemConfig(camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                               sensor=Sensor.IMU_MONOCULAR, use_lines=True)
        self.cfg, self.plain = cfg, plain
        self.device = resolve_device(device)
        cam = cfg.camera
        self.cam = make_camera(cam)
        specs = make_level_specs(cam.height, cam.width, 1000)
        self.n_feat = sum(sp.n_keep for sp in specs)
        self.orb = OrbExtractor(specs, plain=plain)
        self.lines = LineExtractor(256, levels=2, plain=plain) \
            if cfg.use_lines else None
        self.to(self.device)

    def forward(self, B) -> BootstrapOut:
        from .models.mapstore import Atlas, MapStore
        from .models.system import frame_prelude
        from .models.tracking import Tracker, TrackState
        atlas = Atlas([MapStore(n_feat=self.n_feat)])
        tr = Tracker(self.cfg, atlas, self.n_feat, device=self.device,
                     plain=self.plain)
        init_frame = -1
        for i, img in enumerate(B["frames"]):
            feats, lf = frame_prelude(self.orb, self.lines, self.cam, img,
                                      self.plain)
            tr.process_frame(feats, float(B["timestamps"][i]),
                             imu=B["imu"][i], line_feats=lf)
            if tr.state == TrackState.OK:
                init_frame = i
                break
        m = atlas.current
        res = tr.last_twoview
        kfs = list(tr.new_kf_queue)
        return BootstrapOut(
            init_frame, tr.attempts,
            bool(res.used_homography) if res is not None else False,
            tr.init_matches,
            int(res.is_triangulated.sum()) if res is not None else 0,
            m.n_pt, m.n_ln, m.kf_pose_cw[kfs].copy(),
            m.kf_pose_wb[kfs].copy(), list(tr.attempt_syncs), m, tr)


def bootstrap_step(seed: int = 0, device="cuda", plain: bool = False):
    """The monocular bootstrap (`BootstrapStep`) and its inputs from
    `inputs.build_bootstrap_inputs(seed)`, the frames on `device`."""
    from .inputs import build_bootstrap_inputs
    dev = resolve_device(device)
    B = build_bootstrap_inputs(seed)
    B["frames"] = [torch.from_numpy(f).to(dev) for f in B["frames"]]
    return BootstrapStep(plain=plain, device=dev), B


class SeqStep(NamedTuple):
    kf: int                    # the keyframe's slot
    points: int                # map points alive after the step
    lines: int                 # map lines alive
    keyframes: int             # keyframes alive
    culled: list               # slots of the keyframes culled
    ba: list                   # window solves: (path, keyframes, LM iters)
    host_syncs: int            # device-to-host reads of the mapper
    ms: float                  # wall ms of process_keyframe


class KeyframeSequenceOut(NamedTuple):
    steps: list                # SeqStep per keyframe from the third on
    init_kf: int               # sequence index at which the IMU initialized
    init_scale: float          # the scale the initialization applied
    inv_lam: float             # 1 / the map's starting monocular scale
    scale: float               # the map's final scale against the truth
    gravity_err_deg: float     # map's gravity direction against the truth
    n_refine: int              # scale / gravity refinement pulses
    n_viba: int                # full-map inertial BA solves
    viba_window: int           # keyframes in the largest full-map window
    ate_sim3: float            # final keyframe centres' ATE RMSE (m)
    ate_se3: float
    map: object                # the port's MapStore at the end
    track: dict                # the tracker stand-in's state


class KeyframeSequence(nn.Module):
    """The whole keyframe step over a keyframe sequence: the map of
    `inputs.start_keyframe_map`, then for each further keyframe the
    tracker stand-in's `inputs.insert_keyframe` and the port's
    `LocalMapper.process_keyframe` (culling, new points and lines, fusion,
    the point statistics, IMU init, the window BA, the scale refinement
    and full-map pulses, keyframe culling), the mapper's pending map
    transform composed into the stand-in's frame after each step.

    The caps are production's unless given: store 512 KF / 16384 points /
    2048 lines, point BA window 16 x 4096 x 8192, inertial window 16 KF
    with lines 256 / 512 (its half bucket), the full-map window 64 x 8192
    x 16384 + 512 / 1024, IMU init cap 32, fuse cap 2048.  Mono-inertial
    with lines; the camera is `K_EUROC` without distortion, the body frame
    the camera's.  forward(seq) -> KeyframeSequenceOut."""

    def __init__(self, plain: bool = False, device="cuda",
                 store=None, caps=None, viba_caps=None, K: PinholeK = K_EUROC):
        super().__init__()
        from .config import Sensor
        self.device = resolve_device(device)
        self.store = {**dict(max_kf=512, max_pts=16384, max_lines=2048),
                      **(store or {})}
        self.cfg = mapper_config(Sensor.IMU_MONOCULAR, K, identity_tbc=True)
        self.caps = dict(caps or {})
        self.viba_caps = dict(viba_caps or {})
        self.plain = plain
        self.mapper = None

    def new_mapper(self):
        """A fresh LocalMapper at the step's caps (the full-map window's
        set before its first use, as the reference allows)."""
        from .models.local_mapping import LocalMapper
        from .models.mapstore import Atlas
        mp = LocalMapper(self.cfg, Atlas([_empty_store()]), 1000,
                         device=self.device, plain=self.plain, **self.caps)
        for k, v in self.viba_caps.items():
            setattr(mp, k, v)
        return mp

    def forward(self, seq) -> KeyframeSequenceOut:
        import time
        from .inputs import compose_transform, insert_keyframe, \
            start_keyframe_map
        from .models.mapstore import MapStore
        mp = self.mapper = self.new_mapper()
        m = MapStore(n_feat=seq["n_feat"], n_line_feat=seq["n_line_feat"],
                     **self.store)
        mp.map = m
        track = start_keyframe_map(m, seq)
        steps, init_kf, n_viba, viba_window = [], -1, 0, 0
        cuda = self.device.type == "cuda"
        for i in range(2, len(seq["t_kf"])):
            kf = insert_keyframe(m, seq, i, track)
            mp.host_syncs = 0
            mp.ba_calls = []
            was_init = m.imu_initialized
            t0 = time.perf_counter()
            culled = mp.process_keyframe(kf)
            if cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if mp.pending_transform is not None:
                compose_transform(track, mp.pending_transform)
                mp.pending_transform = None
            if m.imu_initialized and not was_init:
                init_kf = i
            ba = [(c["path"], c["window"], [int(x) for x in c["iters"]])
                  for c in mp.ba_calls]
            for path, w, _ in ba:
                if path == "viba":
                    n_viba += 1
                    viba_window = max(viba_window, w)
            steps.append(SeqStep(kf, m.n_pt, m.n_ln, m.n_kf,
                                 [int(c[0]) for c in culled], ba,
                                 mp.host_syncs, ms))
        return KeyframeSequenceOut(
            steps, init_kf,
            float(mp.init_scale) if mp.init_scale is not None else 0.0,
            1.0 / seq["lam"], sequence_scale(m, seq),
            gravity_error_deg(m, seq, track), mp.n_refine, n_viba,
            viba_window,
            *sequence_ate(m, seq), m, track)


def gravity_error_deg(m, seq, track) -> float:
    """Angle (deg) between the map's gravity direction (0, 0, -1) and the
    world's as the newest keyframe's pose maps it (R_cw^map^T R_cw^true
    (0, 0, -1)), which IMU init should have aligned."""
    kf, i = track["last_kf"], track["last_i"]
    R_mw = m.kf_pose_cw[kf, :, :3].astype(np.float64).T @ seq["R_wc"][i].T
    d = R_mw @ np.array([0.0, 0.0, -1.0])
    return float(np.degrees(np.arccos(np.clip(-d[2], -1.0, 1.0))))


def _centres(m, seq):
    """The live keyframes' camera centres and their true ones."""
    kfs = m.kf_chain()
    P = m.kf_pose_cw[kfs].astype(np.float64)
    c = -np.einsum("kji,kj->ki", P[:, :, :3], P[:, :, 3])
    i = np.searchsorted(seq["t_kf"], m.kf_timestamp[kfs] - 1e-6)
    return c, seq["p_wc"][i], m.kf_timestamp[kfs]


def sequence_scale(m, seq) -> float:
    """The map's scale against the truth (map units per metre; 1 is
    metric): the Sim3 (Umeyama) alignment of the true keyframe centres
    onto the map's."""
    from .io.trajectory import umeyama
    c, g, _ = _centres(m, seq)
    return float(umeyama(g, c)[0])


def sequence_ate(m, seq):
    """(Sim3, SE3) ATE RMSE (m) of the live keyframes' camera centres
    against the truth at their timestamps (io/trajectory.ate_rmse)."""
    from .io.trajectory import Trajectory, ate_rmse
    c, _, t = _centres(m, seq)
    est = Trajectory(t, c, np.zeros((len(t), 4)))
    gt = Trajectory(seq["t_kf"], seq["p_wc"], np.zeros((len(seq["t_kf"]),
                                                        4)))
    return ate_rmse(est, gt, True), ate_rmse(est, gt, False)


def keyframe_sequence(seed: int = 0, device="cuda", plain: bool = False,
                      **kw):
    """The whole keyframe step over a keyframe sequence
    (`KeyframeSequence`, production's caps unless `kw` names others:
    store, caps, viba_caps) and the sequence of
    `inputs.build_keyframe_sequence(seed)` (`seq_kw` in kw: its sizes)."""
    from .inputs import build_keyframe_sequence
    dev = resolve_device(device)
    seq = build_keyframe_sequence(seed, **kw.pop("seq_kw", {}))
    return KeyframeSequence(plain=plain, device=dev, **kw), seq


class TrackedFrame(NamedTuple):
    state: int                 # TrackState after the frame
    tracked: bool              # process_frame returned a pose
    inliers: int               # the pose optimization's inliers (0 untracked)
    matched: int               # projection matches of the frame
    keyframe: bool             # the frame made a keyframe (or the map)
    ms: float                  # wall ms: upload, front end, tracker, mapping
    host_syncs: int            # device-to-host reads of tracker and mapper


class TrackedSequenceOut(NamedTuple):
    frames: list               # TrackedFrame per frame
    n_tracked: int             # frames with a pose
    init_frame: int            # the frame that bootstrapped the map, or -1
    imu_init_kf: int           # keyframes made when the IMU initialized, or -1
    imu_init_frame: int        # the frame at which it initialized, or -1
    init_scale: float          # the scale IMU init applied (0 if none)
    pre_init_scale: float      # the trajectory's scale the frame before
    scale: float               # the trajectory's scale against the truth
    gravity_err_deg: float     # the map's gravity direction, last frame
    keyframes: int             # keyframes, points and lines alive at the end
    points: int
    lines: int
    ate_sim3: float            # ATE RMSE (m) over every tracked frame
    ate_se3: float
    map: object                # the port's MapStore
    tracker: object            # the port's Tracker
    mapper: object             # the port's LocalMapper


class TrackedSequence(nn.Module):
    """The mono-inertial main path from rendered frames to a gravity-aligned
    metric map, as `System.track_monocular` runs it with synchronous
    mapping and no keyframe database (scripts/run_synthetic_vi.py): each
    frame uploaded, through the frame prelude (ORB with the `pyramid`
    kernel, the 2-level line front end), `Tracker.process_frame` (the
    bootstrap, then tracking against the local map, the keyframe
    decision) and the keyframe glue (`models/system.drain_keyframes`:
    `LocalMapper.process_keyframe` for every new keyframe, then the IMU
    init's transform).

    IMU_MONOCULAR with lines, EuRoC K without distortion, the body frame
    the camera's (`mapper_config(..., identity_tbc=True)`), 1000 ORB and
    256 line features at 752x480, production's store (512 KF / 16384
    points / 2048 lines) and caps unless given: `store`, `caps` (the
    LocalMapper's), `viba_caps`, `n_features`, `local_pts_cap`.  The
    bootstrap's RANSAC samples come from `sampler` where given (see
    `models/tracking.Tracker`).  forward(S) -> TrackedSequenceOut, S the
    dict of `inputs.build_tracked_sequence`."""

    def __init__(self, plain: bool = False, device="cuda", store=None,
                 caps=None, viba_caps=None, n_features: int = 1000,
                 local_pts_cap: int = 2048, sampler=None,
                 K: PinholeK = K_EUROC):
        super().__init__()
        from .config import Sensor
        from .ops.cameras import make_camera
        self.device = resolve_device(device)
        self.plain = plain
        self.cfg = mapper_config(Sensor.IMU_MONOCULAR, K, identity_tbc=True)
        cam = self.cfg.camera
        self.cam = make_camera(cam)
        specs = make_level_specs(cam.height, cam.width, n_features)
        self.n_feat = sum(sp.n_keep for sp in specs)
        self.orb = OrbExtractor(specs, plain=plain)
        self.lines = LineExtractor(256, levels=2, plain=plain)
        self.store = {**dict(max_kf=512, max_pts=16384, max_lines=2048),
                      **(store or {})}
        self.caps = dict(caps or {})
        self.viba_caps = dict(viba_caps or {})
        self.local_pts_cap = local_pts_cap
        self.sampler = sampler
        self.to(self.device)

    def new_pipeline(self):
        """A fresh (tracker, mapper) pair on one Atlas at the step's caps."""
        from .models.local_mapping import LocalMapper
        from .models.mapstore import Atlas, MapStore
        from .models.tracking import Tracker
        atlas = Atlas([MapStore(n_feat=self.n_feat, **self.store)])
        tr = Tracker(self.cfg, atlas, self.n_feat, self.local_pts_cap,
                     device=self.device, plain=self.plain,
                     sampler=self.sampler)
        mp = LocalMapper(self.cfg, atlas, self.n_feat, device=self.device,
                         plain=self.plain, **self.caps)
        for k, v in self.viba_caps.items():
            setattr(mp, k, v)
        return tr, mp

    def forward(self, S, frame_ctx=None) -> TrackedSequenceOut:
        """`frame_ctx(i)`, where given, is a context manager entered around
        frame i's work (a profiler's range)."""
        import contextlib
        import time
        from .models.system import (apply_pending_transform,
                                    drain_keyframes, frame_prelude)
        from .models.tracking import TrackState
        tr, mp = self.new_pipeline()
        cuda = self.device.type == "cuda"
        frames, init_frame, imu_kf, imu_frame, n_made = [], -1, -1, -1, 0
        pre_scale = 0.0
        for i, img in enumerate(S["frames"]):
            syncs0 = tr.host_syncs + mp.host_syncs
            was_init = tr.map.imu_initialized
            booting = tr.state in (TrackState.NO_IMAGES_YET,
                                   TrackState.NOT_INITIALIZED)
            t0 = time.perf_counter()
            with frame_ctx(i) if frame_ctx else contextlib.nullcontext():
                img_t = torch.as_tensor(img, dtype=torch.float32).to(
                    self.device)
                feats, lf = frame_prelude(self.orb, self.lines, self.cam,
                                          img_t, self.plain)
                pose = tr.process_frame(feats, float(S["timestamps"][i]),
                                        imu=S["imu"][i], line_feats=lf)
                made = len(tr.new_kf_queue)
                drain_keyframes(tr, mp)
                apply_pending_transform(tr, mp)
                if cuda:
                    torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n_made += made
            if booting and tr.state == TrackState.OK and init_frame < 0:
                init_frame = i
            if tr.map.imu_initialized and not was_init:
                imu_kf, imu_frame = n_made, i
            elif not tr.map.imu_initialized and tr.last_pose_cw is not None:
                pre_scale = tracked_errors(tr, S)[1]
            ok = tr.state == TrackState.OK and not booting
            frames.append(TrackedFrame(
                int(tr.state), pose is not None,
                int(tr.last_n_inliers) if ok else 0,
                int(tr.last_n_matched) if ok else 0, made > 0, ms,
                tr.host_syncs + mp.host_syncs - syncs0))
        m = tr.map
        ate, scale, grav = tracked_errors(tr, S)
        init_scale = 0.0 if mp.init_scale is None else float(mp.init_scale)
        return TrackedSequenceOut(
            frames, sum(f.tracked for f in frames), init_frame, imu_kf,
            imu_frame, init_scale, pre_scale, scale, grav, int(m.n_kf),
            int(m.n_pt), int(m.n_ln), ate[0], ate[1], m, tr, mp)


def tracked_errors(tracker, S):
    """((Sim3, SE3) ATE RMSE (m) of every tracked frame's camera centre
    (`Tracker.full_trajectory`) against the truth, the trajectory's scale
    against the truth (Umeyama, map units per metre; 1 is metric), the
    map's gravity direction error (deg) at the last tracked frame: the
    angle between (0, 0, -1) and the world's down as R_cw^map^T
    R_cw^true maps it)."""
    from .io.trajectory import Trajectory, associate, ate_rmse, umeyama
    ts, pos, quat = tracker.full_trajectory()
    gt = Trajectory(np.asarray(S["timestamps"]), np.asarray(S["p_wc"]),
                    np.zeros((len(S["timestamps"]), 4)))
    if len(ts) < 3 or tracker.last_pose_cw is None:
        return (float("inf"), float("inf")), 0.0, 180.0
    est = Trajectory(ts, pos, quat)
    ate = (ate_rmse(est, gt, True), ate_rmse(est, gt, False))
    ia, ib = associate(est.timestamps, gt.timestamps)
    ok = np.isfinite(pos[ia]).all(-1)
    scale = float(umeyama(gt.positions[ib][ok], pos[ia][ok])[0])
    i = int(np.argmin(np.abs(gt.timestamps - ts[-1])))
    R_cw = tracker.last_pose_cw[:, :3].astype(np.float64)
    d = R_cw.T @ S["R_wc"][i].T @ np.array([0.0, 0.0, -1.0])
    grav = float(np.degrees(np.arccos(np.clip(-d[2], -1.0, 1.0))))
    return ate, scale, grav


def tracked_sequence(seed: int = 0, device="cuda", plain: bool = False,
                     n_frames: int = 180, **kw):
    """The mono-inertial main path over rendered frames
    (`TrackedSequence`, production's caps unless `kw` names others) and
    the frames of `inputs.build_tracked_sequence(seed, n_frames)`."""
    from .inputs import build_tracked_sequence
    dev = resolve_device(device)
    S = build_tracked_sequence(seed, n_frames)
    return TrackedSequence(plain=plain, device=dev, **kw), S


class SystemFrame(NamedTuple):
    state: int                 # TrackState after the frame
    tracked: bool              # track_monocular returned a pose
    inliers: int               # the pose optimization's inliers (0 untracked)
    keyframe: bool             # the frame made a keyframe (or the map)
    reloc_tried: int           # relocalization attempts in the frame
    reloc_ok: int              # ... that succeeded
    ms: float                  # wall ms: upload, front end, tracker, mapping
    host_syncs: int            # device-to-host reads of the whole system


class SystemRunOut(NamedTuple):
    frames: list               # SystemFrame per frame
    n_tracked: int             # frames with a pose
    init_frame: int            # the frame that bootstrapped the map, or -1
    imu_init_kf: int           # keyframes made when the IMU initialized, or -1
    imu_init_frame: int        # the frame at which it initialized, or -1
    imu_initialized: bool
    init_scale: float          # the scale IMU init applied (0 if none)
    pre_init_scale: float      # the trajectory's scale the frame before
    scale: float               # after global_refine: the trajectory's scale
    gravity_err_deg: float     # the map's gravity direction, last frame
    keyframes: int             # keyframes, points and lines alive at the end
    points: int
    lines: int
    maps: int                  # maps in the Atlas
    ba_norm: float             # |accelerometer bias| of the frame state
    final_state: int           # TrackState after the last frame
    ate_sim3: float            # after global_refine, over every frame (m)
    ate_se3: float
    reloc_tried: int           # relocalization attempts and successes
    reloc_ok: int
    poses: list                # each frame's T_cw (None untracked)
    metrics: dict              # System.metrics_summary()
    system: object             # the port's System
    loops: int = 0             # loops the loop closer closed
    merges: int = 0            # maps it merged
    verifications: int = 0     # Sim3 verifications it ran
    prior_aligned: bool = False     # the prior-map relocalizer aligned
    prior_align_kf: int = -1   # ... at its n-th keyframe, or -1
    prior_n: int = 0           # keyframes it re-expressed in the prior world
    prior_err: float = float("nan")     # their RMSE against the truth (m)


def system_config(**kw):
    """The SystemConfig of tests/test_mh_replay_regression.py and
    scripts/run_mh_loop.py, the system's defaults otherwise (loop closing
    on): IMU_MONOCULAR with lines, EuRoC K without distortion, the body
    frame the camera's; kw replaces fields (the MH replay's comparisons
    pass use_loop_closing=False, as the JAX reference run they are held
    to)."""
    from .config import CameraConfig, Sensor, SystemConfig
    base = dict(sensor=Sensor.IMU_MONOCULAR,
                camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
    return SystemConfig(**{**base, **kw})


STEREO_BASELINE = 0.11       # m, EuRoC's cam0-cam1 baseline


def stereo_config(sensor=None, **kw):
    """`system_config` for a second view: the reference's
    `stereo_line_inertial_euroc3` (IMU_STEREO, lines) by default, or
    STEREO (`stereo_line_euroc3`) or RGBD; the rectified EuRoC camera
    (no distortion) with the 0.11 m baseline, none for RGB-D (its depth
    image gives the depths, the residuals stay mono); kw replaces
    fields."""
    from .config import CameraConfig, Sensor
    sensor = Sensor.IMU_STEREO if sensor is None else Sensor(sensor)
    cam = dict(dist=(0.0, 0.0, 0.0, 0.0))
    if sensor != Sensor.RGBD:
        cam["baseline"] = STEREO_BASELINE
    return system_config(**{"sensor": sensor, "camera": CameraConfig(**cam),
                            **kw})


class SystemRun(nn.Module):
    """The port's `System` over a replay: every frame through
    `System.track_monocular` (the front ends, the tracker with the
    keyframe database and relocalization, the keyframe step), or
    `track_stereo` where the replay has right views (`S["right"]`),
    `track_rgbd` where it has depth images (`S["depth"]`), then
    `global_refine`.  The configuration is `system_config(**cfg_kw)`
    (production's store and feature counts unless cfg_kw names others:
    `map`, `orb`, `seed`, `use_loop_closing`, ...), or `cfg` where given;
    `caps`, `viba_caps`, `sampler`, `pnp_sampler`, `sim3_sampler` and
    `dist_mesh` go to `System`.  forward(S) -> SystemRunOut, S the dict of
    `inputs.build_mh_replay` (or `build_tracked_sequence`,
    `build_stereo_replay`, `build_stereo_room`, `build_rgbd_room`)."""

    def __init__(self, plain: bool = False, device="cuda", caps=None,
                 viba_caps=None, sampler=None, pnp_sampler=None,
                 sim3_sampler=None, cfg=None, dist_mesh=None, **cfg_kw):
        super().__init__()
        self.device = resolve_device(device)
        self.plain = plain
        self.cfg = cfg if cfg is not None else system_config(**cfg_kw)
        self.kw = dict(caps=caps, viba_caps=viba_caps, sampler=sampler,
                       pnp_sampler=pnp_sampler, sim3_sampler=sim3_sampler,
                       dist_mesh=dist_mesh)

    def new_system(self):
        from .models.system import System
        return System(self.cfg, device=self.device, plain=self.plain,
                      **self.kw)

    def forward(self, S, frame_ctx=None) -> SystemRunOut:
        """`frame_ctx(i)`, where given, is a context manager entered around
        frame i's work (a profiler's range)."""
        import contextlib
        import time
        from .models.tracking import TrackState
        slam = self.new_system()
        tr = slam.tracker
        cuda = self.device.type == "cuda"
        frames, poses = [], []
        init_frame = imu_kf = imu_frame = -1
        n_made, pre_scale = 0, 0.0
        for i, img in enumerate(S["frames"]):
            syncs0 = slam.host_syncs
            r0, ok0 = tr.reloc_tries, tr.reloc_ok
            was_init = tr.map.imu_initialized
            booting = tr.state in (TrackState.NO_IMAGES_YET,
                                   TrackState.NOT_INITIALIZED)
            t0 = time.perf_counter()
            t = float(S["timestamps"][i])
            with frame_ctx(i) if frame_ctx else contextlib.nullcontext():
                if "right" in S:
                    pose = slam.track_stereo(img, S["right"][i], t,
                                             imu=S["imu"][i])
                elif "depth" in S:
                    pose = slam.track_rgbd(img, S["depth"][i], t,
                                           imu=S["imu"][i])
                else:
                    pose = slam.track_monocular(img, t, imu=S["imu"][i])
                if cuda:
                    torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            # the monocular bootstrap makes two keyframes, the depth
            # bootstrap and a tracked frame one
            made = tr.last_kf_frame_idx == tr.frame_idx \
                and tr.state == TrackState.OK
            two = booting and "right" not in S and "depth" not in S
            n_made += (2 if two else 1) if made else 0
            if booting and tr.state == TrackState.OK and init_frame < 0:
                init_frame = i
            if tr.map.imu_initialized and not was_init:
                imu_kf, imu_frame = n_made, i
            elif not tr.map.imu_initialized and tr.last_pose_cw is not None:
                pre_scale = tracked_errors(tr, S)[1]
            ok = tr.state == TrackState.OK and not booting
            poses.append(None if pose is None else np.array(pose))
            frames.append(SystemFrame(
                int(tr.state), pose is not None,
                int(tr.last_n_inliers) if ok else 0, bool(made),
                tr.reloc_tries - r0, tr.reloc_ok - ok0, ms,
                slam.host_syncs - syncs0))
        m = tr.map
        stats = (bool(m.imu_initialized), int(m.n_kf), int(m.n_pt),
                 int(m.n_ln), len(slam.atlas.maps),
                 float(np.linalg.norm(tr.frame_ba)), int(tr.state))
        slam.global_refine()
        if cuda:
            torch.cuda.synchronize()
        ate, scale, grav = tracked_errors(tr, S)
        mp = slam.mapper
        init_scale = 0.0 if mp.init_scale is None else float(mp.init_scale)
        lc = slam.loop_closer
        rl = slam.relocalizer
        prior = () if rl is None else (
            rl.T_prior_from_live is not None, rl.aligned_at,
            len(rl.relocalized_poses),
            prior_error(rl.relocalized_poses, S["prior"]["T_pw"])
            if "prior" in S else float("nan"))
        return SystemRunOut(
            frames, sum(f.tracked for f in frames), init_frame, imu_kf,
            imu_frame, stats[0], init_scale, pre_scale,
            scale, grav, *stats[1:], ate[0], ate[1], tr.reloc_tries,
            tr.reloc_ok, poses, slam.metrics_summary(), slam,
            *((lc.n_loops_closed, lc.n_maps_merged, lc.n_verifications)
              if lc is not None else (0, 0, 0)), *prior)


def lose_tracking(tracker) -> None:
    """The tracker as the reference's `System.load_atlas` leaves it
    (models/system.py:480-490): LOST, no pose, no motion model, its next
    frame re-enters the map through `_relocalize`."""
    from .models.mapstore import INVALID
    from .models.tracking import TrackState
    tracker.state = TrackState.LOST
    tracker.init_feats = None
    tracker.last_feats = None
    tracker.last_pose_cw = None
    tracker.last_feat_pt = None
    tracker.last_feat_ln = None
    tracker.ref_kf = INVALID
    tracker.last_created_kf = INVALID
    tracker.velocity = None
    tracker.lost_count = 0
    tracker.imu_since_kf = []


RELOC_START = 83        # the relocalization case's first frame (4.15 s)
RELOC_FRAMES = 5        # frames fed to it at most


def relocalization_case(slam, S, poses, start: int = RELOC_START,
                        max_frames: int = RELOC_FRAMES) -> dict:
    """Relocalization on a replay's final map: the tracker lost as
    `lose_tracking` leaves it, then the replay's frames from `start` fed
    again without IMU until one is tracked.  Returns the frames it took
    (-1 if none), the relocalized pose's camera-centre distance (m) and
    rotation (deg) from `poses[j]` (the pose the run tracked at that
    frame), the tries, the last frame's wall ms and the accepted
    attempt's record (`Tracker.last_reloc`)."""
    import time
    lose_tracking(slam.tracker)
    tries0 = slam.tracker.reloc_tries
    out = dict(frames=-1, centre_m=float("inf"), rot_deg=float("inf"))
    for j in range(start, min(start + max_frames, len(S["frames"]))):
        t0 = time.perf_counter()
        pose = slam.track_monocular(S["frames"][j],
                                    float(S["timestamps"][j]), imu=None)
        if slam.device.type == "cuda":
            torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        if pose is not None:
            P = np.asarray(pose, np.float64)
            G = np.asarray(poses[j], np.float64)
            c_p = -P[:, :3].T @ P[:, 3]
            c_g = -G[:, :3].T @ G[:, 3]
            R = P[:, :3] @ G[:, :3].T
            out.update(frames=j - start + 1,
                       centre_m=float(np.linalg.norm(c_p - c_g)),
                       rot_deg=float(np.degrees(np.arccos(np.clip(
                           (np.trace(R) - 1) / 2, -1.0, 1.0)))),
                       reloc=slam.tracker.last_reloc)
            break
    out["tries"] = slam.tracker.reloc_tries - tries0
    return out


def mh_replay(seconds: float = 8.0, seed: int = 7, device="cuda",
              plain: bool = False, **kw):
    """The whole system over the MH replay (`SystemRun`, production's
    sizes unless `kw` names others) and the replay of
    `inputs.build_mh_replay(seconds, seed)` (`replay_kw` in kw: its
    sizes)."""
    from .inputs import build_mh_replay
    dev = resolve_device(device)
    S = build_mh_replay(seconds, seed, **kw.pop("replay_kw", {}))
    return SystemRun(plain=plain, device=dev, **kw), S


def stereo_replay(seconds: float = 8.0, seed: int = 7, device="cuda",
                  plain: bool = False, **kw):
    """The whole system over the stereo-inertial replay (`SystemRun` with
    `stereo_config()`: IMU_STEREO with lines, loop closing on,
    production's sizes unless `kw` names others) and the replay of
    `inputs.build_stereo_replay(seconds, seed)` (`replay_kw` in kw: its
    sizes)."""
    from .inputs import build_stereo_replay
    dev = resolve_device(device)
    S = build_stereo_replay(seconds, seed, **kw.pop("replay_kw", {}))
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps", "sampler",
                                   "pnp_sampler", "sim3_sampler")
            if k in kw}
    return SystemRun(plain=plain, device=dev, cfg=stereo_config(**kw),
                     **caps), S


def stereo_room(n_frames: int = 15, seed: int = 0, imu: bool = False,
                device="cuda", plain: bool = False, **kw):
    """`System.track_stereo` with lines over the room orbit of
    tests/test_stereo.py (STEREO; imu=True: IMU_STEREO over
    tests/test_stereo_inertial.py's orbit), loop closing off as there
    (`SystemRun`; kw: `stereo_config` fields and `caps`, `viba_caps`;
    `use_lines=False` gives the point-only STEREO of
    tests/test_stereo.py:14-38, whose tracker solves the pose with the
    stereo LM), and the orbit of `inputs.build_stereo_room`."""
    from .config import Sensor
    from .inputs import build_stereo_room
    dev = resolve_device(device)
    S = build_stereo_room(seed, n_frames, imu=imu)
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps") if k in kw}
    kw.setdefault("use_loop_closing", False)
    cfg = stereo_config(Sensor.IMU_STEREO if imu else Sensor.STEREO, **kw)
    return SystemRun(plain=plain, device=dev, cfg=cfg, **caps), S


def rgbd_room(n_frames: int = 12, seed: int = 0, device="cuda",
              plain: bool = False, bf: float = 0.0, **kw):
    """`System.track_rgbd` over the RGB-D room orbit of tests/test_stereo.py
    (no lines, loop closing off, as there; `SystemRun`; kw:
    `stereo_config` fields and `caps`, `viba_caps`) and the orbit of
    `inputs.build_rgbd_room`.  bf > 0 (ORB-SLAM3's `Camera.bf`, 40.0 in
    its TUM RGB-D settings) gives the camera the baseline bf / fx: the
    depths then enter the pose solve as u_R rows (the stereo LM); bf = 0
    keeps the residuals mono."""
    from .config import CameraConfig, Sensor
    from .inputs import build_rgbd_room
    dev = resolve_device(device)
    S = build_rgbd_room(seed, n_frames, bf=bf)
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps") if k in kw}
    kw.setdefault("use_loop_closing", False)
    kw.setdefault("use_lines", False)
    if bf > 0:
        kw.setdefault("camera", CameraConfig(
            dist=(0.0, 0.0, 0.0, 0.0), baseline=bf / CameraConfig().fx))
    cfg = stereo_config(Sensor.RGBD, **kw)
    return SystemRun(plain=plain, device=dev, cfg=cfg, **caps), S


def kb8_config(**kw):
    """tests/test_kb8_native.py:131-133's configuration: the fisheye
    room's KB8 camera (fx = fy = 380, cx = 376, cy = 240, k =
    `inputs.KB8_K`, 752x480), monocular, no lines, the system's defaults
    otherwise (loop closing on); kw replaces fields."""
    from .config import CameraConfig, SystemConfig
    from .inputs import KB8_INTRINSICS, KB8_K
    base = dict(camera=CameraConfig(model="kb8", dist=KB8_K,
                                    **KB8_INTRINSICS),
                use_lines=False)
    return SystemConfig(**{**base, **kw})


def kb8_room(n_frames: int = 30, seed: int = 0, device="cuda",
             plain: bool = False, **kw):
    """`System.track_monocular` with the KB8 fisheye over the room of
    tests/test_kb8_native.py:116-169 (`SystemRun` with `kb8_config(**kw)`,
    kw also `caps`, `viba_caps`, `sampler`, `sim3_sampler`) and its frames
    (`inputs.build_kb8_room`)."""
    from .inputs import build_kb8_room
    dev = resolve_device(device)
    S = build_kb8_room(seed, n_frames)
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps", "sampler",
                                   "sim3_sampler") if k in kw}
    return SystemRun(plain=plain, device=dev, cfg=kb8_config(**kw),
                     **caps), S


def kb8_vi_config(use_lines: bool = True, **kw):
    """The fork's main configuration on a fisheye lens: IMU_MONOCULAR with
    the fisheye room's KB8 camera (`inputs.KB8_INTRINSICS`, `KB8_K`), the
    body frame the camera's, lines on unless use_lines=False, the system's
    defaults otherwise (loop closing on); kw replaces fields."""
    from .config import Sensor
    return system_config(**{**dict(
        sensor=Sensor.IMU_MONOCULAR, use_lines=use_lines,
        camera=kb8_config().camera), **kw})


def kb8_vi_replay(seconds: float = 8.0, seed: int = 7, use_lines: bool = True,
                  device="cuda", plain: bool = False, **kw):
    """The whole system with the KB8 fisheye and the IMU over the MH
    replay's hall (`SystemRun` with `kb8_vi_config(use_lines, **kw)`, kw
    also `caps`, `viba_caps`, `sampler`, `pnp_sampler`, `sim3_sampler`,
    `replay_kw`: `inputs.build_kb8_vi_replay`'s n_frames / frames) and the
    replay of `inputs.build_kb8_vi_replay(seconds, seed)`."""
    from .inputs import build_kb8_vi_replay
    dev = resolve_device(device)
    S = build_kb8_vi_replay(seconds, seed, **kw.pop("replay_kw", {}))
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps", "sampler",
                                   "pnp_sampler", "sim3_sampler")
            if k in kw}
    return SystemRun(plain=plain, device=dev,
                     cfg=kb8_vi_config(use_lines, **kw), **caps), S


def line_mode_config(mode: int, **kw):
    """SLAM mode 1, 2 or 3 (the reference's YAML `SLAM`: the pose and the
    window BA from lines alone) on `system_config`'s camera: MONOCULAR
    with lines, loop closing on (as the JAX package's System runs it);
    kw replaces fields."""
    from .config import Sensor, SlamMode
    return system_config(**{**dict(sensor=Sensor.MONOCULAR, use_lines=True,
                                   slam_mode=SlamMode(mode)), **kw})


def line_mode_replay(mode: int, seconds: float = 8.0, seed: int = 7,
                     device="cuda", plain: bool = False, **kw):
    """The whole system under SLAM mode 1, 2 or 3 over the MH replay's
    frames (`SystemRun` with `line_mode_config(mode, **kw)`, kw also the
    caps and samplers of `kb8_vi_replay` and `replay_kw`) and the replay
    of `inputs.build_mh_replay(seconds, seed)` with its IMU batches
    dropped (MONOCULAR)."""
    from .inputs import build_mh_replay
    dev = resolve_device(device)
    S = build_mh_replay(seconds, seed, **kw.pop("replay_kw", {}))
    S["imu"] = [None] * len(S["frames"])
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps", "sampler",
                                   "pnp_sampler", "sim3_sampler")
            if k in kw}
    return SystemRun(plain=plain, device=dev,
                     cfg=line_mode_config(mode, **kw), **caps), S


def ed_config(prior_dir=None, **kw):
    """`system_config` with the ED line detector (`line.detector = 1`, the
    reference's `extractor: 1`): IMU_MONOCULAR with lines at 752x480, loop
    closing on; with `prior_dir`, the prior-map relocalizer on that prior
    keyframe set (`reloc.enabled`); kw replaces fields."""
    from .config import LineConfig, RelocConfig
    base = dict(line=LineConfig(detector=1))
    if prior_dir is not None:
        base["reloc"] = RelocConfig(enabled=True,
                                    prior_data_dir=str(prior_dir))
    return system_config(**{**base, **kw})


def prior_error(relocalized_poses: dict, T_pw) -> float:
    """RMSE (m) of the relocalized keyframe positions (time -> [3,4] pose
    in the prior world) against the truth of the MH trajectory at those
    times taken into the prior world by T_pw [3,4]; nan if none."""
    from .io import synthetic as syn
    if not relocalized_poses:
        return float("nan")
    ts = np.asarray(sorted(relocalized_poses), np.float64)
    got = np.stack([np.asarray(relocalized_poses[float(t)], np.float64)[:, 3]
                    for t in ts])
    T = np.asarray(T_pw, np.float64)
    truth = syn._eval_mh(ts).p_wb @ T[:, :3].T + T[:, 3]
    return float(np.sqrt(((got - truth) ** 2).sum(1).mean()))


def ed_replay(seed: int = 7, cfg_seed: int = 0, reloc: bool = True,
              device="cuda", plain: bool = False, prior_dir=None, **kw):
    """The whole system with the ED line detector over the MH replay
    (`SystemRun` with `ed_config`, cfg.seed = cfg_seed; kw also the caps
    and samplers of `kb8_vi_replay` and `replay_kw`) and the replay of
    `inputs.build_mh_replay(8.0, seed)`; with `reloc`, also the prior
    keyframe set of `inputs.build_prior_set` written into `prior_dir` (a
    new temporary directory where None) and the relocalizer on it.  The
    replay dict then holds `prior` (build_prior_set's dict with its
    `dir`), from which the run reports the relocalized trajectory's error
    (`prior_error`)."""
    import tempfile
    from .inputs import build_mh_replay, build_prior_set
    dev = resolve_device(device)
    replay_kw = kw.pop("replay_kw", {})
    S = build_mh_replay(8.0, seed, **replay_kw)
    if reloc:
        prior_dir = prior_dir or tempfile.mkdtemp(prefix="prior_set_")
        scene = {k: replay_kw[k] for k in ("n_points", "n_lines")
                 if k in replay_kw}
        S["prior"] = dict(build_prior_set(prior_dir, replay_seed=seed,
                                          **scene), dir=str(prior_dir))
    caps = {k: kw.pop(k) for k in ("caps", "viba_caps", "sampler",
                                   "pnp_sampler", "sim3_sampler")
            if k in kw}
    cfg = ed_config(S["prior"]["dir"] if reloc else None, seed=cfg_seed,
                    **kw)
    return SystemRun(plain=plain, device=dev, cfg=cfg, **caps), S


def ed_stereo_room(n_frames: int = 15, seed: int = 0, device="cuda",
                   plain: bool = False, **kw):
    """`stereo_room` with lines under the ED line detector (STEREO, the
    room orbit of tests/test_stereo.py)."""
    from .config import LineConfig
    return stereo_room(n_frames, seed, device=device, plain=plain,
                       line=LineConfig(detector=1), **kw)


def mh_loop(duration: float = 28.0, seed: int = 7, device="cuda",
            plain: bool = False, **kw):
    """The whole system with its default configuration (loop closing on)
    over the closed circuit of scripts/run_mh_loop.py (`SystemRun`,
    production's sizes unless `kw` names others) and the circuit of
    `inputs.build_mh_loop(duration, seed)` (`replay_kw` in kw: its
    sizes)."""
    from .inputs import build_mh_loop
    dev = resolve_device(device)
    S = build_mh_loop(duration, seed, **kw.pop("replay_kw", {}))
    return SystemRun(plain=plain, device=dev, **kw), S


class LoopClosureOut(NamedTuple):
    case: str
    closed: list               # per keyframe fed: a loop closed / maps merged
    loops: int
    merges: int
    verifications: int         # Sim3 verifications run
    err_before: float          # circle: the revisit keyframe's centre from
    err_after: float           # the first's (m); merge: the largest merged
                               # keyframe centre's error against the truth
    maps: int                  # maps in the Atlas after
    points: int                # live points after
    graph: dict                # LoopCloser.last_graph: the last graph
    verify: dict               # LoopCloser.last_verify
    ms: list                   # wall ms per keyframe fed
    loop_closer: object


class LoopClosure(nn.Module):
    """`LoopCloser.process_keyframe` over the last keyframes of a hand-made
    map (`inputs.build_drifted_loop_map`: the last 4; `inputs.
    build_merge_maps`: the young map's last 3), with the reference tests'
    keyframe database (the random vocabulary of seed 0, a database per map
    for the merge) at production caps (pose graph 512 keyframes x 4096
    edges, global BA 128 x 8192 x 32768; `gba_caps` replaces the last: on
    the CPU pass smaller ones).  forward(inputs) works on copies of the
    maps and returns LoopClosureOut."""

    def __init__(self, case: str = "circle", device="cuda",
                 plain: bool = False, gba_caps=None):
        super().__init__()
        if case not in ("circle", "merge"):
            raise ValueError(f"loop_closure: no case {case!r}")
        self.case = case
        self.device = resolve_device(device)
        self.plain = plain
        self.gba_caps = gba_caps

    def forward(self, inputs) -> LoopClosureOut:
        import copy
        import time
        from .config import CameraConfig, SystemConfig
        from .models import vocabulary as V
        from .models.kfdb import AtlasKeyFrameDatabase, KeyFrameDatabase
        from .models.loop_closing import LoopCloser
        from .models.mapstore import Atlas
        cfg = SystemConfig(camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                           use_lines=False)
        voc = V.random_vocabulary(seed=0)
        dev, plain = self.device, self.plain
        if self.case == "circle":
            m = copy.deepcopy(inputs["map"])
            kfs = inputs["keyframes"]
            atlas = Atlas(maps=[m], active=0)
            db = KeyFrameDatabase(voc, m.max_kf, m.n_feat, device=dev,
                                  plain=plain)
            for kf in kfs:
                db.add_keyframe(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf])
            feed = kfs[-4:]
        else:
            m_old = copy.deepcopy(inputs["m_old"])
            m_cur = copy.deepcopy(inputs["m_cur"])
            atlas = Atlas(maps=[m_old, m_cur], active=1)
            db = AtlasKeyFrameDatabase(voc, 64, m_cur.n_feat, atlas,
                                       device=dev, plain=plain)
            for mm, ks in ((m_old, inputs["old_kfs"]),
                           (m_cur, inputs["cur_kfs"])):
                for kf in ks:
                    db.add_keyframe(kf, mm.kf_feat_desc[kf],
                                    mm.kf_feat_valid[kf], map_id=mm.map_id)
            feed = inputs["cur_kfs"][-3:]
        lc = LoopCloser(cfg, atlas, db, atlas.current.n_feat, device=dev,
                        plain=plain)
        if self.gba_caps is not None:
            lc._gba_caps = tuple(self.gba_caps)
        err0 = self._error(atlas, inputs, None)
        closed, ms = [], []
        for kf in feed:
            t0 = time.perf_counter()
            closed.append(bool(lc.process_keyframe(int(kf))))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        kf_map = None if lc.pending_merge is None \
            else lc.pending_merge["kf_map"]
        return LoopClosureOut(
            self.case, closed, lc.n_loops_closed, lc.n_maps_merged,
            lc.n_verifications, err0, self._error(atlas, inputs, kf_map),
            len(atlas.maps), int(atlas.current.pt_valid.sum()),
            lc.last_graph, lc.last_verify, ms, lc)

    def _error(self, atlas, inputs, kf_map) -> float:
        m = atlas.current
        c = m.kf_centers()
        if self.case == "circle":
            kfs = inputs["keyframes"]
            return float(np.linalg.norm(c[kfs[-1]] - c[kfs[0]]))
        if kf_map is None:
            return float("inf")
        return float(max(np.linalg.norm(c[kf_map[k]] - p)
                         for k, p in zip(inputs["cur_kfs"],
                                         inputs["centres"])))


def loop_closure(case: str = "circle", seed: int = 0, device="cuda",
                 plain: bool = False, gba_caps=None):
    """The loop closer at production caps over a hand-made map
    (`LoopClosure`) and the map's inputs: "circle",
    `inputs.build_drifted_loop_map(seed)`; "merge",
    `inputs.build_merge_maps(seed)`."""
    from .inputs import build_drifted_loop_map, build_merge_maps
    if case == "circle":
        m, kfs, _ = build_drifted_loop_map(seed)
        inputs = dict(map=m, keyframes=kfs)
    else:
        m_old, m_cur, old_kfs, cur_kfs, centres = build_merge_maps(seed)
        inputs = dict(m_old=m_old, m_cur=m_cur, old_kfs=old_kfs,
                      cur_kfs=cur_kfs, centres=centres)
    return LoopClosure(case, device=device, plain=plain,
                       gba_caps=gba_caps), inputs


# --------------------------------------------------------------------------
# Slice 15: the sharded back end (plvio_tpu_torch/parallel/)
# --------------------------------------------------------------------------

DIST_LIBA = dict(n_pt=4096, n_obs=8192, n_ln=256, n_lobs=512, n_kf=16)
DIST_FULL = dict(n_pt=8192, n_obs=16384, n_ln=512, n_lobs=1024, n_kf=64)


def shard_mesh(shards: int, device="cuda"):
    """A mesh of `shards` shards, all on `device`."""
    from .parallel.mesh import Mesh
    return Mesh([resolve_device(device)] * shards)


def window_runner_args(A) -> dict:
    """An inertial window of `inputs.build_inertial_window` (tensors,
    padded to its caps) as `DistLIBARunner.solve`'s unpadded numpy
    arguments: the free landmarks and the valid observations."""
    def np_(k):
        return A[k].detach().cpu().numpy()
    n_pt, n_ln = int(np_("pt_free").sum()), int(np_("ln_free").sum())
    ov, lv = np_("obs_valid"), np_("lobs_valid")
    return dict(pose_wb=np_("kf_pose_wb"), vel=np_("kf_vel"),
                bg=np_("kf_bg"), ba=np_("kf_ba"), kf_free=np_("kf_free"),
                kf_free_bias=np_("kf_free_bias"), obs_kf=np_("obs_kf")[ov],
                obs_pt=np_("obs_pt")[ov], obs_uv=np_("obs_uv")[ov],
                obs_is2=np_("obs_is2")[ov], pt_xyz=np_("pt_xyz")[:n_pt],
                pre_stack={k: v.detach().cpu().numpy()
                           for k, v in A["pre_const"].items()},
                imu_info=np_("imu_info"), edge_valid=np_("edge_valid"),
                rw_g=np_("rw_info_g"), rw_a=np_("rw_info_a"),
                lobs_kf=np_("lobs_kf")[lv], lobs_ln=np_("lobs_ln")[lv],
                lobs_eq=np_("lobs_eq")[lv], ln_ep=np_("ln_ep6")[:n_ln])


class DistWindow(nn.Module):
    """One inertial window solve on the landmark-sharded back end
    (`parallel/dist_liba.DistLIBARunner` on `mesh`, the mapper's buckets):
    forward(W) -> the runner's numpy (pose_wb, vel, bg, ba, pt_xyz,
    ln_ep), W the dict of `window_runner_args`."""

    def __init__(self, mesh, plain: bool = False):
        super().__init__()
        from .parallel.dist_liba import DistLIBARunner
        Rcb, tcb = _euroc_extrinsic()
        self.runner = DistLIBARunner(K_EUROC, Rcb, tcb, 9.81, mesh=mesh,
                                     plain=plain)

    def forward(self, W):
        return self.runner.solve(**W)


def _euroc_extrinsic():
    from .inputs import extrinsics
    Rcb, tcb = extrinsics()
    return Rcb.astype(np.float32), tcb.astype(np.float32)


def dist_window(shards: int = 2, big: bool = False, seed: int = 0,
                device="cuda", plain: bool = False, sizes=None):
    """One sharded inertial window at the mapper's bucket: the sliding
    window's (C = 16; 4096 points, 8192 observations, 256 lines, 512 line
    observations) or with `big` the full-map window's (C = 64; 8192 /
    16384 / 512 / 1024), from `inputs.build_inertial_window(seed,
    perturbed)`; `sizes` replaces the caps (the CPU's reduced runs).
    Returns (DistWindow on a mesh of `shards` shards of `device`, W (its
    arguments), A (the window's tensors on the CPU, with its truth))."""
    from .inputs import build_inertial_window
    dev = resolve_device(device)
    z = dict(DIST_FULL if big else DIST_LIBA, **(sizes or {}))
    A = build_inertial_window(z["n_pt"], z["n_obs"], z["n_ln"], z["n_lobs"],
                              seed=seed, device="cpu", perturbed=True,
                              n_kf=z["n_kf"],
                              n_observers=z.get("n_observers", 5))
    return DistWindow(shard_mesh(shards, dev), plain=plain), \
        window_runner_args(A), A


def dist_window_solve(mesh, plain: bool = False):
    """fn(*args) -> (pose_wb, vel, bg, ba, pt_xyz [n_pt], obs_valid,
    ln_ep [n_ln], lobs_valid) on the args' device: the sharded window
    solve in `make_local_inertial_ba`'s argument and output layout (args:
    `models/kernels.LIBA_KEYS` of a window), for `KN.against_float64`
    against the single-device solve."""
    from .models.kernels import LIBA_KEYS

    def fn(*args):
        A = dict(zip(LIBA_KEYS, args))
        dev = args[0].device
        out = DistWindow(mesh, plain=plain)(window_runner_args(A))
        n_pt, n_ln = args[6].shape[0], args[18].shape[0]
        pts = np.zeros((n_pt, 3), np.float32)
        pts[:len(out[4])] = out[4]
        pts[len(out[4]):] = args[6][len(out[4]):].cpu().numpy()
        lns = args[18].cpu().numpy().copy()
        if out[5] is not None:
            lns[:len(out[5])] = out[5]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return (t(out[0]), t(out[1]), t(out[2]), t(out[3]), t(pts),
                args[11], t(lns), args[23])
    return fn


def dist_replay(shards: int = 2, seed: int = 7, cfg_seed: int = 0,
                device="cuda", plain: bool = False, **kw):
    """`System` over the MH replay (`mh_replay`'s, cfg.seed = cfg_seed)
    with the mapper's runner on a mesh of `shards` shards on the one
    device: every inertial window solve on the sharded back end (kw:
    `mh_replay`'s)."""
    from .inputs import build_mh_replay
    dev = resolve_device(device)
    S = build_mh_replay(8.0, seed, **kw.pop("replay_kw", {}))
    return SystemRun(plain=plain, device=dev, seed=cfg_seed,
                     dist_mesh=shard_mesh(shards, dev), **kw), S


def dist_ba_step(shards: int = 2, seed: int = 0, n_cams: int = 4,
                 n_pts: int = 96, iters: int = 12, device="cuda",
                 plain: bool = False):
    """`parallel/dist_ba.make_dist_ba` on the scene of tests/test_dist_ba.py
    (`inputs.build_dist_ba_scene`, default_rng(seed)) over a mesh of
    `shards` shards of `device`.  Returns (run, data, scene)."""
    from .inputs import K_DIST_BA, build_dist_ba_scene
    from .parallel import dist_ba as DB
    dev = resolve_device(device)
    scene = build_dist_ba_scene(np.random.default_rng(seed), n_cams, n_pts)
    poses_gt, X_gt, poses0, X0, obs_kf, obs_pt, obs_uv = scene
    _, _, obs_pt_l, valid, (okf_b, ouv_b), (X0_b, free_b) = \
        DB.bucket_observations(shards, n_pts, obs_pt, (obs_kf, obs_uv),
                               (X0, np.ones(n_pts, bool)))
    t = torch.from_numpy
    data = DB.DistBAData(
        kf_poses=t(poses0), kf_free=t(np.arange(n_cams) > 0),
        pt_xyz=t(X0_b), pt_free=t(free_b), obs_kf=t(okf_b.astype(np.int32)),
        obs_pt=t(obs_pt_l), obs_uv=t(ouv_b), obs_valid=t(valid),
        obs_is2=t(np.ones(len(valid), np.float32)))
    run = DB.make_dist_ba(K_DIST_BA, shard_mesh(shards, dev), n_cams,
                          iters=iters, plain=plain)
    return run, data, scene


def chain_ba_step(shards: int = 2, seed: int = 0, C: int = 16,
                  pts_per_kf: int = 30, halo: int = 2, outer_iters: int = 6,
                  device="cuda", plain: bool = False):
    """`parallel/chain_ba.make_chain_ba` on tests/test_chain_ba.py's chain
    (`inputs.build_chain_ba_problem`, default_rng(seed)) over a mesh of
    `shards` shards of `device`, the first keyframe fixed.  Returns (run,
    data, layout, problem)."""
    from .inputs import K_CHAIN, build_chain_ba_problem
    from .parallel import chain_ba as CB
    dev = resolve_device(device)
    prob = build_chain_ba_problem(np.random.default_rng(seed), C=C,
                                  pts_per_kf=pts_per_kf)
    poses_gt, pts, obs_kf, obs_pt, obs_uv = prob
    rng = np.random.default_rng(seed + 1)
    poses0 = poses_gt.copy()
    poses0[1:, :, 3] += rng.normal(0, 0.03, (C - 1, 3)).astype(np.float32)
    pts0 = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    data, layout = CB.partition_chain(
        shards, halo, np.arange(C), poses0, obs_kf, obs_pt, obs_uv,
        np.ones(len(obs_kf), np.float32), pts0, fixed_kf=np.array([0]))
    run = CB.make_chain_ba(K_CHAIN, shard_mesh(shards, dev), layout["Wh"],
                           data.pt_xyz.shape[1], data.obs_kf.shape[1],
                           outer_iters=outer_iters, halo=halo, plain=plain)
    return run, data, layout, prob


def chain_liba_step(shards: int = 2, seed: int = 0, n_kf: int = 12,
                    n_pts: int = 200, n_lns: int = 8, halo: int = 2,
                    outer_sweeps: int = 3, iters: int = 6, device="cuda",
                    plain: bool = False):
    """`parallel/chain_liba.make_chain_liba` on the chain of
    tests/test_chain_liba.py:193 (`inputs.build_chain_vi_problem`,
    default_rng(seed); positions moved by 2 cm and velocities by 3 cm/s)
    over a mesh of `shards` shards of `device`.  Returns (run, data,
    layout, problem)."""
    from .inputs import K_CHAIN_VI, build_chain_vi_problem
    from .parallel import chain_liba as CL
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    prob = build_chain_vi_problem(rng, n_kf=n_kf, n_pts=n_pts, n_lns=n_lns)
    (pose_gt, vel_gt, X, ln_ep, obs_kf, obs_pt, obs_uv, lobs_kf, lobs_ln,
     lobs_eq, pre_stack, infos, ev, rwg, rwa) = prob
    pose0, vel0 = pose_gt.copy(), vel_gt.copy()
    for i in range(1, n_kf):
        pose0[i, :, 3] += rng.normal(0, 0.02, 3)
        vel0[i] += rng.normal(0, 0.03, 3)
    bgba = np.zeros((n_kf, 3), np.float32)
    data, layout = CL.partition_chain_vi(
        shards, halo, n_kf, pose0, vel0, bgba, bgba, obs_kf, obs_pt, obs_uv,
        np.ones(len(obs_kf), np.float32), X.copy(), pre_stack, infos, ev,
        rwg, rwa, lobs_kf=lobs_kf, lobs_ln=lobs_ln, lobs_eq=lobs_eq,
        ln_ep=ln_ep.copy(), fixed_pos=(0,), free_all_biases=False)
    Rcb, tcb = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    run = CL.make_chain_liba(
        K_CHAIN_VI, shard_mesh(shards, dev), layout["Wh"],
        data.pt_xyz.shape[1], data.obs_kf.shape[1], data.ln_ep.shape[1],
        data.lobs_kf.shape[1], Rcb, tcb, 9.81, halo=halo,
        outer_sweeps=outer_sweeps, iters=iters, plain=plain)
    return run, data, layout, prob
