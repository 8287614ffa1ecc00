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
        feats = self.orb(img)
        lf = self.lines(img)
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
        feats = self.orb(img)
        lf = self.lines(img)
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
    LM iteration count."""

    def __init__(self, plain: bool = False, K: PinholeK = K_EUROC):
        super().__init__()
        self.epi = make_epipolar_matcher(K, plain=plain)
        self.tri = make_triangulator(K, plain=plain)
        self.lba = make_local_ba_pl(K, plain=plain)

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
                 device="cuda", plain: bool = False):
    """The keyframe mapping step at the given window size (default: the
    worst case, 16 KF x 4096 points x 8192 observations, 512 lines x 1024
    observations, 1024 features) and its inputs from
    `inputs.build_mapping_inputs` (bench.py's numpy draws, seed 1)."""
    from .inputs import build_mapping_inputs
    dev = resolve_device(device)
    A = build_mapping_inputs(n_kf, n_pt, n_obs, n_feat, n_ln, n_lobs,
                             device=dev)
    return MappingStep(plain=plain).to(dev), A


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


def entry(device="cuda"):
    """The flagship point+line tracked frame at EuRoC geometry
    (480x752, 1000 features, 2048 map points, 128 map lines, 256 line
    features) on `device`."""
    return tracking_step_pl(device=device)
