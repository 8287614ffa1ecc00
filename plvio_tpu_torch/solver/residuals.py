"""Residuals ("edges") of the VI pose optimizer, the windowed point+line
BA, the inertial window BA and the IMU initialization, and their
retractions (port of plvio_tpu/solver/residuals.py:
`retract_pose_cw_single` :41, `retract_pose_cw` :47, `PinholeK` :90,
`retract_pose_wb_single` :56, `retract_pose_wb` :61, `retract_additive`
:68, `retract_gdir` :72, `retract_scale` :78, `make_point_reproj` :107,
`make_line_reproj` :155, `make_line_reproj_body_ba` :226,
`make_point_reproj_body` :248, `make_stereo_reproj_body` :266,
`make_point_reproj_body_ba` :290,
`state_prior` :308, `make_inertial` :318, `make_inertial_gs` :348,
`bias_rw` :466, `make_prior15` :474, the pose-only edges
`make_point_reproj_fixed` :119 and `make_stereo_reproj_fixed` :132, the
line-only modes' edges `make_line_reproj_fixed` :173,
`make_line_angle_fixed` :188 and `make_line_angle` :208, the
KB8 fisheye's `KB8K` :500, `kb8_project_single` :511,
`make_point_reproj_kb8_fixed` :524, `make_point_reproj_kb8` :534 and
`make_point_reproj_body_ba_kb8` :544, `point_reproj_ba_for` :559,
`point_reproj_body_ba_for` :567, and the loop closer's Sim(3) pieces
`sim3_from_flat` :387, `sim3_to_flat` :392, `retract_sim3(_single)`
:396-409, `retract_sim3_4dof(_single)` :414-434 with `_SIM3_4DOF_MASK`,
`sim3_edge` :437 and `sim3_edge_4dof` :452).

A residual is `res(blocks, deltas, const) -> r` that applies its own
retraction to each block; the engine (solver/engine.py) differentiates it
with `torch.func.jacrev` (the reference: `jax.jacfwd`).  Beside
each residual stands its analytic Jacobian at delta = 0 (`*_jac`): the
formulas the kernels of csrc/ evaluate.  Tangent
order of pose_wb is [dp(3), dtheta(3)] with R <- R Exp(dtheta), p <- p +
dp; pose_cw (world->camera, the BA's keyframes) takes the left se3
perturbation T <- Exp(rho, phi) T of `lie.se3_exp`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import lie


class PinholeK(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


class KB8K(NamedTuple):
    """The Kannala-Brandt (equidistant) fisheye's intrinsics: the BA and
    pose edges of a KB8 camera project through it onto raw pixels."""
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    k3: float
    k4: float


def kb8_for(cfg) -> Optional[KB8K]:
    """The KB8K of a SystemConfig's KB8 camera, None for a pinhole one."""
    cam = cfg.camera
    if cam.model != "kb8":
        return None
    d = tuple(cam.dist) + (0.0,) * 4
    return KB8K(cam.fx, cam.fy, cam.cx, cam.cy, *d[:4])


# --------------------------------------------------------------------------
# Retractions
# --------------------------------------------------------------------------

def retract_pose_cw_single(P: torch.Tensor, d: torch.Tensor):
    R, t = P[:, :3], P[:, 3]
    dR, dt = lie.se3_exp(d)
    return dR @ R, dR @ t + dt


def retract_pose_cw(P: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Batched engine retract: [N,3,4], [N,6] -> [N,3,4]."""
    R, t = P[..., :3], P[..., 3]
    dR, dt = lie.se3_exp(d)
    Rn = dR @ R
    tn = (dR @ t[..., None])[..., 0] + dt
    return torch.cat([lie.so3_normalize(Rn), tn[..., None]], -1)


def retract_pose_wb_single(P: torch.Tensor, d: torch.Tensor):
    R, p = P[:, :3], P[:, 3]
    return R @ lie.so3_exp(d[3:]), p + d[:3]


def retract_pose_wb(P: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Batched engine retract: [N,3,4], [N,6] -> [N,3,4]."""
    R, p = P[..., :3], P[..., 3]
    Rn = lie.so3_normalize(R @ lie.so3_exp(d[..., 3:]))
    return torch.cat([Rn, (p + d[..., :3])[..., None]], -1)


def retract_additive(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return x + d


def retract_gdir(R: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Gravity direction R_wg, 2-DoF: [N,3,3], [N,2] -> R Exp(dx, dy, 0)."""
    d3 = torch.cat([d, torch.zeros_like(d[..., :1])], -1)
    return lie.so3_normalize(R @ lie.so3_exp(d3))


def retract_scale(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return s * torch.exp(d)


def _project(K: PinholeK, pc: torch.Tensor) -> torch.Tensor:
    z = torch.clamp_min(pc[2], 1e-4)
    return torch.stack([K.fx * pc[0] / z + K.cx, K.fy * pc[1] / z + K.cy])


# --------------------------------------------------------------------------
# Residuals
# --------------------------------------------------------------------------

def make_point_reproj(K: PinholeK):
    """Full BA edge (pose_cw, point) -> r [2]; const = {'uv': [2]}."""
    def res(blocks, deltas, const):
        P, X = blocks
        dp, dX = deltas
        R, t = retract_pose_cw_single(P, dp)
        return _project(K, R @ (X + dX) + t) - const["uv"]
    return res


def make_point_reproj_fixed(K: PinholeK):
    """Pose-only edge (pose_cw) -> r [2], the landmark a constant;
    const = {'uv': [2], 'X': [3]}."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (dp,) = deltas
        R, t = retract_pose_cw_single(P, dp)
        return _project(K, R @ const["X"] + t) - const["uv"]
    return res


def make_stereo_reproj_fixed(K: PinholeK, bf: float):
    """Pose-only stereo edge -> r [3] with the right-eye row u_R = u -
    bf / z (depth clamped at 1e-4); const = {'uvr': [3], 'X': [3]}."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (dp,) = deltas
        R, t = retract_pose_cw_single(P, dp)
        pc = R @ const["X"] + t
        z = torch.clamp_min(pc[2], 1e-4)
        u = K.fx * pc[0] / z + K.cx
        v = K.fy * pc[1] / z + K.cy
        ur = u - bf / z
        return torch.stack([u, v, ur]) - const["uvr"]
    return res


def kb8_project_single(K: KB8K, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame point [3] -> raw pixel [2] through the theta polynomial
    (r floored at 1e-9, the depth at 1e-6; the powers and sums in jnp's
    order).  Batched over leading dimensions too."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-18))
    theta = torch.atan2(r, torch.clamp_min(z, 1e-6))
    t2 = theta * theta
    p2 = t2 * t2
    theta_d = theta * (1.0 + K.k1 * t2 + K.k2 * p2 + K.k3 * (t2 * p2)
                       + K.k4 * (p2 * p2))
    s = theta_d / r
    return torch.stack([K.fx * x * s + K.cx, K.fy * y * s + K.cy], -1)


def make_point_reproj_kb8_fixed(K: KB8K):
    """Pose-only KB8 edge against raw pixels; const = {'uv': [2], 'X':
    [3]}."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (dp,) = deltas
        R, t = retract_pose_cw_single(P, dp)
        return kb8_project_single(K, R @ const["X"] + t) - const["uv"]
    return res


def make_point_reproj_kb8(K: KB8K):
    """Full BA KB8 edge (pose_cw, point) against raw pixels; const =
    {'uv': [2]}."""
    def res(blocks, deltas, const):
        P, X = blocks
        dp, dX = deltas
        R, t = retract_pose_cw_single(P, dp)
        return kb8_project_single(K, R @ (X + dX) + t) - const["uv"]
    return res


def point_reproj_ba_for(K):
    """The camera-model dispatch of the full-BA point edge: a KB8K camera
    optimizes the equidistant lens against raw pixels, a PinholeK one the
    undistorted projection."""
    return make_point_reproj_kb8(K) if isinstance(K, KB8K) \
        else make_point_reproj(K)


def make_line_reproj(K: PinholeK):
    """(pose_cw, line6) -> r [2]: signed distance of each projected
    endpoint to the observed normalized line l = (a, b, c), |(a, b)| = 1;
    const = {'l': [3]}."""
    def res(blocks, deltas, const):
        P, L = blocks
        dp, dL = deltas
        R, t = retract_pose_cw_single(P, dp)
        Ln = L + dL
        l = const["l"]
        r = []
        for k in range(2):
            uv = _project(K, R @ Ln[3 * k:3 * k + 3] + t)
            r.append(l[0] * uv[0] + l[1] * uv[1] + l[2])
        return torch.stack(r)
    return res


def make_line_reproj_fixed(K: PinholeK):
    """Pose-only line edge -> r [2], the endpoints constants; const =
    {'l': [3], 'Xs': [3], 'Xe': [3]}."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (dp,) = deltas
        R, t = retract_pose_cw_single(P, dp)
        l = const["l"]
        out = []
        for key in ("Xs", "Xe"):
            uv = _project(K, R @ const[key] + t)
            out.append(l[0] * uv[0] + l[1] * uv[1] + l[2])
        return torch.stack(out)
    return res


def _sin_angle(uv_s, uv_e, d_obs):
    """Sine of the angle between the projected segment's direction, the
    difference normalised by rsqrt(|d|^2 + 1e-12) (finite at d = 0, the
    padded rows), and the observed unit direction d_obs [2]."""
    d = uv_e - uv_s
    d = d * torch.rsqrt(torch.sum(d * d) + 1e-12)
    return torch.stack([d[0] * d_obs[1] - d[1] * d_obs[0]])


def make_line_angle_fixed(K: PinholeK):
    """Pose-only angle edge -> r [1]: the sine of the angle between the
    projected segment and the observed direction; const = {'dir': [2],
    'Xs': [3], 'Xe': [3]}."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (dp,) = deltas
        R, t = retract_pose_cw_single(P, dp)
        return _sin_angle(_project(K, R @ const["Xs"] + t),
                          _project(K, R @ const["Xe"] + t), const["dir"])
    return res


def make_line_angle(K: PinholeK):
    """BA angle edge (pose_cw, line6), both free -> r [1]; const = {'dir':
    [2]}."""
    def res(blocks, deltas, const):
        P, L6 = blocks
        dp, dl = deltas
        R, t = retract_pose_cw_single(P, dp)
        L6 = L6 + dl
        return _sin_angle(_project(K, R @ L6[:3] + t),
                          _project(K, R @ L6[3:] + t), const["dir"])
    return res


def make_point_reproj_body(K: PinholeK, Rcb: torch.Tensor, tcb: torch.Tensor):
    """Pose-only reprojection with the state on the body frame and a fixed
    camera-from-body extrinsic.  blocks = (pose_wb,), const = {'uv': [2],
    'X': [3] world point}."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (d,) = deltas
        R_wb, p_wb = retract_pose_wb_single(P, d)
        Xb = R_wb.T @ (const["X"] - p_wb)
        return _project(K, Rcb @ Xb + tcb) - const["uv"]
    return res


def make_stereo_reproj_body(K: PinholeK, bf: float, Rcb: torch.Tensor,
                            tcb: torch.Tensor):
    """The pose-only stereo edge on the body frame: (u, v, u_R = u - bf/z)
    against const {'uvr': [3], 'X': [3] world point}; blocks =
    (pose_wb,)."""
    def res(blocks, deltas, const):
        (P,) = blocks
        (d,) = deltas
        R_wb, p_wb = retract_pose_wb_single(P, d)
        Xb = R_wb.T @ (const["X"] - p_wb)
        pc = Rcb @ Xb + tcb
        z = torch.clamp_min(pc[2], 1e-4)
        u = K.fx * pc[0] / z + K.cx
        v = K.fy * pc[1] / z + K.cy
        ur = u - torch.full_like(z, bf) / z
        return torch.stack([u, v, ur]) - const["uvr"]
    return res


def make_point_reproj_body_ba(K: PinholeK, Rcb: torch.Tensor,
                              tcb: torch.Tensor):
    """Inertial-window BA edge (pose_wb, point), both free; const = {'uv':
    [2]}."""
    def res(blocks, deltas, const):
        P, X = blocks
        d, dX = deltas
        R_wb, p_wb = retract_pose_wb_single(P, d)
        Xb = R_wb.T @ (X + dX - p_wb)
        return _project(K, Rcb @ Xb + tcb) - const["uv"]
    return res


def make_point_reproj_body_ba_kb8(K: KB8K, Rcb: torch.Tensor,
                                  tcb: torch.Tensor):
    """Inertial-window BA edge (pose_wb, point) through the KB8 lens
    against raw pixels; const = {'uv': [2]}."""
    def res(blocks, deltas, const):
        P, X = blocks
        d, dX = deltas
        R_wb, p_wb = retract_pose_wb_single(P, d)
        Xb = R_wb.T @ (X + dX - p_wb)
        return kb8_project_single(K, Rcb @ Xb + tcb) - const["uv"]
    return res


def point_reproj_body_ba_for(K, Rcb, tcb):
    """The camera-model dispatch of the inertial-window point edge: a KB8K
    camera projects through the lens onto raw pixels, a PinholeK one
    onto undistorted pixels."""
    return make_point_reproj_body_ba_kb8(K, Rcb, tcb) \
        if isinstance(K, KB8K) else make_point_reproj_body_ba(K, Rcb, tcb)


def make_line_reproj_body_ba(K: PinholeK, Rcb: torch.Tensor,
                             tcb: torch.Tensor):
    """Inertial-window line edge (pose_wb, line6), both free: the signed
    distance of each projected endpoint to the observed line; const =
    {'l': [3]}."""
    def res(blocks, deltas, const):
        P, L = blocks
        dp, dL = deltas
        R_wb, p_wb = retract_pose_wb_single(P, dp)
        Ln = L + dL
        l = const["l"]
        r = []
        for k in range(2):
            pc = Rcb @ (R_wb.T @ (Ln[3 * k:3 * k + 3] - p_wb)) + tcb
            uv = _project(K, pc)
            r.append(l[0] * uv[0] + l[1] * uv[1] + l[2])
        return torch.stack(r)
    return res


def state_prior(blocks, deltas, const):
    """Absolute prior on an additive block: r = x - x0."""
    (x,) = blocks
    (dx,) = deltas
    return x + dx - const["x0"]


def make_inertial_gs(gravity: float = 9.81):
    """IMU-initialization edge, poses fixed: blocks = (gdir R_wg, scale
    [1], bias_g, bias_a, vel1, vel2); const = the preintegration fields +
    {'R1','p1','R2','p2'}."""
    def res(blocks, deltas, const):
        Rwg, s, bg, ba, v1, v2 = blocks
        dg, ds, dbg_, dba_, dv1, dv2 = deltas
        g0 = torch.tensor([0.0, 0.0, -gravity], dtype=v1.dtype,
                          device=v1.device)
        Rwg = retract_gdir(Rwg, dg)
        s = (s * torch.exp(ds))[0]
        v1 = v1 + dv1
        v2 = v2 + dv2
        dbg = bg + dbg_ - const["bg0"]
        dba = ba + dba_ - const["ba0"]
        g_w = Rwg @ g0
        dT = const["dT"]
        R1, p1, R2, p2 = const["R1"], const["p1"], const["R2"], const["p2"]
        dR_corr = const["dR"] @ lie.so3_exp(const["JRg"] @ dbg)
        dV_corr = const["dV"] + const["JVg"] @ dbg + const["JVa"] @ dba
        dP_corr = const["dP"] + const["JPg"] @ dbg + const["JPa"] @ dba
        er = lie.so3_log(dR_corr.T @ R1.T @ R2)
        ev = R1.T @ (s * (v2 - v1) - g_w * dT) - dV_corr
        ep = R1.T @ (s * (p2 - p1 - v1 * dT) - 0.5 * g_w * dT * dT) - dP_corr
        return torch.cat([er, ev, ep])
    return res


def make_inertial(gravity: float = 9.81):
    """blocks = (pose_wb1, vel1, bias_g, bias_a, pose_wb2, vel2); const =
    {'dT','dR','dV','dP','JRg','JVg','JVa','JPg','JPa','bg0','ba0'}."""
    def res(blocks, deltas, const):
        P1, v1, bg, ba, P2, v2 = blocks
        dP1, dv1, dbg_, dba_, dP2, dv2 = deltas
        g_w = torch.tensor([0.0, 0.0, -gravity], dtype=v1.dtype,
                           device=v1.device)
        R1, p1 = retract_pose_wb_single(P1, dP1)
        R2, p2 = retract_pose_wb_single(P2, dP2)
        v1 = v1 + dv1
        v2 = v2 + dv2
        dbg = bg + dbg_ - const["bg0"]
        dba = ba + dba_ - const["ba0"]
        dT = const["dT"]
        dR_corr = const["dR"] @ lie.so3_exp(const["JRg"] @ dbg)
        dV_corr = const["dV"] + const["JVg"] @ dbg + const["JVa"] @ dba
        dP_corr = const["dP"] + const["JPg"] @ dbg + const["JPa"] @ dba
        er = lie.so3_log(dR_corr.T @ R1.T @ R2)
        ev = R1.T @ (v2 - v1 - g_w * dT) - dV_corr
        ep = R1.T @ (p2 - p1 - v1 * dT - 0.5 * g_w * dT * dT) - dP_corr
        return torch.cat([er, ev, ep])
    return res


def bias_rw(blocks, deltas, const):
    """Random walk between consecutive biases."""
    b1, b2 = blocks
    d1, d2 = deltas
    return (b2 + d2) - (b1 + d1)


def make_prior15():
    """Marginalization prior on (pose_wb, vel, bg, ba); const = {'R0',
    'p0','v0','bg0','ba0'}."""
    def res(blocks, deltas, const):
        P, v, bg, ba = blocks
        dP, dv, dbg, dba = deltas
        R, p = retract_pose_wb_single(P, dP)
        return torch.cat([lie.so3_log(const["R0"].T @ R), p - const["p0"],
                          (v + dv) - const["v0"], (bg + dbg) - const["bg0"],
                          (ba + dba) - const["ba0"]])
    return res


# --------------------------------------------------------------------------
# Analytic Jacobians at delta = 0 (the kernel's formulas)
# --------------------------------------------------------------------------

def point_reproj_body_jac(K: PinholeK, Rcb, tcb, P, X, uv):
    """Batched body-frame reprojection: P [3,4] pose_wb, X [N,3], uv [N,2]
    -> (r [N,2], J [N,2,6]) w.r.t. [dp, dtheta].  dXb/dp = -R^T,
    dXb/dtheta = hat(Xb); the depth derivative is 0 where z is clamped."""
    R, p = P[:, :3], P[:, 3]
    Xb = (X - p) @ R                                  # R^T (X - p)
    pc = Xb @ Rcb.T + tcb
    z = torch.clamp_min(pc[:, 2], 1e-4)
    r = torch.stack([K.fx * pc[:, 0] / z + K.cx,
                     K.fy * pc[:, 1] / z + K.cy], -1) - uv
    iz = 1.0 / z
    dz = (pc[:, 2] > 1e-4).to(pc.dtype)
    zero = torch.zeros_like(z)
    Jpi = torch.stack([
        torch.stack([K.fx * iz, zero, -K.fx * pc[:, 0] * iz * iz * dz], -1),
        torch.stack([zero, K.fy * iz, -K.fy * pc[:, 1] * iz * iz * dz], -1),
    ], 1)                                             # [N,2,3]
    JR = Jpi @ Rcb                                    # d r / d Xb
    J = torch.cat([-(JR @ R.T), JR @ lie.hat(Xb)], -1)
    return r, J


def stereo_reproj_body_jac(K: PinholeK, bf: float, Rcb, tcb, P, X, uvr):
    """Batched `make_stereo_reproj_body` at delta = 0: P [3,4] pose_wb, X
    [N,3], uvr [N,3] -> (r [N,3], J [N,3,6]) w.r.t. [dp, dtheta]; the u_R
    row is d(u - bf/z)/dpc = [fx/z, 0, (-fx x + bf)/z^2] (no depth
    derivative where z is clamped)."""
    R, p = P[:, :3], P[:, 3]
    Xb = (X - p) @ R
    pc = Xb @ Rcb.T + tcb
    z = torch.clamp_min(pc[:, 2], 1e-4)
    u = K.fx * pc[:, 0] / z + K.cx
    v = K.fy * pc[:, 1] / z + K.cy
    r = torch.stack([u, v, u - torch.full_like(z, bf) / z], -1) - uvr
    iz = 1.0 / z
    dz = (pc[:, 2] > 1e-4).to(pc.dtype)
    zero = torch.zeros_like(z)
    Jpi = torch.stack([
        torch.stack([K.fx * iz, zero, -K.fx * pc[:, 0] * iz * iz * dz], -1),
        torch.stack([zero, K.fy * iz, -K.fy * pc[:, 1] * iz * iz * dz], -1),
        torch.stack([K.fx * iz, zero,
                     (-K.fx * pc[:, 0] + bf) * iz * iz * dz], -1),
    ], 1)                                             # [N,3,3]
    JR = Jpi @ Rcb
    J = torch.cat([-(JR @ R.T), JR @ lie.hat(Xb)], -1)
    return r, J


def _proj_jac_clamped(K: PinholeK, pc: torch.Tensor):
    """(uv [N,2], d uv / d pc [N,2,3]) of the projection with the depth
    clamped at 1e-4 (no depth derivative where it is clamped)."""
    z = torch.clamp_min(pc[:, 2], 1e-4)
    uv = torch.stack([K.fx * pc[:, 0] / z + K.cx,
                      K.fy * pc[:, 1] / z + K.cy], -1)
    iz = 1.0 / z
    dz = (pc[:, 2] > 1e-4).to(pc.dtype)
    zero = torch.zeros_like(z)
    Jpi = torch.stack([
        torch.stack([K.fx * iz, zero, -K.fx * pc[:, 0] * iz * iz * dz], -1),
        torch.stack([zero, K.fy * iz, -K.fy * pc[:, 1] * iz * iz * dz], -1),
    ], 1)
    return uv, Jpi


def kb8_proj_jac(K: KB8K, pc: torch.Tensor):
    """(uv [N,2], d uv / d pc [N,2,3]) of `kb8_project_single`, analytic:
    with r = sqrt(max(x^2 + y^2, 1e-18)), zc = max(z, 1e-6), theta =
    atan2(r, zc), theta_d = theta P(theta^2), s = theta_d / r:
    d theta / d r = zc / (r^2 + zc^2), d theta / d zc = -r / (r^2 + zc^2),
    d theta_d / d theta = 1 + 3 k1 t2 + 5 k2 t2^2 + 7 k3 t2^3 + 9 k4 t2^4,
    u = fx x s + cx.  No r derivative where r is floored (r -> 0) and no
    depth derivative where the depth is clamped."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp_min(r2, 1e-18))
    zc = torch.clamp_min(z, 1e-6)
    theta = torch.atan2(r, zc)
    t2 = theta * theta
    p2 = t2 * t2
    p3 = t2 * p2
    p4 = p2 * p2
    theta_d = theta * (1.0 + K.k1 * t2 + K.k2 * p2 + K.k3 * p3 + K.k4 * p4)
    dtd = 1.0 + 3.0 * K.k1 * t2 + 5.0 * K.k2 * p2 + 7.0 * K.k3 * p3 \
        + 9.0 * K.k4 * p4
    s = theta_d / r
    den = r * r + zc * zc
    ds_dr = (dtd * zc / den * r - theta_d) / (r * r)
    ds_dz = dtd * (-r / den) / r * (z > 1e-6).to(pc.dtype)
    on = (r2 > 1e-18).to(pc.dtype)
    dr_dx, dr_dy = x / r * on, y / r * on
    uv = torch.stack([K.fx * x * s + K.cx, K.fy * y * s + K.cy], -1)
    J = torch.stack([
        torch.stack([K.fx * (s + x * ds_dr * dr_dx), K.fx * x * ds_dr * dr_dy,
                     K.fx * x * ds_dz], -1),
        torch.stack([K.fy * y * ds_dr * dr_dx, K.fy * (s + y * ds_dr * dr_dy),
                     K.fy * y * ds_dz], -1)], 1)
    return uv, J


def point_reproj_kb8_jac(K: KB8K, P, X, uv):
    """Batched `make_point_reproj_kb8` at delta = 0 (the `ba_linearize`
    kernel's KB8 mode): P [N,3,4] pose_cw, X [N,3], uv [N,2] -> (r [N,2],
    J_pose [N,2,6], J_point [N,2,3])."""
    R, t = P[..., :3], P[..., 3]
    pc = (R @ X[..., None])[..., 0] + t
    proj, Jpi = kb8_proj_jac(K, pc)
    Jp = torch.cat([Jpi, -Jpi @ lie.hat(pc)], -1)
    return proj - uv, Jp, Jpi @ R


def point_reproj_jac(K: PinholeK, P, X, uv):
    """Batched `make_point_reproj` at delta = 0: P [N,3,4] pose_cw, X
    [N,3], uv [N,2] -> (r [N,2], J_pose [N,2,6], J_point [N,2,3]).  With
    pc = R X + t, d pc / d rho = I, d pc / d phi = -hat(pc) (left
    perturbation), d pc / d X = R."""
    R, t = P[..., :3], P[..., 3]
    pc = (R @ X[..., None])[..., 0] + t
    proj, Jpi = _proj_jac_clamped(K, pc)
    Jp = torch.cat([Jpi, -Jpi @ lie.hat(pc)], -1)
    return proj - uv, Jp, Jpi @ R


def line_reproj_fixed_jac(K: PinholeK, P, Xs, Xe, l):
    """Batched `make_line_reproj_fixed` at delta = 0: P [N,3,4], Xs, Xe
    [N,3], l [N,3] -> (r [N,2], J_pose [N,2,6])."""
    r, Jp, _ = line_reproj_jac(K, P, torch.cat([Xs, Xe], -1), l)
    return r, Jp


def line_angle_jac(K: PinholeK, P, L, d_obs):
    """Batched `make_line_angle` at delta = 0 (the kernels' angle row):
    P [N,3,4], L [N,6], d_obs [N,2] -> (r [N,1], J_pose [N,1,6], J_line
    [N,1,6]).  With d = uv_e - uv_s, n = (|d|^2 + 1e-12)^-1/2 and r =
    n (d x d_obs): d r / d d = n g - n^3 (d . g) d, g = (d_obs[1],
    -d_obs[0]); the endpoints enter as d uv_e / d . - d uv_s / d ., each
    through the pinhole rows of `line_reproj_jac`."""
    R, t = P[..., :3], P[..., 3]
    uvs, rows = [], []
    for k in range(2):
        pc = (R @ L[:, 3 * k:3 * k + 3, None])[..., 0] + t
        proj, Jpi = _proj_jac_clamped(K, pc)
        uvs.append(proj)
        rows.append((Jpi, pc))
    d = uvs[1] - uvs[0]
    n = torch.rsqrt((d * d).sum(-1) + 1e-12)
    g = torch.stack([d_obs[:, 1], -d_obs[:, 0]], -1)
    r = n * (d * g).sum(-1)
    dr_dd = n[:, None] * g - (n ** 3 * (d * g).sum(-1))[:, None] * d
    Jps, Jls = [], []
    for k, (Jpi, pc) in enumerate(rows):
        jrow = (dr_dd[:, None, :] @ Jpi) * (1.0 if k else -1.0)
        Jps.append(torch.cat([jrow, -jrow @ lie.hat(pc)], -1))
        Jls.append(jrow @ R)
    return r[:, None], Jps[0] + Jps[1], torch.cat(Jls, -1)


def point_reproj_body_ba_kb8_jac(K: KB8K, Rcb, tcb, P, X, uv):
    """Batched `make_point_reproj_body_ba_kb8` at delta = 0 (the kernels'
    body-KB8 mode): P [N,3,4] pose_wb, X [N,3], uv [N,2] -> (r [N,2],
    J_pose [N,2,6], J_point [N,2,3]); the lens rows of `kb8_proj_jac`
    through the body rows of `_body_rows`."""
    R, p = P[..., :3], P[..., 3]
    Xb = ((X - p)[:, None, :] @ R)[:, 0]
    proj, Jpi = kb8_proj_jac(K, Xb @ Rcb.T + tcb)
    Jp, JX = _body_rows(Jpi, Rcb, R, Xb)
    return proj - uv, Jp, JX


def line_reproj_jac(K: PinholeK, P, L, l):
    """Batched `make_line_reproj` at delta = 0: P [N,3,4], L [N,6], l
    [N,3] -> (r [N,2], J_pose [N,2,6], J_line [N,2,6]); row k depends on
    endpoint k only."""
    R, t = P[..., :3], P[..., 3]
    rs, Jps, Jls = [], [], []
    zero3 = torch.zeros_like(L[:, None, :3])
    for k in range(2):
        pc = (R @ L[:, 3 * k:3 * k + 3, None])[..., 0] + t
        proj, Jpi = _proj_jac_clamped(K, pc)
        rs.append(l[:, 0] * proj[:, 0] + l[:, 1] * proj[:, 1] + l[:, 2])
        jrow = l[:, None, 0:1] * Jpi[:, 0:1] + l[:, None, 1:2] * Jpi[:, 1:2]
        Jps.append(torch.cat([jrow, -jrow @ lie.hat(pc)], -1))
        jl = jrow @ R
        Jls.append(torch.cat([jl, zero3] if k == 0 else [zero3, jl], -1))
    return (torch.stack(rs, -1), torch.cat(Jps, 1), torch.cat(Jls, 1))


def inertial_jac(gravity: float, blocks, const):
    """(r [9], J [9,24]) of `make_inertial` with columns [pose1(6), v1(3),
    bg(3), ba(3), pose2(6), v2(3)]."""
    P1, v1, bg, ba, P2, v2 = blocks
    dev, dt_ = v1.device, v1.dtype
    g_w = torch.tensor([0.0, 0.0, -gravity], dtype=dt_, device=dev)
    R1, p1, R2, p2 = P1[:, :3], P1[:, 3], P2[:, :3], P2[:, 3]
    dbg = bg - const["bg0"]
    dba = ba - const["ba0"]
    dT = const["dT"]
    phi = const["JRg"] @ dbg
    dR_corr = const["dR"] @ lie.so3_exp(phi)
    E = dR_corr.T @ R1.T @ R2
    er = lie.so3_log(E)
    av = v2 - v1 - g_w * dT
    ap = p2 - p1 - v1 * dT - 0.5 * g_w * dT * dT
    ev = R1.T @ av - (const["dV"] + const["JVg"] @ dbg
                      + const["JVa"] @ dba)
    ep = R1.T @ ap - (const["dP"] + const["JPg"] @ dbg
                      + const["JPa"] @ dba)
    Jri = lie.so3_right_jacobian_inv(er)
    Jr = lie.so3_right_jacobian(phi)
    Z = torch.zeros(3, 3, dtype=dt_, device=dev)
    R1t = R1.T
    rows_r = [Z, -Jri @ R2.T @ R1, Z, -Jri @ E.T @ Jr @ const["JRg"], Z,
              Z, Jri, Z]
    rows_v = [Z, lie.hat(R1t @ av), -R1t, -const["JVg"], -const["JVa"],
              Z, Z, R1t]
    rows_p = [-R1t, lie.hat(R1t @ ap), -R1t * dT, -const["JPg"],
              -const["JPa"], R1t, Z, Z]
    J = torch.cat([torch.cat(rows_r, 1), torch.cat(rows_v, 1),
                   torch.cat(rows_p, 1)], 0)
    return torch.cat([er, ev, ep]), J


def _body_rows(jr, Rcb, R, Xb):
    """Row(s) jr = d r / d pc [N,k,3] of a body-frame edge -> (d r / d
    pose_wb [N,k,6], d r / d X [N,k,3]): with JR = jr Rcb (d r / d Xb), d
    Xb / d dp = -R^T, d Xb / d dtheta = hat(Xb), d Xb / d X = R^T."""
    JR = jr @ Rcb
    JX = JR @ R.transpose(-1, -2)
    return torch.cat([-JX, JR @ lie.hat(Xb)], -1), JX


def point_reproj_body_ba_jac(K: PinholeK, Rcb, tcb, P, X, uv):
    """Batched `make_point_reproj_body_ba` at delta = 0: P [N,3,4] pose_wb,
    X [N,3], uv [N,2] -> (r [N,2], J_pose [N,2,6], J_point [N,2,3])."""
    R, p = P[..., :3], P[..., 3]
    Xb = ((X - p)[:, None, :] @ R)[:, 0]              # R^T (X - p)
    proj, Jpi = _proj_jac_clamped(K, Xb @ Rcb.T + tcb)
    Jp, JX = _body_rows(Jpi, Rcb, R, Xb)
    return proj - uv, Jp, JX


def line_reproj_body_ba_jac(K: PinholeK, Rcb, tcb, P, L, l):
    """Batched `make_line_reproj_body_ba` at delta = 0: P [N,3,4], L [N,6],
    l [N,3] -> (r [N,2], J_pose [N,2,6], J_line [N,2,6]); row k depends on
    endpoint k only."""
    R, p = P[..., :3], P[..., 3]
    rs, Jps, Jls = [], [], []
    zero3 = torch.zeros_like(L[:, None, :3])
    for k in range(2):
        Xb = ((L[:, 3 * k:3 * k + 3] - p)[:, None, :] @ R)[:, 0]
        proj, Jpi = _proj_jac_clamped(K, Xb @ Rcb.T + tcb)
        rs.append(l[:, 0] * proj[:, 0] + l[:, 1] * proj[:, 1] + l[:, 2])
        jrow = l[:, None, 0:1] * Jpi[:, 0:1] + l[:, None, 1:2] * Jpi[:, 1:2]
        Jp, JX = _body_rows(jrow, Rcb, R, Xb)
        Jps.append(Jp)
        Jls.append(torch.cat([JX, zero3] if k == 0 else [zero3, JX], -1))
    return (torch.stack(rs, -1), torch.cat(Jps, 1), torch.cat(Jls, 1))


def retract_gdir_jac(R):
    """d R Exp(d, 0) / d d at d = 0: R [3,3] -> [3,3,2] (R hat(e_0), R
    hat(e_1))."""
    E = torch.eye(3, dtype=R.dtype, device=R.device)[:2]
    return torch.stack([R @ lie.hat(e) for e in E], -1)


def retract_scale_jac(s):
    """d s exp(d) / d d at d = 0."""
    return s


def state_prior_jac(blocks, const):
    """(r [n], J [n,n] = I) of `state_prior`."""
    (x,) = blocks
    return x - const["x0"], torch.eye(x.shape[-1], dtype=x.dtype,
                                      device=x.device)


def inertial_gs_jac(gravity: float, blocks, const):
    """(r [9], J [9,15]) of `make_inertial_gs` with columns [gdir(2),
    scale(1), bg(3), ba(3), v1(3), v2(3)]: d g_w / d gdir = -R_wg
    hat(g0)[:, :2], d s / d ds = s; the rotation rows as in
    `inertial_jac`."""
    Rwg, s, bg, ba, v1, v2 = blocks
    dev, dt_ = v1.device, v1.dtype
    g0 = torch.tensor([0.0, 0.0, -gravity], dtype=dt_, device=dev)
    s = s[0]
    dbg = bg - const["bg0"]
    dba = ba - const["ba0"]
    dT = const["dT"]
    R1, p1, R2, p2 = const["R1"], const["p1"], const["R2"], const["p2"]
    g_w = Rwg @ g0
    phi = const["JRg"] @ dbg
    E = (const["dR"] @ lie.so3_exp(phi)).T @ R1.T @ R2
    er = lie.so3_log(E)
    dv = v2 - v1
    dp = p2 - p1 - v1 * dT
    R1t = R1.T
    ev = R1t @ (s * dv - g_w * dT) - (const["dV"] + const["JVg"] @ dbg
                                      + const["JVa"] @ dba)
    ep = R1t @ (s * dp - 0.5 * g_w * dT * dT) - (const["dP"]
                                                 + const["JPg"] @ dbg
                                                 + const["JPa"] @ dba)
    Jri = lie.so3_right_jacobian_inv(er)
    Jr = lie.so3_right_jacobian(phi)
    Gg = (R1t @ Rwg @ lie.hat(g0))[:, :2]           # d (-R1^T g_w) / d gdir
    Z2 = torch.zeros(3, 2, dtype=dt_, device=dev)
    Z1 = torch.zeros(3, 1, dtype=dt_, device=dev)
    Z = torch.zeros(3, 3, dtype=dt_, device=dev)
    rows_r = [Z2, Z1, -Jri @ E.T @ Jr @ const["JRg"], Z, Z, Z]
    rows_v = [Gg * dT, (R1t @ (s * dv))[:, None], -const["JVg"],
              -const["JVa"], -s * R1t, s * R1t]
    rows_p = [Gg * (0.5 * dT * dT), (R1t @ (s * dp))[:, None], -const["JPg"],
              -const["JPa"], -s * dT * R1t, Z]
    J = torch.cat([torch.cat(rows_r, 1), torch.cat(rows_v, 1),
                   torch.cat(rows_p, 1)], 0)
    return torch.cat([er, ev, ep]), J


def bias_rw_jac(blocks):
    """(r [3], J [3,6]) of `bias_rw`: columns [b1, b2]."""
    b1, b2 = blocks
    I3 = torch.eye(3, dtype=b1.dtype, device=b1.device)
    return b2 - b1, torch.cat([-I3, I3], 1)


def prior15_jac(blocks, const):
    """(r [15], J [15,15]) of `make_prior15`: columns [pose(6), v, bg,
    ba]; the rotation block is Jr^{-1}(er), the rest identity."""
    P, v, bg, ba = blocks
    er = lie.so3_log(const["R0"].T @ P[:, :3])
    r = torch.cat([er, P[:, 3] - const["p0"], v - const["v0"],
                   bg - const["bg0"], ba - const["ba0"]])
    J = torch.zeros(15, 15, dtype=v.dtype, device=v.device)
    J[0:3, 3:6] = lie.so3_right_jacobian_inv(er)
    J[3:6, 0:3] = torch.eye(3, dtype=v.dtype, device=v.device)
    J[6:, 6:] = torch.eye(9, dtype=v.dtype, device=v.device)
    return r, J


# --------------------------------------------------------------------------
# Sim(3) states and the essential graph's edge (vertices S_iw, world ->
# keyframe similarities; storage [13] = R (9, row-major), t (3), s)
# --------------------------------------------------------------------------

def sim3_from_flat(S: torch.Tensor):
    return S[..., :9].reshape(S.shape[:-1] + (3, 3)), S[..., 9:12], \
        S[..., 12]


def sim3_to_flat(R, t, s):
    return torch.cat([R.reshape(R.shape[:-2] + (9,)), t, s[..., None]], -1)


def retract_sim3_single(S: torch.Tensor, d: torch.Tensor):
    """Left perturbation S <- Exp(d) S."""
    R, t, s = sim3_from_flat(S)
    dR, dt, ds = lie.sim3_exp(d)
    return dR @ R, ds * (dR @ t) + dt, ds * s


def retract_sim3(S: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Batched engine retract [N,13], [N,7] -> [N,13], the rotation
    re-orthonormalized."""
    R, t, s = sim3_from_flat(S)
    dR, dt, ds = lie.sim3_exp(d)
    return sim3_to_flat(lie.so3_normalize(dR @ R),
                        ds[..., None] * (dR @ t[..., None])[..., 0] + dt,
                        ds * s)


# rho and the world yaw free; roll, pitch and sigma frozen
SIM3_4DOF_MASK = (1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0)


def _mask4(d: torch.Tensor) -> torch.Tensor:
    return d * torch.tensor(SIM3_4DOF_MASK, dtype=d.dtype, device=d.device)


def retract_sim3_4dof_single(S: torch.Tensor, d: torch.Tensor):
    """World-frame (right) perturbation S <- S Exp(d_masked): translation
    and yaw about the world z (gravity) axis, scale pinned."""
    R, t, s = sim3_from_flat(S)
    dR, dt, _ = lie.sim3_exp(_mask4(d))
    return R @ dR, s * (R @ dt) + t, s


def retract_sim3_4dof(S: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    R, t, s = sim3_from_flat(S)
    dR, dt, _ = lie.sim3_exp(_mask4(d))
    return sim3_to_flat(lie.so3_normalize(R @ dR),
                        s[..., None] * (R @ dt[..., None])[..., 0] + t, s)


def _edge(retract, blocks, deltas, const):
    Ri, ti, si = retract(blocks[0], deltas[0])
    Rj, tj, sj = retract(blocks[1], deltas[1])
    Rj_inv, tj_inv, sj_inv = lie.sim3_inv(Rj, tj, sj)
    R1, t1, s1 = lie.sim3_mul(Ri, ti, si, Rj_inv, tj_inv, sj_inv)
    R2, t2, s2 = lie.sim3_mul(const["Rji"], const["tji"], const["sji"],
                              R1, t1, s1)
    return lie.sim3_log(R2, t2, s2)


def sim3_edge(blocks, deltas, const):
    """r [7] = log(S_ji_meas S_i S_j^{-1}); const {'Rji', 'tji', 'sji'}."""
    return _edge(retract_sim3_single, blocks, deltas, const)


def sim3_edge_4dof(blocks, deltas, const):
    """`sim3_edge` with both perturbations restricted to world
    translation and yaw, scale pinned."""
    return _edge(retract_sim3_4dof_single, blocks, deltas, const)
