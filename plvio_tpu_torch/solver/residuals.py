"""Residuals ("edges") of the VI pose optimizer and their retractions
(port of plvio_tpu/solver/residuals.py: `PinholeK` :90,
`retract_pose_wb_single` :56, `retract_pose_wb` :61, `retract_additive`
:68, `make_point_reproj_body` :248, `make_inertial` :318, `bias_rw` :466,
`make_prior15` :474).

A residual is `res(blocks, deltas, const) -> r` that applies its own
retraction to each block; the engine (solver/engine.py) differentiates it
with `torch.func.jacfwd`, as the reference does with `jax.jacfwd`.  Beside
each residual stands its analytic Jacobian at delta = 0 (`*_jac`): the
formulas csrc/vi_pose_lm.cu evaluates.  Tangent order of pose_wb is
[dp(3), dtheta(3)] with R <- R Exp(dtheta), p <- p + dp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lie


class PinholeK(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


# --------------------------------------------------------------------------
# Retractions
# --------------------------------------------------------------------------

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


def _project(K: PinholeK, pc: torch.Tensor) -> torch.Tensor:
    z = torch.clamp_min(pc[2], 1e-4)
    return torch.stack([K.fx * pc[0] / z + K.cx, K.fy * pc[1] / z + K.cy])


# --------------------------------------------------------------------------
# Residuals
# --------------------------------------------------------------------------

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
