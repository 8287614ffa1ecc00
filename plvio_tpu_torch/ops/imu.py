"""On-manifold IMU preintegration and state prediction (port of
plvio_tpu/ops/imu.py: `ImuCalib`, `make_calib`, `Preintegrated`,
`identity_preintegrated`, `preintegrate`, `delta_rotation`,
`delta_velocity`, `delta_position`, `predict_state`).

`imu_preint` is the hand-written CUDA kernel (csrc/imu_preint.cu) of the VI
frame's IMU stage: preintegration of the frame's sample window, the state
prediction and the information `inv(C[:9,:9] + 1e-8 I)` of the inertial
edge, in one launch.  `imu_preint_plain` beside it is the same stage in
plain PyTorch (`torch.linalg.inv`, an LU solve, as the reference's
`jnp.linalg.inv`).

Covariance order: [dR(3), dV(3), dP(3), bg(3), ba(3)].
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda
from ..utils import lie


class ImuCalib(NamedTuple):
    """Noise densities scaled to per-sample sigmas (float32 values)."""
    sigma_gyro: float
    sigma_acc: float
    walk_gyro: float
    walk_acc: float
    Rbc: np.ndarray          # [3,3] float32 body-from-camera rotation
    tbc: np.ndarray          # [3] float32
    gravity: float


def make_calib(cfg) -> ImuCalib:
    """From a plvio_tpu_torch.config.ImuConfig (values rounded to float32, as
    the reference's jnp.float32 scalars)."""
    sf = float(np.sqrt(cfg.frequency))
    Tbc = cfg.Tbc_matrix()

    def f32(x):
        return float(np.float32(x))

    return ImuCalib(
        sigma_gyro=f32(cfg.noise_gyro * sf), sigma_acc=f32(cfg.noise_acc * sf),
        walk_gyro=f32(cfg.gyro_walk / sf), walk_acc=f32(cfg.acc_walk / sf),
        Rbc=np.asarray(Tbc[:3, :3], np.float32),
        tbc=np.asarray(Tbc[:3, 3], np.float32), gravity=f32(cfg.gravity))


class Preintegrated(NamedTuple):
    """Preintegrated measurement between two frames."""
    dT: torch.Tensor      # scalar total time
    dR: torch.Tensor      # [3,3]
    dV: torch.Tensor      # [3]
    dP: torch.Tensor      # [3]
    JRg: torch.Tensor     # [3,3] d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor       # [15,15]
    bias_gyro: torch.Tensor   # [3] linearization-point bias
    bias_acc: torch.Tensor
    avg_a: torch.Tensor   # [3] mean raw accel
    avg_w: torch.Tensor


def identity_preintegrated(bias_gyro=None, bias_acc=None,
                           device="cuda") -> Preintegrated:
    device = cuda.resolve_device(device)
    z3 = torch.zeros(3, device=device)
    z33 = torch.zeros(3, 3, device=device)
    return Preintegrated(
        dT=torch.zeros((), device=device), dR=torch.eye(3, device=device),
        dV=z3, dP=z3, JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        C=torch.zeros(15, 15, device=device),
        bias_gyro=z3 if bias_gyro is None else bias_gyro,
        bias_acc=z3 if bias_acc is None else bias_acc, avg_a=z3, avg_w=z3)


def _noise_diag(a: float, b: float, dev) -> torch.Tensor:
    """diag of [a^2]*3 + [b^2]*3, squared in float32."""
    v = torch.tensor([a] * 3 + [b] * 3, dtype=torch.float32, device=dev)
    return torch.diag(v ** 2)


def preintegrate(gyro, acc, dt, mask, calib: ImuCalib, bias_gyro,
                 bias_acc) -> Preintegrated:
    """Integrate a padded batch of IMU samples (gyro/acc [K,3], dt [K],
    mask [K] bool) at the linearization-point biases: midpoint-free
    forward Euler with the OLD dR for dP/dV and the bias Jacobians, A/B
    noise propagation on [dR dV dP], random-walk growth of the bias
    block; padded samples leave the state untouched."""
    dev = gyro.device
    f32 = torch.float32
    Nga = _noise_diag(calib.sigma_gyro, calib.sigma_acc, dev)
    NgaWalk = _noise_diag(calib.walk_gyro, calib.walk_acc, dev)
    I3 = torch.eye(3, dtype=f32, device=dev)
    z3 = torch.zeros(3, dtype=f32, device=dev)
    dR, dV, dP = I3, z3, z3
    JRg = JVg = JVa = JPg = JPa = torch.zeros(3, 3, dtype=f32, device=dev)
    C = torch.zeros(15, 15, dtype=f32, device=dev)
    T = torch.zeros((), dtype=f32, device=dev)
    sum_a, sum_w = z3, z3
    n = torch.zeros((), dtype=f32, device=dev)
    gyro, acc, dt = gyro.to(f32), acc.to(f32), dt.to(f32)
    for k in range(gyro.shape[0]):
        w, a, m = gyro[k], acc[k], mask[k]
        dti = torch.where(m, dt[k], torch.zeros_like(dt[k]))
        a_hat = a - bias_acc
        w_hat = w - bias_gyro
        dt2 = dti * dti
        dRa = dR @ a_hat
        dP_new = dP + dV * dti + 0.5 * dRa * dt2
        dV_new = dV + dRa * dti
        dRWa = dR @ lie.hat(a_hat)
        A = torch.eye(9, dtype=f32, device=dev)
        B = torch.zeros(9, 6, dtype=f32, device=dev)
        A[3:6, 0:3] = -dti * dRWa
        A[6:9, 0:3] = -0.5 * dt2 * dRWa
        A[6:9, 3:6] = dti * I3
        B[3:6, 3:6] = dti * dR
        B[6:9, 3:6] = 0.5 * dt2 * dR
        JPa_new = JPa + JVa * dti - 0.5 * dt2 * dR
        JPg_new = JPg + JVg * dti - 0.5 * dt2 * dRWa @ JRg
        JVa_new = JVa - dti * dR
        JVg_new = JVg - dti * dRWa @ JRg
        phi = w_hat * dti
        dRi = lie.so3_exp(phi)
        rightJ = lie.so3_right_jacobian(phi)
        A[0:3, 0:3] = dRi.T
        B[0:3, 0:3] = rightJ * dti
        dR_new = lie.so3_normalize(dR @ dRi)
        JRg_new = dRi.T @ JRg - rightJ * dti
        C_new = C.clone()
        C_new[:9, :9] = A @ C[:9, :9] @ A.T + B @ Nga @ B.T
        C_new[9:, 9:] = C[9:, 9:] + NgaWalk

        def keep(new, old):
            return torch.where(m, new, old)

        dR, dV, dP = keep(dR_new, dR), keep(dV_new, dV), keep(dP_new, dP)
        JRg, JVg, JVa = keep(JRg_new, JRg), keep(JVg_new, JVg), \
            keep(JVa_new, JVa)
        JPg, JPa, C = keep(JPg_new, JPg), keep(JPa_new, JPa), \
            keep(C_new, C)
        T = T + dti
        sum_a = sum_a + torch.where(m, a, torch.zeros_like(a))
        sum_w = sum_w + torch.where(m, w, torch.zeros_like(w))
        n = n + m.to(f32)
    n = torch.clamp_min(n, 1.0)
    return Preintegrated(dT=T, dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg,
                         JVa=JVa, JPg=JPg, JPa=JPa, C=C, bias_gyro=bias_gyro,
                         bias_acc=bias_acc, avg_a=sum_a / n, avg_w=sum_w / n)


def delta_rotation(p: Preintegrated, bias_gyro) -> torch.Tensor:
    dbg = bias_gyro - p.bias_gyro
    return lie.so3_normalize(p.dR @ lie.so3_exp(p.JRg @ dbg))


def delta_velocity(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    dbg, dba = bias_gyro - p.bias_gyro, bias_acc - p.bias_acc
    return p.dV + p.JVg @ dbg + p.JVa @ dba


def delta_position(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    dbg, dba = bias_gyro - p.bias_gyro, bias_acc - p.bias_acc
    return p.dP + p.JPg @ dbg + p.JPa @ dba


def predict_state(p: Preintegrated, R1, v1, p1, gravity_w):
    """Forward prediction of the body state: returns (R2, v2, p2)."""
    dT = p.dT
    R2 = lie.so3_normalize(R1 @ delta_rotation(p, p.bias_gyro))
    v2 = v1 + gravity_w * dT + R1 @ delta_velocity(p, p.bias_gyro,
                                                   p.bias_acc)
    p2 = p1 + v1 * dT + 0.5 * gravity_w * dT * dT \
        + R1 @ delta_position(p, p.bias_gyro, p.bias_acc)
    return R2, v2, p2


class ImuFrame(NamedTuple):
    """What the VI frame needs of its IMU window."""
    pre: Preintegrated
    R2: torch.Tensor          # [3,3] predicted body rotation
    v2: torch.Tensor          # [3]
    p2: torch.Tensor          # [3]
    imu_info: torch.Tensor    # [9,9] inv(C[:9,:9] + 1e-8 I)


def imu_preint_plain(gyro, acc, dt, mask, calib: ImuCalib, bias_gyro,
                     bias_acc, pose_wb, vel) -> ImuFrame:
    """Plain version of `imu_preint`."""
    pre = preintegrate(gyro, acc, dt, mask, calib, bias_gyro, bias_acc)
    g_w = torch.tensor([0.0, 0.0, -calib.gravity], dtype=torch.float32,
                       device=gyro.device)
    R2, v2, p2 = predict_state(pre, pose_wb[:, :3], vel, pose_wb[:, 3], g_w)
    C9 = pre.C[:9, :9] + torch.eye(9, device=gyro.device) * 1e-8
    return ImuFrame(pre, R2, v2, p2, torch.linalg.inv(C9))


# float32 output layout of csrc/imu_preint.cu (offset, shape)
_LAYOUT = (("dT", ()), ("dR", (3, 3)), ("dV", (3,)), ("dP", (3,)),
           ("JRg", (3, 3)), ("JVg", (3, 3)), ("JVa", (3, 3)),
           ("JPg", (3, 3)), ("JPa", (3, 3)), ("C", (15, 15)),
           ("avg_a", (3,)), ("avg_w", (3,)), ("R2", (3, 3)), ("v2", (3,)),
           ("p2", (3,)), ("imu_info", (9, 9)))
OUT_FLOATS = sum(int(np.prod(s)) for _, s in _LAYOUT)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
IMU_PREINT = cuda.Kernel("imu_preint", "imu_preint",
                         [_P, _P, _P, _P, _I, _P, _P, _P, _P,
                          _F, _F, _F, _F, _F, _P, _P])


def imu_preint(gyro, acc, dt, mask, calib: ImuCalib, bias_gyro, bias_acc,
               pose_wb, vel) -> ImuFrame:
    """Preintegrate the window (gyro/acc [K,3], dt [K], mask [K] bool, any
    K: the kernel streams the samples) at biases (bias_gyro, bias_acc)
    [3], predict from (pose_wb [3,4], vel [3]), and invert the 9x9
    covariance block.  CPU tensors take the plain version; CUDA tensors
    launch csrc/imu_preint.cu."""
    if gyro.device.type == "cpu":
        return imu_preint_plain(gyro, acc, dt, mask, calib, bias_gyro,
                                bias_acc, pose_wb, vel)
    k = gyro.shape[0]
    cuda.check_cuda("imu_preint", gyro, acc, dt, mask, bias_gyro, bias_acc,
                    pose_wb, vel)
    if any(t.dtype != torch.float32 for t in (gyro, acc, dt, bias_gyro,
                                              bias_acc, pose_wb, vel)) \
            or mask.dtype != torch.bool:
        raise ValueError("imu_preint: float32 inputs and a bool mask")
    if gyro.shape != (k, 3) or acc.shape != (k, 3) or dt.shape != (k,) \
            or mask.shape != (k,) or bias_gyro.shape != (3,) \
            or bias_acc.shape != (3,) or pose_wb.shape != (3, 4) \
            or vel.shape != (3,):
        raise ValueError("imu_preint: shape mismatch")
    out = torch.empty(OUT_FLOATS, dtype=torch.float32, device=gyro.device)
    IMU_PREINT.launch(
        cuda.ptr(gyro), cuda.ptr(acc), cuda.ptr(dt), cuda.ptr(mask), k,
        cuda.ptr(bias_gyro), cuda.ptr(bias_acc), cuda.ptr(pose_wb),
        cuda.ptr(vel), calib.sigma_gyro, calib.sigma_acc, calib.walk_gyro,
        calib.walk_acc, calib.gravity, cuda.ptr(out), cuda.stream())
    f, off = {}, 0
    for name, shape in _LAYOUT:
        size = int(np.prod(shape))
        f[name] = out[off:off + size].view(shape)
        off += size
    pre = Preintegrated(
        dT=f["dT"], dR=f["dR"], dV=f["dV"], dP=f["dP"], JRg=f["JRg"],
        JVg=f["JVg"], JVa=f["JVa"], JPg=f["JPg"], JPa=f["JPa"], C=f["C"],
        bias_gyro=bias_gyro, bias_acc=bias_acc, avg_a=f["avg_a"],
        avg_w=f["avg_w"])
    return ImuFrame(pre, f["R2"], f["v2"], f["p2"], f["imu_info"])
