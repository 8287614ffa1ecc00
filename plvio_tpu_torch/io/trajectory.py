"""Trajectory evaluation: nearest-timestamp association, Umeyama
alignment and the absolute trajectory error (port of
plvio_tpu/io/trajectory.py: `Trajectory` :22, `associate` :58, `umeyama`
:71, `ate_rmse` :88; the TUM readers and writers and `rpe_rmse` are not
ported).  Host-side numpy."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Trajectory:
    timestamps: np.ndarray   # [N]
    positions: np.ndarray    # [N,3]
    quaternions: np.ndarray  # [N,4] (x,y,z,w)

    def __len__(self):
        return len(self.timestamps)


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association; returns index pairs (ia, ib)."""
    ib = np.searchsorted(t_b, t_a)
    ib = np.clip(ib, 0, len(t_b) - 1)
    ib_prev = np.clip(ib - 1, 0, len(t_b) - 1)
    use_prev = np.abs(t_b[ib_prev] - t_a) < np.abs(t_b[ib] - t_a)
    ib = np.where(use_prev, ib_prev, ib)
    ok = np.abs(t_b[ib] - t_a) <= max_dt
    ia = np.nonzero(ok)[0]
    return ia, ib[ok]


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning src -> dst.  Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: Trajectory, gt: Trajectory, with_scale: bool = True,
             max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment (Sim3 with
    `with_scale`, else SE3); non-finite estimates are left out of the
    alignment."""
    ia, ib = associate(est.timestamps, gt.timestamps, max_dt)
    if len(ia) < 3:
        return float("inf")
    p_est, p_gt = est.positions[ia], gt.positions[ib]
    finite = np.isfinite(p_est).all(-1)
    if finite.sum() < 3:
        return float("inf")
    p_est, p_gt = p_est[finite], p_gt[finite]
    s, R, t = umeyama(p_est, p_gt, with_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = aligned - p_gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))
