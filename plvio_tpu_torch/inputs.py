"""Synthetic tracking inputs (port of bench.build_inputs, bench.py:33-119,
and of the VI frame's IMU windows, bench.py:407-433).

The same synthetic room, orbit and frames (seed 0) as the reference; the
local map's descriptors come from the port's own extractors, so nothing
here needs JAX.  Returns numpy arrays, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from plvio_tpu.io import synthetic as syn

from .entry import K_EUROC, resolve_device
from .ops.frontend import make_extractor
from .ops.lines import LineExtractor
from .utils import lie


def build_inputs(n_frames: int = 16, cap_pts: int = 2048, cap_lns: int = 128,
                 height: int = 480, width: int = 752, seed: int = 0,
                 n_features: int = 1000, device="cpu"):
    """Synthetic-room frames + an oracle local map (points and lines) with
    descriptors extracted from the frames.

    Returns (frames [n] of [H,W] float32, poses [n] ground-truth T_cw
    [3,4], pt_xyz [cap_pts,3], pt_desc [cap_pts,8] uint32, pt_valid,
    ln_ep6 [cap_lns,6], ln_desc [cap_lns,8] uint32, ln_valid, traj)."""
    dev = resolve_device(device)
    K = K_EUROC
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=200)
    traj = syn.make_orbit_trajectory(duration=n_frames / 20.0 + 0.5,
                                     fps=20.0, radius=0.6)
    frames = [syn.render_frame(scene, traj.R_wb[i], traj.p_wb[i], rng=rng,
                               width=width, height=height)
              for i in range(n_frames)]

    def to_dev(img):
        return torch.from_numpy(np.asarray(img, np.float32)).to(dev)

    # local map: scene points visible anywhere in the window, descriptor
    # from the nearest detection (< 3 px) of the first frame (every 4th)
    # that sees them
    orb, _ = make_extractor(height, width, n_features=n_features, device=dev)
    taken = np.zeros(len(scene.points), bool)
    X, D = [], []
    with torch.no_grad():
        for fi in range(0, n_frames, 4):
            uv0, _, vis0, _, _ = syn.project_scene(
                scene, traj.R_wb[fi], traj.p_wb[fi], K.fx, K.fy, K.cx, K.cy,
                width, height)
            f0 = orb(to_dev(frames[fi]))
            det_uv = f0.uv.cpu().numpy()
            det_desc = f0.desc.cpu().numpy().view(np.uint32)
            det_ok = f0.valid.cpu().numpy()
            for i in np.nonzero(vis0 & ~taken)[0]:
                d = np.linalg.norm(det_uv - uv0[i], axis=-1)
                d[~det_ok] = 1e9
                j = d.argmin()
                if d[j] < 3.0:
                    X.append(scene.points[i])
                    D.append(det_desc[j])
                    taken[i] = True
        n = min(len(X), cap_pts)
        pt_xyz = np.zeros((cap_pts, 3), np.float32)
        pt_desc = np.zeros((cap_pts, 8), np.uint32)
        pt_valid = np.zeros(cap_pts, bool)
        if n:
            pt_xyz[:n] = np.asarray(X, np.float32)[:n]
            pt_desc[:n] = np.asarray(D, np.uint32)[:n]
        pt_valid[:n] = True

        # oracle map lines: scene lines drawn in frame 0, LBD from the
        # nearest frame-0 detection (single-level extractor, 256 lines)
        _, _, _, uv_l0, vis_l0 = syn.project_scene(
            scene, traj.R_wb[0], traj.p_wb[0], K.fx, K.fy, K.cx, K.cy,
            width, height)
        lf0 = LineExtractor(256, levels=1).to(dev)(to_dev(frames[0]))
        lep = lf0.ep.cpu().numpy()
        lok = lf0.valid.cpu().numpy()
        ldesc = lf0.desc.cpu().numpy().view(np.uint32)
    ln_ep6 = np.zeros((cap_lns, 6), np.float32)
    ln_desc = np.zeros((cap_lns, 8), np.uint32)
    ln_valid = np.zeros(cap_lns, bool)
    k = 0
    for i in np.nonzero(vis_l0)[0]:
        if k >= cap_lns:
            break
        mid_gt = (uv_l0[i, 0] + uv_l0[i, 1]) / 2
        d = np.linalg.norm((lep[:, :2] + lep[:, 2:]) / 2 - mid_gt, axis=-1)
        d[~lok] = 1e9
        j = d.argmin()
        if d[j] < 30.0:
            ln_ep6[k, :3] = scene.lines[i, 0]
            ln_ep6[k, 3:] = scene.lines[i, 1]
            ln_desc[k] = ldesc[j]
            ln_valid[k] = True
            k += 1

    poses = []
    for i in range(n_frames):
        R_cw = traj.R_wb[i].T
        t_cw = -R_cw @ traj.p_wb[i]
        poses.append(np.ascontiguousarray(
            np.concatenate([R_cw, t_cw[:, None]], 1), dtype=np.float32))
    return (frames, poses, pt_xyz, pt_desc, pt_valid,
            ln_ep6, ln_desc, ln_valid, traj)


def synthesize_imu(rng: np.random.Generator, duration: float,
                   imu_rate: float = 200.0, radius: float = 1.5,
                   height_amp: float = 0.3, omega: float = 0.45,
                   noise_gyro: float = 1.7e-4, noise_acc: float = 2.0e-3,
                   bias_gyro_mag: float = 0.002, bias_acc_mag: float = 0.02):
    """IMU measurements along the orbit trajectory (port of
    plvio_tpu.io.synthetic.synthesize_imu, whose float32 rotation log is
    JAX's; here it is the port's, which agrees to float32 rounding).  The
    same draws from `rng` in the same order."""
    dt = 1.0 / imu_rate
    t = np.arange(dt, duration - dt, dt)
    fine = syn._eval_orbit(np.concatenate([t - dt, t, t + dt]), radius,
                           height_amp, omega)
    n = len(t)
    Rm, R0, Rp = fine.R_wb[:n], fine.R_wb[n:2 * n], fine.R_wb[2 * n:]
    vm, vp = fine.v_wb[:n], fine.v_wb[2 * n:]
    dR = np.einsum("nij,nik->njk", Rm, Rp)
    w_body = lie.so3_log(torch.from_numpy(dR.astype(np.float32))).numpy(
        ).astype(np.float64) / (2 * dt)
    a_world = (vp - vm) / (2 * dt)
    g_w = np.array([0.0, 0.0, -syn.GRAVITY])
    a_body = np.einsum("nij,ni->nj", R0, a_world - g_w)
    bg = rng.normal(0, bias_gyro_mag, 3)
    ba = rng.normal(0, bias_acc_mag, 3)
    sqrt_rate = np.sqrt(imu_rate)
    gyro = w_body + bg + rng.normal(0, noise_gyro * sqrt_rate, (n, 3))
    acc = a_body + ba + rng.normal(0, noise_acc * sqrt_rate, (n, 3))
    return syn.SyntheticImu(timestamps=t, gyro=gyro, acc=acc, bias_gyro=bg,
                            bias_acc=ba)


def build_imu_windows(traj, n_frames: int, seed: int = 3, n_imu: int = 10):
    """The VI frame's IMU windows (port of bench.py:407-433): a 200 Hz
    IMU synthesized along the radius-0.6 m orbit (`synthesize_imu`, seed
    `seed`, no bias),
    and for each frame i = 1..n_frames-1 the first `n_imu` samples of
    (t_{i-1}, t_i] (zero-padded), each dt 1/200 s.

    Returns (gyro [n-1,n_imu,3], acc [n-1,n_imu,3], dts [n-1,n_imu],
    carry0) as float32 numpy arrays; carry0 = (pose_wb [3,4], vel [3],
    bg [3], ba [3], H15 [15,15]) is the ground-truth frame-0 state with
    zero biases and H15 = I."""
    rng = np.random.default_rng(seed)
    imu = synthesize_imu(rng, n_frames / 20.0 + 0.4, radius=0.6,
                         bias_gyro_mag=0.0, bias_acc_mag=0.0)
    nv = n_frames - 1
    gyro = np.zeros((nv, n_imu, 3), np.float32)
    acc = np.zeros((nv, n_imu, 3), np.float32)
    dts = np.full((nv, n_imu), 1.0 / 200.0, np.float32)
    for j in range(nv):
        m = (imu.timestamps > traj.timestamps[j]) \
            & (imu.timestamps <= traj.timestamps[j + 1])
        gg, aa = imu.gyro[m][:n_imu], imu.acc[m][:n_imu]
        gyro[j, :len(gg)] = gg
        acc[j, :len(aa)] = aa
    pose_wb0 = np.ascontiguousarray(np.concatenate(
        [traj.R_wb[0], traj.p_wb[0][:, None]], 1), dtype=np.float32)
    carry0 = (pose_wb0, np.asarray(traj.v_wb[0], np.float32),
              np.zeros(3, np.float32), np.zeros(3, np.float32),
              np.eye(15, dtype=np.float32))
    return gyro, acc, dts, carry0
