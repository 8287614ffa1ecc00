"""Synthetic tracking inputs (port of bench.build_inputs, bench.py:33-119,
and of the VI frame's IMU windows, bench.py:407-433).

The same synthetic room, orbit and frames (seed 0) as the reference; the
local map's descriptors come from the port's own extractors, so nothing
here needs JAX.  Returns numpy arrays, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda import resolve_device
from .entry import K_EUROC
from .io import synthetic as syn
from .ops.frontend import make_extractor
from .ops.lines import LineExtractor
from .utils import lie


def build_inputs(n_frames: int = 16, cap_pts: int = 2048, cap_lns: int = 128,
                 height: int = 480, width: int = 752, seed: int = 0,
                 n_features: int = 1000, device="cuda"):
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
    orb, _ = make_extractor(height, width, n_features=n_features,
                            device=dev)
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


def build_mapping_inputs(n_kf: int = 16, n_pt: int = 4096, n_obs: int = 8192,
                         n_feat: int = 1024, n_ln: int = 512,
                         n_lobs: int = 1024, device="cuda"):
    """The keyframe mapping step's window (port of bench.py:214-292, the
    arrays of `bench.build_mapping_step`): the same numpy default_rng(1)
    draws in the same order, with the port's float32 so3_exp for the KF
    rotations.  Returns a dict of tensors on `device`: the epipolar pair
    (pose_a, pose_b, uv_a, uv_b, desc [n_feat,8] int32, ang, ok) and the
    window (kf_poses [n_kf,3,4] T_cw, kf_free, pt_xyz, pt_free, obs_kf,
    obs_pt, obs_uv, obs_valid, obs_is2, ln_ep6, ln_free, lobs_kf, lobs_ln,
    lobs_eq, lobs_valid, lobs_is2)."""
    dev = resolve_device(device)
    K = K_EUROC
    rng = np.random.default_rng(1)
    X = rng.uniform([-6, -4, 3], [6, 4, 12], (n_pt, 3)).astype(np.float32)
    kf_poses = []
    for c in range(n_kf):
        Rm = lie.so3_exp(torch.tensor(rng.normal(0, 0.02, 3),
                                      dtype=torch.float32)).numpy()
        t = np.array([0.25 * c, 0.02 * c, 0.0], np.float32)
        kf_poses.append(np.concatenate([Rm, t[:, None]], 1))
    kf_poses = np.stack(kf_poses).astype(np.float32)
    obs_kf = rng.integers(0, n_kf, n_obs).astype(np.int32)
    obs_pt = rng.integers(0, n_pt, n_obs).astype(np.int32)
    pc = np.einsum("oij,oj->oi", kf_poses[obs_kf, :, :3], X[obs_pt]) \
        + kf_poses[obs_kf, :, 3]
    z = np.maximum(pc[:, 2], 1e-3)
    obs_uv = np.stack([K.fx * pc[:, 0] / z + K.cx,
                       K.fy * pc[:, 1] / z + K.cy], -1).astype(np.float32)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape).astype(np.float32)

    fa = rng.integers(0, n_pt, n_feat)
    pca = X[fa] @ kf_poses[0, :, :3].T + kf_poses[0, :, 3]
    pcb = X[fa] @ kf_poses[1, :, :3].T + kf_poses[1, :, 3]
    uv_a = np.stack([K.fx * pca[:, 0] / pca[:, 2] + K.cx,
                     K.fy * pca[:, 1] / pca[:, 2] + K.cy], -1)
    uv_b = np.stack([K.fx * pcb[:, 0] / pcb[:, 2] + K.cx,
                     K.fy * pcb[:, 1] / pcb[:, 2] + K.cy], -1)
    desc = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32)
    ang = rng.uniform(0, 2 * np.pi, n_feat).astype(np.float32)

    ln_ep6 = np.concatenate(
        [X[:n_ln], X[:n_ln] + rng.normal(0, 0.5, (n_ln, 3))],
        -1).astype(np.float32)
    lobs_kf = rng.integers(0, n_kf, n_lobs).astype(np.int32)
    lobs_ln = rng.integers(0, n_ln, n_lobs).astype(np.int32)
    Rl = kf_poses[lobs_kf, :, :3]
    tl = kf_poses[lobs_kf, :, 3]
    pa = np.einsum("oij,oj->oi", Rl, ln_ep6[lobs_ln, :3]) + tl
    pb = np.einsum("oij,oj->oi", Rl, ln_ep6[lobs_ln, 3:]) + tl
    za = np.maximum(pa[:, 2], 1e-3)
    zb = np.maximum(pb[:, 2], 1e-3)
    uva = np.stack([K.fx * pa[:, 0] / za + K.cx,
                    K.fy * pa[:, 1] / za + K.cy], -1)
    uvb = np.stack([K.fx * pb[:, 0] / zb + K.cx,
                    K.fy * pb[:, 1] / zb + K.cy], -1)
    uva += rng.normal(0, 0.5, uva.shape)
    uvb += rng.normal(0, 0.5, uvb.shape)
    ha = np.concatenate([uva, np.ones((n_lobs, 1))], 1)
    hb = np.concatenate([uvb, np.ones((n_lobs, 1))], 1)
    leq = np.cross(ha, hb).astype(np.float32)
    leq /= np.maximum(
        np.linalg.norm(leq[:, :2], axis=1, keepdims=True), 1e-6)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)

    return dict(
        pose_a=f32(kf_poses[0]), pose_b=f32(kf_poses[1]), uv_a=f32(uv_a),
        uv_b=f32(uv_b), desc=i32(desc.view(np.int32)), ang=f32(ang),
        ok=ones(n_feat), kf_poses=f32(kf_poses),
        kf_free=torch.from_numpy(np.arange(n_kf) > 0).to(dev),
        pt_xyz=f32(X), pt_free=ones(n_pt), obs_kf=i32(obs_kf),
        obs_pt=i32(obs_pt), obs_uv=f32(obs_uv), obs_valid=ones(n_obs),
        obs_is2=torch.ones(n_obs, dtype=torch.float32, device=dev),
        ln_ep6=f32(ln_ep6), ln_free=ones(n_ln), lobs_kf=i32(lobs_kf),
        lobs_ln=i32(lobs_ln), lobs_eq=f32(leq), lobs_valid=ones(n_lobs),
        lobs_is2=torch.ones(n_lobs, dtype=torch.float32, device=dev))


def perturb_window(kf_poses: np.ndarray, pt_xyz: np.ndarray):
    """A perturbed start for the windowed BA (numpy, float64 then float32,
    `default_rng(7)`): for each KF c = 1..n-1 in order R <- Exp(N(0, 0.005,
    3)) R, then t += N(0, 0.02, 3); then every point += N(0, 0.05).  KF 0
    (held fixed by the BA) stays.  Returns (kf_poses, pt_xyz) float32."""
    rng = np.random.default_rng(7)
    P = np.array(kf_poses, np.float64)
    for c in range(1, P.shape[0]):
        dR = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.005, 3))).numpy()
        P[c, :, :3] = dR @ P[c, :, :3]
        P[c, :, 3] += rng.normal(0, 0.02, 3)
    X = np.asarray(pt_xyz, np.float64) + rng.normal(0, 0.05,
                                                    np.shape(pt_xyz))
    return P.astype(np.float32), X.astype(np.float32)
