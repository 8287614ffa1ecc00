"""Synthetic inputs (port of bench.build_inputs, bench.py:33-119, of the
VI frame's IMU windows, bench.py:407-433, and of the mapping step's
window, bench.py:214-292), and the inertial back end's window and IMU
chain.

The same synthetic room, orbit and frames (seed 0) as the reference; the
local map's descriptors come from the port's own extractors, so nothing
here needs JAX.  Returns numpy arrays, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ImuConfig
from .cuda import resolve_device
from .entry import K_EUROC
from .io import synthetic as syn
from .models.kernels import PRE_KEYS
from .ops import imu as IMU
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


# --------------------------------------------------------------------------
# The inertial back end: the sliding window of the VI BA and the chain of
# the IMU initialization
# --------------------------------------------------------------------------

# observations of each landmark of the inertial window: with 4, one
# outlier cannot be absorbed by its landmark, so the chi2 gate rejects it
OBS_PER_LANDMARK = 4
# real keyframes of the IMU-initialization chain (padded to its cap)
INIT_REAL_KF = 20


def extrinsics():
    """(Rcb [3,3], tcb [3]) float64: camera-from-body, the inverse of
    EuRoC's Tbc (config.ImuConfig)."""
    T = ImuConfig().Tbc_matrix()
    Rcb = T[:3, :3].T
    return Rcb, -Rcb @ T[:3, 3]


def _preintegrate_links(imu, t_kf, calib, valid):
    """Preintegrate the IMU between consecutive times t_kf [n] (float32,
    the port's plain `ops/imu.preintegrate` at zero biases) where `valid`
    [n-1]; identity constants elsewhere.  Returns (pre_const {key: [n-1,
    ...]}, C [n-1,15,15], avg_a [n-1,3], samples (gyro, acc, dt, mask)
    [n-1,K,...]) as numpy."""
    n_e = len(t_kf) - 1
    sel = [(imu.timestamps > t_kf[i]) & (imu.timestamps <= t_kf[i + 1])
           for i in range(n_e)]
    k = max(8, -(-max(int(m.sum()) for m in sel) // 8) * 8)
    gyro = np.zeros((n_e, k, 3), np.float32)
    acc = np.zeros((n_e, k, 3), np.float32)
    dts = np.zeros((n_e, k), np.float32)
    mask = np.zeros((n_e, k), bool)
    cols = {key: [] for key in PRE_KEYS}
    Cs = np.zeros((n_e, 15, 15), np.float32)
    avg_a = np.zeros((n_e, 3), np.float32)
    z3 = torch.zeros(3)
    for i in range(n_e):
        if valid[i]:
            m = sel[i]
            ts = imu.timestamps[m]
            c = len(ts)
            gyro[i, :c], acc[i, :c] = imu.gyro[m], imu.acc[m]
            dts[i, :c] = np.diff(np.concatenate([[t_kf[i]], ts]))
            mask[i, :c] = True
            p = IMU.preintegrate(torch.from_numpy(gyro[i]),
                                 torch.from_numpy(acc[i]),
                                 torch.from_numpy(dts[i]),
                                 torch.from_numpy(mask[i]), calib, z3, z3)
        else:
            p = IMU.identity_preintegrated(device="cpu")
        vals = {"dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP,
                "JRg": p.JRg, "JVg": p.JVg, "JVa": p.JVa, "JPg": p.JPg,
                "JPa": p.JPa, "bg0": p.bias_gyro, "ba0": p.bias_acc}
        for key in PRE_KEYS:
            cols[key].append(vals[key].numpy())
        Cs[i] = p.C.numpy()
        avg_a[i] = p.avg_a.numpy()
    pre = {key: np.stack(v).astype(np.float32) for key, v in cols.items()}
    return pre, Cs, avg_a, (gyro, acc, dts, mask)


def _infos(Cs, valid):
    """inv(C[:9,:9] + 1e-8 I) (float64, then float32) where valid, I
    elsewhere (models/local_mapping.py:1416-1424)."""
    out = np.tile(np.eye(9), (len(Cs), 1, 1))
    for i in np.nonzero(valid)[0]:
        out[i] = np.linalg.inv(Cs[i][:9, :9].astype(np.float64)
                               + np.eye(9) * 1e-8)
    return out.astype(np.float32)


def _visible(X, R_wc, p_wc, K, width, height, margin=8.0):
    """[S, N] bool: X [N,3] in front of each camera (0.1 < z < 30) and
    inside the image with a margin; and the pixels [S,N,2]."""
    pc = np.einsum("sji,snj->sni", R_wc, X[None] - p_wc[:, None])
    z = pc[..., 2]
    zc = np.maximum(z, 1e-6)
    uv = np.stack([K.fx * pc[..., 0] / zc + K.cx,
                   K.fy * pc[..., 1] / zc + K.cy], -1)
    vis = (z > 0.1) & (z < 30.0) & (uv[..., 0] >= margin) \
        & (uv[..., 0] < width - margin) & (uv[..., 1] >= margin) \
        & (uv[..., 1] < height - margin)
    return vis, uv


def _frustum_points(rng, n, per, R_wc, p_wc, K, width, height,
                    second=None):
    """n points at 2-8 m in the frustum of a random slot, each visible from
    at least `per` slots (with `second`, a function X -> second endpoint,
    both endpoints visible).  Returns (X [n,3], second [n,3] or None, vis
    [S,n])."""
    S = R_wc.shape[0]
    X, X2, V = [], [], []
    got = 0
    while got < n:
        m = 4 * n
        ref = rng.integers(0, S, m)
        u = rng.uniform(8.0, width - 8.0, m)
        v = rng.uniform(8.0, height - 8.0, m)
        z = rng.uniform(2.0, 8.0, m)
        xc = np.stack([(u - K.cx) / K.fx * z, (v - K.cy) / K.fy * z, z], -1)
        Xw = np.einsum("nij,nj->ni", R_wc[ref], xc) + p_wc[ref]
        vis, _ = _visible(Xw, R_wc, p_wc, K, width, height)
        if second is not None:
            Xe = second(Xw)
            vis &= _visible(Xe, R_wc, p_wc, K, width, height)[0]
            X2.append(Xe)
        ok = vis.sum(0) >= per
        X.append(Xw[ok])
        V.append(vis[:, ok])
        if second is not None:
            X2[-1] = X2[-1][ok]
        got += int(ok.sum())
    X = np.concatenate(X)[:n]
    V = np.concatenate(V, 1)[:, :n]
    return X, (np.concatenate(X2)[:n] if second is not None else None), V


def _pick_observations(rng, vis, n_obs):
    """(slot, landmark) pairs: n_obs spread evenly over the landmarks, each
    landmark's from distinct slots that see it, sorted by slot as the
    reference's window code lists them."""
    n = vis.shape[1]
    per = np.full(n, n_obs // n)
    per[:n_obs % n] += 1
    kf, lm = [], []
    for j in range(n):
        cand = np.nonzero(vis[:, j])[0]
        kf.append(rng.permutation(cand)[:per[j]])
        lm.append(np.full(per[j], j))
    kf, lm = np.concatenate(kf), np.concatenate(lm)
    order = np.lexsort((lm, kf))
    return kf[order].astype(np.int32), lm[order].astype(np.int32)


def build_inertial_window(n_pt: int = 4096, n_obs: int = 8192,
                          n_ln: int = 256, n_lobs: int = 512, seed: int = 0,
                          device="cuda", perturbed: bool = False,
                          n_kf: int = 16, n_observers: int = 5):
    """A window of the sliding-window VI BA shaped as production's
    (models/local_mapping.py:1143-1176, 1377-1445), numpy default_rng(seed).

    - Trajectory: the port's orbit (radius 1.5 m) at 20 fps, a KF every 3
      frames; the n_kf slots are `n_observers` older fixed visual
      observers (every other KF, so not chain-consecutive: their inertial
      edges are masked) and then n_kf - n_observers chain-consecutive
      window KFs, the oldest fixed as the anchor.
    - IMU: `synthesize_imu` along the orbit with EuRoC noise (1.7e-4,
      2e-3) and small nonzero biases; each window link preintegrated in
      float32 by the port's plain `ops/imu.preintegrate` at zero biases;
      imu_info = inv(C9 + 1e-8 I), rw_info_g/a = 1 / mean diag of C's bias
      blocks (local_mapping.py:1417-1422).
    - Landmarks: n_obs / 4 points at 2-8 m in the slots' frustums (at
      most n_pt; the remaining slots padded, pt_free false, as production
      pads its buckets), each seen by 4 slots (camera Tcb
      from EuRoC's Tbc), so that the observations fill n_obs; 0.5 px
      noise, octaves 0-7 (obs_is2 = 1.2^(-2 oct)).  Lines likewise
      (n_lobs / 4 of them, endpoints 2-8 m, 0.3-1.0 m long),
      observed as the normalized line equations of the two noisy
      projected endpoints.  2% of the point and of the line observations
      are 20 px outliers (lines: across the segment), which the chi2
      gate rejects (`OBS_PER_LANDMARK`).
    - Start: the truth (poses, velocities, landmarks and the IMU's true
      biases), or with `perturbed` default_rng(7): on each free KF R <- R
      Exp(N(0, 0.01)), p += N(0, 0.03), v += N(0, 0.05), then every point
      and line endpoint += N(0, 0.02).

    Returns a dict of tensors on `device`: the arguments of
    `make_local_inertial_ba` (kf_pose_wb, kf_vel, kf_bg, kf_ba, kf_free,
    kf_free_bias, pt_xyz, pt_free, obs_kf, obs_pt, obs_uv, obs_valid,
    obs_is2, pre_const, imu_info, edge_valid, rw_info_g, rw_info_a, ln_ep6,
    ln_free, lobs_kf, lobs_ln, lobs_eq, lobs_valid), Rcb / tcb (float32),
    the truth (gt_pose_wb, gt_vel, gt_bg, gt_ba, gt_pt_xyz, gt_ln_ep6),
    the outlier masks (obs_outlier, lobs_outlier) and each link's IMU
    samples (imu_gyro, imu_acc, imu_dt, imu_mask [n_kf-1,K,...])."""
    dev = resolve_device(device)
    K = K_EUROC
    width, height = 752, 480
    rng = np.random.default_rng(seed)
    n_win = n_kf - n_observers
    kf_idx = np.concatenate([np.arange(n_observers) * 2 + 1,
                             2 * n_observers + 1 + np.arange(n_win)])
    t_kf = kf_idx * 3 / 20.0
    traj = syn._eval_orbit(t_kf, 1.5, 0.3, 0.45)
    imu = synthesize_imu(rng, float(t_kf[-1]) + 0.1)
    R_wb, p_wb, v_wb = traj.R_wb, traj.p_wb, traj.v_wb
    T = ImuConfig().Tbc_matrix()
    Rcb, tcb = extrinsics()
    R_wc = R_wb @ T[:3, :3]
    p_wc = np.einsum("sij,j->si", R_wb, T[:3, 3]) + p_wb

    edge_valid = np.zeros(n_kf - 1, bool)
    edge_valid[n_observers:] = True
    calib = IMU.make_calib(ImuConfig())
    pre, Cs, _, samples = _preintegrate_links(imu, t_kf, calib, edge_valid)
    imu_info = _infos(Cs, edge_valid)
    rw_g = np.zeros(n_kf - 1, np.float32)
    rw_a = np.zeros(n_kf - 1, np.float32)
    for i in np.nonzero(edge_valid)[0]:
        C = Cs[i].astype(np.float64)
        rw_g[i] = 1.0 / max(np.trace(C[9:12, 9:12]) / 3, 1e-12)
        rw_a[i] = 1.0 / max(np.trace(C[12:15, 12:15]) / 3, 1e-12)

    per_lm = OBS_PER_LANDMARK
    m_pt = min(n_pt, n_obs // per_lm)
    Xr, _, vis = _frustum_points(rng, m_pt, per_lm, R_wc, p_wc, K, width,
                                 height)
    obs_kf, obs_pt = _pick_observations(rng, vis, n_obs)
    X = np.zeros((n_pt, 3))
    X[:m_pt] = Xr

    def project(Xw, kf):
        pc = np.einsum("nji,nj->ni", R_wc[kf], Xw - p_wc[kf])
        return np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                         K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1)

    obs_uv = project(X[obs_pt], obs_kf) + rng.normal(0, 0.5, (n_obs, 2))
    octave = rng.integers(0, 8, n_obs)
    obs_is2 = 1.0 / 1.2 ** (2.0 * octave)
    out_p = rng.random(n_obs) < 0.02
    ang = rng.uniform(0, 2 * np.pi, n_obs)
    obs_uv[out_p] += 20.0 * np.stack([np.cos(ang), np.sin(ang)], -1)[out_p]

    def endpoint(Xs):
        d = rng.normal(0, 1, Xs.shape)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return Xs + d * rng.uniform(0.3, 1.0, (len(Xs), 1))

    m_ln = min(n_ln, n_lobs // per_lm)
    if m_ln:
        Ls, Le, vis_l = _frustum_points(rng, m_ln, per_lm, R_wc, p_wc, K,
                                        width, height, second=endpoint)
        lobs_kf, lobs_ln = _pick_observations(rng, vis_l, n_lobs)
        ua = project(Ls[lobs_ln], lobs_kf)
        ub = project(Le[lobs_ln], lobs_kf)
        out_l = rng.random(n_lobs) < 0.02
        nrm = np.stack([ua[:, 1] - ub[:, 1], ub[:, 0] - ua[:, 0]], -1)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
        ua = ua + rng.normal(0, 0.5, ua.shape) + 20.0 * nrm * out_l[:, None]
        ub = ub + rng.normal(0, 0.5, ub.shape) + 20.0 * nrm * out_l[:, None]
        one = np.ones((n_lobs, 1))
        leq = np.cross(np.concatenate([ua, one], 1),
                       np.concatenate([ub, one], 1))
        leq /= np.maximum(np.linalg.norm(leq[:, :2], axis=1, keepdims=True),
                          1e-9)
        ln_ep6 = np.zeros((n_ln, 6))
        ln_ep6[:m_ln] = np.concatenate([Ls, Le], 1)
    else:
        lobs_kf = lobs_ln = np.zeros(0, np.int32)
        leq = np.zeros((0, 3))
        out_l = np.zeros(0, bool)
        ln_ep6 = np.zeros((n_ln, 6))

    pose_gt = np.concatenate([R_wb, p_wb[..., None]], -1)
    kf_free = np.arange(n_kf) > n_observers
    bg = np.tile(imu.bias_gyro, (n_kf, 1))
    ba = np.tile(imu.bias_acc, (n_kf, 1))
    pose0, vel0, X0, L0 = pose_gt.copy(), v_wb.copy(), X.copy(), ln_ep6.copy()
    if perturbed:
        prng = np.random.default_rng(7)
        for c in np.nonzero(kf_free)[0]:
            dR = lie.so3_exp(torch.from_numpy(prng.normal(0, 0.01, 3))).numpy()
            pose0[c, :, :3] = pose0[c, :, :3] @ dR
            pose0[c, :, 3] += prng.normal(0, 0.03, 3)
            vel0[c] += prng.normal(0, 0.05, 3)
        X0[:m_pt] += prng.normal(0, 0.02, (m_pt, 3))
        L0[:m_ln] += prng.normal(0, 0.02, (m_ln, 6))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def b8(a):
        return torch.from_numpy(np.ascontiguousarray(a, bool)).to(dev)

    gyro, acc, dts, mask = samples
    return dict(
        kf_pose_wb=f32(pose0), kf_vel=f32(vel0), kf_bg=f32(bg), kf_ba=f32(ba),
        kf_free=b8(kf_free), kf_free_bias=b8(kf_free), pt_xyz=f32(X0),
        pt_free=b8(np.arange(n_pt) < m_pt), obs_kf=i32(obs_kf),
        obs_pt=i32(obs_pt), obs_uv=f32(obs_uv),
        obs_valid=b8(np.ones(n_obs, bool)), obs_is2=f32(obs_is2),
        pre_const={k: f32(v) for k, v in pre.items()},
        imu_info=f32(imu_info), edge_valid=b8(edge_valid),
        rw_info_g=f32(rw_g), rw_info_a=f32(rw_a), ln_ep6=f32(L0),
        ln_free=b8(np.arange(n_ln) < m_ln), lobs_kf=i32(lobs_kf),
        lobs_ln=i32(lobs_ln), lobs_eq=f32(leq),
        lobs_valid=b8(np.ones(n_lobs, bool)), Rcb=f32(Rcb), tcb=f32(tcb),
        gt_pose_wb=f32(pose_gt), gt_vel=f32(v_wb), gt_bg=f32(bg),
        gt_ba=f32(ba), gt_pt_xyz=f32(X), gt_ln_ep6=f32(ln_ep6),
        obs_outlier=b8(out_p), lobs_outlier=b8(out_l), imu_gyro=f32(gyro),
        imu_acc=f32(acc), imu_dt=f32(dts), imu_mask=b8(mask))


def build_imu_init_inputs(n_kf: int = 32, seed: int = 0, device="cuda"):
    """The chain of the IMU initialization and of the scale refinement
    (after tests/test_imu_init.py:20-68), numpy default_rng(seed).

    20 KFs (`INIT_REAL_KF`: every 4th frame of the port's orbit at 10
    fps, 0.4 s apart) with an IMU of low noise (1e-5, 1e-4) and a 0.003 rad/s gyro
    bias, each link preintegrated at zero biases by the port's plain
    `ops/imu.preintegrate`; padded to the cap n_kf with identity poses and
    constants and edge_valid false.

    - init: the "mono SLAM" frame, scale 0.5 and rotated by Exp(0.4,
      -0.2, 0.7); vel0 from the positions' differences and Rwg0 from the
      mean accelerometer, as `maybe_initialize_imu` forms them
      (models/local_mapping.py:1062-1085).
    - refine: the metric, gravity-aligned chain given a 1.03 scale error
      and a 0.5 deg gravity tilt (about the horizontal axis (1, 1, 0)),
      the true velocities and gyro bias, Rwg0 = I.

    Returns a dict of tensors on `device`: Rwg0, vel0, pre_const, pose_R,
    pose_p, imu_info, edge_valid (init); ref_Rwg0, ref_vel, ref_bg,
    ref_ba, ref_pose_R, ref_pose_p (refine, same constants); the truth
    gt_scale (2), gt_gdir (the SLAM frame's gravity direction), gt_bg,
    gt_ref_scale (1 / 1.03), gt_ref_gdir; and each link's IMU samples
    (imu_gyro, imu_acc, imu_dt, imu_mask)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_real = INIT_REAL_KF
    dur = 0.4 * n_real + 0.4
    traj = syn.make_orbit_trajectory(duration=dur, fps=10.0)
    imu = synthesize_imu(rng, dur, noise_gyro=1e-5, noise_acc=1e-4,
                         bias_gyro_mag=0.003, bias_acc_mag=0.0)
    ids = 2 + 4 * np.arange(n_real)
    n = n_real
    t_kf = np.zeros(n_kf)
    t_kf[:n] = traj.timestamps[ids]
    valid = np.zeros(n_kf - 1, bool)
    valid[:n - 1] = True
    calib = IMU.make_calib(ImuConfig())
    pre, Cs, avg_a, samples = _preintegrate_links(imu, t_kf, calib, valid)
    imu_info = _infos(Cs, valid)

    def chain(R, p):
        pose_R = np.tile(np.eye(3), (n_kf, 1, 1))
        pose_p = np.zeros((n_kf, 3))
        pose_R[:n], pose_p[:n] = R, p
        return pose_R, pose_p

    lam = 0.5
    R_pert = lie.so3_exp(torch.tensor([0.4, -0.2, 0.7])).double().numpy()
    pose_R, pose_p = chain(R_pert @ traj.R_wb[ids],
                           lam * traj.p_wb[ids] @ R_pert.T)
    vel0 = np.zeros((n_kf, 3))
    v = np.diff(pose_p[:n], axis=0) / np.maximum(
        np.diff(traj.timestamps[ids])[:, None], 1e-3)
    vel0[:n - 1], vel0[n - 1] = v, v[-1]
    dirG = np.zeros(3)
    for i in range(n - 1):
        dirG -= pose_R[i + 1] @ avg_a[i]
    dirG /= np.linalg.norm(dirG)
    gI = np.array([0.0, 0.0, -1.0])
    vx = np.cross(gI, dirG)
    s = np.linalg.norm(vx)
    ang = np.arctan2(s, float(gI @ dirG))
    Rwg0 = lie.so3_exp(torch.tensor(vx / max(s, 1e-9) * ang,
                                    dtype=torch.float32)).numpy()

    tilt = np.array([1.0, 1.0, 0.0]) / np.sqrt(2.0) * np.radians(0.5)
    R_tilt = lie.so3_exp(torch.from_numpy(tilt)).numpy()
    ref_R, ref_p = chain(R_tilt @ traj.R_wb[ids],
                         1.03 * traj.p_wb[ids] @ R_tilt.T)
    ref_vel = np.zeros((n_kf, 3))
    ref_vel[:n] = 1.03 * traj.v_wb[ids] @ R_tilt.T

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    gyro, acc, dts, mask = samples
    return dict(
        Rwg0=f32(Rwg0), vel0=f32(vel0),
        pre_const={k: f32(x) for k, x in pre.items()}, pose_R=f32(pose_R),
        pose_p=f32(pose_p), imu_info=f32(imu_info),
        edge_valid=torch.from_numpy(valid).to(dev),
        ref_Rwg0=f32(np.eye(3)), ref_vel=f32(ref_vel),
        ref_bg=f32(imu.bias_gyro), ref_ba=f32(np.zeros(3)),
        ref_pose_R=f32(ref_R), ref_pose_p=f32(ref_p),
        gt_scale=1.0 / lam, gt_gdir=f32(R_pert @ gI), gt_bg=f32(imu.bias_gyro),
        gt_ref_scale=1.0 / 1.03, gt_ref_gdir=f32(R_tilt @ gI),
        imu_gyro=f32(gyro), imu_acc=f32(acc), imu_dt=f32(dts),
        imu_mask=torch.from_numpy(mask).to(dev))
