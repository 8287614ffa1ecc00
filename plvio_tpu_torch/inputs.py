"""Synthetic inputs (port of bench.build_inputs, bench.py:33-119, of the
VI frame's IMU windows, bench.py:407-433, and of the mapping step's
window, bench.py:214-292), the inertial back end's window and IMU chain,
the keyframe step's maps, the bootstrap's frames, the keyframe
sequence with its stand-in for the tracker's keyframe insertion, the
tracked sequence's rendered frames and the MH replay's, the stereo and
RGB-D rooms, and the KB8 fisheye's room and window BA.

The same synthetic room, orbit and frames (seed 0) as the reference; the
local map's descriptors come from the port's own extractors, so nothing
here needs JAX.  Returns numpy arrays, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ImuConfig
from .cuda import resolve_device
from .entry import K_EUROC, STEREO_BASELINE
from .io import synthetic as syn
from .models.kernels import PRE_KEYS
from .solver.residuals import KB8K, PinholeK
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
                          n_kf: int = 16, n_observers: int = 5,
                          kb8: bool = False):
    """A window of the sliding-window VI BA shaped as production's
    (models/local_mapping.py:1143-1176, 1377-1445), numpy default_rng(seed).
    With `kb8` the same draws observed by the fisheye room's camera
    (`kb8_camera`): the points through the lens on raw pixels, the lines
    as the pinhole projection of its fx, fy, cx, cy (the window BA's line
    edge of a KB8K camera).

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

    Kl = kb8_camera() if kb8 else K

    def project(Xw, kf, lens=False):
        pc = np.einsum("nji,nj->ni", R_wc[kf], Xw - p_wc[kf])
        if lens:
            return syn._kb8_project_cam_np(pc, Kl.fx, Kl.fy, Kl.cx, Kl.cy,
                                           KB8_K)
        return np.stack([Kl.fx * pc[:, 0] / pc[:, 2] + Kl.cx,
                         Kl.fy * pc[:, 1] / pc[:, 2] + Kl.cy], -1)

    obs_uv = project(X[obs_pt], obs_kf, kb8) \
        + rng.normal(0, 0.5, (n_obs, 2))
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


# --------------------------------------------------------------------------
# The keyframe step's neighbourhood: a map of 14 keyframes, the new one last
# --------------------------------------------------------------------------

KEYFRAME_MAP_KF = 14


def _flip_bits(rng, desc, k):
    """desc [N,8] uint32 with k[i] random bits of row i flipped."""
    out = desc.copy()
    for i in np.nonzero(k)[0]:
        bits = rng.choice(256, int(k[i]), replace=False)
        for b in bits:
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _octaves(rng, n):
    """ORB-like octaves 0..7, each level ~1/1.44 as populated as the one
    below."""
    w = 1.2 ** (-2.0 * np.arange(8))
    return rng.choice(8, n, p=w / w.sum()).astype(np.int32)


def _map_segments(rng, kind, n, R_wc, p_wc, K, width, height):
    """n 3D segments [n,2,3] of one kind, each drawn in the frustum of a
    random slot: 'normal' (endpoint at 2-8 m, 0.4-2 m long), 'far'
    (45-60 m, 6-12 m, across the view), 'long' (30-36 m, 21-25 m),
    'baseline' (2-8 m, 0.6-1.5 m, within 0.2 deg of the direction from the
    slot's camera centre to the next slot's, so both views' interpretation
    planes nearly coincide) and 'twin' (pairs crossing at a common
    midpoint, 0.4-1.0 rad apart in the slot's image; n pairs)."""
    S = R_wc.shape[0]
    ref = rng.integers(0, S, n)
    u = rng.uniform(120.0, width - 120.0, n)
    v = rng.uniform(100.0, height - 100.0, n)
    if kind == "far":
        z, length = rng.uniform(45.0, 60.0, n), rng.uniform(6.0, 12.0, n)
    elif kind == "long":
        z, length = rng.uniform(3.0, 6.0, n), rng.uniform(21.0, 25.0, n)
    else:
        z = rng.uniform(2.0, 8.0, n)
        length = rng.uniform(0.4, 2.0, n) if kind != "baseline" \
            else rng.uniform(0.6, 1.5, n)
    xc = np.stack([(u - K.cx) / K.fx * z, (v - K.cy) / K.fy * z, z], -1)
    mid = np.einsum("nij,nj->ni", R_wc[ref], xc) + p_wc[ref]
    if kind == "far":
        # across the view: in the slot's image plane
        a = rng.uniform(0, np.pi, n)
        dc = np.stack([np.cos(a), np.sin(a), np.zeros(n)], -1)
        d = np.einsum("nij,nj->ni", R_wc[ref], dc)
    elif kind == "long":
        # receding from the near end, within ~6 deg of the optical axis
        dc = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), np.ones((n, 1))],
                            1)
        d = np.einsum("nij,nj->ni", R_wc[ref], dc)
        mid = mid + d / np.linalg.norm(d, axis=1, keepdims=True) \
            * length[:, None] / 2
    elif kind == "baseline":
        # the first half exactly along the last baseline (slot 12 -> 13):
        # both interpretation planes coincide to rounding
        ref[:n // 2] = S - 2
        mid[:n // 2] = np.einsum("nij,nj->ni", R_wc[ref[:n // 2]],
                                 xc[:n // 2]) + p_wc[ref[:n // 2]]
        nxt = np.minimum(ref + 1, S - 1)
        nxt = np.where(nxt == ref, ref - 1, nxt)
        d = p_wc[nxt] - p_wc[ref]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        jit = rng.normal(0, 1, (n, 3))
        jit -= (jit * d).sum(1, keepdims=True) * d
        jit /= np.linalg.norm(jit, axis=1, keepdims=True)
        tilt = np.radians(rng.uniform(0.0, 0.2, n))
        tilt[:n // 2] = 0.0
        d = d + jit * np.tan(tilt)[:, None]
    else:
        d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seg = np.stack([mid - d * length[:, None] / 2,
                    mid + d * length[:, None] / 2], 1)
    if kind != "twin":
        return seg
    # the twin: the same midpoint, rotated about the slot's viewing ray
    ray = mid - p_wc[ref]
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    ang = rng.uniform(0.4, 1.0, n) * rng.choice([-1.0, 1.0], n)
    rot = lie.so3_exp(torch.from_numpy(ray * ang[:, None])).numpy()
    d2 = np.einsum("nij,nj->ni", rot, d)
    twin = np.stack([mid - d2 * length[:, None] / 2,
                     mid + d2 * length[:, None] / 2], 1)
    return np.concatenate([seg, twin])


def build_keyframe_map(confirmed_lines: bool = False, seed: int = 0):
    """The map store of the keyframe step's neighbourhood work (numpy,
    default_rng(seed)): 14 keyframes on the port's orbit (radius 1.5 m,
    one every 0.15 s, 0.1 m apart), the new one (slot 13) last, at
    production's capacities (512 KF, 16384 points, 2048 lines, 1000
    features and 256 line features a keyframe), shaped so that every
    branch of `create_new_lines`, `search_in_neighbors` and `local_ba`
    decides something.  What seed 0 reaches (`LocalMapper` at production
    caps, the same on the port and the JAX mapper,
    `tests/test_torch_neighborhood.py`):

    - points: 4641 map points at 2-8 m, each bound in 2-3 keyframes that
      see it (at most 820 a keyframe, 500 in the new one), and 40
      duplicates; every keyframe also holds features at map points it sees
      but does not bind and >= 150 unmatched features, 1000 in all; the new
      keyframe binds 540 and leaves 460 unbound.  Observations: the true
      projections + 0.4 px x 1.2^octave noise, 2% of them 15 px outliers;
      stored poses and points perturbed (keyframes 4-13 0.5 mrad / 2 mm,
      points 3 mm).  The new keyframe has 10 covisible neighbours (13
      keyframes in the fuse's two hops), whose 4657 points exceed the
      forward fuse's cap of 2048.
    - duplicates: 26 landmarks the new keyframe sees but does not bind,
      duplicated 2 mm away with the same descriptor and bound in the new
      keyframe (half of them in one more keyframe), and 14 on the new
      keyframe's ray at +10% depth; the fuse binds 182 features, merges
      25 landmark pairs and its 3D check refuses 16 merges.
    - lines: 382 segments (300 of 0.4-2 m at 2-8 m, 16 at 45-60 m, 10
      receding ones 21-25 m long, 24 within 0.2 deg of a baseline, the
      first 12 exactly along the last one and seen without noise, 16 twin
      pairs crossing at 0.4-1.0 rad with 3 bits between their LBDs), seen
      as 203-256 LBD-described segments a keyframe (3444 in all; 0.3 px
      noise, 12% of them fragments, half of those only a third), none
      bound in the new keyframe.  Over the 10 neighbour pairs the pair
      matcher's gates each decide rows (the match changes without the
      gate: midpoint 419, angle 91, length ratio 18, 40 px 47), and 18,
      50 and 4 matched pairs fail only the triangulator's depth,
      plane-angle and length gates; its agreement and perpendicular-
      distance gates fail no pair (both reconstructions lie on the two
      planes' intersection, so no real pair can fail them).
      `create_new_lines` makes 109 lines (107 with `confirmed_lines`).
    - BA: the window holds 11 keyframes + 3 fixed observers (14 of 16
      slots), 4429 points and 10064 observations, which the caps of 4096
      and 8192 cut; its chi2 gate unbinds 128 observations and 10 points
      lose their last one.  With `confirmed_lines`, 24 map lines bound in
      3 (12 of them) or 4 of the keyframes 4-12 make `local_ba` take the
      point+line path.

    Returns (arrays, truth): `arrays` in the layout of
    `state.mapstore_to_numpy` (the JAX package's `MapStore` attribute
    names), truth = dict(kf_pose_cw [14,3,4], pt_xyz [16384,3] (the map
    points' true positions), new_kf)."""
    from .models.mapstore import MapStore
    from .state import mapstore_to_numpy
    rng = np.random.default_rng(seed)
    K = K_EUROC
    width, height = 752, 480
    n_kf = KEYFRAME_MAP_KF
    new_kf = n_kf - 1
    t_kf = (1 + 3 * np.arange(n_kf)) / 20.0
    traj = syn._eval_orbit(t_kf, 1.5, 0.3, 0.45)
    R_wc, p_wc = traj.R_wb, traj.p_wb
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_wc)
    m = MapStore(n_feat=1000, n_line_feat=256)
    F, LF = m.n_feat, m.n_line_feat

    def project(X, k):
        pc = X @ R_cw[k].T + t_cw[k]
        return np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                         K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1), pc[:, 2]

    # ---- points and their bindings -------------------------------------
    n_cand = 9000
    Xc, _, vis = _frustum_points(rng, n_cand, 3, R_wc, p_wc, K, width,
                                 height)
    cap_bound = np.full(n_kf, 820)
    cap_bound[new_kf] = 500
    n_bound = np.zeros(n_kf, int)
    runs = []
    for i in rng.permutation(n_cand):
        V = np.nonzero(vis[:, i])[0]
        V = V[n_bound[V] < cap_bound[V]]
        run = np.sort(rng.permutation(V)[:int(rng.choice([2, 2, 2, 3, 3]))])
        if len(run) < 2:
            continue
        n_bound[run] += 1
        runs.append((i, run))
    n_pt = len(runs)
    X = np.array([Xc[i] for i, _ in runs])
    pdesc = rng.integers(0, 2 ** 32, (n_pt, 8), dtype=np.uint32)
    # per keyframe: (uv, desc, octave, point or -1) of its features
    feats = [[] for _ in range(n_kf)]
    bound_in = np.zeros((n_kf, n_pt), bool)
    for j, (_, run) in enumerate(runs):
        bound_in[run, j] = True
    # duplicates of points the new keyframe sees but does not bind
    vis_new = vis[new_kf, [i for i, _ in runs]]
    pool = np.nonzero(vis_new & ~bound_in[new_kf])[0]
    dup_of = rng.choice(pool, 40, replace=False)
    dX, dpos = [], []
    for q, j in enumerate(dup_of):
        if q < 26:                      # 2 mm away: merged
            off = rng.normal(0, 1, 3)
            dX.append(X[j] + 0.002 * off / np.linalg.norm(off))
        else:                           # +10% depth on the new KF's ray
            dX.append(p_wc[new_kf] + 1.1 * (X[j] - p_wc[new_kf]))
        dpos.append(j)
    X = np.concatenate([X, np.array(dX)])
    pdesc = np.concatenate([pdesc, pdesc[dup_of]])
    n_all = len(X)
    bound_in = np.concatenate([bound_in, np.zeros((n_kf, 40), bool)], 1)
    vis_all = np.concatenate(
        [vis[:, [i for i, _ in runs]],
         _visible(np.array(dX), R_wc, p_wc, K, width, height)[0]], 1)
    for q in range(40):
        j = n_pt + q
        bound_in[new_kf, j] = True
        # some duplicates also in one more keyframe that sees them and
        # does not bind the original
        if rng.random() < 0.5:
            others = np.nonzero(vis_all[:, j] & ~bound_in[:, dup_of[q]])[0]
            others = others[others != new_kf]
            if len(others):
                bound_in[int(rng.choice(others)), j] = True
    for k in range(n_kf):
        b = np.nonzero(bound_in[k])[0]
        for j in b:
            feats[k].append(j)
        # map points seen but not bound (originals of the duplicates
        # excluded in the new keyframe: the duplicate sits there)
        seen = np.nonzero(vis_all[k] & ~bound_in[k])[0]
        if k == new_kf:
            seen = np.setdiff1d(seen, dup_of)
        n_free = max(0, F - 150 - len(b))
        feats[k] += list(rng.permutation(seen)[:n_free])
    # the stored map: perturbed poses (free keyframes) and points
    pose_true = np.concatenate([R_cw, t_cw[..., None]], -1)
    pose_map = pose_true.copy()
    for k in range(4, n_kf):
        dR = lie.so3_exp(torch.from_numpy(rng.normal(0, 5e-4, 3))).numpy()
        pose_map[k, :, :3] = dR @ pose_map[k, :, :3]
        pose_map[k, :, 3] += rng.normal(0, 0.002, 3)
    X_map = X + rng.normal(0, 0.003, X.shape)

    ids = m.alloc_points(n_all)
    perm = rng.permutation(n_all)          # point ids in random order
    pid = ids[perm]
    m.pt_xyz[pid] = X_map
    m.pt_desc[pid] = pdesc
    m.pt_n_obs[pid] = bound_in.sum(0)
    m.pt_found[pid] = m.pt_n_obs[pid]
    m.pt_visible[pid] = m.pt_n_obs[pid]
    m.pt_first_kf[pid] = np.argmax(bound_in, 0)
    for k in range(n_kf):
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = t_kf[k]
        m.kf_pose_cw[kf] = pose_map[k]
        if k > 0:
            m.kf_prev[kf] = kf - 1
            m.kf_next[kf - 1] = kf
        js = np.array(feats[k], int)
        nf = len(js)
        uv, _ = project(X[js], k)
        octv = _octaves(rng, F)
        sig = 0.4 * 1.2 ** octv[:nf]
        uv = uv + rng.normal(0, 1, uv.shape) * sig[:, None]
        is_bound = bound_in[k, js]
        out = is_bound & (rng.random(nf) < 0.02)
        a = rng.uniform(0, 2 * np.pi, nf)
        uv[out] += 15.0 * np.stack([np.cos(a), np.sin(a)], -1)[out]
        desc = _flip_bits(rng, pdesc[js], rng.integers(0, 11, nf))
        n_noise = F - nf
        nuv = np.stack([rng.uniform(0, width, n_noise),
                        rng.uniform(0, height, n_noise)], -1)
        ndesc = rng.integers(0, 2 ** 32, (n_noise, 8), dtype=np.uint32)
        order = rng.permutation(F)
        all_uv = np.concatenate([uv, nuv])[order]
        all_desc = np.concatenate([desc, ndesc])[order]
        match = np.concatenate([np.where(is_bound, pid[js], -1),
                                np.full(n_noise, -1)])[order]
        m.kf_feat_uv[kf] = all_uv
        m.kf_feat_uv_raw[kf] = all_uv
        m.kf_feat_desc[kf] = all_desc
        m.kf_feat_octave[kf] = octv[order]
        m.kf_feat_angle[kf] = rng.uniform(0, 360, F)
        m.kf_feat_valid[kf] = True
        m.kf_match_pt[kf] = match

    # ---- lines ----------------------------------------------------------
    kinds = (("normal", 300), ("far", 16), ("long", 10), ("baseline", 24),
             ("twin", 16))
    segs, sdesc = [], []
    for kind, n in kinds:
        s = _map_segments(rng, kind, n, R_wc, p_wc, K, width, height)
        d = rng.integers(0, 2 ** 32, (len(s), 8), dtype=np.uint32)
        if kind == "twin":
            d[n:] = _flip_bits(rng, d[:n], np.full(n, 3))
        segs.append(s)
        sdesc.append(d)
    segs = np.concatenate(segs)
    sdesc = np.concatenate(sdesc)
    b0 = 300 + 16 + 10
    crisp = set(range(b0, b0 + 12))     # the exact baseline lines
    n_seg = len(segs)
    seg_obs = [[] for _ in range(n_kf)]
    for k in range(n_kf):
        us, zs = project(segs[:, 0], k)
        ue, ze = project(segs[:, 1], k)
        inside = [(w[:, 0] >= 4) & (w[:, 0] < width - 4) & (w[:, 1] >= 4)
                  & (w[:, 1] < height - 4) for w in (us, ue)]
        ok = (zs > 0.1) & (ze > 0.1) & inside[0] & inside[1]
        ii = rng.permutation(np.nonzero(ok)[0])[:LF]
        for i in ii:
            a, b = us[i].copy(), ue[i].copy()
            r = rng.random()
            if r < 0.06:                # only a third of it
                t0 = 0.0 if rng.random() < 0.5 else 0.65
                a, b = a + t0 * (b - a), a + (t0 + 0.35) * (b - a)
            elif r < 0.12:              # a fragment
                t0, t1 = rng.uniform(0, 0.45), rng.uniform(0.55, 1.0)
                a, b = a + t0 * (b - a), a + t1 * (b - a)
            if rng.random() < 0.5:
                a, b = b, a
            ep = np.concatenate([a, b]) + rng.normal(0, 0.3, 4) \
                * (i not in crisp)
            seg_obs[k].append((i, ep))
    line_of = np.full((n_kf, LF), -1)
    for k in range(n_kf):
        n = len(seg_obs[k])
        m.kf_line_ep[k, :n] = np.array([e for _, e in seg_obs[k]])
        si = np.array([i for i, _ in seg_obs[k]], int)
        m.kf_line_desc[k, :n] = _flip_bits(rng, sdesc[si],
                                           rng.integers(0, 13, n))
        m.kf_line_valid[k, :n] = True
        line_of[k, :n] = si
    if confirmed_lines:
        normal = np.arange(300)
        seen = np.array([[(line_of[k] == i).any() for i in normal]
                         for k in range(4, new_kf)])
        cand = normal[seen.sum(0) >= 4]
        pick = rng.choice(cand, 24, replace=False)
        lns = m.alloc_lines(24)
        for ln, i in zip(lns, pick):
            ks = np.nonzero(seen[:, i])[0] + 4
            ks = rng.permutation(ks)[:int(rng.integers(3, 5))]
            for k in ks:
                m.kf_match_ln[k, np.nonzero(line_of[k] == i)[0][0]] = ln
            m.ln_ep[ln] = segs[i].reshape(6) + rng.normal(0, 0.01, 6)
            m.ln_desc[ln] = sdesc[i]
            m.ln_first_kf[ln] = int(ks.min())
            m.ln_n_obs[ln] = len(ks)
            m.ln_found[ln] = len(ks)
            m.ln_visible[ln] = len(ks)
    for k in range(n_kf):
        m.update_covisibility(k)
    pt_true = np.zeros_like(m.pt_xyz)
    pt_true[pid] = X
    truth = dict(kf_pose_cw=pose_true.astype(np.float32),
                 pt_xyz=pt_true.astype(np.float32), new_kf=new_kf)
    return mapstore_to_numpy(m), truth


def build_projection_case(seed: int = 0, kb8: bool = False):
    """A case of the projection matcher at its path's shapes in which every
    gate decides some rows (numpy, default_rng(seed)): a random pose;
    2048 points (4% behind the camera, 1% nearer than 5 cm, 5% outside
    the image, 1% of them in the strip between u = 2 cx and the image's
    752 px edge, 5% invalid) and 1000 features: 650 at points' projections
    (the near, the strip's and some invalid ones among them) with noise up
    to ~1.5 windows and 0-70 flipped bits, 60 second features next to a
    point's (the ratio test), 40 points duplicated next to another
    (mutual), the rest unmatched; octaves 0-7; per point a distance range
    (10% of them excluding the point, 10% off) and a viewing normal (10%
    beyond 60 deg, 10% zero).  Returns a dict of the matcher's arguments
    (pose, pt_xyz, pt_desc [P,8] uint32, pt_valid, feat_uv, feat_desc,
    feat_octave, feat_valid) and the frustum statistics (pt_normal,
    pt_min_dist, pt_max_dist).  With kb8, the same case for the fisheye
    room's KB8 camera (`KB8_INTRINSICS`, `KB8_K`): the points placed on
    the lens's rays through their pixels (`ops.cameras.kb8_unproject` in
    float64), the pixels raw."""
    K = K_EUROC
    if kb8:
        K = KB8K(**KB8_INTRINSICS, k1=KB8_K[0], k2=KB8_K[1], k3=KB8_K[2],
                 k4=KB8_K[3])
    P, F = 2048, 1000
    rng = np.random.default_rng(seed)
    R = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3))).numpy()
    t = rng.normal(0, 0.5, 3)
    pose = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    u = rng.uniform(0, 2 * K.cx, P)
    v = rng.uniform(0, 2 * K.cy, P)
    z = rng.uniform(2, 8, P)
    z[:80] = rng.uniform(-3, 0.04, 80)                    # behind
    z[80:100] = rng.uniform(0.01, 0.045, 20)              # too near
    u[100:180] += rng.choice([-1, 1], 80) * rng.uniform(2 * K.cx, 900, 80)
    u[180:200] = 2 * K.cx + rng.uniform(0.1, 15.0, 20)    # past 2 cx
    if kb8:
        from .ops import cameras as CAM
        cam = CAM.Camera(K.fx, K.fy, K.cx, K.cy, KB8_K, 752, 480, "kb8")
        ray = CAM.kb8_unproject(cam, torch.from_numpy(
            np.stack([u, v], -1))).numpy()
        xc = ray * z[:, None]
    else:
        xc = np.stack([(u - K.cx) / K.fx * z, (v - K.cy) / K.fy * z, z], -1)
    X = (xc - t) @ R                                       # R^T (xc - t)
    X[1960:2000] = X[1000:1040] + 0.001                   # duplicates
    valid = np.ones(P, bool)
    valid[200:300] = False
    desc = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32)
    desc[1960:2000] = desc[1000:1040]
    # features
    src = np.concatenate([np.arange(80, 100), np.arange(180, 200),
                          rng.choice(np.arange(200, 300), 20, replace=False),
                          rng.choice(np.arange(300, 1960), 590,
                                     replace=False)])
    octave = rng.integers(0, 8, F).astype(np.int32)
    win = np.float32(1.2) ** octave[:650]
    uv_src = np.stack([u[src], v[src]], -1)
    off = rng.normal(0, 1, (650, 2))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    fuv = uv_src + off * (rng.uniform(0, 1.5, 650) * 2.0 * win)[:, None]
    fdesc = _flip_bits(rng, desc[src], rng.integers(0, 70, 650))
    # 60 second features at 0.5 px from a matched one, similar descriptors
    twin = rng.choice(650, 60, replace=False)
    tuv = fuv[twin] + 0.5
    tdesc = _flip_bits(rng, fdesc[twin], rng.integers(0, 6, 60))
    n_rest = F - 650 - 60
    ruv = np.stack([rng.uniform(0, 2 * K.cx, n_rest),
                    rng.uniform(0, 2 * K.cy, n_rest)], -1)
    rdesc = rng.integers(0, 2 ** 32, (n_rest, 8), dtype=np.uint32)
    perm = rng.permutation(F)
    feat_uv = np.concatenate([fuv, tuv, ruv])[perm].astype(np.float32)
    feat_desc = np.concatenate([fdesc, tdesc, rdesc])[perm]
    feat_octave = octave[perm]
    feat_valid = rng.random(F) < 0.97
    # frustum: range and normal
    C = -R.T @ t
    d_cam = np.linalg.norm(X - C, axis=1)
    mn, mx = d_cam / 1.5, d_cam * 1.4
    bad = rng.random(P) < 0.1
    mn[bad] = d_cam[bad] * rng.uniform(1.3, 2.0, bad.sum())
    off_r = rng.random(P) < 0.1
    mx[off_r] = 0.0
    view = (X - C) / d_cam[:, None]
    normal = view + rng.normal(0, 0.2, (P, 3))
    away = rng.random(P) < 0.1
    normal[away] = -view[away] + rng.normal(0, 0.3, (away.sum(), 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal[rng.random(P) < 0.1] = 0.0
    f32 = np.float32
    return dict(pose=pose, pt_xyz=X.astype(f32), pt_desc=desc,
                pt_valid=valid, feat_uv=feat_uv, feat_desc=feat_desc,
                feat_octave=feat_octave, feat_valid=feat_valid,
                pt_normal=normal.astype(f32), pt_min_dist=mn.astype(f32),
                pt_max_dist=mx.astype(f32))


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


# --------------------------------------------------------------------------
# The monocular bootstrap
# --------------------------------------------------------------------------

TWOVIEW_CASES = ("general", "planar", "outliers", "rotation", "euroc_raw")


def _twoview_pair(rng, X, baseline=(0.3, 0.05, 0.0), rot=(0.02, -0.03, 0.01),
                  noise=0.3):
    """tests/test_twoview.py:_make_pair: the points X [N,3] seen from the
    origin and from (R2, t2), with pixel noise; (uv1, uv2, ok, R2, t2)."""
    K = K_EUROC
    R2 = lie.so3_exp(torch.tensor(rot, dtype=torch.float32)).double().numpy()
    t2 = np.asarray(baseline, np.float64)

    def project(R, t):
        pc = X @ R.T + t
        return np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                         K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1), pc[:, 2]

    uv1, z1 = project(np.eye(3), np.zeros(3))
    uv2, z2 = project(R2, t2)
    ok = (z1 > 0.1) & (z2 > 0.1)
    uv1 = uv1 + rng.normal(0, noise, uv1.shape)
    uv2 = uv2 + rng.normal(0, noise, uv2.shape)
    return uv1, uv2, ok, R2, t2


def build_twoview_cases(seed: int = 0, n: int = 200):
    """The correspondence cases of tests/test_twoview.py:18-97 at n matches,
    each from numpy default_rng(seed) as its test draws them: 'general'
    (points 3-8 m ahead, 0.3 m baseline), 'planar' (a tilted plane),
    'outliers' (the general case with 40 matches thrown 20-80 px),
    'rotation' (no baseline: must fail), and 'euroc_raw', the general
    scene's projections passed through the EuRoC cam0 rad-tan model
    (`ops.cameras.distort_pixels` at the `CameraConfig` coefficients): raw
    pixels, which the bootstrap sees only through `undistort_pixels`.

    Returns {name: dict(uv1, uv2 [n,2] float32, valid [n] bool, R, t (the
    true second camera, float64), X [n,3] (points in camera 1), bad (the
    outliers' rows, or None), raw (True where uv1 / uv2 are distorted))}."""
    from .config import CameraConfig
    from .ops import cameras as CAM

    def general(rng):
        X = rng.uniform(-2, 2, (n, 3))
        X[:, 2] = rng.uniform(3, 8, n)
        return X

    def planar(rng):
        X = rng.uniform(-2, 2, (n, 3))
        X[:, 2] = 5.0 + 0.3 * X[:, 0]
        return X

    out = {}
    for name in TWOVIEW_CASES:
        rng = np.random.default_rng(seed)
        X = planar(rng) if name == "planar" else general(rng)
        kw = dict(baseline=(0.0, 0.0, 0.0), rot=(0.05, 0.02, 0.0),
                  noise=0.2) if name == "rotation" else {}
        uv1, uv2, ok, R2, t2 = _twoview_pair(rng, X, **kw)
        bad = None
        if name == "outliers":
            bad = rng.choice(n, 40, replace=False)
            uv2[bad] += rng.uniform(20, 80, (40, 2)) \
                * rng.choice([-1, 1], (40, 2))
        uv1 = uv1.astype(np.float32)
        uv2 = uv2.astype(np.float32)
        if name == "euroc_raw":
            cam = CAM.make_camera(CameraConfig())
            uv1, uv2 = (CAM.distort_pixels(cam, torch.from_numpy(a)).numpy()
                        for a in (uv1, uv2))
        out[name] = dict(uv1=uv1, uv2=uv2, valid=ok, R=R2, t=t2, X=X,
                         bad=bad, raw=name == "euroc_raw")
    return out


def build_bootstrap_inputs(seed: int = 0, n_frames: int = 6):
    """Frames for the monocular bootstrap (after tests/test_e2e_mono.py:
    21-24): the room (4000 points, 200 lines, numpy default_rng(seed)),
    the 0.6 m orbit at 20 fps, each frame rendered at EuRoC K with zero
    distortion, and the 200 Hz IMU (`synthesize_imu`, default_rng(seed +
    1), biased) cut into each frame's batch: the samples in (t_{i-1},
    t_i], none for frame 0.

    Returns dict(frames [n] of [480,752] float32, timestamps [n], imu [n]
    of (gyro [k,3], acc [k,3], dt [k]) float32, pose_cw [n,3,4] float32
    (the true camera poses), bias_gyro, bias_acc)."""
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=200)
    traj = syn.make_orbit_trajectory(duration=n_frames / 20.0, fps=20.0,
                                     radius=0.6)
    frames = [syn.render_frame(scene, traj.R_wb[i], traj.p_wb[i], rng=rng)
              for i in range(n_frames)]
    imu = synthesize_imu(np.random.default_rng(seed + 1),
                         n_frames / 20.0 + 0.2, radius=0.6)
    batches, prev = [], -np.inf
    for ts in traj.timestamps:
        m = (imu.timestamps > prev) & (imu.timestamps <= ts)
        k = int(m.sum())
        batches.append((imu.gyro[m].astype(np.float32),
                        imu.acc[m].astype(np.float32),
                        np.full(k, 1.0 / 200.0, np.float32)))
        prev = ts
    R_cw = np.transpose(traj.R_wb, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, traj.p_wb)
    pose_cw = np.concatenate([R_cw, t_cw[..., None]], -1).astype(np.float32)
    return dict(frames=[np.asarray(f, np.float32) for f in frames],
                timestamps=traj.timestamps, imu=batches, pose_cw=pose_cw,
                bias_gyro=imu.bias_gyro, bias_acc=imu.bias_acc)


# --------------------------------------------------------------------------
# The keyframe sequence: a map kept alive over ~55 keyframes by a numpy
# stand-in for the tracker's keyframe insertion
# --------------------------------------------------------------------------

SEQ_KF = 58                 # keyframes: one every 3rd frame at 20 fps
SEQ_SCENE_POINTS = 50000
SEQ_SCENE_LINES = 4000
SEQ_FOUND = 0.9             # share of the visible mapped points found
SEQ_LINE_FOUND = 0.75       # ... of the visible mapped lines
SEQ_FRAMES = 3              # tracked frames a keyframe stands for
SEQ_RADIUS = 1.0            # the orbit's radius (m): walls 2-4 m away
SEQ_OMEGA = 0.6             # its rate (rad/s): 0.6 m/s, ~0.5 m/s^2
SEQ_LOCAL = 15              # newest keyframes whose landmarks are tracked


def build_keyframe_sequence(seed: int = 0, n_kf: int = SEQ_KF,
                            n_feat: int = 1000, n_line_feat: int = 256,
                            n_points: int = SEQ_SCENE_POINTS,
                            n_lines: int = SEQ_SCENE_LINES):
    """The scene, truth and IMU of the keyframe sequence (numpy,
    default_rng(seed)): the port's room (`io/synthetic.make_room_scene`,
    n_points points and n_lines segments on its walls, each point with a
    random 256-bit descriptor, a base angle, an octave and a detector
    response) and orbit (`_eval_orbit` at SEQ_RADIUS, SEQ_OMEGA: faster
    than the frames' orbit, so that IMU init sees ~0.5 m/s^2), one
    keyframe every 3rd frame at 20 fps (keyframe k at 0.15 (k + 1) s,
    n_kf of them: 8.7 s at 58), and a 200 Hz IMU along the orbit
    (`synthesize_imu`, EuRoC noise, gyro bias ~0.003 rad/s, no
    accelerometer bias).  The body frame is the camera's.

    The map starts in keyframe 0's camera frame at the monocular scale
    lam = 1 / (keyframe 0's median scene depth), as a two-view bootstrap
    leaves it: rotated off gravity, not metric.

    Returns a dict: t_kf [n_kf], R_wc [n_kf,3,3], p_wc [n_kf,3], v_w
    [n_kf,3] (the truth), pose_err [n_kf,6] (the tracker's smooth error:
    translation, rotation), X [P,3], desc [P,8] uint32, angle [P] (deg),
    octave [P], response [P] (a detector's, 0-1),
    seg [L,2,3], ldesc [L,8] uint32, imu (a SyntheticImu), lam, seed,
    n_feat, n_line_feat."""
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=n_points, n_lines=n_lines)
    t_kf = 0.15 * (np.arange(n_kf) + 1)
    traj = syn._eval_orbit(t_kf, SEQ_RADIUS, 0.3, SEQ_OMEGA)
    imu = synthesize_imu(rng, float(t_kf[-1]) + 0.1, radius=SEQ_RADIUS,
                         omega=SEQ_OMEGA, bias_gyro_mag=0.003,
                         bias_acc_mag=0.0)
    X = scene.points
    R_cw0 = traj.R_wb[0].T
    z0 = (X - traj.p_wb[0]) @ R_cw0.T
    vis0 = z0[:, 2] > 0.1
    # the tracker's pose error: smooth in time (three sinusoids of 0.2-0.6
    # Hz a component), ~2 mm and ~0.5 mrad
    f = rng.uniform(0.2, 0.6, (3, 6))
    ph = rng.uniform(0, 2 * np.pi, (3, 6))
    amp = np.concatenate([np.full(3, 1.2e-3), np.full(3, 3e-4)])
    err = (amp * np.sin(2 * np.pi * f[None] * t_kf[:, None, None]
                        + ph[None])).sum(1)
    return dict(
        t_kf=t_kf, R_wc=traj.R_wb, p_wc=traj.p_wb, v_w=traj.v_wb,
        pose_err=err, X=X,
        desc=rng.integers(0, 2 ** 32, (len(X), 8), dtype=np.uint32),
        angle=rng.uniform(0.0, 360.0, len(X)), octave=_octaves(rng, len(X)),
        response=rng.random(len(X)),
        seg=scene.lines,
        ldesc=rng.integers(0, 2 ** 32, (len(scene.lines), 8),
                           dtype=np.uint32),
        imu=imu, lam=float(1.0 / np.median(z0[vis0, 2])), seed=seed,
        n_feat=n_feat, n_line_feat=n_line_feat)


def _seq_view(seq, i, rng):
    """Keyframe i's features: (uv [n_feat,2], desc, octave, angle, scene
    id or -1 [n_feat]) and line features (ep [n_line_feat,4], desc, valid,
    scene id or -1), in a random order; the scene points and lines it
    sees (visible masks)."""
    K = K_EUROC
    width, height = 752, 480
    F, LF = seq["n_feat"], seq["n_line_feat"]
    R_cw = seq["R_wc"][i].T
    p = seq["p_wc"][i]

    def project(P):
        pc = (P - p) @ R_cw.T
        z = np.maximum(pc[:, 2], 1e-6)
        uv = np.stack([K.fx * pc[:, 0] / z + K.cx,
                       K.fy * pc[:, 1] / z + K.cy], -1)
        ok = (pc[:, 2] > 0.1) & (pc[:, 2] < 30.0)
        return uv, ok

    uv, ok = project(seq["X"])
    vis = ok & (uv[:, 0] >= 8) & (uv[:, 0] < width - 8) & (uv[:, 1] >= 8) \
        & (uv[:, 1] < height - 8)
    # the strongest responses in view, as a detector keeps them: the same
    # points from view to view but for the noise of the response
    sid = np.nonzero(vis)[0]
    resp = seq["response"][sid] + rng.normal(0, 0.03, len(sid))
    sid = rng.permutation(sid[np.argsort(-resp)[:int(0.88 * F)]])
    n = len(sid)
    # a scene point's octave is its own, +-1 in 2 views of 5
    octv = _octaves(rng, F)
    octv[:n] = np.clip(seq["octave"][sid]
                       + rng.choice([-1, 0, 0, 0, 1], n), 0, 7)
    fuv = uv[sid] + rng.normal(0, 1, (n, 2)) * 0.5 * 1.2 ** octv[:n, None]
    out = rng.random(n) < 0.02
    a = rng.uniform(0, 2 * np.pi, n)
    fuv[out] += 15.0 * np.stack([np.cos(a), np.sin(a)], -1)[out]
    fdesc = _flip_bits(rng, seq["desc"][sid], rng.integers(0, 11, n))
    fang = (seq["angle"][sid] + rng.normal(0, 2.0, n)) % 360.0
    nn = F - n
    all_uv = np.concatenate([fuv, np.stack([rng.uniform(0, width, nn),
                                            rng.uniform(0, height, nn)], -1)])
    all_desc = np.concatenate(
        [fdesc, rng.integers(0, 2 ** 32, (nn, 8), dtype=np.uint32)])
    all_ang = np.concatenate([fang, rng.uniform(0, 360.0, nn)])
    all_sid = np.concatenate([sid, np.full(nn, -1)])
    order = rng.permutation(F)
    feats = (all_uv[order].astype(np.float32), all_desc[order],
             octv[order], all_ang[order].astype(np.float32), all_sid[order])

    # a segment is seen as its longest run inside the image (sampled at
    # 64 points), if that run is at least 30 px long
    seg = seq["seg"]
    tt = np.linspace(0.0, 1.0, 64)
    P = seg[:, :1] + tt[None, :, None] * (seg[:, 1:] - seg[:, :1])
    suv, sok = project(P.reshape(-1, 3))
    suv, sok = suv.reshape(-1, 64, 2), sok.reshape(-1, 64)
    ins = sok & (suv[..., 0] >= 4) & (suv[..., 0] < width - 4) \
        & (suv[..., 1] >= 4) & (suv[..., 1] < height - 4)
    first = np.argmax(ins, 1)
    last = 63 - np.argmax(ins[:, ::-1], 1)
    # the run from the first inside sample while it stays inside
    out_after = ~ins & (np.arange(64)[None] > first[:, None])
    stop = np.where(out_after.any(1), np.argmax(out_after, 1) - 1, last)
    ar = np.arange(len(seg))
    us, ue = suv[ar, first], suv[ar, stop]
    lvis = ins.any(1) & (np.linalg.norm(ue - us, axis=1) >= 30.0)
    lsid = rng.permutation(np.nonzero(lvis)[0])[:int(0.75 * LF)]
    m = len(lsid)
    ep = np.concatenate([us[lsid], ue[lsid]], 1) + rng.normal(0, 0.3, (m, 4))
    flip = rng.random(m) < 0.5
    ep[flip] = ep[flip][:, [2, 3, 0, 1]]
    ldesc = _flip_bits(rng, seq["ldesc"][lsid], rng.integers(0, 13, m))
    nl = LF - m
    a0 = np.stack([rng.uniform(40, width - 40, nl),
                   rng.uniform(40, height - 40, nl)], -1)
    ang = rng.uniform(0, np.pi, nl)
    ln = rng.uniform(20, 120, nl)
    a1 = a0 + ln[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    lorder = rng.permutation(LF)
    lines = (np.concatenate([ep, np.concatenate([a0, a1], 1)])[lorder]
             .astype(np.float32),
             np.concatenate([ldesc, rng.integers(0, 2 ** 32, (nl, 8),
                                                 dtype=np.uint32)])[lorder],
             np.ones(LF, bool),
             np.concatenate([lsid, np.full(nl, -1)])[lorder])
    return feats, lines, vis, lvis


def _scene_of_landmarks(match, scene_of, kfs, valid, n_scene):
    """Each live landmark's scene id: the one most of its bound features
    carry (the lowest on a tie), -1 where none; and for each scene id the
    lowest live landmark carrying it (-1)."""
    rows = match[kfs]
    sc = np.stack([scene_of[int(k)] for k in kfs]) if len(kfs) else rows
    sel = (rows >= 0) & (sc >= 0)
    lm, s = rows[sel].astype(np.int64), sc[sel].astype(np.int64)
    lm_sid = np.full(len(valid), -1, np.int64)
    if len(lm):
        key, cnt = np.unique(lm * n_scene + s, return_counts=True)
        klm, ks = key // n_scene, key % n_scene
        order = np.lexsort((ks, -cnt, klm))
        klm, ks = klm[order], ks[order]
        first = np.ones(len(klm), bool)
        first[1:] = klm[1:] != klm[:-1]
        lm_sid[klm[first]] = ks[first]
    lm_sid[~valid] = -1
    best = np.full(n_scene, np.iinfo(np.int64).max)
    live = np.nonzero(lm_sid >= 0)[0]
    np.minimum.at(best, lm_sid[live], live)
    best[best == np.iinfo(np.int64).max] = -1
    return lm_sid, best


def _seq_preint(seq, t0, t1, bg, ba):
    """The raw IMU samples of (t0, t1] and their preintegration at (bg,
    ba) by the port's plain `ops/imu.preintegrate` (float32, the CPU), as
    numpy: ((gyro, acc, dt), Preintegrated)."""
    imu = seq["imu"]
    # sample times and keyframe times are both multiples of 5 ms, up to
    # float rounding
    m = (imu.timestamps > t0 + 1e-9) & (imu.timestamps <= t1 + 1e-9)
    ts = imu.timestamps[m]
    raw = (imu.gyro[m].astype(np.float32), imu.acc[m].astype(np.float32),
           np.diff(np.concatenate([[t0], ts])).astype(np.float32))
    cal = IMU.make_calib(ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
    p = IMU.preintegrate(*(torch.from_numpy(a) for a in raw),
                         torch.ones(len(ts), dtype=torch.bool), cal,
                         torch.from_numpy(np.asarray(bg, np.float32)),
                         torch.from_numpy(np.asarray(ba, np.float32)))
    return raw, IMU.Preintegrated(*(v.numpy() for v in p))


def _seq_pose(m, seq, i, track):
    """Keyframe i's camera pose T_cw and velocity in the map's current
    frame, as a tracker localizing against the map would report them: the
    true motion from the newest keyframe (its translation at the map's
    scale `track["s"]`) applied to that keyframe's pose in the map, with
    the increment of the sequence's smooth tracker error (`pose_err`)."""
    prev, ip = track["last_kf"], track["last_i"]
    s = track["s"]
    R_cw = [seq["R_wc"][j].T for j in (ip, i)]
    t_cw = [-R_cw[k] @ seq["p_wc"][j] for k, j in enumerate((ip, i))]
    e = seq["pose_err"][i] - seq["pose_err"][ip]
    dR = lie.so3_exp(torch.from_numpy(e[3:])).numpy()
    R_rel = dR @ R_cw[1] @ R_cw[0].T
    t_rel = s * (t_cw[1] - R_cw[1] @ R_cw[0].T @ t_cw[0] + e[:3])
    P = m.kf_pose_cw[prev].astype(np.float64)
    pose = np.concatenate([R_rel @ P[:, :3], (R_rel @ P[:, 3] + t_rel)
                           [:, None]], 1).astype(np.float32)
    R_mw = pose[:, :3].T.astype(np.float64) @ R_cw[1]
    return pose, (s * R_mw @ seq["v_w"][i]).astype(np.float32)


def _bind_keyframe(m, seq, kf, track, feats, lines, vis, lvis, rng):
    """Bind keyframe kf's features to the local map's points and lines
    (those bound in the SEQ_LOCAL newest keyframes) of their scene ids
    (the lowest id of a scene id, with probability
    SEQ_FOUND) and count the tracked frames since the last keyframe: each
    live landmark whose scene point is in view is visible in SEQ_FRAMES
    frames, and found in each with probability SEQ_FOUND if it is the
    lowest id of a scene id among the keyframe's features (a duplicate
    is never found, so `cull_points` removes it); lines with probability
    SEQ_LINE_FOUND."""
    chain = m.kf_chain()
    kfs = np.array([k for k in chain[chain != kf][-SEQ_LOCAL:]
                    if int(k) in track["feat_scene"]], int)
    n_sc = len(seq["X"])
    pt_sid, best = _scene_of_landmarks(m.kf_match_pt, track["feat_scene"],
                                       kfs, m.pt_valid, n_sc)
    seen = pt_sid >= 0
    seen[seen] = vis[pt_sid[seen]]
    m.pt_visible[seen] += SEQ_FRAMES
    sid = feats[4]
    cand = np.nonzero((sid >= 0) & (best[np.maximum(sid, 0)] >= 0))[0]
    m.pt_found[best[sid[cand]]] += rng.binomial(SEQ_FRAMES, SEQ_FOUND,
                                                len(cand)).astype(np.int32)
    cand = cand[rng.random(len(cand)) < SEQ_FOUND]
    pts = best[sid[cand]]
    n_ls = len(seq["seg"])
    ln_sid, lbest = _scene_of_landmarks(m.kf_match_ln, track["line_scene"],
                                        kfs, m.ln_valid, n_ls)
    lseen = ln_sid >= 0
    lseen[lseen] = lvis[ln_sid[lseen]]
    m.ln_visible[lseen] += SEQ_FRAMES
    lsid = lines[3]
    lc = np.nonzero((lsid >= 0) & (lbest[np.maximum(lsid, 0)] >= 0))[0]
    m.ln_found[lbest[lsid[lc]]] += rng.binomial(
        SEQ_FRAMES, SEQ_LINE_FOUND, len(lc)).astype(np.int32)
    lc = lc[rng.random(len(lc)) < SEQ_LINE_FOUND]
    lns = lbest[lsid[lc]]
    m.ln_n_obs[lns] += 1
    m.kf_match_ln[kf, lc] = lns
    m.add_observations(kf, cand, pts)


def _write_keyframe(m, kf, t, pose, vel, feats, lines):
    m.kf_timestamp[kf] = t
    m.kf_pose_cw[kf] = pose
    m.kf_vel[kf] = vel
    uv, desc, octv, ang, _ = feats
    m.kf_feat_uv[kf] = uv
    m.kf_feat_uv_raw[kf] = uv
    m.kf_feat_desc[kf] = desc
    m.kf_feat_octave[kf] = octv
    m.kf_feat_angle[kf] = ang
    m.kf_feat_valid[kf] = True
    m.kf_match_pt[kf] = -1
    m.kf_match_ln[kf] = -1
    m.kf_line_ep[kf], m.kf_line_desc[kf], m.kf_line_valid[kf] = lines[:3]


def start_keyframe_map(m, seq):
    """The two-keyframe map a monocular bootstrap leaves, in the map store
    m (the port's or the JAX package's: only the fields and methods both
    have): keyframes 0 and 1 at their true poses in the map frame
    (keyframe 0's camera frame at scale lam), a map point at the scene
    point of every feature pair the two share (3 mm noise, in metres) and
    a map line at every shared segment, both bound in both, and keyframe
    1's IMU window.  Returns the tracker stand-in's state: the map's scale
    s (map units per metre), the newest keyframe's slot and sequence
    index, and the scene ids of each keyframe's features and lines."""
    s = seq["lam"]
    R = seq["R_wc"][0].T
    t = -s * R @ seq["p_wc"][0]
    track = dict(s=s, feat_scene={}, line_scene={})
    rng = np.random.default_rng([seq["seed"], 0])
    views = [_seq_view(seq, i, rng) for i in (0, 1)]
    kfs = []
    for i, (feats, lines, _, _) in enumerate(views):
        kf = m.alloc_kf()
        if i:
            pose, vel = _seq_pose(m, seq, i, track)
        else:
            pose = np.eye(3, 4, dtype=np.float32)
            vel = (s * R @ seq["v_w"][0]).astype(np.float32)
        _write_keyframe(m, kf, seq["t_kf"][i], pose, vel, feats, lines)
        track["feat_scene"][kf] = feats[4]
        track["line_scene"][kf] = lines[3]
        track["last_kf"], track["last_i"] = kf, i
        kfs.append(kf)
    k0, k1 = kfs
    m.kf_next[k0], m.kf_prev[k1] = k1, k0
    raw, pre = _seq_preint(seq, seq["t_kf"][0], seq["t_kf"][1],
                           np.zeros(3), np.zeros(3))
    m.kf_imu_raw[k1], m.kf_preint[k1] = raw, pre
    (f0, l0, _, _), (f1, l1, _, _) = views
    shared = np.intersect1d(f0[4][f0[4] >= 0], f1[4][f1[4] >= 0])
    pts = m.alloc_points(len(shared))
    Xm = s * (seq["X"][shared] + rng.normal(0, 0.003, (len(shared), 3))) \
        @ R.T + t
    m.pt_xyz[pts] = Xm
    m.pt_desc[pts] = seq["desc"][shared]
    m.pt_first_kf[pts] = k0
    m.pt_n_obs[pts] = 2
    m.pt_found[pts] = 2
    m.pt_visible[pts] = 2
    for kf, f in ((k0, f0), (k1, f1)):
        pos = np.full(len(seq["X"]), -1)
        pos[f[4][f[4] >= 0]] = np.nonzero(f[4] >= 0)[0]
        m.kf_match_pt[kf, pos[shared]] = pts
    lsh = np.intersect1d(l0[3][l0[3] >= 0], l1[3][l1[3] >= 0])
    lns = m.alloc_lines(len(lsh))
    m.ln_ep[lns] = (s * (seq["seg"][lsh].reshape(-1, 3) @ R.T)
                    + t).reshape(-1, 6)
    m.ln_desc[lns] = seq["ldesc"][lsh]
    m.ln_first_kf[lns] = k0
    m.ln_n_obs[lns] = 2
    m.ln_found[lns] = 2
    m.ln_visible[lns] = 2
    for kf, ln in ((k0, l0), (k1, l1)):
        pos = np.full(len(seq["seg"]), -1)
        pos[ln[3][ln[3] >= 0]] = np.nonzero(ln[3] >= 0)[0]
        m.kf_match_ln[kf, pos[lsh]] = lns
    m.update_covisibility(k0)
    m.update_covisibility(k1)
    return track


def insert_keyframe(m, seq, i, track):
    """The tracker's keyframe insertion for keyframe i >= 2, a numpy
    stand-in until the host tracker is ported, on the map store m (the
    port's or the JAX package's): a new keyframe slot at keyframe i's true
    pose relative to the newest keyframe's in the map (`_seq_pose`),
    chained
    after the newest keyframe; its 1000 point and 256 line features
    (`_seq_view`: scene points in view with octave noise, flipped
    descriptor bits and 2% 15 px outliers, noise features to the count);
    each feature bound to the live landmark of its scene id (the lowest
    id) with probability SEQ_FOUND, pt_visible / pt_found raised for the 3
    frames since the last keyframe (`_bind_keyframe`; lines alike); the IMU
    samples since the newest keyframe in kf_imu_raw and their
    preintegration at its biases in kf_preint; the new keyframe's biases
    are the newest keyframe's.  Draws from default_rng([seed, i]).
    Returns the new keyframe's slot."""
    rng = np.random.default_rng([seq["seed"], i])
    feats, lines, vis, lvis = _seq_view(seq, i, rng)
    prev = track["last_kf"]
    pose, vel = _seq_pose(m, seq, i, track)
    kf = m.alloc_kf()
    _write_keyframe(m, kf, seq["t_kf"][i], pose, vel, feats, lines)
    track["feat_scene"][kf] = feats[4]
    track["line_scene"][kf] = lines[3]
    m.kf_prev[kf], m.kf_next[kf] = prev, -1
    m.kf_next[prev] = kf
    bg, ba = m.kf_bias_g[prev].copy(), m.kf_bias_a[prev].copy()
    m.kf_bias_g[kf], m.kf_bias_a[kf] = bg, ba
    raw, pre = _seq_preint(seq, float(m.kf_timestamp[prev]), seq["t_kf"][i],
                           bg, ba)
    m.kf_imu_raw[kf], m.kf_preint[kf] = raw, pre
    _bind_keyframe(m, seq, kf, track, feats, lines, vis, lvis, rng)
    track["last_kf"], track["last_i"] = kf, i
    return kf


def compose_transform(track, pending):
    """The tracker stand-in takes the mapper's pending transform (R_gw,
    s), X' = s R_gw X: the map's scale becomes s times its own (its
    rotation reaches the stand-in through the newest keyframe's pose,
    which the transform re-expressed)."""
    track["s"] = float(pending[1]) * track["s"]


def build_inertial_map(seq, n_kf: int, store=None, seed: int = 1):
    """The map the keyframe step holds after IMU init, built directly from
    the sequence's truth (numpy, default_rng(seed)): keyframes 0..n_kf-1
    of `seq` chained, in the metric gravity-aligned world frame, their
    poses with the tracker's smooth error, true velocities, biases zero
    and the IMU windows preintegrated at them; a map point at each scene
    point featured in >= 2 of the keyframes (3 mm noise) and a map line at
    each segment featured in >= 3, bound wherever featured; the
    covisibility, and the IMU stages set (initialized, ba1).  `store`:
    the port MapStore's capacities (production's by default).  Returns
    the port `MapStore`."""
    from .models.mapstore import MapStore
    rng = np.random.default_rng(seed)
    m = MapStore(n_feat=seq["n_feat"], n_line_feat=seq["n_line_feat"],
                 **(store or {}))
    views = [_seq_view(seq, i, rng) for i in range(n_kf)]
    for i, (feats, lines, _, _) in enumerate(views):
        kf = m.alloc_kf()
        R_cw = seq["R_wc"][i].T
        e = seq["pose_err"][i]
        dR = lie.so3_exp(torch.from_numpy(e[3:])).numpy()
        pose = np.concatenate([dR @ R_cw, (-R_cw @ seq["p_wc"][i] + e[:3])
                               [:, None]], 1)
        _write_keyframe(m, kf, seq["t_kf"][i], pose.astype(np.float32),
                        seq["v_w"][i].astype(np.float32), feats, lines)
        if i:
            m.kf_prev[kf], m.kf_next[kf - 1] = kf - 1, kf
            raw, pre = _seq_preint(seq, seq["t_kf"][i - 1], seq["t_kf"][i],
                                   np.zeros(3), np.zeros(3))
            m.kf_imu_raw[kf], m.kf_preint[kf] = raw, pre
    for fam, key, n_min in (("pt", 4, 2), ("ln", 3, 3)):
        sids = np.stack([v[0 if fam == "pt" else 1][key] for v in views])
        src = seq["X"] if fam == "pt" else seq["seg"]
        cnt = np.bincount(sids[sids >= 0], minlength=len(src))
        keep = np.nonzero(cnt >= n_min)[0]
        if fam == "pt":
            ids = m.alloc_points(len(keep))
            m.pt_xyz[ids] = src[keep] + rng.normal(0, 0.003, (len(keep), 3))
            m.pt_desc[ids] = seq["desc"][keep]
        else:
            ids = m.alloc_lines(len(keep))
            m.ln_ep[ids] = src[keep].reshape(-1, 6) \
                + rng.normal(0, 0.003, (len(keep), 6))
            m.ln_desc[ids] = seq["ldesc"][keep]
        lm_of = np.full(len(src), -1)
        lm_of[keep] = ids
        match = np.where(sids >= 0, lm_of[np.maximum(sids, 0)], -1)
        first = np.full(len(src), -1)
        for k in range(n_kf - 1, -1, -1):
            first[sids[k][sids[k] >= 0]] = k
        if fam == "pt":
            m.pt_first_kf[ids] = first[keep]
            m.kf_match_pt[:n_kf] = match
            m.pt_n_obs[ids] = cnt[keep]
            m.pt_found[ids] = cnt[keep]
            m.pt_visible[ids] = cnt[keep]
        else:
            m.ln_first_kf[ids] = first[keep]
            m.kf_match_ln[:n_kf] = match
            m.ln_n_obs[ids] = cnt[keep]
            m.ln_found[ids] = cnt[keep]
            m.ln_visible[ids] = cnt[keep]
    for k in range(n_kf):
        m.update_covisibility(k)
    m.imu_initialized = m.imu_ba1 = True
    return m


# --------------------------------------------------------------------------
# The tracked sequence: rendered frames with their IMU batches, as
# scripts/run_synthetic_vi.py makes them
# --------------------------------------------------------------------------

TRACK_FRAMES = 180          # 9 s at 20 fps


def build_tracked_sequence(seed: int = 0, n_frames: int = TRACK_FRAMES):
    """The inputs of scripts/run_synthetic_vi.py:28-56 (numpy,
    default_rng(seed) shared in the script's order): the room with 4000
    points and 60 segments, the 0.6 m orbit at 20 fps over n_frames / 20
    + 0.2 s, the 200 Hz IMU along it (EuRoC noise, gyro bias ~0.002 rad/s,
    accelerometer bias ~0.01 m/s^2), then each frame rendered at EuRoC K
    without distortion; frame i's IMU batch is the samples in (t_{i-1},
    t_i] with their time steps, none for frame 0.

    Returns dict(frames [n] of [480,752] float32, timestamps [n], imu [n]
    of (gyro [k,3], acc [k,3], dt [k]) float64 or None, R_wc [n,3,3],
    p_wc [n,3] (the truth: the body frame is the camera's), bias_gyro,
    bias_acc)."""
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=60)
    dur = n_frames / 20.0 + 0.2
    traj = syn.make_orbit_trajectory(duration=dur, fps=20.0, radius=0.6)
    imu = synthesize_imu(rng, dur, radius=0.6, noise_gyro=1.7e-4,
                         noise_acc=2e-3, bias_gyro_mag=0.002,
                         bias_acc_mag=0.01)
    n = min(n_frames, len(traj.timestamps))
    frames, batches, last_t = [], [], None
    for i in range(n):
        t = traj.timestamps[i]
        frames.append(np.asarray(syn.render_frame(
            scene, traj.R_wb[i], traj.p_wb[i], rng=rng), np.float32))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            ts = imu.timestamps[sel]
            batches.append((imu.gyro[sel], imu.acc[sel],
                            np.diff(np.concatenate([[last_t], ts]))))
        last_t = t
    return dict(frames=frames, timestamps=traj.timestamps[:n], imu=batches,
                R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n],
                bias_gyro=imu.bias_gyro, bias_acc=imu.bias_acc)


MH_SECONDS = 8.0
MH_SEED = 7


def build_mh_replay(seconds: float = MH_SECONDS, seed: int = MH_SEED,
                    n_points: int = 9000, n_lines: int = 500,
                    n_frames=None):
    """The inputs of tests/test_mh_replay_regression.py:21-48 (numpy,
    default_rng(seed) shared in its order): the machine hall with n_points
    points and n_lines structural lines, the MH trajectory at 20 fps over
    seconds + 0.3 s, the 200 Hz IMU along it with bias random walk, then
    every frame rendered in order (752x480, motion blur, exposure jitter,
    vignetting, noise; the first n_frames only where given); frame i's
    IMU batch is the samples in (t_{i-1}, t_i] with their time steps, none
    for frame 0.  Rendering takes ~0.5 s a frame of one CPU core.

    Returns dict(frames [n] of [480,752] float32, timestamps [n], imu [n]
    of (gyro [k,3], acc [k,3], dt [k]) float64 or None, R_wc [n,3,3],
    p_wc [n,3] (the truth: the body frame is the camera's), scene, traj,
    imu_data)."""
    rng = np.random.default_rng(seed)
    scene = syn.make_hall_scene(rng, n_points=n_points, n_lines=n_lines)
    traj = syn.make_mh_trajectory(seconds + 0.3, fps=20.0)
    imu = syn.synthesize_imu_mh(rng, seconds + 0.3)
    n = len(traj.timestamps) if n_frames is None \
        else min(n_frames, len(traj.timestamps))
    frames, batches, last_t = [], [], None
    for i in range(n):
        t = traj.timestamps[i]
        frames.append(syn.render_frame_realistic(scene, syn._eval_mh, t,
                                                 rng))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            ts = imu.timestamps[sel]
            batches.append((imu.gyro[sel], imu.acc[sel],
                            np.diff(np.concatenate([[last_t], ts]))))
        last_t = t
    return dict(frames=frames, timestamps=traj.timestamps[:n], imu=batches,
                R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n], scene=scene,
                traj=traj, imu_data=imu)


def _stereo_world(seconds: float, seed: int, n_points: int = 9000,
                  n_lines: int = 500):
    """(rng, hall, MH trajectory, IMU): `build_mh_replay`'s world, the
    generator left where its first frame draws."""
    rng = np.random.default_rng(seed)
    scene = syn.make_hall_scene(rng, n_points=n_points, n_lines=n_lines)
    traj = syn.make_mh_trajectory(seconds + 0.3, fps=20.0)
    imu = syn.synthesize_imu_mh(rng, seconds + 0.3)
    return rng, scene, traj, imu


def build_stereo_replay(seconds: float = MH_SECONDS, seed: int = MH_SEED,
                        n_points: int = 9000, n_lines: int = 500,
                        n_frames=None, frames=None):
    """`build_mh_replay`'s hall, trajectory and IMU with both views of a
    rectified pair: per frame the left view, then the right one (the
    camera moved STEREO_BASELINE along its own x axis, every sub-exposure
    alike), drawn from the one generator in that order.  Rendering takes
    ~1 s a pair of one CPU core.  `frames`, where given, holds the views
    already rendered (left and right [n,480,752] arrays, e.g.
    `render_stereo_replay`'s by another process) and nothing is rendered.

    Returns `build_mh_replay`'s dict with `right` [n] of [480,752]
    float32 beside `frames` (the left views)."""
    rng, scene, traj, imu = _stereo_world(seconds, seed, n_points, n_lines)
    right_ev = syn.right_eye(syn._eval_mh, STEREO_BASELINE)
    n = len(traj.timestamps) if n_frames is None \
        else min(n_frames, len(traj.timestamps))
    left, right, batches, last_t = [], [], [], None
    for i in range(n):
        t = traj.timestamps[i]
        if frames is not None:
            left.append(frames[0][i])
            right.append(frames[1][i])
        else:
            left.append(syn.render_frame_realistic(scene, syn._eval_mh, t,
                                                   rng))
            right.append(syn.render_frame_realistic(scene, right_ev, t,
                                                    rng))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            ts = imu.timestamps[sel]
            batches.append((imu.gyro[sel], imu.acc[sel],
                            np.diff(np.concatenate([[last_t], ts]))))
        last_t = t
    return dict(frames=left, right=right, timestamps=traj.timestamps[:n],
                imu=batches, R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n],
                scene=scene, traj=traj, imu_data=imu)


def render_stereo_replay(left: np.ndarray, right: np.ndarray,
                         seconds: float = MH_SECONDS,
                         seed: int = MH_SEED) -> None:
    """`build_stereo_replay`'s views, rendered in order into left / right
    [n,480,752] float32 (shared buffers: another process renders while the
    caller does other work)."""
    rng, scene, traj, _ = _stereo_world(seconds, seed)
    right_ev = syn.right_eye(syn._eval_mh, STEREO_BASELINE)
    for i in range(len(left)):
        t = traj.timestamps[i]
        left[i] = syn.render_frame_realistic(scene, syn._eval_mh, t, rng)
        right[i] = syn.render_frame_realistic(scene, right_ev, t, rng)


def build_stereo_room(seed: int = 0, n_frames: int = 15, imu: bool = False,
                      n_lines: int = 60):
    """The room orbits of tests/test_stereo.py:14-30 (imu False: 1 s,
    STEREO) and tests/test_stereo_inertial.py:24-55 (imu True: 3 s with
    the low-noise, bias-free 200 Hz IMU): default_rng(seed), the room with
    4000 points and n_lines lines (60 there), the 0.6 m orbit at 20 fps,
    then per frame
    the left and the right view (render_frame with noise, in that order);
    frame i's IMU batch is the samples in (t_{i-1}, t_i], none for frame 0
    (None throughout without imu).

    Returns dict(frames, right [n] of [480,752] float32, timestamps [n],
    imu [n], R_wc [n,3,3], p_wc [n,3], scene)."""
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=n_lines)
    duration = 3.0 if imu else 1.0
    traj = syn.make_orbit_trajectory(duration=duration, radius=0.6)
    data = synthesize_imu(rng, duration, radius=0.6, noise_gyro=1e-5,
                          noise_acc=1e-4, bias_gyro_mag=0.0,
                          bias_acc_mag=0.0) if imu else None
    n = min(n_frames, len(traj.timestamps))
    frames, right, batches, last_t = [], [], [], None
    for i in range(n):
        t = traj.timestamps[i]
        R, p = traj.R_wb[i], traj.p_wb[i]
        frames.append(np.asarray(syn.render_frame(scene, R, p, rng=rng),
                                 np.float32))
        right.append(np.asarray(syn.render_frame(
            scene, R, p + R[:, 0] * STEREO_BASELINE, rng=rng), np.float32))
        if data is None or last_t is None:
            batches.append(None)
        else:
            sel = (data.timestamps > last_t) & (data.timestamps <= t)
            batches.append((data.gyro[sel], data.acc[sel], np.diff(
                np.concatenate([[last_t], data.timestamps[sel]]))))
        last_t = t
    return dict(frames=frames, right=right, timestamps=traj.timestamps[:n],
                imu=batches, R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n],
                scene=scene)


def build_rgbd_room(seed: int = 0, n_frames: int = 12, bf: float = 0.0):
    """The RGB-D room orbit of tests/test_stereo.py:41-63: default_rng(seed),
    the room with 4000 points and no lines, the 1 s orbit of radius 0.6 m,
    then per frame the view (render_frame with noise) and its oracle depth
    image (`io.synthetic.oracle_depth`, EuRoC K).  `bf` is the depth
    camera's baseline times fx (ORB-SLAM3's `Camera.bf`, 40.0 in its TUM
    RGB-D settings; 0 keeps the residuals mono): it changes no input and
    is carried to the configuration (`entry.rgbd_room`).

    Returns dict(frames, depth [n] of [480,752] float32, timestamps [n],
    imu [n] of None, R_wc [n,3,3], p_wc [n,3], scene, bf)."""
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=0)
    traj = syn.make_orbit_trajectory(duration=1.0, radius=0.6)
    n = min(n_frames, len(traj.timestamps))
    frames, depth = [], []
    for i in range(n):
        R, p = traj.R_wb[i], traj.p_wb[i]
        frames.append(np.asarray(syn.render_frame(scene, R, p, rng=rng),
                                 np.float32))
        depth.append(syn.oracle_depth(scene, R, p))
    return dict(frames=frames, depth=depth, timestamps=traj.timestamps[:n],
                imu=[None] * n, R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n],
                scene=scene, bf=float(bf))


KB8_K = (0.01, -0.005, 0.002, 0.0)   # tests/test_kb8_native.py:130
KB8_INTRINSICS = dict(fx=380.0, fy=380.0, cx=376.0, cy=240.0)


def kb8_camera() -> "KB8K":
    """The fisheye room's lens as the BA and pose edges take it."""
    return KB8K(**KB8_INTRINSICS, k1=KB8_K[0], k2=KB8_K[1], k3=KB8_K[2],
                k4=KB8_K[3])


def build_kb8_window(n_kf: int = 16, n_pt: int = 2048, n_obs: int = 4096,
                     perturbed: bool = True, device="cuda",
                     n_ln: int = 0, n_lobs: int = 0):
    """The point-only window BA of a KB8 camera at the typical bucket:
    `build_mapping_inputs`' window (its keyframes, points and observation
    pairs, seed 1), observed through the fisheye room's lens
    (`kb8_camera`, float64 numpy) on raw pixels with N(0, 0.5) px noise
    (default_rng(2)), from `perturb_window`'s start when `perturbed`.
    Returns dict of `make_local_ba`'s arguments (kf_poses, kf_free,
    pt_xyz, pt_free, obs_kf, obs_pt, obs_uv, obs_valid, obs_is2) on
    `device`.  With n_lobs > 0 the window of `make_local_ba_pl` with a
    KB8K camera: `build_mapping_inputs`' lines too, each observation the
    line equation of its endpoints' pinhole projections at the camera's
    fx, fy, cx, cy (the line edge of a KB8K) with N(0, 0.5) px noise
    (default_rng(3)), the endpoints perturbed by N(0, 0.02) (default_rng(
    4)) when `perturbed`; then every key of BA_KEYS."""
    dev = resolve_device(device)
    A = build_mapping_inputs(n_kf, n_pt, n_obs, 64, n_ln, n_lobs,
                             device="cpu")
    P = A["kf_poses"].numpy().astype(np.float64)
    X = A["pt_xyz"].numpy().astype(np.float64)
    okf, opt = A["obs_kf"].numpy(), A["obs_pt"].numpy()
    pc = np.einsum("oij,oj->oi", P[okf, :, :3], X[opt]) + P[okf, :, 3]
    K8 = kb8_camera()
    uv = syn._kb8_project_cam_np(pc, K8.fx, K8.fy, K8.cx, K8.cy, KB8_K)
    uv += np.random.default_rng(2).normal(0, 0.5, uv.shape)
    out = {k: A[k] for k in ("kf_poses", "kf_free", "pt_xyz", "pt_free",
                             "obs_kf", "obs_pt", "obs_valid", "obs_is2")}
    out["obs_uv"] = torch.from_numpy(uv.astype(np.float32))
    if perturbed:
        Pp, Xp = perturb_window(A["kf_poses"].numpy(), A["pt_xyz"].numpy())
        out["kf_poses"], out["pt_xyz"] = (torch.from_numpy(Pp),
                                          torch.from_numpy(Xp))
    keys = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
            "obs_uv", "obs_valid", "obs_is2")
    if n_lobs:
        L = A["ln_ep6"].numpy().astype(np.float64)
        lkf, lln = A["lobs_kf"].numpy(), A["lobs_ln"].numpy()
        lrng = np.random.default_rng(3)
        out["lobs_eq"] = torch.from_numpy(_line_obs(
            lrng, K8, P[lkf], L[lln], 0.5)[0])
        for k in ("ln_free", "lobs_kf", "lobs_ln", "lobs_valid",
                  "lobs_is2"):
            out[k] = A[k]
        out["ln_ep6"] = A["ln_ep6"]
        if perturbed:
            out["ln_ep6"] = A["ln_ep6"] + torch.from_numpy(
                np.random.default_rng(4).normal(0, 0.02, L.shape).astype(
                    np.float32))
        keys = keys + ("ln_ep6", "ln_free", "lobs_kf", "lobs_ln", "lobs_eq",
                       "lobs_valid", "lobs_is2")
    return {k: out[k].contiguous().to(dev) for k in keys}


def _line_obs(rng, K, P, L, noise: float):
    """Observations of segments L [n,6] (float64) by cameras P [n,3,4]
    T_cw through the pinhole fx, fy, cx, cy of K: both endpoints projected
    with N(0, noise) px added (start, then end).  Returns (line equations
    [n,3] |(a, b)| = 1, unit directions end - start [n,2]) float32."""
    uv = []
    for k in range(2):
        pc = np.einsum("nij,nj->ni", P[:, :, :3], L[:, 3 * k:3 * k + 3]) \
            + P[:, :, 3]
        z = np.maximum(pc[:, 2], 1e-3)
        uv.append(np.stack([K.fx * pc[:, 0] / z + K.cx,
                            K.fy * pc[:, 1] / z + K.cy], -1)
                  + rng.normal(0, noise, (len(L), 2)))
    one = np.ones((len(L), 1))
    leq = np.cross(np.concatenate([uv[0], one], 1),
                   np.concatenate([uv[1], one], 1))
    leq /= np.maximum(np.linalg.norm(leq[:, :2], axis=1, keepdims=True),
                      1e-9)
    d = uv[1] - uv[0]
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)
    return leq.astype(np.float32), d.astype(np.float32)


def build_line_window(n_kf: int = 16, n_ln: int = 512, n_lobs: int = 1024,
                      m_ln: int = 128, seed: int = 5, perturbed: bool = True,
                      device="cuda"):
    """The line-only window BA of SLAM modes 1-3 at production's caps
    (models/local_mapping.py: 16 KF x 512 lines x 1024 observations):
    `build_mapping_inputs`' keyframes (seed 1), m_ln segments (default_rng(
    seed): start points in its box, 0.5-1.5 m long in a random direction),
    each seen by n_lobs // m_ln distinct keyframes, observed through the
    EuRoC pinhole with N(0, 0.5) px noise (`_line_obs`: the line equation
    and the unit direction); the other n_ln - m_ln line slots padded
    (ln_free false), as the mapper pads its buckets.  With `perturbed` the
    keyframes start from `perturb_window` and the endpoints move by
    N(0, 0.05).  Returns dict of `make_local_ba_lines_only`'s arguments
    (kf_poses, kf_free, ln_ep6, ln_free, lobs_kf, lobs_ln, lobs_eq,
    lobs_dir, lobs_valid, lobs_is2) on `device`."""
    dev = resolve_device(device)
    A = build_mapping_inputs(n_kf, 64, 128, 64, 0, 0, device="cpu")
    P = A["kf_poses"].numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    per = n_lobs // m_ln
    Xs = rng.uniform([-3, -2, 4], [3, 2, 10], (m_ln, 3))
    d = rng.normal(0, 1, (m_ln, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    L = np.concatenate([Xs, Xs + d * rng.uniform(0.5, 1.5, (m_ln, 1))], 1)
    lkf = np.concatenate([rng.choice(n_kf, per, replace=False)
                          for _ in range(m_ln)]).astype(np.int32)
    lln = np.repeat(np.arange(m_ln), per).astype(np.int32)
    leq, ldir = _line_obs(rng, K_EUROC, P[lkf], L[lln], 0.5)
    ln = np.zeros((n_ln, 6))
    ln[:m_ln] = L
    kf = A["kf_poses"].numpy()
    if perturbed:
        kf = perturb_window(kf, np.zeros((1, 3), np.float32))[0]
        ln[:m_ln] += np.random.default_rng(seed + 1).normal(0, 0.05,
                                                             (m_ln, 6))

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    n = len(lkf)
    return dict(kf_poses=t(kf), kf_free=t(np.arange(n_kf) > 0, bool),
                ln_ep6=t(ln), ln_free=t(np.arange(n_ln) < m_ln, bool),
                lobs_kf=t(lkf, np.int32), lobs_ln=t(lln, np.int32),
                lobs_eq=t(leq), lobs_dir=t(ldir),
                lobs_valid=t(np.ones(n, bool), bool),
                lobs_is2=t(np.ones(n)))


def build_line_pose_case(seed: int = 0, cap: int = 256, n: int = 160,
                         outliers: float = 0.1, device="cuda"):
    """The line-only pose LM's inputs at the tracker's cap (256 map
    lines): n of the cap's rows valid, segments 1.5-6 m in front of a
    pose near the identity (default_rng(seed)), observed through the
    EuRoC pinhole with N(0, 0.5) px noise (`_line_obs`), a share
    `outliers` of them observed 30 px off across the segment; the start
    the truth moved by N(0, 0.02) rad / m.  Returns (pose0 [3,4], l_obs
    [cap,3], dir_obs [cap,2], Xs, Xe [cap,3], valid [cap], is2 [cap]) on
    `device`, then the true pose [3,4] in numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.05, 3))).numpy()
    P = np.concatenate([R, rng.normal(0, 0.1, (3, 1))], 1)
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.3, 1.3, n),
                   rng.uniform(1.5, 6.0, n)], -1)
    Xs = (pc - P[:, 3]) @ R
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Xe = Xs + 0.8 * d
    L = np.concatenate([Xs, Xe], 1)
    leq, ldir = _line_obs(rng, K_EUROC, np.repeat(P[None], n, 0), L, 0.5)
    bad = rng.random(n) < outliers
    leq[bad, 2] += 30.0          # the observed line moved 30 px
    dx = rng.normal(0, 0.02, 6)
    dR = lie.so3_exp(torch.from_numpy(dx[3:])).numpy()
    P0 = np.concatenate([dR @ P[:, :3], (dR @ P[:, 3] + dx[:3])[:, None]], 1)

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)
    valid = torch.from_numpy(np.arange(cap) < n).to(dev)
    return (torch.from_numpy(P0.astype(np.float32)).to(dev), pad(leq),
            pad(ldir), pad(Xs), pad(Xe), valid,
            torch.ones(cap, dtype=torch.float32, device=dev)), P





def build_kb8_room(seed: int = 0, n_frames: int = 30):
    """The fisheye room of tests/test_kb8_native.py:116-169:
    default_rng(seed), the room with 4000 points and 10 lines, the orbit of
    radius 0.6 m at 20 fps over n_frames / 20 s, then per frame the raw
    KB8 view (`io.synthetic.render_frame_kb8`, k = KB8_K, fx = fy = 380,
    cx = 376, cy = 240, 752x480, with noise).

    Returns dict(frames [n] of [480,752] float32, timestamps [n], imu [n]
    of None, R_wc [n,3,3], p_wc [n,3], scene)."""
    rng = np.random.default_rng(seed)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=10)
    traj = syn.make_orbit_trajectory(duration=n_frames / 20.0, fps=20.0,
                                     radius=0.6)
    n = min(n_frames, len(traj.timestamps))
    frames = [np.asarray(syn.render_frame_kb8(
        scene, traj.R_wb[i], traj.p_wb[i], k=KB8_K, rng=rng,
        **KB8_INTRINSICS), np.float32) for i in range(n)]
    return dict(frames=frames, timestamps=traj.timestamps[:n],
                imu=[None] * n, R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n],
                scene=scene)


def build_kb8_vi_replay(seconds: float = MH_SECONDS, seed: int = MH_SEED,
                        n_frames=None, frames=None):
    """The MH replay seen through the fisheye room's lens: `build_mh_replay`'s
    world, trajectory and 200 Hz IMU (its generators, in its rng order),
    each frame the raw KB8 view of the hall at the frame's pose
    (`io.synthetic.render_frame_kb8`, KB8_INTRINSICS, k = KB8_K, 752x480,
    with noise).  The KB8 renderer draws the points only (a straight
    segment is a curve under the lens, plvio_tpu/io/synthetic.py:330-333),
    so the line front end finds few segments on these frames.  `frames`,
    where given, holds the views already rendered (e.g. by
    `render_kb8_vi_replay` in another process) and nothing is rendered.

    Returns `build_mh_replay`'s dict (frames [n] of [480,752] float32,
    timestamps, imu batches, R_wc, p_wc, scene, traj, imu_data)."""
    rng, scene, traj, imu = _stereo_world(seconds, seed)
    n = len(traj.timestamps) if n_frames is None \
        else min(n_frames, len(traj.timestamps))
    out, batches, last_t = [], [], None
    for i in range(n):
        t = traj.timestamps[i]
        out.append(frames[i] if frames is not None else np.asarray(
            syn.render_frame_kb8(scene, traj.R_wb[i], traj.p_wb[i], k=KB8_K,
                                 rng=rng, **KB8_INTRINSICS), np.float32))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            ts = imu.timestamps[sel]
            batches.append((imu.gyro[sel], imu.acc[sel],
                            np.diff(np.concatenate([[last_t], ts]))))
        last_t = t
    return dict(frames=out, timestamps=traj.timestamps[:n], imu=batches,
                R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n], scene=scene,
                traj=traj, imu_data=imu)


def render_kb8_vi_replay(out: np.ndarray, seconds: float = MH_SECONDS,
                         seed: int = MH_SEED) -> None:
    """`build_kb8_vi_replay`'s frames, rendered in order into out
    [n,480,752] float32 (a shared buffer)."""
    rng, scene, traj, _ = _stereo_world(seconds, seed)
    for i in range(len(out)):
        out[i] = syn.render_frame_kb8(scene, traj.R_wb[i], traj.p_wb[i],
                                      k=KB8_K, rng=rng, **KB8_INTRINSICS)


PNP_CASES = ("place", "rendered")


def build_pnp_case(name: str = "rendered", seed: int = 0):
    """2D-3D matches for `ops.pnp` at relocalization's shapes: "place",
    tests/test_place_recognition.py:65-87's 200 matches (points 4-8 m
    ahead, 0.5 px noise, 25% outliers); "rendered", 512 rows as the
    tracker pads them, 400 valid: the MH replay's hall seen from its
    trajectory at 5 s, 1 px noise, 20% outliers.  Returns (uv [N,2], X
    [N,3] float32, valid [N] bool, T_cw [3,4] the truth)."""
    rng = np.random.default_rng(seed)
    K = K_EUROC
    if name == "place":
        n = 200
        X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        X[:, 2] += 6
        w, t = rng.normal(0, 0.3, 3), rng.normal(0, 0.5, 3)
        R = lie.so3_exp(torch.tensor(w, dtype=torch.float32)).numpy()
        pc = X @ R.T + t
        uv = np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                       K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1)
        uv += rng.normal(0, 0.5, uv.shape)
        bad = rng.choice(n, n // 4, replace=False)
        uv[bad] += rng.uniform(40, 150, (len(bad), 2))
        return (uv.astype(np.float32), X, np.ones(n, bool),
                np.concatenate([R, t[:, None]], 1).astype(np.float32))
    scene = syn.make_hall_scene(rng, n_points=9000, n_lines=500)
    traj = syn._eval_mh(np.array([5.0]))
    R_wc, p_wc = traj.R_wb[0], traj.p_wb[0]
    uv_all, _, vis, _, _ = syn.project_scene(scene, R_wc, p_wc, K.fx, K.fy,
                                             K.cx, K.cy, 752, 480)
    ids = np.nonzero(vis)[0][:400]
    N = 512
    X = np.zeros((N, 3), np.float32)
    uv = np.zeros((N, 2), np.float32)
    X[:400] = scene.points[ids]
    uv[:400] = uv_all[ids] + rng.normal(0, 1.0, (400, 2))
    bad = rng.choice(400, 80, replace=False)
    uv[bad] += rng.uniform(30, 120, (80, 2)) * rng.choice([-1, 1], (80, 2))
    valid = np.zeros(N, bool)
    valid[:400] = True
    T = np.concatenate([R_wc.T, (-R_wc.T @ p_wc)[:, None]], 1)
    return uv, X, valid, T.astype(np.float32)


# --------------------------------------------------------------------------
# Loop closing: the hand-made maps of the reference's loop-closing tests and
# the closed circuit of scripts/run_mh_loop.py
# --------------------------------------------------------------------------
LOOP_CASES = ("circle", "merge")


def pack_bits_np(pm1: np.ndarray) -> np.ndarray:
    """[...,256] {-1,+1} descriptors -> [...,8] uint32 (bit j of word w is
    descriptor bit 32 w + j, as ops/matching.py `pack_bits_u32`)."""
    bits = (pm1 > 0).astype(np.uint64).reshape(pm1.shape[:-1] + (8, 32))
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _circle_cam(a: float, radius: float = 1.2):
    """A camera on the circle of `radius` at angle a looking outward:
    (R_wc, p)."""
    c, s = np.cos(a), np.sin(a)
    p = np.array([radius * c, radius * s, 0.0])
    look = np.array([c, s, 0.0])
    x = np.cross([0, 0, -1.0], look)
    x /= np.linalg.norm(x)
    y = np.cross(look, x)
    return np.stack([x, y, look], -1), p


def _wall_projection(pts_w, R_cw, t_cw, K=K_EUROC, n_feat: int = 256):
    """The first n_feat wall points in front of the camera and inside the
    image (10 px margin): (indices, uv)."""
    pc = pts_w @ R_cw.T + t_cw
    z = pc[:, 2]
    uv = np.stack([K.fx * pc[:, 0] / np.maximum(z, 1e-6) + K.cx,
                   K.fy * pc[:, 1] / np.maximum(z, 1e-6) + K.cy], -1)
    vis = (z > 0.3) & (uv[:, 0] > 10) & (uv[:, 0] < 742) \
        & (uv[:, 1] > 10) & (uv[:, 1] < 470)
    sel = np.nonzero(vis)[0][:n_feat]
    return sel, uv[sel]


def build_drifted_loop_map(seed: int = 0, n_kf: int = 16,
                           drift: float = 0.25):
    """tests/test_loop_closing.py:15's drifted circle: 1200 wall points on a
    3 m cylinder with one random descriptor each, n_kf + 1 keyframes on
    the 1.2 m circle looking outward (the last revisits the first view),
    translation drift growing linearly to `drift`; the last two keyframes
    observe duplicates of their points in the drifted frame.  Returns
    (port MapStore, keyframes, angles)."""
    from .models.mapstore import MapStore
    rng = np.random.default_rng(seed)
    K = K_EUROC
    n_feat = 256
    m = MapStore(max_kf=64, max_pts=4096, max_lines=64, n_feat=n_feat)
    n_pts = 1200
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    pts_w = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                      rng.uniform(-1.5, 1.5, n_pts)], -1)
    packed = pack_bits_np(rng.choice([-1.0, 1.0], (n_pts, 256)))
    pt_ids = m.alloc_points(n_pts)
    m.pt_xyz[pt_ids] = pts_w.astype(np.float32)
    m.pt_desc[pt_ids] = packed
    m.pt_n_obs[pt_ids] = 2
    angles = np.concatenate([np.linspace(0, 2 * np.pi, n_kf,
                                         endpoint=False), [0.0]])
    kfs = []
    for i, a in enumerate(angles):
        R_wc, p_true = _circle_cam(a)
        d = drift * i / len(angles)
        p_est = p_true + np.array([d, -0.5 * d, 0.0])
        R_cw = R_wc.T
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = i * 0.5
        m.kf_pose_cw[kf] = np.concatenate(
            [R_cw, (-R_cw @ p_est)[:, None]], 1).astype(np.float32)
        if i > 0:
            m.kf_prev[kf] = kfs[-1]
            m.kf_next[kfs[-1]] = kf
        sel, uv = _wall_projection(pts_w, R_cw, -R_cw @ p_true, K, n_feat)
        m.kf_feat_uv[kf, :len(sel)] = uv
        m.kf_feat_desc[kf, :len(sel)] = packed[sel]
        m.kf_feat_valid[kf, :len(sel)] = True
        if i >= len(angles) - 2:
            dup = m.alloc_points(len(sel))
            m.pt_xyz[dup] = (pts_w[sel][:len(dup)]
                             + np.array([d, -0.5 * d, 0.0])).astype(
                                 np.float32)
            m.pt_desc[dup] = packed[sel][:len(dup)]
            m.pt_n_obs[dup] = 2
            m.kf_match_pt[kf, :len(dup)] = dup
        else:
            m.kf_match_pt[kf, :len(sel)] = pt_ids[sel]
        kfs.append(kf)
    for kf in kfs:
        m.update_covisibility(kf)
    return m, kfs, angles


def build_gba_chain(seed: int = 0, n_kf: int = 48, n_pts: int = 3000,
                    n_feat: int = 128):
    """tests/test_loop_closing.py:120's chain for the chained global BA:
    n_kf keyframes around the circle observing the wall from their true
    poses, every stored pose perturbed (0.01 rad, 5 cm).  Returns (port
    MapStore, [(R_cw, t_cw)] the truth)."""
    from .models.mapstore import MapStore
    from .utils import lie
    rng = np.random.default_rng(seed)
    m = MapStore(max_kf=64, max_pts=8192, max_lines=8, n_feat=n_feat)
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    pts_w = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                      rng.uniform(-1.5, 1.5, n_pts)], -1)
    pt_ids = m.alloc_points(n_pts)
    m.pt_xyz[pt_ids] = pts_w.astype(np.float32)
    m.pt_n_obs[pt_ids] = 3
    truth, prev = [], None
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n_kf, endpoint=False)):
        R_wc, p = _circle_cam(a)
        R_cw = R_wc.T
        t_cw = -R_cw @ p
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = 0.5 * i
        sel, uv = _wall_projection(pts_w, R_cw, t_cw, K_EUROC, n_feat)
        m.kf_feat_uv[kf, :len(sel)] = uv
        m.kf_feat_uv_raw[kf, :len(sel)] = uv
        m.kf_feat_valid[kf, :len(sel)] = True
        m.kf_match_pt[kf, :len(sel)] = pt_ids[sel]
        dR = lie.so3_exp(torch.tensor(rng.normal(0, 0.01, 3),
                                      dtype=torch.float32)).numpy()
        m.kf_pose_cw[kf, :, :3] = (dR @ R_cw).astype(np.float32)
        m.kf_pose_cw[kf, :, 3] = (t_cw + rng.normal(0, 0.05, 3)).astype(
            np.float32)
        truth.append((R_cw, t_cw))
        if prev is not None:
            m.kf_prev[kf] = prev
            m.kf_next[prev] = kf
        prev = kf
    return m, truth


def build_big_chain(n_kf: int = 600, drift: float = 0.8):
    """tests/test_essential_graph_big.py:33's chain: n_kf + 1 keyframes
    around the circle (the last revisits the first view), translation
    drift growing linearly to `drift`, covisibility 80 to the previous
    keyframe and 45 to the one before.  Returns (port MapStore,
    keyframes, [(R_cw, t_cw)] the truth)."""
    from .models.mapstore import MapStore
    m = MapStore(max_kf=n_kf + 40, max_pts=64, max_lines=8, n_feat=8)
    angles = np.concatenate([np.linspace(0, 2 * np.pi, n_kf,
                                         endpoint=False), [0.0]])
    kfs, gt, prev = [], [], None
    for i, a in enumerate(angles):
        R_wc, p_true = _circle_cam(a)
        R_cw = R_wc.T
        d = drift * i / len(angles)
        p_est = p_true + np.array([d, -0.6 * d, 0.3 * d])
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = 0.5 * i
        m.kf_pose_cw[kf] = np.concatenate(
            [R_cw, (-R_cw @ p_est)[:, None]], 1).astype(np.float32)
        gt.append((R_cw.copy(), -R_cw @ p_true))
        if prev is not None:
            m.kf_prev[kf] = prev
            m.kf_next[prev] = kf
            m.covis[kf, prev] = m.covis[prev, kf] = 80
            if i >= 2:
                m.covis[kf, kfs[-2]] = m.covis[kfs[-2], kf] = 45
        prev = kf
        kfs.append(kf)
    return m, np.asarray(kfs), gt


def build_merge_maps(seed: int = 0, n_pts: int = 1500):
    """tests/test_map_merge.py:63's two maps: the old one, 14 keyframes on
    the full circle in the world frame, and a young one (map id 1), 5
    keyframes of a revisit near angle 0 expressed in a frame related to
    the old one by X_old = 1.3 R_z(0.3) X_cur + (0.5, -0.2, 0.1), the same
    points and descriptors.  Returns (m_old, m_cur, old keyframes, current
    keyframes, the current keyframes' true centres)."""
    from .models.mapstore import MapStore
    rng = np.random.default_rng(seed)
    n_feat = 256
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    pts_w = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                      rng.uniform(-1.5, 1.5, n_pts)], -1).astype(np.float32)
    packed = pack_bits_np(rng.choice([-1.0, 1.0], (n_pts, 256)))

    def add_kf(m, pts, R_cw, t_cw, ts, ids, prev):
        kf = m.alloc_kf()
        m.kf_timestamp[kf] = ts
        m.kf_pose_cw[kf] = np.concatenate([R_cw, t_cw[:, None]], 1)
        sel, uv = _wall_projection(pts, R_cw, t_cw, K_EUROC, n_feat)
        m.kf_feat_uv[kf, :len(sel)] = uv
        m.kf_feat_desc[kf, :len(sel)] = packed[sel]
        m.kf_feat_valid[kf, :len(sel)] = True
        m.kf_match_pt[kf, :len(sel)] = ids[sel]
        if prev is not None:
            m.kf_prev[kf] = prev
            m.kf_next[prev] = kf
        return kf

    def pose(a):
        R_wc, p = _circle_cam(a)
        R_cw = R_wc.T
        return R_cw.astype(np.float32), (-R_cw @ p).astype(np.float32), p

    def new_map(pts, map_id):
        m = MapStore(max_kf=64, max_pts=8192, max_lines=64, n_feat=n_feat,
                     map_id=map_id)
        ids = m.alloc_points(len(pts))
        m.pt_xyz[ids] = pts
        m.pt_desc[ids] = packed
        m.pt_n_obs[ids] = 2
        return m, ids

    m_old, ids_old = new_map(pts_w, 0)
    old_kfs, prev = [], None
    for i, a in enumerate(np.linspace(0, 2 * np.pi, 14, endpoint=False)):
        R_cw, t_cw, _ = pose(a)
        prev = add_kf(m_old, pts_w, R_cw, t_cw, 0.5 * i, ids_old, prev)
        old_kfs.append(prev)
    for kf in old_kfs:
        m_old.update_covisibility(kf)
    s0, th = 1.3, 0.3
    R0 = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1.0]], np.float32)
    t0 = np.array([0.5, -0.2, 0.1], np.float32)
    pts_cur = ((pts_w - t0) @ R0) / s0
    m_cur, ids_cur = new_map(pts_cur.astype(np.float32), 1)
    cur_kfs, centres, prev = [], [], None
    for i, a in enumerate([0.0, 0.12, 0.24, 0.36, 0.48]):
        R_cw_w, t_cw_w, p_true = pose(a)
        R_cw = R_cw_w @ R0
        t_cw = (R_cw_w @ t0 + t_cw_w) / s0
        prev = add_kf(m_cur, pts_cur, R_cw.astype(np.float32),
                      t_cw.astype(np.float32), 100.0 + 0.5 * i, ids_cur,
                      prev)
        cur_kfs.append(prev)
        centres.append(p_true)
    for kf in cur_kfs:
        m_cur.update_covisibility(kf)
    return m_old, m_cur, old_kfs, cur_kfs, centres


MH_LOOP_SECONDS = 28.0


def _mh_loop_world(duration: float, seed: int, n_points: int = 9000,
                   n_lines: int = 500):
    """(rng, hall, circuit at 20 fps, IMU): scripts/run_mh_loop.py's
    world, the generator left where its first frame draws."""
    rng = np.random.default_rng(seed)
    scene = syn.make_hall_scene(rng, n_points=n_points, n_lines=n_lines)
    traj = syn._eval_mh_loop(np.arange(0.0, duration, 1.0 / 20.0))
    imu = syn.synthesize_imu_mh(rng, duration + 0.3,
                                eval_fn=syn._eval_mh_loop)
    return rng, scene, traj, imu


def build_mh_loop(duration: float = MH_LOOP_SECONDS, seed: int = 7,
                  n_points: int = 9000, n_lines: int = 500, n_frames=None,
                  frames=None):
    """The inputs of scripts/run_mh_loop.py (numpy, default_rng(seed) in its
    order): the 9000-point / 500-line hall, the closed circuit
    `_eval_mh_loop` at 20 fps over `duration`, the 200 Hz IMU along it over
    duration + 0.3 s, then every frame rendered in order (the first
    n_frames only where given; ~0.5 s a frame of one CPU core).  `frames`,
    where given, holds the frames already rendered (an [n,480,752] array,
    e.g. `render_mh_loop`'s by another process) and nothing is rendered.
    Returns the dict of `build_mh_replay`."""
    rng, scene, traj, imu = _mh_loop_world(duration, seed, n_points,
                                           n_lines)
    t_frames = traj.timestamps
    n = len(t_frames) if n_frames is None else min(n_frames, len(t_frames))
    rendered, frames = frames, []
    batches, last_t = [], None
    for i in range(n):
        t = traj.timestamps[i]
        frames.append(rendered[i] if rendered is not None else
                      syn.render_frame_realistic(scene, syn._eval_mh_loop,
                                                 t, rng))
        if last_t is None:
            batches.append(None)
        else:
            sel = (imu.timestamps > last_t) & (imu.timestamps <= t)
            ts = imu.timestamps[sel]
            batches.append((imu.gyro[sel], imu.acc[sel],
                            np.diff(np.concatenate([[last_t], ts]))))
        last_t = t
    return dict(frames=frames, timestamps=traj.timestamps[:n], imu=batches,
                R_wc=traj.R_wb[:n], p_wc=traj.p_wb[:n], scene=scene,
                traj=traj, imu_data=imu)


def render_mh_loop(out: np.ndarray, duration: float = MH_LOOP_SECONDS,
                   seed: int = 7) -> None:
    """`build_mh_loop`'s frames, rendered in order into out [n,480,752]
    float32 (a shared buffer: another process renders while the caller
    does other work)."""
    rng, scene, traj, _ = _mh_loop_world(duration, seed)
    for i in range(len(out)):
        out[i] = syn.render_frame_realistic(scene, syn._eval_mh_loop,
                                            traj.timestamps[i], rng)


# the prior keyframe set of the prior-map relocalizer: the reference's
# prior camera (models/relocalization.py: 640x480, K hardcoded in the
# reference's Relocalization.cpp:8), the MH replay's hall seen from the
# truth poses of these replay frames, expressed in a "prior world" that is
# the replay's world turned 30 deg about its vertical and moved
PRIOR_K = (518.0, 519.0, 325.5, 253.5)
PRIOR_SIZE = (480, 640)
PRIOR_FRAMES = (36, 44, 52, 60, 68, 76)
PRIOR_YAW = np.pi / 6
PRIOR_SHIFT = (2.5, -1.5, 0.4)
PRIOR_DEPTH_SCALE = 5000.0      # metres x 5000 in the 16-bit depth images


def prior_from_replay() -> np.ndarray:
    """[3,4] transform taking replay-world points into the prior world."""
    c, s = np.cos(PRIOR_YAW), np.sin(PRIOR_YAW)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return np.concatenate([R, np.asarray(PRIOR_SHIFT)[:, None]], 1)


def _write_png_gray(path, img: np.ndarray) -> None:
    import cv2
    if not cv2.imwrite(str(path), img):
        raise OSError(f"cannot write {path}")


def _write_pgm16(path, img: np.ndarray) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n65535\n".encode())
        f.write(np.ascontiguousarray(img, ">u2").tobytes())


def build_prior_set(out_dir, seed: int = 0, frames=PRIOR_FRAMES,
                    tum: bool = False, seconds: float = MH_SECONDS,
                    replay_seed: int = MH_SEED, n_points: int = 9000,
                    n_lines: int = 500) -> dict:
    """Write a prior keyframe set in the reference's on-disk format into
    out_dir: color/<i+1>.png (8-bit grey), depth/<i+1>.pgm (16-bit, metres
    x 5000, 0 where no scene point splats or beyond 13.1 m) and pose.txt,
    row i the camera-to-prior-world pose of image i+1 as `x y z qx qy qz
    qw` (with `tum`, a timestamp first: the TUM form).  Frame i is the MH
    replay's hall (`build_mh_replay`'s scene of n_points / n_lines) rendered by
    `io.synthetic.render_frame` at the prior camera (PRIOR_K, 640x480, no
    distortion, noise from default_rng(seed)) from the truth pose of replay
    frame frames[i], its depth `io.synthetic.oracle_depth` at that camera.

    Returns dict(T_pw [3,4] (`prior_from_replay`), frames, T_wc [n,3,4] in
    the prior world, timestamps [n] of the replay frames)."""
    import os
    _, scene, traj, _ = _stereo_world(seconds, replay_seed, n_points,
                                      n_lines)
    fx, fy, cx, cy = PRIOR_K
    H, W = PRIOR_SIZE
    T_pw = prior_from_replay()
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "color"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rows, poses = [], []
    for i, k in enumerate(frames):
        R_wc, p_wc = traj.R_wb[k], traj.p_wb[k]
        img = syn.render_frame(scene, R_wc, p_wc, fx, fy, cx, cy, W, H,
                               rng=rng)
        depth = syn.oracle_depth(scene, R_wc, p_wc, fx, fy, cx, cy, W, H)
        d16 = np.where((depth > 0) & (depth * PRIOR_DEPTH_SCALE <= 65535),
                       np.round(depth * PRIOR_DEPTH_SCALE), 0).astype(
                           np.uint16)
        _write_png_gray(os.path.join(out_dir, "color", f"{i + 1}.png"),
                        np.round(img).astype(np.uint8))
        _write_pgm16(os.path.join(out_dir, "depth", f"{i + 1}.pgm"), d16)
        R_p = T_pw[:, :3] @ R_wc
        p_p = T_pw[:, :3] @ p_wc + T_pw[:, 3]
        q = lie.rot_to_quat(torch.from_numpy(R_p)).numpy()
        rows.append(([traj.timestamps[k]] if tum else [])
                    + list(p_p) + list(q))
        poses.append(np.concatenate([R_p, p_p[:, None]], 1))
    np.savetxt(os.path.join(out_dir, "pose.txt"), np.asarray(rows),
               fmt="%.9f")
    return dict(T_pw=T_pw, frames=tuple(frames), T_wc=np.stack(poses),
                timestamps=traj.timestamps[list(frames)])


def prior_live_offset():
    """(R_lp [3,3], t_lp [3]) float32: the live world of
    `place_prior_keyframes` in the prior world, 0.4 rad about a unit axis
    and moved (tests/test_prior_reloc.py:83-90)."""
    axis = np.array([0.36, -0.48, 0.8])
    q = torch.tensor(np.concatenate([np.sin(0.2) * axis, [np.cos(0.2)]]),
                     dtype=torch.float32)
    return (lie.quat_to_rot(q).numpy(),
            np.array([0.3, -0.2, 0.5], np.float32))


def place_prior_keyframes(m, prior_frames) -> list:
    """A hand-made live map for the prior-map relocalizer: one keyframe a
    prior frame in the map store m (its features: uv, valid, packed
    descriptors; its pose: the prior frame's moved into the live world of
    `prior_live_offset`; timestamp i), the map marked mature (imu_ba2).
    Returns the keyframes."""
    R_lp, t_lp = prior_live_offset()
    m.imu_ba2 = True
    kfs = []
    for i, p in enumerate(prior_frames):
        kf = m.alloc_kf()
        m.kf_feat_uv[kf] = p.uv
        m.kf_feat_valid[kf] = p.valid
        m.kf_feat_desc[kf] = p.desc_packed
        R_lc = R_lp @ p.T_wc[:, :3]
        t_lc = R_lp @ p.T_wc[:, 3] + t_lp
        m.kf_pose_cw[kf, :, :3] = R_lc.T
        m.kf_pose_cw[kf, :, 3] = -R_lc.T @ t_lc
        m.kf_timestamp[kf] = float(i)
        kfs.append(kf)
    return kfs


# --------------------------------------------------------------------------
# The sharded solvers' problems (parallel/): the builders of the
# reference's tests, kept in the port
# --------------------------------------------------------------------------

K_CHAIN_VI = K_EUROC


def _so3(w) -> np.ndarray:
    return lie.so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def build_chain_vi_problem(rng: np.random.Generator, n_kf: int = 24,
                           n_pts: int = 400, n_lns: int = 24):
    """The ground-truth orbit chain of tests/test_chain_liba.py:41
    `_build_problem`: n_kf keyframes at 8 Hz on the radius-1.2 m orbit
    (Tbc = identity, zero biases), the IMU with EuRoC noise
    (`synthesize_imu`) preintegrated between them by the port's
    `ops/imu.preintegrate`, points and line segments in the shell the
    orbit looks out at, observed noise-free through K_EUROC.  Returns
    (pose_gt [n,3,4] T_wb, vel_gt, X [n_pts,3], ln_ep [n_lns,6], obs_kf,
    obs_pt, obs_uv, lobs_kf, lobs_ln, lobs_eq, pre_stack, infos, ev, rwg,
    rwa) in numpy."""
    K = K_CHAIN_VI
    dur, fps = n_kf / 8.0, 8.0
    traj = syn.make_orbit_trajectory(duration=dur + 0.3, fps=fps,
                                     radius=1.2)
    imu = synthesize_imu(rng, dur + 0.3, noise_gyro=1.7e-4,
                         noise_acc=2.0e-3, bias_gyro_mag=0, bias_acc_mag=0)
    kf_ids = np.arange(n_kf)
    calib = IMU.make_calib(ImuConfig())
    z3 = torch.zeros(3)
    pose_gt = np.concatenate(
        [traj.R_wb[kf_ids], traj.p_wb[kf_ids][..., None]], -1
    ).astype(np.float32)
    vel_gt = traj.v_wb[kf_ids].astype(np.float32)
    cols = {key: [] for key in PRE_KEYS}
    infos, ev, rwg, rwa = [], [], [], []
    for a, b in zip(kf_ids[:-1], kf_ids[1:]):
        t0, t1 = traj.timestamps[a], traj.timestamps[b]
        m = (imu.timestamps > t0) & (imu.timestamps <= t1)
        ts = imu.timestamps[m]
        dts = np.diff(np.concatenate([[t0], ts]))
        p = IMU.preintegrate(
            torch.as_tensor(imu.gyro[m], dtype=torch.float32),
            torch.as_tensor(imu.acc[m], dtype=torch.float32),
            torch.as_tensor(dts, dtype=torch.float32),
            torch.ones(len(ts), dtype=torch.bool), calib, z3, z3)
        vals = {"dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP,
                "JRg": p.JRg, "JVg": p.JVg, "JVa": p.JVa, "JPg": p.JPg,
                "JPa": p.JPa, "bg0": p.bias_gyro, "ba0": p.bias_acc}
        for key in PRE_KEYS:
            cols[key].append(np.asarray(vals[key].numpy(), np.float32))
        C = p.C.numpy().astype(np.float64)
        infos.append(np.linalg.inv(C[:9, :9] + np.eye(9) * 1e-8))
        ev.append(True)
        rwg.append(1.0 / max(C[9:12, 9:12].trace() / 3, 1e-12))
        rwa.append(1.0 / max(C[12:15, 12:15].trace() / 3, 1e-12))
    pre_stack = {k: np.stack(v) for k, v in cols.items()}

    X = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(0.5, 2.0, n_pts)
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(n_kf):
        R_wb, p_wb = pose_gt[k, :, :3], pose_gt[k, :, 3]
        pc = (X - p_wb) @ R_wb
        uv = np.stack([K.fx * pc[:, 0] / np.maximum(pc[:, 2], 1e-6) + K.cx,
                       K.fy * pc[:, 1] / np.maximum(pc[:, 2], 1e-6) + K.cy],
                      -1)
        vis = (pc[:, 2] > 0.2) & (np.abs(uv[:, 0] - K.cx) < 360) \
            & (np.abs(uv[:, 1] - K.cy) < 240)
        ids = np.nonzero(vis)[0]
        obs_kf.append(np.full(len(ids), k, np.int32))
        obs_pt.append(ids.astype(np.int32))
        obs_uv.append(uv[ids].astype(np.float32))
    obs_kf = np.concatenate(obs_kf)
    obs_pt = np.concatenate(obs_pt)
    obs_uv = np.concatenate(obs_uv)

    Ls = rng.uniform(-3, 3, (n_lns, 3)).astype(np.float32)
    Ls[:, 2] = rng.uniform(0.5, 2.0, n_lns)
    Le = Ls + rng.normal(0, 0.25, (n_lns, 3)).astype(np.float32)
    ln_ep = np.concatenate([Ls, Le], -1)
    lobs_kf, lobs_ln, lobs_eq = [], [], []
    for k in range(n_kf):
        R_wb, p_wb = pose_gt[k, :, :3], pose_gt[k, :, 3]
        for li in range(n_lns):
            pcs = R_wb.T @ (Ls[li] - p_wb)
            pce = R_wb.T @ (Le[li] - p_wb)
            if pcs[2] < 0.2 or pce[2] < 0.2:
                continue
            us = np.array([K.fx * pcs[0] / pcs[2] + K.cx,
                           K.fy * pcs[1] / pcs[2] + K.cy])
            ue = np.array([K.fx * pce[0] / pce[2] + K.cx,
                           K.fy * pce[1] / pce[2] + K.cy])
            if not (abs(us[0] - K.cx) < 360 and abs(us[1] - K.cy) < 240
                    and abs(ue[0] - K.cx) < 360
                    and abs(ue[1] - K.cy) < 240):
                continue
            l = np.cross(np.append(us, 1.0), np.append(ue, 1.0))
            l /= max(np.linalg.norm(l[:2]), 1e-9)
            lobs_kf.append(k)
            lobs_ln.append(li)
            lobs_eq.append(l.astype(np.float32))
    return (pose_gt, vel_gt, X, ln_ep, obs_kf, obs_pt, obs_uv,
            np.asarray(lobs_kf, np.int32), np.asarray(lobs_ln, np.int32),
            np.asarray(lobs_eq, np.float32).reshape(-1, 3), pre_stack,
            np.stack(infos).astype(np.float32), np.asarray(ev),
            np.asarray(rwg, np.float32), np.asarray(rwa, np.float32))


def perturb_chain_vi(rng: np.random.Generator, pose_gt, vel_gt, X, ln_ep,
                     n_kf: int):
    """tests/test_dist_liba.py:21 `_perturb`: points and line endpoints
    moved by 2 cm, keyframes 1.. rotated by ~0.01 rad and moved by 3 cm,
    velocities by 5 cm/s.  Returns (pose0, vel0, X0, ln0)."""
    pose0 = pose_gt.copy()
    vel0 = vel_gt.copy()
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    ln0 = ln_ep + rng.normal(0, 0.02, ln_ep.shape).astype(np.float32)
    for i in range(1, n_kf):
        w = rng.normal(0, 0.01, 3)
        pose0[i, :, :3] = pose0[i, :, :3] @ _so3(w)
        pose0[i, :, 3] += rng.normal(0, 0.03, 3)
        vel0[i] += rng.normal(0, 0.05, 3)
    return pose0, vel0, X0, ln0


def build_dist_window(seed: int = 0, n_kf: int = 16, n_pts: int = 300,
                      n_lns: int = 16) -> dict:
    """A perturbed inertial window for the sharded solvers: the chain of
    `build_chain_vi_problem` (default_rng(seed)) perturbed by
    `perturb_chain_vi`, the first keyframe fixed.  Returns a dict of the
    `DistLIBARunner.solve` arguments (numpy) and the truth (`pose_gt`,
    `vel_gt`, `X`, `ln_ep`)."""
    rng = np.random.default_rng(seed)
    (pose_gt, vel_gt, X, ln_ep, obs_kf, obs_pt, obs_uv, lobs_kf, lobs_ln,
     lobs_eq, pre_stack, infos, ev, rwg, rwa) = build_chain_vi_problem(
        rng, n_kf=n_kf, n_pts=n_pts, n_lns=n_lns)
    pose0, vel0, X0, ln0 = perturb_chain_vi(rng, pose_gt, vel_gt, X, ln_ep,
                                            n_kf)
    bgba = np.zeros((n_kf, 3), np.float32)
    kf_free = np.ones(n_kf, bool)
    kf_free[0] = False
    return dict(pose_wb=pose0, vel=vel0, bg=bgba, ba=bgba.copy(),
                kf_free=kf_free, kf_free_bias=kf_free.copy(), obs_kf=obs_kf,
                obs_pt=obs_pt, obs_uv=obs_uv,
                obs_is2=np.ones(len(obs_kf), np.float32), pt_xyz=X0,
                pre_stack=pre_stack, imu_info=infos, edge_valid=ev,
                rw_g=rwg, rw_a=rwa, lobs_kf=lobs_kf, lobs_ln=lobs_ln,
                lobs_eq=lobs_eq, ln_ep=ln0, pose_gt=pose_gt, vel_gt=vel_gt,
                X=X, ln_gt=ln_ep)


K_DIST_BA = K_EUROC


def build_dist_ba_scene(rng: np.random.Generator, n_cams: int = 4,
                        n_pts: int = 96):
    """tests/test_dist_ba.py:17 `_problem`: n_cams cameras 0.4 m apart
    looking at n_pts points 6 m ahead (0.3 px noise), every point seen by
    every camera; the start moves cameras 1.. by ~0.008 rad and 3 cm and
    the points by 4 cm.  Returns (poses_gt [n,3,4] T_cw, X_gt, poses0, X0,
    obs_kf, obs_pt, obs_uv)."""
    K = K_DIST_BA
    X_gt = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    X_gt[:, 2] += 6.0
    poses_gt = []
    for c in range(n_cams):
        w = rng.normal(0, 0.02, 3)
        t = np.array([0.4 * c, 0.0, 0.0]) + rng.normal(0, 0.02, 3)
        poses_gt.append(np.concatenate([_so3(w), t[:, None]],
                                       1).astype(np.float32))
    poses_gt = np.stack(poses_gt)
    obs_kf, obs_pt, obs_uv = [], [], []
    for c in range(n_cams):
        pc = (poses_gt[c, :, :3] @ X_gt.T).T + poses_gt[c, :, 3]
        uv = np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                       K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1)
        uv += rng.normal(0, 0.3, uv.shape)
        obs_kf.append(np.full(n_pts, c, np.int32))
        obs_pt.append(np.arange(n_pts, dtype=np.int32))
        obs_uv.append(uv.astype(np.float32))
    obs_kf = np.concatenate(obs_kf)
    obs_pt = np.concatenate(obs_pt)
    obs_uv = np.concatenate(obs_uv)
    poses0 = poses_gt.copy()
    for c in range(1, n_cams):
        w = rng.normal(0, 0.008, 3)
        poses0[c, :, :3] = _so3(w) @ poses0[c, :, :3]
        poses0[c, :, 3] += rng.normal(0, 0.03, 3)
    X0 = X_gt + rng.normal(0, 0.04, X_gt.shape).astype(np.float32)
    return (poses_gt, X_gt, poses0.astype(np.float32), X0.astype(np.float32),
            obs_kf, obs_pt, obs_uv)


# tests/test_chain_ba.py's and scripts/multihost_worker.py's cameras
K_CHAIN = PinholeK(fx=200.0, fy=200.0, cx=128.0, cy=96.0)
K_MULTIHOST = PinholeK(fx=100.0, fy=100.0, cx=64.0, cy=48.0)


def build_chain_ba_problem(rng: np.random.Generator, C: int = 16,
                           pts_per_kf: int = 30, obs_window: int = 2):
    """tests/test_chain_ba.py:20 `_chain_problem`: a camera sweeping
    along x (0.4 m a keyframe), pts_per_kf points ahead of each keyframe
    seen by its +-obs_window chain neighbours through K_CHAIN (0.3 px
    noise).  Returns (poses_gt [C,3,4] T_cw, pts, obs_kf, obs_pt,
    obs_uv)."""
    K = K_CHAIN
    poses_gt, pts, obs_kf, obs_pt, obs_uv = [], [], [], [], []
    for c in range(C):
        R = _so3(rng.normal(0, 0.02, 3))
        t = np.array([0.4 * c, 0, 0], np.float32) \
            + rng.normal(0, 0.05, 3).astype(np.float32)
        poses_gt.append(np.concatenate([R, t[:, None]], 1).astype(np.float32))
    poses_gt = np.stack(poses_gt)
    for c in range(C):
        C1 = -poses_gt[c, :, :3].T @ poses_gt[c, :, 3]
        for _ in range(pts_per_kf):
            X = C1 + np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                               rng.uniform(2.0, 5.0)])
            pid = len(pts)
            pts.append(X)
            for c2 in range(max(0, c - obs_window),
                            min(C, c + obs_window + 1)):
                pc = poses_gt[c2, :, :3] @ X + poses_gt[c2, :, 3]
                if pc[2] < 0.2:
                    continue
                uv = np.array([K.fx * pc[0] / pc[2] + K.cx,
                               K.fy * pc[1] / pc[2] + K.cy])
                if not (0 <= uv[0] < 256 and 0 <= uv[1] < 192):
                    continue
                obs_kf.append(c2)
                obs_pt.append(pid)
                obs_uv.append(uv + rng.normal(0, 0.3, 2))
    return (poses_gt, np.asarray(pts, np.float32),
            np.asarray(obs_kf, np.int64), np.asarray(obs_pt, np.int64),
            np.asarray(obs_uv, np.float32))


def build_multihost_chain(n_shards: int):
    """scripts/multihost_worker.py's chain: C = 2 n_shards keyframes 0.3 m
    apart (identity rotations), 6 points per keyframe seen noise-free by
    its two neighbours through K_MULTIHOST.  Returns (chain_poses, pts,
    obs_kf, obs_pt, obs_uv)."""
    K = K_MULTIHOST
    rng = np.random.default_rng(0)
    C = 2 * n_shards
    chain_poses, pts, okf, opt, ouv = [], [], [], [], []
    for c in range(C):
        chain_poses.append(np.concatenate(
            [np.eye(3, dtype=np.float32),
             np.array([[0.3 * c], [0.0], [0.0]], np.float32)], 1))
    chain_poses = np.stack(chain_poses)
    for c in range(C):
        for k in range(6):
            X = np.array([0.3 * c + rng.uniform(-1, 1),
                          rng.uniform(-1, 1), rng.uniform(2, 4)],
                         np.float32)
            pid_ = len(pts)
            pts.append(X)
            for c2 in range(max(0, c - 1), min(C, c + 2)):
                pc = chain_poses[c2, :, :3] @ X + chain_poses[c2, :, 3]
                okf.append(c2)
                opt.append(pid_)
                ouv.append([K.fx * pc[0] / pc[2] + K.cx,
                            K.fy * pc[1] / pc[2] + K.cy])
    return (chain_poses, np.asarray(pts, np.float32), np.asarray(okf),
            np.asarray(opt), np.asarray(ouv, np.float32))
