"""Slice 12, path B: the KB8 fisheye camera (monocular, no lines) against
the JAX package on the CPU.

Run as a script, it prints REF_KB8 for chip_smoke.py: the JAX `System`
over tests/test_kb8_native.py:116-169's fisheye room (30 frames, the
system's defaults: loop closing on) with `cfg.seed` 0..4, one process
each, two at a time, its ATE before and after `global_refine`:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_kb8.py

As tests (torch on one thread), each against the JAX package on the same
inputs:

(a) `kb8_project`, `kb8_unproject`, `kb8_undistort_pixels` and
    `kb8_distort_norm` on tests/test_cameras.py:68-80's inputs and on a
    grid over the fisheye room's image: within 1e-4 px / 1e-5 on the
    rays (the same float32 operations; atan2 and tan of XLA's CPU
    library and of torch's may differ by an ulp), the undistorted grid
    within 1e-4 px + 4e-6 of the pixel's distance from the principal
    point (at the image's corners theta nears 70 deg, where tan turns an
    ulp of theta into ~1.5e-6 of the distance, ~1000 px);
(b) the analytic KB8 projection Jacobian (`kb8_proj_jac`,
    `point_reproj_kb8_jac`, the formulas of the kernels) against
    `torch.func.jacrev` of the residual in float64, r -> 0 included:
    within 1e-9 relative;
(c) the KB8 projection matcher on tests/test_kb8_native.py:76-113's
    inputs and on `inputs.build_projection_case(kb8=True)` (fuse and
    tracker modes): matched, pt_feat where matched and feat_pt equal, but
    for rows whose projection lies within 1% of a gate (the image border
    within 1% of its extent, the window within 1% of its radius, the range
    within 1% of its bound);
(d) the KB8 pose LM on tests/test_kb8_native.py:38-73's inputs and with
    20% of its rows made outliers: the port's plain float32 run within 2x
    JAX's distance to a float64 run of the port + 1e-6 a pose entry,
    inliers equal but for rows whose chi2 at the float64 pose lies within
    1% of 5.991;
(e) `make_local_ba` with the KB8K camera at 16 KF
    (`inputs.build_kb8_window`): KF poses within 2x JAX's distance to a
    float64 run of the port + 1e-4 a pose entry (the keyframe step's
    rule), inlier
    masks equal;
(f) `System` with the KB8 camera through the public `track_monocular`,
    at the reduced sizes of tests/test_torch_system.py, loop closing off,
    against the JAX `System` fed the port's features: the port starts from
    the JAX run's state after the bootstrap (whose RANSAC draws differ) and
    both run to the end of the first keyframe step after it: states,
    inliers, keyframes made and map counts equal, poses within 1e-4;
(g) `slow`: the whole fisheye room (`entry.kb8_room`, 30 frames,
    production's sizes, loop closing on) on the CPU with the JAX
    package's RANSAC draws for cfg.seed 0 (`test_torch_bootstrap.
    JaxKeyChain`): the JAX run's (REF_KB8, cfg.seed 0) bootstrap frame,
    frames tracked, keyframes and points equal, its ATE within 1e-3 m;
    with the port's own draws only the reference test's ATE bound holds
    it (the frames before the bootstrap follow the draws).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.config import CameraConfig, SystemConfig
from plvio_tpu.io import synthetic as JSYN
from plvio_tpu.io import trajectory as JTIO
from plvio_tpu.models.system import System as JSystem
from plvio_tpu.utils import lie as JLIE

KB8_K = (0.01, -0.005, 0.002, 0.0)
KB8_FRAMES = 30


def kb8_config(seed: int = 0, **kw) -> SystemConfig:
    """tests/test_kb8_native.py:131-133's configuration."""
    return SystemConfig(camera=CameraConfig(
        model="kb8", fx=380.0, fy=380.0, cx=376.0, cy=240.0, dist=KB8_K),
        use_lines=False, seed=seed, **kw)


def jax_kb8_inputs(n_frames: int = KB8_FRAMES, seed: int = 0) -> dict:
    """The fisheye room with the JAX package's generators, drawn in the
    test's order."""
    rng = np.random.default_rng(seed)
    scene = JSYN.make_room_scene(rng, n_points=4000, n_lines=10)
    traj = JSYN.make_orbit_trajectory(duration=KB8_FRAMES / 20.0, fps=20.0,
                                      radius=0.6)
    frames = [JSYN.render_frame_kb8(scene, traj.R_wb[i], traj.p_wb[i],
                                    k=KB8_K, rng=rng)
              for i in range(n_frames)]
    return dict(frames=frames, timestamps=traj.timestamps[:n_frames],
                R_wc=traj.R_wb[:n_frames], p_wc=traj.p_wb[:n_frames])


def _ate(js, S):
    q = np.asarray(JLIE.rot_to_quat(jnp.asarray(S["R_wc"], jnp.float32)))
    gt = JTIO.Trajectory(np.asarray(S["timestamps"]), np.asarray(S["p_wc"]),
                         q)
    est = js.trajectory()
    return JTIO.ate_rmse(est, gt, True), JTIO.ate_rmse(est, gt, False)


def reference_kb8(seed: int = 0) -> dict:
    """The JAX `System` over the fisheye room with `cfg.seed` = seed."""
    S = jax_kb8_inputs()
    js = JSystem(kb8_config(seed))
    n_ok = 0
    for i in range(KB8_FRAMES):
        n_ok += js.track_monocular(S["frames"][i],
                                   float(S["timestamps"][i])) is not None
    m = js.atlas.current
    out = {"n_frames": KB8_FRAMES, "n_tracked": int(n_ok),
           "maps": len(js.atlas.maps), "keyframes": int(m.n_kf),
           "points": int(m.n_pt), "final_state": int(js.tracker.state)}
    out["ate_sim3_run"], out["ate_se3_run"] = _ate(js, S)
    # as the port's `entry.SystemRun` reports it: after `global_refine`
    # (the loop closer's global BA through the lens)
    js.global_refine()
    out["ate_sim3"], out["ate_se3"] = _ate(js, S)
    return out


def reference_five_seeds() -> dict:
    """REF_KB8: each seed's run, the ranges of the counts and the worst
    Sim3 / SE3 ATE."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    runs = []
    for pair in ((0, 1), (2, 3), (4,)):
        procs = [subprocess.Popen([sys.executable, __file__, "--seed",
                                   str(k)], stdout=subprocess.PIPE, env=env,
                                  text=True) for k in pair]
        for p in procs:
            out, _ = p.communicate()
            line = [x for x in out.splitlines() if x.startswith("KB8_SEED = ")]
            runs.append(json.loads(line[-1][len("KB8_SEED = "):]))
    ref = {"per_seed": runs}
    for k in ("n_tracked", "keyframes", "points", "maps"):
        ref[k + "_range"] = [min(r[k] for r in runs),
                             max(r[k] for r in runs)]
    for k in ("ate_sim3", "ate_se3", "ate_sim3_run", "ate_se3_run"):
        ref[k + "_worst"] = max(r[k] for r in runs)
    return ref


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

from plvio_tpu.models import kernels as JKN  # noqa: E402
from plvio_tpu.ops import cameras as JC  # noqa: E402
from plvio_tpu.solver import residuals as JRES  # noqa: E402
from plvio_tpu_torch.config import CameraConfig as PCam  # noqa: E402
from plvio_tpu_torch.models import kernels as KN  # noqa: E402
from plvio_tpu_torch.ops import cameras as PC  # noqa: E402
from plvio_tpu_torch.solver import residuals as RES  # noqa: E402

TUMVI = dict(fx=190.97, fy=190.9, cx=254.93, cy=256.9,
             k1=0.0034823894022493434, k2=0.0007150348452162257,
             k3=-0.0020532361418706202, k4=0.00020293673591811182)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cams(cfg_kw):
    from plvio_tpu.config import CameraConfig as JCam
    return JC.make_camera(JCam(**cfg_kw)), PC.make_camera(PCam(**cfg_kw))


def test_kb8_camera_matches_reference():
    """(a) on tests/test_cameras.py:68-80's points and camera, and on a
    grid of raw pixels over the fisheye room's image."""
    rng = np.random.default_rng(0)
    kw = dict(model="kb8", fx=190.9, fy=190.9, cx=254.9, cy=256.8,
              width=512, height=512,
              dist=(0.00348, 0.000715, -0.0020532, 0.000202))
    jc, pc = _cams(kw)
    p = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.8
    uj = np.asarray(JC.kb8_project(jc, jnp.asarray(p)))
    up = PC.kb8_project(pc, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(up, uj, atol=1e-4, rtol=0)
    rj = np.asarray(JC.kb8_unproject(jc, jnp.asarray(uj)))
    rp = PC.kb8_unproject(pc, torch.from_numpy(uj.copy())).numpy()
    np.testing.assert_allclose(rp, rj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(rp, p / p[:, 2:3], atol=1e-3, rtol=1e-3)
    xn = (p / p[:, 2:3])[:, :2]
    np.testing.assert_allclose(
        PC.kb8_distort_norm(pc, torch.from_numpy(xn)).numpy(),
        np.asarray(JC.kb8_distort_norm(jc, jnp.asarray(xn))), atol=1e-6)
    room = dict(model="kb8", fx=380.0, fy=380.0, cx=376.0, cy=240.0,
                dist=KB8_K)
    jc, pc = _cams(room)
    u, v = np.meshgrid(np.linspace(0, 751, 25), np.linspace(0, 479, 17))
    g = np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)
    for cam_j, cam_p in ((jc, pc),):
        dj = np.asarray(JC.undistort_pixels(cam_j, jnp.asarray(g)))
        dp = PC.undistort_pixels(cam_p, torch.from_numpy(g)).numpy()
        dist = np.linalg.norm(dj - [cam_p.cx, cam_p.cy], axis=1)
        assert (np.abs(dp - dj).max(1) <= 1e-4 + 4e-6 * dist).all()
        # the frame form (the kernel's plain version) is the same function
        fp, e, q = PC.undistort_frame_plain(cam_p, torch.from_numpy(g), None)
        assert e is None and q is None and np.array_equal(fp.numpy(), dp)


def test_kb8_jacobian_matches_autodiff():
    """(b) in float64, a point on the optical axis (r floored) included."""
    from torch.func import jacrev, vmap
    K8 = RES.KB8K(**TUMVI)
    rng = np.random.default_rng(3)
    pc = rng.uniform([-3, -3, 0.3], [3, 3, 5], (200, 3))
    pc[0, :2] = 0.0
    pc = torch.from_numpy(pc)
    uv, J = RES.kb8_proj_jac(K8, pc)
    Ja = vmap(jacrev(lambda q: RES.kb8_project_single(K8, q)))(pc)
    assert torch.equal(uv, RES.kb8_project_single(K8, pc))
    assert float((J - Ja).abs().max()) <= 1e-9 * float(Ja.abs().max())
    # the BA edge at delta = 0 against jacrev of make_point_reproj_kb8
    from plvio_tpu_torch.utils import lie
    P = torch.cat([lie.so3_exp(torch.tensor(rng.normal(0, 0.2, (200, 3)))),
                   torch.from_numpy(rng.normal(0, 0.3, (200, 3, 1)))], -1)
    X = torch.from_numpy(rng.uniform([-2, -2, 2], [2, 2, 6], (200, 3)))
    obs = torch.from_numpy(rng.uniform(0, 500, (200, 2)))
    r, Jp, Jx = RES.point_reproj_kb8_jac(K8, P, X, obs)
    res = RES.make_point_reproj_kb8(K8)

    def f(d, P1, X1, u1):
        return res((P1, X1), (d[:6], d[6:]), {"uv": u1})
    Ja = vmap(jacrev(f))(torch.zeros(200, 9, dtype=torch.float64), P, X, obs)
    assert float((torch.cat([Jp, Jx], -1) - Ja).abs().max()) \
        <= 1e-9 * float(Ja.abs().max())
    ra = vmap(f)(torch.zeros(200, 9, dtype=torch.float64), P, X, obs)
    assert float((r - ra).abs().max()) <= 1e-9


def _near_gate(K, pose, X, valid, feat_uv, feat_oct, radius, mn=None,
               mx=None):
    """Rows whose projection (float64, the reference's formula) lies within
    1% of a gate: the image border (1% of its extent), a valid feature's
    window (1% of its radius), the distance range (1% of its bound)."""
    R, t = pose[:, :3].astype(np.float64), pose[:, 3].astype(np.float64)
    pc = X.astype(np.float64) @ R.T + t
    from plvio_tpu_torch.io.synthetic import _kb8_project_cam_np
    uv = _kb8_project_cam_np(np.c_[pc[:, :2], np.maximum(pc[:, 2], 1e-6)],
                             K.fx, K.fy, K.cx, K.cy,
                             (K.k1, K.k2, K.k3, K.k4))
    w, h = 2 * K.cx, 2 * K.cy
    near = (np.minimum(np.abs(uv[:, 0]), np.abs(uv[:, 0] - w)) < 0.01 * w) \
        | (np.minimum(np.abs(uv[:, 1]), np.abs(uv[:, 1] - h)) < 0.01 * h) \
        | (np.abs(pc[:, 2] - 0.05) < 5e-4)
    r = radius * np.float32(1.2) ** feat_oct.astype(np.float64)
    d = np.sqrt(((uv[:, None] - feat_uv[None].astype(np.float64)) ** 2)
                .sum(-1))
    near |= (np.abs(d - r[None]) < 0.01 * r[None]).any(1)
    if mn is not None:
        C = -R.T @ t
        dc = np.linalg.norm(X - C, axis=1)
        near |= (np.abs(dc - 0.8 * mn) < 0.008 * mn) \
            | (np.abs(dc - 1.2 * mx) < 0.012 * mx)
    return near & valid


def _compare_matches(oj, op, near):
    """matched, pt_feat where matched and feat_pt equal but for rows near
    a gate (and the features those rows point at)."""
    mj, mp = np.asarray(oj[2]), op[2].numpy()
    ij, ip = np.asarray(oj[1]), op[1].numpy()
    bad = (mj != mp) | (mj & (ij != ip))
    assert not (bad & ~near).any(), np.nonzero(bad & ~near)[0]
    fj, fp = np.asarray(oj[3]), op[3].numpy()
    ok_cols = np.ones(len(fj), bool)
    for rows in (np.nonzero(near)[0],):
        ok_cols[ij[rows]] = False
        ok_cols[ip[rows]] = False
    assert (fj[ok_cols] == fp[ok_cols]).all()
    return int(bad.sum())


def test_kb8_matcher_matches_reference():
    """(c) on tests/test_kb8_native.py's scene and on the projection case
    in both modes."""
    rng = np.random.default_rng(1)
    K8j, K8p = JRES.KB8K(**TUMVI), RES.KB8K(**TUMVI)
    theta = rng.uniform(0, 1.2, 150)
    phi = rng.uniform(0, 2 * np.pi, 150)
    d = rng.uniform(1.5, 5.0, 150)
    X = (np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                   np.cos(theta)], -1) * d[:, None]).astype(np.float32)
    n = len(X)
    pose = np.eye(3, 4, dtype=np.float32)
    uv_raw = np.asarray(jnp.stack([JRES.kb8_project_single(
        K8j, jnp.asarray(p)) for p in X]))
    inb = (uv_raw[:, 0] > 5) & (uv_raw[:, 0] < 505) \
        & (uv_raw[:, 1] > 5) & (uv_raw[:, 1] < 505)
    cap = n_feat = 256
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    pt_xyz = np.zeros((cap, 3), np.float32)
    pt_desc = np.zeros((cap, 8), np.uint32)
    pt_valid = np.zeros(cap, bool)
    pt_xyz[:n], pt_desc[:n], pt_valid[:n] = X, desc, True
    feat_uv = np.zeros((n_feat, 2), np.float32)
    feat_desc = np.zeros((n_feat, 8), np.uint32)
    feat_valid = np.zeros(n_feat, bool)
    feat_uv[:n] = uv_raw + rng.normal(0, 0.5, (n, 2))
    feat_desc[:n], feat_valid[:n] = desc, inb
    oct0 = np.zeros(n_feat, np.int32)
    cases = [(pose, pt_xyz, pt_desc, pt_valid, feat_uv, feat_desc, oct0,
              feat_valid, 8.0, 80.0, None, None, None, K8j, K8p)]
    from plvio_tpu_torch.inputs import build_projection_case, kb8_camera
    c = build_projection_case(kb8=True)
    Kp = kb8_camera()
    Kj = JRES.KB8K(*Kp)
    base = [c[k] for k in ("pose", "pt_xyz", "pt_desc", "pt_valid",
                           "feat_uv", "feat_desc", "feat_octave",
                           "feat_valid")]
    cases.append((*base, 2.0, 50.0, None, None, None, Kj, Kp))
    cases.append((*base, 6.0, 80.0, c["pt_normal"], c["pt_min_dist"],
                  c["pt_max_dist"], Kj, Kp))
    flips = []
    for (P, Xp, Dp, Vp, U, Df, O, Vf, rad, mxd, nrm, dmin, dmax, Kj_,
         Kp_) in cases:
        jm = JKN.make_projection_matcher_kb8(Kj_, U.shape[0], Xp.shape[0])
        kw = {} if dmin is None else dict(
            pt_normal=jnp.asarray(nrm), pt_min_dist=jnp.asarray(dmin),
            pt_max_dist=jnp.asarray(dmax))
        oj = jm(jnp.asarray(P), jnp.asarray(Xp), jnp.asarray(Dp),
                jnp.asarray(Vp), jnp.asarray(U), jnp.asarray(Df),
                jnp.asarray(O), jnp.asarray(Vf), jnp.float32(rad),
                jnp.float32(mxd), **kw)
        t = [torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a))
            for a in (P, Xp, Dp, Vp, U, Df, O, Vf)]
        fr = [None if a is None else torch.from_numpy(a)
              for a in (nrm, dmin, dmax)]
        op = KN.make_projection_matcher_kb8(Kp_)(*t, rad, mxd, *fr)
        near = _near_gate(Kp_, P, Xp, Vp, U[Vf], O[Vf], rad, dmin, dmax)
        flips.append(_compare_matches(oj, op, near))
        assert int(op[2].sum()) >= 100
    print(f"KB8 matcher rows differing from JAX (all near a gate): {flips}")


def _pose_case(outliers: bool):
    """tests/test_kb8_native.py:38-73's pose case (default_rng(0)), and
    with 20% of its rows moved up to 30 px."""
    from plvio_tpu.utils import lie as JL
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 1.2, 200)
    phi = rng.uniform(0, 2 * np.pi, 200)
    d = rng.uniform(1.5, 5.0, 200)
    X = (np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                   np.cos(theta)], -1) * d[:, None]).astype(np.float32)
    n = len(X)
    pose_true = np.concatenate(
        [np.asarray(JL.so3_exp(jnp.asarray([0.03, -0.05, 0.02]))),
         np.array([[0.1], [-0.1], [0.15]], np.float32)], 1).astype(
             np.float32)
    K8 = JRES.KB8K(**TUMVI)
    pc = X @ pose_true[:, :3].T + pose_true[:, 3]
    uv = np.asarray(jnp.stack([JRES.kb8_project_single(K8, jnp.asarray(p))
                               for p in pc])) + rng.normal(0, 0.3, (n, 2))
    dx = rng.normal(0, 0.03, 6).astype(np.float32)
    Rp, tp = JL.se3_exp(jnp.asarray(dx))
    pose0 = np.concatenate(
        [np.asarray(Rp) @ pose_true[:, :3],
         (np.asarray(Rp) @ pose_true[:, 3] + np.asarray(tp))[:, None]],
        1).astype(np.float32)
    if outliers:
        uv[: n // 5] += np.random.default_rng(11).uniform(-30, 30,
                                                          (n // 5, 2))
    cap = 256
    uv_p = np.zeros((cap, 2), np.float32)
    X_p = np.zeros((cap, 3), np.float32)
    v = np.zeros(cap, bool)
    uv_p[:n], X_p[:n], v[:n] = uv, X, True
    return pose0, uv_p, X_p, v, np.ones(cap, np.float32), pose_true


@pytest.mark.parametrize("outliers", [False, True])
def test_kb8_pose_lm_matches_reference(outliers):
    """(d)"""
    pose0, uv, X, v, is2, truth = _pose_case(outliers)
    cap = len(v)
    jp, ji, jn = JKN.make_pose_optimizer_kb8(JRES.KB8K(**TUMVI), cap)(
        *[jnp.asarray(a) for a in (pose0, uv, X, v, is2)])
    K8 = RES.KB8K(**TUMVI)
    t = [torch.from_numpy(a) for a in (pose0, uv, X, v, is2)]
    pp, pi, pn = KN.make_pose_optimizer_kb8(K8, plain=True)(*t)
    p64, _, _ = KN.kb8_pose_lm_plain(
        K8, *[a.double() if a.is_floating_point() else a for a in t])
    p64 = p64.numpy()
    dj = np.abs(np.asarray(jp) - p64).max()
    dp = np.abs(pp.numpy() - p64).max()
    print(f"KB8 pose LM outliers={outliers}: port {dp:.2e}, JAX {dj:.2e} "
          f"from float64; inliers {int(pn)} / {int(jn)}")
    assert dp <= 2 * dj + 1e-6
    pc = X.astype(np.float64) @ p64[:, :3].T + p64[:, 3]
    from plvio_tpu_torch.io.synthetic import _kb8_project_cam_np
    r = _kb8_project_cam_np(np.c_[pc[:, :2], np.maximum(pc[:, 2], 1e-6)],
                            K8.fx, K8.fy, K8.cx, K8.cy,
                            (K8.k1, K8.k2, K8.k3, K8.k4)) - uv
    chi2 = (r * r).sum(1) * is2
    near = np.abs(chi2 - 5.991) < 0.01 * 5.991
    assert not ((np.asarray(ji) != pi.numpy()) & ~near).any()
    assert np.abs(np.asarray(jp)[:, 3] - truth[:, 3]).max() < 5e-3 \
        or outliers


def test_kb8_local_ba_matches_reference():
    """(e) at the typical bucket's window (16 KF x 2048 points x 4096
    observations), from the perturbed start."""
    from plvio_tpu_torch.inputs import build_kb8_window, kb8_camera
    K8 = kb8_camera()
    A = build_kb8_window(device="cpu")
    args = list(A.values())
    oj = [np.asarray(a) for a in JKN.make_local_ba(
        JRES.KB8K(*K8), 16, 2048, 4096)(*[jnp.asarray(a.numpy())
                                          for a in args])]
    op = KN.make_local_ba(K8, plain=True)(*args)
    o64 = KN.local_ba_plain(K8, *[a.double() if a.is_floating_point()
                                  else a for a in args])
    ref = o64[0].numpy()
    dj = np.abs(oj[0] - ref).max()
    dp = np.abs(op[0].numpy() - ref).max()
    print(f"KB8 window BA: KF poses from float64 port {dp:.2e}, JAX {dj:.2e}")
    assert dp <= 2 * dj + 1e-4
    assert (op[2].numpy() == oj[2]).all()


KB8_TEST_FRAMES = 11
# ORB features a frame in the System comparison: the fisheye room's full
# count (at tests/test_torch_system.py's 500 the JAX tracker's two-view
# bootstrap holds out to frame 14 on these frames)
KB8_TEST_FEATURES = 1000


@pytest.fixture(scope="module")
def kb8_run():
    """Both systems (reduced sizes, loop closing off) over the fisheye
    room's frames on the port's features: JAX from the start, the port from
    the JAX run's state after the bootstrap, until the first keyframe step
    after it."""
    from test_torch_system import (CAPS, MAP, VIBA, _record,
                                   jax_layout, jax_system_with_database,
                                   jax_track, jit_reconstruction)
    from plvio_tpu.config import MapConfig, OrbConfig
    from plvio_tpu_torch.config import MapConfig as PMap
    from plvio_tpu_torch.config import OrbConfig as POrb
    from plvio_tpu_torch.config import SystemConfig as PCfg
    from plvio_tpu_torch.inputs import build_kb8_room
    from plvio_tpu_torch.models.system import System
    from plvio_tpu_torch.state import (kfdb_state, load_kfdb_state,
                                       load_mapper_state, load_tracker_state,
                                       mapper_state, mapstore_from_numpy,
                                       mapstore_to_numpy, tracker_state)
    from plvio_tpu.models import tracking as JT
    cam = dict(model="kb8", fx=380.0, fy=380.0, cx=376.0, cy=240.0,
               dist=KB8_K)
    port = System(PCfg(camera=PCam(**cam), use_lines=False,
                       use_loop_closing=False,
                       orb=POrb(n_features=KB8_TEST_FEATURES),
                       map=PMap(**MAP)),
                  device="cpu", caps=CAPS, viba_caps=VIBA)
    js = jax_system_with_database(kb8_config(
        use_loop_closing=False, orb=OrbConfig(n_features=KB8_TEST_FEATURES),
        map=MapConfig(**MAP)))
    S = build_kb8_room(0, KB8_TEST_FRAMES)
    feats = []

    def capture(*a, _fn=port.track_features):
        feats.append(a[:2])
        return None
    port.track_features = capture
    with torch.no_grad():
        for i in range(KB8_TEST_FRAMES):
            port.track_monocular(S["frames"][i], float(S["timestamps"][i]))
    del port.track_features
    made_p = []
    process = port.mapper.process_keyframe

    def recording(kf, protect=()):
        made_p.append(int(kf))
        return process(kf, protect=protect)
    port.mapper.process_keyframe = recording
    jt, pt = js.tracker, port.tracker
    orig = jit_reconstruction()
    recs, start = [], -1
    try:
        for i, (f, _) in enumerate(feats):
            t = float(S["timestamps"][i])
            if start < 0 and jt.state == JT.TrackState.OK:
                start = i
                port.atlas.maps[0] = mapstore_from_numpy(
                    mapstore_to_numpy(js.atlas.current))
                load_mapper_state(port.mapper, mapper_state(js.mapper))
                load_tracker_state(pt, tracker_state(jt))
                load_kfdb_state(port.kfdb, kfdb_state(js.kfdb))
            n0 = len(js.processed)
            jf, _ = jax_layout(f, _NoLines(f))
            jax_track(js, jf, None, t, None)
            jrec = _record(jt, js.processed[n0:])
            if start >= 0:
                del made_p[:]
                with torch.no_grad():
                    port.track_features(f, None, t, None)
                recs.append((i, jrec, _record(pt, made_p)))
                if i > start and jrec["made"]:
                    break
    finally:
        from plvio_tpu.ops import twoview as JTV
        JTV.reconstruct_two_views = orig
    return dict(recs=recs, start=start, port=port, js=js)


class _NoLines:
    """Line features of no segments, for `jax_layout`'s signature."""

    def __init__(self, f):
        e = torch.zeros(0)
        self.ep = self.angle = self.length = self.lineq = self.valid = e
        self.desc = torch.zeros(0, 8, dtype=torch.int32)


def test_kb8_system_tracks_as_reference(kb8_run):
    """(f)"""
    from test_torch_system import POSE_TOL
    recs = kb8_run["recs"]
    assert 1 <= kb8_run["start"] <= 6
    assert recs and recs[-1][1]["made"], "no keyframe step after the start"
    worst = 0.0
    for i, j, p in recs:
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (i, k, p[k], j[k])
        d = float(np.abs(p["pose"] - j["pose"]).max())
        worst = max(worst, d)
        assert d <= POSE_TOL, (i, d)
    print(f"KB8 System: frames {recs[0][0]}..{recs[-1][0]}, largest pose "
          f"difference {worst:.2e}")
    assert kb8_run["port"].mapper.ba_K == RES.KB8K(
        380.0, 380.0, 376.0, 240.0, *KB8_K)


# REF_KB8's cfg.seed 0 run (the JAX System over the whole room)
REF_KB8_SEED0 = {"n_tracked": 26, "keyframes": 6, "points": 826,
                 "ate_sim3": 0.02527757388697494,
                 "ate_se3": 0.07813825698497055}


@pytest.mark.slow
def test_kb8_room_with_reference_draws():
    """(g)"""
    from test_torch_bootstrap import JaxKeyChain
    from plvio_tpu_torch.entry import kb8_room
    step, S = kb8_room(KB8_FRAMES, device="cpu", sampler=JaxKeyChain(0))
    with torch.no_grad():
        out = step(S)
    ref = REF_KB8_SEED0
    print(f"KB8 room, JAX's draws: init {out.init_frame}, tracked "
          f"{out.n_tracked}, keyframes {out.keyframes}, points {out.points},"
          f" ATE {out.ate_sim3:.5f} / {out.ate_se3:.5f} (JAX {ref})")
    assert out.init_frame == KB8_FRAMES - ref["n_tracked"]
    for k in ("n_tracked", "keyframes", "points"):
        assert getattr(out, k) == ref[k], k
    assert abs(out.ate_sim3 - ref["ate_sim3"]) <= 1e-3
    assert abs(out.ate_se3 - ref["ate_se3"]) <= 1e-3


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed"]:
        print("KB8_SEED = " + json.dumps(reference_kb8(int(sys.argv[2]))))
    else:
        print("REF_KB8 = " + json.dumps(reference_five_seeds()))
