"""Slice 6, the two-view reconstruction of the monocular bootstrap, against
the JAX package on the CPU (plvio_tpu/ops/twoview.py), on the cases of
tests/test_twoview.py (`inputs.build_twoview_cases`: general, planar, 40
outliers, pure rotation, and the general scene as raw EuRoC pixels).

The port cannot draw JAX's RANSAC samples, so it gets them: JAX's
`_sample_indices` on the two halves of the case's key, as
`reconstruct_two_views` draws them.  The JAX functions run under
`jax.jit`, compiled once per shape for the module.

Tolerances, and why.  The homography is the reference's DLT on raw
pixels, an ill-conditioned system: XLA's and torch's float32 SVDs of it
lie ~1e-4 (median) to ~3e-2 (worst minimal set) from its float64
solution, and from each other.  So, as in slices 3-5, float32 results are
held to a float64 run of the port's plain version: the port's distance to
it at most 2x JAX's, plus float32's floor of 2e-5 of the value's
magnitude (where both are that close, e.g. the general scene's t: port
1.1e-5, JAX 2.7e-6).  Further:
- `success` and `used_homography`: equal; the pure rotation fails on
  both sides.
- `is_triangulated`: equal but for `FLIP_SHARE` of the matches (rows
  whose inlier or gate test one float32 model takes and the other does
  not; 0-1 on these cases).
- scores: within 1e-4 of the best score for every minimal model whose
  condition number is below 1e6 (on worse ones JAX's float32 inverse lies
  2.1e-4 from float64, the port's 4.7e-5), and no farther from a float64
  scoring than 2x JAX's; inlier masks equal but for rows within 1e-3 of a
  gate.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plvio_tpu.config import CameraConfig as JCameraConfig
from plvio_tpu.ops import cameras as JCAM
from plvio_tpu.ops import twoview as JTV
from plvio_tpu.solver.residuals import PinholeK as JPinholeK
from plvio_tpu_torch.config import CameraConfig
from plvio_tpu_torch.entry import K_EUROC as K
from plvio_tpu_torch.inputs import TWOVIEW_CASES, build_twoview_cases
from plvio_tpu_torch.ops import cameras as CAM
from plvio_tpu_torch.ops import twoview as TV
from plvio_tpu_torch.utils import lie

JK = JPinholeK(fx=K.fx, fy=K.fy, cx=K.cx, cy=K.cy)
FLIP_SHARE = 0.01
KEYS = {"general": 0, "planar": 1, "outliers": 2, "rotation": 3,
        "euroc_raw": 0}


@pytest.fixture(scope="module")
def jx():
    """The JAX functions, jitted once for the module."""
    jcam = JCAM.make_camera(JCameraConfig())
    f = dict(
        sample=jax.jit(JTV._sample_indices, static_argnums=(2, 3)),
        recon=jax.jit(lambda u1, u2, v, k: JTV.reconstruct_two_views(
            JK, u1, u2, v, k)),
        dlt=jax.jit(jax.vmap(JTV._dlt_homography)),
        eight=jax.jit(jax.vmap(JTV._eight_point_F)),
        eight_w=jax.jit(JTV._eight_point_F),
        dlt_w=jax.jit(JTV._dlt_homography_w),
        score_h=jax.jit(jax.vmap(JTV.score_H, (0, None, None, None))),
        score_f=jax.jit(jax.vmap(JTV.score_F, (0, None, None, None))),
        check=jax.jit(JTV._check_rt),
        rec_e=jax.jit(JTV.recover_from_E),
        rec_h=jax.jit(JTV.recover_from_H),
        undistort=jax.jit(lambda uv: JCAM.undistort_pixels(jcam, uv)))
    f["cases"] = {n: build_twoview_cases(0, n) for n in (200, 1000)}
    return f


def case_inputs(jx, name, n):
    """(JAX's uv1, uv2, the port's uv1, uv2, valid, key, idx_h, idx_f)."""
    c = jx["cases"][n][name]
    u1, u2 = c["uv1"], c["uv2"]
    p1, p2 = torch.from_numpy(u1), torch.from_numpy(u2)
    j1, j2 = jnp.asarray(u1), jnp.asarray(u2)
    if c["raw"]:
        cam = CAM.make_camera(CameraConfig())
        p1, p2 = CAM.undistort_pixels(cam, p1), CAM.undistort_pixels(cam, p2)
        j1, j2 = jx["undistort"](j1), jx["undistort"](j2)
    valid = jnp.asarray(c["valid"])
    key = jax.random.PRNGKey(KEYS[name])
    k_h, k_f = jax.random.split(key)
    idx_h = np.array(jx["sample"](k_h, valid, 200, 4))
    idx_f = np.array(jx["sample"](k_f, valid, 200, 8))
    return j1, j2, p1, p2, c["valid"], key, idx_h, idx_f


def unit_sign(M):
    """Models up to scale and sign: unit Frobenius norm, the largest
    entry positive; [B,9] float64."""
    M = np.asarray(M, np.float64).reshape(-1, 9)
    M = M / np.linalg.norm(M, axis=1, keepdims=True)
    s = np.sign(M[np.arange(len(M)), np.abs(M).argmax(1)])
    return M * s[:, None]


def gaps(port, jax_, f64):
    """Entry distances of the port's and JAX's values from float64."""
    f64 = np.asarray(f64, np.float64)
    return (np.abs(np.asarray(port, np.float64) - f64),
            np.abs(np.asarray(jax_, np.float64) - f64))


def assert_f64_rule(port, jax_, f64, what):
    """The port's float32 value no farther from float64 than 2x JAX's, or
    than float32's floor (2e-5 of the value's magnitude, at least 1)."""
    gp, gj = gaps(port, jax_, f64)
    floor = 2e-5 * max(1.0, float(np.abs(np.asarray(f64)).max()))
    assert gp.max() <= 2 * gj.max() + floor, (what, gp.max(), gj.max())


def near_gate(c, th, tol=1e-3):
    return np.abs(np.asarray(c, np.float64) - th) < tol * th


@pytest.mark.parametrize("part", ["dlt_homography", "eight_point_F",
                                  "dlt_homography_w", "score_H", "score_F",
                                  "check_rt", "recover_from_E",
                                  "recover_from_H"])
def test_parts_match_jax(jx, part):
    name = "planar" if part in ("dlt_homography_w", "recover_from_H") \
        else "general"
    j1, j2, p1, p2, valid, key, idx_h, idx_f = case_inputs(jx, name, 200)
    q1, q2 = p1.double(), p2.double()
    pv = torch.from_numpy(valid)
    jv = jnp.asarray(valid)
    jH = np.array(jx["dlt"](j1[idx_h], j2[idx_h]))
    jF = np.array(jx["eight"](j1[idx_f], j2[idx_f]))
    if part == "dlt_homography":
        pH = TV._dlt_homography(p1[idx_h], p2[idx_h])
        qH = TV._dlt_homography(q1[idx_h], q2[idx_h])
        gp, gj = (np.abs(unit_sign(a) - unit_sign(qH)).max(1)
                  for a in (pH, jH))
        assert np.median(gp) <= 2 * np.median(gj) + 1e-6
        assert gp.max() <= 2 * gj.max() + 1e-6
    elif part == "eight_point_F":
        pF = TV._eight_point_F(p1[idx_f], p2[idx_f])
        qF = TV._eight_point_F(q1[idx_f], q2[idx_f])
        gp, gj = (np.abs(unit_sign(a) - unit_sign(qF)).max(1)
                  for a in (pF, jF))
        assert np.median(gp) <= 2 * np.median(gj) + 1e-6
        assert gp.max() <= 2 * gj.max() + 1e-6
    elif part == "dlt_homography_w":
        sH, okH = jx["score_h"](jnp.asarray(jH), j1, j2, jv)
        w = np.asarray(okH[int(jnp.argmax(sH))], np.float32)
        jW = np.asarray(jx["dlt_w"](j1, j2, jnp.asarray(w)))
        pW = TV._dlt_homography_w(p1, p2, torch.from_numpy(w))
        qW = TV._dlt_homography_w(q1, q2, torch.from_numpy(w).double())
        assert_f64_rule(unit_sign(pW), unit_sign(jW), unit_sign(qW), part)
    elif part in ("score_H", "score_F"):
        models = jH if part == "score_H" else jF
        jfn = jx["score_h" if part == "score_H" else "score_f"]
        pfn = TV.score_H if part == "score_H" else TV.score_F
        js, jok = (np.asarray(a) for a in jfn(jnp.asarray(models), j1, j2,
                                              jv))
        ps, pok = pfn(torch.from_numpy(models), p1, p2, pv)
        qs, _ = pfn(torch.from_numpy(models).double(), q1, q2, pv)
        ps, pok, qs = ps.numpy(), pok.numpy(), qs.numpy()
        cond = np.linalg.cond(models.astype(np.float64)) \
            if part == "score_H" else np.ones(len(models))
        well = cond < 1e6
        assert well.mean() > 0.5
        assert np.abs(ps - js)[well].max() <= 1e-4 * np.abs(js).max()
        assert_f64_rule(ps, js, qs, part)
        # gate values of each row under each model, in float64
        th = 5.991 if part == "score_H" else 3.841
        c = score_terms(torch.from_numpy(models).double(), q1, q2,
                        part == "score_H")
        differ = pok != jok
        assert not (differ & ~near_gate(c, th)).any()
    elif part == "check_rt":
        jres = jx["recon"](j1, j2, jv, key)
        R, t = np.array(jres.R), np.array(jres.t)
        x1n, x2n = (TV._normalize_pixels(K, a) for a in (p1, p2))
        jc, jg, jX = (np.array(a) for a in jx["check"](
            jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1n.numpy()),
            jnp.asarray(x2n.numpy()), jv))
        pc, pg, pX = TV._check_rt(torch.from_numpy(R), torch.from_numpy(t),
                                  x1n, x2n, pv)
        qc, qg, qX = TV._check_rt(torch.from_numpy(R).double(),
                                  torch.from_numpy(t).double(),
                                  x1n.double(), x2n.double(), pv)
        assert (pg.numpy() != jg).sum() <= FLIP_SHARE * len(valid)
        assert abs(int(pc) - int(jc)) <= FLIP_SHARE * len(valid)
        both = pg.numpy() & jg & qg.numpy()
        assert both.sum() > 100
        assert_f64_rule(pX.numpy()[both], jX[both], qX.numpy()[both], part)
    else:
        use_h = part == "recover_from_H"
        sc = jx["score_h" if use_h else "score_f"]
        models = jH if use_h else jF
        s, ok = sc(jnp.asarray(models), j1, j2, jv)
        inl = ok[int(jnp.argmax(s))].astype(jnp.float32)
        Km = np.array([[K.fx, 0, K.cx], [0, K.fy, K.cy], [0, 0, 1.0]],
                      np.float32)
        if use_h:
            M = np.asarray(jx["dlt_w"](j1, j2, inl))
            _, inl = JTV.score_H(jnp.asarray(M), j1, j2, jv)
            M = np.linalg.inv(Km) @ M @ Km
        else:
            M = np.asarray(jx["eight_w"](j1, j2, inl))
            _, inl = JTV.score_F(jnp.asarray(M), j1, j2, jv)
            M = Km.T @ M @ Km
        M = M.astype(np.float32)
        x1n, x2n = (TV._normalize_pixels(K, a) for a in (p1, p2))
        inl_np = np.array(inl)
        jr = [np.array(a) for a in jx["rec_h" if use_h else "rec_e"](
            jnp.asarray(M), jnp.asarray(x1n.numpy()),
            jnp.asarray(x2n.numpy()), jnp.asarray(inl_np))]
        pfn = TV.recover_from_H if use_h else TV.recover_from_E
        pr = [a.numpy() for a in pfn(torch.from_numpy(M), x1n, x2n,
                                     torch.from_numpy(inl_np))]
        qr = [a.numpy() for a in pfn(torch.from_numpy(M).double(),
                                     x1n.double(), x2n.double(),
                                     torch.from_numpy(inl_np))]
        assert bool(pr[0]) and bool(jr[0]) and bool(qr[0])
        for k, what in ((1, "R"), (2, "t")):
            assert_f64_rule(pr[k], jr[k], qr[k], what)
        assert (pr[4] != jr[4]).sum() <= FLIP_SHARE * len(valid)
        both = pr[4] & jr[4] & qr[4]
        assert_f64_rule(pr[3][both], jr[3][both], qr[3][both], "X")


def score_terms(models, uv1, uv2, homography: bool):
    """Each row's larger gate value (c1, c2) under each model [B,N]."""
    x1, x2 = TV._homog(uv1), TV._homog(uv2)
    if homography:
        p2 = TV._dehomog(x1 @ models.transpose(-1, -2))
        p1 = TV._dehomog(x2 @ torch.linalg.inv(models).transpose(-1, -2))
        c1 = ((p1 - uv1) ** 2).sum(-1)
        c2 = ((p2 - uv2) ** 2).sum(-1)
    else:
        l2 = x1 @ models.transpose(-1, -2)
        l1 = x2 @ models
        c2 = (l2 * x2).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2)
        c1 = (l1 * x1).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2)
    th = 5.991 if homography else 3.841
    # the term nearer its gate decides a flip
    return torch.where((c1 - th).abs() < (c2 - th).abs(), c1, c2).numpy()


@pytest.mark.parametrize("name,n", [(c, 200) for c in TWOVIEW_CASES]
                         + [("general", 1000)])
def test_reconstruct_two_views_matches_jax(jx, name, n):
    j1, j2, p1, p2, valid, key, idx_h, idx_f = case_inputs(jx, name, n)
    jres = jax.tree_util.tree_map(np.asarray, jx["recon"](
        j1, j2, jnp.asarray(valid), key))
    pv = torch.from_numpy(valid)
    pres = TV.reconstruct_two_views(K, p1, p2, pv, idx_h, idx_f)
    qres = TV.reconstruct_two_views(K, p1.double(), p2.double(), pv, idx_h,
                                    idx_f)
    assert bool(pres.success) == bool(jres.success)
    assert bool(pres.used_homography) == bool(jres.used_homography)
    if name == "rotation":
        assert not bool(pres.success) and not bool(qres.success)
        return
    assert bool(pres.success) and bool(qres.success)
    assert bool(qres.used_homography) == bool(jres.used_homography)
    pg, qg = pres.is_triangulated.numpy(), qres.is_triangulated.numpy()
    assert (pg != jres.is_triangulated).sum() <= FLIP_SHARE * n
    assert_f64_rule(pres.R.numpy(), jres.R, qres.R.numpy(), "R")
    assert_f64_rule(pres.t.numpy(), jres.t, qres.t.numpy(), "t")
    both = pg & jres.is_triangulated & qg
    assert both.mean() > 0.4
    assert_f64_rule(pres.points3d.numpy()[both], jres.points3d[both],
                    qres.points3d.numpy()[both], "points")


def test_own_draw(jx):
    """The port's own draw: distinct indices of valid rows, and a general
    scene reconstructed within the reference test's bounds."""
    c = jx["cases"][200]["general"]
    valid = torch.from_numpy(c["valid"])
    valid[::7] = False
    g = torch.Generator().manual_seed(3)
    for k in (4, 8):
        idx = TV.sample_indices(valid, 200, k, g)
        assert idx.shape == (200, k) and idx.dtype == torch.int64
        assert bool(valid[idx].all())
        s = idx.sort(1).values
        assert bool((s[:, 1:] != s[:, :-1]).all())
    res = TV.reconstruct_two_views(K, torch.from_numpy(c["uv1"]),
                                   torch.from_numpy(c["uv2"]), valid,
                                   generator=g)
    assert bool(res.success) and not bool(res.used_homography)
    dR = res.R.double().T @ torch.from_numpy(c["R"])
    ang = float(lie.so3_log(dR.float()).norm())
    assert ang < 0.01
    t_dir = c["t"] / np.linalg.norm(c["t"])
    t = res.t.double().numpy()
    assert np.linalg.norm(t / np.linalg.norm(t) - t_dir) < 0.06
