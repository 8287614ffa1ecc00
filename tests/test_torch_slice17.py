"""Slice 17 on the CPU: the bag-of-words score on disjoint bags, the line
level the ORB pyramid's first launch makes for the line front end, and
the arithmetic of schur_solve's redesigned fill-in and CG storage.

- `bow_score`'s plain version is exactly 0 on a bag that shares no word
  with the query (DBoW2's value: it sums over the shared words only, and
  `KeyFrameDatabase` keeps rows whose score is above 0); on bags that
  share words it lies within 1e-6 of JAX's `l1_score` (the sum over
  10 000 words runs in another order) with equal keep decisions.
- The line front end fed the level the ORB extractor returns with its
  pyramid (`OrbExtractor.with_line_level`) gives the bits it gives
  when it makes the level itself, and that level is `line_level_plain`'s.
- A mirror of the fill-in kernel's traversal (csrc/schur_solve.cu
  `fill_kernel`: a keyframe pair's block walks k1's observations in
  column order, forms each shared landmark's columns on both keyframes and
  adds their terms chunk by chunk) equals, in float64, the plain engine's
  dense Gram fill-in Gm Gm^T (solver/engine.py `_schur_reduce`) within
  1e-12 relative, and, in float32, the dense design's chunked sums bit for bit
  (the order the kernel keeps), at 16 keyframes, point+line and inertial.
- The 15-DoF window's stored pattern (`KN.cg_pattern`, the kernel's
  `row_segs`) leaves out only entries that are exactly 0 in the plain
  engine's damped, reduced, frozen system in float64.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.models import vocabulary as JV
from plvio_tpu_torch.entry import K_EUROC
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.models import vocabulary as V
from plvio_tpu_torch.solver import engine as E

SCORE_TOL = 1e-6


def _bags(rng, n, W, lo, hi, draws):
    b = np.zeros((n, W), np.float32)
    for r in range(n):
        np.add.at(b[r], rng.integers(lo, hi, draws), 1.0)
        b[r] /= b[r].sum()
    return b


def test_bow_score_plain_exactly_zero_on_disjoint_bags():
    """512 bags on the other half of the vocabulary from the query: every
    plain score (single bank, pair of banks) exactly 0, none kept; 64 bags
    that share words: within 1e-6 of JAX's l1_score, the same rows kept."""
    rng = np.random.default_rng(8)
    W = 10000
    q = _bags(rng, 1, W, 0, W // 2, 1000)[0]
    far = _bags(rng, 512, W, W // 2, W, 1000)
    mask = torch.ones(512, dtype=torch.bool)
    s = V.score_plain(torch.from_numpy(q), torch.from_numpy(far), mask)
    assert bool((s == 0).all()) and not bool((s > 0).any())
    pair = V.bow_score_pair(torch.from_numpy(q), torch.from_numpy(far), mask,
                            torch.from_numpy(q), torch.from_numpy(far), mask)
    assert bool((pair == 0).all())
    near = _bags(rng, 64, W, 0, W, 900)
    near[5] = far[3]                       # one disjoint row among them
    m = torch.from_numpy(rng.random(64) > 0.2)
    sp = V.bow_score(torch.from_numpy(q), torch.from_numpy(near), m).numpy()
    sj = np.where(m.numpy(), np.asarray(JV.l1_score(jnp.asarray(q),
                                                    jnp.asarray(near))), -1.0)
    shared = ((q[None] > 0) & (near > 0)).any(1)
    assert shared.sum() == 63 and sp[5] in (0.0, -1.0)
    np.testing.assert_allclose(sp, sj, atol=SCORE_TOL, rtol=0)
    live = m.numpy() & shared
    assert np.array_equal(sp[live] > 0, sj[live] > 0) and (sp[live] > 0).all()


def test_frame_line_level_from_the_pyramid():
    """`frame_prelude`'s fused path: the ORB extractor's pyramid returns
    the line level (bit-equal to `line_level_plain`), and the line
    extractor given it returns the bits of the extractor that makes the
    level itself; the ORB features are those of the call without it."""
    from plvio_tpu_torch.models.system import (frame_prelude,
                                               undistort_features)
    from plvio_tpu_torch.ops import frontend as FE
    from plvio_tpu_torch.ops import lines as LN
    from plvio_tpu_torch.ops.cameras import make_camera
    from plvio_tpu_torch.config import CameraConfig
    rng = np.random.default_rng(3)
    h, w = 120, 200
    img = torch.from_numpy(rng.uniform(0, 255, (1, 1, h, w)).astype(
        np.float32))
    img = torch.nn.functional.avg_pool2d(img, 5, 1, 2)[0, 0] * 1.7 - 90.0
    img = img.clamp(0, 255).contiguous()
    img[30:90, 40:42] = 250.0                  # two edges for the lines
    img[60:62, 20:180] = 5.0
    orb = FE.OrbExtractor(FE.make_level_specs(h, w, 300))
    lines = LN.LineExtractor(32, levels=2)
    feats, level1 = orb.with_line_level(img)
    assert torch.equal(level1, FE.line_level_plain(img))
    f0 = orb(img)
    assert all(torch.equal(a, b) for a, b in zip(feats, f0))
    lf, lf0 = lines(img, level1), lines(img)
    assert all(torch.equal(a, b) for a, b in zip(lf, lf0))
    cam = make_camera(CameraConfig())
    pf, plf = frame_prelude(orb, lines, cam, img)
    ef, elf = undistort_features(cam, f0, lf0)

    def same(a, b):                  # NaN where both are (invalid slots)
        return a.shape == b.shape and bool(
            ((a == b) | (a.isnan() & b.isnan()) if a.is_floating_point()
             else a == b).all())
    assert all(same(a, b) for a, b in zip(plf, elf))
    assert all(same(a, b) for a, b in zip(pf, ef))


def _observation_factors(prob, st, lam, lm_free):
    """Per landmark family: (G [n_obs, 6, d] = W_o F of each observation,
    the observations' keyframe and landmark indices) in float64, W_o the
    observation's pose-landmark coupling block J_pose^T w J_lm (the
    engine's B summed over them) and F the engine's chol(Hpp_d)^-T with
    its gates (solver/engine.py `_schur_reduce`)."""
    _, H, _, lm_sys, _, _ = prob.build_normal_equations(st)
    out = {}
    for term in prob.terms:
        if term.lm_ref is None:
            continue
        name, lidx = term.lm_ref
        _, J, w, _, dofs = prob._linearize(term, st)
        Jp = torch.split(J, dofs, dim=2)
        Wo = torch.einsum("kdi,kdj->kij", Jp[0] * w[:, None, None], Jp[1])
        Hpp, gp, _ = lm_sys[name]
        lf = lm_free[name].to(H.dtype)
        Hpp = Hpp * lf[:, None, None]
        dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hd = Hpp + torch.diag_embed(dpp * lam + 1e-4 * dpp.mean(-1, True)
                                    + 1e-6)
        occ = (dpp.sum(-1) > 1e-9) & lm_free[name]
        eye = torch.eye(Hpp.shape[-1], dtype=H.dtype)
        F = E.chol_invT_blocks(torch.where(occ[:, None, None], Hd, eye))
        occ = occ & torch.isfinite(F).all(-1).all(-1) \
            & (F.abs().amax((-2, -1)) < 1e3)
        F = torch.where(occ[:, None, None], F, torch.zeros_like(F))
        G = torch.einsum("kij,kjl->kil", Wo * lf[lidx][:, None, None],
                         F[lidx])
        out[name] = (G, term.dense_refs[0][1], lidx)
    return out


CHUNKS = 24          # csrc/schur_solve.cu kSumChunks


def _columns(fams, n_lm):
    """Per family: (G [n, 6, d] numpy, keyframe, landmark, first column of
    the family's landmarks in the coupling); C."""
    out, c0 = {}, 0
    for f, d in (("pt", 3), ("ln", 6)):
        G, kfi, lmi = fams[f]
        out[f] = (G.numpy(), kfi.numpy(), lmi.numpy(), c0, d)
        c0 += d * n_lm[f]
    return out, c0


def _traversal(fams, valid, n_kf, n_lm, dt):
    """The fill-in kernel's walk (csrc/schur_solve.cu `fill_kernel`) in
    the float type dt: per block (k1 <= k2), k1's observations by their
    landmark's column; each landmark's factor on k1 summed over k1's
    observations of it and on k2 over its observations in k2, both in
    observation order from 0; where k2 sees it, its columns' terms
    g1[a] g2[b] added in column order into their chunk's sum, the chunks
    then added in order from 0."""
    cols, C = _columns(fams, n_lm)
    cols = {f: (v[0].astype(dt),) + v[1:] for f, v in cols.items()}
    chunk = -(-C // CHUNKS)
    okf = np.concatenate([cols[f][1] for f in cols])
    col = np.concatenate([cols[f][3] + cols[f][4] * cols[f][2]
                          for f in cols])
    ok = np.concatenate([valid[f].numpy() for f in cols])
    n_obs = len(cols["pt"][1])
    order = np.argsort(np.where(ok, okf * C + col, n_kf * C),
                       kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(okf[ok],
                                                       minlength=n_kf))])
    Ff = np.zeros((6 * n_kf, 6 * n_kf), dt)
    for k1 in range(n_kf):
        for k2 in range(k1, n_kf):
            part = np.zeros((CHUNKS, 6, 6), dt)
            q, q1 = start[k1], start[k1 + 1]
            while q < q1:
                o = order[q]
                f = "pt" if o < n_obs else "ln"
                G, kfi, lmi, c0, d = cols[f]
                loc = o if f == "pt" else o - n_obs
                g1 = np.zeros((6, d), dt)
                while q < q1 and col[order[q]] == col[o]:
                    o1 = order[q]
                    g1 = g1 + G[o1 if f == "pt" else o1 - n_obs]
                    q += 1
                p = lmi[loc]
                mine = np.nonzero(ok[n_obs:] if f == "ln" else ok[:n_obs])[0]
                mine = mine[(lmi[mine] == p) & (kfi[mine] == k2)]
                if len(mine) == 0:
                    continue
                g2 = np.zeros((6, d), dt)
                for o2 in mine:                    # observation order
                    g2 = g2 + G[o2]
                for m in range(d):
                    c = (c0 + d * p + m) // chunk
                    part[c] = part[c] + np.outer(g1[:, m], g2[:, m])
            tot = np.zeros((6, 6), dt)
            for c in range(CHUNKS):
                tot = tot + part[c]
            Ff[6 * k1:6 * k1 + 6, 6 * k2:6 * k2 + 6] = tot
            Ff[6 * k2:6 * k2 + 6, 6 * k1:6 * k1 + 6] = tot.T
    return Ff


def _dense_chunked(fams, valid, n_kf, n_lm, dt):
    """The dense design's fill-in in the float type dt: the operand Gm summed
    observation by observation in landmark order (csrc/schur_solve.cu's
    factor stage then), Gm Gm^T over the columns in CHUNKS chunks of
    ceil(C / CHUNKS), each chunk from 0 in column order, the chunks added
    in order from 0 (its `gram_kernel` and `gram_reduce_kernel`)."""
    cols, C = _columns(fams, n_lm)
    Gm = np.zeros((6 * n_kf, C), dt)
    for f, (G, kfi, lmi, c0, d) in cols.items():
        ok = valid[f].numpy()
        for o in np.argsort(np.where(ok, lmi, n_lm[f]), kind="stable"):
            if ok[o]:
                r, c = 6 * kfi[o], c0 + d * lmi[o]
                Gm[r:r + 6, c:c + d] = Gm[r:r + 6, c:c + d] + G[o].astype(dt)
    chunk = -(-C // CHUNKS)
    Ff = np.zeros((6 * n_kf, 6 * n_kf), dt)
    for c in range(CHUNKS):
        acc = np.zeros_like(Ff)
        for k in range(c * chunk, min(C, (c + 1) * chunk)):
            acc = acc + np.outer(Gm[:, k], Gm[:, k])
        Ff = Ff + acc
    return Ff


def _dense_gram(fams, n_kf, n_lm, valid):
    """Gm Gm^T of the engine's Gram operand Gm [6 n_kf, sum P d], summed
    from the same per-observation factors."""
    cols = []
    for f, (G, kfi, lmi) in fams.items():
        g = G * valid[f][:, None, None].to(G.dtype)
        Bk = torch.zeros(n_kf, n_lm[f], 6, G.shape[2], dtype=torch.float64)
        Bk.index_put_((kfi, lmi), g, accumulate=True)
        cols.append(Bk.permute(0, 2, 1, 3).reshape(6 * n_kf, -1))
    Gm = torch.cat(cols, 1)
    return Gm @ Gm.T


@functools.lru_cache(maxsize=None)
def _window(kind):
    """A 16-keyframe window of the kind on the CPU in float64: (problem,
    states, dense and landmark free masks, valid masks, landmark counts);
    built once a module (nothing here changes them)."""
    if kind == "point+line":
        from plvio_tpu_torch.entry import mapping_step
        from plvio_tpu_torch.inputs import perturb_window
        _, A = mapping_step(n_kf=16, n_pt=192, n_obs=384, n_feat=256,
                            n_ln=24, n_lobs=48, device="cpu")
        P, X = perturb_window(A["kf_poses"].numpy(), A["pt_xyz"].numpy())
        d = torch.float64
        prob = KN._ba_problem(
            K_EUROC, 16, 192, 24, A["obs_kf"].long(), A["obs_pt"].long(),
            A["obs_uv"].to(d), A["obs_valid"], A["obs_is2"].to(d),
            A["lobs_kf"].long(), A["lobs_ln"].long(), A["lobs_eq"].to(d),
            A["lobs_valid"], A["lobs_is2"].to(d))
        st = {"pose": torch.from_numpy(P).to(d),
              "pt": torch.from_numpy(X).to(d), "ln": A["ln_ep6"].to(d)}
        free = ({"pose": A["kf_free"]},
                {"pt": A["pt_free"], "ln": A["ln_free"]})
        valid = {"pt": A["obs_valid"], "ln": A["lobs_valid"]}
        return prob, st, free, valid, {"pt": 192, "ln": 24}
    from plvio_tpu_torch.inputs import build_inertial_window
    A = build_inertial_window(n_pt=192, n_obs=384, n_ln=24, n_lobs=48,
                              n_kf=16, n_observers=3, device="cpu",
                              perturbed=True)
    d = torch.float64

    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.to(d) if v.is_floating_point() else v
    a = [cast(A[k]) for k in KN.LIBA_KEYS]
    prob = KN._liba_problem(
        K_EUROC, A["Rcb"].to(d), A["tcb"].to(d), 9.81, 16, 192, 24,
        (a[8].long(), a[9].long(), a[10], a[12]), a[11],
        (a[20].long(), a[21].long(), a[22]), a[23],
        (a[13], a[14], a[15], a[16], a[17]))
    st = {"pose": a[0], "vel": a[1], "bg": a[2], "ba": a[3], "pt": a[6],
          "ln": a[18]}
    free = ({"pose": a[4], "vel": a[4], "bg": a[5], "ba": a[5]},
            {"pt": a[7], "ln": a[19]})
    valid = {"pt": a[11], "ln": a[23]}
    return prob, st, free, valid, {"pt": 192, "ln": 24}


@pytest.mark.parametrize("kind", ["point+line", "inertial"])
def test_fill_in_traversal_equals_dense_gram(kind):
    """The kernel's walk in float64 within 1e-12 relative of the engine's
    dense Gram, and in float32 bit-equal to the dense design's chunked
    sums."""
    prob, st, free, valid, n_lm = _window(kind)
    fams = _observation_factors(prob, st, 1e-4, free[1])
    Ff = torch.from_numpy(_traversal(fams, valid, 16, n_lm, np.float64))
    ref = _dense_gram(fams, 16, n_lm, valid)
    scale = float(ref.abs().max())
    assert scale > 0 and int((Ff != 0).sum()) > 0
    assert float((Ff - ref).abs().max()) <= 1e-12 * scale
    f32 = _traversal(fams, valid, 16, n_lm, np.float32)
    assert np.array_equal(f32, _dense_chunked(fams, valid, 16, n_lm,
                                              np.float32))
    # and the engine's own fill-in (its H minus the reduced system's pose
    # block, before the freeze) is the same Gram
    layout, H, g, lm_sys, _, _ = prob.build_normal_equations(st)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    Hd = H + torch.diag(torch.diagonal(H) * lam + 1e-6)
    Hr = Hd
    for name, (Hpp, gp, B) in lm_sys.items():
        Hr, _, _ = prob._schur_reduce(name, Hpp, gp, B, Hr, g, lam,
                                      free[1][name])
    fill = (Hd - Hr)[:96, :96]
    assert float((fill - ref).abs().max()) <= 1e-10 * scale


def test_cg_pattern_holds_every_nonzero_of_the_15dof_system():
    prob, st, free, _, _ = _window("inertial")
    layout, H, g, lm_sys, _, _ = prob.build_normal_equations(st)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    Hr, _, _, _ = prob.reduce_system(layout, H, g, lm_sys, lam, *free)
    pat = KN.cg_pattern(16, True)
    # pose rows: the 96 pose columns and 3 x 3 columns of each of the 2-3
    # neighbouring keyframes' families; the other rows 15 a neighbour
    assert Hr.shape == pat.shape == (240, 240)
    assert int(pat.sum()) == 6 * (96 * 16 + 9 * 46) + 9 * 15 * 46 == 17910
    assert bool((Hr[~pat] == 0).all())
    assert int((Hr[96:][pat[96:]] != 0).sum()) > 0
    assert bool(KN.cg_pattern(16, False).all())
