"""The windowed point+line BA against the JAX package (CPU): the analytic
Jacobians of the two BA residuals, the engine's Schur pieces
(`chol_invT_blocks`, `_cg_solve`, one Schur `solve_step`) and
`make_local_ba_pl` from the true and from a perturbed start, on
bench.build_mapping_step's window at 4 KF / 256 points / 512 observations
/ 32 lines / 64 line observations.

Tolerances, and why:
- Jacobians: analytic against torch.func.jacrev in float64, <= 1e-7.
- chol_invT_blocks: 1e-5 relative (the same closed forms in float32);
  _cg_solve: 5e-4 relative after 16 steps on a system of condition ~120
  (matrix-vector sums in another order, amplified by CG; 1.2e-4 seen).
- one Schur step: cost within 1e-5 relative, poses within 5e-5 (9e-6
  seen: the reduced solve is 16 CG steps in float32), points within 1e-4
  relative where the point's Hpp is well conditioned (smallest eigenvalue
  >= 1e-3 of the largest): a point seen from two nearby KFs has a
  near-null depth direction that amplifies the pose difference.
- the plain BA in float32 against itself in float64 (the engine follows
  the states' dtype): the same iteration counts, KF poses within 3e-3
  (1.5-1.6e-3 seen: at 4 KF the 16-step CG amplifies float32 rounding;
  this band is why the card compares kernel and plain paths at 16 KF).
- the whole BA: KF poses within 1e-3 (a pose entry), inlier masks equal,
  largest camera-centre error within 10% of the reference's.  The LM
  accepts a step when a sum over ~600 terms falls and exits when it moves
  by < 1e-2 relative, so sums in another order can flip a borderline
  decision; both sides' iteration counts per round are checked equal here
  (the JAX side's from a step-by-step replay of its loop, `_jax_lm_iters`).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacrev

import bench
from plvio_tpu.models import kernels as JK
from plvio_tpu.solver import engine as JE
from plvio_tpu.solver import residuals as JR
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu_torch.entry import K_EUROC
from plvio_tpu_torch.inputs import perturb_window
from plvio_tpu_torch.models import kernels as TK
from plvio_tpu_torch.solver import engine as TE
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.utils import lie

SMALL = dict(n_kf=4, n_pt=256, n_obs=512, n_feat=128, n_ln=32, n_lobs=64)
KEYS = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
        "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free", "lobs_kf",
        "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")
JPK = JPin(*K_EUROC)


@pytest.fixture(scope="module")
def window():
    _, A = bench.build_mapping_step(**SMALL)
    return {k: np.asarray(v) for k, v in A.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _start(A, perturbed):
    B = dict(A)
    if perturbed:
        B["kf_poses"], B["pt_xyz"] = perturb_window(A["kf_poses"],
                                                    A["pt_xyz"])
    return B


def _centre_err(P, G):
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    c = -np.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -np.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float(np.linalg.norm(c - cg, axis=1).max())


# -- analytic Jacobians --------------------------------------------------

def _rand_poses(rng, n):
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.3, (n, 3))))
    t = torch.from_numpy(rng.normal(0, 0.5, (n, 3)))
    return torch.cat([R, t[..., None]], -1)


def _autodiff(res, blocks, const, dofs):
    def f(delta, blk, c):
        return res(blk, torch.split(delta, dofs), c)
    n = blocks[0].shape[0]
    zeros = torch.zeros(n, sum(dofs), dtype=torch.float64)
    return torch.func.vmap(jacrev(f))(zeros, blocks, const)


def test_point_jacobian_matches_autodiff():
    rng = np.random.default_rng(0)
    n = 64
    P = _rand_poses(rng, n)
    X = torch.from_numpy(rng.uniform([-2, -2, 2], [2, 2, 8], (n, 3)))
    uv = torch.from_numpy(rng.uniform(0, 400, (n, 2)))
    J = _autodiff(RES.make_point_reproj(K_EUROC), (P, X), {"uv": uv},
                  [6, 3])
    r, Jp, Jx = RES.point_reproj_jac(K_EUROC, P, X, uv)
    assert float((torch.cat([Jp, Jx], -1) - J).abs().max()) <= 1e-7 * float(
        J.abs().max())
    r_ref = torch.func.vmap(RES.make_point_reproj(K_EUROC))(
        (P, X), (torch.zeros(n, 6, dtype=torch.float64),
                 torch.zeros(n, 3, dtype=torch.float64)), {"uv": uv})
    assert float((r - r_ref).abs().max()) <= 1e-9


def test_line_jacobian_matches_autodiff():
    rng = np.random.default_rng(1)
    n = 64
    P = _rand_poses(rng, n)
    Xs = rng.uniform([-2, -2, 2], [2, 2, 8], (n, 3))
    L = torch.from_numpy(np.concatenate(
        [Xs, Xs + rng.normal(0, 0.5, (n, 3))], 1))
    l = rng.normal(0, 1, (n, 3))
    l /= np.linalg.norm(l[:, :2], axis=1, keepdims=True)
    l = torch.from_numpy(l)
    J = _autodiff(RES.make_line_reproj(K_EUROC), (P, L), {"l": l}, [6, 6])
    r, Jp, Jl = RES.line_reproj_jac(K_EUROC, P, L, l)
    assert float((torch.cat([Jp, Jl], -1) - J).abs().max()) <= 1e-7 * float(
        J.abs().max())


# -- Schur pieces ------------------------------------------------------------

@pytest.mark.parametrize("d", [3, 6])
def test_chol_invT_blocks_matches_reference(d):
    rng = np.random.default_rng(d)
    M = rng.normal(0, 1, (50, d, d))
    A = (M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(d)).astype(np.float32)
    Fj = np.asarray(jax.jit(JE.chol_invT_blocks)(A))
    Ft = TE.chol_invT_blocks(_t(A)).numpy()
    assert np.abs(Ft - Fj).max() <= 1e-5 * np.abs(Fj).max()
    inv = np.linalg.inv(A.astype(np.float64))
    FFt = Ft.astype(np.float64) @ np.swapaxes(Ft, -1, -2)
    assert np.abs(FFt - inv).max() <= 1e-3 * np.abs(inv).max()


def test_cg_solve_matches_reference():
    rng = np.random.default_rng(2)
    M = rng.normal(0, 1, (24, 24))
    H = (M @ M.T + np.diag(np.logspace(-2, 2, 24))).astype(np.float32)
    g = rng.normal(0, 1, 24).astype(np.float32)
    xj = np.asarray(jax.jit(lambda a, b: JE._cg_solve(a, b, 16))(H, g))
    xt = TE._cg_solve(_t(H), _t(g), 16).numpy()
    assert np.abs(xt - xj).max() <= 5e-4 * np.abs(xj).max()


def _jax_problem(B, mask, mask_l):
    prob = JE.Problem(linear_solver="cg")
    prob.add_dense("pose", SMALL["n_kf"], 6, JR.retract_pose_cw)
    prob.add_landmarks("pt", SMALL["n_pt"], 3, JR.retract_additive)
    prob.add_landmarks("ln", SMALL["n_ln"], 6, JR.retract_additive)
    delta = float(np.sqrt(JK.CHI2_MONO))
    prob.add_term(JE.Term(
        name="reproj", res_fn=JR.point_reproj_ba_for(JPK), rdim=2,
        dense_refs=[("pose", B["obs_kf"])], lm_ref=("pt", B["obs_pt"]),
        const={"uv": B["obs_uv"]}, mask=mask, info=B["obs_is2"],
        robust_delta=delta))
    prob.add_term(JE.Term(
        name="line", res_fn=JR.make_line_reproj(JPK), rdim=2,
        dense_refs=[("pose", B["lobs_kf"])], lm_ref=("ln", B["lobs_ln"]),
        const={"l": B["lobs_eq"]}, mask=mask_l, info=B["lobs_is2"],
        robust_delta=delta))
    return prob


def test_schur_step_matches_reference(window):
    B = {k: jnp.asarray(v) for k, v in _start(window, True).items()}
    Bt = {k: _t(v) for k, v in _start(window, True).items()}

    @jax.jit
    def jstep(B, lam):
        prob = _jax_problem(B, B["obs_valid"], B["lobs_valid"])
        st = {"pose": B["kf_poses"], "pt": B["pt_xyz"], "ln": B["ln_ep6"]}
        new, cost, _ = prob.solve_step(
            st, lam, {"pose": B["kf_free"]},
            {"pt": B["pt_free"], "ln": B["ln_free"]})
        _, H, _, lm_sys, _, _ = prob.build_normal_equations(st)
        return new, cost, lm_sys["pt"][0]

    lam = 1e-4
    new_j, cost_j, Hpp = jstep(B, jnp.float32(lam))
    prob = TK._ba_problem(
        K_EUROC, SMALL["n_kf"], SMALL["n_pt"], SMALL["n_ln"],
        Bt["obs_kf"].long(), Bt["obs_pt"].long(), Bt["obs_uv"],
        Bt["obs_valid"], Bt["obs_is2"], Bt["lobs_kf"].long(),
        Bt["lobs_ln"].long(), Bt["lobs_eq"], Bt["lobs_valid"],
        Bt["lobs_is2"])
    st = {"pose": Bt["kf_poses"], "pt": Bt["pt_xyz"], "ln": Bt["ln_ep6"]}
    new_t, cost_t, _ = prob.solve_step(
        st, torch.tensor(lam), {"pose": Bt["kf_free"]},
        {"pt": Bt["pt_free"], "ln": Bt["ln_free"]})
    assert abs(float(cost_t) - float(cost_j)) <= 1e-5 * float(cost_j)
    dpose = np.abs(new_t["pose"].numpy() - np.asarray(new_j["pose"])).max()
    assert dpose <= 5e-5, dpose
    ev = np.linalg.eigvalsh(np.asarray(Hpp, np.float64))
    well = ev[:, 0] >= 1e-3 * np.maximum(ev[:, -1], 1e-30)
    assert well.sum() >= 20
    Xj = np.asarray(new_j["pt"])
    rel = np.linalg.norm(new_t["pt"].numpy() - Xj, axis=1) \
        / np.linalg.norm(Xj, axis=1)
    assert rel[well].max() <= 1e-4, rel[well].max()


# -- the whole BA ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lba():
    return JK.make_local_ba_pl(JPK, SMALL["n_kf"], SMALL["n_pt"],
                               SMALL["n_obs"], SMALL["n_ln"],
                               SMALL["n_lobs"])


def _jax_lm_iters(B, rounds=2, iters=8, early_tol=1e-2):
    """LM iterations per round of JK.make_local_ba_pl on B: its loop
    (E.optimize with early_tol, then the chi2 re-gate) replayed step by
    step on the JAX problem's solve_step and cost, since the jitted loop
    does not report its count."""
    B = {k: jnp.asarray(v) for k, v in B.items()}
    free = ({"pose": B["kf_free"]}, {"pt": B["pt_free"], "ln": B["ln_free"]})

    @jax.jit
    def cost(st, mask, mask_l):
        return _jax_problem(B, mask, mask_l).cost(st)

    @jax.jit
    def lm_step(st, lam, mask, mask_l):
        prob = _jax_problem(B, mask, mask_l)
        new, _, _ = prob.solve_step(st, lam, *free)
        return new, prob.cost(new)[0]

    st = {"pose": B["kf_poses"], "pt": B["pt_xyz"], "ln": B["ln_ep6"]}
    mask, mask_l = B["obs_valid"], B["lobs_valid"]
    counts = []
    for _ in range(rounds):
        lam, c, n, done = np.float32(1e-4), np.float32(cost(st, mask,
                                                          mask_l)[0]), 0, False
        while n < iters and not done:
            new, nc = lm_step(st, lam, mask, mask_l)
            nc, n = np.float32(nc), n + 1
            done = abs(nc - c) / max(c, np.float32(1e-20)) < early_tol
            if nc < c:
                st, c, lam = new, nc, np.float32(max(lam * 0.5, 1e-8))
            else:
                lam = np.float32(min(lam * 4.0, 1e4))
        counts.append(n)
        chi2s = cost(st, mask, mask_l)[1]
        mask = B["obs_valid"] & (chi2s["reproj"] < JK.CHI2_MONO)
        mask_l = B["lobs_valid"] & (chi2s["line"] < JK.CHI2_MONO)
    return counts


@pytest.mark.parametrize("perturbed", [False, True])
def test_local_ba_pl_matches_reference(window, jax_lba, perturbed):
    B = _start(window, perturbed)
    oj = [np.asarray(a) for a in jax_lba(*[jnp.asarray(B[k]) for k in KEYS])]
    stats = []
    ot = [a.numpy() for a in TK.make_local_ba_pl(K_EUROC)(
        *[_t(B[k]) for k in KEYS], stats=stats)]
    assert stats == _jax_lm_iters(B) == [3, 1]
    assert np.abs(ot[0] - oj[0]).max() <= 1e-3
    assert (ot[3] == oj[3]).all() and (ot[4] == oj[4]).all()
    ej = _centre_err(oj[0], window["kf_poses"])
    et = _centre_err(ot[0], window["kf_poses"])
    assert abs(et - ej) <= 0.1 * ej, (et, ej)
    if perturbed:
        assert et < 0.5 * _centre_err(B["kf_poses"], window["kf_poses"])


@pytest.mark.parametrize("perturbed", [False, True])
def test_local_ba_pl_float32_within_float64_band(window, perturbed):
    B = _start(window, perturbed)
    lba = TK.make_local_ba_pl(K_EUROC)
    out, stats = {}, {}
    for dt in (torch.float32, torch.float64):
        args = [_t(B[k]).to(dt) if B[k].dtype == np.float32 else _t(B[k])
                for k in KEYS]
        stats[dt] = []
        out[dt] = lba(*args, stats=stats[dt])
    assert stats[torch.float32] == stats[torch.float64] == [3, 1]
    assert out[torch.float64][0].dtype == torch.float64
    gap = float((out[torch.float32][0].double()
                 - out[torch.float64][0]).abs().max())
    assert gap <= 3e-3, gap
    assert torch.equal(out[torch.float32][3], out[torch.float64][3])


# -- the point-only BA (make_local_ba) ----------------------------------------

PT_KEYS = KEYS[:9]


@pytest.fixture(scope="module")
def jax_lba_pt():
    return JK.make_local_ba(JPK, SMALL["n_kf"], SMALL["n_pt"], SMALL["n_obs"])


@pytest.mark.parametrize("perturbed", [False, True])
def test_local_ba_matches_reference(window, jax_lba_pt, perturbed):
    """`make_local_ba` (models/kernels.py:1307), the windowed BA without the
    line family, on the same window's points: KF poses within 1e-3 (a pose
    entry, as the point+line BA above), inlier masks equal, the largest
    camera-centre error within 10% of the reference's, and the LM
    iterations per round those of a step-by-step replay of the JAX loop on
    the point-only problem (CG steps min(max(6 n_kf // 2, 16), 128) on both
    sides)."""
    B = _start(window, perturbed)
    oj = [np.asarray(a) for a in jax_lba_pt(*[jnp.asarray(B[k])
                                              for k in PT_KEYS])]
    stats = []
    ot = [a.numpy() for a in TK.make_local_ba(K_EUROC)(
        *[_t(B[k]) for k in PT_KEYS], stats=stats)]
    assert len(ot) == 3 and ot[1].shape == (SMALL["n_pt"], 3)
    assert np.abs(ot[0] - oj[0]).max() <= 1e-3
    assert (ot[2] == oj[2]).all()
    # the replay's line term masked out leaves the point-only problem
    assert stats == _jax_lm_iters(
        dict(B, lobs_valid=np.zeros_like(B["lobs_valid"])))
    ej = _centre_err(oj[0], window["kf_poses"])
    et = _centre_err(ot[0], window["kf_poses"])
    assert abs(et - ej) <= 0.1 * ej, (et, ej)


# -- the engine's deterministic sums (the card's path, run here) -------------

@pytest.mark.parametrize("shape", ["blocks", "matrix"])
def test_sorted_segment_sums_match_index_put(shape):
    """`engine.accumulate`'s card path (`sorted_sums=True`: one stable
    sort, fixed chunk sums by `segment_sum`) against `index_put_` with
    accumulate on the CPU, in float64 on destinations hit from 0 to ~900
    times (more than SEG_CHUNK^1: two levels): within 1e-12 relative (the
    same sums in another order)."""
    rng = np.random.default_rng(3)
    if shape == "blocks":
        out = torch.zeros(7, 6, 6, dtype=torch.float64)
        idx = (torch.from_numpy(np.concatenate(
            [np.zeros(900, np.int64), rng.integers(1, 6, 300)])),)
        vals = torch.from_numpy(rng.normal(size=(1200, 6, 6)))
    else:
        out = torch.zeros(48, 48, dtype=torch.float64)
        rows = torch.from_numpy(rng.integers(0, 8, (500, 1)) * 6
                                + np.arange(6))
        cols = torch.from_numpy(rng.integers(0, 8, (500, 1)) * 6
                                + np.arange(6))
        idx = (rows[:, :, None], cols[:, None, :])
        vals = torch.from_numpy(rng.normal(size=(500, 6, 6)))
    ref = out.clone().index_put_(idx, vals, accumulate=True)
    got = out.clone()
    TE.accumulate(got, idx, vals, sorted_sums=True)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    untouched = ref == 0
    assert bool((got[untouched] == 0).all())
