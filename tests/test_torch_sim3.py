"""The loop closer's Sim(3) pieces of the PyTorch port against the JAX
package on the CPU: the Sim(3) helpers (utils/lie.py), the essential
graph's edges and their Jacobians (solver/residuals.py), the Sim3 RANSAC
with the reference's samples (ops/pnp.py), the Sim3 reprojection
refinement (models/kernels.py `make_sim3_reproj_optimizer`, on the
fixtures of tests/test_essential_graph_big.py), the Hamming distance
matrix and the pose graph's summation tables.

Tolerances: the Sim(3) functions within 1e-6 near and away from both
Taylor switches (|sigma|, theta = 1e-4); the edges and their Jacobians
within 1e-5 (relative to the largest entry, at least 1), or, where float32
cancellation just above the Taylor switch dominates, within 2x the JAX
value's distance to a float64 run + 1e-5; RANSAC: the best
hypothesis and its count equal, the inlier masks equal but for rows
within 1e-6 (relative) of the gate, and (s, R, t) within 2x the JAX
run's distance to the port's float64 run + 1e-5; the reprojection
refinement to the same rule with its inlier count equal.
"""
import numpy as np
import pytest
import torch
from torch.func import jacrev

import jax
import jax.numpy as jnp

from plvio_tpu.models import kernels as JKN
from plvio_tpu.ops import matching as JM
from plvio_tpu.ops import pnp as JPNP
from plvio_tpu.solver import residuals as JRES
from plvio_tpu.solver.residuals import PinholeK as JPinholeK
from plvio_tpu.utils import lie as JL

from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import matching as M
from plvio_tpu_torch.ops import pnp as PNP
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.solver.residuals import PinholeK
from plvio_tpu_torch.utils import lie

SIGMAS = (0.0, 5e-5, 2e-4, 0.3)
THETAS = (0.0, 5e-5, 2e-4, 1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _xi(rng, sigma, theta):
    axis = rng.normal(0, 1, 3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([rng.normal(0, 1, 3), theta * axis,
                           [sigma]]).astype(np.float32)


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("theta", THETAS)
def test_sim3_functions_against_jax(sigma, theta):
    rng = np.random.default_rng(int(1e6 * (sigma + 3 * theta)))
    xi = _xi(rng, sigma, theta)
    xj, xt = jnp.asarray(xi), _t(xi)
    W_j = np.asarray(JL._sim3_W(xj[3:6], xj[6]))
    W_t = lie._sim3_W(xt[3:6], xt[6]).numpy()
    assert np.abs(W_j - W_t).max() <= 1e-6
    Rj, tj, sj = JL.sim3_exp(xj)
    Rt, tt, st = lie.sim3_exp(xt)
    for a, b in ((Rj, Rt), (tj, tt), (sj, st)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
    # the log of the reference's exp, and the group operations
    lj = np.asarray(JL.sim3_log(Rj, tj, sj))
    lt = lie.sim3_log(_t(np.asarray(Rj)), _t(np.asarray(tj)),
                      torch.tensor(float(sj))).numpy()
    assert np.abs(lj - lt).max() <= 1e-6
    Ri, ti, si = JL.sim3_inv(Rj, tj, sj)
    Rv, tv, sv = lie.sim3_inv(Rt, tt, st)
    for a, b in ((Ri, Rv), (ti, tv), (si, sv)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
    R2, t2, s2 = JL.sim3_mul(Rj, tj, sj, Ri, ti, si)
    Rm, tm, sm = lie.sim3_mul(Rt, tt, st, Rv, tv, sv)
    for a, b in ((R2, Rm), (t2, tm), (s2, sm)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
    p = rng.normal(0, 1, (5, 3)).astype(np.float32)
    assert np.abs(np.asarray(JL.sim3_apply(Rj, tj, sj[None], jnp.asarray(p)))
                  - lie.sim3_apply(Rt, tt, st[None], _t(p)).numpy()
                  ).max() <= 1e-6


def test_se3_helpers_against_jax():
    rng = np.random.default_rng(3)
    for theta in (0.0, 1e-4, 0.7, 3.1):
        xi = _xi(rng, 0.0, theta)[:6]
        R = np.asarray(JL.so3_exp(jnp.asarray(xi[3:])))
        t = xi[:3]
        assert np.abs(np.asarray(JL.se3_log(jnp.asarray(R), jnp.asarray(t)))
                      - lie.se3_log(_t(R), _t(t)).numpy()).max() <= 1e-5
        Ri, ti = JL.se3_inv(jnp.asarray(R), jnp.asarray(t))
        Rp, tp = lie.se3_inv(_t(R), _t(t))
        assert np.abs(np.asarray(ti) - tp.numpy()).max() <= 1e-6
        Rm, tm = JL.se3_mul(Ri, ti, jnp.asarray(R), jnp.asarray(t))
        Rq, tq = lie.se3_mul(Rp, tp, _t(R), _t(t))
        assert np.abs(np.asarray(tm) - tq.numpy()).max() <= 1e-6
        assert np.abs(np.asarray(JL.se3_matrix(jnp.asarray(R), jnp.asarray(t)))
                      - lie.se3_matrix(_t(R), _t(t)).numpy()).max() <= 1e-6
        q = rng.normal(0, 1, 4).astype(np.float32)
        assert np.abs(np.asarray(JL.quat_to_rot(jnp.asarray(q)))
                      - lie.quat_to_rot(_t(q)).numpy()).max() <= 1e-6


def _state(rng):
    R = lie.so3_exp(_t(rng.normal(0, 1, 3).astype(np.float32))).numpy()
    return np.concatenate([R.reshape(-1), rng.normal(0, 1, 3),
                           [np.exp(rng.normal(0, 0.2))]]).astype(np.float32)


@pytest.mark.parametrize("four_dof", [False, True])
@pytest.mark.parametrize("near", [False, True])
def test_sim3_edges_and_jacobians(four_dof, near):
    """Residual and Jacobian at delta = 0: the reference's jacfwd against
    the port's engine's jacrev, on random edges and on near-consistent
    ones (the measurement S_j S_i^-1 within 1e-3 rad: the Taylor
    branches of sim3_log)."""
    rng = np.random.default_rng(7 + 2 * four_dof + near)
    jfn = JRES.sim3_edge_4dof if four_dof else JRES.sim3_edge
    tfn = RES.sim3_edge_4dof if four_dof else RES.sim3_edge
    worst = -1.0
    for _ in range(6):
        Si, Sj = _state(rng), _state(rng)
        if near:
            Ri, ti, si = JL.sim3_inv(jnp.asarray(Si[:9].reshape(3, 3)),
                                     jnp.asarray(Si[9:12]),
                                     jnp.asarray(Si[12]))
            R, t, s = JL.sim3_mul(jnp.asarray(Sj[:9].reshape(3, 3)),
                                  jnp.asarray(Sj[9:12]), jnp.asarray(Sj[12]),
                                  Ri, ti, si)
            R = R @ JL.so3_exp(jnp.asarray(rng.normal(0, 1e-3, 3),
                                           jnp.float32))
            meas = (np.asarray(R), np.asarray(t), float(s))
        else:
            S = _state(rng)
            meas = (S[:9].reshape(3, 3), S[9:12], float(S[12]))
        cj = {"Rji": jnp.asarray(meas[0]), "tji": jnp.asarray(meas[1]),
              "sji": jnp.float32(meas[2])}
        ct = {"Rji": _t(np.asarray(meas[0])), "tji": _t(np.asarray(meas[1])),
              "sji": torch.tensor(meas[2], dtype=torch.float32)}

        def fj(d):
            return jfn((jnp.asarray(Si), jnp.asarray(Sj)), (d[:7], d[7:]), cj)

        def ft(d):
            return tfn((_t(Si), _t(Sj)), (d[:7], d[7:]), ct)
        z = np.zeros(14, np.float32)
        rj, Jj = np.asarray(fj(jnp.asarray(z))), \
            np.asarray(jax.jacfwd(fj)(jnp.asarray(z)))
        rt, Jt = ft(_t(z)).numpy(), jacrev(ft)(_t(z)).numpy()
        c64 = {k: v.double() for k, v in ct.items()}

        def f64(d):
            return tfn((_t(Si).double(), _t(Sj).double()), (d[:7], d[7:]),
                       c64)
        z64 = torch.zeros(14, dtype=torch.float64)
        r64, J64 = f64(z64).numpy(), jacrev(f64)(z64).numpy()
        for a, b, ref in ((rj, rt, r64), (Jj, Jt, J64)):
            scale = max(1.0, float(np.abs(a).max()))
            gap = float(np.abs(a - b).max()) / scale
            # float32 cancellation near the Taylor switches: then the port
            # is held to 2x the reference's distance to float64
            rule = 2 * float(np.abs(a - ref).max()) / scale + 1e-5
            worst = max(worst, gap - max(1e-5, rule))
    assert worst <= 0.0, worst


class JaxSim3Samples:
    """The reference's Sim3 RANSAC draws: its key split once per
    verification, 64 keys, three rows without replacement weighted by
    valid (ops/pnp.py:171-176)."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed + 7)

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    @staticmethod
    def draw(sub, valid, iters: int = 64):
        p = jnp.asarray(valid, jnp.float32)
        p = p / jnp.maximum(p.sum(), 1.0)
        keys = jax.random.split(sub, iters)
        return np.asarray(jax.vmap(lambda k: jax.random.choice(
            k, len(valid), shape=(3,), replace=False, p=p))(keys))

    def __call__(self, valid):
        return self.draw(self.next_key(), np.asarray(valid))


def _ransac_case(rng, n=256, n_valid=200, n_out=60, scale=1.2):
    X1 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    R = lie.so3_exp(_t(np.array([0.1, 0.2, -0.3], np.float32))).numpy()
    X2 = (scale * X1 @ R.T + np.array([0.3, 0.1, -0.2])).astype(np.float32)
    X2 += rng.normal(0, 0.01, X2.shape).astype(np.float32)
    X2[:n_out] += rng.normal(0, 0.5, (n_out, 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    X1[n_valid:] = 0
    X2[n_valid:] = 0
    return X1, X2, valid


def _pose_gap(a, b):
    return max(abs(float(a[0]) - float(b[0])),
               float(np.abs(np.asarray(a[1], np.float64) - b[1]).max()),
               float(np.abs(np.asarray(a[2], np.float64) - b[2]).max()))


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("case", ["outliers", "few"])
def test_sim3_ransac_with_jax_samples(fix_scale, case):
    rng = np.random.default_rng(11 + fix_scale)
    X1, X2, valid = _ransac_case(rng, **({} if case == "outliers"
                                         else dict(n_valid=24, n_out=8)))
    sub = jax.random.PRNGKey(5)
    samples = JaxSim3Samples.draw(sub, valid)
    sj, Rj, tj, inl_j, nj = JPNP.sim3_ransac(
        jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), sub, th=0.08,
        fix_scale=fix_scale)
    args = [_t(X1), _t(X2), _t(valid), _t(samples)]
    p32 = PNP.sim3_ransac_plain(*args, th=0.08, fix_scale=fix_scale)
    p64 = PNP.sim3_ransac_plain(args[0].double(), args[1].double(), *args[2:],
                                th=0.08, fix_scale=fix_scale)
    # the reference's counts, as its sim3_ransac forms them
    Xj1, Xj2 = jnp.asarray(X1), jnp.asarray(X2)
    ref_scale = jnp.sqrt(jnp.maximum(jnp.sum((Xj2 - Xj2.mean(0)) ** 2, -1),
                                     1e-9)).mean()
    hyp = jax.vmap(lambda idx: JPNP.sim3_horn(Xj1[idx], Xj2[idx],
                                              fix_scale))(
        jnp.asarray(samples))

    def score(s_, R_, t_):
        d_ = jnp.linalg.norm(s_ * (Xj1 @ R_.T) + t_ - Xj2, axis=-1)
        return jnp.sum(jnp.asarray(valid) & (d_ < 0.08 * ref_scale)
                       & (s_ > 0.1) & (s_ < 10.0))
    counts_j = np.asarray(jax.vmap(score)(*hyp))
    best_j = int(np.argmax(counts_j))
    assert int(p32.best) == best_j == int(p64.best)
    assert int(p32.n) == int(nj) == int(p64.n)
    # masks: equal but for rows within 1e-6 (relative) of the gate
    X1d, X2d = X1.astype(np.float64), X2.astype(np.float64)
    scale_ref = np.sqrt(np.maximum(((X2d - X2d.mean(0)) ** 2).sum(-1),
                                   1e-9)).mean()
    hs, hR, ht = PNP.sim3_horn(_t(X1d[samples[int(p64.best)]]),
                               _t(X2d[samples[int(p64.best)]]), fix_scale)
    d = np.linalg.norm(float(hs) * X1d @ hR.numpy().T + ht.numpy() - X2d,
                       axis=1)
    near = np.abs(d - 0.08 * scale_ref) <= 1e-6 * 0.08 * scale_ref
    diff = np.asarray(inl_j) != p32.inliers.numpy()
    assert not (diff & ~near).any()
    ref = (p64.s.item(), p64.R.numpy(), p64.t.numpy())
    gap_j = _pose_gap((sj, Rj, tj), ref)
    gap_t = _pose_gap((p32.s, p32.R.numpy(), p32.t.numpy()), ref)
    assert gap_t <= 2 * gap_j + 1e-5, (gap_t, gap_j)


def _reproj_fixture(rng, fixture):
    """tests/test_essential_graph_big.py:114 ("converges") and :159
    ("fix_scale"), drawn from default_rng(0) in their order."""
    K = (400., 400., 376., 240.)
    lie_exp = lambda v: np.asarray(JL.so3_exp(jnp.asarray(v, jnp.float32)))
    if fixture == "converges":
        cap, s_gt = 256, 1.1
        Rg = lie_exp([0.02, -0.03, 0.2])
        tg = np.array([0.5, -0.3, 0.2])
        P1 = np.eye(3, 4, dtype=np.float32)
        R2 = lie_exp([0., 0.25, 0.])
        P2 = np.concatenate([R2, np.array([[0.1], [0.], [0.3]], np.float32)],
                            1)
    else:
        cap, s_gt = 128, 1.0
        Rg = lie_exp([0.0, 0.0, 0.15])
        tg = np.array([0.3, -0.2, 0.1])
        P1 = np.eye(3, 4, dtype=np.float32)
        P2 = np.eye(3, 4, dtype=np.float32)
    X1 = rng.uniform(-2, 2, (cap, 3))
    X1[:, 2] = rng.uniform(3, 7, cap)
    X2 = s_gt * X1 @ Rg.T + tg

    def proj(P, X):
        pc = X @ P[:, :3].T + P[:, 3]
        return np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2],
                         K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    if fixture == "converges":
        uv2 = proj(P2, X2) + rng.normal(0, 0.3, (cap, 2))
        uv1 = proj(P1, X1) + rng.normal(0, 0.3, (cap, 2))
        R0 = lie_exp([0.01, 0.01, 0.25])
        S13 = np.concatenate([R0.reshape(-1), tg + [0.1, -0.1, 0.05],
                              [1.0]]).astype(np.float32)
    else:
        uv2, uv1 = proj(P2, X2), proj(P1, X1)
        S13 = np.concatenate([np.eye(3).reshape(-1), [0.2, -0.1, 0.0],
                              [1.0]]).astype(np.float32)
    ones = np.ones(cap, np.float32)
    valid = np.ones(cap, bool)
    return K, cap, [S13, X1.astype(np.float32), uv2.astype(np.float32),
                    valid, ones, X2.astype(np.float32),
                    uv1.astype(np.float32), valid, ones, P1, P2]


@pytest.mark.parametrize("fixture", ["converges", "fix_scale"])
def test_sim3_reproj_against_jax(fixture):
    K, cap, args = _reproj_fixture(np.random.default_rng(0), fixture)
    fix = fixture == "fix_scale"
    jo = JKN.make_sim3_reproj_optimizer(JPinholeK(*K), cap, fix_scale=fix)(
        *[jnp.asarray(a) for a in args])
    ts = [_t(a) for a in args]
    p32 = KN.sim3_reproj_plain(PinholeK(*K), *ts, fix_scale=fix)
    p64 = KN.sim3_reproj_plain(PinholeK(*K), *[
        t.double() if t.dtype == torch.float32 else t for t in ts],
        fix_scale=fix)
    assert int(p32[3]) == int(jo[3]) == int(p64[3])
    assert torch.equal(p32[1], torch.from_numpy(np.array(jo[1])))
    gap_j = float(np.abs(np.asarray(jo[0], np.float64) - p64[0].numpy()).max())
    gap_t = float((p32[0].double() - p64[0]).abs().max())
    assert gap_t <= 2 * gap_j + 1e-5, (gap_t, gap_j)
    if fix:
        assert abs(float(p32[0][12]) - 1.0) < 1e-5


def test_hamming_dist_plain_against_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (30, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(JM.hamming_matrix(
        JM.unpack_u32_to_pm1(jnp.asarray(a)),
        JM.unpack_u32_to_pm1(jnp.asarray(b))), np.float32)
    got = M.hamming_dist_plain(_t(a.view(np.int32)), _t(b.view(np.int32)))
    assert np.array_equal(ref, got.numpy())


def test_graph_tables_order():
    """Each keyframe's incident edges and each pair's edges in edge order,
    with the side / flip bits the kernel reads."""
    ei = np.array([1, 2, 0, 2, 1], np.int32)
    ej = np.array([0, 1, 2, 0, 0], np.int32)
    inc_ptr, inc, pair_ab, pair_ptr, pair_list = KN.graph_tables(ei, ej, 3)
    assert inc_ptr.tolist() == [0, 4, 7, 10]
    assert inc.tolist() == [1, 4, 7, 9, 0, 3, 8, 2, 5, 6]
    assert pair_ab.tolist() == [[0, 1], [0, 2], [1, 2]]
    assert pair_ptr.tolist() == [0, 2, 4, 5]
    assert pair_list.tolist() == [1, 9, 4, 7, 3]
