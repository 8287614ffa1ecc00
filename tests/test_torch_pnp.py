"""Slice 9, PnP for relocalization, against the JAX package on the CPU.

`ops/pnp.py`'s `pnp_ransac` and `mlpnp_refine` (plain, float32) against
plvio_tpu/ops/pnp.py on the two cases of `inputs.build_pnp_case`: that
of tests/test_place_recognition.py:65-87 (200 matches, 25% outliers; the
refinement from a start ~3 deg and ~15 cm off, as :131-) and 512 matches
from a rendered map (the MH replay's hall seen from its trajectory at 5
s, 1 px noise, 20% outliers, 400 valid rows as the tracker pads them).
The port is given JAX's RANSAC samples: the reference's
`jax.random.choice(key, N, (6,), replace=False, p=valid / sum)` per
hypothesis, replayed here.

Tolerances, and why (the DLT solves on raw world coordinates and is
ill-conditioned, so float32 SVDs lie far from its float64 solution and
from each other):
- the best hypothesis index equal (its loose count is a count: only a row
  within float32 noise of the 4 chi2 gate can flip it); every
  hypothesis' loose count within one row of JAX's, on all but 2% of them
  (minimal six-point solutions are noise-dominated in float32);
- inlier masks equal, but for 1% of the rows, each within 1e-3 px^2 of
  the chi2 gate under the float64 run's pose;
- R and t within 2x JAX's largest pose-entry distance to a float64 run
  of the port's plain version on the same samples, plus FLOOR (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.ops import pnp as JP
from plvio_tpu.solver.residuals import PinholeK as JK
from plvio_tpu.utils import lie as JL
from plvio_tpu_torch.inputs import build_pnp_case
from plvio_tpu_torch.ops import pnp as P
from plvio_tpu_torch.solver.residuals import PinholeK

K = PinholeK(fx=458.654, fy=457.296, cx=367.215, cy=248.375)
JKK = JK(*K)
FLOOR, GATE_PX2, FLIPS = P.FLOOR, P.GATE_PX2, P.FLIPS
CHI2 = 5.991


def jax_samples(key, valid, iters=128):
    """The reference's RANSAC draws (ops/pnp.py:59-63)."""
    p = valid.astype(np.float32)
    p = p / max(p.sum(), 1.0)
    keys = jax.random.split(key, iters)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, len(valid), shape=(6,), replace=False, p=jnp.asarray(p)))(keys))


def jax_best(uv, X, valid, samples):
    """The reference's best hypothesis (pnp.py:65-93), recomputed."""
    xn = jnp.stack([(uv[:, 0] - K.cx) / K.fx, (uv[:, 1] - K.cy) / K.fy], -1)
    Rs, ts = jax.vmap(lambda i: JP._dlt_pose(xn[i], jnp.asarray(X)[i]))(
        jnp.asarray(samples))
    pc = jnp.einsum("nj,hij->hni", jnp.asarray(X), Rs) + ts[:, None]
    z = jnp.maximum(pc[..., 2], 1e-6)
    pred = jnp.stack([K.fx * pc[..., 0] / z + K.cx,
                      K.fy * pc[..., 1] / z + K.cy], -1)
    chi2 = ((pred - uv) ** 2).sum(-1)
    cnt = (valid & (chi2 < 4 * CHI2) & (pc[..., 2] > 0.05)).sum(-1)
    return int(jnp.argmax(cnt)), np.asarray(cnt)


def case(name):
    """`inputs.build_pnp_case`: (uv [N,2], X [N,3] float32, valid [N], R,
    t, the outlier rows (those the truth puts beyond 8 px))."""
    uv, X, valid, T = build_pnp_case(name)
    R, t = T[:, :3], T[:, 3]
    pc = X @ R.T + t
    z = np.maximum(pc[:, 2], 1e-6)
    pred = np.stack([K.fx * pc[:, 0] / z + K.cx,
                     K.fy * pc[:, 1] / z + K.cy], -1)
    bad = np.nonzero(valid & (((pred - uv) ** 2).sum(-1) > 64.0))[0]
    return uv, X, valid, R, t, bad


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _pose_gap(R, t, R64, t64):
    P32 = np.concatenate([np.asarray(R, np.float64),
                          np.asarray(t, np.float64)[:, None]], 1)
    P64 = np.concatenate([R64.numpy(), t64.numpy()[:, None]], 1)
    return float(np.abs(P32 - P64).max())


def _masks_agree(m_port, m_jax, chi2_64):
    diff = np.nonzero(np.asarray(m_port) != np.asarray(m_jax))[0]
    assert len(diff) <= FLIPS * len(m_port), diff
    assert (np.abs(chi2_64[diff] - CHI2) < GATE_PX2).all(), chi2_64[diff]


@pytest.mark.parametrize("name", ["place", "rendered"])
def test_pnp_ransac_equals_jax(name):
    uv, X, valid, R_true, t_true, bad = case(name)
    key = jax.random.PRNGKey(0)
    samples = jax_samples(key, valid)
    # the JAX function under jax.jit (eagerly it takes ~7 s a call)
    Rj, tj, inlj, nj = jax.jit(JP.pnp_ransac)(
        JKK, jnp.asarray(uv), jnp.asarray(X), jnp.asarray(valid), key)
    best_j, counts_j = jax_best(uv, X, valid, samples)
    tu, tX, tv, ts = _t(uv, X, valid, samples)
    res = P.pnp_ransac(K, tu, tX, tv, ts)
    ref = P.pnp_ransac_plain(K, tu.double(), tX.double(), tv, ts)
    assert int(res.best) == best_j == int(ref.best)
    # a minimal six-point DLT is noise-dominated in float32: a hypothesis'
    # loose count may differ by one row
    dc = np.abs(res.counts.numpy() - counts_j)
    assert dc.max() <= 1 and (dc > 0).mean() <= 0.02, dc
    chi2_64, _ = P._chi2(K, tu.double(), tX.double(), ref.R, ref.t)
    _masks_agree(res.inliers.numpy(), np.asarray(inlj), chi2_64.numpy())
    assert abs(int(res.n) - int(nj)) <= FLIPS * len(uv)
    gap_p = _pose_gap(res.R, res.t, ref.R, ref.t)
    gap_j = _pose_gap(Rj, tj, ref.R, ref.t)
    print(f"{name}: pose gap to float64 port {gap_p:.2e} JAX {gap_j:.2e}")
    assert gap_p <= 2 * gap_j + FLOOR, (gap_p, gap_j)
    if name != "place":
        return
    # and the solve is right: the outliers out, the pose near the truth
    assert not res.inliers.numpy()[bad].any()
    assert int(res.n) >= 0.9 * (int(valid.sum()) - len(bad))
    assert np.abs(res.R.numpy() - R_true).max() < 0.01
    assert np.abs(res.t.numpy() - t_true).max() < 0.05


@pytest.mark.parametrize("name", ["place", "rendered"])
def test_mlpnp_refine_equals_jax(name):
    """From one float32 start (tests/test_place_recognition.py:131-: ~3
    deg and ~15 cm off the truth), the refined pose and its strict mask."""
    uv, X, valid, R_true, t_true, bad = case(name)
    inliers = valid.copy()
    inliers[bad] = False
    dw = np.array([0.03, -0.03, 0.02])
    R0 = (np.asarray(JL.so3_exp(jnp.asarray(dw, jnp.float32)))
          @ R_true).astype(np.float32)
    t0 = (t_true + np.array([0.1, -0.05, 0.1])).astype(np.float32)
    Rj, tj, inlj, nj = JP.mlpnp_refine(
        JKK, jnp.asarray(uv), jnp.asarray(X), jnp.asarray(inliers),
        jnp.asarray(R0), jnp.asarray(t0))
    tu, tX, ti, tR, tt = _t(uv, X, inliers, R0, t0)
    R, t, inl, n = P.mlpnp_refine(K, tu, tX, ti, tR, tt)
    R64, t64, inl64, _ = P.mlpnp_refine_plain(K, tu.double(), tX.double(),
                                              ti, tR.double(), tt.double())
    chi2_64, _ = P._chi2(K, tu.double(), tX.double(), R64, t64)
    _masks_agree(inl.numpy(), np.asarray(inlj), chi2_64.numpy())
    gap_p = _pose_gap(R, t, R64, t64)
    gap_j = _pose_gap(Rj, tj, R64, t64)
    print(f"{name}: pose gap to float64 port {gap_p:.2e} JAX {gap_j:.2e}")
    assert gap_p <= 2 * gap_j + FLOOR, (gap_p, gap_j)
    assert abs(int(n) - int(nj)) <= FLIPS * len(uv)
    assert np.abs(R.numpy() - R_true).max() < 5e-3
    assert np.abs(t.numpy() - t_true).max() < 0.02


def test_sampler_draws_valid_rows():
    """The tracker's own draws (`twoview.sample_indices` on its
    generator): six distinct valid rows a hypothesis."""
    from plvio_tpu_torch.ops.twoview import sample_indices
    valid = torch.zeros(512, dtype=torch.bool)
    valid[:40] = True
    s = sample_indices(valid, 128, 6, torch.Generator().manual_seed(0))
    assert s.shape == (128, 6) and int(s.max()) < 40
    assert all(len(set(r.tolist())) == 6 for r in s)
