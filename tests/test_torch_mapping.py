"""The mapping step's matching and triangulation against the JAX package
(CPU): `triangulate_dlt`, `make_triangulator`, `rotation_histogram_filter`
and `make_epipolar_matcher` on bench.build_mapping_step's window at a small
size (4 KF, 256 points, 128 features), seeded with numpy.

Tolerances: triangulated points within 1e-4 relative (both sides take a
float32 SVD; LAPACK's and torch's differ in the last bits), `good` masks
equal; matches (idx, ok) and histogram masks identical: the gates
are float32 comparisons of the same arithmetic, and pairs within 1e-4 of
the epipolar threshold are not drawn by these inputs (checked below)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from plvio_tpu.models import kernels as JK
from plvio_tpu.ops import matching as JM
from plvio_tpu.ops import twoview as JTV
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu.utils import lie as JL
from plvio_tpu_torch.entry import K_EUROC
from plvio_tpu_torch.models import kernels as TK
from plvio_tpu_torch.ops import matching as TM
from plvio_tpu_torch.ops import twoview as TTV

SMALL = dict(n_kf=4, n_pt=256, n_obs=512, n_feat=128, n_ln=32, n_lobs=64)
JK_ = JPin(*K_EUROC)


@pytest.fixture(scope="module")
def window():
    _, A = bench.build_mapping_step(**SMALL)
    return {k: np.asarray(v) for k, v in A.items()}


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_dlt_matches_reference(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, 3)
    R = np.asarray(JL.so3_exp(jnp.asarray(w, jnp.float32)))
    t = np.array([-0.3, 0.05, 0.02], np.float32) + rng.normal(0, 0.01, 3)
    t = t.astype(np.float32)
    X = rng.uniform([-3, -2, 2], [3, 2, 9], (200, 3))
    x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    X2 = X @ R.T + t
    x2 = (X2[:, :2] / X2[:, 2:] + rng.normal(0, 1e-3, (200, 2))).astype(
        np.float32)
    Xj = np.asarray(jax.jit(JTV.triangulate_dlt)(R, t, x1, x2))
    Xt = TTV.triangulate_dlt(_t(R), _t(t), _t(x1), _t(x2)).numpy()
    rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert rel.max() <= 1e-4, rel.max()


def test_triangulator_matches_reference(window):
    A = window
    n = SMALL["n_feat"]
    rng = np.random.default_rng(3)
    # matched pairs with pixel noise, some swapped partners (outliers)
    # and every other pair at octave 1 or 2
    idx = np.arange(n)
    idx[:20] = rng.permutation(20)
    uv2 = (A["uv_b"][idx] + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    valid = rng.random(n) < 0.9
    oct1 = rng.integers(0, 3, n).astype(np.int32)
    oct2 = rng.integers(0, 3, n).astype(np.int32)
    for octs in ((None, None), (oct1, oct2)):
        jo = [None if o is None else jnp.asarray(o) for o in octs]
        to = [None if o is None else _t(o) for o in octs]
        Xj, gj = JK.make_triangulator(JK_, n)(
            A["pose_a"], A["pose_b"], A["uv_a"], uv2, valid, oct1=jo[0],
            oct2=jo[1])
        Xt, gt = TK.make_triangulator(K_EUROC)(
            _t(A["pose_a"]), _t(A["pose_b"]), _t(A["uv_a"]), _t(uv2),
            _t(valid), oct1=to[0], oct2=to[1])
        Xj, gj, Xt, gt = np.asarray(Xj), np.asarray(gj), Xt.numpy(), gt.numpy()
        assert 40 <= gj.sum() < valid.sum()
        assert (gj == gt).all(), (gj != gt).sum()
        both = gj & gt
        rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
        assert rel[both].max() <= 1e-4, rel[both].max()


def test_rotation_histogram_matches_reference():
    rng = np.random.default_rng(5)
    n = 300
    ident = np.arange(n, dtype=np.int32)
    cases = []
    # ordinary angles in degrees, random matches
    a2 = rng.uniform(0, 360, n).astype(np.float32)
    cases.append((rng.uniform(0, 360, n).astype(np.float32), a2,
                  rng.integers(0, n, n).astype(np.int32)))
    # tied bins: 4 bins with 40 matches each, the rest spread thinly, so
    # that the third place is a tie that lax.top_k gives the lower bin
    rot = np.concatenate([np.repeat([18.0, 78.0, 138.0, 270.0], 40),
                          rng.uniform(0, 360, n - 160)]).astype(np.float32)
    cases.append((((a2 + rot) % 360.0).astype(np.float32), a2, ident))
    # radians fed to the degree filter, as the mapping benchmark does: the
    # differences fall in bins 0 and 29 only, and every match stays
    cases.append((rng.uniform(0, 2 * np.pi, n).astype(np.float32),
                  rng.uniform(0, 2 * np.pi, n).astype(np.float32), ident))
    for i, (a1, a2, idx) in enumerate(cases):
        ok = np.ones(n, bool) if idx is ident else rng.random(n) < 0.8
        okj = np.asarray(jax.jit(JM.rotation_histogram_filter)(
            a1, a2, idx, ok))
        okt = TM.rotation_histogram_filter(_t(a1), _t(a2), _t(idx),
                                           _t(ok)).numpy()
        assert (okj == okt).all(), (okj != okt).sum()
        assert 0 < okt.sum() < ok.sum() if i < 2 else okt.all()


@pytest.mark.parametrize("with_oct", [False, True])
def test_epipolar_matcher_matches_reference(window, with_oct):
    A = window
    n = SMALL["n_feat"]
    rng = np.random.default_rng(6)
    # pixel noise so that the gate decides, and the second KF's
    # descriptors with a few flipped bits so that ratios and ties vary
    uv1 = (A["uv_a"] + rng.normal(0, 1.0, (n, 2))).astype(np.float32)
    d2 = A["desc"] ^ (rng.random((n, 8)) < 0.02).astype(np.uint32) \
        << rng.integers(0, 32, (n, 8)).astype(np.uint32)
    oct2 = rng.integers(0, 4, n).astype(np.int32) if with_oct else None
    ok1 = rng.random(n) < 0.95
    args = (A["pose_a"], A["pose_b"], uv1, A["desc"], ok1, A["uv_b"], d2,
            A["ok"], A["ang"], A["ang"])
    ij, okj = JK.make_epipolar_matcher(JK_, n)(
        *[jnp.asarray(a) for a in args],
        oct2=None if oct2 is None else jnp.asarray(oct2))
    it, okt = TK.make_epipolar_matcher(K_EUROC)(
        *[_t(a) for a in args], oct2=None if oct2 is None else _t(oct2))
    ij, okj = np.asarray(ij), np.asarray(okj)
    assert 20 <= okj.sum() < n
    assert (okj == okt.numpy()).all(), (okj != okt.numpy()).sum()
    assert (ij[okj] == it.numpy()[okj]).all()
    # no pair sits within 1e-4 px of the gate, where float rounding of
    # the two frameworks could decide it either way
    F = TK.fundamental(K_EUROC, _t(A["pose_a"]), _t(A["pose_b"])).double()
    x1 = torch.cat([_t(uv1).double(), torch.ones(n, 1, dtype=torch.float64)],
                   1)
    x2 = torch.cat([_t(A["uv_b"]).double(),
                    torch.ones(n, 1, dtype=torch.float64)], 1)
    lines = x1 @ F.T
    d = (lines @ x2.T).abs() / lines[:, :2].norm(dim=1, keepdim=True)
    th = 2.0 * (1.2 ** (torch.from_numpy(oct2).double() if with_oct
                        else torch.zeros(n, dtype=torch.float64)))
    assert float((d - th[None, :]).abs().min()) > 1e-4
