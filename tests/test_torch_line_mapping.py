"""The keyframe line pair matcher and line triangulator against the JAX
package (CPU): `make_line_pair_matcher` (models/kernels.py:605) on the
256 x 256 line features of `inputs.build_keyframe_map`'s new keyframe and
its neighbours, `line_pair_gate` against the reference's dense gate, and
`make_line_triangulator` (:389) on the matched pairs and on the cases of
tests/test_lines.py:83-142 (exact, noisy, zero-baseline, mismatched).

Tolerances, and why:
- matches, gates and good masks exactly equal (the gates' float32
  expressions in the reference's order);
- endpoints of good pairs: as close to a float64 run of the same formulas
  as the reference's float32 ones are, within 2x + 1e-6 m, and within
  5e-5 of their magnitude of the reference's: each endpoint is a
  ray-plane intersection whose planes meet at ~1 deg, so float32
  rounding grows ~100x, and XLA contracts multiply-adds where the port
  does not.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from plvio_tpu.models import kernels as JK
from plvio_tpu.solver.residuals import PinholeK as JPinholeK
from plvio_tpu_torch.entry import K_EUROC as K
from plvio_tpu_torch.inputs import build_keyframe_map
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import matching as M
from plvio_tpu_torch.state import mapstore_from_numpy

JPK = JPinholeK(*K)


def _angles(ep):
    return (np.arctan2(ep[:, 3] - ep[:, 1], ep[:, 2] - ep[:, 0])
            % np.pi).astype(np.float32)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def kmap():
    arrays, truth = build_keyframe_map(False)
    return mapstore_from_numpy(arrays), truth


def _pair_args(m, nb, kf):
    """The line pair matcher's arguments for neighbour nb and keyframe kf,
    as create_new_lines forms them (every line free)."""
    return [m.kf_line_ep[nb], m.kf_line_desc[nb], _angles(m.kf_line_ep[nb]),
            m.kf_line_valid[nb], m.kf_line_ep[kf], m.kf_line_desc[kf],
            _angles(m.kf_line_ep[kf]), m.kf_line_valid[kf]]


@pytest.fixture(scope="module")
def jax_pair():
    return JK.make_line_pair_matcher(256)


def _changed(ref, idx, ok):
    ri, rok = ref
    return int(((ok != rok) | (ok & rok & (idx != ri))).sum())


def test_line_pair_matcher_matches_reference(kmap, jax_pair):
    """256 x 256 segments of the new keyframe against each of its 10
    neighbours: idx and ok equal; every gate decides some rows (the plain
    match changes when that gate alone is left out)."""
    m, truth = kmap
    kf = truth["new_kf"]
    run = KN.make_line_pair_matcher()
    effects = dict.fromkeys(("midpoint", "angle", "length ratio", "40 px"),
                            0)
    n_ok = []
    for nb in m.covisible_kfs(kf, n=10, min_weight=5):
        args = _pair_args(m, nb, kf)
        ij, okj = (np.asarray(a) for a in jax_pair(
            *[jnp.asarray(a) for a in args]))
        it, okt = run(*[_t(a) for a in args])
        np.testing.assert_array_equal(okt.numpy(), okj)
        np.testing.assert_array_equal(it.numpy()[okj], ij[okj])
        n_ok.append(int(okj.sum()))
        ep1, d1, a1, o1, ep2, d2, a2, o2 = [_t(a) for a in args]
        mid1, l1 = M._seg_mid_len(ep1)
        mid2, l2 = M._seg_mid_len(ep2)
        dang = torch.remainder((a1[:, None] - a2[None]).abs(), torch.pi)
        dang = torch.minimum(dang, torch.pi - dang)
        lr = l1[:, None] / l2[None].clamp_min(1e-6)
        gates = {"midpoint": ((mid1[:, None] - mid2[None]) ** 2).sum(-1)
                 < 6400.0,
                 "angle": dang < 0.25,
                 "length ratio": (lr > 0.5) & (lr < 2.0),
                 "40 px": (l1[:, None] > 40.0) & (l2[None] > 40.0)}
        dist = M.hamming_matrix(M.unpack_u32_to_pm1(d1),
                                M.unpack_u32_to_pm1(d2))
        for k in gates:
            g = torch.ones_like(gates[k])
            for k2, g2 in gates.items():
                if k2 != k:
                    g = g & g2
            effects[k] += _changed((it, okt), *M.match_nn_ratio(
                dist, o1, o2, g, 110.0, 0.95))
    assert n_ok[0] >= 100
    assert min(effects.values()) > 0, effects


def test_line_pair_gate_matches_dense_reference(kmap):
    """`line_pair_gate` against the reference's dense gate expressions
    (models/kernels.py:618-631) on the new keyframe and its best
    neighbour."""
    m, truth = kmap
    kf = truth["new_kf"]
    nb = m.covisible_kfs(kf, n=1, min_weight=5)[0]
    ep1, _, a1, _, ep2, _, a2, _ = _pair_args(m, nb, kf)
    e1, e2 = jnp.asarray(ep1), jnp.asarray(ep2)
    mid1 = (e1[:, :2] + e1[:, 2:]) / 2
    mid2 = (e2[:, :2] + e2[:, 2:]) / 2
    d2m = jnp.sum((mid1[:, None] - mid2[None, :]) ** 2, -1)
    dang = jnp.abs(jnp.asarray(a1)[:, None] - jnp.asarray(a2)[None, :]) \
        % jnp.pi
    dang = jnp.minimum(dang, jnp.pi - dang)
    len1 = jnp.linalg.norm(e1[:, 2:] - e1[:, :2], axis=-1)
    len2 = jnp.linalg.norm(e2[:, 2:] - e2[:, :2], axis=-1)
    lr = len1[:, None] / jnp.maximum(len2[None, :], 1e-6)
    ref = (d2m < 80.0 ** 2) & (dang < 0.25) & (lr > 0.5) & (lr < 2.0) \
        & (len1[:, None] > 40.0) & (len2[None, :] > 40.0)
    got = M.line_pair_gate(_t(ep1), _t(a1), _t(ep2), _t(a2), 80.0, 0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < got.numel()


def _float64_gap(args, out):
    """Largest endpoint distance (m) of the good rows of `out` to the
    plain formulas run in float64."""
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    Xs, Xe, _ = KN.line_triangulate_plain(K, *a64)
    good = out[2].numpy() if torch.is_tensor(out[2]) else np.asarray(out[2])
    g = []
    for X, X64 in ((out[0], Xs), (out[1], Xe)):
        X = np.asarray(X, np.float64)
        g.append(np.linalg.norm(X - X64.numpy(), axis=1)[good])
    return float(np.concatenate(g).max())


def test_line_triangulator_matches_reference(kmap, jax_pair):
    """The pairs the matcher finds between the new keyframe and its best
    neighbour: good equal, endpoints within the float32 band."""
    m, truth = kmap
    kf = truth["new_kf"]
    nb = m.covisible_kfs(kf, n=1, min_weight=5)[0]
    args = _pair_args(m, nb, kf)
    idx, ok = (np.asarray(a) for a in jax_pair(
        *[jnp.asarray(a) for a in args]))
    targs = [m.kf_pose_cw[nb], m.kf_pose_cw[kf], m.kf_line_ep[nb],
             m.kf_line_ep[kf][idx], ok]
    oj = [np.asarray(a) for a in JK.make_line_triangulator(JPK, 256)(
        *[jnp.asarray(a) for a in targs])]
    tt = [_t(a) for a in targs]
    ot = KN.make_line_triangulator(K)(*tt)
    np.testing.assert_array_equal(ot[2].numpy(), oj[2])
    good = oj[2]
    assert 50 <= good.sum() < ok.sum()
    for a, b in ((ot[0], oj[0]), (ot[1], oj[1])):
        gap = np.linalg.norm(a.numpy()[good] - b[good], axis=1)
        assert (gap <= 5e-5 * np.linalg.norm(b[good], axis=1)).all()
    gt, gj = _float64_gap(tt, ot), _float64_gap(tt, oj)
    assert gt <= 2 * gj + 1e-6, (gt, gj)


def _two_view_case():
    """tests/test_lines.py:83-112: eight segments seen from two views 0.3 m
    apart."""
    Kt = JPinholeK(fx=458.0, fy=457.0, cx=367.0, cy=248.0)
    Xs = np.array([[0.3, 0.2, 1.5], [-0.5, 0.1, 2.0],
                   [0.0, -0.3, 1.2], [0.4, 0.4, 3.0]] * 2, np.float32)
    Xe = Xs + np.array([[0.5, 0.1, 0.2], [0.0, 0.6, 0.1],
                        [0.4, 0.0, 0.3], [0.2, 0.5, 0.0]] * 2, np.float32)
    t1 = np.zeros(3, np.float32)
    t2 = np.array([-0.3, 0.05, 0.0], np.float32)

    def proj(t, X):
        pc = X + t
        return np.stack([Kt.fx * pc[:, 0] / pc[:, 2] + Kt.cx,
                         Kt.fy * pc[:, 1] / pc[:, 2] + Kt.cy], -1)
    ep1 = np.concatenate([proj(t1, Xs), proj(t1, Xe)], -1).astype(np.float32)
    ep2 = np.concatenate([proj(t2, Xs), proj(t2, Xe)], -1).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    pose1 = np.concatenate([R, t1[:, None]], 1)
    pose2 = np.concatenate([R, t2[:, None]], 1)
    return Kt, Xs, Xe, pose1, pose2, ep1, ep2


@pytest.mark.parametrize("case", ["exact", "noisy", "zero_baseline",
                                  "mismatched"])
def test_line_triangulator_two_view_cases(case):
    """The cases of tests/test_lines.py: exact observations recovered to
    1e-3 m, 0.5 px noise to 0.1 m, a zero baseline always rejected,
    mismatched pairs mostly rejected; good equal to the reference's."""
    Kt, Xs, Xe, pose1, pose2, ep1, ep2 = _two_view_case()
    rng = np.random.default_rng(0)
    if case != "exact":
        ep1 = ep1 + rng.normal(0, 0.5, ep1.shape).astype(np.float32)
        ep2 = ep2 + rng.normal(0, 0.5, ep2.shape).astype(np.float32)
    if case == "zero_baseline":
        pose2, ep2 = pose1, ep1
    if case == "mismatched":
        ep2 = ep2[np.roll(np.arange(8), 1)]
    valid = np.ones(8, bool)
    args = (pose1, pose2, ep1, ep2, valid)
    oj = [np.asarray(a) for a in JK.make_line_triangulator(Kt, 8)(
        *[jnp.asarray(a) for a in args])]
    ot = KN.make_line_triangulator(KN.PinholeK(*Kt))(*[_t(a) for a in args])
    good = ot[2].numpy()
    np.testing.assert_array_equal(good, oj[2])
    err = np.linalg.norm(ot[0].numpy() - Xs, axis=1).max()
    if case == "exact":
        assert good.all() and err < 1e-3
        assert np.linalg.norm(ot[1].numpy() - Xe, axis=1).max() < 1e-3
    elif case == "noisy":
        assert good.all() and err < 0.1
    elif case == "zero_baseline":
        assert not good.any()
    else:
        assert good.sum() <= 4
