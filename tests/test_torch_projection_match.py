"""The projection matcher against the JAX package (CPU):
`make_projection_matcher` (models/kernels.py:767) at 2048 map points x
1000 features, both ways it is called: the keyframe fuse (radius 2,
max_dist 50, no frustum gates) and the production tracker (radius 6,
max_dist 80, the distance-range and viewing-angle gates), on a case in
which every gate decides some rows (the plain match changes when that gate
alone is left out); and the rule of its feature back map on duplicate
scatter indices (the last row that writes a feature wins).

Tolerance: pt_feat, matched, uv_m and feat_pt exactly equal, and the port's
1.2^octave table equal to the reference's float32 power.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from plvio_tpu.models import kernels as JK
from plvio_tpu.solver.residuals import PinholeK as JPinholeK
from plvio_tpu_torch.entry import K_EUROC as K
from plvio_tpu_torch.inputs import build_projection_case
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import matching as M

P, F = 2048, 1000
JPK = JPinholeK(*K)
MODES = {"fuse": dict(radius=2.0, max_dist=50.0, frustum=False),
         "tracker": dict(radius=6.0, max_dist=80.0, frustum=True)}


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


ARGS = ("pose", "pt_xyz", "pt_desc", "pt_valid", "feat_uv", "feat_desc",
        "feat_octave", "feat_valid")


def run_jax(c, mode):
    kw = MODES[mode]
    fr = {}
    if kw["frustum"]:
        fr = {k: jnp.asarray(c[k]) for k in ("pt_normal", "pt_min_dist",
                                              "pt_max_dist")}
    out = JK.make_projection_matcher(JPK, F, P)(
        *[jnp.asarray(c[k]) for k in ARGS], jnp.float32(kw["radius"]),
        jnp.float32(kw["max_dist"]), **fr)
    return [np.asarray(a) for a in out]


def run_port(c, mode):
    kw = MODES[mode]
    fr = {}
    if kw["frustum"]:
        fr = {k: _t(c[k]) for k in ("pt_normal", "pt_min_dist",
                                    "pt_max_dist")}
    out = KN.make_projection_matcher(K)(*[_t(c[k]) for k in ARGS],
                                        kw["radius"], kw["max_dist"], **fr)
    return [a.numpy() for a in out]


@pytest.fixture(scope="module")
def case():
    return build_projection_case()


def test_octave_scale_is_the_reference_power():
    o = jnp.arange(8, dtype=jnp.float32)
    np.testing.assert_array_equal(KN.OCTAVE_SCALE, np.asarray(1.2 ** o))


def gate_effects(c, mode, ref):
    """Rows whose match changes when one gate of the plain match is left
    out."""
    kw = MODES[mode]
    T = {k: _t(v) for k, v in c.items()}
    fr = (T["pt_normal"], T["pt_min_dist"], T["pt_max_dist"]) \
        if kw["frustum"] else (None, None, None)
    uv, ok = KN.project_gates(K, T["pose"], T["pt_xyz"], T["pt_valid"], *fr)
    X = T["pt_xyz"].double()
    Pd = T["pose"].double()
    z = X @ Pd[2, :3] + Pd[2, 3]
    in_img = (z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < 2 * K.cx) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < 2 * K.cy)
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(T["pt_desc"]),
                            M.unpack_u32_to_pm1(T["feat_desc"]))
    scale = torch.from_numpy(KN.OCTAVE_SCALE)[T["feat_octave"].long()]
    d2 = ((uv[:, None] - T["feat_uv"][None]) ** 2).sum(-1)
    r = kw["radius"] * scale
    win = d2 <= r * r
    ref = (torch.from_numpy(ref[1]), torch.from_numpy(ref[2]))
    fv = T["feat_valid"]

    def nn(rows, gate, md=kw["max_dist"], ratio=0.9, mutual=True):
        return M.match_nn_ratio(dist, rows, fv, gate, md, ratio, mutual)

    def changed(out):
        idx, okk = out
        return int(((okk != ref[1]) | (okk & ref[1] & (idx != ref[0])))
                   .sum())
    eff = {"window": changed(nn(ok, None)),
           "max_dist": changed(nn(ok, win, md=1e30)),
           "ratio": changed(nn(ok, win, ratio=1e30)),
           "mutual": changed(nn(ok, win, mutual=False)),
           "valid": changed(nn(ok | (~T["pt_valid"] & in_img), win))}
    no_img = KN.project_gates(K, T["pose"], T["pt_xyz"], T["pt_valid"],
                              *fr)[1] | (T["pt_valid"] & ~in_img)
    eff["in-image"] = changed(nn(no_img, win))
    if kw["frustum"]:
        no_range = KN.project_gates(K, T["pose"], T["pt_xyz"],
                                    T["pt_valid"], T["pt_normal"],
                                    T["pt_min_dist"],
                                    torch.zeros_like(T["pt_max_dist"]))[1]
        no_angle = KN.project_gates(K, T["pose"], T["pt_xyz"],
                                    T["pt_valid"], None, T["pt_min_dist"],
                                    T["pt_max_dist"])[1]
        eff["range"] = changed(nn(no_range, win))
        eff["angle"] = changed(nn(no_angle, win))
    return eff


@pytest.mark.parametrize("mode", sorted(MODES))
def test_projection_matcher_matches_reference(case, mode):
    oj = run_jax(case, mode)
    ot = run_port(case, mode)
    for name, a, b in zip(("uv_m", "pt_feat", "matched", "feat_pt"), ot, oj):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert 150 <= int(oj[2].sum()) <= 600
    eff = gate_effects(case, mode, ot)
    assert min(eff.values()) > 0, eff


@pytest.mark.parametrize("last_matches_zero", [False, True])
def test_feat_pt_last_write_wins(last_matches_zero):
    """Six points, four features: row 0 matches feature 0 and rows 1-5 do
    not (their scatter index is 0 too), so feature 0 takes row 5's -1; or
    rows 0-4 match features 1-3 / nothing and row 5 matches feature 0, so
    feature 0 takes 5."""
    rng = np.random.default_rng(3)
    n, f = 6, 4
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    fdesc = rng.integers(0, 2 ** 32, (f, 8), dtype=np.uint32)
    z = np.full(n, 4.0)
    uv = np.stack([np.linspace(100, 600, n), np.full(n, 200.0)], -1)
    valid = np.zeros(n, bool)
    owner = {0: 5, 1: 1, 2: 2} if last_matches_zero else {0: 0, 1: 3}
    feat_uv = np.stack([np.linspace(650, 700, f), np.full(f, 400.0)], -1)
    for j, r in owner.items():
        valid[r] = True
        fdesc[j] = desc[r]
        feat_uv[j] = uv[r]
    X = np.stack([(uv[:, 0] - K.cx) / K.fx * z, (uv[:, 1] - K.cy) / K.fy * z,
                  z], -1)
    c = dict(pose=np.eye(3, 4, dtype=np.float32),
             pt_xyz=X.astype(np.float32), pt_desc=desc, pt_valid=valid,
             feat_uv=feat_uv.astype(np.float32), feat_desc=fdesc,
             feat_octave=np.zeros(f, np.int32),
             feat_valid=np.ones(f, bool))
    kw = dict(radius=jnp.float32(2.0), max_dist=jnp.float32(50.0))
    oj = [np.asarray(a) for a in JK.make_projection_matcher(JPK, f, n)(
        *[jnp.asarray(c[k]) for k in ARGS], **kw)]
    ot = KN.make_projection_matcher(K)(*[_t(c[k]) for k in ARGS], 2.0, 50.0)
    np.testing.assert_array_equal(ot[3].numpy(), oj[3])
    np.testing.assert_array_equal(ot[2].numpy(), oj[2])
    assert int(oj[3][0]) == (5 if last_matches_zero else -1)
    assert bool(oj[2][0]) != last_matches_zero
