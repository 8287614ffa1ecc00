"""Slice 9, the keyframe database, against the JAX package on the CPU.

The port's `models/kfdb.py` (device banks; here on the CPU, the plain
pipeline and score) and plvio_tpu/models/kfdb.py fed the same keyframes:
random descriptors (points and lines), queried with noisy copies, with
the trained vocabularies and the deterministic random ones.

Tolerances, and why:
- bank rows (word ids and bags), `present` and `has_lines`, candidate
  ids and their order are equal: ids and bags are exact
  (tests/test_torch_vocabulary.py), and the queries here keep score gaps
  far above the tolerance;
- scores within 1e-6: the L1 sums run in another order.
"""
import numpy as np
import pytest

from plvio_tpu.models import vocabulary as JV
from plvio_tpu.models.kfdb import AtlasKeyFrameDatabase as JAtlasDB
from plvio_tpu.models.kfdb import KeyFrameDatabase as JDB
from plvio_tpu.models.mapstore import Atlas as JAtlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu_torch.models import vocabulary as V
from plvio_tpu_torch.models.kfdb import AtlasKeyFrameDatabase, KeyFrameDatabase
from plvio_tpu_torch.models.mapstore import Atlas, MapStore
from plvio_tpu_torch.state import kfdb_state, load_kfdb_state

SCORE_TOL = 1e-6
N_FEAT, N_LF, MAX_KF = 300, 64, 24


def _flip(rng, d, frac):
    """Flip each bit of packed descriptors d [n,8] uint32 with prob frac."""
    bits = np.unpackbits(d.view(np.uint8), axis=-1)
    bits ^= (rng.random(bits.shape) < frac).astype(np.uint8)
    return np.packbits(bits, axis=-1).view(np.uint32).reshape(d.shape)


def _family(rng, n_kf, n):
    """n_kf keyframes of n random descriptors each: [(desc, valid)]."""
    out = []
    for _ in range(n_kf):
        d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        v = rng.random(n) > 0.05
        out.append((d, v))
    return out


def _vocs(kind):
    if kind == "trained":
        return (JV.default_vocabulary("orb"), JV.default_vocabulary("lbd"),
                V.default_vocabulary("orb"), V.default_vocabulary("lbd"))
    return (JV.random_vocabulary(0, 6, 3), JV.random_vocabulary(1, 6, 2),
            V.random_vocabulary(0, 6, 3), V.random_vocabulary(1, 6, 2))


def _pair(kind, lines):
    vj, lj, vp, lp = _vocs(kind)
    j = JDB(vj, MAX_KF, N_FEAT, line_voc=lj if lines else None,
            n_line_feat=N_LF)
    p = KeyFrameDatabase(vp, MAX_KF, N_FEAT, line_voc=lp if lines else None,
                         n_line_feat=N_LF, device="cpu")
    return j, p


def _same_banks(j, p):
    np.testing.assert_array_equal(p.present, j.present)
    np.testing.assert_array_equal(p.word_ids.numpy(), j.word_ids)
    np.testing.assert_array_equal(p.bows.numpy(), j.bows)
    if j.line_voc is not None:
        np.testing.assert_array_equal(p.has_lines, j.has_lines)
        np.testing.assert_array_equal(p.bows_l.numpy(), j.bows_l)


def _same_query(rj, rp):
    np.testing.assert_array_equal(np.asarray(rp[0]), np.asarray(rj[0]))
    np.testing.assert_allclose(rp[1], rj[1], atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["trained", "random"])
@pytest.mark.parametrize("lines", [False, True])
def test_add_query_remove_equal_jax(kind, lines):
    rng = np.random.default_rng(11)
    j, p = _pair(kind, lines)
    kfs = _family(rng, 10, N_FEAT)
    lkfs = _family(rng, 10, N_LF)
    for k, ((d, v), (ld, lv)) in enumerate(zip(kfs, lkfs)):
        if k == 3:
            lv = np.zeros(N_LF, bool)          # < 5 valid: no line bag
        wj = j.add_keyframe(k + 2, d, v, ld, lv)
        wp = p.add_keyframe(k + 2, d, v, ld, lv)
        np.testing.assert_array_equal(wp.numpy(), wj)
    _same_banks(j, p)
    qd, qv = _flip(rng, kfs[5][0], 0.03), kfs[5][1]
    ql = (_flip(rng, lkfs[5][0], 0.03), lkfs[5][1])
    for kw in (dict(), dict(line_desc=ql[0], line_valid=ql[1]),
               dict(top_n=5, min_rel_score=0.0)):
        rj, rp = j.query(qd, qv, **kw), p.query(qd, qv, **kw)
        _same_query(rj, rp)
        assert int(rp[0][0]) == 7
    exclude = np.zeros(MAX_KF, bool)
    exclude[7] = True
    _same_query(j.query(qd, qv, exclude=exclude),
                p.query(qd, qv, exclude=exclude))
    j.remove_keyframe(7)
    p.remove_keyframe(7)
    _same_banks(j, p)
    _same_query(j.query(qd, qv, top_n=4, min_rel_score=0.0),
                p.query(qd, qv, top_n=4, min_rel_score=0.0))


@pytest.mark.parametrize("lines", [False, True])
def test_query_grouped_equal_jax(lines):
    """Covisibility-group scores: the host matvec over the same scores."""
    rng = np.random.default_rng(12)
    j, p = _pair("trained", lines)
    kfs = _family(rng, 12, N_FEAT)
    lkfs = _family(rng, 12, N_LF)
    for k, ((d, v), (ld, lv)) in enumerate(zip(kfs, lkfs)):
        j.add_keyframe(k, d, v, ld, lv)
        p.add_keyframe(k, d, v, ld, lv)
    covis = rng.integers(0, 40, (MAX_KF, MAX_KF))
    covis = np.maximum(covis, covis.T)
    kf_valid = np.zeros(MAX_KF, bool)
    kf_valid[:12] = True
    kf_valid[4] = False
    q = (_flip(rng, kfs[6][0], 0.05), kfs[6][1])
    kw = dict(line_desc=_flip(rng, lkfs[6][0], 0.05),
              line_valid=lkfs[6][1]) if lines else {}
    rj = j.query_grouped(*q, covis, kf_valid, top_n=4, **kw)
    rp = p.query_grouped(*q, covis, kf_valid, top_n=4, **kw)
    np.testing.assert_array_equal(rp[0], rj[0])
    np.testing.assert_allclose(rp[1], rj[1], atol=4 * SCORE_TOL, rtol=0)


def _atlases(n_maps):
    ja = JAtlas([JMapStore(max_kf=MAX_KF, max_pts=64, max_lines=16,
                           n_feat=N_FEAT, n_line_feat=N_LF)])
    pa = Atlas([MapStore(max_kf=MAX_KF, max_pts=64, max_lines=16,
                         n_feat=N_FEAT, n_line_feat=N_LF)])
    for _ in range(n_maps - 1):
        kw = dict(max_kf=MAX_KF, max_pts=64, max_lines=16, n_feat=N_FEAT,
                  n_line_feat=N_LF)
        ja.create_new_map(**kw)
        pa.create_new_map(**kw)
    return ja, pa


def _fill(rng, m_j, m_p, n_kf):
    """n_kf live keyframes with the same descriptors in both stores."""
    for k in range(n_kf):
        for m in (m_j, m_p):
            assert m.alloc_kf() == k
        d = rng.integers(0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32)
        v = rng.random(N_FEAT) > 0.05
        ld = rng.integers(0, 2 ** 32, (N_LF, 8), dtype=np.uint32)
        lv = rng.random(N_LF) > 0.3
        for m in (m_j, m_p):
            m.kf_feat_desc[k], m.kf_feat_valid[k] = d, v
            m.kf_line_desc[k], m.kf_line_valid[k] = ld, lv


def test_atlas_database_equal_jax():
    """Per-map banks: `rebuild` from the stores, `query_other_maps`,
    `merge_maps` under a slot remap, and `kfdb_state` / `load_kfdb_state`
    carrying the JAX banks over."""
    rng = np.random.default_rng(13)
    vj, lj, vp, lp = _vocs("trained")
    ja, pa = _atlases(3)
    for mj, mp in zip(ja.maps, pa.maps):
        _fill(rng, mj, mp, 6)
    dj = JAtlasDB(vj, MAX_KF, N_FEAT, ja, line_voc=lj, n_line_feat=N_LF)
    dp = AtlasKeyFrameDatabase(vp, MAX_KF, N_FEAT, pa, line_voc=lp,
                               n_line_feat=N_LF, device="cpu")
    dj.rebuild()
    dp.rebuild()
    for mid in (0, 1, 2):
        _same_banks(dj.db(mid), dp.db(mid))
    m1 = ja.maps[1]
    q = (_flip(rng, m1.kf_feat_desc[4], 0.03), m1.kf_feat_valid[4])
    oj = dj.query_other_maps(*q, cur_map_id=ja.maps[2].map_id)
    op = dp.query_other_maps(*q, cur_map_id=pa.maps[2].map_id)
    assert [(a, b) for a, b, _ in op] == [(a, b) for a, b, _ in oj]
    np.testing.assert_allclose([s for _, _, s in op], [s for _, _, s in oj],
                               atol=SCORE_TOL, rtol=0)
    assert op[0][:2] == (ja.maps[1].map_id, 4)
    _same_query(dj.query(*q, map_id=1), dp.query(*q, map_id=1))
    kf_map = np.full(MAX_KF, -1, np.int64)
    kf_map[:6] = np.arange(10, 16)
    kf_map[2] = -1
    dj.merge_maps(1, 0, kf_map)
    dp.merge_maps(1, 0, kf_map)
    assert sorted(dp._dbs) == sorted(dj._dbs)
    _same_banks(dj.db(0), dp.db(0))
    # the JAX banks carried into a fresh port database
    fresh = AtlasKeyFrameDatabase(vp, MAX_KF, N_FEAT, pa, line_voc=lp,
                                  n_line_feat=N_LF, device="cpu")
    load_kfdb_state(fresh, kfdb_state(dj))
    for mid in dj._dbs:
        _same_banks(dj.db(mid), fresh.db(mid))
    _same_query(dj.query(*q, map_id=0), fresh.query(*q, map_id=0))


def test_retrieval_and_line_mix():
    """tests/test_place_recognition.py:46-63 (a noisy re-observation
    retrieves its keyframe) and tests/test_vocabulary_trained.py:79 (a
    keyframe sharing points and lines outranks one sharing points only),
    on the port as on JAX."""
    rng = np.random.default_rng(14)
    j, p = _pair("random", True)
    d0 = rng.integers(0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32)
    v0 = np.ones(N_FEAT, bool)
    ld0 = rng.integers(0, 2 ** 32, (N_LF, 8), dtype=np.uint32)
    ld1 = rng.integers(0, 2 ** 32, (N_LF, 8), dtype=np.uint32)
    lv = np.ones(N_LF, bool)
    for db in (j, p):
        db.add_keyframe(0, d0, v0, ld0, lv)
        db.add_keyframe(1, d0, v0, ld1, lv)
    rj = j.query(d0, v0, top_n=2, line_desc=ld0, line_valid=lv)
    rp = p.query(d0, v0, top_n=2, line_desc=ld0, line_valid=lv)
    _same_query(rj, rp)
    assert int(rp[0][0]) == 0 and rp[1][0] > rp[1][1]
    p.remove_keyframe(0)
    assert not p.has_lines[0] and float(p.bows_l[0].abs().sum()) == 0.0
