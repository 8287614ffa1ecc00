"""Slice 9, the bag-of-words vocabulary, against the JAX package on the CPU.

The port's `models/vocabulary.py` (packed centroid levels, the plain
descent and bag) against plvio_tpu/models/vocabulary.py on the same
descriptors: a rendered frame's ORB and LBD descriptors (the port's CPU
front end on frame 0 of `inputs.build_tracked_sequence`), random ones
with invalid rows, and a constructed tie between two children.

Tolerances, and why:
- the assets are byte copies, and the loaded centroids equal JAX's +-1
  levels exactly (the MSB-first np.packbits rows repacked LSB first into
  the port's words: a wrong repacking still gives plausible word ids, so
  the ids are compared, not only their range);
- word ids are equal: the descent compares integer Hamming distances
  (the reference's float32 dots of +-1 vectors are exact integers), and
  ties take the first child on both sides;
- the bag is bit-equal: integer counts over their exact total, one true
  division;
- the L1 score within 1e-6: the sum over 10 000 words runs in another
  order (XLA's reduction against torch's).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.models import vocabulary as JV
from plvio_tpu.ops import matching as JM
from plvio_tpu_torch.models import vocabulary as V
from plvio_tpu_torch.state import vocabulary_from_numpy

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCORE_TOL = 1e-6


def _frame_descriptors():
    """ORB [N,8] and LBD [256,8] packed descriptors (numpy uint32) with
    their valid masks, of a rendered frame through the port's front end."""
    from plvio_tpu_torch.entry import TrackedSequence
    from plvio_tpu_torch.inputs import build_tracked_sequence
    from plvio_tpu_torch.models.system import frame_prelude
    S = build_tracked_sequence(0, 1)
    step = TrackedSequence(plain=True, device="cpu")
    with torch.no_grad():
        f, lf = frame_prelude(step.orb, step.lines, step.cam,
                              torch.from_numpy(S["frames"][0]))
    return dict(orb=(f.desc.numpy().view(np.uint32), f.valid.numpy()),
                lbd=(lf.desc.numpy().view(np.uint32), lf.valid.numpy()))


@pytest.fixture(scope="module")
def frame():
    return _frame_descriptors()


def _random(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    valid = rng.random(n) > 0.15
    return d, valid


def _tie(voc_j):
    """A descriptor at equal Hamming distance from two level-0 children
    (the closest two), nearer to them than to the others: the first must
    win."""
    C = np.asarray(voc_j.centroids[0], np.float32) > 0
    for a in range(len(C)):
        for b in range(a + 1, len(C)):
            diff = np.nonzero(C[a] != C[b])[0]
            if len(diff) % 2:
                continue
            d = C[a].copy()
            d[diff[: len(diff) // 2]] = C[b][diff[: len(diff) // 2]]
            dist = (C != d[None]).sum(1)
            if dist[a] == dist[b] and (np.delete(dist, [a, b])
                                       > dist[a]).all():
                return d, a
    raise AssertionError("no tie constructed")


def _jax_pipeline(voc_j, desc, valid):
    wid, bow = JV.make_bow_pipeline(voc_j, len(desc))(
        jnp.asarray(desc), jnp.asarray(valid))
    return np.asarray(wid), np.asarray(bow)


def _port_pipeline(voc, desc, valid):
    wid, bow = V.make_bow_pipeline(voc, len(desc))(
        torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)),
        torch.from_numpy(np.ascontiguousarray(valid)))
    return wid.numpy(), bow.numpy()


@pytest.mark.parametrize("kind", ["orb", "lbd"])
def test_assets_are_byte_copies(kind):
    a = open(os.path.join(REPO, "plvio_tpu", "assets", f"{kind}voc.npz"),
             "rb").read()
    b = open(os.path.join(REPO, "plvio_tpu_torch", "assets",
                          f"{kind}voc.npz"), "rb").read()
    assert a == b


@pytest.mark.parametrize("kind,depth", [("orb", 4), ("lbd", 3)])
def test_load_equals_jax_centroids(kind, depth):
    """Every level's centroids equal JAX's +-1 rows (k = 10; ORB depth 4,
    10 000 words; LBD depth 3, 1 000 words), and the JAX vocabulary
    carried over with `state.vocabulary_from_numpy` equals the load."""
    vj, vp = JV.default_vocabulary(kind), V.default_vocabulary(kind)
    assert (vp.k, vp.depth) == (vj.k, vj.depth) == (10, depth)
    carried = vocabulary_from_numpy(vj)
    for l in range(depth):
        pm1 = V.unpack_u32_to_pm1(vp.centroids[l]).numpy()
        np.testing.assert_array_equal(
            pm1, np.asarray(vj.centroids[l], np.float32))
        np.testing.assert_array_equal(carried.centroids[l].numpy(),
                                      vp.centroids[l].numpy())


@pytest.mark.parametrize("kind", ["orb", "lbd"])
@pytest.mark.parametrize("source", ["frame", "random", "tie"])
def test_transform_and_bow_equal_jax(kind, source, frame):
    """Word ids equal, bags bit-equal, on the trained vocabularies."""
    vj, vp = JV.default_vocabulary(kind), V.default_vocabulary(kind)
    if source == "frame":
        desc, valid = frame[kind]
    elif source == "random":
        desc, valid = _random(1 if kind == "orb" else 2, 1000)
    else:
        d, first = _tie(vj)
        desc = np.asarray(JM.pack_bits_u32(jnp.asarray(d[None])))
        desc = np.concatenate([desc, _random(3, 15)[0]])
        valid = np.ones(len(desc), bool)
    wj, bj = _jax_pipeline(vj, desc, valid)
    wp, bp = _port_pipeline(vp, desc, valid)
    np.testing.assert_array_equal(wp, wj)
    np.testing.assert_array_equal(bp, bj)
    assert (wp[~valid] == -1).all() and (wp[valid] >= 0).all()
    if source == "tie":
        assert wp[0] // vp.k ** (vp.depth - 1) == first
    assert abs(float(bp.sum()) - 1.0) < 1e-5 or not valid.any()


def test_random_vocabulary_equals_jax():
    """The deterministic random tree (the fallback without assets) and its
    descent, mirroring tests/test_place_recognition.py:30-44."""
    vj, vp = JV.random_vocabulary(seed=0), V.random_vocabulary(seed=0)
    for l in range(4):
        np.testing.assert_array_equal(
            V.unpack_u32_to_pm1(vp.centroids[l]).numpy(),
            np.asarray(vj.centroids[l], np.float32))
    desc, valid = _random(4, 500)
    valid[:] = True
    wj, _ = _jax_pipeline(vj, desc, valid)
    wp, _ = _port_pipeline(vp, desc, valid)
    np.testing.assert_array_equal(wp, wj)
    assert wp.min() >= 0 and wp.max() < vp.n_words


def test_save_load_roundtrip(tmp_path):
    """The port's file is the reference's format: JAX loads what the port
    saves, and the port loads it back."""
    vp = V.random_vocabulary(seed=3, k=5, depth=3)
    path = str(tmp_path / "voc.npz")
    V.save(vp, path)
    vj = JV.load(path)
    back = V.load(path)
    for l in range(3):
        np.testing.assert_array_equal(
            V.unpack_u32_to_pm1(vp.centroids[l]).numpy(),
            np.asarray(vj.centroids[l], np.float32))
        np.testing.assert_array_equal(back.centroids[l].numpy(),
                                      vp.centroids[l].numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_l1_score_within_tolerance(masked):
    """The score of a bag against a bank of 64 bags, plain and through
    `bow_score` (its plain version on the CPU), against JAX's l1_score."""
    rng = np.random.default_rng(9)
    W = 10000
    bank = np.zeros((64, W), np.float32)
    for r in range(64):
        ids = rng.integers(0, W, 900)
        np.add.at(bank[r], ids, 1.0)
        bank[r] /= bank[r].sum()
    v = bank[7] * 0.5 + bank[8] * 0.5
    mask = rng.random(64) > 0.3 if masked else np.ones(64, bool)
    sj = np.where(mask, np.asarray(JV.l1_score(jnp.asarray(v),
                                               jnp.asarray(bank))), -1.0)
    sp = V.bow_score(torch.from_numpy(v), torch.from_numpy(bank),
                     torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(sp, sj, atol=SCORE_TOL, rtol=0)
    assert int(np.argmax(sp)) in (7, 8)
