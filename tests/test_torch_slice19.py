"""Slice 19's redesigns of `vi_pose_lm` and `line_detect` on the CPU.

1. The top-K rule of csrc/line_detect.cu, mirrored in numpy: the roots
   with a score above 0 keyed on (score bits, complement of the row: rows
   number the labels in index order), sorted descending by the bitonic
   network whose every exchange puts the larger key at the lower index
   (so the padding to a power of two is never stored), then the
   lowest-index cells with score 0 in order.  It equals
   `torch.sort(score, descending=True, stable=True).indices[:n]`, the
   plain version's (and lax.top_k's) order, with tied scores, fewer good
   roots than n, none, and more than n.
2. The both-level plain path (`detect_levels_plain`, what
   `line_detect_levels` runs on CPU tensors and `extract_lines_pyramid`
   on the plain path) equals two one-level `detect_lines` calls bit for
   bit, and JAX `detect_lines` at both levels of a rendered 480x752 frame
   by tests/test_torch_lines.py's rule (>= 95% of the reference's valid
   segments within 0.5 px).
3. `make_vi_pose_optimizer`'s run, which now keeps its extrinsics on each
   device it has seen, on the CPU against JAX `make_vi_pose_optimizer`
   within tests/test_torch_vi_pose_opt.py's bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.config import ImuConfig
from plvio_tpu.models import kernels as JK
from plvio_tpu.ops import imu as JI
from plvio_tpu.ops import lines as JL
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu_torch.models import kernels as TK
from plvio_tpu_torch.ops import lines as TL
from plvio_tpu_torch.ops.frontend import line_level_plain
from plvio_tpu_torch.solver.residuals import PinholeK
from plvio_tpu_torch.utils import lie
from test_torch_lines import _frame, _match_segments
from test_torch_vi_pose_opt import (CAP, KV, _compare, _frame_problem,
                                    _gate_near, _run_both)


def kernel_top_k(score: np.ndarray, n: int) -> np.ndarray:
    """The cell indices csrc/line_detect.cu writes, in order, for the
    cells' scores (>= 0; > 0 only for the good roots)."""
    C = len(score)
    n = min(n, C)
    good = np.nonzero(score > 0)[0]
    bits = score.astype(np.float32).view(np.uint32)
    key = [(int(bits[i]) << 32) | (0xFFFFFFFF - int(i)) for i in good]
    n_good = len(key)
    P = 1
    while P < n_good:
        P <<= 1
    k = 2
    while k <= P:
        d = k >> 1
        while d >= 1:
            for t in range(P // 2):
                blk, off = t // d, t % d
                if d == k >> 1:
                    i, j = blk * k + off, blk * k + k - 1 - off
                else:
                    i = blk * 2 * d + off
                    j = i + d
                if j < n_good and key[j] > key[i]:
                    key[i], key[j] = key[j], key[i]
            d >>= 1
        k <<= 1
    top = [0xFFFFFFFF - (v & 0xFFFFFFFF) for v in key[:min(n, n_good)]]
    tail = [i for i in range(C) if not score[i] > 0][:n - len(top)]
    return np.array(top + tail, np.int64)


def _scores(case, C=300, seed=0):
    rng = np.random.default_rng(seed)
    s = np.zeros(C, np.float32)
    if case == "ties":
        idx = rng.choice(C, 60, replace=False)
        s[idx] = rng.choice([12.0, 15.5, 20.0], 60)
    elif case == "fewer":
        s[rng.choice(C, 10, replace=False)] = rng.uniform(12, 80, 10)
    elif case == "more":
        idx = rng.choice(C, 200, replace=False)
        s[idx] = rng.uniform(12, 80, 200).astype(np.float32)
        s[idx[::7]] = 33.25                       # and some ties
    return s


@pytest.mark.parametrize("case", ["ties", "fewer", "none", "more"])
def test_kernel_top_k_rule_is_the_stable_sort(case):
    s = _scores(case)
    n = 40 if case == "ties" else 64
    want = torch.sort(torch.from_numpy(s), descending=True,
                      stable=True).indices[:n].numpy()
    np.testing.assert_array_equal(kernel_top_k(s, n), want)


@pytest.fixture(scope="module")
def room_levels():
    """A rendered 480x752 room frame and its line level; JAX
    `detect_lines` on each (192 and 64 segments, as the pyramid asks)."""
    img = torch.from_numpy(_frame(0))
    img1 = line_level_plain(img).contiguous()
    det = {n: jax.jit(lambda im, n=n: JL.detect_lines(im, n)[:4])
           for n in (192, 64)}
    ref = [det[n](jnp.asarray(im.numpy())) for im, n in ((img, 192),
                                                         (img1, 64))]
    return (img, img1), ref


def test_both_level_plain_path_is_two_one_level_calls(room_levels):
    (img, img1), _ = room_levels
    both = TL.detect_levels_plain([img, img1], [192, 64])
    assert TL.line_detect_levels([img, img1], [192, 64])[0][0].shape == \
        (192, 4)
    for got, (im, n) in zip(both, ((img, 192), (img1, 64))):
        one = TL.detect_lines(im, n)
        assert all(torch.equal(a, b) for a, b in zip(got[:4], one[:4]))
        assert all(torch.equal(a, b) for a, b in zip(got[4], one[4]))


@pytest.mark.parametrize("level", [0, 1])
def test_both_level_plain_path_matches_reference(room_levels, level):
    (img, img1), ref = room_levels
    got = TL.detect_levels_plain([img, img1], [192, 64])[level]
    ej, vj = np.asarray(ref[level][0]), np.asarray(ref[level][3])
    et, vt = got[0].numpy(), got[3].numpy()
    assert vj.sum() >= (10 if level == 0 else 3)
    m = _match_segments(ej, vj, et, vt)
    assert (m >= 0).sum() / vj.sum() >= 0.95


@pytest.fixture(scope="module")
def vi_optimizers():
    jo = JK.make_vi_pose_optimizer(JPin(*KV), CAP, np.eye(3, dtype=np.float32),
                                   np.zeros(3, np.float32), 9.81)
    to = TK.make_vi_pose_optimizer(PinholeK(*KV), CAP, np.eye(3),
                                   np.zeros(3), 9.81)
    return jo, to


@pytest.mark.parametrize("have_prior", [True, False])
def test_vi_run_with_kept_extrinsics_matches_reference(vi_optimizers,
                                                       have_prior):
    """Two calls of the same run (the second on the extrinsics the first
    kept) give the same result, within test_torch_vi_pose_opt.py's bounds
    of the reference."""
    rng = np.random.default_rng(11)
    calib = JI.make_calib(ImuConfig())
    R0 = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3))).numpy()
    p0, v0 = rng.normal(0, 1, 3), rng.normal(0, 0.5, 3)
    prob = _frame_problem(rng, (R0.astype(np.float32), p0.astype(np.float32),
                                v0.astype(np.float32)), calib)
    prev = np.concatenate([R0, p0[:, None]], 1).astype(np.float32)
    bg, ba = np.full(3, 1e-3, np.float32), np.full(3, 1e-2, np.float32)
    prior_const = {"R0": R0.astype(np.float32), "p0": p0.astype(np.float32),
                   "v0": v0.astype(np.float32), "bg0": np.zeros(3, np.float32),
                   "ba0": np.zeros(3, np.float32)}
    H15 = np.eye(15, dtype=np.float32) * 100.0
    runs = [_run_both(vi_optimizers, prob, prev, v0.astype(np.float32), bg,
                      ba, prior_const, H15, have_prior) for _ in range(2)]
    (oj, ot), (_, ot2) = runs
    assert all(torch.equal(a, b) for a, b in zip(ot, ot2))
    diff = _compare(oj, ot)
    assert not np.any(diff & ~_gate_near(ot, prob))
