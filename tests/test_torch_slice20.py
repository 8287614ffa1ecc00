"""Slice 20's redesigns of `ba_linearize` and `hamming_match` on the CPU.

The kernels run only on the card; their new sum and reduction orders are
mirrored here in numpy, index for index, against the orders of the
kernels before the redesign (one thread a segment entry walking its
observations; one 1024-thread block summing the robust costs; a global
atomicMin a gated pair):

1. csrc/ba_linearize.cu `kf_segment`: a keyframe's observation blocks
   staged `kStage` at a time (double-buffered: one stage summed while the
   next loads), each entry summed in kf_order across the stages; `seg_sum`: a landmark's entries with their loads four at a
   time ahead of the adds, in pt_order / ln_order.  Both add the same
   terms in the same order as the parent's loop, so their float32 sums
   are its bits.
2. The cost sum: each of the parent's 1024 threads' sums (w chi2 values
   v, v + 1024, ... in order) is now a chain its block adds while
   evaluating those observations (`cost_chains`, 8 chains a block), and
   the launch's last block runs the parent's tree over the chain sums
   (`chain_trees`, the points' and the lines' trees level by level in
   one pass): the same additions in the same order.
3. csrc/hamming_match.cu: each block's column minima of (distance << 16
   | row) in shared memory, then one global atomicMin a touched column,
   give the column's first row among the equal least distances, as
   argmin(axis=0) does and as one atomicMin a pair did.
4. The plain `hamming_match` in the tracker's ungated mode (radius +inf:
   the reference-keyframe and relocalization matches) against JAX
   `match_nn_ratio` with no gate, 2048 x 1000.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.ops import matching as JM
from plvio_tpu_torch.ops import matching as M

K_STAGE = 192          # csrc/ba_linearize.cu kStage
RED_THREADS = 1024     # csrc/ba_linearize.cu kRedThreads


def _segments(keys: np.ndarray, n: int):
    """(order, start): `models/kernels._segments` without masked rows."""
    order = np.argsort(keys, kind="stable")
    start = np.zeros(n + 1, np.int64)
    start[1:] = np.cumsum(np.bincount(keys, minlength=n))
    return order, start


def parent_segment(src, order, lo, hi, stride, e):
    """The parent's reduce_kernel thread: (sum, the rows it added)."""
    acc, rows = np.float32(0), []
    for i in range(lo, hi):
        acc = np.float32(acc + src[order[i] * stride + e])
        rows.append(int(order[i]))
    return acc, rows


def staged_segment(src, order, lo, hi, e):
    """`kf_segment`'s entry e: the block stages kStage observations'
    27-float blocks into one of two buffers, thread e adds its entry of
    each staged block in order, stage after stage (the next stage loading
    meanwhile into the other buffer)."""
    acc, rows = np.float32(0), []
    for c0 in range(lo, hi, K_STAGE):
        cnt = min(K_STAGE, hi - c0)
        s_ord = order[c0:c0 + cnt]
        idx = np.arange(cnt * 27)
        s_blk = src[s_ord[idx // 27] * 27 + idx % 27]
        for i in range(cnt):
            acc = np.float32(acc + s_blk[i * 27 + e])
            rows.append(int(s_ord[i]))
    return acc, rows


def prefetched_segment(src, order, lo, hi, stride, e):
    """`seg_sum`: four order entries, then four values, then their adds
    in order (the padding lanes never added)."""
    acc, rows = np.float32(0), []
    for i in range(lo, hi, 4):
        ix = [order[i + k] if i + k < hi else 0 for k in range(4)]
        v = [src[ix[k] * stride + e] if i + k < hi else np.float32(0)
             for k in range(4)]
        for k in range(4):
            if i + k < hi:
                acc = np.float32(acc + v[k])
                rows.append(int(ix[k]))
    return acc, rows


@pytest.mark.parametrize("n_obs", [0, 37, 576, 1300])
def test_staged_keyframe_sum_adds_in_kf_order(n_obs):
    """A keyframe's entries over 0, fewer than one stage, three and seven
    stages of observations: the rows added and the float32 sums equal the
    parent's loop's, entry by entry (signed zeros included)."""
    rng = np.random.default_rng(n_obs)
    n_kf = 3
    kf = rng.integers(0, n_kf, 3 * n_obs) if n_obs else np.zeros(0, int)
    src = rng.normal(0, 1e3, (max(len(kf), 1) * 27)).astype(np.float32)
    src[::7] = np.float32(-0.0)
    order, start = _segments(kf, n_kf)
    for k in range(n_kf):
        for e in (0, 5, 20, 26):
            a, ra = parent_segment(src, order, start[k], start[k + 1], 27, e)
            b, rb = staged_segment(src, order, start[k], start[k + 1], e)
            assert ra == rb and a.tobytes() == b.tobytes(), (k, e)


@pytest.mark.parametrize("stride", [9, 27])
def test_prefetched_landmark_sum_adds_in_pt_order(stride):
    """Each landmark's entries (1 to 17 observations, some none): the rows
    `seg_sum` adds, in pt_order (or ln_order), and its sums equal the
    parent's."""
    rng = np.random.default_rng(stride)
    n_lm = 200
    lm = np.concatenate([rng.integers(0, n_lm, 900),
                         np.full(17, 3), np.full(4, 7)])
    rng.shuffle(lm)
    src = rng.normal(0, 50, len(lm) * stride).astype(np.float32)
    order, start = _segments(lm, n_lm + 5)
    for p in range(n_lm + 5):
        for e in (0, stride // 2, stride - 1):
            a, ra = parent_segment(src, order, start[p], start[p + 1],
                                   stride, e)
            b, rb = prefetched_segment(src, order, start[p], start[p + 1],
                                       stride, e)
            assert ra == rb and a.tobytes() == b.tobytes(), (p, e)


def parent_block_sum(x: np.ndarray) -> np.float32:
    """csrc/ba_linearize.cu's cost sum before the redesign: one block of
    1024 threads, thread t from 0 over x[t::1024], then the tree."""
    sh = np.zeros(RED_THREADS, np.float32)
    for t in range(RED_THREADS):
        a = np.float32(0)
        for v in x[t::RED_THREADS]:
            a = np.float32(a + v)
        sh[t] = a
    s = RED_THREADS // 2
    while s:
        sh[:s] = sh[:s] + sh[s:2 * s]
        s //= 2
    return sh[0]


def chained_cost_sum(x: np.ndarray) -> np.float32:
    """csrc/ba_linearize.cu's cost sum: 128 blocks of 512 threads, block k
    owning the chains v = 8k .. 8k + 7 (`cost_chains`): its threads
    evaluate 64 steps of each chain a pass into shared memory, then thread
    c adds its chain's steps in order, pass after pass; the last block's
    `chain_trees` over the 1024 chain sums, each level's additions spread
    over its 512 threads."""
    blocks, threads = 128, 512
    chains = RED_THREADS // blocks
    rows = threads // chains
    part = np.zeros(RED_THREADS, np.float32)
    steps = -(-len(x) // RED_THREADS)
    for k in range(blocks):
        acc = [np.float32(0)] * chains
        for j0 in range(0, steps, rows):
            s_w = np.zeros(threads, np.float32)
            for t in range(threads):
                c, j = t % chains, j0 + t // chains
                i = k * chains + c + j * RED_THREADS
                if j < steps and i < len(x):
                    s_w[t] = x[i]
            for c in range(chains):
                v = k * chains + c
                for r in range(rows):
                    if j0 + r < steps and v + (j0 + r) * RED_THREADS < len(x):
                        acc[c] = np.float32(acc[c] + s_w[r * chains + c])
        part[k * chains:(k + 1) * chains] = acc
    sh = part.copy()
    s = RED_THREADS // 2
    while s:
        new = sh.copy()
        for t in range(threads):
            for v in range(t, s, threads):
                new[v] = np.float32(sh[v] + sh[v + s])
        sh = new
        s //= 2
    return sh[0]


@pytest.mark.parametrize("n", [0, 1, 1000, 9216, 70000])
def test_chained_cost_sum_in_block_sum_order(n):
    """The cost as the kernel sums it now (each chain of w chi2 values by
    the block that owns it, the tree by the launch's last block) equals
    the parent's 1024-thread block sum bit for bit, over a heavy-tailed w
    chi2 whose sum order matters, up to more steps than one pass."""
    rng = np.random.default_rng(n)
    x = (rng.standard_cauchy(n) ** 2).astype(np.float32)
    ref = parent_block_sum(x)
    assert chained_cost_sum(x).tobytes() == ref.tobytes()
    if n > 1000:
        # a sequential sum differs: the order is what is being kept
        seq = np.float32(0)
        for v in x:
            seq = np.float32(seq + v)
        assert seq.tobytes() != ref.tobytes()


def column_best(dist: np.ndarray, gate: np.ndarray, rows_a_block: int):
    """csrc/hamming_match.cu's column minima: each block of rows_a_block
    rows takes the least (dist << 16 | row) of its gated pairs in shared
    memory, then one global minimum a touched column; 0xffffffff where no
    row reaches a column."""
    n, m = dist.shape
    key = (dist.astype(np.uint64) << 16) | np.arange(n, dtype=np.uint64)[
        :, None]
    key = np.where(gate, key, np.uint64(0xFFFFFFFF))
    best = np.full(m, 0xFFFFFFFF, np.uint64)
    for r0 in range(0, n, rows_a_block):
        s_best = key[r0:r0 + rows_a_block].min(axis=0)
        touched = s_best != 0xFFFFFFFF
        best[touched] = np.minimum(best[touched], s_best[touched])
    return best


@pytest.mark.parametrize("gated", [False, True])
def test_shared_then_global_column_minimum_is_first_argmin(gated):
    """Tie-heavy distances (two-bit descriptors): the column minima by
    block then globally name, for every column a row reaches, the first
    row among its least distances (argmin(axis=0) of the masked matrix),
    at 8 rows a block (the launch's) and at other block sizes."""
    g = torch.Generator().manual_seed(3)
    n, m = 700, 500
    a = (torch.randint(0, 4, (n, 8), generator=g) << 30).to(torch.int32)
    b = (torch.randint(0, 4, (m, 8), generator=g) << 30).to(torch.int32)
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(a),
                            M.unpack_u32_to_pm1(b)).numpy().astype(np.int64)
    gate = np.ones((n, m), bool)
    if gated:
        xy_a = torch.rand(n, 2, generator=g).numpy() * 120
        xy_b = torch.rand(m, 2, generator=g).numpy() * 120
        gate = ((xy_a[:, None] - xy_b[None]) ** 2).sum(-1) <= 20.0 ** 2
        gate &= (torch.rand(n, generator=g) < 0.9).numpy()[:, None]
    masked = np.where(gate, dist, 10 ** 6)
    first = masked.argmin(axis=0)
    reached = gate.any(axis=0)
    for rows in (8, 1, 32, n):
        best = column_best(dist, gate, rows)
        assert np.array_equal((best & 0xFFFF)[reached], first[reached])
        assert np.array_equal(best[reached] >> 16,
                              masked.min(axis=0)[reached])
        assert np.all(best[~reached] == 0xFFFFFFFF)


def test_ungated_plain_match_against_jax():
    """The tracker's reference-keyframe match, 2048 map descriptors x 1000
    features (300 near copies), ratio 0.75, max 60, mutual: the port's
    plain `hamming_match` at radius +inf equals JAX `match_nn_ratio` on the
    reference's distance matrix with no gate."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (2048, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32)
    b[:300] = a[:300] ^ 1
    b[300:310] = a[300:310] ^ 3          # ties against the first copies
    va = rng.random(2048) < 0.8
    vb = np.ones(1000, bool)
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    idx, ok = M.hamming_match(ta, tb, torch.from_numpy(va),
                              torch.from_numpy(vb), torch.zeros(2048, 2),
                              torch.zeros(1000, 2), radius=math.inf,
                              max_dist=60.0, ratio=0.75)
    da = JM.unpack_u32_to_pm1(jnp.asarray(a))
    db = JM.unpack_u32_to_pm1(jnp.asarray(b))
    ji, jo = JM.match_nn_ratio(JM.hamming_matrix(da, db), jnp.asarray(va),
                               jnp.asarray(vb), None, max_dist=60.0,
                               ratio=0.75, mutual=True)
    jo = np.asarray(jo)
    assert np.array_equal(ok.numpy(), jo) and int(jo.sum()) > 100
    assert np.array_equal(idx.numpy()[jo], np.asarray(ji)[jo])
