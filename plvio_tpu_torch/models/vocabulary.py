"""Binary bag-of-words vocabulary (port of plvio_tpu/models/vocabulary.py:
`Vocabulary` :31, `random_vocabulary` :41, `transform` :88, `bow_vector`
:107, `l1_score` :116, `make_bow_pipeline` :122, `save` :135, `load` :147,
`default_vocabulary` :159; `train` :51 is not ported).

Level l of the tree is a centroid table [k^(l+1), 8] int32 in the port's
packed descriptor layout (ops/matching.py: bit j of word w is descriptor
bit 32w+j).  A descriptor descends through the depth levels, at each
taking the child of least Hamming distance among its node's k children
(the first on ties): the reference's argmax of the +-1 dot product, whose
integer dots are exact in float32.  The bag of words is the L1-normalized
histogram [k^depth] of a frame's word ids; the score of a query against a
bank of bags is DBoW2's L1 score 1 - |v - w|_1 / 2.

The plain versions unpack to +-1 and follow the reference.  On CUDA
tensors `bow_transform` (the descent and the bag in one launch) and
`bow_score` (the masked score of a query against a bank) are the
hand-written kernels of csrc/bow.cu.

The shipped vocabularies (`assets/{orb,lbd}voc.npz`, byte copies of the
JAX package's) store each level as `np.packbits` rows: MSB first within a
byte, descriptor bit i in bit 7 - i % 8 of byte i // 8.  `load` unpacks
them and repacks the bits LSB first into the port's words.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cuda
from ..ops.matching import unpack_u32_to_pm1

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets")


class Vocabulary(NamedTuple):
    centroids: tuple      # per level: [k^(l+1), 8] int32 packed
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.k ** self.depth


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """[n,256] {0,1} -> [n,8] int32 words, bit j of word w = bit 32w+j."""
    b = np.packbits(bits.astype(np.uint8).reshape(len(bits), 8, 32),
                    axis=-1, bitorder="little")
    return np.ascontiguousarray(b).view("<u4").reshape(len(bits), 8) \
        .view(np.int32)


def from_bits(levels, k: int, depth: int) -> Vocabulary:
    """A vocabulary from its levels as [k^(l+1), 256] {0,1} (or bool)."""
    return Vocabulary(tuple(torch.from_numpy(pack_bits_np(np.asarray(b)))
                            for b in levels), k, depth)


def random_vocabulary(seed: int = 0, k: int = 10, depth: int = 4
                      ) -> Vocabulary:
    """The reference's random tree: each level's +-1 centroids drawn with
    `default_rng(seed).choice([-1, 1])`, level by level."""
    rng = np.random.default_rng(seed)
    levels = []
    for l in range(depth):
        c = rng.choice([-1.0, 1.0], size=(k ** (l + 1), 256))
        levels.append(c > 0)
    return from_bits(levels, k, depth)


def save(voc: Vocabulary, path: str) -> None:
    """The reference's file format: each level as np.packbits rows."""
    arrays = {}
    for l, C in enumerate(voc.centroids):
        bits = (unpack_u32_to_pm1(C.cpu()).numpy() > 0).astype(np.uint8)
        arrays[f"level_{l}"] = np.packbits(bits, axis=-1)
    np.savez_compressed(path, k=voc.k, depth=voc.depth, **arrays)


def load(path: str) -> Vocabulary:
    z = np.load(path)
    k, depth = int(z["k"]), int(z["depth"])
    levels = [np.unpackbits(z[f"level_{l}"], axis=-1)[:, :256]
              for l in range(depth)]
    return from_bits(levels, k, depth)


def default_vocabulary(kind: str = "orb", seed: int = 0) -> Vocabulary:
    """The shipped trained vocabulary (`assets/{kind}voc.npz`), or the
    reference's deterministic random one when the file is absent."""
    path = os.path.join(ASSETS, f"{kind}voc.npz")
    if os.path.exists(path):
        return load(path)
    return random_vocabulary(seed=seed, k=10, depth=4)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def transform(voc: Vocabulary, desc_packed: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Descriptors [N,8] int32 packed -> word ids [N] int32 (-1 where not
    valid): the reference's descent by +-1 dot products, first index on
    ties (torch.argmax's rule, as jnp.argmax)."""
    d = unpack_u32_to_pm1(desc_packed)
    node = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    kk = torch.arange(voc.k, device=d.device)
    for l in range(voc.depth):
        C = unpack_u32_to_pm1(voc.centroids[l].to(d.device))
        cand = node[:, None] * voc.k + kk[None, :]
        dots = torch.einsum("nd,nkd->nk", d, C[cand])
        node = node * voc.k + torch.argmax(dots, dim=1)
    return torch.where(valid, node, torch.full_like(node, -1)).to(
        torch.int32)


def bow_vector(voc: Vocabulary, word_ids: torch.Tensor) -> torch.Tensor:
    """Word ids [N] -> the L1-normalized histogram [n_words] float32,
    h / max(sum h, 1e-9), divided by a tensor (eager CUDA divides by a
    Python scalar through its reciprocal, an ulp off the kernel)."""
    W = voc.n_words
    ok = word_ids >= 0
    safe = torch.clamp(word_ids.long(), 0, W - 1)
    h = torch.zeros(W, dtype=torch.float32, device=word_ids.device)
    h.index_add_(0, safe, ok.to(torch.float32))
    return h / torch.clamp_min(h.sum(), 1e-9)


def l1_score(v: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 score of a query v [W] against a bank ws [K,W]:
    1 - |v - w|_1 / 2, in [0, 1], and exactly 0 for a row that shares no
    word with v (DBoW2 sums over the shared words only; the L1 form would
    leave the rounding of 1 - 2 / 2 there, whose sign the database's
    `scores > 0` reads)."""
    vb = v[None, :]
    shared = ((vb > 0) & (ws > 0)).any(dim=-1)
    s = 1.0 - 0.5 * torch.sum(torch.abs(vb - ws), dim=-1)
    return torch.where(shared, s, torch.zeros_like(s))


def score_plain(v: torch.Tensor, ws: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Plain version of `bow_score`: the L1 score, -1 where not mask."""
    return torch.where(mask, l1_score(v, ws), torch.full_like(ws[:, 0], -1.0))


# --------------------------------------------------------------------------
# Kernels: bow_transform, bow_score (csrc/bow.cu)
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
BOW_TRANSFORM = cuda.Kernel("bow", "bow_transform",
                            [_P, _I, _I, _P, _P, _I, _P, _P, _P])
BOW_SCORE = cuda.Kernel("bow", "bow_score",
                        [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P])


def packed_levels(voc: Vocabulary, device) -> torch.Tensor:
    """Every level's centroids in one [sum k^(l+1), 8] int32 table."""
    return torch.cat([c.to(device) for c in voc.centroids]).contiguous()


def bow_transform(table: torch.Tensor, k: int, depth: int,
                  desc_packed: torch.Tensor, valid: torch.Tensor,
                  ids_out: Optional[torch.Tensor] = None,
                  bow_out: Optional[torch.Tensor] = None):
    """The descent and the bag of words of one frame in one launch of
    csrc/bow.cu: table [sum k^(l+1), 8] int32 (`packed_levels`),
    desc_packed [N,8] int32, valid [N] bool -> (word ids [N] int32, bow
    [k^depth] float32), written into ids_out / bow_out where given (a
    row of a keyframe database's bank).  CUDA tensors only."""
    W = k ** depth
    dev = desc_packed.device
    n = desc_packed.shape[0]
    if ids_out is None:
        ids_out = torch.empty(n, dtype=torch.int32, device=dev)
    if bow_out is None:
        bow_out = torch.empty(W, dtype=torch.float32, device=dev)
    cuda.check_cuda("bow_transform", table, desc_packed, valid, ids_out,
                    bow_out)
    rows = sum(k ** (l + 1) for l in range(depth))
    if table.dtype != torch.int32 or table.shape != (rows, 8) \
            or desc_packed.dtype != torch.int32 \
            or desc_packed.shape != (n, 8) or valid.dtype != torch.bool \
            or valid.shape != (n,) or ids_out.dtype != torch.int32 \
            or ids_out.shape != (n,) or bow_out.dtype != torch.float32 \
            or bow_out.shape != (W,):
        raise ValueError("bow_transform: table [rows,8] int32, desc [N,8] "
                         "int32, valid [N] bool, ids [N] int32, bow [W] "
                         "float32")
    if not (2 <= k <= 32) or W > 40000:
        raise ValueError("bow_transform: needs 2 <= k <= 32 and at most "
                         "40000 words (the histogram lives in shared "
                         "memory)")
    BOW_TRANSFORM.launch(cuda.ptr(table), k, depth, cuda.ptr(desc_packed),
                         cuda.ptr(valid), n, cuda.ptr(ids_out),
                         cuda.ptr(bow_out), cuda.stream())
    return ids_out, bow_out


def _check_score(v, bank, mask):
    """Raise unless v [W] / bank [K,W] float32 and mask [K] bool are
    contiguous on one CUDA device."""
    dev = v.device
    K, W = bank.shape
    if dev.type != "cuda" or bank.device != dev or mask.device != dev \
            or not (v.is_contiguous() and bank.is_contiguous()
                    and mask.is_contiguous()):
        cuda.check_cuda("bow_score", v, bank, mask)
    if v.dtype != torch.float32 or bank.dtype != torch.float32 \
            or v.shape != (W,) or mask.dtype != torch.bool \
            or mask.shape != (K,):
        raise ValueError("bow_score: v [W] / bank [K,W] float32, mask [K] "
                         "bool")


def bow_score(v: torch.Tensor, bank: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 scores [K] float32 of a query v [W] against bank [K,W]
    (-1 where not mask), |v - w| summed in a fixed order.  CPU tensors
    take the plain version; CUDA tensors launch csrc/bow.cu."""
    if v.device.type == "cpu":
        return score_plain(v, bank, mask)
    _check_score(v, bank, mask)
    K, W = bank.shape
    out = torch.empty(K, dtype=torch.float32, device=v.device)
    if K:
        BOW_SCORE.launch(v.data_ptr(), bank.data_ptr(), mask.data_ptr(), K,
                         W, None, None, None, 0, out.data_ptr(),
                         cuda.stream(v.device.index))
    return out


def score_pair_plain(v, bank, mask, v_l, bank_l, mask_l) -> torch.Tensor:
    """Plain version of `bow_score_pair`: `score_plain` on each bank."""
    return torch.stack([score_plain(v, bank, mask),
                        score_plain(v_l, bank_l, mask_l)])


def bow_score_pair(v, bank, mask, v_l, bank_l, mask_l) -> torch.Tensor:
    """A query's point and line bags against the keyframe database's two
    banks (bank [K,W], bank_l [K,W_l]) in one launch of csrc/bow.cu:
    scores [2,K] float32, -1 where the masks are off.  CPU tensors take
    the plain version."""
    if v.device.type == "cpu":
        return score_pair_plain(v, bank, mask, v_l, bank_l, mask_l)
    _check_score(v, bank, mask)
    _check_score(v_l, bank_l, mask_l)
    K, W = bank.shape
    if bank_l.shape[0] != K or v_l.device != v.device:
        raise ValueError("bow_score_pair: both banks [K,*] on one device")
    out = torch.empty(2, K, dtype=torch.float32, device=v.device)
    if K:
        BOW_SCORE.launch(v.data_ptr(), bank.data_ptr(), mask.data_ptr(), K,
                         W, v_l.data_ptr(), bank_l.data_ptr(),
                         mask_l.data_ptr(), bank_l.shape[1], out.data_ptr(),
                         cuda.stream(v.device.index))
    return out


class BowPipeline:
    """`make_bow_pipeline`'s callable: (desc_packed [N,8] int32, valid [N]
    bool) -> (word ids [N] int32, bow [W] float32), on the kernel for
    CUDA tensors (into given bank rows `ids_out` / `bow_out`), on the
    plain versions for CPU tensors or with `plain`."""

    def __init__(self, voc: Vocabulary, plain: bool = False):
        self.voc = voc
        self.plain = plain
        self._tables = {}

    def table(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._tables:
            self._tables[key] = packed_levels(self.voc, device)
        return self._tables[key]

    def __call__(self, desc_packed, valid, ids_out=None, bow_out=None):
        if self.plain or desc_packed.device.type == "cpu":
            wid = transform(self.voc, desc_packed, valid)
            bow = bow_vector(self.voc, wid)
            if ids_out is not None:
                ids_out.copy_(wid)
                wid = ids_out
            if bow_out is not None:
                bow_out.copy_(bow)
                bow = bow_out
            return wid, bow
        return bow_transform(self.table(desc_packed.device), self.voc.k,
                             self.voc.depth, desc_packed.contiguous(),
                             valid.contiguous(), ids_out, bow_out)


def make_bow_pipeline(voc: Vocabulary, n_feat: int,
                      plain: bool = False) -> BowPipeline:
    """(desc_packed [N,8] int32, valid [N]) -> (word_ids [N], bow [W]);
    n_feat is the reference's signature's (any N is taken)."""
    return BowPipeline(voc, plain)
