"""Keyframe database: bag-of-words retrieval for relocalization (port of
plvio_tpu/models/kfdb.py: `KeyFrameDatabase` :22-172, with its line
bank mixed in at LINE_W, and `AtlasKeyFrameDatabase` :175-237).

The banks live on the device: bags [max_kf, W] float32 and word ids
[max_kf, n_feat] int32.  `add_keyframe` runs the keyframe's descriptors
through the vocabulary (`bow_transform` on the card) straight into its
bank rows; a query scores its bag (and its line bag, where it has one)
against the whole bank in one launch (`bow_score`, `bow_score_pair`) and
reads back the scores.  (The reference keeps the bank
in host memory and uploads all of it on every query.)  Which rows hold a
keyframe (`present`, `has_lines`) and the ranking of the scores stay on
the host, as in the reference, and so does the covisibility-group sum of
`query_grouped` (a host matvec).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..cuda import HostIO, resolve_device
from . import vocabulary as V


class KeyFrameDatabase(HostIO):
    """With `line_voc` given, a second bank of line (LBD) bags is kept, and
    a query that carries >= 5 valid segments scores s + LINE_W max(s_l, 0)
    against the keyframes that have one."""

    LINE_W = 0.3

    def __init__(self, voc: V.Vocabulary, max_kf: int, n_feat: int,
                 line_voc: V.Vocabulary = None, n_line_feat: int = 0,
                 device="cuda", plain: bool = False):
        self.device = resolve_device(device)
        self.plain = plain
        self.host_syncs = 0
        self.voc = voc
        self.max_kf = max_kf
        self.n_feat = n_feat
        dev = self.device
        self.bows = torch.zeros(max_kf, voc.n_words, dtype=torch.float32,
                                device=dev)
        self.word_ids = torch.full((max_kf, n_feat), -1, dtype=torch.int32,
                                   device=dev)
        self.present = np.zeros(max_kf, bool)
        self._pipeline = V.make_bow_pipeline(voc, n_feat, plain)
        self._score = V.score_plain if plain else V.bow_score
        self._score_pair = V.score_pair_plain if plain else V.bow_score_pair
        self.line_voc = line_voc
        if line_voc is not None:
            self.bows_l = torch.zeros(max_kf, line_voc.n_words,
                                      dtype=torch.float32, device=dev)
            self.has_lines = np.zeros(max_kf, bool)
            self._pipeline_l = V.make_bow_pipeline(line_voc, n_line_feat,
                                                   plain)

    def _t(self, a, dtype=None) -> torch.Tensor:
        """An array or tensor on the database's device."""
        if torch.is_tensor(a):
            return a.to(self.device)
        return self._dev(np.asarray(a) if dtype is None
                         else np.asarray(a, dtype))

    def _n_valid(self, valid) -> int:
        if torch.is_tensor(valid):
            return int(self._host(valid.sum()))
        return int(np.asarray(valid).sum())

    def add_keyframe(self, kf: int, desc_packed, valid, line_desc=None,
                     line_valid=None) -> torch.Tensor:
        """The keyframe's word ids and bag into its bank rows (and its line
        bag where it has >= 5 valid segments).  desc_packed [n_feat,8]
        uint32 / int32 and valid [n_feat] bool, numpy or tensors.  Returns
        the bank's word id row."""
        self._pipeline(self._t(desc_packed), self._t(valid, bool),
                       ids_out=self.word_ids[kf], bow_out=self.bows[kf])
        self.present[kf] = True
        if self.line_voc is not None and line_desc is not None \
                and line_valid is not None and self._n_valid(line_valid) >= 5:
            self._pipeline_l(self._t(line_desc), self._t(line_valid, bool),
                             bow_out=self.bows_l[kf])
            self.has_lines[kf] = True
        return self.word_ids[kf]

    def remove_keyframe(self, kf: int) -> None:
        self.present[kf] = False
        self.bows[kf] = 0
        if self.line_voc is not None:
            self.bows_l[kf] = 0
            self.has_lines[kf] = False

    def _combined_scores(self, desc_packed, valid, mask, line_desc=None,
                         line_valid=None) -> np.ndarray:
        """Masked L1 scores [max_kf] float32 of a query against the whole
        bank, line-word augmented when both sides carry line data."""
        _, bow = self._pipeline(self._t(desc_packed), self._t(valid, bool))
        lines = self.line_voc is not None and line_desc is not None \
            and line_valid is not None and self._n_valid(line_valid) >= 5
        if lines:
            _, bow_l = self._pipeline_l(self._t(line_desc),
                                        self._t(line_valid, bool))
            scores = self._score_pair(bow, self.bows, self._t(mask), bow_l,
                                      self.bows_l,
                                      self._t(mask & self.has_lines))
        else:
            scores = self._score(bow, self.bows, self._t(mask))[None]
        if scores.device.type == "cpu":
            got = scores.numpy()
        else:
            self.host_syncs += 1
            got = scores.cpu().numpy()
        if lines:
            return got[0] + self.LINE_W * np.maximum(got[1], 0.0)
        return got[0]

    def query(self, desc_packed, valid, exclude: np.ndarray = None,
              top_n: int = 3, min_rel_score: float = 0.75, line_desc=None,
              line_valid=None) -> Tuple[np.ndarray, np.ndarray]:
        """Best-matching keyframes for a query frame: up to top_n of the
        best 3 top_n scores above 0 and above min_rel_score x the best.
        Returns (kf_ids, scores)."""
        mask = self.present.copy()
        if exclude is not None:
            mask &= ~exclude
        scores = self._combined_scores(desc_packed, valid, mask, line_desc,
                                       line_valid)
        order = np.argsort(-scores)[:top_n * 3]
        order = order[scores[order] > 0]
        if len(order) == 0:
            return np.zeros(0, np.int64), np.zeros(0)
        best = scores[order[0]]
        keep = order[scores[order] >= min_rel_score * best][:top_n]
        return keep, scores[keep]

    def copy_row_from(self, other: "KeyFrameDatabase", old_kf: int,
                      new_kf: int) -> None:
        self.bows[new_kf] = other.bows[old_kf].to(self.device)
        self.word_ids[new_kf] = other.word_ids[old_kf].to(self.device)
        self.present[new_kf] = True
        if self.line_voc is not None and other.line_voc is not None:
            self.bows_l[new_kf] = other.bows_l[old_kf].to(self.device)
            self.has_lines[new_kf] = other.has_lines[old_kf]

    def query_grouped(self, desc_packed, valid, covis: np.ndarray,
                      kf_valid: np.ndarray, exclude: np.ndarray = None,
                      top_n: int = 3, line_desc=None, line_valid=None):
        """Covisibility-group accumulated scoring: each candidate's score
        plus its covisible (>= 15 shared) members' scores, the best
        top_n candidates (a host matvec)."""
        mask = self.present & kf_valid
        if exclude is not None:
            mask = mask & ~exclude
        scores = self._combined_scores(desc_packed, valid, mask, line_desc,
                                       line_valid)
        cands = np.nonzero(scores > 0)[0]
        if len(cands) == 0:
            return np.zeros(0, np.int64), np.zeros(0)
        group_mat = (covis[cands] >= 15) & mask[None, :]
        group_scores = scores[cands] + group_mat @ scores
        order = np.argsort(-group_scores)[:top_n]
        return cands[order], group_scores[order]


class AtlasKeyFrameDatabase:
    """One keyframe database per map of an Atlas (keyframe slots are per
    map store); every method defaults to the Atlas' active map."""

    def __init__(self, voc: V.Vocabulary, max_kf: int, n_feat: int, atlas,
                 line_voc: V.Vocabulary = None, n_line_feat: int = 0,
                 device="cuda", plain: bool = False):
        self.voc = voc
        self.max_kf = max_kf
        self.n_feat = n_feat
        self.atlas = atlas
        self.line_voc = line_voc
        self.n_line_feat = n_line_feat
        self.device = resolve_device(device)
        self.plain = plain
        self._dbs = {}

    @property
    def host_syncs(self) -> int:
        return sum(db.host_syncs for db in self._dbs.values())

    def db(self, map_id: int = None) -> KeyFrameDatabase:
        if map_id is None:
            map_id = self.atlas.current.map_id
        if map_id not in self._dbs:
            self._dbs[map_id] = KeyFrameDatabase(
                self.voc, self.max_kf, self.n_feat, line_voc=self.line_voc,
                n_line_feat=self.n_line_feat, device=self.device,
                plain=self.plain)
        return self._dbs[map_id]

    def add_keyframe(self, kf, desc_packed, valid, map_id=None,
                     line_desc=None, line_valid=None):
        return self.db(map_id).add_keyframe(kf, desc_packed, valid,
                                            line_desc, line_valid)

    def rebuild(self):
        """Every map's bank from the Atlas' stored keyframe descriptors."""
        self._dbs = {}
        for m in self.atlas.maps:
            db = self.db(m.map_id)
            for kf in m.valid_kf_indices():
                ld = lv = None
                if self.line_voc is not None \
                        and hasattr(m, "kf_line_desc"):
                    ld = m.kf_line_desc[kf]
                    lv = m.kf_line_valid[kf]
                db.add_keyframe(int(kf), m.kf_feat_desc[kf],
                                m.kf_feat_valid[kf], ld, lv)

    def remove_keyframe(self, kf, map_id=None):
        self.db(map_id).remove_keyframe(kf)

    def query(self, desc_packed, valid, exclude=None, top_n=3,
              min_rel_score=0.75, map_id=None, line_desc=None,
              line_valid=None):
        return self.db(map_id).query(desc_packed, valid, exclude, top_n,
                                     min_rel_score, line_desc, line_valid)

    def query_grouped(self, desc_packed, valid, covis, kf_valid,
                      exclude=None, top_n=3, map_id=None, line_desc=None,
                      line_valid=None):
        return self.db(map_id).query_grouped(desc_packed, valid, covis,
                                             kf_valid, exclude, top_n,
                                             line_desc, line_valid)

    def query_other_maps(self, desc_packed, valid, cur_map_id, top_n=3):
        """Best candidates from every map but cur_map_id, ranked together:
        [(map_id, kf, score), ...]."""
        out = []
        for m in self.atlas.maps:
            mid = m.map_id
            if mid == cur_map_id or mid not in self._dbs:
                continue
            kfs, scores = self._dbs[mid].query(desc_packed, valid,
                                               top_n=top_n)
            out.extend((mid, int(k), float(s))
                       for k, s in zip(kfs, scores) if m.kf_valid[int(k)])
        out.sort(key=lambda x: -x[2])
        return out[:top_n]

    def merge_maps(self, from_id: int, to_id: int,
                   kf_map: np.ndarray) -> None:
        """Move from_id's rows into to_id under the slot remap kf_map."""
        if from_id not in self._dbs:
            return
        src = self._dbs.pop(from_id)
        dst = self.db(to_id)
        for old in np.nonzero(src.present)[0]:
            new = int(kf_map[old])
            if new >= 0:
                dst.copy_row_from(src, int(old), new)
