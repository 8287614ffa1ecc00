"""The keyframe step's neighbourhood work on the local mapper (port of
plvio_tpu/models/local_mapping.py: `LocalMapper` with `create_new_lines`
:541, `_median_depth` :685, `search_in_neighbors` :329, `_fuse_into`
:263, `_replace_point` :244 and `local_ba` :697).

The host bookkeeping is the reference's, line for line, on the port's
numpy `MapStore`; only the device calls differ: the line pair matcher
(the `hamming_match` kernel's line pair mode), the line triangulator
(csrc/line_triangulate.cu), the fuse's projection matcher
(csrc/proj_match.cu) and the windowed BAs (csrc/ba_linearize.cu +
csrc/schur_solve.cu, point-only or point+line).  Kernel inputs go to the
mapper's device; their outputs come back to numpy where the reference
calls `np.asarray`, and each such read is counted in `host_syncs`.
`plain=True` runs the kernels' plain PyTorch versions on any device.
Each device call depends on the bookkeeping of the calls before it
(lines bound by earlier neighbours, points merged away by earlier
fusions), so the calls are not batched.
"""
from __future__ import annotations

import numpy as np

from ..cuda import HostIO, resolve_device
from ..solver.residuals import PinholeK
from . import kernels as KN
from .mapstore import INVALID, MapStore


class LocalMapper(HostIO):
    """The local mapper's neighbourhood methods at production's caps
    (models/local_mapping.py:31-34, 71, 87-90: the point BA window
    `ba_kf_cap` x `ba_pt_cap` x `ba_obs_cap`, 512 lines x 1024 line
    observations, fuse cap 2048), in the configuration the port runs:
    pinhole camera, lines on; `map` is the store they work on.  The
    culling that reads the reference's `recent_lns` is not ported, so the
    list is not kept."""

    def __init__(self, K: PinholeK, ba_kf_cap: int = 16,
                 ba_pt_cap: int = 4096, ba_obs_cap: int = 8192,
                 slam_mode: int = 0, device="cuda", plain: bool = False):
        self.device = resolve_device(device)
        self.ba_kf_cap = ba_kf_cap
        self.ba_pt_cap = ba_pt_cap
        self.ba_obs_cap = ba_obs_cap
        self.local_ba_kernel = KN.make_local_ba(K, plain=plain)
        self.fuse_cap = 2048
        self.fuse_match = KN.make_projection_matcher(K, plain=plain)
        self.n_fused = 0
        self.ba_ln_cap = 512
        self.ba_lobs_cap = 1024
        self.line_pair_match = KN.make_line_pair_matcher(plain=plain)
        self.line_triangulate = KN.make_line_triangulator(K, plain=plain)
        self.local_ba_pl_kernel = KN.make_local_ba_pl(K, plain=plain)
        self.slam_mode = int(slam_mode)
        self.map: MapStore = None
        # what the last calls did: features bound, landmarks merged and
        # merges refused by the 3D check in the fuse, the BA's path and LM
        # iterations per round, and the device-to-host reads
        self.n_bound = 0
        self.n_merged = 0
        self.n_refused = 0
        self.ba_path = None
        self.ba_stats: list = []
        self.host_syncs = 0

    # ------------------------------------------------------------------
    # Duplicate-landmark fusion
    # ------------------------------------------------------------------
    def _replace_point(self, drop: int, keep: int) -> None:
        """Rebind every observation of `drop` to `keep` (skipping keyframes
        that already observe `keep`) and absorb its statistics."""
        m = self.map
        kfs = m.valid_kf_indices()
        rl, cols = np.nonzero(m.kf_match_pt[kfs] == drop)
        rows = kfs[rl]
        for r, c in zip(rows, cols):
            if (m.kf_match_pt[r] == keep).any():
                m.kf_match_pt[r, c] = INVALID
            else:
                m.kf_match_pt[r, c] = keep
                m.pt_n_obs[keep] += 1
        m.pt_found[keep] += m.pt_found[drop]
        m.pt_visible[keep] += m.pt_visible[drop]
        m.pt_valid[drop] = False
        m.n_pt -= 1

    def _fuse_into(self, target_kf: int, pt_ids: np.ndarray) -> int:
        """Project candidate map points into `target_kf`; bind unbound
        feature matches as new observations, and merge two landmarks that
        a matched feature binds to different points when they coincide in
        3D (keep the better-observed one)."""
        m = self.map
        cap = self.fuse_cap
        ids = pt_ids[:cap]
        n = len(ids)
        if n == 0:
            return 0
        xyz = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        live = np.zeros(cap, bool)
        xyz[:n] = m.pt_xyz[ids]
        desc[:n] = m.pt_desc[ids]
        live[:n] = m.pt_valid[ids]
        _, pt_feat, matched, _ = self.fuse_match(
            self._dev(m.kf_pose_cw[target_kf]), self._dev(xyz),
            self._dev(desc), self._dev(live),
            self._dev(m.kf_feat_uv[target_kf]),
            self._dev(m.kf_feat_desc[target_kf]),
            self._dev(m.kf_feat_octave[target_kf]),
            self._dev(m.kf_feat_valid[target_kf]), 2.0, 50.0)
        matched = self._host(matched)
        pt_feat = self._host(pt_feat)
        row = m.kf_match_pt[target_kf]
        bound = np.zeros(m.max_pts, bool)
        bound[row[row >= 0]] = True
        R_t = m.kf_pose_cw[target_kf, :, :3]
        t_t = m.kf_pose_cw[target_kf, :, 3]
        n_fused = 0
        for slot in np.nonzero(matched[:n])[0]:
            p = int(ids[slot])
            f = int(pt_feat[slot])
            if not m.pt_valid[p]:
                continue            # merged away earlier in this loop
            cur = int(m.kf_match_pt[target_kf, f])
            if cur == p:
                continue
            if cur == INVALID:
                if bound[p]:
                    continue        # p already observed on another feature
                m.kf_match_pt[target_kf, f] = p
                m.pt_n_obs[p] += 1
                bound[p] = True
                n_fused += 1
                self.n_bound += 1
            elif m.pt_valid[cur]:
                # merge only when the two landmarks coincide in 3D
                # (relative to depth)
                z = float(R_t[2] @ m.pt_xyz[p] + t_t[2])
                if np.linalg.norm(m.pt_xyz[p] - m.pt_xyz[cur]) \
                        > 0.02 * max(z, 0.5):
                    self.n_refused += 1
                    continue
                keep, drop = ((cur, p) if m.pt_n_obs[cur] >= m.pt_n_obs[p]
                              else (p, cur))
                self._replace_point(drop, keep)
                n_fused += 1
                self.n_merged += 1
        return n_fused

    def search_in_neighbors(self, kf: int) -> None:
        """Two-hop duplicate fusion around the new keyframe: the
        neighbourhood's points into it, then its points into each of the
        first 10 neighbours."""
        m = self.map
        n1 = [int(x) for x in m.covisible_kfs(kf, n=10, min_weight=5)
              if m.kf_valid[x]]
        ext = list(n1)
        for nb in n1:
            for y in m.covisible_kfs(nb, n=5, min_weight=5):
                y = int(y)
                if y != kf and m.kf_valid[y] and y not in ext:
                    ext.append(y)
        if not ext:
            return
        # forward: neighborhood points into the new KF
        cand = np.unique(m.kf_match_pt[ext])
        cand = cand[cand >= 0]
        cand = cand[m.pt_valid[cand]]
        fused = self._fuse_into(kf, cand)
        # backward: the new KF's points into each neighbor
        own = m.kf_match_pt[kf]
        own_ids = own[own >= 0]
        own_ids = own_ids[m.pt_valid[own_ids]]
        for nb in ext[:10]:
            fused += self._fuse_into(nb, own_ids)
        self.n_fused += fused
        if fused:
            m.update_covisibility(kf)

    # ------------------------------------------------------------------
    # New map lines
    # ------------------------------------------------------------------
    def create_new_lines(self, kf: int) -> None:
        """Triangulate unmatched line observations of `kf` against the
        best covisible keyframes by interpretation-plane intersection."""
        m = self.map
        neighbors = m.covisible_kfs(kf, n=10, min_weight=5)

        def angles(ep):
            return np.arctan2(ep[:, 3] - ep[:, 1],
                              ep[:, 2] - ep[:, 0]) % np.pi

        ep_k = m.kf_line_ep[kf]
        ang_k = angles(ep_k)
        C_k = -m.kf_pose_cw[kf, :, :3].T @ m.kf_pose_cw[kf, :, 3]
        for nb in neighbors:
            if not m.kf_valid[nb]:
                continue
            C_n = -m.kf_pose_cw[nb, :, :3].T @ m.kf_pose_cw[nb, :, 3]
            med_depth = self._median_depth(nb)
            if med_depth <= 0 or np.linalg.norm(C_k - C_n) / med_depth < 0.01:
                continue
            free_k = m.kf_line_valid[kf] & (m.kf_match_ln[kf] == INVALID)
            free_n = m.kf_line_valid[nb] & (m.kf_match_ln[nb] == INVALID)
            if free_k.sum() == 0 or free_n.sum() == 0:
                continue
            ep_n = m.kf_line_ep[nb]
            idx_k, ok = self.line_pair_match(
                self._dev(ep_n), self._dev(m.kf_line_desc[nb]),
                self._dev(angles(ep_n).astype(np.float32)),
                self._dev(free_n), self._dev(ep_k),
                self._dev(m.kf_line_desc[kf]),
                self._dev(ang_k.astype(np.float32)), self._dev(free_k))
            ok_np = self._host(ok)
            if ok_np.sum() == 0:
                continue
            idx_np = self._host(idx_k)
            ep2 = ep_k[idx_np]
            Xs_w, Xe_w, good = self.line_triangulate(
                self._dev(m.kf_pose_cw[nb]), self._dev(m.kf_pose_cw[kf]),
                self._dev(ep_n), self._dev(ep2), ok)
            good_np = self._host(good)
            if good_np.sum() == 0:
                continue
            f1 = np.nonzero(good_np)[0]
            f2 = idx_np[good_np]
            fresh = m.kf_match_ln[kf][f2] == INVALID
            f1, f2 = f1[fresh], f2[fresh]
            if len(f1) == 0:
                continue
            lns = m.alloc_lines(len(f1))
            nn = len(lns)
            f1, f2 = f1[:nn], f2[:nn]
            Xs_np = self._host(Xs_w)
            Xe_np = self._host(Xe_w)
            m.ln_ep[lns] = np.concatenate([Xs_np[f1], Xe_np[f1]], -1)
            m.ln_desc[lns] = m.kf_line_desc[kf][f2]
            m.ln_first_kf[lns] = kf
            m.ln_n_obs[lns] = 2
            m.ln_found[lns] = 2
            m.ln_visible[lns] = 2
            m.kf_match_ln[nb, f1] = lns
            m.kf_match_ln[kf, f2] = lns

    def _median_depth(self, kf: int) -> float:
        m = self.map
        pts = m.kf_match_pt[kf]
        pts = pts[pts >= 0]
        if len(pts) == 0:
            return -1.0
        X = m.pt_xyz[pts]
        R, t = m.kf_pose_cw[kf, :, :3], m.kf_pose_cw[kf, :, 3]
        z = (R @ X.T).T[:, 2] + t[2]
        return float(np.median(z))

    # ------------------------------------------------------------------
    def local_ba(self, kf: int) -> None:
        """Windowed BA: covisible KFs free, their observers fixed, points
        (and multi-view lines) Schur-eliminated."""
        m = self.map
        window = m.covisible_kfs(kf, n=self.ba_kf_cap - 6, min_weight=5)
        window = np.concatenate([[kf], window[m.kf_valid[window]]])
        window = window[:self.ba_kf_cap]
        in_window = np.zeros(m.max_kf, bool)
        in_window[window] = True

        # points seen by the window
        pt_ids = np.unique(m.kf_match_pt[window])
        pt_ids = pt_ids[pt_ids >= 0]
        pt_ids = pt_ids[m.pt_valid[pt_ids]][:self.ba_pt_cap]
        pt_slot = np.full(m.max_pts, -1, np.int32)
        pt_slot[pt_ids] = np.arange(len(pt_ids))

        # fixed KFs: observers of those points outside the window
        fixed = []
        kf_slot = np.full(m.max_kf, -1, np.int32)
        slots = list(window)
        for i, w in enumerate(window):
            kf_slot[w] = i
        for other in m.valid_kf_indices():
            if in_window[other]:
                continue
            shared = np.isin(m.kf_match_pt[other], pt_ids) \
                & (m.kf_match_pt[other] >= 0)
            if shared.sum() > 0 and len(slots) < self.ba_kf_cap:
                kf_slot[other] = len(slots)
                slots.append(other)
                fixed.append(other)
        slots = np.asarray(slots)

        # gauge: always fix at least the oldest KF in the system
        free_mask = np.zeros(self.ba_kf_cap, bool)
        free_mask[:len(window)] = True
        if len(fixed) == 0:
            oldest = np.argmin(m.kf_timestamp[window])
            free_mask[oldest] = False

        # observation table
        obs_kf, obs_pt, obs_uv, obs_is2 = [], [], [], []
        for s, kfi in enumerate(slots):
            match = m.kf_match_pt[kfi]
            feat = np.nonzero((match >= 0) & np.isin(match, pt_ids))[0]
            obs_kf.append(np.full(len(feat), s, np.int32))
            obs_pt.append(pt_slot[match[feat]])
            obs_uv.append(m.kf_feat_uv[kfi, feat])
            obs_is2.append(1.0 / 1.2 ** (2.0 * m.kf_feat_octave[kfi, feat]))
        obs_kf = np.concatenate(obs_kf)[:self.ba_obs_cap]
        obs_pt = np.concatenate(obs_pt)[:self.ba_obs_cap]
        obs_uv = np.concatenate(obs_uv)[:self.ba_obs_cap]
        obs_is2 = np.concatenate(obs_is2)[:self.ba_obs_cap]
        n_obs = len(obs_kf)

        def pad(a, cap, fill=0):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:len(a)] = a
            return out

        kf_poses = np.tile(np.eye(3, 4, dtype=np.float32),
                           (self.ba_kf_cap, 1, 1))
        kf_poses[:len(slots)] = m.kf_pose_cw[slots]
        pt_xyz = np.zeros((self.ba_pt_cap, 3), np.float32)
        pt_xyz[:len(pt_ids)] = m.pt_xyz[pt_ids]
        pt_free = np.zeros(self.ba_pt_cap, bool)
        pt_free[:len(pt_ids)] = True

        ln_ids = np.unique(m.kf_match_ln[window])
        ln_ids = ln_ids[ln_ids >= 0]
        ln_ids = ln_ids[m.ln_valid[ln_ids]]
        # only multi-view-confirmed lines optimize poses
        ln_ids = ln_ids[m.ln_n_obs[ln_ids] >= 3][:self.ba_ln_cap]
        use_pl = len(ln_ids) >= 8
        if use_pl:
            ln_slot = np.full(m.max_lines, -1, np.int32)
            ln_slot[ln_ids] = np.arange(len(ln_ids))
            lobs_kf, lobs_ln, lobs_eq = [], [], []
            for s, kfi in enumerate(slots):
                match = m.kf_match_ln[kfi]
                feat = np.nonzero((match >= 0) & np.isin(match, ln_ids))[0]
                if len(feat) == 0:
                    continue
                lobs_kf.append(np.full(len(feat), s, np.int32))
                lobs_ln.append(ln_slot[match[feat]])
                ep = m.kf_line_ep[kfi, feat]
                sp = np.concatenate([ep[:, :2], np.ones((len(ep), 1))], 1)
                e_ = np.concatenate([ep[:, 2:], np.ones((len(ep), 1))], 1)
                l = np.cross(sp, e_)
                l /= np.maximum(np.linalg.norm(l[:, :2], axis=1,
                                               keepdims=True), 1e-9)
                lobs_eq.append(l.astype(np.float32))
            lobs_kf = np.concatenate(lobs_kf)[:self.ba_lobs_cap]
            lobs_ln = np.concatenate(lobs_ln)[:self.ba_lobs_cap]
            lobs_eq = np.concatenate(lobs_eq)[:self.ba_lobs_cap]
            n_lobs = len(lobs_kf)
            ln_ep6 = np.zeros((self.ba_ln_cap, 6), np.float32)
            ln_ep6[:len(ln_ids)] = m.ln_ep[ln_ids]
            ln_free = np.zeros(self.ba_ln_cap, bool)
            ln_free[:len(ln_ids)] = True
        d = self._dev
        self.ba_stats = []
        if use_pl and self.slam_mode in (1, 2, 3):
            raise NotImplementedError(
                "the line-only local BA of SLAM modes 1-3 "
                "(make_local_ba_lines_only) is not ported")
        elif use_pl:
            self.ba_path = "pl"
            (new_poses, new_pts, new_lns, inlier, _) = \
                self.local_ba_pl_kernel(
                    d(kf_poses), d(free_mask), d(pt_xyz), d(pt_free),
                    d(pad(obs_kf, self.ba_obs_cap)),
                    d(pad(obs_pt, self.ba_obs_cap)),
                    d(pad(obs_uv, self.ba_obs_cap)),
                    d(pad(np.ones(n_obs, bool), self.ba_obs_cap, False)),
                    d(pad(obs_is2.astype(np.float32), self.ba_obs_cap)),
                    d(ln_ep6), d(ln_free),
                    d(pad(lobs_kf, self.ba_lobs_cap)),
                    d(pad(lobs_ln, self.ba_lobs_cap)),
                    d(pad(lobs_eq, self.ba_lobs_cap)),
                    d(pad(np.ones(n_lobs, bool), self.ba_lobs_cap, False)),
                    d(pad(np.ones(n_lobs, np.float32), self.ba_lobs_cap)),
                    stats=self.ba_stats)
            m.ln_ep[ln_ids] = self._host(new_lns)[:len(ln_ids)]
        else:
            self.ba_path = "pt"
            new_poses, new_pts, inlier = self.local_ba_kernel(
                d(kf_poses), d(free_mask), d(pt_xyz), d(pt_free),
                d(pad(obs_kf, self.ba_obs_cap)),
                d(pad(obs_pt, self.ba_obs_cap)),
                d(pad(obs_uv, self.ba_obs_cap)),
                d(pad(np.ones(n_obs, bool), self.ba_obs_cap, False)),
                d(pad(obs_is2.astype(np.float32), self.ba_obs_cap)),
                stats=self.ba_stats)

        new_poses = self._host(new_poses)
        new_pts = self._host(new_pts)
        wr = free_mask[:len(slots)] \
            & np.isfinite(new_poses[:len(slots)]).all((1, 2))
        m.kf_pose_cw[slots[wr]] = new_poses[:len(slots)][wr]
        okp = np.isfinite(new_pts[:len(pt_ids)]).all(1)
        m.pt_xyz[pt_ids[okp]] = new_pts[:len(pt_ids)][okp]

        # drop observations judged outliers by the BA
        inlier_np = self._host(inlier)[:n_obs]
        bad = ~inlier_np
        if bad.any():
            for s, kfi in enumerate(slots):
                sel = (obs_kf == s) & bad
                if sel.any():
                    # find features bound to these points and unbind
                    bad_pts = pt_ids[obs_pt[sel]]
                    match = m.kf_match_pt[kfi]
                    unbind = np.isin(match, bad_pts)
                    m.kf_match_pt[kfi, unbind] = INVALID
                    m.pt_n_obs[bad_pts] -= 1
        # points that lost all observations are bad
        orphan = pt_ids[m.pt_n_obs[pt_ids] < 1]
        if len(orphan):
            m.remove_point(orphan)
