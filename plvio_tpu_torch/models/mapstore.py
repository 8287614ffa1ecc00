"""The struct-of-arrays map store, as far as the monocular bootstrap, the
tracker and the keyframe step touch it (port of
plvio_tpu/models/mapstore.py: the arrays and inertial fields of `MapStore.__init__` :27-105, `alloc_kf`
:108, `alloc_points` :117, `alloc_lines` :123, `add_observations` :130,
`update_covisibility` :140 (its numpy path :155-175), `covisible_kfs`
:177, `remove_point` :206, `remove_line` :215, `remove_keyframe` :223,
`valid_kf_indices` :245, `kf_chain` :248, `apply_scaled_rotation` :253,
`recompute_body_poses` :280, `set_cam_poses_from_body` :297, the loop
closer's `apply_sim3` :310, `absorb` :340 and `kf_centers` :407, the
tracker's `local_map_points` :189 and `local_map_lines` :198, and the
`Atlas` :413-435 with `create_new_map`).

Host-side numpy, as in the reference: fixed-capacity arrays with validity
masks, mutated only by the host bookkeeping of the local mapper; device
kernels receive copies of slices.  `state.mapstore_from_numpy` /
`mapstore_to_numpy` carry a store's arrays across.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

INVALID = -1

# every array of a store, by name (the layout of mapstore_to_numpy)
ARRAYS = (
    "kf_valid", "kf_timestamp", "kf_pose_cw", "kf_pose_wb", "kf_vel",
    "kf_bias_g", "kf_bias_a", "kf_feat_uv", "kf_feat_uv_raw",
    "kf_feat_octave", "kf_feat_angle", "kf_feat_desc", "kf_feat_valid",
    "kf_match_pt", "kf_line_ep", "kf_line_desc", "kf_line_valid",
    "kf_match_ln", "kf_prev", "kf_next", "pt_valid", "pt_xyz", "pt_desc",
    "pt_normal", "pt_min_dist", "pt_max_dist", "pt_first_kf", "pt_n_obs",
    "pt_found", "pt_visible", "ln_valid", "ln_ep", "ln_desc", "ln_first_kf",
    "ln_n_obs", "ln_found", "ln_visible", "covis")
# the scalars beside them
SCALARS = ("map_id", "max_kf", "max_pts", "max_lines", "n_feat",
           "n_line_feat", "n_kf", "n_pt", "n_ln", "change_index")
# the IMU initialization stages and the keyframes' inertial links (kf ->
# ops.imu.Preintegrated of numpy arrays; kf -> (gyro [K,3], acc [K,3], dt
# [K]) raw samples)
INERTIAL = ("imu_initialized", "imu_ba1", "imu_ba2", "kf_preint",
            "kf_imu_raw")


class MapStore:
    def __init__(self, max_kf: int = 512, max_pts: int = 16384,
                 max_lines: int = 2048, n_feat: int = 1024,
                 n_line_feat: int = 256, map_id: int = 0):
        self.map_id = map_id
        self.max_kf = max_kf
        self.max_pts = max_pts
        self.max_lines = max_lines
        self.n_feat = n_feat
        self.n_line_feat = n_line_feat

        # ---- keyframes -------------------------------------------------
        self.kf_valid = np.zeros(max_kf, bool)
        self.kf_timestamp = np.zeros(max_kf, np.float64)
        self.kf_pose_cw = np.tile(np.eye(3, 4, dtype=np.float32),
                                  (max_kf, 1, 1))
        self.kf_pose_wb = np.tile(np.eye(3, 4, dtype=np.float32),
                                  (max_kf, 1, 1))
        self.kf_vel = np.zeros((max_kf, 3), np.float32)
        self.kf_bias_g = np.zeros((max_kf, 3), np.float32)
        self.kf_bias_a = np.zeros((max_kf, 3), np.float32)
        self.kf_feat_uv = np.zeros((max_kf, n_feat, 2), np.float32)
        self.kf_feat_uv_raw = np.zeros((max_kf, n_feat, 2), np.float32)
        self.kf_feat_octave = np.zeros((max_kf, n_feat), np.int32)
        self.kf_feat_angle = np.zeros((max_kf, n_feat), np.float32)
        self.kf_feat_desc = np.zeros((max_kf, n_feat, 8), np.uint32)
        self.kf_feat_valid = np.zeros((max_kf, n_feat), bool)
        self.kf_match_pt = np.full((max_kf, n_feat), INVALID, np.int32)
        self.kf_line_ep = np.zeros((max_kf, n_line_feat, 4), np.float32)
        self.kf_line_desc = np.zeros((max_kf, n_line_feat, 8), np.uint32)
        self.kf_line_valid = np.zeros((max_kf, n_line_feat), bool)
        self.kf_match_ln = np.full((max_kf, n_line_feat), INVALID, np.int32)
        self.kf_prev = np.full(max_kf, INVALID, np.int32)
        self.kf_next = np.full(max_kf, INVALID, np.int32)
        self.n_kf = 0

        # ---- map points ------------------------------------------------
        self.pt_valid = np.zeros(max_pts, bool)
        self.pt_xyz = np.zeros((max_pts, 3), np.float32)
        self.pt_desc = np.zeros((max_pts, 8), np.uint32)
        self.pt_normal = np.zeros((max_pts, 3), np.float32)
        self.pt_min_dist = np.zeros(max_pts, np.float32)
        self.pt_max_dist = np.zeros(max_pts, np.float32)
        self.pt_first_kf = np.full(max_pts, INVALID, np.int32)
        self.pt_n_obs = np.zeros(max_pts, np.int32)
        self.pt_found = np.zeros(max_pts, np.int32)
        self.pt_visible = np.zeros(max_pts, np.int32)
        self.n_pt = 0

        # ---- map lines (3D endpoints) ----------------------------------
        self.ln_valid = np.zeros(max_lines, bool)
        self.ln_ep = np.zeros((max_lines, 6), np.float32)
        self.ln_desc = np.zeros((max_lines, 8), np.uint32)
        self.ln_first_kf = np.full(max_lines, INVALID, np.int32)
        self.ln_n_obs = np.zeros(max_lines, np.int32)
        self.ln_found = np.zeros(max_lines, np.int32)
        self.ln_visible = np.zeros(max_lines, np.int32)
        self.n_ln = 0

        # ---- covisibility (shared point and line observations) --------
        self.covis = np.zeros((max_kf, max_kf), np.int32)
        self.change_index = 0
        # IMU initialization stages
        self.imu_initialized = False
        self.imu_ba1 = False
        self.imu_ba2 = False
        # preintegration from the previous keyframe of the temporal chain,
        # and the raw samples for reintegration at new biases
        self.kf_preint = {}
        self.kf_imu_raw = {}

    # ------------------------------------------------------------------
    def alloc_kf(self) -> int:
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            raise RuntimeError("keyframe capacity exhausted")
        i = int(free[0])
        self.kf_valid[i] = True
        self.n_kf += 1
        return i

    def alloc_points(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.pt_valid)[0][:n]
        self.pt_valid[free] = True
        self.n_pt += len(free)
        return free

    def alloc_lines(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.ln_valid)[0][:n]
        self.ln_valid[free] = True
        self.n_ln += len(free)
        return free

    # ------------------------------------------------------------------
    def add_observations(self, kf: int, feat_idx: np.ndarray,
                         pt_idx: np.ndarray) -> None:
        """Bind features of keyframe `kf` to map points and update the
        covisibility."""
        self.kf_match_pt[kf, feat_idx] = pt_idx
        self.pt_n_obs[pt_idx] += 1
        self.update_covisibility(kf)
        self.change_index += 1

    def update_covisibility(self, kf: int) -> None:
        """Recompute the covisibility row and column of `kf` from shared
        point and line observations (the reference's numpy path; its
        native library, which the port does not load, counts the same)."""
        counts = np.zeros(self.max_kf, np.int32)
        pts = self.kf_match_pt[kf]
        pts = pts[pts >= 0]
        if len(pts):
            member = np.zeros(self.max_pts, bool)
            member[pts] = True
            all_m = self.kf_match_pt
            hit = (all_m >= 0) & member[np.clip(all_m, 0, self.max_pts - 1)]
            counts += hit.sum(axis=1, dtype=np.int32)
        lns = self.kf_match_ln[kf]
        lns = lns[lns >= 0]
        if len(lns):
            member = np.zeros(self.max_lines, bool)
            member[lns] = True
            all_l = self.kf_match_ln
            hit = (all_l >= 0) & member[np.clip(all_l, 0,
                                                self.max_lines - 1)]
            counts += hit.sum(axis=1, dtype=np.int32)
        counts[~self.kf_valid] = 0
        counts[kf] = 0
        self.covis[kf] = counts
        self.covis[:, kf] = counts

    def covisible_kfs(self, kf: int, n: int = 10,
                      min_weight: int = 15) -> np.ndarray:
        """Best covisible keyframes, by numpy's default (unstable) argsort
        of the negated weights, as the reference orders them."""
        w = self.covis[kf].copy()
        w[~self.kf_valid] = 0
        w[kf] = 0
        order = np.argsort(-w)
        out = order[w[order] >= min_weight][:n]
        if len(out) == 0:  # fall back to any connection
            out = order[w[order] > 0][:n]
        return out

    def local_map_points(self, kfs: np.ndarray, cap: int) -> np.ndarray:
        """The live points observed by `kfs`, in np.unique's (ascending)
        order, as a fixed-size index array (INVALID-padded, the first `cap`
        kept)."""
        ids = np.unique(self.kf_match_pt[kfs])
        ids = ids[(ids >= 0)
                  & self.pt_valid[np.clip(ids, 0, self.max_pts - 1)]]
        out = np.full(cap, INVALID, np.int32)
        out[:min(len(ids), cap)] = ids[:cap]
        return out

    def local_map_lines(self, kfs: np.ndarray, cap: int) -> np.ndarray:
        """The live lines observed by `kfs`, as `local_map_points`."""
        ids = np.unique(self.kf_match_ln[kfs])
        ids = ids[(ids >= 0)
                  & self.ln_valid[np.clip(ids, 0, self.max_lines - 1)]]
        out = np.full(cap, INVALID, np.int32)
        out[:min(len(ids), cap)] = ids[:cap]
        return out

    # ------------------------------------------------------------------
    def remove_point(self, ids: np.ndarray) -> None:
        """Clear validity and every back-pointer of the points `ids`."""
        ids = np.atleast_1d(ids)
        self.pt_valid[ids] = False
        mask = np.isin(self.kf_match_pt, ids)
        self.kf_match_pt[mask] = INVALID
        self.n_pt -= len(ids)
        self.change_index += 1

    def remove_line(self, ids: np.ndarray) -> None:
        ids = np.atleast_1d(ids)
        self.ln_valid[ids] = False
        mask = np.isin(self.kf_match_ln, ids)
        self.kf_match_ln[mask] = INVALID
        self.n_ln -= len(ids)
        self.change_index += 1

    def remove_keyframe(self, kf: int) -> None:
        """Remove a keyframe: its observations, its covisibility, and its
        place in the temporal chain (prev <-> next rewired)."""
        pts = self.kf_match_pt[kf]
        good = pts >= 0
        self.pt_n_obs[pts[good]] -= 1
        lns = self.kf_match_ln[kf]
        self.ln_n_obs[lns[lns >= 0]] -= 1
        self.kf_match_pt[kf] = INVALID
        self.kf_match_ln[kf] = INVALID
        self.kf_valid[kf] = False
        self.kf_feat_valid[kf] = False
        self.covis[kf] = 0
        self.covis[:, kf] = 0
        p, n = self.kf_prev[kf], self.kf_next[kf]
        if p >= 0:
            self.kf_next[p] = n
        if n >= 0:
            self.kf_prev[n] = p
        self.n_kf -= 1
        self.change_index += 1

    def valid_kf_indices(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def kf_chain(self) -> np.ndarray:
        """The temporal keyframe chain, oldest to newest."""
        kfs = self.valid_kf_indices()
        return kfs[np.argsort(self.kf_timestamp[kfs])]

    def apply_scaled_rotation(self, R_gw: np.ndarray, scale: float,
                              Tbc: Optional[np.ndarray] = None) -> None:
        """Re-express the whole map in a gravity-aligned, metric frame:
        X' = s R_gw X; camera poses T_cw' = [R_cw R_gw^T | s t_cw],
        velocities rotated and scaled, body poses recomputed from Tbc."""
        R_gw = np.asarray(R_gw, np.float32)
        kfs = self.valid_kf_indices()
        R_cw = self.kf_pose_cw[kfs, :, :3]
        t_cw = self.kf_pose_cw[kfs, :, 3]
        self.kf_pose_cw[kfs, :, :3] = np.einsum("kij,lj->kil", R_cw, R_gw)
        self.kf_pose_cw[kfs, :, 3] = scale * t_cw
        self.pt_xyz[self.pt_valid] = scale * np.einsum(
            "ij,kj->ki", R_gw, self.pt_xyz[self.pt_valid])
        if self.ln_valid.any():
            ep = self.ln_ep[self.ln_valid].reshape(-1, 3)
            self.ln_ep[self.ln_valid] = (scale * np.einsum(
                "ij,kj->ki", R_gw, ep)).reshape(-1, 6)
        self.kf_vel[kfs] = scale * np.einsum("ij,kj->ki", R_gw,
                                             self.kf_vel[kfs])
        if Tbc is not None:
            self.recompute_body_poses(Tbc)
        self.change_index += 1

    def recompute_body_poses(self, Tbc: np.ndarray) -> None:
        """kf_pose_wb from kf_pose_cw: T_wb = T_wc T_cb, T_cb = Tbc^-1."""
        R_bc = np.asarray(Tbc[:3, :3], np.float32)
        t_bc = np.asarray(Tbc[:3, 3], np.float32)
        R_cb = R_bc.T
        t_cb = -R_cb @ t_bc
        kfs = self.valid_kf_indices()
        R_cw = self.kf_pose_cw[kfs, :, :3]
        t_cw = self.kf_pose_cw[kfs, :, 3]
        R_wc = R_cw.transpose(0, 2, 1)
        p_wc = -np.einsum("kij,kj->ki", R_wc, t_cw)
        R_wb = np.einsum("kij,jl->kil", R_wc, R_cb)
        p_wb = np.einsum("kij,j->ki", R_wc, t_cb) + p_wc
        self.kf_pose_wb[kfs, :, :3] = R_wb
        self.kf_pose_wb[kfs, :, 3] = p_wb

    def set_cam_poses_from_body(self, kfs: np.ndarray,
                                Tbc: np.ndarray) -> None:
        """The inverse of recompute_body_poses for the keyframes `kfs`."""
        R_bc = np.asarray(Tbc[:3, :3], np.float32)
        t_bc = np.asarray(Tbc[:3, 3], np.float32)
        R_wb = self.kf_pose_wb[kfs, :, :3]
        p_wb = self.kf_pose_wb[kfs, :, 3]
        R_wc = np.einsum("kij,jl->kil", R_wb, R_bc)
        p_wc = np.einsum("kij,j->ki", R_wb, t_bc) + p_wb
        R_cw = R_wc.transpose(0, 2, 1)
        t_cw = -np.einsum("kij,kj->ki", R_cw, p_wc)
        self.kf_pose_cw[kfs, :, :3] = R_cw
        self.kf_pose_cw[kfs, :, 3] = t_cw


    def apply_sim3(self, s: float, R: np.ndarray, t: np.ndarray,
                   Tbc: Optional[np.ndarray] = None) -> None:
        """Re-express the whole map under the similarity X' = s R X + t (a
        map merge's weld): camera poses T_cw' = [R_cw R^T | s t_cw -
        R_cw R^T t] (projectively identical, pc' = s pc), velocities
        scaled and rotated, body poses recomputed from Tbc."""
        R = np.asarray(R, np.float32)
        t = np.asarray(t, np.float32)
        kfs = self.valid_kf_indices()
        self.pt_xyz[self.pt_valid] = (
            s * self.pt_xyz[self.pt_valid] @ R.T + t).astype(np.float32)
        if self.ln_valid.any():
            ep = self.ln_ep[self.ln_valid].reshape(-1, 3)
            self.ln_ep[self.ln_valid] = (
                s * ep @ R.T + t).reshape(-1, 6).astype(np.float32)
        R_cw = self.kf_pose_cw[kfs, :, :3]
        t_cw = self.kf_pose_cw[kfs, :, 3]
        R_new = np.einsum("kij,lj->kil", R_cw, R)
        self.kf_pose_cw[kfs, :, :3] = R_new
        self.kf_pose_cw[kfs, :, 3] = s * t_cw - np.einsum(
            "kij,j->ki", R_new, t)
        self.kf_vel[kfs] = s * self.kf_vel[kfs] @ R.T
        if Tbc is not None:
            self.recompute_body_poses(Tbc)
        self.change_index += 1

    def absorb(self, other: "MapStore"):
        """Append `other`'s keyframes, points and lines (already expressed
        in this map's world frame) to this store.  Returns (kf_map, pt_map,
        ln_map): old slot -> new slot (INVALID where the old slot was not
        valid)."""
        kfs = np.nonzero(other.kf_valid)[0]
        pts = np.nonzero(other.pt_valid)[0]
        lns = np.nonzero(other.ln_valid)[0]
        new_kf = np.nonzero(~self.kf_valid)[0][:len(kfs)]
        if len(new_kf) < len(kfs):
            raise RuntimeError("keyframe capacity exhausted in merge")
        new_pt = self.alloc_points(len(pts))
        new_ln = self.alloc_lines(len(lns))
        if len(new_pt) < len(pts) or len(new_ln) < len(lns):
            raise RuntimeError("landmark capacity exhausted in merge")
        self.kf_valid[new_kf] = True
        self.n_kf += len(new_kf)
        kf_map = np.full(other.max_kf, INVALID, np.int32)
        pt_map = np.full(other.max_pts, INVALID, np.int32)
        ln_map = np.full(other.max_lines, INVALID, np.int32)
        kf_map[kfs] = new_kf
        pt_map[pts] = new_pt
        ln_map[lns] = new_ln

        def remap(idx, lut):
            return np.where(idx >= 0, lut[np.maximum(idx, 0)], INVALID)
        for f in ("kf_timestamp", "kf_pose_cw", "kf_pose_wb", "kf_vel",
                  "kf_bias_g", "kf_bias_a", "kf_feat_uv", "kf_feat_uv_raw",
                  "kf_feat_octave", "kf_feat_angle", "kf_feat_desc",
                  "kf_feat_valid", "kf_line_ep", "kf_line_desc",
                  "kf_line_valid"):
            getattr(self, f)[new_kf] = getattr(other, f)[kfs]
        self.kf_match_pt[new_kf] = remap(other.kf_match_pt[kfs], pt_map)
        self.kf_match_ln[new_kf] = remap(other.kf_match_ln[kfs], ln_map)
        self.kf_prev[new_kf] = remap(other.kf_prev[kfs], kf_map)
        self.kf_next[new_kf] = remap(other.kf_next[kfs], kf_map)
        for f in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
                  "pt_max_dist", "pt_n_obs", "pt_found", "pt_visible"):
            getattr(self, f)[new_pt] = getattr(other, f)[pts]
        self.pt_first_kf[new_pt] = remap(other.pt_first_kf[pts], kf_map)
        for f in ("ln_ep", "ln_desc", "ln_n_obs", "ln_found", "ln_visible"):
            getattr(self, f)[new_ln] = getattr(other, f)[lns]
        self.ln_first_kf[new_ln] = remap(other.ln_first_kf[lns], kf_map)
        self.covis[np.ix_(new_kf, new_kf)] = other.covis[np.ix_(kfs, kfs)]
        for kf_old, kf_new in zip(kfs, new_kf):
            if kf_old in other.kf_preint:
                self.kf_preint[int(kf_new)] = other.kf_preint[kf_old]
            if kf_old in other.kf_imu_raw:
                self.kf_imu_raw[int(kf_new)] = other.kf_imu_raw[kf_old]
        self.change_index += 1
        return kf_map, pt_map, ln_map

    def kf_centers(self) -> np.ndarray:
        """Camera centres of all keyframe slots: C = -R^T t."""
        R = self.kf_pose_cw[:, :, :3]
        t = self.kf_pose_cw[:, :, 3]
        return -np.einsum("kji,kj->ki", R, t)


@dataclass
class Atlas:
    """Multi-map container: the maps and the active one, which receives
    new data; a tracking loss on a map of more than 10 keyframes starts a
    fresh one (`create_new_map`)."""
    maps: List[MapStore] = field(default_factory=list)
    active: int = 0
    next_map_id: int = 1

    def __post_init__(self):
        if not self.maps:
            self.maps = [MapStore(map_id=0)]
        self.next_map_id = max([m.map_id for m in self.maps] + [0]) + 1

    @property
    def current(self) -> MapStore:
        return self.maps[self.active]

    def create_new_map(self, **kw) -> MapStore:
        """A new empty map (MapStore's keywords), appended and active."""
        m = MapStore(map_id=self.next_map_id, **kw)
        self.next_map_id += 1
        self.maps.append(m)
        self.active = len(self.maps) - 1
        return m
