"""Prior-map relocalization (port of plvio_tpu/models/relocalization.py):
align the live session to a prior RGB-D keyframe set and export the
keyframe trajectory in the prior set's world.

At start-up `load_prior_dir` reads the reference's prior format
(color/<i+1>.png, depth/<i+1>.pgm, pose.txt) and extracts each prior
frame's ORB features (`ops.frontend.OrbExtractor` at the prior image's
size), its bag of words (`vocabulary.make_bow_pipeline`) and its
depth-backprojected points.  Once the live map matures (its inertial BA2,
or ten keyframes), each new keyframe is scored against the prior frames;
the three best are matched (`matching.hamming_dist`, the Hamming matrix
kernel, then `match_nn_ratio`), and PnP RANSAC with the ML refinement
(`ops.pnp.pnp_ransac`, `mlpnp_refine`) at the prior camera's fixed K gives
the live-to-prior world transform.  Every later keyframe's pose is then
re-expressed in the prior world, and `save_trajectory` writes them.

The relocalizer only observes: it reads the map and writes nothing into
the map or the tracker.  Its RANSAC samples come from its own generator
(seeded with cfg.seed + 13, where the reference splits
`jax.random.PRNGKey(cfg.seed + 13)` once an attempt), or from an injected
`sampler(valid) -> samples [iters,6]`, as the tracker's `pnp_sampler`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..cuda import HostIO, resolve_device
from ..ops import matching as M
from ..ops import pnp as PNP
from ..ops import twoview as TV
from ..solver.residuals import PinholeK
from ..utils import lie
from . import vocabulary as V
from .mapstore import Atlas

PRIOR_K = PinholeK(fx=518.0, fy=519.0, cx=325.5, cy=253.5)
RANSAC_ITERS = 128
MATCH_CAP = 512
DEPTH_SCALE = 5000.0           # the prior depth images' units a metre


@dataclass
class PriorFrame:
    """One prior keyframe (the reference's R_Frame)."""
    T_wc: np.ndarray          # [3,4] prior-world-from-camera
    uv: np.ndarray            # [N,2] keypoints
    desc_packed: np.ndarray   # [N,8] uint32
    valid: np.ndarray         # [N]
    xyz_w: np.ndarray         # [N,3] depth-backprojected 3D (prior world)
    has_depth: np.ndarray     # [N]
    bow: np.ndarray           # [W]


class PriorMapRelocalizer(HostIO):
    """The prior-map relocalizer on `device` (the card unless the caller
    asks for the CPU; `plain` runs the kernels' plain versions)."""

    def __init__(self, cfg: SystemConfig, atlas: Atlas, voc: V.Vocabulary,
                 n_feat: int, device="cuda", plain: bool = False,
                 sampler=None):
        self.cfg = cfg
        self.atlas = atlas
        self.voc = voc
        self.n_feat = n_feat
        self.device = resolve_device(device)
        self.plain = plain
        self.host_syncs = 0
        cam = cfg.camera
        self.K = PinholeK(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        # the prior set was captured by its own camera; the reference
        # hardcodes it (Relocalization.cpp:8)
        self.prior_K = PRIOR_K
        self.prior_frames: List[PriorFrame] = []
        self._prior_dev: list = []       # (desc, valid & has_depth) on device
        self._bow_pipeline = V.make_bow_pipeline(voc, n_feat, plain)
        self._extract = None
        self._dist = M.hamming_dist_plain if plain else M.hamming_dist
        self._pnp = PNP.pnp_ransac_plain if plain else PNP.pnp_ransac
        self._ml = PNP.mlpnp_refine_plain if plain else PNP.mlpnp_refine
        # live->prior world transform, set on the first alignment
        self.T_prior_from_live: Optional[np.ndarray] = None   # [3,4]
        # time -> pose in the prior world
        self.relocalized_poses: Dict[float, np.ndarray] = {}
        self.sampler = sampler
        self.generator = torch.Generator().manual_seed(cfg.seed + 13)
        self.n_keyframes = 0          # process_keyframe calls
        self.aligned_at = -1          # ... the call that aligned, or -1
        self.aligned_kf = -1          # ... its keyframe
        self.attempts: list = []      # per _try_align: the frames tried

    # ------------------------------------------------------------------
    def add_prior_frame(self, img: np.ndarray, depth: np.ndarray,
                        T_wc: np.ndarray) -> None:
        """Register a prior RGB-D keyframe: its ORB features at the image's
        own size, its bag of words and its depth-backprojected points."""
        from ..ops.frontend import make_extractor
        if self._extract is None:
            self._extract, _ = make_extractor(
                img.shape[0], img.shape[1], self.cfg.orb.n_features,
                device=self.device, plain=self.plain)
        f = self._extract(torch.as_tensor(img, dtype=torch.float32).to(
            self.device))
        _, bow = self._bow_pipeline(f.desc, f.valid)
        uv, valid, desc, bow = self._host_many(f.uv, f.valid, f.desc, bow)
        desc = desc.view(np.uint32)
        ui = np.clip(uv[:, 0].astype(int), 0, depth.shape[1] - 1)
        vi = np.clip(uv[:, 1].astype(int), 0, depth.shape[0] - 1)
        z = depth[vi, ui]
        has_depth = valid & (z > 0.05) & np.isfinite(z)
        xn = (uv[:, 0] - self.prior_K.cx) / self.prior_K.fx
        yn = (uv[:, 1] - self.prior_K.cy) / self.prior_K.fy
        pc = np.stack([xn * z, yn * z, z], -1)
        xyz_w = pc @ T_wc[:, :3].T + T_wc[:, 3]
        self.prior_frames.append(PriorFrame(
            T_wc=np.asarray(T_wc, np.float32), uv=uv, desc_packed=desc,
            valid=valid, xyz_w=xyz_w.astype(np.float32),
            has_depth=has_depth, bow=bow))
        self._prior_dev.append((f.desc.contiguous(),
                                self._dev(valid & has_depth)))

    def load_prior_dir(self, data_dir: str) -> int:
        """Load the reference's on-disk prior format: color/<i+1>.png and
        depth/<i+1>.pgm paired with row i of pose.txt, rows `x y z qx qy qz
        qw` or TUM `t x y z qx qy qz qw`.  Returns the frames loaded."""
        from ..io.euroc import load_image_gray, read_pgm
        rows = np.loadtxt(os.path.join(data_dir, "pose.txt"), ndmin=2)
        off = 1 if rows.shape[1] >= 8 else 0   # a timestamp column first
        n = 0
        for i, row in enumerate(rows):
            cpath = os.path.join(data_dir, "color", f"{i + 1}.png")
            dpath = os.path.join(data_dir, "depth", f"{i + 1}.pgm")
            if not (os.path.exists(cpath) and os.path.exists(dpath)):
                continue
            img = load_image_gray(cpath)
            depth = read_pgm(dpath).astype(np.float32) / DEPTH_SCALE
            q = torch.as_tensor(row[off + 3:off + 7], dtype=torch.float32)
            R = lie.quat_to_rot(q).numpy()
            t = row[off:off + 3]
            self.add_prior_frame(img, depth,
                                 np.concatenate([R, t[:, None]], 1))
            n += 1
        return n

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, timestamp: float) -> None:
        """Align once the map matures, then re-express the keyframe's pose
        in the prior world."""
        m = self.atlas.current
        self.n_keyframes += 1
        if self.T_prior_from_live is None:
            mature = m.imu_ba2 or m.n_kf >= 10
            if mature and self.prior_frames:
                self._try_align(kf)
                if self.T_prior_from_live is not None:
                    self.aligned_at, self.aligned_kf = self.n_keyframes, kf
        if self.T_prior_from_live is not None:
            T = self.T_prior_from_live
            R_cw = m.kf_pose_cw[kf, :, :3]
            t_cw = m.kf_pose_cw[kf, :, 3]
            R_wc = R_cw.T
            p_wc = -R_wc @ t_cw
            R_p = T[:, :3] @ R_wc
            p_p = T[:, :3] @ p_wc + T[:, 3]
            self.relocalized_poses[float(timestamp)] = np.concatenate(
                [R_p, p_p[:, None]], 1)

    def _samples(self, valid: np.ndarray) -> torch.Tensor:
        if self.sampler is not None:
            return torch.as_tensor(self.sampler(valid))
        return TV.sample_indices(torch.from_numpy(valid), RANSAC_ITERS, 6,
                                 self.generator)

    def _try_align(self, kf: int) -> None:
        """The live keyframe against the three prior frames of the best bag
        scores: matches (at least 15), PnP RANSAC (12 inliers) and the ML
        refinement (12 again) give T_prior_from_live."""
        m = self.atlas.current
        desc_l = self._dev(m.kf_feat_desc[kf])
        valid_l = self._dev(m.kf_feat_valid[kf])
        _, bow = self._bow_pipeline(desc_l, valid_l)
        bow = self._host(bow)
        scores = np.array([1.0 - 0.5 * np.abs(bow - p.bow).sum()
                           for p in self.prior_frames])
        top = np.argsort(-scores)[:3]    # the reference keeps the top 3
        tried = []
        self.attempts.append(tried)
        for pi in top:
            prior = self.prior_frames[pi]
            desc_p, valid_p = self._prior_dev[pi]
            dist = self._dist(desc_l, desc_p)
            idx, ok = M.match_nn_ratio(dist, valid_l, valid_p, None,
                                       max_dist=60.0, ratio=0.75)
            ok_np, idx_np = self._host_many(ok, idx)
            att = dict(prior=int(pi), matches=int(ok_np.sum()), n_ransac=0,
                       n_ml=0)
            tried.append(att)
            if ok_np.sum() < 15:
                continue
            fsel = np.nonzero(ok_np)[0]
            uv_p = np.zeros((MATCH_CAP, 2), np.float32)
            X_p = np.zeros((MATCH_CAP, 3), np.float32)
            vmask = np.zeros(MATCH_CAP, bool)
            nv = min(len(fsel), MATCH_CAP)
            uv_p[:nv] = m.kf_feat_uv[kf][fsel[:nv]]
            X_p[:nv] = prior.xyz_w[idx_np[fsel[:nv]]]
            vmask[:nv] = True
            samples = self._samples(vmask)
            uv_t, X_t, v_t = (self._dev(a) for a in (uv_p, X_p, vmask))
            res = self._pnp(self.K, uv_t, X_t, v_t,
                            samples.to(self.device))
            att["n_ransac"] = int(self._host(res.n))
            if att["n_ransac"] < 12:
                continue
            R, t, _, n = self._ml(self.K, uv_t, X_t, res.inliers, res.R,
                                  res.t)
            R_cw_p, t_cw_p, n = self._host_many(R, t, n)
            att["n_ml"] = int(n)
            if att["n_ml"] < 12:
                continue
            R_wc_p = R_cw_p.T
            p_wc_p = -R_wc_p @ t_cw_p
            R_cw_l = m.kf_pose_cw[kf, :, :3]
            t_cw_l = m.kf_pose_cw[kf, :, 3]
            # T_prior_from_live = T_wc_prior o T_cw_live
            R_T = R_wc_p @ R_cw_l
            t_T = R_wc_p @ t_cw_l + p_wc_p
            self.T_prior_from_live = np.concatenate(
                [R_T, t_T[:, None]], 1).astype(np.float32)
            return

    # ------------------------------------------------------------------
    def save_trajectory(self, path: str) -> None:
        """The relocalized keyframes in time order, TUM format (the
        reference's SaveKeyFrameTrajectoryByRelocalization)."""
        from ..io import trajectory as TIO
        ts = np.asarray(sorted(self.relocalized_poses.keys()))
        pos, quat = [], []
        for t in ts:
            T = self.relocalized_poses[float(t)]
            pos.append(T[:, 3])
            quat.append(lie.rot_to_quat(torch.as_tensor(
                np.ascontiguousarray(T[:, :3]), dtype=torch.float32)).numpy())
        TIO.write_tum(path, TIO.Trajectory(
            ts, np.asarray(pos).reshape(-1, 3),
            np.asarray(quat).reshape(-1, 4)))
