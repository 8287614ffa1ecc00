#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two tracked frames at EuRoC geometry (480x752, 1000 ORB
features, 256 line features, 2048 map points, 128 map lines), its
keyframe mapping step at both window sizes of the reference's benchmark
(16 KF x 4096 points x 8192 observations + 512 lines x 1024 observations,
and 2048 / 4096 / 256 / 512), the inertial back end, the keyframe step's
neighbourhood work, the monocular bootstrap, the whole keyframe step, the
tracked sequence (180 rendered frames through the front ends, the
tracker and the keyframe step) and the whole `System` over the 8 s MH
replay (166 frames, with the keyframe database and relocalization), the
loop closer on hand-made maps and `System` with loop closing over the
28 s closed circuit through their user entry points, and fails (nonzero
exit, no result line) unless every phase passes:

1. the card is there (prints `nvidia-smi` name and power limit);
2. the CUDA kernels build from `plvio_tpu_torch/csrc` (25 sources: nvcc,
   sm_90a, one nvcc per source, all started together);
3. each kernel agrees with its plain PyTorch version on the card at the
   paths' shapes (the mapping kernels also on a perturbed window at the
   same shape in which every gate of the epipolar match and of the
   triangulation decides some rows, and the Schur step's landmarks against
   the plain step and a float64 back-substitution; slice 5's kernels on
   every call of a plain run of its path, the projection matcher also in
   the tracker's frustum mode, and `make_local_ba` against float64;
   slice 6's `undistort` at EuRoC's coefficients on the 16 frames'
   keypoints and line endpoints, the two-view kernels on the five cases
   of `inputs.build_twoview_cases` at 200 matches and the general one at
   1000, held to the plain version in float64 on the same samples, and
   `imu_preint` on a 128-sample keyframe window; slice 8's `pyramid` at
   every ORB level, chained and from the plain level above, and its line
   level, on the 16 frames, within 1e-4 grey levels; slice 9's
   `bow_transform` bit-equal to the plain pipeline on the ORB and LBD
   descriptors of every 4th frame of the MH replay, `bow_score` within
   1e-6 on a 512-row bank of those frames, `pnp_ransac` and
   `mlpnp_refine` against the plain version's float64 run on the same
   samples, `ops.pnp.kernels_against_float64`);
4. slice 1, `tracking_step_pl`: 16 synthetic frames with the pose carried,
   >= 80 inliers, camera centre <= 10 mm and rotation <= 0.3 deg from
   ground truth on every frame, every kernel of the path launched; the
   same frames on the plain path, and the largest pose difference;
5. slice 2, `tracking_step_vi`: frames 1..15 with their IMU windows and the
   carry (pose_wb, v, bg, ba, H15), held to a guard from the JAX reference
   run on the CPU (REF_VI below): every frame >= 90% of the reference's
   fewest inliers, body position and rotation within max(2x the
   reference's largest error, 10 mm / 0.3 deg) of ground truth, every
   kernel of the path launched; the same frames on the plain path, each
   frame's pose within 1e-4, inliers within 1% and carried H15 within 1e-3
   relative of it;
6. CUDA-event times per frame of both frames (kernel and plain paths) and
   per kernel beside its plain version, with the card's name and power
   limit;
7. slice 3, `mapping_step`, at both sizes: from the true start the
   triangulated and inlier counts within 1% of the JAX reference run on
   the CPU (REF_MAP below), from the perturbed start
   (`inputs.perturb_window`) the largest camera-centre error within
   max(2x the reference's, 10 mm), the kernel path's KF poses within
   1e-4 of the plain path's on the CPU and their landmarks' reprojection
   residuals within 0.1 px, and within 1e-4 of the card's plain path,
   whose three runs from each start give the same bits (its normal
   equations summed by sorted segment sums), every kernel of the path
   launched; CUDA-event times per mapping step on
   both paths, of `schur_solve` beside torch.mm of its Gram fill-in,
   and the sustained figure of bench.py's `bench_sustained` (3 point+line
   frames + 1 typical mapping step, ms per frame);
8. slice 4, `inertial_ba_step` at both buckets and starts and `imu_init`
   with its refinement, held to REF_LIBA / REF_INIT;
9. slice 5, `neighborhood_step` on both maps of
   `inputs.build_keyframe_map` (with and without confirmed map lines):
   new lines, fuse binds, merges and refusals and the BA's path equal on
   the kernel and plain paths, the BA's KF poses within 2x the CPU plain
   run's distance to float64, the counts within 1% of the JAX mapper's on
   the CPU (REF_NBH below), the
   largest camera-centre error within max(2x the reference's, 10 mm),
   every kernel of the path launched; CUDA-event ms per step on both
   paths and the host syncs per step;
10. slice 6, `bootstrap_step`: the rendered frames through the frame
   prelude and the port's tracker to the initial map, held to the JAX
   tracker's run on the CPU (REF_BOOT below: the initializing frame, the
   attempts and the model equal, the counts within their tolerances, the
   second keyframe's rotation and t-direction errors against the truth
   within 2x the reference's largest over five RANSAC keys), every kernel
   of the path launched (PATH_BOOT; `undistort` not, as the renders have
   no distortion); then, as a path of its own, the EuRoC-raw case (raw
   cam0 pixels) through `undistort_pixels` and `reconstruct_two_views`,
   every kernel of it launched (PATH_RAW); ms per attempt on both paths;
11. slice 7, `keyframe_sequence`, held to REF_SEQ;
12. slice 8, `tracked_sequence`: the 180 frames of
   `inputs.build_tracked_sequence` at production's sizes, held to the
   JAX package's run on the CPU (REF_TRACK below: frames tracked >= its
   fewest - 2, the IMU initialized within 2 keyframes of its, keyframes,
   points and lines within 10%, the init scale's, the final scale's, the
   gravity's and the ATE's errors within 2x its worst over five RANSAC
   keys, REF_BOOT's rule), every kernel of the
   path launched, the pyramid 7 + 1 launches a frame; wall ms and host
   syncs a frame for the bootstrap, tracked and keyframe frames;
13. slice 9, `mh_replay`: `System.track_monocular` over the 166 frames of
   the 8 s MH replay at full width (the 9000-point / 500-line hall, 1000
   ORB / 256 line features, production's store and caps, loop closing
   off), then `global_refine`, held to tests/test_mh_replay_regression.
   py's bounds and to the JAX `System`'s run on the CPU over five seeds
   (REF_MH below); one keyframe database row a live keyframe, each equal
   to the plain pipeline's on the card; every kernel of the path
   launched (PATH_SYSTEM); then the relocalization case on the final map
   (LOST, no pose, frames from mid-sequence fed again), held to REF_MH's
   frames and pose distance, with `bow_score`, `pnp_ransac` and
   `mlpnp_refine` launched (PATH_RELOC); then the replay again with
   cfg.seed 1..4 (`seed_spread`: the card's own RANSAC draws), every run
   within the regression's bounds and REF_MH's ranges, the median of each
   count inside them.  The replay is rendered once on
   the host before phase 3's slice-9 checks (numpy and cv2, in order
   with the one generator; ~40 s there);
14. slice 10, loop closing: `entry.loop_closure` at production caps on
   the drifted circle (closed within its last 4 keyframes, revisit error
   < 0.12 m and within 2x REF_LOOPCLOSE's) and on the two-map merge
   (merged, the fused points within 5% of REF_LOOPCLOSE's), each in a
   launch window of its own with every kernel of the path launched; on
   the inputs those runs gave them, `sim3_ransac` (the path's samples and
   the card's own), `sim3_reproj` (with and without fix_scale) and
   `pose_graph` (Sim3 and 4-DoF at S = 119 in one block; the 601-keyframe
   chain at 301 anchors and a 512-keyframe chain, S = 3584, on the global
   path) held to their plain versions' float64 runs (within 2x the plain
   float32 run's distance + 1e-6, the same bits on a second launch, the
   path reported), `hamming_match`'s matrix mode equal to plain; the
   global BA of phase 11's final map at 128 KF with lines (schur_solve's
   global path, the reprojection RMS not above the input's); then
   `System` with its default configuration (loop closing on) over the 28
   s circuit (`entry.mh_loop`, 560 frames rendered by a process started
   at the beginning, on one niced core), held to
   test_mh_loop_single_map_survival's bounds but for the map count (no
   more maps than REF_LOOP, the JAX run's), with every kernel of the path
   and the loop closer's query launched;
15. slice 11, the rectified-stereo front: `hamming_match`'s stereo point
   and line modes bit-equal to their plain versions on a full-width
   rendered pair (the stereo replay's first) and on synthetic sets;
   `System.track_stereo` (`entry.stereo_replay`: IMU_STEREO with lines,
   the reference's stereo_line_inertial_euroc3 at EuRoC geometry, 0.11 m
   baseline, loop closing on) over the 8 s stereo replay (166 pairs,
   rendered after the circuit by the same niced process): pairs 0..110,
   through the keyframe that initializes the IMU, against the JAX System
   fed the port's CPU features (FED_STEREO: keyframes equal after every
   pair, points, lines and bound features within max(2, 1%)); then
   with cfg.seed 0..4 held to REF_STEREO (the JAX System's five runs on
   the CPU): frames tracked, keyframes, points and lines of every run
   within 10% of the reference's range over its seeds (and the median
   inside it where the range has width: the reference's five runs are
   one), the IMU initialized, the SE3 ATE within 2x the
   reference's worst; `pose_irls` with the u_R column and
   `vi_pose_lm` with the stereo term on the inputs the tracker gave them
   in that run, held to their plain versions' float64 runs (within 2x the
   plain float32 runs' distance over four row orders + 1e-6, the same
   bits on a second launch), and the mono calls' digests of
   `kernel_digest.py` equal to the mono-only tree's (PARENT_DIGESTS);
   STEREO with lines over the room orbit of tests/test_stereo.py
   (`entry.stereo_room`, 15 pairs: >= 14 tracked,
   SE3 ATE < 0.05 m and within 2x REF_STEREO's) and RGB-D over it
   (`entry.rgbd_room`, 12 frames: >= 11 tracked, SE3 ATE < 0.08 m), each
   run in a launch window of its own with every kernel of its path
   launched;
16. slice 12, STEREO and RGB-D without lines and the KB8 fisheye through
   `System`: the pinhole calls of `undistort`, `proj_match` and the
   point BA give the digests of the tree before the KB8 modes
   (PINHOLE_DIGESTS); STEREO without lines
   over tests/test_stereo.py's room (15 pairs, 0.11 m baseline: >= 14
   tracked, SE3 ATE < 0.05 m and within 2x the JAX run's,
   REF_STEREO_PTS), RGB-D with ORB-SLAM3's bf 40 over its room (12
   frames: >= 11 tracked, SE3 ATE < 0.08 m and within 2x the JAX run's),
   `pose_lm`'s stereo mode on the inputs the tracker gave it held to its
   plain version's float64 run (as phase 15's solvers); the fisheye room
   of tests/test_kb8_native.py (`entry.kb8_room`, 30 frames, loop closing
   on) with cfg.seed 0 (Sim3 ATE < 0.06 m) and 1..4: the Sim3 ATE within
   2x the JAX runs' worst, the counts within 10% of their ranges
   (REF_KB8; the keyframes within one: the frames before the bootstrap
   follow the RANSAC draws, and JAX's own seeds track 24-27); `pose_lm`'s KB8 mode (float64 rule),
   `undistort`'s and `proj_match`'s KB8 modes (against their plain
   versions on the run's last frame and call) and `ba_linearize`'s KB8
   mode on the typical window (`inputs.build_kb8_window`: one
   linearization within 1e-4 relative of the plain engine, the BA within
   2x the CPU plain run's distance to float64); each room in a launch
   window of its own with every kernel of its path launched;
17. slice 13, the KB8 fisheye with the IMU (with and without lines) and
   the line-only SLAM modes 1-3 through `System`: slice 12's digests of the
   kernels that gained modes (SLICE12_DIGESTS); the new modes on fixed
   windows at the paths' shapes, each by one linearization within 1e-4
   relative of the plain engine's normal equations (pose blocks, g, Hpp,
   gp, the couplings B: `KN.linearization_against_plain`) and by the
   whole BA within 2x the plain float32 runs' distance to a float64 run
   + 1e-6, bit-stable over three launches (`KN.against_float64`):
   `ba_linearize`'s body-frame KB8 mode
   (`inputs.build_inertial_window(kb8=True)`, 16 KF, with lines at the
   worst bucket; without them at the half by the BA's rule alone; the
   64-KF window on schur_solve's global path by its one-step rule), its
   KB8 point edge beside the line family (`inputs.build_kb8_window(
   n_ln=256, n_lobs=512)`), its line-only modes 1, 2 and 3 each with
   schur_solve on no point blocks (`inputs.build_line_window`, 16 KF x
   512 lines x 1024 observations); the KB8 camera's keyframe mapping step
   (`entry.mapping_step(kb8=True)`, the worst window, the only path that
   reaches the KB8 + line BA) in a launch window of its own; the fisheye
   replay (`entry.kb8_vi_replay`'s inputs, its frames rendered by the
   render process after the stereo pairs) without and with lines at
   cfg.seed 0..4, and the MH replay's frames under SLAM modes 1, 2, 3 at
   cfg.seed 0..4: each run against the JAX runs of its regime (with or
   without IMU init; REF_KB8_VI over cfg.seed 0..9, with lines 0..19,
   where 2 of the 20 initialize; REF_LINE_MODES over 0..9): frames
   tracked, keyframes (the keyframes at the init where the reference's
   runs mostly do not initialize) and the IMU init frame within 10% of
   that pool's ranges, the ATE within 2x its worst (REF_KB8_VI: SE3;
   REF_LINE_MODES: Sim3), each seed 0 run in a launch window of its own
   with every kernel of its path launched; `undistort`'s KB8 mode on the
   fisheye run's last frame's keypoints and segments (NaN on both where
   the padding undistorts), `pose_irls` on its last point+line call (NaN
   line rows: a NaN pose and no inliers on both, as the reference's), and
   `pose_lm`'s line families on SLAM mode 3's last line-only call and on
   `inputs.build_line_pose_case` (float64 rule);
18. slice 14, the ED line detector (`line.detector = 1`) and the prior-map
   relocalizer through `System`: `line_detect_ed` against its plain
   version on the MH replay's frame 1 at both levels of the line pyramid
   (`ops.lines.ed_against_plain`: the bf16 gradients and magnitude and the
   cells' candidate anchors bit-equal, the walks that differ counted, the
   segment sets within 0.01 px); `inputs.build_prior_set`'s prior set
   (six views of the replay's hall at the prior camera, 640x480, with
   16-bit depth) and the replay's frames of phase 13 through `System` with
   `entry.ed_config` (IMU_MONOCULAR with lines, loop closing on, the
   relocalizer on the prior set) at cfg.seed 0..4, cfg.seed 0 in a launch
   window of its own with every kernel of its path launched and the cell
   detector never: each run against REF_ED's runs of its regime
   (`replay_guards`: frames tracked, IMU init frame, keyframes, SE3 ATE),
   aligned where every reference run aligns, at a keyframe within the
   reference's range +- 1, its relocalized keyframes within 2x the
   reference's worst RMSE against the truth in the prior world; cfg.seed
   0 again with the relocalizer off: every frame's pose bit-equal; the
   STEREO room with lines under the ED detector (`entry.ed_stereo_room`,
   15 pairs) by phase 15's room rule against REF_ED["room"];
19. slice 15, the sharded back end (plvio_tpu_torch/parallel/):
   `kernel_digest.window_digests` (the single-device window BAs) equal to
   the parent tree's (WINDOW_DIGESTS); `schur_reduce` on each shard of
   `entry.dist_window(2)` at C = 16 and C = 64 against the plain partial
   (the engine's `reduce_system` of the shard's problem) within 1e-4
   relative, the same bits on three launches; `schur_solve_reduced`'s
   solve of their sum, CG at S = 240 and 960, and its Cholesky at
   dist_ba's S on dist_ba's summed raw partials, by `KN.against_float64`
   (whose limit must lie below half of max |dx64|, so that a zero or
   halved dx fails it) and within 1e-2 x max |dx64| of the plain float32
   solve of the same system; the CG solve of the partials, summed in
   shard order by the kernel, bit-equal to the solve of their sum;
   the sharded window solve at D = 1, 2, 4 against the single-device
   window solve by the float64 rule (D = 2 three times, the same bits);
   dist_ba, chain_ba and chain_liba on 2 shards against their plain
   versions on a CPU mesh by the same rule (plain float32 runs over four
   observation orders), each in a launch window of its own; the port's
   two-process worker sharing the card over gloo, bit-equal to the
   2-shard mesh of this process (or on the CPU where the card's compute
   mode is exclusive, said on a line of its own); one window solve's wall
   and CUDA-event ms at D = 1, 2, 4; `entry.dist_replay(2)` (the MH
   replay's frames of phase 13, loop closing off) at cfg.seed 0..4
   against REF_DIST's runs (`replay_guards`), every run with at least one
   window solve on the sharded path and none on the single-device
   inertial kernel, its dropped observations printed, cfg.seed 0 in a
   launch window of its own with every kernel of PATH_DIST launched; and
   cfg.seed 0 with loop closing on, >= 85% of its frames tracked.

`library_ms` is one PyTorch call computing the same function where
there is one (the pyramid's: 7 antialiased bilinear `F.interpolate`, its
own weights; the line level's: `avg_pool2d`; `bow_score`'s: 1 - 0.5
`torch.cdist(v[None], bank, p=1)`; `pose_graph`'s: its 15 dense solves
alone, 15 x `torch.linalg.cholesky` + `cholesky_solve` at the same S),
else null.

Each kernel's least time on the card (`bound_ms`) is the larger of its
bytes (inputs read once, outputs written once) over 3.35 TB/s and its
operations over 67 TFLOP/s (the float32 rate outside the tensor cores,
also used for the integer work; the two-view, Sim3 and pose-graph
kernels solve in float64 by choice, but the float32 function they
replace sets their bound), counted
from this run's shapes and data (`work`, beside each kernel's check).

Prints a JSON line of the kernels, then, as its last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one card and no network; JAX is never imported.
"""
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from plvio_tpu_torch import cuda
from plvio_tpu_torch.config import CameraConfig, ImuConfig
from plvio_tpu_torch.entry import (K_EUROC, LIBA_HALF, LIBA_WORST,
                                   MAPPING_TYPICAL, MAPPING_WORST,
                                   bootstrap_step, imu_init,
                                   inertial_ba_step, keyframe_sequence,
                                   loop_closure, mapping_step,
                                   neighborhood_step, point_projection_match,
                                   project_points, relocalization_case,
                                   rgbd_room, stereo_config, stereo_room,
                                   SystemRun, tracked_sequence,
                                   tracking_step_pl, tracking_step_vi)
from plvio_tpu_torch.inputs import (PNP_CASES, TWOVIEW_CASES,
                                    build_imu_windows, build_inputs,
                                    build_keyframe_map, build_mh_replay,
                                    build_pnp_case, build_stereo_replay,
                                    build_twoview_cases, perturb_window)
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.models.kernels import rel_err, unpack_sym
from plvio_tpu_torch.models import vocabulary as V
from plvio_tpu_torch.ops import cameras as CAM
from plvio_tpu_torch.ops import frontend as FE
from plvio_tpu_torch.ops import imu as IMU
from plvio_tpu_torch.ops import lines as LN
from plvio_tpu_torch.ops import matching as M
from plvio_tpu_torch.ops import pnp as PNP
from plvio_tpu_torch.ops import stereo as ST
from plvio_tpu_torch.ops import twoview as TV
from plvio_tpu_torch.solver import engine as E
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.state import from_numpy, mapstore_from_numpy

H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE, N_FRAMES = 480, 752, 1000, 2048, 128, \
    256, 16
KERNELS = {
    "orb_fast_grid": (FE.ORB_FAST_GRID, "plvio_tpu/ops/frontend.py:151"),
    "orb_describe": (FE.ORB_DESCRIBE, "plvio_tpu/ops/frontend.py:300"),
    "hamming_match": (M.HAMMING_MATCH, "plvio_tpu/ops/matching.py:59"),
    "pose_irls": (KN.POSE_IRLS, "plvio_tpu/models/kernels.py:179"),
    "line_detect": (LN.LINE_DETECT, "plvio_tpu/ops/lines.py:63"),
    "line_refine_lbd": (LN.LINE_REFINE_LBD, "plvio_tpu/ops/lines.py:514"),
    "imu_preint": (IMU.IMU_PREINT, "plvio_tpu/ops/imu.py:87"),
    "vi_pose_lm": (KN.VI_POSE_LM, "plvio_tpu/models/kernels.py:932"),
    "rot_hist": (M.ROT_HIST, "plvio_tpu/ops/matching.py:115"),
    "triangulate": (KN.TRIANGULATE, "plvio_tpu/models/kernels.py:878"),
    "ba_linearize": (KN.BA_LINEARIZE, "plvio_tpu/solver/engine.py:355"),
    "schur_solve": (KN.SCHUR_SOLVE, "plvio_tpu/solver/engine.py:452"),
    "inertial_chain": (KN.INERTIAL_CHAIN,
                       "plvio_tpu/models/kernels.py:1279"),
    "inertial_gs_lm": (KN.INERTIAL_GS_LM,
                       "plvio_tpu/models/kernels.py:1137"),
    "proj_match": (KN.PROJ_MATCH, "plvio_tpu/models/kernels.py:767"),
    "line_triangulate": (KN.LINE_TRIANGULATE,
                         "plvio_tpu/models/kernels.py:389"),
    "undistort": (CAM.UNDISTORT, "plvio_tpu/ops/cameras.py:86"),
    "twoview_hypotheses": (TV.TWOVIEW_HYPOTHESES,
                           "plvio_tpu/ops/twoview.py:290"),
    "twoview_recover": (TV.TWOVIEW_RECOVER, "plvio_tpu/ops/twoview.py:296"),
    "pyramid": (FE.PYRAMID, "plvio_tpu/ops/frontend.py:98"),
    "pyramid_line": (FE.PYRAMID_LINE, "plvio_tpu/ops/lines.py:737"),
    "bow_transform": (V.BOW_TRANSFORM, "plvio_tpu/models/vocabulary.py:88"),
    "bow_score": (V.BOW_SCORE, "plvio_tpu/models/vocabulary.py:116"),
    "pnp_ransac": (PNP.PNP_RANSAC, "plvio_tpu/ops/pnp.py:49"),
    "mlpnp_refine": (PNP.MLPNP_REFINE, "plvio_tpu/ops/pnp.py:217"),
    "hamming_matrix": (M.HAMMING_MATRIX, "plvio_tpu/ops/matching.py:49"),
    "sim3_ransac": (PNP.SIM3_RANSAC, "plvio_tpu/ops/pnp.py:165"),
    "sim3_reproj": (KN.SIM3_REPROJ, "plvio_tpu/models/kernels.py:524"),
    "pose_graph": (KN.POSE_GRAPH, "plvio_tpu/models/kernels.py:488"),
    "hamming_match_stereo": (ST.STEREO_MATCH_POINTS,
                             "plvio_tpu/ops/stereo.py:16"),
    "hamming_match_stereo_lines": (ST.STEREO_MATCH_LINES,
                                   "plvio_tpu/ops/stereo.py:38"),
    "pose_irls_stereo": (KN.POSE_IRLS_STEREO,
                         "plvio_tpu/models/kernels.py:179"),
    "vi_pose_lm_stereo": (KN.VI_POSE_LM_STEREO,
                          "plvio_tpu/models/kernels.py:932"),
    "pose_lm_stereo": (KN.POSE_LM_STEREO, "plvio_tpu/models/kernels.py:687"),
    "pose_lm_kb8": (KN.POSE_LM_KB8, "plvio_tpu/models/kernels.py:1493"),
    "undistort_kb8": (CAM.UNDISTORT_KB8, "plvio_tpu/ops/cameras.py:170"),
    "proj_match_kb8": (KN.PROJ_MATCH_KB8,
                       "plvio_tpu/models/kernels.py:1443"),
    "ba_linearize_kb8": (KN.BA_LINEARIZE_KB8,
                         "plvio_tpu/solver/residuals.py:534"),
    "ba_linearize_kb8_body": (KN.BA_LINEARIZE_KB8_BODY,
                              "plvio_tpu/solver/residuals.py:544"),
    "ba_linearize_kb8_lines": (KN.BA_LINEARIZE_KB8_LINES,
                               "plvio_tpu/models/kernels.py:641"),
    "ba_linearize_line_only": (KN.BA_LINEARIZE_LINE_ONLY,
                               "plvio_tpu/models/kernels.py:1394"),
    "pose_lm_line": (KN.POSE_LM_LINE, "plvio_tpu/models/kernels.py:1344"),
    "line_detect_ed": (LN.LINE_DETECT_ED, "plvio_tpu/ops/lines.py:276"),
    "schur_reduce": (KN.SCHUR_REDUCE, "plvio_tpu/solver/engine.py:476"),
    "schur_solve_reduced_cg": (KN.SCHUR_SOLVE_REDUCED_CG,
                               "plvio_tpu/solver/engine.py:540"),
    "schur_solve_reduced_chol": (KN.SCHUR_SOLVE_REDUCED_CHOL,
                                 "plvio_tpu/parallel/dist_ba.py:186"),
}
# schur_solve's launches whose reduced system exceeds one block (its
# global path, counted in KN.SCHUR_SOLVE.global_launches), and the TPU
# kernel it replaces
GLOBAL = ("schur_solve_global", "plvio_tpu/solver/engine.py:256")
# pose_graph's launches whose Cholesky took the cooperative global path
GLOBAL_PG = ("pose_graph_global", "plvio_tpu/models/kernels.py:488")
PATH_PL = ("orb_fast_grid", "orb_describe", "hamming_match", "pose_irls",
           "line_detect", "line_refine_lbd")
PATH_VI = ("orb_fast_grid", "orb_describe", "hamming_match", "line_detect",
           "line_refine_lbd", "imu_preint", "vi_pose_lm")
PATH_MAP = ("hamming_match", "rot_hist", "triangulate", "ba_linearize",
            "schur_solve")
PATH_LIBA = ("ba_linearize", "inertial_chain", "schur_solve")
PATH_INIT = ("inertial_gs_lm",)
PATH_NBH = ("proj_match", "hamming_match", "line_triangulate", "ba_linearize",
            "schur_solve")
PATH_BOOT = ("orb_fast_grid", "orb_describe", "hamming_match", "rot_hist",
             "line_detect", "line_refine_lbd", "twoview_hypotheses",
             "twoview_recover", "line_triangulate", "imu_preint")
PATH_RAW = ("undistort", "twoview_hypotheses", "twoview_recover")
PATH_TRACK = ("pyramid", "pyramid_line", "orb_fast_grid", "orb_describe",
              "line_detect", "line_refine_lbd", "hamming_match", "rot_hist",
              "twoview_hypotheses", "twoview_recover", "line_triangulate",
              "imu_preint", "proj_match", "pose_irls", "vi_pose_lm",
              "triangulate", "ba_linearize", "schur_solve",
              "inertial_chain", "inertial_gs_lm")
PATH_SYSTEM = PATH_TRACK + ("bow_transform",)
PATH_RELOC = ("bow_transform", "bow_score", "hamming_match", "pnp_ransac",
              "mlpnp_refine")
PATH_SEQ = ("hamming_match", "rot_hist", "triangulate", "line_triangulate",
            "proj_match", "ba_linearize", "schur_solve", "inertial_chain",
            "inertial_gs_lm", "imu_preint", "schur_solve_global")
# tests/test_torch_keyframe_step.py's JAX LocalMapper over
# build_keyframe_sequence(0) at production's sizes on the CPU (float32):
# the keyframe at which the IMU initialized and the scale it applied, 1 /
# the start's monocular scale, keyframes, points and lines alive at the
# end, the map's final scale against the truth, its gravity direction
# error (deg), the full-map solves and their largest window, and the
# keyframe centres' ATE RMSE (m); printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_keyframe_step.py`
REF_SEQ = {"init_kf": 13, "init_scale": 1.7033237218856812,
           "inv_lam": 1.7327722230765765, "keyframes": 32, "points": 6216,
           "lines": 1349, "scale": 0.9881112200492166,
           "gravity_err_deg": 0.0451966042240831, "viba_solves": 1,
           "viba_window": 26, "ate_sim3": 0.004874773026713829,
           "ate_se3": 0.012946194053327333}
# tests/test_torch_tracked_sequence.py's JAX package over
# build_tracked_sequence(0) (scripts/run_synthetic_vi.py's 180 frames) at
# full width on the CPU, its own front end, production's caps, no keyframe
# database, with the RANSAC key 0: frames with a pose (and the fewest over
# the keys 0..4), the bootstrap frame, the keyframes made when the IMU
# initialized and its frame, the scale it applied and the trajectory's
# scale the frame before, the final trajectory scale, the gravity error
# (deg) at the last frame, keyframes, points and lines at the end, the
# ATE RMSE (m) over every tracked frame; and each error against the
# truth at its worst over the keys 0..4 (`_worst`: the IMU init's scale
# error |init_scale x pre_init_scale - 1|, the final scale's |scale - 1|,
# gravity, ATE), as REF_BOOT's rule holds the card, which draws its own
# RANSAC samples; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_tracked_sequence.py`
REF_TRACK = {"n_frames": 180, "n_tracked": 178, "n_tracked_min": 178,
             "init_frame": 2, "imu_init_kf": 10, "imu_init_frame": 41,
             "init_scale": 1.9935938119888306,
             "pre_init_scale": 0.424464417560102,
             "scale": 0.9572593560990982,
             "gravity_err_deg": 0.27519892413438296, "keyframes": 51,
             "points": 6622, "lines": 26, "ate_sim3": 0.01783909232166533,
             "ate_se3": 0.02993225677915693,
             "init_scale_err_worst": 0.22953015813895083,
             "scale_err_worst": 0.12024451265424752,
             "gravity_err_deg_worst": 0.731032035986275,
             "ate_sim3_worst": 0.024866913032282948,
             "ate_se3_worst": 0.07098224984586711}
# tests/test_torch_system.py's JAX System (use_loop_closing=False,
# synchronous) over the 8 s MH replay (build_mh_replay(8.0, 7): 166
# frames, the 9000 / 500 hall) at full width on the CPU, cfg.seed 0 (its
# RANSAC key), and over the seeds 0..4: frames with a pose (and the
# fewest), the bootstrap frame, the keyframes made when the IMU
# initialized (and its range over the seeds) and its frame, the scale it
# applied and the trajectory's scale the frame before, |ba|, maps, the
# final state, keyframes, points and lines alive (and their ranges over
# the seeds), relocalizations tried during the run; after global_refine
# the trajectory's scale, the gravity error (deg), the ATE RMSE (m); the
# relocalization case (LOST, no pose, frames 83.. fed again without IMU):
# the frames it took (and the most over the seeds), the relocalized
# pose's camera-centre distance (m) and rotation (deg) from the pose the
# run tracked at that frame; each error's worst over the seeds; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_system.py`
REF_MH = {"n_frames": 166, "n_tracked": 164, "init_frame": 2,
          "imu_init_kf": 13, "imu_init_frame": 61,
          "init_scale": 4.402053356170654,
          "pre_init_scale": 0.1122629430874247, "imu_initialized": True,
          "ba_norm": 0.14881227910518646, "maps": 1, "final_state": 2,
          "keyframes": 38, "points": 5221, "lines": 214, "reloc_tried": 0,
          "reloc_ok": 0, "scale": 0.7883809898652384,
          "gravity_err_deg": 1.480448836816026,
          "ate_sim3": 0.10187800793793453, "ate_se3": 0.3719113373881168,
          "kf_bank_rows": 38, "reloc_frames": 1,
          "reloc_centre_m": 0.03856664448169237,
          "reloc_rot_deg": 0.23229247103817136,
          "init_scale_err": 0.505812534608407,
          "scale_err": 0.2116190101347616,
          "init_scale_err_worst": 0.505812534608407,
          "scale_err_worst": 0.46681918339200523,
          "gravity_err_deg_worst": 1.651233864517859,
          "ate_sim3_worst": 0.1375727232083872,
          "ate_se3_worst": 0.824015187004141,
          "reloc_centre_m_worst": 0.06749195474066302,
          "reloc_rot_deg_worst": 0.569283165788743, "n_tracked_min": 164,
          "reloc_frames_max": 1, "reloc_tried_max": 0, "keyframes_min": 31,
          "keyframes_max": 43, "points_min": 4218, "points_max": 6414,
          "lines_min": 181, "lines_max": 283, "imu_init_kf_min": 12,
          "imu_init_kf_max": 13}
# tests/test_torch_stereo_system.py's JAX System (IMU_STEREO with lines,
# rectified EuRoC geometry, 0.11 m baseline, the system's defaults: loop
# closing on, synchronous mapping) over the 8 s stereo replay
# (build_stereo_replay(8.0, 7): 166 pairs) at full width on the CPU,
# cfg.seed 0: frames with a pose, the IMU init's frame, maps, the final
# state, keyframes, points and lines alive, the ATE RMSE (m) after
# global_refine; the ranges of the counts and the worst SE3 ATE over the
# seeds 0..4 (the seed reaches no RANSAC draw on this path: the five runs
# are one); and the room orbits of tests/test_stereo.py: STEREO with
# lines over 15 pairs, RGB-D (no lines) over 12 frames; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_stereo_system.py`
REF_STEREO = {"n_frames": 166, "n_tracked": 166, "imu_init_frame": 110,
              "imu_initialized": True, "maps": 1, "final_state": 2,
              "keyframes": 32, "points": 12756, "lines": 511,
              "ate_sim3": 0.11922747022506756,
              "ate_se3": 0.43347584578210047,
              "n_tracked_range": [166, 166], "keyframes_range": [32, 32],
              "points_range": [12756, 12756], "lines_range": [511, 511],
              "ate_se3_worst": 0.43347584578210047, "maps_max": 1,
              "room_stereo": {"n_frames": 15, "n_tracked": 15,
                              "keyframes": 3, "points": 1204, "lines": 4,
                              "ate_sim3": 0.0032265398028096574,
                              "ate_se3": 0.005777861674711516,
                              "final_state": 2},
              "room_rgbd": {"n_frames": 12, "n_tracked": 12, "keyframes": 3,
                            "points": 1359, "lines": 0,
                            "ate_sim3": 0.0036179086650171663,
                            "ate_se3": 0.004232408568307856,
                            "final_state": 2}}
# plvio_tpu_torch/kernel_digest.py's mono lines on the tree before the
# stereo rows and modes (its commit's `git archive`, PYTHONPATH at it,
# the script of this tree), on an H100 80GB HBM3 at 700 W: the kernels
# the stereo rows extend give the same bits on mono calls
# The JAX System fed the port's CPU features of the stereo replay (the
# replay of REF_STEREO, cfg.seed 0) through pair 110, whose keyframe
# initializes the IMU: the map's (keyframes, points, lines) from each pair
# of `counts_at` on, and each pair's features bound to a map point;
# printed as the "jax" columns of
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_stereo_system.py --fed`
FED_STEREO = {
    "counts_at": [[0, 1, 667, 23], [12, 2, 965, 38], [32, 3, 1264, 60],
                  [52, 4, 1561, 75], [56, 5, 1866, 84], [76, 6, 2197, 99],
                  [96, 7, 2569, 133], [110, 8, 2937, 169]],
    "inliers": [
        667, 469, 484, 457, 449, 434, 439, 432, 415, 416, 398, 405, 361, 521,
        491, 498, 497, 478, 484, 470, 442, 424, 431, 420, 408, 418, 390, 408,
        419, 418, 397, 403, 382, 531, 486, 430, 398, 373, 384, 364, 388, 369,
        349, 356, 354, 341, 337, 331, 336, 402, 381, 320, 261, 302, 223, 187,
        173, 307, 280, 273, 296, 292, 279, 278, 295, 331, 386, 425, 431, 365,
        350, 325, 276, 250, 228, 247, 243, 339, 332, 343, 351, 355, 376, 382,
        378, 383, 342, 352, 333, 331, 320, 319, 298, 298, 308, 276, 275, 288,
        274, 268, 254, 276, 255, 240, 242, 229, 214, 201, 188, 184, 166]}
PARENT_DIGESTS = {
    "vi_pose_lm have_prior=True": "37ea30a8a290d2c88c800dd7a3a51f93",
    "vi_pose_lm have_prior=False": "6f78a10c419546a19ef6a4f638b18a58",
    "hamming_match window": "ca998a1ead77423fb022a08e0d0a5664",
    "hamming_match line": "00b9cec0d480e37091a5502e60b7a0c3",
    "hamming_match epipolar": "7e81bfa9c6443682a347dcfab4f64f21",
    "pose_irls mono n_lines=0": "2b87e410ad469cec8feef728b7891294",
    "pose_irls mono n_lines=64": "e72396e61c8ec2f03f7e6ce7be602589"}
PATH_STEREO = ("pyramid", "pyramid_line", "orb_fast_grid", "orb_describe",
               "line_detect", "line_refine_lbd", "hamming_match", "rot_hist",
               "triangulate", "line_triangulate", "imu_preint", "proj_match",
               "ba_linearize", "schur_solve", "inertial_chain",
               "inertial_gs_lm", "bow_transform", "hamming_match_stereo",
               "hamming_match_stereo_lines", "pose_irls_stereo",
               "vi_pose_lm_stereo")
PATH_ROOM_STEREO = ("orb_fast_grid", "orb_describe", "line_detect",
                    "line_refine_lbd", "hamming_match_stereo",
                    "hamming_match_stereo_lines", "pose_irls_stereo",
                    "proj_match")
PATH_RGBD = ("orb_fast_grid", "orb_describe", "pose_irls", "proj_match")
# slice 12: STEREO without lines over the room (15 pairs), RGB-D with bf 40
# over it (12 frames), the KB8 fisheye room (30 frames, loop closing on)
PATH_STEREO_PTS = ("pyramid", "orb_fast_grid", "orb_describe",
                   "hamming_match_stereo", "proj_match", "pose_lm_stereo",
                   "hamming_match", "triangulate", "ba_linearize",
                   "schur_solve", "bow_transform")
PATH_RGBD_PTS = ("pyramid", "orb_fast_grid", "orb_describe", "proj_match",
                 "pose_lm_stereo", "ba_linearize", "schur_solve",
                 "bow_transform")
PATH_KB8 = ("pyramid", "orb_fast_grid", "orb_describe", "undistort_kb8",
            "hamming_match", "rot_hist", "twoview_hypotheses",
            "twoview_recover", "proj_match_kb8", "pose_lm_kb8", "triangulate",
            "ba_linearize_kb8", "schur_solve", "bow_transform")
# tests/test_torch_pose_lm.py's JAX System on the CPU over the room orbits
# without lines (STEREO, 15 pairs; RGB-D with bf 40, 12 frames), loop
# closing off
REF_STEREO_PTS = {"stereo": {"n_frames": 15, "n_tracked": 15,
                             "keyframes": 3, "points": 1205,
                             "ate_sim3": 0.003244420961376264,
                             "ate_se3": 0.005761990550406985,
                             "final_state": 2},
                  "rgbd": {"n_frames": 12, "n_tracked": 12, "keyframes": 3,
                           "points": 1373,
                           "ate_sim3": 0.0029691855829989907,
                           "ate_se3": 0.003510777120423907,
                           "final_state": 2}}
# tests/test_torch_kb8.py's JAX System on the CPU over the fisheye room (30
# frames, loop closing on) with cfg.seed 0..4: the ranges of the counts
# and the worst ATE after `global_refine` (as SystemRun reports it) and
# before it ("_run")
REF_KB8 = {"n_tracked_range": [24, 27],
           "keyframes_range": [5, 7],
           "points_range": [375, 834],
           "maps_range": [1, 1],
           "ate_sim3_worst": 0.05138924211133539,
           "ate_se3_worst": 0.08882849378260928,
           "ate_sim3_run_worst": 0.05102360126862187,
           "ate_se3_run_worst": 0.08960969547069364}
# kernel_digest.pinhole_digests on the tree before the KB8 modes
PINHOLE_DIGESTS = {
    "undistort pinhole": "d14e8e9e156578e8287ef66837fc5a29",
    "proj_match pinhole fuse": "f85a6bf39cc5fc2c491fc7dbaee688ea",
    "proj_match pinhole tracker": "288ee89b36fe188d8465ea25ffdf8b58",
    "local_ba pinhole points": "f0089d9e6cb04c42f015959d9673178f"}
# tests/test_torch_bootstrap.py's JAX tracker on build_bootstrap_inputs(0)
# (the port's CPU front end's features): the initializing frame, attempts,
# model, init matches, triangulated matches, points and lines with the
# RANSAC key of seed 0, and the second keyframe's largest rotation (deg)
# and t-direction errors against the truth over the keys 0..4; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_bootstrap.py`
REF_BOOT = {"init_frame": 2, "attempts": 2, "used_homography": True,
            "init_matches": 296, "n_triangulated": 274, "points": 274,
            "lines": 7, "rot_err_deg": 0.23840322026429564,
            "tdir_err": 0.10796273895736609}
# bench.build_mapping_step's step (with the line inliers) on the CPU in
# float32, at both sizes, from the true start and from
# inputs.perturb_window's start: triangulated pairs, inlier observations,
# the largest camera-centre errors (m) against the true KF poses; printed
# by `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_mapping_step.py`
REF_MAP = {
    "worst": {"n_good": 1024, "n_inliers": 8192, "n_inliers_l": 1024,
              "true_max_centre_m": 0.00398586260877945,
              "perturbed_start_m": 0.04400639133499479,
              "perturbed_max_centre_m": 0.011309127880816847},
    "typical": {"n_good": 1024, "n_inliers": 4096, "n_inliers_l": 512,
                "true_max_centre_m": 0.0038392607427625773,
                "perturbed_start_m": 0.04400644060011908,
                "perturbed_max_centre_m": 0.010204830494980062}}
MAP_POSE_TOL = 1e-4       # kernel against plain path, a KF pose entry
MAP_RES_TOL_PX = 0.1      # ... a reprojection residual: ~2x MAP_POSE_TOL x fx
# make_local_inertial_ba (models/kernels.py:1206) on the CPU in float32 at
# both buckets of `_liba_window` from the true and the perturbed start of
# inputs.build_inertial_window: point and line inliers, the largest
# body-position (m), velocity (m/s) and rotation (deg) errors and the
# largest bias errors against the truth; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_inertial_ba.py`
REF_LIBA = {
    "worst_true": {
        "n_inliers": 8038, "n_inliers_l": 496,
        "max_pos_m": 0.0026293746809380823,
        "max_vel_mps": 0.0034532484439772815,
        "max_rot_deg": 0.029816365572999267,
        "max_bg": 5.568144842982292e-07, "max_ba": 0.0008910135366022587},
    "worst_perturbed": {
        "n_inliers": 8033, "n_inliers_l": 496,
        "max_pos_m": 0.010273185909857693,
        "max_vel_mps": 0.014899040434813316,
        "max_rot_deg": 0.0477130791510268,
        "max_bg": 8.939823601394892e-07, "max_ba": 0.005236792610958219},
    "half_true": {
        "n_inliers": 4009, "n_inliers_l": 506,
        "max_pos_m": 0.0028285130220241307,
        "max_vel_mps": 0.003691819746046111,
        "max_rot_deg": 0.0339620684841832,
        "max_bg": 7.136550266295671e-07, "max_ba": 0.0010594059713184834},
    "half_perturbed": {
        "n_inliers": 4008, "n_inliers_l": 505,
        "max_pos_m": 0.009017411908361882,
        "max_vel_mps": 0.013520111469521458,
        "max_rot_deg": 0.051008917921994426,
        "max_bg": 1.9972212612628937e-06, "max_ba": 0.005584200611338019}}
# make_inertial_init and make_scale_refine (models/kernels.py:1137, 1092)
# on the CPU in float32 on inputs.build_imu_init_inputs: scale, gravity
# direction R_wg (0, 0, -1) and the initialization's gyro bias; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_imu_init.py`
REF_INIT = {"init_scale": 2.0023462772369385,
            "init_gdir": [0.045517437160015106, 0.4215737581253052,
                          -0.9056510329246521],
            "init_bg": [0.0003484622575342655, -0.0003937759029213339,
                        0.001889435457997024],
            "refine_scale": 0.9717907905578613,
            "refine_gdir": [-0.006310852710157633, 0.006210932042449713,
                            -0.9999608397483826]}
# the JAX LocalMapper (models/local_mapping.py: create_new_lines,
# search_in_neighbors, local_ba) on the CPU at production caps on both maps
# of inputs.build_keyframe_map: new lines, fuse binds and merges, the BA's
# path, observations the BA's chi2 gate unbound, points and lines after,
# and the largest camera-centre error (m) before and after; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_neighborhood.py`
REF_NBH = {
    "points": {"new_lines": 109, "n_fused": 207, "n_merged": 25,
               "n_bound": 182, "ba_path": "pt", "unbound_by_ba": 128,
               "n_pt": 4646, "n_ln": 109,
               "start_max_centre_m": 0.005461366838584026,
               "max_centre_m": 0.0032463054327698656},
    "confirmed_lines": {"new_lines": 107, "n_fused": 207, "n_merged": 25,
                        "n_bound": 182, "ba_path": "pl",
                        "unbound_by_ba": 128, "n_pt": 4646, "n_ln": 131,
                        "start_max_centre_m": 0.005461366838584026,
                        "max_centre_m": 0.0031855501098876616}}
GRAVITY = 9.81
HBM_BPS = 3.35e12         # H100 SXM device memory, bytes/s
F32_OPS = 67e12           # H100 SXM float32 outside the tensor cores
# __graft_entry__._tracking_step_vi_fn on the CPU (float32), fed
# build_inputs(16) + build_imu_windows: frames 1..15, fewest inliers, the
# largest body-position and rotation errors against ground truth; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_tracking_step_vi.py`
REF_VI = {"min_inliers": 80, "max_pos_m": 0.00924061761037433,
          "max_rot_deg": 0.13442194971241928}
SEG_TOL_PX = 0.01          # a segment's partner within 0.01 px (endpoints)
SEG_MISS = 0.02            # share of a side's segments allowed no partner
#                            (at least one): sums in another order can move
#                            a segment across a threshold or reorder two
#                            nearly equal lengths
BITS_SHARE = 0.995         # LBD / BRIEF bit agreement


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)
    print(f"  ok: {msg}")


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device milliseconds of fn() over `reps` calls (CUDA events,
    warm-up excluded)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*objs):
    """Bytes of the tensors in objs (tuples and named tuples walked)."""
    n = 0
    for o in objs:
        if torch.is_tensor(o):
            n += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            n += nbytes(*o)
    return n


def work(nb, ops, rate=F32_OPS):
    """The bound of a kernel call from its bytes and operations (at
    `rate` operations a second)."""
    t_b, t_o = nb / HBM_BPS * 1e3, ops / rate * 1e3
    return dict(bytes=int(nb), ops=int(ops), bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def pose_err(P, G):
    """(camera-centre distance, rotation angle deg) between two T_cw."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    c = -P[:, :3].T @ P[:, 3]
    cg = -G[:, :3].T @ G[:, 3]
    return float(np.linalg.norm(c - cg)), rot_deg(P[:, :3], G[:, :3])


def rot_deg(A, B):
    dR = np.asarray(A, np.float64) @ np.asarray(B, np.float64).T
    return math.degrees(math.acos(max(-1.0, min(1.0,
                                                (np.trace(dR) - 1) / 2))))


def rot_diff_rad(A, B):
    """Angle of A^T B from its skew part (acos of the trace cannot resolve
    angles below ~1e-4 rad in float64 of float32 rotations)."""
    dR = A[:, :3].double().cpu().T @ B[:, :3].double().cpu()
    w = torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]]) / 2
    return math.asin(min(1.0, float(w.norm())))


def h15_gap(a, b):
    """Relative Frobenius gap of two carried priors: 0 where both are
    non-finite (the reference's NaN prior), inf where only one is."""
    fa, fb = bool(torch.isfinite(a).all()), bool(torch.isfinite(b).all())
    if not (fa or fb):
        return 0.0
    if not (fa and fb):
        return math.inf
    return float((a - b).norm() / b.norm())


def seg_share(ea, va, eb, vb, tol=SEG_TOL_PX):
    """(matched, total): valid segments of a with a valid segment of b
    whose endpoints are both within tol (either orientation)."""
    ea, eb = ea.double().cpu().numpy(), eb.double().cpu().numpy()
    va, vb = va.cpu().numpy(), vb.cpu().numpy()
    n = 0
    for i in np.nonzero(va)[0]:
        same = np.maximum(np.linalg.norm(eb[:, :2] - ea[i, :2], axis=1),
                          np.linalg.norm(eb[:, 2:] - ea[i, 2:], axis=1))
        flip = np.maximum(np.linalg.norm(eb[:, :2] - ea[i, 2:], axis=1),
                          np.linalg.norm(eb[:, 2:] - ea[i, :2], axis=1))
        d = np.where(vb, np.minimum(same, flip), np.inf)
        n += int(d.min() <= tol)
    return n, int(va.sum())


def check_segments(name, ek, vk, ep, vp):
    a, na = seg_share(ek, vk, ep, vp)
    b, nb = seg_share(ep, vp, ek, vk)
    ok = all(n - m <= max(1, int(SEG_MISS * n)) for m, n in ((a, na),
                                                             (b, nb)))
    check(ok, f"{name}: {a}/{na} kernel and {b}/{nb} plain segments have a "
          f"partner within {SEG_TOL_PX} px (at most max(1, {SEG_MISS:.0%}) "
          "without)")


def bit_agreement(dk, dp):
    if dk.shape[0] == 0:
        return 1.0
    return float((M.unpack_u32_to_pm1(dk) == M.unpack_u32_to_pm1(dp))
                 .float().mean())


def check_pl_kernels(imgs, poses, st, step, report):
    """The four kernels of slice 1 against their plain versions."""
    dev = imgs[0].device
    orb = step.orb
    # -- orb_fast_grid: every level of frame 1
    pyr = FE.build_pyramid(imgs[1], orb.specs)
    same, total, err, out_b = [], [], 0.0, 0
    for im in pyr:
        bk, ak = FE.orb_fast_grid(im, 20.0, 7.0)
        bp, ap = FE.orb_fast_grid_plain(im, 20.0, 7.0)
        out_b += nbytes(bk, ak)
        eq = (ak == ap) & (bk == bp)
        same.append(int(eq.sum()))
        total.append(eq.numel())
        err = max(err, float((bk - bp).abs().max()))
    check(same[0] == total[0],
          f"orb_fast_grid level 0 winners identical ({same[0]}/{total[0]})")
    frac = sum(same[1:]) / sum(total[1:])
    check(frac >= 0.995, f"orb_fast_grid levels 1-7 winners {frac:.4%} "
          "identical (>= 99.5%)")
    # FAST at two thresholds on the 16-pixel ring, 3x3 NMS, cell argmax:
    # ~60 operations a pixel
    report["orb_fast_grid"] = dict(
        **work(nbytes(*pyr) + out_b, 60 * sum(im.numel() for im in pyr)),
        max_abs_err=err,
        ms=cuda_ms(lambda: [FE.orb_fast_grid(im, 20.0, 7.0) for im in pyr]),
        plain_ms=cuda_ms(lambda: [FE.orb_fast_grid_plain(im, 20.0, 7.0)
                                  for im in pyr]))

    # -- orb_describe: the keypoints of frame 1, all levels in one call
    xys, octs = [], []
    for lv, spec in enumerate(orb.specs):
        best, arg = FE.orb_fast_grid(pyr[lv], 20.0, 7.0)
        xy, _, _ = FE.select_top_cells(best, arg, spec.width // 16,
                                       spec.n_keep)
        xys.append(xy)
        octs.append(torch.full((xy.shape[0],), lv, dtype=torch.int32,
                               device=dev))
    xy, oc = torch.cat(xys), torch.cat(octs)
    dargs = (pyr, xy, oc, orb.taps, orb.pattern, orb.wx, orb.wy)
    ang_k, desc_k = FE.orb_describe(*dargs)
    ang_p, desc_p = FE.orb_describe_plain(*dargs)
    agree = bit_agreement(desc_k, desc_p)
    dang = (ang_k - ang_p).abs()
    dang = float(torch.minimum(dang, 360.0 - dang).max())
    check(agree >= BITS_SHARE,
          f"orb_describe bits {agree:.4%} agree (>= 99.5%)")
    check(dang <= 0.01, f"orb_describe angles within {dang:.2e} deg "
          "(<= 0.01)")
    # per keypoint: its 39x39 patch read once, a 7x7 blur of it, the
    # intensity centroid on the r=15 disc and 256 steered comparisons
    n_kp = xy.shape[0]
    report["orb_describe"] = dict(
        **work(min(n_kp * 39 * 39 * 4, nbytes(*pyr)) + nbytes(xy, oc)
               + nbytes(ang_k, desc_k),
               n_kp * (39 * 39 * 49 * 2 + 31 * 31 * 4 + 256 * 4)),
        max_abs_err=dang, ms=cuda_ms(lambda: FE.orb_describe(*dargs)),
        plain_ms=cuda_ms(lambda: FE.orb_describe_plain(*dargs)))

    # -- hamming_match: the point and line matches of frame 1 at its
    #    carried pose, and a tie-heavy random case
    with torch.no_grad():
        feats = orb(imgs[1])
        lf = step.lines(imgs[1])
    pose0 = torch.from_numpy(poses[0]).to(dev)
    uvp, row_ok = project_points(K_EUROC, pose0, st["pt_xyz"], st["pt_valid"],
                                 H, W)
    pt_case = (st["pt_desc"], feats.desc, row_ok, feats.valid, uvp, feats.uv)
    pt_kw = dict(radius=20.0, max_dist=80.0, ratio=0.9)
    g = torch.Generator(device="cpu").manual_seed(0)
    rnd_case = (
        (torch.randint(0, 4, (CAP_PTS, 8), generator=g) << 30).to(
            torch.int32).to(dev),
        (torch.randint(0, 4, (N_FEAT, 8), generator=g) << 30).to(
            torch.int32).to(dev),
        (torch.rand(CAP_PTS, generator=g) < 0.9).to(dev),
        (torch.rand(N_FEAT, generator=g) < 0.9).to(dev),
        (torch.rand(CAP_PTS, 2, generator=g) * 100).to(dev),
        (torch.rand(N_FEAT, 2, generator=g) * 100).to(dev))
    lcase = KN.line_proj_match_core
    li_k, lm_k, _ = lcase(K_EUROC, pose0, st["ln_ep6"], st["ln_desc"],
                          st["ln_valid"], lf.ep, lf.desc, lf.angle, lf.valid,
                          lf.lineq)
    li_p, lm_p, _ = lcase(K_EUROC, pose0, st["ln_ep6"], st["ln_desc"],
                          st["ln_valid"], lf.ep, lf.desc, lf.angle, lf.valid,
                          lf.lineq, plain=True)
    errs = [float((li_k != li_p).sum() + (lm_k != lm_p).sum())]
    check(errs[0] == 0, "hamming_match line mode: idx and ok identical "
          f"({int(lm_k.sum())} matched)")
    for name, case in (("points", pt_case), ("random ties", rnd_case)):
        ik, ok_k = M.hamming_match(*case, **pt_kw)
        ip, ok_p = M.hamming_match_plain(*case, **pt_kw)
        errs.append(float((ik != ip).sum() + (ok_k != ok_p).sum()))
        check(errs[-1] == 0, f"hamming_match {name}: idx and ok identical "
              f"({int(ok_k.sum())} matched)")
    # the window gate on every pair (~6 operations), then XOR + popc of 8
    # words on the pairs it admits (~17)
    gated = int((M.window_gate(uvp, feats.uv, 20.0) & row_ok[:, None]
                 & feats.valid[None, :]).sum())
    n_r, n_c = uvp.shape[0], feats.uv.shape[0]
    report["hamming_match"] = dict(
        **work(nbytes(*pt_case) + n_r * 5, 6 * n_r * n_c + 17 * gated),
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: M.hamming_match(*pt_case, **pt_kw)),
        plain_ms=cuda_ms(lambda: M.hamming_match_plain(*pt_case, **pt_kw)))

    # -- pose_irls: frame 1's matches at its carried pose
    uv_m, ok, is2 = point_projection_match(K_EUROC, feats, pose0,
                                           st["pt_xyz"], st["pt_desc"],
                                           st["pt_valid"], H, W)
    pargs = (K_EUROC, pose0, uv_m, st["pt_xyz"], ok, is2,
             lf.lineq[li_k.long()].contiguous(),
             st["ln_ep6"][:, :3].contiguous(),
             st["ln_ep6"][:, 3:].contiguous(), lm_k,
             torch.ones(CAP_LNS, device=dev))
    Pk, ipk, ilk, _ = KN.pose_irls(*pargs)
    Pp, ipp, ilp, _ = KN.pose_irls_plain(*pargs)
    drot = rot_diff_rad(Pk, Pp)
    dt = float((Pk[:, 3] - Pp[:, 3]).abs().max())
    check(drot <= 1e-5 and dt <= 1e-5, f"pose_irls rotation {drot:.2e} rad, "
          f"translation {dt:.2e} m from the plain Cholesky version "
          "(<= 1e-5)")
    r = KN.project(K_EUROC, st["pt_xyz"] @ Pp[:, :3].T + Pp[:, 3]) - uv_m
    chi2 = (r * r).sum(-1) * is2
    diff = ipk != ipp
    near = (chi2 - KN.CHI2_MONO).abs() <= 0.01 * KN.CHI2_MONO
    check(bool((~diff | near).all()) and bool((ilk == ilp).all()),
          f"pose_irls inlier masks equal but for {int(diff.sum())} rows "
          "within 1% of the gate")
    # 4 rounds x 3 Gauss-Newton steps over every point (~150 operations)
    # and both endpoints of every line (~300)
    report["pose_irls"] = dict(
        **work(nbytes(*pargs[1:]) + nbytes(Pk, ipk, ilk) + 4,
               12 * (150 * CAP_PTS + 300 * CAP_LNS)),
        max_abs_err=float((Pk - Pp).abs().max()),
        ms=cuda_ms(lambda: KN.pose_irls(*pargs)),
        plain_ms=cuda_ms(lambda: KN.pose_irls_plain(*pargs)))


def check_line_kernels(img, report):
    """line_detect and line_refine_lbd on frame 1, both pyramid levels."""
    pairs = torch.from_numpy(LN._band_pair_pattern()).to(img.device)
    img1 = img.reshape(H // 2, 2, W // 2, 2).mean((1, 3)).contiguous()
    levels = ((img, N_LINE - N_LINE // 4), (img1, N_LINE // 4))
    err, det_err = 0.0, 0.0
    dets, det_out, ref_in, ref_out, n_seg = [], 0, 0, 0, 0
    for lv, (im, n) in enumerate(levels):
        dk = LN.line_detect(im, n)
        dp = LN.detect_lines(im, n)
        det_out += nbytes(dk)
        differ = int((dk[4][0] != dp[4][0]).sum()
                     + (dk[4][1] != dp[4][1]).sum())
        check(differ == 0, f"line_detect level {lv}: bf16 Scharr gradients "
              f"identical ({differ} of {2 * im.numel()} differ)")
        check_segments(f"line_detect level {lv}", dk[0], dk[3], dp[0], dp[3])
        rows = dk[3] & dp[3]
        if bool(rows.any()):
            det_err = max(det_err, float((dk[0] - dp[0])[rows].abs().max()))
        dets.append(dp)
        # the refit on the same (plain) detections
        f0 = None
        if lv == 1:
            f0 = LN.refine_lbd_plain(dets[0][4][0], dets[0][4][1],
                                     dets[0][0], dets[0][3], pairs)
        fk = LN.line_refine_lbd(dp[4][0], dp[4][1], dp[0], dp[3], pairs, f0)
        fp = LN.refine_lbd_plain(dp[4][0], dp[4][1], dp[0], dp[3], pairs, f0)
        ref_in += nbytes(dp[4], dp[0], dp[3])
        ref_out += nbytes(fk)
        n_seg += int(dp[3].sum())
        check_segments(f"line_refine_lbd level {lv}", fk.ep, fk.valid,
                       fp.ep, fp.valid)
        # descriptors of the segments that agree (same row: the refit keeps
        # the detections' order)
        both = fk.valid & fp.valid \
            & ((fk.ep - fp.ep).abs().amax(1) <= SEG_TOL_PX)
        bits = bit_agreement(fk.desc[both], fp.desc[both])
        check(bits >= BITS_SHARE, f"line_refine_lbd level {lv}: LBD bits "
              f"{bits:.4%} agree on the {int(both.sum())} segments within "
              f"{SEG_TOL_PX} px (>= 99.5%)")
        if bool(both.any()):
            err = max(err, float((fk.ep - fp.ep)[both].abs().max()))
    lk1, lk2 = LN.LineExtractor(N_LINE).to(img.device)(img), \
        LN.LineExtractor(N_LINE).to(img.device)(img)
    check(all(torch.equal(x, y) for x, y in zip(lk1, lk2)),
          "line kernels: two runs of the pyramid give identical outputs")
    # bf16 Scharr (2 x 9 products), the cell structure tensors, links and
    # components: ~60 operations a pixel
    report["line_detect"] = dict(
        **work(nbytes(img, img1) + det_out, 60 * (img.numel() + img1.numel())),
        max_abs_err=det_err,
        ms=cuda_ms(lambda: [LN.line_detect(im, n) for im, n in levels]),
        plain_ms=cuda_ms(lambda: [LN.detect_lines(im, n)
                                  for im, n in levels], reps=5))
    dp0, dp1 = dets
    f0 = LN.refine_lbd_plain(dp0[4][0], dp0[4][1], dp0[0], dp0[3], pairs)

    def refine(fn):
        fn(dp0[4][0], dp0[4][1], dp0[0], dp0[3], pairs)
        fn(dp1[4][0], dp1[4][1], dp1[0], dp1[3], pairs, f0)
    # per segment: the refit's gradient snaps and the banded LBD, ~15k
    # operations
    report["line_refine_lbd"] = dict(
        **work(ref_in + ref_out, 15000 * n_seg),
        max_abs_err=err, ms=cuda_ms(lambda: refine(LN.line_refine_lbd)),
        plain_ms=cuda_ms(lambda: refine(LN.refine_lbd_plain), reps=5))


def vi_frame1_case(step, img, carry, xs, st):
    """The inputs of the VI optimizer on frame 1, as the step forms them."""
    pose_wb, vel, bg, ba, H15 = carry
    _, gyro, acc, dts = xs
    imu = IMU.imu_preint_plain(gyro, acc, dts, step.imu_mask, step.calib,
                               bg, ba, pose_wb, vel)
    pre = imu.pre
    pose_cw = torch.cat([imu.R2.T, (-imu.R2.T @ imu.p2)[:, None]], 1)
    with torch.no_grad():
        feats = step.orb(img)
    uv_m, ok, is2 = point_projection_match(
        K_EUROC, feats, pose_cw.contiguous(), st["pt_xyz"], st["pt_desc"],
        st["pt_valid"], H, W)
    pre_const = {"dT": pre.dT, "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
                 "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
                 "JPg": pre.JPg, "JPa": pre.JPa, "bg0": pre.bias_gyro,
                 "ba0": pre.bias_acc}
    prior_const = {"R0": pose_wb[:, :3], "p0": pose_wb[:, 3], "v0": vel,
                   "bg0": bg, "ba0": ba}
    eye = torch.eye(3, device=img.device)
    z3 = torch.zeros(3, device=img.device)
    return (K_EUROC, eye, z3, step.calib.gravity,
            torch.cat([imu.R2, imu.p2[:, None]], 1), imu.v2, bg, ba,
            uv_m.contiguous(), st["pt_xyz"], ok, is2, pose_wb, vel,
            pre_const, imu.imu_info, step.rw_info, prior_const, H15)


def check_vi_kernels(step, img, carry, xs, st, report):
    """imu_preint on window 1, vi_pose_lm on frame 1 both ways."""
    pose_wb, vel, bg, ba, _ = carry
    _, gyro, acc, dts = xs
    args = (gyro, acc, dts, step.imu_mask, step.calib, bg, ba, pose_wb, vel)
    fk = IMU.imu_preint(*args)
    fp = IMU.imu_preint_plain(*args)
    errs = {}
    for f in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"):
        a, b = getattr(fk.pre, f).double(), getattr(fp.pre, f).double()
        errs[f] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    for f in ("R2", "v2", "p2"):
        a, b = getattr(fk, f).double(), getattr(fp, f).double()
        errs[f] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-5, f"imu_preint deltas, Jacobians, covariance "
          f"and prediction within 1e-5 relative (worst {worst} "
          f"{errs[worst]:.2e})")
    fro = float((fk.imu_info - fp.imu_info).norm() / fp.imu_info.norm())
    check(fro <= 1e-4, f"imu_preint imu_info within {fro:.2e} relative "
          "Frobenius of the LU inverse (<= 1e-4)")
    # per sample the 15x15 covariance propagation A C A^T (~13.5k
    # operations), then the 9x9 inverse
    report["imu_preint"] = dict(
        **work(nbytes(gyro, acc, dts) + nbytes(fk), 13500 * gyro.shape[0]
               + 2000),
        max_abs_err=errs[worst], ms=cuda_ms(lambda: IMU.imu_preint(*args)),
        plain_ms=cuda_ms(lambda: IMU.imu_preint_plain(*args)))

    case = vi_frame1_case(step, img, carry, xs, st)
    worst_err = 0.0
    lm_iters = []
    for hp in (True, False):
        ok_ = KN.vi_pose_lm(*case, hp)
        op_ = KN.vi_pose_opt_plain(*case, hp,
                                   stats=lm_iters if hp else None)
        drot = rot_diff_rad(ok_[0], op_[0])
        dt = float((ok_[0][:, 3] - op_[0][:, 3]).abs().max())
        nk, np_ = int(ok_[5]), int(op_[5])
        hrel = float((ok_[6] - op_[6]).norm() / op_[6].norm())
        print(f"  vi_pose_lm have_prior={hp}: rotation {drot:.2e} rad, "
              f"position {dt:.2e} m, velocity "
              f"{float((ok_[1] - op_[1]).abs().max()):.2e}, biases "
              f"{float((ok_[2] - op_[2]).abs().max()):.2e} / "
              f"{float((ok_[3] - op_[3]).abs().max()):.2e}, inliers {nk} vs "
              f"{np_}, H15 {hrel:.2e} relative Frobenius")
        check(drot <= 1e-4 and dt <= 1e-4, f"vi_pose_lm have_prior={hp}: "
              "pose within 1e-4 rad / 1e-4 m of the plain version")
        check(abs(nk - np_) <= 0.01 * max(np_, 1),
              f"vi_pose_lm have_prior={hp}: inliers within 1%")
        check(hrel <= 1e-3, f"vi_pose_lm have_prior={hp}: H15 within 1e-3 "
              "relative Frobenius")
        worst_err = max(worst_err, float((ok_[0] - op_[0]).abs().max()))
    # per LM iteration (the plain version's count on the same data): the
    # linearization and the cost of every edge (~250 operations each),
    # then the 30x30 factorization
    cap = case[9].shape[0]
    report["vi_pose_lm"] = dict(
        **work(nbytes(*case[8:12]) + 448 * 4 + 246 * 4 + cap + 4,
               sum(lm_iters) * (250 * cap + 2 * 30 ** 3)),
        max_abs_err=worst_err, ms=cuda_ms(lambda: KN.vi_pose_lm(*case, True)),
        plain_ms=cuda_ms(lambda: KN.vi_pose_opt_plain(*case, True), reps=3,
                         warmup=1))


def perturbed_window(A):
    """A copy of a mapping window with inputs.perturb_window's start."""
    B = dict(A)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    B["kf_poses"] = torch.from_numpy(P).to(A["kf_poses"].device)
    B["pt_xyz"] = torch.from_numpy(X).to(A["pt_xyz"].device)
    return B


def centre_err(P, G):
    """Largest camera-centre distance (m) between two KF pose stacks."""
    P, G = P.double().cpu(), G.double().cpu()
    c = -torch.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -torch.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float((c - cg).norm(dim=1).max())


def within(v, lo, hi, slack=0):
    """v within 10% of lo..hi (or within `slack` of it)."""
    return min(0.9 * lo, lo - slack) <= v <= max(1.1 * hi, hi + slack)


def check_band(what, vals, lo, hi, slack=0, median=False):
    """The guard on a count against the reference's range lo..hi over its
    seeds: every value of `vals` within 10% of it (or within `slack`),
    and with `median` the median inside it where it has a width."""
    med = float(np.median(vals))
    inside = not median or hi == lo or lo <= med <= hi
    check(all(within(v, lo, hi, slack) for v in vals) and inside,
          f"{what} {vals} (median {med:g}) within 10% "
          + (f"or {slack} " if slack else "")
          + f"of the reference's {lo}..{hi} over its seeds"
          + (", the median inside it" if median and hi > lo else ""))


def changed(ref, idx, ok):
    """Rows whose match differs from (ref_idx, ref_ok)."""
    ri, rok = ref
    return int(((ok != rok) | (ok & rok & (idx != ri))).sum())


def epipolar_gate_case(A, dev):
    """The path's window at n_feat, reshaped so that every gate of the
    epipolar match decides some rows: 1 px noise on uv_a and mixed
    octaves (the epipolar gate), a few flipped bits everywhere, 72 flipped
    bits on 32 rows (max_dist 60), 32 columns duplicated next to their
    twin (the ratio test) and 32 rows duplicated next to their twin (the
    mutual check).  Returns the kernel's arguments and keywords."""
    g = torch.Generator().manual_seed(12)
    n = A["desc"].shape[0]
    d1 = A["desc"].cpu().clone()
    d2 = d1 ^ (torch.randint(0, 2, (n, 8), generator=g) << 7).to(torch.int32)
    uv1 = A["uv_a"].cpu() + torch.randn(n, 2, generator=g)
    uv2 = A["uv_b"].cpu().clone()
    d2[400:432] = d1[400:432] ^ 0x1FF
    d2[756:788], uv2[756:788] = d2[500:532], uv2[500:532] + 0.25
    d1[900:932], uv1[900:932] = d1[600:632], uv1[600:632] + 0.25
    th = 2.0 * torch.pow(1.2, torch.randint(0, 4, (n,), generator=g).float())
    F = KN.fundamental(K_EUROC, A["pose_a"], A["pose_b"])
    args = (d1.to(dev), d2.to(dev), A["ok"], A["ok"],
            uv1.contiguous().to(dev), uv2.to(dev))
    return args, dict(radius=0.0, max_dist=60.0, ratio=0.8, epi_F=F,
                      epi_th=th.to(dev))


def epipolar_gate_effects(args, kw, ref):
    """Rows whose match changes when one gate of the plain version is left
    out: each must be > 0 for the kernel's equality to test that gate."""
    d1, d2, ok1, ok2, uv1, uv2 = args
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(d1), M.unpack_u32_to_pm1(d2))
    gate = M.epipolar_gate(kw["epi_F"], uv1, uv2, kw["epi_th"])
    nn = M.match_nn_ratio
    return {
        "epipolar": changed(ref, *nn(dist, ok1, ok2, None, 60.0, 0.8)),
        "ratio": changed(ref, *nn(dist, ok1, ok2, gate, 60.0, 1e30)),
        "mutual": changed(ref, *nn(dist, ok1, ok2, gate, 60.0, 0.8,
                                   mutual=False)),
        "max_dist": changed(ref, *nn(dist, ok1, ok2, gate, 1e30, 0.8))}


def triangulate_gate_case(A, dev):
    """Pairs of the path's window at n_feat (float64 construction): 0.7 px
    noise on uv_b, 3 px on 32 rows (the reprojection gate), the first 10
    rows swapped, 32 rows at 1 cm from one camera (the depth gate), 32
    rows at 300 baselines (the parallax gate) and 10% invalid.  Returns
    the kernel's arguments."""
    g = torch.Generator().manual_seed(11)
    P1, P2 = A["pose_a"].double().cpu(), A["pose_b"].double().cpu()
    R21 = P2[:, :3] @ P1[:, :3].T
    t21 = P2[:, 3] - R21 @ P1[:, 3]
    uv1 = A["uv_a"].double().cpu()
    n = uv1.shape[0]
    uv2 = A["uv_b"].double().cpu() + 0.7 * torch.randn(n, 2, generator=g,
                                                        dtype=torch.float64)
    uv2[:10] = uv2[:10].flip(0)
    uv2[300:332] += 3.0 * torch.randn(32, 2, generator=g,
                                      dtype=torch.float64)
    ray = torch.stack([(uv1[:, 0] - K_EUROC.cx) / K_EUROC.fx,
                       (uv1[:, 1] - K_EUROC.cy) / K_EUROC.fy,
                       torch.ones(n, dtype=torch.float64)], -1)
    a = (ray @ R21.T)[:, 2]
    base = float((R21.T @ t21).norm())
    # depth 1 cm in view 1, or 1 cm in view 2 where view 1's would put
    # the point behind view 2
    s_near = torch.maximum(torch.full_like(a, 0.01), (0.01 - t21[2]) / a)
    for rows, s in ((slice(100, 132), s_near[100:132]),
                    (slice(200, 232), torch.full((32,), 300.0 * base,
                                                 dtype=torch.float64))):
        X2 = (s[:, None] * ray[rows]) @ R21.T + t21
        uv2[rows] = torch.stack([K_EUROC.fx * X2[:, 0] / X2[:, 2] + K_EUROC.cx,
                                 K_EUROC.fy * X2[:, 1] / X2[:, 2]
                                 + K_EUROC.cy], -1)
    valid = torch.rand(n, generator=g) < 0.9
    th = torch.full((n,), 5.991, device=dev)
    return (K_EUROC, A["pose_a"], A["pose_b"], A["uv_a"],
            uv2.float().to(dev), valid.to(dev), th, th)


def triangulate_gate_effects(targs, Xw):
    """Valid rows that fail exactly one gate of the plain version (depth,
    parallax, reprojection), recomputed from its world points: a kernel
    that skipped that gate would call them good."""
    K, P1, P2, uv1, uv2, valid, th1, th2 = [
        x.double().cpu() if torch.is_tensor(x) and x.is_floating_point()
        else x.cpu() if torch.is_tensor(x) else x for x in targs]
    Xw = Xw.double().cpu()
    X1 = Xw @ P1[:, :3].T + P1[:, 3]
    X2 = Xw @ P2[:, :3].T + P2[:, 3]
    C1, C2 = -P1[:, :3].T @ P1[:, 3], -P2[:, :3].T @ P2[:, 3]
    r1, r2 = Xw - C1, Xw - C2
    cosp = (r1 * r2).sum(-1) / (r1.norm(dim=-1) * r2.norm(dim=-1))

    def err(X, uv):
        z = X[:, 2].clamp_min(1e-9)
        e = torch.stack([K.fx * X[:, 0] / z + K.cx,
                         K.fy * X[:, 1] / z + K.cy], -1) - uv
        return (e * e).sum(-1)
    fail = {"depth": (X1[:, 2] <= 0.02) | (X2[:, 2] <= 0.02),
            "parallax": cosp >= 0.99995,
            "reprojection": (err(X1, uv1) >= th1) | (err(X2, uv2) >= th2)}
    out = {}
    for k, f in fail.items():
        others = torch.zeros_like(f)
        for k2, f2 in fail.items():
            if k2 != k:
                others |= f2
        out[k] = int((valid & f & ~others).sum())
    return out


def well_gap(cand, ref, Hpp):
    """Per landmark, |cand - ref| along the eigen-directions of Hpp whose
    eigenvalue is >= 1e-3 of the block's largest, relative to |ref|: the
    directions the observations determine (a line endpoint's slide along
    its line and a low-parallax point's depth are left out, where the
    damping floor decides).  Returns (gap [P], directions kept [P])."""
    ev, V = torch.linalg.eigh(Hpp.double())
    occ = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1) > 1e-9
    keep = (ev >= 1e-3 * ev[:, -1:].clamp_min(1e-30)) & occ[:, None]
    d = torch.einsum("pdk,pd->pk", V, cand.double() - ref.double()) * keep
    return d.norm(dim=1) / ref.double().norm(dim=1), keep.sum(1)


def backsub_reference(hp, W, lm_idx, kf_idx, free, dx, X, lam,
                      dt=torch.float64):
    """The landmark back-substitution of the engine's Schur step
    (damping floor, occupied gate, chol_invT_blocks, blk_ok, the explicit
    Dinv = F F^T) in dtype dt from the kernel's own system: hp [P, D(D+1)/2
    + D] packed Hpp and gp, W [O, 6 D] per-observation couplings, the
    kernel's pose step dx.  Returns (candidate landmarks, occupied,
    condition number of each damped block)."""
    D = X.shape[1]
    NU = D * (D + 1) // 2
    lf = free.to(dt)
    Hpp = unpack_sym(hp[:, :NU], D).to(dt) * lf[:, None, None]
    g = hp[:, NU:].to(dt) * lf[:, None]
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hd = Hpp + torch.diag_embed(dpp * lam + 1e-4 * dpp.mean(-1, keepdim=True)
                                + 1e-6)
    occ = (dpp.sum(-1) > 1e-9) & free
    Hd = torch.where(occ[:, None, None], Hd,
                     torch.eye(D, dtype=Hd.dtype, device=Hd.device))
    Fc = E.chol_invT_blocks(Hd)
    occ = occ & torch.isfinite(Fc).all(-1).all(-1) \
        & (Fc.abs().amax((-2, -1)) < 1e3)
    Wo = W.to(dt).view(-1, 6, D) * lf[lm_idx, None, None]
    d = dx.to(dt).view(-1, 6)[kf_idx]
    rhs = g.index_add(0, lm_idx, -torch.einsum("oij,oi->oj", Wo, d))
    Dinv = torch.einsum("pij,pkj->pik", Fc, Fc)
    dxp = torch.einsum("pij,pj->pi", Dinv, rhs) * occ[:, None]
    return X.to(dt) + dxp, occ, torch.linalg.cond(Hd.double())


def window_residuals(poses, pts, lns, A):
    """Reprojection residuals (px) of every point and line observation of
    a mapping window: the landmarks as the observing keyframes see them,
    so null directions (depth of a point seen once, an endpoint sliding
    along its line) do not count."""
    rp = RES.point_reproj_jac(K_EUROC, poses[A["obs_kf"].long()],
                              pts[A["obs_pt"].long()], A["obs_uv"])[0]
    rl = RES.line_reproj_jac(K_EUROC, poses[A["lobs_kf"].long()],
                             lns[A["lobs_ln"].long()], A["lobs_eq"])[0]
    return rp, rl


def check_map_kernels(report):
    """The four kernels of slice 3 (and hamming_match's epipolar mode) on
    the worst-case mapping window."""
    dev = torch.device("cuda")
    sz = MAPPING_WORST
    _, A = mapping_step(**sz, device=dev)
    n = sz["n_feat"]
    # -- hamming_match, epipolar mode: the step's match
    F = KN.fundamental(K_EUROC, A["pose_a"], A["pose_b"])
    th = torch.full((n,), 2.0, device=dev)
    ecase = (A["desc"], A["desc"], A["ok"], A["ok"], A["uv_a"], A["uv_b"])
    ekw = dict(radius=0.0, max_dist=60.0, ratio=0.8, epi_F=F, epi_th=th)
    ik, okk = M.hamming_match(*ecase, **ekw)
    ip, okp = M.hamming_match_plain(*ecase, **ekw)
    check(torch.equal(ik, ip) and torch.equal(okk, okp),
          f"hamming_match epipolar mode: idx and ok identical "
          f"({int(okk.sum())} of {n} matched)")
    ecase2, ekw2 = epipolar_gate_case(A, dev)
    ik2, okk2 = M.hamming_match(*ecase2, **ekw2)
    ip2, okp2 = M.hamming_match_plain(*ecase2, **ekw2)
    eff = epipolar_gate_effects(ecase2, ekw2, (ip2, okp2))
    check(torch.equal(ik2, ip2) and torch.equal(okk2, okp2),
          f"hamming_match epipolar mode, perturbed case: idx and ok "
          f"identical ({int(okk2.sum())} of {n} matched)")
    check(min(eff.values()) > 0, "hamming_match epipolar mode, perturbed "
          f"case: every gate decides some rows (rows that change without "
          f"it: {eff})")
    report["hamming_match"]["epipolar_ms"] = cuda_ms(
        lambda: M.hamming_match(*ecase, **ekw))
    report["hamming_match"]["epipolar_plain_ms"] = cuda_ms(
        lambda: M.hamming_match_plain(*ecase, **ekw))
    # -- rot_hist: the step's case (radians) and a tie-heavy one
    g = torch.Generator().manual_seed(1)
    rot = torch.cat([torch.tensor([18.0, 78.0, 138.0, 270.0])
                     .repeat_interleave(200), torch.rand(n - 800, generator=g)
                     * 360])
    a2 = torch.rand(n, generator=g) * 360
    hcases = [(A["ang"], A["ang"], ik, okk),
              (((a2 + rot) % 360).to(dev), a2.to(dev),
               torch.arange(n, dtype=torch.int32, device=dev),
               (torch.rand(n, generator=g) < 0.95).to(dev))]
    for i, hc in enumerate(hcases):
        hk, hp = M.rot_hist(*hc), M.rotation_histogram_filter(*hc)
        check(torch.equal(hk, hp), f"rot_hist case {i}: masks identical "
              f"({int(hk.sum())} of {int(hc[3].sum())} kept)")
    report["rot_hist"] = dict(
        **work(n * (4 + 4 + 4 + 1) + n, 8 * n), max_abs_err=0.0,
        ms=cuda_ms(lambda: M.rot_hist(*hcases[0])),
        plain_ms=cuda_ms(lambda: M.rotation_histogram_filter(*hcases[0])))
    # -- triangulate: the step's matched pairs
    targs = (K_EUROC, A["pose_a"], A["pose_b"], A["uv_a"],
             A["uv_b"][ik.long()].contiguous(), okk,
             torch.full((n,), 5.991, device=dev),
             torch.full((n,), 5.991, device=dev))
    Xk, gk = KN.triangulate(*targs)
    Xp, gp = KN.triangulate_plain(*targs)
    trel = float(((Xk - Xp).norm(dim=1) / Xp.norm(dim=1))[gk & gp].max())
    check(torch.equal(gk, gp) and trel <= 1e-4,
          f"triangulate: good masks identical ({int(gk.sum())} good), "
          f"points within {trel:.2e} relative (<= 1e-4)")
    targs2 = triangulate_gate_case(A, dev)
    Xk2, gk2 = KN.triangulate(*targs2)
    Xp2, gp2 = KN.triangulate_plain(*targs2)
    trel2 = float(((Xk2 - Xp2).norm(dim=1) / Xp2.norm(dim=1))[gk2 & gp2]
                  .max())
    eff = triangulate_gate_effects(targs2, Xp2)
    eff["invalid"] = int((~targs2[5]).sum())
    check(torch.equal(gk2, gp2) and trel2 <= 1e-4,
          f"triangulate, perturbed case: good masks identical "
          f"({int(gk2.sum())} of {n} good), points within {trel2:.2e} "
          "relative (<= 1e-4)")
    check(min(eff.values()) > 0, "triangulate, perturbed case: every gate "
          f"alone rejects some rows ({eff})")
    # per pair: A^T A, ~6 Jacobi sweeps of 6 rotations on 4x4, the gates
    report["triangulate"] = dict(
        **work(nbytes(*targs[1:]) + nbytes(Xk, gk), 3000 * n),
        max_abs_err=float((Xk - Xp)[gk].abs().max()),
        ms=cuda_ms(lambda: KN.triangulate(*targs)),
        plain_ms=cuda_ms(lambda: KN.triangulate_plain(*targs)))
    # -- ba_linearize and schur_solve: one LM step of the perturbed window
    B = perturbed_window(A)
    keys = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
            "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free",
            "lobs_kf", "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")
    S = 6 * sz["n_kf"]
    w = KN._BAWork(K_EUROC, *[B[k] for k in keys], lam0=1e-4,
                   early_tol=1e-2, cg_iters=min(max(S // 2, 16), 128))
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    prob = KN._ba_problem(
        K_EUROC, sz["n_kf"], sz["n_pt"], sz["n_ln"], B["obs_kf"].long(),
        B["obs_pt"].long(), B["obs_uv"], B["obs_valid"], B["obs_is2"],
        B["lobs_kf"].long(), B["lobs_ln"].long(), B["lobs_eq"],
        B["lobs_valid"], B["lobs_is2"])
    st = {"pose": B["kf_poses"], "pt": B["pt_xyz"], "ln": B["ln_ep6"]}
    layout, H, gv, lm_sys, cost, _ = prob.build_normal_equations(st)
    t = w.t
    Hk = torch.block_diag(*unpack_sym(t["hcc"][:, :21], 6).unbind(0))
    errs = {"H": rel_err(Hk, H), "g": rel_err(t["hcc"][:, 21:].reshape(-1),
                                              gv),
            "Hpp points": rel_err(unpack_sym(t["hpt"][:, :6], 3),
                                  lm_sys["pt"][0]),
            "gp points": rel_err(t["hpt"][:, 6:], lm_sys["pt"][1]),
            "Hpp lines": rel_err(unpack_sym(t["hln"][:, :21], 6),
                                 lm_sys["ln"][0]),
            "gp lines": rel_err(t["hln"][:, 21:], lm_sys["ln"][1]),
            "cost": abs(float(t["ctrl"][1]) - float(cost)) / float(cost)}
    # the couplings: the per-observation blocks summed per (KF, landmark)
    for fam, Wo, okf, olm in (("points", t["p_w"], B["obs_kf"], B["obs_pt"]),
                              ("lines", t["l_w"], B["lobs_kf"],
                               B["lobs_ln"])):
        Bp = lm_sys["pt" if fam == "points" else "ln"][2]
        D = Wo.shape[1] // 6
        P = Bp.shape[1] // D
        Bk = torch.zeros(sz["n_kf"], P, 6, D, dtype=torch.float64, device=dev)
        Bk.index_put_((okf.long(), olm.long()), Wo.double().view(-1, 6, D),
                      accumulate=True)
        errs[f"B {fam}"] = rel_err(Bk.permute(0, 2, 1, 3).reshape(Bp.shape),
                                   Bp.double())
    worst = max(errs, key=errs.get)
    print(f"  ba_linearize relative errors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(errs[worst] <= 1e-4, "ba_linearize: H blocks, g, Hpp, gp, the "
          "couplings B and the "
          f"cost within 1e-4 relative of the plain engine (worst {worst} "
          f"{errs[worst]:.2e})")
    n_obs, n_lobs = sz["n_obs"], sz["n_lobs"]
    n_pt, n_ln, n_kf = sz["n_pt"], sz["n_ln"], sz["n_kf"]
    lin_in = nbytes(*[B[k] for k in keys])
    lin_out = nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"])
    report["ba_linearize"] = dict(
        **work(lin_in + lin_out, 400 * n_obs + 1100 * n_lobs),
        max_abs_err=errs[worst],
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: prob.build_normal_equations(st), reps=5))
    KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    ff_ref = torch.mm(t["gm"], t["gm"].T)
    gram_err = rel_err(t["ff"], ff_ref)
    check(gram_err <= 1e-5, f"schur_solve: Gram fill-in within {gram_err:.2e}"
          " relative of torch.mm on its operand (<= 1e-5)")
    lam = torch.tensor(1e-4, device=dev)
    free = ({"pose": B["kf_free"]}, {"pt": B["pt_free"], "ln": B["ln_free"]})
    new = prob.step_from_system(layout, H, gv, lm_sys, st, lam, *free)
    dpose = float((t["cposes"].view(n_kf, 3, 4) - new["pose"]).abs().max())
    check(dpose <= 1e-4, f"schur_solve: candidate KF poses within 1e-4 of "
          f"the plain engine's step (max {dpose:.2e})")
    # the landmarks: against a float64 back-substitution from the kernel's
    # own system (held to the plain one above) and pose step on every
    # occupied landmark, in float32 ulps times the block's condition
    # number: at most the larger of 32 and 4x what the plain float32
    # formulas reach on the same inputs; and against the plain step along
    # Hpp's well-conditioned directions, to 1e-3 relative: the two pose
    # steps differ by up to ~7e-5 (the fixed-step CG in float32, summed in
    # another order), which moves the landmarks by ~4e-4 relative
    eps = 2.0 ** -24
    for fam, cand, ref, X, hp, W, obs_lm, obs_kf, lfree in (
            ("points", t["cpts"], new["pt"], B["pt_xyz"], t["hpt"], t["p_w"],
             B["obs_pt"], B["obs_kf"], B["pt_free"]),
            ("lines", t["clns"], new["ln"], B["ln_ep6"], t["hln"], t["l_w"],
             B["lobs_ln"], B["lobs_kf"], B["ln_free"])):
        rel, kept = well_gap(cand, ref,
                             lm_sys["pt" if fam == "points" else "ln"][0])
        bargs = (hp, W, obs_lm.long(), obs_kf.long(), lfree, t["dx"], X, 1e-4)
        r64, occ, cond = backsub_reference(*bargs)
        r32 = backsub_reference(*bargs, dt=torch.float32)[0]
        scale = eps * cond * (r64 - X.double()).norm(dim=1) + 1e-7

        def ulps(c):
            return float(((c.double() - r64).norm(dim=1) / scale)[occ].max())
        u_k, u_32 = ulps(cand), ulps(r32)
        lim = max(32.0, 4 * u_32)
        print(f"  schur_solve {fam}: {int((kept > 0).sum())} of {rel.numel()}"
              f" with well-conditioned directions ({int(kept.sum())} in all),"
              f" within {float(rel.max()):.2e} relative of the plain step "
              f"along them; {int(occ.sum())} occupied (largest condition "
              f"number {float(cond[occ].max()):.3g}), within {u_k:.2f} ulps "
              f"x condition number of the float64 back-substitution (the "
              f"plain float32 formulas: {u_32:.2f})")
        check(int(kept.sum()) > 0 and float(rel.max()) <= 1e-3,
              f"schur_solve: candidate {fam} within 1e-3 relative of the "
              "plain step along Hpp's well-conditioned directions")
        check(int(occ.sum()) > 0 and u_k <= lim,
              f"schur_solve: candidate {fam} within {lim:.1f} ulps x "
              "condition number of a float64 back-substitution from the "
              "kernel's own system, every occupied landmark")
        occ_k = (t["occ_pt"] if fam == "points" else t["occ_ln"]).bool()
        check(torch.equal(occ_k, occ) and bool((cand[~occ] == X[~occ]).all()),
              f"schur_solve {fam}: occupied gate as the float64 one's, and "
              "the landmarks outside it unchanged")

    def schur():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    C = 3 * n_pt + 6 * n_ln

    def gram_ops(obs_kf, obs_lm, n_lm, D):
        # the fill-in's least work: per landmark seen from m keyframes, the
        # upper triangle of its (6m x 6m) block, D multiply-adds an entry
        key = torch.unique(obs_kf.long() * n_lm + obs_lm.long())
        m = torch.bincount(key % n_lm, minlength=n_lm).double()
        return float((6 * m * (6 * m + 1) / 2 * D * 2).sum())
    # the landmark factors and the per-observation G = W F, the fill-in,
    # the CG (2 S^2 per iteration) and the back-substitution
    report["schur_solve"] = dict(
        **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"],
                      t["poses"], t["pts"], t["lns"])
               + nbytes(t["cposes"], t["cpts"], t["clns"], t["dx"]),
               300 * n_pt + 1500 * n_ln + 250 * n_obs + 1000 * n_lobs
               + gram_ops(B["obs_kf"], B["obs_pt"], n_pt, 3)
               + gram_ops(B["lobs_kf"], B["lobs_ln"], n_ln, 6)
               + w_cg(S) * 2 * S * S),
        max_abs_err=dpose, ms=cuda_ms(schur),
        plain_ms=cuda_ms(lambda: prob.step_from_system(
            layout, H, gv, lm_sys, st, lam, *free), reps=5),
        gram_ms=cuda_ms(lambda: torch.mm(t["gm"], t["gm"].T, out=ff_ref)),
        gram_work=work(nbytes(t["gm"], t["ff"]), 2 * S * S * C))


def _cast(v, dt):
    if isinstance(v, dict):
        return {k: _cast(x, dt) for k, x in v.items()}
    return v.to(dt) if torch.is_tensor(v) and v.is_floating_point() else v


def liba_problem(A, args, terms=None):
    """The plain engine's inertial window problem at the window's masks
    (only the named terms, if given) and its states and free masks."""
    dt = args[0].dtype
    prob = KN._liba_problem(
        K_EUROC, A["Rcb"].to(dt), A["tcb"].to(dt), GRAVITY,
        A["kf_pose_wb"].shape[0], A["pt_xyz"].shape[0], A["ln_ep6"].shape[0],
        (args[8].long(), args[9].long(), args[10], args[12]), args[11],
        (args[20].long(), args[21].long(), args[22]), args[23],
        (args[13], args[14], args[15], args[16], args[17]))
    if terms is not None:
        prob.terms = [t for t in prob.terms if t.name in terms]
    st = {"pose": args[0], "vel": args[1], "bg": args[2], "ba": args[3],
          "pt": args[6], "ln": args[18]}
    free = ({"pose": args[4], "vel": args[4], "bg": args[5],
             "ba": args[5]}, {"pt": args[7], "ln": args[19]})
    return prob, st, free


def check_inertial_kernels(report):
    """The kernels of slice 4 against their plain versions: ba_linearize's
    body-frame mode, inertial_chain and schur_solve's 15-DoF step on one
    LM step of the perturbed worst-case inertial window, and
    inertial_gs_lm (initialization and refinement) at the cap of 32 KF."""
    dev = torch.device("cuda")
    _, A = inertial_ba_step(**LIBA_WORST, perturbed=True, device=dev)
    args = [A[k] for k in KN.LIBA_KEYS]
    n_kf, n_pt, n_ln = 16, LIBA_WORST["n_pt"], LIBA_WORST["n_ln"]
    n_obs, n_lobs = LIBA_WORST["n_obs"], LIBA_WORST["n_lobs"]
    w = KN.inertial_work(K_EUROC, A["Rcb"], A["tcb"], GRAVITY, *args)
    w.chain(KN.CHAIN_COST_STATE)
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    w.chain(KN.CHAIN_LINEARIZE)
    t = w.t
    # -- ba_linearize (body frame): the visual terms alone
    vis, st, free = liba_problem(A, args, ("reproj", "line"))
    _, Hv, gv, lm_sys, cost_v, _ = vis.build_normal_equations(st)
    S6 = 6 * n_kf
    Hk = torch.block_diag(*unpack_sym(t["hcc"][:, :21], 6).unbind(0))
    errs = {"pose blocks": rel_err(Hk, Hv[:S6, :S6]),
            "g": rel_err(t["hcc"][:, 21:].reshape(-1), gv[:S6]),
            "Hpp points": rel_err(unpack_sym(t["hpt"][:, :6], 3),
                                  lm_sys["pt"][0]),
            "gp points": rel_err(t["hpt"][:, 6:], lm_sys["pt"][1]),
            "Hpp lines": rel_err(unpack_sym(t["hln"][:, :21], 6),
                                 lm_sys["ln"][0]),
            "gp lines": rel_err(t["hln"][:, 21:], lm_sys["ln"][1])}
    for fam, Wo, okf, olm in (("points", t["p_w"], A["obs_kf"], A["obs_pt"]),
                              ("lines", t["l_w"], A["lobs_kf"],
                               A["lobs_ln"])):
        Bp = lm_sys["pt" if fam == "points" else "ln"][2][:S6]
        D = Wo.shape[1] // 6
        P = Bp.shape[1] // D
        Bk = torch.zeros(n_kf, P, 6, D, dtype=torch.float64, device=dev)
        Bk.index_put_((okf.long(), olm.long()), Wo.double().view(-1, 6, D),
                      accumulate=True)
        errs[f"B {fam}"] = rel_err(Bk.permute(0, 2, 1, 3).reshape(Bp.shape),
                                   Bp.double())
    print("  ba_linearize body frame, relative errors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    blocks = {k: v for k, v in errs.items() if not k.startswith("B ")}
    worst = max(blocks, key=blocks.get)
    check(blocks[worst] <= 1e-5, "ba_linearize body frame: pose blocks, g, "
          f"Hpp and gp within 1e-5 relative of the plain engine (worst "
          f"{worst} {blocks[worst]:.2e})")
    # the couplings are per-observation products of two Jacobians formed
    # in another order (1.2e-5 for lines in both frames), as phase 3
    check(max(errs["B points"], errs["B lines"]) <= 1e-4,
          "ba_linearize body frame: the couplings B within 1e-4 relative of "
          "the plain engine")
    worst = max(errs, key=errs.get)
    # -- inertial_chain: the chain terms alone
    chn, _, _ = liba_problem(A, args, ("inertial", "bg_rw", "ba_rw"))
    _, Hc, gc, _, cost_c, _ = chn.build_normal_equations(st)
    Hl, gl = KN.inertial_dense_system(t, n_kf)
    Hl[:S6, :S6] -= Hk.double()
    gl[:S6] -= t["hcc"][:, 21:].double().reshape(-1)
    full, _, _ = liba_problem(A, args)
    _, H, g, lm_full, cost, _ = full.build_normal_equations(st)
    cerr = {"H": rel_err(Hl, Hc.double()), "g": rel_err(gl, gc.double()),
            "chain cost": abs(float(t["ccost"][0]) - float(cost_c))
            / float(cost_c),
            "cost": abs(float(t["ctrl"][1]) - float(cost)) / float(cost)}
    print("  inertial_chain relative errors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in cerr.items()))
    check(max(cerr.values()) <= 1e-5, "inertial_chain: H and g blocks of "
          "the inertial and bias random-walk edges, the chain's cost and the "
          "step's cost within 1e-5 relative of the plain engine's "
          "build_normal_equations")
    lin_in = nbytes(*[A[k] for k in KN.LIBA_KEYS if k != "pre_const"]) \
        + nbytes(*A["pre_const"].values())
    lin_out = nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"])
    report["ba_linearize"]["inertial"] = dict(
        **work(lin_in + lin_out, 450 * n_obs + 1200 * n_lobs),
        max_abs_err=errs[worst],
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: vis.build_normal_equations(st), reps=3))
    # per link: residual, Jacobian and the 9x9 Cholesky (~2k), the
    # whitening of 25 columns (~2.3k), 495 block entries (~9k)
    n_e = n_kf - 1
    ch_in = nbytes(t["poses"], t["kfx"], t["pre"], t["imu_info"],
                   t["edge_valid"], t["rw_g"], t["rw_a"])
    report["inertial_chain"] = dict(
        **work(ch_in + nbytes(t["link"], t["link_cost"], t["ccost"]),
               13500 * n_e),
        max_abs_err=max(cerr.values()),
        ms=cuda_ms(lambda: w.chain(KN.CHAIN_LINEARIZE)),
        plain_ms=cuda_ms(lambda: chn.build_normal_equations(st), reps=5))
    # -- schur_solve, 15-DoF: one step against the plain step and float64
    KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    lam = torch.tensor(1e-4, device=dev)
    new = full.step_from_system(*full.build_normal_equations(st)[:4], st,
                                lam, *free)
    A64 = {k: A[k].cpu() for k in ("kf_pose_wb", "pt_xyz", "ln_ep6", "Rcb",
                                   "tcb")}
    args64 = [_cast(a.cpu() if torch.is_tensor(a) else
                    {k: x.cpu() for k, x in a.items()}, torch.float64)
              for a in args]
    p64, st64, free64 = liba_problem(A64, args64)
    ref, _, _ = p64.solve_step(st64, torch.tensor(1e-4, dtype=torch.float64),
                               *free64)
    args32 = [_cast(a, torch.float32) for a in args64]
    p32, st32, free32 = liba_problem(A64, args32)
    cpu32, _, _ = p32.solve_step(st32, torch.tensor(1e-4), *free32)
    kfx = t["ckfx"]
    cand = {"pose": t["cposes"].view(n_kf, 3, 4), "vel": kfx[:, :3],
            "bg": kfx[:, 3:6], "ba": kfx[:, 6:]}
    gaps = {}
    for name in ("pose", "vel", "bg", "ba"):
        gk = float((cand[name].double().cpu() - ref[name]).abs().max())
        gp = float((new[name].double().cpu() - ref[name]).abs().max())
        gc = float((cpu32[name].double() - ref[name]).abs().max())
        kp = float((cand[name] - new[name]).abs().max())
        gaps[name] = (gk, gp, gc, kp)
    print("  schur_solve 15-DoF step, from float64 (kernel, plain on the "
          "card, plain on the CPU) and kernel - plain: " + ", ".join(
              f"{k} {a:.2e} / {b:.2e} / {c:.2e} / {d:.2e}"
              for k, (a, b, c, d) in gaps.items()))
    # the card's plain step sums by atomics, so its float32 CG lands
    # 1.5e-6 to 2.5e-4 from the kernel's from run to run; the CPU's is
    # fixed
    check(all(gaps[k][0] <= 2 * max(gaps[k][1], gaps[k][2]) + 1e-6
              for k in ("pose", "vel")),
          "schur_solve 15-DoF: candidate poses and velocities within 2x the "
          "farther plain float32 step's (card, CPU) distance to the engine "
          "in float64")
    eps = 2.0 ** -24
    for fam, cnd, X, hp, W, obs_lm, obs_kf, lfree, key in (
            ("points", t["cpts"], A["pt_xyz"], t["hpt"], t["p_w"],
             A["obs_pt"], A["obs_kf"], A["pt_free"], "pt"),
            ("lines", t["clns"], A["ln_ep6"], t["hln"], t["l_w"],
             A["lobs_ln"], A["lobs_kf"], A["ln_free"], "ln")):
        rel, kept = well_gap(cnd, new[key], lm_full[key][0])
        rel = rel[kept > 0]              # padded slots have no direction
        bargs = (hp, W, obs_lm.long(), obs_kf.long(), lfree,
                 t["dx"][:S6], X, 1e-4)
        r64, occ, cond = backsub_reference(*bargs)
        r32 = backsub_reference(*bargs, dt=torch.float32)[0]
        scale = eps * cond * (r64 - X.double()).norm(dim=1) + 1e-7

        def ulps(c):
            return float(((c.double() - r64).norm(dim=1) / scale)[occ].max())
        u_k, u_32 = ulps(cnd), ulps(r32)
        lim = max(32.0, 4 * u_32)
        print(f"  schur_solve 15-DoF {fam}: {int((kept > 0).sum())} with "
              f"well-conditioned directions, within {float(rel.max()):.2e} "
              f"relative of the plain step along them; {int(occ.sum())} "
              f"occupied, within {u_k:.2f} ulps x condition number of the "
              f"float64 back-substitution (plain float32 formulas {u_32:.2f})")
        check(int(occ.sum()) > 0 and u_k <= lim,
              f"schur_solve 15-DoF: candidate {fam} within {lim:.1f} ulps x "
              "condition number of a float64 back-substitution from the "
              "kernel's own system, every occupied landmark")
        # the plain step's pose step varies by up to 2.5e-4 (above), which
        # moves the landmarks by up to 1.4e-3 relative along these
        # directions; the ulps check above holds the back-substitution
        check(int(kept.sum()) > 0 and float(rel.max()) <= 1e-2,
              f"schur_solve 15-DoF: candidate {fam} within 1e-2 relative of "
              "the plain step along Hpp's well-conditioned directions")
    S = 15 * n_kf

    def schur():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())

    def gram_ops(okf, olm, n_lm, D):
        key = torch.unique(okf.long() * n_lm + olm.long())
        m = torch.bincount(key % n_lm, minlength=n_lm).double()
        return float((6 * m * (6 * m + 1) / 2 * D * 2).sum())
    report["schur_solve"]["inertial"] = dict(
        **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"],
                      t["link"], t["poses"], t["kfx"], t["pts"], t["lns"])
               + nbytes(t["cposes"], t["ckfx"], t["cpts"], t["clns"],
                        t["dx"]),
               300 * n_pt + 1500 * n_ln + 250 * n_obs + 1000 * n_lobs
               + gram_ops(A["obs_kf"], A["obs_pt"], n_pt, 3)
               + gram_ops(A["lobs_kf"], A["lobs_ln"], n_ln, 6)
               + w_cg(S) * 2 * S * S),
        max_abs_err=gaps["pose"][3], ms=cuda_ms(schur),
        plain_ms=cuda_ms(lambda: full.step_from_system(
            *full.build_normal_equations(st)[:4], st, lam, *free), reps=3))
    # -- inertial_gs_lm: initialization and refinement at the cap
    m, B = imu_init(device=dev)
    mp, _ = imu_init(device=dev, plain=True)
    mc, Bc = imu_init(device="cpu")
    B64 = _cast(Bc, torch.float64)
    worst_gap = 0.0
    for name, run in (("init", lambda mm, bb: mm(bb)),
                      ("refine", lambda mm, bb: mm.refine(bb))):
        ok_, op_, ref = run(m, B), run(mp, B), run(mc, B64)
        names = ("Rwg", "scale", "bg", "ba", "vel")[:len(ref)]
        gk = {n: float((a.double().cpu() - r).abs().max())
              for n, a, r in zip(names, ok_, ref)}
        gp = {n: float((a.double().cpu() - r).abs().max())
              for n, a, r in zip(names, op_, ref)}
        kp = max(float((a - b).abs().max()) for a, b in zip(ok_, op_))
        worst_gap = max(worst_gap, kp)
        print(f"  inertial_gs_lm {name}: scale kernel {float(ok_[1]):.7f}, "
              f"plain {float(op_[1]):.7f}, float64 {float(ref[1]):.7f}; "
              f"from float64 kernel {gk}, plain {gp}")
        floor = {"Rwg": 1e-5, "scale": 1e-4, "bg": 1e-6, "ba": 1e-7,
                 "vel": 1e-5}
        check(all(gk[n] <= 2 * gp[n] + floor[n] for n in names),
              f"inertial_gs_lm {name}: within 2x the plain float32 run's "
              f"distance to the engine in float64 (+ {floor})")
    n = 32
    it = 20
    report["inertial_gs_lm"] = dict(
        # per iteration: 31 links of residual, Jacobian, whitening and
        # block (~7k), the 105x105 assembly, Cholesky (S^3 / 3) and two
        # triangular solves, and the candidate's cost (~1.5k a link)
        **work(nbytes(B["Rwg0"], B["vel0"], B["pose_R"], B["pose_p"],
                      B["imu_info"], B["edge_valid"], *B["pre_const"].values())
               + (16 + 3 * n) * 4,
               it * (31 * 8500 + (9 + 3 * n) ** 3 / 3 + 3 * (9 + 3 * n) ** 2)),
        max_abs_err=worst_gap, ms=cuda_ms(lambda: m(B)),
        plain_ms=cuda_ms(lambda: mp(B), reps=3, warmup=1))


def w_cg(S):
    return min(max(S // 2, 16), 128)


def record_nbh_calls(mp):
    """Wrap the mapper's device calls so that a run records their
    arguments: the path's own inputs for holding each kernel to its plain
    version at the path's shapes."""
    rec = {}
    for attr in ("fuse_match", "line_pair_match", "line_triangulate",
                 "local_ba_kernel", "local_ba_pl_kernel"):
        fn = getattr(mp, attr)
        rec[attr] = []

        def wrap(*a, _fn=fn, _calls=rec[attr], **kw):
            out = _fn(*a, **kw)
            _calls.append((a, {k: v for k, v in kw.items() if k != "stats"},
                           out))
            return out
        setattr(mp, attr, wrap)
    return rec


def ba_float64_gaps(rec):
    """The run's window BA (point-only or point+line, as recorded) against
    the plain engine in float64 on the CPU: the largest KF pose entry gap
    of the recorded result and of the plain float32 run on the CPU."""
    pl = bool(rec["local_ba_pl_kernel"])
    args, _, out = (rec["local_ba_pl_kernel"] if pl
                    else rec["local_ba_kernel"])[0]
    cpu = [x.cpu() for x in args]
    fn = KN.local_ba_pl_plain if pl else KN.local_ba_plain
    ref = fn(K_EUROC, *[x.double() if x.is_floating_point() else x
                        for x in cpu])[0]
    c32 = fn(K_EUROC, *cpu)[0]
    return (float((out[0].cpu().double() - ref).abs().max()),
            float((c32.double() - ref).abs().max()))


def point_stats(m, ids):
    """The tracker's frustum inputs for the map points `ids`, as
    `update_point_stats` (models/local_mapping.py:609)
    forms them: the mean viewing direction of the keyframes that bind each
    point, the distance range from its newest observation's octave."""
    kfs = m.valid_kf_indices()
    R, t = m.kf_pose_cw[kfs, :, :3], m.kf_pose_cw[kfs, :, 3]
    C = -np.einsum("kji,kj->ki", R, t)
    normal = np.zeros((len(ids), 3), np.float32)
    mx = np.zeros(len(ids), np.float32)
    for i, p in enumerate(ids):
        ks, fs = np.nonzero(m.kf_match_pt[kfs] == p)
        if len(ks) < 2:
            continue
        v = m.pt_xyz[p] - C[ks]
        d = np.linalg.norm(v, axis=1)
        n = (v / d[:, None]).sum(0)
        normal[i] = n / np.linalg.norm(n)
        j = np.argmax(m.kf_timestamp[kfs[ks]])
        mx[i] = d[j] * 1.2 ** m.kf_feat_octave[kfs[ks[j]], fs[j]]
    return normal, mx / 1.2 ** 7, mx


def check_nbh_kernels(report):
    """The kernels of slice 5 against their plain versions at the path's
    shapes: every call of one plain run of `neighborhood_step` on the card
    (the fuse's 11 projection matches at 2048 points x 1000 features, the
    line pair matches at 256 x 256, the line triangulations at 256 pairs),
    the projection matcher in the tracker's frustum mode on the first
    fuse's points, and `make_local_ba` at the run's window (16 KF x 4096
    points x 8192 observations) against the plain engine in float64."""
    dev = torch.device("cuda")
    step, m = neighborhood_step(False, device=dev, plain=True)
    rec = record_nbh_calls(step.mapper)
    with torch.no_grad():
        step(m)
    # -- proj_match, fuse mode: every call of the run
    n_eq = 0
    for a, kw, _ in rec["fuse_match"]:
        ok_, op_ = KN.proj_match(K_EUROC, *a), KN.proj_match_plain(K_EUROC,
                                                                    *a)
        n_eq += all(torch.equal(x, y) for x, y in zip(ok_, op_))
    fa = rec["fuse_match"][0][0]
    fk, fp = KN.proj_match(K_EUROC, *fa), KN.proj_match_plain(K_EUROC, *fa)
    check(n_eq == len(rec["fuse_match"]),
          f"proj_match fuse mode: uv_m, pt_feat, matched and feat_pt "
          f"identical in all {len(rec['fuse_match'])} calls of the run "
          f"({int(fk[2].sum())} of {fa[1].shape[0]} matched in the first)")
    # -- proj_match, the tracker's mode: the map's points with their
    #    frustum statistics, radius 6, max_dist 80
    ids = np.unique(m.kf_match_pt[m.valid_kf_indices()])
    ids = ids[ids >= 0][:fa[1].shape[0]]
    nrm, mn, mx = point_stats(m, ids)
    P = fa[1].shape[0]

    def pad(x):
        out = np.zeros((P,) + x.shape[1:], np.float32)
        out[:len(x)] = x
        return torch.from_numpy(out).to(dev)
    xyz = pad(m.pt_xyz[ids])
    desc = torch.from_numpy(np.ascontiguousarray(
        np.pad(m.pt_desc[ids], ((0, P - len(ids)), (0, 0))).view(np.int32)
    )).to(dev)
    live = torch.zeros(P, dtype=torch.bool, device=dev)
    live[:len(ids)] = True
    ta = (fa[0], xyz, desc, live, *fa[4:8], 6.0, 80.0, pad(nrm), pad(mn),
          pad(mx))
    tk, tp = KN.proj_match(K_EUROC, *ta), KN.proj_match_plain(K_EUROC, *ta)
    check(all(torch.equal(x, y) for x, y in zip(tk, tp)),
          "proj_match tracker mode (range and viewing-angle gates, radius "
          f"6, max 80): all four outputs identical ({int(tk[2].sum())} of "
          f"{len(ids)} matched)")
    F_ = fa[4].shape[0]
    # per row the projection and gates (~60 operations), per pair the
    # window test (~8), XOR + popc of 8 words on the pairs it admits (~17)
    scale = torch.from_numpy(KN.OCTAVE_SCALE).to(dev)[fa[6].long()]
    uvp, okp = KN.project_gates(K_EUROC, fa[0], fa[1], fa[3])
    adm = int((((uvp[:, None] - fa[4][None]) ** 2).sum(-1)
               <= (2.0 * scale) ** 2)[okp].sum())
    report["proj_match"] = dict(
        **work(nbytes(*fa[:8]) + nbytes(*fk), 60 * P + 8 * P * F_
               + 17 * adm),
        max_abs_err=float((fk[0] - fp[0]).abs().max()),
        ms=cuda_ms(lambda: KN.proj_match(K_EUROC, *fa)),
        plain_ms=cuda_ms(lambda: KN.proj_match_plain(K_EUROC, *fa)),
        tracker_ms=cuda_ms(lambda: KN.proj_match(K_EUROC, *ta)),
        tracker_plain_ms=cuda_ms(lambda: KN.proj_match_plain(K_EUROC, *ta)))
    # -- hamming_match, line pair mode: every call of the run
    n_eq = 0
    for a, kw, _ in rec["line_pair_match"]:
        ep1, d1, a1, o1, ep2, d2, a2, o2 = a
        args = (d1, d2, o1, o2, ep1, ep2)
        kw = dict(radius=80.0, max_dist=110.0, ratio=0.95, a_ang=a1,
                  b_ang=a2, angle_tol=0.25, pair=True)
        ik, okk = M.hamming_match(*args, **kw)
        ip, okp_ = M.hamming_match_plain(*args, **kw)
        n_eq += torch.equal(ik[okk], ip[okp_]) and torch.equal(okk, okp_)
    ep1, d1, a1, o1, ep2, d2, a2, o2 = rec["line_pair_match"][0][0]
    pargs = (d1, d2, o1, o2, ep1, ep2)
    pkw = dict(radius=80.0, max_dist=110.0, ratio=0.95, a_ang=a1, b_ang=a2,
               angle_tol=0.25, pair=True)
    check(n_eq == len(rec["line_pair_match"]),
          "hamming_match line pair mode: idx and ok identical in all "
          f"{len(rec['line_pair_match'])} calls of the run "
          f"({int(M.hamming_match(*pargs, **pkw)[1].sum())} of "
          f"{ep1.shape[0]} matched in the first)")
    report["hamming_match"]["pair_ms"] = cuda_ms(
        lambda: M.hamming_match(*pargs, **pkw))
    report["hamming_match"]["pair_plain_ms"] = cuda_ms(
        lambda: M.hamming_match_plain(*pargs, **pkw))
    # -- line_triangulate: every call of the run
    errs, n_eq = [], 0
    for a, kw, _ in rec["line_triangulate"]:
        ok_ = KN.line_triangulate(K_EUROC, *a)
        op_ = KN.line_triangulate_plain(K_EUROC, *a)
        n_eq += torch.equal(ok_[2], op_[2])
        g = ok_[2] & op_[2]
        if bool(g.any()):
            errs += [float(((x - y).norm(dim=1) / y.norm(dim=1))[g].max())
                     for x, y in zip(ok_[:2], op_[:2])]
    ta_ = rec["line_triangulate"][0][0]
    lk, lp = KN.line_triangulate(K_EUROC, *ta_), \
        KN.line_triangulate_plain(K_EUROC, *ta_)
    check(n_eq == len(rec["line_triangulate"]) and max(errs) <= 5e-5,
          f"line_triangulate: good masks identical in all "
          f"{len(rec['line_triangulate'])} calls ({int(lk[2].sum())} of "
          f"{int(ta_[4].sum())} good in the first), endpoints within "
          f"{max(errs):.2e} relative (<= 5e-5)")
    n = ta_[2].shape[0]
    # per pair: four ray-plane intersections, 16 depths, the plane angle,
    # agreement, perpendicular distances and length (~400 operations)
    # (rows that fail a gate hold intersections of near-coincident planes,
    # where one rounding step moves the point by metres: good rows only)
    report["line_triangulate"] = dict(
        **work(nbytes(*ta_) + nbytes(*lk), 400 * n),
        max_abs_err=max(float((x - y)[lk[2]].abs().max()) for x, y in
                        zip(lk[:2], lp[:2])),
        ms=cuda_ms(lambda: KN.line_triangulate(K_EUROC, *ta_)),
        plain_ms=cuda_ms(lambda: KN.line_triangulate_plain(K_EUROC, *ta_)))
    # -- make_local_ba: the run's window against float64
    ba = rec["local_ba_kernel"][0][0]
    cpu = [x.cpu() for x in ba]
    ref = KN.local_ba_plain(K_EUROC, *[x.double() if x.is_floating_point()
                                       else x for x in cpu])[0]

    def gap(out):
        return float((out[0].cpu().double() - ref).abs().max())
    with torch.no_grad():
        gk = gap(KN.local_ba(K_EUROC, *ba))
        gp = gap(KN.local_ba_plain(K_EUROC, *ba))
        gc = gap(KN.local_ba_plain(K_EUROC, *cpu))
    print(f"  make_local_ba (16 KF x {ba[2].shape[0]} points x "
          f"{ba[4].shape[0]} observations): KF poses from the float64 run: "
          f"kernel {gk:.2e}, plain on the card {gp:.2e}, plain on the CPU "
          f"{gc:.2e}")
    check(gk <= 2 * gc + 1e-6, "make_local_ba: the kernel path's KF poses "
          "within 2x the CPU plain run's distance to the engine in float64")
    # ba_linearize and schur_solve in make_local_ba's configuration: one LM
    # step of the window, no line family
    w = KN._BAWork(K_EUROC, *ba, *KN.no_lines(dev), lam0=1e-4,
                   early_tol=1e-2, cg_iters=w_cg(6 * ba[0].shape[0]))
    n_kf, n_pt, n_obs = ba[0].shape[0], ba[2].shape[0], ba[4].shape[0]
    prob = KN._ba_problem(K_EUROC, n_kf, n_pt, 0, ba[4].long(), ba[5].long(),
                          ba[6], ba[7], ba[8])
    st = {"pose": ba[0], "pt": ba[2]}
    lerr = max(KN.linearization_against_plain(w, prob, st).values())
    t = w.t
    check(lerr <= 1e-4, f"ba_linearize, point-only window: H blocks, g, "
          f"Hpp, gp and B within {lerr:.2e} relative of the plain engine "
          "(<= 1e-4)")
    report["ba_linearize"]["points"] = dict(
        **work(nbytes(*ba) + nbytes(t["hcc"], t["hpt"], t["p_w"]),
               400 * n_obs),
        max_abs_err=lerr,
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: prob.build_normal_equations(st), reps=5))
    S = 6 * n_kf

    def schur():
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
    schur()
    layout, H, gv, lm_sys, _, _ = prob.build_normal_equations(st)
    lam = torch.tensor(1e-4, device=dev)
    free = ({"pose": ba[1]}, {"pt": ba[3]})
    new = prob.step_from_system(layout, H, gv, lm_sys, st, lam, *free)
    dpose = float((t["cposes"].view(n_kf, 3, 4) - new["pose"]).abs().max())
    check(dpose <= 1e-4, "schur_solve, point-only window: candidate KF poses "
          f"within {dpose:.2e} of the plain engine's step (<= 1e-4)")
    key = torch.unique(ba[4].long() * n_pt + ba[5].long())
    mm = torch.bincount(key % n_pt, minlength=n_pt).double()
    report["schur_solve"]["points"] = dict(
        **work(nbytes(t["hcc"], t["hpt"], t["p_w"], t["poses"], t["pts"])
               + nbytes(t["cposes"], t["cpts"], t["dx"]),
               300 * n_pt + 250 * n_obs
               + float((6 * mm * (6 * mm + 1) / 2 * 3 * 2).sum())
               + w_cg(S) * 2 * S * S),
        max_abs_err=dpose, ms=cuda_ms(schur),
        plain_ms=cuda_ms(lambda: prob.step_from_system(
            layout, H, gv, lm_sys, st, lam, *free), reps=5))


def twoview_inputs(name, n, dev, cases=None):
    """A case of `inputs.build_twoview_cases` on the card (raw EuRoC
    pixels undistorted by the `undistort` kernel), with 200 H and 200 F
    minimal sets drawn from a generator seeded n."""
    c = (cases or build_twoview_cases(0, n))[name]
    uv1, uv2 = (torch.from_numpy(c[k]).to(dev) for k in ("uv1", "uv2"))
    if c["raw"]:
        cam = CAM.make_camera(CameraConfig())
        uv1, uv2 = (CAM.undistort(cam, u, None)[0] for u in (uv1, uv2))
    valid = torch.from_numpy(c["valid"]).to(dev)
    g = torch.Generator().manual_seed(n)
    idx_h = TV.sample_indices(valid.cpu(), 200, 4, g)
    idx_f = TV.sample_indices(valid.cpu(), 200, 8, g)
    return c, uv1, uv2, valid, idx_h, idx_f


def twoview_against_f64(name, n, uv1, uv2, valid, idx_h, idx_f):
    """Both two-view kernels against the plain version in float64 on the
    card, on the same samples (`ops.twoview.kernels_against_float64`).
    Returns (kernel output, info, the largest R / t / point gaps)."""
    g = TV.kernels_against_float64(K_EUROC, uv1, uv2, valid, idx_h, idx_f)
    torch.cuda.synchronize()
    r, rp = g.out.result, g.ref.result
    ok = bool(r.success) == bool(rp.success) == (name != "rotation") \
        and bool(r.used_homography) == bool(rp.used_homography) \
        and g.best_equal and g.score_gap <= 1e-6 \
        and max(g.gaps) <= 1e-5 and g.flips <= 0.01 * n
    check(ok, f"two-view kernels, {name} at N = {n}: success "
          f"{bool(r.success)}, homography {bool(r.used_homography)}, best "
          f"minimal models {int(g.out.b_h)} / {int(g.out.b_f)} as the "
          f"float64 plain version's (ties excepted), scores within "
          f"{g.score_gap:.1e} (<= 1e-6), R / t / points within "
          f"{g.gaps[0]:.1e} / {g.gaps[1]:.1e} / {g.gaps[2]:.1e} (<= 1e-5), "
          f"{g.flips} triangulation flips (<= 1%)")
    return g.out, g.info, g.gaps


def library_pyramid(img, specs):
    """The pyramid's levels by PyTorch's antialiased bilinear resize, its
    own weights: the library yardstick of the `pyramid` kernel (the port
    never calls it)."""
    out = [img]
    for spec in specs[1:]:
        out.append(torch.nn.functional.interpolate(
            out[-1][None, None], size=(spec.height, spec.width),
            mode="bilinear", align_corners=False, antialias=True)[0, 0])
    return out


def check_pyramid_kernels(imgs, report):
    """The `pyramid` kernels against their plain versions on the rendered
    frames: the 7 ORB levels chained as the front end runs them, each
    level also from the plain level above, and the line level; then their
    times beside the plain versions and the library calls (7 antialiased
    bilinear resizes; one 2x2 average pool)."""
    specs = FE.make_level_specs(H, W, N_FEAT)
    e_chain = e_level = e_line = 0.0
    with torch.no_grad():
        for img in imgs:
            pk = FE.build_pyramid(img, specs)
            pp = FE.build_pyramid_plain(img, specs)
            e_chain = max(e_chain, *(float((a - b).abs().max())
                                     for a, b in zip(pk, pp)))
            for lv in range(1, len(specs)):
                one = FE.pyramid_level(pp[lv - 1], specs[lv].height,
                                       specs[lv].width)
                e_level = max(e_level, float((one - pp[lv]).abs().max()))
            e_line = max(e_line, float((FE.line_level(img)
                                        - FE.line_level_plain(img)).abs()
                                       .max()))
    check(e_chain <= 1e-4 and e_level <= 1e-4,
          f"pyramid on {len(imgs)} rendered frames: every level within "
          f"{e_chain:.2e} (chained) and {e_level:.2e} (from the plain level "
          "above) of the plain version (<= 1e-4 grey levels)")
    check(e_line <= 1e-4, f"pyramid_line: the line level within "
          f"{e_line:.2e} of the plain version (<= 1e-4)")
    img = imgs[1]
    # bytes: each level reads the one above and writes itself; operations:
    # a multiply and an add per nonzero weight, over the rows (each output
    # row's taps at every input column), then the columns
    nb, ops, prev = 0, 0, (H, W)
    for sp in specs[1:]:
        nb += 4 * (prev[0] * prev[1] + sp.height * sp.width)
        wy = FE.resize_weights(prev[0], sp.height, "cpu")
        wx = FE.resize_weights(prev[1], sp.width, "cpu")
        ops += 2 * (int((wy != 0).sum()) * prev[1]
                    + int((wx != 0).sum()) * sp.height)
        prev = (sp.height, sp.width)
    report["pyramid"] = dict(
        **work(nb, ops), max_abs_err=max(e_chain, e_level),
        ms=cuda_ms(lambda: FE.build_pyramid(img, specs)),
        plain_ms=cuda_ms(lambda: FE.build_pyramid_plain(img, specs)),
        library_ms=cuda_ms(lambda: library_pyramid(img, specs)))
    h2, w2 = H // 2, W // 2
    report["pyramid_line"] = dict(
        **work(4 * (4 * h2 * w2 + h2 * w2), 4 * h2 * w2), max_abs_err=e_line,
        ms=cuda_ms(lambda: FE.line_level(img)),
        plain_ms=cuda_ms(lambda: FE.line_level_plain(img)),
        library_ms=cuda_ms(lambda: torch.nn.functional.avg_pool2d(
            img[None, None], 2)))


def check_boot_kernels(imgs, orb, lines, report):
    """The kernels of slice 6 against their plain versions: `undistort` at
    EuRoC's coefficients on the 16 frames' keypoints and segment endpoints
    (from the kernel front end), the two-view kernels on the five cases at
    200 matches and the general one at 1000 against the plain version in
    float64 on the same samples, `imu_preint` on a keyframe's window of
    128 samples (100 live)."""
    dev = imgs[0].device
    cam = CAM.make_camera(CameraConfig())
    errs, frames = [0.0, 0.0], []
    with torch.no_grad():
        for img in imgs:
            f, lf = orb(img), lines(img)
            kp, ep = f.uv.contiguous(), lf.ep.contiguous()
            uk, ek, qk = CAM.undistort(cam, kp, ep)
            up, epp, _ = CAM.undistort_frame_plain(cam, kp, ep)
            own = LN.line_equation(ek)
            errs[0] = max(errs[0], float((uk - up).abs().max()),
                          float((ek - epp).abs().max()))
            # c = (x0 y1 - y0 x1) / n cancels products of ~1e5: its
            # rounding scales with them over the length, a and b with 1
            scale = torch.stack([torch.ones_like(ek[:, 0])] * 2 + [
                ((ek[:, 0] * ek[:, 3]).abs() + (ek[:, 1] * ek[:, 2]).abs())
                / torch.linalg.vector_norm(ek[:, 2:] - ek[:, :2], dim=1)],
                1)
            errs[1] = max(errs[1], float(((qk - own).abs() / scale).max()))
            frames.append((kp, ep))
    check(errs[0] == 0 and errs[1] <= 1e-6,
          f"undistort at EuRoC's coefficients, {len(imgs)} frames' "
          f"keypoints and endpoints: within {errs[0]:.2e} px of the plain "
          f"version (== 0: the same float32 operations in the same order), "
          f"line equations those of its own endpoints "
          f"within {errs[1]:.2e} of their scale (<= 1e-6; c's scale is the "
          "products it cancels over the length)")
    kp, ep = frames[1]
    n_pts, n_seg = kp.shape[0], ep.shape[0]
    # per point 8 Newton steps of ~70 operations and the pixel maps (~8),
    # per segment its line equation (~15)
    report["undistort"] = dict(
        **work(nbytes(kp, ep) + nbytes(*CAM.undistort(cam, kp, ep)),
               (8 * 70 + 8) * (n_pts + 2 * n_seg) + 15 * n_seg),
        max_abs_err=errs[0], ms=cuda_ms(lambda: CAM.undistort(cam, kp, ep)),
        plain_ms=cuda_ms(lambda: CAM.undistort_frame_plain(cam, kp, ep)))
    # -- the two-view kernels
    cases = build_twoview_cases(0, 200)
    gaps = []
    for name in TWOVIEW_CASES:
        _, *a = twoview_inputs(name, 200, dev, cases)
        gaps.append(twoview_against_f64(name, 200, *a)[2])
    _, uv1, uv2, valid, idx_h, idx_f = twoview_inputs("general", 1000, dev)
    out, info, g1000 = twoview_against_f64("general", 1000, uv1, uv2, valid,
                                           idx_h, idx_f)
    gaps.append(g1000)
    n = uv1.shape[0]
    ih, if_ = idx_h.to(dev, torch.int32), idx_f.to(dev, torch.int32)
    models, scores = TV.twoview_hypotheses(uv1, uv2, valid, ih, if_)
    # what the function needs, at the float32 rate of the reference (the
    # kernel itself solves in float64): per model its 8x9 system (~100
    # operations) and null vector (~9^3), per F model the rank-2 cut of a
    # 3x3 (~3^3) and the denormalization (~90); per model and match the
    # symmetric transfer or epipolar terms (~45)
    report["twoview_hypotheses"] = dict(
        **work(nbytes(uv1, uv2, valid, ih, if_, models, scores),
               400 * (100 + 9 ** 3) + 200 * (3 ** 3 + 90) + 400 * n * 45),
        max_abs_err=max(g[0] for g in gaps),
        ms=cuda_ms(lambda: TV.twoview_hypotheses(uv1, uv2, valid, ih, if_)),
        plain_ms=cuda_ms(lambda: TV.twoview_hypotheses_plain(
            uv1, uv2, valid, idx_h.to(dev), idx_f.to(dev)), reps=5))
    hyp = TV.twoview_hypotheses_plain(uv1, uv2, valid, idx_h.to(dev),
                                      idx_f.to(dev))
    n_cand = int((info[8:] >= 0).sum())
    # what the function needs, at the float32 rate: per match the inlier
    # tests of the two best models (~90), both refits' A^T A rows (3 rows
    # x 45 entries x 2), their re-scores (~90), and per motion hypothesis
    # of the chosen model one 4x4 triangulation (~24 to build, ~4^3 for
    # its null vector) with the gates (~60); the refits' 9x9 null vectors
    # and the decomposition (~2 x 9^3 + 500)
    report["twoview_recover"] = dict(
        **work(nbytes(uv1, uv2, valid, models, scores)
               + nbytes(*out.result[1:5]),
               n * (90 + 270 + 90) + n_cand * n * (24 + 4 ** 3 + 60)
               + 2 * 9 ** 3 + 500),
        max_abs_err=max(max(g[1], g[2]) for g in gaps),
        ms=cuda_ms(lambda: TV.twoview_recover(K_EUROC, uv1, uv2, valid,
                                              models, scores)),
        plain_ms=cuda_ms(lambda: TV.twoview_recover_plain(
            K_EUROC, uv1, uv2, valid, *hyp), reps=5))
    # -- imu_preint on a keyframe window longer than 64 samples
    rng = np.random.default_rng(128)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dt).to(dev)
    args = (t(rng.normal(0, 0.5, (128, 3))),
            t(rng.normal(0, 1.0, (128, 3)) + [0, 0, 9.81]),
            t(np.full(128, 0.005)), t(np.arange(128) < 100, torch.bool),
            IMU.make_calib(ImuConfig()), t(np.zeros(3)), t(np.zeros(3)),
            t(np.eye(3, 4)), t(np.zeros(3)))
    fk, fp = IMU.imu_preint(*args), IMU.imu_preint_plain(*args)
    rel = max(float((getattr(fk.pre, f) - getattr(fp.pre, f)).abs().max())
              / max(float(getattr(fp.pre, f).abs().max()), 1e-30)
              for f in fk.pre._fields)
    check(rel <= 5e-5, f"imu_preint on a 128-sample keyframe window (100 "
          f"live): every preintegrated field within {rel:.2e} relative of "
          "the plain version (<= 5e-5)")


def reset_counts():
    for k, _ in KERNELS.values():
        k.launches = 0
    KN.SCHUR_SOLVE.global_launches = 0
    KN.POSE_GRAPH.global_launches = 0
    KN.SCHUR_SOLVE_REDUCED_CG.global_launches = 0


def read_counts():
    return {**{name: k.launches for name, (k, _) in KERNELS.items()},
            GLOBAL[0]: KN.SCHUR_SOLVE.global_launches,
            GLOBAL_PG[0]: KN.POSE_GRAPH.global_launches}


def run_slice3(dev, pl_step, imgs, pose0, map_args, smi):
    """Phase 7: the mapping step at both sizes.  Returns its launches."""
    print("[7] slice 3: mapping_step at both window sizes, true and "
          "perturbed start")
    sizes = (("worst", MAPPING_WORST), ("typical", MAPPING_TYPICAL))
    runs = {}
    cpu_runs = {}
    for name, sz in sizes:
        step, A = mapping_step(**sz, device=dev)
        plain, _ = mapping_step(**sz, device=dev, plain=True)
        runs[name] = (step, plain, A, perturbed_window(A))
        cpu_runs[name], _ = mapping_step(**sz, device="cpu")
    reset_counts()
    outs = {}
    with torch.no_grad():
        for name, (step, _, A, B) in runs.items():
            sk_t, sk_p = [], []
            outs[name] = (step(A, stats=sk_t), step(B, stats=sk_p), sk_t,
                          sk_p)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches: {launches}")
    check(all(launches[k] > 0 for k in PATH_MAP),
          f"every kernel of slice 3 launched ({', '.join(PATH_MAP)})")
    for name, (step, plain, A, B) in runs.items():
        ref = REF_MAP[name]
        o_t, o_p, it_t, it_p = outs[name]
        # the kernel path is held to the plain path on the CPU and to the
        # card's plain path, which sums its normal equations by sorted
        # segment sums (solver/engine.py `accumulate`) and so repeats:
        # three runs of it from each start, the same bits
        with torch.no_grad():
            sp_t, sp_p = [], []
            q_t, q_p = (cpu_runs[name]({k: v.cpu() for k, v in W.items()},
                                       stats=st)
                        for W, st in ((A, sp_t), (B, sp_p)))
            q_t, q_p = (q._replace(kf_poses=q.kf_poses.to(dev),
                                   pt_xyz=q.pt_xyz.to(dev),
                                   ln_ep6=q.ln_ep6.to(dev))
                        for q in (q_t, q_p))
            c3 = [(plain(A), plain(B)) for _ in range(3)]
        c_t, c_p = c3[0]
        same = all(torch.equal(a, b) for c in c3[1:]
                   for o, o0 in zip(c, c3[0]) for a, b in zip(o, o0)
                   if torch.is_tensor(a))
        check(same, f"{name}: three runs of the card's plain path from each "
              "start give the same bits")
        dcp = max(float((o_t.kf_poses - c_t.kf_poses).abs().max()),
                  float((o_p.kf_poses - c_p.kf_poses).abs().max()))
        check(dcp <= MAP_POSE_TOL, f"{name}: kernel and card plain paths' "
              f"KF poses within {MAP_POSE_TOL:g} ({dcp:.2e})")
        counts = (int(o_t.n_good), int(o_t.n_inliers), int(o_t.n_inliers_l))
        e_t = centre_err(o_t.kf_poses, A["kf_poses"])
        e0 = centre_err(B["kf_poses"], A["kf_poses"])
        e_p = centre_err(o_p.kf_poses, A["kf_poses"])
        d_t = float((o_t.kf_poses - q_t.kf_poses).abs().max())
        d_p = float((o_p.kf_poses - q_p.kf_poses).abs().max())
        print(f"  {name}: the card's plain path's KF poses from the kernel "
              f"path's: true {float((o_t.kf_poses - c_t.kf_poses).abs().max()):.2e}"
              f", perturbed {float((o_p.kf_poses - c_p.kf_poses).abs().max()):.2e}")
        print(f"  {name}: n_good / inliers / line inliers {counts} (reference "
              f"{ref['n_good']}, {ref['n_inliers']}, {ref['n_inliers_l']}); "
              f"largest camera-centre error: true start {e_t * 1e3:.3f} mm "
              f"(reference {ref['true_max_centre_m'] * 1e3:.3f}), perturbed "
              f"{e0 * 1e3:.3f} -> {e_p * 1e3:.3f} mm (reference "
              f"{ref['perturbed_max_centre_m'] * 1e3:.3f}); LM iterations "
              f"per round kernel {[int(x) for x in it_t]} / "
              f"{[int(x) for x in it_p]}, plain (CPU) {sp_t} / {sp_p}; plain "
              f"path inliers {int(q_t.n_inliers)} / {int(q_p.n_inliers)}")
        check(all(bool(torch.isfinite(x).all()) for x in
                  (o_t.kf_poses, o_t.pt_xyz, o_t.ln_ep6, o_p.kf_poses,
                   o_p.pt_xyz, o_p.ln_ep6))
              and o_t.kf_poses.shape == (MAPPING_WORST["n_kf"], 3, 4),
              f"{name}: poses, points and lines finite, poses [16,3,4]")
        want = (ref["n_good"], ref["n_inliers"], ref["n_inliers_l"])
        check(all(abs(c - r) <= 0.01 * r for c, r in zip(counts, want)),
              f"{name}: triangulated and inlier counts within 1% of REF_MAP")
        lim = max(2 * ref["perturbed_max_centre_m"], 0.010)
        check(e_p <= lim, f"{name}: perturbed start's largest camera-centre "
              f"error {e_p * 1e3:.3f} mm <= {lim * 1e3:.3f} mm")
        check(max(d_t, d_p) <= MAP_POSE_TOL,
              f"{name}: kernel and plain (CPU) paths' KF poses within "
              f"{MAP_POSE_TOL:g} (true {d_t:.2e}, perturbed {d_p:.2e})")
        gaps = []
        for o, q, W in ((o_t, q_t, A), (o_p, q_p, B)):
            rk = window_residuals(o.kf_poses, o.pt_xyz, o.ln_ep6, W)
            rq = window_residuals(q.kf_poses, q.pt_xyz, q.ln_ep6, W)
            gaps += [float((a - b).abs().max()) for a, b in zip(rk, rq)]
        check(max(gaps) <= MAP_RES_TOL_PX,
              f"{name}: kernel and plain (CPU) paths' points and lines "
              f"reproject "
              f"within {MAP_RES_TOL_PX:g} px of each other in every "
              f"observation (true start {gaps[0]:.2e} / {gaps[1]:.2e}, "
              f"perturbed {gaps[2]:.2e} / {gaps[3]:.2e} px)")
    for name, (step, plain, A, B) in runs.items():
        def go(stp, W):
            def f():
                with torch.no_grad():
                    stp(W)
            return f
        mk = cuda_ms(go(step, B), reps=10, warmup=2)
        mp = cuda_ms(go(plain, B), reps=3, warmup=1)
        print(f"  mapping_step {name} (perturbed start): kernel path "
              f"{mk:.3f} ms/step, plain path {mp:.3f} ms/step, on {smi}")
    step_t, _, A_t, _ = runs["typical"]

    def burst():
        p = pose0
        with torch.no_grad():
            for img in imgs[:3]:
                p, _ = pl_step(img, p, *map_args)
            step_t(A_t)
    sus = cuda_ms(burst, reps=5, warmup=1) / 3
    print(f"  sustained (bench_sustained: 3 point+line frames + 1 typical "
          f"mapping step): {sus:.3f} ms/frame, on {smi}")
    return launches


def liba_errors(A, out):
    """Largest body-position (m), velocity (m/s), rotation (deg) and bias
    errors of a window solve against the truth."""
    pose = out[0].double().cpu()
    gt = A["gt_pose_wb"].double().cpu()
    dR = gt[..., :3].transpose(-1, -2) @ pose[..., :3]
    w = torch.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                     dR[:, 1, 0] - dR[:, 0, 1]], -1) / 2
    return dict(
        max_pos_m=float((pose[..., 3] - gt[..., 3]).norm(dim=1).max()),
        max_vel_mps=float((out[1].double().cpu() - A["gt_vel"].double().cpu())
                          .norm(dim=1).max()),
        max_rot_deg=math.degrees(float(w.norm(dim=1).clamp_max(1.0)
                                       .asin().max())),
        max_bg=float((out[2].cpu() - A["gt_bg"].cpu()).abs().max()),
        max_ba=float((out[3].cpu() - A["gt_ba"].cpu()).abs().max()))


def gdir_deg(R, g):
    a = (R.double().cpu() @ torch.tensor([0.0, 0.0, -1.0],
                                         dtype=torch.float64))
    b = torch.as_tensor(g, dtype=torch.float64)
    return math.degrees(math.atan2(float(torch.linalg.cross(a, b).norm()),
                                   float(a @ b)))


def run_slice4(dev, smi):
    """Phase 8: the inertial window solve at both buckets and both starts,
    the IMU initialization and the scale refinement.  Returns the
    launches."""
    print("[8] slice 4: inertial_ba_step at both buckets, true and perturbed "
          "start; imu_init and its refinement")
    runs = {}
    for name, sz in (("worst", LIBA_WORST), ("half", LIBA_HALF)):
        for start in ("true", "perturbed"):
            pert = start == "perturbed"
            step, A = inertial_ba_step(**sz, perturbed=pert, device=dev)
            plain, _ = inertial_ba_step(**sz, perturbed=pert, device=dev,
                                        plain=True)
            runs[f"{name}_{start}"] = (step, plain, A)
    init, B = imu_init(device=dev)
    init_p, _ = imu_init(device=dev, plain=True)
    reset_counts()
    outs = {}
    with torch.no_grad():
        for key, (step, _, A) in runs.items():
            its = []
            outs[key] = (step(A, stats=its), its)
        o_init, o_ref = init(B), init.refine(B)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches: {launches}")
    check(all(launches[k] > 0 for k in PATH_LIBA + PATH_INIT),
          f"every kernel of slice 4 launched "
          f"({', '.join(PATH_LIBA + PATH_INIT)})")
    for key, (step, plain, A) in runs.items():
        ref = REF_LIBA[key]
        ok_, it_k = outs[key]
        with torch.no_grad():
            it_p = []
            op_ = plain(A, stats=it_p)
        ek, ep = liba_errors(A, ok_), liba_errors(A, op_)
        e0 = liba_errors(A, [A[k] for k in ("kf_pose_wb", "kf_vel", "kf_bg",
                                             "kf_ba")])
        n = (int(ok_.inlier.sum()), int(ok_.inlier_l.sum()))
        gaps = [float((a - b).abs().max()) for a, b in zip(ok_[:4], op_[:4])]
        print(f"  {key}: inliers points / lines kernel {n}, plain "
              f"{(int(op_.inlier.sum()), int(op_.inlier_l.sum()))} "
              f"(reference {ref['n_inliers']}, {ref['n_inliers_l']}); LM "
              f"iterations per round kernel {[int(x) for x in it_k]}, plain "
              f"{it_p}; start {e0['max_pos_m'] * 1e3:.3f} mm / "
              f"{e0['max_vel_mps']:.4f} m/s; errors kernel {ek}; plain {ep}; "
              f"reference {ref}; kernel - plain (pose, vel, bg, ba) {gaps}")
        check(all(bool(torch.isfinite(x).all()) for x in ok_ + op_)
              and ok_.pose_wb.shape == (16, 3, 4),
              f"{key}: states and landmarks finite on both paths, poses "
              "[16,3,4]")
        check(abs(n[0] - ref["n_inliers"]) <= 0.01 * ref["n_inliers"]
              and abs(n[1] - ref["n_inliers_l"]) <= 0.01 * ref["n_inliers_l"],
              f"{key}: point and line inliers within 1% of REF_LIBA")
        lim_p = max(2 * ref["max_pos_m"], 0.010)
        lim_v = max(2 * ref["max_vel_mps"], 0.02)
        check(ek["max_pos_m"] <= lim_p and ek["max_vel_mps"] <= lim_v,
              f"{key}: largest position error {ek['max_pos_m'] * 1e3:.3f} mm"
              f" <= {lim_p * 1e3:.3f} mm, velocity {ek['max_vel_mps']:.4f} <= "
              f"{lim_v:.4f} m/s")
        if key.endswith("perturbed"):
            rej = [int((~o.inlier).sum()) + int((~o.inlier_l).sum())
                   for o in (ok_, op_)]
            check(min(rej) > 0 and torch.equal(ok_.inlier, op_.inlier)
                  and torch.equal(ok_.inlier_l, op_.inlier_l),
                  f"{key}: the chi2 re-gate rejects {rej[0]} / {rej[1]} "
                  "observations on the kernel / plain path, point and line "
                  "masks equal")
    with torch.no_grad():
        p_init, p_ref = init_p(B), init_p.refine(B)
    for name, o, po, sc, gd in (
            ("init", o_init, p_init, REF_INIT["init_scale"],
             REF_INIT["init_gdir"]),
            ("refine", o_ref, p_ref, REF_INIT["refine_scale"],
             REF_INIT["refine_gdir"])):
        dg = gdir_deg(o[0], gd)
        print(f"  imu {name}: scale kernel {float(o[1]):.7f}, plain "
              f"{float(po[1]):.7f}, reference {sc:.7f}; gravity direction "
              f"{dg:.2e} deg from the reference's; truth: scale "
              f"{B['gt_scale'] if name == 'init' else B['gt_ref_scale']:.7f}")
        check(abs(float(o[1]) - sc) <= 0.01 * sc and dg <= 0.1,
              f"imu {name}: scale within 1% and gravity direction within 0.1 "
              "deg of REF_INIT")
    bg_gap = float((o_init[2].cpu() - torch.tensor(REF_INIT["init_bg"]))
                   .abs().max())
    check(bg_gap <= 1e-4, f"imu init: gyro bias within {bg_gap:.2e} of "
          "REF_INIT (<= 1e-4)")
    for name in ("worst", "half"):
        step, plain, A = runs[f"{name}_perturbed"]

        def go(stp):
            def f():
                with torch.no_grad():
                    stp(A)
            return f
        mk = cuda_ms(go(step), reps=10, warmup=2)
        mp = cuda_ms(go(plain), reps=2, warmup=1)
        print(f"  inertial_ba_step {name} (perturbed start): kernel path "
              f"{mk:.3f} ms/step, plain path {mp:.3f} ms/step, on {smi}")
    for name, fk, fp in (("init", lambda: init(B), lambda: init_p(B)),
                         ("refine", lambda: init.refine(B),
                          lambda: init_p.refine(B))):
        print(f"  imu_init {name}: kernel path {cuda_ms(fk):.3f} ms, plain "
              f"path {cuda_ms(fp, reps=3, warmup=1):.3f} ms, on {smi}")
    return launches


def map_centre_err(m, truth):
    """Largest camera-centre error (m) of the map's keyframes."""
    G = truth["kf_pose_cw"].astype(np.float64)
    P = m.kf_pose_cw[:len(G)].astype(np.float64)
    c = -np.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -np.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float(np.linalg.norm(c - cg, axis=1).max())


def run_slice5(dev, smi, report):
    """Phase 9: the keyframe step's neighbourhood work on both maps, kernel
    and plain paths, each from its own copy of the map.  Returns the
    launches."""
    print("[9] slice 5: neighborhood_step on both maps of "
          "build_keyframe_map, kernel and plain paths")
    runs = {}
    for name, conf in (("points", False), ("confirmed_lines", True)):
        arrays, truth = build_keyframe_map(conf)
        step, _ = neighborhood_step(conf, device=dev)
        plain, _ = neighborhood_step(conf, device=dev, plain=True)
        runs[name] = (step, plain, arrays, truth)
    reset_counts()
    outs, recs = {}, {}
    with torch.no_grad():
        for name, (step, _, arrays, _) in runs.items():
            mk = mapstore_from_numpy(arrays)
            recs[name] = record_nbh_calls(step.mapper)
            outs[name] = (step(mk), mk)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches: {launches}")
    check(all(launches[k] > 0 for k in PATH_NBH),
          f"every kernel of slice 5 launched ({', '.join(PATH_NBH)})")
    for name, (step, plain, arrays, truth) in runs.items():
        ref = REF_NBH[name]
        ok_, mk = outs[name]
        mp_ = mapstore_from_numpy(arrays)
        with torch.no_grad():
            op_ = plain(mp_)
        e0 = map_centre_err(mapstore_from_numpy(arrays), truth)
        ek, ep = map_centre_err(mk, truth), map_centre_err(mp_, truth)
        dpose = float(np.abs(mk.kf_pose_cw - mp_.kf_pose_cw).max())
        nb = int((mk.kf_match_pt >= 0).sum())
        db = int((mk.kf_match_pt != mp_.kf_match_pt).sum()
                 + (mk.kf_match_ln != mp_.kf_match_ln).sum())
        gk, gc = ba_float64_gaps(recs[name])
        print(f"  {name}: kernel {tuple(ok_)}, plain {tuple(op_)}; "
              f"reference {ref}; largest camera-centre error {e0 * 1e3:.3f} "
              f"-> kernel {ek * 1e3:.3f} / plain {ep * 1e3:.3f} mm; "
              f"kernel - plain KF poses {dpose:.2e}, bindings differing "
              f"{db} of {nb}; the BA's KF poses from a float64 run: kernel "
              f"{gk:.2e}, plain on the CPU {gc:.2e}")
        check(all(np.isfinite(x).all() for x in (mk.kf_pose_cw, mk.pt_xyz,
                                                 mk.ln_ep)),
              f"{name}: poses, points and lines finite")
        same = ("new_lines", "n_bound", "n_merged", "n_refused", "ba_path")
        check(all(getattr(ok_, k) == getattr(op_, k) for k in same),
              f"{name}: new lines, fuse binds, merges and refusals and the "
              "BA path equal on the kernel and plain paths")
        want = "pl" if name == "confirmed_lines" else "pt"
        check(ok_.ba_path == ref["ba_path"] == want,
              f"{name}: the BA took the {want!r} path, as the reference")
        # the card's plain BA sums by atomics (kernel - plain 1e-5 to
        # 1.02e-4 in a pose entry from run to run on the confirmed-lines
        # map), so the kernel path is held to float64 as in phase 3
        check(gk <= 2 * gc + 1e-6 and db <= 0.001 * nb,
              f"{name}: the BA's KF poses within 2x the CPU plain run's "
              f"distance to float64 ({gk:.2e} vs {gc:.2e}), the kernel and "
              f"plain paths' bindings equal but for 0.1% ({db})")
        got = {"new_lines": ok_.new_lines, "n_bound": ok_.n_bound,
               "n_merged": ok_.n_merged, "n_pt": mk.n_pt, "n_ln": mk.n_ln}
        check(all(abs(v - ref[k]) <= 0.01 * ref[k] for k, v in got.items()),
              f"{name}: new lines, binds, merges, points and lines {got} "
              "within 1% of REF_NBH")
        lim = max(2 * ref["max_centre_m"], 0.010)
        check(ek <= lim, f"{name}: largest camera-centre error "
              f"{ek * 1e3:.3f} mm <= {lim * 1e3:.3f} mm")
    for name, (step, plain, arrays, _) in runs.items():
        def go(stp, reps):
            maps = iter([mapstore_from_numpy(arrays) for _ in range(reps)])

            def f():
                with torch.no_grad():
                    return stp(next(maps))
            return f
        mk = cuda_ms(go(step, 7), reps=5, warmup=2)
        mp = cuda_ms(go(plain, 3), reps=2, warmup=1)
        syncs = outs[name][0].host_syncs
        print(f"  neighborhood_step {name}: kernel path {mk:.3f} ms/step, "
              f"plain path {mp:.3f} ms/step, {syncs} host syncs a step, on "
              f"{smi}")
    for k in ("proj_match", "line_triangulate"):
        r = report[k]
        print(f"  {k}: {r['ms']:.4f} ms, bound {r['bound_ms']:.6f} ms, "
              f"{launches[k]} launches on the path, on {smi}")
    hm = report["hamming_match"]
    print(f"  hamming_match line pair mode (256 x 256): {hm['pair_ms']:.4f} "
          f"ms beside its epipolar mode {hm['epipolar_ms']:.4f} ms, "
          f"{launches['hamming_match']} launches on the path, on {smi}")
    return launches


def boot_errors(out, B):
    """Rotation (deg) and t-direction errors of the second keyframe
    against the true relative motion of the two init frames."""
    m, kfs = out.map, out.tracker.new_kf_queue
    i0 = int(np.argmin(np.abs(B["timestamps"] - m.kf_timestamp[kfs[0]])))
    T0, T1 = np.eye(4), np.eye(4)
    T0[:3], T1[:3] = B["pose_cw"][i0], B["pose_cw"][out.init_frame]
    T10 = T1 @ np.linalg.inv(T0)
    P = m.kf_pose_cw[kfs[1]].astype(np.float64)
    tt = T10[:3, 3] / np.linalg.norm(T10[:3, 3])
    t = P[:, 3] / np.linalg.norm(P[:, 3])
    return rot_deg(P[:, :3], T10[:3, :3]), float(np.linalg.norm(t - tt))


def run_slice6(dev, smi, report):
    """Phase 10: the monocular bootstrap on the rendered frames, and the
    EuRoC-raw case through `undistort` and the two-view kernels, each a
    path with its own launch window.  Returns the launches of both."""
    print("[10] slice 6: bootstrap_step on the rendered frames; the "
          "EuRoC-raw case")
    step, B = bootstrap_step(device=dev)
    plain, Bp = bootstrap_step(device=dev, plain=True)
    reset_counts()
    with torch.no_grad():
        out = step(B)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"  launches (bootstrap_step): {launches}")
    check(all(launches[k] > 0 for k in PATH_BOOT)
          and launches["undistort"] == 0,
          f"every kernel of bootstrap_step launched ({', '.join(PATH_BOOT)})"
          ", and not undistort (the renders have no distortion)")
    with torch.no_grad():
        op = plain(Bp)
    rot, tdir = boot_errors(out, B)
    prot, ptdir = boot_errors(op, Bp)
    got = {k: getattr(out, k) for k in ("init_frame", "attempts",
                                        "used_homography", "init_matches",
                                        "n_triangulated", "points", "lines")}
    print(f"  kernel path: {got}, rotation error {rot:.4f} deg, t-direction "
          f"error {tdir:.4f}, host syncs per attempt {out.host_syncs}; plain "
          f"path: frame {op.init_frame}, attempts {op.attempts}, homography "
          f"{op.used_homography}, matches {op.init_matches}, triangulated "
          f"{op.n_triangulated}, points {op.points}, lines {op.lines}, "
          f"rotation error {prot:.4f} deg, t-direction error {ptdir:.4f}; "
          f"reference {REF_BOOT}")
    ref = REF_BOOT
    check(all(np.isfinite(a).all() for a in (out.kf_pose_cw, out.kf_pose_wb,
                                              out.map.pt_xyz, out.map.ln_ep)),
          "the initial map's poses, points and lines finite")
    check(got["init_frame"] == ref["init_frame"]
          and got["attempts"] == ref["attempts"]
          and got["used_homography"] == ref["used_homography"],
          f"initialized on frame {got['init_frame']} after "
          f"{got['attempts']} attempts with the "
          f"{'homography' if got['used_homography'] else 'fundamental'}, as "
          "REF_BOOT")
    check(abs(got["init_matches"] - ref["init_matches"])
          <= 0.02 * ref["init_matches"]
          and all(abs(got[k] - ref[k]) <= 0.05 * ref[k]
                  for k in ("n_triangulated", "points"))
          and got["lines"] >= 1
          and abs(got["lines"] - ref["lines"]) <= max(3, ref["lines"] // 2),
          f"init matches {got['init_matches']} within 2%, triangulated "
          f"{got['n_triangulated']} and points {got['points']} within 5%, "
          f"lines {got['lines']} within max(3, half) of REF_BOOT (the card's "
          "own RANSAC draws)")
    check(rot <= 2 * ref["rot_err_deg"] and tdir <= 2 * ref["tdir_err"],
          f"second keyframe: rotation error {rot:.4f} deg <= "
          f"{2 * ref['rot_err_deg']:.4f}, t-direction error {tdir:.4f} <= "
          f"{2 * ref['tdir_err']:.4f} (2x the reference's largest)")
    c, *_ = twoview_inputs("euroc_raw", 1000, dev)
    cam = CAM.make_camera(CameraConfig())
    raw = [torch.from_numpy(c[k]).to(dev) for k in ("uv1", "uv2")]
    valid = torch.from_numpy(c["valid"]).to(dev)
    reset_counts()
    with torch.no_grad():
        u1, u2 = (CAM.undistort_pixels(cam, u) for u in raw)
        res = TV.reconstruct_two_views(
            K_EUROC, u1, u2, valid, generator=torch.Generator().manual_seed(0))
        success = bool(res.success)
    torch.cuda.synchronize()
    launches_raw = read_counts()
    print(f"  launches (EuRoC-raw case): {launches_raw}")
    check(all(launches_raw[k] > 0 for k in PATH_RAW),
          f"every kernel of the EuRoC-raw case launched "
          f"({', '.join(PATH_RAW)})")
    dR = res.R.double().cpu().numpy().T @ c["R"]
    ang = math.acos(max(-1.0, min(1.0, (np.trace(dR) - 1) / 2)))
    t_dir = c["t"] / np.linalg.norm(c["t"])
    t = res.t.double().cpu().numpy()
    et = float(np.linalg.norm(t / np.linalg.norm(t) - t_dir))
    check(success and not bool(res.used_homography) and ang < 0.01
          and et < 0.06,
          f"EuRoC-raw case (1000 raw cam0 matches, undistorted on the card): "
          f"success with F, rotation error {ang:.2e} rad < 0.01, "
          f"t-direction error {et:.2e} < 0.06 (tests/test_twoview.py's "
          "bounds)")

    def go(stp, BB):
        def f():
            with torch.no_grad():
                return stp(BB)
        return f
    t0 = time.perf_counter()
    go(step, B)()
    torch.cuda.synchronize()
    wk = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    go(plain, Bp)()
    torch.cuda.synchronize()
    wp = (time.perf_counter() - t0) * 1e3
    mk = cuda_ms(go(step, B), reps=3, warmup=1)
    print(f"  bootstrap_step: kernel path {mk / out.attempts:.3f} ms per "
          f"attempt ({mk:.3f} ms for {len(B['frames'][:out.init_frame + 1])} "
          f"frames, CUDA events; wall {wk:.1f} ms), plain path "
          f"{wp / max(op.attempts, 1):.3f} ms per attempt (wall {wp:.1f} "
          f"ms), on {smi}")
    for k in ("undistort", "twoview_hypotheses", "twoview_recover"):
        r = report[k]
        print(f"  {k}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms, {launches[k]} launches on "
              f"bootstrap_step, {launches_raw[k]} on the EuRoC-raw case, on "
              f"{smi}")
    return {k: launches[k] + launches_raw[k] for k in launches}


def gram_ops(okf, olm, n_lm, D):
    """Operations of the Gram fill-in: each landmark's 6m x 6m block of
    its m observing keyframes, D columns each."""
    key = torch.unique(okf.long() * n_lm + olm.long())
    m = torch.bincount(key % n_lm, minlength=n_lm).double()
    return float((6 * m * (6 * m + 1) / 2 * D * 2).sum())


def check_global_kernels(report):
    """schur_solve's global path (the reduced solve beyond one block)
    against its plain version, by `KN.global_solve_against_float64`'s
    rule: one Schur step from the perturbed start of the 64 KF inertial
    window with lines (S = 960) and of the 128 KF point-only window (S =
    768).  report["schur_solve_global"] gets the 64 KF row (the sequence's
    shape), report["schur_solve_global_128"] the 128 KF one."""
    for kind, n_kf, key in (("inertial", 64, GLOBAL[0]),
                            ("points", 128, GLOBAL[0] + "_128")):
        got = KN.global_solve_against_float64(kind, n_kf, "cuda")
        print(f"  schur_solve global path, {kind} {n_kf} KF (S = {got.S}), "
              "kernel / plain on the card from float64, kernel - plain: "
              + got.summary())
        check(not got.failures(),
              f"schur_solve global path, {kind} {n_kf} KF: the global path "
              "taken, the same bits on a second launch, each state within "
              "2x the plain float32 step's distance to float64 and no "
              "farther from the plain step than that (+1e-6), the pose "
              "within a quarter of the float64 step's largest entry "
              f"{got.failures()}")
        c = got.case
        w, A, prob, st, free = (c["work"], c["inputs"], c["prob"],
                                c["states"], c["free"])
        t, S = w.t, got.S
        lam = torch.tensor(c["lam"], device="cuda")
        n_pt, n_ln = t["pts"].shape[0], t["lns"].shape[0]
        ops = 300 * n_pt + 1500 * n_ln + 250 * w.n_obs \
            + gram_ops(A["obs_kf"], A["obs_pt"], n_pt, 3) \
            + w_cg(S) * 2 * S * S
        if w.body:
            ops += 1000 * t["lobs_kf"].shape[0] + gram_ops(
                A["lobs_kf"], A["lobs_ln"], n_ln, 6)
        report[key] = dict(
            **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"],
                          t["link"] if w.body else (), t["poses"],
                          t["kfx"] if w.body else (), t["pts"], t["lns"])
                   + nbytes(t["cposes"], t["ckfx"] if w.body else (),
                            t["cpts"], t["clns"], t["dx"]), ops),
            max_abs_err=got.gaps["pose"].kernel_plain,
            ms=cuda_ms(w.solve, reps=5, warmup=1),
            plain_ms=cuda_ms(lambda: prob.solve_step(st, lam, *free),
                             reps=2, warmup=1))


def run_slice7(dev, smi):
    """Phase 11: the whole keyframe step over the keyframe sequence
    (`keyframe_sequence`, production's sizes) in its own launch window,
    held to REF_SEQ.  Returns its launches and the final map."""
    print("[11] slice 7: keyframe_sequence, the keyframe step over "
          f"{REF_SEQ['keyframes']}+ keyframes at production's sizes")
    step, seq = keyframe_sequence(device=dev)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = step(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    m = out.map
    got = dict(init_kf=out.init_kf, init_scale=out.init_scale,
               keyframes=int(m.n_kf), points=int(m.n_pt), lines=int(m.n_ln),
               scale=out.scale, gravity_err_deg=out.gravity_err_deg,
               viba_solves=out.n_viba, viba_window=out.viba_window,
               ate_sim3=out.ate_sim3, ate_se3=out.ate_se3,
               refine=out.n_refine)
    print(f"  launches: {launches}")
    print(f"  kernel path: {got}; reference {REF_SEQ}")
    by_path = {}
    for s_ in out.steps:
        paths = [b[0] for b in s_.ba]
        key = "viba" if "viba" in paths else (paths[0] if paths else "none")
        by_path.setdefault(key, []).append(s_)
    for key, st_ in sorted(by_path.items()):
        iters = [sum(b[2]) for s_ in st_ for b in s_.ba if b[0] == key]
        print(f"  {key}: {len(st_)} steps, {np.mean([x.ms for x in st_]):.1f}"
              f" ms a step (wall; max {max(x.ms for x in st_):.1f}), "
              f"{np.mean([x.host_syncs for x in st_]):.1f} host syncs a step,"
              f" windows {sorted({b[1] for x in st_ for b in x.ba})}, LM "
              f"iterations a solve {np.mean(iters) if iters else 0:.1f}, on "
              f"{smi}")
    print(f"  the sequence: {len(out.steps)} steps in {wall:.1f} s, culled "
          f"{sum(len(x.culled) for x in out.steps)} keyframes, on {smi}")
    ref = REF_SEQ
    check(all(np.isfinite(a[m.kf_valid]).all() for a in (
        m.kf_pose_cw, m.kf_vel, m.kf_bias_g, m.kf_bias_a))
          and np.isfinite(m.pt_xyz[m.pt_valid]).all(),
          "keyframe states and map points finite")
    check(all(launches[k] > 0 for k in PATH_SEQ),
          "every kernel of the keyframe step launched "
          f"({', '.join(PATH_SEQ)})")
    check(out.viba_window > 22 and launches[GLOBAL[0]] > 0,
          f"a full-map pulse of {out.viba_window} > 22 keyframes took "
          f"schur_solve's global path ({launches[GLOBAL[0]]} launches)")
    check(got["init_kf"] == ref["init_kf"],
          f"the IMU initialized at keyframe {got['init_kf']}, as REF_SEQ")
    check(all(abs(got[k] - ref[k]) <= 0.05 * ref[k]
              for k in ("keyframes", "points", "lines")),
          f"keyframes {got['keyframes']}, points {got['points']}, lines "
          f"{got['lines']} within 5% of REF_SEQ")
    e_init = abs(got["init_scale"] - ref["inv_lam"])
    e_ref = abs(ref["init_scale"] - ref["inv_lam"])
    check(e_init <= 2 * e_ref
          and abs(got["scale"] - 1) <= 2 * abs(ref["scale"] - 1),
          f"init scale {got['init_scale']:.4f} against 1/lam "
          f"{ref['inv_lam']:.4f}: off {e_init:.4f} <= 2x the reference's "
          f"{e_ref:.4f}; final scale {got['scale']:.4f} within 2x the "
          "reference's distance to 1")
    check(got["gravity_err_deg"] <= 2 * ref["gravity_err_deg"],
          f"gravity error {got['gravity_err_deg']:.4f} deg <= 2x the "
          f"reference's {ref['gravity_err_deg']:.4f}")
    check(got["ate_sim3"] <= 2 * ref["ate_sim3"]
          and got["ate_se3"] <= 2 * ref["ate_se3"],
          f"ATE {got['ate_sim3'] * 1e3:.2f} mm (Sim3), "
          f"{got['ate_se3'] * 1e3:.2f} mm (SE3) <= 2x the reference's "
          f"{ref['ate_sim3'] * 1e3:.2f} / {ref['ate_se3'] * 1e3:.2f}")
    return launches, m


def run_slice8(dev, smi):
    """Phase 12: the tracked sequence (`tracked_sequence`, 180 rendered
    frames at production's sizes) in its own launch window, held to
    REF_TRACK.  Returns its launches."""
    print("[12] slice 8: tracked_sequence, 180 rendered frames through the "
          "frame prelude, the tracker and the keyframe step")
    step, S = tracked_sequence(device=dev)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = step(S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    fr = out.frames
    boot = fr[:out.init_frame + 1]
    trk = [f for f in fr[out.init_frame + 1:] if f.tracked and not f.keyframe]
    kfs = [f for f in fr[out.init_frame + 1:] if f.keyframe]
    got = dict(n_tracked=out.n_tracked, init_frame=out.init_frame,
               imu_init_kf=out.imu_init_kf,
               imu_init_frame=out.imu_init_frame, init_scale=out.init_scale,
               pre_init_scale=out.pre_init_scale, scale=out.scale,
               gravity_err_deg=out.gravity_err_deg, keyframes=out.keyframes,
               points=out.points, lines=out.lines, ate_sim3=out.ate_sim3,
               ate_se3=out.ate_se3, maps=len(out.tracker.atlas.maps))
    print(f"  launches: {launches}")
    print(f"  kernel path: {got}; reference {REF_TRACK}")
    print(f"  inliers per tracked frame: {[f.inliers for f in fr]}")
    print(f"  states per frame: {[f.state for f in fr]}")
    for what, fs in (("bootstrap frames", boot), ("tracked frames", trk),
                     ("keyframe frames", kfs)):
        ms = [f.ms for f in fs]
        print(f"  {what}: {len(fs)}, {np.mean(ms):.2f} ms a frame (wall; "
              f"median {np.median(ms):.2f}, max {max(ms):.2f}), "
              f"{np.mean([f.host_syncs for f in fs]):.1f} host syncs a "
              f"frame, on {smi}")
    print(f"  the sequence: {len(fr)} frames in {wall:.1f} s "
          f"({len(fr) / wall:.1f} frames/s), on {smi}")
    ref = REF_TRACK
    m = out.map
    check(all(np.isfinite(a[m.kf_valid]).all() for a in (
        m.kf_pose_cw, m.kf_vel, m.kf_bias_g, m.kf_bias_a))
          and np.isfinite(m.pt_xyz[m.pt_valid]).all(),
          "keyframe states and map points finite")
    check(all(launches[k] > 0 for k in PATH_TRACK),
          f"every kernel of the tracked sequence launched "
          f"({', '.join(PATH_TRACK)})")
    check(launches["pyramid"] == 7 * len(fr)
          and launches["pyramid_line"] == len(fr),
          f"the pyramid: 7 level launches and 1 line level a frame "
          f"({launches['pyramid']} / {launches['pyramid_line']} over "
          f"{len(fr)} frames)")
    check(got["n_tracked"] >= ref["n_tracked_min"] - 2,
          f"{got['n_tracked']} frames tracked >= the reference's "
          f"{ref['n_tracked_min']} - 2 (the fewest over its RANSAC keys)")
    check(abs(got["imu_init_kf"] - ref["imu_init_kf"]) <= 2
          and got["imu_init_kf"] > 0,
          f"the IMU initialized at keyframe {got['imu_init_kf']} (frame "
          f"{got['imu_init_frame']}), within 2 of the reference's "
          f"{ref['imu_init_kf']} (frame {ref['imu_init_frame']})")
    check(all(abs(got[k] - ref[k]) <= 0.1 * ref[k]
              for k in ("keyframes", "points", "lines")),
          f"keyframes {got['keyframes']}, points {got['points']}, lines "
          f"{got['lines']} within 10% of the reference's {ref['keyframes']}"
          f" / {ref['points']} / {ref['lines']}")
    errs = dict(init_scale_err=abs(got["init_scale"] * got["pre_init_scale"]
                                   - 1),
                scale_err=abs(got["scale"] - 1),
                gravity_err_deg=got["gravity_err_deg"],
                ate_sim3=got["ate_sim3"], ate_se3=got["ate_se3"])
    print(f"  errors against the truth: {errs}")
    for k, what in (("init_scale_err", "the IMU init's scale error "
                     "|init_scale x pre_init_scale - 1|"),
                    ("scale_err", "the final scale error |scale - 1|"),
                    ("gravity_err_deg", "the gravity error (deg)"),
                    ("ate_sim3", "the Sim3 ATE (m)"),
                    ("ate_se3", "the SE3 ATE (m)")):
        worst = ref[k + "_worst"]
        check(errs[k] <= 2 * worst, f"{what} {errs[k]:.4f} <= 2x the "
              f"reference's worst over its RANSAC keys ({worst:.4f})")
    return launches


def replay_descriptors(S, dev, step=4):
    """The ORB and LBD descriptors (with their valid masks) of every
    step-th frame of the MH replay through the port's front end on the
    card."""
    orb = FE.OrbExtractor(FE.make_level_specs(H, W, N_FEAT)).to(dev)
    lines = LN.LineExtractor(N_LINE, levels=2).to(dev)
    out = []
    with torch.no_grad():
        for img in S["frames"][::step]:
            t = torch.from_numpy(img).to(dev)
            f, lf = orb(t), lines(t)
            out.append((f.desc.contiguous(), f.valid.contiguous(),
                        lf.desc.contiguous(), lf.valid.contiguous()))
    return out


def check_system_kernels(S, report):
    """Slice 9's kernels against their plain versions: `bow_transform` on
    the ORB (10 000 words) and LBD (1 000) descriptors of every 4th frame
    of the MH replay, ids and bags bit-equal, each written into a bank
    row; `bow_score` of a frame's bag against the 512-row bank of those
    frames' bags, within 1e-6; `pnp_ransac` and `mlpnp_refine` on the
    cases of `inputs.build_pnp_case` (200 matches; 512 rows, 400 valid)
    with the tracker's own samples, against the plain version's float64
    run (`ops.pnp.kernels_against_float64`)."""
    dev = torch.device("cuda")
    descs = replay_descriptors(S, dev)
    vocs = {"orb": V.default_vocabulary("orb"),
            "lbd": V.default_vocabulary("lbd")}
    pipes = {k: (V.make_bow_pipeline(v, 0), V.make_bow_pipeline(v, 0, True))
             for k, v in vocs.items()}
    bank = torch.zeros(512, vocs["orb"].n_words, device=dev)
    n_ids = descs[0][0].shape[0]
    ids = torch.full((512, n_ids), -1, dtype=torch.int32, device=dev)
    bad = 0
    with torch.no_grad():
        for r, (d, v, ld, lv) in enumerate(descs):
            wk, bk = pipes["orb"][0](d, v, ids_out=ids[r], bow_out=bank[r])
            wp, bp = pipes["orb"][1](d, v)
            lk, lbk = pipes["lbd"][0](ld, lv)
            lp, lbp = pipes["lbd"][1](ld, lv)
            bad += not (torch.equal(wk, wp) and torch.equal(bk, bp)
                        and torch.equal(lk, lp) and torch.equal(lbk, lbp))
    torch.cuda.synchronize()
    check(bad == 0, f"bow_transform: word ids and bags bit-equal to the "
          f"plain pipeline on {len(descs)} replay frames' ORB ({n_ids}) and "
          f"LBD ({N_LINE}) descriptors ({bad} frames differ)")
    d, v = descs[len(descs) // 2][:2]
    voc = vocs["orb"]
    rows = sum(voc.k ** (l + 1) for l in range(voc.depth))
    nb = 32 * rows + 33 * n_ids + 4 * n_ids + 4 * voc.n_words
    ops = n_ids * voc.depth * voc.k * 24 + voc.n_words
    report["bow_transform"] = dict(
        **work(nb, ops), max_abs_err=0.0,
        ms=cuda_ms(lambda: pipes["orb"][0](d, v)),
        plain_ms=cuda_ms(lambda: pipes["orb"][1](d, v)), library_ms=None)
    mask = torch.zeros(512, dtype=torch.bool, device=dev)
    mask[:len(descs)] = True
    q = bank[len(descs) // 2].clone()
    sk = V.bow_score(q, bank, mask)
    sp = V.score_plain(q, bank, mask)
    lib = 1.0 - 0.5 * torch.cdist(q[None], bank, p=1)[0]
    torch.cuda.synchronize()
    e_score = float((sk - sp).abs().max())
    e_lib = float((torch.where(mask, lib, -1.0) - sp).abs().max())
    check(e_score <= 1e-6 and int(torch.argmax(sk)) == len(descs) // 2,
          f"bow_score: a replay frame's bag against the 512-row bank of "
          f"{len(descs)} frames within {e_score:.2e} of the plain version "
          f"(<= 1e-6), its own row best (torch.cdist: {e_lib:.2e})")
    # the kernel reads only the rows the mask lets in (a masked row
    # returns at once): their bags, the query, the mask; 512 scores out
    W_, rows_in = voc.n_words, int(mask.sum())
    report["bow_score"] = dict(
        **work(4 * (rows_in * W_ + W_ + 512) + 512, 3 * rows_in * W_),
        max_abs_err=e_score, ms=cuda_ms(lambda: V.bow_score(q, bank, mask)),
        plain_ms=cuda_ms(lambda: V.score_plain(q, bank, mask)),
        library_ms=cuda_ms(lambda: torch.cdist(q[None], bank, p=1)))
    gaps = {}
    for name in PNP_CASES:
        uv, X, valid, _ = build_pnp_case(name)
        s_ = TV.sample_indices(torch.from_numpy(valid), 128, 6,
                               torch.Generator().manual_seed(0))
        args = [torch.from_numpy(a).to(dev) for a in (uv, X, valid)]
        r = PNP.kernels_against_float64(K_EUROC, *args, s_.to(dev))
        print(f"  pnp {name}: "
              f"{({k: v for k, v in r.items() if k != 'failures'})}")
        check(not r["failures"], f"pnp_ransac / mlpnp_refine on the {name} "
              f"case ({len(uv)} rows): the best hypothesis, the inliers "
              f"({r['n']}, refined {r['n_ml']}) and the poses as the float64"
              f" run's (gaps {r['ransac_gap']:.2e} / {r['ml_gap']:.2e}, the "
              f"plain float32 run's {r['ransac_plain_gap']:.2e} / "
              f"{r['ml_plain_gap']:.2e}; {r['failures']})")
        gaps[name] = (r, args, s_.to(dev))
    r, (uv, X, valid), s_ = gaps["rendered"]
    n, it = uv.shape[0], s_.shape[0]
    st = {}
    PNP.pnp_ransac(K_EUROC, uv, X, valid, s_, stats=st)
    rot = int(st["rotations"])
    print(f"  pnp_ransac on the rendered case: {rot} Jacobi rotations "
          f"({rot / (it + 3):.1f} a 12x12 solve)")
    # operations: per hypothesis its 6 matches' normal matrix (78 entries,
    # 4 operations a match) and ~40 operations a match to score it; the
    # three refits' normal matrices over all n matches, 10 passes of ~40
    # operations a match (weights and strict scores); the Jacobi
    # rotations the kernels applied, 216 operations each (3 x 12 pairs of
    # 6)
    report["pnp_ransac"] = dict(
        **work(4 * (5 * n + 6 * it + 12 + it) + 2 * n,
               it * (6 * 78 * 4 + 40 * n) + 3 * 78 * 4 * n + 10 * 40 * n
               + 216 * rot), max_abs_err=r["ransac_gap"],
        ms=cuda_ms(lambda: PNP.pnp_ransac(K_EUROC, uv, X, valid, s_)),
        plain_ms=cuda_ms(lambda: PNP.pnp_ransac_plain(K_EUROC, uv, X, valid,
                                                      s_), reps=3),
        library_ms=None)
    res = PNP.pnp_ransac(K_EUROC, uv, X, valid, s_)
    # its 8 steps' ~250 operations a match run over the inliers alone
    # (the kernel skips the rest); the strict re-score reads every row
    n_in = int(res.inliers.sum())
    report["mlpnp_refine"] = dict(
        **work(4 * (5 * n + 24) + 2 * n, 8 * n_in * 250 + 40 * n),
        max_abs_err=r["ml_gap"],
        ms=cuda_ms(lambda: PNP.mlpnp_refine(K_EUROC, uv, X, res.inliers,
                                            res.R, res.t)),
        plain_ms=cuda_ms(lambda: PNP.mlpnp_refine_plain(
            K_EUROC, uv, X, res.inliers, res.R, res.t), reps=5),
        library_ms=None)


def run_slice9(dev, smi, S):
    """Phase 13: the whole System over the MH replay (`SystemRun`, 166
    frames at full width) in its own launch window, held to the
    regression's bounds and REF_MH; then the relocalization case in a
    window of its own.  Returns (the replay's launches, the case's)."""
    print("[13] slice 9: System.track_monocular over the 8 s MH replay "
          f"({len(S['frames'])} frames, the 9000 / 500 hall), then "
          "global_refine, then relocalization on its map")
    step = SystemRun(device=dev, use_loop_closing=False)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = step(S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    fr = out.frames
    n = len(fr)
    got = dict(n_tracked=out.n_tracked, init_frame=out.init_frame,
               imu_init_kf=out.imu_init_kf, imu_init_frame=out.imu_init_frame,
               init_scale=out.init_scale, pre_init_scale=out.pre_init_scale,
               scale=out.scale, gravity_err_deg=out.gravity_err_deg,
               keyframes=out.keyframes, points=out.points, lines=out.lines,
               maps=out.maps, ba_norm=out.ba_norm,
               final_state=out.final_state, ate_sim3=out.ate_sim3,
               ate_se3=out.ate_se3, reloc_tried=out.reloc_tried,
               reloc_ok=out.reloc_ok)
    print(f"  launches: {launches}")
    print(f"  kernel path: {got}")
    print(f"  inliers per frame: {[f.inliers for f in fr]}")
    print(f"  states per frame: {[f.state for f in fr]}")
    boot = fr[:out.init_frame + 1]
    rest = fr[out.init_frame + 1:]
    kinds = (("bootstrap frames", boot),
             ("tracked frames", [f for f in rest if f.tracked
                                 and not f.keyframe and not f.reloc_tried]),
             ("keyframe frames", [f for f in rest if f.keyframe]),
             ("relocalization frames", [f for f in rest if f.reloc_tried]))
    for what, fs in kinds:
        if not fs:
            print(f"  {what}: none")
            continue
        ms = [f.ms for f in fs]
        print(f"  {what}: {len(fs)}, {np.mean(ms):.2f} ms a frame (wall; "
              f"median {np.median(ms):.2f}, max {max(ms):.2f}), "
              f"{np.mean([f.host_syncs for f in fs]):.1f} host syncs a "
              f"frame, on {smi}")
    print(f"  the replay: {n} frames in {wall:.1f} s ({n / wall:.1f} "
          f"frames/s, global_refine included), on {smi}")
    print(f"  metrics_summary: {json.dumps(out.metrics)}")
    ref = REF_MH
    m = out.system.atlas.current
    check(all(np.isfinite(a[m.kf_valid]).all() for a in (
        m.kf_pose_cw, m.kf_vel, m.kf_bias_g, m.kf_bias_a))
          and np.isfinite(m.pt_xyz[m.pt_valid]).all(),
          "keyframe states and map points finite")
    # tests/test_mh_replay_regression.py:53-74
    check(got["maps"] == 1 and got["final_state"] != 4
          and out.imu_initialized and got["ba_norm"] < 0.5,
          f"the regression's state: IMU initialized, |ba| "
          f"{got['ba_norm']:.3f} < 0.5, one map, not LOST at the end")
    check(got["n_tracked"] >= 0.85 * n and got["lines"] >= 20,
          f"{got['n_tracked']} / {n} frames tracked (>= 85%), "
          f"{got['lines']} lines (>= 20)")
    check(got["ate_sim3"] < 0.6 and got["ate_se3"] < 1.0,
          f"after global_refine ATE Sim3 {got['ate_sim3']:.4f} m < 0.6, "
          f"SE3 {got['ate_se3']:.4f} m < 1.0")
    # REF_MH, REF_TRACK's rule
    check(got["n_tracked"] >= ref["n_tracked_min"] - 2,
          f"{got['n_tracked']} frames tracked >= the reference's "
          f"{ref['n_tracked_min']} - 2 (the fewest over its seeds)")
    check(abs(got["imu_init_kf"] - ref["imu_init_kf"]) <= 2,
          f"the IMU initialized at keyframe {got['imu_init_kf']} (frame "
          f"{got['imu_init_frame']}), within 2 of the reference's "
          f"{ref['imu_init_kf']} (frame {ref['imu_init_frame']}; "
          f"{ref['imu_init_kf_min']}..{ref['imu_init_kf_max']} over its "
          f"seeds)")
    for k in ("keyframes", "points", "lines"):
        check_band(f"{k} (the reference's seed 0: {ref[k]})", [got[k]],
                   ref[k + "_min"], ref[k + "_max"])
    errs = dict(init_scale_err=abs(got["init_scale"] * got["pre_init_scale"]
                                   - 1),
                scale_err=abs(got["scale"] - 1),
                gravity_err_deg=got["gravity_err_deg"],
                ate_sim3=got["ate_sim3"], ate_se3=got["ate_se3"])
    print(f"  errors against the truth: {errs}")
    for k, what in (("init_scale_err", "the IMU init's scale error "
                     "|init_scale x pre_init_scale - 1|"),
                    ("scale_err", "the final scale error |scale - 1|"),
                    ("gravity_err_deg", "the gravity error (deg)"),
                    ("ate_sim3", "the Sim3 ATE (m)"),
                    ("ate_se3", "the SE3 ATE (m)")):
        worst = ref[k + "_worst"]
        check(errs[k] <= 2 * worst, f"{what} {errs[k]:.4f} <= 2x the "
              f"reference's worst over its seeds ({worst:.4f})")
    db = out.system.kfdb.db()
    check(np.array_equal(db.present, m.kf_valid),
          f"the keyframe database: one bank row a live keyframe "
          f"({int(db.present.sum())} rows, {int(m.n_kf)} keyframes)")
    pipe = V.make_bow_pipeline(db.voc, m.n_feat, plain=True)
    pipe_l = V.make_bow_pipeline(db.line_voc, m.n_line_feat, plain=True)
    rows_bad = 0
    for kf in np.nonzero(db.present)[0]:
        wid, bow = pipe(torch.from_numpy(m.kf_feat_desc[kf].view(np.int32))
                        .to(dev), torch.from_numpy(m.kf_feat_valid[kf])
                        .to(dev))
        lv = m.kf_line_valid[kf]
        ok = torch.equal(wid, db.word_ids[kf]) and torch.equal(bow,
                                                               db.bows[kf])
        if lv.sum() >= 5:
            _, bl = pipe_l(torch.from_numpy(m.kf_line_desc[kf].view(
                np.int32)).to(dev), torch.from_numpy(lv).to(dev))
            ok = ok and db.has_lines[kf] and torch.equal(bl, db.bows_l[kf])
        rows_bad += not ok
    check(rows_bad == 0, "every bank row (word ids, bag, line bag) equal to "
          f"the plain pipeline's on the card ({rows_bad} differ)")
    check(all(launches[k] > 0 for k in PATH_SYSTEM),
          f"every kernel of the replay launched ({', '.join(PATH_SYSTEM)})")
    print(f"  schur_solve's global path: "
          f"{launches[GLOBAL[0]]} launches (global_refine's window)")
    reset_counts()
    case = relocalization_case(out.system, S, out.poses)
    torch.cuda.synchronize()
    reloc = read_counts()
    print(f"  relocalization case: {case}; launches {reloc}")
    print(f"  relocalization frame: {case.get('ms', float('nan')):.2f} ms "
          f"(wall), on {smi}")
    check(1 <= case["frames"] <= ref["reloc_frames_max"],
          f"relocalized on the map within {case['frames']} frame(s) (the "
          f"reference: {ref['reloc_frames_max']} at most over its seeds)")
    check(case["centre_m"] <= 2 * ref["reloc_centre_m_worst"]
          and case["rot_deg"] <= 2 * ref["reloc_rot_deg_worst"],
          f"the relocalized pose {case['centre_m']:.4f} m / "
          f"{case['rot_deg']:.3f} deg from the pose the run tracked there "
          f"(<= 2x the reference's worst {ref['reloc_centre_m_worst']:.4f}"
          f" m / {ref['reloc_rot_deg_worst']:.3f} deg)")
    check(all(reloc[k] > 0 for k in PATH_RELOC),
          f"every kernel of relocalization launched ({', '.join(PATH_RELOC)})")
    seed_spread(dev, S, got)
    return launches, reloc


SPREAD_SEEDS = (1, 2, 3, 4)     # besides phase 13's cfg.seed 0


def seed_spread(dev, S, first):
    """The witness for REF_MH's range rule: the replay again with cfg.seed
    1..4 (the tracker's generator: the bootstrap's RANSAC draws, so the
    initial map), beside seed 0's run (`first`, phase 13's `got`).  Every
    run meets the regression's bounds and has its keyframes, points and
    lines within 10% of the reference's range over its own five seeds;
    the port's median of each count over its five runs lies inside that
    range (the card's spread is the reference's, not below it)."""
    runs = [first]
    for seed in SPREAD_SEEDS:
        t0 = time.perf_counter()
        with torch.no_grad():
            o = SystemRun(device=dev, seed=seed,
                          use_loop_closing=False)(S)
        torch.cuda.synchronize()
        runs.append(dict(n_tracked=o.n_tracked, imu_init_kf=o.imu_init_kf,
                         keyframes=o.keyframes, points=o.points,
                         lines=o.lines, maps=o.maps, ba_norm=o.ba_norm,
                         final_state=o.final_state, ate_sim3=o.ate_sim3,
                         ate_se3=o.ate_se3, imu=o.imu_initialized))
        print(f"  cfg.seed {seed}: {runs[-1]} "
              f"({time.perf_counter() - t0:.1f} s)")
        del o
    runs[0] = dict(runs[0], imu=True)   # checked in phase 13
    n = len(S["frames"])
    bad = [i for i, r in enumerate(runs) if not (
        r["imu"] and r["maps"] == 1 and r["final_state"] != 4
        and r["ba_norm"] < 0.5 and r["n_tracked"] >= 0.85 * n
        and r["lines"] >= 20 and r["ate_sim3"] < 0.6 and r["ate_se3"] < 1.0)]
    check(not bad, f"the regression's bounds on every cfg.seed 0..4 "
          f"(failing: {bad})")
    ref = REF_MH
    for k in ("keyframes", "points", "lines"):
        check_band(f"{k} over cfg.seed 0..4", [r[k] for r in runs],
                   ref[k + "_min"], ref[k + "_max"], median=True)



# --------------------------------------------------------------------------
# Phase 14: loop closing and map merge (slice 10)
# --------------------------------------------------------------------------
# tests/test_torch_loop_closing.py's JAX LoopCloser at production caps (pose
# graph 512 x 4096, global BA 128 x 8192 x 32768) on the CPU: the drifted
# circle (the last 4 keyframes fed: which closed, the revisit keyframe's
# centre from the first's before and after, m) and the merge (the young
# map's last 3: which merged, merges, live points after, the merged
# keyframes' largest centre error, m); printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 \
#  tests/test_torch_loop_closing.py`
REF_LOOPCLOSE = {"circle": {"closed": [False, False, False, True],
                            "err_before": 0.2630667984485626,
                            "err_after": 0.006363206543028355},
                 "merge": {"closed": [False, True, False], "merges": 1,
                           "points": 2820,
                           "err_after": 1.727771374249414e-07}}
# scripts/run_mh_loop.py 28 cpu: the JAX System over the 28 s circuit (560
# frames) with the default configuration on the CPU: frames tracked,
# keyframes and maps at the end, loops closed, ATE RMSE (m) after
# global_refine, the loop-closing stage's mean ms a keyframe (the CPU's)
REF_LOOP = {"n_frames": 560, "n_tracked": 530, "keyframes": 68, "maps": 2,
            "loops": 0, "ate_sim3": 1.8088, "ate_se3": 1.9566,
            "loop_closing_ms_cpu": 4947.87, "loop_closing_calls": 133}
PATH_LOOP = ("bow_transform", "bow_score", "hamming_match", "hamming_matrix",
             "sim3_ransac", "sim3_reproj", "pose_graph", "ba_linearize",
             "schur_solve", "schur_solve_global")
PATH_MERGE = ("bow_transform", "bow_score", "hamming_match",
              "hamming_matrix", "sim3_ransac", "sim3_reproj", "ba_linearize",
              "schur_solve", "schur_solve_global")
PATH_GBA = ("ba_linearize", "schur_solve", "schur_solve_global")
PATH_MH_LOOP = PATH_SYSTEM + ("bow_score",)


class Recorder:
    """Wraps a module function and keeps the arguments of its calls (the
    kernel checks of phase 14 run on the inputs the path gave them)."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name
        self.orig = getattr(mod, name)
        self.calls = []

        def rec(*a, **kw):
            self.calls.append((tuple(x.clone() if torch.is_tensor(x) else x
                                     for x in a), dict(kw)))
            return self.orig(*a, **kw)
        setattr(mod, name, rec)

    def restore(self):
        setattr(self.mod, self.name, self.orig)


def reproj_rms(m):
    """RMS reprojection error (px) of every point observation of a map."""
    ks, fs = np.nonzero((m.kf_match_pt >= 0) & m.kf_valid[:, None])
    X = m.pt_xyz[m.kf_match_pt[ks, fs]].astype(np.float64)
    P = m.kf_pose_cw[ks].astype(np.float64)
    pc = np.einsum("oij,oj->oi", P[:, :, :3], X) + P[:, :, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    K = K_EUROC
    uv = np.stack([K.fx * pc[:, 0] / z + K.cx, K.fy * pc[:, 1] / z + K.cy],
                  -1)
    return float(np.sqrt(((uv - m.kf_feat_uv[ks, fs]) ** 2).sum(-1).mean()))


def check_loop_kernels(rec, report, smi):
    """Phase 14 (a): each new kernel against its plain version and float64
    on the inputs the loop-closure path gave it (the drifted circle's
    verification and graph), by the rule of `ops.pnp.sim3_against_float64`
    / `KN.pose_graph_against_float64` (within 2x the plain float32 run's
    distance to float64 + 1e-6, the same bits on a second launch), and
    times, bounds and launches for the kernel line."""
    dev = torch.device("cuda")
    (X1, X2, valid, samples), kw = rec["sim3_ransac"].calls[0]
    th, fix = kw.get("th", 0.08), kw.get("fix_scale", False)
    own = TV.sample_indices(valid.cpu(), 64, 3,
                            torch.Generator().manual_seed(1)).to(dev)
    for what, smp in (("the path's samples", samples), ("the card's own",
                                                        own)):
        r = PNP.sim3_against_float64(X1, X2, valid, smp, th, fix)
        check(not r["failures"],
              f"sim3_ransac on the drifted circle's verification "
              f"({int(valid.sum())} matches), {what}: best {r['best']}, "
              f"{r['n']} inliers and (s, R, t) as the float64 run's (gap "
              f"{r['gap']:.2e}, the plain float32 run's "
              f"{r['plain_gap']:.2e}) {r['failures']}")
    n, it = X1.shape[0], samples.shape[0]
    report["sim3_ransac"] = dict(
        **work(4 * (6 * n + 3 * it + 2 + it + 13) + 2 * n,
               it * (400 + 30 * n) + 40 * n + 2000),
        max_abs_err=r["gap"],
        ms=cuda_ms(lambda: PNP.sim3_ransac(X1, X2, valid, samples, th, fix)),
        plain_ms=cuda_ms(lambda: PNP.sim3_ransac_plain(X1, X2, valid,
                                                       samples, th, fix),
                         reps=5), library_ms=None)
    args, kw = rec["sim3_reproj"].calls[0]
    K, targs = args[0], args[1:12]
    for fs in (False, True):
        r = KN.sim3_reproj_against_float64(K, targs, fix_scale=fs)
        check(not r["failures"],
              f"sim3_reproj (fix_scale {fs}) on the circle's "
              f"{int(targs[3].sum())} pairs a side: S13 {r['kernel']:.2e} "
              f"from float64 (the plain run's {r['plain']:.2e}), {r['n']} "
              f"inliers {r['failures']}")
        if not fs:
            e_rep = r["kernel"]
    cap = targs[1].shape[0]
    rounds, iters = 3, 8
    report["sim3_reproj"] = dict(
        **work(4 * (2 * cap * 6 + 13 + 24) + 4 * cap + 13 * 4 + 4,
               rounds * (iters + 1) * 2 * cap * (160 + 60)),
        max_abs_err=e_rep,
        ms=cuda_ms(lambda: KN.sim3_reproj(K, *targs)),
        plain_ms=cuda_ms(lambda: KN.sim3_reproj_plain(K, *targs), reps=2,
                         warmup=1), library_ms=None)
    gargs, _ = rec["pose_graph"].calls[0]
    graphs = [("Sim3, the circle", gargs[:9], False, gargs[11]),
              ("4-DoF, the circle", gargs[:9], True, gargs[11])]
    # the 601-keyframe chain through a production-cap graph (301 anchors)
    from plvio_tpu_torch.config import CameraConfig, SystemConfig
    from plvio_tpu_torch.inputs import build_big_chain
    from plvio_tpu_torch.models.loop_closing import LoopCloser
    from plvio_tpu_torch.models.mapstore import Atlas
    m, kfs, gt = build_big_chain()
    lc = LoopCloser(SystemConfig(camera=CameraConfig(dist=(0.0,) * 4),
                                 use_lines=False), Atlas(maps=[m], active=0),
                    None, m.n_feat, device=dev)
    chain = m.kf_chain()
    pre = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                    m.kf_pose_cw[k, :, 3].copy()) for k in chain}
    kf, cand = int(kfs[-1]), int(kfs[0])
    R_w = gt[-1][0].T @ pre[kf][0]
    t_w = gt[-1][0].T @ (pre[kf][1] - gt[-1][1])
    Rn = m.kf_pose_cw[kf, :, :3] @ R_w.T
    m.kf_pose_cw[kf, :, 3] = m.kf_pose_cw[kf, :, 3] - Rn @ t_w
    m.kf_pose_cw[kf, :, :3] = Rn
    n0 = len(rec["pose_graph"].calls)
    lc._essential_graph(kf, cand, 1.0, R_w, t_w, pre, {kf})
    bargs, n_act = rec["pose_graph"].calls[n0][0][:9], \
        rec["pose_graph"].calls[n0][0][11]
    graphs.append((f"Sim3, the 601-KF chain ({n_act} anchors)", bargs,
                   False, n_act))
    # the graph at its full capacity: a 512-keyframe chain, S = 3584
    m, kfs, gt = build_big_chain(n_kf=511)
    lc = LoopCloser(SystemConfig(camera=CameraConfig(dist=(0.0,) * 4),
                                 use_lines=False), Atlas(maps=[m], active=0),
                    None, m.n_feat, device=dev)
    chain = m.kf_chain()
    pre = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                    m.kf_pose_cw[k, :, 3].copy()) for k in chain}
    kf, cand = int(kfs[-1]), int(kfs[0])
    R_w = gt[-1][0].T @ pre[kf][0]
    t_w = gt[-1][0].T @ (pre[kf][1] - gt[-1][1])
    n0 = len(rec["pose_graph"].calls)
    lc._essential_graph(kf, cand, 1.0, R_w, t_w, pre, {kf})
    fargs, n_full = rec["pose_graph"].calls[n0][0][:9], \
        rec["pose_graph"].calls[n0][0][11]
    graphs.append((f"Sim3, a {n_full}-KF chain (the capacity)", fargs,
                   False, n_full))
    errs = []
    for what, a, four, n_act in graphs:
        r = KN.pose_graph_against_float64(a, four_dof=four, n_active=n_act)
        print(f"  pose_graph {what}: S = {r['S']}, path "
              f"{('one block', 'global')[r['path']]}, kernel "
              f"{r['kernel']:.2e} / plain {r['plain']:.2e} from float64, "
              f"the float64 solve moved a state by {r['step']:.3f}")
        check(not r["failures"],
              f"pose_graph {what} (S = {r['S']}, "
              f"{('one block', 'global')[r['path']]} path): within 2x the "
              "plain float32 run's distance to float64 + 1e-6, the same bits "
              f"on a second launch {r['failures']}")
        check(r["path"] == (1 if r["S"] > KN.PG_ONE_BLOCK_MAX_S else 0),
              f"pose_graph reported the {('one block', 'global')[r['path']]}"
              f" path at S = {r['S']}")
        errs.append(r["kernel"])
    # a graph's work: 15 iterations of the edges' 14-direction
    # linearization (~1500 operations a direction), the blocks' sums, the
    # factorization S^3 / 3 and two solves, the retraction and two cost
    # passes (~700 operations an edge); bytes: states in and out, edges
    for key, (what, a, four, n_a) in (("pose_graph", graphs[0]),
                                      (GLOBAL_PG[0], graphs[3])):
        E_ = int(a[7].sum())
        S = 7 * n_a
        ops = 15 * (E_ * (14 * 1500 + 2 * 700 + 2 * 49 * 14) + S ** 3 / 3
                    + 2 * S * S + n_a * 400)
        Hs = torch.randn(S, S, device=dev)
        Hs = Hs @ Hs.T + S * torch.eye(S, device=dev)
        g = torch.randn(S, 1, device=dev)

        def library():
            for _ in range(15):
                torch.cholesky_solve(g, torch.linalg.cholesky(Hs))
        report[key] = dict(
            **work(4 * (13 * n_a * 2 + E_ * 16 + n_a), ops),
            max_abs_err=errs[0 if key == "pose_graph" else 3],
            ms=cuda_ms(lambda: KN.pose_graph(*a, four_dof=four,
                                             n_active=n_a), reps=3,
                       warmup=1),
            plain_ms=cuda_ms(lambda: KN.pose_graph_compacted_plain(
                *a, four_dof=four, n_active=n_a), reps=1, warmup=1),
            library_ms=cuda_ms(library, reps=2, warmup=1))
        print(f"  pose_graph, {what}: S = {S}, {E_} edges; plain: the "
              "engine's float32 LM with torch's Cholesky, on the card; "
              "library: 15 x torch.linalg.cholesky + cholesky_solve at the "
              f"same S, on {smi}")
    (a, b), _ = rec["hamming_dist"].calls[0]
    hk = M.hamming_dist(a, b)
    hp = M.hamming_dist_plain(a, b)
    check(torch.equal(hk, hp), f"hamming_match's matrix mode "
          f"{a.shape[0]} x {b.shape[0]}: equal to the plain matmul")
    report["hamming_matrix"] = dict(
        **work(32 * (a.shape[0] + b.shape[0]) + 4 * a.shape[0] * b.shape[0],
               16 * a.shape[0] * b.shape[0]), max_abs_err=0.0,
        ms=cuda_ms(lambda: M.hamming_dist(a, b)),
        plain_ms=cuda_ms(lambda: M.hamming_dist_plain(a, b)),
        library_ms=None)


def run_slice10(dev, smi, seq_map, render):
    """Phase 14: the loop closer at production caps on the drifted circle
    and the merge (`entry.loop_closure`, each in a launch window of its
    own), the new kernels against plain and float64 on the inputs the
    circle gave them, the global BA of the keyframe sequence's final map
    (window of its own), and the 28 s circuit through `System` with the
    default configuration (`entry.mh_loop`; frames rendered by a process
    started at the script's beginning).  Returns (launches by path,
    report entries)."""
    print("[14] slice 10: loop closing and map merge (entry.loop_closure at "
          "production caps), the kernels against float64, the global BA "
          "at 128 KF, the 28 s circuit through System")
    report = {}
    recs = {name: Recorder(mod, name) for mod, name in (
        (PNP, "sim3_ransac"), (KN, "sim3_reproj"), (KN, "pose_graph"),
        (M, "hamming_dist"))}
    launches = {}
    try:
        out = {}
        for case in ("circle", "merge"):
            step, inputs = loop_closure(case, device=dev)
            reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                out[case] = o = step(inputs)
            torch.cuda.synchronize()
            launches[case] = read_counts()
            print(f"  {case}: closed {o.closed}, loops {o.loops}, merges "
                  f"{o.merges}, verifications {o.verifications}, error "
                  f"{o.err_before:.4f} -> {o.err_after:.4f} m, points "
                  f"{o.points}, graph {o.graph}, ms per keyframe "
                  f"{[round(x, 1) for x in o.ms]} "
                  f"({time.perf_counter() - t0:.1f} s), on {smi}")
            print(f"  launches: {launches[case]}")
        ref = REF_LOOPCLOSE
        o = out["circle"]
        check(o.loops == 1 and o.err_after < 0.12
              and o.err_after <= 2 * ref["circle"]["err_after"],
              f"the drifted circle closed within its last 4 keyframes "
              f"({o.closed}), revisit error {o.err_after:.4f} m < 0.12 and "
              f"<= 2x the JAX loop closer's {ref['circle']['err_after']:.4f}")
        check(all(launches["circle"][k] > 0 for k in PATH_LOOP),
              f"every kernel of the loop closure launched "
              f"({', '.join(PATH_LOOP)})")
        o = out["merge"]
        rm = ref["merge"]
        check(o.merges == rm["merges"] == 1 and o.maps == 1
              and abs(o.points - rm["points"]) <= 0.05 * rm["points"]
              and o.err_after < 0.08,
              f"the young map merged ({o.closed}), {o.points} points after "
              f"the fusion within 5% of the JAX run's {rm['points']}, the "
              f"merged keyframes within {o.err_after:.4f} < 0.08 m")
        check(all(launches["merge"][k] > 0 for k in PATH_MERGE),
              f"every kernel of the merge launched ({', '.join(PATH_MERGE)})")
        check_loop_kernels(recs, report, smi)
    finally:
        for r in recs.values():
            r.restore()
    # (c) the global BA of the keyframe sequence's final map
    from plvio_tpu_torch.config import CameraConfig, SystemConfig
    from plvio_tpu_torch.models.loop_closing import LoopCloser
    from plvio_tpu_torch.models.mapstore import Atlas
    rms0 = reproj_rms(seq_map)
    n_lines = int(seq_map.ln_valid.sum())
    lc = LoopCloser(SystemConfig(camera=CameraConfig(dist=(0.0,) * 4)),
                    Atlas(maps=[seq_map], active=0), None, seq_map.n_feat,
                    device=dev)
    chain = seq_map.kf_chain()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        lc.run_global_ba(fixed_kf=int(chain[0]))
    torch.cuda.synchronize()
    ms_gba = (time.perf_counter() - t0) * 1e3
    launches["gba"] = read_counts()
    rms1 = reproj_rms(seq_map)
    print(f"  global BA of the sequence's map ({len(chain)} KF, {n_lines} "
          f"lines, caps {lc._gba_caps}): reprojection RMS {rms0:.4f} -> "
          f"{rms1:.4f} px in {ms_gba:.1f} ms, launches {launches['gba']}, "
          f"on {smi}")
    check(launches["gba"][GLOBAL[0]] > 0 and lc.gba_pl_kernel is not None
          and all(launches["gba"][k] > 0 for k in PATH_GBA),
          "the global BA with lines took schur_solve's global path (S = 768)")
    check(np.isfinite(rms1) and rms1 <= rms0,
          f"its reprojection RMS {rms1:.4f} px <= the input's {rms0:.4f}")
    # (d) the circuit through System with the default configuration
    waited = render.wait(0)
    check(waited is not None, "the circuit's frames rendered "
          f"(waited {waited} s for the render process)")
    from plvio_tpu_torch.entry import SystemRun
    from plvio_tpu_torch.inputs import MH_LOOP_SECONDS, build_mh_loop
    S = build_mh_loop(MH_LOOP_SECONDS,
                      frames=render.frames(0, render.n_circuit))
    step = SystemRun(device=dev)
    check(step.cfg.use_loop_closing, "the default configuration: loop "
          "closing on")
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        o = step(S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["mh_loop"] = read_counts()
    from plvio_tpu_torch.models.tracking import TrackState
    fr = o.frames
    kf_ms = [f.ms for f in fr if f.keyframe]
    tr_ms = [f.ms for f in fr if f.tracked and not f.keyframe]
    lcs = o.metrics.get("loop_closing", {})
    got = dict(n_tracked=o.n_tracked, n_frames=len(fr), keyframes=o.keyframes,
               lines=o.lines, maps=o.maps, loops=o.loops, merges=o.merges,
               verifications=o.verifications, imu=o.imu_initialized,
               final_state=o.final_state, ate_sim3=o.ate_sim3,
               ate_se3=o.ate_se3,
               loop_closing_ms=lcs.get("mean_ms"),
               loop_closing_calls=lcs.get("calls"))
    print(f"  the circuit: {got}; reference {REF_LOOP}")
    print(f"  wall ms a frame: tracked {np.mean(tr_ms):.1f}, keyframe "
          f"{np.mean(kf_ms):.1f} (max {max(kf_ms):.1f}); the loop-closing "
          f"stage {lcs.get('mean_ms')} ms a keyframe; {wall:.1f} s in all; "
          f"launches {launches['mh_loop']}, on {smi}")
    # test_mh_loop_single_map_survival's bounds, but for the map count:
    # the JAX System's own run of this tree splits the circuit in two
    # maps at t ~ 15 s (REF_LOOP), so the port is held to no more maps
    # than the reference made
    check(o.imu_initialized and o.maps <= max(1, REF_LOOP["maps"])
          and o.final_state != int(TrackState.LOST)
          and o.n_tracked >= 0.85 * len(fr),
          f"test_mh_loop_single_map_survival's bounds: IMU initialized "
          f"({o.imu_initialized}), {o.maps} map(s) (one: "
          f"{o.maps == 1}; the reference's run {REF_LOOP['maps']}), not "
          f"LOST at the end ({o.final_state}), {o.n_tracked} / {len(fr)} "
          ">= 85% tracked")
    check(all(launches["mh_loop"][k] > 0 for k in PATH_MH_LOOP),
          f"every kernel of the System path launched, the loop closer's "
          f"query included ({', '.join(PATH_MH_LOOP)})")
    return launches, report


# --------------------------------------------------------------------------
# Phase 15: slice 11, the rectified-stereo front
# --------------------------------------------------------------------------

class RecordingRun(SystemRun):
    """`SystemRun` whose System's tracker records the last arguments of
    its point+line pose IRLS and of its VI pose optimizer (by have_prior):
    the kernels' inputs on the main path; and after every pair the map's
    keyframes, points and lines and the features bound to a map point
    (`per_pair`, host values the tracker holds anyway)."""

    def forward(self, S):
        import contextlib
        self.per_pair = []

        @contextlib.contextmanager
        def after(i):
            yield
            tr = self.slam.tracker
            m, f = tr.map, tr.last_feat_pt
            self.per_pair.append((int(m.n_kf), int(m.n_pt), int(m.n_ln),
                                  0 if f is None else int((f >= 0).sum())))
        return super().forward(S, frame_ctx=after)

    def new_system(self):
        slam = super().new_system()
        self.slam = slam
        tr = slam.tracker
        self.rec = {}
        pl, vi = getattr(tr, "pose_opt_pl", None), tr.vi_pose_opt

        def pl_rec(*a):
            self.rec["pl"] = a
            return pl(*a)

        def vi_rec(*a):
            self.rec[("vi", bool(a[-1]))] = a
            return vi(*a)
        if pl is not None:
            tr.pose_opt_pl = pl_rec
        tr.vi_pose_opt = vi_rec
        return slam


def check_fed_trace(per_pair):
    """The replay's first pairs, through the keyframe that initializes the
    IMU, against the JAX System fed the port's CPU features (FED_STEREO):
    the same keyframe count after every pair, and the map's points and
    lines and the pair's bound features each within max(2, 1%) (the
    inlier rule of the solvers against float64: a feature near a gate
    may fall either way in float32)."""
    ref = FED_STEREO
    n = len(ref["inliers"])
    at = {c[0]: tuple(c[1:]) for c in ref["counts_at"]}
    want, counts = [], None
    for i in range(n):
        counts = at.get(i, counts)
        want.append(counts + (ref["inliers"][i],))
    bad, worst = [], [0] * 4
    for i, (got, ref_i) in enumerate(zip(per_pair[:n], want)):
        gaps = [abs(a - b) for a, b in zip(got, ref_i)]
        worst = [max(w, g) for w, g in zip(worst, gaps)]
        if gaps[0] or any(g > max(2, 0.01 * r)
                          for g, r in zip(gaps[1:], ref_i[1:])):
            bad.append((i, got, ref_i))
    print(f"  pairs 0..{n - 1} against the JAX System fed the port's CPU "
          f"features: largest gaps (keyframes, points, lines, bound) "
          f"{worst}; off: {bad[:8]}")
    check(len(per_pair) >= n and not bad,
          f"pairs 0..{n - 1} (through the IMU initialization): keyframes "
          f"equal, points, lines and bound features within max(2, 1%) of "
          f"the JAX System fed the port's CPU features")


def check_stereo_matchers(S, report):
    """`match_stereo` / `match_stereo_lines` against their plain versions on
    the stereo replay's first pair (the port's front end on the card) and
    on synthetic sets: every output bit-equal; times and bounds on the
    pair."""
    dev = torch.device("cuda")
    orb = FE.OrbExtractor(FE.make_level_specs(H, W, N_FEAT)).to(dev)
    lines = LN.LineExtractor(N_LINE, levels=2).to(dev)
    views = [torch.from_numpy(S[k][0]).to(dev) for k in ("frames", "right")]
    with torch.no_grad():
        fl, fr = (orb(v) for v in views)
        ll, lr = (lines(v) for v in views)
    bf = stereo_config().camera.baseline * K_EUROC.fx
    pt_case = (fl.uv.contiguous(), fl.desc, fl.octave, fl.valid,
               fr.uv.contiguous(), fr.desc, fr.octave, fr.valid, bf)
    ln_case = (ll.ep.contiguous(), ll.desc, ll.angle.contiguous(), ll.valid,
               lr.ep.contiguous(), lr.desc, lr.angle.contiguous(), lr.valid,
               bf)
    from plvio_tpu_torch.kernel_digest import stereo_point_case
    syn_case = (*stereo_point_case(dev), bf)
    errs = {}
    for name, fn, plain, case in (
            ("points", ST.match_stereo, ST.match_stereo_plain, pt_case),
            ("synthetic points", ST.match_stereo, ST.match_stereo_plain,
             syn_case),
            ("lines", ST.match_stereo_lines, ST.match_stereo_lines_plain,
             ln_case)):
        k, p = fn(*case), plain(*case)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        errs[name] = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(k, p))
        check(same, f"hamming_match stereo {name}: u_R / depths and has "
              f"bit-equal to the plain version ({int(k[2].sum())} of "
              f"{case[0].shape[0]} with a depth)")
    # the point gate on every pair (~6 operations), the line gate (~20:
    # the wrapped angle, the y-spans, the midpoints), then XOR + popc of
    # 8 words on the pairs it admits (~17); the epilogue ~10 a row
    n_l, n_r = fl.uv.shape[0], fr.uv.shape[0]
    tol = 2.0 * torch.from_numpy(M.OCTAVE_SCALE).to(dev)[fl.octave.long()]
    disp = fl.uv[:, None, 0] - fr.uv[None, :, 0]
    gated = int(((fl.uv[:, None, 1] - fr.uv[None, :, 1]).abs()
                 <= tol[:, None]) .logical_and(disp > 0.1)
                .logical_and(disp <= bf / 0.1)
                .logical_and(fl.valid[:, None] & fr.valid[None, :]).sum())
    out = ST.match_stereo(*pt_case)
    report["hamming_match_stereo"] = dict(
        **work(nbytes(*pt_case[:8]) + nbytes(*out),
               6 * n_l * n_r + 17 * gated + 10 * n_l),
        max_abs_err=max(errs["points"], errs["synthetic points"]),
        ms=cuda_ms(lambda: ST.match_stereo(*pt_case)),
        plain_ms=cuda_ms(lambda: ST.match_stereo_plain(*pt_case)),
        library_ms=None)
    nl_l, nl_r = ll.ep.shape[0], lr.ep.shape[0]
    out = ST.match_stereo_lines(*ln_case)
    lg = ll.valid[:, None] & lr.valid[None, :]
    report["hamming_match_stereo_lines"] = dict(
        **work(nbytes(*ln_case[:8]) + nbytes(*out),
               20 * nl_l * nl_r + 17 * int(lg.sum()) + 20 * nl_l),
        max_abs_err=errs["lines"],
        ms=cuda_ms(lambda: ST.match_stereo_lines(*ln_case)),
        plain_ms=cuda_ms(lambda: ST.match_stereo_lines_plain(*ln_case)),
        library_ms=None)


def check_stereo_solvers(run, slam, report):
    """The stereo pose IRLS and the stereo VI pose optimizer on the inputs
    the tracker gave them in the replay (its last call of each; the VI
    one with and without the prior where the run made both), against
    their plain versions' float64 runs; times and bounds on them."""
    tr = slam.tracker
    bf = tr.bf
    a = run.rec["pl"]
    pargs = [x.contiguous() for x in a[:10]]
    ur = a[10].contiguous()
    r = KN.pose_irls_against_float64(K_EUROC, pargs, ur, bf)
    n_st = int(((ur > 0) & pargs[3]).sum())
    print(f"  pose_irls_stereo on the replay's last point+line frame "
          f"({int(pargs[3].sum())} points matched, {n_st} of them with "
          f"u_R): {r}")
    check(not r["failures"], "pose_irls with u_R rows as its float64 run "
          f"(state gap {r['kernel']:.2e}, the plain float32 runs' "
          f"{r['plain']:.2e} over {len(r['plain_orders'])} row orders; "
          f"{r['failures']})")
    Pk = KN.pose_irls(K_EUROC, *pargs, ur=ur, bf=bf)
    Pp = KN.pose_irls_plain(K_EUROC, *pargs, ur=ur, bf=bf)
    n, L = pargs[2].shape[0], pargs[5].shape[0]
    report["pose_irls_stereo"] = dict(
        **work(nbytes(*pargs, ur) + nbytes(*Pk[:3]) + 4,
               12 * (150 * n + 50 * n_st + 300 * L)),
        max_abs_err=float((Pk[0] - Pp[0]).abs().max()),
        ms=cuda_ms(lambda: KN.pose_irls(K_EUROC, *pargs, ur=ur, bf=bf)),
        plain_ms=cuda_ms(lambda: KN.pose_irls_plain(K_EUROC, *pargs, ur=ur,
                                                    bf=bf)),
        library_ms=None)
    dev = pargs[0].device
    Rcb = torch.from_numpy(np.ascontiguousarray(tr.R_cb)).to(dev)
    tcb = torch.from_numpy(np.ascontiguousarray(tr.t_cb)).to(dev)
    vis = [k for k in (("vi", True), ("vi", False)) if k in run.rec]
    check(bool(vis), "the replay ran the VI pose optimizer")
    worst = 0.0
    for key in vis:
        v = run.rec[key]
        hp = key[1]
        vargs = [Rcb, tcb, slam.cfg.imu.gravity, *v[:4],
                 v[4][:, :2].contiguous(), *v[5:15]]
        vur = v[4][:, 2].contiguous()
        r = KN.vi_pose_lm_against_float64(K_EUROC, vargs, hp, vur, bf)
        print(f"  vi_pose_lm_stereo on the replay's last VI frame "
              f"(have_prior={hp}; {int(v[6].sum())} matched, "
              f"{int(((vur > 0) & v[6]).sum())} of them with u_R): {r}")
        check(not r["failures"], f"vi_pose_lm with the stereo term "
              f"(have_prior={hp}) as its float64 run (state gap "
              f"{r['kernel']:.2e}, the plain float32 runs' {r['plain']:.2e}"
              f" over {len(r['plain_orders'])} row orders; "
              f"{r['failures']})")
        ok_ = KN.vi_pose_lm(K_EUROC, *vargs, hp, ur=vur, bf=bf)
        stats = []
        op_ = KN.vi_pose_opt_plain(K_EUROC, *vargs, hp, stats=stats,
                                   ur=vur, bf=bf)
        worst = max(worst, float((ok_[0] - op_[0]).abs().max()))
    # per LM iteration (the plain version's count on the last case): the
    # linearization and the cost of every edge (~250 operations, ~100 more
    # for a stereo row), then the 30x30 factorization
    cap = vargs[8].shape[0]
    n_st = int(((vur > 0) & vargs[9]).sum())
    report["vi_pose_lm_stereo"] = dict(
        **work(nbytes(*vargs[7:11], vur) + 448 * 4 + 246 * 4 + cap + 4,
               sum(stats) * (250 * cap + 100 * n_st + 2 * 30 ** 3)),
        max_abs_err=worst,
        ms=cuda_ms(lambda: KN.vi_pose_lm(K_EUROC, *vargs, hp, ur=vur,
                                         bf=bf)),
        plain_ms=cuda_ms(lambda: KN.vi_pose_opt_plain(
            K_EUROC, *vargs, hp, ur=vur, bf=bf), reps=3, warmup=1),
        library_ms=None)


def check_mono_digests():
    """The mono calls of the kernels that gained stereo rows and modes
    give the mono-only tree's bits (kernel_digest.py's cases)."""
    from plvio_tpu_torch import kernel_digest as KD
    dev = torch.device("cuda")
    got = {}
    case = KD.vi_case(dev)
    for hp in (True, False):
        got[f"vi_pose_lm have_prior={hp}"] = KD.digest(KN.vi_pose_lm(*case,
                                                                      hp))
    for name, args, kw in KD.hamming_cases(dev):
        got[f"hamming_match {name}"] = KD.digest(M.hamming_match(*args,
                                                                 **kw))
    for nl in (0, 64):
        got[f"pose_irls mono n_lines={nl}"] = KD.digest(
            KN.pose_irls(*KD.pose_case(dev, nl)))
    bad = [k for k, v in PARENT_DIGESTS.items() if got[k] != v]
    check(not bad, "the mono calls of vi_pose_lm, pose_irls and "
          f"hamming_match's modes 0-2 give the mono-only tree's digests "
          f"(differ: {bad})")


def stereo_frames_summary(out, smi):
    fr = out.frames
    boot = fr[:out.init_frame + 1]
    rest = fr[out.init_frame + 1:]
    for what, fs in (("bootstrap frames", boot),
                     ("tracked frames", [f for f in rest if f.tracked
                                         and not f.keyframe]),
                     ("keyframe frames", [f for f in rest if f.keyframe])):
        if not fs:
            print(f"  {what}: none")
            continue
        ms = [f.ms for f in fs]
        print(f"  {what}: {len(fs)}, {np.mean(ms):.2f} ms a frame (wall; "
              f"median {np.median(ms):.2f}, max {max(ms):.2f}), "
              f"{np.mean([f.host_syncs for f in fs]):.1f} host syncs a "
              f"frame, on {smi}")


def run_slice11(dev, smi, render, report):
    """Phase 15 (see the module docstring).  Returns the launches of the
    replay (cfg.seed 0), the STEREO room and the RGB-D room, each counted
    in a window of its own."""
    print("[15] slice 11: track_stereo / track_rgbd, the stereo matchers "
          "and the stereo solver rows")
    waited = render.wait(1)
    check(waited is not None, f"the stereo replay's {render.n_stereo} "
          "pairs rendered after the circuit by the render process (waited "
          f"{waited} s)")
    frames = tuple(render.frames(k, render.n_stereo) for k in (1, 2))
    S = build_stereo_replay(frames=frames)
    check_stereo_matchers(S, report)
    check_mono_digests()

    run = RecordingRun(device=dev, cfg=stereo_config(seed=0))
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = run(S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    got = dict(n_tracked=out.n_tracked, init_frame=out.init_frame,
               imu_init_frame=out.imu_init_frame, imu=out.imu_initialized,
               keyframes=out.keyframes, points=out.points, lines=out.lines,
               maps=out.maps, final_state=out.final_state,
               ate_sim3=out.ate_sim3, ate_se3=out.ate_se3)
    print(f"  launches: {launches}")
    print(f"  cfg.seed 0: {got}")
    print(f"  inliers per frame: {[f.inliers for f in out.frames]}")
    stereo_frames_summary(out, smi)
    print(f"  the stereo replay: {len(out.frames)} pairs in {wall:.1f} s "
          f"({len(out.frames) / wall:.1f} pairs/s, global_refine "
          f"included), on {smi}")
    print(f"  metrics_summary: {json.dumps(out.metrics)}")
    check(out.init_frame == 0, "the depth bootstrap on the first pair")
    check(all(launches[k] > 0 for k in PATH_STEREO),
          f"every kernel of the stereo replay launched "
          f"({', '.join(PATH_STEREO)})")
    check_stereo_solvers(run, out.system, report)
    check_fed_trace(run.per_pair)
    runs = [got]
    for seed in SPREAD_SEEDS:
        t0 = time.perf_counter()
        with torch.no_grad():
            o = SystemRun(device=dev, cfg=stereo_config(seed=seed))(S)
        torch.cuda.synchronize()
        runs.append(dict(n_tracked=o.n_tracked, imu=o.imu_initialized,
                         keyframes=o.keyframes, points=o.points,
                         lines=o.lines, maps=o.maps,
                         final_state=o.final_state, ate_sim3=o.ate_sim3,
                         ate_se3=o.ate_se3))
        print(f"  cfg.seed {seed}: {runs[-1]} "
              f"({time.perf_counter() - t0:.1f} s)")
        del o
    ref = REF_STEREO
    check(all(r["imu"] and r["maps"] <= ref["maps_max"]
              and r["final_state"] != 4 for r in runs),
          "every cfg.seed 0..4: the IMU initialized, one map, not LOST at "
          "the end (as every reference run)")
    # The reference's five runs are one run (cfg.seed reaches no RANSAC
    # draw on this path), so its ranges have no width, and the median rule
    # of REF_MH would ask for its counts bit for bit after 166 pairs.  The
    # pairs through the IMU initialization are held pair by pair above
    # (check_fed_trace).  From there on the runs part: the initialization
    # at pair 110 moves its velocities by 6.1e-3 m/s when every keyframe
    # translation moves one float32 ulp (ROADMAP Queue 3), so where the
    # range has no width, the rule for the end counts is the 10% band.
    for k in ("n_tracked", "keyframes", "points", "lines"):
        check_band(f"{k} over cfg.seed 0..4", [r[k] for r in runs],
                   *ref[k + "_range"], median=True)
    worst = ref["ate_se3_worst"]
    ates = [r["ate_se3"] for r in runs]
    check(max(ates) <= 2 * worst, f"the SE3 ATE over cfg.seed 0..4 "
          f"{[round(a, 4) for a in ates]} m <= 2x the reference's worst "
          f"({worst:.4f} m)")

    reset_counts()
    step, R = stereo_room(15, device=dev)
    with torch.no_grad():
        ro = step(R)
    torch.cuda.synchronize()
    launches_room = read_counts()
    rs = ref["room_stereo"]
    print(f"  STEREO room: tracked {ro.n_tracked} / {len(R['frames'])}, "
          f"keyframes {ro.keyframes}, points {ro.points}, lines {ro.lines},"
          f" ATE {ro.ate_sim3:.4f} / {ro.ate_se3:.4f} m (the reference: "
          f"{rs}); launches {launches_room}")
    check(ro.n_tracked >= 14 and ro.ate_se3 < 0.05
          and ro.ate_se3 <= 2 * rs["ate_se3"],
          f"STEREO with lines over the room: {ro.n_tracked} >= 14 pairs "
          f"tracked, SE3 ATE {ro.ate_se3:.4f} m < 0.05 and <= 2x the "
          f"reference's {rs['ate_se3']:.4f}")
    check(all(launches_room[k] > 0 for k in PATH_ROOM_STEREO),
          f"every kernel of the STEREO room launched "
          f"({', '.join(PATH_ROOM_STEREO)})")
    reset_counts()
    step, R = rgbd_room(12, device=dev)
    with torch.no_grad():
        rd = step(R)
    torch.cuda.synchronize()
    launches_rgbd = read_counts()
    rr = ref["room_rgbd"]
    print(f"  RGB-D room: tracked {rd.n_tracked} / {len(R['frames'])}, "
          f"keyframes {rd.keyframes}, points {rd.points}, ATE "
          f"{rd.ate_sim3:.4f} / {rd.ate_se3:.4f} m (the reference: {rr}); "
          f"launches {launches_rgbd}")
    check(rd.n_tracked >= 11 and rd.ate_se3 < 0.08,
          f"RGB-D over the room: {rd.n_tracked} >= 11 frames tracked, SE3 "
          f"ATE {rd.ate_se3:.4f} m < 0.08")
    check(all(launches_rgbd[k] > 0 for k in PATH_RGBD),
          f"every kernel of the RGB-D room launched ({', '.join(PATH_RGBD)})")
    return launches, launches_room, launches_rgbd


class Slice12Run(SystemRun):
    """`SystemRun` whose System's tracker records the last arguments of
    its point-only stereo LM, of its pose solve and of its projection
    matcher (the KB8 ones on a fisheye camera), and the last frame's raw
    keypoints: the kernels' inputs on the main path."""

    def new_system(self):
        slam = super().new_system()
        tr = slam.tracker
        self.rec = {}

        def recorder(name, fn):
            def rec(*a, **kw):
                self.rec[name] = (a, kw)
                return fn(*a, **kw)
            return rec
        for name in ("pose_opt_stereo", "pose_opt", "proj_match"):
            fn = getattr(tr, name)
            if fn is not None:
                setattr(tr, name, recorder(name, fn))
        extract = slam.extract

        def extract_rec(img):
            f = extract(img)
            self.rec["feats"] = f
            return f
        slam.extract = extract_rec
        return slam


def pose_lm_report(name, args, kb8, smi):
    """A pose LM mode on the inputs the tracker gave it: the float64 rule
    of `KN.pose_lm_against_float64`, then its report (times, bound)."""
    r = KN.pose_lm_against_float64(args, kb8)
    valid = args[4] if kb8 else args[5]
    print(f"  {name} on the run's last call ({int(valid.sum())} of "
          f"{valid.shape[0]} rows valid): {r}")
    check(not r["failures"], f"{name} as its float64 run (pose gap "
          f"{r['kernel']:.2e}, the plain float32 runs' {r['plain']:.2e} over "
          f"{len(r['plain_orders'])} row orders; {r['failures']})")
    if kb8:
        K8, *t = args
        fk = lambda: KN.kb8_pose_lm(K8, *t)  # noqa: E731
        fp = lambda: KN.kb8_pose_lm_plain(K8, *t)  # noqa: E731
        rounds, iters, per_row, per_cost = 3, 6, 260, 70
    else:
        K, bf, *t = args
        fk = lambda: KN.stereo_pose_lm(K, bf, *t)  # noqa: E731
        fp = lambda: KN.stereo_pose_lm_plain(K, bf, *t)  # noqa: E731
        rounds, iters, per_row, per_cost = 4, 10, 200, 45
    Pk, Pp = fk(), fp()
    n = int(valid.sum())
    cap = valid.shape[0]
    # per round: the cost at the start, per iteration the linearization
    # and the candidate's cost of every valid row and a 6x6 factor, then
    # the re-gate of every row
    ops = rounds * (n * per_cost + iters * (n * (per_row + per_cost) + 400)
                    + cap * per_cost)
    return dict(**work(nbytes(*t) + nbytes(*Pk), ops),
                max_abs_err=float((Pk[0] - Pp[0]).abs().max()),
                ms=cuda_ms(fk), plain_ms=cuda_ms(fp, reps=3, warmup=1),
                library_ms=None)


def check_pinhole_digests():
    """The pinhole calls of undistort, proj_match and the point BA give
    the bits of the tree before the KB8 modes
    (kernel_digest.pinhole_digests)."""
    from plvio_tpu_torch import kernel_digest as KD
    got = KD.pinhole_digests(torch.device("cuda"))
    bad = [k for k, v in PINHOLE_DIGESTS.items() if got[k] != v]
    check(not bad, "the pinhole calls of undistort, proj_match and the "
          f"point BA give the pre-KB8 tree's digests (differ: {bad})")


def check_kb8_ba(dev, report):
    """ba_linearize's KB8 mode on the typical window
    (`inputs.build_kb8_window`): one linearization against the plain
    engine's normal equations (jacrev through the lens), the whole BA
    against the float64 rule of the point-only window."""
    from plvio_tpu_torch.inputs import build_kb8_window, kb8_camera
    K8 = kb8_camera()
    A = build_kb8_window(device=dev)
    ba = list(A.values())
    cpu = [a.cpu() for a in ba]
    ref = KN.local_ba_plain(K8, *[a.double() if a.is_floating_point()
                                  else a for a in cpu])[0]

    def gap(out):
        return float((out[0].cpu().double() - ref).abs().max())
    with torch.no_grad():
        gk = gap(KN.local_ba(K8, *ba))
        gc = gap(KN.local_ba_plain(K8, *cpu))
    print(f"  KB8 window BA (16 KF x {ba[2].shape[0]} points x "
          f"{ba[4].shape[0]} observations): KF poses from the float64 run: "
          f"kernel {gk:.2e}, plain on the CPU {gc:.2e}")
    check(gk <= 2 * gc + 1e-6, "the KB8 window BA's kernel path within 2x "
          "the CPU plain run's distance to the engine in float64")
    w = KN._BAWork(K8, *ba, *KN.no_lines(dev), lam0=1e-4, early_tol=1e-2,
                   cg_iters=w_cg(6 * ba[0].shape[0]))
    n_kf, n_pt, n_obs = ba[0].shape[0], ba[2].shape[0], ba[4].shape[0]
    prob = KN._ba_problem(K8, n_kf, n_pt, 0, ba[4].long(), ba[5].long(),
                          ba[6], ba[7], ba[8])
    st = {"pose": ba[0], "pt": ba[2]}
    lerr = max(KN.linearization_against_plain(w, prob, st).values())
    t = w.t
    check(lerr <= 1e-4, f"ba_linearize's KB8 mode: H blocks, g, Hpp, gp and "
          f"B within {lerr:.2e} relative of the plain engine (<= 1e-4)")
    # per observation: the projection through the lens and its Jacobian
    # (~150 operations), the pose and point rows and the blocks (~400)
    report["ba_linearize_kb8"] = dict(
        **work(nbytes(*ba) + nbytes(t["hcc"], t["hpt"], t["p_w"]),
               550 * n_obs),
        max_abs_err=lerr,
        ms=cuda_ms(lambda: w.linearize(KN.BA_MODE_LINEARIZE)),
        plain_ms=cuda_ms(lambda: prob.build_normal_equations(st), reps=5),
        library_ms=None)


def check_kb8_front(run, slam, report):
    """undistort's and proj_match's KB8 modes on the fisheye run's last
    frame: its raw keypoints and the matcher's last call, against their
    plain versions on the card."""
    cam = slam.camera
    kp = run.rec["feats"].uv.contiguous()
    uk = CAM.undistort(cam, kp, None)[0]
    up = CAM.undistort_frame_plain(cam, kp, None)[0]
    du = float((uk - up).abs().max())
    check(du <= 1e-4, f"undistort's KB8 mode on the last frame's "
          f"{kp.shape[0]} keypoints within {du:.2e} px of the plain version "
          "(<= 1e-4)")
    n = kp.shape[0]
    # per keypoint 10 Newton steps of ~25 operations, tan and the pixels
    report["undistort_kb8"] = dict(
        **work(nbytes(kp) + nbytes(uk), n * (10 * 25 + 40)),
        max_abs_err=du, ms=cuda_ms(lambda: CAM.undistort(cam, kp, None)),
        plain_ms=cuda_ms(lambda: CAM.undistort_frame_plain(cam, kp, None)),
        library_ms=None)
    a, kw = run.rec["proj_match"]
    K8 = slam.tracker.kb8
    args = [x.contiguous() if torch.is_tensor(x) else x for x in a]
    kw = {k: (v.contiguous() if torch.is_tensor(v) else v)
          for k, v in kw.items()}
    pk = KN.proj_match(K8, *args, **kw)
    pp = KN.proj_match_plain(K8, *args, **kw)
    check(all(torch.equal(x, y) for x, y in zip(pk, pp)),
          f"proj_match's KB8 mode on the tracker's last call: all four "
          f"outputs identical ({int(pk[2].sum())} of {args[1].shape[0]} "
          "matched)")
    P, F_ = args[1].shape[0], args[4].shape[0]
    scale = torch.from_numpy(KN.OCTAVE_SCALE).to(kp.device)[args[6].long()]
    uvp, okp = KN.project_gates(K8, args[0], args[1], args[3])
    adm = int((((uvp[:, None] - args[4][None]) ** 2).sum(-1)
               <= (float(args[8]) * scale) ** 2)[okp].sum())
    report["proj_match_kb8"] = dict(
        **work(nbytes(*args[:8]) + nbytes(*pk), 90 * P + 8 * P * F_
               + 17 * adm),
        max_abs_err=float((pk[0] - pp[0]).abs().max()),
        ms=cuda_ms(lambda: KN.proj_match(K8, *args, **kw)),
        plain_ms=cuda_ms(lambda: KN.proj_match_plain(K8, *args, **kw)),
        library_ms=None)


def room_summary(what, out, n, ref, launches, smi):
    print(f"  {what}: tracked {out.n_tracked} / {n}, keyframes "
          f"{out.keyframes}, points {out.points}, maps {out.maps}, ATE "
          f"{out.ate_sim3:.4f} / {out.ate_se3:.4f} m (the reference: {ref});"
          f" launches {launches}")
    stereo_frames_summary(out, smi)


def run_slice12(dev, smi, report):
    """Phase 16 (see the module docstring).  Returns the launches of the
    STEREO room, the RGB-D room and the fisheye room, each counted in a
    window of its own."""
    from plvio_tpu_torch.config import Sensor
    from plvio_tpu_torch.entry import kb8_config
    from plvio_tpu_torch.inputs import build_kb8_room, build_stereo_room
    print("[16] slice 12: STEREO and RGB-D without lines, the KB8 fisheye")
    check_pinhole_digests()
    # -- STEREO without lines
    R = build_stereo_room(0, 15)
    run = Slice12Run(device=dev, cfg=stereo_config(
        Sensor.STEREO, use_lines=False, use_loop_closing=False))
    reset_counts()
    with torch.no_grad():
        ro = run(R)
    torch.cuda.synchronize()
    l_st = read_counts()
    rs = REF_STEREO_PTS["stereo"]
    room_summary("STEREO room without lines", ro, len(R["frames"]), rs, l_st,
                 smi)
    check(ro.n_tracked >= 14 and ro.ate_se3 < 0.05
          and ro.ate_se3 <= 2 * rs["ate_se3"],
          f"STEREO without lines over the room: {ro.n_tracked} >= 14 pairs "
          f"tracked, SE3 ATE {ro.ate_se3:.4f} m < 0.05 and <= 2x the "
          f"reference's {rs['ate_se3']:.4f}")
    check(all(l_st[k] > 0 for k in PATH_STEREO_PTS),
          f"every kernel of the STEREO room without lines launched "
          f"({', '.join(PATH_STEREO_PTS)})")
    tr = ro.system.tracker
    a, _ = run.rec["pose_opt_stereo"]
    args = (tr.K, tr.bf, *[x.contiguous() for x in a])
    report["pose_lm_stereo"] = pose_lm_report("pose_lm_stereo", args, False,
                                              smi)
    # -- RGB-D with bf 40
    step, R = rgbd_room(12, device=dev, bf=40.0)
    reset_counts()
    with torch.no_grad():
        rd = step(R)
    torch.cuda.synchronize()
    l_rgbd = read_counts()
    rr = REF_STEREO_PTS["rgbd"]
    room_summary("RGB-D room, bf 40", rd, len(R["frames"]), rr, l_rgbd, smi)
    check(rd.n_tracked >= 11 and rd.ate_se3 < 0.08
          and rd.ate_se3 <= 2 * rr["ate_se3"],
          f"RGB-D with bf 40 over the room: {rd.n_tracked} >= 11 frames "
          f"tracked, SE3 ATE {rd.ate_se3:.4f} m < 0.08 and <= 2x the "
          f"reference's {rr['ate_se3']:.4f}")
    check(rd.system.tracker.pose_opt_stereo is not None
          and all(l_rgbd[k] > 0 for k in PATH_RGBD_PTS),
          f"every kernel of the RGB-D room with bf 40 launched "
          f"({', '.join(PATH_RGBD_PTS)})")
    # -- the KB8 fisheye
    R = build_kb8_room(0, 30)
    run = Slice12Run(device=dev, cfg=kb8_config(seed=0))
    reset_counts()
    with torch.no_grad():
        rk = run(R)
    torch.cuda.synchronize()
    l_kb8 = read_counts()
    ref = REF_KB8
    room_summary("KB8 fisheye room, cfg.seed 0", rk, len(R["frames"]),
                 {k: v for k, v in ref.items() if k != "per_seed"}, l_kb8,
                 smi)
    check(rk.ate_sim3 < 0.06, f"the fisheye room (cfg.seed 0): Sim3 ATE "
          f"{rk.ate_sim3:.4f} m < 0.06 (tests/test_kb8_native.py's bound)")
    check(all(l_kb8[k] > 0 for k in PATH_KB8),
          f"every kernel of the fisheye room launched ({', '.join(PATH_KB8)})")
    slam = rk.system
    check_kb8_front(run, slam, report)
    a, _ = run.rec["pose_opt"]
    report["pose_lm_kb8"] = pose_lm_report(
        "pose_lm_kb8", (slam.tracker.kb8, *[x.contiguous() for x in a]),
        True, smi)
    check_kb8_ba(dev, report)
    runs = [rk]
    for seed in SPREAD_SEEDS:
        t0 = time.perf_counter()
        with torch.no_grad():
            o = SystemRun(device=dev, cfg=kb8_config(seed=seed))(R)
        torch.cuda.synchronize()
        print(f"  cfg.seed {seed}: tracked {o.n_tracked}, keyframes "
              f"{o.keyframes}, points {o.points}, maps {o.maps}, ATE "
              f"{o.ate_sim3:.4f} / {o.ate_se3:.4f} m "
              f"({time.perf_counter() - t0:.1f} s)")
        runs.append(o)
    worst = ref["ate_sim3_worst"]
    ates = [o.ate_sim3 for o in runs]
    check(max(ates) <= 2 * worst, f"the fisheye room's Sim3 ATE over "
          f"cfg.seed 0..4 {[round(x, 4) for x in ates]} m <= 2x the "
          f"reference's worst ({worst:.4f} m)")
    # The runs differ from the reference's by their RANSAC draws alone:
    # given the JAX package's draws, the port's CPU run of this room gives
    # the JAX run's frames tracked (26 of 30: tests/test_kb8_native.py's
    # >= 25), keyframes and points exactly (tests/test_torch_kb8.py,
    # slow).  With the port's own draws the frames before the two-view
    # bootstrap follow the draws, as the JAX package's own cfg.seed 0..4
    # track 26, 24, 24, 27, 27: the counts are held to that range.  A
    # handful of keyframes moves by one with the bootstrap's frame, so
    # that count has a floor of one.
    for k in ("n_tracked", "keyframes", "points"):
        check_band(f"the fisheye room's {k} over cfg.seed 0..4",
                   [getattr(o, k) for o in runs], *ref[k + "_range"],
                   slack=1 if k == "keyframes" else 0)
    return l_st, l_rgbd, l_kb8


# --------------------------------------------------------------------------
# Phase 17: slice 13, the KB8 fisheye with the IMU and lines, SLAM modes 1-3
# --------------------------------------------------------------------------

KB8_VI_SECONDS = 8.0
# kernel_digest.slice12_digests on the tree before slice 13 (its commit's
# `git archive`, PYTHONPATH at it, the script of this tree), on an H100
# 80GB HBM3 at 700 W: the pose LM, the KB8 modes and the KB8 window BA
SLICE12_DIGESTS = {
    "pose_lm stereo": "ed02638e8edd2fbac96ac65316b66072",
    "pose_lm kb8": "65a5001c4fbe39715cacc3c03939e23a",
    "undistort kb8": "05f373353876d10d2d1a1752e203ef41",
    "proj_match kb8 fuse": "c1a57da662ad85e7e150457e4dbff934",
    "proj_match kb8 tracker": "97b836f9a89b74b82828d957908b4f22",
    "local_ba kb8 perturbed": "63f130a01d6c95bfa6953536aa9948a5"}
# tests/test_torch_kb8_inertial.py's JAX System over the fisheye replay
# (8 s, IMU_MONOCULAR, loop closing on) with cfg.seed 0..9, without and
# with lines: per seed, then the ranges of the counts and the worst ATE
# (after global_refine); printed by `JAX_PLATFORMS=cpu PYTHONPATH=.:tests
# python3 tests/test_torch_kb8_inertial.py` (ten seeds: five undersample
# the spread, its N_SEEDS)
REF_KB8_VI = {
    "points_only": {
        "per_seed": [
            {"n_tracked": 122, "init_frame": 44, "imu_init_frame": 128,
             "imu_init_kf": 8, "keyframes": 24, "points": 3602, "lines": 0,
             "ate_sim3": 0.012668049906608227, "ate_se3": 0.0542862916898143,
             "calls": {"local_ba_kernel": 7, "_liba_window": 19, "liba_kernel":
             18, "full_inertial_ba": 1}},
            {"n_tracked": 122, "init_frame": 44, "imu_init_frame": 129,
             "imu_init_kf": 8, "keyframes": 24, "points": 3639, "lines": 0,
             "ate_sim3": 0.015280808954164653, "ate_se3": 0.06850578302334033,
             "calls": {"local_ba_kernel": 7, "_liba_window": 19, "liba_kernel":
             18, "full_inertial_ba": 1}},
            {"n_tracked": 122, "init_frame": 44, "imu_init_frame": 128,
             "imu_init_kf": 8, "keyframes": 24, "points": 3887, "lines": 0,
             "ate_sim3": 0.013886718484883211, "ate_se3": 0.06272685047447359,
             "calls": {"local_ba_kernel": 7, "_liba_window": 19, "liba_kernel":
             18, "full_inertial_ba": 1}},
            {"n_tracked": 131, "init_frame": 35, "imu_init_frame": 113,
             "imu_init_kf": 8, "keyframes": 37, "points": 5127, "lines": 0,
             "ate_sim3": 0.018667684318611072, "ate_se3": 0.0433945056769513,
             "calls": {"local_ba_kernel": 7, "_liba_window": 32, "liba_kernel":
             31, "full_inertial_ba": 1}},
            {"n_tracked": 122, "init_frame": 44, "imu_init_frame": 128,
             "imu_init_kf": 8, "keyframes": 24, "points": 3658, "lines": 0,
             "ate_sim3": 0.013819996560269946, "ate_se3": 0.06566557956719585,
             "calls": {"local_ba_kernel": 7, "_liba_window": 19, "liba_kernel":
             18, "full_inertial_ba": 1}},
            {"n_tracked": 131, "init_frame": 35, "imu_init_frame": 93,
             "imu_init_kf": 8, "keyframes": 37, "points": 4469, "lines": 0,
             "ate_sim3": 0.014879183370614214, "ate_se3": 0.02001221348693987,
             "calls": {"local_ba_kernel": 7, "_liba_window": 35, "liba_kernel":
             34, "full_inertial_ba": 1}},
            {"n_tracked": 123, "init_frame": 43, "imu_init_frame": 130,
             "imu_init_kf": 8, "keyframes": 24, "points": 3697, "lines": 0,
             "ate_sim3": 0.018015046334958217, "ate_se3": 0.018727671274355668,
             "calls": {"local_ba_kernel": 7, "_liba_window": 19, "liba_kernel":
             18, "full_inertial_ba": 1}},
            {"n_tracked": 126, "init_frame": 40, "imu_init_frame": 133,
             "imu_init_kf": 8, "keyframes": 20, "points": 2600, "lines": 0,
             "ate_sim3": 0.0458699869404857, "ate_se3": 0.2331275448788402,
             "calls": {"local_ba_kernel": 7, "_liba_window": 16, "liba_kernel":
             13, "full_inertial_ba": 1}},
            {"n_tracked": 131, "init_frame": 35, "imu_init_frame": 107,
             "imu_init_kf": 8, "keyframes": 37, "points": 5063, "lines": 0,
             "ate_sim3": 0.017491024330940633, "ate_se3": 0.019836437536573655,
             "calls": {"local_ba_kernel": 7, "_liba_window": 32, "liba_kernel":
             31, "full_inertial_ba": 1}},
            {"n_tracked": 131, "init_frame": 35, "imu_init_frame": 128,
             "imu_init_kf": 8, "keyframes": 25, "points": 3581, "lines": 0,
             "ate_sim3": 0.019843237659313687, "ate_se3": 0.11098564296132528,
             "calls": {"local_ba_kernel": 7, "_liba_window": 20, "liba_kernel":
             17, "full_inertial_ba": 1}}],
        "n_tracked_range": [122, 131],
        "keyframes_range": [20, 37],
        "points_range": [2600, 5127],
        "lines_range": [0, 0],
        "maps_range": [1, 1],
        "init_frame_range": [35, 44],
        "imu_init_frame_range": [93, 133],
        "imu_init_kf_range": [8, 8],
        "ate_sim3_worst": 0.0458699869404857,
        "ate_se3_worst": 0.2331275448788402},
    "lines": {
        "per_seed": [
            {"n_tracked": 5, "init_frame": 44, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 6, "points": 450, "lines": 0,
             "ate_sim3": 0.010918888445601434, "ate_se3": 0.7370680402867277,
             "calls": {"local_ba_kernel": 6}},
            {"n_tracked": 4, "init_frame": 44, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 451, "lines": 0,
             "ate_sim3": 0.01377281263123336, "ate_se3": 0.08803396717409405,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 5, "init_frame": 44, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 6, "points": 441, "lines": 0,
             "ate_sim3": 0.028445225637284518, "ate_se3": 0.7232003494519913,
             "calls": {"local_ba_kernel": 6}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 388, "lines": 0,
             "ate_sim3": 0.08941003738611362, "ate_se3": 0.13087463947628197,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 5, "init_frame": 44, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 6, "points": 453, "lines": 0,
             "ate_sim3": 0.11583021341661774, "ate_se3": 0.7151105639672496,
             "calls": {"local_ba_kernel": 6}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 4, "points": 364, "lines": 0,
             "ate_sim3": 0.0990778483167697, "ate_se3": 0.14704928849156532,
             "calls": {"local_ba_kernel": 4}},
            {"n_tracked": 4, "init_frame": 43, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 3, "points": 373, "lines": 0,
             "ate_sim3": 0.10156855090164102, "ate_se3": 0.10364529131212685,
             "calls": {"local_ba_kernel": 3}},
            {"n_tracked": 6, "init_frame": 40, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 291, "lines": 0,
             "ate_sim3": 0.14001716412804427, "ate_se3": 0.731024239551703,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 358, "lines": 0,
             "ate_sim3": 0.09233514658730642, "ate_se3": 0.09560600845311942,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 390, "lines": 0,
             "ate_sim3": 0.08720819399948572, "ate_se3": 0.1095640439380073,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 6, "points": 387, "lines": 0,
             "ate_sim3": 0.07388337449801065, "ate_se3": 0.07480874556753762,
             "calls": {"local_ba_kernel": 6}},
            {"n_tracked": 105, "init_frame": 35, "imu_init_frame": 67,
             "imu_init_kf": 8, "keyframes": 9, "points": 626, "lines": 0,
             "ate_sim3": 0.40559404530290244, "ate_se3": 0.9151829870794898,
             "calls": {"local_ba_kernel": 7, "_liba_window": 4,
             "full_inertial_ba": 1}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 4, "points": 369, "lines": 0,
             "ate_sim3": 0.10164790975203204, "ate_se3": 0.13840171838625334,
             "calls": {"local_ba_kernel": 4}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 4, "points": 381, "lines": 0,
             "ate_sim3": 0.10115761086327953, "ate_se3": 0.14513108417764048,
             "calls": {"local_ba_kernel": 4}},
            {"n_tracked": 126, "init_frame": 3, "imu_init_frame": 52,
             "imu_init_kf": 8, "keyframes": 13, "points": 632, "lines": 0,
             "ate_sim3": 0.6058779297021215, "ate_se3": 0.7988871246456322,
             "calls": {"local_ba_kernel": 7, "_liba_window": 42,
             "full_inertial_ba": 1}},
            {"n_tracked": 6, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 4, "points": 357, "lines": 0,
             "ate_sim3": 0.10653593543820854, "ate_se3": 0.11626479113426233,
             "calls": {"local_ba_kernel": 4}},
            {"n_tracked": 4, "init_frame": 43, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 3, "points": 374, "lines": 0,
             "ate_sim3": 0.09926746399159735, "ate_se3": 0.10019084596379944,
             "calls": {"local_ba_kernel": 3}},
            {"n_tracked": 7, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 380, "lines": 0,
             "ate_sim3": 0.10385427066363356, "ate_se3": 0.11180477379999418,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 4, "init_frame": 44, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 416, "lines": 0,
             "ate_sim3": 0.011814826308964065, "ate_se3": 0.08576943863573719,
             "calls": {"local_ba_kernel": 5}},
            {"n_tracked": 6, "init_frame": 35, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 5, "points": 379, "lines": 0,
             "ate_sim3": 0.08627916723447536, "ate_se3": 0.08711098055776158,
             "calls": {"local_ba_kernel": 5}}],
        "n_tracked_range": [4, 126],
        "keyframes_range": [3, 13],
        "points_range": [291, 632],
        "lines_range": [0, 0],
        "maps_range": [1, 1],
        "init_frame_range": [3, 44],
        "imu_init_frame_range": [-1, 67],
        "imu_init_kf_range": [-1, 8],
        "ate_sim3_worst": 0.6058779297021215,
        "ate_se3_worst": 0.9151829870794898}}
# tests/test_torch_line_modes.py's JAX System over the MH replay's frames
# (MONOCULAR with lines, loop closing on) under SLAM modes 1-3 with
# cfg.seed 0..9; printed by `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3
# tests/test_torch_line_modes.py`
REF_LINE_MODES = {
    "1": {
        "per_seed": [
            {"n_tracked": 159, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 39, "points": 4202, "lines": 277,
             "ate_sim3": 0.30980287079381386, "ate_se3": 1.4170167721319105,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 27}},
            {"n_tracked": 157, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 43, "points": 5170, "lines": 309,
             "ate_sim3": 0.2990468801353229, "ate_se3": 1.4570920837321706,
             "calls": {"local_ba_kernel": 17, "local_ba_lines_kernel": 32}},
            {"n_tracked": 161, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 41, "points": 4733, "lines": 267,
             "ate_sim3": 0.2624394068436159, "ate_se3": 1.4726645545267647,
             "calls": {"local_ba_kernel": 15, "local_ba_lines_kernel": 31}},
            {"n_tracked": 152, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 40, "points": 4197, "lines": 249,
             "ate_sim3": 0.3144240720548059, "ate_se3": 1.6067240929902493,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 29}},
            {"n_tracked": 119, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 28, "points": 2540, "lines": 122,
             "ate_sim3": 0.2749101351989767, "ate_se3": 0.8636552441673531,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 16}},
            {"n_tracked": 158, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 61, "points": 9181, "lines": 462,
             "ate_sim3": 0.28071408083075206, "ate_se3": 1.5304640828815903,
             "calls": {"local_ba_kernel": 20, "local_ba_lines_kernel": 48}},
            {"n_tracked": 139, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 41, "points": 6826, "lines": 316,
             "ate_sim3": 0.21525919703574178, "ate_se3": 1.1844300387641262,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 30}},
            {"n_tracked": 122, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 30, "points": 3235, "lines": 133,
             "ate_sim3": 0.4883362420975312, "ate_se3": 0.8781301472203036,
             "calls": {"local_ba_kernel": 17, "local_ba_lines_kernel": 18}},
            {"n_tracked": 157, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 38, "points": 3379, "lines": 196,
             "ate_sim3": 0.5014242066873397, "ate_se3": 1.5807231856523891,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 27}},
            {"n_tracked": 105, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 19, "points": 1577, "lines": 70,
             "ate_sim3": 0.4449085690276552, "ate_se3": 0.6052773346672053,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 9}}],
        "n_tracked_range": [105, 161],
        "keyframes_range": [19, 61],
        "points_range": [1577, 9181],
        "lines_range": [70, 462],
        "maps_range": [1, 1],
        "init_frame_range": [2, 2],
        "imu_init_frame_range": [-1, -1],
        "imu_init_kf_range": [-1, -1],
        "ate_sim3_worst": 0.5014242066873397,
        "ate_se3_worst": 1.6067240929902493},
    "2": {
        "per_seed": [
            {"n_tracked": 96, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 16, "points": 920, "lines": 51,
             "ate_sim3": 0.31495594976191355, "ate_se3": 0.5614266000673626,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 5}},
            {"n_tracked": 114, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 22, "points": 1370, "lines": 67,
             "ate_sim3": 0.6517456824382104, "ate_se3": 1.1498731599016263,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 9}},
            {"n_tracked": 90, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 12, "points": 1140, "lines": 31,
             "ate_sim3": 0.33491338128291376, "ate_se3": 0.4371673391583282,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 1}},
            {"n_tracked": 95, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 13, "points": 1136, "lines": 48,
             "ate_sim3": 0.2418120594660087, "ate_se3": 0.5595106624888513,
             "calls": {"local_ba_kernel": 18, "local_ba_lines_kernel": 3}},
            {"n_tracked": 101, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 19, "points": 1330, "lines": 56,
             "ate_sim3": 0.2766469767382269, "ate_se3": 0.7016797093631961,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 6}},
            {"n_tracked": 102, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 14, "points": 1118, "lines": 49,
             "ate_sim3": 0.2602139221521576, "ate_se3": 0.6135443208223079,
             "calls": {"local_ba_kernel": 18, "local_ba_lines_kernel": 4}},
            {"n_tracked": 104, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 18, "points": 1161, "lines": 48,
             "ate_sim3": 0.250963080659693, "ate_se3": 0.7440470594747542,
             "calls": {"local_ba_kernel": 15, "local_ba_lines_kernel": 8}},
            {"n_tracked": 122, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 22, "points": 1715, "lines": 68,
             "ate_sim3": 0.48846175140606, "ate_se3": 1.5134062311009195,
             "calls": {"local_ba_kernel": 18, "local_ba_lines_kernel": 10}},
            {"n_tracked": 94, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 18, "points": 1366, "lines": 61,
             "ate_sim3": 0.32472050952108017, "ate_se3": 0.5773863964041385,
             "calls": {"local_ba_kernel": 18, "local_ba_lines_kernel": 6}},
            {"n_tracked": 126, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 22, "points": 1812, "lines": 64,
             "ate_sim3": 0.4240145628771701, "ate_se3": 1.3145801485668667,
             "calls": {"local_ba_kernel": 20, "local_ba_lines_kernel": 8}}],
        "n_tracked_range": [90, 126],
        "keyframes_range": [12, 22],
        "points_range": [920, 1812],
        "lines_range": [31, 68],
        "maps_range": [1, 1],
        "init_frame_range": [2, 2],
        "imu_init_frame_range": [-1, -1],
        "imu_init_kf_range": [-1, -1],
        "ate_sim3_worst": 0.6517456824382104,
        "ate_se3_worst": 1.5134062311009195},
    "3": {
        "per_seed": [
            {"n_tracked": 159, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 35, "points": 3260, "lines": 192,
             "ate_sim3": 0.32883637092133927, "ate_se3": 1.5321771863054499,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 23}},
            {"n_tracked": 156, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 39, "points": 4106, "lines": 197,
             "ate_sim3": 0.24362623417522725, "ate_se3": 1.562896736132347,
             "calls": {"local_ba_kernel": 17, "local_ba_lines_kernel": 28}},
            {"n_tracked": 160, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 40, "points": 4256, "lines": 251,
             "ate_sim3": 0.3014494382402797, "ate_se3": 1.449385652564463,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 29}},
            {"n_tracked": 158, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 39, "points": 3719, "lines": 247,
             "ate_sim3": 0.33594507563939613, "ate_se3": 1.571365063870467,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 28}},
            {"n_tracked": 130, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 28, "points": 2606, "lines": 138,
             "ate_sim3": 0.1911682279478078, "ate_se3": 0.9276695667960568,
             "calls": {"local_ba_kernel": 18, "local_ba_lines_kernel": 16}},
            {"n_tracked": 118, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 23, "points": 1647, "lines": 93,
             "ate_sim3": 0.18642381773444325, "ate_se3": 0.7508619014454015,
             "calls": {"local_ba_kernel": 19, "local_ba_lines_kernel": 11}},
            {"n_tracked": 151, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 51, "points": 8859, "lines": 424,
             "ate_sim3": 0.4872430870085605, "ate_se3": 1.492475068890247,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 40}},
            {"n_tracked": 124, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 26, "points": 2695, "lines": 143,
             "ate_sim3": 0.2650825565338401, "ate_se3": 0.8688937876999064,
             "calls": {"local_ba_kernel": 17, "local_ba_lines_kernel": 15}},
            {"n_tracked": 109, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 24, "points": 2832, "lines": 115,
             "ate_sim3": 0.16163742398359526, "ate_se3": 0.5320852137690651,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 13}},
            {"n_tracked": 134, "init_frame": 2, "imu_init_frame": -1,
             "imu_init_kf": -1, "keyframes": 27, "points": 1506, "lines": 102,
             "ate_sim3": 0.5737027478676414, "ate_se3": 1.4128714115466572,
             "calls": {"local_ba_kernel": 16, "local_ba_lines_kernel": 17}}],
        "n_tracked_range": [109, 160],
        "keyframes_range": [23, 51],
        "points_range": [1506, 8859],
        "lines_range": [93, 424],
        "maps_range": [1, 1],
        "init_frame_range": [2, 2],
        "imu_init_frame_range": [-1, -1],
        "imu_init_kf_range": [-1, -1],
        "ate_sim3_worst": 0.5737027478676414,
        "ate_se3_worst": 1.571365063870467}}
PATH_KB8_VI = ("pyramid", "orb_fast_grid", "orb_describe", "undistort_kb8",
               "hamming_match", "rot_hist", "twoview_hypotheses",
               "twoview_recover", "proj_match_kb8", "pose_lm_kb8",
               "triangulate", "ba_linearize_kb8", "schur_solve", "imu_preint",
               "inertial_gs_lm", "vi_pose_lm", "ba_linearize_kb8_body",
               "inertial_chain", "schur_solve_global", "bow_transform")
# with lines the reference's tracker solves the pose with the pinhole
# point+line IRLS on the raw pixels and loses nearly every frame: no IMU
# init, and no line reaches the map (the KB8 renderer draws none)
PATH_KB8_VI_LINES = ("pyramid", "pyramid_line", "orb_fast_grid",
                     "orb_describe", "line_detect", "line_refine_lbd",
                     "undistort_kb8", "hamming_match", "rot_hist",
                     "twoview_hypotheses", "twoview_recover",
                     "proj_match_kb8", "pose_irls", "triangulate",
                     "ba_linearize_kb8", "schur_solve", "imu_preint",
                     "bow_transform")
# the keyframe mapping step of the KB8 camera (`entry.mapping_step(kb8=
# True)`): the KB8 point edge beside the line family
PATH_KB8_MAP = ("hamming_match", "rot_hist", "triangulate",
                "ba_linearize_kb8_lines", "schur_solve")
PATH_LINE_MODE = ("pyramid", "pyramid_line", "orb_fast_grid", "orb_describe",
                  "line_detect", "line_refine_lbd", "hamming_match",
                  "rot_hist", "twoview_hypotheses", "twoview_recover",
                  "line_triangulate", "proj_match", "pose_irls",
                  "pose_lm_line", "triangulate", "ba_linearize",
                  "ba_linearize_line_only", "schur_solve", "bow_transform")


class Slice13Run(SystemRun):
    """`SystemRun` whose System records the last arguments of the
    tracker's line-only and point+line pose solves and the last frame's
    raw keypoints and segments (the kernels' inputs on the main path)."""

    def new_system(self):
        slam = super().new_system()
        tr = slam.tracker
        self.rec = {}
        for name in ("pose_opt_line_only", "pose_opt_pl"):
            fn = getattr(tr, name, None)
            if fn is None:
                continue

            def rec(*a, _fn=fn, _name=name, **kw):
                self.rec[_name] = (a, kw)
                return _fn(*a, **kw)
            setattr(tr, name, rec)
        if slam.extract_lines is not None:
            lines = slam.extract_lines

            def lines_rec(img):
                lf = lines(img)
                self.rec["lines"] = lf
                return lf
            slam.extract_lines = lines_rec
        extract = slam.extract

        def extract_rec(img):
            f = extract(img)
            self.rec["feats"] = f
            return f
        slam.extract = extract_rec
        return slam


def check_slice12_digests():
    """The kernels that gained slice 13's modes give slice 12's bits on its
    calls (kernel_digest.slice12_digests)."""
    from plvio_tpu_torch import kernel_digest as KD
    got = dict(line.rsplit(" ", 1) for line in KD.slice12_digests(
        torch.device("cuda")))
    bad = [k for k, v in SLICE12_DIGESTS.items() if got.get(k) != v]
    check(not bad, "the pose LM's stereo and KB8 families and the KB8 modes "
          "of undistort, proj_match and the window BA give slice 12's "
          f"digests (differ: {bad})")


def window_report(name, got, wk, prob, st, ops):
    """A window BA mode's checks and report: one linearization of the
    kernel (`wk`, a _BAWork at the path's shape) against the plain
    engine's normal equations of the same terms (`prob` at the states
    `st`) within 1e-4 relative (`KN.linearization_against_plain`), then
    the whole BA by `KN.against_float64`'s rule (its result `got`).  The
    report's max_abs_err is the linearization's largest relative gap."""
    errs = KN.linearization_against_plain(wk, prob, st)
    worst = max(errs, key=errs.get)
    print(f"  {name}, one linearization against the plain engine, "
          "relative: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(errs[worst] <= 1e-4, f"{name}: pose blocks, g, Hpp, gp and the "
          f"couplings B within 1e-4 relative of the plain engine (worst "
          f"{worst} {errs[worst]:.2e})")
    print(f"  {name}, the whole BA: kernel {got['kernel']:.2e} / plain "
          f"float32 {got['plain']:.2e} from float64 (orders "
          f"{[f'{x:.2e}' for x in got['plain_orders']]}), kernel - plain "
          f"{got['kernel_plain']:.2e}")
    check(not got["failures"], f"{name}: the whole BA within 2x the plain "
          f"float32 runs' distance to float64 + 1e-6 (over "
          f"{len(got['plain_orders'])} observation orders), the same bits "
          f"on three launches {got['failures']}")
    t = wk.t
    nb = nbytes(t["poses"], t["pts"], t["lns"], t["obs_kf"], t["obs_pt"],
                t["obs_uv"], t["obs_is2"], t["lobs_kf"], t["lobs_ln"],
                t["lobs_eq"], t["lobs_is2"], t["lobs_dir"]) \
        + nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"], t["l_w"])
    return dict(**work(nb, ops), max_abs_err=errs[worst],
                ms=cuda_ms(lambda: wk.linearize(KN.BA_MODE_LINEARIZE)),
                plain_ms=cuda_ms(lambda: prob.build_normal_equations(st),
                                 reps=3, warmup=1), library_ms=None)


def check_slice13_kernels(dev, report):
    """The new modes on fixed windows at the paths' shapes (16 KF): the
    body-frame KB8 mode (the worst inertial bucket with lines and the
    half one without; the 64-KF window on schur_solve's global path), the
    KB8 point edge beside the line family, the line-only mode (1-3), each
    by `window_report` (one linearization against the plain engine, the
    whole BA by `KN.against_float64`'s rule) where it has the window's
    line family, by the whole BA's rule alone without it."""
    from plvio_tpu_torch.entry import K_EUROC
    from plvio_tpu_torch.inputs import (build_inertial_window,
                                        build_kb8_window, build_line_window,
                                        kb8_camera)
    K8 = kb8_camera()
    # -- the body-frame KB8 mode
    for lines, sz in ((True, LIBA_WORST), (False, LIBA_HALF)):
        A = build_inertial_window(**{**sz, **({} if lines else dict(
            n_ln=0, n_lobs=0))}, perturbed=True, device=dev, kb8=True)
        keys = KN.LIBA_KEYS if lines else KN.LIBA_KEYS[:18]
        Rcb, tcb = A["Rcb"].cpu(), A["tcb"].cpu()
        with torch.no_grad():
            got = KN.against_float64(
                lambda *a: KN.local_inertial_ba(K8, Rcb, tcb, GRAVITY, *a),
                lambda *a: KN.local_inertial_ba_plain(
                    K8, Rcb.to(a[0].dtype), tcb.to(a[0].dtype), GRAVITY, *a),
                [A[k] for k in keys], (0, 1, 2, 3),
                rows=KN.LIBA_ROWS if lines else KN.LIBA_ROWS[:1])
        if lines:
            args = [A[k] for k in KN.LIBA_KEYS]
            wk = KN.inertial_work(K8, Rcb, tcb, GRAVITY, *args)
            wk.chain(KN.CHAIN_COST_STATE)
            prob = KN._liba_problem(
                K8, A["Rcb"], A["tcb"], GRAVITY, 16, sz["n_pt"], sz["n_ln"],
                (args[8].long(), args[9].long(), args[10], args[12]),
                args[11], (args[20].long(), args[21].long(), args[22]),
                args[23], (args[13], args[14], args[15], args[16],
                           args[17]))
            prob.terms = [t for t in prob.terms
                          if t.name in ("reproj", "line")]
            st = {"pose": args[0], "vel": args[1], "bg": args[2],
                  "ba": args[3], "pt": args[6], "ln": args[18]}
            # per point row: the lens and its Jacobian (~150), the body
            # rows and the blocks (~450); per line row ~1200
            report["ba_linearize_kb8_body"] = window_report(
                "ba_linearize body-frame KB8, 16 KF worst bucket with lines",
                got, wk, prob, st, 600 * sz["n_obs"] + 1200 * sz["n_lobs"])
        else:
            print(f"  ba_linearize body-frame KB8, half bucket without lines: "
                  f"kernel {got['kernel']:.2e} / plain {got['plain']:.2e} "
                  "from float64")
            check(not got["failures"], "ba_linearize body-frame KB8 without "
                  f"lines by the float64 rule {got['failures']}")
    r = KN.global_solve_against_float64("inertial", 64, dev, kb8=True)
    print(f"  body-frame KB8 at 64 KF (S = {r.S}): " + r.summary())
    check(not r.failures(), "the 64-KF inertial window with the KB8 lens on "
          f"schur_solve's global path by its float64 rule {r.failures()}")
    # -- the KB8 point edge beside the line family
    A = build_kb8_window(device=dev, n_ln=256, n_lobs=512)
    args = list(A.values())
    with torch.no_grad():
        got = KN.against_float64(
            lambda *a: KN.local_ba_pl(K8, *a),
            lambda *a: KN.local_ba_pl_plain(K8, *a), args, (0, 1, 2),
            rows=KN.BA_ROWS)
    wk = KN._BAWork(K8, *args, lam0=1e-4, early_tol=1e-2, cg_iters=w_cg(96))
    prob = KN._ba_problem(K8, 16, args[2].shape[0], 256, args[4].long(),
                          args[5].long(), args[6], args[7], args[8],
                          args[11].long(), args[12].long(), args[13],
                          args[14], args[15])
    st = {"pose": args[0], "pt": args[2], "ln": args[9]}
    report["ba_linearize_kb8_lines"] = window_report(
        "ba_linearize KB8 points + pinhole lines, 16 KF x 2048 points x 4096 "
        "obs + 256 lines x 512 obs", got, wk, prob, st,
        550 * args[4].shape[0] + 1000 * args[11].shape[0])
    # -- the line-only mode: each of its three edge sets (modes 1-3) on its
    # own; the report is mode 3's (both edges), with the largest
    # linearization gap of the three
    W = build_line_window(device=dev)
    wargs = list(W.values())
    reps = {}
    for mode in (1, 2, 3):
        with torch.no_grad():
            got = KN.against_float64(
                lambda *a: KN.local_ba_lines_only(K_EUROC, mode, *a),
                lambda *a: KN.local_ba_lines_only_plain(K_EUROC, mode, *a),
                wargs, (0, 1), rows=KN.LINES_ONLY_ROWS)
        wk = KN.lines_only_work(K_EUROC, mode, *wargs)
        prob = KN._lines_only_problem(
            K_EUROC, 16, 512, wargs[4].long(), wargs[5].long(), wargs[6],
            wargs[7], wargs[8], wargs[9], mode)
        st = {"pose": wargs[0], "ln": wargs[2]}
        # per observation: two projections and their rows (~300), the
        # endpoint rows (~250, modes 1 and 3), the angle row (~250, modes 2
        # and 3), the blocks (~700)
        ops = (1000 + 250 * (mode != 2) + 250 * (mode != 1)) \
            * wargs[4].shape[0]
        reps[mode] = window_report(
            f"ba_linearize line-only mode {mode}, 16 KF x 512 lines x 1024 "
            "obs", got, wk, prob, st, ops)
    report["ba_linearize_line_only"] = dict(
        reps[3], max_abs_err=max(r["max_abs_err"] for r in reps.values()))


def line_pose_lm_report(args, smi, what):
    """`pose_lm`'s line families on args (pose0, l_obs, dir_obs, Xs, Xe,
    valid, is2): each mode by `KN.line_pose_lm_against_float64`'s rule,
    then mode 3's report."""
    from plvio_tpu_torch.entry import K_EUROC
    for mode in (1, 2, 3):
        r = KN.line_pose_lm_against_float64(K_EUROC, mode, args)
        print(f"  pose_lm line mode {mode} on {what}: kernel "
              f"{r['kernel']:.2e} / plain float32 {r['plain']:.2e} from "
              f"float64, inliers {r['n']} / {r['n64']}")
        check(not r["failures"], f"pose_lm line mode {mode} on {what} as its "
              f"float64 run {r['failures']}")
    fk = lambda: KN.line_only_pose_lm(K_EUROC, 3, *args)  # noqa: E731
    fp = lambda: KN.line_only_pose_lm_plain(K_EUROC, 3, *args)  # noqa: E731
    Pk, Pp = fk(), fp()
    n, cap = int(args[5].sum()), args[5].shape[0]
    # per round: the cost at the start (~150 a row), per iteration the
    # rows (~500) and the candidate's cost, a 6x6 factor, the re-gate
    ops = 3 * (n * 150 + 6 * (n * 650 + 400) + cap * 150)
    return dict(**work(nbytes(*args) + nbytes(*Pk), ops),
                max_abs_err=float((Pk[0] - Pp[0]).abs().max()),
                ms=cuda_ms(fk), plain_ms=cuda_ms(fp, reps=3, warmup=1),
                library_ms=None)


def replay_guards(what, runs, ref, ate_key):
    """Each run against the reference's runs of its regime (the pool: the
    runs without IMU init for one without it, those with it for one with
    it; a run whose regime the reference never reached fails): its frames
    tracked and IMU init frame within 10% of the pool's ranges, its
    keyframes within 10% (or one), its `ate_key` ATE within 2x the pool's
    worst.  Where every reference run initializes the keyframes are the
    final ones; where its runs mostly do not, a run with IMU init is held
    by the keyframes made when it initialized (`imu_init_kf`): the fisheye
    replay with lines, where the init is a rare event after which float32
    rounding parts the runs, the port with the reference's draws
    reproducing its frames tracked and init frame but not its final
    keyframes (tests/test_torch_kb8_inertial.py
    `test_kb8_vi_replay_with_reference_draws`)."""
    seeds = ref["per_seed"]
    for seed, o in enumerate(runs):
        init = o.imu_init_frame >= 0
        pool = [r for r in seeds if (r["imu_init_frame"] >= 0) == init]
        regime = f"{'with' if init else 'without'} IMU init"
        check(bool(pool), f"{what}, cfg.seed {seed}: a run {regime}, as "
              f"{len(pool)} of the reference's {len(seeds)}")
        kf_key = "imu_init_kf" if init and len(pool) < len(seeds) \
            else "keyframes"
        for key, slack in (("n_tracked", 0), ("imu_init_frame", 0),
                           (kf_key, 1)):
            if key == "imu_init_frame" and not init:
                continue
            v = getattr(o, key)
            lo, hi = (f(r[key] for r in pool) for f in (min, max))
            check(within(v, lo, hi, slack), f"{what}, cfg.seed {seed}: "
                  f"{key} {v} within 10% " + ("or one " if slack else "")
                  + f"of the reference's {lo}..{hi} over its {len(pool)} "
                  f"runs {regime}")
        worst = max(r[ate_key] for r in pool)
        v = getattr(o, ate_key)
        check(v <= 2 * worst, f"{what}, cfg.seed {seed}: {ate_key} {v:.4f} "
              f"m <= 2x the worst of the reference's {len(pool)} runs "
              f"{regime} ({worst:.4f} m)")


def replay_seeds(what, cfg_of, S, path, ref, ate_key, smi):
    """The replay S with cfg_of(seed) for cfg.seed 0..4, seed 0's run in a
    launch window of its own; the guards.  Returns (launches, seed 0's
    run, its recorder)."""
    runs = []
    for seed in range(5):
        run = Slice13Run(device=torch.device("cuda"), cfg=cfg_of(seed))
        if seed == 0:
            reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            o = run(S)
        torch.cuda.synchronize()
        if seed == 0:
            launches, rec0 = read_counts(), run.rec
        print(f"  {what}, cfg.seed {seed}: tracked {o.n_tracked} / "
              f"{len(S['frames'])}, bootstrap frame {o.init_frame}, IMU init "
              f"frame {o.imu_init_frame}, keyframes {o.keyframes}, points "
              f"{o.points}, lines {o.lines}, maps {o.maps}, ATE "
              f"{o.ate_sim3:.4f} / {o.ate_se3:.4f} m "
              f"({time.perf_counter() - t0:.1f} s)")
        runs.append(o)
    stereo_frames_summary(runs[0], smi)
    print(f"  launches (cfg.seed 0): {launches}")
    check(all(launches[k] > 0 for k in path),
          f"{what}: every kernel of the path launched ({', '.join(path)})")
    replay_guards(what, runs, ref, ate_key)
    return launches, runs[0], rec0


def run_slice13(dev, smi, render, S, report):
    """Phase 17 (see the module docstring).  Returns the launches of the
    fisheye replay without and with lines and of the three line modes'
    replays (cfg.seed 0), each counted in a window of its own."""
    from plvio_tpu_torch.entry import kb8_vi_config, line_mode_config
    from plvio_tpu_torch.inputs import build_kb8_vi_replay
    print("[17] slice 13: the KB8 fisheye with the IMU and lines, SLAM "
          "modes 1-3")
    check_slice12_digests()
    check_slice13_kernels(dev, report)
    out = {}
    ms, A = mapping_step(**MAPPING_WORST, device=dev, kb8=True)
    reset_counts()
    with torch.no_grad():
        mo = ms(A)
    torch.cuda.synchronize()
    out["kb8_map"] = read_counts()
    n_obs, n_lobs = A["obs_kf"].shape[0], A["lobs_kf"].shape[0]
    print(f"  the KB8 camera's mapping step (worst window): triangulated "
          f"{int(mo.n_good)}, inliers {int(mo.n_inliers)} / {n_obs} points, "
          f"{int(mo.n_inliers_l)} / {n_lobs} lines; launches "
          f"{out['kb8_map']}")
    dP = float((mo.kf_poses - A["kf_poses"]).abs().max())
    check(bool(torch.isfinite(mo.kf_poses).all()) and dP <= 1e-2
          and int(mo.n_inliers) >= 0.95 * n_obs
          and int(mo.n_inliers_l) >= 0.95 * n_lobs,
          f"the KB8 mapping step from the truth: KF poses finite and within "
          f"{dP:.2e} (<= 1e-2) of it, >= 95% of the point and line "
          "observations inliers")
    check(all(out["kb8_map"][k] > 0 for k in PATH_KB8_MAP),
          f"every kernel of the KB8 mapping step launched "
          f"({', '.join(PATH_KB8_MAP)})")
    waited = render.wait(2)
    check(waited is not None, f"the fisheye replay's {render.n_kb8} frames "
          "rendered after the stereo pairs by the render process (waited "
          f"{waited} s)")
    K = build_kb8_vi_replay(KB8_VI_SECONDS,
                            frames=render.frames(3, render.n_kb8))
    out["kb8_vi"], _, _ = replay_seeds(
        "the fisheye replay with the IMU, no lines",
        lambda seed: kb8_vi_config(False, seed=seed), K, PATH_KB8_VI,
        REF_KB8_VI["points_only"], "ate_se3", smi)
    out["kb8_vi_lines"], o, rec = replay_seeds(
        "the fisheye replay with the IMU and lines",
        lambda seed: kb8_vi_config(True, seed=seed), K, PATH_KB8_VI_LINES,
        REF_KB8_VI["lines"], "ate_se3", smi)
    # undistort's KB8 mode on the run's last frame: its keypoints and
    # segments against the plain version
    cam = o.system.camera
    kp = rec["feats"].uv.contiguous()
    ep = rec["lines"].ep.contiguous()
    uk = CAM.undistort(cam, kp, ep)
    up = CAM.undistort_frame_plain(cam, kp, ep)
    # the padded segments' endpoints (+-1e9 px) undistort to NaN on both
    same_nan = all(torch.equal(torch.isnan(a), torch.isnan(b))
                   for a, b in zip(uk, up))
    du = max(float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
             for a, b in zip(uk[:2], up[:2]))
    n_nan = int(torch.isnan(uk[1]).any(-1).sum())
    check(same_nan and du <= 1e-4, f"undistort's KB8 mode on the fisheye "
          f"run's last frame ({kp.shape[0]} keypoints, {ep.shape[0]} "
          f"segments, {n_nan} of them NaN on both, the padding) within "
          f"{du:.2e} px of the plain version (<= 1e-4)")
    # pose_irls on the run's last point+line call: a KB8 frame's unmatched
    # line rows carry NaN line equations (the padding), which poison the
    # reference's normal equations (0 x NaN); the kernel as its plain
    # version: the same inliers, the pose within 1e-4 or NaN on both
    a, _ = rec["pose_opt_pl"]
    args = [x.contiguous() for x in a]
    K = o.system.tracker.K
    pk = KN.pose_irls(K, *args)
    pp = KN.pose_irls_plain(K, *args)
    nan_l = int(torch.isnan(args[5]).any(-1).sum())
    both_nan = bool(torch.isnan(pk[0]).all() and torch.isnan(pp[0]).all())
    dP = float((pk[0] - pp[0]).abs().max())
    check(int(pk[3]) == int(pp[3]) and (both_nan or dP <= 1e-4),
          f"pose_irls on the fisheye run's last point+line pose solve "
          f"({nan_l} line rows with NaN equations): {int(pk[3])} inliers as "
          f"the plain version's {int(pp[3])}, pose "
          + ("NaN on both" if both_nan else f"within {dP:.2e}"))
    Sm = dict(S, imu=[None] * len(S["frames"]))
    line_rec = None
    for mode in (1, 2, 3):
        out[f"line_mode_{mode}"], o, rec = replay_seeds(
            f"SLAM mode {mode} over the MH replay",
            lambda seed, m=mode: line_mode_config(m, seed=seed), Sm,
            PATH_LINE_MODE, REF_LINE_MODES[str(mode)], "ate_sim3", smi)
        if mode == 3:
            line_rec = rec
    check("pose_opt_line_only" in line_rec, "SLAM mode 3's replay ran the "
          "line-only pose solve")
    a, _ = line_rec["pose_opt_line_only"]
    args = [x.contiguous() for x in a]
    report["pose_lm_line"] = line_pose_lm_report(
        args, smi, "SLAM mode 3's last line-only pose solve")
    from plvio_tpu_torch.inputs import build_line_pose_case
    line_pose_lm_report(build_line_pose_case(device=dev)[0], smi,
                        "inputs.build_line_pose_case")
    return out


# tests/test_torch_prior_reloc.py's JAX System over the MH replay's frames
# (build_mh_replay(8.0, 7)) with the ED line detector (line.detector 1),
# IMU_MONOCULAR with lines, loop closing on, the prior-map relocalizer on
# inputs.build_prior_set's prior set, cfg.seed 0..9: each run's frames
# tracked, bootstrap / IMU init frames, keyframes (alive at the end, and
# made when the IMU initialized), points, lines, maps, ATE (Sim3, SE3) after
# global_refine, whether the relocalizer aligned, the keyframe (its n-th
# process_keyframe) at which it did, the keyframes it relocalized and their
# position RMSE against the truth in the prior world; the ranges and worst
# values; printed by
# JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_prior_reloc.py
# "room": tests/test_torch_lines_ed.py's JAX System over the STEREO room
# with lines under the ED detector (15 pairs), printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_lines_ed.py`
REF_ED = {
    "per_seed": [
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        61, "imu_init_kf": 13, "imu_initialized": True, "keyframes": 37,
        "points": 5460, "lines": 281, "maps": 1, "final_state": 2, "ate_sim3":
        0.09741257065896768, "ate_se3": 0.33129248160892516, "scale":
        0.8125304584086847, "aligned": True, "align_kf": 16, "n_relocalized":
        28, "reloc_err": 0.6676709933189315},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        58, "imu_init_kf": 12, "imu_initialized": True, "keyframes": 39,
        "points": 6254, "lines": 314, "maps": 1, "final_state": 2, "ate_sim3":
        0.16430504857473094, "ate_se3": 0.33658431761262964, "scale":
        1.161246789279312, "aligned": True, "align_kf": 14, "n_relocalized":
        33, "reloc_err": 0.6530010359809468},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        61, "imu_init_kf": 13, "imu_initialized": True, "keyframes": 33,
        "points": 4555, "lines": 258, "maps": 1, "final_state": 2, "ate_sim3":
        0.06129164917969541, "ate_se3": 0.2531142907036525, "scale":
        0.855689002700623, "aligned": True, "align_kf": 15, "n_relocalized":
        24, "reloc_err": 0.47861928219316524},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        58, "imu_init_kf": 12, "imu_initialized": True, "keyframes": 34,
        "points": 5071, "lines": 270, "maps": 1, "final_state": 2, "ate_sim3":
        0.1581927927949123, "ate_se3": 0.26414594991669704, "scale":
        1.1142602697437987, "aligned": True, "align_kf": 15, "n_relocalized":
        26, "reloc_err": 0.4706890681830813},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        61, "imu_init_kf": 13, "imu_initialized": True, "keyframes": 34,
        "points": 4867, "lines": 265, "maps": 1, "final_state": 2, "ate_sim3":
        0.09481400990886905, "ate_se3": 0.27332403539561784, "scale":
        0.8477712495625785, "aligned": True, "align_kf": 16, "n_relocalized":
        25, "reloc_err": 0.5326176781346608},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        58, "imu_init_kf": 12, "imu_initialized": True, "keyframes": 36,
        "points": 5593, "lines": 286, "maps": 1, "final_state": 2, "ate_sim3":
        0.1574244850561478, "ate_se3": 0.2723466254029953, "scale":
        1.1205583727680473, "aligned": True, "align_kf": 15, "n_relocalized":
        28, "reloc_err": 0.48628052687069584},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        61, "imu_init_kf": 13, "imu_initialized": True, "keyframes": 34,
        "points": 4684, "lines": 276, "maps": 1, "final_state": 2, "ate_sim3":
        0.062411057294690396, "ate_se3": 0.20377455298442482, "scale":
        0.8856979761290553, "aligned": True, "align_kf": 15, "n_relocalized":
        25, "reloc_err": 0.5478536241743911},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        58, "imu_init_kf": 12, "imu_initialized": True, "keyframes": 37,
        "points": 5489, "lines": 290, "maps": 1, "final_state": 2, "ate_sim3":
        0.07356260716586845, "ate_se3": 0.34813546901649983, "scale":
        1.196293842449894, "aligned": True, "align_kf": 15, "n_relocalized":
        27, "reloc_err": 0.7235062112304956},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        58, "imu_init_kf": 12, "imu_initialized": True, "keyframes": 39,
        "points": 6099, "lines": 312, "maps": 1, "final_state": 2, "ate_sim3":
        0.1599361919449843, "ate_se3": 0.38406374694602713, "scale":
        1.1939287999995603, "aligned": True, "align_kf": 14, "n_relocalized":
        32, "reloc_err": 0.7358604606552015},
        {"n_frames": 166, "n_tracked": 164, "init_frame": 2, "imu_init_frame":
        62, "imu_init_kf": 14, "imu_initialized": True, "keyframes": 39,
        "points": 5558, "lines": 309, "maps": 1, "final_state": 2, "ate_sim3":
        0.11819811258913034, "ate_se3": 0.4226506885633573, "scale":
        0.7593213903247075, "aligned": True, "align_kf": 16, "n_relocalized":
        30, "reloc_err": 0.8387748137288535},
    ],
    "n_tracked_range": [164, 164],
    "keyframes_range": [33, 39],
    "points_range": [4555, 6254],
    "lines_range": [258, 314],
    "maps_range": [1, 1],
    "init_frame_range": [2, 2],
    "imu_init_frame_range": [58, 62],
    "imu_init_kf_range": [12, 14],
    "ate_sim3_worst": 0.16430504857473094,
    "ate_se3_worst": 0.4226506885633573,
    "align_kf_range": [14, 16],
    "n_relocalized_range": [24, 33],
    "reloc_err_worst": 0.8387748137288535,
    "aligned": [True, True, True, True, True, True, True, True, True, True],
    "room":
        {"n_frames": 15, "n_tracked": 15, "keyframes": 3, "points": 1208,
        "lines": 5, "ate_sim3": 0.003401744671773378, "ate_se3":
        0.005684781796185705, "final_state": 2},
}
PATH_ED = tuple("line_detect_ed" if k == "line_detect" else k
                for k in PATH_SYSTEM) + ("bow_score", "hamming_matrix",
                                         "pnp_ransac", "mlpnp_refine")
PATH_ED_ROOM = tuple("line_detect_ed" if k == "line_detect" else k
                     for k in PATH_ROOM_STEREO)


def check_ed_kernels(S, report):
    """line_detect_ed against its plain version on the MH replay's frame 1
    at both levels of the line pyramid, stage by stage."""
    dev = torch.device("cuda")
    img = torch.from_numpy(S["frames"][1]).to(dev)
    levels = ((img, N_LINE - N_LINE // 4), (FE.line_level(img), N_LINE // 4))
    err, nb, ops = 0.0, 0, 0
    for lv, (im, n) in enumerate(levels):
        r = LN.ed_against_plain(im, n)
        k, p = r["kernel"], r["plain"]
        check(r["grads"] and r["mag"] and r["cells"],
              f"line_detect_ed level {lv}: bf16 gradients, magnitude and "
              "the cells' candidate anchors bit-equal to the plain version")
        print(f"  line_detect_ed level {lv}: {r['walks_differ']} of "
              f"{r['n_walks']} anchors' walks differ from the plain "
              f"version's; outputs bit-equal: {r['same']}; "
              f"{int(k[3].sum())} segments")
        check_segments(f"line_detect_ed level {lv}", k[0], k[3], p[0], p[3])
        rows = k[3] & p[3]
        if bool(rows.any()):
            err = max(err, float((k[0] - p[0])[rows].abs().max()))
        # the work this level's data needs: bf16 Scharr, magnitude and the
        # anchor test (~40 operations a pixel), the live walk steps (five
        # bilinear samples and the realignment, ~110 operations), the fits
        # (97 points x ~30), the overlap test (A x A x ~25) and the two
        # bitonic sorts (n log n (log n + 1) / 2 compares)
        gx, gy, mag, score = LN.ed_anchor_field(im)
        ax, ay, ts = LN.ed_cells(score)
        _, _, w = LN.ed_points(gx, gy, mag, ax, ay, ts > 0)
        A = ax.shape[0]
        steps = int(w.sum()) - int((ts > 0).sum())
        C = score.shape[0] // 8 * (score.shape[1] // 8)

        def sort_ops(n):
            lg = (n - 1).bit_length()
            return (1 << lg) * lg * (lg + 1) // 2
        ops += 40 * im.numel() + 110 * steps + 30 * 97 * A + 25 * A * A \
            + sort_ops(C) + sort_ops(A)
        nb += nbytes(im) + nbytes(k)
    report["line_detect_ed"] = dict(
        **work(nb, ops), max_abs_err=err,
        ms=cuda_ms(lambda: [LN.line_detect_ed(im, n) for im, n in levels]),
        plain_ms=cuda_ms(lambda: [LN.detect_lines_ed(im, n)
                                  for im, n in levels], reps=3, warmup=1),
        library_ms=None)


def run_slice14(dev, smi, S, report):
    """Phase 18 (see the module docstring).  Returns the launches of the
    ED replay (cfg.seed 0) and of the ED STEREO room, each counted in a
    window of its own."""
    import shutil
    import tempfile
    from plvio_tpu_torch.entry import ed_config, ed_stereo_room
    from plvio_tpu_torch.inputs import build_prior_set
    print("[18] slice 14: the ED line detector and the prior-map "
          "relocalizer through System")
    check_ed_kernels(S, report)
    ref = REF_ED
    prior_dir = tempfile.mkdtemp(prefix="prior_set_")
    try:
        t0 = time.perf_counter()
        Se = dict(S, prior=dict(build_prior_set(prior_dir), dir=prior_dir))
        print(f"  the prior set: {len(Se['prior']['frames'])} frames of the "
              f"replay's hall at the prior camera (640x480) rendered in "
              f"{time.perf_counter() - t0:.1f} s")
        runs, launches = [], None
        for seed in range(5):
            run = SystemRun(device=dev, cfg=ed_config(prior_dir, seed=seed))
            if seed == 0:
                reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                o = run(Se)
            torch.cuda.synchronize()
            if seed == 0:
                launches = read_counts()
            print(f"  the ED replay, cfg.seed {seed}: tracked {o.n_tracked} "
                  f"/ {len(Se['frames'])}, IMU init frame "
                  f"{o.imu_init_frame}, keyframes {o.keyframes}, points "
                  f"{o.points}, lines {o.lines}, ATE {o.ate_sim3:.4f} / "
                  f"{o.ate_se3:.4f} m; the prior map aligned "
                  f"{o.prior_aligned} at keyframe {o.prior_align_kf}, "
                  f"{o.prior_n} keyframes relocalized at "
                  f"{o.prior_err:.4f} m RMSE "
                  f"({time.perf_counter() - t0:.1f} s)")
            runs.append(o)
        o0 = runs[0]
        stereo_frames_summary(o0, smi)
        st = o0.metrics.get("prior_reloc", {})
        print(f"  the relocalizer's stage (prior_reloc): {json.dumps(st)}; "
              f"its attempts {o0.system.relocalizer.attempts[-1:]}")
        print(f"  launches (cfg.seed 0): {launches}")
        check(all(launches[k] > 0 for k in PATH_ED)
              and launches["line_detect"] == 0,
              f"the ED replay: every kernel of the path launched "
              f"({', '.join(PATH_ED)}), the cell detector line_detect never")
        replay_guards("the ED replay", runs, ref, "ate_se3")
        lo, hi = ref["align_kf_range"]
        pool = ref["aligned"]
        for seed, o in enumerate(runs):
            # aligned where every reference run aligns, not where none does
            check(o.prior_aligned if all(pool) else
                  (not o.prior_aligned if not any(pool) else True),
                  f"cfg.seed {seed}: the relocalizer aligned "
                  f"({o.prior_aligned}), as {sum(pool)} of the reference's "
                  f"{len(pool)} runs")
            if o.prior_aligned:
                check(lo - 1 <= o.prior_align_kf <= hi + 1,
                      f"cfg.seed {seed}: aligned at keyframe "
                      f"{o.prior_align_kf}, within the reference's {lo}..{hi}"
                      " +- 1")
                check(o.prior_err <= 2 * ref["reloc_err_worst"],
                      f"cfg.seed {seed}: the relocalized trajectory "
                      f"{o.prior_err:.4f} m from the truth in the prior world"
                      f" (<= 2x the reference's worst "
                      f"{ref['reloc_err_worst']:.4f})")
        # the relocalizer only observes: the same run without it tracks to
        # the same bits
        with torch.no_grad():
            off = SystemRun(device=dev, cfg=ed_config(None, seed=0))(Se)
        torch.cuda.synchronize()
        same = len(off.poses) == len(o0.poses) and all(
            (a is None and b is None) or (a is not None and b is not None
                                          and np.array_equal(a, b))
            for a, b in zip(o0.poses, off.poses))
        counts = [(x.n_tracked, x.keyframes, x.points, x.lines)
                  for x in (o0, off)]
        check(same and counts[0] == counts[1],
              f"cfg.seed 0 with the relocalizer off: every frame's pose "
              f"bit-equal to the run with it on, counts {counts[1]} as "
              f"{counts[0]}")
    finally:
        shutil.rmtree(prior_dir, ignore_errors=True)
    reset_counts()
    step, R = ed_stereo_room(15, device=dev)
    with torch.no_grad():
        ro = step(R)
    torch.cuda.synchronize()
    launches_room = read_counts()
    rs = ref["room"]
    print(f"  the STEREO room under the ED detector: tracked {ro.n_tracked} "
          f"/ {len(R['frames'])}, keyframes {ro.keyframes}, points "
          f"{ro.points}, lines {ro.lines}, ATE {ro.ate_sim3:.4f} / "
          f"{ro.ate_se3:.4f} m (the reference: {rs}); launches "
          f"{launches_room}")
    check(ro.n_tracked >= 14 and ro.ate_se3 < 0.05
          and ro.ate_se3 <= 2 * rs["ate_se3"],
          f"STEREO with lines under the ED detector over the room: "
          f"{ro.n_tracked} >= 14 pairs tracked, SE3 ATE {ro.ate_se3:.4f} m "
          f"< 0.05 and <= 2x the reference's {rs['ate_se3']:.4f}")
    check(all(launches_room[k] > 0 for k in PATH_ED_ROOM),
          f"every kernel of the ED STEREO room launched "
          f"({', '.join(PATH_ED_ROOM)})")
    return [launches, launches_room]


# --------------------------------------------------------------------------
# Phase 19: the sharded back end (slice 15)
# --------------------------------------------------------------------------
# tests/test_torch_dist_liba.py's `reference_dist`: the JAX System with
# PLVIO_DIST=1 on a 2-device CPU mesh (XLA_FLAGS=
# --xla_force_host_platform_device_count=2) over the 8 s MH replay at
# cfg.seed 0..4, loop closing off (tests/test_torch_system.py's
# `reference_mh`): seed 0's run, each quantity's range and worst over the
# seeds, and each seed's counts; printed by
# `JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_dist_liba.py`
REF_DIST = {"n_frames": 166, "n_tracked": 164, "init_frame": 2,
    "imu_init_kf": 13, "imu_init_frame": 61, "keyframes": 39, "points": 5365,
    "lines": 213, "ate_se3": 0.40361323274281263,
    "ate_sim3": 0.11463203064981566, "scale": 0.7704989067403079,
    "gravity_err_deg": 1.374549727109277,
    "init_scale_err_worst": 0.505812534608407,
    "scale_err_worst": 0.5036590773544329,
    "gravity_err_deg_worst": 1.6856710140273785,
    "ate_sim3_worst": 0.13379597817799055, "ate_se3_worst": 0.8874444335182512,
    "reloc_centre_m_worst": 0.07937484006750314,
    "reloc_rot_deg_worst": 0.7211436361301167, "n_tracked_min": 164,
    "n_tracked_max": 164, "imu_init_frame_min": 58, "imu_init_frame_max": 61,
    "keyframes_min": 33, "keyframes_max": 42, "init_frame_min": 2,
    "init_frame_max": 2, "per_seed": [{"n_tracked": 164, "init_frame": 2,
    "imu_init_frame": 61, "imu_init_kf": 13, "keyframes": 39, "points": 5365,
    "lines": 213, "ate_se3": 0.40361323274281263,
    "ate_sim3": 0.11463203064981566}, {"n_tracked": 164, "init_frame": 2,
    "imu_init_frame": 58, "imu_init_kf": 12, "keyframes": 42, "points": 6068,
    "lines": 272, "ate_se3": 0.7929078624537308,
    "ate_sim3": 0.12746209651096296}, {"n_tracked": 164, "init_frame": 2,
    "imu_init_frame": 59, "imu_init_kf": 13, "keyframes": 33, "points": 4727,
    "lines": 189, "ate_se3": 0.0999189629579039,
    "ate_sim3": 0.046202271106297994}, {"n_tracked": 164, "init_frame": 2,
    "imu_init_frame": 58, "imu_init_kf": 12, "keyframes": 41, "points": 6400,
    "lines": 262, "ate_se3": 0.5071106880384272,
    "ate_sim3": 0.11710486326172481}, {"n_tracked": 164, "init_frame": 2,
    "imu_init_frame": 58, "imu_init_kf": 12, "keyframes": 42, "points": 5889,
    "lines": 274, "ate_se3": 0.8874444335182512,
    "ate_sim3": 0.13379597817799055}]}
PATH_DIST = PATH_SYSTEM + ("ba_linearize", "inertial_chain", "schur_reduce",
                           "schur_solve_reduced_cg")
# kernel_digest.window_digests on the tree before slice 15 (PR 14's, on the
# H100 with `PYTHONPATH=<that tree> python3 plvio_tpu_torch/
# kernel_digest.py window`): the single-device window BAs' existing
# entries of ba_linearize, schur_solve and inertial_chain keep their bits
# beside the new modes and entries
WINDOW_DIGESTS = {
    "mapping_step typical perturbed":
        "ffee42bd85ba709ff5f3ffbb53f13dd2",
    "inertial_ba_step worst perturbed=False":
        "0d04417e03d24acba24ab736cb8797b1",
    "inertial_ba_step worst perturbed=True":
        "818c7a613f019b9f2c46aa2149068fd3",
    "inertial_ba_step half perturbed=False":
        "47441b0135441193ee29c35bd49223de",
    "inertial_ba_step half perturbed=True":
        "7172a6fcf7e94e963a5bfe3920b5e93d",
    "local_ba pinhole points":
        "f0089d9e6cb04c42f015959d9673178f",
    "local_ba_lines_only mode=1":
        "d7c3328f9bca7a793ee9a5d1a5a60be9",
    "local_ba_lines_only mode=2":
        "c421f800f2ea623353454ca60fc8eba7",
    "local_ba_lines_only mode=3":
        "fe6af36818209809840b085db86a8848",
    "local_inertial_ba kb8 lines=False":
        "8b6507d7b6bc4b7f601af02629233313",
    "local_inertial_ba kb8 lines=True":
        "baa3cf9fc9265fab4ee42c6a6908a718",
    "local_ba_pl kb8":
        "fdb842c024a07f21501509d8fcf5793f"}


def _row_free(kf_free, kf_free_bias, body):
    """The free mask of a dense system's rows (csrc/schur_solve.cu
    `row_free`): pose and velocity rows by kf_free, bias rows by
    kf_free_bias; 6 pose rows a keyframe without the inertial states."""
    f = kf_free.to(torch.float32)
    if not body:
        return torch.repeat_interleave(f, 6)
    fb = kf_free_bias.to(torch.float32)
    return torch.cat([torch.repeat_interleave(f, 6),
                      torch.repeat_interleave(f, 3),
                      torch.repeat_interleave(fb, 3),
                      torch.repeat_interleave(fb, 3)])


def solve_only_work(n_kf: int, body: bool, kf_free, kf_free_bias, lam,
                    device):
    """A window's work with no landmarks and no observations, for
    schur_solve_reduced's solve of a given system alone (its free masks
    and damping from the arguments)."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    dev = torch.device(device)
    z = lambda *s, dt=f32: torch.zeros(*s, dtype=dt, device=dev)
    poses = torch.eye(3, 4, device=dev).repeat(n_kf, 1, 1).contiguous()
    inertial = None
    if body:
        n_e = n_kf - 1
        inertial = dict(kfx=z(n_kf, 9), kf_free_bias=kf_free_bias,
                        pre=z(n_e, 67), imu_info=z(n_e, 81),
                        edge_valid=z(n_e, dt=b8), rw_g=z(n_e), rw_a=z(n_e),
                        Rcb=torch.eye(3), tcb=torch.zeros(3), gravity=0.0)
    S = (15 if body else 6) * n_kf
    w = KN._BAWork(RES.PinholeK(1.0, 1.0, 0.0, 0.0), poses, kf_free,
                   z(0, 3), z(0, dt=b8), z(0, dt=i32), z(0, dt=i32), z(0, 2),
                   z(0, dt=b8), z(0), z(0, 6), z(0, dt=b8), z(0, dt=i32),
                   z(0, dt=i32), z(0, 3), z(0, dt=b8), z(0), lam0=lam,
                   early_tol=0.0, cg_iters=min(max(S // 2, 16), 128),
                   inertial=inertial)
    w.t["ctrl"][0] = lam
    return w


def reduced_solve_kernel(H, rhs, kf_free, kf_free_bias, lam: float,
                         raw: bool, chol: bool, body: bool):
    """schur_solve_reduced's solve alone of a given summed system (H, rhs)
    on the card: dx (against `KN.reduced_solve_plain`)."""
    n_kf = kf_free.shape[0]
    w = solve_only_work(n_kf, body, kf_free, kf_free_bias, lam, H.device)
    Hs, rs = KN._system_bufs(w, "hsum", "rsum")
    Hs.copy_(H)
    rs.copy_(rhs)
    kern = KN.SCHUR_SOLVE_REDUCED_CHOL if chol else KN.SCHUR_SOLVE_REDUCED_CG
    kern.launch(*w.args, None, None, 0, cuda.ptr(Hs), cuda.ptr(rs), 1,
                int(raw), int(chol), cuda.stream())
    return w.t["dx"].clone()


SOLVE_REL = 1e-2     # kernel - plain float32 dx, relative to max |dx64|


def reduced_solve_rule(name, H, rhs, kf_free, kf_free_bias, lam, raw, chol,
                       body):
    """schur_solve_reduced's solve of (H, rhs) on the card against its
    plain version: by `KN.against_float64` (the same bits on three
    launches), and the kernel's dx within SOLVE_REL x max |dx64| of the
    plain float32 solve of the same system.  The float64 rule's limit
    must lie below half of max |dx64|, so that a zero or halved dx fails
    it."""
    def kern(H_, r_, f_, fb_):
        return (reduced_solve_kernel(H_, r_, f_, fb_, lam, raw, chol, body),)

    def plain(H_, r_, f_, fb_):
        fr = _row_free(f_, fb_, body).to(H_.dtype)
        return (KN.reduced_solve_plain(H_, r_, fr, lam, raw, chol),)
    args = [H, rhs, kf_free, kf_free_bias]
    got = KN.against_float64(kern, plain, args, (0,))
    dx64 = plain(*[a.cpu().double() if a.is_floating_point() else a.cpu()
                   for a in args])[0]
    m64 = float(dx64.abs().max())
    limit = 2 * got["plain"] + 1e-6
    rel = got["kernel_plain"] / m64
    got.update(max_dx64=m64, limit=limit, rel_plain=rel)
    print(f"  schur_solve_reduced {name} (S = {H.shape[0]}): max |dx64| "
          f"{m64:.4e}; dx from float64 kernel {got['kernel']:.2e} / plain "
          f"float32 {got['plain']:.2e} (limit {limit:.2e}), kernel - plain "
          f"{got['kernel_plain']:.2e} ({rel:.2e} of max |dx64|)")
    check(not got["failures"], f"schur_solve_reduced {name}: within 2x the "
          f"plain float32 solve's distance to float64 + 1e-6, the same bits "
          f"on three launches {got['failures']}")
    check(limit < 0.5 * m64, f"schur_solve_reduced {name}: the float64 "
          f"rule's limit {limit:.2e} below half of max |dx64| {m64:.2e} (a "
          "zero or halved dx fails it)")
    check(rel <= SOLVE_REL, f"schur_solve_reduced {name}: dx within "
          f"{SOLVE_REL:g} x max |dx64| of the plain float32 solve of the "
          f"same system ({rel:.2e})")
    return got


def reduce_case(dev, big):
    """One LM step's shard partials of `entry.dist_window(2, big)`: the
    sharded data, its shard works after linearizing (lambda = 1e-4), per
    shard the plain partial's problem, states and masks, and the window
    (A)."""
    from plvio_tpu_torch.entry import dist_window
    from plvio_tpu_torch.parallel import dist_liba as DL
    step, Wa, A = dist_window(2, big=big, device=dev)
    runner = step.runner
    data, layout, _ = runner.prepare(**Wa)
    mesh = runner.mesh
    C, Pl = data.kf_pose_wb.shape[0], data.pt_xyz.shape[1]
    Ll, Lo = data.ln_ep.shape[1], data.lobs_kf.shape[1]
    works = DL.shard_works(K_EUROC, runner.Rcb, runner.tcb, GRAVITY, data,
                           mesh)
    sds = DL.local_shards(data, mesh)
    Rcb = torch.as_tensor(runner.Rcb, device=dev)
    tcb = torch.as_tensor(runner.tcb, device=dev)
    plains = []
    for i, (w, sd) in enumerate(zip(works, sds)):
        if i == 0:
            w.chain(KN.CHAIN_COST_STATE)
        w.linearize(KN.BA_MODE_INIT)
        w.linearize(KN.BA_MODE_LINEARIZE)
        if i == 0:
            w.chain(KN.CHAIN_LINEARIZE)
        prob = DL._problem(K_EUROC, Rcb, tcb, GRAVITY, C, Pl, Ll, Lo,
                           sd, sd["obs_valid"], sd["lobs_valid"])
        st = {"pose": sd["pose"], "vel": sd["vel"], "bg": sd["bg"],
              "ba": sd["ba"], "pt": sd["pt_xyz"], "ln": sd["ln_ep"]}
        free = ({"pose": sd["free"], "vel": sd["free"], "bg": sd["free_b"],
                 "ba": sd["free_b"]},
                {"pt": sd["pt_free"], "ln": sd["ln_free"]})
        plains.append((prob, st, free, sd))
    return dict(data=data, works=works, plains=plains, A=A)


def check_reduce(case, what, report=None):
    """schur_reduce on each shard against the plain partial (the engine's
    `reduce_system` of the shard's problem) within 1e-4 relative, the same
    bits on three launches.  Returns the shards' partials."""
    dev = torch.device("cuda")
    lam = torch.tensor(1e-4, device=dev)
    parts = []
    for i, (w, (prob, st, free, sd)) in enumerate(zip(case["works"],
                                                      case["plains"])):
        outs = [tuple(x.clone() for x in KN.schur_reduce(w))
                for _ in range(3)]
        same = all(torch.equal(o[0], outs[0][0])
                   and torch.equal(o[1], outs[0][1]) for o in outs[1:])
        lay, Hh, g, lm_sys, _, _ = prob.build_normal_equations(st)
        Hp, rp, _, _ = prob.reduce_system(lay, Hh, g, lm_sys, lam, *free)
        eh, er = rel_err(outs[0][0], Hp), rel_err(outs[0][1], rp)
        print(f"  schur_reduce {what}, shard {i} (S = {Hp.shape[0]}, "
              f"{int(sd['obs_valid'].sum())} point and "
              f"{int(sd['lobs_valid'].sum())} line observations): H "
              f"{eh:.2e}, rhs {er:.2e} relative to the plain partial")
        check(max(eh, er) <= 1e-4 and same,
              f"schur_reduce {what}, shard {i}: H and rhs within 1e-4 "
              "relative of the plain partial (damped by the shard's own "
              "diagonal, fixed rows frozen), the same bits on three "
              "launches")
        parts.append(outs[0])
        if report is not None and i == 0:
            t = w.t
            n_pt, n_ln = t["pts"].shape[0], t["lns"].shape[0]
            n_obs, n_lobs = t["obs_kf"].shape[0], t["lobs_kf"].shape[0]
            report["schur_reduce"] = dict(
                **work(nbytes(t["hcc"], t["hpt"], t["hln"], t["p_w"],
                              t["l_w"], t["link"], t["obs_kf"],
                              t["lobs_kf"])
                       + nbytes(outs[0], t["fpt"], t["fln"]),
                       300 * n_pt + 1500 * n_ln + 250 * n_obs
                       + 1000 * n_lobs
                       + gram_ops(t["obs_kf"][t["obs_valid"]],
                                  t["obs_pt"][t["obs_valid"]], n_pt, 3)
                       + gram_ops(t["lobs_kf"][t["lobs_valid"]],
                                  t["lobs_ln"][t["lobs_valid"]], n_ln, 6)),
                max_abs_err=max(eh, er), ms=cuda_ms(lambda: KN.schur_reduce(
                    w)),
                plain_ms=cuda_ms(lambda: prob.reduce_system(
                    lay, Hh, g, lm_sys, lam, *free), reps=5),
                library_ms=None)
    return parts


def gap64(a, b):
    return float((a.detach().double().cpu() - b.detach().double().cpu())
                 .abs().max())


def dist_against_single(dev, A):
    """The sharded window solve at D = 1, 2, 4 on the card against the
    single-device window solve by the float64 rule: each D's kernel
    within 2x the plain single-device float32 runs' largest distance to
    its float64 run + 1e-6 (plain runs over KN.FLOAT32_ORDERS observation
    orders, made once); D = 2 three times with the same bits."""
    from plvio_tpu_torch.entry import dist_window_solve, shard_mesh
    args = [{k: x.to(dev) for k, x in A[k].items()} if k == "pre_const"
            else A[k].to(dev) for k in KN.LIBA_KEYS]
    Rcb, tcb = A["Rcb"].cpu(), A["tcb"].cpu()

    def plain(*a):
        return KN.local_inertial_ba_plain(
            K_EUROC, Rcb.to(a[0].dtype), tcb.to(a[0].dtype), GRAVITY, *a)
    idx = (0, 1, 2, 3)
    a32 = KN._cpu(list(args))
    with torch.no_grad():
        p64 = plain(*KN._to64_cpu(list(args)))
        orders = []
        for o in range(KN.FLOAT32_ORDERS):
            a = list(a32)
            if o:
                for g, group in enumerate(KN.LIBA_ROWS):
                    perm = torch.from_numpy(np.random.default_rng(
                        [o, g]).permutation(a32[group[0]].shape[0]))
                    for i in group:
                        a[i] = a32[i][perm].contiguous()
            p = plain(*a)
            orders.append(max(gap64(p[i], p64[i]) for i in idx))
    res = {}
    for D in (1, 2, 4):
        fn = dist_window_solve(shard_mesh(D, dev))
        with torch.no_grad():
            ks = [fn(*args) for _ in range(3 if D == 2 else 1)]
        kern = max(gap64(ks[0][i], p64[i]) for i in idx)
        same = all(torch.equal(k[i], ks[0][i]) for k in ks[1:] for i in idx)
        res[D] = kern
        print(f"  make_dist_liba D = {D} on the card: states {kern:.2e} from "
              f"the single-device float64 run; the plain single-device "
              f"float32 runs {[f'{x:.2e}' for x in orders]}")
        check(kern <= 2 * max(orders) + 1e-6 and same,
              f"make_dist_liba D = {D}: within 2x the single-device plain "
              f"float32 runs' distance to float64 + 1e-6"
              + (", the same bits on three runs" if D == 2 else ""))
    return res, max(orders)


def _perm_rows(data, groups, seed, flat_D=None):
    """A NamedTuple problem with each shard's observations in another
    order: groups of fields permuted together along the observation axis
    (axis 1 of [D, O, ...]; with flat_D, blocks of O_total / D rows)."""
    g = np.random.default_rng(seed)
    out = data._asdict()
    for fields in groups:
        x0 = out[fields[0]]
        if flat_D:
            O = x0.shape[0] // flat_D
            perm = torch.cat([d * O + torch.from_numpy(g.permutation(O))
                              for d in range(flat_D)])
            for f in fields:
                out[f] = out[f][perm].contiguous()
        else:
            for d in range(x0.shape[0]):
                perm = torch.from_numpy(g.permutation(x0.shape[1]))
                for f in fields:
                    out[f][d] = out[f][d][perm].clone()
    return type(data)(**out)


def solver_rule(name, make, data, idx, groups, flat_D=None):
    """A sharded solver's kernel path (make(device, dtype) -> run) on a
    2-shard card mesh against its plain version on a 2-shard CPU mesh by
    the float64 rule (plain float32 runs over KN.FLOAT32_ORDERS
    observation orders), the same bits on three runs.  Returns the gap."""
    run_k = make("cuda", torch.float32)
    run_32 = make("cpu", torch.float32)
    run_64 = make("cpu", torch.float64)
    with torch.no_grad():
        ks = [run_k(data) for _ in range(3)]
        p64 = run_64(data)
        orders = []
        for o in range(KN.FLOAT32_ORDERS):
            d = data if o == 0 else _perm_rows(
                copy_data(data), groups, o, flat_D)
            p = run_32(d)
            orders.append(max(gap64(p[i], p64[i]) for i in idx))
    kern = max(gap64(ks[0][i], p64[i]) for i in idx)
    same = all(torch.equal(k[i], ks[0][i]) for k in ks[1:] for i in idx)
    print(f"  {name} D = 2 on the card: {kern:.2e} from the plain float64 "
          f"run; plain float32 {[f'{x:.2e}' for x in orders]}")
    check(kern <= 2 * max(orders) + 1e-6 and same,
          f"{name}: within 2x the plain float32 runs' distance to float64 + "
          "1e-6, the same bits on three runs")
    return kern


def copy_data(data):
    d = data._asdict()
    for k, v in d.items():
        d[k] = {a: b.clone() for a, b in v.items()} if isinstance(v, dict) \
            else v.clone()
    return type(data)(**d)


def two_process_check(dev):
    """The port's multi-process worker on the card: two processes sharing
    it over gloo (each a shard on cuda:0), their chain BA and sharded
    window solve bit-equal to the 2-shard mesh of this process."""
    import os
    import socket
    from plvio_tpu_torch.parallel import multihost as MH
    from plvio_tpu_torch.parallel.mesh import Mesh
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"  the card's compute mode: {mode}")
    if "Exclusive" in mode:
        print("  the two-process check runs on the CPU with gloo only: the "
              "card is in an exclusive compute mode")
        worker_dev, mesh_dev = "cpu", "cpu"
    else:
        worker_dev, mesh_dev = "cuda:0", dev
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    env = dict(os.environ, PLVIO_COORDINATOR=f"127.0.0.1:{port}",
               PLVIO_NUM_PROCS="2", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plvio_tpu_torch.parallel.multihost",
         "--device", worker_dev, "--backend", "gloo"],
        env=dict(env, PLVIO_PROC_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        check(False, "the two worker processes finished within 180 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and "MULTIHOST_OK" in out,
              f"worker process {r} ({worker_dev}, gloo) ran the chain BA and "
              f"the sharded window solve ({out.strip().splitlines()[-1]})")
    res = [json.loads([x for x in out.splitlines() if x.startswith(
        "MULTIHOST_RESULT = ")][-1].split(" = ", 1)[1]) for out in outs]
    mesh = Mesh([mesh_dev, mesh_dev])
    with torch.no_grad():
        poses, pts = MH.chain_case(mesh)
        dl = MH.dist_case(mesh)
    ok = True
    for r in range(2):
        ok &= MH._digest([poses[r:r + 1], pts[r:r + 1]]) == res[r]["chain"]
        ok &= MH._digest(list(dl[:4]) + [dl[4][r:r + 1], dl[5][r:r + 1]]) \
            == res[r]["dist"]
    check(ok, f"two processes ({worker_dev}, gloo): their chain BA and "
          f"sharded window solve bit-equal to this process's 2-shard mesh "
          f"({time.perf_counter() - t0:.1f} s)")


def dist_solve_times(dev, smi):
    """Wall and CUDA-event ms of one sharded window solve (C = 16, the
    worst bucket) at D = 1, 2, 4, beside the single-device window solve on
    the same bucket."""
    from plvio_tpu_torch.entry import dist_window, inertial_ba_step
    out = {}
    for D in (1, 2, 4):
        step, Wa, _ = dist_window(D, device=dev)
        with torch.no_grad():
            step(Wa)
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                step(Wa)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            dev_ms = cuda_ms(lambda: step(Wa), reps=5, warmup=1)
        out[D] = (float(np.median(walls)), dev_ms)
        print(f"  the sharded window solve, C = 16, D = {D}: wall "
              f"{out[D][0]:.2f} ms (median of 5), CUDA events "
              f"{out[D][1]:.2f} ms, 6 host reads (the six outputs), on {smi}")
    single, A = inertial_ba_step(**LIBA_WORST, perturbed=True, device=dev)
    with torch.no_grad():
        ms1 = cuda_ms(lambda: single(A), reps=5, warmup=1)
    print(f"  the single-device window solve on the same bucket: {ms1:.2f} "
          f"ms, on {smi}")


def dist_replay_run(dev, S, seed, loop_closing=False):
    from plvio_tpu_torch.entry import shard_mesh
    run = SystemRun(device=dev, seed=seed, use_loop_closing=loop_closing,
                    dist_mesh=shard_mesh(2, dev))
    t0 = time.perf_counter()
    with torch.no_grad():
        o = run(S)
    torch.cuda.synchronize()
    met = o.metrics
    n_dist = met.get("mapping/dist_solves", {}).get("calls", 0)
    dropped = met.get("mapping/dist_dropped_obs", {}).get("calls", 0)
    paths = sorted({c["path"] for c in o.system.mapper.ba_calls})
    print(f"  the dist replay, cfg.seed {seed}"
          + (", loop closing on" if loop_closing else "")
          + f": tracked {o.n_tracked} / {len(S['frames'])}, IMU init frame "
          f"{o.imu_init_frame}, keyframes {o.keyframes}, points {o.points}, "
          f"lines {o.lines}, ATE {o.ate_sim3:.4f} / {o.ate_se3:.4f} m; "
          f"{n_dist} window solves on the sharded path, {dropped} "
          f"observations dropped, window paths {paths} "
          f"({time.perf_counter() - t0:.1f} s)")
    ref = REF_MH
    print(f"    beside REF_MH (information): tracked {o.n_tracked} (its "
          f"{ref['n_tracked_min']}..), keyframes {o.keyframes} (its "
          f"{ref['keyframes_min']}..{ref['keyframes_max']}), SE3 ATE "
          f"{o.ate_se3:.4f} (its worst {ref['ate_se3_worst']:.4f})")
    check(n_dist >= 1 and not set(paths) - {"lba", "dist"},
          f"cfg.seed {seed}: {n_dist} >= 1 window solves on the sharded "
          f"path, no inertial window on the single-device kernel")
    return o


def run_slice15(dev, smi, S, report):
    """Phase 19 (see the module docstring).  Returns the launches of the
    dist replay (cfg.seed 0) and of dist_ba, chain_ba and chain_liba's
    runs, each counted in a window of its own."""
    from plvio_tpu_torch import kernel_digest as KD
    from plvio_tpu_torch.entry import shard_mesh
    from plvio_tpu_torch.inputs import (K_CHAIN, K_CHAIN_VI, K_DIST_BA,
                                        build_chain_ba_problem,
                                        build_chain_vi_problem,
                                        build_dist_ba_scene)
    from plvio_tpu_torch.parallel import chain_ba as CB
    from plvio_tpu_torch.parallel import chain_liba as CL
    from plvio_tpu_torch.parallel import dist_ba as DB
    print("[19] slice 15: the landmark-sharded inertial window BA under "
          "System's mapper on a shard mesh, dist_ba, chain_ba, chain_liba")
    t_phase = time.perf_counter()
    got = dict(line.rsplit(" ", 1) for line in KD.window_digests(dev))
    bad = [k for k, v in WINDOW_DIGESTS.items() if got.get(k) != v]
    check(not bad, "the single-device window BAs give the parent tree's "
          f"digests (kernel_digest.window_digests; differ: {bad})")
    # -- schur_reduce on both buckets' shards, schur_solve_reduced's CG
    for big, what in ((False, "C = 16"), (True, "C = 64")):
        case = reduce_case(dev, big)
        parts = check_reduce(case, what, None if big else report)
        H = parts[0][0] + parts[1][0]
        rhs = parts[0][1] + parts[1][1]
        d = case["data"]
        free = d.kf_free.to(dev)
        freeb = d.kf_free_bias.to(dev)
        g = reduced_solve_rule(f"CG, {what}", H, rhs, free, freeb, 1e-4,
                               False, False, True)
        KN.schur_solve_reduced(case["works"], parts)
        check(torch.equal(case["works"][0].t["dx"], g["out"][0]),
              f"schur_solve_reduced CG, {what}: the shards' partials summed "
              "in shard order and solved give the bits of the solve of "
              "their sum")
        if not big:
            Sd = H.shape[0]
            it = min(max(Sd // 2, 16), 128)
            report["schur_solve_reduced_cg"] = dict(
                **work(nbytes(parts) + nbytes(case["works"][0].t["dx"]),
                       # the sum, then per CG step the matrix-vector product
                       # and five vector updates
                       2 * Sd * Sd + it * (2 * Sd * Sd + 10 * Sd)),
                max_abs_err=g["kernel_plain"],
                ms=cuda_ms(lambda: KN.schur_solve_reduced(
                    case["works"], parts)),
                plain_ms=cuda_ms(lambda: KN.reduced_solve_plain(
                    H, rhs, _row_free(free, freeb, True), 1e-4, False,
                    False), reps=5),
                library_ms=None)
            case16 = case
    # -- the sharded window solve at D = 1, 2, 4 against the single-device
    dist_against_single(dev, case16["A"])
    # -- dist_ba: Cholesky at its S, then the solver by the float64 rule
    n_cams, n_pts = 4, 96
    scene = build_dist_ba_scene(np.random.default_rng(0), n_cams, n_pts)
    _, _, poses0, X0, okf, opt, ouv = scene
    _, _, opt_l, valid, (okf_b, ouv_b), (X0_b, free_b) = \
        DB.bucket_observations(2, n_pts, opt, (okf, ouv),
                               (X0, np.ones(n_pts, bool)))
    t_ = torch.from_numpy
    dba = DB.DistBAData(
        kf_poses=t_(poses0), kf_free=t_(np.arange(n_cams) > 0),
        pt_xyz=t_(X0_b), pt_free=t_(free_b),
        obs_kf=t_(okf_b.astype(np.int32)), obs_pt=t_(opt_l),
        obs_uv=t_(ouv_b), obs_valid=t_(valid),
        obs_is2=t_(np.ones(len(valid), np.float32)))
    mesh2 = shard_mesh(2, dev)
    works = DB.shard_works(K_DIST_BA, dba, mesh2, 1e-3)
    for w in works:
        w.linearize(KN.BA_MODE_LINEARIZE)
    parts = [tuple(x.clone() for x in KN.schur_reduce(w, raw=True))
             for w in works]
    Hb, rb = parts[0][0] + parts[1][0], parts[0][1] + parts[1][1]
    fcam = dba.kf_free.to(dev)
    g = reduced_solve_rule("Cholesky, dist_ba's", Hb, rb, fcam, fcam, 1e-3,
                           True, True, False)
    Sb = Hb.shape[0]
    fr = _row_free(fcam, fcam, False)
    Hd = (Hb + torch.diag(torch.diagonal(Hb) * 1e-3 + 1e-6)) \
        * fr[:, None] * fr[None, :] + torch.diag(1.0 - fr)

    def lib_chol():
        L = torch.linalg.cholesky(Hd)
        return torch.cholesky_solve((rb * fr)[:, None], L)
    report["schur_solve_reduced_chol"] = dict(
        **work(nbytes(parts) + nbytes(works[0].t["dx"]),
               2 * Sb * Sb + Sb ** 3 / 3 + 2 * Sb * Sb),
        max_abs_err=g["kernel_plain"],
        ms=cuda_ms(lambda: KN.schur_solve_reduced(works, parts, raw=True,
                                                  chol=True)),
        plain_ms=cuda_ms(lambda: KN.reduced_solve_plain(
            Hb, rb, fr, 1e-3, True, True), reps=5),
        library_ms=cuda_ms(lib_chol))
    print(f"  Cholesky at S = {Sb}: the kernel's solve "
          f"{report['schur_solve_reduced_chol']['ms']:.4f} ms (its sum and "
          f"back-substitutions included), one torch.linalg.cholesky + "
          f"cholesky_solve {report['schur_solve_reduced_chol']['library_ms']:.4f}"
          f" ms, on {smi}")
    launches = []

    def mk_db(device, dt):
        return DB.make_dist_ba(K_DIST_BA, shard_mesh(2, device), n_cams,
                               iters=12, dtype=dt)
    reset_counts()
    solver_rule("dist_ba", mk_db, dba, (0, 1),
                (("obs_kf", "obs_pt", "obs_uv", "obs_valid", "obs_is2"),),
                flat_D=2)
    launches.append(read_counts())
    chain = build_chain_ba_problem(np.random.default_rng(0), C=16)
    poses_gt, pts, ckf, cpt, cuv = chain
    rng = np.random.default_rng(1)
    c0 = poses_gt.copy()
    c0[1:, :, 3] += rng.normal(0, 0.03, (15, 3)).astype(np.float32)
    cdata, clay = CB.partition_chain(
        2, 2, np.arange(16), c0, ckf, cpt, cuv, np.ones(len(ckf), np.float32),
        pts + rng.normal(0, 0.03, pts.shape).astype(np.float32),
        fixed_kf=np.array([0]))

    def mk_cb(device, dt):
        return CB.make_chain_ba(K_CHAIN, shard_mesh(2, device), clay["Wh"],
                                cdata.pt_xyz.shape[1],
                                cdata.obs_kf.shape[1], outer_iters=6,
                                halo=2, dtype=dt)
    reset_counts()
    solver_rule("chain_ba", mk_cb, cdata, (0, 1),
                (("obs_kf", "obs_pt", "obs_uv", "obs_valid", "obs_is2"),))
    launches.append(read_counts())
    rng = np.random.default_rng(0)
    vp = build_chain_vi_problem(rng, n_kf=12, n_pts=200, n_lns=64)
    p0, v0 = vp[0].copy(), vp[1].copy()
    p0[1:, :, 3] += rng.normal(0, 0.02, (11, 3))
    v0[1:] += rng.normal(0, 0.03, (11, 3))
    z3 = np.zeros((12, 3), np.float32)
    vdata, vlay = CL.partition_chain_vi(
        2, 2, 12, p0, v0, z3, z3, vp[4], vp[5], vp[6],
        np.ones(len(vp[4]), np.float32), vp[2].copy(), *vp[10:],
        lobs_kf=vp[7], lobs_ln=vp[8], lobs_eq=vp[9], ln_ep=vp[3].copy(),
        fixed_pos=(0,), free_all_biases=False)

    def mk_cl(device, dt):
        return CL.make_chain_liba(
            K_CHAIN_VI, shard_mesh(2, device), vlay["Wh"],
            vdata.pt_xyz.shape[1], vdata.obs_kf.shape[1],
            vdata.ln_ep.shape[1], vdata.lobs_kf.shape[1],
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), GRAVITY,
            halo=2, outer_sweeps=3, iters=6, dtype=dt)
    reset_counts()
    solver_rule("chain_liba", mk_cl, vdata, (0, 1, 2, 3),
                (("obs_kf", "obs_pt", "obs_uv", "obs_valid", "obs_is2"),
                 ("lobs_kf", "lobs_ln", "lobs_eq", "lobs_valid")))
    launches.append(read_counts())
    # -- the two-process check
    two_process_check(dev)
    # -- times of one window solve at D = 1, 2, 4
    dist_solve_times(dev, smi)
    # -- System over the MH replay on a 2-shard mesh, cfg.seed 0..4
    runs = []
    for seed in range(5):
        if seed == 0:
            reset_counts()
        runs.append(dist_replay_run(dev, S, seed))
        if seed == 0:
            launches.append(read_counts())
            print(f"  launches (cfg.seed 0): {launches[-1]}")
    check(all(launches[-1][k] > 0 for k in PATH_DIST),
          f"the dist replay: every kernel of the path launched "
          f"({', '.join(PATH_DIST)})")
    replay_guards("the dist replay", runs, REF_DIST, "ate_se3")
    o = dist_replay_run(dev, S, 0, loop_closing=True)
    check(o.n_tracked >= 0.85 * len(S["frames"]),
          f"the dist replay with loop closing on: {o.n_tracked} frames "
          "tracked (>= 85%)")
    stereo_frames_summary(runs[0], smi)
    print(f"  phase 19: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = f"{smi} ({torch.cuda.get_device_name(0)}, torch "\
        f"{torch.__version__}, CUDA {torch.version.cuda})"
    print(smi)
    print(f"[1] card: {card}")
    render = start_render()
    try:
        return run_phases(dev, smi, render)
    finally:
        if render.proc.is_alive():
            render.proc.terminate()
        render.proc.join()
        for shm in render.shms:
            shm.close()
            shm.unlink()


class Render(NamedTuple):
    proc: object            # the render process
    done: list              # an Event per group of blocks, set once it is
                            # written: the circuit, the stereo pairs, the
                            # fisheye replay
    shms: list              # shared blocks: circuit, left views, right
                            # views, the fisheye replay's frames
    n_circuit: int          # the circuit's frames
    n_stereo: int           # the stereo replay's pairs
    n_kb8: int              # the fisheye replay's frames

    def frames(self, k: int, n: int) -> np.ndarray:
        """A copy of shared block k as n [H, W] float32 frames."""
        return np.array(np.ndarray((n, H, W), np.float32,
                                   buffer=self.shms[k].buf))

    def wait(self, k: int):
        """Wait for group k (0 the circuit, 1 the stereo pairs, 2 the
        fisheye replay); the seconds waited, rounded to 0.1, or None if
        the render process ended without writing it."""
        t0 = time.perf_counter()
        while not self.done[k].wait(1.0) and self.proc.is_alive():
            pass
        if not self.done[k].is_set():
            return None
        return round(time.perf_counter() - t0, 1)


def start_render() -> Render:
    """One process rendering into shared memory while phases 2-16 run,
    held to one thread on the host's last core at the lowest priority (a
    renderer on every core moves the CUDA-event times of the small
    kernels, PERF.md §6): first the 28 s circuit's frames (`inputs.
    render_mh_loop`, ~0.3 s a frame of one core), then the 8 s stereo
    replay's pairs (`inputs.render_stereo_replay`, ~1 s a pair), then the
    fisheye replay's frames (`inputs.render_kb8_vi_replay`, ~0.25 s a
    frame)."""
    import multiprocessing as mp
    import os
    from multiprocessing import shared_memory
    from plvio_tpu_torch.inputs import MH_LOOP_SECONDS, MH_SECONDS
    from plvio_tpu_torch.io import synthetic as syn
    n_c = len(np.arange(0.0, MH_LOOP_SECONDS, 1.0 / 20.0))
    n_s = len(syn.make_mh_trajectory(MH_SECONDS + 0.3, fps=20.0).timestamps)
    n_k = len(syn.make_mh_trajectory(KB8_VI_SECONDS + 0.3,
                                     fps=20.0).timestamps)
    shms = [shared_memory.SharedMemory(create=True, size=n * H * W * 4)
            for n in (n_c, n_s, n_s, n_k)]
    ctx = mp.get_context("spawn")
    done = [ctx.Event() for _ in range(3)]
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        proc = ctx.Process(target=_render, daemon=True, args=(
            done, [b.name for b in shms], n_c, n_s, n_k))
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return Render(proc, done, shms, n_c, n_s, n_k)


def _render(done, names, n_c, n_s, n_k):
    import os
    from multiprocessing import shared_memory
    os.nice(19)
    os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[-1]})
    try:
        import cv2
        cv2.setNumThreads(1)
    except ImportError:
        pass
    from plvio_tpu_torch.inputs import (render_kb8_vi_replay, render_mh_loop,
                                        render_stereo_replay)
    shms = [shared_memory.SharedMemory(name=nm) for nm in names]

    def block(k, n):
        return np.ndarray((n, H, W), np.float32, buffer=shms[k].buf)
    try:
        render_mh_loop(block(0, n_c))
        done[0].set()
        render_stereo_replay(block(1, n_s), block(2, n_s))
        done[1].set()
        render_kb8_vi_replay(block(3, n_k), KB8_VI_SECONDS)
        done[2].set()
    finally:
        for b in shms:
            b.close()


def run_phases(dev, smi, render):

    print("[2] build")
    t0 = time.perf_counter()
    msgs = cuda.build(sorted({k.name for k, _ in KERNELS.values()}),
                      ptxas_info=True)
    print(f"  built {len(msgs)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, msg in msgs.items():
        for line in msg.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3] kernels against their plain versions")
    (frames, poses, pt_xyz, pt_desc, pt_valid, ln_ep6, ln_desc, ln_valid,
     traj) = build_inputs(N_FRAMES, CAP_PTS, CAP_LNS, H, W,
                          n_features=N_FEAT, device=dev)
    st = from_numpy(dict(pt_xyz=pt_xyz, pt_desc=pt_desc, pt_valid=pt_valid,
                         ln_ep6=ln_ep6, ln_desc=ln_desc, ln_valid=ln_valid),
                    dev)
    map_args = (st["pt_xyz"], st["pt_desc"], st["pt_valid"], st["ln_ep6"],
                st["ln_desc"], st["ln_valid"])
    imgs = [torch.from_numpy(f).to(dev) for f in frames]
    print(f"  map: {int(pt_valid.sum())} points, {int(ln_valid.sum())} "
          "lines")
    gyro, acc, dts, carry0 = build_imu_windows(traj, N_FRAMES)
    carry0 = tuple(torch.from_numpy(a.copy()).to(dev) for a in carry0)
    windows = [tuple(torch.from_numpy(a[j]).to(dev) for a in (gyro, acc, dts))
               for j in range(N_FRAMES - 1)]
    step, _ = tracking_step_pl(H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE,
                               device=dev)
    vi, _ = tracking_step_vi(H, W, N_FEAT, CAP_PTS, N_LINE, device=dev)
    report = {}
    check_pl_kernels(imgs, poses, st, step, report)
    check_line_kernels(imgs[1], report)
    check_vi_kernels(vi, imgs[1], carry0, (imgs[1], *windows[0]), st, report)
    check_map_kernels(report)
    check_inertial_kernels(report)
    check_nbh_kernels(report)
    check_boot_kernels(imgs, step.orb, step.lines, report)
    check_global_kernels(report)
    check_pyramid_kernels(imgs, report)
    t0 = time.perf_counter()
    S = build_mh_replay()
    print(f"  the MH replay: {len(S['frames'])} frames rendered in "
          f"{time.perf_counter() - t0:.1f} s (on the host, in order)")
    check_system_kernels(S, report)

    print(f"[4] slice 1: {N_FRAMES} frames through tracking_step_pl, pose "
          "carried")
    pose0 = torch.from_numpy(poses[0]).to(dev)
    reset_counts()
    poses_k, inls = [], []
    pose = pose0
    with torch.no_grad():
        for img in imgs:
            pose, n = step(img, pose, *map_args)
            poses_k.append(pose)
            inls.append(n)
    torch.cuda.synchronize()
    launches_pl = read_counts()
    inls = [int(n) for n in inls]
    errs = [pose_err(P.cpu().numpy(), G) for P, G in zip(poses_k, poses)]
    print(f"  inliers per frame: {inls}")
    print("  camera-centre error mm: "
          f"{[round(e[0] * 1e3, 3) for e in errs]}")
    print(f"  rotation error deg: {[round(e[1], 4) for e in errs]}")
    print(f"  launches: {launches_pl}")
    check(all(bool(torch.isfinite(P).all()) for P in poses_k)
          and all(P.shape == (3, 4) for P in poses_k),
          "poses finite, [3,4]")
    check(min(inls) >= 80, f"every frame >= 80 inliers (min {min(inls)})")
    check(max(e[0] for e in errs) <= 0.010,
          f"camera centre within 10 mm (max "
          f"{max(e[0] for e in errs) * 1e3:.3f} mm)")
    check(max(e[1] for e in errs) <= 0.3,
          f"rotation within 0.3 deg (max {max(e[1] for e in errs):.4f})")
    check(all(launches_pl[k] > 0 for k in PATH_PL),
          f"every kernel of slice 1 launched ({', '.join(PATH_PL)})")
    plain_step, _ = tracking_step_pl(H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE,
                                     device=dev, plain=True)
    pose = pose0
    dmax = []
    with torch.no_grad():
        for img, Pk_ in zip(imgs, poses_k):
            pose, _ = plain_step(img, pose, *map_args)
            dmax.append(float((pose - Pk_).abs().max()))
    print(f"  plain path: largest pose difference per frame {dmax}")

    print(f"[5] slice 2: frames 1..{N_FRAMES - 1} through tracking_step_vi, "
          "carry (pose_wb, v, bg, ba, H15)")
    vi_plain, _ = tracking_step_vi(H, W, N_FEAT, CAP_PTS, N_LINE, device=dev,
                                   plain=True)

    def run_vi(stp):
        c, out = carry0, []
        with torch.no_grad():
            for i in range(1, N_FRAMES):
                c, (n, nl) = stp(c, (imgs[i], *windows[i - 1]), *map_args)
                out.append((c, n, nl))
        return out

    reset_counts()
    out_k = run_vi(vi)
    torch.cuda.synchronize()
    launches_vi = read_counts()
    inls = [int(n) for _, n, _ in out_k]
    lmat = [int(nl) for _, _, nl in out_k]
    pos = [float(np.linalg.norm(c[0][:, 3].cpu().numpy() - traj.p_wb[i]))
           for i, (c, _, _) in enumerate(out_k, start=1)]
    rot = [rot_deg(c[0][:, :3].cpu().numpy(), traj.R_wb[i])
           for i, (c, _, _) in enumerate(out_k, start=1)]
    h_fin = [bool(torch.isfinite(c[4]).all()) for c, _, _ in out_k]
    print(f"  inliers per frame: {inls}")
    print(f"  line matches per frame: {lmat}")
    print(f"  body position error mm: {[round(e * 1e3, 3) for e in pos]}")
    print(f"  rotation error deg: {[round(e, 4) for e in rot]}")
    print(f"  H15 finite per frame: {h_fin}")
    print(f"  launches: {launches_vi}")
    min_inl = math.ceil(0.9 * REF_VI["min_inliers"])
    max_pos = max(2 * REF_VI["max_pos_m"], 0.010)
    max_rot = max(2 * REF_VI["max_rot_deg"], 0.3)
    check(all(bool(torch.isfinite(c[0]).all() and torch.isfinite(c[1]).all())
              for c, _, _ in out_k), "poses and velocities finite")
    check(min(inls) >= min_inl, f"every frame >= {min_inl} inliers (90% of "
          f"the reference's {REF_VI['min_inliers']}; min {min(inls)})")
    check(max(pos) <= max_pos, f"body position within {max_pos * 1e3:.2f} "
          f"mm (max {max(pos) * 1e3:.3f} mm)")
    check(max(rot) <= max_rot, f"rotation within {max_rot:.3f} deg (max "
          f"{max(rot):.4f})")
    check(all(launches_vi[k] > 0 for k in PATH_VI),
          f"every kernel of slice 2 launched ({', '.join(PATH_VI)})")
    out_p = run_vi(vi_plain)
    dvi = [float((ck[0] - cp[0]).abs().max())
           for (ck, _, _), (cp, _, _) in zip(out_k, out_p)]
    inls_p = [int(n) for _, n, _ in out_p]
    print(f"  plain path: largest pose difference per frame {dvi}; inliers "
          f"{inls_p}")
    check(max(dvi) <= 1e-4, f"every frame's pose within 1e-4 of the plain "
          f"path (max {max(dvi):.2e})")
    check(all(abs(k - p) <= 0.01 * max(p, 1) for k, p in zip(inls, inls_p)),
          "every frame's inliers within 1% of the plain path")
    h_rel = [h15_gap(ck[4], cp[4])
             for (ck, _, _), (cp, _, _) in zip(out_k, out_p)]
    check(max(h_rel) <= 1e-3, "every frame's carried H15 within 1e-3 "
          f"relative Frobenius of the plain path, or non-finite on both "
          f"(max {max(h_rel):.2e})")

    print("[6] times")

    def run_pl(stp):
        def go():
            p = pose0
            with torch.no_grad():
                for img in imgs:
                    p, _ = stp(img, p, *map_args)
        return go

    ms_k = cuda_ms(run_pl(step), reps=3, warmup=1) / N_FRAMES
    ms_p = cuda_ms(run_pl(plain_step), reps=2, warmup=1) / N_FRAMES
    print(f"  tracking_step_pl: kernel path {ms_k:.3f} ms/frame, plain path "
          f"{ms_p:.3f} ms/frame, on {smi}")
    vk = cuda_ms(lambda: run_vi(vi), reps=3, warmup=1) / (N_FRAMES - 1)
    vp = cuda_ms(lambda: run_vi(vi_plain), reps=1, warmup=1) / (N_FRAMES - 1)
    print(f"  tracking_step_vi: kernel path {vk:.3f} ms/frame, plain path "
          f"{vp:.3f} ms/frame, on {smi}")

    launches_map = run_slice3(dev, step, imgs, pose0, map_args, smi)
    launches_liba = run_slice4(dev, smi)
    launches_nbh = run_slice5(dev, smi, report)
    launches_boot = run_slice6(dev, smi, report)
    launches_seq, seq_map = run_slice7(dev, smi)
    launches_track = run_slice8(dev, smi)
    launches_sys, launches_reloc = run_slice9(dev, smi, S)
    launches_loop, report_loop = run_slice10(dev, smi, seq_map, render)
    report.update(report_loop)
    launches_stereo = run_slice11(dev, smi, render, report)
    launches_s12 = run_slice12(dev, smi, report)
    launches_s13 = run_slice13(dev, smi, render, S, report)
    launches_s14 = run_slice14(dev, smi, S, report)
    launches_s15 = run_slice15(dev, smi, S, report)

    rows = []
    for name, (k, replaces) in [*KERNELS.items(),
                                (GLOBAL[0], (KN.SCHUR_SOLVE, GLOBAL[1])),
                                (GLOBAL_PG[0], (KN.POSE_GRAPH,
                                                GLOBAL_PG[1]))]:
        rep = report[name]
        lib = rep.get("library_ms")
        print(f"  {name}: {rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms,"
              f" bound {rep['bound_ms']:.6f} ms ({rep['bound_by']}: "
              f"{rep['bytes']} B, {rep['ops']} ops)"
              + ("" if lib is None else f", library {lib:.4f} ms")
              + f", on {smi}")
        rows.append(dict(name=name, route="cuda", source=k.source,
                         replaces=replaces,
                         launches=launches_pl[name] + launches_vi[name]
                         + launches_map[name] + launches_liba[name]
                         + launches_nbh[name] + launches_boot[name]
                         + launches_seq[name] + launches_track[name]
                         + launches_sys[name] + launches_reloc[name]
                         + sum(v[name] for v in launches_loop.values())
                         + sum(v[name] for v in launches_stereo)
                         + sum(v[name] for v in launches_s12)
                         + sum(v[name] for v in launches_s13.values())
                         + sum(v[name] for v in launches_s14)
                         + sum(v[name] for v in launches_s15),
                         max_abs_err=rep["max_abs_err"], ms=rep["ms"],
                         plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                         bound_by=rep["bound_by"],
                         library_ms=rep.get("library_ms")))
    for key, what in ((GLOBAL[0], "64 KF inertial window with lines"),
                      (GLOBAL[0] + "_128", "128 KF point-only window")):
        rep = report[key]
        n_seq = launches_seq[GLOBAL[0]] if key == GLOBAL[0] else 0
        print(f"  schur_solve global path, {what}: {rep['ms']:.4f} ms, plain "
              f"{rep['plain_ms']:.4f} ms, bound {rep['bound_ms']:.6f} ms "
              f"({rep['bound_by']}: {rep['bytes']} B, {rep['ops']} ops), "
              f"{n_seq} launches on the sequence, on {smi}")
    for name in ("ba_linearize", "schur_solve"):
        for cfg, what in (("inertial", "inertial window (15-DoF)"),
                          ("points", "point-only window (make_local_ba)")):
            rep = report[name][cfg]
            print(f"  {name}, {what}: {rep['ms']:.4f} ms, plain "
                  f"{rep['plain_ms']:.4f} ms, bound {rep['bound_ms']:.6f} ms "
                  f"({rep['bound_by']}: {rep['bytes']} B, {rep['ops']} ops), "
                  f"on {smi}")
    hm, ss = report["hamming_match"], report["schur_solve"]
    print(f"  hamming_match epipolar mode (1024 x 1024): {hm['epipolar_ms']:.4f}"
          f" ms, plain {hm['epipolar_plain_ms']:.4f} ms; line pair mode (256"
          f" x 256): {hm['pair_ms']:.4f} ms, plain {hm['pair_plain_ms']:.4f} "
          f"ms, on {smi}")
    pm = report["proj_match"]
    print(f"  proj_match tracker mode (2048 x 1000, frustum gates): "
          f"{pm['tracker_ms']:.4f} ms, plain {pm['tracker_plain_ms']:.4f} ms, "
          f"on {smi}")
    gw = ss["gram_work"]
    print(f"  schur_solve {ss['ms']:.4f} ms (its Gram fill-in included) "
          f"beside torch.mm of the fill-in alone {ss['gram_ms']:.4f} ms "
          f"(dense bound {gw['bound_ms']:.6f} ms, {gw['bound_by']}), on "
          f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
