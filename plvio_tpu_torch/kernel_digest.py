"""SHA-256 digests of kernel outputs on fixed inputs, for showing that two
source trees give bit-identical results on one card.

    PYTHONPATH=<tree> python3 plvio_tpu_torch/kernel_digest.py

Run it once with PYTHONPATH at each tree (the script only uses entry
points both trees have) and compare the printed lines:

- `vi_pose_lm`: the VI pose optimizer on the case of
  tests/test_torch_cuda.py `test_vi_pose_lm_matches_plain` (1024 points,
  seed 7), with and without the prior: pose, velocity, biases, inliers
  and the next prior H15;
- `mapping_step`: the keyframe mapping step at the typical bucket from
  `inputs.perturb_window`'s start: KF poses, points, lines and both
  inlier masks;
- `hamming_match`: its window, line and epipolar gate modes (0-2) through
  `ops.matching.hamming_match` on fixed inputs (700 x 500, seed 4): idx
  and ok;
- `inertial_ba_step`: the inertial window BA at both buckets, true and
  perturbed start: the states, landmarks and inlier masks;
- `imu_init`: the IMU initialization and the scale refinement at 32 KF;
- `neighborhood_step`: the keyframe step's neighbourhood work on both maps
  of `inputs.build_keyframe_map`: the store's poses, points, lines and
  bindings after the step.

Needs one card; JAX is never imported.
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def vi_case(dev):
    from plvio_tpu_torch.config import ImuConfig
    from plvio_tpu_torch.entry import K_EUROC as K
    from plvio_tpu_torch.ops import imu as IMU
    from plvio_tpu_torch.utils import lie
    rng = np.random.default_rng(7)
    cap = 1024
    R0 = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3), dtype=torch.float32))
    p0 = torch.tensor(rng.normal(0, 1, 3), dtype=torch.float32)
    v0 = torch.tensor(rng.normal(0, 0.5, 3), dtype=torch.float32)
    prev = torch.cat([R0, p0[:, None]], 1)
    g = torch.tensor(rng.normal(0, 0.3, (10, 3)), dtype=torch.float32)
    a = torch.tensor(rng.normal(0, 0.5, (10, 3)), dtype=torch.float32) \
        + R0.T @ torch.tensor([0.0, 0.0, 9.81])
    f = IMU.imu_preint_plain(g, a, torch.full((10,), 0.005),
                             torch.ones(10, dtype=torch.bool),
                             IMU.make_calib(ImuConfig()), torch.zeros(3),
                             torch.zeros(3), prev, v0)
    R2, p2 = f.R2.double().numpy(), f.p2.double().numpy()
    Xc = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (cap, 3))
    X = torch.tensor(Xc @ R2.T + p2, dtype=torch.float32)
    uv = np.stack([K.fx * Xc[:, 0] / Xc[:, 2] + K.cx,
                   K.fy * Xc[:, 1] / Xc[:, 2] + K.cy], -1) \
        + rng.normal(0, 0.7, (cap, 2))
    uv[:150] += rng.uniform(-25, 25, (150, 2))
    Rp = R2 @ lie.so3_exp(torch.tensor(rng.normal(0, 0.01, 3))).numpy()
    pose0 = torch.tensor(np.c_[Rp, p2 + rng.normal(0, 0.02, 3)],
                         dtype=torch.float32)
    pre = f.pre
    pre_const = {k: getattr(pre, k) for k in ("dT", "dR", "dV", "dP", "JRg",
                                              "JVg", "JVa", "JPg", "JPa")}
    pre_const.update(bg0=pre.bias_gyro, ba0=pre.bias_acc)
    prior_const = dict(R0=R0, p0=p0, v0=v0, bg0=torch.zeros(3),
                       ba0=torch.zeros(3))
    rw = torch.tensor([1 / (1.9393e-5 ** 2 * 10)] * 3
                      + [1 / (3e-3 ** 2 * 10)] * 3)

    def d(x):
        if isinstance(x, dict):
            return {k: v.to(dev).contiguous() for k, v in x.items()}
        return x.to(dev).contiguous()

    return [K, d(torch.eye(3)), d(torch.zeros(3)), 9.81, d(pose0), d(f.v2),
            d(torch.full((3,), 1e-3)), d(torch.full((3,), 1e-2)),
            d(torch.tensor(uv, dtype=torch.float32)), d(X),
            d(torch.tensor(rng.random(cap) < 0.9)),
            d(torch.tensor(1 / 1.2 ** (2 * rng.integers(0, 3, cap)),
                           dtype=torch.float32)),
            d(prev), d(v0), d(pre_const), d(f.imu_info), d(rw),
            d(prior_const), d(torch.eye(15) * 100.0)]


def hamming_cases(dev):
    """(name, args, keywords) of hamming_match's modes 0-2 on fixed
    inputs: random two-bit descriptors (many ties), positions in a 120 px
    square, angles, and a fundamental matrix with per-column thresholds."""
    g = torch.Generator().manual_seed(4)
    n, m = 700, 500
    args = [(torch.randint(0, 4, (n, 8), generator=g) << 30).to(torch.int32),
            (torch.randint(0, 4, (m, 8), generator=g) << 30).to(torch.int32),
            torch.rand(n, generator=g) < 0.9, torch.rand(m, generator=g) < 0.9,
            torch.rand(n, 2, generator=g) * 120,
            torch.rand(m, 2, generator=g) * 120]
    args = [t.to(dev) for t in args]
    ang = [(torch.rand(k, generator=g) * 3.1415).to(dev) for k in (n, m)]
    F = torch.tensor([[0.0, -1e-3, 0.05], [1e-3, 0.0, -0.08],
                      [-0.05, 0.08, 1.0]], device=dev)
    th = (2.0 + torch.rand(m, generator=g) * 4).to(dev)
    return [("window", args, dict(radius=20.0, max_dist=80.0, ratio=0.9)),
            ("line", args, dict(radius=40.0, max_dist=110.0, ratio=0.95,
                                a_ang=ang[0], b_ang=ang[1], angle_tol=0.25)),
            ("epipolar", args, dict(radius=0.0, max_dist=60.0, ratio=0.8,
                                    epi_F=F, epi_th=th))]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device", file=sys.stderr)
        return 1
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    from plvio_tpu_torch.models import kernels as KN
    dev = torch.device("cuda")
    case = vi_case(dev)
    for hp in (True, False):
        print(f"vi_pose_lm have_prior={hp} "
              f"{digest(KN.vi_pose_lm(*case, hp))}")
    step, A = mapping_step(**MAPPING_TYPICAL, device=dev)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                  torch.from_numpy(X).to(dev))
    with torch.no_grad():
        o = step(A)
    print(f"mapping_step typical perturbed "
          f"{digest((o.kf_poses, o.pt_xyz, o.ln_ep6, o.inlier, o.inlier_l))}")
    from plvio_tpu_torch.ops import matching as M
    for name, args, kw in hamming_cases(dev):
        print(f"hamming_match {name} {digest(M.hamming_match(*args, **kw))}")
    from plvio_tpu_torch.entry import (LIBA_HALF, LIBA_WORST, imu_init,
                                       inertial_ba_step, neighborhood_step)
    for bucket, sz in (("worst", LIBA_WORST), ("half", LIBA_HALF)):
        for pert in (False, True):
            step, A = inertial_ba_step(**sz, perturbed=pert, device=dev)
            with torch.no_grad():
                o = step(A)
            print(f"inertial_ba_step {bucket} perturbed={pert} "
                  f"{digest([x for x in o if torch.is_tensor(x)])}")
    mod, B = imu_init(device=dev)
    print(f"imu_init {digest(mod(B))} refine {digest(mod.refine(B))}")
    for confirmed in (False, True):
        step, m = neighborhood_step(confirmed, device=dev)
        step(m)
        print(f"neighborhood_step confirmed_lines={confirmed} " + digest(
            [torch.from_numpy(getattr(m, k).copy()) for k in (
                "kf_pose_cw", "pt_xyz", "pt_valid", "kf_match_pt", "ln_ep",
                "ln_valid", "kf_match_ln")]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
