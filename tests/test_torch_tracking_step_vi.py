"""The port's production VI frame (plain versions, CPU) against
__graft_entry__._tracking_step_vi_fn on the same synthetic frames, map and
IMU windows, with the carry handed from frame to frame on each side.

At 240x376, 300 ORB features, 256 map points, 32 map lines, 64 line
features, 3 frames after frame 0.  Per frame: inliers within 3%, body
position within 2 mm and rotation within 0.05 deg of the reference,
velocity within 5 mm/s, the carried H15 within 1e-2 relative Frobenius
(float32 LM in both, summed in different orders; eigh pseudo-inverse).

At this size the reference's own carried H15 is indefinite after frame 1
(float32 cancellation in Hcc - Hpc^T Hpp^+ Hpc), its Cholesky whitening
is NaN from frame 2 on, and every later LM step is rejected: the frame
keeps its IMU prediction.  The port reproduces this, so H15 is compared
where the reference's is finite and must be NaN where it is not.

Run as a script, this file prints the JAX reference's guard that
chip_smoke.py holds the card's 15 VI frames to (`REF_VI`), from the
reference alone at full size (480x752, 16 frames):

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_tracking_step_vi.py
"""
import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as G
from plvio_tpu_torch.entry import tracking_step_vi
from plvio_tpu_torch.inputs import build_imu_windows, build_inputs
from plvio_tpu_torch.state import from_numpy

H, W, NF, CP, CL, NL, NFR = 240, 376, 300, 256, 32, 64, 4


def _inputs(n_frames, height, width, cap_pts, cap_lns, n_features):
    (frames, _, pxyz, pdesc, pvalid, lep, ldesc, lvalid,
     traj) = build_inputs(n_frames, cap_pts, cap_lns, height, width,
                          n_features=n_features, device="cpu")
    gyro, acc, dts, carry0 = build_imu_windows(traj, n_frames)
    jmap = [jnp.asarray(a) for a in (pxyz, pdesc, pvalid, lep, ldesc,
                                     lvalid)]
    st = from_numpy(dict(pt_xyz=pxyz, pt_desc=pdesc, pt_valid=pvalid,
                         ln_ep6=lep, ln_desc=ldesc, ln_valid=lvalid), "cpu")
    tmap = [st[k] for k in ("pt_xyz", "pt_desc", "pt_valid", "ln_ep6",
                            "ln_desc", "ln_valid")]
    return frames, (gyro, acc, dts), carry0, jmap, tmap, traj


@pytest.fixture(scope="module")
def inputs():
    return _inputs(NFR, H, W, CP, CL, NF)


def _run(inputs, n_frames, gravity=9.81):
    """Frames 1..n_frames through both steps, each carrying its own state."""
    frames, (gyro, acc, dts), carry0, jmap, tmap, _ = inputs
    fj = jax.jit(G._tracking_step_vi_fn(H, W, NF, CP, CL, NL,
                                        gravity=gravity))
    step, _ = tracking_step_vi(H, W, NF, CP, NL, gravity=gravity,
                               device="cpu")
    cj = tuple(jnp.asarray(a) for a in carry0)
    ct = tuple(torch.from_numpy(a.copy()) for a in carry0)
    out = []
    for i in range(1, n_frames + 1):
        xs = (frames[i], gyro[i - 1], acc[i - 1], dts[i - 1])
        cj, (nj, lj) = fj(cj, tuple(jnp.asarray(a) for a in xs), *jmap)
        with torch.no_grad():
            ct, (nt, lt) = step(ct, tuple(torch.from_numpy(a) for a in xs),
                                *tmap)
        out.append(([np.asarray(a) for a in cj], int(nj), int(lj),
                    [a.numpy() for a in ct], int(nt), int(lt)))
    return out


@pytest.fixture(scope="module")
def runs(inputs):
    return _run(inputs, NFR - 1), inputs[-1]


def _rot_deg(A, B):
    dR = np.asarray(A, np.float64) @ np.asarray(B, np.float64).T
    return math.degrees(math.acos(min(1.0, max(-1.0,
                                               (np.trace(dR) - 1) / 2))))


def _check_frame(i, cj, nj, lj, ct, nt, lt):
    assert nj >= 10, nj
    assert abs(nt - nj) <= 0.03 * nj, (i, nt, nj)
    assert lt == lj, (i, lt, lj)
    assert np.linalg.norm(ct[0][:, 3] - cj[0][:, 3]) <= 2e-3, i
    assert _rot_deg(ct[0][:, :3], cj[0][:, :3]) <= 0.05, i
    assert np.linalg.norm(ct[1] - cj[1]) <= 5e-3, i
    for a in (*ct[:4], *cj[:4]):
        assert np.all(np.isfinite(a))
    if np.all(np.isfinite(cj[4])):
        rel = np.linalg.norm(ct[4] - cj[4]) / np.linalg.norm(cj[4])
        assert rel <= 1e-2, (i, rel)
    else:
        assert not np.all(np.isfinite(ct[4])), i


def test_vi_frames_match_reference(runs):
    out, traj = runs
    print("inliers (port, JAX):", [(f[4], f[1]) for f in out])
    for i, frame in enumerate(out, start=1):
        _check_frame(i, *frame)
        # and the reference itself stays on the orbit
        assert np.linalg.norm(frame[0][0][:, 3] - traj.p_wb[i]) <= 0.01


def test_vi_frame_at_other_gravity(inputs):
    """The step's `gravity` reaches the IMU prediction as well as the
    inertial residual, as in the reference: frame 1 at g = 9.0 (the
    synthetic IMU measures 9.81, so the prediction is 0.04 m/s off)."""
    (frame,) = _run(inputs, 1, gravity=9.0)
    _check_frame(1, *frame)


def guard(ref_frames, traj):
    """chip_smoke.py's REF_VI from the reference's frames 1..n: the fewest
    inliers and the largest body position (m) and rotation (deg) errors
    against ground truth, with the per-frame values."""
    inl = [int(n) for _, n in ref_frames]
    pos = [float(np.linalg.norm(c[0][:, 3] - traj.p_wb[i]))
           for i, (c, _) in enumerate(ref_frames, start=1)]
    rot = [_rot_deg(c[0][:, :3], traj.R_wb[i])
           for i, (c, _) in enumerate(ref_frames, start=1)]
    vel = [float(np.linalg.norm(c[1] - traj.v_wb[i]))
           for i, (c, _) in enumerate(ref_frames, start=1)]
    return dict(min_inliers=min(inl), max_pos_m=max(pos),
                max_rot_deg=max(rot), inliers=inl, pos_m=pos, rot_deg=rot,
                vel_m_s=vel)


def test_reference_guard(runs):
    out, traj = runs
    g = guard([(cj, nj) for cj, nj, *_ in out], traj)
    assert g["min_inliers"] == min(nj for _, nj, *_ in out) >= 10
    assert 0 < g["max_pos_m"] <= 0.01 and 0 < g["max_rot_deg"] <= 0.3


def reference_vi_guard(n_frames=16, height=480, width=752, cap_pts=2048,
                       cap_lns=128, n_features=1000, n_line_feat=256):
    """The guard from _tracking_step_vi_fn alone, on the port's inputs."""
    frames, (gyro, acc, dts), carry0, jmap, _, traj = _inputs(
        n_frames, height, width, cap_pts, cap_lns, n_features)
    fj = jax.jit(G._tracking_step_vi_fn(height, width, n_features, cap_pts,
                                        cap_lns, n_line_feat))
    cj = tuple(jnp.asarray(a) for a in carry0)
    ref = []
    for i in range(1, n_frames):
        xs = (frames[i], gyro[i - 1], acc[i - 1], dts[i - 1])
        cj, (nj, _) = fj(cj, tuple(jnp.asarray(a) for a in xs), *jmap)
        ref.append(([np.asarray(a) for a in cj], int(nj)))
    return guard(ref, traj)


if __name__ == "__main__":
    print(json.dumps(reference_vi_guard()))
