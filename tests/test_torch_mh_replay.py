"""Slice 9 on the card: the port's `System` over the 8 s MH replay at full
width (`entry.mh_replay`: 166 frames, the 9000-point / 500-line hall,
1000 ORB / 256 line features, production's store and caps, loop closing
off), held to tests/test_mh_replay_regression.py's bounds: IMU
initialized with |ba| < 0.5, one map, not LOST at the end, >= 85% of
frames tracked, >= 20 lines, and after `global_refine` ATE Sim3 < 0.6 m
and SE3 < 1.0 m; then relocalization on its final map within one frame
of the frames fed again (REF_MH in chip_smoke.py: the JAX System took
one, on every seed).

Marked `slow` and `cuda` (the replay renders ~80 s of frames on one CPU
core, then runs on the card); it imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_mh_replay.py
"""
import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.slow, pytest.mark.cuda]


def test_mh_replay_meets_regression_bounds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plvio_tpu_torch.entry import mh_replay, relocalization_case
    from plvio_tpu_torch.models.tracking import TrackState
    step, S = mh_replay(use_loop_closing=False)
    with torch.no_grad():
        out = step(S)
    n = len(out.frames)
    print(f"tracked {out.n_tracked}/{n}, IMU init at keyframe "
          f"{out.imu_init_kf}, |ba| {out.ba_norm:.3f}, lines {out.lines}, "
          f"ATE {out.ate_sim3:.4f} / {out.ate_se3:.4f} m")
    assert out.imu_initialized and out.ba_norm < 0.5
    assert out.maps == 1 and out.final_state != int(TrackState.LOST)
    assert out.n_tracked >= 0.85 * n
    assert out.lines >= 20
    assert out.ate_sim3 < 0.6 and out.ate_se3 < 1.0
    db = out.system.kfdb.db()
    np.testing.assert_array_equal(db.present,
                                  out.system.atlas.current.kf_valid)
    case = relocalization_case(out.system, S, out.poses)
    print(f"relocalization: {case}")
    assert case["frames"] == 1
