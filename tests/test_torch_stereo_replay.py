"""Slice 11 on the card: the port's `System.track_stereo` over the 8 s
stereo replay at full width (`entry.stereo_replay`: 166 rectified pairs of
the 9000-point / 500-line hall, IMU_STEREO with lines, 0.11 m baseline,
1000 ORB / 256 line features a view, production's store and caps, loop
closing on), held to REF_STEREO of chip_smoke.py (the JAX System's run on
the CPU): the depth bootstrap on the first pair, the IMU initialized, one
map, not LOST at the end; frames tracked, keyframes, points and lines
within 10% of the reference's; after `global_refine` the SE3 ATE within
2x the reference's.  Pairs 0..110, through the IMU initialization, are
held pair by pair to FED_STEREO (chip_smoke.check_fed_trace: the JAX
System fed the port's CPU features; keyframes equal, points, lines and
bound features within max(2, 1%)).

Marked `slow` and `cuda` (the replay renders ~170 s of pairs on one CPU
core, then runs on the card); it imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_stereo_replay.py
"""
import sys
from pathlib import Path

import pytest
import torch

pytestmark = [pytest.mark.slow, pytest.mark.cuda]


def test_stereo_replay_as_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import REF_STEREO as ref
    from chip_smoke import RecordingRun, check_fed_trace
    from plvio_tpu_torch.entry import stereo_replay
    from plvio_tpu_torch.models.tracking import TrackState
    step, S = stereo_replay()
    run = RecordingRun(device=step.device, cfg=step.cfg)
    with torch.no_grad():
        out = run(S)
    print(f"tracked {out.n_tracked}/{len(out.frames)}, keyframes "
          f"{out.keyframes}, points {out.points}, lines {out.lines}, IMU "
          f"init at frame {out.imu_init_frame}, ATE {out.ate_sim3:.4f} / "
          f"{out.ate_se3:.4f} m")
    assert out.init_frame == 0
    assert out.imu_initialized and out.maps == 1
    assert out.final_state != int(TrackState.LOST)
    for k in ("n_tracked", "keyframes", "points", "lines"):
        lo, hi = ref[k + "_range"]
        assert 0.9 * lo <= getattr(out, k) <= 1.1 * hi, k
    assert out.ate_se3 <= 2 * ref["ate_se3_worst"]
    check_fed_trace(run.per_pair)
