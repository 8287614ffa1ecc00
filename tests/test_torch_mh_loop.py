"""Slice 10 on the card: the port's `System` with its default
configuration (loop closing on) over the 28 s closed circuit of
scripts/run_mh_loop.py (`entry.mh_loop`: 560 frames, the 9000-point /
500-line hall, production's sizes), held to
tests/test_mh_loop_regression.py `test_mh_loop_single_map_survival`'s
bounds but for the map count: IMU initialized, not LOST at the end,
>= 85% of frames tracked, and no more maps than the JAX System's own run
of the circuit made (REF_LOOP in chip_smoke.py: two).

Marked `slow` and `cuda` (the circuit renders ~3 min of frames on one CPU
core, then runs on the card); it imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_mh_loop.py
"""
import pytest
import torch

pytestmark = [pytest.mark.slow, pytest.mark.cuda]

REF_MAPS = 2            # chip_smoke.py REF_LOOP["maps"]


def test_mh_loop_survives_the_circuit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plvio_tpu_torch.entry import mh_loop
    from plvio_tpu_torch.models.tracking import TrackState
    step, S = mh_loop()
    assert step.cfg.use_loop_closing
    with torch.no_grad():
        out = step(S)
    print(f"tracked {out.n_tracked}/{len(out.frames)}, maps {out.maps}, "
          f"keyframes {out.keyframes}, loops {out.loops}, merges "
          f"{out.merges}, verifications {out.verifications}, ATE "
          f"{out.ate_sim3:.3f} / {out.ate_se3:.3f} m")
    assert out.imu_initialized
    assert out.maps <= REF_MAPS
    assert out.final_state != int(TrackState.LOST)
    assert out.n_tracked >= 0.85 * len(out.frames)
