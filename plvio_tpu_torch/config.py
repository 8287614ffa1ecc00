"""The port's own configuration (copy of the fields of
plvio_tpu/config.py:ImuConfig that `ops/imu.make_calib` reads, with the
same defaults; reference src/Tracking.cc:1057, EuRoC.yaml:38-44)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class ImuConfig:
    """IMU noise densities, rate, body-from-camera transform and gravity."""
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9393e-5
    acc_walk: float = 3.0e-3
    frequency: float = 200.0
    # 4x4 body-from-camera transform (Tbc), row-major
    Tbc: Tuple[float, ...] = (
        0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
        0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
        0.0, 0.0, 0.0, 1.0)
    gravity: float = 9.81

    def Tbc_matrix(self) -> np.ndarray:
        return np.asarray(self.Tbc, dtype=np.float64).reshape(4, 4)
