"""The port's own configuration (copy of the fields of
plvio_tpu/config.py that the port reads, with the same defaults:
`ImuConfig`, reference src/Tracking.cc:1057, EuRoC.yaml:38-44; the
camera, `CameraConfig`; `SlamMode`; the local inertial BA window of
`TrackingConfig`; and the `SystemConfig` fields of the monocular
bootstrap and the local mapper)."""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
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


class Sensor(IntEnum):
    """Sensor modes (plvio_tpu/config.py:22-28)."""
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4


class SlamMode(IntEnum):
    """Point / line feature usage (plvio_tpu/config.py:31-38)."""
    POINT_LINE = 0
    LINE_ONLY_1 = 1
    LINE_ONLY_2 = 2
    LINE_ONLY_3 = 3


@dataclass(frozen=True)
class TrackingConfig:
    """The tracking field the port reads (plvio_tpu/config.py:114-128)."""
    lba_window: int = 10             # LocalInertialBA Nd (Optimizer.cc:9185)


@dataclass(frozen=True)
class CameraConfig:
    """The camera fields the port reads (plvio_tpu/config.py:42-52, EuRoC
    cam0 defaults: pinhole, 752x480, rad-tan k1, k2, p1, p2)."""
    model: str = "pinhole"
    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    dist: Tuple[float, ...] = (-0.28340811, 0.07395907, 0.00019359,
                               1.76187114e-05)
    fps: float = 20.0


@dataclass(frozen=True)
class SystemConfig:
    """The fields of plvio_tpu/config.py:SystemConfig (:155-170) that the
    monocular bootstrap and the local mapper read, with the same
    defaults."""
    sensor: Sensor = Sensor.MONOCULAR
    slam_mode: SlamMode = SlamMode.POINT_LINE
    camera: CameraConfig = field(default_factory=CameraConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    use_lines: bool = True
    seed: int = 0
