"""The port's own configuration (copy of the fields of
plvio_tpu/config.py that the port reads, with the same defaults:
`ImuConfig`, reference src/Tracking.cc:1057, EuRoC.yaml:38-44; the
camera, `CameraConfig`; `SlamMode`; the local inertial BA window of
`TrackingConfig`; `OrbConfig`, `LineConfig`, `MapConfig`, `RelocConfig`;
and the `SystemConfig` fields that `System`, the tracker and the local
mapper read)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Tuple

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
    """The tracking fields the port reads (plvio_tpu/config.py:114-128)."""
    lba_window: int = 10             # LocalInertialBA Nd (Optimizer.cc:9185)
    min_matches_track: int = 15
    min_inliers_track: int = 10      # pose-opt inliers to keep OK state
    recently_lost_s: float = 5.0     # time_recently_lost (reference)
    kf_min_interval: int = 0         # frames; see _need_keyframe
    kf_max_interval: int = 20        # mMaxFrames defaults to fps


@dataclass(frozen=True)
class CameraConfig:
    """The camera fields the port reads (plvio_tpu/config.py:42-56, EuRoC
    cam0 defaults: pinhole, 752x480, rad-tan k1, k2, p1, p2; the rectified
    pair's baseline, bf = baseline * fx, 0 without a second view)."""
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
    baseline: float = 0.0           # metres
    th_depth: float = 35.0          # close / far stereo threshold (bf units)


@dataclass(frozen=True)
class OrbConfig:
    """The ORB extractor's settings (plvio_tpu/config.py:55-65)."""
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    max_raw_keypoints: int = 4096


@dataclass(frozen=True)
class LineConfig:
    """The line front end's settings (plvio_tpu/config.py:68-79)."""
    n_features: int = 200
    levels: int = 2
    scale: float = 2.0
    lsd_scale: float = 0.8
    detector: int = 0               # 0 = LSD-like, 1 = ED-like
    min_length_frac: float = 0.025
    max_raw_segments: int = 1024


@dataclass(frozen=True)
class MapConfig:
    """The map store's capacities (plvio_tpu/config.py:99-107)."""
    max_keyframes: int = 512
    max_points: int = 16384
    max_lines: int = 2048
    max_obs_per_frame: int = 1024
    max_line_obs_per_frame: int = 256
    max_maps: int = 8
    covis_threshold: int = 15


@dataclass(frozen=True)
class RelocConfig:
    """The prior-map relocalizer's settings (plvio_tpu/config.py:131-138)."""
    enabled: bool = False
    prior_data_dir: Optional[str] = None
    top_k: int = 3
    ratio: float = 0.75


@dataclass(frozen=True)
class SystemConfig:
    """The fields of plvio_tpu/config.py:SystemConfig (:141-159) that
    `System`, the tracker and the local mapper read, with the same
    defaults."""
    sensor: Sensor = Sensor.MONOCULAR
    slam_mode: SlamMode = SlamMode.POINT_LINE
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    line: LineConfig = field(default_factory=LineConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    map: MapConfig = field(default_factory=MapConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    reloc: RelocConfig = field(default_factory=RelocConfig)
    use_lines: bool = True
    use_loop_closing: bool = True
    seed: int = 0

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)
