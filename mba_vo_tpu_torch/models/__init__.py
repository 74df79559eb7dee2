"""Sensor and motion models: cameras (pinhole / unified / rad-tan
distortion) and continuous-time trajectory models with IMU synthesis."""

from .camera import (
    PinholeCamera,
    UnifiedCamera,
    RadTanDistortion,
    scale_intrinsics,
)
from .trajectory import (
    ImuParams,
    default_imu_params,
    sample_pose_velocity,
    sample_imu,
    sample_imu_sequence,
)
