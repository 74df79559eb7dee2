"""Multi-sensor system: a camera/IMU registry with extrinsics, and a
per-camera frame container.

Counterpart of ``mba_vo_tpu/models/sensors.py``. The registry is host-side
bookkeeping (sensors are configuration); what the tracker computes with
(intrinsics, extrinsic poses, images) is tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..core.lie import quat_conjugate, quat_multiply, quat_rotate
from ..core.transform import Pose, pose_identity
from .trajectory import ImuParams


@dataclasses.dataclass
class CameraEntry:
    """One registered camera: a model of models.camera (or a raw [4]
    intrinsics tensor) and its body-to-sensor extrinsic pose."""

    camera: object
    T_b2s: Pose
    name: Optional[str] = None


@dataclasses.dataclass
class ImuEntry:
    params: ImuParams
    T_b2s: Pose
    name: Optional[str] = None


class SensorSystem:
    """id -> camera / IMU registry with paired cameras and name lookup."""

    def __init__(self):
        self._cameras: Dict[int, CameraEntry] = {}
        self._imus: Dict[int, ImuEntry] = {}
        self._paired: Dict[int, int] = {}
        self._name_to_id: Dict[str, int] = {}

    def add_camera(self, dev_id: int, camera, T_b2s: Optional[Pose] = None,
                   name: Optional[str] = None) -> None:
        if dev_id in self._cameras:
            raise ValueError(f"camera id {dev_id} already registered")
        self._cameras[dev_id] = CameraEntry(
            camera=camera, T_b2s=T_b2s if T_b2s is not None else pose_identity(torch.float32),
            name=name)
        if name is not None:
            self._name_to_id[name] = dev_id

    def add_paired_camera(self, ref_cam_id: int, overlapped_cam_id: int) -> None:
        """Register a stereo / overlap pairing."""
        for cid in (ref_cam_id, overlapped_cam_id):
            if cid not in self._cameras:
                raise ValueError(f"camera id {cid} not registered")
        self._paired[ref_cam_id] = overlapped_cam_id

    def add_imu(self, dev_id: int, params: ImuParams, T_b2s: Optional[Pose] = None,
                name: Optional[str] = None) -> None:
        if dev_id in self._imus:
            raise ValueError(f"imu id {dev_id} already registered")
        self._imus[dev_id] = ImuEntry(
            params=params, T_b2s=T_b2s if T_b2s is not None else pose_identity(torch.float32),
            name=name)
        if name is not None:
            self._name_to_id[name] = dev_id

    def get_camera(self, dev_id: int) -> CameraEntry:
        return self._cameras[dev_id]

    def get_cameras(self) -> Dict[int, CameraEntry]:
        return dict(self._cameras)

    def get_paired_cameras(self) -> Dict[int, int]:
        return dict(self._paired)

    def get_imu(self, dev_id: int) -> ImuEntry:
        return self._imus[dev_id]

    def get_dev_id(self, name: str) -> int:
        return self._name_to_id[name]

    def relative_extrinsics(self, cam_a: int, cam_b: int) -> Pose:
        """T_a2b: points of camera a's frame in camera b's frame,
        T_b2s(b) * T_b2s(a)^-1."""
        Ta = self._cameras[cam_a].T_b2s
        Tb = self._cameras[cam_b].T_b2s
        qa_inv = quat_conjugate(Ta.q)
        t_ainv = -quat_rotate(qa_inv, Ta.t)
        return Pose(t=quat_rotate(Tb.q, t_ainv) + Tb.t, q=quat_multiply(Tb.q, qa_inv))


class MultiCameraFrame:
    """Per-camera images of one timestamp, with pyramids, gradient pyramids
    and semi-dense detection computed per camera on request."""

    def __init__(self, cap_time: float, exp_time: float):
        self.cap_time = cap_time
        self.exp_time = exp_time
        self._images: Dict[int, torch.Tensor] = {}
        self._pyramids: Dict[int, List[torch.Tensor]] = {}
        self._grad_pyramids: Dict[int, List[torch.Tensor]] = {}

    def add_image(self, cam_id: int, img, device=None) -> None:
        """Store ``img`` (array or tensor) as a tensor, on ``device`` when
        given (a tensor keeps its device otherwise, an array goes to the
        CPU)."""
        self._images[cam_id] = torch.as_tensor(img, device=device)

    def camera_ids(self) -> List[int]:
        return sorted(self._images)

    def image(self, cam_id: int) -> torch.Tensor:
        return self._images[cam_id]

    def compute_pyramid(self, cam_id: int, num_levels: int):
        from ..ops.image import image_pyramid

        self._pyramids[cam_id] = image_pyramid(self._images[cam_id], num_levels)
        return self._pyramids[cam_id]

    def compute_grad_pyramid(self, cam_id: int):
        from ..ops.image import image_gradients

        pyr = self._pyramids.get(cam_id)
        if pyr is None:
            raise ValueError("compute_pyramid first")
        self._grad_pyramids[cam_id] = [image_gradients(lv) for lv in pyr]
        return self._grad_pyramids[cam_id]

    def pyramid(self, cam_id: int):
        return self._pyramids[cam_id]

    def grad_pyramid(self, cam_id: int):
        return self._grad_pyramids[cam_id]

    def detect_features(self, cam_id: int, level: int, opts):
        """Semi-dense detection on one camera's pyramid level."""
        from ..ops.image import gradient_magnitude
        from ..tracker.detector import detect_semidense

        mag = gradient_magnitude(self._grad_pyramids[cam_id][level])
        return detect_semidense(mag, level, opts)
