"""Camera: physical parameters, reverse-z matrices, TAA jitter, frustum.

Mirrors /root/reference/src/scene/Camera.{hpp,cpp}: right-handed lookAt,
reverse-z glTF projection with Halton(2,3) jitter folded into the matrix,
previous-frame matrices kept for velocity, world-space frustum planes, and
physical lens parameters {fov, zN/zF, apertureDiameter, focusDistance,
focalLength} (Camera.hpp:40-48, focalLength derived Camera.cpp:150-152).

The per-frame `CameraUniforms` dict is the analog of the reference's
constants-ring camera UBO (shader_structs/scene/camera.h:12-34).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..mathx import transforms as T
from ..mathx.rng import HALTON_23

# Reference sensor: 35mm film back (Camera.hpp sensorWidth)
SENSOR_WIDTH = 0.035


@dataclass
class CameraParameters:
    fov: float = float(np.radians(59.0))
    z_near: float = 0.1
    z_far: float = 100.0
    aperture_diameter: float = 0.00001
    focus_distance: float = 1.0
    focal_length: float = 0.0


@dataclass
class CameraTransform:
    eye: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.5, 1.0], np.float32))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))


class Camera:
    def __init__(
        self,
        resolution: tuple[int, int],
        parameters: CameraParameters | None = None,
        transform: CameraTransform | None = None,
        apply_jitter: bool = False,
    ) -> None:
        self.resolution = resolution  # (width, height)
        self.parameters = parameters or CameraParameters()
        self.transform = transform or CameraTransform()
        self.apply_jitter = apply_jitter
        self._jitter_index = 0
        self._current_jitter = np.zeros(2, np.float32)
        self._previous_jitter = np.zeros(2, np.float32)
        self._world_to_camera = np.eye(4, dtype=np.float32)
        self._camera_to_clip = np.eye(4, dtype=np.float32)
        self._prev_world_to_camera: np.ndarray | None = None
        self._prev_camera_to_clip: np.ndarray | None = None
        self.update()

    # -- frame protocol ----------------------------------------------------

    def look_at(self, transform: CameraTransform) -> None:
        self.transform = transform
        self.update()

    def update(self) -> None:
        """Recompute matrices for the current frame (Camera::updateBuffer)."""
        w, h = self.resolution
        ar = w / h
        p = self.parameters
        if self.apply_jitter:
            j = HALTON_23[self._jitter_index] * 2.0 - 1.0
            self._current_jitter = (j / np.array([w, h], np.float32)).astype(np.float32)
        else:
            self._current_jitter = np.zeros(2, np.float32)
        self._world_to_camera = T.look_at(
            self.transform.eye, self.transform.target, self.transform.up
        )
        self._camera_to_clip = T.perspective_reverse_z(
            p.fov, ar, p.z_near, p.z_far, tuple(self._current_jitter)
        )
        # focalLength from sensor height (Camera.cpp:150-152)
        tf = 1.0 / np.tan(p.fov * 0.5)
        p.focal_length = (SENSOR_WIDTH / ar) * tf * 0.5
        if self._prev_world_to_camera is None:
            self._prev_world_to_camera = self._world_to_camera.copy()
            self._prev_camera_to_clip = self._camera_to_clip.copy()

    def end_frame(self) -> None:
        """Rotate previous-frame state (Camera::endFrame)."""
        self._prev_world_to_camera = self._world_to_camera.copy()
        self._prev_camera_to_clip = self._camera_to_clip.copy()
        self._previous_jitter = self._current_jitter.copy()
        self._jitter_index = (self._jitter_index + 1) % len(HALTON_23)

    # -- uniforms -------------------------------------------------------------

    def uniforms(self) -> dict[str, np.ndarray]:
        """CameraUniforms pytree (camera.h:12-34)."""
        p = self.parameters
        w, h = self.resolution
        world_to_clip = self._camera_to_clip @ self._world_to_camera
        prev_world_to_clip = self._prev_camera_to_clip @ self._prev_world_to_camera
        corners = T.frustum_corners(
            self.transform.eye,
            self._world_to_camera,
            p.fov,
            w / h,
            p.z_near,
            p.z_far,
        )
        planes = T.frustum_planes(corners)
        col_scales = np.linalg.norm(self._world_to_camera[:3, :3], axis=0)
        return {
            "world_to_camera": self._world_to_camera,
            "camera_to_world": np.linalg.inv(self._world_to_camera),
            "camera_to_clip": self._camera_to_clip,
            "clip_to_world": np.linalg.inv(world_to_clip),
            "world_to_clip": world_to_clip,
            "prev_world_to_clip": prev_world_to_clip,
            "eye": np.asarray(self.transform.eye, np.float32),
            "frustum_planes": planes.astype(np.float32),
            "resolution": np.array([w, h], np.int32),
            "current_jitter": self._current_jitter,
            "previous_jitter": self._previous_jitter,
            "near": np.float32(p.z_near),
            "far": np.float32(p.z_far),
            "max_view_scale": np.float32(np.max(col_scales)),
            "aperture_diameter": np.float32(p.aperture_diameter),
            "focus_distance": np.float32(p.focus_distance),
            "focal_length": np.float32(p.focal_length),
        }
