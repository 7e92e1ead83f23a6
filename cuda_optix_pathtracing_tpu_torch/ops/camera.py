"""Perspective camera (counterpart of the reference ``ops/camera.py``).

Raster origin top-left, pixel centres at +0.5; a physical sensor model
(focal length and sensor height in mm); camera looks down +z; world up
is +z. Matrices are built in numpy exactly as the reference builds them
and applied with explicit f32 multiply-adds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .vecmath import normalize, transform_point, transform_vector


@dataclass(frozen=True)
class CameraConfig:
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 1.0, 0.0)
    width: int = 256
    height: int = 256
    focal_length_mm: float = 20.0
    sensor_height_mm: float = 36.0


def camera_from_raster(focal_mm, sensor_h_mm, x_res, y_res) -> np.ndarray:
    """4×4 float32 matrix mapping raster (px, py, 0) → camera-space
    sensor point."""
    sensor_w_mm = sensor_h_mm * float(x_res) / float(y_res)
    mm = 1e-3
    f, sh, sw = focal_mm * mm, sensor_h_mm * mm, sensor_w_mm * mm
    px_x = sw / float(x_res)
    px_y = sh / float(y_res)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = px_x
    m[1, 1] = -px_y
    m[0, 3] = -0.5 * sw + 0.5 * px_x
    m[1, 3] = 0.5 * sh - 0.5 * px_y
    m[2, 3] = f
    return m


def world_from_camera(direction, position) -> np.ndarray:
    """4×4 float32 camera→world from viewing direction and position."""
    d = np.asarray(direction, dtype=np.float64)
    forward = d / np.linalg.norm(d)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = up
    m[:3, 2] = forward
    m[:3, 3] = np.asarray(position, dtype=np.float64)
    return m


def generate_rays(p_film, cam_from_raster, world_from_cam):
    """Rays through film points ``p_film`` (N, 2) → (origins, unit
    directions), both (N, 3)."""
    zeros = torch.zeros_like(p_film[..., :1])
    p_raster = torch.cat([p_film, zeros], dim=-1)
    p_camera = transform_point(cam_from_raster, p_raster)
    o = transform_point(world_from_cam, torch.zeros_like(p_camera))
    d = normalize(transform_vector(world_from_cam, p_camera))
    return o, d


def pixel_centers(width: int, height: int, device=None):
    """(H*W, 2) float32 pixel indices, row-major (x fastest)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device),
        torch.arange(width, device=device),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(torch.float32)
