"""Sensors (port of ``mitsuba_tpu/render/sensor.py``, the perspective camera).

A sensor is a NamedTuple of camera constants: float32 tensors on the render
device, and the type tag as a Python int so that dispatch needs no device
round trip. Other sensor types land in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core.transform import Transform
from ..device import resolve_device

PERSPECTIVE = 0


class Sensor(NamedTuple):
    type: int                      # sensor type tag
    to_world: torch.Tensor         # (4, 4) camera-to-world
    tan_half_fov: torch.Tensor     # () tan(fov_x / 2)
    aspect: torch.Tensor           # () width / height
    aperture_radius: torch.Tensor  # ()
    focus_distance: torch.Tensor   # ()
    ortho_scale: torch.Tensor      # (2,)
    near: torch.Tensor             # ()
    rdist: torch.Tensor            # (2,) radial distortion


def make_perspective(to_world: Transform, fov_deg: float, width: int,
                     height: int, near: float = 1e-2, device=None) -> Sensor:
    """``fov_deg`` spans the image's x axis (perspective.cpp's default
    fovAxis; the other axes land in a later slice)."""
    dev = resolve_device(device)
    aspect = width / height
    t = np.tan(np.deg2rad(fov_deg) / 2.0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return Sensor(
        type=PERSPECTIVE, to_world=f32(to_world.m), tan_half_fov=f32(t),
        aspect=f32(aspect), aperture_radius=f32(0.0), focus_distance=f32(1.0),
        ortho_scale=f32(np.ones(2)), near=f32(near), rdist=f32(np.zeros(2)),
    )


def pixel_spread(sensor: Sensor, width: int):
    """Angular size of one pixel at the image center (radians)."""
    return 2.0 * sensor.tan_half_fov / float(np.float32(width))


def sample_ray(sensor: Sensor, uv, u_aperture):
    """Film positions uv in [0,1)^2 (R, 2) -> world rays (o, d), (R, 3) each.
    ``u_aperture`` is unused by the perspective camera (thinlens draws it)."""
    if sensor.type != PERSPECTIVE:
        raise NotImplementedError(
            f"sensor type {sensor.type} lands in a later slice of the port")
    x = (2.0 * uv[..., 0] - 1.0) * sensor.tan_half_fov
    y = (1.0 - 2.0 * uv[..., 1]) * sensor.tan_half_fov / sensor.aspect
    d_cam = m.normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
    A = sensor.to_world
    # every ray leaves the pinhole; contiguous, as the intersectors require
    o_w = A[:3, 3].expand_as(d_cam).contiguous()
    d_w = m.normalize(d_cam @ A[:3, :3].T)
    return o_w, d_w
