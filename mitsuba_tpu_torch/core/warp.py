"""Sampling warps (port of ``mitsuba_tpu/core/warp.py``, the subset the
port's scenes use): square -> cosine hemisphere, concentric disk, triangle."""
from __future__ import annotations

import math

import torch

from . import math as m

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)


def square_to_cosine_hemisphere(u):
    p = square_to_uniform_disk_concentric(u)
    z = m.safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    cond = torch.abs(x) > torch.abs(y)
    r = torch.where(cond, x, y)
    ratio = torch.where(cond, m.safe_div(y, x), m.safe_div(x, y))
    phi = torch.where(
        cond,
        (math.pi / 4.0) * ratio,
        (math.pi / 2.0) - (math.pi / 4.0) * ratio,
    )
    zero = (x == 0.0) & (y == 0.0)
    px = torch.where(zero, 0.0, r * torch.cos(phi))
    py = torch.where(zero, 0.0, r * torch.sin(phi))
    return torch.stack([px, py], dim=-1)


def square_to_uniform_triangle(u):
    """Barycentric (b0, b1) uniform on the unit triangle (sqrt warp)."""
    a = m.safe_sqrt(u[..., 0])
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)
