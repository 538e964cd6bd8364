"""Core vector math (port of ``mitsuba_tpu/core/math.py``, the subset the
port's scenes use).

Vectors, points and normals are plain ``(..., 3)`` float32 tensors. Each
function repeats the JAX function's arithmetic in the same order, so the two
agree to float32 rounding.
"""
from __future__ import annotations

import math

import torch


def dot(a, b, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def length(v, keepdim: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim), min=0.0))


def squared_length(v, keepdim: bool = False):
    return dot(v, v, keepdim)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-30))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b, eps: float = 1e-20):
    """a / b with 0 where |b| <= eps (the JAX form: the untaken branch
    divides by 1, so no inf or NaN is ever formed)."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def coordinate_system(n):
    """Right-handed orthonormal basis (s, t) around unit normal ``n``
    (Duff et al. 2017, branch-free, as in the JAX package)."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return s, t


def spherical_direction(theta, phi):
    """(theta, phi) -> unit vector, Z up."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def spherical_coordinates(d):
    """unit vector -> (theta, phi) with phi in [0, 2pi)."""
    theta = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return theta, phi
