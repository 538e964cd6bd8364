"""Core vector math (port of ``mitsuba_tpu/core/math.py``, the subset the
port's scenes and BSDFs use).

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


def sqrt(x):
    """Correctly rounded square root, on every device (XLA's sqrt is).

    On the CPU, ``torch.sqrt`` runs MKL's vector math library (VML,
    ``vmsSqrt``), which splits a large call over its OpenMP threads. In a
    process's first such call, one thread's half of a 4,096-lane call was
    seen to come back as x * rsqrt(x) from the 12-bit ``vrsqrtps``
    estimate with no refinement step (3e-4 relative error, in 15 of 2,500
    fresh processes on a loaded host: ``scripts/vml_first_call_probe.py``).
    The CPU route goes around MKL: the reciprocal of PyTorch's own
    vectorised ``rsqrt`` in float64, rounded once, which is the correctly
    rounded float32 root."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return (1.0 / torch.rsqrt(x.to(torch.float64))).to(x.dtype)


def length(v, keepdim: bool = False):
    return sqrt(torch.clamp(dot(v, v, keepdim), min=0.0))


def squared_length(v, keepdim: bool = False):
    return dot(v, v, keepdim)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-30))


def safe_sqrt(x):
    """sqrt(max(x, 0)), bit for bit, with a gradient of 0 where x <= 0.

    The JAX package's form, sqrt(maximum(x, 0)), has an infinite derivative
    at 0, and where it is evaluated for lanes that a ``where`` then drops
    (the microfacet distribution a lane does not use), the dropped branch's
    0 cotangent times that inf is NaN, which reaches the parameter's
    gradient: Beckmann's ``sample_all`` meets sqrt(1 - ct^2) = sqrt(0) when
    its uniform is below about 6e-6. The root is taken of 1 there instead,
    as ``safe_div`` divides by 1."""
    pos = x > 0.0
    # XLA's max(-0, 0) is +0, and NaN stays NaN
    rest = torch.clamp(x.detach(), min=0.0) + 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), rest)


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


def reflect(wi, n):
    """Reflect wi about n (both pointing away from the surface)."""
    return 2.0 * dot(wi, n, keepdim=True) * n - wi


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized Fresnel reflectance of a conductor per channel
    (util.cpp fresnelConductorExact). ``eta``/``k`` are (..., 3) complex-IOR
    components; ``cos_i`` is (...,) or (..., 1). The JAX form: every root
    and quotient is a safe one, so no branch forms an inf or NaN."""
    if cos_i.dim() == eta.dim() - 1:
        cos_i = cos_i[..., None]
    ci2 = cos_i * cos_i
    si2 = 1.0 - ci2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + ci2
    a = safe_sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * cos_i
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return 0.5 * (rp + rs)
