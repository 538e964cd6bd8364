"""Core vector math (port of ``mitsuba_tpu/core/math.py``, the subset the
port's scenes, spheres and BSDFs use).

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


def solve_quadratic(a, b, c):
    """Numerically stable roots of a x^2 + b x + c (util.cpp solveQuadratic):
    (valid, x0, x1) with x0 <= x1, and the linear case a ~ 0."""
    linear = torch.abs(a) < 1e-20
    lin_x = safe_div(-c, b)
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sqrt_disc = safe_sqrt(disc)
    # q = -0.5 (b + sign(b) sqrt(disc))
    q = -0.5 * (b + torch.where(b < 0, -sqrt_disc, sqrt_disc))
    x0q = safe_div(q, a)
    x1q = safe_div(c, q)
    lo = torch.minimum(x0q, x1q)
    hi = torch.maximum(x0q, x1q)
    x0 = torch.where(linear, lin_x, lo)
    x1 = torch.where(linear, lin_x, hi)
    valid = torch.where(linear, torch.abs(b) > 1e-20, valid)
    return valid, x0, x1


def reflect(wi, n):
    """Reflect wi about n (both pointing away from the surface)."""
    return 2.0 * dot(wi, n, keepdim=True) * n - wi


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta = n_inside / n_outside; wi
    points away from the surface, on n's side. Returns (valid, wt), valid
    False on total internal reflection."""
    eta = torch.as_tensor(eta, dtype=wi.dtype, device=wi.device)
    if eta.dim() == wi.dim() - 1:
        eta = eta[..., None]  # align with the kept vector axis
    cos_i = dot(wi, n, keepdim=True)
    inv_eta = 1.0 / eta
    sin2_t = inv_eta * inv_eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    valid = sin2_t[..., 0] <= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -inv_eta * wi + (inv_eta * cos_i - cos_t) * n
    return valid, wt


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance of a dielectric boundary (util.cpp
    fresnelDielectricExt). ``cos_i`` is signed (negative: the ray arrives
    from inside), ``eta`` = int_ior / ext_ior. Returns (F, cos_t), cos_t the
    signed cosine of the transmitted direction (0 on total internal
    reflection)."""
    out_mask = cos_i >= 0.0
    rel_eta = torch.where(out_mask, eta, 1.0 / eta)
    ci = torch.abs(cos_i)
    sin2_t = (1.0 - ci * ci) / (rel_eta * rel_eta)
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - sin2_t)
    r_s = safe_div(ci - rel_eta * ct, ci + rel_eta * ct)
    r_p = safe_div(rel_eta * ci - ct, rel_eta * ci + ct)
    F = 0.5 * (r_s * r_s + r_p * r_p)
    F = torch.where(tir, 1.0, F)
    cos_t = torch.where(tir, 0.0, torch.where(out_mask, -ct, ct))
    return F, cos_t


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


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance under diffuse illumination (util.cpp
    fresnelDiffuseReflectance's fast path): the published polynomial fits
    of Egan & Hilgeman 1973 for eta < 1 and d'Eon & Irving 2011 for
    eta >= 1, in the JAX function's order of operations."""
    inv_eta = 1.0 / eta
    fit_lt1 = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 * inv_eta
    fit_ge1 = (
        0.919317
        + inv_eta
        * (-3.4793 + inv_eta * (6.75335 + inv_eta * (
            -7.80989 + inv_eta * (4.98554 - inv_eta * 1.36881))))
    )
    return torch.where(eta < 1.0, fit_lt1, fit_ge1)
