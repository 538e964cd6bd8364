"""Ray-triangle and ray-sphere intersection in plain tensor form (port of
the triangle and sphere parts of ``mitsuba_tpu/ops/intersect.py``).

These are the XLA forms of the JAX package: they build (R, T) or (R, S)
intermediates and so suit small batches. The render path sends triangles to
the brute-force kernels in ``cuda_intersect`` instead; analytic spheres stay
here, as in the JAX package, where they are ``jnp`` code outside any Pallas
kernel.
"""
from __future__ import annotations

import torch

from ..core import math as m


def ray_triangle(o, d, p0, e1, e2, t_min, t_max):
    """Moeller-Trumbore. Returns (hit, t, u, v); e1 = p1 - p0, e2 = p2 - p0."""
    pvec = m.cross(d, e2)
    det = m.dot(e1, pvec)
    inv_det = m.safe_div(1.0, det)
    tvec = o - p0
    u = m.dot(tvec, pvec) * inv_det
    qvec = m.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = (
        (torch.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def ray_sphere(o, d, center, radius, t_min, t_max):
    """Analytic sphere intersection (sphere.cpp rayIntersect): (hit, t) of
    the nearer root inside (t_min, t_max). The JAX package's quadratic as
    written: another root formula moves hits at the silhouette and the far
    root of a refracted ray inside the sphere."""
    oc = o - center
    a = m.dot(d, d)
    b = 2.0 * m.dot(oc, d)
    c = m.dot(oc, oc) - radius * radius
    valid, t0, t1 = m.solve_quadratic(a, b, c)
    use0 = (t0 > t_min) & (t0 < t_max)
    use1 = (t1 > t_min) & (t1 < t_max)
    t = torch.where(use0, t0, t1)
    hit = valid & (use0 | use1)
    return hit, t


def ray_brute_force_tris(o, d, p0, e1, e2, t_min, t_max):
    """Closest hit of rays o, d (R, 3) against triangles (T, 3).

    Returns (hit (R,), t (R,), idx (R,) int32, u (R,), v (R,)); the lowest
    index wins a tie, as ``argmin`` does in the JAX form.
    """
    hit, t, u, v = ray_triangle(
        o[:, None, :], d[:, None, :], p0[None], e1[None], e2[None],
        t_min[:, None], t_max[:, None],
    )
    t_masked = torch.where(hit, t, torch.inf)
    idx = torch.argmin(t_masked, dim=1)
    r = torch.arange(o.shape[0], device=o.device)
    best_t = t_masked[r, idx]
    any_hit = torch.isfinite(best_t)
    return (
        any_hit,
        torch.where(any_hit, best_t, torch.inf),
        torch.where(any_hit, idx, -1).to(torch.int32),
        u[r, idx],
        v[r, idx],
    )


def ray_brute_force_spheres(o, d, center, radius, t_min, t_max):
    """Closest hit of rays o, d (R, 3) against spheres center (S, 3), radius
    (S,). Returns (hit (R,), t (R,), idx (R,) int32); the lowest index wins
    a tie."""
    hit, t = ray_sphere(o[:, None, :], d[:, None, :], center[None],
                        radius[None], t_min[:, None], t_max[:, None])
    t_masked = torch.where(hit, t, torch.inf)
    idx = torch.argmin(t_masked, dim=1)
    r = torch.arange(o.shape[0], device=o.device)
    best_t = t_masked[r, idx]
    any_hit = torch.isfinite(best_t)
    return (any_hit, torch.where(any_hit, best_t, torch.inf),
            torch.where(any_hit, idx, -1).to(torch.int32))
