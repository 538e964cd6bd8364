"""Perlin gradient noise (port of ``mitsuba_tpu/core/noise.py``: the 3D
noise that the woven-cloth BSDF's yarn-tension variation reads; ``fbm`` and
``turbulence`` land with the noise texture).

As in the JAX package, the lattice gradients come from the PCG4D counter
hash (``core.rng.pcg4d``, run in int64 on values held in [0, 2^32)) instead
of a permutation table: one of Perlin's twelve edge directions per lattice
corner, picked by the hash's top four bits, trilinearly blended with the
quintic fade. The hash and the corner selection equal the JAX package's bit
for bit.
"""
from __future__ import annotations

import torch

from .rng import pcg4d

_GRAD_KEY = 0x9E3779B9


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _gradient_dot(ix, iy, iz, fx, fy, fz):
    """dot(g, f) with g the gradient at the integer lattice point (ix, iy,
    iz), int tensors read as uint32: one of the 12 edge directions
    selected by the hash's top four bits (Perlin 2002's gradient set,
    branchless)."""
    key = torch.full_like(ix, _GRAD_KEY, dtype=torch.int64)
    h = pcg4d(torch.stack([ix, iy, iz, key], dim=-1))[..., 0] >> 28
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def perlin_3d(p):
    """Improved Perlin noise of (..., 3) points -> (...,), roughly in
    [-1, 1] and 0 at lattice points."""
    pf = torch.floor(p)
    # int32 lattice coordinates, as the JAX package casts them; pcg4d reads
    # them as uint32
    ix = pf[..., 0].to(torch.int32).to(torch.int64)
    iy = pf[..., 1].to(torch.int32).to(torch.int64)
    iz = pf[..., 2].to(torch.int32).to(torch.int64)
    f = p - pf
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def corner(dx, dy, dz):
        return _gradient_dot(ix + dx, iy + dy, iz + dz,
                             fx - dx, fy - dy, fz - dz)

    def lerp(t, a, b):
        return a + t * (b - a)

    x00 = lerp(u, corner(0, 0, 0), corner(1, 0, 0))
    x10 = lerp(u, corner(0, 1, 0), corner(1, 1, 0))
    x01 = lerp(u, corner(0, 0, 1), corner(1, 0, 1))
    x11 = lerp(u, corner(0, 1, 1), corner(1, 1, 1))
    y0 = lerp(v, x00, x10)
    y1 = lerp(v, x01, x11)
    return lerp(w, y0, y1)
