"""Reconstruction filters (port of ``mitsuba_tpu/render/rfilter.py``): box,
tent, Gaussian, Mitchell, Catmull-Rom and Lanczos, evaluated directly as
separable 1D products."""
from __future__ import annotations

import math

import numpy as np
import torch

BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

RADIUS = {
    BOX: 0.5,
    TENT: 1.0,
    GAUSSIAN: 2.0,
    MITCHELL: 2.0,
    CATMULLROM: 2.0,
    LANCZOS: 3.0,
}

# the (B, C) of the Mitchell-Netravali cubics (mitchell.cpp, catmullrom.cpp)
_CUBIC_BC = {MITCHELL: (1.0 / 3.0, 1.0 / 3.0), CATMULLROM: (0.0, 0.5)}


def _sinc(t):
    t = torch.abs(t) * math.pi
    return torch.where(t < 1e-6, 1.0, torch.sin(t) / torch.clamp(t, min=1e-12))


def eval_1d(ftype: int, x):
    """Filter value at (1D) offset x, in the JAX package's order of
    operations."""
    ax = torch.abs(x)
    if ftype == BOX:
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if ftype == TENT:
        return torch.clamp(1.0 - ax, min=0.0)
    if ftype == GAUSSIAN:
        # gaussian.cpp: stddev 0.5, offset so it reaches 0 at the radius
        sigma = 0.5
        r = RADIUS[GAUSSIAN]
        alpha = -1.0 / (2.0 * sigma * sigma)
        return torch.clamp(torch.exp(alpha * ax * ax) - float(np.exp(alpha * r * r)),
                           min=0.0)
    if ftype in _CUBIC_BC:
        B, C = _CUBIC_BC[ftype]
        x2, x3 = ax * ax, ax * ax * ax
        inner = ((12.0 - 9.0 * B - 6.0 * C) * x3
                 + (-18.0 + 12.0 * B + 6.0 * C) * x2
                 + (6.0 - 2.0 * B)) / 6.0
        outer = ((-B - 6.0 * C) * x3
                 + (6.0 * B + 30.0 * C) * x2
                 + (-12.0 * B - 48.0 * C) * ax
                 + (8.0 * B + 24.0 * C)) / 6.0
        return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))
    if ftype == LANCZOS:
        tau = RADIUS[LANCZOS]
        return torch.where(ax < tau, _sinc(ax) * _sinc(ax / tau), 0.0)
    raise ValueError(f"unknown filter type {ftype}")


def footprint(ftype: int) -> int:
    """Half-width in whole pixels of the splat footprint (>= 1 so even the
    box filter's single containing pixel is covered by the tap window)."""
    if ftype not in RADIUS:
        raise ValueError(f"unknown filter type {ftype}")
    return max(1, int(np.ceil(RADIUS[ftype] - 0.5 + 1e-6)))
