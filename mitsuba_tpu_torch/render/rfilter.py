"""Reconstruction filters (port of ``mitsuba_tpu/render/rfilter.py``, box
and Gaussian), evaluated directly as separable 1D products."""
from __future__ import annotations

import numpy as np
import torch

BOX = 0
GAUSSIAN = 2

RADIUS = {
    BOX: 0.5,
    GAUSSIAN: 2.0,
}


def eval_1d(ftype: int, x):
    """Filter value at (1D) offset x."""
    ax = torch.abs(x)
    if ftype == BOX:
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if ftype == GAUSSIAN:
        # gaussian.cpp: stddev 0.5, offset so it reaches 0 at the radius
        sigma = 0.5
        r = RADIUS[GAUSSIAN]
        alpha = -1.0 / (2.0 * sigma * sigma)
        return torch.clamp(torch.exp(alpha * ax * ax) - float(np.exp(alpha * r * r)),
                           min=0.0)
    raise NotImplementedError(f"filter {ftype} lands in a later slice of the port")


def footprint(ftype: int) -> int:
    """Half-width in whole pixels of the splat footprint (>= 1)."""
    if ftype not in RADIUS:
        raise NotImplementedError(f"filter {ftype} lands in a later slice of the port")
    return max(1, int(np.ceil(RADIUS[ftype] - 0.5 + 1e-6)))
