"""Film accumulation (port of ``mitsuba_tpu/render/film.py``: the full-image
``splat_grid`` and ``develop``).

The film is one (H, W, 4) tensor: filter-weighted RGB sums and the weight.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rfilter


class Film(NamedTuple):
    data: torch.Tensor  # (H, W, 4): rgb-weighted sum + weight

    @staticmethod
    def empty(height: int, width: int, device) -> "Film":
        return Film(data=torch.zeros((height, width, 4), device=device))

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]


def splat_grid(film: Film, pos, value, filter_type: int) -> Film:
    """Filter splat of one sample per pixel over the whole image.

    ``pos`` (H, W, 2) continuous positions, each in its own pixel; ``value``
    (H, W, 3). Every sample lives in a distinct pixel, so the footprint-F
    scatter becomes (2F+1)^2 shifted dense adds into a canvas padded by F,
    accumulated in the JAX package's tap order, then cropped. NaN or
    negative samples carry no weight (ImageBlock::put's policy).
    """
    H, W = film.height, film.width
    rows = value.shape[0]
    if rows != H:
        raise NotImplementedError(
            "row-tile splats (sharded films) land in a later slice of the port")
    fp = rfilter.footprint(filter_type)
    dev = value.device

    finite = (torch.all(torch.isfinite(value), dim=-1)
              & torch.all(value > -1e-5, dim=-1))
    value = torch.where(finite[..., None], value, 0.0)
    wmask = finite.to(torch.float32)

    py = torch.arange(rows, device=dev, dtype=torch.float32)[:, None].expand(rows, W)
    px = torch.arange(W, device=dev, dtype=torch.float32)[None, :].expand(rows, W)

    pad = fp
    contrib = torch.cat([value, torch.ones_like(value[..., :1])], dim=-1)
    canvas = torch.zeros((rows + 2 * pad, W + 2 * pad, 4), device=dev)
    # the stencil is pixel-centered, so it needs the full (2fp+1)^2 window
    for oy in range(-fp, fp + 1):
        wy = rfilter.eval_1d(filter_type, py + oy + 0.5 - pos[..., 1])
        for ox in range(-fp, fp + 1):
            wx = rfilter.eval_1d(filter_type, px + ox + 0.5 - pos[..., 0])
            w = (wx * wy * wmask)[..., None]
            canvas[pad + oy:pad + oy + rows, pad + ox:pad + ox + W] += contrib * w
    return Film(data=film.data + canvas[pad:-pad, pad:-pad])


def develop(film: Film):
    """Normalize accumulated splats -> (H, W, 3) radiance image."""
    w = film.data[..., 3:4]
    return film.data[..., :3] / torch.clamp(w, min=1e-12)
