"""Interaction and sampling records (port of ``mitsuba_tpu/render/records.py``):
NamedTuples of batched tensors; ``valid`` masks replace sentinel t values."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.frame import Frame


class Interaction(NamedTuple):
    """Surface interaction for a batch of rays (R lanes)."""

    valid: torch.Tensor       # (R,) hit anything
    t: torch.Tensor           # (R,) distance (inf on a miss)
    p: torch.Tensor           # (R, 3) hit position
    gn: torch.Tensor          # (R, 3) geometric normal
    sh_frame: Frame           # shading frame (n = interpolated normal)
    uv: torch.Tensor          # (R, 2)
    wi: torch.Tensor          # (R, 3) direction toward origin, local frame
    wi_world: torch.Tensor    # (R, 3) direction toward origin, world
    mat_id: torch.Tensor      # (R,) int32, -1 if invalid
    emitter_id: torch.Tensor  # (R,) int32, -1 if not emissive
    prim_id: torch.Tensor     # (R,) int32 triangle id, -1 if invalid
    nee_pdf_area: torch.Tensor  # (R,) NEE area pdf of the hit triangle
    bary: torch.Tensor        # (R, 2) barycentrics (b1, b2)


class DirectSample(NamedTuple):
    """Next-event-estimation emitter sample (DirectSamplingRecord)."""

    d: torch.Tensor           # (R, 3) unit direction from ref point to emitter
    dist: torch.Tensor        # (R,) distance to the sampled point
    radiance: torch.Tensor    # (R, 3) emitted radiance toward ref
    pdf_sa: torch.Tensor      # (R,) solid-angle pdf
    delta: torch.Tensor       # (R,) bool: delta emitter
    valid: torch.Tensor       # (R,) sample admissible
