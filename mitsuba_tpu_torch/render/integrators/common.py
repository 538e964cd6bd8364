"""Shared integrator machinery (port of
``mitsuba_tpu/render/integrators/common.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import math as m

# integrator type tags, the JAX package's numbering
AO = 0
DIRECT = 1
PATH = 2
FIELD = 3
MULTICHANNEL = 9  # misc/multichannel.cpp (api.render_multichannel)

# field integrator AOVs (misc/field.cpp)
FIELD_POSITION = 0
FIELD_NORMAL = 1
FIELD_SH_NORMAL = 2
FIELD_UV = 3
FIELD_ALBEDO = 4
FIELD_DISTANCE = 5
FIELD_PRIM_INDEX = 6
FIELD_GEO_NORMAL = 7


@dataclass(frozen=True)
class IntegratorConfig:
    """Integrator settings (the fields the path tracer and the direct, ao
    and field integrators read)."""

    type: int = PATH
    max_depth: int = 5           # path.cpp maxDepth: 1 = Le only, 2 = direct
    rr_depth: int = 5            # Russian roulette start
    hide_emitters: bool = False  # emitters seen by the camera stay black
    emitter_samples: int = 1     # direct.cpp emitterSamples
    bsdf_samples: int = 1        # direct.cpp bsdfSamples
    ray_length: float = -1.0     # ao.cpp rayLength; <= 0: scene radius / 2
    shading_samples: int = 1     # ao.cpp shadingSamples
    field: int = FIELD_NORMAL    # field.cpp's AOV


def mis_power(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (path.cpp miWeight)."""
    a2 = pdf_a * pdf_a
    return m.safe_div(a2, a2 + pdf_b * pdf_b)


# RNG dimension allocation per sample: 0 pixel jitter, 1 aperture, 2 the
# spectral render's hero wavelength, then DIMS_PER_BOUNCE per bounce from
# DIM_BASE
DIM_SENSOR = 0
DIM_APERTURE = 1
DIM_WAVELENGTH = 2
DIM_BASE = 4
DIMS_PER_BOUNCE = 4
DIM_NEE = 0       # 4d: emitter select + 2d position
DIM_BSDF = 1      # 4d: lobe select + 2d direction
DIM_RR = 2


def ray_offset(p, gn, d):
    """Offset a secondary-ray origin along the geometric normal, to the side
    of ``d``, to avoid self-intersection."""
    s = torch.sign(m.dot(gn, d, keepdim=True))
    mag = 1e-4 * (1.0 + torch.amax(torch.abs(p), dim=-1, keepdim=True))
    return p + gn * s * mag
