"""Emitters and next-event estimation (port of ``mitsuba_tpu/render/emitter.py``,
the triangle area-light branch the Cornell box uses).

Area emitters own a contiguous range of an emissive-triangle array with a
globally monotone CDF: entry j stores ``emitter_index + local_cdf``, so
picking emitter e with residual u is one ``searchsorted(etri_cdf, e + u)``.
Other emitter types land in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp
from .records import DirectSample

# type tags, the JAX package's numbering
AREA = 0

SUPPORTED_TYPES = (AREA,)


class EmitterTable(NamedTuple):
    type: torch.Tensor      # (E,) int32
    radiance: torch.Tensor  # (E, 3)
    pmf: torch.Tensor       # (E,) emitter-selection pmf
    cdf: torch.Tensor       # (E,) emitter-selection cdf (inclusive)
    etri_tri: torch.Tensor  # (ET,) int32 scene triangle index
    etri_cdf: torch.Tensor  # (ET,) float32: emitter_idx + local_cdf

    @property
    def count(self):
        return self.type.shape[0]


def _gather_tri(scene, tri):
    """p0, e1, e2, geometric normal and NEE area pdf of triangles ``tri``."""
    return (scene.tri_p0[tri], scene.tri_e1[tri], scene.tri_e2[tri],
            scene.tri_gn[tri], scene.tri_nee_pdf_area[tri])


def sample_direct(scene, static, p_ref, u3):
    """Scene::sampleEmitterDirect analog: p_ref (R, 3), u3 (R, 3) uniforms.
    Visibility is not tested here; the integrator traces the shadow ray."""
    for t in static.emitter_types:
        if t not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"emitter type {t} lands in a later slice of the port")
    em = scene.emitters
    R = p_ref.shape[0]
    dev = p_ref.device
    u_sel, u0, u1 = u3[..., 0].contiguous(), u3[..., 1], u3[..., 2]

    # emitter pick via cdf (uniform weights, scene.cpp:375-381)
    e_idx = torch.clamp(
        torch.searchsorted(em.cdf, u_sel, right=True), 0, em.count - 1)
    lo_cdf = torch.where(e_idx > 0, em.cdf[torch.clamp(e_idx - 1, min=0)], 0.0)
    u_re = torch.clamp(
        m.safe_div(u_sel - lo_cdf, torch.clamp(em.pmf[e_idx], min=1e-12)),
        0.0, 1.0 - 1e-7)
    etype = em.type[e_idx]

    d = torch.zeros((R, 3), device=dev)
    dist = torch.full((R,), torch.inf, device=dev)
    radiance = torch.zeros((R, 3), device=dev)
    pdf_sa = torch.zeros((R,), device=dev)
    delta = torch.zeros((R,), dtype=torch.bool, device=dev)
    valid = torch.zeros((R,), dtype=torch.bool, device=dev)

    if AREA in static.emitter_types:
        # triangle pick through the globally monotone cdf
        key = e_idx.to(torch.float32) + u_re
        j = torch.clamp(torch.searchsorted(em.etri_cdf, key, right=True),
                        0, em.etri_tri.shape[0] - 1)
        tri = em.etri_tri[j].to(torch.int64)
        p0, e1, e2, n_l, pdf_a_g = _gather_tri(scene, tri)
        bc = warp.square_to_uniform_triangle(torch.stack([u0, u1], dim=-1))
        y = p0 + bc[..., 0:1] * e1 + bc[..., 1:2] * e2
        to_y = y - p_ref
        dist_a = m.length(to_y)
        d_a = to_y / torch.clamp(dist_a, min=1e-12)[..., None]
        cos_l = -m.dot(d_a, n_l)
        # area-measure pdf -> solid angle
        pdf_a = m.safe_div(pdf_a_g * dist_a * dist_a, torch.abs(cos_l))
        ok = (cos_l > 1e-7) & (dist_a > 1e-6)
        sel = etype == AREA
        d = torch.where(sel[..., None], d_a, d)
        dist = torch.where(sel, dist_a, dist)
        radiance = torch.where(sel[..., None], em.radiance[e_idx], radiance)
        pdf_sa = torch.where(sel, pdf_a, pdf_sa)
        valid = torch.where(sel, ok & (pdf_a > 0), valid)

    # the AREA branch folded the emitter pmf into tri_nee_pdf_area at build
    # time; the other (non-delta) types fold it here in the JAX package
    return DirectSample(d=d, dist=dist, radiance=radiance, pdf_sa=pdf_sa,
                        delta=delta, valid=valid)
