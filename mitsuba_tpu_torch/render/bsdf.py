"""BSDFs with masked type dispatch (port of ``mitsuba_tpu/render/bsdf.py``,
the DIFFUSE lobe the Cornell box uses).

Conventions follow the JAX package: unit directions in the local shading
frame (+Z = normal), ``wi`` toward the previous vertex; ``eval`` returns
f(wi, wo)·|cos θo|, ``pdf`` the solid-angle density of ``sample``, and
``sample`` (wo, weight = f·|cos θo|/pdf, pdf, is_delta, eta). Every type
present in the scene is evaluated for the whole batch and selected per lane
with ``where``; types other than DIFFUSE land in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import warp

# type tags, the JAX package's numbering
DIFFUSE = 0

SUPPORTED_TYPES = (DIFFUSE,)


class MaterialTable(NamedTuple):
    """One row per scene material (the columns the port reads)."""

    type: torch.Tensor        # (M,) int32 type tag
    albedo: torch.Tensor      # (M, 3) diffuse reflectance
    albedo_tex: torch.Tensor  # (M,) int32 texture of the albedo, -1 if none
    twosided: torch.Tensor    # (M,) bool: flip frame on backface


class BsdfLocals(NamedTuple):
    """Per-lane material parameters gathered for a batch of interactions."""

    type: torch.Tensor      # (R,)
    albedo: torch.Tensor    # (R, 3)
    twosided: torch.Tensor  # (R,) bool


class BsdfSample(NamedTuple):
    wo: torch.Tensor        # (R, 3)
    weight: torch.Tensor    # (R, 3) f*cos/pdf
    pdf: torch.Tensor       # (R,)
    is_delta: torch.Tensor  # (R,) bool
    eta: torch.Tensor       # (R,) relative IOR along the sampled lobe


def gather_locals(table: MaterialTable, mat_id,
                  albedo_override=None) -> BsdfLocals:
    """Per-lane parameters of materials ``mat_id``; ``albedo_override``
    (R, 3) replaces the table's albedo (a textured albedo)."""
    mid = torch.clamp(mat_id, min=0).to(torch.int64)
    albedo = table.albedo[mid] if albedo_override is None else albedo_override
    return BsdfLocals(type=table.type[mid], albedo=albedo,
                      twosided=table.twosided[mid])


def _check_types(types):
    for t in types:
        if t not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {t} lands in a later slice of the port")


def _flip_twosided(bl: BsdfLocals, wi, wo=None):
    """twosided.cpp: when the incident ray arrives from below, flip the frame
    so one-sided models see the upper hemisphere."""
    flip = bl.twosided & (wi[..., 2] < 0.0)
    sgn = torch.where(flip, -1.0, 1.0)[..., None]
    zflip = torch.cat([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    wi_f = wi * zflip
    if wo is None:
        return wi_f, zflip
    return wi_f, wo * zflip, zflip


def _diffuse_eval(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    f = bl.albedo * (warp.INV_PI * torch.clamp(wo[..., 2], min=0.0))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _diffuse_pdf(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(ok, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _diffuse_sample(bl, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    ok = wi[..., 2] > 0
    weight = torch.where(ok[..., None], bl.albedo, 0.0)
    sh = wi.shape[:-1]
    return (wo, weight, torch.where(ok, pdf, 0.0),
            torch.zeros(sh, dtype=torch.bool, device=wi.device),
            torch.ones(sh, device=wi.device))


def eval(bl: BsdfLocals, wi, wo, active_types=SUPPORTED_TYPES):
    """f(wi, wo)·|cos θo| for the smooth lobes, per-lane type dispatch."""
    _check_types(active_types)
    wi, wo, _ = _flip_twosided(bl, wi, wo)
    out = torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    for t in active_types:
        out = torch.where((bl.type == t)[..., None], _diffuse_eval(bl, wi, wo), out)
    return out


def pdf(bl: BsdfLocals, wi, wo, active_types=SUPPORTED_TYPES):
    _check_types(active_types)
    wi, wo, _ = _flip_twosided(bl, wi, wo)
    out = torch.zeros(wi.shape[:-1], device=wi.device)
    for t in active_types:
        out = torch.where(bl.type == t, _diffuse_pdf(bl, wi, wo), out)
    return out


def sample(bl: BsdfLocals, wi, u_lobe, u2, active_types=SUPPORTED_TYPES) -> BsdfSample:
    _check_types(active_types)
    wi_f, zflip = _flip_twosided(bl, wi)
    sh = wi.shape[:-1]
    dev = wi.device
    out = BsdfSample(
        wo=torch.zeros(sh + (3,), device=dev),
        weight=torch.zeros(sh + (3,), device=dev),
        pdf=torch.zeros(sh, device=dev),
        is_delta=torch.zeros(sh, dtype=torch.bool, device=dev),
        eta=torch.ones(sh, device=dev),
    )
    for t in active_types:
        sel = bl.type == t
        wo_, w_, p_, d_, e_ = _diffuse_sample(bl, wi_f, u_lobe, u2)
        out = BsdfSample(
            wo=torch.where(sel[..., None], wo_, out.wo),
            weight=torch.where(sel[..., None], w_, out.weight),
            pdf=torch.where(sel, p_, out.pdf),
            is_delta=torch.where(sel, d_, out.is_delta),
            eta=torch.where(sel, e_, out.eta),
        )
    # un-flip wo for twosided backfaces
    return out._replace(wo=out.wo * zflip)
