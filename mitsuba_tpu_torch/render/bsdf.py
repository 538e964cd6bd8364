"""BSDFs with masked type dispatch (port of ``mitsuba_tpu/render/bsdf.py``:
the DIFFUSE lobe, the smooth DIELECTRIC and the ROUGH_CONDUCTOR microfacet
lobe).

Conventions follow the JAX package: unit directions in the local shading
frame (+Z = normal), ``wi`` toward the previous vertex; ``eval`` returns
f(wi, wo)·|cos θo|, ``pdf`` the solid-angle density of ``sample``, and
``sample`` (wo, weight = f·|cos θo|/pdf, pdf, is_delta, eta). Every type
present in the scene is evaluated for the whole batch and selected per lane
with ``where``; a rough lobe evaluates both microfacet distributions and
picks one per lane (``_dist_mix``). The smooth dielectric is a delta lobe:
``eval`` and ``pdf`` are 0 on it and only ``sample`` reaches it. Other types
land in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp
from . import microfacet as mf

# type tags, the JAX package's numbering
DIFFUSE = 0
DIELECTRIC = 1
ROUGH_CONDUCTOR = 3

SUPPORTED_TYPES = (DIFFUSE, DIELECTRIC, ROUGH_CONDUCTOR)


class MaterialTable(NamedTuple):
    """One row per scene material (the columns the port reads)."""

    type: torch.Tensor        # (M,) int32 type tag
    dist: torch.Tensor        # (M,) int32 microfacet distribution (mf.BECKMANN/GGX)
    albedo: torch.Tensor      # (M, 3) diffuse reflectance
    albedo_tex: torch.Tensor  # (M,) int32 texture of the albedo, -1 if none
    spec_refl: torch.Tensor   # (M, 3) specular reflectance tint
    spec_trans: torch.Tensor  # (M, 3) specular transmittance tint
    eta: torch.Tensor         # (M, 3) IOR (dielectric: the scalar
                              # int/ext replicated; conductor: real part)
    k: torch.Tensor           # (M, 3) conductor absorption
    alpha: torch.Tensor       # (M, 2) roughness alpha_u, alpha_v
    twosided: torch.Tensor    # (M,) bool: flip frame on backface


class BsdfLocals(NamedTuple):
    """Per-lane material parameters gathered for a batch of interactions;
    ``albedo`` is the post-texture value, so texture gradients flow here."""

    type: torch.Tensor       # (R,)
    dist: torch.Tensor       # (R,)
    albedo: torch.Tensor     # (R, 3)
    spec_refl: torch.Tensor  # (R, 3)
    eta_c: torch.Tensor      # (R, 3) conductor eta
    k_c: torch.Tensor        # (R, 3)
    alpha: torch.Tensor      # (R, 2)
    twosided: torch.Tensor   # (R,) bool
    # the dielectric's columns; None where no lane is a dielectric
    spec_trans: torch.Tensor = None  # (R, 3)
    eta_s: torch.Tensor = None       # (R,) scalar IOR int/ext


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
    return BsdfLocals(type=table.type[mid], dist=table.dist[mid],
                      albedo=albedo, spec_refl=table.spec_refl[mid],
                      eta_c=table.eta[mid], k_c=table.k[mid],
                      alpha=table.alpha[mid], twosided=table.twosided[mid],
                      spec_trans=table.spec_trans[mid],
                      eta_s=table.eta[mid][..., 0])


def _check_types(types):
    for t in types:
        if t not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {t} lands in a later slice of the port")


def _flip_twosided(bl: BsdfLocals, wi, wo=None):
    """twosided.cpp: when the incident ray arrives from below, flip the frame
    so one-sided models see the upper hemisphere. The dielectric has two
    sides by nature and is never flipped (the JAX loader never marks it
    two-sided; a row the builder marks so keeps its side here too)."""
    flip = bl.twosided & (wi[..., 2] < 0.0) & (bl.type != DIELECTRIC)
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


def _dielectric_sample(bl, wi, u_lobe, u2):
    """Smooth dielectric (dielectric.cpp): reflect or refract, chosen by
    Fresnel. Two-sided by nature: the side comes from the sign of cos θi."""
    ci = wi[..., 2]
    F, cos_t = m.fresnel_dielectric(ci, bl.eta_s)
    reflect = u_lobe < F
    wo_r = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
    # in the local frame Snell's law scales the tangent components
    rel_eta = torch.where(ci >= 0, bl.eta_s, 1.0 / bl.eta_s)
    scale = -1.0 / rel_eta
    wo_t = torch.stack([wi[..., 0] * scale, wi[..., 1] * scale, cos_t], dim=-1)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    eta_ratio = torch.where(reflect, 1.0, rel_eta)
    # radiance carries the 1/eta^2 scale through a refraction
    factor = torch.where(reflect, 1.0, 1.0 / (rel_eta * rel_eta))
    weight = torch.where(reflect[..., None], bl.spec_refl,
                         bl.spec_trans * factor[..., None])
    pdf = torch.where(reflect, F, 1.0 - F)
    # total internal reflection: F == 1, so the refraction is never taken
    return (wo, weight, torch.clamp(pdf, min=1e-12),
            torch.ones(ci.shape, dtype=torch.bool, device=wi.device),
            eta_ratio)


def _rough_conductor_f(bl, dist: int, wi, wo):
    """f·cos θo = D G F / (4 cos θi) (roughconductor.cpp, the microfacet
    identity folds cos θo in)."""
    mh = m.normalize(wi + wo)
    D = mf.eval_d(dist, bl.alpha[..., 0], bl.alpha[..., 1], mh)
    G = mf.smith_g(dist, bl.alpha[..., 0], bl.alpha[..., 1], wi, wo, mh)
    F = m.fresnel_conductor(m.dot(wi, mh), bl.eta_c, bl.k_c)
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    spec = m.safe_div(D * G, 4.0 * wi[..., 2])
    return torch.where(ok[..., None], bl.spec_refl * F * spec[..., None], 0.0)


def _rough_conductor_pdf(bl, dist: int, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    mh = m.normalize(wi + wo)
    p = mf.pdf(dist, bl.alpha[..., 0], bl.alpha[..., 1], wi, mh)
    jac = m.safe_div(1.0, 4.0 * torch.abs(m.dot(wo, mh)))
    return torch.where(ok, p * jac, 0.0)


def _rough_conductor_sample(bl, dist: int, wi, u_lobe, u2):
    au, av = bl.alpha[..., 0], bl.alpha[..., 1]
    mh, p_m = mf.sample(dist, au, av, wi, u2)
    wo = m.reflect(wi, mh)
    pdf = m.safe_div(p_m, 4.0 * torch.abs(m.dot(wo, mh)))
    f = _rough_conductor_f(bl, dist, wi, wo)
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0) & (pdf > 1e-12)
    weight = torch.where(ok[..., None], m.safe_div(f, pdf[..., None]), 0.0)
    sh = ok.shape
    return (wo, weight, torch.where(ok, pdf, 0.0),
            torch.zeros(sh, dtype=torch.bool, device=wi.device),
            torch.ones(sh, device=wi.device))


def _dist_mix(bl, fn):
    """fn for both microfacet distributions, selected per lane; the tensors
    of a tuple each selected alike."""
    v_b = fn(mf.BECKMANN)
    v_g = fn(mf.GGX)
    sel = bl.dist == mf.GGX

    def pick(a, b):
        return torch.where(sel[..., None] if a.dim() > sel.dim() else sel,
                           a, b)

    if isinstance(v_g, tuple):
        return tuple(pick(a, b) for a, b in zip(v_g, v_b))
    return pick(v_g, v_b)


def eval(bl: BsdfLocals, wi, wo, active_types=SUPPORTED_TYPES):
    """f(wi, wo)·|cos θo| for the smooth lobes, per-lane type dispatch."""
    _check_types(active_types)
    wi, wo, _ = _flip_twosided(bl, wi, wo)
    out = torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    for t in active_types:
        if t == DIFFUSE:
            v = _diffuse_eval(bl, wi, wo)
        elif t == ROUGH_CONDUCTOR:
            v = _dist_mix(bl, lambda d: _rough_conductor_f(bl, d, wi, wo))
        else:
            continue  # a delta lobe evaluates to 0
        out = torch.where((bl.type == t)[..., None], v, out)
    return out


def pdf(bl: BsdfLocals, wi, wo, active_types=SUPPORTED_TYPES):
    _check_types(active_types)
    wi, wo, _ = _flip_twosided(bl, wi, wo)
    out = torch.zeros(wi.shape[:-1], device=wi.device)
    for t in active_types:
        if t == DIFFUSE:
            v = _diffuse_pdf(bl, wi, wo)
        elif t == ROUGH_CONDUCTOR:
            v = _dist_mix(bl, lambda d: _rough_conductor_pdf(bl, d, wi, wo))
        else:
            continue
        out = torch.where(bl.type == t, v, out)
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
        if t == DIFFUSE:
            r = _diffuse_sample(bl, wi_f, u_lobe, u2)
        elif t == DIELECTRIC:
            r = _dielectric_sample(bl, wi_f, u_lobe, u2)
        else:
            r = _dist_mix(bl, lambda d: _rough_conductor_sample(
                bl, d, wi_f, u_lobe, u2))
        wo_, w_, p_, d_, e_ = r
        out = BsdfSample(
            wo=torch.where(sel[..., None], wo_, out.wo),
            weight=torch.where(sel[..., None], w_, out.weight),
            pdf=torch.where(sel, p_, out.pdf),
            is_delta=torch.where(sel, d_, out.is_delta),
            eta=torch.where(sel, e_, out.eta),
        )
    # un-flip wo for twosided backfaces
    return out._replace(wo=out.wo * zflip)
