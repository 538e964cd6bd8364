"""BSDFs with masked type dispatch (port of ``mitsuba_tpu/render/bsdf.py``:
the DIFFUSE lobe, the smooth DIELECTRIC, the ROUGH_CONDUCTOR microfacet lobe,
and the PLASTIC and ROUGH_PLASTIC two-lobe models).

Conventions follow the JAX package: unit directions in the local shading
frame (+Z = normal), ``wi`` toward the previous vertex; ``eval`` returns
f(wi, wo)·|cos θo|, ``pdf`` the solid-angle density of ``sample``, and
``sample`` (wo, weight = f·|cos θo|/pdf, pdf, is_delta, eta). Every type
present in the scene is evaluated for the whole batch and selected per lane
with ``where``; a rough lobe evaluates both microfacet distributions and
picks one per lane (``_dist_mix``). The smooth dielectric is a delta lobe:
``eval`` and ``pdf`` are 0 on it and only ``sample`` reaches it; so is the
smooth plastic's specular lobe, which ``sample`` chooses with the
probability ``_plastic_spec_prob``. The rough plastic's diffuse lobe reads
the rough-transmittance polynomial that the builder bakes per material
(``core/rtrans.py``). Other types land in a later slice.
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
PLASTIC = 4
ROUGH_PLASTIC = 5

SUPPORTED_TYPES = (DIFFUSE, DIELECTRIC, ROUGH_CONDUCTOR, PLASTIC,
                   ROUGH_PLASTIC)
# the types that read the scalar IOR, and those that read the plastic's
# columns (gathered only where such a lane can be)
_ETA_S_TYPES = (DIELECTRIC, PLASTIC, ROUGH_PLASTIC)
_PLASTIC_TYPES = (PLASTIC, ROUGH_PLASTIC)


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
    nonlinear: torch.Tensor   # (M,) bool: plastic internal-scattering mode
    # the rough-transmittance polynomial T(cos) of ROUGH_PLASTIC rows, low
    # order first, and the internal diffuse reflectance 1 - Tbar_int, both
    # baked at build (core/rtrans.py); zeros on other rows
    rt_coef: torch.Tensor     # (M, 6)
    rt_fdr: torch.Tensor      # (M,)


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
    # the dielectric's and the plastics' columns; None where no lane can
    # read them (the scene has no such type)
    spec_trans: torch.Tensor = None  # (R, 3) dielectric
    eta_s: torch.Tensor = None       # (R,) scalar IOR int/ext
    nonlinear: torch.Tensor = None   # (R,) bool, plastics
    rt_coef: torch.Tensor = None     # (R, 6) rough plastic
    rt_fdr: torch.Tensor = None      # (R,) rough plastic


class BsdfSample(NamedTuple):
    wo: torch.Tensor        # (R, 3)
    weight: torch.Tensor    # (R, 3) f*cos/pdf
    pdf: torch.Tensor       # (R,)
    is_delta: torch.Tensor  # (R,) bool
    eta: torch.Tensor       # (R,) relative IOR along the sampled lobe


def gather_locals(table: MaterialTable, mat_id, types,
                  albedo_override=None) -> BsdfLocals:
    """Per-lane parameters of materials ``mat_id``; ``albedo_override``
    (R, 3) replaces the table's albedo (a textured albedo). A column that
    only some types read is gathered only where ``types`` (the scene's
    ``bsdf_types``) holds one of them: every gather of a trainable column
    costs the training step a sorting backward."""
    mid = torch.clamp(mat_id, min=0).to(torch.int64)
    albedo = table.albedo[mid] if albedo_override is None else albedo_override
    eta_c = table.eta[mid]
    bl = BsdfLocals(type=table.type[mid], dist=table.dist[mid],
                    albedo=albedo, spec_refl=table.spec_refl[mid],
                    eta_c=eta_c, k_c=table.k[mid], alpha=table.alpha[mid],
                    twosided=table.twosided[mid])
    if DIELECTRIC in types:
        bl = bl._replace(spec_trans=table.spec_trans[mid])
    if any(t in types for t in _ETA_S_TYPES):
        bl = bl._replace(eta_s=eta_c[..., 0])
    if any(t in types for t in _PLASTIC_TYPES):
        bl = bl._replace(nonlinear=table.nonlinear[mid])
    if ROUGH_PLASTIC in types:
        bl = bl._replace(rt_coef=table.rt_coef[mid], rt_fdr=table.rt_fdr[mid])
    return bl


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


def _smooth_fresnel(bl, cos_i):
    return m.fresnel_dielectric(cos_i, bl.eta_s)[0]


def _rt_T(bl, cos_v):
    """The rough-transmittance polynomial T(cos) by Horner (rtrans.h eval
    role; coefficients baked at build, core/rtrans.py)."""
    c = torch.clamp(torch.abs(cos_v), 0.0, 1.0)
    acc = bl.rt_coef[..., 5]
    for k in (4, 3, 2, 1, 0):
        acc = acc * c + bl.rt_coef[..., k]
    return torch.clamp(acc, 0.0, 1.0)


def _lum(rgb):
    return (rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160
            + rgb[..., 2] * 0.072169)


def _plastic_parts(bl, wi, wo):
    """plastic.cpp: the diffuse base seen through the smooth interface,
    with the linear and the nonlinear internal-scattering denominators."""
    eta = bl.eta_s
    inv_eta2 = 1.0 / (eta * eta)
    fdr_int = m.fresnel_diffuse_reflectance(1.0 / eta)
    Fi = _smooth_fresnel(bl, wi[..., 2])
    Fo = _smooth_fresnel(bl, wo[..., 2])
    nonlinear_denom = 1.0 - bl.albedo * fdr_int[..., None]
    linear_denom = (1.0 - fdr_int)[..., None]
    diff = (bl.albedo
            * ((1.0 - Fi) * (1.0 - Fo) * inv_eta2)[..., None]
            * warp.INV_PI
            * torch.clamp(wo[..., 2], min=0.0)[..., None])
    return diff, linear_denom, nonlinear_denom, Fi


def _plastic_eval(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    diff, lin_d, nonlin_d, _ = _plastic_parts(bl, wi, wo)
    denom = torch.where(bl.nonlinear[..., None], nonlin_d, lin_d)
    f = diff / torch.clamp(denom, min=1e-6)
    return torch.where(ok[..., None], f, 0.0)


def _plastic_spec_prob(bl, wi):
    """Probability of the specular lobe (plastic.cpp's
    specularSamplingWeight): the Fresnel term of |cos θi| against the
    lobes' luminances."""
    Fi = _smooth_fresnel(bl, torch.abs(wi[..., 2]))
    spec_w = _lum(bl.spec_refl)
    diff_w = _lum(bl.albedo)
    total = spec_w + diff_w
    ssw = m.safe_div(spec_w, torch.clamp(total, min=1e-9))
    p = Fi * ssw
    q = (1.0 - Fi) * (1.0 - ssw)
    return m.safe_div(p, torch.clamp(p + q, min=1e-9))


def _plastic_pdf(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    p_spec = _plastic_spec_prob(bl, wi)
    pdf = (1.0 - p_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, pdf, 0.0)


def _plastic_sample(bl, wi, u_lobe, u2):
    """The specular reflection (a delta lobe) with probability p_spec, else
    a cosine-sampled diffuse direction."""
    ok = wi[..., 2] > 0
    p_spec = _plastic_spec_prob(bl, wi)
    choose_spec = u_lobe < p_spec
    Fi = _smooth_fresnel(bl, wi[..., 2])

    wo_spec = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
    w_spec = bl.spec_refl * m.safe_div(
        Fi, torch.clamp(p_spec, min=1e-9))[..., None]

    wo_diff = warp.square_to_cosine_hemisphere(u2)
    f_diff = _plastic_eval(bl, wi, wo_diff)
    pdf_diff = (1.0 - p_spec) * warp.square_to_cosine_hemisphere_pdf(wo_diff)
    w_diff = m.safe_div(f_diff, torch.clamp(pdf_diff, min=1e-9)[..., None])

    wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
    weight = torch.where(choose_spec[..., None], w_spec, w_diff)
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(choose_spec, p_spec, pdf_diff)
    return (wo, weight, torch.where(ok, pdf, 0.0), choose_spec,
            torch.ones(ok.shape, device=wi.device))


def _rough_plastic_eval(bl, dist: int, wi, wo):
    """roughplastic.cpp: an isotropic microfacet specular lobe (alpha_u)
    over the diffuse base, which the light reaches through the rough
    interface (the baked transmittance in place of 1 - F)."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    mh = m.normalize(wi + wo)
    au = bl.alpha[..., 0]
    D = mf.eval_d(dist, au, au, mh)
    G = mf.smith_g(dist, au, au, wi, wo, mh)
    F = _smooth_fresnel(bl, m.dot(wi, mh))
    spec = m.safe_div(D * G * F, 4.0 * wi[..., 2])
    f_spec = bl.spec_refl * spec[..., None]
    eta = bl.eta_s
    inv_eta2 = 1.0 / (eta * eta)
    T_i = _rt_T(bl, wi[..., 2])
    T_o = _rt_T(bl, wo[..., 2])
    denom = torch.where(bl.nonlinear[..., None],
                        1.0 - bl.albedo * bl.rt_fdr[..., None],
                        (1.0 - bl.rt_fdr)[..., None])
    f_diff = (bl.albedo * (T_i * T_o * inv_eta2)[..., None] * warp.INV_PI
              * torch.clamp(wo[..., 2], min=0.0)[..., None]
              / torch.clamp(denom, min=1e-6))
    return torch.where(ok[..., None], f_spec + f_diff, 0.0)


def _rough_plastic_pdf(bl, dist: int, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    p_spec = _plastic_spec_prob(bl, wi)
    mh = m.normalize(wi + wo)
    au = bl.alpha[..., 0]
    p_m = mf.pdf(dist, au, au, wi, mh)
    pdf_s = m.safe_div(p_m, 4.0 * torch.abs(m.dot(wo, mh)))
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, p_spec * pdf_s + (1.0 - p_spec) * pdf_d, 0.0)


def _rough_plastic_sample(bl, dist: int, wi, u_lobe, u2):
    """One of the two lobes by p_spec; the weight is f / pdf of the mixture
    (never a delta)."""
    ok = wi[..., 2] > 0
    p_spec = _plastic_spec_prob(bl, wi)
    choose_spec = u_lobe < p_spec
    au = bl.alpha[..., 0]
    mh, _ = mf.sample(dist, au, au, wi, u2)
    wo_spec = m.reflect(wi, mh)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
    pdf = _rough_plastic_pdf(bl, dist, wi, wo)
    f = _rough_plastic_eval(bl, dist, wi, wo)
    ok = ok & (pdf > 1e-12) & (wo[..., 2] > 0)
    weight = torch.where(ok[..., None], m.safe_div(
        f, torch.clamp(pdf, min=1e-12)[..., None]), 0.0)
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
        elif t == PLASTIC:
            v = _plastic_eval(bl, wi, wo)
        elif t == ROUGH_PLASTIC:
            v = _dist_mix(bl, lambda d: _rough_plastic_eval(bl, d, wi, wo))
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
        elif t == PLASTIC:
            v = _plastic_pdf(bl, wi, wo)
        elif t == ROUGH_PLASTIC:
            v = _dist_mix(bl, lambda d: _rough_plastic_pdf(bl, d, wi, wo))
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
        elif t == ROUGH_CONDUCTOR:
            r = _dist_mix(bl, lambda d: _rough_conductor_sample(
                bl, d, wi_f, u_lobe, u2))
        elif t == PLASTIC:
            r = _plastic_sample(bl, wi_f, u_lobe, u2)
        else:
            r = _dist_mix(bl, lambda d: _rough_plastic_sample(
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
