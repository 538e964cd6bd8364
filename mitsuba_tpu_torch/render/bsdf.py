"""BSDFs with masked type dispatch (port of ``mitsuba_tpu/render/bsdf.py``:
every single-layer type: the diffuse, rough diffuse (Oren-Nayar), Phong,
Ward, diffuse-transmitter and Hanrahan-Krueger lobes, the smooth and thin
dielectrics, the smooth conductor and the null pass-through as delta lobes,
the rough conductor and rough dielectric microfacet lobes, and the PLASTIC
and ROUGH_PLASTIC two-lobe models).

Conventions follow the JAX package: unit directions in the local shading
frame (+Z = normal), ``wi`` toward the previous vertex; ``eval`` returns
f(wi, wo)·|cos θo|, ``pdf`` the solid-angle density of ``sample``, and
``sample`` (wo, weight = f·|cos θo|/pdf, pdf, is_delta, eta). Every type
present in the scene is evaluated for the whole batch and selected per lane
with ``where``; a rough lobe evaluates both microfacet distributions and
picks one per lane (``_dist_mix``). The delta lobes are 0 in ``eval`` and
``pdf`` and only ``sample`` reaches them; so are the smooth plastic's
specular lobe, which ``sample`` chooses with the probability
``_plastic_spec_prob``, and the Hanrahan-Krueger slab's unscattered
transmission, chosen per lane with its luminance. The rough plastic's
diffuse lobe reads the rough-transmittance polynomial that the builder bakes
per material (``core/rtrans.py``).

The nested layer (mask, mixture, blend, coating and rough coating) takes
``nested=(bl_a, bl_b, ntypes)``: the locals of each lane's nested rows A
and B (``scene.bsdf_nested``) and the types they can hold. Nesting is one
level deep: nested rows dispatch through the base layer alone. The rough
coating reads the same baked transmittance as the rough plastic.

The Irawan-Marschner woven cloth (IRAWAN) reads per-lane yarn parameters
(``iw_par``, ``iw_ks``) that ``render/irawan.lane_params`` looks up from the
weave pattern at the hit's uv; it is sampled through the cosine lobe.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import frame as fr
from ..core import math as m
from ..core import warp
from ..core.frame import Frame
from . import microfacet as mf

# type tags, the JAX package's numbering
DIFFUSE = 0
DIELECTRIC = 1
CONDUCTOR = 2
ROUGH_CONDUCTOR = 3
PLASTIC = 4
ROUGH_PLASTIC = 5
ROUGH_DIELECTRIC = 6
THIN_DIELECTRIC = 7
ROUGH_DIFFUSE = 8   # Oren-Nayar
PHONG = 9
WARD = 10
NULL = 11
MASK = 12           # opacity-masked nested BSDF (mask.cpp)
MIXTURE = 13        # w A + (1 - w) B, constant weight (mixturebsdf.cpp)
BLEND = 14          # the same with a textured weight (blendbsdf.cpp)
DIFFTRANS = 15      # diffuse transmitter (difftrans.cpp)
COATING = 16        # smooth dielectric layer over nested A (coating.cpp)
HK = 17             # Hanrahan-Krueger single-scattering slab (hk.cpp)
ROUGHCOATING = 18   # rough dielectric layer over nested A (roughcoating.cpp)
IRAWAN = 19         # Irawan-Marschner woven cloth (irawan.cpp)

# the types whose rows reference other rows through nested_a / nested_b
NESTED_TYPES = (MASK, MIXTURE, BLEND, COATING, ROUGHCOATING)
SUPPORTED_TYPES = (DIFFUSE, DIELECTRIC, CONDUCTOR, ROUGH_CONDUCTOR, PLASTIC,
                   ROUGH_PLASTIC, ROUGH_DIELECTRIC, THIN_DIELECTRIC,
                   ROUGH_DIFFUSE, PHONG, WARD, NULL, DIFFTRANS, HK,
                   IRAWAN) + NESTED_TYPES
# the types that read each column that only some types read (gathered only
# where such a lane can be)
_SPEC_TRANS_TYPES = (DIELECTRIC, ROUGH_DIELECTRIC, THIN_DIELECTRIC,
                     DIFFTRANS)
_ETA_S_TYPES = (DIELECTRIC, PLASTIC, ROUGH_PLASTIC, ROUGH_DIELECTRIC,
                THIN_DIELECTRIC, COATING, ROUGHCOATING)
_PLASTIC_TYPES = (PLASTIC, ROUGH_PLASTIC)
_RT_TYPES = (ROUGH_PLASTIC, ROUGHCOATING)
_BLEND_TYPES = (MIXTURE, BLEND)


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
    # the rough-transmittance polynomial T(cos) of ROUGH_PLASTIC and
    # ROUGHCOATING rows, low order first, and the internal diffuse
    # reflectance 1 - Tbar_int, both baked at build (core/rtrans.py); zeros
    # on other rows
    rt_coef: torch.Tensor     # (M, 6)
    rt_fdr: torch.Tensor      # (M,)
    # the HK slab's thickness and Henyey-Greenstein g (its k column holds
    # sigma_t, its albedo sigma_s)
    hk_thickness: torch.Tensor  # (M,)
    hk_g: torch.Tensor          # (M,)
    # the nested layer (a coating's k column holds sigma_a * thickness) and
    # the maps; a texture or row id is -1 where there is none
    opacity_tex: torch.Tensor   # (M,) int32 mask opacity texture
    nested_a: torch.Tensor      # (M,) int32 nested row A
    nested_b: torch.Tensor      # (M,) int32 nested row B (mixture, blend)
    weight: torch.Tensor        # (M,) mixture weight of A
    weight_tex: torch.Tensor    # (M,) int32 blend weight texture
    normal_tex: torch.Tensor    # (M,) int32 tangent-space normal map
    bump_tex: torch.Tensor      # (M,) int32 bump map height texture
    bump_scale: torch.Tensor    # (M,) bump height scale
    # the Cauchy dispersion coefficient B (um^2), which the spectral render
    # reads: eta(l) = eta + B (1 / l^2 - 1 / 0.5893^2)
    cauchy_b: torch.Tensor      # (M,)
    irawan: torch.Tensor        # (M,) int32 weave pattern (-1: none)


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
    # the columns that only some types read; None where no lane can read
    # them (the scene has no such type)
    spec_trans: torch.Tensor = None  # (R, 3) dielectrics, difftrans
    eta_s: torch.Tensor = None       # (R,) scalar IOR int/ext
    nonlinear: torch.Tensor = None   # (R,) bool, plastics
    rt_coef: torch.Tensor = None     # (R, 6) rough plastic
    rt_fdr: torch.Tensor = None      # (R,) rough plastic
    hk_thickness: torch.Tensor = None  # (R,) HK
    hk_g: torch.Tensor = None          # (R,) HK
    opacity: torch.Tensor = None       # (R,) mask opacity (1: present)
    blend_w: torch.Tensor = None       # (R,) mixture / blend weight of A
    # irawan: the yarn segment at the lane's uv (render/irawan.py layout:
    # is_weft, psi, umax, kappa, width, length, x, y, alpha, beta, ss,
    # hwidth, specular normalization x area ratio) and its specular colour;
    # gathered by scene.bsdf_locals / bsdf_nested, not by gather_locals
    iw_par: torch.Tensor = None        # (R, 13)
    iw_ks: torch.Tensor = None         # (R, 3)


class BsdfSample(NamedTuple):
    wo: torch.Tensor        # (R, 3)
    weight: torch.Tensor    # (R, 3) f*cos/pdf
    pdf: torch.Tensor       # (R,)
    is_delta: torch.Tensor  # (R,) bool
    eta: torch.Tensor       # (R,) relative IOR along the sampled lobe


def gather_locals(table: MaterialTable, mat_id, types,
                  albedo_override=None, opacity_override=None,
                  blend_override=None) -> BsdfLocals:
    """Per-lane parameters of materials ``mat_id``; ``albedo_override``
    (R, 3) replaces the table's albedo (a textured albedo), and
    ``opacity_override`` and ``blend_override`` (R,) the opacity of 1 and
    the table's weight (textured ones). A column that only some types read
    is gathered only where ``types`` (the scene's ``bsdf_types``, or the
    nested rows' types) holds one of them: every gather of a trainable
    column costs the training step a sorting backward."""
    mid = torch.clamp(mat_id, min=0).to(torch.int64)
    albedo = table.albedo[mid] if albedo_override is None else albedo_override
    eta_c = table.eta[mid]
    bl = BsdfLocals(type=table.type[mid], dist=table.dist[mid],
                    albedo=albedo, spec_refl=table.spec_refl[mid],
                    eta_c=eta_c, k_c=table.k[mid], alpha=table.alpha[mid],
                    twosided=table.twosided[mid])
    if any(t in types for t in _SPEC_TRANS_TYPES):
        bl = bl._replace(spec_trans=table.spec_trans[mid])
    if any(t in types for t in _ETA_S_TYPES):
        bl = bl._replace(eta_s=eta_c[..., 0])
    if any(t in types for t in _PLASTIC_TYPES):
        bl = bl._replace(nonlinear=table.nonlinear[mid])
    if any(t in types for t in _RT_TYPES):
        bl = bl._replace(rt_coef=table.rt_coef[mid], rt_fdr=table.rt_fdr[mid])
    if HK in types:
        bl = bl._replace(hk_thickness=table.hk_thickness[mid],
                         hk_g=table.hk_g[mid])
    if MASK in types:
        bl = bl._replace(opacity=(torch.ones(mid.shape, device=mid.device)
                                  if opacity_override is None
                                  else opacity_override))
    if any(t in types for t in _BLEND_TYPES):
        bl = bl._replace(blend_w=(table.weight[mid] if blend_override is None
                                  else blend_override))
    return bl


def _check_types(types):
    for t in types:
        if t not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {t} lands in a later slice of the port")


def _mirror(wi):
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def _z_scale(sgn):
    """(1, 1, sgn) per lane: scales a direction's z by ``sgn``."""
    return torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn],
                       dim=-1)


def _flip_twosided(bl: BsdfLocals, wi, wo=None):
    """twosided.cpp: when the incident ray arrives from below, flip the frame
    so one-sided models see the upper hemisphere. The dielectric has two
    sides by nature and is never flipped (the JAX loader never marks it
    two-sided; a row the builder marks so keeps its side here too). Every
    other two-sided row flips, as in the JAX package."""
    flip = bl.twosided & (wi[..., 2] < 0.0) & (bl.type != DIELECTRIC)
    zflip = _z_scale(torch.where(flip, -1.0, 1.0))
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


def _rough_diffuse_eval(bl, wi, wo):
    """Oren-Nayar's qualitative model (roughdiffuse.cpp fast mode), sigma =
    alpha / sqrt(2) as the reference converts it. Sampled through the
    cosine lobe."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    sigma = bl.alpha[..., 0] * 0.70710678
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    st_i, st_o = fr.sin_theta(wi), fr.sin_theta(wo)
    cos_dphi = (fr.cos_phi(wi) * fr.cos_phi(wo)
                + fr.sin_phi(wi) * fr.sin_phi(wo))
    sin_alpha = torch.maximum(st_i, st_o)
    tan_beta = torch.minimum(m.safe_div(st_i, torch.abs(wi[..., 2])),
                             m.safe_div(st_o, torch.abs(wo[..., 2])))
    val = a + b * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta
    f = bl.albedo * (warp.INV_PI * val
                     * torch.clamp(wo[..., 2], min=0.0))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _rough_diffuse_sample(bl, wi, u_lobe, u2):
    wo, _, pdf, is_delta, eta = _diffuse_sample(bl, wi, u_lobe, u2)
    f = _rough_diffuse_eval(bl, wi, wo)
    weight = m.safe_div(f, torch.clamp(pdf, min=1e-9)[..., None])
    return wo, weight, pdf, is_delta, eta


def _dielectric_sample(bl, wi, u_lobe, u2):
    """Smooth dielectric (dielectric.cpp): reflect or refract, chosen by
    Fresnel. Two-sided by nature: the side comes from the sign of cos θi."""
    ci = wi[..., 2]
    F, cos_t = m.fresnel_dielectric(ci, bl.eta_s)
    reflect = u_lobe < F
    wo_r = _mirror(wi)
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


def _thin_dielectric_sample(bl, wi, u_lobe, u2):
    """thindielectric.cpp: a thin slab. The internal bounces fold into
    R' = 2F / (1 + F); the transmission leaves the direction unchanged
    (wo = -wi, eta 1)."""
    ci = torch.abs(wi[..., 2])
    F, _ = m.fresnel_dielectric(ci, bl.eta_s)
    R = torch.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
    reflect = u_lobe < R
    wo_r = _mirror(wi)
    wo = torch.where(reflect[..., None], wo_r, -wi)
    weight = torch.where(reflect[..., None], bl.spec_refl, bl.spec_trans)
    pdf = torch.where(reflect, R, 1.0 - R)
    return (wo, weight, torch.clamp(pdf, min=1e-12),
            torch.ones(ci.shape, dtype=torch.bool, device=wi.device),
            torch.ones(ci.shape, device=wi.device))


def _conductor_sample(bl, wi, u_lobe, u2):
    """conductor.cpp: the mirror direction, tinted by the conductor's
    Fresnel term."""
    ok = wi[..., 2] > 0
    wo = _mirror(wi)
    F = m.fresnel_conductor(wi[..., 2], bl.eta_c, bl.k_c)
    weight = torch.where(ok[..., None], bl.spec_refl * F, 0.0)
    return (wo, weight, torch.where(ok, 1.0, 0.0),
            torch.ones(ok.shape, dtype=torch.bool, device=wi.device),
            torch.ones(ok.shape, device=wi.device))


def _null_sample(bl, wi, u_lobe, u2):
    """null.cpp: the ray passes through unchanged."""
    sh = wi.shape[:-1]
    dev = wi.device
    return (-wi, torch.ones(sh + (3,), device=dev), torch.ones(sh, device=dev),
            torch.ones(sh, dtype=torch.bool, device=dev),
            torch.ones(sh, device=dev))


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

    wo_spec = _mirror(wi)
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


def _dielectric_half_vector(bl, wi, wo):
    """The rough dielectric's half vector, turned into the upper hemisphere:
    the standard one for a reflection, the generalized one for a
    refraction. Returns (mh, is_reflect, rel_eta)."""
    ci, co = wi[..., 2], wo[..., 2]
    is_reflect = ci * co > 0
    rel_eta = torch.where(ci > 0, bl.eta_s, 1.0 / bl.eta_s)
    mh_r = m.normalize(wi + wo)
    mh_t = m.normalize(-(wi + wo * rel_eta[..., None]))
    mh = torch.where(is_reflect[..., None], mh_r, mh_t)
    return mh * torch.sign(mh[..., 2:3]), is_reflect, rel_eta


def _rough_dielectric_eval(bl, dist: int, wi, wo):
    """roughdielectric.cpp: D G F / (4 |cos θi|) in reflection, the
    generalized half vector's transmission term with the 1/eta^2 radiance
    scale in refraction. mh is upper-oriented, so dot(wi, mh) is the signed
    cosine: negative from inside, where the Fresnel term takes 1/eta."""
    au, av = bl.alpha[..., 0], bl.alpha[..., 1]
    ci = wi[..., 2]
    mh, is_reflect, rel_eta = _dielectric_half_vector(bl, wi, wo)
    D = mf.eval_d(dist, au, av, mh)
    G = mf.smith_g(dist, au, av, wi, wo, mh)
    F = _smooth_fresnel(bl, m.dot(wi, mh))
    f_r = m.safe_div(D * G * F, 4.0 * torch.abs(ci))
    dot_i, dot_o = m.dot(wi, mh), m.dot(wo, mh)
    sqrt_denom = dot_i + rel_eta * dot_o
    f_t = m.safe_div(
        (1.0 - F) * D * G * torch.abs(dot_i * dot_o) * rel_eta * rel_eta,
        torch.abs(ci) * sqrt_denom * sqrt_denom)
    f_t = f_t / (rel_eta * rel_eta)
    f = torch.where(is_reflect, f_r, f_t)
    tint = torch.where(is_reflect[..., None], bl.spec_refl, bl.spec_trans)
    return tint * torch.clamp(f, min=0.0)[..., None]


def _rough_dielectric_pdf(bl, dist: int, wi, wo):
    """The density of ``_rough_dielectric_sample``, with the physical
    checks that eval gets through Smith's G: wi sees the front of the
    microfacet, and a reflection keeps wo on wi's side of mh while a
    refraction crosses it."""
    au, av = bl.alpha[..., 0], bl.alpha[..., 1]
    ci = wi[..., 2]
    mh, is_reflect, rel_eta = _dielectric_half_vector(bl, wi, wo)
    wi_up = wi * torch.sign(ci)[..., None]
    p_m = mf.pdf(dist, au, av, wi_up, mh)
    F = _smooth_fresnel(bl, m.dot(wi, mh))
    dot_i, dot_o = m.dot(wi, mh), m.dot(wo, mh)
    front = dot_i * ci > 0
    side = torch.where(is_reflect, dot_i * dot_o > 0, dot_i * dot_o < 0)
    jac_r = m.safe_div(1.0, 4.0 * torch.abs(dot_o))
    sqrt_denom = dot_i + rel_eta * dot_o
    jac_t = m.safe_div(rel_eta * rel_eta * torch.abs(dot_o),
                       sqrt_denom * sqrt_denom)
    prob = torch.where(is_reflect, F, 1.0 - F)
    pdf_val = prob * p_m * torch.where(is_reflect, jac_r, jac_t)
    return torch.where(front & side, torch.clamp(pdf_val, min=0.0), 0.0)


def _rough_dielectric_sample(bl, dist: int, wi, u_lobe, u2):
    """A visible normal from wi's side, then reflect or refract about it,
    chosen by its Fresnel term; never a delta."""
    au, av = bl.alpha[..., 0], bl.alpha[..., 1]
    eta = bl.eta_s
    ci = wi[..., 2]
    sgn = torch.sign(ci)[..., None]
    mh_up, _ = mf.sample(dist, au, av, wi * sgn, u2)
    mh = mh_up * sgn  # back to wi's hemisphere
    F, _ = m.fresnel_dielectric(m.dot(wi, mh) * torch.sign(ci), eta)
    reflect = u_lobe < F
    wo_r = m.reflect(wi, mh)
    rel_eta = torch.where(ci > 0, eta, 1.0 / eta)
    valid_t, wo_t = m.refract(wi, mh, rel_eta)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    eta_ratio = torch.where(reflect, 1.0, rel_eta)
    pdf = _rough_dielectric_pdf(bl, dist, wi, wo)
    f = _rough_dielectric_eval(bl, dist, wi, wo)
    # a reflection stays on wi's side, a refraction crosses
    side_ok = torch.where(reflect, ci * wo[..., 2] > 0, ci * wo[..., 2] < 0)
    ok = (pdf > 1e-12) & side_ok & (reflect | valid_t)
    weight = torch.where(ok[..., None], m.safe_div(
        f, torch.clamp(pdf, min=1e-12)[..., None]), 0.0)
    return (wo, weight, torch.where(ok, pdf, 0.0),
            torch.zeros(ok.shape, dtype=torch.bool, device=wi.device),
            torch.where(ok, eta_ratio, 1.0))


def _glossy_prob(bl):
    """The probability of a glossy model's specular lobe: its share of the
    two lobes' luminance (phong.cpp, ward.cpp)."""
    spec_w = _lum(bl.spec_refl)
    diff_w = _lum(bl.albedo)
    return m.safe_div(spec_w, torch.clamp(spec_w + diff_w, min=1e-9))


def _phong_exponent(bl):
    """The loader stores Phong's exponent as alpha = sqrt(2 / (n + 2))."""
    a = torch.clamp(bl.alpha[..., 0], min=1e-4)
    return torch.clamp(2.0 / (a * a) - 2.0, min=1.0)


def _phong_eval(bl, wi, wo):
    """phong.cpp: the normalized cos^n lobe about the mirror direction over
    a Lambertian base."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    n = _phong_exponent(bl)
    cos_a = torch.clamp(m.dot(wo, _mirror(wi)), min=0.0)
    spec = bl.spec_refl * ((n + 2.0) * warp.INV_TWOPI
                           * torch.pow(cos_a, n))[..., None]
    diff = bl.albedo * warp.INV_PI
    f = (spec + diff) * torch.clamp(wo[..., 2], min=0.0)[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _phong_pdf(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    n = _phong_exponent(bl)
    cos_a = torch.clamp(m.dot(wo, _mirror(wi)), min=0.0)
    ps = _glossy_prob(bl)
    pdf_s = (n + 1.0) * warp.INV_TWOPI * torch.pow(cos_a, n)
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, ps * pdf_s + (1.0 - ps) * pdf_d, 0.0)


def _phong_sample(bl, wi, u_lobe, u2):
    """The cos^n lobe about the mirror direction, or the cosine lobe; the
    weight is f / pdf of the mixture."""
    ok = wi[..., 2] > 0
    n = _phong_exponent(bl)
    choose_spec = u_lobe < _glossy_prob(bl)
    ct = torch.pow(torch.clamp(u2[..., 0], 1e-7, 1.0), 1.0 / (n + 1.0))
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * u2[..., 1]
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct],
                        dim=-1)
    wo_spec = Frame.from_normal(_mirror(wi)).to_world(local)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
    return _mixture_sample(bl, wi, wo, ok, _phong_pdf, _phong_eval)


def _mixture_sample(bl, wi, wo, ok, pdf_fn, eval_fn):
    """(wo, f / pdf, pdf, no delta, eta 1) of a two-lobe model's sampled
    direction, dead where the pdf is 0 or wo lies below the surface."""
    pdf = pdf_fn(bl, wi, wo)
    f = eval_fn(bl, wi, wo)
    ok = ok & (pdf > 1e-12) & (wo[..., 2] > 0)
    weight = torch.where(ok[..., None], m.safe_div(
        f, torch.clamp(pdf, min=1e-12)[..., None]), 0.0)
    return (wo, weight, torch.where(ok, pdf, 0.0),
            torch.zeros(ok.shape, dtype=torch.bool, device=wi.device),
            torch.ones(ok.shape, device=wi.device))


def _ward_alpha(bl):
    return (torch.clamp(bl.alpha[..., 0], min=1e-4),
            torch.clamp(bl.alpha[..., 1], min=1e-4))


def _ward_spec(bl, wi, wo):
    """The anisotropic Ward-Duer specular term (ward.cpp, variant 'ward'),
    without the cosine: alpha_u along the frame's s, alpha_v along t."""
    au, av = _ward_alpha(bl)
    h = wi + wo
    hz2 = h[..., 2] * h[..., 2]
    exponent = -m.safe_div((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2,
                           torch.clamp(hz2, min=1e-12))
    ci, co = wi[..., 2], wo[..., 2]
    denom = 4.0 * math.pi * au * av * m.sqrt(torch.clamp(ci * co, min=1e-12))
    return m.safe_div(torch.exp(exponent), denom)


def _ward_eval(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    spec = bl.spec_refl * _ward_spec(bl, wi, wo)[..., None]
    diff = bl.albedo * warp.INV_PI
    f = (spec + diff) * torch.clamp(wo[..., 2], min=0.0)[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _ward_pdf_spec(bl, wi, wo):
    """The half vector's Gaussian density, mapped to wo: p(h) = exp(.) /
    (pi au av hz^3), dwo = 4 (h.wi) dh."""
    au, av = _ward_alpha(bl)
    h = m.normalize(wi + wo)
    hz = torch.clamp(h[..., 2], min=1e-6)
    exponent = -((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) / (hz * hz)
    p_h = m.safe_div(torch.exp(exponent), math.pi * au * av * hz ** 3)
    return m.safe_div(p_h, 4.0 * torch.abs(m.dot(h, wi)))


def _ward_pdf(bl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ps = _glossy_prob(bl)
    pdf = (ps * _ward_pdf_spec(bl, wi, wo)
           + (1.0 - ps) * warp.square_to_cosine_hemisphere_pdf(wo))
    return torch.where(ok, pdf, 0.0)


def _ward_sample(bl, wi, u_lobe, u2):
    """ward.cpp's half-vector sampling: the azimuth remapped for the
    anisotropy, then the Gaussian's tan^2 θh; or the cosine lobe."""
    ok = wi[..., 2] > 0
    au, av = _ward_alpha(bl)
    choose_spec = u_lobe < _glossy_prob(bl)
    phi = 2.0 * math.pi * u2[..., 1]
    cp, sp = torch.cos(phi), torch.sin(phi)
    phi_h = torch.atan2(av * sp, au * cp)
    cph, sph = torch.cos(phi_h), torch.sin(phi_h)
    t2 = (-torch.log(torch.clamp(u2[..., 0], min=1e-9))
          / ((cph / au) ** 2 + (sph / av) ** 2))
    ct = 1.0 / m.sqrt(1.0 + t2)
    st = m.safe_sqrt(1.0 - ct * ct)
    h = torch.stack([st * cph, st * sph, ct], dim=-1)
    wo_spec = m.reflect(wi, h)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
    return _mixture_sample(bl, wi, wo, ok, _ward_pdf, _ward_eval)


def _difftrans_eval(bl, wi, wo):
    """difftrans.cpp: a Lambertian lobe into the opposite hemisphere,
    tinted by the transmittance (the spec_trans column)."""
    ok = wi[..., 2] * wo[..., 2] < 0
    f = bl.spec_trans * (warp.INV_PI * torch.abs(wo[..., 2]))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _difftrans_pdf(bl, wi, wo):
    ok = wi[..., 2] * wo[..., 2] < 0
    return torch.where(ok, warp.INV_PI * torch.abs(wo[..., 2]), 0.0)


def _difftrans_sample(bl, wi, u_lobe, u2):
    wo_up = warp.square_to_cosine_hemisphere(u2)
    # into the hemisphere opposite wi
    wo = wo_up * _z_scale(-torch.sign(wi[..., 2]))
    pdf = warp.INV_PI * torch.abs(wo[..., 2])
    sh = wi.shape[:-1]
    return (wo, bl.spec_trans, torch.clamp(pdf, min=1e-12),
            torch.zeros(sh, dtype=torch.bool, device=wi.device),
            torch.ones(sh, device=wi.device))


def _hg_phase(g, cos_t):
    """The Henyey-Greenstein phase function."""
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * cos_t, min=1e-6)
    return warp.INV_FOURPI * (1.0 - g2) / (denom * m.sqrt(denom))


def _hk_parts(bl, wi, wo):
    """hk.cpp's single scattering in a slab of optical depth tau = sigma_t
    * thickness (sigma_s in the albedo column, sigma_t in k): f without the
    cosine, reflection or transmission by the sides of wi and wo. The
    transmission's 0/0 where mu_i = mu_o takes its limit."""
    sig_s = bl.albedo
    sig_t = torch.clamp(bl.k_c, min=1e-9)
    alb = sig_s / sig_t
    tau = sig_t * bl.hk_thickness[..., None]
    mu_i = torch.clamp(torch.abs(wi[..., 2]), min=1e-6)[..., None]
    mu_o = torch.clamp(torch.abs(wo[..., 2]), min=1e-6)[..., None]
    # the angle between the transport directions
    p = _hg_phase(bl.hk_g, m.dot(-wi, wo))[..., None]
    refl = (wi[..., 2] * wo[..., 2] > 0)[..., None]
    f_r = alb * p * m.safe_div(
        1.0 - torch.exp(-tau * (1.0 / mu_i + 1.0 / mu_o)), mu_i + mu_o)
    same_mu = torch.abs(mu_i - mu_o) < 1e-4
    f_t_gen = alb * p * m.safe_div(
        torch.exp(-tau / mu_i) - torch.exp(-tau / mu_o),
        mu_i - torch.where(same_mu, mu_i + 1.0, mu_o))
    f_t_lim = alb * p * tau * torch.exp(-tau / mu_i) / (mu_i * mu_i)
    f_t = torch.where(same_mu, f_t_lim, f_t_gen)
    return torch.where(refl, f_r, torch.clamp(f_t, min=0.0))


def _hk_eval(bl, wi, wo):
    ok = torch.abs(wi[..., 2]) > 1e-6
    f = _hk_parts(bl, wi, wo) * torch.abs(wo[..., 2])[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _hk_delta_t(bl, wi):
    """The slab's unscattered transmission exp(-tau / mu_i)."""
    sig_t = torch.clamp(bl.k_c, min=1e-9)
    tau = sig_t * bl.hk_thickness[..., None]
    mu_i = torch.clamp(torch.abs(wi[..., 2]), min=1e-6)[..., None]
    return torch.exp(-tau / mu_i)


def _hk_delta_prob(Tr):
    return torch.clamp(_lum(Tr), 0.0, 0.9)


def _hk_pdf_smooth(wo):
    # the cosine lobe on either side, half and half
    return 0.5 * warp.INV_PI * torch.abs(wo[..., 2])


def _hk_pdf(bl, wi, wo):
    p_delta = _hk_delta_prob(_hk_delta_t(bl, wi))
    return (1.0 - p_delta) * _hk_pdf_smooth(wo)


def _hk_sample(bl, wi, u_lobe, u2):
    """The unscattered transmission (a delta, wo = -wi) with probability
    p_delta, else a cosine direction on a side picked by the rest of
    u_lobe: is_delta varies per lane."""
    Tr = _hk_delta_t(bl, wi)
    p_delta = _hk_delta_prob(Tr)
    choose_delta = u_lobe < p_delta

    wo_up = warp.square_to_cosine_hemisphere(u2)
    u_side = m.safe_div(u_lobe - p_delta, torch.clamp(1.0 - p_delta, min=1e-9))
    sgn = torch.where(u_side < 0.5, 1.0, -1.0) * torch.sign(wi[..., 2])
    wo_s = wo_up * _z_scale(sgn)
    pdf_s = (1.0 - p_delta) * _hk_pdf_smooth(wo_s)
    f_s = _hk_eval(bl, wi, wo_s)
    w_s = m.safe_div(f_s, torch.clamp(pdf_s, min=1e-9)[..., None])
    w_d = Tr / torch.clamp(p_delta, min=1e-9)[..., None]

    wo = torch.where(choose_delta[..., None], -wi, wo_s)
    weight = torch.where(choose_delta[..., None], w_d, w_s)
    pdf = torch.where(choose_delta, p_delta, pdf_s)
    return (wo, weight, torch.clamp(pdf, min=1e-12), choose_delta,
            torch.ones(wi.shape[:-1], device=wi.device))


def _rdiv(s: float, x):
    """s / x, divided (``s / tensor`` in PyTorch multiplies by the
    reciprocal)."""
    return torch.div(torch.full_like(x, s), x)


def _irawan_radius_of_curvature(u, umax, kappa, w, l):
    """Radius of curvature of the yarn's spine (irawan.cpp:551-587, Irawan's
    thesis 5.3: a circle, ellipse, hyperbola or parabola by rhat), every
    branch evaluated and one selected per lane."""
    rhat = 1.0 + kappa * (1.0 + _rdiv(1.0, torch.tan(umax)))
    a = 0.5 * w
    sin_umax = torch.sin(umax)
    half = 0.5 * l - a * sin_umax
    # circle
    R_circ = m.safe_div(half, sin_umax)
    # ellipse (rhat > 0)
    rh_e = torch.where(rhat > 0, rhat, 1.0)
    tmax_e = torch.atan(rh_e * torch.tan(umax))
    bhat_e = m.safe_div(half, torch.clamp(torch.sin(tmax_e), min=1e-9))
    ahat_e = m.safe_div(bhat_e, rh_e)
    t_e = torch.atan(rh_e * torch.tan(u))
    c_e, s_e = torch.cos(t_e), torch.sin(t_e)
    R_ell = m.safe_div(torch.pow(
        bhat_e * bhat_e * (c_e * c_e) + ahat_e * ahat_e * (s_e * s_e), 1.5),
        ahat_e * bhat_e)
    # hyperbola (rhat < 0)
    rh_h = torch.where(rhat < 0, rhat, -1.0)
    arg_h = torch.clamp(rh_h * torch.tan(umax), -1.0 + 1e-6, 1.0 - 1e-6)
    tmax_h = -torch.atanh(arg_h)
    bhat_h = m.safe_div(half, torch.clamp(torch.sinh(tmax_h), min=1e-9))
    ahat_h = m.safe_div(bhat_h, rh_h)
    arg_u = torch.clamp(rh_h * torch.tan(u), -1.0 + 1e-6, 1.0 - 1e-6)
    t_h = -torch.atanh(arg_u)
    c_h, s_h = torch.cosh(t_h), torch.sinh(t_h)
    R_hyp = -m.safe_div(torch.pow(
        bhat_h * bhat_h * (c_h * c_h) + ahat_h * ahat_h * (s_h * s_h), 1.5),
        ahat_h * bhat_h)
    # parabola (rhat == 0)
    tm_p = torch.tan(umax)
    ahat_p = m.safe_div(half, 2.0 * torch.clamp(tm_p, min=1e-9))
    t_p = torch.tan(u)
    R_par = 2.0 * ahat_p * torch.pow(1.0 + t_p * t_p, 1.5)
    return torch.where(torch.abs(rhat - 1.0) < 1e-6, R_circ,
                       torch.where(rhat > 0, R_ell,
                                   torch.where(rhat < 0, R_hyp, R_par)))


def _irawan_von_mises(cos_x, b):
    """The von Mises density on the circle (irawan.cpp:588-606; Abramowitz
    and Stegun's polynomials for I0)."""
    ab = torch.abs(b)
    q = ab / 3.75
    t_s = q * q
    i0_small = 1.0 + t_s * (3.5156229 + t_s * (3.0899424 + t_s * (
        1.2067492 + t_s * (0.2659732 + t_s * (0.0360768 + t_s * 0.0045813)))))
    t_l = _rdiv(3.75, torch.clamp(ab, min=1e-6))
    i0_large = torch.exp(ab) / m.sqrt(torch.clamp(ab, min=1e-6)) * (
        0.39894228 + t_l * (0.01328592 + t_l * (0.00225319 + t_l * (
            -0.00157565 + t_l * (0.00916281 + t_l * (-0.02057706 + t_l * (
                0.02635537 + t_l * (-0.01647633 + t_l * 0.00392377))))))))
    i0 = torch.where(ab <= 3.75, i0_small, i0_large)
    return torch.exp(b * cos_x) / (2.0 * math.pi * i0)


def _irawan_seeliger(c1, c2):
    """Lommel-Seeliger attenuation with albedo 1 (irawan.cpp:608-615)."""
    c1 = torch.clamp(c1, min=0.0)
    c2 = torch.clamp(c2, min=0.0)
    return torch.where((c1 > 0) & (c2 > 0),
                       m.safe_div(c1 * c2, 4.0 * math.pi * (c1 + c2)), 0.0)


def _smoothstep01(x):
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _irawan_eval(bl, wi, wo):
    """The Irawan-Marschner woven-cloth BRDF (irawan.cpp eval:230-320, with
    evalFilamentIntegrand:390 and evalStapleIntegrand:482) times cos(wo):
    kd / pi plus the yarn segment's specular integrand (a filament yarn
    where psi = 0, a staple yarn otherwise), scaled by ks and the pattern's
    normalization. A weft segment sees the frame turned by pi / 2 about z."""
    p = bl.iw_par
    is_weft = p[..., 0] > 0.5
    psi = p[..., 1]
    umax = torch.clamp(p[..., 2], min=1e-4)
    kappa = p[..., 3]
    w = torch.clamp(p[..., 4], min=1e-6)
    l = torch.clamp(p[..., 5], min=1e-6)
    x = p[..., 6]
    y = p[..., 7]
    alpha = p[..., 8]
    beta = p[..., 9]
    ss = p[..., 10]
    hwidth = torch.clamp(p[..., 11], min=1e-4)
    snorm = p[..., 12]

    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)

    def rot(v):
        return torch.stack([-v[..., 1], v[..., 0], v[..., 2]], dim=-1)

    om_i = torch.where(is_weft[..., None], rot(wi), wi)
    om_r = torch.where(is_weft[..., None], rot(wo), wo)
    xx = torch.where(is_weft, -y, x)
    yy = torch.where(is_weft, x, y)

    u = yy / (l / 2.0) * umax
    v = xx * math.pi / w

    h = m.normalize(om_i + om_r)
    len_ir = m.length(om_i + om_r)
    geom_ok = (w * torch.sin(umax) < l) & (kappa > -1.0)

    # --- the filament integrand (psi == 0) ---
    u_of_v = torch.atan(m.safe_div(h[..., 1], torch.clamp(
        torch.abs(h[..., 2]), min=1e-9)) * torch.sign(h[..., 2]))
    in_rng_f = torch.abs(u_of_v) < umax
    n_f = m.normalize(torch.stack([
        torch.sin(v), torch.sin(u_of_v) * torch.cos(v),
        torch.cos(u_of_v) * torch.cos(v)], dim=-1))
    t_f = m.normalize(torch.stack([
        torch.zeros_like(u_of_v), torch.cos(u_of_v), -torch.sin(u_of_v)],
        dim=-1))
    ss_c = torch.clamp(ss, 0.0, 1.0 - 1e-4)
    R_f = _irawan_radius_of_curvature(
        torch.minimum(torch.abs(u_of_v), (1 - ss_c) * umax),
        (1 - ss_c) * umax, kappa, w, l)
    a_half = 0.5 * w
    t_cross_h = m.cross(t_f, h)
    Gu = m.safe_div(a_half * (R_f + a_half * torch.cos(v)),
                    len_ir * torch.clamp(torch.abs(t_cross_h[..., 0]),
                                         min=1e-9))
    fc = alpha + _irawan_von_mises(-m.dot(om_i, om_r), beta)
    A_f = _irawan_seeliger(m.dot(n_f, om_i), m.dot(n_f, om_r))
    As = torch.where(
        ss_c > 0,
        A_f * (1.0 - _smoothstep01(m.safe_div(
            torch.abs(u_of_v) - (1.0 - ss_c) * umax,
            torch.clamp(ss_c * umax, min=1e-9)))),
        A_f)
    fs_f = Gu * fc * As * math.pi * l
    delta_y = l * hwidth
    y_of_v = torch.clamp(u_of_v * 0.5 * l / umax,
                         0.5 * (delta_y - l), 0.5 * (l - delta_y))
    hit_f = torch.abs(y_of_v - u * 0.5 * l / umax) < 0.5 * delta_y
    filament = torch.where(in_rng_f & hit_f & geom_ok,
                           m.safe_div(fs_f, delta_y), 0.0)

    # --- the staple integrand (psi != 0) ---
    psi_s = torch.where(torch.abs(psi) > 1e-6, psi, 1.0)  # masked out below
    hy, hz, hx = h[..., 1], h[..., 2], h[..., 0]
    sin_u, cos_u = torch.sin(u), torch.cos(u)
    hyz = hy * sin_u + hz * cos_u
    D = m.safe_div(
        hy * cos_u - hz * sin_u,
        m.sqrt(torch.clamp(hx * hx + hyz * hyz, min=1e-12))
        * torch.tan(psi_s))
    v_of_u = torch.atan2(-hy * sin_u - hz * cos_u, hx) \
        + m.safe_acos(torch.clamp(D, -1.0, 1.0))
    in_rng_s = (torch.abs(D) < 1.0) & (torch.abs(v_of_u) < math.pi / 2.0)
    n_s = m.normalize(torch.stack([
        torch.sin(v_of_u), sin_u * torch.cos(v_of_u),
        cos_u * torch.cos(v_of_u)], dim=-1))
    R_s = _irawan_radius_of_curvature(torch.abs(u), umax, kappa, w, l)
    Gv = m.safe_div(
        a_half * (R_s + a_half * torch.cos(v_of_u)),
        len_ir * torch.clamp(m.dot(n_s, h), min=1e-9)
        * torch.clamp(torch.abs(torch.sin(psi_s)), min=1e-9))
    A_s = _irawan_seeliger(m.dot(n_s, om_i), m.dot(n_s, om_r))
    fs_s = Gv * fc * A_s * 2.0 * w * umax
    delta_x = w * hwidth
    x_of_u = torch.clamp(v_of_u * w / math.pi,
                         0.5 * (delta_x - w), 0.5 * (w - delta_x))
    hit_s = torch.abs(x_of_u - v * w / math.pi) < 0.5 * delta_x
    staple = torch.where(in_rng_s & hit_s & geom_ok,
                         m.safe_div(fs_s, delta_x), 0.0)

    integrand = torch.where(torch.abs(psi) > 1e-6, staple, filament)
    spec = bl.iw_ks * (integrand * snorm)[..., None]
    f = (bl.albedo * warp.INV_PI + spec) \
        * torch.clamp(wo[..., 2], min=0.0)[..., None]
    return torch.where(ok[..., None], torch.clamp(f, min=0.0), 0.0)


def _irawan_sample(bl, wi, u_lobe, u2):
    """irawan.cpp sample: the cosine lobe, weighted by f / pdf."""
    wo, _, pdf, is_delta, eta = _diffuse_sample(bl, wi, u_lobe, u2)
    f = _irawan_eval(bl, wi, wo)
    return (wo, m.safe_div(f, torch.clamp(pdf, min=1e-9)[..., None]), pdf,
            is_delta, eta)


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


# the lobes of eval and pdf by type (a delta lobe has none: 0 there), and
# the samplers; a rough type's functions take the microfacet distribution
_EVAL = {DIFFUSE: _diffuse_eval, ROUGH_DIFFUSE: _rough_diffuse_eval,
         PLASTIC: _plastic_eval, PHONG: _phong_eval, WARD: _ward_eval,
         DIFFTRANS: _difftrans_eval, HK: _hk_eval, IRAWAN: _irawan_eval}
_EVAL_ROUGH = {ROUGH_CONDUCTOR: _rough_conductor_f,
               ROUGH_PLASTIC: _rough_plastic_eval,
               ROUGH_DIELECTRIC: _rough_dielectric_eval}
# roughdiffuse and irawan sample the cosine lobe, so their density is the
# diffuse one
_PDF = {DIFFUSE: _diffuse_pdf, ROUGH_DIFFUSE: _diffuse_pdf,
        PLASTIC: _plastic_pdf, PHONG: _phong_pdf, WARD: _ward_pdf,
        DIFFTRANS: _difftrans_pdf, HK: _hk_pdf, IRAWAN: _diffuse_pdf}
_PDF_ROUGH = {ROUGH_CONDUCTOR: _rough_conductor_pdf,
              ROUGH_PLASTIC: _rough_plastic_pdf,
              ROUGH_DIELECTRIC: _rough_dielectric_pdf}
_SAMPLE = {DIFFUSE: _diffuse_sample, ROUGH_DIFFUSE: _rough_diffuse_sample,
           DIELECTRIC: _dielectric_sample,
           THIN_DIELECTRIC: _thin_dielectric_sample,
           CONDUCTOR: _conductor_sample, PLASTIC: _plastic_sample,
           PHONG: _phong_sample, WARD: _ward_sample,
           DIFFTRANS: _difftrans_sample, HK: _hk_sample, NULL: _null_sample,
           IRAWAN: _irawan_sample}
_SAMPLE_ROUGH = {ROUGH_CONDUCTOR: _rough_conductor_sample,
                 ROUGH_PLASTIC: _rough_plastic_sample,
                 ROUGH_DIELECTRIC: _rough_dielectric_sample}


def _eval_base(bl: BsdfLocals, wi, wo, active_types):
    """f(wi, wo)·|cos θo| of the smooth single-layer lobes, per-lane type
    dispatch (a nested type's rows are 0 here)."""
    wi, wo, _ = _flip_twosided(bl, wi, wo)
    out = torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    for t in active_types:
        if t in _EVAL:
            v = _EVAL[t](bl, wi, wo)
        elif t in _EVAL_ROUGH:
            v = _dist_mix(bl, lambda d: _EVAL_ROUGH[t](bl, d, wi, wo))
        else:
            continue  # a delta lobe evaluates to 0
        out = torch.where((bl.type == t)[..., None], v, out)
    return out


def _pdf_base(bl: BsdfLocals, wi, wo, active_types):
    wi, wo, _ = _flip_twosided(bl, wi, wo)
    out = torch.zeros(wi.shape[:-1], device=wi.device)
    for t in active_types:
        if t in _PDF:
            v = _PDF[t](bl, wi, wo)
        elif t in _PDF_ROUGH:
            v = _dist_mix(bl, lambda d: _PDF_ROUGH[t](bl, d, wi, wo))
        else:
            continue
        out = torch.where(bl.type == t, v, out)
    return out


def _select(sel, r: BsdfSample, out: BsdfSample) -> BsdfSample:
    """``r`` on the lanes of ``sel``, ``out`` elsewhere."""
    return BsdfSample(
        wo=torch.where(sel[..., None], r.wo, out.wo),
        weight=torch.where(sel[..., None], r.weight, out.weight),
        pdf=torch.where(sel, r.pdf, out.pdf),
        is_delta=torch.where(sel, r.is_delta, out.is_delta),
        eta=torch.where(sel, r.eta, out.eta),
    )


def _sample_base(bl: BsdfLocals, wi, u_lobe, u2, active_types) -> BsdfSample:
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
        if t in _SAMPLE:
            r = _SAMPLE[t](bl, wi_f, u_lobe, u2)
        elif t in _SAMPLE_ROUGH:
            r = _dist_mix(bl, lambda d: _SAMPLE_ROUGH[t](
                bl, d, wi_f, u_lobe, u2))
        else:
            continue  # a nested type: the nested layer samples it
        out = _select(bl.type == t, BsdfSample(*r), out)
    # un-flip wo for twosided backfaces
    return out._replace(wo=out.wo * zflip)


# === the nested layer =======================================================

def _coat_refract(v, eta):
    """Refract v across z into a medium of relative IOR eta, keeping the
    hemisphere's sign (coating.cpp refractIn): returns (v', |cos'|)."""
    sz = torch.sign(v[..., 2])
    sin2 = torch.clamp(1.0 - v[..., 2] * v[..., 2], min=0.0)
    sin2_p = sin2 / (eta * eta)
    cos_p = m.sqrt(torch.clamp(1.0 - sin2_p, min=1e-12))
    vp = torch.stack([v[..., 0] / eta, v[..., 1] / eta, sz * cos_p], dim=-1)
    return m.normalize(vp), cos_p


def _coat_refract_out(vp, eta):
    """The inverse of _coat_refract, from the layer to the outside: returns
    (v, valid), valid False on total internal reflection."""
    sz = torch.sign(vp[..., 2])
    sin2_p = torch.clamp(1.0 - vp[..., 2] * vp[..., 2], min=0.0)
    sin2 = sin2_p * eta * eta
    valid = sin2 < 1.0
    cos_o = m.sqrt(torch.clamp(1.0 - sin2, min=1e-12))
    v = torch.stack([vp[..., 0] * eta, vp[..., 1] * eta, sz * cos_o], dim=-1)
    return m.normalize(v), valid


def _coat_absorption(bl, ci_p, co_p):
    """exp(-sigma_a thickness (1/cos_i' + 1/cos_o')): a coating row's k
    column holds sigma_a * thickness."""
    return torch.exp(-bl.k_c * (1.0 / torch.clamp(ci_p, min=1e-6)
                                + 1.0 / torch.clamp(co_p, min=1e-6))[..., None])


def _coating_common(bl, wi, wo):
    eta = bl.eta_s
    wi_p, ci_p = _coat_refract(wi, eta)
    wo_p, co_p = _coat_refract(wo, eta)
    Fi, _ = m.fresnel_dielectric(torch.abs(wi[..., 2]), eta)
    Fo, _ = m.fresnel_dielectric(torch.abs(wo[..., 2]), eta)
    T = _coat_absorption(bl, ci_p, co_p)
    jac = m.safe_div(torch.abs(wo[..., 2]),
                     eta * eta * torch.clamp(co_p, min=1e-6))
    return wi_p, wo_p, Fi, Fo, T, jac


def _coating_eval(bl, bl_a, ntypes, wi, wo):
    wi_p, wo_p, Fi, Fo, T, jac = _coating_common(bl, wi, wo)
    f_n = _eval_base(bl_a, wi_p, wo_p, ntypes)
    return f_n * ((1.0 - Fi) * (1.0 - Fo) * jac)[..., None] * T


def _coating_pdf(bl, bl_a, ntypes, wi, wo):
    wi_p, wo_p, Fi, _, _, jac = _coating_common(bl, wi, wo)
    p_n = _pdf_base(bl_a, wi_p, wo_p, ntypes)
    p_spec = torch.clamp(Fi, 0.05, 0.95)  # sample's lobe probability
    return (1.0 - p_spec) * p_n * jac


def _roughcoating_spec_prob(bl, wi):
    return torch.clamp(1.0 - _rt_T(bl, wi[..., 2]), 0.05, 0.95)


def _roughcoating_eval(bl, bl_a, ntypes, wi, wo):
    """roughcoating.cpp: an isotropic microfacet reflection (alpha_u) over
    nested A, which the light reaches through the macro interface,
    attenuated by the baked transmittance on the way in and out."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    mh = m.normalize(wi + wo)
    au = bl.alpha[..., 0]

    def spec_for(d):
        D = mf.eval_d(d, au, au, mh)
        G = mf.smith_g(d, au, au, wi, wo, mh)
        F, _ = m.fresnel_dielectric(torch.abs(m.dot(wi, mh)), bl.eta_s)
        return m.safe_div(D * G * F, 4.0 * wi[..., 2])

    spec = torch.where(bl.dist == mf.GGX, spec_for(mf.GGX),
                       spec_for(mf.BECKMANN))
    f_spec = bl.spec_refl * spec[..., None]
    wi_p, wo_p, _, _, Tabs, jac = _coating_common(bl, wi, wo)
    f_n = _eval_base(bl_a, wi_p, wo_p, ntypes)
    T_i = _rt_T(bl, wi[..., 2])
    T_o = _rt_T(bl, wo[..., 2])
    f_nested = f_n * (T_i * T_o * jac)[..., None] * Tabs
    return torch.where(ok[..., None], f_spec + f_nested, 0.0)


def _roughcoating_pdf(bl, bl_a, ntypes, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    mh = m.normalize(wi + wo)
    au = bl.alpha[..., 0]
    p_m = torch.where(bl.dist == mf.GGX, mf.pdf(mf.GGX, au, au, wi, mh),
                      mf.pdf(mf.BECKMANN, au, au, wi, mh))
    pdf_s = m.safe_div(p_m, 4.0 * torch.abs(m.dot(wo, mh)))
    wi_p, wo_p, _, _, _, jac = _coating_common(bl, wi, wo)
    p_n = _pdf_base(bl_a, wi_p, wo_p, ntypes)
    p_spec = _roughcoating_spec_prob(bl, wi)
    return torch.where(ok, p_spec * pdf_s + (1.0 - p_spec) * p_n * jac, 0.0)


def _mixture_sample_nested(bl, bl_a, bl_b, ntypes, wi, u_lobe, u2):
    """mixturebsdf.cpp: A with probability w (u_lobe rescaled for the
    chosen lobe), then the mixture's f and pdf at the sampled direction; a
    delta lobe keeps its own weight."""
    w = torch.clamp(bl.blend_w, 1e-4, 1.0 - 1e-4)
    pick_a = u_lobe < w
    u_a = torch.clamp(u_lobe / w, 0.0, 1.0 - 1e-7)
    u_b = torch.clamp((u_lobe - w) / (1.0 - w), 0.0, 1.0 - 1e-7)
    r_a = _sample_base(bl_a, wi, u_a, u2, ntypes)
    r_b = _sample_base(bl_b, wi, u_b, u2, ntypes)
    chosen = _select(pick_a, r_a, r_b)
    wo_m = chosen.wo
    f_m = (w[..., None] * _eval_base(bl_a, wi, wo_m, ntypes)
           + (1.0 - w)[..., None] * _eval_base(bl_b, wi, wo_m, ntypes))
    p_m = (w * _pdf_base(bl_a, wi, wo_m, ntypes)
           + (1.0 - w) * _pdf_base(bl_b, wi, wo_m, ntypes))
    w_smooth = m.safe_div(f_m, torch.clamp(p_m, min=1e-12)[..., None])
    delta = chosen.is_delta
    return BsdfSample(
        wo=wo_m,
        weight=torch.where(delta[..., None], chosen.weight, w_smooth),
        pdf=torch.where(delta, torch.where(pick_a, w, 1.0 - w) * chosen.pdf,
                        p_m),
        is_delta=delta, eta=chosen.eta)


def _mask_sample(bl, bl_a, ntypes, wi, u_lobe, u2):
    """mask.cpp: nested A with probability opacity (u_lobe rescaled), else
    the ray passes through (a delta lobe of weight 1)."""
    op = torch.clamp(bl.opacity, 0.0, 1.0)
    interact = u_lobe < op
    u_n = torch.clamp(m.safe_div(u_lobe, torch.clamp(op, min=1e-7)),
                      0.0, 1.0 - 1e-7)
    r_n = _sample_base(bl_a, wi, u_n, u2, ntypes)
    sh = wi.shape[:-1]
    dev = wi.device
    r_pass = BsdfSample(
        wo=-wi, weight=torch.ones(sh + (3,), device=dev),
        pdf=torch.clamp(1.0 - op, min=1e-12),
        is_delta=torch.ones(sh, dtype=torch.bool, device=dev),
        eta=torch.ones(sh, device=dev))
    return _select(interact, r_n._replace(pdf=op * r_n.pdf), r_pass)


def _coating_sample(bl, bl_a, ntypes, wi, u_lobe, u2):
    """coating.cpp: the smooth interface's mirror reflection (a delta lobe)
    with probability clamp(F, 0.05, 0.95), else nested A sampled inside the
    layer and refracted out; a total internal reflection on the way out
    loses the sample (pdf 0)."""
    eta = bl.eta_s
    Fi, _ = m.fresnel_dielectric(torch.abs(wi[..., 2]), eta)
    p_spec = torch.clamp(Fi, 0.05, 0.95)
    choose_spec = u_lobe < p_spec
    w_s = bl.spec_refl * m.safe_div(Fi, p_spec)[..., None]

    wi_p, ci_p = _coat_refract(wi, eta)
    u_n = torch.clamp(m.safe_div(u_lobe - p_spec, 1.0 - p_spec),
                      0.0, 1.0 - 1e-7)
    r_n = _sample_base(bl_a, wi_p, u_n, u2, ntypes)
    wo_c, valid_out = _coat_refract_out(r_n.wo, eta)
    Fo, _ = m.fresnel_dielectric(torch.abs(wo_c[..., 2]), eta)
    co_p = torch.abs(r_n.wo[..., 2])
    T = _coat_absorption(bl, ci_p, co_p)
    ok_n = valid_out & (r_n.pdf > 0)
    w_n = torch.where(
        ok_n[..., None],
        r_n.weight * T * m.safe_div((1.0 - Fi) * (1.0 - Fo),
                                    1.0 - p_spec)[..., None],
        0.0)
    jac = m.safe_div(torch.abs(wo_c[..., 2]),
                     eta * eta * torch.clamp(co_p, min=1e-6))
    pdf_n = torch.where(ok_n, (1.0 - p_spec) * r_n.pdf * jac, 0.0)
    return BsdfSample(
        wo=torch.where(choose_spec[..., None], _mirror(wi), wo_c),
        weight=torch.where(choose_spec[..., None], w_s, w_n),
        pdf=torch.where(choose_spec, p_spec, pdf_n),
        is_delta=choose_spec | r_n.is_delta,
        eta=torch.ones(wi.shape[:-1], device=wi.device))


def _roughcoating_sample(bl, bl_a, ntypes, wi, u_lobe, u2):
    """roughcoating.cpp: the microfacet reflection or nested A sampled
    inside the layer and refracted out through the macro interface, then
    the mixture's f / pdf at that direction; a nested delta lobe keeps its
    weight, attenuated by the transmittance."""
    eta = bl.eta_s
    p_spec = _roughcoating_spec_prob(bl, wi)
    choose_spec = u_lobe < p_spec
    au = bl.alpha[..., 0]
    mh = torch.where((bl.dist == mf.GGX)[..., None],
                     mf.sample(mf.GGX, au, au, wi, u2)[0],
                     mf.sample(mf.BECKMANN, au, au, wi, u2)[0])
    wo_s = m.reflect(wi, mh)

    wi_p, ci_p = _coat_refract(wi, eta)
    u_n = torch.clamp(m.safe_div(u_lobe - p_spec, 1.0 - p_spec),
                      0.0, 1.0 - 1e-7)
    r_n = _sample_base(bl_a, wi_p, u_n, u2, ntypes)
    wo_c, valid_out = _coat_refract_out(r_n.wo, eta)
    wo_rc = torch.where(choose_spec[..., None], wo_s, wo_c)
    nested_delta = ~choose_spec & r_n.is_delta
    f_rc = _roughcoating_eval(bl, bl_a, ntypes, wi, wo_rc)
    p_rc = _roughcoating_pdf(bl, bl_a, ntypes, wi, wo_rc)
    w_smooth = m.safe_div(f_rc, torch.clamp(p_rc, min=1e-12)[..., None])
    T_i = _rt_T(bl, wi[..., 2])
    T_o = _rt_T(bl, wo_c[..., 2])
    co_p = torch.abs(r_n.wo[..., 2])
    Tabs = _coat_absorption(bl, ci_p, co_p)
    w_delta = r_n.weight * Tabs * m.safe_div(T_i * T_o, 1.0 - p_spec)[..., None]
    ok_n = valid_out & (r_n.pdf > 0)
    jac = m.safe_div(torch.abs(wo_c[..., 2]),
                     eta * eta * torch.clamp(co_p, min=1e-6))
    keep = choose_spec | ok_n
    weight = torch.where(nested_delta[..., None], w_delta, w_smooth)
    pdf = torch.where(nested_delta, (1.0 - p_spec) * r_n.pdf * jac, p_rc)
    return BsdfSample(
        wo=wo_rc, weight=torch.where(keep[..., None], weight, 0.0),
        pdf=torch.where(keep, pdf, 0.0), is_delta=nested_delta,
        eta=torch.ones(wi.shape[:-1], device=wi.device))


def eval(bl: BsdfLocals, wi, wo, active_types=SUPPORTED_TYPES, nested=None):
    """f(wi, wo)·|cos θo| of the smooth lobes, per-lane type dispatch; the
    nested types through ``nested`` (they are 0 without it)."""
    _check_types(active_types)
    out = _eval_base(bl, wi, wo, active_types)
    if nested is None:
        return out
    bl_a, bl_b, ntypes = nested
    _check_types(ntypes)
    types = active_types
    if MIXTURE in types or BLEND in types or MASK in types:
        f_a = _eval_base(bl_a, wi, wo, ntypes)
        if MIXTURE in types or BLEND in types:
            w = bl.blend_w[..., None]
            f_b = _eval_base(bl_b, wi, wo, ntypes)
            mixsel = (bl.type == MIXTURE) | (bl.type == BLEND)
            out = torch.where(mixsel[..., None], w * f_a + (1.0 - w) * f_b,
                              out)
        if MASK in types:
            out = torch.where((bl.type == MASK)[..., None],
                              bl.opacity[..., None] * f_a, out)
    if COATING in types:
        out = torch.where((bl.type == COATING)[..., None],
                          _coating_eval(bl, bl_a, ntypes, wi, wo), out)
    if ROUGHCOATING in types:
        out = torch.where((bl.type == ROUGHCOATING)[..., None],
                          _roughcoating_eval(bl, bl_a, ntypes, wi, wo), out)
    return out


def pdf(bl: BsdfLocals, wi, wo, active_types=SUPPORTED_TYPES, nested=None):
    _check_types(active_types)
    out = _pdf_base(bl, wi, wo, active_types)
    if nested is None:
        return out
    bl_a, bl_b, ntypes = nested
    _check_types(ntypes)
    types = active_types
    if MIXTURE in types or BLEND in types or MASK in types:
        p_a = _pdf_base(bl_a, wi, wo, ntypes)
        if MIXTURE in types or BLEND in types:
            w = bl.blend_w
            p_b = _pdf_base(bl_b, wi, wo, ntypes)
            mixsel = (bl.type == MIXTURE) | (bl.type == BLEND)
            out = torch.where(mixsel, w * p_a + (1.0 - w) * p_b, out)
        if MASK in types:
            out = torch.where(bl.type == MASK, bl.opacity * p_a, out)
    if ROUGHCOATING in types:
        out = torch.where(bl.type == ROUGHCOATING,
                          _roughcoating_pdf(bl, bl_a, ntypes, wi, wo), out)
    if COATING in types:
        out = torch.where(bl.type == COATING,
                          _coating_pdf(bl, bl_a, ntypes, wi, wo), out)
    return out


def sample(bl: BsdfLocals, wi, u_lobe, u2, active_types=SUPPORTED_TYPES,
           nested=None) -> BsdfSample:
    _check_types(active_types)
    out = _sample_base(bl, wi, u_lobe, u2, active_types)
    if nested is None:
        return out
    bl_a, bl_b, ntypes = nested
    _check_types(ntypes)
    types = active_types
    if MIXTURE in types or BLEND in types:
        out = _select((bl.type == MIXTURE) | (bl.type == BLEND),
                      _mixture_sample_nested(bl, bl_a, bl_b, ntypes, wi,
                                             u_lobe, u2), out)
    if MASK in types:
        out = _select(bl.type == MASK,
                      _mask_sample(bl, bl_a, ntypes, wi, u_lobe, u2), out)
    if COATING in types:
        out = _select(bl.type == COATING,
                      _coating_sample(bl, bl_a, ntypes, wi, u_lobe, u2), out)
    if ROUGHCOATING in types:
        out = _select(bl.type == ROUGHCOATING,
                      _roughcoating_sample(bl, bl_a, ntypes, wi, u_lobe, u2),
                      out)
    return out
