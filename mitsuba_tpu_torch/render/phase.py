"""Phase functions (port of ``mitsuba_tpu/render/phase.py``; the reference's
src/phase/{isotropic,hg,rayleigh,kkay,microflake,mixturephase}.cpp).

Directions follow the reference's flow convention: ``wi`` points back
toward where the light came from, ``wo`` is the sampled direction, and the
scattering angle's cosine is taken between -wi and wo (g > 0 scatters
forward). Dispatch is masked over lanes on the static ``active_types``
tuple, as in the BSDF layer. Value and pdf are separate returns, since the
fiber models (kkay, microflake) are not sampled exactly.

As in the JAX package, ``MIXTURE`` is a weighted pair of HG lobes and
``MICROFLAKE`` a Gaussian flake-normal distribution about the fiber axis,
sampled through erfinv.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp
from ..core.frame import Frame

ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
MIXTURE = 3      # mixturephase.cpp: weighted pair of HG lobes
KKAY = 4         # kkay.cpp: Kajiya-Kay hair fiber
MICROFLAKE = 5   # microflake.cpp: specular fiber flakes


class PhaseParams(NamedTuple):
    """Per-lane phase parameters, gathered from the MediumTable by medium."""

    g: torch.Tensor         # (R,) HG asymmetry / mixture lobe 1
    g2: torch.Tensor        # (R,) mixture lobe 2
    w2: torch.Tensor        # (R,) mixture weight of lobe 2
    ks: torch.Tensor        # (R,) kkay specular weight (kd = 1 - ks)
    exponent: torch.Tensor  # (R,) kkay specular exponent
    sigma: torch.Tensor     # (R,) microflake flake-normal std dev
    axis: torch.Tensor      # (R, 3) fiber tangent (kkay, microflake)


def _hg(cos_t, g):
    denom = 1.0 + g * g - 2.0 * g * cos_t
    return warp.INV_FOURPI * (1.0 - g * g) * m.safe_div(
        torch.ones_like(denom), denom * m.safe_sqrt(denom))


def _local_dir(cos_t, u1):
    """The direction at polar cosine ``cos_t`` and azimuth 2 pi u1 about +z."""
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u1
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def _hg_sample_dir(wi, g, u2):
    sq = m.safe_div(1.0 - g * g, 1.0 - g + 2.0 * g * u2[..., 0])
    cos_t = m.safe_div(1.0 + g * g - sq * sq, 2.0 * g)
    cos_t = torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * u2[..., 0], cos_t)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    # the forward axis is the propagation direction, -wi
    return Frame.from_normal(-wi).to_world(_local_dir(cos_t, u2[..., 1]))


def _kkay_profile(ct_o, ct_i, ks, exponent):
    """Kajiya-Kay profile in the cosines to the fiber: a diffuse lobe
    ~ sin(theta_o) and a specular cos^p about the mirrored cone."""
    so = m.safe_sqrt(1.0 - ct_o * ct_o)
    si = m.safe_sqrt(1.0 - ct_i * ct_i)
    spec_cos = torch.clamp(si * so - ct_i * ct_o, 0.0, 1.0)
    return (1.0 - ks) * so + ks * spec_cos ** exponent


def _kkay_norm(ct_i, ks, exponent, n=32):
    """2 pi times the profile's integral over [-1, 1] by an n-point
    midpoint rule."""
    t = ((torch.arange(n, device=ct_i.device, dtype=torch.float32) + 0.5)
         / n * 2.0 - 1.0)
    prof = _kkay_profile(t[None, :], ct_i[..., None], ks[..., None],
                         exponent[..., None])
    return 2.0 * math.pi * torch.sum(prof, dim=-1) * (2.0 / n)


def _kkay_eval(params: PhaseParams, wi, wo):
    ct_i = m.dot(-wi, params.axis)
    ct_o = m.dot(wo, params.axis)
    norm = torch.clamp(_kkay_norm(ct_i, params.ks, params.exponent), min=1e-8)
    return _kkay_profile(ct_o, ct_i, params.ks, params.exponent) / norm


def _flake_D(t, sigma):
    """Gaussian flake-normal pdf over the sphere in t = m . axis, with the
    closed-form normalization 2 pi s sqrt(2 pi) erf(1 / (s sqrt 2))."""
    s = torch.clamp(sigma, min=1e-3)
    z = 2.0 * math.pi * s * math.sqrt(2.0 * math.pi) * torch.special.erf(
        1.0 / (s * math.sqrt(2.0)))
    return torch.exp(-0.5 * (t / s) ** 2) / z


def _flake_sigma(params: PhaseParams, omega, n_t=16, n_phi=8):
    """Projected flake area sigma(omega) = int D(m) |omega . m| dm by an
    (n_t x n_phi) midpoint rule about the fiber axis."""
    dev = omega.device
    mu = m.dot(omega, params.axis)
    smu = m.safe_sqrt(1.0 - mu * mu)
    t = (torch.arange(n_t, device=dev, dtype=torch.float32) + 0.5) / n_t \
        * 2.0 - 1.0
    phi = (torch.arange(n_phi, device=dev, dtype=torch.float32) + 0.5) \
        / n_phi * 2.0 * math.pi
    st = torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))
    dot_om = torch.abs(
        mu[..., None, None] * t[None, :, None]
        + smu[..., None, None] * st[None, :, None]
        * torch.cos(phi)[None, None, :])
    D = _flake_D(t, params.sigma[..., None])
    integrand = D[..., :, None] * dot_om
    dA = (2.0 / n_t) * (2.0 * math.pi / n_phi)
    return torch.sum(integrand, dim=(-1, -2)) * dA


def _microflake_val_pdf(params: PhaseParams, wi, wo):
    """Specular flakes: wo = reflect(omega, m), omega = -wi; value D(h) /
    (2 sigma(omega)), pdf D(h) / (2 |omega . h|) with h the half vector."""
    omega = -wi
    hn = m.normalize(wo - omega)
    cos_h = torch.abs(m.dot(omega, hn))
    D = _flake_D(m.dot(hn, params.axis), params.sigma)
    sigma_o = torch.clamp(_flake_sigma(params, omega), min=1e-6)
    val = D / (2.0 * sigma_o)
    pdf = m.safe_div(D, 2.0 * torch.clamp(cos_h, min=1e-6))
    return val, pdf


def _microflake_sample(params: PhaseParams, wi, u2):
    s = torch.clamp(params.sigma, min=1e-3)
    cap = torch.special.erf(1.0 / (s * math.sqrt(2.0)))
    t = math.sqrt(2.0) * s * torch.special.erfinv(
        torch.clamp((2.0 * u2[..., 0] - 1.0) * cap, -0.999999, 0.999999))
    t = torch.clamp(t, -1.0, 1.0)
    mvec = Frame.from_normal(params.axis).to_world(_local_dir(t, u2[..., 1]))
    omega = -wi
    wo = omega - 2.0 * m.dot(omega, mvec)[..., None] * mvec
    return m.normalize(wo)


def eval_pdf(ptype, params: PhaseParams, wi, wo, active_types=(ISOTROPIC,)):
    """(value, pdf), each (R,), of scattering from ``wi`` into ``wo``."""
    cos_t = -m.dot(wi, wo)
    shape = wi.shape[:-1]
    val = torch.zeros(shape, device=wi.device)
    pdf = torch.full(shape, warp.INV_FOURPI, device=wi.device)
    for t in active_types:
        if t == ISOTROPIC:
            v = torch.full(shape, warp.INV_FOURPI, device=wi.device)
            p = v
        elif t == HG:
            v = _hg(cos_t, params.g)
            p = v
        elif t == RAYLEIGH:
            v = (3.0 / (16.0 * math.pi)) * (1.0 + cos_t * cos_t)
            p = v
        elif t == MIXTURE:
            v = ((1.0 - params.w2) * _hg(cos_t, params.g)
                 + params.w2 * _hg(cos_t, params.g2))
            p = v
        elif t == KKAY:
            v = _kkay_eval(params, wi, wo)
            p = torch.full(shape, warp.INV_FOURPI, device=wi.device)
        elif t == MICROFLAKE:
            v, p = _microflake_val_pdf(params, wi, wo)
        else:
            continue
        sel = ptype == t
        val = torch.where(sel, v, val)
        pdf = torch.where(sel, p, pdf)
    return val, pdf


def sample(ptype, params: PhaseParams, wi, u2, active_types=(ISOTROPIC,)):
    """Sample wo from ``wi`` with the 2D draw ``u2``. Returns (wo, weight,
    pdf), weight = value / pdf (1 where the model is sampled exactly)."""
    out_wo = torch.zeros_like(wi)
    for t in active_types:
        if t == ISOTROPIC or t == KKAY:
            wo = warp.square_to_uniform_sphere(u2)
        elif t == HG:
            wo = _hg_sample_dir(wi, params.g, u2)
        elif t == RAYLEIGH:
            # the (1 + cos^2) cdf inverted by Cardano (rayleigh.cpp); the
            # cube root's argument z + sqrt(z^2 + 1) is positive
            z = 2.0 * (2.0 * u2[..., 0] - 1.0)
            tmp = (z + torch.sqrt(z * z + 1.0)) ** (1.0 / 3.0)
            cos_t = torch.clamp(tmp - 1.0 / tmp, -1.0, 1.0)
            wo = Frame.from_normal(-wi).to_world(_local_dir(cos_t, u2[..., 1]))
        elif t == MIXTURE:
            # a lobe picked by u0, which is then rescaled
            pick2 = u2[..., 0] < params.w2
            u0 = torch.where(
                pick2,
                m.safe_div(u2[..., 0], torch.clamp(params.w2, min=1e-8)),
                m.safe_div(u2[..., 0] - params.w2,
                           torch.clamp(1.0 - params.w2, min=1e-8)))
            uu = torch.stack([torch.clamp(u0, 0.0, 1.0 - 1e-7), u2[..., 1]],
                             dim=-1)
            g_sel = torch.where(pick2, params.g2, params.g)
            wo = _hg_sample_dir(wi, g_sel, uu)
        elif t == MICROFLAKE:
            wo = _microflake_sample(params, wi, u2)
        else:
            continue
        out_wo = torch.where((ptype == t)[..., None], wo, out_wo)
    val, pdf = eval_pdf(ptype, params, wi, out_wo, active_types)
    return out_wo, m.safe_div(val, pdf), pdf
