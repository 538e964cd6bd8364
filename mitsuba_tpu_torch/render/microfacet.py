"""Microfacet distributions, Beckmann and GGX (port of
``mitsuba_tpu/render/microfacet.py``).

D, Smith's shadowing-masking G, classic D·cos sampling and Heitz's GGX
visible-normal sampling, with anisotropic alpha_u/alpha_v, in the local
shading frame (+Z = normal), batched. GGX samples visible normals and
Beckmann samples D·cos; each ``sample_*`` returns the pdf of the density it
draws from.

The rough BSDFs evaluate both distributions on every rough lane and pick one
per lane (``bsdf._dist_mix``), so the branch a lane does not pick must stay
finite in value and in gradient: a NaN there would reach the chosen branch's
gradient as 0 x NaN. Every quotient and root is therefore the JAX package's
safe form, in the same order.
"""
from __future__ import annotations

import math

import torch

from ..core import frame as fr
from ..core import math as m

BECKMANN = 0
GGX = 1


def _project_roughness(alpha_u, alpha_v, w):
    """Anisotropic roughness projected onto direction w
    (microfacet.h projectRoughness)."""
    s2 = fr.sin_theta_2(w)
    inv_s2 = m.safe_div(1.0, s2)
    cos2 = w[..., 0] * w[..., 0] * inv_s2
    sin2 = w[..., 1] * w[..., 1] * inv_s2
    iso = torch.abs(alpha_u - alpha_v) < 1e-7
    proj = m.sqrt(torch.clamp(cos2 * (alpha_u * alpha_u)
                              + sin2 * (alpha_v * alpha_v), min=1e-12))
    return torch.where(iso | (s2 < 1e-12), alpha_u, proj)


def eval_d(dist_type: int, alpha_u, alpha_v, mh):
    """Microfacet density D(m_h); zero below the horizon."""
    ct = fr.cos_theta(mh)
    ct2 = ct * ct
    up = ct > 0.0
    mx2, my2 = mh[..., 0] * mh[..., 0], mh[..., 1] * mh[..., 1]
    if dist_type == BECKMANN:
        ex = -(mx2 / (alpha_u * alpha_u) + my2 / (alpha_v * alpha_v))
        ex = m.safe_div(ex, ct2)
        d = m.safe_div(torch.exp(ex), math.pi * alpha_u * alpha_v * ct2 * ct2)
    elif dist_type == GGX:
        root = ct2 + mx2 / (alpha_u * alpha_u) + my2 / (alpha_v * alpha_v)
        d = m.safe_div(1.0, math.pi * alpha_u * alpha_v * root * root)
    else:
        raise ValueError(dist_type)
    return torch.where(up, torch.clamp(d, min=0.0), 0.0)


def smith_g1(dist_type: int, alpha_u, alpha_v, w, mh):
    """Smith's monostatic shadowing G1(w, m_h)."""
    alpha = _project_roughness(alpha_u, alpha_v, w)
    tan_t = torch.abs(fr.tan_theta(w))
    side_ok = m.dot(w, mh) * fr.cos_theta(w) > 0.0
    if dist_type == BECKMANN:
        a = m.safe_div(1.0, alpha * tan_t)
        poly = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
        g = torch.where(a >= 1.6, 1.0, poly)
    elif dist_type == GGX:
        root = alpha * tan_t
        g = 2.0 / (1.0 + m.sqrt(1.0 + root * root))
    else:
        raise ValueError(dist_type)
    g = torch.where(tan_t < 1e-9, 1.0, g)
    return torch.where(side_ok, g, 0.0)


def smith_g(dist_type: int, alpha_u, alpha_v, wi, wo, mh):
    return (smith_g1(dist_type, alpha_u, alpha_v, wi, mh)
            * smith_g1(dist_type, alpha_u, alpha_v, wo, mh))


def sample_all(dist_type: int, alpha_u, alpha_v, u2):
    """Sample m_h proportional to D(m) cos θ over the hemisphere. Returns
    (m_h, pdf)."""
    u0 = torch.clamp(u2[..., 0], 0.0, 1.0 - 1e-7)
    u1 = u2[..., 1]
    aniso = torch.abs(alpha_u - alpha_v) > 1e-7
    phi_iso = 2.0 * math.pi * u1
    phi_a = torch.atan(alpha_v / alpha_u
                       * torch.tan(2.0 * math.pi * u1 + 0.5 * math.pi))
    phi_a = phi_a + math.pi * torch.floor(2.0 * u1 + 0.5)
    phi = torch.where(aniso, phi_a, phi_iso)
    cp, sp = torch.cos(phi), torch.sin(phi)
    inv_a2 = torch.where(
        aniso,
        cp * cp / (alpha_u * alpha_u) + sp * sp / (alpha_v * alpha_v),
        1.0 / (alpha_u * alpha_u))
    if dist_type == BECKMANN:
        tan2 = -torch.log(torch.clamp(1.0 - u0, min=1e-20)) / inv_a2
    elif dist_type == GGX:
        tan2 = u0 / torch.clamp(1.0 - u0, min=1e-7) / inv_a2
    else:
        raise ValueError(dist_type)
    ct = 1.0 / m.sqrt(1.0 + tan2)
    st = m.safe_sqrt(1.0 - ct * ct)
    mh = torch.stack([st * cp, st * sp, ct], dim=-1)
    return mh, pdf_all(dist_type, alpha_u, alpha_v, mh)


def pdf_all(dist_type: int, alpha_u, alpha_v, mh):
    return (eval_d(dist_type, alpha_u, alpha_v, mh)
            * torch.clamp(fr.cos_theta(mh), min=0.0))


def sample_visible(alpha_u, alpha_v, wi, u2):
    """Heitz 2018 GGX visible-normal sampling (microfacet.h:67). ``wi`` must
    lie in the upper hemisphere (callers flip beforehand). Returns
    (m_h, pdf)."""
    wi_s = m.normalize(torch.stack(
        [alpha_u * wi[..., 0], alpha_v * wi[..., 1], wi[..., 2]], dim=-1))
    up = wi_s.new_tensor([0.0, 0.0, 1.0]).expand_as(wi_s)
    ex = wi_s.new_tensor([1.0, 0.0, 0.0]).expand_as(wi_s)
    grazing = (wi_s[..., 2] < 0.9999)[..., None]
    t1 = torch.where(grazing, m.normalize(m.cross(up, wi_s)), ex)
    t2 = m.cross(wi_s, t1)
    r = m.sqrt(u2[..., 0])
    phi = 2.0 * math.pi * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + wi_s[..., 2])
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * wi_s
    mh = m.normalize(torch.stack(
        [alpha_u * nh[..., 0], alpha_v * nh[..., 1],
         torch.clamp(nh[..., 2], min=1e-6)], dim=-1))
    return mh, pdf_visible(GGX, alpha_u, alpha_v, wi, mh)


def pdf_visible(dist_type: int, alpha_u, alpha_v, wi, mh):
    """pdf of visible-normal sampling: G1(wi, m) |wi·m| D(m) / |cos θi|."""
    d = eval_d(dist_type, alpha_u, alpha_v, mh)
    g1 = smith_g1(dist_type, alpha_u, alpha_v, wi, mh)
    return m.safe_div(g1 * torch.abs(m.dot(wi, mh)) * d,
                      torch.abs(fr.cos_theta(wi)))


def sample(dist_type: int, alpha_u, alpha_v, wi, u2):
    """The distribution's own sampling: GGX visible normals, Beckmann
    D·cos. Returns (m_h, pdf)."""
    if dist_type == GGX:
        return sample_visible(alpha_u, alpha_v, wi, u2)
    return sample_all(dist_type, alpha_u, alpha_v, u2)


def pdf(dist_type: int, alpha_u, alpha_v, wi, mh):
    if dist_type == GGX:
        return pdf_visible(GGX, alpha_u, alpha_v, wi, mh)
    return pdf_all(dist_type, alpha_u, alpha_v, mh)
