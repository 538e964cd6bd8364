"""Rough dielectric transmittance, baked at scene build (port of
``mitsuba_tpu/core/rtrans.py``, a copy: numpy only, float64, so the two
packages bake bitwise the same coefficients).

The reference (rtrans.h:448, the ``data/microfacet`` tables of the
``rdielprec`` utility, read by roughplastic.cpp) ships 3-D (cos, alpha, eta)
spline tables. Here the builder integrates the directional transmittance
T(cos_i; alpha, eta) through a rough dielectric microfacet interface per
material, by deterministic QMC over the Walter microfacet BTDF, and fits a
polynomial in cos_i, so the device evaluates a 6-coefficient Horner per lane
(no table gather in the hot loop). The cosine-weighted hemispherical average
from the dense side gives the internal-scattering denominator (the rough
analog of fresnelDiffuseReflectance).
"""
from __future__ import annotations

import numpy as np

RT_DEG = 6  # polynomial coefficients (degree 5)
# numpy 2 renamed trapz (the same rule)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _hammersley(n):
    u = (np.arange(n) + 0.5) / n
    v = np.zeros(n)
    b = np.arange(n)
    f = 0.5
    while b.any():
        v += f * (b & 1)
        b >>= 1
        f *= 0.5
    return u, v


def _sample_normals(dist: int, alpha: float, n: int):
    """Microfacet normals m ~ D(m)|cos_m| (Beckmann dist=0, GGX dist=1)."""
    u1, u2 = _hammersley(n)
    u1 = np.clip(u1, 1e-7, 1 - 1e-7)
    if dist == 1:  # GGX
        t2 = alpha * alpha * u1 / (1.0 - u1)
    else:  # Beckmann
        t2 = -alpha * alpha * np.log(1.0 - u1)
    ct = 1.0 / np.sqrt(1.0 + t2)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    phi = 2.0 * np.pi * u2
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)


def _smith_g1(dist: int, alpha: float, cos_v):
    cos_v = np.clip(np.abs(cos_v), 1e-6, 1.0)
    tan_v = np.sqrt(1.0 - cos_v * cos_v) / cos_v
    if dist == 1:
        return 2.0 / (1.0 + np.sqrt(1.0 + (alpha * tan_v) ** 2))
    a = 1.0 / np.maximum(alpha * tan_v, 1e-9)
    g = np.where(
        a < 1.6,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
        1.0,
    )
    return g


def _fresnel(cos_i, eta):
    """Unpolarized dielectric Fresnel reflectance for cos_i >= 0 entering
    relative IOR eta (transmitted side / incident side)."""
    cos_i = np.clip(cos_i, 0.0, 1.0)
    # Snell with relative eta (t = sqrt(1 - (1/eta^2)(1-c^2)))
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    rs = (cos_i - eta * cos_t) / np.maximum(cos_i + eta * cos_t, 1e-12)
    rp = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-12)
    F = 0.5 * (rs * rs + rp * rp)
    return np.where(tir, 1.0, F)


def rough_transmittance(dist: int, alpha: float, eta: float, cos_i,
                        n_samples: int = 2048):
    """Directional transmittance through a rough dielectric interface for
    incident cosines ``cos_i`` (array), from the eta=1 side into relative
    IOR ``eta`` (use 1/eta for the dense-to-rare direction). Walter BTDF
    integral estimated with D|cos| QMC normal sampling:
        T(wi) = E_m[ (1-F(wi.m)) G(wi,wo,m) |wi.m| / (cos_i cos_m) ]
    clipped to [0, 1]. alpha <= 1e-4 returns the smooth 1-F limit.
    """
    cos_i = np.atleast_1d(np.asarray(cos_i, np.float64))
    if alpha <= 1e-4:
        return 1.0 - _fresnel(cos_i, eta)
    m_all = _sample_normals(dist, alpha, n_samples)          # (N, 3)
    out = np.zeros_like(cos_i)
    for k, ci in enumerate(cos_i):
        ci = float(np.clip(ci, 1e-4, 1.0))
        wi = np.array([np.sqrt(max(1.0 - ci * ci, 0.0)), 0.0, ci])
        idotm = m_all @ wi                                   # (N,)
        valid = idotm > 1e-6
        F = _fresnel(idotm, eta)
        # refracted direction per normal
        c2 = 1.0 - (1.0 - idotm ** 2) / (eta * eta)
        ok = valid & (c2 > 0)
        cos_t = np.sqrt(np.maximum(c2, 0.0))
        wo = (idotm / eta - cos_t)[:, None] * m_all - wi[None, :] / eta
        wo_n = wo / np.maximum(np.linalg.norm(wo, axis=1, keepdims=True),
                               1e-12)
        down = wo_n[:, 2] < -1e-6                            # transmitted side
        g1i = _smith_g1(dist, alpha, idotm * 0 + ci)
        g1o = _smith_g1(dist, alpha, np.abs(wo_n[:, 2]))
        w = np.where(
            ok & down,
            (1.0 - F) * g1i * g1o * np.abs(idotm)
            / np.maximum(ci * np.abs(m_all[:, 2]), 1e-9),
            0.0,
        )
        out[k] = np.clip(w.mean(), 0.0, 1.0)
    return out


def fit_poly(dist: int, alpha: float, eta: float, n_cos: int = 32):
    """Least-squares polynomial fit of T(cos_i) on [0, 1] -> (RT_DEG,)
    coefficients (lowest order first, Horner-ready reversed on device)."""
    cos = np.linspace(0.02, 1.0, n_cos)
    T = rough_transmittance(dist, alpha, eta, cos)
    V = np.vander(cos, RT_DEG, increasing=True)
    coef, *_ = np.linalg.lstsq(V, T, rcond=None)
    return coef.astype(np.float32), T


def diffuse_transmittance(dist: int, alpha: float, eta: float,
                          n_cos: int = 32):
    """Cosine-weighted hemispherical average of T (rtrans.h
    evalDiffuse role): Tbar = 2 int_0^1 T(c) c dc."""
    cos = np.linspace(0.02, 1.0, n_cos)
    T = rough_transmittance(dist, alpha, eta, cos)
    return float(2.0 * _trapezoid(T * cos, cos))
