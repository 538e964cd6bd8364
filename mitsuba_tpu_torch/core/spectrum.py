"""Spectra (port of ``mitsuba_tpu/core/spectrum.py``).

The renderer works in linear-sRGB RGB: a Spectrum is a (..., 3) float32
tensor. Here are the conversions (XYZ <-> linear sRGB, luminance, the sRGB
transfer curve), the Planck emitter and tabulated spectra resampled to RGB
on the host (numpy, float64, as in the JAX package), and the hero-wavelength
spectral mode: each lane carries three wavelengths, every RGB factor is
lifted to a smooth spectrum of three sigmoid band bases (the basis whose
CIE response matrix is inverted once, so the uplift integrates back to its
RGB), and ``spectral_to_rgb`` turns (wavelength, radiance) samples back into
RGB. The host constants (the white-point correction and the uplift's
inverse) are computed once per process and cached read-only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

if not hasattr(np, "trapezoid"):
    raise ImportError("mitsuba_tpu_torch.core.spectrum needs numpy >= 2.0 "
                      "(np.trapezoid)")

N_CHANNELS = 3

# CIE-standard sRGB <-> XYZ (D65) matrices
_XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)
_SRGB_TO_XYZ = np.linalg.inv(_XYZ_TO_SRGB).astype(np.float32)

# Planck's law (SI)
_H, _C, _KB = 6.62607015e-34, 2.99792458e8, 1.380649e-23


def _right(x, mat: np.ndarray):
    """x @ mat for a (..., 3) tensor and a host (3, 3) matrix."""
    return x @ torch.tensor(mat, device=x.device)


def xyz_to_rgb(xyz):
    return _right(xyz, _XYZ_TO_SRGB.T)


def rgb_to_xyz(rgb):
    return _right(rgb, _SRGB_TO_XYZ.T)


def luminance(rgb):
    """Y of linear sRGB (spectrum.cpp getLuminance)."""
    return (rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160
            + rgb[..., 2] * 0.072169)


def srgb_gamma(x):
    """Linear -> sRGB transfer curve."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)


def srgb_degamma(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def blackbody_rgb(temperature_k: float) -> np.ndarray:
    """Planck emitter resampled to linear sRGB (W / (m^2 sr nm) scale),
    host numpy at build time (BlackBodySpectrum, spectrum.h:92)."""
    lam = np.linspace(360e-9, 830e-9, 95)
    h, c, kb = _H, _C, _KB
    I = (2 * h * c**2) / (lam**5 * (np.exp(h * c / (lam * kb * temperature_k))
                                    - 1.0))
    return spd_to_rgb(lam * 1e9, I * 1e-9)  # per nm


# CIE 1931 colour matching functions, sampled every 5 nm for the host's
# SPD -> RGB integration (analytic fits, _cie_xyz_fits)
_CIE_WL = np.arange(360.0, 831.0, 5.0)


def _cie_xyz_fits(wl):
    """Analytic multi-lobe Gaussian fits to CIE 1931 (Wyman et al. 2013),
    host numpy."""

    def g(x, mu, s1, s2):
        t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
        return np.exp(-0.5 * t * t)

    x = (
        1.056 * g(wl, 599.8, 37.9, 31.0)
        + 0.362 * g(wl, 442.0, 16.0, 26.7)
        - 0.065 * g(wl, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(wl, 568.8, 46.9, 40.5) + 0.286 * g(wl, 530.9, 16.3, 31.1)
    z = 1.217 * g(wl, 437.0, 11.8, 36.0) + 0.681 * g(wl, 459.0, 26.0, 13.8)
    return x, y, z


def spd_to_rgb(wavelengths_nm, values) -> np.ndarray:
    """A tabulated SPD integrated against the CIE curves -> linear sRGB,
    float32 (host; InterpolatedSpectrum -> RGB, spectrum.h:203)."""
    wl = np.asarray(wavelengths_nm, dtype=np.float64)
    vals = np.asarray(values, dtype=np.float64)
    v = np.interp(_CIE_WL, wl, vals, left=0.0, right=0.0)
    cx, cy, cz = _cie_xyz_fits(_CIE_WL)
    norm = np.trapezoid(cy, _CIE_WL)
    X = np.trapezoid(v * cx, _CIE_WL) / norm
    Y = np.trapezoid(v * cy, _CIE_WL) / norm
    Z = np.trapezoid(v * cz, _CIE_WL) / norm
    return (_XYZ_TO_SRGB @ np.array([X, Y, Z])).astype(np.float32)


# --- the hero-wavelength spectral mode ---------------------------------------

WL_MIN, WL_MAX = 360.0, 830.0
# the host grid every 2 nm on which the uplift's constants are integrated
_WL_GRID = np.arange(WL_MIN, WL_MAX + 1e-3, 2.0)
# the luminance integral that normalizes spectral_to_rgb (np.trapezoid, so
# numpy 2, once at import)
_CMF_NORM = float(np.trapezoid(_cie_xyz_fits(_WL_GRID)[1], _WL_GRID))


def cmf_xyz(wl):
    """CIE 1931 x, y, z colour matching functions at ``wl`` (nm), on the
    device (the analytic fits). Returns (..., 3)."""

    def g(x, mu, s1, s2):
        t = (x - mu) * torch.where(x < mu, 1.0 / s1, 1.0 / s2)
        return torch.exp(-0.5 * t * t)

    x = (1.056 * g(wl, 599.8, 37.9, 31.0)
         + 0.362 * g(wl, 442.0, 16.0, 26.7)
         - 0.065 * g(wl, 501.1, 20.4, 26.2))
    y = 0.821 * g(wl, 568.8, 46.9, 40.5) + 0.286 * g(wl, 530.9, 16.3, 31.1)
    z = 1.217 * g(wl, 437.0, 11.8, 36.0) + 0.681 * g(wl, 459.0, 26.0, 13.8)
    return torch.stack([x, y, z], dim=-1)


def _band_bases(wl):
    """Three smooth band bases (red, green, blue) that roughly partition
    unity over the visible range, on the device. Returns (..., 3)."""
    sb = 1.0 / (1.0 + torch.exp((wl - 490.0) / 18.0))
    sr = 1.0 / (1.0 + torch.exp((575.0 - wl) / 18.0))
    sg = torch.clamp(1.0 - sb - sr, min=0.0)
    return torch.stack([sr, sg, sb], dim=-1)


def _band_bases_np(wl) -> np.ndarray:
    """The host (numpy, float64) twin of _band_bases."""
    wl = np.asarray(wl, np.float64)
    sb = 1.0 / (1.0 + np.exp((wl - 490.0) / 18.0))
    sr = 1.0 / (1.0 + np.exp((575.0 - wl) / 18.0))
    sg = np.clip(1.0 - sb - sr, 0.0, None)
    return np.stack([sr, sg, sb], axis=-1)


def _uplift_matrix() -> np.ndarray:
    """3x3 M with M[i] the linear-sRGB response of band basis i under the
    reference white; spectra take the coefficients c = rgb M^-1, so they
    integrate back to rgb."""
    B = _band_bases_np(_WL_GRID)  # (W, 3)
    return np.stack([spd_to_rgb(_WL_GRID, B[:, i] * _D65(_WL_GRID))
                     for i in range(3)])  # (basis, rgb)


def _bb6504(lam_nm):
    """A 6504 K blackbody, 1 at 560 nm (host numpy)."""
    lam = np.asarray(lam_nm) * 1e-9
    h, c, kb = _H, _C, _KB
    I = (2 * h * c**2) / (lam**5 * (np.exp(h * c / (lam * kb * 6504.0)) - 1.0))
    ref = (2 * h * c**2) / (
        (560e-9)**5 * (np.exp(h * c / (560e-9 * kb * 6504.0)) - 1.0))
    return I / ref


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=None)
def _white_poly() -> np.ndarray:
    """The quadratic (a, b, c), float32, such that the smooth illuminant
    bb6504(l) (a + b t + c t^2), t = (l - 360) / 470, integrates to exactly
    linear-sRGB white: the uplift's white coefficients are then (1, 1, 1)
    and a white reflectance is 1 at every wavelength. Read-only."""
    t = (_WL_GRID - WL_MIN) / (WL_MAX - WL_MIN)
    bb = _bb6504(_WL_GRID)
    A = np.stack([spd_to_rgb(_WL_GRID, bb), spd_to_rgb(_WL_GRID, bb * t),
                  spd_to_rgb(_WL_GRID, bb * t * t)], axis=1)  # rgb x coef
    return _frozen(np.linalg.solve(A, np.ones(3)).astype(np.float32))


def _D65(wl):
    """The smooth reference-white illuminant (host numpy): the 6504 K
    blackbody's shape times the quadratic whose sRGB response is (1, 1,
    1)."""
    wl = np.asarray(wl)
    a, b, c = _white_poly()
    t = (wl - WL_MIN) / (WL_MAX - WL_MIN)
    return _bb6504(wl) * (a + b * t + c * t * t)


@functools.lru_cache(maxsize=None)
def _uplift_inv() -> np.ndarray:
    """M^-1 of _uplift_matrix, float32, read-only."""
    return _frozen(np.linalg.inv(_uplift_matrix()).astype(np.float32))


def uplift_rgb(rgb, wl):
    """The smooth spectrum lifted from linear-sRGB ``rgb`` (..., 3) at the
    wavelengths ``wl`` (..., K). Returns (..., K)."""
    c = _right(rgb, _uplift_inv())              # (..., 3) basis coefficients
    B = _band_bases(wl)                         # (..., K, 3)
    return torch.einsum("...kb,...b->...k", B, c)


def sample_wavelengths(u):
    """The hero wavelength and two companions rotated by a third of the
    range, from one uniform ``u`` (...,): (wl (..., 3), pdf) with pdf the
    constant density 1 / 470 per nm."""
    span = WL_MAX - WL_MIN
    offs = torch.tensor([0.0, 1.0 / 3.0, 2.0 / 3.0], device=u.device)
    t = torch.remainder(u[..., None] + offs, 1.0)
    return WL_MIN + t * span, 1.0 / span


def spectral_to_rgb(L, wl, pdf):
    """Linear sRGB (..., 3) of per-wavelength radiance ``L`` (..., K) at
    ``wl`` (..., K) sampled with density ``pdf``. The reference white that
    the emission uplift multiplies in (``d65``) integrates to white, so a
    white reflectance chain under a white emitter gives (1, 1, 1)."""
    xyz = cmf_xyz(wl)                           # (..., K, 3)
    K = wl.shape[-1]
    contrib = torch.einsum("...k,...kc->...c", L, xyz) / (pdf * K * _CMF_NORM)
    return _right(contrib, _XYZ_TO_SRGB.T)


def d65(wl):
    """The reference-white illuminant of _D65 on the device: the emission
    uplift's white-point factor. The Planck constants fold in float64 on
    the host, as in the JAX package, before they meet the float32
    wavelengths."""
    lam = wl * 1e-9
    h, c, kb = _H, _C, _KB
    lam2 = lam * lam
    lam5 = lam * (lam2 * lam2)  # jnp's integer power: x * (x^2)^2
    den = lam * kb * 6504.0
    I = torch.div(torch.full_like(den, 2 * h * c**2),
                  lam5 * (torch.exp(torch.div(torch.full_like(den, h * c),
                                              den)) - 1.0))
    ref = float((2 * h * c**2) / (
        (560e-9)**5 * (np.exp(h * c / (560e-9 * kb * 6504.0)) - 1.0)))
    pa, pb, pc = (float(x) for x in _white_poly())
    t = (wl - WL_MIN) / (WL_MAX - WL_MIN)
    return I / ref * (pa + pb * t + pc * t * t)
