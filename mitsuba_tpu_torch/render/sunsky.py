"""The sun, sky and sunsky emitters (port of ``mitsuba_tpu/render/sunsky.py``;
reference: src/emitters/{sun,sky,sunsky}.cpp).

The sky is baked on the host into a lat-long RGB map, which the scene then
samples as any environment map (alias sampling over its texels); the sun is
a directional light carrying the solar disk's radiance integrated over its
solid angle, or is burnt into the map. Two sky models: Hosek-Wilkie (the
reference's fitted model, over the authors' published RGB coefficients in
``data/hosek_rgb.npz``, a copy of the JAX package's file) and Preetham et
al. 1999's analytic daylight (Perez distribution, zenith chromaticity
polynomials, the solar-position algorithm of its appendix A.6).

Everything here is float64 numpy in the JAX module's order of operations,
so the baked map and the sun's irradiance equal the JAX package's bit for
bit. No tensor is made here: the builder casts the map when it builds the
scene.
"""
from __future__ import annotations

import numpy as np

# Perez coefficients: each row [t_factor, const] so coef = t_factor*T + const
# (Preetham Table A.1-A.3: distribution coefficients for Y, x, y)
_PEREZ_Y = np.array([
    [0.1787, -1.4630],
    [-0.3554, 0.4275],
    [-0.0227, 5.3251],
    [0.1206, -2.5771],
    [-0.0670, 0.3703],
])
_PEREZ_X = np.array([
    [-0.0193, -0.2592],
    [-0.0665, 0.0008],
    [-0.0004, 0.2125],
    [-0.0641, -0.8989],
    [-0.0033, 0.0452],
])
_PEREZ_Y2 = np.array([
    [-0.0167, -0.2608],
    [-0.0950, 0.0092],
    [-0.0079, 0.2102],
    [-0.0441, -1.6537],
    [-0.0109, 0.0529],
])

# sRGB conversion (shared convention with core.spectrum)
_XYZ_TO_SRGB = np.array(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], np.float64)

SUN_APP_RADIUS = np.deg2rad(0.5358 / 2.0)  # solar angular radius


def _perez(theta, gamma, c):
    """Perez sky luminance distribution F(theta, gamma)."""
    cos_t = np.maximum(np.cos(theta), 1e-3)
    cg = np.cos(gamma)
    return (1.0 + c[0] * np.exp(c[1] / cos_t)) * (
        1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * cg * cg)


def _zenith_chromaticity(T, theta_s):
    """Zenith luminance (Kcd/m^2) and CIE chromaticity (Preetham A.2)."""
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # Kcd/m^2
    t = theta_s
    tv = np.array([t ** 3, t ** 2, t, 1.0])
    Tm = np.array([T * T, T, 1.0])
    xz = Tm @ np.array([
        [0.00166, -0.00375, 0.00209, 0.0],
        [-0.02903, 0.06377, -0.03202, 0.00394],
        [0.11693, -0.21196, 0.06052, 0.25886],
    ]) @ tv
    yz = Tm @ np.array([
        [0.00275, -0.00610, 0.00317, 0.0],
        [-0.04214, 0.08970, -0.04153, 0.00516],
        [0.15346, -0.26756, 0.06670, 0.26688],
    ]) @ tv
    return max(Yz, 0.0), xz, yz


def sky_radiance_xyY(d_world, sun_dir, turbidity, up=(0.0, 1.0, 0.0)):
    """Sky radiance for directions d_world (..., 3), returned as CIE XYZ.

    Luminance is converted from the Perez Kcd/m^2 output to radiometric
    W/m^2/sr via the standard 683 lm/W photopic constant — the same
    normalization choice the reference's skyScale default exposes.
    """
    up = np.asarray(up, np.float64)
    d = np.asarray(d_world, np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)

    cos_theta = d @ up
    theta = np.arccos(np.clip(cos_theta, -1.0, 1.0))
    cos_gamma = np.clip(d @ s, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    theta_s = np.arccos(np.clip(s @ up, -1.0, 1.0))

    T = float(turbidity)
    cY = _PEREZ_Y @ [T, 1.0]
    cx = _PEREZ_X @ [T, 1.0]
    cy = _PEREZ_Y2 @ [T, 1.0]
    Yz, xz, yz = _zenith_chromaticity(T, theta_s)

    f0Y = _perez(0.0, theta_s, cY)
    f0x = _perez(0.0, theta_s, cx)
    f0y = _perez(0.0, theta_s, cy)

    Y = Yz * _perez(theta, gamma, cY) / max(f0Y, 1e-9)   # Kcd/m^2
    x = xz * _perez(theta, gamma, cx) / max(f0x, 1e-9)
    y = yz * _perez(theta, gamma, cy) / max(f0y, 1e-9)

    # horizon clamp: below-horizon directions fade to the horizon value
    Y = np.where(cos_theta < 0.0, Y * np.exp(6.0 * cos_theta), Y)

    # xyY -> XYZ; Y in Kcd/m^2 -> cd/m^2 -> W/m^2/sr
    Y_rad = Y * 1000.0 / 683.0
    y_safe = np.maximum(y, 1e-6)
    X = x / y_safe * Y_rad
    Z = (1.0 - x - y) / y_safe * Y_rad
    return np.stack([X, Y_rad, Z], axis=-1)


def sun_radiance_rgb(sun_dir, turbidity, up=(0.0, 1.0, 0.0)):
    """Mean radiance of the solar disk after atmospheric attenuation (RGB,
    W/m^2/sr). Broadband approximation of sun.cpp's spectral computation:
    extraterrestrial solar luminance attenuated by Preetham's optical-mass
    Rayleigh + aerosol terms evaluated at three representative wavelengths
    (615/535/465 nm for R/G/B)."""
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    cos_ts = float(np.clip(s @ np.asarray(up, np.float64), -1.0, 1.0))
    theta_s = np.arccos(cos_ts)
    if cos_ts <= 0.0:
        return np.zeros(3, np.float32)
    # relative optical mass (Preetham / Kasten-Young)
    m = 1.0 / (cos_ts + 0.15 * (93.885 - np.rad2deg(theta_s)) ** -1.253)
    lam = np.array([0.615, 0.535, 0.465])  # microns
    beta = 0.04608 * turbidity - 0.04586
    tau_r = np.exp(-m * 0.008735 * lam ** -4.08)       # Rayleigh
    tau_a = np.exp(-m * beta * lam ** -1.3)            # aerosol (alpha=1.3)
    # extraterrestrial mean solar radiance ~ 2.0e7 W/m^2/sr/um weighted to
    # an RGB white of luminance ~1.88e9 cd/m^2 over the solar disk
    L0 = np.array([1.95e4, 1.99e4, 1.96e4]) * 1000.0
    return (L0 * tau_r * tau_a).astype(np.float32)


def sun_direction(year, month, day, hour, minute, second,
                  latitude, longitude, timezone):
    """Sun direction (world, y-up, x east / z north) from time+place —
    the spherical solar-position algorithm of Preetham App. A.6 as exposed
    by the reference's <sun> location parameters (sun.cpp)."""
    t = hour + minute / 60.0 + second / 3600.0 - timezone
    day_of_year = _day_of_year(year, month, day)
    # solar time correction
    t_solar = (t + 0.170 * np.sin(4 * np.pi * (day_of_year - 80) / 373.0)
               - 0.129 * np.sin(2 * np.pi * (day_of_year - 8) / 355.0)
               + 12.0 * (longitude) / 180.0)
    delta = 0.4093 * np.sin(2 * np.pi * (day_of_year - 81) / 368.0)
    lat = np.deg2rad(latitude)
    h = np.pi * t_solar / 12.0
    theta = np.pi / 2 - np.arcsin(
        np.sin(lat) * np.sin(delta)
        - np.cos(lat) * np.cos(delta) * np.cos(h))
    phi = np.arctan2(-np.cos(delta) * np.sin(h),
                     np.cos(lat) * np.sin(delta)
                     - np.sin(lat) * np.cos(delta) * np.cos(h))
    # to world: y up, elevation = pi/2 - theta, azimuth phi from north (z+)
    el = np.pi / 2 - theta
    return np.array([np.cos(el) * np.sin(phi), np.sin(el),
                     np.cos(el) * np.cos(phi)], np.float64)


def _day_of_year(year, month, day):
    days = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    if year % 4 == 0 and (year % 100 != 0 or year % 400 == 0):
        days[1] = 29
    return sum(days[:month - 1]) + day


def bake_sky_envmap(sun_dir, turbidity=3.0, resolution=(128, 256),
                    scale=1.0, with_sun=False, sun_scale=1.0,
                    extend_below=True, model="hosek",
                    albedo=(0.2, 0.2, 0.2)):
    """Rasterize the analytic sky into a lat-long RGB envmap (H, W, 3) —
    the same bake-then-envmap architecture as sky.cpp's internal bitmap.

    ``model``: "hosek" (default — the reference's Hosek-Wilkie fitted
    model, per-channel ground ``albedo``) or "preetham" (the analytic
    daylight model). with_sun: burn the solar disk into
    the map (sunsky mode where the sun participates in envmap CDF
    importance sampling); otherwise callers pair the map with a
    directional sun emitter for exact hard shadows.
    """
    H, W = resolution
    v = (np.arange(H) + 0.5) / H
    u = (np.arange(W) + 0.5) / W
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    d = np.stack(np.broadcast_arrays(
        st[:, None] * cp[None, :], ct[:, None] * np.ones((1, W)),
        st[:, None] * sp[None, :]), axis=-1)
    if model == "hosek":
        rgb = hosek_sky_radiance_rgb(d, sun_dir, turbidity, albedo=albedo)
        if not extend_below:
            rgb = np.where((d[..., 1:2] < 0.0), 0.0, rgb)
        rgb = rgb * scale
    else:
        xyz = sky_radiance_xyY(d, sun_dir, turbidity)
        if not extend_below:
            xyz = np.where((d[..., 1:2] < 0.0), 0.0, xyz)
        rgb = np.clip(xyz @ _XYZ_TO_SRGB.T, 0.0, None) * scale
    if with_sun:
        s = np.asarray(sun_dir, np.float64)
        s = s / np.linalg.norm(s)
        cos_g = np.clip(d @ s, -1.0, 1.0)
        in_disk = cos_g >= np.cos(SUN_APP_RADIUS)
        sun_rgb = sun_radiance_rgb(sun_dir, turbidity) * sun_scale
        rgb = np.where(in_disk[..., None], rgb + sun_rgb, rgb)
    return rgb.astype(np.float32)


def sun_directional_irradiance(sun_dir, turbidity=3.0, sun_scale=1.0):
    """Irradiance vector for a directional-emitter stand-in of the sun:
    disk radiance integrated over its solid angle (sun.cpp's
    sunRadiusScale->0 collapse to a directional source)."""
    omega = 2.0 * np.pi * (1.0 - np.cos(SUN_APP_RADIUS))
    return sun_radiance_rgb(sun_dir, turbidity) * omega * sun_scale


# === Hosek-Wilkie sky model ===============================================
# "An Analytic Model for Full Spectral Sky-Dome Radiance" (Hosek & Wilkie,
# SIGGRAPH 2012) — the model the reference's sky.cpp actually evaluates
# (src/emitters/sunsky/skymodel.cpp:397 ArHosekSkyModel_GetRadianceInternal
# + CookConfiguration). The 9-parameter distribution and the quintic
# elevation spline are implemented here from the paper; the fitted RGB
# coefficient dataset is the authors' published supplemental data
# (data/hosek_rgb.npz, the JAX package's file copied byte for byte;
# third-party published constants, like the Perez tables above).

_HOSEK_CACHE = None


def _hosek_tables():
    global _HOSEK_CACHE
    if _HOSEK_CACHE is None:
        import os

        p = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "hosek_rgb.npz")
        z = np.load(p)
        _HOSEK_CACHE = (np.asarray(z["coefs"], np.float64),
                        np.asarray(z["rads"], np.float64))
    return _HOSEK_CACHE


def _hosek_cook(turbidity, albedo_rgb, solar_elevation):
    """Cook the per-channel 9-parameter configuration + zenith radiance:
    quintic Bernstein spline in cbrt(2 elev / pi), linear in the turbidity
    remainder, linear in albedo (paper sec. 4; per-channel ground albedo
    like sky.cpp's per-channel model states)."""
    coefs, rads = _hosek_tables()            # (3,2,10,6,9), (3,2,10,6)
    t = float(np.clip(turbidity, 1.0, 10.0))
    ti = int(min(np.floor(t), 9.0))          # 1..9
    tr = t - ti
    x = np.clip(2.0 * solar_elevation / np.pi, 0.0, 1.0) ** (1.0 / 3.0)
    from math import comb

    bw = np.array([comb(5, k) * x ** k * (1.0 - x) ** (5 - k)
                   for k in range(5 + 1)])   # (6,)
    alb = np.asarray(albedo_rgb, np.float64).reshape(3, 1)

    def blend(tab):  # tab (3, 2, 10, 6, ...) -> (3, ...)
        lo = np.tensordot(tab[:, :, ti - 1], bw, axes=([2], [0]))
        out = lo * (1.0 - tr)
        if ti < 10:
            hi = np.tensordot(tab[:, :, ti], bw, axes=([2], [0]))
            out = out + hi * tr
        # albedo lerp over axis 1
        return out[:, 0] * (1.0 - alb.reshape((3,) + (1,) * (out.ndim - 2))) \
            + out[:, 1] * alb.reshape((3,) + (1,) * (out.ndim - 2))

    cfg = blend(coefs)                       # (3, 9)
    rad = blend(rads[..., None])[..., 0]     # (3,)
    return cfg, rad


def hosek_sky_radiance_rgb(d_world, sun_dir, turbidity,
                           albedo=(0.15, 0.15, 0.15), up=(0.0, 1.0, 0.0)):
    """Hosek-Wilkie RGB sky radiance for directions (..., 3) -> (..., 3).

    F(theta, gamma) = (1 + A e^{B/(cos th + 0.01)}) *
       (C + D e^{E gamma} + F cos^2 gamma + G chi(H, gamma) + I sqrt(cos th))
    with chi the anisotropic mie-like phase term; radiance normalized by
    the CIE-Y sum exactly as the reference converts the dataset's units to
    its RGB radiance (sky.cpp:434 `/ 106.856980`)."""
    up = np.asarray(up, np.float64)
    d = np.asarray(d_world, np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    elev = np.pi / 2.0 - np.arccos(np.clip(s @ up, -1.0, 1.0))
    cfg, rad = _hosek_cook(turbidity, albedo, max(elev, 0.0))

    cos_theta = d @ up
    below = cos_theta < 0.0
    ct = np.clip(cos_theta, 0.0, 1.0)
    cos_gamma = np.clip(d @ s, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    out = np.zeros(d.shape[:-1] + (3,), np.float64)
    for c in range(3):
        A, B, C, D, E, F, G, I, H = cfg[c]
        chi = (1.0 + cos_gamma * cos_gamma) / np.power(
            1.0 + H * H - 2.0 * H * cos_gamma, 1.5)
        f = ((1.0 + A * np.exp(B / (ct + 0.01)))
             * (C + D * np.exp(E * gamma) + F * cos_gamma * cos_gamma
                + G * chi + I * np.sqrt(ct)))
        out[..., c] = f * rad[c]
    out /= 106.856980  # sum of CIE Y (sky.cpp:434)
    # horizon continuation like the Preetham path: fade below-horizon
    out = np.where(below[..., None], out * np.exp(6.0 * cos_theta)[..., None],
                   out)
    return np.clip(out, 0.0, None)
