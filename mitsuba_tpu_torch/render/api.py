"""Top-level render orchestration (port of ``mitsuba_tpu/render/api.py``: the
PATH, DIRECT, AO and FIELD integrators with every sampler and every
reconstruction filter of the JAX package, the meters' render, the
hero-wavelength spectral render and the multichannel stack; the other
integrators land in a later slice).

The whole image is one wavefront per sample: every pixel is a lane. A host
loop runs the sample passes and accumulates into the film. A 1x1 meter
(radiance, irradiance, fluence) renders through ``render_meter`` instead:
its samples are the lanes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng as rng_mod
from ..core import spectrum as spec_mod
from ..device import check_on, resolve_device
from . import film as film_mod
from . import rfilter
from . import sensor as sensor_mod
from .integrators import common as icommon
from .integrators import direct as int_direct
from .integrators import misc as int_misc
from .integrators import path as int_path

# the integrators the port renders, by type tag
_LI = {icommon.PATH: int_path.li, icommon.DIRECT: int_direct.li,
       icommon.AO: int_misc.li_ao, icommon.FIELD: int_misc.li_field}

# sampler types, the JAX API's numbering (api.py:33-39; not rng's tags)
INDEPENDENT = 0
STRATIFIED = 1
LDSAMPLER = 2
SOBOL = 3
HALTON = 4
HAMMERSLEY = 5
FAURE = 6
# the rng mode each draws with (api.py:111-117); the stratified sampler
# draws independent numbers and stratifies the pixel jitter alone
_RNG_MODES = {LDSAMPLER: rng_mod.LD, SOBOL: rng_mod.SOBOL,
              HALTON: rng_mod.HALTON, HAMMERSLEY: rng_mod.HAMMERSLEY,
              FAURE: rng_mod.FAURE}


@dataclass(frozen=True)
class RenderSettings:
    width: int = 256
    height: int = 256
    spp: int = 16
    filter_type: int = rfilter.GAUSSIAN
    sampler_type: int = INDEPENDENT
    spp_per_pass: int = 4
    seed: int = 0


def sampler_of(settings: RenderSettings) -> rng_mod.Sampler:
    """The draws' sampler record: the seed, the sampler type's rng mode and
    the total sample count (hammersley's N)."""
    return rng_mod.Sampler(
        seed=settings.seed,
        kind=_RNG_MODES.get(settings.sampler_type, rng_mod.INDEPENDENT),
        n=max(int(settings.spp), 1))


def pixel_sample_positions(settings: RenderSettings, pixel_idx, sample_idx,
                           sampler):
    """Continuous film positions of (pixel, sample) lanes. ``sampler`` is the
    render's ``rng.Sampler`` (an int seed: the independent one). Stratified:
    spp factored into an nx x ny grid, jittered within the stratum
    (stratified.cpp); the others: the sampler's jitter."""
    W = settings.width
    px = (pixel_idx % W).to(torch.float32)
    py = torch.div(pixel_idx, W, rounding_mode="floor").to(torch.float32)
    u = rng_mod.uniform2(sampler, pixel_idx, sample_idx, icommon.DIM_SENSOR)
    if settings.sampler_type == STRATIFIED:
        nx = max(int(settings.spp ** 0.5), 1)
        ny = max(settings.spp // nx, 1)
        s = sample_idx % (nx * ny)
        u = torch.stack([(u[..., 0] + float(s % nx)) / nx,
                         (u[..., 1] + float(s // nx)) / ny], dim=-1)
    return torch.stack([px, py], dim=-1) + u


def _li(cfg: icommon.IntegratorConfig):
    """The integrator's ``li``; raises for one the port does not render."""
    if cfg.type not in _LI:
        raise NotImplementedError(
            f"integrator type {cfg.type} lands in a later slice of the port")
    return _LI[cfg.type]


def render_pass(scene, static, sensor, cfg: icommon.IntegratorConfig,
                settings: RenderSettings, film, sample_base: int,
                n_samples: int, stats=None):
    """Accumulate ``n_samples`` sample passes into ``film``; adds the issued
    ray queries to ``stats["n_rays"]`` (an int64 tensor) when given. Runs
    under the caller's grad mode: the trainer differentiates through it."""
    H, W = settings.height, settings.width
    dev = film.data.device
    pixel_idx = torch.arange(H * W, dtype=torch.int64, device=dev)
    sampler = sampler_of(settings)
    res = torch.tensor([W, H], dtype=torch.float32, device=dev)
    # ray-cone texture filtering needs the pixel's angular size; the JAX
    # package filters the path tracer's primary hits alone (api.py:124)
    kw = {}
    if cfg.type == icommon.PATH:
        kw["pixel_spread"] = (sensor_mod.pixel_spread(sensor, W)
                              if static.has_textures else None)
    li = _li(cfg)
    for s in range(n_samples):
        sample_idx = sample_base + s
        pos = pixel_sample_positions(settings, pixel_idx, sample_idx, sampler)
        uv = pos / res
        u_ap = rng_mod.uniform2(sampler, pixel_idx, sample_idx,
                                icommon.DIM_APERTURE)
        o, d = sensor_mod.sample_ray(sensor, uv, u_ap)
        L, n = li(scene, static, cfg, o, d, sampler, pixel_idx, sample_idx,
                  with_stats=True, **kw)
        # a meter's constant importance turns the radiance mean into
        # irradiance or fluence (1 for a camera: no multiply)
        w = sensor_mod.ray_weight(sensor)
        if w != 1.0:
            L = L * w
        if stats is not None:
            stats["n_rays"] = stats["n_rays"] + n
        if settings.filter_type == rfilter.BOX:
            # full-image fast path: one jittered sample per pixel lane
            film = film_mod.splat_aligned(film, L.reshape(H, W, 3))
        else:
            film = film_mod.splat_grid(film, pos.reshape(H, W, 2),
                                       L.reshape(H, W, 3), settings.filter_type)
    return film


# lanes of one render_meter chunk (api.py:579)
METER_CHUNK = 1 << 15
# the integrators whose 1x1 meter renders go to render_meter (api.py:640)
_METER_INTEGRATORS = (icommon.PATH, icommon.DIRECT, icommon.AO)


def render_meter(scene, static, sensor, cfg: icommon.IntegratorConfig,
                 settings: RenderSettings, stats=None):
    """A meter's measurement (the JAX ``render_meter``): pixel 0, one lane
    per sample in chunks of ``METER_CHUNK`` (the sample count rounded up to
    whole chunks), the independent sampler whatever the settings say, the
    mean of the lanes times ``ray_weight``. Returns (1, 1, 3); adds the
    issued ray queries to ``stats["n_rays"]`` when given."""
    dev = scene.tri_p0.device
    li = _li(cfg)
    sampler = settings.seed  # an int seed: the independent sampler
    pixel_idx = torch.zeros(METER_CHUNK, dtype=torch.int64, device=dev)
    lanes = torch.arange(METER_CHUNK, dtype=torch.int64, device=dev)
    total = torch.zeros(3, device=dev)
    n = 0
    while n < settings.spp:
        sample_idx = lanes + n
        u = rng_mod.uniform2(sampler, pixel_idx, sample_idx,
                             icommon.DIM_SENSOR)
        u_ap = rng_mod.uniform2(sampler, pixel_idx, sample_idx,
                                icommon.DIM_APERTURE)
        o, d = sensor_mod.sample_ray(sensor, u, u_ap)
        L, k = li(scene, static, cfg, o, d, sampler, pixel_idx, sample_idx,
                  with_stats=True)
        if stats is not None:
            stats["n_rays"] = stats["n_rays"] + k
        total = total + L.sum(dim=0)
        n += METER_CHUNK
    return (total / n * sensor_mod.ray_weight(sensor)).reshape(1, 1, 3)


def render_spectral(scene, static, sensor, cfg: icommon.IntegratorConfig,
                    settings: RenderSettings, device=None,
                    with_stats: bool = False):
    """Hero-wavelength spectral render (the JAX ``render_spectral``; the
    reference's spectral build, spectrum.h:25-32): the path tracer with
    ``spectral_wl`` (RGB scene parameters lifted to smooth spectra on the
    fly, dielectrics with a ``cauchy_b`` dispersing), whatever ``cfg.type``
    says; one sample per pass, the independent sampler (a ``Sampler``
    record of the settings' seed) whatever the settings' sampler, box
    splats, each sample's wavelengths turned to RGB by
    ``spectrum.spectral_to_rgb``. Returns the (H, W, 3) linear-sRGB image,
    or (image, n_rays) when ``with_stats``."""
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    H, W = settings.height, settings.width
    sampler = rng_mod.Sampler(seed=settings.seed)
    pixel_idx = torch.arange(H * W, dtype=torch.int64, device=dev)
    res = torch.tensor([W, H], dtype=torch.float32, device=dev)
    film = film_mod.Film.empty(H, W, dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for s in range(settings.spp):
            pos = pixel_sample_positions(settings, pixel_idx, s, sampler)
            u_ap = rng_mod.uniform2(sampler, pixel_idx, s,
                                    icommon.DIM_APERTURE)
            o, d = sensor_mod.sample_ray(sensor, pos / res, u_ap)
            u_wl = rng_mod.uniform1(sampler, pixel_idx, s,
                                    icommon.DIM_WAVELENGTH)
            wl, pdf = spec_mod.sample_wavelengths(u_wl)
            L, n = int_path.li(scene, static, cfg, o, d, sampler, pixel_idx,
                               s, with_stats=True, spectral_wl=wl)
            n_rays = n_rays + n
            L = spec_mod.spectral_to_rgb(L, wl, pdf)
            film = film_mod.splat_aligned(film, L.reshape(H, W, 3))
        img = film_mod.develop(film)
    return (img, int(n_rays)) if with_stats else img


def render_multichannel(scene, static, sensor, cfgs,
                        settings: RenderSettings, device=None):
    """The multichannel integrator (misc/multichannel.cpp): ``render`` of
    each integrator of ``cfgs``, stacked on the last axis in order (3
    channels each). Returns (H, W, 3 * len(cfgs))."""
    return torch.cat([render(scene, static, sensor, c, settings,
                             device=device) for c in cfgs], dim=-1)


def render(scene, static, sensor, cfg: icommon.IntegratorConfig,
           settings: RenderSettings, device=None, with_stats: bool = False):
    """Full render: host loop over passes of ``spp_per_pass`` samples, or
    ``render_meter`` for a 1x1 meter under PATH, DIRECT or AO.

    Runs on ``device`` (CUDA by default), where the scene and sensor must
    already live. Returns the developed (H, W, 3) image, or (image, n_rays)
    with the exact number of issued ray queries when ``with_stats``.
    """
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    _li(cfg)  # raises for an integrator the port does not render
    if (settings.width == settings.height == 1
            and sensor.type in sensor_mod.METERS
            and cfg.type in _METER_INTEGRATORS):
        stats = {"n_rays": torch.zeros((), dtype=torch.int64, device=dev)}
        with torch.no_grad():
            img = render_meter(scene, static, sensor, cfg, settings, stats)
        return (img, int(stats["n_rays"])) if with_stats else img
    H, W = settings.height, settings.width
    chunk = min(settings.spp_per_pass, settings.spp)
    film = film_mod.Film.empty(H, W, dev)
    stats = {"n_rays": torch.zeros((), dtype=torch.int64, device=dev)}
    s = 0
    with torch.no_grad():
        while s < settings.spp:
            n = min(chunk, settings.spp - s)
            film = render_pass(scene, static, sensor, cfg, settings, film, s,
                               n, stats)
            s += n
        img = film_mod.develop(film)
    if with_stats:
        return img, int(stats["n_rays"])
    return img
