"""Top-level render orchestration (port of ``mitsuba_tpu/render/api.py``: the
PATH, VOLPATH, DIRECT, AO and FIELD integrators with every sampler and every
reconstruction filter of the JAX package, the meters' render, the particle
tracer's, the bidirectional tracer's and the Metropolis family's renders,
the hero-wavelength spectral render and the multichannel stack; the other
integrators land in a later slice).

The whole image is one wavefront per sample: every pixel is a lane. A host
loop runs the sample passes and accumulates into the film. A 1x1 meter
(radiance, irradiance, fluence) renders through ``render_meter`` instead:
its samples are the lanes. PTRACER and BDPT scatter-add into a light image
(``render_light_traced``, ``render_bdpt``), and PSSMLT, MLT and ERPT splat
their chains' states into a film (``render_mlt``, ``render_erpt``);
``render_pass`` does not take them, as in the JAX package. The port's CLI
renders them through ``render``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng as rng_mod
from ..core import spectrum as spec_mod
from ..device import check_on, resolve_device
from ..utils.logging import get_logger
from . import film as film_mod
from . import rfilter
from . import sensor as sensor_mod
from .integrators import bdpt as int_bdpt
from .integrators import common as icommon
from .integrators import direct as int_direct
from .integrators import misc as int_misc
from .integrators import mlt as int_mlt
from .integrators import path as int_path
from .integrators import ptracer as int_pt
from .integrators import volpath as int_volpath

# the integrators the port renders, by type tag
_LI = {icommon.PATH: int_path.li, icommon.DIRECT: int_direct.li,
       icommon.AO: int_misc.li_ao, icommon.FIELD: int_misc.li_field,
       icommon.VOLPATH: int_volpath.li}

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


# the integrators without an ``li``, which ``render`` sends to their own
# renders (the JAX api.py:648-655)
WHOLE_IMAGE = (icommon.PTRACER, icommon.BDPT, icommon.PSSMLT, icommon.MLT,
               icommon.ERPT)


def _li(cfg: icommon.IntegratorConfig):
    """The integrator's ``li``; raises for one the port does not render.
    The types of WHOLE_IMAGE have no ``li``: the JAX ``_li_fn``
    (api.py:63-74) raises ValueError for them, and so does this one."""
    if cfg.type in WHOLE_IMAGE:
        raise ValueError(f"unknown integrator type {cfg.type}")
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
_METER_INTEGRATORS = (icommon.PATH, icommon.DIRECT, icommon.VOLPATH,
                      icommon.AO)


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


def render_light_traced(scene, static, sensor, cfg: icommon.IntegratorConfig,
                        settings: RenderSettings, device=None,
                        with_stats: bool = False):
    """The adjoint render (ptracer; the JAX ``render_light_traced``): spp
    passes of H x W particles each, the independent sampler (a ``Sampler``
    of the settings' seed) whatever the settings' sampler, every vertex
    splatted to the camera (box) and the light image scaled by pixels over
    particles. Returns the (H, W, 3) image, or (image, n_rays) when
    ``with_stats``."""
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    H, W = settings.height, settings.width
    P = H * W  # particles per pass
    sampler = rng_mod.Sampler(seed=settings.seed)
    pid = torch.arange(P, dtype=torch.int64, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        light = torch.zeros((H, W, 3), device=dev)
        for s in range(settings.spp):
            n_rays = n_rays + int_pt.trace_pass(
                scene, static, cfg, sensor, light, sampler, pid, s,
                with_stats=True)[1]
        img = int_pt.develop_light_image(light, settings.spp * P)
    return (img, int(n_rays)) if with_stats else img


def render_bdpt(scene, static, sensor, cfg: icommon.IntegratorConfig,
                settings: RenderSettings, device=None,
                with_stats: bool = False):
    """The bidirectional render (the JAX ``render_bdpt``): per sample an eye
    and a light subpath for every pixel lane, the independent sampler (the
    pixel jitter stratified where the settings ask for the stratified
    sampler, as there) whatever the settings' sampler; the t >= 1
    strategies land on the lane's pixel, the t = 0 ones scatter-add into the
    shared light image (bdpt_wr.cpp), box-filtered, and the sum is divided by
    spp. Returns the (H, W, 3) image, or (image, n_rays) when
    ``with_stats``."""
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    H, W = settings.height, settings.width
    sampler = rng_mod.Sampler(seed=settings.seed)
    pixel_idx = torch.arange(H * W, dtype=torch.int64, device=dev)
    res = torch.tensor([W, H], dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        film = torch.zeros((H, W, 3), device=dev)
        for s in range(settings.spp):
            pos = pixel_sample_positions(settings, pixel_idx, s, sampler)
            u_ap = rng_mod.uniform2(sampler, pixel_idx, s,
                                    icommon.DIM_APERTURE)
            o, d = sensor_mod.sample_ray(sensor, pos / res, u_ap)
            L, sp_uv, sp_val, n = int_bdpt.li_and_splats(
                scene, static, cfg, sensor, o, d, sampler, pixel_idx, s,
                with_stats=True)
            n_rays = n_rays + n
            film = film + L.reshape(H, W, 3)
            if sp_uv.shape[0]:
                # one light subpath per pixel lane and pass: scale 1
                ok = (sp_uv[..., 0] >= 0).to(torch.float32)[..., None]
                film.view(H * W, 3).index_add_(
                    0, int_pt.splat_pixels(sp_uv, H, W).reshape(-1),
                    (sp_val * ok).reshape(-1, 3))
        img = film / float(settings.spp)
    return (img, int(n_rays)) if with_stats else img


def render_mlt(scene, static, sensor, cfg: icommon.IntegratorConfig,
               settings: RenderSettings, device=None,
               with_stats: bool = False):
    """The pssmlt and mlt render (the JAX ``render_mlt``): spp x H x W
    mutations over min(chain_count, max(1024, H W)) chains, one per lane,
    drawn from the independent sampler of the settings' seed whatever the
    settings' sampler; b from ``cfg.luminance_samples`` samples, the
    chains seeded from 4 candidates each, and the film times b H W / N with
    N the mutations made. Logs b and the mean acceptance, and keeps them in
    ``mlt.LAST_RUN``. Returns the (H, W, 3) image, or (image, n_rays) when
    ``with_stats``."""
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    H, W = settings.height, settings.width
    n_pixels = H * W
    seed = int(settings.seed)
    n_chains = min(cfg.chain_count, max(1024, n_pixels))
    n_passes = max(1, -(-settings.spp * n_pixels // n_chains))
    mlt_mode = cfg.type == icommon.MLT
    with torch.no_grad():
        b, n_rays = int_mlt.estimate_b(
            scene, static, sensor, cfg, W, H, seed, cfg.luminance_samples,
            mlt_mode=mlt_mode, device=dev)
        st, n = int_mlt.seed_chains(scene, static, sensor, cfg, W, H, seed,
                                    n_chains, mlt_mode=mlt_mode, device=dev)
        film = torch.zeros((H, W, 3), device=dev)
        _, film, acc, k = int_mlt.chain_steps(
            scene, static, sensor, cfg, W, H, seed, st, film, 0, n_passes,
            mlt_mode=mlt_mode)
        img = film * (b * n_pixels / (n_passes * n_chains))
    int_mlt.LAST_RUN.clear()
    int_mlt.LAST_RUN.update(b=float(b), acceptance=float(acc),
                            chains=n_chains, mutations=n_passes)
    get_logger().info(
        "%s: %d chains x %d mutations, b=%.4g, mean acceptance %.3f",
        "mlt" if mlt_mode else "pssmlt", n_chains, n_passes, float(b),
        float(acc))
    return (img, int(n_rays + n + k)) if with_stats else img


def render_erpt(scene, static, sensor, cfg: icommon.IntegratorConfig,
                settings: RenderSettings, device=None,
                with_stats: bool = False):
    """The erpt render (the JAX ``render_erpt``): max(1, spp H W / S)
    passes of S = min(H W, 65536) path-traced seeds, each redistributed
    over a ``cfg.chain_length`` chain, the independent sampler whatever the
    settings' sampler; the film times H W over the seeds. Returns the (H,
    W, 3) image, or (image, n_rays) when ``with_stats``."""
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    H, W = settings.height, settings.width
    n_pixels = H * W
    seed = int(settings.seed)
    n_seeds = min(n_pixels, 65536)
    passes = max(1, settings.spp * n_pixels // n_seeds)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        film = torch.zeros((H, W, 3), device=dev)
        for p in range(passes):
            film, n = int_mlt.erpt_pass(scene, static, sensor, cfg, W, H,
                                        seed, film, p, n_seeds,
                                        cfg.chain_length)
            n_rays = n_rays + n
        img = film * (n_pixels / (passes * n_seeds))
    int_mlt.LAST_RUN.clear()
    int_mlt.LAST_RUN.update(passes=passes, seeds=n_seeds,
                            chain_length=cfg.chain_length)
    return (img, int(n_rays)) if with_stats else img


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
    ``render_meter`` for a 1x1 meter under PATH, VOLPATH, DIRECT or AO,
    ``render_bdpt`` under BDPT, ``render_light_traced`` under PTRACER,
    ``render_mlt`` under PSSMLT and MLT, ``render_erpt`` under ERPT.

    Runs on ``device`` (CUDA by default), where the scene and sensor must
    already live. Returns the developed (H, W, 3) image, or (image, n_rays)
    with the exact number of issued ray queries when ``with_stats``.
    """
    if cfg.type == icommon.BDPT:
        return render_bdpt(scene, static, sensor, cfg, settings, device,
                           with_stats)
    if cfg.type == icommon.PTRACER:
        return render_light_traced(scene, static, sensor, cfg, settings,
                                   device, with_stats)
    if cfg.type in (icommon.PSSMLT, icommon.MLT):
        return render_mlt(scene, static, sensor, cfg, settings, device,
                          with_stats)
    if cfg.type == icommon.ERPT:
        return render_erpt(scene, static, sensor, cfg, settings, device,
                           with_stats)
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
