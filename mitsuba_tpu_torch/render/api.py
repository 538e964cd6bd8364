"""Top-level render orchestration (port of ``mitsuba_tpu/render/api.py``: the
PATH integrator with the independent sampler; the other samplers land in a
later slice).

The whole image is one wavefront per sample: every pixel is a lane. A host
loop runs the sample passes and accumulates into the film.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng as rng_mod
from ..device import check_on, resolve_device
from . import film as film_mod
from . import rfilter
from . import sensor as sensor_mod
from .integrators import common as icommon
from .integrators import path as int_path

@dataclass(frozen=True)
class RenderSettings:
    width: int = 256
    height: int = 256
    spp: int = 16
    filter_type: int = rfilter.GAUSSIAN
    spp_per_pass: int = 4
    seed: int = 0


def pixel_sample_positions(settings: RenderSettings, pixel_idx, sample_idx, seed):
    """Continuous film positions of (pixel, sample) lanes: pure PCG jitter."""
    W = settings.width
    px = (pixel_idx % W).to(torch.float32)
    py = torch.div(pixel_idx, W, rounding_mode="floor").to(torch.float32)
    u = rng_mod.uniform2(seed, pixel_idx, sample_idx, icommon.DIM_SENSOR)
    return torch.stack([px, py], dim=-1) + u


def render_pass(scene, static, sensor, cfg: icommon.IntegratorConfig,
                settings: RenderSettings, film, sample_base: int,
                n_samples: int, stats=None):
    """Accumulate ``n_samples`` sample passes into ``film``; adds the issued
    ray queries to ``stats["n_rays"]`` (an int64 tensor) when given."""
    H, W = settings.height, settings.width
    dev = film.data.device
    pixel_idx = torch.arange(H * W, dtype=torch.int64, device=dev)
    seed = settings.seed
    res = torch.tensor([W, H], dtype=torch.float32, device=dev)
    # ray-cone texture filtering needs the pixel's angular size
    spread = sensor_mod.pixel_spread(sensor, W) if static.has_textures else None
    for s in range(n_samples):
        sample_idx = sample_base + s
        pos = pixel_sample_positions(settings, pixel_idx, sample_idx, seed)
        uv = pos / res
        u_ap = rng_mod.uniform2(seed, pixel_idx, sample_idx, icommon.DIM_APERTURE)
        o, d = sensor_mod.sample_ray(sensor, uv, u_ap)
        L, n = int_path.li(scene, static, cfg, o, d, seed, pixel_idx,
                           sample_idx, with_stats=True, pixel_spread=spread)
        if stats is not None:
            stats["n_rays"] = stats["n_rays"] + n
        film = film_mod.splat_grid(film, pos.reshape(H, W, 2),
                                   L.reshape(H, W, 3), settings.filter_type)
    return film


def render(scene, static, sensor, cfg: icommon.IntegratorConfig,
           settings: RenderSettings, device=None, with_stats: bool = False):
    """Full render: host loop over passes of ``spp_per_pass`` samples.

    Runs on ``device`` (CUDA by default), where the scene and sensor must
    already live. Returns the developed (H, W, 3) image, or (image, n_rays)
    with the exact number of issued ray queries when ``with_stats``.
    """
    dev = resolve_device(device)
    check_on(scene.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    if cfg.type != icommon.PATH:
        raise NotImplementedError(
            f"integrator type {cfg.type} lands in a later slice of the port")
    if settings.filter_type != rfilter.GAUSSIAN:
        # the JAX package takes its splat_aligned path for the box filter
        raise NotImplementedError(
            f"filter {settings.filter_type} lands in a later slice of the port")
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
