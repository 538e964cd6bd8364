"""Adjoint particle tracer (port of
``mitsuba_tpu/render/integrators/ptracer.py``; the reference's
src/integrators/ptracer/ptracer.cpp over ParticleTracer, particleproc.h:128).

Light paths start at the emitters (``emitter.sample_ray``), walk through the
scene, and splat a camera connection at every vertex through the sensor's
importance (``sensor.sample_direct``): one wavefront of particles advances
bounce by bounce, and the light image is a scatter-add target
(``index_add_``, the JAX package's ``.at[].add``; on the card its float
atomics add in no fixed order).

Importance transport corrects the walk as the reference's BSDFs do in
EImportance mode: the shading-normal factor |wi.ns||wo.ng| / (|wi.ng||wo.ns|)
(Veach 5.3), and eta^2 on refraction (radiance carries 1/eta^2, importance
does not). Bounce i draws from dimension DIM_BASE + i * DIMS_PER_BOUNCE on,
as the path tracer does; the emitted ray draws at dimensions 0 and 1.
"""
from __future__ import annotations

import torch

from ...core import math as m
from ...core import rng as rng_mod
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import scene as scene_mod
from .. import sensor as sensor_mod
from .common import (DIM_BASE, DIM_BSDF, DIM_RR, DIMS_PER_BOUNCE,
                     IntegratorConfig, ray_offset)


def _shading_normal_correction(wi_local, wo_local, gn_local):
    """Importance-transport factor (Veach eq. 5.19), clamped to [0, 10]."""
    num = torch.abs(wi_local[..., 2] * m.dot(wo_local, gn_local))
    den = torch.abs(m.dot(wi_local, gn_local) * wo_local[..., 2])
    return torch.clamp(m.safe_div(num, torch.clamp(den, min=1e-9)), 0.0,
                       10.0)


def splat_pixels(uv, H: int, W: int):
    """Flat pixel rows (R,) int64 of film positions uv (R, 2), clamped to
    the film (the JAX package's int32 truncation toward zero)."""
    px = torch.clamp((uv[..., 0] * W).to(torch.int32), 0, W - 1)
    py = torch.clamp((uv[..., 1] * H).to(torch.int32), 0, H - 1)
    return py.to(torch.int64) * W + px.to(torch.int64)


def _splat_connection(light, sensor, value, p, valid, scene, static):
    """Camera connection of points p (R, 3) carrying ``value`` (R, 3):
    visibility, then a box splat of value x importance into ``light``
    (H, W, 3), in place (ptracer_proc.cpp splats the same way). Returns the
    shadow queries issued, occluded or not (an int64 tensor)."""
    H, W = light.shape[0], light.shape[1]
    ss = sensor_mod.sample_direct(sensor, p)
    ok = valid & ss.valid & (torch.amax(value, dim=-1) > 0)
    o_sh = p + ss.d * (1e-4 * (1.0 + torch.amax(torch.abs(p), dim=-1)))[
        ..., None]
    n_issued = ok.sum()
    vis = ~scene_mod.occluded(scene, static, o_sh, ss.d, 0.0,
                              ss.dist * (1.0 - 1e-3), active=ok)
    ok = ok & vis
    v = torch.where(ok[..., None], value * ss.imp[..., None], 0.0)
    light.view(H * W, 3).index_add_(0, splat_pixels(ss.uv, H, W), v)
    return n_issued


def trace_pass(scene, static, cfg: IntegratorConfig, sensor, light, sampler,
               particle_idx, sample_idx: int, with_stats: bool = False):
    """One particle per lane of ``particle_idx`` (R,): emit, walk, splat
    into ``light`` (H, W, 3), the raw light image, in place (develop it with
    ``develop_light_image``). ``sampler`` keys the draws as in ``path.li``.
    Returns ``light``, or (light, n_rays) with ``n_rays`` the issued ray
    queries (closest hits of the live lanes, shadow rays of the connections
    that got that far) when ``with_stats``."""
    types = static.bsdf_types
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 16
    u_e = rng_mod.uniform4(sampler, particle_idx, sample_idx, 0)
    u_ed = rng_mod.uniform2(sampler, particle_idx, sample_idx, 1)
    ers = em_mod.sample_ray(scene, static, u_e, u_ed)
    n_rays = torch.zeros((), dtype=torch.int64, device=light.device)

    # the emitter vertex itself: Le toward the camera (an area light seen
    # directly; ptracer.cpp's "emitted" event)
    if (em_mod.AREA in static.emitter_types
            or em_mod.SPHERE in static.emitter_types):
        ss = sensor_mod.sample_direct(sensor, ers.o)
        cos_c = m.dot(ers.n, ss.d)
        v0 = ers.radiance * m.safe_div(cos_c, ers.pdf_area)[..., None]
        n_rays = n_rays + _splat_connection(
            light, sensor, torch.clamp(v0, min=0.0), ers.o,
            ers.valid & ers.is_area & (cos_c > 0), scene, static)

    thr = torch.where(ers.valid[..., None], ers.weight, 0.0)
    o, d, active = ers.o, ers.d, ers.valid
    # a connection at surface bounce i joins i + 3 vertices (light, i + 1
    # surfaces, camera); the path tracer caps a path at max_depth + 1
    # vertices, so the bounces run 0 .. max_depth - 2
    for i in range(max(max_depth - 1, 0)):
        depth = i + 1
        dim0 = DIM_BASE + i * DIMS_PER_BOUNCE
        n_rays = n_rays + active.sum()
        its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf,
                                      active=active)
        active = active & its.valid
        bl = scene_mod.bsdf_locals(scene, its, static)
        nst = scene_mod.bsdf_nested(scene, its, static)
        gn_local = its.sh_frame.to_local(its.gn)

        # --- the camera connection at this vertex
        ss = sensor_mod.sample_direct(sensor, its.p)
        wo_cam = its.sh_frame.to_local(ss.d)
        f = bsdf_mod.eval(bl, its.wi, wo_cam, active_types=types, nested=nst)
        corr = _shading_normal_correction(its.wi, wo_cam, gn_local)
        n_rays = n_rays + _splat_connection(
            light, sensor, thr * f * corr[..., None],
            ray_offset(its.p, its.gn, ss.d), active, scene, static)

        # --- go on
        extend = active & (depth < max_depth)
        u_b = rng_mod.uniform4(sampler, particle_idx, sample_idx,
                               dim0 + DIM_BSDF)
        bs = bsdf_mod.sample(bl, its.wi, u_b[..., 0], u_b[..., 1:3],
                             active_types=types, nested=nst)
        corr_b = _shading_normal_correction(its.wi, bs.wo, gn_local)
        # importance transport: cancel the radiance convention's 1/eta^2
        thr_new = thr * bs.weight * (corr_b * bs.eta * bs.eta)[..., None]
        alive = (torch.amax(thr_new, dim=-1) > 0) & (bs.pdf > 0)
        d_new = m.normalize(its.sh_frame.to_world(bs.wo))
        o_new = ray_offset(its.p, its.gn, d_new)
        survive = torch.ones_like(alive)
        if depth >= cfg.rr_depth:
            # Russian roulette with a detached q
            q = torch.clamp(torch.amax(thr_new, dim=-1) / torch.clamp(
                torch.amax(thr, dim=-1), min=1e-12), max=0.95).detach()
            u_rr = rng_mod.uniform1(sampler, particle_idx, sample_idx,
                                    dim0 + DIM_RR)
            survive = u_rr < q
            thr_new = torch.where(survive[..., None],
                                  thr_new * m.safe_div(1.0, q)[..., None],
                                  thr_new)
        active_next = extend & alive & survive
        an = active_next[..., None]
        thr = torch.where(an, thr_new, thr)
        o = torch.where(an, o_new, o)
        d = torch.where(an, d_new, d)
        active = active_next
    return (light, n_rays) if with_stats else light


def develop_light_image(light, n_particles: int):
    """pixel = (W H / N) x the raw splat sum (ptracer_proc.cpp's scale)."""
    H, W = light.shape[0], light.shape[1]
    return light * (float(H * W) / float(n_particles))
