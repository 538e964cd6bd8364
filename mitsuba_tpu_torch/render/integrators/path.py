"""Wavefront path tracer with NEE + MIS + Russian roulette (port of
``mitsuba_tpu/render/integrators/path.py``).

Per vertex (path.cpp:119-300): the environment's radiance on escaped rays and
the emitter-hit contribution, each weighted by the power heuristic against
the NEE pdf, one next-event sample weighted against the BSDF pdf, BSDF
sampling to extend the path, and Russian roulette from ``rr_depth`` on.
The whole wavefront advances through an eager loop over bounces with
per-lane ``active`` masks; dead lanes trace degenerate rays (t_max = t_min),
so every lane keeps its place.
"""
from __future__ import annotations

import torch

from ...core import math as m
from ...core import rng as rng_mod
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import scene as scene_mod
from .common import (
    DIM_BASE, DIM_BSDF, DIM_NEE, DIM_RR, DIMS_PER_BOUNCE,
    IntegratorConfig, mis_power, ray_offset,
)


def li(scene, static, cfg: IntegratorConfig, o, d, seed, pixel, sample,
       with_stats: bool = False, pixel_spread=None):
    """Radiance along primary rays o, d (R, 3). Returns (R, 3), or
    ((R, 3), n_rays) with ``n_rays`` the exact count of issued ray queries
    (closest-hit plus shadow), an int64 tensor, when ``with_stats``.

    ``pixel_spread``: the angular pixel size (radians) for the ray-cone MIP
    footprint of textures at the primary hit; None disables MIP lookups."""
    R = o.shape[0]
    dev = o.device
    types = static.bsdf_types
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 16

    L = torch.zeros((R, 3), device=dev)
    thr = torch.ones((R, 3), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(R, device=dev)
    prev_delta = torch.ones(R, dtype=torch.bool, device=dev)  # sensor vertex
    eta = torch.ones(R, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(max_depth):
        depth = i + 1  # 1-based like rRec.depth
        dim0 = DIM_BASE + i * DIMS_PER_BOUNCE
        n_rays = n_rays + active.sum()

        # primary rays leave in raster order, coherent already: the first
        # closest-hit query skips the BVH query's sort
        its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf,
                                      active=active, presorted=i == 0)

        # --- escaped rays: environment emitter with MIS (path.cpp:234-248)
        if static.has_env:
            env_L, lum_pdf = em_mod.eval_env_pdf(scene, static, d)
            w = torch.where(prev_delta, 1.0, mis_power(prev_pdf, lum_pdf))
            show = active & ~its.valid
            L = L + torch.where(show[..., None], thr * env_L * w[..., None], 0.0)

        active = active & its.valid

        # --- emitted radiance at the hit (path.cpp:176-190)
        Le = scene_mod.emitted_radiance(scene, static, its, d)
        lum_pdf_hit = scene_mod.pdf_emitter_hit(scene, its, o)
        w_hit = torch.where(prev_delta, 1.0, mis_power(prev_pdf, lum_pdf_hit))
        show = active & (its.emitter_id >= 0)
        L = L + torch.where(show[..., None], thr * Le * w_hit[..., None], 0.0)

        # the final vertex only collects emission (path.cpp depth check)
        extend = active & (depth < max_depth)

        # ray-cone MIP footprint at the primary hit only (the reference
        # filters through the camera ray's differentials alone). Later
        # bounces look up the base level: the JAX package's trilinear
        # lookup at footprint 0 gives the same value.
        fp_uv = None
        if i == 0 and pixel_spread is not None and static.has_textures:
            fp_uv = scene_mod.uv_footprint(scene, its, pixel_spread)
        bl = scene_mod.bsdf_locals(scene, its, static, fp_uv=fp_uv)

        # --- next event estimation (path.cpp:196-263)
        if static.emitter_types:
            u_nee = rng_mod.uniform4(seed, pixel, sample, dim0 + DIM_NEE)
            ds = em_mod.sample_direct(scene, static, its.p, u_nee[..., :3])
            nee_ok = extend & ds.valid & (ds.pdf_sa > 0)
            n_rays = n_rays + nee_ok.sum()
            o_sh = ray_offset(its.p, its.gn, ds.d)
            vis = ~scene_mod.occluded(scene, static, o_sh, ds.d, 0.0,
                                      ds.dist * (1.0 - 1e-3), active=nee_ok)
            wo_local = its.sh_frame.to_local(ds.d)
            f = bsdf_mod.eval(bl, its.wi, wo_local, active_types=types)
            bsdf_pdf_nee = bsdf_mod.pdf(bl, its.wi, wo_local, active_types=types)
            w_nee = torch.where(ds.delta, 1.0, mis_power(ds.pdf_sa, bsdf_pdf_nee))
            contrib = thr * f * ds.radiance \
                * m.safe_div(w_nee, ds.pdf_sa)[..., None]
            L = L + torch.where((nee_ok & vis)[..., None], contrib, 0.0)

        # --- BSDF sampling (path.cpp:215-233)
        u_b = rng_mod.uniform4(seed, pixel, sample, dim0 + DIM_BSDF)
        bs = bsdf_mod.sample(bl, its.wi, u_b[..., 0], u_b[..., 1:3],
                             active_types=types)
        thr_new = thr * bs.weight
        eta = torch.where(extend, eta * bs.eta, eta)
        alive = (torch.amax(thr_new, dim=-1) > 0) & (bs.pdf > 0)

        d_new = m.normalize(its.sh_frame.to_world(bs.wo))
        o_new = ray_offset(its.p, its.gn, d_new)

        # --- Russian roulette (path.cpp:276-286), only past rr_depth
        q = torch.clamp(torch.amax(thr_new, dim=-1) * eta * eta, max=0.95)
        if depth >= cfg.rr_depth:
            u_rr = rng_mod.uniform1(seed, pixel, sample, dim0 + DIM_RR)
            survive = u_rr < q
            thr_new = torch.where(survive[..., None],
                                  thr_new * m.safe_div(1.0, q)[..., None],
                                  thr_new)
            active_next = extend & alive & survive
        else:
            active_next = extend & alive

        an = active_next[..., None]
        thr = torch.where(an, thr_new, thr)
        o = torch.where(an, o_new, o)
        d = torch.where(an, d_new, d)
        prev_pdf = torch.where(active_next, bs.pdf, prev_pdf)
        prev_delta = torch.where(active_next, bs.is_delta, prev_delta)
        active = active_next

    if with_stats:
        return L, n_rays
    return L
