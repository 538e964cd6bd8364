"""Wavefront path tracer with NEE + MIS + Russian roulette (port of
``mitsuba_tpu/render/integrators/path.py``).

Per vertex (path.cpp:119-300): the environment's radiance on escaped rays and
the emitter-hit contribution, each weighted by the power heuristic against
the NEE pdf, one next-event sample weighted against the BSDF pdf, BSDF
sampling to extend the path, and Russian roulette from ``rr_depth`` on.
The whole wavefront advances through an eager loop over bounces with
per-lane ``active`` masks; dead lanes trace degenerate rays (t_max = t_min),
so every lane keeps its place. With ``spectral_wl`` the three channels carry
three wavelengths (the hero-wavelength mode of ``api.render_spectral``).
"""
from __future__ import annotations

import torch

from ...core import math as m
from ...core import rng as rng_mod
from ...core import spectrum as spec_mod
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import scene as scene_mod
from .common import (
    DIM_BASE, DIM_BSDF, DIM_NEE, DIM_RR, DIMS_PER_BOUNCE,
    IntegratorConfig, mis_power, ray_offset,
)


def roulette_probability(thr, eta):
    """Survival probability of Russian roulette (path.cpp:276-286). It is a
    sampling probability, so it is detached: the 1/q compensation stays a
    constant under autograd (the detached-sampling estimator)."""
    return torch.clamp(torch.amax(thr, dim=-1) * eta * eta, max=0.95).detach()


def li(scene, static, cfg: IntegratorConfig, o, d, sampler, pixel, sample,
       with_stats: bool = False, pixel_spread=None, spectral_wl=None):
    """Radiance along primary rays o, d (R, 3). Returns (R, 3), or
    ((R, 3), n_rays) with ``n_rays`` the exact count of issued ray queries
    (closest-hit plus shadow), an int64 tensor, when ``with_stats``.
    ``sampler`` keys the draws: the render's ``rng.Sampler``, or an int seed
    for the independent sampler.

    ``pixel_spread``: the angular pixel size (radians) for the ray-cone MIP
    footprint of textures at the primary hit; None disables MIP lookups.

    ``spectral_wl``: (R, 3) wavelengths (nm) for hero-wavelength transport
    (the JAX path.py:74-105): every RGB reflectance and emission factor is
    lifted to a smooth spectrum at those wavelengths (emission times the
    reference white ``spectrum.d65``), a dielectric's eta takes the Cauchy
    shift of its row's ``cauchy_b`` at the hero wavelength, and the two
    companion wavelengths die through a dispersive delta transmission (their
    refracted direction is another). The result is then per-wavelength
    radiance, for ``spectrum.spectral_to_rgb``."""
    R = o.shape[0]
    dev = o.device
    types = static.bsdf_types
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 16
    if spectral_wl is not None:
        def lift(v):
            return spec_mod.uplift_rgb(v, spectral_wl)

        white = spec_mod.d65(spectral_wl)

        def lift_emit(v):
            return spec_mod.uplift_rgb(v, spectral_wl) * white
    else:
        def lift(v):
            return v

        lift_emit = lift

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
        # hideEmitters keeps what the camera sees directly black
        hidden_ok = not (cfg.hide_emitters and i == 0)

        # primary rays leave in raster order, coherent already: the first
        # closest-hit query skips the BVH query's sort
        its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf,
                                      active=active, presorted=i == 0)

        # --- escaped rays: environment emitter with MIS (path.cpp:234-248)
        if static.has_env:
            env_L, lum_pdf = em_mod.eval_env_pdf(scene, static, d)
            w = torch.where(prev_delta, 1.0, mis_power(prev_pdf, lum_pdf))
            show = active & ~its.valid & hidden_ok
            L = L + torch.where(show[..., None],
                                thr * lift_emit(env_L) * w[..., None], 0.0)

        active = active & its.valid

        # --- emitted radiance at the hit (path.cpp:176-190)
        Le = scene_mod.emitted_radiance(scene, static, its, d)
        lum_pdf_hit = scene_mod.pdf_emitter_hit(scene, its, o, static)
        w_hit = torch.where(prev_delta, 1.0, mis_power(prev_pdf, lum_pdf_hit))
        show = active & (its.emitter_id >= 0) & hidden_ok
        L = L + torch.where(show[..., None],
                            thr * lift_emit(Le) * w_hit[..., None], 0.0)

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
        nst = scene_mod.bsdf_nested(scene, its, static)

        # --- next event estimation (path.cpp:196-263)
        if static.emitter_types:
            u_nee = rng_mod.uniform4(sampler, pixel, sample, dim0 + DIM_NEE)
            ds = em_mod.sample_direct(scene, static, its.p, u_nee[..., :3])
            nee_ok = extend & ds.valid & (ds.pdf_sa > 0)
            n_rays = n_rays + nee_ok.sum()
            o_sh = ray_offset(its.p, its.gn, ds.d)
            vis = ~scene_mod.occluded(scene, static, o_sh, ds.d, 0.0,
                                      ds.dist * (1.0 - 1e-3), active=nee_ok)
            wo_local = its.sh_frame.to_local(ds.d)
            f = bsdf_mod.eval(bl, its.wi, wo_local, active_types=types,
                              nested=nst)
            bsdf_pdf_nee = bsdf_mod.pdf(bl, its.wi, wo_local,
                                        active_types=types, nested=nst)
            w_nee = torch.where(ds.delta, 1.0, mis_power(ds.pdf_sa, bsdf_pdf_nee))
            contrib = thr * lift(f) * lift_emit(ds.radiance) \
                * m.safe_div(w_nee, ds.pdf_sa)[..., None]
            L = L + torch.where((nee_ok & vis)[..., None], contrib, 0.0)

        # --- BSDF sampling (path.cpp:215-233)
        u_b = rng_mod.uniform4(sampler, pixel, sample, dim0 + DIM_BSDF)
        if spectral_wl is not None:
            # Cauchy dispersion at the hero wavelength: eta(l) = eta +
            # B (1 / l^2 - 1 / l_d^2), l in um, l_d = 589.3 nm
            disp_b = scene.materials.cauchy_b[
                torch.clamp(its.mat_id, min=0).to(torch.int64)]
            wl_um = spectral_wl[..., 0] * 1e-3
            d_eta = disp_b * (1.0 / (wl_um * wl_um) - 1.0 / 0.5893**2)
            bl = bl._replace(eta_c=bl.eta_c + d_eta[..., None])
            if bl.eta_s is not None:
                bl = bl._replace(eta_s=bl.eta_s + d_eta)
        bs = bsdf_mod.sample(bl, its.wi, u_b[..., 0], u_b[..., 1:3],
                             active_types=types, nested=nst)
        w_step = lift(bs.weight)
        if spectral_wl is not None:
            # the companions' delta lobe points elsewhere: value 0
            dispersed = (disp_b > 0.0) & bs.is_delta & (bs.eta != 1.0)
            keep = torch.where(dispersed, 0.0, 1.0)[..., None]
            w_step = torch.cat([w_step[..., :1], w_step[..., 1:] * keep],
                               dim=-1)
        thr_new = thr * w_step
        eta = torch.where(extend, eta * bs.eta, eta)
        alive = (torch.amax(thr_new, dim=-1) > 0) & (bs.pdf > 0)

        d_new = m.normalize(its.sh_frame.to_world(bs.wo))
        o_new = ray_offset(its.p, its.gn, d_new)

        # --- Russian roulette (path.cpp:276-286), only past rr_depth
        q = roulette_probability(thr_new, eta)
        if depth >= cfg.rr_depth:
            u_rr = rng_mod.uniform1(sampler, pixel, sample, dim0 + DIM_RR)
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
