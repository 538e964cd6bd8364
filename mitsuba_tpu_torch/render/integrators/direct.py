"""Direct illumination with emitter/BSDF MIS (port of
``mitsuba_tpu/render/integrators/direct.py``).

Per shading point (direct.cpp): ``emitter_samples`` next-event samples and
``bsdf_samples`` BSDF samples, combined with the power heuristic on the
fractional sample counts (direct.cpp:99-101), plus the radiance of emitters
the camera sees directly. Each query detaches its rays inside the scene
module, as the path tracer's do (the detached-sampling estimator); there is
no roulette probability to detach.
"""
from __future__ import annotations

import torch

from ...core import math as m
from ...core import rng as rng_mod
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import scene as scene_mod
from .common import DIM_BASE, IntegratorConfig, mis_power, ray_offset


def li(scene, static, cfg: IntegratorConfig, o, d, sampler, pixel, sample,
       with_stats: bool = False):
    """Radiance along primary rays o, d (R, 3). Returns (R, 3), or
    ((R, 3), n_rays) with ``n_rays`` the exact count of issued ray queries
    (the camera rays, the admissible shadow and BSDF rays), an int64 tensor,
    when ``with_stats``. ``sampler`` keys the draws: the render's
    ``rng.Sampler``, or an int seed for the independent sampler."""
    R = o.shape[0]
    dev = o.device
    L = torch.zeros((R, 3), device=dev)
    types = static.bsdf_types
    nE = max(cfg.emitter_samples, 0)
    nB = max(cfg.bsdf_samples, 0)
    frac_e = nE / max(nE + nB, 1)
    frac_b = nB / max(nE + nB, 1)
    weight_e = 1.0 / max(nE, 1)
    weight_b = 1.0 / max(nB, 1)

    its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf)
    active = its.valid
    n_rays = torch.full((), R, dtype=torch.int64, device=dev)

    # escaped rays: the environment
    if static.has_env and not cfg.hide_emitters:
        env_L = em_mod.eval_env_pdf(scene, static, d)[0]
        L = L + torch.where((~active)[..., None], env_L, 0.0)

    # emitters the camera sees directly
    if not cfg.hide_emitters:
        Le = scene_mod.emitted_radiance(scene, static, its, d)
        L = L + torch.where(active[..., None], Le, 0.0)

    bl = scene_mod.bsdf_locals(scene, its, static)
    nst = scene_mod.bsdf_nested(scene, its, static)
    dim = DIM_BASE

    for _ in range(nE):
        u = rng_mod.uniform4(sampler, pixel, sample, dim)
        dim += 1
        ds = em_mod.sample_direct(scene, static, its.p, u[..., :3])
        ok = active & ds.valid & (ds.pdf_sa > 0)
        n_rays = n_rays + ok.sum()
        o_sh = ray_offset(its.p, its.gn, ds.d)
        vis = ~scene_mod.occluded(scene, static, o_sh, ds.d, 0.0,
                                  ds.dist * (1.0 - 1e-3), active=ok)
        wo_local = its.sh_frame.to_local(ds.d)
        f = bsdf_mod.eval(bl, its.wi, wo_local, active_types=types,
                          nested=nst)
        pdf_b = bsdf_mod.pdf(bl, its.wi, wo_local, active_types=types,
                             nested=nst)
        # fractional MIS (direct.cpp:99-101)
        w = torch.where(ds.delta, 1.0,
                        mis_power(ds.pdf_sa * frac_e, pdf_b * frac_b))
        contrib = f * ds.radiance \
            * m.safe_div(w * weight_e, ds.pdf_sa)[..., None]
        L = L + torch.where((ok & vis)[..., None], contrib, 0.0)

    for _ in range(nB):
        u = rng_mod.uniform4(sampler, pixel, sample, dim)
        dim += 1
        bs = bsdf_mod.sample(bl, its.wi, u[..., 0], u[..., 1:3],
                             active_types=types, nested=nst)
        ok = active & (bs.pdf > 0) & (torch.amax(bs.weight, dim=-1) > 0)
        n_rays = n_rays + ok.sum()
        d2 = m.normalize(its.sh_frame.to_world(bs.wo))
        o2 = ray_offset(its.p, its.gn, d2)
        its2 = scene_mod.ray_intersect(scene, static, o2, d2, 0.0, torch.inf,
                                       active=ok)
        # an emitter hit, or an escape to the environment
        Le2 = scene_mod.emitted_radiance(scene, static, its2, d2)
        lum_pdf = scene_mod.pdf_emitter_hit(scene, its2, o2, static)
        if static.has_env:
            env_L, env_pdf = em_mod.eval_env_pdf(scene, static, d2)
            Le2 = torch.where(its2.valid[..., None], Le2, env_L)
            lum_pdf = torch.where(its2.valid, lum_pdf, env_pdf)
        else:
            Le2 = torch.where(its2.valid[..., None], Le2, 0.0)
        w = torch.where(bs.is_delta, 1.0,
                        mis_power(bs.pdf * frac_b, lum_pdf * frac_e))
        contrib = bs.weight * Le2 * (w * weight_b)[..., None]
        L = L + torch.where(ok[..., None], contrib, 0.0)

    if with_stats:
        return L, n_rays
    return L
