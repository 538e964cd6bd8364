"""Volumetric path tracer (port of
``mitsuba_tpu/render/integrators/volpath.py``; the reference's
src/integrators/path/volpath.cpp).

The path tracer with participating media: per bounce a free flight through
the lane's current medium (volpath.cpp:104) decides between a medium event
and the surface; next-event estimation from either kind of vertex, the phase
function's value and pdf taking the BSDF's place in MIS (:155, :198); a
phase or BSDF sample to go on; and the medium swap where a path crosses a
transmissive surface. A null surface is a continuation, not a vertex: it
keeps the MIS state (``prev_pdf``, ``prev_delta``) and the last real
vertex ``p_prev``.

With boundary media in the scene (``static.has_boundary_media``) the NEE
shadow ray walks through null boundaries (``scene.attenuated_transmittance``:
``max_crossings + 1`` closest-hit queries); otherwise it is one any-hit
query times the current medium's transmittance.

RNG dimensions per bounce i start at dim0 = DIM_BASE + 512 i, as in the JAX
package: the free flight at dim0 (delta-tracking step k at dim0 + 2 + k),
NEE at dim0 + 64, the BSDF or phase sample at dim0 + 65, roulette at
dim0 + 66, and the shadow walk's crossing j from dim0 + 128 + 8 j (ratio
tracking step k at + 32 + k). The tracking steps' dimensions reach the
fixed ones from step 62 on, and the crossings' each other's from step 8 on,
as in the JAX package (ROADMAP.md, Queue 3); the port keeps the layout.
"""
from __future__ import annotations

import torch

from ...core import math as m
from ...core import rng as rng_mod
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import medium as med_mod
from .. import phase as phase_mod
from .. import scene as scene_mod
from .common import DIM_BASE, IntegratorConfig, mis_power, ray_offset
from .path import roulette_probability

# a volumetric bounce's share of the RNG dimensions (the tracking loops')
DIMS_PER_BOUNCE_VOL = 512
DIM_VOL_NEE = 64
DIM_VOL_BSDF = 65
DIM_VOL_RR = 66
DIM_VOL_SHADOW = 128


def li(scene, static, cfg: IntegratorConfig, o, d, sampler, pixel, sample,
       with_stats: bool = False):
    """Radiance along primary rays o, d (R, 3), which start in vacuum (as
    every JAX caller starts them). Returns (R, 3), or ((R, 3), n_rays)
    with ``n_rays`` the exact count of issued ray queries (closest-hit, and
    shadow or shadow-walk queries), an int64 tensor, when ``with_stats``.
    ``sampler`` keys the draws as in ``path.li``."""
    R = o.shape[0]
    dev = o.device
    types = static.bsdf_types
    med = scene.media
    mtypes = static.medium_types
    mats = scene.materials
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 16
    ph_active = static.phase_types if static.phase_types else (
        phase_mod.ISOTROPIC,)

    L = torch.zeros((R, 3), device=dev)
    thr = torch.ones((R, 3), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(R, device=dev)
    prev_delta = torch.ones(R, dtype=torch.bool, device=dev)
    eta = torch.ones(R, device=dev)
    medium = torch.full((R,), -1, dtype=torch.int32, device=dev)
    p_prev = o  # the last real scattering vertex
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(max_depth):
        depth = i + 1
        dim0 = DIM_BASE + i * DIMS_PER_BOUNCE_VOL
        hidden_ok = not (cfg.hide_emitters and i == 0)
        n_rays = n_rays + active.sum()
        its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf,
                                      active=active)
        t_surf = torch.where(its.valid, its.t, 2.0 * scene.radius)

        # --- a free flight through the current medium (volpath.cpp:104)
        if mtypes:
            ms = med_mod.sample_distance(med, mtypes, medium, o, d, t_surf,
                                         sampler, pixel, sample, dim0, active)
            thr = thr * torch.where(active[..., None], ms.weight, 1.0)
            in_scatter = active & ms.sampled
            on_surface = active & ~ms.sampled
        else:
            in_scatter = torch.zeros(R, dtype=torch.bool, device=dev)
            on_surface = active
        surf_hit = on_surface & its.valid

        # --- emission seen from the last real vertex, MIS against NEE
        if static.has_env:
            env_L, lum_pdf = em_mod.eval_env_pdf(scene, static, d)
            w = torch.where(prev_delta, 1.0, mis_power(prev_pdf, lum_pdf))
            show = on_surface & ~its.valid & hidden_ok
            L = L + torch.where(show[..., None], thr * env_L * w[..., None],
                                0.0)
        Le = scene_mod.emitted_radiance(scene, static, its, d)
        lum_pdf_hit = scene_mod.pdf_emitter_hit(scene, its, p_prev, static)
        w_hit = torch.where(prev_delta, 1.0, mis_power(prev_pdf, lum_pdf_hit))
        show = surf_hit & (its.emitter_id >= 0) & hidden_ok
        L = L + torch.where(show[..., None], thr * Le * w_hit[..., None], 0.0)

        extend_surf = surf_hit & (depth < max_depth)
        extend_med = in_scatter & (depth < max_depth)

        bl = scene_mod.bsdf_locals(scene, its, static)
        nst = scene_mod.bsdf_nested(scene, its, static)
        mid = torch.clamp(medium, min=0).to(torch.int64)
        ph_type = med.phase_type[mid]
        ph_params = phase_mod.PhaseParams(
            g=med.phase_g[mid], g2=med.phase_g2[mid], w2=med.phase_w2[mid],
            ks=med.phase_ks[mid], exponent=med.phase_exp[mid],
            sigma=med.phase_sigma[mid], axis=med.phase_axis[mid])

        # --- next-event estimation from a surface or a medium vertex
        if static.emitter_types:
            u_nee = rng_mod.uniform4(sampler, pixel, sample, dim0 + DIM_VOL_NEE)
            p_ref = (torch.where(in_scatter[..., None], ms.p, its.p) if mtypes
                     else its.p)
            ds = em_mod.sample_direct(scene, static, p_ref, u_nee[..., :3])
            nee_ok = (extend_surf | extend_med) & ds.valid & (ds.pdf_sa > 0)
            o_sh = torch.where(in_scatter[..., None], p_ref,
                               ray_offset(its.p, its.gn, ds.d))
            if static.has_boundary_media:
                # the walk through null boundaries; an opaque hit gives 0
                tr, n_walk = scene_mod.attenuated_transmittance(
                    scene, static, o_sh, ds.d, ds.dist * (1.0 - 1e-3), medium,
                    sampler, pixel, sample, dim0 + DIM_VOL_SHADOW,
                    active=nee_ok, with_stats=True)
                n_rays = n_rays + n_walk
                vis = torch.ones(R, dtype=torch.bool, device=dev)
            else:
                n_rays = n_rays + nee_ok.sum()
                vis = ~scene_mod.occluded(scene, static, o_sh, ds.d, 1e-5,
                                          ds.dist * (1.0 - 1e-3),
                                          active=nee_ok)
                # attenuation through the current medium only
                if mtypes:
                    tr = med_mod.eval_transmittance(
                        med, mtypes, medium, o_sh, ds.d,
                        torch.minimum(ds.dist, t_surf), sampler, pixel,
                        sample, dim0 + DIM_VOL_SHADOW, nee_ok)
                else:
                    tr = torch.ones((R, 3), device=dev)
            wo_local = its.sh_frame.to_local(ds.d)
            f_val = bsdf_mod.eval(bl, its.wi, wo_local, active_types=types,
                                  nested=nst)
            pdf_fwd = bsdf_mod.pdf(bl, its.wi, wo_local, active_types=types,
                                   nested=nst)
            if mtypes:
                f_ph, pdf_ph_nee = phase_mod.eval_pdf(
                    ph_type, ph_params, -d, ds.d, active_types=ph_active)
                f_val = torch.where(in_scatter[..., None], f_ph[..., None],
                                    f_val)
                pdf_fwd = torch.where(in_scatter, pdf_ph_nee, pdf_fwd)
            w_nee = torch.where(ds.delta, 1.0, mis_power(ds.pdf_sa, pdf_fwd))
            contrib = thr * f_val * tr * ds.radiance \
                * m.safe_div(w_nee, ds.pdf_sa)[..., None]
            L = L + torch.where((nee_ok & vis)[..., None], contrib, 0.0)

        # --- go on: a phase sample at a medium event, else a BSDF sample
        u_b = rng_mod.uniform4(sampler, pixel, sample, dim0 + DIM_VOL_BSDF)
        bs = bsdf_mod.sample(bl, its.wi, u_b[..., 0], u_b[..., 1:3],
                             active_types=types, nested=nst)
        d_surf = m.normalize(its.sh_frame.to_world(bs.wo))
        d_new = d_surf
        new_pdf = bs.pdf
        new_delta = bs.is_delta
        w_step = bs.weight
        o_new = ray_offset(its.p, its.gn, d_surf)
        p_scat = its.p
        if mtypes:
            wo_ph, w_ph, pdf_ph = phase_mod.sample(
                ph_type, ph_params, -d, u_b[..., 1:3], active_types=ph_active)
            sc = in_scatter[..., None]
            d_new = torch.where(sc, wo_ph, d_new)
            new_pdf = torch.where(in_scatter, pdf_ph, new_pdf)
            new_delta = torch.where(in_scatter, False, new_delta)
            # the phase weight value / pdf (1 where sampled exactly)
            w_step = torch.where(sc, w_ph[..., None].expand(R, 3), w_step)
            o_new = torch.where(sc, ms.p, o_new)
            p_scat = torch.where(sc, ms.p, p_scat)
        thr_new = thr * w_step
        eta = torch.where(extend_surf, eta * bs.eta, eta)
        # a null boundary is a continuation, not a vertex: crossing it keeps
        # the MIS state of the last real vertex (volpath.cpp's null handling)
        mat = torch.clamp(its.mat_id, min=0).to(torch.int64)
        null_pass = extend_surf & (mats.type[mat] == bsdf_mod.NULL)
        new_pdf = torch.where(null_pass, prev_pdf, new_pdf)
        new_delta = torch.where(null_pass, prev_delta, new_delta)
        p_scat = torch.where(null_pass[..., None], p_prev, p_scat)
        alive = torch.amax(thr_new, dim=-1) > 0

        # --- the medium swap where the path crosses the surface
        new_medium = medium
        if mtypes:
            cos_new = m.dot(d_surf, its.gn)
            crossed = extend_surf & (cos_new * m.dot(d, its.gn) > 0)
            entering = crossed & (cos_new < 0)
            new_medium = torch.where(
                crossed, torch.where(entering, mats.interior_medium[mat],
                                     mats.exterior_medium[mat]), medium)

        # --- Russian roulette past rr_depth, with a detached q
        q = roulette_probability(thr_new, eta)
        if depth >= cfg.rr_depth:
            u_rr = rng_mod.uniform1(sampler, pixel, sample, dim0 + DIM_VOL_RR)
            survive = u_rr < q
            thr_new = torch.where(survive[..., None],
                                  thr_new * m.safe_div(1.0, q)[..., None],
                                  thr_new)
            active_next = (extend_surf | extend_med) & alive & survive
        else:
            active_next = (extend_surf | extend_med) & alive

        an = active_next[..., None]
        thr = torch.where(an, thr_new, thr)
        o = torch.where(an, o_new, o)
        d = torch.where(an, d_new, d)
        prev_pdf = torch.where(active_next, new_pdf, prev_pdf)
        prev_delta = torch.where(active_next, new_delta, prev_delta)
        medium = torch.where(active_next, new_medium, medium)
        p_prev = torch.where(an, p_scat, p_prev)
        active = active_next

    if with_stats:
        return L, n_rays
    return L
