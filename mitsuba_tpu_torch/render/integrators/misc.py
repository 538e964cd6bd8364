"""The ao and field integrators (port of
``mitsuba_tpu/render/integrators/misc.py``; ao.cpp, field.cpp).

Both query the scene through ``scene.ray_intersect`` and ``scene.occluded``,
which detach the rays they take, as every integrator of the port does.
"""
from __future__ import annotations

import torch

from ...core import rng as rng_mod
from ...core import warp
from .. import scene as scene_mod
from .common import (
    DIM_BASE, FIELD_ALBEDO, FIELD_DISTANCE, FIELD_GEO_NORMAL, FIELD_NORMAL,
    FIELD_POSITION, FIELD_PRIM_INDEX, FIELD_SH_NORMAL, FIELD_UV,
    IntegratorConfig, ray_offset,
)


def _rgb(v):
    """(R,) -> (R, 3), the value in every channel."""
    return v[..., None].expand(*v.shape, 3)


def li_ao(scene, static, cfg: IntegratorConfig, o, d, sampler, pixel,
          sample, with_stats: bool = False):
    """Ambient occlusion (ao.cpp): the share of ``shading_samples``
    cosine-weighted directions at the camera hit that reach ``ray_length``
    (half the scene's radius when <= 0) unoccluded; 1 where the camera ray
    escapes. Returns (R, 3), or ((R, 3), n_rays) with ``n_rays`` the exact
    count of issued ray queries (the camera rays and the shadow rays of
    lanes that hit), an int64 tensor, when ``with_stats``."""
    R = o.shape[0]
    its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf)
    active = its.valid
    # a 0-d tensor on the scene's device: no host synchronisation per query
    t_max = scene.radius * 0.5 if cfg.ray_length <= 0 else cfg.ray_length
    n = max(cfg.shading_samples, 1)
    acc = torch.zeros(R, device=o.device)
    for i in range(n):
        u = rng_mod.uniform2(sampler, pixel, sample, DIM_BASE + i)
        wo = its.sh_frame.to_world(warp.square_to_cosine_hemisphere(u))
        o_sh = ray_offset(its.p, its.gn, wo)
        occ = scene_mod.occluded(scene, static, o_sh, wo, 0.0, t_max,
                                 active=active)
        acc = acc + torch.where(active & ~occ, 1.0, 0.0)
    L = _rgb(torch.where(active, acc / n, 1.0))
    if with_stats:
        return L, R + n * active.sum()
    return L


def li_field(scene, static, cfg: IntegratorConfig, o, d, sampler, pixel,
             sample, with_stats: bool = False):
    """AOV extraction (field.cpp): the camera hit's position, shading normal,
    geometric normal, uv, albedo, distance or primitive index; 0 where the
    ray escapes. Returns (R, 3), or ((R, 3), n_rays) with ``with_stats``."""
    its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf)
    f = cfg.field
    if f == FIELD_POSITION:
        out = its.p
    elif f in (FIELD_NORMAL, FIELD_SH_NORMAL):
        out = its.sh_frame.n
    elif f == FIELD_GEO_NORMAL:
        out = its.gn
    elif f == FIELD_UV:
        out = torch.cat([its.uv, torch.zeros_like(its.uv[..., :1])], dim=-1)
    elif f == FIELD_ALBEDO:
        out = scene_mod.eval_albedo(scene, its, static)
    elif f == FIELD_DISTANCE:
        out = _rgb(torch.where(its.valid, its.t, 0.0))
    elif f == FIELD_PRIM_INDEX:
        out = _rgb(its.prim_id.to(torch.float32))
    else:
        raise ValueError(f"unknown field {cfg.field}")
    L = torch.where(its.valid[..., None], out, 0.0)
    if with_stats:
        return L, torch.full((), o.shape[0], dtype=torch.int64,
                             device=o.device)
    return L
