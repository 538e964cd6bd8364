"""Emitters and next-event estimation (port of ``mitsuba_tpu/render/emitter.py``:
triangle area lights, the constant environment and the lat-long environment
map).

Area emitters own a contiguous range of an emissive-triangle array with a
globally monotone CDF: entry j stores ``emitter_index + local_cdf``, so
picking emitter e with residual u is one ``searchsorted(etri_cdf, e + u)``.
The environment map keeps radiance and solid-angle pdf in one (He*We, 4)
table and samples texels through a Walker alias table (one uniform, two row
gathers). Other emitter types land in a later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp
from .records import DirectSample

# type tags, the JAX package's numbering
AREA = 0
CONSTANT = 2
ENVMAP = 3

SUPPORTED_TYPES = (AREA, CONSTANT, ENVMAP)


class EmitterTable(NamedTuple):
    type: torch.Tensor      # (E,) int32
    radiance: torch.Tensor  # (E, 3)
    pmf: torch.Tensor       # (E,) emitter-selection pmf
    cdf: torch.Tensor       # (E,) emitter-selection cdf (inclusive)
    etri_tri: torch.Tensor  # (ET,) int32 scene triangle index
    etri_cdf: torch.Tensor  # (ET,) float32: emitter_idx + local_cdf
    env_index: torch.Tensor     # () int32: the env emitter's index, -1 if none
    env_map: torch.Tensor       # (He*We, 4): radiance rgb + solid-angle pdf
    env_alias: torch.Tensor     # (He*We, 2): accept prob, alias texel id
    env_hw: torch.Tensor        # (2,) int32 (He, We)
    env_to_world: torch.Tensor  # (3, 3) rotation
    env_scale: torch.Tensor     # () brightness scale

    @property
    def count(self):
        return self.type.shape[0]


def _gather_tri(scene, tri):
    """p0, e1, e2, geometric normal and NEE area pdf of triangles ``tri``."""
    return (scene.tri_p0[tri], scene.tri_e1[tri], scene.tri_e2[tri],
            scene.tri_gn[tri], scene.tri_nee_pdf_area[tri])


def sample_direct(scene, static, p_ref, u3):
    """Scene::sampleEmitterDirect analog: p_ref (R, 3), u3 (R, 3) uniforms.
    Visibility is not tested here; the integrator traces the shadow ray."""
    for t in static.emitter_types:
        if t not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"emitter type {t} lands in a later slice of the port")
    em = scene.emitters
    R = p_ref.shape[0]
    dev = p_ref.device
    u_sel, u0, u1 = u3[..., 0].contiguous(), u3[..., 1], u3[..., 2]

    # emitter pick via cdf (uniform weights, scene.cpp:375-381)
    e_idx = torch.clamp(
        torch.searchsorted(em.cdf, u_sel, right=True), 0, em.count - 1)
    lo_cdf = torch.where(e_idx > 0, em.cdf[torch.clamp(e_idx - 1, min=0)], 0.0)
    u_re = torch.clamp(
        m.safe_div(u_sel - lo_cdf, torch.clamp(em.pmf[e_idx], min=1e-12)),
        0.0, 1.0 - 1e-7)
    etype = em.type[e_idx]

    d = torch.zeros((R, 3), device=dev)
    dist = torch.full((R,), torch.inf, device=dev)
    radiance = torch.zeros((R, 3), device=dev)
    pdf_sa = torch.zeros((R,), device=dev)
    delta = torch.zeros((R,), dtype=torch.bool, device=dev)
    valid = torch.zeros((R,), dtype=torch.bool, device=dev)

    if AREA in static.emitter_types:
        # triangle pick through the globally monotone cdf
        key = e_idx.to(torch.float32) + u_re
        j = torch.clamp(torch.searchsorted(em.etri_cdf, key, right=True),
                        0, em.etri_tri.shape[0] - 1)
        tri = em.etri_tri[j].to(torch.int64)
        p0, e1, e2, n_l, pdf_a_g = _gather_tri(scene, tri)
        bc = warp.square_to_uniform_triangle(torch.stack([u0, u1], dim=-1))
        y = p0 + bc[..., 0:1] * e1 + bc[..., 1:2] * e2
        to_y = y - p_ref
        dist_a = m.length(to_y)
        d_a = to_y / torch.clamp(dist_a, min=1e-12)[..., None]
        cos_l = -m.dot(d_a, n_l)
        # area-measure pdf -> solid angle
        pdf_a = m.safe_div(pdf_a_g * dist_a * dist_a, torch.abs(cos_l))
        ok = (cos_l > 1e-7) & (dist_a > 1e-6)
        sel = etype == AREA
        d = torch.where(sel[..., None], d_a, d)
        dist = torch.where(sel, dist_a, dist)
        radiance = torch.where(sel[..., None], em.radiance[e_idx], radiance)
        pdf_sa = torch.where(sel, pdf_a, pdf_sa)
        valid = torch.where(sel, ok & (pdf_a > 0), valid)

    if CONSTANT in static.emitter_types:
        d_c = warp.square_to_uniform_sphere(torch.stack([u0, u1], dim=-1))
        sel = etype == CONSTANT
        d = torch.where(sel[..., None], d_c, d)
        dist = torch.where(sel, 2.0 * scene.radius, dist)
        radiance = torch.where(sel[..., None], em.radiance[e_idx], radiance)
        pdf_sa = torch.where(sel, warp.INV_FOURPI, pdf_sa)
        valid = torch.where(sel, True, valid)

    if ENVMAP in static.emitter_types:
        d_e, pdf_e, rad_e = _envmap_sample(em, torch.stack([u0, u1], dim=-1))
        sel = etype == ENVMAP
        d = torch.where(sel[..., None], d_e, d)
        dist = torch.where(sel, 2.0 * scene.radius, dist)
        radiance = torch.where(sel[..., None], rad_e, radiance)
        pdf_sa = torch.where(sel, pdf_e, pdf_sa)
        valid = torch.where(sel, pdf_e > 0, valid)

    # fold the emitter-selection pmf into the solid-angle pdf (no emitter of
    # this slice is a delta light); AREA folded it into tri_nee_pdf_area at
    # build time
    pdf_sa = pdf_sa * torch.where(etype == AREA, 1.0, em.pmf[e_idx])
    return DirectSample(d=d, dist=dist, radiance=radiance, pdf_sa=pdf_sa,
                        delta=delta, valid=valid)


def eval_env_pdf(scene, static, d_world):
    """Environment radiance along escaped rays d_world (R, 3) and the NEE
    pdf of sampling that direction (Scene::evalEnvironment and
    pdfEmitterDirect): the constant emitter's radiance and uniform-sphere
    pdf, or one table row per lane of the environment map. For scenes with
    an environment emitter (``static.has_env``)."""
    em = scene.emitters
    e_idx = em.env_index.to(torch.int64)
    etype = em.type[e_idx]
    shape = d_world.shape[:-1]
    rad = torch.where(etype == CONSTANT, em.radiance[e_idx],
                      torch.zeros(3, device=d_world.device)).expand(shape + (3,))
    pdf = torch.where(etype == CONSTANT,
                      torch.full(shape, warp.INV_FOURPI, device=d_world.device),
                      0.0)
    if ENVMAP in static.emitter_types:
        r_e, p_e = _envmap_eval_pdf(em, d_world)
        is_env = etype == ENVMAP
        rad = torch.where(is_env, r_e, rad)
        pdf = torch.where(is_env, p_e, pdf)
    return rad, pdf * em.pmf[e_idx]


# --- lat-long environment map (envmap.cpp:99-299) --------------------------

def _mat3_rows(v, M):
    """v @ M for v (R, 3) and M (3, 3), as explicit float32 multiply-adds
    (the JAX package's CPU value; no matrix unit)."""
    return torch.stack([v[..., 0] * M[0, j] + v[..., 1] * M[1, j]
                        + v[..., 2] * M[2, j] for j in range(3)], dim=-1)


def _dir_to_uv(em: EmitterTable, d_world):
    d = _mat3_rows(d_world, em.env_to_world)  # world -> env local
    theta, phi = m.spherical_coordinates(d)
    return phi * warp.INV_TWOPI, theta * warp.INV_PI


def _env_fetch(em: EmitterTable, y, x):
    """(radiance (R, 3), pdf (R,)) from one flat row gather."""
    rp = em.env_map[(y * em.env_hw[1] + x).to(torch.int64)]
    return rp[..., :3] * em.env_scale, rp[..., 3]


def _envmap_eval_pdf(em: EmitterTable, d_world):
    """Radiance and pdf of the texel that d_world falls in."""
    H, W = em.env_hw[0], em.env_hw[1]
    u, v = _dir_to_uv(em, d_world)
    x = torch.minimum(torch.clamp((u * W).to(torch.int32), min=0), W - 1)
    y = torch.minimum(torch.clamp((v * H).to(torch.int32), min=0), H - 1)
    return _env_fetch(em, y, x)


def _envmap_sample(em: EmitterTable, u2):
    """O(1) texel pick through the Walker alias table, then uniform jitter
    within the texel. Returns (d_world, pdf, radiance)."""
    H, W = em.env_hw[0], em.env_hw[1]
    N = em.env_alias.shape[0]
    u0 = torch.clamp(u2[..., 0], 0.0, 1.0 - 1e-7)
    scaled = u0 * N
    i0 = torch.clamp(scaled.to(torch.int32), 0, N - 1)
    u_re = scaled - i0.to(torch.float32)          # recycled uniform
    pa = em.env_alias[i0.to(torch.int64)]
    take = u_re < pa[..., 0]
    idx = torch.where(take, i0, pa[..., 1].to(torch.int32))
    # second recycle: position within the accept/reject split
    u_j = torch.where(
        take,
        u_re / torch.clamp(pa[..., 0], min=1e-12),
        (u_re - pa[..., 0]) / torch.clamp(1.0 - pa[..., 0], min=1e-12),
    )
    row = torch.div(idx, W, rounding_mode="floor")
    col = idx - row * W
    uu = (col.to(torch.float32) + torch.clamp(u_j, 0.0, 1.0 - 1e-6)) / W
    vv = (row.to(torch.float32) + torch.clamp(u2[..., 1], 0.0, 1.0 - 1e-6)) / H
    theta = vv * math.pi
    phi = uu * 2.0 * math.pi
    d_local = m.spherical_direction(theta, phi)
    d_world = _mat3_rows(d_local, em.env_to_world.T)
    rad, pdf = _env_fetch(em, row, col)
    return d_world, pdf, rad
