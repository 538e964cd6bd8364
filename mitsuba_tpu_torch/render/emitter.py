"""Emitters and next-event estimation (port of ``mitsuba_tpu/render/emitter.py``:
triangle area lights, analytic sphere lights, the point, spot, directional
and collimated delta lights, the constant environment and the lat-long
environment map).

Area emitters own a contiguous range of an emissive-triangle array with a
globally monotone CDF: entry j stores ``emitter_index + local_cdf``, so
picking emitter e with residual u is one ``searchsorted(etri_cdf, e + u)``.
The environment map keeps radiance and solid-angle pdf in one (He*We, 4)
table and samples texels through a Walker alias table (one uniform, two row
gathers). A sphere light is sampled by the cone of directions it subtends
(sphere.cpp sampleDirect), so every sample hits it; its center is the
table's ``position`` row and its radius ``spot_cos[:, 0]``, as in the JAX
package. A delta light (point, spot, directional) reports its selection pmf
as the sample's pdf, with ``delta`` set, so the integrators weigh it 1 and
divide by the pmf alone. A collimated beam has no NEE branch, as in the JAX
package: its row is never valid in ``sample_direct`` and never hit, and it
takes its share of the selection pmf; its light leaves only through
``sample_ray``, which starts the particle tracer's and the bidirectional
tracer's light paths at every emitter type.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp
from ..core.frame import Frame
from .records import DirectSample

# type tags, the JAX package's numbering
AREA = 0
POINT = 1
CONSTANT = 2
ENVMAP = 3
DIRECTIONAL = 4
SPOT = 5
COLLIMATED = 6
SPHERE = 7   # analytic sphere area light, cone-sampled NEE

SUPPORTED_TYPES = (AREA, POINT, CONSTANT, ENVMAP, DIRECTIONAL, SPOT,
                   COLLIMATED, SPHERE)
DELTA_TYPES = (POINT, SPOT, DIRECTIONAL)


class EmitterTable(NamedTuple):
    type: torch.Tensor      # (E,) int32
    radiance: torch.Tensor  # (E, 3)
    position: torch.Tensor  # (E, 3) a sphere, point, spot or collimated
                            # light's position, else 0
    direction: torch.Tensor  # (E, 3) unit; a spot's axis, a directional or
                             # collimated light's travel; (0, 0, -1) else
    spot_cos: torch.Tensor  # (E, 2) a spot's cos(cutoff), cos(beam width);
                            # a sphere light's radius in column 0; (0, 1) on
                            # other rows
    delta: torch.Tensor     # (E,) bool: point, spot, directional
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

    if SPHERE in static.emitter_types:
        d_s, dist_s, pdf_s = _sphere_sample(em, e_idx, p_ref, u0, u1)
        sel = etype == SPHERE
        d = torch.where(sel[..., None], d_s, d)
        dist = torch.where(sel, dist_s, dist)
        radiance = torch.where(sel[..., None], em.radiance[e_idx], radiance)
        pdf_sa = torch.where(sel, pdf_s, pdf_sa)
        valid = torch.where(sel, dist_s > 1e-6, valid)

    has_delta = any(t in static.emitter_types for t in DELTA_TYPES)
    if has_delta:
        epmf = em.pmf[e_idx]
    if POINT in static.emitter_types or SPOT in static.emitter_types:
        to_p = em.position[e_idx] - p_ref
        dist_p = m.length(to_p)
        d_p = to_p / torch.clamp(dist_p, min=1e-12)[..., None]
        r2 = torch.clamp(dist_p * dist_p, min=1e-12)

    if POINT in static.emitter_types:
        val = em.radiance[e_idx] / r2[..., None]
        sel = etype == POINT
        d = torch.where(sel[..., None], d_p, d)
        dist = torch.where(sel, dist_p, dist)
        radiance = torch.where(sel[..., None], val, radiance)
        pdf_sa = torch.where(sel, epmf, pdf_sa)  # delta: the selection pmf
        delta = torch.where(sel, True, delta)
        valid = torch.where(sel, dist_p > 1e-6, valid)

    if SPOT in static.emitter_types:
        # spot.cpp falloff: the three selects in the JAX order, so a lane
        # at cos == cos(beam width) or cos == cos(cutoff) lands alike
        cos_f = -m.dot(d_p, em.direction[e_idx])
        cc, cb = em.spot_cos[e_idx, 0], em.spot_cos[e_idx, 1]
        fall = torch.clamp(m.safe_div(cos_f - cc, cb - cc), 0.0, 1.0)
        fall = torch.where(cos_f >= cb, 1.0, fall)
        fall = torch.where(cos_f <= cc, 0.0, fall)
        val = em.radiance[e_idx] * (fall / r2)[..., None]
        sel = etype == SPOT
        d = torch.where(sel[..., None], d_p, d)
        dist = torch.where(sel, dist_p, dist)
        radiance = torch.where(sel[..., None], val, radiance)
        pdf_sa = torch.where(sel, epmf, pdf_sa)
        delta = torch.where(sel, True, delta)
        valid = torch.where(sel, (dist_p > 1e-6) & (fall > 0), valid)

    if DIRECTIONAL in static.emitter_types:
        sel = etype == DIRECTIONAL
        d = torch.where(sel[..., None], -em.direction[e_idx], d)
        dist = torch.where(sel, 2.0 * scene.radius, dist)
        radiance = torch.where(sel[..., None], em.radiance[e_idx], radiance)
        pdf_sa = torch.where(sel, epmf, pdf_sa)
        delta = torch.where(sel, True, delta)
        valid = torch.where(sel, True, valid)

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

    # fold the emitter-selection pmf into the solid-angle pdf of the
    # non-delta samples (a delta sample's pdf is the pmf already); AREA
    # folded it into tri_nee_pdf_area at build time
    if has_delta:
        pdf_sa = torch.where(delta, pdf_sa,
                             pdf_sa * torch.where(etype == AREA, 1.0, epmf))
    else:
        pdf_sa = pdf_sa * torch.where(etype == AREA, 1.0, em.pmf[e_idx])
    return DirectSample(d=d, dist=dist, radiance=radiance, pdf_sa=pdf_sa,
                        delta=delta, valid=valid)


class EmitterRaySample(NamedTuple):
    """An emitted ray (AbstractEmitter::sampleRay) for the light paths."""

    o: torch.Tensor         # (R, 3) origin (on the emitter or its disk)
    d: torch.Tensor         # (R, 3) emission direction
    weight: torch.Tensor    # (R, 3) power over every sampling pdf
    n: torch.Tensor         # (R, 3) emitter surface normal (0 off a surface)
    pdf_area: torch.Tensor  # (R,) area pdf of the origin (surface lights)
    radiance: torch.Tensor  # (R, 3) Le at the origin (surface lights)
    is_area: torch.Tensor   # (R,) bool: the origin is an emitting surface
    valid: torch.Tensor     # (R,) bool
    e_idx: torch.Tensor     # (R,) int64 chosen emitter row
    epmf: torch.Tensor      # (R,) its selection pmf (at least 1e-12)


def sample_ray(scene, static, u4, u2) -> EmitterRaySample:
    """An emitter and a ray leaving it (the JAX ``sample_ray``): the emitter
    picked through the NEE cdf, ``u4[..., 1:3]`` the position, ``u2`` the
    direction. ``weight`` is the radiant power over all sampling pdfs, so a
    particle tracer divides by the particle count alone. Every emitter type
    has its branch, in the JAX package's order; a directional light, the
    constant environment and the envmap start on the disk that bounds the
    scene across the direction."""
    for t in static.emitter_types:
        if t not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"emitter type {t} lands in a later slice of the port")
    em = scene.emitters
    R = u4.shape[0]
    dev = u4.device
    u_sel, u0, u1 = u4[..., 0].contiguous(), u4[..., 1], u4[..., 2]

    e_idx = torch.clamp(
        torch.searchsorted(em.cdf, u_sel, right=True), 0, em.count - 1)
    lo_cdf = torch.where(e_idx > 0, em.cdf[torch.clamp(e_idx - 1, min=0)], 0.0)
    u_re = torch.clamp(
        m.safe_div(u_sel - lo_cdf, torch.clamp(em.pmf[e_idx], min=1e-12)),
        0.0, 1.0 - 1e-7)
    etype = em.type[e_idx]
    epmf = torch.clamp(em.pmf[e_idx], min=1e-12)
    u_pos = torch.stack([u0, u1], dim=-1)

    o = torch.zeros((R, 3), device=dev)
    d = torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(R, 1)
    weight = torch.zeros((R, 3), device=dev)
    n_out = torch.zeros((R, 3), device=dev)
    pdf_area = torch.zeros((R,), device=dev)
    radiance = torch.zeros((R, 3), device=dev)
    is_area = torch.zeros((R,), dtype=torch.bool, device=dev)
    valid = torch.zeros((R,), dtype=torch.bool, device=dev)

    center = 0.5 * (scene.aabb_lo + scene.aabb_hi)
    radius = scene.radius

    if AREA in static.emitter_types:
        # the origin: an area-weighted triangle, uniform barycentrics; the
        # direction: cosine-weighted about the front normal
        key = e_idx.to(torch.float32) + u_re
        j = torch.clamp(torch.searchsorted(em.etri_cdf, key, right=True),
                        0, em.etri_tri.shape[0] - 1)
        tri = em.etri_tri[j].to(torch.int64)
        p0, e1, e2, n_l, pdf_a_g = _gather_tri(scene, tri)
        bc = warp.square_to_uniform_triangle(u_pos)
        y = p0 + bc[..., 0:1] * e1 + bc[..., 1:2] * e2
        p_A = torch.clamp(pdf_a_g, min=1e-20)
        wo_local = warp.square_to_cosine_hemisphere(u2)
        d_a = Frame.from_normal(n_l).to_world(wo_local)
        Le = em.radiance[e_idx]
        # Le cos / (p_A cos / pi) = Le pi / p_A
        w_a = Le * (math.pi / p_A)[..., None]
        sel = etype == AREA
        s3 = sel[..., None]
        o = torch.where(s3, y, o)
        d = torch.where(s3, d_a, d)
        weight = torch.where(s3, w_a, weight)
        n_out = torch.where(s3, n_l, n_out)
        pdf_area = torch.where(sel, p_A, pdf_area)
        radiance = torch.where(s3, Le, radiance)
        is_area = torch.where(sel, True, is_area)
        valid = torch.where(sel, wo_local[..., 2] > 0, valid)

    if SPHERE in static.emitter_types:
        c_s = em.position[e_idx]
        r_s = em.spot_cos[e_idx, 0]
        n_s = warp.square_to_uniform_sphere(u_pos)
        y_s = c_s + r_s[..., None] * n_s
        area_s = 4.0 * math.pi * r_s * r_s
        p_A = m.safe_div(epmf, torch.clamp(area_s, min=1e-12))
        wo_local = warp.square_to_cosine_hemisphere(u2)
        d_sp = Frame.from_normal(n_s).to_world(wo_local)
        Le = em.radiance[e_idx]
        w_s = Le * (math.pi / torch.clamp(p_A, min=1e-20))[..., None]
        sel = etype == SPHERE
        s3 = sel[..., None]
        o = torch.where(s3, y_s, o)
        d = torch.where(s3, d_sp, d)
        weight = torch.where(s3, w_s, weight)
        n_out = torch.where(s3, n_s, n_out)
        pdf_area = torch.where(sel, p_A, pdf_area)
        radiance = torch.where(s3, Le, radiance)
        is_area = torch.where(sel, True, is_area)
        valid = torch.where(sel, wo_local[..., 2] > 0, valid)

    if POINT in static.emitter_types:
        d_p = warp.square_to_uniform_sphere(u2)
        w_p = em.radiance[e_idx] * (4.0 * math.pi / epmf)[..., None]
        sel = etype == POINT
        s3 = sel[..., None]
        o = torch.where(s3, em.position[e_idx], o)
        d = torch.where(s3, d_p, d)
        weight = torch.where(s3, w_p, weight)
        valid = torch.where(sel, True, valid)

    if SPOT in static.emitter_types:
        # uniform over the cone up to the cutoff (spot.cpp sampleRay)
        cc = em.spot_cos[e_idx, 0]
        cb = em.spot_cos[e_idx, 1]
        local = warp.square_to_uniform_cone(u2, cc)
        d_s = Frame.from_normal(em.direction[e_idx]).to_world(local)
        cos_f = local[..., 2]
        fall = torch.clamp(m.safe_div(cos_f - cc, cb - cc), 0.0, 1.0)
        fall = torch.where(cos_f >= cb, 1.0, fall)
        pdf_cone = warp.square_to_uniform_cone_pdf(cc)
        w_s = em.radiance[e_idx] * (fall / (pdf_cone * epmf))[..., None]
        sel = etype == SPOT
        s3 = sel[..., None]
        o = torch.where(s3, em.position[e_idx], o)
        d = torch.where(s3, d_s, d)
        weight = torch.where(s3, w_s, weight)
        valid = torch.where(sel, True, valid)

    def disk_origin(d_emit):
        """A point of the scene's bounding disk across d_emit
        (directional.cpp, envmap.cpp sampleRay)."""
        dsk = warp.square_to_uniform_disk_concentric(u_pos) * radius
        off = Frame.from_normal(d_emit).to_world(
            torch.cat([dsk, torch.zeros_like(dsk[..., :1])], dim=-1))
        return center - d_emit * radius + off

    if DIRECTIONAL in static.emitter_types:
        d_dir = em.direction[e_idx]
        w_d = em.radiance[e_idx] * (
            math.pi * radius * radius / epmf)[..., None]
        sel = etype == DIRECTIONAL
        s3 = sel[..., None]
        o = torch.where(s3, disk_origin(d_dir), o)
        d = torch.where(s3, d_dir, d)
        weight = torch.where(s3, w_d, weight)
        valid = torch.where(sel, True, valid)

    if COLLIMATED in static.emitter_types:
        sel = etype == COLLIMATED
        s3 = sel[..., None]
        o = torch.where(s3, em.position[e_idx], o)
        d = torch.where(s3, em.direction[e_idx], d)
        weight = torch.where(s3, em.radiance[e_idx] / epmf[..., None], weight)
        valid = torch.where(sel, True, valid)

    if CONSTANT in static.emitter_types:
        d_env = warp.square_to_uniform_sphere(u2)  # toward the environment
        w_c = em.radiance[e_idx] * (
            4.0 * math.pi * math.pi * radius * radius / epmf)[..., None]
        sel = etype == CONSTANT
        s3 = sel[..., None]
        o = torch.where(s3, disk_origin(-d_env), o)
        d = torch.where(s3, -d_env, d)
        weight = torch.where(s3, w_c, weight)
        valid = torch.where(sel, True, valid)

    if ENVMAP in static.emitter_types:
        d_env, pdf_e, rad_e = _envmap_sample(em, u2)
        w_e = rad_e * m.safe_div(math.pi * radius * radius,
                                 pdf_e * epmf)[..., None]
        sel = etype == ENVMAP
        s3 = sel[..., None]
        o = torch.where(s3, disk_origin(-d_env), o)
        d = torch.where(s3, -d_env, d)
        weight = torch.where(s3, w_e, weight)
        valid = torch.where(sel, pdf_e > 0, valid)

    return EmitterRaySample(o=o, d=d, weight=weight, n=n_out,
                            pdf_area=pdf_area, radiance=radiance,
                            is_area=is_area, valid=valid, e_idx=e_idx,
                            epmf=epmf)


def _cone(r_s, d2c):
    """(outside, the solid-angle pdf) of the cone that a sphere of radius
    ``r_s`` subtends at squared distance ``d2c`` from its center: uniform
    over the cone outside the sphere, over all directions inside it."""
    dc = m.sqrt(torch.clamp(d2c, min=1e-20))
    outside = dc > r_s * (1.0 + 1e-5)
    sin2_max = torch.clamp(m.safe_div(r_s * r_s, d2c), 0.0, 1.0)
    cos_max = m.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    # 1 - cos_max as sin2 / (1 + cos): 1 - cos_max in float32 loses three
    # digits on a small far light
    one_minus = m.safe_div(sin2_max, 1.0 + cos_max)
    pdf = torch.where(
        outside,
        m.safe_div(torch.ones((), device=d2c.device),
                   2.0 * math.pi * torch.clamp(one_minus, min=1e-12)),
        warp.INV_FOURPI)
    return dc, outside, cos_max, pdf


def _sphere_sample(em: EmitterTable, e_idx, p_ref, u0, u1):
    """A direction from ``p_ref`` in the cone of sphere light ``e_idx``
    (sphere.cpp sampleDirect): (d, the distance to the near side along d,
    the solid-angle pdf without the selection pmf). Inside the sphere the
    direction is uniform over the sphere of directions and the distance
    is the far root."""
    c_s = em.position[e_idx]
    r_s = em.spot_cos[e_idx, 0]
    to_c = c_s - p_ref
    d2c = m.squared_length(to_c)
    dc, outside, cos_max, pdf = _cone(r_s, d2c)
    axis = to_c / dc[..., None]
    cos_t = torch.where(outside, 1.0 - u0 * (1.0 - cos_max), 1.0 - 2.0 * u0)
    sin_t = m.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi_t = 2.0 * math.pi * u1
    local_d = torch.stack([sin_t * torch.cos(phi_t), sin_t * torch.sin(phi_t),
                           cos_t], dim=-1)
    d = Frame.from_normal(axis).to_world(local_d)
    # the near root along d outside (clamped to the tangent), the far one
    # inside
    proj = dc * cos_t
    under = m.sqrt(torch.clamp(r_s * r_s - (d2c - proj * proj), min=0.0))
    dist = torch.where(outside, proj - under, proj + under)
    return d, dist, pdf


def pdf_direct_sphere(em: EmitterTable, e_idx, p_ref, c_s, r_s):
    """Solid-angle pdf that the cone sampling of ``sample_direct`` draws a
    direction from ``p_ref`` that hits sphere light ``e_idx`` (center
    ``c_s``, radius ``r_s``), the selection pmf included: the NEE side of
    the MIS weight of a BSDF sample that hit the sphere (sphere.cpp
    pdfDirect)."""
    pdf = _cone(r_s, m.squared_length(c_s - p_ref))[3]
    return pdf * em.pmf[e_idx]


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
