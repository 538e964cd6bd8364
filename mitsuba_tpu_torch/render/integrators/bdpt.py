"""Bidirectional path tracer (port of
``mitsuba_tpu/render/integrators/bdpt.py``; the reference's
src/integrators/bdpt/{bdpt.cpp, bdpt_proc.cpp, bdpt_wr.cpp} over libbidir's
vertex.cpp, edge.cpp, path.cpp and pathsampler.cpp).

Each lane carries one eye subpath and one light subpath. A subpath is a
``Subpath`` of per-row lists: row k holds one (R, ...) tensor per field for
vertex k of every lane, filled by a lock-step random walk. Every row index
is a Python int, so the strategies read rows by list index, with no copy of
the (K, R) arrays the JAX package updates in place. Each (s, t) connection
strategy is a batched tensor expression over rows; the Python loop over (s,
t) enumerates them as PathSampler::sampleSplats does.

Conventions:
* t = the number of eye-side surface vertices z_1..z_t (the camera z_0 is
  implicit), s = the number of light-side vertices y_0..y_{s-1} (y_0 on the
  emitter); a strategy (s, t) renders paths of s + t segments;
* s = 0: the eye path hit an emitter; t = 0: the light subpath splats to
  the camera (the shared light image of bdpt_wr.cpp).

MIS weights are the power heuristic (beta = 2) over the pdf-ratio walk of
per-vertex forward and reverse area pdfs (Path::miWeight, path.cpp:266),
delta vertices passed through and zero pdfs taken as one. The reverse pdfs
of the up to four vertices beside the junction are recomputed per strategy;
the walk fills the others.

Media: with media in the scene each walk segment first samples a medium
distance; a scattering event is a MEDIUM vertex (a zero normal, the phase
function for extension and the junction pdfs, cos := 1 in the density
conversions), a transmissive crossing swaps the lane's medium, and each
connection weighs its segment by the attenuated transmittance through chains
of null boundaries. Both subpaths start in vacuum, where the camera sits
(``generate_subpaths``).

Emitters: area and sphere lights; delta-position lights (point, spot: their
y_0 is marked so the impossible s = 0 alternative drops out of the MIS sum)
and delta-direction lights (directional, collimated: a degenerate y_0 whose
light flows through s >= 2 and the t = 0 splats). Cameras: the pinhole
(perspective, thin lens) and the orthographic camera (film-area densities,
parallel t = 0 splats); the telecentric camera never connects.

RNG dimensions per sample, as in the JAX package: the eye walk from
DIM_EYE_BASE, the light's emitted ray at DIM_LIGHT_EMIT and + 1, its walk
from DIM_LIGHT_BASE, DIMS_PER_BOUNCE per bounce (the BSDF sample at + 0,
the free flight at + 1, the phase sample at + 2); with media the transmittance
of a connection (s, t) from 500 + 8 (t (N + 1) + s), of a t = 0 splat from
700 + 8 (t (N + 1) + s), crossing i at + 8 i. Those ranges overlap where
ROADMAP.md's Queue 3 says; the port keeps the layout.
"""
from __future__ import annotations

import math

import torch

from ...core import math as m
from ...core import rng as rng_mod
from ...core import warp
from ...core.frame import Frame
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import medium as med_mod
from .. import phase as phase_mod
from .. import scene as scene_mod
from .. import sensor as sensor_mod
from ..records import Interaction
from .common import IntegratorConfig, ray_offset
from .ptracer import _shading_normal_correction

DIM_EYE_BASE = 4
DIM_LIGHT_EMIT = 40
DIM_LIGHT_BASE = 42
DIMS_PER_BOUNCE = 4
DIM_CONNECT = 500   # a connection's transmittance walk
DIM_SPLAT = 700     # a t = 0 splat's transmittance walk
INV_PI = 1.0 / math.pi
# the types whose lobes are all delta: a vertex on them cannot connect
DELTA_BSDF_TYPES = (bsdf_mod.DIELECTRIC, bsdf_mod.CONDUCTOR,
                    bsdf_mod.THIN_DIELECTRIC, bsdf_mod.NULL)
# the default number of segments (bdpt.cpp maxDepth -1)
DEFAULT_DEPTH = 5


class Subpath:
    """One side's vertices: each field a list of K per-row tensors."""

    FIELDS = {  # name: (trailing shape, dtype, fill)
        "p": ((3,), torch.float32, 0.0),
        "gn": ((3,), torch.float32, 0.0),           # geometric normal
        "ns": ((3,), torch.float32, 0.0),           # shading normal
        "uv": ((2,), torch.float32, 0.0),
        "mat_id": ((), torch.int32, -1),
        "emitter_id": ((), torch.int32, -1),
        "wi_world": ((3,), torch.float32, 0.0),     # toward the previous
        "beta": ((3,), torch.float32, 0.0),         # throughput to here
        "pdf_fwd": ((), torch.float32, 0.0),        # area pdf from the prev
        "pdf_rev": ((), torch.float32, 0.0),        # area pdf from the next
        "delta": ((), torch.bool, False),           # reached by a delta lobe
        # a delta-position light's y_0: its own s = 0 alternative is
        # impossible, its neighbour's stay (pbrt's IsDeltaLight)
        "delta_origin": ((), torch.bool, False),
        "conn": ((), torch.bool, False),            # has a smooth lobe
        "light_pdf_a": ((), torch.float32, 0.0),    # emitter-origin area pdf
        "valid": ((), torch.bool, False),
        "is_med": ((), torch.bool, False),          # a medium event
        "med_id": ((), torch.int32, -1),            # its medium (-1 else)
    }

    def __init__(self, K: int, R: int, device):
        self.K = K
        for name, (shape, dtype, fill) in self.FIELDS.items():
            row = torch.full((R,) + shape, fill, dtype=dtype, device=device)
            setattr(self, name, [row] * K)

    def set(self, k: int, **rows):
        for name, v in rows.items():
            getattr(self, name)[k] = v


def _to_area(pdf_sa, dir_unit, dist2, n_target):
    """A solid-angle pdf at the source as an area pdf at the target; a
    medium vertex (zero normal) converts with cos := 1 (vertex.cpp
    EMediumInteraction, pbrt's ConvertDensity)."""
    is_vol = m.squared_length(n_target) < 0.5
    cos_t = torch.where(is_vol, 1.0, torch.abs(m.dot(n_target, -dir_unit)))
    return pdf_sa * m.safe_div(cos_t, torch.clamp(dist2, min=1e-12))


def _vertex_locals(scene, static, sp: Subpath, k: int):
    """(BSDF locals, nested, shading frame) of row k."""
    valid = sp.valid[k]
    ok_n = valid & (m.squared_length(sp.ns[k]) > 0.5)
    up = torch.tensor([0.0, 0.0, 1.0], device=valid.device)
    frame = Frame.from_normal(torch.where(ok_n[..., None], sp.ns[k], up))
    zeros = torch.zeros(valid.shape, device=valid.device)
    its = Interaction(
        valid=valid, t=zeros, p=sp.p[k], gn=sp.gn[k], sh_frame=frame,
        uv=sp.uv[k], wi=frame.to_local(sp.wi_world[k]),
        wi_world=sp.wi_world[k], mat_id=sp.mat_id[k],
        emitter_id=sp.emitter_id[k],
        prim_id=torch.full(valid.shape, -1, dtype=torch.int32,
                           device=valid.device),
        nee_pdf_area=sp.light_pdf_a[k],
        bary=torch.zeros(valid.shape + (2,), device=valid.device))
    return (scene_mod.bsdf_locals(scene, its, static),
            scene_mod.bsdf_nested(scene, its, static), frame)


def _phase_args(scene, static, med_id):
    """(phase types, PhaseParams, the types present) of medium ids."""
    med = scene.media
    mid = torch.clamp(med_id, min=0).to(torch.int64)
    params = phase_mod.PhaseParams(
        g=med.phase_g[mid], g2=med.phase_g2[mid], w2=med.phase_w2[mid],
        ks=med.phase_ks[mid], exponent=med.phase_exp[mid],
        sigma=med.phase_sigma[mid], axis=med.phase_axis[mid])
    ptypes = static.phase_types if static.phase_types else (
        phase_mod.ISOTROPIC,)
    return med.phase_type[mid], params, ptypes


def _vertex_f(scene, static, sp: Subpath, k: int, loc, wi_world, wo_world):
    """Scattering value of row k toward wo: the BSDF (cosine included) at a
    surface, the phase function at a medium event (vertex.cpp eval)."""
    bl, nst, frame = loc
    f = bsdf_mod.eval(bl, frame.to_local(wi_world), frame.to_local(wo_world),
                      active_types=static.bsdf_types, nested=nst)
    if static.medium_types:
        pt, pp, ptys = _phase_args(scene, static, sp.med_id[k])
        ph, _ = phase_mod.eval_pdf(pt, pp, wi_world, wo_world,
                                   active_types=ptys)
        f = torch.where(sp.is_med[k][..., None], ph[..., None], f)
    return f


def _vertex_pdf_toward(scene, static, sp: Subpath, k: int, loc, wi_world,
                       wo_world, dist2, n_target):
    """Area pdf at the target of row k sampling ``wo_world`` (the BSDF's or
    the phase function's directional pdf, converted)."""
    bl, nst, frame = loc
    pdf_sa = bsdf_mod.pdf(bl, frame.to_local(wi_world),
                          frame.to_local(wo_world),
                          active_types=static.bsdf_types, nested=nst)
    if static.medium_types:
        pt, pp, ptys = _phase_args(scene, static, sp.med_id[k])
        _, pdf_ph = phase_mod.eval_pdf(pt, pp, wi_world, wo_world,
                                       active_types=ptys)
        pdf_sa = torch.where(sp.is_med[k], pdf_ph, pdf_sa)
    return _to_area(pdf_sa, wo_world, dist2, n_target)


def random_walk(scene, static, sp: Subpath, o0, d0, beta0, pdf_dir0,
                offset: int, n_steps: int, sampler, lane, sample,
                dim_base: int, importance_mode: bool, medium0):
    """Fill rows offset .. offset + n_steps - 1 of ``sp`` by walking from
    (o0, d0), and the reverse pdf of each row before the one extended
    (libbidir Path::randomWalk). With media each segment first samples a
    medium distance: a scattering event makes a MEDIUM vertex, and a
    transmissive crossing swaps the lane's medium. Returns the closest-hit
    queries issued (an int64 tensor)."""
    types = static.bsdf_types
    delta_types = [t for t in types if t in DELTA_BSDF_TYPES]
    mtypes = static.medium_types
    R = o0.shape[0]
    dev = o0.device
    o, d, beta, pdf_dir = o0, d0, beta0, pdf_dir0
    seg_delta = torch.zeros(R, dtype=torch.bool, device=dev)
    active = torch.amax(beta0, dim=-1) > 0
    medium = medium0
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_steps):
        j = i + offset
        dim0 = dim_base + i * DIMS_PER_BOUNCE
        n_rays = n_rays + active.sum()
        its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf,
                                      active=active)
        hit_surf = active & its.valid

        # --- a free flight along the segment (volpath.cpp:104)
        if mtypes:
            t_seg = torch.where(its.valid, its.t, torch.inf)
            ms = med_mod.sample_distance(scene.media, mtypes, medium, o, d,
                                         t_seg, sampler, lane, sample,
                                         dim0 + 1, active)
            in_scatter = active & ms.sampled
            beta_here = beta * ms.weight
            v_active = in_scatter | hit_surf
        else:
            in_scatter = torch.zeros(R, dtype=torch.bool, device=dev)
            beta_here = beta
            v_active = hit_surf

        dist2 = torch.where(torch.isfinite(its.t), its.t * its.t, 1.0)
        v_p, v_gn, v_ns = its.p, its.gn, its.sh_frame.n
        v_mat, v_em, v_nee = its.mat_id, its.emitter_id, its.nee_pdf_area
        if mtypes:
            sc = in_scatter[..., None]
            dist2 = torch.where(in_scatter, ms.t * ms.t, dist2)
            v_p = torch.where(sc, ms.p, v_p)
            v_gn = torch.where(sc, 0.0, v_gn)
            v_ns = torch.where(sc, 0.0, v_ns)
            v_mat = torch.where(in_scatter, -1, v_mat)
            v_em = torch.where(in_scatter, -1, v_em)
            v_nee = torch.where(in_scatter, 0.0, v_nee)

        pdf_a = torch.where(seg_delta, pdf_dir,
                            _to_area(pdf_dir, d, dist2, v_gn))
        bl = scene_mod.bsdf_locals(scene, its, static)
        nst = scene_mod.bsdf_nested(scene, its, static)
        mat_is_delta = torch.zeros(R, dtype=torch.bool, device=dev)
        for t in delta_types:
            mat_is_delta = mat_is_delta | (bl.type == t)
        v_conn = ~mat_is_delta
        if mtypes:
            v_conn = torch.where(in_scatter, True, v_conn)
        sp.set(j, p=v_p, gn=v_gn, ns=v_ns, uv=its.uv, mat_id=v_mat,
               emitter_id=v_em, wi_world=-d,
               beta=torch.where(v_active[..., None], beta_here, 0.0),
               pdf_fwd=torch.where(v_active, pdf_a, 0.0),
               delta=seg_delta & v_active, conn=v_conn & v_active,
               light_pdf_a=torch.where(v_active, v_nee, 0.0),
               valid=v_active, is_med=in_scatter,
               med_id=torch.where(in_scatter, medium, -1))

        # --- the extension: a BSDF sample at a surface, a phase sample at
        # a medium event
        u_b = rng_mod.uniform4(sampler, lane, sample, dim0)
        bs = bsdf_mod.sample(bl, its.wi, u_b[..., 0], u_b[..., 1:3],
                             active_types=types, nested=nst)
        w_ext = bs.weight
        if importance_mode:
            corr = _shading_normal_correction(
                its.wi, bs.wo, its.sh_frame.to_local(its.gn))
            w_ext = w_ext * (corr * bs.eta * bs.eta)[..., None]
        d_surf = m.normalize(its.sh_frame.to_world(bs.wo))
        pdf_ext = bs.pdf
        ext_delta = bs.is_delta
        d_new = d_surf
        o_new = ray_offset(its.p, its.gn, d_surf)
        if mtypes:
            pt, pp, ptys = _phase_args(scene, static, medium)
            u_ph = rng_mod.uniform2(sampler, lane, sample, dim0 + 2)
            wo_ph, w_ph, pdf_ph = phase_mod.sample(pt, pp, -d, u_ph,
                                                   active_types=ptys)
            sc = in_scatter[..., None]
            d_new = torch.where(sc, wo_ph, d_surf)
            w_ext = torch.where(sc, w_ph[..., None], w_ext)
            pdf_ext = torch.where(in_scatter, pdf_ph, pdf_ext)
            ext_delta = torch.where(in_scatter, False, ext_delta)
            o_new = torch.where(sc, ms.p, o_new)
        beta_new = beta_here * w_ext

        # the reverse pdf of row j - 1: the density of going back toward it
        # given the new direction
        if j > 0:
            pdf_rev_sa = bsdf_mod.pdf(bl, bs.wo, its.wi, active_types=types,
                                      nested=nst)
            if mtypes:
                _, pdf_ph_rev = phase_mod.eval_pdf(pt, pp, d_new, -d,
                                                   active_types=ptys)
                pdf_rev_sa = torch.where(in_scatter, pdf_ph_rev, pdf_rev_sa)
            prev_gn = sp.gn[j - 1]
            prev_vol = m.squared_length(prev_gn) < 0.5
            rev_a = torch.where(
                ext_delta, pdf_rev_sa,
                pdf_rev_sa * m.safe_div(
                    torch.where(prev_vol, 1.0,
                                torch.abs(m.dot(prev_gn, d))), dist2))
            sp.pdf_rev[j - 1] = torch.where(v_active, rev_a,
                                            sp.pdf_rev[j - 1])

        # --- the medium swap where the walk crosses a surface (volpath.cpp)
        if mtypes:
            cos_new = m.dot(d_surf, its.gn)
            crossed = hit_surf & ~in_scatter & (cos_new * m.dot(d, its.gn)
                                                > 0)
            entering = crossed & (cos_new < 0)
            mid_c = torch.clamp(its.mat_id, min=0).to(torch.int64)
            mats = scene.materials
            medium = torch.where(crossed, torch.where(
                entering, mats.interior_medium[mid_c],
                mats.exterior_medium[mid_c]), medium)

        alive = v_active & (pdf_ext > 0) & (torch.amax(beta_new, dim=-1) > 0)
        o = o_new
        d = torch.where(alive[..., None], d_new, d)
        beta = torch.where(alive[..., None], beta_new, beta)
        pdf_dir = torch.where(alive, pdf_ext, pdf_dir)
        seg_delta = ext_delta & alive
        active = alive
    return n_rays


def generate_subpaths(scene, static, cfg: IntegratorConfig, sensor, o, d,
                      sampler, lane, sample, K_eye: int, K_light: int,
                      with_stats: bool = False):
    """The eye subpath z_1..z_{K_eye} from the camera rays (o, d) and the
    light subpath y_0..y_{K_light - 1} from an emitted ray (row 0 on the
    emitter); both walks start in vacuum, where the camera sits. Returns
    (eye, light), and the closest-hit queries issued with
    ``with_stats``."""
    R = o.shape[0]
    dev = o.device
    vacuum = torch.full((R,), -1, dtype=torch.int32, device=dev)
    eye = Subpath(K_eye, R, dev)
    n_rays = random_walk(scene, static, eye, o, d,
                         torch.ones((R, 3), device=dev),
                         sensor_mod.pdf_ray_direction(sensor, d), 0, K_eye,
                         sampler, lane, sample, DIM_EYE_BASE, False, vacuum)
    if sensor.type == sensor_mod.ORTHOGRAPHIC:
        # a delta-direction camera (sensor.h EDeltaDirection): z_1's camera
        # density is the parallel projection's film-area density
        pdf_cam_a = sensor_mod.camera_pdf_area(sensor, eye.p[0], eye.gn[0])
        eye.pdf_fwd[0] = torch.where(eye.valid[0], pdf_cam_a, eye.pdf_fwd[0])

    u_e = rng_mod.uniform4(sampler, lane, sample, DIM_LIGHT_EMIT)
    u_ed = rng_mod.uniform2(sampler, lane, sample, DIM_LIGHT_EMIT + 1)
    ers = em_mod.sample_ray(scene, static, u_e, u_ed)
    em = scene.emitters
    etype0 = em.type[ers.e_idx]
    # delta-position lights (point, spot) start at their fixed position,
    # their y_0 marked so MIS skips its impossible s = 0 alternative
    is_delta_l = ers.valid & ((etype0 == em_mod.POINT)
                              | (etype0 == em_mod.SPOT))
    # delta-direction lights (directional, collimated): a degenerate y_0
    # that no generic s = 1 connection can reach; their light flows through
    # s >= 2 and the t = 0 splats (plain BDPT without the reference's
    # sampleDirect repositioning)
    is_delta_d = ers.valid & ((etype0 == em_mod.DIRECTIONAL)
                              | (etype0 == em_mod.COLLIMATED))
    q_valid = ers.valid & (ers.is_area | is_delta_l | is_delta_d)
    beta_q0 = torch.where(
        q_valid[..., None],
        torch.where(is_delta_l[..., None],
                    m.safe_div(em.radiance[ers.e_idx],
                               torch.clamp(ers.epmf, min=1e-12)[..., None]),
                    m.safe_div(ers.radiance, ers.pdf_area[..., None])), 0.0)
    cos0 = m.dot(ers.n, ers.d)
    pdf_dir0 = torch.clamp(cos0, min=0.0) * INV_PI  # cosine emission
    pdf_dir0 = torch.where(is_delta_l, _emission_dir_pdf(scene, ers.e_idx,
                                                         ers.d), pdf_dir0)
    # y_0's positional pdf: the area pdf of a surface light, the pick pmf
    # of a delta position, the pmf over the scene's bounding disk for a
    # direction (sample_ray's disk origin)
    disk_pdf = ers.epmf / torch.clamp(math.pi * scene.radius * scene.radius,
                                      min=1e-12)
    pos_pdf = torch.where(is_delta_l, ers.epmf,
                          torch.where(is_delta_d, disk_pdf, ers.pdf_area))
    is_delta0 = is_delta_l | is_delta_d
    pdf_dir0 = torch.where(is_delta_d, 1.0, pdf_dir0)  # a discrete direction

    light = Subpath(K_light, R, dev)
    gn0 = torch.where(is_delta0[..., None], 0.0, ers.n)
    light.set(0, p=ers.o, gn=gn0, ns=gn0,
              emitter_id=torch.where(q_valid, ers.e_idx, -1).to(torch.int32),
              beta=beta_q0, pdf_fwd=torch.where(q_valid, pos_pdf, 0.0),
              delta=is_delta_d, delta_origin=is_delta_l,
              conn=q_valid & ~is_delta_d, light_pdf_a=pos_pdf, valid=q_valid)
    if K_light > 1:
        beta_y1 = beta_q0 * m.safe_div(
            cos0, torch.clamp(pdf_dir0, min=1e-12))[..., None]
        # sample_ray's weight is the power over all pdfs for a delta light
        beta_y1 = torch.where(is_delta0[..., None], ers.weight, beta_y1)
        n_rays = n_rays + random_walk(
            scene, static, light, ray_offset(ers.o, gn0, ers.d), ers.d,
            torch.where(q_valid[..., None], beta_y1, 0.0), pdf_dir0, 1,
            K_light - 1, sampler, lane, sample, DIM_LIGHT_BASE, True,
            vacuum)
    return (eye, light, n_rays) if with_stats else (eye, light)


def _emission_dir_pdf(scene, e_idx, d_out):
    """Solid-angle emission pdf of a delta-position light toward d_out: the
    uniform sphere of a point light, the uniform cone up to a spot's cutoff
    (as sample_ray draws them)."""
    em = scene.emitters
    e = torch.clamp(e_idx, min=0).to(torch.int64)
    cc = em.spot_cos[e, 0]
    pdf_spot = torch.where(m.dot(d_out, em.direction[e]) >= cc,
                           warp.INV_TWOPI / torch.clamp(1.0 - cc, min=1e-6),
                           0.0)
    return torch.where(em.type[e] == em_mod.SPOT, pdf_spot, warp.INV_FOURPI)


def _emission_profile(scene, light: Subpath, ys: int, d_out):
    """y_0's emission toward d_out with the radiance or intensity already in
    beta: cos for a surface light, 1 for a point light, a spot's falloff
    (area.cpp, point.cpp, spot.cpp eval)."""
    em = scene.emitters
    e = torch.clamp(light.emitter_id[ys], min=0).to(torch.int64)
    etype = em.type[e]
    f = torch.clamp(m.dot(light.gn[ys], d_out), min=0.0)
    f = torch.where(etype == em_mod.POINT, 1.0, f)
    cc, cb = em.spot_cos[e, 0], em.spot_cos[e, 1]
    cos_f = m.dot(d_out, em.direction[e])
    fall = torch.clamp(m.safe_div(cos_f - cc, cb - cc), 0.0, 1.0)
    fall = torch.where(cos_f >= cb, 1.0, fall)
    fall = torch.where(cos_f <= cc, 0.0, fall)
    return torch.where(etype == em_mod.SPOT, fall, f)


def _remap0(x):
    return torch.where(x > 0, x, 1.0)


def _mis_from_entries(eye_entries, light_entries):
    """The power heuristic 1 / (1 + sum r_i^2) over the alternatives, from
    per-vertex (fwd, rev, delta, skip_own) entries with the junction's
    reverse pdfs substituted (Path::miWeight squares every ratio);
    ``eye_entries`` ordered z_1..z_t, ``light_entries`` y_0..y_{s-1}."""
    sum_ri = 0.0
    # the camera side, z_t down to z_1; the camera z_0 counts as non-delta,
    # so the t = 0 splat is an alternative
    ri = 1.0
    for k in range(len(eye_entries) - 1, -1, -1):
        fwd, rev, delta, _ = eye_entries[k]
        ri = ri * m.safe_div(_remap0(rev), _remap0(fwd))
        use = ~delta & ~eye_entries[k - 1][2] if k > 0 else ~delta
        sum_ri = sum_ri + torch.where(use, ri * ri, 0.0)
    # the light side, y_{s-1} down to y_0
    ri = 1.0
    for k in range(len(light_entries) - 1, -1, -1):
        fwd, rev, delta, skip_own = light_entries[k]
        ri = ri * m.safe_div(_remap0(rev), _remap0(fwd))
        skip = delta | skip_own
        if k > 0:
            skip = skip | light_entries[k - 1][2]
        sum_ri = sum_ri + torch.where(~skip, ri * ri, 0.0)
    return m.safe_div(1.0, 1.0 + sum_ri)


def _entries(sp: Subpath, n: int, subs: dict):
    """(fwd, rev, delta, skip_own) of rows 0..n-1, with the reverse pdfs of
    ``subs`` ({row: rev}) substituted."""
    return [(sp.pdf_fwd[k], subs.get(k, sp.pdf_rev[k]), sp.delta[k],
             sp.delta_origin[k]) for k in range(n)]


def _mis_weight_st(eye: Subpath, light: Subpath, t: int, s: int,
                   esubs: dict, lsubs: dict):
    return _mis_from_entries(_entries(eye, t, esubs),
                             _entries(light, s, lsubs))


def _visible(scene, static, p_a, gn_a, p_b, active, medium_a, sampler, lane,
             sample, dim0: int):
    """(transmittance (R, 3) or (R, 1), unit direction, distance, queries)
    from a to b: one shadow ray without media, else the attenuated
    transmittance through chains of null boundaries (scene.cpp:854-898). A
    medium vertex's zero normal leaves its origin where it is."""
    dvec = p_b - p_a
    dist = m.length(dvec)
    d_unit = dvec / torch.clamp(dist, min=1e-12)[..., None]
    o = ray_offset(p_a, gn_a, d_unit)
    if static.medium_types:
        tr, n = scene_mod.attenuated_transmittance(
            scene, static, o, d_unit, dist * (1.0 - 1e-3), medium_a, sampler,
            lane, sample, dim0, active=active, with_stats=True)
        return tr, d_unit, dist, n
    occ = scene_mod.occluded(scene, static, o, d_unit, 0.0,
                             dist * (1.0 - 1e-3), active=active)
    return (~occ)[..., None].to(torch.float32), d_unit, dist, active.sum()


def _vertex_medium_toward(scene, static, sp: Subpath, k: int, d_out):
    """The medium on the d_out side of row k: a medium event's own, a
    surface's interior or exterior one (shape.h); None without media."""
    if not static.medium_types:
        return None
    mid_c = torch.clamp(sp.mat_id[k], min=0).to(torch.int64)
    mats = scene.materials
    side = torch.where(m.dot(d_out, sp.gn[k]) < 0,
                       mats.interior_medium[mid_c],
                       mats.exterior_medium[mid_c])
    return torch.where(sp.is_med[k], sp.med_id[k], side)


def _toward(sp: Subpath, a: int, b: int):
    """(unit direction, squared distance at least 1e-12) from row a to b."""
    dvec = sp.p[b] - sp.p[a]
    dist2 = torch.clamp(m.squared_length(dvec), min=1e-12)
    return dvec / torch.sqrt(dist2)[..., None], dist2


def li_and_splats(scene, static, cfg: IntegratorConfig, sensor, o, d,
                  sampler, lane, sample, with_stats: bool = False):
    """Every strategy for one eye and one light subpath per lane.

    Returns (L (R, 3) for the lane's own pixel, splat_uv (S, R, 2), splat_val
    (S, R, 3)) with S the number of t = 0 strategies and a splat_uv of -1
    where a splat was not made; and the ray queries issued (an int64
    tensor) with ``with_stats``."""
    N = cfg.max_depth if cfg.max_depth > 0 else DEFAULT_DEPTH
    K_eye = K_light = N
    R = o.shape[0]
    dev = o.device
    eye, light, n_rays = generate_subpaths(
        scene, static, cfg, sensor, o, d, sampler, lane, sample, K_eye,
        K_light, with_stats=True)
    media = bool(static.medium_types)
    eye_loc = [_vertex_locals(scene, static, eye, k) for k in range(K_eye)]
    light_loc = [_vertex_locals(scene, static, light, k)
                 for k in range(K_light)]
    radiance = scene.emitters.radiance

    L = torch.zeros((R, 3), device=dev)
    splat_uvs, splat_vals = [], []
    for t in range(K_eye + 1):
        for s in range(K_light + 1):
            if not 1 <= s + t <= N:
                continue
            if s == 0:
                # --- the eye path hit an emitter at z_t
                if cfg.hide_emitters and t == 1:
                    continue
                zt = t - 1
                has_le = eye.valid[zt] & (eye.emitter_id[zt] >= 0)
                front = m.dot(eye.gn[zt], eye.wi_world[zt]) > 0  # area.cpp
                e = torch.clamp(eye.emitter_id[zt], min=0).to(torch.int64)
                contrib = eye.beta[zt] * torch.where(
                    (has_le & front)[..., None], radiance[e], 0.0)
                # MIS: z_t drawn as a light origin, z_{t-1} by the
                # emission's cosine
                subs = {zt: eye.light_pdf_a[zt]}
                if t >= 2:
                    d_unit, dist2 = _toward(eye, zt, zt - 1)
                    pdf_dir = torch.clamp(m.dot(eye.gn[zt], d_unit),
                                          min=0.0) * INV_PI
                    subs[zt - 1] = _to_area(pdf_dir, d_unit, dist2,
                                            eye.gn[zt - 1])
                w = _mis_weight_st(eye, light, t, s, subs, {})
                L = L + torch.where(has_le[..., None], contrib * w[..., None],
                                    0.0)
                continue

            ys = s - 1  # the light-side junction row
            if t == 0:
                # --- the light subpath splats to the camera
                ok = light.valid[ys] & light.conn[ys]
                ss = sensor_mod.sample_direct(sensor, light.p[ys])
                if s == 1:
                    val = light.beta[ys] * _emission_profile(
                        scene, light, ys, ss.d)[..., None]
                else:
                    frame = light_loc[ys][2]
                    f = _vertex_f(scene, static, light, ys, light_loc[ys],
                                  light.wi_world[ys], ss.d)
                    corr = _shading_normal_correction(
                        frame.to_local(light.wi_world[ys]),
                        frame.to_local(ss.d), frame.to_local(light.gn[ys]))
                    if media:
                        corr = torch.where(light.is_med[ys], 1.0, corr)
                    val = light.beta[ys] * f * corr[..., None]
                ok = ok & ss.valid & (torch.amax(val, dim=-1) > 0)
                o_sh = ray_offset(light.p[ys], light.gn[ys], ss.d)
                if media:
                    tr, n = scene_mod.attenuated_transmittance(
                        scene, static, o_sh, ss.d, ss.dist * (1 - 1e-3),
                        _vertex_medium_toward(scene, static, light, ys, ss.d),
                        sampler, lane, sample,
                        DIM_SPLAT + 8 * (t * (N + 1) + s), active=ok,
                        with_stats=True)
                    ok = ok & (torch.amax(tr, dim=-1) > 0)
                    val = val * tr
                else:
                    n = ok.sum()
                    ok = ok & ~scene_mod.occluded(
                        scene, static, o_sh, ss.d, 0.0, ss.dist * (1 - 1e-3),
                        active=ok)
                n_rays = n_rays + n
                val = torch.where(ok[..., None], val * ss.imp[..., None], 0.0)
                # MIS: y_{s-1} drawn by the camera (the pinhole's converted
                # directional pdf, the orthographic film density), y_{s-2}
                # by y_{s-1}'s BSDF with wi from the camera
                lsubs = {ys: sensor_mod.camera_pdf_area(sensor, light.p[ys],
                                                        light.gn[ys])}
                if s >= 2:
                    d_unit, dist2 = _toward(light, ys, ys - 1)
                    lsubs[ys - 1] = _vertex_pdf_toward(
                        scene, static, light, ys, light_loc[ys], ss.d, d_unit,
                        dist2, light.gn[ys - 1])
                w = _mis_weight_st(eye, light, t, s, {}, lsubs)
                splat_uvs.append(torch.where(ok[..., None], ss.uv, -1.0))
                splat_vals.append(val * w[..., None])
                continue

            # --- s >= 1, t >= 1: connect z_t with y_{s-1}
            zt = t - 1
            ok = (eye.valid[zt] & eye.conn[zt] & light.valid[ys]
                  & light.conn[ys])
            med_a = None
            if media:
                dvec0 = light.p[ys] - eye.p[zt]
                med_a = _vertex_medium_toward(
                    scene, static, eye, zt, dvec0 / torch.clamp(
                        m.length(dvec0), min=1e-12)[..., None])
            tr, d_unit, dist, n = _visible(
                scene, static, eye.p[zt], eye.gn[zt], light.p[ys], ok, med_a,
                sampler, lane, sample, DIM_CONNECT + 8 * (t * (N + 1) + s))
            n_rays = n_rays + n
            ok = ok & (torch.amax(tr, dim=-1) > 0)
            dist2 = torch.clamp(dist * dist, min=1e-12)
            f_e = _vertex_f(scene, static, eye, zt, eye_loc[zt],
                            eye.wi_world[zt], d_unit)
            if s == 1:
                # y_0 is on the emitter: its emission profile toward z_t
                f_em = _emission_profile(scene, light, ys, -d_unit)
                contrib = eye.beta[zt] * f_e * light.beta[ys] * m.safe_div(
                    f_em, dist2)[..., None] * tr
            else:
                frame = light_loc[ys][2]
                f_l = _vertex_f(scene, static, light, ys, light_loc[ys],
                                light.wi_world[ys], -d_unit)
                corr = _shading_normal_correction(
                    frame.to_local(light.wi_world[ys]),
                    frame.to_local(-d_unit), frame.to_local(light.gn[ys]))
                if media:
                    corr = torch.where(light.is_med[ys], 1.0, corr)
                contrib = eye.beta[zt] * f_e * light.beta[ys] * f_l * \
                    m.safe_div(corr, dist2)[..., None] * tr
            contrib = torch.where(ok[..., None], contrib, 0.0)

            # --- the reverse pdfs beside the junction
            # z_t drawn from the light side
            if s == 1:
                e_id = light.emitter_id[ys]
                etype_l = scene.emitters.type[
                    torch.clamp(e_id, min=0).to(torch.int64)]
                pdf_dir = torch.clamp(m.dot(light.gn[ys], -d_unit),
                                      min=0.0) * INV_PI
                is_dl = (etype_l == em_mod.POINT) | (etype_l == em_mod.SPOT)
                pdf_dir = torch.where(
                    is_dl, _emission_dir_pdf(scene, e_id, -d_unit), pdf_dir)
                esubs = {zt: _to_area(pdf_dir, -d_unit, dist2, eye.gn[zt])}
            else:
                esubs = {zt: _vertex_pdf_toward(
                    scene, static, light, ys, light_loc[ys],
                    light.wi_world[ys], -d_unit, dist2, eye.gn[zt])}
            # z_{t-1} from z_t, wi now from the light side
            if t >= 2:
                dp_unit, dist2_p = _toward(eye, zt, zt - 1)
                esubs[zt - 1] = _vertex_pdf_toward(
                    scene, static, eye, zt, eye_loc[zt], d_unit, dp_unit,
                    dist2_p, eye.gn[zt - 1])
            # y_{s-1} from z_t
            lsubs = {ys: _vertex_pdf_toward(
                scene, static, eye, zt, eye_loc[zt], eye.wi_world[zt],
                d_unit, dist2, light.gn[ys])}
            # y_{s-2} from y_{s-1}, wi now from the eye side
            if s >= 2:
                dq_unit, dist2_q = _toward(light, ys, ys - 1)
                lsubs[ys - 1] = _vertex_pdf_toward(
                    scene, static, light, ys, light_loc[ys], -d_unit,
                    dq_unit, dist2_q, light.gn[ys - 1])
            w = _mis_weight_st(eye, light, t, s, esubs, lsubs)
            L = L + contrib * w[..., None]

    if splat_uvs:
        out = L, torch.stack(splat_uvs), torch.stack(splat_vals)
    else:
        out = (L, torch.zeros((0, R, 2), device=dev),
               torch.zeros((0, R, 3), device=dev))
    return (*out, n_rays) if with_stats else out
