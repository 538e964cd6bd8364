"""Scene container, device queries and the host-side builder (port of
``mitsuba_tpu/render/scene.py``, the subset that the Cornell box, the
bunny_x2 scene, the Veach MIS scene and the scene-file loader's scenes use).

The scene compiles on the host into flat tensors: a triangle soup with
per-triangle shading attributes and NEE area pdfs, analytic spheres, a
threaded BVH packed for the lane kernels, a material table, a texture
table (bitmaps and the procedural textures) and an emitter table.
``SceneStatic`` holds the facts the code branches on: every gather of a
later feature (opacity and blend-weight textures, the nested rows, normal
and bump maps) is gated on one, as in the JAX package.

Scenes of at most ``BRUTE_FORCE_MAX_TRIS`` triangles send their queries to
the brute-force kernels of ``ops/cuda_intersect``; larger ones build a
leaf_size=1 BVH, cut it into treelets, and send them to the lane kernels of
``ops/cuda_bvh``, or with ``MTS_BVH_KERNEL=treelet`` to the treelet kernel
K7, with the JAX package's dispatch. Spheres are tested in plain tensor code
beside those kernels and merged with the JAX package's tie rule; a scene may
hold spheres and no triangle. Materials are the BSDF types of
``render/bsdf.py`` (``SUPPORTED_TYPES``: the single-layer ones, the nested
and layered ones, one level deep, and the woven cloth, whose weave patterns
the builder stacks into ``Scene.irawan``), with an optional textured albedo,
mask opacity and blend weight, and normal or bump maps (the rough plastic's
and rough coating's transmittance polynomial baked at ``build``,
``core/rtrans.py``); lights are triangle area lights, analytic sphere lights
(cone-sampled in NEE), a constant environment and a lat-long environment
map, and the point, spot, directional and collimated delta lights; meshes
may be instanced. Participating media (``render/medium.py``: homogeneous
and grid media with their phase functions) sit in ``Scene.media``, and a
material row names the media inside and outside its surface. A material row
may name a subsurface profile (``render/subsurface.py``: the dipole's
profiles and point cloud, and refracted single scattering) in
``Scene.sss``. ``Scene.man_tri`` holds the rows of the dielectric and
thin-dielectric triangles that the Metropolis family's manifold walk
(``render/manifold.py``) tests. Anything else (the other textures) raises
``NotImplementedError``: it lands in a later slice.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel.build import build_bvh, treelet_roots, triangle_aabbs
from ..core import math as m
from ..core import rtrans
from ..core.frame import Frame
from ..core.transform import Transform
from ..device import resolve_device
from ..ops import cuda_bvh
from ..ops import cuda_intersect as bf
from ..ops import intersect as isect
from . import bsdf as bsdf_mod
from . import emitter as em_mod
from . import irawan as irawan_mod
from . import medium as med_mod
from . import phase as phase_mod
from . import subsurface as sss_mod
from . import texture as tex_mod
from .records import Interaction

# above this triangle count the JAX package builds a BVH (scene.py:37)
BRUTE_FORCE_MAX_TRIS = 512

# the JAX package's default resort schedules (rounds, chunk_nit, strip) for
# BVH queries that are not presorted (scene.py:70-75): a K3 launch covers
# chunk_nit * strip node visits per lane, and lanes are re-sorted by node
# pointer between launches
BVH_RESORT = (4, 24, 5)
BVH_RESORT_SHADOW = (1, 16, 10)
# the BVH kernel family (scene.py:62): "lane" (K3-K6) or "treelet" (K7)
BVH_KERNEL = os.environ.get("MTS_BVH_KERNEL", "lane")
BVH_KERNELS = ("lane", "treelet")
# the treelet cut of the scene's BVH (scene.py:1524)
TREELET_MAX_NODES = 4096


class Scene(NamedTuple):
    """Device scene: every leaf is a tensor on the render device."""

    tri_p0: torch.Tensor       # (T, 3)
    tri_e1: torch.Tensor       # (T, 3)
    tri_e2: torch.Tensor       # (T, 3)
    tri_n0: torch.Tensor       # (T, 3) shading normals per vertex
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor      # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_gn: torch.Tensor       # (T, 3) geometric normal (unit)
    tri_mat: torch.Tensor      # (T,) int32
    tri_emitter: torch.Tensor  # (T,) int32 (-1 none)
    tri_nee_pdf_area: torch.Tensor  # (T,) em_pmf * tri_pmf / area
    # a triangle-free scene keeps one placeholder triangle row, a scene
    # without spheres one placeholder sphere row (scene.py:1340,1485)
    sph_center: torch.Tensor   # (S, 3) analytic spheres
    sph_radius: torch.Tensor   # (S,)
    sph_mat: torch.Tensor      # (S,) int32
    sph_emitter: torch.Tensor  # (S,) int32 (-1: not an emitter)
    nodes: torch.Tensor        # (N, 12) BVH node table (ops/cuda_bvh.pack_nodes)
    tl_root: torch.Tensor      # (K,) int32 treelet root rows
    tl_skip: torch.Tensor      # (K,) int32 their skip links (end of the range)
    tl_lo: torch.Tensor        # (K, 3) treelet root boxes
    tl_hi: torch.Tensor        # (K, 3)
    # the octant tables of the BVH with their treelet ranges, which
    # closest-hit K3 and K5-K7 walk (ops/cuda_bvh.octant_tables); None
    # without a BVH
    octants: Optional[cuda_bvh.Octants]
    aabb_lo: torch.Tensor      # (3,) scene bounds
    aabb_hi: torch.Tensor      # (3,)
    radius: torch.Tensor       # () bounding-sphere radius
    materials: bsdf_mod.MaterialTable
    textures: tex_mod.TextureTable
    emitters: em_mod.EmitterTable
    irawan: irawan_mod.IrawanTable  # weave patterns (one zero row if none)
    media: med_mod.MediumTable      # participating media (one row if none)
    sss: sss_mod.SSSTable           # subsurface profiles and point cloud
    # (Tm, 19) float32 specular-mesh rows p0 e1 e2 | n0 n1 n2 | eta of the
    # dielectric and thin-dielectric triangles (``manifold_rows``), one
    # zero row without them; SceneBuilder and the bridge always set it
    man_tri: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class SceneStatic:
    """Hashable facts about a scene (the fields this slice branches on)."""

    n_tris: int
    n_spheres: int
    use_bvh: bool
    bsdf_types: tuple          # sorted tuple of bsdf type tags present
    emitter_types: tuple       # sorted tuple of emitter type tags present
    has_env: bool
    has_textures: bool = False   # a material reads an albedo, opacity or
                                 # weight texture
    n_bvh_nodes: int = 0       # node count of the BVH (0 without one)
    has_opacity_tex: bool = False
    has_weight_tex: bool = False
    nested_bsdf_types: tuple = ()  # sorted types of the rows nested rows name
    has_normal_maps: bool = False
    medium_types: tuple = ()   # sorted medium type tags present (no media: ())
    phase_types: tuple = ()    # sorted phase function tags of the media
    has_boundary_media: bool = False  # a material names an interior or
                                      # exterior medium
    has_sss: bool = False      # a material names a subsurface profile
    has_singlescatter: bool = False  # ... a MODE_SINGLESCATTER one
    n_manifold_tris: int = 0   # rows of Scene.man_tri (0: the zero row)


# the most dielectric triangles the manifold walk tests per step; above it
# the scene has no specular-mesh rows (scene.py:1597)
MAX_MANIFOLD_TRIS = 4096


def manifold_rows(p0, e1, e2, n0, n1, n2, tri_mat, mat_types, mat_eta0):
    """(rows, n) of the manifold walk's specular mesh (the JAX SceneBuilder's
    scene.py:1595-1615): the triangles whose material is a dielectric or a
    thin dielectric, as (n, 19) float32 rows p0 e1 e2 | n0 n1 n2 | eta
    (the row's first eta), when there are 1 to MAX_MANIFOLD_TRIS of them;
    else one zero row and n = 0. Array arguments are numpy, per triangle
    and per material."""
    tri_mat = np.asarray(tri_mat)
    diel = np.isin(np.asarray(mat_types)[tri_mat],
                   (bsdf_mod.DIELECTRIC, bsdf_mod.THIN_DIELECTRIC))
    idx = np.nonzero(diel)[0]
    if not 0 < idx.size <= MAX_MANIFOLD_TRIS:
        return np.zeros((1, 19), np.float32), 0
    cols = [np.asarray(a)[idx] for a in (p0, e1, e2, n0, n1, n2)]
    eta = np.asarray(mat_eta0, np.float64)[tri_mat[idx], None]
    return np.concatenate(cols + [eta], axis=1).astype(np.float32), \
        int(idx.size)


# SceneStatic fields of the JAX package whose non-default values need code
# that lands in a later slice, with the value the port supports
_LATER_SLICE_FIELDS = {"ewa_taps": 0}
# the medium and phase function type tags the port renders
MEDIUM_TYPES = (med_mod.HOMOGENEOUS, med_mod.HETEROGENEOUS)
PHASE_TYPES = (phase_mod.ISOTROPIC, phase_mod.HG, phase_mod.RAYLEIGH,
               phase_mod.MIXTURE, phase_mod.KKAY, phase_mod.MICROFLAKE)


def check_supported(static: dict) -> None:
    """Raise NotImplementedError unless the scene described by ``static``
    (SceneStatic fields by name) is one the port renders."""
    T = static["n_tris"]
    if bool(static["use_bvh"]) != (T > BRUTE_FORCE_MAX_TRIS):
        raise ValueError(
            f"use_bvh={static['use_bvh']} for {T} triangles: the builder "
            f"uses a BVH exactly above {BRUTE_FORCE_MAX_TRIS} triangles")
    for key, ok in _LATER_SLICE_FIELDS.items():
        if key in static and static[key] != ok and not (
                isinstance(ok, tuple) and tuple(static[key]) == ok):
            raise NotImplementedError(
                f"{key}={static[key]!r} lands in a later slice of the port")
    for t in (*static["bsdf_types"], *static.get("nested_bsdf_types", ())):
        if t not in bsdf_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {t} lands in a later slice of the port")
    for t in static["emitter_types"]:
        if t not in em_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"emitter type {t} lands in a later slice of the port")
    for key, known in (("medium_types", MEDIUM_TYPES),
                       ("phase_types", PHASE_TYPES)):
        for t in static.get(key, ()):
            if t not in known:
                raise NotImplementedError(
                    f"{key[:-6]} type {t} lands in a later slice of the port")


# === device queries =======================================================

def _ray_range(o, t_min, t_max, active):
    """Per-lane (t_min, t_max) float32 from scalars or (R,) tensors."""
    R = o.shape[0]

    def lanes(t):
        if isinstance(t, torch.Tensor):
            return t.to(torch.float32).expand(R).contiguous()
        return torch.full((R,), float(t), device=o.device)

    t_min, t_max = lanes(t_min), lanes(t_max)
    if active is not None:
        # inactive lanes trace degenerate rays (t_max = t_min): never a hit
        t_max = torch.where(active, t_max, t_min)
    return t_min, t_max


def _bvh_query(scene: Scene, static: SceneStatic, o, d, t_min, t_max,
               presorted: bool, any_hit: bool):
    """(hit, t, idx, u, v) through the BVH kernels, with the JAX package's
    dispatch (scene.py:195-235, 435-470). ``BVH_KERNEL == "treelet"``: every
    query goes to K7, sorted unless presorted, whatever the tree size. Else
    trees above LANE_VMEM_MAX_NODES go to K5 (sorted unless presorted);
    presorted queries to K4 as they come; the others through the resort
    schedule of K3 launches. Closest-hit K3, K5 and K7 walk the scene's
    octant tables."""
    if BVH_KERNEL not in BVH_KERNELS:
        raise ValueError(f"MTS_BVH_KERNEL={BVH_KERNEL!r}; expected one of "
                         f"{BVH_KERNELS}")
    if BVH_KERNEL == "treelet":
        return cuda_bvh.bvh_traverse_treelets(
            scene.nodes, scene.tl_root, scene.tl_skip, scene.tl_lo,
            scene.tl_hi, o, d, t_min, t_max, scene.aabb_lo, scene.aabb_hi,
            sort=not presorted, any_hit=any_hit, octants=scene.octants)
    N = static.n_bvh_nodes
    args = (scene.nodes, N, o, d, t_min, t_max, scene.aabb_lo, scene.aabb_hi)
    if N > cuda_bvh.LANE_VMEM_MAX_NODES:
        return cuda_bvh.bvh_traverse_lane_hbm(*args, sort=not presorted,
                                              any_hit=any_hit,
                                              octants=scene.octants)
    if presorted:
        return cuda_bvh.bvh_traverse_lane(*args, sort=False, any_hit=any_hit)
    rounds, chunk_nit, strip = BVH_RESORT_SHADOW if any_hit else BVH_RESORT
    return cuda_bvh.bvh_traverse_lane_resort(
        *args, any_hit=any_hit, strip=strip, rounds=rounds,
        chunk_nit=chunk_nit, octants=scene.octants)


def _tri_record(scene: Scene, tri_idx, tri_u, tri_v):
    """Shading record of the hit triangles by a gather (what K1 computes in
    registers): raw interpolated normal, geometric normal, uv, material,
    emitter and NEE area pdf. A miss (-1) reads row 0."""
    ti = torch.clamp(tri_idx, min=0).to(torch.int64)
    b1, b2 = tri_u[..., None], tri_v[..., None]
    b0 = 1.0 - b1 - b2
    n_sh_raw = (b0 * scene.tri_n0[ti] + b1 * scene.tri_n1[ti]
                + b2 * scene.tri_n2[ti])
    uv = (b0 * scene.tri_uv0[ti] + b1 * scene.tri_uv1[ti]
          + b2 * scene.tri_uv2[ti])
    return (n_sh_raw, scene.tri_gn[ti], uv, scene.tri_mat[ti],
            scene.tri_emitter[ti], scene.tri_nee_pdf_area[ti])


def ray_intersect(scene: Scene, static: SceneStatic, o, d, t_min, t_max,
                  active=None, presorted: bool = False) -> Interaction:
    """Closest hit + surface interaction record (Scene::rayIntersect +
    fillIntersectionRecord): triangles through the K1 brute-force kernel on
    small scenes, else through the BVH kernels and a gather of the hit
    triangle's record; spheres in plain tensor code, the closer hit kept
    with the JAX package's tie rule (a sphere wins only when strictly
    closer). ``presorted`` says the rays are coherent already (primary rays
    in raster order), so the BVH query skips its sort.

    ``o`` and ``d`` are detached on entry, as on the JAX package's TPU path
    (scene.py:202-203, 243-244): the kernels carry no gradient, so the hit
    record (p, wi, uv, ...) is a constant of the scene's parameters, on the
    CPU as on the card (the detached-sampling estimator)."""
    o, d = o.detach(), d.detach()
    t_min, t_max = _ray_range(o, t_min, t_max, active)
    R = o.shape[0]
    T = static.n_tris
    if T == 0:
        hit_t = torch.zeros(R, dtype=torch.bool, device=o.device)
        tri_t = torch.full((R,), torch.inf, device=o.device)
        tri_idx = torch.full((R,), -1, dtype=torch.int32, device=o.device)
        tri_u = tri_v = torch.zeros(R, device=o.device)
        record = _tri_record(scene, tri_idx, tri_u, tri_v)
    elif static.use_bvh:
        hit_t, tri_t, tri_idx, tri_u, tri_v = _bvh_query(
            scene, static, o, d, t_min, t_max, presorted, any_hit=False)
        record = _tri_record(scene, tri_idx, tri_u, tri_v)
    else:
        hit_t, tri_t, tri_idx, tri_u, tri_v, *record = \
            bf.brute_force_interaction(
                scene.tri_p0, scene.tri_e1, scene.tri_e2,
                scene.tri_n0, scene.tri_n1, scene.tri_n2,
                scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
                scene.tri_gn, scene.tri_mat, scene.tri_emitter,
                scene.tri_nee_pdf_area, o, d, t_min, t_max,
            )
    n_sh_raw, gn, uv, mat_id, em_id, nee_tri = record
    n_sh = m.normalize(n_sh_raw)
    valid, t = hit_t, tri_t
    if static.n_spheres > 0:
        hit_s, sph_t, sph_idx = isect.ray_brute_force_spheres(
            o, d, scene.sph_center, scene.sph_radius, t_min, t_max)
        closer = hit_s & (~hit_t | (sph_t < tri_t))
        valid = hit_t | closer
        t = torch.where(closer, sph_t, tri_t)
    # sanitized position for missed lanes: inf positions would poison
    # downstream NEE math
    t_safe = torch.where(valid, t, 1.0)
    p = o + t_safe[..., None] * d
    sph_dpdu = None
    if static.n_spheres > 0:
        # sphere.cpp fillIntersectionRecord
        si = torch.clamp(sph_idx, 0, static.n_spheres - 1).to(torch.int64)
        rel = p - scene.sph_center[si]
        n_sph = m.normalize(rel)
        if static.has_normal_maps:
            # dp/du of the (u, v) = (phi / 2pi, theta / pi) map below
            sph_dpdu = torch.stack([-rel[..., 1], rel[..., 0],
                                    torch.zeros_like(t)], dim=-1) \
                * (2.0 * math.pi)
        theta, phi = m.spherical_coordinates(n_sph)
        uv_sph = torch.stack([phi * (0.5 / math.pi), theta * (1.0 / math.pi)],
                             dim=-1)
        sc = closer[..., None]
        gn = torch.where(sc, n_sph, gn)
        n_sh = torch.where(sc, n_sph, n_sh)
        uv = torch.where(sc, uv_sph, uv)
        mat_id = torch.where(closer, scene.sph_mat[si], mat_id)
        em_id = torch.where(closer, scene.sph_emitter[si], em_id)
        # a sphere's primitive id follows the triangles'
        prim = torch.where(closer, T + sph_idx, tri_idx)
        nee_pdf = torch.where(closer | ~hit_t, 0.0, nee_tri)
    else:
        prim = tri_idx
        nee_pdf = torch.where(hit_t, nee_tri, 0.0)

    frame = Frame.from_normal(n_sh)
    if static.has_normal_maps:
        # a sphere lane takes its own sphere's tangent; the JAX package
        # hands every lane the triangle query's (ROADMAP.md, Queue 3)
        sph = None if sph_dpdu is None else (closer, sph_dpdu)
        frame = _perturb_frame(scene, tri_idx, uv, mat_id, frame, sph)
    wi_world = -d
    wi_local = frame.to_local(wi_world)
    return Interaction(
        valid=valid,
        t=torch.where(valid, t, torch.inf),
        p=p,
        gn=gn,
        sh_frame=frame,
        uv=uv,
        wi=wi_local,
        wi_world=wi_world,
        mat_id=torch.where(valid, mat_id, -1),
        emitter_id=torch.where(valid, em_id, -1),
        prim_id=torch.where(valid, prim, -1),
        nee_pdf_area=nee_pdf,
        bary=(torch.stack([tri_u, tri_v], dim=-1) if T > 0
              else torch.zeros((R, 2), device=o.device)),
    )


def _perturb_frame(scene: Scene, tri_idx, uv, mat_id, frame: Frame,
                   sph=None) -> Frame:
    """normalmap.cpp / bumpmap.cpp: the shading frame rebuilt from a
    tangent-space normal map, or from a height texture's finite differences
    at eps = 5e-4 in uv, on the lanes whose material has one. The tangent
    is the triangle's dpdu (trimesh.cpp computeUVTangents), the frame's own
    tangent where the uvs are degenerate; ``sph`` = (lanes, dpdu) gives the
    lanes that hit a sphere and its dpdu there (sphere.cpp), which falls
    back to the frame's tangent at the poles."""
    mid = torch.clamp(mat_id, min=0).to(torch.int64)
    mats = scene.materials
    ntex, btex = mats.normal_tex[mid], mats.bump_tex[mid]
    bscale = mats.bump_scale[mid]
    has_n, has_b = ntex >= 0, btex >= 0

    ti = torch.clamp(tri_idx, min=0).to(torch.int64)
    e1, e2 = scene.tri_e1[ti], scene.tri_e2[ti]
    uv0 = scene.tri_uv0[ti]
    duv1 = scene.tri_uv1[ti] - uv0
    duv2 = scene.tri_uv2[ti] - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    ok_uv = torch.abs(det) > 1e-12
    inv = m.safe_div(1.0, torch.where(ok_uv, det, 1.0))
    dpdu = (e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2]) * inv[..., None]
    t_u = torch.where(ok_uv[..., None], dpdu, frame.s)
    if sph is not None:
        t_u = torch.where(sph[0][..., None], sph[1], t_u)
    n = frame.n
    t_u = t_u - n * m.dot(n, t_u, keepdim=True)
    t_len = m.length(t_u)
    t_u = torch.where((t_len > 1e-9)[..., None],
                      t_u / torch.clamp(t_len, min=1e-9)[..., None], frame.s)
    b_v = m.cross(n, t_u)

    # the normal map: tangent-space rgb in [0, 1]
    flat = torch.tensor([0.5, 0.5, 1.0], device=n.device).expand(n.shape)
    nt = 2.0 * tex_mod.eval_texture(scene.textures, ntex, uv, flat) - 1.0
    n_nm = m.normalize(nt[..., 0:1] * t_u + nt[..., 1:2] * b_v
                       + nt[..., 2:3] * n)
    n_new = torch.where(has_n[..., None], n_nm, n)
    # the bump map: the height's finite differences (a tensor divisor: the
    # card divides by a host scalar through its reciprocal)
    duv = torch.tensor([[5e-4, 0.0], [0.0, 5e-4]], device=n.device)
    eps = duv[0, 0]
    zero3 = torch.zeros(n.shape, device=n.device)
    h0, hu, hv = (tex_mod.eval_texture(scene.textures, btex, uv_, zero3)[..., 0]
                  for uv_ in (uv, uv + duv[0], uv + duv[1]))
    dhdu = (hu - h0) / eps * bscale
    dhdv = (hv - h0) / eps * bscale
    n_bm = m.normalize(m.cross(t_u + dhdu[..., None] * n,
                               b_v + dhdv[..., None] * n))
    n_bm = n_bm * torch.sign(m.dot(n_bm, n, keepdim=True))
    n_new = torch.where(has_b[..., None], n_bm, n_new)

    new_frame = Frame.from_normal(m.normalize(n_new))
    any_map = (has_n | has_b)[..., None]
    return Frame(s=torch.where(any_map, new_frame.s, frame.s),
                 t=torch.where(any_map, new_frame.t, frame.t),
                 n=torch.where(any_map, new_frame.n, frame.n))


def occluded(scene: Scene, static: SceneStatic, o, d, t_min, t_max,
             active=None, presorted: bool = False):
    """Boolean shadow-ray query: the K2 brute-force kernel on small scenes,
    else an any-hit BVH query, or'ed with the spheres' test; ``o`` and
    ``d`` detached as in ``ray_intersect``."""
    o, d = o.detach(), d.detach()
    t_min, t_max = _ray_range(o, t_min, t_max, active)
    if static.n_tris == 0:
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    elif static.use_bvh:
        occ = _bvh_query(scene, static, o, d, t_min, t_max, presorted,
                         any_hit=True)[0]
    else:
        occ = bf.brute_force_closest_hit(
            scene.tri_p0, scene.tri_e1, scene.tri_e2, o, d, t_min, t_max)[0]
    if static.n_spheres > 0:
        occ = occ | isect.ray_brute_force_spheres(
            o, d, scene.sph_center, scene.sph_radius, t_min, t_max)[0]
    return occ


def attenuated_transmittance(scene: Scene, static: SceneStatic, o, d, dist,
                             medium0, sampler, pixel, sample, dim0: int,
                             active=None, max_crossings: int = 4,
                             with_stats: bool = False):
    """Transmittance along shadow segments through chains of media behind
    null boundaries (Scene::evalTransmittance, scene.cpp:854-898; the JAX
    scene.py:509): each of ``max_crossings + 1`` closest-hit queries finds
    the next surface from the last crossing on (from t + 1e-4); the medium
    the lane is in attenuates the segment up to it (crossing i draws from
    dimension dim0 + 8 i on); a null surface swaps the lane's medium for its
    interior (entered against its normal) or exterior one, any other
    surface occludes (0). A chain still crossing after the last query gives
    0 (never brighter than the truth).

    ``dist`` (R,) float32 and ``medium0`` (R,) int32 are per lane. Returns
    (R, 3), 1 on lanes with ``active`` False; with ``with_stats``
    also the number of ray queries issued (an int64 tensor: the lanes
    still walking at each query)."""
    R = o.shape[0]
    dev = o.device
    mtypes = static.medium_types
    mats = scene.materials
    tr = torch.ones((R, 3), device=dev)
    t_ofs = torch.zeros(R, device=dev)
    med_id = medium0
    alive = (active if active is not None
             else torch.ones(R, dtype=torch.bool, device=dev))
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(max_crossings + 1):
        n_rays = n_rays + alive.sum()
        its = ray_intersect(scene, static, o, d, t_ofs + 1e-4, dist,
                            active=alive)
        seg_end = torch.where(its.valid, its.t, dist)
        if mtypes:
            seg_tr = med_mod.eval_transmittance(
                scene.media, mtypes, med_id, o + t_ofs[..., None] * d, d,
                torch.clamp(seg_end - t_ofs, min=0.0), sampler, pixel,
                sample, dim0 + 8 * i, alive)
            tr = tr * torch.where(alive[..., None], seg_tr, 1.0)
        mat = torch.clamp(its.mat_id, min=0).to(torch.int64)
        is_null = mats.type[mat] == bsdf_mod.NULL
        blocked = alive & its.valid & ~is_null
        tr = torch.where(blocked[..., None], 0.0, tr)
        crossing = alive & its.valid & is_null
        entering = m.dot(d, its.gn) < 0
        med_id = torch.where(
            crossing, torch.where(entering, mats.interior_medium[mat],
                                  mats.exterior_medium[mat]), med_id)
        t_ofs = torch.where(crossing, its.t, t_ofs)
        alive = crossing
    tr = torch.where(alive[..., None], 0.0, tr)
    return (tr, n_rays) if with_stats else tr


def uv_footprint(scene: Scene, its: Interaction, spread):
    """Ray-cone texture footprint in uv units (the isotropic branch of the
    JAX package's ray differentials). ``spread`` is the angular pixel size
    at the sensor (radians): a cone of diameter t*spread lands stretched by
    1/cos theta, and the triangle's uv density sqrt(area_uv / area_world)
    converts the world diameter to uv units. Returns (R,), 0 on invalid
    lanes (-> finest level)."""
    T = scene.tri_p0.shape[0]
    ti = torch.clamp(its.prim_id, 0, T - 1).to(torch.int64)
    e1, e2 = scene.tri_e1[ti], scene.tri_e2[ti]
    uv0 = scene.tri_uv0[ti]
    duv1 = scene.tri_uv1[ti] - uv0
    duv2 = scene.tri_uv2[ti] - uv0
    area_w = 0.5 * m.length(m.cross(e1, e2))
    area_uv = 0.5 * torch.abs(
        duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0])
    density = torch.sqrt(m.safe_div(area_uv, torch.clamp(area_w, min=1e-20)))
    cos_t = torch.abs(m.dot(its.wi_world, its.gn))
    world_d = torch.where(torch.isfinite(its.t), its.t, 0.0) * spread
    # geometric mean of the minor (d) and major (d/cos) footprint axes
    fp = world_d * density / torch.sqrt(torch.clamp(cos_t, 1e-2, 1.0))
    tri_lane = its.valid & (its.prim_id >= 0) & (its.prim_id < T)
    return torch.where(tri_lane, fp, 0.0)


def eval_albedo(scene: Scene, its: Interaction, static: SceneStatic,
                fp_uv=None):
    """Diffuse reflectance with the bitmap lookup (Texture::eval path)."""
    mid = torch.clamp(its.mat_id, min=0).to(torch.int64)
    base = scene.materials.albedo[mid]
    if not static.has_textures:
        return base
    tex_id = scene.materials.albedo_tex[mid]
    return tex_mod.eval_texture(scene.textures, tex_id, its.uv, base,
                                fp_uv=fp_uv)


def bsdf_locals(scene: Scene, its: Interaction, static: SceneStatic,
                fp_uv=None) -> bsdf_mod.BsdfLocals:
    """Per-lane BSDF parameters at the hits, with the textured albedo and,
    where the scene has them, the textured mask opacity and blend weight
    (base level). ``fp_uv`` is the ray-cone footprint that selects the
    albedo's MIP level."""
    types = static.bsdf_types
    textured_opacity = (static.has_textures and static.has_opacity_tex
                        and bsdf_mod.MASK in types)
    textured_weight = (static.has_textures and static.has_weight_tex and any(
        t in types for t in (bsdf_mod.MIXTURE, bsdf_mod.BLEND)))
    opacity = blend = None
    if textured_opacity or textured_weight:
        mid = torch.clamp(its.mat_id, min=0).to(torch.int64)
        ones3 = torch.ones(its.uv.shape[:-1] + (3,), device=its.uv.device)
        if textured_opacity:
            opacity = tex_mod.eval_texture(
                scene.textures, scene.materials.opacity_tex[mid], its.uv,
                ones3)[..., 0]
        if textured_weight:
            w_base = scene.materials.weight[mid][..., None].expand(
                ones3.shape)
            blend = tex_mod.eval_texture(
                scene.textures, scene.materials.weight_tex[mid], its.uv,
                w_base)[..., 0]
    bl = bsdf_mod.gather_locals(
        scene.materials, its.mat_id, types,
        albedo_override=eval_albedo(scene, its, static, fp_uv=fp_uv),
        opacity_override=opacity, blend_override=blend)
    if bsdf_mod.IRAWAN in types:
        bl = _yarn_locals(scene, its, bl, its.mat_id)
    return bl


def _yarn_locals(scene: Scene, its: Interaction, bl, mat_id):
    """``bl`` with the yarn parameters of the weave pattern at the hits'
    uv on its IRAWAN lanes (and the yarn's kd as their albedo), zeros
    elsewhere (the JAX scene.py:709-723)."""
    mid = torch.clamp(mat_id, min=0).to(torch.int64)
    iw_par, iw_ks, iw_kd = irawan_mod.lane_params(
        scene.irawan, scene.materials.irawan[mid], its.uv)
    sel = (bl.type == bsdf_mod.IRAWAN)[..., None]
    return bl._replace(iw_par=torch.where(sel, iw_par, 0.0),
                       iw_ks=torch.where(sel, iw_ks, 0.0),
                       albedo=torch.where(sel, iw_kd, bl.albedo))


def bsdf_nested(scene: Scene, its: Interaction, static: SceneStatic):
    """``nested`` of bsdf.eval, pdf and sample: the locals of each lane's
    nested rows A and B (B only where the scene has a mixture or a blend,
    the only types that read it) with their textured albedos (base level),
    and the types they can hold; None in a scene without nesting."""
    ntypes = static.nested_bsdf_types
    if not ntypes:
        return None
    mid = torch.clamp(its.mat_id, min=0).to(torch.int64)

    def locals_of(nid):
        nid = torch.clamp(nid, min=0).to(torch.int64)
        alb = scene.materials.albedo[nid]
        if static.has_textures:
            alb = tex_mod.eval_texture(scene.textures,
                                       scene.materials.albedo_tex[nid],
                                       its.uv, alb)
        bl = bsdf_mod.gather_locals(scene.materials, nid, ntypes,
                                    albedo_override=alb)
        # the JAX package gathers no yarn parameters for a nested row
        # (scene.py:727: a nested irawan is a Lambertian of the row's
        # albedo there; ROADMAP.md, Queue 3)
        if bsdf_mod.IRAWAN in ntypes:
            bl = _yarn_locals(scene, its, bl, nid)
        return bl

    bl_b = None
    if any(t in static.bsdf_types for t in (bsdf_mod.MIXTURE, bsdf_mod.BLEND)):
        bl_b = locals_of(scene.materials.nested_b[mid])
    return locals_of(scene.materials.nested_a[mid]), bl_b, ntypes


def emitted_radiance(scene: Scene, static: SceneStatic, its: Interaction, d):
    """Radiance emitted by a hit surface toward -d (AreaEmitter::eval: only
    the front side emits)."""
    has = its.emitter_id >= 0
    e = torch.clamp(its.emitter_id, min=0).to(torch.int64)
    front = m.dot(its.gn, -d) > 0
    rad = scene.emitters.radiance[e]
    return torch.where((has & front)[..., None], rad, 0.0)


def pdf_emitter_hit(scene: Scene, its: Interaction, ref_p,
                    static: SceneStatic):
    """Solid-angle NEE pdf of the point a BSDF-sampled ray hit
    (Scene::pdfEmitterDirect), from the per-triangle area pdf on the record;
    a hit on a sphere light reports the cone-sampling pdf instead
    (sphere.cpp pdfDirect): the record's 0 there would count it twice
    under MIS."""
    pdf_area = its.nee_pdf_area
    to_hit = its.p - ref_p
    d2 = m.squared_length(to_hit)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    cos_l = torch.abs(m.dot(its.gn, -to_hit / dist[..., None]))
    pdf = m.safe_div(pdf_area * d2, torch.clamp(cos_l, min=1e-7))
    if em_mod.SPHERE in static.emitter_types and static.n_spheres > 0:
        # a sphere's primitive id follows the triangles' (ray_intersect).
        # The JAX package counts tri_p0's rows here (scene.py:775), which
        # in a triangle-free scene include the placeholder row, so there its
        # sphere k reads sphere k - 1's emitter; the port does not copy that
        T = static.n_tris
        si = torch.clamp(its.prim_id - T, 0, static.n_spheres - 1).to(
            torch.int64)
        e_sph = scene.sph_emitter[si]
        is_sph_em = (its.prim_id >= T) & (e_sph >= 0)
        ei = torch.clamp(e_sph, min=0).to(torch.int64)
        pdf_cone = em_mod.pdf_direct_sphere(
            scene.emitters, ei, ref_p, scene.sph_center[si],
            scene.sph_radius[si])
        pdf = torch.where(is_sph_em, pdf_cone, pdf)
    return pdf


# === host-side builder ====================================================

@dataclass
class _Mesh:
    verts: np.ndarray
    faces: np.ndarray
    mat: int
    emitter: int
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None


@dataclass
class SceneBuilder:
    """Assemble a scene on the host, then compile it to device tensors.

    The arithmetic of ``build`` is the JAX package's (float64 on the host,
    cast to float32 at the end), and its BVH builder is a copy of the JAX
    package's, so the two builders give the same tables.
    """

    meshes: list = field(default_factory=list)
    mats: list = field(default_factory=list)
    emitters: list = field(default_factory=list)
    textures: list = field(default_factory=list)
    bitmaps: list = field(default_factory=list)
    shapegroups: list = field(default_factory=list)
    spheres: list = field(default_factory=list)
    irawan: list = field(default_factory=list)  # (pattern dict, repeats)
    media: list = field(default_factory=list)
    vol_grids: list = field(default_factory=list)
    subsurfaces: list = field(default_factory=list)

    def add_material(self, type: int = bsdf_mod.DIFFUSE,
                     albedo=(0.5, 0.5, 0.5), albedo_tex: int = -1,
                     spec_refl=(1.0, 1.0, 1.0), spec_trans=(1.0, 1.0, 1.0),
                     eta=(1.5046, 1.5046, 1.5046),
                     k=(0.0, 0.0, 0.0), alpha=(0.1, 0.1), alpha_tex: int = -1,
                     dist: int = 0, nonlinear: bool = False,
                     twosided: bool = False, opacity_tex: int = -1,
                     nested_a: int = -1, nested_b: int = -1,
                     weight: float = 0.5, weight_tex: int = -1,
                     normal_tex: int = -1, bump_tex: int = -1,
                     bump_scale: float = 1.0, hk_thickness: float = 1.0,
                     hk_g: float = 0.0, cauchy_b: float = 0.0,
                     irawan: int = -1, interior_medium: int = -1,
                     exterior_medium: int = -1, subsurface: int = -1) -> int:
        """A material row with the JAX package's keywords and defaults
        (scene.py:819-865) for the columns the port reads; a scalar
        ``eta`` or ``alpha`` is replicated. An HK row reads sigma_s from
        ``albedo`` and sigma_t from ``k``. A nested row (MASK, MIXTURE,
        BLEND, COATING, ROUGHCOATING) names rows ``nested_a`` (and
        ``nested_b``) of single-layer types; a coating's ``k`` is sigma_a
        times the thickness. ``normal_tex`` / ``bump_tex`` put a normal or
        bump map on the row. An IRAWAN row names the weave pattern
        ``irawan`` (``add_irawan_pattern``). ``cauchy_b`` is the row's
        Cauchy dispersion coefficient (um^2), which the spectral render
        reads. ``interior_medium`` and ``exterior_medium`` name the media
        (``add_medium_*``) inside and outside the row's surfaces, -1 for
        none; ``subsurface`` names a profile (``add_subsurface``)."""
        if type not in bsdf_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {type} lands in a later slice of the port")
        if alpha_tex >= 0:
            raise NotImplementedError(
                "roughness textures land in a later slice of the port "
                "(ROADMAP.md, Queue 1 item 3.2.3)")
        if np.isscalar(eta):
            eta = (float(eta),) * 3
        if np.isscalar(alpha):
            alpha = (float(alpha),) * 2
        self.mats.append(dict(type=type, albedo=tuple(albedo),
                              albedo_tex=albedo_tex, spec_refl=tuple(spec_refl),
                              spec_trans=tuple(spec_trans), eta=tuple(eta),
                              k=tuple(k), alpha=tuple(alpha), dist=dist,
                              nonlinear=bool(nonlinear), twosided=twosided,
                              opacity_tex=opacity_tex, nested_a=nested_a,
                              nested_b=nested_b, weight=weight,
                              weight_tex=weight_tex, normal_tex=normal_tex,
                              bump_tex=bump_tex, bump_scale=bump_scale,
                              hk_thickness=hk_thickness, hk_g=hk_g,
                              cauchy_b=cauchy_b, irawan=irawan,
                              interior_medium=interior_medium,
                              exterior_medium=exterior_medium,
                              subsurface=subsurface))
        return len(self.mats) - 1

    def add_irawan_pattern(self, preset: str = "plain", filename: str = "",
                           kd=(0.3, 0.3, 0.3), ks=(0.4, 0.4, 0.4),
                           repeat_u: float = 10.0,
                           repeat_v: float = 10.0) -> int:
        """A weave pattern: a reference-format ``.cloth`` file, or else a
        built-in preset with yarn colours ``kd`` and ``ks``, repeated
        (``repeat_u``, ``repeat_v``) times over the uv square. Returns its
        id for ``add_material(type=bsdf.IRAWAN, irawan=id)``."""
        pd = (irawan_mod.load_cloth(filename) if filename
              else irawan_mod.preset(preset, kd=kd, ks=ks))
        self.irawan.append((pd, (float(repeat_u), float(repeat_v))))
        return len(self.irawan) - 1

    # --- participating media (the JAX scene.py:931-1051) ---
    @staticmethod
    def _phase_kw(phase_type, phase_g, kw):
        """The medium's phase function: its type tag, g and the other
        models' parameters (``phase_g2``, ``phase_w2``, ``phase_ks``,
        ``phase_exp``, ``phase_sigma``, ``phase_axis``) with the JAX
        builder's defaults."""
        return dict(
            phase_type=phase_type, phase_g=phase_g,
            phase_g2=kw.get("phase_g2", 0.0), phase_w2=kw.get("phase_w2", 0.0),
            phase_ks=kw.get("phase_ks", 0.0), phase_exp=kw.get("phase_exp", 4.0),
            phase_sigma=kw.get("phase_sigma", 0.3),
            phase_axis=tuple(np.asarray(kw.get("phase_axis", (0, 0, 1)),
                                        float)))

    def add_medium_homogeneous(self, sigma_s=(1.0,) * 3, sigma_a=(0.1,) * 3,
                               phase_type: int = 0, phase_g: float = 0.0,
                               scale: float = 1.0, **phase_kw) -> int:
        """homogeneous.cpp: scattering and absorption coefficients (per RGB
        channel) times ``scale``. Returns the medium's id."""
        sigma_s = np.asarray(sigma_s, float)
        sigma_t = sigma_s + np.asarray(sigma_a, float)
        albedo = np.divide(sigma_s, np.maximum(sigma_t, 1e-20))
        self.media.append(dict(
            type=med_mod.HOMOGENEOUS, sigma_t=tuple(sigma_t),
            albedo=tuple(albedo), scale=scale, grid=-1,
            world_to_grid=np.eye(4),
            **self._phase_kw(phase_type, phase_g, phase_kw)))
        return len(self.media) - 1

    def add_medium_heterogeneous(self, density_grid, sigma_t=(1.0,) * 3,
                                 albedo=(0.8,) * 3, phase_type: int = 0,
                                 phase_g: float = 0.0, scale: float = 1.0,
                                 world_to_grid=None, **phase_kw) -> int:
        """heterogeneous.cpp over a (D, H, W) density grid: extinction
        ``sigma_t`` times density times ``scale``; ``world_to_grid`` maps
        the grid's box onto the unit cube (identity by default). Returns
        the medium's id."""
        self.vol_grids.append(np.asarray(density_grid, np.float32))
        self.media.append(dict(
            type=med_mod.HETEROGENEOUS,
            sigma_t=tuple(np.asarray(sigma_t, float)),
            albedo=tuple(np.asarray(albedo, float)), scale=scale,
            grid=len(self.vol_grids) - 1,
            world_to_grid=(np.eye(4) if world_to_grid is None
                           else np.asarray(world_to_grid, float)),
            **self._phase_kw(phase_type, phase_g, phase_kw)))
        return len(self.media) - 1

    def add_subsurface(self, sigma_s=(1.0,) * 3, sigma_a=(0.05,) * 3,
                       g: float = 0.0, eta: float = 1.3,
                       mode: int = sss_mod.MODE_DIPOLE) -> int:
        """A subsurface profile, for ``add_material(subsurface=id)``
        (scene.py:898-913): the dipole (``MODE_DIPOLE``: call
        ``subsurface.prepare(scene, static)`` once after ``build`` to place
        its point cloud) or refracted single scattering
        (``MODE_SINGLESCATTER``, no preparation). Returns its id."""
        self.subsurfaces.append(dict(
            sigma_s=tuple(np.asarray(sigma_s, float)),
            sigma_a=tuple(np.asarray(sigma_a, float)),
            g=float(g), eta=float(eta), mode=int(mode)))
        return len(self.subsurfaces) - 1

    def _build_sss(self, dev) -> sss_mod.SSSTable:
        """The subsurface table (scene.py:915-932): each material's profile
        id and the profiles' rows (the empty table's one row without any),
        with the empty point cloud."""
        t = sss_mod.SSSTable.empty(len(self.mats), dev)
        t = t._replace(mat_sss=torch.tensor(
            [mm["subsurface"] for mm in self.mats], dtype=torch.int32,
            device=dev))
        subs = self.subsurfaces
        if subs:
            def f32(key):
                return torch.tensor(np.asarray([s_[key] for s_ in subs],
                                               np.float32), device=dev)

            t = t._replace(
                sigma_s=f32("sigma_s"), sigma_a=f32("sigma_a"), g=f32("g"),
                eta=f32("eta"), mode=torch.tensor(
                    [s_["mode"] for s_ in subs], dtype=torch.int32,
                    device=dev))
        return t

    def _build_media(self, dev) -> med_mod.MediumTable:
        """The medium table: the rows, the grids zero-padded into one stack,
        each medium's majorant, and per grid the supergrid of maxima over
        each of SUPER_RES^3 cells dilated by one voxel."""
        if not self.media:
            return med_mod.MediumTable.empty(dev)
        grids = self.vol_grids
        if grids:
            shape = tuple(max(g.shape[k] for g in grids) for k in range(3))
            stack = np.zeros((len(grids),) + shape, np.float32)
            sizes = np.zeros((len(grids), 3), np.int32)
            for i, g in enumerate(grids):
                stack[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g
                sizes[i] = g.shape
        else:
            stack = np.zeros((1, 1, 1, 1), np.float32)
            sizes = np.ones((1, 3), np.int32)
        maj = []
        for mm in self.media:
            smax = max(mm["sigma_t"]) * mm["scale"]
            if mm["grid"] >= 0:
                smax = float(np.mean(mm["sigma_t"])) * mm["scale"] * float(
                    grids[mm["grid"]].max())
            maj.append(max(smax, 1e-9))
        S = med_mod.SUPER_RES
        if grids:
            super_maj = np.zeros((len(grids), S, S, S), np.float32)
            for i, g in enumerate(grids):
                # each cell's voxel range [lo, hi] on every axis, one voxel
                # wider on each side
                rng = [[(max(int(np.floor(c / S * (n - 1))) - 1, 0),
                         min(int(np.ceil((c + 1) / S * (n - 1))) + 1, n - 1))
                        for c in range(S)] for n in g.shape]
                for cz, (z0, z1) in enumerate(rng[0]):
                    for cy, (y0, y1) in enumerate(rng[1]):
                        for cx, (x0, x1) in enumerate(rng[2]):
                            super_maj[i, cz, cy, cx] = g[
                                z0:z1 + 1, y0:y1 + 1, x0:x1 + 1].max()
        else:
            super_maj = np.ones((1, 1, 1, 1), np.float32)

        def col(key, dtype=np.float32):
            return torch.as_tensor(
                np.asarray([mm[key] for mm in self.media], dtype), device=dev)

        return med_mod.MediumTable(
            type=col("type", np.int32), sigma_t=col("sigma_t"),
            albedo=col("albedo"), phase_type=col("phase_type", np.int32),
            phase_g=col("phase_g"), phase_g2=col("phase_g2"),
            phase_w2=col("phase_w2"), phase_ks=col("phase_ks"),
            phase_exp=col("phase_exp"), phase_sigma=col("phase_sigma"),
            phase_axis=col("phase_axis"), scale=col("scale"),
            grid_idx=col("grid", np.int32),
            grids=torch.as_tensor(stack, device=dev),
            grid_size=torch.as_tensor(sizes, device=dev),
            world_to_grid=col("world_to_grid"),
            majorant=torch.as_tensor(np.asarray(maj, np.float32), device=dev),
            super_maj=torch.as_tensor(super_maj, device=dev))

    def _add_texture(self, type, color0=(0.0,) * 3, color1=(0.0,) * 3,
                     uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0),
                     line_width=0.01, scale=(1.0, 1.0, 1.0),
                     bitmap=-1) -> int:
        self.textures.append(dict(
            type=type, color0=tuple(color0), color1=tuple(color1),
            uv_scale=tuple(uv_scale), uv_offset=tuple(uv_offset),
            line_width=line_width, scale=tuple(scale), bitmap=bitmap))
        return len(self.textures) - 1

    def add_texture_constant(self, value) -> int:
        """A constant texture (the JAX SceneBuilder's, e.g. a mask's constant
        opacity)."""
        return self._add_texture(tex_mod.TEX_CONSTANT, color0=value)

    def add_texture_checkerboard(self, color0=(0.4,) * 3, color1=(0.2,) * 3,
                                 uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0),
                                 scale=(1.0, 1.0, 1.0)) -> int:
        """checkerboard.cpp: color0 where floor(2u) + floor(2v) is even."""
        return self._add_texture(tex_mod.TEX_CHECKERBOARD, color0, color1,
                                 uv_scale, uv_offset, scale=scale)

    def add_texture_grid(self, color0=(0.2,) * 3, color1=(0.4,) * 3,
                         line_width=0.01, uv_scale=(1.0, 1.0),
                         uv_offset=(0.0, 0.0)) -> int:
        """gridtexture.cpp: color1 within ``line_width`` of a unit cell's
        edge, color0 inside."""
        return self._add_texture(tex_mod.TEX_GRID, color0, color1, uv_scale,
                                 uv_offset, line_width)

    def add_texture_scale(self, nested: int, value) -> int:
        """scale.cpp: a copy of texture ``nested`` with its multiplier times
        ``value`` (folded at build time)."""
        src = dict(self.textures[nested])
        v = np.asarray(value, float) * np.ones(3)
        src["scale"] = tuple(np.asarray(src["scale"], float) * v)
        self.textures.append(src)
        return len(self.textures) - 1

    def add_texture_bitmap(self, image, uv_scale=(1.0, 1.0),
                           uv_offset=(0.0, 0.0), scale=(1.0, 1.0, 1.0)) -> int:
        """A bitmap texture (bitmap.cpp) from an (H, W, 3) or (H, W) image;
        repeat wrapping, MIP chain built at ``build``."""
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        self.bitmaps.append(img)
        return self._add_texture(tex_mod.TEX_BITMAP, uv_scale=uv_scale,
                                 uv_offset=uv_offset, scale=scale,
                                 bitmap=len(self.bitmaps) - 1)

    def add_mesh(self, verts, faces, mat: int, emitter_radiance=None,
                 normals=None, uvs=None) -> None:
        verts = np.asarray(verts, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int64)
        em = -1
        if emitter_radiance is not None:
            self.emitters.append(dict(
                type=em_mod.AREA,
                radiance=tuple(np.asarray(emitter_radiance, dtype=float))))
            em = len(self.emitters) - 1
        self.meshes.append(_Mesh(verts, faces, mat, em, normals, uvs))

    def add_shapegroup(self, parts) -> int:
        """A reusable geometry group (shapegroup.cpp): ``parts`` is a list of
        dicts with keys verts/faces/mat (+ optional normals/uvs). Instances
        are flattened into the one global BVH at build time."""
        self.shapegroups.append(list(parts))
        return len(self.shapegroups) - 1

    def add_instance(self, group: int, to_world: Transform = None) -> None:
        """instance.cpp: replicate a shapegroup under a rigid transform."""
        t = to_world if to_world is not None else Transform.identity()
        for part in self.shapegroups[group]:
            n = part.get("normals")
            self.add_mesh(
                t.apply_point(np.asarray(part["verts"], np.float64)),
                part["faces"], part["mat"],
                normals=(t.apply_normal(np.asarray(n, np.float64))
                         if n is not None else None),
                uvs=part.get("uvs"))

    def add_sphere(self, center, radius, mat: int,
                   emitter_radiance=None) -> None:
        """An analytic sphere (sphere.cpp); with ``emitter_radiance`` a
        sphere light, sampled by its cone in NEE. The emitter row comes
        before the sphere row, in the JAX order, so interleaved mesh and
        sphere lights keep the JAX package's emitter indices."""
        e = -1
        if emitter_radiance is not None:
            e = len(self.emitters)
            self.emitters.append(dict(
                type=em_mod.SPHERE, radiance=tuple(emitter_radiance),
                position=tuple(np.asarray(center, float)),
                spot_cos=(float(radius), 0.0)))
        self.spheres.append((np.asarray(center, float), float(radius), mat, e))

    def add_point_light(self, position, intensity) -> int:
        """point.cpp: a point light of radiant ``intensity``."""
        self.emitters.append(dict(type=em_mod.POINT,
                                  radiance=tuple(intensity),
                                  position=tuple(position)))
        return len(self.emitters) - 1

    def add_spot_light(self, position, direction, intensity,
                       cutoff_deg=20.0, beamwidth_deg=None) -> int:
        """spot.cpp: a point light along ``direction`` whose intensity falls
        off linearly in cos from ``beamwidth_deg`` (0.75 of the cutoff by
        default) to ``cutoff_deg``."""
        if beamwidth_deg is None:
            beamwidth_deg = cutoff_deg * 0.75
        d = np.asarray(direction, float)
        d = d / np.linalg.norm(d)
        self.emitters.append(dict(
            type=em_mod.SPOT, radiance=tuple(intensity),
            position=tuple(position), direction=tuple(d),
            spot_cos=(float(np.cos(np.deg2rad(cutoff_deg))),
                      float(np.cos(np.deg2rad(beamwidth_deg))))))
        return len(self.emitters) - 1

    def add_directional_light(self, direction, irradiance) -> int:
        """directional.cpp: light travelling along ``direction``."""
        d = np.asarray(direction, float)
        d = d / np.linalg.norm(d)
        self.emitters.append(dict(type=em_mod.DIRECTIONAL,
                                  radiance=tuple(irradiance),
                                  direction=tuple(d)))
        return len(self.emitters) - 1

    def add_collimated_beam(self, position, direction, power) -> int:
        """collimated.cpp: a zero-radius beam. Next-event estimation and hit
        queries never see it; it takes its share of the selection pmf."""
        d = np.asarray(direction, float)
        d = d / np.linalg.norm(d)
        self.emitters.append(dict(type=em_mod.COLLIMATED,
                                  radiance=tuple(power),
                                  position=tuple(position),
                                  direction=tuple(d)))
        return len(self.emitters) - 1

    def add_constant_emitter(self, radiance) -> int:
        """A constant environment (constant.cpp): the same radiance from
        every direction, sampled uniformly over the sphere."""
        self.emitters.append(dict(type=em_mod.CONSTANT,
                                  radiance=tuple(radiance)))
        return len(self.emitters) - 1

    def add_envmap(self, image, to_world=None, scale: float = 1.0) -> int:
        """A lat-long environment map (envmap.cpp), importance-sampled by
        texel luminance times sin(theta) through an alias table."""
        self.emitters.append(dict(
            type=em_mod.ENVMAP, radiance=(1.0, 1.0, 1.0),
            env_map=np.asarray(image, np.float32),
            env_to_world=(np.eye(3) if to_world is None
                          else np.asarray(to_world)),
            env_scale=float(scale)))
        return len(self.emitters) - 1

    def build(self, device=None):
        """Compile to (Scene, SceneStatic) on ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        if not self.mats:
            self.add_material()
        T = sum(len(mesh.faces) for mesh in self.meshes)
        # the last environment emitter is the scene's (scene.py:1369-1372)
        env_index = max((i for i, e in enumerate(self.emitters)
                         if e["type"] in (em_mod.CONSTANT, em_mod.ENVMAP)),
                        default=-1)
        envmap_index = max((i for i, e in enumerate(self.emitters)
                            if e["type"] == em_mod.ENVMAP), default=-1)
        use_bvh = T > BRUTE_FORCE_MAX_TRIS
        mats = self.mats
        # the static facts of the materials (scene.py:1620-1642)
        facts = dict(
            bsdf_types=tuple(sorted({mm["type"] for mm in mats})),
            has_textures=any(mm["albedo_tex"] >= 0 or mm["opacity_tex"] >= 0
                             or mm["weight_tex"] >= 0 for mm in mats),
            has_opacity_tex=any(mm["opacity_tex"] >= 0 for mm in mats),
            has_weight_tex=any(mm["weight_tex"] >= 0 for mm in mats),
            nested_bsdf_types=tuple(sorted({
                mats[mm[key]]["type"] for mm in mats
                for key in ("nested_a", "nested_b") if mm[key] >= 0})),
            has_normal_maps=any(mm["normal_tex"] >= 0 or mm["bump_tex"] >= 0
                                for mm in mats),
            medium_types=tuple(sorted({mm["type"] for mm in self.media})),
            phase_types=tuple(sorted({mm["phase_type"]
                                      for mm in self.media})),
            has_boundary_media=any(mm["interior_medium"] >= 0
                                   or mm["exterior_medium"] >= 0
                                   for mm in mats),
            has_sss=any(mm["subsurface"] >= 0 for mm in mats),
            has_singlescatter=any(
                mm["subsurface"] >= 0
                and self.subsurfaces[mm["subsurface"]]["mode"]
                == sss_mod.MODE_SINGLESCATTER for mm in mats),
        )
        emitter_types = tuple(sorted({e["type"] for e in self.emitters}))
        check_supported(dict(n_tris=T, use_bvh=use_bvh,
                             emitter_types=emitter_types, **facts))

        P0, E1, E2, N0, N1, N2, UV0, UV1, UV2, GN, MAT, EM, AREA_ = (
            [], [], [], [], [], [], [], [], [], [], [], [], []
        )
        for mesh in self.meshes:
            v, f = mesh.verts, mesh.faces
            p0 = v[f[:, 0]]
            p1 = v[f[:, 1]]
            p2 = v[f[:, 2]]
            e1 = p1 - p0
            e2 = p2 - p0
            gn = np.cross(e1, e2)
            area2 = np.linalg.norm(gn, axis=1)
            area = 0.5 * area2
            gn = gn / np.maximum(area2[:, None], 1e-20)
            if mesh.normals is not None:
                n = np.asarray(mesh.normals, dtype=np.float64)
                n0, n1, n2 = n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]
            else:
                n0 = n1 = n2 = gn
            if mesh.uvs is not None:
                uv = np.asarray(mesh.uvs, dtype=np.float64)
                uv0, uv1, uv2 = uv[f[:, 0]], uv[f[:, 1]], uv[f[:, 2]]
            else:
                uv0 = uv1 = uv2 = np.zeros((len(f), 2))
            P0.append(p0); E1.append(e1); E2.append(e2)
            N0.append(n0); N1.append(n1); N2.append(n2)
            UV0.append(uv0); UV1.append(uv1); UV2.append(uv2)
            GN.append(gn)
            MAT.append(np.full(len(f), mesh.mat, np.int32))
            EM.append(np.full(len(f), mesh.emitter, np.int32))
            AREA_.append(area)
        if T == 0:
            # one degenerate placeholder row (scene.py:1340-1346): the
            # gathers of a triangle-free scene read it
            e1 = np.zeros((1, 3))
            e1[0, 0] = 1e-9
            e2 = np.zeros((1, 3))
            e2[0, 1] = 1e-9
            z = np.array([[0, 0, 1.0]])
            P0, E1, E2, N0, N1, N2, GN = ([np.zeros((1, 3))], [e1], [e2], [z],
                                          [z], [z], [z])
            UV0 = UV1 = UV2 = [np.zeros((1, 2))]
            MAT, EM = [np.zeros(1, np.int32)], [np.full(1, -1, np.int32)]
            AREA_ = [np.zeros(1)]
        cat = np.concatenate
        tp0, te1, te2 = cat(P0), cat(E1), cat(E2)
        tem = cat(EM)
        tarea = cat(AREA_)

        # emitter table + NEE pdfs (scene.py:1347-1400)
        E = max(len(self.emitters), 1)
        etype = np.zeros(E, np.int32)
        erad = np.zeros((E, 3), np.float32)
        epos = np.zeros((E, 3), np.float32)
        edir = np.tile(np.array([[0, 0, -1.0]], np.float32), (E, 1))
        espot = np.tile(np.array([[0.0, 1.0]], np.float32), (E, 1))
        edelta = np.zeros(E, bool)
        for i, e in enumerate(self.emitters):
            etype[i] = e["type"]
            erad[i] = np.asarray(e["radiance"], np.float32)
            if "position" in e:
                epos[i] = e["position"]
            if "direction" in e:
                edir[i] = e["direction"]
            if "spot_cos" in e:
                espot[i] = e["spot_cos"]
            edelta[i] = e["type"] in em_mod.DELTA_TYPES
        n_emitters = len(self.emitters)
        pmf = np.full(E, 1.0 / max(n_emitters, 1), np.float32)
        if n_emitters == 0:
            pmf[:] = 0.0
        cdf = np.cumsum(pmf).astype(np.float32)
        if n_emitters:
            cdf[-1] = 1.0

        # emissive triangles, grouped by emitter, area-weighted local cdf
        etri_tri_l, etri_cdf_l = [], []
        tri_nee = np.zeros(max(T, 1), np.float32)
        for i, e in enumerate(self.emitters):
            if e["type"] != em_mod.AREA:
                continue
            sel = np.nonzero(tem == i)[0]
            if len(sel) == 0:
                continue
            a = tarea[sel]
            local_pmf = a / a.sum()
            local_cdf = np.cumsum(local_pmf)
            local_cdf[-1] = 1.0
            etri_tri_l.extend(sel.tolist())
            etri_cdf_l.extend((i + local_cdf).tolist())
            # dense per-triangle NEE area pdf (folds the emitter pmf in)
            tri_nee[sel] = pmf[i] * local_pmf / np.maximum(a, 1e-20)
        etri_tri = np.asarray(etri_tri_l or [0], np.int32)
        etri_cdf = np.asarray(etri_cdf_l or [np.inf], np.float32)
        env = (_build_envmap(self.emitters[envmap_index]) if envmap_index >= 0
               else _empty_env())

        # the rough-transmittance bake (scene.py:1427-1441): T(cos) and
        # the internal diffuse reflectance (through 1/eta, from the dense
        # side) of each ROUGH_PLASTIC and ROUGHCOATING row, in float64,
        # cast to float32; zeros elsewhere
        Mn = len(self.mats)
        rt_coef = np.zeros((Mn, rtrans.RT_DEG), np.float32)
        rt_fdr = np.zeros(Mn, np.float32)
        for i, mm in enumerate(self.mats):
            if mm["type"] in (bsdf_mod.ROUGH_PLASTIC, bsdf_mod.ROUGHCOATING):
                a, e, d = (float(mm["alpha"][0]), float(mm["eta"][0]),
                           int(mm["dist"]))
                rt_coef[i], _ = rtrans.fit_poly(d, a, e)
                rt_fdr[i] = 1.0 - rtrans.diffuse_transmittance(d, a, 1.0 / e)

        # spheres (scene.py:1480-1490), one placeholder row without them
        S = len(self.spheres)
        if S:
            sc = np.stack([sp[0] for sp in self.spheres]).astype(np.float32)
            sr = np.array([sp[1] for sp in self.spheres], np.float32)
            sm = np.array([sp[2] for sp in self.spheres], np.int32)
            se = np.array([sp[3] for sp in self.spheres], np.int32)
        else:
            sc, sr = np.zeros((1, 3), np.float32), np.zeros(1, np.float32)
            sm, se = np.zeros(1, np.int32), np.full(1, -1, np.int32)

        # BVH over the triangles' float64 bounds and its treelet cut
        # (scene.py:1495-1536)
        lo, hi = triangle_aabbs(tp0, tp0 + te1, tp0 + te2)
        nodes = np.zeros((1, cuda_bvh.NODE_COLS), np.float32)
        n_bvh_nodes = 0
        tl_root, tl_skip = np.zeros(1, np.int32), np.ones(1, np.int32)
        tl_lo = tl_hi = np.zeros((1, 3), np.float32)
        octants = None
        if use_bvh:
            host_bvh = build_bvh(lo, hi)
            nodes = cuda_bvh.pack_nodes(host_bvh, tp0.astype(np.float32),
                                        te1.astype(np.float32),
                                        te2.astype(np.float32))
            n_bvh_nodes = len(host_bvh.lo)
            tl_root = treelet_roots(host_bvh, max_nodes=TREELET_MAX_NODES)
            tl_skip = host_bvh.skip[tl_root].astype(np.int32)
            tl_lo, tl_hi = host_bvh.lo[tl_root], host_bvh.hi[tl_root]
            octants = cuda_bvh.octant_tables(nodes, tl_root, dev)
        if T > 0:
            man_tri, n_man = manifold_rows(
                tp0, te1, te2, cat(N0), cat(N1), cat(N2), cat(MAT),
                [mm["type"] for mm in mats], [mm["eta"][0] for mm in mats])
        else:
            man_tri, n_man = np.zeros((1, 19), np.float32), 0
        if T > 0:
            scene_lo, scene_hi = lo.min(axis=0), hi.max(axis=0)
        else:
            scene_lo, scene_hi = np.zeros(3), np.ones(3)
        if S:
            scene_lo = np.minimum(scene_lo, (sc - sr[:, None]).min(axis=0))
            scene_hi = np.maximum(scene_hi, (sc + sr[:, None]).max(axis=0))
        radius = 0.5 * float(np.linalg.norm(scene_hi - scene_lo)) + 1e-3

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        scene = Scene(
            tri_p0=f32(tp0), tri_e1=f32(te1), tri_e2=f32(te2),
            tri_n0=f32(cat(N0)), tri_n1=f32(cat(N1)), tri_n2=f32(cat(N2)),
            tri_uv0=f32(cat(UV0)), tri_uv1=f32(cat(UV1)), tri_uv2=f32(cat(UV2)),
            tri_gn=f32(cat(GN)), tri_mat=i32(cat(MAT)), tri_emitter=i32(tem),
            tri_nee_pdf_area=f32(tri_nee),
            sph_center=f32(sc), sph_radius=f32(sr), sph_mat=i32(sm),
            sph_emitter=i32(se),
            nodes=f32(nodes), tl_root=i32(tl_root), tl_skip=i32(tl_skip),
            tl_lo=f32(tl_lo), tl_hi=f32(tl_hi), octants=octants,
            aabb_lo=f32(scene_lo), aabb_hi=f32(scene_hi),
            radius=f32(radius),
            materials=bsdf_mod.MaterialTable(
                type=i32([mm["type"] for mm in self.mats]),
                dist=i32([mm["dist"] for mm in self.mats]),
                albedo=f32([mm["albedo"] for mm in self.mats]),
                albedo_tex=i32([mm["albedo_tex"] for mm in self.mats]),
                spec_refl=f32([mm["spec_refl"] for mm in self.mats]),
                spec_trans=f32([mm["spec_trans"] for mm in self.mats]),
                eta=f32([mm["eta"] for mm in self.mats]),
                k=f32([mm["k"] for mm in self.mats]),
                alpha=f32([mm["alpha"] for mm in self.mats]),
                twosided=torch.as_tensor(
                    np.asarray([mm["twosided"] for mm in self.mats], bool),
                    device=dev),
                nonlinear=torch.as_tensor(
                    np.asarray([mm["nonlinear"] for mm in self.mats], bool),
                    device=dev),
                rt_coef=f32(rt_coef), rt_fdr=f32(rt_fdr),
                hk_thickness=f32([mm["hk_thickness"] for mm in self.mats]),
                hk_g=f32([mm["hk_g"] for mm in self.mats]),
                **{k: i32([mm[k] for mm in self.mats]) for k in (
                    "opacity_tex", "nested_a", "nested_b", "weight_tex",
                    "normal_tex", "bump_tex")},
                weight=f32([mm["weight"] for mm in self.mats]),
                bump_scale=f32([mm["bump_scale"] for mm in self.mats]),
                cauchy_b=f32([mm["cauchy_b"] for mm in self.mats]),
                irawan=i32([mm["irawan"] for mm in self.mats]),
                interior_medium=i32([mm["interior_medium"]
                                     for mm in self.mats]),
                exterior_medium=i32([mm["exterior_medium"]
                                     for mm in self.mats]),
            ),
            textures=tex_mod.build_table(self.textures, self.bitmaps, dev),
            emitters=em_mod.EmitterTable(
                type=i32(etype), radiance=f32(erad), position=f32(epos),
                direction=f32(edir), spot_cos=f32(espot),
                delta=torch.as_tensor(edelta, device=dev), pmf=f32(pmf),
                cdf=f32(cdf), etri_tri=i32(etri_tri), etri_cdf=f32(etri_cdf),
                env_index=i32(env_index), env_map=f32(env["env_map"]),
                env_alias=f32(env["env_alias"]), env_hw=i32(env["env_hw"]),
                env_to_world=f32(env["env_to_world"]),
                env_scale=f32(env["env_scale"]),
            ),
            irawan=irawan_mod.build_table([p for p, _ in self.irawan],
                                          [r for _, r in self.irawan], dev),
            media=self._build_media(dev),
            sss=self._build_sss(dev),
            man_tri=f32(man_tri),
        )
        static = SceneStatic(
            n_tris=T, n_spheres=S, use_bvh=use_bvh,
            emitter_types=emitter_types, has_env=env_index >= 0,
            n_bvh_nodes=n_bvh_nodes, n_manifold_tris=n_man, **facts)
        return scene, static


def _empty_env():
    """The env fields of a scene without an environment map."""
    return dict(env_map=np.asarray([[0.0, 0.0, 0.0, 1.0 / (4.0 * np.pi)]]),
                env_alias=np.asarray([[1.0, 0.0]]), env_hw=np.ones(2),
                env_to_world=np.eye(3), env_scale=np.ones(()))


def _build_envmap(e: dict):
    """Radiance + solid-angle pdf table and the texel alias table of a
    lat-long map (envmap.cpp:99-299 importance sampling)."""
    img = np.asarray(e["env_map"], np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    H, W = img.shape[:2]
    lum = img[..., 0] * 0.212671 + img[..., 1] * 0.715160 + img[..., 2] * 0.072169
    theta = (np.arange(H) + 0.5) / H * np.pi
    sin_t = np.sin(theta)
    w = lum * sin_t[:, None] + 1e-12
    # solid-angle pdf: p(texel) / texel_solid_angle
    p_texel = w / w.sum()
    texel_sa = (2 * np.pi / W) * (np.pi / H) * sin_t[:, None]
    pdf = p_texel / np.maximum(texel_sa, 1e-12)
    rad_pdf = np.concatenate(
        [img.reshape(-1, 3), pdf.reshape(-1, 1)], axis=1)
    prob, alias = _build_alias(p_texel.reshape(-1))
    return dict(
        env_map=np.ascontiguousarray(rad_pdf, np.float32),
        env_alias=np.ascontiguousarray(
            np.stack([prob, alias.astype(np.float32)], axis=1), np.float32),
        env_hw=np.asarray([H, W], np.int32),
        env_to_world=np.asarray(e.get("env_to_world", np.eye(3)), np.float32),
        env_scale=np.asarray(e.get("env_scale", 1.0), np.float32),
    )


def _build_alias(p):
    """Walker/Vose alias table for pmf p (N,): returns (prob, alias)."""
    N = len(p)
    p = np.asarray(p, np.float64)
    p = p / p.sum()
    scaled = p * N
    prob = np.ones(N)
    alias = np.arange(N, dtype=np.int64)
    small = [i for i in range(N) if scaled[i] < 1.0]
    large = [i for i in range(N) if scaled[i] >= 1.0]
    while small and large:
        s_ = small.pop()
        l_ = large.pop()
        prob[s_] = scaled[s_]
        alias[s_] = l_
        scaled[l_] = scaled[l_] - (1.0 - scaled[s_])
        (small if scaled[l_] < 1.0 else large).append(l_)
    return prob.astype(np.float32), alias
