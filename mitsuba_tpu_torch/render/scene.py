"""Scene container, device queries and the host-side builder (port of
``mitsuba_tpu/render/scene.py``, the subset the Cornell box and the bunny_x2
scene use).

The scene compiles on the host into flat tensors: a triangle soup with
per-triangle shading attributes and NEE area pdfs, a threaded BVH packed for
the lane kernels, a material table, a bitmap texture table and an emitter
table. ``SceneStatic`` holds the facts the code branches on.

Scenes of at most ``BRUTE_FORCE_MAX_TRIS`` triangles send their queries to
the brute-force kernels of ``ops/cuda_intersect``; larger ones build a
leaf_size=1 BVH, cut it into treelets, and send them to the lane kernels of
``ops/cuda_bvh``, or with ``MTS_BVH_KERNEL=treelet`` to the treelet kernel
K7, with the JAX package's dispatch. Materials are diffuse, with an optional
bitmap albedo, or rough conductors; lights are triangle area lights, a
constant environment and a lat-long environment map; meshes may be
instanced. Anything else (spheres, other textures and
lights, media, other BSDFs) raises ``NotImplementedError``: it lands in a
later slice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel.build import build_bvh, treelet_roots, triangle_aabbs
from ..core import math as m
from ..core.frame import Frame
from ..core.transform import Transform
from ..device import resolve_device
from ..ops import cuda_bvh
from ..ops import cuda_intersect as bf
from . import bsdf as bsdf_mod
from . import emitter as em_mod
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


@dataclass(frozen=True)
class SceneStatic:
    """Hashable facts about a scene (the fields this slice branches on)."""

    n_tris: int
    n_spheres: int
    use_bvh: bool
    bsdf_types: tuple          # sorted tuple of bsdf type tags present
    emitter_types: tuple       # sorted tuple of emitter type tags present
    has_env: bool
    has_textures: bool = False
    n_bvh_nodes: int = 0       # node count of the BVH (0 without one)


# SceneStatic fields of the JAX package whose non-default values need code
# that lands in a later slice, with the value the port supports
_LATER_SLICE_FIELDS = {
    "n_spheres": 0, "has_opacity_tex": False, "has_weight_tex": False,
    "medium_types": (), "phase_types": (), "nested_bsdf_types": (),
    "has_normal_maps": False, "has_sss": False, "has_singlescatter": False,
    "has_boundary_media": False, "ewa_taps": 0, "n_manifold_tris": 0,
}


def check_supported(static: dict) -> None:
    """Raise NotImplementedError unless the scene described by ``static``
    (SceneStatic fields by name) is one the port renders."""
    T = static["n_tris"]
    if T <= 0:
        raise NotImplementedError(
            "scenes without triangles land in a later slice of the port")
    if bool(static["use_bvh"]) != (T > BRUTE_FORCE_MAX_TRIS):
        raise ValueError(
            f"use_bvh={static['use_bvh']} for {T} triangles: the builder "
            f"uses a BVH exactly above {BRUTE_FORCE_MAX_TRIS} triangles")
    for key, ok in _LATER_SLICE_FIELDS.items():
        if key in static and static[key] != ok and not (
                isinstance(ok, tuple) and tuple(static[key]) == ok):
            raise NotImplementedError(
                f"{key}={static[key]!r} lands in a later slice of the port")
    for t in static["bsdf_types"]:
        if t not in bsdf_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {t} lands in a later slice of the port")
    for t in static["emitter_types"]:
        if t not in em_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"emitter type {t} lands in a later slice of the port")


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


def ray_intersect(scene: Scene, static: SceneStatic, o, d, t_min, t_max,
                  active=None, presorted: bool = False) -> Interaction:
    """Closest hit + surface interaction record (Scene::rayIntersect +
    fillIntersectionRecord): through the K1 brute-force kernel on small
    scenes, else through the BVH kernels and a gather of the hit triangle's
    record. ``presorted`` says the rays are coherent already (primary rays
    in raster order), so the BVH query skips its sort.

    ``o`` and ``d`` are detached on entry, as on the JAX package's TPU path
    (scene.py:202-203, 243-244): the kernels carry no gradient, so the hit
    record (p, wi, uv, ...) is a constant of the scene's parameters, on the
    CPU as on the card (the detached-sampling estimator)."""
    o, d = o.detach(), d.detach()
    t_min, t_max = _ray_range(o, t_min, t_max, active)
    if static.use_bvh:
        hit_t, tri_t, tri_idx, tri_u, tri_v = _bvh_query(
            scene, static, o, d, t_min, t_max, presorted, any_hit=False)
        ti = torch.clamp(tri_idx, min=0).to(torch.int64)
        b1, b2 = tri_u[..., None], tri_v[..., None]
        b0 = 1.0 - b1 - b2
        n_sh_raw = (b0 * scene.tri_n0[ti] + b1 * scene.tri_n1[ti]
                    + b2 * scene.tri_n2[ti])
        uv = (b0 * scene.tri_uv0[ti] + b1 * scene.tri_uv1[ti]
              + b2 * scene.tri_uv2[ti])
        gn = scene.tri_gn[ti]
        mat_id = scene.tri_mat[ti]
        em_id = scene.tri_emitter[ti]
        nee_tri = scene.tri_nee_pdf_area[ti]
    else:
        (hit_t, tri_t, tri_idx, tri_u, tri_v, n_sh_raw, gn, uv, mat_id, em_id,
         nee_tri) = bf.brute_force_interaction(
            scene.tri_p0, scene.tri_e1, scene.tri_e2,
            scene.tri_n0, scene.tri_n1, scene.tri_n2,
            scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
            scene.tri_gn, scene.tri_mat, scene.tri_emitter,
            scene.tri_nee_pdf_area, o, d, t_min, t_max,
        )
    n_sh = m.normalize(n_sh_raw)
    valid = hit_t
    # sanitized position for missed lanes: inf positions would poison
    # downstream NEE math
    t_safe = torch.where(valid, tri_t, 1.0)
    p = o + t_safe[..., None] * d
    nee_pdf = torch.where(hit_t, nee_tri, 0.0)

    frame = Frame.from_normal(n_sh)
    wi_world = -d
    wi_local = frame.to_local(wi_world)
    return Interaction(
        valid=valid,
        t=torch.where(valid, tri_t, torch.inf),
        p=p,
        gn=gn,
        sh_frame=frame,
        uv=uv,
        wi=wi_local,
        wi_world=wi_world,
        mat_id=torch.where(valid, mat_id, -1),
        emitter_id=torch.where(valid, em_id, -1),
        prim_id=torch.where(valid, tri_idx, -1),
        nee_pdf_area=nee_pdf,
        bary=torch.stack([tri_u, tri_v], dim=-1),
    )


def occluded(scene: Scene, static: SceneStatic, o, d, t_min, t_max,
             active=None, presorted: bool = False):
    """Boolean shadow-ray query: the K2 brute-force kernel on small scenes,
    else an any-hit BVH query; ``o`` and ``d`` detached as in
    ``ray_intersect``."""
    o, d = o.detach(), d.detach()
    t_min, t_max = _ray_range(o, t_min, t_max, active)
    if static.use_bvh:
        return _bvh_query(scene, static, o, d, t_min, t_max, presorted,
                          any_hit=True)[0]
    h, _, _, _, _ = bf.brute_force_closest_hit(
        scene.tri_p0, scene.tri_e1, scene.tri_e2, o, d, t_min, t_max)
    return h


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
    """Per-lane BSDF parameters at the hits, with the textured albedo.
    ``fp_uv`` is the ray-cone footprint that selects the MIP level."""
    return bsdf_mod.gather_locals(
        scene.materials, its.mat_id,
        albedo_override=eval_albedo(scene, its, static, fp_uv=fp_uv))


def emitted_radiance(scene: Scene, static: SceneStatic, its: Interaction, d):
    """Radiance emitted by a hit surface toward -d (AreaEmitter::eval: only
    the front side emits)."""
    has = its.emitter_id >= 0
    e = torch.clamp(its.emitter_id, min=0).to(torch.int64)
    front = m.dot(its.gn, -d) > 0
    rad = scene.emitters.radiance[e]
    return torch.where((has & front)[..., None], rad, 0.0)


def pdf_emitter_hit(scene: Scene, its: Interaction, ref_p):
    """Solid-angle NEE pdf of the point a BSDF-sampled ray hit
    (Scene::pdfEmitterDirect), from the per-triangle area pdf on the record."""
    pdf_area = its.nee_pdf_area
    to_hit = its.p - ref_p
    d2 = m.squared_length(to_hit)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    cos_l = torch.abs(m.dot(its.gn, -to_hit / dist[..., None]))
    return m.safe_div(pdf_area * d2, torch.clamp(cos_l, min=1e-7))


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

    def add_material(self, type: int = bsdf_mod.DIFFUSE,
                     albedo=(0.5, 0.5, 0.5), albedo_tex: int = -1,
                     spec_refl=(1.0, 1.0, 1.0), eta=(1.5046, 1.5046, 1.5046),
                     k=(0.0, 0.0, 0.0), alpha=(0.1, 0.1), alpha_tex: int = -1,
                     dist: int = 0, twosided: bool = False) -> int:
        """A material row with the JAX package's keywords and defaults
        (scene.py:819-848) for the columns the port reads; a scalar
        ``eta`` or ``alpha`` is replicated."""
        if type not in bsdf_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {type} lands in a later slice of the port")
        if alpha_tex >= 0:
            raise NotImplementedError(
                "roughness textures land in a later slice of the port")
        if np.isscalar(eta):
            eta = (float(eta),) * 3
        if np.isscalar(alpha):
            alpha = (float(alpha),) * 2
        self.mats.append(dict(type=type, albedo=tuple(albedo),
                              albedo_tex=albedo_tex, spec_refl=tuple(spec_refl),
                              eta=tuple(eta), k=tuple(k), alpha=tuple(alpha),
                              dist=dist, twosided=twosided))
        return len(self.mats) - 1

    def add_texture_bitmap(self, image, uv_scale=(1.0, 1.0),
                           uv_offset=(0.0, 0.0), scale=(1.0, 1.0, 1.0)) -> int:
        """A bitmap texture (bitmap.cpp) from an (H, W, 3) or (H, W) image;
        repeat wrapping, MIP chain built at ``build``."""
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        self.bitmaps.append(img)
        self.textures.append(dict(
            type=tex_mod.TEX_BITMAP, uv_scale=tuple(uv_scale),
            uv_offset=tuple(uv_offset), scale=tuple(scale),
            bitmap=len(self.bitmaps) - 1))
        return len(self.textures) - 1

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
        check_supported(dict(
            n_tris=T, use_bvh=use_bvh,
            bsdf_types=tuple(sorted({mm["type"] for mm in self.mats})),
            emitter_types=tuple(sorted({e["type"] for e in self.emitters}))))

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
        cat = np.concatenate
        tp0, te1, te2 = cat(P0), cat(E1), cat(E2)
        tem = cat(EM)
        tarea = cat(AREA_)

        # emitter table + NEE pdfs (scene.py:1347-1400)
        E = max(len(self.emitters), 1)
        etype = np.zeros(E, np.int32)
        erad = np.zeros((E, 3), np.float32)
        for i, e in enumerate(self.emitters):
            etype[i] = e["type"]
            erad[i] = np.asarray(e["radiance"], np.float32)
        n_emitters = len(self.emitters)
        pmf = np.full(E, 1.0 / max(n_emitters, 1), np.float32)
        if n_emitters == 0:
            pmf[:] = 0.0
        cdf = np.cumsum(pmf).astype(np.float32)
        if n_emitters:
            cdf[-1] = 1.0

        # emissive triangles, grouped by emitter, area-weighted local cdf
        etri_tri_l, etri_cdf_l = [], []
        tri_nee = np.zeros(T, np.float32)
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
        scene_lo, scene_hi = lo.min(axis=0), hi.max(axis=0)
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
                eta=f32([mm["eta"] for mm in self.mats]),
                k=f32([mm["k"] for mm in self.mats]),
                alpha=f32([mm["alpha"] for mm in self.mats]),
                twosided=torch.as_tensor(
                    np.asarray([mm["twosided"] for mm in self.mats], bool),
                    device=dev),
            ),
            textures=tex_mod.build_table(self.textures, self.bitmaps, dev),
            emitters=em_mod.EmitterTable(
                type=i32(etype), radiance=f32(erad), pmf=f32(pmf),
                cdf=f32(cdf), etri_tri=i32(etri_tri), etri_cdf=f32(etri_cdf),
                env_index=i32(env_index), env_map=f32(env["env_map"]),
                env_alias=f32(env["env_alias"]), env_hw=i32(env["env_hw"]),
                env_to_world=f32(env["env_to_world"]),
                env_scale=f32(env["env_scale"]),
            ),
        )
        static = SceneStatic(
            n_tris=T, n_spheres=0, use_bvh=use_bvh,
            bsdf_types=tuple(sorted({mm["type"] for mm in self.mats})),
            emitter_types=tuple(sorted({e["type"] for e in self.emitters})),
            has_env=env_index >= 0,
            has_textures=any(mm["albedo_tex"] >= 0 for mm in self.mats),
            n_bvh_nodes=n_bvh_nodes,
        )
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
