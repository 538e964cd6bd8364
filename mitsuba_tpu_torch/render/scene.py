"""Scene container, device queries and the host-side builder (port of
``mitsuba_tpu/render/scene.py``, the subset the Cornell box uses).

The scene compiles on the host into flat tensors: a triangle soup with
per-triangle shading attributes and NEE area pdfs, a material table and an
emitter table. ``SceneStatic`` holds the facts the code branches on.

This slice covers scenes of at most ``BRUTE_FORCE_MAX_TRIS`` triangles, whose
queries go to the brute-force kernels of ``ops/cuda_intersect``, with diffuse
materials and triangle area lights. Anything else (the BVH, spheres,
textures, environment and other lights, media, other BSDFs) raises
``NotImplementedError``: it lands in a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import math as m
from ..core.frame import Frame
from ..device import resolve_device
from ..ops import cuda_intersect as bf
from . import bsdf as bsdf_mod
from . import emitter as em_mod
from .records import Interaction

# above this triangle count the JAX package builds a BVH (scene.py:37)
BRUTE_FORCE_MAX_TRIS = 512


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
    materials: bsdf_mod.MaterialTable
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


# SceneStatic fields of the JAX package whose non-default values need code
# that lands in a later slice, with the value this slice supports
_LATER_SLICE_FIELDS = {
    "n_spheres": 0, "use_bvh": False, "has_env": False, "has_textures": False,
    "has_opacity_tex": False, "has_weight_tex": False, "medium_types": (),
    "phase_types": (), "nested_bsdf_types": (), "has_normal_maps": False,
    "has_sss": False, "has_singlescatter": False, "has_boundary_media": False,
    "ewa_taps": 0, "n_bvh_nodes": 0, "n_manifold_tris": 0,
}


def check_supported(static: dict) -> None:
    """Raise NotImplementedError unless the scene described by ``static``
    (SceneStatic fields by name) is one this slice renders."""
    T = static["n_tris"]
    if not 0 < T <= BRUTE_FORCE_MAX_TRIS:
        raise NotImplementedError(
            f"{T} triangles: scenes outside 1..{BRUTE_FORCE_MAX_TRIS} "
            "triangles (the BVH path) land in a later slice of the port")
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


def ray_intersect(scene: Scene, static: SceneStatic, o, d, t_min, t_max,
                  active=None) -> Interaction:
    """Closest hit + surface interaction record (Scene::rayIntersect +
    fillIntersectionRecord) through the K1 brute-force kernel."""
    t_min, t_max = _ray_range(o, t_min, t_max, active)
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
             active=None):
    """Boolean shadow-ray query through the K2 brute-force kernel."""
    t_min, t_max = _ray_range(o, t_min, t_max, active)
    h, _, _, _, _ = bf.brute_force_closest_hit(
        scene.tri_p0, scene.tri_e1, scene.tri_e2, o, d, t_min, t_max)
    return h


def bsdf_locals(scene: Scene, its: Interaction,
                static: SceneStatic) -> bsdf_mod.BsdfLocals:
    """Per-lane BSDF parameters at the hits (untextured materials)."""
    if static.has_textures:
        raise NotImplementedError("textures land in a later slice of the port")
    return bsdf_mod.gather_locals(scene.materials, its.mat_id)


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
    cast to float32 at the end), so the two builders give the same tables.
    """

    meshes: list = field(default_factory=list)
    mats: list = field(default_factory=list)
    emitters: list = field(default_factory=list)

    def add_material(self, type: int = bsdf_mod.DIFFUSE,
                     albedo=(0.5, 0.5, 0.5), twosided: bool = False) -> int:
        if type not in bsdf_mod.SUPPORTED_TYPES:
            raise NotImplementedError(
                f"BSDF type {type} lands in a later slice of the port")
        self.mats.append(dict(type=type, albedo=tuple(albedo),
                              twosided=twosided))
        return len(self.mats) - 1

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

    def build(self, device=None):
        """Compile to (Scene, SceneStatic) on ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        if not self.mats:
            self.add_material()
        T = sum(len(mesh.faces) for mesh in self.meshes)
        static = SceneStatic(
            n_tris=T, n_spheres=0, use_bvh=T > BRUTE_FORCE_MAX_TRIS,
            bsdf_types=tuple(sorted({mm["type"] for mm in self.mats})),
            emitter_types=tuple(sorted({e["type"] for e in self.emitters})),
            has_env=False,
        )
        check_supported(vars(static))

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
        tem = np.concatenate(EM)
        tarea = np.concatenate(AREA_)

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

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        cat = np.concatenate
        scene = Scene(
            tri_p0=f32(cat(P0)), tri_e1=f32(cat(E1)), tri_e2=f32(cat(E2)),
            tri_n0=f32(cat(N0)), tri_n1=f32(cat(N1)), tri_n2=f32(cat(N2)),
            tri_uv0=f32(cat(UV0)), tri_uv1=f32(cat(UV1)), tri_uv2=f32(cat(UV2)),
            tri_gn=f32(cat(GN)), tri_mat=i32(cat(MAT)), tri_emitter=i32(tem),
            tri_nee_pdf_area=f32(tri_nee),
            materials=bsdf_mod.MaterialTable(
                type=i32([mm["type"] for mm in self.mats]),
                albedo=f32([mm["albedo"] for mm in self.mats]),
                twosided=torch.as_tensor(
                    np.asarray([mm["twosided"] for mm in self.mats], bool),
                    device=dev),
            ),
            emitters=em_mod.EmitterTable(
                type=i32(etype), radiance=f32(erad), pmf=f32(pmf),
                cdf=f32(cdf), etri_tri=i32(etri_tri), etri_cdf=f32(etri_cdf),
            ),
        )
        return scene, static
