"""Carry a scene and a camera across from the JAX package.

Here the "weights" are the scene and the camera. The caller flattens the JAX
package's ``Scene``/``SceneStatic``/``Sensor`` into plain numpy arrays and
dicts by field name (nested tables as nested dicts); these functions build the
port's tensors from them, the BVH included. Every float is cast to float32
and every index to int32, so no float64 from the host tables leaks into the
port. Nothing here imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import cuda_bvh
from .render import bsdf as bsdf_mod
from .render import emitter as em_mod
from .render import irawan as irawan_mod
from .render import scene as scene_mod
from .render import sensor as sensor_mod
from .render import texture as tex_mod

_TRI_FLOAT = ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_gn", "tri_nee_pdf_area")
_TRI_INT = ("tri_mat", "tri_emitter")
_SPH_FLOAT = ("sph_center", "sph_radius")
_SPH_INT = ("sph_mat", "sph_emitter")
_MAT_FLOAT = ("spec_refl", "spec_trans", "eta", "k", "alpha", "rt_coef",
              "rt_fdr", "hk_thickness", "hk_g", "weight", "bump_scale",
              "cauchy_b")
_MAT_INT = ("type", "dist", "albedo_tex", "opacity_tex", "nested_a",
            "nested_b", "weight_tex", "normal_tex", "bump_tex", "irawan")
_IRAWAN_INT = ("pattern", "tile_w", "tile_h")
_TEX_PROCEDURAL = ("color0", "color1", "line_width")
_ENV_FLOAT = ("env_map", "env_alias", "env_to_world", "env_scale")
_TEX_FLOAT = ("uv_scale", "uv_offset", "scale", "stack", "mips")
_TEX_INT = ("type", "bitmap_idx", "stack_hw", "sizes", "mips_hw")
_TL_INT = ("tl_root", "tl_skip")
_TL_FLOAT = ("tl_lo", "tl_hi")
# rows per page of the JAX package's page-planar BVH table (pack_pages)
_PAGE, _PCOMP = 128, 11
# the JAX slim layout (pack_nodes_slim): four 32-float node slots per row
_SLIM_SLOT = 32
# the JAX fat rows (pallas_bvh.py:56-61): lo, hi, skip, count, then per
# triangle slot p0, e1, e2, id
_FAT_ROW, _FAT_TRI = 64, 10


def _f32(x, dev):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)


def _i32(x, dev):
    return torch.as_tensor(np.array(x, dtype=np.int32), device=dev)


def _bool(x, dev):
    return torch.as_tensor(np.array(x, dtype=bool), device=dev)


def nodes_from_pages(pages, n_nodes: int) -> np.ndarray:
    """The port's (n_nodes, 12) node table from the JAX package's
    page-planar ``(n_pages * 11, 128)`` table (``pack_pages``): page p's row
    c holds component c of nodes [128 p, 128 (p + 1)). A reshape and a
    transpose, cut at ``n_nodes``, with the components in the port's column
    order (lo|p0, skip, hi|e1, tri id, e2, 0)."""
    pages = np.asarray(pages, np.float32)
    n_pages = pages.shape[0] // _PCOMP
    if pages.shape != (n_pages * _PCOMP, _PAGE) or n_nodes > n_pages * _PAGE:
        raise ValueError(f"pages of shape {pages.shape} cannot hold "
                         f"{n_nodes} nodes")
    comp = pages.reshape(n_pages, _PCOMP, _PAGE).transpose(0, 2, 1)
    comp = comp.reshape(n_pages * _PAGE, _PCOMP)[:n_nodes]
    nodes = np.zeros((n_nodes, cuda_bvh.NODE_COLS), np.float32)
    nodes[:, :11] = comp[:, [0, 1, 2, 9, 3, 4, 5, 10, 6, 7, 8]]
    return nodes


def nodes_from_slim(rows, n_nodes: int) -> np.ndarray:
    """The port's (n_nodes, 12) node table from the JAX package's slim rows
    ``(ceil(N / 4), 128)`` (``pack_nodes_slim``, which K7 walks there): node
    n's slot is row n // 4, columns 32 (n % 4) + (lo|p0, hi|e1, e2, skip,
    tri id). The same nodes in the same order as ``cuda_bvh.pack_nodes``."""
    rows = np.asarray(rows, np.float32)
    if rows.shape != (-(-n_nodes // 4), 4 * _SLIM_SLOT):
        raise ValueError(f"slim rows of shape {rows.shape} do not hold "
                         f"{n_nodes} nodes")
    slots = rows.reshape(-1, _SLIM_SLOT)[:n_nodes]
    nodes = np.zeros((n_nodes, cuda_bvh.NODE_COLS), np.float32)
    nodes[:, :11] = slots[:, [0, 1, 2, 9, 3, 4, 5, 10, 6, 7, 8]]
    return nodes


def fat_from_rows(rows) -> np.ndarray:
    """The port's (N, 56) fat table (``cuda_bvh.pack_nodes_fat``) from the
    JAX package's (N, 64) fat rows (``pack_nodes``): the same values, moved
    into float4s (lo skip | hi count | per slot p0 id | e1 0 | e2 0)."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[1] != _FAT_ROW:
        raise ValueError(f"fat rows of shape {rows.shape}, expected (N, 64)")
    out = np.zeros((rows.shape[0], cuda_bvh.FAT_COLS), np.float32)
    out[:, 0:3], out[:, 3] = rows[:, 0:3], rows[:, 6]
    out[:, 4:7], out[:, 7] = rows[:, 3:6], rows[:, 7]
    for k in range(cuda_bvh.FAT_LEAF_SIZE):
        src, dst = 8 + _FAT_TRI * k, 8 + 12 * k
        out[:, dst:dst + 3] = rows[:, src:src + 3]
        out[:, dst + 3] = rows[:, src + 9]
        out[:, dst + 4:dst + 7] = rows[:, src + 3:src + 6]
        out[:, dst + 8:dst + 11] = rows[:, src + 6:src + 9]
    return out


def scene_from_arrays(arrays: dict, static: dict, device=None):
    """(Scene, SceneStatic) of the port from the JAX scene's leaves.

    ``arrays`` maps Scene field names to numpy arrays, with ``materials``,
    ``textures``, ``emitters`` and ``irawan`` (the weave patterns, their
    specular normalization included) as dicts of their tables' fields (a
    material's ``alpha_tex``, if given, must be -1 throughout; the
    textures' ``color0``, ``color1`` and ``line_width`` are read where the
    table holds a procedural row);
    ``static`` maps SceneStatic field names to values. The BVH comes across
    as the JAX scene's ``bvh_pages`` (the same tree, repacked by
    ``nodes_from_pages``), with its treelet cut (``tl_root``, ``tl_skip``,
    ``tl_lo``, ``tl_hi``); its octant tables are built from that table, as
    the builder builds them. Raises NotImplementedError for a scene the port
    does not render.
    """
    dev = resolve_device(device)
    scene_mod.check_supported(static)
    T = int(static["n_tris"])
    tri = {k: _f32(arrays[k], dev) for k in _TRI_FLOAT}
    tri.update({k: _i32(arrays[k], dev) for k in _TRI_INT})
    # a triangle-free scene keeps one placeholder row, as in the JAX package
    if tri["tri_p0"].shape != (max(T, 1), 3):
        raise ValueError(f"tri_p0 has shape {tuple(tri['tri_p0'].shape)}, "
                         f"expected ({max(T, 1)}, 3)")
    S = int(static["n_spheres"])
    sph = {k: _f32(arrays[k], dev) for k in _SPH_FLOAT}
    sph.update({k: _i32(arrays[k], dev) for k in _SPH_INT})
    if sph["sph_radius"].shape != (max(S, 1),):
        raise ValueError(f"sph_radius has shape "
                         f"{tuple(sph['sph_radius'].shape)} for {S} spheres")
    use_bvh = bool(static["use_bvh"])
    n_nodes = int(static.get("n_bvh_nodes", 0))
    if use_bvh != (n_nodes > 0):
        raise ValueError(f"use_bvh={use_bvh} with {n_nodes} BVH nodes")
    nodes = (nodes_from_pages(arrays["bvh_pages"], n_nodes) if use_bvh
             else np.zeros((1, cuda_bvh.NODE_COLS), np.float32))
    octants = (cuda_bvh.octant_tables(nodes, arrays["tl_root"], dev)
               if use_bvh else None)
    mats, texs, ems = arrays["materials"], arrays["textures"], arrays["emitters"]
    iw = arrays["irawan"]
    if np.any(np.asarray(mats.get("alpha_tex", -1)) >= 0):
        raise NotImplementedError(
            "roughness textures land in a later slice of the port "
            "(ROADMAP.md, Queue 1 item 3.2.3)")
    has_textures = bool(static.get("has_textures", False))
    has_maps = bool(static.get("has_normal_maps", False))
    tex_types = np.asarray(texs["type"]).ravel()
    if (has_textures or has_maps) and any(
            int(t) not in tex_mod.SUPPORTED_TYPES for t in tex_types):
        raise NotImplementedError(
            "textures other than bitmaps, constants, checkerboards and grids "
            "land in a later slice of the port (ROADMAP.md, Queue 1 item "
            "3.2.3)")
    procedural = ({k: _f32(texs[k], dev) for k in _TEX_PROCEDURAL}
                  if tex_mod.has_procedural(tex_types) else {})
    scene = scene_mod.Scene(
        **tri,
        **sph,
        nodes=_f32(nodes, dev),
        **{k: _i32(arrays[k], dev) for k in _TL_INT},
        **{k: _f32(arrays[k], dev) for k in _TL_FLOAT},
        octants=octants,
        aabb_lo=_f32(arrays["aabb_lo"], dev),
        aabb_hi=_f32(arrays["aabb_hi"], dev),
        radius=_f32(arrays["radius"], dev),
        materials=bsdf_mod.MaterialTable(
            albedo=_f32(mats["albedo"], dev),
            **{k: _i32(mats[k], dev) for k in _MAT_INT},
            **{k: _f32(mats[k], dev) for k in _MAT_FLOAT},
            twosided=_bool(mats["twosided"], dev),
            nonlinear=_bool(mats["nonlinear"], dev)),
        textures=tex_mod.TextureTable(
            **{k: _f32(texs[k], dev) for k in _TEX_FLOAT},
            **{k: _i32(texs[k], dev) for k in _TEX_INT}, **procedural),
        emitters=em_mod.EmitterTable(
            type=_i32(ems["type"], dev), radiance=_f32(ems["radiance"], dev),
            position=_f32(ems["position"], dev),
            direction=_f32(ems["direction"], dev),
            spot_cos=_f32(ems["spot_cos"], dev),
            delta=_bool(ems["delta"], dev),
            pmf=_f32(ems["pmf"], dev), cdf=_f32(ems["cdf"], dev),
            etri_tri=_i32(ems["etri_tri"], dev),
            etri_cdf=_f32(ems["etri_cdf"], dev),
            env_index=_i32(ems["env_index"], dev),
            env_hw=_i32(ems["env_hw"], dev),
            **{k: _f32(ems[k], dev) for k in _ENV_FLOAT}),
        irawan=irawan_mod.IrawanTable(**{
            k: (_i32 if k in _IRAWAN_INT else _f32)(iw[k], dev)
            for k in irawan_mod.IrawanTable._fields}),
    )
    st = scene_mod.SceneStatic(
        n_tris=T, n_spheres=S, use_bvh=use_bvh,
        bsdf_types=tuple(int(t) for t in static["bsdf_types"]),
        emitter_types=tuple(int(t) for t in static["emitter_types"]),
        has_env=bool(static["has_env"]), has_textures=has_textures,
        n_bvh_nodes=n_nodes,
        has_opacity_tex=bool(static.get("has_opacity_tex", False)),
        has_weight_tex=bool(static.get("has_weight_tex", False)),
        nested_bsdf_types=tuple(
            int(t) for t in static.get("nested_bsdf_types", ())),
        has_normal_maps=has_maps,
    )
    return scene, st


def sensor_from_arrays(arrays: dict, device=None) -> sensor_mod.Sensor:
    """The port's Sensor from the JAX Sensor's fields as numpy arrays (any
    of the nine types)."""
    dev = resolve_device(device)
    stype = int(np.asarray(arrays["type"]))
    if stype not in sensor_mod.TYPES:
        raise ValueError(f"unknown sensor type {stype}")
    rdist = arrays.get("rdist")
    return sensor_mod.Sensor(
        type=stype,
        **{k: _f32(arrays[k], dev) for k in (
            "to_world", "tan_half_fov", "aspect", "aperture_radius",
            "focus_distance", "ortho_scale", "near")},
        rdist=_f32(np.zeros(2) if rdist is None else rdist, dev),
    )


def params_from_arrays(params: dict, device=None) -> dict:
    """The trainer's parameters (``parallel.train.split_params``' dict: leaf
    tensors with ``requires_grad``) from the JAX package's ``split_params``
    output as numpy arrays, by the same names."""
    dev = resolve_device(device)
    return {k: _f32(v, dev).requires_grad_(True) for k, v in params.items()}


def params_to_arrays(params: dict) -> dict:
    """The way back: numpy float32 arrays by name."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
