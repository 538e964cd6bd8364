"""Carry a scene and a camera across from the JAX package.

Here the "weights" are the scene and the camera. The caller flattens the JAX
package's ``Scene``/``SceneStatic``/``Sensor`` into plain numpy arrays and
dicts by field name (nested tables as nested dicts); these functions build the
port's tensors from them. Every float is cast to float32 and every index to
int32, so no float64 from the host tables leaks into the port. Nothing here
imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .render import bsdf as bsdf_mod
from .render import emitter as em_mod
from .render import scene as scene_mod
from .render import sensor as sensor_mod

_TRI_FLOAT = ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_gn", "tri_nee_pdf_area")
_TRI_INT = ("tri_mat", "tri_emitter")


def _f32(x, dev):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)


def _i32(x, dev):
    return torch.as_tensor(np.array(x, dtype=np.int32), device=dev)


def _bool(x, dev):
    return torch.as_tensor(np.array(x, dtype=bool), device=dev)


def scene_from_arrays(arrays: dict, static: dict, device=None):
    """(Scene, SceneStatic) of the port from the JAX scene's leaves.

    ``arrays`` maps Scene field names to numpy arrays, with ``materials`` and
    ``emitters`` as dicts of their tables' fields; ``static`` maps SceneStatic
    field names to values. Raises NotImplementedError for a scene this slice
    does not render.
    """
    dev = resolve_device(device)
    scene_mod.check_supported(static)
    T = int(static["n_tris"])
    tri = {k: _f32(arrays[k], dev) for k in _TRI_FLOAT}
    tri.update({k: _i32(arrays[k], dev) for k in _TRI_INT})
    if tri["tri_p0"].shape != (T, 3):
        raise ValueError(
            f"tri_p0 has shape {tuple(tri['tri_p0'].shape)}, expected ({T}, 3)")
    mats, ems = arrays["materials"], arrays["emitters"]
    scene = scene_mod.Scene(
        **tri,
        materials=bsdf_mod.MaterialTable(
            type=_i32(mats["type"], dev), albedo=_f32(mats["albedo"], dev),
            twosided=_bool(mats["twosided"], dev)),
        emitters=em_mod.EmitterTable(
            type=_i32(ems["type"], dev), radiance=_f32(ems["radiance"], dev),
            pmf=_f32(ems["pmf"], dev), cdf=_f32(ems["cdf"], dev),
            etri_tri=_i32(ems["etri_tri"], dev),
            etri_cdf=_f32(ems["etri_cdf"], dev)),
    )
    st = scene_mod.SceneStatic(
        n_tris=T, n_spheres=int(static["n_spheres"]),
        use_bvh=bool(static["use_bvh"]),
        bsdf_types=tuple(int(t) for t in static["bsdf_types"]),
        emitter_types=tuple(int(t) for t in static["emitter_types"]),
        has_env=bool(static["has_env"]),
        has_textures=bool(static.get("has_textures", False)),
    )
    return scene, st


def sensor_from_arrays(arrays: dict, device=None) -> sensor_mod.Sensor:
    """The port's Sensor from the JAX Sensor's fields as numpy arrays."""
    dev = resolve_device(device)
    stype = int(np.asarray(arrays["type"]))
    if stype != sensor_mod.PERSPECTIVE:
        raise NotImplementedError(
            f"sensor type {stype} lands in a later slice of the port")
    rdist = arrays.get("rdist")
    return sensor_mod.Sensor(
        type=stype,
        **{k: _f32(arrays[k], dev) for k in (
            "to_world", "tan_half_fov", "aspect", "aperture_radius",
            "focus_distance", "ortho_scale", "near")},
        rdist=_f32(np.zeros(2) if rdist is None else rdist, dev),
    )
