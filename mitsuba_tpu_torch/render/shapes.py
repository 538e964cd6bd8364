"""Host-side shape tessellation (a copy of the subset of
``mitsuba_tpu/render/shapes.py`` that the port's scenes use): rectangles and
cubes for the Cornell box, and the heightfield that stands in for
``bunny.ply`` in bench.py's bunny_x2 scene."""
from __future__ import annotations

import numpy as np

from ..core.transform import Transform


def rectangle(to_world: Transform = None):
    """Unit rectangle [-1,1]^2 in the XY plane, +Z normal (rectangle.cpp)."""
    v = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float64
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    if to_world is not None:
        v = to_world.apply_point(v)
    return v, f, uv


def cube(to_world: Transform = None):
    """Unit cube [-1,1]^3 with outward normals (cube.cpp)."""
    verts = []
    faces = []
    uvs = []
    base_v, base_f, base_uv = rectangle()
    # 6 faces: +z, -z, +x, -x, +y, -y
    xforms = [
        Transform.translate([0, 0, 1]),
        Transform.translate([0, 0, -1]) * Transform.rotate([1, 0, 0], 180),
        Transform.translate([1, 0, 0]) * Transform.rotate([0, 1, 0], 90),
        Transform.translate([-1, 0, 0]) * Transform.rotate([0, 1, 0], -90),
        Transform.translate([0, 1, 0]) * Transform.rotate([1, 0, 0], -90),
        Transform.translate([0, -1, 0]) * Transform.rotate([1, 0, 0], 90),
    ]
    off = 0
    for t in xforms:
        verts.append(t.apply_point(base_v))
        faces.append(base_f + off)
        uvs.append(base_uv)
        off += 4
    v = np.concatenate(verts)
    f = np.concatenate(faces)
    uv = np.concatenate(uvs)
    if to_world is not None:
        v = to_world.apply_point(v)
    return v, f, uv


def cornell_box(builder, light_radiance=(18.4, 15.6, 8.0)):
    """Classic Cornell box in meters (box [0,1]^3-ish), building materials
    and geometry into ``builder``. Returns dict of material ids."""
    from . import bsdf as B

    white = builder.add_material(type=B.DIFFUSE, albedo=(0.725, 0.71, 0.68))
    red = builder.add_material(type=B.DIFFUSE, albedo=(0.63, 0.065, 0.05))
    green = builder.add_material(type=B.DIFFUSE, albedo=(0.14, 0.45, 0.091))
    light_mat = builder.add_material(type=B.DIFFUSE, albedo=(0.0, 0.0, 0.0))

    def quad(a, b, c, d, mat, emitter=None):
        v = np.array([a, b, c, d], dtype=np.float64)
        f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
        builder.add_mesh(v, f, mat, emitter_radiance=emitter, uvs=uv)

    # floor, ceiling, back, left (red), right (green) — normals inward
    quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], white)          # floor (+y)
    quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], white)          # ceiling (-y)
    quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], white)          # back (-z)
    quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], red)            # left (+x)
    quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], green)          # right (-x)
    # light patch just below the ceiling (faces down, -y)
    e = 1e-3
    quad(
        [0.343, 1 - e, 0.332], [0.656, 1 - e, 0.332],
        [0.656, 1 - e, 0.645], [0.343, 1 - e, 0.645],
        light_mat, emitter=light_radiance,
    )
    # short block
    _box(builder, white, [0.130, 0.0, 0.065], [0.4, 0.30, 0.38], rot_deg=-18)
    # tall block
    _box(builder, white, [0.53, 0.0, 0.36], [0.75, 0.60, 0.70], rot_deg=16.5)
    return dict(white=white, red=red, green=green, light=light_mat)


def _box(builder, mat, lo, hi, rot_deg=0.0):
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    c = 0.5 * (lo + hi)
    h = 0.5 * (hi - lo)
    t = (
        Transform.translate(c)
        * Transform.rotate([0, 1, 0], rot_deg)
        * Transform.scale(h)
    )
    v, f, uv = cube(t)
    builder.add_mesh(v, f, mat, uvs=uv)


def heightfield(heights, extent=(1.0, 1.0), height_scale: float = 1.0,
                to_world: Transform = None):
    """heightfield.cpp: regular grid of heights -> triangle mesh.

    heights (N, M) sample the surface over [-ex, ex] x [-ey, ey] in the XY
    plane, displaced along +Z (the reference ray-marches the implicit grid;
    a tessellated mesh maps better onto the BVH wavefront). Returns
    (verts, faces, uvs)."""
    h = np.asarray(heights, np.float64)
    N, M = h.shape
    ex, ey = extent
    xs = np.linspace(-ex, ex, M)
    ys = np.linspace(-ey, ey, N)
    X, Y = np.meshgrid(xs, ys)
    v = np.stack([X, Y, h * height_scale], axis=-1).reshape(-1, 3)
    uu, vv = np.meshgrid(np.linspace(0, 1, M), np.linspace(0, 1, N))
    uv = np.stack([uu, vv], axis=-1).reshape(-1, 2)
    idx = np.arange(N * M).reshape(N, M)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[1:, :-1].ravel()
    f = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)])
    if to_world is not None:
        v = to_world.apply_point(v)
    return v, f.astype(np.int64), uv
