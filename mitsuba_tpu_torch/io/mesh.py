"""Mesh loaders: OBJ, PLY and Mitsuba's ``.serialized`` format (a copy of
``mitsuba_tpu/io/mesh.py`` without ``load_hair`` and ``save_serialized``,
which land in a later slice of the port).

Parity: src/shapes/obj.cpp (positions/normals/uvs, o/g grouping; MTL
materials surfaced to the caller), src/shapes/ply.cpp (ascii +
binary_little_endian), src/shapes/serialized.cpp (format documented in its
plugin doc-comment: 0x041C magic, version, zlib DEFLATE stream with flag
bits 0x0001 normals / 0x0002 uvs / 0x0008 colors / 0x0010 face normals /
0x1000 single / 0x2000 double precision, trailing offset dictionary).
Host code: numpy and zlib only.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class MeshData:
    positions: np.ndarray              # (V, 3) float
    faces: np.ndarray                  # (F, 3) int
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    face_normals: bool = False
    name: str = ""
    material: str = ""                 # obj: usemtl name per mesh split


def load_obj(path: str, split_by_material: bool = False):
    """Wavefront OBJ. Returns a list of MeshData (one per material group if
    split_by_material, else a single merged mesh). Handles v/vn/vt, negative
    indices, polygon fan triangulation."""
    positions, normals, uvs = [], [], []
    # face entries: (pos_idx, uv_idx, norm_idx) triples
    groups: dict = {}
    current_mtl = ""

    def resolve(idx, n):
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vals = line.split()[1:3]
                uvs.append([float(vals[0]), float(vals[1]) if len(vals) > 1 else 0.0])
            elif line.startswith("usemtl"):
                current_mtl = line.split(None, 1)[1].strip() if len(line.split()) > 1 else ""
            elif line.startswith("f "):
                verts = []
                for tok in line.split()[1:]:
                    parts = (tok.split("/") + ["", ""])[:3]
                    vi = resolve(parts[0], len(positions))
                    ti = resolve(parts[1], len(uvs)) if parts[1] else -1
                    ni = resolve(parts[2], len(normals)) if parts[2] else -1
                    verts.append((vi, ti, ni))
                key = current_mtl if split_by_material else ""
                tris = groups.setdefault(key, [])
                for k in range(1, len(verts) - 1):  # fan triangulation
                    tris.append((verts[0], verts[k], verts[k + 1]))

    positions = np.asarray(positions, np.float64)
    normals = np.asarray(normals, np.float64) if normals else None
    uvs = np.asarray(uvs, np.float64) if uvs else None

    out = []
    for mtl, tris in groups.items():
        # re-index into per-corner unique vertices (OBJ indexes pos/uv/nrm
        # independently; the compiled scene wants unified vertices)
        remap = {}
        v_out, n_out, t_out, f_out = [], [], [], []
        for tri in tris:
            idxs = []
            for corner in tri:
                if corner not in remap:
                    remap[corner] = len(v_out)
                    v_out.append(positions[corner[0]])
                    if normals is not None and corner[2] >= 0:
                        n_out.append(normals[corner[2]])
                    if uvs is not None and corner[1] >= 0:
                        t_out.append(uvs[corner[1]])
                idxs.append(remap[corner])
            f_out.append(idxs)
        out.append(
            MeshData(
                positions=np.asarray(v_out),
                faces=np.asarray(f_out, np.int64),
                normals=np.asarray(n_out) if len(n_out) == len(v_out) else None,
                uvs=np.asarray(t_out) if len(t_out) == len(v_out) else None,
                material=mtl,
                name=os.path.basename(path) + (f":{mtl}" if mtl else ""),
            )
        )
    return out


def load_ply(path: str) -> MeshData:
    """Stanford PLY: ascii 1.0 and binary_little_endian 1.0."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or ('list', idx_t, cnt_t, name)])
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[1], parts[2]))
            elif line == "end_header":
                break

        _np = {
            "char": np.int8, "int8": np.int8,
            "uchar": np.uint8, "uint8": np.uint8,
            "short": np.int16, "int16": np.int16,
            "ushort": np.uint16, "uint16": np.uint16,
            "int": np.int32, "int32": np.int32,
            "uint": np.uint32, "uint32": np.uint32,
            "float": np.float32, "float32": np.float32,
            "double": np.float64, "float64": np.float64,
        }

        verts = {}
        faces = []
        if fmt == "ascii":
            for name, cnt, props in elements:
                rows = [f.readline().split() for _ in range(cnt)]
                if name == "vertex":
                    arr = np.asarray(rows, np.float64)
                    for i, p in enumerate(props):
                        verts[p[1]] = arr[:, i]
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1 : 1 + n]]
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
        elif fmt == "binary_little_endian":
            for name, cnt, props in elements:
                if name == "vertex" and all(p[0] != "list" for p in props):
                    dt = np.dtype([(p[1], _np[p[0]]) for p in props]).newbyteorder("<")
                    arr = np.frombuffer(f.read(dt.itemsize * cnt), dt)
                    for p in props:
                        verts[p[1]] = arr[p[1]].astype(np.float64)
                elif name == "face":
                    for _ in range(cnt):
                        (cnt_t, idx_t, pname) = (props[0][1], props[0][2], props[0][3])
                        n = int(np.frombuffer(f.read(np.dtype(_np[cnt_t]).itemsize), _np[cnt_t])[0])
                        idx = np.frombuffer(f.read(np.dtype(_np[idx_t]).itemsize * n), _np[idx_t])
                        for k in range(1, n - 1):
                            faces.append([int(idx[0]), int(idx[k]), int(idx[k + 1])])
                else:  # skip unknown fixed-size element
                    dt = np.dtype([(p[1], _np[p[0]]) for p in props if p[0] != "list"])
                    f.read(dt.itemsize * cnt)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    pos = np.stack([verts["x"], verts["y"], verts["z"]], axis=1)
    nrm = None
    if "nx" in verts:
        nrm = np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=1)
    uv = None
    if "u" in verts:
        uv = np.stack([verts["u"], verts["v"]], axis=1)
    elif "s" in verts:
        uv = np.stack([verts["s"], verts["t"]], axis=1)
    return MeshData(
        positions=pos, faces=np.asarray(faces, np.int64), normals=nrm, uvs=uv,
        name=os.path.basename(path),
    )


# --- Mitsuba .serialized ---------------------------------------------------

_MTS_MAGIC = 0x041C
_F_NORMALS = 0x0001
_F_UVS = 0x0002
_F_COLORS = 0x0008
_F_FACE_NORMALS = 0x0010
_F_SINGLE = 0x1000
_F_DOUBLE = 0x2000


def load_serialized(path: str, shape_index: int = 0) -> MeshData:
    with open(path, "rb") as f:
        data = f.read()
    n_meshes = struct.unpack_from("<I", data, len(data) - 4)[0]
    table_off = len(data) - 4 - 8 * n_meshes
    offsets = struct.unpack_from(f"<{n_meshes}Q", data, table_off)
    assert 0 <= shape_index < n_meshes, f"shape index {shape_index} of {n_meshes}"
    start = offsets[shape_index]

    magic, version = struct.unpack_from("<HH", data, start)
    assert magic == _MTS_MAGIC, f"bad magic {magic:#x}"
    end = offsets[shape_index + 1] if shape_index + 1 < n_meshes else table_off
    raw = zlib.decompress(data[start + 4 : end])

    off = 0
    (flags,) = struct.unpack_from("<I", raw, off)
    off += 4
    name = ""
    if version >= 4:
        nul = raw.index(b"\0", off)
        name = raw[off:nul].decode("utf-8", "replace")
        off = nul + 1
    vcount, tcount = struct.unpack_from("<QQ", raw, off)
    off += 16

    ft = np.float64 if flags & _F_DOUBLE else np.float32
    fsz = np.dtype(ft).itemsize

    def take(n_items, width):
        nonlocal off
        arr = np.frombuffer(raw, ft, count=n_items * width, offset=off)
        off += n_items * width * fsz
        return arr.reshape(n_items, width).astype(np.float64)

    pos = take(vcount, 3)
    nrm = take(vcount, 3) if flags & _F_NORMALS else None
    uv = take(vcount, 2) if flags & _F_UVS else None
    col = take(vcount, 3) if flags & _F_COLORS else None
    idx = np.frombuffer(raw, np.uint32, count=tcount * 3, offset=off)
    faces = idx.reshape(tcount, 3).astype(np.int64)
    return MeshData(
        positions=pos, faces=faces, normals=nrm, uvs=uv, colors=col,
        face_normals=bool(flags & _F_FACE_NORMALS), name=name or os.path.basename(path),
    )


def load_mesh(path: str, shape_index: int = 0) -> MeshData:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)[0]
    if ext == ".ply":
        return load_ply(path)
    if ext == ".serialized":
        return load_serialized(path, shape_index)
    raise ValueError(f"unsupported mesh format: {path}")
