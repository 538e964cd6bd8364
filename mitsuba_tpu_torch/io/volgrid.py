"""Mitsuba ``.vol`` grid volumes (port of ``mitsuba_tpu/io/volgrid.py``).

The format of the reference's gridvolume.cpp: the magic ``VOL``, version
byte 3, an int32 encoding (1 float32, 2 float16, 3 uint8), the x, y and z
resolutions, the channel count, the world bounding box as six float32s (48
bytes of header in all), then the data with x fastest.
"""
from __future__ import annotations

import struct

import numpy as np


def load_vol(path: str, mmap: bool = True):
    """Returns (density (D, H, W) float32, world_to_grid (4, 4)).

    A multi-channel grid is averaged over its channels; a uint8 grid is read
    as value / 255. ``mmap``: a float32 single-channel file is memory-mapped
    instead of read into memory, so a build reads only what it touches.
    ``world_to_grid`` maps the bounding box onto the unit cube."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"bad magic {magic!r}")
        (version,) = struct.unpack("<B", f.read(1))
        if version != 3:
            raise ValueError(f"unsupported .vol version {version}")
        enc, xres, yres, zres, channels = struct.unpack("<iiiii", f.read(20))
        bbox = struct.unpack("<6f", f.read(24))
        n = xres * yres * zres * channels
        if enc == 1 and mmap and channels == 1:
            data = np.memmap(path, dtype="<f4", mode="r", offset=48,
                             shape=(n,))
        elif enc == 1:
            data = np.frombuffer(f.read(4 * n), "<f4")
        elif enc == 2:
            data = np.frombuffer(f.read(2 * n), "<f2").astype(np.float32)
        elif enc == 3:
            data = np.frombuffer(f.read(n), np.uint8).astype(np.float32) / 255.0
        else:
            raise ValueError(f"unsupported .vol encoding {enc}")
    grid = data.reshape(zres, yres, xres, channels)
    grid = grid.mean(axis=-1) if channels > 1 else grid[..., 0]
    lo = np.asarray(bbox[:3])
    hi = np.asarray(bbox[3:])
    extent = np.maximum(hi - lo, 1e-12)
    w2g = np.eye(4)
    w2g[0, 0] = 1.0 / extent[0]
    w2g[1, 1] = 1.0 / extent[1]
    w2g[2, 2] = 1.0 / extent[2]
    w2g[:3, 3] = -lo / extent
    if grid.dtype != np.float32:
        grid = grid.astype(np.float32)
    return grid, w2g


def save_vol(path: str, grid, bbox_lo=(0, 0, 0), bbox_hi=(1, 1, 1)) -> None:
    """Write a (D, H, W) density grid as a float32 single-channel file
    spanning the box [bbox_lo, bbox_hi]."""
    grid = np.asarray(grid, np.float32)
    zres, yres, xres = grid.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(struct.pack("<B", 3))
        f.write(struct.pack("<iiiii", 1, xres, yres, zres, 1))
        f.write(struct.pack("<6f", *bbox_lo, *bbox_hi))
        f.write(grid.astype("<f4").tobytes())
