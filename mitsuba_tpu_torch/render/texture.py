"""Bitmap textures with MIP filtering and the procedural textures a scene
file can declare (port of the bitmap, constant, checkerboard and grid parts
of ``mitsuba_tpu/render/texture.py``; scale.cpp is folded into the value
multiplier at build time).

All bitmaps live in one padded stack, stored flat as ``(B*H*W, 3)`` rows with
explicit strides, and their MIP pyramids in one vertically packed chain
(level l >= 1 at row offset H - (H >> (l-1))), so a lookup is one row gather
per tap. ``eval_texture`` does bilinear lookups at the base level, or
trilinear ones when given the ray-cone footprint ``fp_uv``. The MIP chain
is built from the bitmaps once, at build time, as in the JAX package: a
trainer that replaces ``stack`` (``parallel.train.merge_params``) trains the
base level, and lookups above it read the chain as built. A table without a
bitmap holds a 1x1 dummy stack, as in the JAX package. The procedural
columns (``color0``, ``color1``, ``line_width``) are None in a table without
a procedural row, so a bitmap-only scene gathers what it did before they
existed. The builder-only textures (wireframe, vertex colors, curvature,
noise), EWA taps and explicit LODs land in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# type tags, the JAX package's numbering
TEX_CONSTANT = 0
TEX_CHECKERBOARD = 1
TEX_BITMAP = 2
TEX_GRID = 3

SUPPORTED_TYPES = (TEX_CONSTANT, TEX_CHECKERBOARD, TEX_BITMAP, TEX_GRID)
PROCEDURAL_TYPES = (TEX_CONSTANT, TEX_CHECKERBOARD, TEX_GRID)


class TextureTable(NamedTuple):
    type: torch.Tensor        # (K,) int32
    uv_scale: torch.Tensor    # (K, 2)
    uv_offset: torch.Tensor   # (K, 2)
    scale: torch.Tensor       # (K, 3) value multiplier (scale.cpp folded in)
    bitmap_idx: torch.Tensor  # (K,) int32 into the stack, -1 if procedural
    stack: torch.Tensor       # (B*H*W, 3) padded bitmap stack rows
    stack_hw: torch.Tensor    # (2,) int32 padded (H, W) stride of the stack
    sizes: torch.Tensor       # (B, 2) int32 (h, w) true sizes
    mips: torch.Tensor        # (B*H*(W//2), 3) packed MIP chain
    mips_hw: torch.Tensor     # (2,) int32 padded (H, W//2) stride of mips
    # the procedural columns; None where the table has no procedural row
    color0: torch.Tensor = None      # (K, 3) constant / checker dark / grid cell
    color1: torch.Tensor = None      # (K, 3) checker bright / grid line
    line_width: torch.Tensor = None  # (K,) grid line width


def has_procedural(types) -> bool:
    """Whether a table of texture ``types`` carries the procedural columns."""
    return any(int(t) in PROCEDURAL_TYPES for t in types)


def empty_table(device) -> TextureTable:
    """The table of a scene without textures (TextureTable.empty): one
    constant row, so it carries the procedural columns, which no lookup
    reads."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return TextureTable(
        type=i32([0]), uv_scale=f32(np.ones((1, 2))),
        uv_offset=f32(np.zeros((1, 2))), scale=f32(np.ones((1, 3))),
        bitmap_idx=i32([-1]), stack=f32(np.zeros((1, 3))), stack_hw=i32([1, 1]),
        sizes=i32(np.ones((1, 2))), mips=f32(np.zeros((1, 3))),
        mips_hw=i32([1, 1]), color0=f32(np.ones((1, 3))),
        color1=f32(np.ones((1, 3))), line_width=f32([0.01]))


def eval_texture(tt: TextureTable, tex_id, uv, default, fp_uv=None):
    """Evaluate textures for a batch: tex_id (R,) int32 (-1 -> default),
    uv (R, 2), default (R, 3). With ``fp_uv`` (R,), the ray-cone footprint
    in uv units, the MIP level follows from it per texture size and the
    lookup is trilinear; without it, bilinear at the base level.
    Returns (R, 3)."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    uv_t = uv * tt.uv_scale[tid] + tt.uv_offset[tid]
    if fp_uv is None:
        v_bitmap = _bitmap_bilinear_level(tt, tid, uv_t, None)
    else:
        # footprint in texel units at the base level -> fractional level;
        # uv_scale stretches the footprint in texture space too
        bi = torch.clamp(tt.bitmap_idx[tid], min=0).to(torch.int64)
        wh = torch.stack([tt.sizes[bi, 1], tt.sizes[bi, 0]],
                         dim=-1).to(torch.float32)
        size = torch.amax(wh, dim=-1)
        s_mag = torch.amax(torch.abs(tt.uv_scale[tid]), dim=-1)
        texels = fp_uv * s_mag * size
        lod = torch.where(texels > 1.0,
                          torch.log2(torch.clamp(texels, min=1.0)), 0.0)
        v_bitmap = _bitmap_trilinear(tt, tid, uv_t, lod)
    if tt.color0 is not None:
        v_bitmap = _procedural(tt, tid, uv_t, v_bitmap)
    out = v_bitmap * tt.scale[tid]
    return torch.where((tex_id >= 0)[..., None], out, default)


def _procedural(tt: TextureTable, tid, uv_t, v_bitmap):
    """The value before the multiplier, by type: color0 (constant),
    checkerboard.cpp's parity of the 2x-scaled uv, gridtexture.cpp's line of
    width line_width on the unit-cell boundary, or the bitmap's."""
    ttype = tt.type[tid]
    c0, c1 = tt.color0[tid], tt.color1[tid]
    out = c0
    iu = torch.floor(uv_t[..., 0] * 2.0).to(torch.int32)
    iv = torch.floor(uv_t[..., 1] * 2.0).to(torch.int32)
    checker = torch.remainder(iu + iv, 2) == 0
    v_check = torch.where(checker[..., None], c0, c1)
    out = torch.where((ttype == TEX_CHECKERBOARD)[..., None], v_check, out)
    fu = uv_t[..., 0] - torch.floor(uv_t[..., 0])
    fv = uv_t[..., 1] - torch.floor(uv_t[..., 1])
    lw = tt.line_width[tid]
    on_line = (fu < lw) | (fu > 1.0 - lw) | (fv < lw) | (fv > 1.0 - lw)
    v_grid = torch.where(on_line[..., None], c1, c0)
    out = torch.where((ttype == TEX_GRID)[..., None], v_grid, out)
    return torch.where((ttype == TEX_BITMAP)[..., None], v_bitmap, out)


def n_mip_levels(h, w):
    """Levels below base resolution available in the packed chain."""
    n = 0
    while (h >> (n + 1)) >= 1 and (w >> (n + 1)) >= 1:
        n += 1
    return n


def _bitmap_bilinear_level(tt: TextureTable, tid, uv, level):
    """Bilinear lookup at an integer MIP level (None = base stack)."""
    bi = torch.clamp(tt.bitmap_idx[tid], min=0)
    h0 = tt.sizes[bi.to(torch.int64), 0]
    w0 = tt.sizes[bi.to(torch.int64), 1]
    if level is None:
        h = h0.to(torch.float32)
        w = w0.to(torch.float32)
        img = tt.stack
        sh, sw = tt.stack_hw[0], tt.stack_hw[1]
        row0 = torch.zeros_like(h0)
    else:
        lv = torch.clamp(level, min=1)
        h_i = torch.clamp(h0 >> lv, min=1)
        w_i = torch.clamp(w0 >> lv, min=1)
        # packed chain: level l at row offset H - (H >> (l-1))
        row0 = h0 - torch.clamp(h0 >> (lv - 1), min=1)
        h = h_i.to(torch.float32)
        w = w_i.to(torch.float32)
        img = tt.mips
        sh, sw = tt.mips_hw[0], tt.mips_hw[1]

    # repeat wrap; v flipped (uv origin bottom-left, image row 0 top)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(i, n):
        return torch.remainder(i.to(torch.int32),
                               torch.clamp(n.to(torch.int32), min=1))

    x0i, x1i = wrap(x0, w), wrap(x0 + 1, w)
    y0i = wrap(y0, h) + row0
    y1i = wrap(y0 + 1, h) + row0
    base0 = (bi * sh + y0i) * sw
    base1 = (bi * sh + y1i) * sw
    c00 = img[(base0 + x0i).to(torch.int64)]
    c10 = img[(base0 + x1i).to(torch.int64)]
    c01 = img[(base1 + x0i).to(torch.int64)]
    c11 = img[(base1 + x1i).to(torch.int64)]
    return (c00 * (1 - fx) * (1 - fy)
            + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy
            + c11 * fx * fy)


def _bitmap_trilinear(tt: TextureTable, tid, uv, lod):
    """Trilinear MIP interpolation (TMIPMap::evalTrilinear analog)."""
    bi = torch.clamp(tt.bitmap_idx[tid], min=0).to(torch.int64)
    max_l = torch.log2(torch.clamp(
        torch.minimum(tt.sizes[bi, 0], tt.sizes[bi, 1]).to(torch.float32),
        min=1.0))
    lod = torch.minimum(torch.clamp(lod, min=0.0), max_l - 1e-3)
    l0 = torch.floor(lod).to(torch.int32)
    fl = (lod - l0.to(torch.float32))[..., None]
    lo = torch.where((l0 == 0)[..., None],
                     _bitmap_bilinear_level(tt, tid, uv, None),
                     _bitmap_bilinear_level(tt, tid, uv, l0))
    hi = _bitmap_bilinear_level(tt, tid, uv, l0 + 1)
    return lo * (1.0 - fl) + hi * fl


def build_mip_chain(stack, sizes):
    """Host-side packed pyramid (numpy): 2x2 box downsample per level, level
    l >= 1 stored at row offset H - (H >> (l-1))."""
    B, H, W, _ = stack.shape
    out = np.zeros((B, H, max(W // 2, 1), 3), np.float32)
    for b in range(B):
        h, w = int(sizes[b, 0]), int(sizes[b, 1])
        img = stack[b, :h, :w]
        lvl = 1
        while h >> lvl >= 1 and w >> lvl >= 1:
            hh, ww = h >> lvl, w >> lvl
            img = img[: hh * 2, : ww * 2]
            img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                          + img[0::2, 1::2] + img[1::2, 1::2])
            row0 = h - max(h >> (lvl - 1), 1)
            out[b, row0: row0 + hh, :ww] = img
            lvl += 1
    return out


def build_table(textures, bitmaps, device) -> TextureTable:
    """Compile the builder's texture list (dicts) and bitmaps (H, W, 3)
    float32 into a TextureTable on ``device`` (SceneBuilder._build_textures
    for the bitmap and procedural textures). Without a procedural row the
    procedural columns are None."""
    if not textures:
        return empty_table(device)
    for t in textures:
        if t["type"] not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"texture type {t['type']} lands in a later slice of the port")
    if bitmaps:
        Hm = max(b.shape[0] for b in bitmaps)
        Wm = max(b.shape[1] for b in bitmaps)
        stack = np.zeros((len(bitmaps), Hm, Wm, 3), np.float32)
        sizes = np.zeros((len(bitmaps), 2), np.int32)
        for i, b in enumerate(bitmaps):
            stack[i, : b.shape[0], : b.shape[1]] = b[..., :3]
            sizes[i] = (b.shape[0], b.shape[1])
        mips = build_mip_chain(stack, sizes)
    else:
        # a 1x1 dummy entry (scene.py:1671-1674)
        stack = np.zeros((1, 1, 1, 3), np.float32)
        sizes = np.ones((1, 2), np.int32)
        mips = np.zeros((1, 1, 1, 3), np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return TextureTable(
        type=i32([t["type"] for t in textures]),
        uv_scale=f32([t["uv_scale"] for t in textures]),
        uv_offset=f32([t["uv_offset"] for t in textures]),
        scale=f32([t["scale"] for t in textures]),
        bitmap_idx=i32([t["bitmap"] for t in textures]),
        stack=f32(np.ascontiguousarray(stack).reshape(-1, 3)),
        stack_hw=i32(stack.shape[1:3]),
        sizes=i32(sizes),
        mips=f32(np.ascontiguousarray(mips).reshape(-1, 3)),
        mips_hw=i32(mips.shape[1:3]),
        **(dict(color0=f32([t["color0"] for t in textures]),
                color1=f32([t["color1"] for t in textures]),
                line_width=f32([t["line_width"] for t in textures]))
           if has_procedural(t["type"] for t in textures)
           else {}),
    )
