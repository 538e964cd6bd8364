"""Bitmap textures with MIP filtering (port of the bitmap part of
``mitsuba_tpu/render/texture.py``).

All bitmaps live in one padded stack, stored flat as ``(B*H*W, 3)`` rows with
explicit strides, and their MIP pyramids in one vertically packed chain
(level l >= 1 at row offset H - (H >> (l-1))), so a lookup is one row gather
per tap. ``eval_texture`` does bilinear lookups at the base level, or
trilinear ones when given the ray-cone footprint ``fp_uv``. The MIP chain
is built from the bitmaps once, at build time, as in the JAX package: a
trainer that replaces ``stack`` (``parallel.train.merge_params``) trains the
base level, and lookups above it read the chain as built. The procedural
textures (checkerboard, grid, wireframe, vertex colors, curvature, noise),
EWA taps and explicit LODs land in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# type tags, the JAX package's numbering
TEX_BITMAP = 2

SUPPORTED_TYPES = (TEX_BITMAP,)


class TextureTable(NamedTuple):
    type: torch.Tensor        # (K,) int32
    uv_scale: torch.Tensor    # (K, 2)
    uv_offset: torch.Tensor   # (K, 2)
    scale: torch.Tensor       # (K, 3) value multiplier
    bitmap_idx: torch.Tensor  # (K,) int32 into the stack
    stack: torch.Tensor       # (B*H*W, 3) padded bitmap stack rows
    stack_hw: torch.Tensor    # (2,) int32 padded (H, W) stride of the stack
    sizes: torch.Tensor       # (B, 2) int32 (h, w) true sizes
    mips: torch.Tensor        # (B*H*(W//2), 3) packed MIP chain
    mips_hw: torch.Tensor     # (2,) int32 padded (H, W//2) stride of mips


def empty_table(device) -> TextureTable:
    """The table of a scene without textures (TextureTable.empty)."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return TextureTable(
        type=i32([0]), uv_scale=f32(np.ones((1, 2))),
        uv_offset=f32(np.zeros((1, 2))), scale=f32(np.ones((1, 3))),
        bitmap_idx=i32([-1]), stack=f32(np.zeros((1, 3))), stack_hw=i32([1, 1]),
        sizes=i32(np.ones((1, 2))), mips=f32(np.zeros((1, 3))),
        mips_hw=i32([1, 1]))


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
    out = v_bitmap * tt.scale[tid]
    return torch.where((tex_id >= 0)[..., None], out, default)


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
    for bitmap textures)."""
    if not textures:
        return empty_table(device)
    for t in textures:
        if t["type"] not in SUPPORTED_TYPES:
            raise NotImplementedError(
                f"texture type {t['type']} lands in a later slice of the port")
    Hm = max(b.shape[0] for b in bitmaps)
    Wm = max(b.shape[1] for b in bitmaps)
    stack = np.zeros((len(bitmaps), Hm, Wm, 3), np.float32)
    sizes = np.zeros((len(bitmaps), 2), np.int32)
    for i, b in enumerate(bitmaps):
        stack[i, : b.shape[0], : b.shape[1]] = b[..., :3]
        sizes[i] = (b.shape[0], b.shape[1])
    mips = build_mip_chain(stack, sizes)

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
    )
