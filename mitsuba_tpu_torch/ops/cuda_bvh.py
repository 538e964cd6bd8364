"""Threaded-BVH traversal: the CUDA kernels K3-K9 (``csrc/bvh_lane.cu``),
their wrappers, their plain versions, the node packers, the coherence sort
keys and the query functions around them (the counterpart of
``mitsuba_tpu/ops/pallas_bvh.py``, which holds all seven TPU kernels; they
share one walk, one set of checks and one sort, so they share a module).

    K3 ``lane_chunk``                <- ``_lane_chunk`` (pallas_bvh.py:1132)
    K4 ``bvh_traverse_lane_packed``  <- ``bvh_traverse_lane_packed`` (:1052)
    K5 ``lane_hbm``                  <- the kernel of ``bvh_traverse_lane_hbm``
                                        (:1423)
    K6 ``lane_chunk_hbm``            <- ``_lane_chunk_hbm`` (:1514)
    K7 ``treelet_rounds``            <- the kernel of ``bvh_traverse_treelets``
                                        (:514, body ``_treelet_rounds`` :406)
    K8 ``bvh_traverse_packed``       <- ``bvh_traverse_packed`` (:226)
    K9 ``lane_chunk_w``              <- ``_lane_chunk_w`` (:1802)

The TPU's page-planar table (``pack_pages``) exists because Mosaic has no
per-lane gather; here each CUDA thread follows its own skip link through a
node-major table of ``(N, 12)`` float32 (``pack_nodes``; three float4s per
node, see the source note in ``bvh_lane.cu``). K4/K5 walk from the root; K3/K6
resume from per-lane state ``(node, t, idx, u, v)`` for at most ``max_steps``
node visits (0: to the end). On the H100 there is no VMEM/HBM split: K5 and K6
compute what K4 and K3 compute on trees above ``LANE_VMEM_MAX_NODES``, with
their own launch bounds. K7 walks the same tree one treelet (a subtree's row
range) at a time, nearest entered treelet first; K8 walks a tree of up to
four triangles per leaf, whose fat rows (``pack_nodes_fat``, the JAX layout)
it takes split into 32-byte heads and one table of triangle slots
(``fat_tables``); K9 runs K3's walk over the JAX
package's wide pages (``pack_pages_w``, and for closest hits
``pack_pages_w_octants``).

Octant tables (``pack_nodes_octants``, ``Octants``). Closest-hit lanes of
K3, K5, K6, K7 and K9 walk one of eight copies of the tree, the one of their
direction's octant, in which every internal node's nearer child comes first;
any-hit lanes walk the canonical table, whose order the JAX kernels' first
hit depends on, and so do K4's closest-hit lanes (on the coherent camera rays
that the render sends it the octant walk ran slower, see ``bvh_lane.cu``).
The near-first walk finds the closest hit early, so the slab
test culls the boxes behind it. Where two triangles are hit at the same t,
the canonical walk keeps the one it reached first, which is the one with the
lower canonical leaf row; the octant walk keeps that one too by the tie rule:
a hit at t equal to the best replaces the best only if its leaf's canonical
row (kept in the octant rows' column 11; K9's wide pages have no word for it
and read ``Octants.leaf_row`` of the hit triangle) is below the best
triangle's (``Octants.leaf_row``), and in K7 only against a best found in
the same treelet. So the result is the canonical walk's
(``canonical_walk_plain``); only a hit whose box entry rounds past its t can
differ (a near-tie). Closest-hit K8 walks octant copies of its heads; its
slots are in canonical order, so its tie rule compares slot indices
(``FatTables``; ``fat_rows_walk_plain`` is its canonical yardstick).

Each wrapper checks its inputs (one device, dtype, shape, contiguity) on
either device. On CUDA tensors it then allocates the outputs, launches its
kernel on the current stream and counts the launch in its ``launches``
attribute; it never falls back. On CPU tensors it runs its plain version
(``*_plain``): a whole-batch loop over per-lane node pointers that repeats the
kernel's float32 arithmetic operation by operation (the kernels are compiled
without FMA contraction), so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import build

NODE_COLS = 12    # lo.xyz skip | hi.xyz tri | e2.xyz 0 (three float4s)
MAX_NODES = 1 << 24   # skip links and triangle ids are exact float32 values
LSTRIP = 10       # the TPU schedule's strip (pallas_bvh.py:893)
# K7's treelet table: (K, 24) lo.xyz, hi.xyz, root, skip, then per octant
# the treelet's (root, end) in that octant's table; K7 keeps it in shared
# memory (12 KB at 128 treelets)
TREELET_COLS = 24
MAX_TREELETS = 128
# K7's list of entered treelets per ray (csrc/bvh_lane.cu TREELET_LIST); a
# ray that enters more finishes with pending-mask rounds
TREELET_LIST = 8
# the octants of a ray direction: bit k set where d[k] >= 0
OCTANTS = 8
# rays per chunk of the treelet sort key's dense (rays x K) box test
TREELET_KEY_CHUNK = 1 << 15
# K8's fat rows: lo.xyz skip | hi.xyz count | per slot p0.xyz id | e1.xyz 0 |
# e2.xyz 0 (fourteen float4s)
FAT_LEAF_SIZE = 4
SLOT_COLS = 12
FAT_COLS = 8 + SLOT_COLS * FAT_LEAF_SIZE
# K8's split tables (pack_fat_tables): 32-byte heads lo.xyz skip | hi.xyz
# word, and one table of 48-byte triangle slots
HEAD_COLS = 8
# K9's wide pages (pallas_bvh.py:1655): 11 component rows of vpp = page / 128
# lanes-of-128 per page
PCOMP = 11
WIDE_PAGE = 256
# trees above this node count go to K5/K6, as in the JAX package (the TPU's
# VMEM ceiling, pallas_bvh.py:1639)
LANE_VMEM_MAX_NODES = 2_300_000

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("bvh_lane")
    if lib.bvh_lane_packed.argtypes is None:
        root = [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P]
        chunk = [_P, _I] + [_P] * 12 + [_I, _I, _I] + [_P] * 6
        # K3, K5, K6, K7 and K9 take the canonical table, the octant tables
        # and the map
        octs = [_P, _P, _P]
        treelet = octs + [_I, _P, _I, _P, _P, _P, _P, _I, _I] + [_P] * 6
        fat = [_P, _P, _P, _I] + [_P] * 6 + [_I, _I] + [_P] * 6
        for fn, args in ((lib.bvh_lane_packed, root),
                         (lib.bvh_lane_hbm, octs + root[1:]),
                         (lib.bvh_lane_chunk, octs + chunk[1:]),
                         (lib.bvh_lane_chunk_hbm, octs + chunk[1:]),
                         (lib.bvh_lane_chunk_w, octs + [_I] + chunk[1:]),
                         (lib.bvh_treelet_rounds, treelet),
                         (lib.bvh_fat_packed, fat)):
            fn.argtypes = args
            fn.restype = _I
        lib.bvh_kernel_occupancy.argtypes = [_I, _P, _P]
        lib.bvh_kernel_occupancy.restype = _I
    return lib


# bvh_kernel_occupancy's kernel numbers: K4, K5, K6 and K9 have a
# closest-hit and an any-hit instantiation, K8 those two each unbounded and
# bounded
_OCCUPANCY = ("lane_chunk", "treelet_rounds", "lane_chunk_hbm", "lane_hbm",
              "lane_chunk_hbm any_hit", "lane_hbm any_hit",
              "bvh_traverse_lane_packed", "bvh_traverse_lane_packed any_hit",
              "lane_chunk_w", "lane_chunk_w any_hit",
              "bvh_traverse_packed", "bvh_traverse_packed any_hit",
              "bvh_traverse_packed bounded",
              "bvh_traverse_packed any_hit bounded")


def kernel_occupancy(name):
    """(registers per thread, resident blocks of 128 threads per SM) of
    ``lane_chunk`` (K3), ``bvh_traverse_lane_packed`` (K4), ``lane_hbm``
    (K5), ``lane_chunk_hbm`` (K6), ``treelet_rounds`` (K7) or
    ``lane_chunk_w`` (K9) on the current card; the any-hit instantiations of
    K4, K5, K6 and K9 as ``"<name> any_hit"``; K8's four as
    ``"bvh_traverse_packed"`` plus `` any_hit`` and/or `` bounded``."""
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _lib().bvh_kernel_occupancy(_OCCUPANCY.index(name),
                                     ctypes.byref(regs), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"bvh_kernel_occupancy failed: cudaError {rc}")
    return regs.value, blocks.value


# === host-side node table ==================================================

def pack_nodes(bvh, p0, e1, e2) -> np.ndarray:
    """(N, 12) float32 node-major table from a leaf_size=1 BVH and the
    original (unpermuted) triangle arrays. Columns:
      0..2 internal: bbox lo | leaf: tri p0     3 skip link
      4..6 internal: bbox hi | leaf: e1         7 tri id, -1 for internal
      8..10 leaf: e2 (zero on internal nodes)   11 zero
    The same values as ``pack_pages`` (pallas_bvh.py:903), node-major."""
    N = len(bvh.lo)
    counts = np.where(bvh.prim_first >= 0, bvh.prim_count, 0)
    if counts.max() > 1:
        raise ValueError("the lane kernels need a leaf_size=1 BVH")
    _check_ids(N, len(p0))
    leaf = counts > 0
    tri = np.where(leaf, bvh.prim_order[np.maximum(bvh.prim_first, 0)], -1)
    nodes = np.zeros((N, NODE_COLS), np.float32)
    nodes[:, 0:3] = np.where(leaf[:, None], p0[np.maximum(tri, 0)], bvh.lo)
    nodes[:, 4:7] = np.where(leaf[:, None], e1[np.maximum(tri, 0)], bvh.hi)
    nodes[:, 8:11] = np.where(leaf[:, None], e2[np.maximum(tri, 0)], 0.0)
    nodes[:, 3] = bvh.skip.astype(np.float32)
    nodes[:, 7] = tri.astype(np.float32)
    return nodes


def _check_ids(N, T):
    if N >= MAX_NODES or T >= MAX_NODES:
        raise ValueError(f"{N} nodes / {T} triangles: ids must stay below "
                         f"2^24 to be exact in float32")


def pack_nodes_fat(bvh, p0, e1, e2) -> np.ndarray:
    """(N, 56) float32 fat rows for K8 from a BVH of at most four triangles
    per leaf: ``lo.xyz skip | hi.xyz count`` on every node, then per slot k
    < count ``p0.xyz id | e1.xyz 0 | e2.xyz 0``, empty slots zero. The same
    values as the JAX ``pack_nodes`` (pallas_bvh.py:64), in float4s."""
    N = len(bvh.lo)
    counts = np.where(bvh.prim_first >= 0, bvh.prim_count, 0)
    if counts.max() > FAT_LEAF_SIZE:
        raise ValueError(f"fat rows hold at most {FAT_LEAF_SIZE} triangles "
                         f"per leaf, the tree has {counts.max()}")
    _check_ids(N, len(p0))
    rows = np.zeros((N, FAT_COLS), np.float32)
    rows[:, 0:3] = bvh.lo
    rows[:, 3] = bvh.skip.astype(np.float32)
    rows[:, 4:7] = bvh.hi
    rows[:, 7] = counts.astype(np.float32)
    leaf = np.nonzero(counts > 0)[0]
    for k in range(FAT_LEAF_SIZE):
        sel = leaf[counts[leaf] > k]
        tri = bvh.prim_order[bvh.prim_first[sel] + k]
        base = 8 + 12 * k
        rows[sel, base:base + 3] = p0[tri]
        rows[sel, base + 3] = tri.astype(np.float32)
        rows[sel, base + 4:base + 7] = e1[tri]
        rows[sel, base + 8:base + 11] = e2[tri]
    return rows


def pack_pages_w(bvh, p0, e1, e2, page: int = WIDE_PAGE) -> np.ndarray:
    """(n_pages * 11 * vpp, 128) float32 wide-page rows (leaf_size=1 BVH), the
    values of pallas_bvh.py:1655. Page p, component c, vreg k lives at row
    p*(11*vpp) + c*vpp + k and holds nodes [p*page + k*128, p*page +
    (k+1)*128); padding slots carry skip = N and tri id -1."""
    _check_page(page)
    return _wide_from_rows(pack_nodes(bvh, p0, e1, e2), page)


def _check_page(page):
    if page <= 0 or page % 128:
        raise ValueError(f"page {page} is not a positive multiple of 128")


# the node-major columns of wide-page components 0..10: lo/p0, hi/e1, e2,
# skip, tri id
_WIDE_COLS = [0, 1, 2, 4, 5, 6, 8, 9, 10, 3, 7]


def _wide_from_rows(rows, page):
    """A node-major (N, 12) table laid out as wide pages of ``page`` nodes."""
    N = rows.shape[0]
    vpp = page // 128
    n_pages = -(-N // page)
    comp = np.zeros((PCOMP, n_pages * page), np.float32)
    comp[9, :] = float(N)
    comp[10, :] = -1.0
    comp[:, :N] = rows[:, _WIDE_COLS].T
    # (c, p, k, lane) -> (p, c, k, lane): the loop of the JAX packer
    out = comp.reshape(PCOMP, n_pages, vpp, 128).transpose(1, 0, 2, 3)
    return np.ascontiguousarray(out.reshape(n_pages * PCOMP * vpp, 128))


def pack_pages_w_octants(tables, page: int = WIDE_PAGE) -> np.ndarray:
    """(8, n_pages * 11 * vpp, 128) float32: each octant table of
    ``pack_nodes_octants`` laid out as ``pack_pages_w`` lays out the
    canonical one (its skip links, which are rows of that table; no word for
    a leaf's canonical row, which K9's tie rule reads from the map)."""
    _check_page(page)
    return np.stack([_wide_from_rows(np.asarray(t, np.float32), page)
                     for t in tables])


def octant_signs() -> np.ndarray:
    """(8, 3) float64: the direction signs of octant o, +1 on axis k where
    bit k of o is set (d[k] >= 0, as ``ray_sort_keys`` codes it), else -1."""
    return np.where((np.arange(OCTANTS)[:, None] >> np.arange(3)) & 1, 1.0,
                    -1.0)


def pack_nodes_octants(nodes, tl_root=None):
    """The eight octant tables of a node-major table, from that table alone.

    ``nodes`` is the canonical (N, 12) table of a leaf_size=1 BVH
    (``pack_nodes``): the left child of internal row n is n + 1, its right
    child skip[n + 1]. Table o re-emits the same tree in depth-first order
    with the near child first for directions of octant o: the child whose
    centre c (the box centre of an internal row, the vertex mean p0 + (e1 +
    e2) / 3 of a leaf) has the smaller s . c, with s = ``octant_signs()[o]``;
    the left child on equal projections. Skip links are rewritten; leaf rows
    are copied, with their canonical row in column 11 (an exact float).
    Built level by level, all octants at once.

    Returns (tables (8, N, 12) float32, leaf_row (T,) int32: the canonical
    leaf row of triangle i, tl_range (8, K, 2) int32: treelet k's (root,
    end) rows in table o, for the canonical treelet roots ``tl_root`` (K = 0
    without them))."""
    nodes = np.asarray(nodes, np.float32)
    N = nodes.shape[0]
    row = np.arange(N)
    skip = nodes[:, 3].astype(np.int64)
    tri = nodes[:, 7].astype(np.int64)
    leaf = tri >= 0
    _check_threaded(skip, leaf)
    if not np.array_equal(np.sort(tri[leaf]), np.arange(int(leaf.sum()))):
        raise ValueError("the octant tables need a leaf_size=1 BVH over "
                         "triangles 0..T-1")
    a, b, c = (nodes[:, k:k + 3].astype(np.float64) for k in (0, 4, 8))
    centre = np.where(leaf[:, None], a + (b + c) / 3.0, (a + b) / 2.0)
    pos, size = _near_first(skip, leaf, centre)
    # a leaf carries its canonical row in column 11 (an exact float)
    src = nodes.copy()
    src[:, 11] = np.where(leaf, row, 0)
    tables = _reemit(src, pos, size, skip_col=3)
    leaf_row = np.empty(int(leaf.sum()), np.int32)
    leaf_row[tri[leaf]] = row[leaf]
    roots = np.asarray([] if tl_root is None else tl_root, np.int64)
    tl_range = np.stack([pos[:, roots], pos[:, roots] + size[roots]], axis=-1)
    return tables, leaf_row, tl_range.astype(np.int32)


def _check_threaded(skip, leaf):
    """Raise unless ``skip`` (N,) and ``leaf`` (N,) bool describe a binary
    tree in depth-first order with skip links: the left child of internal
    row n is n + 1, its right child skip[n + 1]."""
    N = len(skip)
    row = np.arange(N)
    inner = row[~leaf]
    left = inner + 1
    if skip[0] != N or np.any(skip - row < 1) or np.any(left >= N):
        raise ValueError("nodes is not a threaded depth-first tree")
    right = skip[left]
    if np.any(right >= N) or np.any(skip[right] != skip[inner]):
        raise ValueError("nodes is not a binary threaded tree")


def _near_first(skip, leaf, centre):
    """Where each canonical row goes in each octant's near-first table:
    (pos (8, N) int64, subtree size (N,) int64). Table o re-emits the tree
    in depth-first order with, at every internal node, the child whose
    ``centre`` (N, 3) has the smaller s . c first (s = ``octant_signs()[o]``;
    the left child on equal projections). Level by level, all octants at
    once."""
    N = len(skip)
    size = skip - np.arange(N)
    inner = np.nonzero(~leaf)[0]
    proj = centre @ octant_signs().T                      # (N, 8)
    octs = np.arange(OCTANTS)[:, None]
    pos = np.zeros((OCTANTS, N), np.int64)                # root at row 0
    level = inner[:1] if N > 1 else inner[:0]
    while level.size:
        lc, rc = level + 1, skip[level + 1]
        right_first = (proj[rc] < proj[lc]).T             # (8, n)
        first = np.where(right_first, rc, lc)
        second = np.where(right_first, lc, rc)
        at = pos[:, level] + 1
        pos[octs, first] = at
        pos[octs, second] = at + size[first]
        kids = np.concatenate([lc, rc])
        level = kids[~leaf[kids]]
    return pos, size


def _reemit(rows, pos, size, skip_col):
    """The canonical ``rows`` (N, C) float32 moved to rows ``pos`` (8, N) of
    eight tables (8, N, C), as whole records, with the skip link in column
    ``skip_col`` rewritten: row p's skip is p + the subtree size."""
    N, cols = rows.shape
    src = np.array(rows, np.float32)
    src[:, skip_col] = size
    record = np.dtype((np.void, 4 * cols))
    tables = np.empty((OCTANTS, N, cols), np.float32)
    tables.view(record)[np.arange(OCTANTS)[:, None], pos, 0] = \
        src.view(record)[:, 0]
    tables[:, :, skip_col] += np.arange(N, dtype=np.float32)
    return tables


class Octants(NamedTuple):
    """A tree's octant tables (``pack_nodes_octants``) on the device that
    closest-hit K3, K5, K6 and K7 run on."""

    nodes: torch.Tensor     # (8, N, 12) float32, near child first
    leaf_row: torch.Tensor  # (T,) int32 canonical leaf row of each triangle
    tl_range: torch.Tensor  # (8, K, 2) int32 treelet (root, end) per octant


def octant_tables(nodes, tl_root=None, device=None) -> Octants:
    """``pack_nodes_octants`` of the canonical table ``nodes`` (numpy or a
    tensor) as an ``Octants`` on ``device`` (that of ``nodes`` if None)."""
    if isinstance(nodes, torch.Tensor):
        device = nodes.device if device is None else device
        nodes = nodes.cpu().numpy()
    if isinstance(tl_root, torch.Tensor):
        tl_root = tl_root.cpu().numpy()
    return Octants(*(torch.as_tensor(x, device=device)
                     for x in pack_nodes_octants(nodes, tl_root)))


class WideOctants(NamedTuple):
    """A tree's octant tables as wide pages, for closest-hit K9."""

    pages: torch.Tensor     # (8, n_pages * 11 * vpp, 128) float32
    leaf_row: torch.Tensor  # (T,) int32 canonical leaf row of each triangle


def wide_octant_pages(octants: Octants, page: int = WIDE_PAGE) -> WideOctants:
    """``pack_pages_w_octants`` of ``octants`` on their device."""
    pages = pack_pages_w_octants(octants.nodes.cpu().numpy(), page)
    return WideOctants(torch.as_tensor(pages, device=octants.nodes.device),
                       octants.leaf_row)


def pack_fat_tables(fat):
    """K8's split tables from the (N, 56) fat rows of ``pack_nodes_fat``.

    Returns (heads (N, 8) float32: ``lo.xyz skip | hi.xyz word`` in
    canonical order, where a leaf's word is the int32 ``first << 3 | count``
    (bitcast: its slots are ``tris[first:first + count]``) and an internal
    node's is 0; tris (S, 12) float32: every leaf's slots ``p0.xyz id |
    e1.xyz 0 | e2.xyz 0`` in canonical leaf order, then slot order, so the
    slot index orders hits as the canonical walk meets them; octant_heads
    (8, N, 8) float32: the heads re-emitted near child first per direction
    octant (``pack_nodes_octants``' order, children by the projection of
    their box centre), skip links rewritten, words unchanged)."""
    fat = np.asarray(fat, np.float32)
    if fat.ndim != 2 or fat.shape[1] != FAT_COLS:
        raise ValueError(f"fat rows of shape {fat.shape}, expected (N, "
                         f"{FAT_COLS})")
    N = fat.shape[0]
    skip = fat[:, 3].astype(np.int64)
    count = fat[:, 7].astype(np.int64)
    if np.any((count < 0) | (count > FAT_LEAF_SIZE)):
        raise ValueError(f"fat rows hold 0..{FAT_LEAF_SIZE} triangles")
    leaf = count > 0
    _check_threaded(skip, leaf)
    first = np.cumsum(count) - count
    heads = np.empty((N, HEAD_COLS), np.float32)
    heads[:, :7] = fat[:, :7]
    heads[:, 7] = ((first << 3) | count).astype(np.int32).view(np.float32)
    heads[~leaf, 7] = 0.0
    slots = fat[:, 8:].reshape(N, FAT_LEAF_SIZE, SLOT_COLS)
    tris = np.ascontiguousarray(
        slots[np.arange(FAT_LEAF_SIZE)[None, :] < count[:, None]])
    lo, hi = (fat[:, k:k + 3].astype(np.float64) for k in (0, 4))
    pos, size = _near_first(skip, leaf, (lo + hi) / 2.0)
    return heads, tris, _reemit(heads, pos, size, skip_col=3)


class FatTables(NamedTuple):
    """K8's split tables (``pack_fat_tables``) on the device it runs on."""

    heads: torch.Tensor         # (N, 8) float32, canonical order
    tris: torch.Tensor          # (S, 12) float32 triangle slots
    octant_heads: torch.Tensor  # (8, N, 8) float32, near child first


def fat_tables(fat, device=None) -> FatTables:
    """``pack_fat_tables`` of the fat rows ``fat`` (numpy or a tensor) as a
    ``FatTables`` on ``device``: that of ``fat`` if it is a tensor and
    ``device`` is None, else CUDA unless the caller names another (raises
    without a card)."""
    if isinstance(fat, torch.Tensor) and device is None:
        dev = fat.device
    else:
        dev = resolve_device(device)
    if isinstance(fat, torch.Tensor):
        fat = fat.cpu().numpy()
    return FatTables(*(torch.as_tensor(x, device=dev)
                       for x in pack_fat_tables(fat)))


def treelet_table(tl_root, tl_skip, tl_lo, tl_hi, tl_range):
    """K7's (K, 24) float32 table: lo.xyz, hi.xyz, root, skip, as the JAX
    function concatenates them (pallas_bvh.py:573), then the (root, end) of
    each octant's table from ``tl_range`` (8, K, 2); the ints are exact below
    2^24."""
    K = tl_root.shape[0]
    oct_cols = tl_range.permute(1, 0, 2).reshape(K, 2 * OCTANTS)
    return torch.cat([tl_lo, tl_hi, tl_root[:, None].to(torch.float32),
                      tl_skip[:, None].to(torch.float32),
                      oct_cols.to(torch.float32)], dim=1).contiguous()


# === coherence sort key ====================================================

def _part1by2(x):
    """Spread 10 bits over 30 (Morton interleave helper), on int64 values
    below 2^32 (PyTorch has no uint32 arithmetic on the CPU)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_keys(o, d, scene_lo, scene_hi):
    """Coherence key (pallas_bvh.py:315): direction octant (3 bits) above the
    origin's 30-bit Morton code shifted right by one; uint32 values in an
    int64 tensor."""
    ext = torch.clamp(scene_hi - scene_lo, min=1e-9)
    q = torch.clamp((o - scene_lo) / ext, 0.0, 1.0)
    qi = (q * 1023.0).to(torch.int64)
    morton = (_part1by2(qi[:, 0]) | (_part1by2(qi[:, 1]) << 1)
              | (_part1by2(qi[:, 2]) << 2))
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    return (octant << 29) | (morton >> 1)


def nearest_treelet(o, d, t_min, t_max, tl_lo, tl_hi):
    """Index of the nearest treelet root box each ray enters within (t_min,
    t_max), 0 when it enters none (``_nearest_treelet``, pallas_bvh.py:383):
    a dense (rays x K) box test, ``TREELET_KEY_CHUNK`` rays at a time; the
    lowest index wins a tie, as the JAX scan's strict < gives."""
    inv = _safe_inv(d)
    out = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
    for a in range(0, o.shape[0], TREELET_KEY_CHUNK):
        b = a + TREELET_KEY_CHUNK
        oo, ii = o[a:b, None, :], inv[a:b, None, :]
        t0 = (tl_lo[None] - oo) * ii
        t1 = (tl_hi[None] - oo) * ii
        tn = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=2),
                           t_min[a:b, None])
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=2),
                           t_max[a:b, None])
        e = torch.where(tn <= tf, tn, torch.inf)
        out[a:b] = torch.argmin(e, dim=1)
    return out


def treelet_sort_keys(o, d, t_min, t_max, tl_lo, tl_hi, scene_lo, scene_hi):
    """K7's sort key (pallas_bvh.py:541-548): the nearest treelet in the top
    8 bits over ``ray_sort_keys >> 8``; dead lanes (t_max <= t_min) last."""
    key = ((nearest_treelet(o, d, t_min, t_max, tl_lo, tl_hi) << 24)
           | (ray_sort_keys(o, d, scene_lo, scene_hi) >> 8))
    return torch.where(t_max <= t_min, 0xFFFFFFFF, key)


# === input checks ==========================================================

def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_nodes(nodes, n_nodes):
    """The node-major table of exactly ``n_nodes`` rows; returns its
    device."""
    if _check_table("nodes", nodes, NODE_COLS, nodes.device) != n_nodes:
        raise ValueError(f"nodes has {nodes.shape[0]} rows, expected "
                         f"{n_nodes}")
    return nodes.device


def _check_count(R):
    if 3 * R >= 2 ** 31:
        raise ValueError(f"{R} rays exceed the kernels' int32 index range")


def _check_table(name, t, cols, dev):
    """A float32 node table of ``cols`` columns, 16-byte aligned on CUDA."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no BVH traversal for device {dev}")
    n = t.shape[0] if t.dim() == 2 else 0
    if not 0 < n < MAX_NODES:
        raise ValueError(f"{name} has {n} rows; the kernels take 1..2^24-1")
    _check(name, t, torch.float32, (n, cols), dev)
    if dev.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    return n


def _check_root_rays(o, d, t_min, t_max, dev):
    R = o.shape[0]
    _check_count(R)
    _check("o", o, torch.float32, (R, 3), dev)
    _check("d", d, torch.float32, (R, 3), dev)
    _check("t_min", t_min, torch.float32, (R,), dev)
    _check("t_max", t_max, torch.float32, (R,), dev)
    return R


def _check_chunk_state(rays, state, dev):
    R = rays[0].shape[0]
    _check_count(R)
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_min"), rays):
        _check(name, x, torch.float32, (R,), dev)
    for name, x, dt in zip(("node", "t", "idx", "u", "v"), state,
                           (torch.int32, torch.float32, torch.int32,
                            torch.float32, torch.float32)):
        _check(name, x, dt, (R,), dev)
    return R


# === plain versions ========================================================

def _safe_inv(x):
    """_safe_inv_v (pallas_bvh.py:87): 1 / x with |x| < 1e-12 -> +-1e-12."""
    tiny = torch.abs(x) < 1e-12
    return 1.0 / torch.where(tiny, torch.where(x < 0, -1e-12, 1e-12), x)


def _node_rows(nodes):
    """Node ids -> the node-major table's 12 columns (K3-K7)."""
    def fetch(n):
        row = nodes[n]
        return [row[:, c] for c in range(NODE_COLS)]
    return fetch


def _wide_pages(pages, page, n_nodes=None):
    """Node ids -> the same 12 columns gathered from K9's wide pages:
    component c of node n at row (n // page) * 11 * vpp + c * vpp + (n %
    page) // 128, lane n % 128 (column 11, which the layout lacks, zero).
    For the (8, rows, 128) octant pages, ids are octant * n_nodes + n, the
    rows of ``pack_nodes_octants``' tables."""
    vpp = page // 128
    flat = pages.reshape(-1)
    table = pages[0].numel() if pages.dim() == 3 else 0

    def fetch(n):
        base = 0
        if table:
            base, n = n // n_nodes * table, n % n_nodes
        r = n % page
        word = base + ((n // page) * (PCOMP * vpp) + r // 128) * 128 + r % 128
        g = [flat[word + c * vpp * 128] for c in range(PCOMP)]
        return (g[0:3] + [g[9]] + g[3:6] + [g[10]] + g[6:9]
                + [torch.zeros_like(g[0])])
    return fetch


def _octant(dx, dy, dz):
    """Each lane's octant (int64): bit k set where d[k] >= 0."""
    return ((dx >= 0).to(torch.int64) | ((dy >= 0).to(torch.int64) << 1)
            | ((dz >= 0).to(torch.int64) << 2))


def _walk_plain(fetch, n_nodes, rays, node, bt, bi, bu, bv, any_hit,
                max_steps, end=None, base=None, n_rows=None, leaf_row=None,
                armed=None, canon_by_map=False):
    """The kernels' per-lane walk in tensor form over the table that
    ``fetch`` reads. ``rays`` = (ox, oy, oz, dx, dy, dz, t_min), each (R,).
    Each step advances every lane that is still walking by one node, with
    the kernel's operations in the kernel's order; a lane whose pointer
    reaches its ``end`` (R,) retires (K7). ``base`` (R,) offsets each lane's
    node ids into the ``n_rows`` rows that ``fetch`` reads (a lane's octant
    table). With ``leaf_row`` the walk keeps the tie rule: a hit at t equal
    to the best replaces it where the lane is ``armed`` ((R,) bool, updated
    in place: its best was found in this walk) and the leaf's canonical row
    (column 11, or with ``canon_by_map`` ``leaf_row`` of the hit triangle)
    is below ``leaf_row`` of the best triangle. Returns the new (node, t, idx,
    u, v) and the visits: per-lane internal and leaf visit counts (int64),
    which rows were read at all ((n_rows,) bool) and which ``leaf_row``
    entries ((T,) bool, None without the tie rule)."""
    ox, oy, oz, dx, dy, dz, t_min = rays
    node, bt, bi, bu, bv = (x.clone() for x in (node, bt, bi, bu, bv))
    inx, iny, inz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    v_int = torch.zeros(node.shape, dtype=torch.int64, device=node.device)
    v_leaf = torch.zeros_like(v_int)
    touched = torch.zeros(n_nodes if n_rows is None else n_rows,
                          dtype=torch.bool, device=node.device)
    map_read = None if leaf_row is None else torch.zeros(
        leaf_row.shape, dtype=torch.bool, device=node.device)
    lane = torch.nonzero(node < n_nodes).squeeze(1)
    while lane.numel():
        n = node[lane].to(torch.int64)
        r = n if base is None else n + base[lane]
        touched[r] = True
        g = fetch(r)
        skip = g[3].to(torch.int64)
        tid = g[7].to(torch.int32)
        leaf = tid >= 0
        lox, loy, loz = ox[lane], oy[lane], oz[lane]
        ldx, ldy, ldz = dx[lane], dy[lane], dz[lane]
        tmin, best = t_min[lane], bt[lane]
        # leaf: Moeller-Trumbore on p0 = g0..2, e1 = g4..6, e2 = g8..10
        pvx = ldy * g[10] - ldz * g[9]
        pvy = ldz * g[8] - ldx * g[10]
        pvz = ldx * g[9] - ldy * g[8]
        det = g[4] * pvx + g[5] * pvy + g[6] * pvz
        ok = torch.abs(det) > 1e-12
        invd = 1.0 / torch.where(ok, det, 1.0)
        tvx, tvy, tvz = lox - g[0], loy - g[1], loz - g[2]
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
        qx = tvy * g[6] - tvz * g[5]
        qy = tvz * g[4] - tvx * g[6]
        qz = tvx * g[5] - tvy * g[4]
        vv = (ldx * qx + ldy * qy + ldz * qz) * invd
        tt = (g[8] * qx + g[9] * qy + g[10] * qz) * invd
        geo = (leaf & ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
               & (tt > tmin))
        h = geo & (tt < best)
        if leaf_row is not None:
            # the tie rule: read the map only on an exact tie
            arm = armed[lane]
            tie = geo & (tt == best) & arm
            cur = torch.clamp(bi[lane], min=0).to(torch.int64)
            map_read[cur[tie]] = True
            canon = g[11].to(torch.int64)
            if canon_by_map:
                hit_tri = torch.clamp(tid, min=0).to(torch.int64)
                map_read[hit_tri[tie]] = True
                canon = leaf_row[hit_tri]
            h = h | (tie & (canon < leaf_row[cur]))
            armed[lane] = arm | h
        # internal: slab test on lo = g0..2, hi = g4..6
        t0x, t1x = (g[0] - lox) * inx[lane], (g[4] - lox) * inx[lane]
        t0y, t1y = (g[1] - loy) * iny[lane], (g[5] - loy) * iny[lane]
        t0z, t1z = (g[2] - loz) * inz[lane], (g[6] - loz) * inz[lane]
        tnear = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.maximum(torch.minimum(t0z, t1z), tmin))
        tfar = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), best))
        descend = ~leaf & (tnear <= tfar)
        nxt = torch.where(descend, n + 1, skip)
        if end is not None:
            nxt = torch.where(nxt >= end[lane], n_nodes, nxt)
        new_bi = torch.where(h, tid, bi[lane])
        bt[lane] = torch.where(h, tt, best)
        bi[lane] = new_bi
        bu[lane] = torch.where(h, uu, bu[lane])
        bv[lane] = torch.where(h, vv, bv[lane])
        if any_hit:
            nxt = torch.where(new_bi >= 0, n_nodes, nxt)
        node[lane] = nxt.to(torch.int32)
        v_leaf[lane] += leaf.to(torch.int64)
        v_int[lane] += (~leaf).to(torch.int64)
        go = nxt < n_nodes
        if max_steps:
            go = go & (v_int[lane] + v_leaf[lane] < max_steps)
        lane = lane[go]
    return (node, bt, bi, bu, bv), (v_int, v_leaf, touched, map_read)


def _root_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit, with_visits,
                octants=None):
    """A walk from the root (row 0): over the canonical ``nodes``, or with
    ``octants`` (closest hit) over each lane's octant table with the tie
    rule, unarmed."""
    R = o.shape[0]
    dev = o.device
    node = torch.where(t_max > t_min, 0, n_nodes).to(torch.int32)
    rays = tuple(o[:, k] for k in range(3)) + tuple(d[:, k] for k in range(3))
    rays = rays + (t_min,)
    fetch, walk = _node_rows(nodes), {}
    if octants is not None:
        fetch = _octant_rows(octants)
        walk = _octant_walk(octants, n_nodes, rays)
        walk["armed"] = torch.zeros(R, dtype=torch.bool, device=dev)
    (_, bt, bi, bu, bv), visits = _walk_plain(
        fetch, n_nodes, rays, node, t_max,
        torch.full((R,), -1, dtype=torch.int32, device=dev),
        torch.zeros(R, device=dev), torch.zeros(R, device=dev), any_hit, 0,
        **walk)
    out = _hit_result(bt, bi, bu, bv)
    return out + (visits,) if with_visits else out


def canonical_walk_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit=False,
                         with_visits=False):
    """The canonical walk from the root over ``nodes``, left child first:
    the JAX K4's (hit, t, idx, u, v), and with ``with_visits`` the visits
    (per-lane internal and leaf counts, nodes read). The yardstick that the
    octant walks' closest hits equal except at near-ties; any-hit queries of
    every kernel but K7 and K8 return its result."""
    return _root_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit,
                       with_visits)


# Plain PyTorch version of K4, whose closest-hit and any-hit lanes both walk
# the canonical table
bvh_traverse_lane_packed_plain = canonical_walk_plain


def lane_hbm_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit=False,
                   with_visits=False, octants=None):
    """Plain PyTorch version of K5: any-hit lanes walk K4's walk over the
    canonical ``nodes``; closest-hit lanes walk their octant's table of
    ``octants`` from its row 0 with the tie rule (K3's walk from the root).
    Returns (hit, t, idx, u, v), and with ``with_visits`` the visits as
    ``lane_chunk_plain`` gives them."""
    if not any_hit and octants is None:
        raise ValueError(_NEED_OCTANTS)
    return _root_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit,
                       with_visits, None if any_hit else octants)


def _chunk_plain(fetch, n_nodes, rays, state, any_hit, max_steps,
                 with_visits):
    (node, bt, bi, bu, bv), visits = _walk_plain(
        fetch, n_nodes, rays, *state, any_hit, max_steps)
    out = (bt, bi, bu, bv, node)
    return out + (visits,) if with_visits else out


_NEED_OCTANTS = ("closest-hit queries of K3, K5, K6, K7 and K9 walk the "
                 "octant tables: pass octants (cuda_bvh.octant_tables; K9: "
                 "cuda_bvh.wide_octant_pages)")


def _octant_walk(octants, n_nodes, rays):
    """The walk arguments of closest-hit lanes: each lane's octant table in
    the flattened (8 N, 12) tables and the tie rule's map."""
    if octants is None:
        raise ValueError(_NEED_OCTANTS)
    return dict(base=_octant(*rays[3:6]) * n_nodes,
                n_rows=OCTANTS * n_nodes,
                leaf_row=octants.leaf_row.to(torch.int64))


def _octant_rows(octants):
    return _node_rows(octants.nodes.reshape(-1, NODE_COLS))


def lane_chunk_plain(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
                     t_in, i_in, u_in, v_in, any_hit=False, max_steps=0,
                     with_visits=False, octants=None):
    """Plain PyTorch version of K3: (t, idx, u, v, node) after at most
    ``max_steps`` visits per lane, and with ``with_visits`` this call's
    visits (per-lane internal and leaf counts, rows read, map entries read).
    Any-hit lanes walk the canonical ``nodes``; closest-hit lanes walk their
    octant's table of ``octants`` with the tie rule, and ``node`` is a row of
    that table."""
    rays = (ox, oy, oz, dx, dy, dz, t_min)
    state = (node_in, t_in, i_in, u_in, v_in)
    if any_hit:
        return _chunk_plain(_node_rows(nodes), n_nodes, rays, state, any_hit,
                            max_steps, with_visits)
    walk = _octant_walk(octants, n_nodes, rays)
    (node, bt, bi, bu, bv), visits = _walk_plain(
        _octant_rows(octants), n_nodes, rays, *state, False, max_steps,
        armed=i_in >= 0, **walk)
    out = (bt, bi, bu, bv, node)
    return out + (visits,) if with_visits else out


# Plain PyTorch version of K6: K3's walk (closest-hit lanes on ``octants``);
# the two kernels differ only in their schedule on the card.
lane_chunk_hbm_plain = lane_chunk_plain


def lane_chunk_w_plain(pages, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
                       t_in, i_in, u_in, v_in, any_hit=False, max_steps=0,
                       page=WIDE_PAGE, with_visits=False, octants=None):
    """Plain PyTorch version of K9: K3's walk over wide pages. Any-hit lanes
    walk the canonical ``pages``; closest-hit lanes walk their octant's pages
    of ``octants`` (a ``WideOctants``) with the tie rule, the canonical row
    of a leaf read from the map, and ``node`` is a row of that octant's
    table. The rows read that ``with_visits`` marks are rows of the eight
    tables stacked, as ``lane_chunk_plain`` marks them."""
    rays = (ox, oy, oz, dx, dy, dz, t_min)
    state = (node_in, t_in, i_in, u_in, v_in)
    if any_hit:
        return _chunk_plain(_wide_pages(pages, page), n_nodes, rays, state,
                            True, max_steps, with_visits)
    if octants is None:
        raise ValueError(_NEED_OCTANTS)
    (node, bt, bi, bu, bv), visits = _walk_plain(
        _wide_pages(octants.pages, page, n_nodes), n_nodes, rays, *state,
        False, max_steps, base=_octant(dx, dy, dz) * n_nodes,
        n_rows=OCTANTS * n_nodes, leaf_row=octants.leaf_row.to(torch.int64),
        armed=i_in >= 0, canon_by_map=True)
    out = (bt, bi, bu, bv, node)
    return out + (visits,) if with_visits else out


def _box_plain(lox, loy, loz, hix, hiy, hiz, ox, oy, oz, inx, iny, inz, tmin,
               best):
    """The kernels' slab test in tensor form: (tnear, tfar)."""
    t0x, t1x = (lox - ox) * inx, (hix - ox) * inx
    t0y, t1y = (loy - oy) * iny, (hiy - oy) * iny
    t0z, t1z = (loz - oz) * inz, (hiz - oz) * inz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.maximum(torch.minimum(t0z, t1z), tmin))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), best))
    return tnear, tfar


class _TreeletWalks:
    """What both plain versions of K7 share: the lanes' best hits, their
    treelet walks (a closest-hit lane over its octant's range with the tie
    rule armed afresh in each treelet, an any-hit lane over the canonical
    range) and the visits they make."""

    def __init__(self, nodes, tab, o, d, t_min, t_max, any_hit, octants):
        N, R, dev = nodes.shape[0], o.shape[0], o.device
        self.N, self.tab, self.any_hit = N, tab, any_hit
        self.rays = (tuple(o[:, k] for k in range(3))
                     + tuple(d[:, k] for k in range(3)) + (t_min,))
        self.inv = [_safe_inv(x) for x in self.rays[3:6]]
        self.t_min = t_min
        self.bt = t_max.clone()
        self.bi = torch.full((R,), -1, dtype=torch.int32, device=dev)
        self.bu, self.bv = torch.zeros(R, device=dev), torch.zeros(R, device=dev)
        if any_hit:
            self.fetch, self.walk = _node_rows(nodes), {}
            self.col = torch.full((R,), 6, dtype=torch.int64, device=dev)
        else:
            self.walk = _octant_walk(octants, N, self.rays)
            self.fetch = _octant_rows(octants)
            self.col = 8 + 2 * _octant(*self.rays[3:6])
        self.v_int = torch.zeros(R, dtype=torch.int64, device=dev)
        self.v_leaf = torch.zeros_like(self.v_int)
        self.v_root = torch.zeros_like(self.v_int)
        self.touched = torch.zeros(self.walk.get("n_rows", N), dtype=torch.bool,
                                   device=dev)
        self.map_read = None if any_hit else torch.zeros(
            octants.leaf_row.shape, dtype=torch.bool, device=dev)

    def boxes(self, lane, best):
        """Slab tests of ``lane`` against every root box: (tnear, tfar),
        each (lanes, K)."""
        lo, hi = self.tab[:, 0:3], self.tab[:, 3:6]
        return _box_plain(*lo.T[:, None, :], *hi.T[:, None, :],
                          *(x[lane, None] for x in self.rays[:3]),
                          *(x[lane, None] for x in self.inv),
                          self.t_min[lane, None], best[:, None])

    def enter(self, lane, sel):
        """Walk treelet ``sel`` (per lane) of each lane in ``lane``."""
        R = self.bt.shape[0]
        dev = self.bt.device
        node = torch.full((R,), self.N, dtype=torch.int32, device=dev)
        end = torch.zeros(R, dtype=torch.int64, device=dev)
        col = self.col[lane]
        node[lane] = self.tab[sel, col].to(torch.int32)
        end[lane] = self.tab[sel, col + 1].to(torch.int64)
        armed = torch.zeros(R, dtype=torch.bool, device=dev)
        (_, self.bt, self.bi, self.bu, self.bv), (vi, vl, tc, mr) = _walk_plain(
            self.fetch, self.N, self.rays, node, self.bt, self.bi, self.bu,
            self.bv, self.any_hit, 0, end=end, armed=armed, **self.walk)
        self.v_int += vi
        self.v_leaf += vl
        self.touched |= tc
        if mr is not None:
            self.map_read |= mr

    def rounds(self, pend, lane):
        """_treelet_rounds' dense selection: each round every lane in
        ``lane`` tests its pending treelets' root boxes (``pend`` (R, K),
        updated in place) against its best hit, walks the nearest (lowest
        index on a tie) and retires when it enters none."""
        while lane.numel():
            live = pend[lane]
            self.v_root[lane] += live.sum(dim=1)
            tn, tf = self.boxes(lane, self.bt[lane])
            e = torch.where(live & (tn <= tf), tn, torch.inf)
            best_e, sel = torch.min(e, dim=1)
            keep = best_e < torch.inf    # a lane that enters no box retires
            lane, sel = lane[keep], sel[keep]
            pend[lane, sel] = False
            self.enter(lane, sel)
            if self.any_hit:
                lane = lane[self.bi[lane] < 0]

    def result(self, with_visits, extra=()):
        out = _hit_result(self.bt, self.bi, self.bu, self.bv)
        visits = (self.v_int, self.v_leaf, self.touched, self.v_root,
                  self.map_read) + tuple(extra)
        return out + (visits,) if with_visits else out


def treelet_rounds_plain(nodes, tab, o, d, t_min, t_max, any_hit=False,
                         with_visits=False, octants=None):
    """Plain PyTorch version of K7 in the JAX kernel's form: (hit, t, idx, u,
    v), and with ``with_visits`` the visits (per-lane internal and leaf
    visit counts, rows read, per-lane root-box tests, map entries read).
    Each round tests every live lane against its pending treelets' root
    boxes at once, picks the nearest (lowest index on a tie), and walks
    those treelets' row ranges: closest-hit lanes in their octant's table
    (``octants``), any-hit lanes in ``nodes``."""
    w = _TreeletWalks(nodes, tab, o, d, t_min, t_max, any_hit, octants)
    pend = (t_max > t_min)[:, None].repeat(1, tab.shape[0])
    w.rounds(pend, torch.nonzero(pend.any(dim=1)).squeeze(1))
    return w.result(with_visits)


def treelet_list_plain(nodes, tab, o, d, t_min, t_max, any_hit=False,
                       with_visits=False, octants=None,
                       list_size=TREELET_LIST):
    """Plain PyTorch version of K7 in the kernel's form: each live lane
    tests all K root boxes once against its t_max, keeps the entered ones
    with a finite entry as a list of the ``list_size`` smallest (tnear,
    index), and walks them in that order until an entry lies beyond its
    best hit (or, any-hit, until a hit); a lane whose list ran out finishes
    with ``treelet_rounds_plain``'s rounds over the entered treelets not yet
    walked. The same treelets in the same order as the dense rounds, so the
    same result. With ``with_visits`` the visits as ``treelet_rounds_plain``
    gives them (root-box tests as the kernel makes them) and the number of
    root boxes each lane enters."""
    w = _TreeletWalks(nodes, tab, o, d, t_min, t_max, any_hit, octants)
    R, K = o.shape[0], tab.shape[0]
    dev = o.device
    live = t_max > t_min
    lane = torch.nonzero(live).squeeze(1)
    tn, tf = w.boxes(lane, t_max[lane])
    entered = tn <= tf
    w.v_root[lane] += K
    n_entered = torch.zeros(R, dtype=torch.int64, device=dev)
    n_entered[lane] = entered.sum(dim=1)
    key = torch.where(entered & (tn < torch.inf), tn, torch.inf)
    order = torch.argsort(key, dim=1, stable=True)[:, :list_size]
    okey = torch.gather(key, 1, order)
    pend = torch.zeros((R, K), dtype=torch.bool, device=dev)
    pend[lane] = entered
    walking = live.clone()
    for i in range(min(list_size, K)):
        at = walking[lane] & (okey[:, i] < torch.inf)
        beyond = at & (okey[:, i] > w.bt[lane])
        walking[lane[beyond]] = False    # every later entry is beyond too
        at &= ~beyond
        go, sel = lane[at], order[at, i]
        pend[go, sel] = False
        w.enter(go, sel)
        if any_hit:
            walking[go[w.bi[go] >= 0]] = False
    w.rounds(pend, torch.nonzero(walking & pend.any(dim=1)).squeeze(1))
    return w.result(with_visits, (n_entered,))


def _tri_plain(g, c, ldx, ldy, ldz, lox, loy, loz, tmin):
    """Moeller-Trumbore of the kernels on the slot whose p0 is column ``c``
    of ``g`` (e1 at c + 4, e2 at c + 8), in their operation order: (geo, tt,
    uu, vv), geo the hit beyond tmin whatever the best."""
    pvx = ldy * g[c + 10] - ldz * g[c + 9]
    pvy = ldz * g[c + 8] - ldx * g[c + 10]
    pvz = ldx * g[c + 9] - ldy * g[c + 8]
    det = g[c + 4] * pvx + g[c + 5] * pvy + g[c + 6] * pvz
    ok = torch.abs(det) > 1e-12
    invd = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = lox - g[c], loy - g[c + 1], loz - g[c + 2]
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    qx = tvy * g[c + 6] - tvz * g[c + 5]
    qy = tvz * g[c + 4] - tvx * g[c + 6]
    qz = tvx * g[c + 5] - tvy * g[c + 4]
    vv = (ldx * qx + ldy * qy + ldz * qz) * invd
    tt = (g[c + 8] * qx + g[c + 9] * qy + g[c + 10] * qz) * invd
    geo = ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > tmin)
    return geo, tt, uu, vv


def _fat_start(N, t_min, t_max, start, end):
    """K8's first node and row limit per lane: a dead lane (t_max <= t_min,
    start outside [0, N) or start >= end) starts at N."""
    R, dev = t_max.shape[0], t_max.device
    first = torch.zeros(R, dtype=torch.int64, device=dev) if start is None \
        else start.to(torch.int64)
    stop = torch.full((R,), N, dtype=torch.int64, device=dev) if end is None \
        else end.to(torch.int64)
    node = torch.where((t_max > t_min) & (first >= 0) & (first < stop), first,
                       N)
    return node, stop


def bvh_traverse_packed_plain(tables, o, d, t_min, t_max, start=None,
                              end=None, any_hit=False, with_visits=False,
                              tie_rule=True):
    """Plain PyTorch version of K8 over its split tables (a ``FatTables``),
    walking them as the kernel does: closest-hit lanes without ``[start,
    end)`` walk their direction octant's ``octant_heads`` from row 0, the
    others the canonical ``heads``; a visit tests the head's box against
    (t_min, best) and, where a leaf's box is entered, its slots in slot
    order. A hit replaces the best where tt < best, or where the lane has a
    best and tt == best from a lower slot index (the tie rule: slots are in
    canonical order, so the canonical walk's result; ``tie_rule=False``
    walks without it). Returns (hit, t, idx, u, v), and with
    ``with_visits`` the visits: per-lane node visits and triangle tests,
    head rows read (of the table walked: (8 N,) for the octant walk), slots
    read (a lane entered their leaf's box) and per-lane exact ties met (a
    hit at t equal to the lane's best)."""
    N, R, dev = tables.heads.shape[0], o.shape[0], o.device
    ox, oy, oz = (o[:, k] for k in range(3))
    dx, dy, dz = (d[:, k] for k in range(3))
    inx, iny, inz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    node, stop = _fat_start(N, t_min, t_max, start, end)
    lim = torch.clamp(stop, max=N)
    if any_hit or start is not None:
        rows, base = tables.heads, torch.zeros_like(node)
    else:
        rows = tables.octant_heads.reshape(-1, HEAD_COLS)
        base = _octant(dx, dy, dz) * N
    words = rows.view(torch.int32)[:, 7].to(torch.int64)
    tris = tables.tris
    bt = t_max.clone()
    bs = torch.full((R,), -1, dtype=torch.int64, device=dev)
    bu, bv = torch.zeros(R, device=dev), torch.zeros(R, device=dev)
    v_node = torch.zeros(R, dtype=torch.int64, device=dev)
    v_tri, ties = torch.zeros_like(v_node), torch.zeros_like(v_node)
    touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    opened = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    lane = torch.nonzero(node < lim).squeeze(1)
    while lane.numel():
        n = node[lane]
        r = n + base[lane]
        touched[r] = True
        g = [rows[r, c] for c in range(HEAD_COLS)]
        word = words[r]
        lox, loy, loz = ox[lane], oy[lane], oz[lane]
        ldx, ldy, ldz = dx[lane], dy[lane], dz[lane]
        tmin, best, ls = t_min[lane], bt[lane], bs[lane]
        tnear, tfar = _box_plain(g[0], g[1], g[2], g[4], g[5], g[6], lox, loy,
                                 loz, inx[lane], iny[lane], inz[lane], tmin,
                                 best)
        hit_box = tnear <= tfar
        # every slot's test at once (it does not depend on the best), then
        # the best taken slot by slot in slot order
        slot = torch.arange(FAT_LEAF_SIZE, device=dev)
        valid = hit_box[:, None] & (slot < (word & 7)[:, None])
        sl = torch.where(valid, (word >> 3)[:, None] + slot, 0)
        opened[sl[valid]] = True
        t = tris[sl]
        geo, tt, uu, vv = _tri_plain(
            [t[..., c] for c in range(SLOT_COLS)], 0,
            *(x[:, None] for x in (ldx, ldy, ldz, lox, loy, loz, tmin)))
        geo &= valid
        v_tri[lane] += valid.sum(dim=1)
        lu, lv = bu[lane], bv[lane]
        for k in range(FAT_LEAF_SIZE):
            h = geo[:, k] & (tt[:, k] < best)
            tie = geo[:, k] & (tt[:, k] == best) & (ls >= 0)
            ties[lane] += tie.to(torch.int64)
            if tie_rule and not any_hit:   # as the kernel's instantiations
                h = h | (tie & (sl[:, k] < ls))
            best = torch.where(h, tt[:, k], best)
            ls = torch.where(h, sl[:, k], ls)
            lu = torch.where(h, uu[:, k], lu)
            lv = torch.where(h, vv[:, k], lv)
        bt[lane], bs[lane], bu[lane], bv[lane] = best, ls, lu, lv
        nxt = torch.where(hit_box & (word == 0), n + 1, g[3].to(torch.int64))
        retire = nxt >= lim[lane]
        if any_hit:
            retire |= ls >= 0
        node[lane] = torch.where(retire, N, nxt)
        v_node[lane] += 1
        lane = lane[node[lane] < N]
    idx = torch.where(bs >= 0, tris[bs.clamp(min=0), 3].to(torch.int32), -1)
    out = _hit_result(bt, idx, bu, bv)
    return out + ((v_node, v_tri, touched, opened, ties),) if with_visits \
        else out


def fat_rows_walk_plain(nodes, o, d, t_min, t_max, start=None, end=None,
                        any_hit=False, with_visits=False):
    """The JAX K8's walk over the (N, 56) fat rows of ``pack_nodes_fat``
    (pallas_bvh.py:93-198): from ``start`` (or the root) in canonical
    order, every node's box tested, an entered leaf's triangles in slot
    order, a hit replacing the best only at tt < best. Returns (hit, t, idx,
    u, v), and with ``with_visits`` the visits (per-lane node visits and
    triangle tests, nodes read, leaves whose triangles were read: a leaf's
    box was entered by some lane). The yardstick that K8's walks over its
    split tables (``bvh_traverse_packed_plain``) equal bit for bit."""
    N, R, dev = nodes.shape[0], o.shape[0], o.device
    ox, oy, oz = (o[:, k] for k in range(3))
    dx, dy, dz = (d[:, k] for k in range(3))
    inx, iny, inz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    node, stop = _fat_start(N, t_min, t_max, start, end)
    bt, bi = t_max.clone(), torch.full((R,), -1, dtype=torch.int32, device=dev)
    bu, bv = torch.zeros(R, device=dev), torch.zeros(R, device=dev)
    v_node = torch.zeros(R, dtype=torch.int64, device=dev)
    v_tri = torch.zeros_like(v_node)
    touched = torch.zeros(N, dtype=torch.bool, device=dev)
    opened = torch.zeros_like(touched)
    lane = torch.nonzero(node < N).squeeze(1)
    while lane.numel():
        n = node[lane]
        touched[n] = True
        row = nodes[n]
        g = [row[:, c] for c in range(FAT_COLS)]
        lox, loy, loz = ox[lane], oy[lane], oz[lane]
        ldx, ldy, ldz = dx[lane], dy[lane], dz[lane]
        tmin, best = t_min[lane], bt[lane]
        tnear, tfar = _box_plain(g[0], g[1], g[2], g[4], g[5], g[6], lox, loy,
                                 loz, inx[lane], iny[lane], inz[lane], tmin,
                                 best)
        hit_box = tnear <= tfar
        cnt = g[7].to(torch.int64)
        opened[n[hit_box & (cnt > 0)]] = True
        li, lu, lv = bi[lane], bu[lane], bv[lane]
        for k in range(FAT_LEAF_SIZE):
            c = 8 + SLOT_COLS * k   # p0 = c..c+2, id = c+3, e1, e2
            valid = hit_box & (k < cnt)
            geo, tt, uu, vv = _tri_plain(g, c, ldx, ldy, ldz, lox, loy, loz,
                                         tmin)
            h = valid & geo & (tt < best)
            best = torch.where(h, tt, best)
            li = torch.where(h, g[c + 3].to(torch.int32), li)
            lu = torch.where(h, uu, lu)
            lv = torch.where(h, vv, lv)
            v_tri[lane] += valid.to(torch.int64)
        bt[lane], bi[lane], bu[lane], bv[lane] = best, li, lu, lv
        nxt = torch.where(hit_box & (cnt == 0), n + 1, g[3].to(torch.int64))
        retire = nxt >= stop[lane]
        if any_hit:
            retire |= li >= 0
        node[lane] = torch.where(retire, N, nxt)
        v_node[lane] += 1
        lane = lane[node[lane] < N]
    out = _hit_result(bt, bi, bu, bv)
    return out + ((v_node, v_tri, touched, opened),) if with_visits else out


# === kernel wrappers =======================================================

def _root_outputs(R, dev):
    """(hit, t, idx, u, v) of a root walk (K4, K5, K7, K8)."""
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    t, u, v = (torch.empty(R, dtype=torch.float32, device=dev) for _ in range(3))
    return hit, t, torch.empty(R, dtype=torch.int32, device=dev), u, v


def _chunk_outputs(R, dev):
    """(t, idx, u, v, node) of a resumable walk (K3, K6, K9)."""
    t, u, v = (torch.empty(R, dtype=torch.float32, device=dev) for _ in range(3))
    idx, node = (torch.empty(R, dtype=torch.int32, device=dev) for _ in range(2))
    return t, idx, u, v, node


def _launch(fn_name, wrapper, dev, args, outs):
    """Call csrc's ``fn_name(*args, *outs, stream)`` on ``dev``'s current
    stream, raise if the launch was refused, and count it on ``wrapper``.
    Returns ``outs``; a call without rays launches nothing."""
    if outs[0].numel() == 0:
        return outs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_lib(), fn_name)(*args, *(x.data_ptr() for x in outs),
                                      stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")
    wrapper.launches += 1
    return outs


def bvh_traverse_lane_packed(nodes, n_nodes, o, d, t_min, t_max,
                             any_hit=False):
    """K4: closest hit (or, with ``any_hit``, the first hit found) of rays
    o, d (R, 3) within (t_min, t_max) (R,), walking the canonical table from
    the root, in a kernel instantiation of each query kind.

    Returns (hit bool, t float32 (inf on a miss), idx int32 original triangle
    id (-1 on a miss), u, v float32 (0 on a miss)), each (R,). A lane with
    t_max <= t_min is dead and misses."""
    dev = _check_nodes(nodes, n_nodes)
    R = _check_root_rays(o, d, t_min, t_max, dev)
    if dev.type == "cpu":
        return bvh_traverse_lane_packed_plain(nodes, n_nodes, o, d, t_min,
                                              t_max, any_hit=any_hit)
    return _launch("bvh_lane_packed", bvh_traverse_lane_packed, dev, (
        nodes.data_ptr(), n_nodes, o.data_ptr(), d.data_ptr(),
        t_min.data_ptr(), t_max.data_ptr(), R, int(any_hit)),
        _root_outputs(R, dev))


bvh_traverse_lane_packed.launches = 0


def _octant_ptrs(octants, any_hit):
    """The octant tables' and the map's pointers of a K3, K5, K6, K7 or K9
    launch (null for an any-hit call, which walks the canonical table)."""
    if any_hit:
        return None, None
    tables = octants.pages if isinstance(octants, WideOctants) \
        else octants.nodes
    return tables.data_ptr(), octants.leaf_row.data_ptr()


def lane_hbm(nodes, n_nodes, o, d, t_min, t_max, any_hit=False,
             octants=None):
    """K5: K4's contract (closest hit of rays o, d (R, 3) within (t_min,
    t_max), or the first hit found; returns (hit, t, idx, u, v)) for trees
    above ``LANE_VMEM_MAX_NODES``. Any-hit lanes walk the canonical table
    ``nodes`` from the root; closest-hit lanes walk their direction's octant
    table of ``octants`` (required for a closest-hit call) from its root
    with the tie rule, which keeps the canonical walk's result."""
    dev = _check_nodes(nodes, n_nodes)
    if not any_hit:
        _check_octants(octants, n_nodes, dev)
    R = _check_root_rays(o, d, t_min, t_max, dev)
    if dev.type == "cpu":
        return lane_hbm_plain(nodes, n_nodes, o, d, t_min, t_max,
                              any_hit=any_hit, octants=octants)
    return _launch("bvh_lane_hbm", lane_hbm, dev, (
        nodes.data_ptr(), *_octant_ptrs(octants, any_hit), n_nodes,
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), R,
        int(any_hit)), _root_outputs(R, dev))


lane_hbm.launches = 0


def _check_pages(pages, n_nodes, page):
    """K9's wide pages: whole pages of ``WIDE_PAGE`` nodes (the page the
    kernel is compiled for) that hold ``n_nodes``."""
    if page != WIDE_PAGE:
        raise ValueError(f"K9 takes pages of {WIDE_PAGE} nodes, not {page}")
    rows = _check_table("pages", pages, 128, pages.device)
    per_page = PCOMP * page // 128
    if rows % per_page or not 0 < n_nodes <= rows // per_page * page \
            or n_nodes >= MAX_NODES:
        raise ValueError(f"{n_nodes} nodes do not fit {rows} page rows of "
                         f"{page} nodes")


def _check_resume(rays, state, max_steps, dev):
    """A resumable walk's rays, state and budget (K3, K6, K9); returns R."""
    R = _check_chunk_state(rays, state, dev)
    if max_steps < 0:
        raise ValueError(f"max_steps {max_steps} < 0")
    return R


def _check_octants(octants, n_nodes, dev):
    """An ``Octants`` of ``n_nodes``-row tables on ``dev``."""
    if not isinstance(octants, Octants):
        raise ValueError(_NEED_OCTANTS)
    _check("octants.nodes", octants.nodes, torch.float32,
           (OCTANTS, n_nodes, NODE_COLS), dev)
    if dev.type == "cuda" and octants.nodes.data_ptr() % 16:
        raise ValueError("octants.nodes must be 16-byte aligned (float4 loads)")
    _check_map(octants.leaf_row, dev)


def _check_map(leaf_row, dev):
    T = leaf_row.shape[0] if leaf_row.dim() == 1 else -1
    _check("octants.leaf_row", leaf_row, torch.int32, (T,), dev)


def _check_wide_octants(octants, n_nodes, dev):
    """A ``WideOctants`` of ``n_nodes``-node tables in pages of
    ``WIDE_PAGE`` on ``dev``."""
    if not isinstance(octants, WideOctants):
        raise ValueError(_NEED_OCTANTS)
    rows = -(-n_nodes // WIDE_PAGE) * PCOMP * WIDE_PAGE // 128
    _check("octants.pages", octants.pages, torch.float32,
           (OCTANTS, rows, 128), dev)
    _check_map(octants.leaf_row, dev)


def lane_chunk(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in,
               i_in, u_in, v_in, any_hit=False, max_steps=0, octants=None):
    """K3: resume each lane's walk from (node_in, t_in, i_in, u_in, v_in) for
    at most ``max_steps`` node visits (0: to the end). Rays come as one (R,)
    float32 array per component; node and idx are int32. ``t_in`` is the
    search bound (the best hit so far, or t_max). Returns the updated
    (t, idx, u, v, node); a lane is done when node >= n_nodes.

    Any-hit lanes walk the canonical table ``nodes``; closest-hit lanes walk
    the table of their direction's octant in ``octants`` (required for a
    closest-hit call), so their ``node`` is a row of that table, and keep the
    canonical walk's result by the tie rule."""
    return _octant_chunk("bvh_lane_chunk", lane_chunk_plain, lane_chunk,
                         nodes, n_nodes, (ox, oy, oz, dx, dy, dz, t_min),
                         (node_in, t_in, i_in, u_in, v_in), any_hit,
                         max_steps, octants)


def _octant_chunk(fn_name, plain, wrapper, nodes, n_nodes, rays, state,
                  any_hit, max_steps, octants):
    """K3's and K6's launch: checks, the plain version on the CPU, else the
    kernel with the octant pointers."""
    dev = _check_nodes(nodes, n_nodes)
    if not any_hit:
        _check_octants(octants, n_nodes, dev)
    R = _check_resume(rays, state, max_steps, dev)
    if dev.type == "cpu":
        return plain(nodes, n_nodes, *rays, *state, any_hit=any_hit,
                     max_steps=max_steps, octants=octants)
    return _launch(fn_name, wrapper, dev, (
        nodes.data_ptr(), *_octant_ptrs(octants, any_hit), n_nodes,
        *(x.data_ptr() for x in rays + state), R, int(any_hit),
        int(max_steps)), _chunk_outputs(R, dev))


lane_chunk.launches = 0


def lane_chunk_hbm(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
                   t_in, i_in, u_in, v_in, any_hit=False, max_steps=0,
                   octants=None):
    """K6: K3's contract for trees above ``LANE_VMEM_MAX_NODES``: resume
    each lane from (node_in, t_in, i_in, u_in, v_in) for at most
    ``max_steps`` visits; closest-hit lanes on their octant's table of
    ``octants`` (required for a closest-hit call, and ``node`` is a row of
    that table), any-hit lanes on the canonical ``nodes``. Returns (t, idx,
    u, v, node)."""
    return _octant_chunk("bvh_lane_chunk_hbm", lane_chunk_hbm_plain,
                         lane_chunk_hbm, nodes, n_nodes,
                         (ox, oy, oz, dx, dy, dz, t_min),
                         (node_in, t_in, i_in, u_in, v_in), any_hit,
                         max_steps, octants)


lane_chunk_hbm.launches = 0


def lane_chunk_w(pages, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in,
                 i_in, u_in, v_in, any_hit=False, max_steps=0, page=WIDE_PAGE,
                 octants=None):
    """K9: K3's contract (resume for at most ``max_steps`` node visits) over
    wide pages of ``page`` == ``WIDE_PAGE`` nodes: any-hit lanes over the
    canonical ``pages`` of ``pack_pages_w``, closest-hit lanes over their
    octant's pages in ``octants`` (``wide_octant_pages``, required for a
    closest-hit call), so their ``node`` is a row of that octant's table,
    with the tie rule."""
    dev = pages.device
    _check_pages(pages, n_nodes, page)
    if not any_hit:
        _check_wide_octants(octants, n_nodes, dev)
    rays = (ox, oy, oz, dx, dy, dz, t_min)
    state = (node_in, t_in, i_in, u_in, v_in)
    R = _check_resume(rays, state, max_steps, dev)
    if dev.type == "cpu":
        return lane_chunk_w_plain(pages, n_nodes, *rays, *state,
                                  any_hit=any_hit, max_steps=max_steps,
                                  page=page, octants=octants)
    return _launch("bvh_lane_chunk_w", lane_chunk_w, dev, (
        pages.data_ptr(), *_octant_ptrs(octants, any_hit), page, n_nodes,
        *(x.data_ptr() for x in rays + state), R, int(any_hit),
        int(max_steps)), _chunk_outputs(R, dev))


lane_chunk_w.launches = 0


def treelet_rounds(nodes, tab, o, d, t_min, t_max, any_hit=False,
                   octants=None):
    """K7: closest hit (or, with ``any_hit``, the first hit found) of rays
    o, d (R, 3) within (t_min, t_max) (R,), walking one treelet at a time in
    the order of ``_treelet_rounds``: the nearest root box (``tab``, (K, 24),
    ``treelet_table``) the ray enters before its best hit, lowest index on a
    tie. Any-hit lanes walk the treelet's rows [root, skip) of the canonical
    table ``nodes`` (N, 12); closest-hit lanes walk its range in their
    octant's table of ``octants`` (required for a closest-hit call) with the
    tie rule. Returns (hit, t, idx, u, v) as K4 does; a lane with t_max <=
    t_min misses."""
    dev = nodes.device
    N = _check_table("nodes", nodes, NODE_COLS, dev)
    K = tab.shape[0] if tab.dim() == 2 else 0
    if not 0 < K <= MAX_TREELETS:
        raise ValueError(f"{K} treelets; K7 takes 1..{MAX_TREELETS}")
    _check("tab", tab, torch.float32, (K, TREELET_COLS), dev)
    if not any_hit:
        _check_octants(octants, N, dev)
    R = _check_root_rays(o, d, t_min, t_max, dev)
    if dev.type == "cpu":
        return treelet_rounds_plain(nodes, tab, o, d, t_min, t_max,
                                    any_hit=any_hit, octants=octants)
    return _launch("bvh_treelet_rounds", treelet_rounds, dev, (
        nodes.data_ptr(), *_octant_ptrs(octants, any_hit), N, tab.data_ptr(),
        K, o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), R,
        int(any_hit)),
        _root_outputs(R, dev))


treelet_rounds.launches = 0


def _check_fat_tables(tables):
    """A ``FatTables`` whose three tables lie on one device and agree in
    shape; returns (device, N)."""
    if not isinstance(tables, FatTables):
        raise ValueError("K8 walks its split tables: pass "
                         "cuda_bvh.fat_tables(fat rows), not the fat rows")
    dev = tables.heads.device
    N = _check_table("tables.heads", tables.heads, HEAD_COLS, dev)
    S = tables.tris.shape[0] if tables.tris.dim() == 2 else 0
    if not 0 < S < MAX_NODES:
        raise ValueError(f"tables.tris has {S} slots; K8 takes 1..2^24-1")
    _check("tables.tris", tables.tris, torch.float32, (S, SLOT_COLS), dev)
    _check("tables.octant_heads", tables.octant_heads, torch.float32,
           (OCTANTS, N, HEAD_COLS), dev)
    if dev.type == "cuda" and (tables.tris.data_ptr() % 16
                               or tables.octant_heads.data_ptr() % 16):
        raise ValueError("K8's tables must be 16-byte aligned (float4 loads)")
    return dev, N


def bvh_traverse_packed(tables, o, d, t_min, t_max, start=None, end=None,
                        any_hit=False):
    """K8: closest hit (or the first hit of the canonical walk) of rays o, d
    (R, 3) within (t_min, t_max) over a leaf-4 tree's split tables
    ``tables`` (``fat_tables``). Optional per-ray ``start``/``end`` (R,)
    int32 restrict each lane to the canonical node range [start, end) (a
    subtree is such a range); a lane with start >= end or start outside [0,
    N) is dead. Closest-hit lanes without a range walk their direction
    octant's near-first heads with the slot-index tie rule, the others the
    canonical heads, each query kind (and bounded or not) in an
    instantiation of its own. Returns (hit, t, idx, u, v): the JAX K8's."""
    dev, N = _check_fat_tables(tables)
    R = _check_root_rays(o, d, t_min, t_max, dev)
    if (start is None) != (end is None):
        raise ValueError("pass both start and end, or neither")
    if start is not None:
        _check("start", start, torch.int32, (R,), dev)
        _check("end", end, torch.int32, (R,), dev)
    if dev.type == "cpu":
        return bvh_traverse_packed_plain(tables, o, d, t_min, t_max, start,
                                         end, any_hit=any_hit)
    bounds = (None, None) if start is None else (start.data_ptr(),
                                                 end.data_ptr())
    return _launch("bvh_fat_packed", bvh_traverse_packed, dev, (
        tables.heads.data_ptr(), tables.octant_heads.data_ptr(),
        tables.tris.data_ptr(), N, o.data_ptr(), d.data_ptr(),
        t_min.data_ptr(), t_max.data_ptr(), *bounds, R, int(any_hit)),
        _root_outputs(R, dev))


bvh_traverse_packed.launches = 0


# === queries (sort, launches, re-sorts, unsort) ============================

def sort_rays(o, d, t_min, t_max, scene_lo, scene_hi):
    """Rays sorted by ``ray_sort_keys``, dead lanes last: (ox, oy, oz, dx,
    dy, dz, t_min, t_max) and the original lane of each."""
    key = ray_sort_keys(o, d, scene_lo, scene_hi)
    key = torch.where(t_max <= t_min, 0xFFFFFFFF, key)
    orig = torch.argsort(key, stable=True)
    cols = tuple(o[orig, k] for k in range(3)) + tuple(d[orig, k] for k in range(3))
    return cols + (t_min[orig], t_max[orig]), orig


def _unsort(orig, *xs):
    out = []
    for x in xs:
        y = torch.empty_like(x)
        y[orig] = x
        out.append(y)
    return out


def _hit_result(bt, bi, bu, bv):
    hit = bi >= 0
    return hit, torch.where(hit, bt, torch.inf), bi, bu, bv


def _resort(chunk, nodes, n_nodes, o, d, t_min, t_max, scene_lo, scene_hi,
            any_hit, strip, rounds, chunk_nit):
    R = o.shape[0]
    (*rays, tmx), orig = sort_rays(o, d, t_min, t_max, scene_lo, scene_hi)
    rays = tuple(rays)
    node = torch.where(tmx > rays[6], 0, n_nodes).to(torch.int32)
    state = (node, tmx, torch.full((R,), -1, dtype=torch.int32, device=o.device),
             torch.zeros(R, device=o.device), torch.zeros(R, device=o.device))
    for _ in range(rounds):
        bt, bi, bu, bv, node = chunk(nodes, n_nodes, *rays, *state,
                                     any_hit=any_hit,
                                     max_steps=chunk_nit * strip)
        # lanes on nearby nodes next to each other for the next chunk
        perm = torch.argsort(node, stable=True)
        rays = tuple(x[perm] for x in rays)
        state = tuple(x[perm] for x in (node, bt, bi, bu, bv))
        orig = orig[perm]
    bt, bi, bu, bv, _ = chunk(nodes, n_nodes, *rays, *state, any_hit=any_hit,
                              max_steps=0)
    return _hit_result(*_unsort(orig, bt, bi, bu, bv))


def bvh_traverse_lane_resort(nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                             scene_hi, any_hit=False, strip=LSTRIP, rounds=2,
                             chunk_nit=48, octants=None):
    """Traversal with mid-traversal re-sorts (pallas_bvh.py:1203): sort the
    rays by ``ray_sort_keys``; ``rounds`` K3 launches of ``chunk_nit * strip``
    node visits, each followed by a re-sort by node pointer; a final
    unbounded K3 launch; unsort. Closest-hit queries need ``octants``.
    Returns (hit, t, idx, u, v); the result does not depend on the
    schedule."""
    def chunk(*args, **kw):
        return lane_chunk(*args, octants=octants, **kw)
    return _resort(chunk, nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                   scene_hi, any_hit, strip, rounds, chunk_nit)


def bvh_traverse_lane_hbm_resort(nodes, n_nodes, o, d, t_min, t_max,
                                 scene_lo, scene_hi, any_hit=False,
                                 strip=LSTRIP, rounds=3, chunk_nit=24,
                                 octants=None):
    """``bvh_traverse_lane_resort`` through K6 (pallas_bvh.py:1587); a
    closest-hit query needs ``octants``. Returns (hit, t, idx, u, v); the
    result does not depend on the schedule."""
    def chunk(*args, **kw):
        return lane_chunk_hbm(*args, octants=octants, **kw)
    return _resort(chunk, nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                   scene_hi, any_hit, strip, rounds, chunk_nit)


def _traverse_root(kernel, nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                   scene_hi, sort, any_hit, **kw):
    if not sort:
        return kernel(nodes, n_nodes, o, d, t_min, t_max, any_hit=any_hit,
                      **kw)
    (*rays, tmx), orig = sort_rays(o, d, t_min, t_max, scene_lo, scene_hi)
    res = kernel(nodes, n_nodes, torch.stack(rays[0:3], -1),
                 torch.stack(rays[3:6], -1), rays[6], tmx, any_hit=any_hit,
                 **kw)
    return tuple(_unsort(orig, *res))


def bvh_traverse_lane(nodes, n_nodes, o, d, t_min, t_max, scene_lo, scene_hi,
                      *, sort, any_hit=False):
    """K4 with an optional coherence sort (sort -> traverse -> unsort;
    pallas_bvh.py:1255). Returns (hit, t, idx, u, v)."""
    return _traverse_root(bvh_traverse_lane_packed, nodes, n_nodes, o, d,
                          t_min, t_max, scene_lo, scene_hi, sort, any_hit)


def bvh_traverse_lane_hbm(nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                          scene_hi, *, sort, any_hit=False, octants=None):
    """K5 with an optional coherence sort (pallas_bvh.py:1423); a
    closest-hit query needs ``octants`` (the sort key's top bits group the
    rays by octant, so a launch walks the tables one after another).
    Returns (hit, t, idx, u, v)."""
    return _traverse_root(lane_hbm, nodes, n_nodes, o, d, t_min, t_max,
                          scene_lo, scene_hi, sort, any_hit, octants=octants)


def bvh_traverse_lane_resort_w(pages, n_nodes, o, d, t_min, t_max, scene_lo,
                               scene_hi, any_hit=False, strip=LSTRIP, rounds=2,
                               chunk_nit=16, page=WIDE_PAGE, octants=None):
    """``bvh_traverse_lane_resort`` through K9 over wide pages
    (pallas_bvh.py:1870): sort, ``rounds`` K9 launches of ``chunk_nit *
    strip`` node visits with a re-sort by node pointer after each, a final
    unbounded launch, unsort; a closest-hit query needs ``octants``
    (``wide_octant_pages``). Returns (hit, t, idx, u, v); the result does
    not depend on the schedule."""
    def chunk(*args, **kw):
        return lane_chunk_w(*args, page=page, octants=octants, **kw)
    return _resort(chunk, pages, n_nodes, o, d, t_min, t_max, scene_lo,
                   scene_hi, any_hit, strip, rounds, chunk_nit)


def bvh_traverse_treelets(nodes, tl_root, tl_skip, tl_lo, tl_hi, o, d, t_min,
                          t_max, scene_lo, scene_hi, sort=True, any_hit=False,
                          *, octants):
    """Two-level traversal through K7 (pallas_bvh.py:514): with ``sort``,
    the rays are sorted once by ``treelet_sort_keys`` (nearest treelet,
    octant, origin Morton code; dead lanes last), traversed by one K7
    launch and unsorted. ``tl_*`` are the treelets' root rows, skip links
    and root boxes (``accel.build.treelet_roots``); ``octants`` the tree's
    octant tables with their treelet ranges. Returns (hit, t, idx, u, v);
    the result does not depend on the order."""
    tab = treelet_table(tl_root, tl_skip, tl_lo, tl_hi, octants.tl_range)
    if not sort:
        return treelet_rounds(nodes, tab, o, d, t_min, t_max, any_hit=any_hit,
                              octants=octants)
    key = treelet_sort_keys(o, d, t_min, t_max, tl_lo, tl_hi, scene_lo,
                            scene_hi)
    orig = torch.argsort(key, stable=True)
    res = treelet_rounds(nodes, tab, o[orig], d[orig], t_min[orig],
                         t_max[orig], any_hit=any_hit, octants=octants)
    return tuple(_unsort(orig, *res))


def bvh_traverse(tables, o, d, t_min, t_max, scene_lo, scene_hi, sort=True,
                 any_hit=False):
    """K8 over its split tables ``tables`` (``fat_tables``) with an optional
    coherence sort (sort -> traverse -> unsort; pallas_bvh.py:339). Returns
    (hit, t, idx, u, v)."""
    if not sort:
        return bvh_traverse_packed(tables, o, d, t_min, t_max, any_hit=any_hit)
    (*rays, tmx), orig = sort_rays(o, d, t_min, t_max, scene_lo, scene_hi)
    res = bvh_traverse_packed(tables, torch.stack(rays[0:3], -1),
                              torch.stack(rays[3:6], -1), rays[6], tmx,
                              any_hit=any_hit)
    return tuple(_unsort(orig, *res))
