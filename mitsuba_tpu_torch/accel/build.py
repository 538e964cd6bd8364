"""Binned-SAH BVH builder and treelet cut, host side (a copy of
``mitsuba_tpu/accel/build.py``).

The BVH is flattened into a threaded node stream: every node carries a skip
(miss) link to the next node in depth-first order, so traversal needs no
stack: each ray walks ``node = hit ? node + 1 : skip[node]``. Centroids are
binned (16 bins) on each axis and the cheapest SAH split wins, with a median
split when every centroid coincides. Both the numpy builder and the C++ one
(``native/bvh.cpp``) give the JAX package's trees, array for array.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# one triangle per leaf: the tree of the scene and of every kernel but K8,
# whose fat rows hold up to four (ops/cuda_bvh.FAT_LEAF_SIZE)
LEAF_SIZE = 1
N_BINS = 16
# the JAX package's threshold for its C++ builder (accel/build.py:50)
NATIVE_MIN_PRIMS = 4096


class BVH(NamedTuple):
    """Flattened threaded BVH. N nodes in DFS order.

    * internal node i: children occupy [i+1 ...]; on AABB hit continue at
      i+1, on miss jump to skip[i].
    * leaf node i: prim_first[i] >= 0; owns prim_order[first : first+count].
    * skip == num_nodes means "done".
    """

    lo: np.ndarray          # (N, 3) float32 AABB min
    hi: np.ndarray          # (N, 3) float32 AABB max
    skip: np.ndarray        # (N,)  int32 miss link
    prim_first: np.ndarray  # (N,)  int32; -1 for internal nodes
    prim_count: np.ndarray  # (N,)  int32
    prim_order: np.ndarray  # (T,)  int32 permutation of input primitives


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> BVH:
    """Build a tree of at most ``leaf_size`` primitives per leaf from
    per-primitive AABBs (T, 3)/(T, 3).

    Meshes of ``NATIVE_MIN_PRIMS`` primitives or more go to the C++ builder
    (``native/bvh.cpp``), which raises if it cannot be built; smaller ones to
    the numpy builder. The output layout is the same either way.
    """
    if prim_lo.shape[0] >= NATIVE_MIN_PRIMS:
        from ..native import build_bvh_native

        return BVH(*build_bvh_native(np.asarray(prim_lo), np.asarray(prim_hi),
                                     leaf_size))
    return _build_bvh_numpy(prim_lo, prim_hi, leaf_size)


def _build_bvh_numpy(prim_lo: np.ndarray, prim_hi: np.ndarray,
                     leaf_size: int = LEAF_SIZE) -> BVH:
    """Pure-numpy builder (the JAX package's, arithmetic for arithmetic)."""
    T = prim_lo.shape[0]
    assert T > 0
    prim_lo = prim_lo.astype(np.float64)
    prim_hi = prim_hi.astype(np.float64)
    centroid = 0.5 * (prim_lo + prim_hi)

    # tree assembly buffers (object-free: parallel arrays, grown on demand)
    node_lo, node_hi, node_left, node_first, node_count = [], [], [], [], []

    def new_node():
        node_lo.append(None)
        node_hi.append(None)
        node_left.append(-1)   # index of left child (right = DFS after left subtree)
        node_first.append(-1)
        node_count.append(0)
        return len(node_lo) - 1

    root = new_node()
    # stack of (node_idx, prim index array)
    stack = [(root, np.arange(T))]
    order: list[np.ndarray] = []
    order_pos = 0

    while stack:
        node, idx = stack.pop()
        lo = prim_lo[idx].min(axis=0)
        hi = prim_hi[idx].max(axis=0)
        node_lo[node] = lo
        node_hi[node] = hi
        n = len(idx)
        if n <= leaf_size:
            node_first[node] = order_pos
            node_count[node] = n
            order.append(idx)
            order_pos += n
            continue

        c = centroid[idx]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        extent = c_hi - c_lo
        best = None  # (cost, axis, mask_left)
        for axis in range(3):
            if extent[axis] < 1e-12:
                continue
            rel = (c[:, axis] - c_lo[axis]) / extent[axis]
            bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
            # per-bin counts and bounds via np.minimum.at / maximum.at
            cnt = np.bincount(bins, minlength=N_BINS)
            blo = np.full((N_BINS, 3), np.inf)
            bhi = np.full((N_BINS, 3), -np.inf)
            np.minimum.at(blo, bins, prim_lo[idx])
            np.maximum.at(bhi, bins, prim_hi[idx])
            # prefix/suffix sweep
            cnt_l = np.cumsum(cnt)[:-1]
            cnt_r = n - cnt_l
            lo_l = np.minimum.accumulate(blo, axis=0)[:-1]
            hi_l = np.maximum.accumulate(bhi, axis=0)[:-1]
            lo_r = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
            hi_r = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]

            def area(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            with np.errstate(invalid="ignore"):
                cost = area(lo_l, hi_l) * cnt_l + area(lo_r, hi_r) * cnt_r
            cost = np.where((cnt_l == 0) | (cnt_r == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                best = (cost[k], axis, bins <= k)

        if best is None:
            # all centroids coincide: median split by original order
            mask_left = np.zeros(n, dtype=bool)
            mask_left[: n // 2] = True
        else:
            mask_left = best[2]

        left_idx = idx[mask_left]
        right_idx = idx[~mask_left]
        l = new_node()
        node_left[node] = l
        r = new_node()
        # DFS order: left subtree fully emitted before right — push right first
        stack.append((r, right_idx))
        stack.append((l, left_idx))

    # The builder above allocates children as consecutive ids but DFS order
    # requires the whole left subtree before the right child; re-emit in DFS.
    n_nodes = len(node_lo)
    left_arr = np.array(node_left, dtype=np.int64)
    dfs_index = np.full(n_nodes, -1, dtype=np.int64)
    dfs_nodes: list[int] = []

    # children ids: left child = node_left[i]; right child = node_left[i]+1
    # (new_node() calls for l and r are consecutive).
    stack2 = [root]
    while stack2:
        nd = stack2.pop()
        dfs_index[nd] = len(dfs_nodes)
        dfs_nodes.append(nd)
        if left_arr[nd] >= 0:
            stack2.append(left_arr[nd] + 1)  # right pushed first -> visited after left subtree
            stack2.append(left_arr[nd])

    N = n_nodes
    lo_out = np.empty((N, 3), dtype=np.float32)
    hi_out = np.empty((N, 3), dtype=np.float32)
    skip_out = np.empty(N, dtype=np.int32)
    first_out = np.empty(N, dtype=np.int32)
    count_out = np.empty(N, dtype=np.int32)

    # subtree sizes to compute skip links: skip(i) = i + subtree_size(i)
    size = np.ones(n_nodes, dtype=np.int64)
    for nd in reversed(dfs_nodes):
        if left_arr[nd] >= 0:
            size[nd] = 1 + size[left_arr[nd]] + size[left_arr[nd] + 1]

    for pos, nd in enumerate(dfs_nodes):
        lo_out[pos] = node_lo[nd]
        hi_out[pos] = node_hi[nd]
        skip_out[pos] = pos + size[nd]
        first_out[pos] = node_first[nd]
        count_out[pos] = node_count[nd]

    prim_order = np.concatenate(order).astype(np.int32) if order else np.empty(0, np.int32)
    assert prim_order.shape[0] == T
    return BVH(
        lo=lo_out, hi=hi_out, skip=skip_out,
        prim_first=first_out, prim_count=count_out, prim_order=prim_order,
    )


def treelet_roots(bvh: BVH, max_nodes: int = 1024,
                  max_roots: int = 128) -> np.ndarray:
    """Cut the preorder node stream into treelets: subtrees of at most
    ``max_nodes`` rows whose parents exceed it. In the threaded DFS layout a
    subtree rooted at i is exactly the row range [i, skip[i]), so bounding a
    walk to a treelet is a per-lane range clamp (K7, ops/cuda_bvh.py).

    Walk: descend internal nodes until the subtree fits, emit, jump to its
    skip. ``max_nodes`` is doubled until at most ``max_roots`` treelets
    result (K7 keeps the treelet table in shared memory)."""
    N = len(bvh.skip)
    while True:
        roots = []
        i = 0
        while i < N:
            if bvh.skip[i] - i <= max_nodes:
                roots.append(i)
                i = int(bvh.skip[i])
            else:
                i += 1
        if len(roots) <= max_roots:
            return np.asarray(roots, np.int32)
        max_nodes *= 2


def triangle_aabbs(p0, p1, p2):
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    return lo, hi
