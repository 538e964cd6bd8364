"""Threaded-BVH traversal: the CUDA kernels K3-K6 (``csrc/bvh_lane.cu``),
their wrappers, their plain versions, the node packer, the coherence sort key
and the query functions around them (the counterpart of
``mitsuba_tpu/ops/pallas_bvh.py``).

    K3 ``lane_chunk``                <- ``_lane_chunk`` (pallas_bvh.py:1132)
    K4 ``bvh_traverse_lane_packed``  <- ``bvh_traverse_lane_packed`` (:1052)
    K5 ``lane_hbm``                  <- the kernel of ``bvh_traverse_lane_hbm``
                                        (:1423)
    K6 ``lane_chunk_hbm``            <- ``_lane_chunk_hbm`` (:1514)

The TPU's page-planar table (``pack_pages``) exists because Mosaic has no
per-lane gather; here each CUDA thread follows its own skip link through a
node-major table of ``(N, 12)`` float32 (``pack_nodes``; three float4s per
node, see the source note in ``bvh_lane.cu``). K4/K5 walk from the root; K3/K6
resume from per-lane state ``(node, t, idx, u, v)`` for at most ``max_steps``
node visits (0: to the end). On the H100 there is no VMEM/HBM split: K5 and K6
run K4's and K3's code, on trees above ``LANE_VMEM_MAX_NODES``.

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

import numpy as np
import torch

from . import build

NODE_COLS = 12    # lo.xyz skip | hi.xyz tri | e2.xyz 0 (three float4s)
MAX_NODES = 1 << 24   # skip links and triangle ids are exact float32 values
LSTRIP = 10       # the TPU schedule's strip (pallas_bvh.py:893)
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
        for fn, args in ((lib.bvh_lane_packed, root), (lib.bvh_lane_hbm, root),
                         (lib.bvh_lane_chunk, chunk),
                         (lib.bvh_lane_chunk_hbm, chunk)):
            fn.argtypes = args
            fn.restype = _I
    return lib


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
    if N >= MAX_NODES or len(p0) >= MAX_NODES:
        raise ValueError(f"{N} nodes / {len(p0)} triangles: ids must stay "
                         f"below 2^24 to be exact in float32")
    leaf = counts > 0
    tri = np.where(leaf, bvh.prim_order[np.maximum(bvh.prim_first, 0)], -1)
    nodes = np.zeros((N, NODE_COLS), np.float32)
    nodes[:, 0:3] = np.where(leaf[:, None], p0[np.maximum(tri, 0)], bvh.lo)
    nodes[:, 4:7] = np.where(leaf[:, None], e1[np.maximum(tri, 0)], bvh.hi)
    nodes[:, 8:11] = np.where(leaf[:, None], e2[np.maximum(tri, 0)], 0.0)
    nodes[:, 3] = bvh.skip.astype(np.float32)
    nodes[:, 7] = tri.astype(np.float32)
    return nodes


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
    dev = nodes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no BVH traversal for device {dev}")
    if not 0 < n_nodes < MAX_NODES:
        raise ValueError(f"{n_nodes} nodes; the lane kernels take 1..2^24-1")
    _check("nodes", nodes, torch.float32, (n_nodes, NODE_COLS), dev)
    if dev.type == "cuda" and nodes.data_ptr() % 16:
        raise ValueError("nodes must be 16-byte aligned (float4 loads)")
    return dev


def _check_count(R):
    if 3 * R >= 2 ** 31:
        raise ValueError(f"{R} rays exceed the kernels' int32 index range")


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


def _walk_plain(nodes, n_nodes, rays, node, bt, bi, bu, bv, any_hit,
                max_steps):
    """The kernels' per-lane walk in tensor form. ``rays`` = (ox, oy, oz, dx,
    dy, dz, t_min), each (R,). Each step advances every lane that is still
    walking by one node, with the kernel's operations in the kernel's order.
    Returns the new (node, t, idx, u, v) and the visits: per-lane internal
    and leaf visit counts (int64) and which nodes were read at all ((N,)
    bool)."""
    ox, oy, oz, dx, dy, dz, t_min = rays
    node, bt, bi, bu, bv = (x.clone() for x in (node, bt, bi, bu, bv))
    inx, iny, inz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    v_int = torch.zeros(node.shape, dtype=torch.int64, device=node.device)
    v_leaf = torch.zeros_like(v_int)
    touched = torch.zeros(n_nodes, dtype=torch.bool, device=node.device)
    lane = torch.nonzero(node < n_nodes).squeeze(1)
    while lane.numel():
        n = node[lane].to(torch.int64)
        touched[n] = True
        row = nodes[n]
        g = [row[:, c] for c in range(NODE_COLS)]
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
        h = (leaf & ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt > tmin) & (tt < best))
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
    return (node, bt, bi, bu, bv), (v_int, v_leaf, touched)


def _root_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit, with_visits):
    R = o.shape[0]
    dev = o.device
    node = torch.where(t_max > t_min, 0, n_nodes).to(torch.int32)
    rays = tuple(o[:, k] for k in range(3)) + tuple(d[:, k] for k in range(3))
    (_, bt, bi, bu, bv), visits = _walk_plain(
        nodes, n_nodes, rays + (t_min,), node, t_max,
        torch.full((R,), -1, dtype=torch.int32, device=dev),
        torch.zeros(R, device=dev), torch.zeros(R, device=dev), any_hit, 0)
    hit = bi >= 0
    out = (hit, torch.where(hit, bt, torch.inf), bi, bu, bv)
    return out + (visits,) if with_visits else out


def bvh_traverse_lane_packed_plain(nodes, n_nodes, o, d, t_min, t_max,
                                   any_hit=False, with_visits=False):
    """Plain PyTorch version of K4: (hit, t, idx, u, v), and with
    ``with_visits`` the visits (per-lane internal and leaf counts, nodes
    read)."""
    return _root_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit,
                       with_visits)


def lane_hbm_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit=False,
                   with_visits=False):
    """Plain PyTorch version of K5 (the same walk as K4)."""
    return _root_plain(nodes, n_nodes, o, d, t_min, t_max, any_hit,
                       with_visits)


def _chunk_plain(nodes, n_nodes, rays, state, any_hit, max_steps,
                 with_visits):
    (node, bt, bi, bu, bv), visits = _walk_plain(
        nodes, n_nodes, rays, *state, any_hit, max_steps)
    out = (bt, bi, bu, bv, node)
    return out + (visits,) if with_visits else out


def lane_chunk_plain(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
                     t_in, i_in, u_in, v_in, any_hit=False, max_steps=0,
                     with_visits=False):
    """Plain PyTorch version of K3: (t, idx, u, v, node) after at most
    ``max_steps`` visits per lane, and with ``with_visits`` this call's
    visits (per-lane internal and leaf counts, nodes read)."""
    return _chunk_plain(nodes, n_nodes, (ox, oy, oz, dx, dy, dz, t_min),
                        (node_in, t_in, i_in, u_in, v_in), any_hit, max_steps,
                        with_visits)


def lane_chunk_hbm_plain(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min,
                         node_in, t_in, i_in, u_in, v_in, any_hit=False,
                         max_steps=0, with_visits=False):
    """Plain PyTorch version of K6 (the same walk as K3)."""
    return _chunk_plain(nodes, n_nodes, (ox, oy, oz, dx, dy, dz, t_min),
                        (node_in, t_in, i_in, u_in, v_in), any_hit, max_steps,
                        with_visits)


# === kernel wrappers =======================================================

def _launch_root(fn_name, plain, wrapper, nodes, n_nodes, o, d, t_min, t_max,
                 any_hit):
    dev = _check_nodes(nodes, n_nodes)
    R = _check_root_rays(o, d, t_min, t_max, dev)
    if dev.type == "cpu":
        return plain(nodes, n_nodes, o, d, t_min, t_max, any_hit=any_hit)
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    t, u, v = (torch.empty(R, dtype=torch.float32, device=dev) for _ in range(3))
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return hit, t, idx, u, v
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_lib(), fn_name)(
            nodes.data_ptr(), n_nodes, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), R, int(any_hit),
            hit.data_ptr(), t.data_ptr(), idx.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")
    wrapper.launches += 1
    return hit, t, idx, u, v


def bvh_traverse_lane_packed(nodes, n_nodes, o, d, t_min, t_max,
                             any_hit=False):
    """K4: closest hit (or, with ``any_hit``, the first hit found) of rays
    o, d (R, 3) within (t_min, t_max) (R,), walking from the root.

    Returns (hit bool, t float32 (inf on a miss), idx int32 original triangle
    id (-1 on a miss), u, v float32 (0 on a miss)), each (R,). A lane with
    t_max <= t_min is dead and misses."""
    return _launch_root("bvh_lane_packed", bvh_traverse_lane_packed_plain,
                        bvh_traverse_lane_packed, nodes, n_nodes, o, d, t_min,
                        t_max, any_hit)


bvh_traverse_lane_packed.launches = 0


def lane_hbm(nodes, n_nodes, o, d, t_min, t_max, any_hit=False):
    """K5: K4 for trees above ``LANE_VMEM_MAX_NODES``; same contract."""
    return _launch_root("bvh_lane_hbm", lane_hbm_plain, lane_hbm, nodes,
                        n_nodes, o, d, t_min, t_max, any_hit)


lane_hbm.launches = 0


def _launch_chunk(fn_name, plain, wrapper, nodes, n_nodes, rays, state,
                  any_hit, max_steps):
    dev = _check_nodes(nodes, n_nodes)
    R = _check_chunk_state(rays, state, dev)
    if max_steps < 0:
        raise ValueError(f"max_steps {max_steps} < 0")
    if dev.type == "cpu":
        return plain(nodes, n_nodes, *rays, *state, any_hit=any_hit,
                     max_steps=max_steps)
    t, u, v = (torch.empty(R, dtype=torch.float32, device=dev) for _ in range(3))
    idx, node = (torch.empty(R, dtype=torch.int32, device=dev) for _ in range(2))
    if R == 0:
        return t, idx, u, v, node
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_lib(), fn_name)(
            nodes.data_ptr(), n_nodes, *(x.data_ptr() for x in rays + state),
            R, int(any_hit), int(max_steps), t.data_ptr(), idx.data_ptr(),
            u.data_ptr(), v.data_ptr(), node.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")
    wrapper.launches += 1
    return t, idx, u, v, node


def lane_chunk(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in,
               i_in, u_in, v_in, any_hit=False, max_steps=0):
    """K3: resume each lane's walk from (node_in, t_in, i_in, u_in, v_in) for
    at most ``max_steps`` node visits (0: to the end). Rays come as one (R,)
    float32 array per component; node and idx are int32. ``t_in`` is the
    search bound (the best hit so far, or t_max). Returns the updated
    (t, idx, u, v, node); a lane is done when node >= n_nodes."""
    return _launch_chunk("bvh_lane_chunk", lane_chunk_plain, lane_chunk, nodes,
                         n_nodes, (ox, oy, oz, dx, dy, dz, t_min),
                         (node_in, t_in, i_in, u_in, v_in), any_hit, max_steps)


lane_chunk.launches = 0


def lane_chunk_hbm(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
                   t_in, i_in, u_in, v_in, any_hit=False, max_steps=0):
    """K6: K3 for trees above ``LANE_VMEM_MAX_NODES``; same contract."""
    return _launch_chunk("bvh_lane_chunk_hbm", lane_chunk_hbm_plain,
                         lane_chunk_hbm, nodes, n_nodes,
                         (ox, oy, oz, dx, dy, dz, t_min),
                         (node_in, t_in, i_in, u_in, v_in), any_hit, max_steps)


lane_chunk_hbm.launches = 0


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
                             chunk_nit=48):
    """Traversal with mid-traversal re-sorts (pallas_bvh.py:1203): sort the
    rays by ``ray_sort_keys``; ``rounds`` K3 launches of ``chunk_nit * strip``
    node visits, each followed by a re-sort by node pointer; a final
    unbounded K3 launch; unsort. Returns (hit, t, idx, u, v); the result
    does not depend on the schedule."""
    return _resort(lane_chunk, nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                   scene_hi, any_hit, strip, rounds, chunk_nit)


def bvh_traverse_lane_hbm_resort(nodes, n_nodes, o, d, t_min, t_max,
                                 scene_lo, scene_hi, any_hit=False,
                                 strip=LSTRIP, rounds=3, chunk_nit=24):
    """``bvh_traverse_lane_resort`` through K6 (pallas_bvh.py:1587)."""
    return _resort(lane_chunk_hbm, nodes, n_nodes, o, d, t_min, t_max,
                   scene_lo, scene_hi, any_hit, strip, rounds, chunk_nit)


def _traverse_root(kernel, nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                   scene_hi, sort, any_hit):
    if not sort:
        return kernel(nodes, n_nodes, o, d, t_min, t_max, any_hit=any_hit)
    (*rays, tmx), orig = sort_rays(o, d, t_min, t_max, scene_lo, scene_hi)
    res = kernel(nodes, n_nodes, torch.stack(rays[0:3], -1),
                 torch.stack(rays[3:6], -1), rays[6], tmx, any_hit=any_hit)
    return tuple(_unsort(orig, *res))


def bvh_traverse_lane(nodes, n_nodes, o, d, t_min, t_max, scene_lo, scene_hi,
                      *, sort, any_hit=False):
    """K4 with an optional coherence sort (sort -> traverse -> unsort;
    pallas_bvh.py:1255). Returns (hit, t, idx, u, v)."""
    return _traverse_root(bvh_traverse_lane_packed, nodes, n_nodes, o, d,
                          t_min, t_max, scene_lo, scene_hi, sort, any_hit)


def bvh_traverse_lane_hbm(nodes, n_nodes, o, d, t_min, t_max, scene_lo,
                          scene_hi, *, sort, any_hit=False):
    """K5 with an optional coherence sort (pallas_bvh.py:1423)."""
    return _traverse_root(lane_hbm, nodes, n_nodes, o, d, t_min, t_max,
                          scene_lo, scene_hi, sort, any_hit)
