"""Brute-force closest hit over a small triangle soup: the CUDA kernels K1
and K2 (``csrc/brute_force.cu``), their wrappers and their plain versions.

K1 ``brute_force_interaction`` replaces the Pallas kernel
``mitsuba_tpu/ops/pallas_intersect.py:brute_force_interaction`` and K2
``brute_force_closest_hit`` replaces ``brute_force_closest_hit`` there; both
TPU kernels share the loop body ``_mt_loop``.

What bounds them on an H100: fp32 instruction issue. A test is 46
operations; built without FMA contraction (so that they round like the
plain versions) they cannot go below 46 operations per live test at half
the 67 TFLOP/s peak, twice the bound (13.0 us for the Cornell box's
262,144 camera rays x 36 triangles, 1.47 ms at the 4,096-triangle
contract). What the design does about it (the note in ``brute_force.cu``
has it in full): each block packs its live rays (t_max > t_min) into a
dense list, so warps past the live count skip the loop; each thread tests
two rays against every triangle row it loads, and the rows are staged in
shared memory as float4s, read once per warp for both tests; the
reciprocal's exact division runs only when a divisor leaves the range of
ptxas's fast path; results go out by slot at the end, in whole rows. The
design choices that lost, with their times, are in that note and in
``PERF.md`` (``scripts/torch_bf_sweep.py``).

Each wrapper checks its inputs (one device, dtype, shape, contiguity) on
either device, so the CPU tests hold callers to the kernel's contract. On
CUDA tensors it then allocates the outputs, launches its kernel on the current
stream and counts the launch in its ``launches`` attribute; it never falls
back and does no per-call packing: the kernel stages its own rows from the
(T, 3) arrays. On CPU tensors it runs the plain version (``*_plain``), which
repeats the kernel's float32 arithmetic operation by operation (the kernels
are compiled without FMA contraction), so the two agree exactly on hit and
idx.

The plain versions follow the kernel, not ``ops/intersect.py``: the kernel
inverts the determinant as ``1 / where(|det| > 1e-12, det, 1)`` where the
XLA form uses ``safe_div``. Ties go to the lowest triangle index. A dead
lane (t_max <= t_min, or either NaN) is a miss.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_TRIS = 4096  # the TPU kernel's VMEM contract (pallas_intersect.py:34)
_PLAIN_CHUNK = 64  # triangles per plain-version step (bounds (R, chunk) temporaries)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("brute_force")
    if lib.bf_closest_hit.argtypes is None:
        lib.bf_closest_hit.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _I,
                                       _P, _P, _P, _P, _P, _P]
        lib.bf_closest_hit.restype = _I
        lib.bf_interaction.argtypes = ([_P] * 13 + [_I] + [_P] * 4 + [_I]
                                       + [_P] * 12)
        lib.bf_interaction.restype = _I
        lib.bf_kernel_occupancy.argtypes = [_I, _I, _P, _P, _P]
        lib.bf_kernel_occupancy.restype = _I
        lib.bf_rcp_mismatches.argtypes = [_P, _P]
        lib.bf_rcp_mismatches.restype = _I
    return lib


def reciprocal_mismatches(device):
    """The number of floats x with 2^-126 <= |x| < 2^126 on which the
    kernels' fast reciprocal differs from 1.0f / x on the card: a check
    that the kernels' inverse determinant is correctly rounded (0 when it
    is). Synchronizes."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(bad.device):
        rc = _lib().bf_rcp_mismatches(
            bad.data_ptr(), torch.cuda.current_stream(bad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bf_rcp_mismatches launch failed: cudaError {rc}")
    return int(bad.item())


def kernel_occupancy(name, T):
    """(registers per thread, resident blocks per SM, threads per block) of
    ``brute_force_closest_hit`` (K2) or ``brute_force_interaction`` (K1) at
    T triangles (which set the shared-memory tile) on the current card."""
    regs, blocks, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    which = ("brute_force_closest_hit", "brute_force_interaction").index(name)
    rc = _lib().bf_kernel_occupancy(which, T, ctypes.byref(regs),
                                    ctypes.byref(blocks), ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(f"bf_kernel_occupancy failed: cudaError {rc}")
    return regs.value, blocks.value, threads.value


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_rays(o, d, t_min, t_max, device):
    R = o.shape[0]
    f32 = torch.float32
    _check("o", o, f32, (R, 3), device)
    _check("d", d, f32, (R, 3), device)
    _check("t_min", t_min, f32, (R,), device)
    _check("t_max", t_max, f32, (R,), device)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays exceed the kernel's int32 index range")
    return R


def _check_tris(p0, e1, e2, device):
    T = p0.shape[0]
    if not 1 <= T <= MAX_TRIS:
        raise ValueError(f"{T} triangles; the brute-force kernels take 1..{MAX_TRIS}")
    for name, x in (("p0", p0), ("e1", e1), ("e2", e2)):
        _check(name, x, torch.float32, (T, 3), device)
    return T


def _device(o):
    """The inputs' device: the CPU runs the plain version, CUDA the kernel."""
    dev = o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no brute-force intersector for device {dev}")
    return dev


def _mt_plain(p0, e1, e2, o, d, t_min, t_max):
    """The kernel's loop in tensor form: (best t, idx, u, v), idx -1 and
    u = v = 0 on a miss, t = t_max on a miss."""
    R, T = o.shape[0], p0.shape[0]
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    tmin, tmax = t_min[:, None], t_max[:, None]
    best_t = t_max.clone()
    best_i = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros(R, dtype=torch.float32, device=o.device)
    best_v = torch.zeros(R, dtype=torch.float32, device=o.device)
    for a in range(0, T, _PLAIN_CHUNK):
        b = min(T, a + _PLAIN_CHUNK)
        p0x, p0y, p0z = (p0[None, a:b, k] for k in range(3))
        e1x, e1y, e1z = (e1[None, a:b, k] for k in range(3))
        e2x, e2y, e2z = (e2[None, a:b, k] for k in range(3))
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok_det = torch.abs(det) > 1e-12
        inv = 1.0 / torch.where(ok_det, det, 1.0)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (tt > tmin) & (tt < tmax))
        tm = torch.where(ok, tt, torch.inf)
        k = torch.argmin(tm, dim=1, keepdim=True)  # first index of the minimum
        ct = tm.gather(1, k)[:, 0]
        # strict: an earlier chunk keeps a tie, like the kernel's t < best
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, a + k[:, 0], best_i)
        best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
    return best_t, best_i.to(torch.int32), best_u, best_v


def brute_force_closest_hit_plain(p0, e1, e2, o, d, t_min, t_max):
    """Plain PyTorch version of K2: (hit, t, idx, u, v)."""
    bt, idx, u, v = _mt_plain(p0, e1, e2, o, d, t_min, t_max)
    hit = idx >= 0
    return hit, torch.where(hit, bt, torch.inf), idx, u, v


def brute_force_closest_hit(p0, e1, e2, o, d, t_min, t_max):
    """K2: closest hit of rays o, d (R, 3) within (t_min, t_max) (R,)
    against triangles p0, e1, e2 (T, 3), float32.

    Returns (hit bool, t float32 (inf on a miss), idx int32 (-1 on a miss),
    u, v float32 (0 on a miss)), each (R,).
    """
    dev = _device(o)
    T = _check_tris(p0, e1, e2, dev)
    R = _check_rays(o, d, t_min, t_max, dev)
    if dev.type == "cpu":
        return brute_force_closest_hit_plain(p0, e1, e2, o, d, t_min, t_max)
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return hit, t, idx, u, v
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bf_closest_hit(
            p0.data_ptr(), e1.data_ptr(), e2.data_ptr(), T, o.data_ptr(),
            d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), R,
            hit.data_ptr(), t.data_ptr(), idx.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bf_closest_hit launch failed: cudaError {rc}")
    brute_force_closest_hit.launches += 1
    return hit, t, idx, u, v


brute_force_closest_hit.launches = 0


def brute_force_interaction_plain(p0, e1, e2, n0, n1, n2, uv0, uv1, uv2, gn,
                                  mat, em, nee, o, d, t_min, t_max):
    """Plain PyTorch version of K1: the K2 result plus the hit record."""
    hit, t, idx, u, v = brute_force_closest_hit_plain(
        p0, e1, e2, o, d, t_min, t_max)
    i = torch.clamp(idx, min=0).to(torch.int64)
    b0 = 1.0 - u - v
    h = hit[:, None]
    n_sh = b0[:, None] * n0[i] + u[:, None] * n1[i] + v[:, None] * n2[i]
    z_up = torch.zeros(3, device=o.device)
    z_up[2] = 1.0  # a fill, not a host-to-device copy (which would synchronise)
    n_sh = torch.where(h, n_sh, z_up)
    gn_o = torch.where(h, gn[i], z_up)
    uv = b0[:, None] * uv0[i] + u[:, None] * uv1[i] + v[:, None] * uv2[i]
    uv = torch.where(h, uv, 0.0)
    mat_o = torch.where(hit, mat[i], 0).to(torch.int32)
    em_o = torch.where(hit, em[i], -1).to(torch.int32)
    nee_o = torch.where(hit, nee[i], 0.0)
    return hit, t, idx, u, v, n_sh, gn_o, uv, mat_o, em_o, nee_o


def brute_force_interaction(p0, e1, e2, n0, n1, n2, uv0, uv1, uv2, gn, mat,
                            em, nee, o, d, t_min, t_max):
    """K1: closest hit plus the interaction record.

    Triangle attributes: p0, e1, e2, n0, n1, n2, gn (T, 3) float32;
    uv0, uv1, uv2 (T, 2) float32; mat, em (T,) int32; nee (T,) float32.
    Returns (hit, t, idx, u, v, n_sh (R, 3) unnormalized, gn (R, 3),
    uv (R, 2), mat (R,) int32, em (R,) int32 (-1 on a miss), nee (R,)).
    A miss gives n_sh = gn = (0, 0, 1), uv = 0, mat = 0, nee = 0.
    """
    tris = (p0, e1, e2, n0, n1, n2, uv0, uv1, uv2, gn, mat, em, nee)
    dev = _device(o)
    T = _check_tris(p0, e1, e2, dev)
    R = _check_rays(o, d, t_min, t_max, dev)
    for name, x in (("n0", n0), ("n1", n1), ("n2", n2), ("gn", gn)):
        _check(name, x, torch.float32, (T, 3), dev)
    for name, x in (("uv0", uv0), ("uv1", uv1), ("uv2", uv2)):
        _check(name, x, torch.float32, (T, 2), dev)
    _check("mat", mat, torch.int32, (T,), dev)
    _check("em", em, torch.int32, (T,), dev)
    _check("nee", nee, torch.float32, (T,), dev)
    if dev.type == "cpu":
        return brute_force_interaction_plain(*tris, o, d, t_min, t_max)
    f32, i32 = torch.float32, torch.int32
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    t, u, v, nee_o = (torch.empty(R, dtype=f32, device=dev) for _ in range(4))
    idx, mat_o, em_o = (torch.empty(R, dtype=i32, device=dev) for _ in range(3))
    n_sh = torch.empty((R, 3), dtype=f32, device=dev)
    gn_o = torch.empty((R, 3), dtype=f32, device=dev)
    uv = torch.empty((R, 2), dtype=f32, device=dev)
    out = (hit, t, idx, u, v, n_sh, gn_o, uv, mat_o, em_o, nee_o)
    if R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bf_interaction(
            *(x.data_ptr() for x in tris), T, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), R,
            *(x.data_ptr() for x in out), stream)
    if rc != 0:
        raise RuntimeError(f"bf_interaction launch failed: cudaError {rc}")
    brute_force_interaction.launches += 1
    return out


brute_force_interaction.launches = 0
