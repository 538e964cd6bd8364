#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mitsuba_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA source of the port with nvcc (sm_90a), all at once;
  3. brute-force kernels: hold K1 (brute_force_interaction) and K2
     (brute_force_closest_hit) against their plain PyTorch versions on the
     card -- on the 262,144 camera rays of the 512x512 Cornell view (the
     render's shapes) and on 262,144 random rays against a random
     4096-triangle soup (the kernels' full contract, which exercises the
     shared-memory tiling) -- and time kernel and plain version;
  4. BVH kernels on the bunny_x2 scene (bench.py:27-89; bunny.ply is not in
     the repository, so bench.py's fallback heightfield of 79,202 triangles
     stands in for it, as in the JAX bench): hold K4
     (bvh_traverse_lane_packed) against its plain version on the 262,144
     camera rays, K3 (lane_chunk) on 262,144 bounce rays and shadow rays of
     the first bounce (a bounded launch, then the resumed rest), bit for
     bit; time them, and time the bounce query with the JAX resort schedule
     against one unbounded K3 launch with and without the coherence sort;
  5. large tier: 16 offset copies of the fallback mesh (bench.py:176-183;
     1,267,232 triangles, 2.53M nodes, above LANE_VMEM_MAX_NODES): hold K5
     (lane_hbm) and K6 (lane_chunk_hbm) against their plain versions on the
     262,144 rays of bench.py:205-212; then, with the counts set to 0, a
     closest-hit and a shadow query through the scene (K5) and bench's
     resort query (K6, rounds 6, chunk 16); print build time, rays/s and
     hit rate;
  6. render: mitsuba_tpu_torch.render.api.render of the Cornell box at
     512x512, depth 5, 36 spp in passes of 4, seed 0 (bench.py's Cornell
     layout), with every launch count set to 0 just before and read just
     after; checks 180 launches of K1 and of K2 and the image mean against
     the JAX package's value;
  7. render the bunny_x2 scene at 512x512, depth 5, samples 0-9 in passes of
     2, seed 0 (bench.py:289-293); checks 10 launches of K4 and 300 of K3
     (the JAX dispatch: K4 for the presorted bounce 0; K3 4 x (4 + 1) for
     bounces 1-4 and 5 x (1 + 1) for shadow rays, per sample), none of
     K1/K2/K5/K6, and the image mean within 1% of the JAX package's value;
  8. profile: one render pass of each scene under torch.profiler, printing
     the device's busy share of the wall time and the kernels that take it.

The second-to-last line of output is the kernels' JSON record, the last
{"ok": true, "device": {...}}. Without CUDA the script exits nonzero before
printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import rng as rng_mod
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.ops import build
from mitsuba_tpu_torch.ops import cuda_bvh as cb
from mitsuba_tpu_torch.ops import cuda_intersect as bf
from mitsuba_tpu_torch.render import api, shapes
from mitsuba_tpu_torch.render import bsdf as bsdf_mod
from mitsuba_tpu_torch.render import emitter as em_mod
from mitsuba_tpu_torch.render import scene as scene_mod
from mitsuba_tpu_torch.render import sensor as sensor_mod
from mitsuba_tpu_torch.render.integrators.common import (
    DIM_BASE, DIM_BSDF, DIM_NEE, PATH, IntegratorConfig, ray_offset)
from mitsuba_tpu_torch.render.scene import SceneBuilder

W = H = 512
SPP, SPP_PER_PASS, DEPTH, SEED = 36, 4, 5, 0
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0

# mean_rgb of the same render through the JAX package on its CPU backend:
# bench.py:time_scene with the Cornell arguments of bench.py:299-302 (512x512,
# depth 5, a warm-up pass and 8 timed passes of 4 spp = samples 0..35, seed 0,
# Gaussian filter), run with jax 0.9.0 on a CPU host, rounded to 5 digits by
# time_scene. BENCH_r05.json's TPU v5e record is [0.49274, 0.38073, 0.17204].
REF_MEAN_RGB = (0.49653, 0.38397, 0.17366)
MEAN_RTOL = 5e-3

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per ray-triangle test (csrc/brute_force.cu): edge cross
# 9, det 5, 1/det 1, tvec 3, u 6, qvec 9, v 6, t 6, u+v 1
FLOPS_PER_TEST = 46
# K1's record per hit ray: b0 2, normal 15, uv 10
FLOPS_PER_RECORD = 27
RAY_IN_BYTES = 32                 # o, d, t_min, t_max
K2_OUT_BYTES = 17                 # hit, t, idx, u, v
K1_OUT_BYTES = 17 + 12 + 12 + 8 + 12  # + n_sh, gn, uv, mat/em/nee
K2_TRI_BYTES = 36                 # p0, e1, e2
K1_TRI_BYTES = 120                # + n0 n1 n2 gn (36), uv0-2 (24), mat em nee
REPO_PATHS = {
    "brute_force_interaction": (
        "mitsuba_tpu_torch/csrc/brute_force.cu",
        "mitsuba_tpu/ops/pallas_intersect.py:172"),
    "brute_force_closest_hit": (
        "mitsuba_tpu_torch/csrc/brute_force.cu",
        "mitsuba_tpu/ops/pallas_intersect.py:137"),
    "lane_chunk": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:1132"),
    "bvh_traverse_lane_packed": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:1052"),
    "lane_hbm": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:1423"),
    "lane_chunk_hbm": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:1514"),
}
KERNELS = {
    "brute_force_interaction": bf.brute_force_interaction,
    "brute_force_closest_hit": bf.brute_force_closest_hit,
    "lane_chunk": cb.lane_chunk,
    "bvh_traverse_lane_packed": cb.bvh_traverse_lane_packed,
    "lane_hbm": cb.lane_hbm,
    "lane_chunk_hbm": cb.lane_chunk_hbm,
}

# the bunny_x2 scene (bench.py:27-89, rendered at bench.py:289-293)
BUNNY_EYE, BUNNY_AT, BUNNY_FOV = [0.0, 0.25, -0.75], [0.0, 0.1, 0.0], 45.0
BUNNY_SPP, BUNNY_SPP_PER_PASS = 10, 2
# mean_rgb of the same render (samples 0..9, seed 0, fallback heightfield)
# through the JAX package on its CPU backend: scripts/jax_bunny_ref_mean.py,
# which repeats bench.py:time_scene (a warm-up pass of 2 spp and 4 timed
# passes = samples 0..9), run with jax 0.9.0 on a CPU host, rounded to 5
# digits as time_scene rounds. BENCH_r05.json's TPU record
# [0.57589, 0.62661, 0.73416] is of the real bunny.ply, another scene.
BUNNY_REF_MEAN_RGB = (0.48974, 0.53942, 0.6321)
BUNNY_MEAN_RTOL = 1e-2
# the JAX dispatch's launches per sample (scene.py BVH_RESORT*): K4 once
# for bounce 0; K3 rounds + 1 per query, 4 x 5 closest + 5 x 2 shadow
K3_PER_SPP = 4 * (scene_mod.BVH_RESORT[0] + 1) + 5 * (
    scene_mod.BVH_RESORT_SHADOW[0] + 1)
# bench.py's large-scene tier (bench.py:176-224)
LARGE_COPIES, LARGE_ROUNDS, LARGE_CHUNK = 16, 6, 16

# per node visit of the lane kernels (csrc/bvh_lane.cu): a slab test is 25
# fp32 operations (6 sub, 6 mul, 12 min/max, 1 compare), a triangle test the
# brute-force kernels' 46
FLOPS_PER_BOX = 25
K4_RAY_BYTES = 32 + 17            # o, d, t_min, t_max | hit, t, idx, u, v
K3_RAY_BYTES = 48 + 20            # 7 ray floats + 5 state | t, idx, u, v, node


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, by CUDA events.

    A wrapper's host work (checks, allocations, the ctypes call) takes longer
    than a launch at the render's shapes, so events around calls issued as
    the host goes would time the host. A device-side sleep queued first lets
    the host enqueue every call before the device reaches them; the events
    then bracket back-to-back device work."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cornell(dev):
    b = SceneBuilder()
    shapes.cornell_box(b)
    scene, static = b.build(device=dev)
    sensor = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                         W, H, device=dev)
    return scene, static, sensor


def tri_args(scene):
    """K1's triangle arguments in order (K2 takes the first three)."""
    return (scene.tri_p0, scene.tri_e1, scene.tri_e2, scene.tri_n0,
            scene.tri_n1, scene.tri_n2, scene.tri_uv0, scene.tri_uv1,
            scene.tri_uv2, scene.tri_gn, scene.tri_mat, scene.tri_emitter,
            scene.tri_nee_pdf_area)


def camera_rays(sensor, dev):
    """The 512x512 camera rays of sample 0, as the render makes them."""
    settings = api.RenderSettings(width=W, height=H)
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    pos = api.pixel_sample_positions(settings, pix, 0, SEED)
    uv = pos / torch.tensor([W, H], dtype=torch.float32, device=dev)
    o, d = sensor_mod.sample_ray(sensor, uv, torch.zeros_like(uv))
    R = o.shape[0]
    return (o.contiguous(), d.contiguous(),
            torch.full((R,), 1e-4, device=dev), torch.full((R,), torch.inf, device=dev))


def random_soup(dev, T=4096, R=W * H, seed=7):
    """A random soup of T triangles in the unit cube with full per-triangle
    records, and R rays from around it (numpy, fixed seed)."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    p0 = rs.uniform(0, 1, (T, 3)).astype(f32)
    e1 = rs.normal(scale=0.05, size=(T, 3)).astype(f32)
    e2 = rs.normal(scale=0.05, size=(T, 3)).astype(f32)
    n = [rs.normal(size=(T, 3)).astype(f32) for _ in range(4)]
    uvs = [rs.random((T, 2)).astype(f32) for _ in range(3)]
    mat = rs.integers(0, 4, T).astype(np.int32)
    em = rs.integers(-1, 2, T).astype(np.int32)
    nee = rs.random(T).astype(f32)
    o = rs.uniform(-0.5, 1.5, (R, 3)).astype(f32)
    d = rs.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(f32)
    t_min = np.full(R, 1e-4, f32)
    t_max = np.full(R, np.inf, f32)
    dead = rs.random(R) < 0.1  # inactive lanes, as the integrator sends them
    t_max[dead] = t_min[dead]
    tris = (p0, e1, e2, n[0], n[1], n[2], *uvs, n[3], mat, em, nee)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return tuple(t(x) for x in tris), tuple(t(x) for x in (o, d, t_min, t_max))


def compare(name, out, ref, n_exact, ulp_limit=1):
    """Max |kernel - plain| over the float outputs and the largest ulp gap;
    the first n_exact outputs and every integer or bool output must be
    equal. Raises on any disagreement past ``ulp_limit`` ulp."""
    max_abs, max_ulp = 0.0, 0
    for i, (a, b) in enumerate(zip(out, ref)):
        if i < n_exact or a.dtype in (torch.bool, torch.int32):
            bad = int((a != b).sum())
            if bad:
                raise AssertionError(f"{name}: output {i}: {bad} lanes differ")
            continue
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)):
            raise AssertionError(f"{name}: output {i}: finite lanes differ")
        a, b = a[fin], b[fin]
        if a.numel():
            max_abs = max(max_abs, float((a - b).abs().max()))
            max_ulp = max(max_ulp, int((a.view(torch.int32).long()
                                        - b.view(torch.int32).long()).abs().max()))
    if max_ulp > ulp_limit:
        raise AssertionError(f"{name}: kernel and plain differ by {max_ulp} ulp")
    return max_abs, max_ulp


def bound_ms(kernel, R, T, n_hit):
    """Least time for the function on an H100: the larger of its bytes (each
    input read once, each output written once) over HBM bandwidth and its
    fp32 operations over the fp32 peak."""
    if kernel == "brute_force_interaction":
        nbytes = R * (RAY_IN_BYTES + K1_OUT_BYTES) + T * K1_TRI_BYTES
        flops = FLOPS_PER_TEST * R * T + FLOPS_PER_RECORD * n_hit
    else:
        nbytes = R * (RAY_IN_BYTES + K2_OUT_BYTES) + T * K2_TRI_BYTES
        flops = FLOPS_PER_TEST * R * T
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    """Hold each kernel against its plain version on two inputs; time both
    at the render's shapes. Returns {name: record} for the JSON line."""
    scene, _, sensor = cornell(dev)
    rays = camera_rays(sensor, dev)
    soup_tris, soup_rays = random_soup(dev)
    cases = {
        "cornell_camera": (tri_args(scene), rays),
        "soup4096": (soup_tris, soup_rays),
    }
    kernels = {
        "brute_force_interaction": (bf.brute_force_interaction,
                                    bf.brute_force_interaction_plain, True),
        "brute_force_closest_hit": (bf.brute_force_closest_hit,
                                    bf.brute_force_closest_hit_plain, False),
    }
    records = {}
    for name, (kern, plain, full) in kernels.items():
        rec = dict(name=name, route="cuda", source=REPO_PATHS[name][0],
                   replaces=REPO_PATHS[name][1], max_abs_err=0.0)
        for case, (tris, r) in cases.items():
            args = (tris if full else tris[:3]) + r
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err, ulp = compare(f"{name}/{case}", out, ref, n_exact=1)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            hit_rate = float(out[0].float().mean())
            log(f"kernel {name} on {case}: R={r[0].shape[0]} T={tris[0].shape[0]} "
                f"hit/idx mismatches 0, max |kernel-plain| {err:.3g} "
                f"({ulp} ulp), hit rate {hit_rate:.4f}")
            if case == "cornell_camera":
                # the render's shapes: 262,144 lanes x 36 triangles
                rec["ms"] = cuda_ms(lambda: kern(*args), reps=50)
                rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
                rec["bound_ms"], rec["bound_by"] = bound_ms(
                    name, r[0].shape[0], tris[0].shape[0], int(out[0].sum()))
                rec["library_ms"] = None  # no single PyTorch call computes it
            else:
                soup_ms = cuda_ms(lambda: kern(*args), reps=10)
                soup_plain = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
                soup_bound, soup_by = bound_ms(name, r[0].shape[0],
                                               tris[0].shape[0], int(out[0].sum()))
                log(f"kernel {name} on {case}: {soup_ms:.4f} ms, plain "
                    f"{soup_plain:.4f} ms, bound {soup_bound:.4f} ms ({soup_by})")
        log(f"kernel {name} on cornell_camera: {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        records[name] = rec
    return records


def fallback_mesh():
    """bench.py's stand-in for bunny.ply (bench.py:41-52): a 200x200
    heightfield, 79,202 triangles, normalized to 0.2 units of height on
    y = 0 and centred in x and z."""
    h = np.sin(np.linspace(0, 8, 200))[:, None] * np.cos(
        np.linspace(0, 8, 200))[None, :] * 0.02
    v, f, _ = shapes.heightfield(h, extent=(0.3, 0.3))
    lo, hi = v.min(axis=0), v.max(axis=0)
    scale = 0.2 / (hi[1] - lo[1])
    v = (v - lo) * scale
    v[:, 0] -= 0.5 * (hi[0] - lo[0]) * scale
    v[:, 2] -= 0.5 * (hi[2] - lo[2]) * scale
    return v, f


def bunny(dev):
    """bench.py:build_bunny_scene through the port's builder: two instances
    of the mesh, a 512x512 checker bitmap floor (MIP chain) and a 128x256 HDR
    sky with a sun, sampled through its alias table; and the bench camera."""
    b = SceneBuilder()
    v, f = fallback_mesh()
    white = b.add_material(albedo=(0.6, 0.55, 0.5))
    g = b.add_shapegroup([dict(verts=v, faces=f, mat=white)])
    b.add_instance(g, Transform.translate([-0.13, 0.0, 0.0]))
    b.add_instance(g, Transform.translate([0.13, 0.0, 0.05]))
    n = 512
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((xx // 16 + yy // 16) % 2).astype(np.float32)
    img = np.stack([0.2 + 0.6 * c, 0.25 + 0.45 * c, 0.3 + 0.3 * c], axis=-1)
    t = b.add_texture_bitmap(img, uv_scale=(8.0, 8.0))
    floor = b.add_material(albedo=(1.0, 1.0, 1.0), albedo_tex=t)
    b.add_mesh([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
               [[0, 2, 1], [0, 3, 2]], floor,
               uvs=[[0, 0], [1, 0], [1, 1], [0, 1]])
    He, We = 128, 256
    th = (np.arange(He) + 0.5) / He * np.pi
    ph = (np.arange(We) + 0.5) / We * 2 * np.pi
    T, P = np.meshgrid(th, ph, indexing="ij")
    sky = np.stack([0.35 + 0.3 * np.cos(T), 0.45 + 0.35 * np.cos(T),
                    0.8 + 0.2 * np.cos(T)], axis=-1).astype(np.float32)
    sun_d = np.array([np.sin(0.9) * np.cos(0.7), np.cos(0.9),
                      np.sin(0.9) * np.sin(0.7)])
    dirs = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                    axis=-1)
    sky += (np.clip(dirs @ sun_d, 0, 1) ** 400)[..., None] * np.array(
        [400.0, 380.0, 300.0], np.float32)
    b.add_envmap(sky)
    scene, static = b.build(device=dev)
    sensor = sensor_mod.make_perspective(
        Transform.look_at(BUNNY_EYE, BUNNY_AT, UP), BUNNY_FOV, W, H,
        device=dev)
    return scene, static, sensor


def lane_bound_ms(nodes, R, visits, ray_bytes):
    """Least time for a lane-kernel call on an H100: the larger of its bytes
    over HBM bandwidth and its fp32 operations over the fp32 peak. Bytes:
    each node the call reads, once (32 bytes of an internal node, 48 of a
    leaf, as the kernel loads them), and each ray's inputs and outputs once;
    operations: every visit's test. ``visits`` = (per-lane internal and leaf
    visit counts, nodes read) from the plain version."""
    v_int, v_leaf, touched = visits
    leaf = nodes[:, 7] >= 0
    nbytes = (int((touched & ~leaf).sum()) * 32 + int((touched & leaf).sum()) * 48
              + R * ray_bytes)
    flops = int(v_int.sum()) * FLOPS_PER_BOX + int(v_leaf.sum()) * FLOPS_PER_TEST
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _visits_line(visits, live):
    total = visits[0] + visits[1]
    n = int(total.sum())
    n_live = max(int(live.sum()), 1)
    # what HBM would move if no visit hit a cache (the kernel reads 32 bytes
    # of an internal node, 48 of a leaf)
    uncached_ms = (int(visits[0].sum()) * 32 + int(visits[1].sum()) * 48) \
        / PEAK_BYTES * 1e3
    return (f"visits {n} ({float(total.float().mean()):.2f} per ray, "
            f"{n / n_live:.2f} per live ray, max {int(total.max())}, leaf "
            f"share {int(visits[1].sum()) / max(n, 1):.3f}), "
            f"{int(visits[2].sum())} distinct nodes, uncached node traffic "
            f"{uncached_ms:.4f} ms at peak bandwidth")


def check_root_kernel(name, kern, plain, nodes, N, o, d, t_min, t_max):
    """K4/K5: kernel == plain version bit for bit (hit/idx exact, floats 0
    ulp) on closest and any-hit queries; time both on the closest query."""
    rec = dict(name=name, route="cuda", source=REPO_PATHS[name][0],
               replaces=REPO_PATHS[name][1], max_abs_err=0.0)
    R = o.shape[0]
    for any_hit in (False, True):
        out = kern(nodes, N, o, d, t_min, t_max, any_hit=any_hit)
        ref = plain(nodes, N, o, d, t_min, t_max, any_hit=any_hit,
                    with_visits=True)
        torch.cuda.synchronize()
        err, ulp = compare(f"{name}/any_hit={any_hit}", out, ref[:5],
                           n_exact=1, ulp_limit=0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"kernel {name} any_hit={any_hit}: R={R} N={N} hit/idx "
            f"mismatches 0, max |kernel-plain| {err:.3g} ({ulp} ulp), hit rate "
            f"{float(out[0].float().mean()):.4f}, "
            f"{_visits_line(ref[5], t_max > t_min)}")
        if not any_hit:
            visits = ref[5]
    rec["ms"] = cuda_ms(lambda: kern(nodes, N, o, d, t_min, t_max), reps=20)
    rec["plain_ms"] = cuda_ms(lambda: plain(nodes, N, o, d, t_min, t_max),
                              reps=1, warmup=1)
    rec["bound_ms"], rec["bound_by"] = lane_bound_ms(nodes, R, visits,
                                                     K4_RAY_BYTES)
    rec["library_ms"] = None  # no single PyTorch call computes it
    log(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def _root_state(N, rays, t_max):
    R = t_max.shape[0]
    dev = t_max.device
    return (torch.where(t_max > rays[6], 0, N).to(torch.int32), t_max,
            torch.full((R,), -1, dtype=torch.int32, device=dev),
            torch.zeros(R, device=dev), torch.zeros(R, device=dev))


def check_chunk_kernel(name, kern, plain, nodes, N, rays, t_max, budget,
                       any_hit, rec=None):
    """K3/K6: a launch of ``budget`` visits from the root, then the resumed
    rest: kernel == plain version bit for bit after each. On the first call
    (rec None) also time one unbounded launch from the root, the kernel's
    whole walk in one launch, and its plain version."""
    new = rec is None
    if new:
        rec = dict(name=name, route="cuda", source=REPO_PATHS[name][0],
                   replaces=REPO_PATHS[name][1], max_abs_err=0.0)
    state = _root_state(N, rays, t_max)
    for step, steps in ((f"bounded ({budget} visits)", budget),
                        ("resumed to the end", 0)):
        out = kern(nodes, N, *rays, *state, any_hit=any_hit, max_steps=steps)
        ref = plain(nodes, N, *rays, *state, any_hit=any_hit, max_steps=steps,
                    with_visits=True)
        torch.cuda.synchronize()
        err, ulp = compare(f"{name}/any_hit={any_hit}/{step}", out, ref[:5],
                           n_exact=0, ulp_limit=0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"kernel {name} any_hit={any_hit} {step}: "
            f"R={t_max.shape[0]} idx/node mismatches 0, max |kernel-plain| "
            f"{err:.3g} ({ulp} ulp), lanes still walking "
            f"{int((out[4] < N).sum())}, {_visits_line(ref[5], state[0] < N)}")
        state = (out[4], out[0], out[1], out[2], out[3])
    if new:
        root = _root_state(N, rays, t_max)
        full = plain(nodes, N, *rays, *root, any_hit=any_hit, with_visits=True)
        rec["ms"] = cuda_ms(lambda: kern(nodes, N, *rays, *root,
                                         any_hit=any_hit), reps=20)
        rec["plain_ms"] = cuda_ms(lambda: plain(nodes, N, *rays, *root,
                                                any_hit=any_hit),
                                  reps=1, warmup=1)
        rec["bound_ms"], rec["bound_by"] = lane_bound_ms(
            nodes, t_max.shape[0], full[5], K3_RAY_BYTES)
        rec["library_ms"] = None  # no single PyTorch call computes it
        log(f"kernel {name} (one unbounded launch, any_hit={any_hit}): "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"{_visits_line(full[5], root[0] < N)}")
    return rec


def first_bounce_rays(scene, static, o, d):
    """Sample 0's bounce-1 closest-hit rays and bounce-0 shadow rays, made
    with the integrator's arithmetic (path.py: BSDF sampling and NEE at the
    primary hits); lanes the integrator would not trace are dead."""
    R = o.shape[0]
    dev = o.device
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, torch.inf,
                                  presorted=True)
    bl = scene_mod.bsdf_locals(scene, its, static)
    u_b = rng_mod.uniform4(SEED, pix, 0, DIM_BASE + DIM_BSDF)
    bs = bsdf_mod.sample(bl, its.wi, u_b[..., 0], u_b[..., 1:3],
                         active_types=static.bsdf_types)
    d_b = m.normalize(its.sh_frame.to_world(bs.wo)).contiguous()
    o_b = ray_offset(its.p, its.gn, d_b).contiguous()
    live_b = its.valid & (bs.pdf > 0)
    t_min_b = torch.full((R,), 1e-4, device=dev)
    bounce = (o_b, d_b, t_min_b, torch.where(live_b, torch.inf, t_min_b))
    u_nee = rng_mod.uniform4(SEED, pix, 0, DIM_BASE + DIM_NEE)
    ds = em_mod.sample_direct(scene, static, its.p, u_nee[..., :3])
    nee_ok = its.valid & ds.valid & (ds.pdf_sa > 0)
    o_s = ray_offset(its.p, its.gn, ds.d).contiguous()
    zero = torch.zeros(R, device=dev)
    shadow = (o_s, ds.d.contiguous(), zero,
              torch.where(nee_ok, ds.dist * (1.0 - 1e-3), zero))
    return bounce, shadow


def bvh_kernel_phase(dev):
    """K4 and K3 on the bunny scene at the render's shapes; the coherence
    sort question. Returns {name: record} for the JSON line."""
    t0 = time.perf_counter()
    scene, static, sensor = bunny(dev)
    torch.cuda.synchronize()
    N = static.n_bvh_nodes
    log(f"bunny scene: {static.n_tris} triangles (fallback heightfield), "
        f"{N} BVH nodes, built in {time.perf_counter() - t0:.2f} s")
    nodes, lo, hi = scene.nodes, scene.aabb_lo, scene.aabb_hi
    cam = camera_rays(sensor, dev)
    records = {"bvh_traverse_lane_packed": check_root_kernel(
        "bvh_traverse_lane_packed", cb.bvh_traverse_lane_packed,
        cb.bvh_traverse_lane_packed_plain, nodes, N, *cam)}

    bounce, shadow = first_bounce_rays(scene, static, cam[0], cam[1])
    rec = None
    for any_hit, (o, d, t_min, t_max), sched in (
            (False, bounce, scene_mod.BVH_RESORT),
            (True, shadow, scene_mod.BVH_RESORT_SHADOW)):
        # K3 sees the rays as the resort loop hands them over: sorted
        (*rays, tmx), _ = cb.sort_rays(o, d, t_min, t_max, lo, hi)
        rec = check_chunk_kernel("lane_chunk", cb.lane_chunk,
                                 cb.lane_chunk_plain, nodes, N, tuple(rays),
                                 tmx, sched[1] * sched[2], any_hit, rec)
        # does the coherence sort pay on the card? the whole query with the
        # JAX schedule, with the sort and one unbounded launch, and one
        # unbounded launch on the rays as they come
        rounds, chunk_nit, strip = sched
        t_sched = cuda_ms(lambda: cb.bvh_traverse_lane_resort(
            nodes, N, o, d, t_min, t_max, lo, hi, any_hit=any_hit,
            rounds=rounds, chunk_nit=chunk_nit, strip=strip), reps=10)
        t_sort1 = cuda_ms(lambda: cb.bvh_traverse_lane_resort(
            nodes, N, o, d, t_min, t_max, lo, hi, any_hit=any_hit,
            rounds=0), reps=10)
        raw = tuple(x[:, k].contiguous() for x in (o, d) for k in range(3))
        raw = raw + (t_min,)
        root = _root_state(N, raw, t_max)
        t_raw = cuda_ms(lambda: cb.lane_chunk(nodes, N, *raw, *root,
                                              any_hit=any_hit), reps=10)
        t_one = cuda_ms(lambda: cb.lane_chunk(nodes, N, *rays,
                                              *_root_state(N, rays, tmx),
                                              any_hit=any_hit), reps=10)
        log(f"coherence {'shadow' if any_hit else 'bounce'} query "
            f"(R={o.shape[0]}, live {int((t_max > t_min).sum())}): schedule "
            f"{rounds},{chunk_nit},{strip} {t_sched:.4f} ms; sort + one "
            f"unbounded K3 + unsort {t_sort1:.4f} ms; one unbounded K3 on "
            f"sorted rays {t_one:.4f} ms; one unbounded K3 unsorted "
            f"{t_raw:.4f} ms")
    records["lane_chunk"] = rec
    return records


def large_scene(dev):
    """bench.py:time_large_scene_hbm's geometry with the fallback mesh: 16
    offset copies baked into one mesh (bench.py:176-183)."""
    v0, f0 = fallback_mesh()
    b = SceneBuilder()
    mat = b.add_material(albedo=(0.6, 0.55, 0.5))
    for i in range(LARGE_COPIES):
        dx = (i % 4 - 1.5) * 0.18
        dz = (i // 4 - 1.5) * 0.2
        b.add_mesh(v0 + np.asarray([dx, 0.0, dz]), f0, mat)
    return b.build(device=dev)


def large_tier_phase(dev):
    """K5 and K6 above LANE_VMEM_MAX_NODES: kernel == plain, then the tier's
    queries with the launch counts read. Returns ({name: record}, launches)."""
    t0 = time.perf_counter()
    scene, static = large_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    N = static.n_bvh_nodes
    if N <= cb.LANE_VMEM_MAX_NODES:
        raise AssertionError(f"{N} nodes: the large tier must exceed "
                             f"{cb.LANE_VMEM_MAX_NODES}")
    log(f"large tier: {static.n_tris} triangles, {N} BVH nodes, scene built "
        f"(BVH, packing, upload) in {build_s:.2f} s")
    nodes, lo, hi = scene.nodes, scene.aabb_lo, scene.aabb_hi
    # bench.py:205-212: 2^18 rays from a sphere around the scene, aimed at
    # a smaller sphere inside it
    lo_np, hi_np = (x.cpu().numpy().astype(np.float64) for x in (lo, hi))
    center = (lo_np + hi_np) / 2
    radius = 0.5 * float(np.linalg.norm(hi_np - lo_np))
    R = 1 << 18
    rs = np.random.default_rng(0)
    a = rs.normal(size=(R, 3))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b2 = rs.normal(size=(R, 3))
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    o_np = (center + radius * a).astype(np.float32)
    d_np = ((center + 0.4 * radius * b2) - o_np).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    o = torch.from_numpy(o_np).to(dev)
    d = torch.from_numpy(d_np).to(dev)
    t_min = torch.full((R,), 1e-4, device=dev)
    t_max = torch.full((R,), 1e9, device=dev)

    # the kernels see sorted rays, as their query functions hand them over
    (*rays, tmx), _ = cb.sort_rays(o, d, t_min, t_max, lo, hi)
    rays = tuple(rays)
    records = {
        "lane_hbm": check_root_kernel(
            "lane_hbm", cb.lane_hbm, cb.lane_hbm_plain, nodes, N,
            torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1), rays[6],
            tmx),
        "lane_chunk_hbm": check_chunk_kernel(
            "lane_chunk_hbm", cb.lane_chunk_hbm, cb.lane_chunk_hbm_plain,
            nodes, N, rays, tmx, LARGE_CHUNK * cb.LSTRIP, any_hit=False),
    }

    # the tier's queries: scene closest hit and shadow ray (K5), bench's
    # resort query (K6), with the counts set to 0 just before
    for k in KERNELS.values():
        k.launches = 0
    its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, 1e9)
    occ = scene_mod.occluded(scene, static, o, d, 1e-4, 1e9)
    res = cb.bvh_traverse_lane_hbm_resort(nodes, N, o, d, t_min, t_max, lo, hi,
                                          rounds=LARGE_ROUNDS,
                                          chunk_nit=LARGE_CHUNK)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"large tier launches {launches}")
    expected = {"lane_hbm": 2, "lane_chunk_hbm": LARGE_ROUNDS + 1}
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(f"large tier: {name} launched {n} times, "
                                 f"expected {expected.get(name, 0)}")
    if not (torch.equal(its.valid, res[0]) and torch.equal(occ, res[0])
            and torch.equal(its.prim_id, torch.where(res[0], res[2], -1))):
        raise AssertionError("large tier: K5 and K6 queries disagree")
    hit_rate = float(res[0].float().mean())
    t_k6 = cuda_ms(lambda: cb.bvh_traverse_lane_hbm_resort(
        nodes, N, o, d, t_min, t_max, lo, hi, rounds=LARGE_ROUNDS,
        chunk_nit=LARGE_CHUNK), reps=3, warmup=1)
    t_k5 = cuda_ms(lambda: cb.bvh_traverse_lane_hbm(
        nodes, N, o, d, t_min, t_max, lo, hi, sort=True), reps=3, warmup=1)
    log(f"large tier: hit rate {hit_rate:.4f}; resort query (K6, rounds "
        f"{LARGE_ROUNDS}, chunk {LARGE_CHUNK}) {t_k6:.3f} ms = "
        f"{R / t_k6 * 1e3:.1f} rays/s; sorted query (K5) {t_k5:.3f} ms = "
        f"{R / t_k5 * 1e3:.1f} rays/s")
    return records, launches


def render_phase(dev, label, scene, static, sensor, eye, at, fov, spp,
                 spp_per_pass, ref_mean, rtol, expected):
    """The port's main path: api.render at 512x512, depth 5, seed 0, with
    every launch count set to 0 just before and read just after; checks the
    counts against ``expected`` (0 for a kernel not named) and the image
    mean against the JAX package's value."""
    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    # warm-up at a small size (first-call set-up of the CUDA libraries)
    small = sensor_mod.make_perspective(Transform.look_at(eye, at, UP), fov,
                                        64, 64, device=dev)
    api.render(scene, static, small, cfg,
               api.RenderSettings(width=64, height=64, spp=1, spp_per_pass=1),
               device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    settings = api.RenderSettings(width=W, height=H, spp=spp,
                                  spp_per_pass=spp_per_pass, seed=SEED)
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    img, n_rays = api.render(scene, static, sensor, cfg, settings, device=dev,
                             with_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}

    if tuple(img.shape) != (H, W, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels")
    mean = img.mean(dim=(0, 1)).tolist()
    log(f"render {label} {W}x{H} depth {DEPTH} spp {spp} (passes of "
        f"{spp_per_pass}), seed {SEED}: {dt:.3f} s")
    log(f"render {label} mean_rgb {mean} (reference {list(ref_mean)})")
    log(f"render {label} rays {n_rays}, {n_rays / dt:.1f} rays/s, "
        f"{dt / spp * 1e3:.3f} ms/spp")
    log(f"render {label} max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log(f"render {label} launches {launches}")
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {expected.get(name, 0)}")
    for c, (a, b) in enumerate(zip(mean, ref_mean)):
        if abs(a - b) > rtol * b:
            raise AssertionError(
                f"{label}: mean_rgb[{c}] = {a:.6f}, reference {b} "
                f"(tolerance {rtol:.1%})")
    return launches


def profile_phase(dev, label, scene, static, sensor, spp):
    """Device time by kernel over one render pass of ``spp`` samples
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    settings = api.RenderSettings(width=W, height=H, spp=spp,
                                  spp_per_pass=spp, seed=SEED)
    api.render(scene, static, sensor, cfg, settings, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.render(scene, static, sensor, cfg, settings, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' device time
    dev_us = {e.key: e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    busy = sum(dev_us.values()) / 1e6
    log(f"profile {label} one {spp}-spp pass: wall {wall * 1e3:.3f} ms, device "
        f"busy {busy * 1e3:.3f} ms ({'not measured' if not dev_us else f'{busy / wall:.1%}'})")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    for k, us in top:
        log(f"profile   {us / 1e3:9.3f} ms  {k[:90]}")
    calls_of = {e.key: e.count for e in events
                if e.device_type == DeviceType.CUDA}
    for kernel in ("interaction_kernel", "closest_hit_kernel",
                   "lane_packed_kernel", "lane_chunk_kernel"):
        hits = [k for k in dev_us if f"::{kernel}(" in k]
        if hits or not dev_us:
            took = (f"{sum(dev_us[k] for k in hits) / 1e3:.3f} ms in "
                    f"{sum(calls_of[k] for k in hits)} launches" if dev_us
                    else "not measured")
            log(f"profile   {kernel}: {took}")
    # host dispatch: the PyTorch ops the pass issues, by count
    calls = sorted(((e.key, e.count) for e in events if e.key.startswith("aten::")),
                   key=lambda kv: -kv[1])[:8]
    log("profile   op calls: " + ", ".join(f"{k} {n}" for k, n in calls))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(logs)} sources compiled in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"build {name}: {line.strip()}")

    records = kernel_phase(dev)
    records.update(bvh_kernel_phase(dev))
    large, large_launches = large_tier_phase(dev)
    records.update(large)

    cornell_scene = cornell(dev)
    launches = render_phase(
        dev, "cornell", *cornell_scene, EYE, AT, FOV, SPP, SPP_PER_PASS,
        REF_MEAN_RGB, MEAN_RTOL,
        {"brute_force_interaction": DEPTH * SPP,
         "brute_force_closest_hit": DEPTH * SPP})
    bunny_scene = bunny(dev)
    bunny_launches = render_phase(
        dev, "bunny", *bunny_scene, BUNNY_EYE, BUNNY_AT, BUNNY_FOV,
        BUNNY_SPP, BUNNY_SPP_PER_PASS, BUNNY_REF_MEAN_RGB, BUNNY_MEAN_RTOL,
        {"bvh_traverse_lane_packed": BUNNY_SPP,
         "lane_chunk": K3_PER_SPP * BUNNY_SPP})
    # each kernel's count from the run of the path that drives it
    for name in ("brute_force_interaction", "brute_force_closest_hit"):
        records[name]["launches"] = launches[name]
    for name in ("bvh_traverse_lane_packed", "lane_chunk"):
        records[name]["launches"] = bunny_launches[name]
    for name in ("lane_hbm", "lane_chunk_hbm"):
        records[name]["launches"] = large_launches[name]
    profile_phase(dev, "cornell", *cornell_scene, SPP_PER_PASS)
    profile_phase(dev, "bunny", *bunny_scene, BUNNY_SPP_PER_PASS)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
