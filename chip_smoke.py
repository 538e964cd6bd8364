#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mitsuba_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA source of the port with nvcc (sm_90a), all at once;
  3. brute-force kernels: hold K1 (brute_force_interaction) and K2
     (brute_force_closest_hit) against their plain PyTorch versions on the
     card, bit for bit, on the 262,144 camera rays of the 512x512 Cornell
     view (the render's shapes), on 262,144 random rays against a random
     4096-triangle soup (the kernels' full contract, several shared-memory
     tiles), on a grid of exact ties, on 262,147 rays inside the Cornell box
     of which 70% are dead, and on random soups of 1, 37 and 4,096
     triangles under 100,003 rays; time the kernels on every case (with
     the bound and the exact-arithmetic floor) and the plain versions at
     the render's shapes; print registers, resident blocks and the inner
     loop's instruction slots per test (cuobjdump -sass); and hold the
     kernels' fast reciprocal against 1.0f / x on every float where they
     use it;
  4. BVH kernels on the bunny_x2 scene (bench.py:27-89; bunny.ply is not in
     the repository, so bench.py's fallback heightfield of 79,202 triangles
     stands in for it, as in the JAX bench): time the octant packer; hold K4
     (bvh_traverse_lane_packed) against its plain version on the 262,144
     camera rays, K3 (lane_chunk) on 262,144 bounce rays (closest hit, on
     the octant tables) and shadow rays (any-hit, canonical table) of the
     first bounce (a bounded launch, then the resumed rest), bit for bit;
     hold K3's unbounded closest-hit walk against K4's canonical walk on the
     same rays (hit and t, every mismatch printed as a near-tie or fatal),
     compare their visits, time K3 in turns against K4 (the canonical walk
     from the root) and print K3's and K7's registers and occupancy; time
     the bounce query with the JAX resort schedule against one unbounded K3
     launch with and without the coherence sort;
  5. the treelet kernel K7 (treelet_rounds) on the bunny scene's treelet
     cut: held bit for bit against both plain versions (the JAX rounds and
     the kernel's entry list) on the 262,144 camera rays (as they come), the
     bounce rays and the shadow rays (any-hit), both sorted as its query
     function sorts them; root-box tests per ray and the root boxes each ray
     enters; each launch timed, and the bounce query through the K7 query
     function timed against the K3 resort query;
  6. the fat-row kernel K8 (bvh_traverse_packed) on a leaf-4 tree of the
     same triangles: camera and bounce rays, closest and any-hit, and a
     bounded case with per-ray [start, end) ranges of the tree's treelets;
     then its sorting query bvh_traverse with the counts set to 0;
  7. the wide-page kernel K9 (lane_chunk_w) on pack_pages_w of the same
     triangles' leaf-1 tree: a bounded launch on the sorted bounce rays, then
     the resumed rest, timed beside K3 on the same tree and rays and held
     bit for bit against K4's canonical walk there; then its query
     bvh_traverse_lane_resort_w with the counts set to 0, held bit for bit
     against K4's sorted query bvh_traverse_lane;
  8. large tier: 16 offset copies of the fallback mesh (bench.py:176-183;
     1,267,232 triangles, 2.53M nodes, above LANE_VMEM_MAX_NODES), on the
     262,144 rays of bench.py:205-212 sorted as the queries sort them: print
     K5's and K6's registers, resident blocks and launch grid; hold K5
     (lane_hbm: closest hit on the octant tables, any-hit) and K6
     (lane_chunk_hbm: a bounded launch, then the resumed rest, closest and
     any-hit) against their plain versions bit for bit; hold their closest
     hits against K4's canonical walk of the same tree and rays (hit, and t
     except near-ties within NEAR_TIE_RTOL, each printed); print visits
     (mean and max per live lane), distinct rows read and their MB, and the
     warp efficiency of the octant and canonical walks; time K5 (closest,
     any-hit) and K6 (closest, one unbounded launch) in turns with K4; then,
     with the counts set to 0, a closest-hit and a shadow query through the
     scene (K5, 2 launches) and bench's resort query (K6, rounds 6, chunk
     16: 7 launches); print build time (and the octant packer's), rays/s
     and the hit rate, which must be 0.6073;
  9. render: mitsuba_tpu_torch.render.api.render of the Cornell box at
     512x512, depth 5, 36 spp in passes of 4, seed 0 (bench.py's Cornell
     layout), with every launch count set to 0 just before and read just
     after; checks 180 launches of K1 and of K2 and the image mean against
     the JAX package's value; then the same render once more, counting the
     live lanes (t_max > t_min) of each K1 and K2 launch;
 10. render the bunny_x2 scene at 512x512, depth 5, samples 0-9 in passes of
     2, seed 0 (bench.py:289-293); checks 10 launches of K4 and 300 of K3
     (the JAX dispatch: K4 for the presorted bounce 0; K3 4 x (4 + 1) for
     bounces 1-4 and 5 x (1 + 1) for shadow rays, per sample), none of
     K1/K2/K5/K6, and the image mean within 1% of the JAX package's value;
     prints the mean's difference from PR 3's;
 11. the treelet render: the bunny render of phase 10 with
     render.scene.BVH_KERNEL = "treelet"; checks 100 launches of K7 (a
     closest-hit and a shadow query per bounce, 5 bounces, 10 samples) and
     none of K1-K6, the mean within 1% of the JAX value, and prints ms/spp
     and the mean's difference from the lane render's;
 12. kdbench: bench.py's fallback heightfield written as a binary PLY into a
     temporary directory, run through mitsuba_tpu_torch.mtsutil.main
     (["kdbench", path], defaults: 2^18 rays, 3 repeats); checks that the
     treelet and lane-resort kernels report the same hit rate on each batch
     and that K7 and K3 launched as the utility drives them;
 13. profile: one render pass of each scene (the bunny in both BVH modes)
     under torch.profiler, printing the device's busy share of the wall time,
     the kernels that take it and each port kernel's render mean per launch.

The second-to-last line of output is the kernels' JSON record, the last
{"ok": true, "device": {...}}. Without CUDA the script exits nonzero before
printing any result.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from mitsuba_tpu_torch import mtsutil
from mitsuba_tpu_torch.accel.build import (build_bvh, treelet_roots,
                                           triangle_aabbs)
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
# fp32 without FMA contraction issues at half the fp32 peak: the floor of a
# kernel that rounds each of a test's 46 operations as the plain version does
PEAK_FP32_NO_FMA = PEAK_FP32 / 2
LANES_PER_SM = 128                # fp32 lanes: 4 schedulers x 32
# the brute-force kernels' odd-size cases: not a multiple of any block's
# ray slots; the dead-heavy case's share of dead lanes
ODD_R = W * H + 3
ODD_SOUP_R = 100_003
DEAD_SHARE = 0.7
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
    "treelet_rounds": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:514"),
    "bvh_traverse_packed": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:226"),
    "lane_chunk_w": (
        "mitsuba_tpu_torch/csrc/bvh_lane.cu",
        "mitsuba_tpu/ops/pallas_bvh.py:1802"),
}
KERNELS = {
    "brute_force_interaction": bf.brute_force_interaction,
    "brute_force_closest_hit": bf.brute_force_closest_hit,
    "lane_chunk": cb.lane_chunk,
    "bvh_traverse_lane_packed": cb.bvh_traverse_lane_packed,
    "lane_hbm": cb.lane_hbm,
    "lane_chunk_hbm": cb.lane_chunk_hbm,
    "treelet_rounds": cb.treelet_rounds,
    "bvh_traverse_packed": cb.bvh_traverse_packed,
    "lane_chunk_w": cb.lane_chunk_w,
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
# the bunny render's mean_rgb over every run of PR 3, bit-identical (its
# kernels walked only the canonical table)
PR3_BUNNY_MEAN_RGB = (0.48976483941078186, 0.539433479309082,
                      0.6320508122444153)
# an octant walk may miss a hit that the canonical walk finds (or find one
# it misses) only where a box's rounded entry exceeds the hit's t: then the
# two t differ by rounding, within this relative gap
NEAR_TIE_RTOL = 1e-4
# the JAX dispatch's launches per sample (scene.py BVH_RESORT*): K4 once
# for bounce 0; K3 rounds + 1 per query, 4 x 5 closest + 5 x 2 shadow
K3_PER_SPP = 4 * (scene_mod.BVH_RESORT[0] + 1) + 5 * (
    scene_mod.BVH_RESORT_SHADOW[0] + 1)
# bench.py's large-scene tier (bench.py:176-224), and its hit rate on
# bench's rays in every run of the port so far
LARGE_COPIES, LARGE_ROUNDS, LARGE_CHUNK = 16, 6, 16
LARGE_HIT_RATE = "0.6073"

# per node visit of the lane kernels (csrc/bvh_lane.cu): a slab test is 25
# fp32 operations (6 sub, 6 mul, 12 min/max, 1 compare), a triangle test the
# brute-force kernels' 46
FLOPS_PER_BOX = 25
K4_RAY_BYTES = 32 + 17            # o, d, t_min, t_max | hit, t, idx, u, v
K3_RAY_BYTES = 48 + 20            # 7 ray floats + 5 state | t, idx, u, v, node
K7_TREELET_BYTES = 4 * cb.TREELET_COLS  # a row of K7's shared table
MAP_BYTES = 4                     # an Octants.leaf_row entry read on a tie
K8_RANGE_BYTES = 8                # per-ray start, end of a bounded K8 call
K9_LEAF_BYTES = 44                # a wide-page leaf: 11 component words
# the treelet render: a closest-hit and a shadow query per bounce, each one
# K7 launch (render/scene.py _bvh_query)
K7_PER_SPP = 2 * DEPTH


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


def _records(p0, e1, e2, rs):
    """K1's 13 triangle arrays: p0, e1, e2 and random normals, uvs, ids and
    NEE pdfs drawn from ``rs`` (numpy)."""
    T, f32 = len(p0), np.float32
    n = [rs.normal(size=(T, 3)).astype(f32) for _ in range(4)]
    uvs = [rs.random((T, 2)).astype(f32) for _ in range(3)]
    mat = rs.integers(0, 4, T).astype(np.int32)
    em = rs.integers(-1, 2, T).astype(np.int32)
    nee = rs.random(T).astype(f32)
    return (p0, e1, e2, n[0], n[1], n[2], *uvs, n[3], mat, em, nee)


def _on(dev, tris, rays):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return tuple(t(x) for x in tris), tuple(t(x) for x in rays)


def _kill(rs, t_min, t_max, share):
    """Inactive lanes as the integrator sends them (t_max = t_min), each
    lane with probability ``share``, independently, as roulette and escape
    leave them."""
    dead = rs.random(len(t_max)) < share
    t_max[dead] = t_min[dead]


def random_soup(dev, T=4096, R=W * H, seed=7, dead=0.1, huge=0):
    """A random soup of T triangles in the unit cube with full per-triangle
    records, and R rays from around it (numpy, fixed seed); the edges of
    the first ``huge`` triangles scaled by 2^67."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    p0 = rs.uniform(0, 1, (T, 3)).astype(f32)
    e1 = rs.normal(scale=0.05, size=(T, 3)).astype(f32)
    e2 = rs.normal(scale=0.05, size=(T, 3)).astype(f32)
    e1[:huge] *= f32(2.0 ** 67)
    e2[:huge] *= f32(2.0 ** 67)
    tris = _records(p0, e1, e2, rs)
    o = rs.uniform(-0.5, 1.5, (R, 3)).astype(f32)
    d = rs.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(f32)
    t_min = np.full(R, 1e-4, f32)
    t_max = np.full(R, np.inf, f32)
    _kill(rs, t_min, t_max, dead)
    return _on(dev, tris, (o, d, t_min, t_max))


def tie_grid(dev):
    """tests/test_torch_bvh.py:_tie_grid, copied (the script imports no
    test): 600 triangles of two planar grids of quads of side 1/8, split
    along alternating diagonals, and 1,024 rays aimed at their vertices and
    edge midpoints along dyadic directions, so each ray hits up to six
    triangles at exactly the same t; random K1 records (seed 32)."""
    h = 1 / 8
    tris = []
    for z, x0, y0 in ((0.0, 0.0, 0.0), (0.5, 0.5, 0.25)):
        for i in range(15):
            for j in range(10):
                a = np.array([x0 + i * h, y0 + j * h, z])
                b, c, d = a + [h, 0, 0], a + [h, h, 0], a + [0, h, 0]
                tris += ([(a, b, c), (a, c, d)] if (i + j) % 2
                         else [(a, b, d), (b, c, d)])
    t = np.asarray(tris)
    p0, e1, e2 = (x.astype(np.float32) for x in (t[:, 0], t[:, 1] - t[:, 0],
                                                 t[:, 2] - t[:, 0]))
    rs = np.random.default_rng(31)
    R = 1024
    layer = rs.integers(0, 2, R)
    target = np.stack([(rs.integers(0, 31, R) / 16 + 0.5 * layer),
                       (rs.integers(0, 21, R) / 16 + 0.25 * layer),
                       0.5 * layer], axis=1)
    d = np.stack([rs.choice([-1 / 4, -1 / 8, 0.0, 1 / 8, 1 / 4], R),
                  rs.choice([-1 / 4, -1 / 16, 0.0, 1 / 16, 1 / 4], R),
                  rs.choice([-1.0, 1.0], R)], axis=1)
    o = (target - 2 * d).astype(np.float32)
    rays = (o, d.astype(np.float32), np.zeros(R, np.float32),
            np.full(R, np.inf, np.float32))
    return _on(dev, _records(p0, e1, e2, np.random.default_rng(32)), rays)


def dead_heavy(dev, scene, R=ODD_R, seed=41):
    """The Cornell box's 36 triangles and R rays from random points inside
    the box in random directions (the render's later bounces), DEAD_SHARE of
    them dead, scattered lane by lane."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    o = rs.uniform(0.02, 0.98, (R, 3)).astype(f32)
    d = rs.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(f32)
    t_min = np.full(R, 1e-4, f32)
    t_max = np.full(R, np.inf, f32)
    _kill(rs, t_min, t_max, DEAD_SHARE)
    rays = tuple(torch.from_numpy(x).to(dev) for x in (o, d, t_min, t_max))
    return tri_args(scene), rays


def bf_cases(dev):
    """{case: (K1's triangle arguments, rays)} of the kernel phase: the
    render's shapes (cornell_camera), the contract's 4,096 triangles,
    exact ties, a dead-heavy batch of an odd size, and T = 1, 37 and 4,096
    on an odd number of rays."""
    scene, _, sensor = cornell(dev)
    cases = {
        "cornell_camera": (tri_args(scene), camera_rays(sensor, dev)),
        "soup4096": random_soup(dev),
        "tie_grid": tie_grid(dev),
        "dead_heavy": dead_heavy(dev, scene),
    }
    for T in (1, 37, 4096):
        # at 37, four triangles 2^67 times larger: determinants past 2^126,
        # which take the exact division
        cases[f"odd_T{T}"] = random_soup(dev, T=T, R=ODD_SOUP_R, seed=50 + T,
                                         huge=4 if T == 37 else 0)
    return cases


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


def floor_ms(R, T):
    """The exact-arithmetic floor: R x T tests of 46 fp32 operations at the
    rate without FMA contraction (half the peak)."""
    return FLOPS_PER_TEST * R * T / PEAK_FP32_NO_FMA * 1e3


def sm_clock_during(fn):
    """fn() while nvidia-smi reads the SM clock once, 0.2 s in; returns
    (fn's result, MHz)."""
    box = {}

    def read():
        time.sleep(0.2)
        box["mhz"] = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.split()[0])

    th = threading.Thread(target=read)
    th.start()
    out = fn()
    th.join()
    return out, box["mhz"]


def loop_slots(kernel):
    """Instructions per ray-triangle test in ``kernel``'s inner loop, read
    from ``cuobjdump -sass`` of the built library. The inner loop is the
    smallest loop (a predicated backward branch and its body) that holds
    the most MUFU.RCP on its common path (each test issues one); code that
    a forward branch in it jumps over and that CALLs out (the reciprocal's
    slow path) is left out. Returns (body instructions, slow-path
    instructions, tests per pass, slots per test)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path("brute_force"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = next(f for f in text.split("Function : ")[1:]
                if kernel in f.split("\n", 1)[0])
    ins, labels, pending = [], {}, []
    for line in body.splitlines():
        m_lab = re.match(r"^\s*(\.L_x_\d+):", line)
        if m_lab:
            pending.append(m_lab.group(1))
            continue
        m_ins = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if m_ins:
            addr = int(m_ins.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            ins.append((addr, m_ins.group(2)))

    def target(op):
        m_bra = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", op)
        if not m_bra:
            return None
        tgt = m_bra.group(1)
        return labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)

    best = None
    for addr, op in ins:
        # a loop closes with a predicated backward branch; the reciprocal's
        # slow-path subroutine (RET) and the kernel's exits are no loops
        tgt = target(op)
        if not op.startswith("@") or tgt is None or tgt > addr:
            continue
        loop = [(a, o) for a, o in ins if tgt <= a <= addr]
        if any("RET" in o or "EXIT" in o for _, o in loop):
            continue
        # code inside the loop that a forward branch jumps over and that
        # CALLs out: the reciprocal's slow path, off the common path
        stub = set()
        for a_br, o_br in loop:
            t_br = target(o_br)
            if t_br is not None and a_br < t_br <= addr:
                skipped = [(a, o) for a, o in loop if a_br < a < t_br]
                if any("CALL" in o for _, o in skipped):
                    stub.update(a for a, _ in skipped)
        rcp = sum("MUFU.RCP" in o for a, o in loop if a not in stub)
        key = (-rcp, len(loop))
        if rcp and (best is None or key < best[0]):
            best = (key, loop, len(stub), rcp)
    _, loop, stub, rcp = best
    n_body = len(loop)
    return n_body, stub, rcp, (n_body - stub) / rcp


def kernel_phase(dev):
    """Hold each brute-force kernel against its plain version, bit for bit,
    on every case of ``bf_cases``; time both at the render's shapes and the
    kernel on every case; print registers, occupancy and slots per test.
    Returns {name: record} for the JSON line."""
    cases = bf_cases(dev)
    kernels = {
        "brute_force_interaction": (bf.brute_force_interaction,
                                    bf.brute_force_interaction_plain, True,
                                    "interaction_kernel"),
        "brute_force_closest_hit": (bf.brute_force_closest_hit,
                                    bf.brute_force_closest_hit_plain, False,
                                    "closest_hit_kernel"),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = bf.reciprocal_mismatches(dev)
    log(f"reciprocal: the kernels' fast 1/x differs from 1.0f / x on {bad} "
        f"of the floats with 2^-126 <= |x| < 2^126")
    if bad:
        raise AssertionError(f"the kernels' reciprocal is off on {bad} floats")
    records = {}
    for name, (kern, plain, full, fn_name) in kernels.items():
        rec = _new_record(name)
        for T in (36, 4096):
            regs, blocks, threads = bf.kernel_occupancy(name, T)
            log(f"occupancy {name} at T={T}: {regs} registers, {blocks} "
                f"blocks of {threads} per SM")
        n_body, stub, rcp, slots = loop_slots(fn_name)
        log(f"sass {name}: inner loop {n_body} instructions, {stub} in the "
            f"reciprocal's slow-path stubs, {rcp} tests per pass: "
            f"{slots:.2f} slots per test")
        for case, (tris, r) in cases.items():
            args = (tris if full else tris[:3]) + r
            R, T = r[0].shape[0], tris[0].shape[0]
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err, ulp = compare(f"{name}/{case}", out, ref, n_exact=1,
                               ulp_limit=0)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            live = int((r[3] > r[2]).sum())
            reps = 20 if R * T > 10 ** 8 else 400
            ms, mhz = sm_clock_during(lambda: cuda_ms(lambda: kern(*args),
                                                      reps=reps))
            bound, by = bound_ms(name, R, T, int(out[0].sum()))
            # lane issue slots the card offered per live test in that time
            offered = (ms * 1e-3 * sms * LANES_PER_SM * mhz * 1e6
                       / max(live * T, 1))
            log(f"kernel {name} on {case}: R={R} T={T} live {live} "
                f"({live / R:.4f}), hit rate {float(out[0].float().mean()):.4f}, "
                f"hit/idx mismatches 0, max |kernel-plain| {err:.3g} ({ulp} "
                f"ulp); {ms:.4f} ms at {mhz:.0f} MHz, bound {bound:.5f} ms "
                f"({by}), exact-arithmetic floor {floor_ms(live, T):.5f} ms; "
                f"{offered:.1f} lane slots per live test")
            if case == "cornell_camera":
                rec["ms"] = ms
                rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
                rec["bound_ms"], rec["bound_by"] = bound, by
                rec["library_ms"] = None  # no single PyTorch call computes it
            elif case == "soup4096":
                soup_plain = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
                log(f"kernel {name} on {case}: plain {soup_plain:.4f} ms")
        log(f"kernel {name} on cornell_camera: {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
            f"({rec['bound_by']})")
        records[name] = rec
    return records


def live_share_phase(dev, scene, static, sensor):
    """The live share of the Cornell render's K1 and K2 launches: the same
    render as the render phase, with the scene module's handle on the
    wrappers swapped for one that sums each call's live lanes
    (t_max > t_min) on the device before it calls the wrapper."""
    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    settings = api.RenderSettings(width=W, height=H, spp=SPP,
                                  spp_per_pass=SPP_PER_PASS, seed=SEED)
    names = ("brute_force_interaction", "brute_force_closest_hit")
    live = {n: torch.zeros((), dtype=torch.int64, device=dev) for n in names}
    slots = dict.fromkeys(names, 0)

    def counting(n):
        fn = getattr(bf, n)

        def call(*args):
            live[n] += (args[-1] > args[-2]).sum()
            slots[n] += args[-1].shape[0]
            return fn(*args)
        return call

    real = scene_mod.bf
    scene_mod.bf = types.SimpleNamespace(**{n: counting(n) for n in names})
    try:
        api.render(scene, static, sensor, cfg, settings, device=dev)
    finally:
        scene_mod.bf = real
    for n in names:
        lv = int(live[n])
        log(f"render cornell live lanes of {n}: {lv} of {slots[n]} "
            f"({lv / max(slots[n], 1):.4f})")


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


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lane_bound_ms(nodes, R, visits, ray_bytes, leaf_bytes=48, extra_bytes=0,
                  extra_flops=0, map_read=None):
    """Least time for a lane-kernel call on an H100: the larger of its bytes
    over HBM bandwidth and its fp32 operations over the fp32 peak. Bytes:
    each row of ``nodes`` the call reads, once (32 bytes of an internal
    node, 48 of a leaf, as the kernel loads them), each tie-rule map entry
    it reads (``map_read``), and each ray's inputs and outputs once;
    operations: every visit's test. ``visits`` = (per-lane internal and leaf
    visit counts, rows read) from the plain version; for a walk over the
    octant tables ``nodes`` is their (8 N, 12) rows."""
    v_int, v_leaf, touched = visits[:3]
    leaf = nodes[:, 7] >= 0
    nbytes = (int((touched & ~leaf).sum()) * 32
              + int((touched & leaf).sum()) * leaf_bytes + R * ray_bytes
              + extra_bytes
              + (0 if map_read is None else MAP_BYTES * int(map_read.sum())))
    flops = (int(v_int.sum()) * FLOPS_PER_BOX + int(v_leaf.sum()) * FLOPS_PER_TEST
             + extra_flops)
    return _bound(nbytes, flops)


def octant_rows(octants):
    """The rows of the 8 octant tables as one (8 N, 12) table, the layout
    the plain versions' rows-read masks index."""
    return octants.nodes.reshape(-1, cb.NODE_COLS)


def warp_efficiency(total):
    """Lane visits over 32 x the sum of each warp's longest lane, for warps
    of 32 consecutive lanes in the launch's ray order: the share of a
    one-thread-per-ray launch's lane slots that walk."""
    w = torch.cat([total, total.new_zeros(-total.numel() % 32)]).reshape(-1, 32)
    return int(total.sum()) / max(32 * int(w.amax(dim=1).sum()), 1)


def _visits_line(visits, live):
    total = visits[0] + visits[1]
    n = int(total.sum())
    n_live = max(int(live.sum()), 1)
    rows = int(visits[2].sum())
    # what HBM would move if no visit hit a cache (the kernel reads 32 bytes
    # of an internal node, 48 of a leaf)
    uncached_ms = (int(visits[0].sum()) * 32 + int(visits[1].sum()) * 48) \
        / PEAK_BYTES * 1e3
    return (f"visits {n} ({float(total.float().mean()):.2f} per ray, "
            f"{n / n_live:.2f} per live ray, max {int(total.max())}, leaf "
            f"share {int(visits[1].sum()) / max(n, 1):.3f}), "
            f"{rows} distinct nodes ({rows * 4 * cb.NODE_COLS / 1e6:.1f} MB "
            f"of 48-byte rows; L2 50 MB), warp efficiency "
            f"{warp_efficiency(total):.3f}, uncached node traffic "
            f"{uncached_ms:.4f} ms at peak bandwidth")


def check_root_kernel(name, kern, plain, nodes, N, o, d, t_min, t_max,
                      octants=None):
    """K4/K5: kernel == plain version bit for bit (hit/idx exact, floats 0
    ulp) on closest and any-hit queries (K5's closest-hit lanes on
    ``octants``); time both on the closest query. Returns the record and
    the closest query's (result, visits)."""
    rec = dict(name=name, route="cuda", source=REPO_PATHS[name][0],
               replaces=REPO_PATHS[name][1], max_abs_err=0.0)
    kw = {} if octants is None else {"octants": octants}
    R = o.shape[0]
    for any_hit in (False, True):
        out = kern(nodes, N, o, d, t_min, t_max, any_hit=any_hit, **kw)
        ref = plain(nodes, N, o, d, t_min, t_max, any_hit=any_hit,
                    with_visits=True, **kw)
        torch.cuda.synchronize()
        err, ulp = compare(f"{name}/any_hit={any_hit}", out, ref[:5],
                           n_exact=1, ulp_limit=0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"kernel {name} any_hit={any_hit}: R={R} N={N} hit/idx "
            f"mismatches 0, max |kernel-plain| {err:.3g} ({ulp} ulp), hit rate "
            f"{float(out[0].float().mean()):.4f}, "
            f"{_visits_line(ref[5], t_max > t_min)}")
        if not any_hit:
            closest = out, ref[5]
            visits = ref[5]
    rec["ms"] = cuda_ms(lambda: kern(nodes, N, o, d, t_min, t_max, **kw),
                        reps=20)
    rec["plain_ms"] = cuda_ms(lambda: plain(nodes, N, o, d, t_min, t_max,
                                            **kw), reps=1, warmup=1)
    rows = nodes if octants is None else octant_rows(octants)
    rec["bound_ms"], rec["bound_by"] = lane_bound_ms(rows, R, visits,
                                                     K4_RAY_BYTES,
                                                     map_read=visits[3])
    rec["library_ms"] = None  # no single PyTorch call computes it
    log(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec, closest


def _root_state(N, rays, t_max):
    R = t_max.shape[0]
    dev = t_max.device
    return (torch.where(t_max > rays[6], 0, N).to(torch.int32), t_max,
            torch.full((R,), -1, dtype=torch.int32, device=dev),
            torch.zeros(R, device=dev), torch.zeros(R, device=dev))


def check_chunk_kernel(name, kern, plain, nodes, N, rays, t_max, budget,
                       any_hit, rec=None, octants=None):
    """K3/K6: a launch of ``budget`` visits from the root, then the resumed
    rest: kernel == plain version bit for bit after each (closest-hit lanes
    on ``octants``). On the first call (rec None) also time one unbounded
    launch from the root, the kernel's whole walk in one launch, and its
    plain version."""
    new = rec is None
    if new:
        rec = dict(name=name, route="cuda", source=REPO_PATHS[name][0],
                   replaces=REPO_PATHS[name][1], max_abs_err=0.0)
    kw = {} if octants is None else {"octants": octants}
    state = _root_state(N, rays, t_max)
    for step, steps in ((f"bounded ({budget} visits)", budget),
                        ("resumed to the end", 0)):
        out = kern(nodes, N, *rays, *state, any_hit=any_hit, max_steps=steps,
                   **kw)
        ref = plain(nodes, N, *rays, *state, any_hit=any_hit, max_steps=steps,
                    with_visits=True, **kw)
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
        # one plain call gives the visits and the plain version's time
        full, rec["plain_ms"] = device_ms(lambda: plain(
            nodes, N, *rays, *root, any_hit=any_hit, with_visits=True, **kw))
        rec["ms"] = cuda_ms(lambda: kern(nodes, N, *rays, *root,
                                         any_hit=any_hit, **kw), reps=20)
        rows = nodes if octants is None or any_hit else octant_rows(octants)
        rec["bound_ms"], rec["bound_by"] = lane_bound_ms(
            rows, t_max.shape[0], full[5], K3_RAY_BYTES, map_read=full[5][3])
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


def packer_line(label, scene):
    """Time pack_nodes_octants on ``scene``'s canonical table again (the
    builder ran it once) and print it with the tables' device bytes."""
    nodes_np, roots = scene.nodes.cpu().numpy(), scene.tl_root.cpu().numpy()
    t0 = time.perf_counter()
    cb.pack_nodes_octants(nodes_np, roots)
    dt = time.perf_counter() - t0
    nbytes = sum(x.numel() * x.element_size() for x in scene.octants)
    log(f"octant packer {label}: {nodes_np.shape[0]} nodes, {len(roots)} "
        f"treelets, {dt:.3f} s on the host, tables {nbytes} bytes on the "
        f"device")


def against_canonical(label, out, ref):
    """An octant walk's (hit, t, idx, u, v) against the canonical walk's on
    the same rays: hit equal and t equal on every lane, except lanes whose
    t differ by at most NEAR_TIE_RTOL (a box entry rounded past a hit),
    each printed; idx/u/v mismatches where t is equal counted and printed.
    Raises on anything else."""
    hit, t, idx, u, v = out
    rhit, rt, ridx, ru, rv = ref
    if not torch.equal(hit, rhit):
        raise AssertionError(f"{label}: {int((hit != rhit).sum())} lanes "
                             f"differ on hit")
    bad_t = hit & (t != rt)
    gap = (t - rt).abs() / rt.abs().clamp(min=1e-30)
    same = hit & (t == rt)
    bad_i = same & ((idx != ridx) | (u != ru) | (v != rv))
    for lane in torch.nonzero(bad_t | bad_i).squeeze(1).tolist()[:100]:
        log(f"{label}: lane {lane}: t {float(t[lane])!r} (canonical "
            f"{float(rt[lane])!r}, relative gap {float(gap[lane]):.3g}), idx "
            f"{int(idx[lane])} (canonical {int(ridx[lane])})")
    log(f"{label}: {int(hit.sum())} hits; t mismatches {int(bad_t.sum())} "
        f"(near-ties), idx/u/v mismatches where t is equal "
        f"{int(bad_i.sum())}")
    if bool((gap[bad_t] > NEAR_TIE_RTOL).any()):
        raise AssertionError(f"{label}: a t mismatch beyond a near-tie")


def chunk_result(out):
    """A resumable kernel's (t, idx, u, v, node) after its walk as the
    (hit, t, idx, u, v) of a walk from the root."""
    h = out[1] >= 0
    return h, torch.where(h, out[0], torch.inf), out[1], out[2], out[3]


def walk_visits(label, walks, live, N):
    """Print each walk's visits per live lane and distinct rows read per
    table; returns {walk: mean visits per live lane}."""
    mean = {}
    for name, vis in walks.items():
        n = (vis[0] + vis[1])[live]
        mean[name] = float(n.float().mean())
        per_table = vis[2].reshape(-1, N).sum(dim=1).tolist()
        log(f"{label} visits, {name} walk: mean {mean[name]:.3f} per live "
            f"lane, max {int(n.max())}; distinct rows read "
            f"{int(vis[2].sum())} (per table {per_table})")
    return mean


def in_turns(label, kern, reps=20):
    """Device time of each of ``kern``'s two calls (yardstick first) in the
    order yardstick, kernel, kernel, yardstick; printed and returned."""
    (a, fa), (b, fb) = kern.items()
    turns = [(k, cuda_ms(f, reps=reps)) for k, f in
             ((a, fa), (b, fb), (b, fb), (a, fa))]
    log(f"{label}, in turns: " + ", ".join(f"{k} {ms:.4f} ms"
                                           for k, ms in turns))
    return turns


def k3_octant_phase(nodes, N, octants, rays, tmx):
    """K3's closest-hit walk on the octant tables against the canonical
    walk on the same sorted bounce rays: one unbounded launch each against
    K4 (hit and t), visits per live lane, and times in turns against K4,
    which walks the canonical table from the root."""
    R = tmx.shape[0]
    root = _root_state(N, rays, tmx)
    live = root[0] < N
    o, d = torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1)
    k4 = cb.bvh_traverse_lane_packed(nodes, N, o, d, rays[6], tmx)
    against_canonical("K3 octant walk vs K4 canonical walk", chunk_result(
        cb.lane_chunk(nodes, N, *rays, *root, octants=octants)), k4)
    mean = walk_visits("K3 on the sorted bounce rays", {
        "octant (K3)": cb.lane_chunk_plain(
            nodes, N, *rays, *root, octants=octants, with_visits=True)[5],
        "canonical (K4)": cb.bvh_traverse_lane_packed_plain(
            nodes, N, o, d, rays[6], tmx, with_visits=True)[5]}, live, N)
    if not mean["octant (K3)"] < mean["canonical (K4)"]:
        raise AssertionError("the octant walk visits no fewer nodes than the "
                             "canonical walk")
    in_turns(f"K3 (octant tables) against K4 (canonical walk), one "
             f"unbounded launch each on the same {R} sorted bounce rays", {
                 "K4": lambda: cb.bvh_traverse_lane_packed(nodes, N, o, d,
                                                           rays[6], tmx),
                 "K3": lambda: cb.lane_chunk(nodes, N, *rays, *root,
                                             octants=octants)})


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
    octants = scene.octants
    packer_line("bunny", scene)
    for name in ("lane_chunk", "treelet_rounds"):
        regs, blocks = cb.kernel_occupancy(name)
        log(f"occupancy {name}: {regs} registers, {blocks} blocks of 128 per "
            f"SM = {blocks * 128} threads; one wave holds "
            f"{blocks * 128 * torch.cuda.get_device_properties(dev).multi_processor_count} rays")
    cam = camera_rays(sensor, dev)
    records = {"bvh_traverse_lane_packed": check_root_kernel(
        "bvh_traverse_lane_packed", cb.bvh_traverse_lane_packed,
        cb.bvh_traverse_lane_packed_plain, nodes, N, *cam)[0]}

    bounce, shadow = first_bounce_rays(scene, static, cam[0], cam[1])
    rec = None
    for any_hit, (o, d, t_min, t_max), sched in (
            (False, bounce, scene_mod.BVH_RESORT),
            (True, shadow, scene_mod.BVH_RESORT_SHADOW)):
        # K3 sees the rays as the resort loop hands them over: sorted
        (*rays, tmx), _ = cb.sort_rays(o, d, t_min, t_max, lo, hi)
        rec = check_chunk_kernel("lane_chunk", cb.lane_chunk,
                                 cb.lane_chunk_plain, nodes, N, tuple(rays),
                                 tmx, sched[1] * sched[2], any_hit, rec,
                                 octants=octants)
        if not any_hit:
            k3_octant_phase(nodes, N, octants, tuple(rays), tmx)
        # does the coherence sort pay on the card? the whole query with the
        # JAX schedule, with the sort and one unbounded launch, and one
        # unbounded launch on the rays as they come
        rounds, chunk_nit, strip = sched
        t_sched = cuda_ms(lambda: cb.bvh_traverse_lane_resort(
            nodes, N, o, d, t_min, t_max, lo, hi, any_hit=any_hit,
            rounds=rounds, chunk_nit=chunk_nit, strip=strip,
            octants=octants), reps=10)
        t_sort1 = cuda_ms(lambda: cb.bvh_traverse_lane_resort(
            nodes, N, o, d, t_min, t_max, lo, hi, any_hit=any_hit,
            rounds=0, octants=octants), reps=10)
        raw = tuple(x[:, k].contiguous() for x in (o, d) for k in range(3))
        raw = raw + (t_min,)
        root = _root_state(N, raw, t_max)
        t_raw = cuda_ms(lambda: cb.lane_chunk(nodes, N, *raw, *root,
                                              any_hit=any_hit,
                                              octants=octants), reps=10)
        t_one = cuda_ms(lambda: cb.lane_chunk(nodes, N, *rays,
                                              *_root_state(N, rays, tmx),
                                              any_hit=any_hit,
                                              octants=octants), reps=10)
        log(f"coherence {'shadow' if any_hit else 'bounce'} query "
            f"(R={o.shape[0]}, live {int((t_max > t_min).sum())}): schedule "
            f"{rounds},{chunk_nit},{strip} {t_sched:.4f} ms; sort + one "
            f"unbounded K3 + unsort {t_sort1:.4f} ms; one unbounded K3 on "
            f"sorted rays {t_one:.4f} ms; one unbounded K3 unsorted "
            f"{t_raw:.4f} ms")
    records["lane_chunk"] = rec
    records.update(treelet_kernel_phase(scene, cam, bounce, shadow))
    records.update(fat_kernel_phase(scene, cam, bounce))
    records.update(wide_kernel_phase(scene, bounce))
    return records


def device_ms(fn):
    """fn() and its device time by CUDA events, for one call of a plain
    version (its host loop synchronizes as it goes)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _zero_counts():
    for k in KERNELS.values():
        k.launches = 0


def _check_launches(label, expected):
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"{label} launches {launches}")
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {expected.get(name, 0)}")
    return launches


def _new_record(name):
    return dict(name=name, route="cuda", source=REPO_PATHS[name][0],
                replaces=REPO_PATHS[name][1], max_abs_err=0.0)


def treelet_kernel_phase(scene, cam, bounce, shadow):
    """K7 against its plain version bit for bit on the camera rays (as they
    come, the render's presorted query), the bounce rays and the shadow rays
    (sorted as its query function sorts them); the bounce query through
    the K7 query function against the K3 resort query."""
    nodes, lo, hi = scene.nodes, scene.aabb_lo, scene.aabb_hi
    octants = scene.octants
    tl = (scene.tl_root, scene.tl_skip, scene.tl_lo, scene.tl_hi)
    tab = cb.treelet_table(*tl, octants.tl_range)
    K = tab.shape[0]
    log(f"treelets: K={K} (treelet_roots max_nodes "
        f"{scene_mod.TREELET_MAX_NODES}), nodes {nodes.shape[0]}")

    def sorted_rays(o, d, t_min, t_max):
        orig = torch.argsort(cb.treelet_sort_keys(o, d, t_min, t_max, tl[2],
                                                  tl[3], lo, hi), stable=True)
        return o[orig], d[orig], t_min[orig], t_max[orig]

    rec = _new_record("treelet_rounds")
    for label, rays, any_hit in (("camera", cam, False),
                                 ("bounce", sorted_rays(*bounce), False),
                                 ("shadow", sorted_rays(*shadow), True)):
        o, d, t_min, t_max = rays
        kw = dict(any_hit=any_hit, octants=octants)
        out = cb.treelet_rounds(nodes, tab, o, d, t_min, t_max, **kw)
        ref = cb.treelet_rounds_plain(nodes, tab, o, d, t_min, t_max,
                                      with_visits=True, **kw)
        lst = cb.treelet_list_plain(nodes, tab, o, d, t_min, t_max,
                                    with_visits=True, **kw)
        torch.cuda.synchronize()
        err, ulp = compare(f"treelet_rounds/{label}", out, ref[:5], n_exact=1,
                           ulp_limit=0)
        compare(f"treelet_rounds/{label} (entry list)", out, lst[:5],
                n_exact=1, ulp_limit=0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms = cuda_ms(lambda: cb.treelet_rounds(nodes, tab, o, d, t_min, t_max,
                                               **kw), reps=20)
        visits = lst[5]
        live = t_max > t_min
        R = o.shape[0]
        bound, by = lane_bound_ms(
            nodes if any_hit else octant_rows(octants), R, visits,
            K4_RAY_BYTES, extra_bytes=K * K7_TREELET_BYTES,
            extra_flops=int(visits[3].sum()) * FLOPS_PER_BOX,
            map_read=visits[4])
        entered = visits[5][live].float()
        log(f"kernel treelet_rounds {label} (any_hit={any_hit}): R={R} K={K} "
            f"hit/idx mismatches 0 against both plain versions, max "
            f"|kernel-plain| {err:.3g} ({ulp} ulp), hit rate "
            f"{float(out[0].float().mean()):.4f}, root-box tests "
            f"{int(visits[3].sum())} ({float(visits[3].float().mean()):.2f} "
            f"per ray, {float(visits[3][live].float().mean()):.2f} per live "
            f"ray; the JAX rounds' {float(ref[5][3].float().mean()):.2f} per "
            f"ray), root boxes entered per live ray mean "
            f"{float(entered.mean()):.2f}, max {int(entered.max())}, share "
            f"above {cb.TREELET_LIST} "
            f"{float((entered > cb.TREELET_LIST).float().mean()):.4f}, "
            f"{_visits_line(visits, live)}; {ms:.4f} ms, bound {bound:.5f} "
            f"ms ({by})")
        if label == "bounce":
            _, rec["plain_ms"] = device_ms(lambda: cb.treelet_rounds_plain(
                nodes, tab, o, d, t_min, t_max, octants=octants))
            rec.update(ms=ms, bound_ms=bound, bound_by=by, library_ms=None)
    o, d, t_min, t_max = bounce
    rounds, chunk_nit, strip = scene_mod.BVH_RESORT
    t_k7 = cuda_ms(lambda: cb.bvh_traverse_treelets(
        nodes, *tl, o, d, t_min, t_max, lo, hi, octants=octants), reps=10)
    t_k3 = cuda_ms(lambda: cb.bvh_traverse_lane_resort(
        nodes, nodes.shape[0], o, d, t_min, t_max, lo, hi,
        rounds=rounds, chunk_nit=chunk_nit, strip=strip, octants=octants),
        reps=10)
    k7q = cb.bvh_traverse_treelets(nodes, *tl, o, d, t_min, t_max, lo, hi,
                                   octants=octants)
    k3q = cb.bvh_traverse_lane_resort(nodes, nodes.shape[0], o, d, t_min,
                                      t_max, lo, hi, rounds=rounds,
                                      chunk_nit=chunk_nit, strip=strip,
                                      octants=octants)
    if not (torch.equal(k7q[0], k3q[0]) and torch.equal(k7q[1], k3q[1])):
        raise AssertionError("bounce query: K7 and K3 queries disagree on "
                             "hit or t")
    log(f"bounce query (R={o.shape[0]}, live {int((t_max > t_min).sum())}): "
        f"K7 query (sort + K7 + unsort) {t_k7:.4f} ms; K3 resort query "
        f"{rounds},{chunk_nit},{strip} {t_k3:.4f} ms; hit and t equal")
    log(f"kernel treelet_rounds: {rec['ms']:.4f} ms (bounce), plain "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return {"treelet_rounds": rec}


def scene_tris(scene):
    """The scene's triangles as float32 numpy (p0, e1, e2) and their float64
    bounds."""
    p0, e1, e2 = (x.cpu().numpy() for x in (scene.tri_p0, scene.tri_e1,
                                             scene.tri_e2))
    lo, hi = triangle_aabbs(*(x.astype(np.float64) for x in (p0, p0 + e1,
                                                            p0 + e2)))
    return (p0, e1, e2), (lo, hi)


def fat_kernel_phase(scene, cam, bounce):
    """K8 on the fat rows of a leaf-4 tree of the bunny's triangles: kernel
    == plain bit for bit on camera and bounce rays, closest and any-hit, and
    with per-ray [start, end) treelet ranges; then the sorting query with
    the counts set to 0."""
    dev = scene.nodes.device
    lo, hi = scene.aabb_lo, scene.aabb_hi
    tris, box = scene_tris(scene)
    t0 = time.perf_counter()
    bvh4 = build_bvh(*box, leaf_size=cb.FAT_LEAF_SIZE)
    fat = torch.as_tensor(cb.pack_nodes_fat(bvh4, *tris), device=dev)
    N = fat.shape[0]
    counts = fat[:, 7].to(torch.int64)
    log(f"fat rows: leaf-4 tree of {len(tris[0])} triangles, {N} nodes, "
        f"{int((counts > 0).sum())} leaves, built and packed in "
        f"{time.perf_counter() - t0:.2f} s")
    roots = treelet_roots(bvh4, max_nodes=scene_mod.TREELET_MAX_NODES)
    r_root, r_skip, r_lo, r_hi = (torch.as_tensor(x, device=dev) for x in (
        roots.astype(np.int32), bvh4.skip[roots].astype(np.int32),
        bvh4.lo[roots], bvh4.hi[roots]))
    (*srt, tmx), _ = cb.sort_rays(*bounce, lo, hi)
    b_sorted = (torch.stack(srt[0:3], -1), torch.stack(srt[3:6], -1), srt[6],
                tmx)
    sel = cb.nearest_treelet(*b_sorted, r_lo, r_hi)
    ranges = (r_root[sel].contiguous(), r_skip[sel].contiguous())

    def bound_of(visits, R, bounded):
        # 32 B of box per node read; 48 B per triangle only of the leaves
        # whose box some lane entered (the kernel reads no other slot)
        v_node, v_tri, touched, opened = visits
        nbytes = (int(touched.sum()) * 32
                  + int((counts * opened).sum()) * 48
                  + R * (K4_RAY_BYTES + (K8_RANGE_BYTES if bounded else 0)))
        return _bound(nbytes, int(v_node.sum()) * FLOPS_PER_BOX
                      + int(v_tri.sum()) * FLOPS_PER_TEST)

    rec = _new_record("bvh_traverse_packed")
    for label, rays, rng, any_hit in (
            ("camera", cam, (None, None), False),
            ("camera", cam, (None, None), True),
            ("bounce", b_sorted, (None, None), False),
            ("bounce", b_sorted, (None, None), True),
            ("bounce [start, end)", b_sorted, ranges, False)):
        out = cb.bvh_traverse_packed(fat, *rays, *rng, any_hit=any_hit)
        ref = cb.bvh_traverse_packed_plain(fat, *rays, *rng, any_hit=any_hit,
                                           with_visits=True)
        torch.cuda.synchronize()
        err, ulp = compare(f"bvh_traverse_packed/{label}/any_hit={any_hit}",
                           out, ref[:5], n_exact=1, ulp_limit=0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        v_node, v_tri, touched, opened = ref[5]
        ms = cuda_ms(lambda: cb.bvh_traverse_packed(fat, *rays, *rng,
                                                    any_hit=any_hit), reps=20)
        R = rays[0].shape[0]
        bound, by = bound_of(ref[5], R, rng[0] is not None)
        log(f"kernel bvh_traverse_packed {label} any_hit={any_hit}: R={R} "
            f"hit/idx mismatches 0, max |kernel-plain| {err:.3g} ({ulp} ulp), "
            f"hit rate {float(out[0].float().mean()):.4f}, node visits "
            f"{int(v_node.sum())} ({float(v_node.float().mean()):.2f} per ray, "
            f"max {int(v_node.max())}), triangle tests {int(v_tri.sum())}, "
            f"{int(touched.sum())} distinct nodes ({int(opened.sum())} leaves "
            f"opened); {ms:.4f} ms, bound "
            f"{bound:.5f} ms ({by})")
        if label == "bounce" and not any_hit:
            _, rec["plain_ms"] = device_ms(lambda: cb.bvh_traverse_packed_plain(
                fat, *rays))
            rec.update(ms=ms, bound_ms=bound, bound_by=by, library_ms=None)
    # the op as a caller drives it: sort, K8, unsort, closest and any-hit
    _zero_counts()
    res = [cb.bvh_traverse(fat, *bounce, lo, hi, any_hit=a) for a in (False, True)]
    torch.cuda.synchronize()
    launches = _check_launches("bvh_traverse (K8 query)",
                               {"bvh_traverse_packed": 2})
    rec["launches"] = launches["bvh_traverse_packed"]
    if not torch.equal(res[0][0], res[1][0]):
        raise AssertionError("K8 query: closest and any-hit disagree on hits")
    log(f"kernel bvh_traverse_packed: {rec['ms']:.4f} ms (sorted bounce), plain "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return {"bvh_traverse_packed": rec}


def wide_kernel_phase(scene, bounce):
    """K9 on pack_pages_w of a leaf-1 tree of the bunny's triangles: a
    bounded launch on the sorted bounce rays and the resumed rest, kernel ==
    plain bit for bit; one unbounded launch timed beside K3 on the same tree
    and rays, and held bit for bit against K4, which walks the canonical
    table from the root as K9 does (K3's closest-hit walk on the octant
    tables only against hit and t, near-ties printed); then its resort query
    with the counts set to 0, held bit for bit against K4's sorted query."""
    dev = scene.nodes.device
    lo, hi = scene.aabb_lo, scene.aabb_hi
    tris, box = scene_tris(scene)
    bvh = build_bvh(*box)
    N = len(bvh.lo)
    pages = torch.as_tensor(cb.pack_pages_w(bvh, *tris), device=dev)
    nodes_np = cb.pack_nodes(bvh, *tris)
    nodes = torch.as_tensor(nodes_np, device=dev)
    octants = cb.octant_tables(nodes_np, device=dev)
    (*rays, tmx), _ = cb.sort_rays(*bounce, lo, hi)
    rays = tuple(rays)
    budget = 16 * cb.LSTRIP   # the resort query's default chunk_nit x strip
    rec = _new_record("lane_chunk_w")
    state = _root_state(N, rays, tmx)
    for step, steps in ((f"bounded ({budget} visits)", budget),
                        ("resumed to the end", 0)):
        out = cb.lane_chunk_w(pages, N, *rays, *state, max_steps=steps)
        ref = cb.lane_chunk_w_plain(pages, N, *rays, *state, max_steps=steps,
                                    with_visits=True)
        torch.cuda.synchronize()
        err, ulp = compare(f"lane_chunk_w/{step}", out, ref[:5], n_exact=0,
                           ulp_limit=0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"kernel lane_chunk_w {step}: R={tmx.shape[0]} N={N} page "
            f"{cb.WIDE_PAGE} ({pages.shape[0]} rows) idx/node mismatches 0, "
            f"max |kernel-plain| {err:.3g} ({ulp} ulp), lanes still walking "
            f"{int((out[4] < N).sum())}, {_visits_line(ref[5], state[0] < N)}")
        state = (out[4], out[0], out[1], out[2], out[3])
    root = _root_state(N, rays, tmx)
    full, rec["plain_ms"] = device_ms(lambda: cb.lane_chunk_w_plain(
        pages, N, *rays, *root, with_visits=True))
    k9 = chunk_result(cb.lane_chunk_w(pages, N, *rays, *root))
    if not all(torch.equal(a, b) for a, b in zip(
            k9, cb.bvh_traverse_lane_packed(
                nodes, N, torch.stack(rays[0:3], -1),
                torch.stack(rays[3:6], -1), rays[6], tmx))):
        raise AssertionError("K9 and K4 (the canonical walk) disagree on the "
                             "same tree")
    against_canonical("K3 octant walk vs K9", chunk_result(
        cb.lane_chunk(nodes, N, *rays, *root, octants=octants)), k9)
    rec["ms"] = cuda_ms(lambda: cb.lane_chunk_w(pages, N, *rays, *root),
                        reps=20)
    t_k3 = cuda_ms(lambda: cb.lane_chunk(nodes, N, *rays, *root,
                                         octants=octants), reps=20)
    rec["bound_ms"], rec["bound_by"] = lane_bound_ms(
        nodes, tmx.shape[0], full[5], K3_RAY_BYTES, leaf_bytes=K9_LEAF_BYTES)
    rec["library_ms"] = None  # no single PyTorch call computes it
    log(f"kernel lane_chunk_w (one unbounded launch, sorted bounce rays): "
        f"{rec['ms']:.4f} ms, K3 on the same tree and rays {t_k3:.4f} ms, "
        f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}), {_visits_line(full[5], root[0] < N)}")
    _zero_counts()
    res = cb.bvh_traverse_lane_resort_w(pages, N, *bounce, lo, hi)
    torch.cuda.synchronize()
    launches = _check_launches("bvh_traverse_lane_resort_w (K9 query)",
                               {"lane_chunk_w": 3})
    rec["launches"] = launches["lane_chunk_w"]
    ref = cb.bvh_traverse_lane(nodes, N, *bounce, lo, hi, sort=True)
    if not all(torch.equal(a, b) for a, b in zip(res, ref)):
        raise AssertionError("K9's resort query and K4's sorted query "
                             "disagree")
    against_canonical("K3 resort query vs K9 resort query",
                      cb.bvh_traverse_lane_resort(nodes, N, *bounce, lo, hi,
                                                  rounds=2, chunk_nit=16,
                                                  octants=octants), res)
    return {"lane_chunk_w": rec}


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


def large_tier_rays(scene):
    """bench.py:205-212: 2^18 rays from a sphere around the scene, aimed at
    a smaller sphere inside it, on the scene's device: (o, d, t_min,
    t_max)."""
    dev = scene.nodes.device
    lo_np, hi_np = (x.cpu().numpy().astype(np.float64)
                    for x in (scene.aabb_lo, scene.aabb_hi))
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
    return (torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev),
            torch.full((R,), 1e-4, device=dev),
            torch.full((R,), 1e9, device=dev))


def large_tier_phase(dev):
    """K5 and K6 above LANE_VMEM_MAX_NODES on bench's 262,144 sorted rays:
    kernel == plain version bit for bit (K5 closest and any-hit; K6 bounded,
    then resumed, closest and any-hit); their closest hits against K4's
    canonical walk of the same tree and rays; visits against K4's; each
    timed in turns with K4; then the tier's queries with the launch counts
    read. Returns ({name: record}, launches)."""
    t0 = time.perf_counter()
    scene, static = large_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    N = static.n_bvh_nodes
    if N <= cb.LANE_VMEM_MAX_NODES:
        raise AssertionError(f"{N} nodes: the large tier must exceed "
                             f"{cb.LANE_VMEM_MAX_NODES}")
    log(f"large tier: {static.n_tris} triangles, {N} BVH nodes, scene built "
        f"(BVH, packing, octant tables, upload) in {build_s:.2f} s")
    packer_line("large tier", scene)
    nodes, lo, hi, octants = scene.nodes, scene.aabb_lo, scene.aabb_hi, \
        scene.octants
    o, d, t_min, t_max = large_tier_rays(scene)
    R = o.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("lane_hbm", "lane_chunk_hbm", "lane_hbm any_hit",
                 "lane_chunk_hbm any_hit"):
        regs, blocks = cb.kernel_occupancy(name)
        log(f"occupancy {name}: {regs} registers, {blocks} blocks of 128 per "
            f"SM; grid of {-(-R // 128)} blocks for {R} rays "
            f"(one wave: {blocks * sms} blocks, {blocks * sms * 128} lanes)")

    # the kernels see sorted rays, as their query functions hand them over
    (*rays, tmx), _ = cb.sort_rays(o, d, t_min, t_max, lo, hi)
    rays = tuple(rays)
    so, sd = torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1)
    k5, (k5_out, k5_visits) = check_root_kernel(
        "lane_hbm", cb.lane_hbm, cb.lane_hbm_plain, nodes, N, so, sd, rays[6],
        tmx, octants=octants)
    k6 = None
    for any_hit in (False, True):
        k6 = check_chunk_kernel("lane_chunk_hbm", cb.lane_chunk_hbm,
                                cb.lane_chunk_hbm_plain, nodes, N, rays, tmx,
                                LARGE_CHUNK * cb.LSTRIP, any_hit, k6,
                                octants=octants)
    # the redesigned walks against K4's canonical walk of the same tree and
    # rays (K4 was K5's code before): results, visits, times in turns
    root = _root_state(N, rays, tmx)
    live = root[0] < N
    k4 = {a: lambda a=a: cb.bvh_traverse_lane_packed(nodes, N, so, sd,
                                                     rays[6], tmx, any_hit=a)
          for a in (False, True)}
    canonical = k4[False]()
    against_canonical("K5 octant walk vs K4 canonical walk", k5_out,
                      canonical)
    against_canonical("K6 octant walk (one unbounded launch) vs K4 canonical "
                      "walk", chunk_result(cb.lane_chunk_hbm(
                          nodes, N, *rays, *root, octants=octants)), canonical)
    canon = cb.bvh_traverse_lane_packed_plain(nodes, N, so, sd, rays[6], tmx,
                                              with_visits=True)[5]
    log(f"large tier, K4 canonical walk (closest hit): "
        f"{_visits_line(canon, live)}")
    walk_visits("large tier, closest hit", {"octant (K5, K6)": k5_visits,
                                            "canonical (K4)": canon}, live, N)
    label = f"one unbounded launch each on the same {R} sorted rays"
    in_turns(f"K5 closest hit against K4, {label}", {
        "K4": k4[False],
        "K5": lambda: cb.lane_hbm(nodes, N, so, sd, rays[6], tmx,
                                  octants=octants)})
    in_turns(f"K5 any-hit against K4, {label}", {
        "K4": k4[True],
        "K5": lambda: cb.lane_hbm(nodes, N, so, sd, rays[6], tmx,
                                  any_hit=True)})
    in_turns(f"K6 closest hit against K4, {label}", {
        "K4": k4[False],
        "K6": lambda: cb.lane_chunk_hbm(nodes, N, *rays, *root,
                                        octants=octants)})
    records = {"lane_hbm": k5, "lane_chunk_hbm": k6}

    # the tier's queries: scene closest hit and shadow ray (K5), bench's
    # resort query (K6), with the counts set to 0 just before
    _zero_counts()
    its = scene_mod.ray_intersect(scene, static, o, d, 1e-4, 1e9)
    occ = scene_mod.occluded(scene, static, o, d, 1e-4, 1e9)
    res = cb.bvh_traverse_lane_hbm_resort(nodes, N, o, d, t_min, t_max, lo, hi,
                                          rounds=LARGE_ROUNDS,
                                          chunk_nit=LARGE_CHUNK,
                                          octants=octants)
    torch.cuda.synchronize()
    launches = _check_launches("large tier", {"lane_hbm": 2,
                                              "lane_chunk_hbm": LARGE_ROUNDS + 1})
    if not (torch.equal(its.valid, res[0]) and torch.equal(occ, res[0])
            and torch.equal(its.prim_id, torch.where(res[0], res[2], -1))):
        raise AssertionError("large tier: K5 and K6 queries disagree")
    hit_rate = float(res[0].float().mean())
    t_k6 = cuda_ms(lambda: cb.bvh_traverse_lane_hbm_resort(
        nodes, N, o, d, t_min, t_max, lo, hi, rounds=LARGE_ROUNDS,
        chunk_nit=LARGE_CHUNK, octants=octants), reps=3, warmup=1)
    t_k5 = cuda_ms(lambda: cb.bvh_traverse_lane_hbm(
        nodes, N, o, d, t_min, t_max, lo, hi, sort=True, octants=octants),
        reps=3, warmup=1)
    log(f"large tier: hit rate {hit_rate:.4f}; resort query (K6, rounds "
        f"{LARGE_ROUNDS}, chunk {LARGE_CHUNK}) {t_k6:.3f} ms = "
        f"{R / t_k6 * 1e3:.1f} rays/s; sorted query (K5) {t_k5:.3f} ms = "
        f"{R / t_k5 * 1e3:.1f} rays/s")
    if f"{hit_rate:.4f}" != LARGE_HIT_RATE:
        raise AssertionError(f"large tier: hit rate {hit_rate:.4f}, expected "
                             f"{LARGE_HIT_RATE}")
    return records, launches


def render_phase(dev, label, scene, static, sensor, eye, at, fov, spp,
                 spp_per_pass, ref_mean, rtol, expected):
    """The port's main path: api.render at 512x512, depth 5, seed 0, with
    every launch count set to 0 just before and read just after; checks the
    counts against ``expected`` (0 for a kernel not named) and the image
    mean against the JAX package's value. Returns (launches, mean_rgb,
    ms/spp)."""
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
    _zero_counts()
    t0 = time.perf_counter()
    img, n_rays = api.render(scene, static, sensor, cfg, settings, device=dev,
                             with_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
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
    launches = _check_launches(f"render {label}", expected)
    for c, (a, b) in enumerate(zip(mean, ref_mean)):
        if abs(a - b) > rtol * b:
            raise AssertionError(
                f"{label}: mean_rgb[{c}] = {a:.6f}, reference {b} "
                f"(tolerance {rtol:.1%})")
    return launches, mean, dt / spp * 1e3


@contextlib.contextmanager
def bvh_kernel(name):
    """Run the scene's BVH queries through the ``name`` kernel family."""
    old = scene_mod.BVH_KERNEL
    scene_mod.BVH_KERNEL = name
    try:
        yield
    finally:
        scene_mod.BVH_KERNEL = old


def write_ply(path, v, f):
    """A binary little-endian PLY of float32 vertices and int32 triangles."""
    face = np.zeros(len(f), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    face["n"], face["i"] = 3, f
    with open(path, "wb") as fh:
        fh.write((f"ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {len(v)}\nproperty float x\n"
                  f"property float y\nproperty float z\n"
                  f"element face {len(f)}\n"
                  f"property list uchar int vertex_indices\nend_header\n"
                  ).encode())
        fh.write(np.ascontiguousarray(v, "<f4").tobytes())
        fh.write(face.tobytes())


def kdbench_phase():
    """mtsutil kdbench at its defaults on the fallback heightfield written as
    a binary PLY; the treelet and lane-resort kernels must report the same
    hit rate on each batch. Returns the launches of the run."""
    v, f = fallback_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "fallback_heightfield.ply")
        write_ply(path, v, f)
        buf = io.StringIO()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mtsutil.main(["kdbench", path])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"kdbench {line}")
    log(f"kdbench: {dt:.2f} s including the PLY load and the BVH build")
    # per batch (coherent, incoherent) each query runs once to warm up and
    # 3 timed times (the defaults); a lane-resort query is 2 rounds + 1 K3
    # launches (bvh_traverse_lane_resort's default rounds)
    calls = 2 * (1 + 3)
    launches = _check_launches("kdbench", {"treelet_rounds": calls,
                                           "lane_chunk": calls * (2 + 1)})
    rates = {}
    for line in lines[1:]:
        tag, kname = line.split(":", 1)[0].split()
        rates.setdefault(tag, {})[kname] = line.rsplit("hit rate", 1)[1]
    if rc != 0 or len(rates) != 2 or any(
            len(r) != 2 or r["treelet"] != r["lane-resort"]
            for r in rates.values()):
        raise AssertionError(f"kdbench: rc {rc}, hit rates {rates}")
    return launches


def profile_phase(dev, label, scene, static, sensor, spp):
    """Device time by kernel over one render pass of ``spp`` samples
    (torch.profiler). Returns {kernel: (ms, launches)} of the port's kernels
    that ran (empty if the profiler saw no device time)."""
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
    per_kernel = {}
    for kernel in ("interaction_kernel", "closest_hit_kernel",
                   "lane_packed_kernel", "lane_chunk_kernel",
                   "treelet_rounds_kernel"):
        hits = [k for k in dev_us if f"::{kernel}(" in k]
        if hits or not dev_us:
            ms = sum(dev_us[k] for k in hits) / 1e3
            n = sum(calls_of[k] for k in hits)
            took = (f"{ms:.3f} ms in {n} launches, render mean "
                    f"{ms / max(n, 1):.5f} ms per launch" if dev_us
                    else "not measured")
            log(f"profile   {kernel}: {took}")
            if dev_us:
                per_kernel[kernel] = (ms, n)
    # host dispatch: the PyTorch ops the pass issues, by count
    calls = sorted(((e.key, e.count) for e in events if e.key.startswith("aten::")),
                   key=lambda kv: -kv[1])[:8]
    log("profile   op calls: " + ", ".join(f"{k} {n}" for k, n in calls))
    return per_kernel


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
    launches, _, _ = render_phase(
        dev, "cornell", *cornell_scene, EYE, AT, FOV, SPP, SPP_PER_PASS,
        REF_MEAN_RGB, MEAN_RTOL,
        {"brute_force_interaction": DEPTH * SPP,
         "brute_force_closest_hit": DEPTH * SPP})
    live_share_phase(dev, *cornell_scene)
    bunny_scene = bunny(dev)
    bunny_launches, lane_mean, lane_ms = render_phase(
        dev, "bunny", *bunny_scene, BUNNY_EYE, BUNNY_AT, BUNNY_FOV,
        BUNNY_SPP, BUNNY_SPP_PER_PASS, BUNNY_REF_MEAN_RGB, BUNNY_MEAN_RTOL,
        {"bvh_traverse_lane_packed": BUNNY_SPP,
         "lane_chunk": K3_PER_SPP * BUNNY_SPP})
    with bvh_kernel("treelet"):
        treelet_launches, tl_mean, tl_ms = render_phase(
            dev, "bunny treelet", *bunny_scene, BUNNY_EYE, BUNNY_AT,
            BUNNY_FOV, BUNNY_SPP, BUNNY_SPP_PER_PASS, BUNNY_REF_MEAN_RGB,
            BUNNY_MEAN_RTOL, {"treelet_rounds": K7_PER_SPP * BUNNY_SPP})
    log(f"render bunny treelet vs lane: {tl_ms:.3f} against {lane_ms:.3f} "
        f"ms/spp; mean_rgb difference "
        f"{[a - b for a, b in zip(tl_mean, lane_mean)]}")
    for label, mean in (("lane", lane_mean), ("treelet", tl_mean)):
        log(f"render bunny {label}: mean_rgb difference from PR 3's "
            f"{[a - b for a, b in zip(mean, PR3_BUNNY_MEAN_RGB)]}")
    records["treelet_rounds"]["launches"] = treelet_launches["treelet_rounds"]
    kdbench_phase()
    # each kernel's count from the run of the path that drives it
    for name in ("brute_force_interaction", "brute_force_closest_hit"):
        records[name]["launches"] = launches[name]
    for name in ("bvh_traverse_lane_packed", "lane_chunk"):
        records[name]["launches"] = bunny_launches[name]
    for name in ("lane_hbm", "lane_chunk_hbm"):
        records[name]["launches"] = large_launches[name]
    profile_phase(dev, "cornell", *cornell_scene, SPP_PER_PASS)
    profile_phase(dev, "bunny", *bunny_scene, BUNNY_SPP_PER_PASS)
    with bvh_kernel("treelet"):
        profile_phase(dev, "bunny treelet", *bunny_scene, BUNNY_SPP_PER_PASS)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
