#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mitsuba_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped), each
timed (the seconds printed at its end and together before the JSON lines):
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
     stands in for it, as in the JAX bench): time the octant packer; print
     the registers and occupancy of K3, K4 (both instantiations) and K7;
     hold K4 (bvh_traverse_lane_packed: closest hit and any-hit on the
     canonical table, an instantiation each) against its plain version on
     the 262,144 camera rays, bit for bit; hold the octant walk from the
     root (K5's) against it there (hit, and t except near-ties within
     NEAR_TIE_RTOL, each printed), with the visits and distinct rows of both
     walks, and time K4 in turns with K5; time K4 back to back and with the
     L2 flushed before each launch, and on the camera rays of each sample
     the render traces (the render mean's gap, phase 13); hold K3
     (lane_chunk) on 262,144 bounce rays (closest hit, on the octant tables)
     and shadow rays (any-hit, canonical table) of the first bounce (a
     bounded launch, then the resumed rest), bit for bit; hold K3's
     unbounded closest-hit walk against the canonical plain walk on the
     card on the same rays, compare their visits, and time K3 in turns with
     K4 (the canonical walk from the root); time the bounce query with the
     JAX resort schedule against one unbounded K3 launch with and without
     the coherence sort;
  5. the treelet kernel K7 (treelet_rounds) on the bunny scene's treelet
     cut: held bit for bit against both plain versions (the JAX rounds and
     the kernel's entry list) on the 262,144 camera rays (as they come), the
     bounce rays and the shadow rays (any-hit), both sorted as its query
     function sorts them; root-box tests per ray and the root boxes each ray
     enters; each launch timed, and the bounce query through the K7 query
     function timed against the K3 resort query;
  6. the kernel K8 (bvh_traverse_packed) on the split tables of a leaf-4
     tree of the same triangles (cuda_bvh.fat_tables: their MB and packing
     seconds; registers and resident blocks of its four instantiations):
     camera and sorted bounce rays, closest and any-hit, and a bounded
     case with per-ray [start, end) ranges of the tree's treelets; each held
     bit for bit against its plain twin, the twin bit for bit against the
     JAX walk over the fat rows (fat_rows_walk_plain), with the exact ties
     met, visits, head rows and slots read, time and bound; then its
     sorting query bvh_traverse with the counts set to 0;
  7. the wide-page kernel K9 (lane_chunk_w) on the same triangles' leaf-1
     tree, closest hit on its octant tables laid out as wide pages
     (pack_pages_w_octants), any-hit on pack_pages_w: its registers and
     occupancy; on the sorted bounce rays a bounded launch, then the
     resumed rest, bit for bit against its plain version, closest and
     any-hit, with visits and distinct rows; one unbounded launch of each
     kind bit for bit against K3's on the same tree and rays (closest, on
     the same octant tables) and the canonical any-hit walk (K4), its
     closest hits against the canonical plain walk (near-ties printed), and
     timed in turns with K3 and with K6 (node rows, an instantiation per
     query kind); then its query bvh_traverse_lane_resort_w with
     the counts set to 0, held bit for bit against K3's resort query and
     against K4's sorted query bvh_traverse_lane (near-ties printed), and
     timed in turns with K3's;
  8. large tier: 16 offset copies of the fallback mesh (bench.py:176-183;
     1,267,232 triangles, 2.53M nodes, above LANE_VMEM_MAX_NODES), on the
     262,144 rays of bench.py:205-212 sorted as the queries sort them: print
     K5's and K6's registers, resident blocks and launch grid; hold K5
     (lane_hbm: closest hit on the octant tables, any-hit) and K6
     (lane_chunk_hbm: a bounded launch, then the resumed rest, closest and
     any-hit) against their plain versions bit for bit; hold their closest
     hits against the canonical plain walk of the same tree and rays on the
     card (hit, and t except near-ties within NEAR_TIE_RTOL, each printed);
     print visits (mean and max per live lane), distinct rows read and their
     MB, and the warp efficiency of the octant and canonical walks; time K5
     (closest, any-hit) and K6 (closest, one unbounded launch) in turns with
     K4 (the canonical walk from the root); then,
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
  9b. training: bench.py:time_train_step through the port's trainer
     (parallel.train.make_train_step: torch autograd, Adam at 2e-2) on
     bench's training scene (bench.py:309-328: the Cornell box with a
     textured back wall and a GGX rough-conductor panel), 512x512, depth 5,
     spp 2, box filter: the target by api.render (samples 0-1), step 0
     (the target's samples: loss <= 1e-12 and every gradient 0), then steps
     1-4 timed as bench times them; checks 10 launches of K1 and of K2 in
     the target render and in each step's forward and none in the
     backward or the update (each part's counts set to 0 before it), and
     holds step 1 (the initial parameters, samples 2-3) against the JAX
     package's loss (0.5%) and gradients (2% relative L2, cosine 0.99) on
     its CPU backend (scripts/jax_train_ref.npz); prints fwd_bwd_ms_per_spp
     (bench's dt / (iters * spp)), final_loss, the peak memory and each
     step's split between forward, backward and update (CUDA events);
 9c. scene files (BASELINE configs 2 and 1): scenes/cbox.xml through
     mitsuba_tpu_torch.io.mitsuba_xml.load_scene with -D spp=64 -D res=256
     (its glass sphere is an analytic sphere with the smooth dielectric)
     and api.render, checking 320 launches of K1 and of K2 (5 bounces x 64
     samples); the Cornell box of phase 9 through the direct integrator at
     64x64, 16 spp, one emitter and one BSDF sample, checking 32 launches of
     K1 and 16 of K2 (the camera and the BSDF ray, the shadow ray, per
     sample); each prints wall ms, ms/spp, rays/s and the exact ray count,
     and holds its mean within 1% per channel of the JAX package's CPU value
     (scripts/jax_scenefile_ref_mean.py); then python -m mitsuba_tpu_torch
     on cbox.xml at the same size in a subprocess, whose EXR must equal the
     image of api.render bit for bit;
 9d. the Veach MIS scene (BASELINE config 3, tests/test_baseline_scenes.py's
     fixture: a diffuse floor, four rough-conductor plates of alpha 0.005 to
     0.3, three analytic sphere lights of radius 0.03, 0.12 and 0.45) and
     its plastic variant (plates 1 and 3 GGX and Beckmann rough plastics
     turned to face the camera, the floor a nonlinear smooth plastic),
     built with the port's builder
     (build seconds printed, the rough-transmittance bake included);
     rendered at 512x512, box filter, seed 0: both through the path tracer
     at depth 3, 32 spp in passes of 4, checking 96 launches of K1 and of
     K2, and the first through the direct integrator, 16 spp, checking 32
     of K1 and 16 of K2; each prints wall ms, ms/spp, rays/s, the exact ray
     count and the peak memory, and holds its mean within 0.1% per channel
     of the JAX package's CPU value (scripts/jax_veach_ref_mean.py);
 9e. the scene file's sensor header: uniform4, uniform2 and the pixel
     positions of every sampler type at 65,536 pixels x 16 samples x
     dimensions 0, 1, 3, 4, 6, 7 and 22 (every branch of the samplers) on
     the card against the same functions on the CPU, bit for bit (the draws
     of exactly 1.0 counted); scenes/cbox.xml with its
     sampler and filter replaced (header_xml) through load_scene +
     api.render: the ldsampler and the Mitchell filter at 256x256, 64 spp
     (320 K1 + 320 K2) and the CLI on that file (its EXR equal to the
     image), each other sampler with the Gaussian filter and each other
     filter with the independent sampler at 128x128, 16 spp (80 + 80); ao
     on the Cornell box at 128x128, rayLength 0.3, box filter (an
     independent 512-spp reference and 16 spp x seeds 0-2 per sampler, 1 +
     1 launches per sample), where the ldsampler's mean squared error
     against the reference must be below 0.95 of the independent sampler's
     (tests/test_core.py:165); field position and albedo on the Cornell
     box at 512x512, 4 spp (4 K1); each render prints wall time, ms/spp,
     rays/s, the exact ray count and the peak memory, and holds its mean
     within HEADER_MEAN_RTOL and tv_rgb (the mean absolute difference of
     horizontally adjacent pixels) within HEADER_TV_RTOL per channel of the
     JAX package's CPU values (scripts/jax_header_ref_mean.py); after the
     treelet render (phase 11), ao on bunny_x2 at 512x512, 8 spp, the
     default ray length, box filter: 7 K3 launches per sample (a resorted
     closest hit and a resorted shadow query: the JAX li_ao presorts
     nothing) and none of the others, held as above;
 9f. the material gallery: scenes/cbox.xml with its glass sphere and the
     classic Cornell short block (a cube, turned -17 degrees) made of one of
     the nine single-layer BSDFs (gallery_xml: conductor Au, rough dielectric
     GGX 0.15 and Beckmann 0.3, thin dielectric, rough diffuse, Phong, Ward,
     difftrans, HK, null), each through load_scene + api.render at 256x256,
     64 spp, depth 5, Gaussian filter, held to 320 K1 + 320 K2 launches and
     to the JAX package's CPU mean and tv_rgb within HEADER_MEAN_RTOL and
     HEADER_TV_RTOL per channel (scripts/jax_header_ref_mean.py), with
     wall time, ms/spp, rays/s and the peak memory; then the CLI on the HK
     file, whose EXR must equal the image;
 9g. the layered gallery: the same scene with the sphere and the block made
     of one nested or layered BSDF (LAYERED_BSDFS: a mask of constant
     opacity 0.35 and one of a checkerboard opacity, a mixture of a GGX
     rough conductor and a diffuse, a blend weighted by a grid texture, a
     coating and a GGX rough coating over diffuses), or the block alone
     made of a normal map (a checkerboard of tangent-space normals) over a
     plastic or a bump map (a height field PFM, write_height_pfm, through a
     scale texture) over a rough plastic, each through load_scene +
     api.render at 256x256, 32 spp (LAYERED_GALLERY: 160 K1 + 160 K2),
     held as phase 9f's renders; then the CLI on the rough-coating file,
     whose EXR must equal the image;
 9h. lights and cameras (LIGHTS_VARIANTS, lights_xml): cbox.xml at 128x128,
     16 spp with its area light replaced by a point, a spot or a
     directional light, or joined by all three and a collimated beam
     (through the path tracer and the direct integrator, 2 emitter and 1
     BSDF sample), or its camera a thin lens, an orthographic or a
     spherical camera (128x64), each held as phase 9f's renders (80 + 80
     K1/K2 launches, direct 32 + 32); a radiance, an irradiance (on a floor
     patch) and a fluence meter of 65,536 samples through api.render
     (render_meter: 10 + 10 launches), held to the JAX package's CPU value
     within METER_RTOL; sample_ray of all nine sensor types on 65,536 film
     and aperture draws against the CPU within SENSOR_ATOL; then the CLI on
     the "all" file, whose EXR must equal its image;
 9i. cloth and spectra: tests/test_irawan.py's cloth scene (cloth_xml: a
     rectangle of woven cloth under a point light, path depth 3) at 256x256,
     16 spp, its irawan element the plain or the twill preset or a written
     .cloth pattern with yarn-tension noise and intensity variation
     (CLOTH_TEXT), through load_scene + api.render (48 + 48 K1/K2
     launches); tests/test_spectral.py's glass slab (spectral_scene, the
     port's builder) through api.render_spectral at 256x256, 16 spp, depth
     6, with Cauchy's B 0 and 0.3 (96 + 96); each held as phase 9f's
     renders; the plain variant's file with a multichannel integrator
     through load_scene + api.render_multichannel, whose image must equal
     the plain variant's bit for bit; then the CLI on the .cloth variant's
     file, whose EXR must equal its image;
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
 13. profile: one render pass of each scene (the bunny in both BVH modes;
     4 spp of cbox.xml at 256x256, of the Cornell direct render at 64x64
     and of the Veach MIS path render at 512x512)
     under torch.profiler, printing the device's busy share of the wall time,
     the pass's device kernel launches, the kernels that take it and each
     port kernel's render mean per launch;
     K4's render mean beside its times of phase 4; and one training step
     with its forward and its backward each profiled: their busy shares and
     the backward's top kernels.

The second-to-last line of output is the kernels' JSON record, the last
{"ok": true, "device": {...}}. Without CUDA the script exits nonzero before
printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import typing
from pathlib import Path

import numpy as np
import torch

from mitsuba_tpu_torch import mtsutil
from mitsuba_tpu_torch.accel.build import (build_bvh, treelet_roots,
                                           triangle_aabbs)
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import rng as rng_mod
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.io import image as image_mod
from mitsuba_tpu_torch.io import mitsuba_xml
from mitsuba_tpu_torch.ops import build
from mitsuba_tpu_torch.ops import cuda_bvh as cb
from mitsuba_tpu_torch.ops import cuda_intersect as bf
from mitsuba_tpu_torch.render import api, shapes
from mitsuba_tpu_torch.render import bsdf as bsdf_mod
from mitsuba_tpu_torch.render import emitter as em_mod
from mitsuba_tpu_torch.render import microfacet as mf
from mitsuba_tpu_torch.render import scene as scene_mod
from mitsuba_tpu_torch.render import sensor as sensor_mod
from mitsuba_tpu_torch.render.integrators.common import (
    AO, DIM_BASE, DIM_BSDF, DIM_NEE, DIRECT, FIELD, FIELD_ALBEDO,
    FIELD_POSITION, PATH, IntegratorConfig, ray_offset)
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
# each kernel's source and the TPU kernel it replaces (the function that
# reaches pl.pallas_call); every BVH kernel is one __global__ (K4, K5, K6,
# K9: one per query kind) in bvh_lane.cu
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
# a buffer larger than the 50 MB L2, written before a launch that must find
# the L2 cold, as a render pass's other work leaves it
FLUSH_BYTES = 256 << 20
# bench.py:time_train_step (bench.py:243-283) on its training scene: spp 2,
# steps it = 1..4 timed after step 0; the JAX package's loss and gradients
# of step 1 on its CPU backend (scripts/jax_train_ref.py, 512x512); a K1
# and a K2 launch per bounce and sample in a forward pass, none in the
# backward (the kernels carry no gradient: queries detach their rays)
TRAIN_SPP, TRAIN_ITERS = 2, 4
TRAIN_REF = Path(__file__).resolve().parent / "scripts" / "jax_train_ref.npz"
TRAIN_K12 = {"brute_force_interaction": DEPTH * TRAIN_SPP,
             "brute_force_closest_hit": DEPTH * TRAIN_SPP}
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_COS = 5e-3, 2e-2, 0.99
# the treelet render: a closest-hit and a shadow query per bounce, each one
# K7 launch (render/scene.py _bvh_query)
K7_PER_SPP = 2 * DEPTH
# the scene-file phase (BASELINE configs 2 and 1): scenes/cbox.xml at the
# README's -D spp=64 -D res=256 through the path tracer, and the Cornell box
# of the render phase through the direct integrator at 64x64, 16 spp. Their
# mean_rgb through the JAX package on its CPU backend, the same samples:
# scripts/jax_scenefile_ref_mean.py, run with jax 0.9.0 on a CPU host,
# unrounded. K1/K2 launches: cbox.xml 5 bounces x (a closest hit + a
# shadow query) per sample; direct, per sample, the camera and the BSDF ray
# (K1) and one shadow ray (K2)
CBOX_XML = Path(__file__).resolve().parent / "scenes" / "cbox.xml"
CBOX_SPP, CBOX_RES = 64, 256
CBOX_REF_MEAN_RGB = (0.23012354969978333, 0.17765897512435913,
                     0.07999605685472488)
DIRECT_RES, DIRECT_SPP = 64, 16
DIRECT_REF_MEAN_RGB = (0.3901189863681793, 0.3174380958080292,
                       0.15292032063007355)
SCENE_MEAN_RTOL = 1e-2
# the Veach MIS phase (BASELINE config 3): the fixture's camera and sizes
# (tests/test_baseline_scenes.py:40-41, 193-212: depth 3, box filter) at
# BASELINE's 512x512
VEACH_EYE, VEACH_AT, VEACH_FOV = [0, 1.2, -2.8], [0, 1.0, 1.0], 38.0
VEACH_DEPTH, VEACH_PATH_SPP, VEACH_DIRECT_SPP, VEACH_SPP_PER_PASS = 3, 32, 16, 4
# the plastic variant's rough-plastic plates: degrees about x (as in
# scripts/jax_veach_ref_mean.py)
TURNED = -155.0
# mean_rgb of the three renders through the JAX package on its CPU backend,
# the same samples (seed 0, box filter, 512x512):
# scripts/jax_veach_ref_mean.py, run with jax 0.9.0 on a CPU host,
# unrounded. K1/K2 launches: the path tracer a closest hit and a shadow
# query per bounce and sample; direct, per sample, the camera and the BSDF
# ray (K1) and one shadow ray (K2)
VEACH_REF_MEAN_RGB = (0.02564532682299614, 0.02564532682299614,
                      0.02564532682299614)
VEACH_PLASTIC_REF_MEAN_RGB = (0.05249462649226189, 0.03174475580453873,
                              0.024828311055898666)
VEACH_DIRECT_REF_MEAN_RGB = (0.02532094344496727, 0.02532094344496727,
                             0.02532094344496727)
# the three means agreed with these within 3.6e-5 relative on the H100;
# a wrong rough-plastic lobe or bake moves the plastic render's by over 1%
VEACH_MEAN_RTOL = 1e-3
# the sensor-header phase (9e): scenes/cbox.xml with its sampler and filter
# replaced (header_xml), ao on the Cornell box and on bunny_x2, field on the
# Cornell box. The sampler types by their scene-file names
SAMPLER_TYPES = {"independent": api.INDEPENDENT, "stratified": api.STRATIFIED,
                 "ldsampler": api.LDSAMPLER, "sobol": api.SOBOL,
                 "halton": api.HALTON, "hammersley": api.HAMMERSLEY,
                 "faure": api.FAURE}
HEADER_OTHER_SAMPLERS = ("stratified", "sobol", "halton", "hammersley",
                         "faure")
HEADER_OTHER_FILTERS = ("tent", "catmullrom", "lanczos")
HEADER_SPP, HEADER_RES = 16, 128
# the sampler-bits check: pixels x samples x dimensions per sampler type.
# The dimensions reach every branch of rng._qmc2: 0 (hammersley's i/N), 1
# and 3 (below the compaction), 4 (the first compacted one, prime base 5),
# 6 (the last prime-base dimension), 7 (the first (0,2) one) and 22 (the
# highest a depth-5 path draws, sobol's dimensions 40-41)
BITS_PIXELS, BITS_SAMPLES = 65536, 16
BITS_DIMS = (0, 1, 3, 4, 6, 7, 22)
# ao on the Cornell box, tests/test_core.py:165's variance check at 128x128:
# ldsampler's mean squared error against an independent 512-spp render must
# be below AO_LD_GAIN times the independent sampler's, both at 16 spp,
# averaged over seeds 0-2
AO_RES, AO_LENGTH, AO_SPP, AO_REF_SPP, AO_REF_SEED = 128, 0.3, 16, 512, 7
AO_SEEDS, AO_LD_GAIN = 3, 0.95
# ao on bunny_x2: per sample one closest-hit and one shadow query, neither
# presorted (the JAX li_ao), each through the resort schedule of K3 launches
BUNNY_AO_SPP = 8
K3_PER_AO_SPP = (scene_mod.BVH_RESORT[0] + 1
                 + scene_mod.BVH_RESORT_SHADOW[0] + 1)
FIELD_RES, FIELD_SPP = 512, 4
# (mean_rgb, tv_rgb) of each render through the JAX package on its CPU
# backend, the same samples: scripts/jax_header_ref_mean.py, run with jax
# 0.9.0 on a CPU host, unrounded. tv_rgb is the mean absolute difference of
# horizontally adjacent pixels: a filter's sharpness and a sampler's noise
# pattern move it where they leave the mean alone
HEADER_REF = {
    "cbox.xml ldsampler mitchell": (
        (0.23024810888205285, 0.17776140729791245, 0.08004837758354243),
        (0.014309963795348083, 0.010847860174428193, 0.004874117734487489)),
    "cbox.xml stratified gaussian": (
        (0.23011464127061781, 0.1776260397986984, 0.0799933863659492),
        (0.02272398636113861, 0.01788450271291655, 0.008355579862759909)),
    "cbox.xml sobol gaussian": (
        (0.23018374004972447, 0.17766495724363035, 0.08004286258683244),
        (0.02179885067447761, 0.017186086506517838, 0.008039795457435701)),
    "cbox.xml halton gaussian": (
        (0.22966944717827098, 0.17720484146554202, 0.0797926821596218),
        (0.022375825611442326, 0.017473610010754214, 0.00808767765206546)),
    "cbox.xml hammersley gaussian": (
        (0.22938227621519502, 0.17696820741851532, 0.07968760215206563),
        (0.022330404162955415, 0.017330686049101058, 0.008022533744983074)),
    "cbox.xml faure gaussian": (
        (0.23024064228164015, 0.17770950864347518, 0.0800252253108423),
        (0.02103750343056129, 0.016647385898011024, 0.007811106248786415)),
    "cbox.xml independent tent": (
        (0.23031933513163635, 0.17782460014496257, 0.08006325464885847),
        (0.02620143530329306, 0.02068168785753844, 0.009573309582761076)),
    "cbox.xml independent catmullrom": (
        (0.23046485128880068, 0.17795034584250735, 0.08012838671080375),
        (0.03278528612986208, 0.025879967832777954, 0.011977297830956687)),
    "cbox.xml independent lanczos": (
        (0.23069897919068347, 0.1781539948978769, 0.0802334624529806),
        (0.03892545016087624, 0.030933913602558417, 0.014380796259474265)),
    "ao cornell independent 512 spp seed 7": (
        (0.775436520576477, 0.775436520576477, 0.775436520576477),
        (0.027904840904896654, 0.027904840904896654, 0.027904840904896654)),
    "ao cornell independent 16 spp seed 0": (
        (0.7742195129394531, 0.7742195129394531, 0.7742195129394531),
        (0.09160463828740158, 0.09160463828740158, 0.09160463828740158)),
    "ao cornell independent 16 spp seed 1": (
        (0.7754707336425781, 0.7754707336425781, 0.7754707336425781),
        (0.09201218011811024, 0.09201218011811024, 0.09201218011811024)),
    "ao cornell independent 16 spp seed 2": (
        (0.7760543823242188, 0.7760543823242188, 0.7760543823242188),
        (0.09071265994094488, 0.09071265994094488, 0.09071265994094488)),
    "ao cornell ldsampler 16 spp seed 0": (
        (0.7758674621582031, 0.7758674621582031, 0.7758674621582031),
        (0.04939714566929134, 0.04939714566929134, 0.04939714566929134)),
    "ao cornell ldsampler 16 spp seed 1": (
        (0.775238037109375, 0.775238037109375, 0.775238037109375),
        (0.05015071358267716, 0.05015071358267716, 0.05015071358267716)),
    "ao cornell ldsampler 16 spp seed 2": (
        (0.7755966186523438, 0.7755966186523438, 0.7755966186523438),
        (0.04962782972440945, 0.04962782972440945, 0.04962782972440945)),
    "ao bunny_x2": (
        (0.8800907135009766, 0.8800907135009766, 0.8800907135009766),
        (0.07077928158635029, 0.07077928158635029, 0.07077928158635029)),
    "field cornell position": (
        (0.5036970663555266, 0.5154712891399998, 0.4922595406558088),
        (0.001989279890878877, 0.0008395997030464835, 0.005088945490306625)),
    "field cornell albedo": (
        (0.6041403350492942, 0.5563607621990627, 0.4755961521263714),
        (0.0016849335373485, 0.002121223633882905, 0.002719655882946713)),
    # the material gallery (phase 9f), scripts/jax_header_ref_mean.py's
    # gallery renders
    "gallery conductor": (
        (0.22035015898003768, 0.16790580956965248,
         0.07208642256044794),
        (0.0202424567097491, 0.014168879572407972,
         0.004686767218360395)),
    "gallery roughdielectric ggx": (
        (0.21355376831443776, 0.16668953988824567,
         0.07535592985857649),
        (0.01134782503482132, 0.009084258025774575,
         0.004245123818792361)),
    "gallery roughdielectric beckmann": (
        (0.2134476305616821, 0.16653752415069162,
         0.07528106861267846),
        (0.011319668122342417, 0.009054071982361715,
         0.0042256302877637375)),
    "gallery thindielectric": (
        (0.21972370126185872, 0.17128105924187623,
         0.07743872162144318),
        (0.01577665562485624, 0.01258500540419056,
         0.00584773715999566)),
    "gallery roughdiffuse": (
        (0.21308430590533545, 0.16237243247299193,
         0.07120084651643853),
        (0.010512895131504538, 0.008063178030675905,
         0.0036517819700389717)),
    "gallery phong": (
        (0.21019963295185995, 0.16328532952344965,
         0.07343894071198205),
        (0.011374355958248535, 0.008972658847127012,
         0.004191376942762313)),
    "gallery ward": (
        (0.20928867138363105, 0.16265959150674617,
         0.07317904482396649),
        (0.010836224139934438, 0.008591527030939168,
         0.0040207549463084575)),
    # the difftrans row carries the file's transmittance in spec_trans (its
    # lobe's column; the JAX loader's albedo column is read by no lobe)
    "gallery difftrans": (
        (0.20935489356762838, 0.16054416615686004,
         0.0715809099896078),
        (0.010354935422598967, 0.008053641107680766,
         0.003714357497644973)),
    "gallery hk": (
        (0.20403838192461193, 0.15895111894186206,
         0.07179679091658335),
        (0.010978833019142417, 0.008691760933636092,
         0.004065213813902336)),
    "gallery null": (
        (0.2203347729023016, 0.17201969499854264,
         0.07786997805837186),
        (0.014434126690758302, 0.011421012237216026,
         0.005297890968912188)),
    # the layered gallery (phase 9g), scripts/jax_header_ref_mean.py's
    # layered renders (32 spp)
    "layered mask constant": (
        (0.21344315869031896, 0.16495341535751218,
         0.0737251071106296),
        (0.015084766231883534, 0.01174679360189759,
         0.005385543215156477)),
    "layered mask checkerboard": (
        (0.20396422217331997, 0.16183349967979105,
         0.07417640063880793),
        (0.01381200791456338, 0.011050014326600539,
         0.0053006797742155935)),
    "layered mixturebsdf": (
        (0.2077662716619746, 0.16359853186426607,
         0.07231001284760577),
        (0.011893177467102356, 0.009339779616053367,
         0.004183825356393128)),
    "layered blendbsdf": (
        (0.21889369467766706, 0.1677168529235873,
         0.07286536070771786),
        (0.020281467460111623, 0.014378491862243225,
         0.005083628262808464)),
    "layered coating": (
        (0.2033162228619641, 0.15700678487720546,
         0.07042544374401012),
        (0.012208896720496184, 0.009490519140129211,
         0.004334875908400692)),
    "layered roughcoating": (
        (0.2000470609141328, 0.1570012677836205,
         0.07157787390885145),
        (0.011358710469477468, 0.008923200830101907,
         0.004157412361482139)),
    "layered normalmap": (
        (0.21269766771474077, 0.1639110130668347,
         0.07353600870420979),
        (0.013650385898381452, 0.010549879186579587,
         0.00483463329110797)),
    "layered bumpmap": (
        (0.20901192524836285, 0.164449679532561,
         0.07425677333128017),
        (0.013044368798493636, 0.010441384847664038,
         0.00485247001482834)),
    # lights and cameras (phase 9h), scripts/jax_header_ref_mean.py's
    # lights renders (128x128, 16 spp)
    "lights point": (
        (0.21659413623882315, 0.1574337035550497, 0.06373706632689365),
        (0.03596181976083751, 0.02594232953367247, 0.010615166879458465)),
    "lights spot": (
        (0.20105790908221155, 0.14944877216177435, 0.06631155505808507),
        (0.0413737907019966, 0.030101518276904216, 0.01264453261477785)),
    "lights directional": (
        (0.20053153238346413, 0.17742071167397627, 0.07034948352434914),
        (0.024510739480420946, 0.019588378744695288, 0.008046695341885615)),
    "lights all": (
        (0.7951488551379955, 0.6215328774564108, 0.2632268780034714),
        (0.15431151510464042, 0.11756577130627809, 0.05202964129209508)),
    "lights all direct": (
        (0.4754375627673364, 0.3977737913714687, 0.1841718646873454),
        (0.06858730204988973, 0.057049553178633194, 0.02657380889122705)),
    "lights thinlens": (
        (0.22978547060918045, 0.17738458599487195, 0.07983381183016511),
        (0.02379434147151723, 0.018899810833969778, 0.008865871187898491)),
    "lights orthographic": (
        (0.17047828208453275, 0.13017695235201998, 0.05724311916141156),
        (0.011055414247146574, 0.008197045880776178, 0.0037165602789790806)),
    "lights spherical": (
        (1.4818568836941126, 1.2397048476861765, 0.6258338658944133),
        (0.04392308598510512, 0.035935917162161365, 0.01786362259263983)),
    # cloth and spectra (phase 9i), scripts/jax_header_ref_mean.py's cloth
    # (256x256, 16 spp) and spectral renders (256x256, 16 spp, depth 6)
    "cloth plain": (
        (0.4324094324319123, 0.3023091261070059, 0.2372589667236089),
        (0.04653793890681532, 0.046303363658859654, 0.04618788356833291)),
    "cloth twill": (
        (0.3451984219119897, 0.21509811233097853, 0.15004795535416138),
        (0.029308547604020584, 0.029085177563164883, 0.028975751521623832)),
    "cloth cloth file": (
        (0.3017132319425384, 0.32599155018674475, 0.4566806244267658),
        (0.04896814464863222, 0.04587395203623146, 0.048810802584925934)),
    "spectral cauchy_b 0.0": (
        (2.63249723164013, 2.635025821987128, 2.6330219649668494),
        (1.4254991147612102, 0.8239264923059689, 1.0082237749325298)),
    "spectral cauchy_b 0.3": (
        (1.0312935078058574, 1.0633426766658711, 0.9861515777259151),
        (0.9738411742306726, 0.6738309242698424, 0.7733010739919838)),
}
# the meters of phase 9h through the JAX package's render_meter on its CPU
# backend, 65,536 samples: scripts/jax_header_ref_mean.py's lights meters
METER_REF = {
    "lights radiancemeter": (0.10019056499004364, 0.08333784341812134,
                             0.037494853138923645),
    "lights irradiancemeter": (1.116687297821045, 0.8858837485313416,
                               0.41900119185447693),
    "lights fluencemeter": (4.85649299621582, 3.8972349166870117,
                            1.8554370403289795),
}
METER_RTOL = 1e-4
# the port on the CPU at these sizes: within 4.9e-6 (mean) and 2.7e-5 (tv)
# of these values, a flipped lane or lobe choice being the gap; one flipped
# ao lane at 128x128, 16 spp moves tv by 8.5e-5, so the tv limit leaves room
# for about ten. A broken sampler, filter or integrator moves one of them by
# more (PERF.md section 6, PR 13). The gallery's readings bear the same
# limits out: the port on the CPU within 3.1e-6 and 3.6e-5, the card within
# 2.0e-6 and 1.3e-5, and every broken lobe tried past one of them (PR 14)
HEADER_MEAN_RTOL = 1e-4
HEADER_TV_RTOL = 1e-3
# the material gallery (phase 9f): scenes/cbox.xml with its glass sphere's
# inline BSDF replaced by a reference to one single-layer BSDF, declared once
# at the top level, which the classic Cornell "short block" (a cube of
# half-size 82.5 at (185.5, GALLERY_BLOCK_Y, 169), turned -17 degrees about
# y) shares: each lobe in view through the analytic sphere and through
# K1/K2's triangles. The block floats 0.5 above the floor: resting on it
# (y = 82.5), its bottom face shares the floor's plane, and which of the two
# a lane that passes through the block hits there turns on rounding, in the
# JAX package as in the port (PERF.md section 6, PR 14). The file's size,
# depth 5 and Gaussian filter, 64 spp in passes of 4: 5 K1 + 5 K2 launches
# per sample
GALLERY_BSDFS = {
    "conductor": ('<bsdf type="conductor" id="gallery">'
                  '<string name="material" value="Au"/></bsdf>'),
    "roughdielectric ggx": (
        '<bsdf type="roughdielectric" id="gallery">'
        '<string name="distribution" value="ggx"/>'
        '<float name="alpha" value="0.15"/>'
        '<string name="intIOR" value="bk7"/></bsdf>'),
    "roughdielectric beckmann": (
        '<bsdf type="roughdielectric" id="gallery">'
        '<string name="distribution" value="beckmann"/>'
        '<float name="alpha" value="0.3"/>'
        '<string name="intIOR" value="bk7"/></bsdf>'),
    "thindielectric": ('<bsdf type="thindielectric" id="gallery">'
                       '<string name="intIOR" value="bk7"/></bsdf>'),
    "roughdiffuse": ('<bsdf type="roughdiffuse" id="gallery">'
                     '<float name="alpha" value="0.6"/>'
                     '<rgb name="reflectance" value="0.8, 0.6, 0.3"/></bsdf>'),
    "phong": ('<bsdf type="phong" id="gallery">'
              '<float name="exponent" value="40"/>'
              '<spectrum name="diffuseReflectance" value="0.3"/>'
              '<spectrum name="specularReflectance" value="0.4"/></bsdf>'),
    "ward": ('<bsdf type="ward" id="gallery">'
             '<float name="alphaU" value="0.1"/>'
             '<float name="alphaV" value="0.35"/>'
             '<spectrum name="diffuseReflectance" value="0.3"/>'
             '<spectrum name="specularReflectance" value="0.4"/></bsdf>'),
    "difftrans": ('<bsdf type="difftrans" id="gallery">'
                  '<rgb name="transmittance" value="0.7, 0.6, 0.5"/></bsdf>'),
    "hk": ('<bsdf type="hk" id="gallery">'
           '<spectrum name="sigmaS" value="1"/>'
           '<spectrum name="sigmaA" value="0.05"/>'
           '<float name="thickness" value="1"/>'
           '<phase type="hg"><float name="g" value="0.3"/></phase></bsdf>'),
    "null": '<bsdf type="null" id="gallery"/>',
}
GALLERY_BLOCK_Y = 83.0
GALLERY_BLOCK = (
    '<shape type="cube"><transform name="toWorld">'
    '<scale value="82.5"/><rotate y="1" angle="-17"/>'
    '<translate x="185.5" y="{y}" z="169"/></transform>'
    '<ref id="gallery"/></shape>')
# the layered gallery (phase 9g): the material gallery's scene with the
# sphere and the short block made of one nested or layered BSDF, declared at
# the top level as "gallery". The two map variants put their map on the block
# alone and leave the sphere its glass: the JAX package perturbs a sphere's
# frame with a triangle's tangent (ROADMAP.md, Queue 3). The bump map reads
# HEIGHT_PFM, a smooth height field that write_height_pfm writes beside the
# scene file (a step texture would have a gradient only on its edges). The
# normal map's tilted checks lean along both tangents (a green channel of
# 0.5 would leave the bitangent out, and a flipped y channel unseen)
HEIGHT_PFM = "height.pfm"
HEIGHT_RES = 64
_DIFFUSE = '<bsdf type="diffuse"><rgb name="reflectance" value="{}"/></bsdf>'
LAYERED_BSDFS = {
    "mask constant": (
        '<bsdf type="mask" id="gallery"><float name="opacity" value="0.35"/>'
        + _DIFFUSE.format("0.8, 0.6, 0.3") + "</bsdf>"),
    "mask checkerboard": (
        '<bsdf type="mask" id="gallery">'
        '<texture type="checkerboard" name="opacity">'
        '<float name="uscale" value="4"/><float name="vscale" value="4"/>'
        '<spectrum name="color0" value="0.9"/>'
        '<spectrum name="color1" value="0.2"/></texture>'
        + _DIFFUSE.format("0.2, 0.5, 0.8") + "</bsdf>"),
    "mixturebsdf": (
        '<bsdf type="mixturebsdf" id="gallery">'
        '<string name="weights" value="0.3 0.7"/>'
        '<bsdf type="roughconductor"><string name="distribution" value="ggx"/>'
        '<float name="alpha" value="0.2"/>'
        '<string name="material" value="Cu"/></bsdf>'
        + _DIFFUSE.format("0.3, 0.6, 0.4") + "</bsdf>"),
    "blendbsdf": (
        '<bsdf type="blendbsdf" id="gallery">'
        '<texture type="gridtexture" name="weight">'
        '<float name="lineWidth" value="0.1"/>'
        '<float name="uscale" value="4"/>'
        '<spectrum name="color0" value="0.1"/>'
        '<spectrum name="color1" value="0.9"/></texture>'
        '<bsdf type="conductor"><string name="material" value="Au"/></bsdf>'
        + _DIFFUSE.format("0.7, 0.7, 0.7") + "</bsdf>"),
    "coating": (
        '<bsdf type="coating" id="gallery"><float name="intIOR" value="1.5"/>'
        '<rgb name="sigmaA" value="0.2, 0.4, 0.8"/>'
        '<float name="thickness" value="1"/>'
        + _DIFFUSE.format("0.8, 0.8, 0.8") + "</bsdf>"),
    "roughcoating": (
        '<bsdf type="roughcoating" id="gallery">'
        '<string name="distribution" value="ggx"/>'
        '<float name="alpha" value="0.15"/>'
        + _DIFFUSE.format("0.2, 0.4, 0.7") + "</bsdf>"),
    "normalmap": (
        '<bsdf type="normalmap" id="gallery">'
        '<texture type="checkerboard">'
        '<rgb name="color0" value="0.5, 0.5, 1"/>'
        '<rgb name="color1" value="0.75, 0.65, 0.85"/></texture>'
        '<bsdf type="plastic">'
        '<rgb name="diffuseReflectance" value="0.6, 0.3, 0.2"/></bsdf>'
        "</bsdf>"),
    "bumpmap": (
        '<bsdf type="bumpmap" id="gallery">'
        '<texture type="scale"><float name="scale" value="0.5"/>'
        f'<texture type="bitmap"><string name="filename" value="{HEIGHT_PFM}"/>'
        "</texture></texture>"
        '<bsdf type="roughplastic"><float name="alpha" value="0.2"/>'
        '<rgb name="diffuseReflectance" value="0.3, 0.5, 0.6"/></bsdf>'
        "</bsdf>"),
}


@dataclasses.dataclass(frozen=True)
class Gallery:
    """A gallery phase: its labels' (and files') prefix, its BSDFs by
    variant, its samples per pixel, the variant that also goes through the
    CLI, and the variants whose sphere keeps its glass."""
    kind: str
    bsdfs: dict
    spp: int
    cli: str
    glass_sphere: tuple = ()

    def xml(self, variant, **kw):
        """gallery_xml of ``variant``; ``kw`` goes to gallery_xml."""
        return gallery_xml(self.bsdfs[variant],
                           sphere_glass=variant in self.glass_sphere, **kw)


# phase 9f at the file's 64 spp; phase 9g at 32, so that the script stays
# within its time (PERF.md section 4)
MATERIAL_GALLERY = Gallery("gallery", GALLERY_BSDFS, CBOX_SPP, "hk")
LAYERED_GALLERY = Gallery("layered", LAYERED_BSDFS, 32, "roughcoating",
                          glass_sphere=("normalmap", "bumpmap"))


# phase 9h, lights and cameras: scenes/cbox.xml (its materials, glass
# sphere, depth 5 and Gaussian filter) at -D res=128 and 16 spp (256x256
# took the script to 588.6-605.8 s, past the 600 s it is held to) with its
# area light replaced or joined by delta lights, or its camera another
# sensor type; and three meters through api.render (render_meter) at
# METER_SPP samples. Each light's intensity puts its image mean within a
# factor of three of cbox.xml's (PERF.md section 4). The spot aims straight
# down from under the ceiling, its falloff band on the floor; the
# directional light comes in through the open front onto the floor and the
# back wall; the collimated beam has no NEE branch and is never hit, so in
# "all" it only takes its share of the selection pmf
LIGHTS_SPP, LIGHTS_RES, METER_SPP = 16, 128, 65536
LIGHTS_DEFINES = {"spp": LIGHTS_SPP, "res": LIGHTS_RES,
                  "half": LIGHTS_RES // 2}
POINT_LIGHT = ('<emitter type="point"><point name="position" x="278" '
               'y="500" z="279.6"/><rgb name="intensity" '
               'value="{}"/></emitter>')
SPOT_LIGHT = ('<emitter type="spot"><transform name="toWorld"><lookat '
              'origin="278, 540, 279.6" target="278, 0, 279.6" '
              'up="0, 0, 1"/></transform><float name="cutoffAngle" '
              'value="25"/><float name="beamWidth" value="15"/><rgb '
              'name="intensity" value="{}"/></emitter>')
DIRECTIONAL_LIGHT = ('<emitter type="directional"><vector name="direction" '
                     'x="0.3" y="-0.5" z="1"/><rgb name="irradiance" '
                     'value="{}"/></emitter>')
COLLIMATED_BEAM = ('<emitter type="collimated"><transform name="toWorld">'
                   '<lookat origin="150, 400, 150" target="350, 0, 400" '
                   'up="0, 1, 0"/></transform><rgb name="power" '
                   'value="{}"/></emitter>')
LIGHT_ELEMENTS = {"point": POINT_LIGHT, "spot": SPOT_LIGHT,
                  "directional": DIRECTIONAL_LIGHT,
                  "collimated": COLLIMATED_BEAM}
LIGHT_RGB = {"point": "100000, 84800, 43500",
             "spot": "3000000, 2544000, 1305000",
             "directional": "4, 3.392, 1.74", "collimated": "1000, 1000, 1000"}
_CBOX_LOOK = 'origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"'
_METER_SAMPLER = ('<sampler type="independent"><integer name="sampleCount" '
                  'value="{}"/></sampler>'.format(METER_SPP))
LIGHTS_SENSORS = {
    "thinlens": ('<sensor type="thinlens"><float name="fov" '
                 'value="39.3077"/><float name="apertureRadius" value="20"/>'
                 '<float name="focusDistance" value="1050"/>{look}{header}'
                 "</sensor>"),
    "orthographic": ('<sensor type="orthographic"><transform name="toWorld">'
                     '<scale x="280" y="280" z="1"/><lookat ' + _CBOX_LOOK
                     + "/></transform>{header}</sensor>"),
    "spherical": ('<sensor type="spherical"><transform name="toWorld"><lookat '
                  'origin="278, 274, 279.6" target="278, 274, 280.6" '
                  'up="0, 1, 0"/></transform>{header}</sensor>'),
    "radiancemeter": ('<sensor type="radiancemeter"><transform '
                      'name="toWorld"><lookat origin="278, 273, -800" '
                      'target="400, 90, 250" up="0, 1, 0"/></transform>'
                      + _METER_SAMPLER + "</sensor>"),
    "fluencemeter": ('<sensor type="fluencemeter"><transform name="toWorld">'
                     '<translate x="278" y="274" z="279.6"/></transform>'
                     + _METER_SAMPLER + "</sensor>"),
}
# the irradiance meter rides on a 40 x 40 rectangle floating 0.5 above the
# floor, facing up (its disk's radius 20, the transform's x scale)
METER_PATCH = ('<shape type="rectangle"><transform name="toWorld"><scale '
               'x="20" y="20" z="1"/><rotate x="1" angle="-90"/><translate '
               'x="278" y="0.5" z="279.6"/></transform><sensor '
               'type="irradiancemeter">' + _METER_SAMPLER + "</sensor>"
               "</shape>")
LIGHTS_DIRECT = ('<integrator type="direct"><integer name="emitterSamples" '
                 'value="2"/><integer name="bsdfSamples" value="1"/>'
                 "</integrator>")


class LightsCase(typing.NamedTuple):
    """A phase-9h scene: the delta lights it adds (LIGHT_ELEMENTS' keys),
    whether it keeps the file's area light, the LIGHTS_SENSORS key of its
    sensor (or "irradiancemeter"; None: the file's camera), and its
    integrator element (None: the file's path tracer)."""
    lights: tuple = ()
    keep_area: bool = True
    sensor: typing.Optional[str] = None
    integrator: typing.Optional[str] = None


_ALL = ("point", "spot", "directional", "collimated")
LIGHTS_VARIANTS = {
    "point": LightsCase(("point",), keep_area=False),
    "spot": LightsCase(("spot",), keep_area=False),
    "directional": LightsCase(("directional",), keep_area=False),
    "all": LightsCase(_ALL),
    "all direct": LightsCase(_ALL, integrator=LIGHTS_DIRECT),
    **{k: LightsCase(sensor=k) for k in (
        "thinlens", "orthographic", "spherical", "radiancemeter",
        "irradiancemeter", "fluencemeter")},
}
LIGHTS_METERS = ("radiancemeter", "irradiancemeter", "fluencemeter")
LIGHTS_CLI = "all"


def lights_xml(case) -> str:
    """scenes/cbox.xml's text for a LightsCase (or a LIGHTS_VARIANTS key):
    the delta lights added before the floor, the area light's shape taken
    out unless kept, the sensor replaced (the cameras keep the file's
    sampler and film, the spherical camera's film $res x $half; the radiance
    and fluence meters have their own sampler and a 1x1 film; the
    irradiance meter rides on METER_PATCH), and the integrator replaced.
    The JAX side (scripts/jax_header_ref_mean.py) loads the same text."""
    if isinstance(case, str):
        case = LIGHTS_VARIANTS[case]
    lights, keep_area, sensor, integrator = case
    text = CBOX_XML.read_text()

    def cut(start, end):
        i = text.index(start)
        return text[:i], text[i:text.index(end, i) + len(end)], \
            text[text.index(end, i) + len(end):]

    emitters = "".join(LIGHT_ELEMENTS[k].format(LIGHT_RGB[k])
                       for k in lights)
    text = text.replace("<!-- floor -->", emitters + "\n    <!-- floor -->")
    if not keep_area:
        head, _, tail = cut("<!-- light -->", "</shape>")
        text = head + tail
    if sensor == "irradiancemeter":
        text = text.replace("<!-- floor -->", METER_PATCH
                            + "\n    <!-- floor -->")
    elif sensor is not None:
        head, block, tail = cut('<sensor type="perspective">', "</sensor>")
        header = block[block.index("<sampler"):block.index("</sensor>")]
        if sensor == "spherical":
            header = header.replace('name="height" value="$res"',
                                    'name="height" value="$half"')
        text = head + LIGHTS_SENSORS[sensor].format(
            look=f'<transform name="toWorld"><lookat {_CBOX_LOOK}/>'
                 "</transform>", header=header) + tail
    if integrator is not None:
        head, _, tail = cut('<integrator type="path">', "</integrator>")
        text = head + integrator + tail
    return text


# phase 9i, cloth and spectra. The woven cloth: tests/test_irawan.py's
# end-to-end scene (a rectangle under a point light, the path tracer at
# depth 3) at -D res=256 and 16 spp, its irawan element one of CLOTH_BSDFS:
# the plain and the twill preset, and CLOTH_TEXT, a .cloth pattern whose
# period and fineness turn on the yarn-tension noise and the specular
# intensity variation (the presets reach neither), written beside the file
# as CLOTH_FILE; and the same file with its integrator the multichannel
# wrapper of that path tracer (CLOTH_MULTICHANNEL), whose image must equal
# the plain variant's
CLOTH_DEFINES = {"spp": 16, "res": 256}
CLOTH_DEPTH = 3
CLOTH_FILE = "weave.cloth"
CLOTH_TEXT = """/* a 3x3 twill of blue warp and light weft yarns */
weave {
  name = "denim", tileWidth = 3, tileHeight = 3,
  alpha = 0.01, beta = 4.0, ss = 0.5, hWidth = 0.5,
  warpArea = 0.7, weftArea = 0.3, fineness = 4.0, period = 3.0,
  dWarpUmaxOverDWarp = 20, dWarpUmaxOverDWeft = 10,
  dWeftUmaxOverDWarp = -8, dWeftUmaxOverDWeft = 12,
  pattern { 1, 2, 2,  2, 1, 2,  2, 2, 1 },
  yarn { type = warp, psi = 0, umax = 38, kappa = 1.0,
         width = 1, length = 3, centerU = 0.5, centerV = 0.5,
         kd = {0.1, 0.2, 0.5}, ks = {0.2, 0.3, 0.6} },
  yarn { type = weft, psi = 30, umax = 30, kappa = 0.5,
         width = 1, length = 2, centerU = 0.5, centerV = 0.5,
         kd = {0.5, 0.5, 0.6}, ks = {0.4, 0.4, 0.5} }
}
"""
_CLOTH_COLOURS = ('<rgb name="kd" value="0.4, 0.2, 0.1"/><rgb name="ks" '
                  'value="0.3, 0.3, 0.3"/>')
CLOTH_BSDFS = {
    "plain": '<string name="preset" value="plain"/>' + _CLOTH_COLOURS,
    "twill": '<string name="preset" value="twill"/>' + _CLOTH_COLOURS,
    "cloth file": f'<string name="filename" value="{CLOTH_FILE}"/>',
}
CLOTH_PATH = ('<integrator type="path"><integer name="maxDepth" '
              f'value="{CLOTH_DEPTH}"/></integrator>')
CLOTH_MULTICHANNEL = ('<integrator type="multichannel">' + CLOTH_PATH
                      + "</integrator>")
CLOTH_CLI = "cloth file"
# the spectral render: tests/test_spectral.py's dispersion scene (a glass
# slab turned 40 degrees before an area light), built by the builder (the
# loaders read no cauchy_b), through api.render_spectral at 256x256, 16 spp,
# depth 6, without dispersion and with Cauchy's B = 0.3 um^2
SPECTRAL_RES, SPECTRAL_SPP, SPECTRAL_DEPTH = 256, 16, 6
SPECTRAL_CAUCHY = (0.0, 0.3)
SPECTRAL_EYE, SPECTRAL_AT, SPECTRAL_FOV = [0, 0, -1.5], [0, 0, 0.5], 40.0


def cloth_xml(variant, integrator=CLOTH_PATH) -> str:
    """The cloth scene's text with the CLOTH_BSDFS ``variant`` and the
    ``integrator`` element ($spp and $res defined by CLOTH_DEFINES; the
    "cloth file" variant needs write_cloth beside it). The JAX side
    (scripts/jax_header_ref_mean.py) loads the same text."""
    return f"""<scene version="0.6.0">
  <default name="spp" value="16"/><default name="res" value="12"/>
  {integrator}
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld">
      <lookat origin="0, 0.6, -1.2" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sampleCount" value="$spp"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$res"/><integer name="height" value="$res"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="-90"/></transform>
    <bsdf type="irawan">{CLOTH_BSDFS[variant]}
      <float name="repeatU" value="20"/><float name="repeatV" value="20"/>
    </bsdf>
  </shape>
  <emitter type="point">
    <point name="position" x="0.5" y="1.2" z="-0.5"/>
    <rgb name="intensity" value="6, 6, 6"/>
  </emitter>
</scene>
"""


def write_cloth(directory):
    """CLOTH_TEXT as ``directory``/CLOTH_FILE."""
    (Path(directory) / CLOTH_FILE).write_text(CLOTH_TEXT)


def spectral_scene(builder, bsdf, shapes, transform, cauchy_b):
    """tests/test_spectral.py's dispersion scene added to ``builder`` (a
    SceneBuilder of either package, with that package's ``bsdf``, ``shapes``
    and ``Transform``): a glass slab of eta 1.5 and Cauchy coefficient
    ``cauchy_b``, and an emitting rectangle behind it. Returns the
    builder."""
    glass = builder.add_material(type=bsdf.DIELECTRIC, eta=1.5,
                                 cauchy_b=cauchy_b)
    t = transform.translate([0, 0, 0.5]) * transform.rotate([0, 1, 0], 40.0)
    v, f, uv = shapes.cube(t * transform.scale([0.6, 0.6, 0.15]))
    builder.add_mesh(v, f, glass, uvs=uv)
    v, f, uv = shapes.rectangle(transform.translate([0, 0, 2.0])
                                * transform.rotate([1, 0, 0], 180.0))
    builder.add_mesh(v, f, builder.add_material(albedo=(0, 0, 0)),
                     emitter_radiance=(5.0, 5.0, 5.0), uvs=uv)
    return builder


def height_field():
    """The bump map's height field, HEIGHT_RES x HEIGHT_RES texels (rows v,
    columns u, at the texel centres): along u three terms of a sawtooth's
    Fourier series, which rises slowly and falls fast, so that a flipped
    bump tilts most of the surface the other way (a symmetric field's flip
    is only a shift); along v one sine. Smooth and periodic, so the
    repeating lookup has no seam."""
    c = 2 * np.pi * (np.arange(HEIGHT_RES) + 0.5) / HEIGHT_RES
    saw = np.sin(c) - np.sin(2 * c) / 2 + np.sin(3 * c) / 3
    return (0.5 + 0.1 * saw[None, :] + 0.05 * np.sin(2 * c)[:, None]).astype(
        np.float32)


def write_height_pfm(path):
    """height_field() as a grey PFM."""
    image_mod.write_pfm(str(path), np.repeat(height_field()[..., None], 3,
                                             axis=-1))


def log(*a):
    print(*a, flush=True)


# seconds per phase of main(), in order
PHASE_SECONDS = {}


@contextlib.contextmanager
def phase(name):
    """Time the block as the phase ``name``: printed at its end and kept in
    PHASE_SECONDS."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")


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


def cold_ms(fn, reps: int, flush) -> float:
    """Mean device time of fn() with the L2 cold: each call comes after a
    write of ``flush`` (larger than the L2), and CUDA events bracket the
    call alone. A device-side sleep queued first lets the host enqueue
    every call before the device reaches them, as in ``cuda_ms``."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


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


def camera_rays(sensor, dev, sample=0):
    """The 512x512 camera rays of ``sample``, as the render makes them."""
    settings = api.RenderSettings(width=W, height=H)
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    pos = api.pixel_sample_positions(settings, pix, sample, SEED)
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


def train_scene(dev):
    """bench.py:309-328: the Cornell box with a bitmap-textured back wall
    and a GGX rough-conductor panel, with the port's builder."""
    b = SceneBuilder()
    shapes.cornell_box(b)
    img_t = (0.25 + 0.5 * ((np.indices((64, 64)).sum(0) // 8) % 2)
             )[..., None].repeat(3, axis=-1).astype(np.float32)
    tex = b.add_texture_bitmap(img_t)
    texmat = b.add_material(albedo=(1.0, 1.0, 1.0), albedo_tex=tex)
    vq = np.array([[0.05, 0.05, 0.98], [0.95, 0.05, 0.98],
                   [0.95, 0.95, 0.98], [0.05, 0.95, 0.98]])
    fq = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64)
    uvq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    b.add_mesh(vq, fq, texmat, uvs=uvq)
    rough = b.add_material(type=bsdf_mod.ROUGH_CONDUCTOR, alpha=(0.25, 0.25),
                           eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14), dist=1)
    vr = np.array([[0.15, 0.1, 0.9], [0.85, 0.1, 0.9],
                   [0.85, 0.8, 0.8], [0.15, 0.8, 0.8]])
    b.add_mesh(vr, fq, rough)
    scene, static = b.build(device=dev)
    sensor = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                         W, H, device=dev)
    return scene, static, sensor


def veach_scene(dev, plastic=False, size=W):
    """The Veach MIS scene of BASELINE config 3 with the port's builder:
    the JAX package's fixture (tests/test_baseline_scenes.py:17-44), a
    diffuse floor, four tilted rough-conductor plates (alpha 0.005 to 0.3)
    and three sphere lights of radius 0.03, 0.12 and 0.45. ``plastic``:
    plate 1 becomes a GGX rough plastic, plate 3 a Beckmann one, both
    turned to face the camera (which sees the fixture's plates from behind),
    and the floor a nonlinear smooth plastic. Returns (scene, static, sensor
    at ``size`` x ``size``)."""
    b = SceneBuilder()
    v, f, uv = shapes.rectangle(
        Transform.translate([0, 0, 2]) * Transform.rotate([1, 0, 0], -90.0)
        * Transform.scale([6, 6, 1]))
    floor = (b.add_material(type=bsdf_mod.PLASTIC, albedo=(0.4, 0.4, 0.4),
                            eta=1.49, nonlinear=True) if plastic
             else b.add_material(albedo=(0.4, 0.4, 0.4)))
    b.add_mesh(v, f, floor, uvs=uv)
    rough_plastic = {1: ((0.1, 0.1, 0.1), mf.GGX),
                     3: ((0.5, 0.2, 0.1), mf.BECKMANN)} if plastic else {}
    for i, alpha in enumerate((0.005, 0.02, 0.1, 0.3)):
        if i in rough_plastic:
            albedo, dist = rough_plastic[i]
            mat = b.add_material(type=bsdf_mod.ROUGH_PLASTIC,
                                 alpha=(alpha, alpha), albedo=albedo,
                                 eta=1.49, dist=dist)
        else:
            mat = b.add_material(type=bsdf_mod.ROUGH_CONDUCTOR,
                                 alpha=(alpha, alpha), eta=(0.2,) * 3,
                                 k=(3.9,) * 3)
        # the camera sees the fixture's plates from behind; the rough
        # plastics are turned to face it and the lights' highlights
        tilt = TURNED if i in rough_plastic else -60.0 + 6.0 * i
        t = (Transform.translate([0.0, 0.25 + 0.45 * i, 2.8 - 0.5 * i])
             * Transform.rotate([1, 0, 0], tilt)
             * Transform.scale([2.0, 0.18, 1.0]))
        v, f, uv = shapes.rectangle(t)
        b.add_mesh(v, f, mat, uvs=uv)
    black = b.add_material(albedo=(0.0, 0.0, 0.0))
    for x, r, p in ((-1.5, 0.03, 900.0), (0.0, 0.12, 55.0), (1.5, 0.45, 4.0)):
        b.add_sphere((x, 2.6, 0.5), r, black, emitter_radiance=(p, p, p))
    scene, static = b.build(device=dev)
    sensor = sensor_mod.make_perspective(
        Transform.look_at(VEACH_EYE, VEACH_AT, UP), VEACH_FOV, size, size,
        device=dev)
    return scene, static, sensor


class StepProbe:
    """The ``mark`` hook of a training step: a CUDA event at the step's start
    and at the end of its forward, backward and update, and the launches of
    every kernel in each part (the counts set to 0 at the start and after
    each part). ``keep_grads`` copies the gradients on the device as the
    backward ends, with no synchronisation."""

    PARTS = ("forward", "backward", "update")

    def __init__(self, params, keep_grads=False):
        self.params, self.keep_grads = params, keep_grads
        self.events, self.launches, self.grads = {}, {}, None
        _zero_counts()
        self.events["start"] = self._event()

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __call__(self, part):
        self.events[part] = self._event()
        self.launches[part] = {n: k.launches for n, k in KERNELS.items()}
        _zero_counts()
        if part == "backward" and self.keep_grads:
            self.grads = {k: v.grad.detach().clone()
                          for k, v in self.params.items()}

    def ms(self):
        """Device-timeline ms of each part (after a synchronisation)."""
        names = ("start",) + self.PARTS
        return {b: self.events[a].elapsed_time(self.events[b])
                for a, b in zip(names, names[1:])}

    def check(self, label):
        """Raise unless each forward launched TRAIN_K12 of K1 and of K2 and
        nothing else ran a kernel of the port."""
        for part in self.PARTS:
            want = TRAIN_K12 if part == "forward" else {}
            got = {n: c for n, c in self.launches[part].items() if c}
            if got != want:
                raise AssertionError(f"{label} {part}: launches {got}, "
                                     f"expected {want or 'none'}")


def train_phase(dev):
    """bench.py:time_train_step through the port's trainer
    (parallel.train.make_train_step, torch autograd, Adam at 2e-2) on
    bench's training scene at 512x512, depth 5, spp 2, box filter: the
    target by api.render (samples 0 and 1), step 0 (the target's own
    samples: loss 0, gradients 0), then steps 1-4 timed as bench times
    them. Step 1 runs at the initial parameters (step 0's Adam update of
    zero gradients moves nothing), and its loss and gradients are held
    against scripts/jax_train_ref.py's. Returns what ``train_profile``
    steps on."""
    from mitsuba_tpu_torch.parallel import train as train_mod

    scene, static, sensor = train_scene(dev)
    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    settings = api.RenderSettings(width=W, height=H, spp=TRAIN_SPP,
                                  spp_per_pass=TRAIN_SPP, filter_type=0)
    ref = np.load(TRAIN_REF)
    if int(ref["size"]) != W:
        raise AssertionError(f"{TRAIN_REF} is of {int(ref['size'])}x"
                             f"{int(ref['size'])}, the phase of {W}x{H}")
    log(f"train scene: {static.n_tris} triangles, bsdf types "
        f"{static.bsdf_types}, textures {static.has_textures}")

    _zero_counts()
    target = api.render(scene, static, sensor, cfg, settings, device=dev)
    torch.cuda.synchronize()
    _check_launches("train target", TRAIN_K12)
    log(f"train target mean_rgb {target.mean(dim=(0, 1)).tolist()} (JAX "
        f"package's, {TRAIN_REF.name}: {ref['target_mean'].tolist()})")

    spec = train_mod.ParamSpec(albedo=True, emitter_radiance=True,
                               roughness=True, texture_stack=True)
    params = train_mod.split_params(scene, spec)
    step, init = train_mod.make_train_step(scene, static, sensor, cfg,
                                           settings, spec, n_samples=TRAIN_SPP,
                                           device=dev)
    opt_state = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    probe = StepProbe(params, keep_grads=True)
    params, opt_state, loss0 = step(params, opt_state, target, 0, mark=probe)
    torch.cuda.synchronize()
    probe.check("train step 0")
    g0 = max(float(g.abs().max()) for g in probe.grads.values())
    log(f"train step 0 (samples 0-1, the target's): loss {float(loss0)!r}, "
        f"max |gradient| {g0!r}; split {probe.ms()}")
    if float(loss0) > 1e-12 or g0 != 0.0:
        raise AssertionError(f"step 0: loss {float(loss0)}, max |gradient| "
                             f"{g0}; render and the trainer disagree")

    probes = []
    t0 = time.perf_counter()
    for it in range(1, TRAIN_ITERS + 1):
        probes.append(StepProbe(params, keep_grads=it == 1))
        params, opt_state, loss = step(params, opt_state, target, it,
                                       mark=probes[-1])
        if it == 1:
            loss1 = loss
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for it, pr in enumerate(probes, 1):
        pr.check(f"train step {it}")
        log(f"train step {it}: device-timeline ms {pr.ms()}")
    split = {p: float(np.mean([pr.ms()[p] for pr in probes]))
             for p in StepProbe.PARTS}
    final_loss = float(loss)
    log(f"train steps 1-{TRAIN_ITERS}: {dt:.3f} s, fwd_bwd_ms_per_spp "
        f"{dt / (TRAIN_ITERS * TRAIN_SPP) * 1e3:.2f} (bench.py: dt / (iters * "
        f"spp)), final_loss {final_loss!r}")
    log(f"train mean split of a step (CUDA events, ms): {split}, sum "
        f"{sum(split.values()):.3f}")
    log(f"train max_memory_allocated {peak} bytes ({peak / 2 ** 30:.2f} GiB; "
        f"{mem0} before step 0)")
    if not np.isfinite(final_loss):
        raise AssertionError(f"final loss {final_loss}")

    # step 1 against the JAX package's loss and gradients (CPU, same samples)
    l1, lref = float(loss1), float(ref["loss"])
    log(f"train step 1 loss {l1!r}, JAX {lref!r}, relative "
        f"{l1 / lref - 1:+.3e} (tolerance {TRAIN_LOSS_RTOL})")
    bad = abs(l1 / lref - 1) > TRAIN_LOSS_RTOL
    for k, g in probes[0].grads.items():
        a = g.double().cpu().numpy().ravel()
        b = ref[f"grad_{k}"].astype(np.float64).ravel()
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        log(f"train step 1 gradient {k}: norm {float(np.linalg.norm(a))!r} "
            f"(JAX {float(np.linalg.norm(b))!r}), sum {float(a.sum())!r} (JAX "
            f"{float(b.sum())!r}), relative L2 {rel:.3e}, cosine {cos:.6f}")
        bad |= not (np.isfinite(a).all() and rel <= TRAIN_GRAD_RTOL
                    and cos >= TRAIN_GRAD_COS)
    if bad:
        raise AssertionError("train step 1 disagrees with the JAX package "
                             f"(loss rtol {TRAIN_LOSS_RTOL}, gradients "
                             f"relative L2 {TRAIN_GRAD_RTOL}, cosine "
                             f"{TRAIN_GRAD_COS})")
    return target, step, params, opt_state


def train_profile(trainer):
    """One training step (it = 5) with the forward and the backward each
    under torch.profiler: the device's busy share of each part's wall time
    and the backward's top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    target, step, params, opt_state = trainer
    profs = {p: profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
             for p in ("forward", "backward")}
    walls = {}
    clock = [0.0]

    def mark(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if part in profs:
            profs[part].stop()
            walls[part] = now - clock[0]
        if part == "forward":
            clock[0] = time.perf_counter()
            profs["backward"].start()

    torch.cuda.synchronize()
    profs["forward"].start()
    clock[0] = time.perf_counter()
    step(params, opt_state, target, TRAIN_ITERS + 1, mark=mark)
    for part, prof in profs.items():
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0}
        busy = sum(dev_us.values()) / 1e6
        log(f"profile train {part}: wall {walls[part] * 1e3:.3f} ms, device "
            f"busy {busy * 1e3:.3f} ms "
            f"({'not measured' if not dev_us else f'{busy / walls[part]:.1%}'}), "
            f"{sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)} "
            f"kernel launches")
        if part == "backward":
            for k, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
                log(f"profile   {us / 1e3:9.3f} ms  {k[:90]}")
    gather_backward(params["albedo"].device)


def gather_backward(dev):
    """The backward of one lane gather from a small trainable table, as the
    trainer's material and emitter gathers make it (table[index], which
    autograd reverses with a sorting index_put_), against index_select's
    (an index_add_), on one wavefront of lanes; CUDA events."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # the emitter radiance (one row here), the material table, the stack
    for rows, cols in ((1, 3), (6, 3), (4096, 3)):
        table = torch.rand((rows, cols), generator=g).to(dev).requires_grad_()
        idx = torch.randint(0, rows, (W * H,), generator=g).to(dev)
        cot = torch.rand((W * H, cols), generator=g).to(dev)

        def grad_of(gather):
            return torch.autograd.grad(gather(), table, cot)[0]

        ref = grad_of(lambda: table[idx])
        alt = grad_of(lambda: torch.index_select(table, 0, idx))
        ms = {name: cuda_ms(lambda f=f: grad_of(f), reps=5, warmup=1)
              for name, f in (("table[index]", lambda: table[idx]),
                              ("index_select", lambda: torch.index_select(
                                  table, 0, idx)))}
        log(f"gather backward, ({rows}, {cols}) table, {W * H} lanes: "
            f"{ms['table[index]']:.3f} ms (table[index]), "
            f"{ms['index_select']:.3f} ms (index_select), max difference "
            f"{float((alt - ref).abs().max() / ref.abs().max()):.2e} of the "
            f"largest entry")


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
                       any_hit, rec=None, octants=None, bound_rows=None,
                       leaf_bytes=48):
    """K3/K6/K9: a launch of ``budget`` visits from the root, then the
    resumed rest: kernel == plain version bit for bit after each
    (closest-hit lanes on ``octants``). On the first call (rec None) also
    time one unbounded launch from the root, the kernel's whole walk in one
    launch, and its plain version; the bound charges the rows of
    ``bound_rows`` (node-major, as the plain version's rows-read mask
    indexes them; default the table the walk reads) that it reads,
    ``leaf_bytes`` per leaf."""
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
        rows = bound_rows
        if rows is None:
            rows = nodes if octants is None or any_hit else octant_rows(octants)
        rec["bound_ms"], rec["bound_by"] = lane_bound_ms(
            rows, t_max.shape[0], full[5], K3_RAY_BYTES, leaf_bytes=leaf_bytes,
            map_read=full[5][3])
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
    walk on the same sorted bounce rays: one unbounded launch against the
    canonical plain walk (hit and t), visits per live lane, and times in
    turns with K4, which walks the canonical table from the root."""
    R = tmx.shape[0]
    root = _root_state(N, rays, tmx)
    live = root[0] < N
    o, d = torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1)
    canonical = cb.canonical_walk_plain(nodes, N, o, d, rays[6], tmx,
                                        with_visits=True)
    against_canonical("K3 octant walk vs the canonical walk", chunk_result(
        cb.lane_chunk(nodes, N, *rays, *root, octants=octants)),
        canonical[:5])
    mean = walk_visits("K3 on the sorted bounce rays", {
        "octant (K3)": cb.lane_chunk_plain(
            nodes, N, *rays, *root, octants=octants, with_visits=True)[5],
        "canonical": canonical[5]}, live, N)
    if not mean["octant (K3)"] < mean["canonical"]:
        raise AssertionError("the octant walk visits no fewer nodes than the "
                             "canonical walk")
    in_turns(f"K3 (octant tables) against K4 (canonical walk), one "
             f"unbounded launch each on the same {R} sorted bounce rays", {
                 "K4": lambda: cb.bvh_traverse_lane_packed(nodes, N, o, d,
                                                           rays[6], tmx),
                 "K3": lambda: cb.lane_chunk(nodes, N, *rays, *root,
                                             octants=octants)})


def k4_phase(dev, nodes, N, octants, sensor, cam):
    """K4 on the camera rays: kernel == plain version bit for bit (closest
    hit and any-hit, both on the canonical table); its closest hits and
    visits against the octant walk from the root (K5's walk) on the same
    rays, and the two kernels timed in turns; then K4's time back to back
    (the L2 warm), with the L2 flushed before each launch, and on the camera
    rays of each sample the bunny render traces. Returns the record, with
    the warm and cold times under "warm_ms" and "cold_ms"."""
    rec, (out, visits) = check_root_kernel(
        "bvh_traverse_lane_packed", cb.bvh_traverse_lane_packed,
        cb.bvh_traverse_lane_packed_plain, nodes, N, *cam)
    octant = cb.lane_hbm_plain(nodes, N, *cam, octants=octants,
                               with_visits=True)
    against_canonical("the octant walk (K5's) vs K4 on the camera rays",
                      octant[:5], out)
    live = cam[3] > cam[2]
    log(f"camera rays, octant walk (K5's): {_visits_line(octant[5], live)}; "
        f"rays per octant {torch.bincount(cb._octant(*cam[1].T), minlength=cb.OCTANTS).tolist()}")
    walk_visits("camera rays", {"canonical (K4)": visits,
                                "octant (K5's)": octant[5]}, live, N)
    in_turns("K4 (canonical walk) against K5 (octant walk from the root), "
             f"one launch each on the same {cam[0].shape[0]} camera rays", {
                 "K4": lambda: cb.bvh_traverse_lane_packed(nodes, N, *cam),
                 "K5": lambda: cb.lane_hbm(nodes, N, *cam, octants=octants)})
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)

    def k4(rays):
        return lambda: cb.bvh_traverse_lane_packed(nodes, N, *rays)
    rec["warm_ms"], mhz_warm = sm_clock_during(lambda: cuda_ms(k4(cam),
                                                               reps=200))
    rec["cold_ms"], mhz_cold = sm_clock_during(lambda: cold_ms(
        k4(cam), reps=200, flush=flush))
    log(f"kernel bvh_traverse_lane_packed on the camera rays of sample 0: "
        f"{rec['warm_ms']:.4f} ms back to back ({mhz_warm:.0f} MHz), "
        f"{rec['cold_ms']:.4f} ms with {FLUSH_BYTES >> 20} MB written "
        f"before each launch ({mhz_cold:.0f} MHz)")
    per_sample = []
    for sample in range(BUNNY_SPP):
        rays = camera_rays(sensor, dev, sample)
        per_sample.append((cuda_ms(k4(rays), reps=20),
                           cold_ms(k4(rays), reps=20, flush=flush)))
    log("kernel bvh_traverse_lane_packed on the camera rays of samples 0-"
        f"{BUNNY_SPP - 1} (warm, cold ms): "
        + ", ".join(f"({w:.4f}, {c:.4f})" for w, c in per_sample))
    return rec


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
    for name in ("lane_chunk", "treelet_rounds", "bvh_traverse_lane_packed",
                 "bvh_traverse_lane_packed any_hit"):
        regs, blocks = cb.kernel_occupancy(name)
        log(f"occupancy {name}: {regs} registers, {blocks} blocks of 128 per "
            f"SM = {blocks * 128} threads; one wave holds "
            f"{blocks * 128 * torch.cuda.get_device_properties(dev).multi_processor_count} rays")
    cam = camera_rays(sensor, dev)
    records = {"bvh_traverse_lane_packed": k4_phase(dev, nodes, N, octants,
                                                    sensor, cam)}

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
    """K8 on the split tables (cuda_bvh.fat_tables) of a leaf-4 tree of the
    bunny's triangles: on camera and sorted bounce rays, closest and
    any-hit, and with per-ray [start, end) treelet ranges, the kernel ==
    its plain twin bit for bit and the twin == the JAX walk over the fat
    rows (fat_rows_walk_plain) bit for bit, with the exact ties met, visits,
    head rows and slots read, ms and the bound; then the sorting query with
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
        f"{time.perf_counter() - t0:.2f} s, {fat.numel() * 4 / 1e6:.1f} MB")
    t0 = time.perf_counter()
    tables = cb.fat_tables(fat)
    torch.cuda.synchronize()
    log(f"K8 split tables: heads {tables.heads.numel() * 4 / 1e6:.2f} MB, "
        f"octant heads {tables.octant_heads.numel() * 4 / 1e6:.2f} MB, "
        f"triangle slots {tables.tris.numel() * 4 / 1e6:.2f} MB, packed in "
        f"{time.perf_counter() - t0:.3f} s")
    for kind in ("", " any_hit", " bounded", " any_hit bounded"):
        regs, blocks = cb.kernel_occupancy("bvh_traverse_packed" + kind)
        log(f"occupancy bvh_traverse_packed{kind}: {regs} registers, "
            f"{blocks} blocks of 128 per SM")
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
        # 32 B per head row read, 48 B per slot of a leaf whose box some
        # lane entered (the kernel reads no other slot), and the rays
        v_node, v_tri, touched, opened, _ = visits
        nbytes = (int(touched.sum()) * 32 + int(opened.sum()) * 48
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
        case = f"bvh_traverse_packed/{label}/any_hit={any_hit}"
        out = cb.bvh_traverse_packed(tables, *rays, *rng, any_hit=any_hit)
        ref = cb.bvh_traverse_packed_plain(tables, *rays, *rng,
                                           any_hit=any_hit, with_visits=True)
        yard = cb.fat_rows_walk_plain(fat, *rays, *rng, any_hit=any_hit,
                                      with_visits=True)
        torch.cuda.synchronize()
        err, ulp = compare(case, out, ref[:5], n_exact=1, ulp_limit=0)
        compare(f"{case} (plain twin vs the fat-row walk)", ref[:5], yard[:5],
                n_exact=1, ulp_limit=0)
        y_node = yard[5][0]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        v_node, v_tri, touched, opened, ties = ref[5]
        live = v_node > 0
        ms = cuda_ms(lambda: cb.bvh_traverse_packed(tables, *rays, *rng,
                                                    any_hit=any_hit), reps=20)
        R = rays[0].shape[0]
        bound, by = bound_of(ref[5], R, rng[0] is not None)
        log(f"kernel bvh_traverse_packed {label} any_hit={any_hit}: R={R} "
            f"hit/idx mismatches 0, max |kernel-plain| {err:.3g} ({ulp} ulp); "
            f"plain twin == fat-row walk bit for bit, exact ties met "
            f"{int(ties.sum())} on {int((ties > 0).sum())} lanes; hit rate "
            f"{float(out[0].float().mean()):.4f}, node visits "
            f"{int(v_node.sum())} ({float(v_node[live].float().mean()):.2f} "
            f"per live lane, max {int(v_node.max())}, warp efficiency "
            f"{warp_efficiency(v_node):.3f}; the fat-row walk's "
            f"{float(y_node[live].float().mean()):.2f}, max "
            f"{int(y_node.max())}), triangle tests "
            f"{int(v_tri.sum())}, {int(touched.sum())} distinct head rows "
            f"of {touched.numel()}, {int(opened.sum())} slots read; "
            f"{ms:.4f} ms, bound {bound:.5f} ms ({by})")
        if label == "bounce" and not any_hit:
            _, rec["plain_ms"] = device_ms(lambda: cb.bvh_traverse_packed_plain(
                tables, *rays))
            rec.update(ms=ms, bound_ms=bound, bound_by=by, library_ms=None)
    # the op as a caller drives it: sort, K8, unsort, closest and any-hit
    _zero_counts()
    res = [cb.bvh_traverse(tables, *bounce, lo, hi, any_hit=a)
           for a in (False, True)]
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
    """K9 on a leaf-1 tree of the bunny's triangles, closest hit on its
    octant tables as wide pages, any-hit on pack_pages_w: a bounded launch
    on the sorted bounce rays and the resumed rest, kernel == plain bit for
    bit, closest and any-hit; one unbounded launch of each kind bit for bit
    against K3's (closest) and K4's canonical any-hit walk on the same tree
    and rays, the closest hits against the canonical plain walk (near-ties
    printed), each timed in turns with K3 and K6; then its resort query with the
    counts set to 0, bit for bit against K3's resort query and against K4's
    sorted query (the canonical walk: near-ties printed), and timed in turns
    with K3's."""
    dev = scene.nodes.device
    lo, hi = scene.aabb_lo, scene.aabb_hi
    tris, box = scene_tris(scene)
    bvh = build_bvh(*box)
    N = len(bvh.lo)
    pages = torch.as_tensor(cb.pack_pages_w(bvh, *tris), device=dev)
    nodes_np = cb.pack_nodes(bvh, *tris)
    nodes = torch.as_tensor(nodes_np, device=dev)
    octants = cb.octant_tables(nodes_np, device=dev)
    t0 = time.perf_counter()
    wide = cb.wide_octant_pages(octants)
    torch.cuda.synchronize()
    log(f"wide pages: {N} nodes, page {cb.WIDE_PAGE}: canonical "
        f"{pages.numel() * 4} bytes, octant pages {wide.pages.numel() * 4} "
        f"bytes, packed in {time.perf_counter() - t0:.3f} s")
    for name in ("lane_chunk_w", "lane_chunk_w any_hit"):
        regs, blocks = cb.kernel_occupancy(name)
        log(f"occupancy {name}: {regs} registers, {blocks} blocks of 128 per "
            f"SM")
    (*rays, tmx), _ = cb.sort_rays(*bounce, lo, hi)
    rays = tuple(rays)
    so, sd = torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1)
    budget = 16 * cb.LSTRIP   # the resort query's default chunk_nit x strip
    rec = None
    for any_hit in (False, True):
        rec = check_chunk_kernel(
            "lane_chunk_w", cb.lane_chunk_w, cb.lane_chunk_w_plain, pages, N,
            rays, tmx, budget, any_hit, rec, octants=wide,
            bound_rows=octant_rows(octants), leaf_bytes=K9_LEAF_BYTES)
    root = _root_state(N, rays, tmx)
    k9 = {a: cb.lane_chunk_w(pages, N, *rays, *root, any_hit=a, octants=wide)
          for a in (False, True)}
    k3 = cb.lane_chunk(nodes, N, *rays, *root, octants=octants)
    if not all(torch.equal(a, b) for a, b in zip(k9[False], k3)):
        raise AssertionError("K9 and K3 disagree on the same octant tables")
    if not all(torch.equal(a, b) for a, b in zip(chunk_result(k9[True]),
               cb.bvh_traverse_lane_packed(nodes, N, so, sd, rays[6], tmx,
                                           any_hit=True))):
        raise AssertionError("K9 any-hit and K4 any-hit (the canonical walk) "
                             "disagree on the same tree")
    against_canonical("K9 octant walk vs the canonical walk",
                      chunk_result(k9[False]), cb.canonical_walk_plain(
                          nodes, N, so, sd, rays[6], tmx))
    label = f"one unbounded launch each on the same {tmx.shape[0]} sorted " \
        "bounce rays and tree"
    for any_hit in (False, True):
        kw = dict(any_hit=any_hit, octants=octants)

        def k9(a=any_hit):
            return cb.lane_chunk_w(pages, N, *rays, *root, any_hit=a,
                                   octants=wide)
        in_turns(f"K9 against K3, any_hit={any_hit}, {label}", {
            "K3": lambda kw=kw: cb.lane_chunk(nodes, N, *rays, *root, **kw),
            "K9": k9})
        # the same walk over node rows, an instantiation per query kind
        in_turns(f"K9 against K6, any_hit={any_hit}, {label}", {
            "K6": lambda kw=kw: cb.lane_chunk_hbm(nodes, N, *rays, *root,
                                                  **kw),
            "K9": k9})
    log(f"kernel lane_chunk_w (one unbounded launch, sorted bounce rays): "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    _zero_counts()
    res = cb.bvh_traverse_lane_resort_w(pages, N, *bounce, lo, hi,
                                        octants=wide)
    torch.cuda.synchronize()
    launches = _check_launches("bvh_traverse_lane_resort_w (K9 query)",
                               {"lane_chunk_w": 3})
    rec["launches"] = launches["lane_chunk_w"]

    def k3_query():
        return cb.bvh_traverse_lane_resort(nodes, N, *bounce, lo, hi,
                                           rounds=2, chunk_nit=16,
                                           octants=octants)
    if not all(torch.equal(a, b) for a, b in zip(res, k3_query())):
        raise AssertionError("K9's resort query and K3's disagree")
    against_canonical("K9 resort query vs K4's sorted query (the canonical "
                      "walk)", res, cb.bvh_traverse_lane(nodes, N, *bounce, lo,
                                                         hi, sort=True))
    in_turns("K9 resort query against K3's (rounds 2, chunk_nit 16)", {
        "K3": k3_query,
        "K9": lambda: cb.bvh_traverse_lane_resort_w(pages, N, *bounce, lo,
                                                    hi, octants=wide)},
        reps=10)
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
    then resumed, closest and any-hit); their closest hits against the
    canonical plain walk of the same tree and rays; visits against its;
    each timed in turns with K4; then the tier's queries with the launch counts
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
    # the redesigned walks against the canonical plain walk of the same tree
    # and rays: results and visits; times in turns with K4, the canonical
    # walk from the root
    root = _root_state(N, rays, tmx)
    live = root[0] < N
    k4 = {a: lambda a=a: cb.bvh_traverse_lane_packed(nodes, N, so, sd,
                                                     rays[6], tmx, any_hit=a)
          for a in (False, True)}
    *canonical, canon = cb.canonical_walk_plain(nodes, N, so, sd, rays[6], tmx,
                                                with_visits=True)
    against_canonical("K5 octant walk vs the canonical walk", k5_out,
                      canonical)
    against_canonical("K6 octant walk (one unbounded launch) vs the canonical "
                      "walk", chunk_result(cb.lane_chunk_hbm(
                          nodes, N, *rays, *root, octants=octants)), canonical)
    log(f"large tier, canonical walk (closest hit): "
        f"{_visits_line(canon, live)}")
    walk_visits("large tier, closest hit", {"octant (K5, K6)": k5_visits,
                                            "canonical": canon}, live, N)
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
    """The port's main path: api.render at 512x512, depth 5, seed 0, after a
    warm-up at 64x64 (``timed_render``). Returns (launches, mean_rgb,
    ms/spp)."""
    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    # warm-up at a small size (first-call set-up of the CUDA libraries)
    small = sensor_mod.make_perspective(Transform.look_at(eye, at, UP), fov,
                                        64, 64, device=dev)
    api.render(scene, static, small, cfg,
               api.RenderSettings(width=64, height=64, spp=1, spp_per_pass=1),
               device=dev)
    settings = api.RenderSettings(width=W, height=H, spp=spp,
                                  spp_per_pass=spp_per_pass, seed=SEED)
    _, launches, mean, ms = timed_render(dev, label, scene, static, sensor,
                                         cfg, settings, ref_mean, rtol,
                                         expected)
    return launches, mean, ms


def render_fn(label):
    """The entry point a render's label names: api.render_spectral for
    phase 9i's spectral renders, api.render for every other."""
    return api.render_spectral if label.startswith("spectral") else api.render


def timed_render(dev, label, scene, static, sensor, cfg, settings, ref_mean,
                 rtol, expected):
    """render_fn(label) (api.render but for the spectral renders) with every
    launch count set to 0 just before and read just after; prints its wall
    time, rays/s, ms/spp, the exact ray count and the peak memory; checks
    the counts against ``expected`` (0 for a kernel not named), the image's
    shape and finiteness, and its mean against the JAX package's value
    within ``rtol`` per channel. Returns (image, launches, mean_rgb,
    ms/spp)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    img, n_rays = render_fn(label)(scene, static, sensor, cfg, settings,
                                   device=dev, with_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    spp = settings.spp
    if tuple(img.shape) != (settings.height, settings.width, 3):
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite pixels")
    mean = img.mean(dim=(0, 1)).tolist()
    gap = [a / b - 1.0 for a, b in zip(mean, ref_mean)]
    log(f"render {label} {settings.width}x{settings.height} integrator "
        f"{cfg.type} depth {cfg.max_depth} spp {spp} (passes of "
        f"{settings.spp_per_pass}), seed {settings.seed}: {dt:.3f} s")
    log(f"render {label} mean_rgb {mean} (reference {list(ref_mean)}, "
        f"relative gap {gap})")
    log(f"render {label} rays {n_rays}, {n_rays / dt:.1f} rays/s, "
        f"{dt / spp * 1e3:.3f} ms/spp")
    log(f"render {label} max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    launches = _check_launches(f"render {label}", expected)
    for c, g in enumerate(gap):
        if abs(g) > rtol:
            raise AssertionError(
                f"{label}: mean_rgb[{c}] = {mean[c]:.6f}, reference "
                f"{ref_mean[c]} (tolerance {rtol:.1%})")
    return img, launches, mean, dt / spp * 1e3


def scene_file_phase(dev):
    """The scene-file entry points on the card: load_scene + api.render of
    cbox.xml (path tracer, its glass sphere), the Cornell box through the
    direct integrator, and the CLI in a subprocess, whose EXR must equal
    the first image bit for bit. Returns the two renders' (scene, static,
    sensor, cfg) for the profile phase."""
    defines = {"spp": CBOX_SPP, "res": CBOX_RES}
    t0 = time.perf_counter()
    ls = mitsuba_xml.load_scene(str(CBOX_XML), defines)
    log(f"scene file: load_scene(cbox.xml, {defines}) "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms: {ls.static}; "
        f"{ls.settings}; {ls.integrator}")
    # warm-up at a small size (first-call set-up of the CUDA libraries)
    small = mitsuba_xml.load_scene(str(CBOX_XML), {"spp": 1, "res": 32})
    api.render(small.scene, small.static, small.sensor, small.integrator,
               small.settings, device=dev)
    img = timed_render(
        dev, "scene file cbox.xml", ls.scene, ls.static, ls.sensor,
        ls.integrator, ls.settings, CBOX_REF_MEAN_RGB, SCENE_MEAN_RTOL,
        {"brute_force_interaction": DEPTH * CBOX_SPP,
         "brute_force_closest_hit": DEPTH * CBOX_SPP})[0]

    scene, static, _ = cornell(dev)
    sensor = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                         DIRECT_RES, DIRECT_RES, device=dev)
    direct_cfg = IntegratorConfig(type=DIRECT)
    timed_render(
        dev, "scene file cornell direct", scene, static, sensor, direct_cfg,
        api.RenderSettings(width=DIRECT_RES, height=DIRECT_RES,
                           spp=DIRECT_SPP, spp_per_pass=4, seed=SEED),
        DIRECT_REF_MEAN_RGB, SCENE_MEAN_RTOL,
        {"brute_force_interaction": 2 * DIRECT_SPP,
         "brute_force_closest_hit": DIRECT_SPP})

    cli_matches("scene file", CBOX_XML, defines, img)
    return ((ls.scene, ls.static, ls.sensor, ls.integrator),
            (scene, static, sensor, direct_cfg))


def cli_matches(label, path, defines, img):
    """python -m mitsuba_tpu_torch on the scene file ``path`` with
    ``defines`` in a subprocess, on the card; its EXR must equal ``img``
    (api.render's image of the same file) bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.exr"
        cmd = [sys.executable, "-m", "mitsuba_tpu_torch", str(path)]
        for k, v in defines.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += ["-z", "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=300)
        dt = time.perf_counter() - t0
        for line in (proc.stdout + proc.stderr).splitlines()[-5:]:
            log(f"{label} cli: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{label} cli: exit code {proc.returncode}")
        cli_img = image_mod.read_exr(str(out))
    api_img = img.cpu().numpy()
    same = np.array_equal(cli_img, api_img)
    log(f"{label} cli: {' '.join(cmd[1:])}: {dt:.2f} s with the process "
        f"start; EXR equal to api.render's image bit for bit: {same} (max "
        f"abs difference {np.abs(cli_img - api_img).max()})")
    if not same:
        raise AssertionError(f"{label} cli: the EXR differs from the image "
                             "of api.render")


def veach_phase(dev):
    """BASELINE config 3 on the card: the Veach MIS scene (three sphere
    lights, cone-sampled NEE against four rough plates) and its plastic
    variant through the path tracer at depth 3, 32 spp, and the first
    through the direct integrator, 16 spp; 512x512, box filter, seed 0,
    each held to the JAX package's mean and the exact K1/K2 launches.
    Returns the first scene's (scene, static, sensor, cfg) for the profile
    phase."""
    path_cfg = IntegratorConfig(type=PATH, max_depth=VEACH_DEPTH)
    direct_cfg = IntegratorConfig(type=DIRECT)
    scenes = {}
    for plastic in (False, True):
        label = "veach_mis_plastic" if plastic else "veach_mis"
        t0 = time.perf_counter()
        scenes[plastic] = veach_scene(dev, plastic=plastic)
        log(f"{label}: build {time.perf_counter() - t0:.3f} s (the "
            f"rough-transmittance bake included): {scenes[plastic][1]}")
    # warm-up at a small size (first-call set-up of the CUDA libraries)
    for plastic, cfg in ((False, path_cfg), (True, path_cfg),
                         (False, direct_cfg)):
        scene, static, _ = scenes[plastic]
        small = sensor_mod.make_perspective(
            Transform.look_at(VEACH_EYE, VEACH_AT, UP), VEACH_FOV, 64, 64,
            device=dev)
        api.render(scene, static, small, cfg,
                   api.RenderSettings(width=64, height=64, spp=1,
                                      spp_per_pass=1, filter_type=0),
                   device=dev)
    for label, plastic, cfg, spp, ref, k1, k2 in (
            ("veach_mis path", False, path_cfg, VEACH_PATH_SPP,
             VEACH_REF_MEAN_RGB, VEACH_DEPTH, VEACH_DEPTH),
            ("veach_mis_plastic path", True, path_cfg, VEACH_PATH_SPP,
             VEACH_PLASTIC_REF_MEAN_RGB, VEACH_DEPTH, VEACH_DEPTH),
            ("veach_mis direct", False, direct_cfg, VEACH_DIRECT_SPP,
             VEACH_DIRECT_REF_MEAN_RGB, 2, 1)):
        scene, static, sensor = scenes[plastic]
        timed_render(
            dev, label, scene, static, sensor, cfg,
            api.RenderSettings(width=W, height=H, spp=spp,
                               spp_per_pass=VEACH_SPP_PER_PASS,
                               filter_type=0, seed=SEED),
            ref, VEACH_MEAN_RTOL,
            {"brute_force_interaction": k1 * spp,
             "brute_force_closest_hit": k2 * spp})
    return scenes[False] + (path_cfg,)


def sampler_bits_phase(dev):
    """Every sampler type's draws on the card against the same functions on
    the CPU, bit for bit: uniform4 and uniform2 at BITS_PIXELS pixels x
    BITS_SAMPLES samples x the dimensions BITS_DIMS, and the pixel sample
    positions (the stratified jitter) of each sample. Counts the draws of
    exactly 1.0 (a uint32 word of 2^32 - 128 or more rounds to 2^32)."""
    pix_cpu = torch.arange(BITS_PIXELS, dtype=torch.int64)
    pix = pix_cpu.to(dev)
    for name, tag in SAMPLER_TYPES.items():
        t0 = time.perf_counter()
        settings = api.RenderSettings(width=256, height=BITS_PIXELS // 256,
                                      spp=BITS_SAMPLES, sampler_type=tag,
                                      seed=SEED)
        smp = api.sampler_of(settings)
        ones = values = 0
        for s in range(BITS_SAMPLES):
            pairs = [(api.pixel_sample_positions(settings, pix, s, smp),
                      api.pixel_sample_positions(settings, pix_cpu, s, smp))]
            for d in BITS_DIMS:
                for fn in (rng_mod.uniform4, rng_mod.uniform2):
                    pairs.append((fn(smp, pix, s, d), fn(smp, pix_cpu, s, d)))
            for i, (a, b) in enumerate(pairs):
                if not torch.equal(a.cpu().view(torch.int32),
                                   b.view(torch.int32)):
                    raise AssertionError(
                        f"sampler bits {name}: sample {s}, draw {i} differs "
                        "between the card and the CPU")
                if i:
                    ones += int((b == 1.0).sum())
                    values += b.numel()
        log(f"sampler bits {name} ({smp}): {values} values in "
            f"{BITS_SAMPLES} samples x dimensions {BITS_DIMS} x uniform4 and "
            f"uniform2 at {BITS_PIXELS} pixels, and the pixel positions, "
            f"equal bit for bit on the card and the CPU; {ones} draws of "
            f"exactly 1.0; {time.perf_counter() - t0:.2f} s")


def header_xml(sampler, rfilter):
    """scenes/cbox.xml's text with another sampler and filter type (as
    scripts/jax_header_ref_mean.py's variant_xml makes it)."""
    text = CBOX_XML.read_text()
    for kind, old, new in (("sampler", "independent", sampler),
                           ("rfilter", "gaussian", rfilter)):
        tag = f'<{kind} type="{old}"'
        if text.count(tag) != 1:
            raise AssertionError(f"cbox.xml has no single {tag}")
        text = text.replace(tag, f'<{kind} type="{new}"')
    return text


def tv_rgb(img):
    """Mean absolute difference of horizontally adjacent pixels, per
    channel, in float64 (as scripts/jax_header_ref_mean.py computes it)."""
    img = img.double()
    return (img[:, 1:] - img[:, :-1]).abs().mean(dim=(0, 1)).tolist()


def header_render(dev, label, scene, static, sensor, cfg, settings,
                  expected):
    """timed_render held to HEADER_REF[label]: the mean within
    HEADER_MEAN_RTOL per channel, then tv_rgb within HEADER_TV_RTOL.
    Returns the image."""
    mean_ref, tv_ref = HEADER_REF[label]
    img = timed_render(dev, label, scene, static, sensor, cfg, settings,
                       mean_ref, HEADER_MEAN_RTOL, expected)[0]
    tv = tv_rgb(img)
    gap = [a / b - 1.0 for a, b in zip(tv, tv_ref)]
    log(f"render {label} tv_rgb {tv} (reference {list(tv_ref)}, relative "
        f"gap {gap})")
    for c, g in enumerate(gap):
        if abs(g) > HEADER_TV_RTOL:
            raise AssertionError(
                f"{label}: tv_rgb[{c}] = {tv[c]:.6f}, reference {tv_ref[c]} "
                f"(tolerance {HEADER_TV_RTOL:.1%})")
    return img


def header_renders(dev, tmp, cornell_scene):
    """Every render of the sensor-header phase but bunny_x2's, by label:
    (scene, static, sensor, cfg, settings, expected launches). The cbox.xml
    variants are loaded from files written under ``tmp``
    (``{sampler}_{rfilter}.xml``); ao and field render ``cornell_scene``.
    scripts/torch_header_stats.py renders the same."""
    def k12(n):
        return {"brute_force_interaction": n, "brute_force_closest_hit": n}

    out = {}
    for sampler, rfilter, spp, res in (
            [("ldsampler", "mitchell", CBOX_SPP, CBOX_RES)]
            + [(s, "gaussian", HEADER_SPP, HEADER_RES)
               for s in HEADER_OTHER_SAMPLERS]
            + [("independent", r, HEADER_SPP, HEADER_RES)
               for r in HEADER_OTHER_FILTERS]):
        path = Path(tmp) / f"{sampler}_{rfilter}.xml"
        path.write_text(header_xml(sampler, rfilter))
        ls = mitsuba_xml.load_scene(str(path), {"spp": spp, "res": res},
                                    device=dev)
        # a closest-hit (K1) and a shadow query (K2) per bounce and sample
        out[f"cbox.xml {sampler} {rfilter}"] = (
            ls.scene, ls.static, ls.sensor, ls.integrator, ls.settings,
            k12(DEPTH * spp))
    scene, static, sensor = cornell_scene
    small = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                        AO_RES, AO_RES, device=dev)
    ao_cfg = IntegratorConfig(type=AO, ray_length=AO_LENGTH)
    for name, spp, seed in ([("independent", AO_REF_SPP, AO_REF_SEED)]
                            + [(n, AO_SPP, k)
                               for n in ("independent", "ldsampler")
                               for k in range(AO_SEEDS)]):
        # per sample a camera query (K1) and a shadow query (K2)
        out[f"ao cornell {name} {spp} spp seed {seed}"] = (
            scene, static, small, ao_cfg,
            api.RenderSettings(width=AO_RES, height=AO_RES, spp=spp,
                               spp_per_pass=16, filter_type=0,
                               sampler_type=SAMPLER_TYPES[name], seed=seed),
            k12(spp))
    for name, field in (("position", FIELD_POSITION),
                        ("albedo", FIELD_ALBEDO)):
        out[f"field cornell {name}"] = (
            scene, static, sensor, IntegratorConfig(type=FIELD, field=field),
            api.RenderSettings(width=FIELD_RES, height=FIELD_RES,
                               spp=FIELD_SPP, filter_type=0, seed=SEED),
            {"brute_force_interaction": FIELD_SPP})
    return out


def gallery_xml(bsdf, sphere_glass=False, block_y=GALLERY_BLOCK_Y,
                eye_shift=0.0):
    """scenes/cbox.xml's text with ``bsdf`` (a BSDF element with the id
    "gallery") declared at the top level, the glass sphere's inline BSDF
    replaced by a reference to it (unless ``sphere_glass``), and
    GALLERY_BLOCK added at height ``block_y`` (scripts/jax_header_ref_mean.py
    renders the same text; the bump map's file needs write_height_pfm beside
    it). ``eye_shift`` moves the camera along x by that many scene units
    (the rounding check of PERF.md section 6)."""
    text = CBOX_XML.read_text()
    eye = 'origin="{x}, 273, -800" target="{x}, 273, -799"'
    glass = ('<bsdf type="dielectric">\n            <string name="intIOR" '
             'value="bk7"/>\n        </bsdf>')
    sphere = glass if sphere_glass else '<ref id="gallery"/>'
    for old, new in ((eye.format(x=278), eye.format(x=278 + eye_shift)),
                     (glass, sphere),
                     ("<!-- floor -->", f"{bsdf}\n    <!-- floor -->"),
                     ("<!-- glass sphere -->",
                      GALLERY_BLOCK.format(y=block_y)
                      + "\n    <!-- glass sphere -->")):
        if text.count(old) != 1:
            raise AssertionError(f"cbox.xml has no single {old!r}")
        text = text.replace(old, new)
    return text


def gallery_renders(dev, tmp, gallery, **xml):
    """Every render of ``gallery`` (a Gallery), by label (``{kind}
    {variant}``): (scene, static, sensor, cfg, settings, expected launches),
    loaded from ``{tmp}/{kind}_{variant}.xml`` with -D spp={spp} -D res=256,
    HEIGHT_PFM written beside them; ``xml`` goes to gallery_xml.
    scripts/torch_header_stats.py renders the same."""
    out = {}
    write_height_pfm(Path(tmp) / HEIGHT_PFM)
    for variant in gallery.bsdfs:
        path = Path(tmp) / f"{gallery.kind}_{variant.replace(' ', '_')}.xml"
        path.write_text(gallery.xml(variant, **xml))
        ls = mitsuba_xml.load_scene(
            str(path), {"spp": gallery.spp, "res": CBOX_RES}, device=dev)
        # a closest-hit (K1) and a shadow query (K2) per bounce and sample
        n = DEPTH * gallery.spp
        out[f"{gallery.kind} {variant}"] = (
            ls.scene, ls.static, ls.sensor, ls.integrator, ls.settings,
            {"brute_force_interaction": n, "brute_force_closest_hit": n})
    return out


def gallery_phase(dev, gallery):
    """A gallery's BSDFs on the card (9f: the nine single-layer ones; 9g:
    the nested and layered ones and the maps): each render of
    gallery_renders held to the JAX package's mean and tv_rgb within
    HEADER_MEAN_RTOL and HEADER_TV_RTOL and to its exact K1/K2 launches, and
    the CLI on the gallery's CLI variant, whose EXR must equal its image."""
    cli = f"{gallery.kind} {gallery.cli}"
    with tempfile.TemporaryDirectory() as tmp:
        cases = gallery_renders(dev, tmp, gallery)
        for label, case in cases.items():
            log(f"{label}: {case[1]}")
        # warm-up: one sample of each (first-call set-up of the new lobes)
        for scene, static, sensor, cfg, settings, _ in cases.values():
            api.render(scene, static, sensor, cfg, dataclasses.replace(
                settings, spp=1, spp_per_pass=1), device=dev)
        imgs = {label: header_render(dev, label, *case)
                for label, case in cases.items()}
        cli_matches(cli, Path(tmp) / f"{cli.replace(' ', '_')}.xml",
                    {"spp": gallery.spp, "res": CBOX_RES}, imgs[cli])


def lights_renders(dev, tmp):
    """Every render of phase 9h, by label (``lights {variant}``): (scene,
    static, sensor, cfg, settings, expected launches), loaded from
    ``{tmp}/lights_{variant}.xml`` with LIGHTS_DEFINES.
    scripts/torch_header_stats.py renders the same."""
    out = {}
    for variant in LIGHTS_VARIANTS:
        path = Path(tmp) / f"lights_{variant.replace(' ', '_')}.xml"
        path.write_text(lights_xml(variant))
        ls = mitsuba_xml.load_scene(str(path), LIGHTS_DEFINES, device=dev)
        spp = ls.settings.spp
        if variant in LIGHTS_METERS:
            # render_meter: per chunk of lanes, a closest hit and a shadow
            # query per bounce
            k1 = k2 = DEPTH * -(-spp // api.METER_CHUNK)
        elif ls.integrator.type == DIRECT:
            # the camera and the BSDF ray; a shadow ray per emitter sample
            k1 = (1 + ls.integrator.bsdf_samples) * spp
            k2 = ls.integrator.emitter_samples * spp
        else:
            k1 = k2 = DEPTH * spp
        out[f"lights {variant}"] = (
            ls.scene, ls.static, ls.sensor, ls.integrator, ls.settings,
            {"brute_force_interaction": k1, "brute_force_closest_hit": k2})
    return out


def meter_render(dev, label, scene, static, sensor, cfg, settings,
                 expected):
    """timed_render of a meter (api.render -> render_meter) held to
    METER_REF[label] within METER_RTOL per channel. Returns the value."""
    img = timed_render(dev, label, scene, static, sensor, cfg, settings,
                       METER_REF[label], METER_RTOL, expected)[0]
    return img[0, 0].tolist()


# sample_ray of every sensor type on the card against the CPU, on
# SENSOR_DRAWS film and aperture draws (the CPU's own gaps to the JAX
# package: tests/test_torch_lights.py): origins and directions within
# SENSOR_ATOL in a box of size 1, the irradiance meter's directions from
# its disk's rim within SENSOR_RIM_ATOL (z = sqrt(1 - x^2 - y^2) cancels)
SENSOR_DRAWS = 65536
SENSOR_ATOL, SENSOR_RIM_ATOL = 1e-5, 1e-3


def all_sensors(dev):
    """One sensor of each of the nine types, with non-default parameters
    (the port's constructors on ``dev``), framing a unit box."""
    cam = Transform.look_at([0.4, 0.6, -1.2], [0.5, 0.45, 0.5], [0, 1, 0])
    ortho = cam * Transform.scale([0.6, 0.6, 1.0])
    S = sensor_mod
    return [
        S.make_perspective(cam, 40.0, 24, 16, device=dev),
        S.make_thinlens(cam, 40.0, 24, 16, 0.05, 1.4, device=dev),
        S.make_orthographic(ortho, 24, 16, device=dev),
        S.make_spherical(cam, device=dev),
        S.make_radiancemeter([0.3, 0.2, 0.1], [0.2, 0.5, 1.0], device=dev),
        S.make_irradiancemeter([0.5, 0.01, 0.5], [0.0, 1.0, 0.1], 0.03,
                               device=dev),
        S.make_telecentric(ortho, 24, 16, 0.04, 0.9, device=dev),
        S.make_perspective_rdist(cam, 40.0, 24, 16, kc=(0.12, -0.05),
                                 device=dev),
        S.make_fluencemeter([0.5, 0.5, 0.5], device=dev),
    ]


def sensor_rays_phase(dev):
    """sample_ray of each sensor type on the card and on the CPU, on the
    same SENSOR_DRAWS draws (the film's corners and the poles among them):
    prints the largest gaps and raises past SENSOR_ATOL."""
    g = torch.Generator().manual_seed(SEED)
    uv = torch.rand((SENSOR_DRAWS, 2), generator=g)
    u_ap = torch.rand((SENSOR_DRAWS, 2), generator=g)
    uv[:6] = torch.tensor([[0.5, 0.0], [0.3, 0.0], [0.5, 1.0 - 2 ** -24],
                           [0.0, 0.0], [0.0, 0.5], [1.0 - 2 ** -24, 0.5]])
    rim = (2.0 * uv - 1.0).abs().amax(dim=1) > 1.0 - 1e-6
    for sc, sd in zip(all_sensors("cpu"), all_sensors(dev)):
        o_c, d_c = sensor_mod.sample_ray(sc, uv, u_ap)
        o_d, d_d = sensor_mod.sample_ray(sd, uv.to(dev), u_ap.to(dev))
        torch.cuda.synchronize()
        err_o = (o_d.cpu() - o_c).abs().amax(dim=1)
        err_d = (d_d.cpu() - d_c).abs().amax(dim=1)
        lim = torch.full_like(err_d, SENSOR_ATOL)
        if sc.type == sensor_mod.IRRADIANCEMETER:
            lim[rim] = SENSOR_RIM_ATOL
        log(f"sample_ray type {sc.type}: {SENSOR_DRAWS} draws, card against "
            f"CPU: origin max abs err {float(err_o.max()):.3g}, direction "
            f"{float(err_d.max()):.3g} (rim lanes "
            f"{float(err_d[rim].max()):.3g}); bit-equal lanes "
            f"{int(((err_o == 0) & (err_d == 0)).sum())}")
        if not (bool((err_o <= SENSOR_ATOL).all())
                and bool((err_d <= lim).all())):
            raise AssertionError(f"sample_ray type {sc.type}: the card "
                                 "differs from the CPU past SENSOR_ATOL")


def lights_phase(dev):
    """Phase 9h: each camera and light render of lights_renders held as
    phase 9f's (mean and tv_rgb to the JAX package, exact K1/K2 launches),
    each meter to METER_REF with its launches, sample_ray of every sensor
    type against the CPU, and the CLI on the "all" file, whose EXR must
    equal its image."""
    with tempfile.TemporaryDirectory() as tmp:
        cases = lights_renders(dev, tmp)
        for label, case in cases.items():
            log(f"{label}: sensor type {case[2].type}, {case[1]}")
        # warm-up: one sample of each camera render (a meter's chunk is
        # its own warm-up)
        for label, (scene, static, sensor, cfg, settings, _) in cases.items():
            if label not in METER_REF:
                api.render(scene, static, sensor, cfg, dataclasses.replace(
                    settings, spp=1, spp_per_pass=1), device=dev)
        imgs = {}
        for label, case in cases.items():
            if label in METER_REF:
                log(f"render {label} value {meter_render(dev, label, *case)}")
            else:
                imgs[label] = header_render(dev, label, *case)
        sensor_rays_phase(dev)
        cli = f"lights {LIGHTS_CLI}"
        cli_matches(cli, Path(tmp) / f"lights_{LIGHTS_CLI}.xml",
                    LIGHTS_DEFINES, imgs[cli])


def cloth_renders(dev, tmp):
    """Every cloth render of phase 9i, by label (``cloth {variant}``):
    (scene, static, sensor, cfg, settings, expected launches), loaded from
    ``{tmp}/cloth_{variant}.xml`` with CLOTH_DEFINES, CLOTH_FILE written
    beside them. scripts/torch_header_stats.py renders the same."""
    write_cloth(tmp)
    out = {}
    for variant in CLOTH_BSDFS:
        path = Path(tmp) / f"cloth_{variant.replace(' ', '_')}.xml"
        path.write_text(cloth_xml(variant))
        ls = mitsuba_xml.load_scene(str(path), CLOTH_DEFINES, device=dev)
        # a closest-hit (K1) and a shadow query (K2) per bounce and sample
        n = CLOTH_DEPTH * ls.settings.spp
        out[f"cloth {variant}"] = (
            ls.scene, ls.static, ls.sensor, ls.integrator, ls.settings,
            {"brute_force_interaction": n, "brute_force_closest_hit": n})
    return out


def spectral_renders(dev):
    """The spectral renders of phase 9i, by label (``spectral cauchy_b
    {B}``): (scene, static, sensor, cfg, settings, expected launches) of
    spectral_scene built by the port's builder, for api.render_spectral.
    scripts/torch_header_stats.py renders the same."""
    sensor = sensor_mod.make_perspective(
        Transform.look_at(SPECTRAL_EYE, SPECTRAL_AT, UP), SPECTRAL_FOV,
        SPECTRAL_RES, SPECTRAL_RES, device=dev)
    cfg = IntegratorConfig(type=PATH, max_depth=SPECTRAL_DEPTH)
    settings = api.RenderSettings(width=SPECTRAL_RES, height=SPECTRAL_RES,
                                  spp=SPECTRAL_SPP, seed=SEED)
    n = SPECTRAL_DEPTH * SPECTRAL_SPP
    out = {}
    for b in SPECTRAL_CAUCHY:
        scene, static = spectral_scene(SceneBuilder(), bsdf_mod, shapes,
                                       Transform, b).build(device=dev)
        out[f"spectral cauchy_b {b}"] = (
            scene, static, sensor, cfg, settings,
            {"brute_force_interaction": n, "brute_force_closest_hit": n})
    return out


def cloth_spectra_phase(dev):
    """Phase 9i: each cloth render (load_scene + api.render) and each
    spectral render (api.render_spectral) held as phase 9f's renders (mean
    and tv_rgb to the JAX package, exact K1/K2 launches); the multichannel
    file through load_scene and api.render_multichannel, whose image must
    equal the plain cloth's bit for bit; and the CLI on the .cloth file's
    scene, whose EXR must equal its image."""
    with tempfile.TemporaryDirectory() as tmp:
        cases = cloth_renders(dev, tmp)
        cases.update(spectral_renders(dev))
        for label, case in cases.items():
            log(f"{label}: {case[1]}")
        # warm-up: one sample of each (first-call set-up of the new lobes)
        for label, (scene, static, sensor, cfg, settings, _) in cases.items():
            render_fn(label)(scene, static, sensor, cfg, dataclasses.replace(
                settings, spp=1, spp_per_pass=1), device=dev)
        imgs = {label: header_render(dev, label, *case)
                for label, case in cases.items()}

        path = Path(tmp) / "cloth_multichannel.xml"
        path.write_text(cloth_xml("plain", CLOTH_MULTICHANNEL))
        ls = mitsuba_xml.load_scene(str(path), CLOTH_DEFINES, device=dev)
        plain = cases["cloth plain"]
        if ls.integrator != plain[3]:
            raise AssertionError(f"multichannel: integrator {ls.integrator}, "
                                 f"expected its nested {plain[3]}")
        _zero_counts()
        img = api.render_multichannel(ls.scene, ls.static, ls.sensor,
                                      [ls.integrator], ls.settings,
                                      device=dev)
        _check_launches("render cloth multichannel", plain[5])
        same = torch.equal(img, imgs["cloth plain"])
        log(f"render cloth multichannel: image {tuple(img.shape)} equal to "
            f"the nested path tracer's (cloth plain) bit for bit: {same}")
        if not same:
            raise AssertionError("multichannel: the image differs from its "
                                 "nested integrator's")
        cli = f"cloth {CLOTH_CLI}"
        cli_file = f"cloth_{CLOTH_CLI.replace(' ', '_')}.xml"
        cli_matches(cli, Path(tmp) / cli_file, CLOTH_DEFINES, imgs[cli])


def bunny_ao_case(bunny_scene):
    """ao on bunny_x2 (lane mode) at 512x512, BUNNY_AO_SPP spp, the default
    ray length (half the scene's radius), box filter: K3 launches only,
    K3_PER_AO_SPP per sample; as header_renders' values."""
    return (*bunny_scene, IntegratorConfig(type=AO),
            api.RenderSettings(width=W, height=H, spp=BUNNY_AO_SPP,
                               filter_type=0, seed=SEED),
            {"lane_chunk": K3_PER_AO_SPP * BUNNY_AO_SPP})


def header_phase(dev, cornell_scene):
    """The scene file's sensor header on the card: header_renders, each
    held to the JAX package's statistics and its exact K1/K2 launches, the
    CLI on the ldsampler + Mitchell file, and the ao variance check."""
    ld = "cbox.xml ldsampler mitchell"
    with tempfile.TemporaryDirectory() as tmp:
        cases = header_renders(dev, tmp, cornell_scene)
        log(f"{ld}: {cases[ld][4]}; {cases[ld][3]}")
        # warm-up: one sample (first-call set-up of the samplers' kernels)
        scene, static, sensor, cfg, settings, _ = cases[ld]
        api.render(scene, static, sensor, cfg, dataclasses.replace(
            settings, spp=1, spp_per_pass=1), device=dev)
        imgs = {label: header_render(dev, label, *case)
                for label, case in cases.items()}
        cli_matches(ld, Path(tmp) / "ldsampler_mitchell.xml",
                    {"spp": CBOX_SPP, "res": CBOX_RES}, imgs[ld])

    ref = imgs[f"ao cornell independent {AO_REF_SPP} spp seed {AO_REF_SEED}"]
    mse = {name: float(np.mean([
        ((imgs[f"ao cornell {name} {AO_SPP} spp seed {k}"] - ref) ** 2)
        .mean().item() for k in range(AO_SEEDS)]))
        for name in ("independent", "ldsampler")}
    ratio = mse["ldsampler"] / mse["independent"]
    log(f"ao cornell variance: mean squared error against the "
        f"{AO_REF_SPP}-spp render at {AO_SPP} spp over seeds 0-"
        f"{AO_SEEDS - 1}: independent {mse['independent']}, ldsampler "
        f"{mse['ldsampler']}, ratio {ratio} (must be below {AO_LD_GAIN})")
    if not ratio < AO_LD_GAIN:
        raise AssertionError(f"ao cornell: the ldsampler's error is {ratio} "
                             f"of the independent sampler's")


def bunny_ao_phase(dev, bunny_scene):
    """bunny_ao_case held to the JAX package's statistics and launches."""
    header_render(dev, "ao bunny_x2", *bunny_ao_case(bunny_scene))


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


def profile_phase(dev, label, scene, static, sensor, spp, cfg=None, size=W,
                  filter_type=api.RenderSettings.filter_type):
    """Device time by kernel over one render pass of ``spp`` samples at
    ``size`` x ``size`` (torch.profiler), through ``cfg`` (the path tracer at
    depth 5 by default). Returns {kernel: (ms, launches)} of the port's
    kernels that ran (empty if the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg or IntegratorConfig(type=PATH, max_depth=DEPTH)
    settings = api.RenderSettings(width=size, height=size, spp=spp,
                                  spp_per_pass=spp, seed=SEED,
                                  filter_type=filter_type)
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
    log(f"profile   {sum(calls_of.values())} device kernel launches in the "
        f"pass")
    per_kernel = {}
    for kernel in ("interaction_kernel", "closest_hit_kernel",
                   "lane_packed_kernel", "lane_chunk_kernel",
                   "treelet_rounds_kernel"):
        # a template's name carries its arguments: kernel<false>(...)
        hits = [k for k in dev_us if re.search(rf"::{kernel}[<(]", k)]
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
    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    with phase("2 build"):
        logs = build.build_all()
        log(f"build: {len(logs)} sources compiled")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"build {name}: {line.strip()}")

    with phase("3 brute-force kernels"):
        records = kernel_phase(dev)
    with phase("4-7 BVH kernels"):
        records.update(bvh_kernel_phase(dev))
    with phase("8 large tier"):
        large, large_launches = large_tier_phase(dev)
        records.update(large)

    with phase("9 render"):
        cornell_scene = cornell(dev)
        launches, _, _ = render_phase(
            dev, "cornell", *cornell_scene, EYE, AT, FOV, SPP, SPP_PER_PASS,
            REF_MEAN_RGB, MEAN_RTOL,
            {"brute_force_interaction": DEPTH * SPP,
             "brute_force_closest_hit": DEPTH * SPP})
        live_share_phase(dev, *cornell_scene)
    with phase("9b training"):
        trainer = train_phase(dev)
    with phase("9c scene files"):
        cbox_xml, cornell_direct = scene_file_phase(dev)
    with phase("9d veach"):
        veach = veach_phase(dev)
    with phase("9e sampler bits"):
        sampler_bits_phase(dev)
    with phase("9e sensor header"):
        header_phase(dev, cornell_scene)
    with phase("9f material gallery"):
        gallery_phase(dev, MATERIAL_GALLERY)
    with phase("9g layered gallery"):
        gallery_phase(dev, LAYERED_GALLERY)
    with phase("9h lights and cameras"):
        lights_phase(dev)
    with phase("9i cloth and spectra"):
        cloth_spectra_phase(dev)
    with phase("10 bunny"):
        bunny_scene = bunny(dev)
        bunny_launches, lane_mean, lane_ms = render_phase(
            dev, "bunny", *bunny_scene, BUNNY_EYE, BUNNY_AT, BUNNY_FOV,
            BUNNY_SPP, BUNNY_SPP_PER_PASS, BUNNY_REF_MEAN_RGB,
            BUNNY_MEAN_RTOL,
            {"bvh_traverse_lane_packed": BUNNY_SPP,
             "lane_chunk": K3_PER_SPP * BUNNY_SPP})
    with phase("11 treelet render"):
        with bvh_kernel("treelet"):
            treelet_launches, tl_mean, tl_ms = render_phase(
                dev, "bunny treelet", *bunny_scene, BUNNY_EYE, BUNNY_AT,
                BUNNY_FOV, BUNNY_SPP, BUNNY_SPP_PER_PASS, BUNNY_REF_MEAN_RGB,
                BUNNY_MEAN_RTOL, {"treelet_rounds": K7_PER_SPP * BUNNY_SPP})
        log(f"render bunny treelet vs lane: {tl_ms:.3f} against "
            f"{lane_ms:.3f} ms/spp; mean_rgb difference "
            f"{[a - b for a, b in zip(tl_mean, lane_mean)]}")
        for label, mean in (("lane", lane_mean), ("treelet", tl_mean)):
            log(f"render bunny {label}: mean_rgb difference from the "
                "canonical-table walk's "
                f"{[a - b for a, b in zip(mean, PR3_BUNNY_MEAN_RGB)]}")
        records["treelet_rounds"]["launches"] = \
            treelet_launches["treelet_rounds"]
    with phase("9e ao bunny_x2"):
        bunny_ao_phase(dev, bunny_scene)
    with phase("12 kdbench"):
        kdbench_phase()
    # each kernel's count from the run of the path that drives it
    for name in ("brute_force_interaction", "brute_force_closest_hit"):
        records[name]["launches"] = launches[name]
    for name in ("bvh_traverse_lane_packed", "lane_chunk"):
        records[name]["launches"] = bunny_launches[name]
    for name in ("lane_hbm", "lane_chunk_hbm"):
        records[name]["launches"] = large_launches[name]
    with phase("13 profile"):
        profile_phase(dev, "cornell", *cornell_scene, SPP_PER_PASS)
        profile_phase(dev, "cbox.xml", *cbox_xml[:3], 4, cfg=cbox_xml[3],
                      size=CBOX_RES)
        profile_phase(dev, "cornell direct", *cornell_direct[:3], 4,
                      cfg=cornell_direct[3], size=DIRECT_RES)
        profile_phase(dev, "veach_mis", *veach[:3], VEACH_SPP_PER_PASS,
                      cfg=veach[3], filter_type=0)
        train_profile(trainer)
        del trainer
        bunny_profile = profile_phase(dev, "bunny", *bunny_scene,
                                      BUNNY_SPP_PER_PASS)
        k4 = records["bvh_traverse_lane_packed"]
        ms, n = bunny_profile.get("lane_packed_kernel", (None, 0))
        log(f"K4 render mean {'not measured' if not n else f'{ms / n:.5f}'} "
            f"ms per launch; on sample 0's camera rays {k4['warm_ms']:.5f} ms "
            f"back to back, {k4['cold_ms']:.5f} ms with the L2 flushed before "
            f"each launch (phase 4)")
        with bvh_kernel("treelet"):
            profile_phase(dev, "bunny treelet", *bunny_scene,
                          BUNNY_SPP_PER_PASS)

    log("phase times (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; total {time.perf_counter() - t_start:.1f}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
