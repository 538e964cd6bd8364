#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mitsuba_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA source of the port with nvcc (sm_90a), all at once;
  3. kernels: hold K1 (brute_force_interaction) and K2
     (brute_force_closest_hit) against their plain PyTorch versions on the
     card -- on the 262,144 camera rays of the 512x512 Cornell view (the
     render's shapes) and on 262,144 random rays against a random
     4096-triangle soup (the kernels' full contract, which exercises the
     shared-memory tiling) -- and time kernel and plain version;
  4. render: mitsuba_tpu_torch.render.api.render of the Cornell box at
     512x512, depth 5, 36 spp in passes of 4, seed 0 (bench.py's Cornell
     layout), with every launch count set to 0 just before and read just
     after; checks 180 launches of each kernel and the image mean against
     the JAX package's value;
  5. profile: one 4-spp render pass under torch.profiler, printing the
     device's busy share of the wall time and the kernels that take it.

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

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.ops import build
from mitsuba_tpu_torch.ops import cuda_intersect as bf
from mitsuba_tpu_torch.render import api, shapes
from mitsuba_tpu_torch.render import sensor as sensor_mod
from mitsuba_tpu_torch.render.integrators.common import PATH, IntegratorConfig
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
}


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


def compare(name, out, ref, n_exact):
    """Max |kernel - plain| over the float outputs and the largest ulp gap;
    the first n_exact outputs and every integer or bool output must be
    equal. Raises on any disagreement past 1 ulp."""
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
    if max_ulp > 1:
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


def render_phase(dev):
    """The port's main path: api.render of the Cornell box, bench layout."""
    scene, static, sensor = cornell(dev)
    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    # warm-up at a small size (first-call set-up of the CUDA libraries)
    small = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                        64, 64, device=dev)
    api.render(scene, static, small, cfg,
               api.RenderSettings(width=64, height=64, spp=1, spp_per_pass=1),
               device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    settings = api.RenderSettings(width=W, height=H, spp=SPP,
                                  spp_per_pass=SPP_PER_PASS, seed=SEED)
    bf.brute_force_interaction.launches = 0
    bf.brute_force_closest_hit.launches = 0
    t0 = time.perf_counter()
    img, n_rays = api.render(scene, static, sensor, cfg, settings, device=dev,
                             with_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"brute_force_interaction": bf.brute_force_interaction.launches,
                "brute_force_closest_hit": bf.brute_force_closest_hit.launches}

    if tuple(img.shape) != (H, W, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels")
    mean = img.mean(dim=(0, 1)).tolist()
    log(f"render cornell {W}x{H} depth {DEPTH} spp {SPP} (passes of "
        f"{SPP_PER_PASS}), seed {SEED}: {dt:.3f} s")
    log(f"render mean_rgb {mean} (reference {list(REF_MEAN_RGB)})")
    log(f"render rays {n_rays}, {n_rays / dt:.1f} rays/s, "
        f"{dt / SPP * 1e3:.3f} ms/spp")
    log(f"render max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"render launches {launches}")
    for name, n in launches.items():
        if n != DEPTH * SPP:
            raise AssertionError(f"{name}: {n} launches, expected {DEPTH * SPP}")
    for c, (a, b) in enumerate(zip(mean, REF_MEAN_RGB)):
        if abs(a - b) > MEAN_RTOL * b:
            raise AssertionError(
                f"mean_rgb[{c}] = {a:.6f}, reference {b} (tolerance {MEAN_RTOL:.1%})")
    return launches


def profile_phase(dev):
    """Device time by kernel over one 4-spp render pass (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene, static, sensor = cornell(dev)
    cfg = IntegratorConfig(type=PATH, max_depth=DEPTH)
    settings = api.RenderSettings(width=W, height=H, spp=SPP_PER_PASS,
                                  spp_per_pass=SPP_PER_PASS, seed=SEED)
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
    log(f"profile one {SPP_PER_PASS}-spp pass: wall {wall * 1e3:.3f} ms, device "
        f"busy {busy * 1e3:.3f} ms ({'not measured' if not dev_us else f'{busy / wall:.1%}'})")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    for k, us in top:
        log(f"profile   {us / 1e3:9.3f} ms  {k[:90]}")
    for kernel in ("interaction_kernel", "closest_hit_kernel"):
        us = sum(v for k, v in dev_us.items() if f"::{kernel}(" in k)
        took = f"{us / 1e3:.3f} ms" if dev_us else "not measured"
        log(f"profile   {kernel}: {took} in {DEPTH * SPP_PER_PASS} launches")
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
    launches = render_phase(dev)
    for name, n in launches.items():
        records[name]["launches"] = n
    profile_phase(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
