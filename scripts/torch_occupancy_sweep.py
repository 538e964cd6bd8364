"""Time K3 and K7 of the PyTorch/CUDA port under several __launch_bounds__
minimums of resident blocks per SM, on one CUDA card.

    python scripts/torch_occupancy_sweep.py

Each variant builds mitsuba_tpu_torch/csrc/bvh_lane.cu with
-DK3_MIN_BLOCKS=a -DK7_MIN_BLOCKS=b in a process of its own (a process loads
one build of the library) and prints ptxas's registers and spills, each
kernel's registers and resident blocks per SM, and the device time of one
unbounded launch on the bunny_x2 scene of chip_smoke.py: K3 (closest hit,
octant tables) on the sorted bounce rays, K7 on the camera rays and the
bounce and shadow rays sorted as its query sorts them. Each result is held
against K4's canonical walk (closest hit and t) or K3's (shadow hits).
Variants run in turns, the default first and last.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ((1, 1), (12, 10), (16, 12), (16, 16), (1, 1))


def run_variant(k3_min, k7_min):
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from mitsuba_tpu_torch.ops import build
    from mitsuba_tpu_torch.ops import cuda_bvh as cb

    build.NVCC_FLAGS = build.NVCC_FLAGS + (f"-DK3_MIN_BLOCKS={k3_min}",
                                           f"-DK7_MIN_BLOCKS={k7_min}")
    logs = build.build_all(("bvh_lane",))
    for line in logs.get("bvh_lane", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda")
    for name in ("lane_chunk", "treelet_rounds"):
        regs, blocks = cb.kernel_occupancy(name)
        print(f"  {name}: {regs} registers, {blocks} blocks of 128 per SM")
    scene, static, sensor = cs.bunny(dev)
    N, nodes, octants = static.n_bvh_nodes, scene.nodes, scene.octants
    lo, hi = scene.aabb_lo, scene.aabb_hi
    cam = cs.camera_rays(sensor, dev)
    bounce, shadow = cs.first_bounce_rays(scene, static, cam[0], cam[1])
    # K3 as its resort driver hands the rays over: sorted
    (*rays, tmx), _ = cb.sort_rays(*bounce, lo, hi)
    rays = tuple(rays)
    root = cs._root_state(N, rays, tmx)
    o, d = torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1)
    k4 = cb.bvh_traverse_lane_packed(nodes, N, o, d, rays[6], tmx)
    t, idx, *_ = cb.lane_chunk(nodes, N, *rays, *root, octants=octants)
    if not (torch.equal(idx >= 0, k4[0])
            and torch.equal(torch.where(idx >= 0, t, torch.inf), k4[1])):
        raise AssertionError("K3 disagrees with K4")
    ms = cs.cuda_ms(lambda: cb.lane_chunk(nodes, N, *rays, *root,
                                          octants=octants), reps=20)
    print(f"  K3 sorted bounce: {ms:.4f} ms")
    tab = cb.treelet_table(scene.tl_root, scene.tl_skip, scene.tl_lo,
                           scene.tl_hi, octants.tl_range)

    def sorted_rays(o, d, t_min, t_max):
        orig = torch.argsort(cb.treelet_sort_keys(
            o, d, t_min, t_max, scene.tl_lo, scene.tl_hi, lo, hi), stable=True)
        return o[orig], d[orig], t_min[orig], t_max[orig]

    for label, r, any_hit in (("camera", cam, False),
                              ("bounce", sorted_rays(*bounce), False),
                              ("shadow", sorted_rays(*shadow), True)):
        out = cb.treelet_rounds(nodes, tab, *r, any_hit=any_hit,
                                octants=octants)
        ref = cb.bvh_traverse_lane_packed(nodes, N, *r, any_hit=any_hit)
        if not (torch.equal(out[0], ref[0])
                and (any_hit or torch.equal(out[1], ref[1]))):
            raise AssertionError(f"K7 {label} disagrees with K4")
        ms = cs.cuda_ms(lambda: cb.treelet_rounds(
            nodes, tab, *r, any_hit=any_hit, octants=octants), reps=20)
        print(f"  K7 {label}: {ms:.4f} ms")


def main() -> int:
    if len(sys.argv) == 3:
        run_variant(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_occupancy_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for k3_min, k7_min in VARIANTS:
        print(f"K3_MIN_BLOCKS={k3_min} K7_MIN_BLOCKS={k7_min}", flush=True)
        subprocess.run([sys.executable, __file__, str(k3_min), str(k7_min)],
                       check=True, env=dict(os.environ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
