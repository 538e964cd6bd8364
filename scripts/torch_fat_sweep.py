"""Time K8 of the PyTorch/CUDA port under several launch bounds, and against
another tree's K8, on the bunny scene of chip_smoke.py, on one CUDA card.

    python scripts/torch_fat_sweep.py [OTHER_ROOT]

Each design builds mitsuba_tpu_torch/csrc/bvh_lane.cu with its -D value of
K8_MIN_BLOCKS (the __launch_bounds__ minimum of resident blocks per SM), all
builds at once, then runs in a process of its own (a process loads one
build of the library): it prints ptxas's spills and the registers and
resident blocks per SM of K8's instantiations, and times K8 on a leaf-4 tree
of the scene's triangles (chip_smoke.py's phase 6), each case held bit for
bit against its plain version first:

  * camera rays of sample 0, closest hit and any-hit;
  * the first bounce's rays sorted as bvh_traverse sorts them, closest hit
    and any-hit;
  * the sorted bounce rays bounded to per-ray [start, end) ranges of the
    tree's treelets (closest hit);
  * this tree only: closest hit on the canonical heads (the bounded
    instantiation over [0, N)), on the camera and the sorted bounce rays,
    which isolates the split layout from the near-first order.

Each case runs in turns with K3 (one unbounded closest-hit launch on the
sorted bounce rays over the scene's leaf-1 tree, the same code in every
design and tree), so that a drift of the card between turns shows. The
source's default design runs first and last. OTHER_ROOT is the root of
another checkout (a git archive of the parent commit, say): its package and
its bvh_lane.cu run first and last, through its own wrappers (which take
the fat rows where this tree's take ``fat_tables``). The last line is a JSON
summary of every turn.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = (
    ("default", {}),
    ("min8", {"K8_MIN_BLOCKS": 8}),
    ("min10", {"K8_MIN_BLOCKS": 10}),
    ("min12", {"K8_MIN_BLOCKS": 12}),
    ("default", {}),
)
REPS = 20


def _chip_smoke():
    """This tree's chip_smoke.py as a module, over whichever package comes
    first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _import(src_root, defines):
    """The package of ``src_root`` with ``defines`` added to its nvcc flags:
    (chip_smoke, build, cuda_bvh)."""
    sys.path.insert(0, str(src_root))
    from mitsuba_tpu_torch.ops import build
    from mitsuba_tpu_torch.ops import cuda_bvh as cb

    build.NVCC_FLAGS = build.NVCC_FLAGS + tuple(
        f"-D{k}={v}" for k, v in defines.items())
    return _chip_smoke(), build, cb


def build_design(label, src_root, defines):
    """Build the design's library; print ptxas's spills."""
    _, build, _ = _import(src_root, defines)
    logs = build.build_all(("bvh_lane",))
    for line in logs.get("bvh_lane", "").splitlines():
        if "spill" in line and not line.strip().startswith("0 bytes"):
            print(f"  ptxas {label}: {line.strip()}", flush=True)


def run_design(label, src_root, defines):
    import torch

    cs, _, cb = _import(src_root, defines)
    dev = torch.device("cuda")
    res = {"label": label, "source": str(src_root), "defines": defines}
    split = hasattr(cb, "fat_tables")
    for kind in ("", " any_hit", " bounded", " any_hit bounded"):
        name = "bvh_traverse_packed" + kind
        try:
            regs, blocks = cb.kernel_occupancy(name)
        except ValueError:      # an older tree: no such instantiation
            continue
        res[f"{name}/regs"], res[f"{name}/blocks"] = regs, blocks
        print(f"  {name}: {regs} registers, {blocks} blocks of 128 per SM")
    scene, static, sensor = cs.bunny(dev)
    N, nodes, octants = static.n_bvh_nodes, scene.nodes, scene.octants
    lo, hi = scene.aabb_lo, scene.aabb_hi
    cam = cs.camera_rays(sensor, dev)
    bounce, _ = cs.first_bounce_rays(scene, static, cam[0], cam[1])
    (*srt, tmx), _ = cb.sort_rays(*bounce, lo, hi)
    rays = tuple(srt)
    root = cs._root_state(N, rays, tmx)
    b_sorted = (torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1),
                rays[6], tmx)

    # the leaf-4 tree and its treelet ranges, as chip_smoke.py builds them
    tris, box = cs.scene_tris(scene)
    bvh4 = cs.build_bvh(*box, leaf_size=cb.FAT_LEAF_SIZE)
    fat = torch.as_tensor(cb.pack_nodes_fat(bvh4, *tris), device=dev)
    N4 = fat.shape[0]
    table = cb.fat_tables(fat) if split else fat
    plain = cb.bvh_traverse_packed_plain
    roots = cs.treelet_roots(bvh4, max_nodes=cs.scene_mod.TREELET_MAX_NODES)
    r_root, r_skip, r_lo, r_hi = (torch.as_tensor(x, device=dev) for x in (
        roots.astype("int32"), bvh4.skip[roots].astype("int32"),
        bvh4.lo[roots], bvh4.hi[roots]))
    sel = cb.nearest_treelet(*b_sorted, r_lo, r_hi)
    ranges = (r_root[sel].contiguous(), r_skip[sel].contiguous())
    R = tmx.shape[0]
    whole = (torch.zeros(R, dtype=torch.int32, device=dev),
             torch.full((R,), N4, dtype=torch.int32, device=dev))

    def k3():
        return cb.lane_chunk(nodes, N, *rays, *root, octants=octants)

    cases = [("camera closest", cam, (None, None), False),
             ("camera any-hit", cam, (None, None), True),
             ("bounce closest", b_sorted, (None, None), False),
             ("bounce any-hit", b_sorted, (None, None), True),
             ("bounce [start, end)", b_sorted, ranges, False)]
    if split:
        cases += [("camera closest, canonical heads", cam, whole, False),
                  ("bounce closest, canonical heads", b_sorted, whole, False)]
    for case, r, rng, any_hit in cases:
        def k8(r=r, rng=rng, any_hit=any_hit):
            return cb.bvh_traverse_packed(table, *r, *rng, any_hit=any_hit)
        out = k8()
        torch.cuda.synchronize()
        cs.compare(f"{label}/{case}", out, plain(table, *r, *rng,
                                                 any_hit=any_hit),
                   n_exact=1, ulp_limit=0)
        t = [cs.cuda_ms(f, reps=REPS) for f in (k3, k8, k8, k3)]
        res[case] = t
        print(f"  {case}: K3 {t[0]:.4f}, K8 {t[1]:.4f}, {t[2]:.4f}, "
              f"K3 {t[3]:.4f} ms", flush=True)
    print(f"  {label}: K8 equals its plain version bit for bit in every case")
    print("RESULT " + json.dumps(res), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] in ("--design", "--build"):
        defines = {}
        for kv in filter(None, sys.argv[4].split(",")):
            k, v = kv.split("=")
            defines[k] = int(v)
        if sys.argv[1] == "--build":
            build_design(sys.argv[2], sys.argv[3], defines)
        else:
            run_design(sys.argv[2], sys.argv[3], defines)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_fat_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    turns = [(label, ROOT, d) for label, d in DESIGNS]
    if len(sys.argv) > 1:
        other = Path(sys.argv[1]).resolve()
        turns = [("other", other, {})] + turns + [("other", other, {})]

    def argv(mode, label, src, defines):
        return [sys.executable, __file__, mode, label, str(src),
                ",".join(f"{k}={v}" for k, v in defines.items())]
    # every distinct build at once, one nvcc each
    builds = {(str(src), tuple(sorted(d.items()))): (label, src, d)
              for label, src, d in turns}
    procs = [subprocess.Popen(argv("--build", *b)) for b in builds.values()]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a build failed")
    results = []
    for label, src, defines in turns:
        print(f"== {label} {src} {defines}", flush=True)
        proc = subprocess.run(argv("--design", label, src, defines),
                              stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"design {label} failed: rc {proc.returncode}")
        results += [json.loads(line[7:]) for line in proc.stdout.splitlines()
                    if line.startswith("RESULT ")]
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
