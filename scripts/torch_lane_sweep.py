"""Time K4 and K9 of the PyTorch/CUDA port under several launch bounds, and
against another tree's, on the bunny scene of chip_smoke.py, on one CUDA
card.

    python scripts/torch_lane_sweep.py [OTHER_ROOT]

Each design builds mitsuba_tpu_torch/csrc/bvh_lane.cu with its -D values of
K4_MIN_BLOCKS and K9_MIN_BLOCKS (the __launch_bounds__ minimum of resident
blocks per SM), all builds at once, then runs in a process of its own (a
process loads one build of the library): it prints ptxas's spills and the
registers and resident blocks per SM of K4's and K9's instantiations, and
times, each kernel held bit for bit against its plain version first:

  * K4 on the 262,144 camera rays of sample 0 (the render's bounce 0),
    closest hit and any-hit, and K5's octant walk from the root on the same
    rays, each in turns with K3 (one unbounded closest-hit launch on the
    sorted bounce rays, the same code in every design and tree), and K4
    with the L2 flushed before each launch;
  * K9 on the first bounce's sorted bounce rays over a leaf-1 tree of the
    scene's triangles, one unbounded launch, closest hit and any-hit, each
    in turns with K3 and with K6 (the same walk over node rows, an
    instantiation per query kind, 12 blocks per SM) on the same tree and
    rays; and K9's resort query (bvh_traverse_lane_resort_w) in turns with
    K3's (rounds 2, chunk_nit 16).

The source's default design runs first and last, so that a drift of the
card between turns shows. OTHER_ROOT is the root of another checkout (a git
archive of the parent commit, say): its package and its bvh_lane.cu run
first and last, through its own wrappers (which take ``octants=`` only where
its kernels walk the octant tables). The last line is a JSON summary of
every turn.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = (
    ("default", {}),
    ("min10", {"K4_MIN_BLOCKS": 10, "K9_MIN_BLOCKS": 10}),
    ("min12", {"K4_MIN_BLOCKS": 12, "K9_MIN_BLOCKS": 12}),
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


def _octant_kw(fn, octants):
    """``octants=`` where this tree's ``fn`` takes them."""
    return ({"octants": octants}
            if "octants" in inspect.signature(fn).parameters else {})


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
    from mitsuba_tpu_torch.render import scene as scene_mod
    dev = torch.device("cuda")
    res = {"label": label, "source": str(src_root), "defines": defines}
    for name in ("bvh_traverse_lane_packed", "bvh_traverse_lane_packed any_hit",
                 "lane_chunk_w", "lane_chunk_w any_hit", "lane_chunk"):
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
    # the primary hits through K7, whose code the trees compared here share,
    # so that every design sees the same bounce rays
    scene_mod.BVH_KERNEL = "treelet"
    bounce, _ = cs.first_bounce_rays(scene, static, cam[0], cam[1])
    scene_mod.BVH_KERNEL = "lane"
    (*rays, tmx), _ = cb.sort_rays(*bounce, lo, hi)
    rays = tuple(rays)
    root = cs._root_state(N, rays, tmx)

    def check(case, out, ref, n_exact):
        torch.cuda.synchronize()
        cs.compare(f"{label}/{case}", out, ref, n_exact=n_exact, ulp_limit=0)

    def turns(case, kern, yard, reps=REPS, yard_name="K3"):
        t = [cs.cuda_ms(f, reps=reps) for f in (yard, kern, kern, yard)]
        res[case] = t
        print(f"  {case}: {yard_name} {t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, "
              f"{yard_name} {t[3]:.4f} ms")

    # K4 on the camera rays; K3 on the sorted bounce rays as the yardstick
    def k4(any_hit):
        return lambda: cb.bvh_traverse_lane_packed(nodes, N, *cam,
                                                   any_hit=any_hit)

    def k3():
        return cb.lane_chunk(nodes, N, *rays, *root, octants=octants)

    for any_hit in (False, True):
        check(f"K4 any_hit={any_hit}", k4(any_hit)(),
              cb.bvh_traverse_lane_packed_plain(nodes, N, *cam,
                                                any_hit=any_hit), 1)
    for any_hit in (False, True):
        turns(f"K4 {'any-hit' if any_hit else 'closest'}", k4(any_hit), k3)
    turns("K5 closest (octant walk from the root), camera rays",
          lambda: cb.lane_hbm(nodes, N, *cam, octants=octants), k3)
    flush = torch.empty(cs.FLUSH_BYTES // 4, device=dev)
    res["K4 closest, L2 flushed"] = cs.cold_ms(k4(False), reps=100,
                                               flush=flush)
    print(f"  K4 closest, L2 flushed before each launch: "
          f"{res['K4 closest, L2 flushed']:.4f} ms")

    # K9 on a leaf-1 tree of the same triangles, as chip_smoke builds it
    tris, box = cs.scene_tris(scene)
    bvh = cs.build_bvh(*box)
    N9 = len(bvh.lo)
    pages = torch.as_tensor(cb.pack_pages_w(bvh, *tris), device=dev)
    nodes_np = cb.pack_nodes(bvh, *tris)
    nodes9 = torch.as_tensor(nodes_np, device=dev)
    oct9 = cb.octant_tables(nodes_np, device=dev)
    kw9 = (_octant_kw(cb.lane_chunk_w, cb.wide_octant_pages(oct9))
           if hasattr(cb, "wide_octant_pages") else {})
    root9 = cs._root_state(N9, rays, tmx)

    def k9(any_hit):
        return lambda: cb.lane_chunk_w(pages, N9, *rays, *root9,
                                       any_hit=any_hit,
                                       **({} if any_hit else kw9))

    def k3_9(any_hit):
        return lambda: cb.lane_chunk(nodes9, N9, *rays, *root9,
                                     any_hit=any_hit, octants=oct9)

    for any_hit in (False, True):
        check(f"K9 any_hit={any_hit}", k9(any_hit)(), cb.lane_chunk_w_plain(
            pages, N9, *rays, *root9, any_hit=any_hit,
            **({} if any_hit else kw9)), 0)
    for any_hit in (False, True):
        kind = "any-hit" if any_hit else "closest"
        turns(f"K9 {kind}", k9(any_hit), k3_9(any_hit))
        turns(f"K9 {kind} against K6", k9(any_hit),
              lambda a=any_hit: cb.lane_chunk_hbm(
                  nodes9, N9, *rays, *root9, any_hit=a, octants=oct9),
              yard_name="K6")
    turns("K9 resort query", lambda: cb.bvh_traverse_lane_resort_w(
        pages, N9, *bounce, lo, hi, **kw9),
        lambda: cb.bvh_traverse_lane_resort(
            nodes9, N9, *bounce, lo, hi, rounds=2, chunk_nit=16,
            octants=oct9), reps=10)
    print(f"  {label}: K4 and K9 (closest, any-hit) equal their plain "
          f"versions bit for bit")
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
        print("torch_lane_sweep: CUDA is not available", file=sys.stderr)
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
