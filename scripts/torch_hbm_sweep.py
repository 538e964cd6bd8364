"""Time K5 and K6 of the PyTorch/CUDA port under several launch bounds, and
against another tree's, on the large tier of chip_smoke.py, on one CUDA card.

    python scripts/torch_hbm_sweep.py [OTHER_ROOT]

Each design builds mitsuba_tpu_torch/csrc/bvh_lane.cu with its -D value of
HBM_MIN_BLOCKS (the __launch_bounds__ minimum of resident blocks per SM) in
a process of its own (a process loads one build of the library) and prints
ptxas's spills, the registers and resident blocks per SM of K5's and K6's
closest-hit and any-hit instantiations, and, on the 262,144 sorted rays of
the large tier (2,534,463 nodes): K5 closest hit, K5 any-hit and one
unbounded K6 closest-hit launch, each held bit for bit against its plain
version (K6 also bounded by chip_smoke's budget, then resumed) and timed in
turns with K4, the canonical one-thread-per-ray walk from the root (the
same code in every design of a tree; another tree's K4 may be built
otherwise and time differently); then the tier's sorted K5 query and K6
resort query, twice each, and, where closest-hit K6 walks the octant tables, the resort
query again with its lanes re-sorted by their row in all eight tables
(octant * N + node; the library re-sorts by node alone), held bit for bit
against the library's. The source's default design runs first and last,
so that a drift of the card between turns shows. OTHER_ROOT is the root of another
checkout (a git archive of the parent commit, say): its package and its
bvh_lane.cu run first and last, through its own wrappers (which take
``octants=`` only where its kernels walk the octant tables). The last line is
a JSON summary of every turn.
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
    ("min1", {"HBM_MIN_BLOCKS": 1}),     # the registers the compiler takes
    ("min16", {"HBM_MIN_BLOCKS": 16}),
    ("default", {}),
)


def _chip_smoke():
    """This tree's chip_smoke.py as a module, over whichever package comes
    first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def octant_key_resort(cb, chunk, nodes, N, o, d, t_min, t_max, lo, hi,
                      rounds, chunk_nit):
    """The K6 resort query of cuda_bvh._resort with another re-sort key: a
    closest-hit lane's row in all eight octant tables (octant * N + node,
    retired lanes last), which keeps each table's rows together in a
    launch."""
    import torch

    R, dev = o.shape[0], o.device
    (*rays, tmx), orig = cb.sort_rays(o, d, t_min, t_max, lo, hi)
    rays = tuple(rays)
    table = cb._octant(*rays[3:6]).to(torch.int32) * N
    node = torch.where(tmx > rays[6], 0, N).to(torch.int32)
    state = (node, tmx, torch.full((R,), -1, dtype=torch.int32, device=dev),
             torch.zeros(R, device=dev), torch.zeros(R, device=dev))
    for _ in range(rounds):
        bt, bi, bu, bv, node = chunk(nodes, N, *rays, *state,
                                     max_steps=chunk_nit * cb.LSTRIP)
        key = torch.where(node < N, table + node, cb.OCTANTS * N)
        perm = torch.argsort(key, stable=True)
        rays = tuple(x[perm] for x in rays)
        table = table[perm]
        state = tuple(x[perm] for x in (node, bt, bi, bu, bv))
        orig = orig[perm]
    bt, bi, bu, bv, _ = chunk(nodes, N, *rays, *state, max_steps=0)
    return cb._hit_result(*cb._unsort(orig, bt, bi, bu, bv))


def run_design(label, src_root, defines):
    sys.path.insert(0, str(src_root))
    import torch

    from mitsuba_tpu_torch.ops import build
    from mitsuba_tpu_torch.ops import cuda_bvh as cb

    cs = _chip_smoke()
    build.NVCC_FLAGS = build.NVCC_FLAGS + tuple(
        f"-D{k}={v}" for k, v in defines.items())
    logs = build.build_all(("bvh_lane",))
    for line in logs.get("bvh_lane", "").splitlines():
        if "spill" in line and not line.strip().startswith("0 bytes"):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda")
    res = {"label": label, "source": str(src_root), "defines": defines}
    scene, static = cs.large_scene(dev)
    N, nodes = static.n_bvh_nodes, scene.nodes
    o, d, t_min, t_max = cs.large_tier_rays(scene)
    # the octant tables where this tree's K5/K6 walk them
    kw = ({"octants": scene.octants}
          if "octants" in inspect.signature(cb.lane_hbm).parameters else {})
    for name in ("lane_hbm", "lane_chunk_hbm", "lane_hbm any_hit",
                 "lane_chunk_hbm any_hit"):
        try:
            regs, blocks = cb.kernel_occupancy(name)
        except ValueError:      # an older tree: K6's closest hit only
            continue
        res[f"{name}/regs"], res[f"{name}/blocks"] = regs, blocks
        print(f"  {name}: {regs} registers, {blocks} blocks of 128 per SM")
    (*rays, tmx), _ = cb.sort_rays(o, d, t_min, t_max, scene.aabb_lo,
                                   scene.aabb_hi)
    rays = tuple(rays)
    so, sd = torch.stack(rays[0:3], -1), torch.stack(rays[3:6], -1)
    root = cs._root_state(N, rays, tmx)

    def k5(any_hit):
        return lambda: cb.lane_hbm(nodes, N, so, sd, rays[6], tmx,
                                   any_hit=any_hit, **kw)

    def k4(any_hit):
        return lambda: cb.bvh_traverse_lane_packed(nodes, N, so, sd, rays[6],
                                                   tmx, any_hit=any_hit)

    def k6():
        return cb.lane_chunk_hbm(nodes, N, *rays, *root, **kw)

    plain = {a: cb.lane_hbm_plain(nodes, N, so, sd, rays[6], tmx, any_hit=a,
                                  **kw)
             for a in (False, True)}
    for case, fn, ref in (("K5 closest", k5(False), plain[False]),
                          ("K5 any-hit", k5(True), plain[True]),
                          ("K6 closest", lambda: cs.chunk_result(k6()),
                           plain[False])):
        out = fn()
        torch.cuda.synchronize()
        cs.compare(f"{label}/{case}", out, ref, n_exact=1, ulp_limit=0)
    # K6 bounded by chip_smoke's budget, then resumed
    state = root
    for steps in (cs.LARGE_CHUNK * cb.LSTRIP, 0):
        out = cb.lane_chunk_hbm(nodes, N, *rays, *state, max_steps=steps, **kw)
        ref = cb.lane_chunk_hbm_plain(nodes, N, *rays, *state,
                                      max_steps=steps, **kw)
        torch.cuda.synchronize()
        cs.compare(f"{label}/K6 max_steps={steps}", out, ref, n_exact=0,
                   ulp_limit=0)
        state = (out[4], out[0], out[1], out[2], out[3])
    print(f"  {label}: K5 closest/any-hit and K6 (unbounded; bounded, then "
          f"resumed) equal their plain versions bit for bit")
    for case, kern, yard in (("K5 closest", k5(False), k4(False)),
                             ("K5 any-hit", k5(True), k4(True)),
                             ("K6 closest", k6, k4(False))):
        turns = [cs.cuda_ms(f, reps=20) for f in (yard, kern, kern, yard)]
        res[case] = turns
        print(f"  {case}: K4 {turns[0]:.4f}, {case.split()[0]} "
              f"{turns[1]:.4f}, {turns[2]:.4f}, K4 {turns[3]:.4f} ms")
    lo, hi = scene.aabb_lo, scene.aabb_hi
    queries = {
        "K5 sorted query": lambda: cb.bvh_traverse_lane_hbm(
            nodes, N, o, d, t_min, t_max, lo, hi, sort=True, **kw),
        "K6 resort query": lambda: cb.bvh_traverse_lane_hbm_resort(
            nodes, N, o, d, t_min, t_max, lo, hi, rounds=cs.LARGE_ROUNDS,
            chunk_nit=cs.LARGE_CHUNK, **kw),
    }
    if kw:
        def octant_key():
            def chunk(*args, **k):
                return cb.lane_chunk_hbm(*args, **kw, **k)
            return octant_key_resort(cb, chunk, nodes, N, o, d, t_min, t_max,
                                     lo, hi, cs.LARGE_ROUNDS, cs.LARGE_CHUNK)
        for a, b in zip(octant_key(), queries["K6 resort query"]()):
            assert torch.equal(a, b), "the re-sort key changed the result"
        queries["K6 resort query, octant key"] = octant_key
    for q, fn in queries.items():
        res[q] = [cs.cuda_ms(fn, reps=5, warmup=1) for _ in range(2)]
        print(f"  {q}: {res[q][0]:.4f}, {res[q][1]:.4f} ms")
    print("RESULT " + json.dumps(res), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--design":
        defines = {}
        for kv in filter(None, sys.argv[4].split(",")):
            k, v = kv.split("=")
            defines[k] = int(v)
        run_design(sys.argv[2], sys.argv[3], defines)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_hbm_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    turns = [(label, ROOT, d) for label, d in DESIGNS]
    if len(sys.argv) > 1:
        other = Path(sys.argv[1]).resolve()
        turns = [("other", other, {})] + turns + [("other", other, {})]
    results = []
    for label, src, defines in turns:
        print(f"== {label} {src} {defines}", flush=True)
        proc = subprocess.run(
            [sys.executable, __file__, "--design", label, str(src),
             ",".join(f"{k}={v}" for k, v in defines.items())],
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
