"""Time K1 and K2 of the PyTorch/CUDA port under several schedules, and
against another tree's brute_force.cu, on one CUDA card.

    python scripts/torch_bf_sweep.py [OTHER_ROOT] [--only-default]

Each variant builds mitsuba_tpu_torch/csrc/brute_force.cu with its -D
schedule (BF_THREADS, BF_RPT, BF_TILE, BF_UNROLL) in a process
of its own (a process loads one build of the library) and prints ptxas's
registers and spills, each kernel's registers and resident blocks per SM at
36 and 4,096 triangles, the inner loop's instruction slots per test
(cuobjdump -sass), and the device time of each kernel on chip_smoke.py's
cornell_camera, soup4096 and dead_heavy cases, each result held bit for bit
against the plain version; then the Cornell render of chip_smoke.py's
render phase (ms/spp on the host clock, after one warm-up render) and the
render mean per launch of K1 and K2 in one profiled 4-spp pass of it. With
--only-default only this tree's default schedule runs (twice). OTHER_ROOT
is the root of another checkout (a git archive of the parent commit, say):
its brute_force.cu runs first and last and this tree's default second and
second to last, so that a drift of the card between turns shows.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = (
    ("threads128_rpt4", {"BF_THREADS": 128, "BF_RPT": 4}),
    ("threads128", {"BF_THREADS": 128}),
    ("rpt1", {"BF_RPT": 1}),
    ("threads512_rpt1", {"BF_THREADS": 512, "BF_RPT": 1}),
    ("unroll2", {"BF_UNROLL": 2}),
    ("tile256", {"BF_TILE": 256}),
)
CASES = ("cornell_camera", "soup4096", "dead_heavy")


def run_variant(label, src_root, defines):
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from mitsuba_tpu_torch.ops import build
    from mitsuba_tpu_torch.ops import cuda_intersect as bf

    build.CSRC = Path(src_root) / "mitsuba_tpu_torch" / "csrc"
    build.NVCC_FLAGS = build.NVCC_FLAGS + tuple(
        f"-D{k}={v}" for k, v in defines.items())
    logs = build.build_all(("brute_force",))
    for line in logs.get("brute_force", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    lib = build.load("brute_force")
    has_occ = hasattr(lib, "bf_kernel_occupancy")
    for entry in ("bf_kernel_occupancy", "bf_rcp_mismatches"):
        if not hasattr(lib, entry):
            # an older source: the same two kernel entries, no others
            setattr(lib, entry, types.SimpleNamespace())
    dev = torch.device("cuda")
    res = {"label": label, "source": str(src_root), "defines": defines}
    kernels = {
        "brute_force_interaction": (bf.brute_force_interaction,
                                    bf.brute_force_interaction_plain, True,
                                    "interaction_kernel"),
        "brute_force_closest_hit": (bf.brute_force_closest_hit,
                                    bf.brute_force_closest_hit_plain, False,
                                    "closest_hit_kernel"),
    }
    cases = cs.bf_cases(dev)
    for name, (kern, plain, full, fn_name) in kernels.items():
        if has_occ:
            for T in (36, 4096):
                regs, blocks, threads = bf.kernel_occupancy(name, T)
                print(f"  {name} T={T}: {regs} registers, {blocks} blocks "
                      f"of {threads} per SM")
        try:
            n_body, stub, rcp, slots = cs.loop_slots(fn_name)
        except (StopIteration, TypeError) as e:  # no such kernel or loop
            print(f"  {name}: slots not counted ({e!r})")
            slots = float("nan")
        else:
            print(f"  {name}: inner loop {n_body} instructions ({stub} in "
                  f"slow-path stubs), {rcp} tests per pass, {slots:.2f} "
                  f"slots per test")
        res[f"{name}/slots"] = slots
        for case in CASES:
            tris, r = cases[case]
            args = (tris if full else tris[:3]) + r
            out, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            cs.compare(f"{name}/{case}", out, ref, n_exact=1, ulp_limit=0)
            reps = 20 if case == "soup4096" else 400
            res[f"{name}/{case}"] = cs.cuda_ms(lambda: kern(*args), reps=reps)
            print(f"  {name} {case}: {res[f'{name}/{case}']:.5f} ms "
                  f"(0 ulp against the plain version)")
    scene, static, sensor = cs.cornell(dev)
    # the render phase's Cornell render, on the host clock
    cfg = cs.IntegratorConfig(type=cs.PATH, max_depth=cs.DEPTH)
    settings = cs.api.RenderSettings(width=cs.W, height=cs.H, spp=cs.SPP,
                                     spp_per_pass=cs.SPP_PER_PASS, seed=cs.SEED)
    cs.api.render(scene, static, sensor, cfg, settings, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.api.render(scene, static, sensor, cfg, settings, device=dev)
    torch.cuda.synchronize()
    res["render_ms_per_spp"] = (time.perf_counter() - t0) / cs.SPP * 1e3
    print(f"  Cornell render: {res['render_ms_per_spp']:.3f} ms/spp")
    per_kernel = cs.profile_phase(dev, "cornell", scene, static, sensor,
                                  cs.SPP_PER_PASS)
    for name, fn_name in (("brute_force_interaction", "interaction_kernel"),
                          ("brute_force_closest_hit", "closest_hit_kernel")):
        ms, n = per_kernel.get(fn_name, (float("nan"), 0))
        res[f"{name}/render_mean"] = ms / max(n, 1)
    print("RESULT " + json.dumps(res), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--variant":
        label, src, defines = sys.argv[2], sys.argv[3], {}
        for kv in filter(None, sys.argv[4].split(",")):
            k, v = kv.split("=")
            defines[k] = int(v)
        run_variant(label, src, defines)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_bf_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    args = sys.argv[1:]
    variants = () if "--only-default" in args else VARIANTS
    args = [a for a in args if a != "--only-default"]
    other = args[0] if args else None
    turns = [("default", ROOT, {})] + [(lab, ROOT, d) for lab, d in variants]
    turns.append(("default", ROOT, {}))
    if other is not None:
        turns = [("other", other, {})] + turns + [("other", other, {})]
    for label, src, defines in turns:
        print(f"== {label} {src} {defines}", flush=True)
        subprocess.run([sys.executable, __file__, "--variant", label, str(src),
                        ",".join(f"{k}={v}" for k, v in defines.items())],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
