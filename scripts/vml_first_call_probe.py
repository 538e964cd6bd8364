"""Probe the first threaded MKL VML call of fresh CPU processes: does
``torch.sqrt`` return a correct root on every lane?

    python scripts/vml_first_call_probe.py [--runs 1000] [--jobs 8] [--warm]

Each run starts a fresh interpreter that imports torch, optionally makes a
one-element ``torch.sqrt`` call first (``--warm``), and then takes
``torch.sqrt`` of 4,096 float32 values: the squared lengths of the seeded
normal vectors of ``tests/test_torch_core.py:test_vector_math``, a call that
MKL splits over two threads. A lane is bad when it is off the float64 root
by more than 1e-6 relative. The script prints each run with bad lanes (their
count, first and last lane, largest error) and the totals. Run it with and
without ``--warm`` side by side, so that both see the same load.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

CHILD = """
import numpy as np, torch
if {warm}:
    torch.sqrt(torch.ones(1))
v = np.random.default_rng(2).normal(size=(4096, 3)).astype(np.float32)
a = torch.from_numpy(v)
y = torch.sqrt(torch.clamp(torch.sum(a * a, -1), min=0.0)).numpy()
exact = np.sqrt((v.astype(np.float64) ** 2).sum(-1))
err = np.abs(y - exact) / exact
bad = np.nonzero(err > 1e-6)[0]
print(len(bad), bad.min() if len(bad) else -1, bad.max() if len(bad) else -1,
      err.max())
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1000)
    ap.add_argument("--jobs", type=int, default=8,
                    help="fresh processes started together")
    ap.add_argument("--warm", action="store_true",
                    help="one-element torch.sqrt before the threaded call")
    a = ap.parse_args(argv)
    code = CHILD.format(warm=a.warm)
    n_bad = done = 0
    while done < a.runs:
        batch = min(a.jobs, a.runs - done)
        procs = [subprocess.Popen([sys.executable, "-c", code],
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(batch)]
        for i, p in enumerate(procs):
            out = p.communicate()[0].split()
            if p.returncode != 0:
                raise RuntimeError(f"run {done + i} failed: {out}")
            if int(out[0]):
                n_bad += 1
                print(f"run {done + i}: {out[0]} bad lanes ({out[1]}-{out[2]}),"
                      f" max relative error {float(out[3]):.3g}", flush=True)
        done += batch
    print(f"{'warm' if a.warm else 'cold'}: {n_bad} of {a.runs} runs with bad "
          f"lanes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
