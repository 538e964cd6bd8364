#!/usr/bin/env python
"""How far one rounding moves the manifold walk of ``chip_smoke.manifold_cases``.

    python scripts/torch_manifold_probe.py [--device cpu|cuda]

For each case (cbox.xml's sphere in metres, the glass mesh sphere, the same
sphere in the file's millimetres) it runs ``chip_smoke.manifold_walk`` on
the seeded emission pairs and again on the pairs one ulp up, and prints how
many of the 65,536 lanes moved past ``MANIFOLD_DIR_ATOL`` (exit or target
direction) and past ``MANIFOLD_DET_RTOL`` (``det_omega``), and how many
convergence flags flipped: the spread the card-against-CPU limits of phase
9m must leave room for. It also prints how many exit directions of the
millimetre case differ from the same chains in metres (a direction does
not depend on the unit). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from mitsuba_tpu_torch.render import manifold  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cases = cs.manifold_cases(args.device)
    with torch.no_grad():
        for name, case in cases.items():
            u, rest = case[0], case[1:]
            ref = cs.manifold_walk(*case)
            out = cs.manifold_walk(torch.nextafter(u, torch.full_like(u, 2.0)),
                                   *rest)
            err_d = torch.maximum(*((a - b).abs().amax(dim=1)
                                    for a, b in zip(out[:2], ref[:2])))
            rel = (out[4] - ref[4]).abs() / ref[4].abs().clamp(min=1e-30)
            print(f"{name}: one ulp of the emission pair moves "
                  f"{int((err_d > cs.MANIFOLD_DIR_ATOL).sum())} of {u.shape[0]}"
                  f" lanes past {cs.MANIFOLD_DIR_ATOL} (at most "
                  f"{float(err_d.max()):.3g}), "
                  f"{int((rel > cs.MANIFOLD_DET_RTOL).sum())} past "
                  f"{cs.MANIFOLD_DET_RTOL} in det_omega, and flips "
                  f"{int((out[3] != ref[3]).sum())} convergence flags",
                  flush=True)
        d_m = manifold.chain_exit_dir(*cases["sphere"][:7])
        d_mm = manifold.chain_exit_dir(*cases["sphere mm"][:7])
        err = (d_m - d_mm).abs().amax(dim=1)
        print(f"sphere mm against sphere: {int((err > cs.MANIFOLD_DIR_ATOL).sum())}"
              f" exit directions differ past {cs.MANIFOLD_DIR_ATOL}, "
              f"{int((err > 1e-2).sum())} past 1e-2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
