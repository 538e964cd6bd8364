#!/usr/bin/env python
"""Image statistics of the sensor-header, gallery, lights-and-cameras,
cloth-and-spectra, participating-media, sky-and-subsurface and
bidirectional renders through the port, beside the JAX package's values that chip_smoke.py holds
them to.

    python scripts/torch_header_stats.py [--device cpu|cuda] [--threads N]
        [--block-y Y] [--eye-shift DX] [LABEL ...]

Renders each render of ``chip_smoke.py``'s sensor-header phase (9e,
``chip_smoke.header_renders`` and ``bunny_ao_case``), material-gallery
phase (9f, ``chip_smoke.gallery_renders``, labels ``gallery {variant}``),
layered-gallery phase (9g, labels ``layered {variant}``) and
lights-and-cameras phase (9h, ``chip_smoke.lights_renders``, labels
``lights {variant}``; a meter's value against ``METER_REF``),
cloth-and-spectra phase (9i, ``chip_smoke.cloth_renders`` and
``spectral_renders``, labels ``cloth {variant}`` and ``spectral cauchy_b
{B}``, the latter through ``api.render_spectral``) and participating-media
phase (9j, ``chip_smoke.volume_renders``, labels ``volumes {variant}``)
and sky-and-subsurface phase (9k, ``chip_smoke.sky_renders`` and
``subsurface_renders``, labels ``sky {variant}`` and ``subsurface
{variant}``, the dipole's point cloud placed by
``chip_smoke.subsurface_prepare``'s call on the CPU too) and bidirectional
phase (9l, ``chip_smoke.bidir_renders``, labels ``bidir {variant}``: the
particle tracer and the bidirectional tracer) and Metropolis phase (9m,
``chip_smoke.metro_renders``, labels ``metropolis {variant}``; pssmlt's and
mlt's b against ``METRO_B``) whose label starts with one of
the LABELs (all of them without one)
through this tree's ``mitsuba_tpu_torch`` on ``--device`` (the card by default), and prints its
``mean_rgb`` and ``tv_rgb`` with their relative gaps to
``chip_smoke.HEADER_REF`` (``scripts/jax_header_ref_mean.py``'s values) and
the seconds it took. It imports nothing of JAX. Run from a copy of the tree
with a piece of the port broken on purpose, it shows how far that break
moves each statistic against the limits ``HEADER_MEAN_RTOL`` and
``HEADER_TV_RTOL`` (9j: ``VOLUME_MEAN_RTOL`` and ``VOLUME_TV_RTOL``; 9m: the
header's, and ``METRO_B_RTOL``). ``--block-y`` and ``--eye-shift`` go to
``chip_smoke.gallery_xml``: the gallery's short block at another height, the
camera moved along x (the rounding check of PERF.md section 6, PR 14).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from mitsuba_tpu_torch.render import subsurface as sss_mod  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--block-y", type=float, default=cs.GALLERY_BLOCK_Y)
    ap.add_argument("--eye-shift", type=float, default=0.0)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_header_stats: CUDA is not available", file=sys.stderr)
        return 1

    def wanted(label):
        return not args.labels or any(label.startswith(x) for x in args.labels)

    print(f"tree {ROOT}; device {dev}; limits: mean {cs.HEADER_MEAN_RTOL}, "
          f"tv {cs.HEADER_TV_RTOL} relative (9j: {cs.VOLUME_MEAN_RTOL}, "
          f"{cs.VOLUME_TV_RTOL})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cases = cs.header_renders(dev, tmp, cs.cornell(dev))
        for g in (cs.MATERIAL_GALLERY, cs.LAYERED_GALLERY):
            cases.update(cs.gallery_renders(dev, tmp, g, block_y=args.block_y,
                                            eye_shift=args.eye_shift))
        cases.update(cs.lights_renders(dev, tmp))
        cases.update(cs.cloth_renders(dev, tmp))
        cases.update(cs.spectral_renders(dev))
        cases.update(cs.volume_renders(dev, tmp))
        cases.update(cs.sky_renders(dev, tmp))
        cases.update(cs.bidir_renders(dev, tmp))
        cases.update(cs.metro_renders(dev, tmp))
        for label, (scene, static, *rest) in cs.subsurface_renders(
                dev).items():
            if wanted(label):
                cases[label] = (sss_mod.prepare(scene, static), static,
                                *rest)
        if wanted("ao bunny_x2"):
            cases["ao bunny_x2"] = cs.bunny_ao_case(cs.bunny(dev))
        for label, (scene, static, sensor, cfg, settings, _) in cases.items():
            if not wanted(label):
                continue
            t0 = time.perf_counter()
            img = cs.render_fn(label)(scene, static, sensor, cfg, settings,
                                      device=dev)
            dt = time.perf_counter() - t0
            mean = img.double().mean(dim=(0, 1)).tolist()
            if label in cs.METER_REF:
                mean_ref = cs.METER_REF[label]
                print(f"{label}: {dt:.1f} s; value {mean} gap "
                      f"{[a / b - 1 for a, b in zip(mean, mean_ref)]} (limit "
                      f"{cs.METER_RTOL})", flush=True)
                continue
            tv = cs.tv_rgb(img)
            mean_ref, tv_ref = cs.HEADER_REF[label]
            print(f"{label}: {dt:.1f} s; mean_rgb {mean} gap "
                  f"{[a / b - 1 for a, b in zip(mean, mean_ref)]}; tv_rgb "
                  f"{tv} gap {[a / b - 1 for a, b in zip(tv, tv_ref)]}",
                  flush=True)
            if label in cs.METRO_B:
                b = cs.int_mlt.LAST_RUN["b"]
                print(f"{label}: b {b!r} gap {b / cs.METRO_B[label] - 1} "
                      f"(limit {cs.METRO_B_RTOL}); {cs.int_mlt.LAST_RUN}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
