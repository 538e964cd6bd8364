#!/usr/bin/env python
"""mean_rgb of the Veach MIS renders through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_veach_ref_mean.py

The reference values that ``chip_smoke.py``'s Veach MIS phase (BASELINE
config 3) holds the PyTorch port's renders against, on the same PCG samples
(seed 0, box filter, 512x512):

- ``veach_mis`` (the fixture of tests/test_baseline_scenes.py:17-44, built
  by ``veach_scene``) through the path tracer at the fixture's depth 3,
  32 spp in passes of 4;
- ``veach_mis_plastic`` (the same with plate 1 a GGX rough plastic, plate 3
  a Beckmann one, both turned to face the camera, and the floor a
  nonlinear smooth plastic) through the path tracer, the same settings;
- ``veach_mis`` through the direct integrator, one emitter and one BSDF
  sample, 16 spp in passes of 4.

Prints the JAX version, each render's seconds and its mean, unrounded.
``veach_scene`` is also the JAX side of tests/test_torch_veach.py.
"""
from __future__ import annotations

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from mitsuba_tpu.core.transform import Transform  # noqa: E402
from mitsuba_tpu.render import api, shapes  # noqa: E402
from mitsuba_tpu.render import bsdf as B  # noqa: E402
from mitsuba_tpu.render import microfacet as mf  # noqa: E402
from mitsuba_tpu.render import sensor as sensor_mod  # noqa: E402
from mitsuba_tpu.render.integrators.common import (  # noqa: E402
    DIRECT, PATH, IntegratorConfig)
from mitsuba_tpu.render.scene import SceneBuilder  # noqa: E402

EYE, AT, UP, FOV = [0, 1.2, -2.8], [0, 1.0, 1.0], [0, 1, 0], 38.0
RES, PATH_SPP, DIRECT_SPP, SPP_PER_PASS, DEPTH = 512, 32, 16, 4, 3
# the sphere lights: (x, radius, radiance), at y 2.6, z 0.5
LIGHTS = ((-1.5, 0.03, 900.0), (0.0, 0.12, 55.0), (1.5, 0.45, 4.0))
# the plastic variant's rough-plastic plates: degrees about x
TURNED = -155.0


def veach_scene(plastic=False, size=RES):
    """(scene, static, sensor at ``size`` x ``size``) of the Veach MIS
    scene, with the plastics when ``plastic``; chip_smoke.veach_scene makes
    the same calls on the port's builder."""
    b = SceneBuilder()
    v, f, uv = shapes.rectangle(
        Transform.translate([0, 0, 2]) * Transform.rotate([1, 0, 0], -90.0)
        * Transform.scale([6, 6, 1]))
    floor = (b.add_material(type=B.PLASTIC, albedo=(0.4, 0.4, 0.4),
                            eta=1.49, nonlinear=True) if plastic
             else b.add_material(albedo=(0.4, 0.4, 0.4)))
    b.add_mesh(v, f, floor, uvs=uv)
    rough_plastic = {1: ((0.1, 0.1, 0.1), mf.GGX),
                     3: ((0.5, 0.2, 0.1), mf.BECKMANN)} if plastic else {}
    for i, alpha in enumerate((0.005, 0.02, 0.1, 0.3)):
        if i in rough_plastic:
            albedo, dist = rough_plastic[i]
            mat = b.add_material(type=B.ROUGH_PLASTIC, alpha=(alpha, alpha),
                                 albedo=albedo, eta=1.49, dist=dist)
        else:
            mat = b.add_material(type=B.ROUGH_CONDUCTOR, alpha=(alpha, alpha),
                                 eta=(0.2,) * 3, k=(3.9,) * 3)
        # the camera sees the fixture's plates from behind; the rough
        # plastics are turned to face it and the lights' highlights
        tilt = TURNED if i in rough_plastic else -60.0 + 6.0 * i
        t = (Transform.translate([0.0, 0.25 + 0.45 * i, 2.8 - 0.5 * i])
             * Transform.rotate([1, 0, 0], tilt)
             * Transform.scale([2.0, 0.18, 1.0]))
        v, f, uv = shapes.rectangle(t)
        b.add_mesh(v, f, mat, uvs=uv)
    black = b.add_material(albedo=(0.0, 0.0, 0.0))
    for x, r, p in LIGHTS:
        b.add_sphere((x, 2.6, 0.5), r, black, emitter_radiance=(p, p, p))
    scene, static = b.build()
    sensor = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                         size, size)
    return scene, static, sensor


def mean_of(label, fn):
    t0 = time.perf_counter()
    img = np.asarray(fn())
    print(f"{label}: {time.perf_counter() - t0:.1f} s, shape {img.shape}, "
          f"mean_rgb {img.mean(axis=(0, 1)).tolist()}", flush=True)


def main() -> int:
    print(f"jax {jax.__version__} on {jax.default_backend()}", flush=True)
    for label, plastic, cfg, spp in (
            ("veach_mis path", False, IntegratorConfig(type=PATH,
                                                       max_depth=DEPTH),
             PATH_SPP),
            ("veach_mis_plastic path", True,
             IntegratorConfig(type=PATH, max_depth=DEPTH), PATH_SPP),
            ("veach_mis direct", False, IntegratorConfig(type=DIRECT),
             DIRECT_SPP)):
        scene, static, sensor = veach_scene(plastic)
        settings = api.RenderSettings(width=RES, height=RES, spp=spp,
                                      spp_per_pass=SPP_PER_PASS,
                                      filter_type=0, seed=0)
        mean_of(f"{label} {RES}x{RES} {spp} spp", lambda: api.render(
            scene, static, sensor, cfg, settings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
