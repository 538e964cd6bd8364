#!/usr/bin/env python
"""mean_rgb of the scene-file renders through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_scenefile_ref_mean.py

The reference values that ``chip_smoke.py``'s scene-file phase holds the
PyTorch port's renders against, on the same PCG samples (seed 0):

- ``scenes/cbox.xml`` loaded with ``-D spp=64 -D res=256`` (the README's
  example) and rendered by ``api.render`` with its own settings: the path
  tracer at depth 5, 256x256, 64 spp in passes of 4, Gaussian filter;
- the Cornell box of ``shapes.cornell_box`` (``chip_smoke.cornell``'s camera:
  [0.5, 0.5, -1.39] -> [0.5, 0.5, 0.5], fov 39) through the direct
  integrator, one emitter and one BSDF sample, 64x64, 16 spp in passes of 4,
  Gaussian filter.

Prints the JAX version, each render's seconds and its mean, unrounded.
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
from mitsuba_tpu.io.mitsuba_xml import load_scene  # noqa: E402
from mitsuba_tpu.render import api, shapes  # noqa: E402
from mitsuba_tpu.render import sensor as sensor_mod  # noqa: E402
from mitsuba_tpu.render.integrators.common import (  # noqa: E402
    DIRECT, IntegratorConfig)
from mitsuba_tpu.render.scene import SceneBuilder  # noqa: E402

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox.xml")
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0


def mean_of(label, fn):
    t0 = time.perf_counter()
    img = np.asarray(fn())
    print(f"{label}: {time.perf_counter() - t0:.1f} s, shape {img.shape}, "
          f"mean_rgb {img.mean(axis=(0, 1)).tolist()}", flush=True)


def main() -> int:
    print(f"jax {jax.__version__} on {jax.default_backend()}", flush=True)
    ls = load_scene(CBOX, {"spp": 64, "res": 256})
    mean_of("cbox.xml path 256x256 64 spp", lambda: api.render(
        ls.scene, ls.static, ls.sensor, ls.integrator, ls.settings))

    b = SceneBuilder()
    shapes.cornell_box(b)
    scene, static = b.build()
    sensor = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                         64, 64)
    mean_of("cornell direct 64x64 16 spp", lambda: api.render(
        scene, static, sensor, IntegratorConfig(type=DIRECT),
        api.RenderSettings(width=64, height=64, spp=16, spp_per_pass=4)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
