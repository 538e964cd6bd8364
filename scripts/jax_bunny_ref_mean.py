#!/usr/bin/env python
"""mean_rgb of bench.py's bunny_x2 render through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_bunny_ref_mean.py [--spp 10]

The reference value that ``chip_smoke.py`` holds the PyTorch port's bunny
render against. It repeats ``bench.py:time_scene`` for the bunny arguments
of ``bench.py:289-293`` (512x512, depth 5, seed 0, camera [0, 0.25, -0.75]
-> [0, 0.1, 0], fov 45, Gaussian filter, samples 0..spp-1 in passes of 2):
the same sample positions, camera rays, ``li`` call (with the pixel spread,
since the scene is textured) and ``splat_grid`` per sample, in the same
order. Only the lanes are cut into chunks of ``--chunk`` pixels for ``li``,
so that one process never holds the whole wavefront; every lane's radiance
depends on its own pixel and sample alone, so the image is the same.

Prints the JAX version, the arguments, the issued ray count and the mean.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench  # noqa: E402
from mitsuba_tpu.core import rng as rng_mod  # noqa: E402
from mitsuba_tpu.core.transform import Transform  # noqa: E402
from mitsuba_tpu.render import film as film_mod  # noqa: E402
from mitsuba_tpu.render import rfilter  # noqa: E402
from mitsuba_tpu.render import sensor as sensor_mod  # noqa: E402
from mitsuba_tpu.render.integrators import path as int_path  # noqa: E402
from mitsuba_tpu.render.integrators.common import (  # noqa: E402
    DIM_APERTURE, DIM_SENSOR, PATH, IntegratorConfig)

EYE, AT, FOV = [0.0, 0.25, -0.75], [0.0, 0.1, 0.0], 45.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=16384)
    args = ap.parse_args()
    W = H = args.size
    P = W * H
    if P % args.chunk:
        raise SystemExit("--chunk must divide the pixel count")

    t0 = time.perf_counter()
    scene, static = bench.build_bunny_scene()
    print(f"scene: {static.n_tris} triangles, {static.n_bvh_nodes} nodes, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    sens = sensor_mod.make_perspective(
        Transform.look_at(EYE, AT, [0, 1, 0]), FOV, W, H)
    cfg = IntegratorConfig(type=PATH, max_depth=args.depth)
    seed = jnp.asarray(0, jnp.int32)
    spread = sensor_mod.pixel_spread(sens, W)
    rng_mod.set_sampler(rng_mod.INDEPENDENT)

    @jax.jit
    def lanes(pixel_idx, sample_idx):
        """time_scene's per-sample body for a chunk of pixels."""
        u = rng_mod.uniform2(seed, pixel_idx, sample_idx, DIM_SENSOR)
        px = (pixel_idx % W).astype(jnp.float32)
        py = (pixel_idx // W).astype(jnp.float32)
        pos = jnp.stack([px, py], axis=-1) + u
        uv = pos / jnp.asarray([W, H], jnp.float32)
        u_ap = rng_mod.uniform2(seed, pixel_idx, sample_idx, DIM_APERTURE)
        o, d = sensor_mod.sample_ray(sens, uv, u_ap)
        L, n = int_path.li(
            scene, static, cfg, o, d, seed, pixel_idx, sample_idx,
            with_stats=True,
            pixel_spread=spread if static.has_textures else None)
        return pos, L, n

    @jax.jit
    def splat(film_data, pos, L):
        film = film_mod.splat_grid(film_mod.Film(data=film_data),
                                   pos.reshape(H, W, 2), L.reshape(H, W, 3),
                                   rfilter.GAUSSIAN, 0)
        return film.data

    film = film_mod.Film.empty(H, W).data
    rays = 0.0
    for s in range(args.spp):
        ts = time.perf_counter()
        pos_l, L_l = [], []
        for c in range(0, P, args.chunk):
            pix = jnp.arange(c, c + args.chunk, dtype=jnp.int32)
            pos, L, n = lanes(pix, jnp.asarray(s, jnp.int32))
            pos_l.append(np.asarray(pos))
            L_l.append(np.asarray(L))
            rays += float(n)
        film = splat(film, jnp.asarray(np.concatenate(pos_l)),
                     jnp.asarray(np.concatenate(L_l)))
        print(f"sample {s}: {time.perf_counter() - ts:.1f} s", flush=True)
    img = np.asarray(film_mod.develop(film_mod.Film(data=film)))
    mean = [round(float(x), 5) for x in img.mean(axis=(0, 1))]
    print(f"jax {jax.__version__} backend {jax.default_backend()}; "
          f"{W}x{H} depth {args.depth} spp {args.spp} seed 0 eye {EYE} "
          f"at {AT} fov {FOV}")
    print(f"rays {rays:.0f}")
    print(f"mean_rgb {mean} (unrounded {img.mean(axis=(0, 1)).tolist()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
