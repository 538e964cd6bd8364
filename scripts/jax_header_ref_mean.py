#!/usr/bin/env python
"""Image statistics of the sensor-header renders through the JAX package on
the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_header_ref_mean.py

The reference values that ``chip_smoke.py``'s sensor-header phase (9e)
holds the PyTorch port's renders against, on the same samples:

- ``scenes/cbox.xml`` with its ``<sampler type="independent">`` replaced by
  ``ldsampler`` and its ``<rfilter type="gaussian">`` by ``mitchell``
  (``variant_xml``), loaded with ``-D spp=64 -D res=256`` and rendered by
  ``api.render`` with its own settings (path, depth 5, passes of 4, seed 0);
- the same file at 128x128, 16 spp, with each other sampler (stratified,
  sobol, halton, hammersley, faure) and the Gaussian filter, and with each
  other filter (tent, Catmull-Rom, Lanczos) and the independent sampler;
- ao on the Cornell box of ``shapes.cornell_box`` (``chip_smoke.cornell``'s
  camera), 128x128, rayLength 0.3, box filter, in passes of 16: the
  independent sampler at 512 spp (seed 7) and the independent and the
  ldsampler at 16 spp, seeds 0-2 (``tests/test_core.py:165``'s renders);
- ao on bench's bunny_x2 scene (``bench.build_bunny_scene``, camera of
  ``bench.py:291``), 512x512, 8 spp, the default ray length, box filter;
  its camera rays are cut into chunks of 16,384 lanes, each lane's value
  depending on its own pixel and sample alone;
- field (position, then albedo) on the Cornell box at 512x512, 4 spp, box
  filter.

For each it prints the seconds, ``mean_rgb`` and ``tv_rgb`` (the mean
absolute difference of horizontally adjacent pixels, per channel: it sees a
filter's sharpness and a sampler's noise pattern, which the mean cannot),
unrounded, then every value as one JSON object. ``variant_xml`` is also the
JAX side of tests/test_torch_header.py.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
from mitsuba_tpu.core.transform import Transform  # noqa: E402
from mitsuba_tpu.io.mitsuba_xml import load_scene  # noqa: E402
from mitsuba_tpu.render import api, shapes  # noqa: E402
from mitsuba_tpu.render import film as film_mod  # noqa: E402
from mitsuba_tpu.render import sensor as sensor_mod  # noqa: E402
from mitsuba_tpu.render.integrators import misc as int_misc  # noqa: E402
from mitsuba_tpu.render.integrators.common import (  # noqa: E402
    AO, DIM_APERTURE, FIELD, FIELD_ALBEDO, FIELD_POSITION, IntegratorConfig)
from mitsuba_tpu.render.scene import SceneBuilder  # noqa: E402

CBOX = os.path.join(REPO, "scenes", "cbox.xml")
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
BUNNY_EYE, BUNNY_AT, BUNNY_FOV = [0.0, 0.25, -0.75], [0.0, 0.1, 0.0], 45.0
OTHER_SAMPLERS = ("stratified", "sobol", "halton", "hammersley", "faure")
OTHER_FILTERS = ("tent", "catmullrom", "lanczos")
AO_RES, AO_LENGTH, AO_SPP, AO_REF_SPP, AO_REF_SEED = 128, 0.3, 16, 512, 7
BUNNY_AO_RES, BUNNY_AO_SPP, BUNNY_CHUNK = 512, 8, 16384
FIELD_RES, FIELD_SPP = 512, 4


def variant_xml(sampler="independent", rfilter="gaussian") -> str:
    """The text of scenes/cbox.xml with another sampler and filter type."""
    with open(CBOX) as f:
        text = f.read()
    for kind, old, new in (("sampler", "independent", sampler),
                           ("rfilter", "gaussian", rfilter)):
        tag = f'<{kind} type="{old}"'
        if text.count(tag) != 1:
            raise ValueError(f"cbox.xml has no single {tag}")
        text = text.replace(tag, f'<{kind} type="{new}"')
    return text


def image_stats(img):
    """(mean_rgb, tv_rgb) of an (H, W, 3) image, float64 sums."""
    img = np.asarray(img, np.float64)
    tv = np.abs(img[:, 1:] - img[:, :-1]).mean(axis=(0, 1))
    return img.mean(axis=(0, 1)).tolist(), tv.tolist()


def cornell_sensor(size):
    b = SceneBuilder()
    shapes.cornell_box(b)
    scene, static = b.build()
    return scene, static, sensor_mod.make_perspective(
        Transform.look_at(EYE, AT, UP), FOV, size, size)


def ao_settings(sampler, spp, seed):
    return api.RenderSettings(width=AO_RES, height=AO_RES, spp=spp,
                              spp_per_pass=16, filter_type=0,
                              sampler_type=sampler, seed=seed)


def bunny_ao():
    """bunny_x2 through li_ao, box filter, chunked lanes (see above)."""
    import bench
    from mitsuba_tpu.core import rng as rng_mod

    scene, static = bench.build_bunny_scene()
    W = H = BUNNY_AO_RES
    sens = sensor_mod.make_perspective(
        Transform.look_at(BUNNY_EYE, BUNNY_AT, UP), BUNNY_FOV, W, H)
    cfg = IntegratorConfig(type=AO)
    st = api.RenderSettings(width=W, height=H, spp=BUNNY_AO_SPP,
                            filter_type=0)
    seed = jnp.asarray(0, jnp.int32)
    rng_mod.set_sampler(rng_mod.INDEPENDENT)

    @jax.jit
    def lanes(pixel_idx, sample_idx):
        pos = api.pixel_sample_positions(st, pixel_idx, sample_idx, seed)
        uv = pos / jnp.asarray([W, H], jnp.float32)
        u_ap = rng_mod.uniform2(seed, pixel_idx, sample_idx, DIM_APERTURE)
        o, d = sensor_mod.sample_ray(sens, uv, u_ap)
        return int_misc.li_ao(scene, static, cfg, o, d, seed, pixel_idx,
                              sample_idx)

    film = film_mod.Film.empty(H, W)
    for s in range(BUNNY_AO_SPP):
        L = np.concatenate([
            np.asarray(lanes(jnp.arange(c, c + BUNNY_CHUNK, dtype=jnp.int32),
                             jnp.asarray(s, jnp.int32)))
            for c in range(0, W * H, BUNNY_CHUNK)])
        film = film_mod.splat_aligned(film, jnp.asarray(L).reshape(H, W, 3))
    return film_mod.develop(film)


def renders():
    """(label, thunk) of every render, in chip_smoke.py's order."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        def scene_file(sampler, rfilter, spp, res):
            path = os.path.join(tmp, f"{sampler}_{rfilter}.xml")
            with open(path, "w") as f:
                f.write(variant_xml(sampler, rfilter))
            ls = load_scene(path, {"spp": spp, "res": res})
            return np.asarray(api.render(ls.scene, ls.static, ls.sensor,
                                         ls.integrator, ls.settings))

        out.append(("cbox.xml ldsampler mitchell",
                    lambda: scene_file("ldsampler", "mitchell", 64, 256)))
        for s in OTHER_SAMPLERS:
            out.append((f"cbox.xml {s} gaussian",
                        lambda s=s: scene_file(s, "gaussian", 16, 128)))
        for r in OTHER_FILTERS:
            out.append((f"cbox.xml independent {r}",
                        lambda r=r: scene_file("independent", r, 16, 128)))
        scene, static, sens = cornell_sensor(AO_RES)
        ao = IntegratorConfig(type=AO, ray_length=AO_LENGTH)
        out.append((f"ao cornell independent {AO_REF_SPP} spp seed "
                    f"{AO_REF_SEED}", lambda: api.render(
                        scene, static, sens, ao,
                        ao_settings(api.INDEPENDENT, AO_REF_SPP,
                                    AO_REF_SEED))))
        for name, tag in (("independent", api.INDEPENDENT),
                          ("ldsampler", api.LDSAMPLER)):
            for k in range(3):
                out.append((f"ao cornell {name} {AO_SPP} spp seed {k}",
                            lambda tag=tag, k=k: api.render(
                                scene, static, sens, ao,
                                ao_settings(tag, AO_SPP, k))))
        out.append(("ao bunny_x2", bunny_ao))
        fscene, fstatic, fsens = cornell_sensor(FIELD_RES)
        for name, field in (("position", FIELD_POSITION),
                            ("albedo", FIELD_ALBEDO)):
            out.append((f"field cornell {name}", lambda field=field: api.render(
                fscene, fstatic, fsens,
                IntegratorConfig(type=FIELD, field=field),
                api.RenderSettings(width=FIELD_RES, height=FIELD_RES,
                                   spp=FIELD_SPP, filter_type=0))))
        values = {}
        for label, thunk in out:
            t0 = time.perf_counter()
            mean, tv = image_stats(thunk())
            print(f"{label}: {time.perf_counter() - t0:.1f} s, mean_rgb "
                  f"{mean}, tv_rgb {tv}", flush=True)
            values[label] = {"mean": mean, "tv": tv}
    return values


def main() -> int:
    t0 = time.perf_counter()
    print(f"jax {jax.__version__} on {jax.default_backend()}", flush=True)
    values = renders()
    print(json.dumps(values))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
