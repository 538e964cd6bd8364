#!/usr/bin/env python
"""Image statistics of the sensor-header, gallery, lights-and-cameras,
cloth-and-spectra, participating-media, sky-and-subsurface, bidirectional
and Metropolis renders through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_header_ref_mean.py
        [--block-y Y] [--eye-shift DX] [LABEL ...]

The reference values that ``chip_smoke.py``'s sensor-header phase (9e) and
material-gallery phase (9f) hold the PyTorch port's renders against, on the
same samples (each render whose label starts with one of the LABELs, all of
them without one):

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
  filter;
- the material gallery, ``gallery {variant}`` for each variant of
  ``chip_smoke.GALLERY_BSDFS``: ``scenes/cbox.xml`` with its glass sphere
  and the added Cornell short block made of one single-layer BSDF
  (``chip_smoke.gallery_xml``, which takes ``--block-y`` and
  ``--eye-shift``), loaded and rendered as the ldsampler file;
- the layered gallery, ``layered {variant}`` for each variant of
  ``chip_smoke.LAYERED_BSDFS``: the same scene with the sphere and the block
  made of one nested or layered BSDF (the map variants: the block alone),
  the bump map's height field written by ``chip_smoke.write_height_pfm``
  beside the file, loaded with ``-D spp=32``
  (``chip_smoke.LAYERED_GALLERY.spp``) and rendered as above;
- lights and cameras, ``lights {variant}`` for each variant of
  ``chip_smoke.LIGHTS_VARIANTS`` (phase 9h): ``chip_smoke.lights_xml``'s
  text, cbox.xml with delta lights, another camera or a meter, loaded with
  ``chip_smoke.LIGHTS_DEFINES`` and rendered by ``api.render`` (a meter
  through its ``render_meter``; its tv_rgb is None);
- cloth and spectra (phase 9i): ``cloth {variant}`` for each variant of
  ``chip_smoke.CLOTH_BSDFS``, ``chip_smoke.cloth_xml``'s text (a rectangle
  of woven cloth under a point light) with ``chip_smoke.CLOTH_FILE``
  written beside it, loaded with ``chip_smoke.CLOTH_DEFINES`` and rendered
  by ``api.render``; ``spectral cauchy_b {B}`` for each B of
  ``chip_smoke.SPECTRAL_CAUCHY``, ``chip_smoke.spectral_scene`` built by
  the JAX builder and rendered by ``api.render_spectral`` at
  ``chip_smoke.SPECTRAL_RES``, ``SPECTRAL_SPP`` and ``SPECTRAL_DEPTH``;
- participating media (phase 9j): ``volumes {variant}`` for each variant of
  ``chip_smoke.VOLUME_DEFINES``, ``chip_smoke.volume_xml``'s text (the
  volumetric path tracer on cbox.xml with a medium in its glass sphere, on
  cbox.xml with a smoke plume's grid in a null cube, and on the fallback
  heightfield in a box of fog) with the grid and the PLY written beside it
  by ``chip_smoke.write_volume_files``, loaded with the variant's defines
  and rendered by ``api.render``;
- the sun and the sky (phase 9k): ``sky {variant}`` for each variant of
  ``chip_smoke.SKY_DEFINES``, ``chip_smoke.sky_xml``'s text (the terrain
  PLY under a Hosek sunsky, a floor and a sphere under a Preetham sky and
  a sun of a date), the PLY written beside it, loaded with the variant's
  defines and rendered by ``api.render``; each also prints
  ``chip_smoke.sky_digests`` of its loaded emitter table (``SKY_DIGESTS``);
- subsurface scattering (phase 9k): ``subsurface {variant}`` for each
  variant of ``chip_smoke.SSS_VARIANTS``, ``chip_smoke.subsurface_scene``
  built by the JAX builder, its point cloud placed by ``subsurface.prepare``
  at its defaults, rendered by ``api.render`` at ``chip_smoke.SSS_RES`` and
  ``SSS_SPP``, depth ``SSS_DEPTH``, in passes of one sample (the dipole's
  (lanes x points) sum stays at 65,536 lanes; the samples are the card's);
- the particle tracer and the bidirectional tracer (phase 9l): ``bidir
  {variant}`` for each variant of ``chip_smoke.BIDIR_DEFINES``,
  ``chip_smoke.bidir_xml``'s text (cbox.xml with bdpt and with ptracer, the
  spot-light scene of 9h through its orthographic camera with bdpt, and 9j's
  fog_terrain with bdpt, each at maxDepth 5), loaded with the variant's
  defines and rendered by ``api.render`` (``render_bdpt``,
  ``render_light_traced``);
- the Metropolis family (phase 9m): ``metropolis {variant}`` for each
  variant of ``chip_smoke.METRO_DEFINES``, ``chip_smoke.metro_xml``'s text
  (cbox.xml with pssmlt, mlt and erpt at maxDepth 5), loaded with the
  variant's defines and rendered by ``api.render`` (``render_mlt``,
  ``render_erpt``); for pssmlt and mlt it also prints the normalisation b,
  ``integrators.mlt.estimate_b`` as ``render_mlt`` calls it.

Every scene file is loaded with its difftrans rows made as
``add_material(type=DIFFTRANS, spec_trans=t)`` (``difftrans_in_spec_trans``):
the JAX loader puts the transmittance in the albedo column, which the lobe
never reads, and the port's loader stores it in spec_trans.

For each it prints the seconds, ``mean_rgb`` and ``tv_rgb`` (the mean
absolute difference of horizontally adjacent pixels, per channel: it sees a
filter's sharpness and a sampler's noise pattern, which the mean cannot),
unrounded, then every value as one JSON object. ``variant_xml`` is also the
JAX side of tests/test_torch_header.py.
"""
from __future__ import annotations

import argparse
import contextlib
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
from mitsuba_tpu.render import api, bsdf, shapes  # noqa: E402
from mitsuba_tpu.render import film as film_mod  # noqa: E402
from mitsuba_tpu.render import sensor as sensor_mod  # noqa: E402
from mitsuba_tpu.render.integrators import misc as int_misc  # noqa: E402
from mitsuba_tpu.render.integrators.common import (  # noqa: E402
    AO, DIM_APERTURE, FIELD, FIELD_ALBEDO, FIELD_POSITION, MLT, PATH, PSSMLT,
    IntegratorConfig)
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


@contextlib.contextmanager
def difftrans_in_spec_trans():
    """Within the block, the JAX builder makes a difftrans row as
    ``add_material(type=DIFFTRANS, spec_trans=t)`` with the albedo at its
    default, where the JAX loader asks for ``albedo=t``: so a loaded scene
    carries a difftrans element's transmittance in the column the lobe
    reads (the JAX loader's albedo column is read by no difftrans lobe;
    the PyTorch port's loader stores it in spec_trans)."""
    orig = SceneBuilder.add_material

    def add_material(self, *args, **kw):
        if kw.get("type") == bsdf.DIFFTRANS:
            kw["spec_trans"] = kw.pop("albedo", (0.5, 0.5, 0.5))
        return orig(self, *args, **kw)

    SceneBuilder.add_material = add_material
    try:
        yield
    finally:
        SceneBuilder.add_material = orig


def image_stats(img):
    """(mean_rgb, tv_rgb) of an (H, W, 3) image, float64 sums; tv_rgb None
    for an image one pixel wide (a meter's)."""
    img = np.asarray(img, np.float64)
    if img.shape[1] < 2:
        return img.mean(axis=(0, 1)).tolist(), None
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


def spectral(cauchy_b):
    """chip_smoke.spectral_scene through api.render_spectral."""
    import chip_smoke as cs

    scene, static = cs.spectral_scene(SceneBuilder(), bsdf, shapes, Transform,
                                      cauchy_b).build()
    sens = sensor_mod.make_perspective(
        Transform.look_at(cs.SPECTRAL_EYE, cs.SPECTRAL_AT, UP),
        cs.SPECTRAL_FOV, cs.SPECTRAL_RES, cs.SPECTRAL_RES)
    return api.render_spectral(
        scene, static, sens, IntegratorConfig(type=PATH,
                                              max_depth=cs.SPECTRAL_DEPTH),
        api.RenderSettings(width=cs.SPECTRAL_RES, height=cs.SPECTRAL_RES,
                           spp=cs.SPECTRAL_SPP))


def sky(variant, tmp):
    """chip_smoke.sky_xml's scene through load_scene and api.render, after
    printing the digests of its baked map and sun."""
    import chip_smoke as cs

    path = os.path.join(tmp, "scene.xml")
    with open(path, "w") as f:
        f.write(cs.sky_xml(variant))
    ls = load_scene(path, cs.SKY_DEFINES[variant])
    print(f"sky {variant}: digests {cs.sky_digests(ls.scene.emitters)}",
          flush=True)
    return np.asarray(api.render(ls.scene, ls.static, ls.sensor,
                                 ls.integrator, ls.settings))


def subsurface(variant):
    """chip_smoke.subsurface_scene through prepare and api.render."""
    import chip_smoke as cs
    from mitsuba_tpu.render import subsurface as sss

    scene, static = cs.subsurface_scene(SceneBuilder(), bsdf, shapes,
                                        Transform, sss,
                                        **cs.SSS_VARIANTS[variant]).build()
    scene = sss.prepare(scene, static)
    sens = sensor_mod.make_perspective(
        Transform.look_at(cs.EYE, cs.AT, cs.UP), cs.FOV, cs.SSS_RES,
        cs.SSS_RES)
    return api.render(
        scene, static, sens, IntegratorConfig(type=PATH,
                                              max_depth=cs.SSS_DEPTH),
        api.RenderSettings(width=cs.SSS_RES, height=cs.SSS_RES,
                           spp=cs.SSS_SPP, spp_per_pass=1, seed=cs.SEED))


def metropolis_b(ls):
    """The normalisation b of a loaded pssmlt or mlt scene, as
    ``api.render_mlt`` computes it (one jitted ``estimate_b``)."""
    from mitsuba_tpu.render.integrators import mlt as int_mlt

    s, cfg = ls.settings, ls.integrator
    return float(jax.jit(lambda sc: int_mlt.estimate_b(
        sc, ls.static, ls.sensor, cfg, s.width, s.height, int(s.seed),
        cfg.luminance_samples, mlt_mode=cfg.type == MLT))(ls.scene))


def renders(labels=(), block_y=None, eye_shift=0.0):
    """Statistics of every render whose label starts with one of
    ``labels`` (all without one), in chip_smoke.py's order."""
    import chip_smoke

    out = []
    with tempfile.TemporaryDirectory() as tmp:
        b_values = {}

        def scene_file(text, spp, res, defines=None, b_of=None):
            path = os.path.join(tmp, "scene.xml")
            with open(path, "w") as f:
                f.write(text)
            with difftrans_in_spec_trans():
                ls = load_scene(path, defines or {"spp": spp, "res": res})
            if b_of and ls.integrator.type in (PSSMLT, MLT):
                b_values[b_of] = metropolis_b(ls)
                print(f"{b_of}: b {b_values[b_of]!r}", flush=True)
            return np.asarray(api.render(ls.scene, ls.static, ls.sensor,
                                         ls.integrator, ls.settings))

        out.append(("cbox.xml ldsampler mitchell", lambda: scene_file(
            variant_xml("ldsampler", "mitchell"), 64, 256)))
        for s in OTHER_SAMPLERS:
            out.append((f"cbox.xml {s} gaussian", lambda s=s: scene_file(
                variant_xml(s, "gaussian"), 16, 128)))
        for r in OTHER_FILTERS:
            out.append((f"cbox.xml independent {r}", lambda r=r: scene_file(
                variant_xml("independent", r), 16, 128)))
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
        block = {"block_y": (chip_smoke.GALLERY_BLOCK_Y if block_y is None
                             else block_y), "eye_shift": eye_shift}
        chip_smoke.write_height_pfm(os.path.join(tmp, chip_smoke.HEIGHT_PFM))
        for g in (chip_smoke.MATERIAL_GALLERY, chip_smoke.LAYERED_GALLERY):
            for v in g.bsdfs:
                out.append((f"{g.kind} {v}", lambda g=g, v=v: scene_file(
                    g.xml(v, **block), g.spp, 256)))
        for v in chip_smoke.LIGHTS_VARIANTS:
            out.append((f"lights {v}", lambda v=v: scene_file(
                chip_smoke.lights_xml(v), 0, 0, chip_smoke.LIGHTS_DEFINES)))
        chip_smoke.write_cloth(tmp)
        for v in chip_smoke.CLOTH_BSDFS:
            out.append((f"cloth {v}", lambda v=v: scene_file(
                chip_smoke.cloth_xml(v), 0, 0, chip_smoke.CLOTH_DEFINES)))
        for b in chip_smoke.SPECTRAL_CAUCHY:
            out.append((f"spectral cauchy_b {b}", lambda b=b: spectral(b)))
        chip_smoke.write_volume_files(tmp)
        for v, defines in chip_smoke.VOLUME_DEFINES.items():
            out.append((f"volumes {v}", lambda v=v, defines=defines:
                        scene_file(chip_smoke.volume_xml(v), 0, 0, defines)))
        for v in chip_smoke.SKY_DEFINES:
            out.append((f"sky {v}", lambda v=v: sky(v, tmp)))
        for v in chip_smoke.SSS_VARIANTS:
            out.append((f"subsurface {v}", lambda v=v: subsurface(v)))
        for v, defines in chip_smoke.BIDIR_DEFINES.items():
            out.append((f"bidir {v}", lambda v=v, defines=defines:
                        scene_file(chip_smoke.bidir_xml(v), 0, 0, defines)))
        for v, defines in chip_smoke.METRO_DEFINES.items():
            out.append((f"metropolis {v}", lambda v=v, defines=defines:
                        scene_file(chip_smoke.metro_xml(v), 0, 0, defines,
                                   b_of=f"metropolis {v}")))
        values = {}
        for label, thunk in out:
            if labels and not any(label.startswith(x) for x in labels):
                continue
            t0 = time.perf_counter()
            mean, tv = image_stats(thunk())
            print(f"{label}: {time.perf_counter() - t0:.1f} s, mean_rgb "
                  f"{mean}, tv_rgb {tv}", flush=True)
            values[label] = {"mean": mean, "tv": tv}
            if label in b_values:
                values[label]["b"] = b_values[label]
    return values


def main() -> int:
    t0 = time.perf_counter()
    print(f"jax {jax.__version__} on {jax.default_backend()}", flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--block-y", type=float, default=None)
    ap.add_argument("--eye-shift", type=float, default=0.0)
    args = ap.parse_args()
    values = renders(args.labels, args.block_y, args.eye_shift)
    print(json.dumps(values))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
