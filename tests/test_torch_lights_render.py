"""Port parity, the delta lights and the sensors in renders: phase 9h's "all"
scene (cbox.xml's area light with a point, a spot, a directional and a
collimated light) through a thin-lens camera, loaded by both loaders and
rendered through the path tracer and the direct integrator, pixel for pixel
against the JAX package; the three meters through ``render_meter`` against
the JAX package's meter body on one small scene; and, on the port alone,
the meters' closed forms under a constant environment (tests/test_sensor.py:
E = pi L, fluence 4 pi L) and a point light's inverse-square law
(tests/test_integrators.py), on the CPU.

Tolerances: the renders as tests/test_torch_nested_render.py's (image means
within 1e-3 relative, >= 99% of pixels within atol 1e-4 / rtol 1e-3, ray
counts within 0.1%: an NEE sample on the light's own plane flips with the
last bit of the hit point); the meters within 1e-4 relative per channel
(the sums of 32,768 lanes in another order, and a lane that turns on a
last bit moves the mean by its share); the closed forms within 1e-5
relative (every lane sees the same radiance: only the float32 sum rounds);
the inverse-square law within 2% (64 samples of a 2-degree footprint, as
the JAX test).

The JAX render passes of the "all" scene are traced before the first test
and compiled by XLA in two threads while the port renders on one torch
thread (tests/test_torch_nested_render.py). The JAX ``render_meter`` jits
a chunk with the sensor closed over, a compile per meter; here its body is
traced once with the sensor as an argument (the JAX ``sample_ray`` takes a
traced type), so one compile serves the three meters.
"""
import concurrent.futures
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu.render.integrators import path as jpath
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_scenefile import jax_pass, jax_render

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke  # noqa: E402

ALL_RES, ALL_SPP = 32, 4
DEFINES = {"spp": ALL_SPP, "res": ALL_RES, "half": ALL_RES // 2}
KINDS = {"path": None, "direct": chip_smoke.LIGHTS_DIRECT}
METER_SPP = 1000  # rounds up to one chunk of 32,768 lanes


def all_lights_xml(kind):
    """Phase 9h's "all" scene through the thin-lens camera of its
    "thinlens" variant, rendered by the ``kind`` integrator."""
    return chip_smoke.lights_xml(chip_smoke.LIGHTS_VARIANTS["all"]._replace(
        sensor="thinlens", integrator=KINDS[kind]))


@pytest.fixture(scope="module", autouse=True)
def jax_all_lights(tmp_path_factory):
    """Per integrator, the file, the JAX scene loaded from it and its render
    pass, traced before the module's first test and compiled by XLA in a
    thread of its own while the other tests run."""
    tmp = tmp_path_factory.mktemp("lights")
    with concurrent.futures.ThreadPoolExecutor(len(KINDS)) as pool:
        out = {}
        for kind in KINDS:
            path = tmp / f"{kind}.xml"
            path.write_text(all_lights_xml(kind))
            jls = jxml.load_scene(str(path), DEFINES)
            lowered = jax_pass(jls.static, jls.sensor, jls.integrator,
                               jls.settings).trace(
                jls.scene, jnp.zeros((ALL_RES, ALL_RES, 4)),
                jnp.int32(0)).lower()
            out[kind] = (path, jls, pool.submit(lowered.compile))
        yield out


@pytest.fixture(scope="module")
def all_lights(jax_all_lights):
    """Per integrator, both loaders' scenes, both images and both counts of
    ray queries."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kind, (path, jls, _) in jax_all_lights.items():
            tls = txml.load_scene(str(path), DEFINES, device="cpu")
            img, n = tapi.render(tls.scene, tls.static, tls.sensor,
                                 tls.integrator, tls.settings, device="cpu",
                                 with_stats=True)
            out[kind] = dict(jls=jls, tls=tls, img=img.numpy(), n=n)
    finally:
        torch.set_num_threads(threads)
    for kind, (_, jls, compiled) in jax_all_lights.items():
        out[kind]["img_ref"], out[kind]["n_ref"] = jax_render(
            jls.scene, jls.static, jls.sensor, jls.integrator, jls.settings,
            one_pass=compiled.result())
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_all_lights_scene_loads_as_the_jax_loaders(all_lights, kind):
    tls, jls = all_lights[kind]["tls"], all_lights[kind]["jls"]
    assert tls.static.emitter_types == tuple(jls.static.emitter_types) == (
        0, 1, 4, 5, 6)
    assert tls.sensor.type == int(jls.sensor.type) == tsensor.THINLENS
    em, jem = tls.scene.emitters, jls.scene.emitters
    for f in ("type", "radiance", "position", "direction", "spot_cos",
              "delta", "pmf", "cdf"):
        np.testing.assert_array_equal(getattr(em, f).numpy(),
                                      np.asarray(getattr(jem, f)), err_msg=f)
    assert tls.integrator.type == jls.integrator.type


@pytest.mark.parametrize("kind", KINDS)
def test_all_lights_render_mean_matches_jax(all_lights, kind):
    img, ref = all_lights[kind]["img"], all_lights[kind]["img_ref"]
    assert img.shape == ref.shape == (ALL_RES, ALL_RES, 3)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_all_lights_render_pixels_match_jax(all_lights, kind):
    r = all_lights[kind]
    close = np.isclose(r["img"], r["img_ref"], atol=1e-4,
                       rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


@pytest.mark.parametrize("kind", KINDS)
def test_all_lights_render_ray_counts_match_jax(all_lights, kind):
    n, n_ref = all_lights[kind]["n"], all_lights[kind]["n_ref"]
    assert abs(n - n_ref) <= 1e-3 * n_ref
    assert n > ALL_RES * ALL_RES * ALL_SPP


# --- the meters ---------------------------------------------------------------

def _meter_scene(mod, shapes, T, **build_kw):
    """A floor, a diffuse sphere, a small area light, a point light and a
    spot, by either builder."""
    b = mod.SceneBuilder()
    v, f, uv = shapes.rectangle(T.rotate([1, 0, 0], -90)
                                * T.scale([3, 3, 1]))
    b.add_mesh(v, f, b.add_material(albedo=(0.7, 0.6, 0.5)), uvs=uv)
    b.add_sphere([0.4, 0.5, 0.3], 0.5, b.add_material(albedo=(0.2, 0.5, 0.8)))
    v, f, uv = shapes.rectangle(T.translate([-0.5, 2.0, 0.0])
                                * T.rotate([1, 0, 0], 90)
                                * T.scale([0.3, 0.3, 1]))
    b.add_mesh(v, f, b.add_material(albedo=(0.0,) * 3), uvs=uv,
               emitter_radiance=(20.0, 18.0, 15.0))
    b.add_point_light((1.0, 1.5, -1.0), (3.0, 2.5, 2.0))
    b.add_spot_light((-1.0, 2.5, 1.0), (0.3, -1.0, -0.2), (8.0, 8.0, 9.0),
                     cutoff_deg=30.0)
    return b.build(**build_kw)


def _meters(mod, **kw):
    return [mod.make_radiancemeter([-1.0, 0.6, -1.5], [0.8, -0.1, 1.0], **kw),
            mod.make_irradiancemeter([0.0, 0.01, -0.8], [0.0, 1.0, 0.0], 0.05,
                                     **kw),
            mod.make_fluencemeter([-0.6, 0.8, 0.2], **kw)]


CFG = dict(type=jcommon.PATH, max_depth=3)


@pytest.fixture(scope="module")
def meters():
    """The port's api.render of each meter (render_meter) and the JAX
    render_meter's body on the same samples, with both ray counts."""
    js, jst = _meter_scene(jscene, jshapes, JTransform)
    ts, tst = _meter_scene(tscene, tshapes, TTransform, device="cpu")
    chunk = tapi.METER_CHUNK
    jcfg = jcommon.IntegratorConfig(**CFG)
    jrng.set_sampler(jrng.INDEPENDENT)
    seed = jnp.asarray(0, jnp.int32)

    @jax.jit
    def jax_chunk(scene_, sensor, s0):
        # api.render_meter's one_chunk (mitsuba_tpu/render/api.py:581-590)
        sample_idx = s0 + jnp.arange(chunk, dtype=jnp.int32)
        pixel_idx = jnp.zeros(chunk, jnp.int32)
        u = jrng.uniform2(seed, pixel_idx, sample_idx, jcommon.DIM_SENSOR)
        u_ap = jrng.uniform2(seed, pixel_idx, sample_idx,
                             jcommon.DIM_APERTURE)
        o, d = jsensor.sample_ray(sensor, u, u_ap)
        L, n = jpath.li(scene_, jst, jcfg, o, d, seed, pixel_idx, sample_idx,
                        with_stats=True)
        return jnp.sum(L, axis=0), n

    out = []
    settings = tapi.RenderSettings(width=1, height=1, spp=METER_SPP)
    for jm, tm in zip(_meters(jsensor), _meters(tsensor, device="cpu")):
        total, n_ref = jax_chunk(js, jm, jnp.asarray(0, jnp.int32))
        ref = np.asarray(total / chunk * jsensor.ray_weight(jm))
        img, n = tapi.render(ts, tst, tm, tcommon.IntegratorConfig(**CFG),
                             settings, device="cpu", with_stats=True)
        out.append((tm.type, img.numpy(), n, ref, int(n_ref)))
    return out


def test_meters_match_jax(meters):
    for stype, img, n, ref, n_ref in meters:
        assert img.shape == (1, 1, 3)
        np.testing.assert_allclose(img[0, 0], ref, rtol=1e-4,
                                   err_msg=f"type {stype}")
        assert abs(n - n_ref) <= 1e-3 * n_ref
        assert (img > 0).all()


def test_meter_sample_count_rounds_up_to_whole_chunks(meters):
    """1,000 samples run one chunk of 32,768 lanes, whose mean the meter
    reports, as in the JAX package; a depth-3 path issues at least a
    camera query per lane."""
    for _, _, n, _, _ in meters:
        assert n >= tapi.METER_CHUNK


def _env_only(radiance):
    b = tscene.SceneBuilder()
    b.add_constant_emitter(radiance)
    return b.build(device="cpu")


@pytest.mark.parametrize("stype,factor", [
    (tsensor.RADIANCEMETER, 1.0), (tsensor.IRRADIANCEMETER, math.pi),
    (tsensor.FLUENCEMETER, 4.0 * math.pi)])
@pytest.mark.parametrize("integrator", [tcommon.PATH, tcommon.DIRECT])
def test_meters_closed_forms_under_a_constant_environment(stype, factor,
                                                         integrator):
    """Under a uniform radiance L and no geometry: L, E = pi L, fluence
    4 pi L (tests/test_sensor.py), whatever the integrator."""
    L = np.float32([2.0, 0.5, 1.25])
    scene, static = _env_only(tuple(L.tolist()))
    sensor = {tsensor.RADIANCEMETER: tsensor.make_radiancemeter(
                  [0, 0, 0], [0.2, 0.3, 1.0], device="cpu"),
              tsensor.IRRADIANCEMETER: tsensor.make_irradiancemeter(
                  [0, 0, 0], [0, 0, 1], 0.1, device="cpu"),
              tsensor.FLUENCEMETER: tsensor.make_fluencemeter(
                  [0, 0, 0], device="cpu")}[stype]
    img = tapi.render(scene, static, sensor,
                      tcommon.IntegratorConfig(type=integrator),
                      tapi.RenderSettings(width=1, height=1, spp=4096),
                      device="cpu")
    np.testing.assert_allclose(img[0, 0].numpy(), factor * L, rtol=1e-5)


def test_point_light_inverse_square():
    """A point light of intensity I at height r over a diffuse floor of
    albedo a: the floor's radiance under it is a / pi * I / r^2
    (tests/test_integrators.py, point.cpp radiometry), through the direct
    integrator and the path tracer at depth 2."""
    I, albedo, r = 10.0, 0.6, 2.0
    b = tscene.SceneBuilder()
    v = np.array([[-50, 0, -50], [-50, 0, 50], [50, 0, 50], [50, 0, -50]],
                 float)
    b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]]),
               b.add_material(albedo=(albedo,) * 3))
    b.add_point_light([0, r, 0], (I, I, I))
    scene, static = b.build(device="cpu")
    sens = tsensor.make_perspective(
        TTransform.look_at([0, 1.0, 0], [0, 0, 0], [0, 0, 1]), 2.0, 4, 4,
        device="cpu")
    expected = albedo / np.pi * I / (r * r)
    for cfg in (tcommon.IntegratorConfig(type=tcommon.DIRECT),
                tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=2)):
        img = tapi.render(scene, static, sens, cfg,
                          tapi.RenderSettings(width=4, height=4, spp=64,
                                              filter_type=0),
                          device="cpu")
        np.testing.assert_allclose(img.mean().item(), expected, rtol=0.02)


def test_cli_renders_a_meter_file_through_render_pass(tmp_path):
    """The CLI renders every scene through render_pass, meters included (as
    the JAX CLI does): a 1x1 fluence meter's image is the ray_weight-scaled
    film of its samples (render_pass's pixel-jittered draws), here under a
    constant environment exactly 4 pi L."""
    from mitsuba_tpu_torch.__main__ import main
    from mitsuba_tpu_torch.io.image import read_exr

    path = tmp_path / "m.xml"
    path.write_text('<scene version="0.6.0"><sensor type="fluencemeter">'
                    '<sampler type="independent"><integer name="sampleCount"'
                    ' value="8"/></sampler></sensor><emitter type="constant">'
                    '<rgb name="radiance" value="0.5, 1, 2"/></emitter>'
                    "</scene>")
    out = tmp_path / "m.exr"
    assert main([str(path), "--cpu", "-z", "-o", str(out)]) == 0
    img = read_exr(str(out))
    assert img.shape == (1, 1, 3)
    np.testing.assert_allclose(img[0, 0], 4.0 * np.pi * np.float32(
        [0.5, 1.0, 2.0]), rtol=1e-5)
