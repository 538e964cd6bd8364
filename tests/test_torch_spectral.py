"""Port parity, the spectral render: every function of ``core/spectrum.py``
against the JAX package on the same numpy inputs, the scene file's
wavelength:value spectra, the multichannel integrator, and
``api.render_spectral`` on tests/test_spectral.py's dispersive glass slab
(chip_smoke.spectral_scene) against the JAX package's, on the CPU.

Tolerances:
  * the host functions (numpy, float64) and the sampled wavelengths:
    exactly;
  * the device functions: rtol 1e-5 / atol 1e-6 (exp and the three-term
    matrix products an ulp apart in XLA and PyTorch);
  * the render (8x8, 4 spp, depth 6, Cauchy's B 0.3): the mean within 1e-4
    relative, every pixel within atol 1e-4 / rtol 1e-3 (the JAX
    render_spectral counts no rays: the port's count is held between the
    camera rays and two queries per lane and bounce); the white furnace
    within 3% (the JAX test's).
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import spectrum as jsp
from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu_torch.core import spectrum as tsp
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_render import FIELD_PATHS, _leaf

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
RES, SPP, DEPTH, CAUCHY_B = 8, 4, 6, 0.3
N = 4096


def _draws(seed):
    rng = np.random.default_rng(seed)
    u = rng.random(N, np.float32)
    u[:3] = [0.0, 0.5, 1.0 - 2**-24]
    return u, rng.random((N, 3), np.float32)


# --- core/spectrum.py --------------------------------------------------------

@pytest.mark.parametrize("name", ["xyz_to_rgb", "rgb_to_xyz", "luminance",
                                  "srgb_gamma", "srgb_degamma"])
def test_colour_functions_match_jax(name):
    _, rgb = _draws(1)
    rgb = (rgb * 1.4 - 0.2).astype(np.float32)  # past [0, 1] on both sides
    ref = np.asarray(getattr(jsp, name)(jnp.asarray(rgb)))
    out = getattr(tsp, name)(torch.from_numpy(rgb)).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, **TOL)


def test_sample_wavelengths_equals_jax():
    u, _ = _draws(2)
    wl_ref, pdf_ref = jsp.sample_wavelengths(jnp.asarray(u))
    wl, pdf = tsp.sample_wavelengths(torch.from_numpy(u))
    np.testing.assert_array_equal(wl.numpy(), np.asarray(wl_ref))
    assert pdf == pdf_ref
    assert wl.min() >= tsp.WL_MIN and wl.max() <= tsp.WL_MAX


@pytest.mark.parametrize("name", ["cmf_xyz", "_band_bases", "d65"])
def test_wavelength_functions_match_jax(name):
    wl = np.asarray(jsp.sample_wavelengths(jnp.asarray(_draws(3)[0]))[0])
    ref = np.asarray(getattr(jsp, name)(jnp.asarray(wl)))
    out = getattr(tsp, name)(torch.from_numpy(wl.copy())).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_uplift_and_back_match_jax():
    u, rgb = _draws(4)
    wl_ref, pdf = jsp.sample_wavelengths(jnp.asarray(u))
    wl = torch.from_numpy(np.array(wl_ref))
    ref = np.asarray(jsp.uplift_rgb(jnp.asarray(rgb), wl_ref))
    out = tsp.uplift_rgb(torch.from_numpy(rgb), wl).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    ref = np.asarray(jsp.spectral_to_rgb(jnp.asarray(ref), wl_ref, pdf))
    out = tsp.spectral_to_rgb(torch.from_numpy(out), wl, pdf).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("name", ["_cie_xyz_fits", "_band_bases_np", "_D65",
                                  "_bb6504"])
def test_host_curves_equal_jax(name):
    wl = np.linspace(300.0, 900.0, 301)
    np.testing.assert_array_equal(np.asarray(getattr(tsp, name)(wl)),
                                  np.asarray(getattr(jsp, name)(wl)))


@pytest.mark.parametrize("name", ["_uplift_matrix", "_white_poly",
                                  "_uplift_inv"])
def test_host_constants_equal_jax(name):
    np.testing.assert_array_equal(getattr(tsp, name)(), getattr(jsp, name)())


def test_host_constants_are_cached_read_only():
    for fn in (tsp._white_poly, tsp._uplift_inv):
        a = fn()
        assert fn() is a and not a.flags.writeable
        with pytest.raises(ValueError):
            a[0] = 0.0


@pytest.mark.parametrize("args", [("spd_to_rgb", [400.0, 500.0, 600.0, 700.0],
                                   [0.2, 0.9, 0.4, 0.7]),
                                  ("blackbody_rgb", 2700.0),
                                  ("blackbody_rgb", 6504.0)],
                         ids=["spd_to_rgb", "blackbody_2700",
                              "blackbody_6504"])
def test_spd_to_rgb_and_blackbody_equal_jax(args):
    name, *a = args
    out, ref = getattr(tsp, name)(*a), getattr(jsp, name)(*a)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_white_round_trips():
    """An uplifted white under the reference white integrates back to white
    (tests/test_spectral.py's Monte-Carlo check), and the uplift of white is
    1 at every wavelength."""
    rng = np.random.default_rng(0)
    wl, pdf = tsp.sample_wavelengths(torch.from_numpy(
        rng.random(100_000, np.float32)))
    L = tsp.uplift_rgb(torch.ones((100_000, 3)), wl) * tsp.d65(wl)
    out = tsp.spectral_to_rgb(L, wl, pdf).mean(dim=0).numpy()
    np.testing.assert_allclose(out, 1.0, atol=0.03)
    grid = torch.linspace(380.0, 800.0, 64)
    np.testing.assert_allclose(tsp.uplift_rgb(torch.ones(3), grid).numpy(),
                               1.0, atol=5e-3)


# --- the scene file ----------------------------------------------------------

@pytest.mark.parametrize("value", ["400:0.5, 700:0.7",
                                   "380:0.1 500:0.9 780:0.3",
                                   "450:2.0,550:0.0,650:1.0"])
def test_wavelength_value_pairs_parse_as_the_jax_loader(value):
    out = txml._parse_spectrum("spectrum", value)
    ref = jxml._parse_spectrum("spectrum", value)
    assert len(out) == 3
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def _mc_xml(integrator):
    return (f'<scene version="0.6.0">{integrator}<shape type="rectangle">'
            '<bsdf type="diffuse"/></shape></scene>')


def test_multichannel_adopts_its_nested_integrator(tmp_path):
    path = tmp_path / "mc.xml"
    path.write_text(_mc_xml(chip_smoke.CLOTH_MULTICHANNEL))
    tls = txml.load_scene(str(path), device="cpu")
    jls = jxml.load_scene(str(path))
    assert tls.integrator == tcommon.IntegratorConfig(
        type=tcommon.PATH, max_depth=chip_smoke.CLOTH_DEPTH)
    assert tls.integrator.type == jls.integrator.type
    assert tls.integrator.max_depth == jls.integrator.max_depth
    assert tcommon.MULTICHANNEL == jcommon.MULTICHANNEL
    assert tcommon.DIM_WAVELENGTH == jcommon.DIM_WAVELENGTH
    path.write_text(_mc_xml('<integrator type="multichannel"/>'))
    with pytest.raises(ValueError, match="nested integrator"):
        txml.load_scene(str(path), device="cpu")


def test_render_multichannel_stacks_its_renders():
    b = tscene.SceneBuilder()
    tshapes.cornell_box(b)
    scene, static = b.build(device="cpu")
    sensor = tsensor.make_perspective(
        TTransform.look_at(chip_smoke.EYE, chip_smoke.AT, chip_smoke.UP),
        chip_smoke.FOV, 4, 4, device="cpu")
    cfgs = [tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=3),
            tcommon.IntegratorConfig(type=tcommon.DIRECT)]
    st = tapi.RenderSettings(width=4, height=4, spp=2)
    img = tapi.render_multichannel(scene, static, sensor, cfgs, st,
                                   device="cpu")
    assert img.shape == (4, 4, 6)
    for k, cfg in enumerate(cfgs):
        assert torch.equal(img[..., 3 * k:3 * k + 3],
                           tapi.render(scene, static, sensor, cfg, st,
                                       device="cpu"))


@pytest.mark.parametrize("entry", ["render_spectral", "render_multichannel"])
def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, entry):
    b = tscene.SceneBuilder()
    tshapes.cornell_box(b)
    scene, static = b.build(device="cpu")
    sensor = tsensor.make_perspective(
        TTransform.look_at(chip_smoke.EYE, chip_smoke.AT, chip_smoke.UP),
        chip_smoke.FOV, 2, 2, device="cpu")
    cfg = tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=2)
    st = tapi.RenderSettings(width=2, height=2, spp=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(tapi, entry)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(scene, static, sensor, [cfg] if entry.endswith("channel") else cfg,
           st)


# --- api.render_spectral -----------------------------------------------------

@pytest.fixture(scope="module")
def slab():
    """The dispersive slab through both packages' builders and spectral
    renders, with the port's ray count."""
    jscene_, jstatic = chip_smoke.spectral_scene(
        jscene.SceneBuilder(), jbsdf, jshapes, JTransform, CAUCHY_B).build()
    tscene_, tstatic = chip_smoke.spectral_scene(
        tscene.SceneBuilder(), tbsdf, tshapes, TTransform, CAUCHY_B).build(
        device="cpu")
    look = (chip_smoke.SPECTRAL_EYE, chip_smoke.SPECTRAL_AT, chip_smoke.UP)
    jsens = jsensor.make_perspective(JTransform.look_at(*look),
                                     chip_smoke.SPECTRAL_FOV, RES, RES)
    tsens = tsensor.make_perspective(TTransform.look_at(*look),
                                     chip_smoke.SPECTRAL_FOV, RES, RES,
                                     device="cpu")
    st = dataclasses.replace(japi.RenderSettings(), width=RES, height=RES,
                             spp=SPP)
    ref = np.asarray(japi.render_spectral(
        jscene_, jstatic, jsens,
        jcommon.IntegratorConfig(type=jcommon.PATH, max_depth=DEPTH), st))
    img, n = tapi.render_spectral(
        tscene_, tstatic, tsens,
        tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=DEPTH),
        tapi.RenderSettings(width=RES, height=RES, spp=SPP), device="cpu",
        with_stats=True)
    return dict(jscene=jscene_, tscene=tscene_, ref=ref, img=img.numpy(), n=n)


def test_slab_builds_as_the_jax_builder(slab):
    for path in FIELD_PATHS:
        ref = slab["jscene"]
        for p in path:
            ref = getattr(ref, p)
        np.testing.assert_array_equal(_leaf(slab["tscene"], path),
                                      np.asarray(ref), err_msg=".".join(path))
    assert slab["tscene"].materials.cauchy_b.tolist()[0] == pytest.approx(
        CAUCHY_B)


def test_render_spectral_matches_jax(slab):
    img, ref = slab["img"], slab["ref"]
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0.1
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-4)
    np.testing.assert_allclose(img, ref, atol=1e-4, rtol=1e-3)
    # a closest-hit and a shadow query per live lane and bounce: at least
    # the camera rays, at most two queries per lane and bounce
    assert RES * RES * SPP <= slab["n"] <= 2 * RES * RES * SPP * DEPTH
