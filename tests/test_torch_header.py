"""Port parity for the scene file's sensor header: the six reconstruction
filters (``render/rfilter.py`` through ``film.splat_grid``), the ao and
field integrators (``render/integrators/misc.py``), the loader's
``<sampler>``, ``<rfilter>`` and ``<integrator type="ao|field">`` elements,
and renders through them, against the JAX package on the CPU.

Tolerances, each from the gap measured between the two packages:
- ``eval_1d``: box, tent, Mitchell and Catmull-Rom bit for bit (the JAX side
  runs eagerly, one rounding per operation, as the port); Gaussian and
  Lanczos within 2.4e-7 absolute (two float32 ulps at 1.0): XLA's exp and
  sin differ from PyTorch's by an ulp (measured: 6e-8 and 1.2e-7);
- ``splat_grid`` (the JAX side jitted, as render_pass runs it; the same tap
  order): rtol 1e-5, atol 2e-5. Inside the jit XLA contracts the cubic
  filters' polynomials into FMAs (their weights move by up to 6.4e-7); the
  largest gap measured in the films is 1.08e-5 absolute (Mitchell);
- ``li_field``: test_torch_render.py's TOL (rtol 1e-5, atol 1e-6) on the
  float fields, the primitive index exactly; ``li_ao``: every lane's value
  and the ray count exactly (a visibility ray flipping between the
  packages would move a lane by 1/n; none does at 8x8);
- renders at 8x8: means within 1e-4 relative, every pixel within atol 1e-4 /
  rtol 1e-3, equal ray counts. Measured gaps: 2.4e-7 relative in the means
  and 2.4e-6 absolute per pixel for the ldsampler + Mitchell cbox.xml, 0 for
  ao with the halton sampler (its digit sums are contracted into FMAs by
  XLA inside the jitted render, but every lane's 0/1 visibility agrees).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import rfilter as jrfilter
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu.render.integrators import misc as jmisc
from mitsuba_tpu_torch.__main__ import main as cli_main
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.io import image as timage
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import film as tfilm
from mitsuba_tpu_torch.render import rfilter as trfilter
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render.integrators import common as tcommon
from mitsuba_tpu_torch.render.integrators import misc as tmisc
from test_torch_sampler import jax_sampler  # noqa: F401 (a fixture)
from test_torch_scenefile import jax_render

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "scripts")]
from jax_header_ref_mean import variant_xml  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
FILTERS = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")
FILTER_TAGS = {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 3,
               "catmullrom": 4, "lanczos": 5}
TRANSCENDENTAL = ("gaussian", "lanczos")


# --- filters ----------------------------------------------------------------

@pytest.mark.parametrize("name", FILTERS)
def test_eval_1d_matches_jax(name):
    """Every filter on a grid over [-4, 4] with the knots and the sinc's
    guard (|x| < 1e-6 / pi); the radius and footprint as in JAX."""
    f = FILTER_TAGS[name]
    x = np.concatenate([np.linspace(-4, 4, 2001, dtype=np.float32),
                        np.float32([0, 1e-7, -3e-7, 0.5, 1, 2, 3, -3,
                                    2.9999998, 1.0000001])])
    ref = np.asarray(jrfilter.eval_1d(f, jnp.asarray(x)))
    out = trfilter.eval_1d(f, torch.from_numpy(x)).numpy()
    if name in TRANSCENDENTAL:
        np.testing.assert_allclose(out, ref, rtol=0, atol=2.4e-7)
    else:
        np.testing.assert_array_equal(out, ref)
    assert trfilter.RADIUS[f] == jrfilter.RADIUS[f]
    assert trfilter.footprint(f) == jrfilter.footprint(f)


def test_negative_lobes_are_kept():
    """Mitchell, Catmull-Rom and Lanczos weigh samples negatively past
    their first zero; the weights are not clamped."""
    x = torch.tensor([1.5, 1.5, 1.5])
    for f in (trfilter.MITCHELL, trfilter.CATMULLROM):
        assert trfilter.eval_1d(f, x)[0] < 0
    assert trfilter.eval_1d(trfilter.LANCZOS, torch.tensor([1.5]))[0] < 0


SPLAT_H, SPLAT_W = 9, 13
SPLAT_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module")
def splats():
    """The inputs of the splat tests (a NaN and a negative sample that carry
    no weight among them) and the JAX package's film under each filter, all
    six from one jitted call, as render_pass runs splat_grid."""
    rs = np.random.default_rng(5)
    pos = (np.stack(np.meshgrid(np.arange(SPLAT_W), np.arange(SPLAT_H)), -1)
           + rs.random((SPLAT_H, SPLAT_W, 2))).astype(np.float32)
    val = rs.random((SPLAT_H, SPLAT_W, 3)).astype(np.float32) * 3
    val[0, 0, 1] = np.nan
    val[3, 4, 2] = -1.0
    prior = rs.random((SPLAT_H, SPLAT_W, 4)).astype(np.float32)
    films = jax.jit(lambda f, p, v: [
        jfilm.splat_grid(jfilm.Film(f), p, v, t, 0).data
        for t in FILTER_TAGS.values()])(prior, pos, val)
    return prior, pos, val, dict(zip(FILTER_TAGS, films))


@pytest.mark.parametrize("name", FILTERS)
def test_splat_grid_matches_jax(splats, name):
    """splat_grid and develop under each filter (Lanczos: 7x7 taps)."""
    prior, pos, val, films = splats
    ref = np.asarray(films[name])
    out = tfilm.splat_grid(tfilm.Film(torch.from_numpy(prior)),
                           torch.from_numpy(pos), torch.from_numpy(val),
                           FILTER_TAGS[name])
    np.testing.assert_allclose(out.data.numpy(), ref, **SPLAT_TOL)
    np.testing.assert_allclose(
        tfilm.develop(out).numpy(),
        ref[..., :3] / np.maximum(ref[..., 3:], np.float32(1e-12)),
        **SPLAT_TOL)


# --- the ao and field integrators -------------------------------------------

@pytest.fixture(scope="module")
def variant_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("header") / "cbox_ld_mitchell.xml"
    path.write_text(variant_xml("ldsampler", "mitchell"))
    return str(path)


@pytest.fixture(scope="module")
def loaded(variant_file):
    """cbox.xml with the ldsampler and the Mitchell filter, 8x8, 4 spp,
    through both loaders."""
    defines = {"spp": 4, "res": 8}
    return (jxml.load_scene(variant_file, defines),
            txml.load_scene(variant_file, defines, device="cpu"))


@pytest.fixture(scope="module")
def rays8(loaded):
    """The 64 camera rays through the pixel centres of the 8x8 view (the
    port's sensor's, given to both packages)."""
    _, tls = loaded
    c = (torch.arange(8, dtype=torch.float32) + 0.5) / 8
    uv = torch.stack(torch.meshgrid(c, c, indexing="xy"), -1).reshape(-1, 2)
    o, d = tsensor.sample_ray(tls.sensor, uv, torch.zeros(64, 2))
    return o.numpy().copy(), d.numpy().copy()


FIELDS = ("position", "normal", "sh_normal", "uv", "albedo", "distance",
          "prim_index", "geo_normal")
# (sampler, ray_length, shading_samples); the box is 560 units wide
AO_CASES = {"ldsampler-default-length": ("ldsampler", -1.0, 1),
            "independent-60": ("independent", 60.0, 1),
            "halton-60-x3": ("halton", 60.0, 3)}
AO_SAMPLES = 4


@pytest.mark.parametrize("field", FIELDS)
def test_li_field_matches_jax(loaded, rays8, field):
    jls, tls = loaded
    o, d = rays8
    f = getattr(tcommon, f"FIELD_{field.upper()}")
    assert f == getattr(jcommon, f"FIELD_{field.upper()}")
    ref = np.asarray(jmisc.li_field(
        jls.scene, jls.static,
        jcommon.IntegratorConfig(type=jcommon.FIELD, field=f),
        jnp.asarray(o), jnp.asarray(d), 0, jnp.arange(64), 0))
    out, n = tmisc.li_field(
        tls.scene, tls.static,
        tcommon.IntegratorConfig(type=tcommon.FIELD, field=f),
        torch.from_numpy(o), torch.from_numpy(d), 0, torch.arange(64), 0,
        with_stats=True)
    if field == "prim_index":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert int(n) == 64 and out.shape == (64, 3)


@pytest.mark.parametrize("case", AO_CASES)
def test_li_ao_matches_jax(loaded, rays8, jax_sampler, case):
    """ao at the 64 camera hits, samples 0-3; the ray count is the camera
    rays plus a shadow ray per shading sample of each lane that hits."""
    jls, tls = loaded
    o, d = rays8
    name, length, n_sh = AO_CASES[case]
    settings = tapi.RenderSettings(
        spp=AO_SAMPLES, sampler_type=getattr(tapi, name.upper()), seed=3)
    jax_sampler(settings)  # the API's numbering is the JAX API's
    smp = tapi.sampler_of(settings)
    jcfg = jcommon.IntegratorConfig(type=jcommon.AO, ray_length=length,
                                    shading_samples=n_sh)
    tcfg = tcommon.IntegratorConfig(type=tcommon.AO, ray_length=length,
                                    shading_samples=n_sh)
    pix = np.arange(64, dtype=np.int32)
    for s in range(AO_SAMPLES):
        ref = np.asarray(jmisc.li_ao(jls.scene, jls.static, jcfg,
                                     jnp.asarray(o), jnp.asarray(d), 3,
                                     jnp.asarray(pix), s))
        out, n = tmisc.li_ao(tls.scene, tls.static, tcfg, torch.from_numpy(o),
                             torch.from_numpy(d), smp,
                             torch.from_numpy(pix).long(), s, with_stats=True)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert int(n) == 64 + n_sh * 64  # every camera ray hits the box
    assert 0.0 < ref.mean() < 1.0


# --- the loader ---------------------------------------------------------------

SAMPLERS = ("independent", "stratified", "ldsampler", "sobol", "halton",
            "hammersley", "faure")
HEADERS = {
    **{f"sampler-{t}": (f'<sampler type="{t}"><integer name="sampleCount" '
                        'value="9"/></sampler>', "") for t in SAMPLERS},
    **{f"rfilter-{t}": ("", f'<rfilter type="{t}"/>') for t in FILTERS},
}
INTEGRATORS = {
    "ao": '<integrator type="ao"><float name="rayLength" value="0.25"/>'
          '<integer name="shadingSamples" value="4"/></integrator>',
    "ao-defaults": '<integrator type="ao"/>',
    "field": '<integrator type="field"/>',
}
HEADER_SETTINGS = ("width", "height", "spp", "filter_type", "sampler_type",
                   "spp_per_pass", "seed")
INTEGRATOR_FIELDS = ("type", "max_depth", "rr_depth", "hide_emitters",
                     "emitter_samples", "bsdf_samples", "ray_length",
                     "shading_samples", "field")
SHAPE = '<shape type="rectangle"/>'


def _pair(tmp_path, body):
    path = tmp_path / "s.xml"
    path.write_text(f'<scene version="0.6.0">{body}{SHAPE}</scene>')
    return (jxml.load_scene(str(path)),
            txml.load_scene(str(path), device="cpu"))


@pytest.mark.parametrize("case", HEADERS)
def test_loader_sensor_header_matches_jax(tmp_path, case):
    samp, rf = HEADERS[case]
    jls, tls = _pair(tmp_path, '<sensor type="perspective">' + samp
                     + f'<film type="hdrfilm">{rf}</film></sensor>')
    for f in HEADER_SETTINGS:
        assert getattr(tls.settings, f) == getattr(jls.settings, f), f


@pytest.mark.parametrize("case", INTEGRATORS)
def test_loader_integrator_matches_jax(tmp_path, case):
    jls, tls = _pair(tmp_path, INTEGRATORS[case])
    for f in INTEGRATOR_FIELDS:
        assert getattr(tls.integrator, f) == getattr(jls.integrator, f), f


# --- renders against the JAX package ------------------------------------------

@pytest.fixture(scope="module")
def renders(loaded):
    """Two JAX render compiles: cbox.xml with the ldsampler and the Mitchell
    filter (8x8, 4 spp, path depth 5), and ao on the same scene with the
    halton sampler (8x8, 4 spp, the default ray length, box filter); each
    also through the port. Restores the JAX sampler global after them."""
    jls, tls = loaded
    ao_settings = dict(filter_type=0, sampler_type=tapi.HALTON, seed=1)
    try:
        out = {}
        for name, (jcfg, tcfg, st) in {
                "cbox_ld_mitchell": (jls.integrator, tls.integrator, {}),
                "ao_halton": (jcommon.IntegratorConfig(type=jcommon.AO),
                              tcommon.IntegratorConfig(type=tcommon.AO),
                              ao_settings)}.items():
            ref, n_ref = jax_render(jls.scene, jls.static, jls.sensor, jcfg,
                                    dataclasses.replace(jls.settings, **st))
            img, n = tapi.render(tls.scene, tls.static, tls.sensor, tcfg,
                                 dataclasses.replace(tls.settings, **st),
                                 device="cpu", with_stats=True)
            out[name] = (ref, img.numpy(), n_ref, n)
        return out
    finally:
        jrng.set_sampler(jrng.INDEPENDENT, n=16)


RENDERS = ("cbox_ld_mitchell", "ao_halton")


@pytest.mark.parametrize("name", RENDERS)
def test_render_means_match_jax(renders, name):
    ref, img, _, _ = renders[name]
    assert img.shape == ref.shape == (8, 8, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-4)


@pytest.mark.parametrize("name", RENDERS)
def test_render_pixels_match_jax(renders, name):
    ref, img, _, _ = renders[name]
    np.testing.assert_allclose(img, ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("name", RENDERS)
def test_render_ray_counts_match_jax(renders, name):
    _, img, n_ref, n = renders[name]
    assert n == n_ref and n > img.shape[0] * img.shape[1]


def test_cli_renders_the_header_variant(tmp_path, variant_file):
    """python -m mitsuba_tpu_torch renders the ldsampler + Mitchell file:
    its image equals api.render's bit for bit."""
    out = tmp_path / "out.pfm"
    assert cli_main([variant_file, "-D", "spp=2", "-D", "res=8", "--cpu",
                     "-z", "-L", "error", "-o", str(out)]) == 0
    ls = txml.load_scene(variant_file, {"spp": 2, "res": 8}, device="cpu")
    assert ls.settings.sampler_type == tapi.LDSAMPLER
    assert ls.settings.filter_type == trfilter.MITCHELL
    ref = tapi.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                      ls.settings, device="cpu").numpy()
    np.testing.assert_array_equal(timage.read_pfm(str(out)), ref)


def test_ao_sees_white_where_the_camera_escapes(loaded):
    """ao's value is 1 on a lane whose camera ray leaves the scene; the
    other lane's one shadow ray is the only other query."""
    _, tls = loaded
    o = torch.tensor([[278.0, 273.0, -800.0]] * 2)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    L, n = tmisc.li_ao(tls.scene, tls.static,
                       tcommon.IntegratorConfig(type=tcommon.AO), o, d,
                       trng.Sampler(kind=trng.LD), torch.arange(2), 0,
                       with_stats=True)
    assert L[0].tolist() == [1.0, 1.0, 1.0] and int(n) == 3
