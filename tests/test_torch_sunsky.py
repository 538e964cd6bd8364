"""Port parity, the sun and sky emitters: the Hosek-Wilkie data file, the
sky bake, the sun's position and irradiance, the published Hosek goldens,
the ``sun``, ``sky`` and ``sunsky`` elements through both loaders, and one
sunsky render, against the JAX package on the CPU.

Tolerances:
  * the data file, the baked maps, the sun's direction and irradiance and
    the loaded tables: exactly (the same float64 numpy in the same order of
    operations, cast to float32 at the end);
  * the twelve Hosek goldens: rtol 2e-5, tests/test_texture.py's (goldens
    from the authors' sample implementation);
  * the render (8x8, 4 spp, depth 3, box filter): the mean within 1e-4 and
    tv_rgb (the mean absolute difference of horizontally adjacent pixels)
    within 1e-3 relative per channel, chip_smoke.py's header limits.
"""
import concurrent.futures
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import sunsky as jsky
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import sunsky as tsky
from test_torch_materials import _both, _equal_tables

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke as cs  # noqa: E402

BAKE_RES = (8, 16)
# the sun at the centre of texel (2, 3) of the baked map, 33.75 degrees up,
# so that with_sun burns its disk into that texel
_TH, _PH = 2.5 / BAKE_RES[0] * np.pi, 3.5 / BAKE_RES[1] * 2.0 * np.pi
SUN = np.array([np.sin(_TH) * np.cos(_PH), np.cos(_TH),
                np.sin(_TH) * np.sin(_PH)])
RES, SPP, DEPTH = 8, 4, 3

# (year, month, day, hour, minute, second, latitude, longitude, timezone):
# the loader's default (Tokyo), a leap day, the southern summer solstice, an
# equinox sunrise, and an evening far north with the sun below the horizon
DATES = [
    (2010, 7, 10, 15.0, 0.0, 0.0, 35.6894, 139.6917, 9.0),
    (2024, 2, 29, 8.0, 30.0, 0.0, 48.85, 2.35, 1.0),
    (2023, 12, 21, 12.0, 0.0, 0.0, -33.87, 151.21, 11.0),
    (2000, 3, 20, 6.0, 15.0, 30.0, 51.5, -0.13, 0.0),
    (1999, 11, 1, 21.0, 45.0, 0.0, 64.1, -21.9, 0.0),
]

# tests/test_texture.py's goldens: (turbidity, albedo, sun elevation, view
# theta, azimuth, RGB before the CIE-Y normalization)
HOSEK_GOLDEN = [
    (4.0, 0.15, 0.6, 0.3, 0.0, (3.85052498, 5.45107833, 8.80297205)),
    (4.0, 0.15, 0.6, 0.9, 1.0, (5.39944245, 7.79958744, 12.0892184)),
    (4.0, 0.15, 0.6, 1.2, 2.5, (5.03433971, 8.45885053, 13.7761208)),
    (4.0, 0.15, 0.6, 1.45, 3.1, (11.823874, 16.8287968, 22.0529695)),
    (7.3, 0.4, 0.12, 0.3, 0.0, (1.57365911, 2.21159868, 2.96879558)),
    (7.3, 0.4, 0.12, 0.9, 1.0, (3.80908528, 4.44151448, 4.79796298)),
    (7.3, 0.4, 0.12, 1.2, 2.5, (4.66603491, 5.83937126, 5.99351018)),
    (7.3, 0.4, 0.12, 1.45, 3.1, (7.08138741, 7.66288417, 6.37979923)),
    (2.2, 0.0, 1.2, 0.3, 0.0, (7.80706112, 9.48526272, 13.7297417)),
    (2.2, 0.0, 1.2, 0.9, 1.0, (3.44111542, 6.09672245, 12.1218209)),
    (2.2, 0.0, 1.2, 1.2, 2.5, (3.89287952, 7.09948334, 13.6035187)),
    (2.2, 0.0, 1.2, 1.45, 3.1, (8.34042476, 13.1833071, 20.685514)),
]

_DATE = ('<integer name="year" value="2021"/><integer name="month" '
         'value="6"/><integer name="day" value="2"/><float name="hour" '
         'value="17.5"/><float name="latitude" value="40.4"/><float '
         'name="longitude" value="-3.7"/><float name="timezone" value="2"/>')
_SUN_DIR = '<vector name="sunDirection" x="0.3" y="0.5" z="-0.4"/>'
# each element with a 16x32 map
ELEMENTS = {
    "sky rgb albedo": (
        '<emitter type="sky"><integer name="resolution" value="32"/>'
        f'<float name="turbidity" value="5"/>{_SUN_DIR}'
        '<rgb name="albedo" value="0.1, 0.2, 0.3"/></emitter>'),
    "sky preetham": (
        '<emitter type="sky"><integer name="resolution" value="32"/>'
        f'<string name="model" value="preetham"/>{_DATE}'
        '<float name="skyScale" value="0.5"/></emitter>'),
    "sun": (f'<emitter type="sun">{_DATE}<float name="turbidity" value="2"/>'
            '<float name="sunScale" value="0.3"/></emitter>'),
    "sunsky": (
        '<emitter type="sunsky"><integer name="resolution" value="32"/>'
        f'{_SUN_DIR}<float name="albedo" value="0.35"/><boolean '
        'name="extend" value="false"/><float name="scale" value="2"/>'
        '</emitter>'),
}
RENDER_XML = f"""<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="{DEPTH}"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 1.2, -3" target="0, 0.3, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sampleCount" value="{SPP}"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="{RES}"/>
      <integer name="height" value="{RES}"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="3"/><rotate x="1" angle="-90"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.45, 0.4"/>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/><float name="radius" value="0.5"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.3, 0.5, 0.7"/>
    </bsdf>
  </shape>
  {ELEMENTS["sunsky"].replace('value="false"', 'value="true"')}
</scene>
"""


@pytest.fixture(scope="module")
def render_files(tmp_path_factory):
    """The render's file, loaded by both loaders, and the JAX one-sample
    render pass compiled in a thread while the module's other tests run."""
    path = tmp_path_factory.mktemp("sky") / "sky.xml"
    path.write_text(RENDER_XML)
    jls = jxml.load_scene(str(path))
    st = japi.RenderSettings(width=RES, height=RES, spp=1, spp_per_pass=1,
                             filter_type=0)

    def one_pass(scene_, film_data, s):
        return japi.render_pass(scene_, jls.static, jls.sensor, jls.integrator,
                                st, jfilm.Film(film_data), s, 1).data

    lowered = jax.jit(one_pass).trace(jls.scene, jnp.zeros((RES, RES, 4)),
                                      jnp.int32(0)).lower()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield path, jls, pool.submit(lowered.compile)


@pytest.fixture(scope="module", autouse=True)
def start_the_compile(render_files):
    """The render's JAX compile starts before the module's first test."""


@pytest.mark.parametrize("key", ["coefs", "rads"])
def test_hosek_data_equals_jax(key):
    ref = np.load(REPO / "mitsuba_tpu" / "data" / "hosek_rgb.npz")
    out = np.load(REPO / "mitsuba_tpu_torch" / "data" / "hosek_rgb.npz")
    assert sorted(out.files) == sorted(ref.files) == ["coefs", "rads"]
    assert out[key].dtype == ref[key].dtype
    np.testing.assert_array_equal(out[key], ref[key])


@pytest.mark.parametrize(
    "model,extend,albedo,turbidity,with_sun", list(itertools.product(
        ("hosek", "preetham"), (True, False),
        ((0.25, 0.25, 0.25), (0.1, 0.3, 0.6)), (1.0, 3.0, 10.0),
        (False, True))))
def test_bake_equals_jax(model, extend, albedo, turbidity, with_sun):
    kw = dict(turbidity=turbidity, resolution=BAKE_RES, scale=1.5,
              with_sun=with_sun, sun_scale=0.7, extend_below=extend,
              model=model, albedo=albedo)
    ref = jsky.bake_sky_envmap(SUN, **kw)
    out = tsky.bake_sky_envmap(SUN, **kw)
    assert out.dtype == ref.dtype == np.float32 and out.shape == BAKE_RES + (3,)
    # Preetham's fit holds from turbidity 2: at 1 its Perez normalisation
    # turns the XYZ negative and the clip to RGB >= 0 leaves a black sky,
    # in both packages
    assert out.max() > 0 or (model == "preetham" and turbidity < 2)
    if with_sun:  # the disk's texel and only it
        kw["with_sun"] = False
        lit = np.any(out != tsky.bake_sky_envmap(SUN, **kw), axis=-1)
        assert np.argwhere(lit).tolist() == [[2, 3]]
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("date", DATES, ids=lambda d: f"{d[0]}-{d[1]}-{d[2]}")
def test_sun_position_and_irradiance_equal_jax(date):
    ref = jsky.sun_direction(*date)
    out = tsky.sun_direction(*date)
    np.testing.assert_array_equal(out, ref)
    for turb in (2.0, 6.5):
        np.testing.assert_array_equal(
            tsky.sun_directional_irradiance(out, turb, 0.8),
            jsky.sun_directional_irradiance(ref, turb, 0.8))
    if date[3] == 21.0:  # the northern evening: below the horizon, no sun
        assert out[1] < 0
        assert not tsky.sun_directional_irradiance(out).any()


@pytest.mark.parametrize("turb,alb,elev,theta,az,rgb", HOSEK_GOLDEN)
def test_hosek_goldens(turb, alb, elev, theta, az, rgb):
    s = np.array([np.cos(elev), np.sin(elev), 0.0])
    d = np.array([np.sin(theta) * np.cos(az), np.cos(theta),
                  np.sin(theta) * np.sin(az)])
    out = tsky.hosek_sky_radiance_rgb(d, s, turb, albedo=(alb,) * 3)
    np.testing.assert_allclose(out * 106.856980, rgb, rtol=2e-5)


@pytest.mark.parametrize("case", sorted(ELEMENTS))
def test_elements_load_as_the_jax_loaders(tmp_path, case):
    path = tmp_path / "s.xml"
    path.write_text(f'<scene version="0.6.0">{ELEMENTS[case]}</scene>')
    _, tls, ref, ref_static = _both(path)
    _equal_tables(tls, ref, ref_static)
    want = {"sun": [4], "sunsky": [3, 4]}.get(case, [3])
    assert tls.scene.emitters.type.tolist() == want
    if 3 in want:
        assert tls.scene.emitters.env_hw.tolist() == [16, 32]


def test_sunsky_render_matches_jax(render_files):
    path, jls, compiled = render_files
    tls = txml.load_scene(str(path), device="cpu")
    assert tls.static.emitter_types == (3, 4)
    img = tapi.render(tls.scene, tls.static, tls.sensor, tls.integrator,
                      tls.settings, device="cpu")
    one_pass = compiled.result()
    film = jnp.zeros((RES, RES, 4))
    for s in range(SPP):
        film = one_pass(jls.scene, film, jnp.int32(s))
    ref = np.asarray(jfilm.develop(jfilm.Film(film)), np.float64)
    img = img.numpy().astype(np.float64)
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-2
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=cs.HEADER_MEAN_RTOL)

    def tv(x):
        return np.abs(x[:, 1:] - x[:, :-1]).mean(axis=(0, 1))

    np.testing.assert_allclose(tv(img), tv(ref), rtol=cs.HEADER_TV_RTOL)
