"""Port parity for the scene-file entry points: ``io/mitsuba_xml.load_scene``,
``python -m mitsuba_tpu_torch``, ``io/image`` and the renders they drive
(``scenes/cbox.xml`` through the path tracer, the Cornell box through the
direct integrator, a scene without triangles), against the JAX package on the
CPU.

Tolerances: loaded scenes, sensors, settings and integrator configs exactly
(the same numpy arithmetic, cast to float32 at the end); renders as in
test_torch_render.py: image means within 1e-3 relative, >= 99% of pixels
within atol 1e-4 / rtol 1e-3, equal ray-query counts; image files bit for
bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.io import image as jimage
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu.render.integrators import path as jpath
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.__main__ import main as cli_main
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.io import image as timage
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_render import FIELD_PATHS, _leaf, jax_scene_arrays

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CBOX = str(REPO / "scenes" / "cbox.xml")
CBOX_DEFINES = {"spp": 4, "res": 8}
CFG_FIELDS = ("type", "max_depth", "rr_depth", "hide_emitters",
              "emitter_samples", "bsdf_samples", "ray_length",
              "shading_samples", "field")
SETTINGS_FIELDS = ("width", "height", "spp", "filter_type", "sampler_type",
                   "spp_per_pass", "seed")

# test_io.py:test_xml_include's scene: a sphere (the default gray diffuse,
# albedo 0.5) under a constant emitter of radiance 1, no triangle
INC_XML = ('<scene version="0.5.0">'
           '<shape type="sphere"><float name="radius" value="0.5"/></shape>'
           "</scene>")
MAIN_XML = ('<scene version="0.5.0">'
            '<include filename="inc.xml"/>'
            '<emitter type="constant"><spectrum name="radiance" value="1"/>'
            "</emitter></scene>")
# a smaller sphere under the emitter, which the path tracer hides from the
# camera (hideEmitters)
HIDDEN_XML = ('<scene version="0.6.0"><integrator type="path">'
              '<boolean name="hideEmitters" value="true"/></integrator>'
              '<shape type="sphere"><float name="radius" value="0.25"/>'
              '</shape><emitter type="constant"/></scene>')
# cases 1 and 2 of the loader: a two-sided diffuse, a cube, a disk (its
# transform flips the winding) and a constant emitter; an unknown element,
# shape type, emitter type and top-level BSDF, which both loaders skip
MIX_XML = """<scene version="0.6.0">
  <default name="albedo" value="0.3, 0.6, 0.2"/>
  <integrator type="direct">
    <integer name="emitterSamples" value="2"/>
    <integer name="bsdfSamples" value="3"/>
    <boolean name="hideEmitters" value="true"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="50"/>
    <string name="fovAxis" value="y"/>
    <transform name="toWorld">
      <lookat origin="0, 1, -4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="3"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="12"/><integer name="height" value="6"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <bsdf type="twosided" id="green">
    <bsdf type="diffuse"><rgb name="reflectance" value="$albedo"/></bsdf>
  </bsdf>
  <bsdf type="unknownbsdf" id="odd"/>
  <unknownelement/>
  <shape type="cube">
    <transform name="toWorld">
      <scale value="0.5"/><rotate y="1" angle="30"/>
      <translate x="0.2" y="0.1" z="0.3"/>
    </transform>
    <ref id="green"/>
  </shape>
  <shape type="disk">
    <transform name="toWorld">
      <scale x="2" y="-2" z="1"/><rotate x="1" angle="-90"/>
    </transform>
    <bsdf type="roughconductor">
      <string name="material" value="au"/>
      <string name="distribution" value="ggx"/>
      <float name="alpha" value="0.2"/>
    </bsdf>
  </shape>
  <shape type="hair"/>
  <shape type="sphere">
    <point name="center" x="-0.8" y="0.3" z="0"/>
    <float name="radius" value="0.3"/>
    <bsdf type="dielectric"><float name="intIOR" value="1.33"/></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.5, 0.6, 0.7"/></emitter>
  <emitter type="strange"/>
</scene>
"""


def _scene_xml(body: str) -> str:
    return f'<scene version="0.6.0">{body}</scene>'


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    (d / "inc.xml").write_text(INC_XML)
    (d / "main.xml").write_text(MAIN_XML)
    (d / "mix.xml").write_text(MIX_XML)
    (d / "hidden.xml").write_text(HIDDEN_XML)
    return {"cbox": (CBOX, CBOX_DEFINES), "include": (str(d / "main.xml"), {}),
            "mix": (str(d / "mix.xml"), {}),
            "hidden": (str(d / "hidden.xml"), {})}


@pytest.fixture(scope="module")
def loaded(scene_files):
    """Each scene file through both loaders: (JAX LoadedScene, the port's)."""
    return {name: (jxml.load_scene(path, defines),
                   txml.load_scene(path, defines, device="cpu"))
            for name, (path, defines) in scene_files.items()}


SCENES = ("cbox", "include", "mix", "hidden")


@pytest.mark.parametrize("name", SCENES)
def test_loaded_scene_equals_the_jax_loaders(loaded, name):
    """Field by field and exactly: the port's loader against the JAX
    loader's scene carried over by the bridge."""
    jls, tls = loaded[name]
    ref, _ = bridge.scene_from_arrays(
        jax_scene_arrays(jls.scene), dataclasses.asdict(jls.static),
        device="cpu")
    for path in FIELD_PATHS:
        a, b = _leaf(tls.scene, path), _leaf(ref, path)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=".".join(path))


@pytest.mark.parametrize("name", SCENES)
def test_loaded_static_equals_the_jax_loaders(loaded, name):
    jls, tls = loaded[name]
    _, ref = bridge.scene_from_arrays(
        jax_scene_arrays(jls.scene), dataclasses.asdict(jls.static),
        device="cpu")
    assert tls.static == ref


@pytest.mark.parametrize("name", SCENES)
def test_loaded_sensor_equals_the_jax_loaders(loaded, name):
    jls, tls = loaded[name]
    ref = bridge.sensor_from_arrays(
        {f: np.asarray(getattr(jls.sensor, f)) for f in jls.sensor._fields},
        device="cpu")
    assert tls.sensor.type == ref.type
    for f in ref._fields[1:]:
        np.testing.assert_array_equal(getattr(tls.sensor, f).numpy(),
                                      getattr(ref, f).numpy(), err_msg=f)


@pytest.mark.parametrize("name", SCENES)
def test_loaded_settings_and_integrator_equal_the_jax_loaders(loaded, name):
    jls, tls = loaded[name]
    for f in SETTINGS_FIELDS:
        assert getattr(tls.settings, f) == getattr(jls.settings, f), f
    for f in CFG_FIELDS:
        assert getattr(tls.integrator, f) == getattr(jls.integrator, f), f


def test_mix_scene_reads_what_it_says(loaded):
    """The parts the mix scene exercises did reach the loaders."""
    _, tls = loaded["mix"]
    assert tls.integrator == tcommon.IntegratorConfig(
        type=tcommon.DIRECT, max_depth=-1, hide_emitters=True,
        emitter_samples=2, bsdf_samples=3)
    assert tls.static.n_spheres == 1 and tls.static.n_tris == 12 + 64
    assert tls.static.bsdf_types == (0, 1, 3)
    assert bool(tls.scene.materials.twosided[0])
    assert (tls.settings.width, tls.settings.height) == (12, 6)


# --- the loader's case 3: elements the port does not render yet -----------

def _sensor(inner="", stype="perspective", film=""):
    return (f'<sensor type="{stype}">{inner}<film type="hdrfilm">{film}'
            "</film></sensor>")


def _shape_bsdf(bsdf):
    return f'<shape type="rectangle">{bsdf}</shape>'


CASE3 = {
    **{f"integrator-{t}": f'<integrator type="{t}"/>'
       for t in ("vpl", "sppm", "photonmapper", "irrcache", "adaptive")},
    "bitmap-png": '<texture type="bitmap"><string name="filename" '
                  'value="tex.png"/></texture>',
}


# the nested and layered elements and the procedural textures, which
# raised here until the port rendered them: each loads, under the id it had
# (tests/test_torch_nested.py holds every one against the JAX loader)
NESTED = {
    "bsdf-coating": (_shape_bsdf('<bsdf type="coating"/>'), "materials",
                     tbsdf.COATING),
    "bsdf-mask": (_shape_bsdf('<bsdf type="mask"><bsdf type="diffuse"/>'
                              '</bsdf>'), "materials", tbsdf.MASK),
    **{f"texture-{t}": (f'<texture type="{t}"/>', "textures", tag)
       for t, tag in (("checkerboard", 1), ("gridtexture", 3),
                      ("scale", 0))},
}


# the delta lights and the sensors, which raised here until the port
# rendered them: each loads, under the id it had (tests/test_torch_lights.py
# holds every one against the JAX loader): an emitter's or the sensor's type
LIGHTS = {
    **{f"sensor-{t}": (_sensor(stype=t), "sensor", tag)
       for t, tag in (("thinlens", 1), ("orthographic", 2), ("spherical", 3),
                      ("radiancemeter", 4), ("irradiancemeter", 5))},
    **{f"emitter-{t}": (f'<emitter type="{t}"/>', "emitters", tag)
       for t, tag in (("point", 1), ("directional", 4), ("spot", 5),
                      ("collimated", 6))},
    "shape-meter": ('<shape type="rectangle"><sensor '
                    'type="irradiancemeter"/></shape>', "sensor", 5),
}


# the woven cloth, the spectra and the multichannel integrator, which
# raised here until the port rendered them: each loads
# (tests/test_torch_cloth.py and tests/test_torch_spectral.py hold them
# against the JAX package): the material's type, the integrator's type or
# the reflectance's RGB
PAIRS = "400:0.5, 700:0.7"
CLOTH_SPECTRA = {
    "bsdf-toplevel-irawan": ('<bsdf type="irawan"/>', tbsdf.IRAWAN),
    "bsdf-irawan-cloth": (_shape_bsdf(
        '<bsdf type="irawan"><string name="filename" value="w.cloth"/>'
        '</bsdf>'), tbsdf.IRAWAN),
    "integrator-multichannel": ('<integrator type="multichannel"><integrator '
                                'type="direct"/></integrator>',
                                tcommon.DIRECT),
    "spectrum-pairs": (_shape_bsdf('<bsdf type="diffuse"><spectrum '
                                   f'name="reflectance" value="{PAIRS}"/>'
                                   '</bsdf>'),
                       jxml._parse_spectrum("spectrum", PAIRS)),
}


# the volumetric integrators and the media, which raised here until the
# port rendered them: each loads (tests/test_torch_volume.py holds them
# against the JAX loader): the integrator's type, or the medium table's
# types and the materials' interior media
MEDIA = {
    **{f"integrator-{t}": (f'<integrator type="{t}"/>', tcommon.VOLPATH)
       for t in ("volpath", "volpath_simple")},
    "medium": ('<medium type="homogeneous"/>', ([0], [])),
    "shape-medium": ('<shape type="rectangle"><medium name="interior" '
                     'type="homogeneous"/></shape>', ([0], [0])),
}


# the sun and sky emitters, which raised here until the port rendered them:
# each loads, under the id it had (tests/test_torch_sunsky.py holds every one
# against the JAX loader): the emitter table's types, the baked map's height
# and width (the default resolution 256), and the sun's direction
SKY = {f"emitter-{t}": (f'<emitter type="{t}"/>', want)
       for t, want in (("sky", [3]), ("sun", [4]), ("sunsky", [3, 4]))}


# the particle tracer, the bidirectional tracer and the Metropolis family,
# which raised here until the port rendered them: each loads as its
# integrator type (tests/test_torch_ptracer.py, tests/test_torch_bdpt.py,
# tests/test_torch_pssmlt.py and tests/test_torch_mlt.py hold them against
# the JAX package)
BIDIR = {f"integrator-{t}": (f'<integrator type="{t}"/>', tag)
         for t, tag in (("ptracer", 5), ("bdpt", 11), ("pssmlt", 12),
                        ("mlt", 15), ("erpt", 16))}


@pytest.mark.parametrize("case", sorted(CASE3) + sorted(NESTED)
                         + sorted(LIGHTS) + sorted(CLOTH_SPECTRA)
                         + sorted(MEDIA) + sorted(SKY) + sorted(BIDIR))
def test_later_slice_elements_raise(tmp_path, case):
    (tmp_path / "tex.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    (tmp_path / "w.cloth").write_text("weave { pattern { 1, 2, 2, 1 }, "
                                      "yarn { type = warp }, "
                                      "yarn { type = weft } }")
    path = tmp_path / "s.xml"
    if case in SKY:
        body, want = SKY[case]
        path.write_text(_scene_xml(body))
        ems = txml.load_scene(str(path), device="cpu").scene.emitters
        assert ems.type.tolist() == want
        if 3 in want:
            assert ems.env_hw.tolist() == [128, 256]
        if 4 in want:  # the default date, time and place's sun, above
            assert float(ems.direction[want.index(4), 1]) < 0.0
        return
    if case in BIDIR:
        body, want = BIDIR[case]
        path.write_text(_scene_xml(body))
        assert txml.load_scene(str(path), device="cpu").integrator.type == want
        return
    if case in MEDIA:
        body, want = MEDIA[case]
        path.write_text(_scene_xml(body))
        ls = txml.load_scene(str(path), device="cpu")
        if case.startswith("integrator"):
            assert ls.integrator.type == want
        else:
            inside = ls.scene.materials.interior_medium.tolist()
            assert ls.scene.media.type.tolist() == want[0]
            assert [m for m in inside if m >= 0] == want[1]
        return
    if case in CLOTH_SPECTRA:
        body, want = CLOTH_SPECTRA[case]
        path.write_text(_scene_xml(body))
        ls = txml.load_scene(str(path), device="cpu")
        if case.startswith("bsdf"):
            assert ls.scene.materials.type.tolist()[-1] == want
            assert ls.scene.irawan.tile_w.tolist() == [2]
            assert float(ls.scene.irawan.spec_norm[0]) > 0
        elif case.startswith("integrator"):
            assert ls.integrator.type == want
        else:
            np.testing.assert_array_equal(
                ls.scene.materials.albedo[-1].numpy(), np.asarray(want))
        return
    if case in LIGHTS:
        body, kind, tag = LIGHTS[case]
        path.write_text(_scene_xml(body))
        ls = txml.load_scene(str(path), device="cpu")
        if kind == "sensor":
            assert ls.sensor.type == tag
            meter = tag in (4, 5)
            assert ((ls.settings.width, ls.settings.height) == (1, 1)) == meter
        else:
            assert ls.scene.emitters.type.tolist() == [tag]
        return
    if case in NESTED:
        body, table, tag = NESTED[case]
        path.write_text(_scene_xml(body))
        ls = txml.load_scene(str(path), device="cpu")
        if table == "materials":
            assert tag in ls.scene.materials.type.tolist()
        else:  # a texture no material reads: no lookups, one row
            assert ls.scene.textures.type.tolist() == [tag]
        return
    path.write_text(_scene_xml(CASE3[case]))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        txml.load_scene(str(path), device="cpu")


# the single-layer BSDF elements, which raised here until the port rendered
# them: each loads into a material row of its type, in a shape or at the top
# level (tests/test_torch_materials.py holds every one against the JAX
# loader)
SINGLE_LAYER = {
    **{f"bsdf-{t}": (_shape_bsdf(f'<bsdf type="{t}"/>'), tag)
       for t, tag in (("roughdiffuse", tbsdf.ROUGH_DIFFUSE),
                      ("conductor", tbsdf.CONDUCTOR),
                      ("roughdielectric", tbsdf.ROUGH_DIELECTRIC),
                      ("thindielectric", tbsdf.THIN_DIELECTRIC),
                      ("phong", tbsdf.PHONG), ("ward", tbsdf.WARD),
                      ("difftrans", tbsdf.DIFFTRANS), ("hk", tbsdf.HK),
                      ("null", tbsdf.NULL))},
    "bsdf-toplevel-phong": ('<bsdf type="phong"/>', tbsdf.PHONG),
}


@pytest.mark.parametrize("case", sorted(SINGLE_LAYER))
def test_single_layer_bsdf_elements_load(tmp_path, case):
    body, tag = SINGLE_LAYER[case]
    path = tmp_path / "s.xml"
    path.write_text(_scene_xml(body))
    ls = txml.load_scene(str(path), device="cpu")
    assert tag in ls.scene.materials.type.tolist()
    assert tag in ls.static.bsdf_types


# the sensor header's elements, which raised here until the port rendered
# them: each loads and gives its setting (tests/test_torch_header.py holds
# every one against the JAX loader)
HEADER = {
    "integrator-ao": ('<integrator type="ao"/>', "integrator", "type",
                      tcommon.AO),
    "integrator-field": ('<integrator type="field"/>', "integrator", "type",
                         tcommon.FIELD),
    **{f"sampler-{t}": (_sensor(f'<sampler type="{t}"/>'), "settings",
                        "sampler_type", getattr(tapi, t.upper()))
       for t in ("stratified", "ldsampler", "sobol", "halton", "hammersley",
                 "faure")},
    **{f"rfilter-{t}": (_sensor(film=f'<rfilter type="{t}"/>'), "settings",
                        "filter_type", tag)
       for t, tag in (("tent", 1), ("mitchell", 3), ("catmullrom", 4),
                      ("lanczos", 5))},
}


@pytest.mark.parametrize("case", sorted(HEADER))
def test_sensor_header_elements_load(tmp_path, case):
    body, part, field_name, value = HEADER[case]
    path = tmp_path / "s.xml"
    path.write_text(_scene_xml(body))
    ls = txml.load_scene(str(path), device="cpu")
    assert getattr(getattr(ls, part), field_name) == value


# --- renders against the JAX package --------------------------------------

def jax_pass(static, sensor, cfg, settings):
    """jax_render's pass: one sample into the film, jitted, returning the
    film data and the pass's ray queries."""
    st = dataclasses.replace(settings, spp_per_pass=1)

    @jax.jit
    def one_pass(scene_, film_data, s):
        rays = []

        def li_path(*a, **k):
            L, n = jpath.li(*a, **k, with_stats=True)
            rays.append(n)
            return L

        def counted(fn):
            def query(sc, stc, o, d, t_min, t_max, active=None, **k):
                rays.append(o.shape[0] if active is None else active.sum())
                return fn(sc, stc, o, d, t_min, t_max, active=active, **k)
            return query

        with pytest.MonkeyPatch.context() as mp:
            if cfg.type == jcommon.PATH:
                mp.setattr(japi, "_li_fn", lambda c: li_path)
            else:
                mp.setattr(jscene, "ray_intersect",
                           counted(jscene.ray_intersect))
                mp.setattr(jscene, "occluded", counted(jscene.occluded))
            film = japi.render_pass(scene_, static, sensor, cfg, st,
                                    jfilm.Film(film_data), s, 1)
        return film.data, sum(jnp.asarray(n, jnp.float32) for n in rays)

    return one_pass


def jax_render(scene, static, sensor, cfg, settings, one_pass=None):
    """The JAX package's image, as japi.render makes it with one sample per
    pass, and the exact count of its ray queries, from one compile: the
    path tracer's own counter, or the direct integrator's queries counted
    lane by lane (its loops are plain Python, so the counts are outputs of
    the same trace). ``one_pass``: jax_pass's function of the same
    arguments, compiled already."""
    st = dataclasses.replace(settings, spp_per_pass=1)
    H, W = st.height, st.width
    one_pass = one_pass or jax_pass(static, sensor, cfg, st)
    film, n_rays = jnp.zeros((H, W, 4)), 0
    for s in range(st.spp):
        film, n = one_pass(scene, film, jnp.int32(s))
        n_rays += int(n)
    return np.asarray(jfilm.develop(jfilm.Film(film))), n_rays


def _pair(jls, tls, **settings):
    """(JAX image, port image, JAX ray count, port ray count) of a loaded
    scene pair, with ``settings`` replacing the loaded values."""
    ref, n_ref = jax_render(jls.scene, jls.static, jls.sensor, jls.integrator,
                            dataclasses.replace(jls.settings, **settings))
    img, n = tapi.render(tls.scene, tls.static, tls.sensor, tls.integrator,
                         dataclasses.replace(tls.settings, **settings),
                         device="cpu", with_stats=True)
    return ref, img.numpy(), n_ref, n


@pytest.fixture(scope="module")
def renders(loaded, cornell, cornell_cam):
    """cbox.xml through the path tracer (8x8, 4 spp, depth 5, its Gaussian
    filter); the Cornell box of the builders through the direct integrator
    (8x8, 4 spp, one emitter and one BSDF sample); the include scene (no
    triangle) and the hidden-emitter scene at 8x8, 4 spp."""
    small = dict(width=8, height=8, spp=4)
    out = {"cbox": _pair(*loaded["cbox"]),
           "include": _pair(*loaded["include"], **small),
           "hidden": _pair(*loaded["hidden"], **small)}
    b = tscene.SceneBuilder()
    tshapes.cornell_box(b)
    scene, static = b.build(device="cpu")
    W = H = 8
    js = jsensor.make_perspective(cornell_cam, 39.0, W, H)
    ts = tsensor.make_perspective(
        Transform.look_at([0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0]),
        39.0, W, H, device="cpu")
    st = dict(width=W, height=H, spp=4, spp_per_pass=4)
    ref, n_ref = jax_render(cornell[0], cornell[1], js,
                            jcommon.IntegratorConfig(type=jcommon.DIRECT),
                            japi.RenderSettings(**st))
    img, n = tapi.render(scene, static, ts,
                         tcommon.IntegratorConfig(type=tcommon.DIRECT),
                         tapi.RenderSettings(**st), device="cpu",
                         with_stats=True)
    out["cornell_direct"] = (ref, img.numpy(), n_ref, n)
    return out


RENDERS = ("cbox", "cornell_direct", "include", "hidden")


@pytest.mark.parametrize("name", RENDERS)
def test_render_means_match_jax(renders, name):
    ref, img, _, _ = renders[name]
    assert img.shape == ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-3)


@pytest.mark.parametrize("name", RENDERS)
def test_render_pixels_match_jax(renders, name):
    ref, img, _, _ = renders[name]
    close = np.isclose(img, ref, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


# the Cornell box's ray counts may differ by the NEE samples drawn from
# camera hits on the light, as in test_torch_render.py: the sample lies on
# the light's own plane, where the cos_l > 1e-7 test flips with the last bit
# of the hit point, and the camera rays of the two packages differ in the
# last bit (XLA's dot against torch's matmul). Such a sample carries nothing
# (the light's albedo is 0). Measured: 729 against 728, one lane of sample 0.
RAY_COUNT_RTOL = {"cbox": 0.0, "cornell_direct": 0.0025, "include": 0.0,
                  "hidden": 0.0}


@pytest.mark.parametrize("name", RENDERS)
def test_render_ray_counts_match_jax(renders, name):
    _, img, n_ref, n = renders[name]
    assert abs(n - n_ref) <= RAY_COUNT_RTOL[name] * n_ref
    assert n > img.shape[0] * img.shape[1]


def test_hidden_emitters_leave_the_background_black(renders):
    """hideEmitters: where the camera sees the constant emitter past the
    sphere the image is black; the sphere still shows its albedo."""
    _, img, _, _ = renders["hidden"]
    assert img[0, 0].max() == 0.0
    assert 0.3 < img[3:5, 3:5].mean() < 0.7


def test_triangle_free_sphere_shows_its_albedo(loaded):
    """A convex diffuse sphere (albedo 0.5) under a constant emitter of
    radiance 1 reflects 0.5 (no interreflection on a convex body), where
    the pixel's filter footprint lies on the sphere; the background shows
    the emitter's 1 exactly. 64 spp."""
    _, tls = loaded["include"]
    st = dataclasses.replace(tls.settings, width=8, height=8, spp=64,
                             spp_per_pass=16)
    img = tapi.render(tls.scene, tls.static, tls.sensor, tls.integrator, st,
                      device="cpu").numpy()
    centre = img[2:6, 2:6]
    np.testing.assert_allclose(centre.mean(axis=(0, 1)), 0.5, rtol=0.02)
    assert np.abs(centre - 0.5).max() < 0.1


# --- the CLI ---------------------------------------------------------------

def test_cli_writes_the_api_image(tmp_path):
    """python -m mitsuba_tpu_torch on the CPU writes the EXR that the JAX
    package's reader reads back, bit for bit the image of api.render."""
    out = tmp_path / "out.exr"
    subprocess.run(
        [sys.executable, "-m", "mitsuba_tpu_torch", CBOX, "-D", "spp=2",
         "-D", "res=8", "--cpu", "-z", "-L", "error", "-o", str(out)],
        cwd=REPO, check=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    ls = txml.load_scene(CBOX, {"spp": 2, "res": 8}, device="cpu")
    ref = tapi.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                      ls.settings, device="cpu").numpy()
    np.testing.assert_array_equal(jimage.read_exr(str(out)), ref)


def test_cli_skips_an_existing_output(tmp_path):
    out = tmp_path / "out.exr"
    out.write_bytes(b"kept")
    assert cli_main([CBOX, "-D", "spp=1", "-D", "res=4", "--cpu", "-x", "-z",
                     "-o", str(out)]) == 0
    assert out.read_bytes() == b"kept"


@pytest.mark.parametrize("flags", [["-c", "ck.npz"], ["-p", "2"], ["-j", "2"]],
                         ids=["checkpoint", "devices", "jobs"])
def test_cli_later_slice_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli_main([CBOX, "--cpu", "-o", str(tmp_path / "o.exr")] + flags)


@pytest.mark.parametrize("entry", ["load_scene", "render_scene_file", "cli"])
def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path,
                                                    entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.exr")
    calls = {
        "load_scene": lambda: txml.load_scene(CBOX, CBOX_DEFINES),
        "render_scene_file": lambda: txml.render_scene_file(
            CBOX, CBOX_DEFINES, out),
        "cli": lambda: cli_main([CBOX, "-D", "spp=1", "-D", "res=4", "-z",
                                 "-o", out]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not os.path.exists(out)


def test_render_scene_file_on_the_cpu(tmp_path):
    out = tmp_path / "o.pfm"
    img = txml.render_scene_file(CBOX, {"spp": 1, "res": 4}, str(out),
                                 device="cpu")
    np.testing.assert_array_equal(jimage.read_pfm(str(out)), img.numpy())


# the paths this process opens while "on" (an audit hook cannot be removed,
# so the one hook is installed once and records only while a test asks)
_OPENS = {"on": False, "installed": False, "paths": []}


def _record_opens(event, args):
    if (_OPENS["on"] and event == "open"
            and isinstance(args[0], (str, bytes, os.PathLike))):
        _OPENS["paths"].append(os.path.abspath(os.fsdecode(args[0])))


def test_scene_files_read_nothing_under_the_jax_package(tmp_path, scene_files):
    """The loader and the CLI open no file under mitsuba_tpu/."""
    if not _OPENS["installed"]:
        sys.addaudithook(_record_opens)
        _OPENS["installed"] = True
    _OPENS["paths"] = []
    _OPENS["on"] = True
    try:
        for path, defines in scene_files.values():
            txml.load_scene(path, defines, device="cpu")
        cli_main([CBOX, "-D", "spp=1", "-D", "res=4", "--cpu", "-z",
                  "-o", str(tmp_path / "o.exr")])
    finally:
        _OPENS["on"] = False
    opened = _OPENS["paths"]
    jax_pkg = str(REPO / "mitsuba_tpu") + os.sep
    assert any(p.endswith("cbox.xml") for p in opened)
    assert not [p for p in opened if p.startswith(jax_pkg)]


# --- io/image ---------------------------------------------------------------

IMG = np.random.default_rng(31).random((5, 7, 3)).astype(np.float32) * 3.0


@pytest.mark.parametrize("fmt", ["exr", "pfm", "npy"])
def test_port_images_read_back_in_the_jax_package(tmp_path, fmt):
    path = str(tmp_path / f"i.{fmt}")
    timage.write_image(path, IMG)
    back = {"exr": jimage.read_exr, "pfm": jimage.read_pfm,
            "npy": np.load}[fmt](path)
    np.testing.assert_array_equal(back, IMG)


@pytest.mark.parametrize("fmt", ["exr", "pfm"])
def test_jax_images_read_back_in_the_port(tmp_path, fmt):
    path = str(tmp_path / f"i.{fmt}")
    jimage.write_image(path, IMG)
    back = {"exr": timage.read_exr, "pfm": timage.read_pfm}[fmt](path)
    np.testing.assert_array_equal(back, IMG)


@pytest.mark.parametrize("fmt", ["hdr", "ppm", "m"])
def test_other_writers_match_the_jax_package(tmp_path, fmt):
    a, b = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
    timage.write_image(a, IMG)
    jimage.write_image(b, IMG)
    assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("fmt", ["png", "jpg", "tga", "bmp"])
def test_library_formats_raise(tmp_path, fmt):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        timage.write_image(str(tmp_path / f"i.{fmt}"), IMG)
