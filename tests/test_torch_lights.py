"""Port parity, the delta lights and the sensors: ``sample_direct`` of a
scene with an area light and a point, a spot, a directional and a collimated
light (lanes on the spot's two edges included), ``sample_ray`` and
``ray_weight`` of all nine sensor types, every new scene-file element
through both loaders, the meters nested in a shape, and the two repairs of
faults the port had copied from the JAX package (difftrans's transmittance,
a sphere's normal-map tangent), against the JAX package on the same numpy
inputs, on the CPU. Renders are tests/test_torch_lights_render.py's.

Tolerances:
  * sample_direct: ``delta`` and ``valid`` exactly (the spot's falloff
    decides lanes at cos == cos(beam width) and cos == cos(cutoff) by its
    selects, and the edge lanes sit exactly there: 3-4-5 and 5-12-13
    triangles, whose normalisation is exact in float32); d, dist,
    radiance and pdf_sa at rtol 1e-6 / atol 1e-6 (one normalisation and a
    division, an ulp or two apart in XLA and PyTorch);
  * sample_ray: origins at rtol 1e-6 / atol 1e-6 in a box of size 1, and
    directions at rtol 1e-5 / atol 1e-6 (the JAX matmul and a 3-term sum,
    the warps' sin and cos, an ulp apart: measured 1.2e-7 and 6.3e-7 on
    65,536 draws); the irradiance meter's directions from the disk's rim
    (the draws (0, 0) and (0, 0.5), kept on purpose) at atol 1e-4: the
    cosine hemisphere's z = sqrt(1 - x^2 - y^2) cancels there, and an ulp
    of x and y became 4.2e-5;
  * ray_weight and the loaded tables and sensors exactly (the same numpy
    arithmetic, cast to float32 at the end).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import emitter as jem
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import emitter as tem
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_materials import _both, _equal_tables
from test_torch_render import FIELD_PATHS, _leaf, jax_scene_arrays

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

R = 4096
# the spot at (0, 10, 0) pointing down; lanes at (3, 6, 0) and (5, -2, 0)
# see it at cos = 4/5 and 12/13 exactly: its cutoff and beam width
SPOT_POS, SPOT_CUT, SPOT_BEAM = (0.0, 10.0, 0.0), 0.8, 12.0 / 13.0
EDGES = np.float32([[3.0, 6.0, 0.0], [5.0, -2.0, 0.0]])


def _lights(mod, shapes, T, **build_kw):
    """A floor, a small area light, and a point, a spot, a directional and
    a collimated light (emitters 0-4, in this order), by either builder."""
    b = mod.SceneBuilder()
    v, f, uv = shapes.rectangle(T.translate([0, -3, 0]) * T.rotate(
        [1, 0, 0], -90) * T.scale([8, 8, 1]))
    b.add_mesh(v, f, b.add_material(), uvs=uv)
    v, f, uv = shapes.rectangle(T.translate([1, 6, 1]) * T.rotate(
        [1, 0, 0], 90) * T.scale([0.5, 0.5, 1]))
    b.add_mesh(v, f, b.add_material(albedo=(0.0,) * 3), uvs=uv,
               emitter_radiance=(9.0, 8.0, 7.0))
    b.add_point_light((-2.0, 4.0, 1.5), (30.0, 20.0, 10.0))
    b.add_spot_light(SPOT_POS, (0.0, -1.0, 0.0), (50.0, 60.0, 70.0),
                     cutoff_deg=math.degrees(math.acos(SPOT_CUT)),
                     beamwidth_deg=math.degrees(math.acos(SPOT_BEAM)))
    b.add_directional_light((0.3, -1.0, 0.2), (2.0, 1.5, 1.0))
    b.add_collimated_beam((0.0, 5.0, 0.0), (0.0, -1.0, 0.0), (4.0,) * 3)
    return b.build(**build_kw)


@pytest.fixture(scope="module")
def lights():
    return (_lights(jscene, jshapes, JTransform),
            _lights(tscene, tshapes, TTransform, device="cpu"))


def test_lights_scene_builds_as_in_jax(lights):
    (js, jst), (ts, tst) = lights
    for p in FIELD_PATHS:
        ref = js
        for q in p:
            ref = getattr(ref, q)
        np.testing.assert_array_equal(_leaf(ts, p), np.asarray(ref),
                                      err_msg=".".join(p))
    assert tst.emitter_types == tuple(jst.emitter_types) == (0, 1, 4, 5, 6)
    em = ts.emitters
    assert em.delta.tolist() == [False, True, True, True, False]
    assert em.pmf.tolist() == [np.float32(0.2)] * 5
    # the spot's edges are exactly those of the EDGES lanes
    assert em.spot_cos[2].tolist() == [np.float32(SPOT_CUT),
                                       np.float32(SPOT_BEAM)]


def _u3_and_points():
    rs = np.random.default_rng(16)
    p = rs.uniform([-4, -3, -4], [4, 5, 4], (R, 3)).astype(np.float32)
    u3 = rs.random((R, 3)).astype(np.float32)
    # lanes on the spot's edges, at them +- a little, and in its band
    band = np.float32([[4.0, 0.0, 0.0], [3.0, 6.001, 0.0], [3.0, 5.999, 0.0],
                       [5.0, -2.001, 0.0], [5.0, -1.999, 0.0]])
    k = len(EDGES) + len(band)
    p[:k] = np.concatenate([EDGES, band])
    u3[:k, 0] = 0.5  # the spot (emitter 2 of five)
    return p, u3


def test_sample_direct_matches_jax(lights):
    (js, jst), (ts, tst) = lights
    p, u3 = _u3_and_points()
    ref = jax.jit(jem.sample_direct, static_argnums=1)(
        js, jst, jnp.asarray(p), jnp.asarray(u3))
    out = tem.sample_direct(ts, tst, torch.from_numpy(p),
                            torch.from_numpy(u3))
    for f in ("delta", "valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("d", "dist", "radiance", "pdf_sa"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    sel = np.searchsorted(np.cumsum([0.2] * 5), u3[:, 0], side="right")
    delta, valid = out.delta.numpy(), out.valid.numpy()
    # each type drew lanes; delta lights report the pmf as their pdf, the
    # collimated beam is never valid
    assert set(sel) == {0, 1, 2, 3, 4}
    assert (delta == np.isin(sel, (1, 2, 3))).all()
    np.testing.assert_array_equal(out.pdf_sa.numpy()[delta], np.float32(0.2))
    assert not valid[sel == 4].any() and (out.pdf_sa.numpy()[sel == 4] == 0).all()
    # the cutoff edge is out (cos <= cos cutoff), the beam edge at full
    # intensity / r^2 (cos >= cos beam)
    assert valid[:7].tolist() == [False, True, True, False, True, True, True]
    np.testing.assert_allclose(out.radiance.numpy()[1], np.float32(
        [50.0, 60.0, 70.0]) / 169.0, rtol=1e-6)


def test_directional_light_sees_through_the_open_side(lights):
    """The directional light's shadow ray runs 2 x the scene radius against
    the light's travel; a floor point lies in its light."""
    (_, _), (ts, tst) = lights
    p = torch.tensor([[0.0, -3.0 + 1e-3, 0.0]])
    u3 = torch.tensor([[0.7, 0.5, 0.5]])  # the directional light
    ds = tem.sample_direct(ts, tst, p, u3)
    d = np.float32([0.3, -1.0, 0.2]) / np.linalg.norm([0.3, -1.0, 0.2])
    np.testing.assert_allclose(ds.d[0].numpy(), -d, rtol=1e-6)
    assert ds.dist.item() == pytest.approx(2.0 * ts.radius.item())
    assert bool(ds.valid[0]) and bool(ds.delta[0])


# --- the sensors ------------------------------------------------------------

_CAM = ([0.4, 0.6, -1.2], [0.5, 0.45, 0.5], [0, 1, 0])


def _sensors(mod, T, **kw):
    """One sensor of each type (0-8) with non-default parameters, by either
    package's constructors."""
    cam = T.look_at(*_CAM)
    ortho = T.look_at(*_CAM) * T.scale([0.6, 0.6, 1.0])
    return [
        mod.make_perspective(cam, 40.0, 24, 16, **kw),
        mod.make_thinlens(cam, 40.0, 24, 16, 0.05, 1.4, **kw),
        mod.make_orthographic(ortho, 24, 16, **kw),
        mod.make_spherical(cam, **kw),
        mod.make_radiancemeter([0.3, 0.2, 0.1], [0.2, 0.5, 1.0], **kw),
        mod.make_irradiancemeter([0.5, 0.01, 0.5], [0.0, 1.0, 0.1], 0.03,
                                 **kw),
        mod.make_telecentric(ortho, 24, 16, 0.04, 0.9, **kw),
        mod.make_perspective_rdist(cam, 40.0, 24, 16, kc=(0.12, -0.05),
                                   **kw),
        mod.make_fluencemeter([0.5, 0.5, 0.5], **kw),
    ]


@pytest.fixture(scope="module")
def sensors():
    return (_sensors(jsensor, JTransform),
            _sensors(tsensor, TTransform, device="cpu"))


def test_sensors_construct_as_in_jax(sensors):
    for k, (j, t) in enumerate(zip(*sensors)):
        assert int(j.type) == t.type == k
        b = bridge.sensor_from_arrays(
            {f: np.asarray(getattr(j, f)) for f in j._fields}, device="cpu")
        assert b.type == t.type
        for f in t._fields[1:]:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          getattr(b, f).numpy(),
                                          err_msg=f"type {k} {f}")


def _draws(n):
    rs = np.random.default_rng(23)
    uv = rs.random((n, 2)).astype(np.float32)
    u_ap = rs.random((n, 2)).astype(np.float32)
    # the poles and the film's corners
    uv[:6] = [[0.5, 0.0], [0.3, 0.0], [0.5, 1.0 - 2 ** -24], [0.0, 0.0],
              [0.0, 0.5], [1.0 - 2 ** -24, 0.5]]
    u_ap[:2] = [[0.5, 0.5], [0.0, 1.0 - 2 ** -24]]
    return uv, u_ap


def test_sample_ray_matches_jax_for_every_type(sensors):
    """One jit of the JAX sample_ray serves all nine types (its type is a
    traced value)."""
    uv, u_ap = _draws(R)
    jfn = jax.jit(jsensor.sample_ray)
    for k, (j, t) in enumerate(zip(*sensors)):
        o_ref, d_ref = (np.asarray(x) for x in jfn(j, jnp.asarray(uv),
                                                   jnp.asarray(u_ap)))
        o, d = tsensor.sample_ray(t, torch.from_numpy(uv),
                                  torch.from_numpy(u_ap))
        assert o.is_contiguous() and d.is_contiguous()
        assert o.shape == d.shape == (R, 3)
        np.testing.assert_allclose(o.numpy(), o_ref, rtol=1e-6, atol=1e-6,
                                   err_msg=f"type {k} origin")
        rim = (np.abs(2.0 * uv - 1.0).max(axis=1) > 1.0 - 1e-6) & (
            k == tsensor.IRRADIANCEMETER)
        np.testing.assert_allclose(d.numpy()[~rim], d_ref[~rim], rtol=1e-5,
                                   atol=1e-6, err_msg=f"type {k} direction")
        np.testing.assert_allclose(d.numpy()[rim], d_ref[rim], atol=1e-4,
                                   err_msg=f"type {k} direction, rim")
        np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1.0,
                                   rtol=1e-6)


def test_ray_weight_matches_jax(sensors):
    for j, t in zip(*sensors):
        w = tsensor.ray_weight(t)
        assert np.float32(w) == np.asarray(jsensor.ray_weight(j)), t.type
    assert [tsensor.ray_weight(t) for t in sensors[1]] == [
        1.0, 1.0, 1.0, 1.0, 1.0, float(np.float32(math.pi)), 1.0, 1.0,
        float(np.float32(4 * math.pi))]


def test_thin_lens_focuses_on_its_plane(sensors):
    """Every aperture draw of one film point meets the focus plane at the
    pinhole ray's point."""
    t = sensors[1][1]
    uv = torch.full((64, 2), 0.3)
    u_ap = torch.rand((64, 2), generator=torch.Generator().manual_seed(1))
    o, d = tsensor.sample_ray(t, uv, u_ap)
    A = t.to_world
    z = A[:3, 2] / A[:3, 2].norm()
    t_hit = (1.4 - (o - A[:3, 3]) @ z) / (d @ z)
    p = o + t_hit[:, None] * d
    assert float((p - p[0]).abs().max()) < 1e-5
    assert float((o - A[:3, 3]).norm(dim=1).max()) <= 0.05 * 1.0001


# --- the scene-file elements through both loaders ---------------------------

_BOX = ('<shape type="rectangle"><transform name="toWorld">'
        '<scale value="2"/><rotate x="1" angle="-90"/></transform></shape>')
_LOOK = ('<transform name="toWorld"><lookat origin="0.5, 1.5, -2" '
         'target="0.2, 0.1, 0.4" up="0, 1, 0"/></transform>')
_FILM = ('<film type="hdrfilm"><integer name="width" value="12"/>'
         '<integer name="height" value="8"/></film>')
ELEMENTS = {
    "emitter-point": ('<emitter type="point"><point name="position" '
                      'x="0.1" y="1.5" z="-0.2"/><rgb name="intensity" '
                      'value="4, 5, 6"/></emitter>'),
    "emitter-point-default": '<emitter type="point"/>',
    "emitter-spot": (f'<emitter type="spot">{_LOOK}<float name="cutoffAngle" '
                     'value="25"/><float name="beamWidth" value="15"/>'
                     '<spectrum name="intensity" value="20"/></emitter>'),
    "emitter-spot-default-beam": (f'<emitter type="spot">{_LOOK}<float '
                                  'name="cutoffAngle" value="30"/></emitter>'),
    "emitter-directional": ('<emitter type="directional"><vector '
                            'name="direction" x="0.3" y="-0.5" z="1"/><rgb '
                            'name="irradiance" value="2, 3, 4"/></emitter>'),
    "emitter-collimated": (f'<emitter type="collimated">{_LOOK}<spectrum '
                           'name="power" value="3"/></emitter>'),
    "sensor-thinlens": (f'<sensor type="thinlens">{_LOOK}<float '
                        'name="apertureRadius" value="0.1"/><float '
                        'name="focusDistance" value="2.5"/><float name="fov" '
                        f'value="35"/>{_FILM}</sensor>'),
    "sensor-orthographic": (f'<sensor type="orthographic">{_LOOK}{_FILM}'
                            "</sensor>"),
    "sensor-spherical": f'<sensor type="spherical">{_LOOK}{_FILM}</sensor>',
    "sensor-radiancemeter": (f'<sensor type="radiancemeter">{_LOOK}'
                             '<sampler type="independent"><integer '
                             'name="sampleCount" value="128"/></sampler>'
                             "</sensor>"),
    "sensor-irradiancemeter": (f'<sensor type="irradiancemeter">{_LOOK}'
                               '<film type="mfilm"/></sensor>'),
    "sensor-fluencemeter": f'<sensor type="fluencemeter">{_LOOK}</sensor>',
    "shape-irradiancemeter": (
        '<shape type="rectangle"><transform name="toWorld"><scale x="0.05" '
        'y="0.05" z="1"/><rotate x="1" angle="-90"/><translate y="0.01"/>'
        '</transform><sensor type="irradiancemeter"><sampler '
        'type="independent"><integer name="sampleCount" value="64"/>'
        "</sampler></sensor></shape>"),
    "shape-radiancemeter-flipped": (
        '<shape type="disk"><boolean name="flipNormals" value="true"/>'
        f'{_LOOK}<sensor type="radiancemeter"/></shape>'),
    "shape-fluencemeter": (f'<shape type="sphere">{_LOOK}'
                           '<sensor type="fluencemeter"/></shape>'),
}


@pytest.mark.parametrize("case", sorted(ELEMENTS))
def test_elements_load_as_the_jax_loaders(tmp_path, case):
    path = tmp_path / "s.xml"
    path.write_text(f'<scene version="0.6.0">{ELEMENTS[case]}{_BOX}</scene>')
    jls, tls, ref, ref_static = _both(path)
    _equal_tables(tls, ref, ref_static)
    js = bridge.sensor_from_arrays(
        {f: np.asarray(getattr(jls.sensor, f)) for f in jls.sensor._fields},
        device="cpu")
    assert tls.sensor.type == js.type
    for f in js._fields[1:]:
        np.testing.assert_array_equal(getattr(tls.sensor, f).numpy(),
                                      getattr(js, f).numpy(), err_msg=f)
    for f in ("width", "height", "spp", "sampler_type"):
        assert getattr(tls.settings, f) == getattr(jls.settings, f), f
    if case.startswith("emitter-"):
        tag = {"point": 1, "spot": 5, "directional": 4, "collimated": 6}[
            case.split("-")[1]]
        assert tls.scene.emitters.type.tolist() == [tag]
    else:
        kind = case.split("-")[1]
        assert tls.sensor.type == {
            "thinlens": 1, "orthographic": 2, "spherical": 3,
            "radiancemeter": 4, "irradiancemeter": 5, "fluencemeter": 8}[kind]
        if "meter" in kind:
            assert (tls.settings.width, tls.settings.height) == (1, 1)


def test_later_lists_name_only_sun_and_sky():
    # every sensor and, since the sun and sky joined the port, every
    # emitter element loads
    assert not txml._LATER_SENSORS
    assert not txml._LATER_EMITTERS


# --- the repairs ------------------------------------------------------------

def test_difftrans_transmittance_reaches_spec_trans(tmp_path):
    """The port's loader stores a difftrans element's transmittance in the
    column its lobe reads (spec_trans), as a JAX scene built with
    add_material(type=DIFFTRANS, spec_trans=...) holds it; the albedo
    keeps its default. (The JAX loader puts it in the albedo column, which
    the lobe never reads.)"""
    path = tmp_path / "s.xml"
    path.write_text('<scene version="0.6.0"><shape type="rectangle">'
                    '<bsdf type="difftrans"><rgb name="transmittance" '
                    'value="0.7, 0.6, 0.5"/></bsdf></shape><shape '
                    'type="rectangle"><bsdf type="difftrans"/></shape>'
                    "</scene>")
    tls = txml.load_scene(str(path), device="cpu")
    b = jscene.SceneBuilder()
    for trans in ((0.7, 0.6, 0.5), (0.5, 0.5, 0.5)):
        v, f, uv = jshapes.rectangle(JTransform.identity())
        b.add_mesh(v, f, b.add_material(type=jbsdf.DIFFTRANS,
                                        spec_trans=trans), uvs=uv)
    ref, ref_static = bridge.scene_from_arrays(
        jax_scene_arrays(b.build()[0]), dataclasses.asdict(b.build()[1]),
        device="cpu")
    _equal_tables(tls, ref, ref_static)
    mats = tls.scene.materials
    np.testing.assert_array_equal(mats.spec_trans.numpy(), np.float32(
        [[0.7, 0.6, 0.5], [0.5, 0.5, 0.5]]))
    np.testing.assert_array_equal(mats.albedo.numpy(), np.float32(0.5))
    # the JAX loader's table holds the transmittance in the albedo column
    jmats = jxml.load_scene(str(path)).scene.materials
    np.testing.assert_array_equal(np.asarray(jmats.albedo),
                                  mats.spec_trans.numpy())
    np.testing.assert_array_equal(np.asarray(jmats.spec_trans), 1.0)


def test_a_textured_difftrans_transmittance_raises(tmp_path):
    path = tmp_path / "s.xml"
    path.write_text('<scene version="0.6.0"><shape type="rectangle">'
                    '<bsdf type="difftrans"><texture type="checkerboard" '
                    'name="transmittance"/></bsdf></shape></scene>')
    with pytest.raises(NotImplementedError, match="item 3.2.3"):
        txml.load_scene(str(path), device="cpu")


def test_a_sphere_alone_takes_its_map():
    """In a scene with no triangle the JAX package perturbs no frame; the
    port perturbs a sphere lane's from the sphere's own tangent, and a
    lane at the pole (no tangent) from the frame's."""
    b = tscene.SceneBuilder()
    tilt = b.add_texture_checkerboard(color0=(0.75, 0.5, 0.85),
                                      color1=(0.75, 0.5, 0.85))
    b.add_sphere([0.0, 0.0, 0.0], 1.0, b.add_material(normal_tex=tilt))
    scene, static = b.build(device="cpu")
    assert static.n_tris == 0 and static.has_normal_maps
    o = torch.tensor([[-5.0, 0.0, 0.0], [0.0, 0.0, 5.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    its = tscene.ray_intersect(scene, static, o, d, 1e-4, torch.inf)
    assert its.valid.tolist() == [True, True]
    n = its.sh_frame.n.numpy()
    # at (-1, 0, 0) dp/du is (0, -1, 0) x 2pi: the map's x tilts the normal
    # along -y, and its normal z keeps the geometric normal's share
    assert n[0, 1] < -0.3 and n[0, 0] < -0.5 and abs(n[0, 2]) < 0.3
    assert abs(np.linalg.norm(n[1]) - 1.0) < 1e-6 and n[1, 2] > 0.5


# --- entry points ------------------------------------------------------------

@pytest.mark.parametrize("entry", ["thinlens", "orthographic", "spherical",
                                   "radiancemeter", "irradiancemeter",
                                   "telecentric", "perspective_rdist",
                                   "fluencemeter", "render_meter"])
def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, lights,
                                                       entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = TTransform.look_at(*_CAM)
    ts, tst = lights[1]
    calls = {
        "thinlens": lambda dev: tsensor.make_thinlens(cam, 40, 4, 4, 0.1, 1,
                                                      device=dev),
        "orthographic": lambda dev: tsensor.make_orthographic(cam, 4, 4,
                                                              device=dev),
        "spherical": lambda dev: tsensor.make_spherical(cam, device=dev),
        "radiancemeter": lambda dev: tsensor.make_radiancemeter(
            [0, 0, 0], [0, 0, 1], device=dev),
        "irradiancemeter": lambda dev: tsensor.make_irradiancemeter(
            [0, 0, 0], [0, 1, 0], device=dev),
        "telecentric": lambda dev: tsensor.make_telecentric(cam, 4, 4,
                                                            device=dev),
        "perspective_rdist": lambda dev: tsensor.make_perspective_rdist(
            cam, 40, 4, 4, device=dev),
        "fluencemeter": lambda dev: tsensor.make_fluencemeter([0, 0, 0],
                                                              device=dev),
        "render_meter": lambda dev: tapi.render(
            ts, tst, tsensor.make_fluencemeter([0, 0, 0], device="cpu"),
            tcommon.IntegratorConfig(type=tcommon.AO),
            tapi.RenderSettings(width=1, height=1, spp=1), device=dev),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]("cuda")
    if entry != "render_meter":  # the CPU meter renders are the render file's
        calls[entry]("cpu")
