"""Port parity, the particle tracer: ``emitter.sample_ray`` on a scene that
holds all eight emitter types, the camera connections of ``sensor``
(``sample_direct``, ``pdf_ray_direction``, ``camera_pdf_area``) for the
perspective, thin-lens, orthographic and telecentric cameras, and one
ptracer render of the Cornell box with a glass pane through
``api.render``, against the JAX
package on the same numpy inputs, on the CPU.

Tolerances:
  * sample_ray: the emitter index, ``valid``, ``is_area`` and the pmf
    exactly (one searchsorted over the same cdf; the draws include every
    cdf entry, where ``side="right"`` decides); origins, directions,
    normals and radiances at rtol 1e-5 / atol 1e-5 (the warps' sin, cos
    and sqrt and a frame's three-term sums an ulp or two apart; the disk
    origins are scaled by the scene's radius), weights and area pdfs at
    rtol 1e-5 (a power over a pdf of 1e-3 to 1e3), but a spot's weights
    within 1e-4 of its unit-falloff weight: its falloff (cos - cos_cutoff)
    / (cos_beam - cos_cutoff) divides the cone's cosine 1 - u (1 -
    cos_cutoff), which XLA contracts into a fused multiply-add, by 0.04
    (measured: 8.1e-5 relative on a lane of falloff 0.04);
  * the camera connections: ``valid`` exactly away from the frustum's and
    the film's edges (no draw lies within 1e-4 of one), every float at
    rtol 1e-5 / atol 1e-6 (one normalisation, a 3x3 product and a
    division; the orthographic camera's 4x4 inverse);
  * the render (8x8, depth 3, 2 passes of 64 particles): the mean within
    1e-5 relative and at least 99% of pixels within atol 1e-4 / rtol 1e-3
    (a particle whose walk parts after a last-bit difference moves its
    splats; measured: every pixel within 4.8e-7).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import emitter as jem
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import emitter as tem
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

R = 4096
TOL = dict(rtol=1e-5, atol=1e-5)
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
RES, SPP, DEPTH = 8, 2, 3
SPOT_ROW = 3  # the spot light's emitter row in all_emitters
# one compile each serves the four cameras (the sensor is an argument)
J_SAMPLE_DIRECT = jax.jit(jsensor.sample_direct)
J_PDF_RAY_DIRECTION = jax.jit(jsensor.pdf_ray_direction)
J_CAMERA_PDF_AREA = jax.jit(jsensor.camera_pdf_area)


def all_emitters(mod, shapes, T, **build_kw):
    """A floor, an area light, a sphere light, a point, a spot, a
    directional and a collimated light, a constant environment and an
    environment map (emitters 0-7, in this order), by either builder."""
    b = mod.SceneBuilder()
    v, f, uv = shapes.rectangle(T.translate([0, -1, 0]) * T.rotate(
        [1, 0, 0], -90) * T.scale([3, 3, 1]))
    b.add_mesh(v, f, b.add_material(), uvs=uv)
    v, f, uv = shapes.rectangle(T.translate([0.5, 2, 0.2]) * T.rotate(
        [1, 0, 0], 90) * T.scale([0.4, 0.3, 1]))
    b.add_mesh(v, f, b.add_material(albedo=(0.0,) * 3), uvs=uv,
               emitter_radiance=(9.0, 8.0, 7.0))
    b.add_sphere((-0.8, 0.5, 0.3), 0.25, b.add_material(albedo=(0.0,) * 3),
                 emitter_radiance=(4.0, 5.0, 6.0))
    b.add_point_light((-0.5, 1.5, 1.0), (30.0, 20.0, 10.0))
    b.add_spot_light((0.2, 2.5, -0.3), (0.1, -1.0, 0.2), (50.0, 60.0, 70.0),
                     cutoff_deg=25.0)
    b.add_directional_light((0.3, -1.0, 0.4), (2.0, 2.5, 3.0))
    b.add_collimated_beam((0.0, 3.0, 0.0), (0.0, -1.0, 0.0),
                          (5.0, 5.0, 5.0))
    b.add_constant_emitter((0.2, 0.3, 0.4))
    rs = np.random.default_rng(11)
    b.add_envmap(rs.random((8, 16, 3)).astype(np.float32) * 2.0)
    return b.build(**build_kw)


@pytest.fixture(scope="module")
def emitter_scenes():
    return (all_emitters(jscene, jshapes, JTransform),
            all_emitters(tscene, tshapes, TTransform, device="cpu"))


def _ray_draws():
    rs = np.random.default_rng(5)
    u4 = rs.random((R, 4)).astype(np.float32)
    u2 = rs.random((R, 2)).astype(np.float32)
    # the selection cdf's entries k / 8 (exact in float32), where the
    # search's side decides the emitter
    u4[:8, 0] = np.arange(8, dtype=np.float32) / 8
    return u4, u2


def test_sample_ray_matches_jax_for_every_emitter_type(emitter_scenes):
    (js, jst), (ts, tst) = emitter_scenes
    assert tst.emitter_types == tuple(range(8)) == tuple(jst.emitter_types)
    u4, u2 = _ray_draws()
    ref = jax.jit(lambda a, b: jem.sample_ray(js, jst, a, b))(
        jnp.asarray(u4), jnp.asarray(u2))
    out = tem.sample_ray(ts, tst, torch.from_numpy(u4), torch.from_numpy(u2))
    e_idx = out.e_idx.numpy()
    np.testing.assert_array_equal(e_idx, np.asarray(ref.e_idx))
    assert set(e_idx.tolist()) == set(range(8))
    for f in ("valid", "is_area", "epmf"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("o", "d", "n", "radiance"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), **TOL,
                                   err_msg=f)
    np.testing.assert_allclose(out.pdf_area.numpy(), np.asarray(ref.pdf_area),
                               rtol=1e-5)
    w, w_ref = out.weight.numpy(), np.asarray(ref.weight)
    spot = e_idx == SPOT_ROW
    np.testing.assert_allclose(w[~spot], w_ref[~spot], rtol=1e-5)
    np.testing.assert_allclose(w[spot], w_ref[spot], rtol=1e-5,
                               atol=1e-4 * np.abs(w_ref[spot]).max())
    # every type emits from somewhere: the collimated beam's only light
    assert out.valid[e_idx == tem.COLLIMATED].all()
    np.testing.assert_allclose(np.linalg.norm(out.d.numpy(), axis=1), 1.0,
                               rtol=1e-5)


_CAM = ([0.4, 0.6, -1.2], [0.5, 0.45, 0.5], [0, 1, 0])


def _cameras(mod, T, **kw):
    """A perspective, a thin-lens, an orthographic and a telecentric camera
    with non-default parameters, by either package's constructors."""
    cam = T.look_at(*_CAM)
    ortho = T.look_at(*_CAM) * T.scale([0.6, 0.6, 1.0])
    return [mod.make_perspective(cam, 40.0, 24, 16, **kw),
            mod.make_thinlens(cam, 40.0, 24, 16, 0.05, 1.4, **kw),
            mod.make_orthographic(ortho, 24, 16, **kw),
            mod.make_telecentric(ortho, 24, 16, 0.04, 0.9, **kw)]


def _points():
    """Points around and behind the view, unit normals (the first 64 zero:
    volume vertices) and unit directions."""
    rs = np.random.default_rng(9)
    p = rs.uniform([-1.0, -1.0, -2.0], [2.0, 2.0, 2.0], (R, 3))
    n = rs.normal(size=(R, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:64] = 0.0
    d = rs.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p.astype(np.float32), n.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("k", range(4), ids=["perspective", "thinlens",
                                             "orthographic", "telecentric"])
def test_camera_connections_match_jax(k):
    j = _cameras(jsensor, JTransform)[k]
    t = _cameras(tsensor, TTransform, device="cpu")[k]
    p, n, d = _points()
    ref = J_SAMPLE_DIRECT(j, jnp.asarray(p))
    out = tsensor.sample_direct(t, torch.from_numpy(p))
    valid = out.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    if t.type == tsensor.TELECENTRIC:
        # telecentric.cpp refuses to connect
        assert not valid.any() and not out.imp.numpy().any()
    else:
        assert 0.05 < valid.mean() < 0.95
    for f in ("d", "dist", "uv", "imp"):
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a[valid], b[valid], rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(
        tsensor.pdf_ray_direction(t, torch.from_numpy(d)).numpy(),
        np.asarray(J_PDF_RAY_DIRECTION(j, jnp.asarray(d))),
        rtol=1e-5, atol=1e-6)
    area = tsensor.camera_pdf_area(t, torch.from_numpy(p),
                                   torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(
        area, np.asarray(J_CAMERA_PDF_AREA(j, jnp.asarray(p),
                                           jnp.asarray(n))),
        rtol=1e-5, atol=1e-6)
    assert (area > 0).any()
    np.testing.assert_array_equal(t.position.numpy(),
                                  np.asarray(j.position))


def test_image_plane_area_matches_jax():
    j = _cameras(jsensor, JTransform)[0]
    t = _cameras(tsensor, TTransform, device="cpu")[0]
    np.testing.assert_allclose(tsensor.image_plane_area(t).numpy(),
                               np.asarray(jsensor.image_plane_area(j)),
                               rtol=1e-6)


def glass_cornell(mod, bsdf, shapes, **build_kw):
    """The Cornell box with a glass pane under its light, facing up, by
    either package's builder: one refracting interface, so the particles
    that cross it keep importance transport's eta^2 (a closed glass body
    cancels it on every path the camera sees) and light the floor that the
    camera sees below the pane."""
    b = mod.SceneBuilder()
    shapes.cornell_box(b)
    pane = np.array([[0.3, 0.7, 0.3], [0.3, 0.7, 0.7], [0.7, 0.7, 0.7],
                     [0.7, 0.7, 0.3]])
    b.add_mesh(pane, np.array([[0, 1, 2], [0, 2, 3]]),
               b.add_material(type=bsdf.DIELECTRIC),
               uvs=np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]))
    return b.build(**build_kw)


@pytest.fixture(scope="module", autouse=True)
def jax_render():
    """The JAX ptracer render, started before the module's first test in a
    thread of its own, where XLA compiles it while the other tests run."""
    scene = glass_cornell(jscene, jbsdf, jshapes)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: np.asarray(japi.render(
            *scene, jsensor.make_perspective(
                JTransform.look_at(EYE, AT, UP), FOV, RES, RES),
            jcommon.IntegratorConfig(type=jcommon.PTRACER, max_depth=DEPTH),
            japi.RenderSettings(width=RES, height=RES, spp=SPP))))


@pytest.fixture(scope="module")
def ptracer_renders(jax_render):
    """The port's render, its n_rays, and the lanes handed to each kind of
    scene query during it (counted by wrappers of the scene's two query
    functions)."""
    handed = {"ray_intersect": [], "occluded": [], "blocked": []}
    originals = {name: getattr(tscene, name)
                 for name in ("ray_intersect", "occluded")}

    def spy(name):
        def query(*args, active, **kw):
            handed[name].append(int(active.sum()))
            out = originals[name](*args, active=active, **kw)
            if name == "occluded":
                handed["blocked"].append(int((out & active).sum()))
            return out
        return query

    for name in originals:
        setattr(tscene, name, spy(name))
    try:
        img, n = tapi.render(
            *glass_cornell(tscene, tbsdf, tshapes, device="cpu"),
            tsensor.make_perspective(
                TTransform.look_at(EYE, AT, UP), FOV, RES, RES,
                device="cpu"),
            tcommon.IntegratorConfig(type=tcommon.PTRACER, max_depth=DEPTH),
            tapi.RenderSettings(width=RES, height=RES, spp=SPP),
            device="cpu", with_stats=True)
    finally:
        for name, fn in originals.items():
            setattr(tscene, name, fn)
    return jax_render.result(), img.numpy(), n, handed


def test_ptracer_render_matches_jax(ptracer_renders):
    ref, img = ptracer_renders[:2]
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-5)
    close = np.isclose(img, ref, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


def test_ptracer_counts_its_queries(ptracer_renders):
    """n_rays is every lane handed to a scene query, occluded or not: per
    pass depth - 1 closest-hit walks, and a shadow query for the emitter
    vertex and one per bounce, each over the connections it issues."""
    n, handed = ptracer_renders[2:]
    assert len(handed["ray_intersect"]) == SPP * (DEPTH - 1)
    assert len(handed["occluded"]) == SPP * DEPTH
    assert handed["ray_intersect"][0] == RES * RES
    assert n == sum(handed["ray_intersect"]) + sum(handed["occluded"])
    # occluded connections count too, and this scene has some
    assert sum(handed["blocked"]) > 0
