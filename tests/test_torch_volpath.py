"""Port parity, the volumetric path tracer: one render of a scene holding a
grid medium behind a null boundary and a homogeneous one inside a
dielectric sphere, against the JAX package on the same samples on the CPU;
and two physics checks of the port alone with tests/test_volumetric.py's
scenes and tolerances: Beer-Lambert through an absorbing sphere
(exp(-1.3)) and the volumetric white furnace (1.0).

Tolerances:
  * the render (8x8, 4 spp, depth 6, roulette from 3): the mean within
    1e-4 relative, every pixel within atol 1e-4 / rtol 1e-3 (free flights
    and phase samples an ulp apart; test_torch_volume.py holds them lane
    for lane); the scene keeps its faces off each other's planes and the
    grid's box off its null cube's faces (a ray that starts on a face of
    the grid's box is inside or outside it by the last bit of its origin,
    and the two take different tracking steps and draws);
  * the physics checks: 3% of the closed form, test_volumetric.py's, over
    its 8,192 paths per check (64x64 pixels, 2 samples each, under its 2
    degree field of view, where it traces 4x4 pixels at 512 spp).
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
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import medium as tmed
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

RES, SPP, DEPTH, RR = 8, 4, 6, 3
CAM = ([0.5, 0.45, -1.0], [0.5, 0.4, 0.5], [0, 1, 0])
FOV = 45.0


def plume(n=12):
    """A small plume of densities, zero outside its column."""
    z, y, x = np.meshgrid(*(np.linspace(0, 1, n),) * 3, indexing="ij")
    g = np.exp(-((x - 0.5) ** 2 + (z - 0.5) ** 2) / 0.03) * (y < 0.8)
    g[g < 0.2] = 0.0
    return g.astype(np.float32)


def media_scene(b, bsdf, shapes, T):
    """A floor, a back wall and an area light; a null cube holding a grid
    medium (id 0, isotropic) and a glass sphere holding a homogeneous one
    (id 1, HG g = 0.6), on ``b`` (either package's builder, with that
    package's ``bsdf``, ``shapes`` and ``Transform``)."""
    # the grid's box lies inside the cube by 0.02 on each side
    w2g = np.eye(4)
    w2g[:3, :3] /= 0.56
    w2g[:3, 3] = np.array([-0.12, -0.07, -0.32]) / 0.56
    grid = b.add_medium_heterogeneous(
        plume(), sigma_t=(6.0, 5.0, 4.0), albedo=(0.9, 0.8, 0.7),
        world_to_grid=w2g)
    milk = b.add_medium_homogeneous(sigma_s=(2.0, 1.5, 1.0),
                                    sigma_a=(0.2, 0.3, 0.4), phase_type=1,
                                    phase_g=0.6)
    white = b.add_material(albedo=(0.7, 0.7, 0.7))
    light = b.add_material(albedo=(0.0, 0.0, 0.0))
    null = b.add_material(type=bsdf.NULL, interior_medium=grid)
    glass = b.add_material(type=bsdf.DIELECTRIC, interior_medium=milk)
    half = T.scale([0.5, 0.5, 1])
    for t, mat, em in (
            (T.translate([0.5, 0.0, 0.5]) * T.rotate([1, 0, 0], -90) * half,
             white, None),
            (T.translate([0.5, 0.5, 1.0]) * half, white, None),
            (T.translate([0.5, 0.99, 0.5]) * T.rotate([1, 0, 0], 90)
             * T.scale([0.15, 0.15, 1]), light, (8.0, 8.0, 8.0))):
        v, f, uv = shapes.rectangle(t)
        b.add_mesh(v, f, mat, emitter_radiance=em, uvs=uv)
    v, f, uv = shapes.cube(T.translate([0.4, 0.35, 0.6])
                           * T.scale([0.3, 0.3, 0.3]))
    b.add_mesh(v, f, null, uvs=uv)
    b.add_sphere((0.72, 0.2, 0.45), 0.17, glass)
    return b


def _sphere_scene(sigma_s, sigma_a):
    """test_volumetric.py's sphere of radius 0.5 at z = 2 holding a
    homogeneous medium behind a null boundary, under a constant emitter 1."""
    b = tscene.SceneBuilder()
    med = b.add_medium_homogeneous(sigma_s=(sigma_s,) * 3,
                                   sigma_a=(sigma_a,) * 3)
    b.add_sphere((0, 0, 2.0), 0.5, b.add_material(type=tbsdf.NULL,
                                                  interior_medium=med))
    b.add_constant_emitter((1.0, 1.0, 1.0))
    return b.build(device="cpu")


def _physics_render(scene, static, depth):
    sensor = tsensor.make_perspective(
        TTransform.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), 2.0, 64, 64,
        device="cpu")
    return tapi.render(scene, static, sensor,
                       tcommon.IntegratorConfig(type=tcommon.VOLPATH,
                                                max_depth=depth, rr_depth=64),
                       tapi.RenderSettings(width=64, height=64, spp=2,
                                           spp_per_pass=2, filter_type=0),
                       device="cpu").numpy()


def test_beer_lambert_absorption():
    """L = exp(-sigma_a * chord) through the absorbing sphere's centre."""
    img = _physics_render(*_sphere_scene(0.0, 1.3), depth=8)
    np.testing.assert_allclose(img.mean(), np.exp(-1.3 * 2 * 0.5), rtol=0.03)


def test_scattering_furnace():
    """A conservative medium under a uniform environment leaves the
    radiance 1 (the volumetric white furnace)."""
    img = _physics_render(*_sphere_scene(1.0, 0.0), depth=32)
    np.testing.assert_allclose(img.mean(), 1.0, rtol=0.03)


@pytest.fixture(scope="module", autouse=True)
def jax_pass():
    """The JAX scene and its one-sample render pass, traced before the
    module's first test and compiled by XLA in a thread of its own while
    the physics checks run."""
    js, jst = media_scene(jscene.SceneBuilder(), jbsdf, jshapes,
                          JTransform).build()
    sensor = jsensor.make_perspective(JTransform.look_at(*CAM), FOV, RES, RES)
    cfg = jcommon.IntegratorConfig(type=jcommon.VOLPATH, max_depth=DEPTH,
                                   rr_depth=RR)
    st = japi.RenderSettings(width=RES, height=RES, spp=1, spp_per_pass=1,
                             filter_type=0)

    def one_pass(scene_, film_data, s):
        return japi.render_pass(scene_, jst, sensor, cfg, st,
                                jfilm.Film(film_data), s, 1).data

    lowered = jax.jit(one_pass).trace(js, jnp.zeros((RES, RES, 4)),
                                      jnp.int32(0)).lower()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield js, pool.submit(lowered.compile)


@pytest.fixture(scope="module")
def renders(jax_pass):
    ts, tst = media_scene(tscene.SceneBuilder(), tbsdf, tshapes,
                          TTransform).build(device="cpu")
    tmed.reset_steps()
    img, n = tapi.render(
        ts, tst, tsensor.make_perspective(TTransform.look_at(*CAM), FOV, RES,
                                          RES, device="cpu"),
        tcommon.IntegratorConfig(type=tcommon.VOLPATH, max_depth=DEPTH,
                                 rr_depth=RR),
        tapi.RenderSettings(width=RES, height=RES, spp=SPP, spp_per_pass=SPP,
                            filter_type=0),
        device="cpu", with_stats=True)
    js, compiled = jax_pass
    one_pass = compiled.result()
    film = jnp.zeros((RES, RES, 4))
    for s in range(SPP):
        film = one_pass(js, film, jnp.int32(s))
    ref = np.asarray(jfilm.develop(jfilm.Film(film)))
    return dict(ref=ref, img=img.numpy(), n=n, static=tst,
                steps=dict(tmed.STEPS))


def test_volpath_render_matches_jax(renders):
    img, ref = renders["img"], renders["ref"]
    st = renders["static"]
    assert st.medium_types == (0, 1) and st.has_boundary_media
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-2
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-4)
    np.testing.assert_allclose(img, ref, atol=1e-4, rtol=1e-3)


def test_volpath_counts_its_queries(renders):
    """Per bounce a closest-hit query for each live lane and, with boundary
    media, a five-query shadow walk for each lane that samples an emitter:
    at least the camera's lanes, at most six queries per lane and bounce;
    and both tracking loops ran."""
    lanes = RES * RES * SPP
    assert lanes < renders["n"] <= 6 * DEPTH * lanes
    assert renders["steps"]["distance"] > 0
    assert renders["steps"]["transmittance"] > 0
