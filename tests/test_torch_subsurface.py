"""Port parity, subsurface scattering: the dipole profile, the irradiance
point cloud of ``prepare``, the dipole's Lo and refracted single scattering
on lanes, the builder's table, and one render of a scene holding a dipole
block and a single-scatter sphere (``chip_smoke.subsurface_scene``), against
the JAX package on the same numpy inputs, on the CPU.

The JAX side is four jitted functions, each compiled by XLA in a thread
while the port's tests run: the render pass first (on a stand-in of the
prepared scene's shapes), then ``prepare`` over the concrete scene (one
compile in place of its eager loop's many), ``dipole_rd`` and the lane
functions.

Tolerances:
  * the builder's table, the points, their normals, owners and area
    weights: exactly (the same numpy arithmetic and generator);
  * dipole_rd: rtol 1e-5 / atol 1e-12 (exp, sqrt and a cube an ulp or two
    apart in XLA and PyTorch; Rd spans many decades, so the atol is tiny);
  * the irradiance E: rtol 1e-5 / atol 1e-6 (the same NEE samples and
    shadow queries, each a few float32 ops apart);
  * eval_lo and exact_single_scatter: rtol 1e-4 / atol 1e-6 (a 256-point
    float32 sum in another order; the single-scatter chain of a refraction,
    two closest hits, a log and three exps);
  * the render (8x8, 4 spp, depth 3, box filter): the mean within 1e-4
    relative, every pixel within atol 1e-4 / rtol 1e-3.
"""
import concurrent.futures
import dataclasses
import sys
from pathlib import Path

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
from mitsuba_tpu.render import subsurface as jsss
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render import subsurface as tsss
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_render import SSS_FIELDS, jax_scene_arrays

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke as cs  # noqa: E402

N_POINTS, NEE = 256, 4     # prepare's points and NEE samples
R = 384                    # lanes of the lane tests
RES, SPP, DEPTH = 8, 4, 3
DIM = tcommon.DIM_BASE + tcommon.DIM_SSS   # the first bounce's spare slot
TOL = dict(rtol=1e-5, atol=1e-6)
LANE_TOL = dict(rtol=1e-4, atol=1e-6)


def _rays():
    """R rays from the camera: a third toward the dipole block, a third
    toward the sphere, a third anywhere in the box."""
    rng = np.random.default_rng(3)
    k = R // 3
    tgt = np.concatenate([
        np.stack([rng.uniform(0.55, 0.75, k), rng.uniform(0.05, 0.55, k),
                  np.full(k, 0.45)], -1),
        np.stack([rng.uniform(0.15, 0.39, k), rng.uniform(0.35, 0.59, k),
                  np.full(k, 0.22)], -1),
        np.stack([rng.uniform(0.0, 1.0, R - 2 * k),
                  rng.uniform(0.0, 1.0, R - 2 * k),
                  np.full(R - 2 * k, 0.5)], -1)])
    o = np.tile(np.float32(cs.EYE), (R, 1))
    d = tgt - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _rd_args():
    """Seeded (r2, sigma_s, sigma_a, g, eta) of R lanes, eta on both sides
    of 1 (both fits of Fdr)."""
    rng = np.random.default_rng(11)
    return (np.float32(rng.uniform(0.0, 0.3, (R, 1)) ** 2),
            np.float32(rng.uniform(0.5, 40.0, (R, 3))),
            np.float32(rng.uniform(0.01, 3.0, (R, 3))),
            np.float32(rng.uniform(-0.5, 0.9, (R, 1))),
            np.float32(rng.uniform(0.7, 1.8, (R, 1))))


def _settings(mod, spp):
    return mod.RenderSettings(width=RES, height=RES, spp=spp,
                              spp_per_pass=spp, filter_type=0)


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """The JAX scene, and its one-sample render pass (which takes the
    prepared scene as an argument, lowered on a stand-in of its shapes)
    compiled in a thread while the port's tests run; ``lower`` lowers the
    other JAX functions on demand, each compiled in a thread too."""
    js, jst = cs.subsurface_scene(jscene.SceneBuilder(), jbsdf, jshapes,
                                  JTransform, jsss).build()
    pool = concurrent.futures.ThreadPoolExecutor(2)
    stand_in = js._replace(sss=js.sss._replace(
        points_p=jnp.zeros((N_POINTS, 3)), points_n=jnp.zeros((N_POINTS, 3)),
        points_E=jnp.zeros((N_POINTS, 3)),
        points_sss=jnp.zeros((N_POINTS,), jnp.int32),
        point_area=jnp.zeros((N_POINTS,))))

    def lower(fn, *args):
        return pool.submit(jax.jit(fn).trace(*args).lower().compile)

    sensor = jsensor.make_perspective(JTransform.look_at(cs.EYE, cs.AT,
                                                         cs.UP), cs.FOV,
                                      RES, RES)
    cfg = jcommon.IntegratorConfig(type=jcommon.PATH, max_depth=DEPTH)

    def one_pass(scene_, film_data, s):
        return japi.render_pass(scene_, jst, sensor, cfg, _settings(japi, 1),
                                jfilm.Film(film_data), s, 1).data

    with pool:
        yield dict(scene=js, static=jst, lower=lower,
                   one_pass=lower(one_pass, stand_in,
                                  jnp.zeros((RES, RES, 4)), jnp.int32(0)))


@pytest.fixture(scope="module")
def jax_prepared(jax_side):
    js, jst = jax_side["scene"], jax_side["static"]
    sss = jax_side["lower"](lambda: jsss.prepare(
        js, jst, n_points=N_POINTS, nee_samples=NEE).sss).result()()
    return js._replace(sss=sss), jst


@pytest.fixture(scope="module")
def port_scene():
    return cs.subsurface_scene(tscene.SceneBuilder(), tbsdf, tshapes,
                               TTransform, tsss).build(device="cpu")


@pytest.fixture(scope="module")
def port_prepared(port_scene):
    scene, static = port_scene
    return tsss.prepare(scene, static, n_points=N_POINTS,
                        nee_samples=NEE), static


@pytest.mark.parametrize("field", SSS_FIELDS[:6])
def test_builder_table_equals_jax(jax_side, port_scene, field):
    ref = np.asarray(getattr(jax_side["scene"].sss, field))
    out = getattr(port_scene[0].sss, field).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_static_facts_equal_jax(jax_side, port_scene):
    jst, tst = jax_side["static"], port_scene[1]
    assert tst.has_sss and tst.has_singlescatter
    assert (jst.has_sss, jst.has_singlescatter) == (True, True)
    assert port_scene[0].sss.mode.tolist() == [tsss.MODE_DIPOLE,
                                               tsss.MODE_SINGLESCATTER]


def test_dipole_rd_matches_jax(jax_side):
    args = _rd_args()
    jargs = tuple(map(jnp.asarray, args))
    ref = np.asarray(jax_side["lower"](jsss.dipole_rd, *jargs).result()(
        *jargs))
    out = tsss.dipole_rd(*map(torch.from_numpy, args))
    assert np.isfinite(ref).all() and ref.min() > 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("field", SSS_FIELDS[6:])
def test_prepare_points_equal_jax(jax_prepared, port_prepared, field):
    ref = np.asarray(getattr(jax_prepared[0].sss, field))
    out = getattr(port_prepared[0].sss, field).numpy()
    assert out.dtype == ref.dtype and out.shape[0] == N_POINTS
    if field == "points_E":
        assert ref.max() > 0
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        np.testing.assert_array_equal(out, ref)


def test_prepare_leaves_a_scene_without_dipole_triangles(port_scene):
    """Only triangles are sampled (the JAX package's rule, copied: a
    profile on a sphere alone gathers no points): a scene whose only
    subsurface material is the single-scatter sphere's comes back as it
    went in."""
    scene, static = cs.subsurface_scene(
        tscene.SceneBuilder(), tbsdf, tshapes, TTransform, tsss,
        dipole=False).build(device="cpu")
    assert tsss.prepare(scene, static) is scene


@pytest.fixture(scope="module")
def lanes(jax_side, jax_prepared):
    """eval_lo and exact_single_scatter of both packages on R rays, the
    port on the JAX scene carried across with its point cloud."""
    js, jst = jax_prepared

    def both(scene_, o, d):
        its = jscene.ray_intersect(scene_, jst, o, d, 1e-4, jnp.inf)
        lo = jsss.eval_lo(scene_, its, d)
        ss = jsss.exact_single_scatter(
            scene_, jst, its, d, jnp.int32(0), jnp.arange(R, dtype=jnp.int32),
            jnp.int32(0), DIM, its.valid)
        return lo, ss

    o, d = _rays()
    args = (js, jnp.asarray(o), jnp.asarray(d))
    ref_lo, ref_ss = jax_side["lower"](both, *args).result()(*args)
    scene, static = bridge.scene_from_arrays(
        jax_scene_arrays(js), dataclasses.asdict(jst), device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    its = tscene.ray_intersect(scene, static, to, td, 1e-4, torch.inf)
    lo = tsss.eval_lo(scene, its, td)
    ss = tsss.exact_single_scatter(scene, static, its, td, 0,
                                   torch.arange(R, dtype=torch.int32), 0,
                                   DIM, its.valid)
    return dict(ref_lo=np.asarray(ref_lo), ref_ss=np.asarray(ref_ss),
                lo=lo.numpy(), ss=ss.numpy())


def test_eval_lo_matches_jax(lanes):
    ref = lanes["ref_lo"]
    assert (ref.max(axis=-1) > 0).sum() >= R // 4   # the block's lanes
    np.testing.assert_allclose(lanes["lo"], ref, **LANE_TOL)


def test_exact_single_scatter_matches_jax(lanes):
    ref = lanes["ref_ss"]
    assert (ref.max(axis=-1) > 0).sum() >= R // 10  # the sphere's lanes
    np.testing.assert_allclose(lanes["ss"], ref, **LANE_TOL)


def test_render_matches_jax(jax_side, jax_prepared, port_prepared):
    js = jax_prepared[0]
    one_pass = jax_side["one_pass"].result()
    film = jnp.zeros((RES, RES, 4))
    for s in range(SPP):
        film = one_pass(js, film, jnp.int32(s))
    ref = np.asarray(jfilm.develop(jfilm.Film(film)))
    scene, static = port_prepared
    img = tapi.render(
        scene, static,
        tsensor.make_perspective(TTransform.look_at(cs.EYE, cs.AT, cs.UP),
                                 cs.FOV, RES, RES, device="cpu"),
        tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=DEPTH),
        _settings(tapi, SPP), device="cpu").numpy()
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-2
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-4)
    np.testing.assert_allclose(img, ref, atol=1e-4, rtol=1e-3)


def test_entry_points_raise_without_a_card():
    """The builder of a subsurface scene defaults to CUDA and raises
    without it; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.subsurface_scene(tscene.SceneBuilder(), tbsdf, tshapes,
                            TTransform, tsss).build()
