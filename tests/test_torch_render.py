"""Port parity, render layer: the Cornell box slice of mitsuba_tpu_torch
against the JAX package on the CPU — scene building, the bridge, camera, film,
emitter and BSDF modules, and the whole render.

Both sides draw the same PCG samples, so images agree up to float32
rounding; a lane whose path takes another branch after a last-bit difference
(e.g. a Russian-roulette comparison) changes its pixel, hence the "99% of
pixels" criterion beside the image means. Tolerances per test:
  * builder and bridge tables: exact (the same numpy arithmetic, cast to
    float32 at the end);
  * ray generation, film, emitter and BSDF samples: rtol 1e-5 / atol 1e-6;
  * the render: image means within 1e-3 relative, >= 99% of pixels within
    atol 1e-4 / rtol 1e-3, equal ray-query counts.
"""
import ast
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import emitter as jem
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import rfilter as jrfilter
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu.render.integrators import path as jpath
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import emitter as tem
from mitsuba_tpu_torch.render import film as tfilm
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
W = H = 32
SPP = 2

TRI_FIELDS = ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_gn", "tri_mat",
              "tri_emitter", "tri_nee_pdf_area")
MAT_FIELDS = ("type", "dist", "albedo", "albedo_tex", "spec_refl", "eta", "k",
              "alpha", "twosided", "spec_trans", "nonlinear", "rt_coef",
              "rt_fdr", "hk_thickness", "hk_g", "opacity_tex", "nested_a",
              "nested_b", "weight", "weight_tex", "normal_tex", "bump_tex",
              "bump_scale", "cauchy_b", "irawan", "interior_medium",
              "exterior_medium")
# the participating media (render/medium.py)
MEDIUM_FIELDS = ("type", "sigma_t", "albedo", "phase_type", "phase_g",
                 "phase_g2", "phase_w2", "phase_ks", "phase_exp",
                 "phase_sigma", "phase_axis", "scale", "grid_idx", "grids",
                 "grid_size", "world_to_grid", "majorant", "super_maj")
# the weave-pattern table (render/irawan.py)
IRAWAN_FIELDS = ("pattern", "tile_w", "tile_h", "yarns", "yarn_kd", "yarn_ks",
                 "meta", "repeat", "spec_norm")
EM_FIELDS = ("type", "radiance", "position", "direction", "spot_cos",
             "delta", "pmf", "cdf",
             "etri_tri", "etri_cdf", "env_index", "env_map", "env_alias",
             "env_hw", "env_to_world", "env_scale")
# the subsurface table (render/subsurface.py)
SSS_FIELDS = ("mat_sss", "sigma_s", "sigma_a", "g", "eta", "mode", "points_p",
              "points_n", "points_E", "points_sss", "point_area")
TEX_FIELDS = ("type", "uv_scale", "uv_offset", "scale", "bitmap_idx", "stack",
              "stack_hw", "sizes", "mips", "mips_hw")
SCENE_FIELDS = TRI_FIELDS + ("aabb_lo", "aabb_hi", "radius", "tl_root",
                             "tl_skip", "tl_lo", "tl_hi", "sph_center",
                             "sph_radius", "sph_mat", "sph_emitter")


def _np_tree(nt, fields):
    return {f: np.asarray(getattr(nt, f)) for f in fields}


def jax_scene_arrays(scene):
    """The JAX Scene's leaves that the port reads, as numpy, by field name."""
    arrays = _np_tree(scene, SCENE_FIELDS + ("bvh_pages",))
    arrays["materials"] = _np_tree(scene.materials, MAT_FIELDS)
    # the procedural columns, which the port's table leaves out where it
    # has no procedural row (so they are not in FIELD_PATHS)
    arrays["textures"] = _np_tree(scene.textures, TEX_FIELDS + (
        "color0", "color1", "line_width"))
    arrays["emitters"] = _np_tree(scene.emitters, EM_FIELDS)
    arrays["irawan"] = _np_tree(scene.irawan, IRAWAN_FIELDS)
    arrays["media"] = _np_tree(scene.media, MEDIUM_FIELDS)
    arrays["sss"] = _np_tree(scene.sss, SSS_FIELDS)
    return arrays


@pytest.fixture(scope="module")
def port_cornell():
    b = tscene.SceneBuilder()
    tshapes.cornell_box(b)
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def sensors(cornell_cam):
    js = jsensor.make_perspective(cornell_cam, FOV, W, H)
    ts = tsensor.make_perspective(Transform.look_at(EYE, AT, UP), FOV, W, H,
                                  device="cpu")
    return js, ts


def _leaf(port_scene, path):
    x = port_scene
    for p in path:
        x = getattr(x, p)
    return x.numpy()


FIELD_PATHS = ([(f,) for f in SCENE_FIELDS] + [("materials", f) for f in MAT_FIELDS]
               + [("textures", f) for f in TEX_FIELDS]
               + [("emitters", f) for f in EM_FIELDS]
               + [("irawan", f) for f in IRAWAN_FIELDS]
               + [("media", f) for f in MEDIUM_FIELDS]
               + [("sss", f) for f in SSS_FIELDS])


@pytest.mark.parametrize("path", FIELD_PATHS, ids=".".join)
def test_builder_matches_jax(cornell, port_cornell, path):
    ref = cornell[0]
    for p in path:
        ref = getattr(ref, p)
    ref = np.asarray(ref)
    out = _leaf(port_cornell[0], path)
    assert out.dtype == ref.dtype, path
    np.testing.assert_array_equal(out, ref)


def test_builder_static_matches_jax(cornell, port_cornell):
    jst = dataclasses.asdict(cornell[1])
    for k, v in dataclasses.asdict(port_cornell[1]).items():
        assert v == jst[k], k


def test_bridge_roundtrips_the_jax_scene(cornell, port_cornell):
    scene, static = bridge.scene_from_arrays(
        jax_scene_arrays(cornell[0]), dataclasses.asdict(cornell[1]), device="cpu")
    assert static == port_cornell[1]
    for path in FIELD_PATHS:
        a, b = _leaf(scene, path), _leaf(port_cornell[0], path)
        assert a.dtype == b.dtype and a.dtype != np.float64, path
        np.testing.assert_array_equal(a, b)


def test_bridge_casts_float64_to_float32(cornell):
    arrays = jax_scene_arrays(cornell[0])
    arrays["tri_p0"] = arrays["tri_p0"].astype(np.float64)
    arrays["materials"]["albedo"] = arrays["materials"]["albedo"].astype(np.float64)
    scene, _ = bridge.scene_from_arrays(arrays, dataclasses.asdict(cornell[1]),
                                        device="cpu")
    assert scene.tri_p0.dtype == torch.float32
    assert scene.materials.albedo.dtype == torch.float32


def test_bridge_sensor(sensors):
    js, ts = sensors
    out = bridge.sensor_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")
    assert out.type == ts.type
    for f in ts._fields[1:]:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(ts, f).numpy(), err_msg=f)


# BSDF 20 is a tag no BSDF has, also as a nested row (the sphere light 7
# and the plastics 4 and 5 joined the port with the Veach MIS scene, the
# smooth conductor 2 and the rough dielectric 6 with the single-layer BSDFs,
# the opacity textures and the mask 12 and rough coating 18 with the nested
# and layered ones, the point 1, directional 4 and spot 5 lights with the
# delta lights, irawan 19, the last BSDF type, with the woven cloth);
# medium 2 and phase 6 are tags no medium and no phase function has (the
# boundary media, the homogeneous and grid media 0 and 1 and the six phase
# functions 0-5 joined the port with the volumetric path tracer: see
# test_media_facts_carry_over; has_sss and has_singlescatter joined it with
# subsurface scattering: see test_subsurface_facts_carry_over)
@pytest.mark.parametrize("change", [
    dict(ewa_taps=4),
    dict(bsdf_types=(0, 20)), dict(nested_bsdf_types=(20,)),
    dict(medium_types=(2,)), dict(phase_types=(6,)),
])
def test_later_slices_raise(cornell, change):
    static = dict(dataclasses.asdict(cornell[1]), **change)
    with pytest.raises(NotImplementedError):
        bridge.scene_from_arrays(jax_scene_arrays(cornell[0]), static, device="cpu")


# the media's static facts, which raised in test_later_slices_raise until
# the port rendered them: each now carries over
@pytest.mark.parametrize("change", [
    dict(has_boundary_media=True), dict(medium_types=(0, 1)),
    dict(phase_types=(0, 1, 2, 3, 4, 5)),
])
def test_media_facts_carry_over(cornell, change):
    static = dict(dataclasses.asdict(cornell[1]), **change)
    _, st = bridge.scene_from_arrays(jax_scene_arrays(cornell[0]), static,
                                     device="cpu")
    for k, v in change.items():
        assert getattr(st, k) == v


# the subsurface facts, which raised in test_later_slices_raise until the
# port rendered them: each now carries over, with the empty table (the JAX
# scene's own sss table comes across when given: test_torch_subsurface.py)
@pytest.mark.parametrize("change", [
    dict(has_sss=True), dict(has_singlescatter=True),
])
def test_subsurface_facts_carry_over(cornell, change):
    static = dict(dataclasses.asdict(cornell[1]), **change)
    scene, st = bridge.scene_from_arrays(jax_scene_arrays(cornell[0]), static,
                                         device="cpu")
    for k, v in change.items():
        assert getattr(st, k) == v
    assert scene.sss.mat_sss.tolist() == [-1] * len(
        scene.materials.type.tolist())


def test_sample_ray_matches_jax(sensors):
    js, ts = sensors
    uv = np.random.default_rng(0).random((4096, 2)).astype(np.float32)
    o_ref, d_ref = (np.asarray(x) for x in jax.jit(jsensor.sample_ray)(
        js, jnp.asarray(uv), jnp.zeros((4096, 2))))
    o, d = tsensor.sample_ray(ts, torch.from_numpy(uv), torch.zeros(4096, 2))
    np.testing.assert_allclose(o.numpy(), o_ref, **TOL)
    np.testing.assert_allclose(d.numpy(), d_ref, **TOL)
    np.testing.assert_allclose(tsensor.pixel_spread(ts, W).numpy(),
                               np.asarray(jsensor.pixel_spread(js, W)), **TOL)


def test_pixel_sample_positions_match_jax():
    st_j = japi.RenderSettings(width=24, height=16)
    st_t = tapi.RenderSettings(width=24, height=16)
    pix = np.arange(24 * 16, dtype=np.int32)
    ref = np.asarray(japi.pixel_sample_positions(st_j, jnp.asarray(pix), 3, 5))
    out = tapi.pixel_sample_positions(st_t, torch.from_numpy(pix).long(), 3, 5)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_splat_grid_and_develop_match_jax():
    rs = np.random.default_rng(1)
    h, w = 12, 20
    pos = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
           + rs.random((h, w, 2))).astype(np.float32)
    val = rs.random((h, w, 3)).astype(np.float32) * 3
    val[0, 0, 1] = np.nan  # dropped, like ImageBlock::put
    val[3, 4, 2] = -1.0
    prior = rs.random((h, w, 4)).astype(np.float32)
    # jitted, as render_pass runs it (one compile instead of ~100 eager ones)
    ref = jax.jit(lambda f, p, v: jfilm.splat_grid(
        jfilm.Film(f), p, v, jrfilter.GAUSSIAN, 0))(
            jnp.asarray(prior), jnp.asarray(pos), jnp.asarray(val))
    out = tfilm.splat_grid(tfilm.Film(torch.from_numpy(prior)),
                           torch.from_numpy(pos), torch.from_numpy(val),
                           jrfilter.GAUSSIAN)
    np.testing.assert_allclose(out.data.numpy(), np.asarray(ref.data), **TOL)
    np.testing.assert_allclose(tfilm.develop(out).numpy(),
                               np.asarray(jax.jit(jfilm.develop)(ref)), **TOL)


@pytest.fixture(scope="module")
def hits(cornell, port_cornell):
    """Points on the Cornell walls (interactions of random camera rays), for
    the emitter and BSDF modules."""
    rs = np.random.default_rng(2)
    n = 2048
    o = np.tile(np.float32(EYE), (n, 1))
    d = np.stack([rs.uniform(-0.3, 0.3, n), rs.uniform(-0.3, 0.3, n), np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jits = jscene.ray_intersect(cornell[0], cornell[1], jnp.asarray(o),
                                jnp.asarray(d), 1e-4, jnp.inf)
    tits = tscene.ray_intersect(port_cornell[0], port_cornell[1],
                                torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                                torch.inf)
    u = rs.random((n, 4)).astype(np.float32)
    return jits, tits, u


@pytest.mark.parametrize("field", ["valid", "t", "p", "gn", "uv", "wi", "mat_id",
                                   "emitter_id", "prim_id", "nee_pdf_area"])
def test_ray_intersect_matches_jax(hits, field):
    jits, tits, _ = hits
    ref, out = np.asarray(getattr(jits, field)), getattr(tits, field).numpy()
    if ref.dtype.kind in "bi":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, **TOL)


def test_sample_direct_matches_jax(cornell, port_cornell, hits):
    jits, tits, u = hits
    ref = jem.sample_direct(cornell[0], cornell[1], jits.p, jnp.asarray(u[:, :3]))
    out = tem.sample_direct(port_cornell[0], port_cornell[1], tits.p,
                            torch.from_numpy(u[:, :3]))
    for f in ref._fields:
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(
        tscene.pdf_emitter_hit(port_cornell[0], tits, torch.zeros(len(u), 3),
                               port_cornell[1]).numpy(),
        np.asarray(jscene.pdf_emitter_hit(cornell[0], jits, jnp.zeros((len(u), 3)),
                                          cornell[1])),
        **TOL)


def test_bsdf_matches_jax(cornell, port_cornell, hits):
    jits, tits, u = hits
    jbl = jscene.bsdf_locals(cornell[0], jits, cornell[1])
    tbl = tscene.bsdf_locals(port_cornell[0], tits, port_cornell[1])
    wo = np.random.default_rng(3).normal(size=(len(u), 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    types = cornell[1].bsdf_types
    for fn in ("eval", "pdf"):
        ref = getattr(jbsdf, fn)(jbl, jits.wi, jnp.asarray(wo), active_types=types)
        out = getattr(tbsdf, fn)(tbl, tits.wi, torch.from_numpy(wo), active_types=types)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL, err_msg=fn)
    ref = jbsdf.sample(jbl, jits.wi, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:3]),
                       active_types=types)
    out = tbsdf.sample(tbl, tits.wi, torch.from_numpy(u[:, 0]),
                       torch.from_numpy(u[:, 1:3]), active_types=types)
    for f in ref._fields:
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   **TOL, err_msg=f)


def test_integrator_helpers_match_jax():
    rs = np.random.default_rng(4)
    a, b = rs.random(1000).astype(np.float32), rs.random(1000).astype(np.float32)
    a[:10] = 0.0
    b[:5] = 0.0
    np.testing.assert_allclose(
        tcommon.mis_power(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jcommon.mis_power(jnp.asarray(a), jnp.asarray(b))), **TOL)
    p, gn, d = (rs.normal(size=(1000, 3)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        tcommon.ray_offset(*(torch.from_numpy(x) for x in (p, gn, d))).numpy(),
        np.asarray(jcommon.ray_offset(*(jnp.asarray(x) for x in (p, gn, d)))), **TOL)


@pytest.fixture(scope="module")
def renders(cornell, port_cornell, sensors):
    """The Cornell box at 32x32, 2 spp, depth 5, seed 0, through both
    packages; JAX on its CPU backend takes the XLA brute-force path. The JAX
    side traces one sample and runs it per sample index (the same samples;
    one traced sample compiles in half the time)."""
    js, ts = sensors
    jcfg = jcommon.IntegratorConfig(type=jcommon.PATH, max_depth=5)
    ref = np.asarray(japi.render(
        cornell[0], cornell[1], js, jcfg,
        japi.RenderSettings(width=W, height=H, spp=SPP, spp_per_pass=1)))

    @jax.jit
    def jax_rays(scene, s):
        # bench.py's ray count: path.li's with_stats counter of sample s
        pix = jnp.arange(H * W, dtype=jnp.int32)
        st = japi.RenderSettings(width=W, height=H)
        pos = japi.pixel_sample_positions(st, pix, s, 0)
        o, d = jsensor.sample_ray(js, pos / jnp.asarray([W, H], jnp.float32),
                                  jnp.zeros((H * W, 2)))
        return jpath.li(scene, cornell[1], jcfg, o, d, 0, pix, s,
                        with_stats=True)[1]

    img, n_rays = tapi.render(
        port_cornell[0], port_cornell[1], ts,
        tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=5),
        tapi.RenderSettings(width=W, height=H, spp=SPP, spp_per_pass=SPP),
        device="cpu", with_stats=True)
    n_jax = sum(int(jax_rays(cornell[0], jnp.int32(s))) for s in range(SPP))
    return ref, img.numpy(), n_jax, n_rays


def test_render_image_means_match_jax(renders):
    ref, img, _, _ = renders
    assert img.shape == ref.shape == (H, W, 3)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-3)


def test_render_pixels_match_jax(renders):
    ref, img, _, _ = renders
    close = np.isclose(img, ref, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


def test_render_ray_counts_match_jax(renders):
    """Counts agree to 0.25%. They are not equal: hit points on the light
    draw NEE samples on the light's own plane, where cos_l is rounding noise
    around 0 and the 1e-7 validity test flips with the hit point's last bit
    (XLA contracts into FMAs, the kernel form does not). Such a shadow ray
    carries nothing (the light's albedo is 0), so the images still agree.
    Measured: 12,343 against 12,329, with 32 such samples in the run."""
    _, _, ref_rays, n_rays = renders
    assert n_rays > H * W * SPP
    assert abs(n_rays - ref_rays) <= 0.0025 * ref_rays


def test_render_depth_adds_indirect_light(port_cornell, sensors):
    """Depth 5 must be brighter than depth 2 (transport sanity)."""
    _, ts = sensors
    means = []
    for depth in (2, 5):
        img = tapi.render(port_cornell[0], port_cornell[1], ts,
                          tcommon.IntegratorConfig(max_depth=depth),
                          tapi.RenderSettings(width=16, height=16, spp=1),
                          device="cpu")
        means.append(img.mean().item())
    assert means[1] > means[0] * 1.1


@pytest.mark.parametrize("entry", ["build", "make_perspective", "render",
                                   "scene_from_arrays", "sensor_from_arrays"])
def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, cornell, sensors,
                                                    port_cornell, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    js, ts = sensors
    cam = Transform.look_at(EYE, AT, UP)
    b = tscene.SceneBuilder()
    tshapes.cornell_box(b)
    calls = {
        "build": lambda dev: b.build(device=dev),
        "make_perspective": lambda dev: tsensor.make_perspective(cam, FOV, 4, 4, device=dev),
        "render": lambda dev: tapi.render(
            port_cornell[0], port_cornell[1], ts, tcommon.IntegratorConfig(),
            tapi.RenderSettings(width=W, height=H, spp=1), device=dev),
        "scene_from_arrays": lambda dev: bridge.scene_from_arrays(
            jax_scene_arrays(cornell[0]), dataclasses.asdict(cornell[1]), device=dev),
        "sensor_from_arrays": lambda dev: bridge.sensor_from_arrays(
            {f: np.asarray(getattr(js, f)) for f in js._fields}, device=dev),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]("cuda")
    if entry != "render":  # the CPU render is the slice test above
        calls[entry]("cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _path_strings(path):
    """String constants of a source that name a path under mitsuba_tpu/
    (docstrings aside, and "file:line" labels of the TPU kernels a port
    kernel replaces, which nothing opens)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and re.search(r"(^|[/\\])mitsuba_tpu([/\\]|$)", node.value)
                and not re.search(r"\.py:\d+$", node.value)):
            yield node.value


def test_port_and_chip_smoke_import_no_jax():
    """No source of the port, the scene-file entry points included, and not
    chip_smoke.py imports JAX or the JAX package, or names a path under
    mitsuba_tpu/ to read (test_torch_scenefile.py also holds that the entry
    points open no file there)."""
    files = sorted((REPO / "mitsuba_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for new in ("__main__.py", "io/mitsuba_xml.py", "io/image.py",
                "utils/logging.py", "render/integrators/direct.py",
                "core/rtrans.py", "core/qmc.py", "core/sobol_table.py",
                "render/integrators/misc.py", "utils/chi2.py",
                "render/bsdf.py", "render/texture.py", "render/scene.py",
                "bridge.py", "render/emitter.py", "render/sensor.py",
                "render/api.py", "core/transform.py"):
        assert REPO / "mitsuba_tpu_torch" / new in files, new
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mitsuba_tpu"), f"{f}: imports {mod}"
        assert not list(_path_strings(f)), f"{f}: names {list(_path_strings(f))}"
