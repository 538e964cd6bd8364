"""Port parity, bunny slice: bench.py's bunny_x2 layout shrunk to test size
(two instances of a 24x24 heightfield -- 2,118 triangles with the floor, so a
BVH --, a 64x64 bitmap floor with its MIP chain, a 16x32 environment map with
a sun), built and rendered by mitsuba_tpu_torch and by the JAX package on the
CPU, and carried across by the bridge.

Tolerances:
  * builder tables, the bridge, MIP chains and envmap/alias tables: exact
    (the same numpy arithmetic, cast to float32 at the end);
  * texture lookups, envmap eval/pdf/sampling, footprints and NEE samples:
    rtol 1e-5 / atol 1e-6, except that an envmap direction's texel can flip
    with the last bit of its angles at a texel border, so sampled and looked
    up texels are held on 99.5% of the lanes;
  * the render (32x32, depth 5, 2 spp, seed 0): image means within 1e-3
    relative, >= 99% of pixels within atol 1e-4 / rtol 1e-3 (the JAX CPU
    backend walks its BVH with accel/traverse.py, whose leaf box test and
    safe_div inverse can flip a grazing hit; measured: every pixel within
    1.5e-5);
  * the bridged scene renders the port's image bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import emitter as jem
from mitsuba_tpu.render import records as jrec
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render import texture as jtex
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.ops import cuda_bvh as cb
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import emitter as tem
from mitsuba_tpu_torch.render import records as trec
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render import texture as ttex
from mitsuba_tpu_torch.render.integrators import common as tcommon

TOL = dict(rtol=1e-5, atol=1e-6)
W = H = 32
SPP = 2
EYE, AT, UP, FOV = [0.0, 0.25, -0.75], [0.0, 0.1, 0.0], [0, 1, 0], 45.0

TRI_FIELDS = ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_gn", "tri_mat",
              "tri_emitter", "tri_nee_pdf_area")
MAT_FIELDS = ("type", "albedo", "albedo_tex", "twosided")
TEX_FIELDS = ("type", "uv_scale", "uv_offset", "scale", "bitmap_idx", "stack",
              "stack_hw", "sizes", "mips", "mips_hw")
EM_FIELDS = ("type", "radiance", "pmf", "cdf", "etri_tri", "etri_cdf",
             "env_index", "env_map", "env_alias", "env_hw", "env_to_world",
             "env_scale")
FIELD_PATHS = ([(f,) for f in TRI_FIELDS + ("aabb_lo", "aabb_hi", "radius")]
               + [("materials", f) for f in MAT_FIELDS]
               + [("textures", f) for f in TEX_FIELDS]
               + [("emitters", f) for f in EM_FIELDS])


def bunny_layout(builder, shapes, transform, n=24, tex=64, env_hw=(16, 32),
                 **build_kw):
    """bench.py:build_bunny_scene's layout at test size, built through
    either package (the same calls on each)."""
    b = builder()
    h = np.sin(np.linspace(0, 8, n))[:, None] * np.cos(
        np.linspace(0, 8, n))[None, :] * 0.02
    v, f, _ = shapes.heightfield(h, extent=(0.3, 0.3))
    lo, hi = v.min(axis=0), v.max(axis=0)
    scale = 0.2 / (hi[1] - lo[1])
    v = (v - lo) * scale
    v[:, 0] -= 0.5 * (hi[0] - lo[0]) * scale
    v[:, 2] -= 0.5 * (hi[2] - lo[2]) * scale
    white = b.add_material(albedo=(0.6, 0.55, 0.5))
    g = b.add_shapegroup([dict(verts=v, faces=f, mat=white)])
    b.add_instance(g, transform.translate([-0.13, 0.0, 0.0]))
    b.add_instance(g, transform.translate([0.13, 0.0, 0.05]))
    yy, xx = np.meshgrid(np.arange(tex), np.arange(tex), indexing="ij")
    c = ((xx // 4 + yy // 4) % 2).astype(np.float32)
    img = np.stack([0.2 + 0.6 * c, 0.25 + 0.45 * c, 0.3 + 0.3 * c], axis=-1)
    t = b.add_texture_bitmap(img, uv_scale=(8.0, 8.0))
    floor = b.add_material(albedo=(1.0, 1.0, 1.0), albedo_tex=t)
    b.add_mesh([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
               [[0, 2, 1], [0, 3, 2]], floor,
               uvs=[[0, 0], [1, 0], [1, 1], [0, 1]])
    He, We = env_hw
    th = (np.arange(He) + 0.5) / He * np.pi
    ph = (np.arange(We) + 0.5) / We * 2 * np.pi
    T, P = np.meshgrid(th, ph, indexing="ij")
    sky = np.stack([0.35 + 0.3 * np.cos(T), 0.45 + 0.35 * np.cos(T),
                    0.8 + 0.2 * np.cos(T)], axis=-1).astype(np.float32)
    sun = np.array([np.sin(0.9) * np.cos(0.7), np.cos(0.9),
                    np.sin(0.9) * np.sin(0.7)])
    dirs = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                    axis=-1)
    sky += (np.clip(dirs @ sun, 0, 1) ** 40)[..., None] * np.array(
        [40.0, 38.0, 30.0], np.float32)
    b.add_envmap(sky)
    return b.build(**build_kw)


def jax_scene_arrays(scene):
    """The JAX Scene's leaves that the port reads, as numpy, by field name."""
    arrays = {f: np.asarray(getattr(scene, f)) for f in TRI_FIELDS + (
        "aabb_lo", "aabb_hi", "radius", "bvh_pages")}
    for table, fields in (("materials", MAT_FIELDS), ("textures", TEX_FIELDS),
                          ("emitters", EM_FIELDS)):
        arrays[table] = {f: np.asarray(getattr(getattr(scene, table), f))
                         for f in fields}
    return arrays


@pytest.fixture(scope="module")
def jax_bunny():
    return bunny_layout(jscene.SceneBuilder, jshapes, JTransform)


@pytest.fixture(scope="module")
def port_bunny():
    return bunny_layout(tscene.SceneBuilder, tshapes, TTransform, device="cpu")


@pytest.fixture(scope="module")
def bridged(jax_bunny):
    return bridge.scene_from_arrays(jax_scene_arrays(jax_bunny[0]),
                                    dataclasses.asdict(jax_bunny[1]),
                                    device="cpu")


def _leaf(tree, path):
    for p in path:
        tree = getattr(tree, p)
    return tree


# --- builder and bridge -----------------------------------------------------

@pytest.mark.parametrize("path", FIELD_PATHS, ids=".".join)
def test_builder_matches_jax(jax_bunny, port_bunny, path):
    """Instancing, the BVH scene's bounds, the bitmap and its MIP chain, the
    envmap and its alias table: the same tables as the JAX builder."""
    ref = np.asarray(_leaf(jax_bunny[0], path))
    out = _leaf(port_bunny[0], path).numpy()
    assert out.dtype == ref.dtype, path
    np.testing.assert_array_equal(out, ref)


def test_builder_static_matches_jax(jax_bunny, port_bunny):
    jst = dataclasses.asdict(jax_bunny[1])
    st = dataclasses.asdict(port_bunny[1])
    assert st["use_bvh"] and st["has_env"] and st["has_textures"]
    for k, v in st.items():
        assert v == jst[k], k


def test_builder_nodes_match_jax_pages(jax_bunny, port_bunny):
    """The same tree (the numpy route at this size) packed both ways."""
    N = port_bunny[1].n_bvh_nodes
    ref = bridge.nodes_from_pages(np.asarray(jax_bunny[0].bvh_pages), N)
    np.testing.assert_array_equal(port_bunny[0].nodes.numpy(), ref)


def test_bridge_carries_the_bvh_scene(port_bunny, bridged):
    scene, static = bridged
    assert static == port_bunny[1]
    for f in scene._fields:
        a, b = getattr(scene, f), getattr(port_bunny[0], f)
        for x, y in zip(*((t,) if isinstance(t, torch.Tensor) else t
                          for t in (a, b))):
            assert x.dtype == y.dtype and torch.equal(x, y), f


def test_bridge_rejects_procedural_textures(jax_bunny):
    arrays = jax_scene_arrays(jax_bunny[0])
    arrays["textures"]["type"] = np.asarray([jtex.TEX_CHECKERBOARD], np.int32)
    with pytest.raises(NotImplementedError, match="bitmaps"):
        bridge.scene_from_arrays(arrays, dataclasses.asdict(jax_bunny[1]),
                                 device="cpu")


# --- textures ---------------------------------------------------------------

def test_mip_chain_matches_jax():
    """A non-square, odd-sized bitmap beside a smaller one in one stack."""
    rs = np.random.default_rng(6)
    stack = rs.random((2, 37, 52, 3)).astype(np.float32)
    sizes = np.asarray([[37, 52], [20, 9]], np.int32)
    np.testing.assert_array_equal(ttex.build_mip_chain(stack, sizes),
                                  jtex.build_mip_chain(stack, sizes))
    for h, w in ((37, 52), (20, 9), (1, 8), (512, 512)):
        assert ttex.n_mip_levels(h, w) == jtex.n_mip_levels(h, w)


@pytest.mark.parametrize("footprint", [False, True], ids=["bilinear", "trilinear"])
def test_eval_texture_matches_jax(jax_bunny, port_bunny, footprint):
    """4,096 lookups at random uvs (and footprints spanning every MIP
    level), some lanes untextured (tex_id -1 -> default)."""
    rs = np.random.default_rng(7)
    n = 4096
    uv = rs.uniform(-2, 3, (n, 2)).astype(np.float32)
    tex_id = np.where(rs.random(n) < 0.1, -1, 0).astype(np.int32)
    default = rs.random((n, 3)).astype(np.float32)
    fp = (10.0 ** rs.uniform(-5, 0, n)).astype(np.float32) if footprint else None
    ref = jax.jit(jtex.eval_texture)(
        jax_bunny[0].textures, jnp.asarray(tex_id), jnp.asarray(uv),
        jnp.asarray(default), fp_uv=None if fp is None else jnp.asarray(fp))
    out = ttex.eval_texture(port_bunny[0].textures, torch.from_numpy(tex_id),
                            torch.from_numpy(uv), torch.from_numpy(default),
                            fp_uv=None if fp is None else torch.from_numpy(fp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_uv_footprint_matches_jax(jax_bunny, port_bunny):
    """The ray-cone footprint on hit records of random triangles (floor
    triangles have uvs, heightfield ones none)."""
    rs = np.random.default_rng(8)
    n = 2048
    T = port_bunny[1].n_tris
    prim = rs.integers(-1, T, n).astype(np.int32)
    prim[:16] = [T - 1, T - 2] * 8  # the floor
    valid = prim >= 0
    t = np.where(valid, rs.uniform(0.1, 3.0, n), np.inf).astype(np.float32)
    wi = rs.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    gn = np.asarray(jax_bunny[0].tri_gn)[np.maximum(prim, 0)]
    spread = np.float32(0.003)

    def record(mod, conv):
        fields = {f: None for f in mod.Interaction._fields}
        fields.update(valid=conv(valid), t=conv(t), prim_id=conv(prim),
                      wi_world=conv(wi), gn=conv(gn))
        return mod.Interaction(**fields)

    ref = jax.jit(jscene.uv_footprint)(jax_bunny[0], record(jrec, jnp.asarray),
                                       jnp.asarray(spread))
    out = tscene.uv_footprint(port_bunny[0], record(trec, torch.from_numpy),
                              torch.tensor(spread))
    assert (np.asarray(ref)[:16] > 0).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# --- environment map --------------------------------------------------------

def _share_close(out, ref, share=0.995):
    close = np.isclose(out, ref, **TOL)
    close = close.all(axis=-1) if close.ndim > 1 else close
    assert close.mean() >= share, close.mean()


def test_eval_env_pdf_matches_jax(jax_bunny, port_bunny):
    rs = np.random.default_rng(9)
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jax.jit(jem.eval_env_pdf, static_argnums=1)(
        jax_bunny[0], jax_bunny[1], jnp.asarray(d))
    out = tem.eval_env_pdf(port_bunny[0], port_bunny[1], torch.from_numpy(d))
    for a, b in zip(out, ref):
        _share_close(a.numpy(), np.asarray(b))


def test_envmap_sample_matches_jax(jax_bunny, port_bunny):
    """Alias-table sampling of 4,096 uniforms: direction, pdf, radiance; the
    sampled directions' looked-up pdf equals the sampled pdf."""
    u = np.random.default_rng(10).random((4096, 2)).astype(np.float32)
    ref = jax.jit(jem._envmap_sample)(jax_bunny[0].emitters, jnp.asarray(u))
    out = tem._envmap_sample(port_bunny[0].emitters, torch.from_numpy(u))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    _, pdf_back = tem.eval_env_pdf(port_bunny[0], port_bunny[1], out[0])
    _share_close(pdf_back.numpy(), out[1].numpy())


def test_sample_direct_envmap_matches_jax(jax_bunny, port_bunny):
    rs = np.random.default_rng(11)
    p = rs.uniform(-0.5, 0.5, (2048, 3)).astype(np.float32)
    u = rs.random((2048, 3)).astype(np.float32)
    ref = jax.jit(jem.sample_direct, static_argnums=1)(
        jax_bunny[0], jax_bunny[1], jnp.asarray(p), jnp.asarray(u))
    out = tem.sample_direct(port_bunny[0], port_bunny[1], torch.from_numpy(p),
                            torch.from_numpy(u))
    for f in ref._fields:
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)


# --- the slice end to end ---------------------------------------------------

@pytest.fixture(scope="module")
def renders(jax_bunny, port_bunny, bridged):
    """32x32, 2 spp, depth 5, seed 0 through both packages and through the
    bridged scene. The JAX render takes one sample per pass (the same
    samples; one traced sample compiles in half the time)."""
    cam_j = JTransform.look_at(EYE, AT, UP)
    ref = np.asarray(japi.render(
        *jax_bunny, jsensor.make_perspective(cam_j, FOV, W, H),
        jcommon.IntegratorConfig(type=jcommon.PATH, max_depth=5),
        japi.RenderSettings(width=W, height=H, spp=SPP, spp_per_pass=1)))
    sens = tsensor.make_perspective(TTransform.look_at(EYE, AT, UP), FOV, W,
                                    H, device="cpu")
    cfg = tcommon.IntegratorConfig(type=tcommon.PATH, max_depth=5)
    st = tapi.RenderSettings(width=W, height=H, spp=SPP, spp_per_pass=SPP)
    img, n_rays = tapi.render(*port_bunny, sens, cfg, st, device="cpu",
                              with_stats=True)
    img_b = tapi.render(*bridged, sens, cfg, st, device="cpu")
    return ref, img.numpy(), img_b.numpy(), n_rays


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


def test_render_of_the_bridged_scene_is_the_ports(renders):
    _, img, img_b, n_rays = renders
    assert n_rays > H * W * SPP
    np.testing.assert_array_equal(img_b, img)


def test_render_launch_counts_follow_the_jax_dispatch(monkeypatch, port_bunny):
    """Per sample: K4 once (bounce 0, presorted); K3 4 x (4 + 1) for bounces
    1-4 and 5 x (1 + 1) for the shadow rays, = 30. Counted as wrapper calls,
    which on the CPU run the plain versions."""
    calls = {"k3": 0, "k4": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cb, "lane_chunk", counting("k3", cb.lane_chunk))
    monkeypatch.setattr(cb, "bvh_traverse_lane_packed",
                        counting("k4", cb.bvh_traverse_lane_packed))
    sens = tsensor.make_perspective(TTransform.look_at(EYE, AT, UP), FOV, 8, 8,
                                    device="cpu")
    tapi.render(*port_bunny, sens, tcommon.IntegratorConfig(max_depth=5),
                tapi.RenderSettings(width=8, height=8, spp=2, spp_per_pass=2),
                device="cpu")
    assert calls == {"k3": 2 * 30, "k4": 2 * 1}
