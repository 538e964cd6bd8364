"""Port parity, the nested and layered BSDFs, normal and bump maps and the
procedural textures: mask, mixturebsdf, blendbsdf, coating and roughcoating
(eval, pdf and sample with their nested rows), the constant, checkerboard
and grid textures and the scale fold, the frame that a normal or bump map
perturbs (alone and through ray_intersect), their scene-file elements
through both loaders and the bridge, against the JAX package on the same
numpy inputs, on the CPU; the port's chi-square harness on the nested
samplers; and the gathers of a scene without them. One render of a scene
that holds them all is tests/test_torch_nested_render.py's.

Tolerances (as tests/test_torch_bsdf.py's, for the same reasons):
  * eval and pdf: allclose rtol 1e-5 / atol 1e-6, and equal nonzero masks
    above 1e-30 (XLA's CPU backend flushes denormals, PyTorch keeps them);
  * sample: is_delta, the live mask (pdf > 0) and eta exactly; wo, weight
    and pdf on live lanes at rtol 3e-5 / atol 1e-6, and on ill-conditioned
    lanes (wi or wo within |z| < 0.1 of the surface) at rtol 2e-4 /
    atol 1e-5: the microfacet samplers' and warps' trigonometry, an ulp
    apart in XLA and PyTorch, grows by 1/z there, and a coating refracts
    such a direction once more; and where a coating's lane leaves its layer
    within |z| < 0.02 of the surface, at rtol 1e-2 / atol 1e-4: the exit
    cosine sqrt(1 - eta^2 sin'^2) cancels, so an ulp of sin' grows by
    1/z^2 (measured: 1.9e-3 relative in the pdf at z = 0.008);
  * textures: the procedural lanes bit for bit (selects and one multiply),
    the bitmap lanes at rtol 1e-6 / atol 1e-7;
  * the perturbed frame: rtol 1e-5 / atol 1e-5; the bump map's finite
    difference divides an ulp of the height (6e-8 at 0.5) by eps = 5e-4;
  * loaded tables exactly (the same numpy arithmetic, cast to float32 at
    the end);
  * chi-square: the JAX test's 300,000 samples and significance 5e-4
    (tests/test_bsdf.py:210-312).
"""
import dataclasses
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import rtrans as jrtrans
from mitsuba_tpu.core.frame import Frame as JFrame
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render import texture as jtex
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core.frame import Frame as TFrame
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import microfacet as tmf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render import texture as ttex
from mitsuba_tpu_torch.utils import chi2 as tchi2
from test_torch_bsdf import _directions, make_locals
from test_torch_materials import _both, _equal_tables
from test_torch_plastic import _Recorder
from test_torch_render import _leaf

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke  # noqa: E402

B = tbsdf
R = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
SAMPLE_TOL = dict(rtol=3e-5, atol=1e-6)
ILL, ILL_TOL = 0.1, dict(rtol=2e-4, atol=1e-5)
EXIT, EXIT_TOL = 0.02, dict(rtol=1e-2, atol=1e-4)
TINY = 1e-30
# the new material columns and the textures' procedural columns
NESTED_COLS = ("opacity_tex", "nested_a", "nested_b", "weight", "weight_tex",
               "normal_tex", "bump_tex", "bump_scale")
PROC_COLS = ("color0", "color1", "line_width")

# --- eval, pdf and sample against the JAX package ---------------------------

# (outer types, nested types): each nested type with the base types the
# layered gallery nests, and a batch that mixes them lane by lane (a coating
# over a conductor's delta lobe included)
CASES = {
    "mask": ((B.MASK,), (B.DIFFUSE,)),
    "mixture": ((B.MIXTURE,), (B.DIFFUSE, B.ROUGH_CONDUCTOR)),
    "blend": ((B.BLEND,), (B.DIFFUSE, B.CONDUCTOR)),
    "coating": ((B.COATING,), (B.DIFFUSE,)),
    "roughcoating": ((B.ROUGHCOATING,), (B.DIFFUSE,)),
    "mixed": ((B.DIFFUSE, B.MASK, B.MIXTURE, B.BLEND, B.COATING,
               B.ROUGHCOATING), (B.DIFFUSE, B.CONDUCTOR, B.ROUGH_CONDUCTOR)),
}
# the rough coatings' (distribution, alpha, eta), baked once each
RT_FITS = ((tmf.BECKMANN, 0.1, 1.5), (tmf.GGX, 0.3, 1.3), (tmf.GGX, 0.15, 1.5))


@pytest.fixture(scope="module")
def rt_fits():
    return [(*jrtrans.fit_poly(d, a, e)[:1],
             1.0 - jrtrans.diffuse_transmittance(d, a, 1.0 / e))
            for d, a, e in RT_FITS]


def _row(rs, types, n=R):
    """Seeded per-lane parameters of ``types`` in the ranges they read."""
    f32 = np.float32
    return dict(
        type=rs.choice(np.asarray(types, np.int32), n),
        dist=rs.integers(0, 2, n).astype(np.int32),
        albedo=rs.uniform(0.0, 1.0, (n, 3)).astype(f32),
        spec_refl=rs.uniform(0.2, 1.0, (n, 3)).astype(f32),
        spec_trans=np.ones((n, 3), f32),
        eta_s=rs.uniform(1.2, 1.8, n).astype(f32),
        eta_c=rs.uniform(0.1, 2.0, (n, 3)).astype(f32),
        k_c=rs.uniform(0.0, 1.0, (n, 3)).astype(f32),
        alpha=rs.uniform(0.05, 0.6, (n, 2)).astype(f32),
        twosided=rs.random(n) < 0.5,
        opacity=rs.uniform(0.0, 1.0, n).astype(f32),
        blend_w=rs.uniform(0.0, 1.0, n).astype(f32),
        rt_coef=np.zeros((n, 6), f32), rt_fdr=np.zeros(n, f32),
        hk_thickness=np.ones(n, f32), hk_g=np.zeros(n, f32))


def _inputs(name, fits):
    """The outer rows, nested rows A and B, directions and uniforms of a
    case. A rough coating's lane takes one of RT_FITS with its polynomial
    (a conductor's k as the absorption); a nested conductor's k in its
    range."""
    outer, ntypes = CASES[name]
    rs = np.random.default_rng(zlib.crc32(name.encode()))
    o = _row(rs, outer)
    k = rs.integers(0, len(fits), R)
    rc = o["type"] == B.ROUGHCOATING
    for i, ((d, a, e), (coef, fdr)) in enumerate(zip(RT_FITS, fits)):
        sel = rc & (k == i)
        o["dist"][sel], o["alpha"][sel], o["eta_s"][sel] = d, a, e
        o["rt_coef"][sel], o["rt_fdr"][sel] = coef, fdr
    a, b = _row(rs, ntypes), _row(rs, ntypes)
    for n in (a, b):
        n["k_c"] = rs.uniform(0.5, 4.0, (R, 3)).astype(np.float32)
    return dict(outer=o, a=a, b=b, ntypes=ntypes, types=outer,
                wi=_directions(rs), wo=_directions(rs),
                u_lobe=rs.random(R).astype(np.float32),
                u2=rs.random((R, 2)).astype(np.float32))


def _jax_locals(r):
    n = len(r["type"])
    j = jnp.asarray
    return jbsdf.BsdfLocals(
        type=j(r["type"]), dist=j(r["dist"]), albedo=j(r["albedo"]),
        spec_refl=j(r["spec_refl"]), spec_trans=j(r["spec_trans"]),
        eta_s=j(r["eta_s"]), eta_c=j(r["eta_c"]), k_c=j(r["k_c"]),
        alpha=j(r["alpha"]), nonlinear=jnp.zeros(n, bool),
        twosided=j(r["twosided"]), opacity=j(r["opacity"]),
        blend_w=j(r["blend_w"]), hk_thickness=j(r["hk_thickness"]),
        hk_g=j(r["hk_g"]), rt_coef=j(r["rt_coef"]), rt_fdr=j(r["rt_fdr"]),
        iw_par=jnp.zeros((n, 13)), iw_ks=jnp.zeros((n, 3)))


def _port_locals(r):
    t = torch.from_numpy
    return tbsdf.BsdfLocals(
        type=t(r["type"]), dist=t(r["dist"]), albedo=t(r["albedo"]),
        spec_refl=t(r["spec_refl"]), eta_c=t(r["eta_c"]), k_c=t(r["k_c"]),
        alpha=t(r["alpha"]), twosided=t(r["twosided"]),
        spec_trans=t(r["spec_trans"]), eta_s=t(r["eta_s"]),
        rt_coef=t(r["rt_coef"]), rt_fdr=t(r["rt_fdr"]),
        opacity=t(r["opacity"]), blend_w=t(r["blend_w"]))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, rt_fits):
    a = _inputs(request.param, rt_fits)
    jn = (_jax_locals(a["a"]), _jax_locals(a["b"]), a["ntypes"])
    tn = (_port_locals(a["a"]), _port_locals(a["b"]), a["ntypes"])
    return a, _jax_locals(a["outer"]), jn, _port_locals(a["outer"]), tn


def _nonzero(x):
    return np.abs(x) >= TINY


@pytest.mark.parametrize("fn", ["eval", "pdf"])
def test_eval_and_pdf_match_jax(case, fn):
    a, jbl, jn, tbl, tn = case
    ref = np.asarray(getattr(jbsdf, fn)(
        jbl, jnp.asarray(a["wi"]), jnp.asarray(a["wo"]),
        active_types=a["types"], nested=jn))
    out = getattr(tbsdf, fn)(tbl, torch.from_numpy(a["wi"]),
                             torch.from_numpy(a["wo"]),
                             active_types=a["types"], nested=tn).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(_nonzero(out), _nonzero(ref))
    live = _nonzero(ref) if ref.ndim == 1 else _nonzero(ref).any(axis=-1)
    assert live.sum() > R // 8


def test_sample_matches_jax(case):
    a, jbl, jn, tbl, tn = case
    js = jbsdf.sample(jbl, jnp.asarray(a["wi"]), jnp.asarray(a["u_lobe"]),
                      jnp.asarray(a["u2"]), active_types=a["types"],
                      nested=jn)
    ts = tbsdf.sample(tbl, torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=a["types"], nested=tn)
    np.testing.assert_array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    np.testing.assert_array_equal(ts.eta.numpy(), np.asarray(js.eta))
    live = np.asarray(js.pdf) > 0
    np.testing.assert_array_equal(ts.pdf.numpy() > 0, live)
    wo = np.asarray(js.wo)
    ill = (np.abs(a["wi"][:, 2]) < ILL) | (np.abs(wo[:, 2]) < ILL)
    exit_ = (np.isin(a["outer"]["type"], (B.COATING, B.ROUGHCOATING))
             & (np.abs(wo[:, 2]) < EXIT))
    for lanes, tol in ((live & ~ill, SAMPLE_TOL),
                       (live & ill & ~exit_, ILL_TOL),
                       (live & exit_, EXIT_TOL)):
        for f in ("wo", "weight", "pdf"):
            np.testing.assert_allclose(getattr(ts, f).numpy()[lanes],
                                       np.asarray(getattr(js, f))[lanes],
                                       **tol, err_msg=f)
    np.testing.assert_array_equal(ts.weight.numpy()[~live], 0.0)
    assert live.sum() > R // 4 and (live & ~ill).sum() > live.sum() // 2


def test_each_outer_type_draws_each_of_its_lobes(case):
    """A mask passes some lanes through (delta, wo = -wi) and scatters the
    rest; a mixture picks both rows; a coating reflects off its interface
    (delta) on some lanes and refracts into the layer on others."""
    a, _, _, tbl, tn = case
    ts = tbsdf.sample(tbl, torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=a["types"], nested=tn)
    through = np.all(ts.wo.numpy() == -a["wi"], axis=-1)
    delta = ts.is_delta.numpy()
    t = a["outer"]["type"]
    for typ in a["types"]:
        sel = t == typ
        if typ == B.MASK:
            assert 0 < (through & delta)[sel].sum() < sel.sum()
        elif typ == B.COATING:
            assert 0 < delta[sel].sum() < sel.sum()
        elif typ in (B.MIXTURE, B.BLEND):
            pick_a = a["u_lobe"] < np.clip(a["outer"]["blend_w"], 1e-4,
                                            1 - 1e-4)
            assert 0 < pick_a[sel].sum() < sel.sum()


# --- the procedural textures -----------------------------------------------

def _texture_builders():
    """The same texture list through both builders: a constant, a
    checkerboard (scaled, offset, with a multiplier), a grid, a bitmap, and
    the scale fold of the checkerboard."""
    rs = np.random.default_rng(5)
    img = rs.random((6, 8, 3)).astype(np.float32)
    out = []
    for b in (jscene.SceneBuilder(), tscene.SceneBuilder()):
        b.add_texture_constant((0.3, 0.6, 0.9))
        chk = b.add_texture_checkerboard(
            color0=(0.9, 0.1, 0.5), color1=(0.2, 0.7, 0.3),
            uv_scale=(3.0, 2.0), uv_offset=(0.1, 0.2), scale=(1.0, 2.0, 0.5))
        b.add_texture_grid(color0=(0.1, 0.2, 0.3), color1=(0.8, 0.8, 0.1),
                           line_width=0.1, uv_scale=(4.0, 4.0))
        b.add_texture_bitmap(img, uv_scale=(2.0, 1.0))
        b.add_texture_scale(chk, 0.5)
        out.append(b)
    return out


def test_procedural_textures_match_jax():
    jb, tb = _texture_builders()
    jt = jb._build_textures()
    tt = ttex.build_table(tb.textures, tb.bitmaps, "cpu")
    for f in jt._fields:
        if hasattr(tt, f):
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)), f)
    rs = np.random.default_rng(6)
    K = len(tb.textures)
    tid = rs.integers(-1, K, R).astype(np.int32)
    uv = rs.uniform(-2.0, 3.0, (R, 2)).astype(np.float32)
    default = rs.random((R, 3)).astype(np.float32)
    fp = rs.uniform(0.0, 0.3, R).astype(np.float32)
    types = np.asarray(jt.type)[np.maximum(tid, 0)]
    proc = (tid >= 0) & (types != ttex.TEX_BITMAP)
    for fp_uv in (None, fp):
        ref = np.asarray(jtex.eval_texture(
            jt, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(default),
            fp_uv=None if fp_uv is None else jnp.asarray(fp_uv)))
        out = ttex.eval_texture(
            tt, torch.from_numpy(tid), torch.from_numpy(uv),
            torch.from_numpy(default),
            fp_uv=None if fp_uv is None else torch.from_numpy(fp_uv)).numpy()
        np.testing.assert_array_equal(out[proc], ref[proc])
        np.testing.assert_array_equal(out[tid < 0], default[tid < 0])
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    # every procedural value shows up: both checker colours, cell and line
    for k in (1, 2, 4):
        assert len(np.unique(out[tid == k], axis=0)) == 2


def test_a_table_without_procedural_rows_has_no_procedural_columns():
    """A bitmap-only table leaves color0, color1 and line_width out, so its
    lookups gather what they did before the procedural textures. A table
    without a bitmap holds the JAX builder's 1x1 dummy entry."""
    jb, tb = _texture_builders()
    bitmap_only = [tb.textures[3]]
    assert ttex.build_table(bitmap_only, tb.bitmaps, "cpu").color0 is None
    assert ttex.build_table(tb.textures, tb.bitmaps, "cpu").color0 is not None
    b = tscene.SceneBuilder()
    b.add_texture_grid()
    t = ttex.build_table(b.textures, b.bitmaps, "cpu")
    assert t.stack.shape == (1, 3) and t.sizes.tolist() == [[1, 1]]
    jb = jscene.SceneBuilder()
    jb.add_texture_grid()
    np.testing.assert_array_equal(t.mips.numpy(),
                                  np.asarray(jb._build_textures().mips))


# --- normal and bump maps ----------------------------------------------------

def _map_scene(b, mesh_tf):
    """Two uv-mapped rectangles (a normal map, a bump map through a scale
    texture), a plain one, and a sphere whose material has the normal map."""
    tilt = b.add_texture_checkerboard(color0=(0.5, 0.5, 1.0),
                                      color1=(0.75, 0.5, 0.85),
                                      uv_scale=(2.0, 2.0))
    height = b.add_texture_scale(
        b.add_texture_bitmap(chip_smoke.height_field()), 0.5)
    nm = b.add_material(normal_tex=tilt)
    bm = b.add_material(bump_tex=height, bump_scale=2.0)
    plain = b.add_material()
    for k, mat in enumerate((nm, bm, plain)):
        v, f, uv = mesh_tf(k)
        b.add_mesh(v, f, mat, uvs=uv)
    b.add_sphere([0.0, 0.0, -3.0], 1.0, nm)
    return b.build(**({} if isinstance(b, jscene.SceneBuilder)
                      else {"device": "cpu"}))


def _map_scenes():
    def jtf(k):
        from mitsuba_tpu.core.transform import Transform
        return jshapes.rectangle(Transform.translate([3.0 * k, 0, 0])
                                 * Transform.rotate([0, 0, 1], 30.0 * k))

    def ttf(k):
        return tshapes.rectangle(TTransform.translate([3.0 * k, 0, 0])
                                 * TTransform.rotate([0, 0, 1], 30.0 * k))

    return _map_scene(jscene.SceneBuilder(), jtf), \
        _map_scene(tscene.SceneBuilder(), ttf)


def test_perturbed_frames_match_jax():
    (js, _), (ts, tst) = _map_scenes()
    assert tst.has_normal_maps and not tst.has_textures
    rs = np.random.default_rng(8)
    T = tst.n_tris
    tri = rs.integers(-1, T, R).astype(np.int32)
    mat = np.asarray(ts.tri_mat)[np.maximum(tri, 0)]
    mat[: R // 8] = 0  # the normal map on lanes of the other triangles
    uv = rs.uniform(-1.0, 2.0, (R, 2)).astype(np.float32)
    n = rs.normal(size=(R, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    jf = jscene._perturb_frame(js, jnp.asarray(tri), jnp.asarray(uv),
                               jnp.asarray(mat),
                               JFrame.from_normal(jnp.asarray(n)))
    tf = tscene._perturb_frame(ts, torch.from_numpy(tri),
                               torch.from_numpy(uv), torch.from_numpy(mat),
                               TFrame.from_normal(torch.from_numpy(n)))
    for f in ("s", "t", "n"):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    moved = np.abs(tf.n.numpy() - n).max(axis=1) > 1e-3
    for m_, share in ((0, 0.2), (1, 0.2)):
        assert moved[mat == m_].mean() > share
    assert not moved[mat == 2].any()


TILT = (0.75, 0.5, 0.85)


def _sphere_behind_wall(b, tf, ang):
    """A sphere and, behind it, a rectangle turned by ``ang`` degrees about
    the z axis, both with a constant normal-map tilt."""
    tilt = b.add_texture_checkerboard(color0=TILT, color1=TILT)
    mat = b.add_material(normal_tex=tilt)
    b.add_sphere([0.0, 0.0, 0.0], 1.0, mat)
    v, f, uv = tf(ang)
    b.add_mesh(v, f, mat, uvs=uv)
    return b.build(**({} if isinstance(b, jscene.SceneBuilder)
                      else {"device": "cpu"}))


def test_a_sphere_takes_its_own_tangent_and_a_triangle_the_jax_one():
    """A sphere lane's normal map perturbs the sphere's own frame: its
    tangent is dp/du of the sphere's (u, v) = (phi / 2pi, theta / pi) map
    (sphere.cpp), computed here, and turning the wall behind it changes
    nothing. A triangle lane is held to the JAX ray_intersect (jitted, one
    compile for both scenes), which hands every lane the triangle query's
    tangent (ROADMAP.md, Queue 3): the repair leaves triangle lanes alone."""
    from mitsuba_tpu.core.transform import Transform

    def jtf(ang):
        return jshapes.rectangle(Transform.translate([0, 0, 5])
                                 * Transform.rotate([0, 0, 1], ang)
                                 * Transform.scale([3, 3, 1]))

    def ttf(ang):
        return tshapes.rectangle(TTransform.translate([0, 0, 5])
                                 * TTransform.rotate([0, 0, 1], ang)
                                 * TTransform.scale([3, 3, 1]))

    # three lanes on the sphere (off its poles on the z axis), two on the
    # wall beside it
    o = np.float32([[0.3, 0.4, -5.0], [-0.6, 0.1, -5.0], [0.2, -0.7, -5.0],
                    [2.0, 0.5, -5.0], [-1.5, -2.0, -5.0]])
    d = np.float32([[0.0, 0.0, 1.0]] * 5)
    on_sphere = np.array([True, True, True, False, False])
    jhit = jax.jit(jscene.ray_intersect, static_argnums=1)
    normals = {}
    for ang in (0.0, 90.0):
        js, jst = _sphere_behind_wall(jscene.SceneBuilder(), jtf, ang)
        ts, tst = _sphere_behind_wall(tscene.SceneBuilder(), ttf, ang)
        jits = jhit(js, jst, jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.inf)
        tits = tscene.ray_intersect(ts, tst, torch.from_numpy(o),
                                    torch.from_numpy(d), 1e-4, torch.inf)
        assert ((tits.prim_id.numpy() == tst.n_tris) == on_sphere).all()
        frame = tits.sh_frame
        for f in ("s", "t", "n"):
            np.testing.assert_allclose(
                getattr(frame, f).numpy()[~on_sphere],
                np.asarray(getattr(jits.sh_frame, f))[~on_sphere], rtol=1e-5,
                atol=1e-5, err_msg=f"triangle lanes, {f}")
        # the sphere's frame, from its parametrisation
        p = tits.p.numpy()[on_sphere].astype(np.float64)
        n = p / np.linalg.norm(p, axis=1, keepdims=True)
        t_u = np.stack([-p[:, 1], p[:, 0], np.zeros(len(p))], axis=1)
        t_u /= np.linalg.norm(t_u, axis=1, keepdims=True)
        b_v = np.cross(n, t_u)
        nt = 2.0 * np.float32(TILT) - 1.0
        n_map = nt[0] * t_u + nt[1] * b_v + nt[2] * n
        n_map /= np.linalg.norm(n_map, axis=1, keepdims=True)
        ref = JFrame.from_normal(jnp.asarray(n_map, jnp.float32))
        for f in ("s", "t", "n"):
            np.testing.assert_allclose(
                getattr(frame, f).numpy()[on_sphere],
                np.asarray(getattr(ref, f)), rtol=1e-5, atol=1e-5,
                err_msg=f"sphere lanes, {f}")
        normals[ang] = frame.n.numpy()
    # the wall's quarter turn turns its own lanes' normals, not the sphere's
    np.testing.assert_array_equal(normals[0.0][on_sphere],
                                  normals[90.0][on_sphere])
    assert np.abs(normals[0.0][~on_sphere]
                  - normals[90.0][~on_sphere]).max() > 0.1


# --- the scene-file elements through both loaders ---------------------------

_DIFF = '<bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.4, 0.6"/></bsdf>'
_COND = '<bsdf type="conductor"><string name="material" value="Au"/></bsdf>'
ELEMENTS = {
    "mask-value": f'<bsdf type="mask" id="m"><float name="opacity" value="0.3"/>{_DIFF}</bsdf>',
    "mask-default": f'<bsdf type="mask" id="m">{_DIFF}</bsdf>',
    "mask-twosided": ('<bsdf type="twosided" id="m"><bsdf type="mask">'
                      '<rgb name="opacity" value="0.2, 0.5, 0.9"/>'
                      f'{_DIFF}</bsdf></bsdf>'),
    "mask-ref": ('<texture type="checkerboard" id="t"/><bsdf type="mask" '
                 f'id="m"><ref name="opacity" id="t"/>{_DIFF}</bsdf>'),
    "mixturebsdf": ('<bsdf type="mixturebsdf" id="m"><string name="weights" '
                    f'value="0.3 0.7"/>{_COND}{_DIFF}</bsdf>'),
    "mixturebsdf-renormalised": (
        '<bsdf type="mixturebsdf" id="m"><string name="weights" '
        f'value="0.2 0.3"/>{_DIFF}{_COND}</bsdf>'),
    "mixturebsdf-three": (
        '<bsdf type="mixturebsdf" id="m"><string name="weights" '
        f'value="0.2 0.3 0.5"/>{_COND}{_DIFF}{_DIFF}</bsdf>'),
    "mixturebsdf-ref": (
        f'<bsdf type="plastic" id="p"/><bsdf type="mixturebsdf" id="m">'
        f'<string name="weights" value="0.6 0.4"/>{_DIFF}<ref id="p"/></bsdf>'),
    "blendbsdf-value": ('<bsdf type="blendbsdf" id="m"><float name="weight" '
                        f'value="0.25"/>{_COND}{_DIFF}</bsdf>'),
    "blendbsdf-texture": (
        '<bsdf type="blendbsdf" id="m"><texture type="gridtexture" '
        'name="weight"><float name="lineWidth" value="0.1"/></texture>'
        f'{_COND}{_DIFF}</bsdf>'),
    "coating": ('<bsdf type="coating" id="m"><float name="intIOR" value="1.6"/>'
                '<rgb name="sigmaA" value="0.1, 0.2, 0.3"/>'
                f'<float name="thickness" value="2"/>{_COND}</bsdf>'),
    "coating-default": '<bsdf type="coating" id="m"/>',
    "coating-ref": f'{_DIFF.replace("<bsdf", "<bsdf id=\"d\"")}'
                   '<bsdf type="coating" id="m"><ref id="d"/></bsdf>',
    "roughcoating": ('<bsdf type="roughcoating" id="m"><string '
                     'name="distribution" value="ggx"/><float name="alpha" '
                     f'value="0.2"/><string name="intIOR" value="water"/>{_DIFF}'
                     '</bsdf>'),
    "normalmap": ('<bsdf type="normalmap" id="m"><texture type="checkerboard">'
                  '<rgb name="color0" value="0.5, 0.5, 1"/></texture>'
                  f'{_DIFF}</bsdf>'),
    "normalmap-without-texture": f'<bsdf type="normalmap" id="m">{_DIFF}</bsdf>',
    "bumpmap": ('<bsdf type="bumpmap" id="m"><float name="scale" value="3"/>'
                '<texture type="scale"><float name="scale" value="0.1"/>'
                f'<texture type="bitmap"><string name="filename" '
                f'value="{chip_smoke.HEIGHT_PFM}"/></texture></texture>'
                '<bsdf type="roughplastic"/></bsdf>'),
    "texture-checkerboard": (
        '<texture type="checkerboard" id="t"><float name="uscale" value="3"/>'
        '<float name="voffset" value="0.25"/><rgb name="color1" value="0.1, '
        '0.2, 0.3"/></texture><bsdf type="diffuse" id="m"><ref '
        'name="reflectance" id="t"/></bsdf>'),
    "texture-gridtexture": (
        '<bsdf type="diffuse" id="m"><texture type="gridtexture" '
        'name="reflectance"><float name="lineWidth" value="0.05"/>'
        '<float name="vscale" value="2"/></texture></bsdf>'),
    "texture-scale-value": (
        '<bsdf type="roughdiffuse" id="m"><texture type="scale" '
        'name="reflectance"><spectrum name="value" value="0.8"/>'
        '<rgb name="scale" value="0.5, 1, 0.25"/></texture></bsdf>'),
}


def _pair_of(tmp_path, body, defines=None):
    chip_smoke.write_height_pfm(tmp_path / chip_smoke.HEIGHT_PFM)
    path = tmp_path / "s.xml"
    path.write_text(f'<scene version="0.6.0">{body}<shape type="rectangle">'
                    '<ref id="m"/></shape></scene>')
    return _both(path, defines)


def _equal_new_columns(tscene_, tstatic, jscene_, jstatic):
    """The procedural columns (which _equal_tables' FIELD_PATHS leave out:
    the port drops them from a table without a procedural row) and the
    static facts against the JAX scene's."""
    if ttex.has_procedural(np.asarray(jscene_.textures.type)):
        for k in PROC_COLS:
            np.testing.assert_array_equal(_leaf(tscene_, ("textures", k)),
                                          np.asarray(getattr(
                                              jscene_.textures, k)), k)
    else:
        assert tscene_.textures.color0 is None
    jst = dataclasses.asdict(jstatic)
    for k, v in dataclasses.asdict(tstatic).items():
        assert v == jst[k], k


@pytest.mark.parametrize("case", sorted(ELEMENTS))
def test_elements_load_as_the_jax_loaders(tmp_path, case):
    jls, tls, ref, ref_static = _pair_of(tmp_path, ELEMENTS[case])
    _equal_tables(tls, ref, ref_static)
    _equal_new_columns(tls.scene, tls.static, jls.scene, jls.static)
    assert tls.ids["m"] == jls.ids["m"]
    _equal_new_columns(ref, ref_static, jls.scene, jls.static)


def test_nested_rows_name_rows_of_the_base_layer(tmp_path):
    """A nested row's A (and B) are single-layer rows, and the static
    nested types are theirs; blendbsdf's A is its second child."""
    _, tls, _, _ = _pair_of(tmp_path, ELEMENTS["blendbsdf-texture"])
    mats = tls.scene.materials
    top = tls.ids["m"][1]
    assert mats.type[top] == B.BLEND
    assert mats.type[mats.nested_a[top]] == B.DIFFUSE
    assert mats.type[mats.nested_b[top]] == B.CONDUCTOR
    assert tls.static.nested_bsdf_types == (B.DIFFUSE, B.CONDUCTOR)
    assert tls.static.has_weight_tex and tls.static.has_textures


# --- the chi-square harness on the nested samplers -------------------------

N = 300_000
NESTED_A = dict(type=B.DIFFUSE, albedo=(0.6, 0.4, 0.25))
NESTED_B = dict(type=B.ROUGH_CONDUCTOR, dist=tmf.GGX, eta=(0.2, 0.92, 1.1),
                k=(3.9, 2.45, 2.14), alpha=(0.3, 0.3))
# tests/test_bsdf.py:210-312's configurations: name, outer row, nested A
# and B, their types, theta of wi in degrees
CHI2_CONFIGS = [
    ("mixture", dict(type=B.MIXTURE, blend_w=0.4), NESTED_A, NESTED_B,
     (B.DIFFUSE, B.ROUGH_CONDUCTOR), 30.0),
    ("coating", dict(type=B.COATING, eta=(1.5,) * 3, k=(0.08,) * 3),
     NESTED_A, NESTED_A, (B.DIFFUSE,), 35.0),
    ("mask", dict(type=B.MASK, opacity=0.7), NESTED_A, NESTED_A,
     (B.DIFFUSE,), 30.0),
    ("roughcoating", dict(type=B.ROUGHCOATING, eta=(1.5,) * 3,
                          alpha=(0.25, 0.25), k=(0.02,) * 3),
     dict(type=B.DIFFUSE), dict(type=B.DIFFUSE), (B.DIFFUSE,), 35.0),
]


def _nested_locals(n, opacity=1.0, blend_w=0.5, **kw):
    """test_torch_bsdf.make_locals with the nested columns: the opacity,
    the weight and a rough coating's baked transmittance."""
    bl = make_locals(n, **kw)
    rt, fdr = np.zeros(6, np.float32), 0.0
    if kw.get("type") == B.ROUGHCOATING:
        d, a, e = tmf.GGX, kw["alpha"][0], kw["eta"][0]
        rt = jrtrans.fit_poly(d, a, e)[0]
        fdr = 1.0 - jrtrans.diffuse_transmittance(d, a, 1.0 / e)
    return bl._replace(
        opacity=torch.full((n,), opacity), blend_w=torch.full((n,), blend_w),
        rt_coef=torch.tensor(np.asarray(rt, np.float32)).expand(n, 6),
        rt_fdr=torch.full((n,), float(np.float32(fdr))))


def _wi(theta_deg, n):
    t = np.deg2rad(theta_deg)
    return torch.tensor([np.sin(t), 0.0, np.cos(t)],
                        dtype=torch.float32).expand(n, 3)


@pytest.mark.parametrize("name,outer,cfg_a,cfg_b,ntypes,theta", CHI2_CONFIGS,
                         ids=[c[0] for c in CHI2_CONFIGS])
def test_nested_chi2(name, outer, cfg_a, cfg_b, ntypes, theta):
    """Each nested sampler draws from the density its pdf claims."""
    types = (outer["type"],)

    def mk(n):
        return (_nested_locals(n, **outer),
                (_nested_locals(n, **cfg_a), _nested_locals(n, **cfg_b),
                 ntypes))

    def sample_fn(n):
        bl, nst = mk(n)
        u = trng.uniform4(zlib.crc32(name.encode()) % 1000,
                          torch.arange(n, dtype=torch.int32), 0, 0)
        bs = tbsdf.sample(bl, _wi(theta, n), u[..., 0], u[..., 1:3],
                          active_types=types, nested=nst)
        ok = (bs.pdf > 0) & ~bs.is_delta
        return torch.where(ok[:, None], bs.wo, 0.0)

    def pdf_fn(d):
        bl, nst = mk(d.shape[0])
        return tbsdf.pdf(bl, _wi(theta, d.shape[0]), d, active_types=types,
                         nested=nst)

    ok, _, _, _, info = tchi2.chi2_test(sample_fn, pdf_fn, n_samples=N,
                                        significance=0.0005)
    assert ok, f"{name}: {info}"


# --- the gathers of a scene without them ----------------------------------

def test_scenes_without_the_new_features_gather_nothing_new():
    """The training scene (a bitmap back wall, a rough conductor) renders
    through the path tracer and the direct integrator without reading a
    nested, opacity, weight or map column, and its texture table has no
    procedural column: the same gathers as before."""
    scene, static = chip_smoke.train_scene("cpu")[:2]
    assert static.has_textures and scene.textures.color0 is None
    assert not (static.nested_bsdf_types or static.has_normal_maps)
    seen = []
    mats = scene.materials
    scene = scene._replace(materials=mats._replace(**{
        k: _Recorder(k, getattr(mats, k), seen) for k in NESTED_COLS}))
    sensor = chip_smoke.sensor_mod.make_perspective(
        TTransform.look_at(chip_smoke.EYE, chip_smoke.AT, chip_smoke.UP),
        chip_smoke.FOV, 8, 8, device="cpu")
    for kind in (chip_smoke.PATH, chip_smoke.DIRECT):
        tapi.render(scene, static, sensor,
                    chip_smoke.IntegratorConfig(type=kind, max_depth=3),
                    tapi.RenderSettings(width=8, height=8, spp=1),
                    device="cpu")
    assert seen == []
