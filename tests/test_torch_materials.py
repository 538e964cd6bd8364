"""Port parity, single-layer BSDF scenes: the scene-file elements conductor,
roughdielectric, thindielectric, roughdiffuse, phong, ward, difftrans, hk
and null through both loaders; one scene that holds all nine at once,
rendered through both packages; the gathers of the HK columns; and the
bridge of a JAX scene with a glass or window mesh, on the CPU.

The render is the slice's integrator check: a path tracer at depth 6 with
roulette from depth 2, so the pass-through lobes (null, the thin
dielectric's and HK's transmissions) continue paths, HK's per-lane delta
flag drives the next vertex's MIS, and a rough-dielectric refraction's eta
enters roulette, lane by lane as in the JAX package.

A difftrans element is held against a JAX scene whose difftrans row
carries the file's transmittance in spec_trans, the column its lobe reads
(the JAX loader puts it in the albedo column; ROADMAP.md, Queue 3).

Tolerances: loaded tables exactly (the same numpy arithmetic, cast to
float32 at the end); the render as in test_torch_scenefile.py: image means
within 1e-3 relative, >= 99% of pixels within atol 1e-4 / rtol 1e-3, and
ray-query counts within 0.1%: an NEE sample drawn from a camera hit on the
light lies on the light's own plane, where the cos_l > 1e-7 test flips with
the last bit of the hit point, and such a sample carries nothing (the
light's albedo is 0; test_torch_scenefile.py). Measured: every pixel within
the tolerance, the means within 1.2e-7, 18,751 rays against 18,744.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes
from test_torch_plastic import _gathered
from test_torch_render import FIELD_PATHS, _leaf, jax_scene_arrays
from test_torch_scenefile import jax_render

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "scripts")]
import chip_smoke  # noqa: E402
from jax_header_ref_mean import difftrans_in_spec_trans  # noqa: E402

B = tbsdf

# each element with non-default parameters (twosided where the JAX loader
# passes it on), and some with none: (the BSDF declared with id "m", type)
ELEMENTS = {
    "conductor-au": ('<bsdf type="conductor" id="m">'
                     '<string name="material" value="Au"/></bsdf>',
                     B.CONDUCTOR),
    "conductor-eta-k-twosided": (
        '<bsdf type="twosided" id="m"><bsdf type="conductor">'
        '<rgb name="eta" value="0.2, 0.9, 1.1"/>'
        '<rgb name="k" value="3.9, 2.4, 2.1"/>'
        '<spectrum name="specularReflectance" value="0.9"/></bsdf></bsdf>',
        B.CONDUCTOR),
    "roughdielectric": (
        '<bsdf type="roughdielectric" id="m">'
        '<string name="distribution" value="ggx"/>'
        '<float name="alphaU" value="0.1"/><float name="alphaV" value="0.3"/>'
        '<float name="intIOR" value="1.7"/><string name="extIOR" value="water"/>'
        '<spectrum name="specularTransmittance" value="0.8"/></bsdf>',
        B.ROUGH_DIELECTRIC),
    "roughdielectric-default": ('<bsdf type="roughdielectric" id="m"/>',
                                B.ROUGH_DIELECTRIC),
    "thindielectric": ('<bsdf type="thindielectric" id="m">'
                       '<string name="intIOR" value="bk7"/>'
                       '<rgb name="specularReflectance" value="0.9, 0.8, 0.7"/>'
                       '</bsdf>', B.THIN_DIELECTRIC),
    "roughdiffuse": ('<bsdf type="twosided" id="m"><bsdf type="roughdiffuse">'
                     '<float name="alpha" value="0.6"/>'
                     '<rgb name="reflectance" value="0.8, 0.6, 0.3"/>'
                     '</bsdf></bsdf>', B.ROUGH_DIFFUSE),
    "roughdiffuse-default": ('<bsdf type="roughdiffuse" id="m"/>',
                             B.ROUGH_DIFFUSE),
    "phong": ('<bsdf type="phong" id="m"><float name="exponent" value="40"/>'
              '<spectrum name="diffuseReflectance" value="0.3"/>'
              '<spectrum name="specularReflectance" value="0.4"/></bsdf>',
              B.PHONG),
    "phong-default": ('<bsdf type="phong" id="m"/>', B.PHONG),
    "ward": ('<bsdf type="twosided" id="m"><bsdf type="ward">'
             '<float name="alphaU" value="0.1"/>'
             '<float name="alphaV" value="0.35"/>'
             '<rgb name="diffuseReflectance" value="0.3, 0.2, 0.1"/>'
             '</bsdf></bsdf>', B.WARD),
    "difftrans": ('<bsdf type="difftrans" id="m">'
                  '<rgb name="transmittance" value="0.7, 0.6, 0.5"/></bsdf>',
                  B.DIFFTRANS),
    "hk": ('<bsdf type="hk" id="m"><spectrum name="sigmaS" value="1"/>'
           '<rgb name="sigmaA" value="0.05, 0.1, 0.2"/>'
           '<float name="thickness" value="0.5"/>'
           '<phase type="hg"><float name="g" value="0.3"/></phase></bsdf>',
           B.HK),
    "hk-default": ('<bsdf type="hk" id="m"/>', B.HK),
    "null": ('<bsdf type="null" id="m"/>', B.NULL),
}


def _both(path, defines=None):
    """(JAX LoadedScene, port LoadedScene, bridged JAX scene, its static) of
    one file. The JAX scene carries a difftrans element's transmittance in
    spec_trans, as add_material(type=DIFFTRANS, spec_trans=...) builds it
    (``difftrans_in_spec_trans``): the JAX loader puts it in the albedo
    column, which its lobe never reads (ROADMAP.md, Queue 3)."""
    with difftrans_in_spec_trans():
        jls = jxml.load_scene(str(path), defines)
    tls = txml.load_scene(str(path), defines, device="cpu")
    ref, ref_static = bridge.scene_from_arrays(
        jax_scene_arrays(jls.scene), dataclasses.asdict(jls.static),
        device="cpu")
    return jls, tls, ref, ref_static


def _equal_tables(tls, ref, ref_static):
    for p in FIELD_PATHS:
        a, b = _leaf(tls.scene, p), _leaf(ref, p)
        assert a.dtype == b.dtype, p
        if p == ("irawan", "spec_norm"):
            # each package's own Monte-Carlo sum (tests/test_torch_cloth.py)
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            np.testing.assert_array_equal(a, b, err_msg=".".join(p))
    assert tls.static == ref_static


@pytest.mark.parametrize("case", sorted(ELEMENTS))
def test_elements_load_as_the_jax_loaders(tmp_path, case):
    body, tag = ELEMENTS[case]
    path = tmp_path / "s.xml"
    path.write_text(f'<scene version="0.6.0">{body}<shape type="rectangle">'
                    '<ref id="m"/></shape></scene>')
    _, tls, ref, ref_static = _both(path)
    _equal_tables(tls, ref, ref_static)
    assert tls.scene.materials.type.tolist() == [tag]
    assert tls.ids["m"] == ("bsdf", 0)


# the nested and layered elements and the woven cloth, which raised here
# until the port rendered them: the element's children (the cloth reads
# none), the type of the row the shape gets, and the column its map sets
_NESTED_BODIES = {
    "mixturebsdf": ('<string name="weights" value="0.4 0.6"/>'
                    '<bsdf type="diffuse"/><bsdf type="roughconductor"/>',
                    B.MIXTURE, None),
    "blendbsdf": ('<float name="weight" value="0.3"/><bsdf type="diffuse"/>'
                  '<bsdf type="conductor"/>', B.MIXTURE, None),
    "roughcoating": ('<bsdf type="diffuse"/>', B.ROUGHCOATING, None),
    "irawan": ('<bsdf type="diffuse"/>', B.IRAWAN, None),
    "normalmap": ('<texture type="checkerboard"/><bsdf type="diffuse"/>',
                  B.DIFFUSE, "normal_tex"),
    "bumpmap": ('<texture type="gridtexture"/><bsdf type="diffuse"/>',
                B.DIFFUSE, "bump_tex"),
}


@pytest.mark.parametrize("t", ["mixturebsdf", "blendbsdf", "roughcoating",
                               "irawan", "normalmap", "bumpmap"])
def test_nested_and_layered_elements_still_raise(tmp_path, t):
    """Each loads into the JAX loader's tables (tests/test_torch_nested.py
    and tests/test_torch_cloth.py hold each element against it); irawan,
    the last to raise, loads since item 3.2.4."""
    body, tag, col = _NESTED_BODIES[t]
    path = tmp_path / "s.xml"
    path.write_text(f'<scene version="0.6.0"><shape type="rectangle">'
                    f'<bsdf type="{t}">{body}</bsdf></shape></scene>')
    _, tls, ref, ref_static = _both(path)
    _equal_tables(tls, ref, ref_static)
    mats = tls.scene.materials
    row = int(tls.scene.tri_mat[0])
    assert mats.type[row] == tag
    if col is not None:
        assert getattr(mats, col)[row] == 0


# --- one scene with every single-layer type --------------------------------

ALL_RES, ALL_SPP = 32, 4
TILE_BSDFS = {
    "conductor": '<bsdf type="conductor" id="conductor"/>',
    "beckmann": ('<bsdf type="roughdielectric" id="beckmann">'
                 '<float name="alpha" value="0.3"/></bsdf>'),
    "thin": '<bsdf type="thindielectric" id="thin"/>',
    "clay": ('<bsdf type="roughdiffuse" id="clay">'
             '<float name="alpha" value="0.6"/>'
             '<rgb name="reflectance" value="0.8, 0.6, 0.3"/></bsdf>'),
    "phong": ('<bsdf type="twosided" id="phong"><bsdf type="phong">'
              '<float name="exponent" value="40"/></bsdf></bsdf>'),
    "ward": ('<bsdf type="twosided" id="ward"><bsdf type="ward">'
             '<float name="alphaU" value="0.1"/>'
             '<float name="alphaV" value="0.35"/></bsdf></bsdf>'),
    "leaf": ('<bsdf type="difftrans" id="leaf">'
             '<rgb name="transmittance" value="0.7, 0.6, 0.5"/></bsdf>'),
    "null": '<bsdf type="null" id="null"/>',
}


def all_types_xml():
    """scenes/cbox.xml's room with every single-layer type in view: the
    gallery's GGX rough-dielectric sphere, its short block in HK, and eight
    100 x 100 tiles in
    front of the back wall, one per other type; depth 6, roulette from
    depth 2."""
    text = chip_smoke.MATERIAL_GALLERY.xml("roughdielectric ggx")
    hk = chip_smoke.GALLERY_BSDFS["hk"].replace('id="gallery"', 'id="hk"')
    tiles = "".join(
        f'<shape type="rectangle"><transform name="toWorld">'
        f'<scale value="50"/><rotate y="1" angle="180"/>'
        f'<translate x="{x}" y="{y}" z="500"/></transform>'
        f'<ref id="{name}"/></shape>'
        for name, (x, y) in zip(TILE_BSDFS, [(x, y) for y in (300, 430)
                                             for x in (100, 225, 350, 475)]))
    block = chip_smoke.GALLERY_BLOCK.format(y=chip_smoke.GALLERY_BLOCK_Y)
    for old, new in (
            (block, block.replace('<ref id="gallery"/>', '<ref id="hk"/>')
             + tiles),
            ("<!-- floor -->", hk + "".join(TILE_BSDFS.values())
             + "<!-- floor -->"),
            ('<integer name="maxDepth" value="5"/>',
             '<integer name="maxDepth" value="6"/>'
             '<integer name="rrDepth" value="2"/>')):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def all_types(tmp_path_factory):
    path = tmp_path_factory.mktemp("all") / "all.xml"
    path.write_text(all_types_xml())
    jls, tls, ref, ref_static = _both(path, {"spp": ALL_SPP, "res": ALL_RES})
    img, n = tapi.render(tls.scene, tls.static, tls.sensor, tls.integrator,
                         tls.settings, device="cpu", with_stats=True)
    img_ref, n_ref = jax_render(jls.scene, jls.static, jls.sensor,
                                jls.integrator, jls.settings)
    return dict(jls=jls, tls=tls, ref=ref, ref_static=ref_static,
                img=img.numpy(), n=n, img_ref=img_ref, n_ref=n_ref)


def test_all_types_scene_loads_as_the_jax_loaders(all_types):
    tls = all_types["tls"]
    _equal_tables(tls, all_types["ref"], all_types["ref_static"])
    assert set(tls.static.bsdf_types) == {
        B.DIFFUSE, B.CONDUCTOR, B.ROUGH_DIELECTRIC, B.THIN_DIELECTRIC,
        B.ROUGH_DIFFUSE, B.PHONG, B.WARD, B.NULL, B.DIFFTRANS, B.HK}
    assert tls.integrator.max_depth == 6 and tls.integrator.rr_depth == 2


def test_all_types_render_mean_matches_jax(all_types):
    img, ref = all_types["img"], all_types["img_ref"]
    assert img.shape == ref.shape == (ALL_RES, ALL_RES, 3)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-3)


def test_all_types_render_pixels_match_jax(all_types):
    close = np.isclose(all_types["img"], all_types["img_ref"], atol=1e-4,
                       rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


def test_all_types_render_ray_counts_match_jax(all_types):
    n, n_ref = all_types["n"], all_types["n_ref"]
    assert abs(n - n_ref) <= 1e-3 * n_ref
    assert n > ALL_RES * ALL_RES * ALL_SPP


# --- the gathers -------------------------------------------------------------

@pytest.mark.parametrize("variant,extra", [
    ("ward", []), ("conductor", []),
    ("difftrans", ["spec_trans"]),
    ("thindielectric", ["spec_trans"]),
    ("hk", ["hk_g", "hk_thickness"])])
def test_columns_are_gathered_where_a_type_reads_them(tmp_path, variant,
                                                      extra):
    """A column that only some types read is gathered only where the scene
    has such a type: the HK columns with HK, the transmittance with the
    dielectrics and difftrans; the scalar IOR with the dielectrics (so the
    Cornell, bunny, Veach and training renders issue the same ops as
    before)."""
    path = tmp_path / "g.xml"
    path.write_text(chip_smoke.MATERIAL_GALLERY.xml(variant))
    tls = txml.load_scene(str(path), {"spp": 1, "res": 4}, device="cpu")
    seen, bl = _gathered(tls.scene, tls.static)
    eta_s = ["eta"] if variant == "thindielectric" else []
    assert sorted(seen) == sorted(["alpha", "dist", "eta", "k", "spec_refl",
                                   "twosided", "type"] + extra)
    assert (bl.eta_s is not None) == bool(eta_s)
    assert (bl.hk_g is not None) == ("hk_g" in extra)


def test_builder_takes_the_hk_keywords():
    """SceneBuilder.add_material's hk_thickness and hk_g, with the JAX
    defaults (1, 0), as in the JAX builder."""
    tables = []
    for mod in (jscene, tscene):
        b = mod.SceneBuilder()
        b.add_material(type=B.HK, albedo=(1.0,) * 3, k=(1.05,) * 3,
                       hk_thickness=0.5, hk_g=0.3)
        b.add_material(type=B.HK)
        b.add_mesh(np.eye(3), np.array([[0, 1, 2]]), 0)
        scene = (b.build() if mod is jscene else b.build(device="cpu"))[0]
        tables.append(scene.materials)
    for f in ("hk_thickness", "hk_g"):
        np.testing.assert_array_equal(getattr(tables[1], f).numpy(),
                                      np.asarray(getattr(tables[0], f)))
    assert tables[1].hk_thickness.tolist() == [0.5, 1.0]
    assert tables[1].hk_g.tolist() == pytest.approx([0.3, 0.0])


# --- the bridge --------------------------------------------------------------

@pytest.mark.parametrize("mtype", [jbsdf.THIN_DIELECTRIC, jbsdf.DIELECTRIC])
def test_bridge_takes_a_scene_with_a_glass_mesh(mtype):
    """The JAX builder sets n_manifold_tris for a dielectric or
    thin-dielectric mesh of at most 4,096 triangles; only its MLT family
    reads it, so the bridge carries such a scene (a window quad in the
    Cornell box) and gives the port builder's tables."""
    quad_v = np.array([[0.3, 0.2, 0.4], [0.7, 0.2, 0.4], [0.7, 0.6, 0.4],
                       [0.3, 0.6, 0.4]])
    quad_f = np.array([[0, 1, 2], [0, 2, 3]])
    built = []
    for mod, shapes in ((jscene, jshapes), (tscene, tshapes)):
        b = mod.SceneBuilder()
        shapes.cornell_box(b)
        b.add_mesh(quad_v, quad_f, b.add_material(type=mtype, eta=1.5046))
        built.append(b.build() if mod is jscene else b.build(device="cpu"))
    (jsc, jst), (tsc, tst) = built
    assert jst.n_manifold_tris == 2
    ref, ref_static = bridge.scene_from_arrays(
        jax_scene_arrays(jsc), dataclasses.asdict(jst), device="cpu")
    assert ref_static == tst
    for p in FIELD_PATHS:
        np.testing.assert_array_equal(_leaf(ref, p), _leaf(tsc, p),
                                      err_msg=".".join(p))
