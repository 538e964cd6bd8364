"""Port parity, the nested and layered BSDFs in a render: one scene that holds
the five nested types (mask, mixturebsdf, blendbsdf, coating, roughcoating),
a normal map, a bump map and the constant, checkerboard and grid textures
with the scale fold, loaded from a scene file by both loaders and rendered
through the path tracer and the direct integrator, pixel for pixel against
the JAX package on the CPU.

Tolerances (as tests/test_torch_materials.py's, for the same reasons): image
means within 1e-3 relative, >= 99% of pixels within atol 1e-4 / rtol 1e-3,
ray counts within 0.1% (an NEE sample on the light's own plane flips with the
last bit of the hit point); the loaded tables exactly.

The module traces both JAX render passes before its first test and has XLA
compile them in two threads of their own (the GIL released) while the port
renders on one thread.
"""
import concurrent.futures
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import texture as ttex
from test_torch_nested import _equal_new_columns
from test_torch_scenefile import jax_pass, jax_render

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke  # noqa: E402

ALL_RES, ALL_SPP = 32, 4
KINDS = ("path", "direct")
# each tile's BSDF: the five nested types (with the gallery's nested rows)
# and both maps; the sphere is the checkerboard mask, the block the rough
# coating
TILES = {
    "mix": "mixturebsdf", "blend": "blendbsdf", "coat": "coating",
    "opaque": "mask constant", "nmap": "normalmap", "bump": "bumpmap",
}


def all_nested_xml(kind="path"):
    """The layered gallery's room with the sphere a checkerboard mask, the
    short block a rough coating and six 100 x 100 tiles before the back
    wall: a mixture, a grid-weighted blend, a coating, a constant mask, a
    normal map and a bump map through a scale texture, rendered by the
    ``kind`` integrator. The maps lie over a diffuse and the mixture's
    conductor is smooth: a rough conductor or plastic in the render would
    double the JAX compile (tests/test_torch_nested.py holds their eval, pdf
    and sample against JAX)."""
    text = chip_smoke.LAYERED_GALLERY.xml("mask checkerboard")
    decl = {
        name: chip_smoke.LAYERED_BSDFS[v].replace('id="gallery"',
                                                   f'id="{name}"')
        for name, v in {**TILES, "rc": "roughcoating"}.items()}
    for name in ("nmap", "bump"):
        inner = decl[name][decl[name].rindex("<bsdf type="):-len("</bsdf>")]
        decl[name] = decl[name].replace(inner, '<bsdf type="diffuse"/>')
    rough = decl["mix"][decl["mix"].index('<bsdf type="roughconductor">'):
                        decl["mix"].index("</bsdf>") + len("</bsdf>")]
    decl["mix"] = decl["mix"].replace(
        rough, '<bsdf type="conductor"><string name="material" '
        'value="Cu"/></bsdf>')
    tiles = "".join(
        f'<shape type="rectangle"><transform name="toWorld">'
        f'<scale value="50"/><rotate y="1" angle="180"/>'
        f'<translate x="{x}" y="{y}" z="500"/></transform>'
        f'<ref id="{name}"/></shape>'
        for name, (x, y) in zip(TILES, [(x, y) for y in (300, 430)
                                        for x in (100, 260, 420)]))
    block = chip_smoke.GALLERY_BLOCK.format(y=chip_smoke.GALLERY_BLOCK_Y)
    for old, new in (
            (block, block.replace('<ref id="gallery"/>', '<ref id="rc"/>')
             + tiles),
            ("<!-- floor -->", "".join(decl.values()) + "<!-- floor -->"),
            ('<integrator type="path">', f'<integrator type="{kind}">')):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module", autouse=True)
def jax_all_nested(tmp_path_factory):
    """Per integrator, the file of all_nested_xml, the JAX scene loaded from
    it and its render pass, traced before the module's first test and
    compiled by XLA in a thread of its own while the other tests run."""
    tmp = tmp_path_factory.mktemp("nested")
    chip_smoke.write_height_pfm(tmp / chip_smoke.HEIGHT_PFM)
    defines = {"spp": ALL_SPP, "res": ALL_RES}
    with concurrent.futures.ThreadPoolExecutor(len(KINDS)) as pool:
        out = {}
        for kind in KINDS:
            path = tmp / f"{kind}.xml"
            path.write_text(all_nested_xml(kind))
            jls = jxml.load_scene(str(path), defines)
            lowered = jax_pass(jls.static, jls.sensor, jls.integrator,
                               jls.settings).trace(
                jls.scene, jnp.zeros((ALL_RES, ALL_RES, 4)),
                jnp.int32(0)).lower()
            out[kind] = (path, defines, jls, pool.submit(lowered.compile))
        yield out


@pytest.fixture(scope="module")
def all_nested(jax_all_nested):
    """Per integrator, both loaders' scenes, both images and both counts of
    ray queries."""
    out = {}
    # one thread beside XLA's two compiles: more would oversubscribe the
    # host and slow both (measured: the path render 30 s with all threads,
    # 1.5 s with one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kind, (path, defines, jls, _) in jax_all_nested.items():
            tls = txml.load_scene(str(path), defines, device="cpu")
            img, n = tapi.render(tls.scene, tls.static, tls.sensor,
                                 tls.integrator, tls.settings, device="cpu",
                                 with_stats=True)
            out[kind] = dict(jls=jls, tls=tls, img=img.numpy(), n=n)
    finally:
        torch.set_num_threads(threads)
    for kind, (_, _, jls, compiled) in jax_all_nested.items():
        out[kind]["img_ref"], out[kind]["n_ref"] = jax_render(
            jls.scene, jls.static, jls.sensor, jls.integrator, jls.settings,
            one_pass=compiled.result())
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_all_nested_scene_loads_as_the_jax_loaders(all_nested, kind):
    tls, jls = all_nested[kind]["tls"], all_nested[kind]["jls"]
    _equal_new_columns(tls.scene, tls.static, jls.scene, jls.static)
    st = tls.static
    assert set(tbsdf.NESTED_TYPES) <= set(st.bsdf_types)
    assert st.has_opacity_tex and st.has_weight_tex and st.has_normal_maps
    assert {ttex.TEX_CONSTANT, ttex.TEX_CHECKERBOARD, ttex.TEX_GRID,
            ttex.TEX_BITMAP} <= set(tls.scene.textures.type.tolist())
    assert tls.integrator.type == jls.integrator.type


@pytest.mark.parametrize("kind", KINDS)
def test_all_nested_render_mean_matches_jax(all_nested, kind):
    img, ref = all_nested[kind]["img"], all_nested[kind]["img_ref"]
    assert img.shape == ref.shape == (ALL_RES, ALL_RES, 3)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_all_nested_render_pixels_match_jax(all_nested, kind):
    r = all_nested[kind]
    close = np.isclose(r["img"], r["img_ref"], atol=1e-4,
                       rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


@pytest.mark.parametrize("kind", KINDS)
def test_all_nested_render_ray_counts_match_jax(all_nested, kind):
    n, n_ref = all_nested[kind]["n"], all_nested[kind]["n_ref"]
    assert abs(n - n_ref) <= 1e-3 * n_ref
    assert n > ALL_RES * ALL_RES * ALL_SPP
