"""Port parity, the bidirectional path tracer, on one small scene: the
Cornell box with its area light, a spot light, and a glass sphere holding a
homogeneous HG medium. Against the JAX package on the same inputs, on the
CPU: the rows of ``generate_subpaths``, ``_mis_weight_st`` of every (s, t),
``li_and_splats``' radiance and splats, and one render through
``api.render``; then ``load_scene`` of scenes/cbox.xml with bdpt and
ptracer, the CLI on a bdpt file (its EXR is api.render's image), and the
independent sampler that both renders draw from whatever the scene file
asks for.

Tolerances:
  * the subpaths (the render's two passes of 64 camera rays, 3 rows a
    side): a lane agrees when every integer and boolean field of every row
    is equal and every float of its valid rows is within rtol 1e-4 / atol
    1e-6 (a few products of pdfs, cosines and 1 / d^2 per row, an ulp
    apart at each step); at least 98% of lanes must agree: a walk parts
    where a ray grazes the sphere, whose quadratic cancels and which XLA's
    fused multiply-adds move by 1e-5, or two vertices lie 1e-2 apart (an
    area pdf of 2e4) (measured: 1 eye lane of 128 in this test, 9 of
    1,024 on a 32x32 film); invalid rows' floats are not compared (a
    missed ray's record holds placeholder values that no strategy reads);
  * the MIS weights, computed by both packages from the JAX subpaths:
    rtol 1e-5 / atol 1e-7 (a product of up to six pdf ratios, squared);
  * li_and_splats and the render (8x8, depth 3, 2 spp): means within 1e-4
    relative, at least 99% of lanes or pixels within atol 1e-4 / rtol 1e-3
    (as in tests/test_torch_render.py; measured: every lane, every pixel
    within 4.8e-7).

The JAX side is one render compile (about 13 s with the medium on a
shared 8-core CPU host), started in a thread before the first test; the
port's tests run beside it.
"""
import concurrent.futures
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mitsuba_tpu.__main__ as jmain
from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import bdpt as jbdpt
from mitsuba_tpu.render.integrators import common as jcommon
import mitsuba_tpu_torch.__main__ as tmain
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import image as timage
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import bdpt as tbdpt
from mitsuba_tpu_torch.render.integrators import common as tcommon

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
RES, SPP, DEPTH = 8, 2, 3
SUBPATH_FLOATS = ("p", "gn", "ns", "uv", "wi_world", "beta", "pdf_fwd",
                  "pdf_rev", "light_pdf_a")
SUBPATH_EXACT = ("mat_id", "emitter_id", "delta", "delta_origin", "conn",
                 "valid", "is_med", "med_id")


def bidir_scene(mod, bsdf, shapes, T, **build_kw):
    """The Cornell box with a spot light and a glass sphere holding a
    homogeneous HG medium, by either package's builder."""
    b = mod.SceneBuilder()
    shapes.cornell_box(b)
    b.add_spot_light((0.3, 0.9, 0.3), (0.2, -1.0, 0.3), (2.0, 1.8, 1.5),
                     cutoff_deg=30.0)
    milk = b.add_medium_homogeneous(sigma_s=(2.0, 1.5, 1.0),
                                    sigma_a=(0.2, 0.3, 0.4), phase_type=1,
                                    phase_g=0.5)
    b.add_sphere((0.7, 0.75, 0.3), 0.12,
                 b.add_material(type=bsdf.DIELECTRIC, interior_medium=milk))
    return b.build(**build_kw)


def _settings(mod, res, sampler):
    return mod.RenderSettings(width=res, height=res, spp=SPP,
                              sampler_type=sampler)


# every (t, s) of li_and_splats at depth 3
STRATEGIES = [(t, s) for t in range(DEPTH + 1) for s in range(DEPTH + 1)
              if 1 <= s + t <= DEPTH]


def _junction_subs(eye, light):
    """(esubs, lsubs) of strategy (t, s): the junction rows' reverse pdfs
    replaced by half their forward pdfs (values of the right scale, zeros
    where a row is empty)."""
    def subs(t, s):
        es = {t - 1: eye.pdf_fwd[t - 1] * 0.5} if t else {}
        ls = {s - 1: light.pdf_fwd[s - 1] * 0.5} if s else {}
        return es, ls
    return subs


@pytest.fixture(scope="module", autouse=True)
def jax_render():
    """The JAX render (the ldsampler in its settings, as a scene file would
    ask), started before the module's first test in a thread of its own,
    where XLA compiles it while the port's tests run. Its one compile also
    hands each pass's camera rays, subpaths, MIS weights of every strategy
    and li_and_splats' outputs to the host (jax.debug.callback from
    wrappers of generate_subpaths and li_and_splats, in place while the
    pass is traced)."""
    js, jst = bidir_scene(jscene, jbsdf, jshapes, JTransform)
    cfg = jcommon.IntegratorConfig(type=jcommon.BDPT, max_depth=DEPTH)
    sens = jsensor.make_perspective(JTransform.look_at(EYE, AT, UP), FOV,
                                    RES, RES)
    passes = {}
    gen, li = jbdpt.generate_subpaths, jbdpt.li_and_splats

    def keep(sample, **arrays):
        passes.setdefault(int(sample), {}).update(
            jax.tree.map(np.asarray, arrays))

    def gen_spy(scene, static, cfg_, sensor, o, d, seed, lane, sample, *a,
                **kw):
        eye, light = gen(scene, static, cfg_, sensor, o, d, seed, lane,
                         sample, *a, **kw)
        subs = _junction_subs(eye, light)
        mis = {f"{t} {s}": jbdpt._mis_weight_st(eye, light, t, s,
                                                *subs(t, s))
               for t, s in STRATEGIES}
        jax.debug.callback(lambda *x: keep(**dict(zip(KEYS, x))), sample,
                           o, d, eye, light, mis)
        return eye, light

    def li_spy(*args, **kw):
        out = li(*args, **kw)
        jax.debug.callback(lambda s, L, uv, val: keep(s, L=L, uv=uv,
                                                      val=val),
                           args[8], *out)
        return out

    def render():
        jbdpt.generate_subpaths, jbdpt.li_and_splats = gen_spy, li_spy
        try:
            img = np.asarray(japi.render(
                js, jst, sens, cfg, _settings(japi, RES, japi.LDSAMPLER)))
        finally:
            jbdpt.generate_subpaths, jbdpt.li_and_splats = gen, li
        return img, passes

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(render)


KEYS = ("sample", "o", "d", "eye", "light", "mis")


@pytest.fixture(scope="module")
def port_scene():
    return bidir_scene(tscene, tbsdf, tshapes, TTransform, device="cpu")


def _port_sensor(res):
    return tsensor.make_perspective(TTransform.look_at(EYE, AT, UP), FOV, res,
                                    res, device="cpu")


def _cfg():
    return tcommon.IntegratorConfig(type=tcommon.BDPT, max_depth=DEPTH)


def _port_subpath(jsp):
    """The port's Subpath holding a JAX Subpath's rows."""
    K, R = np.asarray(jsp.valid).shape
    sp = tbdpt.Subpath(K, R, "cpu")
    for name in tbdpt.Subpath.FIELDS:
        a = np.asarray(getattr(jsp, name))
        setattr(sp, name, [torch.from_numpy(a[k].copy()) for k in range(K)])
    return sp


@pytest.fixture(scope="module")
def port_lanes(jax_render, port_scene):
    """The port's subpaths and li_and_splats on each JAX pass's camera
    rays, and the JAX pass's values: {sample: (port, jax)}."""
    out = {}
    lane = torch.arange(RES * RES)
    sens = _port_sensor(RES)
    for sample, ref in jax_render.result()[1].items():
        o, d = (torch.from_numpy(ref[k].copy()) for k in ("o", "d"))
        eye, light = tbdpt.generate_subpaths(*port_scene, _cfg(), sens, o, d,
                                             0, lane, sample, DEPTH, DEPTH)
        L, uv, val = tbdpt.li_and_splats(*port_scene, _cfg(), sens, o, d, 0,
                                         lane, sample)
        out[sample] = (dict(eye=eye, light=light, L=L.numpy(), uv=uv.numpy(),
                            val=val.numpy()), ref)
    assert sorted(out) == list(range(SPP))
    return out


def test_scene_has_every_bidirectional_case(port_scene):
    static = port_scene[1]
    assert static.emitter_types == (0, 5) and static.medium_types == (0,)
    assert tbsdf.DIELECTRIC in static.bsdf_types


def _cbox(tmp_path, integrator, sampler="independent"):
    text = (REPO / "scenes" / "cbox.xml").read_text()
    text, n = re.subn(r'<integrator type="path">',
                      f'<integrator type="{integrator}">', text)
    assert n == 1
    text = text.replace('<sampler type="independent">',
                        f'<sampler type="{sampler}">')
    path = tmp_path / f"{integrator}_{sampler}.xml"
    path.write_text(text)
    return path


@pytest.mark.parametrize("integrator", ["bdpt", "ptracer"])
def test_loaders_agree_on_the_integrator(tmp_path, integrator):
    path = _cbox(tmp_path, integrator, "ldsampler")
    defines = {"spp": 2, "res": 4}
    jcfg = jxml.load_scene(str(path), defines).integrator
    tls = txml.load_scene(str(path), defines, device="cpu")
    assert tls.integrator.type == {"bdpt": 11, "ptracer": 5}[integrator]
    for f in dataclasses.fields(tls.integrator):
        assert getattr(tls.integrator, f.name) == getattr(jcfg, f.name), f
    assert tls.settings.sampler_type == tapi.LDSAMPLER
    img = tapi.render(tls.scene, tls.static, tls.sensor, tls.integrator,
                      tls.settings, device="cpu")
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())


def test_cli_raises_on_a_bdpt_file_as_the_jax_cli(tmp_path):
    """The JAX CLI renders through api.render_pass, whose _li_fn knows no
    bdpt (api.py:63-74), and stops with ValueError; the port's CLI, which
    copied that fault until it was repaired (ROADMAP.md, Queue 3), renders
    the file through api.render: its EXR is api.render's image bit for
    bit. (The name is the test's from before the repair.)"""
    path = str(_cbox(tmp_path, "bdpt"))
    out = tmp_path / "o.exr"
    args = [path, "-D", "spp=1", "-D", "res=4", "-z", "-o", str(out)]
    with pytest.raises(ValueError) as j:
        jmain.main(args)
    assert str(j.value) == "unknown integrator type 11"
    assert not out.exists()
    assert tmain.main(args + ["--cpu"]) == 0
    ls = txml.load_scene(path, {"spp": 1, "res": 4}, device="cpu")
    img = tapi.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                      ls.settings, device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_array_equal(timage.read_exr(str(out)), img)


@pytest.fixture(scope="module")
def port_renders(port_scene):
    """The port's render with the independent sampler and with the
    ldsampler in the settings, with its ray counts."""
    out = {}
    for name, tag in (("independent", tapi.INDEPENDENT),
                      ("ldsampler", tapi.LDSAMPLER)):
        img, n = tapi.render(*port_scene, _port_sensor(RES), _cfg(),
                             _settings(tapi, RES, tag), device="cpu",
                             with_stats=True)
        out[name] = img.numpy()
        out[f"{name} rays"] = n
    return out


def test_renders_draw_from_the_independent_sampler(port_renders):
    """Both renders set the JAX package's sampler global to INDEPENDENT
    (api.py:161,286), and its pixel positions stratify only for the
    stratified sampler: a file's ldsampler changes no bit."""
    np.testing.assert_array_equal(port_renders["ldsampler"],
                                  port_renders["independent"])
    assert port_renders["ldsampler rays"] == port_renders["independent rays"]
    # per sample at most 2 x 3 closest hits and 6 connection and 3 splat
    # shadow walks of 5 queries each, over 64 lanes
    assert 0 < port_renders["independent rays"] <= SPP * 51 * RES * RES


def test_a_vacuum_medium_changes_no_bit():
    """The sphere's medium at zero density: the media branches (free
    flights, phase-aware vertices, each connection's transmittance walk)
    give the plain branches' image (one shadow ray per connection) bit for
    bit; the former are held to JAX above, so the latter are too."""
    imgs = []
    for vacuum in (True, False):
        b = tscene.SceneBuilder()
        tshapes.cornell_box(b)
        kw = {}
        if vacuum:
            kw["interior_medium"] = b.add_medium_homogeneous(
                sigma_s=(0.0,) * 3, sigma_a=(0.0,) * 3)
        b.add_sphere((0.7, 0.75, 0.3), 0.12,
                     b.add_material(type=tbsdf.DIELECTRIC, **kw))
        scene, static = b.build(device="cpu")
        assert bool(static.medium_types) == vacuum
        imgs.append(tapi.render(scene, static, _port_sensor(RES), _cfg(),
                                _settings(tapi, RES, tapi.INDEPENDENT),
                                device="cpu"))
    assert imgs[0].mean() > 0.05
    torch.testing.assert_close(imgs[0], imgs[1], rtol=0, atol=0)


def test_bdpt_render_matches_jax(jax_render, port_renders):
    ref, img = jax_render.result()[0], port_renders["ldsampler"]
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-4)
    close = np.isclose(img, ref, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


def _rows(sp, name):
    return np.stack([np.asarray(r) for r in getattr(sp, name)])


@pytest.mark.parametrize("side", ["eye", "light"])
def test_generate_subpaths_rows_match_jax(port_lanes, side):
    agree = []
    for port, ref in port_lanes.values():
        sp, jsp = port[side], ref[side]
        valid = _rows(jsp, "valid")
        assert sp.K == valid.shape[0] == DEPTH
        same = np.ones(valid.shape[1], bool)
        for name in SUBPATH_EXACT:
            same &= (_rows(sp, name) == _rows(jsp, name)).reshape(
                DEPTH, valid.shape[1], -1).all(axis=(0, 2))
        for name in SUBPATH_FLOATS:
            a, b = _rows(sp, name), _rows(jsp, name)
            ok = np.isclose(a, b, rtol=1e-4, atol=1e-6).reshape(
                DEPTH, valid.shape[1], -1).all(axis=-1)
            same &= (ok | ~valid).all(axis=0)
        agree.append(same)
        # the walks reach every kind of vertex
        assert valid[0].mean() > 0.5 and valid[-1].any()
    agree = np.concatenate(agree)
    assert agree.mean() >= 0.98, f"{side}: {(~agree).sum()} lanes part"


def test_light_subpaths_start_on_every_kind_of_light(port_lanes):
    rows = [port["light"] for port, _ in port_lanes.values()]
    assert any(sp.delta_origin[0].any() for sp in rows)  # the spot
    assert any((sp.valid[0] & ~sp.delta_origin[0]).any() for sp in rows)
    eyes = [port["eye"] for port, _ in port_lanes.values()]
    assert any(bool(torch.stack(sp.is_med).any()) for sp in eyes + rows)


def test_mis_weights_match_jax_for_every_strategy(port_lanes):
    assert len(STRATEGIES) == 9
    for _, ref in port_lanes.values():
        eye, light = _port_subpath(ref["eye"]), _port_subpath(ref["light"])
        subs = _junction_subs(eye, light)
        for t, s in STRATEGIES:
            w = tbdpt._mis_weight_st(eye, light, t, s, *subs(t, s)).numpy()
            np.testing.assert_allclose(w, ref["mis"][f"{t} {s}"], rtol=1e-5,
                                       atol=1e-7, err_msg=f"t={t} s={s}")
            assert ((w > 0) & (w <= 1)).all()


def _lanes_close(a, b):
    """Per lane (the first axis): every value within atol 1e-4 / rtol 1e-3."""
    return np.isclose(a, b, atol=1e-4, rtol=1e-3).reshape(
        a.shape[0], -1).all(axis=-1)


def test_li_and_splats_match_jax(port_lanes):
    lanes = []
    for port, ref in port_lanes.values():
        assert port["uv"].shape == ref["uv"].shape == (DEPTH, RES * RES, 2)
        assert port["L"].mean() > 0 and (port["uv"][..., 0] >= 0).any()
        np.testing.assert_allclose(port["L"].mean(axis=0),
                                   ref["L"].mean(axis=0), rtol=1e-4)
        np.testing.assert_allclose(port["val"].sum(axis=1),
                                   ref["val"].sum(axis=1), rtol=1e-4,
                                   atol=1e-6)
        close = _lanes_close(port["L"], ref["L"])
        for k in ("uv", "val"):
            close &= _lanes_close(port[k].transpose(1, 0, 2),
                                  ref[k].transpose(1, 0, 2))
        lanes.append(close)
    assert np.concatenate(lanes).mean() >= 0.99
