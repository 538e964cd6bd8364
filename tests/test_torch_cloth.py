"""Port parity, the Irawan-Marschner woven cloth: the Perlin noise and the
yarn hash, the weave patterns (the presets, the ``.cloth`` grammar, the
table and its specular normalization), the per-lane yarn lookup, the lobe
through ``bsdf.eval``, ``pdf`` and ``sample``, and an irawan scene file
through both loaders, the bridge and one render, against the JAX package on
the same numpy inputs, on the CPU; and a nested irawan row, whose yarn
parameters the JAX package does not gather (ROADMAP.md, Queue 3).

Tolerances:
  * the hashes, the noise, the patterns, the tables (but the
    normalization) and every column of the lookup but the last: exactly;
  * the lookup's normalization column within 1e-6 relative: it folds in
    -log(xi), whose last bit XLA and PyTorch round apart;
  * the normalization: a float32 sum over 10,000 lanes of each package's
    own BRDF, within 1e-5 relative;
  * eval and pdf: rtol 1e-4 / atol 1e-6 (the curvature's pow(x, 1.5) and
    the trigonometry an ulp apart, grown by the spine's curvature terms),
    with equal nonzero masks; sample: wo and pdf at rtol 1e-5 / atol 1e-5
    (the cosine warp's z = sqrt(1 - x^2 - y^2) grows an ulp of x and y by
    1 / z near the horizon), is_delta and eta exactly, the weight as eval;
  * the render (8x8, 4 spp, the bridge's scene, so the JAX normalization):
    the mean within 1e-4 relative, every pixel within atol 1e-4 / rtol
    1e-3, the ray counts exactly.
"""
import dataclasses
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import noise as jnoise
from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import irawan as jiw
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core import noise as tnoise
from mitsuba_tpu_torch.core import warp as twarp
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import irawan as tiw
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from test_torch_render import FIELD_PATHS, _leaf, jax_scene_arrays
from test_torch_scenefile import jax_render

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
import chip_smoke  # noqa: E402

PATTERNS = ("plain", "twill", "cloth file")
REPEATS = {"plain": (10.0, 10.0), "twill": (7.0, 3.0),
           "cloth file": (5.0, 5.0)}
RES, SPP = 8, 4
LOBE_TOL = dict(rtol=1e-4, atol=1e-6)
# lanes per test: the specular normalization's count, so that the JAX
# package's eager operations compile once for every test
N = 10000


@pytest.fixture(scope="module")
def cloth_dir(tmp_path_factory):
    """A directory holding chip_smoke's .cloth pattern and its scene file."""
    tmp = tmp_path_factory.mktemp("cloth")
    chip_smoke.write_cloth(tmp)
    (tmp / "cloth.xml").write_text(chip_smoke.cloth_xml("cloth file"))
    return tmp


@pytest.fixture(scope="module")
def pattern_dicts(cloth_dir):
    """Each pattern's dict, as the JAX package makes it."""
    return {"plain": jiw.preset("plain", kd=(0.4, 0.2, 0.1)),
            "twill": jiw.preset("twill"),
            "cloth file": jiw.load_cloth(
                str(cloth_dir / chip_smoke.CLOTH_FILE))}


@pytest.fixture(scope="module")
def tables(pattern_dicts):
    """The JAX table of all three patterns (its normalization included) and
    the port's copy of it."""
    jt = jiw.build_table([pattern_dicts[p] for p in PATTERNS],
                         [REPEATS[p] for p in PATTERNS])
    tt = tiw.IrawanTable(**{
        f: torch.from_numpy(np.array(getattr(jt, f))) for f in jt._fields})
    return jt, tt


def _uv(n, seed):
    """uv in [-1, 2)^2: lanes past the unit square on both sides (negative
    tile centres wrap through the uint32 cast)."""
    return (np.random.default_rng(seed).random((n, 2), np.float32) * 3.0
            - 1.0).astype(np.float32)


# --- the hashes and the noise ------------------------------------------------

def test_perlin_3d_equals_jax():
    rng = np.random.default_rng(0)
    p = ((rng.random((N, 3), np.float32) - 0.5) * 400.0).astype(np.float32)
    p[:256] = np.round(p[:256])        # lattice points: 0 there
    p[256:512, 1:] = 0.0               # lane_params' 1-D noise
    ref = np.asarray(jnoise.perlin_3d(jnp.asarray(p)))
    out = tnoise.perlin_3d(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert np.all(out[:256] == 0.0)


def test_hash01_and_the_uint32_cast_equal_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, N, dtype=np.uint64)
    b = rng.integers(0, 2**32, N, dtype=np.uint64)
    a[:4], b[:4] = [0, 2**32 - 1, 0, 2**31], [0, 2**32 - 1, 2**32 - 1, 7]
    ref = np.asarray(jiw._hash01(jnp.asarray(a.astype(np.uint32)),
                                 jnp.asarray(b.astype(np.uint32))))
    out = tiw._hash01(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out, ref)
    x = ((rng.random(N, np.float32) - 0.5) * 1e4).astype(np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32).astype(jnp.uint32))
    np.testing.assert_array_equal(tiw._u32(torch.from_numpy(x)).numpy(),
                                  ref.astype(np.int64))


# --- the patterns ------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "twill"])
def test_presets_equal_jax(name):
    kw = dict(kd=(0.4, 0.2, 0.1), ks=(0.3, 0.3, 0.3))
    assert tiw.preset(name, **kw) == jiw.preset(name, **kw)
    with pytest.raises(ValueError):
        tiw.preset("satin")


def test_load_cloth_equals_jax(cloth_dir, pattern_dicts):
    pd = tiw.load_cloth(str(cloth_dir / chip_smoke.CLOTH_FILE))
    assert pd == pattern_dicts["cloth file"]
    assert pd["period"] > 0 and pd["fineness"] > 0
    assert pd["yarns"][0]["ks"] == (0.2, 0.3, 0.6)  # a trailing {r, g, b}
    (cloth_dir / "bad.cloth").write_text("weave { tileWidth = 2 }")
    with pytest.raises(ValueError, match="no pattern block"):
        tiw.load_cloth(str(cloth_dir / "bad.cloth"))


def test_table_equals_jax(pattern_dicts):
    pats = [pattern_dicts[p] for p in PATTERNS]
    reps = [REPEATS[p] for p in PATTERNS]
    jt = jiw.build_table_nonorm(pats, reps)
    tt = tiw.build_table_nonorm(pats, reps, "cpu")
    for f in jt._fields:
        ref = np.asarray(getattr(jt, f))
        out = getattr(tt, f).numpy()
        assert out.dtype == ref.dtype, f
        np.testing.assert_array_equal(out, ref, err_msg=f)
    empty = tiw.IrawanTable.empty("cpu")
    for f in jt._fields:
        ref = np.asarray(getattr(jiw.IrawanTable.empty(), f))
        assert getattr(empty, f).numpy().dtype == ref.dtype, f
        np.testing.assert_array_equal(getattr(empty, f).numpy(), ref)


@pytest.mark.parametrize("name", PATTERNS)
def test_specular_normalization_matches_jax(pattern_dicts, name):
    ref = jiw._specular_normalization(pattern_dicts[name])
    out = tiw._specular_normalization(pattern_dicts[name])
    assert ref > 0
    np.testing.assert_allclose(out, ref, rtol=1e-5)


@pytest.mark.parametrize("pid", range(len(PATTERNS)), ids=PATTERNS)
def test_lane_params_match_jax(tables, pid):
    jt, tt = tables
    n = N
    uv = _uv(n, 10 + pid)
    ref = jiw.lane_params(jt, jnp.full(n, pid, jnp.int32), jnp.asarray(uv))
    out = tiw.lane_params(tt, torch.full((n,), pid, dtype=torch.int32),
                          torch.from_numpy(uv))
    par, par_ref = out[0].numpy(), np.asarray(ref[0])
    np.testing.assert_array_equal(par[:, :12], par_ref[:, :12])
    np.testing.assert_allclose(par[:, 12], par_ref[:, 12], rtol=1e-6)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if PATTERNS[pid] == "cloth file":
        # the noise and the intensity variation reach the lanes
        assert np.ptp(par[:, 2][par[:, 0] == 0]) > 0
        assert np.unique(par[:, 12]).size > 100


# --- the lobe ----------------------------------------------------------------

def _locals(tables, pid, n, seed):
    """The JAX and the port's locals of n IRAWAN lanes of pattern ``pid``
    at the same uv (test_irawan.py's form), from the JAX lookup."""
    jt, _ = tables
    par, ks, kd = jiw.lane_params(jt, jnp.full(n, pid, jnp.int32),
                                  jnp.asarray(_uv(n, seed)))
    jbl = jiw._norm_locals(n, par)._replace(iw_ks=ks, albedo=kd)
    tbl = tiw._norm_locals(n, torch.from_numpy(np.array(par)))._replace(
        iw_ks=torch.from_numpy(np.array(ks)),
        albedo=torch.from_numpy(np.array(kd)))
    return jbl, tbl


def _dirs(n, seed):
    """Cosine-distributed wi and wo, a few lanes below the surface."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = twarp.square_to_cosine_hemisphere(
            torch.from_numpy(rng.random((n, 2), np.float32))).numpy()
        d[:16, 2] *= -1.0
        out.append(d)
    return out


@pytest.mark.parametrize("fn", ["eval", "pdf"])
@pytest.mark.parametrize("pid", range(len(PATTERNS)), ids=PATTERNS)
def test_irawan_eval_and_pdf_match_jax(tables, pid, fn):
    n = N
    jbl, tbl = _locals(tables, pid, n, 20 + pid)
    wi, wo = _dirs(n, 30 + pid)
    ref = np.asarray(getattr(jbsdf, fn)(jbl, jnp.asarray(wi), jnp.asarray(wo),
                                        active_types=(jbsdf.IRAWAN,)))
    out = getattr(tbsdf, fn)(tbl, torch.from_numpy(wi), torch.from_numpy(wo),
                             active_types=(tbsdf.IRAWAN,)).numpy()
    np.testing.assert_allclose(out, ref, **LOBE_TOL)
    np.testing.assert_array_equal(out > 1e-30, ref > 1e-30)
    if fn == "eval":  # the specular term is on in these lanes
        assert (out[..., 0] > tbl.albedo[..., 0].numpy() / np.pi
                * np.maximum(wo[..., 2], 0) * 1.01).mean() > 0.05


@pytest.mark.parametrize("pid", range(len(PATTERNS)), ids=PATTERNS)
def test_irawan_sample_matches_jax(tables, pid):
    n = N
    jbl, tbl = _locals(tables, pid, n, 40 + pid)
    wi, _ = _dirs(n, 50 + pid)
    u = np.random.default_rng(60 + pid).random((n, 3), np.float32)
    ref = jbsdf.sample(jbl, jnp.asarray(wi), jnp.asarray(u[:, 0]),
                       jnp.asarray(u[:, 1:]), active_types=(jbsdf.IRAWAN,))
    out = tbsdf.sample(tbl, torch.from_numpy(wi), torch.from_numpy(u[:, 0]),
                       torch.from_numpy(u[:, 1:]),
                       active_types=(tbsdf.IRAWAN,))
    for f in ("is_delta", "eta"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("wo", "pdf"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(ref.weight),
                               **LOBE_TOL)


# --- a nested irawan row -----------------------------------------------------

def _nested_pair(builder_cls, bsdf, shapes, transform, **build_kw):
    """A rectangle of twill (the top-level row) and the same rectangle of a
    mixture of weights (1, 0) over that twill and a diffuse."""
    out = []
    for nested in (False, True):
        b = builder_cls()
        pid = b.add_irawan_pattern(preset="twill", kd=(0.4, 0.2, 0.1),
                                   repeat_u=7.0, repeat_v=3.0)
        cloth = b.add_material(type=bsdf.IRAWAN, irawan=pid)
        mat = cloth
        if nested:
            mat = b.add_material(type=bsdf.MIXTURE, nested_a=cloth,
                                 nested_b=b.add_material(), weight=1.0)
        v, f, uv = shapes.rectangle(transform.rotate([1, 0, 0], -90.0))
        b.add_mesh(v, f, mat, uvs=uv)
        out.append(b.build(**build_kw))
    return out


def test_a_nested_irawan_row_gathers_its_yarn():
    """The port gathers a nested IRAWAN row's yarn parameters: a mixture of
    weights (1, 0) over the twill and a diffuse evaluates as the twill
    itself, lane for lane. The JAX package's bsdf_nested gathers none (its
    nested locals carry iw_par = 0, so the row is a Lambertian of the row's
    albedo there): the fault this repairs."""
    (ts, tst), (ns, nst) = _nested_pair(tscene.SceneBuilder, tbsdf, tshapes,
                                        TTransform, device="cpu")
    assert tbsdf.IRAWAN in nst.nested_bsdf_types
    n = N
    rng = np.random.default_rng(70)
    xz = (rng.random((n, 2), np.float32) * 1.8 - 0.9).astype(np.float32)
    o = np.stack([xz[:, 0], np.full(n, 1.0, np.float32), xz[:, 1]], -1)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-4, torch.inf)
    its = tscene.ray_intersect(ts, tst, *args)
    its_n = tscene.ray_intersect(ns, nst, *args)
    assert bool(its.valid.all())
    wo = torch.from_numpy(_dirs(n, 71)[1])
    top = tscene.bsdf_locals(ts, its, tst)
    mix = tscene.bsdf_locals(ns, its_n, nst)
    nested = tscene.bsdf_nested(ns, its_n, nst)
    for fn in (tbsdf.eval, tbsdf.pdf):
        a = fn(top, its.wi, wo, active_types=tst.bsdf_types)
        b = fn(mix, its_n.wi, wo, active_types=nst.bsdf_types, nested=nested)
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert float(top.iw_par[:, 12].abs().min()) > 0  # the specular is on

    _, (jns, jnst) = _nested_pair(jscene.SceneBuilder, jbsdf, jshapes,
                                  JTransform)
    jits = types.SimpleNamespace(mat_id=jnp.asarray(its_n.mat_id.numpy()),
                                 uv=jnp.asarray(its_n.uv.numpy()))
    jbl_a = jscene.bsdf_nested(jns, jits, jnst)[0]
    assert float(jnp.abs(jbl_a.iw_par).max()) == 0.0


# --- an irawan scene file ----------------------------------------------------

@pytest.fixture(scope="module")
def cloth_scene(cloth_dir):
    """The .cloth variant of phase 9i's scene at 8x8, 4 spp through both
    loaders, and the JAX and port (bridge) images with their ray counts."""
    defines = {"spp": SPP, "res": RES}
    path = str(cloth_dir / "cloth.xml")
    jls = jxml.load_scene(path, defines)
    tls = txml.load_scene(path, defines, device="cpu")
    bs, bst = bridge.scene_from_arrays(
        jax_scene_arrays(jls.scene), dataclasses.asdict(jls.static),
        device="cpu")
    ref, n_ref = jax_render(jls.scene, jls.static, jls.sensor, jls.integrator,
                            jls.settings)
    img, n = tapi.render(bs, bst, tls.sensor, tls.integrator, tls.settings,
                         device="cpu", with_stats=True)
    return dict(jls=jls, tls=tls, ref=ref, n_ref=n_ref, img=img.numpy(), n=n)


def test_cloth_file_loads_as_the_jax_loaders(cloth_scene):
    jls, tls = cloth_scene["jls"], cloth_scene["tls"]
    assert tls.static.bsdf_types == tuple(jls.static.bsdf_types) == (
        tbsdf.IRAWAN,)
    for path in FIELD_PATHS:
        ref = jls.scene
        for p in path:
            ref = getattr(ref, p)
        out = _leaf(tls.scene, path)
        if path == ("irawan", "spec_norm"):
            np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5)
        else:
            np.testing.assert_array_equal(out, np.asarray(ref),
                                          err_msg=".".join(path))
    assert tls.integrator.max_depth == jls.integrator.max_depth == 3
    assert txml._LATER_BSDFS == {}


def test_cloth_render_matches_jax(cloth_scene):
    img, ref = cloth_scene["img"], cloth_scene["ref"]
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-3
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-4)
    np.testing.assert_allclose(img, ref, atol=1e-4, rtol=1e-3)
    assert cloth_scene["n"] == cloth_scene["n_ref"]
