"""Port parity, plastic layer: the PLASTIC and ROUGH_PLASTIC BSDFs of
mitsuba_tpu_torch, the rough-transmittance bake (``core/rtrans.py``), the
builders' material tables and the scene-file elements ``plastic`` and
``roughplastic``, against the JAX package on the same numpy inputs, on the
CPU.

Tolerances:
  * eval, pdf and sample: allclose rtol 1e-5 / atol 1e-6 (float32
    elementwise, the same order of operations); masks, is_delta and eta
    exactly. sample's outputs are compared on its live lanes (pdf > 0): a
    dead lane's direction is unused, and visible-normal sampling of a wi
    below the horizon is ill-conditioned there. Live lanes whose sampled
    direction grazes the surface (|wo.z| < 0.1, at most a tenth) get
    rtol 2e-4 / atol 1e-5: the cosine-hemisphere warp takes
    z = sqrt(1 - x^2 - y^2) of x and y from cos and sin, which XLA and
    PyTorch round within an ulp of each other, and near z = 0 that ulp
    grows by 1/z (measured: at most 5e-5 relative in wo, 2.7e-5 in the
    weight, all at |wo.z| < 0.06);
  * the bake (fit_poly, diffuse_transmittance) and the material tables:
    bitwise (the same float64 numpy arithmetic, cast to float32 at the end).
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import rtrans as jrtrans
from mitsuba_tpu.io import image as jimage
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core import rtrans as trtrans
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import microfacet as tmf
from test_torch_render import FIELD_PATHS, _leaf, jax_scene_arrays

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "scripts")]
import chip_smoke  # noqa: E402
from jax_veach_ref_mean import veach_scene as jax_veach  # noqa: E402

R = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
GRAZING, GRAZING_TOL = 0.1, dict(rtol=2e-4, atol=1e-5)
# four materials per case, lanes spread over them at random
N_MATS = 4


def _uniform_sphere(rs, n):
    z = rs.uniform(-1.0, 1.0, n)
    phi = rs.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], -1).astype(np.float32)


def _case_inputs(typ, dist, nonlinear, twosided):
    """Per-lane parameters of ``N_MATS`` materials of one case, with the
    bake of each, and seeded directions: wi and wo over the whole sphere
    (half below the surface), uniforms for sample."""
    rs = np.random.default_rng(1000 * typ + 100 * dist + 10 * nonlinear
                               + twosided)
    alpha = rs.uniform(0.05, 0.6, N_MATS)
    eta = rs.uniform(1.3, 1.8, N_MATS)
    coef = np.zeros((N_MATS, 6), np.float32)
    fdr = np.zeros(N_MATS, np.float32)
    if typ == tbsdf.ROUGH_PLASTIC:
        for j in range(N_MATS):
            coef[j] = jrtrans.fit_poly(dist, alpha[j], eta[j])[0]
            fdr[j] = 1.0 - jrtrans.diffuse_transmittance(dist, alpha[j],
                                                         1.0 / eta[j])
    mid = rs.integers(0, N_MATS, R)
    f32 = np.float32
    return dict(
        type=np.full(R, typ, np.int32), dist=np.full(R, dist, np.int32),
        albedo=rs.uniform(0.0, 1.0, (R, 3)).astype(f32),
        spec_refl=rs.uniform(0.3, 1.0, (R, 3)).astype(f32),
        eta_s=eta[mid].astype(f32),
        alpha=np.repeat(alpha[mid, None], 2, 1).astype(f32),
        nonlinear=np.full(R, bool(nonlinear)),
        twosided=np.full(R, bool(twosided)),
        rt_coef=coef[mid], rt_fdr=fdr[mid],
        wi=_uniform_sphere(rs, R), wo=_uniform_sphere(rs, R),
        u_lobe=rs.random(R).astype(f32), u2=rs.random((R, 2)).astype(f32))


def _jax_locals(a):
    z1, z3 = jnp.zeros(R), jnp.zeros((R, 3))
    return jbsdf.BsdfLocals(
        type=jnp.asarray(a["type"]), dist=jnp.asarray(a["dist"]),
        albedo=jnp.asarray(a["albedo"]), spec_refl=jnp.asarray(a["spec_refl"]),
        spec_trans=z3, eta_s=jnp.asarray(a["eta_s"]),
        eta_c=jnp.asarray(np.repeat(a["eta_s"][:, None], 3, 1)), k_c=z3,
        alpha=jnp.asarray(a["alpha"]), nonlinear=jnp.asarray(a["nonlinear"]),
        twosided=jnp.asarray(a["twosided"]), opacity=jnp.ones(R), blend_w=z1,
        hk_thickness=z1, hk_g=z1, rt_coef=jnp.asarray(a["rt_coef"]),
        rt_fdr=jnp.asarray(a["rt_fdr"]), iw_par=jnp.zeros((R, 13)),
        iw_ks=z3)


def _port_locals(a):
    t = torch.from_numpy
    return tbsdf.BsdfLocals(
        type=t(a["type"]), dist=t(a["dist"]), albedo=t(a["albedo"]),
        spec_refl=t(a["spec_refl"]),
        eta_c=t(np.repeat(a["eta_s"][:, None], 3, 1)),
        k_c=torch.zeros(R, 3), alpha=t(a["alpha"]),
        twosided=t(a["twosided"]), eta_s=t(a["eta_s"]),
        nonlinear=t(a["nonlinear"]), rt_coef=t(a["rt_coef"]),
        rt_fdr=t(a["rt_fdr"]))


# the smooth plastic reads no microfacet distribution: one dist for it
CASES = [(tbsdf.PLASTIC, tmf.BECKMANN, nl, ts)
         for nl in (False, True) for ts in (False, True)] + [
        (tbsdf.ROUGH_PLASTIC, d, nl, ts) for d in (tmf.BECKMANN, tmf.GGX)
        for nl in (False, True) for ts in (False, True)]


def _case_id(c):
    typ, dist, nl, ts = c
    name = "plastic" if typ == tbsdf.PLASTIC else (
        "roughplastic-" + ("ggx" if dist == tmf.GGX else "beckmann"))
    return (f"{name}-{'nonlinear' if nl else 'linear'}-"
            f"{'twosided' if ts else 'onesided'}")


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def case(request):
    a = _case_inputs(*request.param)
    return a, _jax_locals(a), _port_locals(a), (request.param[0],)


@pytest.mark.parametrize("fn", ["eval", "pdf"])
def test_eval_and_pdf_match_jax(case, fn):
    a, jbl, tbl, types = case
    ref = np.asarray(getattr(jbsdf, fn)(jbl, jnp.asarray(a["wi"]),
                                        jnp.asarray(a["wo"]),
                                        active_types=types))
    out = getattr(tbsdf, fn)(tbl, torch.from_numpy(a["wi"]),
                             torch.from_numpy(a["wo"]),
                             active_types=types).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out != 0, ref != 0)
    live = (ref != 0) if ref.ndim == 1 else (ref != 0).any(axis=-1)
    assert live.sum() > R // 8


def test_sample_matches_jax(case):
    a, jbl, tbl, types = case
    js = jbsdf.sample(jbl, jnp.asarray(a["wi"]), jnp.asarray(a["u_lobe"]),
                      jnp.asarray(a["u2"]), active_types=types)
    ts = tbsdf.sample(tbl, torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=types)
    np.testing.assert_array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    np.testing.assert_array_equal(ts.eta.numpy(), np.asarray(js.eta))
    live = np.asarray(js.pdf) > 0
    np.testing.assert_array_equal(ts.pdf.numpy() > 0, live)
    grazing = np.abs(np.asarray(js.wo)[:, 2]) < GRAZING
    for lanes, tol in ((live & ~grazing, TOL), (live & grazing, GRAZING_TOL)):
        for f in ("wo", "weight", "pdf"):
            np.testing.assert_allclose(getattr(ts, f).numpy()[lanes],
                                       np.asarray(getattr(js, f))[lanes],
                                       **tol, err_msg=f)
    np.testing.assert_array_equal(ts.weight.numpy()[~live], 0.0)
    assert live.sum() > R // 4 and (live & grazing).sum() < live.sum() // 8
    if types == (tbsdf.PLASTIC,):
        # the specular choice is a delta lobe, the diffuse one is not
        assert 0 < ts.is_delta.sum() < live.sum()
    else:
        assert not ts.is_delta.any()


@pytest.mark.parametrize("nonlinear", [False, True])
def test_nonlinear_changes_the_diffuse_lobe(nonlinear):
    """The flag reaches the denominators: flipping it changes eval on the
    lanes with a diffuse part and nowhere else."""
    a = _case_inputs(tbsdf.ROUGH_PLASTIC, tmf.GGX, nonlinear, False)
    b = dict(a, nonlinear=~a["nonlinear"])
    wi, wo = torch.from_numpy(a["wi"]), torch.from_numpy(a["wo"])
    fa = tbsdf.eval(_port_locals(a), wi, wo, (tbsdf.ROUGH_PLASTIC,))
    fb = tbsdf.eval(_port_locals(b), wi, wo, (tbsdf.ROUGH_PLASTIC,))
    both = (a["wi"][:, 2] > 0) & (a["wo"][:, 2] > 0)
    assert (fa != fb).any(dim=-1).numpy()[both].mean() > 0.9
    assert bool((fa == fb).all(dim=-1)[torch.from_numpy(~both)].all())


# --- the bake ----------------------------------------------------------------

BAKE_GRID = [(d, a, e) for d in (tmf.BECKMANN, tmf.GGX)
             for a in (1e-4, 0.02, 0.1, 0.3, 0.7)
             for e in (1.2, 1.49, 1.0 / 1.49, 2.0)]


@pytest.mark.parametrize("dist,alpha,eta", BAKE_GRID)
def test_bake_is_bitwise_the_jax_packages(dist, alpha, eta):
    c_t, T_t = trtrans.fit_poly(dist, alpha, eta)
    c_j, T_j = jrtrans.fit_poly(dist, alpha, eta)
    assert c_t.dtype == c_j.dtype == np.float32
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(T_t, T_j)
    assert (trtrans.diffuse_transmittance(dist, alpha, eta)
            == jrtrans.diffuse_transmittance(dist, alpha, eta))


# --- tables ------------------------------------------------------------------

@pytest.fixture(scope="module")
def plastic_scenes():
    """The Veach MIS scene with plastics (chip_smoke.veach_scene) through
    both builders."""
    return (jax_veach(plastic=True, size=8),
            chip_smoke.veach_scene("cpu", plastic=True, size=8))


def test_builders_give_equal_material_tables(plastic_scenes):
    (jscene, jstatic, _), (tscene, tstatic, _) = plastic_scenes
    for path in FIELD_PATHS:
        ref = jscene
        for p in path:
            ref = getattr(ref, p)
        ref = np.asarray(ref)
        out = _leaf(tscene, path)
        assert out.dtype == ref.dtype, path
        np.testing.assert_array_equal(out, ref, err_msg=".".join(path))
    assert dataclasses.asdict(tstatic) == {
        k: v for k, v in dataclasses.asdict(jstatic).items()
        if k in dataclasses.asdict(tstatic)}
    assert tstatic.bsdf_types == (tbsdf.DIFFUSE, tbsdf.ROUGH_CONDUCTOR,
                                  tbsdf.PLASTIC, tbsdf.ROUGH_PLASTIC)
    # only the rough plastic rows carry coefficients
    rough = (tscene.materials.type == tbsdf.ROUGH_PLASTIC).numpy()
    assert rough.sum() == 2
    assert (tscene.materials.rt_coef.numpy()[rough] != 0).all()
    assert (tscene.materials.rt_coef.numpy()[~rough] == 0).all()
    assert tscene.materials.nonlinear.numpy().sum() == 1


def test_bridge_carries_the_plastic_columns(plastic_scenes):
    (jscene, jstatic, _), (tscene, _, _) = plastic_scenes
    ref, _ = bridge.scene_from_arrays(jax_scene_arrays(jscene),
                                      dataclasses.asdict(jstatic),
                                      device="cpu")
    for path in FIELD_PATHS:
        np.testing.assert_array_equal(_leaf(ref, path), _leaf(tscene, path),
                                      err_msg=".".join(path))


def test_bridge_needs_the_columns_that_plastics_read(plastic_scenes):
    (jscene, jstatic, _), _ = plastic_scenes
    arrays = jax_scene_arrays(jscene)
    del arrays["materials"]["rt_coef"]
    with pytest.raises(KeyError, match="rt_coef"):
        bridge.scene_from_arrays(arrays, dataclasses.asdict(jstatic),
                                 device="cpu")


PLASTIC_XML = """<scene version="0.6.0">
  <texture type="bitmap" id="grain">
    <string name="filename" value="grain.pfm"/>
  </texture>
  <bsdf type="plastic" id="floor">
    <ref name="diffuseReflectance" id="grain"/>
    <string name="intIOR" value="acrylic glass"/>
    <boolean name="nonlinear" value="true"/>
  </bsdf>
  <bsdf type="twosided" id="panel">
    <bsdf type="roughplastic">
      <string name="distribution" value="ggx"/>
      <float name="alpha" value="0.15"/>
      <rgb name="diffuseReflectance" value="0.6, 0.3, 0.1"/>
      <rgb name="specularReflectance" value="0.9, 0.9, 0.8"/>
      <string name="extIOR" value="water"/>
    </bsdf>
  </bsdf>
  <shape type="rectangle"><ref id="floor"/></shape>
  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/>
    <float name="radius" value="0.4"/>
    <ref id="panel"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld"><translate y="1.5"/></transform>
    <bsdf type="roughplastic"/>
  </shape>
  <emitter type="constant"/>
</scene>
"""


def test_scene_file_plastics_load_as_the_jax_loaders(tmp_path):
    """plastic and roughplastic through both loaders: an IOR by name, the
    default polypropylene over air, nonlinear, a diffuseReflectance
    texture reference, twosided, a distribution and specularReflectance."""
    img = np.random.default_rng(3).random((4, 6, 3)).astype(np.float32)
    jimage.write_image(str(tmp_path / "grain.pfm"), img)
    path = tmp_path / "plastic.xml"
    path.write_text(PLASTIC_XML)
    jls = jxml.load_scene(str(path))
    tls = txml.load_scene(str(path), device="cpu")
    ref, ref_static = bridge.scene_from_arrays(
        jax_scene_arrays(jls.scene), dataclasses.asdict(jls.static),
        device="cpu")
    for p in FIELD_PATHS:
        a, b = _leaf(tls.scene, p), _leaf(ref, p)
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=".".join(p))
    assert tls.static == ref_static
    mats = tls.scene.materials
    assert mats.type.tolist() == [tbsdf.PLASTIC, tbsdf.ROUGH_PLASTIC,
                                  tbsdf.ROUGH_PLASTIC]
    assert mats.nonlinear.tolist() == [True, False, False]
    assert mats.twosided.tolist() == [False, True, False]
    assert mats.albedo_tex.tolist() == [0, -1, -1]
    np.testing.assert_allclose(mats.eta[:, 0].numpy(),
                               [1.49 / 1.000277, 1.49 / 1.3330, 1.49 / 1.000277],
                               rtol=1e-6)


# --- the gathers of a scene without plastics ---------------------------------

class _Recorder:
    """A table column that records the gathers made from it."""

    def __init__(self, name, t, seen):
        self.name, self.t, self.seen = name, t, seen

    def __getitem__(self, idx):
        self.seen.append(self.name)
        return self.t[idx]


def _gathered(scene, static):
    seen = []
    mats = scene.materials
    table = mats._replace(**{f: _Recorder(f, getattr(mats, f), seen)
                             for f in mats._fields})
    mid = torch.arange(mats.type.shape[0], dtype=torch.int32)
    bl = tbsdf.gather_locals(table, mid, albedo_override=mats.albedo[mid],
                             types=static.bsdf_types)
    return seen, bl


def test_no_plastic_column_is_gathered_without_plastics():
    """On the training scene's materials (diffuse and a rough conductor) the
    gathers are the columns those types read: none of the plastics' and
    none of the dielectric's, so the training step's backward meets no new
    sorting gather."""
    scene, static = chip_smoke.train_scene("cpu")[:2]
    seen, bl = _gathered(scene, static)
    assert sorted(seen) == ["alpha", "dist", "eta", "k", "spec_refl",
                            "twosided", "type"]
    assert bl.eta_s is bl.nonlinear is bl.rt_coef is bl.rt_fdr is None
    assert bl.spec_trans is None


def test_plastic_columns_are_gathered_with_plastics(plastic_scenes):
    _, (scene, static, _) = plastic_scenes
    seen, bl = _gathered(scene, static)
    assert sorted(seen) == ["alpha", "dist", "eta", "k", "nonlinear",
                            "rt_coef", "rt_fdr", "spec_refl", "twosided",
                            "type"]
    np.testing.assert_array_equal(bl.eta_s.numpy(),
                                  scene.materials.eta[:, 0].numpy())
