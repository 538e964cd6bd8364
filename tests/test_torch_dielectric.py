"""Port parity for the glass sphere of scenes/cbox.xml: the smooth dielectric
(Fresnel, refraction, the delta lobe), analytic spheres, and scene queries on
a scene that mixes triangles and spheres, against the JAX package on the
same numpy inputs, on the CPU.

Tolerances: module values rtol 1e-5 / atol 1e-6 (float32 rounding of the
same operation order); booleans, integer ids and the lobe choice exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import math as jm
from mitsuba_tpu.ops import intersect as jisect
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch.core import math as tm
from mitsuba_tpu_torch.ops import intersect as tisect
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
BK7 = 1.5046
R = 4096


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    if ref.dtype.kind in "bi":
        np.testing.assert_array_equal(out, ref, err_msg=what)
    else:
        np.testing.assert_allclose(out, ref, **TOL, err_msg=what)


def unit_dirs(rs, n):
    """Random unit directions on both sides of z = 0, a quarter of them
    grazing (|z| below 1e-3) and a few exactly tangent (z = 0)."""
    d = rs.normal(size=(n, 3))
    d[: n // 4, 2] = rs.uniform(-1e-3, 1e-3, n // 4)
    d[n // 4: n // 4 + 8, 2] = 0.0
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def dirs():
    """wi on both sides (inside the glass where z < 0, where most of the
    outgoing cosines reach total internal reflection for eta = BK7), eta
    BK7 or 1/BK7 per lane, and the lobe uniforms."""
    rs = np.random.default_rng(11)
    wi = unit_dirs(rs, R)
    eta = np.where(rs.random(R) < 0.5, BK7, 1.0 / BK7).astype(np.float32)
    u = rs.random((R, 3)).astype(np.float32)
    return wi, eta, u


def test_fresnel_dielectric_matches_jax(dirs):
    wi, eta, _ = dirs
    F_ref, ct_ref = jm.fresnel_dielectric(jnp.asarray(wi[:, 2]), jnp.asarray(eta))
    F, ct = tm.fresnel_dielectric(_t(wi[:, 2]), _t(eta))
    _close(F.numpy(), F_ref, "F")
    _close(ct.numpy(), ct_ref, "cos_t")
    tir = np.asarray(F_ref) == 1.0
    assert 100 < tir.sum() < R // 2  # total internal reflection is covered
    np.testing.assert_array_equal(F.numpy() == 1.0, tir)


def test_refract_matches_jax(dirs):
    wi, eta, _ = dirs
    n = np.tile(np.float32([0.0, 0.0, 1.0]), (R, 1))
    ok_ref, wt_ref = jm.refract(jnp.asarray(wi), jnp.asarray(n), jnp.asarray(eta))
    ok, wt = tm.refract(_t(wi), _t(n), _t(eta))
    _close(ok.numpy(), ok_ref, "valid")
    _close(wt.numpy(), wt_ref, "wt")
    assert not np.asarray(ok_ref).all()


def locals_pair(eta, rs):
    """Dielectric BsdfLocals of the JAX package and of the port, the same
    values per lane (random tints)."""
    n = len(eta)
    refl = rs.uniform(0.5, 1.0, (n, 3)).astype(np.float32)
    trans = rs.uniform(0.5, 1.0, (n, 3)).astype(np.float32)
    typ = np.full(n, jbsdf.DIELECTRIC, np.int32)
    ts = np.zeros(n, bool)
    z1, z3 = np.zeros(n, np.float32), np.zeros((n, 3), np.float32)
    a2 = np.full((n, 2), 0.1, np.float32)
    eta3 = np.repeat(eta[:, None], 3, axis=-1)
    jbl = jbsdf.BsdfLocals(
        type=jnp.asarray(typ), dist=jnp.zeros(n, jnp.int32),
        albedo=jnp.asarray(z3), spec_refl=jnp.asarray(refl),
        spec_trans=jnp.asarray(trans), eta_s=jnp.asarray(eta),
        eta_c=jnp.asarray(eta3), k_c=jnp.asarray(z3), alpha=jnp.asarray(a2),
        nonlinear=jnp.zeros(n, bool), twosided=jnp.asarray(ts),
        opacity=jnp.ones(n), blend_w=jnp.asarray(z1),
        hk_thickness=jnp.asarray(z1), hk_g=jnp.asarray(z1),
        rt_coef=jnp.zeros((n, 6)), rt_fdr=jnp.asarray(z1),
        iw_par=jnp.zeros((n, 13)), iw_ks=jnp.asarray(z3))
    tbl = tbsdf.BsdfLocals(
        type=_t(typ), dist=torch.zeros(n, dtype=torch.int32), albedo=_t(z3),
        spec_refl=_t(refl), eta_c=_t(eta3), k_c=_t(z3), alpha=_t(a2),
        twosided=_t(ts), spec_trans=_t(trans), eta_s=_t(eta))
    return jbl, tbl


TYPES = (jbsdf.DIFFUSE, jbsdf.DIELECTRIC)


@pytest.mark.parametrize("fn", ["eval", "pdf"])
def test_dielectric_eval_and_pdf_are_zero_as_in_jax(dirs, fn):
    wi, eta, _ = dirs
    jbl, tbl = locals_pair(eta, np.random.default_rng(12))
    wo = unit_dirs(np.random.default_rng(13), R)
    ref = getattr(jbsdf, fn)(jbl, jnp.asarray(wi), jnp.asarray(wo),
                             active_types=TYPES)
    out = getattr(tbsdf, fn)(tbl, _t(wi), _t(wo), active_types=TYPES)
    _close(out.numpy(), ref, fn)
    assert not out.any()


@pytest.mark.parametrize("twosided", [False, True], ids=["onesided", "twosided"])
def test_dielectric_sample_matches_jax(dirs, twosided):
    """Both sides of the surface, both etas, reflection, refraction and
    total internal reflection. A dielectric row marked two-sided is not
    flipped: its side comes from the sign of cos θi (the JAX loader never
    marks one, so the reference is the unmarked row)."""
    wi, eta, u = dirs
    jbl, tbl = locals_pair(eta, np.random.default_rng(14))
    tbl = tbl._replace(twosided=torch.full((R,), twosided))
    ref = jbsdf.sample(jbl, jnp.asarray(wi), jnp.asarray(u[:, 0]),
                       jnp.asarray(u[:, 1:3]), active_types=TYPES)
    out = tbsdf.sample(tbl, _t(wi), _t(u[:, 0]), _t(u[:, 1:3]),
                       active_types=TYPES)
    for f in ref._fields:
        _close(getattr(out, f).numpy(), getattr(ref, f), f)
    refl = np.asarray(ref.wo)[:, 2] * wi[:, 2] > 0
    assert 0 < refl.sum() < R  # both lobes taken
    assert np.asarray(ref.is_delta).all()


# --- spheres --------------------------------------------------------------

CENTERS = np.float32([[0.3, 0.2, 0.4], [0.7, 0.3, 0.6], [0.5, 0.8, 0.5]])
RADII = np.float32([0.2, 0.15, 0.1])


@pytest.fixture(scope="module")
def sphere_rays():
    """Rays from inside the unit box: a third start inside a sphere, a
    sixth are tangent to sphere 0, the rest random (most miss)."""
    rs = np.random.default_rng(21)
    o = rs.uniform(0.05, 0.95, (R, 3)).astype(np.float32)
    d = unit_dirs(rs, R)
    k = R // 3
    which = rs.integers(0, 3, k)
    o[:k] = CENTERS[which] + (rs.normal(size=(k, 3)) * 0.3
                              * RADII[which, None]).astype(np.float32)
    # tangent rays: start on the sphere's tangent plane, run along it
    j = slice(k, k + R // 6)
    m = R // 6
    n = rs.normal(size=(m, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tang = np.cross(n, rs.normal(size=(m, 3)))
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    o[j] = (CENTERS[0] + RADII[0] * n - 0.5 * tang).astype(np.float32)
    d[j] = tang.astype(np.float32)
    t_min = np.full(R, 1e-4, np.float32)
    t_max = np.where(rs.random(R) < 0.1, 0.3, np.inf).astype(np.float32)
    return o, d, t_min, t_max


def test_ray_sphere_matches_jax(sphere_rays):
    o, d, t_min, t_max = sphere_rays
    c = np.broadcast_to(CENTERS[0], o.shape)
    ref = jisect.ray_sphere(*(jnp.asarray(x) for x in (o, d, c)), RADII[0],
                            jnp.asarray(t_min), jnp.asarray(t_max))
    out = tisect.ray_sphere(*(_t(np.ascontiguousarray(x)) for x in (o, d, c)),
                            _t(RADII[0]), _t(t_min), _t(t_max))
    _close(out[0].numpy(), ref[0], "hit")
    h = np.asarray(ref[0])
    _close(out[1].numpy()[h], np.asarray(ref[1])[h], "t")


def test_ray_brute_force_spheres_matches_jax(sphere_rays):
    o, d, t_min, t_max = sphere_rays
    ref = jisect.ray_brute_force_spheres(
        *(jnp.asarray(x) for x in (o, d, CENTERS, RADII, t_min, t_max)))
    out = tisect.ray_brute_force_spheres(
        *(_t(x) for x in (o, d, CENTERS, RADII, t_min, t_max)))
    for name, a, b in zip(("hit", "t", "idx"), out, ref):
        _close(a.numpy(), b, name)
    hit = np.asarray(ref[0])
    assert 0.3 < hit.mean() < 0.9


def build_mixed(SceneBuilder, shapes, **build_kw):
    """The Cornell box with a glass sphere, a diffuse sphere that pokes
    through the floor, and one hidden inside the tall block, built by the
    same calls through either package."""
    b = SceneBuilder()
    ids = shapes.cornell_box(b)
    glass = b.add_material(type=1, eta=BK7)
    b.add_sphere(CENTERS[0], float(RADII[0]), glass)
    b.add_sphere([0.7, 0.05, 0.2], 0.12, ids["red"])
    b.add_sphere([0.64, 0.3, 0.53], 0.05, ids["white"])
    return b.build(**build_kw)


@pytest.fixture(scope="module")
def mixed_hits():
    jsc, jst = build_mixed(jscene.SceneBuilder, jshapes)
    tsc, tst = build_mixed(tscene.SceneBuilder, tshapes, device="cpu")
    assert tst.n_spheres == jst.n_spheres == 3
    rs = np.random.default_rng(22)
    o = rs.uniform(0.05, 0.95, (R, 3)).astype(np.float32)
    o[: R // 4] = CENTERS[0] + rs.normal(size=(R // 4, 3)).astype(
        np.float32) * 0.05  # inside the glass
    d = unit_dirs(rs, R)
    t_max = np.where(rs.random(R) < 0.2, 0.25, np.inf).astype(np.float32)
    jits = jscene.ray_intersect(jsc, jst, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                jnp.asarray(t_max))
    tits = tscene.ray_intersect(tsc, tst, _t(o), _t(d), 1e-4, _t(t_max))
    jocc = jscene.occluded(jsc, jst, jnp.asarray(o), jnp.asarray(d), 0.0,
                           jnp.asarray(t_max))
    tocc = tscene.occluded(tsc, tst, _t(o), _t(d), 0.0, _t(t_max))
    return jits, tits, jocc, tocc, jst.n_tris


@pytest.mark.parametrize("field", ["valid", "t", "p", "gn", "uv", "wi", "mat_id",
                                   "emitter_id", "prim_id", "nee_pdf_area"])
def test_mixed_ray_intersect_matches_jax(mixed_hits, field):
    jits, tits = mixed_hits[:2]
    ref, out = np.asarray(getattr(jits, field)), getattr(tits, field).numpy()
    if ref.dtype.kind == "f" and field != "nee_pdf_area":
        # the record of a missed lane is unspecified (t is inf there)
        ok = np.asarray(jits.valid)
        ref, out = ref[ok], out[ok]
    _close(out, ref, field)


def test_mixed_shading_normals_match_jax(mixed_hits):
    jits, tits = mixed_hits[:2]
    ok = np.asarray(jits.valid)
    _close(tits.sh_frame.n.numpy()[ok], np.asarray(jits.sh_frame.n)[ok],
           "sh_frame.n")


def test_mixed_scene_hits_both_kinds(mixed_hits):
    jits, _, _, _, T = mixed_hits
    prim = np.asarray(jits.prim_id)
    assert ((prim >= 0) & (prim < T)).sum() > 100
    assert (prim >= T).sum() > 100
    assert np.all(np.asarray(jits.nee_pdf_area)[prim >= T] == 0.0)


def test_mixed_occluded_matches_jax(mixed_hits):
    jocc, tocc = mixed_hits[2:4]
    _close(tocc.numpy(), jocc, "occluded")
    assert 0 < np.asarray(jocc).mean() < 1
