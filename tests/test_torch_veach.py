"""Port parity for the Veach MIS scene (BASELINE config 3): the analytic
sphere lights of mitsuba_tpu_torch (cone-sampled NEE and its MIS
counterweight), the emitter table of scenes that mix them with area lights
and an environment, and renders of the scene through the path tracer and
the direct integrator, against the JAX package on the CPU.

Tolerances:
  * builder tables: exactly (the same numpy arithmetic, cast to float32 at
    the end);
  * sample_direct, pdf_direct_sphere and pdf_emitter_hit: rtol 1e-5 /
    atol 1e-6 (float32 elementwise; cos and sin round within an ulp of
    XLA's); valid flags exactly;
  * the analytic anchor (port only): the NEE estimate of the irradiance
    from a sphere light within 0.5% of pi L (r/d)^2 at 2^16 samples;
  * renders, as test_torch_scenefile.py holds cbox.xml: image means within
    1e-3 relative, >= 99% of pixels within atol 1e-4 / rtol 1e-3, equal
    ray-query counts.
"""
import dataclasses
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import emitter as jem
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import emitter as tem
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_render import FIELD_PATHS, _leaf
from test_torch_scenefile import jax_render

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "scripts")]
import chip_smoke  # noqa: E402
from jax_veach_ref_mean import veach_scene as jax_veach  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# the sphere lights of the scene: (center, radius)
SPHERES = [((x, 2.6, 0.5), r) for x, r in ((-1.5, 0.03), (0.0, 0.12),
                                           (1.5, 0.45))]
W = H = 8
SPP = 2


@pytest.fixture(scope="module")
def veach():
    """{plastic: (JAX (scene, static, sensor), the port's)} at 8x8."""
    return {p: (jax_veach(p, size=W),
                chip_smoke.veach_scene("cpu", plastic=p, size=W))
            for p in (False, True)}


def _assert_tables_equal(jsc, tsc):
    for path in FIELD_PATHS:
        ref = jsc
        for p in path:
            ref = getattr(ref, p)
        ref = np.asarray(ref)
        out = _leaf(tsc, path)
        assert out.dtype == ref.dtype, path
        np.testing.assert_array_equal(out, ref, err_msg=".".join(path))


@pytest.mark.parametrize("plastic", [False, True], ids=["veach", "plastic"])
def test_builder_matches_jax(veach, plastic):
    (jsc, jst, _), (tsc, tst, _) = veach[plastic]
    _assert_tables_equal(jsc, tsc)
    jd = dataclasses.asdict(jst)
    assert all(jd[k] == v for k, v in dataclasses.asdict(tst).items())
    assert tst.emitter_types == (tem.SPHERE,) and tst.n_spheres == 3
    np.testing.assert_array_equal(tsc.sph_emitter.numpy(), [0, 1, 2])
    np.testing.assert_array_equal(tsc.emitters.spot_cos[:, 0].numpy(),
                                  np.float32([r for _, r in SPHERES]))


def _reference_points(rs, n_per):
    """Points around each sphere light at distances from its center of
    0.5 r (inside), r (on), r (1 + 1e-5) (the outside test's edge), 1.5 r,
    4 r and 3 to 6 scene units, in seeded directions."""
    pts = []
    for c, r in SPHERES:
        for scale in (0.5, 1.0, 1.0 + 1e-5, 1.5, 4.0, None):
            d = rs.normal(size=(n_per, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            dist = (rs.uniform(3.0, 6.0, (n_per, 1)) if scale is None
                    else r * scale)
            pts.append(np.asarray(c) + d * dist)
    return np.concatenate(pts).astype(np.float32)


@pytest.fixture(scope="module")
def points():
    rs = np.random.default_rng(12)
    p = _reference_points(rs, 256)
    return p, rs.random((len(p), 3)).astype(np.float32)


def test_sample_direct_sphere_matches_jax(veach, points):
    (jsc, jst, _), (tsc, tst, _) = veach[False]
    p, u3 = points
    js = jem.sample_direct(jsc, jst, jnp.asarray(p), jnp.asarray(u3))
    ts = tem.sample_direct(tsc, tst, torch.from_numpy(p), torch.from_numpy(u3))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.delta.numpy(), np.asarray(js.delta))
    for f in ("d", "dist", "pdf_sa", "radiance"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), **TOL,
                                   err_msg=f)
    # a point inside the light it picked samples the sphere of directions
    # at 1/(4 pi) times the selection pmf 1/3
    e = np.searchsorted(np.float32([1 / 3, 2 / 3, 1.0]), u3[:, 0], "right")
    own = np.zeros(len(p), bool)
    for k, (c, r) in enumerate(SPHERES):
        own |= (e == k) & (np.linalg.norm(p - np.asarray(c), axis=1)
                           < 0.9 * r)
    assert own.sum() > 50
    np.testing.assert_allclose(ts.pdf_sa.numpy()[own],
                               1.0 / (4.0 * math.pi) / 3.0, rtol=1e-6)
    assert ts.valid.numpy()[own].all()
    assert ts.valid.numpy().mean() > 0.9


def test_pdf_direct_sphere_matches_jax(veach, points):
    (jsc, _, _), (tsc, _, _) = veach[False]
    p, _ = points
    for k, (c, r) in enumerate(SPHERES):
        e = np.full(len(p), k, np.int32)
        cs = np.broadcast_to(np.float32(c), p.shape).copy()
        rr = np.full(len(p), r, np.float32)
        ref = jem.pdf_direct_sphere(jsc.emitters, jnp.asarray(e),
                                    jnp.asarray(p), jnp.asarray(cs),
                                    jnp.asarray(rr))
        out = tem.pdf_direct_sphere(tsc.emitters, torch.from_numpy(e),
                                    torch.from_numpy(p), torch.from_numpy(cs),
                                    torch.from_numpy(rr))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_small_far_cone_keeps_its_digits(veach):
    """The r = 0.03 light seen from 2.5 away: sin2_max = 1.44e-4, where
    1 - cos_max in float32 loses three digits. The pdf is held to the
    float64 value of 1 / (2 pi (1 - cos_max))."""
    _, (tsc, _, _) = veach[False]
    c, r = SPHERES[0]
    p = np.float32([[c[0], c[1] - 2.5, c[2]]])
    out = tem.pdf_direct_sphere(
        tsc.emitters, torch.zeros(1, dtype=torch.int64), torch.from_numpy(p),
        torch.tensor([c], dtype=torch.float32), torch.tensor([r]))
    d2 = float(np.sum((np.float64(c) - p[0]) ** 2))
    sin2 = np.float64(np.float32(r) ** 2) / d2
    one_minus = sin2 / (1.0 + math.sqrt(1.0 - sin2))
    np.testing.assert_allclose(out.item(), 1.0 / (2 * math.pi * one_minus) / 3,
                               rtol=1e-5)


def _rays_at_spheres(rs, n_per):
    """Rays from the reference points outside the spheres toward points
    near each light (jittered over 1.2 radii), so that most hit it."""
    o, d = [], []
    for c, r in SPHERES:
        dirs = rs.normal(size=(n_per, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        start = np.asarray(c) + dirs * rs.uniform(1.5, 5.0, (n_per, 1))
        target = np.asarray(c) + rs.normal(size=(n_per, 3)) * 0.6 * r
        v = target - start
        o.append(start)
        d.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    return (np.concatenate(o).astype(np.float32),
            np.concatenate(d).astype(np.float32))


def test_pdf_emitter_hit_on_spheres_matches_jax(veach):
    """A BSDF-sampled ray that hits a sphere light reports the cone pdf,
    not the record's 0 (which would give it MIS weight 1 and count it
    twice)."""
    (jsc, jst, _), (tsc, tst, _) = veach[False]
    o, d = _rays_at_spheres(np.random.default_rng(13), 256)
    jits = jscene.ray_intersect(jsc, jst, jnp.asarray(o), jnp.asarray(d),
                                1e-4, jnp.inf)
    tits = tscene.ray_intersect(tsc, tst, torch.from_numpy(o),
                                torch.from_numpy(d), 1e-4, torch.inf)
    np.testing.assert_array_equal(tits.prim_id.numpy(),
                                  np.asarray(jits.prim_id))
    ref = np.asarray(jscene.pdf_emitter_hit(jsc, jits, jnp.asarray(o), jst))
    out = tscene.pdf_emitter_hit(tsc, tits, torch.from_numpy(o), tst).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    on_light = tits.emitter_id.numpy() >= 0
    assert on_light.mean() > 0.5
    assert (out[on_light] > 0).all()
    # the record's area pdf is 0 on a sphere: only the sphere branch gives
    # these hits their pdf
    assert (tits.nee_pdf_area.numpy()[on_light] == 0).all()


def test_triangle_free_sphere_light_gets_its_cone_pdf():
    """Port only: in a scene of spheres and no triangle, a hit on sphere k
    reports sphere k's cone pdf (the primitive ids of ray_intersect)."""
    b = tscene.SceneBuilder()
    m = b.add_material()
    b.add_sphere((0.0, 0.0, 0.0), 0.5, m)
    for x, r in ((-2.0, 0.3), (2.0, 0.6)):
        b.add_sphere((x, 0.0, 0.0), r, m, emitter_radiance=(1.0, 1.0, 1.0))
    scene, static = b.build(device="cpu")
    o = torch.tensor([[-2.0, 3.0, 0.0], [2.0, 3.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    its = tscene.ray_intersect(scene, static, o, d, 1e-4, torch.inf)
    assert its.emitter_id.tolist() == [0, 1]
    pdf = tscene.pdf_emitter_hit(scene, its, o, static)
    ref = tem.pdf_direct_sphere(scene.emitters, torch.tensor([0, 1]), o,
                                scene.sph_center[1:], scene.sph_radius[1:])
    np.testing.assert_array_equal(pdf.numpy(), ref.numpy())


# --- a scene that mixes the kinds of light ---------------------------------

def _mixed(builder_mod, shapes_mod, T):
    """An area-lit quad, a sphere light between two area lights, and a
    constant environment, interleaved: the emitter order is the calls'."""
    b = builder_mod.SceneBuilder()
    m = b.add_material(albedo=(0.5, 0.5, 0.5))
    v, f, _ = shapes_mod.rectangle(T.translate([0, 0, 1]))
    b.add_mesh(v, f, m)
    v, f, _ = shapes_mod.rectangle(T.translate([0, 2, 0])
                                   * T.scale([0.5, 0.25, 1]))
    b.add_mesh(v, f, m, emitter_radiance=(3.0, 3.0, 3.0))
    b.add_sphere((0.5, 1.0, 0.2), 0.2, m, emitter_radiance=(7.0, 6.0, 5.0))
    v, f, _ = shapes_mod.rectangle(T.translate([-1, 2, 0])
                                   * T.scale([0.25, 0.25, 1]))
    b.add_mesh(v, f, m, emitter_radiance=(1.0, 2.0, 3.0))
    b.add_constant_emitter((0.1, 0.2, 0.3))
    return b


@pytest.fixture(scope="module")
def mixed():
    jsc, jst = _mixed(jscene, jshapes, JTransform).build()
    tsc, tst = _mixed(tscene, tshapes, Transform).build(device="cpu")
    return (jsc, jst), (tsc, tst)


def test_mixed_lights_tables_match_jax(mixed):
    """tri_nee_pdf_area folds in the pmf over all four emitters, the sphere
    included: each area triangle carries 1/4 x its local pmf / its area."""
    (jsc, jst), (tsc, tst) = mixed
    _assert_tables_equal(jsc, tsc)
    assert tst.emitter_types == (tem.AREA, tem.CONSTANT, tem.SPHERE)
    assert tsc.emitters.type.tolist() == [tem.AREA, tem.SPHERE, tem.AREA,
                                          tem.CONSTANT]
    np.testing.assert_array_equal(tsc.emitters.pmf.numpy(), np.float32(0.25))
    # the 1 x 0.5 light's two triangles (area 0.25 each) and the
    # 0.5 x 0.5 light's two (area 0.125 each)
    nee = tsc.tri_nee_pdf_area.numpy()
    np.testing.assert_allclose(nee[2:4], 0.25 * 0.5 / 0.25, rtol=1e-6)
    np.testing.assert_allclose(nee[4:6], 0.25 * 0.5 / 0.125, rtol=1e-6)
    assert (nee[:2] == 0).all()
    np.testing.assert_array_equal(tsc.sph_emitter.numpy(), [1])


def test_mixed_lights_sample_direct_matches_jax(mixed):
    (jsc, jst), (tsc, tst) = mixed
    rs = np.random.default_rng(14)
    p = rs.uniform(-1.0, 1.5, (2048, 3)).astype(np.float32)
    u3 = rs.random((2048, 3)).astype(np.float32)
    js = jem.sample_direct(jsc, jst, jnp.asarray(p), jnp.asarray(u3))
    ts = tem.sample_direct(tsc, tst, torch.from_numpy(p), torch.from_numpy(u3))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    for f in ("d", "dist", "pdf_sa", "radiance"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        np.testing.assert_allclose(a, b, **TOL, err_msg=f)
    # every light was drawn
    rad = ts.radiance.numpy()
    for want in ((3.0, 3.0, 3.0), (7.0, 6.0, 5.0), (1.0, 2.0, 3.0),
                 (0.1, 0.2, 0.3)):
        assert (rad == np.float32(want)).all(axis=1).sum() > 300, want


# --- the analytic anchor ---------------------------------------------------

def test_nee_irradiance_from_a_sphere_light_is_analytic():
    """Port only: the irradiance at a point whose normal faces a sphere light
    of radiance L, radius r, at distance d is pi L (r/d)^2 (the cone lies in
    the upper hemisphere). The NEE estimate, the mean of
    L cos(theta) / pdf_sa over 2^16 cone samples, holds it within 0.5%."""
    L, r, dist = 5.0, 0.3, 2.0
    b = tscene.SceneBuilder()
    b.add_sphere((0.0, 0.0, dist), r, b.add_material(),
                 emitter_radiance=(L, L, L))
    scene, static = b.build(device="cpu")
    n = 1 << 16
    u3 = torch.from_numpy(np.random.default_rng(15).random((n, 3)).astype(
        np.float32))
    ds = tem.sample_direct(scene, static, torch.zeros(n, 3), u3)
    assert bool(ds.valid.all())
    est = (ds.radiance[:, 0] * torch.clamp(ds.d[:, 2], min=0.0)
           / ds.pdf_sa).mean().item()
    np.testing.assert_allclose(est, math.pi * L * (r / dist) ** 2, rtol=5e-3)
    # every sample hits the sphere at the distance it reports
    hit = ds.d * ds.dist[:, None] - torch.tensor([0.0, 0.0, dist])
    np.testing.assert_allclose(hit.norm(dim=1).numpy(), r, rtol=1e-3)


# --- renders against the JAX package ---------------------------------------

RENDERS = {
    # name: (plastic scene, integrator)
    "plastic_path": (True, "path"),
    "veach_direct": (False, "direct"),
}


@pytest.fixture(scope="module")
def renders(veach):
    """veach_mis_plastic through the path tracer at the fixture's depth 3 and
    veach_mis through the direct integrator (one emitter and one BSDF
    sample), 8x8, 2 spp, box filter, seed 0, through both packages."""
    out = {}
    for name, (plastic, integ) in RENDERS.items():
        (jsc, jst, jse), (tsc, tst, tse) = veach[plastic]
        jcfg = (jcommon.IntegratorConfig(type=jcommon.PATH, max_depth=3)
                if integ == "path" else
                jcommon.IntegratorConfig(type=jcommon.DIRECT))
        tcfg = tcommon.IntegratorConfig(type=jcfg.type,
                                        max_depth=jcfg.max_depth)
        st = dict(width=W, height=H, spp=SPP, spp_per_pass=SPP,
                  filter_type=0)
        ref, n_ref = jax_render(jsc, jst, jse, jcfg, japi.RenderSettings(**st))
        img, n = tapi.render(tsc, tst, tse, tcfg, tapi.RenderSettings(**st),
                             device="cpu", with_stats=True)
        out[name] = (ref, img.numpy(), n_ref, n)
    return out


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_means_match_jax(renders, name):
    ref, img, _, _ = renders[name]
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=1e-3)


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_pixels_match_jax(renders, name):
    ref, img, _, _ = renders[name]
    close = np.isclose(img, ref, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_ray_counts_match_jax(renders, name):
    _, img, n_ref, n = renders[name]
    assert n == n_ref
    assert n > img.shape[0] * img.shape[1]
