"""Port parity, single-layer BSDFs: the conductor, rough dielectric (both
microfacet distributions), thin dielectric, rough diffuse, Phong, Ward,
diffuse transmitter, Hanrahan-Krueger and null lobes of mitsuba_tpu_torch
against the JAX package on the same numpy inputs, on the CPU; and the
port's chi-square harness (``utils/chi2.py``) on every lobe's sampler.

Tolerances:
  * eval and pdf: allclose rtol 1e-5 / atol 1e-6 (float32 elementwise, the
    same order of operations; the rough dielectric's transmission near total
    internal reflection amplifies an ulp of F in 1 - F, which the atol
    covers). Their nonzero masks are equal above 1e-30: XLA's CPU backend
    flushes denormal intermediates to zero (Beckmann's exp(-tan^2 / alpha^2)
    underflows), PyTorch keeps them, and their products land near 1e-37;
  * sample: is_delta, the live mask (pdf > 0) and eta exactly; wo, weight
    and pdf on live lanes at rtol 3e-5 / atol 1e-6 (the samplers' atan2,
    cos, sin, log, pow and erf inverse differ by an ulp or two between XLA
    and PyTorch; through a refraction and Ward's Gaussian exponent that
    reaches 1.6e-5 relative, measured), except on ill-conditioned lanes,
    which get rtol 2e-4 / atol 1e-5: where wi or wo
    grazes the surface (|z| < 0.1, where the warps' sqrt(1 - x^2 - y^2) and
    the microfacet samplers' trigonometry, rounded within an ulp of each
    other by XLA and PyTorch, grow by 1/z), and the HK transmission where
    mu_i and mu_o are within 0.01 (a difference of exponentials over their
    difference). Measured: at most 2.9e-4 relative there, on components
    within the atol;
  * chi-square: the JAX test's 300,000 samples and significance 5e-4
    (tests/test_bsdf.py:81-137); the port's harness and the JAX package's
    give the same statistic and degrees of freedom on the same sampler, and
    p-values within 1e-4 relative (the JAX harness takes the incomplete
    gamma in float32).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.utils import chi2 as jchi2
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import microfacet as tmf
from mitsuba_tpu_torch.utils import chi2 as tchi2

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

R = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
SAMPLE_TOL = dict(rtol=3e-5, atol=1e-6)
ILL, ILL_TOL = 0.1, dict(rtol=2e-4, atol=1e-5)
HK_SAME_MU = 0.01
TINY = 1e-30
B = tbsdf

# the nine single-layer types of this slice, the rough dielectric with
# each distribution, and a batch that mixes them lane by lane
CASES = {
    "conductor": ((B.CONDUCTOR,), tmf.BECKMANN),
    "roughdielectric-beckmann": ((B.ROUGH_DIELECTRIC,), tmf.BECKMANN),
    "roughdielectric-ggx": ((B.ROUGH_DIELECTRIC,), tmf.GGX),
    "thindielectric": ((B.THIN_DIELECTRIC,), tmf.BECKMANN),
    "roughdiffuse": ((B.ROUGH_DIFFUSE,), tmf.BECKMANN),
    "phong": ((B.PHONG,), tmf.BECKMANN),
    "ward": ((B.WARD,), tmf.BECKMANN),
    "difftrans": ((B.DIFFTRANS,), tmf.BECKMANN),
    "hk": ((B.HK,), tmf.BECKMANN),
    "null": ((B.NULL,), tmf.BECKMANN),
    "mixed": ((B.CONDUCTOR, B.ROUGH_DIELECTRIC, B.THIN_DIELECTRIC,
               B.ROUGH_DIFFUSE, B.PHONG, B.WARD, B.DIFFTRANS, B.HK, B.NULL),
              None),
}
DELTA = (B.CONDUCTOR, B.THIN_DIELECTRIC, B.NULL)


def _uniform_sphere(rs, n):
    z = rs.uniform(-1.0, 1.0, n)
    phi = rs.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)


def _directions(rs):
    """R unit directions: uniform over the sphere (half below the surface),
    a sixteenth of them near grazing (|z| in [1e-3, 0.05], either side) and
    eight exactly in the surface (z = 0)."""
    d = _uniform_sphere(rs, R)
    g = rs.choice(R, R // 16, replace=False)
    z = rs.uniform(1e-3, 0.05, len(g)) * rs.choice([-1.0, 1.0], len(g))
    phi = rs.uniform(0.0, 2.0 * np.pi, len(g))
    s = np.sqrt(1.0 - z * z)
    d[g] = np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)
    phi = rs.uniform(0.0, 2.0 * np.pi, 8)
    d[g[:8]] = np.stack([np.cos(phi), np.sin(phi), np.zeros(8)], -1)
    return d.astype(np.float32)


def _inputs(name):
    """Seeded per-lane parameters of a case, its directions and uniforms:
    every column random in the range its types read (k as a conductor's
    absorption and as HK's sigma_t), two-sided on half the lanes."""
    types, dist = CASES[name]
    rs = np.random.default_rng(zlib.crc32(name.encode()))
    f32 = np.float32
    return dict(
        type=rs.choice(np.asarray(types, np.int32), R),
        dist=(np.full(R, dist, np.int32) if dist is not None
              else rs.integers(0, 2, R).astype(np.int32)),
        albedo=rs.uniform(0.0, 1.0, (R, 3)).astype(f32),
        spec_refl=rs.uniform(0.2, 1.0, (R, 3)).astype(f32),
        spec_trans=rs.uniform(0.2, 1.0, (R, 3)).astype(f32),
        eta_c=rs.uniform(0.1, 2.0, (R, 3)).astype(f32),
        k_c=rs.uniform(0.5, 4.0, (R, 3)).astype(f32),
        eta_s=rs.uniform(1.2, 1.8, R).astype(f32),
        alpha=rs.uniform(0.05, 0.6, (R, 2)).astype(f32),
        twosided=rs.random(R) < 0.5,
        hk_thickness=rs.uniform(0.1, 2.0, R).astype(f32),
        hk_g=rs.uniform(-0.8, 0.8, R).astype(f32),
        wi=_directions(rs), wo=_directions(rs),
        u_lobe=rs.random(R).astype(f32), u2=rs.random((R, 2)).astype(f32))


def _jax_locals(a):
    n = len(a["type"])
    z1 = jnp.zeros(n)
    return jbsdf.BsdfLocals(
        type=jnp.asarray(a["type"]), dist=jnp.asarray(a["dist"]),
        albedo=jnp.asarray(a["albedo"]), spec_refl=jnp.asarray(a["spec_refl"]),
        spec_trans=jnp.asarray(a["spec_trans"]),
        eta_s=jnp.asarray(a["eta_s"]), eta_c=jnp.asarray(a["eta_c"]),
        k_c=jnp.asarray(a["k_c"]), alpha=jnp.asarray(a["alpha"]),
        nonlinear=jnp.zeros(n, bool), twosided=jnp.asarray(a["twosided"]),
        opacity=jnp.ones(n), blend_w=z1,
        hk_thickness=jnp.asarray(a["hk_thickness"]),
        hk_g=jnp.asarray(a["hk_g"]), rt_coef=jnp.zeros((n, 6)), rt_fdr=z1,
        iw_par=jnp.zeros((n, 13)), iw_ks=jnp.zeros((n, 3)))


def _port_locals(a):
    t = torch.from_numpy
    return tbsdf.BsdfLocals(
        type=t(a["type"]), dist=t(a["dist"]), albedo=t(a["albedo"]),
        spec_refl=t(a["spec_refl"]), eta_c=t(a["eta_c"]), k_c=t(a["k_c"]),
        alpha=t(a["alpha"]), twosided=t(a["twosided"]),
        spec_trans=t(a["spec_trans"]), eta_s=t(a["eta_s"]),
        hk_thickness=t(a["hk_thickness"]), hk_g=t(a["hk_g"]))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    a = _inputs(request.param)
    return request.param, a, _jax_locals(a), _port_locals(a), \
        CASES[request.param][0]


def _nonzero(x):
    return np.abs(x) >= TINY


@pytest.mark.parametrize("fn", ["eval", "pdf"])
def test_eval_and_pdf_match_jax(case, fn):
    name, a, jbl, tbl, types = case
    ref = np.asarray(getattr(jbsdf, fn)(jbl, jnp.asarray(a["wi"]),
                                        jnp.asarray(a["wo"]),
                                        active_types=types))
    out = getattr(tbsdf, fn)(tbl, torch.from_numpy(a["wi"]),
                             torch.from_numpy(a["wo"]),
                             active_types=types).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(_nonzero(out), _nonzero(ref))
    live = _nonzero(ref) if ref.ndim == 1 else _nonzero(ref).any(axis=-1)
    if set(types) <= set(DELTA):
        assert not live.any()  # a delta lobe is 0 in eval and pdf
    else:
        assert live.sum() > R // 4


def _ill_conditioned(a, js):
    """Lanes where the two packages' last-bit differences grow (see the
    module docstring)."""
    wo = np.asarray(js.wo)
    ill = (np.abs(a["wi"][:, 2]) < ILL) | (np.abs(wo[:, 2]) < ILL)
    mu_i, mu_o = np.abs(a["wi"][:, 2]), np.abs(wo[:, 2])
    hk_t = ((a["type"] == B.HK) & (a["wi"][:, 2] * wo[:, 2] < 0)
            & (np.abs(mu_i - mu_o) < HK_SAME_MU))
    return ill | hk_t


def test_sample_matches_jax(case):
    name, a, jbl, tbl, types = case
    js = jbsdf.sample(jbl, jnp.asarray(a["wi"]), jnp.asarray(a["u_lobe"]),
                      jnp.asarray(a["u2"]), active_types=types)
    ts = tbsdf.sample(tbl, torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=types)
    np.testing.assert_array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    np.testing.assert_array_equal(ts.eta.numpy(), np.asarray(js.eta))
    live = np.asarray(js.pdf) > 0
    np.testing.assert_array_equal(ts.pdf.numpy() > 0, live)
    ill = _ill_conditioned(a, js)
    for lanes, tol in ((live & ~ill, SAMPLE_TOL), (live & ill, ILL_TOL)):
        for f in ("wo", "weight", "pdf"):
            np.testing.assert_allclose(getattr(ts, f).numpy()[lanes],
                                       np.asarray(getattr(js, f))[lanes],
                                       **tol, err_msg=f)
    np.testing.assert_array_equal(ts.weight.numpy()[~live], 0.0)
    assert live.sum() > R // 2 and (live & ~ill).sum() > live.sum() // 2


def test_delta_flags_by_type(case):
    """The conductor, thin dielectric and null lobes are deltas on every
    lane, the smooth lobes on none; HK picks its unscattered transmission
    per lane, so is_delta varies within the one type."""
    name, a, _, tbl, types = case
    ts = tbsdf.sample(tbl, torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=types)
    delta = ts.is_delta.numpy()
    for t in types:
        d = delta[a["type"] == t]
        if t in DELTA:
            assert d.all()
        elif t == B.HK:
            assert 0 < d.sum() < len(d)
        else:
            assert not d.any()


def test_pass_through_lobes_keep_the_direction():
    """null always, the thin dielectric and HK when they transmit: wo = -wi
    with eta 1, so a path goes on along the same line."""
    a = _inputs("mixed")
    ts = tbsdf.sample(_port_locals(a), torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=CASES["mixed"][0])
    wo, wi = ts.wo.numpy(), a["wi"]
    through = np.all(wo == -wi, axis=-1)
    assert through[a["type"] == B.NULL].all()
    for t in (B.THIN_DIELECTRIC, B.HK):
        sel = (a["type"] == t) & ts.is_delta.numpy() & (wi[:, 2] * wo[:, 2] < 0)
        assert sel.sum() > 20 and through[sel].all()
    assert (ts.eta.numpy()[through] == 1.0).all()


@pytest.mark.parametrize("name", ["difftrans", "hk"])
def test_sign_of_a_tangent_wi_is_zero(name):
    """HK's and difftrans' sign(wi.z) is 0 for wi in the surface, as
    jnp.sign's: the sampled direction collapses onto the surface in both
    packages."""
    assert torch.sign(torch.tensor([0.0, -0.0])).tolist() == [0.0, 0.0]
    a = _inputs(name)
    flat = a["wi"][:, 2] == 0.0
    assert flat.sum() == 8
    types = CASES[name][0]
    ts = tbsdf.sample(_port_locals(a), torch.from_numpy(a["wi"]),
                      torch.from_numpy(a["u_lobe"]), torch.from_numpy(a["u2"]),
                      active_types=types)
    js = jbsdf.sample(_jax_locals(a), jnp.asarray(a["wi"]),
                      jnp.asarray(a["u_lobe"]), jnp.asarray(a["u2"]),
                      active_types=types)
    np.testing.assert_array_equal(ts.wo.numpy()[flat, 2], 0.0)
    np.testing.assert_array_equal(np.asarray(js.wo)[flat, 2], 0.0)


# --- the chi-square harness ------------------------------------------------

N = 300_000
# tests/test_bsdf.py:81-109's configurations of this slice's types, with
# the rough dielectric's Beckmann twin: name, material, theta of wi in
# degrees
CHI2_CONFIGS = [
    ("roughdiffuse_45", dict(type=B.ROUGH_DIFFUSE, alpha=(0.4, 0.4)), 45.0),
    ("roughdielectric_out", dict(type=B.ROUGH_DIELECTRIC, dist=tmf.GGX,
                                 eta=(1.5, 1.5, 1.5), alpha=(0.3, 0.3)), 30.0),
    ("roughdielectric_in", dict(type=B.ROUGH_DIELECTRIC, dist=tmf.GGX,
                                eta=(1.5, 1.5, 1.5), alpha=(0.3, 0.3)), 150.0),
    ("roughdielectric_beck_out", dict(type=B.ROUGH_DIELECTRIC,
                                      dist=tmf.BECKMANN, eta=(1.5, 1.5, 1.5),
                                      alpha=(0.3, 0.3)), 30.0),
    ("phong_30", dict(type=B.PHONG, alpha=(0.2, 0.2),
                      albedo=(0.3, 0.3, 0.3), spec_refl=(0.4, 0.4, 0.4)), 30.0),
    ("ward_30", dict(type=B.WARD, alpha=(0.2, 0.4),
                     albedo=(0.3, 0.3, 0.3), spec_refl=(0.4, 0.4, 0.4)), 30.0),
    ("difftrans_30", dict(type=B.DIFFTRANS, spec_trans=(0.7, 0.6, 0.5)), 30.0),
    ("hk_40", dict(type=B.HK, albedo=(0.6, 0.6, 0.6), k=(1.5, 1.5, 1.5),
                   hk_thickness=0.4, hk_g=0.3), 40.0),
]


def make_locals(n, **kw):
    """The JAX test's make_locals, for the port: every lane one material."""
    d = dict(type=B.DIFFUSE, dist=tmf.GGX, albedo=(0.6, 0.4, 0.25),
             spec_refl=(1.0, 1.0, 1.0), spec_trans=(1.0, 1.0, 1.0),
             eta=(1.5, 1.5, 1.5), k=(0.0, 0.0, 0.0), alpha=(0.3, 0.3),
             hk_thickness=1.0, hk_g=0.0)
    d.update(kw)

    def full(v, *shape):
        return torch.tensor(v, dtype=torch.float32).expand(n, *shape)

    return tbsdf.BsdfLocals(
        type=torch.full((n,), d["type"], dtype=torch.int32),
        dist=torch.full((n,), d["dist"], dtype=torch.int32),
        albedo=full(d["albedo"], 3), spec_refl=full(d["spec_refl"], 3),
        eta_c=full(d["eta"], 3), k_c=full(d["k"], 3),
        alpha=full(d["alpha"], 2),
        twosided=torch.zeros(n, dtype=torch.bool),
        spec_trans=full(d["spec_trans"], 3), eta_s=full(d["eta"][0]),
        hk_thickness=full(d["hk_thickness"]),
        hk_g=full(d["hk_g"]))


def _wi(theta_deg, n):
    t = np.deg2rad(theta_deg)
    return torch.tensor([np.sin(t), 0.0, np.cos(t)],
                        dtype=torch.float32).expand(n, 3)


def _port_sampler(name, mat, theta):
    types = (mat["type"],)

    def sample_fn(n):
        u = trng.uniform4(zlib.crc32(name.encode()) % 1000,
                          torch.arange(n, dtype=torch.int32), 0, 0)
        bs = tbsdf.sample(make_locals(n, **mat), _wi(theta, n), u[..., 0],
                          u[..., 1:3], active_types=types)
        ok = (bs.pdf > 0) & ~bs.is_delta
        return torch.where(ok[:, None], bs.wo, 0.0)

    def pdf_fn(d):
        n = d.shape[0]
        return tbsdf.pdf(make_locals(n, **mat), _wi(theta, n), d,
                         active_types=types)

    return sample_fn, pdf_fn


@pytest.mark.parametrize("name,mat,theta", CHI2_CONFIGS,
                         ids=[c[0] for c in CHI2_CONFIGS])
def test_bsdf_chi2(name, mat, theta):
    """Each lobe's sample draws from its pdf (the port's harness)."""
    sample_fn, pdf_fn = _port_sampler(name, mat, theta)
    ok, pval, stat, dof, info = tchi2.chi2_test(sample_fn, pdf_fn,
                                                n_samples=N,
                                                significance=0.0005)
    assert ok, f"{name}: {info}"


def test_chi2_harness_matches_jax():
    """The two harnesses on one sampler (the port's HK lobe, its samples
    fixed as numpy): the same cells, pooling and statistic."""
    sample_fn, pdf_fn = _port_sampler(*CHI2_CONFIGS[-1])
    d = sample_fn(N).numpy()

    def pdf_np(x):
        return pdf_fn(torch.tensor(np.asarray(x, np.float32))).numpy()

    ours = tchi2.chi2_test(lambda n: d, pdf_np, n_samples=N,
                           significance=0.0005)
    ref = jchi2.chi2_test(lambda n: d, pdf_np, n_samples=N,
                          significance=0.0005)
    assert ours[0] and ref[0]
    assert ours[2] == ref[2] and ours[3] == ref[3]
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-4)


def test_chi2_rejects_a_wrong_pdf():
    """The harness fails a sampler held against another lobe's density:
    Phong's samples (exponent 48) against the density of exponent 23."""
    name, mat, theta = CHI2_CONFIGS[4]
    sample_fn, _ = _port_sampler(name, mat, theta)
    wrong = dict(mat, alpha=(0.2 * np.sqrt(2.0),) * 2)
    _, pdf_fn = _port_sampler(name, wrong, theta)
    ok, _, _, _, info = tchi2.chi2_test(sample_fn, pdf_fn, n_samples=N,
                                        significance=0.0005)
    assert not ok, info
