"""Port parity, microfacet layer: the Fresnel and reflection helpers, both
microfacet distributions and the rough conductor of mitsuba_tpu_torch
against the JAX package on the same numpy inputs, on the CPU, in value and
in gradient (``jax.vjp`` against ``torch.autograd.grad`` with one random
cotangent per output).

Inputs are random from a seed, with grazing directions (|cos| down to 1e-5)
and directions below the horizon, isotropic and anisotropic roughness.
Gradients matter as much as values: the rough BSDFs evaluate both
distributions on every lane and select one, so a non-finite derivative in
the branch a lane does not select would reach the selected one as 0 x inf.

The JAX side runs under ``scripts/jax_train_ref.py``'s
``gradient_safe_math``: its ``safe_sqrt``, ``safe_div`` and ``sin_theta``
with the port's derivatives, the same values. The JAX package's own
derivatives turn to NaN at sqrt(0), at sin theta = 0 and at quotients by
1e-20 < |b| < 5.4e-20, in branches that a ``where`` drops, and the last
three tests hold that finding.

Tolerances: values rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 /
atol 1e-5 relative to the largest gradient of the output: XLA and PyTorch
round exp, log, tan, atan and the trigonometric functions to within an ulp
or two of each other, and a gradient chains a few dozen such roundings.
The first 8 lanes of every direction are grazing (|cos| <= 2e-3), where
float32 is ill-conditioned: there, values and gradients are held to rtol
5e-2 / atol 1e-3 of the output's scale. At cos theta = 1e-5 the port's and
the JAX package's float32 derivatives of sample_visible's pdf by wi.z
differ by 2.8% and lie 5% and 8% from the float64 value (-0.1361,
-0.1400 against -0.1291). Booleans are exact.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import math as jm
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import microfacet as jmf
from mitsuba_tpu_torch.core import math as tm
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import microfacet as tmf

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import jax_train_ref  # noqa: E402

R = 512
VTOL = dict(rtol=1e-5, atol=1e-6)
GRTOL, GATOL = 1e-4, 1e-5
GRAZING = 8          # the first lanes of _dirs
GRAZING_TOL = dict(rtol=5e-2, atol=1e-3)
DISTS = {"beckmann": jmf.BECKMANN, "ggx": jmf.GGX}


def _dirs(rs, n, zlo, zhi):
    """n unit vectors with cos theta uniform in [zlo, zhi], a few of them
    grazing (|z| = 1e-3, 1e-5), in float32."""
    z = rs.uniform(zlo, zhi, n)
    z[:8] = np.clip(np.array([1e-3, -1e-3, 1e-5, -1e-5, 1e-3, 1e-5, 2e-3,
                              -2e-3]), zlo, zhi)
    phi = rs.uniform(0.0, 2.0 * np.pi, n)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    v = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.default_rng(11)
    au = rs.uniform(0.05, 0.8, R).astype(np.float32)
    av = au.copy()
    av[R // 2:] = rs.uniform(0.05, 0.8, R - R // 2)  # half anisotropic
    return dict(
        au=au, av=av,
        w_any=_dirs(rs, R, -1.0, 0.999),   # includes below-horizon lanes
        w_up=_dirs(rs, R, 1e-5, 0.999),
        mh=_dirs(rs, R, -0.3, 0.999),
        u2=rs.uniform(0.0, 1.0 - 2 ** -24, (R, 2)).astype(np.float32),
        cos_i=np.concatenate([rs.uniform(-1.0, 1.0, R - 4),
                              [1e-5, -1e-5, 1.0, 0.0]]).astype(np.float32),
        eta=rs.uniform(0.1, 2.5, (R, 3)).astype(np.float32),
        k=rs.uniform(0.0, 5.0, (R, 3)).astype(np.float32),
        cot=[rs.standard_normal((R, 3)).astype(np.float32) for _ in range(3)],
    )


def _cotangent(inputs, i, shape):
    c = inputs["cot"][i]
    return c[..., 0] if len(shape) == 1 else c[:, :shape[-1]]


def _parity(inputs, jfn, tfn, args, diff):
    """Values of jfn(*args) and tfn(*args), and their gradients with respect
    to the arguments named in ``diff``, with one cotangent per output."""
    jargs = {k: jnp.asarray(v) for k, v in args.items()}

    def jf(*dv):
        return jfn(**dict(jargs, **dict(zip(diff, dv))))

    with jax_train_ref.gradient_safe_math():
        jout, vjp = jax.vjp(jf, *(jargs[k] for k in diff))
        jout = jout if isinstance(jout, tuple) else (jout,)
        cots = [_cotangent(inputs, i, o.shape) for i, o in enumerate(jout)]
        jgrads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                     else jnp.asarray(cots[0]))

    targs = {k: torch.tensor(v, requires_grad=k in diff)
             for k, v in args.items()}
    tout = tfn(**targs)
    tout = tout if isinstance(tout, tuple) else (tout,)
    for i, (a, b) in enumerate(zip(tout, jout)):
        _close(a.detach().numpy(), np.asarray(b), f"output {i}", **VTOL)
    tgrads = torch.autograd.grad(tout, [targs[k] for k in diff],
                                 grad_outputs=[torch.from_numpy(c) for c in cots],
                                 allow_unused=True)
    for name, a, b in zip(diff, tgrads, jgrads):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        assert np.isfinite(a).all(), f"d/d{name}: non-finite port gradient"
        assert np.isfinite(b).all(), f"d/d{name}: non-finite JAX gradient"
        _close(a, b, f"d/d{name}", rtol=GRTOL,
               atol=GATOL * max(np.abs(b).max(), 1.0))


def _close(a, b, what, rtol, atol):
    """The lanes past the grazing ones at (rtol, atol); the grazing ones at
    GRAZING_TOL of the output's scale."""
    np.testing.assert_allclose(a[GRAZING:], b[GRAZING:], rtol=rtol, atol=atol,
                               err_msg=what)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a[:GRAZING], b[:GRAZING],
                               rtol=GRAZING_TOL["rtol"],
                               atol=GRAZING_TOL["atol"] * scale,
                               err_msg=f"{what}, grazing lanes")


def test_fresnel_conductor(inputs):
    _parity(inputs, jm.fresnel_conductor, tm.fresnel_conductor,
            dict(cos_i=inputs["cos_i"], eta=inputs["eta"], k=inputs["k"]),
            ("cos_i", "eta", "k"))


def test_reflect(inputs):
    _parity(inputs, jm.reflect, tm.reflect,
            dict(wi=inputs["w_any"], n=inputs["mh"]), ("wi", "n"))


@pytest.mark.parametrize("dist", DISTS)
def test_eval_d(inputs, dist):
    d = DISTS[dist]
    _parity(inputs, lambda **a: jmf.eval_d(d, **a),
            lambda **a: tmf.eval_d(d, **a),
            dict(alpha_u=inputs["au"], alpha_v=inputs["av"], mh=inputs["mh"]),
            ("alpha_u", "alpha_v", "mh"))


@pytest.mark.parametrize("dist", DISTS)
def test_smith_g1(inputs, dist):
    d = DISTS[dist]
    _parity(inputs, lambda **a: jmf.smith_g1(d, **a),
            lambda **a: tmf.smith_g1(d, **a),
            dict(alpha_u=inputs["au"], alpha_v=inputs["av"], w=inputs["w_any"],
                 mh=inputs["mh"]),
            ("alpha_u", "alpha_v", "w", "mh"))


@pytest.mark.parametrize("dist", DISTS)
def test_sample_all_and_pdf_all(inputs, dist):
    d = DISTS[dist]
    args = dict(alpha_u=inputs["au"], alpha_v=inputs["av"])
    _parity(inputs, lambda **a: jmf.sample_all(d, u2=jnp.asarray(inputs["u2"]), **a),
            lambda **a: tmf.sample_all(d, u2=torch.from_numpy(inputs["u2"]), **a),
            args, ("alpha_u", "alpha_v"))
    _parity(inputs, lambda **a: jmf.pdf_all(d, **a),
            lambda **a: tmf.pdf_all(d, **a),
            dict(args, mh=inputs["mh"]), ("alpha_u", "alpha_v", "mh"))


def test_sample_visible(inputs):
    _parity(inputs, lambda **a: jmf.sample_visible(u2=jnp.asarray(inputs["u2"]), **a),
            lambda **a: tmf.sample_visible(u2=torch.from_numpy(inputs["u2"]), **a),
            dict(alpha_u=inputs["au"], alpha_v=inputs["av"], wi=inputs["w_up"]),
            ("alpha_u", "alpha_v", "wi"))


@pytest.mark.parametrize("dist", DISTS)
def test_pdf_visible(inputs, dist):
    d = DISTS[dist]
    _parity(inputs, lambda **a: jmf.pdf_visible(d, **a),
            lambda **a: tmf.pdf_visible(d, **a),
            dict(alpha_u=inputs["au"], alpha_v=inputs["av"], wi=inputs["w_any"],
                 mh=inputs["mh"]),
            ("alpha_u", "alpha_v", "wi", "mh"))


def _locals(inputs, alpha, albedo, jax_side: bool):
    """Mixed lanes: DIFFUSE and ROUGH_CONDUCTOR, Beckmann and GGX, one-sided
    and two-sided, with the JAX or the port's BsdfLocals."""
    rs = np.random.default_rng(5)
    typ = np.where(rs.random(R) < 0.75, jbsdf.ROUGH_CONDUCTOR,
                   jbsdf.DIFFUSE).astype(np.int32)
    dist = (rs.random(R) < 0.5).astype(np.int32)
    twosided = rs.random(R) < 0.3
    spec = rs.uniform(0.5, 1.0, (R, 3)).astype(np.float32)
    if not jax_side:
        t = torch.from_numpy
        return tbsdf.BsdfLocals(type=t(typ), dist=t(dist), albedo=albedo,
                                spec_refl=t(spec), eta_c=t(inputs["eta"]),
                                k_c=t(inputs["k"]), alpha=alpha,
                                twosided=t(twosided))
    z1, z3 = jnp.zeros(R), jnp.zeros((R, 3))
    return jbsdf.BsdfLocals(
        type=jnp.asarray(typ), dist=jnp.asarray(dist), albedo=albedo,
        spec_refl=jnp.asarray(spec), spec_trans=z3, eta_s=z1,
        eta_c=jnp.asarray(inputs["eta"]), k_c=jnp.asarray(inputs["k"]),
        alpha=alpha, nonlinear=jnp.zeros(R, bool),
        twosided=jnp.asarray(twosided), opacity=jnp.ones(R), blend_w=z1,
        hk_thickness=z1, hk_g=z1, rt_coef=jnp.zeros((R, 6)), rt_fdr=z1,
        iw_par=jnp.zeros((R, 13)), iw_ks=z3)


TYPES = (jbsdf.DIFFUSE, jbsdf.ROUGH_CONDUCTOR)


def _bsdf_args(inputs):
    rs = np.random.default_rng(6)
    return dict(alpha=np.stack([inputs["au"], inputs["av"]], axis=-1),
                albedo=rs.uniform(0.0, 1.0, (R, 3)).astype(np.float32),
                wi=inputs["w_any"], wo=inputs["mh"])


@pytest.mark.parametrize("fn", ["eval", "pdf"])
def test_rough_conductor_eval_pdf(inputs, fn):
    """eval and pdf of mixed lanes, through the per-lane type and
    distribution dispatch, on random directions: grazing, below the
    horizon, two-sided flips."""
    jf, tf = getattr(jbsdf, fn), getattr(tbsdf, fn)
    _parity(inputs,
            lambda alpha, albedo, wi, wo: jf(
                _locals(inputs, alpha, albedo, True), wi, wo, active_types=TYPES),
            lambda alpha, albedo, wi, wo: tf(
                _locals(inputs, alpha, albedo, False), wi, wo, active_types=TYPES),
            _bsdf_args(inputs), ("alpha", "albedo", "wi", "wo"))


def test_rough_conductor_sample(inputs):
    """sample of the same lanes: the sampled direction where the sample is
    live (pdf > 0; visible-normal sampling of a wi below the horizon, whose
    weight is 0, is ill-conditioned in float32 and unused), weight and pdf,
    and their gradients (the direction depends on alpha), then the flags."""
    args = _bsdf_args(inputs)
    del args["wo"]
    u_lobe, u2 = inputs["u2"][:, 0], inputs["u2"][::-1].copy()

    def jf(alpha, albedo, wi):
        s = jbsdf.sample(_locals(inputs, alpha, albedo, True), wi,
                         jnp.asarray(u_lobe), jnp.asarray(u2), active_types=TYPES)
        return jnp.where((s.pdf > 0)[..., None], s.wo, 0.0), s.weight, s.pdf

    def tf(alpha, albedo, wi):
        s = tbsdf.sample(_locals(inputs, alpha, albedo, False), wi,
                         torch.from_numpy(u_lobe), torch.from_numpy(u2),
                         active_types=TYPES)
        return torch.where((s.pdf > 0)[..., None], s.wo, 0.0), s.weight, s.pdf

    _parity(inputs, jf, tf, args, ("alpha", "albedo", "wi"))
    js = jbsdf.sample(_locals(inputs, jnp.asarray(args["alpha"]),
                              jnp.asarray(args["albedo"]), True),
                      jnp.asarray(args["wi"]), jnp.asarray(u_lobe),
                      jnp.asarray(u2), active_types=TYPES)
    ts = tbsdf.sample(_locals(inputs, torch.from_numpy(args["alpha"]),
                              torch.from_numpy(args["albedo"]), False),
                      torch.from_numpy(args["wi"]), torch.from_numpy(u_lobe),
                      torch.from_numpy(u2), active_types=TYPES)
    np.testing.assert_array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    np.testing.assert_array_equal(ts.eta.numpy(), np.asarray(js.eta))
    assert (ts.pdf > 0).sum() > R // 4  # the sampled lobes are mostly live


def test_safe_sqrt_gradient_is_finite_at_zero():
    """The port's safe_sqrt equals the JAX package's bit for bit, including
    0, negatives and NaN, but its gradient is 0 where the argument is <= 0.
    The JAX form's derivative there is inf, so a branch that a ``where``
    drops (a lane's unused microfacet distribution) turns the 0 cotangent
    into NaN: Beckmann's sample_all meets sqrt(1 - ct^2) = 0 for uniforms
    below about 6e-6, and with the JAX form the alpha gradient of bench's
    training step is NaN (scripts/jax_train_ref.py)."""
    x = np.array([0.0, -0.0, -1.0, 1e-30, 0.25, 2.0, np.nan, np.inf],
                 np.float32)
    ref = np.asarray(jm.safe_sqrt(jnp.asarray(x)))
    out = tm.safe_sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))

    def dropped(sqrt_fn, xx, where):
        return where(xx > 1.0, sqrt_fn(xx), 0.0 * xx)

    jg = jax.grad(lambda v: dropped(jm.safe_sqrt, v, jnp.where))(0.0)
    assert np.isnan(float(jg))
    xt = torch.zeros((), requires_grad=True)
    (tg,) = torch.autograd.grad(dropped(tm.safe_sqrt, xt, torch.where), xt)
    assert float(tg) == 0.0


def test_safe_div_gradient_is_finite_for_tiny_denominators():
    """A quotient 0 / b with 1e-20 < |b| < 5.4e-20 (Beckmann's D at
    cos theta near 1e-5, where exp(...) is 0): JAX differentiates it as
    -g x b^-2, which overflows, so the gradient is NaN; torch's
    -g x a / (b x b) is 0. The values agree."""
    b = np.float32(2e-20)
    ref = float(jm.safe_div(jnp.float32(0.0), jnp.float32(b)))
    assert float(tm.safe_div(torch.tensor(0.0), torch.tensor(b))) == ref == 0.0
    assert np.isnan(float(jax.grad(lambda v: jm.safe_div(0.0, v))(b)))
    bt = torch.tensor(b, requires_grad=True)
    (tg,) = torch.autograd.grad(tm.safe_div(torch.tensor(0.0), bt), bt)
    assert float(tg) == 0.0
    with jax_train_ref.gradient_safe_math():
        assert float(jax.grad(lambda v: jm.safe_div(0.0, v))(b)) == 0.0


def test_tan_theta_gradient_is_finite_on_the_normal():
    """smith_g1's tan theta of a direction on the normal (a sampled wo that
    rounds onto it): the JAX package's sin theta is sqrt(0), whose inf
    derivative times the dropped branch's 0 is NaN; the port's is 0."""
    from mitsuba_tpu.core import frame as jfr
    from mitsuba_tpu_torch.core import frame as tfr
    w = np.array([0.0, 0.0, 1.0], np.float32)

    def dropped(frame_mod, ww, where):
        t = frame_mod.tan_theta(ww)
        return where(t < 1e-9, 1.0 + 0.0 * t, t)

    jg = jax.grad(lambda v: dropped(jfr, v, jnp.where))(jnp.asarray(w))
    assert np.isnan(np.asarray(jg)).any()
    wt = torch.tensor(w, requires_grad=True)
    (tg,) = torch.autograd.grad(dropped(tfr, wt, torch.where), wt)
    assert torch.isfinite(tg).all()
    with jax_train_ref.gradient_safe_math():
        jg = jax.grad(lambda v: dropped(jfr, v, jnp.where))(jnp.asarray(w))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
