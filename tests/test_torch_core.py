"""Port parity, core layer: the PyTorch port (mitsuba_tpu_torch.core) against
the JAX package on the same numpy inputs, on the CPU.

Tolerances: the RNG must agree bit for bit (every image comparison rests on
it); transforms are the same numpy code, so exact; float32 tensor math is
held to rtol 1e-6 / atol 1e-6, a few float32 ulps, since XLA and PyTorch may
round transcendental functions and sums differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import frame as jframe
from mitsuba_tpu.core import math as jm
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.core import transform as jtransform
from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu_torch.core import frame as tframe
from mitsuba_tpu_torch.core import math as tm
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core import transform as ttransform
from mitsuba_tpu_torch.core import warp as twarp

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def counters():
    """100k (seed, pixel, sample, dim) tuples, int32 as the renderer passes
    them, including negative values (read as uint32)."""
    rs = np.random.default_rng(1)
    n = 100_000
    return tuple(rs.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
                 for _ in range(4))


def test_pcg4d_bit_exact(counters):
    v = np.stack(counters, axis=-1)
    ref = np.asarray(jrng.pcg4d(jnp.asarray(v)))
    out = trng.pcg4d(_t(v)).numpy()
    np.testing.assert_array_equal(out.astype(np.uint32), ref)


@pytest.mark.parametrize("fn", ["uniform1", "uniform2", "uniform4"])
def test_uniforms_bit_exact(counters, fn):
    ref = np.asarray(getattr(jrng, fn)(*(jnp.asarray(c) for c in counters)))
    out = getattr(trng, fn)(*(_t(c) for c in counters)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


def test_uniforms_broadcast_scalars():
    """Python-int seed/sample/dim broadcast against a pixel tensor, as the
    integrator calls them."""
    pix = np.arange(5000, dtype=np.int32)
    ref = np.asarray(jrng.uniform4(3, jnp.asarray(pix), 7, 12))
    out = trng.uniform4(3, _t(pix), 7, 12).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


def _vecs(seed, n=4096, unit=False):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    if unit:
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


@pytest.mark.parametrize("name", ["dot", "cross", "length", "normalize"])
def test_vector_math(name):
    a, b = _vecs(2), _vecs(3)
    args = (a,) if name in ("length", "normalize") else (a, b)
    ref = np.asarray(getattr(jm, name)(*(jnp.asarray(x) for x in args)))
    out = getattr(tm, name)(*(_t(x) for x in args)).numpy()
    np.testing.assert_allclose(out, ref, **FLOAT_TOL)


def test_safe_div_semantics():
    a = np.array([1.0, 2.0, -3.0, 4.0, 0.0], np.float32)
    b = np.array([2.0, 0.0, 1e-21, -1e-19, 0.0], np.float32)
    ref = np.asarray(jm.safe_div(jnp.asarray(a), jnp.asarray(b)))
    out = tm.safe_div(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_coordinate_system_and_spherical():
    n = _vecs(4, unit=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    s_ref, t_ref = (np.asarray(x) for x in jm.coordinate_system(jnp.asarray(n)))
    s, t = (x.numpy() for x in tm.coordinate_system(_t(n)))
    np.testing.assert_allclose(s, s_ref, **FLOAT_TOL)
    np.testing.assert_allclose(t, t_ref, **FLOAT_TOL)
    th_ref, ph_ref = (np.asarray(x) for x in jm.spherical_coordinates(jnp.asarray(n)))
    th, ph = (x.numpy() for x in tm.spherical_coordinates(_t(n)))
    np.testing.assert_allclose(th, th_ref, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ph, ph_ref, rtol=1e-6, atol=1e-5)


def test_frame_roundtrip_matches_jax():
    n, v = _vecs(5, unit=True), _vecs(6)
    jf = jframe.Frame.from_normal(jnp.asarray(n))
    tf = tframe.Frame.from_normal(_t(n))
    loc_ref = np.asarray(jf.to_local(jnp.asarray(v)))
    loc = tf.to_local(_t(v))
    np.testing.assert_allclose(loc.numpy(), loc_ref, **FLOAT_TOL)
    np.testing.assert_allclose(tf.to_world(loc).numpy(),
                               np.asarray(jf.to_world(jnp.asarray(loc_ref))),
                               **FLOAT_TOL)
    np.testing.assert_array_equal(tframe.cos_theta(loc).numpy(), loc.numpy()[:, 2])


@pytest.mark.parametrize("name", ["square_to_cosine_hemisphere",
                                  "square_to_uniform_disk_concentric",
                                  "square_to_uniform_triangle"])
def test_warps(name):
    u = np.random.default_rng(7).random((4096, 2)).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.9]]  # the disk's center, a corner
    ref = np.asarray(getattr(jwarp, name)(jnp.asarray(u)))
    out = getattr(twarp, name)(_t(u)).numpy()
    np.testing.assert_allclose(out, ref, **FLOAT_TOL)


def test_cosine_hemisphere_pdf():
    d = _vecs(8, unit=True)
    ref = np.asarray(jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(d)))
    out = twarp.square_to_cosine_hemisphere_pdf(_t(d)).numpy()
    np.testing.assert_allclose(out, ref, **FLOAT_TOL)


def test_transform_copy_is_exact():
    J, T = jtransform.Transform, ttransform.Transform
    pairs = [
        (J.look_at([0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0]),
         T.look_at([0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0])),
        (J.translate([1, 2, 3]) * J.rotate([0, 1, 0], 16.5) * J.scale([0.1, 0.3, 0.2]),
         T.translate([1, 2, 3]) * T.rotate([0, 1, 0], 16.5) * T.scale([0.1, 0.3, 0.2])),
    ]
    pts = _vecs(9, n=16).astype(np.float64)
    for a, b in pairs:
        np.testing.assert_array_equal(b.m, a.m)
        np.testing.assert_array_equal(b.inverse().m, a.inverse().m)
        np.testing.assert_array_equal(b.apply_point(pts), a.apply_point(pts))
