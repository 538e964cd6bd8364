"""Port parity for the samplers: ``core/qmc.py``, the Sobol' direction
numbers, ``core/rng.py``'s low-discrepancy modes and ``render/api.py``'s
sampler record and stratified pixel jitter, against the JAX package on the
CPU.

Tolerances: every value bit for bit. The JAX functions run eagerly here, one
XLA computation per operation, so their float32 digit sums are rounded
operation by operation as the port rounds them (inside a jitted render XLA
may contract them into FMAs; test_torch_header.py holds a radical-inverse
render to a tolerance instead).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import qmc as jqmc
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.render import api as japi
from mitsuba_tpu_torch.core import qmc as tqmc
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core.sobol_table import SOBOL_DIRECTIONS
from mitsuba_tpu_torch.render import api as tapi

RS = np.random.default_rng(2024)
# sample indices: the first ones, random ones, and the uint32 edges
INDICES = [0, 1, 2, 3, 15, 16, 255, 256, 2 ** 16 - 1, 2 ** 31 - 1,
           2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1] + \
    RS.integers(0, 2 ** 32, 24).tolist()
SCRAMBLE = RS.integers(0, 2 ** 32, (2, 16), dtype=np.uint64)
ROTATION = RS.random(16, dtype=np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_grid(fn, *scrambles):
    """A JAX qmc function over INDICES x the 16 streams, one call."""
    idx = jnp.asarray(np.asarray(INDICES, np.uint64).astype(np.uint32))[:, None]
    return np.asarray(fn(idx, *(jnp.asarray(s.astype(np.uint32))[None]
                                for s in scrambles)))


def _port_grid(fn, *scrambles):
    return np.stack([fn(i, *(torch.from_numpy(s.astype(np.int64))
                             for s in scrambles)).numpy() for i in INDICES])


def test_sobol_table_equals_the_jax_packages():
    np.testing.assert_array_equal(SOBOL_DIRECTIONS,
                                  jqmc.sobol_direction_numbers())
    assert SOBOL_DIRECTIONS.dtype == np.uint32


def test_faure_permutations_equal_the_jax_packages():
    np.testing.assert_array_equal(tqmc._FAURE, jqmc._FAURE)
    for b, row in zip(tqmc._PRIMES, tqmc._FAURE):
        assert sorted(row[:b]) == list(range(b))


def test_sobol02_matches_jax():
    ref = _jax_grid(jqmc.sobol02, SCRAMBLE[0], SCRAMBLE[1])
    out = _port_grid(tqmc.sobol02, SCRAMBLE[0], SCRAMBLE[1])
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_sobol02_rounds_to_one_as_the_jax_package_does():
    """A word of 2^32 - 128 or more converts to 2^32 in float32: u = 1.0 in
    both packages (the warps the integrators apply to it stay finite)."""
    zero = torch.tensor(0)
    for word in (2 ** 32 - 128, 2 ** 32 - 1):
        ref = np.asarray(jqmc.sobol02(jnp.uint32(0), jnp.uint32(word)))
        out = tqmc.sobol02(0, torch.tensor(word), zero).numpy()
        assert ref[0] == out[0] == 1.0
    assert tqmc.sobol02(0, torch.tensor(2 ** 32 - 129), zero).numpy()[0] < 1.0


@pytest.mark.parametrize("prime_index", [0, 1, 4, 9, 31, 40])
def test_radical_inverse_matches_jax(prime_index):
    rot = jnp.asarray(ROTATION)[None]
    idx = jnp.asarray(np.asarray(INDICES, np.uint64).astype(np.uint32))[:, None]
    ref = np.asarray(jqmc.radical_inverse(prime_index, idx, rot))
    out = np.stack([tqmc.radical_inverse(prime_index, i,
                                         torch.from_numpy(ROTATION)).numpy()
                    for i in INDICES])
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("prime_index", [0, 1, 4, 9, 31])
def test_scrambled_radical_inverse_matches_jax(prime_index):
    idx = jnp.asarray(np.asarray(INDICES, np.uint64).astype(np.uint32))
    ref = np.asarray(jqmc.scrambled_radical_inverse(prime_index, idx))
    out = np.asarray([tqmc.scrambled_radical_inverse(prime_index, i)
                      for i in INDICES], np.float32)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("dim", [0, 1, 2, 17, 63, 70])
def test_sobol_nd_matches_jax(dim):
    ref = _jax_grid(lambda i, s: jqmc.sobol_nd(dim, i, s), SCRAMBLE[0])
    out = _port_grid(lambda i, s: tqmc.sobol_nd(dim, i, s), SCRAMBLE[0])
    np.testing.assert_array_equal(_bits(out), _bits(ref))


# --- the draws of every sampler type ---------------------------------------

SAMPLER_TYPES = ("independent", "stratified", "ldsampler", "sobol", "halton",
                 "hammersley", "faure")
PIX = np.arange(0, 300 * 7, 7, dtype=np.int32)
SAMPLES = (0, 1, 5, 12)
# the sensor and aperture slots, a spare one, the first bounces' NEE, BSDF
# and roulette slots (the prime-base dimensions), a later (0,2) one and one
# past the Sobol table
DIMS = (0, 1, 3, 4, 5, 6, 8, 22, 40)


def _settings(name, spp):
    tag = getattr(tapi, name.upper())
    return (japi.RenderSettings(width=30, height=10, spp=spp,
                                sampler_type=tag, seed=11),
            tapi.RenderSettings(width=30, height=10, spp=spp,
                                sampler_type=tag, seed=11))


@pytest.fixture
def jax_sampler():
    """Sets the JAX package's sampler global as its render_pass does, and
    restores the independent sampler after the test (a later test in the
    same worker would otherwise draw with this one)."""
    def set_mode(settings):
        jrng.set_sampler(
            {japi.LDSAMPLER: jrng.LD, japi.SOBOL: jrng.SOBOL,
             japi.HALTON: jrng.HALTON, japi.HAMMERSLEY: jrng.HAMMERSLEY,
             japi.FAURE: jrng.FAURE}.get(settings.sampler_type,
                                         jrng.INDEPENDENT),
            n=settings.spp)
    try:
        yield set_mode
    finally:
        jrng.set_sampler(jrng.INDEPENDENT, n=16)


# every sampler type at N = 16; hammersley also at N = 12 (not a power of
# two: the ramp takes sample mod N instead of the per-pixel XOR)
DRAW_CASES = [(name, 16) for name in SAMPLER_TYPES] + [("hammersley", 12)]


@pytest.mark.parametrize("name,spp", DRAW_CASES,
                         ids=[f"{n}-n{s}" for n, s in DRAW_CASES])
def test_draws_match_jax(jax_sampler, name, spp):
    """uniform1, uniform2 and uniform4 of each sampler type at PIX x SAMPLES
    x DIMS, bit for bit (the JAX side in one call per function)."""
    js, ts = _settings(name, spp)
    jax_sampler(js)
    smp = tapi.sampler_of(ts)
    pix = torch.from_numpy(PIX).long()
    grid = (jnp.asarray(PIX)[:, None, None],
            jnp.asarray(SAMPLES, jnp.int32)[None, :, None],
            jnp.asarray(DIMS, jnp.int32)[None, None, :])
    for fn in ("uniform1", "uniform2", "uniform4"):
        ref = np.asarray(getattr(jrng, fn)(11, *grid))
        out = np.stack([np.stack([getattr(trng, fn)(smp, pix, s, d).numpy()
                                  for d in DIMS], axis=1) for s in SAMPLES],
                       axis=1)
        np.testing.assert_array_equal(_bits(out), _bits(ref), err_msg=fn)


# the stratified sampler's own jitter grid, and a low-discrepancy jitter
# (the other types' positions are dimension 0 of their draws, held above)
@pytest.mark.parametrize("name", ["stratified", "ldsampler"])
def test_pixel_sample_positions_match_jax(jax_sampler, name):
    """The film positions (spp 10: the stratified sampler's 3 x 3 strata and
    one sample past them)."""
    js, ts = _settings(name, 10)
    jax_sampler(js)
    smp = tapi.sampler_of(ts)
    samples = (0, 4, 8, 9)
    ref = np.asarray(japi.pixel_sample_positions(
        js, jnp.asarray(PIX)[:, None], jnp.asarray(samples, jnp.int32)[None],
        11))
    out = np.stack([tapi.pixel_sample_positions(
        ts, torch.from_numpy(PIX).long(), s, smp).numpy() for s in samples],
        axis=1)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_sampler_record_follows_the_settings():
    """The API's numbering maps to rng's modes (stratified draws
    independent numbers), N is the sample count, the seed is kept."""
    kinds = {name: tapi.sampler_of(_settings(name, 8)[1]).kind
             for name in SAMPLER_TYPES}
    assert kinds == {"independent": trng.INDEPENDENT,
                     "stratified": trng.INDEPENDENT, "ldsampler": trng.LD,
                     "sobol": trng.SOBOL, "halton": trng.HALTON,
                     "hammersley": trng.HAMMERSLEY, "faure": trng.FAURE}
    assert tapi.sampler_of(tapi.RenderSettings(spp=0, seed=3)) == \
        trng.Sampler(seed=3, kind=trng.INDEPENDENT, n=1)


def test_an_int_seed_is_the_independent_sampler():
    pix = torch.arange(64)
    for fn in (trng.uniform1, trng.uniform2, trng.uniform4):
        np.testing.assert_array_equal(
            fn(5, pix, 3, 7).numpy(),
            fn(trng.Sampler(seed=5, kind=trng.INDEPENDENT), pix, 3, 7).numpy())


def test_low_discrepancy_draws_need_host_ints():
    smp = trng.Sampler(kind=trng.LD)
    with pytest.raises(TypeError, match="host int"):
        trng.uniform2(smp, torch.arange(4), torch.arange(4), 5)
