"""Port parity, primary-sample-space MLT and erpt: the PSS sampler, the
tables of fresh uniforms, the tensor radical inverse, Kelemen's small
step, the normalisation b, chain seeding and mutations, one erpt pass, a
path evaluation whose every draw reads a constant table, and the loader.
Against the JAX package on the same inputs, on the CPU, on the Cornell box
of tests/test_mlt.py at 8x8, depth 3.

Tolerances:
  * the PSS lookups, the fresh tables and the radical inverse: bit for bit
    (table reads, the PCG hash, and float32 digit sums of exact powers);
  * small_step: rtol 1e-6 / atol 1e-7 (one exp of float32 each, which
    MKL and XLA may round an ulp apart);
  * b: 1e-6 relative (a float32 sum of 1,024 luminances, summed in another
    order);
  * the chains (256 chains seeded from 4 candidates, then 3 mutations; one
    erpt pass of 64 seeds, chain length 3): at least 99% of chains with
    the same table (atol 1e-6: the small step's rounding) and luminance
    (rtol 1e-4 / atol 1e-6), L within atol 1e-5 on those chains, and the
    film within rtol 1e-4 / atol 1e-4 on the pixels that only agreeing
    chains reached (an accept decision that flips on the last bit of a
    luminance ratio parts a chain for good; measured: every chain agrees,
    the films within 7.7e-6 of values up to 80);
  * the constant-table evaluation: L within rtol 1e-5 / atol 1e-6, as the
    path tracer's parity tests.

The JAX side is one jitted function holding estimate_b, seed_chains,
chain_steps, erpt_pass and the constant-table eval_target (about 12 s of
compile on a shared 8-core CPU host), started in a thread before the first
test; the port's tests run beside it. The file takes about 21 s in a fresh
process, 28 s without the JAX package's compile cache: over a 20 s aim,
since that compile and the imports are most of it.
"""
import concurrent.futures
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import qmc as jqmc
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu.render.integrators import mlt as jmlt
from mitsuba_tpu_torch.core import qmc as tqmc
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import medium as tmedium
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from mitsuba_tpu_torch.render.integrators import mlt as tmlt

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
RES, DEPTH, SEED = 8, 3, 3
CHAINS, LUM, STEPS = 256, 1024, 3
SEEDS, CHAIN_LEN, ERPT_PASS = 64, 3, 1
CONST = 0.37


def cornell(mod, shapes, T, sensor, **kw):
    b = mod.SceneBuilder()
    shapes.cornell_box(b)
    scene, static = b.build(**kw)
    return scene, static, sensor.make_perspective(
        T.look_at(EYE, AT, UP), FOV, RES, RES, **kw)


# the PSS table of the sampler tests, and their lanes and dimensions
TABLE = np.random.default_rng(11).random((5, 6, 4), np.float32)
LANES = np.array([4, 0, 2, 2, 1])
INT_DIMS = [0, 3, 5, 9, -2]
DIMS = np.arange(3, 9)[:, None]
DRAWS = ["uniform4", "uniform1", "uniform2"]
FRESH_LANES = np.arange(0, 4096, 7)


RI_IDX = np.concatenate([np.arange(4096), np.random.default_rng(5).integers(
    0, 2 ** 31, 512)]).astype(np.int64)
RI_CASES = [(0, 0.0), (1, 0.3125), (4, 0.3125)]
STEP_U, STEP_R = np.random.default_rng(4).random((2, 4096, 4), np.float32)


@jax.jit
def _jax_draws():
    """The JAX values of the sampler, table and small-step tests, one
    jitted function. pss_mode sets a module global, which the render
    function below sets too while it is traced, so both run in the one
    thread, one after the other."""
    out = {}
    with jrng.pss_mode(jnp.asarray(TABLE)):
        for draw in DRAWS:
            fn = getattr(jrng, draw)
            for dim in INT_DIMS:
                out[f"{draw} {dim}"] = fn(0, jnp.asarray(LANES), 7, dim)
            out[f"{draw} dims"] = fn(0, jnp.arange(5), 0, jnp.asarray(DIMS))
        out["medium"] = jnp.stack([jrng.uniform2(0, jnp.arange(5), 0, k)
                                   for k in range(2, 8)])
    out["fresh"] = jmlt.fresh_table(SEED + 7919, jnp.asarray(FRESH_LANES), 5,
                                    24)
    for prime, rot in RI_CASES:
        out[f"ri {prime}"] = jqmc.radical_inverse(
            prime, jnp.asarray(RI_IDX, jnp.uint32), rot)
    out["small_step"] = jmlt.small_step(jnp.asarray(STEP_U),
                                        jnp.asarray(STEP_R))
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_run():
    """The JAX side, the sampler tests' draws and then one jitted function,
    started before the module's first test in a thread of its own."""
    js, jst, jsen = cornell(jscene, jshapes, JTransform, jsensor)
    cfg = jcommon.IntegratorConfig(type=jcommon.PSSMLT, max_depth=DEPTH)
    nslots = jmlt.n_slots(cfg)

    @jax.jit
    def run(sc):
        b = jmlt.estimate_b(sc, jst, jsen, cfg, RES, RES, SEED, LUM)
        st = jmlt.seed_chains(sc, jst, jsen, cfg, RES, RES, SEED, CHAINS)
        st2, film, acc = jmlt.chain_steps(sc, jst, jsen, cfg, RES, RES,
                                          SEED, st, jnp.zeros((RES, RES, 3)),
                                          0, STEPS)
        ef = jmlt.erpt_pass(sc, jst, jsen, cfg, RES, RES, SEED,
                            jnp.zeros((RES, RES, 3)), ERPT_PASS, SEEDS,
                            CHAIN_LEN)
        const = jmlt.eval_target(sc, jst, jsen, cfg, RES, RES,
                                 jnp.full((CHAINS, nslots, 4), CONST))
        return dict(b=b, seed=st, steps=st2, film=film, acc=acc, erpt=ef,
                    const=const)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        draws = pool.submit(lambda: jax.tree.map(np.asarray, _jax_draws()))
        yield draws, pool.submit(
            lambda: jax.tree.map(np.asarray, run(js)))


@pytest.fixture(scope="module")
def draws(jax_run):
    return jax_run[0].result()


@pytest.fixture(scope="module")
def ref(jax_run):
    return jax_run[1].result()


@pytest.fixture(scope="module")
def port():
    return cornell(tscene, tshapes, TTransform, tsensor, device="cpu")


def _cfg():
    return tcommon.IntegratorConfig(type=tcommon.PSSMLT, max_depth=DEPTH)


# --- the primary-sample-space sampler ------------------------------------

@pytest.mark.parametrize("dim", INT_DIMS)
@pytest.mark.parametrize("draw", DRAWS)
def test_pss_draws_at_an_int_dim(draws, draw, dim):
    """uniform4/1/2 under the PSS sampler read table[lane, clip(dim)], as
    the JAX pss_mode does (dims 9 and -2 are clipped to 5 and 0)."""
    out = getattr(trng, draw)(trng.PssSampler(torch.from_numpy(TABLE)),
                              torch.from_numpy(LANES), 7, dim).numpy()
    np.testing.assert_array_equal(out, draws[f"{draw} {dim}"])


@pytest.mark.parametrize("draw", DRAWS)
def test_pss_draws_at_a_tensor_of_dims(draws, draw):
    """A (n, 1) tensor of dimensions broadcasts against the (R,) lanes
    (render/medium.py _draws), with the clip."""
    out = getattr(trng, draw)(trng.PssSampler(torch.from_numpy(TABLE)),
                              torch.arange(5), 0,
                              torch.from_numpy(DIMS)).numpy()
    assert out.shape[:2] == (6, 5)
    np.testing.assert_array_equal(out, draws[f"{draw} dims"])


def test_medium_draws_read_the_table(draws):
    """The tracking loops' batched draws (medium._draws) under the PSS
    sampler: the JAX uniform2 at each dimension, clipped."""
    out = tmedium._draws(trng.PssSampler(torch.from_numpy(TABLE)),
                         torch.arange(5), 0, 2, 6).numpy()
    np.testing.assert_array_equal(out, draws["medium"])


# --- fresh tables, the radical inverse, the small step -------------------

def test_fresh_table_bitwise(draws):
    out = tmlt.fresh_table(SEED + 7919, torch.from_numpy(FRESH_LANES), 5, 24)
    np.testing.assert_array_equal(out.numpy(), draws["fresh"])


@pytest.mark.parametrize("prime, rot", RI_CASES)
def test_radical_inverse_of_lanes_bitwise(draws, prime, rot):
    out = tqmc.radical_inverse_lanes(prime, torch.from_numpy(RI_IDX), rot)
    np.testing.assert_array_equal(out.numpy(), draws[f"ri {prime}"])


def test_small_step_matches_jax_and_is_symmetric(draws):
    out = tmlt.small_step(torch.from_numpy(STEP_U),
                          torch.from_numpy(STEP_R)).numpy()
    np.testing.assert_allclose(out, draws["small_step"], rtol=1e-6,
                               atol=1e-7)
    # as tests/test_mlt.py: in [0, 1), sizes in [s1, s2], signs balanced
    v = tmlt.small_step(torch.full((4096,), 0.5),
                        trng.uniform1(3, torch.arange(4096), 0, 0)).numpy()
    assert (v >= 0).all() and (v < 1).all()
    mags = np.abs(v - 0.5)
    assert mags.max() <= 1 / 64 + 1e-6 and mags.min() >= 1 / 1024 - 1e-6
    assert abs(np.mean(np.sign(v - 0.5))) < 0.05
    # the wrap: a step past 1 comes back from 0
    w = tmlt.small_step(torch.full((1,), 0.999), torch.full((1,), 0.0))
    assert 0.0 <= float(w) < 0.02


# --- the chains ----------------------------------------------------------

def test_estimate_b(ref, port):
    with torch.no_grad():
        b, n = tmlt.estimate_b(*port, _cfg(), RES, RES, SEED, LUM)
    assert float(b) == pytest.approx(float(ref["b"]), rel=1e-6)
    assert int(n) > 0


@pytest.fixture(scope="module")
def port_chains(port):
    with torch.no_grad():
        st, _ = tmlt.seed_chains(*port, _cfg(), RES, RES, SEED, CHAINS)
        st2, film, acc, _ = tmlt.chain_steps(
            *port, _cfg(), RES, RES, SEED, st, torch.zeros(RES, RES, 3), 0,
            STEPS)
    return st, st2, film, acc


def _agreeing(st, ref_st):
    same_u = np.all(np.isclose(st.u.numpy(), ref_st.u, atol=1e-6),
                    axis=(1, 2))
    same_i = np.isclose(st.I.numpy(), ref_st.I, rtol=1e-4, atol=1e-6)
    return same_u & same_i


@pytest.mark.parametrize("which", ["seed", "steps"])
def test_chain_states(ref, port_chains, which):
    st = port_chains[0 if which == "seed" else 1]
    ref_st = ref[which]
    ok = _agreeing(st, ref_st)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_allclose(st.L.numpy()[ok], ref_st.L[ok], atol=1e-5)
    np.testing.assert_array_equal(_pixels(st.pos.numpy()[ok]),
                                  _pixels(ref_st.pos[ok]))


def _pixels(pos):
    """Film pixels (N, 2) of positions, as splat_box truncates them."""
    return np.clip(pos.astype(np.int32), 0, RES - 1)


def test_chain_film_and_acceptance(ref, port_chains):
    """The film on the pixels that no parted chain's seed or final state
    lands on (all of it when every chain agrees), and the mean
    acceptance."""
    st0, st2, film, acc = port_chains
    ok = _agreeing(st0, ref["seed"]) & _agreeing(st2, ref["steps"])
    assert ok.mean() >= 0.99, ok.mean()
    mask = np.ones((RES, RES), bool)
    for pos in (st0.pos.numpy(), st2.pos.numpy(), ref["seed"].pos,
                ref["steps"].pos):
        px = _pixels(pos[~ok])
        mask[px[:, 1], px[:, 0]] = False
    np.testing.assert_allclose(film.numpy()[mask], ref["film"][mask],
                               rtol=1e-4, atol=1e-4)
    assert float(acc) == pytest.approx(float(ref["acc"]), abs=2e-3)


def test_erpt_pass(ref, port):
    with torch.no_grad():
        film, n = tmlt.erpt_pass(*port, _cfg(), RES, RES, SEED,
                                 torch.zeros(RES, RES, 3), ERPT_PASS, SEEDS,
                                 CHAIN_LEN)
    np.testing.assert_allclose(film.numpy(), ref["erpt"], rtol=1e-4,
                               atol=1e-4)
    assert float(film.mean()) == pytest.approx(float(ref["erpt"].mean()),
                                               rel=1e-5)


def test_every_path_draw_reads_the_table(ref, port):
    """A table of one constant: path.li's every draw (pixel, aperture, NEE,
    BSDF, roulette) reads it, in both packages."""
    nslots = tmlt.n_slots(_cfg())
    with torch.no_grad():
        L, I, pos, _ = tmlt.eval_target(*port, _cfg(), RES, RES, torch.full(
            (CHAINS, nslots, 4), CONST))
    jL, jI, jpos = ref["const"]
    np.testing.assert_allclose(L.numpy(), jL, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(I.numpy(), jI, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    # every lane is one sample of one pixel: one value
    assert np.ptp(L.numpy(), axis=0).max() == 0.0 and float(I[0]) > 0


# --- the loader ----------------------------------------------------------

def _cbox(tmp_path, kind, extra=""):
    text = (REPO / "scenes" / "cbox.xml").read_text()
    old = '<integrator type="path">'
    assert text.count(old) == 1
    path = tmp_path / f"{kind}.xml"
    path.write_text(text.replace(old, f'<integrator type="{kind}">{extra}'))
    return path


@pytest.mark.parametrize("kind, extra", [
    ("pssmlt", ""), ("erpt", ""),
    ("pssmlt", '<float name="pLarge" value="0.125"/><integer '
     'name="luminanceSamples" value="512"/>'),
    ("erpt", '<integer name="chainLength" value="12"/>')])
def test_loaders_agree_on_the_integrator(tmp_path, kind, extra):
    path = _cbox(tmp_path, kind, extra)
    defines = {"spp": 2, "res": 4}
    jcfg = jxml.load_scene(str(path), defines).integrator
    tcfg = txml.load_scene(str(path), defines, device="cpu").integrator
    assert tcfg.type == {"pssmlt": 12, "erpt": 16}[kind]
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_erpt_file_renders(tmp_path):
    """load_scene + api.render of an erpt file on the CPU: one pass of 16
    seeds at 4x4, with its ray count."""
    path = _cbox(tmp_path, "erpt", '<integer name="chainLength" value="2"/>'
                 '<integer name="maxDepth" value="2"/>')
    ls = txml.load_scene(str(path), {"spp": 1, "res": 4}, device="cpu")
    img, n = tapi.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                         ls.settings, device="cpu", with_stats=True)
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0 and n > 0
    assert tmlt.LAST_RUN == {"passes": 1, "seeds": 16, "chain_length": 2}
