"""Port parity, intersection layer: the plain versions of the brute-force
kernels K1/K2 (mitsuba_tpu_torch.ops.cuda_intersect) against the Pallas
kernels of mitsuba_tpu.ops.pallas_intersect in interpret mode, and the XLA
forms of ops/intersect.py against their port, on the CPU.

Tolerances: hit and idx must be equal (both sides test triangles in index
order with the same strict comparison). t, u, v and the interpolated record
are held to rtol 1e-5 / atol 1e-6: XLA may contract a*b+c into an FMA where
the plain version rounds each operation. Ids and the NEE pdf are gathered,
so they must be equal.

Interpret mode is slow (seconds per call), so one interpret-mode call of
K1 runs in a module fixture and every field is its own test; K2's plain
version is held against the same call's closest hit (``_mt_loop``, shared by
both TPU kernels). The triangles are the Cornell box's and degenerate ones
(see ``case``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import intersect as jisect
from mitsuba_tpu.ops import pallas_intersect as pti
from mitsuba_tpu_torch.ops import cuda_intersect as bf
from mitsuba_tpu_torch.ops import intersect as tisect

TOL = dict(rtol=1e-5, atol=1e-6)
TRI_FIELDS = ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_gn", "tri_mat",
              "tri_emitter", "tri_nee_pdf_area")
K1_OUT = ("hit", "t", "idx", "u", "v", "n_sh", "gn", "uv", "mat", "em", "nee")
EXACT = {"hit", "idx", "gn", "mat", "em", "nee"}


def _rays(n, seed):
    """Rays from inside and outside the Cornell box: camera rays through the
    front opening, random rays from inside, and rays pointing away (misses);
    a tenth of the lanes inactive (t_max = t_min), as the integrator sends."""
    rs = np.random.default_rng(seed)
    o = np.empty((n, 3), np.float32)
    d = rs.normal(size=(n, 3))
    k = n // 3
    o[:k] = [0.5, 0.5, -1.39]
    d[:k] = np.stack([rs.uniform(-0.4, 0.4, k), rs.uniform(-0.4, 0.4, k),
                      np.ones(k)], -1)
    o[k:2 * k] = rs.uniform(0.05, 0.95, (k, 3))
    o[2 * k:] = [0.5, 0.5, -1.39]
    d[2 * k:] = np.abs(d[2 * k:]) * [1, 1, -1]  # away from the box: misses
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    dead = rs.random(n) < 0.1
    t_max[dead] = t_min[dead]
    return o, d.astype(np.float32), t_min, t_max


@pytest.fixture(scope="module")
def case(cornell):
    """The Cornell box's 36 triangles followed by 108 zero-area ones (p0 on
    the box, e1 = e2 = 0), which the determinant test must skip. Past 128
    triangles the Pallas kernel loops over them instead of unrolling one
    step per triangle: the same arithmetic, compiled in interpret mode in
    seconds instead of half a minute."""
    scene, _ = cornell
    tris = [np.array(getattr(scene, f)) for f in TRI_FIELDS]
    pad = [np.concatenate([x] * 3) for x in tris]
    pad[1][:] = 0.0
    pad[2][:] = 0.0
    tris = [np.concatenate([x, y]) for x, y in zip(tris, pad)]
    assert len(tris[0]) > 128
    rays = _rays(4096, seed=11)
    return tris, rays


@pytest.fixture(scope="module")
def k1(case):
    tris, rays = case
    ref = pti.brute_force_interaction(*(jnp.asarray(x) for x in tris + list(rays)),
                                      interpret=True)
    out = bf.brute_force_interaction(*(torch.from_numpy(x) for x in tris + list(rays)))
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


@pytest.fixture(scope="module")
def k2(case, k1):
    """K2's plain version against the Pallas closest hit. Both TPU kernels
    run the same loop body (_mt_loop) and K1's first five outputs are K2's,
    so K1's interpret-mode run serves as the reference: one interpret-mode
    compile instead of two."""
    tris, rays = case
    args = tris[:3] + list(rays)
    out = bf.brute_force_closest_hit(*(torch.from_numpy(x) for x in args))
    return k1[0][:5], [x.numpy() for x in out]


def _compare(name, out, ref):
    assert out.shape == ref.shape, name
    if name in EXACT:
        np.testing.assert_array_equal(out, ref, err_msg=name)
    else:
        np.testing.assert_allclose(out, ref, err_msg=name, **TOL)


@pytest.mark.parametrize("field", K1_OUT[:5])
def test_k2_plain_matches_pallas(k2, field):
    ref, out = k2
    i = K1_OUT.index(field)
    _compare(field, out[i], ref[i])


@pytest.mark.parametrize("field", K1_OUT)
def test_k1_plain_matches_pallas(k1, field):
    ref, out = k1
    i = K1_OUT.index(field)
    _compare(field, out[i], ref[i])


def test_rays_cover_hits_misses_and_dead_lanes(case, k2):
    _, (_, _, t_min, t_max) = case
    hit = k2[1][0]
    assert 0.3 < hit.mean() < 0.8
    assert not hit[t_max == t_min].any()


def test_k1_k2_agree_on_the_hit(k1, k2):
    for a, b in zip(k1[1][:5], k2[1][:5]):
        np.testing.assert_array_equal(a, b)


def test_plain_tie_break_and_chunks():
    """Duplicate triangles, also across the plain version's triangle chunks:
    the lowest index wins, as with the kernel's strict t < best."""
    rs = np.random.default_rng(3)
    T = 3 * bf._PLAIN_CHUNK
    p0 = rs.uniform(-5, 5, (T, 3)).astype(np.float32)
    p0[:, 2] = 10.0 + rs.uniform(0, 5, T)
    e1 = np.tile(np.float32([[-2, 0, 0]]), (T, 1))
    e2 = np.tile(np.float32([[0, -2, 0]]), (T, 1))
    # the wall every ray hits first, at three indices in three chunks
    for i in (150, 7, bf._PLAIN_CHUNK + 3):
        p0[i], e1[i], e2[i] = [3, 3, 2], [-8, 0, 0], [0, -8, 0]
    o = np.zeros((64, 3), np.float32)
    d = np.tile(np.float32([[0, 0, 1]]), (64, 1))
    d[:, :2] = rs.uniform(-0.4, 0.4, (64, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = [torch.from_numpy(x) for x in (p0, e1, e2, o, d)]
    hit, t, idx, u, v = bf.brute_force_closest_hit(
        *args, torch.zeros(64), torch.full((64,), torch.inf))
    assert hit.all() and (idx == 7).all()
    ref = jisect.ray_brute_force_tris(*(jnp.asarray(x) for x in (o, d, p0, e1, e2)),
                                      jnp.zeros(64), jnp.full(64, jnp.inf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(t.numpy(), np.asarray(ref[1]), **TOL)


def _soup(T, R, seed):
    rs = np.random.default_rng(seed)
    p0 = rs.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rs.normal(scale=0.3, size=(T, 3)).astype(np.float32)
    e2 = rs.normal(scale=0.3, size=(T, 3)).astype(np.float32)
    o = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = rs.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return p0, e1, e2, o, d


def test_ray_triangle_matches_jax():
    p0, e1, e2, o, d = _soup(1, 4096, seed=4)
    t_min, t_max = np.zeros(4096, np.float32), np.full(4096, np.inf, np.float32)
    ref = jisect.ray_triangle(*(jnp.asarray(x) for x in (o, d, p0, e1, e2)),
                              jnp.asarray(t_min), jnp.asarray(t_max))
    out = tisect.ray_triangle(*(torch.from_numpy(x) for x in (o, d, p0, e1, e2)),
                              torch.from_numpy(t_min), torch.from_numpy(t_max))
    hit = np.asarray(ref[0])
    np.testing.assert_array_equal(out[0].numpy(), hit)
    # off the triangle, near-parallel rays give huge t where XLA's FMA
    # contraction shows; the hits are what the renderer consumes
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], **TOL)


def test_brute_force_forms_agree_on_a_random_soup():
    """The XLA form (port and JAX) and the kernel's plain version agree on
    which triangle each ray hits, over several plain-version chunks."""
    p0, e1, e2, o, d = _soup(300, 2048, seed=5)
    t_min, t_max = np.zeros(2048, np.float32), np.full(2048, np.inf, np.float32)
    ref = jisect.ray_brute_force_tris(*(jnp.asarray(x) for x in (o, d, p0, e1, e2)),
                                      jnp.asarray(t_min), jnp.asarray(t_max))
    tt = [torch.from_numpy(x) for x in (o, d, p0, e1, e2, t_min, t_max)]
    xla = tisect.ray_brute_force_tris(*tt)
    plain = bf.brute_force_closest_hit(tt[2], tt[3], tt[4], tt[0], tt[1], tt[5], tt[6])
    assert 0.1 < np.asarray(ref[0]).mean() < 0.9
    for out in (xla, plain):
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
        hit = np.asarray(ref[0])  # a miss's u, v differ by design
        for a, b in zip(out[1:], ref[1:]):
            np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], **TOL)


def test_cpu_call_runs_plain_and_counts_no_launch():
    p0, e1, e2, o, d = (torch.from_numpy(x) for x in _soup(8, 16, seed=6))
    before = (bf.brute_force_closest_hit.launches, bf.brute_force_interaction.launches)
    bf.brute_force_closest_hit(p0, e1, e2, o, d, torch.zeros(16),
                               torch.full((16,), torch.inf))
    assert (bf.brute_force_closest_hit.launches,
            bf.brute_force_interaction.launches) == before


@pytest.mark.parametrize("bad, error", [
    ("d_strided", ValueError),     # the kernel reads rows of 3 floats
    ("o_float64", TypeError),
    ("t_max_shape", ValueError),
    ("no_triangles", ValueError),
    ("too_many_triangles", ValueError),  # past the kernels' 4096 contract
])
def test_wrapper_checks_inputs_on_the_cpu_too(bad, error):
    """The CPU route enforces the kernel's input contract, so the CPU tests
    catch a caller that the card would refuse."""
    p0, e1, e2, o, d = (torch.from_numpy(x) for x in _soup(8, 16, seed=6))
    t_min, t_max = torch.zeros(16), torch.full((16,), torch.inf)
    if bad == "d_strided":
        d = torch.cat([d, d], dim=1)[:, ::2]
    elif bad == "o_float64":
        o = o.double()
    elif bad == "t_max_shape":
        t_max = t_max[:8]
    elif bad == "no_triangles":
        p0, e1, e2 = p0[:0], e1[:0], e2[:0]
    else:
        p0, e1, e2 = (x.repeat(bf.MAX_TRIS // 8 + 1, 1) for x in (p0, e1, e2))
    with pytest.raises(error):
        bf.brute_force_closest_hit(p0, e1, e2, o, d, t_min, t_max)


def test_wrapper_rejects_other_devices():
    p0, e1, e2, o, d = (torch.from_numpy(x) for x in _soup(8, 16, seed=6))
    with pytest.raises(ValueError):
        bf.brute_force_closest_hit(p0.to("meta"), e1, e2, o, d, torch.zeros(16),
                                   torch.full((16,), torch.inf))
    with pytest.raises(ValueError):
        bf.brute_force_closest_hit(*(x.to("meta") for x in (p0, e1, e2, o, d)),
                                   torch.zeros(16, device="meta"),
                                   torch.zeros(16, device="meta"))


# --- contract edges of the redesigned kernels (live-ray compaction, several
# rays per thread): the plain version the card holds K1/K2 against, checked
# against the JAX package's XLA form. hit and idx are exact (both test the
# triangles in index order with a strict <, and argmin takes the first
# minimum); t to TOL, since XLA may contract a*b+c into an FMA; a miss's u, v
# differ by design (the XLA form gathers them at argmin = 0), so they are
# held to the kernel's contract (0) instead.

_xla_brute_force = jax.jit(jisect.ray_brute_force_tris)


def _xla(p0, e1, e2, o, d, t_min, t_max):
    return [np.asarray(x) for x in _xla_brute_force(
        *(jnp.asarray(x) for x in (o, d, p0, e1, e2, t_min, t_max)))]


def _check_against_xla(p0, e1, e2, o, d, t_min, t_max):
    ref = _xla(p0, e1, e2, o, d, t_min, t_max)
    tt = [torch.from_numpy(x) for x in (p0, e1, e2, o, d, t_min, t_max)]
    out = [x.numpy() for x in bf.brute_force_closest_hit(*tt)]
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_allclose(out[1], ref[1], **TOL)
    hit = ref[0]
    for a, b in zip(out[3:], ref[3:]):
        np.testing.assert_allclose(a[hit], b[hit], **TOL)
        assert (a[~hit] == 0.0).all()
    return out


def test_all_dead_batch_is_all_misses():
    """Every lane dead (t_max = t_min), as a block of the last bounce may
    be: each gets the miss outputs, K1's record defaults included."""
    p0, e1, e2, o, d = _soup(37, 515, seed=8)
    t_min = np.full(515, 1e-4, np.float32)
    out = _check_against_xla(p0, e1, e2, o, d, t_min, t_min.copy())
    assert not out[0].any() and (out[2] == -1).all()
    assert np.isinf(out[1]).all()
    rec = bf.brute_force_interaction(
        *(torch.from_numpy(x) for x in (p0, e1, e2)),
        *(torch.zeros(37, 3) for _ in range(3)), *(torch.zeros(37, 2) for _ in range(3)),
        torch.ones(37, 3), torch.ones(37, dtype=torch.int32),
        torch.ones(37, dtype=torch.int32), torch.ones(37),
        *(torch.from_numpy(x) for x in (o, d, t_min, t_min.copy())))
    assert (rec[5].numpy() == [0, 0, 1]).all() and (rec[6].numpy() == [0, 0, 1]).all()
    assert (rec[7].numpy() == 0).all() and (rec[8].numpy() == 0).all()
    assert (rec[9].numpy() == -1).all() and (rec[10].numpy() == 0).all()


def test_ray_count_off_every_block_size():
    """1,031 rays (not a multiple of 4, 32 or 256; the kernel packs a
    block's slots in groups of 32 per ray a thread holds), most of them
    dead and scattered, one with a NaN t_max and one with a NaN t_min."""
    p0, e1, e2, o, d = _soup(64, 1031, seed=9)
    rs = np.random.default_rng(10)
    t_min = np.full(1031, 1e-4, np.float32)
    t_max = np.full(1031, np.inf, np.float32)
    dead = rs.random(1031) < 0.7
    t_max[dead] = t_min[dead]
    t_max[3], t_min[5] = np.nan, np.nan
    out = _check_against_xla(p0, e1, e2, o, d, t_min, t_max)
    assert 10 < out[0].sum() < int((~dead).sum())
    assert not out[0][[3, 5]].any() and not out[0][dead].any()


def test_one_triangle():
    p0, e1, e2, o, d = _soup(1, 1000, seed=12)
    # aim half the rays at the triangle's centroid, within 40 degrees of its
    # normal (grazing rays amplify XLA's FMA contraction past TOL)
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n)
    a = n + 0.4 * np.random.default_rng(13).uniform(-1, 1, (500, 3))
    d[:500] = a / np.linalg.norm(a, axis=-1, keepdims=True)
    o[:500] = p0 + (e1 + e2) / 3 - 2 * d[:500]
    out = _check_against_xla(p0, e1, e2, o, d, np.zeros(1000, np.float32),
                             np.full(1000, np.inf, np.float32))
    assert out[0][:500].mean() > 0.9 and set(np.unique(out[2])) <= {-1, 0}


@pytest.mark.parametrize("a, b", [(3, 5), (5, 3)])
def test_shared_edge_goes_to_the_lower_index(a, b):
    """Two triangles that share an edge, at indices a and b among 8, and a
    ray through the edge's midpoint: both report t = 1 exactly (dyadic
    coordinates), and the lower index wins whichever triangle it holds."""
    p0 = np.full((8, 3), 50.0, np.float32)  # far away: never hit
    e1 = np.tile(np.float32([[1, 0, 0]]), (8, 1))
    e2 = np.tile(np.float32([[0, 1, 0]]), (8, 1))
    p0[a], e1[a], e2[a] = [0, 0, 1], [1, 0, 0], [0, 1, 0]
    p0[b], e1[b], e2[b] = [1, 0, 1], [0, 1, 0], [-1, 1, 0]
    o = np.float32([[0.5, 0.5, 0.0], [0.25, 0.25, 0.0], [0.75, 0.75, 0.0]])
    d = np.tile(np.float32([[0, 0, 1]]), (3, 1))
    out = _check_against_xla(p0, e1, e2, o, d, np.zeros(3, np.float32),
                             np.full(3, np.inf, np.float32))
    assert out[0].all() and (out[1] == 1.0).all()
    assert out[2].tolist() == [min(a, b), a, b]
