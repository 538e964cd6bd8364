"""Port parity, BVH layer: the BVH builder (numpy and native routes), the node
packer, the coherence sort key and the plain versions of the lane kernels
K3-K6 (mitsuba_tpu_torch.ops.cuda_bvh) against the JAX package on the CPU.

Tolerances:
  * builder, packer and sort keys: exact (the same arithmetic on the same
    inputs, copied code);
  * K4, K3 and the canonical walk against the Pallas kernels in interpret
    mode: hit and idx exact (both find the same hit with the same strict
    comparisons; the octant walks keep the canonical walk's by the tie
    rule), t to rtol 1e-5 / atol 1e-6 and the barycentrics u, v in [0, 1]
    to atol 1e-5 (XLA may contract a*b+c into an FMA where the plain version
    rounds each operation; measured up to 4.5e-6 on u, v);
  * K5 and K6 against the XLA walk ``accel/traverse.py:bvh_closest_hit``
    (their Pallas kernels take 3-5 s each to compile in interpret mode, more
    than this file's time budget): hit exact, idx on 99% of hits, t to
    rtol 1e-4 (the XLA walk tests a leaf's box before its triangle and
    inverts the determinant through safe_div, so grazing hits can differ);
  * a budgeted and resumed walk against the unbounded one, K4, K5 and K6
    against K3's plain walk and the canonical walk, and the octant walks'
    tie rule against the JAX kernel and the XLA walk: bit for bit.

The Pallas calls run with strip=1: a lane's node sequence does not depend on
the strip, and the smaller kernel body compiles in a third of the time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import build as jbuild
from mitsuba_tpu.accel.traverse import DeviceBVH, bvh_closest_hit
from mitsuba_tpu.ops import pallas_bvh as jpb
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch import native
from mitsuba_tpu_torch.accel import build as tbuild
from mitsuba_tpu_torch.ops import cuda_bvh as cb

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

TOL = {"t": dict(rtol=1e-5, atol=1e-6), "u": dict(rtol=1e-5, atol=1e-5),
       "v": dict(rtol=1e-5, atol=1e-5)}
OUT = ("hit", "t", "idx", "u", "v")
BVH_FIELDS = ("lo", "hi", "skip", "prim_first", "prim_count", "prim_order")


def _mesh(T, seed, size=0.3):
    """A random triangle soup (tests/test_accel.py:random_mesh)."""
    rs = np.random.default_rng(seed)
    p0 = rs.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rs.normal(0, size, (T, 3)).astype(np.float32)
    e2 = rs.normal(0, size, (T, 3)).astype(np.float32)
    return p0, e1, e2


def _rays(R, seed, t_max=np.inf):
    """Rays from [-2, 2]^3 (tests/test_accel.py) aimed at points of the
    soup's box, so that most of them hit; a tenth of them dead
    (t_max = t_min) as the integrator sends them."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = (rs.uniform(-1, 1, (R, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(R, 1e-4, np.float32)
    t_max = np.full(R, t_max, np.float32)
    dead = rs.random(R) < 0.1
    t_max[dead] = t_min[dead]
    return o, d, t_min, t_max


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.fixture(scope="module")
def soup():
    """600 triangles and 1024 rays (the sizes of tests/test_accel.py's
    resort test), the JAX tree and its two packings."""
    p0, e1, e2 = _mesh(600, 21)
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    bvh = jbuild.build_bvh(lo, hi, leaf_size=1)
    N = len(bvh.lo)
    pages = jpb.pack_pages(bvh, p0, e1, e2)
    nodes = cb.pack_nodes(bvh, p0, e1, e2)
    return dict(tris=(p0, e1, e2), bvh=bvh, N=N, pages=pages,
                nodes=torch.from_numpy(nodes), octants=cb.octant_tables(nodes),
                lo=lo.min(0), hi=hi.max(0), rays=_rays(1024, 22))


def _compare(out, ref, field):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, field
    if field in ("hit", "idx"):
        np.testing.assert_array_equal(out, ref, err_msg=field)
    else:
        np.testing.assert_allclose(out, ref, err_msg=field, **TOL[field])


# --- builder --------------------------------------------------------------

@pytest.fixture(scope="module")
def builds():
    """Both packages' trees on a 600-triangle soup (numpy route) and a
    50x50 heightfield of 4,802 triangles (native route)."""
    p0, e1, e2 = _mesh(600, 5)
    soup_box = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    h = np.sin(np.linspace(0, 8, 50))[:, None] * np.cos(
        np.linspace(0, 8, 50))[None, :] * 0.02
    v, f, _ = jshapes.heightfield(h, extent=(0.3, 0.3))
    assert len(f) >= tbuild.NATIVE_MIN_PRIMS
    hf_box = jbuild.triangle_aabbs(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    return {route: (jbuild.build_bvh(*box, leaf_size=1),
                    tbuild.build_bvh(*box))
            for route, box in (("numpy", soup_box), ("native", hf_box))}


@pytest.mark.parametrize("field", BVH_FIELDS)
@pytest.mark.parametrize("route", ["numpy", "native"])
def test_builder_matches_jax(builds, route, field):
    ref, out = (getattr(b, field) for b in builds[route])
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent numpy fallback for a large mesh: a failed build raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    box = np.zeros((5000, 3)), np.ones((5000, 3))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbuild.build_bvh(*box)


# --- packer and sort keys -------------------------------------------------

def test_packer_matches_pages(soup):
    """pack_nodes holds what pack_pages holds, node-major."""
    out = soup["nodes"].numpy()
    ref = bridge.nodes_from_pages(soup["pages"], soup["N"])
    assert out.shape == (soup["N"], cb.NODE_COLS)
    np.testing.assert_array_equal(out, ref)


def test_packer_rejects_fat_leaves(soup):
    p0, e1, e2 = soup["tris"]
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    with pytest.raises(ValueError, match="leaf_size=1"):
        cb.pack_nodes(jbuild.build_bvh(lo, hi, leaf_size=4), p0, e1, e2)


def test_ray_sort_keys_match_jax(soup):
    o, d, _, _ = soup["rays"]
    o = o * 1.5  # some origins outside the scene box: clamped
    ref = np.asarray(jax.jit(jpb.ray_sort_keys)(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(soup["lo"]),
        jnp.asarray(soup["hi"])))
    out = cb.ray_sort_keys(*_t(o, d), *_t(soup["lo"].astype(np.float32),
                                          soup["hi"].astype(np.float32)))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


# --- K4 and K3 against the Pallas kernels (interpret mode) ----------------

@pytest.fixture(scope="module")
def k4(soup):
    """The Pallas K4 (closest hit), the port's K4 and the canonical plain
    walk on the soup's rays."""
    o, d, t_min, t_max = soup["rays"]
    ref = jpb.bvh_traverse_lane_packed(
        jnp.asarray(soup["pages"]), soup["N"], *(jnp.asarray(x) for x in
                                                 (o, d, t_min, t_max)),
        interpret=True, strip=1)
    rays = _t(o, d, t_min, t_max)
    out = cb.bvh_traverse_lane_packed(soup["nodes"], soup["N"], *rays)
    canonical = cb.canonical_walk_plain(soup["nodes"], soup["N"], *rays)
    return ref, out, canonical


@pytest.fixture(scope="module")
def resort_queries(soup):
    """{any_hit: (Pallas, port)} of the resort query (rounds=2, chunk_nit=3:
    lanes resume mid-walk) on the port's K3 plain version and on the Pallas
    _lane_chunk, closest and any-hit, on the soup's rays with t_min = 0 and
    t_max = inf; and under "k4 any_hit" the port's any-hit K4 on the same
    rays."""
    o, d, _, _ = soup["rays"]
    R = len(o)
    t_min, t_max = np.zeros(R, np.float32), np.full(R, np.inf, np.float32)
    out = {}
    for any_hit in (False, True):
        ref = jpb.bvh_traverse_lane_resort(
            jnp.asarray(soup["pages"]), soup["N"],
            *(jnp.asarray(x) for x in (o, d, t_min, t_max, soup["lo"],
                                       soup["hi"])),
            any_hit=any_hit, strip=1, rounds=2, chunk_nit=3, interpret=True)
        out[any_hit] = ref, cb.bvh_traverse_lane_resort(
            soup["nodes"], soup["N"], *_t(o, d, t_min, t_max),
            *_t(soup["lo"].astype(np.float32), soup["hi"].astype(np.float32)),
            any_hit=any_hit, strip=1, rounds=2, chunk_nit=3,
            octants=soup["octants"])
    out["k4 any_hit"] = cb.bvh_traverse_lane_packed(
        soup["nodes"], soup["N"], *_t(o, d, t_min, t_max), any_hit=True)
    return out


# the closest-hit cases keep their ids
K4_CASES = [pytest.param(False, f, id=f) for f in OUT] + [
    pytest.param(True, f, id=f"any_hit-{f}") for f in OUT]


@pytest.mark.parametrize("any_hit,field", K4_CASES)
def test_k4_plain_matches_pallas(k4, resort_queries, any_hit, field):
    """Closest hit: K4 against the Pallas K4. Any-hit: the first hit in
    canonical order, against the Pallas resort query's any-hit on the same
    rays (this module's one any-hit compile; the canonical walk's first hit
    does not depend on how the walk is chunked)."""
    i = OUT.index(field)
    if any_hit:
        ref, out = resort_queries[True][0], resort_queries["k4 any_hit"]
    else:
        ref, out, _ = k4
    _compare(out[i].numpy(), ref[i], field)


@pytest.mark.parametrize("field", OUT)
def test_canonical_walk_matches_pallas(k4, field):
    """The yardstick of the octant walks: the canonical plain walk is the
    Pallas K4's walk."""
    ref, _, canonical = k4
    i = OUT.index(field)
    _compare(canonical[i].numpy(), ref[i], field)


def test_k4_rays_cover_hits_misses_and_dead_lanes(soup, k4):
    _, (hit, *_), _ = k4
    _, _, t_min, t_max = soup["rays"]
    assert 0.3 < hit.float().mean() < 0.95
    assert not hit.numpy()[t_max == t_min].any()


@pytest.fixture(scope="module", params=[False, True], ids=["closest", "any_hit"])
def k3(resort_queries, request):
    """The resort query of ``resort_queries`` of one query kind."""
    return resort_queries[request.param]


@pytest.mark.parametrize("field", OUT)
def test_k3_plain_matches_pallas(k3, field):
    """Closest hit, and for any-hit the first hit found: the same node order
    gives the same first hit, not just the same occlusion."""
    ref, out = k3
    i = OUT.index(field)
    _compare(out[i].numpy(), ref[i], field)


# --- octant tables ----------------------------------------------------------

def _preorder(table):
    """The rows of a threaded table in the order a depth-first walk from the
    root reaches them (left child n + 1, right child skip[n + 1]), each with
    the row after its subtree; raises where the threading is broken."""
    N = table.shape[0]
    skip = table[:, 3].astype(np.int64)
    leaf = table[:, 7] >= 0
    order, after = [], {}

    def visit(n):
        order.append(n)
        if not leaf[n]:
            r = skip[n + 1]
            visit(n + 1)
            assert order[-1] < r and len(order) == r, "left subtree not contiguous"
            visit(r)
        after[n] = len(order)

    visit(0)
    assert order == list(range(N))
    return np.asarray([after[n] for n in range(N)])


@pytest.fixture(scope="module")
def octant_tables(soup):
    roots = jbuild.treelet_roots(soup["bvh"], max_nodes=128, max_roots=64)
    return roots, cb.pack_nodes_octants(soup["nodes"].numpy(), roots)


@pytest.mark.parametrize("octant", range(cb.OCTANTS))
def test_octant_table_threads_the_same_tree_near_child_first(
        soup, octant_tables, octant):
    """Table o holds the canonical rows (leaves with their canonical row in
    column 11), threaded depth first (every subtree contiguous, skip = the
    row after it), each internal row's near child first by the centre
    projection on o's signs, the left (lower canonical rows) on a tie; and
    each treelet's range covers the same rows as its canonical range."""
    nodes = soup["nodes"].numpy()
    N = nodes.shape[0]
    roots, (tables, leaf_row, tl_range) = octant_tables
    table = tables[octant]
    leaf = table[:, 7] >= 0
    canon = table[leaf, 11].astype(np.int64)
    np.testing.assert_array_equal(leaf_row[table[leaf, 7].astype(np.int64)],
                                  canon)
    np.testing.assert_array_equal(np.delete(table[leaf], [3, 11], axis=1),
                                  np.delete(nodes[canon], [3, 11], axis=1))
    assert not table[~leaf, 11].any()
    internal = lambda x: np.delete(x[x[:, 7] < 0], 3, axis=1)  # noqa: E731
    np.testing.assert_array_equal(np.unique(internal(table), axis=0),
                                  np.unique(internal(nodes), axis=0))
    after = _preorder(table)
    np.testing.assert_array_equal(table[:, 3], after)
    # near child first: centre projection on the octant's signs, ties to the
    # subtree of lower canonical leaf rows (the canonical left child)
    s = cb.octant_signs()[octant]
    a, b, c = (table[:, k:k + 3].astype(np.float64) for k in (0, 4, 8))
    proj = np.where(leaf[:, None], a + (b + c) / 3.0, (a + b) / 2.0) @ s
    low = np.where(leaf, table[:, 11], np.inf)
    for n in range(N - 1, -1, -1):     # children come after their parent
        if not leaf[n]:
            low[n] = min(low[n + 1], low[after[n + 1]])
    for n in np.nonzero(~leaf)[0]:
        near, far = n + 1, after[n + 1]
        assert proj[near] < proj[far] or (proj[near] == proj[far]
                                          and low[near] < low[far])
    # treelet ranges: the same rows as the canonical subtree, contiguous
    for k, r in enumerate(roots):
        start, end = tl_range[octant, k]
        assert end - start == soup["bvh"].skip[r] - r == after[start] - start
        rows = table[start:end]
        ref = nodes[r:soup["bvh"].skip[r]]
        np.testing.assert_array_equal(
            np.unique(np.delete(rows, [3, 11], axis=1), axis=0),
            np.unique(np.delete(ref, [3, 11], axis=1), axis=0))


def test_octant_tables_from_the_bridge_equal_the_builders(soup):
    """The bridge rebuilds the canonical table from the JAX pages; the
    octant tables depend on nothing else, so both routes give equal ones."""
    roots = jbuild.treelet_roots(soup["bvh"], max_nodes=128, max_roots=64)
    out = cb.pack_nodes_octants(bridge.nodes_from_pages(soup["pages"],
                                                        soup["N"]), roots)
    ref = cb.pack_nodes_octants(soup["nodes"].numpy(), roots)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tie_grid():
    """A tie-heavy mesh of 600 triangles (the soup's count, so the same
    Pallas compile serves it): two overlapping planar grids of 15 x 10
    quads of side 1/8 at z = 0 and z = 1/2, split along alternating
    diagonals; and 1,024 rays aimed at their vertices and edge midpoints
    along dyadic directions of all eight octants. Every coordinate has a
    few bits, so each ray hits the triangles around its target at exactly
    the same t (up to six at a vertex, two on an edge)."""
    h = 1 / 8
    tris = []
    for z, x0, y0 in ((0.0, 0.0, 0.0), (0.5, 0.5, 0.25)):
        for i in range(15):
            for j in range(10):
                a = np.array([x0 + i * h, y0 + j * h, z])
                b, c, d = a + [h, 0, 0], a + [h, h, 0], a + [0, h, 0]
                tris += ([(a, b, c), (a, c, d)] if (i + j) % 2
                         else [(a, b, d), (b, c, d)])
    t = np.asarray(tris)
    p0, e1, e2 = (x.astype(np.float32) for x in (t[:, 0], t[:, 1] - t[:, 0],
                                                 t[:, 2] - t[:, 0]))
    rs = np.random.default_rng(31)
    R = 1024
    layer = rs.integers(0, 2, R)
    target = np.stack([(rs.integers(0, 31, R) / 16 + 0.5 * layer),
                       (rs.integers(0, 21, R) / 16 + 0.25 * layer),
                       0.5 * layer], axis=1)
    d = np.stack([rs.choice([-1 / 4, -1 / 8, 0.0, 1 / 8, 1 / 4], R),
                  rs.choice([-1 / 4, -1 / 16, 0.0, 1 / 16, 1 / 4], R),
                  rs.choice([-1.0, 1.0], R)], axis=1)
    o = (target - 2 * d).astype(np.float32)
    return (p0, e1, e2), (o, d.astype(np.float32))


@pytest.fixture(scope="module")
def tie_grid():
    """The grid's tree and octant tables, and three closest-hit queries on
    it: the port's resort query over the octant tables (K3's plain version,
    mid-walk resumes), the Pallas resort query in interpret mode (the
    soup's compile: rounds=2, chunk_nit=3, strip=1) and the XLA walk."""
    (p0, e1, e2), (o, d) = _tie_grid()
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    bvh = jbuild.build_bvh(lo, hi, leaf_size=1)
    N = len(bvh.lo)
    nodes = cb.pack_nodes(bvh, p0, e1, e2)
    R = len(o)
    t_min, t_max = np.zeros(R, np.float32), np.full(R, np.inf, np.float32)
    bounds = (lo.min(0), hi.max(0))
    ref = jpb.bvh_traverse_lane_resort(
        jnp.asarray(jpb.pack_pages(bvh, p0, e1, e2)), N,
        *(jnp.asarray(x) for x in (o, d, t_min, t_max, *bounds)),
        strip=1, rounds=2, chunk_nit=3, interpret=True)
    xla = jax.jit(bvh_closest_hit)(DeviceBVH.from_host(bvh, p0, e1, e2),
                                   *(jnp.asarray(x) for x in (o, d, t_min,
                                                              t_max)))
    octants = cb.octant_tables(nodes)
    args = (torch.from_numpy(nodes), N, *_t(o, d, t_min, t_max, *bounds))
    # the octant walk without the tie rule: no leaf row is below -1
    no_tie = octants._replace(leaf_row=torch.full_like(octants.leaf_row, -1))
    queries = {
        "k3": lambda oc: cb.bvh_traverse_lane_resort(
            *args, strip=1, rounds=2, chunk_nit=3, octants=oc),
        # K4 from the root on the rays as they come (a presorted query),
        # over the canonical table
        "k4": lambda oc: cb.bvh_traverse_lane(*args, sort=False),
        # K5 from the root; K6 bounded (3 visits), re-sorted and resumed
        "k5": lambda oc: cb.bvh_traverse_lane_hbm(*args, sort=True,
                                                  octants=oc),
        "k6": lambda oc: cb.bvh_traverse_lane_hbm_resort(
            *args, strip=1, rounds=2, chunk_nit=3, octants=oc),
    }
    return dict(ref=[np.asarray(x) for x in ref],
                xla=[np.asarray(x) for x in xla],
                out={k: q(octants) for k, q in queries.items()},
                first={k: q(no_tie) for k, q in queries.items()})


# K3's cases keep their ids; K5's and K6's walk the same octant tables, K4's
# the canonical table
TIE_CASES = [pytest.param("k3", f, id=f) for f in OUT] + [
    pytest.param(k, f, id=f"{k}-{f}") for k in ("k5", "k6", "k4")
    for f in OUT]


@pytest.mark.parametrize("kernel,field", TIE_CASES)
def test_k3_octant_walk_keeps_the_canonical_tie_break(tie_grid, kernel, field):
    """On exact ties the octant walk's result (K3's resort query, K5's
    query from the root, K6's bounded and resumed resort query) is the JAX
    kernel's and the XLA walk's (the first of the tied triangles in
    canonical order), bit for bit, idx included; without the tie rule it
    would not be. So is K4's, which walks the canonical table (it has no
    tie rule to take away)."""
    i = OUT.index(field)
    out = tie_grid["out"][kernel][i].numpy()
    np.testing.assert_array_equal(out, tie_grid["ref"][i], err_msg=field)
    np.testing.assert_array_equal(out, tie_grid["xla"][i], err_msg=field)
    if field == "hit":
        assert out.mean() > 0.9
    if field == "idx" and kernel != "k4":
        assert (tie_grid["first"][kernel][2].numpy() != out).sum() > 20


# --- K5 and K6 against the XLA walk ---------------------------------------

@pytest.fixture(scope="module")
def big_soup():
    """1500 triangles and 1024 rays (tests/test_accel.py:277-391), with the
    XLA walk over the same leaf_size=1 tree as the reference."""
    rs = np.random.default_rng(3)
    T = 1500
    p0 = rs.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rs.uniform(-0.15, 0.15, (T, 3)).astype(np.float32)
    e2 = rs.uniform(-0.15, 0.15, (T, 3)).astype(np.float32)
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    bvh = jbuild.build_bvh(lo, hi, leaf_size=1)
    R = 1024
    # rays aimed into the soup, so most of them hit
    o = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = (rs.uniform(-0.8, 0.8, (R, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min, t_max = np.full(R, 1e-4, np.float32), np.full(R, 1e9, np.float32)
    ref = jax.jit(bvh_closest_hit)(DeviceBVH.from_host(bvh, p0, e1, e2),
                                   *(jnp.asarray(x) for x in (o, d, t_min,
                                                              t_max)))
    nodes = cb.pack_nodes(bvh, p0, e1, e2)
    bounds = _t(lo.min(0).astype(np.float32), hi.max(0).astype(np.float32))
    return dict(ref=[np.asarray(x) for x in ref],
                nodes=torch.from_numpy(nodes), octants=cb.octant_tables(nodes),
                N=len(bvh.lo), rays=_t(o, d, t_min, t_max), bounds=bounds)


@pytest.mark.parametrize("kernel", ["k5", "k6"])
def test_k5_k6_plain_match_xla(big_soup, kernel):
    nodes, N, rays, bounds, octants = (big_soup[k] for k in (
        "nodes", "N", "rays", "bounds", "octants"))
    if kernel == "k5":
        out = cb.bvh_traverse_lane_hbm(nodes, N, *rays, *bounds, sort=True,
                                       octants=octants)
    else:
        out = cb.bvh_traverse_lane_hbm_resort(nodes, N, *rays, *bounds,
                                              rounds=2, chunk_nit=6,
                                              octants=octants)
    hit, t, idx = (x.numpy() for x in out[:3])
    h_x, t_x, i_x = big_soup["ref"][:3]
    assert 0.3 < hit.mean()
    np.testing.assert_array_equal(hit, h_x)
    np.testing.assert_allclose(t[hit], t_x[hit], rtol=1e-4)
    assert (idx[hit] == i_x[hit]).mean() > 0.99


def test_k5_k6_run_k4_k3_arithmetic(big_soup):
    """K5's plain version is K3's plain octant walk from the root, unbounded,
    for closest hits and K4's, the canonical walk, for any-hit queries; K6's
    is K3's own, for both query kinds and any budget. (On the card K5 and
    K6 differ from them only by their schedule.)"""
    nodes, N, rays, octants = (big_soup[k] for k in ("nodes", "N", "rays",
                                                     "octants"))
    lanes, root = _lanes(*rays, N)
    t, idx, u, v, _ = cb.lane_chunk_plain(nodes, N, *lanes, *root,
                                          octants=octants)
    hit = idx >= 0
    k3 = (hit, torch.where(hit, t, torch.inf), idx, u, v)
    for a, b in zip(cb.lane_hbm_plain(nodes, N, *rays, octants=octants), k3):
        assert torch.equal(a, b)
    for a, b in zip(cb.lane_hbm_plain(nodes, N, *rays, any_hit=True),
                    cb.bvh_traverse_lane_packed_plain(nodes, N, *rays,
                                                      any_hit=True)):
        assert torch.equal(a, b)
    assert cb.bvh_traverse_lane_packed_plain is cb.canonical_walk_plain
    assert cb.lane_chunk_hbm_plain is cb.lane_chunk_plain


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_k6_resort_query_equals_one_walk(big_soup, monkeypatch, any_hit):
    """The K6 resort query (launches of 4 visits, each followed by a re-sort
    by node pointer, a row of the lane's own octant table for a closest-hit
    lane, retired lanes last) gives bit for bit the result of one unbounded
    plain walk from the root on the same rays, and every launch after the
    first sees its lanes in that order."""
    nodes, N, rays, bounds, octants = (big_soup[k] for k in (
        "nodes", "N", "rays", "bounds", "octants"))
    keys = []
    chunk = cb.lane_chunk_hbm

    def spy(nodes, N, ox, oy, oz, dx, dy, dz, t_min, node, *rest, **kw):
        keys.append(node)
        return chunk(nodes, N, ox, oy, oz, dx, dy, dz, t_min, node, *rest, **kw)

    monkeypatch.setattr(cb, "lane_chunk_hbm", spy)
    res = cb.bvh_traverse_lane_hbm_resort(nodes, N, *rays, *bounds,
                                          any_hit=any_hit, strip=1, rounds=3,
                                          chunk_nit=4, octants=octants)
    ref = cb.lane_hbm_plain(nodes, N, *rays, any_hit=any_hit, octants=octants)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    assert len(keys) == 4
    for key in keys[1:]:
        assert bool((key[1:] >= key[:-1]).all())
    assert int((keys[-1] < N).sum()) > 0


# --- the schedule does not change the result ------------------------------

def _lanes(o, d, t_min, t_max, N):
    """The resumable kernels' rays (one array per component) and their
    state at the root."""
    R = o.shape[0]
    rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3)) + (t_min,)
    state = (torch.where(t_max > t_min, 0, N).to(torch.int32), t_max,
             torch.full((R,), -1, dtype=torch.int32), torch.zeros(R),
             torch.zeros(R))
    return rays, state


def _chunk_args(soup, n=None):
    return _lanes(*_t(*(x[:n] for x in soup["rays"])), soup["N"])


def _bounds(soup):
    return _t(soup["lo"].astype(np.float32), soup["hi"].astype(np.float32))


@pytest.fixture(scope="module", params=[False, True], ids=["closest", "any_hit"])
def unbounded(soup, request):
    """One unbounded K3 launch and one unsorted root query on 256 rays, which
    every budget's runs must end on."""
    any_hit = request.param
    nodes, N = soup["nodes"], soup["N"]
    rays, state = _chunk_args(soup, 256)
    full = cb.lane_chunk(nodes, N, *rays, *state, any_hit=any_hit,
                         octants=soup["octants"])
    o, d, t_min, t_max = _t(*(x[:256] for x in soup["rays"]))
    ref = cb.bvh_traverse_lane(nodes, N, o, d, t_min, t_max, *_bounds(soup),
                               sort=False, any_hit=any_hit)
    return any_hit, full, ref


@pytest.mark.parametrize("budget", [1, 7, 40])
def test_budgeted_walk_equals_unbounded(soup, unbounded, budget):
    """K3 resumed launch after launch with ``budget`` visits each ends where
    one unbounded launch ends, bit for bit; so does the resort query."""
    any_hit, full, ref = unbounded
    rays, state = _chunk_args(soup, 256)
    nodes, N = soup["nodes"], soup["N"]
    launches = 0
    while bool((state[0] < N).any()):
        t, i, u, v, node = cb.lane_chunk(nodes, N, *rays, *state,
                                         any_hit=any_hit, max_steps=budget,
                                         octants=soup["octants"])
        state = (node, t, i, u, v)
        launches += 1
        assert launches < 10_000
    assert launches > 1
    for a, b in zip((state[1], state[2], state[3], state[4], state[0]), full):
        assert torch.equal(a, b)
    o, d, t_min, t_max = _t(*(x[:256] for x in soup["rays"]))
    res = cb.bvh_traverse_lane_resort(nodes, N, o, d, t_min, t_max,
                                      *_bounds(soup), any_hit=any_hit,
                                      rounds=3, chunk_nit=budget, strip=1,
                                      octants=soup["octants"])
    for a, b in zip(res, ref):
        assert torch.equal(a, b)


def test_visit_counts_add_up(soup):
    """with_visits counts every step of a lane once, a budget caps it, and
    the nodes read are marked."""
    rays, state = _chunk_args(soup)
    nodes, N = soup["nodes"], soup["N"]
    *_, node, (v_int, v_leaf, touched, _) = cb.lane_chunk_plain(
        nodes, N, *rays, *state, max_steps=5, with_visits=True,
        octants=soup["octants"])
    live = state[0] < N
    assert int((v_int + v_leaf)[~live].sum()) == 0
    assert int((v_int + v_leaf).max()) == 5
    assert torch.equal((v_int + v_leaf < 5) & live, live & (node >= N))
    assert bool(touched[0]) and int(touched.sum()) <= int((v_int + v_leaf).sum())


# --- wrappers ---------------------------------------------------------------

def test_cpu_calls_run_plain_and_count_no_launch(soup):
    o, d, t_min, t_max = _t(*(x[:256] for x in soup["rays"]))
    rays, state = _chunk_args(soup, 256)
    wrappers = (cb.bvh_traverse_lane_packed, cb.lane_hbm, cb.lane_chunk,
                cb.lane_chunk_hbm)
    before = [w.launches for w in wrappers]
    a = cb.bvh_traverse_lane_packed(soup["nodes"], soup["N"], o, d, t_min, t_max)
    b = cb.lane_hbm(soup["nodes"], soup["N"], o, d, t_min, t_max,
                    octants=soup["octants"])
    c = cb.lane_chunk(soup["nodes"], soup["N"], *rays, *state,
                      octants=soup["octants"])
    e = cb.lane_chunk_hbm(soup["nodes"], soup["N"], *rays, *state,
                          octants=soup["octants"])
    assert [w.launches for w in wrappers] == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(c, e):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad,error", [
    ("nodes_f64", TypeError), ("nodes_shape", ValueError),
    ("n_nodes", ValueError), ("o_strided", ValueError), ("t_min_len", ValueError),
    ("idx_dtype", TypeError), ("max_steps", ValueError),
])
def test_wrappers_check_inputs_on_the_cpu_too(soup, bad, error):
    nodes, N = soup["nodes"], soup["N"]
    o, d, t_min, t_max = _t(*soup["rays"])
    rays, (node, t, i, u, v) = _chunk_args(soup)
    root = dict(nodes=nodes, n_nodes=N, o=o, d=d, t_min=t_min, t_max=t_max)
    chunk = dict(max_steps=0)
    if bad == "nodes_f64":
        root["nodes"] = nodes.double()
    elif bad == "nodes_shape":
        root["nodes"] = nodes[:, :11].contiguous()
    elif bad == "n_nodes":
        root["n_nodes"] = N + 1
    elif bad == "o_strided":
        root["o"] = torch.cat([o, o], dim=1)[:, ::2]
    elif bad == "t_min_len":
        root["t_min"] = t_min[:-1]
    elif bad == "idx_dtype":
        i = i.long()
    elif bad == "max_steps":
        chunk["max_steps"] = -1
    with pytest.raises(error):
        if bad in ("idx_dtype", "max_steps"):
            cb.lane_chunk(nodes, N, *rays, node, t, i, u, v,
                          octants=soup["octants"], **chunk)
        else:
            cb.bvh_traverse_lane_packed(**root)


def test_k5_k6_closest_hit_needs_octants(soup):
    """A closest-hit K5 or K6 call without the octant tables raises (on the
    CPU too), as do their plain versions; an any-hit call needs none."""
    nodes, N = soup["nodes"], soup["N"]
    o, d, t_min, t_max = _t(*(x[:64] for x in soup["rays"]))
    rays, state = _chunk_args(soup, 64)
    for call in (lambda **k: cb.lane_hbm(nodes, N, o, d, t_min, t_max, **k),
                 lambda **k: cb.lane_hbm_plain(nodes, N, o, d, t_min, t_max,
                                               **k),
                 lambda **k: cb.lane_chunk_hbm(nodes, N, *rays, *state, **k),
                 lambda **k: cb.lane_chunk_hbm_plain(nodes, N, *rays, *state,
                                                     **k)):
        with pytest.raises(ValueError, match="pass octants"):
            call()
        assert call(any_hit=True)[0].shape == (64,)
    with pytest.raises(ValueError, match="pass octants"):
        cb.bvh_traverse_lane_hbm(nodes, N, o, d, t_min, t_max, *_bounds(soup),
                                 sort=True)



def test_wrappers_reject_other_devices(soup):
    meta = soup["nodes"].to("meta")
    o = torch.zeros((4, 3), device="meta")
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no BVH traversal"):
        cb.bvh_traverse_lane_packed(meta, soup["N"], o, o, t, t)
