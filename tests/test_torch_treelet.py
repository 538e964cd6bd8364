"""Port parity, treelet slice: the treelet cut, the leaf-4 builder, the copied
packers and bridge conversions, the plain versions of K7 (treelet rounds), K8
(leaf-4 trees) and K9 (wide pages) against the JAX package on the CPU, the mesh
loaders, the treelet dispatch of a render and ``mtsutil kdbench``.

Tolerances:
  * treelet cut, builder, packers, bridge, sort keys and loaders: exact (the
    same arithmetic on the same inputs, copied code);
  * K7, K8 and K9 against the Pallas kernels in interpret mode: hit and idx
    exact (both walk the same nodes in the same order with the same strict
    comparisons; K8's near-first closest-hit walk keeps the canonical
    walk's triangle by its tie rule), t to rtol 1e-5 / atol 1e-6 and u, v to atol 1e-5 (XLA on
    the CPU contracts a*b+c into FMAs where the plain versions round every
    operation; measured up to 6e-6 on t);
  * K7's and K9's plain versions against K4's and K3's on the same tree: bit
    for bit where the contract fixes the result (closest t and hit, K9's
    every output); K7's idx may differ from K4's only where t ties;
  * K9's octant wide pages against the octant tables' rows, and K8's split
    tables against the fat rows: exact;
  * K8's walk over its split tables (closest hit near first, with the
    slot-index tie rule) against the JAX walk over the fat rows, on the
    soup and on a tie-heavy mesh: bit for bit (the same operations in the
    same order on the same values, and the tie rule keeps the canonical
    walk's triangle);
  * the treelet render against the port's lane render of the same scene:
    bit for bit (the same closest hits; the lane render's agreement with the
    JAX render is tests/test_torch_bunny.py's).

The Pallas calls run at a small strip (a lane's node sequence does not depend
on it) so that interpret mode compiles in seconds.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import build as jbuild
from mitsuba_tpu.io import mesh as jmesh
from mitsuba_tpu.ops import pallas_bvh as jpb
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch import bridge, mtsutil
from mitsuba_tpu_torch.accel import build as tbuild
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import mesh as tmesh
from mitsuba_tpu_torch.ops import cuda_bvh as cb
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from test_torch_bvh import _preorder, _tie_grid

TOL = {"t": dict(rtol=1e-5, atol=1e-6), "u": dict(rtol=1e-5, atol=1e-5),
       "v": dict(rtol=1e-5, atol=1e-5)}
OUT = ("hit", "t", "idx", "u", "v")
BVH_FIELDS = ("lo", "hi", "skip", "prim_first", "prim_count", "prim_order")


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _compare(out, ref, field):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, field
    if field in ("hit", "idx"):
        np.testing.assert_array_equal(out, ref, err_msg=field)
    else:
        np.testing.assert_allclose(out, ref, err_msg=field, **TOL[field])


@pytest.fixture(scope="module")
def soup():
    """600 triangles and 1,024 rays (tests/test_torch_bvh.py's soup): the
    leaf-1 tree with its treelet cut (max_nodes 256, at most 64 roots) and
    every packing, and the leaf-4 tree with its fat rows and K8's split
    tables."""
    rs = np.random.default_rng(21)
    p0 = rs.uniform(-1, 1, (600, 3)).astype(np.float32)
    e1 = rs.normal(0, 0.3, (600, 3)).astype(np.float32)
    e2 = rs.normal(0, 0.3, (600, 3)).astype(np.float32)
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    bvh = jbuild.build_bvh(lo, hi, leaf_size=1)
    roots = jbuild.treelet_roots(bvh, max_nodes=256, max_roots=64)
    rs = np.random.default_rng(22)
    R = 1024
    o = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = (rs.uniform(-1, 1, (R, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(R, 1e-4, np.float32)
    t_max = np.full(R, np.inf, np.float32)
    dead = rs.random(R) < 0.1   # inactive lanes, as the integrator sends them
    t_max[dead] = t_min[dead]
    bvh4 = jbuild.build_bvh(lo, hi, leaf_size=4)
    tl = (roots, bvh.skip[roots].astype(np.int32), bvh.lo[roots],
          bvh.hi[roots])
    nodes = cb.pack_nodes(bvh, p0, e1, e2)
    octants = cb.octant_tables(nodes, roots)
    fat = torch.from_numpy(cb.pack_nodes_fat(bvh4, p0, e1, e2))
    return dict(
        tris=(p0, e1, e2), box=(lo, hi), bvh=bvh, N=len(bvh.lo), tl=tl,
        nodes=torch.from_numpy(nodes), octants=octants,
        wide=cb.wide_octant_pages(octants),
        slim=jpb.pack_nodes_slim(bvh, p0, e1, e2),
        bvh4=bvh4, fat=fat, tables=cb.fat_tables(fat),
        pages_w=torch.from_numpy(cb.pack_pages_w(bvh, p0, e1, e2)),
        bounds=(lo.min(0).astype(np.float32), hi.max(0).astype(np.float32)),
        rays=(o, d, t_min, t_max))


# --- treelet cut, builder, packers, bridge -----------------------------------

@pytest.mark.parametrize("max_nodes,max_roots", [(256, 64), (64, 4)])
def test_treelet_roots_match_jax(soup, max_nodes, max_roots):
    """(64, 4) doubles max_nodes until at most four treelets remain."""
    ref = jbuild.treelet_roots(soup["bvh"], max_nodes, max_roots)
    out = tbuild.treelet_roots(soup["bvh"], max_nodes, max_roots)
    assert out.dtype == ref.dtype and 1 < len(out) <= max_roots
    np.testing.assert_array_equal(out, ref)
    if max_roots == 4:
        assert np.diff(np.r_[out, soup["N"]]).max() > max_nodes


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_leaf4_builder_matches_jax(soup, route):
    if route == "numpy":
        box = soup["box"]
    else:
        h = np.sin(np.linspace(0, 8, 50))[:, None] * np.cos(
            np.linspace(0, 8, 50))[None, :] * 0.02
        v, f, _ = jshapes.heightfield(h, extent=(0.3, 0.3))
        assert len(f) >= tbuild.NATIVE_MIN_PRIMS
        box = jbuild.triangle_aabbs(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    ref = jbuild.build_bvh(*box, leaf_size=4)
    out = tbuild.build_bvh(*box, leaf_size=4)
    assert ref.prim_count.max() == 4
    for field in BVH_FIELDS:
        a, b = getattr(out, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_pack_pages_w_matches_jax(soup):
    """The JAX wide pages are K9's table as they are."""
    ref = jpb.pack_pages_w(soup["bvh"], *soup["tris"])
    np.testing.assert_array_equal(soup["pages_w"].numpy(), ref)


def test_bridge_slim_rows_are_the_node_table(soup):
    """The rows K7 walks in the JAX package hold the port's node table."""
    out = bridge.nodes_from_slim(soup["slim"], soup["N"])
    np.testing.assert_array_equal(out, soup["nodes"].numpy())


def test_bridge_fat_rows_match_the_packer(soup):
    ref = jpb.pack_nodes(soup["bvh4"], *soup["tris"])
    np.testing.assert_array_equal(bridge.fat_from_rows(ref),
                                  soup["fat"].numpy())


def test_fat_packer_rejects_large_leaves(soup):
    lo, hi = soup["box"]
    with pytest.raises(ValueError, match="at most 4"):
        cb.pack_nodes_fat(jbuild.build_bvh(lo, hi, leaf_size=8), *soup["tris"])


def test_treelet_sort_keys_match_jax(soup):
    o, d, t_min, t_max = soup["rays"]
    tl_lo, tl_hi = soup["tl"][2:]

    def jax_key(o, d, t_min, t_max, tl_lo, tl_hi, lo, hi):
        sel0 = jpb._nearest_treelet(o, jpb._safe_inv3(d), t_min, t_max,
                                    tl_lo, tl_hi)
        key = (sel0.astype(jnp.uint32) << jnp.uint32(24)) | (
            jpb.ray_sort_keys(o, d, lo, hi) >> jnp.uint32(8))
        return jnp.where(t_max <= t_min, jnp.uint32(0xFFFFFFFF), key)

    ref = np.asarray(jax.jit(jax_key)(*_j(o, d, t_min, t_max, tl_lo, tl_hi,
                                          *soup["bounds"])))
    out = cb.treelet_sort_keys(*_t(o, d, t_min, t_max, tl_lo, tl_hi,
                                   *soup["bounds"]))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))
    assert len(np.unique(ref >> 24)) > 2


# --- K7 ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["closest", "any_hit"])
def k7(soup, request):
    """The sorted treelet query through the port's query function (K7's plain
    version on the CPU) and through the Pallas kernel in interpret mode
    (slim rows, strip 4), as the JAX scene calls it."""
    any_hit = request.param
    o, d, t_min, t_max = soup["rays"]
    ref = jpb.bvh_traverse_treelets(
        jnp.asarray(soup["slim"]), *_j(*soup["tl"]),
        *_j(o, d, t_min, t_max, *soup["bounds"]), any_hit=any_hit,
        interpret=True, slim=True, strip=4)
    out = cb.bvh_traverse_treelets(soup["nodes"], *_t(*soup["tl"]),
                                   *_t(o, d, t_min, t_max, *soup["bounds"]),
                                   any_hit=any_hit, octants=soup["octants"])
    return any_hit, ref, out


@pytest.mark.parametrize("field", OUT)
def test_k7_plain_matches_pallas(k7, field):
    """Closest hit, and for any-hit the first hit found: the same treelet
    order and node order give the same first hit."""
    _, ref, out = k7
    i = OUT.index(field)
    _compare(out[i].numpy(), ref[i], field)


def test_k7_rays_cover_hits_misses_and_dead_lanes(soup, k7):
    _, _, (hit, *_) = k7
    _, _, t_min, t_max = soup["rays"]
    assert 0.3 < hit.float().mean() < 0.95
    assert not hit.numpy()[t_max == t_min].any()


@pytest.mark.parametrize("sort", [False, True], ids=["as_they_come", "sorted"])
def test_k7_closest_t_equals_k4(soup, sort):
    """The treelet order changes which nodes a lane visits, not the closest
    hit: t and hit equal K4's (the canonical walk's) bit for bit; idx
    differs only on a t tie."""
    o, d, t_min, t_max = _t(*(x[:256] for x in soup["rays"]))
    ref = cb.bvh_traverse_lane_packed(soup["nodes"], soup["N"], o, d, t_min,
                                      t_max)
    out = cb.bvh_traverse_treelets(soup["nodes"], *_t(*soup["tl"]), o, d,
                                   t_min, t_max, *_t(*soup["bounds"]),
                                   sort=sort, octants=soup["octants"])
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    differ = out[2] != ref[2]
    assert int(differ.sum()) <= 2


def test_k7_edge_cases(soup):
    """A single treelet that is a leaf, rays that miss every root box, and
    a lane whose t_max is below t_min."""
    p0, e1, e2 = soup["tris"]
    leaf = int(np.nonzero(soup["bvh"].prim_first >= 0)[0][0])
    tri = int(soup["bvh"].prim_order[soup["bvh"].prim_first[leaf]])
    tl = _t(np.asarray([leaf], np.int32), np.asarray([leaf + 1], np.int32),
            np.minimum(np.minimum(p0[tri], p0[tri] + e1[tri]),
                       p0[tri] + e2[tri])[None],
            np.maximum(np.maximum(p0[tri], p0[tri] + e1[tri]),
                       p0[tri] + e2[tri])[None])
    c = p0[tri] + (e1[tri] + e2[tri]) / 3   # the triangle's centroid
    o = np.asarray([c + [0, 0, 3], c + [0, 0, 3], [9, 9, 9], c + [0, 0, 3]],
                   np.float32)
    d = np.asarray([[0, 0, -1], [0, 0, -1], [1, 0, 0], [0, 0, -1]], np.float32)
    t_min = np.asarray([0, 0, 0, 5], np.float32)
    t_max = np.asarray([np.inf, 2.0, np.inf, 1.0], np.float32)
    tl_range = cb.pack_nodes_octants(soup["nodes"].numpy(), [leaf])[2]
    tab = cb.treelet_table(*tl, torch.from_numpy(tl_range))
    hit, t, idx, _, _ = cb.treelet_rounds(soup["nodes"], tab,
                                          *_t(o, d, t_min, t_max),
                                          octants=soup["octants"])
    assert hit.tolist() == [True, False, False, False]
    assert int(idx[0]) == tri and abs(float(t[0]) - 3.0) < 1e-4


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("list_size", [1, 2, cb.TREELET_LIST])
def test_k7_entry_list_equals_the_dense_rounds(soup, list_size, any_hit):
    """The kernel's selection (all root boxes tested once, the nearest
    ``list_size`` entered ones walked in (entry, index) order, then the
    dense rounds over the rest) walks the same treelets in the same order as
    _treelet_rounds' rounds: the same result and visits bit for bit. Lists
    of 1 and 2 overflow; a lane that does not overflow tests each root box
    once."""
    o, d, t_min, t_max = _t(*soup["rays"])
    tab = cb.treelet_table(*_t(*soup["tl"]), soup["octants"].tl_range)
    kw = dict(any_hit=any_hit, octants=soup["octants"], with_visits=True)
    ref = cb.treelet_rounds_plain(soup["nodes"], tab, o, d, t_min, t_max, **kw)
    out = cb.treelet_list_plain(soup["nodes"], tab, o, d, t_min, t_max,
                                list_size=list_size, **kw)
    for a, b in zip(out[:5] + out[5][:3], ref[:5] + ref[5][:3]):
        assert torch.equal(a, b)
    entered, live = out[5][5], t_max > t_min
    overflow = entered > list_size
    assert bool(overflow.any()) == (list_size < cb.TREELET_LIST)
    assert bool((out[5][3][live & ~overflow] == tab.shape[0]).all())


@pytest.fixture(scope="module")
def k7_tie_grid():
    """test_torch_bvh's tie-heavy grid through the treelet query: the port's
    (K7's plain version over the octant tables) and the Pallas kernel in
    interpret mode (the k7 fixture's compile: 8 treelets of the same row
    count)."""
    (p0, e1, e2), (o, d) = _tie_grid()
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    bvh = jbuild.build_bvh(lo, hi, leaf_size=1)
    roots = jbuild.treelet_roots(bvh, max_nodes=256, max_roots=64)
    tl = (roots, bvh.skip[roots].astype(np.int32), bvh.lo[roots],
          bvh.hi[roots])
    R = len(o)
    rays = (o, d, np.full(R, 1e-4, np.float32), np.full(R, np.inf, np.float32),
            lo.min(0), hi.max(0))
    ref = jpb.bvh_traverse_treelets(
        jnp.asarray(jpb.pack_nodes_slim(bvh, p0, e1, e2)), *_j(*tl),
        *_j(*rays), interpret=True, slim=True, strip=4)
    nodes = cb.pack_nodes(bvh, p0, e1, e2)
    out = cb.bvh_traverse_treelets(torch.from_numpy(nodes), *_t(*tl),
                                   *_t(*rays),
                                   octants=cb.octant_tables(nodes, roots))
    return len(roots), ref, out


@pytest.mark.parametrize("field", OUT)
def test_k7_octant_walks_keep_the_jax_tie_break(k7_tie_grid, field):
    """On exact ties K7's octant walks return the JAX rounds' triangle: the
    lowest canonical row within a treelet, the earlier treelet's across
    treelets."""
    K, ref, out = k7_tie_grid
    i = OUT.index(field)
    assert K > 1
    np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]),
                                  err_msg=field)


# --- K8 ----------------------------------------------------------------------

def _treelet_ranges(soup):
    """Per-ray [start, end): the fat tree's treelet roots, one per ray in
    turn, and a disabled lane (start == end) every 16th ray."""
    bvh4 = soup["bvh4"]
    roots = jbuild.treelet_roots(bvh4, max_nodes=64, max_roots=16)
    R = len(soup["rays"][0])
    k = np.arange(R) % len(roots)
    start = roots[k].astype(np.int32)
    end = bvh4.skip[roots][k].astype(np.int32)
    end[::16] = start[::16]
    return start, end


@pytest.fixture(scope="module", params=["closest", "any_hit_bounded"])
def k8(soup, request):
    """K8's plain version (over its split tables) and the Pallas kernel
    (interpret mode, strip 1) on the leaf-4 tree: closest hit over the
    whole tree, and any-hit within per-ray [start, end) treelet ranges (one
    compile covers both options)."""
    case = request.param
    o, d, t_min, t_max = soup["rays"]
    kw = dict(any_hit=case != "closest")
    bounds = _treelet_ranges(soup) if case != "closest" else (None, None)
    ref = jpb.bvh_traverse_packed(
        jnp.asarray(jpb.pack_nodes(soup["bvh4"], *soup["tris"])),
        *_j(o, d, t_min, t_max),
        *(None if b is None else jnp.asarray(b) for b in bounds),
        interpret=True, strip=1, **kw)
    out = cb.bvh_traverse_packed(
        soup["tables"], *_t(o, d, t_min, t_max),
        *(None if b is None else torch.from_numpy(b) for b in bounds), **kw)
    return case, ref, out


@pytest.mark.parametrize("field", OUT)
def test_k8_plain_matches_pallas(k8, field):
    _, ref, out = k8
    i = OUT.index(field)
    _compare(out[i].numpy(), ref[i], field)


def test_k8_sorted_query_equals_the_kernel(soup):
    """bvh_traverse (sort -> K8 -> unsort) gives what K8 gives on the rays
    as they come; bounding lanes to treelets hits less than the whole tree,
    and disabled lanes (start == end) never hit."""
    o, d, t_min, t_max = _t(*(x[:256] for x in soup["rays"]))
    ref = cb.bvh_traverse_packed(soup["tables"], o, d, t_min, t_max)
    out = cb.bvh_traverse(soup["tables"], o, d, t_min, t_max,
                          *_t(*soup["bounds"]))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    start, end = _t(*(x[:256] for x in _treelet_ranges(soup)))
    bounded = cb.bvh_traverse_packed(soup["tables"], o, d, t_min, t_max,
                                     start, end)
    assert 0 < int(bounded[0].sum()) < int(ref[0].sum())
    assert not bounded[0][::16].any()


def test_fat_tables_hold_the_fat_rows(soup):
    """The heads are the fat rows' first seven columns, bit for bit, and a
    word that names each leaf's slots (first << 3 | count, 0 on internal
    nodes); the slots are the fat rows' filled slots, bit for bit, in
    canonical leaf order, then slot order."""
    fat = soup["fat"].numpy()
    heads, tris, _ = (x.numpy() for x in soup["tables"])
    np.testing.assert_array_equal(heads[:, :7].view(np.int32),
                                  fat[:, :7].view(np.int32))
    word = heads[:, 7].view(np.int32)
    count = fat[:, 7].astype(np.int64)
    np.testing.assert_array_equal(word & 7, count)
    np.testing.assert_array_equal(word >> 3,
                                  np.where(count > 0, np.cumsum(count) - count,
                                           0))
    assert tris.shape == (int(count.sum()), cb.SLOT_COLS)
    for n in np.nonzero(count)[0]:
        first = word[n] >> 3
        np.testing.assert_array_equal(
            tris[first:first + count[n]].view(np.int32),
            fat[n, 8:].reshape(cb.FAT_LEAF_SIZE, -1)[:count[n]].view(np.int32))
    # every triangle in exactly one slot
    np.testing.assert_array_equal(np.sort(tris[:, 3]), np.arange(600))


@pytest.mark.parametrize("octant", range(cb.OCTANTS))
def test_fat_octant_heads_thread_the_same_tree_near_child_first(soup, octant):
    """Octant table o is a permutation of the canonical heads (skip links
    aside) threaded depth first, every skip the row after its subtree; each
    leaf keeps its word, so it points to the same slots, and each internal
    row's near child comes first by the box-centre projection on o's signs
    (the canonical left child on equal projections)."""
    heads, _, octs = (x.numpy() for x in soup["tables"])
    table = octs[octant]
    N = heads.shape[0]
    leaf = table[:, 7].view(np.int32) != 0
    shim = table.copy()
    shim[:, 7] = np.where(leaf, 0.0, -1.0)   # _preorder's leaf marker
    after = _preorder(shim)
    np.testing.assert_array_equal(table[:, 3], after)
    canon = {int(w): n for n, w in enumerate(heads[:, 7].view(np.int32))
             if w != 0}
    rows = np.asarray([canon[int(w)] for w in table[leaf, 7].view(np.int32)])
    assert len(rows) == len(canon)
    np.testing.assert_array_equal(np.delete(table[leaf], 3, axis=1)
                                  .view(np.int32),
                                  np.delete(heads[rows], 3, axis=1)
                                  .view(np.int32))
    # the same subtree sizes as the canonical tree
    np.testing.assert_array_equal(
        np.sort(after - np.arange(N)),
        np.sort(heads[:, 3].astype(np.int64) - np.arange(N)))
    np.testing.assert_array_equal(np.unique(np.delete(table, 3, axis=1),
                                            axis=0),
                                  np.unique(np.delete(heads, 3, axis=1),
                                            axis=0))
    s = cb.octant_signs()[octant]
    proj = (table[:, 0:3].astype(np.float64)
            + table[:, 4:7].astype(np.float64)) / 2.0 @ s
    low = np.full(N, np.inf)
    low[leaf] = rows
    for n in range(N - 1, -1, -1):     # children come after their parent
        if not leaf[n]:
            low[n] = min(low[n + 1], low[after[n + 1]])
    for n in np.nonzero(~leaf)[0]:
        near, far = n + 1, after[n + 1]
        assert proj[near] < proj[far] or (proj[near] == proj[far]
                                          and low[near] < low[far])


def _with_duplicates(bvh, tris, dup, rs):
    """The leaf-4 tree ``bvh`` with a copy of each triangle in ``dup`` (new
    ids T, T + 1, ...) added to another leaf of fewer than four triangles,
    drawn from ``rs``, whose box and ancestors' boxes grow to hold it; and
    the triangle arrays with the copies appended."""
    lo, hi, skip, first, count, order = (np.array(x) for x in bvh)
    T, N = len(tris[0]), len(lo)
    for k, x in enumerate(dup):
        at = int(np.nonzero(order == x)[0][0])
        home = np.nonzero((first >= 0) & (first <= at)
                          & (at < first + count))[0]
        room = np.nonzero((first >= 0) & (count < cb.FAT_LEAF_SIZE))[0]
        leaf = rs.choice(room[room != home[0]])
        at = first[leaf] + count[leaf]
        order = np.insert(order, at, T + k)
        first[first >= at] += 1
        count[leaf] += 1
        p = tris[0][x] + np.stack([np.zeros(3), tris[1][x], tris[2][x]])
        up = np.nonzero((np.arange(N) <= leaf) & (skip > leaf))[0]
        lo[up] = np.minimum(lo[up], p.min(0))
        hi[up] = np.maximum(hi[up], p.max(0))
    out = tuple(np.concatenate([a, a[list(dup)]]) for a in tris)
    return tbuild.BVH(lo, hi, skip, first, count, order), out


@pytest.fixture(scope="module")
def fat_meshes(soup):
    """{mesh: (fat rows, split tables, rays, per-ray [start, end))} for the
    soup and a tie-heavy mesh: test_torch_bvh's grid (up to six triangles
    hit at exactly the same t per ray) with eight triangles duplicated into
    other leaves, so that two leaves hold the same geometry."""
    meshes = {"soup": (soup["fat"], soup["tables"], _t(*soup["rays"]),
                       _t(*_treelet_ranges(soup)))}
    (p0, e1, e2), (o, d) = _tie_grid()
    lo, hi = jbuild.triangle_aabbs(p0, p0 + e1, p0 + e2)
    rs = np.random.default_rng(33)
    bvh, tris = _with_duplicates(jbuild.build_bvh(lo, hi, leaf_size=4),
                                 (p0, e1, e2), rs.choice(600, 8, replace=False),
                                 rs)
    fat = torch.from_numpy(cb.pack_nodes_fat(bvh, *tris))
    R = len(o)
    roots = jbuild.treelet_roots(bvh, max_nodes=64, max_roots=16)
    k = np.arange(R) % len(roots)
    ranges = (roots[k].astype(np.int32), bvh.skip[roots][k].astype(np.int32))
    meshes["tie_mesh"] = (fat, cb.fat_tables(fat), _t(
        o, d, np.zeros(R, np.float32), np.full(R, np.inf, np.float32)),
        _t(*ranges))
    return meshes


K8_WALKS = [(m, q) for m in ("soup", "tie_mesh")
            for q in ("closest", "any_hit", "bounded")]


@pytest.mark.parametrize("mesh,query", K8_WALKS)
def test_k8_split_walk_equals_the_fat_rows_walk(fat_meshes, mesh, query):
    """K8's walk over its split tables (closest hit: near first, with the
    slot-index tie rule; any-hit and bounded: the canonical heads) returns
    the JAX walk over the fat rows bit for bit, ties included."""
    fat, tables, rays, ranges = fat_meshes[mesh]
    kw = dict(any_hit=query == "any_hit")
    bounds = ranges if query == "bounded" else (None, None)
    out = cb.bvh_traverse_packed_plain(tables, *rays, *bounds,
                                       with_visits=True, **kw)
    ref = cb.fat_rows_walk_plain(fat, *rays, *bounds, **kw)
    for a, b, field in zip(out, ref, OUT):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=field)
    if mesh == "tie_mesh":
        assert out[0].float().mean() > (0.2 if query == "bounded" else 0.9)
        if query == "closest":
            assert int(out[5][4].sum()) > 100    # exact ties met


def test_k8_tie_rule_carries_weight(fat_meshes):
    """Without the tie rule the near-first walk on the tie mesh keeps
    another of the tied triangles than the canonical walk on some lanes."""
    fat, tables, rays, _ = fat_meshes["tie_mesh"]
    out = cb.bvh_traverse_packed_plain(tables, *rays, tie_rule=False)
    ref = cb.fat_rows_walk_plain(fat, *rays)
    assert torch.equal(out[1], ref[1])
    assert int((out[2] != ref[2]).sum()) > 20


# --- K9 ----------------------------------------------------------------------

def _root_state(N, t_min, t_max):
    R = len(t_max)
    return (np.where(t_max > t_min, 0, N).astype(np.int32), t_max,
            np.full(R, -1, np.int32), np.zeros(R, np.float32),
            np.zeros(R, np.float32))


def _k9_lanes(soup, n):
    """The first ``n`` rays as K9 takes them (one array per component), and
    their state at the root."""
    o, d, t_min, t_max = _t(*(x[:n] for x in soup["rays"]))
    rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3)) + (t_min,)
    return rays, _t(*_root_state(soup["N"], t_min.numpy(), t_max.numpy()))


def test_k9_plain_matches_pallas(soup):
    """The Pallas wide-page chunk (interpret mode, strip 1; one compile,
    closest hit, unbounded) from the root against the port's closest-hit
    walk, bounded (3 visits) and resumed, whose state is a row of its
    octant's table; and resumed from the port's bounded any-hit state (rows
    of the canonical pages), where every lane that has no hit yet is where
    a closest-hit canonical walk is, against the port's resumed any-hit
    walk: the same lanes hit, none nearer than the closest hit. The port's
    resort query (rounds 1, chunk_nit 3: lanes resume mid-walk) against the
    Pallas walk from the root. Chunking changes no lane's result."""
    o, d = (x[:512] for x in soup["rays"][:2])
    R, N = len(o), soup["N"]
    t_min, t_max = np.zeros(R, np.float32), np.full(R, np.inf, np.float32)
    rays = tuple(np.ascontiguousarray(x[:, k]) for x in (o, d)
                 for k in range(3)) + (t_min,)
    pages = jnp.asarray(soup["pages_w"].numpy())

    def pallas(state):
        return jpb._lane_chunk_w(pages, N, *_j(*rays, *state), strip=1,
                                 max_nit=0, interpret=True)

    def port(state, any_hit, max_steps=0):
        return cb.lane_chunk_w(soup["pages_w"], N, *_t(*rays), *_t(*state),
                               any_hit=any_hit, max_steps=max_steps,
                               octants=soup["wide"])

    root = _root_state(N, t_min, t_max)
    ref = pallas(root)
    bounded = port(root, False, max_steps=3)
    assert bool((bounded[4] < N).any())
    rest = port(tuple(x.numpy() for x in bounded[4:] + bounded[:4]), False)
    for i, field in enumerate(("t", "idx", "u", "v")):
        _compare(rest[i].numpy(), ref[i], field)
    # any-hit: the port's canonical state handed to the Pallas chunk
    bounded = port(root, True, max_steps=3)
    state = tuple(x.numpy() for x in bounded[4:] + bounded[:4])
    walking = (bounded[4] < N) & (bounded[1] < 0)
    assert bool(walking.any())
    closest = pallas(state)
    rest = port(state, True)
    hit = (rest[1] >= 0).numpy()
    np.testing.assert_array_equal(hit, np.asarray(closest[1]) >= 0)
    # no nearer than the closest hit, within the t tolerance (the first hit
    # is often the closest, and XLA rounds it otherwise)
    t_any, t_closest = rest[0].numpy()[hit], np.asarray(closest[0])[hit]
    assert (t_any >= t_closest - TOL["t"]["rtol"] * np.abs(t_closest)
            - TOL["t"]["atol"]).all()
    # a lane with no hit yet hands over the canonical walk's own state
    for i, field in enumerate(("t", "idx", "u", "v")):
        _compare(np.asarray(closest[i])[walking.numpy()],
                 np.asarray(ref[i])[walking.numpy()], field)
    out = cb.bvh_traverse_lane_resort_w(soup["pages_w"], N,
                                        *_t(o, d, t_min, t_max,
                                            *soup["bounds"]),
                                        rounds=1, chunk_nit=3,
                                        octants=soup["wide"])
    assert 0.3 < out[0].float().mean()
    _compare(out[0].numpy(), np.asarray(ref[1]) >= 0, "hit")
    for i, field in enumerate(("t", "idx", "u", "v")):   # t_max = inf
        _compare(out[i + 1].numpy(), ref[i], field)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_k9_plain_equals_k3(soup, any_hit):
    """K9 is K3's walk over another layout: one unbounded launch of each on
    the same rays, bit for bit (closest hit: both on the octant tables, so
    the rows they end on are rows of the same tables); and a bounded K9
    launch resumed to the end equals the unbounded one."""
    rays, state = _k9_lanes(soup, 256)
    N = soup["N"]
    kw = dict(any_hit=any_hit, octants=soup["wide"])
    full = cb.lane_chunk_w(soup["pages_w"], N, *rays, *state, **kw)
    k3 = cb.lane_chunk(soup["nodes"], N, *rays, *state, any_hit=any_hit,
                       octants=soup["octants"])
    for a, b in zip(full, k3):
        assert torch.equal(a, b)
    t, i, u, v, node = cb.lane_chunk_w(soup["pages_w"], N, *rays, *state,
                                       max_steps=4, **kw)
    assert bool((node < N).any())
    rest = cb.lane_chunk_w(soup["pages_w"], N, *rays, node, t, i, u, v, **kw)
    for a, b in zip(rest, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("octant", range(cb.OCTANTS))
def test_octant_wide_pages_hold_the_octant_rows(soup, octant):
    """Each octant table's wide pages hold, for every node, the same 11
    words as that table's rows (column 11, the leaf's canonical row, has no
    word there), and the padding slots of the last page retire a lane
    (skip = N, tri id -1)."""
    N, table = soup["N"], soup["octants"].nodes[octant]
    pages = soup["wide"].pages[octant]
    assert tuple(pages.shape) == tuple(soup["pages_w"].shape)
    fetch = cb._wide_pages(pages, cb.WIDE_PAGE)
    got = torch.stack(fetch(torch.arange(N)), dim=1)
    assert torch.equal(got[:, :11], table[:, :11])
    pad = torch.arange(N, -(-N // cb.WIDE_PAGE) * cb.WIDE_PAGE)
    tail = fetch(pad)
    assert bool((tail[3] == N).all()) and bool((tail[7] == -1).all())
    # the canonical table laid out the same way is pack_pages_w
    assert np.array_equal(
        cb.pack_pages_w_octants(soup["nodes"].numpy()[None])[0],
        soup["pages_w"].numpy())


def test_k9_closest_hit_needs_octant_pages(soup):
    """A closest-hit K9 call without the octant wide pages, or with the
    node-major octant tables, raises (on the CPU too); an any-hit call
    needs none."""
    rays, state = _k9_lanes(soup, 64)
    for kw in ({}, {"octants": soup["octants"]}):
        with pytest.raises(ValueError, match="pass octants"):
            cb.lane_chunk_w(soup["pages_w"], soup["N"], *rays, *state, **kw)
    assert cb.lane_chunk_w(soup["pages_w"], soup["N"], *rays, *state,
                           any_hit=True)[0].shape == (64,)


# --- wrappers ----------------------------------------------------------------

def test_cpu_calls_run_plain_and_count_no_launch(soup):
    o, d, t_min, t_max = _t(*(x[:16] for x in soup["rays"]))
    wrappers = (cb.treelet_rounds, cb.bvh_traverse_packed, cb.lane_chunk_w)
    before = [w.launches for w in wrappers]
    tab = cb.treelet_table(*_t(*soup["tl"]), soup["octants"].tl_range)
    hit = cb.treelet_rounds(soup["nodes"], tab, o, d, t_min, t_max,
                            octants=soup["octants"])[0]
    cb.bvh_traverse_packed(soup["tables"], o, d, t_min, t_max)
    cb.bvh_traverse_lane_resort_w(soup["pages_w"], soup["N"], o, d, t_min,
                                  t_max, *_t(*soup["bounds"]), rounds=0,
                                  octants=soup["wide"])
    assert [w.launches for w in wrappers] == before and bool(hit.any())


@pytest.mark.parametrize("bad", ["tab_rows", "tab_cols", "fat_cols",
                                 "fat_rows", "fat_slots", "start_only",
                                 "start_dtype", "page", "pages_short"])
def test_wrappers_check_inputs_on_the_cpu_too(soup, bad):
    o, d, t_min, t_max = _t(*(x[:64] for x in soup["rays"]))
    tab = cb.treelet_table(*_t(*soup["tl"]), soup["octants"].tl_range)
    tables = soup["tables"]
    start = torch.zeros(64, dtype=torch.int32)
    rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3)) + (t_min,)
    state = (torch.zeros(64, dtype=torch.int32), t_max,
             torch.full((64,), -1, dtype=torch.int32), torch.zeros(64),
             torch.zeros(64))
    calls = {
        "tab_rows": lambda: cb.treelet_rounds(
            soup["nodes"], tab.repeat(cb.MAX_TREELETS, 1), o, d, t_min, t_max,
            octants=soup["octants"]),
        "tab_cols": lambda: cb.treelet_rounds(soup["nodes"], tab[:, :7],
                                              o, d, t_min, t_max,
                                              octants=soup["octants"]),
        "fat_cols": lambda: cb.bvh_traverse_packed(
            tables._replace(heads=tables.heads[:, :7].contiguous()), o, d,
            t_min, t_max),
        # the fat rows where K8 takes its split tables
        "fat_rows": lambda: cb.bvh_traverse_packed(soup["fat"], o, d, t_min,
                                                   t_max),
        "fat_slots": lambda: cb.bvh_traverse_packed(
            tables._replace(tris=tables.tris.double()), o, d, t_min, t_max),
        "start_only": lambda: cb.bvh_traverse_packed(tables, o, d, t_min,
                                                     t_max, start=start),
        "start_dtype": lambda: cb.bvh_traverse_packed(
            tables, o, d, t_min, t_max, start.long(), start.long()),
        "page": lambda: cb.lane_chunk_w(soup["pages_w"], soup["N"], *rays,
                                        *state, page=200,
                                        octants=soup["wide"]),
        "pages_short": lambda: cb.lane_chunk_w(soup["pages_w"][:22],
                                               soup["N"], *rays, *state,
                                               octants=soup["wide"]),
    }
    with pytest.raises((ValueError, TypeError)):
        calls[bad]()


def test_k8_tables_need_cuda_unless_cpu_is_asked(soup, monkeypatch):
    """fat_tables puts the tables where the fat rows lie, or on the device
    named, CUDA by default: without a card a CUDA call raises rather than
    falling back to the CPU; and K8 takes no other device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fat = soup["fat"].numpy()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cb.fat_tables(fat, device=device)
    assert cb.fat_tables(soup["fat"]).heads.device.type == "cpu"
    for a, b in zip(cb.fat_tables(fat, device="cpu"), soup["tables"]):
        assert torch.equal(a, b)
    meta = cb.FatTables(*(x.to("meta") for x in soup["tables"]))
    o = torch.zeros((4, 3), device="meta")
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no BVH traversal"):
        cb.bvh_traverse_packed(meta, o, o, t, t)


# --- mesh loaders ------------------------------------------------------------

def _write_meshes(path):
    """An ascii PLY with normals and uvs, a binary PLY with a quad face and
    an extra element, and an OBJ with uvs, normals, negative indices and two
    materials."""
    rs = np.random.default_rng(5)
    v = rs.uniform(-1, 1, (6, 3))
    n = rs.normal(size=(6, 3))
    uv = rs.random((6, 2))
    head = ("ply\nformat {}\ncomment test\nelement vertex 6\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property float u\nproperty float v\n"
            "element face 3\nproperty list uchar int vertex_indices\n")
    with open(path / "a.ply", "w") as f:
        f.write(head.format("ascii 1.0") + "end_header\n")
        for i in range(6):
            f.write(" ".join(f"{x:.6f}" for x in (*v[i], *n[i], *uv[i])) + "\n")
        f.write("3 0 1 2\n4 1 2 3 4\n3 3 4 5\n")
    with open(path / "b.ply", "wb") as f:
        f.write((head.format("binary_little_endian 1.0")
                 + "element extra 2\nproperty short s\nend_header\n").encode())
        f.write(np.concatenate([v, n, uv], 1).astype("<f4").tobytes())
        for face in ([0, 1, 2], [1, 2, 3, 4], [3, 4, 5]):
            f.write(np.uint8(len(face)).tobytes()
                    + np.asarray(face, "<i4").tobytes())
        f.write(np.zeros(2, "<i2").tobytes())
    with open(path / "c.obj", "w") as f:
        for i in range(6):
            f.write("v {} {} {}\nvt {} {}\nvn {} {} {}\n".format(
                *v[i], *uv[i], *n[i]))
        f.write("usemtl red\nf 1/1/1 2/2/2 3/3/3\nf -3/-3/-3 -2/-2/-2 -1/-1/-1\n"
                "usemtl blue\nf 1/1/1 3/3/3 4/4/4 5/5/5\n")


@pytest.mark.parametrize("name", ["a.ply", "b.ply", "c.obj"])
def test_mesh_loaders_match_jax(tmp_path, name):
    _write_meshes(tmp_path)
    path = str(tmp_path / name)
    for split in ((False, True) if name.endswith(".obj") else (None,)):
        if split is None:
            pairs = [(tmesh.load_mesh(path), jmesh.load_mesh(path))]
        else:
            pairs = list(zip(tmesh.load_obj(path, split_by_material=split),
                             jmesh.load_obj(path, split_by_material=split)))
            assert len(pairs) == (2 if split else 1)
        for out, ref in pairs:
            for f in dataclasses.fields(jmesh.MeshData):
                a, b = getattr(out, f.name), getattr(ref, f.name)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, f.name
                    np.testing.assert_array_equal(a, b, err_msg=f.name)
                else:
                    assert a == b, f.name
            assert len(out.faces) >= 2 and out.normals is not None


# --- the treelet dispatch of a render ----------------------------------------

W = H = 16
DEPTH = 3    # direct light and two bounces
EYE, AT, UP, FOV = [0, -1.5, 1.2], [0, 0, 0], [0, 0, 1], 45.0


def _scene(builder, shapes, **kw):
    """A 20x20 heightfield (722 triangles, so a BVH) under a small area
    light, built through either package."""
    b = builder()
    h = np.sin(np.linspace(0, 6, 20))[:, None] * np.cos(
        np.linspace(0, 6, 20))[None, :] * 0.05
    v, f, _ = shapes.heightfield(h, extent=(1.0, 1.0))
    b.add_mesh(v, f, b.add_material(albedo=(0.6, 0.5, 0.4)))
    b.add_mesh([[-0.2, -0.2, 1], [0.2, -0.2, 1], [0.2, 0.2, 1], [-0.2, 0.2, 1]],
               [[0, 2, 1], [0, 3, 2]], b.add_material(albedo=(0, 0, 0)),
               emitter_radiance=(10.0, 10.0, 10.0))
    return b.build(**kw)


def _render(scene, static):
    sens = tsensor.make_perspective(TTransform.look_at(EYE, AT, UP), FOV, W, H,
                                    device="cpu")
    return tapi.render(scene, static, sens,
                       tcommon.IntegratorConfig(type=tcommon.PATH,
                                                max_depth=DEPTH),
                       tapi.RenderSettings(width=W, height=H, spp=1),
                       device="cpu").numpy()


def test_treelet_render_serves_every_query_and_matches_the_lane_render(
        monkeypatch):
    """Every BVH query of a treelet-mode render goes to the treelet query,
    and the image equals the lane render's bit for bit: each query returns
    the same closest t, and this scene has no tie between triangles. The
    lane render agrees with the JAX render (tests/test_torch_bunny.py) and
    K7 with the Pallas kernel (above), so this image agrees with JAX's."""
    # a finer cut than the scene default, so that this small tree has more
    # than one treelet
    monkeypatch.setattr(tscene, "TREELET_MAX_NODES", 256)
    scene, static = _scene(tscene.SceneBuilder, tshapes, device="cpu")
    assert static.use_bvh and len(scene.tl_root) > 1
    lane_img = _render(scene, static)
    calls = {"treelet": 0, "sorted": 0}
    treelets = cb.bvh_traverse_treelets

    def spy(*a, **k):
        calls["treelet"] += 1
        calls["sorted"] += bool(k["sort"])
        return treelets(*a, **k)

    def lane(*a, **k):
        raise AssertionError("a lane query function served a treelet-mode query")

    monkeypatch.setattr(tscene, "BVH_KERNEL", "treelet")
    monkeypatch.setattr(cb, "bvh_traverse_treelets", spy)
    for name in ("bvh_traverse_lane", "bvh_traverse_lane_resort",
                 "bvh_traverse_lane_hbm"):
        monkeypatch.setattr(cb, name, lane)
    img = _render(scene, static)
    # a closest-hit and a shadow query per bounce; all but the presorted
    # camera rays are sorted
    assert calls == {"treelet": 2 * DEPTH, "sorted": 2 * DEPTH - 1}
    assert img.shape == (H, W, 3) and img.mean() > 0.01
    np.testing.assert_array_equal(img, lane_img)


def test_unknown_bvh_kernel_raises(monkeypatch):
    scene, static = _scene(tscene.SceneBuilder, tshapes, device="cpu")
    monkeypatch.setattr(tscene, "BVH_KERNEL", "wide")
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="MTS_BVH_KERNEL"):
        tscene.occluded(scene, static, o, o + 1.0, 0.0, 1.0)


# --- kdbench -----------------------------------------------------------------

def test_kdbench_on_the_cpu(tmp_path):
    v, f, _ = tshapes.heightfield(np.sin(np.linspace(0, 6, 24))[:, None]
                                  * np.ones(24)[None, :] * 0.1)
    path = tmp_path / "hf.ply"
    with open(path, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(f)}\n"
                 "property list uchar int vertex_indices\nend_header\n")
        fh.writelines(f"{x} {y} {z}\n" for x, y, z in v)
        fh.writelines(f"3 {a} {b} {c}\n" for a, b, c in f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mtsutil.kdbench([str(path), "-n", "1024", "-r", "1"], device="cpu")
    lines = buf.getvalue().splitlines()
    assert rc == 0 and f"{len(f)} tris" in lines[0]
    results = [ln.split() for ln in lines[1:]]
    assert [tuple(ln.split(":")[0].split()) for ln in lines[1:]] == [
        ("coherent", "treelet"), ("coherent", "lane-resort"),
        ("incoherent", "treelet"), ("incoherent", "lane-resort")]
    rates = [r[-1].rstrip(")") for r in results]
    assert rates[0] == rates[1] and rates[2] == rates[3]
    assert float(rates[0]) > 0.1 and float(rates[2]) > 0.1


def test_other_utilities_land_later():
    with pytest.raises(NotImplementedError, match="later slice"):
        mtsutil.main(["tonemap", "x.exr", "-o", "y.png"])
    assert mtsutil.main(["nope"]) == 2
