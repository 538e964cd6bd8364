"""Port parity, participating media: the six phase functions, the medium
table's builder, free-flight sampling and transmittance (homogeneous and
grid media), the ``.vol`` files, the shadow walk through null boundaries
and the media elements of a scene file, against the JAX package on the same
numpy inputs, on the CPU.

Every lane-for-lane comparison runs N lanes, so one set of JAX compiles
serves the file. Tolerances:
  * the medium table, the ``.vol`` grids and the loaded scene tables:
    exactly (the same numpy arithmetic, cast to float32 at the end);
  * phase values and pdfs: rtol 1e-5 / atol 1e-6 (Rayleigh's cube root
    is a power in PyTorch, the KKAY and microflake quadratures sum in
    another order, erf and erfinv are other approximations, an ulp or two
    apart); sampled directions within atol 2e-5 (HG's cosine cancels in
    (1 + g^2 - sq^2) / 2g for |g| near 0, and erfinv near +-1 grows an
    ulp); the sample's pdf and weight against the JAX eval_pdf at the
    port's direction within rtol 3e-5 (a steep HG or microflake lobe turns
    an ulp of the direction into more of its value);
  * free flights and transmittance: the medium events (``sampled``)
    exactly, distances, positions and weights within rtol 1e-5 / atol
    1e-6 (log and exp an ulp apart);
  * the shadow walk: the closed form exp(-0.6) and exp(-0.6 / 0.8) within
    rtol 1e-5, as tests/test_volumetric.py holds the JAX walk.
"""
import dataclasses
import struct
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.io import volgrid as jvol
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import medium as jmed
from mitsuba_tpu.render import phase as jphase
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.io import volgrid as tvol
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import medium as tmed
from mitsuba_tpu_torch.render import phase as tphase
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import common as tcommon
from mitsuba_tpu_torch.render.integrators import volpath as tvolpath
from test_torch_render import FIELD_PATHS, _leaf, jax_scene_arrays

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
STEEP = dict(rtol=3e-5, atol=1e-6)
ALL_PHASES = (0, 1, 2, 3, 4, 5)
MEDIUM_FIELDS = jmed.MediumTable._fields


J_EVAL_PDF = jax.jit(partial(jphase.eval_pdf, active_types=ALL_PHASES))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- phase functions -------------------------------------------------------

@pytest.fixture(scope="module")
def phase_lanes():
    """N lanes of every phase type, each with its own random parameters,
    incoming and outgoing directions and 2D draw."""
    r = np.random.default_rng(1)
    f32 = np.float32
    lanes = dict(
        ptype=r.integers(0, 6, N).astype(np.int32),
        g=r.uniform(-0.9, 0.9, N).astype(f32),
        g2=r.uniform(-0.9, 0.9, N).astype(f32),
        w2=r.uniform(0.0, 1.0, N).astype(f32),
        ks=r.uniform(0.0, 1.0, N).astype(f32),
        exponent=r.uniform(1.0, 20.0, N).astype(f32),
        sigma=r.uniform(0.05, 0.6, N).astype(f32),
        axis=_unit(r.normal(size=(N, 3))),
        wi=_unit(r.normal(size=(N, 3))),
        wo=_unit(r.normal(size=(N, 3))),
        u2=r.random((N, 2)).astype(f32))
    lanes["g"][:64] = 0.0   # HG's isotropic branch |g| < 1e-4
    return lanes


def _params(mod, lanes, conv):
    return mod.PhaseParams(**{k: conv(lanes[k]) for k in (
        "g", "g2", "w2", "ks", "exponent", "sigma", "axis")})


def test_phase_eval_pdf_matches_jax(phase_lanes):
    """All six types, one per lane, through one dispatch."""
    ln = phase_lanes
    jv, jp = J_EVAL_PDF(jnp.asarray(ln["ptype"]),
                        _params(jphase, ln, jnp.asarray),
                        jnp.asarray(ln["wi"]), jnp.asarray(ln["wo"]))
    tv, tp = tphase.eval_pdf(_t(ln["ptype"]), _params(tphase, ln, _t),
                             _t(ln["wi"]), _t(ln["wo"]),
                             active_types=ALL_PHASES)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    # every type reached; a positive pdf but where the microflake's flake
    # density underflows
    assert set(ln["ptype"].tolist()) == set(ALL_PHASES)
    assert (tp.numpy()[ln["ptype"] != tphase.MICROFLAKE] > 0).all()


def test_phase_sample_matches_jax(phase_lanes):
    ln = phase_lanes
    jwo, _, _ = jax.jit(partial(jphase.sample, active_types=ALL_PHASES))(
        jnp.asarray(ln["ptype"]), _params(jphase, ln, jnp.asarray),
        jnp.asarray(ln["wi"]), jnp.asarray(ln["u2"]))
    two, tw, tp = tphase.sample(_t(ln["ptype"]), _params(tphase, ln, _t),
                                _t(ln["wi"]), _t(ln["u2"]),
                                active_types=ALL_PHASES)
    np.testing.assert_allclose(two.numpy(), np.asarray(jwo), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(two.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    # the weight and pdf are eval_pdf's at the sampled direction: the JAX
    # eval_pdf there (a steep lobe turns the directions' ulps into larger
    # relative gaps of the values at their own directions)
    jv, jp2 = J_EVAL_PDF(jnp.asarray(ln["ptype"]),
                         _params(jphase, ln, jnp.asarray),
                         jnp.asarray(ln["wi"]), jnp.asarray(two.numpy()))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp2), **STEEP)
    ok = np.asarray(jp2) > 1e-20
    np.testing.assert_allclose(tw.numpy()[ok],
                               (np.asarray(jv) / np.asarray(jp2))[ok],
                               **STEEP)


@pytest.mark.parametrize("ptype", ALL_PHASES)
def test_phase_type_alone_matches_jax(phase_lanes, ptype):
    """Each type alone in active_types (a scene with one phase function):
    the same values as the mixed dispatch's on its lanes."""
    ln = phase_lanes
    sel = ln["ptype"] == ptype
    pt = np.full(N, ptype, np.int32)
    tv, tp = tphase.eval_pdf(_t(pt), _params(tphase, ln, _t), _t(ln["wi"]),
                             _t(ln["wo"]), active_types=(ptype,))
    mv, mp = tphase.eval_pdf(_t(ln["ptype"]), _params(tphase, ln, _t),
                             _t(ln["wi"]), _t(ln["wo"]),
                             active_types=ALL_PHASES)
    np.testing.assert_array_equal(tv.numpy()[sel], mv.numpy()[sel])
    np.testing.assert_array_equal(tp.numpy()[sel], mp.numpy()[sel])


# --- the medium table --------------------------------------------------------

def _sparse_grid(r, shape, fill=0.3):
    """Random densities in a box covering ``fill`` of each axis, zero
    elsewhere."""
    g = np.zeros(shape, np.float32)
    box = tuple(slice(int(n * (1 - fill) / 2), int(n * (1 + fill) / 2) + 1)
                for n in shape)
    g[box] = r.random(g[box].shape)
    return g


def _w2g(lo, hi):
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    m = np.eye(4)
    m[:3, :3] = np.diag(1.0 / (hi - lo))
    m[:3, 3] = -lo / (hi - lo)
    return m


def media_builder(b):
    """Two grid media (ids 0, 1: grid ids equal to medium ids) and a
    homogeneous one (id 2), with several phase functions; the grids have
    different shapes, so the stack pads."""
    r = np.random.default_rng(3)
    b.add_medium_heterogeneous(
        _sparse_grid(r, (20, 17, 13)), sigma_t=(3.0, 2.0, 4.0),
        albedo=(0.9, 0.7, 0.5), phase_type=1, phase_g=0.6, scale=1.5,
        world_to_grid=_w2g((-0.2, -0.1, 0.1), (0.9, 1.2, 1.0)))
    b.add_medium_heterogeneous(
        _sparse_grid(r, (5, 6, 7), 0.6), sigma_t=(1.0, 1.0, 2.0),
        albedo=(0.5, 0.5, 0.5), phase_type=4, phase_axis=(0.0, 0.6, 0.8),
        phase_ks=0.3, phase_exp=12.0)
    b.add_medium_homogeneous(sigma_s=(0.8, 1.0, 1.2), sigma_a=(0.1, 0.2, 0.0),
                             phase_type=3, phase_g=0.5, phase_g2=-0.4,
                             phase_w2=0.3, scale=2.0)
    return b


@pytest.fixture(scope="module")
def tables():
    jt = media_builder(jscene.SceneBuilder())._build_media()
    tt = media_builder(tscene.SceneBuilder())._build_media("cpu")
    return jt, tt


def test_build_media_equals_jax(tables):
    jt, tt = tables
    assert tt._fields == jt._fields
    for f in MEDIUM_FIELDS:
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(jt, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # the supergrid leaves empty cells at 0 and the dilation reaches past
    # each cell's own voxels
    assert (tt.super_maj[0] == 0).any() and (tt.super_maj[0] > 0).any()


def test_empty_media_table_equals_jax():
    jt, tt = jmed.MediumTable.empty(), tmed.MediumTable.empty("cpu")
    for f in MEDIUM_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)


@pytest.fixture(scope="module")
def medium_lanes():
    """N rays through the tables' media: origins around the first grid's
    box, random directions, surface distances, media (-1 vacuum .. 2) and
    active flags."""
    r = np.random.default_rng(5)
    return dict(
        o=r.uniform(-0.4, 1.3, (N, 3)).astype(np.float32),
        d=_unit(r.normal(size=(N, 3))),
        t_surf=r.uniform(0.05, 2.5, N).astype(np.float32),
        mid=r.integers(-1, 3, N).astype(np.int32),
        active=r.random(N) < 0.9,
        pixel=np.arange(N, dtype=np.int32))


DIM = 12  # the dimension the lanes draw from (a host int)


def _jax_medium_call(fn, jt, ln, dist):
    return jax.jit(lambda *a: fn(jt, (0, 1), *a[:4], 0, a[4], 3, DIM, a[5]))(
        *(jnp.asarray(ln[k]) for k in ("mid", "o", "d", dist, "pixel",
                                       "active")))


def _port_medium_call(fn, tt, ln, dist):
    return fn(tt, (0, 1), _t(ln["mid"]), _t(ln["o"]), _t(ln["d"]),
              _t(ln[dist]), 0, _t(ln["pixel"]).long(), 3, DIM,
              _t(ln["active"]))


def test_sample_distance_matches_jax(tables, medium_lanes):
    jt, tt = tables
    ref = _jax_medium_call(jmed.sample_distance, jt, medium_lanes, "t_surf")
    out = _port_medium_call(tmed.sample_distance, tt, medium_lanes, "t_surf")
    np.testing.assert_array_equal(out.sampled.numpy(), np.asarray(ref.sampled))
    for f in ("t", "p", "weight"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), **TOL,
                                   err_msg=f)
    # both kinds of media scattered and passed
    mid, smp = medium_lanes["mid"], out.sampled.numpy()
    for k in (0, 2):
        assert smp[mid == k].any() and not smp[mid == k].all()
    assert not smp[mid < 0].any()


def test_eval_transmittance_matches_jax(tables, medium_lanes):
    jt, tt = tables
    ref = _jax_medium_call(jmed.eval_transmittance, jt, medium_lanes,
                           "t_surf")
    tmed.reset_steps()
    out = _port_medium_call(tmed.eval_transmittance, tt, medium_lanes,
                            "t_surf")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    tr = out.numpy()[:, 0]
    mid = medium_lanes["mid"]
    assert ((tr > 0) & (tr < 1)).any() and (tr[mid < 0] == 1).all()
    assert tmed.STEPS["transmittance"] > 0 and tmed.STEPS["loops"] == 1


def test_tracking_loop_stops_early_with_the_same_bits(tables, medium_lanes):
    """A loop that tests for live lanes every step gives the bits of one
    that tests every CHECK_EVERY steps (done lanes keep their state)."""
    _, tt = tables
    ref = _port_medium_call(tmed.sample_distance, tt, medium_lanes, "t_surf")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmed, "CHECK_EVERY", 1)
        out = _port_medium_call(tmed.sample_distance, tt, medium_lanes,
                                "t_surf")
    for f in ref._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def test_sparse_grid_leaps_empty_space():
    """tests/test_volumetric.py's sparse blob: transmittance exactly 1 along
    an empty edge (zero local majorants: pure DDA leaps, no null
    collision), and through the blob the dense quadrature of the trilinear
    density within that test's 3%."""
    n = 33
    grid = np.zeros((n, n, n), np.float32)
    grid[12:21, 12:21, 12:21] = 1.0
    b = tscene.SceneBuilder()
    b.add_medium_heterogeneous(grid, sigma_t=(4.0,) * 3, albedo=(0.0,) * 3)
    tt = b._build_media("cpu")
    sm = tt.super_maj[0].numpy()
    assert sm.max() == 1.0 and (sm == 0).sum() > sm.size // 2
    pix = torch.arange(N)

    def T(o, dist):
        return tmed.eval_transmittance(
            tt, (tmed.HETEROGENEOUS,), torch.zeros(N, dtype=torch.int32),
            torch.tensor([o]).repeat(N, 1), torch.tensor([[0.0, 0.0, 1.0]])
            .repeat(N, 1), torch.full((N,), dist), 0, pix, 0, 0,
            torch.ones(N, dtype=torch.bool))[:, 0].numpy()

    tmed.reset_steps()
    np.testing.assert_array_equal(T([0.05, 0.05, 0.0], 1.0), 1.0)
    # the empty edge's lanes cross the cube in one leap per supercell
    assert tmed.STEPS["transmittance"] <= tmed.SUPER_RES + 2
    ts = np.linspace(0.0, 1.4, 4001)
    z = np.clip((-0.2 + ts) * (n - 1), 0, n - 1)
    z0 = np.floor(z).astype(int)
    dens = grid[z0, 16, 16] * (1 - (z - z0)) + grid[
        np.minimum(z0 + 1, n - 1), 16, 16] * (z - z0)
    ref = np.exp(-4.0 * np.trapezoid(dens, ts))
    np.testing.assert_allclose(T([0.5, 0.5, -0.2], 1.4).mean(), ref,
                               rtol=0.03)


def test_grid_transform_is_the_mediums_own():
    """A grid medium after a homogeneous one: the port reads its own
    world_to_grid. The JAX package reads the transform of the medium whose
    id equals the grid's id (the homogeneous one's identity; ROADMAP.md,
    Queue 3), so it sees no density inside the grid's own box."""
    grid = np.ones((4, 4, 4), np.float32)
    w2g = _w2g((2.0, 2.0, 2.0), (3.0, 3.0, 3.0))
    tables = []
    for mod, kw in ((jscene, {}), (tscene, {"dev": "cpu"})):
        b = mod.SceneBuilder()
        b.add_medium_homogeneous()
        b.add_medium_heterogeneous(grid, sigma_t=(2.0,) * 3, world_to_grid=w2g)
        tables.append(b._build_media(**kw))
    jt, tt = tables
    p = np.float32([[2.5, 2.5, 2.5], [0.5, 0.5, 0.5]])
    mid = np.ones(2, np.int32)
    gl = tmed._grid_lanes(tt, _t(mid).long(), _t(p), _t(p))
    port = tmed._lookup_density(tt, gl, _t(p)).numpy()
    ref = np.asarray(jax.jit(jmed._lookup_density)(jt, jnp.asarray(mid),
                                                   jnp.asarray(p)))
    np.testing.assert_array_equal(port, [1.0, 0.0])
    np.testing.assert_array_equal(ref, [0.0, 1.0])


def test_rng_dimensions_overlap_as_in_jax():
    """The layout's known overlap (ROADMAP.md, Queue 3): delta-tracking
    step 62 of a bounce draws uniform2(dim0 + 64), the first two numbers of
    its NEE sample uniform4(dim0 + 64), in both packages; the shadow walk's
    crossing i at ratio-tracking step 8 draws what crossing i + 1 draws at
    step 0."""
    pix = np.arange(N, dtype=np.int32)
    dim0 = tcommon.DIM_BASE
    draw = jax.jit(lambda p, a, b: (jrng.uniform2(0, p, 0, a),
                                    jrng.uniform4(0, p, 0, b)))
    for a, b in ((dim0 + 2 + 62, dim0 + tvolpath.DIM_VOL_NEE),
                 (dim0 + tvolpath.DIM_VOL_SHADOW + 32 + 8,
                  dim0 + tvolpath.DIM_VOL_SHADOW + 8 + 32)):
        j2, j4 = (np.asarray(x) for x in draw(jnp.asarray(pix), a, b))
        t2 = trng.uniform2(0, _t(pix).long(), 0, a).numpy()
        np.testing.assert_array_equal(j2, j4[:, :2])
        np.testing.assert_array_equal(t2, j2)


# --- .vol files --------------------------------------------------------------

def _vol_bytes(enc, grid, channels=1, bbox=(0, 0, 0, 1, 2, 3)):
    zres, yres, xres = grid.shape[:3]
    head = (b"VOL" + struct.pack("<B", 3)
            + struct.pack("<iiiii", enc, xres, yres, zres, channels)
            + struct.pack("<6f", *bbox))
    dtype = {1: "<f4", 2: "<f2", 3: np.uint8}[enc]
    return head + np.ascontiguousarray(grid, dtype).tobytes()


def test_vol_files_cross_read_bit_for_bit(tmp_path):
    """Files written by each package's save_vol read by the other's
    load_vol (memory-mapped and not), and the float16, uint8 and
    three-channel encodings, bit for bit."""
    g = np.random.default_rng(7).random((9, 6, 5)).astype(np.float32)
    for writer, name in ((tvol.save_vol, "t.vol"), (jvol.save_vol, "j.vol")):
        writer(str(tmp_path / name), g, (0.5, -1, 0), (1.5, 2, 4))
    assert (tmp_path / "t.vol").read_bytes() == (tmp_path / "j.vol").read_bytes()
    cases = {"t.vol": None, "j.vol": None}
    r = np.random.default_rng(8)
    for name, enc, ch, arr in (
            ("f16.vol", 2, 1, r.random((4, 3, 2)).astype(np.float16)),
            ("u8.vol", 3, 1, r.integers(0, 256, (4, 3, 2)).astype(np.uint8)),
            ("rgb.vol", 1, 3, r.random((4, 3, 2, 3)).astype(np.float32))):
        (tmp_path / name).write_bytes(_vol_bytes(enc, arr, ch))
        cases[name] = arr
    for name in cases:
        for mmap in (True, False):
            tg, tw = tvol.load_vol(str(tmp_path / name), mmap=mmap)
            jg, jw = jvol.load_vol(str(tmp_path / name), mmap=mmap)
            assert tg.dtype == jg.dtype == np.float32
            np.testing.assert_array_equal(np.asarray(tg), np.asarray(jg))
            np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(
        np.asarray(tvol.load_vol(str(tmp_path / "t.vol"))[0]), g)


def test_vol_rejects_bad_files(tmp_path):
    (tmp_path / "bad.vol").write_bytes(b"VOX" + bytes(45))
    with pytest.raises(ValueError, match="magic"):
        tvol.load_vol(str(tmp_path / "bad.vol"))
    (tmp_path / "enc.vol").write_bytes(_vol_bytes(1, np.zeros((1, 1, 1)))
                                       .replace(struct.pack("<i", 1), struct
                                                .pack("<i", 9), 1))
    with pytest.raises(ValueError, match="encoding"):
        tvol.load_vol(str(tmp_path / "enc.vol"))


# --- the shadow walk ---------------------------------------------------------

def test_attenuated_transmittance_nested_slab():
    """tests/test_volumetric.py's slab (sigma_a = 1 between two null planes
    at z = 0.2 and 0.8): exp(-0.6) along z, exp(-0.6 / 0.8) at cos 0.8,
    and 0 behind the opaque blocker; with the queries it issued."""
    b = tscene.SceneBuilder()
    med = b.add_medium_homogeneous(sigma_s=(0, 0, 0), sigma_a=(1.0,) * 3)
    lo_m = b.add_material(type=tbsdf.NULL, exterior_medium=med)
    hi_m = b.add_material(type=tbsdf.NULL, interior_medium=med)
    for z, mat in ((0.2, lo_m), (0.8, hi_m)):
        t = TTransform.translate([0.5, 0.5, z]) * TTransform.scale([5, 5, 1])
        v, f, uv = tshapes.rectangle(t)
        b.add_mesh(v, f, mat, uvs=uv)
    t = TTransform.translate([3.0, 0.5, 0.5]) * TTransform.scale([0.2, 0.2, 1])
    v, f, uv = tshapes.rectangle(t)
    b.add_mesh(v, f, b.add_material(), uvs=uv)
    scene, static = b.build(device="cpu")
    assert static.has_boundary_media and static.medium_types == (0,)

    R = 8
    pix = torch.arange(R)

    def rays(v):
        return torch.tensor([v]).repeat(R, 1)

    o, d = rays([0.5, 0.5, 0.0]), rays([0.0, 0.0, 1.0])
    vac = torch.full((R,), -1, dtype=torch.int32)

    def walk(o, d, dist):
        return tscene.attenuated_transmittance(
            scene, static, o, d, torch.full((R,), dist), vac, 0, pix, 0, 500,
            with_stats=True)

    tr, n = walk(o, d, 1.9)
    np.testing.assert_allclose(tr.numpy(), np.exp(-0.6), rtol=1e-5)
    # two crossings, then a query that meets nothing, then two idle ones
    assert int(n) == 3 * R
    d2 = rays([0.6, 0.0, 0.8])
    np.testing.assert_allclose(walk(o, d2, 2.2)[0].numpy(),
                               np.exp(-0.6 / 0.8), rtol=1e-5)
    o3 = rays([3.0, 0.5, 0.0])
    np.testing.assert_array_equal(walk(o3, d, 1.9)[0].numpy(), 0.0)


# --- scene files --------------------------------------------------------------

MEDIA_XML = """<scene version="0.6.0">
  <integrator type="{integrator}"><integer name="maxDepth" value="6"/>
  </integrator>
  <medium type="homogeneous" id="fog">
    <rgb name="sigmaT" value="0.5, 0.6, 0.7"/>
    <rgb name="albedo" value="0.9, 0.8, 0.7"/>
    <float name="scale" value="2"/>
    <phase type="hg"><float name="g" value="0.4"/></phase>
  </medium>
  <bsdf type="diffuse" id="white"/>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.3"/></transform>
    <medium type="heterogeneous" name="interior">
      <volume type="gridvolume" name="density">
        <string name="filename" value="smoke.vol"/></volume>
      <rgb name="sigmaT" value="3, 2, 1"/>
      <phase type="rayleigh"/>
    </medium>
  </shape>
  <shape type="sphere"><float name="radius" value="0.2"/>
    <ref id="white"/><ref name="exterior" id="fog"/>
    <medium type="homogeneous" name="interior">
      <rgb name="sigmaS" value="0.3, 0.2, 0.1"/>
      <rgb name="sigmaA" value="0.05, 0.05, 0.05"/>
    </medium>
  </shape>
  <shape type="rectangle"><ref id="white"/></shape>
  <shape type="rectangle">
    <medium type="heterogeneous">
      <volume type="constvolume"><float name="value" value="0.7"/></volume>
    </medium>
    <bsdf type="dielectric"/>
  </shape>
  <emitter type="constant"/>
</scene>
"""


@pytest.fixture(scope="module")
def media_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    grid = _sparse_grid(np.random.default_rng(9), (6, 5, 4), 0.5)
    tvol.save_vol(str(d / "smoke.vol"), grid, (-0.3, -0.3, -0.3),
                  (0.3, 0.3, 0.3))
    out = {}
    for integrator in ("volpath", "volpath_simple"):
        path = d / f"{integrator}.xml"
        path.write_text(MEDIA_XML.format(integrator=integrator))
        out[integrator] = txml.load_scene(str(path), device="cpu")
    # the JAX loader reads both integrator names as VOLPATH, so one JAX
    # load serves both cases
    out["jax"] = jxml.load_scene(str(d / "volpath.xml"))
    return out


@pytest.mark.parametrize("integrator", ("volpath", "volpath_simple"))
def test_media_file_loads_as_the_jax_loaders(media_files, integrator):
    jls, tls = media_files["jax"], media_files[integrator]
    assert tls.integrator.type == jls.integrator.type == tcommon.VOLPATH
    assert tls.integrator.max_depth == 6
    # FIELD_PATHS: every table, the materials' media and the medium table
    for path in FIELD_PATHS:
        ref = jls.scene
        for p in path:
            ref = getattr(ref, p)
        np.testing.assert_array_equal(_leaf(tls.scene, path), np.asarray(ref),
                                      err_msg=".".join(path))
    st = tls.static
    assert st.medium_types == tuple(jls.static.medium_types) == (0, 1)
    assert st.phase_types == tuple(jls.static.phase_types) == (0, 1, 2)
    assert st.has_boundary_media and jls.static.has_boundary_media
    # the referenced, the nested, the unnamed medium; the null cube, the
    # cloned white row of the sphere, the dielectric with its medium
    mats = tls.scene.materials
    assert mats.type.tolist() == [0, 11, 0, 1, 1]
    assert mats.interior_medium.tolist() == [-1, 1, 2, -1, 3]
    assert mats.exterior_medium.tolist() == [-1, -1, 0, -1, -1]


def test_media_file_through_the_bridge(media_files):
    """The bridge carries the JAX medium table and the material columns:
    the same scene as the port's loader builds."""
    jls, tls = media_files["jax"], media_files["volpath"]
    scene, static = bridge.scene_from_arrays(
        jax_scene_arrays(jls.scene), dataclasses.asdict(jls.static),
        device="cpu")
    assert static == tls.static
    for f in MEDIUM_FIELDS:
        assert torch.equal(getattr(scene.media, f),
                           getattr(tls.scene.media, f)), f
    assert torch.equal(scene.materials.interior_medium,
                       tls.scene.materials.interior_medium)


def test_unknown_medium_or_phase_types_raise():
    b = tscene.SceneBuilder()
    b.add_medium_homogeneous(phase_type=6)
    with pytest.raises(NotImplementedError, match="phase type 6"):
        b.build(device="cpu")
    b = tscene.SceneBuilder()
    b.add_medium_homogeneous()
    b.media[-1]["type"] = 2
    with pytest.raises(NotImplementedError, match="medium type 2"):
        b.build(device="cpu")


def test_media_entry_points_raise_without_a_card(media_files, tmp_path):
    """load_scene and the builder of a media scene default to CUDA and
    raise without it; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    path = tmp_path / "v.xml"
    path.write_text(MEDIA_XML.format(integrator="volpath"))
    with pytest.raises(RuntimeError, match="CUDA"):
        txml.load_scene(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        media_builder(tscene.SceneBuilder()).build()
