"""Port parity, path-space MLT: the bidirectional target
(``eval_target_bdpt``) and mlt's mutations (``chain_steps`` under
``mlt_mode``: the bidirectional, lens, caustic and multi-chain mutations
and the specular-manifold perturbation) on the Cornell box with a glass
sphere at 8x8, depth 3, against the JAX package on the same inputs, on the
CPU; then the loader and the CLI on mlt files.

The JAX side is one jitted ``chain_steps`` whose mutation count is traced
(about 16 s of compile on a shared 8-core CPU host: the bdpt target and
the manifold walk), started in a thread before the first test and called
twice from one state: 256 chains holding fresh tables with luminance 0,
so that every proposal of the first mutation is taken. One call makes that
mutation alone: its state is ``eval_target_bdpt`` of the proposed tables,
which the port evaluates from the same tables. The other makes 1 + STEPS
mutations, which the port makes from the same start. The file takes about
27 s in a fresh process, 39 s without the JAX package's compile cache:
over a 20 s aim, since that compile (the JAX mlt, about 25 s at 8x8 and
depth 3 on its own) is most of it.

Tolerances:
  * the target (L, the t = 0 splats' values, I): at least 99% of lanes
    within rtol 1e-4 / atol 1e-5 and their splat pixels equal (a bdpt lane
    parts where a ray grazes the sphere; as tests/test_torch_bdpt.py);
  * the chains: at least 99% of chains with the same table (atol 1e-6,
    the small step's rounding) and luminance (rtol 1e-4 / atol 1e-6), and
    the film within rtol 1e-4 / atol 1e-4 on the pixels no parted chain's
    state lands on (measured: every chain agrees, the films within 3.1e-5
    of values up to 219).
"""
import concurrent.futures
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.io import mitsuba_xml as jxml
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu.render.integrators import common as jcommon
from mitsuba_tpu.render.integrators import mlt as jmlt
import mitsuba_tpu_torch.__main__ as tmain
from mitsuba_tpu_torch.core.transform import Transform as TTransform
from mitsuba_tpu_torch.io import image as timage
from mitsuba_tpu_torch.io import mitsuba_xml as txml
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render import shapes as tshapes
from mitsuba_tpu_torch.render.integrators import bdpt as tbdpt
from mitsuba_tpu_torch.render.integrators import common as tcommon
from mitsuba_tpu_torch.render.integrators import mlt as tmlt

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
RES, DEPTH, SEED = 8, 3, 5
CHAINS, STEPS = 256, 3


def glass_cornell(mod, shapes, bsdf, T, sensor, **kw):
    """The Cornell box with a glass sphere (an analytic one: the manifold
    strategy's chain) by either package's SceneBuilder."""
    b = mod.SceneBuilder()
    shapes.cornell_box(b)
    b.add_sphere((0.65, 0.25, 0.45), 0.18,
                 b.add_material(type=bsdf.DIELECTRIC, eta=1.5))
    scene, static = b.build(**kw)
    return scene, static, sensor.make_perspective(
        T.look_at(EYE, AT, UP), FOV, RES, RES, **kw)


def _start(mod, table, zeros):
    """The chains' start: the tables, luminance 0 everywhere."""
    Sn = DEPTH
    return mod.ChainState(u=table, L=zeros((CHAINS, 3)), I=zeros((CHAINS,)),
                          pos=zeros((CHAINS, 2)), sp_uv=zeros((Sn, CHAINS, 2)),
                          sp_val=zeros((Sn, CHAINS, 3)))


@pytest.fixture(scope="module", autouse=True)
def jax_run():
    js, jst, jsen = glass_cornell(jscene, jshapes, jbsdf, JTransform,
                                  jsensor)
    cfg = jcommon.IntegratorConfig(type=jcommon.MLT, max_depth=DEPTH)
    assert jmlt._manifold_capable(jst)

    @jax.jit
    def steps(sc, table, n):
        st = _start(jmlt, table, jnp.zeros)
        return jmlt.chain_steps(sc, jst, jsen, cfg, RES, RES, SEED, st,
                                jnp.zeros((RES, RES, 3)), 0, n,
                                mlt_mode=True)

    def go():
        table = jmlt.fresh_table(SEED + 7919, jnp.arange(CHAINS), 0,
                                 jmlt.n_slots_bdpt(cfg))
        return [jax.tree.map(np.asarray, steps(js, table, n))
                for n in (1, 1 + STEPS)] + [np.asarray(table)]

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(go)


@pytest.fixture(scope="module")
def port():
    return glass_cornell(tscene, tshapes, tbsdf, TTransform, tsensor,
                         device="cpu")


def _cfg():
    return tcommon.IntegratorConfig(type=tcommon.MLT, max_depth=DEPTH)


@pytest.fixture(scope="module")
def port_steps(port):
    """The port's 1 + STEPS mutations from the start of the JAX run (its
    tables are made by the port: fresh_table is bit for bit the JAX one,
    tests/test_torch_pssmlt.py)."""
    table = tmlt.fresh_table(SEED + 7919, torch.arange(CHAINS), 0,
                             tmlt.n_slots_bdpt(_cfg()))
    with torch.no_grad():
        st, film, acc, n = tmlt.chain_steps(
            *port, _cfg(), RES, RES, SEED, _start(tmlt, table, torch.zeros),
            torch.zeros(RES, RES, 3), 0, 1 + STEPS, mlt_mode=True)
    return table, st, film, acc, n


def test_scene_takes_the_manifold_strategy(port):
    assert tmlt._manifold_capable(port[1])
    assert port[1].n_spheres == 1 and port[1].n_manifold_tris == 0


def test_eval_target_bdpt(jax_run, port):
    """The port's target of the tables the JAX first mutation proposed
    (every one taken): the state that mutation left."""
    (st1, _, _), _, table = jax_run.result()
    with torch.no_grad():
        L, uv, val, I, pos, n = tmlt.eval_target_bdpt(
            *port, _cfg(), RES, RES, torch.from_numpy(np.array(st1.u)))
    assert int(n) > 0 and uv.shape == (DEPTH, CHAINS, 2)
    ok = np.isclose(I.numpy(), st1.I, rtol=1e-4, atol=1e-5) & np.all(
        np.isclose(L.numpy(), st1.L, rtol=1e-4, atol=1e-5), axis=-1) & np.all(
        np.isclose(val.numpy(), st1.sp_val, rtol=1e-4, atol=1e-5),
        axis=(0, 2))
    assert ok.mean() >= 0.99, ok.mean()
    made = st1.sp_uv[..., 0] >= 0
    np.testing.assert_array_equal(uv.numpy()[..., 0] >= 0, made)
    px = lambda a: np.clip((a * RES).astype(np.int32), 0, RES - 1)  # noqa
    np.testing.assert_array_equal(px(uv.numpy())[:, ok][made[:, ok]],
                                  px(st1.sp_uv)[:, ok][made[:, ok]])
    np.testing.assert_array_equal(pos.numpy(), st1.pos)
    # the mutation moved the tables: some lanes by the manifold walk alone
    # (the light's emission pair and nothing else)
    moved = np.abs(st1.u - table) > 0
    pair = np.zeros_like(moved)
    pair[:, tbdpt.DIM_LIGHT_EMIT + 1, :2] = True
    assert (moved.any(axis=(1, 2)) & ~(moved & ~pair).any(axis=(1, 2))).sum()


def _agreeing(st, ref_st):
    same_u = np.all(np.isclose(st.u.numpy(), ref_st.u, atol=1e-6),
                    axis=(1, 2))
    same_i = np.isclose(st.I.numpy(), ref_st.I, rtol=1e-4, atol=1e-6)
    return same_u & same_i


def test_chain_steps(jax_run, port_steps):
    _, (st, film, acc), _ = jax_run.result()
    _, pst, pfilm, pacc, _ = port_steps
    ok = _agreeing(pst, st)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_allclose(pst.L.numpy()[ok], st.L[ok], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pst.sp_val.numpy()[:, ok], st.sp_val[:, ok],
                               rtol=1e-4, atol=1e-5)
    mask = np.ones((RES, RES), bool)
    for pos in (pst.pos.numpy(), st.pos):
        px = np.clip(pos[~ok].astype(np.int32), 0, RES - 1)
        mask[px[:, 1], px[:, 0]] = False
    np.testing.assert_allclose(pfilm.numpy()[mask], film[mask], rtol=1e-4,
                               atol=1e-4)
    assert float(pacc) == pytest.approx(float(acc), abs=2e-3)


# --- the loader and the CLI ----------------------------------------------

def _cbox(tmp_path, kind, extra=""):
    text = (REPO / "scenes" / "cbox.xml").read_text()
    old = '<integrator type="path">'
    assert text.count(old) == 1
    path = tmp_path / f"{kind}.xml"
    path.write_text(text.replace(old, f'<integrator type="{kind}">{extra}'))
    return path


@pytest.mark.parametrize("extra", [
    "", '<float name="pLarge" value="0.5"/><integer name="luminanceSamples" '
    'value="2048"/><integer name="chainLength" value="9"/>'])
def test_loaders_agree_on_mlt(tmp_path, extra):
    path = _cbox(tmp_path, "mlt", extra)
    defines = {"spp": 2, "res": 4}
    jcfg = jxml.load_scene(str(path), defines).integrator
    tcfg = txml.load_scene(str(path), defines, device="cpu").integrator
    assert tcfg.type == tcommon.MLT
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("kind", ["mlt", "pssmlt"])
def test_cli_renders_the_file_as_api_render(tmp_path, kind):
    """python -m mitsuba_tpu_torch on a file with the Metropolis
    integrator: its EXR is api.render's image bit for bit (the JAX CLI
    stops with ValueError there). 1,024 chains at 4x4, depth 2, 256
    luminance samples."""
    path = _cbox(tmp_path, kind, '<integer name="maxDepth" value="2"/>'
                 '<integer name="luminanceSamples" value="256"/>')
    out = tmp_path / "o.exr"
    assert tmain.main([str(path), "-D", "spp=1", "-D", "res=4", "-z", "-o",
                       str(out), "--cpu"]) == 0
    ls = txml.load_scene(str(path), {"spp": 1, "res": 4}, device="cpu")
    img = tapi.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                      ls.settings, device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_array_equal(timage.read_exr(str(out)), img)
    assert tmlt.LAST_RUN["chains"] == 1024 and tmlt.LAST_RUN["mutations"] == 1
