"""Port parity, the specular-manifold walk (render/manifold.py) and the
specular-mesh rows it walks: ``chain_exit_dir``, ``solve_exit_dir`` (the
pairs and their convergence), ``det_omega`` and ``perturb_cone`` against
the JAX package on the same inputs, on the CPU, on a chain through an
analytic glass sphere (tests/test_manifold.py's layout) and on one through
a glass mesh sphere of 120 triangles; SceneBuilder's and the bridge's
``man_tri`` rows against the JAX SceneBuilder's.

Tolerances (each port walk solves toward its own perturbed directions):
  * the rows: bit for bit (float64 host values cast once to float32);
  * directions (exit, perturbed, cone): at least 99% of lanes within atol
    1e-5 and every lane within 1e-4 (four refractions of float32
    directions: measured within 5.2e-6 through the sphere; through the
    faceted mesh one lane of 256 at 1.9e-5, a ray that meets a facet near
    grazing, where the rounding of the interpolated normal grows);
  * the solved pairs: the same, where both converged (measured 1.6e-7);
    the convergence flags equal on at least 99% of lanes (a lane on the
    1e-4 residual bound can flip; measured: all equal);
  * the Jacobian d omega / d u (carried by hand here, forward-mode AD in
    JAX), relative to each lane's largest entry: at least 99% of lanes
    within 1e-4 and every lane within 1e-3 (as det_omega);
  * det_omega: at least 99% of lanes within rtol 1e-4 and every lane
    within 1e-3 (a cross product of forward-mode columns, which XLA's fused
    multiply-adds move by a few ulps; measured 3.8e-5 on 1,024 sphere
    lanes, one mesh lane of 256 at 2.5e-4, the grazing one).

The JAX side is one jitted function per chain (about 6 and 9 s of compile
on a shared 8-core CPU host), both started in threads before the first
test; the port's tests run beside them. The file takes about 25-28 s in a
fresh process: over a 20 s aim, since those compiles and the imports are
most of it.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import manifold as jman
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import shapes as jshapes
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import manifold as tman
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import shapes as tshapes
from test_torch_render import jax_scene_arrays

# PyTorch on one thread: beside XLA's CPU thread pool, and the other test
# workers', its own pool makes the port's small eager ops many times
# slower
torch.set_num_threads(1)

R = 256
RNG = np.random.default_rng(2)
U = RNG.uniform(0.05, 0.95, (R, 2)).astype(np.float32)
DU = RNG.uniform(-0.02, 0.02, (R, 2)).astype(np.float32)
U_CONE = RNG.random((R, 2), np.float32)
O = np.tile(np.float32([0.0, 1.6, 0.0]), (R, 1))
N_L = np.tile(np.float32([0.0, -1.0, 0.0]), (R, 1))
MESH = (6, 12)  # rings, segments: 120 triangles
THETA = 0.05


def mesh_sphere(mod, shapes, bsdf, **kw):
    """A glass mesh sphere of MESH by either package's SceneBuilder."""
    b = mod.SceneBuilder()
    glass = b.add_material(type=bsdf.DIELECTRIC, eta=1.5)
    v, f, n, uv = shapes.sphere_mesh((0.0, 0.5, 0.0), 0.25, rings=MESH[0],
                                     segments=MESH[1])
    b.add_mesh(v, f, glass, normals=n, uvs=uv)
    return b.build(**kw)


JAX_MESH = mesh_sphere(jscene, jshapes, jbsdf)
CHAINS = {
    "sphere": (np.float32([[0.0, 0.5, 0.0]]), np.float32([0.25]),
               np.float32([1.5]), None),
    "mesh": (np.zeros((1, 3), np.float32), np.zeros(1, np.float32),
             np.ones(1, np.float32), np.asarray(JAX_MESH[0].man_tri)),
}


def _jax_walk(centers, radii, etas, mesh):
    @jax.jit
    def run(u, du, o, n, u_cone):
        chain = jax.vmap(jman.chain_exit_dir,
                         in_axes=(0, 0, 0, None, None, None, None))
        geo = (jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(etas),
               None if mesh is None else jnp.asarray(mesh))
        d0 = chain(u, o, n, *geo)
        d_t = chain(jnp.clip(u + du, 0.0, 1.0), o, n, *geo)
        u_s, ok = jman.solve_exit_dir(u, o, n, d_t, *geo)
        jac = jax.vmap(jax.jacfwd(jman.chain_exit_dir),
                       in_axes=(0, 0, 0, None, None, None, None))
        return dict(d0=d0, d_t=d_t, u=u_s, ok=ok, jac=jac(u, o, n, *geo),
                    det=jman.det_omega(u, o, n, *geo),
                    cone=jman.perturb_cone(d0, u_cone, THETA))

    return jax.tree.map(np.asarray, run(U, DU, O, N_L, U_CONE))


@pytest.fixture(scope="module", autouse=True)
def jax_walks():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {k: pool.submit(_jax_walk, *v) for k, v in CHAINS.items()}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def port_walks():
    """The port's walks of both chains, made while XLA compiles the JAX
    ones; each solves toward its own perturbed exit directions."""
    out = {}
    u, o, n = _t(U), _t(O), _t(N_L)
    for name, chain in CHAINS.items():
        geo = tuple(_t(x) for x in chain)
        with torch.no_grad():
            d0 = tman.chain_exit_dir(u, o, n, *geo)
            d_t = tman.chain_exit_dir(torch.clamp(u + _t(DU), 0.0, 1.0), o,
                                      n, *geo)
            u_s, ok = tman.solve_exit_dir(u, o, n, d_t, *geo)
            res = dict(d0=d0, d_t=d_t, u=u_s, ok=ok,
                       jac=tman.chain_jacobian(u, o, n, *geo)[1],
                       det=tman.det_omega(u, o, n, *geo),
                       cone=tman.perturb_cone(d0, _t(U_CONE), THETA))
        out[name] = {k: v.numpy() for k, v in res.items()}
    return out


@pytest.fixture(scope="module", params=list(CHAINS))
def walk(request, port_walks, jax_walks):
    """(port, JAX) of one chain."""
    return port_walks[request.param], jax_walks[request.param].result()


def _most_within(out, ref, limit, rtol=0.0, atol=0.0):
    """At least 99% of lanes (rows) within (rtol, atol), every lane within
    ``limit`` times that."""
    err = np.abs(out - ref).reshape(len(out), -1).max(axis=1)
    bound = (atol + rtol * np.abs(ref)).reshape(len(out), -1).min(axis=1)
    assert (err <= bound).mean() >= 0.99, (err / bound).max()
    assert (err <= limit * bound).all(), (err / bound).max()


@pytest.mark.parametrize("key", ["d0", "d_t", "cone"])
def test_directions(walk, key):
    out, ref = walk
    _most_within(out[key], ref[key], 10, atol=1e-5)


def test_chain_leaves_through_the_glass(walk):
    """The chains are chains: most exit directions are turned away from
    the emitted ones, and the walk converges on most lanes."""
    out, ref = walk
    assert (np.abs(out["d0"][:, 1] + 1.0) > 1e-3).mean() > 0.2
    assert ref["ok"].mean() > 0.9


def test_solve_exit_dir(walk):
    out, ref = walk
    assert (out["ok"] == ref["ok"]).mean() >= 0.99
    both = out["ok"] & ref["ok"]
    _most_within(out["u"][both], ref["u"][both], 10, atol=1e-5)


def test_chain_jacobian(walk):
    """The Jacobian carried by hand through the chain against the JAX
    package's forward-mode AD (vmap of jacfwd), per lane relative to the
    largest entry of its 3x2 matrix."""
    out, ref = walk
    scale = np.abs(ref["jac"]).max(axis=(1, 2), keepdims=True) + 1e-6
    _most_within(out["jac"] / scale, ref["jac"] / scale, 10, atol=1e-4)


def test_det_omega(walk):
    out, ref = walk
    assert (out["det"] > 0).all()
    _most_within(out["det"], ref["det"], 10, rtol=1e-4)


# --- the specular-mesh rows ----------------------------------------------

def _window(mod, shapes, bsdf, mtype, n_quads=1, **kw):
    """The Cornell box with n_quads glass window quads of ``mtype``."""
    b = mod.SceneBuilder()
    shapes.cornell_box(b)
    mat = b.add_material(type=mtype, eta=1.5046)
    for k in range(n_quads):
        z = 0.3 + 0.4 * k / max(n_quads, 1)
        v = np.array([[0.3, 0.2, z], [0.7, 0.2, z], [0.7, 0.6, z],
                      [0.3, 0.6, z]])
        b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]]), mat)
    return b.build(**kw)


SCENES = {
    "mesh sphere": lambda mod, sh, bs, **kw: mesh_sphere(mod, sh, bs, **kw),
    "dielectric window": lambda mod, sh, bs, **kw: _window(
        mod, sh, bs, bs.DIELECTRIC, **kw),
    "thin window": lambda mod, sh, bs, **kw: _window(
        mod, sh, bs, bs.THIN_DIELECTRIC, **kw),
    "no glass": lambda mod, sh, bs, **kw: _window(mod, sh, bs, bs.DIFFUSE,
                                                  **kw),
    "over the cap": lambda mod, sh, bs, **kw: _window(
        mod, sh, bs, bs.DIELECTRIC, n_quads=2049, **kw),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_builder_rows_bitwise(name):
    """The port's SceneBuilder makes the JAX SceneBuilder's man_tri rows and
    n_manifold_tris: dielectric and thin-dielectric triangles, 1 to 4,096
    of them, else one zero row."""
    js, jst = SCENES[name](jscene, jshapes, jbsdf)
    ts, tst = SCENES[name](tscene, tshapes, tbsdf, device="cpu")
    assert tst.n_manifold_tris == jst.n_manifold_tris
    np.testing.assert_array_equal(ts.man_tri.numpy(), np.asarray(js.man_tri))
    assert ts.man_tri.dtype == torch.float32
    expect = {"mesh sphere": 120, "dielectric window": 2, "thin window": 2,
              "no glass": 0, "over the cap": 0}[name]
    assert tst.n_manifold_tris == expect


@pytest.mark.parametrize("carry", [True, False])
def test_bridge_carries_the_rows(carry):
    """The bridge takes the JAX scene's man_tri, or without it makes the
    same rows from the triangle and material tables."""
    js, jst = SCENES["thin window"](jscene, jshapes, jbsdf)
    ts, tst = SCENES["thin window"](tscene, tshapes, tbsdf, device="cpu")
    arrays = jax_scene_arrays(js)
    if carry:
        arrays["man_tri"] = np.asarray(js.man_tri)
    bs, bst = bridge.scene_from_arrays(arrays, dataclasses.asdict(jst),
                                       device="cpu")
    assert bst == tst
    assert torch.equal(bs.man_tri, ts.man_tri)
