"""Port parity, trainer layer: bench.py's training step (the Cornell variant of
bench.py:309-328: a bitmap-textured back wall and a GGX rough-conductor
panel; albedo, emitter radiance, alpha and the texture stack trainable) in
mitsuba_tpu_torch against the JAX package on the CPU, and the trainer's own
pieces.

The slice as a whole: one ``jax.jit(jax.value_and_grad(...))`` of the JAX
package's ``train.render_loss`` at 8x8, depth 3, roulette from depth 1,
spp 2, sample_base 2 and a constant target, under
``scripts/jax_train_ref.py``'s ``reference_estimator`` (rays detached at
scene queries as on the TPU path; finite derivatives of sqrt at 0 and of
quotients by tiny denominators, the same values), against the port's loss
and gradients on the same parameters (``bridge.params_from_arrays``). It is
the file's one JAX gradient compile, about 50 s.

Tolerances, each with its reason:
  * scene tables: exact (the same numpy arithmetic, cast at the end);
  * film, merge_params: exact values, gradients exact (the same rule at a
    clamp's bound: half the gradient);
  * Adam against optax: rtol 1e-6 / atol 1e-6, 5e-5 of the learning rate
    (float32 rounding of the same update in another order; after a step
    with a zero gradient the second moment is small and the ratio
    m / sqrt(v) carries a few ulps more);
  * the slice: loss rtol 1e-5, each gradient leaf within 1e-4 relative L2
    norm of the JAX one (float32 rounding of exp, log, trigonometric
    functions through three bounces; no lane takes another branch here);
  * finite differences of the port's own loss (same samples, so no Monte
    Carlo noise): rtol 2e-2, 5e-2 for the texture stack and 3e-2 for alpha,
    the float32 central-difference noise of these chains (the JAX package's
    tests/test_grad.py holds its own at the same bounds).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mitsuba_tpu.core.transform import Transform as JTransform
from mitsuba_tpu.parallel import train as jtrain
from mitsuba_tpu.render import api as japi
from mitsuba_tpu.render import bsdf as jbsdf
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import scene as jscene
from mitsuba_tpu.render import sensor as jsensor
from mitsuba_tpu.render.integrators.common import IntegratorConfig as JConfig
from mitsuba_tpu_torch import bridge
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.ops import cuda_intersect as tbf
from mitsuba_tpu_torch.parallel import train as ttrain
from mitsuba_tpu_torch.render import api as tapi
from mitsuba_tpu_torch.render import bsdf as tbsdf
from mitsuba_tpu_torch.render import film as tfilm
from mitsuba_tpu_torch.render import scene as tscene
from mitsuba_tpu_torch.render import sensor as tsensor
from mitsuba_tpu_torch.render.integrators import common as tcommon
from mitsuba_tpu_torch.render.integrators import path as tpath

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "scripts")]
import chip_smoke  # noqa: E402
import jax_train_ref  # noqa: E402

EYE, AT, UP, FOV = jax_train_ref.EYE, jax_train_ref.AT, jax_train_ref.UP, jax_train_ref.FOV
W = H = 8
DEPTH, RR_DEPTH, SPP, BASE = 3, 1, 2, 2
TARGET = 0.5
LEAVES = ("albedo", "emitter_radiance", "alpha", "tex_stack")
SLICE_GRAD_RTOL = 1e-4


def port_train_scene():
    """bench.py:309-328 with the port's builder (chip_smoke.py's)."""
    return chip_smoke.train_scene("cpu")[:2]


def _panel(builder, rough_type):
    """tests/test_grad.py:79-106: a GGX rough-conductor panel under a
    constant environment, with either package's builder."""
    rough = builder.add_material(type=rough_type, alpha=(0.3, 0.3),
                                 eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14),
                                 dist=1)
    v = np.array([[0.2, 0.1, 0.9], [0.8, 0.1, 0.9],
                  [0.8, 0.8, 0.8], [0.2, 0.8, 0.8]])
    builder.add_mesh(v, np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64), rough)
    builder.add_constant_emitter((0.8, 0.9, 1.0))
    return rough


def _sensor(w, h):
    return tsensor.make_perspective(Transform.look_at(EYE, AT, UP), FOV, w, h,
                                    device="cpu")


def _box(w, h, spp):
    return tapi.RenderSettings(width=w, height=h, spp=spp, spp_per_pass=spp,
                               filter_type=0)


@pytest.fixture(scope="module")
def jax_scenes():
    train = jax_train_ref.build_scene()
    b = jscene.SceneBuilder()
    _panel(b, jbsdf.ROUGH_CONDUCTOR)
    return {"train": train, "panel": b.build()}


@pytest.fixture(scope="module")
def port_scenes():
    b = tscene.SceneBuilder()
    _panel(b, tbsdf.ROUGH_CONDUCTOR)
    return {"train": port_train_scene(), "panel": b.build(device="cpu")}


BUILD_PATHS = ([("materials", f) for f in (
    "type", "dist", "albedo", "albedo_tex", "spec_refl", "eta", "k", "alpha",
    "twosided")] + [("textures", "stack"), ("textures", "mips")]
    + [("emitters", f) for f in ("type", "radiance", "pmf", "env_index",
                                 "env_map")] + [("tri_emitter",)])


@pytest.mark.parametrize("which", ["train", "panel"])
@pytest.mark.parametrize("path", BUILD_PATHS, ids=".".join)
def test_builder_matches_jax(jax_scenes, port_scenes, which, path):
    ref, out = jax_scenes[which][0], port_scenes[which][0]
    for p in path:
        ref, out = getattr(ref, p), getattr(out, p)
    ref, out = np.asarray(ref), out.numpy()
    assert out.dtype == ref.dtype, path
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("which", ["train", "panel"])
def test_builder_static_matches_jax(jax_scenes, port_scenes, which):
    jst = dataclasses.asdict(jax_scenes[which][1])
    for k, v in dataclasses.asdict(port_scenes[which][1]).items():
        assert v == jst[k], k


def test_bridge_carries_the_new_columns(jax_scenes, port_scenes):
    """scene_from_arrays of the JAX training scene gives the builder's
    material columns; a roughness texture still raises."""
    from test_torch_render import jax_scene_arrays
    scene, static = jax_scenes["panel"]
    arrays = jax_scene_arrays(scene)
    ps, pst = bridge.scene_from_arrays(arrays, dataclasses.asdict(static),
                                       device="cpu")
    assert pst == port_scenes["panel"][1] and pst.has_env
    for f in tbsdf.MaterialTable._fields:
        np.testing.assert_array_equal(
            getattr(ps.materials, f).numpy(),
            getattr(port_scenes["panel"][0].materials, f).numpy())
    arrays["materials"]["alpha_tex"] = np.array([0], np.int32)
    with pytest.raises(NotImplementedError):
        bridge.scene_from_arrays(arrays, dataclasses.asdict(static), device="cpu")


def test_splat_aligned_matches_jax():
    rs = np.random.default_rng(3)
    v = rs.normal(0.5, 1.0, (6, 5, 3)).astype(np.float32)
    v[0, 0, 1], v[1, 2, 0], v[3, 3, 2] = np.nan, np.inf, -np.inf
    base = rs.uniform(0, 1, (6, 5, 4)).astype(np.float32)
    ref = jfilm.splat_aligned(jfilm.Film(data=jnp.asarray(base)), jnp.asarray(v))
    out = tfilm.splat_aligned(tfilm.Film(data=torch.from_numpy(base)),
                              torch.from_numpy(v))
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(ref.data))
    # negative samples keep their weight here, unlike splat_grid's
    assert (v < 0).any() and out.data[..., 3].sum() == base[..., 3].sum() + 27


@pytest.mark.parametrize("leaf", LEAVES)
def test_merge_params_matches_jax(jax_scenes, port_scenes, leaf):
    """Clamped values, and gradients through the clamps, with values below,
    on and above each bound (JAX passes half the gradient on a bound)."""
    vals = {"albedo": [-0.5, 0.0, 0.3], "emitter_radiance": [-1.0, 0.0, 2.0],
            "alpha": [5e-4, 1e-3, 0.3], "tex_stack": [-0.5, 0.0, 1.0, 1.5, 0.3]}
    jscene_, tscene_ = jax_scenes["train"][0], port_scenes["train"][0]
    shape = np.asarray(jtrain.split_params(jscene_, jax_train_ref.SPEC)[leaf]).shape
    x = np.resize(np.asarray(vals[leaf], np.float32), shape)
    cot = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    pick = {"albedo": lambda s: s.materials.albedo,
            "emitter_radiance": lambda s: s.emitters.radiance,
            "alpha": lambda s: s.materials.alpha,
            "tex_stack": lambda s: s.textures.stack}[leaf]

    jout, vjp = jax.vjp(lambda p: pick(jtrain.merge_params(jscene_, {leaf: p})),
                        jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    p = bridge.params_from_arrays({leaf: x}, device="cpu")
    tout = pick(ttrain.merge_params(tscene_, p))
    (tg,) = torch.autograd.grad(tout, [p[leaf]], torch.from_numpy(cot))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_params_roundtrip(jax_scenes):
    ref = {k: np.asarray(v) for k, v in
           jtrain.split_params(jax_scenes["train"][0], jax_train_ref.SPEC).items()}
    params = bridge.params_from_arrays(ref, device="cpu")
    assert set(params) == set(LEAVES)
    for k, v in params.items():
        assert v.is_leaf and v.requires_grad and v.dtype == torch.float32, k
    back = bridge.params_to_arrays(params)
    for k in ref:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], ref[k])


def test_adam_matches_optax():
    """torch.optim.Adam through ttrain.adam against optax.adam(2e-2), three
    steps with the same given gradients."""
    rs = np.random.default_rng(8)
    shapes = {"albedo": (6, 3), "emitter_radiance": (1, 3), "alpha": (6, 2),
              "tex_stack": (4096, 3)}
    p0 = {k: rs.uniform(0.1, 0.9, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.normal(0, 1e-2, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    grads[1]["albedo"][:] = 0.0  # a step with a zero gradient, as step 0's
    opt = optax.adam(2e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = bridge.params_from_arrays(p0, device="cpu")
    topt = ttrain.adam(list(tp.values()))
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


# --- the slice as a whole ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_slice(jax_scenes):
    """The JAX package's loss and gradients: one value_and_grad compile."""
    scene, static = jax_scenes["train"]
    sens = jsensor.make_perspective(JTransform.look_at(EYE, AT, UP), FOV, W, H)
    cfg = JConfig(type=tcommon.PATH, max_depth=DEPTH, rr_depth=RR_DEPTH)
    st = japi.RenderSettings(width=W, height=H, spp=SPP, spp_per_pass=SPP,
                             filter_type=0)
    params = jtrain.split_params(scene, jax_train_ref.SPEC)
    target = jnp.full((H, W, 3), TARGET)

    def loss(p):
        return jtrain.render_loss(jtrain.merge_params(scene, p), static, sens,
                                  cfg, st, target, BASE, SPP)

    with jax_train_ref.reference_estimator():
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return dict(params={k: np.asarray(v) for k, v in params.items()},
                loss=float(value), grads={k: np.asarray(v) for k, v in grads.items()})


def _port_loss_grads(port_scenes, params_np, cfg=None, target=TARGET):
    scene, static = port_scenes["train"]
    cfg = cfg or tcommon.IntegratorConfig(max_depth=DEPTH, rr_depth=RR_DEPTH)
    params = bridge.params_from_arrays(params_np, device="cpu")
    loss = ttrain.render_loss(ttrain.merge_params(scene, params), static,
                              _sensor(W, H), cfg, _box(W, H, SPP),
                              torch.full((H, W, 3), target), BASE, SPP)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(params, grads)}


@pytest.fixture(scope="module")
def port_slice(port_scenes, jax_slice):
    return _port_loss_grads(port_scenes, jax_slice["params"])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_slice_loss_matches_jax(jax_slice, port_slice):
    np.testing.assert_allclose(port_slice[0], jax_slice["loss"], rtol=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_slice_gradients_match_jax(jax_slice, port_slice, leaf):
    ref, out = jax_slice["grads"][leaf], port_slice[1][leaf]
    assert np.isfinite(out).all() and np.abs(ref).max() > 0
    assert _rel_l2(out, ref) <= SLICE_GRAD_RTOL, _rel_l2(out, ref)


def test_roulette_probability_is_detached(port_scenes, jax_slice, monkeypatch):
    """Fault 1: with q carrying a gradient, the 1/q of the survivors sends
    gradient into everything thr depends on, and the albedo gradient leaves
    the JAX package's."""
    def live_q(thr, eta):
        return torch.clamp(torch.amax(thr, dim=-1) * eta * eta, max=0.95)

    monkeypatch.setattr(tpath, "roulette_probability", live_q)
    _, grads = _port_loss_grads(port_scenes, jax_slice["params"])
    assert _rel_l2(grads["albedo"], jax_slice["grads"]["albedo"]) > 1e-2


def test_queries_detach_their_rays(port_scenes):
    """Fault 2: a closest-hit query returns a record that is constant in
    the rays, on the CPU as from the kernels on the card."""
    scene, static = port_scenes["train"]
    o = torch.tensor([[0.5, 0.5, -1.0], [0.3, 0.4, 0.5]], requires_grad=True)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], requires_grad=True)
    its = tscene.ray_intersect(scene, static, o, d, 1e-4, torch.inf)
    assert bool(its.valid.all())
    for f in ("t", "p", "gn", "uv", "wi", "wi_world", "bary"):
        assert not getattr(its, f).requires_grad, f
    assert not its.sh_frame.n.requires_grad
    assert not tscene.occluded(scene, static, o, d, 0.0, 10.0).requires_grad


def test_kernels_see_only_detached_rays(port_scenes, monkeypatch):
    """K1/K2 carry no autograd.Function: in a training step their wrappers
    are called with detached rays only, once per bounce and sample."""
    seen = {"interaction": [], "closest_hit": []}

    def spy(name, fn):
        def wrapper(*args):
            seen[name].append(args[-4].requires_grad or args[-3].requires_grad)
            return fn(*args)
        return wrapper

    monkeypatch.setattr(tbf, "brute_force_interaction",
                        spy("interaction", tbf.brute_force_interaction))
    monkeypatch.setattr(tbf, "brute_force_closest_hit",
                        spy("closest_hit", tbf.brute_force_closest_hit))
    scene, static = port_scenes["train"]
    spec = jax_train_ref.SPEC
    step, init = ttrain.make_train_step(
        scene, static, _sensor(W, H), tcommon.IntegratorConfig(max_depth=DEPTH),
        _box(W, H, SPP), ttrain.ParamSpec(*spec), n_samples=SPP, device="cpu")
    params = ttrain.split_params(scene, ttrain.ParamSpec(*spec))
    step(params, init(params), torch.full((H, W, 3), TARGET), 1)
    assert seen == {"interaction": [False] * DEPTH * SPP,
                    "closest_hit": [False] * DEPTH * SPP}


# --- the trainer ---------------------------------------------------------------

def _trainer(port_scenes, depth=DEPTH):
    scene, static = port_scenes["train"]
    spec = ttrain.ParamSpec(*jax_train_ref.SPEC)
    cfg = tcommon.IntegratorConfig(max_depth=depth)
    step, init = ttrain.make_train_step(scene, static, _sensor(W, H), cfg,
                                        _box(W, H, SPP), spec, n_samples=SPP,
                                        device="cpu")
    return scene, static, cfg, spec, step, init


def test_step0_renders_the_targets_samples(port_scenes):
    """bench's step 0 renders samples 0 and 1, the target's own: loss 0 and
    every gradient 0, so render and the trainer's render_pass agree."""
    scene, static, cfg, spec, step, init = _trainer(port_scenes)
    target = tapi.render(scene, static, _sensor(W, H), cfg, _box(W, H, SPP),
                         device="cpu")
    params = ttrain.split_params(scene, spec)
    before = {k: v.detach().clone() for k, v in params.items()}
    params, _, loss = step(params, init(params), target, 0)
    assert float(loss) == 0.0
    for k, v in params.items():
        assert float(v.grad.abs().max()) == 0.0, k
        assert torch.equal(v.detach(), before[k]), k  # Adam moved nothing


def test_step_is_the_gradients_fed_to_adam(port_scenes):
    """One make_train_step step = the port's own gradients of render_loss
    fed to optax.adam(2e-2)."""
    scene, static, cfg, spec, step, init = _trainer(port_scenes)
    target = torch.full((H, W, 3), TARGET)
    p0 = ttrain.split_params(scene, spec)
    loss = ttrain.render_loss(ttrain.merge_params(scene, p0), static,
                              _sensor(W, H), cfg, _box(W, H, SPP), target,
                              BASE, SPP)
    grads = dict(zip(p0, torch.autograd.grad(loss, list(p0.values()))))
    opt = optax.adam(2e-2)
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in p0.items()}
    upd, _ = opt.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()},
                        opt.init(jp), jp)
    ref = optax.apply_updates(jp, upd)
    params = ttrain.split_params(scene, spec)
    params, _, loss1 = step(params, init(params), target, BASE // SPP)
    assert float(loss1) == float(loss.detach())
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_trainer_needs_cuda_unless_cpu_is_asked(port_scenes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, static = port_scenes["train"]
    args = (scene, static, _sensor(W, H), tcommon.IntegratorConfig(),
            _box(W, H, SPP), ttrain.ParamSpec())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.make_train_step(*args)
    ttrain.make_train_step(*args, device="cpu")


# --- finite differences of the port's own loss ----------------------------

FD_W = 12


def _fd_check(loss_of, theta0, eps, rtol):
    """d loss / d theta by autograd against central differences of the same
    estimator (same samples: no Monte Carlo noise)."""
    theta = torch.tensor(theta0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(loss_of(theta), theta)
    with torch.no_grad():
        g_fd = (float(loss_of(torch.tensor(theta0 + eps)))
                - float(loss_of(torch.tensor(theta0 - eps)))) / (2 * eps)
    assert g_fd != 0.0
    np.testing.assert_allclose(float(g_ad), g_fd, rtol=rtol)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_match_finite_differences(port_scenes, leaf):
    """Depth 3, below rr_depth, 8 spp at 12x12, target 0.2, as
    tests/test_grad.py: albedo (material 0), radiance and the texture stack
    (scaled by theta; its target the render at theta = 0.5) on the training
    scene; alpha on the constant-env
    panel, where no geometry follows the sampled lobe, so the loss is
    continuous in alpha and the differences equal the detached gradient."""
    which = "panel" if leaf == "alpha" else "train"
    scene, static = port_scenes[which]
    cfg = tcommon.IntegratorConfig(max_depth=3)
    st = _box(FD_W, FD_W, 8)
    sens = _sensor(FD_W, FD_W)
    target = torch.full((FD_W, FD_W, 3), 0.2)
    mats, ems, texs = scene.materials, scene.emitters, scene.textures
    if leaf == "tex_stack":
        # the texture moves the loss against a constant target by less than
        # a float32 step of it; against the render with the stack at half
        # (the same samples) the loss is the texture's alone
        half = scene._replace(textures=texs._replace(stack=texs.stack * 0.5))
        target = tapi.render(half, static, sens, cfg, st, device="cpu")

    def with_leaf(theta):
        if leaf == "albedo":
            alb = torch.cat([theta.expand(1, 3), mats.albedo[1:]])
            return scene._replace(materials=mats._replace(albedo=alb))
        if leaf == "emitter_radiance":
            return scene._replace(emitters=ems._replace(radiance=ems.radiance * theta))
        if leaf == "tex_stack":
            return scene._replace(textures=texs._replace(stack=texs.stack * theta))
        alpha = mats.alpha.clone()
        alpha = torch.where(torch.arange(len(alpha))[:, None] == 0, theta, alpha)
        return scene._replace(materials=mats._replace(alpha=alpha))

    def loss_of(theta):
        return ttrain.render_loss(with_leaf(theta), static, sens, cfg, st,
                                  target, 0, st.spp)

    theta0, rtol = {"albedo": (0.5, 2e-2), "emitter_radiance": (1.0, 2e-2),
                    "tex_stack": (0.8, 5e-2), "alpha": (0.3, 3e-2)}[leaf]
    _fd_check(loss_of, theta0, 1e-3, rtol)
