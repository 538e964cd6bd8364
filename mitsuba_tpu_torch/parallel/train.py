"""Differentiable inverse rendering: the training step (port of
``mitsuba_tpu/parallel/train.py`` on one card, so without its mesh).

Estimator: detached sampling. Every sampling decision (directions, lobe and
emitter picks, roulette) is taken with its pdf treated as a constant, while
the evaluated terms (BSDF values, emitted radiance, textures) carry
gradients: scene queries detach their rays (``scene.ray_intersect``,
``scene.occluded``) and the roulette probability is detached
(``integrators/path.py``). That gives unbiased interior gradients of BSDF
albedo and roughness, emitter radiance and texture contents.

torch autograd takes the place of ``jax.value_and_grad``, and
``torch.optim.Adam`` with optax's defaults the place of ``optax.adam``. The
parameters are leaf tensors with ``requires_grad``, updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import check_on, resolve_device
from ..render import api as api_mod
from ..render import film as film_mod

LEARNING_RATE = 2e-2


class ParamSpec(NamedTuple):
    """Which scene leaves are trainable."""

    albedo: bool = True
    emitter_radiance: bool = True
    roughness: bool = False
    texture_stack: bool = False


def split_params(scene, spec: ParamSpec) -> dict:
    """The trainable leaves of ``scene`` as a dict of fresh leaf tensors
    with ``requires_grad`` (the JAX package's names)."""
    leaves = {}
    if spec.albedo:
        leaves["albedo"] = scene.materials.albedo
    if spec.emitter_radiance:
        leaves["emitter_radiance"] = scene.emitters.radiance
    if spec.roughness:
        leaves["alpha"] = scene.materials.alpha
    if spec.texture_stack:
        leaves["tex_stack"] = scene.textures.stack
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in leaves.items()}


def merge_params(scene, params: dict):
    """``scene`` with the trained leaves put back, under the JAX package's
    clamps. ``torch.maximum``/``torch.minimum`` pass half the gradient to a
    value that sits exactly on a bound, as ``jnp.maximum``/``jnp.clip`` do
    (``torch.clamp`` would pass all of it). Only the texture stack is
    replaced: the MIP chain stays the one built from the bitmaps, as in the
    JAX package."""
    mats, ems, texs = scene.materials, scene.emitters, scene.textures

    def bound(x, v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    if "albedo" in params:
        mats = mats._replace(albedo=params["albedo"])
    if "alpha" in params:
        a = params["alpha"]
        mats = mats._replace(alpha=torch.maximum(a, bound(a, 1e-3)))
    if "emitter_radiance" in params:
        r = params["emitter_radiance"]
        ems = ems._replace(radiance=torch.maximum(r, bound(r, 0.0)))
    if "tex_stack" in params:
        t = params["tex_stack"]
        texs = texs._replace(stack=torch.minimum(
            torch.maximum(t, bound(t, 0.0)), bound(t, 1.0)))
    return scene._replace(materials=mats, emitters=ems, textures=texs)


def render_loss(scene, static, sensor, cfg, settings, target, sample_base: int,
                n_samples: int):
    """Mean squared error of one stochastic render pass (samples
    ``sample_base`` .. ``sample_base + n_samples - 1``) against ``target``."""
    film = film_mod.Film.empty(settings.height, settings.width, target.device)
    film = api_mod.render_pass(scene, static, sensor, cfg, settings, film,
                               sample_base, n_samples)
    img = film_mod.develop(film)
    return torch.mean((img - target) ** 2)


def adam(leaves):
    """``optax.adam(2e-2)``: the same learning rate, betas and eps."""
    return torch.optim.Adam(leaves, lr=LEARNING_RATE, betas=(0.9, 0.999),
                            eps=1e-8)


def make_train_step(scene_template, static, sensor, cfg, settings,
                    spec: ParamSpec, optimizer=None, n_samples: int = 4,
                    device=None):
    """The training step: (step, init) as in the JAX package.

    ``init(params)`` returns the optimizer state, a ``torch.optim`` optimizer
    over the leaves (``optimizer`` maps a list of leaves to one; Adam at
    2e-2 by default). ``step(params, opt_state, target, it)`` renders samples
    ``it * n_samples`` onwards, differentiates the loss, updates the leaves
    in place and returns (params, opt_state, loss). ``mark``, when given,
    is called with "forward", "backward" and "update" as each part ends
    (a timer's hook). Runs on ``device`` (CUDA by default), where the scene,
    sensor and target must live.
    """
    dev = resolve_device(device)
    check_on(scene_template.tri_p0, dev, "scene")
    check_on(sensor.to_world, dev, "sensor")
    make_optimizer = optimizer or adam

    def step(params, opt_state, target, it, mark=None):
        check_on(target, dev, "target")
        opt_state.zero_grad(set_to_none=True)
        scene = merge_params(scene_template, params)
        loss = render_loss(scene, static, sensor, cfg, settings, target,
                           int(it) * n_samples, n_samples)
        if mark is not None:
            mark("forward")
        loss.backward()
        if mark is not None:
            mark("backward")
        opt_state.step()
        if mark is not None:
            mark("update")
        return params, opt_state, loss.detach()

    def init(params):
        return make_optimizer(list(params.values()))

    return step, init
