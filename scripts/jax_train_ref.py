#!/usr/bin/env python
"""Loss and gradients of bench.py's training step through the JAX package on
the CPU: the reference that ``chip_smoke.py`` holds the PyTorch port's step
against.

    JAX_PLATFORMS=cpu python scripts/jax_train_ref.py [--size 512] \\
        [--out scripts/jax_train_ref.npz]

It repeats ``bench.py:time_train_step`` on the Cornell variant of
``bench.py:309-328`` (512x512, depth 5, spp 2, box filter, seed 0; albedo,
emitter radiance, GGX alpha and the texture stack trainable): the target is
``api.render`` of samples 0 and 1, and the reference is
``jax.value_and_grad`` of ``train.render_loss`` at the initial parameters for
samples 2 and 3 (sample_base 2), which is what bench's step with it = 1
differentiates: the Adam update of step 0, whose gradients are 0, leaves the
parameters where they were.

Patches make the JAX package's estimator the port's without changing a
value that the render computes (``reference_estimator``). Scene queries
detach their rays (``detached_queries``): on the CPU the JAX package
intersects with its jnp brute force, which does not detach, while its TPU
path (the Pallas kernels, scene.py:202-203, 243-244) does, and so does the
port. ``safe_sqrt``, ``safe_div`` and ``sin_theta`` get derivatives that
stay finite where the JAX package's turn to NaN in a dropped branch
(``gradient_safe_math``); without them the alpha gradient is NaN. Nothing in
``mitsuba_tpu`` changes on disk.

The loss is a mean over pixels and each pixel's value depends on its own
lanes alone, so the script sums ``render_loss``'s terms and their gradients
over chunks of ``--chunk`` pixels: each chunk renders its lanes as
``api.render_pass`` does (``pixel_sample_positions``, ``sample_ray``, ``li``
with the pixel spread, ``ray_weight``) and splats and develops them as
``film.splat_aligned`` and ``film.develop`` do, so that one process never
holds the whole wavefront's autograd residuals. At 32x32 with chunks of 256
the result equals one ``value_and_grad(train.render_loss)`` over the whole
image to float32 rounding.

Prints the JAX version, the arguments, the loss, each leaf's gradient norm
and sum, and the run's seconds; with ``--out``, writes the loss and the
gradients to an ``.npz`` (``scripts/jax_train_ref.npz``, which
``chip_smoke.py`` reads). At 512x512, 16 chunks: 75-95 s with a cold JAX
compile cache, 39 s with a warm one, with jax 0.9.0 on an 8-core CPU host.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from mitsuba_tpu.core import frame as frame_mod  # noqa: E402
from mitsuba_tpu.core import math as math_mod  # noqa: E402
from mitsuba_tpu.core import rng as rng_mod  # noqa: E402
from mitsuba_tpu.core.transform import Transform  # noqa: E402
from mitsuba_tpu.parallel import train as train_mod  # noqa: E402
from mitsuba_tpu.render import api  # noqa: E402
from mitsuba_tpu.render import bsdf as B  # noqa: E402
from mitsuba_tpu.render import scene as scene_mod  # noqa: E402
from mitsuba_tpu.render import sensor as sensor_mod  # noqa: E402
from mitsuba_tpu.render import shapes  # noqa: E402
from mitsuba_tpu.render.integrators import path as int_path  # noqa: E402
from mitsuba_tpu.render.integrators.common import (  # noqa: E402
    DIM_APERTURE, PATH, IntegratorConfig)
from mitsuba_tpu.render.scene import SceneBuilder  # noqa: E402

EYE, AT, UP, FOV = [0.5, 0.5, -1.39], [0.5, 0.5, 0.5], [0, 1, 0], 39.0
SPEC = train_mod.ParamSpec(albedo=True, emitter_radiance=True,
                           roughness=True, texture_stack=True)


def build_scene():
    """bench.py:309-328: the Cornell box with a bitmap-textured back wall
    and a GGX rough-conductor panel."""
    bt = SceneBuilder()
    shapes.cornell_box(bt)
    img_t = (0.25 + 0.5 * ((np.indices((64, 64)).sum(0) // 8) % 2)
             )[..., None].repeat(3, axis=-1).astype(np.float32)
    tex = bt.add_texture_bitmap(img_t)
    texmat = bt.add_material(albedo=(1.0, 1.0, 1.0), albedo_tex=tex)
    vq = np.array([[0.05, 0.05, 0.98], [0.95, 0.05, 0.98],
                   [0.95, 0.95, 0.98], [0.05, 0.95, 0.98]])
    fq = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64)
    uvq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    bt.add_mesh(vq, fq, texmat, uvs=uvq)
    rough = bt.add_material(type=B.ROUGH_CONDUCTOR, alpha=(0.25, 0.25),
                            eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14),
                            dist=1)
    vr = np.array([[0.15, 0.1, 0.9], [0.85, 0.1, 0.9],
                   [0.85, 0.8, 0.8], [0.15, 0.8, 0.8]])
    fr = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64)
    bt.add_mesh(vr, fr, rough)
    return bt.build()


def _safe_sqrt(x):
    """``core.math.safe_sqrt`` with a gradient of 0 where x <= 0 and the
    same values (the port's form)."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)),
                     jax.lax.stop_gradient(jnp.maximum(x, 0.0)))


def _sin_theta(w):
    """``core.frame.sin_theta`` through ``_safe_sqrt`` (its argument is
    never negative, so the same values)."""
    return _safe_sqrt(frame_mod.sin_theta_2(w))


@jax.custom_jvp
def _div(a, b):
    return a / b


@_div.defjvp
def _div_jvp(primals, tangents):
    """d(a/b) = (da - (a/b) db) / b: JAX's own rule forms b^-2, which
    overflows to inf for |b| < 5.4e-20."""
    a, b = primals
    da, db = tangents
    q = a / b
    return q, (da - q * db) / b


def _safe_div(a, b, eps: float = 1e-20):
    """``core.math.safe_div`` with the quotient differentiated through
    ``_div``; the same values."""
    ok = jnp.abs(b) > eps
    return jnp.where(ok, _div(a, jnp.where(ok, b, 1.0)), 0.0)


@contextlib.contextmanager
def gradient_safe_math():
    """``core.math.safe_sqrt``, ``core.math.safe_div`` and
    ``core.frame.sin_theta`` with gradients that stay finite where the JAX
    package's turn to NaN, and the same values (the port's forms, whose
    torch derivatives stay finite there).

    The rough conductor evaluates Beckmann and GGX on every lane and drops
    one with a ``where`` (on non-rough lanes both), so a derivative of inf
    in a dropped branch meets the ``where``'s 0 cotangent and makes NaN in
    that lane's material's alpha gradient. Three such infs: sqrt's at 0,
    which Beckmann's ``sample_all`` meets as sqrt(1 - ct^2) for uniforms
    below about 6e-6 (pixel 703 of bench's step at 32x32, sample 2), and
    ``sin_theta`` of a sampled direction that rounds onto the normal; and
    the quotient's b^-2 in ``safe_div`` for 1e-20 < |b| < 5.4e-20, which
    Beckmann's ``eval_d`` meets at cos theta near 1e-5. With ``safe_sqrt``
    and ``safe_div`` patched and ``sin_theta`` not, the alpha gradient of
    bench's step at 512x512 was still NaN; with all three it is finite."""
    saved = math_mod.safe_sqrt, math_mod.safe_div, frame_mod.sin_theta
    math_mod.safe_sqrt, math_mod.safe_div = _safe_sqrt, _safe_div
    frame_mod.sin_theta = _sin_theta
    try:
        yield
    finally:
        math_mod.safe_sqrt, math_mod.safe_div, frame_mod.sin_theta = saved


@contextlib.contextmanager
def detached_queries():
    """Every closest-hit query goes through ``scene.ray_intersect`` with
    ``o`` and ``d`` under ``stop_gradient``, as the TPU path queries."""
    inner = scene_mod.ray_intersect

    def ray_intersect(scene, static, o, d, *args, **kwargs):
        return inner(scene, static, jax.lax.stop_gradient(o),
                     jax.lax.stop_gradient(d), *args, **kwargs)

    scene_mod.ray_intersect = ray_intersect
    try:
        yield
    finally:
        scene_mod.ray_intersect = inner


@contextlib.contextmanager
def reference_estimator():
    """Both patches: the port's estimator in the JAX package."""
    with detached_queries(), gradient_safe_math():
        yield


def chunk_loss_fn(scene, static, sens, cfg, settings, sample_base, n_samples):
    """(params, target rows, pixel ids) -> the chunk's sum of squared
    errors: ``train.render_loss``'s terms for those pixels."""
    W, H = settings.width, settings.height
    seed = jnp.asarray(settings.seed, jnp.int32)
    spread = sensor_mod.pixel_spread(sens, W)

    def loss(params, target, pixel_idx):
        sc = train_mod.merge_params(scene, params)
        acc = jnp.zeros(target.shape)
        wsum = jnp.zeros(target.shape[:-1] + (1,))
        for s in range(n_samples):
            sample_idx = sample_base + s
            pos = api.pixel_sample_positions(settings, pixel_idx, sample_idx,
                                             seed)
            uv = pos / jnp.asarray([W, H], jnp.float32)
            u_ap = rng_mod.uniform2(seed, pixel_idx, sample_idx, DIM_APERTURE)
            o, d = sensor_mod.sample_ray(sens, uv, u_ap)
            L = int_path.li(sc, static, cfg, o, d, seed, pixel_idx,
                            sample_idx, pixel_spread=spread)
            L = L * sensor_mod.ray_weight(sens)
            finite = jnp.all(jnp.isfinite(L), axis=-1, keepdims=True)
            acc = acc + jnp.where(finite, L, 0.0)
            wsum = wsum + finite.astype(jnp.float32)
        img = acc / jnp.maximum(wsum, 1e-12)
        return jnp.sum((img - target) ** 2)

    return loss


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    W = H = args.size
    P = W * H
    chunk = min(args.chunk, P)
    if P % chunk:
        raise SystemExit("--chunk must divide the pixel count")
    t_start = time.perf_counter()

    scene, static = build_scene()
    sens = sensor_mod.make_perspective(Transform.look_at(EYE, AT, UP), FOV,
                                       W, H)
    cfg = IntegratorConfig(type=PATH, max_depth=args.depth)
    st = api.RenderSettings(width=W, height=H, spp=args.spp,
                            spp_per_pass=args.spp, filter_type=0)
    rng_mod.set_sampler(rng_mod.INDEPENDENT, n=args.spp)
    params = train_mod.split_params(scene, SPEC)
    with reference_estimator():
        target = np.asarray(api.render(scene, static, sens, cfg, st))
        t_target = time.perf_counter() - t_start
        vg = jax.jit(jax.value_and_grad(chunk_loss_fn(
            scene, static, sens, cfg, st, args.spp, args.spp)))
        flat_t = target.reshape(P, 3)
        loss = 0.0
        grads = {k: np.zeros(v.shape, np.float64) for k, v in params.items()}
        for c in range(0, P, chunk):
            lc, gc = vg(params, jnp.asarray(flat_t[c:c + chunk]),
                        jnp.arange(c, c + chunk, dtype=jnp.int32))
            loss += float(lc)
            for k in grads:
                grads[k] += np.asarray(gc[k], np.float64)
    n = P * 3
    loss /= n
    grads = {k: (v / n).astype(np.float32) for k, v in grads.items()}
    dt = time.perf_counter() - t_start
    print(f"jax {jax.__version__} backend {jax.default_backend()}; {W}x{H} "
          f"depth {args.depth} spp {args.spp} (target samples 0..{args.spp - 1}, "
          f"step samples {args.spp}..{2 * args.spp - 1}) box filter seed 0, "
          f"chunks of {chunk} pixels; target render {t_target:.1f} s, "
          f"total {dt:.1f} s")
    print(json.dumps({
        "loss": loss,
        "target_mean": target.mean(axis=(0, 1)).tolist(),
        "grad_norm": {k: float(np.linalg.norm(v)) for k, v in grads.items()},
        "grad_sum": {k: float(v.sum()) for k, v in grads.items()},
    }))
    if args.out:
        np.savez(args.out, loss=np.float64(loss), size=np.int64(W),
                 target_mean=target.mean(axis=(0, 1)),
                 **{f"grad_{k}": v for k, v in grads.items()})
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
