"""The Metropolis family: pssmlt, mlt and erpt (port of
``mitsuba_tpu/render/integrators/mlt.py``).

* ``pssmlt`` (pssmlt.cpp, pssmlt_sampler.cpp): Kelemen's primary-sample-space
  MLT. A chain's state is the table of uniforms a path-tracer sample reads;
  a mutation is a symmetric small step of every number (mutate1D's s1 =
  1/1024, s2 = 1/64) or, with probability pLarge, a fresh table; the image
  is normalised by b, the mean luminance of uniform samples, and both the
  current and the proposed state splat with their expected weights
  (pssmlt_proc.cpp:140).
* ``mlt`` (mlt.cpp): the chain runs over the bidirectional tracer's
  sampling coordinates, and its target sums every (s, t) strategy of the
  subpath pair, the t = 0 light-image splats included. Its mutations: the
  whole pair drawn afresh (the bidirectional mutation), a small step of the
  sensor slots (lens), of the light's emission segment (caustic) or of
  every bounce (multi-chain), and, where the scene has specular spheres or
  mesh rows, the manifold perturbation of ``render/manifold.py``.
* ``erpt`` (erpt.cpp): path-traced seeds, each running a short chain of
  small steps that deposits an equal share of the seed's energy per
  mutation.

A chain is a lane: thousands of chains advance in lock-step, each
evaluation a whole ``path.li`` or ``bdpt.li_and_splats`` of every lane
with the chains' tables as its sampler (``rng.PssSampler``), so every ray
query goes through the port's kernels as a render's does. The film is a
scatter-add (``index_add_``), as bdpt's light image.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core import math as m
from ...core import qmc
from ...core import rng as rng_mod
from .. import bsdf as bsdf_mod
from .. import emitter as em_mod
from .. import manifold as mani
from .. import sensor as sensor_mod
from . import bdpt as int_bdpt
from . import common as icommon
from . import path as int_path

# Kelemen's mutation sizes (pssmlt_sampler.cpp)
_S1 = 1.0 / 1024.0
_S2 = 1.0 / 64.0
# log(s2 / s1) as the JAX package's float32 log gives it
_LOG_S2_S1 = float(np.float32(np.log(np.float32(_S2 / _S1))))

# mlt's strategies (mlt.cpp's portfolio)
STRAT_BIDIR = 0     # the whole pair drawn afresh (mut_bidir.cpp)
STRAT_LENS = 1      # small step of the sensor slots (mut_lens.cpp)
STRAT_CAUSTIC = 2   # small step of the emission segment (mut_caustic.cpp)
STRAT_MCHAIN = 3    # small step of every bounce slot (mut_mchain.cpp)
STRAT_MANIFOLD = 4  # the specular-manifold perturbation (mut_manifold.cpp)

MANIFOLD_THETA = 0.05  # half-angle of the exit direction's cone

# the last render's normalisation, acceptance and chain counts
# (api.render_mlt and render_erpt set them)
LAST_RUN = {}


def _manifold_capable(static) -> bool:
    """The manifold perturbation needs a dielectric and a chain it can walk:
    analytic spheres or specular-mesh rows (``Scene.man_tri``)."""
    has_diel = (bsdf_mod.DIELECTRIC in static.bsdf_types
                or bsdf_mod.THIN_DIELECTRIC in static.bsdf_types)
    return has_diel and (static.n_spheres > 0 or static.n_manifold_tris > 0)


def n_slots(cfg: icommon.IntegratorConfig) -> int:
    depth = cfg.max_depth if cfg.max_depth > 0 else 16
    return icommon.DIM_BASE + depth * icommon.DIMS_PER_BOUNCE


def n_slots_bdpt(cfg: icommon.IntegratorConfig) -> int:
    depth = cfg.max_depth if cfg.max_depth > 0 else 5
    return int_bdpt.DIM_LIGHT_BASE + depth * int_bdpt.DIMS_PER_BOUNCE


def fresh_table(seed, lane, step, nslots: int):
    """Independent uniforms for whole PSS tables, (R, nslots, 4) (a large
    step)."""
    dims = torch.arange(nslots, device=lane.device)[None, :]
    return rng_mod.uniform4(seed, lane[:, None], step, dims)


def luminance(L):
    return 0.212671 * L[..., 0] + 0.715160 * L[..., 1] + 0.072169 * L[..., 2]


def _lanes(u):
    return torch.arange(u.shape[0], dtype=torch.int64, device=u.device)


def eval_target(scene, static, sensor, cfg, width, height, u):
    """The path contribution of the PSS tables u (R, S, 4): (L (R, 3), I
    (R,) its luminance, film positions (R, 2) in pixels, ray queries)."""
    uv = u[:, icommon.DIM_SENSOR, :2]
    o, d = sensor_mod.sample_ray(sensor, uv, u[:, icommon.DIM_APERTURE, :2])
    L, n = int_path.li(scene, static, cfg, o, d, rng_mod.PssSampler(u),
                       _lanes(u), 0, with_stats=True)
    pos = uv * torch.tensor([width, height], dtype=torch.float32,
                            device=u.device)
    return L, luminance(L), pos, n


def eval_target_bdpt(scene, static, sensor, cfg, width, height, u):
    """The subpath pair's contribution of the coordinate tables u: (L of
    the lane's pixel (R, 3), splat_uv (Sn, R, 2), splat_val (Sn, R, 3), I
    (R,) the total luminance, film positions (R, 2), ray queries). The
    target I sums the lane pixel's strategies and the t = 0 light-image
    ones (the reference's splat list, pathsampler.cpp:764); a splat that
    was not made carries 0."""
    uv = u[:, icommon.DIM_SENSOR, :2]
    o, d = sensor_mod.sample_ray(sensor, uv, u[:, icommon.DIM_APERTURE, :2])
    L, sp_uv, sp_val, n = int_bdpt.li_and_splats(
        scene, static, cfg, sensor, o, d, rng_mod.PssSampler(u), _lanes(u),
        0, with_stats=True)
    ok = (sp_uv[..., 0] >= 0).to(torch.float32)
    sp_val = sp_val * ok[..., None]
    I = luminance(L) + torch.sum(luminance(sp_val), dim=0)
    pos = uv * torch.tensor([width, height], dtype=torch.float32,
                            device=u.device)
    return L, sp_uv, sp_val, I, pos, n


def small_step(u, r):
    """Kelemen's symmetric mutation of every component of u by the
    uniforms r (u's shape): a size log-uniform in (s1, s2], the sign from
    the same draw, wrapped to [0, 1) (pssmlt_sampler.cpp mutate1D)."""
    add = r < 0.5
    t = torch.where(add, 2.0 * r, 2.0 * (r - 0.5))
    dv = _S2 * torch.exp(-_LOG_S2_S1 * t)
    v = torch.where(add, u + dv, u - dv)
    return v - torch.floor(v)


def _slot_mask(nslots: int, strategy, device=None):
    """(..., nslots) bool: the slots each pssmlt-layout strategy perturbs
    (bidir: all; lens: the sensor slots; caustic: those and the last two
    bounces; mchain: every bounce)."""
    slots = torch.arange(nslots, device=device)
    sensor_slots = slots < icommon.DIM_BASE
    bounce_slots = ~sensor_slots
    last2 = slots >= (nslots - 2 * icommon.DIMS_PER_BOUNCE)
    table = torch.stack([torch.ones_like(sensor_slots), sensor_slots,
                         sensor_slots | (bounce_slots & last2),
                         bounce_slots])
    return table[strategy]


def _slot_masks_bdpt(nslots: int, device=None):
    """(small, fresh), each (4, nslots) bool, over the bidirectional layout:
    the slots a strategy's small step perturbs (lens: the sensor slots;
    caustic: the emission segment; mchain: both walks) and the slots it
    draws afresh (bidir: the whole pair, which also keeps the chains
    ergodic over the image)."""
    slots = torch.arange(nslots, device=device)
    sensor_slots = slots < icommon.DIM_BASE
    eye_slots = (slots >= icommon.DIM_BASE) & (slots < int_bdpt.DIM_LIGHT_EMIT)
    light_slots = slots >= int_bdpt.DIM_LIGHT_EMIT
    emit_seg = light_slots & (slots < int_bdpt.DIM_LIGHT_BASE
                              + int_bdpt.DIMS_PER_BOUNCE)
    none = torch.zeros_like(sensor_slots)
    small = torch.stack([none, sensor_slots, emit_seg,
                         eye_slots | light_slots])
    fresh = torch.stack([torch.ones_like(sensor_slots), none, none, none])
    return small, fresh


def _manifold_proposal(scene, static, u_cur, u_prop, is_mani, seed, lane,
                       step: int):
    """The specular-manifold perturbation (mut_manifold.cpp:770): the light
    subpath's chain exit direction turned inside a small symmetric cone,
    the emission pair that realises it Newton-solved (``manifold.py``), and
    the |det d omega / d u| ratio that corrects the acceptance. Lanes whose
    walk fails (no convergence, no round trip, or a light that is not an
    area) propose their current state. Returns (u_prop, jacobian ratio)."""
    e = int_bdpt.DIM_LIGHT_EMIT
    u2_e = u_cur[:, e + 1, :2]
    ers = em_mod.sample_ray(scene, static, u_cur[:, e, :], u2_e)
    mats = scene.materials
    sph_mat = scene.sph_mat.to(torch.int64)
    mtyp = mats.type[sph_mat]
    diel = (mtyp == bsdf_mod.DIELECTRIC) | (mtyp == bsdf_mod.THIN_DIELECTRIC)
    etas = torch.where(diel, mats.eta[sph_mat, 0], 1.0)
    mesh = scene.man_tri if static.n_manifold_tris > 0 else None
    geo = (scene.sph_center, scene.sph_radius, etas, mesh)
    o_l, n_l = ers.o, ers.n

    d0 = mani.chain_exit_dir(u2_e, o_l, n_l, *geo)
    r2 = rng_mod.uniform2(seed + 48611, lane, step, 1)
    d_t = mani.perturb_cone(d0, r2, MANIFOLD_THETA)
    u_new, ok_f = mani.solve_exit_dir(u2_e, o_l, n_l, d_t, *geo)
    # the reverse walk must come back to the current coordinates, else the
    # move is not reversible (a chain map of several roots): self-transition
    u_back, ok_r = mani.solve_exit_dir(u_new, o_l, n_l, d0, *geo)
    rt = torch.amax(torch.abs(u_back - u2_e), dim=-1) < 1e-3
    det0 = mani.det_omega(u2_e, o_l, n_l, *geo)
    det1 = mani.det_omega(u_new, o_l, n_l, *geo)
    ok = (is_mani & ers.valid & ers.is_area & ok_f & ok_r & rt
          & (det1 > 1e-12))
    jac_ratio = torch.where(ok, m.safe_div(det0, det1), 1.0)
    new2 = torch.where(ok[:, None], u_new, u2_e)
    out = u_prop.clone()
    out[:, e + 1, :2] = torch.where(is_mani[:, None], new2,
                                    u_prop[:, e + 1, :2])
    return out, jac_ratio


class ChainState(NamedTuple):
    u: torch.Tensor       # (R, S, 4) current PSS tables
    L: torch.Tensor       # (R, 3) current contributions
    I: torch.Tensor       # (R,) current luminances
    pos: torch.Tensor     # (R, 2) current film positions
    sp_uv: torch.Tensor   # (Sn, R, 2) current light-image splat uvs (mlt)
    sp_val: torch.Tensor  # (Sn, R, 3) current light-image splat values

    def where(self, take, other: "ChainState") -> "ChainState":
        """Per lane: ``other``'s fields where ``take`` (R,), else these."""
        def sel(a, b, view):
            return torch.where(take.view(view), a, b)

        return ChainState(
            u=sel(other.u, self.u, (-1, 1, 1)),
            L=sel(other.L, self.L, (-1, 1)),
            I=sel(other.I, self.I, (-1,)),
            pos=sel(other.pos, self.pos, (-1, 1)),
            sp_uv=sel(other.sp_uv, self.sp_uv, (1, -1, 1)),
            sp_val=sel(other.sp_val, self.sp_val, (1, -1, 1)))


def splat_box(film, pos, val, width: int, height: int):
    """Scatter-add of val (N, 3) at film positions pos (N, 2), in pixels,
    clamped to the film (H, W, 3), in place."""
    px = torch.clamp(pos[..., 0].to(torch.int32), 0, width - 1)
    py = torch.clamp(pos[..., 1].to(torch.int32), 0, height - 1)
    film.view(height * width, 3).index_add_(
        0, py.to(torch.int64) * width + px.to(torch.int64), val)
    return film


def _eval_state(scene, static, sensor, cfg, width, height, u,
                mlt_mode: bool):
    """(ChainState of u, ray queries) for either target."""
    if mlt_mode:
        L, sp_uv, sp_val, I, pos, n = eval_target_bdpt(
            scene, static, sensor, cfg, width, height, u)
    else:
        L, I, pos, n = eval_target(scene, static, sensor, cfg, width,
                                   height, u)
        R = u.shape[0]
        sp_uv = torch.zeros((0, R, 2), device=u.device)
        sp_val = torch.zeros((0, R, 3), device=u.device)
    return ChainState(u, L, I, pos, sp_uv, sp_val), n


def seed_chains(scene, static, sensor, cfg, width, height, seed,
                n_chains: int, rounds: int = 4, mlt_mode: bool = False,
                device=None):
    """Luminance-proportional chain seeds (the reference draws them from a
    luminance cdf over candidate samples, pssmlt_proc.cpp / mlt_proc.cpp):
    each lane reservoir-samples one of ``rounds`` fresh candidates with a
    probability proportional to its luminance. Returns (ChainState, ray
    queries)."""
    nslots = n_slots_bdpt(cfg) if mlt_mode else n_slots(cfg)
    lane = torch.arange(n_chains, dtype=torch.int64, device=device)
    # t = 0 strategies: s = 1..N (li_and_splats' splat list)
    Sn = (cfg.max_depth if cfg.max_depth > 0 else 5) if mlt_mode else 0
    st = ChainState(
        u=torch.zeros((n_chains, nslots, 4), device=device),
        L=torch.zeros((n_chains, 3), device=device),
        I=torch.zeros((n_chains,), device=device),
        pos=torch.zeros((n_chains, 2), device=device),
        sp_uv=torch.zeros((Sn, n_chains, 2), device=device),
        sp_val=torch.zeros((Sn, n_chains, 3), device=device))
    wsum = torch.zeros(n_chains, device=device)
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(rounds):
        u = fresh_table(seed + 7919, lane, k, nslots)
        cand, n = _eval_state(scene, static, sensor, cfg, width, height, u,
                              mlt_mode)
        n_rays = n_rays + n
        wsum_new = wsum + cand.I
        r = rng_mod.uniform1(seed + 104729, lane, k, 0)
        take = (r * wsum_new < cand.I) | (wsum <= 0)
        st = st.where(take, cand)
        wsum = wsum_new
    return st, n_rays


def chain_steps(scene, static, sensor, cfg, width, height, seed,
                st: ChainState, film, step_base: int, n_steps: int,
                mlt_mode: bool = False):
    """Advance every chain by n_steps mutations, splatting into film (in
    place). Both states splat with their expected weights (Veach's
    expected-value technique, pssmlt_proc.cpp:140): the film gathers, over
    mutations, a C'/I' + (1 - a) C/I; the caller scales it by b n_pixels /
    N. Under mlt the t = 0 splats of both states land with the same
    weights. Returns (state, film, mean acceptance (a tensor), ray
    queries)."""
    R, nslots = st.u.shape[0], st.u.shape[1]
    dev = st.u.device
    lane = torch.arange(R, dtype=torch.int64, device=dev)
    wpix = torch.tensor([width, height], dtype=torch.float32, device=dev)
    acc_sum = torch.zeros((), device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    if mlt_mode:
        n_strat = 5 if _manifold_capable(static) else 4
        small_m, fresh_m = _slot_masks_bdpt(nslots, dev)
    for k in range(n_steps):
        step = step_base + k
        r_sel = rng_mod.uniform4(seed + 15485863, lane, step, 0)
        r_mut = fresh_table(seed + 32452843, lane, step, nslots)
        u_fresh = fresh_table(seed, lane, step, nslots)
        jac_ratio = torch.ones(R, device=dev)
        if mlt_mode:
            strat = torch.clamp((r_sel[:, 0] * n_strat).to(torch.int32),
                                max=n_strat - 1).to(torch.int64)
            s4 = torch.clamp(strat, max=3)
            not_mani = (strat < 4)[:, None, None]
            mask_s = small_m[s4][:, :, None] & not_mani
            mask_f = fresh_m[s4][:, :, None] & not_mani
            u_prop = torch.where(mask_s, small_step(st.u, r_mut), st.u)
            u_prop = torch.where(mask_f, u_fresh, u_prop)
            if n_strat == 5:
                u_prop, jac_ratio = _manifold_proposal(
                    scene, static, st.u, u_prop, strat == STRAT_MANIFOLD,
                    seed, lane, step)
        else:
            large = r_sel[:, 0] < cfg.p_large
            u_prop = torch.where(large[:, None, None], u_fresh,
                                 small_step(st.u, r_mut))

        prop, n = _eval_state(scene, static, sensor, cfg, width, height,
                              u_prop, mlt_mode)
        n_rays = n_rays + n

        # jac_ratio: the manifold proposal's pushforward correction (1
        # elsewhere)
        a = torch.where(st.I > 0, torch.clamp(
            m.safe_div(prop.I, st.I) * jac_ratio, max=1.0), 1.0)
        w_prop = torch.where(prop.I > 0,
                             a / torch.clamp(prop.I, min=1e-20), 0.0)
        w_cur = torch.where(st.I > 0,
                            (1.0 - a) / torch.clamp(st.I, min=1e-20), 0.0)
        splat_box(film, st.pos, st.L * w_cur[:, None], width, height)
        splat_box(film, prop.pos, prop.L * w_prop[:, None], width, height)
        if mlt_mode:
            splat_box(film, (st.sp_uv * wpix).reshape(-1, 2),
                      (st.sp_val * w_cur[None, :, None]).reshape(-1, 3),
                      width, height)
            splat_box(film, (prop.sp_uv * wpix).reshape(-1, 2),
                      (prop.sp_val * w_prop[None, :, None]).reshape(-1, 3),
                      width, height)
        st = st.where(r_sel[:, 1] < a, prop)
        acc_sum = acc_sum + torch.mean(a)
    return st, film, acc_sum / max(n_steps, 1), n_rays


def estimate_b(scene, static, sensor, cfg, width, height, seed,
               n_samples: int, lanes: int = 8192, mlt_mode: bool = False,
               device=None):
    """The normalisation b = E_uniform[I(u)] (pssmlt.cpp:297-311) over
    n_samples samples in rounds of ``lanes``, flat sample ids (so the
    sample set does not depend on the rounds), the image-plane pair
    stratified over the id (i + u) / N and radical_inverse_2(i) + u mod 1.
    Returns (b (a tensor), ray queries)."""
    nslots = n_slots_bdpt(cfg) if mlt_mode else n_slots(cfg)
    lanes = min(lanes, max(n_samples, 1))
    rounds = -(-n_samples // lanes)
    n_total = rounds * lanes
    base = torch.arange(lanes, dtype=torch.int64, device=device)
    total = torch.zeros((), device=device)
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(rounds):
        gid = base + k * lanes
        u = fresh_table(seed + 49979687, gid, 0, nslots)
        s = icommon.DIM_SENSOR
        u0 = (gid.to(torch.float32) + u[:, s, 0]) / float(np.float32(n_total))
        u1 = torch.remainder(qmc.radical_inverse_lanes(0, gid) + u[:, s, 1],
                             1.0)
        u[:, s, 0] = u0
        u[:, s, 1] = u1
        cand, n = _eval_state(scene, static, sensor, cfg, width, height, u,
                              mlt_mode)
        n_rays = n_rays + n
        total = total + torch.sum(cand.I)
    return total / n_total, n_rays


def erpt_pass(scene, static, sensor, cfg, width, height, seed, film,
              pass_idx: int, n_seeds: int, chain_len: int):
    """One erpt pass (erpt_proc.cpp): n_seeds path-traced seeds, each
    running chain_len small-step mutations that deposit I_seed / chain_len
    of energy per mutation, into film (in place; the caller divides by the
    seeds per pixel). Returns (film, ray queries)."""
    nslots = n_slots(cfg)
    dev = film.device
    lane = torch.arange(n_seeds, dtype=torch.int64, device=dev)
    u0 = fresh_table(seed, lane, pass_idx, nslots)
    st, n_rays = _eval_state(scene, static, sensor, cfg, width, height, u0,
                             False)
    ed = st.I / float(chain_len)  # the energy each mutation deposits
    for k in range(chain_len):
        step = pass_idx * (chain_len + 1) + k + 1
        r_sel = rng_mod.uniform4(seed + 15485863, lane, step, 0)
        r_mut = fresh_table(seed + 32452843, lane, step, nslots)
        prop, n = _eval_state(scene, static, sensor, cfg, width, height,
                              small_step(st.u, r_mut), False)
        n_rays = n_rays + n
        a = torch.where(st.I > 0,
                        torch.clamp(m.safe_div(prop.I, st.I), max=1.0), 1.0)
        w_prop = torch.where(prop.I > 0,
                             a * ed / torch.clamp(prop.I, min=1e-20), 0.0)
        w_cur = torch.where(
            st.I > 0, (1.0 - a) * ed / torch.clamp(st.I, min=1e-20), 0.0)
        splat_box(film, st.pos, st.L * w_cur[:, None], width, height)
        splat_box(film, prop.pos, prop.L * w_prop[:, None], width, height)
        st = st.where(r_sel[:, 1] < a, prop)
    return film, n_rays
