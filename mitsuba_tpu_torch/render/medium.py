"""Participating media (port of ``mitsuba_tpu/render/medium.py``; the
reference's src/medium/{homogeneous,heterogeneous}.cpp and the grid volumes
of src/volume/gridvolume.cpp).

* homogeneous: closed-form Beer-Lambert transmittance; free-flight sampling
  by a per-channel mixture (the balance heuristic over RGB);
* heterogeneous: a trilinear density grid, with delta (Woodcock) tracking
  for free flights and ratio tracking for transmittance, each step against
  the local majorant of an 8^3 supergrid of dilated per-cell maxima, so
  empty space is crossed in one DDA step.

A lane's current medium is an int32 id (-1: vacuum); a material's interior
and exterior medium ids swap it where a path crosses the surface.

The tracking loops are host loops over steps with per-lane ``done`` masks.
A finished lane keeps its state in both loop bodies, so a loop may run on
past the last lane's end without changing a bit: it tests for live lanes
every ``CHECK_EVERY`` steps (each test is a host sync) and stops at
``MAX_TRACKING_STEPS`` as the JAX while_loop does. Each step draws at a
host-int dimension, which the low-discrepancy samplers need. ``STEPS``
counts the steps the loops ran, for the measurements.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..core import rng as rng_mod

HOMOGENEOUS = 0
HETEROGENEOUS = 1

MAX_TRACKING_STEPS = 256
SUPER_RES = 8            # majorant supergrid resolution per axis
CHECK_EVERY = 4          # tracking steps between tests for live lanes
DRAW_BLOCK = 16          # tracking steps whose draws are hashed at once

# what the tracking loops did since the last reset (host counts): the steps
# of delta tracking ("distance") and of ratio tracking ("transmittance"),
# the loops that ran a step, and the host seconds inside the loops
# ("loop_s") and blocked in their tests for live lanes ("sync_s")
STEPS = {"distance": 0, "transmittance": 0, "loops": 0, "loop_s": 0.0,
         "sync_s": 0.0}


def reset_steps() -> None:
    for k in STEPS:
        STEPS[k] = 0.0 if k.endswith("_s") else 0


class MediumTable(NamedTuple):
    """One row per medium, and the padded stack of density grids."""

    type: torch.Tensor         # (K,) int32
    sigma_t: torch.Tensor      # (K, 3) extinction
    albedo: torch.Tensor       # (K, 3) single-scattering albedo
    phase_type: torch.Tensor   # (K,) int32
    phase_g: torch.Tensor      # (K,)
    phase_g2: torch.Tensor     # (K,) mixture's second HG lobe
    phase_w2: torch.Tensor     # (K,) mixture's weight of lobe 2
    phase_ks: torch.Tensor     # (K,) kkay specular weight
    phase_exp: torch.Tensor    # (K,) kkay specular exponent
    phase_sigma: torch.Tensor  # (K,) microflake flake std dev
    phase_axis: torch.Tensor   # (K, 3) fiber tangent (kkay, microflake)
    scale: torch.Tensor        # (K,) density scale
    grid_idx: torch.Tensor     # (K,) int32 into the stack, -1: homogeneous
    grids: torch.Tensor        # (G, D, H, W) densities, zero-padded
    grid_size: torch.Tensor    # (G, 3) int32 (D, H, W) of each grid
    world_to_grid: torch.Tensor  # (K, 4, 4) per medium
    majorant: torch.Tensor     # (K,) max sigma_t (the global bound)
    # per supercell the max raw density over the cell dilated by one voxel
    # (the dilation covers the trilinear support and the boundary nudge)
    super_maj: torch.Tensor    # (G, S, S, S), S = SUPER_RES

    @staticmethod
    def empty(device) -> "MediumTable":
        def f(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        def i(x):
            return torch.tensor(x, dtype=torch.int32, device=device)

        return MediumTable(
            type=i([0]), sigma_t=f([[1.0] * 3]), albedo=f([[0.5] * 3]),
            phase_type=i([0]), phase_g=f([0.0]), phase_g2=f([0.0]),
            phase_w2=f([0.0]), phase_ks=f([0.0]), phase_exp=f([4.0]),
            phase_sigma=f([0.3]), phase_axis=f([[0.0, 0.0, 1.0]]),
            scale=f([1.0]), grid_idx=i([-1]), grids=f([[[[0.0]]]]),
            grid_size=i([[1, 1, 1]]),
            world_to_grid=torch.eye(4, device=device)[None],
            majorant=f([1.0]), super_maj=f([[[[1.0]]]]))


class MediumSample(NamedTuple):
    sampled: torch.Tensor  # (R,) bool: a scattering event before the surface
    t: torch.Tensor        # (R,) its distance (or the surface's)
    p: torch.Tensor        # (R, 3) its position
    weight: torch.Tensor   # (R, 3) throughput factor


def _affine(w2g, p, point: bool):
    """Rows 0-2 of w2g (R, 4, 4) applied to p (R, 3) as a point (w = 1) or a
    vector, the products summed in column order."""
    out = (w2g[..., :3, 0] * p[..., 0:1] + w2g[..., :3, 1] * p[..., 1:2]
           + w2g[..., :3, 2] * p[..., 2:3])
    return out + w2g[..., :3, 3] if point else out


class _GridLanes(NamedTuple):
    """The loop-invariant per-lane terms of the tracking steps."""

    w2g: torch.Tensor      # (R, 4, 4) world to grid
    gp0: torch.Tensor      # (R, 3) the ray in grid space: gp0 + t dg
    dg: torch.Tensor       # (R, 3)
    inv: torch.Tensor      # (R, 3) 1 / dg (kept off 0)
    nudge: torch.Tensor    # (R,) ~1e-3 voxel in t
    size1: torch.Tensor    # (R, 3) grid size - 1 along (x, y, z)
    vox_base: torch.Tensor  # (R,) int64 first row of the grid's voxels
    cell_base: torch.Tensor  # (R,) int64 first row of its supercells
    scale: torch.Tensor    # (R,) the medium's density scale


def _grid_lanes(med: MediumTable, mid, o, d) -> _GridLanes:
    """The lanes' grids (grid 0 on a homogeneous lane) and rays in grid
    space. The transform is the lane's medium's own; the JAX package reads
    the grid_idx-th medium's (ROADMAP.md, Queue 3), which is the same
    wherever a scene's grid media come first and in grid order."""
    gi = torch.clamp(med.grid_idx[mid], min=0).to(torch.int64)
    w2g = med.world_to_grid[mid]
    gp0, dg = _affine(w2g, o, True), _affine(w2g, d, False)
    S = med.super_maj.shape[1]
    inv = 1.0 / torch.where(torch.abs(dg) < 1e-12,
                            torch.where(dg < 0, -1e-12, 1e-12), dg)
    nudge = 1e-3 / (S * torch.clamp(torch.amax(torch.abs(dg), dim=-1),
                                    min=1e-12))
    size1 = med.grid_size[gi].to(torch.float32).flip(-1) - 1
    return _GridLanes(w2g=w2g, gp0=gp0, dg=dg, inv=inv, nudge=nudge,
                      size1=size1, vox_base=gi * med.grids.shape[1],
                      cell_base=gi * S, scale=med.scale[mid])


def _lookup_density(med: MediumTable, gl: _GridLanes, p):
    """Trilinear grid density at world positions p, times the medium's
    scale (0 outside the grid's unit cube): the eight voxels in one
    gather, the JAX package's products and sums per lane."""
    gp = _affine(gl.w2g, p, True)
    _, D, H, W = med.grids.shape
    hi = torch.tensor([W - 1, H - 1, D - 1], device=p.device)
    xyz = gp * gl.size1                       # voxel units, (x, y, z)
    inside = ((gp >= 0) & (gp <= 1)).all(dim=-1)
    i0 = torch.minimum(torch.clamp(torch.floor(xyz).to(torch.int64), min=0),
                       hi)
    i1 = torch.minimum(i0 + 1, hi)
    f = torch.clamp(xyz - i0, 0.0, 1.0)
    x01, y01, z01 = (torch.stack([i0[..., k], i1[..., k]], dim=-1)
                     for k in range(3))
    rows = ((gl.vox_base[..., None] + z01)[..., :, None] * H
            + y01[..., None, :]) * W                    # (R, z, y)
    v = med.grids.reshape(-1)[rows[..., None] + x01[..., None, None, :]]

    def lerp(a, t):
        return a[..., 0] * (1 - t) + a[..., 1] * t

    c = lerp(v, f[..., 0, None, None])                  # (R, z, y)
    c = lerp(c, f[..., 1, None])                        # (R, z)
    dens = lerp(c, f[..., 2])
    return torch.where(inside, dens, 0.0) * gl.scale


def _super_step(med: MediumTable, gl: _GridLanes, t_cur):
    """One DDA query against the majorant supergrid at parameter t_cur.

    Returns (dmax, t_limit): inside the unit cube, the supercell's
    raw-density majorant and the parameter where the ray leaves the cell;
    outside with an entry ahead, 0 and the entry; outside with none, +inf
    (the caller's lane then runs past its end)."""
    S = med.super_maj.shape[1]
    gp = gl.gp0 + t_cur[..., None] * gl.dg
    inside = ((gp >= 0.0) & (gp <= 1.0)).all(dim=-1)
    c = torch.clamp(torch.floor(gp * S).to(torch.int64), 0, S - 1)
    dmax = med.super_maj.reshape(-1)[
        ((gl.cell_base + c[..., 2]) * S + c[..., 1]) * S + c[..., 0]]
    cf = c.to(torch.float32)
    ins = inside[..., None]
    box_lo = torch.where(ins, cf / S, 0.0)
    box_hi = torch.where(ins, (cf + 1) / S, 1.0)
    t1 = (box_lo - gp) * gl.inv
    t2 = (box_hi - gp) * gl.inv
    t_far = torch.amin(torch.maximum(t1, t2), dim=-1)   # exit (inside)
    t_near = torch.amax(torch.minimum(t1, t2), dim=-1)  # entry (outside)
    miss = ~inside & ((t_near > t_far) | (t_far < 0.0))
    # past the boundary by ~1e-3 voxel (the dilation covers it)
    t_limit = torch.where(
        inside, t_cur + t_far + gl.nudge,
        torch.where(miss, torch.inf,
                    t_cur + torch.clamp(t_near, min=0.0) + gl.nudge))
    return torch.where(inside, dmax, 0.0), t_limit


def _free_flight(u, maj_loc):
    return -torch.log(torch.clamp(1.0 - u, min=1e-20)) / maj_loc


def _draws(sampler, pixel, sample, dim: int, n: int):
    """uniform2 at dimensions dim .. dim + n - 1, (n, R, 2): the independent
    sampler's in one batched hash (the same bits per dimension), the
    low-discrepancy samplers' one host-int dimension at a time."""
    if rng_mod._sampler(sampler).kind in rng_mod._QMC_TYPES:
        return torch.stack([rng_mod.uniform2(sampler, pixel, sample, dim + k)
                            for k in range(n)])
    dims = torch.arange(dim, dim + n, device=pixel.device)[:, None]
    return rng_mod.uniform2(sampler, pixel, sample, dims)


def _run(body, state, done_of, key, sampler, pixel, sample, dim):
    """Run ``body(u2, state)`` until every lane is done (tested every
    CHECK_EVERY steps) or MAX_TRACKING_STEPS; step k draws u2 at dimension
    dim + k, DRAW_BLOCK steps' draws at once. Counts the steps."""
    t0 = time.perf_counter()
    step = 0
    while step < MAX_TRACKING_STEPS:
        if step % CHECK_EVERY == 0:
            ts = time.perf_counter()
            live = bool((~done_of(state)).any())
            STEPS["sync_s"] += time.perf_counter() - ts
            if not live:
                break
        if step % DRAW_BLOCK == 0:
            block = _draws(sampler, pixel, sample, dim + step,
                           min(DRAW_BLOCK, MAX_TRACKING_STEPS - step))
        state = body(block[step % DRAW_BLOCK], state)
        step += 1
    STEPS[key] += step
    STEPS["loops"] += step > 0
    STEPS["loop_s"] += time.perf_counter() - t0
    return state


def sample_distance(med: MediumTable, static_types, medium_id, o, d, t_surf,
                    sampler, pixel, sample, dim: int, active) -> MediumSample:
    """Medium::sampleDistance for the whole lane batch: medium_id (R,)
    int32 (-1: vacuum), t_surf (R,) the distance to the next surface. Draws
    at dimension ``dim`` (uniform4) and, per tracking step k, dim + 2 + k."""
    R = o.shape[0]
    dev = o.device
    mid = torch.clamp(medium_id, min=0).to(torch.int64)
    in_medium = active & (medium_id >= 0)
    u = rng_mod.uniform4(sampler, pixel, sample, dim)

    sampled = torch.zeros(R, dtype=torch.bool, device=dev)
    t_out = t_surf
    weight = torch.ones((R, 3), device=dev)
    mtype = med.type[mid]

    if HOMOGENEOUS in static_types:
        sig = med.sigma_t[mid] * med.scale[mid][..., None]
        # a channel picked uniformly; the pdfs are the mixture's
        ch = torch.clamp((u[..., 0] * 3).to(torch.int64), max=2)
        sig_ch = torch.gather(sig, -1, ch[..., None])[..., 0]
        sig_ch = torch.clamp(sig_ch, min=1e-12)
        t_s = _free_flight(u[..., 1], sig_ch)
        hit_medium = t_s < t_surf
        t_h = torch.minimum(t_s, t_surf)
        tr = torch.exp(-sig * t_h[..., None])
        pdf_scatter = torch.mean(sig * tr, dim=-1)
        pdf_pass = torch.mean(tr, dim=-1)
        sigma_s = sig * med.albedo[mid]
        w_scatter = sigma_s * tr / torch.clamp(pdf_scatter, min=1e-20)[..., None]
        w_pass = tr / torch.clamp(pdf_pass, min=1e-20)[..., None]
        is_h = in_medium & (mtype == HOMOGENEOUS)
        sampled = torch.where(is_h, hit_medium, sampled)
        t_out = torch.where(is_h, t_h, t_out)
        weight = torch.where(
            is_h[..., None],
            torch.where(hit_medium[..., None], w_scatter, w_pass), weight)

    if HETEROGENEOUS in static_types:
        # delta tracking against each supercell's majorant, each flight
        # bounded by the cell's exit (the exponential is memoryless, so a
        # restart at the boundary with the next majorant is unbiased)
        is_het = in_medium & (mtype == HETEROGENEOUS)
        gl = _grid_lanes(med, mid, o, d)
        sig_lum = torch.mean(med.sigma_t[mid], dim=-1)
        sigm = sig_lum * gl.scale

        def body(u2, state):
            t_cur, done, scat = state
            dmax, t_limit = _super_step(med, gl, t_cur)
            maj_loc = torch.clamp(sigm * dmax, min=1e-12)
            t_new = t_cur + _free_flight(u2[..., 0], maj_loc)
            crossed = t_new > t_limit          # empty or outside cells too
            t_new = torch.minimum(t_new, t_limit)
            past = t_new >= t_surf
            p_new = o + t_new[..., None] * d
            dens = _lookup_density(med, gl, p_new)
            real = ~crossed & (u2[..., 1] < sig_lum * dens / maj_loc)
            newly_scat = ~done & ~past & real & is_het
            newly_done = ~done & (past | newly_scat)
            return (torch.where(done, t_cur, torch.minimum(t_new, t_surf)),
                    done | newly_done | ~is_het, scat | newly_scat)

        t_trk, _, scat = _run(
            body, (torch.zeros(R, device=dev), ~is_het,
                   torch.zeros(R, dtype=torch.bool, device=dev)),
            lambda s: s[1], "distance", sampler, pixel, sample, dim + 2)
        t_h = torch.where(scat, t_trk, t_surf)
        # a real collision weighs sigma_s / sigma_t, a pass 1
        sampled = torch.where(is_het, scat, sampled)
        t_out = torch.where(is_het, t_h, t_out)
        weight = torch.where(
            is_het[..., None],
            torch.where(scat[..., None], med.albedo[mid], 1.0), weight)

    p_out = o + t_out[..., None] * d
    return MediumSample(sampled=sampled & in_medium, t=t_out, p=p_out,
                        weight=weight)


def eval_transmittance(med: MediumTable, static_types, medium_id, o, d, dist,
                       sampler, pixel, sample, dim: int, active):
    """Medium::evalTransmittance along segments inside one medium each:
    closed form for a homogeneous lane, one ratio-tracking estimate for a
    heterogeneous one (tracking step k draws at dim + 32 + k). Returns
    (R, 3); 1 on vacuum and inactive lanes."""
    R = o.shape[0]
    dev = o.device
    mid = torch.clamp(medium_id, min=0).to(torch.int64)
    in_medium = active & (medium_id >= 0)
    tr = torch.ones((R, 3), device=dev)
    mtype = med.type[mid]

    if HOMOGENEOUS in static_types:
        sig = med.sigma_t[mid] * med.scale[mid][..., None]
        tr_h = torch.exp(-sig * torch.clamp(dist, max=1e7)[..., None])
        is_h = in_medium & (mtype == HOMOGENEOUS)
        tr = torch.where(is_h[..., None], tr_h, tr)

    if HETEROGENEOUS in static_types:
        is_het = in_medium & (mtype == HETEROGENEOUS)
        gl = _grid_lanes(med, mid, o, d)
        sig_lum = torch.mean(med.sigma_t[mid], dim=-1)
        sigm = sig_lum * gl.scale

        def body(u2, state):
            t_cur, done, w = state
            dmax, t_limit = _super_step(med, gl, t_cur)
            maj_loc = torch.clamp(sigm * dmax, min=1e-12)
            t_new = t_cur + _free_flight(u2[..., 0], maj_loc)
            crossed = t_new > t_limit
            t_new = torch.minimum(t_new, t_limit)
            past = t_new >= dist
            p_new = o + t_new[..., None] * d
            dens = _lookup_density(med, gl, p_new)
            ratio = torch.clamp(1.0 - sig_lum * dens / maj_loc, 0.0, 1.0)
            w_new = torch.where(~done & ~past & ~crossed, w * ratio, w)
            return (torch.where(done, t_cur, t_new), done | past | ~is_het,
                    w_new)

        _, _, w = _run(body, (torch.zeros(R, device=dev), ~is_het,
                              torch.ones(R, device=dev)),
                       lambda s: s[1], "transmittance", sampler, pixel, sample,
                       dim + 32)
        tr = torch.where(is_het[..., None], w[..., None].expand(R, 3), tr)
    return tr
