"""Subsurface scattering (port of ``mitsuba_tpu/render/subsurface.py``;
reference: src/subsurface/dipole.cpp, irrproc.cpp, singlescatter.cpp).

Two modes, chosen per profile (``SceneBuilder.add_subsurface``):

* the dipole (``MODE_DIPOLE``): ``prepare`` places an irradiance point cloud
  on the triangles whose material names a dipole profile (area-weighted,
  numpy's seeded generator on the host, so the points equal the JAX
  package's) and estimates each point's irradiance with NEE on the scene's
  device; at every hit on such a material the path tracer adds ``eval_lo``,
  the Jensen dipole's Rd summed over the points times a Fresnel
  transmittance. The sum is a dense (lanes x points) reduction, computed
  over lane chunks so its intermediates stay under about 2 GB;
* refracted single scattering (``MODE_SINGLESCATTER``,
  ``exact_single_scatter``): one scattering vertex per hit inside the body,
  found by real closest-hit queries for the chord and the exit, and a
  shadow query for the segment to the light. It needs no preparation.

As in the JAX package, ``prepare`` samples triangles only: a dipole profile
on an analytic sphere gathers no points of its own, so its Lo is 0 unless
triangles share the profile (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import rng as rng_mod

MODE_DIPOLE = 0         # dipole.cpp diffusion profile
MODE_SINGLESCATTER = 1  # singlescatter.cpp refracted single scattering

# elements of one (lanes x points x 3) intermediate of eval_lo's reduction:
# dipole_rd keeps about a dozen of them alive at once, so 2^25 float32
# elements (128 MiB) each keep its peak under about 2 GB
LO_CHUNK_ELEMS = 1 << 25


class SSSTable(NamedTuple):
    """The subsurface profiles, each material's profile id and the dipole's
    irradiance point cloud (one zero point until ``prepare`` fills it)."""

    mat_sss: torch.Tensor     # (M,) int32 per-material profile id (-1)
    sigma_s: torch.Tensor     # (S, 3)
    sigma_a: torch.Tensor     # (S, 3)
    g: torch.Tensor           # (S,)
    eta: torch.Tensor         # (S,)
    mode: torch.Tensor        # (S,) int32 MODE_*
    points_p: torch.Tensor    # (N, 3) irradiance sample positions
    points_n: torch.Tensor    # (N, 3) surface normals at the samples
    points_E: torch.Tensor    # (N, 3) irradiance estimates
    points_sss: torch.Tensor  # (N,) int32 owning profile id
    point_area: torch.Tensor  # (N,) area weight dA per sample

    @staticmethod
    def empty(n_mats: int = 1, device=None) -> "SSSTable":
        def f(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        def i(x):
            return torch.tensor(x, dtype=torch.int32, device=device)

        return SSSTable(
            mat_sss=i([-1] * max(n_mats, 1)), sigma_s=f([[1.0] * 3]),
            sigma_a=f([[0.1] * 3]), g=f([0.0]), eta=f([1.3]), mode=i([0]),
            points_p=f([[0.0] * 3]), points_n=f([[0.0, 0.0, 1.0]]),
            points_E=f([[0.0] * 3]), points_sss=i([-1]), point_area=f([0.0]))


def dipole_rd(r2, sigma_s, sigma_a, g, eta):
    """Classical dipole diffuse reflectance Rd(r) (Jensen et al. 2001;
    dipole.cpp's profile). r2: (..., 1) squared radius; sigma_*: (..., 3)."""
    sigma_sp = sigma_s * (1.0 - g)
    sigma_tp = sigma_sp + sigma_a
    alpha_p = m.safe_div(sigma_sp, sigma_tp)
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_tp)
    fdr = m.fresnel_diffuse_reflectance(eta)
    A = (1.0 + fdr) / torch.clamp(1.0 - fdr, min=1e-6)
    zr = m.safe_div(torch.ones_like(sigma_tp), sigma_tp)
    zv = zr * (1.0 + 4.0 / 3.0 * A)
    dr = torch.sqrt(r2 + zr * zr)
    dv = torch.sqrt(r2 + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * torch.exp(-sigma_tr * dr) / (dr ** 3)
    c2 = zv * (sigma_tr * dv + 1.0) * torch.exp(-sigma_tr * dv) / (dv ** 3)
    return alpha_p / (4.0 * math.pi) * (c1 + c2)


def prepare(scene, static, n_points: int = 512, nee_samples: int = 16,
            seed: int = 7):
    """The scene with its dipole point cloud filled in
    (IrradianceSamplingProcess, irrproc.cpp: area-weighted uniform points
    in place of the reference's blue noise). The points are placed on the
    host with ``np.random.default_rng(seed)``, as in the JAX package; their
    irradiance is the mean of ``nee_samples`` NEE samples with a shadow
    query each, on the scene's device (the independent sampler at
    dimension 0, keyed by the point's index as its pixel)."""
    from . import emitter as em_mod
    from . import scene as scene_mod
    from .integrators.common import ray_offset

    sss = scene.sss
    dev = scene.tri_p0.device
    mat_sss = sss.mat_sss.cpu().numpy()
    tri_mat = scene.tri_mat.cpu().numpy()
    has = mat_sss[np.maximum(tri_mat, 0)] >= 0
    if not has.any():
        return scene
    e1 = scene.tri_e1.cpu().numpy()
    e2 = scene.tri_e2.cpu().numpy()
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1) * has
    total = area.sum()
    pmf = area / total
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(pmf), size=n_points, p=pmf)
    b1 = rng.random(n_points)
    b2 = rng.random(n_points)
    flip = b1 + b2 > 1.0
    b1 = np.where(flip, 1.0 - b1, b1)
    b2 = np.where(flip, 1.0 - b2, b2)
    p0 = scene.tri_p0.cpu().numpy()
    pts = p0[tri] + b1[:, None] * e1[tri] + b2[:, None] * e2[tri]
    nrm = scene.tri_gn.cpu().numpy()[tri]
    sid = mat_sss[np.maximum(tri_mat[tri], 0)]

    # device pass: E(p) = mean over NEE samples of radiance * cos / pdf
    P = torch.as_tensor(pts.astype(np.float32), device=dev)
    Nn = torch.as_tensor(nrm.astype(np.float32), device=dev)
    E = torch.zeros((n_points, 3), device=dev)
    pix = torch.arange(n_points, dtype=torch.int32, device=dev)
    for k in range(nee_samples):
        u = rng_mod.uniform4(seed, pix, k, 0)
        ds = em_mod.sample_direct(scene, static, P, u[..., :3])
        cos_i = torch.clamp(m.dot(ds.d, Nn), min=0.0)
        ok = ds.valid & (ds.pdf_sa > 0) & (cos_i > 0)
        o_sh = ray_offset(P, Nn, ds.d)
        vis = ~scene_mod.occluded(scene, static, o_sh, ds.d, 0.0,
                                  ds.dist * (1.0 - 1e-3), active=ok)
        contrib = ds.radiance * m.safe_div(cos_i, ds.pdf_sa)[..., None]
        E = E + torch.where((ok & vis)[..., None], contrib, 0.0)
    E = E / nee_samples

    new = sss._replace(
        points_p=P, points_n=Nn, points_E=E,
        points_sss=torch.as_tensor(sid.astype(np.int32), device=dev),
        point_area=torch.as_tensor(
            np.full(n_points, total / n_points).astype(np.float32),
            device=dev))
    return scene._replace(sss=new)


def _rd_sum(sss, p, sid, sidc):
    """sum_j Rd(|p - x_j|) E_j dA_j over the points of each lane's own
    profile: (R, 3), computed over lane chunks of at most LO_CHUNK_ELEMS /
    (N * 3) lanes; each lane's arithmetic and its sum over the points are
    those of one dense (R, N, 3) reduction."""
    N = sss.points_p.shape[0]
    step = max(1, LO_CHUNK_ELEMS // (N * 3))
    out = []
    for a in range(0, p.shape[0], step):
        s, sc = sid[a:a + step], sidc[a:a + step]
        diff = p[a:a + step, None, :] - sss.points_p[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)[..., None]        # (C, N, 1)
        rd = dipole_rd(
            r2, sss.sigma_s[sc][:, None, :], sss.sigma_a[sc][:, None, :],
            sss.g[sc][:, None, None], sss.eta[sc][:, None, None])
        same = (sss.points_sss[None, :] == s[:, None])[..., None]
        out.append(torch.sum(torch.where(same, rd, 0.0) * sss.points_E[None]
                             * sss.point_area[None, :, None], dim=1))
    return torch.cat(out) if len(out) > 1 else out[0]


def eval_lo(scene, its, d_world):
    """Subsurface outgoing radiance at hits (dipole.cpp Lo):
    Lo = Ft(wo) / pi * sum_j Rd(|xo - x_j|) * E_j * dA_j.
    Returns (R, 3); zero on lanes whose material has no dipole profile."""
    sss = scene.sss
    mid = torch.clamp(its.mat_id, min=0).to(torch.int64)
    sid = sss.mat_sss[mid]
    sidc = torch.clamp(sid, min=0).to(torch.int64)
    lane = (sid >= 0) & (sss.mode[sidc] == MODE_DIPOLE)
    acc = _rd_sum(sss, its.p, sid, sidc)

    cos_o = torch.abs(m.dot(-d_world, its.sh_frame.n))
    ft = 1.0 - m.fresnel_dielectric(cos_o, sss.eta[sidc])[0]
    lo = ft[..., None] * acc / math.pi
    return torch.where(lane[..., None], lo, 0.0)


def _hg(cos_theta, g):
    """Henyey-Greenstein phase value p(cos) (normalized over the sphere)."""
    den = 1.0 + g * g - 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi
                            * torch.clamp(den, min=1e-8) ** 1.5)


def exact_single_scatter(scene, static, its, d, sampler, pixel, sample, dim,
                         active):
    """Refracted single scattering (singlescatter.cpp's fast mode, LoSingle):
    refract the camera ray into the body, sample one interior vertex V
    along the refracted chord (a truncated exponential; the chord's length
    from a closest-hit query), connect V straight to a light point sampled
    at the entry, find the boundary exit of that segment with a second
    closest-hit query and test the rest with a shadow query, and weight by
    Walter et al. 2009's refracted-connection factor
    D = (dV + eta dL)(|cosL / cosV| dV + |cosV / cosL| eta dL), the HG phase,
    Beer-Lambert over (s + dV) and both Fresnel transmittances (with the
    entering ray's eta^2). One sample per bounce; the reference's TIR
    recursion is not followed.

    Draws one uniform4 at ``dim`` (the distance and the light sample).
    Returns (R, 3), zero off single-scatter lanes."""
    from . import emitter as em_mod
    from . import scene as scene_mod
    from .integrators.common import ray_offset

    sss = scene.sss
    mid = torch.clamp(its.mat_id, min=0).to(torch.int64)
    sid = sss.mat_sss[mid]
    sidc = torch.clamp(sid, min=0).to(torch.int64)
    lane = active & (sid >= 0) & (sss.mode[sidc] == MODE_SINGLESCATTER)
    eta = sss.eta[sidc]
    sig_s = sss.sigma_s[sidc]
    sig_t = sig_s + sss.sigma_a[sidc]
    g = sss.g[sidc]
    sig_lum = torch.clamp(torch.mean(sig_t, dim=-1), min=1e-6)
    radius = 1.0 / sig_lum                     # m_radius: mean free path

    # entry refraction of the eye ray (d points toward the surface); only
    # hits arriving from outside start a chord (the reference evaluates Lo
    # at the entry interface)
    wi = -d
    n = its.sh_frame.n
    outside = m.dot(wi, its.gn) > 0.0
    lane = lane & outside
    n_or = torch.where(m.dot(wi, n)[..., None] > 0, n, -n)
    cos_i = m.dot(wi, n_or)
    F_in = m.fresnel_dielectric(cos_i, eta)[0]
    ok_r, d_int = m.refract(wi, n_or, eta)
    lane = lane & ok_r

    # the chord's length by a real query (the reference's its2)
    o_in = ray_offset(its.p, -n_or, d_int)
    its2 = scene_mod.ray_intersect(scene, static, o_in, d_int, 1e-4,
                                   torch.inf, active=lane)
    lane = lane & its2.valid
    thickness = torch.where(its2.valid, its2.t, 10.0 * radius)

    u = rng_mod.uniform4(sampler, pixel, sample, dim)

    # light sample at the entry point (dRec(its.p), singlescatter.cpp:1404)
    ds = em_mod.sample_direct(scene, static, its.p, u[..., 1:4])
    lane = lane & ds.valid & (ds.pdf_sa > 1e-12)
    value = (eta * eta)[..., None] * m.safe_div(
        ds.radiance, ds.pdf_sa[..., None])
    Lp = its.p + ds.d * ds.dist[..., None]

    # truncated-exponential distance along the refracted ray
    sMax = 1.0 - torch.exp(-thickness / radius)
    dist = -radius * torch.log(torch.clamp(1.0 - u[..., 0] * sMax,
                                           min=1e-20))
    dist = torch.minimum(dist, thickness)
    V = o_in + dist[..., None] * d_int
    w_dist = radius * sMax * torch.exp(dist / radius)   # 1 / pdf(dist)

    # straight connection V -> light; the boundary exit by a real query
    VL = Lp - V
    dVL = torch.clamp(m.length(VL), min=1e-9)
    dir_VL = VL / dVL[..., None]
    its3 = scene_mod.ray_intersect(scene, static, V, dir_VL, 1e-4, torch.inf,
                                   active=lane)
    dV = its3.t
    lane = lane & its3.valid & (dV < dVL)
    dL = torch.clamp(dVL - dV, min=1e-9)
    P = its3.p
    n3 = its3.sh_frame.n
    cosL = m.dot(dir_VL, n3)
    cosV = -cosL  # a straight connection: one line through the boundary
    lane = lane & (torch.abs(cosL) > 1e-6)

    # shadow segment P -> light
    o_sh = ray_offset(P, torch.where(cosL[..., None] > 0, n3, -n3), dir_VL)
    vis = ~scene_mod.occluded(scene, static, o_sh, dir_VL, 0.0,
                              dL * (1.0 - 1e-3), active=lane)
    lane = lane & vis

    F_out = m.fresnel_dielectric(torch.abs(cosL), eta)[0]
    D = (dV + eta * dL) * (
        torch.abs(m.safe_div(cosL, cosV)) * dV
        + torch.abs(m.safe_div(cosV, cosL)) * eta * dL)
    phase = _hg(m.dot(d_int, dir_VL), g)
    tr = torch.exp(-sig_t * (dist + dV)[..., None])

    lo = (sig_s * tr * value
          * ((1.0 - F_in) * (1.0 - F_out)
             * m.safe_div(torch.ones_like(D), D)
             * phase * (ds.dist ** 2) * w_dist)[..., None])
    return torch.where(lane[..., None], lo, 0.0)
