"""Specular-manifold walks (port of ``mitsuba_tpu/render/manifold.py``;
reference: src/libbidir/manifold.cpp, mut_manifold.cpp:770).

A specular chain is one closed-form map: emission coordinates u in (0, 1)^2
-> a cosine-hemisphere direction about the light's normal -> up to N_EVENTS
refractions (total internal reflection reflects) at the analytic spheres
and at the specular-mesh rows ``Scene.man_tri`` -> the chain's exit
direction omega(u). The manifold walk is a batched 2x2 Newton solve on that
map's Jacobian; ``det_omega`` is the map's solid-angle area element.

The JAX package writes the map for one lane and takes its Jacobian with
``vmap(jacfwd(...))``. Here the map is written over lanes, and
``_chain_map(..., jac=True)`` carries the Jacobian's two columns beside
the values, each step's derivative written out: PyTorch's forward-mode AD
(``torch.func.jvp``) gives the same columns, but dispatches many times
the plain map's host work, and the Newton walk evaluates the Jacobian 20
times per mutation. The Newton step and ``det_omega`` read the same
columns. The mesh branch tests every lane against every row, (lanes, rows)
tensors, so the lanes go through in chunks of at most ``CHUNK_ELEMS /
rows``; the chosen row's hit is differentiated per lane.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.frame import Frame

N_EVENTS = 4       # specular interactions along the chain at most
N_NEWTON = 10      # Newton steps of the walk
# elements of one (lanes, rows) temporary of the mesh branch
CHUNK_ELEMS = 1 << 23


def _refract_or_reflect(d, n, eta_ratio):
    """Snell refraction of unit d at an interface whose normal n faces d
    (cos_i = -d.n >= 0); total internal reflection reflects. eta_ratio is
    n_incident / n_transmitted."""
    cos_i = -m.dot(d, n)
    sin2_t = eta_ratio * eta_ratio * torch.clamp(1.0 - cos_i * cos_i,
                                                 min=0.0)
    tir = sin2_t > 1.0
    cos_t = m.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    d_t = eta_ratio[..., None] * d \
        + (eta_ratio * cos_i - cos_t)[..., None] * n
    d_r = d + (2.0 * cos_i)[..., None] * n
    out = torch.where(tir[..., None], d_r, d_t)
    return out / torch.clamp(m.length(out), min=1e-12)[..., None]


def _use_mesh(mesh) -> bool:
    # the JAX test is mesh.shape[0] > 1: a lone specular triangle is left
    # out of the chain though n_manifold_tris = 1 turns the strategy on
    # (ROADMAP.md, Queue 3); the port keeps it
    return mesh is not None and mesh.shape[0] > 1


# Tangents: d/du of a lane's value along u0 and u1, in a trailing axis of 2
# (a scalar's (R, 2), a vector's (R, 3, 2)). Each is the derivative of the
# expression beside it; a clamp passes it where the clamp is not active, a
# where picks it with its value.

def _tdot(a, da, b, db=None):
    """Tangent of dot(a, b), a and b (R, 3) with tangents da and db (db
    None: b constant, and a is not read)."""
    t = torch.sum(da * b[..., None], dim=-2)
    return t if db is None else t + torch.sum(a[..., None] * db, dim=-2)


def _tcross(da, b):
    """Tangent of cross(a, b) with b constant, da (R, 3, 2)."""
    return torch.stack([
        da[:, 1] * b[..., 2, None] - da[:, 2] * b[..., 1, None],
        da[:, 2] * b[..., 0, None] - da[:, 0] * b[..., 2, None],
        da[:, 0] * b[..., 1, None] - da[:, 1] * b[..., 0, None],
    ], dim=1)


def _tunit(v, dv, length):
    """Tangent of v / length with length = |v|: (dv - v^ (v^.dv)) /
    length."""
    vh = v / length[..., None]
    return (dv - vh[..., None] * _tdot(vh, dv, vh)[:, None]) \
        / length[..., None, None]


def _cos_hemisphere(u2, jac: bool):
    """warp.square_to_cosine_hemisphere of u2 (R, 2), and with ``jac`` its
    (R, 3, 2) Jacobian (the concentric disk, then z = sqrt(1 - x^2 -
    y^2))."""
    w = warp.square_to_cosine_hemisphere(u2)
    if not jac:
        return w, None
    x = 2.0 * u2[..., 0] - 1.0
    y = 2.0 * u2[..., 1] - 1.0
    cond = torch.abs(x) > torch.abs(y)
    r = torch.where(cond, x, y)
    ratio = torch.where(cond, m.safe_div(y, x), m.safe_div(x, y))
    phi = torch.where(cond, (math.pi / 4.0) * ratio,
                      (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    zero = torch.zeros_like(x)
    two = torch.full_like(x, 2.0)
    # d(x, y) / du = diag(2, 2); ratio's quotient rule, 0 where safe_div
    # returns 0
    dr = torch.stack([torch.where(cond, two, zero),
                      torch.where(cond, zero, two)], dim=-1)
    dx = torch.stack([two, zero], dim=-1)
    dy = torch.stack([zero, two], dim=-1)
    den = torch.where(cond, x, y)
    num = torch.where(cond, y, x)
    dnum = torch.where(cond[..., None], dy, dx)
    dden = torch.where(cond[..., None], dx, dy)
    ok = torch.abs(den) > 1e-20
    safe = torch.where(ok, den, 1.0)
    dratio = torch.where(ok[..., None], (dnum * safe[..., None]
                                         - num[..., None] * dden)
                         / (safe * safe)[..., None], 0.0)
    dphi = torch.where(cond, math.pi / 4.0, -math.pi / 4.0)[..., None] \
        * dratio
    c, s = torch.cos(phi), torch.sin(phi)
    still = ((x == 0.0) & (y == 0.0))[..., None]
    dpx = torch.where(still, 0.0, dr * c[..., None]
                      - (r * s)[..., None] * dphi)
    dpy = torch.where(still, 0.0, dr * s[..., None]
                      + (r * c)[..., None] * dphi)
    zw = w[..., 2]
    dz = torch.where((zw > 0.0)[..., None],
                     -(w[..., 0, None] * dpx + w[..., 1, None] * dpy)
                     / torch.where(zw > 0.0, zw, 1.0)[..., None], 0.0)
    return w, torch.stack([dpx, dpy, dz], dim=1)


def _refract_or_reflect_jac(d, dd, n, dn, eta_ratio):
    """_refract_or_reflect and its tangent (dd, dn: the tangents of d and
    n; eta_ratio has none)."""
    cos_i = -m.dot(d, n)
    dcos_i = -_tdot(d, dd, n, dn)
    one_m = 1.0 - cos_i * cos_i
    sin2_t = eta_ratio * eta_ratio * torch.clamp(one_m, min=0.0)
    dsin2 = torch.where((one_m > 0.0)[..., None],
                        (eta_ratio * eta_ratio * -2.0 * cos_i)[..., None]
                        * dcos_i, 0.0)
    tir = sin2_t > 1.0
    arg = 1.0 - sin2_t
    cos_t = m.sqrt(torch.clamp(arg, min=1e-12))
    dcos_t = torch.where((arg > 1e-12)[..., None],
                         -dsin2 / (2.0 * cos_t)[..., None], 0.0)
    e = eta_ratio[..., None]
    k = eta_ratio * cos_i - cos_t
    d_t = e * d + k[..., None] * n
    dd_t = e[..., None] * dd \
        + (eta_ratio[..., None] * dcos_i - dcos_t)[:, None] * n[..., None] \
        + k[..., None, None] * dn
    d_r = d + (2.0 * cos_i)[..., None] * n
    dd_r = dd + 2.0 * dcos_i[:, None] * n[..., None] \
        + (2.0 * cos_i)[..., None, None] * dn
    out = torch.where(tir[..., None], d_r, d_t)
    dout = torch.where(tir[..., None, None], dd_r, dd_t)
    length = torch.clamp(m.length(out), min=1e-12)
    res = out / length[..., None]
    dres = _tunit(out, dout, length)
    return res, torch.where((m.length(out) > 1e-12)[..., None, None], dres,
                            dout / length[..., None, None])


def _chain_map(u2, o, n_l, centers, radii, etas, mesh, jac: bool = False):
    """The chain's exit directions (R, 3) of lanes u2 (R, 2), o, n_l (R, 3)
    (the JAX ``chain_exit_dir`` of each lane), and with ``jac`` their
    Jacobian (R, 3, 2) d omega / d u, carried through every event by hand
    (the JAX package takes it with forward-mode AD)."""
    w, dw = _cos_hemisphere(u2, jac)
    fr = Frame.from_normal(n_l)
    d = fr.to_world(w)
    p = o
    R = u2.shape[0]
    S = centers.shape[0]
    dev = u2.device
    lanes = torch.arange(R, device=dev)
    if jac:
        dd = (fr.s[..., None] * dw[:, 0:1] + fr.t[..., None] * dw[:, 1:2]
              + fr.n[..., None] * dw[:, 2:3])
        dp = torch.zeros((R, 3, 2), device=dev)
    for _ in range(N_EVENTS):
        best_t = torch.full((R,), torch.inf, device=dev)
        best_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
        if jac:
            dbest_t = torch.zeros((R, 2), device=dev)
        for i in range(S):
            oc = p - centers[i]
            b = m.dot(d, oc)
            c = m.dot(oc, oc) - radii[i] * radii[i]
            disc = b * b - c
            sq = m.sqrt(torch.clamp(disc, min=0.0))
            t0 = -b - sq
            t1 = -b + sq
            t = torch.where(t0 > 1e-4, t0, t1)
            ok = (disc > 0.0) & (t > 1e-4)
            closer = ok & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            best_i = torch.where(closer, i, best_i)
            if jac:
                db = _tdot(d, dd, oc, dp)
                ddisc = 2.0 * b[..., None] * db - 2.0 * _tdot(oc, dp, oc)
                dsq = torch.where((disc > 0.0)[..., None], ddisc / (
                    2.0 * torch.where(sq > 0.0, sq, 1.0))[..., None], 0.0)
                dt = torch.where((t0 > 1e-4)[..., None], -db - dsq,
                                 -db + dsq)
                dbest_t = torch.where(closer[..., None], dt, dbest_t)

        if _use_mesh(mesh):
            # Moller-Trumbore of every lane against every specular-mesh row
            p0m, e1m, e2m = mesh[:, 0:3], mesh[:, 3:6], mesh[:, 6:9]
            dd3 = d[:, None, :]
            pv = m.cross(dd3.expand(-1, mesh.shape[0], -1), e2m)
            det = torch.sum(e1m * pv, dim=-1)
            okd = torch.abs(det) > 1e-12
            inv = 1.0 / torch.where(okd, det, 1.0)
            tv = p[:, None, :] - p0m
            uu = torch.sum(tv * pv, dim=-1) * inv
            qv = m.cross(tv, e1m.expand_as(tv))
            vv = torch.sum(qv * dd3, dim=-1) * inv
            tt = torch.sum(e2m * qv, dim=-1) * inv
            okm = (okd & (uu >= -1e-6) & (vv >= -1e-6)
                   & (uu + vv <= 1.0 + 1e-6) & (tt > 1e-4))
            tt = torch.where(okm, tt, torch.inf)
            j = torch.argmin(tt, dim=-1)
            t_m = tt[lanes, j]
            mesh_closer = t_m < best_t
            row = mesh[j]
            u_b = uu[lanes, j][..., None]
            v_b = vv[lanes, j][..., None]
            n_raw = (row[:, 9:12] * (1.0 - u_b - v_b) + row[:, 12:15] * u_b
                     + row[:, 15:18] * v_b)
            n_len = torch.clamp(m.length(n_raw), min=1e-12)
            n_sh = n_raw / n_len[..., None]
            eta_m = row[:, 18]
            if jac:
                # the chosen row's hit, differentiated: pv = d x e2, det =
                # e1.pv, tv = p - p0, qv = tv x e1 and the quotients by det
                p0j, e1j, e2j = row[:, 0:3], row[:, 3:6], row[:, 6:9]
                pvj = pv[lanes, j]
                qvj = qv[lanes, j]
                tvj = tv[lanes, j]
                invj = inv[lanes, j][..., None]
                dpv = _tcross(dd, e2j)
                dinv = -invj * invj * _tdot(pvj, dpv, e1j)
                duu = _tdot(tvj, dp, pvj, dpv) * invj \
                    + (torch.sum(tvj * pvj, dim=-1)[..., None] * dinv)
                dqv = _tcross(dp, e1j)
                dvv = _tdot(qvj, dqv, d, dd) * invj \
                    + torch.sum(qvj * d, dim=-1)[..., None] * dinv
                dtm = _tdot(qvj, dqv, e2j) * invj \
                    + torch.sum(e2j * qvj, dim=-1)[..., None] * dinv
                dn_raw = ((row[:, 12:15] - row[:, 9:12])[..., None]
                          * duu[:, None]
                          + (row[:, 15:18] - row[:, 9:12])[..., None]
                          * dvv[:, None])
                dn_sh = torch.where((m.length(n_raw) > 1e-12)[..., None, None],
                                    _tunit(n_raw, dn_raw, n_len),
                                    dn_raw / n_len[..., None, None])
        else:
            mesh_closer = torch.zeros(R, dtype=torch.bool, device=dev)
            t_m = torch.full((R,), torch.inf, device=dev)
            n_sh = torch.zeros((R, 3), device=dev)
            eta_m = torch.ones(R, device=dev)
            if jac:
                dtm = torch.zeros((R, 2), device=dev)
                dn_sh = torch.zeros((R, 3, 2), device=dev)

        hit = (best_i >= 0) | mesh_closer
        i_c = torch.clamp(best_i, min=0)
        t_c = torch.where(hit, torch.where(mesh_closer, t_m, best_t), 0.0)
        p_hit = p + t_c[..., None] * d
        if S > 0:
            r_c = torch.clamp(radii[i_c], min=1e-9)
            n_sph = (p_hit - centers[i_c]) / r_c[..., None]
            eta_sph = etas[i_c]
        else:  # mesh-only chains: no sphere set at all
            n_sph = torch.zeros((R, 3), device=dev)
            eta_sph = torch.ones(R, device=dev)
        n_s = torch.where(mesh_closer[..., None], n_sh, n_sph)
        entering = m.dot(d, n_s) < 0.0
        n_or = torch.where(entering[..., None], n_s, -n_s)
        eta_i = torch.where(mesh_closer, eta_m, eta_sph)
        eta_ratio = torch.where(entering, 1.0 / eta_i, eta_i)
        if jac:
            dt_c = torch.where(hit[..., None], torch.where(
                mesh_closer[..., None], dtm, dbest_t), 0.0)
            dp_hit = dp + dt_c[:, None] * d[..., None] \
                + t_c[..., None, None] * dd
            dn_sph = (dp_hit / r_c[..., None, None] if S > 0
                      else torch.zeros_like(dp_hit))
            dn_s = torch.where(mesh_closer[..., None, None], dn_sh, dn_sph)
            dn_or = torch.where(entering[..., None, None], dn_s, -dn_s)
            d_new, dd_new = _refract_or_reflect_jac(d, dd, n_or, dn_or,
                                                    eta_ratio)
            dd = torch.where(hit[..., None, None], dd_new, dd)
            dp = torch.where(hit[..., None, None], dp_hit, dp)
        else:
            d_new = _refract_or_reflect(d, n_or, eta_ratio)
        d = torch.where(hit[..., None], d_new, d)
        p = torch.where(hit[..., None], p_hit, p)
    return (d, dd) if jac else d


def _chunks(R: int, mesh):
    """Lane ranges of at most CHUNK_ELEMS / rows lanes (one range without
    the mesh branch)."""
    step = R if not _use_mesh(mesh) else max(1, CHUNK_ELEMS // mesh.shape[0])
    return [(a, min(a + step, R)) for a in range(0, R, step)] or [(0, 0)]


def chain_exit_dir(u2, o, n_l, centers, radii, etas, mesh=None):
    """The chain's exit directions (R, 3): emission coordinates u2 (R, 2)
    from light points o (R, 3) with normals n_l (R, 3), through the
    analytic spheres ``centers`` (S, 3), ``radii`` (S,), ``etas`` (S,) (eta
    1: inert) and the specular-mesh rows ``mesh`` (Tm, 19) or None
    (``Scene.man_tri``). A ray that misses every event keeps its
    direction."""
    return torch.cat([
        _chain_map(u2[a:b], o[a:b], n_l[a:b], centers, radii, etas, mesh)
        for a, b in _chunks(u2.shape[0], mesh)])


def chain_jacobian(u2, o, n_l, centers, radii, etas, mesh=None):
    """(chain_exit_dir, its Jacobian d omega / d u (R, 3, 2))."""
    out = [_chain_map(u2[a:b], o[a:b], n_l[a:b], centers, radii, etas, mesh,
                      jac=True) for a, b in _chunks(u2.shape[0], mesh)]
    return torch.cat([d for d, _ in out]), torch.cat([j for _, j in out])


def _solve(u0, o, n_l, d_target, centers, radii, etas, mesh):
    fr = Frame.from_normal(d_target)
    fx, fy = fr.s, fr.t
    u = u0
    for _ in range(N_NEWTON):
        d, J = _chain_map(u, o, n_l, centers, radii, etas, mesh, jac=True)
        c0, c1 = J[..., 0], J[..., 1]
        f0, f1 = m.dot(d, fx), m.dot(d, fy)
        # J[i, k] = d f_i / d u_k of the chart residual (d.fx, d.fy)
        j00, j01 = m.dot(c0, fx), m.dot(c1, fx)
        j10, j11 = m.dot(c0, fy), m.dot(c1, fy)
        det = j00 * j11 - j01 * j10
        inv_det = torch.where(torch.abs(det) > 1e-14,
                              1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
        du = torch.stack([(j11 * f0 - j01 * f1) * inv_det,
                          (j00 * f1 - j10 * f0) * inv_det], dim=-1)
        # trust region: a Newton step further than 0.25 in the square
        # leaves the local chart's validity
        nrm = m.length(du)
        du = du * torch.clamp(0.25 / torch.clamp(nrm, min=1e-12),
                              max=1.0)[..., None]
        u = torch.clamp(u - du, 1e-5, 1.0 - 1e-5)
    d_fin = _chain_map(u, o, n_l, centers, radii, etas, mesh)
    f = torch.stack([m.dot(d_fin, fx), m.dot(d_fin, fy)], dim=-1)
    ok = (m.length(f) < 1e-4) & (m.dot(d_fin, d_target) > 0.0)
    return u, ok


def solve_exit_dir(u0, o, n_l, d_target, centers, radii, etas, mesh=None):
    """The batched Newton walk: u with chain_exit_dir(u) == d_target,
    started from u0 (R, 2), the current state's coordinates (the reference
    also walks from the unperturbed path, manifold.cpp ``move``). Returns
    (u (R, 2), converged (R,) bool): converged where the chart residual
    is below 1e-4 and the exit direction faces d_target."""
    out = [_solve(u0[a:b], o[a:b], n_l[a:b], d_target[a:b], centers, radii,
                  etas, mesh) for a, b in _chunks(u0.shape[0], mesh)]
    return (torch.cat([u for u, _ in out]),
            torch.cat([ok for _, ok in out]))


def det_omega(u2, o, n_l, centers, radii, etas, mesh=None):
    """|det d omega / d u| (R,): the chain map's solid-angle area element,
    the density Jacobian of pushing a density on the square through the
    chain onto the sphere of directions (mut_manifold.cpp's dv term)."""
    out = []
    for a, b in _chunks(u2.shape[0], mesh):
        _, J = _chain_map(u2[a:b], o[a:b], n_l[a:b], centers, radii, etas,
                          mesh, jac=True)
        out.append(m.length(m.cross(J[..., 0], J[..., 1])))
    return torch.cat(out)


def perturb_cone(d, u2, theta_max: float):
    """Direction in the cone of half-angle ``theta_max`` about the unit d
    (R, 3): a symmetric proposal, whose density depends on d . d' alone
    (mut_caustic.cpp's angular proposal)."""
    cos_max = float(np.float32(np.cos(np.float32(theta_max))))
    local = warp.square_to_uniform_cone(u2, cos_max)
    return Frame.from_normal(d).to_world(local)
