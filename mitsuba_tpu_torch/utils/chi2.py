"""Chi-square goodness-of-fit harness for directional samplers (port of
``mitsuba_tpu/utils/chi2.py``, in numpy and torch).

The reference's test idea (include/mitsuba/core/chisquare.h:143-162, src/
tests/test_chisquare.cpp): check that a ``sample()`` draws from the density
that ``pdf()`` claims. The sphere is cut into equal-area (cos θ, φ) cells;
a large batch of samples is histogrammed, the pdf integrated per cell on a
midpoint subgrid (cells where a finer grid still moves the integral are
left out), low-count cells pooled, and Pearson's statistic tested.
"""
from __future__ import annotations

import numpy as np
import torch


def _chi2_sf(x: float, k: int) -> float:
    """Survival function of the chi-square distribution with k degrees of
    freedom: the regularized upper incomplete gamma Q(k/2, x/2)."""
    a = torch.tensor(k / 2.0, dtype=torch.float64)
    return float(torch.special.gammaincc(a, torch.tensor(x / 2.0,
                                                         dtype=torch.float64)))


def spherical_cell_of(d, res_theta: int, res_phi: int):
    """The cell index of each unit direction over (cos θ, φ), equal-area
    rows."""
    d = np.asarray(d)
    ct = np.clip(d[..., 2], -1.0, 1.0)
    phi = np.arctan2(d[..., 1], d[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    it = np.minimum(((ct + 1.0) * 0.5 * res_theta).astype(np.int64),
                    res_theta - 1)
    ip = np.minimum((phi / (2 * np.pi) * res_phi).astype(np.int64), res_phi - 1)
    return it * res_phi + ip


def _pool(expected, counts, min_exp_cell):
    """Merge cells in order of rising expectation until each group expects
    at least ``min_exp_cell`` samples (chisquare.h's pooling); a remainder
    joins the last group."""
    order = np.argsort(expected)
    pooled_exp, pooled_cnt = [], []
    acc_e = acc_c = 0.0
    for e, c in zip(expected[order], counts[order]):
        acc_e += e
        acc_c += c
        if acc_e >= min_exp_cell:
            pooled_exp.append(acc_e)
            pooled_cnt.append(acc_c)
            acc_e = acc_c = 0.0
    if acc_e > 0 and pooled_exp:
        pooled_exp[-1] += acc_e
        pooled_cnt[-1] += acc_c
    return np.asarray(pooled_exp), np.asarray(pooled_cnt)


def chi2_test(sample_fn, pdf_fn, n_samples: int = 1_000_000,
              res_theta: int = 16, res_phi: int = 32, sub: int = 8,
              significance: float = 0.001, min_exp_cell: float = 5.0):
    """Run the test.

    ``sample_fn(n)`` gives (n, 3) unit directions (array or tensor), a zero
    row for a sample that produced none; ``pdf_fn(d)`` gives the (m,)
    solid-angle density at the (m, 3) float32 CPU tensor ``d``.

    Returns (passed, p_value, stat, dof, info).
    """
    d = sample_fn(n_samples)
    d = d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
    valid = np.linalg.norm(d, axis=-1) > 0.5
    n_valid = int(valid.sum())
    cells = spherical_cell_of(d[valid], res_theta, res_phi)
    counts = np.bincount(cells, minlength=res_theta * res_phi).astype(
        np.float64)

    def integrate(s):
        """Midpoint integration of the pdf per cell, subgrid factor s."""
        ct_edges = np.linspace(-1.0, 1.0, res_theta * s + 1)
        phi_edges = np.linspace(0.0, 2 * np.pi, res_phi * s + 1)
        ct_mid = 0.5 * (ct_edges[:-1] + ct_edges[1:])
        phi_mid = 0.5 * (phi_edges[:-1] + phi_edges[1:])
        CT, PH = np.meshgrid(ct_mid, phi_mid, indexing="ij")
        ST = np.sqrt(np.maximum(1.0 - CT * CT, 0.0))
        dirs = np.stack([ST * np.cos(PH), ST * np.sin(PH), CT], axis=-1)
        p = pdf_fn(torch.from_numpy(dirs.reshape(-1, 3).astype(np.float32)))
        p = p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else p
        p = np.asarray(p).reshape(res_theta * s, res_phi * s).astype(
            np.float64)
        cell_area = (2.0 / (res_theta * s)) * (2 * np.pi / (res_phi * s))
        return p.reshape(res_theta, s, res_phi, s).sum(axis=(1, 3)) * cell_area

    # cells where refinement still moves the integral hold near-singular
    # pdfs (the rough dielectric's TIR ring) that midpoint quadrature cannot
    # pin down: they are left out of the statistic (the reference integrates
    # adaptively instead)
    p_coarse = integrate(sub)
    p_int = integrate(sub * 2)
    unreliable = np.abs(p_int - p_coarse) > np.maximum(0.03 * p_int, 2e-4)
    reliable = (~unreliable).reshape(-1)
    expected = (p_int * n_samples).reshape(-1)

    # the pdf integrates to the valid fraction, with slack for the mass of
    # the cells left out
    total_p = p_int.sum()
    frac = n_valid / n_samples
    slack = (0.02 * max(frac, 1e-3) + 5e-3
             + 1.5 * p_int.reshape(-1)[~reliable].sum())
    if abs(total_p - frac) > slack:
        return (False, 0.0, np.inf, 0,
                f"pdf integrates to {total_p:.5f} but sample() produced "
                f"{frac:.5f} valid fraction")
    pooled_exp, pooled_cnt = _pool(expected[reliable], counts[reliable],
                                   min_exp_cell)
    dof = len(pooled_exp) - 1
    if dof < 1:
        return False, 0.0, np.inf, 0, "too few cells with expected mass"
    stat = float(np.sum((pooled_cnt - pooled_exp) ** 2
                        / np.maximum(pooled_exp, 1e-9)))
    pval = _chi2_sf(stat, dof)
    return (pval >= significance, pval, stat, dof,
            f"chi2={stat:.1f} dof={dof} p={pval:.5f} (n={n_samples}, "
            f"pdf_mass={total_p:.4f}, valid={frac:.4f})")
