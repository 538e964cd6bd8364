"""Counter-based stateless RNG (port of ``mitsuba_tpu/core/rng.py``).

A pure function (sampler, pixel, sample, dim) -> U[0,1) through the PCG4D
hash (Jarzynski & Olano, JCGT 2020), with the JAX package's sampler modes:
INDEPENDENT draws PCG alone; LD, HALTON, HAMMERSLEY, FAURE and SOBOL replace
each 2D pair by a low-discrepancy point of a per-(pixel, dim) scrambled
stream (``qmc.py``). It must give the JAX package's bits exactly: every
image comparison between the two rests on that.

The JAX package keeps the mode in a module global that its render sets while
tracing. The port keeps no such state: a ``Sampler`` record (seed, mode,
sample count) is handed to every draw where the seed was; an int seed stands
for the independent sampler.

PyTorch has no uint32 arithmetic on the CPU, so the hash runs in int64 on
values kept in [0, 2^32). Products of two such values would overflow int64,
so ``_mul32`` splits the right factor into 16-bit halves; every product then
stays below 2^49 and the low 32 bits come out exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import qmc

_MASK = 0xFFFFFFFF
_PCG_MULT = 1664525
_PCG_INC = 1013904223


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _add32(a, b):
    return (a + b) & _MASK


def _pcg4d(x, y, z, w):
    x = (x * _PCG_MULT + _PCG_INC) & _MASK
    y = (y * _PCG_MULT + _PCG_INC) & _MASK
    z = (z * _PCG_MULT + _PCG_INC) & _MASK
    w = (w * _PCG_MULT + _PCG_INC) & _MASK
    x = _add32(x, _mul32(y, w))
    y = _add32(y, _mul32(z, x))
    z = _add32(z, _mul32(x, y))
    w = _add32(w, _mul32(y, z))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = _add32(x, _mul32(y, w))
    y = _add32(y, _mul32(z, x))
    z = _add32(z, _mul32(x, y))
    w = _add32(w, _mul32(y, z))
    return x, y, z, w


def pcg4d(v):
    """PCG4D mix of a (..., 4) integer tensor, read as uint32 -> (..., 4)
    int64 tensor holding the uint32 results."""
    v = v.to(torch.int64) & _MASK
    return torch.stack(_pcg4d(v[..., 0], v[..., 1], v[..., 2], v[..., 3]),
                       dim=-1)


def _to_unit_float(bits):
    """uint32 (in int64) -> float32 in [0, 1) from the top 24 bits; exact,
    since 5.9604645e-8 rounds to 2^-24 in float32."""
    return (bits >> 8).to(torch.float32) * 5.9604645e-8


def _counter(seed, pixel, sample, dim):
    """The four counter words as uint32 values: tensors become int64 tensors,
    Python ints stay Python ints (a host int sent to the device would cost a
    copy and a stream synchronisation per draw)."""
    return tuple(x.to(torch.int64) & _MASK if isinstance(x, torch.Tensor)
                 else int(x) & _MASK for x in (seed, pixel, sample, dim))


# sampler modes (the JAX package's rng.py:54-60; 1 is its STRATIFIED tag,
# which draws as LD there and which its API never sets: the API's
# stratified sampler jitters pixel positions and draws INDEPENDENT)
INDEPENDENT = 0
LD = 2           # ldsampler.cpp: scrambled (0,2)-sequence pairs
HALTON = 3       # halton.cpp: rotated prime-base radical inverses
HAMMERSLEY = 4   # hammersley.cpp: (i + rot) / N first component
FAURE = 5        # faure.cpp: Faure-permuted radical inverses
SOBOL = 6        # sobol.cpp: multi-dimensional Sobol' directions
_QMC_TYPES = (LD, HALTON, HAMMERSLEY, FAURE, SOBOL)


@dataclass(frozen=True)
class Sampler:
    """What a draw is keyed by besides (pixel, sample, dim): the render's
    seed, the sampler mode and the total sample count (the hammersley
    ramp's N)."""

    seed: int = 0
    kind: int = INDEPENDENT
    n: int = 16


def _sampler(s) -> Sampler:
    return s if isinstance(s, Sampler) else Sampler(seed=s)


# Compact dimensions below this use prime-base radical inverses (halton,
# hammersley, faure); beyond it XOR-scrambled (0,2) pairs, whose base-2
# stratification holds at every dimension (the JAX rng.py:111-121)
_PRIME_DIMS = 5
_SCRAMBLE_KEY = 0x9E3779B9


def _qmc2(smp: Sampler, pixel, sample, dim):
    """One scrambled low-discrepancy 2D point per (pixel, dim) stream
    (the JAX rng.py:124-189). ``sample`` and ``dim`` are host ints: the mode's
    branch, the prime and the index's digits are chosen and computed on the
    host, and only the stream's scramble words are lanes."""
    if isinstance(sample, torch.Tensor) or isinstance(dim, torch.Tensor):
        raise TypeError("the low-discrepancy samplers draw at a host int "
                        "sample index and dimension")
    scr = _pcg4d(*_counter(smp.seed, pixel, dim, _SCRAMBLE_KEY))
    # compact dimension: the integrators leave slots 2-3 unused between the
    # sensor/aperture dimensions and DIM_BASE = 4
    qd = dim - 2 if dim >= 4 else dim
    if smp.kind == SOBOL:
        return torch.stack([qmc.sobol_nd(2 * qd, sample, scr[0]),
                            qmc.sobol_nd(2 * qd + 1, sample, scr[1])], dim=-1)
    if smp.kind == LD or qd >= _PRIME_DIMS:
        return qmc.sobol02(sample, scr[0], scr[1])
    pi0, pi1 = min(2 * qd, 30), min(2 * qd + 1, 31)
    rot_x, rot_y = qmc.unit32(scr[0]), qmc.unit32(scr[1])
    if smp.kind == FAURE:
        # Faure-permuted digits and a per-stream Cranley-Patterson rotation
        u0 = rot_x + float(qmc.scrambled_radical_inverse(pi0, sample))
        u1 = rot_y + float(qmc.scrambled_radical_inverse(pi1, sample))
        return torch.stack([u0 - torch.floor(u0), u1 - torch.floor(u1)],
                           dim=-1)
    u1 = qmc.radical_inverse(pi1, sample, rot_y)
    if smp.kind == HAMMERSLEY and dim == 0:
        # i/N on the image plane alone; a per-pixel XOR permutation of the
        # index (exact for a power-of-two N) keeps the 1/N strata while
        # decorrelating their order from the later dimensions
        n = smp.n
        if n & (n - 1) == 0 and n > 1:
            s_lo = (scr[2] ^ (sample & _MASK)) & (n - 1)
            strat = s_lo.to(torch.float32) + rot_x
        else:
            strat = rot_x + float((sample & _MASK) % n)
        strat = strat / float(n)
        return torch.stack([strat - torch.floor(strat), u1], dim=-1)
    return torch.stack([qmc.radical_inverse(pi0, sample, rot_x), u1], dim=-1)


def uniform4(sampler, pixel, sample, dim):
    """Four U[0,1) floats keyed by (sampler, pixel, sample, dim), at least
    one of them a tensor: ``broadcast_shape + (4,)`` float32. ``sampler`` is
    a ``Sampler`` or an int seed (the independent sampler). Under a
    low-discrepancy mode components 1-2 are its 2D point and 0 and 3 stay
    PCG (the callers' convention: selector, 2D pair, spare)."""
    smp = _sampler(sampler)
    words = torch.broadcast_tensors(
        *_pcg4d(*_counter(smp.seed, pixel, sample, dim)))
    if smp.kind in _QMC_TYPES:
        q = _qmc2(smp, pixel, sample, dim)
        return torch.stack([_to_unit_float(words[0]), q[..., 0], q[..., 1],
                            _to_unit_float(words[3])], dim=-1)
    return torch.stack([_to_unit_float(c) for c in words], dim=-1)


def uniform1(sampler, pixel, sample, dim):
    smp = _sampler(sampler)
    if smp.kind in _QMC_TYPES:
        return _qmc2(smp, pixel, sample, dim)[..., 0]
    return uniform4(smp, pixel, sample, dim)[..., 0]


def uniform2(sampler, pixel, sample, dim):
    smp = _sampler(sampler)
    if smp.kind in _QMC_TYPES:
        return _qmc2(smp, pixel, sample, dim)
    return uniform4(smp, pixel, sample, dim)[..., :2]
