"""Counter-based stateless RNG (port of ``mitsuba_tpu/core/rng.py``,
INDEPENDENT sampler only).

A pure function (seed, pixel, sample, dim) -> U[0,1) through the PCG4D hash
(Jarzynski & Olano, JCGT 2020). It must give the JAX package's bits exactly:
every image comparison between the two rests on that.

PyTorch has no uint32 arithmetic on the CPU, so the hash runs in int64 on
values kept in [0, 2^32). Products of two such values would overflow int64,
so ``_mul32`` splits the right factor into 16-bit halves; every product then
stays below 2^49 and the low 32 bits come out exact.
"""
from __future__ import annotations

import torch

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


def uniform4(seed, pixel, sample, dim):
    """Four independent U[0,1) floats keyed by (seed, pixel, sample, dim), at
    least one of them a tensor: ``broadcast_shape + (4,)`` float32."""
    words = torch.broadcast_tensors(*_pcg4d(*_counter(seed, pixel, sample, dim)))
    return torch.stack([_to_unit_float(c) for c in words], dim=-1)


def uniform1(seed, pixel, sample, dim):
    return uniform4(seed, pixel, sample, dim)[..., 0]


def uniform2(seed, pixel, sample, dim):
    return uniform4(seed, pixel, sample, dim)[..., :2]
