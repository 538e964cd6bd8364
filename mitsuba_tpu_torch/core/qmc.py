"""Quasi-Monte Carlo primitives (port of ``mitsuba_tpu/core/qmc.py``).

* ``sobol02``: the (0,2)-sequence (Sobol dimensions 0 and 1: bit reversal,
  and the dimension whose direction numbers follow v_{k+1} = v_k ^ (v_k >> 1)),
  XOR-scrambled per stream;
* ``radical_inverse``: the prime-base radical inverse with a Cranley-Patterson
  rotation; ``scrambled_radical_inverse``: with Faure's digit permutations;
* ``sobol_nd``: Sobol' dimension ``dim`` from the Joe-Kuo direction numbers
  (``sobol_table.py``), XOR-scrambled.

The sample index and the dimension are host ints at every draw site of the
port (the render loop's sample counter and the integrators' fixed dimension
slots), so what depends on them alone (the bit reversal, the XOR of direction
numbers over the index's bits, the radical inverse's 16 digits) is computed
once per draw on the host. The digit sums run in float32 in the JAX order of
operations, one rounding per operation (numpy float32 scalars). Only the
per-stream scramble or rotation, a tensor, touches the lanes: an XOR or an
add, one int-to-float conversion, a multiply. Unsigned 32-bit words live in
int64 tensors, as in ``rng.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .sobol_table import SOBOL_DIRECTIONS, SOBOL_MAX_DIMS

_MASK = 0xFFFFFFFF
TO_UNIT = 2.3283064365386963e-10  # 2^-32, exact in float32

# direction numbers of Sobol dimension 1 (dimension 0 is the bit reversal)
_V1 = []
_v = 1 << 31
for _k in range(32):
    _V1.append(_v)
    _v ^= _v >> 1

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131)


def _reverse_bits(x: int) -> int:
    x = ((x >> 16) | (x << 16)) & _MASK
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    return ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)


def _xor_directions(index: int, directions) -> int:
    """XOR of ``directions[k]`` over the set bits k of a uint32 index."""
    x = 0
    for k in range(32):
        if (index >> k) & 1:
            x ^= int(directions[k])
    return x


def unit32(bits):
    """uint32 words (int64 tensor) -> float32 ``float(bits) * 2^-32``,
    rounded to nearest: words of 2^32 - 128 and above give 1.0, as in the
    JAX package."""
    return bits.to(torch.float32) * TO_UNIT


def sobol02(index: int, scramble_x, scramble_y):
    """(0,2)-sequence point of sample ``index``, XOR-scrambled by the uint32
    words ``scramble_x``, ``scramble_y`` (int64 tensors of one shape holding
    values in [0, 2^32)). Returns (..., 2) float32 in [0, 1]."""
    index = int(index) & _MASK
    x = scramble_x ^ _reverse_bits(index)
    y = scramble_y ^ _xor_directions(index, _V1)
    return torch.stack([unit32(x), unit32(y)], dim=-1)


def _digits(prime_index: int, index: int, perm=None) -> np.float32:
    """sum_k digit_k * base^-(k+1) over 16 base-b digits of ``index``, in
    float32 as the JAX package sums them; ``perm`` maps each digit."""
    pi = min(max(int(prime_index), 0), len(_PRIMES) - 1)
    base = _PRIMES[pi]
    inv_base = np.float32(1.0) / np.float32(base)
    idx = int(index) & _MASK
    result = np.float32(0.0)
    factor = inv_base
    for _ in range(16):
        digit = idx % base
        if perm is not None:
            digit = int(perm[pi, digit])
        result = result + np.float32(digit) * factor
        factor = factor * inv_base
        idx //= base
    return result


def radical_inverse(prime_index: int, index: int, rotation):
    """Radical inverse of ``index`` in the ``prime_index``-th prime base,
    rotated by ``rotation`` (a float32 tensor) modulo 1."""
    u = rotation + float(_digits(prime_index, index))
    return u - torch.floor(u)


def radical_inverse_lanes(prime_index: int, index, rotation: float = 0.0):
    """``radical_inverse`` of a tensor of indices (the JAX
    ``radical_inverse`` with a traced index): 16 base-b digits of each
    index's uint32 value, summed in float32 in the JAX order, then rotated
    by ``rotation`` modulo 1."""
    pi = min(max(int(prime_index), 0), len(_PRIMES) - 1)
    base = _PRIMES[pi]
    inv_base = np.float32(1.0) / np.float32(base)
    idx = index.to(torch.int64) & _MASK
    result = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    factor = inv_base
    for _ in range(16):
        result = result + (idx % base).to(torch.float32) * float(factor)
        factor = factor * inv_base
        idx = torch.div(idx, base, rounding_mode="floor")
    u = result + float(np.float32(rotation))
    return u - torch.floor(u)


# --- Faure digit permutations (faure.cpp role) -----------------------------
# sigma_2 = (0, 1); even b: 2*sigma_{b/2} ++ 2*sigma_{b/2}+1;
# odd b: insert (b-1)/2 in the middle of sigma_{b-1} and bump values >= it
# (Faure 1992's recursive construction, computed on the host once).
def _faure_perm(b):
    if b == 2:
        return np.array([0, 1], np.int64)
    if b % 2 == 0:
        h = _faure_perm(b // 2)
        return np.concatenate([2 * h, 2 * h + 1])
    c = (b - 1) // 2
    p = _faure_perm(b - 1)
    p = np.where(p >= c, p + 1, p)
    return np.concatenate([p[:c], [c], p[c:]])


_MAX_BASE = _PRIMES[31]
_FAURE = np.zeros((32, _MAX_BASE), np.uint32)
for _i, _b in enumerate(_PRIMES):
    _FAURE[_i, :_b] = _faure_perm(_b)


def scrambled_radical_inverse(prime_index: int, index: int) -> np.float32:
    """Radical inverse with Faure's permutation of each digit (a host
    float32: the caller adds its per-stream rotation)."""
    return _digits(prime_index, index, perm=_FAURE)


def sobol_nd(dim: int, index: int, scramble):
    """Sobol' sample of dimension ``dim`` (clipped to the table) at
    ``index``: the XOR of the dimension's direction numbers over the index's
    set bits, then the per-stream XOR ``scramble`` (uint32 words in an int64
    tensor). Returns float32 from the top 24 bits, in [0, 1)."""
    row = SOBOL_DIRECTIONS[min(max(int(dim), 0), SOBOL_MAX_DIMS - 1)]
    x = scramble ^ _xor_directions(int(index) & _MASK, row)
    return (x >> 8).to(torch.float32) * 5.9604645e-8
