"""Bloom-filter visited set (paper §IV-D) — port of ``src/repro/core/bloom.py``.

Same hash family as the reference: 8 odd multiplicative constants, uint32
wrap-around multiplies and xor-shifts.  torch has no full uint32 arithmetic,
so the hash runs in int64 masked to 32 bits after every multiply; the low 32
bits of a product survive int64 wrap-around, so the positions are the
reference's bit for bit.

Layout: one bool per bit, one row per search lane, plus one scratch column at
index ``num_bits`` that masked-off insertions write to — so an insert is one
unconditional ``index_put_`` of ``True`` (an OR, with no host sync and no
order dependence), where the reference needs its sort-and-add trick
(``bloom.py:61-70``).  Membership is identical; ``packed_words`` packs a lane
back into the reference's uint32 words for comparison.
"""
from __future__ import annotations

import math

import torch

# 8 odd multiplicative constants (golden-ratio family, like SeaHash's mixers)
_HASH_MULTS = (
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
)
_MASK32 = 0xFFFFFFFF
_mults_on: dict = {}     # device -> int64 tensor of _HASH_MULTS (a constant)


def _mults(device) -> torch.Tensor:
    """The multipliers on ``device``, copied there once: a fresh host copy
    per call would block the host on the device every round."""
    t = _mults_on.get(device)
    if t is None:
        t = _mults_on[device] = torch.tensor(_HASH_MULTS, dtype=torch.int64,
                                             device=device)
    return t


def bloom_init(num_bits: int, lanes: int, device="cuda") -> torch.Tensor:
    """(lanes, num_bits + 1) bool; num_bits must be a power of two."""
    if num_bits & (num_bits - 1):
        raise ValueError("num_bits must be a power of 2")
    return torch.zeros(lanes, num_bits + 1, dtype=torch.bool, device=device)


def _hash_positions(ids: torch.Tensor, num_bits: int,
                    num_hashes: int) -> torch.Tensor:
    """(..., K) integer ids -> (..., K, H) int64 bit positions."""
    x = (ids.to(torch.int64) & _MASK32)[..., None]
    h = (x * _mults(ids.device)[:num_hashes]) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _MASK32
    h = h ^ (h >> 12)
    return h & (num_bits - 1)


def insert(bits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
           num_hashes: int = 8) -> torch.Tensor:
    """Set the bits of ``ids`` (lanes, K) where ``mask`` (lanes, K); in place,
    returns ``bits``."""
    lanes, width = bits.shape
    num_bits = width - 1
    pos = _hash_positions(ids, num_bits, num_hashes)             # (B, K, H)
    pos = torch.where(mask[..., None], pos, num_bits)            # scratch col
    row = torch.arange(lanes, device=bits.device)[:, None, None] * width
    bits.view(-1).index_put_(((pos + row).reshape(-1),),
                             torch.ones((), dtype=torch.bool,
                                        device=bits.device))
    return bits


def contains(bits: torch.Tensor, ids: torch.Tensor,
             num_hashes: int = 8) -> torch.Tensor:
    """(lanes, K) bool — True if the id *may* have been inserted."""
    num_bits = bits.shape[1] - 1
    pos = _hash_positions(ids, num_bits, num_hashes)
    lanes = bits.shape[0]
    return bits.gather(1, pos.reshape(lanes, -1)).reshape(pos.shape).all(-1)


def packed_words(bits: torch.Tensor) -> torch.Tensor:
    """(lanes, num_bits // 32) int64 words, bit b of word w = bit 32w + b —
    the reference's uint32 ``bits`` layout, for comparison."""
    lanes, width = bits.shape
    b = bits[:, : width - 1].reshape(lanes, -1, 32).to(torch.int64)
    return (b << torch.arange(32, device=bits.device)).sum(-1)


def false_positive_rate(num_bits: int, num_hashes: int, num_inserted: int) -> float:
    """Analytic FPR (paper §IV-D): (1 - e^{-kn/m})^k."""
    k, m, n = num_hashes, num_bits, num_inserted
    return (1.0 - math.exp(-k * n / m)) ** k
