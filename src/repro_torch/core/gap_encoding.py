"""Gap encoding for adjacency lists (paper §III-E, Fig. 5-a) — a copy of
``src/repro/core/gap_encoding.py`` (numpy only; the encoded bits equal the
reference's for the same adjacency).

Per row: sort neighbour ids ascending, keep the first absolute, store the
rest as deltas to the previous id. The whole graph uses one fixed bit width
b = max(bits(first ids), bits(max delta)) so address arithmetic stays trivial
(paper: "each page uses the same bit length"). Rows are bit-packed into a
flat uint64-backed little-endian bitstream.

The paper reports 20-26 bit widths on 1M-100M graphs -> >=19-37% compression
vs uniform 32-bit; ``compression_ratio`` reproduces that number.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GapEncodedGraph:
    bits: np.ndarray        # packed little-endian bitstream, uint64 words
    bit_width: int          # fixed width b for every stored value
    num_vertices: int
    max_degree: int         # R — every row padded to R entries

    @property
    def encoded_bytes(self) -> int:
        return self.num_vertices * self.max_degree * self.bit_width // 8

    @property
    def raw_bytes(self) -> int:
        return self.num_vertices * self.max_degree * 4

    @property
    def compression_ratio(self) -> float:
        return 1.0 - (self.num_vertices * self.max_degree * self.bit_width) / (
            self.num_vertices * self.max_degree * 32
        )


def _sorted_padded(adj: np.ndarray) -> np.ndarray:
    """Sort each row ascending. Padding (repeated last neighbour) sorts into
    place as duplicates; deltas for duplicates are 0 — free to encode."""
    return np.sort(adj.astype(np.int64), axis=1)


def gap_encode(adj: np.ndarray) -> GapEncodedGraph:
    n, r = adj.shape
    s = _sorted_padded(adj)
    deltas = np.empty_like(s)
    deltas[:, 0] = s[:, 0]
    deltas[:, 1:] = s[:, 1:] - s[:, :-1]
    assert (deltas >= 0).all()
    max_val = int(deltas.max()) if deltas.size else 0
    bit_width = max(1, int(max_val).bit_length())

    flat = deltas.reshape(-1).astype(np.uint64)
    total_bits = flat.size * bit_width
    words = np.zeros((total_bits + 63) // 64 + 1, dtype=np.uint64)
    positions = np.arange(flat.size, dtype=np.uint64) * np.uint64(bit_width)
    word_idx = positions >> np.uint64(6)
    bit_off = positions & np.uint64(63)
    lo = (flat << bit_off) & np.uint64(0xFFFFFFFFFFFFFFFF)
    # contribution spilling into the next word
    shift_hi = np.uint64(64) - bit_off
    hi = np.where(bit_off > 0, flat >> shift_hi, np.uint64(0))
    np.bitwise_or.at(words, word_idx.astype(np.int64), lo)
    np.bitwise_or.at(words, word_idx.astype(np.int64) + 1, hi)
    return GapEncodedGraph(bits=words, bit_width=bit_width, num_vertices=n, max_degree=r)


def gap_decode(enc: GapEncodedGraph) -> np.ndarray:
    n, r, b = enc.num_vertices, enc.max_degree, enc.bit_width
    count = n * r
    positions = np.arange(count, dtype=np.uint64) * np.uint64(b)
    word_idx = (positions >> np.uint64(6)).astype(np.int64)
    bit_off = positions & np.uint64(63)
    lo = enc.bits[word_idx] >> bit_off
    shift_hi = np.uint64(64) - bit_off
    hi = np.where(bit_off > 0, enc.bits[word_idx + 1] << shift_hi, np.uint64(0))
    mask = (np.uint64(1) << np.uint64(b)) - np.uint64(1) if b < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
    vals = ((lo | hi) & mask).reshape(n, r).astype(np.int64)
    out = np.cumsum(vals, axis=1)
    return out.astype(np.int32)


def gap_stats(adj: np.ndarray) -> dict:
    enc = gap_encode(adj)
    return {
        "bit_width": enc.bit_width,
        "raw_bytes": enc.raw_bytes,
        "encoded_bytes": enc.encoded_bytes,
        "compression_ratio": enc.compression_ratio,
    }
