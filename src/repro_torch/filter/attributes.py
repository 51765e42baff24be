"""AttributeStore — per-node attribute columns + bitmap mask compilation; a
copy of ``src/repro/filter/attributes.py`` (numpy only).  Its masks are the
reference's bit for bit, and ``random_attributes`` draws the same columns
from the same seed.

Attributes live as a fixed-shape ``(N, F)`` int32 column matrix (categorical
fields are integer-coded), the host-side twin of the attribute words the NAND
layout keeps in each node's page spare area (``FilterConfig.attr_bits`` per
word, billed by ``nand.simulator``). A ``FilterSpec`` compiles to a per-node
boolean mask in one vectorized pass, and masks pack into uint32 bitmaps —
the wire/storage form the tile-level zero-pass skip and the pushdown
accounting use (32 nodes per word, fixed shapes, jit-friendly).

The store is row-indexed; what the rows key (a frozen index's reordered
internal ids, or a ``MutableIndex``'s stable external ids) is the owner's
contract. ``append`` supports the streaming insert path with amortized
doubling growth.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.filter.spec import FilterSpec


def encode_categorical(values: Sequence) -> Tuple[np.ndarray, Dict]:
    """String/object categories -> (int32 codes, {category: code} vocab).
    Codes are assigned in first-appearance order (deterministic)."""
    vocab: Dict = {}
    codes = np.empty(len(values), np.int32)
    for i, v in enumerate(values):
        if v not in vocab:
            vocab[v] = len(vocab)
        codes[i] = vocab[v]
    return codes, vocab


def pack_bitmap(mask: np.ndarray) -> np.ndarray:
    """(N,) bool -> (ceil(N/32),) uint32, little-endian bit order."""
    bits = np.packbits(np.asarray(mask, bool), bitorder="little")
    pad = (-len(bits)) % 4
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return bits.view("<u4")


def unpack_bitmap(bitmap: np.ndarray, n: int) -> np.ndarray:
    """(W,) uint32 -> (n,) bool."""
    bits = np.unpackbits(np.ascontiguousarray(bitmap).view(np.uint8),
                         bitorder="little")
    return bits[:n].astype(bool)


def bitmap_popcount(bitmap: np.ndarray) -> int:
    return int(np.unpackbits(
        np.ascontiguousarray(bitmap).view(np.uint8)).sum())


class AttributeStore:
    """Column-oriented int32 attribute table over corpus rows."""

    def __init__(self, fields: Sequence[str], values: np.ndarray):
        values = np.asarray(values, np.int32)
        if values.ndim != 2 or values.shape[1] != len(tuple(fields)):
            raise ValueError(
                f"values must be (N, {len(tuple(fields))}), got {values.shape}"
            )
        self.fields: Tuple[str, ...] = tuple(fields)
        self._values = np.ascontiguousarray(values)
        self._len = values.shape[0]

    # -------------------------------------------------------- constructors
    @classmethod
    def from_columns(cls, columns: Dict[str, np.ndarray]) -> "AttributeStore":
        fields = tuple(columns)
        vals = np.stack(
            [np.asarray(columns[f], np.int32) for f in fields], axis=1
        ) if fields else np.zeros((0, 0), np.int32)
        return cls(fields, vals)

    def __len__(self) -> int:
        return self._len

    @property
    def values(self) -> np.ndarray:
        """(N, F) int32 view of the live rows."""
        return self._values[: self._len]

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    @property
    def attr_bits(self) -> int:
        """Bits of one node's packed attribute word (spare-area footprint)."""
        return 32 * self.num_fields

    def column(self, field: str) -> np.ndarray:
        return self.values[:, self.fields.index(field)]

    # ------------------------------------------------------------ mutation
    def coerce_row(self, row) -> list:
        """Validate one node's attributes (dict by field name, or a value
        sequence in column order) into the int column order — raises
        without touching the store, so callers can validate BEFORE other
        state mutates (e.g. MutableIndex.insert)."""
        if isinstance(row, dict):
            unknown = set(row) - set(self.fields)
            if unknown:
                raise KeyError(f"unknown attribute fields {sorted(unknown)}")
            return [int(row.get(f, 0)) for f in self.fields]
        vals = [int(v) for v in row]
        if len(vals) != self.num_fields:
            raise ValueError(
                f"row has {len(vals)} values, store has "
                f"{self.num_fields} fields"
            )
        return vals

    def append(self, row) -> int:
        """Append one node's attributes; returns the new row id."""
        vals = self.coerce_row(row)
        if self._len == self._values.shape[0]:
            grown = np.zeros(
                (max(2 * self._len, 64), self.num_fields), np.int32
            )
            grown[: self._len] = self._values[: self._len]
            self._values = grown
        self._values[self._len] = vals
        self._len += 1
        return self._len - 1

    # ----------------------------------------------------- mask compilation
    def mask(self, spec: FilterSpec) -> np.ndarray:
        """Compile ``spec`` to a (N,) boolean pass mask."""
        return np.asarray(spec.evaluate(self.values, self.fields, np))

    def bitmap(self, spec: FilterSpec) -> np.ndarray:
        """Compile ``spec`` to the packed uint32 form (32 nodes per word)."""
        return pack_bitmap(self.mask(spec))

    def selectivity(self, spec: FilterSpec) -> float:
        """Exact passing fraction — the estimator is exact because the mask
        is one vectorized pass over a host-resident column matrix."""
        if self._len == 0:
            return 0.0
        return float(self.mask(spec).mean())

    # ------------------------------------------------------------- reindex
    def permuted(self, perm: np.ndarray) -> "AttributeStore":
        """Rows re-keyed through ``perm`` (e.g. the index's visit-frequency
        reordering: row i of the result is old row perm[i])."""
        return AttributeStore(self.fields, self.values[np.asarray(perm)])

    def take(self, ids: np.ndarray) -> np.ndarray:
        """Gather rows (e.g. one tile's slice); negative ids -> zero rows."""
        ids = np.asarray(ids)
        out = self.values[np.clip(ids, 0, None)].copy()
        out[ids < 0] = 0
        return out


def random_attributes(
    n: int,
    spec: Dict[str, int] | None = None,
    seed: int = 0,
) -> AttributeStore:
    """Synthetic workload attributes: ``spec`` maps field name -> cardinality
    (values uniform in [0, cardinality)). Default schema gives a coarse
    categorical plus a fine-grained int, enough to dial any selectivity."""
    spec = spec or {"category": 16, "price": 1000}
    rng = np.random.default_rng(seed)
    cols = {
        f: rng.integers(0, card, size=n, dtype=np.int32)
        for f, card in spec.items()
    }
    return AttributeStore.from_columns(cols)
