"""FilterSpec — AND-composed attribute predicates over the corpus; a copy of
``src/repro/filter/spec.py`` (numpy only, so the port carries its own).

A spec is a tuple of predicates (equality / inclusive range / IN-set) over
named integer attribute columns; categorical fields are integer-coded by the
caller (``attributes.encode_categorical``). Specs are frozen and hashable so
the serving engine can batch requests by filter hash, and ``evaluate`` is
operator-only arithmetic over a numpy column matrix (``xp`` names the
array module, as in the reference).

Compose with ``&``::

    spec = FilterSpec.eq("category", 3) & FilterSpec.range("price", 0, 49)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Eq:
    """``field == value``."""
    field: str
    value: int


@dataclass(frozen=True)
class Range:
    """``lo <= field <= hi`` (inclusive; ``None`` leaves a side open)."""
    field: str
    lo: Optional[int] = None
    hi: Optional[int] = None


@dataclass(frozen=True)
class In:
    """``field in values``."""
    field: str
    values: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "values",
                           tuple(int(v) for v in self.values))


Predicate = Union[Eq, Range, In]


def _eval_predicate(p: Predicate, col, xp):
    if isinstance(p, Eq):
        return col == p.value
    if isinstance(p, Range):
        m = xp.ones(col.shape, bool)
        if p.lo is not None:
            m = m & (col >= p.lo)
        if p.hi is not None:
            m = m & (col <= p.hi)
        return m
    if isinstance(p, In):
        if not p.values:
            return xp.zeros(col.shape, bool)
        vals = xp.asarray(p.values)
        return (col[:, None] == vals[None, :]).any(axis=1)
    raise TypeError(f"unknown predicate {type(p).__name__}")


@dataclass(frozen=True)
class FilterSpec:
    """AND-composition of predicates. The empty spec passes every node."""
    predicates: Tuple[Predicate, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "predicates", tuple(self.predicates))

    # --------------------------------------------------------- constructors
    @staticmethod
    def eq(field: str, value: int) -> "FilterSpec":
        return FilterSpec((Eq(field, int(value)),))

    @staticmethod
    def range(field: str, lo: Optional[int] = None,
              hi: Optional[int] = None) -> "FilterSpec":
        return FilterSpec((Range(field, lo, hi),))

    @staticmethod
    def isin(field: str, values) -> "FilterSpec":
        return FilterSpec((In(field, tuple(values)),))

    def __and__(self, other: "FilterSpec") -> "FilterSpec":
        return FilterSpec(self.predicates + other.predicates)

    # ----------------------------------------------------------- evaluation
    @property
    def is_all(self) -> bool:
        return not self.predicates

    def fields(self) -> Tuple[str, ...]:
        return tuple(p.field for p in self.predicates)

    def evaluate(self, values, fields: Tuple[str, ...], xp=np):
        """(N, F) column matrix -> (N,) boolean pass mask."""
        mask = xp.ones(values.shape[0], bool)
        for p in self.predicates:
            try:
                col = values[:, fields.index(p.field)]
            except ValueError:
                raise KeyError(
                    f"filter references unknown attribute {p.field!r}; "
                    f"store has {fields}"
                ) from None
            mask = mask & _eval_predicate(p, col, xp)
        return mask


ALL = FilterSpec()
