"""Caps — typed stream capabilities and negotiation.

The reference negotiates pad formats with GStreamer caps: a media-type name
plus fields whose values can be fixed, lists, or ranges; linking intersects
upstream and downstream caps and fixates the result
(``tensor_common.c`` caps helpers, ``gst_tensor_filter_configure_tensor``,
tensor_filter.c:794). We keep the same model because it is what lets
semantics-agnostic elements compose, but the implementation is a small
value-type: a name plus a field dict where a value may be

- a fixed scalar (int/str/Fraction),
- a list of alternatives,
- an ``IntRange(lo, hi)``,
- or ``ANY`` (unconstrained).

Intersection is field-wise; a missing field means unconstrained. ``fixate``
collapses lists/ranges to their first/lowest value. This is deliberately much
smaller than GstCaps — tensor pipelines only ever use a handful of fields —
while preserving the negotiation semantics the elements rely on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

ANY = object()


@dataclasses.dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int

    def intersect(self, other):
        if isinstance(other, IntRange):
            lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
            if lo > hi:
                return None
            return IntRange(lo, hi) if lo != hi else lo
        if isinstance(other, int):
            return other if self.lo <= other <= self.hi else None
        return None

    def __contains__(self, v):
        return isinstance(v, int) and self.lo <= v <= self.hi


def _intersect_values(a, b):
    """Intersect two field values; None means empty intersection."""
    if a is ANY:
        return b
    if b is ANY:
        return a
    if isinstance(a, IntRange):
        return a.intersect(b)
    if isinstance(b, IntRange):
        return b.intersect(a)
    a_list = a if isinstance(a, (list, tuple)) else [a]
    b_list = b if isinstance(b, (list, tuple)) else [b]
    common = [x for x in a_list if x in b_list]
    if not common:
        return None
    return common[0] if len(common) == 1 else list(common)


def _is_fixed_value(v) -> bool:
    return v is not ANY and not isinstance(v, (list, IntRange))


class Caps:
    """One caps structure: media-type name + constraint fields."""

    def __init__(self, name: str, fields: Optional[Dict[str, Any]] = None):
        self.name = name
        self.fields: Dict[str, Any] = dict(fields or {})

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, k):
        return self.fields[k]

    def __contains__(self, k):
        return k in self.fields

    def get(self, k, default=None):
        return self.fields.get(k, default)

    def with_fields(self, **kw) -> "Caps":
        f = dict(self.fields)
        f.update(kw)
        return Caps(self.name, f)

    def to_string(self) -> str:
        """GStreamer-style textual caps ("name,k=v,..."), the inverse of
        :func:`~nnstreamer_tpu_torch.pipeline.parse.parse_caps_string` — the
        form caps travel in on query/MQTT wires (reference
        gst_caps_to_string)."""
        parts = [self.name]
        parts.extend(f"{k}={v}" for k, v in self.fields.items())
        return ",".join(parts)

    # -- negotiation ---------------------------------------------------------
    def intersect(self, other: "Caps") -> Optional["Caps"]:
        if self.name != other.name:
            return None
        fields = dict(self.fields)
        for k, v in other.fields.items():
            if k in fields:
                merged = _intersect_values(fields[k], v)
                if merged is None:
                    return None
                fields[k] = merged
            else:
                fields[k] = v
        return Caps(self.name, fields)

    def is_fixed(self) -> bool:
        return all(_is_fixed_value(v) for v in self.fields.values())

    def fixate(self) -> "Caps":
        fields = {}
        for k, v in self.fields.items():
            if v is ANY:
                continue
            if isinstance(v, list):
                v = v[0]
            elif isinstance(v, IntRange):
                v = v.lo
            fields[k] = v
        return Caps(self.name, fields)

    def __eq__(self, other):
        return (
            isinstance(other, Caps)
            and self.name == other.name
            and self.fields == other.fields
        )

    def __repr__(self):
        parts = [self.name]
        for k, v in self.fields.items():
            if v is ANY:
                v = "ANY"
            elif isinstance(v, IntRange):
                v = f"[{v.lo},{v.hi}]"
            parts.append(f"{k}={v}")
        return "Caps(" + ", ".join(str(p) for p in parts) + ")"


class CapsList:
    """An ordered set of alternative Caps (a pad template's full caps).

    An ANY CapsList (unconstrained pad) is distinct from an *empty* one
    (failed negotiation) — gst makes the same distinction between
    GST_CAPS_ANY and empty caps.
    """

    def __init__(self, caps: Iterable[Caps], _any: bool = False):
        self.caps = list(caps)
        self._any = _any and not self.caps

    @classmethod
    def any(cls) -> "CapsList":
        return cls([], _any=True)

    def is_any(self) -> bool:
        return self._any

    def intersect(self, other: "CapsList") -> "CapsList":
        if self.is_any():
            return CapsList(other.caps, _any=other.is_any())
        if other.is_any():
            return CapsList(self.caps)
        out = []
        for a in self.caps:
            for b in other.caps:
                c = a.intersect(b)
                if c is not None:
                    out.append(c)
        return CapsList(out)

    def is_empty(self) -> bool:
        return not self.is_any() and not self.caps

    def first(self) -> Optional[Caps]:
        return self.caps[0] if self.caps else None

    def __iter__(self):
        return iter(self.caps)

    def __repr__(self):
        return f"CapsList({self.caps!r})" if self.caps else "CapsList(ANY)"
