# Port copy of karpenter_tpu/scheduling/requirements.py.
"""Requirements set-algebra.

Re-implements (TPU-first, from behavior) the label-keyed constraint algebra of
karpenter core `pkg/scheduling` as consumed by the reference at
pkg/providers/instancetype/types.go:179-283 and
pkg/providers/instance/instance.go:241 (SURVEY.md §2.1):

  - per-key value sets with operators In / NotIn / Exists / DoesNotExist /
    Gt / Lt (k8s NodeSelectorRequirement semantics)
  - `minValues` per-key flexibility floors
    (website/content/en/preview/concepts/nodepools.md:268-330)
  - Intersects / Compatible / Intersection over whole requirement sets

A per-key `Requirement` is canonically either:
  * a finite allow-set    (complement=False, values=frozenset)
  * a co-finite deny-set  (complement=True,  values=frozenset)  # NotIn/Exists
plus optional numeric bounds greater_than / less_than (exclusive), mirroring
how karpenter folds Gt/Lt into the same per-key structure.

This module is also the host-side front end of the TPU solver: requirement
sets are lowered to integer-coded masks in `karpenter_tpu.solver.encode`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence

# Operators (k8s corev1.NodeSelectorOperator spelling).
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

OPERATORS = (IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT)


class IncompatibleError(Exception):
    """Two requirement sets (or a set and labels) cannot be satisfied together."""


@dataclass(frozen=True)
class Requirement:
    """The set of acceptable values for one label key.

    `require_present` distinguishes operators that demand the label exist on
    the node (In / Exists / Gt / Lt — kube NodeSelectorRequirement semantics)
    from those vacuously satisfied by an absent label (NotIn / DoesNotExist).
    """

    key: str
    complement: bool = False  # True => values is a deny-set over all strings
    values: frozenset = field(default_factory=frozenset)
    greater_than: Optional[int] = None  # exclusive lower bound
    less_than: Optional[int] = None  # exclusive upper bound
    min_values: Optional[int] = None  # flexibility floor (NodePool minValues)
    require_present: bool = True

    # -- constructors -------------------------------------------------------

    @staticmethod
    def create(key: str, operator: str, values: Sequence[str] = (), min_values: Optional[int] = None) -> "Requirement":
        vals = frozenset(str(v) for v in values)
        if operator == IN:
            return Requirement(key, False, vals, min_values=min_values, require_present=True)
        if operator == NOT_IN:
            return Requirement(key, True, vals, min_values=min_values, require_present=False)
        if operator == EXISTS:
            return Requirement(key, True, frozenset(), min_values=min_values, require_present=True)
        if operator == DOES_NOT_EXIST:
            return Requirement(key, False, frozenset(), min_values=min_values, require_present=False)
        if operator == GT:
            (v,) = vals if len(vals) == 1 else (None,)
            if v is None:
                raise ValueError(f"{GT} requires exactly one value, got {sorted(vals)}")
            return Requirement(key, True, frozenset(), greater_than=int(v), min_values=min_values)
        if operator == LT:
            (v,) = vals if len(vals) == 1 else (None,)
            if v is None:
                raise ValueError(f"{LT} requires exactly one value, got {sorted(vals)}")
            return Requirement(key, True, frozenset(), less_than=int(v), min_values=min_values)
        raise ValueError(f"unknown operator {operator!r}")

    # -- predicates ---------------------------------------------------------

    def _bounds_ok(self, value: str) -> bool:
        if self.greater_than is None and self.less_than is None:
            return True
        try:
            n = int(value)
        except ValueError:
            return False
        if self.greater_than is not None and not n > self.greater_than:
            return False
        if self.less_than is not None and not n < self.less_than:
            return False
        return True

    def has(self, value: str) -> bool:
        """Does this requirement admit `value`?"""
        if not self._bounds_ok(value):
            return False
        if self.complement:
            return value not in self.values
        return value in self.values

    def is_complement(self) -> bool:
        return self.complement

    def allows_absent(self) -> bool:
        """DoesNotExist <=> empty allow-set."""
        return not self.complement and not self.values

    def is_empty(self) -> bool:
        """True if NO value can ever satisfy this requirement.

        Finite sets: no value passes the bounds. Co-finite sets: only empty
        when both numeric bounds are present and no integer lies strictly
        between them (bounds force numeric-only values, making the admissible
        set finite)."""
        if not self.complement:
            return not any(self._bounds_ok(v) for v in self.values) if self.values else True
        if self.greater_than is not None and self.less_than is not None:
            return not any(
                str(n) not in self.values
                for n in range(self.greater_than + 1, self.less_than)
            )
        return False

    def satisfiable(self) -> bool:
        """A value exists, or absence is acceptable (NotIn/DoesNotExist)."""
        return not self.is_empty() or not self.require_present

    def any_value(self) -> Optional[str]:
        """A representative admissible value (finite sets only)."""
        for v in sorted(self.values):
            if self.has(v):
                return v
        return None

    def len_hint(self) -> Optional[int]:
        """Cardinality if finite, else None (infinite)."""
        if self.complement:
            return None
        return sum(1 for v in self.values if self._bounds_ok(v))

    # -- algebra ------------------------------------------------------------

    def intersect(self, other: "Requirement") -> "Requirement":
        gt = _max_opt(self.greater_than, other.greater_than)
        lt = _min_opt(self.less_than, other.less_than)
        mv = _max_opt(self.min_values, other.min_values)
        rp = self.require_present or other.require_present
        if self.complement and other.complement:
            return Requirement(self.key, True, self.values | other.values, gt, lt, mv, rp)
        if self.complement:
            vals = frozenset(v for v in other.values if v not in self.values)
            return Requirement(self.key, False, vals, gt, lt, mv, rp)
        if other.complement:
            vals = frozenset(v for v in self.values if v not in other.values)
            return Requirement(self.key, False, vals, gt, lt, mv, rp)
        return Requirement(self.key, False, self.values & other.values, gt, lt, mv, rp)

    def intersects(self, other: "Requirement") -> bool:
        # allocation-free fast path for the overwhelmingly common bounds-free
        # case (the oracle's compatible() calls this millions of times per
        # large solve): without Gt/Lt, emptiness reduces to set algebra.
        if (
            self.greater_than is None
            and self.less_than is None
            and other.greater_than is None
            and other.less_than is None
        ):
            if self.complement:
                if other.complement:
                    return True  # co-finite ∩ co-finite is co-finite
                return any(v not in self.values for v in other.values)
            if other.complement:
                return any(v not in other.values for v in self.values)
            return not self.values.isdisjoint(other.values)
        return not self.intersect(other).is_empty()

    def values_list(self) -> list:
        return sorted(v for v in self.values if self._bounds_ok(v))

    def __repr__(self) -> str:  # pragma: no cover
        if self.complement and not self.values and self.greater_than is None and self.less_than is None:
            body = "Exists"
        elif self.complement:
            body = f"NotIn{sorted(self.values)}"
        else:
            body = f"In{sorted(self.values)}" if self.values else "DoesNotExist"
        bounds = ""
        if self.greater_than is not None:
            bounds += f" >{self.greater_than}"
        if self.less_than is not None:
            bounds += f" <{self.less_than}"
        return f"Req({self.key} {body}{bounds})"


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


class Requirements(Dict[str, Requirement]):
    """A conjunction of per-key requirements."""

    @classmethod
    def of(cls, *reqs: Requirement) -> "Requirements":
        out = cls()
        out.add(*reqs)
        return out

    @classmethod
    def from_labels(cls, labels: Mapping[str, str]) -> "Requirements":
        return cls.of(*(Requirement.create(k, IN, [v]) for k, v in (labels or {}).items()))

    @classmethod
    def from_node_selector_terms(cls, terms: Iterable[Mapping]) -> "Requirements":
        """Parse a list of {key, operator, values, minValues?} dicts."""
        out = cls()
        for t in terms or ():
            out.add(
                Requirement.create(
                    t["key"], t.get("operator", IN), t.get("values", ()), t.get("minValues")
                )
            )
        return out

    def add(self, *reqs: Requirement) -> "Requirements":
        for r in reqs:
            cur = self.get(r.key)
            self[r.key] = cur.intersect(r) if cur is not None else r
        return self

    def union(self, other: "Requirements") -> "Requirements":
        out = Requirements(self)
        out.add(*other.values())
        return out

    # -- compatibility ------------------------------------------------------

    def compatible(self, other: "Requirements") -> bool:
        """Can a node satisfy both requirement sets?

        Mirrors karpenter `Requirements.Compatible`: for every key in `self`,
        the intersection with `other`'s requirement (Exists if absent) must be
        non-empty; and vice versa for keys only in `other` whose requirement
        forbids absence. Absent keys behave as unconstrained (Exists).
        """
        for key, req in self.items():
            o = other.get(key)
            if o is None:
                # Other side unconstrained: any non-DoesNotExist req is fine,
                # DoesNotExist is also fine (the label may simply be absent).
                continue
            if not req.intersects(o):
                return False
        return True

    def strictly_compatible(self, other: "Requirements") -> bool:
        """Compatible, and every key whose operator demands label presence
        (In/Exists/Gt/Lt) is actually defined by `other` — used when `other`
        is a concrete node label universe rather than another constraint set.
        NotIn/DoesNotExist are vacuously satisfied by an absent label (kube
        NodeSelectorRequirement semantics)."""
        for key, req in self.items():
            o = other.get(key)
            if o is None:
                if req.require_present:
                    return False
                continue
            if not req.intersects(o):
                return False
        return True

    def labels(self) -> Dict[str, str]:
        """Single-valued keys rendered as node labels (reference:
        pkg/cloudprovider/cloudprovider.go:377-436 builds NodeClaim labels
        from single-valued requirements)."""
        out: Dict[str, str] = {}
        for key, req in self.items():
            if not req.complement and len(req.values) == 1:
                (v,) = req.values
                out[key] = v
        return out

    def has_min_values(self) -> bool:
        return any(r.min_values for r in self.values())

    def __repr__(self) -> str:  # pragma: no cover
        return "Requirements(" + ", ".join(repr(r) for r in self.values()) + ")"
