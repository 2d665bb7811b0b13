# Port copy of karpenter_tpu/utils/resources.py.
"""Integer-exact resource math.

The reference does all resource arithmetic through k8s resource.Quantity
(sigs.k8s.io/karpenter pkg/utils/resources, consumed here per SURVEY.md §2.1).
We re-express quantities as exact integers so that the Python reference solver
and the TPU tensor solver operate on *identical* numbers:

  - cpu                  -> millicores (int)
  - memory / storage     -> bytes (int)
  - everything else      -> integer count (pods, gpus, ...)

The TPU path additionally quantizes to the canonical unit table in
`karpenter_tpu.solver.encode` (cpu: milli, memory: MiB rounded conservatively).
All control-plane bookkeeping stays byte-exact.

Reference behavior spec: pkg/providers/instancetype/types.go:305-451
(computeCapacity), designs/bin-packing.md:17-43 (FFD sort key).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

# Canonical well-known resource names (mirror of k8s core v1).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
NVIDIA_GPU = "nvidia.com/gpu"
AMD_GPU = "amd.com/gpu"
TPU_ACCEL = "google.com/tpu"
AWS_NEURON = "aws.amazon.com/neuron"
HABANA_GAUDI = "habana.ai/gaudi"
POD_ENI = "vpc.amazonaws.com/pod-eni"
EFA = "vpc.amazonaws.com/efa"

_BINARY_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIX = {
    "n": -3,  # handled specially below (sub-unit)
    "u": -2,
    "m": -1,
    "": 0,
    "k": 1,
    "M": 2,
    "G": 3,
    "T": 4,
    "P": 5,
    "E": 6,
}

_QTY_RE = re.compile(r"^\s*([+-]?[0-9]+(?:\.[0-9]+)?)\s*([A-Za-z]*)\s*$")


def parse_quantity(value: object, resource: str) -> int:
    """Parse a k8s-style quantity into the canonical integer unit.

    cpu -> millicores; all other resources -> base units (bytes or count).
    Fractional results round *up* (a request of 1.5 pods of cpu must reserve
    at least that much), matching the conservative direction for requests.
    """
    if isinstance(value, bool):
        raise ValueError(f"invalid quantity {value!r}")
    if isinstance(value, int):
        return value * 1000 if resource == CPU else value
    if isinstance(value, float):
        return _ceil_scaled(value, 1000 if resource == CPU else 1)
    m = _QTY_RE.match(str(value))
    if not m:
        raise ValueError(f"invalid quantity {value!r} for {resource}")
    num_s, suffix = m.groups()

    scale = 1000 if resource == CPU else 1
    if suffix in _BINARY_SUFFIX:
        mult = _BINARY_SUFFIX[suffix] * scale
        return _ceil_rational(num_s, mult)
    if suffix in _DECIMAL_SUFFIX:
        exp = _DECIMAL_SUFFIX[suffix]
        # value * 10^(3*exp) * scale, exactly.
        num = _ceil_rational(num_s, 10 ** (3 * exp) * scale) if exp >= 0 else None
        if num is not None:
            return num
        # negative exponents: divide
        return _ceil_rational_div(num_s, 10 ** (3 * -exp), scale)
    raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")


def _ceil_scaled(value: float, scale: int) -> int:
    from math import ceil

    return ceil(value * scale)


def _ceil_rational(num_s: str, mult: int) -> int:
    """ceil(decimal-string * mult) computed exactly with integers."""
    neg = num_s.startswith("-")
    num_s = num_s.lstrip("+-")
    if "." in num_s:
        whole, frac = num_s.split(".")
    else:
        whole, frac = num_s, ""
    denom = 10 ** len(frac)
    numer = int(whole + frac) if whole + frac else 0
    total = numer * mult
    q, r = divmod(total, denom)
    if neg:
        return -q  # ceil of a negative = truncate toward zero
    return q + (1 if r else 0)


def _ceil_rational_div(num_s: str, div: int, scale: int) -> int:
    neg = num_s.startswith("-")
    num_s = num_s.lstrip("+-")
    if "." in num_s:
        whole, frac = num_s.split(".")
    else:
        whole, frac = num_s, ""
    denom = 10 ** len(frac) * div
    numer = (int(whole + frac) if whole + frac else 0) * scale
    q, r = divmod(numer, denom)
    if neg:
        return -q
    return q + (1 if r else 0)


def format_quantity(amount: int, resource: str) -> str:
    """Human-readable rendering of a canonical integer quantity."""
    if resource == CPU:
        if amount % 1000 == 0:
            return str(amount // 1000)
        return f"{amount}m"
    if resource in (MEMORY, EPHEMERAL_STORAGE):
        for suffix in ("Ti", "Gi", "Mi", "Ki"):
            unit = _BINARY_SUFFIX[suffix]
            if amount % unit == 0 and amount != 0:
                return f"{amount // unit}{suffix}"
        return str(amount)
    return str(amount)


class Resources(Dict[str, int]):
    """A resource vector: name -> canonical integer amount.

    Missing keys are zero. All ops are exact integer arithmetic.
    """

    @classmethod
    def parse(cls, spec: Mapping[str, object] | None) -> "Resources":
        r = cls()
        for k, v in (spec or {}).items():
            r[k] = parse_quantity(v, k)
        return r

    def get_(self, key: str) -> int:
        return self.get(key, 0)

    def add(self, other: Mapping[str, int]) -> "Resources":
        out = Resources(self)
        for k, v in other.items():
            out[k] = out.get(k, 0) + v
        return out

    def sub(self, other: Mapping[str, int]) -> "Resources":
        out = Resources(self)
        for k, v in other.items():
            out[k] = out.get(k, 0) - v
        return out

    def fits(self, capacity: Mapping[str, int]) -> bool:
        """True if every requested amount is <= capacity (missing = 0)."""
        return all(v <= capacity.get(k, 0) for k, v in self.items() if v > 0)

    def exceeds(self, limit: Mapping[str, int]) -> bool:
        """True if any limited resource is exceeded (limit keys only)."""
        return any(self.get(k, 0) > v for k, v in limit.items())

    def positive(self) -> "Resources":
        return Resources({k: v for k, v in self.items() if v > 0})

    def max(self, other: Mapping[str, int]) -> "Resources":
        out = Resources(self)
        for k, v in other.items():
            if v > out.get(k, 0):
                out[k] = v
        return out

    def copy(self) -> "Resources":
        return Resources(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        inner = ", ".join(f"{k}={format_quantity(v, k)}" for k, v in sorted(self.items()))
        return f"Resources({inner})"


def merge(specs: Iterable[Mapping[str, int]]) -> Resources:
    out = Resources()
    for s in specs:
        out = out.add(s)
    return out


ZERO = Resources()
