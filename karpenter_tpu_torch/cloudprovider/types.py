# Port copy of karpenter_tpu/cloudprovider/types.py (cut to InstanceType and Offering).
"""CloudProvider contract: InstanceType / Offering model + typed errors.

Behavioral mirror of karpenter core `pkg/cloudprovider` as implemented by the
reference at pkg/cloudprovider/cloudprovider.go:56-305 (SURVEY.md §2.1/§2.3):

  InstanceType{Name, Requirements, Offerings, Capacity, Overhead}
  Offering{Requirements, Price, Available, ReservationCapacity}
  typed errors: InsufficientCapacityError, NodeClaimNotFoundError,
                CreateError, NodeClassNotReadyError
  InstanceTypes.Truncate (pkg/providers/instance/instance.go:260)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..api import wellknown as wk
from ..scheduling.requirements import IN, Requirement, Requirements
from ..utils.resources import Resources


@dataclass
class Offering:
    """One (instance-type, zone, capacity-type) purchasable unit."""

    zone: str
    capacity_type: str  # on-demand | spot | reserved
    price: float
    available: bool = True
    reservation_capacity: int = 0  # for capacity_type == reserved
    reservation_id: str = ""

    def requirements(self) -> Requirements:
        return Requirements.of(
            Requirement.create(wk.ZONE_LABEL, IN, [self.zone]),
            Requirement.create(wk.CAPACITY_TYPE_LABEL, IN, [self.capacity_type]),
        )


@dataclass
class InstanceType:
    name: str
    # The label universe this type offers (arch, os, zone set, capacity types,
    # cpu, memory-mib, family, size, ... ~25 keys in the reference,
    # pkg/providers/instancetype/types.go:158-284).
    requirements: Requirements
    capacity: Resources
    overhead: Resources  # kube-reserved + system-reserved + eviction threshold
    offerings: List[Offering] = field(default_factory=list)

    def allocatable(self) -> Resources:
        # fresh copy: callers assign the result onto claims and must never
        # share (and risk mutating) the memoized instance
        return Resources(self.allocatable_view())

    def allocatable_view(self) -> Resources:
        """READ-ONLY view of allocatable() (no defensive copy) — for hot
        fit checks that never mutate (the oracle probes this per
        (claim, type); copying dominated the memo win). Memoized per
        (capacity, overhead) OBJECT identity — the memo pins both objects so
        a swapped-in replacement can never alias a freed id (the
        _QUANTIZED_TYPE_CACHE `is`-check discipline)."""
        cached = getattr(self, "_alloc_memo", None)
        if (
            cached is None
            or cached[0] is not self.capacity
            or cached[1] is not self.overhead
        ):
            out = self.capacity.sub(self.overhead)
            cached = (
                self.capacity,
                self.overhead,
                Resources({k: max(0, v) for k, v in out.items()}),
            )
            self._alloc_memo = cached
        return cached[2]

    def cheapest_available(self, reqs: Optional[Requirements] = None) -> Optional[Offering]:
        best = None
        for o in self.offerings:
            if not o.available:
                continue
            if reqs is not None and not reqs.compatible(o.requirements()):
                continue
            if best is None or o.price < best.price:
                best = o
        return best

    def available(self, reqs: Optional[Requirements] = None) -> bool:
        return self.cheapest_available(reqs) is not None
