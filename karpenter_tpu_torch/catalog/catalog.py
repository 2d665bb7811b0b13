# Port copy of karpenter_tpu/catalog/catalog.py.
"""Synthetic instance-type catalog.

The reference ships ~800 EC2 instance types discovered live plus generated
static price/bandwidth/vpc-limit tables (SURVEY.md §2.2 instancetype, §2.11
codegen). For hermetic operation we *generate* a deterministic EC2-shaped
catalog instead: families × sizes with per-family price curves, zonal spot
discounts, accelerator families, and kube-reserved/eviction overhead formulas
mirroring pkg/providers/instancetype/types.go:453-546 behaviorally.

Nothing here is copied from the reference's generated data; the generator is
seeded and pure so every run (and both solver backends) see identical inputs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
import re

from typing import Dict, List, Optional, Sequence

from ..api import wellknown as wk
from ..cloudprovider.types import InstanceType, Offering
from ..scheduling.requirements import IN, Requirement, Requirements
from ..utils import resources as res
from ..utils.resources import Resources

GIB = 1024**3
MIB = 1024**2

# family -> (vcpu:mem-GiB ratio, $/vcpu-hr OD base, arch, accelerator per 8xl)
_FAMILIES = [
    # general purpose
    ("m5", 4, 0.048, "amd64", None),
    ("m5a", 4, 0.043, "amd64", None),
    ("m6i", 4, 0.048, "amd64", None),
    ("m6g", 4, 0.0385, "arm64", None),
    ("m7i", 4, 0.0504, "amd64", None),
    ("m7g", 4, 0.0408, "arm64", None),
    # compute optimized
    ("c5", 2, 0.0425, "amd64", None),
    ("c5a", 2, 0.0385, "amd64", None),
    ("c6i", 2, 0.0425, "amd64", None),
    ("c6g", 2, 0.034, "arm64", None),
    ("c7i", 2, 0.04463, "amd64", None),
    ("c7g", 2, 0.0363, "arm64", None),
    # memory optimized
    ("r5", 8, 0.063, "amd64", None),
    ("r5a", 8, 0.0565, "amd64", None),
    ("r6i", 8, 0.063, "amd64", None),
    ("r6g", 8, 0.0504, "arm64", None),
    ("r7i", 8, 0.06615, "amd64", None),
    ("r7g", 8, 0.05355, "arm64", None),
    # high memory
    ("x2gd", 16, 0.0835, "arm64", None),
    ("z1d", 8, 0.093, "amd64", None),
    # burstable
    ("t3", 4, 0.0416, "amd64", None),
    ("t3a", 4, 0.0376, "amd64", None),
    ("t4g", 4, 0.0336, "arm64", None),
    # AMD 3rd/4th-gen line
    ("m6a", 4, 0.0432, "amd64", None),
    ("c6a", 2, 0.0383, "amd64", None),
    ("r6a", 8, 0.0567, "amd64", None),
    ("m7a", 4, 0.05796, "amd64", None),
    ("c7a", 2, 0.05133, "amd64", None),
    ("r7a", 8, 0.07607, "amd64", None),
    # graviton 4
    ("c8g", 2, 0.03987, "arm64", None),
    # storage optimized
    ("i3", 8, 0.078, "amd64", None),
    ("i3en", 8, 0.1092, "amd64", None),
    ("i4i", 8, 0.0858, "amd64", None),
    ("im4gn", 6, 0.091, "arm64", None),
    ("d3", 8, 0.0624, "amd64", None),
    # high memory network/storage
    ("x2iedn", 32, 0.1668, "amd64", None),
    # accelerated
    ("g4dn", 8, 0.1578, "amd64", ("nvidia.com/gpu", 1)),
    ("g5", 8, 0.1512, "amd64", ("nvidia.com/gpu", 1)),
    ("p3", 8, 0.3825, "amd64", ("nvidia.com/gpu", 4)),
    ("p4d", 12, 0.3410, "amd64", ("nvidia.com/gpu", 8)),
    ("inf1", 8, 0.057, "amd64", ("aws.amazon.com/neuron", 4)),
    ("trn1", 16, 0.4169, "amd64", ("aws.amazon.com/neuron", 8)),
    ("dl1", 24, 0.1277, "amd64", ("habana.ai/gaudi", 8)),
]

# Variant suffixes applied to mainstream families, shaped like EC2's d (local
# NVMe), n (network-optimized), and dn combos — expands the catalog to the
# reference's ~700-type scale (726+ with the round-4 families).
_VARIANTS = [
    ("d", 1.06, {"m5", "m6i", "m6g", "c5", "c6i", "c6g", "r5", "r6i", "r6g", "i3", "z1d"}),
    ("n", 1.12, {"m5", "c5", "r5", "c6g", "m6i", "c6i"}),
    ("dn", 1.18, {"m5", "c5", "r5"}),
    ("b", 1.04, {"r5", "m5"}),
    ("zn", 1.32, {"m5"}),
]


def _expanded_families():
    fams = list(_FAMILIES)
    base = {f[0]: f for f in _FAMILIES}
    for suffix, markup, members in _VARIANTS:
        for fam in sorted(members):
            name, ratio, price, arch, accel = base[fam]
            variant = f"{name}{suffix}"
            if any(f[0] == variant for f in fams):
                continue
            fams.append((variant, ratio, round(price * markup, 6), arch, accel))
    return fams

# size suffix -> vcpu count
_SIZES = [
    ("medium", 1),
    ("large", 2),
    ("xlarge", 4),
    ("2xlarge", 8),
    ("4xlarge", 16),
    ("8xlarge", 32),
    ("12xlarge", 48),
    ("16xlarge", 64),
    ("24xlarge", 96),
    ("32xlarge", 128),
    ("48xlarge", 192),
    ("metal", 96),
]

_BURSTABLE = {"t3", "t3a", "t4g"}  # name-prefix tests would eat trn1 too

_GPU_SIZES = {"xlarge", "2xlarge", "4xlarge", "8xlarge", "12xlarge", "16xlarge", "24xlarge", "48xlarge"}

DEFAULT_ZONES = ("zone-1a", "zone-1b", "zone-1c")


def _h(s: str) -> float:
    """Deterministic hash -> [0,1)."""
    return int(hashlib.sha256(s.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF


def _max_pods(vcpus: int) -> int:
    """ENI-limited pod density, shaped like types.go:453-467's formula."""
    if vcpus <= 2:
        return 29
    if vcpus <= 4:
        return 58
    if vcpus <= 16:
        return 110
    return 234


def _kube_reserved_cpu_milli(vcpus: int) -> int:
    """Banded CPU reservation (types.go:484-517): 6% of first core, 1% of the
    next, 0.5% of the next two, 0.25% of the rest."""
    cores = vcpus
    milli = 0
    bands = [(1, 60), (1, 10), (2, 5), (cores, 2.5)]
    remaining = cores
    for width, per_core_milli in bands:
        take = min(remaining, width)
        if take <= 0:
            break
        milli += int(take * per_core_milli)
        remaining -= take
    return milli


def _kube_reserved_memory(pods: int) -> int:
    """255Mi + 11Mi per pod (the reference's max-pods-based formula)."""
    return (255 + 11 * pods) * MIB


def _eviction_threshold() -> int:
    """100Mi hard eviction threshold (types.go:519-546 default)."""
    return 100 * MIB


@dataclass(frozen=True)
class CatalogSpec:
    zones: Sequence[str] = DEFAULT_ZONES
    spot: bool = True
    vm_memory_overhead_percent: float = 0.075  # settings.md / options.go:36-56


def generate(spec: CatalogSpec = CatalogSpec()) -> List[InstanceType]:
    """Build the full deterministic catalog (~730 instance types)."""
    out: List[InstanceType] = []
    for family, ratio, per_vcpu, arch, accel in _expanded_families():
        for size, vcpus in _SIZES:
            if accel and size not in _GPU_SIZES:
                continue
            if family in _BURSTABLE and vcpus > 8:
                continue  # burstable families stop at 2xlarge
            if family in ("p3", "p4d", "trn1", "dl1") and vcpus < 16:
                continue
            name = f"{family}.{size}"
            mem_gib = vcpus * ratio
            # VM overhead: the hypervisor + CMA carve-out the reference models
            # with vm-memory-overhead-percent (instancetype.go:320-344 learns
            # the true value; we apply the configured percent).
            mem_bytes = int(mem_gib * GIB * (1 - spec.vm_memory_overhead_percent))
            pods = _max_pods(vcpus)
            capacity = Resources(
                {
                    res.CPU: vcpus * 1000,
                    res.MEMORY: mem_bytes,
                    res.EPHEMERAL_STORAGE: 50 * GIB,
                    res.PODS: pods,
                }
            )
            if accel:
                accel_name, per_8xl = accel
                count = max(1, (vcpus // 32) * per_8xl)
                capacity[accel_name] = count
            overhead = Resources(
                {
                    res.CPU: _kube_reserved_cpu_milli(vcpus),
                    res.MEMORY: _kube_reserved_memory(pods) + _eviction_threshold(),
                }
            )
            od_price = round(per_vcpu * vcpus * (1.0 + 0.03 * _h(name)), 5)
            offerings: List[Offering] = []
            for zone in spec.zones:
                offerings.append(Offering(zone=zone, capacity_type=wk.CAPACITY_TYPE_ON_DEMAND, price=od_price))
                if spec.spot and family not in _BURSTABLE:
                    discount = 0.55 + 0.25 * _h(f"{name}/{zone}")  # 55-80% off-ish band
                    offerings.append(
                        Offering(
                            zone=zone,
                            capacity_type=wk.CAPACITY_TYPE_SPOT,
                            price=round(od_price * (1 - discount), 5),
                        )
                    )
            m_gen = re.search(r"\d", family)
            generation = int(m_gen.group()) if m_gen else 0
            reqs = Requirements.of(
                Requirement.create("karpenter.tpu/instance-cpu", IN, [str(vcpus * 1000)]),
                Requirement.create("karpenter.tpu/instance-memory-mib", IN, [str(mem_bytes // MIB)]),
                Requirement.create("karpenter.tpu/instance-family", IN, [family]),
                Requirement.create("karpenter.tpu/instance-size", IN, [size]),
                Requirement.create("karpenter.tpu/instance-generation", IN, [str(generation)]),
                Requirement.create("karpenter.tpu/instance-category", IN, [family[0]]),
                Requirement.create(wk.INSTANCE_TYPE_LABEL, IN, [name]),
                Requirement.create(wk.ARCH_LABEL, IN, [arch]),
                Requirement.create(wk.OS_LABEL, IN, ["linux"]),
                Requirement.create(wk.ZONE_LABEL, IN, sorted({o.zone for o in offerings})),
                Requirement.create(
                    wk.CAPACITY_TYPE_LABEL, IN, sorted({o.capacity_type for o in offerings})
                ),
            )
            if accel:
                reqs.add(Requirement.create("karpenter.tpu/instance-accelerator", IN, [accel[0]]))
            out.append(
                InstanceType(
                    name=name,
                    requirements=reqs,
                    capacity=capacity,
                    overhead=overhead,
                    offerings=offerings,
                )
            )
    return out
