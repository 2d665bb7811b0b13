# Port copy of karpenter_tpu/api/objects.py (cut to the pod-side objects).
"""Core object model: the k8s objects the control loop consumes/produces.

This is a deliberately small, hermetic re-expression of the object surface the
reference interacts with through the kube API (SURVEY.md §1: "Kubernetes API
server is the message bus"). Objects are plain dataclasses stored in the
in-process API store (`karpenter_tpu.controllers.store`) with watch semantics,
so the whole control loop closes without a cluster — the same trick the
reference's kwok provider uses (kwok/ec2/ec2.go:374-628 creates Node objects
directly).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..scheduling.requirements import IN, NOT_IN, EXISTS, Requirement, Requirements
from ..utils.resources import Resources
from . import wellknown as wk

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


# Field metadata marking control-plane-clock timestamps: snapshot restore
# discovers these by dataclass introspection and rebases them by the
# restart's clock delta (controllers/snapshot.py) — a new timestamp field
# declared with this marker rebases automatically instead of silently
# skewing age math after restore.
CLOCK = {"clock": True}


@dataclass
class ObjectMeta:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid())
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_refs: List[str] = field(default_factory=list)  # uids
    # None = "not yet persisted": Store.create stamps it from the store's
    # injected clock, so age math (GC grace, disruption ranking, expiry)
    # always compares against the same clock — a wall-clock default here
    # silently breaks every sim-clock deployment (r5 review finding)
    creation_timestamp: Optional[float] = field(default=None, metadata=CLOCK)
    deletion_timestamp: Optional[float] = field(default=None, metadata=CLOCK)
    resource_version: int = 0

    @property
    def deleting(self) -> bool:
        return self.deletion_timestamp is not None


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str
    value: str = ""

    def as_tuple(self) -> Tuple[str, str, str]:
        return (self.key, self.value, self.effect)


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == EXISTS or self.operator == "Exists":
            return not self.key or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates_all(tolerations: Sequence[Toleration], taints: Sequence[Taint]) -> bool:
    """Pod schedulability gate: every NoSchedule/NoExecute taint must be
    tolerated (PreferNoSchedule is advisory and ignored, matching
    kube-scheduler semantics the reference simulates)."""
    for t in taints:
        if t.effect == wk.EFFECT_PREFER_NO_SCHEDULE:
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Dict[str, str] = field(default_factory=dict)
    min_domains: Optional[int] = None


@dataclass
class PodAffinityTerm:
    label_selector: Dict[str, str]
    topology_key: str
    anti: bool = False
    # weight != None => preferred (soft); reference treats preferred terms via
    # relaxation (website/.../scheduling.md:212-219)
    weight: Optional[int] = None
    # Internal marker set ONLY by the relax loop (solver/relax.py) when it
    # materializes an ACTIVE weighted anti term: the term blocks this pod's
    # own admission like a required anti, but must NOT register as an owned
    # anti at placement — the oracle's bookkeeping records only the original
    # pod's required terms, so satisfied preferences never constrain later
    # pods. Encodes as a kind-3 (blocking-only) domain sig.
    admission_only: bool = False


# Pod fields that feed the solver's cached signature / FFD sort key; assigning
# any of them drops the caches (see Pod.__setattr__).
_POD_SIG_FIELDS = frozenset(
    {
        "meta",
        "requests",
        "node_selector",
        "node_affinity",
        "preferred_node_affinity",
        "tolerations",
        "topology_spread",
        "affinity_terms",
        "priority",
        "volume_zones",
    }
)
_POD_CACHE_KEYS = ("_solver_sig", "_ffd_key", "_sig_num", "_mib_aligned")

# Global pod-mutation epoch: bumped when a pod that has been through the
# encoder (it carries cache keys) is mutated in place. Cross-solve encode
# caches key on (epoch, identity-fingerprint of the pod set): any in-place
# mutation of an encoded pod invalidates them. Fresh pods have no cache keys
# yet, so construction does not bump the epoch.
_POD_MUTATION_EPOCH = 0


def pod_mutation_epoch() -> int:
    return _POD_MUTATION_EPOCH


@dataclass
class Pod:
    meta: ObjectMeta
    requests: Resources = field(default_factory=Resources)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # requiredDuringScheduling node affinity: list of OR'd term-groups, each a
    # Requirements conjunction.
    node_affinity: List[Requirements] = field(default_factory=list)
    preferred_node_affinity: List[Tuple[int, Requirements]] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    affinity_terms: List[PodAffinityTerm] = field(default_factory=list)
    node_name: Optional[str] = None  # binding
    phase: str = "Pending"
    priority: int = 0
    scheduling_gated: bool = False
    owner_kind: str = ""  # "DaemonSet" pods get special handling
    # PV zonal topology (website/.../concepts/scheduling.md:430+):
    # volume_claims names the pod's PVCs; volume_zones is the resolved zone
    # restriction from BOUND zonal PVs (maintained by
    # controllers/volume.VolumeTopologyController; None = unrestricted)
    volume_claims: List[str] = field(default_factory=list)
    volume_zones: Optional[Tuple[str, ...]] = None

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in _POD_SIG_FIELDS:
            d = self.__dict__
            dropped = False
            for k in _POD_CACHE_KEYS:
                if d.pop(k, None) is not None:
                    dropped = True
            if dropped:
                global _POD_MUTATION_EPOCH
                _POD_MUTATION_EPOCH += 1

    def invalidate_solver_cache(self) -> None:
        """Drop cached solver signature/sort keys. Field ASSIGNMENT does this
        automatically (__setattr__); call this after mutating a nested
        container in place (e.g. `pod.meta.labels[...] = ...`), which
        __setattr__ cannot observe."""
        d = self.__dict__
        dropped = False
        for k in _POD_CACHE_KEYS:
            if d.pop(k, None) is not None:
                dropped = True
        if dropped:
            global _POD_MUTATION_EPOCH
            _POD_MUTATION_EPOCH += 1

    def scheduling_requirements(self) -> Requirements:
        """nodeSelector + ALL required node-affinity terms folded into one
        conjunction. NOTE: OR'd terms folded this way over-constrain; the
        scheduler handles alternatives properly via
        `Scheduler._pod_requirement_alternatives`. This fold is only used
        where a single conservative conjunction is acceptable (daemonset
        matching)."""
        reqs = Requirements.from_labels(self.node_selector)
        for term in self.node_affinity:
            reqs = reqs.union(term)
        if self.volume_zones is not None:
            # an EMPTY tuple (conflicting bound volumes) is an unsatisfiable
            # In-[] requirement, not "unrestricted"
            reqs.add(Requirement.create(wk.ZONE_LABEL, IN, list(self.volume_zones)))
        return reqs

    @property
    def bound(self) -> bool:
        return self.node_name is not None

    def gang(self) -> Optional[Tuple[str, int, int]]:
        """(gang_id, size, min_ranks) from the gang labels, or None. A
        malformed size/min-ranks label (non-integer, < 1) voids the gang —
        the pod schedules as an ordinary singleton rather than wedging a
        whole gang on a typo. min_ranks defaults to size and is clamped to
        it (a gang can never need more placements than members)."""
        gid = self.meta.labels.get(wk.GANG_LABEL)
        if not gid:
            return None
        try:
            size = int(self.meta.labels.get(wk.GANG_SIZE_LABEL, ""))
        except ValueError:
            return None
        if size < 1:
            return None
        raw = self.meta.labels.get(wk.GANG_MIN_RANKS_LABEL)
        try:
            min_ranks = min(size, int(raw)) if raw is not None else size
        except ValueError:
            min_ranks = size
        if min_ranks < 1:
            return None
        return (gid, size, min_ranks)
