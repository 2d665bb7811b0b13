# Port copy of karpenter_tpu/solver/resilient.py:108 check_invariants (the
# invariant gate only; the deadline, the circuit breaker and the fallback
# ladder are not ported yet).
"""The post-solve invariant gate.

`check_invariants` validates a result BEFORE it can reach the provisioner:
placements reference real nodes or claim slots, no node's free allocatable
is oversubscribed (including pod slots), every claim's `pod_uids` are
exactly the pods placed on it, and errors are disjoint from placements. The
convex backend (solver/convex.py) gates its rounded result with it and falls
back to the inner FFD solver on a violation.
"""

from __future__ import annotations

from typing import Dict, List

from ..utils.resources import PODS


def check_invariants(qinp, result) -> List[str]:
    """Validate a SolverResult against its (quantized) input. Returns a list
    of violation strings (empty = valid). Mirrors the scheduler's own
    commit-time rules so a correct backend always passes:

    - placements reference input nodes or in-range claim slots;
    - placement/error keys are schedulable input pods, and disjoint;
    - each claim's pod_uids are EXACTLY the pods placed on that slot;
    - no node's free allocatable is oversubscribed (any resource key, and
      one pod slot per pod — scheduler requires free[pods] >= 1 per add).
    """
    violations: List[str] = []
    pods_by_uid = {
        p.meta.uid: p
        for p in qinp.pods
        if not p.scheduling_gated and not p.bound
    }
    nodes = {n.id: n for n in qinp.nodes}
    n_claims = len(result.claims)

    placed_on_claim: Dict[int, set] = {}
    placed_on_node: Dict[str, list] = {}
    for uid, tgt in result.placements.items():
        if uid not in pods_by_uid:
            violations.append(f"placement for unknown/unschedulable pod {uid!r}")
            continue
        if not isinstance(tgt, tuple) or len(tgt) != 2:
            violations.append(f"malformed placement target {tgt!r} for {uid!r}")
        elif tgt[0] == "node":
            if tgt[1] not in nodes:
                violations.append(f"pod {uid!r} placed on phantom node {tgt[1]!r}")
            else:
                placed_on_node.setdefault(tgt[1], []).append(uid)
        elif tgt[0] == "claim":
            if not isinstance(tgt[1], int) or not (0 <= tgt[1] < n_claims):
                violations.append(
                    f"pod {uid!r} placed on out-of-range claim slot {tgt[1]!r} "
                    f"(claims={n_claims})"
                )
            else:
                placed_on_claim.setdefault(tgt[1], set()).add(uid)
        else:
            violations.append(f"unknown placement kind {tgt[0]!r} for {uid!r}")

    overlap = set(result.placements) & set(result.errors)
    if overlap:
        violations.append(
            f"{len(overlap)} pods both placed and errored (e.g. {sorted(overlap)[:3]})"
        )
    for uid in result.errors:
        if uid not in pods_by_uid:
            violations.append(f"error recorded for unknown pod {uid!r}")

    for i, claim in enumerate(result.claims):
        uids = list(claim.pod_uids)
        if len(set(uids)) != len(uids):
            violations.append(f"claim {i} lists duplicate pod uids")
        if set(uids) != placed_on_claim.get(i, set()):
            missing = placed_on_claim.get(i, set()) - set(uids)
            extra = set(uids) - placed_on_claim.get(i, set())
            violations.append(
                f"claim {i} pod_uids inconsistent with placements "
                f"(missing={sorted(missing)[:3]} extra={sorted(extra)[:3]})"
            )

    for node_id, uids in placed_on_node.items():
        free = nodes[node_id].free
        used: Dict[str, int] = {}
        for uid in uids:
            for k, v in pods_by_uid[uid].requests.items():
                if v > 0:
                    used[k] = used.get(k, 0) + v
        for k, v in used.items():
            if v > free.get_(k):
                violations.append(
                    f"node {node_id!r} oversubscribed on {k}: "
                    f"placed={v} free={free.get_(k)}"
                )
        if len(uids) > free.get_(PODS):
            violations.append(
                f"node {node_id!r} pod slots oversubscribed: "
                f"placed={len(uids)} free={free.get_(PODS)}"
            )
    return violations
