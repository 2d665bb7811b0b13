# Port copy of karpenter_tpu/solver/relax.py: relax_items, materialize_pod and plan,
# which TorchSolver's relax ladder and host relax loop (solver/backend.py) use.
"""Respect-mode preferences on the DEVICE path: relax-and-redispatch.

The oracle treats preferences as required, then relaxes a failing pod's
lowest-weight preference and retries that pod in place
(scheduler._schedule_with_relaxation; scheduling.md:212-219). Re-dispatching
the WHOLE solve from scratch with one more preference dropped replays the
oracle's decision sequence exactly — pods before the relaxed one place
identically, the relaxed pod retries under the same state — so the host
drives the relaxation loop while every iteration runs on device.
In the common production case (kube's default-on
ScheduleAnyway spreads that are satisfiable), zero pods fail and ONE
dispatch serves the solve — the class that previously forced every such
surge onto the interpreter-speed oracle.

Supported preference kinds (the others return None -> whole-solve oracle):
  - ScheduleAnyway topology spread (weight 0, relaxed first) — materializes
    to DoNotSchedule;
  - weighted POSITIVE pod affinity — materializes to a required term;
  - preferred NODE affinity — active terms union into the pod's required
    node-affinity term (exactly the oracle's
    _pod_requirement_alternatives base ∪ prefs), so they narrow the device
    solve like any node selector. Pods with OR'd alternatives are already
    fallback groups, so the union targets at most one term.
Weighted ANTI terms on the zone/ct axes materialize ADMISSION-ONLY
(encode kind 3): they block and commit like a required anti for the owning
pod, but never register as owned antis — the oracle's bookkeeping records
only the ORIGINAL pod, so satisfied preferences never constrain later
members — on every topology key (zone/ct via V kind 3, hostname via Q
kind 3: the allowance treats it as an anti while the e_co/c_co owner
registrations stay kind-1-gated).

Ordering: the materialized pods are re-encoded in the ORIGINAL pods'
canonical FFD order (SolverInput.presorted) — their mutated signatures
would otherwise regroup within equal-size blocks and diverge from the
oracle's fixed processing order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..api import wellknown as wk
from ..api.objects import Pod


def relax_items(pod: Pod) -> Optional[List[Tuple[int, int, str, int]]]:
    """Droppable preferences in the oracle's exact relaxation order
    ((weight, kind, idx) ascending — scheduler._schedule_with_relaxation).
    Returns None when the pod carries a preference kind the device loop
    cannot express."""
    items: List[Tuple[int, int, str, int]] = []
    for i, (w, _r) in enumerate(pod.preferred_node_affinity):
        items.append((w, 0, "na", i))
    for i, t in enumerate(pod.topology_spread):
        if t.when_unsatisfiable == "ScheduleAnyway":
            items.append((0, 1, "tsc", i))
    for i, t in enumerate(pod.affinity_terms):
        if t.weight is not None:
            if t.anti and t.topology_key not in (
                wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL, wk.HOSTNAME_LABEL
            ):
                return None  # custom-key weighted antis: oracle
            items.append((t.weight, 2, "aff", i))
    items.sort(key=lambda it: (it[0], it[1], it[3]))
    return items


def materialize_pod(pod: Pod, items, n_dropped: int) -> Pod:
    """Pod view with the still-active preferences REQUIRED and the dropped
    ones gone — mirrors scheduler._effective_pod."""
    active = items[n_dropped:]
    act_tsc = {i for (_w, _k, tag, i) in active if tag == "tsc"}
    act_aff = {i for (_w, _k, tag, i) in active if tag == "aff"}
    act_na = [i for (_w, _k, tag, i) in active if tag == "na"]
    tscs = []
    for i, t in enumerate(pod.topology_spread):
        if t.when_unsatisfiable == "DoNotSchedule":
            tscs.append(t)
        elif i in act_tsc:
            tscs.append(dataclasses.replace(t, when_unsatisfiable="DoNotSchedule"))
    affs = []
    for i, t in enumerate(pod.affinity_terms):
        if t.weight is None:
            affs.append(t)
        elif i in act_aff:
            # active weighted ANTI terms materialize ADMISSION-ONLY (encode
            # kind 3): they block this pod like a required anti but never
            # register — matching the oracle's original-pod bookkeeping
            affs.append(
                dataclasses.replace(t, weight=None, admission_only=t.anti)
            )
    node_aff = pod.node_affinity
    prefs = []
    if act_na:
        # active preferred node affinity unions into the required term —
        # the oracle's base ∪ prefs (dropped prefs vanish, preserving its
        # ascending-weight relaxation); the materialized pod carries NO
        # preferred terms so encode keeps it on device
        base = pod.preferred_node_affinity[act_na[0]][1]
        for i in act_na[1:]:
            base = base.union(pod.preferred_node_affinity[i][1])
        node_aff = (
            [term.union(base) for term in pod.node_affinity]
            if pod.node_affinity
            else [base]
        )
    return dataclasses.replace(
        pod,
        topology_spread=tscs,
        affinity_terms=affs,
        node_affinity=node_aff,
        preferred_node_affinity=prefs,
    )


def plan(qinp) -> Optional[Dict[str, list]]:
    """uid -> relax item list for every preference-carrying pod, or None
    when any pod carries an unsupported kind (or there is nothing to relax).
    An empty dict is never returned — callers take the plain path then."""
    if qinp.preference_policy == "Ignore":
        return None
    items_map: Dict[str, list] = {}
    for pod in qinp.pods:
        items = relax_items(pod)
        if items is None:
            return None
        if items:
            items_map[pod.meta.uid] = items
    return items_map or None
