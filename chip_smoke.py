#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (karpenter_tpu_torch).

Runs the port's main path on one NVIDIA GPU and checks it:

1. prints the card's name and power limit, builds the CUDA kernels from
   karpenter_tpu_torch/csrc with nvcc (sm_90a, one process per source, all
   started together) and times the build;
2. holds each kernel (K1 in both instances: ffd_fast_scan, the fast branch,
   and ffd_zoned_scan, with the zoned event engine; K2 compact_takes; K3
   claim_meta; K6 below) against its plain PyTorch version on the card, at the shapes
   of the 50k-pod solves' own kernel arguments (the surge with and without
   nodes, BASELINE configs 3 and 4, and the mixed zone+ct input): exact
   equality (all outputs are integers), equal zoned event counts, a
   synchronize after each launch; then on small seeded fleets that reach
   the paths the 50k inputs do not (hostname constraints; the zoned
   branch's eventful path, anti registration and preemption bound; the
   fleet of ROADMAP §C.1). Phase 2e holds the sparse instances (K1s, K7s:
   ffd_scan_kernel<*, false, *, *, true>, built from
   csrc/ffd_sparse_kernels.cu) against their plain versions and the dense
   instances' outputs at the kernel arguments of config 3, mixed and the
   wide-constraint fleet (zoned), the surge with its all-padding index
   tables (fast, full width), small hostname and zone fleets, a hostname
   fleet the "auto" gate takes, and index rows rewritten as supersets; K7s
   resumes from its own ring and the dense K7's, K7 from K7s's; the dense
   output pack (pack_outputs) word for word against its plain version;
3. solves the surge, the surge with 200 existing nodes, config 3, config 4
   and the wide-constraint fleet through TorchSolver() REPEATS times each,
   and the mixed input MIXED_REPEATS times, with the launch counts reset
   just before and read just after; TorchSolver() must take the sparse
   scan on config 3, mixed and the wide-constraint fleet (every solve) and
   on no other cell; a sparse="off" solver beside it on those three cells
   and a device_decode=False solver (the dense output pack) on the surge
   and config 3 must decide the same; every kernel must have launched, and
   the decisions must equal the plain-version path's (the mixed input's
   through PlainOnCard); each solve's
   garbage-collection pauses are recorded beside its time;
4. forces the wide re-fetch (a tiny delta capacity) and checks the
   decisions do not change;
5. drives the relax path (Respect-mode preferences) through TorchSolver,
   with the launch counts reset just before and read just after: the
   config3_soft cell (config 3 with ScheduleAnyway spreads) SOFT_REPEATS
   times, whose decisions must equal config 3's in one sparse ladder
   dispatch (K6s zoned) each, and once through a sparse="off" solver; the
   surge_pref cell (every pod prefers zone-1b, the ladder scan's fast
   instance) and the relax walk (bench.py's ladder fleet at WALK_PODS pods,
   every pod after an app's first relaxes; 0 unplaced in one dispatch)
   once each; a small hostname-preference fleet through a sparse="on"
   solver (K6s fast); then the host relax loop at 120 pods, which must
   equal the ladder. K6 (the ladder scan, ffd_ladder_fast_scan and
   ffd_ladder_zoned_scan) and K6s are held against their plain versions in
   phase 2 at the cells' shapes, on a 400-pod relax walk and on 8 seeded
   fleets that mix every preference kind, through both instances.

6. arena and resume: the surge and config 3 each with 1 250 more replicas
   of their last run's pod (surge_tail, config3_tail) alternate with the
   cell itself through TorchSolver() (the arena, the checkpointed scan K7,
   suffix resume: TPUSolver()'s defaults), RESUME_SOLVES solves each, with
   the launch counts reset just before and read just after: every tail
   solve resumes from the ring of the base solve before it (the runs
   skipped as the ring's coverage predicts), a base solve after it runs
   cold, every decision equals a resume=False solver's and the plain
   path's, and a resumed solve uploads the stale run entry (one packed
   message) and the two suffix run arrays, and on config3_tail (resumed
   through K7s) the two suffix index arrays, nothing else. Before it (phase
   2d), K7 (ffd_ckpt_fast_scan at the surge with a snapshot every 16 and
   every 4 steps, ffd_ckpt_zoned_scan at config 3) is held against its plain
   version in every output, ring slot and prefix, against K1's outputs and
   through a resume from its ring; K8 (arena_unpack) against its plain
   version byte for byte on the cells' cold adopts, the config-5
   universe's, and seeded adversarial segment lists (odd-sized bools ahead
   of int32/uint32 entries, bool bytes 2..255). Phase 3 runs TorchSolver()
   at these defaults (its warm solves are zero-upload exact hits) and one
   arena=False solver (K1) on surge_e2e and config 3, held to the same
   decisions; it prints the transfer ledger.

7. scheduling classes and explain: bench.py's gang fleet at 2 000 nodes
   (class_contended: 16 000 evictable victims, a doomed gang, 1 000 gangs
   of 8, 6 000 singletons) through ClassAwareSolver(TorchSolver())
   CLASS_REPEATS times with explain off and CLASS_EXPLAIN_REPEATS with it
   on, class_zone once (every gang labelled for zone co-location: the
   relax ladder, preemption declines), and surge_e2e through TorchSolver()
   with explain on and off in turns, with the launch counts reset just
   before and read just after (K10 gang_commit, K11 preemption_plan, K12
   explain_pack must all launch); then the class solve's stage split, one
   solve with every K10/K11 call held against its plain version, and the
   decisions (evictions, gang verdicts, class_stats) against
   ClassAwareSolver(TorchSolver(device="cpu")): class_contended's, and
   class_zone's on the fleet cut to CLASS_ZONE_CHECK_GANGS gangs (solved
   on the card too). Before it (phase 2f) K10
   and K11 are held against their plain versions on seeded and
   adversarial tables (int32 wrap, no eligible victim or node, a free fit,
   gangs past NG, E = Vm = 1) and K11 at 10 000 nodes, and K12 at the
   outputs of surge_e2e, config 3 and class_contended's cold inner solve,
   at top_k 8 and above Ep; a record built from K12's wire must equal the
   host-derived one. class_zone runs at bench.py's 1 000 gangs (V > 1 000
   zone sigs in the zoned scan's launch-sized shared rows).

8. the convex backend: K13 (admm_pack, csrc/convex_kernels.cu) against its
   plain version on 20 seeded and 9 adversarial tables (padding rows, a row
   with no feasible column, zero cost, tol 10 and 0, max_iters 1, R = 1
   and 16) and K8 on float32 segments; then, with the launch counts reset
   just before and read just after, ConvexSolver(TorchSolver()) runs
   consolidate_global on config 5 at 10 000 nodes and 2 000 candidates
   (cold and warm: the proposal must equal the JAX package's, in one
   dispatch, and the warm adopt upload nothing), the quality suite
   (uniform 3/3 and rightsize 24/6 claims against TorchSolver(), the split
   consolidation deleting 3 in one dispatch) and convex_e2e (5 000 pods,
   200 nodes) CONVEX_E2E_REPEATS times with its stage split; then every
   K13 call of the same work is held against its plain version, config 5
   proposes the same through the plain version, and convex_e2e decides as
   ConvexSolver(TorchSolver(device="cpu")).

9. the serving pipeline: K15 (ffd_lanes_kernel, the lane-batched scan)
   against its plain version and against K1 on each lane, on the surge's
   kernel arguments stacked B = 1, 2 and 8 members deep (member i the surge
   at 50 000 + 3 (i % 3) pods) and config 3's (the zoned instance, B = 8);
   K16 (pad_lanes) byte for byte on a 5-member arena-adopted stack padded
   to 8; K14 (apply_events) on seeded tables (Sp 32 and 4 096, K 0, 8 and
   1 024 with out-of-range and pad rows) and on the surge's run-table edit.
   Then, with the launch counts reset just before and read just after:
   cohort_surge, 8 tenants' members in one fused dispatch through
   SolveService(TorchSolver()).submit_cohort and through solve_cohort_async
   directly, COHORT_DISPATCHES each, beside the same 8 solves submitted solo
   (through an arena of the default 4 buckets and one of 8; every fused dispatch carries all 8, the warm repeats upload nothing,
   decisions equal solo solves and the CPU plain path); cohort_config3
   (zoned lanes); cohort_pad (5 members pad to 8 lanes in a cold arena: the
   upload is exactly 5 members' bytes); surge_stream (stream_run_events:
   every solve after the first two stages through K14, decisions equal an
   unstaged solver's, the resident run tables equal the host encode).

Between 2 and 3, BASELINE config 5 (multi-node consolidation at 10 000
nodes and 2 000 candidates) runs through the port's
BatchedConsolidationEvaluator(TorchSolver()) as bench.py's bench_config5
drives it (config5_phase): the prefix search must find k >= 100 in <= 2
batched dispatches, equal to the sequential replay; K4 (the batched scan,
both instances) and K5 (the verdict pack) are held against their plain
versions, with rows that saturate the claim slots; the universe adopts into
the solver's arena, and a second prepare uploads nothing.

Usage: python3 chip_smoke.py   (no arguments; the sizes below are fixed)
The last line of stdout is {"ok": true, "device": {...}}; any failure
raises and exits non-zero. Without CUDA, or without the package beside
it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PODS = 50_000  # the headline surge
NODES = 200  # existing nodes of the e2e cell
REPEATS = 50  # timed solves per cell (their p99 is the slowest of 50)
DENSE_REPEATS = 10  # sparse="off" solves beside TorchSolver() on the sparse-gated cells
MIXED_REPEATS = 2  # the mixed input (~1.7 s a solve), through both solvers
SOFT_REPEATS = 10  # config3_soft (~1.3 s a solve)
MAX_CLAIMS = 1024  # TorchSolver's default claim-slot ceiling
WALK_PODS = 10_000  # the relax walk: every pod after an app's first relaxes

# H100 SXM published HBM3 bandwidth (NVIDIA data sheet). The integer-op
# ceiling is the card's int32 issue rate, 64 lanes per SM per clock (not
# FMA-doubled), computed from the SM count and the max SM clock it reports.
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def build_input(num_pods: int = 50_000):
    """The headline pending-pod surge: ~40 deployments of 1250 identical
    pods over 14 sizes and a few selectors, two pools over the full catalog
    (a copy of bench.py's build_input against the port's classes)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.catalog.catalog import generate
    from karpenter_tpu_torch.provisioning.scheduler import NodePoolSpec, SolverInput
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    catalog = generate()
    pools = [
        NodePoolSpec(
            name="general",
            weight=10,
            requirements=Requirements.of(
                Requirement.create(wk.NODEPOOL_LABEL, IN, ["general"])
            ),
            taints=[],
            instance_types=catalog,
        ),
        NodePoolSpec(
            name="spot",
            weight=50,
            requirements=Requirements.of(
                Requirement.create(wk.NODEPOOL_LABEL, IN, ["spot"]),
                Requirement.create(wk.CAPACITY_TYPE_LABEL, IN, ["spot"]),
            ),
            taints=[],
            instance_types=catalog,
        ),
    ]
    sizes = [
        ("100m", "128Mi"), ("250m", "256Mi"), ("250m", "512Mi"), ("500m", "512Mi"),
        ("500m", "1Gi"), ("1", "1Gi"), ("1", "2Gi"), ("2", "2Gi"), ("2", "4Gi"),
        ("4", "8Gi"), ("500m", "2Gi"), ("1500m", "3Gi"), ("3", "6Gi"), ("8", "16Gi"),
    ]
    selectors = [
        {},
        {},
        {},
        {wk.ARCH_LABEL: "arm64"},
        {},
        {wk.CAPACITY_TYPE_LABEL: "on-demand"},
        {},
        {wk.ZONE_LABEL: "zone-1b"},
    ]
    pods = []
    spec_id = 0
    for i in range(num_pods):
        spec = spec_id % (len(sizes) * 3)
        cpu, mem = sizes[spec % len(sizes)]
        sel = selectors[spec % len(selectors)]
        pods.append(
            Pod(
                meta=ObjectMeta(name=f"p{i:06d}", uid=f"p{i:06d}"),
                requests=Resources.parse({"cpu": cpu, "memory": mem}),
                node_selector=dict(sel),
            )
        )
        if i % 1250 == 1249:
            spec_id += 1
    return SolverInput(
        pods=pods, nodes=[], nodepools=pools, zones=("zone-1a", "zone-1b", "zone-1c")
    )


def with_tail(inp, n: int):
    """`inp` plus n more replicas of the pod that sorts last in FFD order
    (its smallest signature): only the last run's count changes, so a
    re-solve after `inp` may resume (the surge_tail and config3_tail
    cells)."""
    import copy
    import dataclasses

    from karpenter_tpu_torch.api.objects import _POD_CACHE_KEYS
    from karpenter_tpu_torch.provisioning.scheduler import ffd_sort

    last = ffd_sort(list(inp.pods))[-1]
    extra = []
    for i in range(n):
        q = copy.deepcopy(last)
        for k in _POD_CACHE_KEYS:
            q.__dict__.pop(k, None)
        q.meta = dataclasses.replace(last.meta, name=f"tail{i:06d}", uid=f"tail{i:06d}",
                                     labels=dict(last.meta.labels))
        extra.append(q)
    return dataclasses.replace(inp, pods=list(inp.pods) + extra)


def build_e2e_input(num_pods: int = 50_000, num_nodes: int = 200):
    """The same surge plus existing capacity (the existing-node pour path)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode
    from karpenter_tpu_torch.utils.resources import Resources

    inp = build_input(num_pods)
    nodes = []
    for j in range(num_nodes):
        free = Resources.parse({"cpu": "8", "memory": "32Gi"})
        free["pods"] = 110
        nodes.append(
            ExistingNode(
                id=f"node-{j:04d}",
                labels={
                    wk.ZONE_LABEL: f"zone-1{'abc'[j % 3]}",
                    wk.CAPACITY_TYPE_LABEL: "on-demand",
                    wk.HOSTNAME_LABEL: f"node-{j:04d}",
                    wk.ARCH_LABEL: "amd64",
                    wk.OS_LABEL: "linux",
                },
                taints=[],
                free=free,
            )
        )
    inp.nodes = nodes
    return inp


def build_config3_input(num_pods: int = 50_000):
    """BASELINE config 3: the surge with every deployment spreading across
    the 3 zones, maxSkew 1, self-matching (a copy of bench.py's
    build_config3_input)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import TopologySpreadConstraint

    inp = build_input(num_pods)
    for i, p in enumerate(inp.pods):
        app = f"app-{(i // 1250) % 40}"
        p.meta.labels["app"] = app
        p.topology_spread = [
            TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE_LABEL,
                                     label_selector={"app": app})
        ]
        p.node_selector = {}  # pure spread config
    return inp


def build_config3_soft_input(num_pods: int = 50_000):
    """Config 3 with every zone spread ScheduleAnyway (kube's default-on
    soft spreads), nothing else changed: the relax ladder's satisfiable
    case, whose decisions equal config 3's."""
    import dataclasses

    inp = build_config3_input(num_pods)
    for p in inp.pods:
        p.topology_spread = [dataclasses.replace(t, when_unsatisfiable="ScheduleAnyway")
                             for t in p.topology_spread]
    return inp


def build_relax_walk_input(num_pods: int = 50_000):
    """bench.py's relax-ladder fleet (_decode_relax_metrics part (b)): the
    surge with both pools pinned to zone-1a, pods labelled app-{i % 8},
    node selectors cleared and a ScheduleAnyway zone spread (maxSkew 1) per
    app, so every pod after an app's first relaxes its spread."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import TopologySpreadConstraint
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements

    inp = build_input(num_pods)
    for pl in inp.nodepools:
        pl.requirements = pl.requirements.union(
            Requirements.of(Requirement.create(wk.ZONE_LABEL, IN, ["zone-1a"]))
        )
    for i, p in enumerate(inp.pods):
        app = f"app-{i % 8}"
        p.meta.labels["app"] = app
        p.node_selector = {}
        p.topology_spread = [
            TopologySpreadConstraint(
                max_skew=1, topology_key=wk.ZONE_LABEL,
                label_selector={"app": app},
                when_unsatisfiable="ScheduleAnyway",
            )
        ]
    return inp


def build_surge_pref_input(num_pods: int = 50_000):
    """The surge with every pod preferring zone-1b (preferred node affinity,
    weight 50), which every deployment can honor: the relax ladder with no
    zone-axis sig (the ladder scan's fast instance)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements

    inp = build_input(num_pods)
    pref = Requirements.of(Requirement.create(wk.ZONE_LABEL, IN, ["zone-1b"]))
    for p in inp.pods:
        p.preferred_node_affinity = [(50, pref)]
    return inp


def build_relax_input(seed: int):
    """A small seeded fleet mixing the preference kinds the relax path
    serves, beside hard constraints, plain pods and existing nodes holding
    matching pods. Even seeds carry zone/capacity-type sigs (the ladder
    scan's zoned instance): ScheduleAnyway spreads on zone and capacity
    type, weighted positive zone affinity, weighted anti-affinity on zone,
    capacity type and hostname (admission-only kind-3 sigs), hard zone
    spreads. Odd seeds carry none (the main path's fast instance):
    ScheduleAnyway hostname spreads, weighted positive and anti hostname
    affinity (Q kinds 2 and 3), hard hostname anti-affinity. Both carry
    preferred node affinity (zone, arch). Seeds 2-3 and 6-7 give the pool
    one zone, so zone preferences relax rung by rung."""
    import random

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import (
        ObjectMeta, Pod, PodAffinityTerm, TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.catalog.catalog import generate
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode, NodePoolSpec, SolverInput
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    rng = random.Random(9000 + seed)
    zk, ck, hk = wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL, wk.HOSTNAME_LABEL
    pods = []

    def add(n, labels, cpu="500m", mem="1Gi", **kw):
        for _ in range(n):
            name = f"r{seed}-{len(pods):03d}"
            pods.append(Pod(meta=ObjectMeta(name=name, uid=name, labels=dict(labels)),
                            requests=Resources.parse({"cpu": cpu, "memory": mem}), **kw))

    def spread(sel, key, skew=1, when="ScheduleAnyway"):
        return TopologySpreadConstraint(max_skew=skew, topology_key=key, label_selector=dict(sel),
                                        when_unsatisfiable=when)

    def term(sel, key, anti, weight=None):
        return PodAffinityTerm(label_selector=dict(sel), topology_key=key, anti=anti, weight=weight)

    def prefer(weight, key, values):
        return (weight, Requirements.of(Requirement.create(key, IN, values)))

    if seed % 2 == 0:
        add(rng.randint(3, 10), {"app": "soft"}, topology_spread=[spread({"app": "soft"}, zk)])
        add(rng.randint(2, 6), {"tier": "ct"}, cpu="1",
            topology_spread=[spread({"tier": "ct"}, ck, rng.choice([1, 2]))])
        add(rng.randint(2, 6), {"svc": "db"}, affinity_terms=[term({"svc": "db"}, zk, False, 10)])
        add(rng.randint(2, 4), {"lock": "z"}, cpu="1",
            affinity_terms=[term({"lock": "z"}, zk, True, rng.choice([1, 7]))])
        add(rng.randint(2, 3), {"lock": "c"}, affinity_terms=[term({"lock": "c"}, ck, True, 4)])
        add(rng.randint(2, 8), {"app": "hard"},
            topology_spread=[spread({"app": "hard"}, zk, when="DoNotSchedule")])
    else:
        add(rng.randint(3, 10), {"app": "soft"}, cpu="2",
            topology_spread=[spread({"app": "soft"}, hk, rng.choice([1, 2]))])
        add(rng.randint(2, 6), {"app": "cache"}, cpu="250m",
            affinity_terms=[term({"app": "cache"}, hk, False, 5)])
        add(rng.randint(2, 5), {"app": "db"}, cpu="1", affinity_terms=[term({"app": "db"}, hk, True)])
    add(rng.randint(2, 4), {"lock": "h"}, cpu="250m",
        affinity_terms=[term({"lock": "h"}, hk, True, 3)])
    add(rng.randint(1, 4), {}, cpu="2", preferred_node_affinity=[
        prefer(10, zk, [rng.choice(["zone-1b", "zone-1c"])]), prefer(50, wk.ARCH_LABEL, ["arm64"])])
    add(rng.randint(1, 5), {}, cpu=rng.choice(["250m", "1", "3"]))
    nodes = []
    for j in range(rng.randint(0, 3)):
        free = Resources.parse({"cpu": str(rng.choice([2, 4, 8])), "memory": "16Gi"})
        free["pods"] = 20
        nodes.append(ExistingNode(
            id=f"n{j}", labels={zk: rng.choice(["zone-1a", "zone-1b", "zone-1c"]),
                                ck: "on-demand", hk: f"n{j}", wk.ARCH_LABEL: "amd64",
                                wk.OS_LABEL: "linux"},
            taints=[], free=free,
            pod_labels=[rng.choice([{"app": "soft"}, {"svc": "db"}, {"lock": "z"},
                                    {"app": "cache"}])]))
    extra = [Requirement.create(zk, IN, ["zone-1a"])] if seed % 4 >= 2 else []
    pool = NodePoolSpec(
        name="default", weight=0,
        requirements=Requirements.of(Requirement.create(wk.NODEPOOL_LABEL, IN, ["default"]), *extra),
        taints=[], instance_types=generate())
    return SolverInput(pods=pods, nodes=nodes, nodepools=[pool],
                       zones=("zone-1a", "zone-1b", "zone-1c"))


def build_config4_input(num_pods: int = 50_000):
    """BASELINE config 4: a third of the pods follow svc=web into one zone
    (positive zone affinity); 6 anti singletons spread one per zone; the
    rest are plain (a copy of bench.py's build_config4_input)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import PodAffinityTerm

    inp = build_input(num_pods)
    for i, p in enumerate(inp.pods):
        p.node_selector = {}
        if i % 3 == 0:
            p.meta.labels["svc"] = "web"
            p.affinity_terms = [PodAffinityTerm(label_selector={"svc": "web"},
                                                topology_key=wk.ZONE_LABEL, anti=False)]
        elif i < 9:
            p.meta.labels["svc"] = f"lock-{i}"
            p.affinity_terms = [PodAffinityTerm(label_selector={"svc": f"lock-{i}"},
                                                topology_key=wk.ZONE_LABEL, anti=True)]
    return inp


def build_mixed_input(num_pods: int = 50_000):
    """Config 3 with 2% of the pods spreading over capacity type instead:
    zone and capacity-type domain columns in one solve (a copy of bench.py's
    build_mixed_input)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import TopologySpreadConstraint

    inp = build_config3_input(num_pods)
    for i, p in enumerate(inp.pods):
        if i % 50 == 0:
            app = f"ct-{(i // 1250) % 40}"
            p.meta.labels = {"tier": app}
            p.topology_spread = [
                TopologySpreadConstraint(max_skew=1, topology_key=wk.CAPACITY_TYPE_LABEL,
                                         label_selector={"tier": app})
            ]
    return inp


def build_constraint_wide_input(num_pods: int = 4_800, pods_per_app: int = 40):
    """The wide-constraint fleet: one zone-spread sig per `pods_per_app`
    pods, so V grows with the fleet (120 sigs at the default) while each
    run touches exactly one: fleets of many small deployments, each
    spreading over the zones (a copy of bench.py's
    build_constraint_wide_input)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import TopologySpreadConstraint

    inp = build_input(num_pods)
    for i, p in enumerate(inp.pods):
        app = f"wide-{i // pods_per_app}"
        p.meta.labels["app"] = app
        p.topology_spread = [
            TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE_LABEL,
                                     label_selector={"app": app})
        ]
        p.node_selector = {}
    return inp


def build_constrained_input(seed: int):
    """A small randomized fleet that reaches the scan paths the surge does
    not: hostname spread (Q kind 0), hostname anti-affinity (kind 1),
    positive hostname affinity with and without the bootstrap (kind 2),
    existing nodes holding member pods, weighted pools with limits, a
    tainted pool, selectors."""
    import random

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import (
        ObjectMeta, Pod, PodAffinityTerm, Taint, Toleration, TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.catalog.catalog import generate
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode, NodePoolSpec, SolverInput
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    rng = random.Random(seed)
    host = wk.HOSTNAME_LABEL
    taint = Taint(key="gpu", value="true", effect=wk.EFFECT_NO_SCHEDULE)
    pods = []

    def add(n, cpu, mem, labels=None, **kw):
        for _ in range(n):
            name = f"s{seed}-{len(pods):03d}"
            pods.append(Pod(meta=ObjectMeta(name=name, uid=name, labels=dict(labels or {})),
                            requests=Resources.parse({"cpu": cpu, "memory": mem}), **kw))

    add(rng.randint(3, 9), "200m", "256Mi", {"app": "web"}, topology_spread=[
        TopologySpreadConstraint(max_skew=rng.choice([1, 2]), topology_key=host,
                                 label_selector={"app": "web"})])
    add(rng.randint(2, 5), "250m", "512Mi", {"app": "db"},
        affinity_terms=[PodAffinityTerm(label_selector={"app": "db"}, topology_key=host, anti=True)])
    add(rng.randint(2, 7), "400m", "256Mi", {"app": "cache"},
        affinity_terms=[PodAffinityTerm(label_selector={"app": "cache"}, topology_key=host)])
    for _ in range(rng.randint(3, 8)):
        kw = {}
        if rng.random() < 0.3:
            kw["node_selector"] = {wk.ARCH_LABEL: rng.choice(["amd64", "arm64"])}
        elif rng.random() < 0.3:
            kw["tolerations"] = [Toleration(key="gpu", value="true", effect=wk.EFFECT_NO_SCHEDULE)]
        add(rng.randint(1, 6), f"{rng.choice([100, 500, 1000, 3000])}m",
            f"{rng.choice([128, 1024, 4096])}Mi", **kw)
    nodes = []
    for j in range(rng.randint(0, 4)):
        free = Resources.parse({"cpu": str(rng.choice([1, 2, 4])), "memory": "16Gi"})
        free["pods"] = 20
        nodes.append(ExistingNode(
            id=f"n{j}", labels={wk.ZONE_LABEL: "zone-1a", wk.CAPACITY_TYPE_LABEL: "on-demand",
                                host: f"n{j}", wk.ARCH_LABEL: "amd64", wk.OS_LABEL: "linux"},
            taints=[], free=free,
            pod_labels=[{"app": rng.choice(["web", "cache", "other"])}]))
    catalog = generate()

    def pool(name, weight, *reqs, taints=(), limits=None):
        return NodePoolSpec(
            name=name, weight=weight,
            requirements=Requirements.of(Requirement.create(wk.NODEPOOL_LABEL, IN, [name]), *reqs),
            taints=list(taints), instance_types=catalog,
            limits=Resources.parse(limits or {}))

    pools = [
        pool("small", 5, Requirement.create(wk.INSTANCE_TYPE_LABEL, IN, ["m5.large", "m5.xlarge"]),
             limits={"cpu": str(rng.choice([4, 8, 16]))}),
        pool("any", 1),
        pool("tainted", 9, taints=[taint]),
    ]
    return SolverInput(pods=pods, nodes=nodes, nodepools=pools,
                       zones=("zone-1a", "zone-1b", "zone-1c"))


def build_zone_input(seed: int):
    """A small randomized fleet for the zoned branch's paths that the 50k
    inputs do not reach: zone spread with maxSkew 1 or 2 over existing nodes
    that hold member pods (the first-fit preemption bound), a spread whose
    selector does not match its own pods (eventful, no closed form),
    positive zone affinity, a zone anti-affinity owner and the pods its
    selector matches (anti registration), self-anti singletons, a pool
    with limits, and on odd seeds capacity-type spread and anti locks (the
    mixed zone+ct layout)."""
    import random

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import (
        ObjectMeta, Pod, PodAffinityTerm, TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.catalog.catalog import generate
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode, NodePoolSpec, SolverInput
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    rng = random.Random(seed)
    zk, ck = wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL
    pods = []

    def add(n, cpu, mem, labels, tsc=(), aff=()):
        for _ in range(n):
            name = f"z{seed}-{len(pods):03d}"
            pods.append(Pod(
                meta=ObjectMeta(name=name, uid=name, labels=dict(labels)),
                requests=Resources.parse({"cpu": cpu, "memory": mem}),
                topology_spread=[TopologySpreadConstraint(max_skew=k, topology_key=key,
                                                          label_selector=dict(sel))
                                 for k, key, sel in tsc],
                affinity_terms=[PodAffinityTerm(label_selector=dict(sel), topology_key=key, anti=anti)
                                for sel, key, anti in aff]))

    add(rng.randint(6, 30), "500m", "1Gi", {"app": "w"}, tsc=[(rng.choice([1, 2]), zk, {"app": "w"})])
    add(rng.randint(3, 12), "1", "2Gi", {"app": "x"}, tsc=[(1, zk, {"app": "w"})])
    add(rng.randint(3, 20), "250m", "512Mi", {"svc": "db"}, aff=[({"svc": "db"}, zk, False)])
    add(1, "2", "4Gi", {"o": "1"}, aff=[({"tier": "fe"}, zk, True)])
    add(rng.randint(2, 6), "1", "1Gi", {"tier": "fe"})
    add(rng.randint(2, 4), "1", "2Gi", {"lock": "z"}, aff=[({"lock": "z"}, zk, True)])
    if seed % 2:
        add(rng.randint(4, 12), "500m", "1Gi", {"tier": "ct"}, tsc=[(1, ck, {"tier": "ct"})])
        add(rng.randint(2, 3), "1", "1Gi", {"clock": "c"}, aff=[({"clock": "c"}, ck, True)])
    add(rng.randint(2, 8), f"{rng.choice([100, 500, 2000])}m", "1Gi", {})
    nodes = []
    for j in range(rng.randint(1, 4)):
        free = Resources.parse({"cpu": str(rng.choice([2, 4, 8])), "memory": "16Gi"})
        free["pods"] = 20
        nodes.append(ExistingNode(
            id=f"n{j}", labels={zk: rng.choice(["zone-1a", "zone-1b", "zone-1c"]),
                                ck: rng.choice(["on-demand", "spot"]),
                                wk.HOSTNAME_LABEL: f"n{j}", wk.ARCH_LABEL: "amd64",
                                wk.OS_LABEL: "linux"},
            taints=[], free=free, pod_labels=[{"app": "w"}] * rng.randint(0, 3)))
    catalog = generate()

    def pool(name, weight, limits=None):
        return NodePoolSpec(
            name=name, weight=weight,
            requirements=Requirements.of(Requirement.create(wk.NODEPOOL_LABEL, IN, [name])),
            taints=[], instance_types=catalog, limits=Resources.parse(limits or {}))

    return SolverInput(pods=pods, nodes=nodes,
                       nodepools=[pool("limited", 10, {"cpu": str(rng.choice([8, 16]))}), pool("any", 1)],
                       zones=("zone-1a", "zone-1b", "zone-1c"))


def build_zone_fuzz_53_input():
    """The smallest fleet on which the reference's zoned scan diverges from
    its own oracle (ROADMAP §C.1; the port copies the reference): the
    zone-fuzz draw of seed 53 (zone spreads on app=w, zone affinity on
    svc=db, capacity-type spreads on tier=ct, one existing node holding two
    tier=ct pods) without its draws 2, 9, 12, 19 and 21: 17 one-CPU pods.
    tests/test_torch_isolation.py pins it to the tests' own fleet."""
    import random

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import (
        ObjectMeta, Pod, PodAffinityTerm, TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.catalog.catalog import CatalogSpec, generate
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode, NodePoolSpec, SolverInput
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    zones, cts = ("zone-1a", "zone-1b", "zone-1c"), ("on-demand", "spot")
    zk, ck = wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL
    rng = random.Random(3000 + 53)
    drop = {2, 9, 12, 19, 21}
    pods = []

    def add(i, name, labels, cpu="1", tsc=(), aff=()):
        if i in drop:
            return
        pods.append(Pod(
            meta=ObjectMeta(name=name, uid=name, labels=dict(labels)),
            requests=Resources.parse({"cpu": cpu, "memory": "1Gi"}),
            topology_spread=[TopologySpreadConstraint(max_skew=k, topology_key=key,
                                                      label_selector=dict(sel))
                             for k, key, sel in tsc],
            affinity_terms=[PodAffinityTerm(label_selector=dict(sel), topology_key=key, anti=anti)
                            for sel, key, anti in aff]))

    for i in range(rng.randrange(8, 26)):
        k, name = rng.random(), f"p{i:03d}"
        if k < 0.35:
            add(i, name + "000", {"app": "w"}, tsc=[(1, zk, {"app": "w"})])
        elif k < 0.6:
            add(i, name + "000", {"tier": "ct"}, tsc=[(rng.choice([1, 2]), ck, {"tier": "ct"})])
        elif k < 0.75:
            add(i, name + "000", {"svc": "db"}, aff=[({"svc": "db"}, zk, False)])
        elif k < 0.85:
            lock = {"lock": f"k{i % 3}"}
            add(i, name + "000", lock, aff=[(lock, ck, True)])
        else:
            add(i, name, {}, cpu=rng.choice(["500m", "1", "2"]))
    nodes = []
    for j in range(rng.randrange(0, 5)):
        zone, ct = rng.choice(zones), rng.choice(cts)
        labels = [rng.choice([{"app": "w"}, {"tier": "ct"}])] * rng.randrange(0, 3)
        free = Resources.parse({"cpu": "8", "memory": "32Gi"})
        free["pods"] = 110
        nodes.append(ExistingNode(
            id=f"n{j}", labels={zk: zone, ck: ct, wk.ARCH_LABEL: "amd64", wk.OS_LABEL: "linux",
                                wk.HOSTNAME_LABEL: f"n{j}"},
            taints=[], free=free, pod_labels=[dict(x) for x in labels]))
    pool = NodePoolSpec(
        name="default", weight=0,
        requirements=Requirements.of(Requirement.create(wk.NODEPOOL_LABEL, IN, ["default"])),
        taints=[], instance_types=generate(CatalogSpec()), limits=Resources.parse({}))
    return SolverInput(pods=pods, nodes=nodes, nodepools=[pool], zones=zones)


def build_hostname_wide_input(apps: int = 9, replicas: int = 3):
    """A small fleet whose hostname axis is wide enough for the sparse
    gate: `apps` hostname anti-affinity deployments (one sig each, Q = apps
    >= 8) and filler pods, no zone-axis sig: TorchSolver()'s default
    ("auto") takes the sparse scan's fast instance on it."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod, PodAffinityTerm
    from karpenter_tpu_torch.utils.resources import Resources

    inp = build_input(24)
    pods = list(inp.pods)
    for a in range(apps):
        sel = {"app": f"h{a}"}
        for j in range(replicas):
            name = f"h{a}-{j}"
            pods.append(Pod(
                meta=ObjectMeta(name=name, uid=name, labels=dict(sel)),
                requests=Resources.parse({"cpu": "500m", "memory": "512Mi"}),
                affinity_terms=[PodAffinityTerm(label_selector=dict(sel),
                                                topology_key=wk.HOSTNAME_LABEL, anti=True)]))
    import dataclasses

    return dataclasses.replace(inp, pods=pods)


def build_config5_universe(n_nodes: int = 10_000, n_candidates: int = 2_000):
    """BASELINE config 5: multi-node consolidation at 10k nodes (a copy of
    bench.py's build_config5_universe against the port's classes).

    Fleet: `n_candidates` underutilized nodes (one small pod each, the
    disruption candidates, cost-ordered first) + absorbers with exactly
    one pod worth of free capacity + fully-loaded nodes. The largest
    consolidatable prefix sits strictly inside [2, n_candidates] (absorber
    capacity + the <=1-replacement rule bound it), so the prefix search
    has a real boundary to find."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode
    from karpenter_tpu_torch.utils.resources import Resources

    inp = build_input(0)  # pools + catalog only
    n_absorbers = 1500
    nodes = []

    def mknode(j, kind, free_cpu, free_mem, pods_free):
        free = Resources.parse({"cpu": free_cpu, "memory": free_mem})
        free["pods"] = pods_free
        return ExistingNode(
            id=f"{kind}-{j:05d}",
            labels={
                wk.ZONE_LABEL: f"zone-1{'abc'[j % 3]}",
                wk.CAPACITY_TYPE_LABEL: "on-demand",
                wk.HOSTNAME_LABEL: f"{kind}-{j:05d}",
                wk.ARCH_LABEL: "amd64",
                wk.OS_LABEL: "linux",
            },
            taints=[],
            free=free,
        )

    candidate_pods = {}
    candidate_node = {}
    sizes = [("500m", "512Mi"), ("500m", "1Gi"), ("250m", "512Mi"), ("750m", "768Mi")]
    for j in range(n_candidates):
        nodes.append(mknode(j, "cand", "7", "30Gi", 100))
        cpu, mem = sizes[j % len(sizes)]
        candidate_pods[j] = [
            Pod(
                meta=ObjectMeta(name=f"cp{j:05d}", uid=f"cp{j:05d}"),
                requests=Resources.parse({"cpu": cpu, "memory": mem}),
            )
        ]
        candidate_node[j] = f"cand-{j:05d}"
    for j in range(n_absorbers):
        nodes.append(mknode(j, "abs", "800m", "1Gi", 1))
    for j in range(n_nodes - n_candidates - n_absorbers):
        free = Resources.parse({"cpu": "0", "memory": "0"})
        free["pods"] = 0
        nodes.append(
            ExistingNode(
                id=f"full-{j:05d}",
                labels={
                    wk.ZONE_LABEL: f"zone-1{'abc'[j % 3]}",
                    wk.CAPACITY_TYPE_LABEL: "on-demand",
                    wk.HOSTNAME_LABEL: f"full-{j:05d}",
                    wk.ARCH_LABEL: "amd64",
                    wk.OS_LABEL: "linux",
                },
                taints=[],
                free=free,
            )
        )
    inp.nodes = nodes
    return inp, candidate_pods, candidate_node


def build_config5_consolidation(n_nodes: int = 10_000, n_candidates: int = 2_000):
    """BASELINE config 5 as the convex backend's one-shot global pass takes
    it (ConvexSolver.consolidate_global): build_config5_universe with every
    candidate's pod pending and every node still present, and the
    candidate list [(cand-j, 1.0, {cpj})] in cost order."""
    import dataclasses

    inp, cand_pods, cand_node = build_config5_universe(n_nodes, n_candidates)
    pods = [p for j in range(n_candidates) for p in cand_pods[j]]
    cands = [(cand_node[j], 1.0, frozenset(p.meta.uid for p in cand_pods[j]))
             for j in range(n_candidates)]
    return dataclasses.replace(inp, pods=pods), cands


# ---- the quality scenarios (copies of tools/explain_diff.py's fixtures) --------

_SCENARIO_ZONES = ("zone-1a", "zone-1b")


def _mktype(name: str, cpu: int, mem_gib: int, price: float):
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    reqs = Requirements.of(
        Requirement.create(wk.INSTANCE_TYPE_LABEL, IN, [name]),
        Requirement.create(wk.ARCH_LABEL, IN, ["amd64"]),
        Requirement.create(wk.OS_LABEL, IN, ["linux"]),
        Requirement.create(wk.ZONE_LABEL, IN, list(_SCENARIO_ZONES)),
        Requirement.create(wk.CAPACITY_TYPE_LABEL, IN, ["on-demand"]),
    )
    cap = Resources.parse({"cpu": str(cpu), "memory": f"{mem_gib}Gi"})
    cap["pods"] = 110
    return InstanceType(
        name=name, requirements=reqs, capacity=cap, overhead=Resources(),
        offerings=[Offering(zone=z, capacity_type="on-demand", price=price)
                   for z in _SCENARIO_ZONES],
    )


def _pool(name: str, weight: int, types: list):
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.provisioning.scheduler import NodePoolSpec
    from karpenter_tpu_torch.scheduling.requirements import IN, Requirement, Requirements
    from karpenter_tpu_torch.utils.resources import Resources

    r = Requirements.of(Requirement.create(wk.NODEPOOL_LABEL, IN, [name]))
    return NodePoolSpec(name=name, weight=weight, requirements=r, taints=[],
                        instance_types=types, limits=Resources())


def _mkpod(name: str, cpu: str, mem: str):
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.utils.resources import Resources

    return Pod(meta=ObjectMeta(name=name, uid=name),
               requests=Resources.parse({"cpu": cpu, "memory": mem}))


def _mknode(name: str, cpu: str, mem: str, zone: str = "zone-1a"):
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.provisioning.scheduler import ExistingNode
    from karpenter_tpu_torch.utils.resources import Resources

    lab = {wk.ZONE_LABEL: zone, wk.HOSTNAME_LABEL: name,
           wk.CAPACITY_TYPE_LABEL: "on-demand", wk.ARCH_LABEL: "amd64",
           wk.OS_LABEL: "linux"}
    free = Resources.parse({"cpu": cpu, "memory": mem})
    free["pods"] = 110
    return ExistingNode(id=name, labels=lab, taints=[], free=free)


def build_scenario(name: str):
    """tools/explain_diff.py's three canned shapes (the quality suite's):
    uniform (one pool, one 4-cpu shape, 12 x 1cpu pods: 3 claims for
    either backend), rightsize (pool weight against price: FFD opens 24
    4-cpu nodes, the convex objective 6 16-cpu ones), split (two half-full
    8-cpu nodes plus 8 x 3cpu pods: existing capacity fills first)."""
    from karpenter_tpu_torch.provisioning.scheduler import SolverInput

    if name == "uniform":
        pods = [_mkpod(f"u{i:02d}", "1", "1Gi") for i in range(12)]
        pools = [_pool("general", 0, [_mktype("std.xlarge", 4, 16, 1.0)])]
        return SolverInput(pods=pods, nodes=[], nodepools=pools,
                           zones=_SCENARIO_ZONES, capacity_types=("on-demand",))
    if name == "rightsize":
        pods = [_mkpod(f"w{i:03d}", "1", "1Gi") for i in range(96)]
        pools = [
            _pool("boutique", 100, [_mktype("boutique.xlarge", 4, 16, 1.0)]),
            _pool("warehouse", 0, [_mktype("warehouse.4xlarge", 16, 64, 0.9)]),
        ]
        return SolverInput(pods=pods, nodes=[], nodepools=pools,
                           zones=_SCENARIO_ZONES, capacity_types=("on-demand",))
    if name == "split":
        pods = [_mkpod(f"q{i:02d}", "3", "4Gi") for i in range(8)]
        nodes = [_mknode("n1", "8", "32Gi"),
                 _mknode("n2", "8", "32Gi", zone="zone-1b")]
        pools = [_pool("general", 0, [_mktype("std.4xlarge", 16, 64, 0.9)])]
        return SolverInput(pods=pods, nodes=nodes, nodepools=pools,
                           zones=_SCENARIO_ZONES, capacity_types=("on-demand",))
    raise ValueError(f"unknown scenario {name!r}")


def build_split_consolidation():
    """bench.py _quality_run's one-shot consolidation: three near-empty
    8-cpu candidates (two 1-cpu pods each, priced 0.5) and a 16-cpu
    survivor with room for all six, under the split scenario's pool."""
    from karpenter_tpu_torch.provisioning.scheduler import SolverInput

    base = build_scenario("split")
    nodes = [_mknode(f"c{j}", "8", "32Gi") for j in range(1, 4)]
    nodes.append(_mknode("surv", "16", "64Gi"))
    pods = [_mkpod(f"m{j}{k}", "1", "1Gi") for j in range(3) for k in range(2)]
    inp = SolverInput(pods=pods, nodes=nodes, nodepools=base.nodepools,
                      zones=base.zones, capacity_types=("on-demand",))
    cands = [(f"c{j}", 0.5, frozenset({f"m{j - 1}{k}" for k in range(2)}))
             for j in range(1, 4)]
    return inp, cands


def build_class_input(n_nodes: int = 8, victims_per_node: int = 4, n_high: int = 24,
                      n_gangs: int = 8, gang_size: int = 4, topology=None):
    """Mixed-priority + gang fleet with preemption contention (a copy of
    bench.py's _gang_input against the port's classes), existing nodes only
    (no node pools): low-priority victims hold most of the capacity, a
    high-priority singleton surge must preempt to land, and the gang wave
    oversubscribes what's left. `topology` (e.g. the zone label) labels
    every gang with GANG_TOPOLOGY_LABEL (the class_zone cell; None = the
    original)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.provisioning.scheduler import BoundPodRef, ExistingNode, SolverInput
    from karpenter_tpu_torch.utils.resources import PODS, Resources

    nodes = []
    for e in range(n_nodes):
        victims = [
            BoundPodRef(
                uid=f"victim-{e}-{v}", priority=0,
                requests=Resources.parse({"cpu": "1", "memory": "1Gi"}),
            )
            for v in range(victims_per_node)
        ]
        free = Resources.parse({"cpu": "2", "memory": "4Gi"})
        free[PODS] = 100
        nodes.append(ExistingNode(
            id=f"node-{e}",
            labels={wk.ZONE_LABEL: f"zone-{e % 2}",
                    wk.HOSTNAME_LABEL: f"node-{e}"},
            taints=[], free=free, bound_pods=victims,
        ))
    extra = {} if topology is None else {wk.GANG_TOPOLOGY_LABEL: topology}
    pods = []
    # one doomed gang above everything: 8-cpu members no node can host, so
    # every solve exercises the verdict -> rollback -> re-solve round
    for r in range(gang_size):
        pods.append(Pod(
            meta=ObjectMeta(
                name=f"doomed-{r}", uid=f"doomed-{r}",
                labels={wk.GANG_LABEL: "job-doomed",
                        wk.GANG_SIZE_LABEL: str(gang_size), **extra},
            ),
            requests=Resources.parse({"cpu": "8", "memory": "1Gi"}),
            priority=200,
        ))
    # gang wave lands first (highest surviving priority), fits in free
    for g in range(n_gangs):
        for r in range(gang_size):
            pods.append(Pod(
                meta=ObjectMeta(
                    name=f"gang{g}-{r}", uid=f"gang{g}-{r}",
                    labels={wk.GANG_LABEL: f"job-{g:02d}",
                            wk.GANG_SIZE_LABEL: str(gang_size), **extra},
                ),
                requests=Resources.parse({"cpu": "250m", "memory": "256Mi"}),
                priority=150,
            ))
    # singleton surge below the gangs: overflows the remaining free capacity,
    # so the tail must preempt the priority-0 victims to plan a landing
    for i in range(n_high):
        pods.append(Pod(
            meta=ObjectMeta(name=f"hi-{i:03d}", uid=f"hi-{i:03d}"),
            requests=Resources.parse({"cpu": "1", "memory": "1Gi"}),
            priority=100,
        ))
    return SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=("zone-0", "zone-1"))


def _accept_consolidation(k, v, cand_price=1.0):
    """The controller's acceptance rule: feasible AND (no replacement, or the
    replacement is strictly cheaper than the k nodes it consolidates)
    (a copy of bench.py's)."""
    if not v.ok:
        return False
    if v.has_replacement and (
        v.replacement_price is None or v.replacement_price >= k * cand_price
    ):
        return False
    return True


def _prefix_search(ev, prep, n_candidates, cand_price=1.0):
    """The controller's consolidation-prefix search through the port's copy
    of speculative_binary_search, with the same acceptance rule (a copy of
    bench.py's). Returns (k_best, dispatches, prefixes_evaluated,
    seq_probes) where seq_probes is the round-trip count a sequential binary
    search would have issued for the IDENTICAL decision (replayed host-side
    from the probed verdicts)."""
    from karpenter_tpu_torch.disruption.batched import speculative_binary_search

    best, probed, dispatches = speculative_binary_search(
        lambda ks: ev.evaluate_prepared(prep, [list(range(kk)) for kk in ks]),
        2,
        n_candidates,
        lambda k, v: _accept_consolidation(k, v, cand_price),
    )
    # sequential replay over the same verdicts: every mid it consults was
    # probed (the speculative search replays the identical decisions), so
    # this counts the device round-trips batching collapsed
    lo, hi, seq_probes, seq_best = 2, n_candidates, 0, None
    while lo <= hi:
        mid = (lo + hi) // 2
        seq_probes += 1
        if _accept_consolidation(mid, probed[mid], cand_price):
            seq_best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    assert seq_best == best, "speculative search diverged from sequential replay"
    return (best or 1), dispatches, len(probed), seq_probes


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """Peak int32 ops/s: 64 lanes × SMs × the card's max SM clock."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def time_ms(fn, n: int) -> float:
    """Mean ms per call over n calls, CUDA events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_abs_err(a, b) -> int:
    """Max |a - b| over matching tensors (bools as 0/1), b moved to a's
    device; shapes must agree."""
    import torch

    worst = 0
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(y.shape), (x.shape, y.shape)
        if x.numel():
            d = (x.to(torch.int64) - y.to(x.device, torch.int64)).abs().max().item()
            worst = max(worst, int(d))
    return worst


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def bound(bytes_moved: int, ops: int, ops_per_s: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(inp, dev):
    """K1-K3 against their plain versions at the shapes of `inp`'s solve:
    K1's zoned instance when the input has V-axis sigs (as the main path
    picks it), its fast instance otherwise; the claim bucket doubles on
    saturation as the main path's does."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.convert import args_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    enc = encode(quantize_input(inp))
    host_args, dims, _ = tb.host_kernel_args(enc, tb.TorchSolver._bucket)
    args = args_to_torch(host_args, dev)
    total = int(sum(len(p) for p in enc.group_pods))
    zone = enc.V > 0
    M = tb.initial_claim_bucket(total, MAX_CLAIMS)
    while True:
        out = ffd.ffd_solve(*args, max_claims=M, zone_engine=zone)
        torch.cuda.synchronize()
        if int(out.state.used) < M or M >= MAX_CLAIMS:
            break
        M = min(2 * M, MAX_CLAIMS)
    t0 = time.perf_counter()
    plain = ffd.ffd_solve_plain(*args, max_claims=M, zone_engine=zone)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    k1 = [out.take_e, out.take_c, out.leftover, out.events, *out.state]
    p1 = [plain.take_e, plain.take_c, plain.leftover, plain.events, *plain.state]
    err1 = max_abs_err(k1, p1)
    name = "ffd_zoned_scan" if zone else "ffd_fast_scan"
    assert err1 == 0, f"{name} disagrees with its plain version (max |d| {err1})"
    assert int(out.events) == int(plain.events), (int(out.events), int(plain.events))

    Sp, Ep = out.take_e.shape
    cap = tb.delta_capacity(total, Sp, Ep, M)
    cap_u = tb.delta_uniq_capacity(Sp, M)
    k2 = ffd.compact_takes(out.take_e, out.take_c, cap)
    torch.cuda.synchronize()
    p2 = ffd.compact_takes_plain(out.take_e, out.take_c, cap)
    err2 = max_abs_err(k2, p2)
    assert err2 == 0, f"compact_takes disagrees with its plain version (max |d| {err2})"
    st = out.state
    k3 = ffd.compact_claim_meta(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u)
    torch.cuda.synchronize()
    p3 = ffd.compact_claim_meta_plain(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u)
    err3 = max_abs_err(k3, p3)
    assert err3 == 0, f"claim_meta disagrees with its plain version (max |d| {err3})"
    return dict(enc=enc, args=args, host_args=host_args, out=out, M=M, cap=cap, cap_u=cap_u,
                dims=dims, zone=zone,
                errs=(err1, err2, err3), n_entries=int(k2[1]), n_uniq=int(k3[1]),
                events=int(out.events), plain_once_s=plain_s)


def profiled_ms(fn, n: int, names, tries: int = 3):
    """Device time per call (ms) of the named kernels (each launched once
    per call), from torch.profiler traces of one call each: a trace that
    misses any of them is discarded; the mean over the first n whole traces
    of at most n * tries, or None (not measured) when none is whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    whole = []
    for _ in range(n * tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        hits = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and any(k in e.name for k in names)]
        if len(hits) == len(names):
            whole.append(sum(hits))
            if len(whole) == n:
                break
    return sum(whole) / len(whole) / 1e3 if whole else None


def scan_cost(ph):
    """K1's floor on work and traffic for `ph`'s solve: inputs read once and
    outputs written once; integer ops of this run's data: (sub, floor-div,
    min) per resource over every node row, every claim open before the run
    × type, and every pool × type, once per fast run and once per zoned
    event (ffd.py:935 e_fit, :996 k_raw, :1108 k_tp). Events past a zoned
    run's first are charged at the fewest claims open before any zoned
    run, and a floor-div counts as one op though it issues several, so the
    bound stays a floor. Returns (bytes, ops)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    args, out = ph["args"], ph["out"]
    st = out.state
    Sp, Ep = out.take_e.shape
    T = st.c_mask.shape[1]
    P = args[ffd.ARG_INDEX["pool_type"]].shape[0]
    R = st.c_cum.shape[1]
    tc = out.take_c.cpu()
    used = int(st.used)
    first_run = (tc[:, :used] > 0).to(torch.int32).argmax(dim=0)
    groups, counts = args[0].cpu().tolist(), args[1].cpu().tolist()
    v_owner = args[ffd.ARG_INDEX["v_owner"]].cpu()
    v_anti = args[ffd.ARG_INDEX["v_member"]].cpu() & (args[ffd.ARG_INDEX["v_kind"]].cpu() == 1)
    ops, zoned_before = 0, []
    for s in range(Sp):
        if counts[s] <= 0:
            continue
        before = int((first_run < s).sum())
        ops += (Ep + before * T + P * T) * R * 3
        g = groups[s]
        if ph["zone"] and bool(v_owner[g].any() | v_anti[g].any()):
            zoned_before.append(before)
    if zoned_before:
        ops += max(0, ph["events"] - len(zoned_before)) * (Ep + min(zoned_before) * T + P * T) * R * 3
    inputs = args if ph["zone"] else args[:24]  # the fast instance reads no V-axis input
    return nbytes(*inputs) + nbytes(out.take_e, out.take_c, out.leftover, out.events, *st), ops


def kernel_rows(ph, ph_zone, launches, ops_per_s):
    """The {"kernels": [...]} rows: times, bounds and yardsticks measured
    at the headline solve's shapes (K1's zoned instance at config 3's)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    args, out, M, cap, cap_u = ph["args"], ph["out"], ph["M"], ph["cap"], ph["cap_u"]
    st = out.state
    Sp, Ep = out.take_e.shape
    T = st.c_mask.shape[1]
    P = args[ffd.ARG_INDEX["pool_type"]].shape[0]
    R = st.c_cum.shape[1]
    src = "karpenter_tpu_torch/csrc/ffd_kernels.cu"

    bytes1, ops1 = scan_cost(ph)
    ms1 = time_ms(lambda: ffd.ffd_solve(*args, max_claims=M), 10)
    plain1 = time_ms(lambda: ffd.ffd_solve_plain(*args, max_claims=M), 2)
    b1, by1 = bound(bytes1, ops1, ops_per_s)

    za, zM = ph_zone["args"], ph_zone["M"]
    zSp, zEp = ph_zone["out"].take_e.shape
    bytes_z, ops_z = scan_cost(ph_zone)
    ms_z = time_ms(lambda: ffd.ffd_solve(*za, max_claims=zM, zone_engine=True), 10)
    plain_z = time_ms(lambda: ffd.ffd_solve_plain(*za, max_claims=zM, zone_engine=True), 1)
    b_z, by_z = bound(bytes_z, ops_z, ops_per_s)

    k2 = ffd.compact_takes(out.take_e, out.take_c, cap)
    bytes2 = nbytes(out.take_e, out.take_c) + nbytes(*k2)
    ops2 = Sp * (Ep + M)
    ms2 = time_ms(lambda: ffd.compact_takes(out.take_e, out.take_c, cap), 50)
    plain2 = time_ms(lambda: ffd.compact_takes_plain(out.take_e, out.take_c, cap), 10)

    def library2():
        grid = torch.cat([out.take_e, out.take_c], dim=1)
        idx = torch.nonzero(grid > 0)
        return grid[idx[:, 0], idx[:, 1]]

    lib2 = time_ms(library2, 50)
    b2, by2 = bound(bytes2, ops2, ops_per_s)

    k3 = ffd.compact_claim_meta(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u)
    Wt = k3[4].shape[1]
    bytes3 = nbytes(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool) + nbytes(*k3[:4])
    ops3 = M * T + M * (M - 1) // 2 * Wt
    ms3 = time_ms(
        lambda: ffd.compact_claim_meta(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u), 50
    )
    plain3 = time_ms(
        lambda: ffd.compact_claim_meta_plain(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u),
        10,
    )
    b3, by3 = bound(bytes3, ops3, ops_per_s)
    dev1 = profiled_ms(lambda: ffd.ffd_solve(*args, max_claims=M), 3, KERNEL_NAMES[:1])
    dev_z = profiled_ms(lambda: ffd.ffd_solve(*za, max_claims=zM, zone_engine=True), 3,
                        KERNEL_NAMES[1:2])
    dev2 = profiled_ms(lambda: ffd.compact_takes(out.take_e, out.take_c, cap), 20,
                       KERNEL_NAMES[2:3])
    dev3 = profiled_ms(
        lambda: ffd.compact_claim_meta(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u),
        20, KERNEL_NAMES[3:6])
    e1, e2, e3 = ph["errs"]
    ez = ph_zone["errs"][0]
    zT = ph_zone["out"].state.c_mask.shape[1]
    return [
        dict(name="ffd_fast_scan", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/ffd.py:1884", launches=launches["ffd_fast_scan"],
             max_abs_err=e1, ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
             library_ms=None, match=e1 == 0, device_ms=dev1, shape=dict(Sp=Sp, Ep=Ep, M=M, T=T, P=P, R=R),
             ops=ops1, bytes=bytes1),
        dict(name="ffd_zoned_scan", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/ffd.py:860", launches=launches["ffd_zoned_scan"],
             max_abs_err=ez, ms=ms_z, plain_ms=plain_z, bound_ms=b_z, bound_by=by_z,
             library_ms=None, match=ez == 0, device_ms=dev_z, events=ph_zone["events"],
             shape=dict(Sp=zSp, Ep=zEp, M=zM, T=zT, V=int(za[ffd.ARG_INDEX["v_kind"]].shape[0]),
                        Z=int(za[ffd.ARG_INDEX["zone_col_mask"]].shape[0])),
             ops=ops_z, bytes=bytes_z),
        dict(name="compact_takes", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/ffd.py:325", launches=launches["compact_takes"],
             max_abs_err=e2, ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by=by2,
             library_ms=lib2, match=e2 == 0, device_ms=dev2, shape=dict(Sp=Sp, K=Ep + M, cap=cap),
             ops=ops2, bytes=bytes2),
        dict(name="claim_meta", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/ffd.py:358", launches=launches["claim_meta"],
             max_abs_err=e3, ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=by3,
             library_ms=None, match=e3 == 0, device_ms=dev3, shape=dict(M=M, T=T, Wt=Wt, cap_u=cap_u),
             ops=ops3, bytes=bytes3),
    ]


def ladder_args(inp, dev):
    """The relax ladder's dispatch inputs for `inp`, built by the backend's
    own host steps (TorchSolver._ladder_dispatch): the truncated encode,
    the kernel arguments and the rung table on `dev`, and the pod count."""
    import dataclasses

    from karpenter_tpu_torch.provisioning.scheduler import ffd_sort
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.convert import args_to_torch, array_to_torch
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    qinp = quantize_input(inp)
    items = relax.plan(qinp)
    order = ffd_sort([p for p in qinp.pods if not p.scheduling_gated and p.node_name is None])
    lp = tb.ladder_pods(items, order)
    assert lp is not None, "the input does not take the relax ladder"
    pods0, runs, ladders, ghosts, ghost_of = lp
    enc = encode(dataclasses.replace(qinp, pods=pods0 + ghosts, presorted=True))
    lt = tb.ladder_table(enc, len(pods0), runs, ladders, ghosts, ghost_of, tb.TorchSolver._bucket)
    assert lt is not None, "the ladder's encode declined"
    enc2, rows, rungs = lt
    host_args, dims, _ = tb.host_kernel_args(enc2, tb.TorchSolver._bucket)
    lad = array_to_torch(tb.pad_ladder(rows, dims["Sp"]), dev)
    return enc2, args_to_torch(host_args, dev), lad, dims, len(pods0), rungs


def ladder_phase(inp, dev, zone=None, plain=True):
    """K6 against its plain version on the card at the shapes of `inp`'s
    ladder dispatch: the instance the main path picks (zoned when the
    ladder's encode has V-axis sigs) unless `zone` says which (the fast
    instance, as K1's, records no V-axis counts: it takes only inputs
    without V-axis sigs on the main path); the claim
    bucket doubles on saturation as the main path's does. Every output is
    compared: take rows, leftovers, zoned events, attempts and all 16
    FFDState fields."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.cuda import ffd

    enc, args, lad, dims, n, rungs = ladder_args(inp, dev)
    zone = enc.V > 0 if zone is None else zone
    M = tb.initial_claim_bucket(n, MAX_CLAIMS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    while True:
        start.record()
        out = ffd.ffd_solve_ladder(lad, *args, max_claims=M, zone_engine=zone)
        end.record()
        torch.cuda.synchronize()
        if int(out.state.used) < M or M >= MAX_CLAIMS:
            break
        M = min(2 * M, MAX_CLAIMS)
    err, plain_s = None, None
    if plain:
        t0 = time.perf_counter()
        ref = ffd.ffd_solve_ladder_plain(lad, *args, max_claims=M, zone_engine=zone)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max_abs_err([out.take_e, out.take_c, out.leftover, out.events, out.attempts, *out.state],
                          [ref.take_e, ref.take_c, ref.leftover, ref.events, ref.attempts, *ref.state])
        name = "ffd_ladder_zoned_scan" if zone else "ffd_ladder_fast_scan"
        assert err == 0, f"{name} disagrees with its plain version (max |d| {err})"
    return dict(enc=enc, args=args, lad=lad, out=out, M=M, zone=zone, err=err, n=n, rungs=rungs,
                dims=dims, attempts=int(out.attempts), events=int(out.events),
                leftover=int(out.leftover.sum()), plain_once_s=plain_s,
                kernel_ms=start.elapsed_time(end))


def ladder_cost(ph):
    """K6's floor on work and traffic: inputs (the rung table included) read
    once, outputs written once; integer ops as scan_cost counts them per
    run (node rows, the claims open before the run × types, pools × types),
    plus, for every attempt past a run's first, the node rows and the pool
    pass with no claim, and for every zoned event past one per attempt the
    same. Returns (bytes, ops)."""
    from karpenter_tpu_torch.solver.cuda import ffd

    args, out = ph["args"], ph["out"]
    st = out.state
    Sp, Ep = out.take_e.shape
    T = st.c_mask.shape[1]
    P = args[ffd.ARG_INDEX["pool_type"]].shape[0]
    R = st.c_cum.shape[1]
    tc = out.take_c.cpu()
    used = int(st.used)
    first_run = (tc[:, :used] > 0).to(dtype=tc.dtype).argmax(dim=0)
    counts = args[1].cpu().tolist()
    runs = [s for s in range(Sp) if counts[s] > 0]
    ops = sum((Ep + int((first_run < s).sum()) * T + P * T) * R * 3 for s in runs)
    per = (Ep + P * T) * R * 3
    ops += max(0, ph["attempts"] - len(runs)) * per + max(0, ph["events"] - ph["attempts"]) * per
    inputs = list(args if ph["zone"] else args[:24]) + [ph["lad"]]
    outputs = [out.take_e, out.take_c, out.leftover, out.events, out.attempts, *st]
    return nbytes(*inputs) + nbytes(*outputs), ops


def ladder_kernel_rows(ph_fast, ph_zone, launches, ops_per_s):
    """The K6 rows of the {"kernels": [...]} line: the fast instance at
    surge_pref's shapes, the zoned one at config3_soft's."""
    from karpenter_tpu_torch.solver.cuda import ffd

    src = "karpenter_tpu_torch/csrc/ffd_kernels.cu"
    rows = []
    for name, ph, kname in (("ffd_ladder_fast_scan", ph_fast, KERNEL_NAMES[9]),
                            ("ffd_ladder_zoned_scan", ph_zone, KERNEL_NAMES[10])):
        args, lad, M, zone = ph["args"], ph["lad"], ph["M"], ph["zone"]

        def run(plain=False):
            fn = ffd.ffd_solve_ladder_plain if plain else ffd.ffd_solve_ladder
            return fn(lad, *args, max_claims=M, zone_engine=zone)

        ms = time_ms(run, 10)
        plain_ms = time_ms(lambda: run(True), 1)
        dev_ms = profiled_ms(run, 3, (kname,))
        b, ops = ladder_cost(ph)
        bms, by = bound(b, ops, ops_per_s)
        Sp, Ep = ph["out"].take_e.shape
        rows.append(dict(
            name=name, route="cuda", source=src, replaces="karpenter_tpu/solver/tpu/ffd.py:2167",
            launches=launches[name], max_abs_err=ph["err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None, match=ph["err"] == 0, device_ms=dev_ms,
            attempts=ph["attempts"], events=ph["events"],
            shape=dict(Sp=Sp, Ep=Ep, M=M, T=int(ph["out"].state.c_mask.shape[1]),
                       Lp=int(lad.shape[1]), G=ph["dims"]["Gp"], Vp=ph["dims"]["Vp"]),
            ops=ops, bytes=b))
    return rows


def ladder_breakdown(inp, repeats: int, M: int, zone: bool) -> dict:
    """Median ms of a ladder solve's stages, run one after another as the
    solver runs them: quantize, the relax plan, the FFD order, the
    level-0 and ghost materializations (ladder_pods: materialize_pod over
    every pod and rung), the encode with the ghost rungs, the rung table
    and kernel arguments, their upload through an arena (cold on the first
    pass, exact hits after; the resident rung table and sparse index
    tables apart), the device work (K6, or K6s where the gate takes the
    union index tables, at the solve's final claim bucket M + compaction,
    CUDA events), the one fetch, and the rest of a full solve (decode,
    canonicalization, bookkeeping)."""
    import dataclasses
    import statistics

    import torch

    from karpenter_tpu_torch.provisioning.scheduler import ffd_sort
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.arena import ArgumentArena
    from karpenter_tpu_torch.solver.convert import array_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import (
        encode,
        quantize_input,
        sparse_run_tables,
        use_sparse_constraints,
    )

    names = ("quantize", "relax_plan", "order", "materialize", "encode", "rung_table",
             "upload", "rung_upload", "device", "fetch", "solve")
    stages = {k: [] for k in names}
    solver = tb.TorchSolver()
    arena = ArgumentArena(device="cuda")
    for _ in range(repeats):
        t = [time.perf_counter()]
        qinp = quantize_input(inp)
        t.append(time.perf_counter())
        items = relax.plan(qinp)
        t.append(time.perf_counter())
        order = ffd_sort([p for p in qinp.pods if not p.scheduling_gated and p.node_name is None])
        t.append(time.perf_counter())
        pods0, runs, ladders, ghosts, ghost_of = tb.ladder_pods(items, order)
        t.append(time.perf_counter())
        enc = encode(dataclasses.replace(qinp, pods=pods0 + ghosts, presorted=True))
        t.append(time.perf_counter())
        enc2, rows, _ = tb.ladder_table(enc, len(pods0), runs, ladders, ghosts, ghost_of,
                                        tb.TorchSolver._bucket)
        host_args, dims, prov = tb.host_kernel_args(enc2, tb.TorchSolver._bucket)
        lad_host = tb.pad_ladder(rows, dims["Sp"])
        gated = use_sparse_constraints(enc2)
        sp_host = sparse_run_tables(enc2, dims["Sp"], run_ladder=rows) if gated else None
        t.append(time.perf_counter())
        args = arena.adopt(host_args, prov)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        key = arena.bucket_key(host_args)
        lad = arena.get_ladder(key, lad_host)
        if lad is None:
            lad = array_to_torch(lad_host, "cuda")
            arena.put_ladder(key, lad_host, lad)
        if gated:
            sp = arena.get_sparse(key, enc2.core_rev, *sp_host)
            if sp is None:
                sp = tuple(array_to_torch(x, "cuda") for x in sp_host)
                arena.put_sparse(key, enc2.core_rev, *sp_host, sp)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if gated:
            out = ffd.ffd_solve_ladder_sparse(lad, *sp, *args, max_claims=M, zone_engine=zone)
        else:
            out = ffd.ffd_solve_ladder(lad, *args, max_claims=M, zone_engine=zone)
        Sp, Ep = out.take_e.shape
        flat = tb._pack_outputs_delta(out, tb.delta_capacity(len(pods0), Sp, Ep, M),
                                      tb.delta_uniq_capacity(Sp, M))
        end.record()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        flat.cpu()
        t.append(time.perf_counter())
        solver.solve(inp)
        t.append(time.perf_counter())
        vals = [(t[i + 1] - t[i]) * 1e3 for i in range(len(t) - 1)]
        vals[8] = start.elapsed_time(end)
        for k, v in zip(names, vals):
            stages[k].append(v)
    med = {f"{k}_ms": statistics.median(v) for k, v in stages.items()}
    med["rest_ms"] = med["solve_ms"] - sum(med[f"{k}_ms"] for k in names[:-1])
    return med


def decisions(res):
    """A SolverResult as plain comparable data."""
    from karpenter_tpu_torch.api import wellknown as wk

    claims = []
    for c in res.claims:
        doms = []
        for key in (wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL):
            r = c.requirements.get(key)
            doms.append(sorted(r.values_list()) if r is not None and not r.complement else None)
        claims.append((c.nodepool, sorted(c.instance_type_names), list(c.pod_uids),
                       doms, sorted(c.requests.items())))
    return dict(placements=dict(res.placements), claims=claims, errors=sorted(res.errors))


def breakdown(inp, repeats: int, M: int, zone: bool) -> dict:
    """Median ms of the solve's stages, run one after another as the solver
    runs them: host encode, host kernel-arg padding (and the sparse index
    tables where the gate takes them), the upload (an arena adopt: cold on
    the first pass, an exact hit after; the resident index tables apart),
    the device work (the checkpointed scan, or its sparse twin, at the
    solve's final claim bucket M + compaction, CUDA events), the one fetch,
    and the host decode and bookkeeping (rest_ms: a full solve minus the
    stages)."""
    import statistics

    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.arena import ArgumentArena
    from karpenter_tpu_torch.solver.convert import array_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import (
        encode,
        quantize_input,
        sparse_run_tables,
        use_sparse_constraints,
    )

    names = ("quantize", "relax_plan", "encode", "kernel_args", "upload", "device", "fetch", "solve")
    stages = {k: [] for k in names}
    solver = tb.TorchSolver()
    arena = ArgumentArena(device="cuda")
    for _ in range(repeats):
        ta = time.perf_counter()
        qinp = quantize_input(inp)
        tb_ = time.perf_counter()
        relax.plan(qinp)
        t0 = time.perf_counter()
        enc = encode(qinp)
        t1 = time.perf_counter()
        host_args, dims, prov = tb.host_kernel_args(enc, tb.TorchSolver._bucket)
        gated = use_sparse_constraints(enc)
        sp_host = sparse_run_tables(enc, dims["Sp"]) if gated else None
        t2 = time.perf_counter()
        args = arena.adopt(host_args, prov)
        if gated:
            key = arena.bucket_key(host_args)
            sp = arena.get_sparse(key, enc.core_rev, *sp_host)
            if sp is None:
                sp = tuple(array_to_torch(t, "cuda") for t in sp_host)
                arena.put_sparse(key, enc.core_rev, *sp_host, sp)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        total = int(sum(len(p) for p in enc.group_pods))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if gated:
            out, _ring = ffd.ffd_solve_ckpt_sparse(*sp, *args, max_claims=M, zone_engine=zone)
        else:
            out, _ring = ffd.ffd_solve_ckpt(*args, max_claims=M, zone_engine=zone)
        Sp, Ep = out.take_e.shape
        flat = tb._pack_outputs_delta(out, tb.delta_capacity(total, Sp, Ep, M),
                                      tb.delta_uniq_capacity(Sp, M))
        end.record()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        flat.cpu()
        t5 = time.perf_counter()
        solver.solve(inp)
        t6 = time.perf_counter()
        for k, v in zip(names, ((tb_ - ta) * 1e3, (t0 - tb_) * 1e3, (t1 - t0) * 1e3,
                                (t2 - t1) * 1e3, (t3 - t2) * 1e3, start.elapsed_time(end),
                                (t5 - t4) * 1e3, (t6 - t5) * 1e3)):
            stages[k].append(v)
    med = {f"{k}_ms": statistics.median(v) for k, v in stages.items()}
    med["rest_ms"] = med["solve_ms"] - sum(med[f"{k}_ms"] for k in names[:-1])
    return med


KERNEL_NAMES = ("ffd_scan_kernel<false, false, false, false, false>",
                "ffd_scan_kernel<true, false, false, false, false>",
                "compact_takes_kernel", "meta_pack_kernel", "meta_first_kernel",
                "meta_finish_kernel", "ffd_scan_kernel<false, true, false, false, false>",
                "ffd_scan_kernel<true, true, false, false, false>", "pack_verdicts_kernel",
                "ffd_scan_kernel<false, false, true, false, false>",
                "ffd_scan_kernel<true, false, true, false, false>",
                "ffd_scan_kernel<false, false, false, true, false>",
                "ffd_scan_kernel<true, false, false, true, false>", "arena_unpack_kernel",
                # the sparse instances (14-19) and the dense output pack (20)
                "ffd_scan_kernel<false, false, false, false, true>",
                "ffd_scan_kernel<true, false, false, false, true>",
                "ffd_scan_kernel<false, false, true, false, true>",
                "ffd_scan_kernel<true, false, true, false, true>",
                "ffd_scan_kernel<false, false, false, true, true>",
                "ffd_scan_kernel<true, false, false, true, true>",
                "pack_outputs_kernel",
                # the class and explain kernels (21-25)
                "gang_commit_kernel", "preempt_scan_kernel", "preempt_take_kernel",
                "explain_sums_kernel", "explain_rows_kernel",
                # the lane-batched scan (26, 27), the run-table scatter (28, 29)
                # and the lane pad (30)
                "ffd_lanes_kernel<false>", "ffd_lanes_kernel<true>", "copy_runs_kernel",
                "apply_events_kernel", "pad_lanes_kernel")
# phase 3: TorchSolver() at its defaults (K7, K7s on the sparse-gated cells,
# K2, K3; its uploads are exact hits after the warm-up), one arena=False
# solver (K1 and K1s in both instances) and one device_decode=False solver
# (the dense output pack)
SINGLE_SOLVE_KERNELS = ("ffd_ckpt_fast_scan", "ffd_ckpt_zoned_scan", "ffd_fast_scan",
                        "ffd_zoned_scan", "compact_takes", "claim_meta",
                        "ffd_ckpt_sparse_fast_scan", "ffd_ckpt_sparse_zoned_scan",
                        "ffd_sparse_fast_scan", "ffd_sparse_zoned_scan", "pack_outputs")
RELAX_KERNELS = ("ffd_ladder_fast_scan", "ffd_ladder_zoned_scan", "ffd_ladder_sparse_zoned_scan",
                 "ffd_ladder_sparse_fast_scan", "compact_takes", "claim_meta")
# the arena-and-resume phase: K7 cold and resumed (K7s on config3_tail), K8
# on every delta upload, K1 through the resume=False solver it is held to
RESUME_KERNELS = ("ffd_ckpt_fast_scan", "ffd_ckpt_sparse_zoned_scan", "arena_unpack",
                  "ffd_fast_scan", "ffd_sparse_zoned_scan", "compact_takes", "claim_meta")


def reset_launches():
    from karpenter_tpu_torch.solver.cuda import arena, convex, ffd

    for d in (ffd.LAUNCHES, arena.LAUNCHES, convex.LAUNCHES):
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    from karpenter_tpu_torch.solver.cuda import arena, convex, ffd

    return {**ffd.LAUNCHES, **arena.LAUNCHES, **convex.LAUNCHES}

CONSOLIDATION_KERNELS = ("ffd_batched_fast_scan", "ffd_batched_zoned_scan", "pack_verdicts")


def device_profile(inp, scan: str, tries: int = 6) -> dict:
    """One warm TorchSolver solve under torch.profiler: device time by
    kernel and the device's busy share of the solve's wall time. A trace
    without the solve's scan kernel (`scan`, a KERNEL_NAMES entry) is taken
    again, up to `tries` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.solver import backend as tb

    solver = tb.TorchSolver()
    solver.solve(inp)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solver.solve(inp)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            name = next((k for k in KERNEL_NAMES if k in e.name), "other: " + e.name[:40])
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us()
        if scan in by:
            busy = sum(by.values())
            return dict(wall_us=wall_us, device_busy_us=busy, idle_share=1 - busy / wall_us,
                        by_kernel_us=by)
    return {"device_profile": "not measured (no trace recorded the scan kernel)"}


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


class GcWatch:
    """Garbage-collection pauses inside a window, from gc.callbacks: their
    total ms and the number of collections per generation."""

    def __init__(self):
        self._t0 = 0.0
        self.reset()
        gc.callbacks.append(self._cb)

    def reset(self):
        self.ms = 0.0
        self.collections = [0, 0, 0]

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.collections[info["generation"]] += 1

    def close(self):
        gc.callbacks.remove(self._cb)


def tail(samples) -> dict:
    """p50/p99/max of (solve ms, gc ms, collections) samples, and the slowest
    solve's own garbage-collection pause."""
    ms = [m for m, _, _ in samples]
    slow = max(samples, key=lambda x: x[0])
    return dict(n=len(ms), p50_ms=pct(ms, 50), p99_ms=pct(ms, 99), max_ms=slow[0],
                min_ms=min(ms), slowest_gc_ms=slow[1], slowest_gc_collections=slow[2],
                gc_ms_total=sum(g for _, g, _ in samples),
                solves_with_gen2_gc=sum(1 for _, _, c in samples if c[2]))


class PlainOnCard:
    """Route the kernel wrappers to their plain versions, on the card's
    tensors, for a reference solve through TorchSolver (used where the CPU
    plain path would take minutes: the mixed input's ~10^4 zoned events)."""

    def __enter__(self):
        from karpenter_tpu_torch.solver.cuda import arena, ffd

        def solve_plain(*args, sparse=None, **kw):
            return ffd._scan_plain(args, ffd._state0(args, kw["max_claims"]), kw["max_claims"],
                                   kw.get("zone_engine", False), sparse=sparse)[0]

        def ckpt_plain(init_state, *args, sparse=None, **kw):
            st = (ffd._state0(args, kw["max_claims"]) if init_state is None
                  else ffd._resume_state(init_state, args, kw["max_claims"]))
            return ffd._scan_plain(args, st, kw["max_claims"], kw["zone_engine"],
                                   kw["ckpt_every"], kw["n_ckpt"], sparse=sparse)

        self.saved = (ffd._ffd_solve_cuda, ffd._compact_takes_cuda, ffd._claim_meta_cuda,
                      ffd._ffd_solve_ladder_cuda, ffd._ffd_scan_ckpt_cuda,
                      ffd._pack_outputs_cuda, arena._unpack_cuda, ffd._gang_commit_cuda,
                      ffd._preemption_plan_cuda, ffd._explain_pack_cuda)
        ffd._ffd_solve_cuda = solve_plain
        ffd._compact_takes_cuda = ffd.compact_takes_plain
        ffd._claim_meta_cuda = ffd.compact_claim_meta_plain
        ffd._ffd_solve_ladder_cuda = ffd.ffd_solve_ladder_plain
        ffd._ffd_scan_ckpt_cuda = ckpt_plain
        ffd._pack_outputs_cuda = ffd.pack_outputs_plain
        arena._unpack_cuda = arena.unpack_plain
        ffd._gang_commit_cuda = ffd.gang_commit_plain
        ffd._preemption_plan_cuda = ffd.preemption_plan_plain
        ffd._explain_pack_cuda = ffd.explain_pack_plain
        return self

    def __exit__(self, *exc):
        from karpenter_tpu_torch.solver.cuda import arena, ffd

        (ffd._ffd_solve_cuda, ffd._compact_takes_cuda, ffd._claim_meta_cuda,
         ffd._ffd_solve_ladder_cuda, ffd._ffd_scan_ckpt_cuda, ffd._pack_outputs_cuda,
         arena._unpack_cuda, ffd._gang_commit_cuda, ffd._preemption_plan_cuda,
         ffd._explain_pack_cuda) = self.saved


CONFIG5_NODES = 10_000  # BASELINE config 5
CONFIG5_CANDIDATES = 2_000


def as_consolidation_universe(inp):
    """A small fleet as a consolidation universe: every existing node is a
    candidate, the fleet's pods are dealt round-robin to all candidates but
    the last, which keeps its node and no pods."""
    import dataclasses

    n = len(inp.nodes)
    holders = max(1, n - 1)
    cpods = {c: [] for c in range(n)}
    for i, p in enumerate(inp.pods):
        cpods[i % holders].append(p)
    cnode = {c: inp.nodes[c].id for c in range(n)}
    return dataclasses.replace(inp, pods=[]), cpods, cnode


def small_subsets(n_cand: int, seed: int):
    """Empty, every single candidate, a pair, all, and random subsets: at
    least 9 rows, so the batch bucket adds padding rows."""
    import random

    rng = random.Random(seed)
    subs = [[], *[[c] for c in range(n_cand)], [0, 1], list(range(n_cand))]
    while len(subs) < 13:
        subs.append(sorted(rng.sample(range(n_cand), rng.randint(1, n_cand))))
    return subs


def fleets_with_nodes(make_fleet, n: int):
    """The first n seeds of `make_fleet` whose fleet has at least 2 nodes."""
    out, seed = [], 0
    while len(out) < n:
        inp = make_fleet(seed)
        if len(inp.nodes) >= 2:
            out.append((seed, inp))
        seed += 1
    return out


def batched_scan_cost(args, rows, out, zone: bool):
    """K4's floor on work and traffic: inputs read once (the shared
    arguments and the subset rows), outputs written once (the per-row
    carry, leftovers and event counts); integer ops per row as scan_cost
    counts them — (sub, floor-div, min) per resource over every node row
    and every pool × type, once per run with pods in the row and once per
    zoned event past a zoned run's first — with the claims open before a
    run charged at 0 (verdict mode keeps no per-run takes), so the bound
    stays a floor. Returns (bytes, ops)."""
    from karpenter_tpu_torch.solver.cuda import ffd

    E, R = args[ffd.ARG_INDEX["node_free"]].shape
    P, T = args[ffd.ARG_INDEX["pool_type"]].shape
    b_run_count = rows[0]
    runs_with_pods = (b_run_count > 0).sum(axis=1)
    per_pass = (E + P * T) * R * 3
    ops = int(runs_with_pods.sum()) * per_pass
    if zone:
        groups = args[0].cpu()
        v_owner = args[ffd.ARG_INDEX["v_owner"]].cpu()
        v_anti = args[ffd.ARG_INDEX["v_member"]].cpu() & (args[ffd.ARG_INDEX["v_kind"]].cpu() == 1)
        constrained = (v_owner.any(dim=1) | v_anti.any(dim=1))[groups.long()].numpy()
        zoned_runs = ((b_run_count > 0) & constrained[None, :]).sum(axis=1)
        events = out.events.cpu().numpy()
        ops += int((events - zoned_runs).clip(min=0).sum()) * per_pass
    outputs = [out.leftover, out.events, *out.state]
    in_bytes = nbytes(*args) + int(sum(r.nbytes for r in rows))
    return in_bytes + nbytes(*outputs), ops


def small_batched_check(inp, M: int, seed: int, dev):
    """K4 (the instance the universe picks) and K5 against their plain
    versions (run on CPU copies of the same inputs: at these shapes the
    plain loop is faster there) on every row of one small batch."""
    import torch

    from karpenter_tpu_torch.disruption.batched import BatchedConsolidationEvaluator
    from karpenter_tpu_torch.solver.backend import TorchSolver
    from karpenter_tpu_torch.solver.cuda import consolidate as cons

    base, cpods, cnode = as_consolidation_universe(inp)
    prep = BatchedConsolidationEvaluator(TorchSolver(), max_claims=M).prepare(base, cpods, cnode)
    assert prep is not None, "a small fleet fell off the batched path"
    zone = prep.enc.V > 0
    subs = small_subsets(len(cnode), seed)
    rows = cons.subset_rows(prep.args, prep.pod_cand, prep.pod_run, subs, prep.node_idx,
                            prep.v_delta, prep.v_count0_host)
    out = cons.batched_ffd(prep.args, *cons.upload_rows(rows, dev), M, zone)
    flat = cons.pack_verdicts(out)
    torch.cuda.synchronize()
    cpu_args = tuple(a.cpu() for a in prep.args)
    plain = cons.batched_ffd_plain(cpu_args, *cons.upload_rows(rows, "cpu"), M, zone)
    err4 = max_abs_err([out.leftover, out.events, *out.state],
                       [plain.leftover, plain.events, *plain.state])
    err5 = max_abs_err([flat], [cons.pack_verdicts_plain(plain)])
    used = out.state.used.cpu()
    return dict(zone=zone, err4=err4, err5=err5, rows=len(used), saturated=int((used >= M).sum()),
                events=int(out.events.sum()), prep=prep, rows_host=rows, out=out, M=M)


def config5_phase(dev, ops_per_s: float) -> dict:
    """BASELINE config 5 through the port: prepare the 10k-node universe
    once, then the controller's prefix search (speculative_binary_search)
    through BatchedConsolidationEvaluator(TorchSolver()), as bench.py's
    bench_config5 runs it: the first search checks k >= 100 in <= 2
    dispatches equal to the sequential replay (>= 6 probes), five more are
    timed (p50). Zone-fleet consolidations through the same evaluator drive
    K4's zoned instance. Launch counts are reset just before and read just
    after. Then K4 against its plain version on the card on a full 512-row
    dispatch at config-5 shapes (a sample of rows) and on small fleets whose
    rows saturate the claim slots, K5 on the full batch, the per-dispatch
    host split, and the kernel rows."""
    import random
    import statistics

    import torch

    from karpenter_tpu_torch.disruption import batched as tb
    from karpenter_tpu_torch.solver.backend import TorchSolver
    from karpenter_tpu_torch.solver.cuda import build, ffd
    from karpenter_tpu_torch.solver.cuda import consolidate as cons

    t0 = time.perf_counter()
    inp, cpods, cnode = build_config5_universe(CONFIG5_NODES, CONFIG5_CANDIDATES)
    build_s = time.perf_counter() - t0
    ev = tb.BatchedConsolidationEvaluator(TorchSolver())
    t0 = time.perf_counter()
    prep = ev.prepare(inp, cpods, cnode)
    prepare_s = time.perf_counter() - t0
    assert prep is not None, "config 5 fell off the batched path"
    enc = prep.enc
    assert enc.V == 0
    # the universe adopts into the solver's arena: the second prepare of the
    # same universe uploads nothing (an exact hit of the universe's bucket)
    led, arena = ev.solver.ledger, ev.solver.arena
    cold_bytes = led.total["h2d_bytes"]
    t0 = time.perf_counter()
    prep2 = ev.prepare(inp, cpods, cnode)
    prepare2_s = time.perf_counter() - t0
    universe = dict(cold_h2d_bytes=cold_bytes, second_h2d_bytes=led.total["h2d_bytes"] - cold_bytes,
                    second_exact_hit=arena.stats["exact_hits"] == 1, second_prepare_s=prepare2_s,
                    resident_bytes=arena.total_bytes())
    assert universe["second_h2d_bytes"] == 0 and universe["second_exact_hit"], universe
    assert all(a is b for a, b in zip(prep.args, prep2.args))
    from karpenter_tpu_torch.solver.backend import host_kernel_args

    u_args = host_kernel_args(enc, TorchSolver._bucket)[0]
    universe["k8"] = {k: v for k, v in unpack_check(u_args, dev).items() if k in ("nbytes", "segments", "err")}
    zone_fleets = fleets_with_nodes(build_zone_input, 4)
    zone_preps = []
    for seed, zinp in zone_fleets:
        zev = tb.BatchedConsolidationEvaluator(TorchSolver())
        zp = zev.prepare(*as_consolidation_universe(zinp))
        assert zp is not None and zp.enc.V > 0
        zone_preps.append((zev, zp, len(zinp.nodes)))

    # ---- the main path, launch counts reset just before ---------------------
    reset_launches()
    t0 = time.perf_counter()
    k_best, dispatches, n_probed, seq = _prefix_search(ev, prep, CONFIG5_CANDIDATES)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        k2, d2, probed2, _ = _prefix_search(ev, prep, CONFIG5_CANDIDATES)
        times.append((time.perf_counter() - t0) * 1e3)
        assert (k2, d2) == (k_best, dispatches)
    zone_ks = []
    for zev, zp, n in zone_preps:
        best, _, _ = tb.speculative_binary_search(
            lambda ks: zev.evaluate_prepared(zp, [list(range(kk)) for kk in ks]), 1, n,
            lambda kk, v: _accept_consolidation(kk, v))
        zone_ks.append(best)
    torch.cuda.synchronize()
    launches = read_launches()
    for k in CONSOLIDATION_KERNELS:
        assert launches[k] > 0, f"kernel {k} never launched on the consolidation path"
    assert k_best >= 100, f"expected a large consolidatable prefix, got {k_best}"
    assert dispatches <= 2, f"the prefix search took {dispatches} dispatches"
    assert seq >= 6, f"the sequential baseline needed only {seq} probes"
    p50 = statistics.median(times)
    searches = 6
    print(f"config5: k={k_best} dispatches={dispatches} probed={n_probed} seq_probes={seq} "
          f"p50_ms={p50:.3f} first_s={first_s:.3f} launches={launches} zone_ks={zone_ks}",
          flush=True)

    # ---- K4 / K5 against their plain versions on the card ------------------------
    levels = max(1, (512 + 1).bit_length() - 1)
    ks = tb.binary_probe_frontier(2, CONFIG5_CANDIDATES, levels)
    for extra in (k_best, k_best + 1):
        if extra not in ks and extra <= CONFIG5_CANDIDATES:
            ks[len(ks) // 2] = extra
            ks = sorted(set(ks))
    ks = sorted(ks)
    subsets = [list(range(kk)) for kk in ks]
    rows = cons.subset_rows(prep.args, prep.pod_cand, prep.pod_run, subsets, prep.node_idx,
                            prep.v_delta, prep.v_count0_host)
    Bp = rows[0].shape[0]
    assert Bp == 512 and len(subsets) == 511, (Bp, len(subsets))
    drows = cons.upload_rows(rows, dev)
    M = ev.max_claims
    out = cons.batched_ffd(prep.args, *drows, M, False)
    flat = cons.pack_verdicts(out)
    torch.cuda.synchronize()
    rng = random.Random(5)
    must = [ks.index(k_best), ks.index(k_best + 1) if k_best + 1 in ks else len(ks) - 1,
            0, len(ks) - 1, Bp - 1]
    sample = sorted(set(must) | set(rng.sample(range(Bp), 16)))
    sel = torch.tensor(sample, device=dev)
    t0 = time.perf_counter()
    plain = cons.batched_ffd_plain(prep.args, *[r[sel] for r in drows[:3]], drows[3], M, False)
    torch.cuda.synchronize()
    plain_sample_s = time.perf_counter() - t0
    err4 = max_abs_err([out.leftover[sel], out.events[sel], *[f[sel] for f in out.state]],
                       [plain.leftover, plain.events, *plain.state])
    assert err4 == 0, f"ffd_batched_fast_scan disagrees with its plain version (max |d| {err4})"
    err5 = max_abs_err([flat], [cons.pack_verdicts_plain(out)])
    assert err5 == 0, f"pack_verdicts disagrees with its plain version (max |d| {err5})"
    used = out.state.used.cpu()
    lo_tot = out.leftover.sum(dim=1).cpu()
    print(f"config5 check: rows={Bp} sample={len(sample)} max_abs_err=({err4}, {err5}) "
          f"plain_sample_s={plain_sample_s:.2f} used_max={int(used.max())} "
          f"rows_with_leftover={int((lo_tot > 0).sum())}", flush=True)

    # small fleets with saturating rows (M=2) and M=16: the fast instance on
    # the hostname-constrained fleets, the zoned one on the zone fleets
    small = []
    for make_fleet, zone_expected in ((build_constrained_input, False), (build_zone_input, True)):
        for seed, sinp in fleets_with_nodes(make_fleet, 4):
            for Ms in (2, 16):
                r = small_batched_check(sinp, Ms, seed, dev)
                assert r["zone"] == zone_expected
                assert r["err4"] == 0 and r["err5"] == 0, (make_fleet.__name__, seed, Ms, r["err4"], r["err5"])
                small.append(r)
    for zone_expected in (False, True):
        assert any(r["saturated"] for r in small if r["zone"] == zone_expected and r["M"] == 2), \
            "no small-fleet row saturated its claim slots"
    print(f"small batched fleets: {len(small)} batches max_abs_err=(0, 0) saturated_rows="
          f"{[r['saturated'] for r in small]} events={[r['events'] for r in small]}", flush=True)

    # ---- per-dispatch host split and transfer bytes (the 511-row dispatch) --------
    # stages one after another as a dispatch runs them: the host rows, their
    # upload, K4, K5 + the one fetch, fetch_verdicts (K5 + fetch + the bit
    # unpack), and _finish_verdicts whole (fetch_verdicts + per-row verdicts)
    split = {k: [] for k in ("rows_host", "upload", "device", "pack_fetch", "fetch_unpack",
                             "finish")}
    for _ in range(5):
        t0 = time.perf_counter()
        hrows = cons.subset_rows(prep.args, prep.pod_cand, prep.pod_run, subsets, prep.node_idx,
                                 prep.v_delta, prep.v_count0_host)
        t1 = time.perf_counter()
        d = cons.upload_rows(hrows, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        o = cons.batched_ffd(prep.args, *d, M, False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        cons.pack_verdicts(o).cpu()
        t4 = time.perf_counter()
        fetched = cons.fetch_verdicts(o, enc.T, len(subsets))
        t5 = time.perf_counter()
        ev._finish_verdicts(prep, o, len(subsets))
        t6 = time.perf_counter()
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5)):
            split[k].append(v * 1e3)
    split_ms = {f"{k}_ms": statistics.median(v) for k, v in split.items()}
    h2d = int(sum(r.nbytes for r in rows))
    d2h = int(flat.numel() * flat.element_size())
    assert fetched[0].shape[0] == len(subsets)

    # ---- kernel rows ----------------------------------------------------------------
    src = "karpenter_tpu_torch/csrc/ffd_kernels.cu"
    ms4 = time_ms(lambda: cons.batched_ffd(prep.args, *drows, M, False), 5)
    dev4 = profiled_ms(lambda: cons.batched_ffd(prep.args, *drows, M, False), 3,
                       (KERNEL_NAMES[6],))
    t0 = time.perf_counter()
    cons.batched_ffd_plain(prep.args, *drows, M, False)
    torch.cuda.synchronize()
    plain4 = (time.perf_counter() - t0) * 1e3
    bytes4, ops4 = batched_scan_cost(prep.args, rows, out, False)
    b4, by4 = bound(bytes4, ops4, ops_per_s)

    zr = next(r for r in small if r["zone"] and r["M"] == 16)
    zargs, zrows, zM = zr["prep"].args, zr["rows_host"], zr["M"]
    zdrows = cons.upload_rows(zrows, dev)
    ms4z = time_ms(lambda: cons.batched_ffd(zargs, *zdrows, zM, True), 10)
    dev4z = profiled_ms(lambda: cons.batched_ffd(zargs, *zdrows, zM, True), 3,
                        (KERNEL_NAMES[7],), tries=10)
    plain4z = time_ms(lambda: cons.batched_ffd_plain(zargs, *zdrows, zM, True), 1)
    bytes4z, ops4z = batched_scan_cost(zargs, zrows, zr["out"], True)
    b4z, by4z = bound(bytes4z, ops4z, ops_per_s)

    ms5 = time_ms(lambda: cons.pack_verdicts(out), 50)
    dev5 = profiled_ms(lambda: cons.pack_verdicts(out), 20, ("pack_verdicts_kernel",))
    plain5 = time_ms(lambda: cons.pack_verdicts_plain(out), 10)
    st = out.state
    bytes5 = nbytes(out.leftover, st.used, st.c_zc_bits, st.c_mask, flat)
    ops5 = Bp * (out.leftover.shape[1] + st.c_mask.shape[1] * st.c_mask.shape[2])
    b5, by5 = bound(bytes5, ops5, ops_per_s)

    regs = {k: v.get("registers") for k, v in ptxas_report(build.BUILD_LOG["ptxas"]).items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    reg4 = regs.get("ffd_scan_kernel<false, true, false, false>")
    blocks_per_sm = max(1, min(2048 // 1024, 65536 // (1024 * max(reg4 or 64, 1))))
    waves = -(-Bp // (sms * blocks_per_sm))
    n_disp = searches * dispatches
    rows_out = [
        dict(name="ffd_batched_fast_scan", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/consolidate.py:57",
             launches=launches["ffd_batched_fast_scan"], max_abs_err=err4, ms=ms4,
             plain_ms=plain4, bound_ms=b4, bound_by=by4, library_ms=None, match=err4 == 0,
             device_ms=dev4, launches_per_dispatch=launches["ffd_batched_fast_scan"] / n_disp,
             shape=dict(B=Bp, Sp=int(rows[0].shape[1]),
                        Ep=int(prep.args[ffd.ARG_INDEX["node_free"]].shape[0]),
                        M=M, T=int(st.c_mask.shape[2]), NC=int(rows[2].shape[1])),
             ops=ops4, bytes=bytes4, registers=reg4, blocks_per_sm=blocks_per_sm, waves=waves),
        dict(name="ffd_batched_zoned_scan", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/consolidate.py:57",
             launches=launches["ffd_batched_zoned_scan"], max_abs_err=zr["err4"], ms=ms4z,
             plain_ms=plain4z, bound_ms=b4z, bound_by=by4z, library_ms=None,
             match=zr["err4"] == 0, device_ms=dev4z,
             shape=dict(B=int(zrows[0].shape[0]), Sp=int(zrows[0].shape[1]), M=zM,
                        V=int(zrows[1].shape[1]), Z=int(zrows[1].shape[2])),
             ops=ops4z, bytes=bytes4z, registers=regs.get("ffd_scan_kernel<true, true, false, false>")),
        dict(name="pack_verdicts", route="cuda", source=src,
             replaces="karpenter_tpu/solver/tpu/consolidate.py:291",
             launches=launches["pack_verdicts"], max_abs_err=err5, ms=ms5, plain_ms=plain5,
             bound_ms=b5, bound_by=by5, library_ms=None, match=err5 == 0, device_ms=dev5,
             launches_per_dispatch=launches["pack_verdicts"] / max(1, launches["ffd_batched_fast_scan"]
                                                                   + launches["ffd_batched_zoned_scan"]),
             shape=dict(B=Bp, M=M, Tp=int(st.c_mask.shape[2])), ops=ops5, bytes=bytes5),
    ]
    summary = dict(
        config5_eval_p50_ms=p50,
        config5_subset_evals_per_s=probed2 / (p50 / 1e3),
        config5_prefix_nodes=k_best,
        config5_dispatches=dispatches,
        config5_prefixes_probed=n_probed,
        config5_sequential_probes=seq,
        search_ms=times,
        first_search_s=first_s,
        universe_build_s=build_s,
        prepare_s=prepare_s,
        universe_adopt=universe,
        dims=dict(E=enc.E, T=enc.T, G=enc.G, S=len(enc.run_group), NC=int(rows[2].shape[1]), Bp=Bp),
        per_dispatch=dict(rows=len(subsets), h2d_bytes=h2d, d2h_bytes=d2h, k4_device_ms=dev4,
                          k5_device_ms=dev5, **split_ms),
        launches=launches,
        zone_fleet_k=zone_ks,
        check=dict(sample_rows=len(sample), plain_sample_s=plain_sample_s,
                   small_batches=len(small)),
    )
    return dict(summary=summary, rows=rows_out)


def _scan_outputs(o):
    return [o.take_e, o.take_c, o.leftover, o.events, *o.state]


def ckpt_check(ph, K: int, n: int):
    """K7 (the checkpointed scan, the instance `ph`'s solve picks) against
    its plain version at `ph`'s shapes with ring interval K and n slots:
    every output, every field of every ring slot and the prefix; and against
    K1's outputs (ph["out"]). Then K7's resume from the slot that covers
    the most real runs short of the last, against the plain resume, with the
    final carry equal to the cold solve's and the slot left as it was."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.cuda import ffd

    args, M, zone = ph["args"], ph["M"], ph["zone"]
    kw = dict(max_claims=M, zone_engine=zone, ckpt_every=K, n_ckpt=n)
    out, ring = ffd.ffd_solve_ckpt(*args, **kw)
    torch.cuda.synchronize()
    pout, pring = ffd.ffd_solve_ckpt_plain(*args, **kw)
    err = max_abs_err(_scan_outputs(out) + [*ring.states, ring.prefix],
                      _scan_outputs(pout) + [*pring.states, pring.prefix])
    name = "ffd_ckpt_zoned_scan" if zone else "ffd_ckpt_fast_scan"
    assert err == 0, f"{name} (K={K}, n={n}) disagrees with its plain version (max |d| {err})"
    err_k1 = max_abs_err(_scan_outputs(out), _scan_outputs(ph["out"]))
    assert err_k1 == 0, f"{name} disagrees with K1 (max |d| {err_k1})"
    S = int((args[1] > 0).sum())
    prefix = ring.prefix.cpu().tolist()
    slot = max((i for i, p in enumerate(prefix) if 1 <= p < S), key=lambda i: prefix[i])
    k = prefix[slot]
    init = ffd.FFDState(*(f[slot] for f in ring.states))
    before = [t.clone() for t in init]
    Sp2 = tb.TorchSolver._bucket(S - k, 16, 16)
    suffix = [torch.zeros(Sp2, dtype=torch.int32, device=args[0].device) for _ in range(2)]
    suffix[0][: S - k] = args[0][k:S]
    suffix[1][: S - k] = args[1][k:S]
    rout, rring = ffd.ffd_resume(init, *suffix, *args[2:], **kw)
    torch.cuda.synchronize()
    prout, prring = ffd.ffd_resume_plain(init, *suffix, *args[2:], **kw)
    err_r = max_abs_err(_scan_outputs(rout) + [*rring.states, rring.prefix],
                        _scan_outputs(prout) + [*prring.states, prring.prefix])
    assert err_r == 0, f"{name} resume disagrees with the plain resume (max |d| {err_r})"
    err_f = max_abs_err(list(rout.state), list(out.state))
    assert err_f == 0, f"{name}: the resumed final carry differs from the cold one ({err_f})"
    assert max_abs_err(list(init), before) == 0, "the resume wrote into its checkpoint"
    return dict(name=name, K=K, n=n, err=err, err_k1=err_k1, err_resume=err_r, k=k, S=S,
                Sp2=Sp2, prefix=prefix, out=out, ring=ring, init=init, suffix=suffix)


def sparse_tables(enc, Sp: int, dev, run_ladder=None):
    """The run-major index tables of `enc`'s solve (encode.sparse_run_tables,
    as the backend builds them) on `dev`."""
    from karpenter_tpu_torch.solver.convert import array_to_torch
    from karpenter_tpu_torch.solver.encode import sparse_run_tables

    sq, sv = sparse_run_tables(enc, Sp, run_ladder=run_ladder)
    return array_to_torch(sq, dev), array_to_torch(sv, dev)


def superset_tables(sp, Q: int, V: int, seed: int):
    """The index rows rewritten as supersets: each row's columns in random
    slots of a row 8 wider, -1 interleaved, plus up to two columns the row
    did not list (decision-identical: a non-member column is neutral)."""
    import random

    import torch

    rng = random.Random(seed)
    out = []
    for t, n_cols in zip(sp, (Q, V)):
        rows = t.cpu().tolist()
        width = t.shape[1] + 8
        new = torch.full((t.shape[0], width), -1, dtype=torch.int32)
        for i, row in enumerate(rows):
            cols = [c for c in row if c >= 0]
            extra = [c for c in rng.sample(range(n_cols), min(n_cols, 4)) if c not in cols][:2]
            vals = cols + extra
            for slot, c in zip(rng.sample(range(width), len(vals)), vals):
                new[i, slot] = c
        out.append(new.to(t.device))
    return tuple(out)


def sparse_check(ph, dev, K: int = 16, n: int = 4, resume: bool = True):
    """K1s and K7s (the sparse scan instances, the one `ph`'s solve picks)
    against their plain versions at `ph`'s shapes with the encode's index
    tables: every output, ring slot and prefix, zoned event counts; and
    against the dense K1's outputs (ph["out"]). With `resume`: K7s from
    its own ring slot against the plain sparse resume, K7s from the dense
    K7's ring and K7 from K7s's ring, each ending at the cold carry, every
    checkpoint left untouched. The plain sparse scan runs once: its
    outputs are K1s's reference too."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.cuda import ffd

    args, M, zone = ph["args"], ph["M"], ph["zone"]
    sp = sparse_tables(ph["enc"], ph["dims"]["Sp"], dev)
    kw = dict(max_claims=M, zone_engine=zone, ckpt_every=K, n_ckpt=n)
    out = ffd.ffd_solve_sparse(*sp, *args, max_claims=M, zone_engine=zone)
    cout, cring = ffd.ffd_solve_ckpt_sparse(*sp, *args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pout, pring = ffd.ffd_solve_ckpt_sparse_plain(*sp, *args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    tag = "zoned" if zone else "fast"
    err1 = max_abs_err(_scan_outputs(out), _scan_outputs(pout))
    assert err1 == 0, f"ffd_sparse_{tag}_scan disagrees with its plain version (max |d| {err1})"
    err7 = max_abs_err(_scan_outputs(cout) + [*cring.states, cring.prefix],
                       _scan_outputs(pout) + [*pring.states, pring.prefix])
    assert err7 == 0, f"ffd_ckpt_sparse_{tag}_scan disagrees with its plain version ({err7})"
    err_dense = max_abs_err(_scan_outputs(out), _scan_outputs(ph["out"]))
    assert err_dense == 0, f"ffd_sparse_{tag}_scan disagrees with the dense K1 ({err_dense})"
    res = dict(name=f"ffd_sparse_{tag}_scan", K=K, n=n, err=err1, err_ckpt=err7,
               err_dense=err_dense, events=int(out.events), plain_once_s=plain_s, sp=sp,
               Kq=int(sp[0].shape[1]), Kv=int(sp[1].shape[1]), out=out, cout=cout, cring=cring)
    S = int((args[1] > 0).sum())
    prefix = cring.prefix.cpu().tolist()
    slots = [i for i, p in enumerate(prefix) if 1 <= p < S]
    if not resume or not slots:
        return res
    slot = max(slots, key=lambda i: prefix[i])
    k = prefix[slot]
    Sp2 = tb.TorchSolver._bucket(S - k, 16, 16)
    suffix = [torch.zeros(Sp2, dtype=torch.int32, device=dev) for _ in range(2)]
    idx = [torch.full((Sp2, t.shape[1]), -1, dtype=torch.int32, device=dev) for t in sp]
    for dst, src in zip(suffix + idx, (args[0], args[1], *sp)):
        dst[: S - k] = src[k:S]
    dout, dring = ffd.ffd_solve_ckpt(*args, **kw)
    inits = {"sparse": ffd.FFDState(*(f[slot] for f in cring.states)),
             "dense": ffd.FFDState(*(f[slot] for f in dring.states))}
    before = {name: [t.clone() for t in st] for name, st in inits.items()}
    r_s, rr_s = ffd.ffd_resume_sparse(inits["sparse"], *idx, *suffix, *args[2:], **kw)
    torch.cuda.synchronize()
    pr, prr = ffd.ffd_resume_sparse_plain(inits["sparse"], *idx, *suffix, *args[2:], **kw)
    err_r = max_abs_err(_scan_outputs(r_s) + [*rr_s.states, rr_s.prefix],
                        _scan_outputs(pr) + [*prr.states, prr.prefix])
    assert err_r == 0, f"ffd_ckpt_sparse_{tag}_scan resume disagrees with the plain resume ({err_r})"
    r_sd, _ = ffd.ffd_resume_sparse(inits["dense"], *idx, *suffix, *args[2:], **kw)
    r_ds, _ = ffd.ffd_resume(inits["sparse"], *suffix, *args[2:], **kw)
    torch.cuda.synchronize()
    err_x = max(max_abs_err(list(r.state), list(cout.state)) for r in (r_s, r_sd, r_ds))
    assert err_x == 0, f"a resume across ring forms differs from the cold carry ({err_x})"
    for name, st in inits.items():
        assert max_abs_err(list(st), before[name]) == 0, "a resume wrote into its checkpoint"
    res.update(err_resume=err_r, err_cross=err_x, k=k, S=S, Sp2=Sp2, init=inits["sparse"],
               suffix=suffix, idx=idx)
    return res


def sparse_ladder_check(ph, dev):
    """K6s against its plain version and the dense K6's outputs (ph, from
    ladder_phase) with the union index tables the backend builds."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    S_orig = len(ph["enc"].run_group)
    sp = sparse_tables(ph["enc"], ph["dims"]["Sp"], dev,
                       run_ladder=ph["lad"].cpu().numpy()[:S_orig])
    kw = dict(max_claims=ph["M"], zone_engine=ph["zone"])
    out = ffd.ffd_solve_ladder_sparse(ph["lad"], *sp, *ph["args"], **kw)
    torch.cuda.synchronize()
    ref = ffd.ffd_solve_ladder_sparse_plain(ph["lad"], *sp, *ph["args"], **kw)
    fields = lambda o: [o.take_e, o.take_c, o.leftover, o.events, o.attempts, *o.state]  # noqa: E731
    err = max_abs_err(fields(out), fields(ref))
    name = f"ffd_ladder_sparse_{'zoned' if ph['zone'] else 'fast'}_scan"
    assert err == 0, f"{name} disagrees with its plain version (max |d| {err})"
    err_dense = max_abs_err(fields(out), fields(ph["out"]))
    assert err_dense == 0, f"{name} disagrees with the dense K6 ({err_dense})"
    return dict(name=name, err=err, err_dense=err_dense, sp=sp, out=out,
                attempts=int(out.attempts))


def pack_check(out, big: bool = False):
    """The dense output pack against its plain version, word for word, on
    `out`; with `big` one take set past 65535 (the overflow flag)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    take_e = out.take_e
    if big:
        take_e = take_e.clone()
        take_e.view(-1)[-1] = 70_000
    got = ffd.pack_outputs(take_e, out.take_c, out.leftover, out.state)
    torch.cuda.synchronize()
    want = ffd.pack_outputs_plain(take_e, out.take_c, out.leftover, out.state)
    err = max_abs_err([got], [want])
    assert err == 0 and int(got[0]) == int(big), f"pack_outputs disagrees with its plain version ({err})"
    return dict(err=err, words=int(got.numel()), flag=int(got[0]))


def unpack_check(host_arrays, dev, raw=None):
    """K8 against its plain version (both on the card) on the arena's
    packing of `host_arrays` (`raw`: the packed bytes to use instead),
    byte for byte, and against the arrays themselves when `raw` is None."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver.convert import args_to_torch
    from karpenter_tpu_torch.solver.cuda import arena

    parts, nbytes, specs = arena.pack(host_arrays)
    buf = torch.from_numpy(np.concatenate(parts) if raw is None else raw).to(dev)
    got = arena.unpack(buf, specs)
    torch.cuda.synchronize()
    want = arena.unpack_plain(buf, specs)
    assert all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want))
    err = max_abs_err(got, want)
    if raw is None:
        err = max(err, max_abs_err(got, args_to_torch(host_arrays, dev)))
    assert err == 0, f"arena_unpack disagrees with its plain version (max |d| {err})"
    return dict(buf=buf, specs=specs, nbytes=nbytes, segments=len(specs), err=err)


def adversarial_arrays(seed: int):
    """Seeded arrays of every ARG_SPEC dtype with odd-sized bool tables in
    front of int32/uint32 entries (unaligned offsets), and the packed bytes
    with every bool byte redrawn from 0..255."""
    import numpy as np

    from karpenter_tpu_torch.solver.cuda import arena

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(24):
        shape = tuple(int(x) for x in rng.integers(1, 40, size=int(rng.integers(1, 4))))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32))
        elif kind == 1:
            out.append(rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32))
        else:
            out.append(rng.random(shape) < 0.5)
        out.append(rng.random((2 * int(rng.integers(0, 40)) + 1,)) < 0.5)
    parts, _, specs = arena.pack(out)
    raw = np.concatenate(parts)
    for off, shape, dstr in specs:
        if dstr == "|b1":
            nb = int(np.prod(shape))
            raw[off : off + nb] = rng.integers(0, 256, size=nb, dtype=np.uint8)
    return out, raw


def ckpt_kernel_rows(checks, launches, ops_per_s, solves, phases):
    """The K7 rows: each instance at its cell's shapes (fast at the surge,
    zoned at config 3) with K=16, n=4 — its ring's bytes written beside
    K1's traffic in the bound — and its resume at the suffix of the check,
    with K1's time in the same call beside it."""
    from karpenter_tpu_torch.solver.cuda import ffd

    src = "karpenter_tpu_torch/csrc/ffd_kernels.cu"
    rows = []
    for c, kname, k1name in ((checks["surge_K16"], KERNEL_NAMES[11], KERNEL_NAMES[0]),
                             (checks["config3_K16"], KERNEL_NAMES[12], KERNEL_NAMES[1])):
        ph = phases["surge" if c["name"] == "ffd_ckpt_fast_scan" else "config3"]
        args, M, zone = ph["args"], ph["M"], ph["zone"]
        kw = dict(max_claims=M, zone_engine=zone, ckpt_every=c["K"], n_ckpt=c["n"])
        ms = time_ms(lambda: ffd.ffd_solve_ckpt(*args, **kw), 10)
        k1_ms = time_ms(lambda: ffd.ffd_solve(*args, max_claims=M, zone_engine=zone), 10)
        plain_ms = time_ms(lambda: ffd.ffd_solve_ckpt_plain(*args, **kw), 1)
        dev_ms = profiled_ms(lambda: ffd.ffd_solve_ckpt(*args, **kw), 3, (kname,))
        k1_dev_ms = profiled_ms(lambda: ffd.ffd_solve(*args, max_claims=M, zone_engine=zone), 3,
                                (k1name,))
        init, suffix = c["init"], c["suffix"]
        resume = lambda: ffd.ffd_resume(init, *suffix, *args[2:], **kw)  # noqa: E731
        resume_ms = time_ms(resume, 10)
        resume_dev_ms = profiled_ms(resume, 3, (kname,))
        written = int((c["ring"].prefix >= 0).sum())
        ring_bytes = written * nbytes(*c["out"].state)
        bytes1, ops1 = scan_cost(ph)
        bms, by = bound(bytes1 + ring_bytes, ops1, ops_per_s)
        Sp, Ep = c["out"].take_e.shape
        rows.append(dict(
            name=c["name"], route="cuda", source=src,
            replaces="karpenter_tpu/solver/tpu/ffd.py:1975",
            launches=launches[c["name"]], max_abs_err=max(c["err"], c["err_resume"]), ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None, match=True,
            device_ms=dev_ms, launches_per_solve=launches[c["name"]] / solves[c["name"]],
            k1_ms=k1_ms, k1_device_ms=k1_dev_ms, snapshots=written, ring_bytes_written=ring_bytes,
            ring_bound_ms=ring_bytes / PEAK_BYTES_PER_S * 1e3, resume_ms=resume_ms,
            resume_device_ms=resume_dev_ms, resume_k=c["k"], resume_Sp2=c["Sp2"],
            also_replaces="karpenter_tpu/solver/tpu/ffd.py:2071 (ffd_resume)",
            shape=dict(Sp=Sp, Ep=Ep, M=M, T=int(c["out"].state.c_mask.shape[1]), K=c["K"],
                       n=c["n"]),
            ops=ops1, bytes=bytes1 + ring_bytes))
    return rows


def sparse_scan_cost(ph, sp):
    """scan_cost of `ph`'s solve through the sparse instance: its index
    tables read once besides the other inputs, and on every fast run the
    hostname allowance over the row's valid Q columns (a compare and a min)
    at each node row and each claim open before the run, and the V-count
    recording over its valid V columns per domain column (Kq / Kv of this
    run's data in place of Q / V). Returns (bytes, ops)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    b, ops = scan_cost(ph)
    args, out = ph["args"], ph["out"]
    Ep = out.take_e.shape[1]
    Z = args[ffd.ARG_INDEX["zone_col_mask"]].shape[0]
    used = int(out.state.used)
    first_run = (out.take_c.cpu()[:, :used] > 0).to(torch.int32).argmax(dim=0)
    v_owner = args[ffd.ARG_INDEX["v_owner"]].cpu()
    v_anti = args[ffd.ARG_INDEX["v_member"]].cpu() & (args[ffd.ARG_INDEX["v_kind"]].cpu() == 1)
    nq, nv = (sp[0].cpu() >= 0).sum(dim=1), (sp[1].cpu() >= 0).sum(dim=1)
    for s_, (g, cnt) in enumerate(zip(args[0].cpu().tolist(), args[1].cpu().tolist())):
        if cnt <= 0 or (ph["zone"] and bool(v_owner[g].any() | v_anti[g].any())):
            continue
        ops += (Ep + int((first_run < s_).sum())) * int(nq[s_]) * 2 + int(nv[s_]) * Z
    return b + nbytes(*sp), ops


def sparse_kernel_rows(checks, lchecks, phases, ladder, launches, relax_launches, ops_per_s):
    """The rows of the sparse instances (K1s and K7s fast at the surge's
    shapes with its all-padding tables, zoned at config 3's; K6s zoned at
    config3_soft's, fast at surge_pref's), each with the dense instance's
    time in the same call beside it (dense_ms / dense_device_ms)."""
    from karpenter_tpu_torch.solver.cuda import ffd

    src = "karpenter_tpu_torch/csrc/ffd_sparse_kernels.cu (ffd_kernels.cu, SPARSE=true)"
    rows = []
    for cell, k1s, k1, k7s, k7 in (("surge", 14, 0, 18, 11), ("config3", 15, 1, 19, 12)):
        c, ph = checks[cell], phases[cell]
        args, M, zone, sp = ph["args"], ph["M"], ph["zone"], c["sp"]
        b, ops = sparse_scan_cost(ph, sp)
        Sp, Ep = ph["out"].take_e.shape
        shape = dict(Sp=Sp, Ep=Ep, M=M, T=int(ph["out"].state.c_mask.shape[1]), Kq=c["Kq"],
                     Kv=c["Kv"], Q=int(args[ffd.ARG_INDEX["q_kind"]].shape[0]),
                     V=int(args[ffd.ARG_INDEX["v_kind"]].shape[0]))
        kw = dict(max_claims=M, zone_engine=zone)
        run1 = lambda: ffd.ffd_solve_sparse(*sp, *args, **kw)  # noqa: E731
        dense1 = lambda: ffd.ffd_solve(*args, **kw)  # noqa: E731
        bms, by = bound(b, ops, ops_per_s)
        name = c["name"]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces="karpenter_tpu/solver/tpu/ffd.py:2403",
            launches=launches[name], max_abs_err=max(c["err"], c["err_dense"]),
            ms=time_ms(run1, 10), plain_ms=time_ms(lambda: ffd.ffd_solve_sparse_plain(
                *sp, *args, **kw), 1), bound_ms=bms, bound_by=by, library_ms=None, match=True,
            device_ms=profiled_ms(run1, 3, (KERNEL_NAMES[k1s],)),
            dense_ms=time_ms(dense1, 10), dense_device_ms=profiled_ms(dense1, 3, (KERNEL_NAMES[k1],)),
            events=c["events"], shape=shape, ops=ops, bytes=b))
        ckw = dict(kw, ckpt_every=c["K"], n_ckpt=c["n"])
        run7 = lambda: ffd.ffd_solve_ckpt_sparse(*sp, *args, **ckw)  # noqa: E731
        dense7 = lambda: ffd.ffd_solve_ckpt(*args, **ckw)  # noqa: E731
        written = int((c["cring"].prefix >= 0).sum())
        ring_bytes = written * nbytes(*c["cout"].state)
        bms7, by7 = bound(b + ring_bytes, ops, ops_per_s)
        name7 = name.replace("ffd_sparse", "ffd_ckpt_sparse")
        row = dict(
            name=name7, route="cuda", source=src, replaces="karpenter_tpu/solver/tpu/ffd.py:2500",
            also_replaces="karpenter_tpu/solver/tpu/ffd.py:2602 (ffd_resume_sparse)",
            launches=launches[name7], max_abs_err=max(c["err_ckpt"], c.get("err_resume", 0),
                                                      c.get("err_cross", 0)),
            ms=time_ms(run7, 10), plain_ms=time_ms(lambda: ffd.ffd_solve_ckpt_sparse_plain(
                *sp, *args, **ckw), 1), bound_ms=bms7, bound_by=by7, library_ms=None, match=True,
            device_ms=profiled_ms(run7, 3, (KERNEL_NAMES[k7s],)),
            dense_ms=time_ms(dense7, 10), dense_device_ms=profiled_ms(dense7, 3, (KERNEL_NAMES[k7],)),
            snapshots=written, ring_bytes_written=ring_bytes, shape=dict(shape, K=c["K"], n=c["n"]),
            ops=ops, bytes=b + ring_bytes)
        if "init" in c:
            resume = lambda: ffd.ffd_resume_sparse(  # noqa: E731
                c["init"], *c["idx"], *c["suffix"], *args[2:], **ckw)
            row.update(resume_ms=time_ms(resume, 10),
                       resume_device_ms=profiled_ms(resume, 3, (KERNEL_NAMES[k7s],)),
                       resume_k=c["k"], resume_Sp2=c["Sp2"])
        rows.append(row)
    for cell, k6s, k6 in (("surge_pref", 16, 9), ("config3_soft", 17, 10)):
        c, ph = lchecks[cell], ladder[cell]
        kw = dict(max_claims=ph["M"], zone_engine=ph["zone"])
        run6 = lambda: ffd.ffd_solve_ladder_sparse(ph["lad"], *c["sp"], *ph["args"], **kw)  # noqa: E731
        dense6 = lambda: ffd.ffd_solve_ladder(ph["lad"], *ph["args"], **kw)  # noqa: E731
        b, ops = ladder_cost(ph)
        b += nbytes(*c["sp"])
        bms, by = bound(b, ops, ops_per_s)
        Sp, Ep = ph["out"].take_e.shape
        rows.append(dict(
            name=c["name"], route="cuda", source=src,
            replaces="karpenter_tpu/solver/tpu/ffd.py:2701",
            launches=relax_launches[c["name"]], max_abs_err=max(c["err"], c["err_dense"]),
            ms=time_ms(run6, 10), plain_ms=time_ms(lambda: ffd.ffd_solve_ladder_sparse_plain(
                ph["lad"], *c["sp"], *ph["args"], **kw), 1),
            bound_ms=bms, bound_by=by, library_ms=None, match=True,
            device_ms=profiled_ms(run6, 3, (KERNEL_NAMES[k6s],)),
            dense_ms=time_ms(dense6, 10), dense_device_ms=profiled_ms(dense6, 3, (KERNEL_NAMES[k6],)),
            attempts=c["attempts"], shape=dict(Sp=Sp, Ep=Ep, M=ph["M"], Kq=int(c["sp"][0].shape[1]),
                                               Kv=int(c["sp"][1].shape[1])),
            ops=ops, bytes=b))
    return rows


def pack_kernel_row(out, err, launches, ops_per_s):
    """The dense output pack's row at `out` (config 3's outputs): bound by
    its bytes (every input read once, the buffer written once); the
    yardstick is one device-to-device copy_ of the buffer's bytes
    (labelled: it moves the bytes, it does not pack)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    st = out.state
    fn = lambda: ffd.pack_outputs(out.take_e, out.take_c, out.leftover, st)  # noqa: E731
    buf = fn()
    moved = nbytes(out.take_e, out.take_c, out.leftover, st.c_mask, st.c_zc_bits, st.c_gbits,
                   st.c_pool, st.c_cum, st.used) + nbytes(buf)
    bms, by = bound(moved, 0, ops_per_s)
    dst = torch.empty_like(buf)
    Sp, Ep = out.take_e.shape
    return dict(
        name="pack_outputs", route="cuda", source="karpenter_tpu_torch/csrc/ffd_kernels.cu",
        replaces="karpenter_tpu/solver/backend.py:511", launches=launches["pack_outputs"],
        max_abs_err=err, ms=time_ms(fn, 50),
        plain_ms=time_ms(lambda: ffd.pack_outputs_plain(out.take_e, out.take_c, out.leftover, st), 10),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lambda: dst.copy_(buf), 50),
        library_call="torch.Tensor.copy_ device to device of the packed buffer's bytes "
        "(a yardstick: it moves the bytes, it does not pack)",
        match=err == 0, device_ms=profiled_ms(fn, 20, (KERNEL_NAMES[20],)),
        shape=dict(Sp=Sp, Ep=Ep, M=int(st.c_mask.shape[0]), T=int(st.c_mask.shape[1]),
                   words=int(buf.numel())), bytes=moved, ops=0)


def unpack_kernel_row(check, err, launches, solves, ops_per_s):
    """The K8 row at the surge's cold adopt (36 segments): bound by its
    bytes read and written; the yardstick is one device-to-device copy_ of
    the same bytes (labelled: it moves the bytes, it does not unpack)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import arena

    buf, specs = check["buf"], check["specs"]
    ms = time_ms(lambda: arena.unpack(buf, specs), 50)
    dev_ms = profiled_ms(lambda: arena.unpack(buf, specs), 20, (KERNEL_NAMES[13],))
    plain_ms = time_ms(lambda: arena.unpack_plain(buf, specs), 20)
    dst = torch.empty_like(buf)
    lib_ms = time_ms(lambda: dst.copy_(buf), 50)
    moved = 2 * check["nbytes"]
    bms, by = bound(moved, check["nbytes"], ops_per_s)
    return dict(
        name="arena_unpack", route="cuda", source="karpenter_tpu_torch/csrc/arena_kernels.cu",
        replaces="karpenter_tpu/solver/arena.py:230", launches=launches["arena_unpack"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, library_call="torch.Tensor.copy_ device to device of the same bytes "
        "(a yardstick: it moves the bytes, it does not unpack)",
        match=err == 0, device_ms=dev_ms, launches_per_solve=launches["arena_unpack"] / solves,
        shape=dict(nbytes=check["nbytes"], segments=check["segments"]), bytes=moved,
        ops=check["nbytes"])


RESUME_SOLVES = 20  # per cell: base, tail, base, ...


def resume_phase(cells, plain):
    """The arena-and-resume phase: per cell, TorchSolver() solves base and
    tail alternately, RESUME_SOLVES times, beside a resume=False solver on
    the same inputs. The reference planner (backend._plan_resume) resumes a
    solve from the donor's ring slot covering the most runs inside the
    shared prefix: every tail solve resumes from the base solve before it;
    a base solve after a resumed tail has no checkpoint inside its prefix
    (the resumed solve's ring covers only runs past its resume point) and
    runs cold, harvesting the ring the next tail resumes from. Asserts
    that, the runs skipped, decisions equal to the resume=False solver's and
    the plain path's, and the resumed solves' uploads: the stale run entry
    (one packed message) and the two suffix run arrays, and under the sparse
    gate (config3_tail) the two suffix index arrays (Sp2 x Kq and Sp2 x Kv
    int32, two messages), nothing else."""
    import statistics

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.cuda.ffd import ARG_INDEX
    from karpenter_tpu_torch.solver.encode import (
        encode,
        quantize_input,
        sparse_run_tables,
        use_sparse_constraints,
    )

    run_idx = {ARG_INDEX["run_group"], ARG_INDEX["run_count"]}
    out = {}
    for name, (base, tail) in cells.items():
        warm = tb.TorchSolver(max_claims=MAX_CLAIMS)
        cold = tb.TorchSolver(max_claims=MAX_CLAIMS, resume=False)
        rows = []
        for i in range(RESUME_SOLVES):
            inp = tail if i % 2 else base
            before = (warm.stats["resume_solves"], warm.stats["resume_runs_skipped"],
                      warm.stats["sparse_dispatches"])
            t0 = time.perf_counter()
            res = warm.solve(inp)
            ms = (time.perf_counter() - t0) * 1e3
            led, stale = dict(warm.ledger.solve), warm.arena.last_stale
            t0 = time.perf_counter()
            ref = cold.solve(inp)
            cold_ms = (time.perf_counter() - t0) * 1e3
            assert decisions(res) == decisions(ref), f"{name}[{i}]: resumed != resume=False"
            rows.append(dict(i=i, tail=bool(i % 2), ms=ms, cold_ms=cold_ms,
                             resumed=warm.stats["resume_solves"] - before[0],
                             k=warm.stats["resume_runs_skipped"] - before[1], h2d=led,
                             stale=list(stale),
                             sparse=warm.stats["sparse_dispatches"] - before[2]))
            if i == 1:
                last_res = res
        # the tail's runs: all but the last are the base's; the base's cold
        # ring covers what _ring_coverage says, the resume takes the most
        tenc = encode(quantize_input(tail))
        S = len(tenc.run_group)
        Sp = warm._bucket(S, 16, 16)
        k_want = max(c for c, _ in warm._ring_coverage(Sp, S, 0) if c <= S - 1)
        Sp2 = warm._bucket(S - k_want, 16, 16)
        gated = use_sparse_constraints(tenc)
        # the suffix index arrays' bytes (0 without the gate)
        idx_bytes = (4 * Sp2 * sum(t.shape[1] for t in sparse_run_tables(tenc, Sp))
                     if gated else 0)
        for r in rows:
            want_resume = r["tail"]
            assert r["resumed"] == int(want_resume), (name, r)
            assert r["sparse"] == int(gated), (name, r)
            if want_resume:
                assert r["k"] == k_want, (name, r, k_want)
                assert set(r["stale"]) <= run_idx and r["stale"], (name, r)
                assert r["h2d"]["h2d_bytes"] == (4 * (len(r["stale"]) * Sp + 2 * Sp2)
                                                 + idx_bytes), (name, r)
                assert r["h2d"]["h2d_arrays"] == len(r["stale"]) + 2 + 2 * gated
                assert r["h2d"]["h2d_msgs"] == 3 + 2 * gated
        assert decisions(last_res) == decisions(plain.solve(tail)), f"{name}: != the plain path"
        resumed = [r["ms"] for r in rows if r["resumed"]]
        cold_tail = [r["cold_ms"] for r in rows if r["tail"]]
        harvest = [r["ms"] for r in rows[2:] if not r["tail"]]
        out[name] = dict(
            pods=len(tail.pods), S=S, Sp=Sp, k=k_want, suffix_runs=S - k_want, Sp2=Sp2,
            sparse=gated, suffix_index_bytes=idx_bytes,
            resume_solves=warm.stats["resume_solves"],
            resume_runs_skipped=warm.stats["resume_runs_skipped"],
            resume_hit_rate=warm.resume_hit_rate,
            resumed_p50_ms=statistics.median(resumed),
            cold_tail_p50_ms=statistics.median(cold_tail),
            harvest_base_p50_ms=statistics.median(harvest),
            resumed_h2d=rows[-1]["h2d"] if rows[-1]["resumed"] else rows[-2]["h2d"],
            cold_tail_h2d=dict(cold.ledger.solve),
            arena_hit_rate=warm.ledger.arena_hit_rate, solves=rows)
    return out


# ---- scheduling classes and decision provenance (K10-K12) ------------------------

# class_contended: bench.py's gang fleet at 2 000 nodes (16 000 evictable
# priority-0 victims, 14 008 pending pods: a doomed 8-rank gang, 1 000 gangs
# of 8, 6 000 singletons); class_zone: the same fleet with every gang
# labelled for zone co-location (each gang's injected self-affinity is one
# zone sig: V > 1 000, held in the zoned scan's launch-sized shared rows)
CLASS_KW = dict(n_nodes=2_000, victims_per_node=8, n_high=6_000, n_gangs=1_000, gang_size=8)
CLASS_ZONE_GANGS = CLASS_KW["n_gangs"]
# class_zone's decisions are held against the CPU plain path on the same
# fleet cut to this many gangs (V > 250: past the zoned scan's old 128 static
# rows); the full fleet's CPU solve was most of the phase's plain check
CLASS_ZONE_CHECK_GANGS = 250
CLASS_REPEATS = 3  # timed class_contended solves, explain off
CLASS_EXPLAIN_REPEATS = 2  # then with the explain plane on
CLASS_BREAKDOWN_PASSES = 2
EXPLAIN_REPEATS = 10  # surge_e2e solves with explain on, and as many off
K11_NODES = 10_000  # the preemption planner's tables at BASELINE's fleet size
CLASS_KERNELS = ("gang_commit", "preemption_plan", "explain_pack")


def _on_card(arrays, dev):
    import numpy as np
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def gang_check(tables, dev) -> int:
    """K10 against its plain version on the card (both outputs exact)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    args = _on_card(tables, dev)
    got = ffd.gang_commit(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, ffd.gang_commit_plain(*args))
    assert err == 0, f"gang_commit disagrees with its plain version (max |d| {err})"
    return err


def plan_check(tables, pod_prio: int, dev):
    """K11 against its plain version on the card: (node index, error)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    args = _on_card(tables, dev)
    e, take = ffd.preemption_plan(*args, pod_prio)
    torch.cuda.synchronize()
    pe, ptake = ffd.preemption_plan_plain(*args, pod_prio)
    err = max_abs_err([e.reshape(1), take], [pe.reshape(1), ptake])
    assert err == 0, f"preemption_plan disagrees with its plain version (max |d| {err})"
    return int(e), err


def class_tables(seed: int):
    """Seeded gang-verdict and preemption-plan tables: (gang tables, plan
    tables, pod priority)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ng, s = int(rng.integers(1, 1500)), int(rng.integers(1, 16_000))
    gang = (rng.integers(0, 3, s).astype(np.int32), rng.integers(-1, ng, s).astype(np.int32),
            rng.integers(1, 9, ng).astype(np.int32), rng.integers(0, 9, ng).astype(np.int32))
    E, Vm, R = int(rng.integers(1, 3000)), int(rng.integers(1, 80)), int(rng.integers(1, 5))
    plan = (rng.integers(0, 3, (E, R)).astype(np.int32), rng.integers(0, 6, (E, Vm)).astype(np.int32),
            rng.integers(0, 3, (E, Vm, R)).astype(np.int32), rng.random((E, Vm)) < 0.7,
            rng.random(E) < (0.05 if seed % 2 else 0.9), rng.integers(1, 12, R).astype(np.int32))
    return gang, plan, int(rng.integers(0, 7))


def adversarial_class_tables():
    """Named edge tables: {name: ("gang", tables) | ("plan", tables, prio)}."""
    import numpy as np

    rng = np.random.default_rng(99)
    big = 2**30
    out = {
        # the per-gang sums pass 2**31 and wrap, as XLA's int32 segment sum
        "gang_wrap": ("gang", (np.full(64, big, np.int32), np.zeros(64, np.int32),
                               np.ones(2, np.int32), np.ones(2, np.int32))),
        # gangs at and past NG (JAX parks/drops them), negatives, min_ranks 0
        "gang_past_ng": ("gang", (np.ones(50, np.int32), np.arange(-5, 45, dtype=np.int32) % 13 - 3,
                                  np.ones(7, np.int32), np.array([0, 1, 2, 0, 3, 1, 0], np.int32))),
        "gang_min_ranks_0": ("gang", (np.ones(8, np.int32), np.zeros(8, np.int32),
                                      np.ones(1, np.int32), np.zeros(1, np.int32))),
        "gang_one_block_many_runs": ("gang", (rng.integers(0, 2, 70_000).astype(np.int32),
                                              rng.integers(-1, 3, 70_000).astype(np.int32),
                                              np.ones(3, np.int32), np.array([1, 9_000, 40_000], np.int32))),
    }
    E, Vm, R = 40, 8, 3
    base = (np.zeros((E, R), np.int32), np.zeros((E, Vm), np.int32), np.ones((E, Vm, R), np.int32),
            np.ones((E, Vm), bool), np.ones(E, bool), np.array([3, 3, 1], np.int32))
    # reclaims near 2**30 wrap the int32 prefix past 2**31 (the device legs
    # follow XLA's int32 cumsum there)
    wrap = list(base)
    wrap[2] = np.full((E, Vm, R), big, np.int32)
    wrap[0] = np.full((E, R), big, np.int32)
    out["plan_wrap"] = ("plan", tuple(wrap), 5)
    none_ok = list(base)
    none_ok[3] = np.zeros((E, Vm), bool)
    out["plan_all_ineligible"] = ("plan", tuple(none_ok), 5)
    no_node = list(base)
    no_node[4] = np.zeros(E, bool)
    out["plan_node_ok_false"] = ("plan", tuple(no_node), 5)
    fit0 = list(base)
    fit0[0] = np.zeros((E, R), np.int32)
    fit0[0][7] = 5
    fit0[4] = np.arange(E) >= 7
    out["plan_fit0_first"] = ("plan", tuple(fit0), 5)
    out["plan_E1_Vm1"] = ("plan", (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
                                    np.ones((1, 1, 1), np.int32), np.ones((1, 1), bool),
                                    np.ones(1, bool), np.ones(1, np.int32)), 1)
    wide = (np.zeros((E, 16), np.int32), rng.integers(0, 3, (E, 70)).astype(np.int32),
            rng.integers(0, 2, (E, 70, 16)).astype(np.int32), rng.random((E, 70)) < 0.8,
            np.ones(E, bool), np.full(16, 20, np.int32))
    out["plan_Vm70_R16"] = ("plan", wide, 3)
    return out


def class_kernel_checks(dev) -> dict:
    """K10 and K11 on 16 seeded tables and on the adversarial ones, and K11
    at K11_NODES nodes x 8 victims x R = 3 from build_victim_tensors on the
    class fleet scaled to BASELINE's 10k nodes (free capacity zeroed, so
    the plan must evict; then only the last node admits; then none).
    Returns the checks and the 10k tables for the K11 row."""
    import numpy as np

    from karpenter_tpu_torch.solver import scheduling_class as sc
    from karpenter_tpu_torch.utils.resources import PODS

    seeded = []
    for seed in range(16):
        gang, plan, prio = class_tables(seed)
        gang_check(gang, dev)
        e, _ = plan_check(plan, prio, dev)
        seeded.append((len(gang[0]), len(gang[2]), plan[1].shape, e))
    adversarial = {}
    for name, spec in adversarial_class_tables().items():
        if spec[0] == "gang":
            adversarial[name] = gang_check(spec[1], dev)
        else:
            adversarial[name] = plan_check(spec[1], spec[2], dev)
    assert adversarial["plan_node_ok_false"][0] == -1 and adversarial["plan_fit0_first"][0] == 7
    inp = build_class_input(n_nodes=K11_NODES, victims_per_node=8, n_high=1, n_gangs=0)
    rkeys = ["cpu", "memory", PODS]
    node_free, victim_prio, victim_req, victim_ok, _ = sc.build_victim_tensors(inp.nodes, rkeys)
    node_free[:] = 0
    need = np.array([1000, 1024, 1], np.int32)
    node_ok = np.ones(K11_NODES, bool)
    scaled = {}
    tables = (node_free, victim_prio, victim_req, victim_ok, node_ok, need)
    scaled["all_nodes"] = plan_check(tables, 100, dev)
    last = np.zeros(K11_NODES, bool)
    last[-1] = True
    scaled["last_node"] = plan_check(tables[:4] + (last, need), 100, dev)
    scaled["none"] = plan_check(tables[:4] + (np.zeros(K11_NODES, bool), need), 100, dev)
    assert [v[0] for v in scaled.values()] == [0, K11_NODES - 1, -1], scaled
    return dict(seeded=seeded, adversarial=adversarial, scaled=scaled, k11_tables=tables)


def explain_check(ph, dev, ks) -> dict:
    """K12 against its plain version on the card at the outputs of `ph`'s
    solve (kernel_phase), with the side tables TorchSolver builds
    (backend.explain_args), at each top_k of `ks`."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.convert import array_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd

    take_e = ph["out"].take_e
    Sp, Ep = take_e.shape
    side, E, G = tb.explain_args(ph["enc"], Sp, Ep)
    args = [take_e] + [array_to_torch(a, dev) for a in side]
    worst = 0
    for k in ks:
        got = ffd.explain_pack(*args, E, G, top_k=k)
        torch.cuda.synchronize()
        err = max_abs_err([got], [ffd.explain_pack_plain(*args, E, G, top_k=k)])
        assert err == 0, f"explain_pack disagrees with its plain version (top_k={k}, {err})"
        worst = max(worst, err)
    return dict(args=args, E=E, G=G, Sp=Sp, Ep=Ep, Gp=int(side[1].shape[0]), ks=list(ks), err=worst,
                side_bytes=int(sum(a.nbytes for a in side)))


def explain_record_check(inp, k: int) -> dict:
    """One cold TorchSolver() solve with the explain plane on: the record
    built from K12's wire equals the host-derived record (fingerprint)."""
    from karpenter_tpu_torch.obs import explain as obsexplain
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    obsexplain.configure(enabled=True, top_k=k)
    try:
        s = tb.TorchSolver(max_claims=MAX_CLAIMS)
        res = s.solve(inp)
    finally:
        obsexplain.configure(enabled=False)
    assert s.stats["explain_dispatches"] == 1 and hasattr(res, "_explain_table"), s.stats
    enc = encode(quantize_input(inp))
    dev_rec = obsexplain.build_record(enc, res, k=k, table=res._explain_table)
    host_rec = obsexplain.build_record(enc, res, k=k)
    fp = obsexplain.fingerprint(dev_rec)
    assert fp == obsexplain.fingerprint(host_rec), obsexplain.diff_records(host_rec, dev_rec)[:8]
    return dict(top_k=k, fingerprint=fp[:16], groups=dev_rec["n_groups"],
                rejected=sum(g["n_rejected"] for g in dev_rec["groups"]))


def class_decisions(res):
    """decisions() plus the class outputs: evictions and unschedulable gangs."""
    out = decisions(res)
    out["evictions"] = [(e.node_id, e.pod_uid, e.victim_priority, e.for_pod) for e in res.evictions]
    out["gangs_unschedulable"] = list(res.gangs_unschedulable)
    return out


class _Stages:
    """Host ms per named stage, summed over the calls it wraps."""

    def __init__(self):
        self.ms = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

        return timed


class ClassInstruments:
    """Wrap a ClassAwareSolver's stages for one or more solves: the inner
    solves, the gang pass (_first_failing_gang with its K10 call),
    build_victim_tensors, the node_ok loop (node_ok_mask), the planner's
    plan calls (host ms; device ms from CUDA events around each K11 call;
    the upload bytes of the device leg), _pack_rows. With `check`, every K10
    and K11 call is also held against its plain version on the same card
    tensors (the recording wrapper), and the first call's arguments kept."""

    def __init__(self, caw, check: bool = False):
        self.caw, self.check = caw, check
        self.stages = _Stages()
        self.events = {"gang_commit": [], "preemption_plan": []}
        self.first = {}
        self.calls = {"gang_commit": 0, "preemption_plan": 0}
        self.err = 0

    def __enter__(self):
        import types

        import torch

        from karpenter_tpu_torch.solver import scheduling_class as sc
        from karpenter_tpu_torch.solver.cuda import ffd

        st = self.stages
        inner = self.caw.inner
        self.saved = (inner, sc.build_victim_tensors, sc.node_ok_mask, sc._pack_rows,
                      sc.PLANNERS["device"], ffd.gang_commit, ffd.preemption_plan)
        self.caw.inner = types.SimpleNamespace(inner=inner, solve=st.wrap("inner_solves", inner.solve))
        self.caw._first_failing_gang = st.wrap("gang_pass", self.caw._first_failing_gang)
        sc.build_victim_tensors = st.wrap("build_victim_tensors", sc.build_victim_tensors)
        sc.node_ok_mask = st.wrap("node_ok_loop", sc.node_ok_mask)
        sc._pack_rows = st.wrap("pack_rows", sc._pack_rows)
        gang_fn, plan_fn = sc.PLANNERS["device"]
        sc.PLANNERS["device"] = (gang_fn, st.wrap("plan_calls", plan_fn))

        def on_card(name, kernel, plain):
            def call(*a):
                if name not in self.first:
                    self.first[name] = [t.clone() if hasattr(t, "clone") else t for t in a]
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = kernel(*a)
                e.record()
                self.events[name].append((s, e))
                self.calls[name] += 1
                if self.check:
                    torch.cuda.synchronize()
                    got = [out[0].reshape(-1), out[1]]
                    want = plain(*a)
                    self.err = max(self.err, max_abs_err(got, [want[0].reshape(-1), want[1]]))
                return out

            return call

        ffd.gang_commit = on_card("gang_commit", ffd.gang_commit, ffd.gang_commit_plain)
        ffd.preemption_plan = on_card("preemption_plan", ffd.preemption_plan,
                                      ffd.preemption_plan_plain)
        return self

    def __exit__(self, *exc):
        from karpenter_tpu_torch.solver import scheduling_class as sc
        from karpenter_tpu_torch.solver.cuda import ffd

        (self.caw.inner, sc.build_victim_tensors, sc.node_ok_mask, sc._pack_rows,
         sc.PLANNERS["device"], ffd.gang_commit, ffd.preemption_plan) = self.saved
        del self.caw._first_failing_gang

    def device_ms(self, name) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[name])


def class_breakdown(caw, inp, passes: int) -> dict:
    """Median ms of a class_contended solve's stages over `passes` solves
    (ClassInstruments; rest = the solve minus the stages), with the device
    ms of its K10 and K11 calls and the device leg's transfer per solve."""
    import statistics

    from karpenter_tpu_torch.solver import scheduling_class as sc

    rows = []
    for _ in range(passes):
        t0 = dict(sc.PLANNER_TRANSFER)
        with ClassInstruments(caw) as ins:
            ts = time.perf_counter()
            caw.solve(inp)
            solve_ms = (time.perf_counter() - ts) * 1e3
        row = dict(ins.stages.ms, solve=solve_ms,
                   plan_device=ins.device_ms("preemption_plan"),
                   gang_device=ins.device_ms("gang_commit"),
                   plan_calls_n=ins.calls["preemption_plan"], gang_calls_n=ins.calls["gang_commit"])
        for k in ("h2d_bytes", "d2h_bytes"):
            row[k] = sc.PLANNER_TRANSFER[k] - t0[k]
        row["rest"] = solve_ms - sum(ins.stages.ms.values())
        rows.append(row)
    return {f"{k}_ms" if not k.endswith(("_n", "bytes")) else k:
            statistics.median(r.get(k, 0.0) for r in rows) for k in rows[0]}


def class_kernel_rows(first, checks, ex, launches, per_solve, ops_per_s) -> list:
    """The K10, K11 and K12 rows: K10 at class_contended's first gang call
    (its yardstick torch index_add_ of the placed counts over the hot runs,
    which computes the sums and not the verdict); K11 at K11_NODES nodes
    (no PyTorch call finds a first fitting prefix); K12 at class_contended's
    cold inner solve at top_k 8 (no PyTorch call packs the table)."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    src = "karpenter_tpu_torch/csrc/class_kernels.cu"
    rows = []
    run_placed, run_gang, gang_size, min_ranks = first["gang_commit"]
    S, NG = int(run_placed.shape[0]), int(gang_size.shape[0])
    fn = lambda: ffd.gang_commit(run_placed, run_gang, gang_size, min_ranks)  # noqa: E731
    hot = (run_gang >= 0) & (run_gang < NG)
    idx, vals = run_gang[hot].to(torch.int64), run_placed[hot]
    moved = nbytes(run_placed, run_gang, min_ranks) + NG * 5
    bms, by = bound(moved, S + 2 * NG, ops_per_s)
    rows.append(dict(
        name="gang_commit", route="cuda", source=src,
        replaces="karpenter_tpu/solver/tpu/ffd.py:2953", launches=launches["gang_commit"],
        max_abs_err=checks["gang_err"], ms=time_ms(fn, 200),
        plain_ms=time_ms(lambda: ffd.gang_commit_plain(run_placed, run_gang, gang_size, min_ranks), 50),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.zeros(NG, dtype=torch.int32, device=run_placed.device)
                           .index_add_(0, idx, vals), 200),
        library_call="torch.zeros(NG).index_add_ of the placed counts over the hot runs "
        "(the per-gang sums, not the verdict)",
        match=checks["gang_err"] == 0, device_ms=profiled_ms(fn, 20, ("gang_commit_kernel",)),
        launches_per_solve=per_solve["gang_commit"], shape=dict(S=S, NG=NG), bytes=moved,
        ops=S + 2 * NG))
    tables = checks["k11_tables"]
    args = _on_card(tables, run_placed.device)
    E, Vm, R = tables[2].shape
    fn = lambda: ffd.preemption_plan(*args, 100)  # noqa: E731
    moved = nbytes(*args) + E * Vm + 4
    ops = 2 * E * Vm * R + E * R
    bms, by = bound(moved, ops, ops_per_s)
    rows.append(dict(
        name="preemption_plan", route="cuda", source=src,
        replaces="karpenter_tpu/solver/tpu/ffd.py:2969", launches=launches["preemption_plan"],
        max_abs_err=checks["plan_err"], ms=time_ms(fn, 200),
        plain_ms=time_ms(lambda: ffd.preemption_plan_plain(*args, 100), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
        library_call="none: no PyTorch call finds the first node whose shortest eligible victim "
        "prefix fits",
        match=checks["plan_err"] == 0,
        device_ms=profiled_ms(fn, 20, ("preempt_scan_kernel", "preempt_take_kernel")),
        launches_per_solve=per_solve["preemption_plan"], shape=dict(E=E, Vm=Vm, R=R),
        bytes=moved, ops=ops))
    a, E, G = ex["args"], ex["E"], ex["G"]
    fn = lambda: ffd.explain_pack(*a, E, G, top_k=8)  # noqa: E731
    out = fn()
    take_e = a[0]
    nnz = int((take_e != 0).sum())
    Rr = int(a[2].shape[1])
    moved = nbytes(*a) + nbytes(out)
    ops = nnz * (1 + 2 * Rr) + G * E * (2 * Rr + 3)
    bms, by = bound(moved, ops, ops_per_s)
    rows.append(dict(
        name="explain_pack", route="cuda", source=src,
        replaces="karpenter_tpu/solver/tpu/ffd.py:3096", launches=launches["explain_pack"],
        max_abs_err=ex["err"], ms=time_ms(fn, 100),
        plain_ms=time_ms(lambda: ffd.explain_pack_plain(*a, E, G, top_k=8), 10),
        bound_ms=bms, bound_by=by, library_ms=None,
        library_call="none: no PyTorch call computes the reason codes and packs the first "
        "top_k rejections",
        match=ex["err"] == 0,
        device_ms=profiled_ms(fn, 20, ("explain_sums_kernel", "explain_rows_kernel")),
        launches_per_solve=per_solve["explain_pack"],
        launches_per_surge_e2e_solve=per_solve["explain_pack_surge_e2e"],
        shape=dict(Sp=ex["Sp"], Ep=ex["Ep"], Gp=ex["Gp"], E=E, G=G, top_k=8, take_nnz=nnz),
        bytes=moved, ops=ops))
    return rows


def class_phase(inp, inp_zone, inp_zone_check, surge_e2e, plain_solver_cls) -> dict:
    """The class-aware main path through ClassAwareSolver(TorchSolver()),
    the launch counts reset just before and read just after: CLASS_REPEATS
    timed class_contended solves (explain off), CLASS_EXPLAIN_REPEATS with
    the explain plane on, the class_zone solve once, and surge_e2e through
    TorchSolver() EXPLAIN_REPEATS times with explain on and as many off, in
    turns. Then, outside the counted window: the stage split, one solve
    with every K10/K11 call held against its plain version, and the
    decisions against ClassAwareSolver(TorchSolver(device="cpu")):
    class_contended's, and class_zone's on `inp_zone_check` (the fleet cut
    to CLASS_ZONE_CHECK_GANGS gangs, solved on the card here too)."""
    import torch

    from karpenter_tpu_torch.obs import explain as obsexplain
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import scheduling_class as sc

    solver = tb.TorchSolver(max_claims=MAX_CLAIMS)
    caw = sc.ClassAwareSolver(solver)
    ex_solver = tb.TorchSolver(max_claims=MAX_CLAIMS)
    caw.solve(inp)  # warm: allocator, encode caches, uploads
    ex_solver.solve(surge_e2e)
    stats0 = dict(caw.class_stats)
    for k in sc.PLANNER_TRANSFER:
        sc.PLANNER_TRANSFER[k] = 0
    watch = GcWatch()
    reset_launches()
    samples, ex_samples, results = [], [], []
    for i in range(CLASS_REPEATS + CLASS_EXPLAIN_REPEATS):
        obsexplain.configure(enabled=i >= CLASS_REPEATS)
        watch.reset()
        t0 = time.perf_counter()
        res = caw.solve(inp)
        ms = (time.perf_counter() - t0) * 1e3
        (samples if i < CLASS_REPEATS else ex_samples).append((ms, watch.ms, list(watch.collections)))
        results.append(class_decisions(res))
    transfer = dict(sc.PLANNER_TRANSFER)
    class_ex_dispatches = solver.stats["explain_dispatches"]
    obsexplain.configure(enabled=False)
    zstats0 = dict(caw.class_stats)
    ladder0 = solver.stats["ladder_solves"]
    t0 = time.perf_counter()
    res_zone = caw.solve(inp_zone)
    zone_ms = (time.perf_counter() - t0) * 1e3
    zone_declines = caw.class_stats["declines"] - zstats0["declines"]
    zone_ladders = solver.stats["ladder_solves"] - ladder0
    on_ms, off_ms, on_d2h, off_d2h = [], [], [], []
    for i in range(EXPLAIN_REPEATS):
        for on in (False, True):
            obsexplain.configure(enabled=on)
            t0 = time.perf_counter()
            r = ex_solver.solve(surge_e2e)
            (on_ms if on else off_ms).append((time.perf_counter() - t0) * 1e3)
            (on_d2h if on else off_d2h).append(ex_solver.ledger.solve["d2h_bytes"])
            assert on == hasattr(r, "_explain_table"), "explain table missing / unexpected"
    obsexplain.configure(enabled=False)
    torch.cuda.synchronize()
    launches = read_launches()
    watch.close()
    for k in CLASS_KERNELS:
        assert launches[k] > 0, f"kernel {k} never launched on the class path"
    n_class = CLASS_REPEATS + CLASS_EXPLAIN_REPEATS
    per_solve = {k: (zstats0[k] - stats0[k]) / n_class for k in stats0}
    assert all(r == results[0] for r in results), "class_contended decisions vary across solves"
    assert per_solve["gang_rounds"] == 1 and per_solve["gangs_unschedulable"] == 1, per_solve
    assert per_solve["preemptions"] == len(results[0]["evictions"]) > 0, per_solve
    assert zone_declines == 1 and res_zone.evictions == [] and zone_ladders >= 1, (
        zone_declines, zone_ladders)
    assert class_ex_dispatches == 2 * CLASS_EXPLAIN_REPEATS, class_ex_dispatches
    # stage split and the recording check, outside the counted window
    stages = class_breakdown(caw, inp, CLASS_BREAKDOWN_PASSES)
    with ClassInstruments(caw, check=True) as rec:
        res_rec = caw.solve(inp)
    assert rec.err == 0, f"a class kernel disagrees with its plain version ({rec.err})"
    assert class_decisions(res_rec) == results[0]
    t0 = time.perf_counter()
    cpu = sc.ClassAwareSolver(plain_solver_cls(device="cpu", max_claims=MAX_CLAIMS))
    assert class_decisions(cpu.solve(inp)) == results[0], "class_contended: decisions differ from the plain path"
    assert {k: cpu.class_stats[k] for k in per_solve} == per_solve, (cpu.class_stats, per_solve)
    res_check = caw.solve(inp_zone_check)
    res_zone_cpu = sc.ClassAwareSolver(
        plain_solver_cls(device="cpu", max_claims=MAX_CLAIMS)).solve(inp_zone_check)
    assert class_decisions(res_zone_cpu) == class_decisions(res_check), \
        "class_zone: decisions differ from the plain path"
    plain_s = time.perf_counter() - t0
    n_plan = launches["preemption_plan"]
    return dict(
        samples=samples, tail=tail(samples), explain_tail=tail(ex_samples), launches=launches,
        per_solve_launches={"gang_commit": launches["gang_commit"] / (n_class + 1),
                            "preemption_plan": n_plan / n_class,
                            "explain_pack": class_ex_dispatches / CLASS_EXPLAIN_REPEATS,
                            "explain_pack_surge_e2e": (launches["explain_pack"]
                                                       - class_ex_dispatches) / EXPLAIN_REPEATS},
        class_stats_per_solve=per_solve, stages=stages, planner_transfer_per_solve={
            k: v / n_class for k, v in transfer.items()},
        unplaced=len(results[0]["errors"]), evictions=len(results[0]["evictions"]),
        claims=len(results[0]["claims"]), pods=len(inp.pods), nodes=len(inp.nodes),
        gangs_unschedulable=results[0]["gangs_unschedulable"],
        zone=dict(ms=zone_ms, pods=len(inp_zone.pods), gangs=CLASS_ZONE_GANGS,
                  declines=zone_declines, ladder_solves=zone_ladders,
                  unplaced=len(res_zone.errors), plain_check_gangs=CLASS_ZONE_CHECK_GANGS,
                  equal_to_plain=True),
        explain_surge_e2e=dict(on_p50_ms=pct(on_ms, 50), off_p50_ms=pct(off_ms, 50),
                               on_ms=on_ms, off_ms=off_ms, on_d2h_bytes=on_d2h[-1],
                               off_d2h_bytes=off_d2h[-1], wire_bytes=on_d2h[-1] - off_d2h[-1]),
        recorded=dict(calls=rec.calls, err=rec.err,
                      shapes={k: [list(t.shape) for t in v if hasattr(t, "shape")]
                              for k, v in rec.first.items()}),
        first=rec.first, plain_check_s=plain_s)


# ---- the convex backend (K13 admm_pack) ----------------------------------------------

# convex_e2e: ConvexSolver(TorchSolver()) on the surge with 200 existing nodes,
# cut to CONVEX_E2E_PODS pods from 50 000 (the reference's rounding is a Python
# loop over pods x open claims)
CONVEX_E2E_PODS = 5_000
CONVEX_E2E_REPEATS = 5
CONVEX_TOL = 1e-3  # ConvexSolver's default tolerance (and max_iters 400)
CONVEX_KERNELS = ("admm_pack", "arena_unpack")
# K13 against its plain version (both on the card): X within admm_x_limit
# of the table (ADMM_X_REL of the plain X's largest cell, at most ADMM_X_TOL
# and at least ADMM_X_FLOOR: at config 5 X's cells are ~1/Np, so a fixed
# limit would hold them only loosely) and the latch equal (or, where it differs, the two residuals at the earlier
# latch on either side of tol, and within ADMM_RESID_NOISE of each other
# unless the plain latch itself moves under the few-ulp change below), at
# the longest horizon at which the plain
# version agrees with itself within ADMM_SENS_TOL when every float input is
# scaled by 1 + 2^-22: past it the damped dynamics are on a limit cycle, and
# the last-bit differences of exp and of the sums' order grow to O(0.1) in X
# (tests/test_torch_convex.py holds the plain version to JAX by the same rule)
ADMM_X_TOL = 1e-4
ADMM_X_REL = 1e-3
ADMM_X_FLOOR = 1e-7
ADMM_SENS_TOL = 1e-5
ADMM_RESID_NOISE = 1e-6
ADMM_HORIZONS = (100, 25, 10)
# X is also held at each of these horizons below the compared one where the
# plain version agrees with itself as above: on a problem that settles to
# one fixed point whatever the schedule (config 5), only the transient shows
# a wrong step size, damping or overload term
ADMM_SHORT = (1, 2, 10, 25, 100)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, 700 W
# The JAX package's proposal on config 5: karpenter_tpu's
# ConvexSolver(TPUSolver()).consolidate_global on bench.py's
# build_config5_universe(10_000, 2_000) with the candidates' pods pending and
# the candidates [(cand-j, 1.0, {cpj})], run once with JAX_PLATFORMS=cpu;
# sha256 of the sorted delete list joined by newlines
CONFIG5_CONVEX_FIXTURE = dict(
    delete=2_000, iterations=1,
    sha256="387d75d53bab5f97733043474d713902cc064c2e8b26557d7543997900a6d89e")


def admm_seeded(seed: int):
    """A padded admm_pack argument tuple (numpy) shaped like the backend's
    problems: sunk node columns, then priced columns with room; every real
    row keeps one priced column (tests/test_torch_convex.py's generator)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    S, N, R = int(rng.integers(1, 65)), int(rng.integers(2, 129)), int(rng.integers(1, 5))
    Sp, Np = max(16, -(-S // 16) * 16), max(16, -(-N // 16) * 16)
    E = int(rng.integers(0, N))
    req = np.zeros((Sp, R), np.float32)
    cnt = np.zeros(Sp, np.int32)
    req[:S] = rng.integers(1, 8, (S, R))
    cnt[:S] = rng.integers(1, 6, S)
    cap = np.zeros((Np, R), np.float32)
    cost = np.zeros(Np, np.float32)
    cap[:E] = rng.integers(0, 24, (E, R))
    cap[E:N] = rng.integers(16, 200, (N - E, R))
    cost[E:N] = rng.uniform(0.1, 2.0, N - E)
    feas = np.zeros((Sp, Np), bool)
    feas[:S, :N] = rng.random((S, N)) < rng.uniform(0.2, 0.9)
    feas[np.arange(S), rng.integers(E, N, S)] = True
    return req, cnt, cap, cost, feas


def admm_adversarial() -> dict:
    """(tables, tol, max_iters) that reach K13's edges: padding rows, a row
    with no feasible column, all-zero cost, tol 10 (latch 1) and 0 (latch
    -1), max_iters 1, R = 1 and R = 16, every row and column padding."""
    import numpy as np

    rng = np.random.default_rng(7)
    base = admm_seeded(3)
    out = {"padding_rows": (base, CONVEX_TOL, 400)}
    req, cnt, cap, cost, feas = (a.copy() for a in base)
    feas[1, :] = False
    out["row_without_column"] = ((req, cnt, cap, cost, feas), CONVEX_TOL, 400)
    out["zero_cost"] = ((base[0], base[1], base[2], np.zeros_like(base[3]), base[4]), CONVEX_TOL, 400)
    out["tol_10"] = (admm_seeded(5), 10.0, 30)
    out["tol_0"] = (admm_seeded(5), 0.0, 30)
    out["max_iters_1"] = (admm_seeded(11), CONVEX_TOL, 1)
    out["R1_16x16"] = ((rng.integers(1, 5, (16, 1)).astype(np.float32),
                        rng.integers(0, 4, 16).astype(np.int32),
                        rng.integers(0, 30, (16, 1)).astype(np.float32),
                        rng.uniform(0, 1, 16).astype(np.float32), rng.random((16, 16)) < 0.5),
                       CONVEX_TOL, 400)
    out["R16"] = ((rng.integers(1, 5, (32, 16)).astype(np.float32),
                   rng.integers(1, 4, 32).astype(np.int32),
                   rng.integers(20, 400, (48, 16)).astype(np.float32),
                   rng.uniform(0, 1, 48).astype(np.float32), rng.random((32, 48)) < 0.6),
                  CONVEX_TOL, 400)
    out["all_padding"] = ((np.zeros((16, 2), np.float32), np.zeros(16, np.int32),
                           np.zeros((16, 2), np.float32), np.zeros(16, np.float32),
                           np.zeros((16, 16), bool)), CONVEX_TOL, 400)
    return out


def admm_x_limit(X_plain) -> float:
    """The |dX| limit of K13 against its plain version on one table:
    ADMM_X_REL of the plain X's largest cell, within [ADMM_X_FLOOR,
    ADMM_X_TOL]."""
    top = float(X_plain.abs().max()) if X_plain.numel() else 0.0
    return min(ADMM_X_TOL, max(ADMM_X_FLOOR, ADMM_X_REL * top))


def hold_admm(args, tol, max_iters: int) -> dict:
    """K13 against its plain version on the same card tensors, at the
    longest horizon of (max_iters, then ADMM_HORIZONS below it) at which the
    plain version agrees with itself under a few-ulp input change (the last
    always): X within admm_x_limit there and at each ADMM_SHORT horizon
    below it, the latch equal, or split by tol where the two residuals at
    the earlier latch differ by float noise."""
    import torch

    from karpenter_tpu_torch.solver.cuda import convex as tcc

    def plain(a, k):
        return tcc.admm_pack_plain(*a, tol, k)

    f = 1 + 2**-22
    few = (args[0] * f, args[1], args[2] * f, args[3] * f, args[4])
    horizons = [max_iters] + [h for h in ADMM_HORIZONS if h < max_iters]
    for k in horizons:
        Xp, cp = plain(args, k)
        sens = 0.0
        if k != horizons[-1]:
            sens = float((plain(few, k)[0] - Xp).abs().max())
            if sens > ADMM_SENS_TOL:
                continue
        Xk, ck = tcc.admm_pack(*args, tol, max_iters=k)
        torch.cuda.synchronize()
        err = float((Xk - Xp).abs().max()) if Xk.numel() else 0.0
        ck, cp = int(ck), int(cp)
        limit = admm_x_limit(Xp)
        assert err <= limit, f"admm_pack disagrees with its plain version: |dX| {err} > {limit} at {k}"
        short = {}
        for h in (h for h in ADMM_SHORT if h < k):
            Xh = plain(args, h)[0]
            if float((plain(few, h)[0] - Xh).abs().max()) > ADMM_SENS_TOL:
                continue  # a chaotic transient (convex_e2e near its latch)
            e = float((tcc.admm_pack(*args, tol, max_iters=h)[0] - Xh).abs().max())
            short[h] = e
            assert e <= admm_x_limit(Xh), f"admm_pack disagrees with its plain version: |dX| {e} at {h}"
        split = None
        if ck != cp:
            # the earlier latch: the two residuals there lie on either side
            # of tol. Where the plain version's own latch moves under the
            # few-ulp change, the transient before convergence is chaotic
            # (the final X still agrees, above): then both must latch or
            # both not. Otherwise tol cuts through float noise: the two
            # residuals differ by at most ADMM_RESID_NOISE.
            it = min(c for c in (ck, cp) if c >= 1)

            def resid(fn):
                return float((fn(it) - fn(it - 1)).abs().max())

            rk = resid(lambda j: tcc.admm_pack(*args, tol, max_iters=j)[0])
            rp = resid(lambda j: plain(args, j)[0])
            c_few = int(plain(few, k)[1])
            split = dict(iteration=it, resid_kernel=rk, resid_plain=rp, conv_plain_few_ulps=c_few)
            assert min(rk, rp) < tol <= max(rk, rp), (ck, cp, split)
            if c_few == cp:
                assert abs(rk - rp) <= ADMM_RESID_NOISE, (ck, cp, split)
            else:
                assert (ck < 0) == (cp < 0), (ck, cp, split)
        return dict(horizon=k, max_iters=max_iters, err=err, limit=limit, sens=sens, conv=ck,
                    conv_plain=cp, short=short, latch_split=split, shape=list(Xk.shape))
    raise AssertionError("unreachable: the last horizon is always held")


def unpack_float_check(dev) -> dict:
    """K8 against its plain version and the arrays themselves, byte for
    byte, on a convex problem's segments (float32, int32, bool) behind an
    odd-sized bool table, so the float32 entries start unaligned."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver.cuda import arena

    arrays = [np.array([True, False, True]), *admm_seeded(3)]
    parts, nbytes, specs = arena.pack(arrays)
    buf = torch.from_numpy(np.concatenate(parts)).to(dev)
    got = arena.unpack(buf, specs)
    torch.cuda.synchronize()
    want = arena.unpack_plain(buf, specs)
    for a, g, w in zip(arrays, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes() == a.tobytes(), \
            "arena_unpack disagrees on a float32 segment"
    return dict(nbytes=nbytes, segments=len(specs), dtypes=sorted({d for _, _, d in specs}))


def admm_table_checks(dev) -> dict:
    """K13 on 20 seeded and 9 adversarial tables against its plain version;
    K8 on a convex problem's float32 segments."""
    import torch

    out = {"arena_unpack_float32": unpack_float_check(dev)}
    for seed in range(20):
        args = [torch.from_numpy(a).to(dev) for a in admm_seeded(seed)]
        out[f"seed{seed}"] = hold_admm(args, CONVEX_TOL, 400)
    for name, (tables, tol, iters) in admm_adversarial().items():
        args = [torch.from_numpy(a).to(dev) for a in tables]
        out[name] = hold_admm(args, tol, iters)
    assert out["tol_10"]["conv"] == 1 and out["tol_0"]["conv"] == -1, out
    return out


class AdmmRecorder:
    """Wrap solver/convex.py's admm_pack for one or more solves: CUDA events
    around each K13 call (device ms), the first call's arguments kept, and
    with `check` every call held against its plain version (hold_admm)."""

    def __init__(self, check: bool = False):
        self.check = check
        self.events, self.holds, self.first = [], [], None

    def __enter__(self):
        import torch

        from karpenter_tpu_torch.solver import convex as cv

        self.saved = cv.admm_pack

        def call(*args, max_iters):
            if self.first is None:
                self.first = (args, max_iters)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.saved(*args, max_iters=max_iters)
            e.record()
            self.events.append((s, e))
            if self.check:
                self.holds.append(hold_admm(args[:5], args[5], max_iters))
            return out

        cv.admm_pack = call
        return self

    def __exit__(self, *exc):
        from karpenter_tpu_torch.solver import convex as cv

        cv.admm_pack = self.saved

    def device_ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


class PlainConvex:
    """Route solver/convex.py's admm_pack to the plain version (on the
    card's tensors), for a reference decision through the same solver."""

    def __enter__(self):
        from karpenter_tpu_torch.solver import convex as cv
        from karpenter_tpu_torch.solver.cuda import convex as tcc

        self.saved = cv.admm_pack
        cv.admm_pack = lambda *a, max_iters: tcc.admm_pack_plain(*a, max_iters)
        return self

    def __exit__(self, *exc):
        from karpenter_tpu_torch.solver import convex as cv

        cv.admm_pack = self.saved


def _delete_digest(prop) -> dict:
    import hashlib

    d = sorted(prop["delete"])
    return dict(delete=len(d), iterations=prop["iterations"],
                sha256=hashlib.sha256("\n".join(d).encode()).hexdigest())


def _counting_dispatch(cvs):
    """Count a ConvexSolver's device dispatches (K13 calls)."""
    n = [0]
    inner = cvs._dispatch

    def counted(prob):
        n[0] += 1
        return inner(prob)

    cvs._dispatch = counted
    return n


def convex_phase(dev) -> dict:
    """The convex backend's main path, the launch counts reset just before
    and read just after: consolidate_global on config 5 (cold, then warm),
    the quality suite (uniform and rightsize against TorchSolver(), the
    split one-shot consolidation), and CONVEX_E2E_REPEATS timed solves of
    convex_e2e with the stage split. Then, outside the counted window: K13
    held against its plain version on every call of the same work, the
    config-5 proposal through the plain version, convex_e2e against
    ConvexSolver(TorchSolver(device="cpu")), and the kernel's row."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import convex as cv
    from karpenter_tpu_torch.solver.cuda import build
    from karpenter_tpu_torch.solver.cuda import convex as tcc

    inp5, cands5 = build_config5_consolidation()
    quality = {n: build_scenario(n) for n in ("uniform", "rightsize")}
    split_inp, split_cands = build_split_consolidation()
    e2e = build_e2e_input(CONVEX_E2E_PODS, NODES)

    def new_convex():
        return cv.ConvexSolver(tb.TorchSolver(max_claims=MAX_CLAIMS))

    ce = new_convex()
    ce.solve(e2e)  # warm: allocator, encode caches
    reset_launches()
    # config 5, cold then warm (the arena's second adopt uploads nothing)
    c5 = new_convex()
    n5 = _counting_dispatch(c5)
    st5 = _Stages()
    build_saved = cv._build_consolidate
    cv._build_consolidate = st5.wrap("build_consolidate", build_saved)
    try:
        c5.inner.ledger.begin_solve()
        t0 = time.perf_counter()
        prop5 = c5.consolidate_global(inp5, cands5)
        c5_ms = (time.perf_counter() - t0) * 1e3
        c5_cold = dict(c5.inner.ledger.solve)
        build_cold_ms = st5.ms["build_consolidate"]
        c5.inner.ledger.begin_solve()
        t0 = time.perf_counter()
        prop5b = c5.consolidate_global(inp5, cands5)
        c5_warm_ms = (time.perf_counter() - t0) * 1e3
        c5_warm = dict(c5.inner.ledger.solve)
    finally:
        cv._build_consolidate = build_saved
    got5 = _delete_digest(prop5)
    assert got5 == CONFIG5_CONVEX_FIXTURE, f"config 5 proposal {got5} != the JAX package's"
    assert _delete_digest(prop5b) == got5 and n5[0] == 2, (n5[0], prop5b["iterations"])
    assert c5_warm["h2d_bytes"] == 0, c5_warm
    # the quality suite (bench.py _quality_run)
    qual = {}
    for name, inp in quality.items():
        r_ffd = tb.TorchSolver(max_claims=MAX_CLAIMS).solve(inp)
        cq = new_convex()
        cq.solve(inp)
        t0 = time.perf_counter()
        r_cv = cq.solve(inp)
        ms = (time.perf_counter() - t0) * 1e3
        assert not r_ffd.errors and not r_cv.errors, name
        assert cq.convex_stats["convex_fallbacks"] == 0 and cq.convex_stats["convex_solves"] == 2
        qual[name] = dict(claims_ffd=len(r_ffd.claims), claims_convex=len(r_cv.claims),
                          solve_ms=ms, iterations=cq.convex_stats["admm_iterations"],
                          decisions=decisions(r_cv))
    assert (qual["uniform"]["claims_ffd"], qual["uniform"]["claims_convex"]) == (3, 3), qual
    assert (qual["rightsize"]["claims_ffd"], qual["rightsize"]["claims_convex"]) == (24, 6), qual
    cs = new_convex()
    ns = _counting_dispatch(cs)
    prop_split = cs.consolidate_global(split_inp, split_cands)
    assert prop_split is not None and len(prop_split["delete"]) == 3 and ns[0] == 1, prop_split
    # convex_e2e: timed solves with the stage split
    stages = _Stages()
    names = ("quantize_input", "encode", "_build_provision", "_round_provision",
             "check_invariants", "min_values_post_check")
    saved = {n: getattr(cv, n) for n in names}
    for n in names:
        setattr(cv, n, stages.wrap(n, saved[n]))
    watch = GcWatch()
    samples, e2e_res = [], []
    try:
        with AdmmRecorder() as rec_e2e:
            for _ in range(CONVEX_E2E_REPEATS):
                watch.reset()
                t0 = time.perf_counter()
                r = ce.solve(e2e)
                samples.append(((time.perf_counter() - t0) * 1e3, watch.ms, list(watch.collections)))
                e2e_res.append(decisions(r))
    finally:
        for n in names:
            setattr(cv, n, saved[n])
        watch.close()
    torch.cuda.synchronize()
    launches = read_launches()
    for k in CONVEX_KERNELS:
        assert launches[k] > 0, f"kernel {k} never launched on the convex path"
    assert all(r == e2e_res[0] for r in e2e_res), "convex_e2e decisions vary across solves"
    k13_e2e = rec_e2e.device_ms()
    n_e2e = CONVEX_E2E_REPEATS
    e2e_stages = {k: v / n_e2e for k, v in stages.ms.items()}
    e2e_stages["k13_device_ms"] = sum(k13_e2e) / n_e2e
    e2e_stages["solve_ms"] = sum(m for m, _, _ in samples) / n_e2e
    e2e_stages["rest_ms"] = e2e_stages["solve_ms"] - sum(stages.ms.values()) / n_e2e

    # ---- outside the counted window: K13 against its plain version ----
    with AdmmRecorder(check=True) as rec5:
        prop5c = c5.consolidate_global(inp5, cands5)
    assert _delete_digest(prop5c) == got5
    with PlainConvex():
        prop5p = new_convex().consolidate_global(inp5, cands5)
    assert _delete_digest(prop5p) == got5, "config 5: the plain version proposes otherwise"
    with AdmmRecorder(check=True) as recq:
        for name, inp in quality.items():
            r = new_convex().solve(inp)
            assert decisions(r) == qual[name]["decisions"], name
        assert new_convex().consolidate_global(split_inp, split_cands) == prop_split
    with AdmmRecorder(check=True) as rece:
        r = ce.solve(e2e)
    assert decisions(r) == e2e_res[0]
    t0 = time.perf_counter()
    cpu = cv.ConvexSolver(tb.TorchSolver(device="cpu", max_claims=MAX_CLAIMS))
    r_cpu = cpu.solve(e2e)
    cpu_s = time.perf_counter() - t0
    assert decisions(r_cpu) == e2e_res[0], "convex_e2e: decisions differ from the plain path"

    # ---- K13's row at config 5 ----
    args5, iters = rec5.first
    Sp, Np = args5[4].shape
    R = args5[0].shape[1]
    fn = lambda: tcc.admm_pack(*args5[:5], args5[5], max_iters=iters)  # noqa: E731
    k_ms = time_ms(fn, 5)
    p_ms = time_ms(lambda: tcc.admm_pack_plain(*args5[:5], args5[5], iters), 2)
    fn()
    torch.cuda.synchronize()
    # the kernels the runtime accepted in that call, counted by the launcher:
    # a prologue (ref, prep), a column load and a row update per iteration,
    # the latch tail
    per_call = build.load("convex_kernels").admm_launches()
    assert per_call == 2 + 2 * iters + (1 if iters else 0), (per_call, iters)
    dev_ms, traced = admm_device_ms(fn, per_call)
    assert traced is None or traced <= per_call, (traced, per_call)
    X5, _ = fn()
    cnt = args5[1].to(torch.float32)
    dn = args5[0] * cnt[:, None] / torch.clamp(args5[2].amax(dim=0), min=1.0)[None, :]
    mm_ms = time_ms(lambda: X5.T @ dn, 20)
    moved = iters * Sp * Np * 9 + nbytes(*args5[:4]) + Sp * Np + Sp * Np * 4
    ops = iters * Sp * Np * (4 * R + 17)
    bms, by = bound(moved, ops, PEAK_F32_OPS_PER_S)
    row = dict(
        name="admm_pack", route="cuda", source="karpenter_tpu_torch/csrc/convex_kernels.cu",
        replaces="karpenter_tpu/solver/convex.py:124", launches=launches["admm_pack"],
        max_abs_err=rec5.holds[0]["err"], ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
        library_ms=None,
        library_call="none (no PyTorch call computes an iteration); torch.matmul of X^T dn "
        "alone at config 5 in matmul_xt_dn_ms",
        matmul_xt_dn_ms=mm_ms, device_ms=dev_ms, ms_per_iteration=k_ms / max(iters, 1),
        cuda_launches_per_call=per_call, traced_kernels_per_call=traced,
        match=True, shape=dict(Sp=int(Sp), Np=int(Np), R=int(R), max_iters=iters),
        bytes=moved, ops=ops)
    holds = rec5.holds + recq.holds + rece.holds
    return dict(
        row=row,
        config5=dict(nodes=len(inp5.nodes), candidates=len(cands5), **got5,
                     dispatches_per_decision=n5[0] // 2, decision_ms_cold=c5_ms,
                     decision_ms_warm=c5_warm_ms, build_consolidate_ms=build_cold_ms,
                     h2d_cold=c5_cold, h2d_warm=c5_warm, k13=rec5.holds[0],
                     k13_device_ms_in_decision=rec5.device_ms()[0],
                     max_stay=max(prop5["stay_mass"].values())),
        quality={k: {f: v[f] for f in ("claims_ffd", "claims_convex", "solve_ms", "iterations")}
                 for k, v in qual.items()}
        | {"split": dict(deleted=len(prop_split["delete"]), dispatches=ns[0],
                         iterations=prop_split["iterations"])},
        e2e=dict(pods=len(e2e.pods), nodes=len(e2e.nodes), **tail(samples),
                 claims=len(e2e_res[0]["claims"]), unplaced=len(e2e_res[0]["errors"]),
                 iterations=ce.convex_stats["admm_iterations"], stages=e2e_stages,
                 convex_stats=dict(ce.convex_stats), cpu_solve_s=cpu_s, equal_to_plain=True,
                 cpu_iterations=cpu.convex_stats["admm_iterations"], k13=rece.holds[0]),
        launches=launches,
        holds=dict(calls=len(holds), worst_err=max(h["err"] for h in holds),
                   horizons=sorted({h["horizon"] for h in holds})),
        fallbacks=sum(c.convex_stats["convex_fallbacks"] for c in (c5, ce, cs)))


def admm_device_ms(fn, whole: int, tries: int = 6):
    """(device ms, kernels traced) of one K13 call: the sum of its kernels'
    times in a torch.profiler trace of the call and the number of its kernel
    events there, from the first trace that holds all `whole` launches, else
    from the fullest of `tries` traces; (None, None) when none shows them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        hits = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and "admm_" in e.name]
        if len(hits) > len(best):
            best = hits
        if len(best) >= whole:
            break
    return (sum(best) / 1e3, len(best)) if best else (None, None)


# ---- the serving pipeline: fused cohorts and streaming staging (K14-K16) ------------
#
# cohort_surge: 8 tenants (t0..t7: bench.py _tenant_run's tenants and
# TenantMux's default cohort_max), member i the surge at PODS + 3 (i % 3)
# pods (bench.py _tenant_pass's churn inputs at the surge's size), through
# SolveService(TorchSolver()).submit_cohort and solve_cohort_async directly,
# beside the same 8 solves submitted solo (an arena of 4 buckets, the
# default, and one of 8); cohort_config3: the same members
# at BASELINE config 3 (the zoned lanes); cohort_pad: 5 members padded to 8
# lanes; surge_stream: TorchSolver() with stream_run_events on, the surge
# alternating with the surge less one pod of its first deployment
COHORT_MEMBERS = 8
COHORT_DISPATCHES = 20  # per route
COHORT_SOLO_ROUNDS = 10  # rounds of the same 8 solves submitted solo, beside them
COHORT_CONFIG3_DISPATCHES = 3
COHORT_PAD_MEMBERS = 5
STREAM_SOLVES = 20
LANES_CHECK_B = (1, 2, 8)
COHORT_KERNELS = ("ffd_lanes_fast_scan", "ffd_lanes_zoned_scan", "pad_lanes", "apply_events")
TICKET_TIMEOUT_S = 600  # any one ticket of phase 9


def cohort_members(bases, n: int, prefix: str):
    """n members over the distinct `bases`, member i base i % len(bases),
    each its own tenant."""
    import dataclasses

    return [dataclasses.replace(bases[i % len(bases)], tenant_id=f"{prefix}{i}") for i in range(n)]


def lanes_args(members, dev):
    """The members' kernel arguments stacked lane-major, as the cohort
    dispatch stacks them: (host arrays, tensors on `dev`, claim bucket,
    zone_engine)."""
    import numpy as np

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.convert import args_to_torch
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    hosts, totals, zones = [], [], set()
    for m in members:
        enc = encode(quantize_input(m))
        hosts.append(tb.host_kernel_args(enc, tb.TorchSolver._bucket)[0])
        totals.append(int(sum(len(p) for p in enc.group_pods)))
        zones.add(bool(enc.V > 0))
    assert len(zones) == 1 and all(
        tuple(a.shape for a in h) == tuple(a.shape for a in hosts[0]) for h in hosts)
    stacked = tuple(np.stack([h[j] for h in hosts]) for j in range(len(hosts[0])))
    M = tb.initial_claim_bucket(max(totals), MAX_CLAIMS)
    return stacked, args_to_torch(stacked, dev), M, zones.pop()


def lanes_check(members, dev) -> dict:
    """K15 against its plain version (ffd_solve_plain on every lane, on the
    card) and against K1 on each lane alone, at the members' stacked
    arguments; the claim bucket doubles while a lane saturates it."""
    import torch

    from karpenter_tpu_torch.solver.cuda import ffd

    host, args, M, zone = lanes_args(members, dev)
    while True:
        out = ffd.ffd_solve_lanes(*args, max_claims=M, zone_engine=zone)
        torch.cuda.synchronize()
        if int(out.state.used.max()) < M or M >= MAX_CLAIMS:
            break
        M = min(2 * M, MAX_CLAIMS)
    t0 = time.perf_counter()
    plain = ffd.ffd_solve_lanes_plain(*args, max_claims=M, zone_engine=zone)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max_abs_err(_scan_outputs(out), _scan_outputs(plain))
    name = f"ffd_lanes_{'zoned' if zone else 'fast'}_scan"
    assert err == 0, f"{name} disagrees with its plain version (max |d| {err})"
    err_k1 = 0
    for b in range(len(members)):
        k1 = ffd.ffd_solve(*(a[b] for a in args), max_claims=M, zone_engine=zone)
        err_k1 = max(err_k1, max_abs_err(_scan_outputs(ffd.output_lane(out, b)),
                                         _scan_outputs(k1)))
    assert err_k1 == 0, f"{name} disagrees with K1 on a lane (max |d| {err_k1})"
    return dict(args=args, out=out, M=M, zone=zone, B=len(members), err=err, err_k1=err_k1,
                events=[int(e) for e in out.events.tolist()], plain_once_s=plain_s,
                used=[int(u) for u in out.state.used.tolist()])


def pad_check(members, dev, batch: int = 8) -> dict:
    """K16 against its plain version on the 36 arena-resident arrays of
    the members' stack (adopted as the cohort dispatch adopts them),
    padded to `batch` lanes: byte for byte."""
    import torch

    from karpenter_tpu_torch.solver.arena import ArgumentArena
    from karpenter_tpu_torch.solver.cuda import arena

    host, _args, _M, _zone = lanes_args(members, dev)
    adopted = ArgumentArena(device=dev).adopt(host, (None,) * len(host), ns="__cohort__")
    out = arena.pad_lanes(adopted, batch)
    torch.cuda.synchronize()
    plain = arena.pad_lanes_plain(adopted, batch)
    err = max_abs_err(out, plain)
    assert err == 0, f"pad_lanes disagrees with its plain version (max |d| {err})"
    for a, o in zip(adopted, out):
        assert tuple(o.shape) == (batch,) + tuple(a.shape[1:]) and o.dtype == a.dtype
    return dict(adopted=adopted, out=out, batch=batch, n=len(members), err=err,
                bytes_in=nbytes(*adopted), bytes_out=nbytes(*out), arrays=len(adopted))


def event_rows(seed: int, Sp: int, K: int):
    """K int32 (pos, gid, cnt) edit rows: unique positions in [0, Sp), then
    -1, Sp, Sp + 7 and EVENT_PAD_POS padding (tests/test_torch_stream.py's
    tables)."""
    import numpy as np

    from karpenter_tpu_torch.solver.cuda import ffd

    rng = np.random.default_rng(seed)
    n_in = min(max(0, K - 3), Sp)
    pos = list(rng.choice(Sp, size=n_in, replace=False)) + [-1, Sp, Sp + 7][: max(0, K - n_in)]
    pos += [ffd.EVENT_PAD_POS] * (K - len(pos))
    ev = np.zeros((K, ffd.EVENT_ENTRY_WORDS), dtype=np.int32)
    if K:
        ev[:, 0] = np.asarray(pos, dtype=np.int64)[rng.permutation(K)]
        ev[:, 1] = rng.integers(0, 1 << 20, K)
        ev[:, 2] = rng.integers(-5, 1 << 16, K)
    return rng.integers(0, 4000, Sp).astype(np.int32), rng.integers(0, 1 << 15, Sp).astype(
        np.int32), ev


def surge_less_one(inp):
    """The surge with its first pod gone: its deployment's run count drops
    by one, the shapes stay (one or two run-table edits a solve)."""
    import dataclasses

    return dataclasses.replace(inp, pods=list(inp.pods[1:]))


def events_check(surge, dev) -> dict:
    """K14 against its plain version (both on the card) on seeded tables
    (Sp 32 and 4 096, K 0, 8 and 1 024, out-of-range and pad rows) and on
    the surge's run tables with the edits of surge_less_one, padded to 8
    rows as the arena pads them."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import encode_cache as ec
    from karpenter_tpu_torch.solver.convert import array_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    def check(rg, rc, ev):
        t = [array_to_torch(x, dev) for x in (rg, rc, ev)]
        got = ffd.ffd_apply_events(*t)
        torch.cuda.synchronize()
        want = ffd.ffd_apply_events_plain(*t)
        assert t[0].cpu().numpy().tolist() == rg.tolist(), "apply_events wrote its input"
        return max_abs_err(got, want), t

    errs = {}
    for Sp in (32, 4096):
        for K in (0, 8, 1024):
            errs[f"Sp{Sp}_K{K}"] = check(*event_rows(Sp + K, Sp, K))[0]
    pairs = []
    for inp in (surge, surge_less_one(surge)):
        h = tb.host_kernel_args(encode(quantize_input(inp)), tb.TorchSolver._bucket)[0]
        pairs.append((h[0], h[1]))
    ev = ec.run_table_events(pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1])
    k = len(ev)
    pad = np.zeros((8 - k, ffd.EVENT_ENTRY_WORDS), np.int32)
    pad[:, 0] = ffd.EVENT_PAD_POS
    err, t = check(pairs[0][0], pairs[0][1], np.concatenate([ev, pad]))
    errs["surge"] = err
    assert max(errs.values()) == 0, f"apply_events disagrees with its plain version: {errs}"
    return dict(errs=errs, edits=k, tensors=t, pos=array_to_torch(ev[:, 0], dev).long(),
                gid=array_to_torch(ev[:, 1], dev), cnt=array_to_torch(ev[:, 2], dev),
                Sp=int(pairs[0][0].shape[0]))


def _ms_tail(ms) -> dict:
    return dict(n=len(ms), p50_ms=pct(ms, 50), p99_ms=pct(ms, 99), max_ms=max(ms), min_ms=min(ms))


def cohort_phase(surge_bases, c3_bases, plain) -> dict:
    """The pipeline's main path, the launch counts reset just before and
    read just after: cohort_surge (COHORT_DISPATCHES fused dispatches of 8
    members through SolveService.submit_cohort and as many through
    solve_cohort_async, then the same 8 solves submitted solo through a
    second service and through a third whose arena holds a bucket a
    tenant, COHORT_SOLO_ROUNDS times, with the bytes each round uploads),
    cohort_config3, cohort_pad
    and surge_stream. Every fused dispatch must carry all its members,
    every warm repeat upload nothing; decisions equal solo TorchSolver()
    solves, and the surge members' the CPU plain path's."""
    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.encode import encode, quantize_input
    from karpenter_tpu_torch.solver.pipeline import SolveService

    TorchSolver = tb.TorchSolver
    members = cohort_members(surge_bases, COHORT_MEMBERS, "t")
    c3_members = cohort_members(c3_bases, COHORT_MEMBERS, "c")
    fused = TorchSolver(max_claims=MAX_CLAIMS)
    solo = TorchSolver(max_claims=MAX_CLAIMS)
    # the solo baseline again with an arena of one bucket a tenant, so that
    # fused against solo compares fusion, not the solo arena's evictions
    wide = TorchSolver(max_claims=MAX_CLAIMS)
    wide.arena.max_buckets = COHORT_MEMBERS
    svc, solo_svc, wide_svc = SolveService(fused), SolveService(solo), SolveService(wide)
    # the decisions every member must reach: one solo solve per distinct base
    want = [decisions(solo.solve(b)) for b in surge_bases]
    want_c3 = [decisions(solo.solve(b)) for b in c3_bases]
    unfused = []

    def fused_round(route: str, group, expect):
        d0, m0 = fused.stats["fused_dispatches"], fused.stats["fused_members"]
        t0 = time.perf_counter()
        if route == "service":
            tickets = svc.submit_cohort([{"inp": m} for m in group])
            outs = [t.result(timeout=TICKET_TIMEOUT_S) for t in tickets]
        else:
            outs = fused.solve_cohort_async(group)()
        ms = (time.perf_counter() - t0) * 1e3
        bad = [o for o in outs if isinstance(o, BaseException)]
        assert not bad, bad
        n_d = fused.stats["fused_dispatches"] - d0
        n_m = fused.stats["fused_members"] - m0
        if (n_d, n_m) != (1, len(group)):
            # why: a member without a prep rides its solo path; the others
            # fuse only with members of their exact key
            why = {}
            for m in group:
                prep = fused._cohort_prep(m)
                why[m.tenant_id] = ("solo path (relax plan, fallback class or kernel limits)"
                                    if prep is None else f"fuse key {hash(prep['fkey'])}")
            unfused.append(dict(route=route, dispatches=n_d, members=n_m, why=why))
            print(json.dumps({"cohort_unfused": unfused[-1]}), flush=True)
        assert (n_d, n_m) == (1, len(group)), f"{route}: {n_d} fused dispatches of {n_m} members"
        for i, o in enumerate(outs):
            assert decisions(o) == expect[i % len(expect)], f"{route}: member {i} differs from solo"
        return ms, dict(fused.ledger.solve)

    try:
        # warm (outside the window): a cold cohort per route, a solo round
        cold = fused_round("service", members, want)[1]
        fused_round("direct", members, want)
        for m in members:
            solo_svc.submit(m).result(timeout=TICKET_TIMEOUT_S)
            wide_svc.submit(m).result(timeout=TICKET_TIMEOUT_S)
        torch.cuda.synchronize()
        reset_launches()
        service_ms, direct_ms, solo_ms, wide_ms, warm_h2d = [], [], [], [], []
        solo_h2d, wide_h2d = [], []
        for _ in range(COHORT_DISPATCHES):
            for route, acc in (("service", service_ms), ("direct", direct_ms)):
                ms, led = fused_round(route, members, want)
                acc.append(ms)
                warm_h2d.append(led["h2d_bytes"])
        for _ in range(COHORT_SOLO_ROUNDS):
            for service, backend, acc, h2d in ((solo_svc, solo, solo_ms, solo_h2d),
                                               (wide_svc, wide, wide_ms, wide_h2d)):
                b0 = backend.ledger.total["h2d_bytes"]
                t0 = time.perf_counter()
                tickets = [service.submit(m) for m in members]
                outs = [t.result(timeout=TICKET_TIMEOUT_S) for t in tickets]
                acc.append((time.perf_counter() - t0) * 1e3)
                h2d.append(backend.ledger.total["h2d_bytes"] - b0)
                for i, o in enumerate(outs):
                    assert decisions(o) == want[i % len(want)], f"solo member {i} differs"
        assert warm_h2d == [0] * len(warm_h2d), f"warm fused repeats uploaded {warm_h2d}"
        c3_ms = [fused_round("service", c3_members, want_c3)[0]
                 for _ in range(COHORT_CONFIG3_DISPATCHES)]
        # cohort_pad: 5 members pad to 8 lanes (K16) in a cold arena
        padder = TorchSolver(max_claims=MAX_CLAIMS)
        member_bytes = TorchSolver(max_claims=MAX_CLAIMS)
        member_bytes.solve(members[0])
        outs = padder.solve_cohort_async(members[:COHORT_PAD_MEMBERS])()
        assert padder.stats["fused_members"] == COHORT_PAD_MEMBERS, padder.stats
        for i, o in enumerate(outs):
            assert decisions(o) == want[i % len(want)], f"cohort_pad member {i} differs"
        pad_h2d = padder.ledger.solve["h2d_bytes"]
        assert pad_h2d == COHORT_PAD_MEMBERS * member_bytes.ledger.solve["h2d_bytes"], (
            pad_h2d, member_bytes.ledger.solve)
        stream = stream_phase(surge_bases[0])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        svc.close()
        solo_svc.close()
        wide_svc.close()
    for k in COHORT_KERNELS:
        assert launches[k] > 0, f"kernel {k} never launched on the pipeline path"
    t0 = time.perf_counter()
    for b, w in zip(surge_bases, want):
        assert decisions(plain.solve(b)) == w, "a cohort member differs from the plain path"
    plain_s = time.perf_counter() - t0
    return dict(
        members=COHORT_MEMBERS, dispatches_per_route=COHORT_DISPATCHES, unfused=unfused,
        service=_ms_tail(service_ms), direct=_ms_tail(direct_ms), solo_8=_ms_tail(solo_ms),
        solo_8_h2d_bytes_per_round=solo_h2d,
        solo_8_wide_arena=dict(max_buckets=COHORT_MEMBERS, **_ms_tail(wide_ms),
                               h2d_bytes_per_round=wide_h2d),
        config3=dict(dispatches=COHORT_CONFIG3_DISPATCHES, ms=c3_ms),
        cold_h2d=cold, warm_h2d_bytes=max(warm_h2d),
        pad=dict(members=COHORT_PAD_MEMBERS, batch=8, h2d_bytes=pad_h2d,
                 member_bytes=member_bytes.ledger.solve["h2d_bytes"]),
        fused_stats={k: fused.stats[k] for k in ("fused_dispatches", "fused_members",
                                                 "device_solves")},
        tenant_h2d_bytes=dict(fused.tenant_h2d_bytes), stream=stream, launches=launches,
        plain_check_s=plain_s)


def stream_phase(surge) -> dict:
    """surge_stream: TorchSolver() with stream_run_events on beside an
    unstaged TorchSolver(), STREAM_SOLVES solves alternating the surge and
    surge_less_one. Every solve after the first two stages through K14;
    decisions equal the unstaged solver's; after each solve the resident
    run tables equal the host encode."""
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    staged = tb.TorchSolver(max_claims=MAX_CLAIMS)
    staged.stream_run_events = True
    ctl = tb.TorchSolver(max_claims=MAX_CLAIMS)
    cells = (surge, surge_less_one(surge))
    rows = []
    for k in range(STREAM_SOLVES):
        inp = cells[k % 2]
        h0 = staged.stats["event_stage_hits"]
        t0 = time.perf_counter()
        r = staged.solve(inp)
        ms = (time.perf_counter() - t0) * 1e3
        hit = staged.stats["event_stage_hits"] - h0
        led = dict(staged.ledger.solve)
        assert decisions(r) == decisions(ctl.solve(inp)), f"surge_stream solve {k} differs"
        if k >= 2:
            assert hit == 1, f"surge_stream solve {k} did not stage"
        enc = encode(quantize_input(inp))
        host = tb.host_kernel_args(enc, tb.TorchSolver._bucket)[0]
        dev, _tags = staged.arena._buckets[staged.arena.bucket_key(host, ns=enc.tenant_id)]
        assert dev[0].cpu().numpy().tolist() == host[0].tolist(), "resident run_group differs"
        assert dev[1].cpu().numpy().tolist() == host[1].tolist(), "resident run_count differs"
        rows.append(dict(ms=ms, hit=hit, h2d=led["h2d_bytes"], msgs=led["h2d_msgs"],
                         h2d_unstaged=ctl.ledger.solve["h2d_bytes"],
                         resumed=staged.stats["resume_solves"]))
    return dict(solves=STREAM_SOLVES, hits=staged.stats["event_stage_hits"],
                misses=staged.stats["event_stage_misses"],
                event_batches=staged.arena.stats["event_batches"],
                event_edits=staged.arena.stats["event_edits"],
                h2d_bytes=[x["h2d"] for x in rows], h2d_unstaged=[x["h2d_unstaged"] for x in rows],
                ms=[x["ms"] for x in rows], resume_solves=staged.stats["resume_solves"])


def cohort_kernel_rows(lanes, lanes_c3, pad, ev, launches, ops_per_s) -> list:
    """The K15, K16 and K14 rows: K15 at the surge's B = 8 lanes (K1 on
    one lane beside it) and config 3's zoned lanes, K16 at cohort_pad's
    stack, K14 at the surge's edit."""
    import torch

    from karpenter_tpu_torch.solver.cuda import arena, ffd

    rows = []
    src = "karpenter_tpu_torch/csrc/ffd_lanes_kernels.cu (ffd_kernels.cu, FFD_LANES_ONLY)"
    for ph, kname in ((lanes, KERNEL_NAMES[26]), (lanes_c3, KERNEL_NAMES[27])):
        args, M, zone = ph["args"], ph["M"], ph["zone"]
        name = f"ffd_lanes_{'zoned' if zone else 'fast'}_scan"
        byts = ops = 0
        for b in range(ph["B"]):
            lb, lo = scan_cost(dict(args=[a[b] for a in args], out=ffd.output_lane(ph["out"], b),
                                    zone=zone, events=ph["events"][b]))
            byts, ops = byts + lb, ops + lo
        fn = lambda: ffd.ffd_solve_lanes(*args, max_claims=M, zone_engine=zone)  # noqa: E731
        lane0 = [a[0] for a in args]
        k1 = lambda: ffd.ffd_solve(*lane0, max_claims=M, zone_engine=zone)  # noqa: E731
        b_ms, by = bound(byts, ops, ops_per_s)
        rows.append(dict(
            name=name, route="cuda", source=src, replaces="karpenter_tpu/parallel/sharded.py:80",
            launches=launches[name], max_abs_err=ph["err"], ms=time_ms(fn, 5),
            plain_ms=ph["plain_once_s"] * 1e3,
            bound_ms=b_ms, bound_by=by, library_ms=None,
            library_call="none (no PyTorch call computes the scan)", match=ph["err"] == 0,
            device_ms=profiled_ms(fn, 3, (kname,)), k1_lane_ms=time_ms(k1, 5),
            k1_lane_device_ms=profiled_ms(k1, 3, (KERNEL_NAMES[1 if zone else 0],)),
            err_k1=ph["err_k1"], shape=dict(B=ph["B"], Sp=int(args[0].shape[1]), M=M,
                                            E=int(ph["out"].take_e.shape[2])),
            events=ph["events"], bytes=byts, ops=ops))
    adopted, batch = pad["adopted"], pad["batch"]
    pad_fn = lambda: arena.pad_lanes(adopted, batch)  # noqa: E731
    cat_fn = lambda: arena.pad_lanes_plain(adopted, batch)  # noqa: E731
    moved = pad["bytes_in"] + pad["bytes_out"]
    b_ms, by = bound(moved, 0, ops_per_s)
    cat_ms = time_ms(cat_fn, 20)
    rows.append(dict(
        name="pad_lanes", route="cuda", source="karpenter_tpu_torch/csrc/arena_kernels.cu",
        replaces="karpenter_tpu/parallel/sharded.py:122", launches=launches["pad_lanes"],
        max_abs_err=pad["err"], ms=time_ms(pad_fn, 50), plain_ms=cat_ms, bound_ms=b_ms,
        bound_by=by, library_ms=time_ms(cat_fn, 20),
        library_call="torch.cat of the array and an expand of its last lane, per array "
        "(the plain version is this call)", match=pad["err"] == 0,
        device_ms=profiled_ms(pad_fn, 20, (KERNEL_NAMES[30],)),
        shape=dict(n=pad["n"], B=batch, arrays=pad["arrays"]), bytes=moved, ops=0))
    rg, rc, evt = ev["tensors"]
    pos, gid, cnt = ev["pos"], ev["gid"], ev["cnt"]
    ev_fn = lambda: ffd.ffd_apply_events(rg, rc, evt)  # noqa: E731
    moved = 4 * nbytes(rg) + nbytes(evt)
    b_ms, by = bound(moved, 0, ops_per_s)
    rows.append(dict(
        name="apply_events", route="cuda", source="karpenter_tpu_torch/csrc/arena_kernels.cu",
        replaces="karpenter_tpu/solver/tpu/ffd.py:309", launches=launches["apply_events"],
        max_abs_err=max(ev["errs"].values()), ms=time_ms(ev_fn, 50),
        plain_ms=time_ms(lambda: ffd.ffd_apply_events_plain(rg, rc, evt), 20),
        bound_ms=b_ms, bound_by=by,
        library_ms=time_ms(lambda: (rg.index_copy(0, pos, gid), rc.index_copy(0, pos, cnt)), 50),
        library_call="torch.Tensor.index_copy of the edit rows into each table (pad rows "
        "filtered out beforehand)", match=max(ev["errs"].values()) == 0,
        device_ms=profiled_ms(ev_fn, 20, (KERNEL_NAMES[28], KERNEL_NAMES[29])),
        errs=ev["errs"], shape=dict(Sp=ev["Sp"], K=int(evt.shape[0]), edits=ev["edits"]),
        bytes=moved, ops=0))
    return rows


def ptxas_report(report: str) -> dict:
    """{kernel instance: {registers, spill_stores, spill_loads}} from ptxas
    -v, for the scan instances (demangled by their template flags), the
    lane-batched scan, the verdict pack, the output pack, the arena unpack,
    the lane pad, the run-table scatter and the class kernels."""
    names = {k: k for k in ("pack_verdicts_kernel", "arena_unpack_kernel", "pack_outputs_kernel",
                            "gang_commit_kernel", "preempt_scan_kernel", "preempt_take_kernel",
                            "explain_sums_kernel", "explain_rows_kernel", "copy_runs_kernel",
                            "apply_events_kernel", "pad_lanes_kernel")}
    names.update({"ffd_lanes_kernelILb0E": "ffd_lanes_kernel<false>",
                  "ffd_lanes_kernelILb1E": "ffd_lanes_kernel<true>"})
    for flags in range(32):
        bits = [(flags >> i) & 1 for i in range(5)]
        mangled = "ffd_scan_kernelI" + "".join(f"Lb{b}E" for b in bits)
        names[mangled] = "ffd_scan_kernel<" + ", ".join("true" if b else "false" for b in bits) + ">"
    out, current = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in names.items() if k in line), None)
            if current:
                out[current] = {}
        elif current and "spill stores" in line:
            words = line.replace(",", "").split()
            out[current]["spill_stores"] = int(words[words.index("spill") - 2])
            out[current]["spill_loads"] = int(words[len(words) - 1 - words[::-1].index("spill") - 2])
        elif current and "registers" in line:
            words = line.split()
            i = next(j for j, w in enumerate(words) if w.startswith("registers"))
            out[current]["registers"] = int(words[i - 1])
            current = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.cuda import build, ffd

    t_start = time.perf_counter()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    dev = torch.device("cuda")
    card = gpu_line()
    print(card, flush=True)

    # ---- phase 1: build --------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    ffd_lib = build.load()
    sparse_lib = build.load("ffd_sparse_kernels")
    lanes_lib = build.load("ffd_lanes_kernels")
    class_lib = build.load("class_kernels")
    convex_lib = build.load("convex_kernels")
    build_s = time.perf_counter() - t0
    assert None not in (ffd_lib, sparse_lib, lanes_lib, class_lib, convex_lib)
    v_cap = ffd.zone_v_cap(dev)
    print(f"zoned scan V-row cap on this card: {v_cap}", flush=True)
    for line in build.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    print(f"build: {build_s:.3f} s ({build.BUILD_LOG['libraries']})", flush=True)

    print(f"[phase 2 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 2: kernels vs plain versions at main-path shapes -------------------
    inputs = {
        "surge": build_input(PODS),
        "surge_e2e": build_e2e_input(PODS, NODES),
        "config3": build_config3_input(PODS),
        "config4": build_config4_input(PODS),
        "constraint_wide": build_constraint_wide_input(4_800, 40),
    }
    once = {"mixed": build_mixed_input(PODS)}
    phases = {}
    for name, inp in {**inputs, **once}.items():
        phases[name] = kernel_phase(inp, dev)
        ph = phases[name]
        print(f"kernels[{name}]: zone={ph['zone']} M={ph['M']} used={int(ph['out'].state.used)} "
              f"events={ph['events']} entries={ph['n_entries']} uniq={ph['n_uniq']} "
              f"max_abs_err={ph['errs']} plain_s={ph['plain_once_s']:.2f}", flush=True)
    assert all(phases[n]["zone"] for n in ("config3", "config4", "mixed"))

    # the scan's hostname, limit, taint and node paths, which the surge never
    # reaches, and the zoned branch's eventful path, anti registration and
    # preemption bound, at small shapes
    for seed in range(8):
        ph = kernel_phase(build_constrained_input(seed), dev)
        assert ph["dims"]["Qp"] >= 8 and sum(ph["errs"]) == 0
    print("kernels[constrained x8]: max_abs_err=(0, 0, 0)", flush=True)
    zone_events = []
    for seed in range(8):
        ph = kernel_phase(build_zone_input(seed), dev)
        assert ph["zone"] and sum(ph["errs"]) == 0
        assert bool(ph["out"].state.v_owner_z.any()), "no anti owner registered"
        zone_events.append(ph["events"])
    assert sum(e > 8 for e in zone_events) >= 4, zone_events  # beyond the closed forms
    print(f"kernels[zone x8]: max_abs_err=(0, 0, 0) events={zone_events}", flush=True)
    # the fleet of ROADMAP §C.1 (the reference's zoned scan against its
    # oracle): K1 and K7 zoned against their plain versions
    fz = kernel_phase(build_zone_fuzz_53_input(), dev)
    assert fz["zone"] and sum(fz["errs"]) == 0
    fz_ck = ckpt_check(fz, 2, 16)
    print(f"kernels[zone_fuzz_53_cut]: events={fz['events']} max_abs_err={fz['errs']} "
          f"K7 (K=2) max_abs_err=({fz_ck['err']}, vs K1 {fz_ck['err_k1']}, resume k={fz_ck['k']} "
          f"{fz_ck['err_resume']})", flush=True)

    print(f"[phase 2d starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 2d: K7 and K8 against their plain versions at main-path shapes --------
    # K7 (the checkpointed scan, TorchSolver()'s default dispatch) at the surge
    # (fast; a snapshot every 16 and every 4 steps) and at config 3 (zoned),
    # also against K1's outputs and through a resume from its ring; K8 (the
    # arena unpack) on the four cells' cold adopts (the config-5 universe's in
    # config5_phase) and on seeded adversarial segment lists
    ckpt = {}
    for cell, K, n in (("surge", 16, 4), ("surge", 4, 4), ("config3", 16, 4)):
        c = ckpt[f"{cell}_K{K}"] = ckpt_check(phases[cell], K, n)
        print(f"ckpt[{cell} K={K} n={n}]: {c['name']} prefix={c['prefix']} resume k={c['k']} "
              f"of S={c['S']} max_abs_err=({c['err']}, vs K1 {c['err_k1']}, resume "
              f"{c['err_resume']})", flush=True)
    unpack_checks = {cell: unpack_check(phases[cell]["host_args"], dev) for cell in inputs}
    for seed in range(4):
        arrays, raw = adversarial_arrays(seed)
        unpack_checks[f"adversarial_{seed}"] = unpack_check(arrays, dev)
        unpack_checks[f"adversarial_{seed}_bytes"] = unpack_check(arrays, dev, raw=raw)
    k8_err = max(c["err"] for c in unpack_checks.values())
    print("unpack: " + " ".join(f"{k}={v['nbytes']}B/{v['segments']}seg"
                                for k, v in unpack_checks.items()) + f" max_abs_err={k8_err}",
          flush=True)

    print(f"[phase 2e starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 2e: the sparse instances (K1s, K7s) and the dense output pack ---------
    # at the kernel arguments of config 3, mixed and constraint_wide (zoned),
    # the surge with its all-padding tables (fast, full width), the small
    # hostname fleets with the tables "on" would build (fast), a hostname
    # fleet "auto" gates sparse, the zone fleets, and index rows rewritten as
    # supersets; K7s resumes from its own ring and the dense K7's, K7 from
    # K7s's; the pack against its plain version at the surge's and config
    # 3's outputs and with a take past 65535
    sparse = {}
    for cell in ("surge", "config3", "constraint_wide", "mixed"):
        # the resumes at mixed add ~15 s of plain scan and no path the
        # other three cells do not take
        c = sparse[cell] = sparse_check(phases[cell], dev, resume=cell != "mixed")
        print(f"sparse[{cell}]: {c['name']} Kq={c['Kq']} Kv={c['Kv']} events={c['events']} "
              f"max_abs_err=({c['err']}, K7s {c['err_ckpt']}, vs dense K1 {c['err_dense']}, "
              f"resume k={c.get('k')} {c.get('err_resume')}, across ring forms "
              f"{c.get('err_cross')}) plain_s={c['plain_once_s']:.2f}", flush=True)
    assert all(phases[n]["zone"] for n in ("config3", "constraint_wide", "mixed"))
    assert phases["constraint_wide"]["dims"]["Vp"] == 120, phases["constraint_wide"]["dims"]
    small_sparse = []
    for seed in range(8):
        ph = kernel_phase(build_constrained_input(seed), dev)
        c = sparse_check(ph, dev, K=2, n=16)
        assert not ph["zone"] and ph["enc"].Q > 0
        small_sparse.append(("constrained", seed, c["err"], c["err_ckpt"], c.get("err_resume")))
    for seed in range(4):
        ph = kernel_phase(build_zone_input(seed), dev)
        c = sparse_check(ph, dev, K=2, n=16)
        small_sparse.append(("zone", seed, c["err"], c["err_ckpt"], c.get("err_resume")))
    c = sparse_check(fz, dev, K=2, n=16)
    small_sparse.append(("zone_fuzz_53_cut", 0, c["err"], c["err_ckpt"], c.get("err_resume")))
    from karpenter_tpu_torch.solver.encode import use_sparse_constraints

    hw = kernel_phase(build_hostname_wide_input(), dev)
    assert use_sparse_constraints(hw["enc"]) and hw["enc"].Q >= 8 and not hw["zone"]
    c = sparse_check(hw, dev, K=2, n=16)
    small_sparse.append(("hostname_wide", 0, c["err"], c["err_ckpt"], c.get("err_resume")))
    # supersets: -1 interleaved and extra non-member columns decide the same
    supersets = []
    for name, ph in (("config3", phases["config3"]), ("hostname_wide", hw),
                     ("zone_fuzz_53_cut", fz)):
        sp = sparse_tables(ph["enc"], ph["dims"]["Sp"], dev)
        wide = superset_tables(sp, int(ph["dims"]["Qp"]), int(ph["dims"]["Vp"]), seed=len(supersets))
        kw = dict(max_claims=ph["M"], zone_engine=ph["zone"])
        got = ffd.ffd_solve_sparse(*wide, *ph["args"], **kw)
        torch.cuda.synchronize()
        err = max_abs_err(_scan_outputs(got), _scan_outputs(ph["out"]))
        assert err == 0, f"{name}: superset index rows change the sparse scan's outputs ({err})"
        supersets.append((name, int(wide[0].shape[1]), int(wide[1].shape[1]), err))
    print(f"sparse[small x{len(small_sparse)}]: (fleet, seed, K1s, K7s, resume) max_abs_err="
          f"{small_sparse} supersets (fleet, Kq, Kv, vs dense)={supersets}", flush=True)
    packs = {"surge": pack_check(phases["surge"]["out"]),
             "config3": pack_check(phases["config3"]["out"]),
             "config3_big_take": pack_check(phases["config3"]["out"], big=True)}
    print("pack: " + " ".join(f"{k}={v['words']}words flag={v['flag']}" for k, v in packs.items())
          + " max_abs_err=0", flush=True)

    print(f"[phase 2f starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 2f: the class and explain kernels (K10-K12) against their plain versions
    # K10/K11 on seeded and adversarial tables and K11 at 10k nodes; K12 at
    # the outputs of surge_e2e, config 3 and class_contended's cold inner
    # solve (K1-K3 held at that fleet's shapes too), at top_k 8 and above
    # Ep; a record built from K12's wire equals the host-derived one
    from karpenter_tpu_torch.api import wellknown as wk

    class_checks = class_kernel_checks(dev)
    print(f"class kernels: seeded (S, NG, [E, Vm], node)={class_checks['seeded']} "
          f"adversarial={class_checks['adversarial']} 10k nodes={class_checks['scaled']} "
          f"max_abs_err=0", flush=True)
    class_inp = build_class_input(**CLASS_KW)
    ph_cls = kernel_phase(class_inp, dev)
    print(f"kernels[class_contended]: M={ph_cls['M']} dims={ph_cls['dims']} "
          f"max_abs_err={ph_cls['errs']} plain_s={ph_cls['plain_once_s']:.2f}", flush=True)
    explain_checks, explain_records = {}, {}
    for name, ph, inp in (("surge_e2e", phases["surge_e2e"], inputs["surge_e2e"]),
                          ("config3", phases["config3"], inputs["config3"]),
                          ("class_contended", ph_cls, class_inp)):
        Ep = int(ph["out"].take_e.shape[1])
        explain_checks[name] = explain_check(ph, dev, (8, Ep + 5))
        explain_records[name] = [explain_record_check(inp, k) for k in (8, Ep + 5)]
        c = explain_checks[name]
        print(f"explain[{name}]: Sp={c['Sp']} Ep={c['Ep']} Gp={c['Gp']} E={c['E']} G={c['G']} "
              f"side tables {c['side_bytes']} B top_k={c['ks']} max_abs_err={c['err']} "
              f"records={explain_records[name]}", flush=True)

    print(f"[phase 2c starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 2c: K6, the relax-ladder scan, against its plain version -------------
    # at the ladder cells' shapes (config3_soft through the zoned instance,
    # surge_pref through the fast one), a 400-pod relax walk (every pod after
    # an app's first relaxes), and small fleets mixing every preference
    # kind through both instances
    relax_inputs = {"config3_soft": build_config3_soft_input(PODS)}
    relax_once = {"surge_pref": build_surge_pref_input(PODS),
                  "relax_walk": build_relax_walk_input(WALK_PODS)}
    ladder = {}
    for name, inp in (("config3_soft", relax_inputs["config3_soft"]),
                      ("surge_pref", relax_once["surge_pref"]),
                      ("relax_walk_400", build_relax_walk_input(400))):
        ladder[name] = ph = ladder_phase(inp, dev)
        print(f"ladder[{name}]: zone={ph['zone']} M={ph['M']} used={int(ph['out'].state.used)} "
              f"rungs={ph['rungs']} attempts={ph['attempts']} events={ph['events']} "
              f"leftover={ph['leftover']} max_abs_err={ph['err']} "
              f"plain_s={ph['plain_once_s']:.2f}", flush=True)
    # K6s (the relax-ladder scan's sparse instances) with the union index
    # tables: zoned at config3_soft, fast at surge_pref (all-padding tables)
    lsparse = {name: sparse_ladder_check(ladder[name], dev) for name in ("config3_soft", "surge_pref")}
    print("ladder sparse: " + " ".join(f"{k}={v['name']} attempts={v['attempts']} "
                                       f"max_abs_err=({v['err']}, vs K6 {v['err_dense']})"
                                       for k, v in lsparse.items()), flush=True)
    assert ladder["config3_soft"]["zone"] and not ladder["surge_pref"]["zone"]
    for name in ("config3_soft", "surge_pref"):  # satisfiable: rung 0 places every pod
        runs = int((ladder[name]["args"][1] > 0).sum())
        assert ladder[name]["attempts"] == runs and ladder[name]["leftover"] == 0, name
    walk = ladder["relax_walk_400"]
    assert walk["leftover"] == 0 and walk["attempts"] > 400, walk["attempts"]
    # the fleets with zone/ct sigs through the zoned instance (as the main
    # path picks it; the fast instance records no V-axis counts), the others
    # through both
    small = []
    for seed in range(8):
        inp = build_relax_input(seed)
        ph = ladder_phase(inp, dev)
        assert ph["zone"] == (seed % 2 == 0), (seed, ph["zone"])
        small.append((seed, ph["zone"], ph["attempts"], ph["events"], ph["leftover"]))
        sparse_ladder_check(ph, dev)
        if not ph["zone"]:
            ph = ladder_phase(inp, dev, zone=True)
            sparse_ladder_check(ph, dev)
            small.append((seed, True, ph["attempts"], ph["events"], ph["leftover"]))
    assert any(a > 10 for _, _, a, _, _ in small), small
    assert any(lo > 0 for *_, lo in small), small
    print(f"ladder[relax x8]: max_abs_err=0, K6s too (seed, zoned, attempts, events, "
          f"leftover)={small}", flush=True)

    print(f"[phase 2b starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 2b: config 5, batched consolidation (K4, K5) ------------------------
    int_rate = int32_ops_per_s()
    t0 = time.perf_counter()
    c5 = config5_phase(dev, int_rate)
    c5["summary"]["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"config5": c5["summary"]}), flush=True)

    print(f"[phase 3 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 3: the main path through TorchSolver ---------------------------------
    # TorchSolver() at its defaults (the arena, K7 with its ring), which
    # gates sparse on config 3, mixed and constraint_wide (its
    # sparse_dispatches must count every one of their solves, and none of
    # the others'); a sparse="off" solver beside it on those three cells
    # (timed, same decisions); one arena=False solver (per-array uploads,
    # K1, K1s) on surge_e2e, config 3 and config 4; a device_decode=False
    # solver (the dense output pack) on the surge and config 3; and the
    # hostname fleet that "auto" gates sparse through the fast instances
    TorchSolver = tb.TorchSolver
    solver = TorchSolver(max_claims=MAX_CLAIMS)
    off = TorchSolver(max_claims=MAX_CLAIMS, arena=False)
    dense = TorchSolver(max_claims=MAX_CLAIMS, sparse="off")
    dd = TorchSolver(max_claims=MAX_CLAIMS, device_decode=False)
    gated = ("config3", "mixed", "constraint_wide")
    cold = {}
    for name, inp in {**inputs, **once}.items():  # warm: allocator, encode caches, uploads
        solver.solve(inp)
        cold[name] = dict(solver.ledger.solve)
        if name in gated:
            dense.solve(inp)
    reset_launches()
    samples = {name: [] for name in inputs}
    dense_samples = {name: [] for name in gated if name in inputs}
    sparse_count = {name: 0 for name in {**inputs, **once}}
    results = {}
    transfer = {}
    watch = GcWatch()

    def timed(name, i):
        watch.reset()
        n0 = solver.stats["sparse_dispatches"]
        t0 = time.perf_counter()
        res = solver.solve(inputs[name])
        samples[name].append(((time.perf_counter() - t0) * 1e3, watch.ms, list(watch.collections)))
        sparse_count[name] += solver.stats["sparse_dispatches"] - n0
        results[name] = res
        transfer[name] = dict(solver.ledger.solve)
        if name in gated and i < DENSE_REPEATS:
            watch.reset()
            t0 = time.perf_counter()
            res_d = dense.solve(inputs[name])
            dense_samples[name].append(((time.perf_counter() - t0) * 1e3, watch.ms,
                                        list(watch.collections)))
            assert decisions(res_d) == decisions(res), f"{name}: sparse='off' decisions differ"

    # the four 50k cells in rotation, then the wide-constraint cell on its
    # own: a fifth cell in the rotation would cycle the encode-core cache
    # (4 entries) and the arena's four buckets on every solve
    for i in range(REPEATS):
        for name in inputs:
            if name != "constraint_wide":
                timed(name, i)
    for i in range(REPEATS):
        timed("constraint_wide", i)
    mixed_ms, mixed_dense_ms = [], []
    for _ in range(MIXED_REPEATS):
        n0 = solver.stats["sparse_dispatches"]
        t0 = time.perf_counter()
        results["mixed"] = solver.solve(once["mixed"])
        mixed_ms.append((time.perf_counter() - t0) * 1e3)
        sparse_count["mixed"] += solver.stats["sparse_dispatches"] - n0
        transfer["mixed"] = dict(solver.ledger.solve)
        t0 = time.perf_counter()
        res_d = dense.solve(once["mixed"])
        mixed_dense_ms.append((time.perf_counter() - t0) * 1e3)
        assert decisions(res_d) == decisions(results["mixed"]), "mixed: sparse='off' decisions differ"
    watch.close()
    for name, n in sparse_count.items():
        want = (MIXED_REPEATS if name == "mixed" else REPEATS) if name in gated else 0
        assert n == want, f"{name}: {n} sparse dispatches in {want or REPEATS} solves"
    assert dense.stats["sparse_dispatches"] == 0, dense.stats
    res_off = {n: off.solve(inputs[n]) for n in ("surge_e2e", "config3")}
    res_dd = {n: dd.solve(inputs[n]) for n in ("surge", "config3")}
    dd_d2h = dict(dd.ledger.solve)
    res_off["config4"] = off.solve(inputs["config4"])  # the dense zoned K1
    hw_inp = build_hostname_wide_input()
    n0 = solver.stats["sparse_dispatches"]
    hw_res = solver.solve(hw_inp)
    assert solver.stats["sparse_dispatches"] == n0 + 1, "hostname_wide: not gated sparse"
    hw_off = off.solve(hw_inp)
    torch.cuda.synchronize()
    launches = read_launches()
    for k in SINGLE_SOLVE_KERNELS:
        assert launches[k] > 0, f"kernel {k} never launched on the main path"
    plain = TorchSolver(device="cpu", max_claims=MAX_CLAIMS)
    for name, inp in {**inputs, **once}.items():
        if name == "mixed":
            # the plain zoned scan on the card: ~15 ms an event, ~60 s
            with PlainOnCard():
                ref = TorchSolver(max_claims=MAX_CLAIMS).solve(inp)
        else:
            ref = plain.solve(inp)
        assert decisions(results[name]) == decisions(ref), \
            f"{name}: decisions differ from the plain path"
        res = results[name]
        assert len(res.placements) + len(res.errors) == len(inp.pods), name
        assert all(c.pod_uids for c in res.claims), name
    for n, r in res_off.items():
        assert decisions(r) == decisions(results[n]), f"{n}: arena=False decisions differ"
    for n, r in res_dd.items():
        assert decisions(r) == decisions(results[n]), f"{n}: device_decode=False decisions differ"
    assert decisions(hw_res) == decisions(hw_off) == decisions(plain.solve(hw_inp))
    assert off.ledger.solve["h2d_msgs"] == off.ledger.solve["h2d_arrays"] > 0
    ledger_line = dict(arena_hit_rate=solver.ledger.arena_hit_rate,
                       upload_bytes_per_solve=solver.ledger.upload_bytes_per_solve,
                       solves=solver.ledger.solves, outcomes=solver.ledger.outcomes,
                       total=solver.ledger.total, arena=solver.arena.stats,
                       resident_bytes=solver.arena.total_bytes(),
                       arena_off=dict(surge_e2e_config3_last=dict(off.ledger.solve),
                                      total=off.ledger.total),
                       device_decode_off=dict(config3_last=dd_d2h, total=dd.ledger.total),
                       sparse_dispatches=sparse_count)
    print(json.dumps({"ledger": ledger_line}), flush=True)
    print(f"decisions: equal to the plain path on every cell (arena=False, sparse='off' and "
          f"device_decode=False too); sparse dispatches {sparse_count}; device_decode=False "
          f"d2h bytes {dd_d2h['d2h_bytes']} (config 3) against {transfer['config3']['d2h_bytes']}",
          flush=True)

    print(f"[phase 4 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 4: forced wide re-fetch ---------------------------------------------
    real_cap = tb.delta_capacity
    tb.delta_capacity = lambda *a: 16
    try:
        wide = TorchSolver()
        res_w = wide.solve(inputs["surge_e2e"])
    finally:
        tb.delta_capacity = real_cap
    assert wide.stats["wide_refetches"] >= 1, wide.stats
    assert decisions(res_w) == decisions(results["surge_e2e"]), "wide re-fetch changed decisions"

    print(f"[phase 5 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 5: the relax path through TorchSolver ----------------------------------
    # config3_soft REPEATS times, surge_pref and the relax walk once, with
    # the launch counts reset just before and read just after
    for name, inp in {**relax_inputs, "surge_pref": relax_once["surge_pref"]}.items():
        solver.solve(inp)  # warm
        cold[name] = dict(solver.ledger.solve)
    # config3_soft dispatches the sparse ladder (K6s zoned); a sparse="off"
    # solver solves it once (the dense K6 zoned) and a sparse="on" solver a
    # small hostname-preference fleet (K6s fast)
    reset_launches()
    watch = GcWatch()
    samples.update({name: [] for name in relax_inputs})
    ladder_solves0 = solver.stats["ladder_solves"]
    relax_sparse = {name: 0 for name in {**relax_inputs, **relax_once}}
    for _ in range(SOFT_REPEATS):
        for name, inp in relax_inputs.items():
            watch.reset()
            n0 = solver.stats["sparse_dispatches"]
            t0 = time.perf_counter()
            res = solver.solve(inp)
            samples[name].append(((time.perf_counter() - t0) * 1e3, watch.ms,
                                  list(watch.collections)))
            relax_sparse[name] += solver.stats["sparse_dispatches"] - n0
            results[name] = res
            transfer[name] = dict(solver.ledger.solve)
            assert solver.stats["relax_dispatches"] == 1, solver.stats
    once_ms = {}
    for name, inp in relax_once.items():
        n0 = solver.stats["sparse_dispatches"]
        t0 = time.perf_counter()
        results[name] = solver.solve(inp)
        once_ms[name] = (time.perf_counter() - t0) * 1e3
        relax_sparse[name] += solver.stats["sparse_dispatches"] - n0
        transfer[name] = dict(solver.ledger.solve)
        assert solver.stats["relax_dispatches"] == 1, (name, solver.stats)
    soft_dense = dense.solve(relax_inputs["config3_soft"])
    on = TorchSolver(sparse="on")
    res_on = on.solve(build_relax_input(1))
    assert on.stats["ladder_solves"] == 1 and on.stats["sparse_dispatches"] == 1, on.stats
    watch.close()
    relax_launches = read_launches()
    ladder_solves = solver.stats["ladder_solves"] - ladder_solves0
    for k in RELAX_KERNELS:
        assert relax_launches[k] > 0, f"kernel {k} never launched on the relax path"
    assert ladder_solves == SOFT_REPEATS * len(relax_inputs) + len(relax_once), ladder_solves
    assert relax_sparse["config3_soft"] == SOFT_REPEATS, relax_sparse
    assert relax_sparse["surge_pref"] == 0, relax_sparse
    assert decisions(soft_dense) == decisions(results["config3_soft"]), \
        "config3_soft: sparse='off' decisions differ"
    assert decisions(res_on) == decisions(plain.solve(build_relax_input(1))), \
        "the sparse='on' relax fleet differs from the plain path"
    assert decisions(results["config3_soft"]) == decisions(results["config3"]), \
        "config3_soft decisions differ from config 3's"
    assert decisions(results["surge_pref"]) == decisions(plain.solve(relax_once["surge_pref"])), \
        "surge_pref: decisions differ from the plain path"
    walk_res = results["relax_walk"]
    assert not walk_res.errors and len(walk_res.placements) == WALK_PODS, len(walk_res.errors)
    # the host relax loop on the card equals the ladder (bench.py's relax_pods)
    host = TorchSolver(relax_ladder=False)
    res_h = host.solve(build_relax_walk_input(120))
    res_l = TorchSolver().solve(build_relax_walk_input(120))
    assert decisions(res_h) == decisions(res_l), "the host relax loop differs from the ladder"
    assert host.stats["relax_dispatches"] > 1 and host.stats["ladder_solves"] == 0, host.stats
    print(f"relax path: ladder_solves={ladder_solves} sparse_dispatches={relax_sparse} "
          f"launches={relax_launches} "
          f"host_loop_120_dispatches={host.stats['relax_dispatches']} equal to the ladder",
          flush=True)
    # the relax walk's K6 alone (CUDA events around its launch at the
    # solve's final claim bucket)
    wph = ladder_phase(relax_once["relax_walk"], dev, plain=False)
    walk_k6_ms = wph["kernel_ms"]
    walk_line = dict(pods=WALK_PODS, ms=once_ms["relax_walk"], k6_ms=walk_k6_ms,
                     attempts=wph["attempts"], events=wph["events"],
                     us_per_attempt=walk_k6_ms * 1e3 / max(1, wph["attempts"]),
                     claims=len(walk_res.claims), unplaced=len(walk_res.errors),
                     relax_dispatches=1, M=wph["M"], Sp=wph["dims"]["Sp"], G=wph["dims"]["G"],
                     steady=transfer["relax_walk"])
    print(json.dumps({"relax_walk": walk_line}), flush=True)

    print(f"[phase 6 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 6: arena and resume ----------------------------------------------------
    # surge_tail / config3_tail: the cell plus 1 250 replicas of its last
    # run's pod; base and tail alternate through TorchSolver(), launch
    # counts reset just before and read just after
    tail_cells = {"surge_tail": (inputs["surge"], with_tail(inputs["surge"], 1250)),
                  "config3_tail": (inputs["config3"], with_tail(inputs["config3"], 1250))}
    reset_launches()
    resume = resume_phase(tail_cells, plain)
    torch.cuda.synchronize()
    resume_launches = read_launches()
    for k in RESUME_KERNELS:
        assert resume_launches[k] > 0, f"kernel {k} never launched in the arena-and-resume phase"
    resume_solves = 2 * RESUME_SOLVES * len(tail_cells)  # TorchSolver() and resume=False
    print(json.dumps({"resume": {n: {k: v for k, v in r.items() if k != "solves"}
                                 for n, r in resume.items()},
                      "resume_launches": resume_launches}), flush=True)

    print(f"[phase 7 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 7: scheduling classes and explain ---------------------------------------
    # class_contended through ClassAwareSolver(TorchSolver()) (K10, K11; K12
    # with explain on), class_zone once, surge_e2e with explain on and off
    zone_inp = build_class_input(**{**CLASS_KW, "n_gangs": CLASS_ZONE_GANGS},
                                 topology=wk.ZONE_LABEL)
    zone_check_inp = build_class_input(**{**CLASS_KW, "n_gangs": CLASS_ZONE_CHECK_GANGS},
                                       topology=wk.ZONE_LABEL)
    t0 = time.perf_counter()
    cls = class_phase(class_inp, zone_inp, zone_check_inp, inputs["surge_e2e"], TorchSolver)
    cls["phase_s"] = time.perf_counter() - t0
    class_line = {k: v for k, v in cls.items() if k not in ("first", "samples")}
    print(json.dumps({"classes": class_line}), flush=True)
    class_rows = class_kernel_rows(
        cls["first"], dict(gang_err=0, plan_err=0, k11_tables=class_checks["k11_tables"]),
        explain_checks["class_contended"], cls["launches"], cls["per_solve_launches"], int_rate)

    print(f"[phase 8 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 8: the convex backend (K13) -------------------------------------------
    # K13 against its plain version on seeded and adversarial tables, then the
    # convex cells through ConvexSolver(TorchSolver()) (config 5's one-shot
    # consolidation, the quality suite, convex_e2e), counted
    t0 = time.perf_counter()
    admm_tables = admm_table_checks(dev)
    cvx = convex_phase(dev)
    cvx["phase_s"] = time.perf_counter() - t0
    assert cvx["fallbacks"] == 0, cvx["fallbacks"]
    convex_line = {k: v for k, v in cvx.items() if k != "row"}
    convex_line["tables"] = admm_tables
    print(json.dumps({"convex": convex_line}), flush=True)

    print(f"[phase 9 starts at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- phase 9: the serving pipeline (K14-K16) ----------------------------------
    # K15 against its plain version and K1 on the surge's lanes (B 1, 2, 8)
    # and config 3's (zoned, B 8), K16 on a 5-member stack, K14 on seeded tables
    # and the surge's edit; then the counted pipeline path (cohort_phase)
    t0 = time.perf_counter()
    surge_bases = [inputs["surge"]] + [build_input(PODS + 3 * k) for k in (1, 2)]
    c3_bases = [inputs["config3"]] + [build_config3_input(PODS + 3 * k) for k in (1, 2)]
    lanes = {B: lanes_check(cohort_members(surge_bases, B, "t"), dev) for B in LANES_CHECK_B}
    lanes_c3 = lanes_check(cohort_members(c3_bases, COHORT_MEMBERS, "c"), dev)
    assert lanes_c3["zone"] and not lanes[8]["zone"]
    pad = pad_check(cohort_members(surge_bases, COHORT_PAD_MEMBERS, "t"), dev)
    ev = events_check(inputs["surge"], dev)
    coh = cohort_phase(surge_bases, c3_bases, plain)
    cohort_rows = cohort_kernel_rows(lanes[8], lanes_c3, pad, ev, coh["launches"], int_rate)
    coh["phase_s"] = time.perf_counter() - t0
    coh["lanes_checks"] = {f"surge_B{B}": {k: c[k] for k in ("B", "M", "err", "err_k1", "used",
                                                            "events", "plain_once_s")}
                           for B, c in lanes.items()}
    coh["lanes_checks"][f"config3_B{COHORT_MEMBERS}"] = {k: lanes_c3[k] for k in ("B", "M", "err", "err_k1",
                                                                  "used", "events",
                                                                  "plain_once_s")}
    coh["pad_check"] = {k: pad[k] for k in ("n", "batch", "err", "bytes_in", "bytes_out")}
    coh["events_check"] = {k: ev[k] for k in ("errs", "edits", "Sp")}
    cohort_line = {k: v for k, v in coh.items() if k != "launches"}
    print(json.dumps({"cohort": cohort_line, "cohort_launches": coh["launches"]}), flush=True)
    print(f"cohort_surge: fused p50/p99 {coh['service']['p50_ms']:.2f}/{coh['service']['p99_ms']:.2f}"
          f" ms (service), {coh['direct']['p50_ms']:.2f}/{coh['direct']['p99_ms']:.2f} ms (direct) "
          f"against 8 solo {coh['solo_8']['p50_ms']:.2f}/{coh['solo_8']['p99_ms']:.2f} ms "
          f"(arena of {COHORT_MEMBERS} buckets: {coh['solo_8_wide_arena']['p50_ms']:.2f}/"
          f"{coh['solo_8_wide_arena']['p99_ms']:.2f} ms); "
          f"K15 B=8 {cohort_rows[0]['ms']:.3f} ms (device {cohort_rows[0]['device_ms']}) against K1 "
          f"{cohort_rows[0]['k1_lane_ms']:.3f} ms (device {cohort_rows[0]['k1_lane_device_ms']})",
          flush=True)

    stages = {name: breakdown(inp, 5, phases[name]["M"], phases[name]["zone"])
              for name, inp in inputs.items()}
    stages.update({name: ladder_breakdown(inp, 5, ladder[name]["M"], ladder[name]["zone"])
                   for name, inp in relax_inputs.items()})
    cell_scan = {"surge": 11, "surge_e2e": 11, "config3": 19, "config4": 12, "config3_soft": 17,
                 "constraint_wide": 19}
    profiles = {name: device_profile(inp, KERNEL_NAMES[cell_scan[name]])
                for name, inp in {**inputs, **relax_inputs}.items()}
    # solves per kernel in phase 3's counted window: TorchSolver() on the
    # surge, surge_e2e (K7), config 4 (K7 zoned), config 3 and
    # constraint_wide (K7s zoned) REPEATS times, mixed (K7s zoned)
    # MIXED_REPEATS times, hostname_wide once (K7s fast); sparse="off" on
    # config 3 and constraint_wide DENSE_REPEATS times and mixed
    # MIXED_REPEATS times (K7 zoned); arena=False on surge_e2e (K1),
    # config 4 (K1 zoned), config 3 (K1s zoned), hostname_wide (K1s fast);
    # device_decode=False on the surge (K7) and config 3 (K7s zoned)
    ckpt_solves = {"ffd_ckpt_fast_scan": 2 * REPEATS + 1,
                   "ffd_ckpt_zoned_scan": REPEATS + 2 * DENSE_REPEATS + MIXED_REPEATS,
                   "ffd_ckpt_sparse_zoned_scan": 2 * REPEATS + MIXED_REPEATS + 1,
                   "ffd_ckpt_sparse_fast_scan": 1}
    delta_solves = 5 * REPEATS + 2 * DENSE_REPEATS + 2 * MIXED_REPEATS + 5
    rows = (kernel_rows(phases["surge"], phases["config3"], launches, int_rate)
            + ladder_kernel_rows(ladder["surge_pref"], ladder["config3_soft"], relax_launches,
                                 int_rate)
            + c5["rows"]
            + ckpt_kernel_rows(ckpt, launches, int_rate, ckpt_solves, phases)
            + [unpack_kernel_row(unpack_checks["surge"], k8_err, resume_launches, resume_solves,
                                 int_rate)]
            + sparse_kernel_rows(sparse, lsparse, phases, ladder, launches, relax_launches,
                                 int_rate)
            + [pack_kernel_row(phases["config3"]["out"], packs["config3"]["err"], launches,
                               int_rate)]
            + class_rows + [cvx["row"]] + cohort_rows)
    launches_per_solve = {k: launches[k] / n for k, n in (
        *ckpt_solves.items(), ("ffd_fast_scan", 1), ("ffd_zoned_scan", 1),
        ("ffd_sparse_fast_scan", 1), ("ffd_sparse_zoned_scan", 1), ("pack_outputs", 2),
        ("compact_takes", delta_solves), ("claim_meta", delta_solves))}
    launches_per_solve["arena_unpack_resume_phase"] = resume_launches["arena_unpack"] / resume_solves
    launches_per_solve.update({k: relax_launches[k] / n for k, n in (
        ("ffd_ladder_fast_scan", 1), ("ffd_ladder_zoned_scan", 1),
        ("ffd_ladder_sparse_zoned_scan", SOFT_REPEATS), ("ffd_ladder_sparse_fast_scan", 1))})
    launches_per_solve.update({f"{k}_relax": relax_launches[k] / ladder_solves
                               for k in ("compact_takes", "claim_meta")})
    print(json.dumps({"kernels": rows}))
    cell_ph = {**phases, **ladder}
    solve_line = {
        "solve": {
            name: dict(
                pods=len(inp.pods), nodes=len(inp.nodes), **tail(samples[name]),
                claims=len(results[name].claims), M=cell_ph[name]["M"],
                events_per_solve=cell_ph[name]["events"],
                attempts_per_solve=cell_ph[name].get("attempts"),
                unplaced=len(results[name].errors), steady=transfer[name],
                cold=cold[name], stages=stages[name], profile=profiles[name],
            )
            for name, inp in {**inputs, **relax_inputs}.items()
        },
        "sparse_dispatches": dict(sparse_count, **relax_sparse),
        "mixed": dict(pods=PODS, ms=mixed_ms, claims=len(results["mixed"].claims),
                      M=phases["mixed"]["M"], events_per_solve=phases["mixed"]["events"],
                      unplaced=len(results["mixed"].errors), steady=transfer["mixed"],
                      sparse_off_ms=mixed_dense_ms),
        "sparse_off": {name: tail(v) for name, v in dense_samples.items()},
        "sparse_checks": {k: {f: v[f] for f in ("name", "Kq", "Kv", "events", "err", "err_ckpt",
                                                 "err_dense", "plain_once_s")}
                          | {f: v.get(f) for f in ("k", "err_resume", "err_cross")}
                          for k, v in sparse.items()},
        "device_decode_off": dict(config3=dd_d2h, delta_config3=transfer["config3"]),
        "surge_pref": dict(pods=PODS, ms=once_ms["surge_pref"],
                           claims=len(results["surge_pref"].claims), M=ladder["surge_pref"]["M"],
                           attempts_per_solve=ladder["surge_pref"]["attempts"],
                           unplaced=len(results["surge_pref"].errors),
                           steady=transfer["surge_pref"]),
        "relax_walk": walk_line,
        "resume": resume,
        "classes": class_line,
        "convex": convex_line,
        "cohort": cohort_line,
        "zone_v_cap": v_cap,
        "explain_checks": {k: {f: v[f] for f in ("Sp", "Ep", "Gp", "E", "G", "ks", "err",
                                                 "side_bytes")}
                           for k, v in explain_checks.items()},
        "explain_records": explain_records,
        "class_kernel_checks": {k: class_checks[k] for k in ("seeded", "adversarial", "scaled")},
        "ledger": ledger_line,
        "unpack_checks": {k: dict(nbytes=v["nbytes"], segments=v["segments"])
                          for k, v in unpack_checks.items()},
        "ptxas": {k: v for k, v in ptxas_report(build.BUILD_LOG["ptxas"]).items()},
        "launches": launches,
        "resume_launches": resume_launches,
        "relax_launches": relax_launches,
        "launches_per_solve": launches_per_solve,
        "claim_doublings": solver.stats["claim_doublings"],
        "wide_refetch_ok": True,
        "build_s": build_s,
        "int32_peak_ops_per_s": int_rate,
        "card": card,
        "wall_s": time.perf_counter() - t_start,
    }
    print(json.dumps(solve_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
