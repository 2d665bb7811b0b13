"""GPU-batched consolidation evaluation: the port of
karpenter_tpu/disruption/batched.py.

Wraps solver/cuda/consolidate.py for the disruption controller: encodes the
simulation universe ONCE (all candidates' pods pending, all nodes present),
then evaluates candidate subsets as batches of rows. Used as a fast filter —
the winning subset is re-materialized through the sequential simulate path,
so command construction is the sequential evaluation's; only wall-clock
changes.

prepare() builds and uploads the shared universe once; evaluate_prepared()
dispatches one batch of subsets against it — the controller's speculative
binary replay (speculative_binary_search; config 5: 10k-node multi-node
consolidation) issues 1-2 batched dispatches against a single prepared
universe instead of one sequential round-trip per binary-search probe.
tiered_prefix_search (the largest-acceptable ladder) remains for callers
that want maximal-prefix semantics rather than binary-search parity.

prepare() returns None when the universe contains constructs the scan
cannot express (fallback groups, off-device topology/affinity forms,
Z*C > 32): the caller then takes its sequential path, which in the port is
TorchSolver on the same card. Zone-granular constraints (V axis) ARE
expressible: each subset row subtracts its removed candidates' zone-count
contributions. Shapes past the scan kernel's shared rows raise
UnsupportedInput, as TorchSolver does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..provisioning.scheduler import SolverInput
from ..solver.backend import TorchSolver, check_kernel_limits, host_kernel_args, unpack_zc_bits
from ..solver.cuda.consolidate import (
    _V_COUNT0,
    fetch_verdicts,
    replacement_min_price,
    simulate_subsets,
)
from ..solver.encode import UnpackableInput, encode, quantize_input

# the argument arena's placement tag of the consolidation universe's buckets
UNIVERSE_TAG = "consolidation-universe"


@dataclasses.dataclass
class SubsetVerdict:
    ok: bool  # feasible (everything reschedules, <=1 new claim)
    has_replacement: bool
    replacement_price: Optional[float]  # cheapest offering of the new claim
    replacement_type_count: int  # surviving instance types (spot >=15 rule)


def tiered_prefix_search(evaluate_ks, n_max: int, acceptable, width: int = 64):
    """Largest-acceptable-prefix search over prefix lengths [2, n_max].

    evaluate_ks(ks) -> verdicts for prefixes of those lengths;
    acceptable(k, verdict) -> bool. Phase 1 probes ≤width evenly spaced
    lengths over the whole range; each later phase refines between the
    largest accepted probe and the next probe above it, until the gap is
    fully enumerated — O(log_width(N)) batched dispatches instead of O(N)
    sequential re-solves.

    Returns (k_best — 1 when nothing accepted, probed {k: verdict},
    dispatches)."""
    probed: Dict[int, object] = {}
    k_lo, k_hi = 1, n_max + 1
    dispatches = 0
    while k_hi - k_lo > 1:
        span = [k for k in range(k_lo + 1, k_hi) if k not in probed]
        if not span:
            break
        if len(span) > width:
            step = (len(span) - 1) / (width - 1)
            ks = sorted({span[int(round(i * step))] for i in range(width)})
        else:
            ks = span
        verdicts = evaluate_ks(ks)
        dispatches += 1
        for k, v in zip(ks, verdicts):
            probed[k] = v
        acc = [k for k in ks if acceptable(k, probed[k])]
        if acc:
            k_lo = max(acc)
            higher = [k for k in probed if k > k_lo]
            k_hi = min(higher) if higher else k_hi
        else:
            k_hi = min(ks)
    return k_lo, probed, dispatches


def binary_probe_frontier(lo: int, hi: int, levels: int) -> List[int]:
    """Every prefix length the sequential binary search over [lo, hi] can
    probe within its first `levels` iterations — the top of its decision
    tree. Enumerable WITHOUT verdicts: each probe's (lo, hi) interval is
    fully determined by the accept/reject outcomes above it, and the tree
    covers both outcomes of every node. Level d holds ≤ 2^(d-1) mids, so
    `levels` levels cost ≤ 2^levels − 1 rows."""
    out: List[int] = []
    frontier = [(lo, hi)]
    for _ in range(max(0, levels)):
        nxt: List[Tuple[int, int]] = []
        for l, h in frontier:
            if l > h:
                continue
            m = (l + h) // 2
            out.append(m)
            nxt.append((m + 1, h))  # accepted: search above
            nxt.append((l, m - 1))  # rejected: search below
        if not nxt:
            break
        frontier = nxt
    return sorted(set(out))


def speculative_binary_search(
    evaluate_ks, lo: int, hi: int, acceptable, probe_batch_max: int = 512
):
    """Decision-for-decision replay of the sequential binary search

        while lo <= hi:
            mid = (lo + hi) // 2
            if acceptable(mid): best = mid; lo = mid + 1
            else:               hi = mid - 1

    with the probe frontier evaluated in BATCHED dispatches instead of one
    round-trip per probe. When the remaining interval fits `probe_batch_max`
    every prefix in it is evaluated at once; otherwise one dispatch covers
    the top levels of the binary decision tree (all candidate mids of those
    levels — speculative: half are on paths the replay won't take) and the
    replay consumes cached verdicts until it runs dry. One tree dispatch
    narrows the interval by 2^levels, so any fleet up to ~probe_batch_max²
    candidates resolves in ≤ 2 dispatches.

    Because the replay consumes verdicts in exactly the sequential order,
    the returned best_k is IDENTICAL to the sequential search's — batching
    changes wall-clock, never the decision.

    evaluate_ks(ks) -> verdict per k. Returns (best_k | None,
    probed {k: verdict}, eval_batches)."""
    probe_batch_max = max(1, int(probe_batch_max))
    # 2^levels − 1 ≤ probe_batch_max: the deepest full tree that fits a batch
    levels = max(1, (probe_batch_max + 1).bit_length() - 1)
    probed: Dict[int, object] = {}
    batches = 0
    best: Optional[int] = None
    while lo <= hi:
        mid = (lo + hi) // 2
        if mid not in probed:
            if hi - lo + 1 <= probe_batch_max:
                ks = [k for k in range(lo, hi + 1) if k not in probed]
            else:
                ks = [
                    k
                    for k in binary_probe_frontier(lo, hi, levels)
                    if k not in probed
                ]
            verdicts = evaluate_ks(ks)
            batches += 1
            for k, v in zip(ks, verdicts):
                probed[k] = v
        if acceptable(mid, probed[mid]):
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    return best, probed, batches


@dataclasses.dataclass
class PreparedUniverse:
    enc: object  # EncodedInput
    args: tuple  # device-resident shared kernel args (ffd.ARG_SPEC order)
    pod_cand: np.ndarray  # [N] int64 — candidate id per pod, FFD order
    pod_run: np.ndarray  # [N] int64 — natural run index per pod, FFD order
    node_idx: Dict[int, int]  # candidate id -> E index
    v_delta: Optional[Dict[int, np.ndarray]]  # cid -> [V, Z] zone-count share
    v_count0_host: Optional[np.ndarray] = None  # host copy (per-dispatch base)


class BatchedConsolidationEvaluator:
    def __init__(self, solver: TorchSolver, max_claims: int = 16):
        self.solver = solver
        self.max_claims = max_claims

    def prepare(
        self,
        base_input: SolverInput,
        candidate_pods: Dict[int, list],  # candidate id -> pods (unbound copies)
        candidate_node: Dict[int, str],  # candidate id -> existing-node id
    ) -> Optional[PreparedUniverse]:
        all_pods = [p for pods in candidate_pods.values() for p in pods]
        inp = dataclasses.replace(base_input, pods=all_pods)
        enc = encode(quantize_input(inp))
        if enc.group_fallback.any() or enc.has_topology or enc.has_affinity or enc.G == 0:
            return None
        # positive hostname affinity (kind 2) is handled on the batched path
        # too: the kernel zeroes removed nodes' node_q_member/node_q_owner
        # ROWS per subset, so the scan's global member sums (the bootstrap
        # check) match the sequential simulate's node deletion exactly.

        # Runs stay at NATURAL group granularity (enc.run_group/run_count):
        # same-group pods are fungible, so each subset is expressed as
        # per-run member COUNTS — the scan length stays O(distinct pod
        # specs) instead of O(candidates).
        uid_to_cid = {
            p.meta.uid: cid for cid, pods in candidate_pods.items() for p in pods
        }
        pod_cand = np.fromiter(
            (uid_to_cid[u] for u in enc.sorted_uids), np.int64, len(enc.sorted_uids)
        )
        pod_run = np.repeat(
            np.arange(len(enc.run_count), dtype=np.int64), enc.run_count
        )

        try:
            host_args, dims, prov = host_kernel_args(enc, self.solver._bucket)
        except UnpackableInput:
            return None  # Z*C > 32 — sequential path takes over
        check_kernel_limits(dims, host_args, enc.V > 0, self.solver.device)
        v_count0_host = host_args[_V_COUNT0]
        # upload the shared arrays once, so per-dispatch traffic is the
        # batched axes only, never the constant universe. With the solver's
        # argument arena the universe adopts INTO it: a re-prepare of a
        # shape-identical universe uploads only stale entries as one packed
        # buffer. The universe keys buckets of its own (UNIVERSE_TAG, where
        # the JAX package keys them by its mesh sharding), so universe and
        # single-solve buffers never share a bucket. Without the arena, the
        # per-array upload shares the static arrays' device copies with
        # single solves.
        arena = getattr(self.solver, "arena", None)
        if arena is not None:
            args = arena.adopt(host_args, prov, sharding=UNIVERSE_TAG)
        else:
            args = self.solver._device_args(host_args, prov)

        id_to_e = {nid: e for e, nid in enumerate(enc.node_ids)}
        node_idx = {cid: id_to_e[nid] for cid, nid in candidate_node.items()
                    if nid in id_to_e}
        # Removed candidates' bound pods are re-posed as pending; their share
        # of the initial zone counts must come OUT per subset, or zone-TSC/
        # anti verdicts double-count them against the sequential simulate
        # (which removes the node object entirely).
        v_delta = None
        if enc.V:
            v_delta = {}
            n_dom = len(enc.v_domains) if enc.v_domains is not None else len(enc.zones)
            for cid, e in node_idx.items():
                z = int(enc.v_node_domain[e])
                z2 = (
                    int(enc.node_dom2[e]) if enc.node_dom2 is not None else -1
                )
                if z < 0 and z2 < 0:
                    continue
                d = np.zeros((enc.V, n_dom), dtype=np.int32)
                if z >= 0:
                    d[:, z] = enc.node_v_member[e]
                if z2 >= 0:
                    # mixed-axis universes: the node contributed to BOTH its
                    # zone and its ct column (encode fills both) — subtract
                    # both or ct-sig verdicts double-count removed pods
                    d[:, z2] = enc.node_v_member[e]
                if d.any():
                    v_delta[cid] = d
        return PreparedUniverse(
            enc=enc, args=args, pod_cand=pod_cand, pod_run=pod_run,
            node_idx=node_idx, v_delta=v_delta, v_count0_host=v_count0_host,
        )

    def evaluate_prepared_async(
        self, prep: PreparedUniverse, subsets: Sequence[Sequence[int]]
    ):
        """Dispatch one probe batch; returns a finish() callable that blocks
        on the device->host fetch and builds the verdicts."""
        enc = prep.enc
        out = simulate_subsets(
            prep.args, prep.pod_cand, prep.pod_run, subsets, prep.node_idx,
            self.max_claims, candidate_v_delta=prep.v_delta,
            zone_engine=enc.V > 0, v_count0_host=prep.v_count0_host,
        )
        return lambda: self._finish_verdicts(prep, out, len(subsets))

    def evaluate_prepared(
        self, prep: PreparedUniverse, subsets: Sequence[Sequence[int]]
    ) -> List[SubsetVerdict]:
        return self.evaluate_prepared_async(prep, subsets)()

    def _finish_verdicts(
        self, prep: PreparedUniverse, out, n_subsets: int
    ) -> List[SubsetVerdict]:
        enc = prep.enc
        T, Z, C = enc.T, len(enc.zones), len(enc.capacity_types)
        leftover, used, zc_bits, c_mask = fetch_verdicts(out, T, n_subsets)
        B_, M_ = zc_bits.shape
        c_zone_flat, c_ct_flat = unpack_zc_bits(zc_bits.reshape(-1), Z, C)
        c_zone = c_zone_flat.reshape(B_, M_, Z)
        c_ct = c_ct_flat.reshape(B_, M_, C)
        verdicts: List[SubsetVerdict] = []
        for b in range(n_subsets):
            feasible = leftover[b] == 0 and used[b] <= 1
            price = None
            type_count = 0
            if feasible and used[b] == 1:
                # claims open sequentially from slot 0, so used==1 pins the
                # replacement to slot 0 — asserted so a multi-replacement
                # relaxation cannot silently price the wrong claim
                assert not c_mask[b, 1:].any(), (
                    "replacement-claim invariant violated: used==1 but "
                    "higher slots carry surviving types"
                )
                price = replacement_min_price(
                    c_mask[b, 0], c_zone[b, 0], c_ct[b, 0], enc.offer_avail, enc.offer_price
                )
                type_count = int(c_mask[b, 0].sum())
                if price is None:
                    feasible = False
            verdicts.append(
                SubsetVerdict(
                    ok=bool(feasible),
                    has_replacement=bool(used[b] == 1),
                    replacement_price=price,
                    replacement_type_count=type_count,
                )
            )
        return verdicts

    def evaluate(
        self,
        base_input: SolverInput,
        candidate_pods: Dict[int, list],
        candidate_node: Dict[int, str],
        subsets: Sequence[Sequence[int]],
    ) -> Optional[List[SubsetVerdict]]:
        prep = self.prepare(base_input, candidate_pods, candidate_node)
        if prep is None:
            return None
        return self.evaluate_prepared(prep, subsets)
