# Port copy of karpenter_tpu/obs/explain.py (no trace plane, no metrics counter).
"""Decision provenance: per-solve explain records + the ExplainStore ring.

A placement is only operable if it can answer "why did pod p land on node
n — and why not the others?". This module defines the CANONICAL explain
record: a pure, deterministic function of (encoded input, final decisions),
so the class planners' legs and the GPU kernel produce
bit-identical records whenever they produce identical decisions — which
turns the record into a parity-debugging weapon: diff two legs' records
and the first divergent field names the disagreement.

Layout of one record (all-JSON, canonically ordered):

  pods[uid]    = {group, chosen}            chosen: ["node", id] |
                                            ["claim", idx] | None
  groups[g]    = {n_rejected, rejected}     rejected: top-K [node_id,
                                            reason] rows, ascending node
                                            input order
  preemptions  = [{node, victim, victim_priority, for_pod}]  plan order ==
                                            the minimal-prefix eviction
                                            rationale (scheduling_class)
  gangs        = {gang_id: {committed, placed, min_ranks}}
  gangs_unschedulable, unplaced             sorted lists

The rejection table is computed by `reason_codes` (numpy) — the exact twin
of the device kernel `solver/cuda/ffd.py explain_pack` (K12); both use int32
arithmetic and the same fixed reason precedence, so the device wire decodes
to the same bits the host deriver produces. Reason names here MUST stay in
sync with `solver/cuda/ffd.py EXPLAIN_REASONS`.

Off path: `configure(enabled=False)` (the default) makes every hook a
cheap early return — no allocation, no encode, no device traffic.

On path, capture is LAZY: the per-solve hook stores references (input,
result, wire table, notes) in the ring — microseconds — and the record
materializes on first read (store get/by_pod/recent, i.e. /debug/explain,
the parity suite, a flight-recorder dump). Building a record walks every
pod, which would tax the hot solve path O(pods) for provenance nobody may
ever read; deferring it keeps explain-on overhead under the bench's 2%
budget. The held `enc` is the encode cache's own object, so the ring
extends lifetimes without duplicating the tensors.

No trace plane is ported: a capture keys its entry by its own counter
(`x000001`, ...) and records `tenant_id` and `journal_seq` as None, which is
what the reference records for a solve outside a trace.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("karpenter_tpu_torch")

# -- reason codes (decoder-side names for cuda/ffd.py EXPLAIN_REASONS) ---------
#
# Precedence is part of the wire contract: when several causes apply the
# SMALLEST nonzero code wins, so both sides evaluate in this order.

REASON_FEASIBLE = 0       # node admits + still fits one more pod of the group
REASON_ZONE = 1           # node zone outside the group's allowed zone set
REASON_CAPACITY_TYPE = 2  # capacity type (spot/on-demand) excluded
REASON_TAINT = 3          # labels/taints admission failed beyond zone/ct
REASON_RESOURCES = 4      # admits, but post-solve free < one more pod
REASON_TOPOLOGY = 5       # statically feasible; group owns a spread engine
REASON_AFFINITY = 6       # statically feasible; group owns affinity terms

REASON_NAMES: Dict[int, str] = {
    REASON_FEASIBLE: "feasible",
    REASON_ZONE: "zone",
    REASON_CAPACITY_TYPE: "capacity_type",
    REASON_TAINT: "taint",
    REASON_RESOURCES: "resources",
    REASON_TOPOLOGY: "topology",
    REASON_AFFINITY: "affinity",
}


# -- configuration -------------------------------------------------------------

_ENABLED = False
_TOP_K = 8
_LOCK = threading.Lock()
_XSEQ = itertools.count(1)  # solve keys (no trace plane)
_TLS = threading.local()    # .notes: class-pass annotations awaiting capture


class ExplainStore:
    """Ring of explain entries keyed by solve_id (newest evicts oldest).

    `put` merges: a later capture for the same solve_id replaces the
    record but unions annotations, so the class pass can re-derive over a
    backend capture without losing the backend's wire provenance."""

    def __init__(self, ring: int = 256):
        self._ring = max(1, int(ring))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()

    def put(self, solve_id: str, entry: dict) -> dict:
        with self._lock:
            prev = self._entries.pop(solve_id, None)
            if prev is not None:
                merged = dict(prev.get("annotations") or {})
                merged.update(entry.get("annotations") or {})
                entry = dict(entry, annotations=merged)
            self._entries[solve_id] = entry
            while len(self._entries) > self._ring:
                self._entries.popitem(last=False)
        return entry

    def get(self, solve_id: str) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(solve_id)
        return _materialize(e) if e is not None else None

    def by_pod(self, uid: str) -> List[dict]:
        with self._lock:
            entries = list(self._entries.values())
        entries = [_materialize(e) for e in entries]
        return [e for e in entries if uid in e["record"]["pods"]]

    def recent(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._entries.values())
        out = out if n is None else out[-int(n):]
        return [_materialize(e) for e in out]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_STORE = ExplainStore()


def configure(enabled: bool = True, top_k: int = 8, ring: int = 256) -> None:
    """(Re)configure the runtime; resets the store — call once at operator
    boot, or per-test for isolation."""
    global _ENABLED, _TOP_K, _STORE
    with _LOCK:
        _ENABLED = bool(enabled)
        _TOP_K = max(1, int(top_k))
        _STORE = ExplainStore(ring=ring)


def enabled() -> bool:
    return _ENABLED


def top_k() -> int:
    return _TOP_K


def store() -> ExplainStore:
    return _STORE


# -- the reason deriver (numpy twin of cuda/ffd.py explain_pack) ---------------


def reason_codes(take_e, run_group, group_req, node_free, node_compat,
                 node_zone, node_ct, group_zone, group_ct,
                 group_topo, group_aff) -> np.ndarray:
    """[G, E] int32 reason code per (group, node). int32 arithmetic and
    precedence identical to the device kernel, so a wire-decoded table and
    a host-derived table agree bit-for-bit on equal inputs."""
    take_e = np.asarray(take_e, dtype=np.int32)
    run_group = np.asarray(run_group, dtype=np.int32)
    group_req = np.asarray(group_req, dtype=np.int32)
    node_free = np.asarray(node_free, dtype=np.int32)
    G = group_req.shape[0]
    req_s = group_req[run_group]                       # [S, R]
    usage = take_e.T.astype(np.int32) @ req_s          # [E, R]
    free_final = node_free - usage
    group_zone = np.asarray(group_zone, bool).reshape(G, -1)
    group_ct = np.asarray(group_ct, bool).reshape(G, -1)
    # zero-width axes (no zones / capacity types known) pad to one all-False
    # column; node_zone/node_ct are -1 there so the where() never reads it —
    # the device dispatch pads identically, keeping the tables bit-equal
    if group_zone.shape[1] == 0:
        group_zone = np.zeros((G, 1), dtype=bool)
    if group_ct.shape[1] == 0:
        group_ct = np.zeros((G, 1), dtype=bool)
    Z, C = group_zone.shape[1], group_ct.shape[1]
    zid = np.clip(node_zone, 0, Z - 1)
    cid = np.clip(node_ct, 0, C - 1)
    zone_ok = np.where(node_zone[None, :] >= 0, group_zone[:, zid], True)
    ct_ok = np.where(node_ct[None, :] >= 0, group_ct[:, cid], True)
    compat = np.asarray(node_compat, bool)
    fits = np.all(free_final[None, :, :] >= group_req[:, None, :], axis=-1)
    ghot = (run_group[None, :] == np.arange(G, dtype=np.int32)[:, None])
    placed = (ghot.astype(np.int32) @ take_e) > 0      # [G, E]
    code = np.where(
        ~zone_ok, REASON_ZONE,
        np.where(~ct_ok, REASON_CAPACITY_TYPE,
        np.where(~compat, REASON_TAINT,
        np.where(~fits, REASON_RESOURCES,
        np.where(np.asarray(group_topo, bool)[:, None], REASON_TOPOLOGY,
        np.where(np.asarray(group_aff, bool)[:, None], REASON_AFFINITY,
                 REASON_FEASIBLE))))))
    # a node the group actually landed pods on is never "rejected"
    return np.where(placed, REASON_FEASIBLE, code).astype(np.int32)


def rejection_table(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_rejected [G] i32, words [G, k] i32) — word = e | (code << 16),
    -1 marks an empty slot; entries ascend by node input order. Identical
    packing to the device wire body."""
    G, E = codes.shape
    rej = codes > 0
    n_rej = rej.sum(axis=1).astype(np.int32)
    e_idx = np.arange(E, dtype=np.int32)
    key = np.where(rej, e_idx[None, :], E)
    order = np.argsort(key, axis=1, kind="stable")[:, :k]
    ent_e = np.take_along_axis(key, order, axis=1)
    ent_c = np.take_along_axis(codes, order, axis=1)
    valid = ent_e < E
    words = np.where(valid, ent_e | (ent_c << 16), -1).astype(np.int32)
    if words.shape[1] < k:  # fewer nodes than top-k: pad empty slots
        pad = np.full((G, k - words.shape[1]), -1, dtype=np.int32)
        words = np.concatenate([words, pad], axis=1)
    return n_rej, words


def takes_from_result(enc, placements: Dict[str, tuple]) -> np.ndarray:
    """Reconstruct the dense [S, E] run→node take table from final
    placements (the inverse of backend.decode's codes stream) — how a
    host-derived record recovers the tensor the kernel emits natively."""
    S = int(enc.run_group.shape[0])
    E = len(enc.node_ids)
    node_rank = {nid: e for e, nid in enumerate(enc.node_ids)}
    take = np.zeros((S, E), dtype=np.int32)
    pos = 0
    for s in range(S):
        c = int(enc.run_count[s])
        for uid in enc.sorted_uids[pos:pos + c]:
            t = placements.get(uid)
            if t is not None and t[0] == "node":
                e = node_rank.get(t[1])
                if e is not None:
                    take[s, e] += 1
        pos += c
    return take


def host_table(enc, placements: Dict[str, tuple], k: int):
    """Full host derivation: final takes → reason codes → packed table.
    Consumes the same side tables the device kernel dispatches over
    (encode.explain_tables), so the two outputs are bit-comparable."""
    from ..solver.encode import explain_tables

    take = takes_from_result(enc, placements)
    codes = reason_codes(take, **explain_tables(enc))
    return rejection_table(codes, k)


# -- record assembly -----------------------------------------------------------


def build_record(enc, res, k: Optional[int] = None,
                 table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 notes: Optional[Dict[str, list]] = None) -> dict:
    """The canonical record. `table` injects a wire-decoded (n_rej, words)
    pair (the device leg); None derives it on the host — both must be bit-equal,
    which the parity suite asserts."""
    k = _TOP_K if k is None else int(k)
    if table is None:
        table = host_table(enc, res.placements, k)
    n_rej, words = table
    node_ids = list(enc.node_ids)
    G = int(enc.group_req.shape[0])
    groups: List[dict] = []
    for g in range(G):
        rejected = []
        for w in words[g]:
            w = int(w)
            if w < 0:
                continue
            e, code = w & 0xFFFF, (w >> 16) & 0xFFFF
            name = REASON_NAMES.get(code, f"code{code}")
            nid = node_ids[e] if e < len(node_ids) else f"e{e}"
            rejected.append([nid, name])
        groups.append({"n_rejected": int(n_rej[g]), "rejected": rejected})
    pods: Dict[str, dict] = {}
    if int(enc.run_group.shape[0]):
        # run→pod expansion vectorized; per-pod work is one dict lookup
        uid_group = np.repeat(np.asarray(enc.run_group, dtype=np.int64),
                              np.asarray(enc.run_count, dtype=np.int64))
        get = res.placements.get
        for uid, g in zip(enc.sorted_uids, uid_group.tolist()):
            t = get(uid)
            pods[str(uid)] = {
                "group": g,
                "chosen": [t[0], t[1]] if t is not None else None,
            }
    preemptions = [
        {
            "node": ev.node_id,
            "victim": ev.pod_uid,
            "victim_priority": int(ev.victim_priority),
            "for_pod": ev.for_pod,
        }
        for ev in getattr(res, "evictions", ())
    ]
    gangs: Dict[str, dict] = {}
    for n in (notes or {}).get("gang", ()):
        gangs[n["gang"]] = {
            "committed": bool(n["committed"]),
            "placed": int(n["placed"]),
            "min_ranks": int(n["min_ranks"]),
        }
    return {
        "top_k": k,
        "n_groups": G,
        "pods": pods,
        "groups": groups,
        "preemptions": preemptions,
        "gangs": gangs,
        "gangs_unschedulable": sorted(set(getattr(res, "gangs_unschedulable", ()))),
        "unplaced": sorted(u for u in pods if pods[u]["chosen"] is None),
    }


def fingerprint(record: dict) -> str:
    """Stable content hash — two legs agree iff their fingerprints do."""
    blob = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def diff_records(a: dict, b: dict) -> List[str]:
    """First-divergence paths between two records (parity debugging)."""
    out: List[str] = []

    def walk(x, y, path):
        if len(out) >= 32:
            return
        if isinstance(x, dict) and isinstance(y, dict):
            for kk in sorted(set(x) | set(y)):
                if kk not in x:
                    out.append(f"{path}.{kk}: missing in A")
                elif kk not in y:
                    out.append(f"{path}.{kk}: missing in B")
                else:
                    walk(x[kk], y[kk], f"{path}.{kk}")
        elif isinstance(x, list) and isinstance(y, list):
            if len(x) != len(y):
                out.append(f"{path}: len {len(x)} != {len(y)}")
            for i, (xi, yi) in enumerate(zip(x, y)):
                walk(xi, yi, f"{path}[{i}]")
        elif x != y:
            out.append(f"{path}: {x!r} != {y!r}")

    walk(a, b, "$")
    return out


# -- capture hooks (called by the solver legs) ---------------------------------


def note(kind: str, payload: dict) -> None:
    """Stage a class-pass annotation (gang verdict, preemption rationale)
    for the enclosing class-level capture. No-op when explain is off."""
    if not _ENABLED:
        return
    notes = getattr(_TLS, "notes", None)
    if notes is None:
        notes = _TLS.notes = {}
    notes.setdefault(kind, []).append(payload)


def _drain_notes() -> Dict[str, list]:
    notes = getattr(_TLS, "notes", None)
    _TLS.notes = {}
    return notes or {}


def _materialize(entry: dict) -> dict:
    """Build a deferred entry's record in place (idempotent). Reads are
    rare — the debug endpoint, the parity suite, a crash dump — so the
    O(pods) record assembly runs here instead of on the solve path."""
    if entry.get("_defer") is None:
        return entry
    with _LOCK:
        d = entry.pop("_defer", None)
        if d is None:
            return entry
        inp, enc, res, table, notes, k = d
        try:
            if enc is None:
                from ..solver.encode import encode, quantize_input
                enc = encode(quantize_input(inp))
            record = build_record(enc, res, k=k, table=table, notes=notes)
            entry["record"] = record
            entry["fingerprint"] = fingerprint(record)
        except Exception:  # noqa: BLE001 — diagnostics never abort a read
            log.exception("explain: deferred record build failed")
            entry["record"] = {
                "top_k": k, "n_groups": 0, "pods": {}, "groups": [],
                "preemptions": [], "gangs": {}, "gangs_unschedulable": [],
                "unplaced": [], "error": "materialize failed",
            }
            entry["fingerprint"] = None
    return entry


def capture(inp, res, backend: str, enc=None,
            table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            annotations: Optional[dict] = None,
            drain_notes: bool = False) -> Optional[dict]:
    """Store the explain entry for one solve. Never raises: provenance
    must not fail a solve. The stored entry is DEFERRED — only references
    are kept here; the record builds on first store read. Returns the
    stored entry (tests) or None when disabled/failed."""
    if not _ENABLED:
        return None
    try:
        notes = _drain_notes() if drain_notes else None
        ann = dict(annotations or {})
        ann.setdefault("source", "device" if table is not None else "host")
        ann["backend"] = backend
        sid = f"x{next(_XSEQ):06d}"
        entry = {
            "solve_id": sid,
            "tenant_id": None,
            "journal_seq": None,
            "annotations": ann,
            "_defer": (inp, enc, res, table, notes, _TOP_K),
        }
        return _STORE.put(sid, entry)
    except Exception:  # noqa: BLE001 — diagnostics never abort a solve
        log.exception("explain: capture failed (backend=%s) — continuing",
                      backend)
        return None
