"""Batched consolidation simulation (BASELINE config 5) on the GPU: the port
of karpenter_tpu/solver/tpu/consolidate.py.

The disruption engine re-solves scheduling once per candidate subset. Every
subset is a row of a leading batch axis, evaluated in ONE launch:

  - per-subset pods: the union of the subset's reschedulable pods, as
    per-run member COUNTS (same-group pods are fungible, so the scan stays
    O(distinct pod specs));
  - per-subset capacity: the shared existing-node tensors with the subset's
    nodes removed — derived on the device from a [B, NC] membership matrix
    and a shared [E] node -> candidate map, so no [B, G, E] tensor is built;
  - per-subset zone counts: the removed candidates' share of v_count0 comes
    out on the host (zone counts are global);
  - everything else broadcasts unbatched.

Each row IS the sequential simulation of its subset, so decisions equal the
sequential path's. max_claims for simulations is small (a subset needing
more than one replacement is rejected anyway); slot saturation can only
under-count claims for rows that are already rejected (used > 1).

Two kernels, each with a plain PyTorch version beside it:

- `batched_ffd` (csrc/ffd_kernels.cu K4, `ffd_scan_kernel<ZONE, true>`):
  the FFD scan over B subset rows, one block per row, verdict mode (no
  per-run take tables);
- `pack_verdicts` (K5): each row's leftover total, `used`, zc bits and
  bit-packed type mask in one int32 buffer, so a dispatch is one fetch.

A CUDA tensor launches the kernel, a CPU tensor runs the plain version.
The multi-device forms of the JAX module (`_sharded_ffd`, the candidate
mesh, `replicate_shared`) are not here: the batch runs on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import ffd
from .ffd import ARG_INDEX, I32, FFDOutput, FFDState, _i32_bits, ffd_solve_plain

# Batched axes (ffd.ARG_SPEC): run_count per-subset member pod counts per
# natural run; node_compat per-subset node removal (derived on the device);
# v_count0 with the removed candidates' zone-count contributions taken out;
# node_q_member / node_q_owner with removed rows zeroed. Everything else
# broadcasts.
_RUN_COUNT = ARG_INDEX["run_count"]
_NODE_COMPAT = ARG_INDEX["node_compat"]
_V_COUNT0 = ARG_INDEX["v_count0"]
_NODE_QM = ARG_INDEX["node_q_member"]
_NODE_QO = ARG_INDEX["node_q_owner"]


def _empty_takes(B: int, E: int, M: int, dev):
    """Verdict mode emits no per-run take tables: [B, 0, E] and [B, 0, M]."""
    return (torch.zeros((B, 0, E), dtype=I32, device=dev),
            torch.zeros((B, 0, M), dtype=I32, device=dev))


def batched_ffd_plain(shared_args, b_run_count, b_v_count0, cand_member, node_cand,
                      max_claims: int = 16, zone_engine: bool = True) -> FFDOutput:
    """Plain version: ffd_solve_plain on each row's modified arguments (the
    JAX module vmaps the same per-row construction)."""
    node_compat = shared_args[_NODE_COMPAT]
    nc = cand_member.shape[1]
    dev = node_compat.device
    rows = []
    for b in range(b_run_count.shape[0]):
        removed = (node_cand >= 0) & cand_member[b][torch.clamp(node_cand, 0, max(nc - 1, 0)).long()]
        args = list(shared_args)
        args[_RUN_COUNT] = b_run_count[b]
        args[_NODE_COMPAT] = node_compat & ~removed[None, :]
        args[_V_COUNT0] = b_v_count0[b]
        keep = (~removed)[:, None].to(I32)
        args[_NODE_QM] = shared_args[_NODE_QM] * keep
        args[_NODE_QO] = shared_args[_NODE_QO] * keep
        rows.append(ffd_solve_plain(*args, max_claims=max_claims, zone_engine=zone_engine))
    E = node_compat.shape[1]
    take_e, take_c = _empty_takes(len(rows), E, max_claims, dev)
    return FFDOutput(
        take_e=take_e,
        take_c=take_c,
        leftover=torch.stack([o.leftover for o in rows]),
        state=FFDState(*[torch.stack([o.state[i] for o in rows])
                         for i in range(len(FFDState._fields))]),
        events=torch.stack([o.events for o in rows]),
    )


def _batched_ffd_cuda(shared_args, b_run_count, b_v_count0, cand_member, node_cand,
                      max_claims: int = 16, zone_engine: bool = True) -> FFDOutput:
    from .build import load

    a = dict(zip(ffd.ARG_SPEC, shared_args))
    M = int(max_claims)
    name = "ffd_batched_zoned_scan" if zone_engine else "ffd_batched_fast_scan"
    Sp, G, T, E, P, R, Q, W, V, Z = ffd._check_scan_args(a, zone_engine, name)
    B, NC = cand_member.shape
    ffd._check(b_run_count, "b_run_count", I32, (B, Sp))
    ffd._check(b_v_count0, "b_v_count0", I32, (B, V, Z))
    ffd._check(cand_member, "cand_member", torch.bool, (B, NC))
    ffd._check(node_cand, "node_cand", I32, (E,))
    if NC < 1:
        raise ValueError(f"{name}: the candidate axis is empty")
    dev = b_run_count.device
    e = lambda *s: torch.empty((B, *s), dtype=I32, device=dev)  # noqa: E731
    eb = lambda *s: torch.empty((B, *s), dtype=torch.bool, device=dev)  # noqa: E731
    # the carry, seeded by the kernel's prologue from the shared seeds and
    # the row's subset (FFDState order)
    st = FFDState(
        e_cum=e(E, R), c_cum=e(M, R), c_mask=eb(M, T), c_zc_bits=e(M), c_gbits=e(M, W),
        c_pool=e(M), used=e(), p_usage=e(P, R), e_cm=e(E, Q), e_co=e(E, Q),
        c_cm=e(M, Q), c_co=e(M, Q), v_count=e(V, Z), v_owner_z=eb(V, Z), c_vm=e(M, V),
        c_vo=eb(M, V),
    )
    leftover = e(Sp)
    events = e()
    take_off = ffd.scan_scratch_words(E, M, T, Z)
    row_words = ffd.batch_scratch_words(E, M, T, Z)
    scratch = torch.empty((B * row_words,), dtype=I32, device=dev)
    seeds = [a["pool_usage0"], a["node_q_member"], a["node_q_owner"], b_v_count0,
             node_cand, cand_member]
    ptrs = ([a[n] for n in ffd._SCAN_INPUTS] + seeds + list(st)
            + [b_run_count, leftover, events, scratch])
    rc = load().ffd_batched_launch(
        ffd._ptrs(ptrs), len(ptrs),
        ffd._ints([Sp, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine), B, NC,
                   row_words, take_off]),
        ffd._stream(),
    )
    ffd._raise_on(rc, name)
    ffd.LAUNCHES[name] += 1
    take_e, take_c = _empty_takes(B, E, M, dev)
    return FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st, events=events)


def batched_ffd(shared_args, b_run_count, b_v_count0, cand_member, node_cand,
                max_claims: int = 16, zone_engine: bool = True) -> FFDOutput:
    """The FFD scan over B subset rows (verdict mode): FFDOutput with a
    leading B axis, take_e [B, 0, E], take_c [B, 0, M], leftover [B, Sp],
    every FFDState field [B, ...] and events [B]."""
    if b_run_count.is_cuda:
        return _batched_ffd_cuda(shared_args, b_run_count, b_v_count0, cand_member,
                                 node_cand, max_claims, zone_engine)
    return batched_ffd_plain(shared_args, b_run_count, b_v_count0, cand_member, node_cand,
                             max_claims, zone_engine)


def subset_rows(
    kernel_args: tuple,
    pod_cand: np.ndarray,
    pod_run: np.ndarray,
    subsets: Sequence[Sequence[int]],
    candidate_node_idx: dict,
    candidate_v_delta: Optional[dict] = None,
    v_count0_host: Optional[np.ndarray] = None,
):
    """The host construction of simulate_subsets: (b_run_count [Bp, Sp],
    b_v_count0 [Bp, Vp, Z], cand_member [Bp, NC] bool, node_cand [E]) as
    numpy. Rows past len(subsets) are empty subsets (padding)."""
    from ...parallel.sharded import batch_bucket

    v_count0 = (
        v_count0_host
        if v_count0_host is not None
        else kernel_args[_V_COUNT0].cpu().numpy()
    )
    B = len(subsets)
    S = kernel_args[_RUN_COUNT].shape[0]
    G, E = kernel_args[_NODE_COMPAT].shape
    # candidate-id universe: pods AND nodes (an empty candidate has no pods
    # but its node must still be removed from subset capacity)
    NC = 1
    if pod_cand.size:
        NC = max(NC, int(pod_cand.max()) + 1)
    if candidate_node_idx:
        NC = max(NC, max(candidate_node_idx) + 1)
    # bucket the dims so dispatches see one shape per bucket; padded rows
    # simulate an empty subset and are sliced off before verdict decoding
    NC = ((NC + 63) // 64) * 64
    Bp = batch_bucket(B, None)

    b_run_count = np.zeros((Bp, S), dtype=np.int32)
    b_v_count0 = np.broadcast_to(v_count0, (Bp,) + v_count0.shape).copy()
    cand_member = np.zeros((Bp, NC), dtype=bool)
    for b, subset in enumerate(subsets):
        sub = np.asarray(list(subset), dtype=np.int64)
        cand_member[b, sub[sub < NC]] = True
        member = np.isin(pod_cand, sub)
        b_run_count[b] = np.bincount(pod_run[member], minlength=S).astype(np.int32)
        for cid in subset:
            if candidate_v_delta is not None:
                d = candidate_v_delta.get(cid)
                if d is not None and d.size:
                    V, Z = d.shape
                    b_v_count0[b, :V, :Z] -= d

    node_cand = np.full(E, -1, dtype=np.int32)
    for cid, e in candidate_node_idx.items():
        if 0 <= e < E and cid < NC:
            node_cand[e] = cid
    return b_run_count, b_v_count0, cand_member, node_cand


def upload_rows(rows, device) -> tuple:
    """subset_rows' numpy arrays -> tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in rows)


def simulate_subsets(
    kernel_args: tuple,  # device tensors, ffd.ARG_SPEC order
    pod_cand: np.ndarray,  # [N] int64 — candidate id per pod, FFD order
    pod_run: np.ndarray,  # [N] int64 — run index per pod, FFD order
    subsets: Sequence[Sequence[int]],  # candidate-id subsets to evaluate
    candidate_node_idx: dict,  # candidate id -> existing-node index (E axis)
    max_claims: int = 16,
    candidate_v_delta: Optional[dict] = None,  # cid -> [V, Z] zone-count share
    zone_engine: bool = True,
    v_count0_host: Optional[np.ndarray] = None,  # host copy of args[v_count0]
) -> FFDOutput:
    """Evaluate each subset; returns FFDOutput with leading batch axis Bp.

    kernel_args: the shared (padded) ffd_solve tensors for the FULL
    simulation universe (all candidates' pods pending, all nodes present),
    with runs at NATURAL group granularity: a subset's pods are per-run
    COUNTS of its member pods, and removing pods from a sorted list keeps
    FFD order. Verdict mode only: the per-run take tables are not emitted
    (the disruption filter reads leftovers and the final claim state)."""
    rows = subset_rows(kernel_args, pod_cand, pod_run, subsets, candidate_node_idx,
                       candidate_v_delta, v_count0_host)
    dev = kernel_args[_NODE_COMPAT].device
    return batched_ffd(tuple(kernel_args), *upload_rows(rows, dev), max_claims, zone_engine)


def verdict_words(M: int, Tp: int) -> int:
    """int32 words per row of the verdict buffer: leftover total, used, M zc
    words, M * ceil(Tp/32) type-mask words."""
    return 2 + M + M * ((Tp + 31) // 32)


def pack_verdicts_plain(out: FFDOutput) -> torch.Tensor:
    """Plain version of K5: every host-consumed verdict field in ONE int32
    buffer [B * verdict_words]; c_mask bit-packs to uint32 words (bit i of
    word w is type 32w + i). The leftover total wraps as int32."""
    st = out.state
    B, M, Tp = st.c_mask.shape
    W = (Tp + 31) // 32
    total = _i32_bits(out.leftover.to(torch.int64).sum(dim=1) & 0xFFFFFFFF)
    words = ffd.pack_mask_words_plain(st.c_mask.reshape(B * M, Tp)).reshape(B, M * W)
    return torch.cat(
        [total.reshape(B, 1), st.used.reshape(B, 1).to(I32), st.c_zc_bits.to(I32), words],
        dim=1,
    ).reshape(-1)


def _pack_verdicts_cuda(out: FFDOutput) -> torch.Tensor:
    from .build import load

    st = out.state
    B, M, Tp = st.c_mask.shape
    Sp = out.leftover.shape[1]
    ffd._check(out.leftover, "leftover", I32, (B, Sp))
    ffd._check(st.used, "used", I32, (B,))
    ffd._check(st.c_zc_bits, "c_zc_bits", I32, (B, M))
    ffd._check(st.c_mask, "c_mask", torch.bool, (B, M, Tp))
    flat = torch.empty((B * verdict_words(M, Tp),), dtype=I32, device=st.c_mask.device)
    rc = load().pack_verdicts_launch(
        ffd._ptrs([out.leftover, st.used, st.c_zc_bits, st.c_mask, flat]), 5,
        ffd._ints([B, Sp, M, Tp]), ffd._stream(),
    )
    ffd._raise_on(rc, "pack_verdicts")
    ffd.LAUNCHES["pack_verdicts"] += 1
    return flat


def pack_verdicts(out: FFDOutput) -> torch.Tensor:
    if out.state.c_mask.is_cuda:
        return _pack_verdicts_cuda(out)
    return pack_verdicts_plain(out)


def fetch_verdicts(out: FFDOutput, T: int, n_rows: int):
    """One-transfer fetch of the per-subset verdict fields, sliced to the
    first n_rows real (non-padding) subsets.

    Returns (leftover_total [B], used [B], c_zc_bits [B, M] u32,
    c_mask [B, M, T] bool)."""
    st = out.state
    B, M = st.c_zc_bits.shape
    Tp = st.c_mask.shape[2]
    W = (Tp + 31) // 32
    flat = pack_verdicts(out).cpu().numpy().reshape(B, -1)[:n_rows]
    leftover = flat[:, 0]
    used = flat[:, 1]
    zc = flat[:, 2 : 2 + M].view(np.uint32)
    words = flat[:, 2 + M :].view(np.uint32).reshape(n_rows, M, W)
    bits = (
        words[:, :, :, None] >> np.arange(32, dtype=np.uint32)[None, None, None, :]
    ) & 1
    cm = bits.reshape(n_rows, M, W * 32)[:, :, :T].astype(bool)
    return leftover, used, zc, cm


def replacement_min_price(
    c_mask_row: np.ndarray,  # [T] bool (sliced to real T)
    c_zone_row: np.ndarray,  # [Z] bool
    c_ct_row: np.ndarray,  # [C] bool
    offer_avail: np.ndarray,  # [T, Z, C]
    offer_price: np.ndarray,  # [T, Z, C]
) -> Optional[float]:
    """Cheapest offering reachable by the simulated replacement claim."""
    ok = (
        offer_avail
        & c_mask_row[:, None, None]
        & c_zone_row[None, :, None]
        & c_ct_row[None, None, :]
    )
    if not ok.any():
        return None
    return float(offer_price[ok].min())
