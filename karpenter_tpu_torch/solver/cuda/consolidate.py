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

- `batched_ffd` (csrc/ffd_kernels.cu K4, `ffd_batched_kernel<ZONE, MANY>`,
  built as csrc/ffd_batched_kernels.cu): the FFD scan over B subset rows,
  verdict mode (no per-run take tables), on K1's cluster team; the wrapper
  picks the team from B and what the card holds (`batched_team`) and the
  launcher takes it: one cluster of CL CTAs a row where the card holds all
  B such clusters at once, else one CTA a row, several rows an SM;
- `pack_verdicts` (K5): each row's leftover total, `used`, zc bits and
  bit-packed type mask in one int32 buffer, so a dispatch is one fetch.

A CUDA tensor launches the kernel, a CPU tensor runs the plain version.

With more than one device slot (parallel/sharded.py device_slots: several
visible cards, or virtual_devices), the batch axis splits over the
candidate mesh as in the JAX module: `candidate_mesh` holds one slot per
device slot, the universe lies whole on every physical device
(`universe_sharding`, `replicate_shared`), the batch bucket divides over
the slots, slot s owns rows [s B/n, (s+1) B/n), and `_sharded_ffd` (K18)
runs K4 once per physical device over its slots' rows and gathers the
outputs on the mesh's first device in row order, where K5 packs them. On
one card all slots are that card: one K4 launch over every row.

Under a process group of several processes the candidate mesh is the
reference's two-level (dcn, ici) grid: one row per process, each row that
process's own slots. The batch walks the grid in dcn-major row order; each
process runs K4 over its rows on its cards, packs them with K5, and the
packed verdict words of every process are all-gathered over the group, so
every process's prefix search sees every row (`PackedVerdicts`). In one
process `make_candidate_mesh(slots, hosts)` splits the slots contiguously
(the virtual form), which walks the rows as the flat mesh does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...parallel.sharded import (
    Mesh,
    Placement,
    all_gather,
    device_scope,
    device_slots,
    on_device,
    place,
    process_count,
    process_index,
    slot_rows,
)
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


# The batched scan's cluster sizes, widest first (csrc/ffd_kernels.cu
# BATCH_CL); past them the team is one CTA a row (1)
BATCH_CLUSTERS = (16, 8, 4, 2)


def batched_team(B: int, fits: dict) -> int:
    """The team a launch of B subset rows takes (the wrapper passes it to
    csrc/ffd_kernels.cu launch_batched): the largest of BATCH_CLUSTERS whose clusters the card holds
    all B rows at once; past every size 1, one CTA a row of the many-rows
    instance, the rows past what the card holds at once in waves. `fits`:
    {size: clusters of that size the card holds at once, 1: CTAs of the
    many-rows instance it holds at once}, 0 or missing where it refuses a
    size. Raises for B < 1 and where the card holds neither team."""
    if B < 1:
        raise ValueError(f"batched_team: B={B} < 1")
    for cl in BATCH_CLUSTERS:
        if fits.get(cl, 0) >= B:
            return cl
    if fits.get(1, 0) >= 1:
        return 1
    raise ValueError(f"batched_team: the card holds no team of {BATCH_CLUSTERS} or 1 ({fits})")


_FITS: dict = {}


def _rows_bytes(a: dict, zone_engine: bool) -> int:
    return ffd.scan_rows_bytes(int(a["q_kind"].shape[0]), 0, int(a["v_kind"].shape[0]), 0,
                               zone_engine)


def batched_fits(device, zone_engine: bool, rows_bytes: int) -> Optional[dict]:
    """The batched instance's teams on `device` at a launch of `rows_bytes`
    of launch-sized rows (ffd_batched_info, once per device and size):
    {16, 8, 4, 2: clusters the card holds at once (the cluster instance at
    its widest launch), 1: CTAs of the many-rows instance it holds at once,
    "per_sm": that instance's CTAs a SM, "cluster_per_sm": the cluster
    instance's, "sms": the card's SMs}. None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (idx, bool(zone_engine), int(rows_bytes))
    fits = _FITS.get(key)
    if fits is None:
        from .build import load

        out = (ctypes.c_int * 14)()
        with torch.cuda.device(idx):
            rc = load("ffd_batched_kernels").ffd_batched_info(
                (ctypes.c_void_p * 1)(ctypes.addressof(out)), 1,
                ffd._ints([rows_bytes, rows_bytes]), None)
        ffd._raise_on(rc, "ffd_batched_info")
        o = out[7:14] if zone_engine else out[0:7]
        fits = dict(zip(BATCH_CLUSTERS, o[0:4]))
        fits.update({1: o[4] * o[6], "per_sm": o[4], "cluster_per_sm": o[5], "sms": o[6]})
        _FITS[key] = fits
    return fits


def batched_team_info(shared_args, B: int, zone_engine: bool) -> dict:
    """The team a launch of B rows over `shared_args` takes on their card,
    as chip_smoke.py and tools/batched_ab.py report it: shape, cl, CTAs a
    row, threads a CTA, blocks a SM by the occupancy query, rows at once,
    waves, and the fits."""
    a = dict(zip(ffd.ARG_SPEC, shared_args))
    fits = batched_fits(a["node_free"].device, zone_engine, _rows_bytes(a, zone_engine))
    cl = batched_team(B, fits)
    at_once = fits[cl]
    return dict(shape="one CTA a row" if cl == 1 else "one cluster a row", cl=cl,
                ctas_per_row=cl, threads_per_cta=ffd.CLUSTER_THREADS,
                blocks_per_sm=fits["per_sm"] if cl == 1 else fits["cluster_per_sm"],
                rows_at_once=at_once, waves=-(-B // at_once),
                fits={k: v for k, v in fits.items() if isinstance(k, int)})


def _batched_ffd_cuda(shared_args, b_run_count, b_v_count0, cand_member, node_cand,
                      max_claims: int = 16, zone_engine: bool = True,
                      team: Optional[int] = None) -> FFDOutput:
    """K4 on the card, on the team `batched_team` picks from the card's
    fits; the row scratch is sized for that team and the launcher takes it
    as given. `team` (1, 2, 4, 8 or 16) forces another: chip_smoke.py and
    tools/batched_ab.py use it to hold and time every shape; the main path
    passes none."""
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
    cl = batched_team(B, batched_fits(dev, zone_engine, _rows_bytes(a, zone_engine)))
    if team is not None:
        if team not in (1, *BATCH_CLUSTERS):
            raise ValueError(f"{name}: team {team} is not 1 or one of {BATCH_CLUSTERS}")
        cl = int(team)
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
    take_off = ffd.batch_take_offset(E, M, T, Z, cl)
    row_words = ffd.batch_scratch_words(E, M, T, Z, cl)
    scratch = torch.empty((B * row_words,), dtype=I32, device=dev)
    seeds = [a["pool_usage0"], a["node_q_member"], a["node_q_owner"], b_v_count0,
             node_cand, cand_member]
    ptrs = ([a[n] for n in ffd._SCAN_INPUTS] + seeds + list(st)
            + [b_run_count, leftover, events, scratch])
    rc = load("ffd_batched_kernels").ffd_batched_launch(
        ffd._ptrs(ptrs), len(ptrs),
        ffd._ints([Sp, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine), B, NC,
                   row_words, take_off, cl]),
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


# The candidate mesh per slot list and process group (the JAX module builds
# its one process mesh once; keying on the slot list lets virtual_devices
# come and go)
_MESHES: dict = {}


def make_candidate_mesh(devices, hosts: int = 1) -> Mesh:
    """The mesh of the candidate batch axis over the device slots `devices`.

    hosts == 1: the flat 1-D mesh. hosts > 1: the two-level (dcn, ici) grid
    of the reference, dcn-major: under a process group of at least `hosts`
    processes, row p is process p's slots (the least count over the
    processes, gathered over the group; this process holds its own row
    only); in one process, the slots split contiguously into `hosts` rows
    (the virtual form)."""
    devs = list(devices)
    if hosts > 1:
        counts = [int(n) for n in all_gather(len(devs))] if process_count() > 1 else []
        per = min(counts) if counts else 0
        if len(counts) >= hosts and per > 0:
            rank = process_index()
            return Mesh(devs[:per], ("dcn", "ici"), shape=(hosts, per), world=len(counts),
                        rank=rank, offset=rank * per, global_size=hosts * per)
        per = len(devs) // hosts
        return Mesh(devs[: per * hosts], ("dcn", "ici"), shape=(hosts, per))
    return Mesh(devs, "candidates")


def candidate_mesh(device="cuda") -> Optional[Mesh]:
    """The candidate mesh of `device`'s type: under a process group of
    several processes the (dcn, ici) grid over them, else the flat mesh of
    this process's slots, or None with one slot."""
    slots = device_slots(device)
    nproc = process_count()
    key = (slots, nproc, process_index())
    if key not in _MESHES:
        if nproc > 1:
            _MESHES[key] = make_candidate_mesh(slots, hosts=nproc)
        else:
            _MESHES[key] = make_candidate_mesh(slots) if len(slots) > 1 else None
    return _MESHES[key]


def universe_sharding(device="cuda") -> Optional[Placement]:
    """The universe's placement on the candidate mesh (a whole copy on
    every physical device), or None with one slot: the placement the
    argument arena keys the universe's bucket on when the batched evaluator
    adopts through it (disruption/batched.py prepare)."""
    mesh = candidate_mesh(device)
    return None if mesh is None else Placement(mesh, False)


def replicate_shared(kernel_args: tuple, device="cuda") -> tuple:
    """The shared universe (host arrays or tensors) copied once to every
    physical device of the candidate mesh of `device`'s type, which must
    exist: the arena-off path. Placed arrays are tuples over the mesh's
    physical devices."""
    repl = universe_sharding(device)
    return tuple(tuple(a.to(d) for d in repl.mesh.physical) if isinstance(a, torch.Tensor)
                 else place(a, repl) for a in kernel_args)


class PackedVerdicts(NamedTuple):
    """Every row's packed verdict words (pack_verdicts' layout, [B, words]),
    gathered on the host from every process of a process grid."""

    flat: np.ndarray
    M: int
    Tp: int


def _sharded_ffd(mesh: Mesh, shared, rows, max_claims: int, zone_engine: bool):
    """K18, the JAX `_sharded_ffd`: K4 (batched_ffd) once per physical
    device of the candidate mesh over its slots' rows of the batch, with
    the universe copy on that device, then the outputs gathered on the
    mesh's first device in row order. On one card the slots' rows are
    every row: one K4 launch, nothing to gather. On a process grid (the
    (dcn, ici) mesh over a process group) that covers this process's rows
    only: it packs them there with K5 and all-gathers the packed words over
    the group, in rank (dcn) order, which is row order (PackedVerdicts)."""
    b_run_count, b_v_count0, cand_member, node_cand = rows
    parts = []
    for j, (dev, idx) in enumerate(zip(mesh.physical, slot_rows(mesh, b_run_count.shape[0]))):
        with device_scope(dev):
            out = batched_ffd(on_device(shared, j),
                              *upload_rows((b_run_count[idx], b_v_count0[idx], cand_member[idx],
                                            node_cand), dev),
                              max_claims, zone_engine)
        if dev.type == "cuda":
            ffd.LAUNCHES["sharded_ffd"] += 1
        parts.append((idx, out))
    dev0 = mesh.physical[0]
    if len(parts) == 1:
        out = parts[0][1]
    else:
        inv = torch.from_numpy(np.argsort(np.concatenate([idx for idx, _ in parts]))).to(dev0)

        def cat(get):
            return torch.cat([get(o).to(dev0) for _, o in parts])[inv]

        out = FFDOutput(take_e=cat(lambda o: o.take_e), take_c=cat(lambda o: o.take_c),
                        leftover=cat(lambda o: o.leftover),
                        state=FFDState(*(cat(lambda o, i=i: o.state[i])
                                         for i in range(len(FFDState._fields)))),
                        events=cat(lambda o: o.events))
    if mesh.world == 1:
        return out
    with device_scope(dev0):
        words = pack_verdicts(out)
    B_local, M, Tp = out.state.c_mask.shape
    flat = words.cpu().numpy().reshape(B_local, -1)
    return PackedVerdicts(flat=np.concatenate(all_gather(flat)), M=int(M), Tp=int(Tp))


def subset_rows(
    kernel_args: tuple,
    pod_cand: np.ndarray,
    pod_run: np.ndarray,
    subsets: Sequence[Sequence[int]],
    candidate_node_idx: dict,
    candidate_v_delta: Optional[dict] = None,
    v_count0_host: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
):
    """The host construction of simulate_subsets: (b_run_count [Bp, Sp],
    b_v_count0 [Bp, Vp, Z], cand_member [Bp, NC] bool, node_cand [E]) as
    numpy. Rows past len(subsets) are empty subsets (padding); with a
    candidate `mesh`, Bp divides over its slots. `kernel_args` entries are
    tensors, or tuples of tensors over a mesh's physical devices."""
    from ...parallel.sharded import batch_bucket

    def first(a):
        return a[0] if isinstance(a, tuple) else a

    v_count0 = (
        v_count0_host
        if v_count0_host is not None
        else first(kernel_args[_V_COUNT0]).cpu().numpy()
    )
    B = len(subsets)
    S = first(kernel_args[_RUN_COUNT]).shape[0]
    G, E = first(kernel_args[_NODE_COMPAT]).shape
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
    Bp = batch_bucket(B, mesh)

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
    (the disruption filter reads leftovers and the final claim state).
    With a candidate mesh (more than one device slot) the rows split over
    it (K18, `_sharded_ffd`), the universe copied to every physical device
    when `kernel_args` are plain tensors; the output lies on the mesh's
    first device."""
    placed = isinstance(kernel_args[_NODE_COMPAT], tuple)
    dev = (kernel_args[_NODE_COMPAT][0] if placed else kernel_args[_NODE_COMPAT]).device
    mesh = candidate_mesh(dev)
    rows = subset_rows(kernel_args, pod_cand, pod_run, subsets, candidate_node_idx,
                       candidate_v_delta, v_count0_host, mesh=mesh)
    if mesh is None:
        return batched_ffd(tuple(kernel_args), *upload_rows(rows, dev), max_claims, zone_engine)
    if not placed:
        kernel_args = replicate_shared(kernel_args, dev)
    return _sharded_ffd(mesh, tuple(kernel_args), rows, max_claims, zone_engine)


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
    first n_rows real (non-padding) subsets (`out` may be a process grid's
    PackedVerdicts, fetched and gathered already).

    Returns (leftover_total [B], used [B], c_zc_bits [B, M] u32,
    c_mask [B, M, T] bool)."""
    if isinstance(out, PackedVerdicts):  # a process grid's gathered words
        M, Tp, flat = out.M, out.Tp, out.flat[:n_rows]
    else:
        st = out.state
        B, M = st.c_zc_bits.shape
        Tp = st.c_mask.shape[2]
        flat = pack_verdicts(out).cpu().numpy().reshape(B, -1)[:n_rows]
    W = (Tp + 31) // 32
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
