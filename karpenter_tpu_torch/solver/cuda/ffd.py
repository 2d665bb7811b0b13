"""FFD bin-packing on the GPU: the port of karpenter_tpu/solver/tpu/ffd.py.

The scan walks runs of identical pods in FFD order. A run whose group owns
no zone/capacity-type domain constraint goes through the FAST branch: it
pours first-fit onto existing nodes, then onto open claims, then opens new
claims pool by pool in closed form, and records the domain counts of the
V-axis sigs it is a member of. With `zone_engine=True` (the solve has V-axis
sigs), a run whose group owns a V-axis sig or is a member of an anti sig
goes through the ZONED branch instead: the domain event engine, a loop of
events that each place a closed-form batch (see the JAX module's
docstring for the derivation and the three closed forms).

Each function comes in two forms:

- a plain PyTorch version (`*_plain`), a step-by-step transcription of the
  JAX code, which the CPU tests hold against the JAX package and the chip
  smoke holds the kernels against;
- a wrapper over a hand-written CUDA kernel (`csrc/ffd_kernels.cu`).

The public entry points dispatch on the tensors' device: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version. There is no
fallback from one to the other.

Tensor conventions: all integer work is int32, as in the JAX reference
(x64 off). uint32 bit words (zone/ct bits, group bits, type-mask words)
travel as int32 bit patterns; bool tables are torch.bool.

Both forms count the zoned branch's events per solve (`FFDOutput.events`),
the counterpart of the JAX module's KTPU_DEBUG_EVENTS diagnostic that
leaves `leftover` intact.

`ffd_solve_ladder` is the relax-ladder scan (the JAX `ffd_solve_ladder`):
each run walks a cascade of attempts over its pre-materialized rung groups,
every attempt one step of the scan above; its output also counts the
attempts (`LadderOutput.attempts`).

`ffd_solve_ckpt` is the scan that also snapshots its whole carry into a
`CheckpointRing` every `ckpt_every` steps, and `ffd_resume` the same scan
started from a snapshot over a run suffix (the JAX `ffd_solve_ckpt` /
`ffd_resume`): the solver's default dispatch and its suffix replay.

The sparse twins (`ffd_solve_sparse`, `ffd_solve_ckpt_sparse`,
`ffd_resume_sparse`, `ffd_solve_ladder_sparse`; the JAX ffd.py:2403-2800)
take the run-major index tables of SPARSE_ARG_SPEC ahead of the arguments
and read each run's hostname and zone-sig state through them (`_Run`'s
view); their outputs, rings included, are the dense scans'.
`pack_outputs` is the dense output pack (the JAX backend.py:511
`_pack_outputs`), the fetch of `TorchSolver(device_decode=False)`.

The side kernels of the scheduling-class passes and of decision provenance
close the module (the JAX ffd.py:2920-3105): `gang_commit` (the atomic gang
verdict), `preemption_plan` (one planned preemption) with the eviction
table's wire, `preemption_walk` (the class pass's whole preemption loop,
every candidate planned in order in one launch over tables that stay on the
card), and `explain_pack` (the per-group rejection table) with the explain
wire; their kernels are csrc/class_kernels.cu (K10-K12, the walk).

`ffd_solve_lanes` is the scan over a leading lane axis (the JAX
`jax.vmap(ffd_solve)` of parallel/sharded.py batched_solve, the fused
cohort dispatch): K15, one thread-block cluster a lane, its size chosen
at launch from the lanes the card holds at once (`lanes_cluster`;
csrc/ffd_lanes_kernels.cu).
`ffd_solve_sharded` and `ffd_solve_sharded_sparse` are the lanes of a
mesh-sharded solve (the JAX ffd.py:2264 / :2800): only the run arrays (and
the index tables) carry a leading [Nd] block axis, the other tables are
shared by every lane; K17 is K15's kernel with the shared tables at a
per-lane count of 0, K17s the sparse lanes kernel
(csrc/ffd_lanes_sparse_kernels.cu). `ffd_apply_events` scatters the
streaming stage's (pos, gid, cnt) edit rows into the run tables (the JAX
`ffd_apply_events`): K14, csrc/arena_kernels.cu.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1
BIG = 2**30

# Positional argument table for ffd_solve; identical to the JAX package's
# (tests/test_torch_isolation.py pins the copy).
ARG_SPEC = (
    "run_group",
    "run_count",
    "group_req",
    "group_compat_t",
    "group_zc_bits",
    "group_pool",
    "group_pair_nok",
    "group_device",
    "type_alloc",
    "type_charge",
    "offer_zc_bits",
    "pool_type",
    "pool_zc_bits",
    "pool_daemon",
    "pool_limit",
    "pool_usage0",
    "node_free",
    "node_compat",
    "q_member",
    "q_owner",
    "q_kind",
    "q_cap",
    "node_q_member",
    "node_q_owner",
    "v_member",
    "v_owner",
    "v_kind",
    "v_cap",
    "v_primary",
    "v_aff",
    "v_count0",
    "node_zone",
    "zone_col_mask",
    "node_dom2",
    "col_axis",
    "group_daxis",
)

ARG_INDEX = {name: i for i, name in enumerate(ARG_SPEC)}

# Side tables of the sparse scans (ffd_solve_sparse and its twins), leading
# their signatures as in the JAX package: per-run active hostname-sig
# (run_q_idx [S, Kq]) and zone-sig (run_v_idx [S, Kv]) indices, int32, -1
# padded (solver/encode.py sparse_run_tables).
SPARSE_ARG_SPEC = (
    "run_q_idx",
    "run_v_idx",
)

# Element type of each argument as host_kernel_args builds it: "u32" arrays
# cross into torch as int32 views of the same bits.
_BOOL_ARGS = frozenset({
    "group_compat_t", "group_pool", "group_device", "pool_type", "node_compat",
    "q_member", "q_owner", "v_member", "v_owner",
})
_U32_ARGS = frozenset({
    "group_zc_bits", "group_pair_nok", "offer_zc_bits", "pool_zc_bits",
    "zone_col_mask",
})
ARG_DTYPES = {
    n: ("bool" if n in _BOOL_ARGS else "u32" if n in _U32_ARGS else "i32")
    for n in ARG_SPEC
}


class FFDState(NamedTuple):
    e_cum: torch.Tensor  # [E, R] int32 — requests placed on existing nodes
    c_cum: torch.Tensor  # [M, R] int32 — requests on claim slots (incl daemon)
    c_mask: torch.Tensor  # [M, T] bool — surviving instance types
    c_zc_bits: torch.Tensor  # [M] u32 as int32 — joint (zone, ct) feasibility bits
    c_gbits: torch.Tensor  # [M, W] u32 as int32 — groups placed on each claim
    c_pool: torch.Tensor  # [M] int32 — pool index, -1 if unopened
    used: torch.Tensor  # scalar int32 — claims opened so far
    p_usage: torch.Tensor  # [P, R] int32 — pool usage (limit accounting)
    e_cm: torch.Tensor  # [E, Q] int32 — matching (member) pods per sig
    e_co: torch.Tensor  # [E, Q] int32 — anti-owner pod presence per sig
    c_cm: torch.Tensor  # [M, Q] int32
    c_co: torch.Tensor  # [M, Q] int32
    v_count: torch.Tensor  # [V, Z] int32
    v_owner_z: torch.Tensor  # [V, Z] bool
    c_vm: torch.Tensor  # [M, V] int32
    c_vo: torch.Tensor  # [M, V] bool


class FFDOutput(NamedTuple):
    take_e: torch.Tensor  # [S, E] int32 — pods of run s placed per existing node
    take_c: torch.Tensor  # [S, M] int32 — pods of run s placed per claim slot
    leftover: torch.Tensor  # [S] int32 — pods of run s that failed to place
    state: FFDState
    events: torch.Tensor  # scalar int32 — zoned-branch events of the solve


class CheckpointRing(NamedTuple):
    """Fixed-size ring of FFDState snapshots taken every `ckpt_every` scan
    steps: each FFDState field stacked along a leading [n_ckpt] axis, and
    `prefix[slot]`, the scan steps applied when the slot was written (-1:
    never written). Step j·ckpt_every lands in slot (j-1) % n_ckpt, padded
    steps included, so the host recomputes coverage from (Sp, ckpt_every,
    n_ckpt) alone; padded steps leave the state as it is, so a snapshot at
    position p covers min(p, S_real) real runs."""

    states: FFDState  # each field: [n_ckpt, ...field shape]
    prefix: torch.Tensor  # [n_ckpt] int32, -1 empty


class LadderOutput(NamedTuple):
    """FFDOutput of the relax-ladder scan, plus its attempt count."""

    take_e: torch.Tensor
    take_c: torch.Tensor
    leftover: torch.Tensor
    state: FFDState
    events: torch.Tensor
    attempts: torch.Tensor  # scalar int32 — step bodies run (base and rung attempts)


# The streaming run-table edits (ffd_apply_events): one int32 row per edited
# run position; padding rows carry pos = EVENT_PAD_POS and are dropped by
# the scatter. Equal to the JAX package's (tests/test_torch_isolation.py).
EVENT_ENTRY_WORDS = 3  # (pos, gid, cnt) int32 per run edit
EVENT_PAD_POS = -1  # padding rows scatter out of range and are dropped
# host edit rows that ride in K14's launch parameters (csrc/arena_kernels.cu
# EV_PARAM_ROWS: 3 KB of the 4 KB parameter space); more are copied first
EVENT_PARAM_ROWS = 256

# Mesh-sharded solve (ffd_solve_sharded): the padded run axis Sp is always a
# multiple of this (backend.host_kernel_args buckets S with mult=floor=16), so
# any power-of-2 mesh up to 16 slots divides it into equal contiguous blocks.
# Equal to the JAX package's (tests/test_torch_isolation.py).
SHARD_BLOCK_MULT = 16

DELTA_HEADER_WORDS = 3  # [overflow_flag, entry_count, uniq_meta_count] i32
DELTA_ENTRY_U16 = 2  # (code, count) uint16 per entry word; code = e | E+m

# Launch counts, one per wrapper call that launches its kernel(s). A run
# that resets them and reads them after proves the path went through the
# kernels. The scan counts its instances apart: ffd_fast_scan is
# ffd_cluster_kernel<false, false, false> (zone_engine=False), ffd_zoned_scan
# is ffd_cluster_kernel<true, false, false>; the batched consolidation scan
# (consolidate.batched_ffd) is ffd_batched_kernel<false, *>
# (ffd_batched_fast_scan) and <true, *> (ffd_batched_zoned_scan), on either
# team; pack_verdicts is
# consolidate.pack_verdicts; the relax-ladder scan (ffd_solve_ladder) is
# ffd_ladder_kernel<false, false> (ffd_ladder_fast_scan) and <true, false>
# (ffd_ladder_zoned_scan); the checkpointed scan (ffd_solve_ckpt and
# ffd_resume) is ffd_cluster_kernel<false, true, false> (ffd_ckpt_fast_scan)
# and <true, true, false> (ffd_ckpt_zoned_scan). The last flag, SPARSE, is
# true in the sparse instances of K1 (ffd_sparse_fast_scan /
# ffd_sparse_zoned_scan), K6 (ffd_ladder_sparse_*) and K7
# (ffd_ckpt_sparse_*, also ffd_resume_sparse); pack_outputs is the dense output pack; gang_commit,
# preemption_plan, preemption_walk and explain_pack are the class and explain
# kernels (K10-K12 and the walk, csrc/class_kernels.cu). The lane-batched scan (ffd_solve_lanes, K15) is
# ffd_lanes_kernel<false> (ffd_lanes_fast_scan) and <true>
# (ffd_lanes_zoned_scan); apply_events is the streaming run-table scatter
# (ffd_apply_events, K14, csrc/arena_kernels.cu). The lanes of a mesh-sharded
# solve count apart from K15's: ffd_sharded_fast_scan / ffd_sharded_zoned_scan
# (K17, ffd_lanes_kernel<false> / <true>) and ffd_sharded_sparse_fast_scan /
# ffd_sharded_sparse_zoned_scan (K17s, ffd_lanes_sparse_kernel<false> /
# <true>), one per launch (one per physical device of the mesh); sharded_ffd
# counts the K4 launches of the candidate-sharded consolidation
# (consolidate._sharded_ffd, K18), one per physical device of its mesh.
# pack_delta is the delta pack (K2 + K3, pack_delta_kernel: the claim-delta
# fetch buffer, one launch a delta-fetch solve); mask_words is its word
# stage alone, for the wide re-fetch.
LAUNCHES = {
    "ffd_fast_scan": 0, "ffd_zoned_scan": 0, "pack_delta": 0, "mask_words": 0,
    "ffd_lanes_fast_scan": 0, "ffd_lanes_zoned_scan": 0, "apply_events": 0,
    "ffd_batched_fast_scan": 0, "ffd_batched_zoned_scan": 0, "pack_verdicts": 0,
    "ffd_ladder_fast_scan": 0, "ffd_ladder_zoned_scan": 0,
    "ffd_ckpt_fast_scan": 0, "ffd_ckpt_zoned_scan": 0,
    "ffd_sparse_fast_scan": 0, "ffd_sparse_zoned_scan": 0,
    "ffd_ladder_sparse_fast_scan": 0, "ffd_ladder_sparse_zoned_scan": 0,
    "ffd_ckpt_sparse_fast_scan": 0, "ffd_ckpt_sparse_zoned_scan": 0,
    "pack_outputs": 0, "gang_commit": 0, "preemption_plan": 0, "preemption_walk": 0,
    "explain_pack": 0,
    "ffd_sharded_fast_scan": 0, "ffd_sharded_zoned_scan": 0,
    "ffd_sharded_sparse_fast_scan": 0, "ffd_sharded_sparse_zoned_scan": 0,
    "sharded_ffd": 0,
}

I32 = torch.int32


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def _u32_scalar(v: int) -> int:
    """A uint32 value as the Python int of its int32 bit pattern."""
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _state0(args, M: int) -> FFDState:
    """The scan's initial carry (cold solve); for lane-batched arguments
    ([B, ...] each, ffd_solve_lanes) every field gains the same leading
    [B] axis, each lane seeded from its own arguments."""
    a = dict(zip(ARG_SPEC, args))
    lead = tuple(a["node_free"].shape[:-2])
    E, R = a["node_free"].shape[-2:]
    T = a["group_compat_t"].shape[-1]
    W = a["group_pair_nok"].shape[-1]
    Q = a["q_kind"].shape[-1]
    V = a["v_kind"].shape[-1]
    Z = a["zone_col_mask"].shape[-1]
    dev = a["node_free"].device
    z = lambda *s: torch.zeros(lead + s, dtype=I32, device=dev)  # noqa: E731
    return FFDState(
        e_cum=z(E, R),
        c_cum=z(M, R),
        c_mask=torch.zeros(lead + (M, T), dtype=torch.bool, device=dev),
        c_zc_bits=z(M),
        c_gbits=z(M, W),
        c_pool=torch.full(lead + (M,), -1, dtype=I32, device=dev),
        used=z(),
        p_usage=a["pool_usage0"].to(I32).clone(),
        e_cm=a["node_q_member"].to(I32).clone(),
        e_co=a["node_q_owner"].to(I32).clone(),
        c_cm=z(M, Q),
        c_co=z(M, Q),
        v_count=a["v_count0"].to(I32).clone(),
        v_owner_z=torch.zeros(lead + (V, Z), dtype=torch.bool, device=dev),
        c_vm=z(M, V),
        c_vo=torch.zeros(lead + (M, V), dtype=torch.bool, device=dev),
    )


def _state_spec(args, M: int) -> dict:
    """{field: (shape, dtype)} of the scan's carry for these arguments."""
    a = dict(zip(ARG_SPEC, args))
    E, R = a["node_free"].shape
    T = a["group_compat_t"].shape[1]
    W = a["group_pair_nok"].shape[1]
    P = a["pool_type"].shape[0]
    Q = a["q_kind"].shape[0]
    V = a["v_kind"].shape[0]
    Z = a["zone_col_mask"].shape[0]
    B = torch.bool
    return {
        "e_cum": ((E, R), I32), "c_cum": ((M, R), I32), "c_mask": ((M, T), B),
        "c_zc_bits": ((M,), I32), "c_gbits": ((M, W), I32), "c_pool": ((M,), I32),
        "used": ((), I32), "p_usage": ((P, R), I32), "e_cm": ((E, Q), I32),
        "e_co": ((E, Q), I32), "c_cm": ((M, Q), I32), "c_co": ((M, Q), I32),
        "v_count": ((V, Z), I32), "v_owner_z": ((V, Z), B), "c_vm": ((M, V), I32),
        "c_vo": ((M, V), B),
    }


def _resume_state(init_state, args, M: int) -> FFDState:
    """Fresh copies of a checkpoint's fields, checked against the carry
    these arguments give. The scan writes its carry in place, so a resume
    never runs on the checkpoint's own tensors: the donor's record stays
    intact for the next resume."""
    spec = _state_spec(args, M)
    dev = args[0].device
    out = {}
    for name, t in init_state._asdict().items():
        shape, dtype = spec[name]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(
                f"init_state.{name}: expected {shape} {dtype} on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
        out[name] = t.clone(memory_format=torch.contiguous_format)
    return FFDState(**out)


def _ring0(state: FFDState, n_ckpt: int) -> CheckpointRing:
    """A zeroed ring for `state`'s fields (as the JAX ring0) and prefix -1.
    The fields are views of one zeroed byte buffer, each at a 16-byte
    aligned offset: one fill for the whole ring."""
    dev = state.e_cum.device
    offs, total = [], 0
    for t in state:
        offs.append(total)
        total += -(-(n_ckpt * t.numel() * t.element_size()) // 16) * 16
    buf = torch.zeros((max(total, 16),), dtype=torch.uint8, device=dev)
    fields = []
    for t, off in zip(state, offs):
        nb = n_ckpt * t.numel() * t.element_size()
        fields.append(buf[off : off + nb].view(t.dtype).view((n_ckpt,) + tuple(t.shape)))
    prefix = torch.full((n_ckpt,), -1, dtype=I32, device=dev)
    return CheckpointRing(states=FFDState(*fields), prefix=prefix)


# --- plain PyTorch version of the fast-branch scan -------------------------


def _fit_count(alloc, cum, req):
    """[N] per-node count of additional `req` pods fitting: min over R of
    floor((alloc - cum) / req); req==0 axes don't constrain. Clamped >= 0."""
    safe_req = torch.clamp(req, min=1)
    k = torch.where(req[None, :] > 0, _floordiv(alloc - cum, safe_req[None, :]), BIG)
    return torch.clamp(k.min(dim=1).values, min=0).to(I32)


def _fit_count_nt(alloc_t, cum_n, req):
    """[N, T]: pods fitting per (node, type). alloc_t [T,R], cum_n [N,R]."""
    N, R = cum_n.shape
    T = alloc_t.shape[0]
    k = torch.full((N, T), BIG, dtype=I32, device=cum_n.device)
    safe_req = torch.clamp(req, min=1)
    for r in range(R):
        kr = torch.where(
            req[r] > 0,
            _floordiv(alloc_t[None, :, r] - cum_n[:, r][:, None], safe_req[r]),
            BIG,
        )
        k = torch.minimum(k, kr.to(I32))
    return torch.clamp(k, min=0)


def _pour(cap, remaining):
    """First-fit pour of `remaining` identical pods into nodes with per-node
    capacity `cap` (in index order). Returns (take [N], left scalar)."""
    prefix = torch.cumsum(cap, 0).to(I32) - cap  # exclusive prefix, int32 wrap
    take = torch.minimum(torch.clamp(remaining - prefix, min=0), cap).to(I32)
    return take, (remaining - take.sum().to(I32)).to(I32)


def _hostname_allowance(cm, co, q_kind, q_cap, member_g, owner_g):
    """[N] per-node additional-pod allowance for group g under the hostname
    constraint sigs (Q axis): see the JAX module for the per-kind rules."""
    kind0 = q_kind[None, :] == 0
    kind2 = q_kind[None, :] == 2
    relevant = owner_g[None, :] | ((q_kind[None, :] == 1) & member_g[None, :])
    tsc_allow = torch.where(
        member_g[None, :],
        q_cap[None, :] - cm,
        torch.where(cm + 1 <= q_cap[None, :], BIG, 0).to(I32),
    )
    anti_owner_allow = torch.where(
        cm == 0, torch.where(member_g[None, :], 1, BIG), 0
    ).to(I32)
    anti_member_allow = torch.where(co == 0, BIG, 0).to(I32)
    pos_allow = torch.where(cm > 0, BIG, 0).to(I32)
    per_q = torch.where(
        kind0,
        tsc_allow,
        torch.where(
            kind2,
            pos_allow,
            torch.where(owner_g[None, :], anti_owner_allow, anti_member_allow),
        ),
    )
    per_q = torch.where(relevant, per_q, BIG).to(I32)
    return torch.clamp(per_q.min(dim=1).values, min=0).to(I32)


def _gbit_word(g: int, W: int, device) -> torch.Tensor:
    """[W] one-hot uint32 word (as int32 bits) for group index g."""
    out = torch.zeros((W,), dtype=I32, device=device)
    if (g >> 5) < W:
        out[g >> 5] = _u32_scalar(1 << (g & 31))
    return out


def _pos_cap(cm, owned2):
    """Kind-2 (positive hostname affinity) allowance: BIG where matching
    pods are present on the row, 0 elsewhere; BIG without owned kind-2."""
    v = torch.where(owned2[None, :], torch.where(cm > 0, BIG, 0), BIG).to(I32)
    return v.min(dim=1).values


def _zone_sets(bits, zcm):
    """[...] joint-bit words -> [..., Z] bool domain marginals."""
    return (bits[..., None] & zcm) != 0


def _argmax_first(x) -> int:
    """Index of the first maximum (jnp.argmax's tie rule), bools as 0/1."""
    return int(torch.argmax(x.to(I32)))


def _or_bits(words, dim):
    """OR-reduce int32 bit words along `dim` (the JAX code sums disjoint
    bit columns as uint32, which is the same OR)."""
    return _i32_bits((words.to(torch.int64) & 0xFFFFFFFF).sum(dim=dim))


def _ceil_div(a, b):
    """-(-a // b), the JAX code's ceiling division."""
    return -_floordiv(-a, b)


class _Run:
    """Per-run rows and flags shared by the fast and zoned branches.

    The dense flags (m_g, o_g, m_v, o_v: the group's full Q and V rows) are
    what the zoned branch reads. The fast branch, the fresh-claim allowance
    and the `constrained` test read the run's VIEW of the constraint axes:
    the dense rows themselves, or with the run's index rows (`q_row` [Kq],
    `v_row` [Kv], -1 padded; ffd.py:540-565) the gathered columns, whose
    member/owner flags are False on padding. A column the group neither
    belongs to nor owns contributes the neutral element everywhere, so a
    superset list decides as the dense rows do."""

    def __init__(self, a, g: int, count: int, W: int, q_row=None, v_row=None):
        dev = a["node_free"].device
        self.g = g
        self.req = a["group_req"][g]
        self.compat_t = a["group_compat_t"][g]
        self.g_zc = a["group_zc_bits"][g]
        self.gpool = a["group_pool"][g]
        self.g_nok = a["group_pair_nok"][g]
        self.m_g = a["q_member"][g]
        self.o_g = a["q_owner"][g]
        self.m_v = a["v_member"][g]
        self.o_v = a["v_owner"][g]
        self.gword = _gbit_word(g, W, dev)
        self.remaining0 = count if bool(a["group_device"][g]) else 0
        self.sparse = q_row is not None
        if self.sparse:
            self.qcol, self.qvalid = _valid_cols(q_row)
            self.vcol, self.vvalid = _valid_cols(v_row)
            self.mg_k, self.og_k = _gather(self.m_g, q_row), _gather(self.o_g, q_row)
            self.kq_k, self.cq_k = _gather(a["q_kind"], q_row), _gather(a["q_cap"], q_row)
            self.mv_k, self.ov_k = _gather(self.m_v, v_row), _gather(self.o_v, v_row)
            self.vk_k = _gather(a["v_kind"], v_row)
        else:
            self.mg_k, self.og_k, self.kq_k, self.cq_k = self.m_g, self.o_g, a["q_kind"], a["q_cap"]
            self.mv_k, self.ov_k, self.vk_k = self.m_v, self.o_v, a["v_kind"]
        kq = self.kq_k
        z = torch.zeros((1, kq.shape[0]), dtype=I32, device=dev)
        self.fresh_allow = _hostname_allowance(
            z, z, kq, self.cq_k, self.mg_k, self.og_k & (kq != 2)
        )[0]

    def constrained(self) -> bool:
        """The group owns a V-axis sig or is a member of an anti sig
        (ffd.py:1662), read through the run's view."""
        return bool(torch.any(self.ov_k) | torch.any(self.mv_k & (self.vk_k == 1)))

    def q_cols(self, x):
        """[X, Q] counters -> the run's view [X, Kq] (zeros on padding)."""
        return _gather_cols(x, self.qcol, self.qvalid) if self.sparse else x

    def q_add(self, x, vals):
        """Add view-width deltas back into [X, Q] state (padding dropped)."""
        return _scatter_add_cols(x, self.qcol, self.qvalid, vals) if self.sparse else x + vals

    def q_open(self, x, vals, is_new):
        """Claim-open rows: the dense form replaces the (zero) row, the
        sparse form adds onto it, identical on zeros (ffd.py:553-560)."""
        if self.sparse:
            return _scatter_add_cols(x, self.qcol, self.qvalid,
                                     torch.where(is_new[:, None], vals, 0).to(I32))
        return torch.where(is_new[:, None], vals, x)

    def v_add(self, x, vals):
        return _scatter_add_cols(x, self.vcol, self.vvalid, vals) if self.sparse else x + vals

    def v_open(self, x, vals, is_new):
        if self.sparse:
            return _scatter_add_cols(x, self.vcol, self.vvalid,
                                     torch.where(is_new[:, None], vals, 0).to(I32))
        return torch.where(is_new[:, None], vals, x)

    def v_count_add(self, v_count, contrib):
        """v_count [V, Z] += member x contrib over the view's V rows
        (ffd.py:838-846)."""
        delta = self.mv_k.to(I32)[:, None] * contrib[None, :]
        if self.sparse:
            if not self.vcol.numel():
                return v_count
            return v_count.index_add(0, self.vcol, delta[self.vvalid])
        return v_count + delta


def _valid_cols(row):
    """An index row [K] (-1 padded anywhere) -> (the valid columns as int64,
    the valid mask)."""
    valid = row >= 0
    return row[valid].long(), valid


def _gather(flags, row):
    """flags[row] with padding (-1) read as 0 / False; a zero-width axis
    (Q = 0 or V = 0) is never indexed."""
    out = torch.zeros(row.shape, dtype=flags.dtype, device=flags.device)
    valid = row >= 0
    if bool(valid.any()):
        out[valid] = flags[row[valid].long()]
    return out


def _gather_cols(x, cols, valid):
    """x [X, N] -> [X, K]: column cols[j] at each valid slot, 0 elsewhere."""
    out = torch.zeros((x.shape[0], valid.shape[0]), dtype=x.dtype, device=x.device)
    if cols.numel():
        out[:, valid] = x[:, cols]
    return out


def _scatter_add_cols(x, cols, valid, vals):
    """x [X, N] with vals [X, K] added at column cols[j] of each valid slot
    (the JAX scatter-add with mode="drop": padding slots drop)."""
    if not cols.numel():
        return x
    return x.index_add(1, cols, vals[:, valid].to(x.dtype))


def _count_contrib(a, take_e, take_c, c_zc_after):
    """[Z] recorded-pod count deltas: node domains on every axis, plus claims
    whose domain is single-valued per axis (ffd.py count_contrib)."""
    zcm, col_axis = a["zone_col_mask"], a["col_axis"]
    Z = zcm.shape[0]
    zidx = torch.arange(Z, dtype=I32, device=zcm.device)
    e_zone_1h = (a["node_zone"][:, None] == zidx[None, :]) | (
        a["node_dom2"][:, None] == zidx[None, :]
    )
    contrib = (take_e[:, None] * e_zone_1h).sum(dim=0)
    cz = _zone_sets(c_zc_after, zcm)
    rec = torch.zeros_like(cz)
    for ax in range(2):
        axm = col_axis == ax
        single = (cz & axm[None, :]).sum(dim=1) == 1
        rec = rec | (cz & axm[None, :] & single[:, None])
    contrib = contrib + (take_c[:, None] * rec).sum(dim=0)
    return contrib.to(I32)


def _fast_plain(a, st, r: _Run, M: int):
    """One run of the fast branch (ffd.py:605-855), its Q/V-axis state read
    and written through the run's view (dense rows, or the gathered
    columns of the sparse form)."""
    dev = a["node_free"].device
    E = a["node_free"].shape[0]
    P = a["pool_type"].shape[0]
    midx = torch.arange(M, dtype=I32, device=dev)
    eidx = torch.arange(E, dtype=I32, device=dev)
    type_alloc, type_charge = a["type_alloc"], a["type_charge"]
    offer_zc = a["offer_zc_bits"]
    kq, cq = r.kq_k, r.cq_k
    g, req, compat_t, g_zc, m_g, o_g = r.g, r.req, r.compat_t, r.g_zc, r.mg_k, r.og_k
    remaining = torch.tensor(r.remaining0, dtype=I32, device=dev)
    m_g_i = m_g.to(I32)
    m_v_i = r.mv_k.to(I32)
    owner_nb = o_g & (kq != 2)
    anti_o = o_g & (kq == 1)
    owned2 = o_g & (kq == 2)
    tot_m_q = (r.q_cols(st["e_cm"]).sum(0) + r.q_cols(st["c_cm"]).sum(0)).to(I32)
    boot_ok = torch.all(~owned2 | (m_g & (tot_m_q == 0)))
    boot2 = torch.any(owned2) & boot_ok

    # ---- 1. existing nodes ------------------------------------------------
    e_base = _fit_count(a["node_free"], st["e_cum"], req)
    e_base = torch.where(a["node_compat"][g], e_base, 0).to(I32)
    e_cm_k = r.q_cols(st["e_cm"])
    e_allow_nb = _hostname_allowance(e_cm_k, r.q_cols(st["e_co"]), kq, cq, m_g, owner_nb)
    e_pos = _pos_cap(e_cm_k, owned2)
    e_cap_full = torch.minimum(e_base, torch.minimum(e_allow_nb, e_pos))
    e_cap_boot = torch.minimum(e_base, e_allow_nb)
    has_e_boot = torch.any(e_cap_boot > 0)
    e_first = torch.argmax((e_cap_boot > 0).to(I32))
    e_cap = torch.where(
        boot2, torch.where(eidx == e_first, e_cap_boot, 0).to(I32), e_cap_full
    )
    take_e, remaining = _pour(e_cap, remaining)
    st["e_cum"] = st["e_cum"] + take_e[:, None] * req[None, :]
    st["e_cm"] = r.q_add(st["e_cm"], take_e[:, None] * m_g_i[None, :])
    st["e_co"] = r.q_add(st["e_co"], ((take_e[:, None] > 0) & anti_o[None, :]).to(I32))

    # ---- 2. open claims ---------------------------------------------------
    A_bits = offer_zc & g_zc  # [T]
    ok_off = (st["c_zc_bits"][:, None] & A_bits[None, :]) != 0  # [M, T]
    pair_ok = ~torch.any((st["c_gbits"] & r.g_nok[None, :]) != 0, dim=1)
    is_open = st["c_pool"] >= 0
    pool_ok = torch.where(
        is_open, r.gpool[torch.clamp(st["c_pool"], 0, P - 1).long()], False
    )
    k_nt = _fit_count_nt(type_alloc, st["c_cum"], req)
    fit_nt = st["c_mask"] & compat_t[None, :] & ok_off
    node_ok = is_open & pair_ok & pool_ok
    k_nt = torch.where(fit_nt & node_ok[:, None], k_nt, 0).to(I32)
    c_base = k_nt.max(dim=1).values
    c_cm_k = r.q_cols(st["c_cm"])
    c_allow_nb = _hostname_allowance(c_cm_k, r.q_cols(st["c_co"]), kq, cq, m_g, owner_nb)
    c_pos = _pos_cap(c_cm_k, owned2)
    c_cap_full = torch.minimum(c_base, torch.minimum(c_allow_nb, c_pos))
    c_cap_boot = torch.minimum(c_base, c_allow_nb)
    has_c_boot = torch.any(c_cap_boot > 0)
    c_first = torch.argmax((c_cap_boot > 0).to(I32))
    c_cap = torch.where(
        boot2,
        torch.where(
            has_e_boot, 0, torch.where(midx == c_first, c_cap_boot, 0)
        ).to(I32),
        c_cap_full,
    )
    take_c, remaining = _pour(c_cap, remaining)

    added = take_c > 0
    st["c_cum"] = st["c_cum"] + take_c[:, None] * req[None, :]
    st["c_mask"] = torch.where(
        added[:, None], fit_nt & (k_nt >= take_c[:, None]), st["c_mask"]
    )
    st["c_zc_bits"] = torch.where(added, st["c_zc_bits"] & g_zc, st["c_zc_bits"])
    st["c_gbits"] = st["c_gbits"] | torch.where(added[:, None], r.gword[None, :], 0)
    st["c_cm"] = r.q_add(st["c_cm"], take_c[:, None] * m_g_i[None, :])
    st["c_co"] = r.q_add(st["c_co"], (added[:, None] & anti_o[None, :]).to(I32))
    st["c_vm"] = r.v_add(st["c_vm"], take_c[:, None] * m_v_i[None, :])

    # ---- 3. new claims, pool by pool in priority order ---------------------
    used = st["used"]
    take_new = torch.zeros((M,), dtype=I32, device=dev)
    cap2 = torch.where(
        torch.any(owned2),
        torch.where(boot2 & ~has_e_boot & ~has_c_boot, 1, 0),
        BIG,
    ).to(I32)
    safe_req = torch.clamp(req, min=1)
    for p in range(P):
        new_bits = a["pool_zc_bits"][p] & g_zc
        off_ok = (offer_zc & new_bits) != 0
        fit_t = compat_t & a["pool_type"][p] & off_ok
        daemon = a["pool_daemon"][p]
        k_t = torch.where(
            req[None, :] > 0,
            _floordiv(type_alloc - daemon[None, :], safe_req[None, :]),
            BIG,
        )
        k_t = torch.clamp(k_t.min(dim=1).values, min=0).to(I32)
        k_t = torch.where(fit_t, k_t, 0).to(I32)
        kmax = k_t.max()
        full_take = torch.minimum(kmax, r.fresh_allow)

        one_set = fit_t & (k_t >= 1)
        charge_one = torch.where(one_set[:, None], type_charge, INT32_MAX).min(dim=0).values
        charge_one = torch.where(charge_one == INT32_MAX, 0, charge_one).to(I32)
        headroom = a["pool_limit"][p] - st["p_usage"][p]
        trips = torch.where(
            charge_one > 0,
            torch.clamp(_ceil_div(headroom, torch.clamp(charge_one, min=1)), min=0),
            BIG,
        ).to(I32)
        already_over = torch.any(st["p_usage"][p] >= a["pool_limit"][p])
        allow = torch.where(already_over, 0, trips.min()).to(I32)

        n_want = torch.where(
            full_take > 0, _ceil_div(remaining, torch.clamp(full_take, min=1)), 0
        ).to(I32)
        slots_left = M - used
        n_new = torch.minimum(torch.minimum(n_want, allow), slots_left).to(I32)
        n_new = torch.minimum(n_new, cap2)
        eligible = r.gpool[p] & (full_take > 0)
        n_new = torch.where(eligible, n_new, 0).to(I32)

        # the JAX scan gates this on n_new > 0; with n_new == 0 every
        # update below is the identity, so it runs unconditionally
        is_new = (midx >= used) & (midx < used + n_new)
        j = midx - used
        take_j = torch.where(
            is_new,
            torch.minimum(torch.clamp(remaining - j * full_take, min=0), full_take),
            0,
        ).to(I32)
        st["c_cum"] = torch.where(
            is_new[:, None], daemon[None, :] + take_j[:, None] * req[None, :], st["c_cum"]
        )
        new_mask = fit_t[None, :] & (k_t[None, :] >= take_j[:, None])
        st["c_mask"] = torch.where(is_new[:, None], new_mask, st["c_mask"])
        st["c_zc_bits"] = torch.where(is_new, new_bits, st["c_zc_bits"])
        st["c_gbits"] = torch.where(is_new[:, None], r.gword[None, :], st["c_gbits"])
        st["c_pool"] = torch.where(is_new, p, st["c_pool"]).to(I32)
        st["c_cm"] = r.q_open(st["c_cm"], take_j[:, None] * m_g_i[None, :], is_new)
        st["c_co"] = r.q_open(
            st["c_co"], ((take_j[:, None] > 0) & anti_o[None, :]).to(I32), is_new
        )
        st["c_vm"] = r.v_open(st["c_vm"], take_j[:, None] * m_v_i[None, :], is_new)
        p_usage = st["p_usage"].clone()
        p_usage[p] = p_usage[p] + charge_one * n_new
        st["p_usage"] = p_usage
        take_new = take_new + take_j
        remaining = (remaining - take_j.sum().to(I32)).to(I32)
        used = (used + n_new).to(I32)
        cap2 = (cap2 - n_new).to(I32)
    st["used"] = used
    take_c_total = take_c + take_new
    # zone-sig membership counts (the group may match other pods' selectors
    # without owning a constraint)
    contrib = _count_contrib(a, take_e, take_c_total, st["c_zc_bits"])
    st["v_count"] = r.v_count_add(st["v_count"], contrib)
    return take_e, take_c_total, remaining


def _zoned_plain(a, st, r: _Run, M: int):
    """One constrained run through the domain event engine (ffd.py:860-1651):
    events until the run is placed, an event places nothing, or the fuel
    (remaining + 8) runs out. Returns (take_e, take_c, leftover, events)."""
    dev = a["node_free"].device
    E, R = a["node_free"].shape
    P = a["pool_type"].shape[0]
    zcm = a["zone_col_mask"]
    Z = zcm.shape[0]
    V = a["v_kind"].shape[0]
    zidx = torch.arange(Z, dtype=I32, device=dev)
    eidx = torch.arange(E, dtype=I32, device=dev)
    midx = torch.arange(M, dtype=I32, device=dev)
    type_alloc, type_charge = a["type_alloc"], a["type_charge"]
    offer_zc = a["offer_zc_bits"]
    q_kind, q_cap, v_kind = a["q_kind"], a["q_cap"], a["v_kind"]
    pool_type, pool_daemon, pool_limit = a["pool_type"], a["pool_daemon"], a["pool_limit"]
    g, req, compat_t, g_zc = r.g, r.req, r.compat_t, r.g_zc
    member_g, owner_g, member_v, owner_v = r.m_g, r.o_g, r.m_v, r.o_v
    fresh_allow = r.fresh_allow
    mg_i, mv_i = member_g.to(I32), member_v.to(I32)
    anti_q = owner_g & (q_kind == 1)

    g_ax = int(a["group_daxis"][g])
    gax_cols = a["col_axis"] == g_ax
    nd = a["node_zone"] if g_ax == 0 else a["node_dom2"]
    gz_zones = _zone_sets(g_zc, zcm) & gax_cols
    psig_g = int(a["v_primary"][g])
    has_tsc = psig_g >= 0
    psig = min(max(psig_g, 0), V - 1)
    cap_p = a["v_cap"][psig]
    is_self = bool(member_v[psig])
    asig_g = int(a["v_aff"][g])
    has_affs = asig_g >= 0
    asig = min(max(asig_g, 0), V - 1)
    owned_anti = owner_v & (v_kind == 1)
    owned_blk = owner_v & ((v_kind == 1) | (v_kind == 3))
    member_anti = member_v & (v_kind == 1)
    self_anti = bool(torch.any(owned_blk & member_v))
    is_member_a = bool(member_v[asig])
    has_owned = bool(torch.any(owner_v))
    has_anti = bool(torch.any(owned_blk))
    any_member_anti = bool(torch.any(member_anti))
    e_zone_1h = (a["node_zone"][:, None] == zidx[None, :]) | (
        a["node_dom2"][:, None] == zidx[None, :]
    )
    pure_tsc = has_tsc and not self_anti and not has_affs and not any_member_anti and not has_anti
    multi_ok = not has_tsc and not self_anti
    big_z = torch.full((Z,), BIG, dtype=I32, device=dev)
    safe_req = torch.clamp(req, min=1)

    def fit_pool_t(daemon):
        """[..., T] pods fitting a fresh claim per type over pool daemons."""
        k = torch.full(daemon.shape[:-1] + (type_alloc.shape[0],), BIG, dtype=I32, device=dev)
        for rr in range(R):
            kr = torch.where(
                req[rr] > 0,
                _floordiv(type_alloc[:, rr] - daemon[..., rr, None], safe_req[rr]),
                BIG,
            )
            k = torch.minimum(k, kr.to(I32))
        return torch.clamp(k, min=0)

    def trips_of(headroom, charge):
        return torch.where(
            charge > 0, torch.clamp(_ceil_div(headroom, torch.clamp(charge, min=1)), min=0), BIG
        ).min().to(I32)

    remaining = r.remaining0
    fuel = remaining + 8
    progress = True
    events = 0
    take_e_acc = torch.zeros((E,), dtype=I32, device=dev)
    take_c_acc = torch.zeros((M,), dtype=I32, device=dev)
    while remaining > 0 and progress and fuel > 0:
        used = int(st["used"])
        v_count, v_owner_z = st["v_count"], st["v_owner_z"]
        c_vm, c_vo = st["c_vm"], st["c_vo"]
        c_zc_bits, c_pool = st["c_zc_bits"], st["c_pool"]

        # ---- allowed domains A and per-domain budgets B -------------------
        elig = gz_zones
        cnt_p = v_count[psig]
        cm_ = torch.where(elig, cnt_p, BIG).to(I32)
        m1 = cm_.min()
        amin = int(torch.argmin(cm_))
        nmin = int((cm_ == m1).sum())
        second = torch.where(zidx == amin, BIG, cm_).min()
        m2 = torch.where((nmin == 1) & (zidx == amin), second, m1)
        if has_tsc:
            A = elig & (cnt_p + 1 - m1 <= cap_p)
            B = torch.clamp(m2 + cap_p - cnt_p, 0, BIG).to(I32)
        else:
            A = elig.clone()
            B = big_z.clone()
        blocked_m = torch.any(owned_blk[:, None] & (v_count > 0), dim=0)
        blocked_o = torch.any(member_anti[:, None] & v_owner_z, dim=0)
        A = A & ~blocked_m & ~blocked_o
        if self_anti:
            B = torch.clamp(B, max=1)
        cnt_a = v_count[asig]
        present = cnt_a > 0
        any_present = bool(torch.any(present))
        A_base = A
        if has_affs:
            if any_present:
                A = A & present
            elif not is_member_a:
                A = torch.zeros_like(A)
        if has_affs and not any_present:
            B = torch.clamp(B, max=1)

        # ---- existing-node candidate ----------------------------------------
        e_fit = _fit_count(a["node_free"], st["e_cum"], req)
        e_host = _hostname_allowance(st["e_cm"], st["e_co"], q_kind, q_cap, member_g, owner_g)
        nz_ok = torch.where(nd >= 0, A[torch.clamp(nd, 0, Z - 1).long()], not has_owned)
        elig_e_base = a["node_compat"][g] & (e_fit > 0) & (e_host > 0)
        elig_e = elig_e_base & nz_ok
        found_e = bool(torch.any(elig_e))
        e_star = _argmax_first(elig_e)
        z_e = int(nd[e_star])

        # ---- open-claim candidates --------------------------------------------
        local_aff = has_affs & (c_vm[:, asig] > 0)  # [M]
        anti_claim_ok = torch.all(~owned_blk[None, :] | (c_vm == 0), dim=1) & torch.all(
            ~member_anti[None, :] | ~c_vo, dim=1
        )
        cz = _zone_sets(c_zc_bits, zcm)  # [M, Z]
        zcount_m = (cz & gax_cols[None, :]).sum(dim=1)
        A_m = torch.where(local_aff[:, None], A_base[None, :], A[None, :])
        inter = cz & A_m
        has_inter = torch.any(inter, dim=1)
        aff_mode = has_affs & any_present & ~local_aff  # [M]
        commit_m = has_tsc | aff_mode | has_anti
        score_tsc = torch.where(inter, cnt_p[None, :] * 64 + zidx[None, :], BIG)
        score_aff = torch.where(inter, -cnt_a[None, :] * 64 + zidx[None, :], BIG)
        score_lex = torch.where(inter, zidx[None, :], BIG)
        if has_tsc:
            d_m = torch.argmin(score_tsc, dim=1)
        else:
            d_m = torch.where(
                aff_mode, torch.argmin(score_aff, dim=1), torch.argmin(score_lex, dim=1)
            )
        azmask = _or_bits(torch.where(inter, zcm[None, :], 0), 1)
        bits_eff = torch.where(commit_m, zcm[d_m], azmask) & c_zc_bits & g_zc  # [M]

        ok_off = (bits_eff[:, None] & offer_zc[None, :]) != 0
        pair_ok = ~torch.any((st["c_gbits"] & r.g_nok[None, :]) != 0, dim=1)
        is_open = c_pool >= 0
        pool_ok = torch.where(is_open, r.gpool[torch.clamp(c_pool, 0, P - 1).long()], False)
        k_raw = _fit_count_nt(type_alloc, st["c_cum"], req)  # [M, T]
        fit_nt = st["c_mask"] & compat_t[None, :] & ok_off
        node_ok = is_open & pair_ok & pool_ok & has_inter & (bits_eff != 0) & anti_claim_ok
        k_nt = torch.where(fit_nt & node_ok[:, None], k_raw, 0).to(I32)
        k_m = k_nt.max(dim=1).values
        c_host = _hostname_allowance(st["c_cm"], st["c_co"], q_kind, q_cap, member_g, owner_g)
        elig_m = (k_m > 0) & (c_host > 0)
        found_c = bool(torch.any(elig_m))
        m_star = _argmax_first(elig_m)
        fin_z = _zone_sets(bits_eff[m_star], zcm) & gax_cols
        nz_fin = int(fin_z.sum())
        z_c = _argmax_first(fin_z)

        # ---- first-fit preemption bound -----------------------------------------
        pos_node = torch.where(
            elig_e_base[:, None] & e_zone_1h, eidx[:, None], BIG
        ).min(dim=0).values  # [Z]
        bits_z = c_zc_bits[:, None] & zcm[None, :] & g_zc  # [M, Z]
        off_zt = (bits_z[:, :, None] & offer_zc[None, None, :]) != 0  # [M, Z, T]
        fit_base = st["c_mask"] & compat_t[None, :] & (k_raw >= 1)  # [M, T]
        elig_m_z = torch.any(off_zt & fit_base[:, None, :], dim=2) & (
            is_open & pair_ok & pool_ok & (c_host > 0) & anti_claim_ok
        )[:, None]
        pos_claim = torch.where(elig_m_z, E + midx[:, None], BIG).min(dim=0).values
        pos_z = torch.minimum(pos_node, pos_claim)
        pb_cand = (
            elig & ~A & ~blocked_m & ~blocked_o & ((cnt_p + 1 - cap_p) <= second)
        )

        def preempt_bound(zt: int, pos_t: int):
            """Max consecutive pods into domain zt before a blocked domain
            with an earlier target re-enters the allowed set."""
            if not (has_tsc and nmin == 1 and zt == amin):
                return BIG
            cand = pb_cand & (pos_z < pos_t)
            j = cnt_p + 1 - cap_p - cnt_p[min(max(zt, 0), Z - 1)]
            val = int(torch.where(cand, j, BIG).min())
            return max(val, 0)

        Bz_e = min(int(B[min(max(z_e, 0), Z - 1)]), preempt_bound(z_e, e_star)) if z_e >= 0 else BIG
        q_e = min(remaining, int(e_fit[e_star]), int(e_host[e_star]), Bz_e)
        Bz_c = min(int(B[z_c]), preempt_bound(z_c, E + m_star)) if nz_fin == 1 else BIG
        q_c = min(remaining, int(k_m[m_star]), int(c_host[m_star]), Bz_c)
        if self_anti:
            q_c = min(q_c, 1)

        # ---- new-claim candidates (per pool) --------------------------------------
        pz_bits = a["pool_zc_bits"] & g_zc  # [P]
        pzz = _zone_sets(pz_bits, zcm)  # [P, Z]
        inter_p = pzz & A[None, :]
        has_inter_p = torch.any(inter_p, dim=1)
        if has_tsc:
            d_p = torch.argmin(torch.where(inter_p, cnt_p[None, :] * 64 + zidx[None, :], BIG), dim=1)
        elif has_affs and any_present:
            d_p = torch.argmin(torch.where(inter_p, -cnt_a[None, :] * 64 + zidx[None, :], BIG), dim=1)
        else:
            d_p = torch.argmin(torch.where(inter_p, zidx[None, :], BIG), dim=1)
        commit_p = has_tsc or (has_affs and any_present) or has_anti
        azmask_p = _or_bits(torch.where(inter_p, zcm[None, :], 0), 1)
        nbits_p = (zcm[d_p] if commit_p else azmask_p) & pz_bits  # [P]
        off_ok_p = (nbits_p[:, None] & offer_zc[None, :]) != 0  # [P, T]
        fit_tp = compat_t[None, :] & pool_type & off_ok_p
        k_tp = torch.where(fit_tp, fit_pool_t(pool_daemon), 0).to(I32)
        kmax_p = k_tp.max(dim=1).values
        one_set_p = fit_tp & (k_tp >= 1)
        charge_one_p = torch.where(
            one_set_p[:, :, None], type_charge[None, :, :], INT32_MAX
        ).min(dim=1).values
        charge_one_p = torch.where(charge_one_p == INT32_MAX, 0, charge_one_p).to(I32)
        already_over_p = torch.any(st["p_usage"] >= pool_limit, dim=1)
        elig_p = (
            r.gpool & has_inter_p & (kmax_p > 0) & ~already_over_p
            & (used < M) & (fresh_allow > 0)
        )
        found_p = bool(torch.any(elig_p))
        p_star = _argmax_first(elig_p)
        fin_zp = _zone_sets(nbits_p[p_star], zcm) & gax_cols
        nz_fin_p = int(fin_zp.sum())
        z_p = _argmax_first(fin_zp)
        Bz_p = min(int(B[z_p]), preempt_bound(z_p, E + used)) if nz_fin_p == 1 else BIG
        q_p = min(remaining, int(kmax_p[p_star]), int(fresh_allow), Bz_p)
        if self_anti:
            q_p = min(q_p, 1)

        # ---- (C) fixed-zone affinity bulk drain -------------------------------------
        aff_committed = (
            any_present and nz_fin_p == 1
            and bool(torch.all(~elig_m | ((bits_eff & ~zcm[z_p]) == 0)))
        )
        ze_cnt = (_zone_sets(bits_eff, zcm) & gax_cols[None, :]).sum(dim=1)
        aff_zonefree = (
            not any_present and is_member_a
            and bool(torch.all(~elig_m | (ze_cnt > 1))) and nz_fin_p > 1
        )
        aff_bulk = (
            has_affs and not has_tsc and not self_anti and not has_anti
            and not any_member_anti and not found_e and found_c and found_p
            and (aff_committed or aff_zonefree)
        )
        caps_aff = torch.where(elig_m, torch.minimum(k_m, c_host), 0).to(I32)
        pref_aff = torch.cumsum(caps_aff, 0).to(I32) - caps_aff
        if aff_bulk:
            aff_drain_m = torch.minimum(torch.clamp(remaining - pref_aff, min=0), caps_aff).to(I32)
        else:
            aff_drain_m = torch.zeros((M,), dtype=I32, device=dev)

        # ---- balanced-phase cycle batching --------------------------------------------
        counts_equal = int(torch.where(elig, cnt_p, -BIG).max()) == int(m1)
        multi_claim = bool(torch.any(elig_m & (zcount_m > 1)))
        cyc_ok = pure_tsc and is_self and counts_equal and not multi_claim and (found_e or found_c)
        tgt_e_1h = torch.zeros((E,), dtype=torch.bool, device=dev)
        tgt_c_1h = torch.zeros((M,), dtype=torch.bool, device=dev)
        tgt_has, tgt_cap = [], []
        for z in range(Z):
            elig_ez = elig_e & (nd == z)
            found_ez = bool(torch.any(elig_ez))
            e_z = _argmax_first(elig_ez)
            sc_z = elig_m & cz[:, z] & (zcount_m == 1)
            found_cz = bool(torch.any(sc_z))
            m_z = _argmax_first(sc_z)
            has_t = found_ez or found_cz
            cap_z = (min(int(e_fit[e_z]), int(e_host[e_z])) if found_ez
                     else min(int(k_m[m_z]), int(c_host[m_z])))
            relevant = bool(elig[z])
            tgt_has.append(has_t if relevant else True)
            tgt_cap.append(cap_z if relevant and has_t else BIG)
            if relevant and found_ez:
                tgt_e_1h[e_z] = True
            elif relevant and found_cz:
                tgt_c_1h[m_z] = True
        cyc_ok = cyc_ok and all(tgt_has)
        n_zones = int(elig.sum())
        k_sk = max(int(cap_p), 1)
        rounds = min(min(c // k_sk for c in tgt_cap), remaining // max(k_sk * n_zones, 1))
        cyc_ok = cyc_ok and rounds >= 1 and n_zones >= 1
        per_tgt = k_sk * rounds

        # ---- (A) multi-claim opening quantities -----------------------------------------
        full_p = min(int(kmax_p[p_star]), int(fresh_allow))
        rem_p = remaining - int(aff_drain_m.sum())
        q_tot_p = min(rem_p, Bz_p) if multi_ok else q_p
        trips_p = int(trips_of(pool_limit[p_star] - st["p_usage"][p_star], charge_one_p[p_star]))
        n_want_p = -(-q_tot_p // max(full_p, 1)) if full_p > 0 else 0
        n_open_p = min(n_want_p, trips_p, M - used) if multi_ok else 1

        # ---- (B) closed-form water-fill batching ------------------------------------------
        pz_star = pz_bits[p_star]
        off_zt_star = ((zcm[:, None] & pz_star) & offer_zc[None, :]) != 0  # [Z, T]
        fit_zt = compat_t[None, :] & pool_type[p_star][None, :] & off_zt_star
        k_cap_t = fit_pool_t(pool_daemon[p_star])  # [T]
        k_zt = torch.where(fit_zt, k_cap_t[None, :], 0).to(I32)  # [Z, T]
        kmax_z = k_zt.max(dim=1).values
        z_first = _argmax_first(elig)
        kmax0 = int(kmax_z[z_first])
        kmax_eq = bool(torch.all(~elig | (kmax_z == kmax0)))
        one_zt = fit_zt & (k_zt >= 1)
        charge_zr = torch.where(one_zt[:, :, None], type_charge[None, :, :], INT32_MAX).min(dim=1).values
        charge_zr = torch.where(charge_zr == INT32_MAX, 0, charge_zr).to(I32)
        charge0 = charge_zr[z_first]
        charge_eq = bool(torch.all(~elig[:, None] | (charge_zr == charge0[None, :])))
        covers = bool(torch.all(~elig | pzz[p_star]))
        km0 = max(kmax0, 1)
        trips0 = int(trips_of(pool_limit[p_star] - st["p_usage"][p_star], charge0))
        cand_z = elig_m_z & elig[None, :]
        k_pz = torch.where(
            off_zt & fit_base[:, None, :], k_raw[:, None, :], 0
        ).max(dim=2).values  # [M, Z]
        caps_mz = torch.where(cand_z, torch.minimum(k_pz, c_host[:, None]), 0).to(I32)
        no_node = bool(torch.all(~elig | (pos_node >= BIG)))
        tgts_ok = not bool(torch.any(cand_z & (zcount_m > 1)[:, None]))
        celig = torch.where(elig, cnt_p, BIG).to(I32)
        cs = torch.sort(celig).values
        kk = torch.arange(1, Z + 1, dtype=I32, device=dev)
        pref = torch.cumsum(torch.where(cs < BIG, cs, 0), 0).to(I32)
        nz_e = int(elig.sum())
        th_k = _floordiv(remaining + pref, kk)
        cs_next = torch.cat([cs[1:], torch.full((1,), BIG, dtype=I32, device=dev)])
        ok_k = (kk <= nz_e) & (th_k >= cs) & (th_k <= cs_next)
        theta = int(torch.where(ok_k, th_k, -BIG).max())
        fill = torch.where(elig, torch.clamp(theta - celig, 0, BIG), 0).to(I32)
        r_rem = remaining - int(fill.sum())
        at_lvl = elig & (celig <= theta)
        lexr = torch.cumsum(at_lvl.to(I32), 0) - 1
        bonus = at_lvl & (lexr < r_rem)
        T_zv = (fill + bonus.to(I32)).to(I32)
        pref_mz = torch.cumsum(caps_mz, 0).to(I32) - caps_mz
        take_mz = torch.minimum(torch.clamp(T_zv[None, :] - pref_mz, min=0), caps_mz).to(I32)
        tm_z = take_mz.sum(0).to(I32)
        fr_z = T_zv - tm_z
        n_z = _ceil_div(fr_z, km0).to(I32)
        n_mega = int(n_z.sum())
        mega_ok = (
            pure_tsc and is_self and no_node and tgts_ok and found_p
            and int(cap_p) == 1 and kmax0 > 0 and kmax_eq and charge_eq and covers
            and int(fresh_allow) >= kmax0 and n_mega <= M - used
            and trips0 >= n_mega and remaining > 0 and int(T_zv.sum()) == remaining
        )
        take_mega = torch.zeros((M,), dtype=I32, device=dev)
        zsel = torch.zeros((M,), dtype=torch.long, device=dev)
        drain_m = torch.zeros((M,), dtype=I32, device=dev)
        if mega_ok:
            # fresh-claim slot order: rank claims (z, g) by (open level, lex z)
            base_z = torch.where(elig, cnt_p + tm_z, BIG).to(I32)
            Garr = torch.arange(M, dtype=I32, device=dev)
            K_zg = base_z[:, None] + Garr[None, :] * km0  # [Z, M]
            diff = K_zg[:, :, None] - base_z[None, None, :]  # [Z, M, Z]
            below = torch.minimum(
                torch.clamp(_ceil_div(diff, km0), min=0), n_z[None, None, :]
            )
            tied = (
                (diff >= 0) & (torch.remainder(diff, km0) == 0)
                & (_floordiv(diff, km0) < n_z[None, None, :])
                & (zidx[None, None, :] < zidx[:, None, None])
            )
            rank_zg = (below.sum(2) + tied.sum(2)).to(I32)  # [Z, M]
            valid = (Garr[None, :] < n_z[:, None]) & elig[:, None] & (rank_zg < M)
            take_fr = torch.minimum(
                torch.clamp(fr_z[:, None] - Garr[None, :] * km0, min=0),
                torch.tensor(km0, dtype=I32, device=dev),
            ).to(I32)
            scat_z = torch.zeros((M,), dtype=torch.long, device=dev)
            scat_take = torch.zeros((M,), dtype=I32, device=dev)
            zz = zidx[:, None].expand(Z, M)
            scat_z[rank_zg[valid].long()] = zz[valid].long()
            scat_take[rank_zg[valid].long()] = take_fr[valid]
            j_off = midx - used
            in_mega = (j_off >= 0) & (j_off < n_mega)
            jc = torch.clamp(j_off, 0, M - 1).long()
            zsel = scat_z[jc]
            take_mega = torch.where(in_mega, scat_take[jc], 0).to(I32)
            drain_m = take_mz.sum(1).to(I32)

        # ---- selection & unified masked apply ---------------------------------------------
        cyc_eff = cyc_ok and not mega_ok
        use_e = found_e and not cyc_eff and not mega_ok
        use_c = not found_e and found_c and not cyc_eff and not mega_ok and not aff_bulk
        use_p = (not found_e and (not found_c or aff_bulk) and found_p
                 and not cyc_eff and not mega_ok)

        take_e_add = torch.zeros((E,), dtype=I32, device=dev)
        if use_e:
            take_e_add[e_star] += q_e
        if cyc_eff:
            take_e_add = take_e_add + torch.where(tgt_e_1h, per_tgt, 0).to(I32)
        take_c_add = aff_drain_m.clone()
        if use_c:
            take_c_add[m_star] += q_c
        if cyc_eff:
            take_c_add = take_c_add + torch.where(tgt_c_1h, per_tgt, 0).to(I32)

        # existing-node state
        st["e_cum"] = st["e_cum"] + take_e_add[:, None] * req[None, :]
        st["e_cm"] = st["e_cm"] + take_e_add[:, None] * mg_i[None, :]
        st["e_co"] = st["e_co"] + ((take_e_add[:, None] > 0) & anti_q[None, :]).to(I32)

        # open-claim state
        added = take_c_add > 0
        c_cum = st["c_cum"] + take_c_add[:, None] * req[None, :]
        c_mask = torch.where(added[:, None], fit_nt & (k_nt >= take_c_add[:, None]), st["c_mask"])
        c_zc_bits = torch.where(added, bits_eff, c_zc_bits)
        c_gbits = st["c_gbits"] | torch.where(added[:, None], r.gword[None, :], 0)
        c_cm = st["c_cm"] + take_c_add[:, None] * mg_i[None, :]
        c_co = st["c_co"] + (added[:, None] & anti_q[None, :]).to(I32)
        c_vm = c_vm + take_c_add[:, None] * mv_i[None, :]
        c_vo = c_vo | (added[:, None] & owned_anti[None, :])

        # water-fill target drains (k_raw is the event-start fit count)
        drained = drain_m > 0
        ok_off_all = (c_zc_bits[:, None] & offer_zc[None, :]) != 0
        c_cum = c_cum + drain_m[:, None] * req[None, :]
        c_mask = torch.where(
            drained[:, None],
            c_mask & compat_t[None, :] & ok_off_all & (k_raw >= drain_m[:, None]),
            c_mask,
        )
        c_gbits = c_gbits | torch.where(drained[:, None], r.gword[None, :], 0)
        c_cm = c_cm + drain_m[:, None] * mg_i[None, :]
        c_co = c_co + (drained[:, None] & anti_q[None, :]).to(I32)
        c_vm = c_vm + drain_m[:, None] * mv_i[None, :]

        # new-claim open: n_open_p slots in the committed domain (A)
        j_off = midx - used
        tq = torch.zeros((M,), dtype=I32, device=dev)
        p_usage = st["p_usage"].clone()
        if use_p:
            is_new = (j_off >= 0) & (j_off < n_open_p)
            if multi_ok:
                tq_all = torch.clamp(
                    torch.clamp(q_tot_p - j_off * max(full_p, 1), min=0), max=full_p
                )
            else:
                tq_all = torch.full((M,), q_p, dtype=I32, device=dev)
            tq = torch.where(is_new, tq_all, 0).to(I32)
            c_cum = torch.where(
                is_new[:, None], pool_daemon[p_star][None, :] + tq[:, None] * req[None, :], c_cum
            )
            c_mask = torch.where(
                is_new[:, None], fit_tp[p_star][None, :] & (k_tp[p_star][None, :] >= tq[:, None]), c_mask
            )
            c_zc_bits = torch.where(is_new, nbits_p[p_star], c_zc_bits)
            c_gbits = torch.where(is_new[:, None], r.gword[None, :], c_gbits)
            c_pool = torch.where(is_new, p_star, c_pool).to(I32)
            c_cm = torch.where(is_new[:, None], tq[:, None] * mg_i[None, :], c_cm)
            c_co = torch.where(is_new[:, None], ((tq[:, None] > 0) & anti_q[None, :]).to(I32), c_co)
            c_vm = torch.where(is_new[:, None], tq[:, None] * mv_i[None, :], c_vm)
            c_vo = torch.where(is_new[:, None], (tq[:, None] > 0) & owned_anti[None, :], c_vo)
            p_usage[p_star] = p_usage[p_star] + charge_one_p[p_star] * n_open_p
            used += n_open_p

        # mega-generation open (B): rotating domain per slot
        if mega_ok:
            in_mega = (j_off >= 0) & (j_off < n_mega)
            fit_sel = fit_zt[zsel]
            k_sel = k_zt[zsel]
            c_cum = torch.where(
                in_mega[:, None], pool_daemon[p_star][None, :] + take_mega[:, None] * req[None, :], c_cum
            )
            c_mask = torch.where(in_mega[:, None], fit_sel & (k_sel >= take_mega[:, None]), c_mask)
            c_zc_bits = torch.where(in_mega, zcm[zsel] & pz_star, c_zc_bits)
            c_gbits = torch.where(in_mega[:, None], r.gword[None, :], c_gbits)
            c_pool = torch.where(in_mega, p_star, c_pool).to(I32)
            c_cm = torch.where(in_mega[:, None], take_mega[:, None] * mg_i[None, :], c_cm)
            c_co = torch.where(
                in_mega[:, None], ((take_mega[:, None] > 0) & anti_q[None, :]).to(I32), c_co
            )
            c_vm = torch.where(in_mega[:, None], take_mega[:, None] * mv_i[None, :], c_vm)
            p_usage[p_star] = p_usage[p_star] + charge0 * n_mega
            used += n_mega

        # domain-count recording over the post-update claim bits, and
        # anti-owner registration on the target's recorded domain
        contrib = _count_contrib(a, take_e_add, take_c_add + drain_m + tq + take_mega, c_zc_bits)
        owner_rec = torch.zeros((Z,), dtype=torch.bool, device=dev)
        if use_e and z_e >= 0:
            owner_rec[min(z_e, Z - 1)] = True
        if use_c and nz_fin == 1:
            owner_rec[z_c] = True
        if use_p and nz_fin_p == 1:
            owner_rec[z_p] = True
        st.update(
            c_cum=c_cum.to(I32), c_mask=c_mask, c_zc_bits=c_zc_bits.to(I32), c_gbits=c_gbits,
            c_pool=c_pool, c_cm=c_cm.to(I32), c_co=c_co.to(I32), c_vm=c_vm.to(I32), c_vo=c_vo,
            p_usage=p_usage, used=torch.tensor(used, dtype=I32, device=dev),
            v_count=(v_count + mv_i[:, None] * contrib[None, :]).to(I32),
            v_owner_z=v_owner_z | (owned_anti[:, None] & owner_rec[None, :]),
        )
        placed = int(
            take_e_add.sum() + take_c_add.sum() + tq.sum() + take_mega.sum() + drain_m.sum()
        )
        remaining -= placed
        progress = placed > 0
        fuel -= 1
        events += 1
        take_e_acc = take_e_acc + take_e_add
        take_c_acc = take_c_acc + take_c_add + tq + take_mega + drain_m
    return take_e_acc, take_c_acc, torch.tensor(remaining, dtype=I32, device=dev), events


def _step_plain(a, st, g: int, count: int, M: int, zone_engine: bool, rows=None):
    """One scan step (the JAX step_body) for `count` pods of group g: the
    fast branch, or with `zone_engine` the domain event engine when the
    group owns a V-axis constraint or is a member of an anti sig. `rows`,
    the run's (q_row, v_row) index rows, selects the sparse view. Returns
    (take_e, take_c, leftover, events)."""
    r = _Run(a, g, count, a["group_pair_nok"].shape[1], *(rows or ()))
    if zone_engine and r.constrained():
        return _zoned_plain(a, st, r, M)
    return (*_fast_plain(a, st, r, M), 0)


def _sparse_rows(sparse, s: int):
    """Run s's (q_row, v_row) of the index tables `sparse`, or None."""
    return None if sparse is None else (sparse[0][s], sparse[1][s])


def _scan_plain(args, state: FFDState, M: int, zone_engine: bool,
                ckpt_every: int = 0, n_ckpt: int = 0, sparse=None):
    """The scan from carry `state` (updated in place) over the run arrays
    of `args`; with ckpt_every, n_ckpt >= 1 also the snapshot ring of step_ck
    (ffd.py:1825-1850): step pos = i + 1 writes slot ((pos // K) - 1) %
    n_ckpt when pos % K == 0, padded steps included, and records
    prefix[slot] = pos. `sparse`: the (run_q_idx, run_v_idx) tables of the
    sparse form. Returns (FFDOutput, CheckpointRing or None)."""
    a = dict(zip(ARG_SPEC, args))
    st = state._asdict()
    dev = a["node_free"].device
    E = a["node_free"].shape[0]
    zero = torch.zeros((), dtype=I32, device=dev)
    ring = _ring0(state, n_ckpt) if ckpt_every > 0 and n_ckpt > 0 else None
    events = 0
    takes_e, takes_c, lefts = [], [], []
    for i, (g, count) in enumerate(zip(a["run_group"].tolist(), a["run_count"].tolist())):
        if count <= 0:  # padded runs skip the body
            takes_e.append(torch.zeros((E,), dtype=I32, device=dev))
            takes_c.append(torch.zeros((M,), dtype=I32, device=dev))
            lefts.append(zero)
        else:
            te, tc, lo, n = _step_plain(a, st, g, count, M, zone_engine, _sparse_rows(sparse, i))
            events += n
            takes_e.append(te)
            takes_c.append(tc)
            lefts.append(lo)
        pos = i + 1
        if ring is not None and pos % ckpt_every == 0:
            slot = (pos // ckpt_every - 1) % n_ckpt
            for r, name in zip(ring.states, FFDState._fields):
                r[slot] = st[name]
            ring.prefix[slot] = pos
    out = FFDOutput(
        take_e=torch.stack(takes_e),
        take_c=torch.stack(takes_c),
        leftover=torch.stack(lefts),
        state=FFDState(**st),
        events=torch.tensor(events, dtype=I32, device=dev),
    )
    return out, ring


def ffd_solve_plain(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """Plain PyTorch transcription of the JAX `ffd_solve` scan: per run, the
    fast branch, or with `zone_engine` the domain event engine for runs
    whose group owns a V-axis constraint or is a member of an anti sig."""
    return _scan_plain(args, _state0(args, max_claims), max_claims, zone_engine)[0]


def ffd_solve_ckpt_plain(*args, max_claims: int, zone_engine: bool = False,
                         ckpt_every: int = 16, n_ckpt: int = 4):
    """Plain version of the JAX `ffd_solve_ckpt`: the cold scan plus its
    checkpoint ring. Returns (FFDOutput, CheckpointRing)."""
    return _scan_plain(args, _state0(args, max_claims), max_claims, zone_engine,
                       ckpt_every, n_ckpt)


def ffd_resume_plain(init_state: FFDState, *args, max_claims: int, zone_engine: bool = False,
                     ckpt_every: int = 16, n_ckpt: int = 4):
    """Plain version of the JAX `ffd_resume`: the scan over the suffix run
    arrays of `args`, started from a copy of `init_state` (the carry after
    the prefix), with a fresh, suffix-relative ring. Returns
    (FFDOutput of the suffix, CheckpointRing)."""
    return _scan_plain(args, _resume_state(init_state, args, max_claims), max_claims,
                       zone_engine, ckpt_every, n_ckpt)


def ffd_solve_ladder_plain(run_ladder, *args, max_claims: int,
                           zone_engine: bool = False, sparse=None) -> LadderOutput:
    """Plain PyTorch transcription of the JAX `ffd_solve_ladder` scan
    (step_ladder, ffd.py:1714-1800): each run walks its rung cascade. The
    base rung (level 0) pours every still-unplaced pod of the run's group;
    rung l >= 1 pours ONE pod of group run_ladder[s, l-1] (the run's pod
    spec with its l lowest-weight preferences dropped), and a -1 there ends
    the walk. After a base attempt the walk goes to rung 1, after a rung
    that placed its pod back to the base, after one that placed nothing one
    rung up; it stops when the run is placed, past the last rung, or out of
    fuel. Every attempt is one full step body for its own group (the fast
    branch or, with `zone_engine`, the event engine by that group's own
    constraints) and commits its carry; take rows add up over the run's
    attempts, and leftover is what remains when the walk stops. `attempts`
    counts the step bodies run. `sparse`: the (run_q_idx, run_v_idx)
    tables, each row the union over the run's base and rung groups; every
    attempt re-gathers its own group's flags through them."""
    a = dict(zip(ARG_SPEC, args))
    st = _state0(args, max_claims)._asdict()
    dev = a["node_free"].device
    E = a["node_free"].shape[0]
    G = a["group_compat_t"].shape[0]
    M = max_claims
    Lw = int(run_ladder.shape[1])
    ladder = run_ladder.tolist()
    events = attempts = 0
    takes_e, takes_c, lefts = [], [], []
    for s, (g, count) in enumerate(zip(a["run_group"].tolist(), a["run_count"].tolist())):
        te_a = torch.zeros((E,), dtype=I32, device=dev)
        tc_a = torch.zeros((M,), dtype=I32, device=dev)
        remaining = count if count > 0 else 0
        lvl, fuel = 0, (count + 1) * (Lw + 2) + 4
        while remaining > 0 and lvl <= Lw and fuel > 0:
            fuel -= 1
            is_base = lvl == 0
            gv = ladder[s][min(max(lvl - 1, 0), Lw - 1)]
            if not (is_base or gv >= 0):
                break  # past the run's last rung
            g_cur = g if is_base else min(max(gv, 0), G - 1)
            cnt = remaining if is_base else 1
            te, tc, lo, n = _step_plain(a, st, g_cur, cnt, M, zone_engine,
                                        _sparse_rows(sparse, s))
            events += n
            attempts += 1
            placed = cnt - int(lo)
            lvl = 1 if is_base else (0 if placed > 0 else lvl + 1)
            remaining -= placed
            te_a = te_a + te
            tc_a = tc_a + tc
        takes_e.append(te_a)
        takes_c.append(tc_a)
        lefts.append(torch.tensor(remaining, dtype=I32, device=dev))
    return LadderOutput(
        take_e=torch.stack(takes_e),
        take_c=torch.stack(takes_c),
        leftover=torch.stack(lefts),
        state=FFDState(**st),
        events=torch.tensor(events, dtype=I32, device=dev),
        attempts=torch.tensor(attempts, dtype=I32, device=dev),
    )


def ffd_solve_sparse_plain(run_q_idx, run_v_idx, *args, max_claims: int,
                           zone_engine: bool = False) -> FFDOutput:
    """Plain version of the JAX `ffd_solve_sparse`: ffd_solve_plain with
    the fast branch's Q/V-axis state read through the run's index rows
    (`run_q_idx` [S, Kq], `run_v_idx` [S, Kv] int32, -1 padded)."""
    return _scan_plain(args, _state0(args, max_claims), max_claims, zone_engine,
                       sparse=(run_q_idx, run_v_idx))[0]


def ffd_solve_ckpt_sparse_plain(run_q_idx, run_v_idx, *args, max_claims: int,
                                zone_engine: bool = False, ckpt_every: int = 16,
                                n_ckpt: int = 4):
    """Plain version of the JAX `ffd_solve_ckpt_sparse`. Its ring is
    interchangeable with the dense scan's: (FFDOutput, CheckpointRing)."""
    return _scan_plain(args, _state0(args, max_claims), max_claims, zone_engine,
                       ckpt_every, n_ckpt, sparse=(run_q_idx, run_v_idx))


def ffd_resume_sparse_plain(init_state: FFDState, run_q_idx, run_v_idx, *args,
                            max_claims: int, zone_engine: bool = False,
                            ckpt_every: int = 16, n_ckpt: int = 4):
    """Plain version of the JAX `ffd_resume_sparse`: the suffix scan from a
    copy of `init_state` (a dense or a sparse scan's checkpoint), the
    index tables holding the suffix's rows."""
    return _scan_plain(args, _resume_state(init_state, args, max_claims), max_claims,
                       zone_engine, ckpt_every, n_ckpt, sparse=(run_q_idx, run_v_idx))


def ffd_solve_ladder_sparse_plain(run_ladder, run_q_idx, run_v_idx, *args, max_claims: int,
                                  zone_engine: bool = False) -> LadderOutput:
    """Plain version of the JAX `ffd_solve_ladder_sparse`."""
    return ffd_solve_ladder_plain(run_ladder, *args, max_claims=max_claims,
                                  zone_engine=zone_engine, sparse=(run_q_idx, run_v_idx))


# --- plain versions of the output compaction -------------------------------


def _pack_u16_pairs(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int tensors -> int32 words holding (lo, hi) as little-endian
    uint16 halves, the layout of the JAX bitcast of a [n, 2] uint16 array."""
    w = (lo.to(torch.int64) & 0xFFFF) | ((hi.to(torch.int64) & 0xFFFF) << 16)
    return _i32_bits(w)


def compact_takes_plain(take_e, take_c, cap: int):
    """[Sp,E]/[Sp,M] dense takes -> run-major packed nonzero entries:
    (overflow i32 scalar, n i32 scalar, cnt16 [Sp/2] i32, pairs [cap] i32).
    Entries are (code, count) uint16 pairs, code = column of the [E + M]
    grid; overflow is set when a take exceeds uint16 range or more than
    `cap` entries exist."""
    Sp = take_e.shape[0]
    K = take_e.shape[1] + take_c.shape[1]
    dev = take_e.device
    grid = torch.cat([take_e, take_c], dim=1)
    val = grid.reshape(-1)
    code = torch.arange(K, dtype=I32, device=dev).repeat(Sp)
    mask = val > 0
    cnt_s = (grid > 0).sum(dim=1).to(I32)
    pos = torch.cumsum(mask.to(I32), 0).to(I32) - 1
    n = mask.sum().to(I32)
    sel = mask & (pos < cap)
    ent_c = torch.zeros((cap,), dtype=I32, device=dev)
    ent_v = torch.zeros((cap,), dtype=I32, device=dev)
    ent_c[pos[sel].long()] = code[sel]
    ent_v[pos[sel].long()] = val[sel]
    overflow = ((n > cap) | (val.max() > 65535)).to(I32)
    pairs = _pack_u16_pairs(ent_c, ent_v)
    c2 = cnt_s.reshape(-1, 2)  # Sp is 16-bucketed: even
    cnt16 = _pack_u16_pairs(c2[:, 0], c2[:, 1])
    return overflow, n, cnt16, pairs


def pack_mask_words_plain(c_mask) -> torch.Tensor:
    """[M, T] bool -> [M, ceil(T/32)] uint32 words (as int32 bits); bit j
    of word w is type 32w + j."""
    M, T = c_mask.shape
    Wm = (T + 31) // 32
    cm = torch.zeros((M, Wm * 32), dtype=torch.int64, device=c_mask.device)
    cm[:, :T] = c_mask.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=c_mask.device) << torch.arange(
        32, dtype=torch.int64, device=c_mask.device
    )
    return _i32_bits((cm.reshape(M, Wm, 32) * weights).sum(dim=2))


def compact_claim_meta_plain(c_mask, c_zc_bits, c_gbits, c_pool, cap_u: int):
    """Pack c_mask into words, then dedup the per-claim identity rows (type
    words ++ zone/ct bits ++ group bits ++ pool) into a unique-row table
    plus per-claim uint16 ids. Returns (overflow_u, n_u, uniq [cap_u, Wt],
    mid16 [M/2], meta [M, Wt]), all int32; `meta` holds every claim's row
    (its first words are the packed type mask the wide re-fetch ships)."""
    M = c_pool.shape[0]
    dev = c_pool.device
    meta = torch.cat(
        [pack_mask_words_plain(c_mask), c_zc_bits[:, None], c_gbits, c_pool[:, None]],
        dim=1,
    ).to(I32)
    eq = torch.all(meta[:, None, :] == meta[None, :, :], dim=2)  # [M, M]
    first = torch.argmax(eq.to(I32), dim=1)  # first equal row (diag is True)
    is_rep = first == torch.arange(M, device=dev)
    pos = torch.cumsum(is_rep.to(I32), 0).to(I32) - 1
    n_u = is_rep.sum().to(I32)
    uniq = torch.zeros((cap_u, meta.shape[1]), dtype=I32, device=dev)
    sel = is_rep & (pos < cap_u)
    uniq[pos[sel].long()] = meta[sel]
    mid = pos[first]
    overflow_u = (n_u > cap_u).to(I32)
    m2 = mid.reshape(-1, 2)  # M is >= 64-bucketed: even
    mid16 = _pack_u16_pairs(m2[:, 0], m2[:, 1])
    return overflow_u, n_u, uniq, mid16, meta


def pack_delta_words(Sp: int, M: int, cap: int, cap_u: int, Wt: int) -> int:
    """int32 words of the delta pack's fetch buffer (pack_delta_plain):
    [overflow, n, n_u], cnt16 [Sp/2], pairs [cap], leftover [Sp], uniq
    [cap_u, Wt], mid16 [M/2], used."""
    return 3 + Sp // 2 + cap + Sp + cap_u * Wt + M // 2 + 1


def pack_delta_plain(take_e, take_c, leftover, state: FFDState, cap: int, cap_u: int):
    """Plain version of the JAX `_pack_outputs_delta` (backend.py:635): ONE
    int32 buffer [overflow_t | overflow_u, n, n_u, cnt16, pairs, leftover,
    uniq, mid16, used] from compact_takes_plain and compact_claim_meta_plain
    (pack_delta_words words). The host rebuilds c_cum from the entries."""
    overflow_t, n, cnt16, pairs = compact_takes_plain(take_e, take_c, cap)
    overflow_u, n_u, uniq, mid16, _meta = compact_claim_meta_plain(
        state.c_mask, state.c_zc_bits, state.c_gbits, state.c_pool, cap_u
    )
    parts = [
        (overflow_t | overflow_u).reshape(1),
        n.reshape(1),
        n_u.reshape(1),
        cnt16.reshape(-1),
        pairs.reshape(-1),
        leftover.reshape(-1),
        uniq.reshape(-1),
        mid16.reshape(-1),
        state.used.reshape(1),
    ]
    return torch.cat(parts)


def pack_words(Sp: int, Ep: int, M: int, T: int, Wg: int, R: int) -> int:
    """int32 words of the dense output pack (pack_outputs_plain)."""
    return (1 + (Sp * Ep + 1) // 2 + (Sp * M + 1) // 2 + Sp
            + M * ((T + 31) // 32 + 1 + Wg + 1 + R) + 1)


def _pack16(x) -> torch.Tensor:
    """A take grid flattened, padded to an even count, as uint16 pairs in
    int32 words (the JAX pack16: astype uint16, bitcast pairs)."""
    flat = x.reshape(-1)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.reshape(-1, 2)
    return _pack_u16_pairs(pairs[:, 0], pairs[:, 1])


def pack_outputs_plain(take_e, take_c, leftover, state: FFDState) -> torch.Tensor:
    """Plain version of the JAX `_pack_outputs` (backend.py:511): ONE int32
    buffer [overflow flag, take_e and take_c as uint16 pairs (each padded
    to an even count), leftover, c_mask as uint32 words, c_zc_bits,
    c_gbits, c_pool, c_cum, used]; the flag is set when a take exceeds
    65535."""
    dev = take_e.device
    zero = torch.zeros((), dtype=I32, device=dev)
    big = torch.maximum(
        take_e.max() if take_e.numel() else zero, take_c.max() if take_c.numel() else zero
    )
    parts = [
        (big > 65535).to(I32).reshape(1),
        _pack16(take_e),
        _pack16(take_c),
        leftover.reshape(-1),
        pack_mask_words_plain(state.c_mask).reshape(-1),
        state.c_zc_bits.reshape(-1),
        state.c_gbits.reshape(-1),
        state.c_pool.reshape(-1),
        state.c_cum.reshape(-1),
        state.used.reshape(1),
    ]
    return torch.cat([t.to(I32) for t in parts])


# --- CUDA kernel wrappers ----------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(vals):
    return (ctypes.c_int * len(vals))(*[int(v) for v in vals])


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# Kernel limits (csrc/ffd_kernels.cu): the per-run R rows and the
# per-event domain vectors live in static shared memory. The per-run Q rows
# of every scan instance, and the zoned instances' V rows, are dynamic
# shared memory sized at launch: see scan_rows_budget.
MAX_R = 16
MAX_Z = 32
MAX_P = 64

_BUDGETS: dict = {}


def scan_rows_budget(device):
    """The bytes of launch-sized shared rows (scan_rows_bytes) a scan launch
    holds on `device`: the card's opt-in shared memory per block less an
    instance's static share, the least over every scan instance (the
    *_rows_budget query of each of the five scan libraries). None on the
    CPU, where the plain versions hold any Q and V."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    budget = _BUDGETS.get(idx)
    if budget is None:
        from .build import load

        with torch.cuda.device(idx):
            budgets = [getattr(load(lib), fn)(None, 0, None, None)
                       for lib, fn in (("ffd_kernels", "ffd_rows_budget"),
                                       ("ffd_sparse_kernels", "ffd_sparse_rows_budget"),
                                       ("ffd_lanes_kernels", "ffd_lanes_rows_budget"),
                                       ("ffd_lanes_sparse_kernels",
                                        "ffd_lanes_sparse_rows_budget"),
                                       ("ffd_batched_kernels", "ffd_batched_rows_budget"))]
        if min(budgets) < 0:
            raise RuntimeError(f"ffd_rows_budget: CUDA error {-min(budgets)}")
        budget = _BUDGETS[idx] = min(budgets)
    return budget


def scan_rows_bytes(Q: int, Kq: int, V: int, Kv: int, zone_engine: bool) -> int:
    """Bytes of one launch's shared rows (csrc/ffd_kernels.cu
    scan_rows_bytes): a 24-byte QRow over max(Q, Kq) rows, then with the
    zoned branch vk/vcol as int and mv/ov as bytes over max(V, Kv) / Kv. A
    dense launch passes Kq = Kv = 0; a sparse zoned one at Kq = Q, Kv = V
    takes 24 bytes a Q row and 10 a V row."""
    rows = 24 * max(Q, Kq)
    if zone_engine:
        rows += 6 * max(V, Kv) + 4 * Kv
    return rows


def q_cap(device):
    """The most Q rows a scan launch holds on `device` with no V rows (24
    bytes a row, a sparse view as wide as Q); None on the CPU."""
    budget = scan_rows_budget(device)
    return None if budget is None else budget // 24


def zone_v_cap(device):
    """The most V rows (max(V, Kv)) a zoned scan launch holds on `device`
    with no Q rows (10 bytes a row); None on the CPU."""
    budget = scan_rows_budget(device)
    return None if budget is None else budget // 10


def _check_rows(Q: int, Kq: int, V: int, Kv: int, zone_engine: bool, device, name: str) -> None:
    budget = scan_rows_budget(device)
    need = scan_rows_bytes(Q, Kq, V, Kv, zone_engine)
    if budget is not None and need > budget:
        raise ValueError(f"{name}: Q={Q}, Kq={Kq}, V={V}, Kv={Kv} need {need} B of shared rows, "
                         f"past the {budget} B a scan launch holds on this card")


# the scan's inputs as the launcher takes them: ARG_SPEC without the four
# arrays that seed the carry (FFDState's initial values)
_SCAN_INPUTS = tuple(
    n for n in ARG_SPEC if n not in ("pool_usage0", "node_q_member", "node_q_owner", "v_count0")
)


def scan_scratch_words(E: int, M: int, T: int, Z: int) -> int:
    """int32 words of the scan's global scratch (csrc/ffd_kernels.cu
    scan_runs): the fast branch's [E], [M] and [T] rows, then the zoned
    branch's per-claim, per-type and [M, Z] rows."""
    return 2 * E + 11 * M + 3 * T + 2 * M * Z + 64


# The cluster scans (K1, K6, K7 and their sparse twins: csrc/ffd_kernels.cu
# ffd_cluster_kernel, ffd_ladder_kernel) run one solve on one thread-block
# cluster of up to MAX_CL CTAs of CLUSTER_THREADS threads (16 where the card
# allows, else 8; cluster_info); the lanes scans (K15, K17, K17s:
# ffd_lanes_kernel, ffd_lanes_sparse_kernel) one such cluster a lane, of
# LANE_CLUSTERS CTAs as lanes_cluster picks; the batched scan K4
# (ffd_batched_kernel) one such cluster a subset row, or one CTA a row
# (cuda/consolidate.py batched_team). NT: the threads of the one-block
# kernels (the delta pack's CTAs).
MAX_CL = 16
CLUSTER_THREADS = 512
NT = 1024


def cluster_scratch_words(E: int, M: int, T: int, Z: int) -> int:
    """int32 words of a cluster scan's global scratch: the scan's own
    (scan_scratch_words), then MAX_CL rows of its CTAs' own copies of the
    rows every CTA computes whole (k_t, fit_t, k_cap [T]; the fresh claims'
    order scat_z, scat_take [M])."""
    return scan_scratch_words(E, M, T, Z) + MAX_CL * (3 * T + 2 * M)


def _ceil_chunks(lo, hi, parts: int):
    """[..., parts, 2] int64: the contiguous ceil split of each [lo, hi)."""
    lo, hi = np.asarray(lo, np.int64)[..., None], np.asarray(hi, np.int64)[..., None]
    per = -(-(hi - lo) // parts)
    a = np.minimum(lo + np.arange(parts) * per, hi)
    return np.stack([a, np.minimum(a + per, hi)], -1)


def team_chunks(n: int, cl: int) -> dict:
    """The split of n rows over a scan's team (csrc/ffd_kernels.cu
    thread_chunk, warp_chunk, cta_chunk, lane_chunk), cl CTAs (0: the
    one-block scans), each an int64 array of [lo, hi) rows: "threads", a
    contiguous chunk per thread of the team (the node pour's prefix);
    "ctas", ceil(n / CTAs) rows a CTA; "warps", each CTA's rows split over
    its warps (claim rows); "lanes", each warp's piece per lane, warp-major
    (the claim pour's prefix)."""
    nt, ctas = (NT, 1) if cl == 0 else (CLUSTER_THREADS, cl)
    nwb = nt // 32
    ctas_rows = _ceil_chunks(0, n, ctas)
    warps = _ceil_chunks(ctas_rows[:, 0], ctas_rows[:, 1], nwb).reshape(-1, 2)
    lanes = _ceil_chunks(warps[:, 0], warps[:, 1], 32).reshape(-1, 2)
    return dict(threads=_ceil_chunks(0, n, ctas * nt), warps=warps, ctas=ctas_rows, lanes=lanes)


_CLUSTERS: dict = {}


def cluster_info(device) -> dict:
    """The cluster size the card gives each cluster scan instance, and the
    clusters of 16 and of 8 CTAs it holds at once at the instance's widest
    launch (the occupancy query; csrc/ffd_kernels.cu pick_cluster), chosen
    once per device: {instance name: {"cl", "fit16", "fit8"}}. None on the
    CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    info = _CLUSTERS.get(idx)
    if info is None:
        from .build import load

        info = {}
        with torch.cuda.device(idx):
            for lib, fn, sparse in (("ffd_kernels", "ffd_cluster_info", None),
                                    ("ffd_sparse_kernels", "ffd_sparse_cluster_info", ())):
                out = (ctypes.c_int * 18)()
                rc = getattr(load(lib), fn)((ctypes.c_void_p * 1)(ctypes.addressof(out)), 1,
                                            None, None)
                _raise_on(rc, fn)
                for i, (kind, zone) in enumerate((("", False), ("", True), ("ckpt_", False),
                                                  ("ckpt_", True), ("ladder_", False),
                                                  ("ladder_", True))):
                    info[_scan_name(kind, zone, sparse)] = dict(
                        cl=out[3 * i], fit16=out[3 * i + 1], fit8=out[3 * i + 2])
        _CLUSTERS[idx] = info
    return info


# The lanes scans' cluster sizes, widest first (csrc/ffd_kernels.cu LANE_CL)
LANE_CLUSTERS = (16, 8, 4, 2)


def lanes_cluster(B: int, fits: dict) -> int:
    """The cluster size a lanes launch of B lanes takes (csrc/ffd_kernels.cu
    lanes_cl): the largest of LANE_CLUSTERS whose clusters the card holds
    all B at once (`fits`: {size: clusters of that size the card holds at
    once}, 0 or missing where it refuses the size); past every size, the
    smallest size it holds at all, and the lanes run in waves. Raises
    where it holds none."""
    if B < 1:
        raise ValueError(f"lanes_cluster: B={B} < 1")
    for cl in LANE_CLUSTERS:
        if fits.get(cl, 0) >= B:
            return cl
    held = [cl for cl in LANE_CLUSTERS if fits.get(cl, 0) >= 1]
    if not held:
        raise ValueError(f"lanes_cluster: the card holds no cluster of {LANE_CLUSTERS} ({fits})")
    return held[-1]


def lanes_cluster_info(device, B: int) -> dict:
    """The lanes instances' clusters of 16, 8, 4 and 2 CTAs the card holds
    at once at the instance's widest launch (the occupancy query, once per
    device) and the cluster size a launch of B lanes takes there, as the
    launcher reports them (ffd_lanes_cluster_info,
    ffd_lanes_sparse_cluster_info): {instance name: {"fits": {size:
    clusters}, "cl"}}, K15 / K17 under ffd_lanes_{fast,zoned}_scan, K17s
    under ffd_sharded_sparse_{fast,zoned}_scan. None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    from .build import load

    idx = torch.cuda.current_device() if dev.index is None else dev.index
    info = {}
    with torch.cuda.device(idx):
        for lib, fn, prefix in (("ffd_lanes_kernels", "ffd_lanes_cluster_info", "ffd_lanes"),
                                ("ffd_lanes_sparse_kernels", "ffd_lanes_sparse_cluster_info",
                                 "ffd_sharded_sparse")):
            out = (ctypes.c_int * 10)()
            rc = getattr(load(lib), fn)((ctypes.c_void_p * 1)(ctypes.addressof(out)), 1,
                                        _ints([B]), None)
            _raise_on(rc, fn)
            for z, kind in enumerate(("fast", "zoned")):
                info[f"{prefix}_{kind}_scan"] = dict(
                    fits=dict(zip(LANE_CLUSTERS, out[5 * z:5 * z + 4])), cl=out[5 * z + 4])
    return info


def floordiv_check(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """[D, N] int32: floor(num[i] / den[j]) by the cluster scans' exact
    division (csrc/ffd_kernels.cu floordiv_magic, through
    floordiv_check_kernel) for int32 num [N] and den [D] (every divisor
    >= 1) on the card; the plain floor (_floordiv) for tensors on the CPU."""
    if num.device.type != "cuda":
        return _floordiv(num.unsqueeze(0), den.unsqueeze(1))
    from .build import load

    _check(num, "num", I32)
    _check(den, "den", I32)
    if num.dim() != 1 or den.dim() != 1 or not num.numel() or not den.numel():
        raise ValueError("floordiv_check: num and den must be non-empty vectors")
    if int(den.min()) < 1:
        raise ValueError("floordiv_check: every divisor must be >= 1")
    out = torch.empty((den.numel(), num.numel()), dtype=I32, device=num.device)
    rc = load().floordiv_check_launch(_ptrs([num, den, out]), 3, _ints([num.numel(), den.numel()]),
                                      _stream())
    _raise_on(rc, "floordiv_check")
    return out


def cluster_barriers(n: int, cl: int) -> None:
    """Launch one cluster of cl CTAs (CLUSTER_THREADS threads each) that
    passes n cluster barriers, on the current stream (timing only)."""
    from .build import load

    rc = load().cluster_barrier_launch(None, 0, _ints([n, cl]), _stream())
    _raise_on(rc, "cluster_barrier")


def batch_scratch_words(E: int, M: int, T: int, Z: int, cl: int) -> int:
    """int32 words of one subset row's scratch in the batched scan on a
    team of cl CTAs (1: one CTA a row): the scan's own scratch, its CTAs'
    own rows (k_t, fit_t, k_cap [T]; scat_z, scat_take [M]), then the row's
    [E] and [M] take rows of the current run and its [E] removed-node mask
    (batch_take_offset: where the take rows start)."""
    return batch_take_offset(E, M, T, Z, cl) + 2 * E + M


def batch_take_offset(E: int, M: int, T: int, Z: int, cl: int) -> int:
    """The offset of a subset row's take rows in its scratch (the scan's
    own scratch, then cl CTAs' own rows)."""
    return scan_scratch_words(E, M, T, Z) + cl * (3 * T + 2 * M)


def _scan_name(kind: str, zone_engine: bool, sparse) -> str:
    """LAUNCHES key of a scan instance: kind "" (K1), "ladder_" or "ckpt_"."""
    return f"ffd_{kind}{'sparse_' if sparse is not None else ''}{'zoned' if zone_engine else 'fast'}_scan"


def _check_sparse(sparse, Sp: int, name: str, Q: int, V: int, zone_engine: bool):
    """The index tables of a sparse scan: int32 CUDA tensors [Sp, Kq] and
    [Sp, Kv] within the launch's shared rows (a launch holds max(Q, Kq) Q
    rows and, zoned, max(V, Kv) V rows: its constrained runs reload the
    dense flags). Returns (tensors, [Kq, Kv]); ([], []) for a dense scan,
    whose rows _check_scan_args checked."""
    if sparse is None:
        return [], []
    q, v = sparse
    for t, n in ((q, "run_q_idx"), (v, "run_v_idx")):
        _check(t, n, I32)
        if t.dim() != 2 or t.shape[0] != Sp:
            raise ValueError(f"{name}: {n} must be [{Sp}, K], got {tuple(t.shape)}")
    Kq, Kv = int(q.shape[1]), int(v.shape[1])
    _check_rows(Q, Kq, V, Kv, zone_engine, v.device, name)
    return [q, v], [Kq, Kv]


def _check_scan_args(a: dict, zone_engine: bool, name: str):
    """Shape, dtype, device and kernel-limit checks of the scan's shared
    arguments; returns (Sp, G, T, E, P, R, Q, W, V, Z)."""
    Sp = a["run_group"].shape[0]
    G, T = a["group_compat_t"].shape
    E, R = a["node_free"].shape
    P = a["pool_type"].shape[0]
    Q = a["q_kind"].shape[0]
    V = a["v_kind"].shape[0]
    Z = a["zone_col_mask"].shape[0]
    W = a["group_pair_nok"].shape[1]
    if R > MAX_R:
        raise ValueError(f"{name}: R={R} > {MAX_R}")
    if zone_engine and not (1 <= V and 1 <= Z <= MAX_Z and P <= MAX_P):
        raise ValueError(f"{name}: V={V}, Z={Z} or P={P} outside 1.., 1..{MAX_Z}, ..{MAX_P}")
    _check_rows(Q, 0, V, 0, zone_engine, a["q_kind"].device, name)
    shapes = {
        "run_group": (Sp,), "run_count": (Sp,), "group_req": (G, R),
        "group_compat_t": (G, T), "group_zc_bits": (G,), "group_pool": (G, P),
        "group_pair_nok": (G, W), "group_device": (G,), "type_alloc": (T, R),
        "type_charge": (T, R), "offer_zc_bits": (T,), "pool_type": (P, T),
        "pool_zc_bits": (P,), "pool_daemon": (P, R), "pool_limit": (P, R),
        "pool_usage0": (P, R), "node_free": (E, R), "node_compat": (G, E),
        "q_member": (G, Q), "q_owner": (G, Q), "q_kind": (Q,), "q_cap": (Q,),
        "node_q_member": (E, Q), "node_q_owner": (E, Q), "v_member": (G, V),
        "v_owner": (G, V), "v_kind": (V,), "v_cap": (V,), "v_primary": (G,),
        "v_aff": (G,), "v_count0": (V, Z), "node_zone": (E,), "zone_col_mask": (Z,),
        "node_dom2": (E,), "col_axis": (Z,), "group_daxis": (G,),
    }
    for n, sh in shapes.items():
        _check(a[n], n, torch.bool if ARG_DTYPES[n] == "bool" else I32, sh)
    return Sp, G, T, E, P, R, Q, W, V, Z


def _ffd_solve_cuda(*args, max_claims: int, zone_engine: bool = False,
                    sparse=None) -> FFDOutput:
    """K1, or with `sparse` (the index tables) K1s."""
    from .build import load

    a = dict(zip(ARG_SPEC, args))
    M = int(max_claims)
    name = _scan_name("", zone_engine, sparse)
    Sp, G, T, E, P, R, Q, W, V, Z = _check_scan_args(a, zone_engine, name)
    idx, kdims = _check_sparse(sparse, Sp, name, Q, V, zone_engine)
    st = _state0(args, M)
    dev = a["node_free"].device
    take_e = torch.empty((Sp, E), dtype=I32, device=dev)
    take_c = torch.empty((Sp, M), dtype=I32, device=dev)
    leftover = torch.empty((Sp,), dtype=I32, device=dev)
    events = torch.zeros((), dtype=I32, device=dev)
    scratch = torch.empty((cluster_scratch_words(E, M, T, Z),), dtype=I32, device=dev)
    ptrs = [a[n] for n in _SCAN_INPUTS] + list(st) + [take_e, take_c, leftover, events, scratch]
    dims = [Sp, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine)]
    launch = (load("ffd_sparse_kernels").ffd_scan_sparse_launch if sparse is not None
              else load().ffd_scan_launch)
    rc = launch(_ptrs(ptrs + idx), len(ptrs) + len(idx), _ints(dims + kdims), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st, events=events)


def ladder_scratch_words(E: int, M: int, T: int, Z: int, S: int) -> int:
    """int32 words of the ladder scan's global scratch: a cluster scan's
    own (cluster_scratch_words: the shared rows, then MAX_CL CTAs' own
    rows), then the current attempt's [E] and [M] take rows and its
    leftover slots [S], at offset cluster_scratch_words(E, M, T, Z)."""
    return cluster_scratch_words(E, M, T, Z) + E + M + S


def _ffd_solve_ladder_cuda(run_ladder, *args, max_claims: int,
                           zone_engine: bool = False, sparse=None) -> LadderOutput:
    """K6, or with `sparse` (the union index tables) K6s."""
    from .build import load

    a = dict(zip(ARG_SPEC, args))
    M = int(max_claims)
    name = _scan_name("ladder_", zone_engine, sparse)
    Sp, G, T, E, P, R, Q, W, V, Z = _check_scan_args(a, zone_engine, name)
    idx, kdims = _check_sparse(sparse, Sp, name, Q, V, zone_engine)
    _check(run_ladder, "run_ladder", I32)
    if run_ladder.dim() != 2 or run_ladder.shape[0] != Sp or run_ladder.shape[1] < 1:
        raise ValueError(f"{name}: run_ladder must be [{Sp}, Lw >= 1], got {tuple(run_ladder.shape)}")
    Lw = int(run_ladder.shape[1])
    st = _state0(args, M)
    dev = a["node_free"].device
    take_e = torch.empty((Sp, E), dtype=I32, device=dev)
    take_c = torch.empty((Sp, M), dtype=I32, device=dev)
    leftover = torch.empty((Sp,), dtype=I32, device=dev)
    events = torch.zeros((), dtype=I32, device=dev)
    attempts = torch.zeros((), dtype=I32, device=dev)
    scratch = torch.empty((ladder_scratch_words(E, M, T, Z, Sp),), dtype=I32, device=dev)
    ptrs = ([a[n] for n in _SCAN_INPUTS] + list(st)
            + [take_e, take_c, leftover, events, scratch, run_ladder, attempts])
    dims = [Sp, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine), Lw,
            cluster_scratch_words(E, M, T, Z)]
    launch = (load("ffd_sparse_kernels").ffd_ladder_sparse_launch if sparse is not None
              else load().ffd_ladder_launch)
    rc = launch(_ptrs(ptrs + idx), len(ptrs) + len(idx), _ints(dims + kdims), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return LadderOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st,
                        events=events, attempts=attempts)


def _ffd_scan_ckpt_cuda(init_state, *args, max_claims: int, zone_engine: bool,
                        ckpt_every: int, n_ckpt: int, sparse=None):
    """K7: ffd_solve_ckpt (init_state None: a fresh carry) or ffd_resume
    (the carry starts as copies of init_state); with `sparse` (the index
    tables) K7s, ffd_solve_ckpt_sparse / ffd_resume_sparse."""
    from .build import load

    a = dict(zip(ARG_SPEC, args))
    M = int(max_claims)
    name = _scan_name("ckpt_", zone_engine, sparse)
    Sp, G, T, E, P, R, Q, W, V, Z = _check_scan_args(a, zone_engine, name)
    idx, kdims = _check_sparse(sparse, Sp, name, Q, V, zone_engine)
    st = _state0(args, M) if init_state is None else _resume_state(init_state, args, M)
    ring = _ring0(st, n_ckpt)
    dev = a["node_free"].device
    take_e = torch.empty((Sp, E), dtype=I32, device=dev)
    take_c = torch.empty((Sp, M), dtype=I32, device=dev)
    leftover = torch.empty((Sp,), dtype=I32, device=dev)
    events = torch.zeros((), dtype=I32, device=dev)
    scratch = torch.empty((cluster_scratch_words(E, M, T, Z),), dtype=I32, device=dev)
    ptrs = ([a[n] for n in _SCAN_INPUTS] + list(st)
            + [take_e, take_c, leftover, events, scratch] + list(ring.states) + [ring.prefix])
    dims = [Sp, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine), ckpt_every, n_ckpt]
    launch = (load("ffd_sparse_kernels").ffd_ckpt_sparse_launch if sparse is not None
              else load().ffd_ckpt_launch)
    rc = launch(_ptrs(ptrs + idx), len(ptrs) + len(idx), _ints(dims + kdims), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    out = FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st, events=events)
    return out, ring


MAX_PACK_CL = 16  # the widest cluster of the delta pack (csrc/ffd_kernels.cu MAX_CL)
PACK_CTA_BYTES = 64 * 1024  # input bytes a CTA of the delta pack takes, about


def pack_delta_cluster(Sp: int, Ep: int, M: int, T: int) -> int:
    """The delta pack's CTAs a launch: the smallest power of two whose CTAs
    each read about PACK_CTA_BYTES of the take grid and the type mask, at
    most MAX_PACK_CL (the launcher takes 8 where the card holds no cluster
    of 16)."""
    need = 4 * Sp * (Ep + M) + M * T
    cl = 1
    while cl < MAX_PACK_CL and cl * PACK_CTA_BYTES < need:
        cl *= 2
    return cl


def pack_delta_scratch(out_words: int, M: int, Wt: int) -> int:
    """Words of the delta pack's allocation: the fetch buffer, then the
    kernel's scratch (csrc/ffd_kernels.cu pack_delta_launch lays it out):
    the claim rows [M, Wt], their hashes [M] (uint64), the hash table (S
    uint64 keys and S lowest claims, S the power of two >= max(64, 2M))
    and the ranks [M]."""
    S = 64
    while S < 2 * M:
        S *= 2
    o_meta = (out_words + 3) & ~3
    o_hash = (o_meta + M * Wt + 3) & ~3
    return o_hash + 2 * M + 3 * S + M


def _pack_delta_cuda(take_e, take_c, leftover, state: FFDState, cap: int, cap_u: int,
                     hash_bits: int = 64, cl: int | None = None) -> torch.Tensor:
    """The delta pack in one launch (pack_delta_kernel<hash_bits>). One
    allocation holds the fetch buffer and the kernel's scratch; the buffer
    is returned as a view of it. `hash_bits` 2 (a test instance) and `cl`
    (the cluster's CTAs) are for chip_smoke.py's checks."""
    from .build import load

    Sp, Ep = take_e.shape
    M, T = state.c_mask.shape
    W = state.c_gbits.shape[1]
    for t, n, dt, sh in ((take_e, "take_e", I32, (Sp, Ep)), (take_c, "take_c", I32, (Sp, M)),
                         (leftover, "leftover", I32, (Sp,)),
                         (state.c_mask, "c_mask", torch.bool, (M, T)),
                         (state.c_zc_bits, "c_zc_bits", I32, (M,)),
                         (state.c_gbits, "c_gbits", I32, (M, W)),
                         (state.c_pool, "c_pool", I32, (M,)), (state.used, "used", I32, ())):
        _check(t, n, dt, sh)
    if Sp % 2 or M % 2:
        raise ValueError(f"pack_delta: Sp={Sp} and M={M} must be even")
    Wt = (T + 31) // 32 + 1 + W + 1
    words = pack_delta_words(Sp, M, cap, cap_u, Wt)
    buf = torch.empty((pack_delta_scratch(words, M, Wt),), dtype=I32, device=take_e.device)
    if cl is None:
        cl = pack_delta_cluster(Sp, Ep, M, T)
    ptrs = [take_e, take_c, leftover, state.c_mask, state.c_zc_bits, state.c_gbits,
            state.c_pool, state.used, buf]
    rc = load().pack_delta_launch(_ptrs(ptrs), len(ptrs),
                                  _ints([Sp, Ep, M, T, W, cap, cap_u, cl, hash_bits, buf.numel()]),
                                  _stream())
    _raise_on(rc, "pack_delta")
    LAUNCHES["pack_delta"] += 1
    return buf[:words]


def _mask_words_cuda(c_mask) -> torch.Tensor:
    from .build import load

    M, T = c_mask.shape
    _check(c_mask, "c_mask", torch.bool)
    out = torch.empty((M, (T + 31) // 32), dtype=I32, device=c_mask.device)
    rc = load().mask_words_launch(_ptrs([c_mask, out]), 2, _ints([M, T]), _stream())
    _raise_on(rc, "mask_words")
    LAUNCHES["mask_words"] += 1
    return out


def _pack_outputs_cuda(take_e, take_c, leftover, state: FFDState) -> torch.Tensor:
    from .build import load

    Sp, Ep = take_e.shape
    M, T = state.c_mask.shape
    Wg = state.c_gbits.shape[1]
    R = state.c_cum.shape[1]
    for t, n, dt, sh in ((take_e, "take_e", I32, (Sp, Ep)), (take_c, "take_c", I32, (Sp, M)),
                         (leftover, "leftover", I32, (Sp,)),
                         (state.c_mask, "c_mask", torch.bool, (M, T)),
                         (state.c_zc_bits, "c_zc_bits", I32, (M,)),
                         (state.c_gbits, "c_gbits", I32, (M, Wg)),
                         (state.c_pool, "c_pool", I32, (M,)), (state.c_cum, "c_cum", I32, (M, R)),
                         (state.used, "used", I32, ())):
        _check(t, n, dt, sh)
    out = torch.empty((pack_words(Sp, Ep, M, T, Wg, R),), dtype=I32, device=take_e.device)
    ptrs = [take_e, take_c, leftover, state.c_mask, state.c_zc_bits, state.c_gbits,
            state.c_pool, state.c_cum, state.used, out]
    rc = load().pack_outputs_launch(_ptrs(ptrs), len(ptrs), _ints([Sp, Ep, M, T, Wg, R]),
                                    _stream())
    _raise_on(rc, "pack_outputs")
    LAUNCHES["pack_outputs"] += 1
    return out


# --- public entry points: CUDA tensor -> kernel, CPU tensor -> plain ---------


def ffd_solve(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """FFD scan over ARG_SPEC positional tensors; `zone_engine` enables the
    zoned branch (the caller passes V > 0, as the JAX backend does)."""
    if args[0].is_cuda:
        return _ffd_solve_cuda(*args, max_claims=max_claims, zone_engine=zone_engine)
    return ffd_solve_plain(*args, max_claims=max_claims, zone_engine=zone_engine)


def ffd_solve_ladder(run_ladder, *args, max_claims: int, zone_engine: bool = False) -> LadderOutput:
    """Relax-ladder scan: `run_ladder` [S, Lw] int32 (rung groups per run,
    -1 padded) leads, then the ARG_SPEC tensors (see ffd_solve_ladder_plain
    for the cascade)."""
    if args[0].is_cuda:
        return _ffd_solve_ladder_cuda(run_ladder, *args, max_claims=max_claims,
                                      zone_engine=zone_engine)
    return ffd_solve_ladder_plain(run_ladder, *args, max_claims=max_claims,
                                  zone_engine=zone_engine)


def _check_ring_args(ckpt_every: int, n_ckpt: int):
    if ckpt_every < 1 or n_ckpt < 1:
        raise ValueError(f"ckpt_every={ckpt_every} and n_ckpt={n_ckpt} must be >= 1")


def ffd_solve_ckpt(*args, max_claims: int, zone_engine: bool = False,
                   ckpt_every: int = 16, n_ckpt: int = 4):
    """The FFD scan that also harvests a device-resident checkpoint ring:
    (FFDOutput, CheckpointRing)."""
    _check_ring_args(ckpt_every, n_ckpt)
    if args[0].is_cuda:
        return _ffd_scan_ckpt_cuda(None, *args, max_claims=max_claims, zone_engine=zone_engine,
                                   ckpt_every=ckpt_every, n_ckpt=n_ckpt)
    return ffd_solve_ckpt_plain(*args, max_claims=max_claims, zone_engine=zone_engine,
                                ckpt_every=ckpt_every, n_ckpt=n_ckpt)


def ffd_resume(init_state: FFDState, *args, max_claims: int, zone_engine: bool = False,
               ckpt_every: int = 16, n_ckpt: int = 4):
    """Replay only a run suffix on top of checkpoint `init_state` (left
    untouched): `args` carries the suffix run arrays. Returns (FFDOutput
    of the suffix, a fresh suffix-relative CheckpointRing)."""
    _check_ring_args(ckpt_every, n_ckpt)
    if args[0].is_cuda:
        return _ffd_scan_ckpt_cuda(init_state, *args, max_claims=max_claims,
                                   zone_engine=zone_engine, ckpt_every=ckpt_every,
                                   n_ckpt=n_ckpt)
    return ffd_resume_plain(init_state, *args, max_claims=max_claims, zone_engine=zone_engine,
                            ckpt_every=ckpt_every, n_ckpt=n_ckpt)


def ffd_solve_sparse(run_q_idx, run_v_idx, *args, max_claims: int,
                     zone_engine: bool = False) -> FFDOutput:
    """ffd_solve with the fast branch's Q/V-axis state read through the
    run-major index tables (SPARSE_ARG_SPEC) that lead the arguments."""
    if args[0].is_cuda:
        return _ffd_solve_cuda(*args, max_claims=max_claims, zone_engine=zone_engine,
                               sparse=(run_q_idx, run_v_idx))
    return ffd_solve_sparse_plain(run_q_idx, run_v_idx, *args, max_claims=max_claims,
                                  zone_engine=zone_engine)


def ffd_solve_ckpt_sparse(run_q_idx, run_v_idx, *args, max_claims: int,
                          zone_engine: bool = False, ckpt_every: int = 16, n_ckpt: int = 4):
    """ffd_solve_ckpt through the index tables: (FFDOutput, CheckpointRing);
    the ring resumes through either resume."""
    _check_ring_args(ckpt_every, n_ckpt)
    if args[0].is_cuda:
        return _ffd_scan_ckpt_cuda(None, *args, max_claims=max_claims, zone_engine=zone_engine,
                                   ckpt_every=ckpt_every, n_ckpt=n_ckpt,
                                   sparse=(run_q_idx, run_v_idx))
    return ffd_solve_ckpt_sparse_plain(run_q_idx, run_v_idx, *args, max_claims=max_claims,
                                       zone_engine=zone_engine, ckpt_every=ckpt_every,
                                       n_ckpt=n_ckpt)


def ffd_resume_sparse(init_state: FFDState, run_q_idx, run_v_idx, *args, max_claims: int,
                      zone_engine: bool = False, ckpt_every: int = 16, n_ckpt: int = 4):
    """ffd_resume through the index tables (the suffix's rows); `init_state`
    (a dense or a sparse scan's checkpoint) is left untouched."""
    _check_ring_args(ckpt_every, n_ckpt)
    if args[0].is_cuda:
        return _ffd_scan_ckpt_cuda(init_state, *args, max_claims=max_claims,
                                   zone_engine=zone_engine, ckpt_every=ckpt_every,
                                   n_ckpt=n_ckpt, sparse=(run_q_idx, run_v_idx))
    return ffd_resume_sparse_plain(init_state, run_q_idx, run_v_idx, *args,
                                   max_claims=max_claims, zone_engine=zone_engine,
                                   ckpt_every=ckpt_every, n_ckpt=n_ckpt)


def ffd_solve_ladder_sparse(run_ladder, run_q_idx, run_v_idx, *args, max_claims: int,
                            zone_engine: bool = False) -> LadderOutput:
    """The relax-ladder scan through index tables whose rows are the union
    over each run's base and rung groups."""
    if args[0].is_cuda:
        return _ffd_solve_ladder_cuda(run_ladder, *args, max_claims=max_claims,
                                      zone_engine=zone_engine, sparse=(run_q_idx, run_v_idx))
    return ffd_solve_ladder_sparse_plain(run_ladder, run_q_idx, run_v_idx, *args,
                                         max_claims=max_claims, zone_engine=zone_engine)


def compact_takes(take_e, take_c, cap: int):
    """K2's part of the delta pack on its own: the plain version on the
    CPU; on the card it runs only inside pack_delta."""
    if take_e.is_cuda:
        raise ValueError("compact_takes: on the card the takes are packed by pack_delta")
    return compact_takes_plain(take_e, take_c, cap)


def compact_claim_meta(c_mask, c_zc_bits, c_gbits, c_pool, cap_u: int):
    """K3's part of the delta pack on its own: the plain version on the
    CPU; on the card it runs only inside pack_delta."""
    if c_mask.is_cuda:
        raise ValueError("compact_claim_meta: on the card the claim rows are packed by pack_delta")
    return compact_claim_meta_plain(c_mask, c_zc_bits, c_gbits, c_pool, cap_u)


def pack_delta(take_e, take_c, leftover, state: FFDState, cap: int, cap_u: int) -> torch.Tensor:
    """The delta pack: the claim-delta fetch buffer (see pack_delta_plain)."""
    if take_e.is_cuda:
        return _pack_delta_cuda(take_e, take_c, leftover, state, cap, cap_u)
    return pack_delta_plain(take_e, take_c, leftover, state, cap, cap_u)


def pack_mask_words(c_mask) -> torch.Tensor:
    """[M, T] bool -> [M, ceil(T/32)] int32 words (pack_mask_words_plain)."""
    if c_mask.is_cuda:
        return _mask_words_cuda(c_mask)
    return pack_mask_words_plain(c_mask)


def pack_outputs(take_e, take_c, leftover, state: FFDState) -> torch.Tensor:
    """The dense output pack (see pack_outputs_plain)."""
    if take_e.is_cuda:
        return _pack_outputs_cuda(take_e, take_c, leftover, state)
    return pack_outputs_plain(take_e, take_c, leftover, state)


# --- the lane-batched scan (K15) and the streaming run-table scatter (K14) ----


def _stack_lanes(lanes) -> FFDOutput:
    """Per-lane FFDOutputs -> one FFDOutput, every field on a leading lane axis."""
    st = FFDState(*(torch.stack([ln.state[f] for ln in lanes])
                    for f in range(len(FFDState._fields))))
    return FFDOutput(take_e=torch.stack([ln.take_e for ln in lanes]),
                     take_c=torch.stack([ln.take_c for ln in lanes]),
                     leftover=torch.stack([ln.leftover for ln in lanes]),
                     state=st, events=torch.stack([ln.events for ln in lanes]))


def ffd_solve_lanes_plain(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """Plain version of the JAX `jax.vmap(ffd_solve)` over a leading lane
    axis (parallel/sharded.py batched_solve): ffd_solve_plain on each lane
    of the [B, ...] ARG_SPEC tensors, every FFDOutput field stacked on a
    leading [B] axis."""
    B = int(args[0].shape[0])
    return _stack_lanes([ffd_solve_plain(*(a[b] for a in args), max_claims=max_claims,
                                         zone_engine=zone_engine) for b in range(B)])


def _lane_counts(ptrs, B: int, shared) -> list:
    """The launcher's per-lane element counts of `ptrs` (lane-major
    [B, ...] tensors), two ints each (low, high 32 bits); a tensor in
    `shared` (by identity) is read by every lane: count 0."""
    dims = []
    for t in ptrs:
        per = 0 if any(t is x for x in shared) else t.numel() // B
        dims += [_u32_scalar(per), per >> 32]
    return dims


def _ffd_solve_lanes_cuda(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """K15: one launch, one thread-block cluster a lane (its size chosen by
    the launcher, lanes_cluster), each cluster K1's scan on its lane. The
    per-lane element counts of every array ride in the launch's parameters
    (csrc/ffd_kernels.cu LaneStrides); nothing is uploaded. A lane's
    scratch is a cluster scan's (cluster_scratch_words)."""
    from .build import load

    B = int(args[0].shape[0])
    M = int(max_claims)
    name = f"ffd_lanes_{'zoned' if zone_engine else 'fast'}_scan"
    for n, t in zip(ARG_SPEC, args):
        if t.dim() < 1 or int(t.shape[0]) != B or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous [{B}, ...] lane batch")
    a0 = {n: t[0] for n, t in zip(ARG_SPEC, args)}
    Sp, G, T, E, P, R, Q, W, V, Z = _check_scan_args(a0, zone_engine, name)
    a = dict(zip(ARG_SPEC, args))
    st = _state0(args, M)
    dev = a["node_free"].device
    take_e = torch.empty((B, Sp, E), dtype=I32, device=dev)
    take_c = torch.empty((B, Sp, M), dtype=I32, device=dev)
    leftover = torch.empty((B, Sp), dtype=I32, device=dev)
    events = torch.zeros((B,), dtype=I32, device=dev)
    scratch = torch.empty((B, cluster_scratch_words(E, M, T, Z)), dtype=I32, device=dev)
    ptrs = [a[n] for n in _SCAN_INPUTS] + list(st) + [take_e, take_c, leftover, events, scratch]
    dims = [Sp, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine), B] + _lane_counts(ptrs, B, ())
    rc = load("ffd_lanes_kernels").ffd_lanes_launch(_ptrs(ptrs), len(ptrs), _ints(dims),
                                                    _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st, events=events)


def output_lane(out: FFDOutput, b: int) -> FFDOutput:
    """Lane b of a lane-batched FFDOutput (views, no copy)."""
    return FFDOutput(take_e=out.take_e[b], take_c=out.take_c[b], leftover=out.leftover[b],
                     state=FFDState(*(f[b] for f in out.state)), events=out.events[b])


def ffd_solve_lanes(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """The FFD scan of every lane of [B, ...] ARG_SPEC tensors, outputs
    with a leading [B] axis: K15 for CUDA tensors, the plain version for
    CPU ones."""
    if args[0].is_cuda:
        return _ffd_solve_lanes_cuda(*args, max_claims=max_claims, zone_engine=zone_engine)
    return ffd_solve_lanes_plain(*args, max_claims=max_claims, zone_engine=zone_engine)


# --- the lanes of a mesh-sharded solve (K17, K17s) -------------------------


def ffd_solve_sharded_plain(run_group, run_count, *shared, max_claims: int,
                            zone_engine: bool = False, sparse=None) -> FFDOutput:
    """Plain version of the JAX `ffd_solve_sharded` (and, with `sparse` =
    (run_q_idx [Nd, Sblk, Kq], run_v_idx [Nd, Sblk, Kv]), of
    `ffd_solve_sharded_sparse`): the step-by-step counterpart of its vmap.
    Lane d is ffd_solve_plain (its sparse form) over run block d
    (run_group[d], run_count[d]) from the initial carry, the other 34
    ARG_SPEC tables shared; every FFDOutput field gains a leading [Nd]
    axis, and each lane numbers its claim slots from 0."""
    lanes = []
    for d in range(int(run_group.shape[0])):
        args = (run_group[d], run_count[d]) + tuple(shared)
        sp = None if sparse is None else (sparse[0][d], sparse[1][d])
        lanes.append(_scan_plain(args, _state0(args, max_claims), max_claims, zone_engine,
                                 sparse=sp)[0])
    return _stack_lanes(lanes)


def _ffd_solve_sharded_cuda(run_group, run_count, *shared, max_claims: int,
                            zone_engine: bool = False, sparse=None) -> FFDOutput:
    """K17 (K15's ffd_lanes_kernel, one thread-block cluster per run block),
    or with `sparse` K17s (ffd_lanes_sparse_kernel): one launch over the Nd
    blocks on the tensors' device. Only the run arrays (and the index
    tables), the carry, the outputs and the scratch (a cluster scan's a
    lane) step per lane; every shared table goes at a per-lane count of 0.
    The carry is seeded per lane from the shared tables, as K1's is."""
    from .build import load

    B, Sblk = (int(x) for x in run_group.shape)
    M = int(max_claims)
    name = f"ffd_sharded_{'sparse_' if sparse is not None else ''}{'zoned' if zone_engine else 'fast'}_scan"
    _check(run_group, "run_group", I32, (B, Sblk))
    _check(run_count, "run_count", I32, (B, Sblk))
    lane0 = (run_group[0], run_count[0]) + tuple(shared)
    Sp, G, T, E, P, R, Q, W, V, Z = _check_scan_args(dict(zip(ARG_SPEC, lane0)), zone_engine, name)
    idx, kdims = [], []
    if sparse is not None:
        _check_sparse((sparse[0][0], sparse[1][0]), Sblk, name, Q, V, zone_engine)
        idx = list(sparse)
        kdims = [int(sparse[0].shape[2]), int(sparse[1].shape[2])]
        for t, n, k in zip(idx, ("run_q_idx", "run_v_idx"), kdims):
            _check(t, n, I32, (B, Sblk, k))
    a = dict(zip(ARG_SPEC, (run_group, run_count) + tuple(shared)))
    st = FFDState(*(f.unsqueeze(0).expand((B,) + tuple(f.shape)).contiguous()
                    for f in _state0(lane0, M)))
    dev = run_group.device
    take_e = torch.empty((B, Sblk, E), dtype=I32, device=dev)
    take_c = torch.empty((B, Sblk, M), dtype=I32, device=dev)
    leftover = torch.empty((B, Sblk), dtype=I32, device=dev)
    events = torch.zeros((B,), dtype=I32, device=dev)
    scratch = torch.empty((B, cluster_scratch_words(E, M, T, Z)), dtype=I32, device=dev)
    ptrs = ([a[n] for n in _SCAN_INPUTS] + list(st)
            + [take_e, take_c, leftover, events, scratch] + idx)
    dims = ([Sblk, G, T, E, P, R, Q, W, M, V, Z, int(zone_engine), B]
            + _lane_counts(ptrs, B, shared) + kdims)
    if sparse is not None:
        launch = load("ffd_lanes_sparse_kernels").ffd_lanes_sparse_launch
    else:
        launch = load("ffd_lanes_kernels").ffd_lanes_launch
    rc = launch(_ptrs(ptrs), len(ptrs), _ints(dims), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st, events=events)


def ffd_solve_sharded(run_group, run_count, *shared, max_claims: int,
                      zone_engine: bool = False) -> FFDOutput:
    """Block-local FFD scans over the [Nd, Sblk] run blocks of one solve
    (parallel/sharded.py mesh_run_blocks; ARG_SPEC order, only the two run
    arrays blocked), each from the initial carry: lane d equals ffd_solve
    over block d alone. K17 for CUDA tensors (one launch), the plain
    version for CPU ones. The host stitch (backend._shard_stitch) turns the
    lanes into the sequential result."""
    if run_group.is_cuda:
        return _ffd_solve_sharded_cuda(run_group, run_count, *shared, max_claims=max_claims,
                                       zone_engine=zone_engine)
    return ffd_solve_sharded_plain(run_group, run_count, *shared, max_claims=max_claims,
                                   zone_engine=zone_engine)


def ffd_solve_sharded_sparse(run_q_idx, run_v_idx, run_group, run_count, *shared,
                             max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """ffd_solve_sharded through the index tables, blocked like the runs
    ([Nd, Sblk, Kq] / [Nd, Sblk, Kv]): K17s for CUDA tensors, the plain
    version for CPU ones."""
    if run_group.is_cuda:
        return _ffd_solve_sharded_cuda(run_group, run_count, *shared, max_claims=max_claims,
                                       zone_engine=zone_engine, sparse=(run_q_idx, run_v_idx))
    return ffd_solve_sharded_plain(run_group, run_count, *shared, max_claims=max_claims,
                                   zone_engine=zone_engine, sparse=(run_q_idx, run_v_idx))


def _event_rows(events, device) -> torch.Tensor:
    """The [K, 3] edit rows as an int32 tensor on `device` (a host numpy
    array, as arena.apply_run_events holds them, or a tensor)."""
    if not isinstance(events, torch.Tensor):
        events = torch.from_numpy(np.ascontiguousarray(events, dtype=np.int32))
    return events.to(device=device, dtype=I32)


def ffd_apply_events_plain(run_group, run_count, events):
    """Plain version of the JAX `ffd_apply_events`: the [K, 3] (pos, gid,
    cnt) rows (a tensor or a host numpy array) scattered into a copy of the
    [Sp] run tables, rows whose pos lies outside [0, Sp) (EVENT_PAD_POS
    padding included) dropped, as the JAX docstring says (its scatter wraps
    a negative position as a NumPy index first: ROADMAP §C.9). Returns the
    new (run_group, run_count) as the two rows of one [2, Sp] tensor, as K14
    does; the inputs are not written."""
    out = torch.stack([run_group, run_count])
    ev = _event_rows(events, out.device)
    pos = ev[:, 0].long()
    keep = (pos >= 0) & (pos < out.shape[1])
    out[0, pos[keep]] = ev[keep, 1].to(out.dtype)
    out[1, pos[keep]] = ev[keep, 2].to(out.dtype)
    return out[0], out[1]


def event_param_table(Sp: int, host_ev: np.ndarray) -> np.ndarray:
    """apply_events_launch's int table for host rows: Sp, K, then the K
    (pos, gid, cnt) rows back to back, which the launcher copies into the
    kernel's parameters (at most EVENT_PARAM_ROWS rows)."""
    K = int(host_ev.shape[0])
    if K > EVENT_PARAM_ROWS:
        raise ValueError(f"apply_events: {K} host rows past the parameter table's "
                         f"{EVENT_PARAM_ROWS}")
    dims = np.empty((2 + EVENT_ENTRY_WORDS * K,), dtype=np.int32)
    dims[0], dims[1] = Sp, K
    dims[2:] = host_ev.reshape(-1)
    return dims


def _events_launch_args(run_group, run_count, out, host_ev, dev_ev) -> tuple:
    """apply_events_launch's arguments: the pair, the [2, Sp] result and the
    rows on the card (dev_ev), or null and the host rows `host_ev` in the
    int table (event_param_table): the launch carries them."""
    Sp = int(run_group.shape[0])
    ptrs = (ctypes.c_void_p * 4)(run_group.data_ptr(), run_count.data_ptr(), out.data_ptr(),
                                 None if dev_ev is None else dev_ev.data_ptr())
    if dev_ev is not None:
        return ptrs, 4, _ints([Sp, dev_ev.shape[0]]), _stream()
    dims = event_param_table(Sp, host_ev)
    return ptrs, 4, (ctypes.c_int * dims.shape[0]).from_buffer(dims), _stream()


def _apply_events_cuda(run_group, run_count, events):
    """K14 (csrc/arena_kernels.cu): one launch into one [2, Sp] allocation,
    returned as its two rows. Host rows (a numpy array or a CPU tensor) up
    to EVENT_PARAM_ROWS ride in the launch's parameters; more are copied to
    the card first; rows already on the card are read there."""
    from .build import load

    Sp = int(run_group.shape[0]) if run_group.dim() == 1 else -1
    _check(run_group, "run_group", I32, (Sp,))
    _check(run_count, "run_count", I32, (Sp,))
    host_ev = dev_ev = None
    if isinstance(events, torch.Tensor) and events.is_cuda:
        _check(events, "events", I32)
        dev_ev = events
    else:
        host_ev = events.numpy() if isinstance(events, torch.Tensor) else np.asarray(events)
        if host_ev.dtype != np.int32:
            raise ValueError(f"events: expected int32, got {host_ev.dtype}")
        host_ev = np.ascontiguousarray(host_ev)
    shape = tuple((dev_ev if dev_ev is not None else host_ev).shape)
    if len(shape) != 2 or shape[1] != EVENT_ENTRY_WORDS:
        raise ValueError(f"apply_events: events must be [K, {EVENT_ENTRY_WORDS}], got {shape}")
    if host_ev is not None and shape[0] > EVENT_PARAM_ROWS:
        dev_ev, host_ev = torch.from_numpy(host_ev).to(run_group.device), None
    out = torch.empty((2, Sp), dtype=I32, device=run_group.device)
    rc_ = load("arena_kernels").apply_events_launch(
        *_events_launch_args(run_group, run_count, out, host_ev, dev_ev))
    _raise_on(rc_, "apply_events")
    LAUNCHES["apply_events"] += 1
    return out[0], out[1]


def ffd_apply_events(run_group, run_count, events):
    """Scatter an event batch (a tensor, or host numpy rows) into the
    resident run tables (ARG_SPEC entries 0 and 1): K14 for CUDA tensors,
    the plain version for CPU ones. Returns the edited pair as the two rows
    of one new [2, Sp] tensor; the caller swaps the arena's resident tensors
    for them."""
    if run_group.is_cuda:
        return _apply_events_cuda(run_group, run_count, events)
    return ffd_apply_events_plain(run_group, run_count, events)


# --- scheduling classes: the gang verdict and the preemption plan (K10, K11) --
#
# Eviction-table wire format (the JAX ffd.py:2934-2948): a header
# [overflow, entry_count] then (node_idx, victim_idx) as two uint16 words per
# entry; an index past uint16 sets the overflow flag and packs no rows (the
# class pass then declines). The JAX module's GangStage carry is a layout
# note its orchestrator never builds, so it has no counterpart here.
EVICT_HEADER_WORDS = 2
EVICT_ENTRY_U16 = 2


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap (XLA's int32 sums)."""
    return _i32_bits(x & 0xFFFFFFFF)


def gang_commit_plain(run_placed, run_gang, gang_size, gang_min_ranks):
    """Plain version of the JAX `gang_commit` (ffd.py:2953): per-gang placed
    counts by segment sum over the runs (gangs outside [0, NG) count
    nowhere: JAX parks negative gangs in slot NG and drops indices past
    it), committed iff placed >= min_ranks > 0. Returns (commit [NG] bool,
    placed [NG] int32)."""
    ng = int(gang_size.shape[0])
    hot = (run_gang >= 0) & (run_gang < ng)
    placed = torch.zeros(ng, dtype=torch.int64, device=run_placed.device)
    placed.index_add_(0, run_gang[hot].to(torch.int64), run_placed[hot].to(torch.int64))
    placed = _wrap32(placed)
    commit = (placed >= gang_min_ranks) & (gang_min_ranks > 0)
    return commit, placed


def preemption_plan_plain(node_free, victim_prio, victim_req, victim_ok, node_ok, need,
                          pod_prio: int):
    """Plain version of the JAX `preemption_plan` (ffd.py:2969): the first
    node (ascending) whose free capacity plus the cumulative reclaim of its
    eligible victims (victim_ok and priority strictly below `pod_prio`;
    victims arrive sorted by ascending (priority, uid)) covers `need`, and
    the shortest such victim prefix as a mask. int32 sums wrap, as XLA's.
    Returns (node_idx int32 scalar, -1 = no plan; take [E, Vm] bool, hot only
    on the chosen row, empty when its free capacity alone fits)."""
    E, Vm = victim_prio.shape
    dev = victim_prio.device
    eligible = victim_ok & (victim_prio < int(pod_prio))
    reclaim = torch.where(eligible[:, :, None], victim_req.to(torch.int64), 0)
    cum = _wrap32(node_free[:, None, :].to(torch.int64) + torch.cumsum(reclaim, dim=1))
    fit0 = torch.all(node_free >= need[None, :], dim=1)
    fit_at = torch.all(cum >= need[None, None, :], dim=2)
    any_fit = node_ok & (fit0 | torch.any(fit_at, dim=1))
    node_idx = _argmax_first(any_fit) if bool(any_fit.any()) else -1
    kmin = torch.argmax(fit_at.to(I32), dim=1)  # first fitting position, 0 if none
    take = (
        eligible
        & (torch.arange(Vm, device=dev)[None, :] <= kmin[:, None])
        & ~fit0[:, None]
        & (torch.arange(E, device=dev)[:, None] == node_idx)
    )
    return torch.tensor(node_idx, dtype=I32, device=dev), take


# --- the preemption walk: every candidate planned in order (K11's redesign) --
#
# The class pass plans its candidates one after another over victim tables
# that each plan updates (scheduling_class.py _plan_preemptions, the JAX
# scheduling_class.py:565-606). `preemption_walk` runs that whole loop in one
# call. Its output wire is one int32 buffer: [count, budget flag], then
# `walk_capacity` rows (candidate, node, victim) in the loop's order, -1 past
# `count`.
WALK_HEADER_WORDS = 2
WALK_ROW_WORDS = 3


class WalkOutput(NamedTuple):
    wire: torch.Tensor       # [WALK_HEADER_WORDS + WALK_ROW_WORDS * cap] int32
    node_free: torch.Tensor  # [E, R] int32: the free table after the walk
    victim_ok: torch.Tensor  # [E, Vm] bool: the eligible victims after the walk


def walk_capacity(budget: int, Vm: int, C: int) -> int:
    """Eviction rows a walk can write: a candidate starts below the budget
    and takes at most Vm victims, and C candidates at most C * Vm."""
    return max(1, min(int(budget) + Vm - 1, C * Vm))


def preemption_walk_plain(node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need,
                          prio, budget: int) -> WalkOutput:
    """Plain version of the class pass's preemption loop (the JAX
    scheduling_class.py:565-606) over tensors. For each candidate c in
    order: stop, and set the budget flag, once the evictions so far reach
    `budget` (checked at a candidate's start only); plan with
    preemption_plan_plain on the node row masks[cand_row[c]], need[c] and
    prio[c]; skip a candidate with no plan, and one whose free capacity
    alone fits (no charge); else append its victims ascending, add their
    requests to the node's free row (int32 wrap), clear their victim_ok,
    and set the row to max(free - need[c], 0). The inputs are not written.
    Shapes: node_free [E, R] i32, victim_prio [E, Vm] i32, victim_req
    [E, Vm, R] i32, victim_ok [E, Vm] bool, masks [U, E] bool, cand_row
    [C] i32, need [C, R] i32, prio [C] i32."""
    E, Vm = victim_prio.shape
    C = int(cand_row.shape[0])
    free, ok = node_free.clone(), victim_ok.clone()
    rows, flag = [], 0
    for c in range(C):
        if len(rows) >= budget:
            flag = 1
            break
        e, take = preemption_plan_plain(free, victim_prio, victim_req, ok,
                                        masks[int(cand_row[c])], need[c], int(prio[c]))
        e = int(e)
        if e < 0:
            continue
        hot = torch.nonzero(take[e]).flatten()
        if not hot.numel():
            continue  # free capacity alone fits: nothing to evict, nothing charged
        rows += [(c, e, int(v)) for v in hot]
        free[e] = _wrap32(free[e].to(torch.int64) + victim_req[e, hot].to(torch.int64).sum(0))
        ok[e, hot] = False
        free[e] = torch.clamp(free[e].to(torch.int64) - need[c].to(torch.int64), min=0).to(I32)
    wire = torch.full((WALK_HEADER_WORDS + WALK_ROW_WORDS * walk_capacity(budget, Vm, C),), -1,
                      dtype=I32, device=node_free.device)
    wire[0], wire[1] = len(rows), flag
    if rows:
        wire[WALK_HEADER_WORDS:WALK_HEADER_WORDS + WALK_ROW_WORDS * len(rows)] = torch.tensor(
            rows, dtype=I32).flatten()
    return WalkOutput(wire, free, ok)


def unpack_walk(wire):
    """A walk's wire (host int32) -> ([(candidate, node, victim), ...],
    budget flag)."""
    wire = np.asarray(wire)
    n = int(wire[0])
    body = wire[WALK_HEADER_WORDS:WALK_HEADER_WORDS + WALK_ROW_WORDS * n].reshape(n, WALK_ROW_WORDS)
    return [tuple(int(x) for x in r) for r in body], bool(wire[1])


def pack_evictions(entries):
    """Pack (node_idx, victim_idx) rows into the uint16 eviction table
    (EVICT_HEADER_WORDS, then EVICT_ENTRY_U16 words per row); an index past
    uint16 sets header[0] and packs no rows."""
    n = len(entries)
    if any(e >= 2**16 or v >= 2**16 for e, v in entries):
        return np.asarray([1, 0], dtype=np.uint16)
    buf = np.zeros(EVICT_HEADER_WORDS + EVICT_ENTRY_U16 * n, dtype=np.uint16)
    buf[1] = n
    for i, (e, v) in enumerate(entries):
        buf[EVICT_HEADER_WORDS + 2 * i] = e
        buf[EVICT_HEADER_WORDS + 2 * i + 1] = v
    return buf


def unpack_evictions(buf):
    """Inverse of pack_evictions: (overflow, [(node_idx, victim_idx), ...])."""
    buf = np.asarray(buf, dtype=np.uint16)
    n = int(buf[1])
    rows = [(int(buf[EVICT_HEADER_WORDS + 2 * i]), int(buf[EVICT_HEADER_WORDS + 2 * i + 1]))
            for i in range(n)]
    return bool(buf[0]), rows


# --- decision provenance: the explain wire (K12) ----------------------------
#
# The reason enum and its precedence (the smallest nonzero code wins) are the
# wire contract shared with obs/explain.py's REASON_NAMES. The packed int32
# buffer: a header [overflow, n_groups, top_k], then per group its rejected
# count and top_k entries e | (reason << 16), -1 for an empty slot; overflow
# (a node axis past uint16) makes the host deriver rebuild the table.
EXPLAIN_REASONS = (
    ("feasible", 0),
    ("zone", 1),
    ("capacity_type", 2),
    ("taint", 3),
    ("resources", 4),
    ("topology", 5),
    ("affinity", 6),
)
EXPLAIN_HEADER_WORDS = 3  # [overflow_flag, n_groups, top_k] i32
EXPLAIN_ENTRY_WORDS = 1   # e | (reason << 16) per rejected candidate

EXPLAIN_ARG_SPEC = (
    "take_e",       # [Sp, Ep] i32 — the scan's own output (device-resident)
    "run_group",    # [Sp] i32
    "group_req",    # [Gp, R] i32
    "node_free",    # [Ep, R] i32 (pre-solve)
    "node_compat",  # [Gp, Ep] bool (labels+taints admission)
    "node_zone",    # [Ep] i32 (-1 unknown)
    "node_ct",      # [Ep] i32 (-1 unknown)
    "group_zone",   # [Gp, Z] bool
    "group_ct",     # [Gp, C] bool
    "group_topo",   # [Gp] bool — group owns a spread engine constraint
    "group_aff",    # [Gp] bool — group owns affinity terms
    "e_count",      # i32 scalar — real node count inside the Ep padding
    "g_count",      # i32 scalar — real group count inside the Gp padding
)


def explain_words(n_groups: int, k: int) -> int:
    """Buffer length in int32 words: header + per-group (count + k entries)."""
    return EXPLAIN_HEADER_WORDS + n_groups * (1 + k * EXPLAIN_ENTRY_WORDS)


def explain_pack_plain(take_e, run_group, group_req, node_free, node_compat, node_zone,
                       node_ct, group_zone, group_ct, group_topo, group_aff, e_count,
                       g_count, *, top_k: int):
    """Plain version of the JAX `explain_pack` (ffd.py:3096): final free =
    node_free - take_e^T . group_req[run_group] (int32, wrapping); a node is
    rejected for group g iff it cannot admit and fit ONE MORE pod of g, with
    the precedence zone > capacity_type > taint > resources > topology >
    affinity, and any node g landed pods on is feasible; the first top_k
    rejected real nodes per real group, ascending, packed into one int32
    buffer (layout above). The (group, node) placed sums come from one
    index_add over the runs (every run has one group), not from a group
    one-hot product. run_group lies in [0, Gp)."""
    Sp, Ep = take_e.shape
    Gp, R = group_req.shape
    dev = take_e.device
    take64 = take_e.to(torch.int64)
    req_s = group_req[run_group.to(torch.int64)].to(torch.int64)      # [Sp, R]
    usage = (take64[:, :, None] * req_s[:, None, :]).sum(dim=0)       # [Ep, R]
    free_final = _wrap32(node_free.to(torch.int64) - usage)
    Z, C = group_zone.shape[1], group_ct.shape[1]
    zid = node_zone.clamp(0, Z - 1).to(torch.int64)
    cid = node_ct.clamp(0, C - 1).to(torch.int64)
    zone_ok = torch.where(node_zone[None, :] >= 0, group_zone[:, zid], True)
    ct_ok = torch.where(node_ct[None, :] >= 0, group_ct[:, cid], True)
    fits = torch.all(free_final[None, :, :] >= group_req[:, None, :], dim=-1)
    placed_sum = torch.zeros((Gp, Ep), dtype=torch.int64, device=dev)
    placed_sum.index_add_(0, run_group.to(torch.int64), take64)
    placed = _wrap32(placed_sum) > 0
    code = torch.where(
        ~zone_ok, 1,
        torch.where(~ct_ok, 2,
        torch.where(~node_compat, 3,
        torch.where(~fits, 4,
        torch.where(group_topo[:, None], 5,
        torch.where(group_aff[:, None], 6, 0))))))
    code = torch.where(placed, 0, code).to(I32)
    e_idx = torch.arange(Ep, dtype=I32, device=dev)
    real_e = e_idx[None, :] < int(e_count)
    real_g = torch.arange(Gp, dtype=I32, device=dev) < int(g_count)
    rej = (code > 0) & real_e & real_g[:, None]
    n_rej = rej.sum(dim=1).to(I32)
    key = torch.where(rej, e_idx[None, :], Ep)
    order = torch.sort(key, dim=1, stable=True).indices[:, :top_k]
    ent_e = torch.gather(key, 1, order)
    ent_c = torch.gather(code, 1, order)
    words = torch.where(ent_e < Ep, ent_e | (ent_c << 16), -1).to(I32)
    if words.shape[1] < top_k:  # fewer nodes than top-k: pad empty slots
        pad = torch.full((Gp, top_k - words.shape[1]), -1, dtype=I32, device=dev)
        words = torch.cat([words, pad], dim=1)
    header = torch.tensor([int(Ep > 0xFFFF), int(g_count), int(top_k)], dtype=I32, device=dev)
    rows = torch.cat([n_rej[:, None], words], dim=1)
    return torch.cat([header, rows.reshape(-1)])


def unpack_explain(flat, n_groups: int):
    """Inverse of explain_pack for the REAL group prefix: (overflow,
    n_rejected [G] i32, words [G, K] i32), numpy."""
    flat = np.asarray(flat, dtype=np.int32)
    k = int(flat[2])
    body = flat[EXPLAIN_HEADER_WORDS:].reshape(-1, 1 + k)
    return (bool(flat[0]), np.ascontiguousarray(body[:n_groups, 0]),
            np.ascontiguousarray(body[:n_groups, 1:]))


def _gang_commit_cuda(run_placed, run_gang, gang_size, gang_min_ranks):
    from .build import load

    S, NG = int(run_placed.shape[0]), int(gang_size.shape[0])
    for t, n, sh in ((run_placed, "run_placed", (S,)), (run_gang, "run_gang", (S,)),
                     (gang_size, "gang_size", (NG,)), (gang_min_ranks, "gang_min_ranks", (NG,))):
        _check(t, n, I32, sh)
    dev = run_placed.device
    commit = torch.empty((NG,), dtype=torch.bool, device=dev)
    placed = torch.empty((NG,), dtype=I32, device=dev)
    rc = load("class_kernels").gang_commit_launch(
        _ptrs([run_placed, run_gang, gang_min_ranks, commit, placed]), 5, _ints([S, NG]),
        _stream())
    _raise_on(rc, "gang_commit")
    LAUNCHES["gang_commit"] += 1
    return commit, placed


def _preemption_plan_cuda(node_free, victim_prio, victim_req, victim_ok, node_ok, need,
                          pod_prio: int):
    from .build import load

    E, Vm = victim_prio.shape
    R = int(need.shape[0])
    if E < 1 or Vm < 1 or not 1 <= R <= MAX_R:
        raise ValueError(f"preemption_plan: E={E}, Vm={Vm} must be >= 1 and R={R} in "
                         f"[1, {MAX_R}]")
    for t, n, dt, sh in ((node_free, "node_free", I32, (E, R)),
                         (victim_prio, "victim_prio", I32, (E, Vm)),
                         (victim_req, "victim_req", I32, (E, Vm, R)),
                         (victim_ok, "victim_ok", torch.bool, (E, Vm)),
                         (node_ok, "node_ok", torch.bool, (E,)), (need, "need", I32, (R,))):
        _check(t, n, dt, sh)
    dev = node_free.device
    node_idx = torch.empty((), dtype=I32, device=dev)
    take = torch.empty((E, Vm), dtype=torch.bool, device=dev)
    best = torch.empty((1,), dtype=I32, device=dev)
    rc = load("class_kernels").preemption_plan_launch(
        _ptrs([node_free, victim_prio, victim_req, victim_ok, node_ok, need, node_idx, take,
               best]), 9, _ints([E, Vm, R, pod_prio]), _stream())
    _raise_on(rc, "preemption_plan")
    LAUNCHES["preemption_plan"] += 1
    return node_idx, take


# The walk's team (csrc/class_kernels.cu walk_ctas): one block of 1 024
# threads, or a cluster of WALK_CLUSTER such CTAs; a node row a warp.
WALK_CLUSTER = 16
WALK_BLOCK_ROWS = 2048  # the most node rows one block walks (PERF.md, the walk's Step 0)


def _preemption_walk_cuda(node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need,
                          prio, budget: int, ctas: int = 0) -> WalkOutput:
    """The walk kernel on the card. `ctas` 0 takes the launcher's rule;
    1 (one block) or WALK_CLUSTER (a cluster) force the team, for the
    checks and the timing only."""
    from .build import load

    E, Vm = victim_prio.shape
    R = int(node_free.shape[1])
    U, C = int(masks.shape[0]), int(cand_row.shape[0])
    if E < 1 or Vm < 1 or not 1 <= R <= MAX_R or U < 1:
        raise ValueError(f"preemption_walk: E={E}, Vm={Vm}, U={U} must be >= 1 and R={R} in "
                         f"[1, {MAX_R}]")
    if ctas not in (0, 1, WALK_CLUSTER):
        raise ValueError(f"preemption_walk: ctas={ctas} not 0, 1 or {WALK_CLUSTER}")
    for t, n, dt, sh in ((node_free, "node_free", I32, (E, R)),
                         (victim_prio, "victim_prio", I32, (E, Vm)),
                         (victim_req, "victim_req", I32, (E, Vm, R)),
                         (victim_ok, "victim_ok", torch.bool, (E, Vm)),
                         (masks, "masks", torch.bool, (U, E)), (cand_row, "cand_row", I32, (C,)),
                         (need, "need", I32, (C, R)), (prio, "prio", I32, (C,))):
        _check(t, n, dt, sh)
    if C and bool(((cand_row < 0) | (cand_row >= U)).any()):
        raise ValueError(f"preemption_walk: cand_row outside [0, {U})")
    cap = walk_capacity(budget, Vm, C)
    dev = node_free.device
    wire = torch.empty((WALK_HEADER_WORDS + WALK_ROW_WORDS * cap,), dtype=I32, device=dev)
    free = torch.empty_like(node_free)
    ok = torch.empty_like(victim_ok)
    rc = load("class_kernels").preemption_walk_launch(
        _ptrs([node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need, prio, wire,
               free, ok]), 11, _ints([E, Vm, R, C, budget, cap, ctas]), _stream())
    _raise_on(rc, "preemption_walk")
    LAUNCHES["preemption_walk"] += 1
    return WalkOutput(wire, free, ok)


def block_barriers(n: int) -> None:
    """Launch one walk block (1 024 threads) that passes n __syncthreads
    barriers, on the current stream (timing only: the walk's serial floor
    on one block; cluster_barriers times a cluster's)."""
    from .build import load

    rc = load("class_kernels").block_barrier_launch(None, 0, _ints([n]), _stream())
    _raise_on(rc, "block_barrier")


def walk_ctas(E: int) -> int:
    """The CTAs a walk over E node rows takes (csrc/class_kernels.cu
    walk_ctas, the rule PERF.md's Step 0 chose)."""
    return 1 if E <= WALK_BLOCK_ROWS else WALK_CLUSTER


# K12's teams (csrc/class_kernels.cu explain_team): the local team (every
# CTA of 256 threads sums the take table's counted columns itself, with the
# placed counts of its own groups, so no barrier spans CTAs) while Sp * Ep is at most EXPLAIN_LOCAL_CELLS, Gp at
# most EXPLAIN_LOCAL_GROUPS and its layout (explain_local_words) fits a CTA's
# EXPLAIN_SMEM_WORDS, else one cooperative launch over the card (the
# occupancy query's CTAs at most)
EXPLAIN_LOCAL = 1
EXPLAIN_GRID = 2
EXPLAIN_LOCAL_CELLS = 16384
EXPLAIN_LOCAL_GROUPS = 256
EXPLAIN_SMEM_WORDS = 12288
EXPLAIN_TILE_GROUPS = 8  # the most groups a CTA's tile holds (its warps)
_EXPLAIN_INFO_KEYS = ("team", "grid", "threads", "ctas_per_sm", "sms", "strip_cols",
                      "strip_warps", "segments", "chunk_cols", "strips", "tiles",
                      "smem_bytes", "scratch_words", "local_words")


def explain_local_words(Sp: int, Ep: int, Gp: int, R: int) -> int:
    """The local team's shared words, its tile at EXPLAIN_TILE_GROUPS
    groups: the staged free table, node_zone, node_ct and the tile's placed
    rows over at least 32 columns (a multiple of 32), the staged run_group
    [Sp] and group_req [Gp, R]."""
    cols = max(32, -(-Ep // 32) * 32)
    return (R + 2 + EXPLAIN_TILE_GROUPS) * cols + Sp + Gp * R


def explain_team(Sp: int, Ep: int, Gp: int, R: int) -> int:
    """The team K12 takes for a [Sp, Ep] take table, Gp groups and R
    resources (the launcher's explain_team)."""
    local = (Sp * Ep <= EXPLAIN_LOCAL_CELLS and Gp <= EXPLAIN_LOCAL_GROUPS
             and explain_local_words(Sp, Ep, Gp, R) <= EXPLAIN_SMEM_WORDS)
    return EXPLAIN_LOCAL if local else EXPLAIN_GRID


def explain_teams(Sp: int, Ep: int, Gp: int, R: int) -> tuple:
    """The teams a K12 launch can be forced to at this shape: the grid
    always, the local team where its layout fits."""
    fits = explain_local_words(Sp, Ep, Gp, R) <= EXPLAIN_SMEM_WORDS
    return (EXPLAIN_LOCAL, EXPLAIN_GRID) if fits else (EXPLAIN_GRID,)


def explain_scratch_words(Sp: int, Ep: int, Gp: int, R: int) -> int:
    """K12's scratch after the wire, in int32 words: the final free table
    [R, Ep], the groups' run offsets and the sort's counters (Gp + 1 each)
    and the run ids [Sp]."""
    return R * Ep + 2 * (Gp + 1) + Sp


def explain_team_info(Sp: int, Ep: int, Gp: int, R: int, e_count: int | None = None,
                      team: int = 0) -> dict:
    """The shape of a K12 launch on the current card (csrc/class_kernels.cu
    explain_info): team, grid, CTAs a multiprocessor, the strips of the
    grid's phase A, the segments a group and the staged chunk of phase B,
    the grid's scratch and the local team's shared words."""
    from .build import load

    buf = (ctypes.c_longlong * len(_EXPLAIN_INFO_KEYS))()
    rc = load("class_kernels").explain_info(
        (ctypes.c_void_p * 1)(ctypes.addressof(buf)), 1,
        _ints([Sp, Ep, Gp, R, Ep if e_count is None else e_count, team]), None)
    _raise_on(rc, "explain_info")
    return dict(zip(_EXPLAIN_INFO_KEYS, (int(v) for v in buf)))


def _explain_pack_cuda(take_e, run_group, group_req, node_free, node_compat, node_zone,
                       node_ct, group_zone, group_ct, group_topo, group_aff, e_count,
                       g_count, *, top_k: int, team: int = 0):
    """K12 (csrc/class_kernels.cu explain_kernel): one launch; one
    allocation holds the wire and the scratch after it, and the wire is
    returned as a view. `team` 0 takes the launcher's rule (explain_team);
    EXPLAIN_LOCAL (where explain_teams holds it) or EXPLAIN_GRID force one,
    for the checks and the timing."""
    from .build import load

    Sp, Ep = take_e.shape
    Gp, R = group_req.shape
    Z, C = group_zone.shape[1], group_ct.shape[1]
    if Gp < 1 or Z < 1 or C < 1 or top_k < 1 or R > MAX_R:
        raise ValueError(f"explain_pack: Gp={Gp}, Z={Z}, C={C} and top_k={top_k} must be >= 1 "
                         f"and R={R} at most {MAX_R}")
    if team != 0 and team not in explain_teams(Sp, Ep, Gp, R):
        raise ValueError(f"explain_pack: team={team} not 0 or one of "
                         f"{explain_teams(Sp, Ep, Gp, R)} at Sp={Sp}, Ep={Ep}, Gp={Gp}, R={R}")
    for t, n, dt, sh in ((take_e, "take_e", I32, (Sp, Ep)), (run_group, "run_group", I32, (Sp,)),
                         (group_req, "group_req", I32, (Gp, R)),
                         (node_free, "node_free", I32, (Ep, R)),
                         (node_compat, "node_compat", torch.bool, (Gp, Ep)),
                         (node_zone, "node_zone", I32, (Ep,)), (node_ct, "node_ct", I32, (Ep,)),
                         (group_zone, "group_zone", torch.bool, (Gp, Z)),
                         (group_ct, "group_ct", torch.bool, (Gp, C)),
                         (group_topo, "group_topo", torch.bool, (Gp,)),
                         (group_aff, "group_aff", torch.bool, (Gp,))):
        _check(t, n, dt, sh)
    words = explain_words(Gp, top_k)
    buf = torch.empty((words + explain_scratch_words(Sp, Ep, Gp, R),), dtype=I32,
                      device=take_e.device)
    ptrs = [take_e, run_group, group_req, node_free, node_compat, node_zone, node_ct,
            group_zone, group_ct, group_topo, group_aff, buf]
    rc = load("class_kernels").explain_pack_launch(
        _ptrs(ptrs), len(ptrs), _ints([Sp, Ep, Gp, R, Z, C, top_k, e_count, g_count, team]),
        _stream())
    _raise_on(rc, "explain_pack")
    LAUNCHES["explain_pack"] += 1
    return buf[:words]


def gang_commit(run_placed, run_gang, gang_size, gang_min_ranks):
    """The atomic gang verdict (see gang_commit_plain): (commit, placed)."""
    if run_placed.is_cuda:
        return _gang_commit_cuda(run_placed, run_gang, gang_size, gang_min_ranks)
    return gang_commit_plain(run_placed, run_gang, gang_size, gang_min_ranks)


def preemption_plan(node_free, victim_prio, victim_req, victim_ok, node_ok, need,
                    pod_prio: int):
    """One planned preemption (see preemption_plan_plain): (node_idx, take)."""
    if node_free.is_cuda:
        return _preemption_plan_cuda(node_free, victim_prio, victim_req, victim_ok, node_ok,
                                     need, pod_prio)
    return preemption_plan_plain(node_free, victim_prio, victim_req, victim_ok, node_ok, need,
                                 pod_prio)


def preemption_walk(node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need, prio,
                    budget: int) -> WalkOutput:
    """Every candidate's preemption plan in order, one call (see
    preemption_walk_plain)."""
    args = (node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need, prio, budget)
    if node_free.is_cuda:
        return _preemption_walk_cuda(*args)
    return preemption_walk_plain(*args)


def explain_pack(take_e, run_group, group_req, node_free, node_compat, node_zone, node_ct,
                 group_zone, group_ct, group_topo, group_aff, e_count, g_count, *,
                 top_k: int):
    """The per-group rejection table as one int32 wire buffer (see
    explain_pack_plain)."""
    args = (take_e, run_group, group_req, node_free, node_compat, node_zone, node_ct,
            group_zone, group_ct, group_topo, group_aff, e_count, g_count)
    if take_e.is_cuda:
        return _explain_pack_cuda(*args, top_k=top_k)
    return explain_pack_plain(*args, top_k=top_k)
