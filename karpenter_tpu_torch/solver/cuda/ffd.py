"""FFD bin-packing on the GPU: the port of karpenter_tpu/solver/tpu/ffd.py.

The scan walks runs of identical pods in FFD order. Per run it pours the
run first-fit onto existing nodes, then onto open claims, then opens new
claims pool by pool in closed form (see the JAX module's docstring for the
derivation). This slice ports the FAST branch only (`zone_engine=False`):
groups without zone/capacity-type domain constraints, with hostname (Q
axis) constraints included. The zoned event engine is a later slice.

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

V-axis (zone-sig) state passes through unchanged. With no V-axis sigs
(encode's V == 0, every v_member row False) the JAX fast branch leaves it
unchanged as well, so all 16 FFDState fields compare equal.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


DELTA_HEADER_WORDS = 3  # [overflow_flag, entry_count, uniq_meta_count] i32
DELTA_ENTRY_U16 = 2  # (code, count) uint16 per entry word; code = e | E+m

# Launch counts, one per wrapper call that launches its kernel(s). A run
# that resets them and reads them after proves the path went through the
# kernels.
LAUNCHES = {"ffd_fast_scan": 0, "compact_takes": 0, "claim_meta": 0}

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
    """The scan's initial carry (cold solve)."""
    a = dict(zip(ARG_SPEC, args))
    E, R = a["node_free"].shape
    T = a["group_compat_t"].shape[1]
    W = a["group_pair_nok"].shape[1]
    Q = a["q_kind"].shape[0]
    V = a["v_kind"].shape[0]
    Z = a["zone_col_mask"].shape[0]
    dev = a["node_free"].device
    z = lambda *s: torch.zeros(s, dtype=I32, device=dev)  # noqa: E731
    return FFDState(
        e_cum=z(E, R),
        c_cum=z(M, R),
        c_mask=torch.zeros((M, T), dtype=torch.bool, device=dev),
        c_zc_bits=z(M),
        c_gbits=z(M, W),
        c_pool=torch.full((M,), -1, dtype=I32, device=dev),
        used=torch.zeros((), dtype=I32, device=dev),
        p_usage=a["pool_usage0"].to(I32).clone(),
        e_cm=a["node_q_member"].to(I32).clone(),
        e_co=a["node_q_owner"].to(I32).clone(),
        c_cm=z(M, Q),
        c_co=z(M, Q),
        v_count=a["v_count0"].to(I32).clone(),
        v_owner_z=torch.zeros((V, Z), dtype=torch.bool, device=dev),
        c_vm=z(M, V),
        c_vo=torch.zeros((M, V), dtype=torch.bool, device=dev),
    )


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


def ffd_solve_plain(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """Plain PyTorch transcription of the JAX `ffd_solve` fast branch."""
    if zone_engine:
        raise NotImplementedError("the zoned event engine is not ported yet")
    a = dict(zip(ARG_SPEC, args))
    st = _state0(args, max_claims)._asdict()
    dev = a["node_free"].device
    E, R = a["node_free"].shape
    P = a["pool_type"].shape[0]
    W = a["group_pair_nok"].shape[1]
    M = max_claims
    midx = torch.arange(M, dtype=I32, device=dev)
    eidx = torch.arange(E, dtype=I32, device=dev)
    type_alloc, type_charge = a["type_alloc"], a["type_charge"]
    offer_zc = a["offer_zc_bits"]
    kq, cq = a["q_kind"], a["q_cap"]
    zero = torch.zeros((), dtype=I32, device=dev)

    takes_e, takes_c, lefts = [], [], []
    for g, count in zip(a["run_group"].tolist(), a["run_count"].tolist()):
        if count <= 0:  # padded runs skip the body
            takes_e.append(torch.zeros((E,), dtype=I32, device=dev))
            takes_c.append(torch.zeros((M,), dtype=I32, device=dev))
            lefts.append(zero)
            continue
        req = a["group_req"][g]
        compat_t = a["group_compat_t"][g]
        g_zc = a["group_zc_bits"][g]
        gpool = a["group_pool"][g]
        g_nok = a["group_pair_nok"][g]
        m_g = a["q_member"][g]
        o_g = a["q_owner"][g]
        gword = _gbit_word(g, W, dev)
        remaining = torch.where(
            a["group_device"][g], torch.tensor(count, dtype=I32, device=dev), zero
        )
        m_g_i = m_g.to(I32)
        owner_nb = o_g & (kq != 2)
        anti_o = o_g & (kq == 1)

        fresh_allow = _hostname_allowance(
            torch.zeros((1, kq.shape[0]), dtype=I32, device=dev),
            torch.zeros((1, kq.shape[0]), dtype=I32, device=dev),
            kq, cq, m_g, owner_nb,
        )[0]
        owned2 = o_g & (kq == 2)
        tot_m_q = (st["e_cm"].sum(0) + st["c_cm"].sum(0)).to(I32)
        boot_ok = torch.all(~owned2 | (m_g & (tot_m_q == 0)))
        boot2 = torch.any(owned2) & boot_ok

        # ---- 1. existing nodes --------------------------------------------
        e_base = _fit_count(a["node_free"], st["e_cum"], req)
        e_base = torch.where(a["node_compat"][g], e_base, 0).to(I32)
        e_allow_nb = _hostname_allowance(st["e_cm"], st["e_co"], kq, cq, m_g, owner_nb)
        e_pos = _pos_cap(st["e_cm"], owned2)
        e_cap_full = torch.minimum(e_base, torch.minimum(e_allow_nb, e_pos))
        e_cap_boot = torch.minimum(e_base, e_allow_nb)
        has_e_boot = torch.any(e_cap_boot > 0)
        e_first = torch.argmax((e_cap_boot > 0).to(I32))
        e_cap = torch.where(
            boot2, torch.where(eidx == e_first, e_cap_boot, 0).to(I32), e_cap_full
        )
        take_e, remaining = _pour(e_cap, remaining)
        st["e_cum"] = st["e_cum"] + take_e[:, None] * req[None, :]
        st["e_cm"] = st["e_cm"] + take_e[:, None] * m_g_i[None, :]
        st["e_co"] = st["e_co"] + ((take_e[:, None] > 0) & anti_o[None, :]).to(I32)

        # ---- 2. open claims -----------------------------------------------
        A_bits = offer_zc & g_zc  # [T]
        ok_off = (st["c_zc_bits"][:, None] & A_bits[None, :]) != 0  # [M, T]
        pair_ok = ~torch.any((st["c_gbits"] & g_nok[None, :]) != 0, dim=1)
        is_open = st["c_pool"] >= 0
        pool_ok = torch.where(
            is_open, gpool[torch.clamp(st["c_pool"], 0, P - 1).long()], False
        )
        k_nt = _fit_count_nt(type_alloc, st["c_cum"], req)
        fit_nt = st["c_mask"] & compat_t[None, :] & ok_off
        node_ok = is_open & pair_ok & pool_ok
        k_nt = torch.where(fit_nt & node_ok[:, None], k_nt, 0).to(I32)
        c_base = k_nt.max(dim=1).values
        c_allow_nb = _hostname_allowance(st["c_cm"], st["c_co"], kq, cq, m_g, owner_nb)
        c_pos = _pos_cap(st["c_cm"], owned2)
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
        st["c_gbits"] = st["c_gbits"] | torch.where(added[:, None], gword[None, :], 0)
        st["c_cm"] = st["c_cm"] + take_c[:, None] * m_g_i[None, :]
        st["c_co"] = st["c_co"] + (added[:, None] & anti_o[None, :]).to(I32)

        # ---- 3. new claims, pool by pool in priority order -----------------
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
            full_take = torch.minimum(kmax, fresh_allow)

            one_set = fit_t & (k_t >= 1)
            charge_one = torch.where(one_set[:, None], type_charge, INT32_MAX).min(dim=0).values
            charge_one = torch.where(charge_one == INT32_MAX, 0, charge_one).to(I32)
            headroom = a["pool_limit"][p] - st["p_usage"][p]
            trips = torch.where(
                charge_one > 0,
                torch.clamp(-_floordiv(-headroom, torch.clamp(charge_one, min=1)), min=0),
                BIG,
            ).to(I32)
            already_over = torch.any(st["p_usage"][p] >= a["pool_limit"][p])
            allow = torch.where(already_over, 0, trips.min()).to(I32)

            n_want = torch.where(
                full_take > 0, -_floordiv(-remaining, torch.clamp(full_take, min=1)), 0
            ).to(I32)
            slots_left = M - used
            n_new = torch.minimum(torch.minimum(n_want, allow), slots_left).to(I32)
            n_new = torch.minimum(n_new, cap2)
            eligible = a["group_pool"][g][p] & (full_take > 0)
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
            st["c_gbits"] = torch.where(is_new[:, None], gword[None, :], st["c_gbits"])
            st["c_pool"] = torch.where(is_new, p, st["c_pool"]).to(I32)
            st["c_cm"] = torch.where(
                is_new[:, None], take_j[:, None] * m_g_i[None, :], st["c_cm"]
            )
            st["c_co"] = torch.where(
                is_new[:, None],
                ((take_j[:, None] > 0) & anti_o[None, :]).to(I32),
                st["c_co"],
            )
            p_usage = st["p_usage"].clone()
            p_usage[p] = p_usage[p] + charge_one * n_new
            st["p_usage"] = p_usage
            take_new = take_new + take_j
            remaining = (remaining - take_j.sum().to(I32)).to(I32)
            used = (used + n_new).to(I32)
            cap2 = (cap2 - n_new).to(I32)
        st["used"] = used
        takes_e.append(take_e)
        takes_c.append(take_c + take_new)
        lefts.append(remaining)

    return FFDOutput(
        take_e=torch.stack(takes_e),
        take_c=torch.stack(takes_c),
        leftover=torch.stack(lefts),
        state=FFDState(**st),
    )


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


# Kernel limits (csrc/ffd_kernels.cu): per-run Q and R rows live in shared
# memory.
MAX_Q = 256
MAX_R = 16


def _ffd_solve_cuda(*args, max_claims: int) -> FFDOutput:
    from .build import load

    a = dict(zip(ARG_SPEC, args))
    Sp = a["run_group"].shape[0]
    G, T = a["group_compat_t"].shape
    E, R = a["node_free"].shape
    P = a["pool_type"].shape[0]
    Q = a["q_kind"].shape[0]
    W = a["group_pair_nok"].shape[1]
    M = int(max_claims)
    if Q > MAX_Q or R > MAX_R:
        raise ValueError(f"ffd_fast_scan: Q={Q} > {MAX_Q} or R={R} > {MAX_R}")
    shapes = {
        "run_group": (Sp,), "run_count": (Sp,), "group_req": (G, R),
        "group_compat_t": (G, T), "group_zc_bits": (G,), "group_pool": (G, P),
        "group_pair_nok": (G, W), "group_device": (G,), "type_alloc": (T, R),
        "type_charge": (T, R), "offer_zc_bits": (T,), "pool_type": (P, T),
        "pool_zc_bits": (P,), "pool_daemon": (P, R), "pool_limit": (P, R),
        "pool_usage0": (P, R), "node_free": (E, R), "node_compat": (G, E),
        "q_member": (G, Q), "q_owner": (G, Q), "q_kind": (Q,), "q_cap": (Q,),
        "node_q_member": (E, Q), "node_q_owner": (E, Q),
    }
    for n, sh in shapes.items():
        _check(a[n], n, torch.bool if ARG_DTYPES[n] == "bool" else I32, sh)
    st = _state0(args, M)
    take_e = torch.empty((Sp, E), dtype=I32, device=a["node_free"].device)
    take_c = torch.empty((Sp, M), dtype=I32, device=take_e.device)
    leftover = torch.empty((Sp,), dtype=I32, device=take_e.device)
    scratch = torch.empty((2 * E + 4 * M + 2 * T + 64,), dtype=I32, device=take_e.device)
    ptrs = [a[n] for n in (
        "run_group", "run_count", "group_req", "group_compat_t", "group_zc_bits",
        "group_pool", "group_pair_nok", "group_device", "type_alloc", "type_charge",
        "offer_zc_bits", "pool_type", "pool_zc_bits", "pool_daemon", "pool_limit",
        "node_free", "node_compat", "q_member", "q_owner", "q_kind", "q_cap",
    )] + [
        st.e_cum, st.c_cum, st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool,
        st.used, st.p_usage, st.e_cm, st.e_co, st.c_cm, st.c_co,
        take_e, take_c, leftover, scratch,
    ]
    lib = load()
    rc = lib.ffd_fast_scan_launch(
        _ptrs(ptrs), len(ptrs), _ints([Sp, G, T, E, P, R, Q, W, M]), _stream()
    )
    _raise_on(rc, "ffd_fast_scan")
    LAUNCHES["ffd_fast_scan"] += 1
    return FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover, state=st)


def _compact_takes_cuda(take_e, take_c, cap: int):
    from .build import load

    Sp, Ep = take_e.shape
    M = take_c.shape[1]
    _check(take_e, "take_e", I32)
    _check(take_c, "take_c", I32, (Sp, M))
    if Sp % 2:
        raise ValueError(f"compact_takes: Sp={Sp} must be even")
    dev = take_e.device
    hdr = torch.empty((2,), dtype=I32, device=dev)
    cnt16 = torch.empty((Sp // 2,), dtype=I32, device=dev)
    pairs = torch.empty((cap,), dtype=I32, device=dev)
    rows = torch.empty((2 * Sp,), dtype=I32, device=dev)
    rc = load().compact_takes_launch(
        _ptrs([take_e, take_c, hdr, cnt16, pairs, rows]), 6,
        _ints([Sp, Ep, M, cap]), _stream(),
    )
    _raise_on(rc, "compact_takes")
    LAUNCHES["compact_takes"] += 1
    return hdr[0], hdr[1], cnt16, pairs


def _claim_meta_cuda(c_mask, c_zc_bits, c_gbits, c_pool, cap_u: int):
    from .build import load

    M, T = c_mask.shape
    W = c_gbits.shape[1]
    _check(c_mask, "c_mask", torch.bool)
    _check(c_zc_bits, "c_zc_bits", I32, (M,))
    _check(c_gbits, "c_gbits", I32, (M, W))
    _check(c_pool, "c_pool", I32, (M,))
    if M % 2:
        raise ValueError(f"claim_meta: M={M} must be even")
    Wt = (T + 31) // 32 + 1 + W + 1
    dev = c_mask.device
    hdr = torch.empty((2,), dtype=I32, device=dev)
    uniq = torch.empty((cap_u, Wt), dtype=I32, device=dev)
    mid16 = torch.empty((M // 2,), dtype=I32, device=dev)
    meta = torch.empty((M, Wt), dtype=I32, device=dev)
    first = torch.empty((2 * M,), dtype=I32, device=dev)
    rc = load().claim_meta_launch(
        _ptrs([c_mask, c_zc_bits, c_gbits, c_pool, hdr, uniq, mid16, meta, first]), 9,
        _ints([M, T, W, cap_u]), _stream(),
    )
    _raise_on(rc, "claim_meta")
    LAUNCHES["claim_meta"] += 1
    return hdr[0], hdr[1], uniq, mid16, meta


# --- public entry points: CUDA tensor -> kernel, CPU tensor -> plain ---------


def ffd_solve(*args, max_claims: int, zone_engine: bool = False) -> FFDOutput:
    """Fast-branch FFD scan over ARG_SPEC positional tensors."""
    if zone_engine:
        raise NotImplementedError("the zoned event engine is not ported yet")
    if args[0].is_cuda:
        return _ffd_solve_cuda(*args, max_claims=max_claims)
    return ffd_solve_plain(*args, max_claims=max_claims)


def compact_takes(take_e, take_c, cap: int):
    if take_e.is_cuda:
        return _compact_takes_cuda(take_e, take_c, cap)
    return compact_takes_plain(take_e, take_c, cap)


def compact_claim_meta(c_mask, c_zc_bits, c_gbits, c_pool, cap_u: int):
    if c_mask.is_cuda:
        return _claim_meta_cuda(c_mask, c_zc_bits, c_gbits, c_pool, cap_u)
    return compact_claim_meta_plain(c_mask, c_zc_bits, c_gbits, c_pool, cap_u)
