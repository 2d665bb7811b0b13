# Port copy of karpenter_tpu/solver/encode_cache.py (the mesh-block run
# identities cut).
"""Incremental encode cache: delta-patch `_EncodeCore` instead of rebuilding.

The control loop's dominant host cost at scale is re-deriving the encode
tables every tick (solver/encode.py). The existing `_CORE_CACHE` already
serves the *identical-input* case; this layer serves the next delta class
out: the pod set CHANGED, but only within the known signature universe —
pods added to / removed from existing groups, pods bound (they drop out of
the filtered set), disruption simulations re-placing a subset that spans
the same groups. For those, every [G]/[T]/[P]-indexed table in the cached
core is reusable verbatim, because each is a pure function of

    (ordered distinct signature sequence, catalog segment of the cache key)

— the signature covers requests, selectors, affinities, tolerations,
spreads, labels, priority, and volume zones, and the catalog segment covers
pools (content + instance-type identity), daemonsets, axes, and the
preference policy. Only the run split (`run_group`/`run_count`), the pod
lists (`group_pods`), and `sorted_uids` depend on pod multiplicity, and
those are rebuilt from the vectorized FFD sort in O(pods) NumPy.

Invalidation rules (solver/SPEC.md "Encode cache"): any delta the patch
cannot express — catalog/daemonset/axes/policy change, a signature entering
or leaving the universe, a signature-order change, an intern-epoch reset —
falls back to a full `_build_core`. The patch must be SEMANTICS-INVISIBLE:
a patched core feeds `_encode_with_nodes` exactly the arrays a fresh build
would (tests/test_encode_cache.py asserts field-by-field equality).

The cluster store side of the channel is `state/cluster.py:EncodeDeltas`,
which stamps `SolverInput.state_rev`; a matching catalog revision lets the
donor scan skip the deep catalog-key compare.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# Visible counters for bench/tests: exact-key hits, successful patches,
# full rebuilds, and vault-donor adoptions (the encoder bumps these; reset
# freely between measurements).
STATS: Dict[str, int] = {
    "hits": 0, "patches": 0, "rebuilds": 0, "vault_adopts": 0,
}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


# Per-table revision tags (solver/arena.py provenance): every full
# `_build_core` stamps its core with the next value, and try_patch's
# dataclasses.replace PRESERVES the donor's stamp because every [G]/[T]/[P]
# table is shared verbatim — so (core_rev, table name) is a content-identity
# token for core-derived kernel args, and a patched encode's static tables
# provably need no re-hash and no re-upload. Monotonic, never reused.
_CORE_REV = 0


def next_core_rev() -> int:
    global _CORE_REV
    _CORE_REV += 1
    return _CORE_REV


# Tenancy (solver/tenancy.py): per-tenant core-cache NAMESPACES. Each tenant
# hits/patches/evicts inside its own dict (same _CORE_CACHE_MAX budget per
# namespace), so one tenant's churn can never evict another's hot core and a
# patch donor can never cross clusters. tenant_id=None maps to the caller's
# default dict (encode.py _CORE_CACHE) so the single-tenant path — including
# tests/bench that clear `em._CORE_CACHE` directly — is byte-identical.
_TENANT_CORE_CACHES: Dict[str, dict] = {}


def tenant_core_cache(tenant_id: Optional[str], default: dict) -> dict:
    if tenant_id is None:
        return default
    cache = _TENANT_CORE_CACHES.get(tenant_id)
    if cache is None:
        cache = _TENANT_CORE_CACHES[tenant_id] = {}
    return cache


def drop_tenant(tenant_id: str) -> None:
    """Release a removed tenant's encode namespace (TenantRegistry.remove)."""
    _TENANT_CORE_CACHES.pop(tenant_id, None)


def try_patch(key, presort, structure, core_cache, state_rev=None):
    """Scan `core_cache` for a donor core with the same catalog segment and
    the same ordered distinct-signature sequence as the new pod set; return
    a patched copy (new run split / pod lists, every derived table shared)
    or None when no delta-compatible donor exists.

    `key` is the new `_core_key` tuple — [2:4] is the deep catalog segment
    (pools, daemonsets) and [4:7] the cheap one (zones, capacity types,
    preference policy; small tuples, always compared). `state_rev` is the
    cluster delta-channel stamp (tracker identity + catalog element); an
    equal stamp prefix proves the DEEP segment's identity without the tuple
    compare — it says nothing about [4:7], which per-call options control.
    """
    from . import encode as enc

    pods_sorted, sigs, sorted_uids, interned = presort
    if not interned:
        return None  # batch-local sig ids: not comparable across solves
    group_pods, run_group, run_count, group_snums = structure
    for k2, ent2 in core_cache.items():
        core2 = ent2[1]
        if core2.sig_epoch != enc._SIG_EPOCH:
            continue  # intern table reset since the donor was built
        if core2.group_snums != group_snums:
            continue  # universe grew/shrank/reordered: not patchable
        if k2[4:7] != key[4:7]:
            continue  # zone/capacity-type universe or preference policy moved
        rev2 = ent2[3] if len(ent2) > 3 else None
        same_catalog = (
            state_rev is not None
            and rev2 is not None
            # same tracker object + same (store catalog rev, provider
            # catalog token) — proves pools_key/ds_key equality without
            # the deep compare (state/cluster.py:EncodeDeltas)
            and rev2[:2] == state_rev[:2]
        ) or k2[2:4] == key[2:4]
        if not same_catalog:
            continue
        # the donor's core_rev rides through replace() untouched — the
        # patched core's shared tables ARE the donor's, so downstream
        # provenance consumers (backend.host_kernel_args, the argument
        # arena) treat them as unchanged; only the run split / pod lists
        # (content-hashed, never revision-tagged) differ
        return dataclasses.replace(
            core2,
            group_pods=group_pods,
            run_group=run_group,
            run_count=run_count,
            sorted_uids=sorted_uids,
        )
    return None


# --- vault donors (solver/vault.py restore path) ---------------------------
#
# A vault restore cannot re-insert cores into the live cache: `_core_key`
# embeds pod/type OBJECT IDS and interned signature NUMBERS, both of which
# are process-local. Instead, restored cores park here keyed by CONTENT —
# the ordered distinct pod-signature sequence plus the catalog content
# fingerprint (encode._catalog_content_fp) and the cheap key segments — and
# the encoder consults this registry only after an exact hit AND a patch
# both miss. Adoption re-stamps the process-local fields (run split, pod
# lists, interned snums, sig epoch, core_rev) exactly like try_patch, so an
# adopted core is indistinguishable from a fresh build downstream. Content
# keying makes donors self-verifying: a donor whose pods or catalog no
# longer match simply never matches, so a stale vault can slow a restart
# but can never change a decision.

_VAULT_DONORS: Dict[tuple, object] = {}


def _donor_key(sig_seq, ds_key, zones, cts, policy, cat_fp) -> tuple:
    return (sig_seq, ds_key, zones, cts, policy, cat_fp)


def install_vault_donors(donors) -> int:
    """Install exported donor records (vault.export_encode_donors). Each is
    guarded independently — one malformed record never aborts a restore."""
    n = 0
    for d in donors or ():
        try:
            _VAULT_DONORS[_donor_key(
                d["sig_seq"], d["ds_key"], d["zones"], d["cts"],
                d["policy"], d["cat_fp"],
            )] = d["core"]
            n += 1
        except Exception:  # noqa: BLE001 — skip, don't abort the restore
            continue
    return n


def clear_vault_donors() -> None:
    _VAULT_DONORS.clear()


def adopt_vault_donor(key, structure, sig_seq, cat_fp, presort):
    """Match the current encode against the donor registry by content and
    return a fully re-stamped core, or None. Mirrors try_patch's replace()
    but additionally re-stamps group_snums/sig_epoch (interned numbers are
    process-local) and takes a FRESH core_rev — the donor's provenance
    chain died with its process, so arena consumers must treat adopted
    tables as new content."""
    donor = _VAULT_DONORS.get(
        _donor_key(sig_seq, key[3], key[4], key[5], key[6], cat_fp)
    )
    if donor is None:
        return None
    group_pods, run_group, run_count, group_snums = structure
    if donor.group_req.shape[0] != len(group_pods):
        return None  # content key collision paranoia: shapes must agree
    _pods_sorted, _sigs, sorted_uids, interned = presort
    from . import encode as enc

    return dataclasses.replace(
        donor,
        group_pods=group_pods,
        run_group=run_group,
        run_count=run_count,
        sorted_uids=sorted_uids,
        group_snums=group_snums if interned else (),
        sig_epoch=enc._SIG_EPOCH if interned else -1,
        core_rev=next_core_rev(),
    )


# Run identity for checkpoint resume (backend._plan_resume): two scan steps
# are the same step iff they have the same interned signature number (same
# pod spec — group indices alone can be renumbered by a mid-list insert),
# the same group index (the [G] tables are positional), and the same count.
# Node-table identity (the "node-table revision" leg of the prefix rule) is
# checked separately by the arena's context signature.


def run_identity(enc) -> tuple:
    """Tuple of (snum, group, count) per REAL run of `enc`, in scan order.
    () when signatures were not interned (batch-local ids are not
    comparable across solves — resume must not match on them)."""
    snums = getattr(enc, "group_snums", ())
    if not snums:
        return ()
    out = []
    for g, c in zip(enc.run_group, enc.run_count):
        g = int(g)
        c = int(c)
        if c <= 0:
            break  # runs are front-packed; padding never precedes a real run
        out.append((snums[g], g, c))
    return tuple(out)


def run_lcp(prev: tuple, cur: tuple) -> int:
    """Longest common prefix length of two run_identity() tuples."""
    n = min(len(prev), len(cur))
    k = 0
    while k < n and prev[k] == cur[k]:
        k += 1
    return k


def run_table_events(prev_rg, prev_rc, rg, rc, max_events: int = 0):
    """Diff two same-shape padded run tables into the (pos, gid, cnt) edit
    triplets of the streaming event-apply kernel (cuda/ffd.ffd_apply_events).

    Returns an int32 [K, 3] array of the positions where either table
    changed, or None when the tables' shapes differ (different shape
    bucket — a whole-array upload is the only move) or when K exceeds
    `max_events` (> 0; a near-total rewrite is cheaper shipped whole than as
    a triplet table 3x its size). K == 0 returns an empty [0, 3] array —
    the caller skips the dispatch entirely."""
    import numpy as np

    if prev_rg.shape != rg.shape or prev_rc.shape != rc.shape:
        return None
    changed = np.nonzero((prev_rg != rg) | (prev_rc != rc))[0]
    if max_events and len(changed) > max_events:
        return None
    ev = np.empty((len(changed), 3), dtype=np.int32)
    ev[:, 0] = changed
    ev[:, 1] = rg[changed]
    ev[:, 2] = rc[changed]
    return ev
