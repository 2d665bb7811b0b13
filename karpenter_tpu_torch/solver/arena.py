"""Device-resident argument arena with packed delta uploads: the port of
karpenter_tpu/solver/arena.py.

`ArgumentArena` keeps the kernel args device-resident per shape bucket.
Each solve classifies every ARG_SPEC entry as fresh or stale:

  1. provenance fast path — entries that are pure functions of the cached
     encode core carry a token from `backend.host_kernel_args` (keyed on
     `EncodedInput.core_rev`). Same token ⇒ same bytes, no hash, no upload.
  2. content digest — everything else (node/pool-usage tensors, the run
     split) is blake2b-hashed; equal digest ⇒ fresh. A token mismatch with
     an equal digest (a rebuilt core with identical tables, as the relax
     loop produces every iteration) refreshes the token and keeps the
     resident buffer.

The stale set packs into ONE contiguous uint8 host buffer at the JAX
package's offsets (entries back to back, so an odd-sized bool table leaves
the next int32 entry unaligned), crosses in ONE host→device copy, and ONE
launch of the unpack kernel (solver/cuda/arena.py) slices it into typed
views of ONE freshly allocated block (each entry at a multiple of 256
bytes). An exact encode-cache hit therefore dispatches
with ZERO uploads; a steady-state delta solve pays one packed message.
Resident tensors are never written after their unpack (the scan clones its
carry), so they are safe to reuse across dispatches, the overflow-retry
redispatch included.

A resident entry keeps its whole block alive. So that a bucket never holds
more than twice the footprint of its live entries (each entry's bytes
rounded up to the block's 256-byte alignment), an adopt whose stale
entries would leave an earlier block under half live moves that block's
survivors into the new block, as more segments of the same unpack launch
(device to device: no host byte crosses, the ledger and the eviction order
are the reference's); a streaming edit (K14), which replaces the run
tables outside any block, does the same with a launch that only moves.
`block_bytes(key)` is what a bucket's blocks hold.

`TransferLedger` counts every host→device and device→host byte per solve
(and cumulatively), so tests assert the zero-upload / single-packed-upload
invariants and equal the JAX ledger's counts on the same solves.

Residency classes besides the args: the resume donor records
(`put_checkpoint`, backend._plan_resume), the relax ladder's rung tables
(`put_ladder`, backend._ladder_arg), the sparse scans' index-table pairs
(`put_sparse`, backend._sparse_arg), the mesh-sharded solve's
block-boundary carries (`put_shard_record`, backend._plan_shard_resume)
and the streaming stage's host copies of the run tables
(`apply_run_events`, "run_host"). All die with their bucket on
`invalidate()` or eviction.

Placed buckets (a mesh-sharded solve, the consolidation universe on a
candidate mesh): `adopt(sharding=...)` takes a parallel/sharded.py
`Placement` for every entry, or a tuple of them aligned with the args. The
stale entries pack into one buffer per distinct placement; a blocked
group's bytes go to each physical device for its own slots' rows, a copied
group lands whole on each physical device (one packed copy and one unpack
launch per device and group). Each resident entry is then a tuple of
tensors aligned with the mesh's physical devices. The ledger counts the
bytes as the JAX ledger does: each stale byte once, one message per
group, a blocked group's bytes also as shard bytes.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_LEDGER_FIELDS = ("h2d_bytes", "h2d_arrays", "h2d_msgs", "d2h_bytes", "d2h_msgs",
                  "h2d_shard_bytes")


class TransferLedger:
    """Per-solve + cumulative host↔device transfer accounting.

    `begin_solve()` opens a per-solve window (`.solve`); uploads/fetches
    recorded inside it accumulate into `.total` as well. Adopt outcomes
    (exact_hit / delta_upload / full_upload) count the arena's hit classes.
    Records may come from two threads at once (the serving pipeline's
    dispatcher uploads while its decoder fetches), so every update holds a
    lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.solves = 0
        self.solve: Dict[str, int] = dict.fromkeys(_LEDGER_FIELDS, 0)
        self.total: Dict[str, int] = dict.fromkeys(_LEDGER_FIELDS, 0)
        self.outcomes: Dict[str, int] = {
            "exact_hit": 0, "delta_upload": 0, "full_upload": 0
        }

    def begin_solve(self) -> None:
        with self._lock:
            self.solves += 1
            self.solve = dict.fromkeys(_LEDGER_FIELDS, 0)

    def record_upload(self, nbytes: int, arrays: int, msgs: int = 1,
                      shard_bytes: int = 0) -> None:
        """`shard_bytes` <= `nbytes`: the part uploaded blocked over a mesh
        (each device receives only its slots' rows of those bytes; the rest
        lands whole on every device)."""
        with self._lock:
            for k, v in (("h2d_bytes", nbytes), ("h2d_arrays", arrays), ("h2d_msgs", msgs),
                         ("h2d_shard_bytes", shard_bytes)):
                self.solve[k] += v
                self.total[k] += v

    def record_fetch(self, nbytes: int, msgs: int = 1) -> None:
        with self._lock:
            for k, v in (("d2h_bytes", nbytes), ("d2h_msgs", msgs)):
                self.solve[k] += v
                self.total[k] += v

    def record_adopt(self, outcome: str) -> None:
        with self._lock:
            self.outcomes[outcome] += 1

    @property
    def upload_bytes_per_solve(self) -> float:
        return self.total["h2d_bytes"] / self.solves if self.solves else 0.0

    @property
    def arena_hit_rate(self) -> float:
        n = sum(self.outcomes.values())
        return self.outcomes["exact_hit"] / n if n else 0.0

    def shard_upload_bytes_per_device(self, n_devices: int) -> float:
        """Average host->device bytes landing on EACH device per solve under
        an n-way mesh: blocked bytes split 1/n per device, everything else
        lands whole. Equals upload_bytes_per_solve at n = 1."""
        if not self.solves:
            return 0.0
        n = max(1, int(n_devices))
        shard = self.total["h2d_shard_bytes"]
        repl = self.total["h2d_bytes"] - shard
        return (repl + shard / n) / self.solves

    def end_solve(self) -> Dict[str, int]:
        """Close the per-solve window: return its counters."""
        with self._lock:
            return dict(self.solve)


def _nbytes(obj) -> int:
    """Byte size of one residency record: arrays and tensors by .nbytes,
    containers recursively, scalars/metadata free."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    nb = getattr(obj, "nbytes", None)  # torch.Tensor
    return int(nb) if isinstance(nb, int) else 0


def _buffer_split(placement) -> int:
    """How many ways a placed group's packed bytes split (the JAX
    `_buffer_sharding`'s n_way): a blocked group on a mesh of n >= 2 slots
    sends each device only its slots' rows, n ways; a copied group lands
    whole on every device, 1. The ledger counts a split group's bytes as
    shard bytes."""
    n = placement.mesh.size
    return n if placement.blocked and n > 1 else 1


def _tensors(x) -> tuple:
    """A resident entry's tensors: the entry itself, or a placed entry's
    tensors over its mesh's physical devices."""
    return x if isinstance(x, tuple) else (x,)


def _digest(a: np.ndarray) -> bytes:
    """Content digest of a host array (shape/dtype live in the bucket key)."""
    return hashlib.blake2b(
        np.ascontiguousarray(a).tobytes(), digest_size=16
    ).digest()


class ArgumentArena:
    """Per-bucket device-resident kernel args with packed delta uploads.

    A bucket is one padded shape signature ((shape, dtype) per ARG_SPEC
    entry, plus a placement tag: the batched-consolidation universe keys
    its own buckets with one, as the JAX package does through its mesh
    sharding) — so a bucket's resident tensors are always shape-compatible
    with its dispatches. Bounded LRU (adopt re-inserts the key on every
    hit): the `max_buckets` cap and the optional `budget_bytes` byte budget
    both evict whole cold buckets — every residency class at once — via
    `_evict_bucket`.
    """

    def __init__(self, ledger: Optional[TransferLedger] = None, device="cuda",
                 max_buckets: int = 4, budget_bytes: int = 0):
        self.ledger = ledger if ledger is not None else TransferLedger()
        self.device = device
        self.max_buckets = max_buckets
        # byte budget across EVERY residency class (0 = unbounded): when the
        # accounted total exceeds it, whole cold buckets evict LRU-first —
        # the evicted bucket's next solve pays one cold packed upload
        self.budget_bytes = int(budget_bytes)
        # bucket key -> {residency class -> accounted bytes}
        self._bytes: Dict[tuple, Dict[str, int]] = {}
        # bucket key -> [device tensors per entry, (token, digest) per entry]
        self._buckets: Dict[tuple, list] = {}
        # checkpoint residency class (backend._plan_resume): the bucket's
        # newest solve's scan checkpoints; keyed on the SAME bucket key as
        # the resident args, so a checkpoint is only offered to a dispatch
        # whose shapes match the solve that produced it
        self._ckpts: Dict[tuple, list] = {}
        self.max_ckpts_per_bucket = 1
        # relax-ladder residency class (backend._ladder_arg): per-bucket
        # device-resident run_ladder tables, keyed on content digest
        self._ladders: Dict[tuple, Tuple[bytes, object]] = {}
        # sparse-constraint residency class (backend._sparse_arg): per-
        # bucket device-resident run_q_idx/run_v_idx pairs, keyed on a token
        # of the encode core rev plus the content digests, so a re-encoded
        # fleet whose constraint layout is unchanged reuses the tables with
        # zero upload
        self._sparse: Dict[tuple, Tuple[bytes, object]] = {}
        # mesh-sharded residency class (backend._record_shard): per bucket,
        # the newest sharded solve's block-boundary carries and stitched
        # rows (host-side), the donor of a shard resume
        self._shards: Dict[tuple, dict] = {}
        # streaming run-table residency (apply_run_events): host copies (+
        # digests) of the run_group/run_count pair the bucket's device
        # tensors currently hold, so the NEXT solve can diff against them
        # and ship only (pos, gid, cnt) edit triplets; accounted as
        # "run_host", dropped by invalidate() and eviction
        self._run_host: Dict[tuple, tuple] = {}
        # the unpack blocks (solver/cuda/arena.py unpack_block) behind the
        # resident entries: per bucket, each entry's block ids (one per
        # tensor of the entry; None for a tensor outside any block, as K14's
        # run tables), and each live block's size in bytes
        self._homes: Dict[tuple, list] = {}
        self._blocks: Dict[tuple, Dict[int, int]] = {}
        self._block_ids = 0
        # ARG_SPEC indices the LAST adopt uploaded (() on an exact hit)
        self.last_stale: tuple = ()
        self.stats: Dict[str, int] = {
            "adopts": 0, "exact_hits": 0, "delta_uploads": 0,
            "full_uploads": 0, "invalidations": 0,
            "event_batches": 0, "event_edits": 0, "evictions": 0,
            # survivors of earlier blocks moved into a new one, and the
            # unpack launches that moved any
            "moved_segments": 0, "compactions": 0,
        }

    def invalidate(self) -> None:
        """Drop every resident tensor + tag (on every device of a placed
        bucket) AND the checkpoints, ladder tables, sparse index tables and
        shard records. Safe to call any time: the next adopt pays one full
        packed upload and the next solve runs cold."""
        self._buckets.clear()
        self._ckpts.clear()
        self._ladders.clear()
        self._sparse.clear()
        self._shards.clear()
        self._run_host.clear()
        self._homes.clear()
        self._blocks.clear()
        self._bytes.clear()
        self.last_stale = ()
        self.stats["invalidations"] += 1

    # -- byte accounting + budgeted eviction ---------------------------------

    def total_bytes(self) -> int:
        return sum(sum(cls.values()) for cls in self._bytes.values())

    def _account(self, key: tuple, cls: str, nbytes: int) -> None:
        self._bytes.setdefault(key, {})[cls] = int(nbytes)

    def _evict_bucket(self, key: tuple) -> None:
        """Drop EVERY residency class for one bucket key, so eviction never
        strands a derived record whose donor args are gone."""
        self._buckets.pop(key, None)
        self._ckpts.pop(key, None)
        self._shards.pop(key, None)
        self._run_host.pop(key, None)
        self._homes.pop(key, None)
        self._blocks.pop(key, None)
        for lk in [lk for lk in self._ladders if lk[0] == key]:
            self._ladders.pop(lk, None)
        for sk in [sk for sk in self._sparse if sk[0] == key]:
            self._sparse.pop(sk, None)
        self._bytes.pop(key, None)
        self.stats["evictions"] += 1

    def _enforce_budget(self, current_key: Optional[tuple] = None) -> None:
        """Evict coldest-first (insertion order of `_buckets` = LRU) until
        the accounted total fits the budget. `current_key` — the bucket the
        in-flight dispatch holds references to — goes last, and only if it
        alone still busts the budget (the caller's references keep its
        tensors alive through the dispatch)."""
        if self.budget_bytes <= 0:
            return
        while self.total_bytes() > self.budget_bytes:
            victim = next((k for k in self._buckets if k != current_key), None)
            if victim is None:
                victim = next(
                    (k for k in self._bytes if k != current_key),
                    current_key if current_key in self._bytes else None)
            if victim is None:
                break
            self._evict_bucket(victim)

    def bucket_key(self, host_args: tuple, sharding=None, ns=None) -> tuple:
        """Residency key for one dispatch's kernel args. `sharding` is a
        placement tag (None for single solves), a `Placement` or a tuple of
        them (their mesh's token is part of the key: a sharded and an
        unsharded solve of one fleet hold different buckets); `ns` the
        tenant namespace (None yields the 2-tuple)."""
        shapes = tuple((a.shape, a.dtype.str) for a in host_args)
        if ns is None:
            return (shapes, sharding)
        return (shapes, sharding, ns)

    def put_checkpoint(self, key: tuple, record: dict) -> None:
        """Record a solve's checkpoint set for its bucket (newest first,
        bounded). Records die with the bucket on invalidate()."""
        lst = self._ckpts.setdefault(key, [])
        lst.insert(0, record)
        del lst[self.max_ckpts_per_bucket:]
        self._account(key, "ckpt", sum(_nbytes(r) for r in lst))
        self._enforce_budget(key)

    def get_checkpoints(self, key: tuple) -> list:
        return self._ckpts.get(key, [])

    def put_shard_record(self, key: tuple, record: dict) -> None:
        """Record a sharded solve's block-boundary carries + stitched rows
        for its bucket (one per bucket: the newest sharded solve is the
        only useful resume donor). Dies on invalidate()."""
        self._shards[key] = record
        self._account(key, "shard", _nbytes(record))
        self._enforce_budget(key)

    def get_shard_record(self, key: tuple):
        return self._shards.get(key)

    def put_ladder(self, key: tuple, host_table: np.ndarray, dev) -> None:
        """Record a bucket's device-resident relax-ladder table (one per
        bucket and shape)."""
        self._ladders[(key, host_table.shape)] = (_digest(host_table), dev)
        self._account(key, "ladder", sum(
            _nbytes(v[1]) for lk, v in self._ladders.items() if lk[0] == key))
        self._enforce_budget(key)

    def get_ladder(self, key: tuple, host_table: np.ndarray):
        """The bucket's resident ladder table if its content matches, else
        None (the caller uploads and re-records)."""
        rec = self._ladders.get((key, host_table.shape))
        if rec is None or rec[0] != _digest(host_table):
            return None
        return rec[1]

    @staticmethod
    def _sparse_token(core_rev: int, run_q_idx: np.ndarray, run_v_idx: np.ndarray) -> bytes:
        """Staleness token of a sparse index-table pair: the encode core rev
        (a core rebuild mints a fresh one) plus the content digests."""
        return str(int(core_rev)).encode() + _digest(run_q_idx) + _digest(run_v_idx)

    def put_sparse(self, key: tuple, core_rev: int, run_q_idx: np.ndarray,
                   run_v_idx: np.ndarray, dev_pair) -> None:
        """Record a bucket's device-resident sparse index pair (one per
        bucket and shape pair), counted under the budget as "sparse"."""
        shp = (run_q_idx.shape, run_v_idx.shape)
        self._sparse[(key, shp)] = (self._sparse_token(core_rev, run_q_idx, run_v_idx), dev_pair)
        self._account(key, "sparse", sum(
            _nbytes(d) for sk, v in self._sparse.items() if sk[0] == key for d in v[1]))
        self._enforce_budget(key)

    def get_sparse(self, key: tuple, core_rev: int, run_q_idx: np.ndarray,
                   run_v_idx: np.ndarray):
        """The bucket's resident sparse index pair if its token matches,
        else None (the caller uploads and re-records)."""
        rec = self._sparse.get((key, (run_q_idx.shape, run_v_idx.shape)))
        if rec is None or rec[0] != self._sparse_token(core_rev, run_q_idx, run_v_idx):
            return None
        return rec[1]

    def apply_run_events(self, host_args: tuple, prov: tuple, sharding=None,
                         ns=None) -> bool:
        """Streaming event-batch apply: sync the bucket's resident run
        tables (ARG_SPEC entries 0/1) to `host_args` by shipping only the
        (pos, gid, cnt) edit triplets and scattering them on the device
        (cuda/ffd.py ffd_apply_events, K14), instead of letting adopt()
        re-upload the whole padded pair. Returns True when the resident
        tensors + tags now match `host_args[0:2]` (adopt's digest check then
        sees them fresh: zero run-table upload bytes).

        The diff base must provably equal the DEVICE content, so the stage
        only fires when the recorded host copy's digests match the bucket's
        current adopt tags, the trust anchor adopt itself uses. Any mismatch
        (cold bucket, an interleaved unstaged solve, after invalidate())
        declines and lets adopt pay the normal upload; the new host pair is
        recorded either way so the NEXT solve can stage."""
        from . import encode_cache
        from .cuda import ffd

        if sharding is not None:
            return False  # a placement-tagged bucket keeps its own layout
        rg = np.ascontiguousarray(host_args[0])
        rc = np.ascontiguousarray(host_args[1])
        key = self.bucket_key(host_args, sharding, ns=ns)
        dig_rg, dig_rc = _digest(rg), _digest(rc)
        prev = self._run_host.get(key)
        self._run_host[key] = (rg.copy(), rc.copy(), dig_rg, dig_rc)
        self._account(key, "run_host", rg.nbytes + rc.nbytes)
        bkt = self._buckets.get(key)
        if bkt is None or prev is None:
            return False
        dev, tags = bkt
        if (dev[0] is None or dev[1] is None
                or tags[0] is None or tags[1] is None
                or tags[0][1] != prev[2] or tags[1][1] != prev[3]):
            return False  # device content is not (provably) the diff base
        events = encode_cache.run_table_events(
            prev[0], prev[1], rg, rc, max_events=max(16, rg.shape[0] // 3))
        if events is None:
            return False  # shape moved or near-total rewrite: ship whole
        k = len(events)
        if k == 0:
            return True  # tables unchanged; adopt's digest check hits as-is
        # pad to a power of two >= 8 with EVENT_PAD_POS rows, which the
        # scatter drops (the JAX package's compile buckets)
        k2 = 8
        while k2 < k:
            k2 *= 2
        if k2 != k:
            pad = np.zeros((k2 - k, events.shape[1]), dtype=events.dtype)
            pad[:, 0] = ffd.EVENT_PAD_POS
            events = np.concatenate([events, pad])
        # the host rows go to K14 as they are: up to ffd.EVENT_PARAM_ROWS they
        # cross inside the launch's parameters (no event tensor, no copy),
        # so the ledger counts the same bytes and message as a copy would
        self.ledger.record_upload(events.nbytes, 1, msgs=1)
        dev[0], dev[1] = ffd.ffd_apply_events(dev[0], dev[1], events)
        homes = self._homes.get(key)
        if homes is not None:
            homes[0] = homes[1] = (None,)
            self._compact(key, dev)
        tags[0] = (prov[0], dig_rg)
        tags[1] = (prov[1], dig_rc)
        self.stats["event_batches"] += 1
        self.stats["event_edits"] += k
        return True

    # -- the unpack blocks behind the resident entries -------------------------

    def block_bytes(self, key: tuple) -> int:
        """Bytes the bucket's unpack blocks hold, and its tensors outside
        any block (K14's run tables: the two rows of its one [2, Sp]
        allocation, whose bytes their sizes count once)."""
        bkt, homes = self._buckets.get(key), self._homes.get(key)
        if bkt is None or homes is None:
            return 0
        loose = sum(int(t.nbytes) for x, h in zip(bkt[0], homes) if h
                    for t, b in zip(_tensors(x), h) if b is None)
        return sum(self._blocks.get(key, {}).values()) + loose

    def live_bytes(self, key: tuple) -> int:
        """The footprints (bytes rounded up to the block's alignment) of the
        bucket's resident tensors: block_bytes(key) stays within twice it."""
        from .cuda.arena import aligned

        bkt = self._buckets.get(key)
        if bkt is None:
            return 0
        return sum(aligned(t.nbytes) for x in bkt[0] if x is not None for t in _tensors(x))

    def _moves(self, key: tuple, dev: list, keep) -> List[Tuple[int, int]]:
        """(entry, tensor) of the resident tensors to move into this
        adopt's block: every tensor of `keep` (the entries that stay) in a
        block those that go would leave under half live (footprints)."""
        from .cuda.arena import aligned

        homes = self._homes.get(key)
        if not homes:
            return []
        live: Dict[int, int] = {}
        for i in keep:
            for t, b in zip(_tensors(dev[i]), homes[i] or ()):
                if b is not None:
                    live[b] = live.get(b, 0) + aligned(t.nbytes)
        low = {b for b, size in self._blocks[key].items() if 2 * live.get(b, 0) < size}
        if not low:
            return []
        return [(i, j) for i in keep for j, b in enumerate(homes[i] or ()) if b in low]

    def _settle(self, key: tuple, dev: list, placed: list) -> None:
        """Record this adopt's blocks: `placed` lists (entry, tensor slot,
        block id, block bytes) of every tensor now in a new block; blocks
        no entry references any more are dropped."""
        homes = self._homes.setdefault(key, [None] * len(dev))
        blocks = self._blocks.setdefault(key, {})
        for i, j, b, size in placed:
            h = list(homes[i] or (None,) * len(_tensors(dev[i])))
            h[j] = b
            homes[i] = tuple(h)
            blocks[b] = size
        refs = {b for h in homes if h for b in h}
        for b in [b for b in blocks if b not in refs]:
            del blocks[b]

    def _rehome(self, dev: list, here, moved, b: int, size: int, placed: list) -> None:
        """Put the moved copies of a placed bucket's survivors `here`
        ((entry, tensor slot)) in their entries and record them in block b."""
        for (i, k), t in zip(here, moved):
            x = list(_tensors(dev[i]))
            x[k] = t
            dev[i] = tuple(x) if isinstance(dev[i], tuple) else t
            placed.append((i, k, b, size))
        self._moved(len(here))

    def _new_block(self) -> int:
        self._block_ids += 1
        return self._block_ids

    def _compact(self, key: tuple, dev: list) -> None:
        """A launch that only moves: the survivors of every block left
        under half live, into one new block (a single-device bucket)."""
        from .cuda.arena import upload_block

        moves = self._moves(key, dev, [i for i, x in enumerate(dev) if x is not None])
        if not moves:
            return
        _, moved, block = upload_block([], 0, (), self.device,
                                       moves=[dev[i] for i, _ in moves])
        b = self._new_block()
        for (i, _), t in zip(moves, moved):
            dev[i] = t
        self._moved(len(moves))
        self._settle(key, dev, [(i, 0, b, int(block.numel())) for i, _ in moves])

    def _moved(self, n: int) -> None:
        """Count one unpack launch that moved n survivors (none: nothing)."""
        if n:
            self.stats["moved_segments"] += n
            self.stats["compactions"] += 1

    def context_signature(self, key: tuple, exclude: tuple = ()) -> Optional[tuple]:
        """Content signature of the bucket's resident entries OUTSIDE
        `exclude` (ARG_SPEC indices), read from the adopt tags. Two equal
        signatures prove byte-identical non-excluded kernel args — the
        node-table/core-identity leg of checkpoint prefix validity
        (backend._plan_resume). None until the bucket is fully tagged."""
        bkt = self._buckets.get(key)
        if bkt is None:
            return None
        out = []
        for i, t in enumerate(bkt[1]):
            if i in exclude:
                continue
            if t is None:
                return None
            out.append(t[1])
        return tuple(out)

    def adopt(self, host_args: tuple, prov: tuple, sharding=None, ns=None) -> tuple:
        """Return device-resident tensors matching `host_args`, uploading
        only stale entries as ONE packed buffer. `prov` aligns with
        `host_args` (backend.host_kernel_args): a hashable content-identity
        token per entry, or None to force the digest path. With a
        `Placement` (or a tuple of them) the entries are placed on its mesh
        (see the module docstring): one packed buffer per distinct
        placement, each entry a tuple of tensors over the mesh's physical
        devices."""
        from ..parallel.sharded import Placement, device_scope
        from .cuda.arena import pack, upload_block

        self.stats["adopts"] += 1
        key = self.bucket_key(host_args, sharding, ns=ns)
        bkt = self._buckets.pop(key, None)
        if bkt is None:
            while len(self._buckets) >= self.max_buckets:
                self._evict_bucket(next(iter(self._buckets)))
            bkt = [[None] * len(host_args), [None] * len(host_args)]
        # re-insert on EVERY adopt: dict order is the LRU order the budget
        # enforcer and the bucket cap both evict from the front of
        self._buckets[key] = bkt
        self._account(key, "args", sum(int(a.nbytes) for a in host_args))
        dev, tags = bkt
        stale: List[int] = []
        for i, a in enumerate(host_args):
            tok = prov[i]
            ent = tags[i]
            if dev[i] is not None and ent is not None:
                if tok is not None and ent[0] == tok:
                    continue  # provenance proves content identity
                dig = _digest(a)
                if ent[1] == dig:
                    # same bytes under a new token: keep the tensor
                    tags[i] = (tok, dig)
                    continue
            else:
                dig = _digest(a)
            tags[i] = (tok, dig)
            stale.append(i)
        led = self.ledger
        self.last_stale = tuple(stale)
        if not stale:
            self.stats["exact_hits"] += 1
            led.record_adopt("exact_hit")
            self._enforce_budget(key)
            return tuple(dev)
        full = len(stale) == len(host_args)
        self.stats["full_uploads" if full else "delta_uploads"] += 1
        if isinstance(sharding, tuple):  # a Placement, or one per entry
            placements = ((sharding,) * len(host_args) if isinstance(sharding, Placement)
                          else sharding)
            groups: Dict[Placement, List[int]] = {}
            for i in stale:
                groups.setdefault(placements[i], []).append(i)
            total = shard = 0
            stale_set = set(stale)
            # survivors to move, each with the first upload to its device
            pending = self._moves(key, dev, [i for i in range(len(dev))
                                             if dev[i] is not None and i not in stale_set])
            placed = []
            for plc, idxs in groups.items():
                mesh = plc.mesh
                per_dev = []
                for j, d in enumerate(mesh.physical):
                    rows = mesh.local_slots(j)
                    parts, off, specs = pack([
                        np.ascontiguousarray(host_args[i][rows]) if plc.blocked else host_args[i]
                        for i in idxs])
                    here = [(i, k) for i, k in pending if _tensors(dev[i])[k].device == d]
                    pending = [m for m in pending if m not in here]
                    with device_scope(d):
                        new, moved, block = upload_block(
                            parts, off, specs, d, moves=[_tensors(dev[i])[k] for i, k in here])
                    b = self._new_block()
                    size = int(block.numel())
                    per_dev.append(new)
                    placed += [(i, j, b, size) for i in idxs]
                    self._rehome(dev, here, moved, b, size, placed)
                for k, i in enumerate(idxs):
                    dev[i] = tuple(new[k] for new in per_dev)
                nb = sum(int(host_args[i].nbytes) for i in idxs)
                total += nb
                if _buffer_split(plc) > 1:
                    shard += nb
            # survivors on a device no stale group uploads to: a launch that
            # only moves, one a device
            while pending:
                d = _tensors(dev[pending[0][0]])[pending[0][1]].device
                here = [(i, k) for i, k in pending if _tensors(dev[i])[k].device == d]
                pending = [m for m in pending if m not in here]
                with device_scope(d):
                    _, moved, block = upload_block(
                        [], 0, (), d, moves=[_tensors(dev[i])[k] for i, k in here])
                self._rehome(dev, here, moved, self._new_block(), int(block.numel()), placed)
            self._settle(key, dev, placed)
            led.record_upload(total, len(stale), msgs=len(groups), shard_bytes=shard)
            led.record_adopt("full_upload" if full else "delta_upload")
            self._enforce_budget(key)
            return tuple(dev)
        # pack stale entries back to back into one byte buffer -> one copy
        # to the device -> one unpack launch into one block of typed views,
        # with the survivors of any block the stale entries leave under half
        # live moved into it
        stale_set = set(stale)
        moves = self._moves(key, dev, [i for i in range(len(dev))
                                       if dev[i] is not None and i not in stale_set])
        parts, off, specs = pack([host_args[i] for i in stale])
        new, moved, block = upload_block(parts, off, specs, self.device,
                                         moves=[dev[i] for i, _ in moves])
        for j, i in enumerate(stale):
            dev[i] = new[j]
        for (i, _), t in zip(moves, moved):
            dev[i] = t
        self._moved(len(moves))
        b, size = self._new_block(), int(block.numel())
        self._settle(key, dev, [(i, 0, b, size) for i in (*stale, *(i for i, _ in moves))])
        led.record_upload(off, len(stale), msgs=1)
        led.record_adopt("full_upload" if full else "delta_upload")
        self._enforce_budget(key)
        return tuple(dev)
