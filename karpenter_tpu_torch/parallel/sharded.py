"""Device meshes and batched solves over a lane axis: the port of
karpenter_tpu/parallel/sharded.py's `make_mesh`, `batch_bucket`,
`batched_solve` and `pad_batch`, and of the single-process placement the
mesh-sharded solve and the candidate-sharded consolidation use.

`batched_solve` runs `ffd_solve` on every lane of a [B, ...] argument
tuple (the JAX `jax.vmap(ffd_solve)`): on the card one launch of K15
(cuda/ffd.py ffd_solve_lanes, one thread-block cluster a lane). `pad_batch`
pads such a tuple to a batch bucket on the device by replicating its last
lane: one launch of K16 (cuda/arena.py pad_lanes). Both serve the fused cohort
dispatch (solver/backend.py solve_cohort_async), which runs on one card.

A `Mesh` is an ordered list of device slots on one named axis, the
counterpart of a one-axis `jax.sharding.Mesh`. The slot list
(`device_slots`) is the visible CUDA devices, as the reference's is
`jax.devices()`, or one slot for the CPU. `virtual_devices(n)` is the rig
setting that stands in for XLA's
`--xla_force_host_platform_device_count`: inside it the port sees n slots,
dealt round-robin over the physical devices of that type (on one card all
n are cuda:0, on the CPU all n are the CPU; on four cards slot i is
cuda:i % 4). A `Placement` says how an array lies on a mesh: its leading
axis split over the slots (each physical device holds the rows of its own
slots) or a copy on every physical device. Every mesh cache keys on the
slot list, so leaving `virtual_devices` restores the single-device path.

Several processes (the port of the reference's `jax.distributed` pod-slice
helpers, PERF row 17m): `init_distributed` joins a `torch.distributed`
process group, `make_process_mesh` builds a run-axis mesh over every
process in process-major order (process p owns blocks [p·per, (p+1)·per)),
`put_process_sharded` places only this process's blocks, and
`mesh_sharded_call` maps a function over the blocks and gathers its
outputs over the group. A process can address only its own devices, so a
process mesh holds this process's slots and carries the global size, the
world size, the rank and the offset of its first block; what crosses
processes is host data, gathered with `all_gather_object`.
"""

from __future__ import annotations

import contextlib
import datetime
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

_VIRTUAL: Optional[int] = None  # virtual_devices(n): the slot count, else None


@contextlib.contextmanager
def virtual_devices(n: int):
    """Rig setting: inside the block the port sees `n` device slots, dealt
    round-robin over the physical devices of each type (the counterpart of
    the reference rig's --xla_force_host_platform_device_count). Tests
    enter it with 8, chip_smoke.py with 4."""
    global _VIRTUAL
    if int(n) < 1:
        raise ValueError(f"virtual_devices: n={n} must be >= 1")
    prev, _VIRTUAL = _VIRTUAL, int(n)
    try:
        yield
    finally:
        _VIRTUAL = prev


def device_slots(device="cuda") -> tuple:
    """The ordered device slots of `device`'s type: the visible CUDA
    devices, or one CPU slot; under virtual_devices(n), n slots dealt
    round-robin over those physical devices."""
    dev = torch.device(device)
    if dev.type == "cuda":
        phys = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        phys = [torch.device(dev.type)]
    if _VIRTUAL is None or not phys:
        return tuple(phys)
    return tuple(phys[i % len(phys)] for i in range(_VIRTUAL))


class Mesh:
    """An ordered list of device slots on one axis (the reference's 1-D
    `Mesh(np.asarray(devices), (axis,))`), or a grid of them (`shape`, the
    two-level (dcn, ici) candidate mesh, dcn-major). `physical` lists each
    distinct device once, in first-slot order; `slot_device[s]` is slot s's
    index in it.

    `devices` are the slots THIS process holds. On a mesh over several
    processes (`world` > 1) they are slots [offset, offset + n_local) of the
    `size` global ones, in process-major order; in one process `size` ==
    `n_local` and `offset` 0. Equal meshes have equal `token`s (slot list,
    axis names, shape, world size, rank, offset), the key of every cache
    that depends on a mesh."""

    def __init__(self, devices, axis, shape=None, world: int = 1, rank: int = 0,
                 offset: int = 0, global_size: Optional[int] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device slot")
        self.axis = axis
        phys: list = []
        for d in self.devices:
            if d not in phys:
                phys.append(d)
        self.physical = tuple(phys)
        self.slot_device = tuple(phys.index(d) for d in self.devices)
        self.world, self.rank, self.offset = int(world), int(rank), int(offset)
        self.global_size = len(self.devices) if global_size is None else int(global_size)
        self.shape = tuple(shape) if shape is not None else (self.global_size,)
        self.token = (tuple(str(d) for d in self.devices), axis, self.shape, self.world,
                      self.rank, self.offset)

    @property
    def size(self) -> int:
        """Slots over every process (the reference's `mesh.devices.size`)."""
        return self.global_size

    @property
    def n_local(self) -> int:
        """Slots this process holds."""
        return len(self.devices)

    def local_slots(self, j: int) -> list:
        """The local slots physical device j holds, in slot order."""
        return [s for s, p in enumerate(self.slot_device) if p == j]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.token == self.token

    def __hash__(self) -> int:
        return hash(self.token)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r}, shape={self.shape})"


class Placement(NamedTuple):
    """How one array lies on `mesh`: `blocked` splits its leading axis over
    the slots (one row per slot; each physical device holds the rows of its
    own slots, in slot order), else a whole copy on every physical device.
    Placed arrays are tuples of tensors aligned with `mesh.physical`."""

    mesh: Mesh
    blocked: bool


def make_mesh(n_devices: Optional[int] = None, axis: str = "candidates",
              device="cuda") -> Mesh:
    """The first `n_devices` slots of `device`'s type (all when None)."""
    slots = device_slots(device)
    return Mesh(slots[: n_devices or len(slots)], axis)


def batch_bucket(b: int, mesh=None, mult: int = 8) -> int:
    """Bucket a candidate-batch size so dispatches see one shape per bucket,
    not one per exact row count, and the batch axis divides evenly across
    `mesh` when given (lcm of the bucket multiple and its slot count; an int
    is a slot count). Shared by simulate_subsets, the speculative-probe
    planner and the cohort dispatch."""
    if mesh is not None:
        n_dev = mesh.size if isinstance(mesh, Mesh) else int(mesh)
        mult = mult * n_dev // math.gcd(mult, n_dev)
    return max(mult, ((b + mult - 1) // mult) * mult)


def slot_rows(mesh: Mesh, B: int) -> list:
    """The candidate-batch split: global slot s owns rows [s * B/n,
    (s+1) * B/n) of the n global slots (B divides evenly: batch_bucket).
    Returns, per physical device of this process, the row indices of its
    slots, in slot order."""
    per = B // mesh.size
    return [np.concatenate([np.arange((mesh.offset + s) * per, (mesh.offset + s + 1) * per)
                            for s in mesh.local_slots(j)])
            for j in range(len(mesh.physical))]


def place(a: np.ndarray, placement: Placement) -> tuple:
    """A host array on the mesh as `placement` says (one message per
    physical device): the tuple of tensors aligned with mesh.physical."""
    from ..solver.convert import array_to_torch

    mesh = placement.mesh
    out = []
    for j, dev in enumerate(mesh.physical):
        part = a[mesh.local_slots(j)] if placement.blocked else a
        out.append(array_to_torch(np.ascontiguousarray(part), dev))
    return tuple(out)


def on_device(placed_args, j: int) -> tuple:
    """Physical device j's tensors of a tuple of placed arrays."""
    return tuple(p[j] for p in placed_args)


def device_scope(dev: torch.device):
    """The context a launch on `dev` runs in: its CUDA device current (the
    wrappers launch on the current device's stream), nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def mesh_solve(mesh: Mesh, args: tuple, max_claims: int, zone_engine: bool, sparse=None):
    """The lanes of a mesh-sharded solve: per physical device, one launch
    of K17 (cuda/ffd.py ffd_solve_sharded; K17s, ffd_solve_sharded_sparse,
    with `sparse`, the placed index tables) over the run blocks of the slots
    it holds, on that device's current stream. `args` are the 36 placed
    arrays (run_group and run_count blocked, the rest copies). Returns
    [(physical index, FFDOutput of its slots' lanes)]; nothing waits."""
    from ..solver.cuda.ffd import ffd_solve_sharded, ffd_solve_sharded_sparse

    parts = []
    for j, dev in enumerate(mesh.physical):
        dargs = on_device(args, j)
        with device_scope(dev):
            if sparse is not None:
                out = ffd_solve_sharded_sparse(sparse[0][j], sparse[1][j], *dargs,
                                               max_claims=max_claims, zone_engine=zone_engine)
            else:
                out = ffd_solve_sharded(*dargs, max_claims=max_claims, zone_engine=zone_engine)
        parts.append((j, out))
    return parts


def gather_lanes(mesh: Mesh, parts):
    """mesh_solve's outputs fetched to the host and put in slot order: an
    FFDOutput of numpy arrays, every field with a leading [Nd] axis. On a
    process mesh each process fetches its local lanes, then one
    all_gather_object over the group assembles every process's, in global
    block order (every block's lanes have the same shapes, so this
    process's devices sent n_local / size of the bytes)."""
    from ..solver.convert import output_to_host
    from ..solver.cuda.ffd import FFDOutput, FFDState

    host = {j: output_to_host(out) for j, out in parts}
    order = [(host[mesh.slot_device[s]], mesh.local_slots(mesh.slot_device[s]).index(s))
             for s in range(mesh.n_local)]

    def stacked(get):
        return np.stack([get(h)[k] for h, k in order])

    local = FFDOutput(
        take_e=stacked(lambda h: h.take_e), take_c=stacked(lambda h: h.take_c),
        leftover=stacked(lambda h: h.leftover),
        state=FFDState(*(stacked(lambda h, i=i: h.state[i]) for i in range(len(FFDState._fields)))),
        events=stacked(lambda h: h.events))
    if mesh.world > 1:
        local = tree_concat(all_gather(local))
    return local


def tree_concat(parts: list):
    """Concatenate structurally identical (nested) namedtuples of numpy
    arrays along axis 0: per-process or per-worker block slices back into
    the [Nd, ...] stacked shape."""
    first = parts[0]
    if hasattr(first, "_fields"):
        return type(first)(*(tree_concat([getattr(p, f) for p in parts]) for f in first._fields))
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def batched_solve(batched_args: tuple, max_claims: int, zone_engine: bool = True):
    """ffd_solve over a leading lane axis: `batched_args` are the ARG_SPEC
    tensors, each with a leading axis B. Returns an FFDOutput whose fields
    carry the same leading axis. `zone_engine` is ffd_solve's (the cohort
    dispatch passes the members' shared `enc.V > 0`, so a fused lane runs
    the instance its solo dispatch would). A fused lane can carry V > 0:
    the cohort dispatch declines only custom-key topology and affinity, so
    members with zone or capacity-type spreads fuse through the zoned
    instance (ffd_lanes_kernel<true>)."""
    from ..solver.cuda.ffd import ffd_solve_lanes

    return ffd_solve_lanes(*batched_args, max_claims=max_claims, zone_engine=zone_engine)


def pad_batch(batched_args: tuple, batch: int) -> tuple:
    """Pad a batched args tuple to `batch` lanes by replicating the LAST
    real member's lane on the device: no host->device bytes, no ledger
    traffic. Decode discards the pad lanes, whose content only needs to be
    a valid solve, which the replicated member is. A tuple already at (or
    past) `batch` lanes passes through as the same objects."""
    if not batched_args:
        return tuple(batched_args)
    if int(batched_args[0].shape[0]) >= batch:
        return tuple(batched_args)
    from ..solver.cuda.arena import pad_lanes

    return pad_lanes(tuple(batched_args), batch)


# --- several processes (PERF row 17m) ----------------------------------------
#
# On a multi-node deployment every node runs the same solve in its own
# process over its own cards. These helpers are the fail-closed
# construction path: a grid the processes cannot divide evenly raises a
# typed MeshConstructionError instead of building a wrong mesh.


class MeshConstructionError(RuntimeError):
    """Process-spanning mesh construction failed fail-closed: the requested
    device grid cannot be divided evenly across the participating processes
    (or the sharding arguments to a mesh call were inconsistent). Callers
    decline to the single-process path or fix the topology; they never
    proceed with a wrong mesh."""


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None, timeout_s: float = 300.0) -> None:
    """Join the process group of a multi-process mesh solve:
    torch.distributed.init_process_group at `tcp://host:port` (a bare
    `host:port` gains the scheme), with this process's rank and the world
    size. A failure raises MeshConstructionError.

    The default backend is gloo: everything that crosses processes on this
    path is host data (the lane outputs the stitch fetches anyway, the
    per-process slot counts, the packed consolidation verdicts), and NCCL
    would also refuse two ranks on one card."""
    import torch.distributed as dist

    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    try:
        dist.init_process_group(backend or "gloo", init_method=addr,
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # noqa: BLE001 -- the typed fail-closed surface
        raise MeshConstructionError(
            f"torch.distributed.init_process_group failed for {addr} "
            f"({process_id}/{num_processes}): {e}") from e


def close_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _group():
    """torch.distributed when this process is in an initialized group."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    """The processes of the group (1 without one)."""
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def all_gather(obj) -> list:
    """Every process's `obj`, in rank order: one all_gather_object over the
    group; [obj] without one."""
    dist = _group()
    if dist is None or dist.get_world_size() <= 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def process_slot_counts(device="cuda") -> list:
    """Each process's device-slot count, in rank order (one all_gather of
    len(device_slots(device)) over the group; this process's alone without
    one)."""
    return [int(n) for n in all_gather(len(device_slots(device)))]


def make_process_mesh(n_shards: Optional[int] = None, axis: str = "shards", device="cuda"):
    """A 1-D run-axis mesh spanning every process, and the contiguous block
    range this process owns: `(mesh, (lo, hi))`, blocks [lo, hi) of the
    `n_shards`-wide grid on this process's slots.

    Single-process: `make_mesh` and the full range. With process_count() >
    1 every process must hold the same number of slots and `n_shards` must
    divide evenly over the processes; anything else raises
    MeshConstructionError. The layout is process-major: process p owns
    blocks [p·per, (p+1)·per), the run blocks the stitch walks left to
    right. The mesh holds this process's first `per` slots."""
    nproc = process_count()
    if nproc <= 1:
        m = make_mesh(n_shards, axis=axis, device=device)
        return m, (0, m.size)
    sizes = dict(enumerate(process_slot_counts(device)))
    if len(set(sizes.values())) != 1:
        raise MeshConstructionError(
            f"devices do not divide the grid: per-process device counts are uneven ({sizes}) "
            f"— a 1-D run axis cannot split into equal contiguous per-process blocks")
    total = sum(sizes.values())
    n = int(n_shards) if n_shards else total
    if n % nproc:
        raise MeshConstructionError(
            f"devices do not divide the grid: n_shards={n} is not a multiple of "
            f"process_count={nproc}")
    per = n // nproc
    if per > min(sizes.values()):
        raise MeshConstructionError(
            f"devices do not divide the grid: n_shards={n} needs {per} devices per process "
            f"but processes hold {min(sizes.values())}")
    pid = process_index()
    mesh = Mesh(device_slots(device)[:per], axis, world=nproc, rank=pid, offset=pid * per,
                global_size=n)
    return mesh, (pid * per, (pid + 1) * per)


def put_process_sharded(mesh: Mesh, arr, lo: int, hi: int) -> tuple:
    """Place a [Nd, ...] block array on `mesh` by uploading ONLY this
    process's blocks [lo, hi), split over its slots (one message per
    physical device): no process uploads another's blocks. Single-process:
    the whole array, blocked. Returns the placed tuple (mesh.physical
    order)."""
    a = np.asarray(arr)
    if process_count() <= 1:
        return place(np.ascontiguousarray(a), Placement(mesh, True))
    if mesh.n_local != hi - lo:
        raise MeshConstructionError(
            f"local partition [{lo}, {hi}) does not match the {mesh.n_local} local mesh devices")
    return place(np.ascontiguousarray(a[lo:hi]), Placement(mesh, True))


def fetch_placed(mesh: Mesh, placed: tuple, blocked: bool = True) -> np.ndarray:
    """A placed array back on the host: a blocked one's local rows in slot
    order, a copied one's first copy."""
    if not blocked:
        return placed[0].cpu().numpy()
    host = [p.cpu().numpy() for p in placed]
    return np.stack([host[mesh.slot_device[s]][mesh.local_slots(mesh.slot_device[s]).index(s)]
                     for s in range(mesh.n_local)])


def mesh_sharded_call(mesh: Mesh, fn, in_shardings=None, out_shardings=None):
    """`fn` over `mesh`, as the reference's jit with explicit shardings or
    its shard_map form.

    Exactly one of in_shardings / out_shardings raises MeshConstructionError
    ("one-sided"). With neither, the shard_map form: the returned call takes
    the whole [Nd·k, ...] array, runs `fn` on each of this process's blocks
    of k rows on its slot's device, and returns every block's output, in
    global block order, as a host tensor (the blocks of other processes
    arrive through one all_gather over the group). With both (Placements on
    `mesh`), the call places its argument as in_shardings says and runs `fn`
    over the whole array on the mesh's first device, as jit computes the
    global function; it returns that tensor."""
    if (in_shardings is None) != (out_shardings is None):
        raise MeshConstructionError(
            "one-sided shardings: pass both sharding arguments or omit them to use the "
            "shard_map form")
    if in_shardings is not None:
        for p in (in_shardings, out_shardings):
            if not isinstance(p, Placement) or p.mesh != mesh:
                raise MeshConstructionError("shardings must be Placements on the called mesh")

        def call_placed(x):
            a = np.ascontiguousarray(np.asarray(x))
            if not in_shardings.blocked:
                whole = place(a, in_shardings)[0]
            else:
                # k rows a slot: this process places its slots' blocks, and
                # the whole array is assembled from every process's
                if a.shape[0] % mesh.size:
                    raise ValueError(f"{a.shape[0]} rows do not split into {mesh.size} blocks")
                blocks = a.reshape((mesh.size, a.shape[0] // mesh.size) + a.shape[1:])
                mine = blocks[mesh.offset:mesh.offset + mesh.n_local]
                got = fetch_placed(mesh, place(np.ascontiguousarray(mine), in_shardings))
                if mesh.world > 1:
                    got = np.concatenate(all_gather(got))
                whole = torch.from_numpy(got.reshape(a.shape)).to(mesh.physical[0])
            with device_scope(mesh.physical[0]):
                return fn(whole)

        return call_placed

    def call_blocks(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if t.shape[0] % mesh.size:
            raise ValueError(f"{t.shape[0]} rows do not split into {mesh.size} blocks")
        k = t.shape[0] // mesh.size
        outs = []
        for s, dev in enumerate(mesh.devices):
            b = mesh.offset + s
            with device_scope(dev):
                outs.append(torch.as_tensor(fn(t[b * k:(b + 1) * k].to(dev))).cpu())
        local = torch.cat(outs)
        if mesh.world > 1:
            return torch.from_numpy(np.concatenate(all_gather(local.numpy())))
        return local

    return call_blocks
