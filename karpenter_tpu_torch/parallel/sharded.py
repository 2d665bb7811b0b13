"""Device meshes and batched solves over a lane axis: the port of
karpenter_tpu/parallel/sharded.py's `make_mesh`, `batch_bucket`,
`batched_solve` and `pad_batch`, and of the single-process placement the
mesh-sharded solve and the candidate-sharded consolidation use.

`batched_solve` runs `ffd_solve` on every lane of a [B, ...] argument
tuple (the JAX `jax.vmap(ffd_solve)`): on the card one launch of K15
(cuda/ffd.py ffd_solve_lanes, one block per lane). `pad_batch` pads such a
tuple to a batch bucket on the device by replicating its last lane: one
launch of K16 (cuda/arena.py pad_lanes). Both serve the fused cohort
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
"""

from __future__ import annotations

import contextlib
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
    `Mesh(np.asarray(devices), (axis,))`). `physical` lists each distinct
    device once, in first-slot order; `slot_device[s]` is slot s's index in
    it. Equal meshes have equal `token`s (slot list + axis name), the key
    of every cache that depends on a mesh."""

    def __init__(self, devices, axis: str):
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
        self.token = (tuple(str(d) for d in self.devices), axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_slots(self, j: int) -> list:
        """The slots physical device j holds, in slot order."""
        return [s for s, p in enumerate(self.slot_device) if p == j]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.token == self.token

    def __hash__(self) -> int:
        return hash(self.token)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r})"


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
    """The candidate-batch split: slot s owns rows [s * B/n, (s+1) * B/n)
    (B divides evenly: batch_bucket). Returns, per physical device, the
    row indices of its slots, in slot order."""
    per = B // mesh.size
    return [np.concatenate([np.arange(s * per, (s + 1) * per) for s in mesh.local_slots(j)])
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
    FFDOutput of numpy arrays, every field with a leading [Nd] axis."""
    from ..solver.convert import output_to_host
    from ..solver.cuda.ffd import FFDOutput, FFDState

    host = {j: output_to_host(out) for j, out in parts}
    order = [(host[mesh.slot_device[s]], mesh.local_slots(mesh.slot_device[s]).index(s))
             for s in range(mesh.size)]

    def stacked(get):
        return np.stack([get(h)[k] for h, k in order])

    return FFDOutput(
        take_e=stacked(lambda h: h.take_e), take_c=stacked(lambda h: h.take_c),
        leftover=stacked(lambda h: h.leftover),
        state=FFDState(*(stacked(lambda h, i=i: h.state[i]) for i in range(len(FFDState._fields)))),
        events=stacked(lambda h: h.events))


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
