#!/usr/bin/env python3
"""The preemption walk's team sizes, and the class pass against another
checkout's, on one card.

--step0 (this checkout alone): the walk's tables at class_contended's
walk call (chip_smoke.CLASS_KW through ClassAwareSolver(TorchSolver(device=
"cpu")), the call recorded and its tables moved to the card) and at
chip_smoke's K11_NODES walks (every node admitted: the fits near the front;
only the last 64: every search walks ~10 000 rows). On each, in turns,
ROUNDS rounds:
- "per_candidate": the class pass's loop as it ran before the walk, one
  K11 call a candidate with its upload and fetch and the host update
  (chip_smoke.per_candidate_ms), host clock;
- "block": the walk on one block of 1 024 threads (ctas 1);
- "cluster": the walk on a cluster of 16 such CTAs (ctas 16);
the walks by CUDA events over CALLS calls, every walk's wire and final
tables equal to the plain version's, and the per-candidate loop's rows
equal to the walk's. Then the team barrier's cost (chip_smoke.walk_barrier_us)
and ptxas's registers and spills of the class kernels.

OTHER_CHECKOUT (for example the parent commit unpacked with `git archive`):
each cell through each checkout's ClassAwareSolver(TorchSolver()) in a
process of its own, in turns (this, other, other, this): one warm solve,
SOLVES timed ones (host clock, each ended by a synchronize), each
checkout's own chip_smoke.class_breakdown over one pass, the launches of
the class kernels and the node_ok_mask rows a solve, and a digest of the
decisions, which must agree. The cells: class_contended, and class_keys,
the same fleet with a toleration of its own on every hi-* pod (a mask_key
each, the node rows all equal: the walk goes in chunks of
scheduling_class.WALK_CHUNK_KEYS candidates; the decisions are
class_contended's). The other checkout's kernels build first (this one's
are built by the first turn, or were built by an earlier command).

Usage: python3 karpenter_tpu_torch/tools/walk_ab.py --step0
       python3 karpenter_tpu_torch/tools/walk_ab.py OTHER_CHECKOUT [CELL ...] [--turns N]
(--turns: N rounds of the four turns a cell, 1 by default)
Prints one JSON object ({"step0": ...} or {"walk_ab": ...}), then the
card's name and power limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUNDS = 3  # Step 0's rounds of (per_candidate, block, cluster, cluster, block, per_candidate)
CALLS = 10  # walk calls a timing
SOLVES = 3  # timed class_contended solves a side a turn
TEAMS = {"block": 1, "cluster": 16}
CELLS = ("class_contended", "class_keys")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _class_walk_args(cs):
    """class_contended's walk call on the CPU plain path: its tables (CPU
    tensors) and budget."""
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import scheduling_class as sc
    from karpenter_tpu_torch.solver.cuda import ffd

    seen = []
    walk = ffd.preemption_walk

    def recording(*a):
        seen.append(a)
        return walk(*a)

    ffd.preemption_walk = recording
    try:
        sc.ClassAwareSolver(tb.TorchSolver(device="cpu", max_claims=cs.MAX_CLAIMS)).solve(
            cs.build_class_input(**cs.CLASS_KW))
    finally:
        ffd.preemption_walk = walk
    assert len(seen) == 1, len(seen)
    *tables, budget = seen[0]
    return tables, budget


def step0() -> dict:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import scheduling_class as sc
    from karpenter_tpu_torch.solver.cuda import build, ffd

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    tables, budget = _class_walk_args(cs)
    shapes = {"class_contended": ([t.to(dev) for t in tables], budget)}
    checks = cs.class_kernel_checks(dev)
    for name, t in checks["walk10k"].items():
        shapes[f"k11_nodes_{name}"] = (cs._on_card(t, dev), cs.WALK_BUDGET)
    out = {}
    for name, (args, b) in shapes.items():
        want = ffd.preemption_walk_plain(*args, b)
        rows, flag = ffd.unpack_walk(want.wire.cpu().numpy())
        host = [a.cpu().numpy() for a in args]
        assert sc._walk_host(sc.preemption_plan_host, host[:4], *host[4:], b)[:2] == (rows, flag), \
            name
        for team, ctas in TEAMS.items():
            got = ffd._preemption_walk_cuda(*args, b, ctas=ctas)
            torch.cuda.synchronize()
            assert cs.max_abs_err(list(got), list(want)) == 0, (name, team)
        ms = {k: [] for k in ("per_candidate", *TEAMS)}
        for _ in range(ROUNDS):
            for k in ("per_candidate", "block", "cluster", "cluster", "block", "per_candidate"):
                if k == "per_candidate":
                    ms[k].append(cs.per_candidate_ms(args, b, n=1))
                else:
                    ms[k].append(cs.time_ms(
                        lambda c=TEAMS[k]: ffd._preemption_walk_cuda(*args, b, ctas=c), CALLS))
        cost = cs.walk_cost(args, b)
        out[name] = dict(ms=ms, median_ms={k: statistics.median(v) for k, v in ms.items()},
                         rule_team=ffd.walk_ctas(cost["E"]), **cost)
    return dict(shapes=out, barrier_us=cs.walk_barrier_us(dev), build_s=build_s,
                ptxas={k: v for k, v in cs.ptxas_report(build.BUILD_LOG["ptxas"]).items()
                       if "walk" in k or "preempt" in k or "gang" in k},
                walk_checks={k: (w["E"], w["C"], w["evictions"], w["flag"])
                             for k, w in checks["walks"].items()})


def class_input(cs, cell: str):
    """The cell's fleet from `cs` (a checkout's chip_smoke): class_keys
    gives every hi-* pod a toleration of its own (it tolerates no taint of
    the fleet, so every node row stays class_contended's)."""
    import dataclasses

    from karpenter_tpu_torch.api.objects import Toleration

    inp = cs.build_class_input(**cs.CLASS_KW)
    if cell == "class_keys":
        pods = [dataclasses.replace(p, tolerations=[Toleration(key=f"walk-ab-{p.meta.uid}",
                                                               operator="Exists")])
                if p.meta.uid.startswith("hi-") else p for p in inp.pods]
        inp = dataclasses.replace(inp, pods=pods)
    return inp


def class_solve(root: str, cell: str) -> dict:
    """`cell` through `root`'s ClassAwareSolver(TorchSolver())."""
    import torch

    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import scheduling_class as sc
    from karpenter_tpu_torch.solver.cuda import build, ffd

    build.build()
    inp = class_input(cs, cell)
    caw = sc.ClassAwareSolver(tb.TorchSolver(max_claims=cs.MAX_CLAIMS))
    res = caw.solve(inp)
    torch.cuda.synchronize()
    for k in ffd.LAUNCHES:
        ffd.LAUNCHES[k] = 0
    rows = []
    mask = sc.node_ok_mask
    sc.node_ok_mask = lambda p, nodes: rows.append(1) or mask(p, nodes)
    ms = []
    try:
        for _ in range(SOLVES):
            t0 = time.perf_counter()
            caw.solve(inp)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        sc.node_ok_mask = mask
    launches = {k: ffd.LAUNCHES.get(k, 0) / SOLVES
                for k in ("gang_commit", "preemption_plan", "preemption_walk")}
    stages = cs.class_breakdown(caw, inp, 1)
    digest = hashlib.sha256(json.dumps(cs.class_decisions(res), sort_keys=True,
                                       default=str).encode()).hexdigest()
    return dict(root=root, cell=cell, ms=ms, launches_per_solve=launches, stages=stages,
                node_ok_rows_per_solve=len(rows) / SOLVES, digest=digest,
                evictions=len(res.evictions), class_stats=caw.class_stats)


def walk_ab(other: str, cells, turns: int = 1) -> dict:
    other = os.path.abspath(other)
    env = dict(os.environ)
    prebuild = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from karpenter_tpu_torch.solver.cuda import build; build.build()", other],
        cwd=other, env=env)
    # no timing while nvcc runs
    assert prebuild.wait() == 0, "the other checkout's kernels did not build"
    sides = {"this": REPO, "other": other}
    order = ("this", "other", "other", "this") * turns
    out = {}
    for cell in cells:
        runs = {"this": [], "other": []}
        for side in order:
            got = subprocess.run([sys.executable, os.path.abspath(__file__), "--class-solve",
                                  sides[side], cell], capture_output=True, text=True, env=env)
            assert got.returncode == 0, (cell, side, got.stderr[-4000:])
            runs[side].append(json.loads(got.stdout.strip().splitlines()[-1]))
        digests = {r["digest"] for v in runs.values() for r in v}
        assert len(digests) == 1, f"the two checkouts decide {cell} differently: {digests}"
        summary = {}
        for side, rs in runs.items():
            ms = sorted(x for r in rs for x in r["ms"])
            summary[side] = dict(p50_ms=statistics.median(ms), p99_ms=ms[-1], ms=ms,
                                 turn_p50_ms=[statistics.median(r["ms"]) for r in rs],
                                 stages=[r["stages"] for r in rs],
                                 launches_per_solve=rs[0]["launches_per_solve"],
                                 node_ok_rows_per_solve=rs[0]["node_ok_rows_per_solve"],
                                 evictions=rs[0]["evictions"])
        out[cell] = dict(sides=summary, decisions_equal=True, digest=digests.pop())
    return dict(order=order, cells=out)


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--class-solve":
        print(json.dumps(class_solve(sys.argv[2], sys.argv[3])))
        return 0
    if not torch.cuda.is_available():
        print("walk_ab: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--step0"]:
        print(json.dumps({"step0": step0()}))
    elif len(sys.argv) >= 2 and not sys.argv[1].startswith("-"):
        args, turns = sys.argv[2:], 1
        if "--turns" in args:
            i = args.index("--turns")
            turns = int(args[i + 1])
            args = args[:i] + args[i + 2:]
        if not set(args) <= set(CELLS) or turns < 1:
            print(__doc__, file=sys.stderr)
            return 2
        print(json.dumps({"walk_ab": walk_ab(sys.argv[1], args or CELLS, turns)}))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(_card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
