#!/usr/bin/env python3
"""The explain pack (K12) and the run-table edit (K14) of this checkout
against another checkout's, on one card.

Each side runs in a process of its own with its checkout's package first on
sys.path, so the two sides' wrappers and kernels are each their own; only
the class and arena libraries are built (cached under the checkout's
build/). The inputs are made once, on the CPU, by this checkout's
chip_smoke builders, and saved (build/karpenter_tpu_torch/side_ab_inputs.pt):

- K12 at two shapes: class_contended's cold solve (chip_smoke.CLASS_KW:
  Sp 1 008, Ep 2 016, Gp 1 024) and surge_e2e's (build_e2e_input: Sp 32,
  Ep 224, Gp 32): the take table of the plain scan and the side tables of
  backend.explain_args, at top_k 8;
- K14 at four batches: the surge's one-edit batch (the run tables of
  build_input(50 000) and the edits of chip_smoke.surge_less_one, padded to
  8 rows as the arena pads them), and seeded tables (chip_smoke.event_rows)
  at Sp 4 096 with K 1 024, with K at the parameter-table limit (256 rows)
  and with one row past it.

Every worker, on each K12 shape: the output's digest (which must agree
between the sides), loop_ms (CUDA events around CALLS calls of the
wrapper), device_ms (torch.profiler, the median of TRACES traces of one
call each, with its split by kernel name: the memset, the sums and the rows
kernels of earlier checkouts), the team the launch takes, a host split of
one wrapper call by time.perf_counter_ns (checks, allocations, ctypes
tables, launch; medians of SPLITS calls) and, where the launch picks its
team, loop and device ms on every team forced. On each K14 batch, the
staged solve's K14 step from host rows (numpy, as arena.apply_run_events
holds them) to the new pair: for a checkout whose wrapper takes device
rows only, the rows' copy to the card and then the wrapper; else the
wrapper on the host rows. Its digest, loop_ms, device_us (the profiler,
by name: the copy and the scatter kernels, the rows' memcpy), allocations
a call (the caching allocator's count) and its host split (the rows'
copy, allocations, ctypes tables, launch). ncu does not run on the chip
machine: no achieved occupancy or DRAM bytes.

Usage: python3 karpenter_tpu_torch/tools/side_ab.py OTHER_CHECKOUT [--rounds N]
       python3 karpenter_tpu_torch/tools/side_ab.py --alone CHECKOUT
OTHER_CHECKOUT (for example the parent commit unpacked with `git archive`):
N rounds (1 by default) of the turns this, other, other, this. --alone:
CHECKOUT alone, twice (the parent's numbers before a change; the inputs are
still made by this checkout). Prints the card's name and power limit, then
one JSON object {"side_ab": ...} (also written, with every run, to
chiprun_out/side_ab.json). Exits non-zero without CUDA.
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
INPUTS = os.path.join(REPO, "build", "karpenter_tpu_torch", "side_ab_inputs.pt")

CALLS = 50  # wrapper calls a loop timing
TRACES = 3  # profiled calls a shape
SPLITS = 20  # calls split by host clock
TOP_K = 8
K12_SHAPES = ("class_contended", "surge_e2e")
K14_SHAPES = ("surge_one_edit", "Sp4096_K1024", "Sp4096_K256", "Sp4096_K257")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _explain_inputs(inp) -> dict:
    """The explain arguments of `inp`'s cold solve on the CPU: the plain
    scan's take table (the claim bucket doubled on saturation, as
    chip_smoke.kernel_phase does) and backend.explain_args' side tables."""
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.convert import args_to_torch, array_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    enc = encode(quantize_input(inp))
    args = args_to_torch(tb.host_kernel_args(enc, tb.TorchSolver._bucket)[0], "cpu")
    M = tb.initial_claim_bucket(int(sum(len(p) for p in enc.group_pods)), cs.MAX_CLAIMS)
    while True:
        out = ffd.ffd_solve(*args, max_claims=M, zone_engine=enc.V > 0)
        if int(out.state.used) < M or M >= cs.MAX_CLAIMS:
            break
        M = min(2 * M, cs.MAX_CLAIMS)
    Sp, Ep = out.take_e.shape
    side, E, G = tb.explain_args(enc, Sp, Ep)
    return dict(args=[out.take_e.clone()] + [array_to_torch(a, torch.device("cpu"))
                                             for a in side], E=E, G=G)


def make_inputs(path: str) -> None:
    """K12's two shapes and K14's four batches (see the module docstring),
    on the CPU, saved to `path`."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import encode_cache as ec
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    k12 = {"class_contended": _explain_inputs(cs.build_class_input(**cs.CLASS_KW)),
           "surge_e2e": _explain_inputs(cs.build_e2e_input(cs.PODS, cs.NODES))}
    surge = cs.build_input(cs.PODS)
    pairs = [tb.host_kernel_args(encode(quantize_input(x)), tb.TorchSolver._bucket)[0][:2]
             for x in (surge, cs.surge_less_one(surge))]
    ev = ec.run_table_events(pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1])
    pad = np.zeros((8 - len(ev), ffd.EVENT_ENTRY_WORDS), np.int32)
    pad[:, 0] = ffd.EVENT_PAD_POS
    k14 = {"surge_one_edit": (np.ascontiguousarray(pairs[0][0], dtype=np.int32),
                              np.ascontiguousarray(pairs[0][1], dtype=np.int32),
                              np.concatenate([ev, pad]).astype(np.int32))}
    for K in (1024, 256, 257):
        k14[f"Sp4096_K{K}"] = cs.event_rows(4096 + K, 4096, K)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(dict(k12=k12, k14=k14, edits=len(ev)), path)


def _device_trace(fn):
    """(device µs of one call, {name: µs}) from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return sum(by_name.values()), by_name


def _median_trace(fn):
    traces = sorted((_device_trace(fn) for _ in range(TRACES)), key=lambda x: x[0])
    return traces[len(traces) // 2]


def _loop_ms(fn, calls: int = CALLS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(calls):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / calls


def _allocations(fn) -> int:
    import torch

    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - n0


def _digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _split(steps) -> dict:
    """Nanoseconds of each (name, fn) step of one call, in order; each fn
    takes the previous step's result."""
    out, x = {}, None
    for name, fn in steps:
        t0 = time.perf_counter_ns()
        x = fn(x)
        out[name] = time.perf_counter_ns() - t0
    return out


def _median_split(make_steps) -> dict:
    import torch

    splits = []
    for _ in range(SPLITS):
        torch.cuda.synchronize()
        splits.append(_split(make_steps()))
    return {k: statistics.median(s[k] for s in splits) / 1e3 for k in splits[0]}


def _k12_checks(ffd, a):
    """The wrapper's checks (every checkout's: device, type, shape,
    contiguity of the 11 tensors)."""
    import torch

    take_e, run_group, group_req, node_free, node_compat, node_zone, node_ct, group_zone, \
        group_ct, group_topo, group_aff = a
    Sp, Ep = take_e.shape
    Gp, R = group_req.shape
    Z, C = group_zone.shape[1], group_ct.shape[1]
    I32 = torch.int32
    for t, n, dt, sh in ((take_e, "take_e", I32, (Sp, Ep)), (run_group, "run_group", I32, (Sp,)),
                         (group_req, "group_req", I32, (Gp, R)),
                         (node_free, "node_free", I32, (Ep, R)),
                         (node_compat, "node_compat", torch.bool, (Gp, Ep)),
                         (node_zone, "node_zone", I32, (Ep,)), (node_ct, "node_ct", I32, (Ep,)),
                         (group_zone, "group_zone", torch.bool, (Gp, Z)),
                         (group_ct, "group_ct", torch.bool, (Gp, C)),
                         (group_topo, "group_topo", torch.bool, (Gp,)),
                         (group_aff, "group_aff", torch.bool, (Gp,))):
        ffd._check(t, n, dt, sh)
    return Sp, Ep, Gp, R, Z, C


def _k12_steps(build, ffd, a, E, G):
    """One wrapper call of K12 cut into steps, as the checkout's wrapper
    takes them: the two-kernel launcher of earlier checkouts (an output, a
    [Gp*Ep + Ep*R] scratch) or the one-launch kernel (one allocation for the
    output and the scratch: ffd.explain_scratch_words)."""
    import torch

    one = hasattr(ffd, "explain_team")
    dev = a[0].device
    box = {}

    def checks(_):
        box["dims"] = _k12_checks(ffd, a)

    def alloc(_):
        Sp, Ep, Gp, R, Z, C = box["dims"]
        if one:
            n = ffd.explain_words(Gp, TOP_K) + ffd.explain_scratch_words(Sp, Ep, Gp, R)
            box["bufs"] = [torch.empty((n,), dtype=torch.int32, device=dev)]
        else:
            box["bufs"] = [torch.empty((ffd.explain_words(Gp, TOP_K),), dtype=torch.int32,
                                       device=dev),
                           torch.empty((max(1, Gp * Ep + Ep * R),), dtype=torch.int32,
                                       device=dev)]

    def tables(_):
        Sp, Ep, Gp, R, Z, C = box["dims"]
        dims = [Sp, Ep, Gp, R, Z, C, TOP_K, E, G]
        if one:
            dims.append(ffd.explain_team(Sp, Ep, Gp, R))
        box["c"] = (ffd._ptrs(list(a) + box["bufs"]), len(a) + len(box["bufs"]), ffd._ints(dims),
                    ffd._stream())

    def launch(_):
        rc = build.load("class_kernels").explain_pack_launch(*box["c"])
        assert rc == 0, rc

    return [("checks", checks), ("allocations", alloc), ("tables", tables), ("launch", launch)]


def _k14_step_fn(ffd, rg, rc, host_ev, dev):
    """The staged solve's K14 step from host rows: the checkout's wrapper on
    the host rows where it takes them (ffd.EVENT_PARAM_ROWS), else the rows'
    copy to the card (arena.apply_run_events' array_to_torch) and then the
    wrapper."""
    from karpenter_tpu_torch.solver.convert import array_to_torch

    if hasattr(ffd, "EVENT_PARAM_ROWS"):
        return lambda: ffd.ffd_apply_events(rg, rc, host_ev)
    return lambda: ffd.ffd_apply_events(rg, rc, array_to_torch(host_ev, dev))


def _k14_steps(build, ffd, rg, rc, host_ev, dev):
    """The K14 step cut into steps, as the checkout takes them: the rows'
    copy, the two outputs and the ctypes tables of earlier checkouts; the
    one [2, Sp] allocation and the launch table (the rows in the
    parameters up to EVENT_PARAM_ROWS, else copied) of this design."""
    import torch

    from karpenter_tpu_torch.solver.convert import array_to_torch

    Sp, K = int(rg.shape[0]), int(host_ev.shape[0])
    box = {}
    if hasattr(ffd, "EVENT_PARAM_ROWS"):
        def copy(_):
            box["ev"] = (array_to_torch(host_ev, dev) if K > ffd.EVENT_PARAM_ROWS else None)

        def alloc(_):
            box["out"] = torch.empty((2, Sp), dtype=torch.int32, device=dev)

        def tables(_):
            box["c"] = ffd._events_launch_args(rg, rc, box["out"], host_ev, box["ev"])

        def launch(_):
            assert build.load("arena_kernels").apply_events_launch(*box["c"]) == 0
    else:
        def copy(_):
            box["ev"] = array_to_torch(host_ev, dev)

        def alloc(_):
            box["out"] = (torch.empty_like(rg), torch.empty_like(rc))

        def tables(_):
            box["c"] = (ffd._ptrs([rg, rc, box["ev"], *box["out"]]), 5, ffd._ints([Sp, K]),
                        ffd._stream())

        def launch(_):
            assert build.load("arena_kernels").apply_events_launch(*box["c"]) == 0
    return [("rows_copy", copy), ("allocations", alloc), ("tables", tables), ("launch", launch)]


def worker(checkout: str) -> dict:
    """One side's measurements (see the module docstring)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from karpenter_tpu_torch.solver.cuda import build, ffd

    assert os.path.abspath(ffd.__file__).startswith(os.path.abspath(checkout)), ffd.__file__
    build.SOURCES = {k: v for k, v in build.SOURCES.items()
                     if k in ("class_kernels", "arena_kernels")}
    t0 = time.perf_counter()
    build.load("class_kernels")
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    data = torch.load(INPUTS, weights_only=False)
    teams = hasattr(ffd, "explain_team")
    k12 = {}
    for name in K12_SHAPES:
        sh = data["k12"][name]
        a = [t.to(dev) for t in sh["args"]]
        E, G = sh["E"], sh["G"]

        def call():
            return ffd.explain_pack(*a, E, G, top_k=TOP_K)

        Sp, Ep = a[0].shape
        r = dict(digest=_digest([call()]), Sp=int(Sp), Ep=int(Ep), Gp=int(a[2].shape[0]),
                 R=int(a[2].shape[1]), E=E, G=G, top_k=TOP_K, take_nnz=int((a[0] != 0).sum()))
        r["loop_ms"] = _loop_ms(call)
        us, by_name = _median_trace(call)
        r["device_ms"], r["device_by_name_us"] = us / 1e3, by_name
        r["split_us"] = _median_split(lambda: _k12_steps(build, ffd, a, E, G))
        r["split_total_us"] = sum(r["split_us"].values())
        if teams:
            r["team"] = ffd.explain_team_info(int(Sp), int(Ep), int(a[2].shape[0]),
                                              int(a[2].shape[1]))
            r["teams_ms"] = {}
            for team in ffd.explain_teams(int(Sp), int(Ep), int(a[2].shape[0]),
                                          int(a[2].shape[1])):
                def forced(team=team):
                    return ffd._explain_pack_cuda(*a, E, G, top_k=TOP_K, team=team)

                assert _digest([forced()]) == r["digest"], (name, team)
                r["teams_ms"][team] = dict(loop_ms=_loop_ms(forced),
                                           device_ms=_median_trace(forced)[0] / 1e3,
                                           info=ffd.explain_team_info(
                                               int(Sp), int(Ep), int(a[2].shape[0]),
                                               int(a[2].shape[1]), team=team))
        else:
            r["team"] = dict(shape="explain_sums_kernel (at most 4 096 blocks of 256) + "
                             "explain_rows_kernel (one block of 256 a group) after a memset")
        k12[name] = r
    k14 = {}
    for name in K14_SHAPES:
        rg_h, rc_h, ev_h = data["k14"][name]
        rg, rc = torch.from_numpy(rg_h).to(dev), torch.from_numpy(rc_h).to(dev)
        step = _k14_step_fn(ffd, rg, rc, ev_h, dev)
        r = dict(digest=_digest(step()), Sp=int(rg.shape[0]), K=int(ev_h.shape[0]),
                 param_rows=getattr(ffd, "EVENT_PARAM_ROWS", None))
        assert rg.cpu().numpy().tolist() == rg_h.tolist(), "apply_events wrote its input"
        r["loop_ms"] = _loop_ms(step)
        r["device_us"], r["device_by_name_us"] = _median_trace(step)
        r["allocations_a_call"] = _allocations(step)
        r["split_us"] = _median_split(lambda: _k14_steps(build, ffd, rg, rc, ev_h, dev))
        r["split_total_us"] = sum(r["split_us"].values())
        k14[name] = r
    return dict(k12=k12, k14=k14, build_s=build_s, checkout=os.path.abspath(checkout),
                teams=teams, edits=data["edits"])


def _run_worker(checkout: str) -> dict:
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", checkout],
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"side_ab worker for {checkout} failed ({p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def _mean_floats(rs, key: str, name: str) -> dict:
    """The mean over runs of every float of rs[i][key][name], and of its
    host split."""
    first = rs[0][key][name]
    out = {k: statistics.mean(r[key][name][k] for r in rs) for k, v in first.items()
           if isinstance(v, float)}
    out["split_us"] = {k: statistics.mean(r[key][name]["split_us"][k] for r in rs)
                       for k in first["split_us"]}
    out["device_by_name_us"] = first["device_by_name_us"]
    return out


def main() -> int:
    import torch

    argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    if argv == ["--make-inputs"]:
        make_inputs(INPUTS)
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    alone = argv[:1] == ["--alone"]
    if alone:
        argv = argv[1:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("side_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--make-inputs"],
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"side_ab inputs failed:\n{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    inputs_s = time.perf_counter() - t0
    other = argv[0]
    turns = ([("other", other)] * 2 if alone
             else [("this", REPO), ("other", other), ("other", other), ("this", REPO)] * rounds)
    runs = {"this": [], "other": []}
    for side, checkout in turns:
        runs[side].append(_run_worker(checkout))
    summary = {}
    for key, names in (("k12", K12_SHAPES), ("k14", K14_SHAPES)):
        for name in names:
            s = {}
            for side, rs in runs.items():
                if not rs:
                    continue
                digests = {r[key][name]["digest"] for r in rs}
                assert len(digests) == 1, (name, side, digests)
                s[side] = _mean_floats(rs, key, name)
                last = rs[-1][key][name]
                for k in ("team", "teams_ms", "allocations_a_call", "param_rows"):
                    if k in last:
                        s[side][k] = last[k]
                s[side]["digest"] = digests.pop()
            if "other" in s and "this" in s:
                assert s["this"]["digest"] == s["other"]["digest"], (name, "the sides disagree")
                s["change"] = {k: s["this"][k] / s["other"][k] - 1.0 for k in s["this"]
                               if isinstance(s["this"][k], float) and s["other"].get(k)}
            r0 = (runs["this"] or runs["other"])[0][key][name]
            s["shape"] = {k: r0[k] for k in ("Sp", "Ep", "Gp", "R", "E", "G", "top_k",
                                             "take_nnz", "K") if k in r0}
            summary[f"{key}_{name}"] = s
    line = dict(shapes=summary, card=card, rounds=rounds, inputs_s=inputs_s,
                build_s={side: [r["build_s"] for r in rs] for side, rs in runs.items() if rs},
                edits=(runs["this"] or runs["other"])[0]["edits"],
                this=None if alone else REPO, other=os.path.abspath(other),
                ncu="not run: ncu does not work on the chip machine",
                wall_s=time.perf_counter() - t0)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "side_ab.json"), "w") as f:
        json.dump(dict(side_ab=line, runs=runs), f, indent=1)
    print(json.dumps({"side_ab": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
