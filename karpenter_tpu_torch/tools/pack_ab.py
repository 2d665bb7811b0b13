#!/usr/bin/env python3
"""The delta pack (the claim-delta fetch buffer) of this checkout against
another checkout's, on one card.

Each side runs in a process of its own with its checkout's package first on
sys.path, so the two sides' wrappers, kernels and backend `_pack_outputs_delta`
are each their own; only the four FFD scan libraries are built (cached
under the checkout's build/). The pack's inputs are made once, by this checkout's
chip_smoke builders, and saved (build/karpenter_tpu_torch/pack_ab_inputs.pt): the kernel
arguments of the surge, config 3 (the sparse index tables, as TorchSolver()
gates it), config 4, surge_e2e, constraint_wide, config3_soft's ladder
dispatch (its union index tables) and class_contended's cold inner solve
(Sp 1 008, Ep 2 016), each with the claim bucket its solve ends at, and
chip_smoke.build_claim_table's synthetic table at M 8 192. Every worker runs
the scans itself (they are the same in both checkouts), then on each shape:

- loop_ms: CUDA events around CALLS calls of `_pack_outputs_delta`;
- device_us: torch.profiler over one call (the median of TRACES traces),
  with the device time of every kernel, copy and set by name, and the
  kernels a call (`launches`);
- the solve's way (not for the synthetic table): the scan, then the pack
  and its fetch (`.cpu()`), host clock (scan_pack_fetch_ms), against the
  scan alone ended by a synchronize (scan_ms): pack_fetch_ms is the
  difference of the medians over SOLVES;
- the device stage of chip_smoke.breakdown split by one more CUDA event
  between the scan and the pack (split_scan_ms, split_pack_ms, medians);
- a digest of the fetched buffer, which must agree between the sides.

Usage: python3 karpenter_tpu_torch/tools/pack_ab.py OTHER_CHECKOUT [--rounds N]
       python3 karpenter_tpu_torch/tools/pack_ab.py --alone CHECKOUT
OTHER_CHECKOUT (for example the parent commit unpacked with `git archive`):
N rounds (1 by default) of the turns this, other, other, this. --alone:
CHECKOUT's pack alone, twice (the parent's numbers before a change; the
inputs are still made by this checkout, whose scans it shares). Prints
the card's name and power limit, then one JSON object {"pack_ab": ...}
(also written to chiprun_out/pack_ab.json). Exits non-zero without CUDA.
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
INPUTS = os.path.join(REPO, "build", "karpenter_tpu_torch", "pack_ab_inputs.pt")

CALLS = 50  # pack calls a loop timing
TRACES = 5  # profiled calls a shape
SOLVES = 10  # scan (+ pack + fetch) timings a shape
SHAPES = ("surge", "config3", "config4", "surge_e2e", "constraint_wide", "config3_soft",
          "class_contended", "table_8k")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_inputs(path: str) -> None:
    """The shapes' scan arguments (or the synthetic table's pack inputs),
    on the CPU, saved to `path`."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from karpenter_tpu_torch.solver.encode import use_sparse_constraints

    dev = torch.device("cuda")
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    shapes = {}
    solo = {"surge": cs.build_input(cs.PODS), "config3": cs.build_config3_input(cs.PODS),
            "config4": cs.build_config4_input(cs.PODS),
            "surge_e2e": cs.build_e2e_input(cs.PODS, cs.NODES),
            "constraint_wide": cs.build_constraint_wide_input(4_800, 40),
            "class_contended": cs.build_class_input(**cs.CLASS_KW)}
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.convert import args_to_torch
    from karpenter_tpu_torch.solver.cuda import ffd
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    for name, inp in solo.items():
        # kernel_phase's scan without its checks: the claim bucket doubles on
        # saturation as the solve's does
        enc = encode(quantize_input(inp))
        host_args, dims, _ = tb.host_kernel_args(enc, tb.TorchSolver._bucket)
        args = args_to_torch(host_args, dev)
        total = int(sum(len(p) for p in enc.group_pods))
        zone = enc.V > 0
        M = tb.initial_claim_bucket(total, cs.MAX_CLAIMS)
        while True:
            out = ffd.ffd_solve(*args, max_claims=M, zone_engine=zone)
            if int(out.state.used) < M or M >= cs.MAX_CLAIMS:
                break
            M = min(2 * M, cs.MAX_CLAIMS)
        Sp, Ep = out.take_e.shape
        sparse = cpu(cs.sparse_tables(enc, Sp, dev)) if use_sparse_constraints(enc) else None
        shapes[name] = dict(kind="ckpt", args=cpu(args), sparse=sparse, ladder=None, M=M,
                            zone=zone, cap=tb.delta_capacity(total, Sp, Ep, M),
                            cap_u=tb.delta_uniq_capacity(Sp, M))
    ph = cs.ladder_phase(cs.build_config3_soft_input(cs.PODS), dev, plain=False)
    enc, lad, dims = ph["enc"], ph["lad"], ph["dims"]
    sp = cs.sparse_tables(enc, dims["Sp"], dev, run_ladder=lad.cpu().numpy()[:len(enc.run_group)])
    Sp, Ep = ph["out"].take_e.shape
    shapes["config3_soft"] = dict(
        kind="ladder", args=cpu(ph["args"]), sparse=cpu(sp), ladder=lad.cpu(), M=ph["M"],
        zone=ph["zone"], cap=tb.delta_capacity(ph["n"], Sp, Ep, ph["M"]),
        cap_u=tb.delta_uniq_capacity(Sp, ph["M"]))
    out, cap, cap_u = cs.build_claim_table(torch.device("cpu"))
    st = out.state
    shapes["table_8k"] = dict(kind="table", cap=cap, cap_u=cap_u, tensors=dict(
        take_e=out.take_e, take_c=out.take_c, leftover=out.leftover, c_mask=st.c_mask,
        c_zc_bits=st.c_zc_bits, c_gbits=st.c_gbits, c_pool=st.c_pool, used=st.used))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(shapes, path)


def _scan_fn(ffd, sh, dev):
    """The shape's scan as its solve dispatches it (K7 / K7s, or the
    ladder's K6s), returning the FFDOutput."""
    args = tuple(t.to(dev) for t in sh["args"])
    sparse = None if sh["sparse"] is None else tuple(t.to(dev) for t in sh["sparse"])
    kw = dict(max_claims=sh["M"], zone_engine=sh["zone"])
    if sh["kind"] == "ladder":
        lad = sh["ladder"].to(dev)
        return lambda: ffd.ffd_solve_ladder_sparse(lad, *sparse, *args, **kw)
    ring = dict(ckpt_every=16, n_ckpt=4)
    if sparse is not None:
        return lambda: ffd.ffd_solve_ckpt_sparse(*sparse, *args, **kw, **ring)[0]
    return lambda: ffd.ffd_solve_ckpt(*args, **kw, **ring)[0]


def _device_trace(fn):
    """(device µs of one call, {name: µs}, kernels launched) from a
    torch.profiler trace of fn()."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, kernels = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
        kernels += not name.lower().startswith(("memcpy", "memset"))
    return sum(by_name.values()), by_name, kernels


def worker(checkout: str) -> dict:
    """One side's measurements (see the module docstring)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import types

    import torch

    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.cuda import build, ffd

    assert os.path.abspath(tb.__file__).startswith(os.path.abspath(checkout)), tb.__file__
    build.SOURCES = {k: v for k, v in build.SOURCES.items() if k.startswith("ffd_")}
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    shapes = torch.load(INPUTS, weights_only=False)
    res = {}
    for name in SHAPES:
        sh = shapes[name]
        scan = None
        if sh["kind"] == "table":
            t = {k: v.to(dev) for k, v in sh["tensors"].items()}
            out = types.SimpleNamespace(
                take_e=t["take_e"], take_c=t["take_c"], leftover=t["leftover"],
                state=types.SimpleNamespace(**{k: t[k] for k in (
                    "c_mask", "c_zc_bits", "c_gbits", "c_pool", "used")}))
        else:
            scan = _scan_fn(ffd, sh, dev)
            out = scan()
        cap, cap_u = sh["cap"], sh["cap_u"]

        def pack():
            return tb._pack_outputs_delta(out, cap, cap_u)

        flat = pack().cpu().numpy()
        r = dict(digest=hashlib.sha256(flat.tobytes()).hexdigest()[:16], words=int(flat.size),
                 overflow=int(flat[0]), n=int(flat[1]), n_u=int(flat[2]),
                 Sp=int(out.take_e.shape[0]), Ep=int(out.take_e.shape[1]),
                 M=int(out.state.c_mask.shape[0]), T=int(out.state.c_mask.shape[1]),
                 cap=cap, cap_u=cap_u)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        pack()
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(CALLS):
            pack()
        ev1.record()
        torch.cuda.synchronize()
        r["loop_ms"] = ev0.elapsed_time(ev1) / CALLS
        traces = sorted((_device_trace(pack) for _ in range(TRACES)), key=lambda x: x[0])
        r["device_us"], r["device_by_name_us"], r["launches"] = traces[len(traces) // 2]
        if scan is not None:
            spf, so, split_scan, split_pack = [], [], [], []
            ev2 = torch.cuda.Event(enable_timing=True)
            for _ in range(SOLVES):
                torch.cuda.synchronize()
                a = time.perf_counter()
                o = scan()
                tb._pack_outputs_delta(o, cap, cap_u).cpu()
                spf.append((time.perf_counter() - a) * 1e3)
                torch.cuda.synchronize()
                a = time.perf_counter()
                scan()
                torch.cuda.synchronize()
                so.append((time.perf_counter() - a) * 1e3)
                ev0.record()
                o = scan()
                ev2.record()
                tb._pack_outputs_delta(o, cap, cap_u)
                ev1.record()
                torch.cuda.synchronize()
                split_scan.append(ev0.elapsed_time(ev2))
                split_pack.append(ev2.elapsed_time(ev1))
            r.update(scan_pack_fetch_ms=statistics.median(spf), scan_ms=statistics.median(so),
                     split_scan_ms=statistics.median(split_scan),
                     split_pack_ms=statistics.median(split_pack))
            r["pack_fetch_ms"] = r["scan_pack_fetch_ms"] - r["scan_ms"]
        res[name] = r
    return dict(shapes=res, build_s=build_s, checkout=os.path.abspath(checkout))


def _run_worker(checkout: str) -> dict:
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", checkout],
                       capture_output=True, text=True, timeout=1200)
    if p.returncode != 0:
        raise RuntimeError(f"pack_ab worker for {checkout} failed ({p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


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
        print("pack_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--make-inputs"],
                       capture_output=True, text=True, timeout=1200)
    if p.returncode != 0:
        raise RuntimeError(f"pack_ab inputs failed:\n{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    inputs_s = time.perf_counter() - t0
    other = argv[0]
    turns = ([("other", other)] * 2 if alone
             else [("this", REPO), ("other", other), ("other", other), ("this", REPO)] * rounds)
    runs = {"this": [], "other": []}
    for side, checkout in turns:
        runs[side].append(_run_worker(checkout))
    summary = {}
    for name in SHAPES:
        s = {}
        for side, rs in runs.items():
            if not rs:
                continue
            digests = {r["shapes"][name]["digest"] for r in rs}
            assert len(digests) == 1, (name, side, digests)
            keys = [k for k, v in rs[0]["shapes"][name].items() if isinstance(v, float)]
            s[side] = {k: statistics.mean(r["shapes"][name][k] for r in rs) for k in keys}
            s[side]["launches"] = rs[0]["shapes"][name]["launches"]
            s[side]["device_by_name_us"] = rs[-1]["shapes"][name]["device_by_name_us"]
            s[side]["digest"] = digests.pop()
        if "other" in s and "this" in s:
            assert s["this"]["digest"] == s["other"]["digest"], (name, "the two sides disagree")
            s["change"] = {k: s["this"][k] / s["other"][k] - 1.0 for k in s["this"]
                           if isinstance(s["this"][k], float) and s["other"].get(k)}
        s["shape"] = {k: (runs["this"] or runs["other"])[0]["shapes"][name][k] for k in (
            "Sp", "Ep", "M", "T", "cap", "cap_u", "words", "overflow", "n", "n_u")}
        summary[name] = s
    line = dict(shapes=summary, card=card, rounds=rounds, inputs_s=inputs_s,
                build_s={side: [r["build_s"] for r in rs] for side, rs in runs.items() if rs},
                this=None if alone else REPO, other=os.path.abspath(other),
                wall_s=time.perf_counter() - t0)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "pack_ab.json"), "w") as f:
        json.dump(dict(pack_ab=line, runs=runs), f, indent=1)
    print(json.dumps({"pack_ab": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
