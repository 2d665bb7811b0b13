"""The cluster scans' launch geometry, scratch and row budget on the CPU.

K1, K6, K7 and their sparse twins run one solve on one thread-block
cluster (csrc/ffd_kernels.cu ffd_cluster_kernel, ffd_ladder_kernel: 16
CTAs of 512 threads where the card allows, else 8); K4, K15 and K17 keep
one block of 1 024 threads. The kernels run only on the card
(chip_smoke.py phases 12 and 13 hold them against their plain versions
there); here:

- solver/cuda/ffd.py team_chunks mirrors the kernel's split of node and
  claim rows over a team (thread_chunk, warp_chunk, cta_chunk,
  lane_chunk): for every row count 1..2 000 and CL 1, 2, 8, 16 and the
  one-block team, each split covers every row exactly once, in order, and
  a CTA's rows are the union of its warps' rows; the split puts rows on
  every CTA while there are as many rows as CTAs.
- cluster_scratch_words leaves every CTA its own k_t / fit_t / k_cap and
  scat rows after the scan's shared scratch; ladder_scratch_words leaves
  the ladder's CTAs the same rows and puts the current attempt's take rows
  and leftover slots after them.
- check_kernel_limits at the H100's row budget with the cluster
  instances' static share (216 832 B of launch-sized rows, measured on an
  H100 80GB HBM3: PERF.md §6): the 260-app and 1 000-app hostname
  fleets fit, the Q and V caps are 9 034 and 21 683 rows, a zoned launch
  at exactly the budget passes and one byte less raises; the same for the
  relax ladder's dispatch (the ladder cluster instances share the budget).
- floordiv_check (the kernels' exact division, held against the floor on
  the card) takes the plain floor on CPU tensors; cluster_info is None on
  the CPU.

Every output is an integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.backend import UnsupportedInput
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_qrows import APPS_260, _dims, hostname_apps
from tests.test_torch_solver import pod

H100_ROWS_BUDGET = 216_832  # B: the least row budget over the scan instances, H100 80GB HBM3
ZONE = "topology.kubernetes.io/zone"


def _covers(chunks, n) -> bool:
    """The [lo, hi) chunks, in order, tile [0, n) exactly once (an empty
    chunk sits where the last one ended, or at n)."""
    lo, hi = chunks[:, 0], chunks[:, 1]
    ends = np.concatenate([[0], np.maximum.accumulate(hi)[:-1]])
    full = lo < hi
    return bool((hi >= lo).all() and (lo[full] == ends[full]).all()
                and ((lo[~full] == ends[~full]) | (lo[~full] == n)).all() and hi.max() == n)


@pytest.mark.parametrize("cl", [0, 1, 2, 8, 16])
def test_team_chunks_cover_every_row_once(cl):
    """Every split of n rows over a team covers each row exactly once and in
    order: the node rows over its threads, the claim rows over its warps
    and their lanes (the pour's prefix runs in that order), and a CTA's
    rows are its warps' rows; every CTA holds rows while there are as many
    rows as CTAs."""
    ctas = max(cl, 1)
    nwb = (tffd.NT if cl == 0 else tffd.CLUSTER_THREADS) // 32
    for n in range(1, 2001):
        ch = tffd.team_chunks(n, cl)
        assert ch["threads"].shape == (ctas * nwb * 32, 2) and ch["lanes"].shape == (ctas * nwb * 32, 2)
        assert ch["warps"].shape == (ctas * nwb, 2) and ch["ctas"].shape == (ctas, 2)
        for key in ("threads", "warps", "ctas", "lanes"):
            assert _covers(ch[key], n), (cl, n, key)
        w = ch["warps"].reshape(ctas, nwb, 2)
        assert (ch["ctas"][:, 0] == w[:, 0, 0]).all() and (ch["ctas"][:, 1] == w[:, -1, 1]).all()
        rows = ch["ctas"][:, 1] - ch["ctas"][:, 0]
        assert rows.max() == -(-n // ctas) and (rows > 0).sum() == min(n, -(-n // -(-n // ctas)))


def test_cluster_scratch_gives_every_cta_its_own_rows():
    E, M, T, Z = 8, 512, 768, 3
    shared = tffd.scan_scratch_words(E, M, T, Z)
    assert tffd.cluster_scratch_words(E, M, T, Z) == shared + tffd.MAX_CL * (3 * T + 2 * M)
    assert tffd.MAX_CL == 16 and tffd.CLUSTER_THREADS * tffd.MAX_CL >= tffd.NT


def test_ladder_scratch_gives_every_cta_and_the_attempt_its_own_rows():
    """The ladder's scratch as the kernel lays it out: the scan's shared
    rows, MAX_CL CTAs' own rows, then the attempt's take_e [E], take_c [M]
    and leftover [S] at the offset the wrapper passes
    (cluster_scratch_words); no two pieces overlap and all fit."""
    for E, M, T, Z, S in ((8, 512, 768, 3, 64), (0, 64, 128, 1, 16), (2_016, 1_024, 732, 32, 1_008)):
        shared = tffd.scan_scratch_words(E, M, T, Z)
        cta = 3 * T + 2 * M
        off = tffd.cluster_scratch_words(E, M, T, Z)
        pieces = [(0, shared)] + [(shared + r * cta, shared + (r + 1) * cta) for r in range(tffd.MAX_CL)]
        pieces += [(off, off + E), (off + E, off + E + M), (off + E + M, off + E + M + S)]
        for (a0, a1), (b0, b1) in zip(pieces, pieces[1:]):
            assert a1 <= b0, (E, M, T, Z, S)
        assert pieces[-1][1] == tffd.ladder_scratch_words(E, M, T, Z, S)


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: H100_ROWS_BUDGET)


def test_caps_at_the_cluster_budget(h100):
    """The Q cap (24 B a row) and the V cap (10 B a row) at the budget."""
    assert tffd.q_cap("cuda") == H100_ROWS_BUDGET // 24 == 9_034
    assert tffd.zone_v_cap("cuda") == H100_ROWS_BUDGET // 10 == 21_683


@pytest.mark.parametrize("apps", [260, 1_000])
def test_hostname_fleets_fit_the_cluster_budget(apps, h100):
    """The 260-app fleet (Qp 264) and the 1 000-app fleet still launch on
    the card: their Q rows stay far inside the budget."""
    spec = APPS_260 if apps == 260 else dict(pods=hostname_apps(1_000), pools=[dict(name="default")])
    dims, host_args, zone = _dims(spec)
    assert dims["Qp"] >= apps and not zone
    tbackend.check_kernel_limits(dims, host_args, zone, "cuda")


def test_zoned_rows_at_the_cluster_budget(monkeypatch):
    """A zoned fleet's Q and V rows pass at exactly the budget they need and
    raise one byte below it; at the H100's budget a launch that needs one
    byte more than the budget raises."""
    sel = {"app": "w"}
    spec = dict(pods=hostname_apps(20) + [pod(f"w{i}", labels=sel, tsc=[(1, ZONE, sel)])
                                          for i in range(6)],
                pools=[dict(name="default")])
    dims, host_args, zone = _dims(spec)
    need = tffd.scan_rows_bytes(dims["Qp"], dims["Qp"], dims["Vp"], dims["Vp"], True)
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: need)
    tbackend.check_kernel_limits(dims, host_args, zone, "cuda")
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: need - 1)
    with pytest.raises(UnsupportedInput, match="shared rows"):
        tbackend.check_kernel_limits(dims, host_args, zone, "cuda")
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: H100_ROWS_BUDGET)
    wide = dict(dims, Qp=(H100_ROWS_BUDGET - 10 * dims["Vp"]) // 24 + 1)
    with pytest.raises(UnsupportedInput, match="shared rows"):
        tbackend.check_kernel_limits(wide, host_args, zone, "cuda")


def test_division_and_clusters_on_the_cpu():
    """On CPU tensors floordiv_check is the plain floor (the reference the
    card's exact division is held to), and there is no cluster to pick."""
    num = torch.tensor([0, 1, -1, 7, -7, 2**31 - 1, -2**31, -2**31 + 1], dtype=torch.int32)
    den = torch.tensor([1, 2, 3, 7, 65_536, 2**31 - 1], dtype=torch.int32)
    got = tffd.floordiv_check(num, den)
    want = [[a // b for a in num.tolist()] for b in den.tolist()]
    assert got.dtype == torch.int32 and got.tolist() == want
    assert tffd.cluster_info("cpu") is None


def _ladder_limits(monkeypatch, inp):
    """(dims, host_args, zone) that TorchSolver's ladder dispatch hands to
    check_kernel_limits for `inp` (on the CPU, where nothing is checked)."""
    seen = []
    real = tbackend.check_kernel_limits

    def record(dims, host_args, zone, device):
        seen.append((dims, host_args, zone))
        return real(dims, host_args, zone, device)

    monkeypatch.setattr(tbackend, "check_kernel_limits", record)
    solver = tbackend.TorchSolver(device="cpu")
    solver.solve(inp)
    monkeypatch.setattr(tbackend, "check_kernel_limits", real)
    assert solver.stats["ladder_solves"] == 1 and len(seen) == 1
    return seen[0]


def test_ladder_rows_at_the_cluster_budget(monkeypatch):
    """The relax ladder's dispatch (the ladder cluster instances, K6 / K6s
    zoned) against the row budget: its Q and V rows pass at exactly the
    budget they need and raise one byte below it; at the H100's budget the
    widest Q rows that fit pass and one row more raises."""
    import chip_smoke as cs

    dims, host_args, zone = _ladder_limits(monkeypatch, cs.build_relax_walk_input(24))
    assert zone and dims["Vp"] >= 8
    need = tffd.scan_rows_bytes(dims["Qp"], dims["Qp"], dims["Vp"], dims["Vp"], True)
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: need)
    tbackend.check_kernel_limits(dims, host_args, zone, "cuda")
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: need - 1)
    with pytest.raises(UnsupportedInput, match="shared rows"):
        tbackend.check_kernel_limits(dims, host_args, zone, "cuda")
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: H100_ROWS_BUDGET)
    widest = (H100_ROWS_BUDGET - 10 * dims["Vp"]) // 24
    tbackend.check_kernel_limits(dict(dims, Qp=widest), host_args, zone, "cuda")
    with pytest.raises(UnsupportedInput, match="shared rows"):
        tbackend.check_kernel_limits(dict(dims, Qp=widest + 1), host_args, zone, "cuda")
