"""K13's feasible-cell layout and cost model, on the CPU.

(a) admm_layout_plain (karpenter_tpu_torch/solver/cuda/convex.py), the
    plain version of the layout the kernel builds on the card, against a
    numpy construction on chip_smoke.py's 20 seeded and 9 adversarial
    tables and its fully dense ones: the CSR (row_ptr, col) and the column
    tiles (32 adjacent columns' rows: tptr, trow, tmask, tbase into the
    CSR) both round-trip to feas, columns ascend within a row and rows
    within a tile.
(b) admm_pack_plain's X is exactly 0 on every masked cell at horizons 0,
    1, 2, 10 and 400: the kernel keeps X only on the feasible cells.
(c) chip_smoke.admm_cost pinned on BASELINE config 5's shape (Sp 2 000,
    Np 10 000, R 3, 3 002 000 feasible cells, 400 iterations).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from karpenter_tpu_torch.solver.cuda import convex as tcc

torch.set_num_threads(1)

TABLES = {f"seed{seed}": cs.admm_seeded(seed) for seed in range(20)}
TABLES.update({name: t[0] for name, t in cs.admm_adversarial().items()})
DENSE = {f"dense_{Sp}x{Np}": cs.admm_dense(Sp, Sp, Np, R) for Sp, Np, R in cs.ADMM_DENSE}
HORIZONS = (0, 1, 2, 10, 400)


def numpy_layout(feas: np.ndarray):
    """(row_ptr, col, tptr, trow, tmask, tbase) built cell by cell in numpy."""
    Sp, Np = feas.shape
    tiles = -(-Np // 32)
    row_ptr = np.concatenate([[0], np.cumsum(feas.sum(axis=1))])
    col = np.concatenate([np.flatnonzero(feas[s]) for s in range(Sp)] + [np.zeros(0, np.int64)])
    csr_pos = np.full(feas.shape, -1, np.int64)
    csr_pos[feas] = np.arange(int(feas.sum()))  # row-major: the CSR's order
    tptr, trow, tmask, tbase = [0], [], [], []
    for t in range(tiles):
        for s in range(Sp):
            cells = np.flatnonzero(feas[s, 32 * t:32 * t + 32])
            if len(cells):
                trow.append(s)
                tmask.append(int(sum(1 << int(c) for c in cells)))
                tbase.append(int(csr_pos[s, 32 * t + cells[0]]))
        tptr.append(len(trow))
    return tuple(np.asarray(v, np.int64) for v in (row_ptr, col, tptr, trow, tmask, tbase))


@pytest.mark.parametrize("name", sorted(TABLES) + sorted(DENSE))
def test_layout_plain_matches_numpy(name):
    feas = {**TABLES, **DENSE}[name][4]
    got = [t.numpy() for t in tcc.admm_layout_plain(torch.from_numpy(feas))]
    want = numpy_layout(feas)
    for g, w, field in zip(got, want, tcc.LAYOUT_FIELDS):
        assert g.dtype == np.int64 and np.array_equal(g, w), field
    row_ptr, col, tptr, trow, tmask, tbase = got
    Sp, Np = feas.shape
    nnz = int(feas.sum())
    assert row_ptr[-1] == len(col) == nnz and tptr[-1] == len(trow) == len(tmask) == len(tbase)
    # CSR round trip; columns ascend within each row
    rows = np.repeat(np.arange(Sp), np.diff(row_ptr))
    back = np.zeros_like(feas)
    back[rows, col] = True
    assert np.array_equal(back, feas)
    assert all(np.all(np.diff(col[row_ptr[s]:row_ptr[s + 1]]) > 0) for s in range(Sp))
    # the tiles round trip through the CSR: bit l of an entry of tile t is
    # cell (row, 32 t + l), at CSR position tbase + the bits below l; rows
    # ascend within each tile
    back = np.zeros_like(feas)
    for t in range(len(tptr) - 1):
        assert np.all(np.diff(trow[tptr[t]:tptr[t + 1]]) > 0)
        for e in range(tptr[t], tptr[t + 1]):
            assert tmask[e] > 0
            bits = [l for l in range(32) if tmask[e] >> l & 1]
            for i, l in enumerate(bits):
                p = tbase[e] + i
                assert rows[p] == trow[e] and col[p] == 32 * t + l
                back[trow[e], 32 * t + l] = True
    assert np.array_equal(back, feas)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_plain_x_is_zero_on_masked_cells(name):
    args = [torch.from_numpy(a) for a in TABLES[name]]
    masked = ~args[4]
    for h in HORIZONS:
        X, _ = tcc.admm_pack_plain(*args, cs.CONVEX_TOL, h)
        assert X.dtype == torch.float32 and tuple(X.shape) == tuple(args[4].shape)
        assert torch.all(X[masked] == 0), h
        assert torch.isfinite(X).all(), h


def test_admm_cost_on_config5_shape():
    cost = cs.admm_cost(2_000, 10_000, 3, 3_002_000, 400)
    # inputs once (run_req, run_count, cand_cap, cand_cost: 192 000 B; the
    # mask 2e7 B; tol), X (8e7 B) and conv once
    assert cost["bytes"] == 192_000 + 20_000_000 + 4 + 80_000_000 + 4 == 100_192_008
    assert cost["ops"] == 400 * 3_002_000 * (4 * 3 + 17) == 34_823_200_000
    assert cost["dense_reread_bytes"] == 400 * 2 * 10**7 * 9 + 192_000 + 2 * 10**7 + 8 * 10**7
    ms, by = cs.bound(cost["bytes"], cost["ops"], cs.PEAK_F32_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(0.51975, rel=1e-4)
    dense_ms, dense_by = cs.bound(cost["dense_reread_bytes"], 400 * 2 * 10**7 * 29,
                                  cs.PEAK_F32_OPS_PER_S)
    assert dense_by == "bytes" and dense_ms == pytest.approx(21.522, rel=1e-4)
