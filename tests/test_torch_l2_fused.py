"""The fused L2 matcher's semantics (``ops/matching.py l2_topk_fused``,
kernel L3 on a card) on the CPU: its plain version (``_l2_topk_screened``)
and a step-by-step emulation of the kernel's design (the rows cut into
``fused_splits`` splits of 128-row tiles, each tile's rows split between
two threads a query, a running k-best list each in (distance, row) order
from k ``(BIG_DIST, -1)`` slots, then the merge of the lists) against the
parent's chunk loop (``l2_topk_chunked``: a tile a chunk, ``stable_topk``,
``_merge_topk``), distances and rows bit for bit: ties to the lower row
across tiles, halves and splits, the start's slots before any row at or
past ``BIG_DIST``, fewer valid rows than k, partial tiles and chunks."""

import numpy as np
import pytest
import torch

from tod_tpu_torch.ops import matching as tm

torch.set_num_threads(1)


def _rows(rng, n: int) -> np.ndarray:
    """SIFT-like rows (non-negative, unit norm, clipped at 0.2) and signed
    ones, half each."""
    x = rng.random((n // 2, 128)) ** 3
    x = np.minimum(x / np.linalg.norm(x, axis=1, keepdims=True), 0.2)
    return np.concatenate([x, rng.standard_normal((n - n // 2, 128))]
                          ).astype(np.float32)


def _before(a, b) -> bool:
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _insert(best: list, cand, k: int) -> None:
    if _before(cand, best[k - 1]):
        best[k - 1] = cand
        best.sort(key=lambda e: (e[0], e[1]))


def emulate_fused(q: torch.Tensor, db: torch.Tensor, n_valid: int, k: int):
    """The kernel's algorithm over the plain tile's distances."""
    dist = tm.l2_distances_torch(q, db, n_valid, "chain").numpy()
    n_split, per = tm.fused_splits(len(q), n_valid)
    tiles = -(-n_valid // 128)
    out_d = np.full((len(q), k), tm.BIG_DIST, np.float32)
    out_i = np.full((len(q), k), -1, np.int32)
    for qi in range(len(q)):
        lists = []
        for split in range(n_split):
            for half in range(2):
                best = [(np.float32(tm.BIG_DIST), -1)] * k
                for t in range(split * per, min(tiles, (split + 1) * per)):
                    for c in range(t * 128 + 64 * half,
                                   min(n_valid, t * 128 + 64 * half + 64)):
                        _insert(best, (dist[qi, c], c), k)
                lists.append(best)
        best = [(np.float32(tm.BIG_DIST), -1)] * k
        for lst in lists:
            for cand in lst:
                _insert(best, cand, k)
        out_d[qi] = [d for d, _ in best]
        out_i[qi] = [i for _, i in best]
    return torch.from_numpy(out_d), torch.from_numpy(out_i)


def _same(got, want) -> None:
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1].to(torch.int32), want[1].to(torch.int32))


@pytest.mark.parametrize("n_q, n_rows, n_valid, k", [
    (3, 4096, 4096, 5),          # one chunk, 32 tiles in 32 splits
    (2, 8192, 5000, 8),          # a partial chunk and tile
    (4, 4096, 3, 5),             # fewer valid rows than k: the BIG slots
    (1, 4096, 200, 1)])          # one query, k = 1
def test_fused_design_equals_the_chunk_loop(n_q, n_rows, n_valid, k):
    rng = np.random.default_rng(n_q + n_valid)
    q = torch.from_numpy(_rows(rng, n_q))
    db = _rows(rng, n_rows)
    # ties across halves, tiles and splits: copies of one row, and of a
    # query (distance 0)
    db[[1, 70, 130, 600, 3000]] = db[0]
    db[[2, 2500]] = q[0].numpy()
    db = torch.from_numpy(db)
    want = tm.l2_topk_chunked(q, db, n_valid, k, 4096, "chain")
    assert tm.fused_splits(n_q, n_valid)[0] > 1 or n_valid <= 128
    _same(emulate_fused(q, db, n_valid, k), want)
    _same(tm.l2_topk_fused(q, db, n_valid, k), want)


def test_start_slots_come_before_far_rows():
    """Rows at or past BIG_DIST never displace the start's (BIG_DIST, -1)
    slots, in the chunk loop as in the fused design."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_rows(rng, 2))
    db = _rows(rng, 4096)
    db[5:] = 3000.0                      # squared distances ~1.15e9
    db = torch.from_numpy(db)
    want = tm.l2_topk_chunked(q, db, 4096, 8, 4096, "chain")
    assert (want[1] == -1).any() and (want[0] == tm.BIG_DIST).any()
    _same(emulate_fused(q, db, 4096, 8), want)
    _same(tm.l2_topk_fused(q, db, 4096, 8), want)


def test_splits_cover_every_tile_once():
    for n_q, n_valid in ((5000, 83468), (7, 83468), (16384, 86016), (1, 5),
                         (513, 10000), (128, 128), (129, 129)):
        n_split, per = tm.fused_splits(n_q, n_valid)
        tiles = -(-n_valid // 128)
        assert (n_split - 1) * per < tiles <= n_split * per
        assert -(-n_q // 128) * n_split >= min(tiles, 8)


def test_l2_topk_takes_the_fused_matcher_for_the_chain_order():
    """On a CPU tensor l2_topk and l2_topk_fused are the plain version;
    the wrapper refuses what the kernel cannot take and launches nothing
    here."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_rows(rng, 5))
    db = torch.from_numpy(_rows(rng, 4096))
    before = tm.l2_topk_fused.launches
    _same(tm.l2_topk(q, db, 4000), tm.l2_topk_fused(q, db, 4000, 5))
    assert tm.l2_topk_fused.launches == before
    for bad in ((q.double(), db, 5), (q[:, :64], db, 5), (q, db, 9),
                (q, db, 0), (q, db.to("meta"), 5)):
        with pytest.raises(ValueError):
            tm.l2_topk_fused(bad[0], bad[1], 100, bad[2])
