"""Parity of the port's global-kNN matcher (tod_tpu_torch.ops.hamming and
ops.matching) with tod_tpu.ops.pallas.hamming and tod_tpu.ops.matching.

On the CPU the port's wrapper runs its plain twin of kernel B5; it must
equal, bit for bit, the reference's Pallas kernel run in interpret mode
(as tests/test_pallas_hamming.py runs it) and the reference's streaming
XLA matcher after the radius cut. The CUDA kernel itself is compared with
the twin in test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tod_tpu.ops import matching as jmatch
from tod_tpu.ops.pallas import hamming as jham
from tod_tpu_torch.ops import hamming as tham
from tod_tpu_torch.ops import matching as tmatch
from tod_tpu_torch.ops.segmented import TWIN_ROWS
from tod_tpu_torch.utils.smoke_catalog import (HAMMING_TILE_TIES,
                                               edge_case_arrays_hamming)

torch.set_num_threads(1)

CHUNK = 2048
N_ROWS = 3 * CHUNK


def _case(seed, n_q=256):
    """Rows over three 2048-row chunks with row 10 duplicated across both
    chunk boundaries and inside one chunk, and queries with 0, 1, a few
    and many hits within 35."""
    db, q = edge_case_arrays_hamming(seed, N_ROWS, n_q, (CHUNK, 2 * CHUNK))
    return q, db


def _pallas(q, db, n_valid, k, radius):
    bits_t, pop = jham.pack_db_bits(jnp.asarray(db), jnp.int8)
    d, i = jham.hamming_topk_fused(jnp.asarray(q), bits_t, pop, n_valid,
                                   k=k, radius=radius, q_tile=128,
                                   db_chunk=CHUNK)
    return np.asarray(d), np.asarray(i)


def _cut(d, i, radius):
    """The reference XLA matcher's output after the radius cut, in the
    kernel's convention: a dropped slot is (1e9, -1)."""
    r = 256 if radius is None else radius
    keep = (d <= r) & (d < jmatch.BIG_DIST)
    return np.where(keep, d, jmatch.BIG_DIST).astype(np.float32), \
        np.where(keep, i, -1).astype(np.int32)


def _twin(q, db, n_valid, k, radius):
    d, i = tham.hamming_topk_fused(
        torch.from_numpy(q), tham.pack_db_bits(torch.from_numpy(db)),
        n_valid, k=k, radius=radius)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("radius", [None, 35])
def test_twin_matches_interpret_kernel_and_xla_matcher(k, radius):
    q, db = _case(k)
    n_valid = N_ROWS - 100          # the last chunk ends in padding
    before = tham.hamming_topk_fused.launches
    d_t, i_t = _twin(q, db, n_valid, k, radius)
    assert tham.hamming_topk_fused.launches == before   # no kernel on a CPU
    d_p, i_p = _pallas(q, db, n_valid, k, radius)
    np.testing.assert_array_equal(d_t, d_p)
    np.testing.assert_array_equal(i_t, i_p)
    d_x, i_x = jmatch.hamming_topk(jnp.asarray(q), jnp.asarray(db), n_valid,
                                   k=k, chunk=CHUNK)
    d_c, i_c = _cut(np.asarray(d_x), np.asarray(i_x), radius)
    np.testing.assert_array_equal(d_t, d_c)
    np.testing.assert_array_equal(i_t, i_c)
    # the planted ties: row 10, then its copies in row order, across both
    # chunk boundaries; holes after every real match
    dups = [10, 1000, 1001, 1002, 1003, CHUNK - 3, CHUNK - 2, CHUNK - 1,
            CHUNK, CHUNK + 1, CHUNK + 2, 2 * CHUNK - 3]
    assert i_t[0].tolist() == dups[:k] and (d_t[0] == 0).all()
    assert i_t[1].tolist() == dups[:k] and (d_t[1] == 1).all()
    # ties across the tensor-core sweep's fragments, lanes and tiles
    assert i_t[67].tolist() == HAMMING_TILE_TIES[:k] and (d_t[67] == 0).all()
    real = i_t >= 0
    assert (real[:, :-1] | ~real[:, 1:]).all()
    assert (d_t[~real] == 1e9).all()
    if radius is not None:
        assert (d_t[real] <= radius).all()
        assert real[66].sum() == 1                 # fewer hits than k
        assert not real[70:].any()                 # random queries: none
        assert real[2:66, 0].all()                 # a hit each


@pytest.mark.parametrize("n_valid", [0, 3])
def test_twin_with_few_valid_rows(n_valid):
    q, db = _case(3, n_q=128)
    d_t, i_t = _twin(q, db, n_valid, 5, None)
    d_p, i_p = _pallas(q, db, n_valid, 5, None)
    np.testing.assert_array_equal(d_t, d_p)
    np.testing.assert_array_equal(i_t, i_p)
    assert (i_t[:, n_valid:] == -1).all() and (d_t[:, n_valid:] == 1e9).all()
    assert ((i_t[:, :n_valid] >= 0) & (i_t[:, :n_valid] < n_valid)).all()


def test_twin_takes_any_query_count():
    """The kernel and its twin need no query padding: a ragged Q gives the
    rows of the padded reference call."""
    q, db = _case(4, n_q=300)
    d_t, i_t = _twin(q, db, N_ROWS, 5, 35)
    padded, n = tham.pad_queries(q)
    assert n == 300 and padded.shape[0] == 512
    np.testing.assert_array_equal(padded, jham.pad_queries(q)[0])
    d_p, i_p = _pallas(padded[:384], db, N_ROWS, 5, 35)
    np.testing.assert_array_equal(d_t, d_p[:300])
    np.testing.assert_array_equal(i_t, i_p[:300])


def test_hamming_topk_matches_reference():
    """The streaming XLA matcher as plain PyTorch, bit for bit: distances,
    rows and the padding rows it returns when few rows are valid."""
    q, db = _case(5)
    for n_valid, k in ((N_ROWS - 7, 5), (2, 5), (N_ROWS, 8)):
        d_t, i_t = tmatch.hamming_topk(torch.from_numpy(q),
                                       torch.from_numpy(db), n_valid, k=k,
                                       chunk=CHUNK)
        d_j, i_j = jmatch.hamming_topk(jnp.asarray(q), jnp.asarray(db),
                                       n_valid, k=k, chunk=CHUNK)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    with pytest.raises(ValueError):
        tmatch.hamming_topk(torch.from_numpy(q), torch.from_numpy(db[:-1]),
                            10, chunk=CHUNK)


def test_radius_truncate_and_pad_db_match_reference():
    rng = np.random.default_rng(6)
    d = np.sort(rng.integers(0, 80, (64, 5)), 1).astype(np.float32)
    i = rng.integers(-1, 500, (64, 5)).astype(np.int32)
    ok = rng.random(64) < 0.8
    m_t = tmatch.radius_truncate(torch.from_numpy(d), torch.from_numpy(i),
                                 35.0, torch.from_numpy(ok))
    m_j = jmatch.radius_truncate(jnp.asarray(d), jnp.asarray(i), 35.0,
                                 jnp.asarray(ok))
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n in (0, 5, 2048, 2049):
        desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        p_t, n_t = tmatch.pad_db(desc, CHUNK)
        p_j, n_j = jmatch.pad_db(desc, CHUNK)
        assert n_t == n_j and p_t.dtype == p_j.dtype
        np.testing.assert_array_equal(p_t, p_j)


def test_probe_twin_and_split_plan():
    """T1's plain versions against numpy, and the kernel's row splits."""
    q, db = _case(7, n_q=130)
    words = tham.pack_db_bits(torch.from_numpy(db))
    bits_q = np.unpackbits(q, axis=1, bitorder="little").astype(np.int64)
    bits_d = np.unpackbits(db[:5000], axis=1, bitorder="little").astype(
        np.int64)
    dist = bits_q.sum(1)[:, None] + bits_d.sum(1)[None, :] \
        - 2 * bits_q @ bits_d.T
    got = {m: tham.hamming_probe(torch.from_numpy(q), words, 5000, m).numpy()
           for m in tham.PROBE_MODES}
    np.testing.assert_array_equal(got["dist_sum"], dist.sum(1))
    np.testing.assert_array_equal(got["row_min"], dist.min(1))
    assert got["block_min"].tolist() == [0]
    with pytest.raises(ValueError):
        tham.hamming_probe(torch.from_numpy(q), words, 0, "row_min")
    with pytest.raises(ValueError):
        tham.hamming_probe(torch.from_numpy(q), words, 10, "row_min", "bf16")
    for n_q, n_valid in ((5000, 2117214), (5000, 21193614), (300, 6144),
                         (1, 1), (128, 0), (512, 4097)):
        n_split, per = tham.split_plan(n_q, n_valid, 132)
        assert 1 <= n_split <= tham.MAX_SPLITS
        assert per % tham.ROW_TILE == 0 or n_valid == 0
        assert (n_split - 1) * per < max(n_valid, 1) <= n_split * per \
            or n_valid == 0


@pytest.mark.parametrize("route", sorted(tham.PROBE_ROUTES))
def test_probe_routes_share_the_plain_version(route):
    """On a CPU tensor every T1 route runs the one plain version: each
    route's kernel is held against it on the card."""
    q, db = _case(11, n_q=70)
    qt, words = torch.from_numpy(q), tham.pack_db_bits(torch.from_numpy(db))
    before = tham.hamming_probe.launches
    for mode in tham.PROBE_MODES:
        got = tham.hamming_probe(qt, words, 4321, mode, route)
        assert torch.equal(got, tham.hamming_probe_torch(qt, words, 4321,
                                                         mode))
    assert tham.hamming_probe.launches == before


@pytest.mark.parametrize("n_q, n_valid", [
    (5000, 2117214), (5000, 21193614), (512, 2117214), (1024, 1739636),
    (300, 20000), (1, 1), (17, 8), (65, 129), (5000, 1 << 26),
    (100000, 1 << 26), (256, 4097)])
def test_split_plan_covers_every_row_once(n_q, n_valid):
    """Every valid row lies in exactly one split, no split is empty, a split
    is a multiple of ROW_TILE rows and below the kernel's 2^23-row keys,
    the grid stays inside its y limit, and where the rows allow the blocks
    fill 132 SMs several times over."""
    for q_block in (tham.BLOCK_QUERIES, tham.POPC_BLOCK_QUERIES):
        n_split, per = tham.split_plan(n_q, n_valid, 132, q_block)
        assert 1 <= n_split <= tham.MAX_SPLITS
        assert per % tham.ROW_TILE == 0 and 0 < per <= tham.MAX_SPLIT_ROWS
        assert (n_split - 1) * per < n_valid <= n_split * per
        tiles = -(-n_q // q_block)
        if n_valid >= 4 * 132 * tham.MIN_SPLIT_ROWS:
            assert tiles * n_split >= 4 * 132, (tiles, n_split)


@pytest.mark.parametrize("n_q, n_valid", [(5000, 2117214), (300, 20000),
                                          (64, 5), (1, 0)])
def test_twin_schedule_follows_the_plan(n_q, n_valid):
    """The twin's row blocks tile [0, n_valid) in ascending order and never
    straddle a split of the kernel's plan."""
    n_split, per = tham.split_plan(n_q, n_valid, tham.TWIN_SMS)
    blocks = list(tham.twin_schedule(n_q, n_valid))
    assert [b for b, _ in blocks[1:]] == [e for _, e in blocks[:-1]]
    assert (blocks[0][0] if blocks else 0) == 0
    assert (blocks[-1][1] if blocks else 0) == n_valid
    for base, end in blocks:
        assert base < end and (end - 1) // per == base // per
        assert end - base <= TWIN_ROWS


def test_wrapper_refuses_what_it_cannot_take():
    q, db = _case(8, n_q=128)
    qt, words = torch.from_numpy(q), tham.pack_db_bits(torch.from_numpy(db))
    for bad in (dict(k=0), dict(k=9)):
        with pytest.raises(ValueError):
            tham.hamming_topk_fused(qt, words, N_ROWS, **bad)
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(qt, words, N_ROWS + 1)          # n_valid
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(qt.to(torch.int32), words, N_ROWS)   # dtype
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(qt, words.view(torch.uint8), N_ROWS)  # DB
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(qt.to("meta"), words, N_ROWS)   # no path
    with pytest.raises(ValueError):
        tham.pack_db_bits(torch.from_numpy(db[:, :16]))
    assert torch.equal(tham.pack_db_bits(torch.from_numpy(db)).view(
        torch.uint8), torch.from_numpy(db))
