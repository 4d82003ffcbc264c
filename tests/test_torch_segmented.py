"""Parity of the port's segmented matcher (tod_tpu_torch.ops.segmented) with
tod_tpu.ops.pallas.segmented.

On the CPU the port's wrapper runs its plain twin; it must equal, bit for
bit, both the reference's XLA twin and its Pallas kernel run in interpret
mode (as tests/test_segmented.py runs it). The CUDA kernel itself is
compared with the twin in test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.ops.pallas import segmented as jseg
from tod_tpu_torch import convert
from tod_tpu_torch.ops import segmented as tseg
from tod_tpu_torch.types import TodModel

torch.set_num_threads(1)


def _arrays(rng, sizes):
    return [(rng.integers(0, 256, (n, 32), dtype=np.uint8),
             rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32))
            for n in sizes]


def _both(arrays):
    jm = [JaxModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    tm = [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    return jm, tm


def _edge_case_models(rng):
    """An empty object, one spanning several chunks, duplicated rows (the
    lowest-row tie rule) and rows at distance 0 and 256 from query 0/1."""
    arrays = _arrays(rng, [300, 0, 4500, 64, 700, 1])
    dup = arrays[3][0]
    dup[10:20] = dup[5]                  # rows 5 and 10..19 equal
    return arrays


def _queries(rng, arrays, n=512):
    q = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    q[0] = arrays[4][0][123]             # distance 0 to object 4 row 123
    q[1] = ~arrays[5][0][0]              # distance 256 to object 5's row
    q[2] = arrays[3][0][5]               # distance 0 to 11 equal rows of o3
    return q


def test_pack_segmented_layout_matches(rng):
    arrays = _arrays(rng, [5, 2049, 700, 0])
    jm, tm = _both(arrays)
    jdb = jseg.pack_segmented(jm, db_chunk=2048, reserve_rows=100)
    tdb = tseg.pack_segmented(tm, db_chunk=2048, reserve_rows=100,
                              device="cpu")
    for name in ("obj_start", "n_rows", "spans", "points"):
        np.testing.assert_array_equal(getattr(tdb, name).numpy(),
                                      np.asarray(getattr(jdb, name)))
    assert tdb.db_chunk == jseg.db_chunk_of(jdb) == 2048
    assert tdb.starts_host == (0, 2048, 6144, 8192)
    assert tdb.rows_host == (5, 2049, 700, 0)
    # rows hold the reference's bits, packed: (N_pad, 8) int32 words
    bits = np.asarray(jdb.bits_t).T.astype(np.uint8)
    packed = np.packbits(bits, axis=1, bitorder="little")
    assert tuple(tdb.words.shape) == (bits.shape[0], 8)
    np.testing.assert_array_equal(tdb.words.view(torch.uint8).numpy(),
                                  packed)


def test_twin_matches_reference_twin_and_interpret_kernel(rng):
    arrays = _edge_case_models(rng)
    jm, tm = _both(arrays)
    jdb = jseg.pack_segmented(jm, db_chunk=2048)
    tdb = tseg.pack_segmented(tm, db_chunk=2048, device="cpu")
    q = _queries(rng, arrays)
    d_x, r_x = jseg.object_top1_xla(jnp.asarray(q), jdb, db_chunk=2048)
    d_f, r_f = jseg.object_top1_fused(jnp.asarray(q), jdb, q_tile=512,
                                      db_chunk=2048)     # interpret mode
    d_t, r_t = tseg.object_top1_torch(torch.from_numpy(q), tdb)
    assert d_t.dtype == torch.float32 and r_t.dtype == torch.int32
    for d_ref, r_ref in ((d_x, r_x), (d_f, r_f)):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_ref))
    d, r = d_t.numpy(), r_t.numpy()
    assert (d[:, 1] == tseg.DIST_CLAMP).all() and (r[:, 1] == 0).all()
    assert (d[0, 4], r[0, 4]) == (0, 123)
    assert (d[1, 5], r[1, 5]) == (256, 0)
    assert (d[2, 3], r[2, 3]) == (0, 5)      # lowest of the equal rows


def test_wrapper_runs_twin_for_cpu_tensors(rng):
    arrays = _arrays(rng, [100, 0, 333])
    _, tm = _both(arrays)
    tdb = tseg.pack_segmented(tm, db_chunk=256, device="cpu")
    q = torch.from_numpy(rng.integers(0, 256, (37, 32), dtype=np.uint8))
    before = tseg.object_top1.launches
    d, r = tseg.object_top1(q, tdb)          # Q need not fill a tile
    d_t, r_t = tseg.object_top1_torch(q, tdb)
    assert torch.equal(d, d_t) and torch.equal(r, r_t)
    assert tseg.object_top1.launches == before   # the twin is no launch
    with pytest.raises(ValueError):
        tseg.object_top1(q.to("meta"), tdb)


def test_segmented_db_from_jax_round_trip(rng):
    arrays = _edge_case_models(rng)
    jm, tm = _both(arrays)
    jdb = jseg.pack_segmented(jm, db_chunk=2048, reserve_rows=64)
    fields = {k: np.asarray(v) for k, v in jdb._asdict().items()}
    got = convert.segmented_db_from_jax(fields, "cpu")
    want = tseg.pack_segmented(tm, db_chunk=2048, reserve_rows=64,
                               device="cpu")
    for name in ("words", "points", "obj_start", "n_rows", "spans"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.db_chunk, got.starts_host, got.rows_host) == \
        (want.db_chunk, want.starts_host, want.rows_host)
    models = convert.models_from_numpy(
        [f"o{i}" for i in range(len(arrays))], [d for d, _ in arrays],
        [p[None] for _, p in arrays])       # (1, N, 3) as the model DB has
    for m, j in zip(models, jm):
        assert m.object_id == j.object_id and m.n_points == j.n_points
        assert m.span == pytest.approx(j.span, rel=1e-6)


# ---- kernel B1's key (csrc/segmented_top1.cu) -------------------------------

# B1's key: the row within its object in the low 18 bits (objects have at
# most 2^18 rows), and the bias that keeps |r| + 256 - 2 popc(q & r) >= 0
B1_ROW_BITS = 18
B1_POP_BIAS = 256


def b1_key(r_pop, row, and_pop):
    """Kernel B1's key of a pair, ``((|r| + 256) << 18 | row) -
    (popc(q & r) << 19)`` (int64 in, int64 out): ``(dist - |q| + 256) <<
    18 | row``. A smaller key has the smaller distance (same query), then
    the lower row."""
    return (((r_pop + B1_POP_BIAS) << B1_ROW_BITS) | row) \
        - (and_pop << (B1_ROW_BITS + 1))


def b1_key_split(key, q_pop):
    """``(dist, row)`` of :func:`b1_key` for a query of popcount ``q_pop``."""
    return (key >> B1_ROW_BITS) - B1_POP_BIAS + q_pop, \
        key & ((1 << B1_ROW_BITS) - 1)


def test_b1_key_bounds():
    """The key at the extremes of the descriptors (all-zero and all-ones
    query and row) and of the rows (0 and 2^18 - 1): in [0, 2^28), and
    split back into the distance and the row."""
    for q_pop in (0, 256):
        for r_pop in (0, 256):
            and_pop = min(q_pop, r_pop)       # all zero or all ones
            dist = q_pop + r_pop - 2 * and_pop
            for row in (0, (1 << B1_ROW_BITS) - 1):
                key = b1_key(torch.tensor([r_pop]), torch.tensor([row]),
                             torch.tensor([and_pop]))
                assert 0 <= int(key) < 2 ** 28, (q_pop, r_pop, row)
                d, r = b1_key_split(key, q_pop)
                assert (int(d), int(r)) == (dist, row)
    # the smallest and largest keys: a row equal to an all-ones query, and
    # an all-ones row against an all-zero query at the last row
    assert int(b1_key(torch.tensor([256]), torch.tensor([0]),
                      torch.tensor([256]))) == 0
    assert int(b1_key(torch.tensor([256]), torch.tensor([2**18 - 1]),
                      torch.tensor([0]))) == (512 << 18) + 2**18 - 1


def _b1_object_keys(qb, q_pop, db_u8, start, n):
    """Kernel B1's arithmetic for one object as plain PyTorch: the min of
    :func:`b1_key` over its ``n`` real rows, with |q|, |r| and popc(q & r)
    from the unpacked bits ``qb``; (511, 0) for an object without rows."""
    if not n:
        return torch.full_like(q_pop, tseg.DIST_CLAMP), torch.zeros_like(q_pop)
    rb = tseg.unpack_bits(db_u8[start:start + n],
                          torch.float32).to(torch.int64)
    key = b1_key(rb.sum(1)[None, :], torch.arange(n)[None, :], qb @ rb.T)
    assert int(key.min()) >= 0 and int(key.max()) < 2 ** 28
    return b1_key_split(key.min(1).values, q_pop)


def _unpacked(q_u8, db):
    qb = tseg.unpack_bits(q_u8, torch.float32).to(torch.int64)
    return qb, qb.sum(1), db.words.view(torch.uint8)


def _b1_keys_torch(q_u8, db):
    """Kernel B1's grid as plain PyTorch: object o in column o."""
    qb, q_pop, db_u8 = _unpacked(q_u8, db)
    d_out = torch.zeros((q_u8.shape[0], db.n_objects), dtype=torch.int64)
    r_out = torch.zeros_like(d_out)
    for o, (start, n) in enumerate(zip(db.starts_host, db.rows_host)):
        d_out[:, o], r_out[:, o] = _b1_object_keys(qb, q_pop, db_u8, start, n)
    return d_out.to(torch.float32), r_out.to(torch.int32)


def _b2_keys_torch(q_u8, db, sel):
    """Kernel B2's grid as plain PyTorch: slot c runs B1's object function
    on object sel[c], or, for a slot outside [0, O), writes the hole key
    0x7FFFFFFF split as (key >> 18, key & (2^18 - 1))."""
    qb, q_pop, db_u8 = _unpacked(q_u8, db)
    d_out = torch.zeros((q_u8.shape[0], len(sel)), dtype=torch.int64)
    r_out = torch.zeros_like(d_out)
    for c, o in enumerate(sel):
        if 0 <= o < db.n_objects:
            d_out[:, c], r_out[:, c] = _b1_object_keys(
                qb, q_pop, db_u8, db.starts_host[o], db.rows_host[o])
        else:
            d_out[:, c] = tseg.KEY_INVALID >> B1_ROW_BITS
            r_out[:, c] = tseg.KEY_INVALID & ((1 << B1_ROW_BITS) - 1)
    return d_out.to(torch.float32), r_out.to(torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b1_key_matches_twin(seed):
    """The one-key arg-min equals B1's twin, distances and lowest-row ties,
    on objects of 0-300 rows with ties across the tile's fragments, lanes
    and tiles, all-zero and all-one rows and queries (the tile edge cases
    of the card's tests), and on the edge-case models above."""
    from tod_tpu_torch.utils.smoke_catalog import \
        edge_case_arrays_hamming_tiles

    rng = np.random.default_rng(seed)
    descs, q = edge_case_arrays_hamming_tiles(seed, 40)
    arrays = [(d, np.zeros((len(d), 3), np.float32)) for d in descs]
    cases = [(arrays, q), (_edge_case_models(rng), None)]
    for arrays, q in cases:
        _, tm = _both(arrays)
        db = tseg.pack_segmented(tm, db_chunk=256, reserve_rows=200,
                                 device="cpu")
        q = torch.from_numpy(_queries(rng, arrays, 64) if q is None else q)
        d, r = _b1_keys_torch(q, db)
        d_t, r_t = tseg.object_top1_torch(q, db)
        assert torch.equal(d, d_t) and torch.equal(r, r_t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b2_columns_through_b1_key_match_twin(seed):
    """B2's two-grid design emulated through B1's key (holes at -1 and past
    the catalog, an empty object, repeated and out-of-order ids) equals
    B2's twin, and each real column equals B1's column sel[c]."""
    from tod_tpu_torch.utils.smoke_catalog import \
        edge_case_arrays_hamming_tiles

    rng = np.random.default_rng(seed)
    descs, q = edge_case_arrays_hamming_tiles(seed, 40)
    arrays = [(d, np.zeros((len(d), 3), np.float32)) for d in descs]
    sels = [[8, -1, 2, 1, 8, 0, -1, 7, 3, 12, 5, 6, 4], [-1], [1, 1, 8]]
    cases = [(arrays, q, sels),
             (_edge_case_models(rng), None, [[4, -1, 1, 2, 4, 0, 6, 3, 5]])]
    for arrays, q, case_sels in cases:
        _, tm = _both(arrays)
        db = tseg.pack_segmented(tm, db_chunk=256, reserve_rows=200,
                                 device="cpu")
        q = torch.from_numpy(_queries(rng, arrays, 64) if q is None else q)
        d1, r1 = _b1_keys_torch(q, db)
        for sel in case_sels:
            d, r = _b2_keys_torch(q, db, sel)
            d_t, r_t = tseg.object_top1_gathered_torch(
                q, db, torch.tensor(sel, dtype=torch.int32))
            assert torch.equal(d, d_t) and torch.equal(r, r_t), sel
            real = [c for c, o in enumerate(sel) if 0 <= o < db.n_objects]
            cols = [sel[c] for c in real]
            assert torch.equal(d[:, real], d1[:, cols])
            assert torch.equal(r[:, real], r1[:, cols])
            holes = [c for c in range(len(sel)) if c not in real]
            assert (d[:, holes] == tseg.HOLE_DIST).all()
            assert (r[:, holes] == tseg.HOLE_ROW).all()
