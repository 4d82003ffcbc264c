"""Parity of the port's SIFT/L2 segmented matcher
(tod_tpu_torch.ops.segmented_l2) with tod_tpu.ops.pallas.segmented_l2.

On the CPU the port's wrappers run their plain twins; these must equal, bit
for bit, both the reference's XLA twins and its Pallas kernels run in
interpret mode (as tests/test_sift.py runs them): int8 squared distances are
exact integers on every side, the square root is correctly rounded and 1/256
is a power of two. The CUDA kernels themselves are compared with the twins
in test_torch_cuda.py, which needs a card.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.ops.pallas import segmented_l2 as jl2
from tod_tpu_torch import convert
from tod_tpu_torch.cells import trainer as ttrainer
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops import compress as tcompress
from tod_tpu_torch.ops import segmented as tseg
from tod_tpu_torch.ops import segmented_l2 as tl2
from tod_tpu_torch.types import TodModel
from tod_tpu_torch.utils import prng

torch.set_num_threads(1)


def _unit(rng, n):
    d = rng.random((n, 128)).astype(np.float32) ** 3    # sparse-ish, like SIFT
    return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)


def _arrays(rng, sizes):
    return [(_unit(rng, n), rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32))
            for n in sizes]


def _both(arrays):
    jm = [JaxModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    tm = [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    return jm, tm


def _edge_case_models(rng):
    """An empty object, one spanning several chunks, an object of one row,
    and duplicated rows (the lowest-row tie rule), some of them in a later
    chunk than the first copy."""
    arrays = _arrays(rng, [300, 0, 1100, 64, 700, 1])
    arrays[3][0][10:20] = arrays[3][0][5]       # rows 5 and 10..19 equal
    arrays[2][0][[40, 300, 900]] = arrays[2][0][7]   # equal rows, 3 chunks
    return arrays


def _queries(rng, arrays, n=128):
    q = _unit(rng, n)
    q[0] = arrays[4][0][123]        # distance 0 to object 4 row 123
    q[1] = arrays[3][0][5]          # distance 0 to 11 equal rows of object 3
    q[2] = arrays[2][0][7]          # distance 0 to rows 7, 40, 300, 900
    q[3] = 0.0                      # |q| = 0
    return np.array(jl2.quantize_descriptors(jnp.asarray(q)))


def _assert_db_equal(got, want):
    for name in ("rows", "norm_sq", "points", "obj_start", "n_rows", "spans"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.db_chunk, got.starts_host, got.rows_host) == \
        (want.db_chunk, want.starts_host, want.rows_host)


def test_quantize_descriptors_matches(rng):
    d = _unit(rng, 500)
    d[0, :4] = [0.5 / 256, 1.5 / 256, 2.5 / 256, 0.6]   # ties to even; clip
    d[1] = -d[1]                                          # clip at 0
    want = np.asarray(jl2.quantize_descriptors(jnp.asarray(d)))
    got = tl2.quantize_descriptors(torch.from_numpy(d))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tl2.quantize_numpy(d), want)
    assert want[0, :4].tolist() == [0, 2, 2, 127] and not want[1].any()
    # q / 256 is exact and quantises back to q: models travel as int8
    back = want.astype(np.float32) / 256.0
    np.testing.assert_array_equal(tl2.quantize_numpy(back), want)
    assert tl2.quantize_numpy(want) is want


@pytest.mark.parametrize("case", ["reserve", "empty_catalog", "int8_models"])
def test_pack_segmented_l2_matches_through_convert(rng, case):
    """The port's packed DB equals the reference's arrays carried over by
    segmented_db_f_from_jax: rows, norms (PAD_NORM on padding and reserved
    rows), points and the segment layout."""
    arrays = [] if case == "empty_catalog" else \
        _arrays(rng, [5, 600, 0, 257])
    jm, tm = _both(arrays)
    if case == "int8_models":        # quantised models pack to the same DB
        tm = [TodModel(m.object_id, tl2.quantize_numpy(m.descriptors),
                       m.points) for m in tm]
    jdb = jl2.pack_segmented_l2(jm, db_chunk=256, reserve_rows=300)
    fields = {k: np.asarray(v) for k, v in jdb._asdict().items()}
    got = convert.segmented_db_f_from_jax(fields, "cpu")
    want = tl2.pack_segmented_l2(tm, db_chunk=256, reserve_rows=300,
                                 device="cpu")
    _assert_db_equal(got, want)
    np.testing.assert_array_equal(want.rows.numpy(), fields["vecs_t"].T)
    np.testing.assert_array_equal(want.norm_sq.numpy(), fields["norm_sq"][0])
    assert want.db_chunk == jl2.db_chunk_of_f(jdb) == 256
    if arrays:
        assert want.rows_host == (5, 600, 0, 257)
        assert want.starts_host == (0, 512, 1280, 1792)
        assert (want.norm_sq[5:512] == tl2.PAD_NORM).all()
    else:
        assert want.n_objects == 0 and tuple(want.rows.shape) == (256, 128)
        assert (want.norm_sq == tl2.PAD_NORM).all()


def test_b3_twin_matches_reference_twin_and_interpret_kernel(rng):
    arrays = _edge_case_models(rng)
    jm, tm = _both(arrays)
    jdb = jl2.pack_segmented_l2(jm, db_chunk=256)
    tdb = tl2.pack_segmented_l2(tm, db_chunk=256, device="cpu")
    q = _queries(rng, arrays)
    d_x, r_x = jl2.object_top1_l2_xla(jnp.asarray(q), jdb, db_chunk=256)
    d_f, r_f = jl2.object_top1_l2_fused(jnp.asarray(q), jdb, q_tile=128,
                                        db_chunk=256)    # interpret mode
    d_t, r_t = tl2.object_top1_l2_torch(torch.from_numpy(q), tdb)
    assert d_t.dtype == torch.float32 and r_t.dtype == torch.int32
    for d_ref, r_ref in ((d_x, r_x), (d_f, r_f)):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_ref))
    d, r = d_t.numpy(), r_t.numpy()
    assert (d[0, 4], r[0, 4]) == (0, 123)
    assert (d[1, 3], r[1, 3]) == (0, 5)      # lowest of the equal rows
    assert (d[2, 2], r[2, 2]) == (0, 7)      # ... across chunks
    # the object with no rows reports its padding rows' distance, exactly
    # sqrt(f32(|q|^2 + 2^28)) / 256 (~64), and row 0
    q_norm = (q.astype(np.int64) ** 2).sum(1)
    d_sq, _ = tl2.object_top1_l2_sq_torch(torch.from_numpy(q), tdb)
    np.testing.assert_array_equal(d_sq[:, 1].numpy(), q_norm + tl2.PAD_NORM)
    np.testing.assert_array_equal(
        d[:, 1], np.sqrt((q_norm + tl2.PAD_NORM).astype(np.float32))
        * np.float32(1 / 256))
    assert (r[:, 1] == 0).all() and d_sq[3, 1] == tl2.PAD_NORM
    assert d[:, [0, 2, 3, 4, 5]].max() < 2.0 < d[:, 1].min()


def test_b4_twin_matches_reference_twin_and_interpret_kernel(rng):
    arrays = _edge_case_models(rng)
    jm, tm = _both(arrays)
    jdb = jl2.pack_segmented_l2(jm, db_chunk=256)
    tdb = tl2.pack_segmented_l2(tm, db_chunk=256, device="cpu")
    q = _queries(rng, arrays)
    sel = np.array([3, -1, 0, 1, 5, 2, -1, 4, 3], np.int32)
    d_x, r_x = jl2.object_top1_l2_gathered_xla(jnp.asarray(q), jdb,
                                               jnp.asarray(sel), db_chunk=256)
    d_f, r_f = jl2.object_top1_l2_gathered_fused(
        jnp.asarray(q), jdb, jnp.asarray(sel),
        jl2.max_chunks_per_object_f(jdb), q_tile=128)    # interpret mode
    d_t, r_t = tl2.object_top1_l2_gathered_torch(
        torch.from_numpy(q), tdb, torch.from_numpy(sel))
    for d_ref, r_ref in ((d_x, r_x), (d_f, r_f)):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_ref))
    # each column is the full sweep's column at sel; holes report
    # _to_l2(DIST_INVALID) = sqrt(2^31) / 256 and row 0, bit for bit
    d_full, r_full = tl2.object_top1_l2_torch(torch.from_numpy(q), tdb)
    for c, o in enumerate(sel):
        if o >= 0:
            assert torch.equal(d_t[:, c], d_full[:, o])
            assert torch.equal(r_t[:, c], r_full[:, o])
    hole = np.asarray(jl2._to_l2(jnp.int32(jl2.DIST_INVALID)))
    assert np.float32(tl2.HOLE_DIST_L2) == hole == \
        np.sqrt(np.float32(2.0 ** 31)) / 256
    assert (d_t.numpy()[:, [1, 6]] == hole).all()
    assert (r_t.numpy()[:, [1, 6]] == tl2.HOLE_ROW_L2).all()
    # an id past the catalog is a hole too (the kernel must not read it)
    d_p, r_p = tl2.object_top1_l2_gathered_torch(
        torch.from_numpy(q), tdb, torch.tensor([6, 0], dtype=torch.int32))
    assert (d_p[:, 0] == tl2.HOLE_DIST_L2).all() and (r_p[:, 0] == 0).all()
    assert torch.equal(d_p[:, 1], d_full[:, 0])


def test_wrappers_run_twins_for_cpu_tensors(rng):
    arrays = _arrays(rng, [100, 0, 333])
    _, tm = _both(arrays)
    tdb = tl2.pack_segmented_l2(tm, db_chunk=256, device="cpu")
    q = torch.from_numpy(_queries(rng, _edge_case_models(rng), 37))
    sel = torch.tensor([2, -1, 0], dtype=torch.int32)
    before = (tl2.object_top1_l2.launches,
              tl2.object_top1_l2_gathered.launches)
    d, r = tl2.object_top1_l2(q, tdb)        # Q need not fill a tile
    d_t, r_t = tl2.object_top1_l2_torch(q, tdb)
    assert torch.equal(d, d_t) and torch.equal(r, r_t)
    d, r = tl2.object_top1_l2_gathered(q, tdb, sel)
    d_t, r_t = tl2.object_top1_l2_gathered_torch(q, tdb, sel)
    assert torch.equal(d, d_t) and torch.equal(r, r_t)
    assert before == (tl2.object_top1_l2.launches,
                      tl2.object_top1_l2_gathered.launches)
    with pytest.raises(ValueError):
        tl2.object_top1_l2(q.to("meta"), tdb)
    with pytest.raises(ValueError):
        tl2.object_top1_l2_gathered(q.to("meta"), tdb, sel)
    # the dispatch on the DB's class, as FusedDetector matches
    assert torch.equal(tfused.match_full(q, tdb)[0],
                       tl2.object_top1_l2_torch(q, tdb)[0])
    assert torch.equal(tfused.match_gathered(q, tdb, sel)[1], r_t)


@pytest.mark.parametrize("entry", [
    tfused.FusedDetector.__init__, tseg.pack_segmented,
    tl2.pack_segmented_l2, convert.segmented_db_from_jax,
    convert.segmented_db_f_from_jax, tfused.pack_models,
    convert.model_db_from_jax, ttrainer.train_object,
    tcompress.compress_model, tcompress.self_knn, prng.gumbel,
    prng.threefry_bits])
def test_entry_points_default_to_the_card(entry):
    """Entry points serve on the card unless the caller names another
    device (the tests name "cpu"); none falls back when no card is found."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_to_l2_matches_bit_for_bit():
    """Every squared distance two int8 rows can have (up to 2 * 127^2 *
    128), the empty object's range and the invalid distance."""
    x = np.concatenate([
        np.arange(0, 2 * 127 * 127 * 128 + 1, dtype=np.int64),
        tl2.PAD_NORM + np.arange(0, 127 * 127 * 128 + 1, 97, dtype=np.int64),
        [tl2.DIST_INVALID, -5]]).astype(np.int32)
    want = np.asarray(jl2._to_l2(jnp.asarray(x)))
    got = tl2.to_l2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 0.0 and got[-2] == np.float32(tl2.HOLE_DIST_L2)


# ---- kernel B3's tile key (csrc/segmented_l2_top1.cu) ----------------------

# B3's tile: 128 rows a step (kTcRows), the row's column in the low 7 bits
# of its key (kColBits), and the key's bias (kKeyBias:
# |r|^2 - 2 q.r = d - |q|^2 >= -|q|^2 >= -128 * 128^2 = -2^21)
L2_ROW_TILE = 128
L2_COL_BITS = 7
L2_KEY_BIAS = 1 << 21


def l2_tile_key(v, col):
    """Kernel B3's key of a pair: ``(v + 2^21) << 7 | col`` for ``v = |r|^2
    - 2 q.r`` (int64 in, int64 out) and the row's column in its 128-row
    tile. For int8 operands it lies in [0, 2^31), and a smaller key has the
    smaller distance ``|q|^2 + v`` (same query), then the lower column."""
    return ((v + L2_KEY_BIAS) << L2_COL_BITS) | col


def l2_tile_key_split(key):
    """``(v, col)`` of :func:`l2_tile_key`."""
    return (key >> L2_COL_BITS) - L2_KEY_BIAS, key & (L2_ROW_TILE - 1)


def test_l2_tile_key_bound_at_int8_extremes():
    """The key ``(|r|^2 - 2 q.r + 2^21) << 7 | col`` at the int8 extremes:
    d = 0 at q = r = -128 (the smallest v, -2^21) and d = 128 x 255^2 at
    q = -128, r = 127 (the largest); inside [0, 2^31) and round-tripped."""
    q = torch.full((1, 128), -128, dtype=torch.int64)
    cases = {"min": torch.full((1, 128), -128, dtype=torch.int64),
             "max": torch.full((1, 128), 127, dtype=torch.int64),
             "zero": torch.zeros((1, 128), dtype=torch.int64)}
    q_norm = int((q ** 2).sum())
    assert q_norm == L2_KEY_BIAS
    got = {}
    for name, r in cases.items():
        v = (r ** 2).sum(1) - 2 * (q * r).sum(1)
        for col in (0, L2_ROW_TILE - 1):
            key = l2_tile_key(v, torch.tensor([col]))
            assert 0 <= int(key) < 2 ** 31, (name, int(key))
            v2, c2 = l2_tile_key_split(key)
            assert int(v2) == int(v) and int(c2) == col
        got[name] = int(v) + q_norm
    assert got == {"min": 0, "max": 128 * 255 ** 2, "zero": q_norm}
    # q = 127, r = -128 is as far, with a smaller |q|^2
    v = (128 * 128 ** 2) - 2 * 128 * (127 * -128)
    assert 0 <= int(l2_tile_key(torch.tensor([v]), torch.tensor([127]))) \
        < 2 ** 31


def _tiled_keys_torch(q_i8, db):
    """Kernel B3's arithmetic as plain PyTorch: per object, 128-row tiles
    of real rows, the per-tile min of :func:`l2_tile_key`, tiles folded in
    ascending order on the distance alone (strict <)."""
    q = q_i8.to(torch.int64)
    q_norm = (q ** 2).sum(1)
    d_out = torch.empty((q.shape[0], db.n_objects), dtype=torch.int64)
    r_out = torch.zeros((q.shape[0], db.n_objects), dtype=torch.int64)
    for o, (start, n) in enumerate(zip(db.starts_host, db.rows_host)):
        best_v = torch.full((q.shape[0],), 1 << 62, dtype=torch.int64)
        best_r = torch.zeros(q.shape[0], dtype=torch.int64)
        for base in range(0, n, L2_ROW_TILE):
            rows = db.rows[start + base:start + min(base + L2_ROW_TILE,
                                                    n)].to(torch.int64)
            v = (rows ** 2).sum(1)[None, :] - 2 * q @ rows.T
            key = l2_tile_key(v, torch.arange(rows.shape[0])[None, :])
            assert int(key.min()) >= 0 and int(key.max()) < 2 ** 31
            t_v, t_c = l2_tile_key_split(key.min(1).values)
            take = t_v < best_v
            best_v = torch.where(take, t_v, best_v)
            best_r = torch.where(take, base + t_c, best_r)
        d_out[:, o] = best_v + q_norm if n else q_norm + tl2.PAD_NORM
        r_out[:, o] = best_r
    return d_out.to(torch.int32), r_out.to(torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiled_key_fold_matches_twin_over_the_full_int8_range(seed):
    """The key fold equals B3's twin, distances and lowest-row ties, on
    int8 rows and queries over -128..127 (not only the quantiser's 0..127),
    objects of 0, 1, 15, 16, 17, 127, 128 and 129 rows padded with reserved
    rows, and rows tied across the 128-row tiles."""
    rng = np.random.default_rng(seed)
    sizes = [17, 0, 1, 15, 16, 300, 127, 128, 129]
    descs = [rng.integers(-128, 128, (n, 128)).astype(np.int8) for n in sizes]
    descs[5][[3, 127, 128, 255, 299]] = descs[5][40]
    descs[5][200] = -128
    descs[5][201] = 127
    q = rng.integers(-128, 128, (40, 128)).astype(np.int8)
    q[0] = descs[5][40]
    q[1] = -128
    q[2] = 127
    q[3] = descs[5][40] // 2
    models = [TodModel(f"o{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    db = tl2.pack_segmented_l2(models, db_chunk=256, reserve_rows=64,
                               device="cpu")
    qt = torch.from_numpy(q)
    d_k, r_k = _tiled_keys_torch(qt, db)
    d_t, r_t = tl2.object_top1_l2_sq_torch(qt, db)
    assert torch.equal(d_k, d_t) and torch.equal(r_k, r_t)
    assert (d_t[0, 5].item(), r_t[0, 5].item()) == (0, 3)
    assert (d_t[1, 5].item(), r_t[1, 5].item()) == (0, 200)
    assert (d_t[2, 5].item(), r_t[2, 5].item()) == (0, 201)
