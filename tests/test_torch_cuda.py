"""The port's CUDA kernels (B1, B2, B3, B4 of the SIFT/L2 path, and B5 and
its isolation modes T1 of the global-kNN path, on every route, with B5 also
at the training dedup's shapes) against
their plain PyTorch twins, on the card, with the edges of the tensor-core
tiles (ragged Q and n_valid, short objects beside padding, the full int8
range, all-zero and all-one descriptors, ties across fragments, lanes,
tiles and splits); and the threefry noise kernel N1 against its twins on
the card and the same draws on the CPU.

Every test here is marked ``cuda`` and skips without a GPU. The file needs
neither JAX nor the JAX package, so it also runs on a machine that has
only torch; there, skip the repository's conftest (which sets up JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.ops import compress as tcompress
from tod_tpu_torch.ops import hamming as tham
from tod_tpu_torch.ops import segmented as tseg
from tod_tpu_torch.ops import segmented_l2 as tl2
from tod_tpu_torch.types import TodModel
from tod_tpu_torch.utils import prng
from tod_tpu_torch.utils.smoke_catalog import (
    HAMMING_TILE_TIES, dedup_case_arrays, edge_case_arrays_hamming,
    edge_case_arrays_hamming_tiles, edge_case_arrays_l2,
    edge_case_arrays_l2_int8)

# ragged against the tiles' 16-query m-tiles and 256-query blocks
TILE_Q = [1, 15, 16, 17, 63, 65, 255, 257, 2048]
# holes, a repeated id, out-of-order ids, an id past the catalog
EDGE_SEL = [8, -1, 2, 1, 8, 0, -1, 7, 3, 12, 5, 6, 4]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _edge_case_db(rng, device):
    """An empty object, objects spanning several row tiles and DB chunks,
    duplicated rows (the lowest-row tie rule) and a one-row object."""
    sizes = [300, 0, 4500, 64, 700, 1, 513]
    descs = [rng.integers(0, 256, (n, 32), dtype=np.uint8) for n in sizes]
    descs[3][10:20] = descs[3][5]
    models = [TodModel(f"o{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return descs, tseg.pack_segmented(models, db_chunk=2048, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [512, 300, 1])
def test_b1_matches_twin(n_q):
    dev = _cuda()
    rng = np.random.default_rng(n_q)
    descs, db = _edge_case_db(rng, dev)
    q = rng.integers(0, 256, (n_q, 32), dtype=np.uint8)
    q[0] = descs[4][123]                   # distance 0
    if n_q > 2:
        q[1] = ~descs[5][0]                # distance 256
        q[2] = descs[3][5]                 # ties over 11 equal rows
    q = torch.from_numpy(q).to(dev)
    before = tseg.object_top1.launches
    d, r = tseg.object_top1(q, db)
    torch.cuda.synchronize()
    assert tseg.object_top1.launches == before + 1
    d_t, r_t = tseg.object_top1_torch(q, db)
    assert torch.equal(d, d_t) and torch.equal(r, r_t)
    d, r = d.cpu().numpy(), r.cpu().numpy()
    assert (d[:, 1] == tseg.DIST_CLAMP).all() and (r[:, 1] == 0).all()
    assert (d[0, 4], r[0, 4]) == (0, 123)
    if n_q > 2:
        assert (d[1, 5], r[1, 5]) == (256, 0)
        assert (d[2, 3], r[2, 3]) == (0, 5)


@pytest.mark.cuda
def test_b1_refuses_what_it_cannot_take():
    dev = _cuda()
    rng = np.random.default_rng(1)
    _, db = _edge_case_db(rng, dev)
    q = torch.from_numpy(rng.integers(0, 256, (8, 32), dtype=np.uint8))
    with pytest.raises(ValueError):
        tseg.object_top1(q.to(dev).to(torch.int32), db)     # dtype
    with pytest.raises(ValueError):
        tseg.object_top1(q.to(dev)[:, :16], db)              # width
    with pytest.raises(ValueError):
        tseg.object_top1(q.to(dev).view(-1)[1:161].view(5, 32), db)  # align
    cpu_db = tseg.pack_segmented([TodModel("a", np.zeros((3, 32), np.uint8),
                                           np.zeros((3, 3), np.float32))],
                                 device="cpu")
    with pytest.raises(ValueError):
        tseg.object_top1(q.to(dev), cpu_db)                  # DB elsewhere


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", sorted({512, 300, *TILE_Q}))
def test_b2_matches_twin_and_b1_columns(n_q):
    """B2 on objects of 0-4500 rows (ties over equal rows, distances 0 and
    256), with holes at -1 and past the catalog, repeated and out-of-order
    ids and a selection of holes only."""
    dev = _cuda()
    rng = np.random.default_rng(100 + n_q)
    descs, db = _edge_case_db(rng, dev)
    q = rng.integers(0, 256, (max(n_q, 3), 32), dtype=np.uint8)
    q[0] = descs[4][123]
    q[1] = ~descs[5][0]
    q[2] = descs[3][5]
    q = torch.from_numpy(q[:n_q]).to(dev)
    d_b1, r_b1 = tseg.object_top1(q, db)
    # holes, a repeated id, out-of-order ids, an id past the catalog
    for sel in ([4, -1, 2, 1, 4, 0, -1, 6, 3, 9, 5], [-1, 9]):
        sel = torch.tensor(sel, dtype=torch.int32, device=dev)
        before = tseg.object_top1_gathered.launches
        d, r = tseg.object_top1_gathered(q, db, sel)
        torch.cuda.synchronize()
        assert tseg.object_top1_gathered.launches == before + 1
        d_t, r_t = tseg.object_top1_gathered_torch(q, db, sel)
        assert torch.equal(d, d_t) and torch.equal(r, r_t)
        real = (sel >= 0) & (sel < db.n_objects)
        cols = sel[real].long()
        assert torch.equal(d[:, real], d_b1[:, cols])
        assert torch.equal(r[:, real], r_b1[:, cols])
        assert (d[:, ~real] == tseg.HOLE_DIST).all()
        assert (r[:, ~real] == tseg.HOLE_ROW).all()
    assert (d_b1[0, 4].item(), r_b1[0, 4].item()) == (0, 123)


def _tile_case_hamming(seed, n_q, device):
    """``edge_case_arrays_hamming_tiles`` (objects of 0-300 rows, ties
    across B1's fragments, lanes and tiles, all-zero and all-one rows and
    queries) in segments padded to reserved rows: ``(db, queries)``."""
    descs, q = edge_case_arrays_hamming_tiles(seed, n_q)
    models = [TodModel(f"o{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return tseg.pack_segmented(models, db_chunk=256, reserve_rows=200,
                               device=device), \
        torch.from_numpy(q).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", TILE_Q)
def test_b1_b2_match_twins_at_the_tile_edges(n_q):
    dev = _cuda()
    db, q = _tile_case_hamming(700 + n_q, n_q, dev)
    before = tseg.object_top1.launches
    d, r = tseg.object_top1(q, db)
    torch.cuda.synchronize()
    assert tseg.object_top1.launches == before + 1
    d_t, r_t = tseg.object_top1_torch(q, db)
    assert torch.equal(d, d_t) and torch.equal(r, r_t)
    assert (d[:, 1] == tseg.DIST_CLAMP).all() and (r[:, 1] == 0).all()
    assert (d[0, 8].item(), r[0, 8].item()) == (0, 7)
    if n_q > 3:
        assert (d[1, 8].item(), r[1, 8].item()) == (0, 200)
        assert (d[2, 8].item(), r[2, 8].item()) == (0, 201)
        assert (d[3, 7].item(), r[3, 7].item()) == (0, 128)
        # |q| = 0 and 256 against every object with rows: dist |r| and
        # 256 - |r|, within [0, 256]
        full = torch.tensor(db.rows_host, device=dev) > 0
        assert (d[1:3, full] >= 0).all() and (d[1:3, full] <= 256).all()
    for sel in (EDGE_SEL, [8, 8, 1, 0]):
        sel = torch.tensor(sel, dtype=torch.int32, device=dev)
        d2, r2 = tseg.object_top1_gathered(q, db, sel)
        torch.cuda.synchronize()
        d2_t, r2_t = tseg.object_top1_gathered_torch(q, db, sel)
        assert torch.equal(d2, d2_t) and torch.equal(r2, r2_t)
        real = (sel >= 0) & (sel < db.n_objects)
        cols = sel[real].long()
        assert torch.equal(d2[:, real], d[:, cols])
        assert torch.equal(r2[:, real], r[:, cols])
        assert (d2[:, ~real] == tseg.HOLE_DIST).all()


@pytest.mark.cuda
def test_b2_refuses_what_it_cannot_take():
    dev = _cuda()
    rng = np.random.default_rng(2)
    _, db = _edge_case_db(rng, dev)
    q = torch.from_numpy(rng.integers(0, 256, (8, 32), dtype=np.uint8)).to(dev)
    sel = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tseg.object_top1_gathered(q, db, sel.long())             # dtype
    with pytest.raises(ValueError):
        tseg.object_top1_gathered(q, db, sel.cpu())               # device
    with pytest.raises(ValueError):
        tseg.object_top1_gathered(q, db, torch.zeros(
            70000, dtype=torch.int32, device=dev))                # grid y


# ---- B3 and B4: int8 squared L2 --------------------------------------------

def _edge_cases_l2(seed, n_q, device):
    """The shared L2 edge cases (an empty object, a one-row object, ties
    within and across row tiles, a query at distance 0, a zero query),
    packed with reserved rows: ``(db, queries)``. With ``n_q`` = 1 only
    the distance-0 query is left."""
    descs, q = edge_case_arrays_l2(seed, long_rows=4500, n_q=n_q)
    models = [TodModel(f"o{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return tl2.pack_segmented_l2(models, db_chunk=2048, reserve_rows=100,
                                 device=device), \
        torch.from_numpy(q).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [512, 300, 1])
def test_b3_matches_twin(n_q):
    dev = _cuda()
    db, q = _edge_cases_l2(200 + n_q, n_q, dev)
    before = tl2.object_top1_l2.launches
    d_sq, r = tl2.object_top1_l2_sq(q, db)
    torch.cuda.synchronize()
    assert tl2.object_top1_l2.launches == before + 1
    d_sq_t, r_t = tl2.object_top1_l2_sq_torch(q, db)
    assert d_sq.dtype == torch.int32
    assert torch.equal(d_sq, d_sq_t) and torch.equal(r, r_t)
    d, r2 = tl2.object_top1_l2(q, db)
    d_t, _ = tl2.object_top1_l2_torch(q, db)
    assert torch.equal(d, d_t) and torch.equal(r2, r_t)
    q_norm = (q.to(torch.int64) ** 2).sum(1)
    assert torch.equal(d_sq[:, 1].long(), q_norm + tl2.PAD_NORM)
    assert (r[:, 1] == 0).all()
    assert (d_sq[0, 4].item(), r[0, 4].item()) == (0, 123)
    if n_q > 3:
        assert (d_sq[1, 3].item(), r[1, 3].item()) == (0, 5)
        assert (d_sq[2, 2].item(), r[2, 2].item()) == (0, 7)


def _full_range_case_l2(seed, n_q, device):
    """``edge_case_arrays_l2_int8`` (the full int8 range, short objects,
    ties across the kernel's fragments and tiles) in segments padded to
    reserved rows, so that padding sits in the same 128-row tile as real
    rows: ``(db, queries)``."""
    descs, q = edge_case_arrays_l2_int8(seed, n_q)
    models = [TodModel(f"o{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return tl2.pack_segmented_l2(models, db_chunk=256, reserve_rows=200,
                                 device=device), \
        torch.from_numpy(q).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 15, 16, 17, 63, 65, 255, 257, 2048])
def test_b3_matches_twin_over_the_full_int8_range(n_q):
    dev = _cuda()
    db, q = _full_range_case_l2(600 + n_q, n_q, dev)
    d_sq, r = tl2.object_top1_l2_sq(q, db)
    torch.cuda.synchronize()
    d_sq_t, r_t = tl2.object_top1_l2_sq_torch(q, db)
    assert torch.equal(d_sq, d_sq_t) and torch.equal(r, r_t)
    assert (d_sq[0, 8].item(), r[0, 8].item()) == (0, 7)
    q_norm = (q.to(torch.int64) ** 2).sum(1)
    assert torch.equal(d_sq[:, 1].long(), q_norm + tl2.PAD_NORM)
    if n_q > 3:
        assert (d_sq[1, 8].item(), r[1, 8].item()) == (0, 200)
        assert (d_sq[2, 8].item(), r[2, 8].item()) == (0, 201)
        assert (d_sq[3, 7].item(), r[3, 7].item()) == (0, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [512, 300, 1])
def test_b4_matches_twin_and_b3_columns(n_q):
    dev = _cuda()
    db, q = _edge_cases_l2(300 + n_q, n_q, dev)
    # holes, a repeated id, out-of-order ids, an id past the catalog
    sel = torch.tensor([4, -1, 2, 1, 4, 0, -1, 6, 3, 9], dtype=torch.int32,
                       device=dev)
    before = tl2.object_top1_l2_gathered.launches
    d_sq, r = tl2.object_top1_l2_gathered_sq(q, db, sel)
    torch.cuda.synchronize()
    assert tl2.object_top1_l2_gathered.launches == before + 1
    d_sq_t, r_t = tl2.object_top1_l2_gathered_sq_torch(q, db, sel)
    assert torch.equal(d_sq, d_sq_t) and torch.equal(r, r_t)
    d_b3, r_b3 = tl2.object_top1_l2_sq(q, db)
    real = (sel >= 0) & (sel < db.n_objects)
    cols = sel[real].long()
    assert torch.equal(d_sq[:, real], d_b3[:, cols])
    assert torch.equal(r[:, real], r_b3[:, cols])
    assert (d_sq[:, ~real] == tl2.DIST_INVALID).all()
    assert (r[:, ~real] == tl2.HOLE_ROW_L2).all()
    d, _ = tl2.object_top1_l2_gathered(q, db, sel)
    assert (d[:, ~real] == tl2.HOLE_DIST_L2).all()
    assert (d_sq[0, 0].item(), r[0, 0].item()) == (0, 123)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", TILE_Q)
def test_b4_matches_twin_and_b3_columns_over_the_full_int8_range(n_q):
    dev = _cuda()
    db, q = _full_range_case_l2(800 + n_q, n_q, dev)
    sel = torch.tensor(EDGE_SEL, dtype=torch.int32, device=dev)
    before = tl2.object_top1_l2_gathered.launches
    d_sq, r = tl2.object_top1_l2_gathered_sq(q, db, sel)
    torch.cuda.synchronize()
    assert tl2.object_top1_l2_gathered.launches == before + 1
    d_sq_t, r_t = tl2.object_top1_l2_gathered_sq_torch(q, db, sel)
    assert torch.equal(d_sq, d_sq_t) and torch.equal(r, r_t)
    d_b3, r_b3 = tl2.object_top1_l2_sq(q, db)
    real = (sel >= 0) & (sel < db.n_objects)
    cols = sel[real].long()
    assert torch.equal(d_sq[:, real], d_b3[:, cols])
    assert torch.equal(r[:, real], r_b3[:, cols])
    assert (d_sq[:, ~real] == tl2.DIST_INVALID).all()
    assert (r[:, ~real] == tl2.HOLE_ROW_L2).all()
    assert (d_sq[0, 0].item(), r[0, 0].item()) == (0, 7)       # slot 0: o8
    if n_q > 3:
        assert (d_sq[1, 0].item(), r[1, 0].item()) == (0, 200)
        assert (d_sq[2, 0].item(), r[2, 0].item()) == (0, 201)
        assert (d_sq[3, 7].item(), r[3, 7].item()) == (0, 128)  # slot 7: o7


@pytest.mark.cuda
def test_b3_b4_refuse_what_they_cannot_take():
    dev = _cuda()
    rng = np.random.default_rng(3)
    db, _ = _edge_cases_l2(3, 8, dev)
    q = torch.from_numpy(rng.integers(0, 128, (8, 128)).astype(np.int8))
    sel = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tl2.object_top1_l2(q.to(dev).to(torch.uint8), db)        # dtype
    with pytest.raises(ValueError):
        tl2.object_top1_l2(q.to(dev)[:, :64], db)                 # width
    with pytest.raises(ValueError):
        tl2.object_top1_l2(
            q.to(dev).view(-1)[1:641].view(5, 128), db)           # alignment
    cpu_db = tl2.pack_segmented_l2(
        [TodModel("a", np.zeros((3, 128), np.int8),
                  np.zeros((3, 3), np.float32))], device="cpu")
    with pytest.raises(ValueError):
        tl2.object_top1_l2(q.to(dev), cpu_db)                     # DB elsewhere
    with pytest.raises(ValueError):
        tl2.object_top1_l2_gathered(q.to(dev), db, sel.long())    # dtype
    with pytest.raises(ValueError):
        tl2.object_top1_l2_gathered(q.to(dev), db, sel.cpu())     # device
    with pytest.raises(ValueError):
        tl2.object_top1_l2_gathered(q.to(dev), db, torch.zeros(
            70000, dtype=torch.int32, device=dev))                # grid y


# ---- B5 and T1: radius k-NN over the whole DB ------------------------------

def _edge_cases_hamming(seed, n_q, device, n_rows=20000):
    """Rows with row 10 copied across the kernel's own split boundaries
    (for this Q) and inside one split, and the queries of
    ``edge_case_arrays_hamming`` (with ties across the sweep's fragments
    and tiles)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_split, per = tham.split_plan(n_q, n_rows, n_sm)
    assert n_split > 2
    db, q = edge_case_arrays_hamming(seed, n_rows, max(n_q, 70),
                                     [per * s for s in range(1, n_split)])
    return (tham.pack_db_bits(torch.from_numpy(db).to(device)),
            torch.from_numpy(q[:n_q]).to(device), per)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [512, 300, 1, 15, 16, 17, 63, 65, 5000])
@pytest.mark.parametrize("k, radius", [(5, 35), (8, 50), (5, None), (1, 0)])
def test_b5_matches_twin(n_q, k, radius):
    dev = _cuda()
    words, q, per = _edge_cases_hamming(500 + n_q, n_q, dev)
    n = words.shape[0]
    for n_valid in (n, n - 77, 3, 0, 1, 7, 8, 9, 127, 128, 129, 255, 257,
                    per - 1, per, per + 1, 2 * per + 1):
        before = tham.hamming_topk_fused.launches
        d, i = tham.hamming_topk_fused(q, words, n_valid, k=k, radius=radius)
        torch.cuda.synchronize()
        assert tham.hamming_topk_fused.launches == before + 1
        d_t, i_t = tham.hamming_topk_fused_torch(q, words, n_valid, k, radius)
        assert torch.equal(d, d_t) and torch.equal(i, i_t), n_valid
    d, i = tham.hamming_topk_fused(q, words, words.shape[0], k=k,
                                   radius=radius)
    # query 0 equals row 10 and its copies across the split boundaries
    assert i[0, 0].item() == 10 and d[0, 0].item() == 0
    if k > 4:
        assert i[0, 1:5].tolist() == [1000, 1001, 1002, 1003]
    if n_q > 67:
        assert i[67].tolist() == HAMMING_TILE_TIES[:k]
        assert (d[67] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(tham.PROBE_ROUTES))
@pytest.mark.parametrize("n_q", [300, 17, 5000])
def test_t1_modes_match_plain_versions(route, n_q):
    dev = _cuda()
    words, q, _ = _edge_cases_hamming(9, n_q, dev)
    for n_valid in (words.shape[0], 5000, 129, 1):
        for mode in tham.PROBE_MODES:
            before = tham.hamming_probe.launches
            got = tham.hamming_probe(q, words, n_valid, mode, route)
            torch.cuda.synchronize()
            assert tham.hamming_probe.launches == before + 1
            want = tham.hamming_probe_torch(q, words, n_valid, mode)
            assert torch.equal(got, want), (mode, n_valid)


@pytest.mark.cuda
def test_b5_route_is_a_tensor_core_route():
    _cuda()
    assert tham.b5_route() in ("s8", "b1")


@pytest.mark.cuda
def test_b5_refuses_what_it_cannot_take():
    dev = _cuda()
    words, q, _ = _edge_cases_hamming(10, 128, dev)
    n = words.shape[0]
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(q.to(torch.int32), words, n)         # dtype
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(q[:, :16], words, n)                  # width
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(q.view(-1)[1:161].view(5, 32), words, n)
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(q, words.cpu(), n)                    # device
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(q, words, n + 1)                      # n_valid
    with pytest.raises(ValueError):
        tham.hamming_topk_fused(q, words, n, k=9)                     # k
    with pytest.raises(ValueError):
        tham.hamming_probe(q, words, n, "dot_only")                   # mode
    with pytest.raises(ValueError):
        tham.hamming_probe(q, words, n, "row_min", "bf16")            # route


# ---- the model dedup on B5 (training) -------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [2, 9, 400, 3000, 20000])
@pytest.mark.parametrize("radius", [8, 16])
def test_b5_matches_twin_at_the_dedup_shapes(n_rows, radius):
    """A model's rows against themselves (Q = N), k = 8: exact duplicates
    at distance 0 (more than k), chains and equal-distance ties, and rows
    just inside and outside the radius."""
    dev = _cuda()
    d, _ = dedup_case_arrays(n_rows, max(n_rows, 64))
    rows = torch.from_numpy(d[:n_rows]).to(dev)
    words = tham.pack_db_bits(rows)
    k = min(8, n_rows)
    before = tham.hamming_topk_fused.launches
    got = tham.hamming_topk_fused(rows, words, n_rows, k=k, radius=radius)
    torch.cuda.synchronize()
    assert tham.hamming_topk_fused.launches == before + 1
    want = tham.hamming_topk_fused_torch(rows, words, n_rows, k, radius)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # every row finds itself (or an equal earlier row) first
    assert (got[0][:, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [0, 1, 2, 400, 20000])
def test_compress_model_on_the_card_equals_the_cpu_path(n_rows):
    dev = _cuda()
    d, p = dedup_case_arrays(7, max(n_rows, 64))
    d, p = d[:n_rows], p[:n_rows]
    for hamming in (8, 16):
        before = tham.hamming_topk_fused.launches
        got = tcompress.compress_model(d, p, hamming, 0.005, device=dev)
        assert tham.hamming_topk_fused.launches == before + (n_rows > 1)
        want = tcompress.compress_model(d, p, hamming, 0.005, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ---- the reference's threefry noise on the card ----------------------------

@pytest.mark.cuda
def test_noise_on_the_card_equals_the_cpus():
    """Bits and uniforms bit for bit; Gumbel values within the bound of
    tests/test_torch_prng.py (each log within an ulp on either device)."""
    dev = _cuda()
    keys = prng.split(prng.split(prng.prng_key(2**31 - 1), 16), 3)
    for shape in [(128, 192), (512, 384), (7,)]:
        bits = prng.random_bits(keys, shape, dev)
        assert torch.equal(bits.cpu(), prng.random_bits(keys, shape))
        u = prng.uniform(keys, shape, prng.F32_TINY, 1.0, dev)
        assert torch.equal(u.cpu(), prng.uniform(keys, shape, prng.F32_TINY))
    noise = {d: ThreefryNoise(prng.split(prng.prng_key(5))[1], 3, True, d)
             for d in (dev, torch.device("cpu"))}
    for stage, shape in [("tier1", (32, 3, 128, 192)),
                         ("round0", (16, 3, 512, 384)),
                         ("round2", (16, 3, 128, 384))]:
        got = noise[dev](stage, shape)
        assert got.is_cuda and got.shape == shape
        ref = noise[torch.device("cpu")](stage, shape).double()
        gap = (got.cpu().double() - ref).abs()
        bound = 2.0 ** -22 + 2.0 * torch.from_numpy(
            np.spacing(np.abs(ref.float().numpy())).astype(np.float64))
        assert (gap <= bound).all(), float(gap.max())


# ---- kernel N1: threefry + Gumbel ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 3, 128, 192), (3, 3, 7, 9),
                                   (5, 3, 13, 1), (32, 3, 128, 192),
                                   (16, 3, 1024, 512), (21846, 3, 1, 5)],
                         ids=["A0", "odd", "odd1", "tier1", "global",
                              "keys_past_grid_y"])
def test_n1_matches_twins_on_the_card(shape):
    """Bits equal random_bits on the card bit for bit; Gumbel values equal
    gumbel_torch on the card bit for bit (both call logf), or, if some
    differ, within the bound of tests/test_torch_prng.py; one launch a
    call (none for A = 0)."""
    dev = _cuda()
    n_obj, _, n, m = shape
    keys = prng.split(prng.split(prng.prng_key(2**31 - 1 - n), n_obj), 3)
    launched = int(n_obj > 0)
    before = prng.threefry_bits.launches
    bits = prng.threefry_bits(keys, (n, m), dev)
    torch.cuda.synchronize()
    assert prng.threefry_bits.launches == before + launched
    assert bits.is_cuda and bits.dtype == torch.int32 and bits.shape == shape
    assert torch.equal(bits.to(torch.int64) & prng.MASK,
                       prng.random_bits(keys, (n, m), dev))
    assert torch.equal(bits, prng.threefry_bits_torch(keys, (n, m), dev))
    before = prng.gumbel.launches
    g = prng.gumbel(keys, (n, m), dev)
    torch.cuda.synchronize()
    assert prng.gumbel.launches == before + launched
    assert g.is_cuda and g.dtype == torch.float32 and g.shape == shape
    ref = prng.gumbel_torch(keys, (n, m), dev)
    differ = int((g != ref).sum())
    if differ:
        gap = (g.double() - ref.double()).abs()
        bound = 2.0 ** -22 + 2.0 * torch.from_numpy(np.spacing(
            np.abs(ref.cpu().numpy())).astype(np.float64)).to(dev)
        assert (gap <= bound).all(), (differ, float(gap.max()))
    print(f"N1 {shape}: {differ} of {g.numel()} Gumbel values differ from "
          "the twin's on the card")


@pytest.mark.cuda
def test_n1_refuses_what_it_cannot_take():
    dev = _cuda()
    key = prng.prng_key(0)
    with pytest.raises(ValueError):
        prng.gumbel(key, (1 << 16, 1 << 15), dev)            # 2^31 draws
    with pytest.raises(ValueError):
        prng.threefry_bits(np.zeros((4, 3), np.uint32), (4,), dev)


# ---- the batched query counts of detect_batch_raw --------------------------

# B x q_cap (B1, B3) and B x 5000 (B5) at B = 2 and 4, and one short of a
# tile
BATCH_Q = [2 * 2048, 4 * 2048, 4 * 2048 - 77]
BATCH_Q_GLOBAL = [2 * 5000, 4 * 5000, 4 * 5000 - 77]


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", BATCH_Q)
def test_b1_b3_match_twins_at_the_batched_q(n_q):
    """B1 and B3 bit for bit against their twins over the edge-case DBs at
    the query counts of a batch of frames folded into the query axis."""
    dev = _cuda()
    rng = np.random.default_rng(n_q)
    _, db = _edge_case_db(rng, dev)
    q = torch.from_numpy(rng.integers(0, 256, (n_q, 32),
                                      dtype=np.uint8)).to(dev)
    d, r = tseg.object_top1(q, db)
    d_t, r_t = tseg.object_top1_torch(q, db)
    assert torch.equal(d, d_t) and torch.equal(r, r_t)
    db_l2, _ = _edge_cases_l2(300 + n_q, 1, dev)
    q8 = torch.from_numpy(rng.integers(-128, 128, (n_q, 128),
                                       dtype=np.int8)).to(dev)
    d_sq, r = tl2.object_top1_l2_sq(q8, db_l2)
    d_sq_t, r_t = tl2.object_top1_l2_sq_torch(q8, db_l2)
    assert torch.equal(d_sq, d_sq_t) and torch.equal(r, r_t)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", BATCH_Q_GLOBAL)
def test_b5_matches_twin_at_the_batched_q(n_q):
    """B5 bit for bit against its twin at the global path's operating
    point (k 5, radius 35) at the query counts of a batch of frames."""
    dev = _cuda()
    words, q, _ = _edge_cases_hamming(700 + n_q, n_q, dev)
    for n_valid in (words.shape[0], words.shape[0] - 77):
        d, i = tham.hamming_topk_fused(q, words, n_valid, k=5, radius=35)
        d_t, i_t = tham.hamming_topk_fused_torch(q, words, n_valid, 5, 35)
        assert torch.equal(d, d_t) and torch.equal(i, i_t), n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [prng.gumbel, prng.threefry_bits],
                         ids=["gumbel", "bits"])
def test_n1_wrappers_default_to_the_card(fn):
    """Named no device, N1's wrappers launch the kernel on the card."""
    dev = _cuda()
    keys = prng.split(prng.split(prng.prng_key(12), 4), 3)
    before = fn.launches
    got = fn(keys, (128, 192))
    torch.cuda.synchronize()
    assert got.is_cuda and fn.launches == before + 1
    assert torch.equal(got, fn(keys, (128, 192), dev))


# ---- the 2D-only path (P3P graph-RANSAC) on the card -----------------------

def _scene_2d(seed: int = 11):
    """Flat (Q, 1) matches of two near-planar objects seen at two poses
    (60 and 40 true matches among junk) and one object of five keypoints;
    K of the smoke frames. numpy only."""
    rng = np.random.default_rng(seed)
    K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]],
                 np.float32)
    q = 160
    obj = np.full((q, 1), 2, np.int32)
    xy = rng.uniform([0, 0], [640, 480], (q, 2)).astype(np.float32)
    train = rng.uniform(-0.12, 0.12, (q, 1, 3)).astype(np.float32)
    for o, (lo, n_true, n_all) in enumerate([(0, 60, 90), (90, 40, 155)]):
        ax = rng.uniform(-0.4, 0.4, 3)
        th = np.linalg.norm(ax)
        k = ax / th
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        T = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                      0.8 + 0.2 * o])
        X = train[lo:lo + n_true, 0]
        X[:, 2] *= 0.05
        uv = (X @ R.T + T) @ K.T
        xy[lo:lo + n_true] = uv[:, :2] / uv[:, 2:3] + rng.normal(
            0, 0.3, (n_true, 2))
        obj[lo:n_all] = o
    valid = np.ones((q, 1), bool)
    dist = rng.uniform(10, 30, (q, 1)).astype(np.float32)
    return obj, dist, valid, train, xy, K


@pytest.mark.cuda
def test_2d_path_on_the_card_equals_the_cpus():
    """detect_frame_2d on the card against the CPU: the same accepts and
    unique-inlier counts, poses within 1e-3; one N1 launch a round; and a
    round (ransac_round_2d) that never waits for the host."""
    from tod_tpu_torch.geometry import detection2d as td

    dev = _cuda()
    arrays = _scene_2d()
    cfg = td.Pnp2dConfig(n_hypotheses=256, min_inliers=8, max_instances=3)
    out = {}
    for d in (torch.device("cpu"), dev):
        noise = ThreefryNoise(prng.prng_key(7), cfg.max_instances, False, d)
        t = [torch.from_numpy(a).to(d) for a in arrays]
        before = prng.gumbel.launches
        out[d.type] = td.detect_frame_2d(noise, *t[:5], t[5],
                                         torch.arange(3, device=d), 128, cfg)
        torch.cuda.synchronize()
        if d.type == "cuda":
            assert prng.gumbel.launches == before + cfg.max_instances
    cpu, gpu = out["cpu"], out["cuda"]
    acc = cpu.accepted
    assert acc[0, 0] and acc[1, 0] and not acc[2].any()
    assert torch.equal(gpu.accepted.cpu(), acc)
    assert torch.equal(gpu.n_inliers.cpu()[acc], cpu.n_inliers[acc])
    for name in ("R", "T"):
        gap = (getattr(gpu, name).cpu() - getattr(cpu, name))[acc].abs()
        assert float(gap.max()) < 1e-3, name

    t = [torch.from_numpy(a).to(dev) for a in arrays]
    from tod_tpu_torch.geometry.detection import cluster_matches
    m = cluster_matches(t[0], t[1], t[2], t[3],
                        torch.zeros((len(t[0]), 3), device=dev), t[4],
                        torch.arange(2, device=dev), 128)
    g = ThreefryNoise(prng.prng_key(7), 1, False, dev)(
        "round0", (2, 3, cfg.n_hypotheses, 128))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        found = td.ransac_round_2d(g, m, t[5], m.valid, cfg)[4]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(found.all())


@pytest.mark.cuda
def test_stage_timer_on_the_card():
    """CUDA-event stages: read in report(), positive, the reference's
    format."""
    from tod_tpu_torch.utils.profiling import StageTimer, timed

    dev = _cuda()
    a = torch.ones((2048, 2048), device=dev)
    timer = StageTimer(dev)
    for _ in range(3):
        with timer.stage("matmul"):
            a @ a
        with timer.stage("add"):
            a + a
    report = timer.report()
    assert timer.times["matmul"] > timer.times["add"] > 0
    assert report.splitlines()[0].lstrip().startswith("matmul ")
    assert timed(lambda: a @ a, n=3) > 0


def _batch_scene(dev, n_obj: int = 16, m: int = 384):
    """Per-object stores of ``m`` matches (80 % valid) whose query points
    are the model points moved 0.8 m away with 2 mm of noise, and one
    round's Gumbel draws, made from a seed on the host."""
    from tod_tpu_torch.geometry.adjacency import ObjectMatches

    g = torch.Generator().manual_seed(0)
    t = torch.rand(n_obj, m, 3, generator=g) * 0.3
    q = t + torch.tensor([0.0, 0.0, 0.8]) \
        + 0.002 * torch.rand(n_obj, m, 3, generator=g)
    u = torch.rand(n_obj, 3, 128, m, generator=g).clamp(1e-6, 1 - 1e-6)
    matches = ObjectMatches(
        q, t, torch.arange(m).expand(n_obj, m).contiguous(),
        torch.rand(n_obj, m, 2, generator=g) * 600,
        torch.rand(n_obj, m, generator=g) < 0.8)
    return (ObjectMatches(*(x.to(dev) for x in matches)),
            (-torch.log(-torch.log(u))).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 4, 1])
def test_fits_do_not_depend_on_the_batch(n):
    """On the card each object's refit (a weighted Horn fit over 384
    matches), its adjacency graphs (the pairwise distances' batched
    product), its 3-path log-weights and its whole RANSAC round are the
    same in a batch of 16 objects and of ``n`` (the sharded paths run an
    object's tiers in smaller batches than one device, down to one)."""
    from tod_tpu_torch.geometry import adjacency as tadj
    from tod_tpu_torch.geometry import ransac as tran
    from tod_tpu_torch.geometry.transforms import kabsch

    dev = _cuda()
    m, gum = _batch_scene(dev)
    spans = torch.full((16,), 0.5, device=dev)

    def run(k):
        part = type(m)(*(x[:k] for x in m))
        graphs = tadj.fill_adjacency(part, spans[:k], 0.01)
        fit = kabsch(part.query_pts, part.train_pts, part.valid.float())
        logw = tran.consistency_log_weights(graphs.sample | True,
                                            part.valid)
        rnd = tran.ransac_round(gum[:k], part, graphs, graphs.valid,
                                tran.RansacConfig(n_hypotheses=128))
        return (fit.R, fit.T, logw, *graphs, *rnd)

    for a, b in zip(run(16), run(n)):
        assert torch.equal(a[:n], b)


@pytest.mark.cuda
def test_sharded_matchers_on_the_card():
    """The row-sharded B5 (plain and ring) and the object-sharded B1 on
    the card named four times, at (1 x 4) and (2 x 2), against the
    single-device kernels, bit for bit."""
    from tod_tpu_torch.parallel import (make_mesh, pack_segmented_sharded,
                                        ring_hamming_topk,
                                        sharded_hamming_topk,
                                        sharded_object_top1)

    dev = _cuda()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(0, 256, (300, 32), dtype=np.uint8)
                         ).to(dev)
    db = torch.from_numpy(rng.integers(0, 256, (4 * 4096, 32),
                                       dtype=np.uint8)).to(dev)
    words = tham.pack_db_bits(db)
    want = tham.hamming_topk_fused(q, words, len(db) - 77, k=5, radius=120)
    models = [TodModel(f"o{i}", rng.integers(0, 256, (50 + 31 * i, 32),
                                             dtype=np.uint8),
                       np.zeros((50 + 31 * i, 3), np.float32))
              for i in range(7)]
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(*shape, devices=[dev] * 4)
        for fn in (sharded_hamming_topk, ring_hamming_topk):
            got = fn(mesh, q, words, len(db) - 77, k=5, chunk=4096,
                     radius=120)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        sdb, ids = pack_segmented_sharded(models, mesh, db_chunk=2048)
        by_id = {mm.object_id: mm for mm in models}
        one = tseg.pack_segmented(
            [by_id[i] if i else TodModel("", np.zeros((0, 32), np.uint8),
                                         np.zeros((0, 3), np.float32))
             for i in ids], db_chunk=2048, device=dev)
        got = sharded_object_top1(mesh, q, sdb)
        assert all(torch.equal(a, b) for a, b in
                   zip(got, tseg.object_top1(q, one)))
