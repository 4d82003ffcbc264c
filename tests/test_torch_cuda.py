"""The port's CUDA kernels (B1, B2, B3, B4 of the SIFT/L2 path, and B5 and
its isolation modes T1 of the global-kNN path, on every route, with B5 also
at the training dedup's shapes) against
their plain PyTorch twins, on the card, with the edges of the tensor-core
tiles (ragged Q and n_valid, short objects beside padding, the full int8
range, all-zero and all-one descriptors, ties across fragments, lanes,
tiles and splits); and the threefry noise kernel N1 against its twins on
the card and the same draws on the CPU; L1 (the host libm's atan2f), L2
(the fused SIFT descriptor), L3 (the fused L2 matcher and its distance
tile), P1 (P3P), L4 (glibc's cosf, sincosf, powf; XLA's log), M1 and M2
(the 2D path's mirror and model normal) and R1 (its reprojection
consensus, every mode) against their plain versions, bit for bit; and the
2D path on the card against the CPU, bit for bit.

Every test here is marked ``cuda`` and skips without a GPU. The file needs
neither JAX nor the JAX package, so it also runs on a machine that has
only torch; there, skip the repository's conftest (which sets up JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os

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
    """detect_frame_2d on the card against the CPU: every field bit for
    bit (the round rounds alike on both devices: P1 against its twin, fixed
    sums, the C library's functions); one N1 launch a round; and a round
    (ransac_round_2d) that never waits for the host."""
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
    for name, a, b in zip(cpu._fields, cpu, gpu):
        assert torch.equal(b.cpu(), a), name

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


# ---- L1 (the host libm's atan2f), L2 (the fused SIFT descriptor), L3 --------

def _atan2_pairs():
    """Random pairs over 6 decades, all integer pairs in [-255, 255]^2 and
    the special values, as float32 (y, x)."""
    rng = np.random.default_rng(11)
    n = 1_000_000
    y = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    g = np.arange(-255, 256)
    gy, gx = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-45,
                     1.17549435e-38, 3.4028235e38, 2.0 ** 26, 2.0 ** 60,
                     2.0 ** -60])
    sy, sx = (a.ravel() for a in np.meshgrid(vals, vals, indexing="ij"))
    return (np.concatenate([y, gy, sy]).astype(np.float32),
            np.concatenate([x, gx, sx]).astype(np.float32))


@pytest.mark.cuda
def test_l1_matches_plain_atan2f():
    """Kernel L1 against the plain version on the CPU, bit for bit (NaN
    where NaN), over 10^6 random pairs, every integer pair of 8-bit
    differences and the special values; one launch a call."""
    from tod_tpu_torch.ops import libm

    dev = _cuda()
    y, x = (torch.from_numpy(a) for a in _atan2_pairs())
    want = libm.atan2f_torch(y, x)
    before = libm.atan2f.launches
    got = libm.atan2f(y.to(dev), x.to(dev)).cpu()
    assert libm.atan2f.launches == before + 1
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    assert libm.atan2f(y[:0].to(dev), x[:0].to(dev)).shape == (0,)


def _describe_case(k_count: int, seed: int):
    """A (200, 260) float32 level with smooth and noisy parts, ``k_count``
    keypoints (integer xy, some near the border where the patch's start is
    clamped) and angles (half-bin angles and +-pi among them)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:200, 0:260]
    img = (100 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
           + rng.normal(0, 8, (200, 260))).astype(np.float32)
    xy = np.stack([rng.integers(0, 260, k_count),
                   rng.integers(0, 200, k_count)], -1).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, k_count).astype(np.float32)
    angle[:8] = (np.arange(8)[:k_count] + 0.5) * np.float32(2 * np.pi / 32)
    angle[8:10] = [np.pi, -np.pi][:max(0, k_count - 8)]
    return (torch.from_numpy(img), torch.from_numpy(xy),
            torch.from_numpy(angle))


@pytest.mark.cuda
@pytest.mark.parametrize("k_count, batch", [(1, 1), (3, 1), (4, 1), (7, 1),
                                            (30, 1), (905, 1), (1978, 1),
                                            (271, 12), (330, 2)])
def test_l2_fused_matches_plain_chain(k_count, batch):
    """Kernel L2 (the fused SIFT descriptor: patches, gradients, L1's
    atan2f, soft bins, the contraction in the reference's order and Lowe's
    normalisation) against the plain chain on the CPU, bit for bit, in
    each summation order (lanes, parity, chain) and at the serving and
    training widths; one launch a call."""
    from tod_tpu_torch.ops import sift as tsift

    dev = _cuda()
    img, xy, angle = _describe_case(k_count, k_count)
    want = tsift.sift_describe_torch(img, xy, angle, batch)
    before = tsift.sift_descriptors.launches
    got = tsift.sift_descriptors(img.to(dev), xy.to(dev), angle.to(dev),
                                 batch).cpu()
    assert tsift.sift_descriptors.launches == before + 1
    assert torch.equal(got, want), tsift.contraction_order(k_count, batch)


@pytest.mark.cuda
def test_l2_fused_refuses_what_it_cannot_take():
    from tod_tpu_torch.ops import sift as tsift

    dev = _cuda()
    img, xy, angle = (a.to(dev) for a in _describe_case(5, 1))
    assert tsift.sift_descriptors(img, xy[:0], angle[:0]).shape == (0, 128)
    for bad in ((img[:20], xy, angle), (img.double(), xy, angle),
                (img, xy[:, :1], angle), (img, xy, angle.cpu())):
        with pytest.raises(ValueError):
            tsift.sift_descriptors(*bad)


def _l2_rows(rng, n: int) -> np.ndarray:
    """SIFT-like rows (non-negative, unit norm, clipped at 0.2) and signed
    ones, half each."""
    x = rng.random((n // 2, 128)) ** 3
    x = np.minimum(x / np.linalg.norm(x, axis=1, keepdims=True), 0.2)
    return np.concatenate([x, rng.standard_normal((n - n // 2, 128))]
                          ).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q, chunk, n_valid", [
    (1, 4096, 4096), (1, 300, 257), (7, 4096, 4000), (100, 4096, 4096),
    (513, 4096, 1), (65, 100, 100), (63, 150, 77), (2, 30, 30)])
def test_l3_matches_plain_tile(n_q, chunk, n_valid):
    """Kernel L3 against its plain tile on the CPU, bit for bit, at each
    order (vector, chain, lanes, parity), ragged tiles and padding
    columns; one launch a call."""
    from tod_tpu_torch.ops import matching as tm

    dev = _cuda()
    rng = np.random.default_rng(n_q + chunk)
    q = torch.from_numpy(_l2_rows(rng, n_q))
    rows = torch.from_numpy(_l2_rows(rng, chunk))
    kind = tm.l2_order(n_q, chunk)
    want = tm.l2_distances_torch(q, rows, n_valid, kind)
    before = tm.l2_distances.launches
    got = tm.l2_distances(q.to(dev), rows.to(dev), n_valid, kind).cpu()
    assert tm.l2_distances.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), kind


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 513])
def test_l2_topk_on_the_card_equals_the_cpus(n_q):
    """The matcher's l2_topk on the card (one query: one L3 tile a chunk;
    more: one launch of the fused matcher) against the CPU path over three
    chunks with a partial last one and ties: every distance and row bit for
    bit."""
    from tod_tpu_torch.ops import matching as tm

    dev = _cuda()
    rng = np.random.default_rng(n_q)
    q = _l2_rows(rng, n_q)
    db = _l2_rows(rng, 3 * 4096)
    db[[17, 5000, 9000]] = q[0]
    want = tm.l2_topk(torch.from_numpy(q), torch.from_numpy(db), 10000)
    before = tm.l2_distances.launches, tm.l2_topk_fused.launches
    got = tm.l2_topk(torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev),
                     10000)
    assert (tm.l2_distances.launches, tm.l2_topk_fused.launches) == (
        (before[0] + 3, before[1]) if n_q == 1 else (before[0], before[1] + 1))
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_l3_refuses_what_it_cannot_take():
    from tod_tpu_torch.ops import matching as tm

    dev = _cuda()
    q = torch.zeros((3, 128), device=dev)
    for bad in ((q.double(), q), (q[:, :64], q), (q, q.cpu())):
        with pytest.raises(ValueError):
            tm.l2_distances(*bad, 3, "chain")
    with pytest.raises(RuntimeError):
        tm.l2_distances(q, q, 3, "vector")       # one query only


@pytest.mark.cuda
def test_features_on_the_card_equal_the_cpus():
    """ORB and SIFT through L1 and L2 (the fused SIFT descriptor) on the
    card: keypoints, angles and descriptors equal the CPU's plain path, bit
    for bit (the Harris responses are held elsewhere)."""
    from tod_tpu_torch.ops import orb as torb
    from tod_tpu_torch.ops import sift as tsift

    dev = _cuda()
    rng = np.random.default_rng(2)
    gray = torch.from_numpy(np.kron(rng.integers(0, 256, (30, 40)),
                                    np.ones((8, 8))).astype(np.float32))
    for detect in (torb.orb_detect_and_compute,
                   tsift.sift_detect_and_compute):
        k_c, d_c = detect(gray, n_features=1000)
        k_g, d_g = detect(gray.to(dev), n_features=1000)
        for name in ("xy", "angle", "level", "valid"):
            assert torch.equal(getattr(k_c, name), getattr(k_g, name).cpu())
        assert torch.equal(d_c, d_g.cpu())
        assert int(k_c.valid.sum()) > 200


# ---- L3's fused matcher, P1 and L4 ----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_q, n_valid, k", [
    (7, 4096 * 3 - 5, 5), (129, 300, 8), (513, 10000, 1), (300, 3, 5),
    (1, 9000, 5)])
def test_l3_fused_matches_the_chunk_loop_and_the_cpu(n_q, n_valid, k):
    """The fused matcher against the parent's chunk loop (L3 tiles,
    stable_topk, _merge_topk) on the card and its plain version on the CPU:
    ties across splits (rows repeated far apart), fewer valid rows than k,
    a partial last tile; distances and rows bit for bit."""
    from tod_tpu_torch.ops import matching as tm

    dev = _cuda()
    rng = np.random.default_rng(n_q + n_valid)
    q = torch.from_numpy(_l2_rows(rng, n_q))
    db = _l2_rows(rng, 3 * 4096)
    db[[2, 4000, 8000, 12000]] = db[1]
    db[[3, 7000]] = q[0].numpy()
    db = torch.from_numpy(db)
    want = tm._l2_topk_screened(q, db, n_valid, k, "chain")
    loop = tm.l2_topk_chunked(q.to(dev), db.to(dev), n_valid, k, 4096,
                              "chain")
    before = tm.l2_topk_fused.launches
    got = tm.l2_topk_fused(q.to(dev), db.to(dev), n_valid, k)
    assert tm.l2_topk_fused.launches == before + 1
    for d, i in (loop, want):
        assert torch.equal(got[0].cpu().view(torch.int32),
                           d.cpu().view(torch.int32))
        assert torch.equal(got[1].cpu(), i.cpu())


@pytest.mark.cuda
def test_l3_fused_refuses_what_it_cannot_take():
    from tod_tpu_torch.ops import matching as tm

    dev = _cuda()
    q = torch.zeros((3, 128), device=dev)
    for bad in ((q.double(), q, 5), (q[:, :64], q, 5), (q, q.cpu(), 5),
                (q, q, 9), (q, q, 0)):
        with pytest.raises(ValueError):
            tm.l2_topk_fused(bad[0], bad[1], 3, bad[2])


def _p3p_samples(rng, n):
    """``n`` samples of chip_smoke.py's generator (phase 3i's): half
    well-posed (a pose, three points, their rays), half random rays and
    points."""
    import chip_smoke

    return tuple(torch.from_numpy(a)
                 for a in chip_smoke.p3p_samples(rng, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 130, 4096])
def test_p1_matches_plain_version(n):
    """Kernel P1 against p3p_distances_torch on the CPU: every distance and
    validity bit for bit; one launch a call; and p3p's poses (P1, then the
    fixed-order Horn fit) equal on both devices."""
    from tod_tpu_torch.geometry import pnp

    dev = _cuda()
    bear, pts = _p3p_samples(np.random.default_rng(n), n)
    want = pnp.p3p_distances_torch(bear, pts)
    before = pnp.p3p_distances.launches
    got = pnp.p3p_distances(bear.to(dev), pts.to(dev))
    assert pnp.p3p_distances.launches == before + 1
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])
    cpu, card = pnp.p3p(bear, pts), pnp.p3p(bear.to(dev), pts.to(dev))
    for name, a, b in zip(cpu._fields, cpu, card):
        assert torch.equal(b.cpu(), a), name


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [0, 1, 2, 3])
def test_l4_libm_matches_plain_versions(fn):
    """L4's cosf, sincosf, powf and XLA's log against their plain versions on
    the CPU: 200,000 floats over 12 decades, the special values and the 2D
    path's ranges, bit for bit (NaN as NaN)."""
    from tod_tpu_torch.ops import libm

    dev = _cuda()
    rng = np.random.default_rng(fn)
    x = rng.standard_normal(200_000) * 10.0 ** rng.uniform(-6, 6, 200_000)
    x = np.concatenate([x, [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45,
                            2.0 ** -12, np.pi / 4, 120.0, 3.4e38, 1.0],
                        rng.uniform(-np.pi, np.pi, 1000)])
    x = torch.from_numpy(x.astype(np.float32))
    y = torch.from_numpy(rng.uniform(-3, 3, x.numel()).astype(np.float32))
    plain = (lambda: (libm.cosf_torch(x),), lambda: libm.sincosf_torch(x),
             lambda: (libm.powf_torch(x, y),),
             lambda: (libm.log_xla_torch(x),))[fn]()
    before = libm.libm_f32.launches
    got = libm.libm_f32(fn, x.to(dev), y.to(dev) if fn == 2 else None)
    assert libm.libm_f32.launches == before + 1
    got = got if fn == 1 else (got,)
    for g, w in zip(got, plain):
        g = g.cpu()
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        assert torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [0, 1, 2, 3])
def test_l4_views_match_plain_versions(fn):
    """L4 on lengths that are no multiple of 4 and on offset views: aligned
    arrays take the kernel's float4 body and a scalar tail, an array offset
    by 1-3 floats its scalar path; bit for bit against the plain versions
    (NaN as NaN)."""
    from tod_tpu_torch.ops import libm

    dev = _cuda()
    rng = np.random.default_rng(10 + fn)
    x = rng.standard_normal(4099) * 10.0 ** rng.uniform(-6, 6, 4099)
    x = torch.from_numpy(np.abs(x).astype(np.float32) if fn in (2, 3)
                         else x.astype(np.float32))
    y = torch.from_numpy(rng.uniform(-3, 3, x.numel()).astype(np.float32))
    plain = (lambda a, b: (libm.cosf_torch(a),),
             lambda a, b: libm.sincosf_torch(a),
             lambda a, b: (libm.powf_torch(a, b),),
             lambda a, b: (libm.log_xla_torch(a),))[fn]
    x_dev, y_dev = x.to(dev), y.to(dev)
    for lo, hi, y_lo in ((0, 4099, 0), (1, 4099, 1), (2, 4097, 2),
                         (3, 4098, 3), (1, 4000, 0), (0, 1, 0), (1, 3, 1),
                         (3, 9, 3), (2, 2, 2)):
        b = y[y_lo:y_lo + hi - lo]
        got = libm.libm_f32(fn, x_dev[lo:hi],
                            y_dev[y_lo:y_lo + hi - lo] if fn == 2 else None)
        got = got if fn == 1 else (got,)
        for g, w in zip(got, plain(x[lo:hi], b)):
            g = g.cpu()
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan), (lo, hi, y_lo)
            assert torch.equal(g[~nan].view(torch.int32),
                               w[~nan].view(torch.int32)), (lo, hi, y_lo)


@pytest.mark.cuda
@pytest.mark.parametrize("n_obj, n_pose, n", [(1, 1, 1), (3, 4, 77),
                                               (2, 16, 1024), (1, 2, 3185),
                                               (1, 2, 3186), (1, 2, 5000),
                                               (3, 5, 777), (1, 2, 40001)])
def test_p2_matches_plain_version(n_obj, n_pose, n):
    """Kernel P2 (every Gauss-Newton iteration of a call in one launch, one
    reduction tree for the 27 sums) against gauss_newton_pose_torch on the
    CPU: R and T bit for bit, with rows weighted out, points behind the
    camera and odd row counts (the pairwise sums' carried rows at several
    levels: 77, 777, 3185, 40001); 3186 and 5000 with five and six
    register levels, 40001 with nine (seven on the per-thread stack). The
    points and pixels are one an object."""
    from tod_tpu_torch.geometry import pnp

    dev = _cuda()
    rng = np.random.default_rng(n)
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    X = torch.from_numpy(rng.uniform(-0.12, 0.12, (n_obj, 1, n, 3))
                         .astype(np.float32))
    X[..., 2] += 0.8
    X[0, 0, :min(n, 3), 2] = -0.4
    q = torch.linalg.qr(torch.eye(3) + 0.02 * torch.from_numpy(
        rng.standard_normal((n_obj, n_pose, 3, 3)).astype(np.float32)))[0]
    R0 = q * torch.sign(torch.linalg.det(q))[..., None, None]
    T0 = torch.from_numpy(rng.uniform(-0.01, 0.01, (n_obj, n_pose, 3))
                          .astype(np.float32))
    uv = X[..., :2] / X[..., 2:3] * 525.0 + torch.tensor([319.5, 239.5])
    w = torch.from_numpy((rng.random((n_obj, n_pose, n)) > 0.2)
                         .astype(np.float32))
    want = pnp.gauss_newton_pose_torch(R0, T0, K, X, uv, w)
    before = pnp.gauss_newton_pose.launches
    got = pnp.gauss_newton_pose(*(t.to(dev) for t in (R0, T0, K, X, uv, w)))
    assert pnp.gauss_newton_pose.launches == before + 1
    for g, wt in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), wt.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["per_pose", "one_for_all"])
def test_p2_input_layouts(layout):
    """P2 reads X and uv once an object: with a copy for every pose
    (``per_pose``: the wrapper's poses-an-object is 1) and with one set for
    every pose of the call (``one_for_all``: (N, 3) and (N, 2)), bit for bit
    against the plain version."""
    from tod_tpu_torch.geometry import pnp

    dev = _cuda()
    rng = np.random.default_rng(7)
    n_obj, n_pose, n = 2, 3, 301
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    X = torch.from_numpy(rng.uniform(-0.12, 0.12, (n, 3)).astype(np.float32))
    X[:, 2] += 0.8
    uv = X[:, :2] / X[:, 2:3] * 525.0 + torch.tensor([319.5, 239.5])
    uv = uv + torch.from_numpy(rng.normal(0, 0.5, uv.shape).astype(
        np.float32))
    if layout == "per_pose":
        X = X.expand(n_obj, n_pose, n, 3).clone()
        uv = uv.expand(n_obj, n_pose, n, 2).clone()
    ang = torch.from_numpy(rng.uniform(-0.03, 0.03, (n_obj, n_pose, 3))
                           .astype(np.float32))
    R0 = pnp.rodrigues(ang)
    T0 = torch.from_numpy(rng.uniform(-0.01, 0.01, (n_obj, n_pose, 3))
                          .astype(np.float32))
    w = torch.from_numpy((rng.random((n_obj, n_pose, n)) > 0.2)
                         .astype(np.float32))
    want = pnp.gauss_newton_pose_torch(R0, T0, K, X, uv, w)
    got = pnp.gauss_newton_pose(*(t.to(dev) for t in (R0, T0, K, X, uv, w)))
    for g, wt in zip(got, want):
        assert g.shape == wt.shape
        assert torch.equal(g.cpu().view(torch.int32), wt.view(torch.int32))


# ---- L1 fused from the level image; P1 in groups of 4 lanes ----------------


def _orientation_case(h: int, w: int, seed: int):
    """A float32 level image and 400 int32 keypoints anywhere in it, the
    corners and borders first (the dense moments' zero padding)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(110 + 60 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
                  + rng.normal(0, 12, (h, w)), 0, 255).astype(np.float32)
    xy = np.stack([rng.integers(0, w, 400), rng.integers(0, h, 400)], -1)
    xy[:8] = [(0, 0), (w - 1, h - 1), (0, h - 1), (w - 1, 0), (w // 2, 0),
              (w // 2, h - 1), (0, h // 2), (w - 1, h // 2)]
    return torch.from_numpy(img), torch.from_numpy(xy.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h, w", [(480, 640), (400, 533), (333, 444),
                                  (720, 1280), (15, 17), (16, 31),
                                  (255, 32), (1, 1)])
@pytest.mark.parametrize("transposed", [False, True])
def test_l1_orientation_matches_plain_version(h, w, transposed):
    """Kernel L1 (tod_orb_angles: the integral images, then the moments at
    the keypoints and atan2f) against keypoint_moments_torch + atan2f_torch
    on the CPU, bit for bit, on a row-major and a column-major image (the
    pyramid's levels past 0); one launch (two kernels) a call."""
    from tod_tpu_torch.ops import libm
    from tod_tpu_torch.ops import orb as torb

    dev = _cuda()
    img, xy = _orientation_case(h, w, h + w)
    if transposed:
        img = img.t().contiguous().t()
    m10, m01 = torb.keypoint_moments_torch(img, xy)
    want = libm.atan2f_torch(m01, m10)
    before = torb.orb_angles.launches
    got = torb.keypoint_angles(img.to(dev), xy.to(dev)).cpu()
    assert torb.orb_angles.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_l1_orientation_refuses_what_it_cannot_take():
    from tod_tpu_torch.ops import orb as torb

    dev = _cuda()
    img, xy = (a.to(dev) for a in _orientation_case(40, 50, 1))
    assert torb.orb_angles(img, xy[:0]).shape == (0,)
    for bad in ((img[0], xy), (img, xy[:, :1]), (img, xy.cpu())):
        with pytest.raises(ValueError):
            torb.orb_angles(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 8192, 8191, 17])
def test_p1_lane_groups_match_plain_version(n):
    """P1 (a group of 4 lanes a sample, a root each) against
    p3p_distances_torch on the CPU, every distance and validity bit for bit
    (NaN where NaN), at the 2D path's chunk sizes, an odd count (a grid
    ending inside a block) and degenerate samples (chip_smoke.py
    p3p_degenerate: collinear points, a repeated point, a repeated ray, NaN
    and zero bearings, all points at one place); one launch a call."""
    import chip_smoke
    from tod_tpu_torch.geometry import pnp

    dev = _cuda()
    bear, pts = chip_smoke.p3p_degenerate(*(a.numpy() for a in _p3p_samples(
        np.random.default_rng(n + 4), n)))
    want_s, want_ok = pnp.p3p_distances_torch(bear, pts)

    def same(got, want):          # bit for bit, NaN where NaN
        got = got.cpu()
        nan = torch.isnan(want)
        return torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))

    before = pnp.p3p_distances.launches
    got = pnp.p3p_distances(bear.to(dev), pts.to(dev))
    assert pnp.p3p_distances.launches == before + 1
    assert same(got[0], want_s) and torch.equal(got[1].cpu(), want_ok)


@pytest.mark.cuda
@pytest.mark.parametrize("n_obj, n_pose", [(32, 8), (5, 8), (1, 1), (3, 2)])
def test_m1_m2_match_plain_versions(n_obj, n_pose):
    """M1 (the 2D path's mirror) and M2 (its model normal) against
    mirror_poses_torch and sym3_smallest_vector_torch on the CPU, bit for
    bit (NaN where NaN), at a chunk's shape, a tail and small shapes, with
    chip_smoke.py mirror_cases' edge cases (no turn, s at 1e-6, T = 0, a
    NaN pose; isotropic, rank-0 and rank-1 covariances); one launch a
    call each."""
    import chip_smoke
    from tod_tpu_torch.geometry import detection2d as td

    dev = _cuda()
    R, T, n, cov = chip_smoke.mirror_cases(
        np.random.default_rng(n_obj * 10 + n_pose), max(n_obj, 4),
        max(n_pose, 5))
    R, T = R[:n_obj, :n_pose].contiguous(), T[:n_obj, :n_pose].contiguous()
    n, cov = n[:n_obj], cov[:n_obj]
    want_r, want_t = td.mirror_poses_torch(R, T, n)
    want_n = td.sym3_smallest_vector_torch(cov)

    def same(got, want):
        got = got.cpu()
        nan = torch.isnan(want)
        return torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))

    before = (td.mirror_poses.launches, td.sym3_smallest_vector.launches)
    got_r, got_t = td.mirror_poses(R.to(dev), T.to(dev), n.to(dev))
    got_n = td.sym3_smallest_vector(cov.to(dev))
    assert (td.mirror_poses.launches, td.sym3_smallest_vector.launches) \
        == (before[0] + 1, before[1] + 1)
    assert same(got_r, want_r) and same(got_t, want_t)
    assert same(got_n, want_n)


@pytest.mark.cuda
def test_m1_m2_take_views_and_refuse_other_dtypes():
    """Non-contiguous inputs (the 2D path gathers its top poses) give the
    contiguous inputs' bits; float64 is refused."""
    import chip_smoke
    from tod_tpu_torch.geometry import detection2d as td

    dev = _cuda()
    R, T, n, cov = (x.to(dev) for x in chip_smoke.mirror_cases(
        np.random.default_rng(3), 8, 6))
    got = td.mirror_poses(R[:, 1::2], T[:, 1::2], n)
    want = td.mirror_poses(R[:, 1::2].contiguous(), T[:, 1::2].contiguous(),
                           n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(td.sym3_smallest_vector(cov[::2]),
                       td.sym3_smallest_vector(cov[::2].contiguous()))
    with pytest.raises(ValueError):
        td.mirror_poses(R.double(), T, n)
    with pytest.raises(ValueError):
        td.sym3_smallest_vector(cov.double())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 6])
def test_lapack_lu_on_the_card_is_jnp_linalg_solve(n):
    """csrc/lapack_lu.cuh (the LU of kernels P1 and P2) through p3p.cu's
    check entry tod_lu_solve: the reference's jnp.linalg.solve bits on
    tests/data/torch_p3p_fixture.npz's systems (ties, singular ones, a
    zero leading entry; J^T J + 1e-6 I at n = 6), and lu_solve's on the
    CPU."""
    from tod_tpu_torch import kernels
    from tod_tpu_torch.geometry import lapack

    dev = _cuda()
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_p3p_fixture.npz"))
    M = torch.from_numpy(fx[f"lu{n}_M"])
    F = torch.from_numpy(fx[f"lu{n}_F"])
    # held by name while the kernel runs (a temporary's memory is reused)
    M_dev, F_dev = M.to(dev).contiguous(), F.to(dev).contiguous()
    x = torch.empty_like(F_dev)
    kernels.call("p3p", "tod_lu_solve",
                 [M_dev.data_ptr(), F_dev.data_ptr(), x.data_ptr()],
                 [len(M), n], torch.cuda.current_stream(dev).cuda_stream)
    got = x.cpu().numpy()
    for want in (fx[f"lu{n}_x"], lapack.lu_solve(M, F).numpy()):
        assert ((got.view(np.int32) == want.view(np.int32))
                | (np.isnan(got) & np.isnan(want))).all()


@pytest.mark.cuda
def test_m2_on_the_card_is_jnp_linalg_eigh():
    """Kernel M2 (LAPACK's ssyevd at n = 3): jnp.linalg.eigh's column 0,
    sign included, on tests/data/torch_p3p_fixture.npz's covariances
    (chip_smoke.mirror_cases', planar ones, and six scales across both of
    ssyevd's scaling branches)."""
    from tod_tpu_torch.geometry import detection2d as td

    dev = _cuda()
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_p3p_fixture.npz"))
    got = td.sym3_smallest_vector(torch.from_numpy(fx["cov"]).to(dev))
    assert (got.cpu().numpy().view(np.int32)
            == fx["normal"].view(np.int32)).all()


@pytest.mark.cuda
def test_p1_takes_views():
    """Strided bearings and points (every other sample of a larger batch,
    copied to contiguous rows by the wrapper) give the contiguous inputs'
    distances and validity bit for bit: the wrapper holds both copies
    until the launch."""
    from tod_tpu_torch.geometry import pnp

    dev = _cuda()
    bear, pts = (a.to(dev) for a in _p3p_samples(np.random.default_rng(41),
                                                 2048))
    want = pnp.p3p_distances(bear[::2].contiguous(), pts[::2].contiguous())
    got = pnp.p3p_distances(bear[::2], pts[::2])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def _r1_inputs(shape, seed, dev):
    """chip_smoke.py consensus_cases (phase 3l's edge cases) on the CPU and
    on the card, with ObjectMatches of each."""
    import chip_smoke
    from tod_tpu_torch.geometry.adjacency import ObjectMatches

    host = chip_smoke.consensus_cases(np.random.default_rng(seed), *shape)
    out = []
    for args in (host, [x.to(dev) for x in host]):
        R, T, K, X, xy, valid, ok = args
        out.append((R, T, K, ObjectMatches(
            query_pts=None, train_pts=X, query_idx=None, query_xy=xy,
            valid=valid), valid, ok))
    return out


def _same_r1(got, want):
    got, want = got.cpu(), want.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 48, 40), (3, 136, 1030), (2, 8, 1),
                                   (5, 300, 2100), (1, 129, 1024)])
def test_r1_matches_plain_versions(shape):
    """R1 (csrc/consensus.cu) against its plain versions on the CPU, bit
    for bit (NaN where NaN), in every mode: the counts of every pose, the
    selection (top 8, model normal, mirrors, the 16 poses' inliers and
    counts), the masks and the truncated SSE; matches past one staged
    tile of 1,024 (1,030, 2,100) and poses past a block of 128 (136, 300,
    129); one launch a call."""
    from tod_tpu_torch.geometry import detection2d as td

    dev = _cuda()
    (Rh, Th, Kh, mh, vh, okh), (Rc, Tc, Kc, mc, vc, okc) = _r1_inputs(
        shape, sum(shape), dev)
    thr2 = 16.0
    want_n = td.consensus_counts_torch(Rh, Th, Kh, mh, vh, okh, thr2)
    want_s = td.consensus_select_torch(want_n, Rh, Th, Kh, mh, vh, okh,
                                       thr2)
    before = td.consensus_kernel.launches
    got_n = td.consensus_counts(Rc, Tc, Kc, mc, vc, okc, thr2)
    assert td.consensus_kernel.launches == before + 1
    assert _same_r1(got_n, want_n)
    got_s = td.consensus_select(got_n, Rc, Tc, Kc, mc, vc, okc, thr2)
    assert td.consensus_kernel.launches == before + 2
    for name in td.Selection._fields:
        assert _same_r1(getattr(got_s, name), getattr(want_s, name)), name
    masks, counts = td.consensus_masks(got_s.R, got_s.T, Kc, mc, vc, thr2)
    want_m = td.count_inliers(want_s.R, want_s.T, Kh, mh, vh, thr2)
    assert _same_r1(masks, want_m)
    assert _same_r1(counts, want_m.sum(-1, dtype=torch.int32))
    sse = td.consensus_sse(got_s.R, got_s.T, Kc, mc, vc, thr2)
    assert _same_r1(sse, td.truncated_sse(want_s.R, want_s.T, Kh, mh, vh,
                                          thr2))
    assert td.consensus_kernel.launches == before + 4


@pytest.mark.cuda
def test_r1_takes_views_and_refuses_what_it_cannot_take():
    """Strided poses (the 2D path flattens its P3P candidates) give the
    contiguous inputs' bits; float64 poses, fewer than 8 poses to select
    from and int64 counts are refused."""
    from tod_tpu_torch.geometry import detection2d as td

    dev = _cuda()
    _, (R, T, K, m, valid, ok) = _r1_inputs((3, 96, 200), 4, dev)
    thr2 = 16.0
    got = td.consensus_counts(R[:, ::2], T[:, ::2], K, m, valid, ok[:, ::2],
                              thr2)
    want = td.consensus_counts(R[:, ::2].contiguous(),
                               T[:, ::2].contiguous(), K, m, valid,
                               ok[:, ::2].contiguous(), thr2)
    assert torch.equal(got, want)
    sse = td.consensus_sse(R[:, 1::3], T[:, 1::3], K, m, valid, thr2)
    assert _same_r1(sse, td.consensus_sse(
        R[:, 1::3].contiguous(), T[:, 1::3].contiguous(), K, m, valid, thr2))
    with pytest.raises(ValueError):
        td.consensus_counts(R.double(), T, K, m, valid, ok, thr2)
    counts = td.consensus_counts(R, T, K, m, valid, ok, thr2)
    with pytest.raises(ValueError):
        td.consensus_select(counts[:, :7], R[:, :7], T[:, :7], K, m, valid,
                            ok[:, :7], thr2)
    with pytest.raises(ValueError):
        td.consensus_select(counts.long(), R, T, K, m, valid, ok, thr2)


@pytest.mark.cuda
def test_r1_launches_on_the_2d_round():
    """A 2D round on the card launches R1 five times a chunk (the
    consensus's counts and selection, the refinement's two recounts and
    its SSE) and M1 and M2 never (they run inside R1)."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.detection import cluster_matches

    dev = _cuda()
    arrays = _scene_2d()
    cfg = td.Pnp2dConfig(n_hypotheses=256, min_inliers=8, max_instances=1)
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    m = cluster_matches(t[0], t[1], t[2], t[3],
                        torch.zeros((len(t[0]), 3), device=dev), t[4],
                        torch.arange(2, device=dev), 128)
    g = ThreefryNoise(prng.prng_key(7), 1, False, dev)(
        "round0", (2, 3, cfg.n_hypotheses, 128))
    before = (td.consensus_kernel.launches, td.mirror_poses.launches,
              td.sym3_smallest_vector.launches)
    td.ransac_round_2d(g, m, t[5], m.valid, cfg)
    assert (td.consensus_kernel.launches, td.mirror_poses.launches,
            td.sym3_smallest_vector.launches) == (before[0] + 5, before[1],
                                                  before[2])
