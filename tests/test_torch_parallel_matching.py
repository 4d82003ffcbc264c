"""The port's mesh and DB-sharded matchers (tod_tpu_torch/parallel/mesh.py,
matching.py, segmented.py's packing and ``sharded_object_top1``) against
the reference's (tod_tpu/parallel) on the CPU.

The port's mesh names ``cpu`` eight times, the reference's the conftest's
eight virtual CPU devices, both (2 x 4) where a test shards. Every result
is held bit for bit: distances, global rows, object ids and columns."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.ops.pallas.segmented_l2 import quantize_descriptors
from tod_tpu.parallel import make_mesh as jax_mesh
from tod_tpu.parallel import matching as jmatch
from tod_tpu.parallel import segmented as jsharded
from tod_tpu_torch.ops.hamming import hamming_topk_fused, pack_db_bits
from tod_tpu_torch.parallel import (make_mesh, pack_segmented_l2_sharded,
                                    pack_segmented_sharded,
                                    ring_hamming_topk, sharded_hamming_topk,
                                    sharded_object_top1, stacked_max_chunks)
from tod_tpu_torch.parallel import matching as tmatch
from tod_tpu_torch.parallel import mesh as tmesh
from tod_tpu_torch.types import TodModel

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
CHUNK = 128


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    return make_mesh(2, 4, CPU8), jax_mesh(n_data=2, n_db=4)


def test_mesh_shapes_and_devices():
    mesh = make_mesh(n_data=4, n_db=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "db": 2}
    assert mesh.axis_names == ("data", "db")
    assert mesh.device(3, 1) == torch.device("cpu") == mesh.first
    assert make_mesh(devices=CPU8).shape == {"data": 8, "db": 1}
    assert make_mesh(n_db=4, devices=["cpu"] * 9).shape == {"data": 2,
                                                            "db": 4}


def test_mesh_refuses_too_few_devices(monkeypatch):
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        make_mesh(n_data=8, n_db=2, devices=CPU8)
    # no list: the CUDA devices, each once; none here, and no CPU fallback
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="have 0"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(n_db=2)
    assert mesh.devices == ((torch.device("cuda", 0),
                             torch.device("cuda", 1)),)


def test_collectives():
    parts = [torch.tensor([[s, 5 - s]]) for s in range(4)]
    cpu = torch.device("cpu")
    assert tmesh.all_gather(parts, cpu, dim=1).tolist() == [
        [0, 5, 1, 4, 2, 3, 3, 2]]
    assert tmesh.min_over(parts, cpu).tolist() == [[0, 2]]
    assert tmesh.ring_rotate("abcd") == list("bcda")


def _db(rng, n_rows, n_q=64):
    return (rng.integers(0, 256, (n_q, 32), dtype=np.uint8),
            rng.integers(0, 256, (n_rows, 32), dtype=np.uint8))


@pytest.mark.parametrize("ring", [False, True])
def test_sharded_topk_equals_reference(meshes, rng, ring):
    """Both matchers at (2 x 4), the tail rows masked, against the
    reference's: dist and global rows bit for bit, and the single-device
    B5 twin's; with the radius cut, the twin's at that radius."""
    mesh, jmesh = meshes
    q, db = _db(rng, 4 * CHUNK * 2)
    n_valid = len(db) - 37
    port = ring_hamming_topk if ring else sharded_hamming_topk
    ref = jmatch.ring_hamming_topk if ring else jmatch.sharded_hamming_topk
    d_t, i_t = port(mesh, torch.from_numpy(q), torch.from_numpy(db),
                    n_valid, k=5, chunk=CHUNK)
    d_j, i_j = ref(jmesh, jnp.asarray(q), jnp.asarray(db), n_valid, k=5,
                   chunk=CHUNK)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    words = pack_db_bits(torch.from_numpy(db))
    for radius in (None, 110.0):
        d_1, i_1 = hamming_topk_fused(torch.from_numpy(q), words, n_valid,
                                      k=5, radius=radius)
        d_r, i_r = port(mesh, torch.from_numpy(q), words, n_valid, k=5,
                        chunk=CHUNK, radius=radius)
        assert torch.equal(d_r, d_1) and torch.equal(i_r, i_1)


def test_ring_at_the_largest_distance(meshes):
    """Rows at distance 256 (each query's complement) rank ahead of the
    empty slots in the ring's packed merge, as in the reference."""
    mesh, jmesh = meshes
    q = np.zeros((8, 32), np.uint8)
    db = np.full((4 * CHUNK, 32), 255, np.uint8)
    d_t, i_t = ring_hamming_topk(mesh, torch.from_numpy(q),
                                 torch.from_numpy(db), 3, k=5, chunk=CHUNK)
    d_j, i_j = jmatch.ring_hamming_topk(jmesh, jnp.asarray(q),
                                        jnp.asarray(db), 3, k=5, chunk=CHUNK)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert (i_t[:, :3] >= 0).all() and (d_t[:, :3] == 256).all()


def test_merge_by_index_equals_reference(rng):
    """The ring's fold, ties and empty slots included."""
    d = rng.integers(0, 600, (16, 10)).astype(np.float32)
    i = rng.integers(-1, 3000, (16, 10)).astype(np.int32)
    d[:, :3] = 7.0
    got = tmatch._merge_topk_by_index(*(torch.from_numpy(x) for x in
                                        (d[:, :5], i[:, :5], d[:, 5:],
                                         i[:, 5:])), 5)
    ref = jmatch._merge_topk_by_index(d[:, :5], i[:, :5], d[:, 5:],
                                      i[:, 5:], 5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_matchers_keep_the_reference_errors(meshes, rng):
    mesh, _ = meshes
    q, db = _db(rng, 4 * CHUNK + 8)
    for fn in (sharded_hamming_topk, ring_hamming_topk):
        with pytest.raises(ValueError, match="chunk-multiple"):
            fn(mesh, torch.from_numpy(q), torch.from_numpy(db), 10,
               chunk=CHUNK)
    big = torch.zeros(((1 << 22), 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^22"):
        ring_hamming_topk(mesh, torch.from_numpy(q), big, 10, chunk=CHUNK)
    with pytest.raises(ValueError, match="over 'data'"):
        sharded_hamming_topk(mesh, torch.from_numpy(q[:3]),
                             torch.from_numpy(db[:4 * CHUNK]), 10,
                             chunk=CHUNK)


def _models(rng, l2: bool):
    arrays = []
    for i in range(7):       # 7 objects over 4 shards: one padding slot
        n = 100 + 37 * i
        if l2:
            d = rng.random((n, 128)).astype(np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
        else:
            d = rng.integers(0, 256, (n, 32), np.uint8)
        arrays.append((d, rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)))
    return ([JaxModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)],
            [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)])


@pytest.mark.parametrize("l2", [False, True])
def test_sharded_object_top1_equals_reference(meshes, rng, l2):
    """Round-robin packing (ids, padding slots) and the (Q, O) columns in
    shard-major order, ORB (B1's twin) and SIFT (B3's), against the
    reference's stacked DB under ``shard_map``; each shard on its own mesh
    device, the reference's grid bound (``stacked_max_chunks``)."""
    mesh, jmesh = meshes
    jm, tm = _models(rng, l2)
    if l2:
        qf = rng.random((128, 128)).astype(np.float32)
        qf /= np.linalg.norm(qf, axis=1, keepdims=True)
        q = np.asarray(quantize_descriptors(jnp.asarray(qf)))
        jdb, jids = jsharded.pack_segmented_l2_sharded(jm, 4, db_chunk=2048)
        tdb, tids = pack_segmented_l2_sharded(tm, mesh, db_chunk=2048)
    else:
        q = rng.integers(0, 256, (128, 32), dtype=np.uint8)
        jdb, jids = jsharded.pack_segmented_sharded(jm, 4, db_chunk=2048)
        tdb, tids = pack_segmented_sharded(tm, mesh, db_chunk=2048)
    assert tids == jids and tids.count(None) == 1 and tdb.n_objects == 8
    assert stacked_max_chunks(tdb) == jsharded.stacked_max_chunks(jdb)
    assert all(tdb.at(i, s) is tdb.shards[s] for i in range(2)
               for s in range(4))
    d_j, r_j = jax.jit(lambda qq, db: jsharded.sharded_object_top1(
        jmesh, qq, db))(jnp.asarray(q), jdb)
    d_t, r_t = sharded_object_top1(mesh, torch.from_numpy(q), tdb)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
