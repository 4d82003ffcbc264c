"""The port's L2 matcher (``tod_tpu_torch/ops/matching.py l2_topk``, the
cell graph's SIFT DescriptorMatcher) against the compiled reference's
(``jax.jit`` of ``tod_tpu/ops/matching.py l2_topk``), bit for bit: every
squared distance, row and order, on SIFT-like normalised rows made from a
numpy seed, at Q = 1 (the one-query "vector" order), 7, 100 and 513, over
one chunk and several, with a partial last chunk, at the matcher's chunk
of 4,096 and at widths whose dot sums in the "lanes" and "parity" orders.
Also kernel L3's plain tile (``l2_distances_torch``) against the
reference's formula jitted at each order, and the kernel builder's digest,
which covers the local headers a source includes (no nvcc needed)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.ops.matching import l2_topk as ref_l2_topk
from tod_tpu_torch import kernels
from tod_tpu_torch.ops import matching as tm
from tod_tpu_torch.ops.reduce import square_norms

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _ref_topk(query, db, n_valid, k=5, chunk=4096):
    return ref_l2_topk(query, db, n_valid, k=k, chunk=chunk)


@jax.jit
def _ref_tile(query, rows):
    """The distance of the reference's l2_topk body, before the padding's
    mask (tod_tpu/ops/matching.py:129-132)."""
    q_sq = (query * query).sum(axis=1, keepdims=True)
    d_sq = (rows * rows).sum(axis=1)[None, :]
    dot = jnp.dot(query, rows.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(q_sq + d_sq - 2.0 * dot, 0.0)


def sift_rows(rng, n: int) -> np.ndarray:
    """(n, 128) float32 rows shaped like SIFT descriptors: non-negative,
    skewed, unit norm, clipped at 0.2."""
    x = rng.random((n, 128)).astype(np.float32) ** 3
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.minimum(x, np.float32(0.2)).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# (Q, DB rows, valid rows, chunk): one chunk, several, a partial last one
TOPK_CASES = [(q, n, nv, 4096) for q in (1, 7, 100, 513)
              for n, nv in ((4096, 4096), (12288, 9001))] + [
    (7, 4096, 3, 4096),          # fewer valid rows than k
    (100, 600, 577, 100),        # "lanes"
    (513, 300, 299, 150),        # "parity"
]


@pytest.mark.parametrize("n_q, n_rows, n_valid, chunk", TOPK_CASES)
def test_l2_topk_bit_for_bit(n_q, n_rows, n_valid, chunk):
    rng = np.random.default_rng(n_q * 7 + n_rows + chunk)
    q = sift_rows(rng, n_q)
    db = sift_rows(rng, n_rows)
    db[11] = db[5] = q[0]                 # a tie at distance 0
    db[n_valid - 1] = q[-1]
    ref_d, ref_i = _ref_topk(q, db, n_valid, chunk=chunk)
    d, i = tm.l2_topk(torch.from_numpy(q), torch.from_numpy(db), n_valid,
                      chunk=chunk)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(ref_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("n_q, chunk, kind", [
    (1, 4096, "vector"), (1, 100, "vector"), (7, 4096, "chain"),
    (100, 512, "chain"), (33, 100, "lanes"), (64, 150, "parity"),
    (5, 30, "parity")])
def test_l3_plain_tile_bit_for_bit(n_q, chunk, kind):
    """The plain tile of kernel L3 at each order against the reference's
    formula, jitted at the same shapes (its dot's kernel is the one under
    l2_topk); columns past ``n_valid`` are BIG_DIST."""
    assert tm.l2_order(n_q, chunk) == kind
    rng = np.random.default_rng(chunk + n_q)
    # signed rows as well: every order rounds them otherwise
    q = np.concatenate([sift_rows(rng, n_q // 2),
                        rng.standard_normal((n_q - n_q // 2, 128))]
                       ).astype(np.float32)
    rows = np.concatenate([sift_rows(rng, chunk // 2),
                           rng.standard_normal((chunk - chunk // 2, 128))]
                          ).astype(np.float32)
    want = np.asarray(_ref_tile(q, rows))
    n_valid = chunk - 3
    got = tm.l2_distances_torch(torch.from_numpy(q), torch.from_numpy(rows),
                                n_valid, kind).numpy()
    np.testing.assert_array_equal(_bits(got[:, :n_valid]),
                                  _bits(want[:, :n_valid]))
    assert (got[:, n_valid:] == np.float32(tm.BIG_DIST)).all()


def test_l2_order_and_norms():
    """The order of each width (ops/image.py's column rule; one query is
    "vector"); the norms sum as XLA's reduce-window does."""
    assert [tm.l2_order(2, c) for c in (8, 24, 25, 40, 49, 150, 4096)] == \
        ["lanes", "lanes", "parity", "lanes", "chain", "parity", "chain"]
    assert tm.l2_order(1, 4096) == "vector"
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 128)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: (a * a).sum(axis=1))(x))
    np.testing.assert_array_equal(_bits(square_norms(torch.from_numpy(x))),
                                  _bits(want))


def test_l2_distances_wrapper_on_the_cpu():
    """On a CPU tensor the wrapper is the plain tile and launches nothing;
    it refuses what kernel L3 cannot take."""
    rng = np.random.default_rng(8)
    q, rows = (torch.from_numpy(sift_rows(rng, n)) for n in (5, 64))
    before = tm.l2_distances.launches
    assert torch.equal(tm.l2_distances(q, rows, 60, "chain"),
                       tm.l2_distances_torch(q, rows, 60, "chain"))
    assert tm.l2_distances.launches == before
    for bad in ((q.double(), rows), (q[:, :64], rows), (q, rows[None]),
                (q.to("meta"), rows.to("meta"))):
        with pytest.raises(ValueError):
            tm.l2_distances(*bad, 60, "chain")
    with pytest.raises(ValueError):
        tm.ordered_dot(q, rows[:5], "pairwise")


def test_kernel_digest_covers_local_headers(tmp_path):
    """A kernel is rebuilt when a local header it includes changes (and not
    for a system header); the sources that share L1's atan2f include it."""
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    assert [h.name for h in kernels.local_includes(src)] == ["a.cuh", "b.cuh"]
    before = kernels.digest(src)
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert kernels.digest(src) != before
    for name in ("libm_f32", "sift_descriptor"):
        assert [h.name for h in kernels.local_includes(
            kernels.CSRC / f"{name}.cu")] == ["libm_f32.cuh"]
    assert "l2_distances" in kernels.SOURCES
