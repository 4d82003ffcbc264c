"""The port's threefry noise (tod_tpu_torch/utils/prng.py) against
``jax.random``, and the detector's key path against the reference's.

Keys, random bits and uniforms must be equal bit for bit. Gumbel values
``-log(-log(u))`` go through two logarithms, XLA's and PyTorch's, each
within one ulp of the exact value but not always the same one, so they are
held to ``|g - g_ref| <= 2^-22 + 2 ulp(g_ref)``: the inner logs may differ
by 2 ulp of ``v = -log(u)``, which moves ``log(v)`` by at most
``2 * 2^-23`` absolute, and the outer logs round by an ulp of ``g`` each.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.utils import prng
from torch_parity import JaxReplayNoise, JaxReplayNoiseGlobal, frame_keys

SEEDS = [0, 1, 7, 2**31 - 1]
# tier 1 (n_hypotheses x m_cap) and tier 2 (n_hypotheses and the lean
# continuation budget x max_matches_per_object) of the bench's operating
# point and of the streaming test's
SHAPES = [(128, 192), (512, 384), (128, 384), (256, 256), (64, 128)]
# a round of the global path (n_hypotheses x max_matches_per_object)
GLOBAL_SHAPE = (1024, 512)


def gumbel_bound(ref: np.ndarray) -> np.ndarray:
    return 2.0**-22 + 2.0 * np.spacing(np.abs(ref)).astype(np.float64)


def assert_gumbel_close(got, ref) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref)
    assert got.shape == ref.shape
    gap = np.abs(got - ref.astype(np.float64))
    assert (gap <= gumbel_bound(ref)).all(), float(gap.max())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.prng_key(seed)
    np.testing.assert_array_equal(mine, np.asarray(key))
    assert mine.dtype == np.uint32
    for n in (2, 3, 5, 16, 32, 100):
        np.testing.assert_array_equal(prng.split(mine, n),
                                      np.asarray(jax.random.split(key, n)))
    # a batch of keys splits key by key, as vmap(split) does
    batch = prng.split(mine, 7)
    want = np.stack([np.asarray(jax.random.split(k, 3))
                     for k in jax.random.split(key, 7)])
    np.testing.assert_array_equal(prng.split(batch, 3), want)
    # the frame keys of FusedDetector(seed=seed)
    key_h = mine
    for ref in frame_keys(seed, 4):
        key_h, sub = prng.split(key_h)
        np.testing.assert_array_equal(sub, np.asarray(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.prng_key(seed)
    tiny = float(np.finfo(np.float32).tiny)
    for shape in SHAPES + [(7,), (3, 5, 7)]:
        bits = prng.random_bits(mine, shape).numpy()
        assert bits.min() >= 0 and bits.max() <= prng.MASK
        np.testing.assert_array_equal(
            bits.astype(np.uint32),
            np.asarray(jax.random.bits(key, shape, jnp.uint32)))
        for lo in (0.0, tiny):
            u = prng.uniform(mine, shape, lo, 1.0).numpy()
            ref = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo,
                                                1.0))
            np.testing.assert_array_equal(u.view(np.uint32),
                                          ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_the_stated_bound(seed):
    key = jax.random.PRNGKey(seed)
    keys = prng.split(prng.prng_key(seed), 3)
    for shape in SHAPES:
        got = prng.gumbel(keys, shape, "cpu")           # one batched draw
        assert got.shape == (3,) + shape and got.dtype == torch.float32
        for k_h, k_j, g in zip(keys, jax.random.split(key, 3), got):
            ref = np.asarray(jax.random.gumbel(k_j, shape, jnp.float32))
            assert_gumbel_close(g.numpy(), ref)
            # bit for bit with the batch of one
            assert torch.equal(prng.gumbel(k_h, shape, "cpu"), g)


def test_batched_bits_equal_key_by_key():
    keys = prng.split(prng.split(prng.prng_key(3), 4), 3)       # (4, 3, 2)
    got = prng.random_bits(keys, (5, 9))
    assert got.shape == (4, 3, 5, 9)
    for a in range(4):
        for v in range(3):
            assert torch.equal(got[a, v], prng.random_bits(keys[a, v], (5, 9)))


@pytest.mark.parametrize("segmented", [True, False],
                         ids=["segmented", "global"])
def test_threefry_noise_follows_the_reference_key_path(segmented):
    key_j = frame_keys(11, 3)[2]
    key_h = np.asarray(key_j)
    n_inst = 3
    mine = ThreefryNoise(key_h, n_inst, segmented, "cpu")
    replay = (JaxReplayNoise if segmented else JaxReplayNoiseGlobal)(
        key_j, n_inst)
    stages = [("round0", (4, 3, 256, 96)), ("round1", (4, 3, 64, 96)),
              ("round2", (4, 3, 64, 96))]
    if segmented:
        stages.insert(0, ("tier1", (6, 3, 128, 64)))
    else:
        with pytest.raises(ValueError, match="no tier 1"):
            mine("tier1", (6, 3, 128, 64))
    for stage, shape in stages:
        got = mine(stage, shape)
        assert got.shape == shape and got.dtype == torch.float32
        assert_gumbel_close(got.numpy(), replay(stage, shape).numpy())


def test_detector_key_advances_once_a_frame():
    """FusedDetector(seed=s) holds PRNGKey(s) and splits it once a frame,
    an empty catalog's frames included, as the reference does."""
    from tod_tpu_torch import convert
    from tod_tpu_torch.models import fused as tfused

    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    cfg = convert.config_from_dict(dict(pipeline="segmented"))
    det = tfused.FusedDetector([], cfg, seed=9, device="cpu")
    np.testing.assert_array_equal(det._key, np.asarray(
        jax.random.PRNGKey(9)))
    key = jax.random.PRNGKey(9)
    for _ in range(2):
        _, got = det.detect_raw(fx["images"][0], fx["depths"][0], fx["K"])
        assert got.accepted.numel() == 0
        key, _ = jax.random.split(key)
        np.testing.assert_array_equal(det._key, np.asarray(key))


def test_stream_with_the_detectors_own_noise():
    """The streaming test's detectors (tests/test_torch_streaming.py) with
    nothing injected: FusedDetector(seed=SEED) draws its own threefry noise,
    and every frame's slab, masks, accepts, inlier counts, clique sizes and
    age equal the reference's; gated poses within the streaming test's
    bound."""
    import dataclasses

    from tod_tpu.db.models import TodModel as JaxModel
    from tod_tpu.models import FusedDetector
    from tod_tpu_torch import convert
    from tod_tpu_torch.geometry.ransac import ObjectDetections
    from tod_tpu_torch.models import fused as tfused
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog
    from test_torch_geometry import _pose_close
    from test_torch_streaming import N_FRAMES, SEED, _streaming_config

    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    real = [(fx[f"desc{i}"][::8], fx[f"points{i}"][::8]) for i in range(3)]
    ids, arrays = smoke_catalog([str(s) for s in fx["model_ids"]], real,
                                n_objects=8)
    cfg = _streaming_config()
    jd = FusedDetector([JaxModel(i, d, p) for i, (d, p) in
                        zip(ids, arrays)], cfg, seed=SEED)
    slabs = []
    c1, c2, c3 = jd._coarse
    jd._coarse = (lambda *a: slabs.append(c1(*a)) or slabs[-1], c2, c3)
    td = tfused.FusedDetector(
        convert.models_from_numpy(ids, [d for d, _ in arrays],
                                  [p for _, p in arrays]),
        convert.config_from_dict(dataclasses.asdict(cfg)), seed=SEED,
        device="cpu")
    assert td.noise is None
    n_acc = 0
    for f in range(N_FRAMES):
        image, depth = fx["images"][f % 2], fx["depths"][f % 2]
        _, det_j = jd.detect_raw(image, depth, fx["K"])
        _, det_t = td.detect_raw(image, depth, fx["K"])
        np.testing.assert_array_equal(td._key, np.asarray(jd._key))
        for name, a, b in zip(("sel", "force", "force_act"), slabs[f],
                              td.slab):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          f"frame {f} {name}")
        for name in ("accepted", "n_inliers", "clique_size"):
            np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                          np.asarray(getattr(det_j, name)),
                                          f"frame {f} {name}")
        np.testing.assert_array_equal(td._age.numpy(), np.asarray(jd._age))
        ref = td.poses(ObjectDetections(
            *(torch.from_numpy(np.array(a)) for a in det_j)))
        port = td.poses(det_t)
        key = lambda r: (r.object_id, r.confidence, r.clique_size)  # noqa
        assert sorted(map(key, port)) == sorted(map(key, ref)), f"frame {f}"
        for r_t in port:
            r_j = next(r for r in ref if key(r) == key(r_t))
            _pose_close(r_t.R, r_t.T, r_j.R, r_j.T)
        n_acc += len(port)
    assert n_acc > 0


# ---- kernel N1 (csrc/threefry_gumbel.cu), emulated draw by draw -----------

def _funnel_shift_l(hi, lo, r):
    """``__funnelshift_l(lo, hi, r)``: the high word of ``(hi:lo) << r``,
    in uint32 (a rotation when ``hi`` is ``lo``)."""
    return (hi << np.uint32(r)) | (lo >> np.uint32(32 - r))


def n1_draws(key, index):
    """Kernel N1's per-draw code path in numpy ``uint32`` (wrapping adds)
    and float32, in the kernel's order, for the flat ``index`` (uint64)
    under ``key`` (2,): ``(bits, u, g)``."""
    k0, k1 = (np.full(index.shape, w, np.uint32) for w in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(prng.KS_PARITY))
    x0 = (index >> np.uint64(32)).astype(np.uint32) + ks[0]
    x1 = (index & np.uint64(prng.MASK)).astype(np.uint32) + ks[1]
    for i in range(5):
        for r in prng.ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _funnel_shift_l(x1, x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + np.uint32(i + 1))
    bits = x0 ^ x1
    f = ((bits >> np.uint32(9)) | np.uint32(prng.F32_ONE_BITS)).view(
        np.float32) - np.float32(1.0)
    tiny = np.float32(prng.F32_TINY)
    span = np.float32(1.0) - tiny
    u = np.maximum(f * span + tiny, tiny)
    with np.errstate(divide="raise", invalid="raise"):
        g = -np.log(-np.log(u))
    return bits, u, g


@pytest.mark.parametrize("seed", SEEDS)
def test_n1_emulation_equals_the_plain_draws(seed):
    """Bits and uniforms bit for bit, Gumbel values within the bound, at
    the tier-1, round and global shapes (three vertex keys each)."""
    keys = prng.split(prng.split(prng.prng_key(seed), 2)[1], 3)
    for shape in [(128, 192), (512, 384), GLOBAL_SHAPE]:
        index = np.arange(np.prod(shape), dtype=np.uint64)
        bits_t = prng.random_bits(keys, shape).numpy()
        u_t = prng.uniform(keys, shape, prng.F32_TINY, 1.0).numpy()
        g_t = prng.gumbel_torch(keys, shape).numpy()
        for v, key in enumerate(keys):
            bits, u, g = n1_draws(key, index)
            np.testing.assert_array_equal(bits, bits_t[v].reshape(-1))
            np.testing.assert_array_equal(u.view(np.uint32),
                                          u_t[v].reshape(-1).view(np.uint32))
            assert_gumbel_close(g, g_t[v].reshape(-1))
            assert g.dtype == np.float32


@pytest.mark.parametrize("seed", SEEDS)
def test_n1_emulation_at_high_flat_indices(seed):
    """Around 2^16 against a draw of that length; around 2^24 (and at
    2^32 - 1, the last index the low word holds) against the plain
    threefry of the same (0, index) counts, as random_bits counts them."""
    key = prng.split(prng.prng_key(seed), 3)[2]
    around = np.arange(-16, 16, dtype=np.int64)
    index = (1 << 16) + around
    bits, _, _ = n1_draws(key, index.astype(np.uint64))
    np.testing.assert_array_equal(
        bits, prng.random_bits(key, ((1 << 16) + 16,)).numpy()[index])
    index = np.concatenate([(1 << 24) + around, [2**32 - 1]])
    bits, u, g = n1_draws(key, index.astype(np.uint64))
    k = key.astype(np.int64)
    b1, b2 = prng.threefry2x32(k[0], k[1], 0, index)
    np.testing.assert_array_equal(bits, (b1 ^ b2).astype(np.uint32))
    assert (u >= prng.F32_TINY).all() and (u < 1.0).all()
    assert np.isfinite(g).all()


def test_wrappers_on_the_cpu_run_the_twins():
    """gumbel and threefry_bits on the CPU equal their plain twins bit for
    bit (no launch counted); threefry_bits is random_bits reinterpreted as
    int32; no keys (A = 0) and an odd n * M give the plain shapes."""
    keys = prng.split(prng.split(prng.prng_key(4), 5), 3)      # (5, 3, 2)
    launches = prng.gumbel.launches, prng.threefry_bits.launches
    for shape in [(7, 9), (128, 192), (13,)]:
        g = prng.gumbel(keys, shape, "cpu")
        assert g.dtype == torch.float32 and g.shape == (5, 3) + shape
        assert torch.equal(g, prng.gumbel_torch(keys, shape))
        b = prng.threefry_bits(keys, shape, "cpu")
        assert b.dtype == torch.int32
        assert torch.equal(b, prng.threefry_bits_torch(keys, shape))
        assert torch.equal(b.to(torch.int64) & prng.MASK,
                           prng.random_bits(keys, shape))
    empty = keys[:0]                                            # (0, 3, 2)
    assert prng.gumbel(empty, (7, 9), "cpu").shape == (0, 3, 7, 9)
    assert prng.threefry_bits(empty, (7, 9), "cpu").shape == (0, 3, 7, 9)
    assert (prng.gumbel.launches, prng.threefry_bits.launches) == launches


@pytest.mark.parametrize("fn", [prng.gumbel, prng.threefry_bits],
                         ids=["gumbel", "bits"])
def test_wrappers_refuse_what_the_kernel_cannot_take(fn):
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="keys"):
        fn(np.zeros((3,), np.uint32), (4,))                  # not (..., 2)
    with pytest.raises(ValueError, match="draws a key"):
        fn(key, (1 << 16, 1 << 15))                          # n * M >= 2^31
    with pytest.raises(ValueError, match="no threefry path"):
        fn(key, (4,), "meta")
