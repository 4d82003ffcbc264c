"""The port's float32 ``atan2f`` (``tod_tpu_torch/ops/libm.py``) against the
host C library's and against the compiled reference's ``jnp.arctan2``, bit
for bit.

XLA's CPU backend lowers ``atan2`` to a call of the C library's ``atan2f``,
so the reference's keypoint and gradient orientations are this host's libm
(glibc 2.36, x86-64: fdlibm's float code). The port computes that function
itself, in plain PyTorch here and in kernel L1 on the card. The first case
holds the premise: on a host whose libm rounds otherwise, it fails first.
"""

import ctypes
import ctypes.util
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu_torch.ops import libm

torch.set_num_threads(1)

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.atan2f.restype = ctypes.c_float
_LIBM.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]


def host_atan2f(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The C library's ``atan2f``, pair by pair."""
    f = _LIBM.atan2f
    return np.fromiter((f(a, b) for a, b in zip(y.tolist(), x.tolist())),
                       np.float32, len(y))


def compiled_arctan2(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))


def assert_same_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Bit for bit, NaN payloads aside (every NaN in one place as NaN)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, what)
    differ = got.view(np.int32)[~nan] != want.view(np.int32)[~nan]
    assert not differ.any(), (
        f"{what}: {int(differ.sum())} of {differ.size} differ, e.g. "
        f"{got[~nan][differ][:3]} against {want[~nan][differ][:3]}")


def _subnormal(v: np.ndarray) -> np.ndarray:
    return (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)


def _check(y: np.ndarray, x: np.ndarray, what: str) -> None:
    """Against libm on every pair; against the compiled reference on the
    pairs without a subnormal argument or result: XLA's CPU runtime flushes
    subnormal operands and results to zero (atan2f(1e-45, 1e-45) is then
    0 / 0, NaN), which no image gradient or moment reaches (ROADMAP queue
    C, held)."""
    got = libm.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    host = host_atan2f(y, x)
    assert_same_bits(got, host, f"{what} against libm")
    normal = ~(_subnormal(y) | _subnormal(x) | _subnormal(host))
    assert_same_bits(got[normal], compiled_arctan2(y, x)[normal],
                     f"{what} against jax.jit(jnp.arctan2)")


def _random_pairs(seed: int, n: int):
    """Pairs over 6 decades either side of 1, both signs."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    return y.astype(np.float32), x.astype(np.float32)


def test_host_libm_is_the_premise():
    """The premise of the port's atan2f: this host's libm is the compiled
    reference's atan2 and rounds as fdlibm's float code (glibc 2.36); where
    either fails, the reference's angles are another function."""
    y, x = _random_pairs(7, 50_000)
    host = host_atan2f(y, x)
    assert_same_bits(compiled_arctan2(y, x), host,
                     "the reference's atan2 against this host's libm")
    assert_same_bits(libm.atan2f_torch(torch.from_numpy(y),
                                       torch.from_numpy(x)).numpy(), host,
                     "fdlibm's atan2f (the port) against this host's libm")
    # and not PyTorch's own atan2, which rounds otherwise in ~15 %
    theirs = torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert (theirs.view(np.int32) != host.view(np.int32)).mean() > 0.05


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_pairs(seed):
    """Four cases of 250,000 random pairs: 10^6 in all."""
    _check(*_random_pairs(seed, 250_000), f"random pairs, seed {seed}")


def test_integer_pairs():
    """All 261,121 pairs in [-255, 255]^2: the central differences of 8-bit
    images, zero in either or both."""
    g = np.arange(-255, 256, dtype=np.float32)
    y, x = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    _check(y, x, "integer pairs")


def test_special_values():
    """+-0, +-inf and NaN in either argument, x == 1 (fdlibm's own branch),
    subnormals, the extremes, and |y / x| around 2^26 and 2^60 (either of
    which a float atan2f may cut at) and their reciprocals, every sign."""
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-45, -1e-45,
            1.17549435e-38, 3.4028235e38, -3.4028235e38, 0.5, 2.0, 1e-30,
            1e30, np.float32(np.pi)]
    y, x = (np.array(v, np.float32) for v in zip(*itertools.product(vals,
                                                                     vals)))
    _check(y, x, "special values")
    rng = np.random.default_rng(5)
    ys, xs = [], []
    for e in (24, 25, 26, 27, 28, 58, 59, 60, 61, 62):
        xm = rng.uniform(1, 2, 200) * 2.0 ** rng.integers(-40, 40, 200)
        ym = xm * 2.0 ** e * rng.uniform(0.5, 2, 200)
        for sy, sx in itertools.product((1, -1), (1, -1)):
            ys += [sy * ym, sy * xm]
            xs += [sx * xm, sx * ym]
    y = rng.standard_normal(2000) * 10.0 ** rng.uniform(-40, 38, 2000)
    ys += [y, -y, [2.0 ** -29, 2.0 ** -30, 2.0 ** 25, 2.0 ** 26]]
    xs += [np.ones(2000), np.ones(2000), np.ones(4)]
    _check(np.concatenate(ys).astype(np.float32),
           np.concatenate(xs).astype(np.float32), "extreme ratios, x == 1")


def test_wrapper_refuses_what_it_cannot_take():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; other types, shapes and devices raise."""
    y, x = (torch.from_numpy(a) for a in _random_pairs(3, 1000))
    before = libm.atan2f.launches
    assert torch.equal(libm.atan2f(y, x), libm.atan2f_torch(y, x))
    assert libm.atan2f.launches == before
    assert libm.atan2f(y[:0], x[:0]).shape == (0,)
    with pytest.raises(TypeError):
        libm.atan2f(y.double(), x.double())
    with pytest.raises(ValueError):
        libm.atan2f(y[:10], x)
    with pytest.raises(ValueError):
        libm.atan2f(y.to("meta"), x.to("meta"))
