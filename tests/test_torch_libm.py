"""The port's float32 ``atan2f`` (``tod_tpu_torch/ops/libm.py``) against the
host C library's and against the compiled reference's ``jnp.arctan2``, bit
for bit; and its transcriptions of glibc's FMA builds of ``cosf``,
``sinf`` / ``sincosf`` and ``powf`` (and the double FMA they rest on)
against the host C library's, XLA's inline ``log`` against
``jax.jit(jnp.log)`` and the correctly rounded root against numpy's, bit
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
for _name in ("cosf", "sinf"):
    getattr(_LIBM, _name).restype = ctypes.c_float
    getattr(_LIBM, _name).argtypes = [ctypes.c_float]
_LIBM.powf.restype = ctypes.c_float
_LIBM.powf.argtypes = [ctypes.c_float, ctypes.c_float]
_LIBM.fma.restype = ctypes.c_double
_LIBM.fma.argtypes = [ctypes.c_double] * 3


def host1(name: str, x: np.ndarray) -> np.ndarray:
    """The C library's float function ``name`` of each element."""
    f = getattr(_LIBM, name)
    return np.fromiter((f(v) for v in x.tolist()), np.float32, len(x))


def host_powf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    f = _LIBM.powf
    return np.fromiter((f(a, b) for a, b in zip(x.tolist(), y.tolist())),
                       np.float32, len(x))


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
    # the premise of cosf, sincosf and powf: this host's libm picks
    # glibc 2.36's FMA builds, which the port transcribes (another build or
    # an older glibc rounds some of these otherwise)
    x = np.concatenate([y, 1e4 * y]).astype(np.float32)
    t = torch.from_numpy(x)
    sin, cos = libm.sincosf_torch(t)
    assert_same_bits(cos.numpy(), host1("cosf", x), "cosf against libm")
    assert_same_bits(sin.numpy(), host1("sinf", x), "sinf against libm")
    ax = np.abs(x)
    third = np.full_like(ax, 1.0 / 3.0)
    assert_same_bits(libm.powf_torch(torch.from_numpy(ax),
                                     torch.from_numpy(third)).numpy(),
                     host_powf(ax, third), "powf against libm")


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


# ---- glibc's FMA builds: cosf, sinf / sincosf, powf; XLA's log; sqrt -----


def _floats(seed: int, n: int) -> np.ndarray:
    """Floats over 8 decades either side of 1, both signs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
            ).astype(np.float32)


SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                    1.17549435e-38, 2.0 ** -12, -2.0 ** -12, 2.0 ** -13,
                    0.785398, 0.7853982, 0.7853983, 119.99, 120.0, 120.01,
                    1e10, 3.4028235e38, -3.4028235e38, np.float32(np.pi),
                    -np.float32(np.pi), 1.0, -1.0, 0.5, 2.0], np.float32)


def _ranges(seed: int) -> np.ndarray:
    """The 2D path's arguments: theta / 3 of the resolvent cubic, the
    mirror's angles, Gauss-Newton's small steps, the eigen-solve's angles,
    and the Cardano terms of the cube root."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, np.pi / 3, 20000),
                           rng.uniform(-np.pi, np.pi, 20000),
                           rng.uniform(0, 1e-3, 20000),
                           rng.uniform(2 * np.pi / 3, np.pi, 20000),
                           10.0 ** rng.uniform(-12, 6, 20000)]
                          ).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sincosf_random(seed):
    """Four cases of 250,000 random floats: 10^6 in all, sin and cos."""
    x = _floats(seed, 250_000)
    sin, cos = libm.sincosf_torch(torch.from_numpy(x))
    assert_same_bits(sin.numpy(), host1("sinf", x), f"sinf, seed {seed}")
    assert_same_bits(cos.numpy(), host1("cosf", x), f"cosf, seed {seed}")


def test_sincosf_special_values_and_ranges():
    x = np.concatenate([SPECIAL, _ranges(4)])
    sin, cos = libm.sincosf_torch(torch.from_numpy(x))
    assert_same_bits(sin.numpy(), host1("sinf", x), "sinf")
    assert_same_bits(cos.numpy(), host1("cosf", x), "cosf")
    assert_same_bits(libm.cosf(torch.from_numpy(x)).numpy(), cos.numpy(),
                     "the cosf wrapper")
    assert_same_bits(libm.sincosf(torch.from_numpy(x))[0].numpy(),
                     sin.numpy(), "the sincosf wrapper")


@pytest.mark.parametrize("seed", [0, 1])
def test_log_xla_random_special_and_ranges(seed):
    """XLA's inline ``log`` (the 2D path's log-ratios) against
    ``jax.jit(jnp.log)``: 500,000 floats a case over the whole range,
    subnormals (taken as zero by XLA's runtime), zeros, negatives, the
    special values, and the path's arguments."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        (rng.random(500_000) * 10.0 ** rng.uniform(-46, 38, 500_000)),
        -rng.random(1000) * 1e-40, _floats(seed, 20_000), SPECIAL,
        _ranges(seed)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    assert_same_bits(libm.log_xla(torch.from_numpy(x)).numpy(), want,
                     f"log_xla, seed {seed}")


def test_log1p_of_counts_is_log_of_one_plus():
    """``jnp.log1p`` of the sampling graph's counts (integers from 1 to
    10^9, and 0) compiles to XLA's ``log`` of ``1 + count``: the RANSAC
    weights of both paths (``ransac.consistency_log_weights``)."""
    rng = np.random.default_rng(12)
    c = np.concatenate([[0.0], np.floor(10.0 ** rng.uniform(0, 9, 200_000))]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(c)))
    assert_same_bits(libm.log_xla(1.0 + torch.from_numpy(c)).numpy(), want,
                     "log1p of counts")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sqrt_rn_is_correctly_rounded(dtype):
    """PyTorch's CPU sqrt misses the correctly rounded root on some
    arguments (its vectorised loops); ``sqrt_rn`` gives numpy's (the
    host's ``sqrtss``/``sqrtsd``) on 10^6 arguments, the specials
    included."""
    rng = np.random.default_rng(13)
    x = np.concatenate([rng.random(1_000_000) * 10.0 ** rng.uniform(
        -30, 30, 1_000_000), [0.0, -0.0, np.inf, np.nan, -1.0, 1e-40]]
                       ).astype(dtype)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = libm.sqrt_rn(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    view = np.int32 if dtype == np.float32 else np.int64
    np.testing.assert_array_equal(got[~nan].view(view), want[~nan].view(view))
    theirs = torch.sqrt(torch.from_numpy(x)).numpy()
    assert (theirs[~nan].view(view) != want[~nan].view(view)).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_powf_cube_roots(seed):
    """P3P's cube root: |x| ** (1/3) over 500,000 floats a case, the
    special values and the Cardano terms."""
    x = np.abs(np.concatenate([_floats(seed, 500_000), SPECIAL,
                               _ranges(seed)]))
    y = np.full_like(x, 1.0 / 3.0)
    got = libm.powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert_same_bits(got, host_powf(x, y), f"powf(x, 1/3), seed {seed}")


def test_powf_any_operands():
    """Random pairs (integral y a third of them: the sign rules), and every
    pair of the special values: overflow, underflow, the may-underflow
    band, zeros, infinities, NaN, negative bases."""
    rng = np.random.default_rng(9)
    x = _floats(5, 200_000)
    y = (rng.standard_normal(200_000) * 10.0 ** rng.uniform(-3, 2, 200_000)
         ).astype(np.float32)
    y[::3] = np.round(y[::3])
    vals = np.concatenate([SPECIAL, np.array(
        [3.0, -3.0, 1e-40, -1e-40, 0.25, -2.5, 127.0, -150.0, 200.0,
         -200.0, 149.5, -149.5], np.float32)])
    px, py = (np.array(v, np.float32) for v in zip(*itertools.product(
        vals, vals)))
    x, y = np.concatenate([x, px]), np.concatenate([y, py])
    got = libm.powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert_same_bits(got, host_powf(x, y), "powf")


def test_fma_f64_against_libm_fma():
    """The emulated double FMA against the C library's ``fma``: products
    that cancel the addend to 8 digits, and random operands."""
    rng = np.random.default_rng(11)
    n = 100_000
    a = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    b = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    c = np.where(np.arange(n) % 2, -a * b * (1 + rng.standard_normal(n)
                                             * 1e-8),
                 rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n))
    got = libm.fma_f64(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    want = np.fromiter((_LIBM.fma(*v) for v in zip(a, b, c)), np.float64, n)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_acosf_is_xlas_arccos():
    """``jnp.arccos`` compiled by XLA: atan2f(sqrt((1 - x)(1 + x)), x),
    bit for bit over [-1, 1] and past it (NaN)."""
    x = np.concatenate([np.linspace(-1, 1, 100_001), [-1.5, 2.0, np.nan]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.arccos)(jnp.asarray(x)))
    got = libm.acosf(torch.from_numpy(x)).numpy()
    assert_same_bits(got, want, "acosf against jax.jit(jnp.arccos)")


def test_libm_wrappers_route_by_device():
    """On CPU tensors the wrappers are the plain versions and launch
    nothing; other devices raise."""
    x = torch.from_numpy(_floats(3, 1000))
    before = libm.libm_f32.launches
    assert torch.equal(libm.log_xla(x.abs()), libm.log_xla_torch(x.abs()))
    assert torch.equal(libm.powf(x.abs(), x), libm.powf_torch(x.abs(), x))
    assert libm.libm_f32.launches == before
    with pytest.raises(ValueError):
        libm.cosf(x.to("meta"))
    with pytest.raises(ValueError):
        libm.powf(x[:10], x)
