"""Read the compiled reference's SIFT descriptor arithmetic and its short
pyramid products off, shape by shape.

Runs with the JAX package on the CPU, on the host type whose rounding the
port copies (tod_tpu_torch/ops/sift.py, tod_tpu_torch/ops/image.py):

    JAX_PLATFORMS=cpu python tools/fit_sift_order.py [--sift] [--short]
        [--libm] [--batches 1,2,4,12] [--features 300,...] [--quick]

``--sift`` classifies the summation order of XLA's dot of the (512, 1369)
descriptor tables by (1369, N) weights, N = 8 x batch x K, at every
per-level keypoint count K of the feature budgets (3 and 8 levels at
scale 1.2) and batch (the trainer's view batch, batched serving's frames).
Each output is probed by cancellation: three weights, 2^25, -2^25 and 1,
at depths i, j, m give 1 exactly when i and j meet before m joins them,
and four such probes tell one fused multiply-add chain a 512-deep block
("chain"), even/odd chains a 1024-deep block ("parity") and four chains
over depth mod 4 ("lanes") apart. It prints each N whose kind is not
``contraction_order``'s (the widths either side of each change of
``ops/image.py _WIDE_KERNELS`` among them), then holds the whole
descriptor (``sift_descriptors`` against ``jax.jit`` of the reference's)
bit for bit at a K of each kind, and the three steps read off the
compiled program besides the dot: ``sqrt(fma(gx, gx, gy * gy))`` against
the unfused and the other fused sum of squares, ``jnp.mod``'s
fmod-and-fix against the port's ``torch.remainder``, and the norm's
32-wide windows against a plain sum.

``--short`` holds every level of the 3- and 8-level pyramids of 20 small
frame sizes (48x64 to 180x320, whose deepest levels have 50 rows or
fewer) against the compiled ``build_pyramid`` on a seeded random frame,
and for each level that differs, which product (rows or columns) does.

``--libm`` compiles the reference's 2D-only detection step
(``tod_tpu/geometry/detection2d.py``, the P3P fault's path) and prints
the C library functions its object code calls by name, and the HLO that
``jnp.arccos`` lowers to.

It exits with status 1 if any N is not in the rule's order or any
descriptor, step or surveyed level differs (``--short`` prints the
levels it cannot match; tests/test_torch_sizes.py names them).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BIG = np.float32(2.0 ** 25)
# (i, j, m) probes and the kinds' answers (1: i and j meet before m)
PROBES = ((0, 1, 2), (0, 2, 1), (0, 4, 1), (512, 1023, 0))
KINDS = {(1, 0, 0, 1): "chain", (0, 1, 1, 0): "parity",
         (1, 0, 1, 0): "lanes", (1, 0, 0, 0): "one chain"}
SHORT_FRAMES = ("60x80,72x96,96x128,120x160,144x176,90x160,135x240,150x200,"
                "128x128,180x320,180x240,112x200,100x100,160x120,176x144,"
                "64x64,48x64,120x213,150x267,166x221")


def probe_kinds(n_cols: int) -> set:
    """The kinds of the (512, 1369) x (1369, n_cols) dot's outputs: row r
    of the constant operand holds probe r mod 4, every column the same
    ones, so each output answers its row's probe."""
    import jax
    import jax.numpy as jnp

    a = np.zeros((512, 1369), np.float32)
    for r in range(512):
        i, j, m = PROBES[r % 4]
        a[r, i], a[r, j], a[r, m] = BIG, -BIG, 1.0
    b = np.zeros((1369, n_cols), np.float32)
    b[sorted({p for t in PROBES for p in t}), :] = 1.0
    out = np.asarray(jax.jit(lambda x: jnp.dot(jnp.asarray(a), x))(
        jnp.asarray(b)))
    bits = (out == 1.0).astype(int)
    sigs = np.stack([bits[k::4] for k in range(4)], -1).reshape(-1, 4)
    return {KINDS.get(tuple(s), str(tuple(s))) for s in set(map(tuple, sigs))}


def sift_survey(batches, features, quick: bool) -> int:
    import jax
    import jax.numpy as jnp
    import torch
    from tod_tpu.ops import image as jimage
    from tod_tpu.ops import sift as jsift
    from tod_tpu_torch.ops import image as timage
    from tod_tpu_torch.ops import sift as tsift
    from tod_tpu_torch.ops.fast import features_per_level
    from tod_tpu_torch.ops.libm import atan2f

    counts = sorted({k for nf in features for n in (3, 8)
                     for k in features_per_level(nf, n, 1.2)} | {1, 2, 3})
    widths = sorted({8 * b * k for b in batches for k in counts})
    if quick:
        widths = widths[::7]
    # either side of each width where the wide products' kernels change:
    # the widest of the old kernel and the next width of its class
    for widest, step, _ in timage._WIDE_KERNELS:
        nxt = next(c for c in range(widest + 8, widest + 80, 8)
                   if (c - 1) // 16 % 4 == step)
        widths = sorted(set(widths) | {widest, nxt})
    bad = 0
    t0 = time.perf_counter()
    for n_cols in widths:
        got = probe_kinds(n_cols)
        want = tsift.contraction_order(n_cols // 8)[0]
        if got != {want}:
            print(f"    N={n_cols}: {sorted(got)}, rule {want}")
            bad += 1
    print(f"sift: {len(widths)} widths N = 8 x batch x K (batch "
          f"{list(batches)}, K {counts[0]}-{counts[-1]}), "
          f"{len(widths) - bad} in the rule's order "
          f"({time.perf_counter() - t0:.0f} s)")

    rng = np.random.default_rng(0)
    gray = (rng.random((120, 160)) * 255).astype(np.float32)
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(gray), 7, 1.6))
    for k in (1, 3, 4, 7, 30, 96, 250, 1374, 1978):
        xy = np.stack([rng.integers(18, 142, k), rng.integers(18, 102, k)],
                      -1).astype(np.int32)
        ang = rng.uniform(-np.pi, np.pi, k).astype(np.float32)
        ref = np.asarray(jax.jit(jsift.sift_descriptors)(
            jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(ang)))
        got = tsift.sift_descriptors(torch.from_numpy(blurred.copy()),
                                     torch.from_numpy(xy),
                                     torch.from_numpy(ang)).numpy()
        n_bad = int((got != ref).sum())
        print(f"sift: K={k} ({tsift.contraction_order(k)[0]}): "
              f"{n_bad} of {ref.size} descriptor entries differ")
        bad += bool(n_bad)

    # the steps around the dot, against jax.jit of each alone
    gx, gy = (rng.standard_normal((2, 64, 1369)) * 40).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jnp.sqrt(a * a + b * b))(gx, gy))
    tx, ty = torch.from_numpy(gx), torch.from_numpy(gy)
    for name, m2 in (("fma(gx, gx, gy gy)", timage.fma_f32(tx, tx, ty * ty)),
                     ("fma(gy, gy, gx gx)", timage.fma_f32(ty, ty, tx * tx)),
                     ("gx gx + gy gy", tx * tx + ty * ty)):
        n_bad = int((tsift._sqrt_f32(m2).numpy() != ref).sum())
        print(f"sift: magnitude sqrt({name}): {n_bad} of {ref.size} differ")
        bad += bool(n_bad) and name.startswith("fma(gx")
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    rel_j = np.asarray(jax.jit(lambda a, b, t: jnp.mod(
        (jnp.arctan2(b, a) - t[:, None]) * (8 / (2.0 * np.pi)), 8))(
            gx, gy, ang))
    rel_t = torch.remainder((atan2f(ty, tx) - torch.from_numpy(ang)[:, None])
                            * (8 / (2.0 * np.pi)), 8).numpy()
    n_bad = int((rel_t != rel_j).sum())
    print(f"sift: orientation bins (host atan2f, jnp.mod as torch.remainder):"
          f" {n_bad} of {rel_j.size} differ")
    bad += bool(n_bad)
    desc = np.abs(rng.standard_normal((64, 128))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda d: jnp.linalg.norm(d, axis=1))(desc))
    n_bad = int((tsift._norm(torch.from_numpy(desc)).numpy() != ref).sum())
    plain = np.sqrt((desc.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    print(f"sift: norms in 32-wide windows: {n_bad} of {ref.size} differ "
          f"(an exact sum rounded once: {int((plain != ref).sum())})")
    bad += bool(n_bad)
    return bad


def row_cuts(depth: int, rows: int, width: int) -> list:
    """Depths at which the compiled row product (``dot(W, x)`` contracting
    both operands' first axis, as ``jax.image.resize`` of the rows runs it)
    starts a new partial sum, in any output: probe b puts 2^25, -2^25 and
    1 at depths b - 1, b, b + 1 of a column, whose output is 1 unless a
    partial sum starts at b (each column probes every b in turn)."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda w, x: jax.lax.dot_general(
        w, x, (((0,), (0,)), ((), ())), precision="highest"))
    w = jnp.ones((depth, rows), jnp.float32)
    cuts = set()
    for shift in range(depth - 2):
        x = np.zeros((depth, width), np.float32)
        b = 1 + (np.arange(width) + shift) % (depth - 2)
        cols = np.arange(width)
        x[b - 1, cols], x[b, cols], x[b + 1, cols] = BIG, -BIG, 1.0
        out = np.asarray(f(w, jnp.asarray(x)))
        cuts.update(b[(out != 1.0).any(0)].tolist())
    return sorted(cuts)


def short_survey(frames) -> int:
    import jax
    import jax.numpy as jnp
    import torch
    from tod_tpu.ops import image as jimage
    from tod_tpu_torch.ops import image as timage

    bad = 0
    for frame in frames.split(","):
        h, w = (int(v) for v in frame.split("x"))
        rng = np.random.default_rng(h * 1000 + w)
        gray = (rng.random((h, w)) * 255).astype(np.float32)
        for n_levels in (3, 8):
            ref = jax.jit(lambda g: jimage.build_pyramid(g, n_levels, 1.2))(
                jnp.asarray(gray))
            got = timage.build_pyramid(torch.from_numpy(gray), n_levels, 1.2)
            for level, (a, b) in enumerate(zip(got, ref)):
                n_bad = int((a.numpy() != np.asarray(b)).sum())
                if not n_bad:
                    continue
                oh, ow = a.shape
                rows = np.asarray(jax.jit(lambda g: jax.image.resize(
                    g, (oh, w), method="linear"))(jnp.asarray(gray)))
                row_bad = int((timage._resize_rows(
                    torch.from_numpy(gray), oh,
                    timage.gemm_order(h, oh, True)).numpy() != rows).sum())
                cuts = (f", partial sums from depths {row_cuts(h, oh, w)}"
                        if row_bad else "")
                print(f"    {frame}, {n_levels} levels, level {level} "
                      f"({oh}x{ow}): {n_bad} pixels differ; the row product "
                      f"{h} -> {oh} at width {w}: {row_bad}{cuts}")
                bad += 1
    short = sum(s[0] <= 50 for f in frames.split(",")
                for s in timage.pyramid_shapes(*map(int, f.split("x")), 8,
                                               1.2))
    print(f"short: {len(frames.split(','))} frames, 3 and 8 levels "
          f"({short} levels of 50 rows or fewer at 8): {bad} levels differ")
    return bad


def libm_calls() -> None:
    """The named C library calls of the reference's compiled P3P and its
    Gauss-Newton refinement (tod_tpu/geometry/pnp.py, the 2D-only path)."""
    import jax
    import jax.numpy as jnp

    out = tempfile.mkdtemp(prefix="xla_dump_")
    jax.config.update("jax_compilation_cache_dir", None)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={out}")
    from tod_tpu.geometry import pnp

    rng = np.random.default_rng(0)
    rays = rng.standard_normal((64, 3, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    pts = (rng.standard_normal((64, 3, 3)) + [0, 0, 2]).astype(np.float32)
    jax.jit(jax.vmap(pnp.p3p))(jnp.asarray(rays), jnp.asarray(pts))
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    X = (rng.standard_normal((50, 3)) + [0, 0, 2]).astype(np.float32)
    uv = (rng.random((50, 2)) * 400).astype(np.float32)
    jax.jit(pnp.gauss_newton_pose)(jnp.eye(3), jnp.zeros(3), K, X, uv,
                                   jnp.ones(50))
    names = set()
    for obj in glob.glob(os.path.join(out, "*.o")):
        syms = subprocess.run(["nm", "-u", obj], capture_output=True,
                              text=True).stdout
        names.update(re.findall(r"\bU (\w+)", syms))
    print("libm: the compiled P3P and refinement call "
          + ", ".join(sorted(names)))
    lowered = jax.jit(jnp.arccos).lower(jnp.float32(0.5))
    ops = sorted(set(re.findall(r"= f32\[\] (\w+)\(",
                                lowered.compile().as_text())))
    print("libm: jnp.arccos lowers to "
          + ("chlo.acos" if "chlo.acos" in lowered.as_text() else "?")
          + ", compiled as the HLO ops " + ", ".join(ops))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sift", action="store_true")
    ap.add_argument("--short", action="store_true")
    ap.add_argument("--libm", action="store_true")
    ap.add_argument("--batches", default="1,2,4,12")
    ap.add_argument("--features", default="300,500,600,800,1000,2000,3000,"
                    "5000")
    ap.add_argument("--frames", default=SHORT_FRAMES)
    ap.add_argument("--quick", action="store_true",
                    help="every 7th width of the --sift survey")
    args = ap.parse_args()
    if not (args.sift or args.short or args.libm):
        args.sift = args.short = True
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    bad = 0
    if args.sift:
        bad += sift_survey([int(v) for v in args.batches.split(",")],
                           [int(v) for v in args.features.split(",")],
                           args.quick)
    if args.short:
        bad += short_survey(args.frames)
    if args.libm:
        libm_calls()
    print("every surveyed shape in the port's order" if not bad
          else f"{bad} shapes or steps differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
