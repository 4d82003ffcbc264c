"""Read off where the compiled reference's pyramid products split their
depth, and how its column kernels sum a depth that is no multiple of their
unroll.

Runs with the JAX package on the CPU, on the host type whose rounding the
port copies (tod_tpu_torch/ops/image.py):

    JAX_PLATFORMS=cpu python tools/fit_pyramid_shards.py [--frames HxW,...]
        [--batch 1] [--depths 97,98,...]

XLA's CPU program of ``jax.image.resize`` runs two dots a level. The row
product (and both products where the columns go first, the path of the
reference's ``jnp.einsum`` when the output is narrower than tall) has a
transposed operand and goes to Eigen's thread-pool contraction, which may
split the depth into blocks summed apart (``ops/image.py depth_shard``,
``eigen_order``). For each such product of each level of the 8-level
pyramids of ``--frames`` (at the compiled pyramid's depth, free and
output sizes, vmapped over ``--batch`` images the batch folded into the
free dimension, as one dot of the weights against the image contracting
both first axes), a
cancellation probe finds every depth at which a partial sum starts: 2^25
at depth p, -2^25 at p + 4 and 1 at the last depth give 1 exactly unless a
partial sum starts in (p, p + 4] (within one chain, lanes or parity kernel
the two meet first). It prints the probed and the predicted starts of each
product that splits, and a mark where they differ.

The plain column product (no transposed operand) runs oneDNN's kernels
(``gemm_order``). On dense random operands at each of ``--depths``, it
holds the port's tail rule, the kernels' products past their unroll (2 for
parity, 4 for lanes), each rounded and added after the unrolled sum,
against the compiled dot and against the rule it replaced (lanes over the
whole depth; parity chains over each block's first multiple of 8, the rest
chained on).

It exits with status 1 if a product splits elsewhere than predicted or a
tail differs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BIG = np.float32(2.0 ** 25)
FRAMES = ("60x80,72x96,96x128,120x160,144x176,90x160,135x240,150x200,"
          "128x128,180x320,180x240,112x200,100x100,160x120,176x144,64x64,"
          "48x64,120x213,150x267,166x221,240x320,360x640,480x640")


def transposed_products(h: int, w: int, batch: int):
    """(depth, free, out) of each transposed-operand dot of the 8-level
    pyramid of an (h, w) frame as the compiled reference forms it: W
    (depth, out) against x (depth, free), output (out, free)."""
    from tod_tpu_torch.ops import image as timage

    shapes = []
    for oh, ow in timage.pyramid_shapes(h, w, 8, 1.2)[1:]:
        if oh != h and ow != w and ow < oh:
            shapes += [(w, batch * h, ow), (h, batch * ow, oh)]
        elif oh != h:
            shapes.append((h, batch * w, oh))
    return shapes


def probed_starts(depth: int, free: int, out: int) -> list:
    """The depths after the first where the compiled dot of W (depth, out)
    against x (depth, free), contracting both first axes, starts a partial
    sum."""
    import jax
    import jax.numpy as jnp

    dot = jax.jit(lambda w, x: jax.lax.dot_general(
        w, x, (((0,), (0,)), ((), ())), precision="highest"))
    w = jnp.ones((depth, out), jnp.float32)
    fail = []
    ps = np.arange(depth - 5)
    for s in range(0, len(ps), free):
        chunk = ps[s:s + free]
        x = np.zeros((depth, free), np.float32)
        x[depth - 1] = 1.0
        cols = np.arange(len(chunk))
        x[chunk, cols], x[chunk + 4, cols] = BIG, -BIG
        got = np.asarray(dot(w, jnp.asarray(x)))      # (out, free)
        fail += chunk[(got[:, :len(chunk)] != 1.0).any(0)].tolist()
    # a start at b fails the probes p = b - 4 .. b - 1
    return sorted({p + 1 for p in fail if p + 1 not in fail})


def predicted_starts(depth: int, free: int, out: int) -> list:
    from tod_tpu_torch.ops import image as timage

    block = timage.eigen_order(depth, free, out)[1]
    return list(range(block, depth, block))


def tail_sums(x: np.ndarray, w: np.ndarray, kind: str, old: bool
              ) -> np.ndarray:
    """x (rows, depth) @ w (depth, cols) in oneDNN's ``kind`` (parity:
    1024-deep blocks of even and odd chains; lanes: four chains over
    k mod 4) as the port sums it, or (``old``) by the rule it replaced:
    lanes over the whole depth; parity chains over each block's first
    multiple of 8, its rest chained on."""
    ld = np.longdouble
    d = x.shape[1]

    def chain(ks, acc):
        for k in ks:
            acc = (x[:, k:k + 1].astype(ld) * w[k:k + 1].astype(ld)
                   + acc.astype(ld)).astype(np.float32)
        return acc

    zero = np.zeros((x.shape[0], w.shape[1]), np.float32)
    if kind == "lanes":
        end = d if old else d & ~3
        lane = [chain(range(j, end, 4), zero) for j in range(4)]
        out = (lane[0] + lane[1]) + (lane[2] + lane[3])
    else:
        end = d if old else d & ~1
        out = None
        for s in range(0, end, 1024):
            e = min(end, s + 1024)
            peel = s + ((e - s) & ~7) if old else e
            part = chain(range(s, peel, 2), zero) + chain(
                range(s + 1, peel, 2), zero)
            part = chain(range(peel, e), part)
            out = part if out is None else out + part
    tail = None
    for k in range(end, d):
        p = x[:, k:k + 1] * w[k:k + 1]
        tail = p if tail is None else tail + p
    return out if tail is None else out + tail


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", default=FRAMES)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--depths", default="97,98,99,100,101,102,103,213,221,"
                    "267,1101")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    from tod_tpu_torch.ops import image as timage

    bad = 0
    seen = set()
    for frame in args.frames.split(","):
        h, w = (int(v) for v in frame.split("x"))
        for shape in transposed_products(h, w, args.batch):
            if shape in seen:
                continue
            seen.add(shape)
            got, want = probed_starts(*shape), predicted_starts(*shape)
            if got != want or timage.depth_shard(shape[1], shape[2],
                                                 shape[0]):
                mark = "" if got == want else "  *"
                print(f"    {frame}: depth {shape[0]}, free {shape[1]}, out "
                      f"{shape[2]}: starts {got}, predicted {want}{mark}",
                      flush=True)
            bad += got != want
    print(f"splits: {len(seen)} transposed products, {bad} not as "
          "predicted")
    dot = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), precision="highest"))
    for d in (int(v) for v in args.depths.split(",")):
        rng = np.random.default_rng(d)
        for kind, cols in (("parity", 83), ("lanes", 107)):
            x = rng.standard_normal((60, d)).astype(np.float32)
            wt = rng.standard_normal((d, cols)).astype(np.float32)
            ref = np.asarray(dot(jnp.asarray(x), jnp.asarray(wt)))
            new = int((tail_sums(x, wt, kind, False) != ref).sum())
            old = int((tail_sums(x, wt, kind, True) != ref).sum())
            print(f"    tail: {kind} at depth {d}: the port's rule {new}, "
                  f"the rule it replaced {old} of {ref.size} outputs differ",
                  flush=True)
            bad += bool(new)
    print("every product as predicted" if not bad
          else f"{bad} products or tails differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
