"""Read the compiled reference's resize summation orders off, product by
product.

Runs with the JAX package on the CPU, on the host type whose rounding the
port copies (tod_tpu_torch/ops/image.py):

    JAX_PLATFORMS=cpu python tools/fit_resize_order.py [--frames 720x1280,...]
        [--levels 3,8] [--tests]

For each level of the pyramids (scale 1.2) of the frame sizes it:
- holds the row product (rows pass) in the order ``gemm_order`` derives
  against the compiled resize of the rows alone, on two random frames;
- runs the column product (columns pass) in each of the three orders
  ("chain", "parity", "lanes") against the compiled resize of the columns
  alone, and prints ``(depth, cols)`` and the orders that match, with ``*``
  where ``gemm_order``'s rule picks another.

``--tests`` then runs tests/test_torch_sizes.py at those frame sizes
(``TORCH_SIZES_FRAMES``): the weights and the levels bit for bit, ORB in
slot order and SIFT at 3 and 8 levels. It exits with status 1 if any
product matches no order or the rule's order, or a test fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GRID = "240x320,480x640,480x848,720x1280,960x1280,1080x1920"


def compiled_resize(x: np.ndarray, out_hw):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(lambda a: jax.image.resize(
        a, out_hw, method="linear"))(jnp.asarray(x)))


def product_orders(rows: int, depth: int, cols: int, rows_pass: bool):
    """The orders whose product equals the compiled reference's on two
    random inputs: the row product resizes a (depth, cols) frame to (rows,
    cols) and is tried in the derived order only; the column product
    resizes (rows, depth) to (rows, cols) and is tried in all three."""
    import torch
    from tod_tpu_torch.ops import image as timage

    kinds = {"chain": (timage._BLOCK["chain"],),
             "parity": (timage._BLOCK["parity"],), "lanes": (depth,)}
    if rows_pass:
        kinds = {"chain": (timage._row_slice(depth),)}
    good = []
    for kind, (block,) in kinds.items():
        ok = True
        for seed in (0, 1):
            rng = np.random.default_rng(seed)
            if rows_pass:    # (depth, cols) -> (rows, cols)
                x = (rng.random((depth, cols)) * 255).astype(np.float32)
                ref = compiled_resize(x, (rows, cols))
                got = timage._resize_rows(torch.from_numpy(x), rows,
                                          (kind, block)).numpy()
            else:            # (rows, depth) -> (rows, cols)
                x = (rng.random((rows, depth)) * 255).astype(np.float32)
                ref = compiled_resize(x, (rows, cols))
                got = timage._resize_rows(torch.from_numpy(x.T.copy()), cols,
                                          (kind, block)).numpy().T
            if not np.array_equal(got, ref):
                ok = False
                break
        if ok:
            good.append(kind)
    return good


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", default=GRID)
    ap.add_argument("--levels", default="3,8")
    ap.add_argument("--tests", action="store_true")
    args = ap.parse_args()

    import torch
    from tod_tpu_torch.ops import image as timage

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    top = max(int(v) for v in args.levels.split(","))
    bad = 0
    for frame in args.frames.split(","):
        h, w = (int(v) for v in frame.split("x"))
        t0 = time.perf_counter()
        print(f"{h}x{w}:")
        for oh, ow in timage.pyramid_shapes(h, w, top, 1.2)[1:]:
            if product_orders(oh, h, w, True) != ["chain"]:
                print(f"    row product {(oh, h, w)}: not the derived slices")
                bad += 1
            good = product_orders(oh, w, ow, False)
            have = timage.gemm_order(w, ow, False)[0]
            mark = "" if have in good else " *"
            print(f"    ({w}, {ow}): {' / '.join(good) or 'NONE'}{mark}")
            bad += bool(mark)
        print(f"{h}x{w}: {time.perf_counter() - t0:.0f} s", flush=True)
    print("every product in the rule's order" if not bad
          else f"{bad} products not in the rule's order")
    if args.tests:
        import pytest
        os.environ["TORCH_SIZES_FRAMES"] = args.frames
        os.chdir(ROOT)
        bad += pytest.main(["-q", "-p", "no:cacheprovider",
                            os.path.join(ROOT, "tests",
                                         "test_torch_sizes.py")])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
