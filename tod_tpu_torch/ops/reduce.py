"""Row reductions summed in the compiled reference's order.

XLA's CPU backend rewrites a reduce over a row of 128 float32 values into a
reduce-window: the terms added in order within each 32-wide window from
+0, then the four windows added in order (read off jax 0.9.0 on x86-64
with AVX-512 and FMA; ``tools/fit_l2_order.py`` rereads it). The SIFT
descriptor's norms (``ops/sift.py``) and the L2 matcher's row norms
(``ops/matching.py``) both sum so.
"""

from __future__ import annotations

import torch

WINDOW = 32             # the reduce-window's width


def square_norms(x: torch.Tensor) -> torch.Tensor:
    """(N,) float32 squared norms of (N, D) float32 rows, D a multiple of
    :data:`WINDOW`, summed as the compiled reference sums them: the
    squares rounded, added in order within each window from +0, the
    windows added in order."""
    sq = (x * x).reshape(x.shape[0], x.shape[1] // WINDOW, WINDOW)
    win = sq[:, :, 0]
    for i in range(1, WINDOW):
        win = win + sq[:, :, i]
    total = win[:, 0]
    for j in range(1, sq.shape[1]):
        total = total + win[:, j]
    return total
