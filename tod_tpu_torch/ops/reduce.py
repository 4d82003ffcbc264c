"""Row reductions summed in the compiled reference's order.

XLA's CPU backend rewrites a reduce over a row of 128 float32 values into a
reduce-window: the terms added in order within each 32-wide window from
+0, then the four windows added in order (read off jax 0.9.0 on x86-64
with AVX-512 and FMA; ``tools/fit_l2_order.py`` rereads it). The SIFT
descriptor's norms (``ops/sift.py``) and the L2 matcher's row norms
(``ops/matching.py``) both sum so.

A reduce over more than one window's terms (:func:`tree_sum`) becomes a
reduce-window of 32-wide windows over the terms padded to a multiple of
32, then a reduce of the windows' sums, by the same rule: the 2D path's
model mean and truncated reprojection error (``geometry/detection2d.py``)
and the resize's weights (``ops/image.py``) sum so.
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


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)`` in the compiled reference's order, on any device:
    :data:`WINDOW` terms or fewer added in order from +0; more, padded to
    a multiple of :data:`WINDOW` with ``pad // 2`` zeros in front (the
    rest behind), each window added in order from +0, and the windows'
    sums reduced the same way (XLA's tree-reduction rewrite)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    total = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    if n <= WINDOW:
        for row in x:
            total = total + row
        return total
    padded = -(-n // WINDOW) * WINDOW
    front = (padded - n) // 2
    zeros = x.new_zeros((1,) + x.shape[1:])
    x = torch.cat([zeros.expand((front,) + x.shape[1:]), x,
                   zeros.expand((padded - n - front,) + x.shape[1:])])
    windows = x.unflatten(0, (padded // WINDOW, WINDOW))
    total = total.expand(windows.shape[:1] + total.shape)
    for i in range(WINDOW):
        total = total + windows[:, i]
    return tree_sum(total, 0)
