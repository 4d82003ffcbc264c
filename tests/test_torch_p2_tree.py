"""Kernel P2's reduction schedule (``tod_tpu_torch/csrc/gauss_newton.cu``)
modelled in numpy, against ``transforms.pairwise_sum`` bit for bit.

P2 sums its 2N Jacobian rows for the 27 entries of J^T J and J^T r in one
tree whose grouping must be ``pairwise_sum``'s (the halves added
elementwise, an odd last row carried): register levels (thread t sums its
level-L node depth first, a level-1 node at a time from its two rows, the
pending left subtree of level 1 in registers and of higher levels on a
per-thread stack), shared
levels (the right half's nodes to the left half's threads, an odd last node
to the middle) and warp levels (``__shfl_down_sync`` by the half). The model
below follows the kernel's loops statement for statement on float32 rows
whose sums part under any other grouping, so the tree's grouping is checked
here, on the CPU, before the card runs it (tests/test_torch_cuda.py and
chip_smoke.py phase 3i hold the kernel itself against the plain version).
"""

import numpy as np
import pytest
import torch

from tod_tpu_torch.geometry.transforms import pairwise_sum

torch.set_num_threads(1)

THREADS = 256      # the kernel's kThreads
COLS = 3           # entries a row (the kernel's 27; the grouping is per entry)


def tree_levels(rows: int):
    """The kernel's register levels: the half sizes of the levels until at
    most THREADS nodes are left, and that node count."""
    halves, nodes = [], rows
    while nodes > THREADS:
        halves.append(nodes // 2)
        nodes -= nodes // 2
    return halves, nodes


def kernel_tree_sum(x: np.ndarray) -> np.ndarray:
    """The column sums of x (rows, COLS) as kernel P2's tree adds them."""
    f32 = np.float32
    halves, nodes = tree_levels(x.shape[0])
    levels = len(halves)
    held = {}                                 # thread -> its node's sums
    for t in range(nodes):
        p1 = np.zeros(COLS, f32)
        stack = {}
        if levels == 0:                   # node t is row t
            p1 = x[t].copy()
        for path in range(1 << (levels - 1) if levels else 0):
            node, ok = t, True
            for k in range(levels - 1, 0, -1):
                if (path >> (k - 1)) & 1:
                    node += halves[k]
                else:
                    ok = ok and node < halves[k]
            if not ok:
                continue
            has_left = node < halves[0]
            right = x[node + halves[0]]
            v = (x[node] + right).astype(f32) if has_left else right
            right1 = levels > 1 and bool(path & 1)
            p1 = (p1 + v).astype(f32) \
                if right1 and node - halves[1] < halves[1] else v.copy()
            if not right1:
                continue
            node -= halves[1]
            for k in range(2, levels):
                if not (path >> (k - 1)) & 1:
                    stack[k - 2] = p1.copy()
                    break
                node -= halves[k]
                if node < halves[k]:
                    p1 = (stack[k - 2] + p1).astype(f32)
        held[t] = p1
    n = nodes
    while n > 32:                             # shared levels
        half = n // 2
        slots = {t - half: held[t] for t in range(half, n)}
        for t in range(half):
            held[t] = (held[t] + slots[t]).astype(f32)
        if n & 1:
            held[half] = slots[half]
        n -= half
    while n > 1:                              # warp levels
        half = n // 2
        moved = {lane: held.get(lane + half) for lane in range(32)}
        for lane in range(n - half):
            held[lane] = (held[lane] + moved[lane]).astype(f32) \
                if lane < half else moved[lane]
        n -= half
    return held[0]


def rows_for(n: int) -> np.ndarray:
    """2n float32 rows over three decades of both signs, where the sums of
    two groupings round apart (over many more decades the largest rows
    alone would set them)."""
    rng = np.random.default_rng(n)
    return (rng.standard_normal((2 * n, COLS))
            * 10.0 ** rng.uniform(-1, 2, (2 * n, COLS))).astype(np.float32)


@pytest.mark.parametrize("first", list(range(1, 301, 25)))
def test_tree_matches_pairwise_sum_small(first):
    """Every N from 1 to 300 (25 a case): at most two register levels."""
    for n in range(first, first + 25):
        x = rows_for(n)
        want = pairwise_sum(torch.from_numpy(x), 0).numpy()
        np.testing.assert_array_equal(kernel_tree_sum(x).view(np.int32),
                                      want.view(np.int32), f"N = {n}")


@pytest.mark.parametrize("n", [1024, 3186, 5000, 40001])
def test_tree_matches_pairwise_sum_large(n):
    """A 2D chunk's 1,024 matches (three register levels, one on the
    stack), 3,186 and 5,000 (five and six), and 40,001 (nine, odd)."""
    x = rows_for(n)
    want = pairwise_sum(torch.from_numpy(x), 0).numpy()
    np.testing.assert_array_equal(kernel_tree_sum(x).view(np.int32),
                                  want.view(np.int32))


def test_rows_tell_groupings_apart():
    """The rows are fit to check a grouping: summed in order, or shuffled
    (each then pairs with other rows), they give other bits than
    ``pairwise_sum`` at 1,024 matches."""
    x = rows_for(1024)
    want = pairwise_sum(torch.from_numpy(x), 0).numpy()
    in_order = np.zeros(COLS, np.float32)
    for row in x:
        in_order = (in_order + row).astype(np.float32)
    assert (in_order != want).any()
    moved = x[np.random.default_rng(0).permutation(len(x))]
    assert (kernel_tree_sum(moved) != want).any()


def test_levels_of_the_kernel():
    """The register levels the kernel's host entry counts: a 2D chunk's
    1,024 matches take three (256 nodes), 5,000 six (157)."""
    assert tree_levels(2048) == ([1024, 512, 256], 256)
    halves, nodes = tree_levels(10000)
    assert (len(halves), nodes) == (6, 157)
    assert tree_levels(2) == ([], 2)
