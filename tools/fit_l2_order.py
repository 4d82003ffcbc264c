"""Read the compiled reference's L2 matcher arithmetic off, shape by shape.

Runs with the JAX package on the CPU, on the host type whose rounding the
port copies (tod_tpu_torch/ops/matching.py l2_topk and kernel L3):

    JAX_PLATFORMS=cpu python tools/fit_l2_order.py [--queries 1,2,7,100,513]
        [--widths 8,24,25,...,4096,8192] [--asm] [--quick]

For each (queries Q, chunk width N) it jits the reference's dot of the
matcher (``(Q, 128) x (N, 128)^T`` at Precision.HIGHEST, as
tod_tpu/ops/matching.py:127 runs it) on seeded normal rows and classifies
every output by the candidate order that reproduces it bit for bit:
"chain" (one fused multiply-add chain over the 128 depths), "parity" (even
and odd chains, added), "lanes" (four chains over depth mod 4, (p0 + p1)
+ (p2 + p3)) and "vector" (the one-query fusion's eight 8-lane chains in
``VECTOR_BLOCKS`` order, then its horizontal sum). It prints each shape
whose outputs are not all the kind ``l2_order`` predicts. It then holds
the norms (``square_norms``), the tile (``l2_distances_torch``) and the
whole ``l2_topk`` (every distance and row) against the jitted reference at
a few shapes, and prints the optimised HLO's distance fusion, whose
``2 * dot`` is exact (so a fused multiply-add there rounds alike).
``--asm`` disassembles (objdump) the one-query dot fusion's object code,
from which the "vector" order was read. It exits with status 1 if any
output, norm, distance or row differs.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QUERIES = (1, 2, 7, 64, 100, 513)
WIDTHS = (8, 16, 24, 25, 30, 33, 40, 49, 50, 64, 65, 100, 150, 200, 300,
          512, 1000, 1024, 2048, 4095, 4096, 8192)


def kinds_of(got: np.ndarray, q: np.ndarray, rows: np.ndarray) -> dict:
    """Share of the outputs each candidate order reproduces bit for bit."""
    import torch

    from tod_tpu_torch.ops.matching import L2_KINDS, ordered_dot

    a, b = torch.from_numpy(q)[:, None, :], torch.from_numpy(rows)[None]
    return {kind: float((ordered_dot(a, b, kind).numpy() == got).mean())
            for kind in L2_KINDS}


def survey(queries, widths) -> int:
    import jax
    import jax.numpy as jnp

    from tod_tpu_torch.ops.matching import l2_order

    @jax.jit
    def dot(q, rows):
        return jnp.dot(q, rows.T, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)

    rng = np.random.default_rng(0)
    bad = 0
    for n in widths:
        for n_q in queries:
            q = rng.standard_normal((n_q, 128)).astype(np.float32)
            rows = rng.standard_normal((n, 128)).astype(np.float32)
            share = kinds_of(np.asarray(dot(q, rows)), q, rows)
            want = l2_order(n_q, n)
            if share[want] != 1.0:
                bad += 1
                print(f"Q {n_q} x N {n}: rule {want!r}, outputs by kind "
                      f"{share}")
    print(f"surveyed {len(queries) * len(widths)} shapes (Q {queries}, "
          f"N {widths}): {bad} not in the rule's order")
    return bad


def whole(quick: bool) -> int:
    """Norms, tiles and l2_topk against the jitted reference."""
    import jax
    import jax.numpy as jnp
    import torch

    from tod_tpu.ops.matching import l2_topk as ref_topk
    from tod_tpu_torch.ops import matching as tm
    from tod_tpu_torch.ops.reduce import square_norms

    @functools.partial(jax.jit, static_argnames=("chunk",))
    def ref(q, db, n_valid, chunk):
        return ref_topk(q, db, n_valid, k=5, chunk=chunk)

    rng = np.random.default_rng(1)
    bad = 0
    x = rng.standard_normal((500, 128)).astype(np.float32)
    norms = np.asarray(jax.jit(lambda a: (a * a).sum(axis=1))(x))
    if not np.array_equal(square_norms(torch.from_numpy(x)).numpy(),
                          norms):
        bad += 1
        print("square_norms differs from XLA's reduce")
    cases = [(1, 8192, 8000, 4096), (513, 12288, 9001, 4096),
             (100, 600, 577, 100), (64, 300, 299, 150)]
    if not quick:
        cases.append((3000, 32768, 20000, 4096))
    for n_q, n, n_valid, chunk in cases:
        q = rng.random((n_q, 128)).astype(np.float32)
        db = rng.random((n, 128)).astype(np.float32)
        d, i = (np.asarray(a) for a in ref(q, db, n_valid, chunk))
        pd, pi = tm.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                            n_valid, chunk=chunk)
        same = np.array_equal(pd.numpy().view(np.int32), d.view(np.int32)) \
            and np.array_equal(pi.numpy(), i)
        bad += not same
        print(f"l2_topk Q {n_q} x {n} rows ({n_valid} valid), chunk {chunk} "
              f"({tm.l2_order(n_q, chunk)}): bit for bit {same}")
    return bad


DUMP = """
import sys
import numpy as np
import jax
sys.path.insert(0, sys.argv[1])
from tod_tpu.ops.matching import l2_topk
for n_q in (100, 1):
    jax.jit(lambda q, d: l2_topk(q, d, 4096, chunk=4096)).lower(
        np.zeros((n_q, 128), np.float32),
        np.zeros((4096, 128), np.float32)).compile()
"""


def show_fusion(asm: bool) -> None:
    """The optimised HLO's distance fusion and, with ``asm``, the object
    code of the one-query dot fusion (compiled in a child process that
    dumps XLA's artifacts)."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} "
                             f"--xla_dump_to={tmp}")
        subprocess.run([sys.executable, "-c", DUMP, ROOT], env=env,
                       check=True)
        for path in sorted(glob.glob(os.path.join(
                tmp, "*cpu_after_optimizations.txt"))):
            for line in open(path).read().splitlines():
                if re.search(r"= f32\[\d+,4096\]\S* (subtract|maximum|"
                             r"multiply)\(", line):
                    print(line.strip()[:120])
        if asm:
            for obj in sorted(glob.glob(os.path.join(tmp, "*part_00.o"))):
                out = subprocess.run(["objdump", "-d", "--no-show-raw-insn",
                                      obj], capture_output=True, text=True)
                print(*[ln for ln in out.stdout.splitlines()
                        if re.search(r"vfmadd|vaddps|vaddss|vshufpd|"
                                     r"vextractf|vmovshdup", ln)], sep="\n")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--queries", default=",".join(map(str, QUERIES)))
    p.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    p.add_argument("--asm", action="store_true")
    p.add_argument("--quick", action="store_true",
                   help="skip the graph-sized l2_topk case (~1 min)")
    args = p.parse_args()
    bad = survey([int(v) for v in args.queries.split(",")],
                 [int(v) for v in args.widths.split(",")])
    bad += whole(args.quick)
    show_fusion(args.asm)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
