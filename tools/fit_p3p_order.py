"""Read the compiled reference's P3P arithmetic off, stage by stage.

Runs with the JAX package on the CPU, on the host type whose rounding the
port copies (tod_tpu_torch/geometry/pnp.py p3p_distances_torch and kernel
P1, csrc/p3p.cu):

    JAX_PLATFORMS=cpu python tools/fit_p3p_order.py [--samples 20000]
        [--no-fusions]

1. The fusions: it compiles ``jax.jit(jax.vmap(tod_tpu.geometry.pnp.p3p))``
   in a child process that dumps XLA's artifacts, and prints every fusion
   of the optimised HLO outside the fused computations (the entry and the
   Newton steps' loop), in order, with the multiplies, adds and subtracts
   of its HLO and the fused multiply-adds (``vfmadd``/``vfmsub``/
   ``vfnmadd``/``vfnmsub``) in its object code. Each fusion recomputes what
   it inlines (the Newton polishes recompute the quartic's coefficients
   from the side ratios and cosines), each with LLVM's own contractions.
2. The stages, on seeded well-posed samples:
   - the side lengths: ``jnp.linalg.norm`` as compiled (a reduce whose
     object code is one FMA chain from the first square) against the
     port's ``pnp._side`` bit for bit, and against the unfused
     ``sqrt((d0 d0 + d1 d1) + d2 d2)``;
   - the cosines: ``jnp.dot`` against ``transforms.dot3`` bit for bit;
   - the coefficients: the reference's normalised coefficients ``C3/C4 ..
     C0/C4`` (its expressions jitted on their own compile to four fusions
     of 24, 12, 12 and 12 multiply-add instructions, as in the whole P3P)
     against ``pnp.quartic_coefficients`` (unfused), and against LLVM's
     contraction rule emulated for ``C0/C4`` (a product with one use folds
     into the add or subtract that takes it, the left operand first when
     both could): the rule gives the compiled bits.
It exits with status 1 if a side or a cosine differs, or the emulated
``C0/C4`` does.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DUMP = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax
import jax.numpy as jnp
from tod_tpu.geometry import pnp
rng = np.random.default_rng(0)
rays = rng.standard_normal((64, 3, 3)).astype(np.float32)
rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
pts = (rng.standard_normal((64, 3, 3)) + [0, 0, 2]).astype(np.float32)
jax.jit(jax.vmap(pnp.p3p))(jnp.asarray(rays), jnp.asarray(pts))
"""

FMA = re.compile(r"\bvf(n)?m(add|sub)\w*")


def fusion_table() -> list:
    """``(computation, fusion, HLO multiplies, adds + subtracts, FMA
    instructions)`` for every fusion of the compiled P3P outside the fused
    computations, in the dump's order."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} "
                             f"--xla_dump_to={tmp}")
        subprocess.run([sys.executable, "-c", DUMP, ROOT], env=env,
                       check=True)
        hlo = open(glob.glob(os.path.join(
            tmp, "*jit_p3p.cpu_after_optimizations.txt"))[0]).read()
        bodies = dict(re.findall(r"^%(\S+) [^\n]*\{\n(.*?)^\}", hlo,
                                 re.S | re.M))
        rows, comp = [], None
        for line in hlo.splitlines():
            head = re.match(r"^(?:ENTRY )?%(\S+) .*\{$", line)
            if head:
                comp = head.group(1)
                continue
            m = re.match(r"\s*(?:ROOT )?%(\S+) = .* fusion\(.*calls=%([\w.]+)",
                         line)
            if not m or comp is None or comp.startswith("fused_"):
                continue
            name, called = m.groups()
            body = bodies.get(called, "")
            muls = len(re.findall(r" multiply\(", body))
            adds = len(re.findall(r" (?:add|subtract)\(", body))
            obj = glob.glob(os.path.join(
                tmp, f"*obj-file.{name}_kernel_module.o"))
            fmas = 0
            if obj:
                asm = subprocess.run(["objdump", "-d", "--no-show-raw-insn",
                                      obj[0]], capture_output=True,
                                     text=True).stdout
                fmas = len(FMA.findall(asm))
            rows.append((comp, name, muls, adds, fmas))
    return rows


def samples(n: int, seed: int = 0):
    """``n`` well-posed P3P samples: (bearings (n, 3, 3), points (n, 3,
    3)) float32, the points of a small flat patch seen from 0.9 m."""
    rng = np.random.default_rng(seed)
    K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    bear, pts = [], []
    for _ in range(n):
        ax = rng.uniform(-0.4, 0.4, 3)
        th = np.linalg.norm(ax)
        k = ax / th
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        T = np.array([*rng.uniform(-0.15, 0.15, 2), 0.9])
        X = rng.uniform(-0.12, 0.12, (3, 3))
        X[:, 2] *= 0.1
        uv = (X @ R.T + T) @ K.T
        b = np.concatenate([(uv[:, :2] / uv[:, 2:3] - K[:2, 2])
                            / np.diag(K)[:2], np.ones((3, 1))], 1)
        bear.append(b / np.linalg.norm(b, axis=1, keepdims=True))
        pts.append(X)
    return (np.asarray(bear, np.float32), np.asarray(pts, np.float32))


def reference_stages(bear: np.ndarray, pts: np.ndarray):
    """The reference's sides, cosines (tod_tpu/geometry/pnp.py:135-140)
    and normalised quartic coefficients (:144-164, then solve_quartic's
    first lines, :50-53), each jitted over the samples."""
    import jax
    import jax.numpy as jnp

    def sides(b, p):
        return (jnp.linalg.norm(p[1] - p[2]), jnp.linalg.norm(p[0] - p[2]),
                jnp.linalg.norm(p[0] - p[1]), jnp.dot(b[1], b[2]),
                jnp.dot(b[0], b[2]), jnp.dot(b[0], b[1]))

    def coefficients(b, p):
        a, b_, c, ca, cb, cg = sides(b, p)
        a2, b2, c2 = a * a, b_ * b_, c * c
        Ar = a2 / b2
        Br = c2 / b2
        C4 = (Ar * Ar - 2 * Ar * Br - 2 * Ar + Br * Br
              - 4 * Br * ca * ca + 2 * Br + 1)
        C3 = (-4 * Ar * Ar * cb + 8 * Ar * Br * cb + 4 * Ar * ca * cg
              + 4 * Ar * cb - 4 * Br * Br * cb + 8 * Br * ca * ca * cb
              + 4 * Br * ca * cg - 4 * Br * cb - 4 * ca * cg)
        C2 = (4 * Ar * Ar * cb * cb + 2 * Ar * Ar - 8 * Ar * Br * cb * cb
              - 4 * Ar * Br - 8 * Ar * ca * cb * cg - 4 * Ar * cg * cg
              + 4 * Br * Br * cb * cb + 2 * Br * Br - 4 * Br * ca * ca
              - 8 * Br * ca * cb * cg + 4 * ca * ca + 4 * cg * cg - 2)
        C1 = (-4 * Ar * Ar * cb + 8 * Ar * Br * cb + 4 * Ar * ca * cg
              + 8 * Ar * cb * cg * cg - 4 * Ar * cb - 4 * Br * Br * cb
              + 4 * Br * ca * cg + 4 * Br * cb - 4 * ca * cg)
        C0 = (Ar * Ar - 2 * Ar * Br - 4 * Ar * cg * cg + 2 * Ar
              + Br * Br - 2 * Br + 1)
        return C3 / C4, C2 / C4, C1 / C4, C0 / C4

    got = jax.jit(jax.vmap(sides))(bear, pts)
    coef = jax.jit(jax.vmap(coefficients))(bear, pts)
    return [np.asarray(x) for x in got], [np.asarray(x) for x in coef]


def port_stages(bear: np.ndarray, pts: np.ndarray):
    """The port's sides (``pnp._side``), the unfused norms, the cosines,
    the normalised coefficients of ``pnp.quartic_coefficients``, and
    ``C0/C4`` under LLVM's contraction rule."""
    import torch

    from tod_tpu_torch.geometry import pnp
    from tod_tpu_torch.geometry.transforms import dot3
    from tod_tpu_torch.ops.image import fma_f32

    b, p = torch.from_numpy(bear), torch.from_numpy(pts)
    pairs = ((1, 2), (0, 2), (0, 1))
    sides = [pnp._side(p[:, i], p[:, j]) for i, j in pairs]
    unfused = [pnp._norm(p[:, i] - p[:, j]) for i, j in pairs]
    cos = [dot3(b[:, i], b[:, j]) for i, j in pairs]
    a, b_, c = sides
    ca, cb, cg = cos
    Ar, Br = (a * a) / (b_ * b_), (c * c) / (b_ * b_)
    C4, C3, C2, C1, C0 = pnp.quartic_coefficients(Ar, Br, ca, cb, cg)
    coef = [C3 / C4, C2 / C4, C1 / C4, C0 / C4]
    # C0 / C4 as its fusion contracts it: Ar Ar - 2 Ar Br takes the left
    # product, each single-use 4 x y y term folds into its subtraction;
    # Br Br (two uses) and the doublings (x + x) stay apart
    r18 = fma_f32(Ar, Ar, -((2 * Ar) * Br))
    num = (((2 * Ar) + fma_f32(-cg, (4 * Ar) * cg, r18)) + Br * Br) \
        - 2 * Br + 1
    den = ((2 * Br) + fma_f32(-ca, (4 * Br) * ca, Br * Br + (r18 - 2 * Ar))) \
        + 1
    return ([t.numpy() for t in sides + cos], [t.numpy() for t in unfused],
            [t.numpy() for t in coef], (num / den).numpy())


def off(x: np.ndarray, y: np.ndarray) -> int:
    return int((x.view(np.int32) != y.view(np.int32)).sum())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=20000)
    p.add_argument("--no-fusions", action="store_true")
    args = p.parse_args()
    if not args.no_fusions:
        rows = fusion_table()
        for comp, name, muls, adds, fmas in rows:
            print(f"fusion {comp:<24} {name:<34} HLO mul {muls:3d} add/sub "
                  f"{adds:3d}  FMA instructions {fmas:4d}")
        print(f"fusions: {len(rows)}, {sum(r[4] > 0 for r in rows)} with "
              f"multiply-adds, {sum(r[4] for r in rows)} FMA instructions")
    bear, pts = samples(args.samples)
    ref_sides, ref_coef = reference_stages(bear, pts)
    mine, unfused, coef, c0_rule = port_stages(bear, pts)
    names = ("a", "b", "c", "cos_a", "cos_b", "cos_g")
    side_off = [off(m, r) for m, r in zip(mine, ref_sides)]
    print(f"sides and cosines off the reference's ({args.samples} samples): "
          + ", ".join(f"{n} {k}" for n, k in zip(names, side_off))
          + "; the unfused norms: "
          + ", ".join(f"{n} {off(u, r)}"
                      for n, u, r in zip(names, unfused, ref_sides)))
    coef_off = [off(m, r) for m, r in zip(coef, ref_coef)]
    rule_off = off(c0_rule, ref_coef[3])
    print("coefficients C3/C4, C2/C4, C1/C4, C0/C4 off the reference's "
          f"(unfused): {coef_off}; C0/C4 under LLVM's contraction rule: "
          f"{rule_off}")
    return 1 if any(side_off) or rule_off else 0


if __name__ == "__main__":
    sys.exit(main())
