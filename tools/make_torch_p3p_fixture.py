"""Write tests/data/torch_p3p_fixture.npz: the reference's P3P, solves,
normals and refinements at the shapes of kernels P1, P2 and M2, for
chip_smoke.py phase 3k to hold the card against.

Runs with the JAX package on the CPU (the host type of
tests/test_torch_premise.py), in about a minute:

    JAX_PLATFORMS=cpu python tools/make_torch_p3p_fixture.py [--out PATH]

It holds (float32 unless said otherwise):

- ``lu3_M`` (2000, 3, 3), ``lu3_F`` (2000, 3), ``lu3_x``:
  ``jax.jit(jax.vmap(jnp.linalg.solve))`` of random systems, every
  seventh with a zero leading entry, every eleventh of small integers
  (pivot ties, some singular);
- ``lu6_M`` (1000, 6, 6) normal-equation matrices ``J^T J + 1e-6 I``,
  ``lu6_F``, ``lu6_x``;
- ``cov`` (N, 3, 3) and ``normal`` (N, 3): ``jnp.linalg.eigh``'s column 0
  (sign included) of chip_smoke.mirror_cases' covariances (seed 37, both
  of its shapes), 512 planar ones and 64 at each of six scales;
- ``p3p_seed``, ``p3p_n`` (int): chip_smoke.p3p_samples' inputs (16,384
  samples, kernel P1's shape), ``p3p_in_sha256`` (their bytes),
  ``p3p_{R,T,valid}_sha256`` of ``jax.jit(jax.vmap(p3p))``'s outputs, and
  ``p3p_{R,T,valid}_head`` those of the first 256 samples;
- ``p2_shapes`` (int, 2 x 3): chip_smoke.p2_cases' first two shapes
  (32 x 16 x 1,024 and 2 x 8 x 5,000), ``p2_{R,T}_sha256`` of the
  reference's refinement (5 iterations) of each, ``p2_{R,T}_head{k}`` its
  first object's poses.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

OUT = os.path.join(ROOT, "tests", "data", "torch_p3p_fixture.npz")
P3P_SEED = 19
HEAD = 256


def sha(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke
    import fit_lapack_order
    from tod_tpu.geometry import pnp as rp

    f32 = np.float32
    out = {}
    solve = jax.jit(jax.vmap(lambda a, b: jnp.linalg.solve(a, b[:, None])[:, 0]))
    rng = np.random.default_rng(3)
    M = rng.standard_normal((2000, 3, 3)).astype(f32)
    M[::7, 0, 0] = 0.0
    M[::11] = rng.integers(-2, 3, (len(M[::11]), 3, 3))
    F = rng.standard_normal((2000, 3)).astype(f32)
    out.update(lu3_M=M, lu3_F=F, lu3_x=np.asarray(solve(M, F)))
    M6, F6 = fit_lapack_order.normal_matrices(6, 1000, 6)
    out.update(lu6_M=M6, lu6_F=F6, lu6_x=np.asarray(solve(M6, F6)))

    covs = [chip_smoke.mirror_cases(np.random.default_rng(37), *shape)[3]
            .numpy() for shape in chip_smoke.MIRROR_SHAPES]
    covs.append(fit_lapack_order.covariances(512, 5))
    for scale in (1e-30, 1e-20, 1e-5, 1.0, 1e18, 1e30):
        a = (rng.standard_normal((64, 3, 3)) * scale).astype(f32)
        covs.append((a + a.transpose(0, 2, 1)).astype(f32))
    cov = np.concatenate(covs).astype(f32)
    out.update(cov=cov, normal=np.asarray(
        jax.jit(jax.vmap(jnp.linalg.eigh))(cov)[1])[:, :, 0])

    n = chip_smoke.P1_SAMPLES
    bear, pts = chip_smoke.p3p_samples(np.random.default_rng(P3P_SEED), n)
    ref = jax.jit(jax.vmap(rp.p3p))(jnp.asarray(bear), jnp.asarray(pts))
    out.update(p3p_seed=np.int32(P3P_SEED), p3p_n=np.int32(n),
               p3p_in_sha256=sha(np.concatenate([bear, pts])))
    for name, x in zip(("R", "T", "valid"), ref):
        x = np.asarray(x)
        out[f"p3p_{name}_sha256"] = sha(x)
        out[f"p3p_{name}_head"] = x[:HEAD]

    gn = jax.jit(jax.vmap(jax.vmap(rp.gauss_newton_pose,
                                   (0, 0, None, None, None, 0)),
                          (0, 0, None, 0, 0, 0)))
    shapes = []
    for k, (shape, host) in enumerate(chip_smoke.p2_cases()):
        if k == 2:
            break
        R0, T0, K, X, uv, w = (t.numpy() for t in host)
        R, T = (np.asarray(x) for x in gn(R0, T0, K, X[:, 0], uv[:, 0], w))
        shapes.append(shape)
        out[f"p2_R_sha256{k}"], out[f"p2_T_sha256{k}"] = sha(R), sha(T)
        out[f"p2_R_head{k}"], out[f"p2_T_head{k}"] = R[0], T[0]
    out["p2_shapes"] = np.array(shapes, np.int32)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
