#!/usr/bin/env python
"""Write tests/data/torch_small_sizes_fixture.npz, the small frame sizes'
references that chip_smoke.py phase 13c holds the port to.

Runs with the JAX package on the CPU (about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_small_sizes_fixture.py

The file holds SHA-256 digests (``tod_tpu_torch/utils/camera_sizes.py``
``digest``), not arrays:

- ``frames_json``: for each small frame size whose pyramid needs the depth
  splits and kernel tails of ``tod_tpu_torch/ops/image.py`` (``SMALL``,
  QQVGA 160x120 and QCIF 176x144 first), the reference's 8-level pyramid
  (scale 1.2; the 3-level pyramid's levels are its first three) of the
  seeded random frame that ``small_frame`` makes, and of three such frames
  in one vmapped program (``batch3``: each frame's levels);
- ``scenes_json``: at QQVGA and QCIF, bench objects 0 and 1 rendered at
  that size (``size_scene``), the frame's image and depth, and the
  reference's ORB (5000 features) at ``ORB_LEVELS`` (3 and 6) levels on
  its serving gray (valid, xy, level, descriptors, in slot order; at 8 levels
  QQVGA's last level, 45x33, is narrower than the reference's 37-pixel
  patch, which it refuses).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tod_tpu_torch.utils.camera_sizes import (  # noqa: E402
    SMALL, SMALL_SCENES, digest, size_scene, small_frame)

LEVELS = 8
SCALE = 1.2
ORB_LEVELS = (3, 6)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_small_sizes_fixture.npz"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tod_tpu.ops import image as jimage
    from tod_tpu.ops import orb as jorb
    from tod_tpu.ops.image import rgb_to_gray
    from tod_tpu.utils import synthetic as syn

    pyramid = jax.jit(lambda x: jimage.build_pyramid(x, LEVELS, SCALE))
    frames = {}
    for h, w in SMALL:
        levels = pyramid(jnp.asarray(small_frame(h, w)))
        batch = np.stack([small_frame(h, w, k) for k in range(3)])
        batched = jax.jit(jax.vmap(lambda x: jimage.build_pyramid(
            x, LEVELS, SCALE)))(jnp.asarray(batch))
        frames[f"{h}x{w}"] = {
            "levels": [digest(np.asarray(a)) for a in levels],
            "batch3": [[digest(np.asarray(a)[k]) for a in batched]
                       for k in range(3)]}
    scenes = {}
    for h, w in SMALL_SCENES:
        image, depth = size_scene(syn, h, w)
        g = rgb_to_gray(jnp.asarray(image))
        entry = {"image": digest(image), "depth": digest(depth)}
        for n in ORB_LEVELS:
            k, d = jax.jit(lambda x, n=n: jorb.orb_detect_and_compute(
                x, n_features=5000, n_levels=n, scale_factor=SCALE))(g)
            entry[f"orb{n}"] = {
                **{name: digest(np.asarray(getattr(k, name)), name)
                   for name in ("valid", "xy", "level")},
                "desc": digest(np.asarray(d), "desc"),
                "n_valid": int(np.asarray(k.valid).sum())}
        scenes[f"{h}x{w}"] = entry
        print(f"{h}x{w}: ORB valid " + ", ".join(
            f"{entry[f'orb{n}']['n_valid']} at {n} levels"
            for n in ORB_LEVELS), flush=True)
    np.savez(args.out, frames_json=json.dumps(frames),
             scenes_json=json.dumps(scenes))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
