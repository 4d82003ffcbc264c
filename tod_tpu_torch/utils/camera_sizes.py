"""The scenes and digests that hold the port to the reference at camera sizes
other than VGA.

One definition for the fixture generator (tools/make_torch_sizes_fixture.py,
with the reference), the CPU tests (tests/test_torch_sizes*.py) and the smoke
run on the GPU (chip_smoke.py phase 13): the digests only hold while they
all render and hash alike. Numpy only; a renderer module is passed in,
``tod_tpu_torch.utils.synthetic`` or the reference's, which render the same
pixels.

The sizes are those of the cameras the reference's users run: 320x240 and
1280x1024 (Kinect v1, Xtion), 848x480 and 1280x720 (RealSense D4xx),
1920x1080 (Kinect v2), and VGA; and the small frames whose pyramids take
Eigen's depth splits and oneDNN's kernel tails (``SMALL``: QQVGA 160x120,
QCIF 176x144 of time-of-flight cameras such as the SwissRanger SR4000, and
seven other sizes of 100 to 267 columns; tools/make_torch_small_sizes_
fixture.py, chip_smoke.py phase 13c).
"""

from __future__ import annotations

import hashlib

import numpy as np

GRID = ((240, 320), (480, 640), (480, 848), (720, 1280), (960, 1280),
        (1080, 1920))
# the main path's second camera: 1280x720 with VGA's focal length doubled,
# centred
HW720 = (720, 1280)
K720 = np.array([[1050.0, 0.0, 639.5], [0.0, 1050.0, 359.5],
                 [0.0, 0.0, 1.0]])
# small frames (rows, columns): QQVGA and QCIF first, then the other sizes
# whose pyramids split a product's depth or end a kernel in a tail
SMALL = ((160, 120), (176, 144), (144, 176), (135, 240), (150, 200),
         (100, 100), (120, 213), (150, 267), (166, 221))
SMALL_SCENES = SMALL[:2]       # rendered and run through ORB as well
# each array as the digest reads it, whatever dtype a package keeps it in
KINDS = {"valid": bool, "ok": bool, "xy": np.float32, "qp": np.float32,
         "level": np.int32, "desc": np.uint8, "dsc": np.uint8}


def size_camera(h: int, w: int) -> np.ndarray:
    """VGA's focal length (525) scaled with the width, centred."""
    f = 525.0 * w / 640
    return np.array([[f, 0.0, (w - 1) / 2], [0.0, f, (h - 1) / 2],
                     [0.0, 0.0, 1.0]])


def bench_object(syn, i: int):
    """bench.py make_obj (BENCH_SHAPES=mixed, bench.py:120-138): a plane,
    a box and a cylinder in turn."""
    oid = f"obj{i:03d}"
    if i % 3 == 0:
        return syn.SyntheticObject.make(oid, seed=100 + i)
    if i % 3 == 1:
        return syn.SyntheticBox.make(oid, seed=100 + i,
                                     size_m=(0.2, 0.15, 0.1))
    return syn.SyntheticCylinder.make(oid, seed=100 + i, radius_m=0.08,
                                      height_m=0.2)


def bench_placements(syn, objects, n_scenes: int):
    """bench.py build_scenes (clean): three objects a scene at z 0.75,
    0.9 and 1.05, x -0.22, 0.02 and 0.24, poses from rng 7; ``[(trio,
    [(R, T)])]`` a scene."""
    rng = np.random.default_rng(7)
    out = []
    for s in range(n_scenes):
        trio = [objects[(3 * s + j) % len(objects)] for j in range(3)]
        poses = [syn.facing_pose(rng, z=z)
                 if isinstance(o, syn.SyntheticObject)
                 else syn.presenting_pose(rng, z=z)
                 for o, z in zip(trio, (0.75, 0.9, 1.05))]
        for (_, T), x in zip(poses, (-0.22, 0.02, 0.24)):
            T[0] = x
        out.append((trio, poses))
    return out


def bench_scenes(syn, objects, n_scenes: int, hw=(480, 640), K=None):
    """:func:`bench_placements`' scenes rendered in frames of ``hw``
    through ``K`` (default the renderer's VGA camera); ``[(image,
    depth)]``."""
    return [syn.compose_scene(trio, poses, hw=hw,
                              K=syn.DEFAULT_K if K is None else K)
            for trio, poses in bench_placements(syn, objects, n_scenes)]


def small_frame(h: int, w: int, k: int = 0) -> np.ndarray:
    """A seeded random gray frame of (h, w) in [0, 255) (the k-th of a
    batch), float32."""
    rng = np.random.default_rng(h * 1000 + w + 7919 * k)
    return (rng.random((h, w)) * 255).astype(np.float32)


def size_scene(syn, h: int, w: int):
    """Bench objects 0 (a plane) and 1 (a box) at z 0.8 and 1.0, x -0.1
    and 0.12 (poses from rng 7), in a frame of (h, w) through
    :func:`size_camera`; (image, depth)."""
    objects = [bench_object(syn, 0), bench_object(syn, 1)]
    rng = np.random.default_rng(7)
    poses = [syn.facing_pose(rng, z=0.8), syn.presenting_pose(rng, z=1.0)]
    poses[0][1][0], poses[1][1][0] = -0.1, 0.12
    return syn.compose_scene(objects, poses, hw=(h, w), K=size_camera(h, w))


def views_720p(syn, obj):
    """The 720p capture plan: two rings of 12 views at 65 and 40 degrees
    through :data:`K720`, by frame number."""
    views = syn.turntable_observations(obj, n_views=12,
                                       elevations_deg=(65.0, 40.0), hw=HW720,
                                       K=K720)
    return sorted(views, key=lambda o: o["frame_number"])


def digest(array, kind: str = None) -> str:
    """SHA-256 of an array's dtype and shape, then its bytes; ``kind``
    names the dtype (:data:`KINDS`) it is read in first."""
    a = np.ascontiguousarray(array if kind is None else
                             np.asarray(array, KINDS[kind]))
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def rows_digest(xy, qp, dsc, ok) -> str:
    """The valid compacted queries as a multiset: each row's (xy, 3D point,
    descriptor) bytes, sorted."""
    xy, qp, dsc, ok = (np.asarray(a, KINDS[k]) for a, k in
                       ((xy, "xy"), (qp, "qp"), (dsc, "dsc"), (ok, "ok")))
    keys = sorted(a.tobytes() + b.tobytes() + c.tobytes()
                  for a, b, c in zip(xy[ok], qp[ok], dsc[ok]))
    return hashlib.sha256(b"".join(keys)).hexdigest()
