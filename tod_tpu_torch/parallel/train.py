"""The training step over a batch of turntable views
(tod_tpu/parallel/train.py): per view, keypoints and descriptors on the
masked view, validation against the eroded mask and the depth,
back-projection and camera -> world. The feature ops take one image, so the
views run one after another on a device; :func:`train_views_sharded` splits
the views over a mesh's ``'data'`` axis.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from tod_tpu_torch.geometry.transforms import camera_to_world
from tod_tpu_torch.ops.depth import depth_to_3d_sparse
from tod_tpu_torch.ops.morphology import validate_keypoints
from tod_tpu_torch.ops.orb import orb_detect_and_compute
from tod_tpu_torch.ops.sift import sift_detect_and_compute
from tod_tpu_torch.parallel.mesh import Mesh, all_gather, split_even


def subpixel_coords(snapped: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The sub-pixel fraction of the keypoints ``xy`` kept on top of their
    mask-snapped integer pixels: ``snapped + (xy - round(xy))``, rounding
    half to even as ``jnp.round`` does (depth is still read at the integer
    pixel, :func:`depth_to_3d_sparse` rounds)."""
    return snapped + (xy - torch.round(xy))


def train_views_step(grays: torch.Tensor, masks: torch.Tensor,
                     depths_m: torch.Tensor, Ks: torch.Tensor,
                     Rs: torch.Tensor, Ts: torch.Tensor,
                     n_features: int = 1000, n_levels: int = 3,
                     scale_factor: float = 1.2,
                     fast_threshold: float = 20.0,
                     feature_type: str = "ORB", subpixel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V,H,W) grays, masks and metric depths with (V,3,3) K and R and
    (V,3) T -> (V,K,D) descriptors (uint8 ORB bits or float32 SIFT), (V,K,3)
    world points and (V,K) valid, on the tensors' device. ``subpixel``
    (ORB only; SIFT keeps integer coords, as in the reference) refines the
    keypoints and back-projects each model point through
    :func:`subpixel_coords`."""
    sub = subpixel and feature_type != "SIFT"
    descs, worlds, valids = [], [], []
    for gray, mask, depth_m, K, R, T in zip(grays, masks, depths_m, Ks, Rs,
                                            Ts):
        settings = dict(n_features=n_features, n_levels=n_levels,
                        scale_factor=scale_factor,
                        fast_threshold=fast_threshold, mask=mask)
        if feature_type == "SIFT":
            kps, desc = sift_detect_and_compute(gray, **settings)
        else:
            kps, desc = orb_detect_and_compute(gray, subpixel=sub, **settings)
        val = validate_keypoints(kps.xy, kps.valid, mask, depth_m)
        coords = val.xy.to(torch.float32)
        if sub:
            coords = subpixel_coords(coords, kps.xy)
        cam = depth_to_3d_sparse(depth_m, K, coords)
        descs.append(desc)
        worlds.append(camera_to_world(R, T, cam, views=len(grays)))
        valids.append(val.valid)
    return torch.stack(descs), torch.stack(worlds), torch.stack(valids)


def train_views_sharded(mesh: Mesh, n_features: int = 1000,
                        n_levels: int = 3, scale_factor: float = 1.2,
                        subpixel: bool = False, **settings):
    """The training step with the view batch split over ``'data'``:
    returns ``fn(grays, masks, depths_m, Ks, Rs, Ts)``. V must divide by
    the data axis; data row ``i`` runs :func:`train_views_step` on its
    views on its first device, and the outputs come back concatenated in
    view order on the mesh's first device. ``settings`` are the step's
    other keywords (``fast_threshold``, ``feature_type``)."""
    return functools.partial(_train_sharded, mesh, dict(
        n_features=n_features, n_levels=n_levels, scale_factor=scale_factor,
        subpixel=subpixel, **settings))


def _train_sharded(mesh: Mesh, settings: dict, *views: torch.Tensor):
    per = split_even(views[0].shape[0], mesh.shape["data"], "views over "
                     "'data'")
    outs = []
    for i in range(mesh.shape["data"]):
        dev = mesh.device(i, 0)
        outs.append(train_views_step(
            *(v[i * per:(i + 1) * per].to(dev, non_blocking=True)
              for v in views), **settings))
    return tuple(all_gather(list(f), mesh.first) for f in zip(*outs))
