"""Sharding over a ('data', 'db') mesh of devices (tod_tpu/parallel).

The names load on first use: ``cells/trainer.py`` imports
``parallel.train``, and the serving modules import ``models``, which
import the cells."""

import importlib

_HOMES = {
    "Mesh": "mesh", "make_mesh": "mesh",
    "sharded_hamming_topk": "matching", "ring_hamming_topk": "matching",
    "pack_segmented_sharded": "segmented",
    "pack_segmented_l2_sharded": "segmented",
    "stacked_max_chunks": "segmented", "sharded_object_top1": "segmented",
    "serving_step_sharded": "segmented",
    "ShardedServingDetector": "serving",
    "detect_batch_sharded": "detect",
    "train_views_sharded": "train",
    "PipelinedDetector": "pipeline",
    "dryrun_multichip": "dryrun",
}

__all__ = list(_HOMES)


def __getattr__(name: str):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOMES[name]}"),
                   name)
