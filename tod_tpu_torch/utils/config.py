"""Config helpers, copied from tod_tpu/utils/config.py (json only).

The ``.ork`` YAML schema is handled by :mod:`tod_tpu_torch.pipeline.ork`;
nested structured params passed as JSON strings (reference:
``search_json_params``, src/detection/DescriptorMatcher.cpp:160-187) are
parsed here; and ``merge_dict`` mirrors
python/object_recognition_tod/__init__.py:5-17.
"""

from __future__ import annotations

import json
from collections.abc import Mapping
from typing import Any


def merge_dict(a: Mapping, b: Mapping) -> dict:
    """Recursively merge two dicts, preferring values from ``a``.

    Same contract as the reference's ``merge_dict``
    (python/object_recognition_tod/__init__.py:5-17): keys present in both are
    merged recursively when both values are mappings, otherwise ``a`` wins.
    """
    c = dict(a)
    for key, val in b.items():
        if key in a:
            if isinstance(val, Mapping) and isinstance(a[key], Mapping):
                c[key] = merge_dict(a[key], val)
            # otherwise a is preferred, as done with the initial copy
        else:
            c[key] = val
    return c


def parse_json_params(params: Any) -> dict:
    """Parse a JSON-string parameter into a dict; pass dicts through.

    The reference passes nested params as JSON strings and parses them in-cell
    with json_spirit (src/detection/DescriptorMatcher.cpp:160-168,
    src/training/Trainer.cpp:88-103). We accept either a JSON string or an
    already-structured mapping.
    """
    if params is None:
        return {}
    if isinstance(params, Mapping):
        return dict(params)
    if isinstance(params, (bytes, bytearray)):
        params = params.decode("utf-8")
    if isinstance(params, str):
        params = params.strip()
        if not params:
            return {}
        return json.loads(params)
    raise TypeError(f"cannot parse params of type {type(params)!r}")


def dump_json_params(params: Mapping) -> str:
    """Serialize a param dict to the JSON-string form used across cell boundaries."""
    return json.dumps(dict(params), sort_keys=True)
