"""`.ork` YAML pipeline configs: loader + builder (tod_tpu/pipeline/ork.py).

Preserves the reference's L5 config layer (SURVEY.md section 1): an ``.ork``
file names typed cells (``source1`` / ``pipeline1`` / ``sink1`` / ``voter1``),
their module, their inputs/outputs wiring and nested parameter dicts
(conf/detection.ork:17-46, conf/training.ork:2-28). Existing reference
configs load unchanged: ``module: object_recognition_tod`` resolves to the
tod_tpu_torch pipelines, and hardware source types (OpenNI / RosKinect) map
to the DatasetSource stand-in. Files are read by :mod:`ork_yaml`, which
needs no pyyaml.

Nested ``feature``/``descriptor``/``search``/``db`` parameter dicts are
re-encoded as the JSON-string params the cells declare, exactly how the
reference core CLI feeds TodTrainer/TodDetector.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from tod_tpu_torch.pipeline import ork_yaml
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.plasm import Plasm
from tod_tpu_torch.utils.config import dump_json_params

# (module, type) -> cell class resolver; late imports to avoid cycles.


def _registry() -> Dict[Tuple[str, str], Any]:
    from tod_tpu_torch.cells.io import Aggregator, DatasetSource, Publisher
    from tod_tpu_torch.models.detector import TodDetector
    from tod_tpu_torch.models.trainer import TodTrainer

    reg: Dict[Tuple[str, str], Any] = {}

    def add(type_name: str, cls, modules: List[str]):
        for m in modules:
            reg[(m, type_name)] = cls

    tod_modules = ["object_recognition_tod", "tod_tpu", "tod_tpu_torch", ""]
    add("TodDetector", TodDetector, tod_modules)
    add("TodTrainer", TodTrainer, tod_modules)
    src_modules = ["object_recognition_core.io.source",
                   "object_recognition_ros.io", "tod_tpu.io",
                   "tod_tpu_torch.io", ""]
    add("OpenNI", DatasetSource, src_modules)
    add("RosKinect", DatasetSource, src_modules)
    add("DatasetSource", DatasetSource, src_modules)
    add("Publisher", Publisher, ["object_recognition_ros.io", "tod_tpu.io",
                                 "tod_tpu_torch.io", ""])
    add("Aggregator", Aggregator,
        ["object_recognition_core.io", "tod_tpu.io", "tod_tpu_torch.io", ""])
    return reg


def load_ork(path: str) -> Dict[str, dict]:
    """Parse an .ork file into {cell_name: spec dict}."""
    doc = ork_yaml.load_file(path)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a mapping of cell specs")
    return doc


# Parameters that TodTrainer/TodDetector receive as JSON strings (the
# reference packs nested dicts into json params, detector.py:49-54).
_JSON_PARAM_KEYS = {
    "feature": "json_feature_params",
    "descriptor": "json_descriptor_params",
    "search": "search",
    "db": "json_db",
    "object_ids": "json_object_ids",
}


def _adapt_parameters(cell_type: str, parameters: Dict[str, Any]) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for key, value in (parameters or {}).items():
        if cell_type == "TodTrainer" and key in ("search", "object_ids"):
            # consumed by the training CLI (object iteration / LSH metadata),
            # not by the TodTrainer blackbox itself — same as the reference,
            # where the core `ork training` CLI reads them (conf/training.ork)
            continue
        if cell_type in ("TodTrainer", "TodDetector") and key in _JSON_PARAM_KEYS:
            out_key = _JSON_PARAM_KEYS[key]
            if isinstance(value, (dict, list)):
                params[out_key] = dump_json_params(value) \
                    if isinstance(value, dict) else json.dumps(value)
            else:
                params[out_key] = value
        else:
            params[key] = value
    return params


def instantiate_cell(name: str, spec: Dict[str, Any]) -> Cell:
    cell_type = spec.get("type")
    module = spec.get("module", "") or ""
    reg = _registry()
    cls = reg.get((module, cell_type)) or reg.get(("", cell_type))
    if cls is None:
        raise ValueError(f"{name}: unknown cell type {module}.{cell_type}")
    params = _adapt_parameters(cell_type, spec.get("parameters", {}))
    return cls(name, **params)


class OrkPipeline:
    """An instantiated .ork graph: cells + a wired plasm."""

    def __init__(self, cells: Dict[str, Cell], plasm: Plasm,
                 specs: Dict[str, dict]):
        self.cells = cells
        self.plasm = plasm
        self.specs = specs

    def execute(self, niter: int = 1) -> None:
        self.plasm.execute(niter)


def _wire(plasm: Plasm, src: Cell, dst: Cell) -> None:
    """Connect by port-name intersection (how the core CLI wires source ->
    pipeline -> sink: matching tendril names are plugged together)."""
    common = [k for k in src.outputs.keys() if k in dst.inputs]
    for port in common:
        plasm.connect(src[port] >> dst[port])


def build_pipeline_from_ork(path: str,
                            overrides: Optional[Dict[str, Dict]] = None
                            ) -> OrkPipeline:
    """Instantiate every cell in the .ork and wire inputs/outputs.

    ``overrides``: {cell_name: extra parameters} — e.g. point source1 at a
    dataset directory, or redirect db params at a test DB.
    """
    specs = load_ork(path)
    overrides = overrides or {}
    cells: Dict[str, Cell] = {}
    for name, spec in specs.items():
        spec = dict(spec)
        if name in overrides:
            spec["parameters"] = {**(spec.get("parameters") or {}),
                                  **overrides[name]}
        cells[name] = instantiate_cell(name, spec)

    plasm = Plasm()
    for cell in cells.values():
        plasm.insert(cell)
    for name, spec in specs.items():
        for upstream in (spec.get("inputs") or []):
            if upstream in cells:
                _wire(plasm, cells[upstream], cells[name])
        for downstream in (spec.get("outputs") or []):
            if downstream in cells:
                _wire(plasm, cells[name], cells[downstream])
    return OrkPipeline(cells, plasm, specs)
