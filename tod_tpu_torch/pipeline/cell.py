"""Cells: processing nodes with declared params/inputs/outputs (a copy of
tod_tpu/pipeline/cell.py).

The ecto-cell protocol: a Cell declares its
tendrils via class methods (``declare_params`` / ``declare_io``, the protocol
every reference cell implements, e.g. src/detection/DescriptorMatcher.cpp:
131-152), is configured once, and is then ``process()``-ed per scheduler
iteration. Indexing a cell (``cell['out'] >> other['in']``) builds dataflow
connections for a Plasm.

Unlike ecto there is no C++/Python boundary per cell: cells pass numpy
values between them and compute on torch tensors inside; the serving path
also runs as one object (tod_tpu_torch.models.fused.FusedDetector) — the
cell graph is the flexible/compatible path, matching how the reference used
ecto for wiring while OpenCV did the math.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from tod_tpu_torch.pipeline.tendril import Tendrils


class PortProxy:
    """``cell['a', 'b']`` or ``cell[:]`` — a handle used to build connections."""

    def __init__(self, cell: "Cell", keys: Union[slice, Tuple[str, ...]]):
        self.cell = cell
        if isinstance(keys, slice):
            self.keys: Optional[Tuple[str, ...]] = None  # resolved at connect
        elif isinstance(keys, str):
            self.keys = (keys,)
        else:
            self.keys = tuple(keys)

    def resolve(self, side: str) -> Tuple[str, ...]:
        if self.keys is not None:
            return self.keys
        tendrils = self.cell.outputs if side == "out" else self.cell.inputs
        return tuple(tendrils.keys())

    def __rshift__(self, other: "PortProxy") -> List["Connection"]:
        from tod_tpu_torch.pipeline.plasm import Connection
        src_keys = self.resolve("out")
        dst_keys = other.resolve("in")
        if len(src_keys) != len(dst_keys):
            raise ValueError(
                f"port count mismatch: {self.cell.name}{src_keys} >> "
                f"{other.cell.name}{dst_keys}")
        return [Connection(self.cell, s, other.cell, d)
                for s, d in zip(src_keys, dst_keys)]


class Cell:
    """Base cell. Subclasses override the declare/configure/process hooks."""

    def __init__(self, name: Optional[str] = None, **params: Any):
        self.name = name or type(self).__name__
        self.params = Tendrils()
        self.inputs = Tendrils()
        self.outputs = Tendrils()
        self.declare_params(self.params)
        # Apply user values for already-declared params NOW so that composite
        # cells (BlackBox.declare_cells) see them when declaring IO.
        leftover = {}
        for k, v in params.items():
            if k in self.params:
                self.params[k] = v
            else:
                leftover[k] = v
        self.declare_io(self.params, self.inputs, self.outputs)
        unknown = [k for k in leftover if k not in self.params
                   and k not in self.inputs]
        if unknown:
            raise ValueError(f"{self.name}: unknown parameters {unknown}")
        for k, v in leftover.items():
            if k in self.params:
                self.params[k] = v
            else:
                self.inputs[k] = v
        self._configured = False

    # -- declaration hooks -----------------------------------------------------
    @staticmethod
    def declare_params(p: Tendrils) -> None:  # noqa: ARG004
        pass

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:  # noqa: ARG004
        pass

    # -- lifecycle -------------------------------------------------------------
    def configure(self) -> None:
        pass

    def ensure_configured(self) -> None:
        if not self._configured:
            missing = self.params.missing_required()
            if missing:
                raise ValueError(
                    f"{self.name}: missing required params {missing}")
            self.configure()
            self._configured = True

    def process(self) -> None:
        raise NotImplementedError

    # -- connection sugar ------------------------------------------------------
    def __getitem__(self, keys) -> PortProxy:
        return PortProxy(self, keys)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class CellInfo:
    """Deferred cell construction (the ecto BlackBoxCellInfo analog used in
    declare_cells, python/object_recognition_tod/detector.py:26-30)."""

    def __init__(self, cell_class, params: Optional[Dict[str, Any]] = None):
        self.cell_class = cell_class
        self.params = dict(params or {})

    def instantiate(self, name: str) -> Cell:
        return self.cell_class(name, **self.params)


class Forward:
    """Forward an inner cell key to an outer BlackBox key
    (ecto BlackBoxForward; declare_forwards, detector.py:34-47)."""

    def __init__(self, inner_key: str, outer_key: Optional[str] = None,
                 doc: Optional[str] = None):
        self.inner_key = inner_key
        self.outer_key = outer_key or inner_key
        self.doc = doc
