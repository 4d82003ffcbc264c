"""BlackBox: a composite cell wrapping an inner plasm (a copy of
tod_tpu/pipeline/blackbox.py).

The ecto ``BlackBox`` protocol rebuilt: subclasses declare inner cells
(``declare_cells``), forward outer params/inputs/outputs onto inner tendrils
(``declare_forwards``), declare direct params (``declare_direct_params``),
and wire the inner dataflow graph (``connections``) — the exact protocol the
reference's TodDetector/TodTrainer implement
(python/object_recognition_tod/detector.py:15-110, trainer.py:17-55).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

from tod_tpu_torch.pipeline.cell import Cell, CellInfo, Forward
from tod_tpu_torch.pipeline.plasm import Connection, Plasm
from tod_tpu_torch.pipeline.scheduler import Scheduler
from tod_tpu_torch.pipeline.tendril import Tendrils


def _normalize_forwards(spec) -> Dict[str, List[Forward]]:
    out: Dict[str, List[Forward]] = {}
    for cell_name, fwds in (spec or {}).items():
        if fwds == "all":
            out[cell_name] = "all"  # resolved after instantiation
        else:
            out[cell_name] = [f if isinstance(f, Forward) else Forward(f)
                              for f in fwds]
    return out


class BlackBox(Cell):
    """Composite cell. Subclass hooks (all optional):
      declare_cells(p) -> {name: Cell | CellInfo}
      declare_forwards(p) -> (params_map, inputs_map, outputs_map)
      declare_direct_params(p)
      configure(p, i, o)
      connections(p) -> [Connection | list]
    """

    def __init__(self, name=None, **params):
        self._cells: Dict[str, Cell] = {}
        self._fwd_p: Dict[str, List[Forward]] = {}
        self._fwd_i: Dict[str, List[Forward]] = {}
        self._fwd_o: Dict[str, List[Forward]] = {}
        self.plasm = Plasm()
        self._scheduler: Scheduler | None = None
        super().__init__(name, **params)

    # -- subclass hooks --------------------------------------------------------
    @classmethod
    def declare_cells(cls, p: Tendrils) -> Dict[str, Union[Cell, CellInfo]]:  # noqa: ARG003
        return {}

    @classmethod
    def declare_forwards(cls, p: Tendrils) -> Tuple[dict, dict, dict]:  # noqa: ARG003
        return {}, {}, {}

    @classmethod
    def declare_direct_params(cls, p: Tendrils) -> None:  # noqa: ARG003
        pass

    def connections(self, p: Tendrils) -> List:  # noqa: ARG002
        return []

    def configure_blackbox(self, p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        """Post-instantiation hook (the reference's BlackBox.configure)."""

    # -- Cell protocol implementation -----------------------------------------
    def declare_params(self, p: Tendrils) -> None:
        # Only direct params here; user values for them are applied by
        # Cell.__init__ before declare_io runs, so declare_cells sees them.
        type(self).declare_direct_params(p)

    def declare_io(self, p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        cells = type(self).declare_cells(p)
        self._cells = {
            name: (spec.instantiate(name) if isinstance(spec, CellInfo)
                   else spec)
            for name, spec in cells.items()}
        for name, cell in self._cells.items():
            cell.name = name
            setattr(self, name, cell)

        fp, fi, fo = type(self).declare_forwards(p)
        self._fwd_p = _normalize_forwards(fp)
        self._fwd_i = _normalize_forwards(fi)
        self._fwd_o = _normalize_forwards(fo)

        for cell_name, fwds in self._fwd_p.items():
            cell = self._cells[cell_name]
            if fwds == "all":
                fwds = [Forward(k) for k in cell.params.keys()]
                self._fwd_p[cell_name] = fwds
            for f in fwds:
                p.declare_tendril(f.outer_key, cell.params.at(f.inner_key))

        for cell_name, fwds in self._fwd_i.items():
            cell = self._cells[cell_name]
            if fwds == "all":
                fwds = [Forward(k) for k in cell.inputs.keys()]
                self._fwd_i[cell_name] = fwds
            for f in fwds:
                i.declare_tendril(f.outer_key, cell.inputs.at(f.inner_key))
        for cell_name, fwds in self._fwd_o.items():
            cell = self._cells[cell_name]
            if fwds == "all":
                fwds = [Forward(k) for k in cell.outputs.keys()]
                self._fwd_o[cell_name] = fwds
            for f in fwds:
                o.declare_tendril(f.outer_key, cell.outputs.at(f.inner_key))

    def configure(self) -> None:
        self.configure_blackbox(self.params, self.inputs, self.outputs)
        conns = self.connections(self.params)
        for item in conns:
            self.plasm.connect(item)
        for cell in self._cells.values():
            self.plasm.insert(cell)
        self._scheduler = Scheduler(self.plasm)

    def process(self) -> None:
        self.ensure_configured()
        self._scheduler.execute_iteration()

    @property
    def scheduler(self) -> Scheduler:
        self.ensure_configured()
        return self._scheduler
