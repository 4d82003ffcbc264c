"""The cell graph's runtime and .ork loader (ROADMAP A12b): tod_tpu_torch
against tod_tpu on the CPU.

The reference's runtime cases (tests/test_pipeline.py) on the port's
tendrils, cells, plasm, scheduler and blackboxes; the port's toposort
against the reference's native one on random graphs (the same order, the
same cycle error); the port's pyyaml-free .ork reader equal to
``yaml.safe_load`` on every conf/*.ork and on the .ork texts the reference's
tests write; the graphs both packages build from each conf/*.ork (cells,
types, parameters, wiring) equal.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from tod_tpu.pipeline import Plasm as RefPlasm
from tod_tpu.pipeline import build_pipeline_from_ork as ref_build
from tod_tpu_torch.cells.io import Constant, Dealer, PassthroughN
from tod_tpu_torch.db import InMemoryDb
from tod_tpu_torch.pipeline import (BlackBox, Cell, CellInfo, Forward, Plasm,
                                    Scheduler, Tendrils, ThreadedScheduler,
                                    build_pipeline_from_ork, load_ork,
                                    toposort)
from tod_tpu_torch.pipeline import ork_yaml
from torch_parity import native_library

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = sorted(glob.glob(os.path.join(ROOT, "conf", "*.ork")))


@pytest.fixture(scope="session", autouse=True)
def _native_library():
    """The reference's Plasm sorts through tod_tpu.native: build it
    safely."""
    native_library()


@pytest.fixture(autouse=True)
def _reset_port_dbs():
    InMemoryDb.reset_shared()
    yield
    InMemoryDb.reset_shared()


class Doubler(Cell):
    @staticmethod
    def declare_io(p, i, o):
        i.declare("x", "input", default=0)
        o.declare("y", "output")

    def process(self):
        self.outputs["y"] = 2 * self.inputs["x"]


class Adder(Cell):
    @staticmethod
    def declare_io(p, i, o):
        i.declare("a", "lhs", default=0)
        i.declare("b", "rhs", default=0)
        o.declare("sum", "a+b")

    def process(self):
        self.outputs["sum"] = self.inputs["a"] + self.inputs["b"]


# ---- the reference's runtime cases (tests/test_pipeline.py) ---------------

def test_tendrils_declare_and_access():
    t = Tendrils()
    t.declare("x", "doc", default=5)
    assert t["x"] == 5
    t["x"] = 7
    assert t.x == 7
    t.declare("req", "must be set", required=True)
    assert t.missing_required() == ["req"]


def test_cell_param_validation():
    with pytest.raises(ValueError):
        Constant("c", nonsense=1)


def test_plasm_executes_in_topo_order():
    c = Constant("c", value=3)
    d = Doubler("d")
    a = Adder("a")
    p = Plasm()
    p.connect(c["out"] >> d["x"])
    p.connect(c["out"] >> a["a"], d["y"] >> a["b"])
    p.execute(1)
    assert a.outputs["sum"] == 9  # 3 + 2*3


def test_plasm_detects_cycles():
    d1, d2 = Doubler("d1"), Doubler("d2")
    p = Plasm()
    p.connect(d1["y"] >> d2["x"])
    p.connect(d2["y"] >> d1["x"])
    with pytest.raises(ValueError, match="cycle"):
        p.toposorted()


def test_plasm_bad_port_raises():
    c, d = Constant("c", value=1), Doubler("d")
    p = Plasm()
    with pytest.raises(KeyError):
        p.connect(c["nope"] >> d["x"])


def test_multi_port_connection_sugar():
    class TwoOut(Cell):
        @staticmethod
        def declare_io(p, i, o):
            o.declare("p", "")
            o.declare("q", "")

        def process(self):
            self.outputs["p"], self.outputs["q"] = 1, 2

    t, a = TwoOut("t"), Adder("a")
    p = Plasm()
    p.connect(t["p", "q"] >> a["a", "b"])
    p.execute()
    assert a.outputs["sum"] == 3


def test_dealer_and_passthrough():
    d = Dealer("deal", iterable=["m1", "m2"])
    pt = PassthroughN("pt", items={"v": "a value"})
    p = Plasm()
    p.connect(d["out"] >> pt["v"])
    p.execute(2)
    assert pt.outputs["v"] == "m2"


class SmallBox(BlackBox):
    @classmethod
    def declare_cells(cls, p):
        return {"const": CellInfo(Constant, {"value": p["value"]}),
                "doubler": CellInfo(Doubler)}

    @classmethod
    def declare_forwards(cls, _p):
        return ({}, {}, {"doubler": [Forward("y", "result")]})

    @classmethod
    def declare_direct_params(cls, p):
        p.declare("value", "the seed value", default=1)

    def connections(self, p):
        return [self.const["out"] >> self.doubler["x"]]


def test_blackbox_composition():
    box = SmallBox("box", value=21)
    box.process()
    assert box.outputs["result"] == 42


def test_blackbox_forward_all():
    class AllBox(BlackBox):
        @classmethod
        def declare_cells(cls, p):
            return {"add": CellInfo(Adder)}

        @classmethod
        def declare_forwards(cls, _p):
            return ({}, {"add": "all"}, {"add": "all"})

    box = AllBox("box")
    box.inputs["a"] = 4
    box.inputs["b"] = 5
    box.process()
    assert box.outputs["sum"] == 9


def test_scheduler_timing_report():
    c, d = Constant("c", value=1), Doubler("d")
    p = Plasm()
    p.connect(c["out"] >> d["x"])
    s = Scheduler(p)
    s.execute(3)
    report = s.timing_report()
    assert "3 iterations" in report and "d" in report


def test_threaded_scheduler_levels():
    c1, c2 = Constant("c1", value=2), Constant("c2", value=3)
    d1, d2 = Doubler("d1"), Doubler("d2")
    a = Adder("a")
    p = Plasm()
    p.connect(c1["out"] >> d1["x"])
    p.connect(c2["out"] >> d2["x"])
    p.connect(d1["y"] >> a["a"], d2["y"] >> a["b"])
    s = ThreadedScheduler(p, max_workers=2)
    s.execute(2)
    assert a.outputs["sum"] == 10  # 2*2 + 2*3
    assert s.n_iterations == 2
    # level structure: constants | doublers | adder
    assert [len(lvl) for lvl in s._levels] == [2, 2, 1]


# ---- toposort: the reference's native Kahn order --------------------------

def _random_dag(seed: int, n: int, n_edges: int):
    """Edges of a random DAG on ``n`` nodes (a hidden order, shuffled node
    ids, repeated edges allowed)."""
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n)
    edges = []
    for _ in range(n_edges):
        a, b = rng.choice(n, 2, replace=False)
        if rank[a] > rank[b]:
            a, b = b, a
        edges.append((int(a), int(b)))
    return edges


@pytest.mark.parametrize("seed, n, n_edges", [
    (0, 1, 0), (1, 5, 0), (2, 8, 12), (3, 30, 60), (4, 60, 400),
    (5, 200, 150)])
def test_toposort_matches_native_on_dags(seed, n, n_edges):
    """Exactly the native order (ready nodes lowest index first)."""
    from tod_tpu.native import toposort as native_toposort

    edges = _random_dag(seed, n, n_edges)
    got = toposort(n, edges)
    assert got == native_toposort(n, edges)
    pos = {v: i for i, v in enumerate(got)}
    assert all(pos[a] < pos[b] for a, b in edges)


@pytest.mark.parametrize("seed, n", [(10, 2), (11, 9), (12, 40)])
def test_toposort_raises_on_cycles_as_native(seed, n):
    """A cycle (a DAG with a closed chain through random nodes added, or a
    self loop) raises the reference's ValueError in both."""
    from tod_tpu.native import toposort as native_toposort

    edges = _random_dag(seed, n, 3 * n)
    ring = np.random.default_rng(seed).permutation(n)[:min(n, 3)]
    edges += [(int(a), int(b)) for a, b in zip(ring, np.roll(ring, -1))]
    for graph in (edges, [(0, 0)]):
        with pytest.raises(ValueError, match="plasm graph has a cycle"):
            toposort(n, graph)
        with pytest.raises(ValueError, match="plasm graph has a cycle"):
            native_toposort(n, graph)


def test_plasm_order_matches_reference_plasm():
    """The same graph built in both packages (cells inserted in the same
    order) schedules its cells in the same order."""
    from tod_tpu.cells.io import Constant as RefConstant
    from tod_tpu.pipeline import Cell as RefCell

    class RefDoubler(RefCell):
        declare_io = staticmethod(Doubler.declare_io)
        process = Doubler.process

    edges = _random_dag(7, 12, 20)

    def build(plasm_cls, const, doubler):
        cells = [const(f"c{i}", value=i) if i % 3 == 0 else doubler(f"d{i}")
                 for i in range(12)]
        plasm = plasm_cls()
        for cell in cells:
            plasm.insert(cell)
        for a, b in edges:
            if not isinstance(cells[b], const):
                src = "out" if isinstance(cells[a], const) else "y"
                plasm.connect(cells[a][src] >> cells[b]["x"])
        return [c.name for c in plasm.toposorted()]

    assert build(Plasm, Constant, Doubler) == build(RefPlasm, RefConstant,
                                                     RefDoubler)


# ---- the .ork reader: yaml.safe_load's result without pyyaml --------------

# the .ork texts tests/test_apps.py writes (its db root filled in)
APP_TEXTS = [
    """
pipeline1:
  type: TodTrainer
  module: object_recognition_tod
  parameters:
    feature: {type: ORB, n_features: 400, n_levels: 3, scale_factor: 1.2}
    descriptor: {type: ORB}
    db: {type: filesystem, root: '/tmp/pytest-of-x/db'}
    object_ids: "all"
""",
    """
source1:
  type: OpenNI
  module: object_recognition_core.io.source
pipeline1:
  type: TodDetector
  module: object_recognition_tod
  inputs: [source1]
  parameters:
    object_ids: "all"
    feature: {type: ORB, n_features: 1200, n_levels: 3, scale_factor: 1.2}
    descriptor: {type: ORB}
    search: {type: LSH, radius: 35, ratio: 0.8}
    n_ransac_iterations: 512
    min_inliers: 8
    sensor_error: 0.01
    db: {type: filesystem, root: '/tmp/pytest-of-x/db'}
"""]

# the subset's corners: scalars as YAML 1.1 resolves them, quotes, comments,
# nested and multi-line flow collections, block sequences
EDGE_TEXT = r"""
# a comment line
a: 1            # a trailing comment
b: -2
c: 0.5
d: 1e3          # no dot: a string in YAML 1.1
e: .inf
f: yes
g: ~
h: 'it''s # not a comment'
i: "x\ty \"q\" # neither"
j: [1, two, 'three', [4, 5], {k: v}]
k: {type: ORB, n_features: 400, n_levels: 3, scale_factor: 1.2}
l:
  - 1
  - x: 2
    y: 3
  - [a]
m:
- p
- q
n: 0x1F
o: 017
p: 1_000
q: +.5
r: 6x8
s:
t: hello world
u: {a: [1, 2,
   3], b: c}
w: True
x: 0
y: -0.0
z: '#hash'
bb: a#b
cc: [x, 'y, z']
"""


@pytest.mark.parametrize("path", CONF, ids=os.path.basename)
def test_ork_reader_equals_yaml_on_conf(path):
    with open(path) as f:
        text = f.read()
    assert ork_yaml.safe_load(text) == yaml.safe_load(text)
    assert load_ork(path) == yaml.safe_load(text)


@pytest.mark.parametrize("text", APP_TEXTS + [EDGE_TEXT, "", "# only\n"],
                         ids=["train", "detect", "edges", "empty", "comment"])
def test_ork_reader_equals_yaml_on_test_texts(text):
    assert ork_yaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: 1:20\n",
    "a: [1, 2\n", "---\na: 1\n", "a: 'open\n"])
def test_ork_reader_refuses_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        ork_yaml.safe_load(text)


# ---- the graphs built from conf/*.ork --------------------------------------

def _graph(pipeline):
    cells = {name: (type(cell).__name__, {k: v for k, v in cell.params.items()
                                          if k != "device"})
             for name, cell in pipeline.cells.items()}
    edges = sorted((c.src.name, c.src_port, c.dst.name, c.dst_port)
                   for c in pipeline.plasm.connections)
    return cells, edges


@pytest.mark.parametrize("path", CONF, ids=os.path.basename)
def test_ork_builds_the_reference_graph(path):
    """Each conf/*.ork instantiates the same cells (type and parameters) and
    the same connections in both packages; the port's computing cells
    default to the card."""
    db = {"type": "mem", "collection": "ork_graph"}
    over = {"source1": {"path": "frames"}, "pipeline1": {"db": db}}
    mine = build_pipeline_from_ork(path, over)
    ref = ref_build(path, over)
    assert _graph(mine) == _graph(ref)
    assert mine.cells["pipeline1"].params["device"] == "cuda"
    assert json.loads(mine.cells["pipeline1"].params["json_db"]) == db
