from tod_tpu_torch.pipeline.tendril import Tendril, Tendrils
from tod_tpu_torch.pipeline.cell import Cell, CellInfo, Forward
from tod_tpu_torch.pipeline.plasm import Connection, Plasm, toposort
from tod_tpu_torch.pipeline.scheduler import Scheduler, ThreadedScheduler
from tod_tpu_torch.pipeline.blackbox import BlackBox
from tod_tpu_torch.pipeline.ork import load_ork, build_pipeline_from_ork

__all__ = [
    "Tendril", "Tendrils", "Cell", "CellInfo", "Forward", "Connection",
    "Plasm", "toposort", "Scheduler", "ThreadedScheduler", "BlackBox",
    "load_ork", "build_pipeline_from_ork",
]
