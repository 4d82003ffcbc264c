"""TodTrainer: the training pipeline BlackBox (tod_tpu/models/trainer.py).

API-parity rebuild of python/object_recognition_tod/trainer.py:17-55: wire
Constant(object_id, json_db) -> Trainer -> ModelFiller -> ModelWriter('TOD').
The Trainer runs on its ``device`` param (the card unless the caller names
another), forwarded with the Trainer's other params.
"""

from __future__ import annotations

from tod_tpu_torch.cells.io import Constant
from tod_tpu_torch.cells.readers import ModelWriter
from tod_tpu_torch.cells.trainer import ModelFiller, Trainer
from tod_tpu_torch.pipeline.blackbox import BlackBox
from tod_tpu_torch.pipeline.cell import CellInfo, Forward
from tod_tpu_torch.pipeline.tendril import Tendrils


class TodTrainer(BlackBox):
    @classmethod
    def declare_cells(cls, _p: Tendrils):
        return {
            "object_id": CellInfo(Constant),
            "json_db": CellInfo(Constant),
            "model_filler": CellInfo(ModelFiller),
            "model_writer": CellInfo(ModelWriter, {"method": "TOD"}),
            "trainer": CellInfo(Trainer),
        }

    @classmethod
    def declare_forwards(cls, _p):
        p = {"json_db": [Forward("value", "json_db")],
             "object_id": [Forward("value", "object_id")],
             "trainer": "all"}
        return p, {}, {"model_writer": [Forward("document_id")]}

    def connections(self, p):
        conns = [self.object_id["out"] >> self.trainer["object_id"],
                 self.json_db["out"] >> self.trainer["json_db"]]
        conns += [self.trainer["descriptors", "points"]
                  >> self.model_filler["descriptors", "points"]]
        conns += [self.object_id["out"] >> self.model_writer["object_id"],
                  self.json_db["out"] >> self.model_writer["json_db"],
                  self.model_filler["db_document"]
                  >> self.model_writer["db_document"]]
        return conns
