"""Model IO cells: ModelReader, ModelReaderIterative, ModelWriter (a copy
of tod_tpu/cells/readers.py).

Rebuilds src/detection/ModelReader.cpp (load model docs by id, emit
descriptors/points/object_id) and object_recognition_core's ModelWriter as
used by the trainer pipeline (trainer.py:30: ``ModelWriter(method='TOD')``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from tod_tpu_torch.db import Document, ObjectDbParameters
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils


class ModelReader(Cell):
    """Load one TOD model document by id (ModelReader.cpp:25-71)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("db_params", "The DB parameters (dict or JSON).",
                  required=True)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("model_id", "The DB id of the model to load.")
        o.declare("descriptors", "The descriptors.")
        o.declare("object_id", "The DB object ID.")
        o.declare("points", "The 3d position of the points.")

    def configure(self) -> None:
        self._db = ObjectDbParameters(self.params["db_params"]).generate_db()

    def process(self) -> None:
        doc = self._db.load(self.inputs["model_id"])
        self.outputs["descriptors"] = doc.get_attachment("descriptors")
        self.outputs["points"] = doc.get_attachment("points")
        self.outputs["object_id"] = doc.fields.get("object_id", doc.id)


class ModelReaderIterative(Cell):
    """Load a list of model documents (ModelReader.cpp:75-135)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("db_params", "The DB parameters (dict or JSON).",
                  required=True)
        p.declare("model_ids", "The DB ids of the models to load.",
                  default=())

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        o.declare("descriptors", "List of descriptor matrices.")
        o.declare("points", "List of point matrices.")
        o.declare("object_ids", "List of object ids.")

    def configure(self) -> None:
        self._db = ObjectDbParameters(self.params["db_params"]).generate_db()

    def process(self) -> None:
        descriptors: List[np.ndarray] = []
        points: List[np.ndarray] = []
        object_ids: List[str] = []
        for model_id in self.params["model_ids"]:
            doc = self._db.load(model_id)
            descriptors.append(doc.get_attachment("descriptors"))
            points.append(doc.get_attachment("points"))
            object_ids.append(doc.fields.get("object_id", doc.id))
        self.outputs["descriptors"] = descriptors
        self.outputs["points"] = points
        self.outputs["object_ids"] = object_ids


class ModelWriter(Cell):
    """Persist a filled model document, stamping object_id + method
    (the core ModelWriter used at trainer.py:30)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("method", "The model method tag.", default="TOD")

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("db_document", "The document to persist.", required=True)
        i.declare("json_db", "The DB parameters as a JSON string.",
                  required=True)
        i.declare("object_id", "The object the model belongs to.",
                  required=True)
        o.declare("document_id", "The persisted document id.")

    def process(self) -> None:
        db = ObjectDbParameters(self.inputs["json_db"]).generate_db()
        doc: Document = self.inputs["db_document"]
        doc.fields["Type"] = "Model"
        doc.fields["object_id"] = self.inputs["object_id"]
        doc.fields["method"] = self.params["method"]
        # one model per (object, method): replace any existing
        for old in list(db.query(Type="Model",
                                 object_id=self.inputs["object_id"],
                                 method=self.params["method"])):
            db.delete(old.id)
        self.outputs["document_id"] = db.insert(doc)
