"""DB views: the two query shapes the pipeline needs (tod_tpu/db/views.py).

Mirrors object_recognition_core's ``View``/``ViewIterator`` as used by the
reference Trainer (src/training/Trainer.cpp:126-133:
``View::VIEW_OBSERVATION_WHERE_OBJECT_ID`` + key = object_id) and the model
loader (``ModelReaderBase`` triggering src/detection/DescriptorMatcher.cpp:61).
"""

from __future__ import annotations

from enum import Enum
from typing import Iterator, List, Optional

from tod_tpu_torch.db.backends import ObjectDb
from tod_tpu_torch.db.document import Document


class View(Enum):
    VIEW_OBSERVATION_WHERE_OBJECT_ID = "observation_where_object_id"
    VIEW_MODEL_WHERE_OBJECT_ID_AND_METHOD = "model_where_object_id_and_method"

    def __init__(self, *_args):
        self.key: Optional[str] = None
        self.method: Optional[str] = None

    def set_key(self, key: str) -> None:
        self.key = key

    def set_method(self, method: str) -> None:
        self.method = method


class ViewIterator:
    """Iterate the documents matched by a view, ordered deterministically."""

    def __init__(self, view: View, db: ObjectDb):
        self._view = view
        self._db = db

    def _docs(self) -> List[Document]:
        if self._view is View.VIEW_OBSERVATION_WHERE_OBJECT_ID:
            docs = list(self._db.query(Type="Observation",
                                       object_id=self._view.key))
            # Turntable order: sort by frame_number when present.
            docs.sort(key=lambda d: d.fields.get("frame_number", 0))
            return docs
        if self._view is View.VIEW_MODEL_WHERE_OBJECT_ID_AND_METHOD:
            docs = list(self._db.query(Type="Model", object_id=self._view.key,
                                       method=self._view.method or "TOD"))
            docs.sort(key=lambda d: d.id or "")
            return docs
        raise ValueError(self._view)

    def __iter__(self) -> Iterator[Document]:
        return iter(self._docs())
