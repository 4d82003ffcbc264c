"""TOD model documents and observation prototypes (tod_tpu/db/models.py).

Models load as :class:`tod_tpu_torch.types.TodModel` and observations as
:class:`tod_tpu_torch.types.Observation`.

Model format parity with the reference: a model document carries attachments
``descriptors`` (N x 32 uint8 — 256-bit binary descriptors, cv::Mat CV_8U) and
``points`` (1 x N x 3 float32 — CV_32FC3), written by ModelFiller
(src/training/ModelFiller.cpp:20-26) with fields ``object_id`` and
``method='TOD'`` (python/object_recognition_tod/trainer.py:30).

Observation documents mirror object_recognition_core's Observation prototype
(used at src/training/Trainer.cpp:135-138): attachments ``image`` (H,W,3 u8),
``depth`` (H,W f32 meters or u16 mm), ``mask`` (H,W u8), ``K`` (3,3), ``R``
(3,3), ``T`` (3,) with fields object_id + frame_number.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from tod_tpu_torch.db.backends import ObjectDb
from tod_tpu_torch.db.document import Document
from tod_tpu_torch.db.views import View, ViewIterator
from tod_tpu_torch.types import Observation, TodModel


def write_model(db: ObjectDb, object_id: str, descriptors: np.ndarray,
                points: np.ndarray, method: str = "TOD") -> str:
    """Persist a trained model; ModelFiller + ModelWriter analog
    (src/training/ModelFiller.cpp:20-26, trainer.py:30)."""
    # binary (uint8/ORB) kept as-is for format parity; float descriptors
    # (the SIFT/L2 path) stored as float32
    descriptors = np.ascontiguousarray(descriptors)
    if not np.issubdtype(descriptors.dtype, np.floating):
        descriptors = descriptors.astype(np.uint8)
    else:
        descriptors = descriptors.astype(np.float32)
    pts = np.asarray(points, dtype=np.float32)
    if pts.ndim == 3:  # accept the reference's (1, N, 3) layout
        pts = pts.reshape(-1, 3)
    doc = Document(
        fields={"Type": "Model", "object_id": object_id, "method": method},
        attachments={"descriptors": descriptors,
                     "points": pts.reshape(1, -1, 3)},
    )
    return db.insert(doc)


def _model_from_document(doc: Document) -> TodModel:
    descriptors = np.asarray(doc.get_attachment("descriptors"))
    if not np.issubdtype(descriptors.dtype, np.floating):
        descriptors = descriptors.astype(np.uint8)
    points = np.asarray(doc.get_attachment("points"), dtype=np.float32)
    if points.ndim == 3:
        points = points.reshape(-1, 3)
    elif points.ndim == 2 and points.shape[1] != 3:
        # reference tolerates transposed storage (DescriptorMatcher.cpp:84-85)
        points = points.T
    return TodModel(object_id=doc.fields["object_id"], descriptors=descriptors,
                    points=points, document_id=doc.id)


def find_models_for_object(db: ObjectDb, object_id: str,
                           method: str = "TOD") -> List[TodModel]:
    view = View.VIEW_MODEL_WHERE_OBJECT_ID_AND_METHOD
    view.set_key(object_id)
    view.set_method(method)
    return [_model_from_document(doc) for doc in ViewIterator(view, db)]


def load_models_for_objects(db: ObjectDb, object_ids: Sequence[str] | str = "all",
                            method: str = "TOD") -> List[TodModel]:
    """Load one model per object (the matcher-side DB reload,
    src/detection/DescriptorMatcher.cpp:61-129)."""
    if object_ids == "all" or object_ids == ["all"]:
        docs = list(db.query(Type="Model", method=method))
        docs.sort(key=lambda d: (d.fields.get("object_id", ""), d.id or ""))
        return [_model_from_document(d) for d in docs]
    models: List[TodModel] = []
    for oid in object_ids:
        found = find_models_for_object(db, oid, method)
        if found:
            models.append(found[0])
    return models


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def insert_observation(db: ObjectDb, object_id: str, frame_number: int,
                       image: np.ndarray, depth: np.ndarray, mask: np.ndarray,
                       K: np.ndarray, R: np.ndarray, T: np.ndarray) -> str:
    doc = Document(
        fields={"Type": "Observation", "object_id": object_id,
                "frame_number": int(frame_number)},
        attachments={
            "image": np.asarray(image),
            "depth": np.asarray(depth),
            "mask": np.asarray(mask),
            "K": np.asarray(K, dtype=np.float64),
            "R": np.asarray(R, dtype=np.float64),
            "T": np.asarray(T, dtype=np.float64).reshape(3),
        },
    )
    return db.insert(doc)


def observation_from_document(doc: Document) -> Observation:
    """The decoded observation of an Observation document."""
    return Observation(image=doc.get_attachment("image"),
                       depth=doc.get_attachment("depth"),
                       mask=doc.get_attachment("mask"),
                       K=doc.get_attachment("K"),
                       R=doc.get_attachment("R"),
                       T=doc.get_attachment("T"),
                       frame_number=doc.fields.get("frame_number", 0))


def observations_for_object(db: ObjectDb, object_id: str) -> List[Observation]:
    view = View.VIEW_OBSERVATION_WHERE_OBJECT_ID
    view.set_key(object_id)
    return [observation_from_document(doc)
            for doc in ViewIterator(view, db)]
