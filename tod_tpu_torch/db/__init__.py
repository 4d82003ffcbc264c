from tod_tpu_torch.db.document import Document
from tod_tpu_torch.db.backends import (
    ObjectDb,
    ObjectDbParameters,
    InMemoryDb,
    FilesystemDb,
    CouchDb,
)
from tod_tpu_torch.db.views import View, ViewIterator
from tod_tpu_torch.db.models import (
    write_model,
    load_models_for_objects,
    find_models_for_object,
    insert_observation,
    observation_from_document,
    observations_for_object,
)
from tod_tpu_torch.types import Observation, TodModel

__all__ = [
    "Document",
    "ObjectDb",
    "ObjectDbParameters",
    "InMemoryDb",
    "FilesystemDb",
    "CouchDb",
    "View",
    "ViewIterator",
    "Observation",
    "TodModel",
    "write_model",
    "load_models_for_objects",
    "find_models_for_object",
    "insert_observation",
    "observation_from_document",
    "observations_for_object",
]
