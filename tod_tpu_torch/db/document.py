"""Documents: typed fields + binary array attachments (tod_tpu/db/
document.py).

The replacement for object_recognition_core's ``db::Document`` as used by
the reference (attachment load: src/detection/DescriptorMatcher.cpp:74-86;
attachment store: src/training/ModelFiller.cpp:20-26; load by id:
src/detection/ModelReader.cpp:50-68). Attachments are numpy arrays (the
reference's cv::Mat): serialized with ``np.save`` for filesystem/HTTP backends.
"""

from __future__ import annotations

import io
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


def new_document_id() -> str:
    return uuid.uuid4().hex


@dataclass
class Document:
    """A database document: JSON-able fields plus named array attachments."""

    id: Optional[str] = None
    rev: Optional[str] = None
    fields: Dict[str, Any] = field(default_factory=dict)
    attachments: Dict[str, np.ndarray] = field(default_factory=dict)

    # -- field access --------------------------------------------------------
    def get_field(self, name: str) -> Any:
        return self.fields[name]

    def set_field(self, name: str, value: Any) -> None:
        self.fields[name] = value

    # -- attachment access ----------------------------------------------------
    def get_attachment(self, name: str) -> np.ndarray:
        """Fetch one attachment as a numpy array (cv::Mat analog)."""
        return self.attachments[name]

    def set_attachment(self, name: str, array: np.ndarray) -> None:
        self.attachments[name] = np.asarray(array)

    def has_attachment(self, name: str) -> bool:
        return name in self.attachments

    # -- serialization helpers -------------------------------------------------
    @staticmethod
    def encode_array(array: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.asarray(array), allow_pickle=False)
        return buf.getvalue()

    @staticmethod
    def decode_array(data: bytes) -> np.ndarray:
        """Decode an attachment blob: native npy, with a fallback to the
        reference-era cv::Mat formats (FileStorage YAML/XML, PNG, raw
        header: ``db/legacy.py``), so documents written by a reference
        install load without migration."""
        try:
            return np.load(io.BytesIO(data), allow_pickle=False)
        except (ValueError, OSError):
            from tod_tpu_torch.db.legacy import decode_legacy_mat

            return decode_legacy_mat(data)
