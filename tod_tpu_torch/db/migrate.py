"""Migrate a reference-era (object_recognition_core) database into npy
documents (tools/migrate_db.py).

Reads a CouchDB instance or an offline dump holding the reference's
documents (trained models with cv::Mat attachments ``descriptors`` and
``points``; capture observations with PNG image/depth/mask and YAML
calibration attachments), decodes every attachment with
:func:`tod_tpu_torch.db.legacy.decode_legacy_mat` and writes the documents
into a backend as native npy attachments. Fields (Type, object_id, method,
frame_number, ...) pass through unchanged, so the migrated DB serves the
views directly. The backends also decode legacy attachments at load time
(``Document.decode_array``); migrating decodes once.

Run it as ``python -m tod_tpu_torch.cli migrate --src URL|DIR --dst JSON
[--new-ids]``. A dump directory holds ``<dump>/<docid>/doc.json`` plus one
file an attachment, or ``<dump>/<docid>.json`` with inline base64
``_attachments`` (the shape ``GET _all_docs?include_docs=true&
attachments=true`` exports).
"""

from __future__ import annotations

import base64
import json
import os
import sys
from typing import Dict, Iterator, Tuple
from urllib import request as _urlrequest

import numpy as np

from tod_tpu_torch.db.backends import ObjectDbParameters
from tod_tpu_torch.db.document import Document
from tod_tpu_torch.db.legacy import LegacyDecodeError, decode_legacy_mat

RawDoc = Tuple[str, Dict, Dict[str, bytes]]  # (id, fields, {name: blob})


def iter_couch(url: str) -> Iterator[RawDoc]:
    """Yield raw documents from a CouchDB database URL."""
    url = url.rstrip("/")

    def get(path: str) -> bytes:
        with _urlrequest.urlopen(f"{url}/{path}", timeout=60.0) as resp:
            return resp.read()

    rows = json.loads(get("_all_docs"))["rows"]
    for row in rows:
        doc_id = row["id"]
        if doc_id.startswith("_design"):
            continue
        raw = json.loads(get(doc_id))
        raw.pop("_id", None)
        raw.pop("_rev", None)
        stubs = raw.pop("_attachments", {})
        blobs = {name: get(f"{doc_id}/{name}") for name in stubs}
        yield doc_id, raw, blobs


def iter_dump(root: str) -> Iterator[RawDoc]:
    """Yield raw documents from an offline dump directory."""
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        if os.path.isdir(path):
            meta_path = os.path.join(path, "doc.json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                raw = json.load(f)
            doc_id = raw.pop("_id", entry)
            raw.pop("_rev", None)
            raw.pop("_attachments", None)
            blobs = {}
            for fname in sorted(os.listdir(path)):
                if fname == "doc.json":
                    continue
                with open(os.path.join(path, fname), "rb") as f:
                    blobs[fname] = f.read()
            yield doc_id, raw, blobs
        elif entry.endswith(".json"):
            with open(path) as f:
                raw = json.load(f)
            doc_id = raw.pop("_id", entry[:-5])
            raw.pop("_rev", None)
            stubs = raw.pop("_attachments", {})
            blobs = {name: base64.b64decode(stub["data"])
                     for name, stub in stubs.items() if "data" in stub}
            yield doc_id, raw, blobs


def migrate(source: Iterator[RawDoc], dst_params: str,
            keep_ids: bool = True) -> Dict[str, int]:
    """Write every decodable source document into the backend
    ``dst_params`` names (a document with an undecodable attachment is
    skipped and reported on stderr); returns the counts."""
    dst = ObjectDbParameters(dst_params).generate_db()
    stats = {"documents": 0, "attachments": 0, "skipped": 0}
    for doc_id, fields, blobs in source:
        attachments: Dict[str, np.ndarray] = {}
        ok = True
        for name, blob in blobs.items():
            try:
                attachments[name] = decode_legacy_mat(blob)
            except LegacyDecodeError as e:
                print(f"  SKIP {doc_id}: attachment {name!r} undecodable "
                      f"({e})", file=sys.stderr)
                ok = False
                break
        if not ok:
            stats["skipped"] += 1
            continue
        doc = Document(id=doc_id if keep_ids else None, fields=fields,
                       attachments=attachments)
        dst.insert(doc)
        stats["documents"] += 1
        stats["attachments"] += len(attachments)
        t = fields.get("Type", "?")
        oid = fields.get("object_id", "?")
        print(f"  migrated {doc_id} (Type={t}, object_id={oid}, "
              f"{len(attachments)} attachments)", file=sys.stderr)
    return stats
