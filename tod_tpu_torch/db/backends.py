"""Object database backends (tod_tpu/db/backends.py).

The replacement for object_recognition_core's ``ObjectDb`` /
``ObjectDbParameters`` (used at src/training/Trainer.cpp:122-124 and
src/detection/GuessGenerator.cpp: ``ObjectDbParameters(json).generateDb()``).

Three backends:
  * ``InMemoryDb``  — ``type: 'mem'``       fast fake for tests.
  * ``FilesystemDb``— ``type: 'filesystem'`` directory tree of JSON + .npy files.
  * ``CouchDb``     — ``type: 'CouchDB'``    HTTP backend speaking the CouchDB
    document/attachment REST dialect, so the reference's ``.ork`` configs
    (conf/detection.ork:43-46: ``type: CouchDB, root: http://localhost:5984``)
    work unchanged.

Documents are queried by field equality; that is the only view primitive the
reference pipeline needs (observations by object_id, models by
object_id+method — see tod_tpu_torch.db.views). The on-disk FilesystemDb
layout is the reference's, so a DB written by either package loads in the
other.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional
from urllib import request as _urlrequest
from urllib.error import HTTPError

import numpy as np

from tod_tpu_torch.db.document import Document, new_document_id
from tod_tpu_torch.utils.config import parse_json_params


class ObjectDb:
    """Abstract document database."""

    def insert(self, doc: Document) -> str:
        """Persist ``doc`` (assigning an id if absent) and return its id."""
        raise NotImplementedError

    def load(self, doc_id: str) -> Document:
        raise NotImplementedError

    def delete(self, doc_id: str) -> None:
        raise NotImplementedError

    def all_ids(self) -> List[str]:
        raise NotImplementedError

    def query(self, **field_equals: Any) -> Iterator[Document]:
        """Yield documents whose fields match all given equality constraints."""
        for doc_id in self.all_ids():
            doc = self.load(doc_id)
            if all(doc.fields.get(k) == v for k, v in field_equals.items()):
                yield doc

    def parameters(self) -> Dict[str, Any]:
        """The parameter dict that would recreate this DB (for JSON plumbing)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# In-memory backend
# ---------------------------------------------------------------------------


class InMemoryDb(ObjectDb):
    """Process-local store; the fake-DB fixture the reference never had
    (SURVEY.md section 4 calls for one)."""

    # Registry so that independently-parsed parameter dicts with the same
    # ``collection`` name share storage within a process (mirrors how two
    # cells pointing CouchDB at the same URL see the same data).
    _registry: Dict[str, "InMemoryDb"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, collection: str = "object_recognition"):
        self.collection = collection
        self._docs: Dict[str, Document] = {}
        self._lock = threading.Lock()

    @classmethod
    def shared(cls, collection: str) -> "InMemoryDb":
        with cls._registry_lock:
            if collection not in cls._registry:
                cls._registry[collection] = cls(collection)
            return cls._registry[collection]

    @classmethod
    def reset_shared(cls) -> None:
        with cls._registry_lock:
            cls._registry.clear()

    def insert(self, doc: Document) -> str:
        with self._lock:
            if doc.id is None:
                doc.id = new_document_id()
            doc.rev = str(int(doc.rev or 0) + 1)
            # Deep-ish copy to decouple caller mutation from the store.
            stored = Document(
                id=doc.id,
                rev=doc.rev,
                fields=dict(doc.fields),
                attachments={k: np.array(v) for k, v in doc.attachments.items()},
            )
            self._docs[doc.id] = stored
            return doc.id

    def load(self, doc_id: str) -> Document:
        with self._lock:
            doc = self._docs[doc_id]
            return Document(
                id=doc.id,
                rev=doc.rev,
                fields=dict(doc.fields),
                attachments={k: np.array(v) for k, v in doc.attachments.items()},
            )

    def delete(self, doc_id: str) -> None:
        with self._lock:
            self._docs.pop(doc_id, None)

    def all_ids(self) -> List[str]:
        with self._lock:
            return list(self._docs.keys())

    def parameters(self) -> Dict[str, Any]:
        return {"type": "mem", "collection": self.collection}


# ---------------------------------------------------------------------------
# Filesystem backend
# ---------------------------------------------------------------------------


class FilesystemDb(ObjectDb):
    """One directory per document: ``<root>/<collection>/<id>/fields.json`` plus
    one ``<name>.npy`` per attachment. Doubles as the checkpoint format
    (SURVEY.md section 5: "the model DB *is* the checkpoint system")."""

    def __init__(self, root: str, collection: str = "object_recognition"):
        self.root = os.path.expanduser(root)
        self.collection = collection
        self._dir = os.path.join(self.root, collection)
        os.makedirs(self._dir, exist_ok=True)

    def _doc_dir(self, doc_id: str) -> str:
        return os.path.join(self._dir, doc_id)

    def insert(self, doc: Document) -> str:
        if doc.id is None:
            doc.id = new_document_id()
        doc_dir = self._doc_dir(doc.id)
        os.makedirs(doc_dir, exist_ok=True)
        doc.rev = str(int(doc.rev or 0) + 1)
        meta = {"fields": doc.fields, "rev": doc.rev}
        with open(os.path.join(doc_dir, "fields.json"), "w") as f:
            json.dump(meta, f)
        for name, arr in doc.attachments.items():
            np.save(os.path.join(doc_dir, f"{name}.npy"), np.asarray(arr),
                    allow_pickle=False)
        # drop stale attachment files from a previous revision: load() picks
        # up every *.npy in the directory, so leftovers would resurrect
        # attachments deleted from the document (checkpoint corruption)
        keep = {f"{name}.npy" for name in doc.attachments}
        for fname in os.listdir(doc_dir):
            if fname.endswith(".npy") and fname not in keep:
                os.remove(os.path.join(doc_dir, fname))
        return doc.id

    def load(self, doc_id: str) -> Document:
        doc_dir = self._doc_dir(doc_id)
        with open(os.path.join(doc_dir, "fields.json")) as f:
            meta = json.load(f)
        attachments = {}
        for fname in os.listdir(doc_dir):
            if fname.endswith(".npy"):
                attachments[fname[:-4]] = np.load(
                    os.path.join(doc_dir, fname), allow_pickle=False)
        return Document(id=doc_id, rev=meta.get("rev"), fields=meta["fields"],
                        attachments=attachments)

    def delete(self, doc_id: str) -> None:
        doc_dir = self._doc_dir(doc_id)
        if os.path.isdir(doc_dir):
            for fname in os.listdir(doc_dir):
                os.remove(os.path.join(doc_dir, fname))
            os.rmdir(doc_dir)

    def all_ids(self) -> List[str]:
        return [d for d in os.listdir(self._dir)
                if os.path.isdir(os.path.join(self._dir, d))]

    def parameters(self) -> Dict[str, Any]:
        return {"type": "filesystem", "root": self.root,
                "collection": self.collection}


# ---------------------------------------------------------------------------
# CouchDB-compatible HTTP backend
# ---------------------------------------------------------------------------


class CouchDb(ObjectDb):
    """Backend speaking CouchDB's REST dialect so reference configs
    (conf/detection.ork:43-46) run unchanged.

    Uses only: PUT /db, GET|PUT|DELETE /db/docid, GET|PUT /db/docid/attname,
    GET /db/_all_docs. Attachments travel as npy bytes
    (content-type application/octet-stream).
    """

    def __init__(self, root: str = "http://localhost:5984",
                 collection: str = "object_recognition", timeout: float = 30.0):
        self.root = root.rstrip("/")
        self.collection = collection
        self.timeout = timeout
        self._ensure_db()

    # -- raw http ------------------------------------------------------------
    def _req(self, method: str, path: str, body: Optional[bytes] = None,
             content_type: str = "application/json") -> tuple:
        url = f"{self.root}/{path}"
        req = _urlrequest.Request(url, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", content_type)
        with _urlrequest.urlopen(req, timeout=self.timeout) as resp:
            return resp.status, resp.read()

    def _ensure_db(self) -> None:
        try:
            self._req("PUT", self.collection)
        except HTTPError as e:
            if e.code not in (409, 412):  # already exists
                raise

    # -- ObjectDb API ----------------------------------------------------------
    def insert(self, doc: Document) -> str:
        if doc.id is None:
            doc.id = new_document_id()
        payload: Dict[str, Any] = dict(doc.fields)
        if doc.rev:
            payload["_rev"] = doc.rev
        try:
            _, data = self._req("PUT", f"{self.collection}/{doc.id}",
                                json.dumps(payload).encode())
        except HTTPError as e:
            if e.code == 409:  # conflict: fetch rev and retry once
                _, cur = self._req("GET", f"{self.collection}/{doc.id}")
                payload["_rev"] = json.loads(cur)["_rev"]
                _, data = self._req("PUT", f"{self.collection}/{doc.id}",
                                    json.dumps(payload).encode())
            else:
                raise
        doc.rev = json.loads(data)["rev"]
        for name, arr in doc.attachments.items():
            blob = Document.encode_array(arr)
            _, data = self._req(
                "PUT", f"{self.collection}/{doc.id}/{name}?rev={doc.rev}",
                blob, content_type="application/octet-stream")
            doc.rev = json.loads(data)["rev"]
        return doc.id

    def load(self, doc_id: str) -> Document:
        _, data = self._req("GET", f"{self.collection}/{doc_id}")
        raw = json.loads(data)
        rev = raw.pop("_rev", None)
        raw.pop("_id", None)
        att_stubs = raw.pop("_attachments", {})
        attachments = {}
        for name in att_stubs:
            _, blob = self._req("GET", f"{self.collection}/{doc_id}/{name}")
            attachments[name] = Document.decode_array(blob)
        return Document(id=doc_id, rev=rev, fields=raw, attachments=attachments)

    def delete(self, doc_id: str) -> None:
        try:
            _, cur = self._req("GET", f"{self.collection}/{doc_id}")
            rev = json.loads(cur)["_rev"]
            self._req("DELETE", f"{self.collection}/{doc_id}?rev={rev}")
        except HTTPError as e:
            if e.code != 404:
                raise

    def all_ids(self) -> List[str]:
        _, data = self._req("GET", f"{self.collection}/_all_docs")
        rows = json.loads(data)["rows"]
        return [r["id"] for r in rows]

    def parameters(self) -> Dict[str, Any]:
        return {"type": "CouchDB", "root": self.root,
                "collection": self.collection}


# ---------------------------------------------------------------------------
# Parameters / factory
# ---------------------------------------------------------------------------


class ObjectDbParameters:
    """Parses a DB parameter JSON string/dict and builds the backend; mirrors
    ``object_recognition_core::db::ObjectDbParameters(json).generateDb()``
    (src/training/Trainer.cpp:122-124)."""

    def __init__(self, params: Any = None):
        self.params = parse_json_params(params)
        self.type = self.params.get("type", "mem")

    def generate_db(self) -> ObjectDb:
        collection = self.params.get("collection", "object_recognition")
        if self.type in ("mem", "memory", "empty", ""):
            return InMemoryDb.shared(collection)
        if self.type.lower() == "filesystem":
            return FilesystemDb(self.params.get("root", "/tmp/tod_tpu_db"),
                                collection)
        if self.type.lower() == "couchdb":
            return CouchDb(self.params.get("root", "http://localhost:5984"),
                           collection)
        raise ValueError(f"unknown db type: {self.type!r}")

    # camelCase alias matching the reference API name
    generateDb = generate_db
