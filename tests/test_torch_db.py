"""The object DB (ROADMAP A12b): tod_tpu_torch.db against tod_tpu.db on
the CPU.

The reference's backend contract (tests/test_db.py) on the port's three
backends, CouchDb against the same in-process fake CouchDB server; models
and observations in the port's types; and FilesystemDb's on-disk format
shared both ways: a DB written by either package loads in the other with
equal fields, descriptors, points and attachments (bit for bit).
"""

import numpy as np
import pytest

import tod_tpu.db as ref
from tod_tpu_torch.db import (CouchDb, Document, FilesystemDb, InMemoryDb,
                              ObjectDbParameters, find_models_for_object,
                              insert_observation, load_models_for_objects,
                              observations_for_object, write_model)
from tod_tpu_torch.types import Observation, TodModel
from test_db import couch_url  # noqa: F401  (the fake CouchDB server)


@pytest.fixture(autouse=True)
def _reset_port_dbs():
    InMemoryDb.reset_shared()
    yield
    InMemoryDb.reset_shared()


def _roundtrip(db):
    doc = Document(fields={"Type": "Model", "object_id": "obj1",
                           "method": "TOD"})
    doc.set_attachment("descriptors",
                       np.arange(64, dtype=np.uint8).reshape(2, 32))
    doc.set_attachment("points", np.ones((1, 2, 3), np.float32))
    doc_id = db.insert(doc)
    assert doc_id

    loaded = db.load(doc_id)
    assert loaded.fields["object_id"] == "obj1"
    np.testing.assert_array_equal(loaded.get_attachment("descriptors"),
                                  doc.get_attachment("descriptors"))
    assert loaded.get_attachment("points").shape == (1, 2, 3)

    assert doc_id in db.all_ids()
    found = list(db.query(object_id="obj1"))
    assert len(found) == 1

    db.delete(doc_id)
    assert doc_id not in db.all_ids()


def test_inmemory_roundtrip():
    _roundtrip(InMemoryDb("t"))


def test_filesystem_roundtrip(tmp_path):
    _roundtrip(FilesystemDb(str(tmp_path), "t"))


def test_couchdb_roundtrip(couch_url):  # noqa: F811
    _roundtrip(CouchDb(couch_url, "t"))


def test_parameters_factory(tmp_path, couch_url):  # noqa: F811
    assert isinstance(
        ObjectDbParameters('{"type": "mem"}').generate_db(), InMemoryDb)
    assert isinstance(
        ObjectDbParameters({"type": "filesystem",
                            "root": str(tmp_path)}).generate_db(),
        FilesystemDb)
    db = ObjectDbParameters({"type": "CouchDB",
                             "root": couch_url}).generate_db()
    assert isinstance(db, CouchDb)
    a = ObjectDbParameters('{"type": "mem", "collection": "c1"}').generate_db()
    b = ObjectDbParameters('{"type": "mem", "collection": "c1"}').generate_db()
    assert a is b
    with pytest.raises(ValueError, match="unknown db type"):
        ObjectDbParameters({"type": "sqlite"}).generate_db()


def test_models_load_as_port_types(tmp_path):
    db = FilesystemDb(str(tmp_path))
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, (10, 32), dtype=np.uint8)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    write_model(db, "objA", desc, pts)
    write_model(db, "objB", desc[:5], pts[:5])

    models = load_models_for_objects(db, "all")
    assert all(type(m) is TodModel for m in models)
    assert [m.object_id for m in models] == ["objA", "objB"]
    np.testing.assert_array_equal(models[0].descriptors, desc)
    np.testing.assert_array_equal(models[0].points, pts)
    assert models[0].document_id in db.all_ids()

    only_b = find_models_for_object(db, "objB")
    assert len(only_b) == 1 and only_b[0].n_points == 5
    assert [m.object_id for m in load_models_for_objects(
        db, ["objB", "missing"])] == ["objB"]


def test_model_span():
    pts = np.array([[0, 0, 0], [1, 2, 2]], np.float32)
    m = TodModel("x", np.zeros((2, 32), np.uint8), pts)
    assert np.isclose(m.span, 3.0)  # sqrt(1+4+4)


def test_observation_roundtrip():
    db = InMemoryDb("obs")
    img = np.zeros((48, 64, 3), np.uint8)
    depth = np.full((48, 64), 0.7, np.float32)
    mask = np.ones((48, 64), np.uint8)
    K = np.eye(3)
    for frame in (1, 0, 2):
        insert_observation(db, "obj", frame, img, depth, mask, K,
                           np.eye(3), np.zeros(3))
    obs = observations_for_object(db, "obj")
    assert all(type(o) is Observation for o in obs)
    assert [o.frame_number for o in obs] == [0, 1, 2]  # turntable order
    assert obs[0].depth.dtype == np.float32
    assert obs[0].T.shape == (3,)


def test_filesystem_update_in_place_drops_stale_attachments(tmp_path):
    db = FilesystemDb(str(tmp_path), "test")
    doc = Document(fields={"kind": "m"},
                   attachments={"a": np.arange(3), "b": np.arange(4)})
    doc_id = db.insert(doc)
    doc2 = db.load(doc_id)
    del doc2.attachments["b"]
    doc2.attachments["a"] = np.arange(5)
    db.insert(doc2)
    loaded = db.load(doc_id)
    assert set(loaded.attachments) == {"a"}
    assert len(loaded.attachments["a"]) == 5


def test_non_npy_attachment_names_the_migration():
    """A non-npy blob goes to the reference-era decoder (db/legacy.py), as
    the reference's ``decode_array`` does: a FileStorage matrix decodes,
    a map without its fields raises ``LegacyDecodeError``."""
    from tod_tpu_torch.db.legacy import LegacyDecodeError

    with pytest.raises(LegacyDecodeError, match="FileStorage"):
        Document.decode_array(b"%YAML:1.0\nmat: !!opencv-matrix\n")
    np.testing.assert_array_equal(
        Document.decode_array(b"%YAML:1.0\nmat: !!opencv-matrix\n"
                              b"   rows: 1\n   cols: 2\n   dt: i\n"
                              b"   data: [ 3, -4 ]\n"),
        np.array([[3, -4]], np.int32))


# ---- one FilesystemDb, both packages ----------------------------------------

def _fill(pkg, root):
    """Two models (ORB uint8 and SIFT float32) and three observations
    (u16 and float depth) written by ``pkg``'s db module."""
    rng = np.random.default_rng(3)
    db = pkg.FilesystemDb(root, "shared")
    orb = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    sift = rng.random((7, 128), dtype=np.float32)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    pkg.write_model(db, "orb_obj", orb, pts)
    pkg.write_model(db, "sift_obj", sift, pts[:7])
    for frame in (2, 0, 1):
        depth = (rng.integers(0, 2000, (12, 16)).astype(np.uint16)
                 if frame != 1 else rng.random((12, 16), dtype=np.float32))
        pkg.insert_observation(
            db, "orb_obj", frame,
            rng.integers(0, 256, (12, 16, 3), dtype=np.uint8), depth,
            rng.integers(0, 2, (12, 16), dtype=np.uint8),
            np.eye(3) * (frame + 1), rng.normal(size=(3, 3)),
            rng.normal(size=3))
    return db


def _contents(pkg, root):
    db = pkg.FilesystemDb(root, "shared")
    models = [(m.object_id, m.descriptors, m.points)
              for m in pkg.load_models_for_objects(db, "all")]
    obs = [(o.frame_number, o.image, o.depth, o.mask, o.K, o.R, o.T)
           for o in pkg.observations_for_object(db, "orb_obj")]
    docs = {i: db.load(i) for i in db.all_ids()}
    return models, obs, {i: (d.fields, d.rev, d.attachments)
                         for i, d in docs.items()}


def _assert_same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["tod_tpu", "tod_tpu_torch"])
def test_filesystem_db_shared_both_ways(tmp_path, writer):
    """Written by one package, read by both: the same documents (fields,
    revisions, attachments), models and observations, bit for bit."""
    import tod_tpu_torch.db as port

    root = str(tmp_path / "db")
    _fill(ref if writer == "tod_tpu" else port, root)
    _assert_same(_contents(port, root), _contents(ref, root))


def test_filesystem_db_files_are_identical(tmp_path):
    """The same document written by each package gives the same files:
    fields.json and every attachment's .npy, byte for byte."""
    import tod_tpu_torch.db as port

    blobs = []
    for pkg in (ref, port):
        db = pkg.FilesystemDb(str(tmp_path / pkg.__name__), "c")
        doc = pkg.Document(id="d0", fields={"Type": "Model", "x": [1, 2.5]},
                           attachments={"a": np.arange(6, dtype=np.int16),
                                        "b": np.ones((2, 3), np.float32)})
        db.insert(doc)
        d = tmp_path / pkg.__name__ / "c" / "d0"
        blobs.append({f.name: f.read_bytes() for f in sorted(d.iterdir())})
    assert blobs[0] == blobs[1]


def test_couchdb_shared_both_ways(couch_url):  # noqa: F811
    """A CouchDB collection written by one package loads in the other."""
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    write_model(CouchDb(couch_url, "x"), "port_obj", desc, pts)
    ref.write_model(ref.CouchDb(couch_url, "x"), "ref_obj", desc[:4],
                    pts[:4])
    for db in (CouchDb(couch_url, "x"), ref.CouchDb(couch_url, "x")):
        mods = {m.object_id: m for m in
                (load_models_for_objects if isinstance(db, CouchDb)
                 else ref.load_models_for_objects)(db, "all")}
        np.testing.assert_array_equal(mods["port_obj"].descriptors, desc)
        np.testing.assert_array_equal(mods["ref_obj"].points, pts[:4])
