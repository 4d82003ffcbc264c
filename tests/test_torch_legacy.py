"""Reference-era cv::Mat attachments on the port (tod_tpu_torch/db/legacy.py,
db/migrate.py) against the reference (tod_tpu/db/legacy.py,
tools/migrate_db.py) on the CPU: every case of tests/test_migrate.py, every
dtype and channel count, both FileStorage headers and XML, the encoder's
bytes, the key choice, PNG blobs, and the migration of a dump and of a
CouchDB into npy documents."""

import base64
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from tod_tpu.db import legacy as rleg
from tod_tpu_torch.db import FilesystemDb, load_models_for_objects
from tod_tpu_torch.db import legacy as tleg
from tod_tpu_torch.db import migrate as tmig
from tod_tpu_torch.db.document import Document
from test_db import couch_url  # noqa: F401  (the fake CouchDB server)
from torch_parity import write_legacy_dump

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import migrate_db  # noqa: E402

torch.set_num_threads(1)

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.int32, np.float32,
          np.float64]


def _random(rng, dtype, shape):
    if np.dtype(dtype).kind == "f":
        a = (rng.standard_normal(shape)
             * 10.0 ** rng.integers(-8, 12, shape)).astype(dtype)
        flat = a.reshape(-1)
        specials = [np.nan, np.inf, -np.inf, -0.0, 7.0, 2.0 ** 31, -2.0 ** 31]
        flat[:len(specials)] = specials[:flat.size]
        return a
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(
        dtype)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_bytes_and_decoder_match_reference(dtype, channels):
    """The port's FileStorage text is the reference's byte for byte (the
    70-column wrap, the float formats, the quoted ``dt``), deflated or
    not; both decoders read either's output to the same array."""
    rng = np.random.default_rng(channels * 10 + DTYPES.index(dtype))
    for rows, cols in ((1, 1), (3, 7), (9, 40), (1, 200)):
        shape = (rows, cols) if channels == 1 else (rows, cols, channels)
        a = _random(rng, dtype, shape)
        for compress in (False, True):
            want = rleg.encode_legacy_mat(a, compress=compress)
            assert tleg.encode_legacy_mat(a, compress=compress) == want
            _same(tleg.decode_legacy_mat(want),
                  rleg.decode_legacy_mat(want))


def test_one_dimensional_and_named_encoding():
    a = np.arange(17, dtype=np.float32) / 3
    for name in ("data", "descriptors", "points"):
        assert (tleg.encode_legacy_mat(a, name, compress=False)
                == rleg.encode_legacy_mat(a, name, compress=False))
    with pytest.raises(ValueError):
        tleg.encode_legacy_mat(np.zeros((2, 2), np.int64))


def test_yaml_1_0_header_and_xml():
    """Older OpenCV's ``%YAML:1.0`` (no ``---``) and FileStorage XML, as
    cv2 writes them, with several matrices."""
    rng = np.random.default_rng(3)
    mats = {"descriptors": rng.integers(0, 256, (5, 32), np.uint8),
            "points": rng.random((1, 5, 3)).astype(np.float32),
            "K": np.array([[525.0, 0, 319.5], [0, 525, 239.5], [0, 0, 1]])}
    for ext in (".yml", ".xml"):
        fs = cv2.FileStorage("x" + ext, cv2.FILE_STORAGE_WRITE
                             | cv2.FILE_STORAGE_MEMORY)
        for k, v in mats.items():
            fs.write(k, v)
        text = fs.releaseAndGetString()
        if ext == ".yml":
            assert text.startswith("%YAML 1.2\n---\n")
            variants = [text, text.replace("%YAML 1.2\n---\n", "%YAML:1.0\n")]
        else:
            variants = [text]
        for t in variants:
            for blob in (t.encode(), zlib.compress(t.encode())):
                for key in mats:
                    _same(tleg.decode_legacy_mat(blob, prefer=key),
                          rleg.decode_legacy_mat(blob, prefer=key))
                for mod in (tleg, rleg):
                    with pytest.raises(mod.LegacyDecodeError,
                                       match="ambiguous"):
                        mod.decode_legacy_mat(blob, prefer="absent")


def test_scalar_entries_are_skipped():
    """A map with scalar entries beside its matrix: the port skips them,
    as the reference means to (``FileNode.mat()`` is None for them); under
    cv2 5.0 the reference's ``mat()`` raises on a scalar node instead
    (ROADMAP queue C, the reference's side)."""
    fs = cv2.FileStorage("x.yml", cv2.FILE_STORAGE_WRITE
                         | cv2.FILE_STORAGE_MEMORY)
    fs.write("data", np.eye(2))
    fs.write("n_views", 4)
    fs.write("note", "captured")
    blob = fs.releaseAndGetString().encode()
    _same(tleg.decode_legacy_mat(blob), np.eye(2))
    with pytest.raises(cv2.error):
        rleg.decode_legacy_mat(blob)


def test_single_matrix_is_taken_whatever_its_key():
    blob = rleg.encode_legacy_mat(np.eye(3), name="calibration")
    _same(tleg.decode_legacy_mat(blob), rleg.decode_legacy_mat(blob))


def test_nd_matrix_and_empty_matrix():
    """cv2 writes a numpy array with more than 512 channels as an
    ``!!opencv-nd-matrix``; an empty matrix decodes to no matrix in
    either package."""
    nd = np.random.default_rng(4).integers(0, 256, (2, 3, 600), np.uint8)
    fs = cv2.FileStorage("x.yml", cv2.FILE_STORAGE_WRITE
                         | cv2.FILE_STORAGE_MEMORY)
    fs.write("data", nd)
    blob = fs.releaseAndGetString().encode()
    assert b"opencv-nd-matrix" in blob
    _same(tleg.decode_legacy_mat(blob), rleg.decode_legacy_mat(blob))
    empty = rleg.encode_legacy_mat(np.zeros((0, 32), np.uint8))
    assert tleg.encode_legacy_mat(np.zeros((0, 32), np.uint8)) == empty
    for mod in (tleg, rleg):
        with pytest.raises(mod.LegacyDecodeError, match="no matrices"):
            mod.decode_legacy_mat(empty)


# ---- the cases of tests/test_migrate.py --------------------------------------

def test_decode_filestorage_yaml_zlib():
    desc = np.random.default_rng(0).integers(0, 256, (40, 32), np.uint8)
    blob = tleg.encode_legacy_mat(desc)
    assert blob[:2] != b"%Y"
    _same(tleg.decode_legacy_mat(blob), desc)


def test_decode_filestorage_yaml_plain_and_float3():
    pts = np.random.default_rng(1).random((1, 17, 3)).astype(np.float32)
    blob = tleg.encode_legacy_mat(pts, compress=False)
    assert blob.lstrip()[:5] == b"%YAML"
    _same(tleg.decode_legacy_mat(blob), rleg.decode_legacy_mat(blob))
    _same(tleg.decode_legacy_mat(blob), pts)


@pytest.mark.parametrize("kind", ["rgb", "u16", "gray", "bgra"])
def test_decode_png_blobs_as_reference(kind):
    """3-channel PNGs come back RGB, 4-channel ones in cv2's BGRA order
    (both as the reference returns them), gray and u16 depth as they
    are."""
    rng = np.random.default_rng(2)
    img = {"rgb": rng.integers(0, 255, (24, 32, 3), np.uint8),
           "u16": rng.integers(0, 5000, (24, 32), np.uint16),
           "gray": rng.integers(0, 255, (24, 32), np.uint8),
           "bgra": rng.integers(0, 255, (24, 32, 4), np.uint8)}[kind]
    png = cv2.imencode(".png", img)[1].tobytes()
    _same(tleg.decode_legacy_mat(png), rleg.decode_legacy_mat(png))
    if kind == "rgb":
        _same(tleg.decode_legacy_mat(png), img[..., ::-1])
    else:
        _same(tleg.decode_legacy_mat(png), img)


def test_jpeg_blob_is_refused_by_name():
    """The reference decodes JPEG through cv2, the port through its own
    decoder (ROADMAP A12g) into the same RGB pixels; what the port's
    decoder does not take (here arithmetic coding) it refuses naming
    JPEG."""
    img = np.random.default_rng(2).integers(0, 255, (16, 16, 3), np.uint8)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    _same(tleg.decode_legacy_mat(jpg), rleg.decode_legacy_mat(jpg))
    sof = jpg.index(b"\xff\xc0")
    arith = jpg[:sof] + b"\xff\xc9" + jpg[sof + 2:]
    with pytest.raises(tleg.LegacyDecodeError, match="JPEG"):
        tleg.decode_legacy_mat(arith)


@pytest.mark.parametrize("depth,channels", [(5, 1), (0, 3), (2, 1), (6, 2)])
def test_decode_raw_header(depth, channels):
    rng = np.random.default_rng(3)
    dtype = tleg._CV_DEPTH_TO_DTYPE[depth]
    a = _random(rng, dtype, (9, 3, channels))
    blob = struct.pack("<iii", 9, 3, depth | ((channels - 1) << 3)) \
        + a.tobytes()
    _same(tleg.decode_legacy_mat(blob), rleg.decode_legacy_mat(blob))
    _same(tleg.decode_legacy_mat(zlib.compress(blob)),
          rleg.decode_legacy_mat(zlib.compress(blob)))


def test_decode_npy_idempotent_and_garbage():
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    _same(tleg.decode_legacy_mat(Document.encode_array(arr)), arr)
    for blob in (b"definitely not a matrix", b"",
                 struct.pack("<iii", 4, 4, 5) + b"\0" * 8):
        for mod in (tleg, rleg):
            with pytest.raises(mod.LegacyDecodeError):
                mod.decode_legacy_mat(blob)


def test_document_decode_array_falls_back_to_legacy():
    desc = np.random.default_rng(4).integers(0, 256, (8, 32), np.uint8)
    _same(Document.decode_array(rleg.encode_legacy_mat(desc)), desc)


# ---- migration -----------------------------------------------------------------

def _documents(root, collection):
    """{doc id: (fields, {name: array})} of a FilesystemDb."""
    db = FilesystemDb(root, collection)
    return {i: (db.load(i).fields, db.load(i).attachments)
            for i in db.all_ids()}


def _same_documents(got, want):
    assert sorted(got) == sorted(want)
    for doc_id, (fields, atts) in want.items():
        assert got[doc_id][0] == fields
        assert sorted(got[doc_id][1]) == sorted(atts)
        for name, arr in atts.items():
            _same(got[doc_id][1][name], arr)


def _dump(tmp_path, n_views=3):
    from tod_tpu.utils.synthetic import (SyntheticObject,
                                         turntable_observations)

    obj = SyntheticObject.make("legacy_obj", seed=11)
    observations = turntable_observations(obj, n_views=n_views,
                                          elevations_deg=(60.0,))
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 256, (120, 32), np.uint8)
    pts = rng.random((120, 3)).astype(np.float32) * 0.2
    dump = str(tmp_path / "dump")
    os.makedirs(dump)
    write_legacy_dump(dump, obj.object_id, observations, desc, pts)
    return dump, obj.object_id, observations, desc, pts


def test_migrate_dump_equals_reference_tool_then_trains(tmp_path):
    """The port's migration of a reference-format dump writes the
    reference tool's documents (fields and npy attachments bit for bit);
    the legacy model loads exactly; the migrated observations train the
    model that the pristine observations train."""
    from tod_tpu_torch.cells.trainer import train_object
    from tod_tpu_torch.db import InMemoryDb, insert_observation
    from tod_tpu_torch.db import observations_for_object

    dump, oid, observations, desc, pts = _dump(tmp_path)
    dst = {"type": "filesystem", "root": str(tmp_path / "db"),
           "collection": "migrated"}
    ref_dst = dict(dst, root=str(tmp_path / "ref_db"))
    stats = tmig.migrate(tmig.iter_dump(dump), json.dumps(dst))
    assert stats == migrate_db.migrate(migrate_db.iter_dump(dump),
                                       json.dumps(ref_dst))
    assert stats == {"documents": 1 + len(observations),
                     "attachments": 2 + 6 * len(observations),
                     "skipped": 0}
    _same_documents(_documents(dst["root"], "migrated"),
                    _documents(ref_dst["root"], "migrated"))

    db = FilesystemDb(dst["root"], "migrated")
    models = load_models_for_objects(db, [oid])
    assert len(models) == 1
    _same(models[0].descriptors, desc)
    _same(models[0].points, pts)

    params = '{"type": "ORB", "n_features": 300}'
    got = train_object(observations_for_object(db, oid), params,
                       device="cpu")
    pristine = InMemoryDb.shared("pristine")
    for obs in observations:
        insert_observation(pristine, oid, obs["frame_number"], obs["image"],
                           obs["depth"], obs["mask"], obs["K"], obs["R"],
                           obs["T"])
    want = train_object(observations_for_object(pristine, oid), params,
                        device="cpu")
    assert len(got[0]) > 50
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_migrate_inline_base64_export_and_new_ids(tmp_path):
    desc = np.random.default_rng(6).integers(0, 256, (30, 32), np.uint8)
    pts = np.random.default_rng(7).random((1, 30, 3)).astype(np.float32)
    dump = str(tmp_path / "dump")
    os.makedirs(dump)
    doc = {"_id": "m0", "_rev": "1-abc", "Type": "Model",
           "object_id": "objX", "method": "TOD",
           "_attachments": {
               name: {"content_type": "text/x-yaml",
                      "data": base64.b64encode(
                          rleg.encode_legacy_mat(a)).decode()}
               for name, a in (("descriptors", desc), ("points", pts))}}
    with open(os.path.join(dump, "m0.json"), "w") as f:
        json.dump(doc, f)
    # an undecodable attachment (a JPEG with no image data) skips its
    # document, in both tools
    bad = {"_id": "j0", "Type": "Observation", "object_id": "objX",
           "_attachments": {"image": {"data": base64.b64encode(
               b"\xff\xd8\xff\xd9").decode()}}}
    with open(os.path.join(dump, "j0.json"), "w") as f:
        json.dump(bad, f)
    dst = {"type": "filesystem", "root": str(tmp_path / "db"),
           "collection": "migrated"}
    stats = tmig.migrate(tmig.iter_dump(dump), json.dumps(dst))
    assert stats == {"documents": 1, "attachments": 2, "skipped": 1}
    models = load_models_for_objects(FilesystemDb(dst["root"], "migrated"),
                                     ["objX"])
    assert len(models) == 1 and models[0].n_points == 30
    _same(models[0].descriptors, desc)
    fresh = dict(dst, root=str(tmp_path / "fresh"))
    tmig.migrate(tmig.iter_dump(dump), json.dumps(fresh), keep_ids=False)
    ids = FilesystemDb(fresh["root"], "migrated").all_ids()
    assert len(ids) == 1 and ids[0] != "m0"


def test_migrate_from_couchdb_equals_reference_tool(tmp_path, couch_url):  # noqa: F811
    """Both tools read the same CouchDB (the in-process fake server) over
    urllib and write the same documents."""
    from urllib import request

    dump, oid, observations, desc, pts = _dump(tmp_path, n_views=2)

    def put(path, body, ctype="application/json"):
        req = request.Request(f"{couch_url}/{path}", data=body, method="PUT",
                              headers={"Content-Type": ctype})
        with request.urlopen(req, timeout=30) as resp:
            resp.read()

    put("legacy", b"")
    for doc_id in sorted(os.listdir(dump)):
        with open(os.path.join(dump, doc_id, "doc.json"), "rb") as f:
            put(f"legacy/{doc_id}", f.read())
        for name in sorted(os.listdir(os.path.join(dump, doc_id))):
            if name != "doc.json":
                with open(os.path.join(dump, doc_id, name), "rb") as f:
                    put(f"legacy/{doc_id}/{name}", f.read(),
                        "application/octet-stream")
    dst = {"type": "filesystem", "root": str(tmp_path / "db"),
           "collection": "c"}
    ref_dst = dict(dst, root=str(tmp_path / "ref"))
    url = f"{couch_url}/legacy"
    assert (tmig.migrate(tmig.iter_couch(url), json.dumps(dst))
            == migrate_db.migrate(migrate_db.iter_couch(url),
                                  json.dumps(ref_dst)))
    _same_documents(_documents(dst["root"], "c"),
                    _documents(ref_dst["root"], "c"))
    assert len(_documents(dst["root"], "c")) == 1 + len(observations)
