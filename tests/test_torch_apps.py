"""The port's user tools through ``python -m tod_tpu_torch.cli`` against
the reference's on the CPU: ``view`` against apps/feature_viewer (stdout
character for character, the ``--png`` figure), ``migrate`` against
tools/migrate_db.py and ``ingest`` against tools/ingest_frames.py (their
outputs bit for bit)."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import tod_tpu.db as rdb
from tod_tpu_torch import cli
from tod_tpu_torch.db import FilesystemDb
from test_ingest import _render_frames, _write_tum
from test_torch_legacy import _documents, _dump, _same_documents

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import ingest_frames  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _run(args, **kw):
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=ENV, cwd=ROOT, timeout=300, **kw)


@pytest.fixture(scope="module")
def model_db(tmp_path_factory):
    """Two models written by the reference into one FilesystemDb."""
    root = str(tmp_path_factory.mktemp("view_db"))
    db = rdb.FilesystemDb(root)
    rng = np.random.default_rng(2)
    for oid, n in (("obj000", 700), ("obj001", 90)):
        rdb.write_model(db, oid, rng.integers(0, 256, (n, 32), np.uint8),
                        (rng.normal(size=(n, 3)) * 0.05
                         + (0.1, -0.2, 0.7)).astype(np.float32))
    return json.dumps({"type": "filesystem", "root": root})


@pytest.mark.parametrize("object_id", ["obj000", "obj001", "absent"])
def test_view_prints_the_reference_text(model_db, object_id):
    want = _run([os.path.join(ROOT, "apps", "feature_viewer"), object_id,
                 "--db", model_db])
    got = _run(["-m", "tod_tpu_torch.cli", "view", object_id, "--db",
                model_db])
    assert got.returncode == want.returncode == (1 if object_id == "absent"
                                                 else 0)
    assert got.stdout == want.stdout
    if object_id == "absent":
        assert got.stderr.strip() == "There are no tod models available."
    else:
        assert f"object_id: {object_id}" in got.stdout


def test_view_png_draws_the_reference_figure(model_db, tmp_path):
    pytest.importorskip("matplotlib")
    want, got = str(tmp_path / "ref.png"), str(tmp_path / "port.png")
    r = _run([os.path.join(ROOT, "apps", "feature_viewer"), "obj001",
              "--db", model_db, "--png", want])
    p = _run(["-m", "tod_tpu_torch.cli", "view", "obj001", "--db", model_db,
              "--png", got])
    assert r.returncode == p.returncode == 0, p.stderr
    assert p.stdout == r.stdout.replace(want, got)
    np.testing.assert_array_equal(cv2.imread(got), cv2.imread(want))


NO_MATPLOTLIB = r"""
import sys
sys.modules["matplotlib"] = None
sys.modules["cv2"] = None
from tod_tpu_torch import cli
sys.exit(cli.main(["view", "obj001", "--db", sys.argv[1], "--png",
                   sys.argv[2]]))
"""


def test_view_png_without_matplotlib_names_it(model_db, tmp_path):
    """The card's machine has no matplotlib: the summary still prints,
    then ``--png`` stops with an error that names matplotlib."""
    r = _run(["-c", NO_MATPLOTLIB, model_db, str(tmp_path / "x.png")])
    assert r.returncode != 0
    assert "points: 90" in r.stdout
    assert "matplotlib" in r.stderr
    assert not (tmp_path / "x.png").exists()


def test_migrate_command_equals_reference_tool(tmp_path):
    dump = _dump(tmp_path, n_views=2)[0]
    dst = {"type": "filesystem", "root": str(tmp_path / "port"),
           "collection": "m"}
    ref = dict(dst, root=str(tmp_path / "ref"))
    got = _run(["-m", "tod_tpu_torch.cli", "migrate", "--src", dump,
                "--dst", json.dumps(dst)])
    want = _run([os.path.join(ROOT, "tools", "migrate_db.py"), "--src", dump,
                 "--dst", json.dumps(ref)])
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert json.loads(got.stdout) == {"documents": 3, "attachments": 14,
                                      "skipped": 0}
    assert got.stderr == want.stderr
    _same_documents(_documents(dst["root"], "m"), _documents(ref["root"], "m"))
    fresh = dict(dst, root=str(tmp_path / "fresh"))
    assert cli.main(["migrate", "--src", dump, "--dst", json.dumps(fresh),
                     "--new-ids"]) == 0
    assert not set(FilesystemDb(fresh["root"], "m").all_ids()) & set(
        FilesystemDb(dst["root"], "m").all_ids())


def _same_frames(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        x, y = np.load(os.path.join(a, n)), np.load(os.path.join(b, n))
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_ingest_tum_equals_reference_tool(tmp_path, capsys):
    frames = _render_frames(3)
    rec = tmp_path / "rec"
    rec.mkdir()
    _write_tum(rec, frames)
    args = [str(rec), "--format", "tum", "--fx", "520.5", "--cy", "241.0"]
    n = ingest_frames.main([args[0], str(tmp_path / "ref")] + args[1:])
    assert cli.main(["ingest", args[0], str(tmp_path / "port")]
                    + args[1:]) == 0
    assert n == 3
    assert capsys.readouterr().out.count("wrote 3 frames") == 2
    _same_frames(tmp_path / "port", tmp_path / "ref")


@pytest.mark.parametrize("scale,limit", [("10000", "0"), ("1000", "1")])
def test_ingest_pairs_equals_reference_tool(tmp_path, scale, limit):
    """Paired 8-bit color (and one gray and one 16-bit color image, which
    cv2's IMREAD_COLOR converts) with depth in other units."""
    frames = _render_frames(3)
    rec = tmp_path / "rec"
    rec.mkdir()
    for i, (image, depth_mm) in enumerate(frames):
        color = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
        if i == 1:
            color = color[..., 1]
        if i == 2:
            color = color.astype(np.uint16) * 257 + 3
        cv2.imwrite(str(rec / f"color_{i:04d}.png"), color)
        cv2.imwrite(str(rec / f"depth_{i:04d}.png"),
                    (depth_mm.astype(np.float64) * float(scale) / 1000.0
                     ).astype(np.uint16))
    args = ["--format", "pairs", "--depth-scale", scale, "--limit", limit]
    ingest_frames.main([str(rec), str(tmp_path / "ref")] + args)
    cli.main(["ingest", str(rec), str(tmp_path / "port")] + args)
    _same_frames(tmp_path / "port", tmp_path / "ref")


def test_ingest_errors_match_reference_tool(tmp_path):
    """A pair mismatch stops both tools alike; a JPEG frame (even one
    named ``.png``), which the reference reads through cv2, is read by the
    port's own decoder into the same frames (ROADMAP A12g)."""
    (tmp_path / "color_0000.png").write_bytes(b"")
    for main in (ingest_frames.main, lambda a: cli.main(["ingest"] + a)):
        with pytest.raises(SystemExit, match="pair mismatch"):
            main([str(tmp_path), str(tmp_path / "o"), "--format", "pairs"])
    image, depth = _render_frames(1)[0]
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    cv2.imwrite(str(jpg / "color_0000.png.jpg"), image)
    os.replace(jpg / "color_0000.png.jpg", jpg / "color_0000.png")
    cv2.imwrite(str(jpg / "depth_0000.png"), depth)
    assert ingest_frames.main([str(jpg), str(tmp_path / "r"), "--format",
                               "pairs"]) == 1
    assert cli.main(["ingest", str(jpg), str(tmp_path / "p"), "--format",
                     "pairs"]) == 0
    _same_frames(tmp_path / "p", tmp_path / "r")
    # what neither reads stops both
    (jpg / "color_0000.png").write_bytes(b"\xff\xd8\xff\xd9")
    for main in (ingest_frames.main, lambda a: cli.main(["ingest"] + a)):
        with pytest.raises(SystemExit, match="unreadable color image"):
            main([str(jpg), str(tmp_path / "x"), "--format", "pairs"])
