"""tod: train / detect with ``.ork`` files on the port (the counterpart of
apps/tod, the ``ork training`` / ``ork detection`` analog), and the user
tools: the feature viewer (apps/feature_viewer), the reference-era DB
migration (tools/migrate_db.py) and recording ingest
(tools/ingest_frames.py).

Usage:
  python -m tod_tpu_torch.cli training  -c conf/training.ork
      [--object_ids '["obj1","obj2"]' | all] [--device cuda]
  python -m tod_tpu_torch.cli detection -c conf/detection.ork --frames DIR
      [--niter N] [--timing] [--device cuda] [--profile DIR]
  python -m tod_tpu_torch.cli view <object_id> [--db JSON] [--png PATH]
  python -m tod_tpu_torch.cli migrate --src URL|DIR --dst JSON [--new-ids]
  python -m tod_tpu_torch.cli ingest [--format tum|pairs] SRC OUT [...]

The training command iterates the objects with observations in the
configured DB and runs the TodTrainer pipeline for each. The detection
command builds the .ork graph with the frame source pointed at a directory
of .npz frames (image, depth, K; an empty depth takes the 2D-only path)
and executes it, one frame a scheduler iteration; with ``--profile`` the
loop runs inside a torch.profiler trace written into DIR. ``--device``
reaches every computing cell as a .ork override (the card by default;
``cpu`` runs the kernels' plain twins). The .ork files are read without
pyyaml. ``view``, ``migrate`` and ``ingest`` run on the host; none of
them needs cv2 (``--png`` needs matplotlib, imported only then).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def cmd_training(args) -> int:
    from tod_tpu_torch.db import ObjectDbParameters
    from tod_tpu_torch.models.trainer import TodTrainer
    from tod_tpu_torch.pipeline.ork import _adapt_parameters, load_ork

    specs = load_ork(args.config)
    pipeline_spec = next(s for s in specs.values()
                         if s.get("type") == "TodTrainer")
    raw_params = pipeline_spec.get("parameters", {})
    params = _adapt_parameters("TodTrainer", raw_params)
    params.pop("json_db", None)  # passed explicitly below
    params["device"] = args.device

    db_params = raw_params.get("db", {})
    db = ObjectDbParameters(db_params).generate_db()

    object_ids = args.object_ids or raw_params.get("object_ids", "all")
    if isinstance(object_ids, str) and object_ids.startswith("["):
        object_ids = json.loads(object_ids)
    if object_ids == "all":
        object_ids = sorted({doc.fields["object_id"]
                             for doc in db.query(Type="Observation")})
    if not object_ids:
        print("no objects with observations found in the DB", file=sys.stderr)
        return 1

    for oid in object_ids:
        print(f"*** training object {oid}")
        trainer = TodTrainer("trainer", object_id=oid,
                             json_db=json.dumps(db_params), **params)
        trainer.process()
        print(f"    model document: {trainer.outputs['document_id']}")
    return 0


def cmd_detection(args) -> int:
    from tod_tpu_torch.pipeline.ork import build_pipeline_from_ork, load_ork
    from tod_tpu_torch.pipeline.scheduler import Scheduler

    overrides = {name: {"device": args.device}
                 for name, spec in load_ork(args.config).items()
                 if spec.get("type") == "TodDetector"}
    if args.frames:
        overrides["source1"] = {"path": args.frames, "loop": False}
    pipeline = build_pipeline_from_ork(args.config, overrides)
    n = args.niter
    if n is None:
        src = pipeline.cells.get("source1")
        if src is not None and hasattr(src, "_n_frames"):
            src.ensure_configured()
            n = src._n_frames()
        else:
            n = 1

    sched = Scheduler(pipeline.plasm)
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from tod_tpu_torch.utils.profiling import trace
        profile_ctx = trace(args.profile)
        print(f"capturing a torch.profiler trace -> {args.profile} (a "
              "Chrome trace: Perfetto, chrome://tracing or TensorBoard)",
              file=sys.stderr)
    with profile_ctx:
        for it in range(n):
            sched.execute_iteration()
            det = pipeline.cells.get("pipeline1")
            results = det.outputs["pose_results"] if det else []
            print(f"frame {it}: {len(results)} poses")
            for r in results:
                print(f"  {r.object_id}: "
                      f"T={[round(float(x), 4) for x in r.T]} "
                      f"inliers={int(r.confidence)}")
    if args.timing:
        print(sched.timing_report(), file=sys.stderr)
    return 0


def cmd_view(args) -> int:
    """Summarise an object's TOD model on stdout, as apps/feature_viewer
    does (the reference's Dealer -> ModelReader plasm, its cloud viewer
    replaced by the summary and an optional PNG)."""
    import numpy as np

    from tod_tpu_torch.cells.readers import ModelReader
    from tod_tpu_torch.db import ObjectDbParameters, find_models_for_object

    db_params = json.loads(args.db)
    db = ObjectDbParameters(db_params).generate_db()
    models = find_models_for_object(db, args.object_id, "TOD")
    if not models:
        print("There are no tod models available.", file=sys.stderr)
        return 1

    reader = ModelReader("db_reader", db_params=db_params)
    reader.inputs["model_id"] = models[0].document_id
    reader.ensure_configured()
    reader.process()
    points = reader.outputs["points"].reshape(-1, 3)
    desc = reader.outputs["descriptors"]

    mins, maxs = points.min(0), points.max(0)
    print(f"object_id: {args.object_id}")
    print(f"model document: {models[0].document_id}")
    print(f"points: {len(points)}  descriptors: {desc.shape}")
    print(f"bbox min: {np.round(mins, 4).tolist()}")
    print(f"bbox max: {np.round(maxs, 4).tolist()}")
    print(f"span: {float(np.linalg.norm(maxs - mins)):.4f} m")

    if args.png:
        try:
            import matplotlib
        except ImportError as err:
            raise SystemExit("view --png draws its figure with matplotlib, "
                             "which is not installed") from err
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1,
                   c=points[:, 2], cmap="viridis")
        ax.set_title(f"TOD model: {args.object_id} ({len(points)} features)")
        fig.savefig(args.png, dpi=120)
        print(f"wrote {args.png}")
    return 0


def cmd_migrate(args) -> int:
    from tod_tpu_torch.db.migrate import iter_couch, iter_dump, migrate

    source = (iter_couch(args.src) if args.src.startswith("http")
              else iter_dump(args.src))
    stats = migrate(source, args.dst, keep_ids=not args.new_ids)
    print(json.dumps(stats))
    return 0


def cmd_ingest(args) -> int:
    from tod_tpu_torch.utils.ingest import ingest

    ingest(args)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tod_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("training", help="train TOD models")
    p_train.add_argument("-c", "--config", required=True)
    p_train.add_argument("--object_ids", default=None,
                         help='JSON list of ids or "all"')
    p_train.add_argument("--device", default="cuda",
                         help="torch device to train on (default: cuda)")
    p_train.set_defaults(func=cmd_training)

    p_det = sub.add_parser("detection", help="detect objects in RGB-D frames")
    p_det.add_argument("-c", "--config", required=True)
    p_det.add_argument("--frames", default=None,
                       help="directory of .npz frames (image/depth/K)")
    p_det.add_argument("--niter", type=int, default=None)
    p_det.add_argument("--timing", action="store_true",
                       help="print per-cell timing to stderr")
    p_det.add_argument("--device", default="cuda",
                       help="torch device to detect on (default: cuda)")
    p_det.add_argument("--profile", default=None, metavar="DIR",
                       help="write a torch.profiler trace of the "
                            "detection loop into DIR")
    p_det.set_defaults(func=cmd_detection)

    p_view = sub.add_parser("view", help="summarise an object's TOD model")
    p_view.add_argument("object_id",
                        help="The id of the object whose TOD model to show.")
    p_view.add_argument("--db", default='{"type": "filesystem", '
                        '"root": "/tmp/tod_tpu_db"}',
                        help="DB parameters as a JSON string.")
    p_view.add_argument("--png", default=None,
                        help="Write a 3D scatter rendering to this file "
                             "(needs matplotlib).")
    p_view.set_defaults(func=cmd_view)

    p_mig = sub.add_parser("migrate", help="rewrite a reference-era DB "
                           "(CouchDB or dump) as npy documents")
    p_mig.add_argument("--src", required=True,
                       help="CouchDB database URL (http://host:5984/dbname) "
                            "or dump directory path")
    p_mig.add_argument("--dst", required=True,
                       help="DB parameter JSON ({'type': 'filesystem'|"
                            "'CouchDB'|'mem', ...})")
    p_mig.add_argument("--new-ids", action="store_true",
                       help="assign fresh document ids instead of keeping "
                            "the source ids")
    p_mig.set_defaults(func=cmd_migrate)

    from tod_tpu_torch.utils.ingest import add_arguments
    p_ing = sub.add_parser("ingest", help="convert an RGB-D recording to "
                           "DatasetSource .npz frames")
    add_arguments(p_ing)
    p_ing.set_defaults(func=cmd_ingest)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
