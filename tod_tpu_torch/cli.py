"""tod: train / detect with ``.ork`` files on the port (the counterpart of
apps/tod, the ``ork training`` / ``ork detection`` analog).

Usage:
  python -m tod_tpu_torch.cli training  -c conf/training.ork
      [--object_ids '["obj1","obj2"]' | all] [--device cuda]
  python -m tod_tpu_torch.cli detection -c conf/detection.ork --frames DIR
      [--niter N] [--timing] [--device cuda] [--profile DIR]

The training command iterates the objects with observations in the
configured DB and runs the TodTrainer pipeline for each. The detection
command builds the .ork graph with the frame source pointed at a directory
of .npz frames (image, depth, K; an empty depth takes the 2D-only path)
and executes it, one frame a scheduler iteration; with ``--profile`` the
loop runs inside a torch.profiler trace written into DIR. ``--device``
reaches every computing cell as a .ork override (the card by default;
``cpu`` runs the kernels' plain twins). The .ork files are read without
pyyaml.
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

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
