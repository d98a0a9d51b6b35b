"""Detection serving CLI of the port (``detjax/cli/serve.py``): checkpoint
-> micro-batching HTTP service.

    python -m detjax_torch.cli.serve --ckpt-dir /run/ckpt --port 8000
    curl -s -X POST --data-binary @photo.jpg localhost:8000/detect

``--engine``: "fp", "int8" (needs ``--int8-calibrate IMAGE...``) or the
path of a saved detect program (``python -m detjax_torch.cli.export``,
exported at ``--batch-size``). ``--mesh`` waits for the parallel slice of
the port; there is no ``--compilation-cache`` flag (nothing here is
compiled by XLA).
"""

from __future__ import annotations

import argparse

from detjax_torch.cli.common import (
    load_calibration_batch,
    load_model,
    parse_overrides,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="retinanet_r50_640_latency")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--engine", default="fp",
                    help="'fp', 'int8', or the path of a saved detect "
                         "program (exported at --batch-size)")
    ap.add_argument("--int8-calibrate", nargs="+", metavar="IMAGE",
                    help="with --engine int8: image files to calibrate PTQ "
                         "activation ranges on (REQUIRED for int8)")
    ap.add_argument("--int8-calib-mode", default="absmax",
                    choices=("absmax", "p999"),
                    help="PTQ activation-range estimator: full abs-max or "
                         "the 99.9th-percentile clip")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="the micro-batch size")
    ap.add_argument("--buckets", type=int, nargs="+", metavar="SIZE",
                    help="canvas bucketing: one engine per square canvas "
                         "size (e.g. --buckets 320 640), each image routed "
                         "to the smallest canvas that holds it unscaled "
                         "(fp/int8 engines)")
    ap.add_argument("--mesh", type=int, nargs="?", const=0, default=None,
                    metavar="N", help="multi-device serving (not ported yet)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="request-coalescing window")
    ap.add_argument("--score-threshold", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="group.field=value")
    return ap


def make_server(args, ap=None):
    """The :class:`DetectionServer` the arguments describe."""
    from detjax_torch.data.coco import COCO_CLASSES
    from detjax_torch.serve import DetectionServer

    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh is not ported yet; multi-device serving comes with the "
            "parallel slice of the port (ROADMAP Queue 1 #5, Parallel)")
    if args.engine == "int8" and not args.int8_calibrate:
        msg = ("--engine int8 requires --int8-calibrate IMAGE... (PTQ "
               "ranges frozen from an arbitrary first request are "
               "unrepresentative and non-reproducible)")
        if ap is not None:
            ap.error(msg)
        raise ValueError(msg)
    cfg, model = load_model(args.preset, args.ckpt_dir,
                            parse_overrides(args.overrides),
                            device=args.device)
    names = (COCO_CLASSES if cfg.model.num_classes == len(COCO_CLASSES)
             else None)
    calibration = None
    if args.int8_calibrate:
        calibration = load_calibration_batch(args.int8_calibrate, cfg,
                                             normalize=False)
        print(f"int8 PTQ calibration: {len(args.int8_calibrate)} image(s)")
    return cfg, DetectionServer(
        model, cfg, engine=args.engine, batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms, score_threshold=args.score_threshold,
        class_names=names, calibration=calibration, buckets=args.buckets,
        int8_calib_mode=args.int8_calib_mode)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg, server = make_server(args, ap)

    import signal
    import threading

    def _terminate(signum, frame):
        # SIGTERM: finish in-flight batches, then exit; shutdown() must
        # not run on the serving thread's frame (its handshake deadlocks)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _terminate)
    print(f"serving {cfg.model.name} ({args.engine}) on "
          f"http://{args.host}:{args.port}  "
          f"[batch={args.batch_size}, window={args.max_wait_ms}ms]",
          flush=True)
    try:
        server.serve(args.host, args.port)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
