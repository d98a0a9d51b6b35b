"""Detection serving CLI of the port (``detjax/cli/serve.py``): checkpoint
-> micro-batching HTTP service.

    python -m detjax_torch.cli.serve --ckpt-dir /run/ckpt --port 8000
    curl -s -X POST --data-binary @photo.jpg localhost:8000/detect

``--engine``: "fp", "int8" (needs ``--int8-calibrate IMAGE...``) or the
path of a saved detect program (``python -m detjax_torch.cli.export``,
exported at ``--batch-size``). ``--mesh [N]`` serves over the first N
local CUDA devices (all without N): one replica of the model on each, every
batch split between them (fp and int8 engines). There is no
``--compilation-cache`` flag (nothing here is compiled by XLA).
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
                    metavar="N",
                    help="serve over N local CUDA devices (all without N), "
                         "each batch split between them")
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

    mesh = None
    if args.mesh is not None:
        import torch

        from detjax_torch.parallel.mesh import make_mesh

        avail = torch.cuda.device_count()
        n = avail if args.mesh == 0 else args.mesh
        if not 0 < n <= avail:
            # a silent slice would serve on fewer devices than asked for
            msg = (f"--mesh {args.mesh}: need 1..{avail} "
                   f"(available CUDA devices: {avail})")
            if ap is not None:
                ap.error(msg)
            raise ValueError(msg)
        mesh = make_mesh([f"cuda:{i}" for i in range(n)])
        print(f"serving mesh: {n} device(s)")
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
        mesh=mesh, int8_calib_mode=args.int8_calib_mode)


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
