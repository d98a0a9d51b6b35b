"""COCO evaluation CLI of the port (``detjax/cli/evaluate.py``): restore a
checkpoint, run batched inference over a val set, print the 12 COCO bbox
stats (or VOC per-class AP with ``--voc``).

    python -m detjax_torch.cli.evaluate --ckpt-dir /run/ckpt \\
        --ann instances_val2017.json --images val2017/

``--int8`` evaluates through the int8 PTQ engine (calibrated on the first
eval batch; with ``--protocol`` once at the preset's canvas, then every
protocol bucket from the same qtree). Runs on ``--device`` (default
``cuda``). There is no ``--compilation-cache`` flag (nothing here is
compiled by XLA).
"""

from __future__ import annotations

import argparse
import sys

from detjax_torch.cli.common import load_model, parse_overrides


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="retinanet_r50_640")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ann", help="instances_val2017.json path")
    ap.add_argument("--images", help="val image dir")
    ap.add_argument("--csv", help="CSV annotation file (the lineage's "
                                  "csv_eval path)")
    ap.add_argument("--class-map", help="class_name,id CSV (with --csv)")
    ap.add_argument("--voc", action="store_true",
                    help="VOC-style per-class AP@0.5 instead of COCO stats")
    ap.add_argument("--int8", action="store_true",
                    help="evaluate through the int8 PTQ engine (calibrates "
                         "on the first eval batch)")
    ap.add_argument("--int8-calib-mode", default="absmax",
                    choices=("absmax", "p999"),
                    help="PTQ activation-range estimator: full abs-max or "
                         "the 99.9th-percentile clip")
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the EMA shadow params (train.ema_decay>0 "
                         "checkpoint; pass the same --set here)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--protocol", action="store_true",
                    help="evaluate each image at its reference protocol "
                         "canvas (min/max from data.eval_scale_minmax, "
                         "bucketed engines) instead of one fixed canvas")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--set", action="append", dest="overrides")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.int8 and args.voc:
        ap.error("--int8 is only wired for the COCO path")
    if args.protocol and args.voc:
        ap.error("--protocol is a COCO-path option")

    from detjax_torch.data import (CocoDataset, CSVDataset,
                                   SyntheticDetectionDataset)
    from detjax_torch.evaluation import run_coco_eval
    from detjax_torch.evaluation.evaluator import run_voc_eval

    user = parse_overrides(args.overrides)
    cfg, model = load_model(args.preset, args.ckpt_dir, user,
                            use_ema=args.ema, device=args.device)
    if args.synthetic:
        ds = SyntheticDetectionDataset(
            num_images=32, image_size=cfg.model.image_size,
            num_classes=cfg.model.num_classes, seed=1)
    elif args.csv:
        ds = CSVDataset(args.csv, args.class_map, image_dir=args.images)
    else:
        ds = CocoDataset(args.ann, args.images)

    if args.voc:
        res = run_voc_eval(model, ds, cfg, max_images=args.max_images)
        for k, v in res.items():
            print(f"{k}: {v:.4f}")
        return res

    from detjax_torch import quant

    if args.protocol:
        import dataclasses

        from detjax_torch.evaluation import run_coco_eval_protocol

        # evaluator-grade candidate budget unless the user set one: the
        # reference's eval branch keeps every score > 0.05 pair
        if ("eval.pre_nms_top_k" not in user
                and "eval.exact_candidates" not in user):
            cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
                cfg.eval, pre_nms_top_k=16384, exact_candidates=True))
            print("--protocol: evaluator-grade candidate budget "
                  "(pre_nms_top_k=16384, exact oracle selection; "
                  "--set eval.pre_nms_top_k=... to override)",
                  file=sys.stderr)
        detect_fn_for = None
        if args.int8:
            # calibrate once at the preset's fixed canvas, then serve
            # every protocol bucket from the same qtree
            import torch

            from detjax_torch.data.pipeline import (make_eval_iterator,
                                                    normalize_u8)

            batch = next(iter(make_eval_iterator(ds, cfg)))
            imgs = normalize_u8(torch.as_tensor(batch["images"]),
                                cfg.data.mean, cfg.data.std)
            qtree = quant.quantize_model(model, cfg, imgs,
                                         calib_mode=args.int8_calib_mode)

            def detect_fn_for(bcfg, qt=qtree):
                return lambda _m, u8: quant.detect_int8_u8(qt, u8, bcfg)
        res = run_coco_eval_protocol(
            model, ds, cfg, max_images=args.max_images,
            detect_fn_for=detect_fn_for, verbose=True)
    else:
        detect_fn = None
        if args.int8:
            qstate = {}

            def detect_fn(_model, x):
                # lazy PTQ: calibrate on the first eval batch
                if "q" not in qstate:
                    print("int8: calibrating PTQ activation ranges on the "
                          "first eval batch; results depend on eval-set "
                          "order", file=sys.stderr)
                    qstate["q"] = quant.quantize_model(
                        model, cfg, x, calib_mode=args.int8_calib_mode)
                return quant.detect_int8(qstate["q"], x, cfg)
        res = run_coco_eval(model, ds, cfg, max_images=args.max_images,
                            detect_fn=detect_fn)
    for k, v in res.stats.items():
        print(f"{k:>6}: {v:.4f}")
    return res


if __name__ == "__main__":
    main()
