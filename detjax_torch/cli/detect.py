"""Detection demo CLI of the port (``detjax/cli/detect.py``): run the detect
path on image files and save box-annotated copies.

    python -m detjax_torch.cli.detect photo.jpg --ckpt-dir /run/ckpt

``--int8`` serves through the int8 PTQ engine, calibrated on the first
input image. Runs on ``--device`` (default ``cuda``). There is no
``--compilation-cache`` flag (nothing here is compiled by XLA).
"""

from __future__ import annotations

import argparse
import os
import sys

from detjax_torch.cli.common import load_model, parse_overrides


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("images", nargs="+", help="input image file(s)")
    ap.add_argument("--preset", default="retinanet_r50_640")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out-dir", default="detections")
    ap.add_argument("--score-threshold", type=float, default=0.3)
    ap.add_argument("--int8", action="store_true",
                    help="serve through the int8 PTQ engine (calibrates on "
                         "the first input image)")
    ap.add_argument("--int8-calib-mode", default="absmax",
                    choices=("absmax", "p999"),
                    help="PTQ activation-range estimator: full abs-max or "
                         "the 99.9th-percentile clip")
    ap.add_argument("--ema", action="store_true",
                    help="use the EMA shadow params (train.ema_decay>0 "
                         "checkpoint; pass the same --set here)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="group.field=value")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from detjax_torch.data.coco import COCO_CLASSES
    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.data.transforms import letterbox
    from detjax_torch.modeling import detect
    from detjax_torch.utils.visualize import draw_detections

    cfg, model = load_model(args.preset, args.ckpt_dir,
                            parse_overrides(args.overrides),
                            use_ema=args.ema, device=args.device)
    names = (COCO_CLASSES if cfg.model.num_classes == len(COCO_CLASSES)
             else None)
    dev = next(model.parameters()).device
    os.makedirs(args.out_dir, exist_ok=True)
    qtree = None
    written = []
    for path in args.images:
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        canvas, _, scale = letterbox(img, np.zeros((0, 4), np.float32),
                                     cfg.model.image_size)
        x = normalize_u8(torch.from_numpy(canvas)[None].to(dev),
                         cfg.data.mean, cfg.data.std, model.compute_dtype)
        if args.int8:
            from detjax_torch import quant

            if qtree is None:
                print("int8: calibrating PTQ activation ranges on "
                      f"{path} (first input image); detections for other "
                      "images depend on this image's activation ranges",
                      file=sys.stderr)
                qtree = quant.quantize_model(
                    model, cfg, x, calib_mode=args.int8_calib_mode)
            det = quant.detect_int8(qtree, x, cfg)
        else:
            det = detect(model, x, cfg)
        nv = int(det.num_valid[0])
        boxes = det.boxes[0, :nv].cpu().numpy() / scale
        out = draw_detections(img, boxes, det.scores[0, :nv].cpu().numpy(),
                              det.labels[0, :nv].cpu().numpy(), names,
                              args.score_threshold)
        dst = os.path.join(args.out_dir, os.path.basename(path))
        Image.fromarray(out).save(dst)
        written.append(dst)
        print(f"{path}: {nv} detections -> {dst}")
    return written


if __name__ == "__main__":
    main()
