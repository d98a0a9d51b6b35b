"""Serving-export CLI of the port (``detjax/cli/export.py``): checkpoint ->
one saved detect program (``detjax_torch/export.py``) with the trained
weights baked in.

    python -m detjax_torch.cli.export detect.pt2 --ckpt-dir /run/ckpt \\
        --batch-size 8 --input u8 --selftest

``--selftest`` reloads the program and diffs it against the live detect
path (the int8 engine's with ``--int8-calibrate``). The program runs on
the device it was exported for (``--platforms cuda`` or ``cpu``; default
``--device``). There is no ``--compilation-cache`` flag: nothing here is
compiled by XLA.
"""

from __future__ import annotations

import argparse
import os

from detjax_torch.cli.common import (
    load_calibration_batch,
    load_model,
    parse_overrides,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", help="output program path (e.g. detect.pt2)")
    ap.add_argument("--preset", default="retinanet_r50_640")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--platforms", default="",
                    help="the one device the program is exported for: "
                         "'cuda' or 'cpu' (default: --device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model is loaded on")
    ap.add_argument("--selftest", action="store_true",
                    help="reload the program and diff vs the live detect")
    ap.add_argument("--int8-calibrate", nargs="+", metavar="IMAGE",
                    help="PTQ-quantize on these image files and export the "
                         "int8 engine's program instead of the fp one")
    ap.add_argument("--int8-calib-mode", default="absmax",
                    choices=("absmax", "p999"),
                    help="PTQ activation-range estimator: full abs-max or "
                         "the 99.9th-percentile clip")
    ap.add_argument("--input", default="fp32", choices=("fp32", "u8"),
                    help="program input: normalized fp32 images, or raw "
                         "uint8 canvases with the mean/std normalization "
                         "inside the program")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="group.field=value")
    return ap


def selftest(path: str, model, cfg, batch_size: int, input_format: str,
             calibration=None, calib_mode: str = "absmax") -> bool:
    """The reloaded program against the live engine on seeded inputs:
    the same detection counts, and the shared top of each image's score
    distribution within 2e-2 (detjax's selftest bar)."""
    import numpy as np
    import torch

    from detjax_torch.export import load_detect
    from detjax_torch.modeling import detect, detect_u8

    h, w = cfg.model.image_size
    rng = np.random.default_rng(1)
    if input_format == "u8":
        images = rng.integers(0, 256, (batch_size, h, w, 3), np.uint8)
    else:
        images = rng.uniform(0, 1, (batch_size, h, w, 3)).astype(np.float32)
    served = load_detect(path)(images)
    if calibration is not None:
        from detjax_torch import quant

        qtree = quant.quantize_model(model, cfg, calibration,
                                     calib_mode=calib_mode)
        live = (quant.detect_int8_u8(qtree, images, cfg)
                if input_format == "u8"
                else quant.detect_int8(qtree, images, cfg))
    elif input_format == "u8":
        live = detect_u8(model, images, cfg)
    else:
        live = detect(model, torch.from_numpy(images).to(
            model.compute_dtype), cfg)
    nv_s = served.num_valid.cpu().numpy()
    nv_l = live.num_valid.cpu().numpy()
    sc_s = np.sort(served.scores.cpu().numpy(), axis=-1)
    sc_l = np.sort(live.scores.cpu().numpy(), axis=-1)
    max_delta, ok = 0.0, True
    for i in range(len(nv_s)):
        k = int(min(nv_s[i], nv_l[i]))
        d = 0.0 if k == 0 else float(np.abs(sc_s[i, -k:] - sc_l[i, -k:]).max())
        max_delta = max(max_delta, d)
        ok = ok and abs(int(nv_s[i]) - int(nv_l[i])) <= 1 and d < 2e-2
    print(f"selftest: counts within +-1 and shared score distribution within "
          f"2e-2 -> {'OK' if ok else 'MISMATCH'} (max score delta "
          f"{max_delta:.2e})")
    return ok


def main(argv=None):
    args = build_parser().parse_args(argv)
    from detjax_torch.export import save_detect

    cfg, model = load_model(args.preset, args.ckpt_dir,
                            parse_overrides(args.overrides),
                            device=args.device)
    calibration = None
    if args.int8_calibrate:
        calibration = load_calibration_batch(args.int8_calibrate, cfg)
        print(f"int8 PTQ calibrated on {len(args.int8_calibrate)} image(s)")
    platforms = tuple(p for p in args.platforms.split(",") if p) or None
    save_detect(args.out, model, cfg, batch_size=args.batch_size,
                platforms=platforms, calibration=calibration,
                input_format=args.input, calib_mode=args.int8_calib_mode)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"batch={args.batch_size}, image={cfg.model.image_size}, "
          f"input={args.input})")
    if args.selftest and not selftest(
            args.out, model, cfg, args.batch_size, args.input, calibration,
            args.int8_calib_mode):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
