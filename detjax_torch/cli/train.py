"""Training CLI of the port, the counterpart of ``detjax/cli/train.py``
(the reference's ``python train.py --dataset coco --depth 50 ...``).

Examples:
  # COCO (needs instances_train2017.json + images)
  python -m detjax_torch.cli.train --preset retinanet_r50_640 \\
      --coco-path /data/coco --steps 90000 --ckpt-dir /tmp/run1

  # self-contained synthetic smoke run (no data needed)
  python -m detjax_torch.cli.train --synthetic --steps 200

  # on the CPU, at a small size
  python -m detjax_torch.cli.train --synthetic --steps 2 --device cpu \\
      --depth 18 --set model.image_size=(64,64)
Any config field is overridable: --set train.learning_rate=1e-4

  # data-parallel on 8 cards, one process a card over NCCL
  python -m torch.distributed.run --nproc_per_node 8 \
      -m detjax_torch.cli.train --preset coco_v5e8 --dp --synthetic

  # the same 8 cards as a (4 data x 2 space) mesh: each image's rows split
  # over two cards
  python -m torch.distributed.run --nproc_per_node 8 \
      -m detjax_torch.cli.train --preset retinanet_r50_1024 --spatial 2 \
      --synthetic

Runs on ``--device`` (default ``cuda``; without a GPU it stops unless
given ``--device cpu``). ``--dp`` trains data-parallel
(``detjax_torch.parallel``): under torchrun, one process a device
(``cuda:LOCAL_RANK`` over NCCL; gloo with ``--device cpu``), each fed its
stride of the data (``make_train_iterator(per_host=True)``), and only rank
0 prints, logs and writes checkpoints; without torchrun, at world size 1
on ``--device``. ``--spatial K`` (implies ``--dp``) makes the mesh
``(data, space=K)``: K must divide the world size, the K ranks of a data
index load the same images and each trains on its block of their rows
(``detjax_torch/models/spatial.py``). detjax's ``--compile-cache`` has
no counterpart: it points XLA's persistent compilation cache at a
directory, and this package compiles no XLA programs (its CUDA kernels
build once per checkout, into ``detjax_torch/_build``).
"""

from __future__ import annotations

import argparse
import contextlib
import os

from detjax_torch.cli.common import parse_overrides


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="retinanet_r50_640")
    ap.add_argument("--depth", type=int, choices=(18, 34, 50, 101, 152),
                    help="backbone depth (the reference's --depth; "
                         "shorthand for --set model.backbone_depth=N)")
    ap.add_argument("--coco-path", help="dir with annotations/ and images/")
    ap.add_argument("--train-ann", help="explicit annotation JSON path")
    ap.add_argument("--train-images", help="explicit image dir")
    ap.add_argument("--val-ann")
    ap.add_argument("--val-images")
    ap.add_argument("--csv-train",
                    help="CSV annotation file (the lineage's --csv_train "
                         "dataset)")
    ap.add_argument("--csv-classes",
                    help="class_name,id CSV (with --csv-train)")
    ap.add_argument("--csv-val", help="CSV annotations for periodic eval")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic dataset (smoke/demo)")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--tensorboard", action="store_true",
                    help="also write TensorBoard scalars under "
                         "<log-dir>/tb")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over torch.distributed: one process "
                         "a device under torchrun, else world size 1")
    ap.add_argument("--spatial", type=int, default=1, metavar="K",
                    help="spatial partitioning: a (data, space=K) mesh, "
                         "each image's rows split over K ranks (implies "
                         "--dp; K must divide the world size)")
    ap.add_argument("--import-backbone",
                    help="torch state_dict .pt with a pretrained ResNet")
    ap.add_argument("--import-detector",
                    help="torch state_dict .pt with a full lineage detector "
                         "(backbone+FPN+heads)")
    ap.add_argument("--eval-images", type=int, default=None,
                    help="cap on periodic-eval images")
    ap.add_argument("--debug", action="store_true",
                    help="torch.autograd anomaly detection (NaN hunting)")
    ap.add_argument("--trace-dir", default="",
                    help="profile the whole run with torch.profiler and "
                         "write a Chrome trace into this dir (keep --steps "
                         "short)")
    ap.add_argument("--unsafe-pickle", action="store_true",
                    help="allow --import-* to unpickle whole-module "
                         "checkpoints (executes code from the file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="group.field=value")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.coco_path or args.train_ann
                                   or args.csv_train):
        ap.error("one of --coco-path, --train-ann, --csv-train or "
                 "--synthetic is required")
    if args.train_ann and not (args.train_images or args.coco_path):
        ap.error("--train-ann needs --train-images (or --coco-path)")
    if args.csv_train and not args.csv_classes:
        ap.error("--csv-train needs --csv-classes")
    mesh, owns_group = None, False
    if args.dp or args.spatial > 1:
        import torch.distributed as dist

        from detjax_torch.parallel.mesh import make_mesh

        # under torchrun a bare --device cuda is cuda:LOCAL_RANK
        had_group = dist.is_initialized()
        mesh = make_mesh([args.device], spatial=args.spatial)
        owns_group = dist.is_initialized() and not had_group
    try:
        return _train(args, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args, mesh):
    import torch

    from detjax_torch.config import get_config
    from detjax_torch.data import (CocoDataset, CSVDataset,
                                   SyntheticDetectionDataset,
                                   make_train_iterator)
    from detjax_torch.train import fit, make_train_state
    from detjax_torch.utils.profiling import trace_context

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = args.device if mesh is None else mesh.device
    if args.debug:
        torch.autograd.set_detect_anomaly(True)
    overrides = parse_overrides(args.overrides)
    if args.depth is not None:
        overrides["model.backbone_depth"] = args.depth
    cfg = get_config(args.preset, **overrides)

    if args.synthetic:
        train_ds = SyntheticDetectionDataset(
            num_images=64, image_size=cfg.model.image_size,
            num_classes=cfg.model.num_classes)
        eval_ds = SyntheticDetectionDataset(
            num_images=16, image_size=cfg.model.image_size,
            num_classes=cfg.model.num_classes, seed=1)
    elif args.csv_train:
        train_ds = CSVDataset(args.csv_train, args.csv_classes,
                              image_dir=args.train_images)
        eval_ds = (CSVDataset(args.csv_val, args.csv_classes,
                              image_dir=args.val_images or args.train_images)
                   if args.csv_val else None)
        if cfg.model.num_classes != train_ds.num_classes:
            overrides["model.num_classes"] = train_ds.num_classes
            cfg = get_config(args.preset, **overrides)
            say(f"num_classes={train_ds.num_classes} (from --csv-classes)")
    else:
        ann = args.train_ann or os.path.join(
            args.coco_path, "annotations",
            f"instances_{cfg.data.train_split}.json")
        imgs = args.train_images or os.path.join(
            args.coco_path, cfg.data.train_split)
        train_ds = CocoDataset(ann, imgs)
        eval_ds = None
        val_ann = args.val_ann or (args.coco_path and os.path.join(
            args.coco_path, "annotations",
            f"instances_{cfg.data.eval_split}.json"))
        if val_ann and os.path.exists(val_ann):
            eval_ds = CocoDataset(
                val_ann, args.val_images or os.path.join(
                    args.coco_path, cfg.data.eval_split))

    state = make_train_state(cfg, seed=cfg.train.seed, device=device)
    if args.import_backbone or args.import_detector:
        from detjax_torch.utils.torch_import import (
            import_full_detector, import_resnet_backbone,
            load_state_dict_file)

        path = args.import_detector or args.import_backbone
        sd = load_state_dict_file(path, allow_pickle=args.unsafe_pickle)
        importer = (import_full_detector if args.import_detector
                    else import_resnet_backbone)
        importer(state, sd)
        what = "detector" if args.import_detector else "backbone"
        say(f"imported pretrained {what} from {path}")

    if mesh is not None and mesh.space > 1:
        say(f"spatial mesh: {mesh.world_size} process(es) as "
            f"({mesh.data_size} data x {mesh.space} space), {mesh.device} "
            f"on rank {mesh.rank}")
    elif mesh is not None:
        say(f"data-parallel mesh: {mesh.world_size} process(es), "
            f"{mesh.device} on rank {mesh.rank}")
    tracing = (trace_context("detjax-train", args.trace_dir)
               if args.trace_dir else contextlib.nullcontext())
    with tracing:
        result = fit(
            cfg, make_train_iterator(train_ds, cfg,
                                     per_host=mesh is not None, mesh=mesh),
            num_steps=args.steps, state=state, eval_dataset=eval_ds,
            eval_max_images=args.eval_images,
            checkpoint_dir=args.ckpt_dir or None,
            log_dir=args.log_dir or None, tensorboard=args.tensorboard,
            mesh=mesh, device=args.device if mesh is None else None)
    say(f"done: step={result.state.step} "
        f"throughput={result.images_per_sec:.1f} img/s")
    return result


if __name__ == "__main__":
    main()
