"""Variable-geometry protocol evaluation (``detjax/evaluation/protocol.py``).

The reference evaluates at per-image canvases: the short side scaled to
608 (capped so the long side stays within 1024), bilinear resize, zero pad
at the bottom and right to a multiple of 32. The canvas family is finite,
so images are bucketed by their exact protocol canvas
(``transforms.protocol_canvas``) and each bucket runs in batches of one
shape, ``cfg.eval.batch_size``, the final partial batch padded by
repeating (image_id -1). Every canvas is a multiple of 32 on both sides,
which the fused bottleneck kernels take. Detections map back to original
coordinates through each image's protocol scale.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from detjax_torch.config import Config
from detjax_torch.data.transforms import letterbox_protocol, protocol_canvas
from detjax_torch.evaluation.coco_map import COCOMetric, EvalResult
from detjax_torch.evaluation.evaluator import (
    detections_to_host,
    ground_truths,
    images_disabled,
    per_image,
)


def image_sizes(dataset) -> List[Tuple[int, int]]:
    """Per-index original (H, W), without decoding pixels where possible:
    from a COCO JSON's image entries, else from records with decode
    disabled (datasets with ``load_images``), else from the records."""
    imgs = getattr(dataset, "images", None)
    if isinstance(imgs, list) and imgs and "height" in imgs[0]:
        return [(int(i["height"]), int(i["width"])) for i in imgs]
    sizes = []
    with images_disabled(dataset):
        for i in range(len(dataset)):
            sizes.append(tuple(dataset[i]["size"]))
    return sizes


def bucket_by_canvas(sizes: List[Tuple[int, int]], min_side: int,
                     max_side: int, pad_stride: int = 32
                     ) -> Dict[Tuple[int, int], List[int]]:
    """Group image indices by their exact protocol canvas shape."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx, (h, w) in enumerate(sizes):
        hw, _ = protocol_canvas(h, w, min_side, max_side, pad_stride)
        buckets.setdefault(hw, []).append(idx)
    return buckets


def _bucket_cfg(cfg: Config, canvas_hw: Tuple[int, int]) -> Config:
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=canvas_hw))


def iter_detections_protocol(
    model, dataset, cfg: Config,
    max_images: Optional[int] = None,
    detect_fn_for: Optional[Callable[[Config], Callable]] = None,
    pad_stride: int = 32,
    verbose: bool = False,
):
    """Yield ``(image_id, boxes, scores, labels)`` per image in original
    coordinates, each image detected on its reference-protocol canvas
    (min and max sides from ``cfg.data.eval_scale_minmax``, default (608,
    1024)).

    ``detect_fn_for(bucket_cfg) -> fn(model, canvases_u8)`` overrides the
    detect of each bucket; the default is ``detect_u8`` at the bucket's
    canvas on the model's device.
    """
    from concurrent.futures import ThreadPoolExecutor

    from detjax_torch.data.pipeline import device_prefetch
    from detjax_torch.modeling import _model_device, detect_u8

    minmax = tuple(cfg.data.eval_scale_minmax) or (608, 1024)
    sizes = image_sizes(dataset)
    n = len(sizes) if max_images is None else min(max_images, len(sizes))
    buckets = bucket_by_canvas(sizes[:n], *minmax, pad_stride)
    bs = cfg.eval.batch_size
    dev = _model_device(model, cfg)

    def load(i, hw):
        rec = dataset[i]
        canvas, _, scale = letterbox_protocol(
            rec["image"], rec["boxes"], hw, *minmax)
        return canvas, int(rec["image_id"]), scale

    def host_batches():
        # decode + letterbox threads, as in data.DetectionIterator
        with ThreadPoolExecutor(max(1, cfg.data.host_workers)) as pool:
            for hw in sorted(buckets):
                idxs = buckets[hw]
                if verbose:
                    print(f"  protocol bucket {hw[0]}x{hw[1]}: "
                          f"{len(idxs)} images", flush=True)
                for start in range(0, len(idxs), bs):
                    chunk = idxs[start:start + bs]
                    loaded = list(pool.map(lambda i: load(i, hw), chunk))
                    canvases = [c for c, _, _ in loaded]
                    ids = [i for _, i, _ in loaded]
                    scales = [s for _, _, s in loaded]
                    while len(canvases) < bs:  # one batch shape a bucket
                        canvases.append(canvases[-1])
                        ids.append(-1)
                        scales.append(1.0)
                    yield {"images": np.stack(canvases), "image_id": ids,
                           "scale": scales, "canvas": hw}

    engines: Dict[Tuple[int, int], Callable] = {}

    def engine(hw):
        if hw not in engines:
            bcfg = _bucket_cfg(cfg, hw)
            engines[hw] = (detect_fn_for(bcfg) if detect_fn_for is not None
                           else lambda m, x: detect_u8(m, x, bcfg))
        return engines[hw]

    # split-phase overlap, as in evaluator.iter_detections: batch N+1 is
    # dispatched before batch N's detections are read on the host
    pending = None
    for batch in device_prefetch(host_batches(), dev, keys=("images",)):
        det = engine(batch["canvas"])(model, batch["images"])
        item = (*detections_to_host(det), batch["image_id"], batch["scale"])
        if pending is not None:
            yield from per_image(*pending)
        pending = item
    if pending is not None:
        yield from per_image(*pending)


def run_coco_eval_protocol(
    model, dataset, cfg: Config,
    max_images: Optional[int] = None,
    detect_fn_for: Optional[Callable[[Config], Callable]] = None,
    pad_stride: int = 32,
    verbose: bool = False,
) -> EvalResult:
    """COCO bbox metrics with every image on its reference-protocol
    canvas. Returns :class:`EvalResult`."""
    gts = ground_truths(dataset)
    metric = COCOMetric(category_ids=list(range(cfg.model.num_classes)))
    for img_id, boxes, scores, labels in iter_detections_protocol(
            model, dataset, cfg, max_images, detect_fn_for=detect_fn_for,
            pad_stride=pad_stride, verbose=verbose):
        metric.add(img_id, gts[img_id], boxes, scores, labels)
    return metric.compute()
