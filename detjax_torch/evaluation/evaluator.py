"""End-to-end COCO and VOC evaluation over the port's detect path
(``detjax/evaluation/evaluator.py``).

Batches of letterboxed uint8 canvases from ``make_eval_iterator`` (host
threads decode and resize) reach the model's device through
``device_prefetch`` (pinned memory, a side CUDA stream), run through
``detect_u8`` (normalize, forward, candidate selection, the NMS kernel on
a GPU), and come back as fixed-size ``Detections``, which are copied into
pinned host memory behind the work that makes them. Boxes are mapped back
to original image coordinates through the letterbox scale and scored by
the in-repo COCOeval (``coco_map.py``) or the VOC evaluator (``voc.py``).

Split-phase overlap: batch N+1 is dispatched before batch N's detections
are read on the host, and the host then waits for batch N's copy only,
so the device computes N+1 while the host matches N. The detect path
makes no host sync of its own.

Ground truth is built once, before the iterator starts its threads, in
one annotation-only pass; nothing toggles ``load_images`` while loader
threads read the dataset.

Sharded over a ``mesh`` (``detjax_torch.parallel``, config 5's periodic
evaluation): each rank of a multi-process mesh detects its contiguous
rows of every batch and the fixed-size ``Detections`` are all-gathered
back into batch order, so that every rank scores the same set; a
single-process mesh splits every batch over its devices, each with a
replica of the model, and gathers the slices in order. On a ``(data,
space)`` mesh a rank detects its data index's images cut to its own image
rows (``models/spatial.py``: halo exchanges, the head outputs gathered
over the space group, NMS on the gathered candidates on each rank), and
the Detections are gathered over the data axis only: over every rank
each image would appear S times. A single-process ``(data, space)`` mesh
does the same with a thread a device (``parallel/mesh.py::RowRunner``).
Another engine (``detect_fn``, e.g. the evaluate CLI's int8 engine) runs
on the rows too: the int8 traversal exchanges its own halos
(``quant.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from detjax_torch.config import Config
from detjax_torch.evaluation.coco_map import COCOMetric, EvalResult, GroundTruth
from detjax_torch.ops.nms import Detections

@contextlib.contextmanager
def images_disabled(dataset):
    """Skip image decode for annotation-only record access (datasets that
    expose ``load_images``)."""
    if hasattr(dataset, "load_images"):
        old = dataset.load_images
        dataset.load_images = False
        try:
            yield
        finally:
            dataset.load_images = old
    else:
        yield


def ground_truths(dataset) -> Dict[int, GroundTruth]:
    """image_id -> GroundTruth in original image coordinates, for every
    record, from one annotation-only pass. A dataset with
    ``load_annotations`` (COCO) gives every annotation of the image,
    degenerate boxes included, as COCOeval keeps them; any other gives
    its record's boxes, labels, crowd flags and areas."""
    gts: Dict[int, GroundTruth] = {}
    with images_disabled(dataset):
        for i in range(len(dataset)):
            rec = dataset[i]
            image_id = int(rec["image_id"])
            if hasattr(dataset, "load_annotations"):
                rec = dataset.load_annotations(image_id)
            gts[image_id] = GroundTruth(
                boxes=rec["boxes"], labels=rec["labels"],
                iscrowd=rec.get("iscrowd"), areas=rec.get("areas"))
    return gts


def detections_to_host(det: Detections):
    """Queue the copy of ``det`` into pinned host memory behind the work
    that makes it; returns ``(host Detections, event)``, the event None
    off CUDA. Read the host tensors only after ``event.synchronize()``."""
    if det.boxes.device.type != "cuda":
        return det, None
    host = Detections(*(t.to("cpu", non_blocking=True) for t in det))
    done = torch.cuda.Event()
    done.record()
    return host, done


def per_image(host_det, done, image_ids, scales):
    """``(image_id, boxes, scores, labels)`` per real image of a batch,
    boxes divided by the image's scale; ids below 0 mark padding."""
    if done is not None:
        done.synchronize()
    boxes = host_det.boxes.numpy()
    scores = host_det.scores.numpy()
    labels = host_det.labels.numpy()
    num_valid = host_det.num_valid.numpy()
    for i, img_id in enumerate(image_ids):
        img_id = int(img_id)
        if img_id < 0:
            continue
        nv = int(num_valid[i])
        yield (img_id, boxes[i, :nv] / float(scales[i]), scores[i, :nv],
               labels[i, :nv])


def iter_detections(model, dataset, cfg: Config,
                    max_images: Optional[int] = None,
                    detect_fn: Optional[Callable] = None,
                    mesh=None):
    """Yield ``(image_id, boxes, scores, labels)`` per image in original
    image coordinates, through ``detect_u8`` on the model's device.

    ``detect_fn(model, images) -> Detections`` overrides the path; it gets
    normalized NHWC images in the model's dtype on the model's device.
    ``mesh`` shards every batch over the mesh's data axis (see the module
    docstring); ``eval.batch_size`` must divide over it. A multi-process
    mesh takes the model on the rank's device."""
    from detjax_torch.data.pipeline import (
        device_prefetch,
        make_eval_iterator,
        normalize_u8,
    )
    from detjax_torch.modeling import _model_device, detect_u8

    dev = _model_device(model, cfg)

    def detect_on(replica, images):
        if detect_fn is None:
            return detect_u8(replica, images, cfg)
        x = normalize_u8(images, cfg.data.mean, cfg.data.std,
                         replica.compute_dtype)
        return detect_fn(replica, x)

    batches = make_eval_iterator(dataset, cfg)
    close = None
    if mesh is None:
        def dispatch(images):
            return detect_on(model, images)
    else:
        dispatch, batches = _sharded_dispatch(model, dev, batches, cfg, mesh,
                                              detect_on)
        close = getattr(dispatch, "close", None)
    if mesh is None or mesh.multi_process:
        batches = device_prefetch(batches, dev, keys=("images",))
    try:
        yield from _detections(batches, dispatch, max_images)
    finally:
        if close is not None:
            close()


def _detections(batches, dispatch, max_images):
    """iter_detections' loop: dispatch batch N+1 before reading N."""
    n_done = 0
    n_dispatched = 0  # images in flight, an upper bound on those to yield
    pending = None
    for batch in batches:
        if max_images is not None and n_dispatched >= max_images:
            break  # enough images in flight
        det = detections_to_host(dispatch(batch["images"]))
        n_dispatched += len(batch["image_id"])
        if pending is not None:
            for item in per_image(*pending):
                yield item
                n_done += 1
                if max_images is not None and n_done >= max_images:
                    return
        pending = (*det, batch["image_id"], batch["scale"])
    if pending is not None:
        for item in per_image(*pending):
            yield item
            n_done += 1
            if max_images is not None and n_done >= max_images:
                return


def _sharded_dispatch(model, dev, batches, cfg: Config, mesh, detect_on):
    """``(dispatch, batches)`` for a sharded evaluation: ``dispatch(images)``
    gives the whole batch's Detections on ``dev``. A multi-process mesh
    hands the rank its data index's contiguous rows of each batch (picked
    on the host, before the copy; cut to its image rows on a ``space``
    axis) and all-gathers the Detections over the data axis in order; a
    single-process mesh splits each batch over its devices' replicas and
    gathers the slices on ``dev`` in order, on a ``space`` axis through a
    ``RowRunner`` (whose ``close`` the caller calls). The canvas is
    checked against the space axis before any exchange."""
    from detjax_torch.models import spatial
    from detjax_torch.parallel.mesh import (RowRunner, check_mesh,
                                             replicate, split_over)

    check_mesh(mesh)
    b = cfg.eval.batch_size
    if b % mesh.data_size:
        raise ValueError(f"eval.batch_size={b} must be divisible by the "
                         f"mesh's data axis ({mesh.data_size} devices)")
    part = b // mesh.data_size
    if mesh.space > 1:
        spatial.check_canvas_rows(cfg.model.image_size[0], mesh.space)
    if mesh.multi_process:
        if dev != mesh.device:
            raise ValueError(f"the model is on {dev}, this rank's mesh "
                             f"device is {mesh.device}")
        lo = mesh.data_rank * part
        cut = mesh.image_rows(cfg.model.image_size[0])

        def rows(batches):
            for batch in batches:
                yield dict(batch, images=batch["images"][lo:lo + part, cut])

        def dispatch(images):
            with spatial.space_group(mesh.space_context()):
                det = detect_on(model, images)
            return Detections(*(_all_gather(t, mesh) for t in det))

        return dispatch, rows(batches)
    replicas = replicate(model, mesh)
    if mesh.space > 1:
        return RowRunner(dev, mesh, lambda rep, x: detect_on(
            rep, torch.as_tensor(x).to(next(rep.parameters()).device)),
            replicas), batches
    runs = [(lambda x, rep=rep, d=d: detect_on(rep, torch.as_tensor(x).to(d)))
            for rep, d in zip(replicas, mesh.devices)]
    return split_over(dev, runs), batches


def _all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ``t`` of every rank of the data axis (those of this rank's
    space index), stacked along dim 0 in data order."""
    import torch.distributed as dist

    group = mesh.data_group if mesh.space > 1 else mesh.group
    parts = [torch.empty_like(t) for _ in range(mesh.data_size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def run_coco_eval(model, dataset, cfg: Config,
                  max_images: Optional[int] = None,
                  detect_fn: Optional[Callable] = None,
                  mesh=None) -> EvalResult:
    """Detect over ``dataset`` and compute the 12 COCO bbox stats and the
    per-class AP; ``result["AP"]`` is mAP@[.5:.95]."""
    gts = ground_truths(dataset)
    metric = COCOMetric(category_ids=list(range(cfg.model.num_classes)))
    for img_id, boxes, scores, labels in iter_detections(
            model, dataset, cfg, max_images, detect_fn=detect_fn,
            mesh=mesh):
        metric.add(img_id, gts[img_id], boxes, scores, labels)
    return metric.compute()


def run_voc_eval(model, dataset, cfg: Config, iou_threshold: float = 0.5,
                 max_images: Optional[int] = None):
    """VOC-style per-class AP over ``dataset`` (the lineage's csv_eval
    protocol). Returns ``{"mAP", "AP/<class>"}``."""
    from detjax_torch.evaluation.voc import evaluate_voc

    gts = ground_truths(dataset)
    gt_sel, dets = {}, {}
    for img_id, boxes, scores, labels in iter_detections(
            model, dataset, cfg, max_images):
        gt_sel[img_id] = {"boxes": gts[img_id].boxes,
                          "labels": gts[img_id].labels}
        dets[img_id] = {"boxes": boxes, "scores": scores, "labels": labels}
    return evaluate_voc(gt_sel, dets, num_classes=cfg.model.num_classes,
                        iou_threshold=iou_threshold,
                        class_names=getattr(dataset, "class_names", None))
