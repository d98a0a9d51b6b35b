"""Batching, prefetch and the augmentation on the device
(``detjax/data/pipeline.py``).

The host decodes, crops and letterboxes each image onto a fixed uint8
canvas in a pool of threads (:class:`DetectionIterator`, whose batches
are deterministic in the seed, the epoch and the index, whatever the
number of threads); :func:`device_prefetch` copies them to the card from
pinned memory on a side CUDA stream, a batch ahead; normalisation and the
random flip run on the device (:func:`device_augment`), so the copy moves
uint8.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from detjax_torch.config import Config
from detjax_torch.data.transforms import letterbox, pad_annotations, random_crop
from detjax_torch.utils.device import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_u8(images_u8: torch.Tensor, mean, std,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 -> normalized image, on the tensor's device: fp32 ``/255``,
    then ``-mean``, then ``/std`` over the last (channel) dim, then one
    cast to ``out_dtype``."""
    x = images_u8.to(torch.float32) / 255.0
    m = device_constant(tuple(mean), torch.float32, x.device)
    s = device_constant(tuple(std), torch.float32, x.device)
    return ((x - m) / s).to(out_dtype)


def device_augment(images_u8: torch.Tensor, gt_boxes: torch.Tensor,
                   flip: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   hflip_prob: float = 0.5,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize and randomly flip each image horizontally, on the tensor's
    device.

    images_u8 [B, H, W, 3] uint8 NHWC; gt_boxes [B, G, 4] xyxy. ``flip``
    [B] bool is the per-image mask; when None and ``hflip_prob > 0`` it is
    drawn as ``uniform < hflip_prob`` from ``generator`` (a CPU
    ``torch.Generator``; the global one when None). The math runs in fp32
    through the flip, with one cast to ``out_dtype`` at the end; a flipped
    image's boxes become ``(w - x2, y1, w - x1, y2)``.
    """
    b, _, w, _ = images_u8.shape
    x = normalize_u8(images_u8, mean, std)
    if flip is None and hflip_prob > 0:
        flip = torch.rand(b, generator=generator) < hflip_prob
    if flip is not None:
        flip = flip.to(device=x.device, dtype=torch.bool)
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        flipped = torch.stack([w - gt_boxes[..., 2], gt_boxes[..., 1],
                               w - gt_boxes[..., 0], gt_boxes[..., 3]], -1)
        gt_boxes = torch.where(flip[:, None, None], flipped, gt_boxes)
    return x.to(out_dtype), gt_boxes


class DetectionIterator:
    """Fixed-shape batches from a record dataset, with background prefetch.

    Yields ``{"images": u8 [B,H,W,3], "gt_boxes": [B,G,4],
    "gt_labels": [B,G], "image_id": [B], "scale": [B]}`` numpy batches.
    ``workers`` threads decode and letterbox (the native decode and resize
    release the GIL); a background thread keeps ``prefetch`` batches ready.
    The shuffle and each example's crop are keyed by ``(seed, epoch,
    index)``, so the stream is the same whatever the number of threads or
    their completion order, and :meth:`iter_from` seeks without decoding.
    """

    def __init__(self, dataset, batch_size: int, image_size: Tuple[int, int],
                 max_gt: int = 100, shuffle: bool = True, repeat: bool = True,
                 seed: int = 0, crop: bool = False,
                 crop_range: Tuple[float, float] = (0.3, 1.0),
                 drop_remainder: bool = True, prefetch: int = 2,
                 workers: int = 1, shard_index: int = 0,
                 num_shards: int = 1,
                 scale_minmax: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.bs = batch_size
        self.hw = image_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.crop = crop
        self.crop_range = crop_range
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.workers = max(1, workers)
        self.shard_index = shard_index
        self.num_shards = num_shards
        # the reference eval protocol's resize rule (transforms.protocol_scale)
        self.scale_minmax = scale_minmax

    def _record_to_example(self, rec: dict, rng: np.random.Generator) -> dict:
        img, boxes, labels = rec["image"], rec["boxes"], rec["labels"]
        if self.crop and rng.random() < 0.5:
            img, boxes, labels = random_crop(
                img, boxes, labels, rng, *self.crop_range)
        canvas, boxes, scale = letterbox(img, boxes, self.hw,
                                         scale_minmax=self.scale_minmax)
        pb, pl = pad_annotations(boxes, labels, self.max_gt)
        return {"images": canvas, "gt_boxes": pb, "gt_labels": pl,
                "image_id": rec["image_id"], "scale": scale}

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.num_shards > 1:
            # every process takes a disjoint stride of the same shuffle
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def _examples(self, order, epoch: int):
        """Decoded examples in ``order``, through a thread pool when
        workers > 1, in order either way."""

        def load(i):
            rng = np.random.default_rng((self.seed, epoch, int(i)))
            return self._record_to_example(self.ds[int(i)], rng)

        if self.workers == 1:
            for i in order:
                yield load(i)
            return
        from concurrent.futures import ThreadPoolExecutor

        window = self.workers * 2
        with ThreadPoolExecutor(self.workers) as pool:
            pending = collections.deque()
            it = iter(order)
            for i in it:
                pending.append(pool.submit(load, i))
                if len(pending) >= window:
                    break
            for i in it:
                yield pending.popleft().result()
                pending.append(pool.submit(load, i))
            while pending:
                yield pending.popleft().result()

    def batches_per_epoch(self) -> int:
        n = len(self._epoch_order(0))
        return n // self.bs if self.drop_remainder else -(-n // self.bs)

    def iter_from(self, batch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """The stream from global batch ``batch_idx`` on, an O(1) seek: the
        shuffle and the per-example RNG are keyed by (seed, epoch, index),
        so no skipped example is decoded. Training streams only
        (``drop_remainder``)."""
        if batch_idx and not self.drop_remainder:
            raise ValueError("iter_from requires drop_remainder batches "
                             "(train path); eval streams don't resume")
        return self._iterate(start_batch=batch_idx)

    def _gen(self, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        bpe = self.batches_per_epoch() if start_batch else 0
        epoch = start_batch // bpe if start_batch else 0
        skip = start_batch - epoch * bpe if start_batch else 0
        while True:
            order = self._epoch_order(epoch)
            if skip:
                order = order[skip * self.bs:]
                skip = 0
            buf = []
            for ex in self._examples(order, epoch):
                buf.append(ex)
                if len(buf) == self.bs:
                    yield self._stack(buf)
                    buf = []
            if buf and not self.drop_remainder:
                # pad the final partial batch by repeating the last example
                while len(buf) < self.bs:
                    filler = dict(buf[-1])
                    filler["image_id"] = -1  # marks padding for eval
                    buf.append(filler)
                yield self._stack(buf)
            epoch += 1
            if not self.repeat:
                return

    @staticmethod
    def _stack(examples) -> Dict[str, np.ndarray]:
        return {
            "images": np.stack([e["images"] for e in examples]),
            "gt_boxes": np.stack([e["gt_boxes"] for e in examples]),
            "gt_labels": np.stack([e["gt_labels"] for e in examples]),
            "image_id": np.asarray([e["image_id"] for e in examples], np.int64),
            "scale": np.asarray([e["scale"] for e in examples], np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._iterate(start_batch=0)

    def _iterate(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._gen(start_batch)
            return
        q: collections.deque = collections.deque()
        done = threading.Event()
        sem = threading.Semaphore(self.prefetch)
        lock = threading.Lock()

        def worker():
            try:
                for batch in self._gen(start_batch):
                    # a bounded wait, so that an abandoned consumer (done
                    # set while this thread is parked) releases the thread
                    while not sem.acquire(timeout=0.1):
                        if done.is_set():
                            return
                    if done.is_set():
                        return
                    with lock:
                        q.append(batch)
                with lock:
                    q.append(None)  # clean end of stream
            except BaseException as exc:  # handed to the consumer, re-raised
                with lock:
                    q.append(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                with lock:
                    item = q.popleft() if q else ()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, tuple) and item == ():
                    t.join(timeout=0.005)
                    continue
                sem.release()
                yield item
        finally:
            done.set()


def prefetch_is_profitable(transfer_s: float, step_s: float,
                           threshold: float = 0.5) -> bool:
    """Whether copying the next batch during the current step can help on
    this host: only when one transfer is well below a step (below
    ``threshold`` of it); otherwise there is no compute to hide it
    under."""
    return transfer_s < threshold * step_s


def device_prefetch(batches: Iterator[Dict[str, np.ndarray]], device,
                    size: int = 1, keys: Optional[Sequence[str]] = None
                    ) -> Iterator[Dict]:
    """Batches on ``device``, ``size`` ahead of the consumer.

    On a CUDA device each batch's arrays are copied into pinned host
    tensors, then to the card with ``non_blocking`` copies on a side
    stream, so that the next batch's copy overlaps the current batch's
    compute and the host never waits for a copy from pageable memory. The
    consumer's stream waits on the copy's event before the batch is
    yielded, and each device tensor is recorded on that stream, so its
    memory is not reused while the consumer's work is queued. A pinned
    tensor stays referenced until its batch is yielded, after its copy was
    enqueued, and PyTorch's pinned-memory allocator does not hand its
    block out again before the copy's event has completed. On another
    device the arrays become plain tensors there.

    ``keys`` names the entries to copy (default: all); the others pass
    through as they are, e.g. the evaluator's ``image_id`` and ``scale``,
    which only the host reads.
    """
    dev = torch.device(device)

    def wanted(k):
        return keys is None or k in keys

    if dev.type != "cuda":
        for b in batches:
            yield {k: torch.as_tensor(v).to(dev) if wanted(k) else v
                   for k, v in b.items()}
        return

    copy_stream = torch.cuda.Stream(dev)
    in_flight: collections.deque = collections.deque()

    def put(b):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in b.items() if wanted(k)}
        with torch.cuda.stream(copy_stream):
            moved = {k: t.to(dev, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        out = {k: moved[k] if k in moved else v for k, v in b.items()}
        return out, moved, host, done

    def hand_over(entry):
        out, moved, _, done = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in moved.values():
            t.record_stream(consumer)
        return out

    for b in batches:
        in_flight.append(put(b))
        if len(in_flight) > size:
            yield hand_over(in_flight.popleft())
    while in_flight:
        yield hand_over(in_flight.popleft())


def _process_shard() -> Tuple[int, int]:
    """(rank, world size) from torch.distributed when it is initialised,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_train_iterator(dataset, cfg: Config, per_host: bool = False
                        ) -> DetectionIterator:
    """Shuffled, repeating, cropped (``cfg.data.random_crop``) training
    batches of ``cfg.train.batch_size``. ``per_host=True`` gives this
    process its stride of the data and its share of the global batch, by
    its torch.distributed rank."""
    shard_index, num_shards = _process_shard() if per_host else (0, 1)
    bs = cfg.train.batch_size
    if per_host:
        if bs % num_shards:
            raise ValueError(f"train.batch_size {bs} is not divisible by "
                             f"the world size {num_shards}")
        bs //= num_shards
    return DetectionIterator(
        dataset, bs, cfg.model.image_size,
        max_gt=cfg.train.max_gt, shuffle=True, repeat=True,
        seed=cfg.train.seed, crop=cfg.data.random_crop,
        crop_range=(cfg.data.crop_min_scale, cfg.data.crop_max_scale),
        prefetch=cfg.data.prefetch, workers=cfg.data.host_workers,
        shard_index=shard_index, num_shards=num_shards)


def make_eval_iterator(dataset, cfg: Config) -> DetectionIterator:
    """One pass in dataset order at ``cfg.eval.batch_size``; the final
    partial batch is padded by repeating its last example with
    ``image_id = -1``."""
    return DetectionIterator(
        dataset, cfg.eval.batch_size, cfg.model.image_size,
        max_gt=cfg.train.max_gt, shuffle=False, repeat=False, crop=False,
        drop_remainder=False, prefetch=cfg.data.prefetch,
        workers=cfg.data.host_workers,
        scale_minmax=tuple(cfg.data.eval_scale_minmax) or None)
