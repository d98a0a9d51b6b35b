"""Anchors, matching, losses, box coding and the detection postprocess of
RetinaNet, in plain PyTorch over fp32.

The rules, as the configuration files state them:

- anchors: levels 3-7, stride 2^l, base size 4 x stride, three scales
  (2^0, 2^(1/3), 2^(2/3)) times three ratios (h / w = 0.5, 1, 2),
  ratio-major, centred on ((x + 0.5) s, (y + 0.5) s); per level row-major
  over (y, x), the cell's anchors innermost;
- matching: each anchor's GT is its highest IoU over the image's valid
  GTs; positive at IoU >= 0.5, negative below 0.4, ignored between;
- focal loss (alpha 0.25, gamma 2) over positives and negatives, each
  image's sum over its positives (at least 1); smooth-L1 (beta 1/9) on
  the std-normalised deltas (0.1, 0.1, 0.2, 0.2) of positives, each
  image's sum over 4 x its positives; both averaged over the batch;
- augmentation: uint8 / 255, minus the mean, over the std (ImageNet's),
  then the flip of the images in the step's flip mask;
- detection: the top 1,000 anchors by their best class logit, the top
  1,000 (anchor, class) pairs among them above the score threshold 0.05,
  decoded and clipped to the canvas, greedy NMS at IoU 0.5 over boxes
  offset by class, the first 100 kept.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def anchors(image_hw: Sequence[int], levels: Sequence[int],
            scales: Sequence[float], ratios: Sequence[float],
            base_scale: float, device) -> torch.Tensor:
    """[sum A, 4] xyxy fp32."""
    h, w = image_hw
    out = []
    for lvl in levels:
        s = 2 ** lvl
        size = base_scale * s
        cell = []
        for r in ratios:
            for sc in scales:
                aw = math.sqrt((size * sc) ** 2 / r)
                ah = aw * r
                cell.append((-aw / 2, -ah / 2, aw / 2, ah / 2))
        cell = np.asarray(cell, np.float32)
        fh, fw = -(-h // s), -(-w // s)
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * s
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * s
        yy, xx = np.meshgrid(cy, cx, indexing="ij")
        ctr = np.stack([xx, yy, xx, yy], -1)  # [fh, fw, 4]
        out.append((ctr[:, :, None, :] + cell[None, None]).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out)).to(device)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> fp32 [B, 3, H, W]."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def flip_mask(train_seed: int, step: int, batch: int,
              prob: float = 0.5) -> torch.Tensor:
    """The step's horizontal-flip mask as the configuration states it: a
    CPU ``torch.Generator`` seeded with (train seed << 32) + step, one
    uniform draw an image, flipped where it is below ``prob``."""
    gen = torch.Generator().manual_seed((int(train_seed) << 32) + int(step))
    return torch.rand(batch, generator=gen) < prob


def flip(x: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror the masked images ([B, 3, H, W]) and their boxes."""
    w = x.shape[-1]
    m = mask.to(x.device)
    x = torch.where(m[:, None, None, None], x.flip(-1), x)
    fb = torch.stack([w - boxes[..., 2], boxes[..., 1],
                      w - boxes[..., 0], boxes[..., 3]], -1)
    return x, torch.where(m[:, None, None], fb, boxes)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] -> [N, M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]).clamp(min=0)
              * (a[:, 3] - a[:, 1]).clamp(min=0))
    area_b = ((b[:, 2] - b[:, 0]).clamp(min=0)
              * (b[:, 3] - b[:, 1]).clamp(min=0))
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)


def match(anc: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
          fg: float, bg: float):
    """One image: (labels [A] with -1 off the positives, GT boxes [A, 4],
    positive [A], negative [A])."""
    valid = labels >= 0
    iou = torch.where(valid[None, :], box_iou(anc, boxes), -1.0)
    best, idx = iou.max(dim=1)
    pos = (best >= fg) & valid.any()
    neg = best < bg
    return (torch.where(pos, labels[idx], -1), boxes[idx], pos, neg)


def encode(gt: torch.Tensor, anc: torch.Tensor, std) -> torch.Tensor:
    aw, ah = anc[:, 2] - anc[:, 0], anc[:, 3] - anc[:, 1]
    ax, ay = anc[:, 0] + 0.5 * aw, anc[:, 1] + 0.5 * ah
    gw = (gt[:, 2] - gt[:, 0]).clamp(min=1.0)
    gh = (gt[:, 3] - gt[:, 1]).clamp(min=1.0)
    gx = gt[:, 0] + 0.5 * (gt[:, 2] - gt[:, 0])
    gy = gt[:, 1] + 0.5 * (gt[:, 3] - gt[:, 1])
    d = torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                     torch.log(gh / ah)], -1)
    return d / torch.tensor(std, device=d.device)


def decode(deltas: torch.Tensor, anc: torch.Tensor, std,
           image_hw) -> torch.Tensor:
    """deltas [..., A, 4] and anchors [A, 4] (or of the deltas' shape) ->
    boxes clipped to the canvas."""
    d = deltas * torch.tensor(std, device=deltas.device)
    aw, ah = anc[..., 2] - anc[..., 0], anc[..., 3] - anc[..., 1]
    ax, ay = anc[..., 0] + 0.5 * aw, anc[..., 1] + 0.5 * ah
    px, py = d[..., 0] * aw + ax, d[..., 1] * ah + ay
    pw, ph = torch.exp(d[..., 2]) * aw, torch.exp(d[..., 3]) * ah
    h, w = image_hw
    box = torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw,
                       py + 0.5 * ph], -1)
    hi = torch.tensor((w, h, w, h), dtype=box.dtype, device=box.device)
    return torch.minimum(box.clamp(min=0), hi)


def image_loss(cls: torch.Tensor, box: torch.Tensor, anc: torch.Tensor,
               gt_boxes: torch.Tensor, gt_labels: torch.Tensor, t: dict,
               std) -> torch.Tensor:
    """One image's focal + smooth-L1 loss; cls [A, K], box [A, 4]."""
    labels, gt, pos, neg = match(anc, gt_boxes, gt_labels,
                                 t["fg_iou_threshold"],
                                 t["bg_iou_threshold"])
    k = cls.shape[-1]
    target = (labels[:, None] == torch.arange(k, device=cls.device)
              ).to(cls.dtype)
    ce = F.binary_cross_entropy_with_logits(cls, target, reduction="none")
    p = torch.sigmoid(cls)
    p_t = target * p + (1 - target) * (1 - p)
    a = t["focal_alpha"]
    alpha_t = target * a + (1 - target) * (1 - a)
    focal = alpha_t * (1 - p_t) ** t["focal_gamma"] * ce
    weight = (pos | neg).to(cls.dtype)
    npos = pos.sum().to(cls.dtype)
    cls_loss = (focal * weight[:, None]).sum() / npos.clamp(min=1)
    diff = (box - encode(gt, anc, std)).abs()
    beta = t["smooth_l1_beta"]
    sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    reg_loss = (sl1 * pos[:, None].to(cls.dtype)).sum() / (4 * npos).clamp(
        min=1)
    return cls_loss + reg_loss


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D], -1 past num_valid
    logits: torch.Tensor  # [B, D]
    margin: torch.Tensor  # [B, D] logits above the nearest selection cut


def postprocess(cls: torch.Tensor, box: torch.Tensor, anc: torch.Tensor,
                e: dict, std, image_hw) -> Detections:
    """Detections of a batch from its fp32 logits and deltas. ``margin``
    is how far a detection lies above the cuts that chose it: its anchor's
    best logit above the first anchor left out, its logit above the first
    pair left out, above the score threshold and above the first NMS
    survivor past ``max_detections``."""
    bsz, a, k = cls.shape
    n = min(e["pre_nms_top_k"], a)
    thr = math.log(e["score_threshold"]) - math.log1p(-e["score_threshold"])
    best, order = torch.sort(cls.amax(-1), dim=-1, descending=True,
                             stable=True)
    top_a = order[:, :n]
    cut_a = best[:, n] if a > n else torch.full_like(best[:, 0], -math.inf)
    slab = cls.gather(1, top_a[..., None].expand(bsz, n, k))
    slab = torch.where(slab > thr, slab, -math.inf).reshape(bsz, n * k)
    logit, flat = torch.sort(slab, dim=-1, descending=True, stable=True)
    cut_p = torch.maximum(logit[:, n], torch.full_like(logit[:, n], thr))
    logit, flat = logit[:, :n], flat[:, :n]
    margin = torch.minimum(best[:, :n].gather(1, flat // k)
                           - cut_a[:, None], logit - cut_p[:, None])
    anchor = top_a.gather(1, flat // k)
    label = flat % k
    boxes = decode(box.gather(1, anchor[..., None].expand(bsz, n, 4)),
                   anc[anchor], std, image_hw)
    keep = nms(boxes + (label * (max(image_hw) + 2.0))[..., None], logit,
               e["nms_iou_threshold"], e["max_detections"] + 1)
    after = keep[:, -1]  # the first survivor past the kept ones
    cut_d = torch.where(after >= 0, logit.gather(
        1, after.clamp(min=0)[:, None])[:, 0], -math.inf)
    margin = torch.minimum(margin, logit - cut_d[:, None])
    keep = keep[:, :-1]
    ok = keep >= 0
    idx = keep.clamp(min=0)
    lg = torch.where(ok, logit.gather(1, idx), -math.inf)
    return Detections(
        boxes=torch.where(ok[..., None], boxes.gather(
            1, idx[..., None].expand(*idx.shape, 4)), 0.0),
        scores=torch.where(ok, torch.sigmoid(lg), 0.0),
        labels=torch.where(ok, label.gather(1, idx), -1),
        logits=lg, margin=torch.where(ok, margin.gather(1, idx), -math.inf))


def nms(boxes: torch.Tensor, score: torch.Tensor, iou_thr: float,
        max_out: int) -> torch.Tensor:
    """Greedy NMS a row: keep the best live candidate, drop every live one
    that overlaps it by more than ``iou_thr``; -inf is never kept.
    boxes [B, N, 4], score [B, N] -> kept indices [B, max_out], -1 pad."""
    bsz = score.shape[0]
    live = score.clone()
    keep = torch.full((bsz, max_out), -1, dtype=torch.long,
                      device=score.device)
    rows = torch.arange(bsz, device=score.device)
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    for i in range(max_out):
        best = live.argmax(1)
        ok = torch.isfinite(live[rows, best])
        keep[:, i] = torch.where(ok, best, -1)
        kb = boxes[rows, best][:, None, :]
        wh = (torch.minimum(kb[..., 2:], boxes[..., 2:])
              - torch.maximum(kb[..., :2], boxes[..., :2])).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area[rows, best][:, None] + area - inter).clamp(
            min=1e-8)
        kill = (iou > iou_thr) & ok[:, None]
        kill[rows, best] = True
        live = torch.where(kill, -math.inf, live)
    return keep


def logit(p: torch.Tensor) -> torch.Tensor:
    """The logit of an fp32 probability, in fp64."""
    p = p.to(torch.float64).clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def nearest_anchor_boxes(det_boxes: torch.Tensor, ref_boxes: torch.Tensor,
                         anc: torch.Tensor, chunk: int = 16384
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each of D boxes, the anchor whose reference box lies nearest
    (largest coordinate gap over the anchor's size): (gap [D], anchor [D]).
    det_boxes [D, 4], ref_boxes [A, 4]."""
    size = torch.sqrt((anc[:, 2] - anc[:, 0]) * (anc[:, 3] - anc[:, 1]))
    best = torch.full((det_boxes.shape[0],), math.inf,
                      device=det_boxes.device)
    arg = torch.zeros(det_boxes.shape[0], dtype=torch.long,
                      device=det_boxes.device)
    for a0 in range(0, ref_boxes.shape[0], chunk):
        rb = ref_boxes[a0:a0 + chunk]
        gap = ((det_boxes[:, None, :] - rb[None]).abs().amax(-1)
               / size[None, a0:a0 + chunk])
        g, i = gap.min(1)
        better = g < best
        best = torch.where(better, g, best)
        arg = torch.where(better, i + a0, arg)
    return best, arg


def judge_image(served: Tuple, cls: torch.Tensor, box_ref: torch.Tensor,
                anc: torch.Tensor, ref_top: Detections, ref_kept: int,
                row: int, cover_iou: float, cut_margin: float
                ) -> List[float]:
    """(logit_gap, box_gap, cover_gap, kept_gap) of one image's served
    detections.

    - logit_gap: over served detections, |logit of the served score - the
      reference's logit of that class at the anchor whose reference box
      lies nearest the served box|;
    - box_gap: that nearest distance, as the largest coordinate gap over
      the anchor's size;
    - cover_gap: over the reference's top detections that lie at least
      ``cut_margin`` above the candidate selection's cuts, how far the
      best served detection of the same class that overlaps it (IoU >=
      ``cover_iou``) lies below it in logit (100 when none does). Greedy
      NMS keeps every one of them or a same-class box that overlaps it
      with a higher score, so a sound program stays within its noise; a
      detection near a cut may fall on either side of it;
    - kept_gap: |detections served - detections the reference keeps|.
    """
    boxes, scores, labels, nv = served
    dev = cls.device
    boxes = torch.as_tensor(np.asarray(boxes[:nv]), device=dev).float()
    scores = torch.as_tensor(np.asarray(scores[:nv]), device=dev)
    labels = torch.as_tensor(np.asarray(labels[:nv]), device=dev).long()
    if nv:
        gap, a = nearest_anchor_boxes(boxes, box_ref, anc)
        ref_logit = cls[a, labels].to(torch.float64)
        logit_gap = float((logit(scores) - ref_logit).abs().max())
        box_gap = float(gap.max())
    else:
        logit_gap = box_gap = 0.0
    served_logit = logit(scores) if nv else None
    cover = 0.0
    rl = ref_top.labels[row]
    for j in range(rl.shape[0]):
        if int(rl[j]) < 0 or float(ref_top.margin[row, j]) < cut_margin:
            continue
        want = float(ref_top.logits[row, j])
        best = -math.inf
        if nv:
            same = labels == rl[j]
            if bool(same.any()):
                iou = box_iou(ref_top.boxes[row, j][None], boxes)[0]
                hit = same & (iou >= cover_iou)
                if bool(hit.any()):
                    best = float(served_logit[hit].max())
        cover = max(cover, want - best if best > -math.inf else 100.0)
    return [logit_gap, box_gap, cover, float(abs(nv - ref_kept))]
