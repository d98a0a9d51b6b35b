"""The reference's detections of a set of canvases, and the numbers that
compare served detections with them (``detection.judge_image``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import detection as D
from benchmark.reference import model as R

COVER_TOP = 20  # the reference's best detections an image that must be covered
COVER_IOU = 0.45  # overlap that counts as covering (NMS suppresses above 0.5)
CUT_MARGIN = 0.5  # logits above the selection's cuts a covered detection lies
BLOCK = 8  # canvases a reference forward
NOTE_ABOVE = 1.0


def anchors_of(model_cfg: dict, device) -> torch.Tensor:
    m = model_cfg
    return D.anchors(m["image_size"], range(m["min_level"],
                                            m["max_level"] + 1),
                     m["anchor_scales"], m["anchor_ratios"],
                     m["anchor_base_scale"], device)


def detect(net: torch.nn.Module, conf: dict, canvases_u8: torch.Tensor,
           kind: str = "fp32") -> List[Tuple]:
    """Detections of each canvas as the server returns them, (boxes,
    scores, labels, num_valid) in numpy, by the reference computed in
    ``kind``: the control in the program's place."""
    mc = conf["model"]
    anc = anchors_of(mc, canvases_u8.device)
    out = []
    with torch.no_grad(), R.tf32_off(), R.precision(net, kind):
        for b0 in range(0, canvases_u8.shape[0], BLOCK):
            cls, box = net(D.normalize(canvases_u8[b0:b0 + BLOCK]))
            det = D.postprocess(cls, box, anc, conf["eval"], mc["box_std"],
                                mc["image_size"])
            nv = (det.labels >= 0).sum(1).cpu().numpy()
            for i in range(cls.shape[0]):
                out.append((det.boxes[i].cpu().numpy(),
                            det.scores[i].cpu().numpy(),
                            det.labels[i].cpu().numpy(), int(nv[i])))
    return out


def compare(net: torch.nn.Module, conf: dict, canvases_u8: torch.Tensor,
            served: Sequence[Sequence[Tuple]], notes: list = None
            ) -> Dict[str, float]:
    """The largest logit_gap, box_gap, cover_gap and kept_gap over the served
    answers; ``served[i]`` lists the answers given for canvas i. Answers
    with a gap above NOTE_ABOVE are listed in ``notes``, when given."""
    mc = conf["model"]
    anc = anchors_of(mc, canvases_u8.device)
    worst = np.zeros(4)
    with torch.no_grad(), R.tf32_off():
        for b0 in range(0, canvases_u8.shape[0], BLOCK):
            cls, box = net(D.normalize(canvases_u8[b0:b0 + BLOCK]))
            top = D.postprocess(cls, box, anc, conf["eval"], mc["box_std"],
                                mc["image_size"])
            kept = (top.labels >= 0).sum(1).tolist()
            top = D.Detections(*(t[:, :COVER_TOP] for t in top))
            ref_boxes = D.decode(box, anc, mc["box_std"], mc["image_size"])
            for i in range(cls.shape[0]):
                for answer in served[b0 + i]:
                    got = D.judge_image(answer, cls[i], ref_boxes[i], anc,
                                        top, kept[i], i, COVER_IOU,
                                        CUT_MARGIN)
                    if notes is not None and max(got) > NOTE_ABOVE:
                        notes.append({"canvas": b0 + i, "kept": answer[3],
                                      "gaps": got})
                    worst = np.maximum(worst, got)
    return dict(zip(("logit_gap", "box_gap", "cover_gap", "kept_gap"),
                    map(float, worst)))
