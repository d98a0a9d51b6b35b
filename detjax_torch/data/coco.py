"""COCO dataset without pycocotools (``detjax/data/coco.py``).

Parses the ``instances_*.json`` annotation format directly (plain JSON;
pycocotools' C extension is needed only for RLE masks, which bbox
detection never touches): contiguous label mapping, xywh -> xyxy,
degenerate-box filtering for training, image loading. JPEG files decode
through the port's libjpeg binding (``detjax_torch.native``), then PIL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# The 80 COCO "thing" class names in official category-id order, used when
# building synthetic datasets or exporting detections without a JSON file.
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


class CocoDataset:
    """Detection dataset over a COCO-format annotation JSON.

    Record schema (``__getitem__``):
      ``{"image": [H,W,3] uint8 or None, "boxes": [N,4] f32 xyxy,
         "labels": [N] i32 contiguous, "iscrowd": [N] bool,
         "areas": [N] f32, "image_id": int, "file_name": str,
         "size": (H, W)}``
    """

    def __init__(self, annotation_file: str, image_dir: Optional[str] = None,
                 load_images: bool = True):
        with open(annotation_file) as f:
            data = json.load(f)
        self.image_dir = image_dir
        self.load_images = load_images and image_dir is not None
        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        # contiguous label mapping: category id → [0, K)
        self.cat_id_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_cat_id = {i: c["id"] for i, c in enumerate(cats)}
        self.class_names = [c["name"] for c in cats]
        self.num_classes = len(cats)

        self.images: List[dict] = data["images"]
        anns_by_img: Dict[int, List[dict]] = {}
        for ann in data.get("annotations", []):
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self._anns = anns_by_img

    def __len__(self) -> int:
        return len(self.images)

    def load_annotations(self, image_id: int,
                         filter_degenerate: bool = False
                         ) -> Dict[str, np.ndarray]:
        """xywh→xyxy.

        ``filter_degenerate=True`` drops boxes with w/h < 1px like the
        lineage's training path. The default keeps everything: this method
        also supplies EVAL ground truth (evaluator.ground_truths), and
        pycocotools' COCOeval keeps all annotations — filtering there would
        shift npig and break the ±0.2 mAP parity protocol.
        """
        boxes, labels, iscrowd, areas = [], [], [], []
        for ann in self._anns.get(image_id, []):
            x, y, w, h = ann["bbox"]
            if filter_degenerate and (w < 1 or h < 1):
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat_id_to_label[ann["category_id"]])
            iscrowd.append(bool(ann.get("iscrowd", 0)))
            areas.append(float(ann.get("area", w * h)))
        n = len(boxes)
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(n, 4),
            "labels": np.asarray(labels, np.int32).reshape(n),
            "iscrowd": np.asarray(iscrowd, bool).reshape(n),
            "areas": np.asarray(areas, np.float32).reshape(n),
        }

    def load_image(self, idx: int) -> np.ndarray:
        info = self.images[idx]
        path = os.path.join(self.image_dir, info["file_name"])
        if path.lower().endswith((".jpg", ".jpeg")):
            # the in-repo libjpeg binding releases the GIL, so loader
            # threads decode in parallel; PIL where it cannot decode
            from detjax_torch import native

            with open(path, "rb") as f:
                return native.decode_image(f.read())
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)

    def __getitem__(self, idx: int) -> dict:
        info = self.images[idx]
        rec = self.load_annotations(info["id"], filter_degenerate=True)
        rec["image_id"] = info["id"]
        rec["file_name"] = info["file_name"]
        rec["size"] = (info.get("height"), info.get("width"))
        rec["image"] = self.load_image(idx) if self.load_images else None
        return rec
