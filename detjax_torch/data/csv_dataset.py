"""CSV-annotation dataset, the lineage's other format
(``detjax/data/csv_dataset.py``).

Format (one box per line, lineage convention):
    path/to/image.jpg,x1,y1,x2,y2,class_name
    path/to/empty_image.jpg,,,,,          (negative image: empty fields)
Class map file: ``class_name,id`` per line.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np


def load_class_map(path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            name, idx = row[0].strip(), int(row[1])
            out[name] = idx
    return out


class CSVDataset:
    """Same record schema as :class:`detjax_torch.data.coco.CocoDataset`."""

    def __init__(self, csv_file: str, class_map: Dict[str, int] | str,
                 image_dir: Optional[str] = None, load_images: bool = True):
        if isinstance(class_map, str):
            class_map = load_class_map(class_map)
        self.class_map = dict(class_map)
        self.num_classes = max(class_map.values()) + 1 if class_map else 0
        self.class_names = [None] * self.num_classes
        for name, idx in class_map.items():
            self.class_names[idx] = name
        self.image_dir = image_dir or ""
        self.load_images = load_images

        per_image: Dict[str, List[list]] = {}
        with open(csv_file) as f:
            for ln, row in enumerate(csv.reader(f)):
                if not row:
                    continue
                fname = row[0].strip()
                per_image.setdefault(fname, [])
                rest = [c.strip() for c in row[1:]]
                if len(rest) < 5 or not any(rest[:5]):
                    continue  # negative image
                x1, y1, x2, y2 = (float(v) for v in rest[:4])
                name = rest[4]
                if name not in self.class_map:
                    raise ValueError(
                        f"line {ln + 1}: unknown class {name!r}")
                if x2 <= x1 or y2 <= y1:
                    raise ValueError(
                        f"line {ln + 1}: degenerate box {rest[:4]}")
                per_image[fname].append([x1, y1, x2, y2, self.class_map[name]])
        self.files = sorted(per_image)
        self._anns = per_image

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        fname = self.files[idx]
        rows = self._anns[fname]
        n = len(rows)
        arr = np.asarray(rows, np.float32).reshape(n, 5)
        rec = {
            "boxes": arr[:, :4].astype(np.float32),
            "labels": arr[:, 4].astype(np.int32),
            "iscrowd": np.zeros(n, bool),
            "areas": ((arr[:, 2] - arr[:, 0]) * (arr[:, 3] - arr[:, 1])
                      ).astype(np.float32),
            "image_id": idx,
            "file_name": fname,
            "size": (None, None),
            "image": None,
        }
        if self.load_images:
            from PIL import Image

            with Image.open(os.path.join(self.image_dir, fname)) as im:
                rec["image"] = np.asarray(im.convert("RGB"), dtype=np.uint8)
                rec["size"] = rec["image"].shape[:2]
        return rec
