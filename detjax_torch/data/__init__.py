"""Input pipeline (``detjax/data``): datasets, host transforms onto fixed
uint8 canvases, the threaded batch iterator, prefetch to the device, and
normalisation and flip on the device."""

from detjax_torch.data.coco import COCO_CLASSES, CocoDataset
from detjax_torch.data.csv_dataset import CSVDataset
from detjax_torch.data.pipeline import (
    DetectionIterator,
    device_augment,
    device_prefetch,
    make_eval_iterator,
    make_train_iterator,
)
from detjax_torch.data.synthetic import SyntheticDetectionDataset
from detjax_torch.data.transforms import hflip_boxes, letterbox, normalize_image

__all__ = [
    "CocoDataset",
    "COCO_CLASSES",
    "CSVDataset",
    "SyntheticDetectionDataset",
    "letterbox",
    "hflip_boxes",
    "normalize_image",
    "DetectionIterator",
    "make_train_iterator",
    "make_eval_iterator",
    "device_augment",
    "device_prefetch",
]
