"""Evaluation (``detjax/evaluation``): COCO-style bbox mAP without
pycocotools (a numpy copy of detjax's COCOeval with the native C++ fast
path), the VOC evaluator, and the loops that run the port's detect path
over a dataset, at one fixed canvas or at each image's protocol canvas."""

from detjax_torch.evaluation.coco_map import COCOMetric, evaluate_detections
from detjax_torch.evaluation.evaluator import run_coco_eval
from detjax_torch.evaluation.protocol import run_coco_eval_protocol
from detjax_torch.evaluation.voc import evaluate_voc

__all__ = ["COCOMetric", "evaluate_detections", "run_coco_eval",
           "run_coco_eval_protocol", "evaluate_voc"]
