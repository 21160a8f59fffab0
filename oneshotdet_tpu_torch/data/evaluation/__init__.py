from .coco_eval import (compute_thresholds_for_classes, do_coco_evaluation,
                        evaluate_box_proposals)
from .coco_metrics import COCOEvalNumpy


def evaluate(dataset, predictions, output_folder=None, logger=None, iou_type="bbox",
             box_only=False):
    """COCO-protocol evaluation of per-episode predictions (the dispatch of
    ``oneshotdet_tpu/data/evaluation/__init__.py``)."""
    return do_coco_evaluation(dataset, predictions, output_folder, logger,
                              box_only=box_only)


__all__ = ["COCOEvalNumpy", "compute_thresholds_for_classes", "do_coco_evaluation", "evaluate",
           "evaluate_box_proposals"]
