"""Webcam / video one-shot detection loop (counterpart of the root
``demo/webcam.py``).

    python -m oneshotdet_tpu_torch.tools.webcam --support crop.jpg \
        [--config-file configs/oneshot_fcos_r50.yaml] [--source 0 | VIDEO] \
        [--threshold 0.3] [--ckpt X.pth] [--device cpu] [KEY VALUE ...]

Builds ``OneShotPredictor`` on the card (or ``--device``), overlays
``--ckpt`` (``resume=False, prefer_tag=False``, as ``tools.oneshot_demo``),
caches the support crop's features once, then for each frame that
``cv2.VideoCapture(--source)`` reads (a camera index or a video file) calls
``run_on_image`` and shows the frame with its boxes, their scores and the
frame's milliseconds (host clock around ``run_on_image``) until the source
ends or ``q`` is pressed. OpenCV is imported in ``main``; binary PPM supports
are read without PIL, other formats need PIL. One card: ``--spatial-devices``
above 1 raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Tuple

import numpy as np

WINDOW = "oneshotdet_tpu_torch"


def draw(cv2, frame_bgr: np.ndarray, boxes: np.ndarray, scores: np.ndarray, ms: float) -> None:
    """Boxes, their scores and the frame's ms drawn on ``frame_bgr`` in place."""
    for box, score in zip(boxes, scores):
        x1, y1, x2, y2 = map(int, box)
        cv2.rectangle(frame_bgr, (x1, y1), (x2, y2), (0, 0, 255), 2)
        cv2.putText(frame_bgr, f"{score:.2f}", (x1, y1 - 4), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 255, 255), 1)
    cv2.putText(frame_bgr, f"{ms:.0f} ms", (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (255, 255, 255), 2)


def stream(predictor, capture, cv2) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """Detect, draw and show every frame ``capture`` reads, until it ends or
    ``q`` is pressed; returns each frame's (boxes, scores, ms)."""
    out = []
    while True:
        ok, frame_bgr = capture.read()
        if not ok:
            break
        t0 = time.perf_counter()
        boxes, scores = predictor.run_on_image(np.ascontiguousarray(frame_bgr[:, :, ::-1]))
        ms = (time.perf_counter() - t0) * 1e3
        out.append((boxes, scores, ms))
        draw(cv2, frame_bgr, boxes, scores, ms)
        cv2.imshow(WINDOW, frame_bgr)
        if cv2.waitKey(1) & 0xFF == ord("q"):
            break
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One-shot detection on a webcam or video "
                                            "(PyTorch/CUDA)")
    p.add_argument("--config-file", default="configs/oneshot_fcos_r50.yaml")
    p.add_argument("--support", required=True)
    p.add_argument("--source", default="0", help="camera index or video path")
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--ckpt", default="")
    p.add_argument("--spatial-devices", type=int, default=1)
    p.add_argument("--device", default="", help="torch device (default cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)
    if args.spatial_devices > 1:
        raise NotImplementedError("--spatial-devices > 1: the port runs on one card")

    try:
        import cv2
    except ImportError:
        raise SystemExit("the webcam tool needs opencv-python (cv2)")

    from ..config import cfg
    from ..data.image_io import read_image_rgb
    from ..predictor import OneShotPredictor
    from ..utils.checkpoint import Checkpointer

    c = cfg.clone()
    if args.config_file:
        c.merge_from_file(args.config_file)
    if args.opts:
        c.merge_from_list(args.opts)
    predictor = OneShotPredictor(c, confidence_threshold=args.threshold,
                                 device=args.device or "cuda")
    if args.ckpt:
        Checkpointer(os.path.dirname(args.ckpt) or ".", cfg=c).load(
            predictor.model, f=args.ckpt, resume=False, prefer_tag=False)
    predictor.set_support(read_image_rgb(args.support))

    cam = cv2.VideoCapture(int(args.source) if args.source.isdigit() else args.source)
    try:
        stream(predictor, cam, cv2)
    finally:
        cam.release()
        cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
