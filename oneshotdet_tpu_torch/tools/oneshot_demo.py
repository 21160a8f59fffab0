"""One-shot detection demo over a directory of images (counterpart of the
root ``demo/oneshot_demo.py``).

    python -m oneshotdet_tpu_torch.tools.oneshot_demo --config-file CFG.yaml \
        --support crop.jpg --images DIR_OR_FILE --out OUT [--ckpt X.pth] \
        [--threshold 0.3] [--artifact STEM] [--device cpu]

Caches the support crop's features once, then writes every image of
``--images`` with its detections drawn (``run_on_opencv_image``) to
``--out`` under its own name. The model is built from the cfg with
``--ckpt`` overlaid (``resume=False, prefer_tag=False``), or, with
``--artifact``, served from a bundle of ``export.export_serving``
(``ArtifactPredictor``: no model-building Python). Binary PPM files are
read without PIL; other formats, and the drawing, need PIL. One card:
``--spatial-devices`` above 1 raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One-shot detection demo (PyTorch/CUDA)")
    p.add_argument("--config-file", default="configs/oneshot_fcos_r50.yaml")
    p.add_argument("--support", required=True)
    p.add_argument("--images", required=True, help="image file or directory")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--ckpt", default="")
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--artifact", default="", help="serving bundle stem (export_serving)")
    p.add_argument("--device", default="", help="torch device (default cuda)")
    p.add_argument("--spatial-devices", type=int, default=1)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)
    if args.spatial_devices > 1:
        raise NotImplementedError("--spatial-devices > 1: the port runs on one card")

    from PIL import Image

    from ..data.image_io import read_image_rgb
    from ..predictor import ArtifactPredictor, OneShotPredictor

    device = args.device or "cuda"
    if args.artifact:
        predictor = ArtifactPredictor(args.artifact, confidence_threshold=args.threshold,
                                      device=device)
        print(f"serving {args.artifact} ({'compiled' if predictor.used_executable else 'exported'}"
              " programs)")
    else:
        from ..config import cfg
        from ..utils.checkpoint import Checkpointer

        c = cfg.clone()
        if args.config_file:
            c.merge_from_file(args.config_file)
        if args.opts:
            c.merge_from_list(args.opts)
        predictor = OneShotPredictor(c, confidence_threshold=args.threshold, device=device)
        if args.ckpt:
            Checkpointer(os.path.dirname(args.ckpt) or ".", cfg=c).load(
                predictor.model, f=args.ckpt, resume=False, prefer_tag=False)
    predictor.set_support(read_image_rgb(args.support))
    print("support features cached")

    paths = (sorted(glob.glob(os.path.join(args.images, "*"))) if os.path.isdir(args.images)
             else [args.images])
    os.makedirs(args.out, exist_ok=True)
    for path in paths:
        try:
            rgb = read_image_rgb(path)
        except (OSError, ValueError):
            continue
        bgr = predictor.run_on_opencv_image(rgb[:, :, ::-1])
        out_path = os.path.join(args.out, os.path.basename(path))
        Image.fromarray(bgr[:, :, ::-1]).save(out_path)
        print(f"{path} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
