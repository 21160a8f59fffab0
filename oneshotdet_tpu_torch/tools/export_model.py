"""Serving-export CLI of the port (counterpart of the root ``tools/export_model.py``).

    python -m oneshotdet_tpu_torch.tools.export_model --config-file CFG.yaml \
        --out STEM [--ckpt X.pth] [--kind full|cached_support|both] [--batch 8] \
        [--serving [--no-compile]] [--device cpu] [KEY VALUE ...]

Builds the detector on the card (or ``--device``), overlays ``--ckpt`` (a
``.pth``, a Caffe2 ``.pkl``, ``catalog://`` or a URL) onto the seeded
initial weights through ``Checkpointer(...).load(..., prefer_tag=False,
resume=False)``, so exactly that file is exported, and writes
ExportedPrograms (``export.py``) at the cfg's first query bucket and its
support bucket: ``STEM.eval`` (kind full, batch ``--batch``) and
``STEM.serve.support`` / ``STEM.serve.detect`` (kind cached_support). With
``--serving`` it writes the batch-1 serving bundle ``STEM.{support,detect,
meta.json}`` instead, with its AOTInductor pair ``STEM.{support,detect}.exec``
unless ``--no-compile``; serve it with ``predictor.ArtifactPredictor``. The
fused head (``ONESHOT_PALLAS_ROI_HEAD=1`` when the model is built) is fixed
at export. Artifacts are for the device they were exported on.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One-shot detection serving export (PyTorch/CUDA)")
    p.add_argument("--config-file", default="", type=str)
    p.add_argument("--ckpt", default="", type=str,
                   help=".pth, .pkl, catalog:// or URL; the seeded weights if omitted")
    p.add_argument("--out", required=True, type=str, help="output path stem of the artifacts")
    p.add_argument("--kind", default="both", choices=["full", "cached_support", "both"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--serving", action="store_true",
                   help="write the batch-1 serving bundle (export_serving) instead")
    p.add_argument("--no-compile", action="store_true",
                   help="with --serving: no AOTInductor pair")
    p.add_argument("--device", default="", help="torch device (default cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    import torch

    from .. import export as oexport
    from ..config import cfg
    from ..models import build_detection_model
    from ..utils.checkpoint import Checkpointer
    from ..utils.logger import setup_logger

    c = cfg.clone()
    if args.config_file:
        c.merge_from_file(args.config_file)
    if args.opts:
        c.merge_from_list(args.opts)
    logger = setup_logger("oneshotdet_tpu_torch")
    model = build_detection_model(c, device=torch.device(args.device or "cuda"))
    if args.ckpt:
        Checkpointer(os.path.dirname(args.ckpt) or ".", logger, cfg=c).load(
            model, f=args.ckpt, resume=False, prefer_tag=False)

    if args.serving:
        compiled = oexport.export_serving(c, model, args.out,
                                          compile_executable=not args.no_compile)
        logger.info(f"wrote {args.out}.support / .detect / .meta.json"
                    + (" and their .exec pair" if compiled else ""))
        return 0
    if args.kind in ("full", "both"):
        oexport.save(oexport.export_eval(c, model, batch=args.batch, kind="full"),
                     args.out + ".eval")
        logger.info(f"wrote {args.out}.eval")
    if args.kind in ("cached_support", "both"):
        oexport.save(oexport.export_eval(c, model, batch=args.batch, kind="cached_support"),
                     args.out + ".serve")
        logger.info(f"wrote {args.out}.serve.support / .detect")
    return 0


if __name__ == "__main__":
    sys.exit(main())
