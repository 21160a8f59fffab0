"""Evaluation CLI of the port (counterpart of the root ``tools/test_net.py``).

    python -m oneshotdet_tpu_torch.tools.test_net --config-file CFG.yaml \
        [--ckpt X.pth] [--seq_test] [--device cpu] [KEY VALUE ...]

Merges the cfg, builds the detector on the card (or ``--device``), reads
``DATASETS.TEST[0]`` through ``make_data_loader`` and runs ``inference``
with the COCO evaluator into ``OUTPUT_DIR/eval``, stopping after
``FEW_SHOT.STOP_ITER`` batches where that is above 0. Weights: ``--ckpt``,
else ``MODEL.WEIGHT`` (a ``.pth``, a Caffe2 ``.pkl``, ``catalog://`` or a
URL), overlaid onto the seeded initial weights by a ``Checkpointer`` rooted
at the eval folder with ``prefer_tag=False``, so a training folder's
``last_checkpoint`` tag never redirects the load; with neither, the seeded
initial weights. ``--seq_test`` evaluates every ``TEST.LOAD_DIR/model_*``
file whose iteration lies in ``[TEST.MIN_ITER, TEST.MAX_ITER]``, each
loaded by its own path into ``OUTPUT_DIR/eval_{iter:07d}``. One card: the
JAX CLI's device mesh has no counterpart.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="One-shot detection evaluation (PyTorch/CUDA)")
    parser.add_argument("--config-file", default="", type=str)
    parser.add_argument("--seq_test", action="store_true")
    parser.add_argument("--ckpt", default="", type=str)
    parser.add_argument("--device", default="", help="torch device (default cuda)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    import torch

    from ..config import cfg
    from ..data import make_data_loader
    from ..engine.inference import inference
    from ..models import build_detection_model
    from ..utils.checkpoint import Checkpointer
    from ..utils.logger import setup_logger

    c = cfg.clone()
    if args.config_file:
        c.merge_from_file(args.config_file)
    if args.opts:
        c.merge_from_list(args.opts)

    weights = args.ckpt or c.MODEL.WEIGHT
    logger = setup_logger("oneshotdet_tpu_torch", c.OUTPUT_DIR, "test_log.txt")
    logger.info(f"config:\n{c}")
    device = torch.device(args.device or "cuda")
    model = build_detection_model(c, device=device)
    stop = c.FEW_SHOT.STOP_ITER if c.FEW_SHOT.STOP_ITER > 0 else None

    def run_one(ckpt_path, out_dir):
        if ckpt_path:
            Checkpointer(out_dir, logger, cfg=c).load(model, f=ckpt_path, resume=False,
                                                      prefer_tag=False)
        loader, dataset = make_data_loader(c, is_train=False, device=device)
        return inference(c, model, loader, dataset, out_dir, stop, logger)

    if args.seq_test:
        for f in sorted(glob.glob(os.path.join(c.TEST.LOAD_DIR, "model_*"))):
            m = re.search(r"model_(\d+)", os.path.basename(f))
            if not m:
                continue
            it = int(m.group(1))
            if not (c.TEST.MIN_ITER <= it <= c.TEST.MAX_ITER):
                continue
            logger.info(f"=== seq_test checkpoint {f} ===")
            run_one(f, os.path.join(c.OUTPUT_DIR, f"eval_{it:07d}"))
    else:
        run_one(weights, os.path.join(c.OUTPUT_DIR, "eval"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
