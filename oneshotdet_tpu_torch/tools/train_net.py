"""Training CLI of the port (counterpart of the root ``tools/train_net.py``).

    python -m oneshotdet_tpu_torch.tools.train_net --config-file CFG.yaml \
        [--device cpu] [--use-tensorboard] [KEY VALUE ...]

Merges the cfg, builds the detector on the card (or ``--device``) in train
mode with its SGD optimizer and WarmupMultiStep scheduler, and loads
weights through a ``Checkpointer`` on ``OUTPUT_DIR``: that folder's
``last_checkpoint`` tag wins over ``MODEL.WEIGHT`` (a ``.pth``, a Caffe2
``.pkl`` of ResNet blobs for both backbones, ``catalog://`` or a URL);
parameters named by FEW_SHOT.UNLOAD_KEYWORD keep their initial values, and
FEW_SHOT.RESUME keeps the file's iteration. With ``MODEL.FSS_WEIGHT`` the
load is two overlays: that file first, then ``MODEL.WEIGHT`` (or the tag)
with ``rpn.head`` kept as the first left it. Then it trains from the loaded
iteration to SOLVER.MAX_ITER over ``DATASETS.TRAIN[0]``, saving
``OUTPUT_DIR/model_{iter:07d}.pth`` every SOLVER.CHECKPOINT_PERIOD
iterations and ``model_final.pth`` at the end. ``--skip-test`` is accepted
as the JAX CLI accepts it (neither tests after training). One card: the JAX
CLI's device mesh and multi-host start have no counterpart.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="One-shot detection training (PyTorch/CUDA)")
    parser.add_argument("--config-file", default="", type=str)
    parser.add_argument("--skip-test", action="store_true")
    parser.add_argument("--use-tensorboard", action="store_true")
    parser.add_argument("--device", default="", help="torch device (default cuda)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    import torch

    from ..config import cfg
    from ..data import make_data_loader
    from ..engine import do_train
    from ..models import build_detection_model
    from ..solver import make_lr_scheduler, make_optimizer
    from ..utils.checkpoint import Checkpointer
    from ..utils.logger import setup_logger
    from ..utils.metric_logger import MetricLogger, TensorboardLogger

    c = cfg.clone()
    if args.config_file:
        c.merge_from_file(args.config_file)
    if args.opts:
        c.merge_from_list(args.opts)
    c.freeze()

    logger = setup_logger("oneshotdet_tpu_torch", c.OUTPUT_DIR)
    device = torch.device(args.device or "cuda")
    logger.info(f"device: {device}")
    logger.info(f"config:\n{c}")
    model = build_detection_model(c, device=device)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {n_params / 1e6:.1f}M")
    optimizer = make_optimizer(c, model)
    scheduler = make_lr_scheduler(c, optimizer)

    checkpointer = Checkpointer(c.OUTPUT_DIR, logger, cfg=c)
    state = dict(model=model, optimizer=optimizer, scheduler=scheduler)
    if c.MODEL.FSS_WEIGHT:
        checkpointer.load(**state, f=c.MODEL.FSS_WEIGHT, resume=False)
        start_iter = checkpointer.load(
            **state, f=c.MODEL.WEIGHT or None,
            unload_keywords=tuple(c.FEW_SHOT.UNLOAD_KEYWORD) + ("rpn.head",),
            resume=c.FEW_SHOT.RESUME)
    else:
        start_iter = checkpointer.load(**state, f=c.MODEL.WEIGHT or None,
                                       unload_keywords=c.FEW_SHOT.UNLOAD_KEYWORD,
                                       resume=c.FEW_SHOT.RESUME)
    logger.info(f"start_iter: {start_iter}")

    meters = (TensorboardLogger(c.TENSORBOARD_EXPERIMENT, start_iter) if args.use_tensorboard
              else MetricLogger())
    loader, _ = make_data_loader(c, is_train=True, start_iter=start_iter, device=device)
    do_train(c, model, optimizer, scheduler, loader, meters=meters, start_iter=start_iter,
             checkpointer=checkpointer, logger=logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
