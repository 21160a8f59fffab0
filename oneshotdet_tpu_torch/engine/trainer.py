"""Training loop on one card (counterpart of
``oneshotdet_tpu/engine/trainer.py``).

``train_step`` is the JAX package's ``make_train_step`` as eager PyTorch:
the train forward's loss dict, its sum, the backward, one optimizer step and
one scheduler step. ``do_train`` iterates it over a data loader from
``start_iter``, reads the metrics back from the card only every
``log_period`` iterations, as the JAX loop does, and saves a checkpoint
every SOLVER.CHECKPOINT_PERIOD iterations and at the end. There is no mesh
(one card).

The ROI sampling draws of iteration ``it`` come from ``step_generator(it)``,
a generator seeded with ``6666 * 2**32 + it``: a function
of the iteration alone, as the JAX package's ``fold_in(PRNGKey(6666),
step)``, so a run resumed at iteration k takes the draws of an
uninterrupted one.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..structures.boxes import Boxes
from ..structures.image_batch import ImageBatch


def batch_to_inputs(batch: Dict, device=None):
    """A flat batch dict (numpy arrays or tensors; see
    ``utils.synthetic.make_episodic_batch``) -> (images, supports, targets)
    on ``device``; the targets' field 'labels' is int32 and their size the
    queries' (w, h), with the fields 'masks' and 'keypoints' (float32) where
    the batch has ``gt_masks`` and ``gt_keypoints``."""
    def t(x, dtype=None):
        return torch.as_tensor(x, device=device, dtype=dtype)

    images = ImageBatch(pixels=t(batch["query_pixels"], torch.float32),
                        sizes=t(batch["query_sizes"], torch.float32))
    supp = ImageBatch(pixels=t(batch["supp_pixels"], torch.float32),
                      sizes=t(batch["supp_sizes"], torch.float32))
    fields = {"labels": t(batch["gt_labels"], torch.int32)}
    for key, name in (("gt_masks", "masks"), ("gt_keypoints", "keypoints")):
        if key in batch:
            fields[name] = t(batch[key], torch.float32)
    targets = Boxes(xyxy=t(batch["gt_xyxy"], torch.float32), valid=t(batch["gt_valid"], torch.bool),
                    size=images.sizes_wh(), fields=fields)
    return images, supp, targets


STEP_SEED = 6666


def step_generator(it: int, device) -> torch.Generator:
    """The generator of iteration ``it``'s sampling draws, on ``device``:
    seeded with ``6666 * 2**32 + it``."""
    return torch.Generator(device=device).manual_seed((STEP_SEED << 32) + int(it))


def train_step(model, optimizer, scheduler, batch: Dict,
               generator: Optional[torch.Generator] = None,
               draws: Optional[torch.Tensor] = None,
               it: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One update: forward_train, backward of the summed losses, an
    optimizer step and a scheduler step. Returns the losses and 'loss_total'
    as detached scalar tensors on the model's device (no host sync).
    ``draws`` (the sampling uniforms) or ``generator`` go to
    ``forward_train``; with neither, the draws come from
    ``step_generator(it)``."""
    device = next(model.parameters()).device
    if generator is None and draws is None:
        if it is None:
            raise ValueError("train_step needs the iteration it, a generator or draws")
        generator = step_generator(it, device)
    images, supp, targets = batch_to_inputs(batch, device)
    optimizer.zero_grad(set_to_none=True)
    losses = model.forward_train(images, supp, targets, generator=generator, draws=draws)
    total = sum(losses.values())
    total.backward()
    optimizer.step()
    scheduler.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss_total"] = total.detach()
    return metrics


def do_train(cfg, model, optimizer, scheduler, data_loader, meters=None, start_iter: int = 0,
             log_period: int = 100, generator: Optional[torch.Generator] = None,
             checkpointer=None, logger=None) -> int:
    """Train from ``start_iter`` until SOLVER.MAX_ITER or the loader ends.
    Each step's draws come from ``step_generator(it)``, or from
    ``generator`` where one is given. The losses of every step reach
    ``meters`` (a ``MetricLogger``) at each ``log_period``, when one line
    goes to ``logger`` (else stdout): the total, the load and compute
    seconds, and each loss of the step (loss_mask and loss_kp among them
    with MASK_ON / KEYPOINT_ON). With a ``checkpointer``, saves
    ``model_{it + 1:07d}`` after every SOLVER.CHECKPOINT_PERIOD-th iteration
    and ``model_final`` at the end. Returns the iteration reached."""
    max_iter = cfg.SOLVER.MAX_ITER
    period = cfg.SOLVER.CHECKPOINT_PERIOD
    log = logger.info if logger else (lambda msg: print(msg, flush=True))
    pending = []
    t_data = t_step = 0.0
    t0 = time.time()
    it = start_iter
    for batch in data_loader:
        if it >= max_iter:
            break
        t1 = time.time()
        metrics = train_step(model, optimizer, scheduler, batch, generator, it=it)
        log_now = (it + 1) % log_period == 0 or it + 1 == max_iter
        if meters is not None:
            pending.append(metrics)
        if log_now:
            # the one host read of the device's losses in this period
            for m in pending:
                meters.update(**{k: float(v) for k, v in m.items()})
            pending.clear()
        t2 = time.time()
        t_data += t1 - t0
        t_step += t2 - t1
        if log_now:
            span = (it % log_period) + 1
            terms = "  ".join(f"{k} {float(v):.4f}" for k, v in metrics.items()
                              if k != "loss_total")
            log(f"iter {it + 1}/{max_iter} loss {float(metrics['loss_total']):.4f} "
                f"load {t_data / span:.3f}s comp {t_step / span:.3f}s  {terms}")
            t_data = t_step = 0.0
        if checkpointer is not None and (it + 1) % period == 0:
            checkpointer.save(f"model_{it + 1:07d}", model, optimizer, scheduler, it + 1)
        t0 = time.time()
        it += 1
    if checkpointer is not None:
        checkpointer.save("model_final", model, optimizer, scheduler, it)
    return it
