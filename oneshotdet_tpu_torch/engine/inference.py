"""Inference engine (counterpart of ``oneshotdet_tpu/engine/inference.py``).

The eval loop runs the port's detector over batches of the collator's numpy
dicts (``query_pixels`` (B, H, W, 3), ``query_sizes`` (B, 2) true (h, w),
``supp_pixels`` (B * shot, h, w, 3), ``supp_sizes``, ``target_ids``,
``img_ids``, ``idxs``), trims the padded detections on the host and
evaluates them with the COCO protocol.

Differences from the JAX engine: the steps are plain functions that close
over the model, which holds its own weights (no ``variables`` argument, no
``jit``); they run under ``torch.inference_mode`` on the model's device; one
card only (a ``mesh`` raises); the multi-class step loops over classes in
Python where the JAX step scans.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..structures.image_batch import ImageBatch
from ..utils.metric_logger import Timer

_MODEL_KEYS = ("query_pixels", "query_sizes", "supp_pixels", "supp_sizes", "target_ids")


def _single_card(mesh):
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported to oneshotdet_tpu_torch; "
                                  "the engine runs on one card")


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _on(device, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device)


def _outputs(dets):
    return dets.xyxy, dets.get_field("scores"), dets.get_field("labels"), dets.valid


def make_eval_step(model, mesh=None):
    """Eval forward: batch dict -> (xyxy, scores, labels, valid), each (B, K, ...)."""
    _single_card(mesh)
    dev = _device(model)

    @torch.inference_mode()
    def eval_step(batch):
        b = {k: _on(dev, batch[k]) for k in _MODEL_KEYS}
        images = ImageBatch(pixels=b["query_pixels"], sizes=b["query_sizes"])
        supp = ImageBatch(pixels=b["supp_pixels"], sizes=b["supp_sizes"])
        return _outputs(model(images, supp, target_ids=b["target_ids"]))

    return eval_step


def make_cached_support_eval_steps(model, mesh=None):
    """Eval split into the support features, once per class, and the query
    forward against them: (support_step, query_step).

    ``support_step(supp_pixels, supp_sizes)`` -> (pooled per level, supp_7x7)
    of one episode's supports; ``query_step(batch, supp_pooled, supp_7x7)`` ->
    (xyxy, scores, labels, valid)."""
    _single_card(mesh)
    dev = _device(model)

    @torch.inference_mode()
    def support_step(supp_pixels, supp_sizes):
        supp = ImageBatch(pixels=_on(dev, supp_pixels), sizes=_on(dev, supp_sizes))
        return model.compute_support_features(supp, 1)

    @torch.inference_mode()
    def query_step(batch, supp_pooled, supp_7x7):
        images = ImageBatch(pixels=_on(dev, batch["query_pixels"]),
                            sizes=_on(dev, batch["query_sizes"]))
        return _outputs(model.detect_with_support(images, supp_pooled, supp_7x7,
                                                  _on(dev, batch["target_ids"])))

    return support_step, query_step


def make_multiclass_eval_step(model, mesh=None):
    """One query backbone+FPN pass shared by S support classes.

    Returns a step
        (batch, supp_pooled_stack, supp_7x7_stack, target_ids_stack)
          -> (xyxy, scores, labels, valid), each with leading (S, B, ...)
    where supp_pooled_stack is a list per FPN level of (S, 1, 1, 1, C),
    supp_7x7_stack is (S, 1, shot, 7, 7, C) -- class-level support features
    from ``compute_support_features`` at batch 1, stacked over classes -- and
    target_ids_stack is (S,)."""
    _single_card(mesh)
    dev = _device(model)

    @torch.inference_mode()
    def eval_step(batch, supp_pooled_stack, supp_7x7_stack, target_ids_stack):
        images = ImageBatch(pixels=_on(dev, batch["query_pixels"]),
                            sizes=_on(dev, batch["query_sizes"]))
        features = model.backbone_features(images)
        sizes_wh = images.sizes_wh()
        tids = _on(dev, target_ids_stack)
        outs = [_outputs(model.detect_from_features(
                    features, sizes_wh, [p[s] for p in supp_pooled_stack],
                    supp_7x7_stack[s], tids[s]))
                for s in range(tids.shape[0])]
        return tuple(torch.stack(field) for field in zip(*outs))

    return eval_step


def compute_on_dataset(
    model,
    data_loader,
    stop_iter: Optional[int] = None,
    logger=None,
    mesh=None,
    cache_supports: bool = False,
) -> Dict[int, dict]:
    """Run eval over the loader; returns {dataset index: prediction dict}
    with "boxes" (N, 4) xyxy and "scores" (N,) at network input scale and
    "input_size" (w, h), for every episode reached (``stop_iter`` stops
    early).

    cache_supports: compute support features once per target class and skip
    the support backbone afterwards -- valid when the support for a class is
    fixed across episodes (FEW_SHOT.CHOOSE_SELECTED protocol)."""
    if cache_supports:
        support_step, query_step = make_cached_support_eval_steps(model, mesh=mesh)
        supp_cache: dict = {}
    else:
        eval_step = make_eval_step(model, mesh=mesh)
    dev = _device(model)
    results: dict = {}
    timer = Timer()
    n_images = 0
    for it, batch in enumerate(data_loader):
        if stop_iter is not None and it >= stop_iter:
            break
        q = np.shape(batch["query_pixels"])
        if len(q) != 4 or q[-1] != 3:
            raise NotImplementedError(
                f"query_pixels of shape {q}: the engine takes (B, H, W, 3) pixels "
                "(TPU.HOST_S2D space-to-depth input is not ported)")
        timer.tic()
        if cache_supports:
            b = q[0]
            spp = np.shape(batch["supp_pixels"])[0] // b    # shots per image
            tids = np.asarray(batch["target_ids"]).tolist()
            for i, tid in enumerate(tids):
                if tid not in supp_cache:
                    supp_cache[tid] = support_step(
                        batch["supp_pixels"][i * spp:(i + 1) * spp],
                        batch["supp_sizes"][i * spp:(i + 1) * spp])
            pooled = [torch.cat([supp_cache[t][0][lvl] for t in tids], dim=0)
                      for lvl in range(len(supp_cache[tids[0]][0]))]
            supp_7x7 = torch.cat([supp_cache[t][1] for t in tids], dim=0)
            out = query_step(batch, pooled, supp_7x7)
        else:
            out = eval_step(batch)
        xyxy, scores, _, valid = out
        dt = timer.toc()
        b = q[0]
        n_images += b
        xyxy = xyxy.float().cpu().numpy()
        scores = scores.float().cpu().numpy()
        valid = valid.cpu().numpy()
        for i in range(b):
            idx = int(batch["idxs"][i])
            v = valid[i]
            h, w = np.asarray(batch["query_sizes"])[i]
            results[idx] = {
                "boxes": xyxy[i][v],
                "scores": scores[i][v],
                "input_size": (float(w), float(h)),
            }
        if logger and (it + 1) % 10 == 0:
            logger.info(
                f"eval iter {it + 1}: {dt / b * 1000:.1f} ms/im "
                f"(avg {timer.total_time / max(n_images, 1) * 1000:.1f}) on {dev}")
    if logger:
        logger.info(
            f"Total eval: {n_images} images, "
            f"{timer.total_time / max(n_images, 1) * 1000:.2f} ms/im on {dev}")
    return results


def inference(
    cfg,
    model,
    data_loader,
    dataset,
    output_folder: Optional[str] = None,
    stop_iter: Optional[int] = None,
    logger=None,
    mesh=None,
):
    """Inference + COCO-protocol evaluation. ``dataset`` is duck-typed:
    ``coco`` (a ``LiteCOCO``), ``id_to_img_map``, ``get_img_info(index)`` ->
    (image info, category) and ``len``."""
    from ..data.evaluation import evaluate
    from ..utils import comm

    comm.get_world_size()       # one process only
    t0 = time.time()
    # fixed per-class supports -> support features are computed once per
    # class and cached
    cache_supports = bool(cfg.FEW_SHOT.CHOOSE_SELECTED) and not cfg.FEW_SHOT.SUPP_AUG
    results_by_idx = compute_on_dataset(model, data_loader, stop_iter, logger, mesh=mesh,
                                        cache_supports=cache_supports)
    if logger:
        logger.info(f"inference wall time: {time.time() - t0:.1f}s")
    predictions: List[Optional[dict]] = [results_by_idx.get(i) for i in range(len(dataset))]
    if stop_iter is not None:
        # evaluate only reached episodes (the reference truncates the same way)
        reached = max(results_by_idx.keys(), default=-1) + 1
        return evaluate(_TrimmedDataset(dataset, reached), predictions[:reached],
                        output_folder, logger, box_only=cfg.MODEL.RPN_ONLY)
    return evaluate(dataset, predictions, output_folder, logger,
                    box_only=cfg.MODEL.RPN_ONLY)


class _TrimmedDataset:
    """View of the first N episodes of a dataset (stop_iter evaluation)."""

    def __init__(self, dataset, n):
        self._dataset = dataset
        self._n = n
        self.coco = dataset.coco
        self.id_to_img_map = {k: v for k, v in dataset.id_to_img_map.items() if k < n}

    def __len__(self):
        return self._n

    def get_img_info(self, index):
        return self._dataset.get_img_info(index)

    def __getattr__(self, name):
        return getattr(self._dataset, name)
