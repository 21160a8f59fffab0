"""Checkpoints (counterpart of ``oneshotdet_tpu/utils/checkpoint.py``, with
the load rules of ``oneshotdet_tpu/utils/torch_import.py``).

A save is ``<save_dir>/<name>.pth`` holding ``{"model": state dict,
"optimizer": ..., "scheduler": ..., "iteration": n}``, the reference's
maskrcnn_benchmark layout, so the JAX package's ``load_torch_checkpoint``
reads its ``"model"`` entry. Each save writes its path into
``<save_dir>/last_checkpoint``.

Loading overlays: a file's tensors replace the model's where the names
match (a leading ``module.``, from a run under DDP, stripped;
``num_batches_tracked`` and names the model lacks skipped; each reshaped to
the model's shape) and every other tensor keeps its current value. Tensors
whose name holds an UNLOAD keyword keep their current values too, by the
JAX package's two rules:

- the port's own saves (the file's ``"optimizer"`` has the group layout of
  the optimizer being restored), which stand in for the JAX package's orbax
  saves: parameters and buffers alike, as its orbax branch unloads params
  and constants;
- any other file (a reference-layout ``.pth``, a ``.pkl``): parameters only,
  buffers (FrozenBN statistics) always loaded, as its ``.pth`` branch
  applies ``merge_with_unload`` to its params only.

Likewise ``resume`` restores the iteration only from the port's own saves,
where the optimizer state is restored: the JAX package keeps the state's
fresh step for a ``.pth`` / ``.pkl``. The port's names are the reference's,
so the JAX package's flax-path keyword ``fcos_head`` is ``rpn.head`` here
and ``roi_head`` is ``roi_heads``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

URL_PREFIXES = ("catalog://", "http://", "https://", "file://")


def merge_with_unload(loaded: Mapping[str, torch.Tensor], fresh: Mapping[str, torch.Tensor],
                      unload_keywords: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``loaded``, with ``fresh``'s value for every name that holds a keyword."""
    return {k: fresh[k] if any(kw and kw in k for kw in unload_keywords) else v
            for k, v in loaded.items()}


def overlay_state_dict(model: torch.nn.Module, state: Mapping[str, object],
                       unload_keywords: Sequence[str] = (),
                       unload_buffers: bool = False) -> Tuple[List[str], List[str]]:
    """Copy ``state``'s tensors into ``model`` by the rules above (UNLOAD
    keywords on buffers too with ``unload_buffers``, for the port's own
    saves); returns the file's (matched, unmatched) names."""
    own = model.state_dict()
    params = {k for k, _ in model.named_parameters()}
    new, matched, unmatched = {}, [], []
    for key, value in state.items():
        name = key[len("module."):] if key.startswith("module.") else key
        if "num_batches_tracked" in name or name not in own:
            unmatched.append(key)
            continue
        new[name] = torch.as_tensor(value).reshape(own[name].shape)
        matched.append(key)
    kept = merge_with_unload({k: v for k, v in new.items() if unload_buffers or k in params},
                             own, unload_keywords)
    new.update(kept)
    with torch.no_grad():
        for name, value in new.items():
            if value is not own[name]:      # not kept by an UNLOAD keyword
                own[name].copy_(value)
    return matched, unmatched


def _same_layout(optimizer: torch.optim.Optimizer, state: Mapping) -> bool:
    groups = state.get("param_groups", ())
    return len(groups) == len(optimizer.param_groups) and all(
        len(g["params"]) == len(o["params"]) for g, o in zip(groups, optimizer.param_groups))


class Checkpointer:
    def __init__(self, save_dir: str, logger=None, cfg=None):
        self.save_dir = os.path.abspath(save_dir)
        self.logger = logger
        self.cfg = cfg          # for cfg.PATHS_CATALOG
        os.makedirs(self.save_dir, exist_ok=True)

    def _log(self, msg: str):
        if self.logger:
            self.logger.info(msg)
        else:
            print(msg, flush=True)

    def tag_file(self) -> str:
        return os.path.join(self.save_dir, "last_checkpoint")

    def has_checkpoint(self) -> bool:
        return os.path.exists(self.tag_file())

    def get_checkpoint_file(self) -> str:
        try:
            with open(self.tag_file()) as f:
                return f.read().strip()
        except OSError:
            return ""

    def save(self, name: str, model: torch.nn.Module, optimizer=None, scheduler=None,
             iteration: int = 0) -> str:
        """Write ``<save_dir>/<name>.pth`` and point the tag at it."""
        path = os.path.join(self.save_dir, f"{name}.pth")
        data = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "iteration": int(iteration)}
        if optimizer is not None:
            data["optimizer"] = optimizer.state_dict()
        if scheduler is not None:
            data["scheduler"] = scheduler.state_dict()
        torch.save(data, path)
        with open(self.tag_file(), "w") as f:
            f.write(path)
        self._log(f"Saved checkpoint to {path}")
        return path

    def load(self, model: torch.nn.Module, optimizer=None, scheduler=None,
             f: Optional[str] = None, unload_keywords: Sequence[str] = (), resume: bool = True,
             prefer_tag: bool = True) -> int:
        """Overlay a checkpoint onto ``model``; returns the iteration to start
        from: the file's ``"iteration"`` under ``resume`` where the file is
        one of the port's own saves (its optimizer state restored), else 0.

        The save_dir's tag wins over ``f`` unless ``prefer_tag=False`` (pass
        that where ``f`` names the exact file to evaluate). ``catalog://``
        and URLs resolve through ``model_zoo``; a ``.pkl`` holds Caffe2
        ResNet blobs, loaded into both Siamese bodies; any other file is a
        ``torch.save`` dict (its ``"model"`` entry, or the whole dict). Where
        the file has an ``"optimizer"`` of ``optimizer``'s group layout (the
        port's own saves), it and the ``"scheduler"`` are restored, whatever
        ``resume`` says, as the JAX package restores its optimizer state
        (and with it the schedule's count), and UNLOAD keywords keep buffers
        fresh too."""
        if prefer_tag and self.has_checkpoint():
            f = self.get_checkpoint_file()
        if not f:
            self._log("No checkpoint found. Initializing model from scratch")
            return 0
        if f.startswith(URL_PREFIXES):
            from .model_zoo import resolve_weight_path

            f = resolve_weight_path(f, cfg=self.cfg, logger=self.logger)
        self._log(f"Loading checkpoint from {f}")
        if f.endswith(".pkl"):
            from .c2_import import backbone_state_dict, convert_c2_resnet, load_c2_pickle

            body, matched, unmatched = convert_c2_resnet(load_c2_pickle(f))
            self._log(f"caffe2 import: {len(matched)} matched, {len(unmatched)} unmatched")
            ckpt, state = {}, backbone_state_dict(body)
        else:
            ckpt = torch.load(f, map_location="cpu", weights_only=True)
            state = ckpt.get("model", ckpt)
        own_save = (optimizer is not None and "optimizer" in ckpt
                    and _same_layout(optimizer, ckpt["optimizer"]))
        matched, unmatched = overlay_state_dict(model, state, unload_keywords,
                                                unload_buffers=own_save)
        self._log(f"checkpoint: {len(matched)} matched, {len(unmatched)} unmatched")
        if own_save:
            optimizer.load_state_dict(ckpt["optimizer"])
            if scheduler is not None and "scheduler" in ckpt:
                scheduler.load_state_dict(dict(ckpt["scheduler"]))
            self._log("optimizer and scheduler state restored")
        elif optimizer is not None and "optimizer" in ckpt:
            self._log("optimizer state of another group layout left out")
        return int(ckpt.get("iteration", 0)) if resume and own_save else 0

