"""Loading weights from a reference-format ``.pth`` (the load half of
``oneshotdet_tpu/utils/checkpoint.py``, for the format that
``oneshotdet_tpu/utils/torch_import.py::load_torch_checkpoint`` reads).

The port's parameter and buffer names are the reference's, so a file's
state dict (its ``"model"`` entry, or the whole file) loads with
``load_state_dict(strict=True)``. Saving, the ``last_checkpoint`` tag and
``merge_with_unload`` are not ported.
"""

from __future__ import annotations

import torch


def load_weights(model: torch.nn.Module, path: str, logger=None) -> int:
    """Load ``path`` into ``model`` (strict); returns the number of tensors
    loaded. The file is read with ``weights_only=True``: tensors, numbers,
    strings and containers of them."""
    if logger:
        logger.info(f"Loading checkpoint from {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    model.load_state_dict(state, strict=True)
    if logger:
        logger.info(f"checkpoint: {len(state)} of {len(model.state_dict())} tensors matched")
    return len(state)
