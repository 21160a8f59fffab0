"""Process-group helpers (counterpart of ``oneshotdet_tpu/utils/comm.py``).

The port runs in one process on one card; a run inside a
``torch.distributed`` group of more than one process raises.
"""

from __future__ import annotations

import torch.distributed as dist


def get_world_size() -> int:
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process evaluation is not ported to oneshotdet_tpu_torch yet")
    return 1


def get_rank() -> int:
    get_world_size()
    return 0


def is_main_process() -> bool:
    return get_rank() == 0
