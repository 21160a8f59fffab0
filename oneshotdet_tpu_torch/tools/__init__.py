"""Tools of the port: the evaluation CLI ``test_net`` (``python -m
oneshotdet_tpu_torch.tools.test_net``, on the card or ``--device cpu``) and
kernel parity, timing and ablation scripts that run on one CUDA card (each
runs as ``python3 oneshotdet_tpu_torch/tools/<name>.py`` and as
``<module>.main(argv)``)."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_fresh_ms(fn, inputs, warmup: int) -> float:
    """ms per call of ``fn(*inputs[i])`` with CUDA events, over the inputs
    after the first ``warmup + 1`` (which warm up), each used once."""
    import torch

    for args in inputs[:warmup + 1]:
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timed = inputs[warmup + 1:]
    start.record()
    for args in timed:
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(timed)
