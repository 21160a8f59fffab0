"""The fused relation head kernel (K3) on the card: parity with the unfused
head and times of both.

    python3 oneshotdet_tpu_torch/tools/tune_roi_head.py [--which both|fused|unfused] [--iters 8] [--warmup 2]

Counterpart of ``tools/tune_roi_head.py``; needs one CUDA card and nvcc and
exits non-zero without CUDA. With seeded weights (N(0, 1/fan_in) kernels)
it holds K3 (``ops/roi_head_fused.py``) to the port's unfused ``ROIBoxHead``
(cuBLAS/cuDNN layers) at a small size (16 ROIs, 2 images) in float32, abs
5e-3 (the JAX tool's bound), prints the bf16 difference, then times both in
bf16 at 8 images x 2000 ROIs with CUDA events, each call on inputs it has not
seen. The JAX tool's ``ONESHOT_ROI_HEAD_ABLATE`` and ``ONESHOT_ROI_HEAD_T``
are TPU knobs with no counterpart; ``tools/ablate_roi_head.py`` ablates K3.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_head_fused as rf  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line, time_fresh_ms  # noqa: E402

PARITY_ATOL = 5e-3
IMAGES, PER_IMAGE, CHANNELS = 8, 2000, 256


def seeded_head(seed: int) -> ROIBoxHead:
    gen = torch.Generator().manual_seed(seed)
    head = ROIBoxHead(in_channels=CHANNELS)
    with torch.no_grad():
        for name, p in head.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            p.copy_(n / math.sqrt(p[0].numel()) if p.dim() > 1
                    else (1.0 + 0.1 * n if name.endswith("weight") else 0.1 * n))
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", choices=("both", "fused", "unfused"), default="both")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_roi_head: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    head = seeded_head(0).to(dev).eval()
    packed = rf.pack_roi_head_params(head)

    # ---- parity (f32 and bf16, small) ------------------------------------
    rr = np.random.RandomState(0)
    roi = torch.from_numpy(rr.randn(16, 7, 7, CHANNELS).astype(np.float32)).to(dev)
    supp = torch.from_numpy(rr.randn(2, 7, 7, CHANNELS).astype(np.float32)).to(dev)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            ref_l, ref_d = head(roi.to(dtype), supp.to(dtype))
            got_l, got_d = rf.fused_roi_head_cuda(roi.to(dtype), supp.to(dtype),
                                                  rf.kernel_operands(packed, dtype), 8)
            dl = float((got_l - ref_l).abs().max())
            dd = float((got_d - ref_d).abs().max())
            print(f"head parity {str(dtype)[6:]}: logits max|d|={dl:.3e} deltas max|d|={dd:.3e}",
                  flush=True)
            if dtype == torch.float32 and not (dl < PARITY_ATOL and dd < PARITY_ATOL):
                raise AssertionError(f"fused head vs unfused (f32): {dl}, {dd} >= {PARITY_ATOL}")

    # ---- timing at production shapes (bf16) ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(900)
    inputs = [(torch.randn(IMAGES * PER_IMAGE, 7, 7, CHANNELS, generator=gen, device=dev,
                           dtype=torch.bfloat16),
               torch.randn(IMAGES, 7, 7, CHANNELS, generator=gen, device=dev,
                           dtype=torch.bfloat16))
              for _ in range(args.iters + args.warmup + 1)]
    ops = rf.kernel_operands(packed, torch.bfloat16)
    r = IMAGES * PER_IMAGE
    runs = {"unfused": lambda x, s: head(x, s),
            "fused": lambda x, s: rf.fused_roi_head_cuda(x, s, ops, PER_IMAGE)}
    with torch.inference_mode():
        for name, fn in runs.items():
            if args.which not in (name, "both"):
                continue
            ms = time_fresh_ms(fn, inputs, args.warmup)
            print(f"{name:<8} {ms:8.3f} ms/batch ({ms / r * 1000:.3f} us/ROI) [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
