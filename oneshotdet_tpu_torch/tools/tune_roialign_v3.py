"""The cross-ROI ROIAlign kernels on the card: parity and times.

    python3 oneshotdet_tpu_torch/tools/tune_roialign_v3.py [--iters 8] [--warmup 2] [--blocks 4,16,64]

Counterpart of ``tools/tune_roialign_v3.py``; needs one CUDA card and nvcc
and exits non-zero without CUDA. It
1. holds v4 (K5, ``ops/roi_align_v4.py``) and v3 (K4, ``ops/roi_align_v3.py``)
   to the plain exact ROIAlign (``ops/roi_align.py``) in float32 at a small
   size (P6-P7 maps of an 832x1216 image, 64 ROIs), abs 2e-5;
2. prints the largest K5 - K1 and K4 - K1 differences at the production
   shapes in bf16: batch 8, C = 256, the P3-P7 maps of 832x1216, 8 x 2000
   ROIs (K5 clamps the columns of ROIs wider than 56 cells, so it differs);
3. times K1, K4 and K5 (each of the latter at every ROIs-per-block value in
   ``--blocks``) with CUDA events, each call on inputs it has not seen, on the
   two ROI mixes of the JAX tool: ``uniform`` (box sides U(8, 640)) and
   ``p3-skew`` (U(8, 110), FCOS-like, mostly on P3).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from oneshotdet_tpu_torch.ops import roi_align as ra  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_align_v3 as v3  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_align_v4 as v4  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line, time_fresh_ms  # noqa: E402
from oneshotdet_tpu_torch.tools.ablate_v4 import (BATCH, CHANNELS, SCALES, SHAPES,  # noqa: E402
                                                  make_rois)

ROIS_PER_IMAGE = 2000
PARITY_ATOL = 2e-5


def make_inputs(seed, dev, small=False, dtype=torch.bfloat16, skew=None):
    """(features, rois, levels, scales) as the JAX tool draws them."""
    rr = np.random.RandomState(seed)
    shapes = SHAPES[3:] if small else SHAPES
    feats = [torch.from_numpy(rr.randn(BATCH, h, w, CHANNELS).astype(np.float32)).to(dev, dtype)
             for h, w in shapes]
    rois, lvl = make_rois(rr, 64 if small else BATCH * ROIS_PER_IMAGE, skew, 1 if small else 4)
    return (feats, torch.from_numpy(rois).to(dev), torch.from_numpy(lvl).to(dev),
            SCALES[3:] if small else SCALES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--blocks", default="4,16,64", help="ROIs per block to time K4 and K5 at")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_roialign_v3: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # ---- parity: f32, small shapes, against the exact ROIAlign -------------
    feats, rois, lvl, sc = make_inputs(7, dev, small=True, dtype=torch.float32)
    ref = ra.multilevel_roi_align_plain(feats, rois, lvl, (7, 7), sc, 2)
    for name, fn in (("v4 (K5)", v4.multilevel_roi_align_v4_cuda),
                     ("v3 (K4)", v3.multilevel_roi_align_v3_cuda)):
        d = float((fn(feats, rois, lvl, (7, 7), sc, 2) - ref).abs().max())
        print(f"{name}-vs-exact (f32 small) max|diff| = {d:.3e}", flush=True)
        if not d < PARITY_ATOL:
            raise AssertionError(f"{name}: {d} >= {PARITY_ATOL}")

    # ---- bf16 production shapes against K1 -----------------------------------
    feats, rois, lvl, sc = make_inputs(11, dev)
    k1 = ra.multilevel_roi_align_cuda(feats, rois, lvl, (7, 7), sc, 2).float()
    for name, fn in (("v4 (K5)", v4.multilevel_roi_align_v4_cuda),
                     ("v3 (K4)", v3.multilevel_roi_align_v3_cuda)):
        d = float((fn(feats, rois, lvl, (7, 7), sc, 2).float() - k1).abs().max())
        print(f"{name}-vs-K1 (bf16 prod, uniform mix) max|diff| = {d:.4f}", flush=True)
    del feats, rois, lvl, k1

    # ---- timing ------------------------------------------------------------
    blocks = [int(t) for t in args.blocks.split(",")]
    r = BATCH * ROIS_PER_IMAGE
    n = args.iters + args.warmup + 1
    for skew in (None, "p3"):
        name = "p3-skew" if skew else "uniform"
        inputs = [make_inputs(100 + i + (1000 if skew else 0), dev, skew=skew)[:3]
                  for i in range(n)]

        def report(label, fn):
            ms = time_fresh_ms(lambda f, ro, lv: fn(f, ro, lv, (7, 7), SCALES, 2), inputs,
                               args.warmup)
            print(f"[{name}] {label:<14} {ms:8.3f} ms/batch ({ms / r * 1000:.3f} us/ROI) [{card}]",
                  flush=True)

        report("K1 roi_align", ra.multilevel_roi_align_cuda)
        for t in blocks:
            report(f"K4 v3 t={t}", lambda *a, t=t: v3.multilevel_roi_align_v3_cuda(
                *a, rois_per_block=t))
            report(f"K5 v4 t={t}", lambda *a, t=t: v4.multilevel_roi_align_v4_cuda(
                *a, rois_per_block=t))
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
