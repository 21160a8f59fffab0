"""How far the fused head's float32 route (3xTF32 on wgmma) is from exact, by
stage.

    python3 oneshotdet_tpu_torch/tools/accuracy_roi_head.py [--rois 4096]

Needs one CUDA card and nvcc. Builds the kernel as it is and a copy whose
fc6/fc7 GEMM keeps one tensor-core sum over the whole of K (no float32
promotion of partial sums), runs both on the same seeded inputs (512 ROIs per
image, TF32 off for PyTorch's products) and prints, for each, the largest
error of the logits and deltas when the chain is finished exactly (float64)
from the kernel's own output of one stage on: the front (fc6's input ``a``),
fc6, fc7, and the kernel's outputs. The reference is the plain float32 front
(``head_front_chain``) finished in float64. It also prints fc6's error
against float64 on the kernel's own ``a``, largest and mean over the positive
outputs: a truncating sum shows as a mean below zero.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_head_fused as rf  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line  # noqa: E402
from oneshotdet_tpu_torch.tools.ablate_roi_head import build  # noqa: E402

PER_IMAGE = 512
COPIES = [
    ("as built (partial sums of 64 promoted)", []),
    ("one tensor-core sum over K", [
        ("        block(kb, 0, f0, kb % T_PROMOTE != 0);   // a group starts its own sum",
         "        block(kb, 0, f0, kb != 0);"),
        ("            tot[e] += acc[e];", "            tot[e] = acc[e];")]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rois", type=int, default=4096, help=f"a multiple of {PER_IMAGE}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("accuracy_roi_head: no CUDA device visible to torch", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(21)
    head = ROIBoxHead()
    with torch.no_grad():
        for name, p in head.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            p.copy_(n / math.sqrt(p[0].numel()) if p.dim() > 1
                    else (1.0 + 0.1 * n if name.endswith("weight") else 0.1 * n))
    ops = rf.kernel_operands(rf.pack_roi_head_params(head.cuda()), torch.float32)
    x = torch.randn(args.rois, 7, 7, 256, generator=gen).cuda()
    supp = torch.randn(args.rois // PER_IMAGE, 7, 7, 256, generator=gen).cuda()
    d = lambda t: t.double()
    hidden = ops["fc7"].shape[0]

    def tail(a=None, f6=None, f7=None):
        if f7 is None:
            if f6 is None:
                f6 = torch.relu(d(a) @ d(ops["fc6"]) + d(ops["fc6b"]))
            f7 = torch.relu(d(f6) @ d(ops["fc7"]) + d(ops["fc7b"]))
        return d(f7) @ d(ops["pred"]) + d(ops["predb"])

    with torch.inference_mode():
        plain_a = rf.head_front_chain(x, supp, ops, PER_IMAGE,
                                      lambda u, w: u.float() @ w.float())
        ref = tail(a=plain_a)
    kernel = rf._kernel
    try:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build(workdir, COPIES)
            for name, lib in libs.items():
                rf._kernel = lambda lib=lib: lib
                scratch = {}
                with torch.inference_mode():
                    logits, deltas = rf.fused_roi_head_cuda(x, supp, ops, PER_IMAGE, scratch)
                    torch.cuda.synchronize()
                    a = rf.untile_f32_rows(scratch["a"], args.rois, plain_a.shape[1])
                    f6 = rf.untile_f32_rows(scratch["f6"], args.rois, hidden)
                    stages = (("front (a)", tail(a=a)), ("front + fc6", tail(f6=f6)),
                              ("front + fc6 + fc7", tail(f7=scratch["f7"])),
                              ("kernel outputs", d(torch.cat([logits, deltas], 1))))
                    for stage, out in stages:
                        print(f"{name}: {stage}: logits and deltas max abs err "
                              f"{float((out - ref).abs().max()):.3e} [{card}]", flush=True)
                    exact6 = torch.relu(d(a) @ d(ops["fc6"]) + d(ops["fc6b"]))
                    e6 = (d(f6) - exact6)[exact6 > 0]
                    print(f"{name}: fc6 on the kernel's a vs float64: max abs err "
                          f"{float(e6.abs().max()):.3e}, mean {float(e6.mean()):.3e} "
                          f"(outputs up to {float(exact6.max()):.2f}) [{card}]", flush=True)
    finally:
        rf._kernel = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
