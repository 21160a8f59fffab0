"""Where the fused relation head kernel spends its time, by ablation.

    python3 oneshotdet_tpu_torch/tools/ablate_roi_head.py [--dtype bfloat16|float32]
        [--rois 16000] [--rounds 3] [--reps 10]

Needs one CUDA card and nvcc. Builds copies of csrc/roi_head.cu, each with
one part of the chosen route's work cut out (the results of the cut copies
are wrong and only their times count), and times each against the full
kernel with CUDA events on the main path's shapes: R ROIs, 2000 per image
(16 000 = 8 images). Prints the card, one line per copy and round
(interleaved) and the time each cut saves. Each cut's text must be in the
source once, or the tool raises.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from oneshotdet_tpu_torch import csrc  # noqa: E402
from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_head_fused as rf  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line  # noqa: E402

# The GN statistics code is shared by both routes' head_front.
NO_GN = ("no GN statistics", [(
    "  const float inv_n = 1.f / (float)(NPOS * GS);",
    "  return;\n  const float inv_n = 1.f / (float)(NPOS * GS);")])

# (name, [(text in roi_head.cu, replacement)]) per route. bf16:
# head_front_bf16 runs without a thread block cluster (its weight copies
# cost nothing measurable, the first cut shows), so there is no multicast to
# cut.
CUTS = {
    torch.bfloat16: [
        ("full", []),
        ("no producer copies", [(
            "        mbar_expect_tx(&full[stage], SLOT);\n"
            "        bulk_load(ring + stage * SLOT, src, SLOT, &full[stage]);",
            "        mbar_arrive(&full[stage]);")]),
        ("no head_front wgmma", [(
            "wgmma_rs<N>(d, a[kk], smem_desc(w + kk * 256, 128, KD * 16));",
            "d[0] += (float)a[kk][0];")]),
        NO_GN,
        ("no 3x3 conv (copies, products)", [(
            "constexpr int SA = 9 * C / KDA; ", "constexpr int SA = 0; ")]),
        ("no fc6/fc7 GEMM", [(
            "    if ((rc = launch_fc(args, s)) != 0) return rc;\n", "")]),
    ],
    torch.float32: [
        ("full", []),
        ("no producer copies", [(
            "        mbar_expect_tx(&full[stage], T_SLOT);\n"
            "        bulk_load(ring + stage * T_SLOT, slice_source_tf32(args, s), T_SLOT, "
            "&full[stage]);",
            "        mbar_arrive(&full[stage]);")]),
        ("one TF32 pass (hi x hi only)", [(
            "  wgmma_tf32<N>(d, f.lo, b_hi, acc);\n  wgmma_tf32<N>(d, f.hi, b_lo, 1);\n"
            "  wgmma_tf32<N>(d, f.hi, b_hi, 1);", "  wgmma_tf32<N>(d, f.hi, b_hi, acc);")]),
        ("no head_front wgmma", [(
            "    mma3<N>(d, f, smem_desc(w, 128, KD * 32), smem_desc(w + T_TILE, 128, KD * 32), 1);",
            "    d[0] += __uint_as_float(f.hi[0]) + __uint_as_float(f.lo[0]);")]),
        NO_GN,
        ("no 3x3 conv (copies, products)", [(
            "constexpr int TSA = 9 * T_HALF / TKDA; ", "constexpr int TSA = 0; ")]),
        ("no fc6/fc7 GEMM", [(
            "    if ((rc = launch_fc_tf32(args, s)) != 0) return rc;\n", "")]),
    ],
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(workdir, cuts):
    src = open(os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc", "roi_head.cu")).read()
    procs = []
    for i, (name, patches) in enumerate(cuts):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {name!r}: its text is not in roi_head.cu once")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"cut{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libcut{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("roi_head"), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {name!r}:\n{out}")
        handle = ctypes.CDLL(lib)
        handle.oneshot_roi_head_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        handle.oneshot_roi_head_forward.restype = ctypes.c_int
        handle.oneshot_roi_head_error_string.argtypes = [ctypes.c_int]
        handle.oneshot_roi_head_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--rois", type=int, default=16000, help="a multiple of 2000")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_roi_head: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dtype = DTYPES[args.dtype]
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
    ops = rf.kernel_operands(rf.pack_roi_head_params(head.cuda()), dtype)
    x = torch.randn(args.rois, 7, 7, 256, generator=gen).cuda().to(dtype)
    supp = torch.randn(args.rois // 2000, 7, 7, 256, generator=gen).cuda().to(dtype)

    def time_ms():
        rf.fused_roi_head_cuda(x, supp, ops, 2000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            rf.fused_roi_head_cuda(x, supp, ops, 2000)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    kernel = rf._kernel
    try:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build(workdir, CUTS[dtype])
            times = {name: [] for name in libs}
            for rnd in range(args.rounds):
                for name, lib in libs.items():
                    rf._kernel = lambda lib=lib: lib
                    times[name].append(time_ms())
                    print(f"round {rnd} {name}: {times[name][-1]:.3f} ms per call", flush=True)
    finally:
        rf._kernel = kernel
    full = min(times["full"])
    for name, t in times.items():
        print(f"{args.dtype} R={args.rois} {name:<30} {min(t):8.3f} ms  saves "
              f"{full - min(t):7.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
