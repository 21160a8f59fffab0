"""Where the fused relation head kernel spends its time, by ablation.

    python3 oneshotdet_tpu_torch/tools/ablate_roi_head.py

Needs one CUDA card and nvcc. Builds copies of csrc/roi_head.cu, each with
one part of the bf16 work cut out (the results of the cut copies are wrong
and only their times count), and times each against the full kernel with
CUDA events on the main path's bf16 shapes: R = 16 000 ROIs, 8 images x
2000. Prints the card, one line per copy (three rounds, interleaved) and the
time each cut saves.
"""

from __future__ import annotations

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

# (name, [(text in roi_head.cu, replacement)]): each cut removes one part of
# the bf16 path. head_front_bf16 runs without a thread block cluster (its
# weight copies cost nothing measurable, the first cut shows), so there is
# no multicast to cut.
CUTS = [
    ("full", []),
    ("no producer copies", [(
        "        mbar_expect_tx(&full[stage], SLOT);\n"
        "        bulk_load(ring + stage * SLOT, src, SLOT, &full[stage]);",
        "        mbar_arrive(&full[stage]);")]),
    ("no head_front wgmma", [(
        "wgmma_rs<N>(d, a[kk], smem_desc(w + kk * 256, 128, KD * 16));",
        "d[0] += (float)a[kk][0];")]),
    ("no GN statistics", [(
        "  const float inv_n = 1.f / (float)(NPOS * GS);",
        "  return;\n  const float inv_n = 1.f / (float)(NPOS * GS);")]),
    ("no 3x3 conv (copies, products)", [(
        "constexpr int SA = 9 * C / KDA; ", "constexpr int SA = 0; ")]),
    ("no fc6/fc7 GEMM", [(
        "    if ((rc = launch_fc(args, s)) != 0) return rc;\n", "")]),
]


def build(workdir):
    src = open(os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc", "roi_head.cu")).read()
    procs = []
    for i, (name, patches) in enumerate(CUTS):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_roi_head: no CUDA device visible to torch", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(21)
    head = ROIBoxHead()
    with torch.no_grad():
        for name, p in head.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            p.copy_(n / math.sqrt(p[0].numel()) if p.dim() > 1
                    else (1.0 + 0.1 * n if name.endswith("weight") else 0.1 * n))
    ops = rf.kernel_operands(rf.pack_roi_head_params(head.cuda()), torch.bfloat16)
    x = torch.randn(16000, 7, 7, 256, generator=gen).cuda().bfloat16()
    supp = torch.randn(8, 7, 7, 256, generator=gen).cuda().bfloat16()

    def time_ms(reps=10):
        rf.fused_roi_head_cuda(x, supp, ops, 2000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            rf.fused_roi_head_cuda(x, supp, ops, 2000)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    with tempfile.TemporaryDirectory() as workdir:
        libs = build(workdir)
        times = {name: [] for name in libs}
        for rnd in range(3):
            for name, lib in libs.items():
                rf._kernel = lambda lib=lib: lib
                times[name].append(time_ms())
                print(f"round {rnd} {name}: {times[name][-1]:.3f} ms per call", flush=True)
    full = min(times["full"])
    for name, t in times.items():
        print(f"{name:<30} {min(t):8.3f} ms  saves {full - min(t):7.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
