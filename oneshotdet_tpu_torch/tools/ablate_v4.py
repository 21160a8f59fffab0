"""Where the windowed ROIAlign kernel (v4, K5) spends its time, by ablation.

    python3 oneshotdet_tpu_torch/tools/ablate_v4.py [--iters 6] [--warmup 2] [--rounds 2]

Counterpart of ``tools/ablate_v4.py``; needs one CUDA card and nvcc and exits
non-zero without CUDA. Builds copies of csrc/roi_align_v4.cu with one part of
the work cut out (the results of the cut copies are wrong and only their
times count) and times each, and K1 (the exact ROIAlign), with CUDA events on
inputs each call has not seen: bf16, batch 8, the P3-P7 maps of 832x1216,
8 x 2000 ROIs of the ``p3-skew`` mix (box sides U(8, 110)).

The JAX tool's cuts ``noswap`` (the per-ROI (p, w) sublane swaps of Mosaic)
and ``nobd`` (the block-diagonal weight assembly in VMEM) name steps that the
CUDA kernel does not have: it contracts the window columns straight from the
map, with no transposed copy and no block-diagonal product. Its one cut is
``nostageb``: stage A (the rows) alone, its values summed into one output
column instead of weighed into every output column. ``noop`` returns from
the kernel at once: what is left is the wrapper's work around it (the dense
weights, the sort into blocks, the launch).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from oneshotdet_tpu_torch import csrc  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_align as ra  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_align_v4 as v4  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line, time_fresh_ms  # noqa: E402
from oneshotdet_tpu_torch.tools.tune_roialign_v3 import SCALES, make_inputs  # noqa: E402

STAGE_B = """#pragma unroll
        for (int q = 0; q < MAX_POOLED_W; ++q) {
          if (q >= pooled_w) break;
          const float wq = s_wx[q * WIN + w];
          acc[q].x += wq * a.x;
          acc[q].y += wq * a.y;
        }"""
# (name, [(text in roi_align_v4.cu, replacement)]): each cut removes one part
CUTS = [
    ("full", []),
    ("nostageb", [(STAGE_B, "acc[0].x += a.x;\n        acc[0].y += a.y;")]),
    ("noop", [("  const int k = blockIdx.x;\n  const int p = blockIdx.y;",
               "  if (blockDim.x > 0) return;\n  const int k = blockIdx.x;\n"
               "  const int p = blockIdx.y;")]),
]
NO_COUNTERPART = {
    "noswap": "no (p, w) swap exists: window columns are read in place",
    "nobd": "no block-diagonal weight matrix exists: each column is weighed directly",
}


def build(workdir):
    src = open(os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc", "roi_align_v4.cu")).read()
    procs = []
    for i, (name, patches) in enumerate(CUTS):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {name!r}: its text is not in roi_align_v4.cu once")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"cut{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libcut{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("roi_align_v4"), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    bound = v4._kernel()
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {name!r}:\n{out}")
        handle = ctypes.CDLL(lib)
        for fn in ("oneshot_roi_align_v4_forward", "oneshot_roi_align_v4_error_string"):
            getattr(handle, fn).argtypes = getattr(bound, fn).argtypes
            getattr(handle, fn).restype = getattr(bound, fn).restype
        libs[name] = handle
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_v4: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    for name, why in NO_COUNTERPART.items():
        print(f"{name}: not ablated ({why})", flush=True)
    r = 8 * 2000
    inputs = [make_inputs(7000 + i, dev, skew="p3")[:3]
              for i in range(args.iters + args.warmup + 1)]

    def run(fn):
        return time_fresh_ms(lambda f, ro, lv: fn(f, ro, lv, (7, 7), SCALES, 2), inputs,
                             args.warmup)

    kernel = v4._kernel
    times = {"K1 roi_align": []}
    with tempfile.TemporaryDirectory() as workdir:
        libs = build(workdir)
        times.update({f"v4[{name}]": [] for name in libs})
        try:
            for rnd in range(args.rounds):
                times["K1 roi_align"].append(run(ra.multilevel_roi_align_cuda))
                for name, lib in libs.items():
                    v4._kernel = lambda lib=lib: lib
                    times[f"v4[{name}]"].append(run(v4.multilevel_roi_align_v4_cuda))
                print(f"round {rnd}: " + ", ".join(f"{k} {v[-1]:.3f}" for k, v in times.items()),
                      flush=True)
        finally:
            v4._kernel = kernel
    full = min(times["v4[full]"])
    for name, t in times.items():
        print(f"{name:<14} {min(t):8.3f} ms/batch ({min(t) / r * 1000:.3f} us/ROI), "
              f"saves {full - min(t):8.3f} ms against v4[full] [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
