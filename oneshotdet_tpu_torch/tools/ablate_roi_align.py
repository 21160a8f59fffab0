"""Where the ROIAlign kernel (K1) spends its time, by ablation.

    python3 oneshotdet_tpu_torch/tools/ablate_roi_align.py [--reps 20] [--rounds 3]

Needs one CUDA card and nvcc. Builds copies of csrc/roi_align.cu, each with
one part of the work cut out (the outputs of the cut copies are wrong and
only their times count), and times each against the full kernel with CUDA
events, back-to-back calls, on the main path's shapes: the batch-8 832x1216
pyramid (C = 256) and 8 x 2000 ROIs of the JAX tool's FCOS-like p3-skew mix
(``tune_roialign_v3.make_inputs``), bf16 and f32. Prints the card, one line
per copy and round (interleaved) and the time each cut saves.
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
from oneshotdet_tpu_torch.tools import card_line  # noqa: E402
from oneshotdet_tpu_torch.tools.tune_roialign_v3 import SCALES, make_inputs  # noqa: E402

NO_SUMS = ("    for (int iy = 0; iy < grid; ++iy) {\n      const AxisSample sy",
           "    for (int iy = 0; iy < 0; ++iy) {\n      const AxisSample sy")
NO_COPIES = ("cp_async16(dst + o, src + o);", "if (o < 0) cp_async16(dst, src);")
# (name, [(text in roi_align.cu, replacement)]): "no sums" stores zeros for
# every bin (planning, copies and stores remain); "no copies" sums whatever
# the buffers hold (planning, sums and stores remain)
CUTS = [
    ("full", []),
    ("no sums", [NO_SUMS]),
    ("no copies", [NO_COPIES]),
    ("no sums, no copies", [NO_SUMS, NO_COPIES]),
]


def build(workdir):
    src = open(os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc", "roi_align.cu")).read()
    procs = []
    for i, (name, patches) in enumerate(CUTS):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {name!r}: its text is not in roi_align.cu once")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"cut{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libcut{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("roi_align"), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {name!r}:\n{out}")
        handle = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.oneshot_roi_align_forward.argtypes = [p, i, i, i, p, p, p, i, i, i, i, p, p, p]
        handle.oneshot_roi_align_forward.restype = ctypes.c_int
        handle.oneshot_cuda_error_string.argtypes = [ctypes.c_int]
        handle.oneshot_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_roi_align: no CUDA device visible to torch", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    kernel = ra._kernel
    try:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build(workdir)
            for dtype in (torch.bfloat16, torch.float32):
                feats, rois, levels, _ = make_inputs(900, dev, dtype=dtype, skew="p3")

                def time_ms():
                    call = lambda: ra.multilevel_roi_align_cuda(feats, rois, levels, (7, 7),
                                                               SCALES, 2)
                    call()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.reps):
                        call()
                    end.record()
                    end.synchronize()
                    return start.elapsed_time(end) / args.reps

                times = {name: [] for name in libs}
                for rnd in range(args.rounds):
                    for name, lib in libs.items():
                        ra._kernel = lambda lib=lib: lib
                        times[name].append(time_ms())
                        print(f"{str(dtype)[6:]} round {rnd} {name}: {times[name][-1]:.4f} ms "
                              f"per call", flush=True)
                full = min(times["full"])
                for name, t in times.items():
                    print(f"{str(dtype)[6:]} p3-skew R={rois.shape[0]} {name:<20} "
                          f"{min(t):8.4f} ms  saves {full - min(t):7.4f} ms [{card}]",
                          flush=True)
                del feats, rois, levels
                torch.cuda.empty_cache()
    finally:
        ra._kernel = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
