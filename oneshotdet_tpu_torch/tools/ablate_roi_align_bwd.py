"""Where the ROIAlign backward kernel (K1b) spends its time, by variants.

    python3 oneshotdet_tpu_torch/tools/ablate_roi_align_bwd.py [--reps 20] [--rounds 2]

Needs one CUDA card and nvcc. Builds copies of csrc/roi_align_bwd.cu: as
built (one 16-byte vector atomic per four channels), with one scalar
float32 atomic per channel, and with the atomics cut out (its gradient is
wrong and only its time counts). Times each call of the wrapper (zeroing,
kernel, cast) with CUDA events, back to back and in interleaved rounds, at
the train step's proposals: R = 1024 over the batch-8 832x1216 pyramid
(C = 256), random ROIs (chip_smoke.random_rois) and ROIs crowded onto a few
GT-like boxes (chip_smoke.clustered_rois), bf16 and f32; the zeroing and the
cast alone; and checks the two full copies against the float32 plain
gradient. Prints the card and one line per copy, case and round.
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

import chip_smoke  # noqa: E402
from oneshotdet_tpu_torch import csrc  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_align as ra  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line  # noqa: E402

VECTOR = ("  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g[0], w * g[1], w * g[2], "
          "w * g[3]));")
SCALAR = ("  atomicAdd(p, w * g[0]);\n  atomicAdd(p + 1, w * g[1]);\n"
          "  atomicAdd(p + 2, w * g[2]);\n  atomicAdd(p + 3, w * g[3]);")
CUT = ("  if (w == 12345.f) atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g[0], "
       "w * g[1], w * g[2], w * g[3]));")
# (name, [(text in roi_align_bwd.cu, replacement)], its gradient is right)
VARIANTS = [("as built", [], True), ("scalar atomics", [(VECTOR, SCALAR)], True),
            ("no atomics", [(VECTOR, CUT)], False)]


def build(workdir):
    src_dir = os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc")
    src = open(os.path.join(src_dir, "roi_align_bwd.cu")).read()
    procs = []
    for i, (name, patches, _) in enumerate(VARIANTS):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in roi_align_bwd.cu once")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libv{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("roi_align_bwd"), "-I", src_dir, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out}")
        handle = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.oneshot_roi_align_backward.argtypes = [p, i, i, i, p, p, p, i, i, i, i, p, p]
        handle.oneshot_roi_align_backward.restype = ctypes.c_int
        handle.oneshot_roi_align_bwd_error_string.argtypes = [ctypes.c_int]
        handle.oneshot_roi_align_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs


def time_ms(call, reps):
    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_roi_align_bwd: no CUDA device visible to torch", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    shapes = [(chip_smoke.BATCH, h, w, 256)
              for h, w in chip_smoke.pyramid_shapes(*chip_smoke.QUERY_HW)]
    rois, valid = chip_smoke.random_rois(1024, chip_smoke.BATCH, chip_smoke.QUERY_HW, gen, dev)
    cases = [("random R=1024", rois, valid),
             ("GT-clustered R=1024", chip_smoke.clustered_rois(gen, dev), None)]
    ws_rows = sum(s[0] * s[1] * s[2] for s in shapes)
    loader = ra._bwd_kernel
    try:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build(workdir)
            for dtype in (torch.bfloat16, torch.float32):
                zero_ms = time_ms(lambda: torch.zeros((ws_rows, 256), device=dev), args.reps)
                ws = torch.zeros((ws_rows, 256), device=dev)
                cast_ms = time_ms(lambda: ra._split_workspace(ws, shapes, dtype), args.reps)
                del ws
                print(f"{str(dtype)[6:]}: zeroing the {4 * ws_rows * 256 / 1e6:.1f} MB workspace "
                      f"{zero_ms:.4f} ms, the cast {cast_ms:.4f} ms [{card}]", flush=True)
                for case, r, v in cases:
                    lv = ra.fpn_level_map(r[:, 1:], 3, 7)
                    g = torch.randn((r.shape[0], 7, 7, 256), generator=gen).to(dev, dtype)
                    bargs = (g, shapes, dtype, r, lv, (7, 7), chip_smoke.SCALES_Q, 2, v)
                    want = ra.multilevel_roi_align_backward_plain(
                        g.float(), shapes, torch.float32, r, lv, (7, 7), chip_smoke.SCALES_Q, 2, v)
                    for name, _, right in VARIANTS:
                        if right:
                            ra._bwd_kernel = lambda lib=libs[name]: lib
                            chip_smoke.grad_compare(f"{name} {case}", dtype,
                                                    ra.multilevel_roi_align_backward_cuda(*bargs),
                                                    want)
                    del want
                    for rnd in range(args.rounds):
                        for name, lib in libs.items():
                            ra._bwd_kernel = lambda lib=lib: lib
                            ms = time_ms(lambda: ra.multilevel_roi_align_backward_cuda(*bargs),
                                         args.reps)
                            print(f"{str(dtype)[6:]} {case} round {rnd} {name:<15} {ms:.4f} ms "
                                  f"per call [{card}]", flush=True)
                    torch.cuda.empty_cache()
    finally:
        ra._bwd_kernel = loader
    return 0


if __name__ == "__main__":
    sys.exit(main())
