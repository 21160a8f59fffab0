"""Where the GroupNorm kernels (K2) spend their time, launch by launch.

    python3 oneshotdet_tpu_torch/tools/ablate_group_norm.py [--reps 20] [--levels 3,4,5,6,7]
        [--dtypes bfloat16,float32] [--variants] [--root DIR]

Needs one CUDA card and nvcc. On the FCOS tower's maps (batch 8, P3-P7 of
832x1216, C = 256), bf16 and f32, with ReLU, prints for each map:

- each launch's device time: torch.profiler's CUDA kernel times by kernel
  name, the mean per launch over ``--reps`` back-to-back calls;
- the wrapper's time as a user calls it: ms per call over back-to-back calls
  (CUDA events, ``time_fresh_ms``), and the median of CUDA events around one
  call on an idle card, which holds the host's part of the call;
- the host time of the wrapper alone: the host clock around ``--reps`` calls
  that only enqueue their launches;
- the bound (x read once and y written once at 3.35 TB/s) and the two-launch
  design's floor (x read twice, y written once), with the kernels' share of
  each.

Every call gets an x that no earlier call of the run read (at least 200 MB of
inputs per map), so no call finds its x in the 50 MB L2 from an earlier call.
``--variants`` also builds copies of csrc/group_norm.cu with one change each
(``VARIANTS``) and times each beside the kernels as built: the normalize
launch taking the runs in the moments launch's order instead of the reverse
one, and two cuts of ``gn_moments`` (their outputs are wrong and only their
times count).
``--root DIR`` times the kernels of another checkout's
``oneshotdet_tpu_torch`` (an unpacked archive of an earlier commit) with this
script; it works only when the script runs as a program, since the package
must not be imported yet.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BATCH, CHANNELS, QUERY_HW = 8, 256, (832, 1216)
FRESH_BYTES = 200e6
# (name, [(text in group_norm.cu, replacement)]) for --variants: "forward
# order" has gn_normalize take the runs, and each lane its rows, in
# gn_moments' order; "no statistics" lets the image's last block reset its
# counter and leave (no sums over the runs, no mean/inv); "no moments reads"
# leaves gn_moments before its rows (no reads, no partial sums, no
# statistics), so gn_normalize then reads x from HBM where it otherwise finds
# part of it in L2
VARIANTS = [
    ("forward order", [("  const int split = gridDim.x - 1 - blockIdx.x;\n",
                        "  const int split = blockIdx.x;\n"),
                       ("  const int b = gridDim.y - 1 - blockIdx.y;\n",
                        "  const int b = blockIdx.y;\n"),
                       ("  t.off += (t.n - 1) * t.step;\n  t.step = -t.step;\n", "")]),
    ("no statistics", [("  if (!is_last) return;\n",
                        "  if (!is_last) return;\n  if (threadIdx.x == 0) arrivals[b] = 0u;\n"
                        "  return;\n")]),
    ("no moments reads", [("  const T* p = x + t.off;\n",
                           "  const T* p = x + t.off;\n  if (spatial > 0) return;\n")]),
]


def pyramid_shapes(h, w):
    """P3..P7 (H, W) of an (h, w) input through the R-50-FPN strides."""
    shapes = []
    for _ in range(3):
        h, w = (h + 1) // 2, (w + 1) // 2
    for _ in range(5):
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return shapes


def kernel_ms(fn, inputs):
    """{kernel name: device ms per launch} from torch.profiler over one call
    of ``fn`` on each input (each kernel launches once per call): the mean
    over the launches the profiler recorded."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            fn(*args)
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        m = re.search(r"(gn_[a-z_]+?)(?:_kernel)?(?:<|\(|$)", e.key)
        if not m:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        total[m.group(1)] = total.get(m.group(1), 0.0) + us / 1e3
        count[m.group(1)] = count.get(m.group(1), 0) + e.count
    return {name: total[name] / count[name] for name in total}


def one_call_ms(fn, inputs):
    """Median of CUDA events around one call on an idle card."""
    times = []
    for args in inputs:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, inputs):
    """Host clock per call around calls that only enqueue their launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in inputs:
        fn(*args)
    dt = (time.perf_counter() - t0) / len(inputs)
    torch.cuda.synchronize()
    return dt * 1e3


def measure(gn, x_all, gamma, beta, reps, act="relu"):
    """One map's numbers (see the module docstring) for ``group_norm_act_cuda``
    of the module ``gn`` over the fresh inputs ``x_all`` (one per row)."""
    from oneshotdet_tpu_torch.tools import time_fresh_ms

    fn = lambda x: gn.group_norm_act_cuda(x, gamma, beta, 32, 1e-5, act, 0.2)
    inputs = [(x,) for x in x_all]
    per_launch = kernel_ms(fn, inputs[:reps])
    b2b = time_fresh_ms(fn, inputs[reps:2 * reps + 2], warmup=1)
    one = one_call_ms(fn, inputs[2 * reps + 2:3 * reps + 2])
    host = host_ms(fn, inputs[:reps])
    x = x_all[0]
    nbytes = 2 * x.numel() * x.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(per_launch=per_launch, device_ms=sum(per_launch.values()), b2b_ms=b2b,
                one_call_ms=one, host_ms=host, bound_ms=bound, floor_ms=1.5 * bound)


def build_variants(workdir):
    """{variant name: (forward, error_string)} of copies of group_norm.cu
    with one change each, one nvcc each, all started together."""
    from oneshotdet_tpu_torch import csrc
    from oneshotdet_tpu_torch.ops import group_norm as gn

    src = open(os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc", "group_norm.cu")).read()
    procs = []
    for i, (name, patches) in enumerate(VARIANTS):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in group_norm.cu once")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"variant{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libvariant{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("group_norm"), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out}")
        libs[name] = gn.bind(ctypes.CDLL(lib))
    return libs


def report(label, r, card):
    launches = ", ".join(f"{k} {v:.4f}" for k, v in r["per_launch"].items())
    return (f"{label}: launches [{launches}] ms, device sum {r['device_ms']:.4f} ms; "
            f"back-to-back {r['b2b_ms']:.4f} ms/call; one call {r['one_call_ms']:.4f} ms "
            f"(idle card, median); host {r['host_ms']:.4f} ms/call; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_ms'] / r['b2b_ms']:.1%} of it back-to-back), 3-pass floor "
            f"{r['floor_ms']:.4f} ms ({r['floor_ms'] / r['b2b_ms']:.1%}) [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--levels", default="3,4,5,6,7")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--root", default=None)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    if args.root and args.variants:
        print("ablate_group_norm: --variants changes this checkout's kernels, not --root's",
              file=sys.stderr)
        return 2
    if args.root:
        if "oneshotdet_tpu_torch" in sys.modules:
            print("ablate_group_norm: --root needs a process that has not imported "
                  "oneshotdet_tpu_torch", file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.abspath(args.root))
    else:
        sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("ablate_group_norm: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from oneshotdet_tpu_torch.ops import group_norm as gn
    from oneshotdet_tpu_torch.tools import card_line

    card = card_line()
    print(f"{card}; kernels of {os.path.dirname(os.path.dirname(os.path.abspath(gn.__file__)))}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    gamma = 1.0 + 0.1 * torch.randn(CHANNELS, generator=gen, device=dev)
    beta = 0.1 * torch.randn(CHANNELS, generator=gen, device=dev)
    shapes = pyramid_shapes(*QUERY_HW)
    saved = getattr(gn, "_forward_fn", None)   # an earlier checkout's wrapper may lack it
    try:
        with tempfile.TemporaryDirectory() as workdir:
            kernels = {"as built": gn._kernel() if args.variants else None}
            if args.variants:
                kernels.update(build_variants(workdir))
            for dtype in (getattr(torch, d) for d in args.dtypes.split(",")):
                for lvl in (int(v) for v in args.levels.split(",")):
                    h, w = shapes[lvl - 3]
                    one = BATCH * h * w * CHANNELS * torch.finfo(dtype).bits // 8
                    n = max(3 * args.reps + 2, -(-int(FRESH_BYTES) // one))
                    x_all = torch.randn(n, BATCH, h, w, CHANNELS, generator=gen, device=dev,
                                        dtype=dtype)
                    for name, kernel in kernels.items():
                        if kernel is not None:
                            gn._forward_fn = kernel
                        r = measure(gn, x_all, gamma, beta, args.reps)
                        label = "" if kernel is None else f" {name}"
                        print(report(f"{str(dtype)[6:]} P{lvl} {(BATCH, h, w, CHANNELS)} "
                                     f"relu{label}", r, card), flush=True)
                    del x_all
                    torch.cuda.empty_cache()
    finally:
        if args.variants:
            gn._forward_fn = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
