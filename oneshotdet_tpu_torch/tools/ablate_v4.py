"""Where the cross-ROI ROIAlign kernels K4 (v3) and K5 (v4) spend their time,
launch by launch.

    python3 oneshotdet_tpu_torch/tools/ablate_v4.py [--reps 10] [--kernels v3,v4]
        [--rois 16000,4096] [--dtypes bfloat16,float32] [--mixes p3-skew,uniform]
        [--variants] [--root DIR]

Counterpart of ``tools/ablate_v4.py``; needs one CUDA card and nvcc and exits
non-zero without CUDA. On batch 8, C = 256, the P3-P7 maps of 832x1216, with
the ROI mixes of the JAX tool (``uniform``: box sides U(8, 640); ``p3-skew``:
U(8, 110), FCOS-like, mostly on P3; ``--rois`` per batch, image-major), 7x7
output and sampling ratio 2, it prints for each kernel, dtype, mix and R:

- every launch of one call, by kernel name, with its device time
  (torch.profiler over ``--reps`` calls, ms per call), grouped as
  ``prologue`` (the PyTorch work of the wrapper: elementwise ops, sorts,
  copies), ``sort`` (the block sort) and ``body`` (the ROIAlign kernel);
- ms per call back to back (CUDA events, ``time_fresh_ms``) and the median of
  CUDA events around one call on an idle card;
- the host time per call: the host clock around ``--reps`` calls (a call
  that waits for the card inside, as a blocking copy does, counts that wait);
- the bound (the pyramid, ROIs and levels read once, the output written once
  at 3.35 TB/s) and the share of it back to back.

Every call gets ROIs that no earlier call had; the calls take turns over
``PYRAMIDS`` pyramids, so that each finds its maps out of the 50 MB L2.

``--variants`` also builds copies of csrc/roi_align_v3.cu and
csrc/roi_align_v4.cu with one change each (``VARIANTS``) and times each
beside the kernels as built: ``noop`` returns from the body at once (what is
left is the block sort and the launches), ``oney`` (K4) and ``nostageb``
(K5) keep only the first term of the outer sum, the first y tap and the
first window column (what is left: one inner contraction per bin),
``oneaddr`` loads every tap of an inner contraction from one address (all
L1 hits: what is left is the instructions), ``noreuse`` recomputes every
inner contraction, ``reuse 2`` keeps K5's last
two stage-A values instead of one, ``min blocks n`` budgets registers for n
resident blocks, and
``staged`` copies each ROI's footprint into shared memory by ``cp.async``
when it fits and reads its taps from there. The cut copies' results are wrong
and only their times count; ``staged`` is checked against the kernel as
built. The JAX tool's cuts ``noswap`` (the per-ROI (p, w) sublane swaps of
Mosaic) and ``nobd`` (the block-diagonal weight assembly in VMEM) name steps
that the CUDA kernels do not have.

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BATCH, CHANNELS = 8, 256
SHAPES = [(104, 152), (52, 76), (26, 38), (13, 19), (7, 10)]
SCALES = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
PYRAMIDS = 3                  # pyramids the timed calls take turns over
MIXES = {"uniform": None, "p3-skew": "p3"}
BODY = re.compile(r"roi_align_v[34]_kernel")
SORT = re.compile(r"slab_sort")
LAUNCH = re.compile(r"cu(da)?(LaunchKernel|Memcpy|Memset)")
NO_COUNTERPART = {
    "noswap": "no (p, w) swap exists: window columns are read in place",
    "nobd": "no block-diagonal weight matrix exists: each column is weighed directly",
}

# --variants: (kernel, name, [(file in csrc/, text, replacement)]); each text
# must be in its file once. The copies take csrc/'s three sources, patched.
V3, V4, TAPS = "roi_align_v3.cu", "roi_align_v4.cu", "roi_align_taps.cuh"
_NOOP = ("  const int group = a.block_group[blockIdx.x];\n",
         "  const int group = a.block_group[blockIdx.x];\n  if (group >= 0) return;\n")
_ONE_ADDR = (TAPS, "      if (k0 + k < n && active) v[k] = V::load(p + cell[k0 + k] * stride);\n",
             "      if (k0 + k < n && active) v[k] = V::load(p);\n")
_V3_BOUNDS = "BODY_WARPS * 32, sizeof(T) == 4 ? 4 : 3)"
_V4_BOUNDS = "BODY_WARPS * 32, 4)"
# staged: each lane copies its channel vector of a band of pixels into shared
# memory by cp.async (K4: the chunk's tap rows x one output column's tap
# columns; K5: one output row's tap rows x the ROI's tap columns) when the
# band fits STAGE_PX pixels, and contracts from there; 4 warps a block, so
# that the buffers fit the static shared memory; loads through the generic
# path, which reaches both memories
_STAGE = """#define STAGE_PX 20
template <typename T, int N>
__device__ __forceinline__ bool stage(T* buf, const T* src, int y0, int y1, int x0, int x1,
                                      int width, int channels, bool active) {
  const int nc = x1 - x0 + 1, npx = (y1 - y0 + 1) * nc;
  if (y1 < y0 || npx > STAGE_PX) return false;
  for (int i = 0; i < npx; ++i) {
    const T* from = src + ((int64_t)(y0 + i / nc) * width + x0 + i % nc) * channels;
    const unsigned to = (unsigned)__cvta_generic_to_shared(buf + i * 32 * N);
    if (active)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(to), "l"(from),
                   "n"(N * sizeof(T)) : "memory");
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
  return true;
}

"""
_STAGE_COMMON = [
    (TAPS, "#define BODY_WARPS 8 ", "#define BODY_WARPS 4 "),
    (TAPS, "    return __ldg(reinterpret_cast<const raw*>(p));\n",
     "    return *reinterpret_cast<const raw*>(p);\n"),
    (TAPS, "// The last one or two inner contractions",
     _STAGE + "// The last one or two inner contractions"),
]
_STAGE_BUF = ("  Taps& tp = s_taps[warp];\n",
              "  Taps& tp = s_taps[warp];\n"
              "  __shared__ __align__(16) T s_stage[BODY_WARPS][STAGE_PX * 32 * N];\n"
              "  T* sbuf = s_stage[warp] + lane * N;\n")
_STAGE_V3 = [
    (V3,) + _STAGE_BUF,
    (V3, "      for (int q = 0; q < pw; ++q) {\n        Recent<N, 2> recent;\n",
     """      int sy0 = 1 << 30, sy1 = -1;
      for (int pp = 0; pp < rows; ++pp)
        for (int j = 0; j < tp.ny[pp]; ++j) {
          sy0 = min(sy0, tp.yc[pp][j]);
          sy1 = max(sy1, tp.yc[pp][j]);
        }
      for (int q = 0; q < pw; ++q) {
        Recent<N, 2> recent;
        int sx0 = 1 << 30, sx1 = -1;
        for (int k = 0; k < tp.nx[q]; ++k) {
          sx0 = min(sx0, tp.xc[q][k]);
          sx1 = max(sx1, tp.xc[q][k]);
        }
        const bool staged = stage<T, N>(sbuf, base + c, sy0, sy1, sx0, sx1, width, C, active);
"""),
    (V3, "              contract<T, N>(base + (int64_t)y * width * C + c, tp.xc[q], tp.xw[q], "
         "tp.nx[q],\n                             C, active, sx);\n",
     """              if (staged)
                contract<T, N>(sbuf + ((int64_t)(y - sy0) * (sx1 - sx0 + 1) - sx0) * 32 * N,
                               tp.xc[q], tp.xw[q], tp.nx[q], 32 * N, active, sx);
              else
                contract<T, N>(base + (int64_t)y * width * C + c, tp.xc[q], tp.xw[q],
                               tp.nx[q], C, active, sx);
"""),
]
_STAGE_V4 = [
    (V4,) + _STAGE_BUF,
    (V4, "      for (int pp = 0; pp < rows; ++pp) {\n        // along the output row",
     """      int sx0 = 1 << 30, sx1 = -1;
      for (int q = 0; q < pw; ++q)
        for (int i = 0; i < tp.nx[q]; ++i) {
          sx0 = min(sx0, tp.xc[q][i]);
          sx1 = max(sx1, tp.xc[q][i]);
        }
      for (int pp = 0; pp < rows; ++pp) {
        int sy0 = 1 << 30, sy1 = -1;
        for (int k = 0; k < tp.ny[pp]; ++k) {
          sy0 = min(sy0, tp.yc[pp][k]);
          sy1 = max(sy1, tp.yc[pp][k]);
        }
        const bool staged = stage<T, N>(sbuf, base + c, sy0, sy1, sx0, sx1, width, C, active);
        // along the output row"""),
    (V4, "              contract<T, N>(base + (int64_t)x * C + c, tp.yc[pp], tp.yw[pp], "
         "tp.ny[pp],\n                             (int64_t)width * C, active, sa);\n",
     """              if (staged)
                contract<T, N>(sbuf + ((int64_t)(x - sx0) - (int64_t)sy0 * (sx1 - sx0 + 1)) * 32 * N,
                               tp.yc[pp], tp.yw[pp], tp.ny[pp], (int64_t)(sx1 - sx0 + 1) * 32 * N,
                               active, sa);
              else
                contract<T, N>(base + (int64_t)x * C + c, tp.yc[pp], tp.yw[pp], tp.ny[pp],
                               (int64_t)width * C, active, sa);
"""),
]
VARIANTS = [
    ("v3", "noop", [(V3,) + _NOOP]),
    ("v3", "oney", [(V3, "          for (int j = 0; j < ny; ++j) {\n",
                     "          for (int j = 0; j < min(ny, 1); ++j) {\n")]),
    ("v3", "noreuse", [(V3, "            if (!recent.get(y, sx)) {\n", "            {\n")]),
    ("v3", "staged", _STAGE_COMMON + _STAGE_V3),
    ("v3", "oneaddr", [_ONE_ADDR]),
    ("v4", "noop", [(V4,) + _NOOP]),
    ("v4", "nostageb", [(V4, "          for (int i = 0; i < nx; ++i) {\n",
                         "          for (int i = 0; i < min(nx, 1); ++i) {\n")]),
    ("v4", "noreuse", [(V4, "            if (!recent.get(x, sa)) {\n", "            {\n")]),
    ("v4", "reuse 2", [(V4, "        Recent<N, 1> recent;\n", "        Recent<N, 2> recent;\n")]),
    ("v4", "staged", _STAGE_COMMON + _STAGE_V4),
    ("v4", "oneaddr", [_ONE_ADDR]),
] + [("v3", f"min blocks {n}", [(V3, _V3_BOUNDS, f"BODY_WARPS * 32, {n})")]) for n in (1, 3, 4)
     ] + [("v4", f"min blocks {n}", [(V4, _V4_BOUNDS, f"BODY_WARPS * 32, {n})")]) for n in (1, 3)]
# the variants that compute what the kernel computes: checked against it
EXACT = ("noreuse", "reuse 2", "staged", "min blocks 1", "min blocks 3", "min blocks 4")


def make_rois(rr, nroi: int, skew=None, kmax: int = 4):
    """(rois (n, 5) float32, levels (n,) int32) in numpy as the JAX tool draws
    them: box sides U(8, 640) (``skew=None``) or U(8, 110) (``"p3"``), image
    major, the FPN level rule on 224 with levels 0..kmax."""
    hi = 110 if skew == "p3" else 640
    wh = rr.uniform(8, hi, (nroi, 2)).astype(np.float32)
    xy = rr.uniform(0, 1, (nroi, 2)).astype(np.float32) * (np.array([1200, 800]) - wh)
    rois = np.concatenate([np.repeat(np.arange(BATCH, dtype=np.float32), nroi // BATCH)[:, None],
                           xy, xy + wh], axis=1).astype(np.float32)
    area = wh[:, 0] * wh[:, 1]
    lvl = np.clip(np.floor(4 + np.log2(np.sqrt(area) / 224 + 1e-8)) - 3, 0, kmax)
    return rois, lvl.astype(np.int32)


def kernel_ms(fn, inputs):
    """torch.profiler over one call of ``fn`` on each input: ([(kernel name,
    group, launches per call, device ms per call)], launches per call). The
    launches are the host's runtime calls that put work on the card (kernel
    launches, copies, memsets): the tracer can drop a kernel's device record,
    never its launch call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # a first, unrecorded step with one call: the tracer can lose the device
    # records of the first calls after it starts
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in ([inputs[0]], inputs):
            for args in step:
                fn(*args)
            torch.cuda.synchronize()
            prof.step()
    rows, launches = [], 0
    for e in prof.key_averages():
        if LAUNCH.match(e.key):
            launches += e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        group = "body" if BODY.search(e.key) else "sort" if SORT.search(e.key) else "prologue"
        rows.append((e.key, group, e.count / len(inputs), us / 1e3 / len(inputs)))
    return sorted(rows, key=lambda r: -r[3]), launches / len(inputs)


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
    """Host clock per call around back-to-back calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in inputs:
        fn(*args)
    dt = (time.perf_counter() - t0) / len(inputs)
    torch.cuda.synchronize()
    return dt * 1e3


def bound_ms(feats, rois, levels, out_numel, elt):
    nbytes = (sum(f.numel() for f in feats) * elt + rois.numel() * 4 + levels.numel() * 4
              + out_numel * elt)
    return nbytes / HBM_BYTES_PER_S * 1e3


def measure(fn, inputs, reps):
    """One configuration's numbers for ``fn(feats, rois, levels)`` over the
    inputs (at least 4 * reps + 2 of them)."""
    from oneshotdet_tpu_torch.tools import time_fresh_ms

    fn(*inputs[0])
    launches, n_launches = kernel_ms(fn, inputs[1:reps + 1])
    b2b = time_fresh_ms(fn, inputs[reps + 1:2 * reps + 2], warmup=0)
    one = one_call_ms(fn, inputs[2 * reps + 2:3 * reps + 2])
    host = host_ms(fn, inputs[3 * reps + 2:4 * reps + 2])
    groups = {g: sum(r[3] for r in launches if r[1] == g) for g in ("prologue", "sort", "body")}
    return dict(launches=launches, groups=groups, device_ms=sum(groups.values()),
                n_launches=n_launches, b2b_ms=b2b, one_call_ms=one, host_ms=host)


def report(label, m, bound, card):
    parts = "; ".join(f"{g} {m['groups'][g]:.4f}" for g in ("prologue", "sort", "body"))
    lines = [f"{label}: {m['n_launches']:.0f} launches per call, device {m['device_ms']:.4f} ms "
             f"({parts}); back-to-back {m['b2b_ms']:.4f} ms/call; one call {m['one_call_ms']:.4f} "
             f"ms (idle card, median); host {m['host_ms']:.4f} ms/call; bound {bound:.4f} ms "
             f"({bound / m['b2b_ms']:.1%} of it back-to-back) [{card}]"]
    for name, group, n, ms in m["launches"]:
        short = name if len(name) <= 90 else name[:87] + "..."
        lines.append(f"    {group:<8} {n:5.2f}x {ms:8.4f} ms  {short}")
    return "\n".join(lines)


def build_variants(workdir, names):
    """{(kernel, variant): ctypes library} of copies of the kernels' sources
    with one change each, one nvcc each, all started together."""
    from oneshotdet_tpu_torch import csrc

    procs = []
    for i, (kernel, name, patches) in enumerate(VARIANTS):
        if kernel not in names:
            continue
        texts = {f: open(os.path.join(csrc._SRC_DIR, f)).read() for f in (V3, V4, TAPS)}
        for f, old, new in patches:
            if texts[f].count(old) != 1:
                raise RuntimeError(f"variant {kernel} {name!r}: its text is not in {f} once")
            texts[f] = texts[f].replace(old, new)
        vdir = os.path.join(workdir, f"variant{i}")
        os.makedirs(vdir)
        for f, text in texts.items():
            with open(os.path.join(vdir, f), "w") as out:
                out.write(text)
        src_name = f"roi_align_{kernel}"
        lib = os.path.join(vdir, f"lib{src_name}.so")
        procs.append(((kernel, name), lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags(src_name), "-o", lib, os.path.join(vdir, f"{src_name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{out}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", default="v3,v4")
    ap.add_argument("--rois", default="16000,4096")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--mixes", default="p3-skew,uniform")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    if args.root and args.variants:
        print("ablate_v4: --variants changes this checkout's kernels, not --root's",
              file=sys.stderr)
        return 2
    if args.root:
        if "oneshotdet_tpu_torch" in sys.modules:
            print("ablate_v4: --root needs a process that has not imported oneshotdet_tpu_torch",
                  file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.abspath(args.root))
    else:
        sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("ablate_v4: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from oneshotdet_tpu_torch.ops import roi_align_v3 as v3
    from oneshotdet_tpu_torch.ops import roi_align_v4 as v4
    from oneshotdet_tpu_torch.tools import card_line

    card = card_line()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(v3.__file__)))
    print(f"{card}; kernels of {pkg}", flush=True)
    for name, why in NO_COUNTERPART.items():
        print(f"{name}: not ablated ({why})", flush=True)
    mods = {"v3": (v3, v3.multilevel_roi_align_v3_cuda), "v4": (v4, v4.multilevel_roi_align_v4_cuda)}
    kernels = args.kernels.split(",")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    n_calls = 4 * args.reps + 2
    saved = {k: mods[k][0]._kernel for k in kernels}
    try:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build_variants(workdir, kernels) if args.variants else {}
            for dtype in (getattr(torch, d) for d in args.dtypes.split(",")):
                pyramids = [[torch.randn(BATCH, h, w, CHANNELS, generator=gen, device=dev,
                                         dtype=dtype) for h, w in SHAPES]
                            for _ in range(PYRAMIDS)]
                for mix in args.mixes.split(","):
                    for r in (int(v) for v in args.rois.split(",")):
                        rr = np.random.RandomState(7000 + 10 * list(MIXES).index(mix) + r)
                        inputs = []
                        for i in range(n_calls):
                            rois, lvl = make_rois(rr, r, MIXES[mix])
                            inputs.append((pyramids[i % PYRAMIDS], torch.from_numpy(rois).to(dev),
                                           torch.from_numpy(lvl).to(dev)))
                        bound = bound_ms(pyramids[0], inputs[0][1], inputs[0][2],
                                         r * 49 * CHANNELS, torch.finfo(dtype).bits // 8)
                        for k in kernels:
                            mod, cuda_fn = mods[k]
                            fn = lambda f, ro, lv, cuda_fn=cuda_fn: cuda_fn(f, ro, lv, (7, 7),
                                                                           SCALES, 2)
                            label = f"{k} {str(dtype)[6:]} {mix} R={r}"
                            print(report(label, measure(fn, inputs, args.reps), bound, card),
                                  flush=True)
                            ref = fn(*inputs[0])
                            for (kk, name), lib in libs.items():
                                if kk != k:
                                    continue
                                mod._kernel = lambda lib=lib, mod=mod: mod.bind(lib)
                                try:
                                    m = measure(fn, inputs, args.reps)
                                    same = torch.equal(fn(*inputs[0]), ref)
                                finally:
                                    mod._kernel = saved[k]
                                if name in EXACT and not same:
                                    raise AssertionError(f"{label} [{name}] differs from the "
                                                         f"kernel as built")
                                tag = ", equal to the kernel as built" if same else ""
                                print(report(f"{label} [{name}{tag}]", m, bound, card),
                                      flush=True)
                        del inputs
                del pyramids
                torch.cuda.empty_cache()
    finally:
        for k in kernels:
            mods[k][0]._kernel = saved[k]
    return 0


if __name__ == "__main__":
    sys.exit(main())
