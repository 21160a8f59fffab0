"""Where the ROIAlign backward kernel (K1b) spends its time: an earlier build
of it against this one, and copies of this one with one change each.

    python3 oneshotdet_tpu_torch/tools/ablate_roi_align_bwd.py [--parent FILE]
        [--reps 20] [--rounds 2] [--variants] [--cases random,clustered,...]

Needs one CUDA card and nvcc. At the train step's shapes (C = 256, sampling
ratio 2): the proposals' R = 1024 over the batch-8 832x1216 pyramid, random
ROIs (chip_smoke.random_rois) and ROIs crowded onto a few GT-like boxes
(chip_smoke.clustered_rois), the support 7x7 (R = 8) and the five 1x1 pools
on the 416x416 support pyramid, in bf16 and f32, it prints per case:

- the bound (grad_out and the ROIs read once, the gradient written once, at
  3.35 TB/s; chip_smoke.k1b_bound);
- ms per call back to back (CUDA events over ``--reps`` calls) of the
  wrapper as a user calls it, in ``--rounds`` rounds of parent, this
  kernel, this kernel, parent, each with its share of the bound; and the
  host clock per call over the same calls without a sync (the wrapper's
  host time, where it paces the call);
- this kernel's two launches apart, the samples and tile bits and the
  body, by their device times (torch.profiler, ``ablate_v4.kernel_ms``),
  with the runtime launch calls per call;
- the (tile, ROI) pairs of ``roi_align_bwd_plan``.

``--parent FILE`` is an earlier ``csrc/roi_align_bwd.cu``, with the
``roi_align_common.cuh`` it includes beside it, for example the block per
ROI that adds with float32 atomics into a zeroed float32 workspace (unpack
``git archive <commit> oneshotdet_tpu_torch`` into ``build/parent/``, which
git ignores, and pass
``build/parent/oneshotdet_tpu_torch/csrc/roi_align_bwd.cu``). Its call is its
wrapper's: the workspace zeroed, the kernel, one cast per level.

``--variants`` also builds copies of csrc/roi_align_bwd.cu with one change
each (``VARIANTS``) and times each after the kernel as built: ``min blocks
3`` budgets registers for 3 resident body blocks per SM, ``f32 32
channels`` gives an fp32 block 32 channels and a thread 8 rows (64 and 16
as built), ``coarse first`` starts the body blocks from the last level's
tiles (the first level's first as built), ``no sums`` cuts the body's sums
out (what is left is the lists, copies, weights, barriers and stores). The copies with the
sums are checked against the kernel as built, bit for bit; ``no sums`` is
wrong and only its time counts.

``--timeline`` builds a copy whose body blocks stamp the global timer at
entry and exit, and prints per case the body's span, the blocks' time
against their ROI counts and the last blocks to end.

Every copy is checked against the float32 plain gradient
(chip_smoke.grad_compare) before it is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from oneshotdet_tpu_torch import csrc  # noqa: E402
from oneshotdet_tpu_torch.ops import roi_align as ra  # noqa: E402
from oneshotdet_tpu_torch.tools import card_line  # noqa: E402

# (name, [(text in roi_align_bwd.cu, replacement)], its sums are the kernel's)
VARIANTS = [
    ("min blocks 3", [("#define BODY_MIN_BLOCKS 2", "#define BODY_MIN_BLOCKS 3")], True),
    ("f32 32 channels", [("#define SV_F32 16 ", "#define SV_F32 8 "),
                         ("#define TR_F32 16\n", "#define TR_F32 8\n")], True),
    ("coarse first", [("  const int tile = blockIdx.x / slices;",
                       "  const int tile = num_tiles - 1 - blockIdx.x / slices;")], True),
    ("no sums", [("if (pm != 0 && cv < vpp) {", "if (pm != 0 && cv < vpp && grid < 0) {")],
     False),
]
# the body's blocks stamp %globaltimer at entry and exit, with their ROI
# count, into a device array that oneshot_bwd_timeline copies out
TIMELINE = ("timeline", [
    ("#define LIST_MAX 1024 ", "__device__ unsigned long long g_stamp[1 << 16][2];\n"
     "__device__ int g_rois[1 << 16];\n#define LIST_MAX 1024 "),
    ("  const Tile o = tile_of(out, batch, tile);\n",
     "  const Tile o = tile_of(out, batch, tile);\n  unsigned long long t_in;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_in));\n  int n_all = 0;\n"),
    ("    const int n = s_count;\n", "    const int n = s_count;\n    n_all += n;\n"),
    ("  const int x = x0 + col;\n",
     "  if (tid == 0 && blockIdx.x < (1 << 16)) {\n    unsigned long long t_out;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_out));\n"
     "    g_stamp[blockIdx.x][0] = t_in;\n    g_stamp[blockIdx.x][1] = t_out;\n"
     "    g_rois[blockIdx.x] = n_all;\n  }\n  const int x = x0 + col;\n"),
    ("const char* oneshot_roi_align_bwd_error_string(int code) {",
     "void oneshot_bwd_timeline(unsigned long long* stamps, int* rois, int blocks) {\n"
     "  cudaMemcpyFromSymbol(stamps, g_stamp, sizeof(unsigned long long) * 2 * blocks);\n"
     "  cudaMemcpyFromSymbol(rois, g_rois, sizeof(int) * blocks);\n}\n\n"
     "const char* oneshot_roi_align_bwd_error_string(int code) {"),
], True)
SUMS = {name: right for name, _, right in VARIANTS}
CASES = ("random", "clustered", "support7", "support1")


def _patched(src, name, patches):
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its text is not in roi_align_bwd.cu once")
        src = src.replace(old, new)
    return src


def build(workdir, parent, variants, timeline):
    """{name: ctypes library}: 'as built' and each variant from this
    checkout's source, 'parent' from ``parent``; one nvcc each, all at
    once."""
    src_dir = os.path.join(ROOT, "oneshotdet_tpu_torch", "csrc")
    src = open(os.path.join(src_dir, "roi_align_bwd.cu")).read()
    jobs = [("as built", src, src_dir)]
    if variants:
        jobs += [(name, _patched(src, name, patches), src_dir) for name, patches, _ in VARIANTS]
    if timeline:
        jobs.append((TIMELINE[0], _patched(src, TIMELINE[0], TIMELINE[1]), src_dir))
    if parent:
        jobs.append(("parent", open(parent).read(), os.path.dirname(os.path.abspath(parent))))
    procs = []
    for i, (name, text, inc) in enumerate(jobs):
        path = os.path.join(workdir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libv{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("roi_align_bwd"), "-I", inc, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: " + " | ".join(regs), flush=True)
        handle = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.oneshot_roi_align_backward.argtypes = (
            [p, i, i, i, p, p, p, i, i, i, i, p, p] + ([] if name == "parent" else [p]))
        handle.oneshot_roi_align_backward.restype = ctypes.c_int
        handle.oneshot_roi_align_bwd_error_string.argtypes = [ctypes.c_int]
        handle.oneshot_roi_align_bwd_error_string.restype = ctypes.c_char_p
        if name == TIMELINE[0]:
            handle.oneshot_bwd_timeline.argtypes = [p, p, i]
        libs[name] = handle
    return libs


def kernel_call(lib, bargs):
    """A call of this checkout's wrapper on ``bargs`` with library ``lib``."""
    def call():
        ra._bwd_kernel = lambda: lib
        return ra.multilevel_roi_align_backward_cuda(*bargs)
    return call


def parent_call(lib, grad_out, shapes, dtype, rois, levels, output_size, scales, g, valid):
    """The earlier wrapper's call: a zeroed level-major float32 workspace,
    one launch that adds into it, one cast per level."""
    dev = rois.device
    b, c = shapes[0][0], shapes[0][3]
    offsets = ra._level_offsets(shapes)
    ws = torch.zeros((offsets[-1], c), dtype=torch.float32, device=dev)
    pyr = ra._Pyramid()
    for i, (shape, s) in enumerate(zip(shapes, scales)):
        pyr.data[i] = ws[offsets[i]].data_ptr()
        pyr.height[i] = shape[1]
        pyr.width[i] = shape[2]
        pyr.scale[i] = float(s)
    pyr.num_levels = len(shapes)
    rc = lib.oneshot_roi_align_backward(
        ctypes.addressof(pyr), b, c, ra._DTYPE_CODE[dtype], rois.data_ptr(), levels.data_ptr(),
        0 if valid is None else valid.data_ptr(), rois.shape[0], output_size[0],
        output_size[1], g, grad_out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent kernel: {lib.oneshot_roi_align_bwd_error_string(rc)}")
    return ra._split_workspace(ws, shapes, dtype)


def timeline(lib, bargs, blocks):
    """One call of the timeline copy on ``bargs``: the body's span, its
    blocks' time against their ROI counts (least squares: fixed us + us per
    ROI), and the last blocks to end."""
    import numpy as np

    kernel_call(lib, bargs)()
    torch.cuda.synchronize()
    stamps = np.zeros((blocks, 2), dtype=np.uint64)
    rois = np.zeros(blocks, dtype=np.int32)
    lib.oneshot_bwd_timeline(stamps.ctypes.data, rois.ctypes.data, blocks)
    t0 = stamps[:, 0].min()
    start = (stamps[:, 0] - t0) / 1e3
    end = (stamps[:, 1] - t0) / 1e3
    dur = end - start
    busy = rois > 0
    a, b = np.polyfit(rois[busy], dur[busy], 1)[::-1] if busy.sum() > 1 else (0.0, 0.0)
    last = np.argsort(end)[-3:][::-1]
    return (f"span {end.max():.1f} us, 99% of blocks ended by {np.percentile(end, 99):.1f} us; "
            f"{(~busy).sum()} empty blocks {np.median(dur[~busy]) if (~busy).any() else 0:.2f} "
            f"us each (median); {busy.sum()} blocks with ROIs: {a:.2f} us + {b:.3f} us per ROI "
            f"(most ROIs {rois.max()}); last to end: "
            + ", ".join(f"block {k} ({rois[k]} ROIs) {start[k]:.1f}-{end[k]:.1f} us" for k in last))


def back_to_back(call, reps):
    """(ms per call by CUDA events, host ms per call by the host clock up to
    the last call's enqueue), over ``reps`` calls after one."""
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def cases(dev, gen, which):
    """(name, shapes, rois, levels, output size, scales, valid)."""
    q = [(chip_smoke.BATCH, h, w, 256) for h, w in chip_smoke.pyramid_shapes(*chip_smoke.QUERY_HW)]
    s = [(chip_smoke.BATCH, h, w, 256) for h, w in chip_smoke.pyramid_shapes(*chip_smoke.SUPP_HW)]
    sc = chip_smoke.SCALES_Q
    out = []
    rois, valid = chip_smoke.random_rois(1024, chip_smoke.BATCH, chip_smoke.QUERY_HW, gen, dev)
    crowd = chip_smoke.clustered_rois(gen, dev)
    supp = torch.tensor([[i, 0.0, 0.0, 416.0 - 13 * i, 300.0 + 10 * i]
                         for i in range(chip_smoke.BATCH)], device=dev)
    if "random" in which:
        out.append(("random R=1024", q, rois, ra.fpn_level_map(rois[:, 1:], 3, 7), (7, 7), sc,
                    valid))
    if "clustered" in which:
        out.append(("GT-clustered R=1024", q, crowd, ra.fpn_level_map(crowd[:, 1:], 3, 7),
                    (7, 7), sc, None))
    if "support7" in which:
        out.append(("support 7x7 R=8", s, supp, ra.fpn_level_map(supp[:, 1:], 3, 7), (7, 7), sc,
                    None))
    if "support1" in which:
        zero = torch.zeros(chip_smoke.BATCH, dtype=torch.int32, device=dev)
        for lvl in range(5):
            out.append((f"support 1x1 P{lvl + 3} R=8", [s[lvl]], supp, zero, (1, 1), (sc[lvl],),
                        None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_roi_align_bwd: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from oneshotdet_tpu_torch.tools.ablate_v4 import kernel_ms

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    loader = ra._bwd_kernel
    summary = {}
    try:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build(workdir, args.parent, args.variants, args.timeline)
            stamped = libs.pop(TIMELINE[0], None)
            for dtype in [getattr(torch, d) for d in args.dtypes.split(",")]:
                dt = str(dtype)[6:]
                for case, shapes, r, lv, out_hw, sc, v in cases(dev, gen, args.cases.split(",")):
                    g = torch.randn((r.shape[0], *out_hw, 256), generator=gen).to(dev, dtype)
                    bargs = (g, shapes, dtype, r, lv, out_hw, sc, 2, v)
                    want = ra.multilevel_roi_align_backward_plain(
                        g.float(), shapes, torch.float32, r, lv, out_hw, sc, 2, v)
                    calls = {name: (lambda lib=lib: parent_call(lib, *bargs)) if name == "parent"
                             else kernel_call(lib, bargs) for name, lib in libs.items()}
                    built = calls["as built"]()
                    for name, call in calls.items():
                        got = call()
                        if SUMS.get(name, True):
                            chip_smoke.grad_compare(f"{name} {case}", dtype, got, want)
                        if SUMS.get(name) and not all(torch.equal(a, b)
                                                      for a, b in zip(got, built)):
                            raise AssertionError(f"{name} {case} {dt}: differs from as built")
                    del want, built
                    bound, by, nbytes, _ = chip_smoke.k1b_bound(g, r, lv, v, shapes)
                    plan = ra.roi_align_bwd_plan(shapes, r, lv, out_hw, sc, 2, v)
                    pairs = sum(len(x) for x in plan.lists)
                    print(f"{dt} {case}: bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB); "
                          f"{pairs} (tile, ROI) pairs over {len(plan.tiles)} tiles [{card}]",
                          flush=True)
                    order = (["parent"] if "parent" in calls else []) + ["as built", "as built"]
                    order += ["parent"] if "parent" in calls else []
                    order += [n for n in calls if n not in ("parent", "as built")]
                    for rnd in range(args.rounds):
                        for name in order:
                            ms, host = back_to_back(calls[name], args.reps)
                            summary.setdefault((dt, case, name), []).append(ms)
                            print(f"{dt} {case} round {rnd} {name:<13} {ms:.4f} ms per call "
                                  f"({100 * bound / ms:.1f}% of the bound), host "
                                  f"{host:.4f} ms per call", flush=True)
                    ra._bwd_kernel = lambda: libs["as built"]  # noqa: B023
                    rows, launches = kernel_ms(
                        lambda: ra.multilevel_roi_align_backward_cuda(*bargs), [()] * 3)
                    dev_ms = {k.split("(")[0].replace("void ", ""): m for k, _, _, m in rows}
                    bits_dev = sum(m for k, m in dev_ms.items() if "tiles" in k)
                    body_dev = sum(m for k, m in dev_ms.items() if "body" in k)
                    summary[(dt, case, "parts")] = [bits_dev, body_dev, launches, bound]
                    print(f"{dt} {case} as built by launch, device ms: samples and tile bits "
                          f"{bits_dev:.4f}, body {body_dev:.4f}; {launches:g} runtime launch "
                          f"calls per call [{card}]", flush=True)
                    if stamped is not None:
                        vpp = shapes[0][3] * g.element_size() // 16
                        sv = 8 if dtype == torch.bfloat16 else 16   # SV_BF16, SV_F32
                        blocks = len(plan.tiles) * -(-vpp // sv)
                        print(f"{dt} {case} timeline: {timeline(stamped, bargs, blocks)} "
                              f"[{card}]", flush=True)
                    del g
                    torch.cuda.empty_cache()
    finally:
        ra._bwd_kernel = loader
    print(f"summary, median ms per call back to back [{card}]:")
    for (dt, case, name), vals in summary.items():
        if name == "parts":
            d1, d2, n, bound = vals
            print(f"  {dt} {case} as built by launch, device: bits {d1:.4f}, body {d2:.4f}, "
                  f"{n:g} launches, bound {bound:.4f}")
        else:
            print(f"  {dt} {case} {name}: {statistics.median(vals):.4f} "
                  f"({' '.join(f'{x:.4f}' for x in vals)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
