"""Where the resize + normalize + pad kernel (H1) spends its time: this
checkout's kernel beside another checkout's, in one process on one card.

    python3 -m oneshotdet_tpu_torch.tools.ablate_resize [--root DIR] [--reps 20] [--variants]

Needs one CUDA card and nvcc; exits non-zero without CUDA. On the inputs of
``chip_smoke.py`` phase 8 -- the first eval batch of its synthetic dataset
(8 VOC-sized queries into their 832x1216 or 1216x832 bucket, their 8
supports into 416x416) -- and on the edge cases ``EDGES`` (into 832x1216),
it prints for each kernel and case:

- the device ms per call and per launch: torch.profiler's CUDA kernel time
  of the resize kernel over ``--reps`` calls, with its launches per call;
- the wrapper's host ms per call: the median of the host clock around
  each of 5 x ``--reps`` calls that only enqueue their launches;
- CUDA-event ms of one call on an idle card (the median; the event interval
  holds the wrapper's host work) and per call back to back;
- the bound (the uint8 sources read once, the float32 slots written once, at
  3.35 TB/s) and the share of it of the device time and of one call.

The case ``batch`` is what the collator launches per batch: the queries and
the supports, as one call of ``resize_normalize_pad_slots`` where the
wrapper has it, else as two calls of ``resize_normalize_pad_cuda``. Each
wrapper packs its own sources (``pack_images``); the packing is not timed.

``--variants`` also builds copies of this checkout's
csrc/resize_normalize_pad.cu with one part of the work cut out
(``VARIANTS``: the staging copies, the horizontal pass, the vertical sums,
the rounding and table look-up, the stores, all of these but the copies,
everything after the set-up) or with another register budget, chain count
or run length (``SETTINGS``: the wrapper's), and times each on the queries,
the supports and the batch after the kernel as built. The cut copies'
outputs are wrong and only their times count; the others (``EXACT``) must
equal the kernel as built.

``--root DIR`` also times the kernel of another checkout (an unpacked
archive of an earlier commit, ``git archive <commit> oneshotdet_tpu_torch``
into ``build/parent/``, which git ignores): its ``ops/resize.py`` and its
``csrc`` loader are loaded under another package name, so its
``csrc/resize_normalize_pad.cu`` is built into its own ``build/`` and runs
through its own wrapper, beside this checkout's. The two take turns: root,
this, this, root.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# chip_smoke.py phase 8's edge cases: (source (h0, w0), target (oh, ow)),
# sources drawn in order from RandomState(8), into the 832x1216 slot
EDGES = (((900, 1300), (400, 578)), ((2000, 3000), (200, 300)),   # downscale
         ((40, 60), (800, 1200)), ((37, 53), (811, 1163)),       # upscale
         ((300, 1), (400, 2)), ((1, 300), (2, 400)), ((1, 1), (5, 7)))
# --variants: (name, [(text in resize_normalize_pad.cu, replacement)]); each
# text must be in the file once
_STORE = "        float* o = dst + (yg + j - y0) * pitch_g + k0;\n"
VARIANTS = [
    ("no copies", [("      if (c0 < g0 + span)\n", "      if (c0 < g0 + span && k < 0)\n")]),
    ("no horizontal", [("    if (!active) return;\n    for (int r = r0;",
                        "    if (active || !active) return;\n    for (int r = r0;")]),
    ("no vertical", [("        for (int t = 0; t < tmax; ++t) {\n",
                      "        for (int t = 0; t < tmax && c0 < 0; ++t) {\n")]),
    ("no rounding", [("lut_of[i][round_clamp_u8(acc[u][i])]", "static_cast<float>(acc[u][i])")]),
    # the values stay live: a compare against -1 that never holds
    ("no stores", [(_STORE, _STORE + "        if (static_cast<int>(blockIdx.x) >= 0) {\n"
                    "          if (v[0] + v[1] + v[2] + v[3] == -1.0f) lut[0][0] = 0.0f;\n"
                    "          continue;\n        }\n")]),
    ("setup only", [("  __syncthreads();\n\n  const int sfirst",
                     "  __syncthreads();\n  if (static_cast<int>(blockIdx.x) >= 0) return;\n\n"
                     "  const int sfirst")]),
    ("min blocks 3", [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 3)")]),
    ("min blocks 5", [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 5)")]),
    ("min blocks 6", [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 6)")]),
    ("2 rows a chain set", [("#define HROWS 4 ", "#define HROWS 2 ")]),
    ("8 rows a chain set", [("#define HROWS 4 ", "#define HROWS 8 ")]),
    ("runs of 64", []),
]
# the wrapper's settings a variant changes: {name: {attribute of ops.resize: value}}
SETTINGS = {"runs of 64": {"SHORT_RUN": 64}}
# every cut at once but the copies: the walk's skeleton (loops, barriers)
VARIANTS.append(("skeleton", [p for name, ps in VARIANTS
                              if name in ("no horizontal", "no vertical", "no rounding",
                                          "no stores") for p in ps]))
# the variants that compute what the kernel computes: checked against it
EXACT = ("min blocks 3", "min blocks 5", "min blocks 6", "2 rows a chain set",
         "8 rows a chain set", "runs of 64")
KERNEL = re.compile(r"resize_normalize_pad")
LAUNCH = re.compile(r"cu(da)?LaunchKernel")


def edge_sources():
    """The edge cases' uint8 sources and targets."""
    rng = np.random.RandomState(8)
    return ([rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for (h, w), _ in EDGES],
            [hw for _, hw in EDGES])


def first_batch(workdir):
    """(items, query bucket, support bucket) of chip_smoke phase 8's first
    eval batch: its synthetic dataset written under ``workdir``, the
    flagship config at batch chip_smoke.BATCH, the loader's first indices."""
    import chip_smoke
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.data import build as data_build
    from oneshotdet_tpu_torch.data import make_data_loader
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

    img_dir, ann_file = write_synthetic_coco(workdir, num_images=chip_smoke.DATA_IMAGES,
                                             sizes=chip_smoke.DATA_SIZES,
                                             box_side=chip_smoke.DATA_BOX_SIDE, seed=0)
    env = {"ONESHOT_CUSTOM_IMG_DIR": img_dir, "ONESHOT_CUSTOM_ANN_FILE": ann_file}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = default_cfg.clone()
        cfg.merge_from_file(os.path.join(ROOT, "configs", "oneshot_fcos_r50.yaml"))
        cfg.merge_from_list(["DATASETS.TEST", "('custom',)", "TEST.IMS_PER_BATCH",
                             str(chip_smoke.BATCH)])
        loader, _ = make_data_loader(cfg, is_train=False, device="cpu")
        first_idx = next(iter(loader.batch_iter()))
        fresh = data_build.build_dataset(cfg, "custom", False)
        items = [fresh.load(fresh.plan(i)) for i in first_idx]
        bucket = loader.collator.query_bucket_for([it["img"]["out_hw"] for it in items])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return items, tuple(bucket), tuple(cfg.TPU.SUPP_BUCKET)


def load_root(root):
    """Another checkout's ``ops/resize.py`` with its own ``csrc`` loader,
    under the package name ``_h1_root``."""
    pkg_dir = os.path.join(os.path.abspath(root), "oneshotdet_tpu_torch")
    for name, path in (("_h1_root", pkg_dir), ("_h1_root.ops", os.path.join(pkg_dir, "ops"))):
        mod = types.ModuleType(name)
        mod.__path__ = [path]
        sys.modules[name] = mod

    def from_file(name, path, package=False):
        spec = importlib.util.spec_from_file_location(
            name, path, submodule_search_locations=[os.path.dirname(path)] if package else None)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    sys.modules["_h1_root"].csrc = from_file("_h1_root.csrc",
                                             os.path.join(pkg_dir, "csrc", "__init__.py"), True)
    return from_file("_h1_root.ops.resize", os.path.join(pkg_dir, "ops", "resize.py"))


def calls(mod, cases, dev):
    """{case: (fn, launches the case asks for, bound ms)} for one wrapper
    module: ``fn()`` runs the case as the data path calls it."""
    out = {}
    norm = cases["norm"]
    packed = {}
    for case in ("queries", "supports", "edges"):
        images, targets, slot = cases[case]
        packed[case] = (mod.pack_images(images, targets, dev), slot)
        torch.cuda.synchronize()
    for case, (p, slot) in packed.items():
        out[case] = (lambda p=p, slot=slot: mod.resize_normalize_pad_cuda(p, slot, *norm), 1,
                     cases["bound_ms"][case])
    bound = cases["bound_ms"]["queries"] + cases["bound_ms"]["supports"]
    if hasattr(mod, "resize_normalize_pad_slots"):
        (qi, qt, qs), (si, st, ss) = cases["queries"], cases["supports"]
        both = mod.pack_images(qi + si, qt + st, dev, outputs=[0] * len(qi) + [1] * len(si))
        slots = (mod.slot(qs, *norm), mod.slot(ss, *norm))
        out["batch"] = (lambda: mod.resize_normalize_pad_slots(both, slots), 1, bound)
    else:
        q, s = packed["queries"], packed["supports"]
        out["batch"] = (lambda: (mod.resize_normalize_pad_cuda(q[0], q[1], *norm),
                                 mod.resize_normalize_pad_cuda(s[0], s[1], *norm)), 2, bound)
    torch.cuda.synchronize()
    return out


def device_ms(fn, reps, attempts=3):
    """(device ms per call of the resize kernel, kernel launches per call),
    torch.profiler over ``reps`` calls after an unrecorded one. The tracer
    can drop a kernel's device records (never its launch calls): a window
    with none is profiled again, up to ``attempts`` times; then the device
    time is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for n in (1, reps):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us, launches = 0.0, 0
        for e in prof.key_averages():
            if LAUNCH.match(e.key):
                launches += e.count
            if KERNEL.search(e.key):
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
        if us > 0:
            return us / 1e3 / reps, launches / reps
    return None, launches / reps


def host_ms(fn, reps):
    """Median of the host clock around each of ``reps`` calls that only
    enqueue their launches."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def one_call_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(fn, reps):
    fn()
    torch.cuda.synchronize()
    dev_ms, launches = device_ms(fn, reps)
    return dict(device_ms=dev_ms, launches=launches, host_ms=host_ms(fn, reps),
                one_call_ms=one_call_ms(fn, reps), b2b_ms=back_to_back_ms(fn, reps))


def report(label, r, bound, card):
    dev = r["device_ms"]
    if dev is None:
        device = (f"device not measured (the profiler kept no kernel record; "
                  f"{r['launches']:.0f} launches)")
        share = "not measured"
    else:
        device = (f"device {dev:.4f} ms per call ({r['launches']:.0f} launches, "
                  f"{dev / max(r['launches'], 1):.4f} ms per launch; torch.profiler)")
        share = f"{bound / dev:.1%} of the device time"
    return (f"{label}: {device}; host {r['host_ms']:.4f} ms per call (wrapper, median); one "
            f"call {r['one_call_ms']:.4f} ms (CUDA events, idle card, median); back to back "
            f"{r['b2b_ms']:.4f} ms per call; bound {bound:.4f} ms ({share}, "
            f"{bound / r['one_call_ms']:.1%} of one call) [{card}]")


def inputs(items, query_bucket, supp_bucket):
    """The cases' sources, targets and slots, their bounds and the norm."""
    first = items[0]["img"]
    queries = [it["img"] for it in items]
    supports = [s for it in items for s in it["img_supp"]]
    edge_images, edge_targets = edge_sources()
    cases = {
        "norm": (first["mean"], first["std"], first["to_bgr255"]),
        "queries": ([q["u8"] for q in queries], [q["out_hw"] for q in queries], query_bucket),
        "supports": ([s["u8"] for s in supports], [s["out_hw"] for s in supports], supp_bucket),
        "edges": (edge_images, edge_targets, (832, 1216)),
    }
    cases["bound_ms"] = {
        case: (sum(im.size for im in cases[case][0])
               + len(cases[case][0]) * cases[case][2][0] * cases[case][2][1] * 12)
        / HBM_BYTES_PER_S * 1e3
        for case in ("queries", "supports", "edges")}
    return cases


def build_variants(workdir):
    """{name: ctypes library} of the patched copies, one nvcc each, all
    started together."""
    from oneshotdet_tpu_torch import csrc

    src = open(os.path.join(csrc._SRC_DIR, "resize_normalize_pad.cu")).read()
    procs = []
    for i, (name, patches) in enumerate(VARIANTS):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in the source once")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"libv{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [csrc._nvcc(), *csrc._flags("resize_normalize_pad"), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_resize: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from oneshotdet_tpu_torch.ops import resize
    from oneshotdet_tpu_torch.tools import card_line

    card = card_line()
    dev = torch.device("cuda")
    kernels = [("this", resize)]
    if args.root:
        kernels = [("root", load_root(args.root))] + kernels
    for label, mod in kernels:
        print(f"{label}: {os.path.abspath(mod.__file__)} [{card}]", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        items, query_bucket, supp_bucket = first_batch(workdir)
    cases = inputs(items, query_bucket, supp_bucket)
    print(f"queries: {len(cases['queries'][0])} into {query_bucket}, targets "
          f"{cases['queries'][1]}; supports: {len(cases['supports'][0])} into {supp_bucket}, "
          f"sources {[im.shape[:2] for im in cases['supports'][0]]}, targets "
          f"{cases['supports'][1]}; edges: {EDGES}", flush=True)
    fns = {label: calls(mod, cases, dev) for label, mod in kernels}
    order = [k for k, _ in kernels]
    order = order + order[::-1]          # root, this, this, root
    for case in ("queries", "supports", "batch", "edges"):
        for label in order:
            fn, want, bound = fns[label][case]
            r = measure(fn, args.reps)
            note = "" if r["launches"] == want else f" (the wrapper launches {want})"
            print(report(f"{label} {case}", r, bound, card) + note, flush=True)
    if args.variants:
        with tempfile.TemporaryDirectory() as workdir:
            libs = build_variants(workdir)
            built = resize._kernel()
            try:
                for name, lib in libs.items():
                    settings = SETTINGS.get(name, {})
                    saved = {k: getattr(resize, k) for k in settings}
                    for case in ("queries", "supports", "batch"):
                        fn, _, bound = fns["this"][case]
                        want = fn() if name in EXACT else None
                        resize._lib = resize.bind(lib)
                        if lib.oneshot_resize_init() < 0:
                            raise RuntimeError(f"variant {name!r}: init failed")
                        for k, v in settings.items():
                            setattr(resize, k, v)
                        try:
                            if want is not None and not all(
                                    torch.equal(g, w) for g, w in zip(fn(), want)):
                                raise AssertionError(f"variant {name!r} differs from the "
                                                     f"kernel as built on the {case}")
                            print(report(f"this [{name}] {case}", measure(fn, args.reps),
                                         bound, card), flush=True)
                        finally:
                            resize._lib = built
                            for k, v in saved.items():
                                setattr(resize, k, v)
            finally:
                resize._lib = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
