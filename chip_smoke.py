"""Smoke run of oneshotdet_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version at the main path's shapes, drives the flagship one-shot
detector (Siamese FCOS R-50-FPN, configs/oneshot_fcos_r50.yaml, bf16, random
weights from a seed) through its two entry points -- the streaming predictor
and the batch-8 832x1216 eval forward at 512 and 2000 proposals per image --
and checks a small float32 forward on the card against the same model on the
CPU. Any failure raises and exits non-zero. The last two lines of stdout are
the per-kernel JSON line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
KERNEL_SOURCE = "oneshotdet_tpu_torch/csrc/roi_align.cu"
KERNEL_REPLACES = "oneshotdet_tpu/ops/pallas_roi_align.py:249"
QUERY_HW = (832, 1216)
SUPP_HW = (416, 416)
BATCH = 8


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pyramid_shapes(h, w):
    """P3..P7 (H, W) of an (h, w) input through the R-50-FPN strides."""
    shapes = []
    for _ in range(3):                      # stem conv, max pool, ... to C3
        h, w = (h + 1) // 2, (w + 1) // 2
    for _ in range(5):
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return shapes


def time_ms(fn, reps=20, warmup=2):
    """Median over ``reps`` of CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of the bf16 spacing at max(|a|, |b|)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126))) - 7)
    return float(((a - b).abs() / ulp).max())


def random_rois(n, batch, image_hw, gen, dev):
    """Random boxes: ordinary, over 5:1, partly outside the image and
    degenerate (x2 < x1), with about 10% of the slots invalid."""
    h, w = image_hw
    xy = torch.rand(n, 2, generator=gen) * torch.tensor([w, h]) * 1.1 - 40
    wh = torch.exp(torch.rand(n, 2, generator=gen) * 6.0)       # 1 .. 400 px
    wh[0::5, 0] *= 8.0                                           # wide, > 5:1
    wh[1::5, 1] *= 8.0                                           # tall
    wh[2::11] *= -0.2                                            # degenerate
    b = torch.randint(0, batch, (n, 1), generator=gen).float()
    rois = torch.cat([b, xy, xy + wh], dim=1)
    valid = torch.rand(n, generator=gen) > 0.1
    return rois.to(dev), valid.to(dev)


def kernel_checks(ra, dev):
    """Phase 3: the ROIAlign kernel against its plain version at the main
    path's three uses. Returns the headline entry for the kernels line."""
    gen = torch.Generator().manual_seed(3)
    scales = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
    q_shapes = pyramid_shapes(*QUERY_HW)
    s_shapes = pyramid_shapes(*SUPP_HW)
    log(f"query pyramid {q_shapes}, support pyramid {s_shapes}")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        q_feats = [torch.randn(BATCH, h, w, 256, generator=gen).to(dev, dtype) for h, w in q_shapes]
        s_feats = [torch.randn(BATCH, h, w, 256, generator=gen).to(dev, dtype) for h, w in s_shapes]
        supp_rois = torch.tensor([[i, 0.0, 0.0, 416.0 - 13 * i, 300.0 + 10 * i]
                                  for i in range(BATCH)], device=dev)
        zero_lv = torch.zeros(BATCH, dtype=torch.int32, device=dev)
        cases = []
        for r in (16000, 4096):
            rois, valid = random_rois(r, BATCH, QUERY_HW, gen, dev)
            levels = ra.fpn_level_map(rois[:, 1:], 3, 7)
            cases.append((f"proposals 7x7 R={r}", q_feats, rois, levels, (7, 7), scales, valid))
        cases.append(("support 7x7 R=8", s_feats, supp_rois,
                      ra.fpn_level_map(supp_rois[:, 1:], 3, 7), (7, 7), scales, None))
        for lvl in range(5):
            cases.append((f"support 1x1 P{lvl + 3} R=8", [s_feats[lvl]], supp_rois,
                          zero_lv, (1, 1), (scales[lvl],), None))
        for name, feats, rois, levels, out_hw, sc, valid in cases:
            args = (feats, rois, levels, out_hw, sc, 2, valid)
            k = ra.multilevel_roi_align_cuda(*args)
            torch.cuda.synchronize()
            p = ra.multilevel_roi_align_plain(*args)
            diff = (k.float() - p.float()).abs()
            err = float(diff.max())
            rel = float((diff / p.float().abs().clamp(min=1e-6)).max())
            if dtype == torch.float32:
                ok, tol = err <= 1e-5, "abs <= 1e-5"
                metric = f"max abs err {err:.3e}, max rel err {rel:.3e}"
            else:
                ulps = bf16_ulps(k, p)
                ok, tol = ulps <= 1.0, "<= 1 bf16 ulp"
                metric = f"max abs err {err:.3e}, max rel err {rel:.3e}, {ulps:.2f} bf16 ulp"
            if not ok:
                raise AssertionError(f"roi_align {name} {dtype}: {metric} (tolerance {tol})")
            elt = torch.finfo(dtype).bits // 8
            in_bytes = sum(f.numel() for f in feats) * elt + rois.numel() * 4 + levels.numel() * 4
            in_bytes += 0 if valid is None else valid.numel()
            out_bytes = k.numel() * elt
            ops = k.numel() * 4 * 8                 # 2x2 samples x 4 corners x (mul + add)
            t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            ms = time_ms(lambda: ra.multilevel_roi_align_cuda(*args))
            plain_ms = time_ms(lambda: ra.multilevel_roi_align_plain(*args), reps=20, warmup=1)
            log(f"roi_align {name} {str(dtype)[6:]}: {metric} (tolerance {tol}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
                f"{(in_bytes + out_bytes) / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            del k, p
        del q_feats, s_feats
        torch.cuda.empty_cache()
    return results


def distinct_weights_(model, gen):
    """Seeded weights with no near-equal scores (so top-k tie order does not
    decide the CPU/GPU comparison): N(0, 1/fan_in) kernels, 1 + 0.1 N
    scales, 0.1 N biases and means, 1 + 0.2 |N| variances."""
    with torch.no_grad():
        for name, v in model.state_dict().items():
            n = torch.randn(v.shape, generator=gen)
            if v.dim() > 1:
                val = n / math.sqrt(v[0].numel())
            elif name.endswith("running_var"):
                val = 1.0 + 0.2 * n.abs()
            elif name.endswith(("weight", "scale")):
                val = 1.0 + 0.1 * n
            else:
                val = 0.1 * n
            v.copy_(val)


def match_detections(a, b, score_rtol=5e-4, box_rtol=1e-3):
    """Valid detections of a and b (one image each, numpy) agree as sets:
    equal counts, and each box of a has a box of b with IoU > 0.99 whose
    score and coordinates match within tolerance."""
    (ab, as_), (bb, bs) = a, b
    if len(ab) != len(bb):
        raise AssertionError(f"{len(ab)} vs {len(bb)} detections")
    for box, score in zip(ab, as_):
        lt = np.maximum(box[:2], bb[:, :2])
        rb = np.minimum(box[2:], bb[:, 2:])
        inter = np.prod(np.clip(rb - lt + 1, 0, None), axis=1)
        area = lambda x: (x[..., 2] - x[..., 0] + 1) * (x[..., 3] - x[..., 1] + 1)
        iou = inter / (area(box) + area(bb) - inter)
        j = int(np.argmax(iou))
        if not (iou[j] > 0.99
                and abs(bs[j] - score) <= score_rtol * abs(score) + 1e-5
                and np.all(np.abs(bb[j] - box) <= box_rtol * np.abs(box) + 1e-3)):
            raise AssertionError(f"detection {box} {score} unmatched "
                                 f"(best {bb[j]} {bs[j]}, IoU {iou[j]:.4f})")


def small_forward_check(cfg_path, dev):
    """A float32 forward (batch 2, 128x160 queries, 64x64 supports) on the
    card (the kernel) and on the CPU (the plain version that the tier-1 tests
    hold against the JAX package) with the same weights and inputs."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.structures import ImageBatch

    cfg = default_cfg.clone()
    cfg.merge_from_file(cfg_path)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_PRE_TOPK", 1024,
                         "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 128,
                         "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 64])
    gen = torch.Generator().manual_seed(11)
    q = torch.randn(2, 128, 160, 3, generator=gen) * 50
    s = torch.randn(2, 64, 64, 3, generator=gen) * 50
    qs = torch.tensor([[128.0, 160.0], [100.0, 150.0]])
    ss = torch.tensor([[64.0, 64.0], [60.0, 40.0]])
    cpu = build_detection_model(cfg, device="cpu")
    distinct_weights_(cpu, torch.Generator().manual_seed(12))
    gpu = build_detection_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    ref = cpu(ImageBatch(q, qs), ImageBatch(s, ss))
    out = gpu(ImageBatch(q.to(dev), qs.to(dev)), ImageBatch(s.to(dev), ss.to(dev)))
    n = 0
    for i in range(2):
        def valid_dets(d):
            v = d.valid[i].cpu().numpy()
            return (d.xyxy[i].cpu().numpy()[v], d.get_field("scores")[i].cpu().numpy()[v])
        match_detections(valid_dets(out), valid_dets(ref))
        n += int(out.valid[i].sum())
    log(f"small float32 forward: {n} detections on the card match the CPU plain path "
        f"(score rtol 5e-4, box rtol 1e-3, TF32 off)")


STAGES = ("query_backbone", "support_backbone", "support_pool", "fcos_head",
          "fcos_postprocess", "roi_pool", "roi_head", "roi_postprocess")


def profile_forward(model, images, supps, label):
    """One eval forward under torch.profiler: device time of each stage range
    of the detector, the device's busy share of the forward's wall time, and
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(images, supps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in STAGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    if busy_ms == 0:
        log(f"profile {label}: torch.profiler recorded no device time")
        return
    log(f"profile {label}: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    # each stage's range on the device timeline, first kernel to last,
    # gaps included (the host-side range misses the ctypes kernel launches)
    spans = {e.name: e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name in STAGES}
    for name in STAGES:
        if name in spans:
            log(f"  stage {name:<17} device span {spans[name]:8.2f} ms "
                f"({100 * spans[name] / wall_ms:5.1f}% of wall)")
    per_kernel = {}
    for e in device:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  kernel {ms:8.2f} ms  {name[:110]}")


def check_detections(dets, batch, capacity, sizes_wh):
    if dets.xyxy.shape != (batch, capacity, 4) or dets.valid.shape != (batch, capacity):
        raise AssertionError(f"detections shape {tuple(dets.xyxy.shape)}")
    v = dets.valid
    boxes, scores = dets.xyxy.float(), dets.get_field("scores").float()
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite detections")
    w, h = sizes_wh[:, 0:1], sizes_wh[:, 1:2]
    inside = (boxes[..., 0] >= 0) & (boxes[..., 1] >= 0) & (boxes[..., 2] <= w - 1) & (boxes[..., 3] <= h - 1)
    if not bool((inside | ~v).all()):
        raise AssertionError("a valid detection lies outside its image")
    if int(v.sum()) == 0:
        raise AssertionError("no detections")
    if not bool(((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError("scores outside [0, 1]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from oneshotdet_tpu_torch import csrc
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import roi_align as ra
    from oneshotdet_tpu_torch.predictor import OneShotPredictor
    from oneshotdet_tpu_torch.structures import ImageBatch

    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    flagship = os.path.join(ROOT, "configs", "oneshot_fcos_r50.yaml")
    preset = os.path.join(ROOT, "configs", "oneshot_fcos_r50_fast_eval.yaml")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    csrc.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in csrc.build_logs.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")

    # -- phase 3: kernel against plain ----------------------------------------
    checks = kernel_checks(ra, dev)
    small_forward_check(flagship, dev)

    # -- phase 4: predictor ---------------------------------------------------
    cfg = default_cfg.clone()
    cfg.merge_from_file(flagship)
    gen = torch.Generator().manual_seed(0)
    launches = {}
    ra.roi_align_launches = 0
    pred = OneShotPredictor(cfg, confidence_threshold=0.0, device=dev,
                            generator=torch.Generator().manual_seed(1))
    supp = torch.randint(0, 256, (300, 400, 3), generator=gen, dtype=torch.uint8).numpy()
    pred.set_support(supp)
    frames = [(480, 640), (800, 1200), (720, 1280), (600, 800)]
    for fh, fw in frames:
        frame = torch.randint(0, 256, (fh, fw, 3), generator=gen, dtype=torch.uint8).numpy()
        t0 = time.perf_counter()
        boxes, scores = pred.run_on_image(frame)
        ms = (time.perf_counter() - t0) * 1e3
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all() and len(scores) > 0):
            raise AssertionError(f"predictor frame {fh}x{fw}: empty or non-finite output")
        if not (boxes[:, [0, 2]].min() >= 0 and boxes[:, [0, 2]].max() <= fw
                and boxes[:, [1, 3]].min() >= 0 and boxes[:, [1, 3]].max() <= fh):
            raise AssertionError(f"predictor frame {fh}x{fw}: box outside the frame")
        log(f"predictor frame {fh}x{fw}: {len(scores)} detections, {ms:.1f} ms "
            f"(host clock, first frame includes warm-up) [{card}]")
    launches["predictor"] = ra.roi_align_launches
    expected = 6 + len(frames)
    if launches["predictor"] != expected:
        raise AssertionError(f"predictor: {launches['predictor']} roi_align launches, expected {expected}")
    del pred
    torch.cuda.empty_cache()

    # -- phase 5: batched eval forward ----------------------------------------
    g = torch.Generator(device=dev).manual_seed(5)
    q_sizes = torch.tensor([[832, 1216], [800, 1200], [832, 1100], [704, 1216],
                            [832, 1216], [768, 1024], [832, 1184], [640, 960]],
                           dtype=torch.float32, device=dev)
    s_sizes = torch.tensor([[416, 416], [300, 400], [400, 300], [416, 320],
                            [256, 416], [416, 416], [350, 350], [200, 400]],
                           dtype=torch.float32, device=dev)
    images = ImageBatch(torch.randn(BATCH, *QUERY_HW, 3, generator=g, device=dev) * 50, q_sizes)
    supps = ImageBatch(torch.randn(BATCH, *SUPP_HW, 3, generator=g, device=dev) * 50, s_sizes)
    for label, path in (("preset EVAL_ROI_TOPK=512", preset), ("full 2000/img", flagship)):
        c = default_cfg.clone()
        c.merge_from_file(path)
        model = build_detection_model(c, device=dev, generator=torch.Generator().manual_seed(1))
        dets = model(images, supps)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ra.roi_align_launches = 0
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = model(images, supps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        n = ra.roi_align_launches
        if n != 7 * iters:
            raise AssertionError(f"{label}: {n} roi_align launches in {iters} forwards, expected {7 * iters}")
        launches[label] = n
        capacity = min(c.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                       c.TPU.EVAL_ROI_TOPK or c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST)
        check_detections(dets, BATCH, capacity, images.sizes_wh())
        log(f"eval forward {label}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, "
            f"{dt * 1e3:.1f} ms/batch, {BATCH / dt:.1f} img/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{int(dets.valid.sum())} detections [{card}]")
        profile_forward(model, images, supps, label)
        del model, dets
        torch.cuda.empty_cache()

    # -- kernels line and result ------------------------------------------------
    head = checks[("proposals 7x7 R=16000", torch.bfloat16)]
    kernels = [{
        "name": "roi_align",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches["full 2000/img"],
        "launches_by_path": launches,
        "shape": "batch-8 832x1216 pyramid, C=256, R=16000 rois, 7x7, bf16",
        "max_abs_err": head["max_abs_err"],
        "tolerance": "1 bf16 ulp (f32 cases: 1e-5 abs)",
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
