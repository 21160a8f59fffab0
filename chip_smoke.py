"""Smoke run of oneshotdet_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the port's seven CUDA kernels from this checkout (ROIAlign K1 and its
backward K1b, the fused relation head K3, GroupNorm K2, the cross-ROI
ROIAlign variants K4 and K5, the data path's resize + normalize + pad H1),
holds each against its plain PyTorch version
at the shapes its path gives it (K1 also at its edge cases and on the
FCOS-like p3-skew mix, with its per-ROI plan against the Python mirror; K1b
against the plain gradient (summed in float64) at the train step's shapes,
random and GT-clustered, at K1's edge cases and as the autograd Function against
torch.autograd.grad of the plain forward, with its tile lists against the
Python mirror, bit-identical over calls and streams, two launches per call
and no host sync; K2 on the FCOS tower's P3-P7 and
at narrower channel widths, with its backward, its arrival counters over
back-to-back calls, two streams and two CUDA graphs, and its per-launch
device times; K4 and K5 bit for bit on K1's proposal and edge cases, the
predictor's 1 x 2000, the p3-skew mix on fresh inputs and one case per vector
width, with their block sort against slab_blocks, two launches per call and
K5's window clamp),
drives the paths of the kernels that no model runs (FusedGroupNorm over the
tower levels; the port's tools tune_roialign_v3, ablate_v4, tune_roi_head,
ablate_roi_head for K3's float32 route, accuracy_roi_head and
ablate_group_norm at reduced counts), then the flagship one-shot detector
(Siamese FCOS R-50-FPN, configs/oneshot_fcos_r50.yaml, bf16, random weights
from a seed) through its entry points -- the streaming predictor, the
batch-8 832x1216 eval forward at 512 and 2000 proposals per image, each with
the unfused and the fused head, the same forward at 2000 in float32 with
both heads (K3's 3xTF32 route; their detections must pair up), the eval
engine (per-batch, cached-support and multi-class steps, and
inference() with the COCO evaluator), and the train step at full width
(do_train and train_step over fresh synthetic episodes: finite losses and
gradients, the support backbone trained through K1b, 7 K1 and 7 K1b
launches per step, frozen stages unchanged), and the episodic eval data path
and the eval CLI (phase 8: a synthetic COCO-style dataset of VOC-sized PPM
images; H1 bit for bit against its plain version on a batch and at edge
cases; the card loader against the CPU loader; `test_net` over the flagship
at batch 8 with a .pth of seeded weights, unfused and with the fused head,
and --seq_test), and the train CLI (phase 9: tools.train_net at full width
over that dataset from catalog:// Detectron-style R-50 blobs drawn from a
seed, both backbones equal to the blobs; 3 steps saving model_0000003 and
model_final, then a run resumed from the last_checkpoint tag with the saved
weights bit for bit and the scheduled learning rate, 7 K1 and 7 K1b calls a
step and 1 H1 launch a batch, ms/step with the loader, saves' seconds and
peak memory; remove_solver_states; test_net --seq_test over the saved
files), and the serving artifact (phase 10: export.export_serving of the
batch-1 bundle unfused and with the fused head, each with its AOTInductor
pair, and the batch-8 `full` program; ArtifactPredictor from the compiled
pair and from the ExportedProgram pair against OneShotPredictor on phase 4's
support and frames -- bit for bit for the ExportedProgram route, paired within
one bf16 ulp for the compiled one -- with K1, and K3 with the
fused head, counted from inside the loaded programs; export, compile and
load seconds, file sizes, ms per frame, peak memory), and the training
variants (phase 11: three configs that between them turn on artificial
proposals, soft labels, the mse, cxe and focal class losses, 'rn', remat,
AdaBound, the reverse-order pass, linear fusion and negative supports, each
trained at full width with 7 K1 and 7 K1b launches a step, 8 and 8 with
negative supports, and peak memory with and without remat; the same configs'
small float32 steps on the card against the CPU; K3 against its plain
version at 9 and 14 predictor columns; the fused eval forward of the
neg-support focal model with 1 K3 launch and of the linear-fusion model with
none), and the support-side and dense-point switches (phase 12: config A,
FEW_SHOT.SUPP_AUG with the flip, the jitter and the conv merge, and
MASK_SUPP, on a synthetic dataset with polygon segmentations: H1 bit for bit
on the first batch's 24 support slots, tools.test_net with the fused head
and tools.train_net, with ms per batch and per step, the loader's host ms
and launches; config B, the max merge and 4 dense points per FCOS cell:
train steps and an eval forward at full width; the small float32 forward
and train step of the avg merge and of 5 dense points on the card against
the CPU), and the mask and keypoint heads (phase 13: K1 and K1b at their
14x14 pools against their plain versions -- K1 on P4 at R = 16 000 and
1024, over P3-P4 and at its edge cases, K1b at R = 1024 random and
GT-clustered, bit-identical run to run; then the flagship with MASK_ON and
KEYPOINT_ON at full width: eval forwards unfused and fused with 9 K1
launches each, tools.test_net with segm_* and keypoints_*, tools.train_net
with loss_mask and loss_kp and 9 K1 and 9 K1b calls a step, small float32
forward and train checks against the CPU, the predictor's masks and
contours), and TPU.QUANT (phase 14: small float32 'int8' and 'int8_weight'
forwards with the mask and keypoint heads on the card against the CPU, each
'int8' layer replayed on the CPU's input and bit for bit; the fast-eval
preset at full width in bf16 with QUANT none, int8 and int8_weight, ms/batch
by CUDA events, peak memory, 7 K1 a forward; tools.quant_drift against the
bf16 float forward at production capacities beside the stated bound; an
int8_weight model with int8 codes as an ExportedProgram bundle bit for bit
against OneShotPredictor and its support program compiled by AOTInductor),
and the anchor stage 1 (phase 15, MODEL.FCOS_ON False: the anchor RPN
feeding stage 2 and RetinaNet with RPN_ONLY at full width, eval forwards
with 7 and 6 K1 launches, train steps with 7 and 5 K1 and K1b calls, the
anchor RPN through tools.test_net, tools.train_net and the predictor, and
small float32 forwards and train steps of both on the card against the CPU),
and the last eval-path gaps (phase 16: K1 at C = 512, bf16 and float32 (two
channel slices), against its plain version with its plan on the proposals,
the predictor's 1 x 2000, the p3-skew mix and the edge cases; the preset,
the full forward and the 'int8' preset with ONESHOT_PREPOOL_COMPRESS=1,
hoisted with and without the fused opt-in (7 K1, 0 K3) and un-hoisted in
the same call, small float32 and 'int8' hoisted forwards against the CPU;
RetinaNet with RPN_ONLY under 'int8' and 'int8_weight' at full width and
small against the CPU; the anchor RPN's serving bundle through
ArtifactPredictor bit for bit against OneShotPredictor and RetinaNet's
batch-8 full program bit for bit against eager; tools.webcam on a 3-frame
MJPG where cv2 imports) -- and checks small float32 forwards and a small float32 train
step on the card against the same model on the CPU. Every kernel's launch count is
set to 0 before each path and read after it. Any failure raises and exits
non-zero. The last two lines of stdout are the per-kernel JSON line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM, bf16 tensor cores, dense
TF32_OPS_PER_S = 494.7e12     # H100 SXM, TF32 tensor cores, dense
KERNEL_SOURCE = "oneshotdet_tpu_torch/csrc/roi_align.cu"
KERNEL_REPLACES = "oneshotdet_tpu/ops/pallas_roi_align.py:249"
BWD_SOURCE = "oneshotdet_tpu_torch/csrc/roi_align_bwd.cu"
# no TPU kernel: the JAX package takes this gradient as XLA's transpose of
BWD_REPLACES = "none: XLA autodiff of oneshotdet_tpu/ops/roi_align.py:215"
# K1b against the plain gradient, its float32 terms summed in float64 (a
# float32 sum by atomic adds moves from run to run): the kernel
# sums a pixel's terms in float32 in its own order (separable weights, tile
# by tile), so a sum that cancels keeps an absolute error of the order of its
# terms' rounding (GRAD_ATOL x the largest gradient); f32 within GRAD_RTOL
# relative on top, bf16 within 1 bf16 ulp (the one rounding to bf16)
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-6
HEAD_SOURCE = "oneshotdet_tpu_torch/csrc/roi_head.cu"
HEAD_REPLACES = "oneshotdet_tpu/ops/pallas_roi_head.py:226"
# fused head vs its plain version: both run float32-accurate chains (the
# kernel's as 3xTF32 products) and differ in the order of the sums (f32); in
# bf16 an intermediate can round to the neighbouring bf16 value (outputs of
# order 1)
HEAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the float32 flagship forward, fused head against unfused: the share of
# detections that pair up (random weights leave near-ties at the top-k cut)
F32_MIN_MATCH = 0.95
# (R, ROIs per image): the two cells, the predictor's frame, a 3-image tail
HEAD_CASES = ((16000, 2000), (4096, 512), (2000, 2000), (24, 8))
GN_SOURCE = "oneshotdet_tpu_torch/csrc/group_norm.cu"
GN_REPLACES = "oneshotdet_tpu/ops/pallas_groupnorm.py:111"
V3_SOURCE = "oneshotdet_tpu_torch/csrc/roi_align_v3.cu"
V3_REPLACES = "oneshotdet_tpu/ops/pallas_roi_align_v3.py:119"
V4_SOURCE = "oneshotdet_tpu_torch/csrc/roi_align_v4.cu"
V4_REPLACES = "oneshotdet_tpu/ops/pallas_roi_align_v4.py:168"
SCALES_Q = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
ENGINE_MIN_SHARE = 0.8        # see engine_checks
QUERY_HW = (832, 1216)
SUPP_HW = (416, 416)
BATCH = 8
H1_SOURCE = "oneshotdet_tpu_torch/csrc/resize_normalize_pad.cu"
# no TPU kernel: the JAX package's native host pass (C++ through ctypes, one
# call per image, oneshotdet_tpu/data/collate.py:48)
H1_REPLACES = "oneshotdet_tpu/csrc/fast_collate.cpp:69"
DATA_IMAGES = 24              # phase 8's synthetic dataset: VOC-sized PPM images
DATA_SIZES = ((375, 500), (500, 375))
DATA_BOX_SIDE = (90.0, 300.0)     # areas above INPUT.SUPP_AREA_THRESHOLD (80 x 80)
CLI_STOP_ITER = 4             # batches the eval CLI evaluates: one warm-up, three timed
TRAIN_CLI_ITERS = (3, 6)      # phase 9: run A's MAX_ITER (= its CHECKPOINT_PERIOD), run B's
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_TRAJECTORY = 2, 10, 20
# tests/torch_port_common.py's SMALL capacities, for the small train step
SMALL = ["MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 200, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 100,
         "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 64, "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 32,
         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 32,
         "TPU.MAX_GT_BOXES", 4, "TPU.NMS_PRE_TOPK", 256, "TPU.COMPUTE_DTYPE", "float32"]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text):
    """From an ``-Xptxas -v`` log: {kernel: (registers, spill store bytes,
    spill load bytes)} and the lines that warn of an ignored setmaxnreg
    (C7508) or serialized wgmma (C7513)."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            kernels.setdefault(cur, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            kernels.setdefault(cur, [0, 0, 0])[0] = int(m.group(1))
    warnings = [ln.strip() for ln in text.splitlines() if "C7508" in ln or "C7513" in ln]
    return {k: tuple(v) for k, v in kernels.items()}, warnings


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


def edge_case_rois(gen, dev):
    """K1's edge cases on the query pyramid: (name, rois, levels or None for
    the FPN rule, valid). One ROI alone; ROIs as wide as a whole P3 row (152
    cells) at heights of 1 to 100 px, on P3; ROIs wholly outside the level
    on each side; a batch whose every slot is invalid."""
    h, w = QUERY_HW
    n = 64
    b = torch.randint(0, BATCH, (n, 1), generator=gen).float()
    y1 = torch.rand(n, 1, generator=gen) * (h - 100)
    row = torch.cat([b, torch.zeros(n, 1), y1, torch.full((n, 1), float(w)),
                     y1 + 1 + torch.rand(n, 1, generator=gen) * 99], dim=1)
    xy = torch.rand(n, 2, generator=gen) * torch.tensor([w, h])
    wh = 8 + torch.rand(n, 2, generator=gen) * 200
    shift = torch.zeros(n, 2)
    shift[0::4, 0] = w + 20 + wh[0::4, 0]                  # right of the level
    shift[1::4, 0] = -(xy[1::4, 0] + 2 * wh[1::4, 0] + 20)   # left
    shift[2::4, 1] = h + 20 + wh[2::4, 1]                  # below
    shift[3::4, 1] = -(xy[3::4, 1] + 2 * wh[3::4, 1] + 20)   # above
    outside = torch.cat([b, xy + shift, xy + shift + wh], dim=1)
    one = torch.tensor([[3.0, 100.0, 200.0, 420.0, 350.0]])
    invalid, _ = random_rois(n, BATCH, QUERY_HW, gen, "cpu")
    p3 = torch.zeros(n, dtype=torch.int32, device=dev)
    return [("R=1", one.to(dev), None, None),
            ("whole P3 row R=64", row.to(dev), p3, None),
            ("outside R=64", outside.to(dev), None, None),
            ("all invalid R=64", invalid.to(dev), None, torch.zeros(n, dtype=torch.bool, device=dev))]


def k1_bound(feats, rois, levels, valid, out, pixels=None):
    """K1's bound on these inputs (ms, 'bytes' or 'operations'): the pyramid
    (or only the ``pixels`` distinct pixels the ROIs' samples touch, where
    given), ROIs, levels and flags read once and the output written once at
    the card's memory rate; 2 x 2 samples x 4 corners x (multiply + add) per
    output value at the fp32 rate."""
    elt = out.element_size()
    fbytes = (sum(f.numel() for f in feats) if pixels is None
              else pixels * feats[0].shape[-1]) * elt
    in_bytes = fbytes + rois.numel() * 4 + levels.numel() * 4
    in_bytes += 0 if valid is None else valid.numel()
    nbytes = in_bytes + out.numel() * elt
    ops = out.numel() * 4 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops


PLAIN_CHUNK = 1000             # ROIs per call of a plain version (14x14: (R, 784, C) temporaries)


def _plain_chunked(fn, rois, levels, valid, chunk=PLAIN_CHUNK):
    """The plain forward ``fn(rois, levels, valid)`` over ``chunk`` ROIs at a
    time, concatenated (a ROI's output depends on that ROI alone)."""
    outs = []
    for i in range(0, rois.shape[0], chunk):
        sl = slice(i, i + chunk)
        outs.append(fn(rois[sl], levels[sl], None if valid is None else valid[sl]))
    return torch.cat(outs)


def k1_compare(ra, name, dtype, args):
    """K1 against its plain version on ``args`` (the plain side PLAIN_CHUNK
    ROIs at a time, ``_plain_chunked``), with its plan's statistics against
    the Python mirror (``roi_align_plan``), every item within the staging
    buffer and the item count within MAX_ITEMS. Returns (kernel output, max abs err, metric
    text, tolerance text, staged bytes)."""
    feats, rois, levels, out_hw, scales, g, valid = args
    stats = torch.zeros((rois.shape[0], 2), dtype=torch.int32, device=rois.device)
    k = ra.multilevel_roi_align_cuda(*args, stats=stats)
    torch.cuda.synchronize()
    p = _plain_chunked(lambda r, lv, v: ra.multilevel_roi_align_plain(feats, r, lv, out_hw,
                                                                      scales, g, v),
                       rois, levels, valid)
    diff = (k.float() - p.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / p.float().abs().clamp(min=1e-6)).max()) if diff.numel() else 0.0
    metric = f"max abs err {err:.3e}, max rel err {rel:.3e}"
    if dtype == torch.float32:
        ok, tol = err <= 1e-5, "abs <= 1e-5"
    else:
        ulps = bf16_ulps(k, p) if diff.numel() else 0.0
        ok, tol = ulps <= 1.0, "<= 1 bf16 ulp"
        metric += f", {ulps:.2f} bf16 ulp"
    del p, diff
    if not (ok and torch.isfinite(k.float()).all()):
        raise AssertionError(f"roi_align {name} {dtype}: {metric} (tolerance {tol})")
    plans = ra.roi_align_plan(*args)
    want = torch.tensor([[0, 0] if pl is None else [len(pl.items), pl.staged_pixels]
                         for pl in plans], dtype=torch.int32)
    got = stats.cpu()
    if not torch.equal(got, want):
        i = int((got != want).any(1).nonzero()[0])
        raise AssertionError(f"roi_align {name} {dtype}: ROI {i}'s kernel plan (items, staged "
                             f"pixels) {got[i].tolist()} differs from roi_align_plan's "
                             f"{want[i].tolist()}")
    budget = ra.stage_budget(feats[0].shape[-1], dtype)
    worst = max((max((r1 - r0) * (c1 - c0) for *_, r0, r1, c0, c1 in pl.items)
                 for pl in plans if pl is not None), default=0)
    most = int(got[:, 0].max()) if got.numel() else 0
    if worst > budget or most > ra.MAX_ITEMS:
        raise AssertionError(f"roi_align {name} {dtype}: an item of {worst} pixels (budget "
                             f"{budget}) or {most} items (limit {ra.MAX_ITEMS})")
    staged = int(got[:, 1].sum()) * feats[0].shape[-1] * k.element_size()
    return k, err, f"{metric}; at most {most} items a ROI, {worst} of {budget} pixels an item", \
        tol, staged


def kernel_checks(ra, dev):
    """Phase 3: the ROIAlign kernel against its plain version at the main
    path's uses (the proposals at R = 16 000 and 4096, the predictor's
    1 x 2000, the support 7x7 and the five 1x1 pools), at its edge cases
    (one ROI, ROIs as wide as a P3 row, ROIs wholly outside, all slots
    invalid) and on the p3-skew mix timed on fresh inputs; each case's plan
    statistics against ``roi_align_plan``. Returns {(case, dtype): entry}."""
    from oneshotdet_tpu_torch.tools import time_fresh_ms
    from oneshotdet_tpu_torch.tools.tune_roialign_v3 import make_inputs

    gen = torch.Generator().manual_seed(3)
    scales = SCALES_Q
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
        rois, valid = random_rois(2000, 1, QUERY_HW, gen, dev)
        cases.append(("predictor 7x7 1 x 2000", [f[:1] for f in q_feats], rois,
                      ra.fpn_level_map(rois[:, 1:], 3, 7), (7, 7), scales, valid))
        cases.append(("support 7x7 R=8", s_feats, supp_rois,
                      ra.fpn_level_map(supp_rois[:, 1:], 3, 7), (7, 7), scales, None))
        for lvl in range(5):
            cases.append((f"support 1x1 P{lvl + 3} R=8", [s_feats[lvl]], supp_rois,
                          zero_lv, (1, 1), (scales[lvl],), None))
        for name, rois, levels, valid in edge_case_rois(gen, dev):
            levels = ra.fpn_level_map(rois[:, 1:], 3, 7) if levels is None else levels
            cases.append((name, q_feats, rois, levels, (7, 7), scales, valid))
        for name, feats, rois, levels, out_hw, sc, valid in cases:
            args = (feats, rois, levels, out_hw, sc, 2, valid)
            k, err, metric, tol, staged = k1_compare(ra, name, dtype, args)
            bound, by, nbytes, ops = k1_bound(feats, rois, levels, valid, k)
            ms = time_ms(lambda: ra.multilevel_roi_align_cuda(*args))
            plain_ms = time_ms(lambda: ra.multilevel_roi_align_plain(*args), reps=20, warmup=1)
            log(f"roi_align {name} {str(dtype)[6:]}: {metric} (tolerance {tol}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                f"({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), kernel at "
                f"{100 * bound / ms:.1f}% of its bound; staged {staged / 1e6:.1f} MB "
                f"from L2, plan as roi_align_plan")
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bound_share=bound / ms)
            del k
        del q_feats, s_feats
        torch.cuda.empty_cache()
        # the FCOS-like mix (sides U(8, 110), mostly on P3) at R = 16 000, each
        # timed call on inputs it has not seen
        warmup, iters = 1, 5
        inputs = [make_inputs(500 + i, dev, dtype=dtype, skew="p3")[:3]
                  for i in range(warmup + 1 + iters)]
        feats, rois, levels = inputs[-1]
        args = (feats, rois, levels, (7, 7), scales, 2, None)
        k, err, metric, tol, staged = k1_compare(ra, "p3-skew R=16000", dtype, args)
        bound, by, nbytes, ops = k1_bound(feats, rois, levels, None, k)
        ms = time_fresh_ms(lambda f, r, lv: ra.multilevel_roi_align_cuda(f, r, lv, (7, 7),
                                                                          scales, 2),
                           inputs, warmup)
        log(f"roi_align p3-skew R=16000 {str(dtype)[6:]} (fresh inputs each call): {metric} "
            f"(tolerance {tol}); kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
            f"{100 * bound / ms:.1f}% of its bound; staged {staged / 1e6:.1f} MB from L2")
        results[("p3-skew R=16000", dtype)] = dict(max_abs_err=err, ms=ms, bound_ms=bound,
                                                   bound_by=by, bound_share=bound / ms)
        del inputs, feats, rois, levels, k
        torch.cuda.empty_cache()
    return results


def clustered_rois(gen, dev, per_gt=32, gts=4):
    """R = BATCH x gts x per_gt ROIs crowded onto a few GT-like boxes per
    image (each ROI its GT jittered by up to 10% of its size), as sampled
    proposals crowd onto the GT: neighbouring ROIs share most pixels."""
    h, w = QUERY_HW
    rows = []
    for b in range(BATCH):
        wh = 32 + torch.rand(gts, 2, generator=gen) * 368
        xy = torch.rand(gts, 2, generator=gen) * (torch.tensor([w, h]) - wh)
        gt = torch.cat([xy, xy + wh], dim=1).repeat_interleave(per_gt, dim=0)
        jitter = (torch.rand(gt.shape, generator=gen) - 0.5) * 0.2 * wh.repeat_interleave(
            per_gt, dim=0).repeat(1, 2)
        rows.append(torch.cat([torch.full((gts * per_gt, 1), float(b)), gt + jitter], dim=1))
    return torch.cat(rows).to(dev)


def k1b_bound(grad_out, rois, levels, valid, shapes):
    """K1b's bound on these inputs (ms, 'bytes' or 'operations', bytes,
    ops): grad_out, ROIs, levels and flags read once and the gradient
    written once in the features' dtype, at the card's memory rate; 2 x 2
    samples x 4 corners x (multiply + add) per grad_out value at the fp32
    rate."""
    elt = grad_out.element_size()
    nbytes = (grad_out.numel() * elt + rois.numel() * 4 + levels.numel() * 4
              + (0 if valid is None else valid.numel())
              + sum(math.prod(s) for s in shapes) * elt)
    ops = grad_out.numel() * 4 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops


def grad_compare(label, dtype, got, want):
    """Per-level gradients ``got`` (the kernel's, in ``dtype``) against
    ``want`` (the plain gradient, its float32 terms summed in float64 and
    rounded once to float32, where a float32 sum by the plain version's
    atomic adds moves from run to run): f32 within GRAD_RTOL |want| +
    GRAD_ATOL max|want|, bf16 within 1 bf16 ulp of |want| + the same
    GRAD_ATOL term. Raises otherwise; returns (max abs err, worst share of
    the allowance, text)."""
    gmax = max(float(w.abs().max()) for w in want)
    atol = GRAD_ATOL * gmax
    err = share = 0.0
    for k, w in zip(got, want):
        if k.shape != w.shape or k.dtype != dtype:
            raise AssertionError(f"{label}: gradient {tuple(k.shape)} {k.dtype}, expected "
                                 f"{tuple(w.shape)} {dtype}")
        k = k.float()
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{label}: non-finite gradient")
        d = (k - w).abs()
        if dtype == torch.float32:
            allowed = GRAD_RTOL * w.abs() + atol
        else:
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
            allowed = ulp + atol
        err = max(err, float(d.max()))
        share = max(share, float((d / allowed).max()))
    tol = (f"rtol {GRAD_RTOL} + atol {GRAD_ATOL} x max|grad|" if dtype == torch.float32
           else f"1 bf16 ulp + atol {GRAD_ATOL} x max|grad|")
    text = (f"max abs err {err:.3e} (max |grad| {gmax:.3e}), worst {100 * share:.1f}% of the "
            f"allowance ({tol})")
    if share > 1.0:
        raise AssertionError(f"{label} {dtype}: {text}")
    return err, share, text


def bwd_parts(ra, bargs, calls=3):
    """(runtime launch calls per call, device ms per call of the tile bits
    and of the body) of K1b's wrapper on ``bargs``, by torch.profiler
    (``ablate_v4.kernel_ms``)."""
    launches, per_kernel = roi_variant_launches(
        lambda: ra.multilevel_roi_align_backward_cuda(*bargs), calls)
    bits = sum(ms for k, ms in per_kernel.items() if "roi_align_bwd_tiles" in k)
    body = sum(ms for k, ms in per_kernel.items() if "roi_align_bwd_body" in k)
    return launches, bits, body


def bwd_no_sync(ra, bargs, want):
    """K1b's wrapper makes no host sync: one call under
    torch.cuda.set_sync_debug_mode("error"), and one captured in a CUDA graph
    and replayed; both bit-identical to ``want``."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ra.multilevel_roi_align_backward_cuda(*bargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ra.multilevel_roi_align_backward_cuda(*bargs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ra.multilevel_roi_align_backward_cuda(*bargs)
    graph.replay()
    torch.cuda.synchronize()
    for label, out in (("under sync-debug mode", got), ("replayed from a CUDA graph", captured)):
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"roi_align_bwd {label}: differs from the eager call")
    del graph, captured


def roi_align_bwd_checks(ra, dev):
    """Phase 3e: the ROIAlign backward kernel K1b against its plain version
    (the plain gradient of the same inputs, summed in float64) at the train
    step's shapes: the proposals' R = 1024 (random and GT-clustered ROIs) over the
    batch-8 832x1216 pyramid, the support 7x7 (R = 8) and the five 1x1 pools
    on the 416x416 support pyramid; at K1's edge cases (with valid = False
    slots); and the whole autograd Function (K1 forward, K1b backward)
    against torch.autograd.grad of the float32 plain forward. In every case
    the kernel's tile bits equal ``roi_align_bwd_plan``'s, two calls and one
    call on each of two streams give the same bits, and the call makes 2
    launches (runtime calls, torch.profiler); the Function's gradient is
    bit-identical across two torch.autograd.grad calls; at R = 1024 the
    wrapper runs under sync-debug mode and inside a CUDA graph. Logs each
    case's time, its tile bits and body apart, bound and share of it.
    Returns {(case, dtype): entry}."""
    gen = torch.Generator().manual_seed(4)
    scales = SCALES_Q
    q_shapes = [(BATCH, h, w, 256) for h, w in pyramid_shapes(*QUERY_HW)]
    s_shapes = [(BATCH, h, w, 256) for h, w in pyramid_shapes(*SUPP_HW)]
    supp_rois = torch.tensor([[i, 0.0, 0.0, 416.0 - 13 * i, 300.0 + 10 * i]
                              for i in range(BATCH)], device=dev)
    zero_lv = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    rois, valid = random_rois(1024, BATCH, QUERY_HW, gen, dev)
    crowd = clustered_rois(gen, dev)
    cases = [("proposals 7x7 R=1024", q_shapes, rois, ra.fpn_level_map(rois[:, 1:], 3, 7),
              (7, 7), scales, valid),
             ("GT-clustered 7x7 R=1024", q_shapes, crowd, ra.fpn_level_map(crowd[:, 1:], 3, 7),
              (7, 7), scales, None),
             ("support 7x7 R=8", s_shapes, supp_rois, ra.fpn_level_map(supp_rois[:, 1:], 3, 7),
              (7, 7), scales, None)]
    for lvl in range(5):
        cases.append((f"support 1x1 P{lvl + 3} R=8", [s_shapes[lvl]], supp_rois, zero_lv,
                      (1, 1), (scales[lvl],), None))
    for name, r, lv, v in edge_case_rois(gen, dev):
        cases.append((name, q_shapes, r, ra.fpn_level_map(r[:, 1:], 3, 7) if lv is None else lv,
                      (7, 7), scales, v))
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes, r, lv, out_hw, sc, v in cases:
            g_out = torch.randn((r.shape[0], *out_hw, 256), generator=gen).to(dev, dtype)
            bargs = (g_out, shapes, dtype, r, lv, out_hw, sc, 2, v)
            plan = ra.roi_align_bwd_plan(shapes, r, lv, out_hw, sc, 2, v)
            scratch = ra.bwd_scratch(r.shape[0], len(plan.tiles), dev)
            got = ra.multilevel_roi_align_backward_cuda(*bargs, scratch=scratch)
            torch.cuda.synchronize()
            bits = ra.bwd_tile_bits(scratch, r.shape[0], len(plan.tiles))
            if not torch.equal(bits.cpu(), plan.bits()):
                diff = [t for t, (a, b) in enumerate(zip(ra.bwd_lists_from_bits(bits),
                                                         plan.lists)) if a != b]
                raise AssertionError(f"roi_align_bwd {name} {dtype}: the kernel's tile lists "
                                     f"differ from roi_align_bwd_plan's at {len(diff)} tiles, "
                                     f"first {plan.tiles[diff[0]] if diff else None}")
            want = ra.multilevel_roi_align_backward_plain(g_out.float(), shapes, torch.float32,
                                                          r, lv, out_hw, sc, 2, v,
                                                          work_dtype=torch.float64)
            err, share, text = grad_compare(f"roi_align_bwd {name}", dtype, got, want)
            del want
            again = ra.multilevel_roi_align_backward_cuda(*bargs)
            streams = (torch.cuda.Stream(), torch.cuda.Stream())
            outs = []
            for st in streams:
                st.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(st):
                    outs.append(ra.multilevel_roi_align_backward_cuda(*bargs))
            for st in streams:
                torch.cuda.current_stream().wait_stream(st)
            torch.cuda.synchronize()
            for label, out in (("a second call", again), ("a call on stream 1", outs[0]),
                               ("a call on stream 2", outs[1])):
                if not all(torch.equal(a, b) for a, b in zip(out, got)):
                    raise AssertionError(f"roi_align_bwd {name} {dtype}: {label} is not "
                                         f"bit-identical to the first")
            del again, outs
            if name == "proposals 7x7 R=1024":
                bwd_no_sync(ra, bargs, got)
            launches, bits_dev_ms, body_dev_ms = bwd_parts(ra, bargs)
            if launches != (2 if r.shape[0] else 1):
                raise AssertionError(f"roi_align_bwd {name} {dtype}: {launches} launches per "
                                     f"call, expected 2 (the tile bits and the body)")
            del got
            bound, by, nbytes, ops = k1b_bound(g_out, r, lv, v, shapes)
            ms = time_ms(lambda: ra.multilevel_roi_align_backward_cuda(*bargs))
            plain_ms = time_ms(lambda: ra.multilevel_roi_align_backward_plain(*bargs),
                               reps=5, warmup=1)
            pairs = sum(len(x) for x in plan.lists)
            log(f"roi_align_bwd {name} {str(dtype)[6:]}: {text}; tile bits as "
                f"roi_align_bwd_plan ({pairs} (tile, ROI) pairs over {len(plan.tiles)} tiles), "
                f"bit-identical over 2 calls and 2 streams, {launches:g} launches per call; "
                f"kernel {ms:.4f} ms (device: the tile bits {bits_dev_ms:.4f}, the body "
                f"{body_dev_ms:.4f}), "
                f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP), kernel at {100 * bound / ms:.1f}% of its bound")
            results[(name, dtype)] = dict(max_abs_err=err, allowance_share=share, ms=ms,
                                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                          bound_share=bound / ms, bits_device_ms=bits_dev_ms,
                                          body_device_ms=body_dev_ms, launches_per_call=launches,
                                          pairs=pairs)
            del bits, scratch
        torch.cuda.empty_cache()
        # the autograd Function: K1 forward, K1b backward, against autograd of
        # the float32 plain forward; two backward calls bit-identical
        feats = [torch.randn(s, generator=gen).to(dev, dtype).requires_grad_() for s in q_shapes]
        lv = ra.fpn_level_map(rois[:, 1:], 3, 7)
        g_out = torch.randn((rois.shape[0], 7, 7, 256), generator=gen).to(dev, dtype)
        n1, n1b = ra.roi_align_launches, ra.roi_align_bwd_launches
        out = ra.multilevel_roi_align(feats, rois, lv, (7, 7), scales, 2, valid)
        got = torch.autograd.grad(out, feats, g_out, retain_graph=True)
        if (ra.roi_align_launches - n1, ra.roi_align_bwd_launches - n1b) != (1, 1):
            raise AssertionError("roi_align Function: K1 and K1b must launch once each")
        again = torch.autograd.grad(out, feats, g_out)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("roi_align Function: two torch.autograd.grad calls differ")
        f32 = [f.detach().float().requires_grad_() for f in feats]
        ref = ra.multilevel_roi_align_plain(f32, rois, lv, (7, 7), scales, 2, valid)
        want = torch.autograd.grad(ref, f32, g_out.float())
        if dtype == torch.float32 and not torch.equal(out, ref):
            raise AssertionError("roi_align Function: forward differs from the plain version")
        err, _, text = grad_compare("roi_align Function", dtype, list(got), list(want))
        log(f"roi_align Function (K1 + K1b) R=1024 {str(dtype)[6:]} against "
            f"torch.autograd.grad of the float32 plain forward: {text}; two "
            f"torch.autograd.grad calls bit-identical")
        del feats, out, got, again, f32, ref, want
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        crowd_ms = results[("GT-clustered 7x7 R=1024", dtype)]["ms"]
        rand_ms = results[("proposals 7x7 R=1024", dtype)]["ms"]
        log(f"roi_align_bwd crowded tiles: GT-clustered R=1024 {str(dtype)[6:]} {crowd_ms:.4f} "
            f"ms against random ROIs {rand_ms:.4f} ms ({crowd_ms / rand_ms:.2f}x)")
    return results


MASK_POOL = (14, 14)           # the mask and keypoint heads' pools (POOLER_RESOLUTION 14)


def mask_kp_kernel_checks(ra, dev):
    """Phase 13a-b: K1 and K1b at the mask and keypoint heads' 14 x 14 pools.
    13a, K1 against its plain version in bf16 and f32 (plan statistics as
    ``roi_align_plan``, every item within the staging buffer, the item count
    within MAX_ITEMS): one level, P4 of the batch-8 832x1216 pyramid, at
    R = 16 000 (the eval's 8 x 2000 detections) and R = 1024 (training); two
    levels (1/8, 1/16) by the FPN rule; K1's edge cases on P4. 13b, K1b at
    R = 1024 on P4, random and GT-clustered, against the plain gradient
    (summed in float64), its tile bits as ``roi_align_bwd_plan``'s,
    bit-identical over two calls. Returns {(case, dtype): entry}."""
    gen = torch.Generator().manual_seed(13)
    q_shapes = pyramid_shapes(*QUERY_HW)
    p4 = (BATCH, *q_shapes[1], 256)
    results = {}
    bwd = ra._bwd_kernel()
    for dtype in (torch.bfloat16, torch.float32):
        code = 1 if dtype == torch.bfloat16 else 0
        log(f"roi_align_bwd at {MASK_POOL[0]}x{MASK_POOL[1]} {str(dtype)[6:]}: prefetch depth "
            f"{bwd.oneshot_roi_align_bwd_prefetch(code, MASK_POOL[0] * MASK_POOL[1])} (7x7: "
            f"{bwd.oneshot_roi_align_bwd_prefetch(code, 49)})")
        feats = [torch.randn(BATCH, h, w, 256, generator=gen).to(dev, dtype)
                 for h, w in q_shapes[:2]]
        cases = []
        for r in (16000, 1024):
            rois, valid = random_rois(r, BATCH, QUERY_HW, gen, dev)
            cases.append((f"P4 14x14 R={r}", feats[1:], rois,
                          torch.zeros(r, dtype=torch.int32, device=dev), (0.0625,), valid))
        rois, valid = random_rois(4096, BATCH, QUERY_HW, gen, dev)
        cases.append(("P3-P4 14x14 R=4096", feats, rois, ra.fpn_level_map(rois[:, 1:], 3, 4),
                      (0.125, 0.0625), valid))
        for name, r, lv, v in edge_case_rois(gen, dev):
            cases.append((f"P4 14x14 {name}", feats[1:], r,
                          torch.zeros(r.shape[0], dtype=torch.int32, device=dev), (0.0625,), v))
        for name, fs, rois, levels, sc, valid in cases:
            args = (fs, rois, levels, MASK_POOL, sc, 2, valid)
            k, err, metric, tol, staged = k1_compare(ra, name, dtype, args)
            bound, by, nbytes, ops = k1_bound(fs, rois, levels, valid, k)
            del k
            ms = time_ms(lambda: ra.multilevel_roi_align_cuda(*args), reps=10)
            plain_ms = time_ms(lambda: _plain_chunked(
                lambda r, lv, v: ra.multilevel_roi_align_plain(fs, r, lv, MASK_POOL, sc, 2, v),
                rois, levels, valid), reps=2, warmup=0)
            log(f"roi_align {name} {str(dtype)[6:]}: {metric} (tolerance {tol}); kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({PLAIN_CHUNK} ROIs a call), bound "
                f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), kernel at "
                f"{100 * bound / ms:.1f}% of its bound; staged {staged / 1e6:.1f} MB from L2")
            results[(name, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound, bound_by=by, bound_share=bound / ms)
        del feats, cases
        torch.cuda.empty_cache()
        # 13b: K1b at R = 1024 on P4
        rois, valid = random_rois(1024, BATCH, QUERY_HW, gen, dev)
        zero = torch.zeros(1024, dtype=torch.int32, device=dev)
        for name, r, v in (("P4 14x14 R=1024", rois, valid),
                           ("GT-clustered P4 14x14 R=1024", clustered_rois(gen, dev), None)):
            g_out = torch.randn((1024, *MASK_POOL, 256), generator=gen).to(dev, dtype)
            bargs = (g_out, [p4], dtype, r, zero, MASK_POOL, (0.0625,), 2, v)
            plan = ra.roi_align_bwd_plan([p4], r, zero, MASK_POOL, (0.0625,), 2, v)
            scratch = ra.bwd_scratch(1024, len(plan.tiles), dev)
            got = ra.multilevel_roi_align_backward_cuda(*bargs, scratch=scratch)
            torch.cuda.synchronize()
            bits = ra.bwd_tile_bits(scratch, 1024, len(plan.tiles))
            if not torch.equal(bits.cpu(), plan.bits()):
                raise AssertionError(f"roi_align_bwd {name} {dtype}: the kernel's tile lists "
                                     f"differ from roi_align_bwd_plan's")
            want = ra.multilevel_roi_align_backward_plain(g_out.float(), [p4], torch.float32,
                                                          r, zero, MASK_POOL, (0.0625,), 2, v,
                                                          work_dtype=torch.float64)
            err, share, text = grad_compare(f"roi_align_bwd {name}", dtype, got, want)
            del want
            again = ra.multilevel_roi_align_backward_cuda(*bargs)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"roi_align_bwd {name} {dtype}: a second call is not "
                                     f"bit-identical to the first")
            del again, got, bits, scratch
            bound, by, nbytes, ops = k1b_bound(g_out, r, zero, v, [p4])
            ms = time_ms(lambda: ra.multilevel_roi_align_backward_cuda(*bargs), reps=10)
            plain_ms = time_ms(lambda: ra.multilevel_roi_align_backward_plain(*bargs),
                               reps=3, warmup=1)
            pairs = sum(len(x) for x in plan.lists)
            log(f"roi_align_bwd {name} {str(dtype)[6:]}: {text}; tile bits as "
                f"roi_align_bwd_plan ({pairs} (tile, ROI) pairs), bit-identical over 2 calls; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), kernel at "
                f"{100 * bound / ms:.1f}% of its bound")
            results[(f"bwd {name}", dtype)] = dict(max_abs_err=err, allowance_share=share, ms=ms,
                                                   plain_ms=plain_ms, bound_ms=bound,
                                                   bound_by=by, bound_share=bound / ms)
        torch.cuda.empty_cache()
    return results


def head_work(r, b, ops):
    """(bytes, flops) the fused head needs: each input and operand read
    once, the outputs written once; multiply-adds of compress_0 (query half
    per ROI, support half per image), compress_1, the 3x3 conv, fc6, fc7 and
    the predictors."""
    hidden, npred = ops["fc7"].shape[0], ops["pred"].shape[1]
    elt = torch.finfo(ops["dtype"]).bits // 8
    operands = sum(v.numel() * v.element_size() for k, v in ops.items()
                   if torch.is_tensor(v) and not k.endswith("T"))   # not the transposed copies
    nbytes = (r + b) * 49 * 256 * elt + operands + r * npred * 4
    per_roi = 49 * (256 * 512 + 512 * 256 + 9 * 256 * 128) + 49 * 128 * hidden \
        + hidden * hidden + hidden * npred
    return nbytes, 2 * (r * per_roi + b * 49 * 256 * 512)


def head_checks(dev):
    """Phase 3b: the fused head kernel against its plain version at the main
    path's ROI counts (B = 8 images x 2000 and x 512 proposals, the
    predictor's 1 x 2000) and a tail of 3 images x 8, f32 and bf16, seeded
    N(0, 1/fan_in) weights; a support swap; times of the kernel, the plain
    version and the unfused ROIBoxHead (cuBLAS/cuDNN layers), and the
    kernel's share of its bound."""
    from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead
    from oneshotdet_tpu_torch.ops import roi_head_fused as rf

    gen = torch.Generator().manual_seed(21)
    head = ROIBoxHead()
    distinct_weights_(head, gen)
    head = head.to(dev).eval()
    packed = rf.pack_roi_head_params(head)
    results = {}
    for r, per_image in HEAD_CASES:
        b = r // per_image
        x32 = torch.randn(r, 7, 7, 256, generator=gen).to(dev)
        s32 = torch.randn(b, 7, 7, 256, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, supp = x32.to(dtype), s32.to(dtype)
            ops = rf.kernel_operands(packed, dtype)
            with torch.inference_mode():
                kl, kd = rf.fused_roi_head_cuda(x, supp, ops, per_image)
                torch.cuda.synchronize()
                pl, pd = rf.fused_roi_head_plain(x, supp, ops, per_image)
                # another image's support; with one image, its channels reversed
                other = supp.flip(0) if b > 1 else supp.flip(-1)
                sl, _ = rf.fused_roi_head_cuda(x, other, ops, per_image)
                torch.cuda.synchronize()
            err = max(float((kl - pl).abs().max()), float((kd - pd).abs().max()))
            scale = max(float(pl.abs().max()), float(pd.abs().max()))
            rel = err / scale
            swap = float((sl - kl).abs().max())
            tol = HEAD_TOL[dtype]
            name = f"R={r} ({b} x {per_image}) {str(dtype)[6:]}"
            if not (err <= tol and torch.isfinite(kl).all() and torch.isfinite(kd).all()):
                raise AssertionError(f"roi_head {name}: max abs err {err:.3e} (tolerance {tol})")
            if not swap > 10 * tol:
                raise AssertionError(f"roi_head {name}: swapping supports moved the logits "
                                     f"by only {swap:.3e}")
            reps = 10 if dtype == torch.bfloat16 else 5
            with torch.inference_mode():
                ms = time_ms(lambda: rf.fused_roi_head_cuda(x, supp, ops, per_image), reps=reps)
                plain_ms = time_ms(lambda: rf.fused_roi_head_plain(x, supp, ops, per_image),
                                   reps=5, warmup=1)
                unfused_ms = time_ms(lambda: head(x, supp), reps=reps)
            nbytes, flops = head_work(r, b, ops)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            if dtype == torch.bfloat16:
                t_ops, ops_by, ops_text = flops / BF16_OPS_PER_S * 1e3, "operations", ""
            else:
                # float32-accurate products: as FP32 FMA, or as three TF32
                # tensor-core products each (3xTF32); the smaller bounds
                t_fma = flops / FP32_OPS_PER_S * 1e3
                t_3x = 3 * flops / TF32_OPS_PER_S * 1e3
                t_ops = min(t_fma, t_3x)
                ops_by = "3xtf32 ops" if t_3x <= t_fma else "fma ops"
                ops_text = (f"; FMA bound {t_fma:.4f} ms (67 TFLOP/s), 3xTF32 bound "
                            f"{t_3x:.4f} ms (3 x ops at 494.7 TFLOP/s)")
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else ops_by
            log(f"roi_head {name}: max abs err {err:.3e} at output scale {scale:.3f} "
                f"({rel:.2e} of it; tolerance {tol} abs); support swap moves logits by "
                f"{swap:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused ROIBoxHead "
                f"(cuBLAS/cuDNN) {unfused_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e12:.3f} TFLOP{ops_text}), kernel at "
                f"{100 * bound / ms:.1f}% of its bound, {unfused_ms / ms:.2f}x the unfused head")
            results[(r, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       unfused_ms=unfused_ms, bound_ms=bound, bound_by=by,
                                       bound_share=bound / ms)
            del kl, kd, pl, pd, sl, x, supp
            torch.cuda.empty_cache()
    return results


def gn_library(x, gamma, beta, act):
    """One PyTorch GroupNorm call (plus the activation) on the same input:
    NHWC viewed as channels-last NCHW."""
    y = torch.nn.functional.group_norm(x.permute(0, 3, 1, 2), 32, gamma.to(x.dtype),
                                       beta.to(x.dtype), 1e-5)
    if act == "relu":
        return torch.relu(y)
    return torch.nn.functional.leaky_relu(y, 0.2) if act == "leaky" else y


def group_norm_vs_library(gn, x, gamma, beta):
    """K2 (ReLU) and F.group_norm + ReLU on x: ms of one call on an idle card
    (median of 50, the host's part included) and per call over 40 calls back
    to back. Returns [K2 one call, library one call, K2 back to back,
    library back to back]."""
    from oneshotdet_tpu_torch.tools import time_fresh_ms

    k2 = lambda v: gn.group_norm_act_cuda(v, gamma, beta, 32, 1e-5, "relu", 0.2)
    lib = lambda v: gn_library(v, gamma, beta, "relu")
    times = [time_ms(lambda: k2(x), reps=50, warmup=5), time_ms(lambda: lib(x), reps=50, warmup=5),
             time_fresh_ms(k2, [(x,)] * 42, 1), time_fresh_ms(lib, [(x,)] * 42, 1)]
    log(f"group_norm {tuple(x.shape)} {str(x.dtype)[6:]} relu vs F.group_norm+relu: one call "
        f"{times[0]:.4f} vs {times[1]:.4f} ms, back to back {times[2]:.4f} vs {times[3]:.4f} "
        f"ms/call [{card_line()}]")
    return times


def group_norm_counter_checks(gn, dev, gamma, beta, gen):
    """K2's arrival counters, on the tower's P4 (66 runs an image), each
    result equal to the first call's: 200 calls back to back on one stream;
    100 on each of two streams at once; two CUDA graphs, each capturing one
    call (both on torch's one capture stream), replayed 3 times on two
    streams at once. Every stream's counters read 0 after, and the captures
    add none to them (a graph's call takes counters of its own)."""
    h, w = pyramid_shapes(*QUERY_HW)[1]
    xs = [torch.randn(BATCH, h, w, 256, generator=gen).to(dev, torch.bfloat16) for _ in range(2)]
    refs = [gn.group_norm_act_cuda(x, gamma, beta, 32, 1e-5, "relu")[0] for x in xs]
    cur = torch.cuda.current_stream(dev)
    zeros = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    bad = zeros()
    for i in range(200):
        bad += (gn.group_norm_act_cuda(xs[i % 2], gamma, beta, 32, 1e-5, "relu")[0]
                != refs[i % 2]).sum()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]

    def on_both_streams(rounds, call, tally):
        for s in streams:
            s.wait_stream(cur)
        for _ in range(rounds):
            for k, s in enumerate(streams):
                with torch.cuda.stream(s):
                    tally[k] += (call(k) != refs[k]).sum()
        for s in streams:
            cur.wait_stream(s)

    side_bad = [zeros(), zeros()]
    on_both_streams(100, lambda k: gn.group_norm_act_cuda(xs[k], gamma, beta, 32, 1e-5,
                                                          "relu")[0], side_bad)
    eager_buffers = len(gn._counters)
    graphs, g_outs = [torch.cuda.CUDAGraph() for _ in range(2)], []
    for k, graph in enumerate(graphs):
        with torch.cuda.graph(graph):
            g_outs.append(gn.group_norm_act_cuda(xs[k], gamma, beta, 32, 1e-5, "relu")[0])
    graph_bad = [zeros(), zeros()]

    def replay(k):
        graphs[k].replay()
        return g_outs[k]

    on_both_streams(3, replay, graph_bad)
    torch.cuda.synchronize()
    keys = {(xs[0].device.index, s.cuda_stream) for s in streams + [cur]}
    left = {k: int(counters.abs().sum()) for k, counters in gn._counters.items()}
    counts = (int(bad), [int(v) for v in side_bad], [int(v) for v in graph_bad])
    log(f"group_norm counters: 200 back-to-back calls, 2 streams x 100 at once, 2 graphs x 3 "
        f"replays on 2 streams at once, on {tuple(xs[0].shape)} bf16: elements differing from "
        f"the first call {counts}; stream counter buffers {eager_buffers} before the captures, "
        f"{len(gn._counters)} after, their sums {left}")
    if (counts != (0, [0, 0], [0, 0]) or any(left.values()) or not keys <= set(left)
            or len(gn._counters) != eager_buffers):
        raise AssertionError(f"group_norm counters: {counts}, {left}")
    del xs, refs, g_outs, graphs


def group_norm_case(gn, x, gamma, beta, groups, act, name):
    """K2 against its plain version on x: f32 within 1e-4 abs, bf16 within 1
    bf16 ulp, the statistics within 1e-4 (abs for the mean, relative for
    inv); raises otherwise. Returns (max abs err, metric text, tolerance)."""
    k, k_mean, k_inv = gn.group_norm_act_cuda(x, gamma, beta, groups, 1e-5, act, 0.2)
    torch.cuda.synchronize()
    p, p_mean, p_inv = gn.group_norm_act_plain(x, gamma, beta, groups, 1e-5, act, 0.2)
    err = float((k.float() - p.float()).abs().max())
    stat_err = max(float((k_mean - p_mean).abs().max()),
                   float(((k_inv - p_inv) / p_inv).abs().max()))
    if x.dtype == torch.float32:
        ok, tol, metric = err <= 1e-4, "abs <= 1e-4", f"max abs err {err:.3e}"
    else:
        ulps = bf16_ulps(k, p)
        ok, tol = ulps <= 1.0, "<= 1 bf16 ulp"
        metric = f"max abs err {err:.3e}, {ulps:.2f} bf16 ulp"
    metric += f", statistics {stat_err:.2e}"
    if not (ok and stat_err <= 1e-4):
        raise AssertionError(f"group_norm {name}: {metric} (tolerance {tol})")
    return err, metric, tol


# (C, groups, (B, H, W)) of K2's cases off the tower's C = 256: the kernels'
# narrower thread widths (4 channels: C = 68, 260, 1028; 2 channels: C = 66,
# 2046), so bf16 loads of 8 and 4 bytes and f32 loads of 16 and 8 bytes; more
# than 256 threads a block (C = 1028, 2046: the 1024-thread build); C = 2040
# (8 channels, 255 threads); odd maps, down to one row
GN_WIDTH_CASES = [(66, 33, (3, 13, 19)), (66, 6, (1, 1, 1)), (68, 17, (3, 7, 5)),
                  (260, 13, (2, 21, 1)), (1028, 4, (3, 5, 3)), (2046, 31, (2, 9, 7)),
                  (2046, 66, (1, 1, 1)), (2040, 34, (3, 3, 11))]


def group_norm_width_checks(gn, dev, gen):
    """K2 against its plain version at GN_WIDTH_CASES, f32 and bf16, each
    activation, input mean 0.5."""
    for c, groups, (b, h, w) in GN_WIDTH_CASES:
        gamma = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        beta = (0.1 * torch.randn(c, generator=gen)).to(dev)
        x32 = torch.randn(b, h, w, c, generator=gen) + 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dev, dtype)
            cpt = gn.kernel_plan(x, gamma, beta, groups)[3]
            for act in (None, "relu", "leaky"):
                name = f"{tuple(x.shape)} G={groups} {str(dtype)[6:]} act={act}"
                _, metric, tol = group_norm_case(gn, x, gamma, beta, groups, act, name)
                log(f"group_norm {name}, {cpt} channels a thread, {c // cpt} threads a row: "
                    f"{metric} (tolerance {tol})")


def group_norm_checks(dev):
    """Phase 3c: the GroupNorm kernels (K2) against their plain version on the
    FCOS tower's shapes (batch 8, P3-P7 of 832x1216, C = 256), f32 and bf16,
    for no activation, ReLU and LeakyReLU(0.2); P3 at input mean 100 in both
    dtypes; the arrival counters (group_norm_counter_checks); the kernels'
    other channel widths (group_norm_width_checks); the backward
    through GroupNormAct with the kernels' forward against autograd of the
    plain forward. Times at P3 of the kernels, the plain version and
    F.group_norm, and ablate_group_norm's per-launch device times on fresh
    inputs (ReLU); K2 against F.group_norm + ReLU at every level
    (group_norm_vs_library). Returns {(act, dtype): entry} at P3 and
    "vs_library_by_level"."""
    from oneshotdet_tpu_torch.ops import group_norm as gn
    from oneshotdet_tpu_torch.tools import ablate_group_norm

    gen = torch.Generator().manual_seed(13)
    dev_gen = torch.Generator(device=dev).manual_seed(29)
    gamma = (1.0 + 0.1 * torch.randn(256, generator=gen)).to(dev)
    beta = (0.1 * torch.randn(256, generator=gen)).to(dev)
    results, levels = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for lvl, (h, w) in enumerate(pyramid_shapes(*QUERY_HW)):
            x = torch.randn(BATCH, h, w, 256, generator=gen).to(dev, dtype)
            for act in (None, "relu", "leaky"):
                name = f"P{lvl + 3} {tuple(x.shape)} {str(dtype)[6:]} act={act}"
                err, metric, tol = group_norm_case(gn, x, gamma, beta, 32, act, name)
                if act == "relu":
                    levels[f"P{lvl + 3} {str(dtype)[6:]}"] = group_norm_vs_library(gn, x, gamma, beta)
                if lvl != 0:
                    log(f"group_norm {name}: {metric} (tolerance {tol})")
                    continue
                ms = time_ms(lambda: gn.group_norm_act_cuda(x, gamma, beta, 32, 1e-5, act, 0.2))
                plain_ms = time_ms(lambda: gn.group_norm_act_plain(x, gamma, beta, 32, 1e-5,
                                                                   act, 0.2), warmup=1)
                lib_ms = time_ms(lambda: gn_library(x, gamma, beta, act))
                nbytes = 2 * x.numel() * x.element_size()
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                log(f"group_norm {name}: {metric} (tolerance {tol}); kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, F.group_norm{'+' + act if act else ''} {lib_ms:.4f} ms, "
                    f"bound {bound:.4f} ms (bytes: {nbytes / 1e6:.1f} MB)")
                results[(act, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             library_ms=lib_ms, bound_ms=bound, bound_by="bytes")
                if act == "relu":
                    # each launch's device time, on inputs no call has read
                    n = max(62, -(-200_000_000 // (x.numel() * x.element_size())))
                    x_all = torch.randn(n, *x.shape, generator=dev_gen, device=dev).to(dtype)
                    r = ablate_group_norm.measure(gn, x_all, gamma, beta, 20)
                    log("group_norm " + ablate_group_norm.report(name, r, card_line()))
                    results[(act, dtype)].update(per_launch_ms=r["per_launch"],
                                                 back_to_back_ms=r["b2b_ms"],
                                                 host_ms=r["host_ms"])
                    del x_all
                    torch.cuda.empty_cache()
            del x
    # input mean 100: E[x^2] ~ 1e4, so two f32 summation orders of the one-pass
    # variance differ by ~1e-3 and the outputs by ~1e-2 (the formula's
    # conditioning, shared with the JAX package)
    h, w = pyramid_shapes(*QUERY_HW)[0]
    x100 = torch.randn(BATCH, h, w, 256, generator=gen) + 100.0
    for dtype in (torch.float32, torch.bfloat16):
        x = x100.to(dev, dtype)
        k = gn.group_norm_act_cuda(x, gamma, beta)[0]
        torch.cuda.synchronize()
        p = gn.group_norm_act_plain(x, gamma, beta)[0]
        err = float((k.float() - p.float()).abs().max())
        log(f"group_norm P3 {str(dtype)[6:]} input mean 100: max abs err {err:.3e}, "
            f"{bf16_ulps(k, p):.2f} bf16 ulp (tolerance 3e-2 abs)")
        if not err <= 3e-2:
            raise AssertionError(f"group_norm at input mean 100: max abs err {err:.3e}")
    del x100, x, k, p
    group_norm_counter_checks(gn, dev, gamma, beta, gen)
    group_norm_width_checks(gn, dev, gen)
    results["vs_library_by_level"] = levels
    # backward: f32, P4, LeakyReLU
    h, w = pyramid_shapes(*QUERY_HW)[1]
    x = torch.randn(BATCH, h, w, 256, generator=gen).to(dev)
    cot = torch.randn(BATCH, h, w, 256, generator=gen).to(dev)
    grads = []
    for fn in (gn.group_norm_act, lambda *a: gn.group_norm_act_plain(*a)[0]):
        xs, gs, bs = (v.clone().requires_grad_() for v in (x, gamma, beta))
        (fn(xs, gs, bs, 32, 1e-5, "leaky", 0.2) * cot).sum().backward()
        grads.append((xs.grad, gs.grad, bs.grad))
    for name, got, want in zip(("dx", "dgamma", "dbeta"), *grads):
        if not torch.allclose(got, want, rtol=2e-3, atol=2e-4):
            raise AssertionError(f"group_norm backward {name}: max abs err "
                                 f"{float((got - want).abs().max()):.3e}")
    log(f"group_norm backward (f32, P4, leaky, kernel forward) vs autograd of the plain forward: "
        f"dx {float((grads[0][0] - grads[1][0]).abs().max()):.3e}, dgamma "
        f"{float((grads[0][1] - grads[1][1]).abs().max()):.3e} (rtol 2e-3, atol 2e-4)")
    torch.cuda.empty_cache()
    return results


def fused_group_norm_path(dev):
    """K2's own path: the FusedGroupNorm module (ReLU) over the FCOS tower's
    five bf16 levels, each an NCHW channels-last map viewed as NHWC, as a
    tower in the port's NCHW modules would call it. Returns every kernel's
    launches on this path."""
    from oneshotdet_tpu_torch.models.layers import FusedGroupNorm
    from oneshotdet_tpu_torch.ops import group_norm as gn

    gen = torch.Generator().manual_seed(17)
    module = FusedGroupNorm(256, act="relu")
    distinct_weights_(module, gen)
    module = module.to(dev)
    maps = [torch.randn(BATCH, 256, h, w, generator=gen).to(dev, torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for h, w in pyramid_shapes(*QUERY_HW)]
    reset_launches()
    with torch.inference_mode():
        outs = [module(m.permute(0, 2, 3, 1)) for m in maps]
    torch.cuda.synchronize()
    counts = read_launches()
    launches = counts["group_norm"]
    for m, y in zip(maps, outs):
        ref = gn.group_norm_act_plain(m.permute(0, 2, 3, 1), module.weight.detach(),
                                      module.bias.detach(), 32, 1e-5, "relu")[0]
        if y.shape != ref.shape or bf16_ulps(y, ref) > 1.0 or not torch.isfinite(y).all():
            raise AssertionError(f"FusedGroupNorm on {tuple(m.shape)}: differs from plain")
    if launches != len(maps):
        raise AssertionError(f"FusedGroupNorm path: {launches} group_norm launches, "
                             f"expected {len(maps)}")
    log(f"FusedGroupNorm (relu) over the five tower levels, bf16 channels-last: {launches} "
        f"group_norm launches, each within 1 bf16 ulp of the plain version")
    return counts


def roi_variant_work(feats, rois, levels, valid):
    """Each variant's operations on these inputs, from the taps its kernel
    lists (``v3_roi_taps``, ``v4_roi_taps``: the spec's non-zero weights): K4
    multiplies and adds its x taps per y tap, then its y taps; K5 its rows per
    window column, then its columns. Also K5 as the JAX kernel writes it
    (dense stage A over the level's rows, then the 64-column window)."""
    from oneshotdet_tpu_torch.ops import roi_align_v3 as v3
    from oneshotdet_tpu_torch.ops import roi_align_v4 as v4

    c = feats[0].shape[-1]
    ok = v3.live_rois(rois, levels, valid, feats[0].shape[0], len(feats)).cpu()
    (_, _, ny), (_, _, nx) = v3.v3_roi_taps(feats, rois, levels, (7, 7), SCALES_Q, 2, ok)
    k4 = 2 * c * float((ny[:, :, None] * (nx[:, None, :] + 1)).sum())
    _, (_, _, ny), (_, _, nx) = v4.v4_roi_taps(feats, rois, levels, (7, 7), SCALES_Q, 2, ok)
    k5 = 2 * c * float((nx[:, None, :] * (ny[:, :, None] + 1)).sum())
    heights = torch.tensor([f.shape[1] for f in feats])[levels.long().cpu().clamp(0, 4)]
    k5_dense = 2 * c * float((ok * (7 * heights * 64 + 7 * 64 * 7)).sum())
    return k4, k5, k5_dense


def roi_variant_launches(fn, calls=3):
    """(launches per call, {kernel: device ms per call}) by torch.profiler over
    ``calls`` calls of ``fn`` (``ablate_v4.kernel_ms``)."""
    from oneshotdet_tpu_torch.tools.ablate_v4 import kernel_ms

    rows, launches = kernel_ms(fn, [()] * calls)
    return launches, {r[0].split("(")[0].replace("void ", ""): r[3] for r in rows}


def roi_variant_checks(ra, dev):
    """Phase 3d: the cross-ROI ROIAlign kernels K4 (v3) and K5 (v4) against
    their plain versions, bit for bit (tolerance 0), in f32 and bf16: on K1's
    proposal cases (R = 16 000 and 4096 random ROIs on the batch-8 832x1216
    pyramid, 10% invalid), K1's edge cases (``edge_case_rois``), the
    predictor's 1 x 2000, the p3-skew mix at R = 16 000 on fresh inputs, and
    one small case for each vector width the kernels are built for (C = 66
    and 68); in each case the block sort on the card equals ``slab_blocks``.
    At R = 16 000 and 4096 each call must make 2 launches (the sort and the
    body, torch.profiler); K5 must clamp ROIs wider than 56 cells (differ
    from K1) and, in f32, equal K1 on ROIs up to 48 cells wide. Returns
    {(name, case, dtype): entry}."""
    from oneshotdet_tpu_torch.ops import roi_align_v3 as v3
    from oneshotdet_tpu_torch.ops import roi_align_v4 as v4
    from oneshotdet_tpu_torch.tools import time_fresh_ms
    from oneshotdet_tpu_torch.tools.tune_roialign_v3 import make_inputs

    gen = torch.Generator().manual_seed(19)
    q_shapes = pyramid_shapes(*QUERY_HW)
    variants = (("roi_align_v3", v3.multilevel_roi_align_v3_cuda,
                 v3.multilevel_roi_align_v3_plain),
                ("roi_align_v4", v4.multilevel_roi_align_v4_cuda,
                 v4.multilevel_roi_align_v4_plain))
    results = {}

    def compare(case, dtype, args):
        """Both kernels and the sort against their plain versions on args;
        returns {name: kernel output}."""
        feats, rois, levels, valid = args[0], args[1], args[2], args[6]
        b, n_levels = feats[0].shape[0], len(feats)
        if rois.shape[0]:
            ok = v3.live_rois(rois, levels, valid, b, n_levels)
            want = v3.slab_blocks(rois, levels, ok, b, n_levels, v3.ROIS_PER_BLOCK)
            got = v3.slab_sort_cuda(rois, levels, valid, b, n_levels, v3.ROIS_PER_BLOCK)
            if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])):
                raise AssertionError(f"block sort {case} differs from slab_blocks")
        outs = {}
        for name, cuda_fn, plain_fn in variants:
            k = cuda_fn(*args)
            torch.cuda.synchronize()
            p = plain_fn(*args)
            err = float((k.float() - p.float()).abs().max()) if k.numel() else 0.0
            if not (torch.equal(k, p) and torch.isfinite(k.float()).all()):
                raise AssertionError(f"{name} {case} {dtype}: max abs err {err} against the "
                                     f"plain version (tolerance 0, bit for bit)")
            outs[name] = k
            results.setdefault((name, case, dtype), {})["max_abs_err"] = err
        vec = v3.vector_elems(feats[0].shape[-1], dtype, [f.data_ptr() for f in feats])
        log(f"roi_align_v3/v4 {case} {str(dtype)[6:]}: both equal their plain versions bit for "
            f"bit (vectors of {vec} channels); block sort as slab_blocks")
        return outs

    for dtype in (torch.float32, torch.bfloat16):
        elt = torch.finfo(dtype).bits // 8
        feats = [torch.randn(BATCH, h, w, 256, generator=gen).to(dev, dtype) for h, w in q_shapes]
        for r in (16000, 4096):
            case = f"R={r}"
            rois, valid = random_rois(r, BATCH, QUERY_HW, gen, dev)
            levels = ra.fpn_level_map(rois[:, 1:], 3, 7)
            args = (feats, rois, levels, (7, 7), SCALES_Q, 2, valid)
            k1 = ra.multilevel_roi_align_cuda(*args)
            nbytes = (sum(f.numel() for f in feats) * elt + rois.numel() * 4 + levels.numel() * 4
                      + valid.numel() + k1.numel() * elt)
            k4_ops, k5_ops, k5_dense_ops = roi_variant_work(feats, rois, levels, valid)
            outs = compare(case, dtype, args)
            k = outs["roi_align_v4"]
            scale_r = torch.tensor(SCALES_Q, device=dev)[levels.long()]
            span = torch.clamp((rois[:, 3] - rois[:, 1]) * scale_r, min=1.0)
            wide, narrow = valid & (span > 56), valid & (span <= 48)
            gap_wide = float((k[wide].float() - k1[wide].float()).abs().max())
            gap_narrow = float((k[narrow].float() - k1[narrow].float()).abs().max())
            # K5 and K1 sum in other orders: in bf16, outputs near zero can
            # round apart by more than one ulp, so f32 alone
            narrow_ok = dtype == torch.bfloat16 or gap_narrow <= 1e-5
            log(f"roi_align_v4 {case} {str(dtype)[6:]}: vs K1, {int(wide.sum())} ROIs wider "
                f"than 56 cells differ by up to {gap_wide:.4f} (the window clamp), "
                f"{int(narrow.sum())} up to 48 cells by {gap_narrow:.3e}")
            if not (gap_wide > 0.1 and narrow_ok):
                raise AssertionError(f"roi_align_v4 {case}: window clamp not as expected "
                                     f"({gap_wide}, {gap_narrow})")
            del outs, k, k1
            for name, cuda_fn, plain_fn in variants:
                own_ops = k4_ops if name == "roi_align_v3" else k5_ops
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = own_ops / FP32_OPS_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                n_launch, per_launch = roi_variant_launches(lambda: cuda_fn(*args))
                if n_launch != 2:
                    raise AssertionError(f"{name} {case} {dtype}: {n_launch} launches per call "
                                         f"({per_launch}), expected 2 (sort and body)")
                ms = time_ms(lambda: cuda_fn(*args), reps=10)
                plain_ms = time_ms(lambda: plain_fn(*args), reps=3, warmup=1)
                ops_text = (f"{own_ops / 1e9:.2f} GFLOP" if name == "roi_align_v3" else
                            f"{own_ops / 1e9:.2f} GFLOP non-zero, {k5_dense_ops / 1e9:.1f} "
                            f"GFLOP dense as the TPU kernel writes it")
                launch_text = ", ".join(f"{kn} {v:.4f} ms" for kn, v in per_launch.items())
                log(f"{name} {case} {str(dtype)[6:]}: 0 error (bit for bit); kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB "
                    f"as K1; own work {ops_text}), kernel at {100 * bound / ms:.1f}% of its "
                    f"bound; {n_launch:.0f} launches per call: {launch_text}")
                results[(name, case, dtype)].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, bound_share=bound / ms,
                    gflop=own_ops / 1e9, launches_per_call=n_launch, per_launch_ms=per_launch)
                torch.cuda.empty_cache()
        rois, valid = random_rois(2000, 1, QUERY_HW, gen, dev)
        compare("predictor 1 x 2000", dtype, ([f[:1] for f in feats], rois,
                                              ra.fpn_level_map(rois[:, 1:], 3, 7), (7, 7),
                                              SCALES_Q, 2, valid))
        for case, rois, levels, valid in edge_case_rois(gen, dev):
            levels = ra.fpn_level_map(rois[:, 1:], 3, 7) if levels is None else levels
            compare(case, dtype, (feats, rois, levels, (7, 7), SCALES_Q, 2, valid))
        del feats
        torch.cuda.empty_cache()
        # the FCOS-like mix at R = 16 000, each timed call on inputs it has not seen
        warmup, iters = 1, 5
        inputs = [make_inputs(600 + i, dev, dtype=dtype, skew="p3")[:3]
                  for i in range(warmup + 1 + iters)]
        feats, rois, levels = inputs[-1]
        compare("p3-skew R=16000", dtype, (feats, rois, levels, (7, 7), SCALES_Q, 2, None))
        bound = (sum(f.numel() for f in feats) * elt + rois.numel() * 4 + levels.numel() * 4
                 + rois.shape[0] * 49 * 256 * elt) / HBM_BYTES_PER_S * 1e3
        for name, cuda_fn, _ in variants:
            ms = time_fresh_ms(lambda f, r, lv: cuda_fn(f, r, lv, (7, 7), SCALES_Q, 2), inputs,
                               warmup)
            log(f"{name} p3-skew R=16000 {str(dtype)[6:]} (fresh inputs each call, back to back): "
                f"{ms:.4f} ms, bound {bound:.4f} ms (bytes), {100 * bound / ms:.1f}% of it")
            results[(name, "p3-skew R=16000", dtype)].update(ms=ms, bound_ms=bound)
        del inputs, feats, rois, levels
        torch.cuda.empty_cache()
        # one case for each vector width: C = 66 takes 2 channels a lane, 68 takes 4
        for c in (66, 68):
            f2 = [torch.randn(2, h, w, c, generator=gen).to(dev, dtype) for h, w in q_shapes]
            rois, valid = random_rois(500, 2, QUERY_HW, gen, dev)
            compare(f"C={c} R=500", dtype, (f2, rois, ra.fpn_level_map(rois[:, 1:], 3, 7),
                                            (7, 7), SCALES_Q, 2, valid))
    return results


def tool_runs():
    """Phase 3f: the port's card tools at reduced counts, each with every
    kernel's launch count set to 0 just before and read just after.
    Returns {tool: {kernel: launches}}."""
    from oneshotdet_tpu_torch.tools import (ablate_group_norm, ablate_roi_head, ablate_v4,
                                            accuracy_roi_head, tune_roi_head, tune_roialign_v3)

    runs = (("tune_roialign_v3", tune_roialign_v3, ["--iters", "2", "--warmup", "1",
                                                     "--blocks", "16"]),
            ("ablate_v4", ablate_v4, ["--reps", "2", "--rois", "4096", "--dtypes", "bfloat16",
                                      "--mixes", "p3-skew", "--variants"]),
            ("tune_roi_head", tune_roi_head, ["--iters", "2", "--warmup", "1"]),
            ("ablate_roi_head", ablate_roi_head, ["--dtype", "float32", "--rois", "16000",
                                                  "--rounds", "1", "--reps", "3"]),
            ("accuracy_roi_head", accuracy_roi_head, ["--rois", "4096"]),
            ("ablate_group_norm", ablate_group_norm, ["--reps", "10"]))
    launches = {}
    for name, tool, argv in runs:
        reset_launches()
        t0 = time.perf_counter()
        rc = tool.main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"tool {name} exited {rc}")
        launches[name] = read_launches()
        log(f"tool {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
        torch.cuda.empty_cache()
    return launches


def _counters():
    from oneshotdet_tpu_torch.ops import group_norm, roi_align, roi_align_v3, roi_align_v4
    from oneshotdet_tpu_torch.ops import roi_head_fused

    from oneshotdet_tpu_torch.ops import resize

    return {"roi_align": (roi_align, "roi_align_launches"),
            "roi_align_bwd": (roi_align, "roi_align_bwd_launches"),
            "roi_head": (roi_head_fused, "fused_roi_head_launches"),
            "group_norm": (group_norm, "group_norm_launches"),
            "roi_align_v3": (roi_align_v3, "roi_align_v3_launches"),
            "roi_align_v4": (roi_align_v4, "roi_align_v4_launches"),
            "resize_normalize_pad": (resize, "resize_launches")}


def reset_launches():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_launches():
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


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


def _best_partners(a, b, score_rtol, box_rtol):
    """For each detection of a (boxes, scores), whether its highest-IoU
    detection in b has IoU > 0.99 (any IoU where a's box is under a pixel
    wide or high: there a 1e-4 px shift costs a few percent) and score and
    coordinates within tolerance; and that partner's index and IoU."""
    (ab, as_), (bb, bs) = a, b
    if len(ab) == 0 or len(bb) == 0:
        return np.zeros(len(ab), bool), np.zeros(len(ab), int), np.zeros(len(ab))
    lt = np.maximum(ab[:, None, :2], bb[None, :, :2])
    rb = np.minimum(ab[:, None, 2:], bb[None, :, 2:])
    inter = np.prod(np.clip(rb - lt + 1, 0, None), axis=2)
    area = lambda x: (x[..., 2] - x[..., 0] + 1) * (x[..., 3] - x[..., 1] + 1)
    union = area(ab)[:, None] + area(bb)[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = inter / union
    zero = ~(union > 0)
    if zero.any():
        # a box of zero area (x2 = x1 - 1, which decoding a shrunk anchor
        # gives) pairs with the boxes at its coordinates: its IoU is 0 / 0
        rows = np.nonzero(zero.any(axis=1))[0]
        close = np.all(np.abs(bb[None] - ab[rows, None])
                       <= box_rtol * np.abs(ab[rows, None]) + 1e-3, axis=2)
        iou[rows] = np.where(zero[rows], close, iou[rows])
    j = np.argmax(iou, axis=1)
    best = iou[np.arange(len(ab)), j]
    thin = np.minimum(ab[:, 2] - ab[:, 0], ab[:, 3] - ab[:, 1]) + 1 < 1
    ok = (((best > 0.99) | thin) & (np.abs(bs[j] - as_) <= score_rtol * np.abs(as_) + 1e-5)
          & np.all(np.abs(bb[j] - ab) <= box_rtol * np.abs(ab) + 1e-3, axis=1))
    return ok, j, best


def match_detections(a, b, score_rtol=5e-4, box_rtol=1e-3):
    """Valid detections of a and b (one image each, numpy) agree as sets:
    equal counts, and each box of a has a box of b with IoU > 0.99 whose
    score and coordinates match within tolerance."""
    (ab, as_), (bb, bs) = a, b
    if len(ab) != len(bb):
        raise AssertionError(f"{len(ab)} vs {len(bb)} detections")
    ok, j, best = _best_partners(a, b, score_rtol, box_rtol)
    if not ok.all():
        i = int(np.argmin(ok))
        raise AssertionError(f"detection {ab[i]} {as_[i]} unmatched "
                             f"(best {bb[j[i]]} {bs[j[i]]}, IoU {best[i]:.4f})")


def match_fraction(a, b, score_rtol=5e-4, box_rtol=1e-3):
    """Share of the detections of a and b (one image each) that pair up as
    in ``match_detections``, over the larger of the two counts."""
    n = max(len(a[0]), len(b[0]))
    return 1.0 if n == 0 else float(_best_partners(a, b, score_rtol, box_rtol)[0].sum()) / n


def small_forward_check(cfg_path, dev, fused=False, opts=(), aug=0, label="", prepare=None):
    """A float32 forward (batch 2, 128x160 queries, 64x64 supports) on the
    card (the kernels) and on the CPU (the plain versions that the tier-1
    tests hold against the JAX package) with the same weights and inputs;
    with ``fused``, both with the fused relation head; ``opts`` more cfg
    overrides, ``aug`` each support followed by that many variants
    (``aug_supports``), ``prepare`` a function applied to the CPU model's
    weights after they are drawn."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import roi_head_fused as rf
    from oneshotdet_tpu_torch.structures import ImageBatch

    cfg = default_cfg.clone()
    cfg.merge_from_file(cfg_path)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_PRE_TOPK", 1024,
                         "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 128,
                         "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 64, *opts])
    gen = torch.Generator().manual_seed(11)
    q = torch.randn(2, 128, 160, 3, generator=gen) * 50
    s = torch.randn(2, 64, 64, 3, generator=gen) * 50
    qs = torch.tensor([[128.0, 160.0], [100.0, 150.0]])
    ss = torch.tensor([[64.0, 64.0], [60.0, 40.0]])
    if aug:
        s, ss = (torch.from_numpy(x) for x in aug_supports(s.numpy(), ss.numpy(), aug))
    cpu = build_detection_model(cfg, device="cpu")
    distinct_weights_(cpu, torch.Generator().manual_seed(12))
    if prepare is not None:
        prepare(cpu)
    gpu = build_detection_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    for m in (cpu, gpu):
        m.config = dataclasses.replace(m.config, fused_roi_head=fused)
    ref = cpu(ImageBatch(q, qs), ImageBatch(s, ss))
    rf.fused_roi_head_launches = 0
    out = gpu(ImageBatch(q.to(dev), qs.to(dev)), ImageBatch(s.to(dev), ss.to(dev)))
    if rf.fused_roi_head_launches != int(fused):
        raise AssertionError(f"small forward: {rf.fused_roi_head_launches} roi_head launches")
    n = 0
    for i in range(2):
        def valid_dets(d):
            v = d.valid[i].cpu().numpy()
            return (d.xyxy[i].cpu().numpy()[v], d.get_field("scores")[i].cpu().numpy()[v])
        match_detections(valid_dets(out), valid_dets(ref))
        n += int(out.valid[i].sum())
    log(f"small float32 forward{', fused head' if fused else ''}{label}: {n} detections on "
        f"the card match the CPU plain path (score rtol 5e-4, box rtol 1e-3, TF32 off)")
    return n


STAGES = ("query_backbone", "support_backbone", "support_pool", "fcos_head",
          "fcos_postprocess", "roi_pool", "roi_head", "roi_postprocess", "mask_head",
          "keypoint_head", "rpn_head", "rpn_postprocess", "retinanet_head",
          "retinanet_postprocess")


def profile_forward(model, images, supps, label):
    """One eval forward under torch.profiler: device time of each stage range
    of the detector, the device's busy share of the forward's wall time, and
    the kernels that take the most device time. Returns {stage: device span
    ms}."""
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
        return {}
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
    return spans


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


def head_device_ms(model, images, supps):
    """Device time of one forward's relation head: CUDA events recorded on
    the stream just before and after the head's call, so the time runs from
    the head's first kernel to its last (gaps included) however far the host
    runs ahead of the card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    inner = model._roi_head_multi_shot

    def timed(*args):
        start.record()
        out = inner(*args)
        end.record()
        return out

    model._roi_head_multi_shot = timed
    try:
        model(images, supps)
    finally:
        del model._roi_head_multi_shot
    end.synchronize()
    return start.elapsed_time(end)


def f32_forward_checks(cfg_path, dev, images, supps, card, iters=2):
    """Phase 5b: the flagship at full width in float32 (TPU.COMPUTE_DTYPE
    float32, TF32 off; batch 8, 832x1216 queries, 416x416 supports, 2000
    proposals per image, so R = 16 000), with the unfused head and with K3's
    float32 route: 0 and 1 K3 launch per forward, ms/batch, peak memory, one
    profiled forward's stage spans, the head's device time by CUDA events
    (``head_device_ms``), and the share of the fused run's
    detections that pair up with the unfused run's (score rtol 5e-4, box rtol
    1e-3; at least F32_MIN_MATCH). Returns ({cell: K3 launches}, {cell:
    launches of every kernel}, {cell: entry})."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import roi_head_fused as rf

    c = default_cfg.clone()
    c.merge_from_file(cfg_path)
    c.merge_from_list(["TPU.COMPUTE_DTYPE", "float32"])
    model = build_detection_model(c, device=dev, generator=torch.Generator().manual_seed(1))
    head_launches, paths, results, dets = {}, {}, {}, {}
    for fused in (False, True):
        cell = "full 2000/img f32, fused head" if fused else "full 2000/img f32"
        model.config = dataclasses.replace(model.config, fused_roi_head=fused)
        model(images, supps)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model(images, supps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        paths[f"{cell}, {iters} forwards"] = read_launches()
        head_launches[cell] = rf.fused_roi_head_launches
        if rf.fused_roi_head_launches != (iters if fused else 0):
            raise AssertionError(f"{cell}: {rf.fused_roi_head_launches} roi_head launches in "
                                 f"{iters} forwards")
        peak = torch.cuda.max_memory_allocated() / 2**30
        capacity = min(c.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                       c.TPU.EVAL_ROI_TOPK or c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST)
        check_detections(out, BATCH, capacity, images.sizes_wh())
        dets[fused] = [(out.xyxy[i].float().cpu().numpy()[v], out.get_field("scores")[i].float()
                        .cpu().numpy()[v]) for i, v in enumerate(out.valid.cpu().numpy())]
        log(f"eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} float32, "
            f"{dt * 1e3:.1f} ms/batch, {BATCH / dt:.1f} img/s, peak memory {peak:.2f} GiB, "
            f"{int(out.valid.sum())} detections [{card}]")
        spans = profile_forward(model, images, supps, cell)
        head_ms = head_device_ms(model, images, supps)
        log(f"  relation head {'(K3) ' if fused else '(layers) '}by CUDA events around its call: "
            f"{head_ms:.2f} ms [{card}]")
        results[cell] = dict(ms_per_batch=dt * 1e3, peak_gib=peak,
                             roi_head_span_ms=spans.get("roi_head"), roi_head_event_ms=head_ms)
        del out
    counts = [max(len(a[0]), len(b[0])) for a, b in zip(dets[True], dets[False])]
    shares = [match_fraction(a, b) for a, b in zip(dets[True], dets[False])]
    share = sum(f * n for f, n in zip(shares, counts)) / max(1, sum(counts))
    log(f"float32 forward, fused head vs unfused: {100 * share:.2f}% of {sum(counts)} detections "
        f"pair up (per image min {100 * min(shares):.2f}%; score rtol 5e-4, box rtol 1e-3; "
        f"required >= {100 * F32_MIN_MATCH:.0f}%)")
    if share < F32_MIN_MATCH:
        raise AssertionError(f"float32 forward: only {share:.4f} of the fused head's detections "
                             f"match the unfused head's")
    results["full 2000/img f32, fused head"]["match_fraction"] = share
    del model
    torch.cuda.empty_cache()
    return head_launches, paths, results


class SyntheticEpisodes:
    """An episodic eval dataset as ``inference`` takes it (duck-typed):
    ``coco``, ``id_to_img_map``, ``get_img_info`` and ``len``, over a COCO
    annotation file written to ``root``: one image per episode, sized as the
    episode's query, with two ground-truth boxes of the episode's class."""

    def __init__(self, root, sizes_hw, cats):
        from oneshotdet_tpu_torch.data import LiteCOCO

        rng = np.random.RandomState(31)
        images, anns = [], []
        for i, ((h, w), cat) in enumerate(zip(sizes_hw, cats)):
            images.append({"id": 100 + i, "file_name": f"{i:06d}.jpg", "width": int(w),
                           "height": int(h)})
            for k in range(2):
                bw, bh = rng.uniform(40, w / 2), rng.uniform(40, h / 2)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({"id": 2 * i + k + 1, "image_id": 100 + i, "category_id": int(cat),
                             "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0})
        path = os.path.join(root, "instances.json")
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": f"class{c}"} for c in sorted(set(cats))]},
                      f)
        self.coco = LiteCOCO(path)
        self.id_to_img_map = {i: 100 + i for i in range(len(images))}
        self._cats = [int(c) for c in cats]

    def __len__(self):
        return len(self._cats)

    def get_img_info(self, index):
        return self.coco.imgs[self.id_to_img_map[index]], self._cats[index]


def engine_checks(cfg, model, card, n_batches=3, classes=4):
    """Phase 6: the eval engine at full width (batch 8, 832x1216 bf16, fused
    head): compute_on_dataset per batch and with cached supports, the
    multi-class step against the single-class step, and inference() with
    the COCO evaluator. Class c's support is one fixed image, so cached and
    per-batch supports are the same pixels. Returns the K3 launches."""
    from oneshotdet_tpu_torch import engine
    from oneshotdet_tpu_torch.ops import roi_head_fused as rf

    rng = np.random.RandomState(41)
    q_sizes = np.array([[832, 1216], [800, 1200], [832, 1100], [704, 1216],
                        [832, 1216], [768, 1024], [832, 1184], [640, 960]], np.float32)
    supp_px = (rng.randn(classes, *SUPP_HW, 3) * 50).astype(np.float32)
    supp_hw = np.array([[416, 416], [300, 400], [400, 300], [416, 320]], np.float32)
    batches = []
    for it in range(n_batches):
        tids = (np.arange(BATCH) + it) % classes + 1
        batches.append({
            "query_pixels": (rng.randn(BATCH, *QUERY_HW, 3) * 50).astype(np.float32),
            "query_sizes": q_sizes,
            "supp_pixels": supp_px[tids - 1],
            "supp_sizes": supp_hw[tids - 1],
            "target_ids": tids.astype(np.int32),
            "img_ids": np.arange(BATCH) + BATCH * it,
            "idxs": np.arange(BATCH) + BATCH * it,
        })
    n_img = n_batches * BATCH
    rf.fused_roi_head_launches = 0
    engine.compute_on_dataset(model, batches[:1])                 # warm-up
    runs = {}
    for cached in (False, True):
        t0 = time.perf_counter()
        runs[cached] = engine.compute_on_dataset(model, batches, cache_supports=cached)
        dt = time.perf_counter() - t0
        log(f"engine compute_on_dataset cache_supports={cached}: {n_img} images in "
            f"{dt:.3f} s, {n_img / dt:.1f} img/s (host clock, numpy batches in) [{card}]")
    # Cached supports are computed at batch 1, per-batch ones at batch 8:
    # cuDNN picks its convolution kernels by shape, so the bf16 support
    # features differ in the last bits, which moves near-tied scores across
    # NMS decisions. The check is the share of each episode's detections
    # that pair up at the detection tolerances, held against a control: the
    # same episodes with every support moved to the next class.
    control = engine.compute_on_dataset(model, [dict(b, supp_pixels=np.roll(b["supp_pixels"], 1, 0))
                                                for b in batches])
    share, share_control, n = [], [], 0
    for idx, ref in runs[False].items():
        got = runs[True][idx]
        if got["input_size"] != ref["input_size"]:
            raise AssertionError(f"engine episode {idx}: input_size differs")
        share.append(match_fraction((got["boxes"], got["scores"]), (ref["boxes"], ref["scores"])))
        share_control.append(match_fraction((control[idx]["boxes"], control[idx]["scores"]),
                                            (ref["boxes"], ref["scores"])))
        n += len(ref["scores"])
    log(f"engine: cached-support vs per-batch detections ({n}): per episode, "
        f"{100 * min(share):.2f}% (min) / {100 * np.mean(share):.2f}% (mean) pair up at "
        f"score rtol 5e-4, box rtol 1e-3; control (another class's support) "
        f"{100 * max(share_control):.2f}% (max) / {100 * np.mean(share_control):.2f}% (mean)")
    if not (min(share) >= ENGINE_MIN_SHARE and max(share_control) < ENGINE_MIN_SHARE):
        raise AssertionError(f"engine: cached supports disagree with per-batch ones "
                             f"(min share {min(share):.4f}, control {max(share_control):.4f}, "
                             f"required >= {ENGINE_MIN_SHARE} and below it)")

    # multi-class: S = classes cached class-level supports off one query pass
    support_step, query_step = engine.make_cached_support_eval_steps(model)
    feats = [support_step(supp_px[k:k + 1], supp_hw[k:k + 1]) for k in range(classes)]
    pooled = [torch.stack([f[0][lvl] for f in feats]) for lvl in range(len(feats[0][0]))]
    s7 = torch.stack([f[1] for f in feats])
    tids = np.arange(1, classes + 1, dtype=np.int32)
    step = engine.make_multiclass_eval_step(model)
    step(batches[0], pooled, s7, tids)                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(batches[1], pooled, s7, tids)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"engine multi-class step: {classes} classes x {BATCH} images in {dt * 1e3:.1f} ms, "
        f"{classes * BATCH / dt:.1f} episodes/s [{card}]")
    share = []
    for k in range(classes):
        single = query_step(dict(batches[1], target_ids=np.full(BATCH, k + 1, np.int32)),
                            [p[k] for p in pooled], s7[k])
        for i in range(BATCH):
            v, sv = out[3][k, i].cpu().numpy(), single[3][i].cpu().numpy()
            share.append(match_fraction((out[0][k, i].float().cpu().numpy()[v],
                                         out[1][k, i].float().cpu().numpy()[v]),
                                        (single[0][i].float().cpu().numpy()[sv],
                                         single[1][i].float().cpu().numpy()[sv])))
            if not (out[2][k, i][v] == k + 1).all():
                raise AssertionError("multi-class step: labels are not the class ids")
    log(f"engine: multi-class slices vs the single-class step: per (class, image) "
        f"{100 * min(share):.2f}% (min) / {100 * np.mean(share):.2f}% (mean) of the "
        f"detections pair up (score rtol 5e-4, box rtol 1e-3)")
    if min(share) < ENGINE_MIN_SHARE:
        raise AssertionError(f"multi-class step: a class slice disagrees with the "
                             f"single-class step (share {min(share):.4f})")

    with tempfile.TemporaryDirectory() as root:
        ds = SyntheticEpisodes(root, [q_sizes[i % BATCH] for i in range(n_img)],
                               [int(b["target_ids"][i]) for b in batches for i in range(BATCH)])
        t0 = time.perf_counter()
        res = engine.inference(cfg, model, batches, ds, output_folder=os.path.join(root, "out"))
        dt = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"inference: non-finite metrics {res}")
    log(f"engine inference(): {n_img} episodes in {dt:.3f} s with evaluation, "
        f"AP {res['AP']:.4f} AP50 {res['AP50']:.4f} (random weights) [{card}]")
    return rf.fused_roi_head_launches


# the forward's stage ranges; the backward runs on autograd's own thread,
# which a range on this thread does not see
TRAIN_STAGES = STAGES[:7]


def profile_train_step(step, label, stages=TRAIN_STAGES):
    """One train step under torch.profiler: wall and device busy time, the
    device span of each stage range of the forward (``stages``), and the
    kernels that take the most device time, K1 and K1b summed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in stages]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    if busy_ms == 0:
        log(f"profile {label}: torch.profiler recorded no device time")
        return {}
    per_kernel = {}
    for e in device:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    k1 = sum(ms for n, ms in per_kernel.items() if "roi_align_kernel" in n)
    k1b = sum(ms for n, ms in per_kernel.items() if "roi_align_bwd_" in n)
    log(f"profile {label}: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%; K1 "
        f"kernels {k1:.3f} ms, K1b kernels {k1b:.3f} ms ({100 * k1b / busy_ms:.2f}% of busy)")
    spans = {e.name: e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name in stages}
    for name in stages:
        if name in spans:
            log(f"  stage {name:<17} device span {spans[name]:8.2f} ms "
                f"({100 * spans[name] / wall_ms:5.1f}% of wall)")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  kernel {ms:8.2f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, k1_ms=k1, k1b_ms=k1b, spans=spans)


def train_path(cfg_path, dev, card):
    """Phase 7: the flagship's one-shot train step at full width (bf16,
    batch 8, 832x1216 queries, 416x416 supports, MAX_GT_BOXES 64, random
    weights from seed 1, a fresh synthetic episode batch per step from the
    port's make_episodic_batch) through the entry points: build the model,
    model.train(), the optimizer and scheduler from the cfg, TRAIN_WARMUP
    steps through do_train, then TRAIN_STEPS timed steps through
    train_step. Asserts finite losses, a finite gradient for every trainable
    parameter after step 1 and a non-zero one for the support backbone's
    layer2-4 (reached only through K1b) and the FCOS towers, 7 K1 and 7 K1b
    launches per step, and bit-identical frozen parameters. Then logs a
    TRAIN_TRAJECTORY-step loss trajectory on one repeated batch. Returns
    (launches per path, entry)."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.engine import do_train, train_step
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import roi_align as ra
    from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from oneshotdet_tpu_torch.utils import MetricLogger
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    cfg = default_cfg.clone()
    cfg.merge_from_file(cfg_path)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    t0 = time.perf_counter()
    batches = [make_episodic_batch(BATCH, QUERY_HW, SUPP_HW, max_gt=cfg.TPU.MAX_GT_BOXES,
                                   seed=100 + i) for i in range(steps)]
    log(f"train: {steps} synthetic episode batches made in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")
    model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    model.train()
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_scheduler(cfg, optimizer)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    gen = torch.Generator(device=dev).manual_seed(7)
    meters = MetricLogger()
    reset_launches()
    do_train(cfg, model, optimizer, scheduler, batches[:1], meters=meters, log_period=1,
             generator=gen)
    torch.cuda.synchronize()
    bad = [n for n, p in trainable.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise AssertionError(f"train step 1: no or non-finite gradient for {bad[:5]} "
                             f"({len(bad)} parameters)")

    def grad_norm(prefixes):
        return math.sqrt(sum(float(p.grad.float().norm()) ** 2 for n, p in trainable.items()
                             if n.startswith(prefixes)))

    norms = {label: grad_norm(prefixes) for label, prefixes in (
        ("support backbone layer2-4", tuple(f"supp_backbone.body.layer{i}." for i in (2, 3, 4))),
        ("support FPN", ("supp_backbone.fpn.",)),
        ("query backbone layer2-4", tuple(f"backbone.body.layer{i}." for i in (2, 3, 4))),
        ("FCOS towers", ("rpn.head.cls_tower.", "rpn.head.bbox_tower.")),
        ("relation head", ("roi_heads.",)))}
    log("train step 1 gradient norms: " + ", ".join(f"{k} {v:.4e}" for k, v in norms.items()))
    for label in ("support backbone layer2-4", "FCOS towers"):
        if not norms[label] > 0:
            raise AssertionError(f"train step 1: zero gradient for the {label}")
    log(f"train step 1: every one of {len(trainable)} trainable parameters has a finite "
        f"gradient; {len(frozen)} frozen (stem and layer1 of both backbones)")
    do_train(cfg, model, optimizer, scheduler, batches[1:TRAIN_WARMUP], meters=meters,
             log_period=1, generator=gen, start_iter=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    metrics = []
    t0 = time.perf_counter()
    for (start, end), batch in zip(events, batches[TRAIN_WARMUP:]):
        start.record()
        metrics.append(train_step(model, optimizer, scheduler, batch, gen))
        end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    launches = read_launches()
    if launches["roi_align"] != 7 * steps or launches["roi_align_bwd"] != 7 * steps:
        raise AssertionError(f"train: {launches['roi_align']} K1 and {launches['roi_align_bwd']} "
                             f"K1b launches in {steps} steps, expected {7 * steps} each")
    peak = torch.cuda.max_memory_allocated()
    history = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(history):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {TRAIN_WARMUP + i + 1}: non-finite losses {m}")
        log(f"train step {TRAIN_WARMUP + i + 1}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
    for n, p in model.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            raise AssertionError(f"train: frozen parameter {n} changed")
    log(f"train warm-up losses (do_train, MetricLogger): {meters}")
    log(f"train step, flagship bf16, batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]}, supports "
        f"{SUPP_HW[0]}x{SUPP_HW[1]}: {wall * 1e3:.1f} ms/step by the host clock over "
        f"{TRAIN_STEPS} steps ({BATCH / wall:.1f} img/s), CUDA events per step median "
        f"{step_ms[len(step_ms) // 2]:.1f} ms (min {step_ms[0]:.1f}, max {step_ms[-1]:.1f}); "
        f"peak memory {peak / 2**30:.2f} GiB; {launches['roi_align'] // steps} K1 and "
        f"{launches['roi_align_bwd'] // steps} K1b launches per step; {len(frozen)} frozen "
        f"parameters bit-identical [{card}]")
    prof = profile_train_step(lambda: train_step(model, optimizer, scheduler, batches[-1], gen),
                              "train step")
    # the loss on one repeated batch (logged, not asserted)
    traj = []
    for _ in range(TRAIN_TRAJECTORY):
        traj.append(train_step(model, optimizer, scheduler, batches[0], gen)["loss_total"])
    log(f"train: loss_total over {TRAIN_TRAJECTORY} steps on one repeated batch: "
        + " ".join(f"{float(v):.4f}" for v in traj))
    entry = dict(ms_per_step=wall * 1e3, img_per_s=BATCH / wall,
                 event_ms_median=step_ms[len(step_ms) // 2], peak_gib=peak / 2**30,
                 losses=history, profile=prof)
    del model, optimizer, scheduler, batches
    torch.cuda.empty_cache()
    return launches, entry


def small_train_check(cfg_path, dev):
    """A float32 train step at the tier-1 tests' SMALL capacities (batch 2,
    128x160 queries, 64x64 supports) on the card (K1, K1b) and on the CPU
    (the plain versions the tests hold against JAX): the same weights,
    batch and sampling draws, TF32 off. Run twice on the card. With cuDNN
    off (PyTorch's own CUDA convolutions) the losses must pair up within
    rtol 1e-4 and each parameter's gradient within 1e-3 relative norm. With
    cuDNN's default float32 convolution algorithms the same holds for the
    losses and for the support backbone, whose gradient passes only through
    K1b; the worst parameter is logged: cuDNN's algorithms for the query's
    shapes move the query backbone's gradients by ~2e-3 relative norm on
    their own."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.engine import batch_to_inputs
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    cfg = default_cfg.clone()
    cfg.merge_from_file(cfg_path)
    cfg.merge_from_list(SMALL)
    batch = make_episodic_batch(2, (128, 160), (64, 64), max_gt=4, seed=21)
    cpu = build_detection_model(cfg, device="cpu")
    distinct_weights_(cpu, torch.Generator().manual_seed(22))
    n = cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + cfg.TPU.MAX_GT_BOXES
    draws = torch.rand((2, n), generator=torch.Generator().manual_seed(23))

    def step(model, d):
        model.train()
        losses = model.forward_train(*batch_to_inputs(batch, d), draws=draws.to(d))
        sum(losses.values()).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n_: p.grad.detach().cpu() for n_, p in model.named_parameters()
                 if p.grad is not None})

    lc, gc = step(cpu, "cpu")
    result = {}
    for label, cudnn in (("cuDNN default", True), ("cuDNN off", False)):
        gpu = build_detection_model(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        torch.backends.cudnn.enabled = cudnn
        try:
            lg, gg = step(gpu, dev)
        finally:
            torch.backends.cudnn.enabled = True
        del gpu
        if gc.keys() != gg.keys():
            raise AssertionError("small train step: card and CPU differ in which parameters "
                                 "have gradients")
        loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
        rel = sorted(((float((gg[k] - g).norm() / g.norm().clamp(min=1e-30)), k)
                      for k, g in gc.items()), reverse=True)
        supp = [r for r in rel if r[1].startswith("supp_backbone.")][0]
        log(f"small float32 train step, card ({label}) against CPU, TF32 off: losses within "
            f"{loss_rel:.2e} relative, worst gradient {rel[0][0]:.2e} relative norm "
            f"({rel[0][1]}), worst of the support backbone {supp[0]:.2e} ({supp[1]})")
        result[label] = dict(loss_rel=loss_rel, grad_rel=rel[0][0], grad_worst=rel[0][1],
                             supp_backbone_rel=supp[0])
    for label, key in (("cuDNN off", "grad_rel"), ("cuDNN default", "supp_backbone_rel")):
        r = result[label]
        if r["loss_rel"] > 1e-4 or r[key] > 1e-3:
            raise AssertionError(f"small train step, {label}: losses {r['loss_rel']:.2e} "
                                 f"(rtol 1e-4), gradients {r[key]:.2e} (bound 1e-3)")
    return result

def h1_compare(resize, packed, slots, label):
    """H1's one launch for ``packed`` into ``slots`` against its plain
    version on the card, bit for bit (tolerance 0)."""
    got = resize.resize_normalize_pad_slots_cuda(packed, slots)
    want = resize.resize_normalize_pad_slots_plain(packed, slots)
    torch.cuda.synchronize()
    differ = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                 for g, w in zip(got, want))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    log(f"H1 {label}: {len(packed)} images into {[s.pad_hw for s in slots]}, one launch, "
        f"{differ} values differ from the plain version (max abs err {err})")
    if differ:
        raise AssertionError(f"H1 {label}: {differ} values differ from the plain version")
    return err


def h1_steepest(resize, limit, shape):
    """The largest n for which the wrapper's plan accepts the downscale
    ``shape(n)`` = (h0, w0, oh, ow) at the card's shared-memory ``limit``."""
    lo, hi = 2, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            resize.launch_plan([shape(mid)], limit)
            lo = mid
        except ValueError:
            hi = mid
    return lo


def h1_parity(resize, items, query_bucket, supp_bucket, dev):
    """H1 bit for bit against its plain version: the first batch's queries
    and supports in one launch (and each alone), the edge cases of
    ``ablate_resize.EDGES`` and: a strip partly in the padding, a target
    width that is not a multiple of the strip, slots whose width is not a
    multiple of 4 (4-byte stores), two outputs with different
    normalizations, and the steepest vertical and horizontal downscales the
    wrapper accepts. Returns the largest abs error (0)."""
    from oneshotdet_tpu_torch.tools import ablate_resize

    first = items[0]["img"]
    norm = (first["mean"], first["std"], first["to_bgr255"])
    queries = [it["img"] for it in items]
    supports = [s for it in items for s in it["img_supp"]]
    both = resize.pack_images([x["u8"] for x in queries + supports],
                              [x["out_hw"] for x in queries + supports], dev,
                              outputs=[0] * len(queries) + [1] * len(supports))
    slots = (resize.slot(query_bucket, *norm), resize.slot(supp_bucket, *norm))
    err = h1_compare(resize, both, slots, "first batch's queries and supports")
    for label, xs, bucket in (("queries", queries, query_bucket),
                              ("supports", supports, supp_bucket)):
        alone = resize.pack_images([x["u8"] for x in xs], [x["out_hw"] for x in xs], dev)
        err = max(err, h1_compare(resize, alone, (resize.slot(bucket, *norm),),
                                  f"first batch's {label} alone"))
    images, targets = ablate_resize.edge_sources()
    err = max(err, h1_compare(resize, resize.pack_images(images, targets, dev),
                              (resize.slot(QUERY_HW, *norm),),
                              "edge cases (down, up, 1-pixel wide, 1 pixel)"))
    rng = np.random.RandomState(9)
    src = lambda h, w: rng.randint(0, 256, (h, w, 3)).astype(np.uint8)  # noqa: E731
    rgb = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225], False)
    limit = resize._kernel().oneshot_resize_init()
    steep_h = h1_steepest(resize, limit, lambda n: (n, 40, 1, 20))
    steep_w = h1_steepest(resize, limit, lambda n: (8, n, 4, 1))
    cases = [
        ("strip partly padding, width not a multiple of the strip",
         [src(123, 77), src(50, 70)], [(300, 100), (130, 181)], [(320, 224)], [norm]),
        ("slots of width 17 and 53 (4-byte stores)",
         [src(13, 17), src(20, 30)], [(13, 17), (35, 51)], [(13, 17), (37, 53)], [norm, rgb]),
        ("two outputs, BGR255 and RGB/255 with std",
         [src(375, 500), src(500, 375), src(120, 300), src(300, 120)],
         [(800, 1066), (1066, 800), (160, 400), (400, 160)], [(1216, 1216), SUPP_HW],
         [norm, rgb]),
        (f"steepest vertical downscale the wrapper accepts ({steep_h}x40 -> 1x20)",
         [src(steep_h, 40)], [(1, 20)], [(32, 32)], [norm]),
        (f"steepest horizontal downscale the wrapper accepts (8x{steep_w} -> 4x1)",
         [src(8, steep_w)], [(4, 1)], [(32, 32)], [norm]),
    ]
    for label, images, targets, buckets, norms in cases:
        outputs = [0] * len(images) if len(buckets) == 1 else \
            [i * len(buckets) // len(images) for i in range(len(images))]
        packed = resize.pack_images(images, targets, dev, outputs=outputs)
        err = max(err, h1_compare(resize, packed, tuple(resize.slot(b, *n) for b, n in
                                                        zip(buckets, norms)), label))
    for bgr, mean, std in ((True, norm[0], norm[1]), (False, *rgb[:2])):
        exact = resize.pack_images([src(*SUPP_HW)], [SUPP_HW], dev)
        err = max(err, h1_compare(resize, exact, (resize.slot(SUPP_HW, mean, std, bgr),),
                                  f"source of the slot's size, to_bgr255={bgr}"))
    return err


def h1_checks(resize, items, query_bucket, supp_bucket, dev, card):
    """Phase 8: H1 bit for bit (``h1_parity``); the device time of its
    launches (torch.profiler) and the wrapper's host time apart, CUDA events
    around one call, beside the bound, for the first batch's queries and
    supports alone and for the batch's one launch; the plain version and
    8 x F.interpolate on the queries and supports."""
    from oneshotdet_tpu_torch.tools import ablate_resize

    out = {"max_abs_err": h1_parity(resize, items, query_bucket, supp_bucket, dev)}
    cases = ablate_resize.inputs(items, query_bucket, supp_bucket)
    fns = ablate_resize.calls(resize, cases, dev)
    for label in ("queries", "supports", "batch"):
        fn, _, bound_ms = fns[label]
        r = ablate_resize.measure(fn, reps=10)
        out[label] = dict(r, bound_ms=bound_ms,
                          bound_share=bound_ms / (r["device_ms"] or r["b2b_ms"]))
        log(ablate_resize.report(f"H1 {label}", r, bound_ms, card))
        if label == "batch":
            continue
        images, targets, bucket = cases[label]
        packed = resize.pack_images(images, targets, dev)
        plain_ms = time_ms(lambda: resize.resize_normalize_pad_plain(
            packed, bucket, *cases["norm"]), reps=3, warmup=1)
        floats = [torch.from_numpy(im).to(dev).permute(2, 0, 1)[None].float() for im in images]
        library_ms = time_ms(lambda: [torch.nn.functional.interpolate(
            f, size=hw, mode="bilinear", align_corners=False, antialias=True)
            for f, hw in zip(floats, targets)])
        out[label].update(plain_ms=plain_ms, library_ms=library_ms)
        log(f"H1 {label}: plain {plain_ms:.3f} ms, {len(floats)} x F.interpolate(bilinear, "
            f"antialias) {library_ms:.4f} ms (CUDA events, median) [{card}]")
    return out


class _LogCollector(logging.Handler):
    """Keeps the CLI logger's messages for the checks."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _cli_logger(prefix="test_net"):
    """The port's CLI logger, set up before the CLI sets up its own: messages
    kept for the checks, and printed except the config dump."""
    logger = logging.getLogger("oneshotdet_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    collector = _LogCollector()
    printer = logging.StreamHandler(sys.stdout)
    printer.addFilter(lambda r: not r.getMessage().startswith("config:"))
    printer.setFormatter(logging.Formatter(f"{prefix}: %(message)s"))
    for h in list(logger.handlers):
        logger.removeHandler(h)
    logger.addHandler(collector)
    logger.addHandler(printer)
    return collector


def _timed_loader(build_mod, marks):
    """Wrap the loader's iteration to record, per batch, the host clock
    when it is asked for and when it is handed over."""
    orig = build_mod.PrefetchingLoader.__iter__

    def timed(self):
        it = orig(self)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            marks.append((t0, time.perf_counter()))
            yield batch

    build_mod.PrefetchingLoader.__iter__ = timed
    return orig


def check_eval_outputs(folder, label):
    """The COCO metrics and result file exist, the metrics are finite and
    every detection lies inside its image."""
    with open(os.path.join(folder, "coco_results.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(folder, "coco_custom_result.json")) as f:
        dets = json.load(f)
    with open(os.path.join(folder, "coco_custom_gt.json")) as f:
        sizes = {im["id"]: (im["width"], im["height"]) for im in json.load(f)["images"]}
    if not (metrics and all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"{label}: metrics {metrics}")
    if not dets:
        raise AssertionError(f"{label}: no detections written")
    for d in dets:
        w, h = sizes[d["image_id"]]
        x, y, bw, bh = d["bbox"]
        if not (x >= 0 and y >= 0 and x + bw <= w + 1 + 1e-3 and y + bh <= h + 1 + 1e-3
                and np.isfinite(d["score"])):
            raise AssertionError(f"{label}: detection {d} outside its {w}x{h} image")
    return metrics, len(dets)


def eval_cli_path(flagship, dev, card):
    """Phase 8: the episodic eval data path and the test_net CLI at full
    width. A synthetic COCO-style dataset of VOC-sized PPM images and a .pth
    of the seed-1 model; H1 against its plain version; the card loader
    against the CPU loader over a whole pass; the CLI on the flagship (bf16,
    batch 8) over CLI_STOP_ITER batches, unfused and with the fused head,
    then --seq_test over three copies of the .pth. Returns (per-path
    launches, numbers)."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.data import build as data_build
    from oneshotdet_tpu_torch.data import make_data_loader
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import resize
    from oneshotdet_tpu_torch.tools import test_net
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

    t_phase = time.perf_counter()
    paths, out = {}, {}
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann_file = write_synthetic_coco(root, num_images=DATA_IMAGES, sizes=DATA_SIZES,
                                                 box_side=DATA_BOX_SIDE, seed=0)
        os.environ["ONESHOT_CUSTOM_IMG_DIR"] = img_dir
        os.environ["ONESHOT_CUSTOM_ANN_FILE"] = ann_file
        opts = ["DATASETS.TEST", "('custom',)", "TEST.IMS_PER_BATCH", str(BATCH)]
        cfg = default_cfg.clone()
        cfg.merge_from_file(flagship)
        cfg.merge_from_list(opts)
        model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        ckpt = os.path.join(root, "seed1.pth")
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
        del model
        torch.cuda.empty_cache()

        # H1 on the first batch's images and edge cases
        loader, dataset = make_data_loader(cfg, is_train=False, device=dev)
        first_idx = next(iter(loader.batch_iter()))
        fresh = data_build.build_dataset(cfg, "custom", False)
        items = [fresh.load(fresh.plan(i)) for i in first_idx]
        query_bucket = loader.collator.query_bucket_for([it["img"]["out_hw"] for it in items])
        out["h1"] = h1_checks(resize, items, query_bucket, tuple(cfg.TPU.SUPP_BUCKET), dev, card)

        # the card loader against the CPU loader, a whole pass
        reset_launches()
        t0 = time.perf_counter()
        card_batches = list(loader)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        paths["eval loader, one pass"] = read_launches()
        cpu_batches = list(make_data_loader(cfg, is_train=False, device="cpu")[0])
        if len(card_batches) != len(cpu_batches):
            raise AssertionError("loader: the card and CPU loaders give different batch counts")
        for i, (g, c) in enumerate(zip(card_batches, cpu_batches)):
            for k in c:
                if isinstance(c[k], torch.Tensor):
                    if not (g[k].device.type == dev.type and torch.equal(
                            g[k].cpu().view(torch.int32), c[k].view(torch.int32))):
                        raise AssertionError(f"loader batch {i}: {k} differs from the CPU loader")
                elif not np.array_equal(g[k], c[k]):
                    raise AssertionError(f"loader batch {i}: {k} differs from the CPU loader")
        buckets = sorted({tuple(b["query_pixels"].shape[1:3]) for b in card_batches})
        n_h1 = paths["eval loader, one pass"]["resize_normalize_pad"]
        if n_h1 != len(card_batches) or \
                buckets != sorted(tuple(b) for b in cfg.TPU.QUERY_BUCKETS):
            raise AssertionError(f"loader: {n_h1} H1 launches for {len(card_batches)} batches, "
                                 f"query buckets {buckets}")
        log(f"eval loader: {len(dataset)} episodes in {len(card_batches)} batches, query "
            f"buckets {buckets}, equal to the CPU loader (pixels bit for bit); one pass on the "
            f"card {card_s:.2f} s, {n_h1} H1 launches [{card}]")
        out["loader"] = dict(episodes=len(dataset), batches=len(card_batches), pass_s=card_s)
        del card_batches, cpu_batches, loader
        torch.cuda.empty_cache()

        # the CLI, unfused and with the fused head
        collector = _cli_logger()
        cli = out["cli"] = {}
        for fused in (False, True):
            label = "eval CLI (test_net), fused head" if fused else "eval CLI (test_net)"
            out_dir = os.path.join(root, "fused" if fused else "unfused")
            argv = ["--config-file", flagship, "--ckpt", ckpt, *opts, "OUTPUT_DIR", out_dir,
                    "FEW_SHOT.STOP_ITER", str(CLI_STOP_ITER)]
            marks = []
            collector.messages.clear()
            orig = _timed_loader(data_build, marks)
            if fused:
                os.environ["ONESHOT_PALLAS_ROI_HEAD"] = "1"
            reset_launches()
            try:
                rc = test_net.main(argv)
            finally:
                data_build.PrefetchingLoader.__iter__ = orig
                os.environ.pop("ONESHOT_PALLAS_ROI_HEAD", None)
            torch.cuda.synchronize()
            paths[label] = n = read_launches()
            metrics, n_dets = check_eval_outputs(os.path.join(out_dir, "eval"), label)
            if rc != 0 or n["roi_align"] != 7 * CLI_STOP_ITER or \
                    n["roi_head"] != (CLI_STOP_ITER if fused else 0) or \
                    n["resize_normalize_pad"] != len(marks):
                raise AssertionError(f"{label}: exit {rc}, launches {n} for {CLI_STOP_ITER} "
                                     f"batches ({len(marks)} handed over)")
            loaded = [m for m in collector.messages if m.startswith("Loading checkpoint from ")]
            if loaded != [f"Loading checkpoint from {ckpt}"]:
                raise AssertionError(f"{label}: loaded {loaded}")
            # batch k's time: from its request to the next request (the engine
            # reads the detections back before it asks again); batch 0 warms up
            starts = [m[0] for m in marks]
            timed = CLI_STOP_ITER - 1
            img_s = BATCH * timed / (starts[CLI_STOP_ITER] - starts[1])
            host_ms = [1e3 * (b - a) for a, b in marks]
            cli[label] = dict(img_s=img_s, loader_host_ms=host_ms, detections=n_dets,
                              AP50=metrics["AP50"])
            log(f"{label}: {CLI_STOP_ITER} batches of {BATCH} (832x1216 / 1216x832, bf16), "
                f"{img_s:.1f} img/s over batches 2-{CLI_STOP_ITER} (host clock, loader "
                f"included), loader host ms per batch {[round(v, 1) for v in host_ms]}, "
                f"launches {n}, {n_dets} detections, AP50 {metrics['AP50']:.4f} (random "
                f"weights) [{card}]")
            torch.cuda.empty_cache()

        # --seq_test over three copies of the .pth, MIN_ITER 2, MAX_ITER 3
        load_dir = os.path.join(root, "ckpts")
        os.makedirs(load_dir)
        for it in (1, 2, 3):
            os.link(ckpt, os.path.join(load_dir, f"model_{it:07d}.pth"))
        seq_dir = os.path.join(root, "seq")
        collector.messages.clear()
        reset_launches()
        rc = test_net.main(["--config-file", flagship, "--seq_test", *opts, "OUTPUT_DIR", seq_dir,
                            "FEW_SHOT.STOP_ITER", "1", "TEST.LOAD_DIR", load_dir,
                            "TEST.MIN_ITER", "2", "TEST.MAX_ITER", "3"])
        torch.cuda.synchronize()
        paths["eval CLI --seq_test"] = read_launches()
        want = [os.path.join(load_dir, f"model_{it:07d}.pth") for it in (2, 3)]
        seq = [m[len("=== seq_test checkpoint "):-4] for m in collector.messages
               if m.startswith("=== seq_test checkpoint ")]
        loaded = [m[len("Loading checkpoint from "):] for m in collector.messages
                  if m.startswith("Loading checkpoint from ")]
        evals = sorted(d for d in os.listdir(seq_dir) if d.startswith("eval"))
        if rc != 0 or seq != want or loaded != want or evals != ["eval_0000002", "eval_0000003"]:
            raise AssertionError(f"--seq_test: exit {rc}, checkpoints {seq}, loaded {loaded}, "
                                 f"folders {evals}")
        for d in evals:
            check_eval_outputs(os.path.join(seq_dir, d), f"--seq_test {d}")
        log(f"eval CLI --seq_test: evaluated {[os.path.basename(w) for w in want]} into {evals} "
            f"(model_0000001.pth left out by TEST.MIN_ITER) [{card}]")
        logging.getLogger("oneshotdet_tpu_torch").handlers.clear()
        for key in ("ONESHOT_CUSTOM_IMG_DIR", "ONESHOT_CUSTOM_ANN_FILE"):
            os.environ.pop(key, None)
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return paths, out


C2_CATALOG = """class ModelCatalog:
    @staticmethod
    def get(name):
        if name != "ImageNetPretrained/MSRA/R-50":
            raise RuntimeError(f"model not present in the catalog {{name}}")
        return {url!r}
"""


class _TrainProbe:
    """Wraps ``Checkpointer.load`` / ``save`` and the trainer's
    ``train_step`` for one CLI run: after each load, ``on_load(model,
    optimizer, path)``; per save its host seconds; per step its entry time,
    learning rate, K1 and K1b launches, and the losses (read after the run)."""

    def __init__(self, ckpt_mod, trainer_mod, on_load):
        self.ckpt_mod, self.trainer_mod, self.on_load = ckpt_mod, trainer_mod, on_load
        self.saves, self.steps, self.end = [], [], None
        self.max_iter = None

    def __enter__(self):
        cls, probe = self.ckpt_mod.Checkpointer, self
        self.orig = (cls.load, cls.save, self.trainer_mod.train_step)
        load, save, step = self.orig

        def load_(ckptr, model, optimizer=None, scheduler=None, **kw):
            start = load(ckptr, model, optimizer, scheduler, **kw)
            probe.on_load(model, optimizer, start)
            return start

        def save_(ckptr, name, *args, **kw):
            t0 = time.perf_counter()
            path = save(ckptr, name, *args, **kw)
            probe.saves.append((name, time.perf_counter() - t0))
            return path

        def step_(model, optimizer, scheduler, batch, generator=None, draws=None, it=None):
            t0 = time.perf_counter()
            before = read_launches()
            lr = optimizer.param_groups[0]["lr"]
            metrics = step(model, optimizer, scheduler, batch, generator, draws, it)
            after = read_launches()
            probe.steps.append(dict(it=it, t0=t0, lr=lr, metrics=metrics,
                                    launches={k: after[k] - before[k] for k in after}))
            if it + 1 == probe.max_iter:
                torch.cuda.synchronize()
                probe.end = time.perf_counter()
            return metrics

        cls.load, cls.save, self.trainer_mod.train_step = load_, save_, step_
        return self

    def __exit__(self, *exc):
        cls = self.ckpt_mod.Checkpointer
        cls.load, cls.save, self.trainer_mod.train_step = self.orig


def train_cli_path(flagship, dev, card):
    """Phase 9: the train CLI at full width (tools.train_net in-process on
    the flagship, bf16, batch 8, 832x1216 / 1216x832 queries, 416x416
    supports, MAX_GT_BOXES 64) over phase 8's synthetic dataset with
    FEW_SHOT.TRAINING_EXCL_CATS [] (its 3 classes are COCO ids 1-3, which
    the default excludes). MODEL.WEIGHT is catalog://ImageNetPretrained/
    MSRA/R-50, which a PATHS_CATALOG file points at a file:// URL of
    Detectron-style R-50 blobs drawn from a numpy seed: after the load both
    backbones' bodies equal the blobs exactly. Run A trains 3 steps and
    saves model_0000003 and model_final; run B, in the same OUTPUT_DIR with
    FEW_SHOT.RESUME, loads the tag's file, starts at 3 with the weights of
    model_0000003.pth bit for bit and step 4's learning rate
    warmup_multistep_schedule(3), runs 7 K1 and 7 K1b calls (14 launches)
    a step, 1 H1 launch a batch and no K2-K5, finite losses, and saves
    model_0000006; remove_solver_states' copy of it loads; test_net
    --seq_test over the folder evaluates exactly model_0000003 and
    model_0000006. Returns (per-path launches, numbers)."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.data import build as data_build
    from oneshotdet_tpu_torch.engine import trainer
    from oneshotdet_tpu_torch.models.resnet import ResNet
    from oneshotdet_tpu_torch.solver import warmup_multistep_schedule
    from oneshotdet_tpu_torch.tools import remove_solver_states, test_net, train_net
    from oneshotdet_tpu_torch.utils import checkpoint as ckpt_mod
    from oneshotdet_tpu_torch.utils.c2_import import load_c2_pickle, map_c2_resnet_key
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_c2_resnet, write_synthetic_coco

    t_phase = time.perf_counter()
    paths, out = {}, {}
    run_a, run_b = TRAIN_CLI_ITERS
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann_file = write_synthetic_coco(root, num_images=DATA_IMAGES, sizes=DATA_SIZES,
                                                 box_side=DATA_BOX_SIDE, seed=0)
        blobs_path = write_synthetic_c2_resnet(
            os.path.join(root, "R-50.pkl"),
            {k: tuple(v.shape) for k, v in ResNet(50).state_dict().items()}, seed=5)
        blobs = load_c2_pickle(blobs_path)
        catalog = os.path.join(root, "catalog.py")
        with open(catalog, "w") as f:
            f.write(C2_CATALOG.format(url="file://" + blobs_path))
        env = {"ONESHOT_CUSTOM_IMG_DIR": img_dir, "ONESHOT_CUSTOM_ANN_FILE": ann_file,
               "ONESHOT_MODEL_ZOO": os.path.join(root, "zoo")}
        os.environ.update(env)
        train_dir = os.path.join(root, "train")
        opts = ["DATASETS.TRAIN", "('custom',)", "DATASETS.TEST", "('custom',)",
                "FEW_SHOT.TRAINING_EXCL_CATS", "[]", "TEST.IMS_PER_BATCH", str(BATCH),
                "SOLVER.IMS_PER_BATCH", str(BATCH), "SOLVER.CHECKPOINT_PERIOD", str(run_a),
                "MODEL.WEIGHT", "catalog://ImageNetPretrained/MSRA/R-50",
                "PATHS_CATALOG", catalog, "OUTPUT_DIR", train_dir]
        cfg = default_cfg.clone()
        cfg.merge_from_file(flagship)
        cfg.merge_from_list(opts)
        collector = _cli_logger("train_net")

        def check_blobs(model, optimizer, start):
            """Run A's load: both bodies equal the blobs; nothing else read."""
            sd = model.state_dict()
            n = 0
            for key, blob in blobs.items():
                name = map_c2_resnet_key(key)
                if name is None:
                    continue
                want = torch.from_numpy(blob)
                for net in ("backbone", "supp_backbone"):
                    got = sd[f"{net}.body.{name}"]
                    if got.device.type != dev.type or not torch.equal(got.cpu(), want):
                        raise AssertionError(f"train CLI run A: {net}.body.{name} differs from "
                                             f"the blob {key}")
                    n += 1
            for k, v in sd.items():
                if ".body." in k and k.endswith(("running_mean", "running_var")):
                    if not bool((v == (1.0 if k.endswith("var") else 0.0)).all()):
                        raise AssertionError(f"train CLI run A: {k} is not neutral")
            if start != 0:
                raise AssertionError(f"train CLI run A: start_iter {start}")
            out["blob_tensors_checked"] = n

        # -- run A: MODEL.WEIGHT from the model zoo, 3 steps, 2 saves
        reset_launches()
        with _TrainProbe(ckpt_mod, trainer, check_blobs) as probe_a:
            probe_a.max_iter = run_a
            rc = train_net.main(["--config-file", flagship, *opts, "SOLVER.MAX_ITER", str(run_a)])
        torch.cuda.synchronize()
        paths["train CLI run A"] = read_launches()
        files = sorted(os.listdir(train_dir))
        want_files = ["last_checkpoint", f"model_{run_a:07d}.pth", "model_final.pth"]
        resolved = [m for m in collector.messages if m.startswith("catalog://")]
        if rc != 0 or files != want_files or "blob_tensors_checked" not in out or not resolved:
            raise AssertionError(f"train CLI run A: exit {rc}, files {files}, messages "
                                 f"{collector.messages[-6:]}")
        log(f"train CLI run A: {resolved[0]}; both bodies equal the blobs "
            f"({out['blob_tensors_checked']} tensors); {run_a} steps, saved "
            f"{[n for n, _ in probe_a.saves]} in {[round(t, 2) for _, t in probe_a.saves]} s; "
            f"launches {paths['train CLI run A']} [{card}]")
        torch.cuda.empty_cache()

        # -- run B: resume from the tag, 3 more steps
        ref_path = os.path.join(train_dir, f"model_{run_a:07d}.pth")
        ref = torch.load(ref_path, map_location="cpu", weights_only=True)["model"]
        final_model = {}

        def check_resume(model, optimizer, start):
            sd = model.state_dict()
            bad = [k for k, v in ref.items() if not torch.equal(sd[k].cpu(), v)]
            if bad or set(sd) != set(ref) or start != run_a:
                raise AssertionError(f"train CLI run B: start {start}, {len(bad)} tensors differ "
                                     f"from {ref_path} ({bad[:3]})")
            final_model["model"] = model

        collector.messages.clear()
        marks = []
        orig_iter = _timed_loader(data_build, marks)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            with _TrainProbe(ckpt_mod, trainer, check_resume) as probe:
                probe.max_iter = run_b
                rc = train_net.main(["--config-file", flagship, *opts, "SOLVER.MAX_ITER",
                                     str(run_b), "FEW_SHOT.RESUME", "True"])
        finally:
            data_build.PrefetchingLoader.__iter__ = orig_iter
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        paths["train CLI run B"] = n = read_launches()
        loaded = [m for m in collector.messages if m.startswith("Loading checkpoint from ")]
        with open(os.path.join(train_dir, "last_checkpoint")) as f:
            tag = f.read()
        files = sorted(os.listdir(train_dir))
        want_files = ["last_checkpoint", f"model_{run_a:07d}.pth", f"model_{run_b:07d}.pth",
                      "model_final.pth"]
        final_path = os.path.join(train_dir, "model_final.pth")
        if rc != 0 or loaded != [f"Loading checkpoint from {final_path}"] or \
                f"start_iter: {run_a}" not in collector.messages or files != want_files or \
                tag != final_path:
            raise AssertionError(f"train CLI run B: exit {rc}, loaded {loaded}, files {files}, "
                                 f"tag {tag}")
        s = cfg.SOLVER
        lr4 = warmup_multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                        s.WARMUP_ITERS, s.WARMUP_METHOD)(run_a)
        steps = probe.steps
        if [st["it"] for st in steps] != list(range(run_a, run_b)) or steps[0]["lr"] != lr4:
            raise AssertionError(f"train CLI run B: iterations {[st['it'] for st in steps]}, "
                                 f"step 4's lr {steps[0]['lr']} (schedule: {lr4})")
        for st in steps:
            k = st["launches"]
            if k["roi_align"] != 7 or k["roi_align_bwd"] != 7 or any(
                    k[x] for x in ("roi_head", "group_norm", "roi_align_v3", "roi_align_v4")):
                raise AssertionError(f"train CLI step {st['it'] + 1}: launches {k}")
            losses = {name: float(v) for name, v in st["metrics"].items()}
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"train CLI step {st['it'] + 1}: losses {losses}")
            st["losses"] = losses
        if n["resize_normalize_pad"] != len(marks) or len(marks) != run_b - run_a or \
                n["roi_align"] != 7 * len(steps) or n["roi_align_bwd"] != 7 * len(steps):
            raise AssertionError(f"train CLI run B: launches {n} for {len(marks)} batches")
        # steps 5-6: from the request of step 5's batch to the end of step 6's work
        ms_step = 1e3 * (probe.end - marks[1][0]) / 2
        host_ms = [1e3 * (b - a) for a, b in marks]
        for it in range(run_a, run_b):
            log(f"train CLI step {it + 1}: lr {steps[it - run_a]['lr']:.6g}, "
                + ", ".join(f"{k} {v:.4f}" for k, v in steps[it - run_a]["losses"].items()))
        log(f"train CLI run B: resumed from {final_path} at iteration {run_a} (the tag; weights "
            f"equal {os.path.basename(ref_path)} bit for bit, step 4's lr = "
            f"warmup_multistep_schedule({run_a}) = {lr4:.6g}); {ms_step:.1f} ms/step by the host "
            f"clock over steps 5-6 with the loader included (bf16, batch {BATCH}, 832x1216 / "
            f"1216x832); loader host ms per batch {[round(v, 1) for v in host_ms]}; saves "
            f"{[(k, round(v, 2)) for k, v in probe.saves]} s; peak memory {peak / 2**30:.2f} GiB; "
            f"per step 7 K1 launches, 7 K1b calls (14 launches), no K2-K5; "
            f"{n['resize_normalize_pad']} H1 launches for {len(marks)} batches [{card}]")
        out.update(ms_per_step=ms_step, loader_host_ms=host_ms,
                   save_s={"run A": probe_a.saves, "run B": probe.saves},
                   peak_gib=peak / 2**30, lr_step4=lr4,
                   losses=[st["losses"] for st in steps])
        del steps, probe.steps
        torch.cuda.empty_cache()

        # -- a weights-only copy of model_0000006 loads
        slim_dir = os.path.join(root, "slim")
        os.makedirs(slim_dir)
        slim = os.path.join(slim_dir, f"model_{run_b:07d}.pth")
        full = os.path.join(train_dir, f"model_{run_b:07d}.pth")
        rc = remove_solver_states.main(["--in", full, "--out", slim])
        data = torch.load(slim, map_location="cpu", weights_only=True)
        model = final_model.pop("model")
        start = ckpt_mod.Checkpointer(slim_dir).load(model, f=slim, resume=False)
        want = torch.load(full, map_location="cpu", weights_only=True)["model"]
        sd = model.state_dict()
        if rc != 0 or set(data) != {"model", "iteration"} or start != 0 or any(
                not torch.equal(sd[k].cpu(), v) for k, v in want.items()):
            raise AssertionError(f"remove_solver_states: exit {rc}, keys {sorted(data)}")
        log(f"remove_solver_states: {os.path.getsize(full) / 2**20:.0f} MiB -> "
            f"{os.path.getsize(slim) / 2**20:.0f} MiB, loads with resume=False")
        del model, sd, data, want, ref
        torch.cuda.empty_cache()

        # -- test_net --seq_test over the training folder
        seq_dir = os.path.join(root, "seq")
        collector.messages.clear()
        reset_launches()
        rc = test_net.main(["--config-file", flagship, "--seq_test", *opts, "OUTPUT_DIR", seq_dir,
                            "FEW_SHOT.STOP_ITER", "1", "TEST.LOAD_DIR", train_dir])
        torch.cuda.synchronize()
        paths["train CLI, test_net --seq_test"] = read_launches()
        want = [os.path.join(train_dir, f"model_{it:07d}.pth") for it in (run_a, run_b)]
        loaded = [m[len("Loading checkpoint from "):] for m in collector.messages
                  if m.startswith("Loading checkpoint from ")]
        evals = sorted(d for d in os.listdir(seq_dir) if d.startswith("eval"))
        if rc != 0 or loaded != want or evals != [f"eval_{run_a:07d}", f"eval_{run_b:07d}"]:
            raise AssertionError(f"train CLI --seq_test: exit {rc}, loaded {loaded}, "
                                 f"folders {evals}")
        n_dets = [check_eval_outputs(os.path.join(seq_dir, d), f"--seq_test {d}")[1]
                  for d in evals]
        log(f"test_net --seq_test over the training folder: evaluated "
            f"{[os.path.basename(w) for w in want]} into {evals}, {n_dets} detections inside "
            f"their images [{card}]")
        logging.getLogger("oneshotdet_tpu_torch").handlers.clear()
        for key in env:
            os.environ.pop(key, None)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 9: {out['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return paths, out


ARTIFACT_ROUNDS = 2            # phase 10: the frames twice per route, frames 2-8 timed
# phase 10's compiled route against the eager bf16 predictor: Inductor fuses
# and reorders the bf16 arithmetic (GroupNorm's statistics, pointwise
# chains), so an activation can round to the neighbouring bf16 value and
# near-tied scores cross the top-k and NMS cuts. Detections pair by IoU > 0.99
# with score and coordinates within one bf16 ulp, relative; at least this
# share per frame (the detection tolerances' share is printed beside it)
ARTIFACT_RTOL = 2.0 ** -7
ARTIFACT_MIN_SHARE = 0.75


def phase5_batch(dev):
    """Phase 5's batch-8 queries (832x1216) and supports (416x416), drawn
    from seed 5 on the card."""
    from oneshotdet_tpu_torch.structures import ImageBatch

    g = torch.Generator(device=dev).manual_seed(5)
    q_sizes = torch.tensor([[832, 1216], [800, 1200], [832, 1100], [704, 1216],
                            [832, 1216], [768, 1024], [832, 1184], [640, 960]],
                           dtype=torch.float32, device=dev)
    s_sizes = torch.tensor([[416, 416], [300, 400], [400, 300], [416, 320],
                            [256, 416], [416, 416], [350, 350], [200, 400]],
                           dtype=torch.float32, device=dev)
    images = ImageBatch(torch.randn(BATCH, *QUERY_HW, 3, generator=g, device=dev) * 50, q_sizes)
    supps = ImageBatch(torch.randn(BATCH, *SUPP_HW, 3, generator=g, device=dev) * 50, s_sizes)
    return images, supps


def _frame_ms(predictor, frames, rounds=ARTIFACT_ROUNDS):
    """ms per frame by the host clock (``run_on_image`` returns host arrays)
    over every frame after the first, the frames ``rounds`` times."""
    times = []
    for _ in range(rounds):
        for frame in frames:
            t0 = time.perf_counter()
            predictor.run_on_image(frame)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times[1:]))


def _detection_gap(a, b):
    """Largest relative score and box gaps between the detections of a and
    their partners in b, over the detections whose highest-IoU partner has
    IoU > 0.99 (``_best_partners``)."""
    _, j, iou = _best_partners(a, b, 5e-4, 1e-3)
    same = iou > 0.99
    if not same.any():
        return 0.0, 0.0
    score = np.abs(b[1][j] - a[1]) / np.maximum(np.abs(a[1]), 1e-6)
    box = np.abs(b[0][j] - a[0]) / np.maximum(np.abs(a[0]), 1.0)
    return float(score[same].max()), float(box[same].max())


def same_program(a, b) -> bool:
    """Two ExportedPrograms with the same graph, signature, weights and
    constants (values equal), so one compiled package serves both."""
    if a.graph_module.code != b.graph_module.code or \
            str(a.graph_signature) != str(b.graph_signature):
        return False
    for x, y in ((a.state_dict, b.state_dict), (a.constants, b.constants)):
        if x.keys() != y.keys() or not all(
                isinstance(x[k], torch.Tensor) == isinstance(y[k], torch.Tensor)
                and (not isinstance(x[k], torch.Tensor) or (
                    x[k].shape == y[k].shape and x[k].dtype == y[k].dtype
                    and torch.equal(x[k], y[k]))) for k in x):
            return False
    return True


def artifact_path(flagship, dev, card, supp, frames):
    """Phase 10: the serving artifact at full width (export.py,
    predictor.ArtifactPredictor). The flagship bf16 with seeded distinct
    weights (``distinct_weights_``, seed 12): the serving bundle at batch 1
    (832x1216 queries, 416x416 supports) exported unfused and with the fused
    head, each with its AOTInductor pair, and the ``full`` kind at batch 8
    unfused as an ExportedProgram; export and compile seconds and the
    files' sizes. Each bundle served by ``ArtifactPredictor`` from the
    compiled pair (``used_executable``) and from the ExportedProgram pair
    alone, load seconds against building ``OneShotPredictor``. On phase 4's
    support and frames: the ExportedProgram route equals ``OneShotPredictor``
    bit for bit; at least ARTIFACT_MIN_SHARE of the compiled route's
    detections pair up with its own per frame (IoU > 0.99, score and box
    within one bf16 ulp, ``match_fraction``), the share within the detection
    tolerances (score rtol 5e-4, box rtol 1e-3) and the largest gap printed
    beside it. K1 launches 6 per ``set_support`` and 1 per frame
    from inside both routes' programs, K3 1 per frame with the fused head
    and 0 without, nothing else. The full artifact equals the eager forward
    on phase 5's batch bit for bit (7 K1 launches). ms per frame over frames
    2 and later for each route and ``OneShotPredictor``, and peak memory.
    The fused bundle's support program is the unfused one's (the same graph
    and weights, ``same_program``), so its AOTInductor package is compiled
    once and hard-linked into the fused bundle. Returns (per-path launches,
    numbers)."""
    from oneshotdet_tpu_torch import export as oexport
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.predictor import ArtifactPredictor, OneShotPredictor

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = default_cfg.clone()
    cfg.merge_from_file(flagship)
    paths, out = {}, {"bundles": {}}
    t0 = time.perf_counter()
    eager = OneShotPredictor(cfg, confidence_threshold=0.0, query_bucket=QUERY_HW,
                             supp_bucket=SUPP_HW, device=dev,
                             generator=torch.Generator().manual_seed(1))
    distinct_weights_(eager.model, torch.Generator().manual_seed(12))
    torch.cuda.synchronize()
    out["eager_build_s"] = time.perf_counter() - t0
    model = eager.model
    compile_s, reused = {}, {}
    save_compiled = oexport.save_compiled
    supports = {}

    def timed_save_compiled(exported, path):
        """``save_compiled``, timed; a support program equal to one already
        compiled (the unfused and fused bundles' support graphs and weights
        are the same) gets that AOTInductor package, hard-linked, in place
        of a second compile."""
        t = time.perf_counter()
        twin = next((p for p, e in supports.items() if same_program(e, exported)), None) \
            if path.endswith(".support") else None
        if twin is not None:
            for ext in (".exec", ".exec.json"):
                os.link(twin + ext, path + ext)
            ok = True
        else:
            ok = save_compiled(exported, path)
        if path.endswith(".support"):
            supports[path] = exported
            reused[path] = twin
        compile_s[path] = time.perf_counter() - t
        return ok

    with tempfile.TemporaryDirectory() as root:
        oexport.save_compiled = timed_save_compiled
        try:
            for fused in (False, True):
                name = "fused" if fused else "unfused"
                model.config = dataclasses.replace(model.config, fused_roi_head=fused)
                stem = os.path.join(root, name)
                t0 = time.perf_counter()
                if not oexport.export_serving(cfg, model, stem, query_hw=QUERY_HW,
                                              supp_hw=SUPP_HW):
                    raise AssertionError(f"export_serving {name}: no compiled pair")
                total = time.perf_counter() - t0
                files = {ext: os.path.getsize(stem + ext) for ext in
                         (".support", ".detect", ".support.exec", ".detect.exec")}
                twin = reused[stem + ".support"]
                out["bundles"][name] = dict(
                    export_s=total - compile_s[stem], compile_s=compile_s[stem],
                    compile_support_s=compile_s[stem + ".support"],
                    compile_detect_s=compile_s[stem + ".detect"],
                    support_package_from=os.path.basename(twin) if twin else None,
                    mib={k: v / 2**20 for k, v in files.items()})
                support_how = (f"support package of {os.path.basename(twin)} reused (the same "
                               f"graph and weights) in {compile_s[stem + '.support']:.2f} s"
                               if twin else
                               f"AOTInductor compile support {compile_s[stem + '.support']:.1f} s")
                log(f"artifact {name}: export_serving {total:.1f} s (export + save "
                    f"{total - compile_s[stem]:.1f} s, {support_how} + detect "
                    f"{compile_s[stem + '.detect']:.1f} s); files "
                    + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in files.items())
                    + f" [{card}]")
                # the ExportedProgram pair alone, without the compiled one
                ep_stem = os.path.join(root, f"{name}_ep")
                for ext in (".support", ".detect", ".meta.json"):
                    os.link(stem + ext, ep_stem + ext)
        finally:
            oexport.save_compiled = save_compiled
        model.config = dataclasses.replace(model.config, fused_roi_head=False)
        t0 = time.perf_counter()
        full = oexport.export_eval(cfg, model, batch=BATCH, query_hw=QUERY_HW, supp_hw=SUPP_HW,
                                   kind="full")
        full_export_s = time.perf_counter() - t0
        oexport.save(full, os.path.join(root, "full.eval"))
        full_mib = os.path.getsize(os.path.join(root, "full.eval")) / 2**20
        t0 = time.perf_counter()
        full = oexport.load(os.path.join(root, "full.eval")).module()
        full_load_s = time.perf_counter() - t0
        out["full"] = dict(export_s=full_export_s, mib=full_mib, load_s=full_load_s)
        log(f"artifact full (batch {BATCH}, unfused, ExportedProgram): export "
            f"{full_export_s:.1f} s, {full_mib:.1f} MiB, load {full_load_s:.1f} s [{card}]")

        # -- the full artifact against the eager forward on phase 5's batch
        zero = {k: 0 for k in _counters()}
        images, supps = phase5_batch(dev)
        tids = torch.ones((BATCH,), dtype=torch.int32, device=dev)
        ref = model(images, supps)
        reset_launches()
        with torch.inference_mode():
            got = full(images.pixels, images.sizes, supps.pixels, supps.sizes, tids)
        torch.cuda.synchronize()
        paths["artifact full, batch 8"] = read_launches()
        want = (ref.xyxy, ref.get_field("scores"), ref.valid)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("artifact full: differs from the eager forward")
        if paths["artifact full, batch 8"] != dict(zero, roi_align=7):
            raise AssertionError(f"artifact full: launches {paths['artifact full, batch 8']}")
        log(f"artifact full, batch {BATCH}: equal to the eager forward bit for bit "
            f"({int(ref.valid.sum())} detections), 7 K1 launches from inside the program")
        del full, images, supps, got, ref, want
        torch.cuda.empty_cache()
        out["peak_full_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()

        # -- serving: both routes of each bundle against OneShotPredictor
        ms = {}
        for fused in (False, True):
            name = "fused" if fused else "unfused"
            model.config = dataclasses.replace(model.config, fused_roi_head=fused)
            routes = {}
            for route, stem in (("compiled", name), ("exported", f"{name}_ep")):
                t0 = time.perf_counter()
                routes[route] = ArtifactPredictor(os.path.join(root, stem), device=dev)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                if routes[route].used_executable != (route == "compiled"):
                    raise AssertionError(f"artifact {name} {route}: used_executable "
                                         f"{routes[route].used_executable}")
                out["bundles"][name][f"{route}_load_s"] = load_s
            eager.set_support(supp)
            for route, ap in routes.items():
                label = f"artifact {name} {route}"
                reset_launches()
                ap.set_support(supp)
                torch.cuda.synchronize()
                paths[f"{label}, set_support"] = read_launches()
                if paths[f"{label}, set_support"] != dict(zero, roi_align=6):
                    raise AssertionError(f"{label} set_support: {paths[f'{label}, set_support']}")
                worst, n, paired, shares = (0.0, 0.0), 0, 0, []
                total = dict(zero)
                for frame in frames:
                    want = eager.run_on_image(frame)
                    reset_launches()
                    got = ap.run_on_image(frame)
                    torch.cuda.synchronize()
                    frame_launches = read_launches()
                    if frame_launches != dict(zero, roi_align=1, roi_head=int(fused)):
                        raise AssertionError(f"{label} frame: launches {frame_launches}")
                    total = {k: v + frame_launches[k] for k, v in total.items()}
                    if route == "exported":
                        if not (np.array_equal(got[0], want[0])
                                and np.array_equal(got[1], want[1])):
                            raise AssertionError(f"{label}: differs from OneShotPredictor")
                    else:
                        shares.append((match_fraction(got, want, ARTIFACT_RTOL, ARTIFACT_RTOL),
                                       match_fraction(got, want)))
                        gap = _detection_gap(got, want)
                        worst = tuple(max(a, b) for a, b in zip(worst, gap))
                    n += len(want[1])
                    paired += len(got[1])
                paths[f"{label}, {len(frames)} frames"] = total
                if route == "compiled":
                    out["bundles"][name]["compiled_gap"] = worst
                    out["bundles"][name]["compiled_paired_share"] = shares
                    if min(sh[0] for sh in shares) < ARTIFACT_MIN_SHARE:
                        raise AssertionError(
                            f"{label}: shares paired with OneShotPredictor's {shares}, required "
                            f">= {ARTIFACT_MIN_SHARE} within {ARTIFACT_RTOL:.2e}")

                log(f"{label}: {paired} detections over {len(frames)} frames "
                    + ("equal to OneShotPredictor's bit for bit" if route == "exported" else
                       f"against OneShotPredictor's {n}: share paired by IoU > 0.99 per frame "
                       f"within one bf16 ulp ({ARTIFACT_RTOL:.2e} relative; required >= "
                       f"{ARTIFACT_MIN_SHARE}) {[sh[0] for sh in shares]}, within score rtol "
                       f"5e-4 and box rtol 1e-3 {[sh[1] for sh in shares]}; largest gap of "
                       f"same boxes (IoU > 0.99): score {worst[0]:.2e}, box {worst[1]:.2e} "
                       f"relative")
                    + f"; per set_support 6 K1, per frame 1 K1 and {int(fused)} K3 launched "
                    f"from inside the loaded programs, load {out['bundles'][name][route + '_load_s']:.2f} s")
            ms[f"OneShotPredictor {name}"] = _frame_ms(eager, frames)
            for route, ap in routes.items():
                ms[f"artifact {name} {route}"] = _frame_ms(ap, frames)
            del routes
        out["frame_ms"] = ms
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"artifact serving ms per frame (host clock, frames 2-{ARTIFACT_ROUNDS * len(frames)}"
            f", bf16, batch 1, 832x1216 / 416x416 buckets): "
            + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
            + f"; building OneShotPredictor {out['eager_build_s']:.2f} s; peak memory while "
            f"serving {out['peak_gib']:.2f} GiB (exports and the batch-8 full program "
            f"{out['peak_full_gib']:.2f} GiB) [{card}]")
    del eager, model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10: {out['phase_s']:.1f} s")
    return paths, out


# phase 11: the training variants, each config's cfg overrides; "neg" feeds
# negative supports (a second episode batch's supports) to forward_train and
# "adabound" steps the config by the port's AdaBound
VARIANTS = {
    "art + soft transLinear + mse + rn + remat": dict(opts=[
        "FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS", True, "FEW_SHOT.SOFT_LABELING", True,
        "FEW_SHOT.SOFT_LABELING_FUNC", "transLinear", "FEW_SHOT.SECOND_STAGE_CLS_LOSS",
        "mse_loss", "FEW_SHOT.SECOND_STAGE_METHOD", "rn", "TPU.REMAT_BACKBONE", True],
        neg=False, adabound=True, extra=None),
    "reverse order + cxe + linear fusion": dict(opts=[
        "FEW_SHOT.REVERSE_ORDER", True, "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "cxe_loss",
        "FEW_SHOT.LINEAR_FUSION", True], neg=False, adabound=False, extra="loss_reverse"),
    "neg support + focal": dict(opts=[
        "FEW_SHOT.NEG_SUPPORT.TURN_ON", True, "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "focal_loss"],
        neg=True, adabound=False, extra="loss_cls_suppress"),
}
VARIANT_WARMUP, VARIANT_STEPS = 1, 2
# K3 at the variants' predictor widths: (ncls, nreg) -> ncls + 4 nreg columns
HEAD_WIDTHS = {9: (1, 2), 14: (2, 3)}
HEAD_WIDTH_CASES = ((16000, 2000), (4096, 512))


def variant_cfg(cfg_path, opts, small=False):
    from oneshotdet_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(cfg_path)
    cfg.merge_from_list((SMALL if small else []) + list(opts))
    return cfg


def variant_step(model, optimizer, scheduler, batch, neg_batch, gen, dev):
    """One update of a variant config: ``engine.train_step`` or, with
    negative supports, ``forward_train`` with them and the same backward,
    optimizer and scheduler steps. Returns the detached losses."""
    from oneshotdet_tpu_torch.engine import batch_to_inputs, train_step

    if neg_batch is None:
        return train_step(model, optimizer, scheduler, batch, gen)
    images, supp, targets = batch_to_inputs(batch, dev)
    optimizer.zero_grad(set_to_none=True)
    losses = model.forward_train(images, supp, targets, generator=gen,
                                 images_neg_supp=batch_to_inputs(neg_batch, dev)[1])
    sum(losses.values()).backward()
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in losses.items()}


def variant_full_width(cfg_path, dev, card, label, spec):
    """Phase 11a: one variant config at full width (the flagship, bf16, batch
    8, 832x1216 queries, 416x416 supports, seed-1 weights, fresh episodes):
    VARIANT_WARMUP + VARIANT_STEPS steps; finite losses with the expected
    keys, a non-zero gradient on the support backbone's layer4 (reached only
    through K1b), 7 K1 and 7 K1b launches per step (8 and 8 with negative
    supports); ms/step over the timed steps; peak memory of one step, and
    with remat the same step without it."""
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer, make_param_groups
    from oneshotdet_tpu_torch.solver.adabound import AdaBound
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    cfg = variant_cfg(cfg_path, spec["opts"])
    steps = VARIANT_WARMUP + VARIANT_STEPS
    aug = spec.get("aug", 0)
    batches = [aug_episode(make_episodic_batch(BATCH, QUERY_HW, SUPP_HW,
                                               max_gt=cfg.TPU.MAX_GT_BOXES, seed=300 + i), aug)
               for i in range(steps + 1)]
    negs = [aug_episode(make_episodic_batch(BATCH, QUERY_HW, SUPP_HW,
                                            max_gt=cfg.TPU.MAX_GT_BOXES, seed=400 + i), aug)
            for i in range(steps + 1)] if spec["neg"] else [None] * (steps + 1)
    model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    model.train()
    if spec["adabound"]:
        optimizer = AdaBound(make_param_groups(cfg, model), lr=cfg.SOLVER.BASE_LR)
    else:
        optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_scheduler(cfg, optimizer)
    gen = torch.Generator(device=dev).manual_seed(17)
    per_step = 8 if spec["neg"] else 7
    keys = {"loss_cls", "loss_reg", "loss_centerness", "loss_classifier", "loss_box_reg"}
    if spec["extra"]:
        keys.add(spec["extra"])
    reset_launches()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    history = []
    t0 = None
    for i, ((start, end), batch, neg) in enumerate(zip(events, batches, negs)):
        if i == VARIANT_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        start.record()
        history.append(variant_step(model, optimizer, scheduler, batch, neg, gen, dev))
        end.record()
        if i == 0:
            supp4 = [p.grad for n, p in model.named_parameters()
                     if n.startswith("supp_backbone.body.layer4.")]
            norm = math.sqrt(sum(float(g.float().norm()) ** 2 for g in supp4 if g is not None))
            if not (len(supp4) and all(g is not None for g in supp4) and norm > 0
                    and math.isfinite(norm)):
                raise AssertionError(f"variant {label}: support backbone layer4 gradient "
                                     f"norm {norm}")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / VARIANT_STEPS
    launches = read_launches()
    if launches["roi_align"] != per_step * steps or launches["roi_align_bwd"] != per_step * steps:
        raise AssertionError(f"variant {label}: {launches['roi_align']} K1 and "
                             f"{launches['roi_align_bwd']} K1b launches in {steps} steps, "
                             f"expected {per_step * steps} each")
    losses = [{k: float(v) for k, v in m.items()} for m in history]
    for i, m in enumerate(losses):
        if set(m) - {"loss_total"} != keys:
            raise AssertionError(f"variant {label} step {i + 1}: loss keys {sorted(m)}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"variant {label} step {i + 1}: non-finite losses {m}")
    event_ms = sorted(a.elapsed_time(b) for a, b in events[VARIANT_WARMUP:])
    out = dict(ms_per_step=wall * 1e3, event_ms=event_ms, losses=losses,
               k1_per_step=launches["roi_align"] // steps,
               k1b_per_step=launches["roi_align_bwd"] // steps,
               supp_layer4_grad_norm=norm, optimizer=type(optimizer).__name__)
    # peak memory of one step on the same batch, with remat and (for a remat
    # config) without it
    remat = model.config.remat_backbone
    for on in ((True, False) if remat else (False,)):
        model.config = dataclasses.replace(model.config, remat_backbone=on)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        variant_step(model, optimizer, scheduler, batches[-1], negs[-1], gen, dev)
        torch.cuda.synchronize()
        out["peak_gib_remat" if on else "peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    mem = f"peak memory {out['peak_gib']:.2f} GiB"
    if remat:
        mem = (f"peak memory {out['peak_gib_remat']:.2f} GiB with remat, {out['peak_gib']:.2f} "
               f"GiB without it on the same batch")
    log(f"train variant '{label}', flagship bf16, batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]}, "
        f"{type(optimizer).__name__}: {wall * 1e3:.1f} ms/step by the host clock over "
        f"{VARIANT_STEPS} steps (CUDA events {', '.join(f'{x:.1f}' for x in event_ms)} ms); "
        f"{mem}; {out['k1_per_step']} K1 and {out['k1b_per_step']} K1b launches per step; "
        f"losses {losses[-1]} [{card}]")
    del model, optimizer, scheduler, batches, negs
    torch.cuda.empty_cache()
    return out, launches


# The float32 gradients of two runs that round differently can take the
# other branch of a ReLU (or leaky ReLU) where its input lies within rounding
# of 0: with the supports' 2 x 2 layer4 maps at 64 x 64, one such element
# can move a parameter's gradient past the 1e-3 bound. ``follow_kinks``
# makes the card's backward take the CPU's branch there (inputs within
# KINK_REL x the tensor's largest magnitude of 0) and counts the elements.
KINK_REL = 1e-4


class _KinkAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, positive):
        ctx.save_for_backward(positive)
        ctx.slope = slope
        return torch.where(x > 0, x, x * slope)

    @staticmethod
    def backward(ctx, g):
        (positive,) = ctx.saved_tensors
        return torch.where(positive, g, g * ctx.slope), None, None


class follow_kinks:
    """Patch ``F.relu`` and ``F.leaky_relu`` (every activation of the model,
    ``nn.ReLU`` and ``nn.LeakyReLU`` included) for one run. With
    ``recorded`` None, record each call's input (CPU copies, in call
    order); else take the recorded run's branch where this run's input is
    within KINK_REL x its largest magnitude of 0, and count in ``taken`` the
    elements whose branch that changed."""

    def __init__(self, recorded=None):
        self.recorded = recorded
        self.calls = []
        self.taken = 0

    def _act(self, x, slope, inplace=False):
        if self.recorded is None:
            self.calls.append(x.detach().cpu())
            return self._orig[slope > 0](x, slope) if slope else self._orig[False](x)
        ref = self.recorded[len(self.calls)].to(x.device)
        self.calls.append(None)
        own = x.detach() > 0
        near = x.detach().abs() <= KINK_REL * x.detach().abs().max()
        positive = torch.where(near, ref > 0, own)
        self.taken += int((positive != own).sum())
        return _KinkAct.apply(x, float(slope), positive)

    def __enter__(self):
        import torch.nn.functional as F

        self._orig = {False: F.relu, True: F.leaky_relu}
        F.relu = lambda x, inplace=False: self._act(x, 0.0)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: self._act(x, negative_slope)
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.relu, F.leaky_relu = self._orig[False], self._orig[True]


def variant_small_check(cfg_path, dev, label, spec):
    """Phase 11b: the variant config's float32 train step at the tier-1
    tests' SMALL capacities (batch 2, 128x160 queries, 64x64 supports) on the
    card and on the CPU: the same weights, batch, artificial jitters, draws
    and negative supports; TF32 and cuDNN off; the card's activations
    differentiated at the CPU's branch within rounding of their kink
    (``follow_kinks``). Losses within rtol 1e-4, each parameter's gradient
    within 1e-3 relative norm."""
    from oneshotdet_tpu_torch.engine import batch_to_inputs
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.models.roi_head import draw_art_offsets
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    cfg = variant_cfg(cfg_path, spec["opts"], small=True)
    aug = spec.get("aug", 0)
    batch = aug_episode(make_episodic_batch(2, (128, 160), (64, 64), max_gt=4, seed=31), aug)
    neg = aug_episode(make_episodic_batch(2, (128, 160), (64, 64), max_gt=4, seed=32),
                      aug) if spec["neg"] else None
    cpu = build_detection_model(cfg, device="cpu")
    distinct_weights_(cpu, torch.Generator().manual_seed(33))
    g, post = cfg.TPU.MAX_GT_BOXES, cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN
    n = min(1000, 13 * g + post) if cfg.FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS else post + g
    gen = torch.Generator().manual_seed(34)
    art = draw_art_offsets((2, g), gen, "cpu")
    draws = torch.rand((2, n), generator=gen)

    def step(model, d, kinks):
        model.train()
        with kinks:
            losses = model.forward_train(
                *batch_to_inputs(batch, d), draws=draws.to(d), art_offsets=art.to(d),
                images_neg_supp=batch_to_inputs(neg, d)[1] if neg is not None else None)
            sum(losses.values()).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n_: p.grad.detach().cpu() for n_, p in model.named_parameters()
                 if p.grad is not None})

    record = follow_kinks()
    lc, gc = step(cpu, "cpu", record)
    gpu = build_detection_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    follow = follow_kinks(record.calls)
    torch.backends.cudnn.enabled = False
    try:
        lg, gg = step(gpu, dev, follow)
    finally:
        torch.backends.cudnn.enabled = True
    del gpu, record
    if len(follow.calls) != len(follow.recorded):
        raise AssertionError(f"small variant step '{label}': {len(follow.calls)} activations on "
                             f"the card, {len(follow.recorded)} on the CPU")
    if gc.keys() != gg.keys() or lc.keys() != lg.keys():
        raise AssertionError(f"small variant step '{label}': card and CPU differ in their "
                             f"losses or in which parameters have gradients")
    loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    rel = sorted(((float((gg[k] - v).norm() / v.norm().clamp(min=1e-30)), k)
                  for k, v in gc.items() if float(v.norm()) > 0), reverse=True)
    log(f"small float32 train step '{label}', card against CPU (cuDNN off, TF32 off): losses "
        f"within {loss_rel:.2e} relative, worst gradient {rel[0][0]:.2e} relative norm "
        f"({rel[0][1]}); {follow.taken} activation elements at the CPU's branch "
        f"(within {KINK_REL} x scale of the kink); losses {lc}")
    if loss_rel > 1e-4 or rel[0][0] > 1e-3:
        raise AssertionError(f"small variant step '{label}': losses {loss_rel:.2e} (rtol 1e-4), "
                             f"gradients {rel[0][0]:.2e} (bound 1e-3)")
    return dict(loss_rel=loss_rel, grad_rel=rel[0][0], grad_worst=rel[0][1],
                kink_elements_taken=follow.taken)


def head_width_checks(dev):
    """Phase 11c: the fused head K3 against its plain version at the
    variants' predictor widths, 9 (focal, mse, l1) and 14 (focal with
    negative supports, 'rn' with mse or l1) columns, at R = 16 000 and 4096,
    f32 and bf16 (HEAD_TOL), with times, plain times and the bound
    (``head_work`` at that width)."""
    from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead
    from oneshotdet_tpu_torch.ops import roi_head_fused as rf

    gen = torch.Generator().manual_seed(41)
    results = {}
    for cols, (ncls, nreg) in HEAD_WIDTHS.items():
        head = ROIBoxHead(num_classes=ncls, num_bbox_reg=nreg)
        distinct_weights_(head, gen)
        head = head.to(dev).eval()
        packed = rf.pack_roi_head_params(head)
        for r, per_image in HEAD_WIDTH_CASES:
            b = r // per_image
            x32 = torch.randn(r, 7, 7, 256, generator=gen).to(dev)
            s32 = torch.randn(b, 7, 7, 256, generator=gen).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                x, supp = x32.to(dtype), s32.to(dtype)
                ops = rf.kernel_operands(packed, dtype)
                with torch.inference_mode():
                    kl, kd = rf.fused_roi_head_cuda(x, supp, ops, per_image)
                    torch.cuda.synchronize()
                    pl, pd = rf.fused_roi_head_plain(x, supp, ops, per_image)
                if kl.shape != (r, ncls) or kd.shape != (r, 4 * nreg):
                    raise AssertionError(f"roi_head {cols} columns: outputs {tuple(kl.shape)}, "
                                         f"{tuple(kd.shape)}")
                err = max(float((kl - pl).abs().max()), float((kd - pd).abs().max()))
                tol = HEAD_TOL[dtype]
                name = f"{cols} columns R={r} ({b} x {per_image}) {str(dtype)[6:]}"
                if not (err <= tol and torch.isfinite(kl).all() and torch.isfinite(kd).all()):
                    raise AssertionError(f"roi_head {name}: max abs err {err:.3e} "
                                         f"(tolerance {tol})")
                reps = 10 if dtype == torch.bfloat16 else 5
                with torch.inference_mode():
                    ms = time_ms(lambda: rf.fused_roi_head_cuda(x, supp, ops, per_image),
                                 reps=reps)
                    plain_ms = time_ms(lambda: rf.fused_roi_head_plain(x, supp, ops, per_image),
                                       reps=3, warmup=1)
                nbytes, flops = head_work(r, b, ops)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                if dtype == torch.bfloat16:
                    t_ops, ops_by = flops / BF16_OPS_PER_S * 1e3, "operations"
                else:
                    t_fma, t_3x = flops / FP32_OPS_PER_S * 1e3, 3 * flops / TF32_OPS_PER_S * 1e3
                    t_ops = min(t_fma, t_3x)
                    ops_by = "3xtf32 ops" if t_3x <= t_fma else "fma ops"
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else ops_by
                log(f"roi_head {name}: max abs err {err:.3e} (tolerance {tol} abs); kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
                    f"{nbytes / 1e6:.1f} MB, {flops / 1e12:.3f} TFLOP), kernel at "
                    f"{100 * bound / ms:.1f}% of its bound")
                results[f"{cols} columns, R={r}, {str(dtype)[6:]}"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
                del kl, kd, pl, pd, x, supp
        del head
        torch.cuda.empty_cache()
    return results


def variant_fused_forwards(cfg_path, dev, card):
    """Phase 11c: one fused eval forward (batch 8, 832x1216, bf16, phase 5's
    batch) of the neg-support model with the focal loss (14 predictor
    columns: 1 K3 launch, 7 K1) and of the linear-fusion model (the JAX
    package's gate: 0 K3 launches, 7 K1); detections checked."""
    from oneshotdet_tpu_torch.models import build_detection_model

    images, supps = phase5_batch(dev)
    out, paths = {}, {}
    for label, opts, want in (
            ("neg support + focal", VARIANTS["neg support + focal"]["opts"], 1),
            ("linear fusion", ["FEW_SHOT.LINEAR_FUSION", True], 0)):
        cfg = variant_cfg(cfg_path, opts)
        model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        model.config = dataclasses.replace(model.config, fused_roi_head=True)
        model(images, supps)                                  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        dets = model(images, supps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = read_launches()
        if n["roi_head"] != want or n["roi_align"] != 7:
            raise AssertionError(f"fused eval forward, {label}: {n['roi_head']} K3 and "
                                 f"{n['roi_align']} K1 launches, expected {want} and 7")
        check_detections(dets, BATCH, min(cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                                          cfg.TPU.EVAL_ROI_TOPK
                                          or cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST),
                         images.sizes_wh())
        ncls = model.roi_heads.box.predictor.cls_score.out_features
        cols = ncls + model.roi_heads.box.predictor.bbox_pred.out_features
        log(f"fused eval forward, {label} ({cols} predictor columns): {n['roi_head']} K3 and "
            f"{n['roi_align']} K1 launches, {ms:.1f} ms (host clock, one forward), "
            f"{int(dets.valid.sum())} detections [{card}]")
        paths[f"train variants: fused eval forward, {label}"] = n
        out[label] = dict(ms=ms, k3_launches=n["roi_head"], columns=cols)
        del model, dets
        torch.cuda.empty_cache()
    return out, paths


def train_variants_path(cfg_path, dev, card):
    """Phase 11: the training variants (a) at full width, (b) small float32
    on the card against the CPU, (c) K3 at the variants' predictor widths
    and in their fused eval forwards."""
    t_phase = time.perf_counter()
    out = {"full_width": {}, "small": {}}
    paths = {}
    for label, spec in VARIANTS.items():
        out["full_width"][label], paths[f"train variants: {label}"] = variant_full_width(
            cfg_path, dev, card, label, spec)
    for label, spec in VARIANTS.items():
        out["small"][label] = variant_small_check(cfg_path, dev, label, spec)
    out["head_widths"] = head_width_checks(dev)
    out["fused_forwards"], fused_paths = variant_fused_forwards(cfg_path, dev, card)
    paths.update(fused_paths)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: {out['phase_s']:.1f} s")
    return paths, out


# -- phase 12: the support-side and dense-point switches -------------------------

def aug_supports(pixels, sizes, num_aug):
    """Each support (N, h, w, 3) of true size (h, w) followed by its
    ``num_aug`` variants, as the loader lays them out: the flip of its true
    extent, then a colour change standing in for the jitter (synthetic
    float pixels). Returns the (N * (1 + num_aug), ...) pixels and sizes
    (float32 numpy)."""
    pixels, sizes = np.asarray(pixels, np.float32), np.asarray(sizes, np.float32)
    out = []
    for s, (h, w) in zip(pixels, sizes.astype(int)):
        flip = s.copy()
        flip[:h, :w] = s[:h, :w][:, ::-1]
        jit = s.copy()
        jit[:h, :w] = s[:h, :w] * np.float32(0.7) + np.float32(0.1)
        out += [s, flip, jit][:1 + num_aug]
    return np.stack(out), np.repeat(sizes, 1 + num_aug, axis=0)


def aug_episode(batch, num_aug):
    """A ``make_episodic_batch`` dict with its supports expanded by
    ``aug_supports`` (unchanged for 0)."""
    if not num_aug:
        return batch
    pixels, sizes = aug_supports(batch["supp_pixels"], batch["supp_sizes"], num_aug)
    return dict(batch, supp_pixels=pixels, supp_sizes=sizes)


# Config A: the loader's augmentation (the flip and the PIL-free jitter),
# the conv merge and masked supports, through both CLIs with the fused head
# in eval; config B: the max merge of a support and its flip and 4 dense
# points per FCOS cell, trained on synthetic episodes (no loader)
SUPP_A = ["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", 2,
          "FEW_SHOT.SUPP_AUG_METHOD", "conv", "FEW_SHOT.MASK_SUPP", True]
SUPP_B = dict(opts=["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", 1,
                    "FEW_SHOT.SUPP_AUG_METHOD", "max", "MODEL.FCOS.DENSE_POINTS", 4],
              neg=False, adabound=False, extra=None, aug=1)
# config A's model on synthetic episodes (no loader, no mask): its steps and
# its eval forward once warm, beside the CLIs' first batches and steps
SUPP_A_MODEL = dict(opts=SUPP_A[:6], neg=False, adabound=False, extra=None, aug=2)
SUPP_CLI_BATCHES = 2          # eval CLI batches: one warm-up, one timed
SUPP_CLI_STEPS = 3            # train CLI steps: one warm-up, two timed
# the small float32 checks on the card against the CPU: the avg merge of 3
# variants, and 5 dense points
SUPP_SMALL = {
    "avg, 2 augs": dict(opts=["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", 2],
                        neg=False, adabound=False, extra=None, aug=2),
    "dense points 5": dict(opts=["MODEL.FCOS.DENSE_POINTS", 5], neg=False, adabound=False,
                           extra=None, aug=0),
}


def supp_aug_cli(flagship, dev, card, plain_loader_ms):
    """Phase 12a: config A at full width (the flagship, bf16, batch 8) on a
    synthetic COCO-style dataset with polygon segmentations
    (``write_synthetic_coco(segmentation=True)``): H1 bit for bit against
    its plain version on the first eval batch (8 queries and 24 supports,
    each support followed by its flip and its jitter, masked) in one launch;
    ``tools.test_net`` with the fused head over SUPP_CLI_BATCHES batches of
    a .pth of seed-1 weights (7 K1 and 1 K3 launches a batch, 1 H1 a batch);
    ``tools.train_net`` from that .pth for SUPP_CLI_STEPS steps (7 K1 and 7
    K1b launches a step, 1 H1 a batch): ms per batch and per step, the
    loader's host ms per batch, peak memory."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.data import build as data_build
    from oneshotdet_tpu_torch.data import make_data_loader
    from oneshotdet_tpu_torch.engine import trainer
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import resize
    from oneshotdet_tpu_torch.tools import test_net, train_net
    from oneshotdet_tpu_torch.utils import checkpoint as ckpt_mod
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

    paths, out = {}, {}
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann_file = write_synthetic_coco(root, num_images=DATA_IMAGES, sizes=DATA_SIZES,
                                                 box_side=DATA_BOX_SIDE, seed=0,
                                                 segmentation=True)
        env = {"ONESHOT_CUSTOM_IMG_DIR": img_dir, "ONESHOT_CUSTOM_ANN_FILE": ann_file}
        os.environ.update(env)
        opts = [str(v) for v in ["DATASETS.TRAIN", "('custom',)", "DATASETS.TEST",
                                 "('custom',)", "FEW_SHOT.TRAINING_EXCL_CATS", "[]",
                                 "TEST.IMS_PER_BATCH", BATCH, "SOLVER.IMS_PER_BATCH", BATCH,
                                 *SUPP_A]]
        cfg = default_cfg.clone()
        cfg.merge_from_file(flagship)
        cfg.merge_from_list(opts)
        model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        ckpt = os.path.join(root, "seed1.pth")
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
        del model
        torch.cuda.empty_cache()

        # H1 on the first augmented batch: 8 queries and 24 supports, one launch
        loader, _ = make_data_loader(cfg, is_train=False, device=dev)
        fresh = data_build.build_dataset(cfg, "custom", False)
        items = [fresh.load(fresh.plan(i)) for i in next(iter(loader.batch_iter()))]
        queries = [it["img"] for it in items]
        supports = [x for it in items for x in it["img_supp"]]
        first = queries[0]
        norm = (first["mean"], first["std"], first["to_bgr255"])
        query_bucket = loader.collator.query_bucket_for([q["out_hw"] for q in queries])
        packed = resize.pack_images([x["u8"] for x in queries + supports],
                                    [x["out_hw"] for x in queries + supports], dev,
                                    outputs=[0] * len(queries) + [1] * len(supports))
        slots = (resize.slot(query_bucket, *norm), resize.slot(SUPP_HW, *norm))
        out["h1_max_abs_err"] = h1_compare(
            resize, packed, slots, f"first augmented batch ({len(queries)} queries, "
            f"{len(supports)} supports: each with its flip and jitter, masked)")
        out["h1_support_slots"] = len(supports)
        if len(supports) != 3 * BATCH:
            raise AssertionError(f"first augmented batch: {len(supports)} supports")
        del loader, fresh, items, packed

        collector = _cli_logger()
        # -- the eval CLI with the fused head
        marks = []
        orig = _timed_loader(data_build, marks)
        os.environ["ONESHOT_PALLAS_ROI_HEAD"] = "1"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            rc = test_net.main(["--config-file", flagship, "--ckpt", ckpt, *opts, "OUTPUT_DIR",
                                os.path.join(root, "eval"), "FEW_SHOT.STOP_ITER",
                                str(SUPP_CLI_BATCHES)])
        finally:
            data_build.PrefetchingLoader.__iter__ = orig
            os.environ.pop("ONESHOT_PALLAS_ROI_HEAD", None)
        torch.cuda.synchronize()
        label = "supp aug A: eval CLI (test_net), fused head"
        paths[label] = n = read_launches()
        metrics, n_dets = check_eval_outputs(os.path.join(root, "eval", "eval"), label)
        if rc != 0 or n["roi_align"] != 7 * SUPP_CLI_BATCHES or \
                n["roi_head"] != SUPP_CLI_BATCHES or n["resize_normalize_pad"] != len(marks):
            raise AssertionError(f"{label}: exit {rc}, launches {n} for {SUPP_CLI_BATCHES} "
                                 f"batches ({len(marks)} handed over)")
        starts = [m[0] for m in marks]
        ms_batch = 1e3 * (starts[SUPP_CLI_BATCHES] - starts[1]) / (SUPP_CLI_BATCHES - 1)
        host_ms = [1e3 * (b - a) for a, b in marks]
        out["eval_cli"] = dict(ms_per_batch=ms_batch, loader_host_ms=host_ms, detections=n_dets,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                               k1_per_batch=n["roi_align"] // SUPP_CLI_BATCHES,
                               k3_per_batch=n["roi_head"] // SUPP_CLI_BATCHES)
        log(f"{label}: {SUPP_CLI_BATCHES} batches of {BATCH} (24 supports each), "
            f"{ms_batch:.1f} ms per batch over batches 2-{SUPP_CLI_BATCHES} (host clock, loader "
            f"included); loader host ms per batch {[round(v, 1) for v in host_ms]} (phase 8, "
            f"no augmentation: {[round(v, 1) for v in plain_loader_ms]}); per batch "
            f"{n['roi_align'] // SUPP_CLI_BATCHES} K1, {n['roi_head'] // SUPP_CLI_BATCHES} K3 "
            f"and 1 H1 launches; peak memory {out['eval_cli']['peak_gib']:.2f} GiB; {n_dets} "
            f"detections inside their images [{card}]")
        torch.cuda.empty_cache()

        # -- the train CLI from the .pth
        marks = []
        orig = _timed_loader(data_build, marks)
        collector.messages.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            with _TrainProbe(ckpt_mod, trainer, lambda *a: None) as probe:
                probe.max_iter = SUPP_CLI_STEPS
                rc = train_net.main(["--config-file", flagship, *opts, "MODEL.WEIGHT", ckpt,
                                     "SOLVER.MAX_ITER", str(SUPP_CLI_STEPS),
                                     "SOLVER.CHECKPOINT_PERIOD", str(10 * SUPP_CLI_STEPS),
                                     "OUTPUT_DIR", os.path.join(root, "train")])
        finally:
            data_build.PrefetchingLoader.__iter__ = orig
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = "supp aug A: train CLI (train_net)"
        paths[label] = n = read_launches()
        steps = probe.steps
        for st in steps:
            k = st["launches"]
            losses = {name: float(v) for name, v in st["metrics"].items()}
            if k["roi_align"] != 7 or k["roi_align_bwd"] != 7 or k["roi_head"] or \
                    not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"{label} step {st['it'] + 1}: launches {k}, losses {losses}")
            st["losses"] = losses
        if rc != 0 or len(steps) != SUPP_CLI_STEPS or \
                n["resize_normalize_pad"] != len(marks) or len(marks) != SUPP_CLI_STEPS:
            raise AssertionError(f"{label}: exit {rc}, {len(steps)} steps, launches {n} for "
                                 f"{len(marks)} batches")
        ms_step = 1e3 * (probe.end - marks[1][0]) / (SUPP_CLI_STEPS - 1)
        host_ms = [1e3 * (b - a) for a, b in marks]
        out["train_cli"] = dict(ms_per_step=ms_step, loader_host_ms=host_ms, peak_gib=peak,
                                losses=steps[-1]["losses"], k1_per_step=7, k1b_per_step=7)
        log(f"{label}: {SUPP_CLI_STEPS} steps from the .pth, {ms_step:.1f} ms/step over steps "
            f"2-{SUPP_CLI_STEPS} (host clock, loader included; bf16, batch {BATCH}, 24 "
            f"supports); loader host ms per batch {[round(v, 1) for v in host_ms]}; per step 7 "
            f"K1 and 7 K1b calls, 1 H1 launch a batch; peak memory {peak:.2f} GiB; losses "
            f"{steps[-1]['losses']} [{card}]")
        del steps, probe.steps
        logging.getLogger("oneshotdet_tpu_torch").handlers.clear()
        for key in env:
            os.environ.pop(key, None)
    torch.cuda.empty_cache()
    return paths, out


def supp_aug_eval_forward(cfg_path, dev, card, label, spec, fused):
    """Phase 12b: a config's eval forward (batch 8, 832x1216, bf16, phase
    5's batch, each support followed by ``spec["aug"]`` variants, seed-1
    weights): 7 K1 launches and 1 K3 with ``fused``, the detections checked;
    host ms of one forward after a warm-up."""
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.structures import ImageBatch

    images, supps = phase5_batch(dev)
    a = spec["aug"]
    pixels = torch.stack([x for s in supps.pixels for x in (s, s.flip(1), s * 0.7)[:1 + a]])
    supps = ImageBatch(pixels, supps.sizes.repeat_interleave(1 + a, dim=0))
    cfg = variant_cfg(cfg_path, spec["opts"])
    model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    model.config = dataclasses.replace(model.config, fused_roi_head=fused)
    model(images, supps)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    dets = model(images, supps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = read_launches()
    if n["roi_align"] != 7 or n["roi_head"] != int(fused):
        raise AssertionError(f"{label} eval forward: launches {n}")
    check_detections(dets, BATCH, min(cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                                      cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST), images.sizes_wh())
    log(f"{label} eval forward ({len(pixels)} supports{', fused head' if fused else ''}): "
        f"{ms:.1f} ms (host clock, one forward after a warm-up), {n['roi_align']} K1 and "
        f"{n['roi_head']} K3 launches, {int(dets.valid.sum())} detections [{card}]")
    del model, dets, images, supps
    torch.cuda.empty_cache()
    return dict(ms=ms), n


def supp_aug_path(cfg_path, dev, card, plain_loader_ms):
    """Phase 12: SUPP_AUG, MASK_SUPP and DENSE_POINTS on the card: config A
    through the loader and both CLIs (``supp_aug_cli``), A's model and
    config B on synthetic episodes (``variant_full_width``: 1 warm-up and 2
    timed steps) and their eval forwards (A's with the fused head), and the small float32
    forward and train steps of the avg merge of 3 variants and of 5 dense
    points against the CPU (``small_forward_check``,
    ``variant_small_check``)."""
    t_phase = time.perf_counter()
    paths, out = {}, {}
    for key, label, spec, fused in (
            ("a", "supp aug A's model: conv merge of 24 supports", SUPP_A_MODEL, True),
            ("b", "supp aug B: max merge + dense points 4", SUPP_B, False)):
        out[f"train_{key}"], paths[f"{label}, train steps"] = variant_full_width(
            cfg_path, dev, card, label, spec)
        out[f"eval_{key}"], paths[f"{label}, eval forward"] = supp_aug_eval_forward(
            cfg_path, dev, card, label, spec, fused)
        if key == "a":      # the CLIs after A's shapes have run once
            cli_paths, out["cli"] = supp_aug_cli(cfg_path, dev, card, plain_loader_ms)
            paths.update(cli_paths)
    out["small"] = {}
    for name, spec in SUPP_SMALL.items():
        n = small_forward_check(cfg_path, dev, opts=spec["opts"], aug=spec["aug"],
                                label=f" ({name})")
        out["small"][name] = dict(forward_detections=n,
                                  **variant_small_check(cfg_path, dev, name, spec))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['phase_s']:.1f} s")
    return paths, out


# -- phase 13: the mask and keypoint heads (MODEL.MASK_ON / KEYPOINT_ON) ------------

MK_OPTS = ["MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True]
MK_K1 = 9                      # K1 a forward or step: the 7 box-path pools + the two 14x14
MK_CLI_BATCHES = 2             # eval CLI batches: one warm-up, one timed
MK_CLI_STEPS = 3               # train CLI steps: one warm-up, two timed
MK_ITERS = 3                   # timed eval forwards
# the small float32 checks: narrow heads (the CPU side runs them over every slot)
MK_SMALL = MK_OPTS + ["MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(64, 64)",
                      "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", "(64, 64)", "TPU.MASK_RASTER", 28]
MK_MASK_ATOL = 1e-4            # mask probabilities, card against CPU (float32, TF32 off)
MK_ARGMAX_GAP = 1e-3           # keypoints compared where a heatmap's top two lie apart
# the heatmaps' softmax is blind to a constant added to a whole heatmap: this
# bias's gradient is zero, and both sides give rounding noise
MK_SHIFT_INVARIANT = {"roi_heads.keypoint.predictor.kps_score_lowres.bias":
                      "roi_heads.keypoint.predictor.kps_score_lowres.weight"}


def mk_cfg(flagship, *opts):
    from oneshotdet_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(flagship)
    cfg.merge_from_list(MK_OPTS + list(opts))
    return cfg


def check_mask_kp_fields(dets, label):
    """mask_probs (B, K, 28, 28) and keypoints (B, K, 17, 2 / -) of the
    detections: finite, the probabilities in [0, 1], each keypoint inside
    its box (cell centres of the box's heatmap)."""
    b, k = dets.valid.shape
    v = dets.valid
    probs = dets.get_field("mask_probs")
    xy, sc = dets.get_field("keypoints_xy"), dets.get_field("keypoints_scores")
    if probs.shape != (b, k, 28, 28) or probs.dtype != torch.float32 or \
            xy.shape != (b, k, 17, 2) or sc.shape != (b, k, 17):
        raise AssertionError(f"{label}: fields {tuple(probs.shape)} {probs.dtype}, "
                             f"{tuple(xy.shape)}, {tuple(sc.shape)}")
    p, x, s_ = probs[v], xy[v].float(), sc[v].float()
    if not (torch.isfinite(p).all() and float(p.min()) >= 0 and float(p.max()) <= 1
            and torch.isfinite(x).all() and torch.isfinite(s_).all()):
        raise AssertionError(f"{label}: non-finite or out-of-range masks or keypoints")
    box = dets.xyxy[v].float()
    lo, hi = box[:, None, :2] - 1e-2, torch.maximum(box[:, None, 2:], box[:, None, :2] + 1) + 1e-2
    if not bool(((x >= lo) & (x <= hi)).all()):
        raise AssertionError(f"{label}: a keypoint outside its box")
    return int(v.sum())


def mask_kp_eval_forwards(flagship, dev, card):
    """Phase 13c: the flagship with both heads at full width (mask 4 x 256,
    keypoint 8 x 512 with 17 keypoints, 14x14 pools on P4), bf16, batch 8
    832x1216, seed-1 weights: MK_ITERS timed eval forwards unfused and with
    the fused head (9 K1 launches a forward; 0 / 1 K3), ms, peak memory,
    the fields checked, one profiled forward each."""
    from oneshotdet_tpu_torch.models import build_detection_model

    cfg = mk_cfg(flagship)
    images, supps = phase5_batch(dev)
    model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    paths, out = {}, {}
    for fused in (False, True):
        cell = "mask+keypoint 2000/img" + (", fused head" if fused else "")
        model.config = dataclasses.replace(model.config, fused_roi_head=fused)
        dets = model(images, supps)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(MK_ITERS):
            dets = model(images, supps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / MK_ITERS
        peak = torch.cuda.max_memory_allocated() / 2**30
        paths[f"{cell}, {MK_ITERS} forwards"] = n = read_launches()
        if n["roi_align"] != MK_K1 * MK_ITERS or n["roi_head"] != (MK_ITERS if fused else 0):
            raise AssertionError(f"{cell}: launches {n} in {MK_ITERS} forwards, expected "
                                 f"{MK_K1} K1 and {int(fused)} K3 a forward")
        check_detections(dets, BATCH, 2000, images.sizes_wh())
        nd = check_mask_kp_fields(dets, cell)
        out[cell] = dict(ms=dt * 1e3, peak_gib=peak, k1_per_forward=MK_K1,
                         k3_per_forward=int(fused), detections=nd)
        log(f"eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, "
            f"{dt * 1e3:.1f} ms/batch, {BATCH / dt:.1f} img/s, peak memory {peak:.2f} GiB, {nd} "
            f"detections with masks and keypoints, {MK_K1} K1 launches a forward [{card}]")
        out[cell]["stages_ms"] = profile_forward(model, images, supps, cell)
    del model, dets, images, supps
    torch.cuda.empty_cache()
    return paths, out


def quiet_mask_kp_heads_(model, gen):
    """Redraw the mask and keypoint heads' conv weights at N(0, 0.01), biases
    0, for the CLI run's checkpoint. The seeded random backbone and FPN give
    features far larger than trained ones; from the heads' own init (the JAX
    package's kaiming- and lecun-normal) the train CLI's mask logits reach
    the thousands within three steps and a later step's boxes go NaN. The
    model's init stays as it is; only this smoke's weights are quieter."""
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if name.startswith(("roi_heads.mask.", "roi_heads.keypoint.")):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.01 if v.dim() > 1
                        else torch.zeros(v.shape))


def mask_kp_cli(flagship, dev, card):
    """Phase 13c: ``tools.test_net`` over MK_CLI_BATCHES batches of 8 on
    ``write_synthetic_coco(segmentation=True, keypoints=True)`` (a .pth of
    seed-1 weights, the heads' quieter, ``quiet_mask_kp_heads_``; 9 K1
    launches a batch; segm_* and keypoints_* present and finite) and ``tools.train_net`` from that .pth for MK_CLI_STEPS
    steps (9 K1 and 9 K1b a step; finite loss_mask and loss_kp)."""
    from oneshotdet_tpu_torch.data import build as data_build
    from oneshotdet_tpu_torch.engine import trainer
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.tools import test_net, train_net
    from oneshotdet_tpu_torch.utils import checkpoint as ckpt_mod
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

    paths, out = {}, {}
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann_file = write_synthetic_coco(root, num_images=DATA_IMAGES, sizes=DATA_SIZES,
                                                 box_side=DATA_BOX_SIDE, seed=0,
                                                 segmentation=True, keypoints=True)
        env = {"ONESHOT_CUSTOM_IMG_DIR": img_dir, "ONESHOT_CUSTOM_ANN_FILE": ann_file}
        os.environ.update(env)
        opts = [str(v) for v in ["DATASETS.TRAIN", "('custom',)", "DATASETS.TEST",
                                 "('custom',)", "FEW_SHOT.TRAINING_EXCL_CATS", "[]",
                                 "TEST.IMS_PER_BATCH", BATCH, "SOLVER.IMS_PER_BATCH", BATCH,
                                 *MK_OPTS]]
        cfg = mk_cfg(flagship, *opts)
        model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        quiet_mask_kp_heads_(model, torch.Generator().manual_seed(2))
        ckpt = os.path.join(root, "seed1.pth")
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
        del model
        torch.cuda.empty_cache()
        collector = _cli_logger()
        marks = []
        orig = _timed_loader(data_build, marks)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            rc = test_net.main(["--config-file", flagship, "--ckpt", ckpt, *opts, "OUTPUT_DIR",
                                os.path.join(root, "eval"), "FEW_SHOT.STOP_ITER",
                                str(MK_CLI_BATCHES)])
        finally:
            data_build.PrefetchingLoader.__iter__ = orig
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = "mask+keypoint: eval CLI (test_net)"
        paths[label] = n = read_launches()
        metrics, n_dets = check_eval_outputs(os.path.join(root, "eval", "eval"), label)
        want = {f"segm_{k}" for k in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1",
                                      "AR@10", "AR@100")}
        want |= {f"keypoints_{k}" for k in ("AP", "AP50", "AP75", "APm", "APl", "AR@20")}
        if rc != 0 or n["roi_align"] != MK_K1 * MK_CLI_BATCHES or not want <= set(metrics):
            raise AssertionError(f"{label}: exit {rc}, launches {n} for {MK_CLI_BATCHES} "
                                 f"batches, metrics {sorted(metrics)}")
        out["eval_cli"] = dict(metrics={k: metrics[k] for k in sorted(want | {"AP"})},
                               detections=n_dets, wall_s=wall,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                               k1_per_batch=MK_K1)
        log(f"{label}: {MK_CLI_BATCHES} batches of {BATCH}, {wall:.1f} s in all with the "
            f"evaluation (host clock; the segm pass pastes each episode's best 100 masks); "
            f"{MK_K1} K1 launches a batch; {n_dets} detections; "
            f"AP {metrics['AP']:.4f}, segm_AP {metrics['segm_AP']:.4f}, keypoints_AP "
            f"{metrics['keypoints_AP']:.4f} (random weights) [{card}]")
        torch.cuda.empty_cache()

        marks = []
        orig = _timed_loader(data_build, marks)
        collector.messages.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            with _TrainProbe(ckpt_mod, trainer, lambda *a: None) as probe:
                probe.max_iter = MK_CLI_STEPS
                rc = train_net.main(["--config-file", flagship, *opts, "MODEL.WEIGHT", ckpt,
                                     "SOLVER.MAX_ITER", str(MK_CLI_STEPS),
                                     "SOLVER.CHECKPOINT_PERIOD", str(10 * MK_CLI_STEPS),
                                     "OUTPUT_DIR", os.path.join(root, "train")])
        finally:
            data_build.PrefetchingLoader.__iter__ = orig
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = "mask+keypoint: train CLI (train_net)"
        paths[label] = n = read_launches()
        steps = probe.steps
        for st in steps:
            k = st["launches"]
            losses = {name: float(v) for name, v in st["metrics"].items()}
            if k["roi_align"] != MK_K1 or k["roi_align_bwd"] != MK_K1 or \
                    not {"loss_mask", "loss_kp"} <= set(losses) or \
                    not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"{label} step {st['it'] + 1}: launches {k}, losses {losses}")
            st["losses"] = losses
        if rc != 0 or len(steps) != MK_CLI_STEPS:
            raise AssertionError(f"{label}: exit {rc}, {len(steps)} steps")
        ms_step = 1e3 * (probe.end - steps[1]["t0"]) / (MK_CLI_STEPS - 1)
        out["train_cli"] = dict(ms_per_step=ms_step, peak_gib=peak, losses=steps[-1]["losses"],
                                k1_per_step=MK_K1, k1b_per_step=MK_K1)
        log(f"{label}: {MK_CLI_STEPS} steps from the .pth, {ms_step:.1f} ms/step over steps "
            f"2-{MK_CLI_STEPS} (host clock from step 2's entry, loader included; bf16, batch "
            f"{BATCH}); per step {MK_K1} K1 and {MK_K1} K1b calls; peak memory {peak:.2f} GiB; "
            f"losses {steps[-1]['losses']} [{card}]")
        del steps, probe.steps
        logging.getLogger("oneshotdet_tpu_torch").handlers.clear()
        for key in env:
            os.environ.pop(key, None)
    torch.cuda.empty_cache()
    return paths, out


def _mk_batch(seed):
    """A small episode batch (2 x 128x160 queries, 64x64 supports) with GT
    mask rasters (28^2) and 17 keypoints per GT inside its box."""
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    batch = make_episodic_batch(2, (128, 160), (64, 64), max_gt=4, seed=seed)
    rng = np.random.RandomState(seed)
    gt, v = batch["gt_xyxy"], batch["gt_valid"]
    masks = (rng.rand(2, 4, 28, 28) > 0.5).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (2, 2, 4, 17))
    kps = np.stack([gt[..., None, 0] + u[0] * (gt[..., None, 2] - gt[..., None, 0]),
                    gt[..., None, 1] + u[1] * (gt[..., None, 3] - gt[..., None, 1]),
                    rng.choice([0, 1, 2], (2, 4, 17))], -1).astype(np.float32)
    return dict(batch, gt_masks=masks * v[..., None, None],
                gt_keypoints=kps * v[..., None, None])


def mask_kp_small_checks(flagship, dev):
    """Phase 13c: small float32 checks of both heads (64-wide, the
    flagship's SMALL capacities), card against CPU with the same weights
    (``distinct_weights_``), TF32 off: an eval forward (detections as
    ``match_detections``; each matched detection's mask within MK_MASK_ATOL
    and its keypoints within 1e-3 px where its heatmap's two largest values
    lie more than MK_ARGMAX_GAP apart) and a train step (cuDNN off, the
    card's ReLUs at the CPU's branch within rounding of their kink,
    ``follow_kinks``, the heads' included: losses within rtol 5e-4, each
    gradient within 1e-3 relative norm; kps_score_lowres.bias, whose
    gradient is zero, within 1e-6 of its weight's)."""
    from oneshotdet_tpu_torch.engine import batch_to_inputs
    from oneshotdet_tpu_torch.models import build_detection_model

    cfg = mk_cfg(flagship, *SMALL, *MK_SMALL)
    cpu = build_detection_model(cfg, device="cpu")
    distinct_weights_(cpu, torch.Generator().manual_seed(41))
    gpu = build_detection_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    batch = _mk_batch(42)
    heat = {}
    hooks = [m.roi_heads.keypoint.register_forward_hook(
        lambda mod, i, o, d=d: heat.__setitem__(d, o.detach().float().cpu()))
        for m, d in ((cpu, "cpu"), (gpu, "card"))]
    outs = {}
    for m, d in ((cpu, "cpu"), (gpu, dev)):
        images, supp, _ = batch_to_inputs(batch, d)
        outs["cpu" if m is cpu else "card"] = m(images, supp)
    for h in hooks:
        h.remove()
    ref, got = outs["cpu"], outs["card"]
    worst_mask = worst_kp = 0.0
    clear = ties = 0
    b, k = ref.valid.shape
    flat = {d: heat[d].permute(0, 3, 1, 2).reshape(b, k, 17, -1) for d in heat}
    for i in range(b):
        def valid_dets(x):
            v = x.valid[i].cpu().numpy()
            return x.xyxy[i].cpu().numpy()[v], x.get_field("scores")[i].cpu().numpy()[v]
        match_detections(valid_dets(got), valid_dets(ref))
        _, j, _ = _best_partners(valid_dets(ref), valid_dets(got), 5e-4, 1e-3)
        rv = np.nonzero(ref.valid[i].cpu().numpy())[0]
        gv = np.nonzero(got.valid[i].cpu().numpy())[0]
        for a, bj in zip(rv, gv[j]):
            d = float((got.get_field("mask_probs")[i, bj].cpu()
                       - ref.get_field("mask_probs")[i, a]).abs().max())
            worst_mask = max(worst_mask, d)
            top2 = torch.topk(flat["cpu"][i, a], 2, dim=-1).values
            c = (top2[:, 0] - top2[:, 1]) > MK_ARGMAX_GAP
            dxy = (got.get_field("keypoints_xy")[i, bj].cpu() - ref.get_field("keypoints_xy")[i, a])
            if bool(c.any()):
                worst_kp = max(worst_kp, float(dxy[c].abs().max()))
            clear += int(c.sum())
            ties += int((~c).sum())
    if worst_mask > MK_MASK_ATOL or worst_kp > 1e-3 or clear == 0:
        raise AssertionError(f"small mask+keypoint forward: masks {worst_mask:.2e} (tolerance "
                             f"{MK_MASK_ATOL}), keypoints {worst_kp:.2e} px over {clear} clear "
                             f"heatmaps")
    log(f"small float32 mask+keypoint forward, card against CPU (TF32 off): detections match, "
        f"masks within {worst_mask:.2e}, keypoints within {worst_kp:.2e} px on {clear} heatmaps "
        f"with a clear maximum ({ties} near-ties not compared)")
    draws = torch.rand((2, cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + cfg.TPU.MAX_GT_BOXES),
                       generator=torch.Generator().manual_seed(43))

    def step(model, d, kinks):
        model.train()
        with kinks:
            losses = model.forward_train(*batch_to_inputs(batch, d), draws=draws.to(d))
            sum(losses.values()).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n_: p.grad.detach().cpu() for n_, p in model.named_parameters()
                 if p.grad is not None})

    record = follow_kinks()
    lc, gc = step(cpu, "cpu", record)
    follow = follow_kinks(record.calls)
    torch.backends.cudnn.enabled = False
    try:
        lg, gg = step(gpu, dev, follow)
    finally:
        torch.backends.cudnn.enabled = True
    del gpu, cpu, record
    if gc.keys() != gg.keys() or lc.keys() != lg.keys() or not {"loss_mask", "loss_kp"} <= set(lc):
        raise AssertionError("small mask+keypoint step: card and CPU differ in their losses or "
                             "in which parameters have gradients")
    loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    for name, weight in MK_SHIFT_INVARIANT.items():
        scale = float(gc[weight].norm())
        if max(float(gc[name].norm()), float(gg[name].norm())) > 1e-6 * scale:
            raise AssertionError(f"small mask+keypoint step: {name} gradient not ~0")
    rel = sorted(((float((gg[k] - v).norm() / v.norm().clamp(min=1e-30)), k)
                  for k, v in gc.items() if float(v.norm()) > 0 and k not in MK_SHIFT_INVARIANT),
                 reverse=True)
    log(f"small float32 mask+keypoint train step, card against CPU (cuDNN off, TF32 off): "
        f"losses within {loss_rel:.2e} relative, worst gradient {rel[0][0]:.2e} relative norm "
        f"({rel[0][1]}); {follow.taken} activation elements at the CPU's branch; losses {lc}")
    if loss_rel > 5e-4 or rel[0][0] > 1e-3:
        raise AssertionError(f"small mask+keypoint step: losses {loss_rel:.2e} (rtol 5e-4), "
                             f"gradients {rel[0][0]:.2e} (bound 1e-3)")
    return dict(mask_max_abs_err=worst_mask, keypoint_max_px_err=worst_kp,
                keypoints_compared=clear, keypoint_near_ties=ties, loss_rel=loss_rel,
                grad_rel=rel[0][0], kink_elements_taken=follow.taken)


def mask_kp_predictor(flagship, dev, card, supp, frame):
    """Phase 13c: ``OneShotPredictor`` with both heads at full width (bf16,
    seed-1 weights): ``set_support`` (6 K1), ``run_on_image(...,
    return_masks=True)`` and ``run_on_opencv_image`` on one frame (3 K1 a
    frame: the 7x7 and the two 14x14 pools)."""
    from oneshotdet_tpu_torch.predictor import OneShotPredictor

    reset_launches()
    pred = OneShotPredictor(mk_cfg(flagship), confidence_threshold=0.0, device=dev,
                            generator=torch.Generator().manual_seed(1))
    pred.set_support(supp)
    t0 = time.perf_counter()
    boxes, scores, masks = pred.run_on_image(frame, return_masks=True)
    ms = (time.perf_counter() - t0) * 1e3
    bgr = np.ascontiguousarray(frame[:, :, ::-1])
    t0 = time.perf_counter()
    drawn = pred.run_on_opencv_image(bgr)
    draw_ms = (time.perf_counter() - t0) * 1e3
    n = read_launches()
    if n["roi_align"] != 6 + 2 * 3:
        raise AssertionError(f"predictor with masks: launches {n}, expected 6 + 2 x 3 K1")
    if not (len(scores) and masks.shape == (len(scores), 28, 28) and np.isfinite(masks).all()
            and drawn.shape == bgr.shape and not np.array_equal(drawn, bgr)):
        raise AssertionError(f"predictor with masks: {len(scores)} detections, masks "
                             f"{masks.shape}, frame {drawn.shape}")
    log(f"predictor with masks and keypoints: frame {frame.shape[0]}x{frame.shape[1]}, "
        f"{len(scores)} detections with masks, run_on_image {ms:.1f} ms, run_on_opencv_image "
        f"{draw_ms:.1f} ms (host clock, first frames, contours drawn on the host) [{card}]")
    del pred
    torch.cuda.empty_cache()
    return {"predictor with masks": n}, dict(ms=ms, opencv_ms=draw_ms, detections=len(scores))


def mask_kp_path(flagship, dev, card, supp, frame):
    """Phase 13: K1 and K1b at 14x14 (13a-b, ``mask_kp_kernel_checks``),
    then the flagship with MASK_ON and KEYPOINT_ON (13c): eval forwards,
    the CLIs, the small float32 checks and the predictor."""
    from oneshotdet_tpu_torch.ops import roi_align as ra

    kernels = mask_kp_kernel_checks(ra, dev)
    paths, out = mask_kp_eval_forwards(flagship, dev, card)
    cli_paths, out["cli"] = mask_kp_cli(flagship, dev, card)
    paths.update(cli_paths)
    out["small"] = mask_kp_small_checks(flagship, dev)
    pred_paths, out["predictor"] = mask_kp_predictor(flagship, dev, card, supp, frame)
    paths.update(pred_paths)
    return paths, out, kernels


# -- phase 14: TPU.QUANT ('int8', 'int8_weight') ------------------------------------

QUANT_MODES = ("int8", "int8_weight")
QUANT_ITERS = 5                # timed eval forwards of each preset cell
QUANT_FORCE_RTOL = 1e-4        # an int8 layer's own input on the card, of max|CPU input|
# the stated drift bound of 'int8' (configs/oneshot_fcos_r50_fast_eval.yaml:13-20)
QUANT_BOUND = {"match_rate@0.9": 1.0, "matched_score_mae": 1.5e-3}


class int8_forced:
    """Context over a port model: record (``calls`` None) or replay the
    inputs of its int8 layers (``QuantConv2d``, ``QuantLinear``) and of its
    relation head (compress_0's int8 halves). Replaying on the card, each
    call checks its own input against the CPU's within QUANT_FORCE_RTOL of
    the input's maximum, takes the CPU's, and must give the CPU's output bit
    for bit (the int32 sums are exact on both). 'int8' is discontinuous: a
    float rounding difference before a quantizer (cuDNN against the CPU's
    convs) moves a code across a rounding boundary now and then, and that
    step (1/127 of the tensor's maximum) moves every code after it; replaying
    holds each float chain and each int8 layer apart."""

    def __init__(self, model, calls=None):
        from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead
        from oneshotdet_tpu_torch.ops.quant import QuantConv2d, QuantLinear

        self.model, self.calls = model, calls
        self.record = calls is None
        self.mods = {n: m for n, m in model.named_modules()
                     if isinstance(m, (QuantConv2d, QuantLinear, ROIBoxHead))}
        self.layers = 0

    def __enter__(self):
        if self.record:
            self.calls = {n: [] for n in self.mods}
        self.seen = {n: 0 for n in self.mods}
        self.handles = []
        for name, mod in self.mods.items():
            self.handles.append(mod.register_forward_pre_hook(self._pre(name)))
            if not name.endswith("box"):
                self.handles.append(mod.register_forward_hook(self._post(name)))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def _pre(self, name):
        def hook(mod, args):
            n_in = 1 if not name.endswith("box") else 2
            if self.record:
                self.calls[name].append([[None if a is None else a.detach().cpu()
                                          for a in args[:n_in]], None])
                return None
            k = self.seen[name]
            self.seen[name] = k + 1
            ins, _ = self.calls[name][k]
            new = []
            for a, ref in zip(args[:n_in], ins):
                if a is None:          # the head's ROI features under the hoist
                    new.append(None)
                    continue
                err = float((a.detach().float().cpu() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                if err > QUANT_FORCE_RTOL * max(scale, 1e-30):
                    raise AssertionError(f"int8 {name} call {k}: input {err:.3e} from the "
                                         f"CPU's, beyond {QUANT_FORCE_RTOL} x {scale:.3e}")
                fmt = torch.channels_last if ref.dim() == 4 and a.is_contiguous(
                    memory_format=torch.channels_last) else torch.contiguous_format
                new.append(ref.to(a.device).contiguous(memory_format=fmt))
            self.layers += 1
            return tuple(new) + tuple(args[n_in:])
        return hook

    def _post(self, name):
        def hook(mod, args, out):
            if self.record:
                self.calls[name][-1][1] = out.detach().cpu()
                return
            want = self.calls[name][self.seen[name] - 1][1]
            if not torch.equal(out.detach().cpu(), want):
                raise AssertionError(f"int8 {name}: output on the card differs from the CPU's "
                                     f"on the same input")
        return hook


def quant_small_checks(flagship, dev):
    """Phase 14a: small float32 forwards with TPU.QUANT 'int8' and
    'int8_weight' (batch 2, 128x160 queries, 64x64 supports, narrow mask and
    keypoint heads on) on the card against the same forward on the CPU, the
    same weights: detections within the detection tolerances (score rtol
    5e-4, box rtol 1e-3), mask probabilities within MK_MASK_ATOL where both
    detect the same box; 'int8' replayed (``int8_forced``), every int8 layer
    bit for bit on the CPU's input. 'int8_weight' also with its weights as
    int8 codes (``quantize_weights_int8``): bit for bit against its
    fake-quantized float weights on the card."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops.quant import quantize_weights_int8
    from oneshotdet_tpu_torch.structures import ImageBatch

    gen = torch.Generator().manual_seed(11)
    q = torch.randn(2, 128, 160, 3, generator=gen) * 50
    s = torch.randn(2, 64, 64, 3, generator=gen) * 50
    qs = torch.tensor([[128.0, 160.0], [100.0, 150.0]])
    ss = torch.tensor([[64.0, 64.0], [60.0, 40.0]])
    out = {}
    for mode in QUANT_MODES:
        cfg = default_cfg.clone()
        cfg.merge_from_file(flagship)
        cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_PRE_TOPK", 1024,
                             "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 128,
                             "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 64, "TPU.QUANT", mode,
                             *MK_SMALL])
        cpu = build_detection_model(cfg, device="cpu")
        distinct_weights_(cpu, torch.Generator().manual_seed(12))
        gpu = build_detection_model(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        with int8_forced(cpu) as rec:
            ref = cpu(ImageBatch(q, qs), ImageBatch(s, ss))
        args = (ImageBatch(q.to(dev), qs.to(dev)), ImageBatch(s.to(dev), ss.to(dev)))
        reset_launches()
        if mode == "int8":
            with int8_forced(gpu, rec.calls) as rep:
                got = gpu(*args)
            layers = rep.layers
        else:
            got, layers = gpu(*args), 0
        n_launch = read_launches()
        if n_launch["roi_align"] != MK_K1:
            raise AssertionError(f"quant {mode} small forward: launches {n_launch}")
        n, mask_err = 0, 0.0
        for i in range(2):
            def dets(d):
                v = d.valid[i].cpu().numpy()
                return (d.xyxy[i].cpu().numpy()[v], d.get_field("scores")[i].cpu().numpy()[v])
            match_detections(dets(got), dets(ref))
            n += int(got.valid[i].sum())
            ok, j, _ = _best_partners(dets(got), dets(ref), 5e-4, 1e-3)
            gm = got.get_field("mask_probs")[i].cpu().numpy()[got.valid[i].cpu().numpy()]
            rm = ref.get_field("mask_probs")[i].cpu().numpy()[ref.valid[i].cpu().numpy()]
            if ok.any():
                mask_err = max(mask_err, float(np.abs(gm[ok] - rm[j[ok]]).max()))
        if mask_err > MK_MASK_ATOL:
            raise AssertionError(f"quant {mode}: mask probabilities {mask_err:.3e} from the CPU's")
        entry = dict(detections=n, mask_max_abs_err=mask_err, replayed_int8_calls=layers,
                     k1_per_forward=n_launch["roi_align"])
        if mode == "int8_weight":
            codes = build_detection_model(cfg, device=dev)
            codes.load_state_dict(cpu.state_dict(), strict=True)
            quantize_weights_int8(codes)
            n8 = sum(int(p.dtype == torch.int8) for p in codes.parameters())
            again = codes(*args)
            for a, b in ((again.xyxy, got.xyxy), (again.get_field("scores"),
                                                  got.get_field("scores"))):
                if not torch.equal(a, b):
                    raise AssertionError("int8_weight: int8 codes differ from fake-quant")
            entry["int8_weight_tensors"] = n8
            del codes
        out[mode] = entry
        log(f"quant {mode} small float32 forward (mask and keypoint heads on): {n} detections "
            f"on the card match the CPU (score rtol 5e-4, box rtol 1e-3), masks within "
            f"{mask_err:.2e}" + (f", {layers} int8 calls replayed from the CPU, each output bit "
                                 f"for bit" if mode == "int8" else
                                 f", the int8-code weights ({entry['int8_weight_tensors']} "
                                 f"tensors) bit for bit with fake-quant")
            + f"; {MK_K1} K1 launches")
        del cpu, gpu
    torch.cuda.empty_cache()
    return out


def quant_preset_cells(preset, dev, card):
    """Phase 14b: the fast-eval preset (EVAL_ROI_TOPK=512) at full width, bf16,
    batch 8 832x1216 / 416x416 (phase 5's batch), seed-1 weights, with
    TPU.QUANT none, int8, int8_weight (fake-quant per call) and int8_weight
    with int8 codes: ms/batch over QUANT_ITERS forwards by CUDA events, peak
    memory, K1 launches (7 a forward), detections checked, one profiled
    forward each."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops.quant import quantize_weights_int8

    images, supps = phase5_batch(dev)
    paths, out = {}, {}
    for mode, codes in (("none", False), ("int8", False), ("int8_weight", False),
                        ("int8_weight", True)):
        c = default_cfg.clone()
        c.merge_from_file(preset)
        c.merge_from_list(["TPU.QUANT", mode])
        model = build_detection_model(c, device=dev, generator=torch.Generator().manual_seed(1))
        if codes:
            quantize_weights_int8(model)
        cell = f"preset, TPU.QUANT {mode}" + (" (int8 codes)" if codes else "")
        dets = model(images, supps)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(QUANT_ITERS):
            dets = model(images, supps)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / QUANT_ITERS
        peak = torch.cuda.max_memory_allocated() / 2**30
        paths[f"{cell}, {QUANT_ITERS} forwards"] = n = read_launches()
        if n["roi_align"] != 7 * QUANT_ITERS or n["roi_head"] != 0:
            raise AssertionError(f"{cell}: launches {n} in {QUANT_ITERS} forwards")
        check_detections(dets, BATCH, 512, images.sizes_wh())
        out[cell] = dict(ms=ms, peak_gib=peak, k1_per_forward=7,
                         detections=int(dets.valid.sum()))
        log(f"eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, {ms:.1f} "
            f"ms/batch (CUDA events over {QUANT_ITERS}), {BATCH / ms * 1e3:.1f} img/s, peak "
            f"memory {peak:.2f} GiB, {out[cell]['detections']} detections, 7 K1 launches a "
            f"forward [{card}]")
        out[cell]["stages_ms"] = profile_forward(model, images, supps, cell)
        del model, dets
        torch.cuda.empty_cache()
    return paths, out


def quant_drift_reports(dev, card):
    """Phase 14c: ``tools.quant_drift`` at production capacities (PRE_NMS
    6000, POST 2000, 2000 detections, batch 8 832x1216 / 416x416, the tool's
    seeded inputs and seed-0 weights): 'int8' and 'int8_weight' against the
    bf16 float forward, beside the configuration's stated bound for 'int8'."""
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.tools import quant_drift as qd

    images, supps = qd.seeded_inputs(BATCH, QUERY_HW, SUPP_HW, 20260818, dev)
    dets = {}
    for mode in ("none",) + QUANT_MODES:
        model = build_detection_model(qd.make_cfg(mode), device=dev,
                                      generator=torch.Generator().manual_seed(0))
        dets[mode] = qd.detections(model, images, supps)
        del model
        torch.cuda.empty_cache()
    out = {}
    for mode in QUANT_MODES:
        out[mode] = r = qd.drift_report(dets["none"], dets[mode])
        log(f"quant_drift {mode} vs bf16 float (6000/2000/2000, batch {BATCH}): "
            + json.dumps(r) + f"; stated bound for int8: {json.dumps(QUANT_BOUND)} [{card}]")
    return out


def quant_artifact(flagship, dev, card, supp, frames):
    """Phase 14d: the flagship bf16 with TPU.QUANT 'int8_weight' and int8
    codes (seed-12 distinct weights, ``quantize_weights_int8``): its batch-1
    serving bundle as ExportedPrograms (``ArtifactPredictor``, bit for bit
    against ``OneShotPredictor`` on phase 4's support and frames) and its
    support program (the support backbone's int8 codes) compiled by
    AOTInductor and loaded in that route's place (at least
    ARTIFACT_MIN_SHARE of a frame's detections within one bf16 ulp of the
    eager ones, as phase 10's compiled route; the support program holds a
    third of the detect program's layers and compiles in a fraction of its
    time); K1 6 per
    ``set_support`` and 1 per frame from inside the programs; export,
    compile and load seconds, ms per frame."""
    from oneshotdet_tpu_torch import export as oexport
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.ops.quant import quantize_weights_int8
    from oneshotdet_tpu_torch.predictor import ArtifactPredictor, OneShotPredictor

    cfg = default_cfg.clone()
    cfg.merge_from_file(flagship)
    cfg.merge_from_list(["TPU.QUANT", "int8_weight"])
    eager = OneShotPredictor(cfg, confidence_threshold=0.0, query_bucket=QUERY_HW,
                             supp_bucket=SUPP_HW, device=dev,
                             generator=torch.Generator().manual_seed(1))
    distinct_weights_(eager.model, torch.Generator().manual_seed(12))
    quantize_weights_int8(eager.model)
    zero = {k: 0 for k in _counters()}
    out = {}
    with tempfile.TemporaryDirectory() as root:
        stem = os.path.join(root, "int8_weight")
        t0 = time.perf_counter()
        oexport.export_serving(cfg, eager.model, stem, query_hw=QUERY_HW, supp_hw=SUPP_HW,
                               compile_executable=False)
        out["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        exported = ArtifactPredictor(stem, device=dev)
        out["load_s"] = time.perf_counter() - t0
        support = oexport.load(stem + ".support")
        int8_tensors = sum(int(v.dtype == torch.int8) for v in support.state_dict.values())
        t0 = time.perf_counter()
        if not oexport.save_compiled(support, stem + ".support"):
            raise AssertionError("quant artifact: the support program did not compile")
        out["compile_support_s"] = time.perf_counter() - t0
        out["mib"] = {ext: os.path.getsize(stem + ext) / 2**20
                      for ext in (".support", ".detect", ".support.exec")}
        # the exported route with the compiled support program in its place
        compiled = copy.copy(exported)
        t0 = time.perf_counter()
        compiled._sup_call = oexport.load_compiled(stem + ".support", device=dev)
        out["load_compiled_s"] = time.perf_counter() - t0
        del support
        eager.set_support(supp)
        shares = []
        for route, ap in (("exported", exported), ("compiled", compiled)):
            reset_launches()
            ap.set_support(supp)
            torch.cuda.synchronize()
            if read_launches() != dict(zero, roi_align=6):
                raise AssertionError(f"quant artifact {route} set_support: {read_launches()}")
            for frame in frames:
                want = eager.run_on_image(frame)
                reset_launches()
                got = ap.run_on_image(frame)
                torch.cuda.synchronize()
                if read_launches() != dict(zero, roi_align=1):
                    raise AssertionError(f"quant artifact {route} frame: {read_launches()}")
                if route == "exported":
                    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                        raise AssertionError("quant artifact: the ExportedProgram route "
                                             "differs from OneShotPredictor")
                else:
                    shares.append((match_fraction(got, want, ARTIFACT_RTOL, ARTIFACT_RTOL),
                                   match_fraction(got, want)))
        if min(sh[0] for sh in shares) < ARTIFACT_MIN_SHARE:
            raise AssertionError(f"quant artifact compiled: shares {shares}")
        out["compiled_paired_share"] = shares
        out["frame_ms"] = {"OneShotPredictor": _frame_ms(eager, frames, 1),
                           "exported": _frame_ms(exported, frames, 1)}
        t0 = time.perf_counter()
        for _ in range(3):
            compiled.set_support(supp)
        torch.cuda.synchronize()
        out["set_support_ms"] = {"compiled support": (time.perf_counter() - t0) / 3 * 1e3}
        t0 = time.perf_counter()
        for _ in range(3):
            exported.set_support(supp)
        torch.cuda.synchronize()
        out["set_support_ms"]["exported"] = (time.perf_counter() - t0) / 3 * 1e3
        log(f"quant artifact int8_weight (int8 codes, {int8_tensors} int8 tensors in the support "
            f"program): export {out['export_s']:.1f} s, AOTInductor compile of the support "
            f"program {out['compile_support_s']:.1f} s, files "
            + ", ".join(f"{k} {v:.1f} MiB" for k, v in out["mib"].items())
            + f"; the ExportedProgram route equals OneShotPredictor bit for bit over "
            f"{len(frames)} frames; with the compiled support program, the share within one "
            f"bf16 ulp {[sh[0] for sh in shares]} (within 5e-4 / 1e-3 "
            f"{[sh[1] for sh in shares]}); 6 K1 per set_support, 1 per frame; ms per frame "
            + ", ".join(f"{k} {v:.2f}" for k, v in out["frame_ms"].items())
            + "; ms per set_support (host clock) "
            + ", ".join(f"{k} {v:.2f}" for k, v in out["set_support_ms"].items()) + f" [{card}]")
    del eager, exported, compiled
    torch.cuda.empty_cache()
    return out


def quant_path(flagship, preset, dev, card, supp, frames):
    """Phase 14: TPU.QUANT on the card (14a-d)."""
    t_phase = time.perf_counter()
    out = {"small": quant_small_checks(flagship, dev)}
    paths, out["preset"] = quant_preset_cells(preset, dev, card)
    out["drift"] = quant_drift_reports(dev, card)
    out["artifact"] = quant_artifact(flagship, dev, card, supp, frames)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14: {out['phase_s']:.1f} s")
    return paths, out


# -- phase 15: the anchor stage 1 (MODEL.FCOS_ON False) ---------------------------------

# cell A: the anchor RPN feeding stage 2; cell B: one-stage RetinaNet
ANCHOR_A = ["MODEL.FCOS_ON", False, "MODEL.RPN.ANCHOR_STRIDE", "(8, 16, 32, 64, 128)"]
ANCHOR_B = ANCHOR_A + ["MODEL.RETINANET_ON", True, "MODEL.RPN_ONLY", True]
# per cell: its overrides, and K1 a forward, K1 (and K1b calls) a train step
ANCHOR_CELLS = {"A anchor RPN": (ANCHOR_A, 7, 7), "B RetinaNet RPN_ONLY": (ANCHOR_B, 6, 5)}
# the train cells' learning rate: the seeded random backbones give a fused
# pyramid of ~10^3, and one SGD step at the flagship's 5e-4 sends the RPN's
# deltas to ~10^3 (loss_rpn_box_reg 7.8 -> 1124), its proposals below a
# pixel and the next step's loss_box_reg to NaN; a step's work is the same
ANCHOR_TRAIN = ["SOLVER.BASE_LR", 1e-6]
ANCHOR_ITERS = 3                      # timed eval forwards of a cell
ANCHOR_WARMUP, ANCHOR_STEPS = 2, 5    # train steps of a cell, each on a fresh batch
ANCHOR_CLI_BATCHES, ANCHOR_CLI_STEPS = 2, 3
ANCHOR_STAGES = ("query_backbone", "support_backbone", "support_pool", "rpn_head",
                 "rpn_postprocess", "retinanet_head", "retinanet_postprocess", "roi_pool",
                 "roi_head", "roi_postprocess")


def anchor_cfg(flagship, opts, *more):
    from oneshotdet_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(flagship)
    cfg.merge_from_list(list(opts) + list(more))
    return cfg


def quiet_anchor_head_(model, gen):
    """Redraw the anchor head's kernels for this smoke's seeded weights,
    whose fused pyramid (random backbones, the query times the pooled
    support) reaches ~10^3 at full width and after ``distinct_weights_``
    alike: from the model's init (N(0, 0.01), the JAX package's) the RPN's
    deltas reach ~900 and shrink proposals below a pixel, where x2 - x1 + 1
    rounds to 0 or below (the same arithmetic as the JAX package's), their
    stage-2 regression targets are not finite and loss_box_reg is NaN; at
    N(0, 1/fan_in) RetinaNet's logits saturate the sigmoid, whose ties then
    decide a card-against-CPU comparison (at its init's N(0, 0.01) its
    logits still reach ~70). The RPN head's conv and cls_logits at
    N(0, 0.001) and its bbox_pred at N(0, 0.0001) (deltas within ~1), and
    RetinaNet's five convs at N(0, 0.005) keep their outputs near 1. The
    model's init stays as it is."""
    retina = model.config.stage1 == "retinanet"
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if name.startswith("rpn.head.") and v.dim() > 1:
                std = 5e-3 if retina else 1e-4 if "bbox_pred" in name else 1e-3
                v.copy_(torch.randn(v.shape, generator=gen) * std)


def anchor_eval_forwards(flagship, dev, card):
    """Phase 15a: each cell's eval forward (bf16, batch 8 832x1216, phase 5's
    batch, seed-1 weights, the anchor head's ``quiet_anchor_head_``), A unfused and with the fused head: ANCHOR_ITERS
    timed forwards after a warm-up, ms by CUDA events and by the host clock,
    peak memory, K1 (and K3) launches a forward, the detections checked
    (2000 an image: A's stage 2 on R = 16 000 proposals, B's RetinaNet
    detections), one profiled forward's stage spans."""
    from oneshotdet_tpu_torch.models import build_detection_model

    images, supps = phase5_batch(dev)
    paths, out = {}, {}
    for key, (opts, k1, _) in ANCHOR_CELLS.items():
        model = build_detection_model(anchor_cfg(flagship, opts), device=dev,
                                      generator=torch.Generator().manual_seed(1))
        quiet_anchor_head_(model, torch.Generator().manual_seed(2))
        for fused in ((False, True) if key.startswith("A") else (False,)):
            cell = key + (", fused head" if fused else "")
            model.config = dataclasses.replace(model.config, fused_roi_head=fused)
            dets = model(images, supps)                     # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(ANCHOR_ITERS)]
            t0 = time.perf_counter()
            for start, end in events:
                start.record()
                dets = model(images, supps)
                end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / ANCHOR_ITERS
            ev = sorted(s.elapsed_time(e) for s, e in events)
            peak = torch.cuda.max_memory_allocated() / 2**30
            paths[f"phase 15 {cell}, {ANCHOR_ITERS} forwards"] = n = read_launches()
            if n["roi_align"] != k1 * ANCHOR_ITERS or \
                    n["roi_head"] != (ANCHOR_ITERS if fused else 0):
                raise AssertionError(f"{cell}: launches {n} in {ANCHOR_ITERS} forwards, "
                                     f"expected {k1} K1 and {int(fused)} K3 a forward")
            check_detections(dets, BATCH, 2000, images.sizes_wh())
            nd = int(dets.valid.sum())
            log(f"phase 15 eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, "
                f"{host_ms:.1f} ms/batch by the host clock, CUDA events median "
                f"{ev[len(ev) // 2]:.1f} ms (min {ev[0]:.1f}, max {ev[-1]:.1f}), peak memory {peak:.2f} GiB, {nd} "
                f"detections, {k1} K1 and {int(fused)} K3 launches a forward [{card}]")
            out[cell] = dict(ms_host=host_ms, ms_events_median=ev[len(ev) // 2],
                             ms_events=ev, peak_gib=peak, k1_per_forward=k1,
                             k3_per_forward=int(fused), detections=nd,
                             stages_ms=profile_forward(model, images, supps,
                                                       f"phase 15 {cell}"))
        del model, dets
        torch.cuda.empty_cache()
    del images, supps
    torch.cuda.empty_cache()
    return paths, out


def anchor_train_steps(flagship, dev, card):
    """Phase 15b: each cell's train step at full width (bf16, batch 8
    832x1216, supports 416x416, MAX_GT_BOXES 64, seed-1 weights, the
    anchor head's ``quiet_anchor_head_``, SOLVER.BASE_LR ``ANCHOR_TRAIN``):
    ANCHOR_WARMUP steps, then ANCHOR_STEPS timed, each on a fresh
    ``make_episodic_batch`` episode; ms/step by CUDA events and the host
    clock, peak memory, K1 and K1b calls a step (A 7 and 7; B 5 and 5: its
    train step returns before the support 7x7), the losses finite and of
    the cell's keys, the support backbone's layer4 (reached only through
    K1b) with a non-zero gradient; one profiled step's stage spans."""
    from oneshotdet_tpu_torch.engine import train_step
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    steps = ANCHOR_WARMUP + ANCHOR_STEPS
    batches = [make_episodic_batch(BATCH, QUERY_HW, SUPP_HW, max_gt=64, seed=300 + i)
               for i in range(steps)]
    keys = {"A anchor RPN": {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                             "loss_box_reg"},
            "B RetinaNet RPN_ONLY": {"loss_retina_cls", "loss_retina_reg"}}
    paths, out = {}, {}
    for key, (opts, _, k1) in ANCHOR_CELLS.items():
        cfg = anchor_cfg(flagship, opts, *ANCHOR_TRAIN)
        model = build_detection_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        quiet_anchor_head_(model, torch.Generator().manual_seed(2))
        model.train()
        optimizer = make_optimizer(cfg, model)
        scheduler = make_lr_scheduler(cfg, optimizer)
        gen = torch.Generator(device=dev).manual_seed(7)
        reset_launches()
        history = [train_step(model, optimizer, scheduler, batches[0], gen)]
        bad = [n for n, p in model.named_parameters() if p.requires_grad and (
            p.grad is None or not bool(torch.isfinite(p.grad).all()))]
        supp4 = [p.grad for n, p in model.named_parameters()
                 if n.startswith("supp_backbone.body.layer4.")]
        if bad or not all(g is not None and float(g.float().abs().sum()) > 0 for g in supp4):
            raise AssertionError(f"{key} train step 1: no or non-finite gradient for {bad[:5]} "
                                 f"({len(bad)} parameters), or a zero one for the support "
                                 f"layer4; losses {history[0]}")
        for batch in batches[1:ANCHOR_WARMUP]:
            history.append(train_step(model, optimizer, scheduler, batch, gen))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(ANCHOR_STEPS)]
        t0 = time.perf_counter()
        for (start, end), batch in zip(events, batches[ANCHOR_WARMUP:]):
            start.record()
            history.append(train_step(model, optimizer, scheduler, batch, gen))
            end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / ANCHOR_STEPS
        ev = sorted(s.elapsed_time(e) for s, e in events)
        peak = torch.cuda.max_memory_allocated() / 2**30
        paths[f"phase 15 {key} train, {steps} steps"] = n = read_launches()
        if n["roi_align"] != k1 * steps or n["roi_align_bwd"] != k1 * steps:
            raise AssertionError(f"{key} train: launches {n} in {steps} steps, expected {k1} "
                                 f"K1 and {k1} K1b calls a step")
        losses = [{k: float(v) for k, v in m.items() if k != "loss_total"} for m in history]
        for i, m in enumerate(losses):
            if set(m) != keys[key] or not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{key} train step {i + 1}: losses {m}")
        log(f"phase 15 train step {key}: bf16, batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]}, "
            f"{host_ms:.1f} ms/step by the host clock over {ANCHOR_STEPS} steps on fresh "
            f"batches, CUDA events median {ev[len(ev) // 2]:.1f} ms (min {ev[0]:.1f}, max "
            f"{ev[-1]:.1f}), peak memory {peak:.2f} GiB, {k1} K1 and {k1} K1b calls a step; "
            f"last losses {losses[-1]} [{card}]")
        prof = profile_train_step(lambda: train_step(model, optimizer, scheduler, batches[-1], gen),
                                  f"phase 15 {key} train step", ANCHOR_STAGES)
        out[key] = dict(ms_host=host_ms, ms_events_median=ev[len(ev) // 2], ms_events=ev,
                        peak_gib=peak, k1_per_step=k1, k1b_per_step=k1, losses=losses[-1],
                        profile=prof)
        del model, optimizer, scheduler
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()
    return paths, out


def anchor_cli(flagship, dev, card):
    """Phase 15c: cell A through ``tools.test_net`` over ANCHOR_CLI_BATCHES
    batches of 8 on phase 8's synthetic dataset (a .pth of seed-1 weights,
    the anchor head's ``quiet_anchor_head_``;
    7 K1 launches a batch, COCO files written) and ``tools.train_net`` from
    that .pth for ANCHOR_CLI_STEPS steps at ``ANCHOR_TRAIN``'s learning rate
    (7 K1 and 7 K1b calls a step, finite losses)."""
    from oneshotdet_tpu_torch.data import build as data_build
    from oneshotdet_tpu_torch.engine import trainer
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.tools import test_net, train_net
    from oneshotdet_tpu_torch.utils import checkpoint as ckpt_mod
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

    paths, out = {}, {}
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann_file = write_synthetic_coco(root, num_images=DATA_IMAGES, sizes=DATA_SIZES,
                                                 box_side=DATA_BOX_SIDE, seed=0)
        env = {"ONESHOT_CUSTOM_IMG_DIR": img_dir, "ONESHOT_CUSTOM_ANN_FILE": ann_file}
        os.environ.update(env)
        opts = [str(v) for v in ["DATASETS.TRAIN", "('custom',)", "DATASETS.TEST",
                                 "('custom',)", "FEW_SHOT.TRAINING_EXCL_CATS", "[]",
                                 "TEST.IMS_PER_BATCH", BATCH, "SOLVER.IMS_PER_BATCH", BATCH,
                                 *ANCHOR_A]]
        model = build_detection_model(anchor_cfg(flagship, opts), device=dev,
                                      generator=torch.Generator().manual_seed(1))
        quiet_anchor_head_(model, torch.Generator().manual_seed(2))
        ckpt = os.path.join(root, "seed1.pth")
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
        del model
        torch.cuda.empty_cache()
        _cli_logger()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rc = test_net.main(["--config-file", flagship, "--ckpt", ckpt, *opts, "OUTPUT_DIR",
                            os.path.join(root, "eval"), "FEW_SHOT.STOP_ITER",
                            str(ANCHOR_CLI_BATCHES)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = "phase 15 A anchor RPN: eval CLI (test_net)"
        paths[label] = n = read_launches()
        metrics, n_dets = check_eval_outputs(os.path.join(root, "eval", "eval"), label)
        if rc != 0 or n["roi_align"] != 7 * ANCHOR_CLI_BATCHES:
            raise AssertionError(f"{label}: exit {rc}, launches {n} for {ANCHOR_CLI_BATCHES} "
                                 f"batches")
        out["eval_cli"] = dict(wall_s=wall, detections=n_dets, AP=metrics["AP"],
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"{label}: {ANCHOR_CLI_BATCHES} batches of {BATCH}, {wall:.1f} s in all with the "
            f"evaluation (host clock); 7 K1 launches a batch; {n_dets} detections; AP "
            f"{metrics['AP']:.4f} (random weights) [{card}]")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with _TrainProbe(ckpt_mod, trainer, lambda *a: None) as probe:
            probe.max_iter = ANCHOR_CLI_STEPS
            rc = train_net.main(["--config-file", flagship, *opts, *map(str, ANCHOR_TRAIN),
                                 "MODEL.WEIGHT", ckpt, "SOLVER.MAX_ITER", str(ANCHOR_CLI_STEPS),
                                 "SOLVER.CHECKPOINT_PERIOD", str(10 * ANCHOR_CLI_STEPS),
                                 "OUTPUT_DIR", os.path.join(root, "train")])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = "phase 15 A anchor RPN: train CLI (train_net)"
        paths[label] = read_launches()
        steps = probe.steps
        for st in steps:
            k = st["launches"]
            losses = {name: float(v) for name, v in st["metrics"].items()}
            if k["roi_align"] != 7 or k["roi_align_bwd"] != 7 or \
                    "loss_objectness" not in losses or \
                    not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"{label} step {st['it'] + 1}: launches {k}, losses {losses}")
            st["losses"] = losses
        if rc != 0 or len(steps) != ANCHOR_CLI_STEPS:
            raise AssertionError(f"{label}: exit {rc}, {len(steps)} steps")
        ms_step = 1e3 * (probe.end - steps[1]["t0"]) / (ANCHOR_CLI_STEPS - 1)
        out["train_cli"] = dict(ms_per_step=ms_step, peak_gib=peak, losses=steps[-1]["losses"])
        log(f"{label}: {ANCHOR_CLI_STEPS} steps from the .pth, {ms_step:.1f} ms/step over steps "
            f"2-{ANCHOR_CLI_STEPS} (host clock, loader included; bf16, batch {BATCH}); 7 K1 and "
            f"7 K1b calls a step; peak memory {peak:.2f} GiB; losses {steps[-1]['losses']} "
            f"[{card}]")
        logging.getLogger("oneshotdet_tpu_torch").handlers.clear()
        for key in env:
            os.environ.pop(key, None)
    torch.cuda.empty_cache()
    return paths, out


def anchor_predictor(flagship, dev, card, supp, frames):
    """Phase 15d: ``OneShotPredictor`` of cell A (bf16, seed-1 weights) on
    phase 4's support (6 K1) and frames of four sizes (1 K1 a frame), the
    anchor grids built once for the query bucket's shapes."""
    from oneshotdet_tpu_torch.predictor import OneShotPredictor

    reset_launches()
    pred = OneShotPredictor(anchor_cfg(flagship, ANCHOR_A), confidence_threshold=0.0,
                            device=dev, generator=torch.Generator().manual_seed(1))
    pred.set_support(supp)
    ms = []
    for frame in frames:
        t0 = time.perf_counter()
        boxes, scores = pred.run_on_image(frame)
        ms.append((time.perf_counter() - t0) * 1e3)
        fh, fw = frame.shape[:2]
        if not (len(scores) and np.isfinite(boxes).all() and boxes[:, [0, 2]].max() <= fw
                and boxes[:, [1, 3]].max() <= fh and boxes.min() >= 0):
            raise AssertionError(f"phase 15 predictor frame {fh}x{fw}: {len(scores)} detections "
                                 f"or a box outside the frame")
    n = read_launches()
    grids = len(pred.model.rpn.generator._grids)
    if n["roi_align"] != 6 + len(frames) or grids != 5:
        raise AssertionError(f"phase 15 predictor: launches {n}, {grids} anchor grids built")
    log(f"phase 15 predictor A: frames {[f.shape[:2] for f in frames]}, ms "
        f"{[round(m, 1) for m in ms]} (host clock, the first with its warm-up), 6 + {len(frames)} K1 launches, 5 anchor "
        f"grids built [{card}]")
    del pred
    torch.cuda.empty_cache()
    return {"phase 15 predictor A": n}, dict(ms=ms)


def anchor_small_checks(flagship, dev):
    """Phase 15e: small float32 models of A and B (the flagship's SMALL
    capacities, batch 2 128x160, supports 64x64) on the card against the
    CPU with the same weights (``distinct_weights_``, the anchor head's
    ``quiet_anchor_head_``) and inputs, TF32 off: the eval forward's
    detections within the detection tolerances (``small_forward_check``),
    and a train step with the same draws, cuDNN off and the card's
    activations at the CPU's branch within rounding of their kink
    (``follow_kinks``): losses within rtol 1e-4, each gradient within 1e-3
    relative norm."""
    from oneshotdet_tpu_torch.engine import batch_to_inputs
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    out = {}
    prepare = lambda m: quiet_anchor_head_(m, torch.Generator().manual_seed(52))  # noqa: E731
    for key, (opts, _, _) in ANCHOR_CELLS.items():
        n = small_forward_check(flagship, dev, opts=opts, label=f" (phase 15 {key})",
                                prepare=prepare)
        cfg = anchor_cfg(flagship, opts, *SMALL)
        batch = make_episodic_batch(2, (128, 160), (64, 64), max_gt=4, seed=51)
        cpu = build_detection_model(cfg, device="cpu")
        distinct_weights_(cpu, torch.Generator().manual_seed(53))
        prepare(cpu)
        shapes = pyramid_shapes(128, 160)
        r = cfg.MODEL.RPN
        n_anchors = 3 * sum(h * w for h, w in shapes)
        n_props = min(r.FPN_POST_NMS_TOP_N_TRAIN, sum(
            min(r.POST_NMS_TOP_N_TRAIN, r.PRE_NMS_TOP_N_TRAIN, 3 * h * w) for h, w in shapes))
        g = torch.Generator().manual_seed(54)
        rpn_draws = torch.rand((2, n_anchors), generator=g)
        draws = torch.rand((2, n_props + cfg.TPU.MAX_GT_BOXES), generator=g)

        def step(model, d, kinks):
            model.train()
            with kinks:
                losses = model.forward_train(*batch_to_inputs(batch, d), draws=draws.to(d),
                                             rpn_draws=rpn_draws.to(d))
                sum(losses.values()).backward()
            return ({k: float(v.detach()) for k, v in losses.items()},
                    {n_: p.grad.detach().cpu() for n_, p in model.named_parameters()
                     if p.grad is not None})

        record = follow_kinks()
        lc, gc = step(cpu, "cpu", record)
        gpu = build_detection_model(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        follow = follow_kinks(record.calls)
        torch.backends.cudnn.enabled = False
        try:
            lg, gg = step(gpu, dev, follow)
        finally:
            torch.backends.cudnn.enabled = True
        del gpu, cpu, record
        if gc.keys() != gg.keys() or lc.keys() != lg.keys() or \
                not all(math.isfinite(v) for v in (*lc.values(), *lg.values())):
            raise AssertionError(f"phase 15 small step {key}: card and CPU differ in their "
                                 f"losses or in which parameters have gradients, or a loss "
                                 f"is not finite: {lc} {lg}")
        loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
        rel = sorted(((float((gg[k] - v).norm() / v.norm().clamp(min=1e-30)), k)
                      for k, v in gc.items() if float(v.norm()) > 0), reverse=True)
        log(f"phase 15 small float32 train step {key}, card against CPU (cuDNN off, TF32 off): "
            f"losses within {loss_rel:.2e} relative, worst gradient {rel[0][0]:.2e} relative "
            f"norm ({rel[0][1]}); {follow.taken} activation elements at the CPU's branch; "
            f"losses {lc}")
        if loss_rel > 1e-4 or rel[0][0] > 1e-3:
            raise AssertionError(f"phase 15 small step {key}: losses {loss_rel:.2e} (rtol 1e-4), "
                                 f"gradients {rel[0][0]:.2e} (bound 1e-3)")
        out[key] = dict(forward_detections=n, loss_rel=loss_rel, grad_rel=rel[0][0],
                        kink_elements_taken=follow.taken)
    return out


def anchor_path(flagship, dev, card, supp, frames):
    """Phase 15: the anchor RPN (A) and RetinaNet (B) stage 1 at full width:
    eval forwards, train steps, A's CLIs and predictor, and the small
    float32 checks against the CPU."""
    t_phase = time.perf_counter()
    paths, out = {}, {}
    for name, fn in (("eval", lambda: anchor_eval_forwards(flagship, dev, card)),
                     ("train", lambda: anchor_train_steps(flagship, dev, card)),
                     ("cli", lambda: anchor_cli(flagship, dev, card)),
                     ("predictor", lambda: anchor_predictor(flagship, dev, card, supp, frames))):
        t0 = time.perf_counter()
        p, out[name] = fn()
        paths.update(p)
        log(f"phase 15 {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["small"] = anchor_small_checks(flagship, dev)
    log(f"phase 15 small: {time.perf_counter() - t0:.1f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['phase_s']:.1f} s")
    return paths, out


# -- phase 16: the last eval-path gaps (the hoist, RetinaNet int8, anchor export) ------

PREPOOL_ENV = "ONESHOT_PREPOOL_COMPRESS"
HOIST_ITERS = 3                       # timed eval forwards of a phase 16 cell
K1_512_CASES = 16000                  # R of the proposals' case at C = 512


class env_set:
    """Context: environment variables set (value None: removed), restored
    after."""

    def __init__(self, **values):
        self.values, self.saved = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class hoist_int8_forced:
    """Context: record (``calls`` None) or replay the hoisted query half's
    ``int8_dot`` calls (``models.detector.int8_dot``, one per level map),
    as ``int8_forced`` replays the int8 layers: on the card each call's
    input within QUANT_FORCE_RTOL of the CPU's maximum, the CPU's input
    taken, the CPU's output given bit for bit."""

    def __init__(self, calls=None):
        self.calls, self.record, self.taken = calls, calls is None, 0

    def __enter__(self):
        from oneshotdet_tpu_torch.models import detector

        self.mod, self.real = detector, detector.int8_dot
        if self.record:
            self.calls = []
        detector.int8_dot = self._call
        return self

    def __exit__(self, *exc):
        self.mod.int8_dot = self.real

    def _call(self, x, w):
        if self.record:
            y = self.real(x, w)
            self.calls.append((x.detach().cpu(), y.detach().cpu()))
            return y
        ref_x, ref_y = self.calls[self.taken]
        self.taken += 1
        err = float((x.detach().float().cpu() - ref_x.float()).abs().max())
        scale = float(ref_x.float().abs().max())
        if err > QUANT_FORCE_RTOL * max(scale, 1e-30):
            raise AssertionError(f"hoisted int8_dot {self.taken}: input {err:.3e} from the "
                                 f"CPU's, beyond {QUANT_FORCE_RTOL} x {scale:.3e}")
        y = self.real(ref_x.to(x.device, x.dtype), w)
        if not torch.equal(y.cpu(), ref_y):
            raise AssertionError(f"hoisted int8_dot {self.taken}: output on the card differs "
                                 f"from the CPU's on the same input")
        return y


def touched_pixels(plans, rois, levels, shapes):
    """Distinct (level, image, row, column) pixels that the plans' ROIs
    stage: the least the kernel must read."""
    maps = {}
    for r, plan in enumerate(plans):
        if plan is None or not plan.rows or not plan.cols:
            continue
        lvl = int(levels[r])
        key = (lvl, int(rois[r, 0]))
        if key not in maps:
            maps[key] = np.zeros(shapes[lvl], bool)
        maps[key][np.ix_(plan.rows, plan.cols)] = True
    return int(sum(m.sum() for m in maps.values()))


def k1_512_checks(ra, dev, card):
    """Phase 16a: K1 at C = 512 (the hoisted compress_0 query half's maps,
    2 x 256 channels) against its plain version in bf16 and float32 (two
    channel slices of 1 KB a pixel): the proposals at R = 16 000, the
    predictor's 1 x 2000, the p3-skew mix at R = 16 000 and the edge cases,
    each with its plan statistics against ``roi_align_plan``; ms, bound and
    share of the bound at each shape, the bound reading only the pixels the
    ROIs touch (``touched_pixels``)."""
    from oneshotdet_tpu_torch.tools.tune_roialign_v3 import make_rois

    gen = torch.Generator().manual_seed(16)
    q_shapes = pyramid_shapes(*QUERY_HW)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        feats = [torch.randn(BATCH, h, w, 512, generator=gen).to(dev, dtype) for h, w in q_shapes]
        cases = []
        rois, valid = random_rois(K1_512_CASES, BATCH, QUERY_HW, gen, dev)
        cases.append((f"proposals 7x7 R={K1_512_CASES}", feats, rois,
                      ra.fpn_level_map(rois[:, 1:], 3, 7), valid))
        rois, valid = random_rois(2000, 1, QUERY_HW, gen, dev)
        cases.append(("predictor 7x7 1 x 2000", [f[:1] for f in feats], rois,
                      ra.fpn_level_map(rois[:, 1:], 3, 7), valid))
        rr = np.random.RandomState(516)
        skew, skew_lv = make_rois(rr, K1_512_CASES, "p3", 4)
        cases.append((f"p3-skew R={K1_512_CASES}", feats, torch.from_numpy(skew).to(dev),
                      torch.from_numpy(skew_lv).to(dev), None))
        for name, r, lv, v in edge_case_rois(gen, dev):
            cases.append((name, feats, r, ra.fpn_level_map(r[:, 1:], 3, 7) if lv is None else lv,
                          v))
        for name, fs, rois, levels, valid in cases:
            args = (fs, rois, levels, (7, 7), SCALES_Q, 2, valid)
            k, err, metric, tol, staged = k1_compare(ra, f"C=512 {name}", dtype, args)
            pixels = touched_pixels(ra.roi_align_plan(*args), rois.cpu(), levels.cpu(),
                                    [tuple(f.shape[1:3]) for f in fs])
            bound, by, nbytes, ops = k1_bound(fs, rois, levels, valid, k, pixels)
            ms = time_ms(lambda: ra.multilevel_roi_align_cuda(*args))
            main_case = not name.startswith(("one ROI", "outside", "all invalid", "wide"))
            plain_ms = (time_ms(lambda: ra.multilevel_roi_align_plain(*args), reps=5, warmup=1)
                        if main_case and rois.shape[0] <= 2000 else None)
            log(f"roi_align C=512 {name} {str(dtype)[6:]}: {metric} (tolerance {tol}); "
                f"{ra.channel_slices(512, dtype)} channel slice(s); kernel {ms:.4f} ms"
                + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
                + f", bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
                f"kernel at {100 * bound / ms:.1f}% of its bound; staged {staged / 1e6:.1f} MB "
                f"[{card}]")
            out[f"{name} {str(dtype)[6:]}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bound, bound_by=by,
                                                   bound_share=bound / ms)
            del k
        del feats
        torch.cuda.empty_cache()
    return out


def _timed_forwards(model, images, supps, iters=HOIST_ITERS):
    """A warm-up then ``iters`` eval forwards: (dets, CUDA-event ms list,
    peak GiB, launches)."""
    dets = model(images, supps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        dets = model(images, supps)
        end.record()
    torch.cuda.synchronize()
    return (dets, sorted(s.elapsed_time(e) for s, e in events),
            torch.cuda.max_memory_allocated() / 2**30, read_launches())


def quant_card_check(cfg, dev, label, prepare=None):
    """A small float32 forward of ``cfg`` (batch 2, 128x160 queries, 64x64
    supports; TPU.QUANT and the hoist as ``cfg`` and the environment say)
    on the card against the CPU with the same weights: detections within
    the detection tolerances; under 'int8' every int8 layer, the relation
    head's support half and the hoisted query half replayed from the CPU,
    each bit for bit. Returns (detections, replayed calls)."""
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.structures import ImageBatch

    gen = torch.Generator().manual_seed(11)
    q = torch.randn(2, 128, 160, 3, generator=gen) * 50
    s = torch.randn(2, 64, 64, 3, generator=gen) * 50
    qs = torch.tensor([[128.0, 160.0], [100.0, 150.0]])
    ss = torch.tensor([[64.0, 64.0], [60.0, 40.0]])
    cpu = build_detection_model(cfg, device="cpu")
    distinct_weights_(cpu, torch.Generator().manual_seed(12))
    if prepare is not None:
        prepare(cpu)
    gpu = build_detection_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    with int8_forced(cpu) as rec, hoist_int8_forced() as hrec:
        ref = cpu(ImageBatch(q, qs), ImageBatch(s, ss))
    args = (ImageBatch(q.to(dev), qs.to(dev)), ImageBatch(s.to(dev), ss.to(dev)))
    replayed = 0
    if cfg.TPU.QUANT == "int8":
        with int8_forced(gpu, rec.calls) as rep, hoist_int8_forced(hrec.calls) as hrep:
            got = gpu(*args)
        replayed = rep.layers + hrep.taken
    else:
        got = gpu(*args)
    n = 0
    for i in range(2):
        def dets(d):
            v = d.valid[i].cpu().numpy()
            return d.xyxy[i].float().cpu().numpy()[v], d.get_field("scores")[i].cpu().numpy()[v]
        match_detections(dets(got), dets(ref))
        n += int(got.valid[i].sum())
    log(f"phase 16 small float32 forward {label}: {n} detections on the card match the CPU "
        f"(score rtol 5e-4, box rtol 1e-3, TF32 off)"
        + (f", {replayed} int8 calls replayed from the CPU, each bit for bit" if replayed else ""))
    del cpu, gpu
    return n, replayed


def hoist_cells(flagship, preset, dev, card):
    """Phase 16b: ONESHOT_PREPOOL_COMPRESS=1 at full width (bf16, phase 5's
    batch 8): the preset (R = 4096) and the full forward (R = 16 000), each
    built with the hoist and ONESHOT_PALLAS_ROI_HEAD=1 (both read at build)
    and run as built (7 K1, 0 K3: the fused head is not taken under the
    hoist), then hoisted without the opt-in and un-hoisted in turns
    (hoisted, un-hoisted, un-hoisted, hoisted; HOIST_ITERS forwards each
    after a warm-up, the model warmed by two forwards first); the preset
    also under 'int8'. ms/batch by CUDA events (the median of each side's
    forwards), peak memory, one profiled forward of each side; then small
    float32 and 'int8' hoisted forwards on the card against the CPU."""
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model

    images, supps = phase5_batch(dev)
    paths, out = {}, {}
    for label, path, quant in (("preset", preset, "none"), ("full 2000/img", flagship, "none"),
                               ("preset int8", preset, "int8")):
        c = default_cfg.clone()
        c.merge_from_file(path)
        c.merge_from_list(["TPU.QUANT", quant])
        with env_set(ONESHOT_PREPOOL_COMPRESS="1", ONESHOT_PALLAS_ROI_HEAD="1"):
            model = build_detection_model(c, device=dev,
                                          generator=torch.Generator().manual_seed(1))
        built = model.config
        if not (built.prepool_compress and built.fused_roi_head):
            raise AssertionError(f"phase 16 {label}: the switches were not read at build")
        for _ in range(2):
            model(images, supps)
        sides = {"hoisted": dataclasses.replace(built, fused_roi_head=False),
                 "un-hoisted": dataclasses.replace(built, fused_roi_head=False,
                                                   prepool_compress=False)}
        runs = [("hoisted, fused opt-in", built)] if quant == "none" else []
        runs += [(name, sides[name]) for name in ("hoisted", "un-hoisted", "un-hoisted",
                                                  "hoisted")]
        times = {}
        capacity = min(c.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                       c.TPU.EVAL_ROI_TOPK or c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST)
        for name, conf in runs:
            cell = f"phase 16 {label}, {name}"
            model.config = conf
            dets, ev, peak, n = _timed_forwards(model, images, supps)
            paths[f"{cell}, {HOIST_ITERS} forwards" + (" (again)" if name in times else "")] = n
            if n["roi_align"] != 7 * HOIST_ITERS or n["roi_head"] != 0:
                raise AssertionError(f"{cell}: launches {n} in {HOIST_ITERS} forwards, expected "
                                     f"7 K1 and 0 K3 a forward")
            check_detections(dets, BATCH, capacity, images.sizes_wh())
            times.setdefault(name, []).extend(ev)
            log(f"eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, CUDA events "
                f"{[round(e, 1) for e in ev]} ms/batch, peak memory {peak:.2f} GiB, "
                f"{int(dets.valid.sum())} detections, 7 K1 and 0 K3 a forward [{card}]")
            entry = out.setdefault(cell, dict(k1_per_forward=7, k3_per_forward=0,
                                              detections=int(dets.valid.sum()), peak_gib=peak))
            entry["ms_events"] = sorted(times[name])
            entry["ms_events_median"] = entry["ms_events"][len(entry["ms_events"]) // 2]
            if name in sides and "stages_ms" not in entry:
                entry["stages_ms"] = profile_forward(model, images, supps, cell)
        log(f"phase 16 {label}: CUDA-event medians, hoisted "
            f"{out[f'phase 16 {label}, hoisted']['ms_events_median']:.1f}, un-hoisted "
            f"{out[f'phase 16 {label}, un-hoisted']['ms_events_median']:.1f} ms/batch (in turns, "
            f"{2 * HOIST_ITERS} forwards each) [{card}]")
        del model, dets
        torch.cuda.empty_cache()
    del images, supps
    torch.cuda.empty_cache()
    small = {}
    for quant in ("none", "int8"):
        c = default_cfg.clone()
        c.merge_from_file(flagship)
        c.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_PRE_TOPK", 1024,
                           "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 128,
                           "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 64, "TPU.QUANT", quant])
        with env_set(ONESHOT_PREPOOL_COMPRESS="1"):
            small[quant] = quant_card_check(c, dev, f"hoisted, TPU.QUANT {quant}")
    out["small"] = small
    return paths, out


def retina_quant_cells(flagship, dev, card):
    """Phase 16c: RetinaNet with RPN_ONLY under TPU.QUANT 'int8' and
    'int8_weight' at full width (bf16, phase 5's batch 8, seed-1 weights,
    the head's ``quiet_anchor_head_``): the eval forward (6 K1 a forward),
    ms/batch by CUDA events; then small float32 forwards of both modes on
    the card against the CPU, 'int8' replayed."""
    from oneshotdet_tpu_torch.models import build_detection_model

    images, supps = phase5_batch(dev)
    paths, out = {}, {}
    for mode in QUANT_MODES:
        cell = f"phase 16 B RetinaNet RPN_ONLY, TPU.QUANT {mode}"
        model = build_detection_model(anchor_cfg(flagship, ANCHOR_B, "TPU.QUANT", mode),
                                      device=dev, generator=torch.Generator().manual_seed(1))
        quiet_anchor_head_(model, torch.Generator().manual_seed(2))
        dets, ev, peak, n = _timed_forwards(model, images, supps, iters=2)
        paths[f"{cell}, 2 forwards"] = n
        if n["roi_align"] != 6 * 2 or n["roi_head"] != 0:
            raise AssertionError(f"{cell}: launches {n}, expected 6 K1 a forward")
        check_detections(dets, BATCH, 2000, images.sizes_wh())
        med = ev[len(ev) // 2]
        log(f"eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, CUDA events "
            f"{[round(e, 1) for e in ev]} ms/batch, peak memory {peak:.2f} GiB, "
            f"{int(dets.valid.sum())} detections, 6 K1 a forward [{card}]")
        out[cell] = dict(ms_events=ev, peak_gib=peak, k1_per_forward=6,
                         detections=int(dets.valid.sum()))
        del model, dets
        torch.cuda.empty_cache()
    del images, supps
    torch.cuda.empty_cache()
    prepare = lambda m: quiet_anchor_head_(m, torch.Generator().manual_seed(52))  # noqa: E731
    out["small"] = {mode: quant_card_check(anchor_cfg(flagship, ANCHOR_B, *SMALL,
                                                      "TPU.COMPUTE_DTYPE", "float32",
                                                      "TPU.QUANT", mode),
                                           dev, f"RetinaNet RPN_ONLY, TPU.QUANT {mode}",
                                           prepare)
                    for mode in QUANT_MODES}
    return paths, out


def anchor_export_cells(flagship, dev, card, supp, frames):
    """Phase 16d: the anchor RPN (cell A, seed-1 weights, the head's
    ``quiet_anchor_head_``) as a batch-1 serving bundle on the ExportedProgram
    route: ``ArtifactPredictor`` bit for bit against ``OneShotPredictor`` on
    phase 4's support and frames, K1 6 per ``set_support`` and 1 per frame
    counted from inside the programs; RetinaNet RPN_ONLY's batch-8 ``full``
    program bit for bit against the eager forward on phase 5's batch (6 K1
    inside); export and load seconds."""
    from oneshotdet_tpu_torch import export as oexport
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.predictor import ArtifactPredictor, OneShotPredictor

    zero = {k: 0 for k in _counters()}
    out, paths = {}, {}
    cfg = anchor_cfg(flagship, ANCHOR_A)
    eager = OneShotPredictor(cfg, confidence_threshold=0.0, query_bucket=QUERY_HW,
                             supp_bucket=SUPP_HW, device=dev,
                             generator=torch.Generator().manual_seed(1))
    quiet_anchor_head_(eager.model, torch.Generator().manual_seed(2))
    with tempfile.TemporaryDirectory() as root:
        stem = os.path.join(root, "anchor_rpn")
        t0 = time.perf_counter()
        oexport.export_serving(cfg, eager.model, stem, query_hw=QUERY_HW, supp_hw=SUPP_HW,
                               compile_executable=False)
        out["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = ArtifactPredictor(stem, device=dev)
        out["load_s"] = time.perf_counter() - t0
        out["mib"] = {ext: os.path.getsize(stem + ext) / 2**20 for ext in (".support", ".detect")}
    eager.set_support(supp)
    reset_launches()
    served.set_support(supp)
    torch.cuda.synchronize()
    if read_launches() != dict(zero, roi_align=6):
        raise AssertionError(f"phase 16 A bundle set_support: {read_launches()}")
    n_dets = []
    for frame in frames:
        want = eager.run_on_image(frame)
        reset_launches()
        got = served.run_on_image(frame)
        torch.cuda.synchronize()
        if read_launches() != dict(zero, roi_align=1):
            raise AssertionError(f"phase 16 A bundle frame: {read_launches()}")
        if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
                and len(got[1]) > 0):
            raise AssertionError("phase 16 A bundle: the ExportedProgram route differs from "
                                 "OneShotPredictor")
        n_dets.append(len(got[1]))
    paths["phase 16 A bundle, set_support + frames"] = dict(zero, roi_align=6 + len(frames))
    out["frame_ms"] = {"OneShotPredictor": _frame_ms(eager, frames, 1),
                       "exported": _frame_ms(served, frames, 1)}
    del eager, served
    torch.cuda.empty_cache()
    log(f"phase 16 A anchor RPN serving bundle (ExportedProgram route): export "
        f"{out['export_s']:.1f} s, load {out['load_s']:.1f} s, files "
        + ", ".join(f"{k} {v:.1f} MiB" for k, v in out["mib"].items())
        + f"; equal to OneShotPredictor bit for bit over {len(frames)} frames ({n_dets} "
        f"detections), 6 K1 per set_support and 1 per frame inside the programs; ms per frame "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["frame_ms"].items()) + f" [{card}]")

    images, supps = phase5_batch(dev)
    cfg_b = anchor_cfg(flagship, ANCHOR_B)
    model = build_detection_model(cfg_b, device=dev, generator=torch.Generator().manual_seed(1))
    quiet_anchor_head_(model, torch.Generator().manual_seed(2))
    want = model(images, supps)
    t0 = time.perf_counter()
    ep = oexport.export_eval(cfg_b, model, batch=BATCH, query_hw=QUERY_HW, supp_hw=SUPP_HW,
                             kind="full")
    out["retina_full_export_s"] = time.perf_counter() - t0
    prog = ep.module()
    tids = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    reset_launches()
    with torch.inference_mode():
        got = prog(images.pixels, images.sizes, supps.pixels, supps.sizes, tids)
    torch.cuda.synchronize()
    n = read_launches()
    paths["phase 16 B RetinaNet full program, batch 8"] = n
    if n != dict(zero, roi_align=6):
        raise AssertionError(f"phase 16 B full program: launches {n}")
    for g, w in zip(got, (want.xyxy, want.get_field("scores"), want.valid)):
        if not torch.equal(g, w):
            raise AssertionError("phase 16 B full program differs from the eager forward")
    out["retina_full_detections"] = int(want.valid.sum())
    log(f"phase 16 B RetinaNet RPN_ONLY full program, batch {BATCH}: export "
        f"{out['retina_full_export_s']:.1f} s, equal to the eager forward bit for bit "
        f"({out['retina_full_detections']} detections), 6 K1 inside [{card}]")
    del model, ep, prog, images, supps
    torch.cuda.empty_cache()
    return paths, out


def webcam_cell(flagship, dev, card):
    """Phase 16e: ``tools.webcam`` on a 3-frame MJPG video written by
    ``cv2.VideoWriter`` (frames 480x640), ``cv2.imshow`` / ``waitKey`` /
    ``destroyAllWindows`` replaced in-process: the flagship on the card,
    every frame detected and shown, ms per frame. Where cv2 does not
    import, one line says so."""
    try:
        import cv2
    except ImportError:
        log("phase 16 webcam tool: cv2 (OpenCV) is not installed on this machine, the tool "
            "was not run")
        return {}, {"cv2": None}
    from oneshotdet_tpu_torch.data.image_io import write_ppm
    from oneshotdet_tpu_torch.tools import webcam

    gen = np.random.RandomState(16)
    shown, results = [], []
    saved = cv2.imshow, cv2.waitKey, cv2.destroyAllWindows, webcam.stream
    cv2.imshow = lambda name, img: shown.append(img.shape)
    cv2.waitKey = lambda ms: -1
    cv2.destroyAllWindows = lambda: None
    webcam.stream = lambda *a: results.extend(saved[3](*a)) or results
    try:
        with tempfile.TemporaryDirectory() as root:
            write_ppm(os.path.join(root, "support.ppm"),
                      gen.randint(0, 256, (300, 400, 3), dtype=np.uint8))
            video = os.path.join(root, "video.avi")
            writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 5, (640, 480))
            for _ in range(3):
                writer.write(gen.randint(0, 256, (480, 640, 3), dtype=np.uint8))
            writer.release()
            reset_launches()
            rc = webcam.main(["--config-file", flagship, "--support",
                              os.path.join(root, "support.ppm"), "--source", video,
                              "--threshold", "0.0"])
    finally:
        cv2.imshow, cv2.waitKey, cv2.destroyAllWindows, webcam.stream = saved
    n = read_launches()
    if rc != 0 or len(results) != 3 or len(shown) != 3 or n["roi_align"] != 6 + 3:
        raise AssertionError(f"phase 16 webcam: rc {rc}, {len(results)} frames, launches {n}")
    for boxes, scores, _ in results:
        if not (len(scores) and np.isfinite(boxes).all() and boxes.min() >= 0
                and boxes[:, [0, 2]].max() <= 640 and boxes[:, [1, 3]].max() <= 480):
            raise AssertionError("phase 16 webcam: empty or outside the frame")
    ms = [r[2] for r in results]
    log(f"phase 16 webcam tool (cv2 {cv2.__version__}): 3 MJPG frames 480x640, "
        f"{[len(r[1]) for r in results]} detections, ms per frame {[round(m, 1) for m in ms]} "
        f"(host clock, the first with its warm-up), 6 + 3 K1 [{card}]")
    return {"phase 16 webcam, support + 3 frames": n}, {"cv2": cv2.__version__, "frame_ms": ms}


def eval_gaps_path(flagship, preset, dev, card, supp, frames):
    """Phase 16: K1 at C = 512 (16a), the hoisted compress_0 query half
    (16b), RetinaNet under TPU.QUANT (16c), an exported anchor stage 1
    (16d) and the webcam tool (16e)."""
    from oneshotdet_tpu_torch.ops import roi_align as ra

    t_phase = time.perf_counter()
    paths, out = {}, {}
    t0 = time.perf_counter()
    out["k1_512"] = k1_512_checks(ra, dev, card)
    log(f"phase 16a: {time.perf_counter() - t0:.1f} s")
    for name, fn in (("hoist", lambda: hoist_cells(flagship, preset, dev, card)),
                     ("retina_quant", lambda: retina_quant_cells(flagship, dev, card)),
                     ("anchor_export", lambda: anchor_export_cells(flagship, dev, card, supp,
                                                                   frames)),
                     ("webcam", lambda: webcam_cell(flagship, dev, card))):
        t0 = time.perf_counter()
        p, out[name] = fn()
        paths.update(p)
        log(f"phase 16 {name}: {time.perf_counter() - t0:.1f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['phase_s']:.1f} s")
    return paths, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from oneshotdet_tpu_torch import csrc
    from oneshotdet_tpu_torch.config import cfg as default_cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.ops import roi_align as ra
    from oneshotdet_tpu_torch.ops import roi_head_fused as rf
    from oneshotdet_tpu_torch.predictor import OneShotPredictor

    # Inductor's and Triton's caches (phase 10's AOTInductor compiles) stay
    # in the checkout's build/
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(ROOT, "build", "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
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
    phase_s, t_last = {}, [time.perf_counter()]

    def phase_done(name):
        """Seconds since the previous phase ended, kept and printed."""
        now = time.perf_counter()
        phase_s[name] = now - t_last[0]
        t_last[0] = now
        log(f"{name}: {phase_s[name]:.1f} s since the previous phase")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    csrc.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in csrc.build_logs.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")
    kernels_ptx, warnings = ptxas_report(csrc.build_logs.get("roi_head", ""))
    for kname, (regs, st, ld) in kernels_ptx.items():
        if any(k in kname for k in ("head_front_bf16", "fc_gemm_bf16", "head_front_tf32",
                                    "fc_gemm_tf32")):
            log(f"ptxas roi_head.cu {kname}: {regs} registers at entry (setmaxnreg: consumers "
                f"232, producer 40), spill stores {st} B, spill loads {ld} B")
    log(f"ptxas roi_head.cu C7508/C7513 warnings: {warnings or 'none'}")
    for kname, (regs, st, ld) in ptxas_report(csrc.build_logs.get("roi_align", ""))[0].items():
        log(f"ptxas roi_align.cu {kname}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    for src in ("roi_align_bwd", "roi_align_v3", "roi_align_v4"):
        for kname, (regs, st, ld) in ptxas_report(csrc.build_logs.get(src, ""))[0].items():
            log(f"ptxas {src}.cu {kname}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
    k1 = ra._kernel()
    log(f"roi_align.cu: {k1.oneshot_roi_align_blocks_per_sm(1)} resident blocks per SM in bf16, "
        f"{k1.oneshot_roi_align_blocks_per_sm(0)} in f32 (one ROI per block)")

    phase_done("phase 2 (build)")

    # -- phase 3: kernels against plain ----------------------------------------
    checks = kernel_checks(ra, dev)
    bwd_checks = roi_align_bwd_checks(ra, dev)
    head_checks_result = head_checks(dev)
    small_forward_check(flagship, dev)
    small_forward_check(flagship, dev, fused=True)
    small_train = small_train_check(flagship, dev)
    gn_checks = group_norm_checks(dev)
    variant_checks = roi_variant_checks(ra, dev)
    # launches of every kernel on each path, counts set to 0 just before it
    paths = {"FusedGroupNorm, 5 tower levels": fused_group_norm_path(dev)}
    paths.update(tool_runs())

    phase_done("phase 3 (kernels, tools)")

    # -- phase 4: predictor, unfused and fused head --------------------------
    cfg = default_cfg.clone()
    cfg.merge_from_file(flagship)
    gen = torch.Generator().manual_seed(0)
    launches = {}
    head_launches = {}
    reset_launches()
    pred = OneShotPredictor(cfg, confidence_threshold=0.0, device=dev,
                            generator=torch.Generator().manual_seed(1))
    supp = torch.randint(0, 256, (300, 400, 3), generator=gen, dtype=torch.uint8).numpy()
    pred.set_support(supp)
    frames = [(480, 640), (800, 1200), (720, 1280), (600, 800)]
    frame_pixels = [torch.randint(0, 256, (fh, fw, 3), generator=gen,
                                  dtype=torch.uint8).numpy() for fh, fw in frames]
    for fused in (False, True):
        pred.model.config = dataclasses.replace(pred.model.config, fused_roi_head=fused)
        rf.fused_roi_head_launches = 0
        for (fh, fw), frame in zip(frames, frame_pixels):
            t0 = time.perf_counter()
            boxes, scores = pred.run_on_image(frame)
            ms = (time.perf_counter() - t0) * 1e3
            if not (np.isfinite(boxes).all() and np.isfinite(scores).all() and len(scores) > 0):
                raise AssertionError(f"predictor frame {fh}x{fw}: empty or non-finite output")
            if not (boxes[:, [0, 2]].min() >= 0 and boxes[:, [0, 2]].max() <= fw
                    and boxes[:, [1, 3]].min() >= 0 and boxes[:, [1, 3]].max() <= fh):
                raise AssertionError(f"predictor frame {fh}x{fw}: box outside the frame")
            log(f"predictor{' (fused head)' if fused else ''} frame {fh}x{fw}: {len(scores)} "
                f"detections, {ms:.1f} ms (host clock, first frame includes warm-up) [{card}]")
        label = "predictor, fused head" if fused else "predictor"
        if rf.fused_roi_head_launches != (len(frames) if fused else 0):
            raise AssertionError(f"{label}: {rf.fused_roi_head_launches} roi_head launches")
        head_launches[label] = rf.fused_roi_head_launches
    launches["predictor"] = ra.roi_align_launches
    paths["predictor, unfused and fused"] = read_launches()
    expected = 6 + 2 * len(frames)
    if launches["predictor"] != expected:
        raise AssertionError(f"predictor: {launches['predictor']} roi_align launches, expected {expected}")
    del pred
    torch.cuda.empty_cache()

    phase_done("phase 4 (predictor)")

    # -- phase 5: batched eval forward, unfused and fused head ------------------
    images, supps = phase5_batch(dev)
    for label, path in (("preset EVAL_ROI_TOPK=512", preset), ("full 2000/img", flagship)):
        c = default_cfg.clone()
        c.merge_from_file(path)
        model = build_detection_model(c, device=dev, generator=torch.Generator().manual_seed(1))
        for fused in (False, True):
            cell = f"{label}, fused head" if fused else label
            model.config = dataclasses.replace(model.config, fused_roi_head=fused)
            dets = model(images, supps)                     # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                dets = model(images, supps)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            n, nh = ra.roi_align_launches, rf.fused_roi_head_launches
            if n != 7 * iters:
                raise AssertionError(f"{cell}: {n} roi_align launches in {iters} forwards, expected {7 * iters}")
            if nh != (iters if fused else 0):
                raise AssertionError(f"{cell}: {nh} roi_head launches in {iters} forwards")
            launches[cell] = n
            head_launches[cell] = nh
            paths[f"{cell}, {iters} forwards"] = read_launches()
            capacity = min(c.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                           c.TPU.EVAL_ROI_TOPK or c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST)
            check_detections(dets, BATCH, capacity, images.sizes_wh())
            log(f"eval forward {cell}: batch {BATCH} {QUERY_HW[0]}x{QUERY_HW[1]} bf16, "
                f"{dt * 1e3:.1f} ms/batch, {BATCH / dt:.1f} img/s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                f"{int(dets.valid.sum())} detections [{card}]")
            profile_forward(model, images, supps, cell)
        del model, dets
        torch.cuda.empty_cache()
    f32_heads, f32_paths, f32_cells = f32_forward_checks(flagship, dev, images, supps, card)
    head_launches.update(f32_heads)
    paths.update(f32_paths)
    del images, supps

    phase_done("phase 5 (eval forwards)")

    # -- phase 6: the eval engine, fused head ------------------------------------
    c = default_cfg.clone()
    c.merge_from_file(flagship)
    model = build_detection_model(c, device=dev, generator=torch.Generator().manual_seed(1))
    model.config = dataclasses.replace(model.config, fused_roi_head=True)
    reset_launches()
    head_launches["engine"] = engine_checks(c, model, card)
    paths["engine"] = read_launches()
    del model
    torch.cuda.empty_cache()

    phase_done("phase 6 (engine)")

    # -- phase 7: the one-shot train step at full width --------------------------
    paths["train step"], train = train_path(flagship, dev, card)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    launches[f"train step, {steps} steps"] = paths["train step"]["roi_align"]

    phase_done("phase 7 (train step)")

    # -- phase 8: the episodic eval data path and the eval CLI ---------------------
    cli_paths, evalcli = eval_cli_path(flagship, dev, card)
    paths.update(cli_paths)
    for label in ("eval CLI (test_net)", "eval CLI (test_net), fused head"):
        launches[label] = cli_paths[label]["roi_align"]
        head_launches[label] = cli_paths[label]["roi_head"]

    phase_done("phase 8 (eval data path, CLI)")

    # -- phase 9: the train CLI (checkpoints, model zoo, resume, --seq_test) -----
    train_paths, traincli = train_cli_path(flagship, dev, card)
    paths.update(train_paths)
    launches["train CLI run B"] = train_paths["train CLI run B"]["roi_align"]

    phase_done("phase 9 (train CLI)")

    # -- phase 10: the serving artifact (export, ArtifactPredictor) --------------
    artifact_paths, artifact = artifact_path(flagship, dev, card, supp, frame_pixels)
    paths.update(artifact_paths)
    for label, n in artifact_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 10 (serving artifact)")

    # -- phase 11: the training variants -----------------------------------------
    variant_paths, variants = train_variants_path(flagship, dev, card)
    paths.update(variant_paths)
    for label, n in variant_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 11 (training variants)")

    # -- phase 12: SUPP_AUG, MASK_SUPP and DENSE_POINTS ----------------------------
    supp_paths, supp_aug = supp_aug_path(
        flagship, dev, card, evalcli["cli"]["eval CLI (test_net), fused head"]["loader_host_ms"])
    paths.update(supp_paths)
    for label, n in supp_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 12 (support switches)")

    # -- phase 13: MASK_ON and KEYPOINT_ON, K1 and K1b at 14x14 --------------------
    mk_paths, mask_kp, mk_kernels = mask_kp_path(flagship, dev, card, supp, frame_pixels[1])
    paths.update(mk_paths)
    for label, n in mk_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 13 (mask and keypoint heads)")

    # -- phase 14: TPU.QUANT int8 and int8_weight ----------------------------------
    quant_paths, quant = quant_path(flagship, preset, dev, card, supp, frame_pixels)
    paths.update(quant_paths)
    for label, n in quant_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 14 (TPU.QUANT)")

    # -- phase 15: the anchor RPN and RetinaNet stage 1 (MODEL.FCOS_ON False) -------
    anchor_paths, anchor = anchor_path(flagship, dev, card, supp, frame_pixels)
    paths.update(anchor_paths)
    for label, n in anchor_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 15 (anchor RPN and RetinaNet)")

    # -- phase 16: the hoist (K1 at C = 512), RetinaNet int8, anchor export, webcam --
    gap_paths, eval_gaps = eval_gaps_path(flagship, preset, dev, card, supp, frame_pixels)
    paths.update(gap_paths)
    for label, n in gap_paths.items():
        launches[label] = n["roi_align"]
        head_launches[label] = n["roi_head"]

    phase_done("phase 16 (hoist, RetinaNet int8, anchor export, webcam)")

    # -- kernels line and result ------------------------------------------------
    head = checks[("proposals 7x7 R=16000", torch.bfloat16)]
    k3 = head_checks_result[(16000, torch.bfloat16)]
    k3f = head_checks_result[(16000, torch.float32)]
    kernels = [{
        "name": "roi_align",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches["full 2000/img"],
        "launches_by_path": launches,
        "launches_per_train_step": paths["train step"]["roi_align"] // steps,
        "shape": "batch-8 832x1216 pyramid, C=256, R=16000 rois, 7x7, bf16",
        "max_abs_err": head["max_abs_err"],
        "tolerance": "1 bf16 ulp (f32 cases: 1e-5 abs)",
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_share": head["bound_share"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "p3_skew_fresh_ms": checks[("p3-skew R=16000", torch.bfloat16)]["ms"],
        "pool_14x14": {f"{name} {str(dt)[6:]}": e for (name, dt), e in mk_kernels.items()
                       if not name.startswith("bwd ")},
        "mask_keypoint": mask_kp,
        "quant": quant,
        "anchor_stage1": anchor,
        "pool_512": eval_gaps["k1_512"],
        "eval_gaps": {k: v for k, v in eval_gaps.items() if k != "k1_512"},
        "artifact": artifact,
        "supp_aug": supp_aug,
        "card": card,
    }, {
        "name": "roi_head",
        "route": "cuda",
        "source": HEAD_SOURCE,
        "replaces": HEAD_REPLACES,
        "launches": head_launches["full 2000/img, fused head"],
        "launches_by_path": head_launches,
        "shape": "R=16000 rois (8 images x 2000) of (7, 7, 256) + 8 supports, bf16",
        "max_abs_err": k3["max_abs_err"],
        "tolerance": f"{HEAD_TOL[torch.bfloat16]} abs (f32 cases: {HEAD_TOL[torch.float32]} abs)",
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "unfused_head_ms": k3["unfused_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_share": k3["bound_share"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
        "max_abs_err_f32": k3f["max_abs_err"],
        "ms_f32": k3f["ms"],
        "plain_ms_f32": k3f["plain_ms"],
        "bound_ms_f32": k3f["bound_ms"],
        "bound_by_f32": k3f["bound_by"],
        "bound_share_f32": k3f["bound_share"],
        "unfused_head_ms_f32": k3f["unfused_ms"],
        "ms_f32_r4096": head_checks_result[(4096, torch.float32)]["ms"],
        "unfused_head_ms_f32_r4096": head_checks_result[(4096, torch.float32)]["unfused_ms"],
        "f32_forward": f32_cells,
        "variant_widths": variants["head_widths"],
        "variant_fused_forwards": variants["fused_forwards"],
        "card": card,
    }]
    k2 = gn_checks[("relu", torch.bfloat16)]
    k2f = gn_checks[("relu", torch.float32)]
    kernels.append({
        "name": "group_norm",
        "route": "cuda",
        "source": GN_SOURCE,
        "replaces": GN_REPLACES,
        "launches": paths["FusedGroupNorm, 5 tower levels"]["group_norm"],
        "launches_by_path": {label: n["group_norm"] for label, n in paths.items()},
        "shape": "(8, 104, 152, 256) bf16 (P3 of the FCOS tower), act relu",
        "max_abs_err": k2["max_abs_err"],
        "tolerance": "1 bf16 ulp (f32: 1e-4 abs; f32 at input mean 100: 3e-2 abs)",
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "library": "torch.nn.functional.group_norm + relu",
        "per_launch_ms": k2["per_launch_ms"],
        "back_to_back_ms": k2["back_to_back_ms"],
        "host_ms": k2["host_ms"],
        "ms_f32": k2f["ms"],
        "per_launch_ms_f32": k2f["per_launch_ms"],
        "back_to_back_ms_f32": k2f["back_to_back_ms"],
        "bound_ms_f32": k2f["bound_ms"],
        "library_ms_f32": k2f["library_ms"],
        "vs_library_by_level": gn_checks["vs_library_by_level"],
        "card": card,
    })
    for name, source, replaces, tool in (("roi_align_v3", V3_SOURCE, V3_REPLACES, "tune_roialign_v3"),
                                         ("roi_align_v4", V4_SOURCE, V4_REPLACES, "tune_roialign_v3")):
        v = variant_checks[(name, "R=16000", torch.bfloat16)]
        vf = variant_checks[(name, "R=16000", torch.float32)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": paths[tool][name],
            "launches_by_path": {label: n[name] for label, n in paths.items()},
            "shape": "batch-8 832x1216 pyramid, C=256, R=16000 rois, 7x7, bf16",
            "max_abs_err": v["max_abs_err"],
            "tolerance": "0 (bit for bit, f32 and bf16, every case)",
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"],
            "bound_share": v["bound_share"],
            "library_ms": None,
            "gflop": v["gflop"],
            "launches_per_call": v["launches_per_call"],
            "per_launch_ms": v["per_launch_ms"],
            "ms_r4096": variant_checks[(name, "R=4096", torch.bfloat16)]["ms"],
            "p3_skew_fresh_ms": variant_checks[(name, "p3-skew R=16000", torch.bfloat16)]["ms"],
            "ms_f32": vf["ms"],
            "bound_ms_f32": vf["bound_ms"],
            "p3_skew_fresh_ms_f32": variant_checks[(name, "p3-skew R=16000", torch.float32)]["ms"],
            "card": card,
        })
    bwd = bwd_checks[("proposals 7x7 R=1024", torch.bfloat16)]
    kernels.append({
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": BWD_SOURCE,
        "replaces": BWD_REPLACES,
        "launches": paths["train step"]["roi_align_bwd"],
        "launches_by_path": {label: n["roi_align_bwd"] for label, n in paths.items()},
        "launches_per_train_step": paths["train step"]["roi_align_bwd"] // steps,
        "shape": "grad (1024, 7, 7, 256) bf16 -> the batch-8 832x1216 pyramid's gradient",
        "max_abs_err": bwd["max_abs_err"],
        "tolerance": f"1 bf16 ulp + {GRAD_ATOL} x max|grad| of the plain gradient "
                     f"(summed in float64) "
                     f"(f32: rtol {GRAD_RTOL} + the same atol); bit-identical run to run",
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "bound_share": bwd["bound_share"],
        "library_ms": None,
        "launches_per_call": bwd["launches_per_call"],
        "bits_device_ms": bwd["bits_device_ms"],
        "body_device_ms": bwd["body_device_ms"],
        "clustered_ms": bwd_checks[("GT-clustered 7x7 R=1024", torch.bfloat16)]["ms"],
        "clustered_ms_f32": bwd_checks[("GT-clustered 7x7 R=1024", torch.float32)]["ms"],
        "support_7x7_ms": bwd_checks[("support 7x7 R=8", torch.bfloat16)]["ms"],
        "support_1x1_ms": [bwd_checks[(f"support 1x1 P{lvl} R=8", torch.bfloat16)]["ms"]
                           for lvl in range(3, 8)],
        "ms_f32": bwd_checks[("proposals 7x7 R=1024", torch.float32)]["ms"],
        "bound_ms_f32": bwd_checks[("proposals 7x7 R=1024", torch.float32)]["bound_ms"],
        "pool_14x14": {f"{name[4:]} {str(dt)[6:]}": e for (name, dt), e in mk_kernels.items()
                       if name.startswith("bwd ")},
        "train_step": {k: v for k, v in train.items() if k != "losses"},
        "small_train_check": small_train,
        "train_variants": {"full_width": {k: {n: v for n, v in e.items() if n != "losses"}
                                          for k, e in variants["full_width"].items()},
                           "small": variants["small"]},
        "card": card,
    })
    h1 = evalcli["h1"]
    kernels.append({
        "name": "resize_normalize_pad",
        "route": "cuda",
        "source": H1_SOURCE,
        "replaces": H1_REPLACES,
        "launches": paths["eval CLI (test_net)"]["resize_normalize_pad"],
        "launches_by_path": {label: n["resize_normalize_pad"] for label, n in paths.items()},
        "launches_per_batch": 1,
        "shape": "one launch per batch: 8 VOC-sized uint8 queries (500x375 / 375x500) -> "
                 "(8, 832, 1216, 3) or (8, 1216, 832, 3) float32, resized to 800x1066 / "
                 "1066x800, and their 8 supports -> (8, 416, 416, 3)",
        "max_abs_err": h1["max_abs_err"],
        "tolerance": "0 (bit for bit, every case)",
        "ms": h1["batch"]["device_ms"] or h1["batch"]["b2b_ms"],
        "ms_by": "torch.profiler, device time of the launch" if h1["batch"]["device_ms"]
                 else "CUDA events, back to back (the profiler kept no kernel record)",
        "host_ms": h1["batch"]["host_ms"],
        "one_call_ms": h1["batch"]["one_call_ms"],
        "plain_ms": h1["queries"]["plain_ms"] + h1["supports"]["plain_ms"],
        "bound_ms": h1["batch"]["bound_ms"],
        "bound_by": "bytes",
        "bound_share": h1["batch"]["bound_share"],
        "library_ms": h1["queries"]["library_ms"] + h1["supports"]["library_ms"],
        "library": "16 x torch.nn.functional.interpolate(bilinear, antialias=True) (the "
                   "queries and the supports), resize only",
        "queries": h1["queries"],
        "supports": h1["supports"],
        "cli": evalcli["cli"],
        "loader": evalcli["loader"],
        "launches_train_cli_run_b": paths["train CLI run B"]["resize_normalize_pad"],
        "supp_aug_batch": {"support_slots": supp_aug["cli"]["h1_support_slots"],
                           "max_abs_err": supp_aug["cli"]["h1_max_abs_err"]},
        "train_cli": {k: v for k, v in traincli.items() if k != "losses"},
        "card": card,
    })
    for k in kernels[2:]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: not launched on its own path")
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; total {sum(phase_s.values()):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
