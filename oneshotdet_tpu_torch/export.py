"""Serving export (counterpart of ``oneshotdet_tpu/export.py``): the eval
program traced once by ``torch.export`` at static bucket shapes, the weights
inside, reloadable in another process without the model-building Python or
the config system.

Two artifact kinds, as in the JAX package:

- **full**: ``f(pixels, sizes, supp_pixels, supp_sizes, target_ids) ->
  (xyxy, scores, valid)``, the support features recomputed per call
  (``GeneralizedRCNN.forward``);
- **cached_support**: the pair ``support(supp_pixels, supp_sizes) ->
  (pooled, supp_7x7)`` and ``detect(pixels, sizes, pooled, supp_7x7,
  target_ids) -> (xyxy, scores, valid)``, the support branch run once per
  class (``compute_support_features`` / ``detect_with_support``).

Artifacts are box-only, as the JAX package's: with MODEL.MASK_ON /
KEYPOINT_ON the programs run and hold no mask or keypoint head.

Any stage 1 exports: FCOS, the anchor RPN and RetinaNet (the submodule
``rpn`` either way). The anchor grids of the artifact's query bucket are
built before the trace and held by the programs as constants; with
RPN_ONLY the detect program holds no ``roi_heads`` and returns the stage-1
output's (xyxy, scores, valid). Every NMS of the path (FCOS's, the anchor
RPN's five per-level calls, RetinaNet's chunked one, stage 2's) is the op
``oneshotdet::nms_keep_mask``, so its data-dependent loop stays out of the
traced graph.

Input contract: pixels are NHWC float32, normalized and zero-padded to the
artifact's static shape (never space-to-depth blocked: the port's stem takes
plain pixels, so a bundle's meta says ``"host_s2d": false``); sizes are
float32 (B, 2) true (h, w); target_ids int32 (B,).

An artifact is an ``ExportedProgram`` (``save`` / ``load``) of the device
the model was built on, with the port's kernels as the custom ops of
``ops.library``: K1 on every ROIAlign and, where the model was built with the
fused head (``ONESHOT_PALLAS_ROI_HEAD=1``), K3, whose operands the program
holds as its own buffers. The head's route is fixed at trace time.
``save_compiled`` / ``load_compiled`` stand for the JAX package's serialized
executables: an AOTInductor package of the program, compiled for the device
it was exported on. A process that loads one imports ``ops.library`` first
(this module does).
"""

import copy
import dataclasses
import json
import logging
import os
import subprocess
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils import _pytree

from .ops import library  # noqa: F401  (registers the ops the programs call)
from .ops.roi_head_fused import kernel_operands, pack_roi_head_params
from .structures import ImageBatch

logger = logging.getLogger(__name__)

# Inductor rounds a fused kernel's intermediates to bf16 where the eager
# program does, so the compiled program follows the eager numbers
INDUCTOR_CONFIGS = {"emulate_precision_casts": True}


def _outputs(dets):
    return dets.xyxy, dets.get_field("scores"), dets.valid


class _Program(nn.Module):
    """One eval entry point, ``entry(model, *inputs)``, as a module's forward
    for ``torch.export``. The module holds a shallow copy of ``model`` with
    only the submodules ``keep`` names (the ones the entry point runs), so
    the program carries only their weights. With the fused head, the head's
    kernel operands (packed once, here) are this module's buffers, so the
    program holds them as constants; the traced head reads them through
    ``ROIBoxHead.operands_override``."""

    def __init__(self, model, entry, keep):
        super().__init__()
        self.model = copy.copy(model)
        self.model._modules = {k: v for k, v in model._modules.items() if k in keep}
        heads = "roi_heads" in self.model._modules
        if heads:
            # box-only: the mask and keypoint heads neither run nor carry
            # their weights
            heads = copy.copy(model.roi_heads)
            heads._modules = {"box": model.roi_heads.box}
            self.model._modules["roi_heads"] = heads
            self.model.config = dataclasses.replace(model.config, mask_on=False,
                                                    keypoint_on=False)
        self.entry = entry
        self.head_operands = nn.Module()
        self.operand_meta = None
        if heads and model.config.fused_roi_head and not model.config.prepool_compress:
            head = model.roi_heads.box
            dev = next(model.parameters()).device
            ops = kernel_operands(pack_roi_head_params(head), model.dtype,
                                  tiles=dev.type != "cpu")
            self.operand_meta = {k: v for k, v in ops.items() if not isinstance(v, torch.Tensor)}
            for k, v in ops.items():
                if isinstance(v, torch.Tensor):   # each its own storage
                    self.head_operands.register_buffer(k, v.clone())

    def forward(self, *args):
        head = self.model.roi_heads.box if self.operand_meta is not None else None
        if head is not None:
            head.operands_override = dict(self.operand_meta,
                                          **dict(self.head_operands.named_buffers()))
        try:
            return self.entry(self.model, *args)
        finally:
            if head is not None:
                head.operands_override = None


def _export(model, entry, keep, args):
    grids = getattr(model._modules.get("rpn"), "generator", None)
    built = None if grids is None else dict(grids._grids)
    try:
        with torch.no_grad():
            ep = torch.export.export(_Program(model, entry, keep), tuple(args), strict=False)
    finally:
        # a grid made inside the trace is a traced value, not a tensor
        leaked = built is not None and grids._grids.keys() != built.keys()
        if leaked:
            grids._grids = built
    if leaked:
        raise RuntimeError("anchor grids were built inside the export trace: the query "
                           "bucket's level shapes were not prebuilt")
    return ep


def level_shapes(hw: Tuple[int, int], levels: int = 5):
    """(H, W) of P3 .. P(2 + levels) for an (H, W) input: each stride-2 step
    of the stem, the max pool, the ResNet stages and P6 / P7 takes the
    ceiling of half."""
    (h, w), out = hw, []
    for k in range(1, 3 + levels):
        h, w = -(-h // 2), -(-w // 2)
        if k >= 3:
            out.append((h, w))
    return out


def _output_examples(ep):
    """Zero tensors of an ExportedProgram's output shapes, in its output
    structure (``jax.eval_shape`` of the support side, in the JAX package)."""
    out = [n.meta["val"] for n in ep.graph.output_node().args[0]]
    return _pytree.tree_unflatten(
        [torch.zeros(v.shape, dtype=v.dtype, device=v.device) for v in out],
        ep.call_spec.out_spec)


def export_eval(cfg, model, *, batch: int = 8, query_hw: Optional[Tuple[int, int]] = None,
                supp_hw: Optional[Tuple[int, int]] = None, kind: str = "full"):
    """Trace the eval program of ``model`` (the port's ``GeneralizedRCNN``,
    on the device the artifact is for) at static shapes. Returns one
    ``ExportedProgram`` (kind="full") or a (support, detect) pair of them
    (kind="cached_support"); the weights are inside, and for the anchor RPN
    and RetinaNet the anchor grids of ``query_hw`` too."""
    if kind not in ("full", "cached_support"):
        raise ValueError(f"unknown export kind: {kind!r}")
    query_hw = tuple(query_hw or cfg.TPU.QUERY_BUCKETS[0])
    supp_hw = tuple(supp_hw or cfg.TPU.SUPP_BUCKET)
    dev = next(model.parameters()).device
    if model.config.stage1 != "fcos":
        model.rpn.generator.grid_anchors(level_shapes(query_hw, len(model.config.fpn_strides)),
                                         dev)
    pixels = torch.zeros((batch, *query_hw, 3), dtype=torch.float32, device=dev)
    sizes = torch.tensor([query_hw] * batch, dtype=torch.float32, device=dev)
    supp_pixels = torch.zeros((batch, *supp_hw, 3), dtype=torch.float32, device=dev)
    supp_sizes = torch.tensor([supp_hw] * batch, dtype=torch.float32, device=dev)
    target_ids = torch.ones((batch,), dtype=torch.int32, device=dev)

    if kind == "full":
        def full(m, pixels, sizes, supp_pixels, supp_sizes, target_ids):
            return _outputs(m._forward_eval(ImageBatch(pixels, sizes),
                                            ImageBatch(supp_pixels, supp_sizes), target_ids))

        return _export(model, full, set(model._modules),
                       (pixels, sizes, supp_pixels, supp_sizes, target_ids))

    def support(m, supp_pixels, supp_sizes):
        return m._support_branch(ImageBatch(supp_pixels, supp_sizes), batch)

    def detect(m, pixels, sizes, pooled, supp_7x7, target_ids):
        return _outputs(m._detect_with_support(ImageBatch(pixels, sizes), pooled, supp_7x7,
                                               target_ids))

    supp_net = "supp_backbone" if model.config.siamese_backbone else "backbone"
    exp_support = _export(model, support, {supp_net}, (supp_pixels, supp_sizes))
    # trace the detect side against the support side's output shapes
    pooled, supp_7x7 = _output_examples(exp_support)
    exp_detect = _export(model, detect, {"backbone", "rpn", "roi_heads"},
                         (pixels, sizes, pooled, supp_7x7, target_ids))
    return exp_support, exp_detect


def _program_device(ep) -> str:
    """The device type of an ExportedProgram's weights."""
    for v in ep.state_dict.values():
        return v.device.type
    raise ValueError("the exported program holds no weights")


def _replace_into(path: str, write) -> None:
    """``write(f)`` into ``<path>.tmp`` through a file object, then move it
    to ``path``."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def export_serving(cfg, model, path: str, *, query_hw: Optional[Tuple[int, int]] = None,
                   supp_hw: Optional[Tuple[int, int]] = None,
                   compile_executable: bool = True) -> bool:
    """Export the batch-1 serving bundle of ``model`` to ``path``:

    - ``<path>.support`` / ``<path>.detect``: the ExportedProgram pair;
    - ``<path>.support.exec`` / ``<path>.detect.exec``: their AOTInductor
      packages for the device the model is on (``save_compiled``), unless
      ``compile_executable=False``;
    - ``<path>.meta.json``: the input contract (buckets, normalization,
      resize rule; ``host_s2d`` always false) and the device, so that
      ``predictor.ArtifactPredictor`` serves frames without the model-building
      Python or the config system.

    Returns whether the compiled pair was written."""
    query_hw = tuple(query_hw or cfg.TPU.QUERY_BUCKETS[0])
    supp_hw = tuple(supp_hw or cfg.TPU.SUPP_BUCKET)
    pair = export_eval(cfg, model, batch=1, query_hw=query_hw, supp_hw=supp_hw,
                       kind="cached_support")
    save(pair, path)
    c = cfg.INPUT
    meta = {
        "query_bucket": list(query_hw),
        "supp_bucket": list(supp_hw),
        "host_s2d": False,
        "pixel_mean": [float(v) for v in c.PIXEL_MEAN],
        "pixel_std": [float(v) for v in c.PIXEL_STD],
        "to_bgr255": bool(c.TO_BGR255),
        "min_size_test": int(c.MIN_SIZE_TEST),
        "max_size_test": int(c.MAX_SIZE_TEST),
        "supp_min_size_test": int(c.SUPP_MIN_SIZE_TEST),
        "supp_max_size_test": int(c.SUPP_MAX_SIZE_TEST),
        "device": _program_device(pair[0]),
    }
    _replace_into(path + ".meta.json", lambda f: f.write(json.dumps(meta, indent=2).encode()))
    return save_compiled(pair, path) if compile_executable else False


def openmp_cxx() -> Optional[str]:
    """A C++ compiler whose ``-print-file-name`` finds OpenMP's
    ``libgomp.spec`` (AOTInductor links its wrapper with ``-fopenmp``):
    ``$CXX``, else the first ``g++`` or ``c++`` on ``PATH`` that does; None
    where none does."""
    names = [os.environ.get("CXX")] + [os.path.join(d, n) for d in
                                       os.environ.get("PATH", "").split(os.pathsep)
                                       for n in ("g++", "c++")]
    for cxx in names:
        if not (cxx and os.path.isfile(cxx) and os.access(cxx, os.X_OK)):
            continue
        try:
            spec = subprocess.run([cxx, "-print-file-name=libgomp.spec"], capture_output=True,
                                  text=True, timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            continue
        if os.path.isabs(spec) and os.path.exists(spec):
            return cxx
    return None


def save_compiled(exported, path: str) -> bool:
    """Compile one ExportedProgram (or a pair) with AOTInductor for the
    device it was exported on, into ``<path>.exec`` (a pair: ``<path>.support.exec``
    and ``<path>.detect.exec``), with ``<path>.exec.json`` naming that device;
    the C++ compiler is ``openmp_cxx()``'s. Returns False, and logs why,
    where the toolchain cannot compile (no C++ compiler that links OpenMP, no
    Triton for a CUDA program); other failures raise."""
    if isinstance(exported, tuple):
        return (save_compiled(exported[0], path + ".support")
                and save_compiled(exported[1], path + ".detect"))
    from torch._inductor import aoti_compile_and_package
    from torch._inductor.exc import CppCompileError, InductorError, InvalidCxxCompiler

    cxx = openmp_cxx()
    if cxx is None:
        logger.warning("save_compiled: no C++ compiler on PATH links OpenMP (libgomp.spec)")
        return False
    try:
        _replace_into(path + ".exec", lambda f: aoti_compile_and_package(
            exported, package_path=f, inductor_configs={"cpp.cxx": cxx, **INDUCTOR_CONFIGS}))
    except InductorError as e:
        if not isinstance(e.inner_exception, (ImportError, InvalidCxxCompiler, CppCompileError)):
            raise
        logger.warning("save_compiled: the toolchain cannot compile %s: %s", path, e)
        return False
    info = {"device": _program_device(exported)}
    _replace_into(path + ".exec.json", lambda f: f.write(json.dumps(info).encode()))
    return True


def load_compiled(path: str, device=None):
    """The AOTInductor package saved by ``save_compiled``, loaded and ready to
    call with the program's inputs (no tracing, no compile), or None when
    it is absent or was built for another device than ``device`` (default
    "cuda")."""
    device = torch.device("cuda" if device is None else device)
    if not (os.path.exists(path + ".exec") and os.path.exists(path + ".exec.json")):
        return None
    with open(path + ".exec.json") as f:
        info = json.load(f)
    if info["device"] != device.type:
        return None
    from torch._inductor import aoti_load_package

    with open(path + ".exec", "rb") as f:
        return aoti_load_package(f)


def save(exported, path: str) -> None:
    """Write one ExportedProgram to ``path`` (a pair as ``<path>.support`` and
    ``<path>.detect``)."""
    if isinstance(exported, tuple):
        save(exported[0], path + ".support")
        save(exported[1], path + ".detect")
        return
    _replace_into(path, lambda f: torch.export.save(exported, f))


def load(path: str):
    """Read an ExportedProgram; call it as ``load(path).module()(*args)``."""
    with open(path, "rb") as f:
        return torch.export.load(f)
