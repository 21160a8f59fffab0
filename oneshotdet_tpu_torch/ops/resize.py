"""Resize + normalize + pad of a batch of uint8 RGB images: the plain
PyTorch version and the CUDA kernel's wrapper.

Counterpart of the JAX package's native host pass
``oneshotdet_tpu/csrc/fast_collate.cpp::resize_normalize_pad`` (one call
per image into its zero-padded batch slot, ``data/collate.py:48``): PIL's
triangle filter with its coefficients in float64 (the support widened by
the scale when downsampling), a horizontal pass summed in float64 and stored
as float32, a vertical pass in float64, one round half away from zero, a
clamp to 0..255, then BGR255 (or /255) and ``(c - mean) / std`` in float32.
That is the C++ pass's rounding, not PIL's own two-pass one.

A batch is packed once (``pack_images``: the sources and their meta in one
buffer, one upload) and may go to several outputs at once, each with its
own slot and normalization (``Slot``): the data path's queries and
supports are one ``resize_normalize_pad_slots`` call.
``resize_normalize_pad`` is the one-output case. Both dispatch on the
device of the packed sources: CPU tensors take the plain versions; CUDA
tensors launch the kernel of ``csrc/resize_normalize_pad.cu`` (one launch
for every output) or raise. The plain version repeats the kernel's
operations in its order, one rounding at a time, so the two agree bit for
bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

# Kernel launches since the count was last reset (set it to 0 to reset).
resize_launches = 0

# per image: source byte offset, h0, w0, oh, ow, output, slot in the output
META_FIELDS = 7
# the kernel's shape (csrc/resize_normalize_pad.cu): a block owns a strip of
# at most STRIP_MAX output columns and walks at most RUN_MAX rows, GROUP at a
# time
STRIP_MAX, RUN_MAX, GROUP, THREADS, MAX_OUTPUTS = 64, 64, 8, 192, 4
# the rows a block walks: RUN_MAX, or SHORT_RUN for an output whose grid at
# RUN_MAX would fill the card's resident blocks (BLOCKS_PER_SM a SM) less
# than twice: a block's walk is serial, so a small grid is paced by it
SHORT_RUN, BLOCKS_PER_SM = 32, 4
# its static shared memory: the normalized values (3 x 256 floats) and the
# first taps and tap counts of STRIP_MAX column and RUN_MAX row filters
STATIC_SMEM = 3 * 256 * 4 + 2 * STRIP_MAX * 4 + 2 * RUN_MAX * 4
# an H100 block's shared memory (opt-in) less the static part; the library
# reports the card's own figure at its first use (``oneshot_resize_init``)
DYNAMIC_LIMIT = 232448 - STATIC_SMEM
RING_MAX = 64       # resampled source rows a block holds, at most
STAGE_MAX = 16      # source rows a batch of copies stages, at most


@dataclasses.dataclass
class PackedImages:
    """A batch of uint8 RGB sources back to back on one device.

    pixels: (N,) uint8, image i at ``meta[i, 0]``, (h0, w0, 3) row-major;
      16-byte aligned, its buffer padded to a multiple of 16 bytes.
    meta: (B, 7) int64 on the same device: offset, h0, w0, oh, ow, output,
      slot (the image's index among its output's images). pixels and meta
      are views of one buffer, uploaded by one copy.
    shapes: ((h0, w0, oh, ow), ...) on the host; (oh, ow) is the resample
      target of each image.
    outputs: each image's output, on the host (ascending: an output's images
      are consecutive).
    needs: the batch's maxima of ``_needs``, the kernel's plan's inputs
      (worked out once, when the batch is packed).
    """

    pixels: torch.Tensor
    meta: torch.Tensor
    shapes: Tuple[Tuple[int, int, int, int], ...]
    outputs: Tuple[int, ...] = ()
    needs: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.outputs:
            self.outputs = (0,) * len(self.shapes)
        if not self.needs:
            self.needs = _batch_needs(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)


def pack_images(images: Sequence[np.ndarray], out_hw: Sequence[Tuple[int, int]],
                device=None, outputs: Sequence[int] = None) -> PackedImages:
    """Pack (h0, w0, 3) uint8 arrays with their resample targets onto
    ``device`` (default "cuda"); ``outputs`` gives each image's output
    (default all 0; ascending). The meta and the sources share one host
    buffer (pinned for a CUDA device) and one asynchronous copy on the
    current stream."""
    device = torch.device("cuda" if device is None else device)
    if len(images) != len(out_hw) or not images:
        raise ValueError("pack_images: one (oh, ow) per image, at least one image")
    outputs = (0,) * len(images) if outputs is None else tuple(int(o) for o in outputs)
    if len(outputs) != len(images) or outputs[0] != 0 or any(
            b - a not in (0, 1) for a, b in zip(outputs, outputs[1:])):
        raise ValueError(f"pack_images: outputs {outputs} must count up from 0, one per image, "
                         "each output's images together")
    shapes, offsets, total = [], [], 0
    for im, (oh, ow) in zip(images, out_hw):
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"pack_images: need (h, w, 3) uint8, got {im.shape} {im.dtype}")
        h0, w0 = im.shape[:2]
        if min(h0, w0, oh, ow) < 1:
            raise ValueError(f"pack_images: empty source {im.shape[:2]} or target {(oh, ow)}")
        shapes.append((int(h0), int(w0), int(oh), int(ow)))
        offsets.append(total)
        total += im.size
    slots, seen = [], {}
    for o in outputs:
        slots.append(seen.get(o, 0))
        seen[o] = slots[-1] + 1
    meta_bytes = _align16(len(images) * META_FIELDS * 8)
    # the kernel copies whole 16-byte chunks: the sources start aligned and
    # the buffer ends on a multiple of 16
    buf = torch.empty(meta_bytes + _align16(total), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:meta_bytes].view(np.int64)[:len(images) * META_FIELDS] = np.array(
        [(off,) + s + (o, k) for off, s, o, k in zip(offsets, shapes, outputs, slots)],
        np.int64).reshape(-1)
    for im, off in zip(images, offsets):
        host[meta_bytes + off:meta_bytes + off + im.size] = np.ascontiguousarray(im).reshape(-1)
    if device.type != "cpu":
        buf = buf.to(device, non_blocking=True)
    meta = buf[:len(images) * META_FIELDS * 8].view(torch.int64).view(len(images), META_FIELDS)
    return PackedImages(buf[meta_bytes:meta_bytes + total], meta, tuple(shapes), outputs)


@dataclasses.dataclass(frozen=True)
class Slot:
    """One output of a resize: its (pad_h, pad_w) slot and normalization,
    mean and std as float32 values."""

    pad_hw: Tuple[int, int]
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    to_bgr255: bool = True


def slot(pad_hw, mean, std, to_bgr255: bool = True) -> Slot:
    """A checked ``Slot``: mean and std rounded to float32 once."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("resize_normalize_pad: mean and std need 3 values each")
    pad_h, pad_w = (int(v) for v in pad_hw)
    return Slot((pad_h, pad_w), tuple(mean.tolist()), tuple(std.tolist()), bool(to_bgr255))


def filter_size(in_size: int, out_size: int) -> int:
    """Taps of the widest filter of an in_size -> out_size resample."""
    return math.ceil(max(in_size / out_size, 1.0)) * 2 + 1


def filters(in_size: int, out_size: int, device=None):
    """PIL's precompute_coeffs for the triangle filter, in float64:
    (first tap (out,), tap count (out,), weights (out, ksize)); weights past
    a filter's count are 0."""
    f64 = torch.float64
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = filter_size(in_size, out_size)
    center = (torch.arange(out_size, dtype=f64, device=device) + 0.5) * scale
    first = (center - support + 0.5).to(torch.int64).clamp(min=0)
    count = (center + support + 0.5).to(torch.int64).clamp(max=in_size) - first
    taps = torch.arange(ksize, device=device)
    arg = ((taps[None, :] + first[:, None]).to(f64) - center[:, None] + 0.5) * ss
    w = torch.where(arg < 0, arg + 1.0, 1.0 - arg).clamp(min=0.0)
    w = torch.where(taps[None, :] < count[:, None], w, torch.zeros_like(w))
    ww = torch.zeros(out_size, dtype=f64, device=device)
    for i in range(ksize):          # the C++ sum, one tap at a time
        ww = ww + w[:, i]
    k = torch.where((ww != 0)[:, None], w / ww[:, None], w)
    return first, count, k


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def _resample(src: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(h0, w0, 3) uint8 -> (oh, ow, 3) float64 before rounding."""
    h0, w0 = src.shape[:2]
    dev = src.device
    s = src.to(torch.float64)
    first, _, k = filters(w0, ow, dev)
    tmp = torch.zeros((h0, ow, 3), dtype=torch.float64, device=dev)
    for i in range(k.shape[1]):
        idx = (first + i).clamp(max=w0 - 1)
        tmp = tmp + k[:, i][None, :, None] * s[:, idx, :]
    tmp = tmp.to(torch.float32).to(torch.float64)
    first, _, k = filters(h0, oh, dev)
    acc = torch.zeros((oh, ow, 3), dtype=torch.float64, device=dev)
    for i in range(k.shape[1]):
        idy = (first + i).clamp(max=h0 - 1)
        acc = acc + k[:, i][:, None, None] * tmp[idy]
    return acc


def _check_slots(packed: PackedImages, slots) -> Tuple[Slot, ...]:
    slots = tuple(slots)
    if not all(isinstance(s, Slot) for s in slots):
        raise ValueError("resize_normalize_pad: slots must be resize.slot(...) values")
    if not slots or packed.outputs[-1] >= len(slots):
        raise ValueError(f"resize_normalize_pad: images go to {packed.outputs[-1] + 1} outputs, "
                         f"{len(slots)} slots given")
    for (h0, w0, oh, ow), o in zip(packed.shapes, packed.outputs):
        pad_h, pad_w = slots[o].pad_hw
        if oh > pad_h or ow > pad_w:
            raise ValueError(f"resize_normalize_pad: target {(oh, ow)} exceeds the slot "
                             f"{(pad_h, pad_w)}")
    return slots


def resize_normalize_pad_slots_plain(packed: PackedImages,
                                     slots: Sequence[Slot]) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: one (images, pad_h, pad_w, 3) float32
    tensor per slot on the sources' device, each image resampled to its
    (oh, ow), normalized and zero-padded in its output's slot."""
    slots = _check_slots(packed, slots)
    dev = packed.pixels.device
    counts = [packed.outputs.count(o) for o in range(len(slots))]
    outs = tuple(torch.zeros((n, *s.pad_hw, 3), dtype=torch.float32, device=dev)
                 for n, s in zip(counts, slots))
    inv255 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(255.0, dtype=torch.float32)
    for (h0, w0, oh, ow), (off, k), o in zip(packed.shapes, packed.meta[:, [0, 6]].tolist(),
                                              packed.outputs):
        s = slots[o]
        mean = torch.tensor(s.mean, dtype=torch.float32, device=dev)
        std = torch.tensor(s.std, dtype=torch.float32, device=dev)
        src = packed.pixels[off:off + h0 * w0 * 3].reshape(h0, w0, 3)
        c = _round_half_away(_resample(src, oh, ow)).clamp(0.0, 255.0).to(torch.float32)
        c = c.flip(-1) if s.to_bgr255 else c * inv255.to(dev)
        outs[o][k, :oh, :ow] = (c - mean) / std
    return outs


def resize_normalize_pad_plain(packed: PackedImages, pad_hw, mean, std,
                               to_bgr255: bool = True) -> torch.Tensor:
    """The one-output plain version: (B, pad_h, pad_w, 3) float32."""
    return resize_normalize_pad_slots_plain(packed, (slot(pad_hw, mean, std, to_bgr255),))[0]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's strip width, filters, ring, staging and shared-memory
    layout for a batch (``launch_plan``)."""

    strip: int          # output columns a block owns
    kw: int             # taps of the widest column filter
    kh: int             # ... and row filter
    row_filters: int    # row filters a block holds at once (RUN_MAX or GROUP)
    ring_rows: int      # resampled source rows it holds (a power of two)
    stage_rows: int     # source rows a batch of copies stages (a power of two)
    row_bytes: int      # bytes of one staged source row
    offsets: Tuple[int, int, int, int]   # kx, ky, ring, stage
    smem: int           # dynamic shared memory, bytes

    def fields(self) -> Tuple[int, ...]:
        return (self.strip, self.kw, self.kh, self.row_filters, self.ring_rows,
                self.stage_rows, self.row_bytes) + self.offsets


def _span(in_size: int, out_size: int, n: int) -> int:
    """Most source pixels that n consecutive outputs of an in_size ->
    out_size resample read together: their filters' centers lie (n - 1) *
    scale apart and each reaches support + 0.5 to either side, one more for
    the truncation of its first tap."""
    scale = in_size / out_size
    return min(in_size, int((n - 1) * scale + 2 * max(scale, 1.0) + 1) + 1)


@functools.lru_cache(maxsize=4096)
def _needs(h0: int, w0: int, oh: int, ow: int) -> Tuple[int, int, int, int, int]:
    """One image's widest column and row filters, the source rows a group
    of GROUP output rows reads, the rows it adds, and the source pixels a
    full strip reads."""
    return (filter_size(w0, ow), filter_size(h0, oh), _span(h0, oh, min(GROUP, oh)),
            -(-GROUP * h0 // oh) + 2, _span(w0, ow, min(STRIP_MAX, ow)))


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _batch_needs(shapes) -> Tuple[int, ...]:
    return tuple(max(v) for v in zip(*(_needs(*s) for s in set(shapes))))


def launch_plan(shapes, limit: int = DYNAMIC_LIMIT, needs=None) -> LaunchPlan:
    """The layout for a batch of (h0, w0, oh, ow): the widest strip (64,
    halved down to 1 for a steep horizontal downscale) whose shared memory
    fits ``limit``, with every row filter of a block's run where they fit
    (else a group's) and the largest ring and staging that fit, up to what
    the batch can use; ``needs``, the batch's ``_batch_needs``, if known.
    Raises ValueError where nothing fits (a downscale too steep)."""
    kw, kh, ring, stage, span = needs or _batch_needs(shapes)
    ring, stage = min(RING_MAX, _pow2(ring)), min(STAGE_MAX, _pow2(stage))
    for strip in (64, 32, 16, 8, 4, 2, 1):
        if strip < STRIP_MAX:
            span = max(_span(w0, ow, min(strip, ow)) for _, w0, _, ow in shapes)
        plan = _strip_plan(strip, span, kw, kh, ring, stage, limit)
        if plan is not None:
            return plan
    raise ValueError(f"resize kernel: filters of {kw} x {kh} taps need more than {limit} bytes "
                     "of shared memory: downscale too steep")


@functools.lru_cache(maxsize=1024)
def _strip_plan(strip, span, kw, kh, ring, stage, limit):
    """``launch_plan`` at one strip width, or None where nothing fits."""
    row_bytes = (3 * span + 30 + 15) // 16 * 16
    ring_row = (strip * 3 + 3) // 4 * 4 * 8    # a ring row's bytes (4-double pieces)
    fixed = _align16(kw * strip * 8)

    def rest(r, st):
        return r * ring_row + 2 * st * row_bytes

    for rows in (RUN_MAX, GROUP):
        room = limit - fixed - _align16(rows * kh * 8)
        r, st = ring, stage
        while r > 1 and rest(r, st) > room:
            r //= 2     # the ring first: a steep downscale reads many rows per group
            if rest(r, st) > room and st > 1:
                st //= 2
        while st > 1 and rest(r, st) > room:
            st //= 2
        if rest(r, st) > room:
            continue
        sizes = (kw * strip * 8, rows * kh * 8, r * ring_row, 2 * st * row_bytes)
        offsets = tuple(sum(_align16(n) for n in sizes[:i]) for i in range(4))
        return LaunchPlan(strip, kw, kh, rows, r, st, row_bytes, offsets,
                          sum(_align16(n) for n in sizes))
    return None


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


_lib = None
_cards = {}     # device index -> (the kernel's dynamic shared memory limit, SM count)


def bind(lib):
    """Set the C signatures of a loaded resize library (this checkout's
    ``csrc/resize_normalize_pad.cu`` or a copy of it) and check its shape
    against the wrapper's; returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.oneshot_resize_normalize_pad.argtypes = [p, p, i, p, p, p, p, i, p]
    lib.oneshot_resize_normalize_pad.restype = i
    lib.oneshot_resize_init.argtypes = []
    lib.oneshot_resize_init.restype = i
    lib.oneshot_resize_error_string.argtypes = [i]
    lib.oneshot_resize_error_string.restype = ctypes.c_char_p
    shape = (ctypes.c_int * 6)()
    lib.oneshot_resize_shape(shape)
    if tuple(shape) != (STRIP_MAX, RUN_MAX, GROUP, THREADS, MAX_OUTPUTS, META_FIELDS):
        raise RuntimeError(f"resize kernel: its shape {tuple(shape)} is not the wrapper's")
    return lib


def _kernel():
    global _lib
    if _lib is None:
        from .. import csrc

        _lib = bind(csrc.load("resize_normalize_pad"))
    return _lib


def _runs(slots, counts, strip, sms):
    """Each output's run length: RUN_MAX, or SHORT_RUN where its grid at
    RUN_MAX is under two fillings of the card's resident blocks."""
    return [RUN_MAX if k * -(-s.pad_hw[1] // strip) * -(-s.pad_hw[0] // RUN_MAX)
            >= 2 * BLOCKS_PER_SM * sms else SHORT_RUN for s, k in zip(slots, counts)]


def _launch(lib, packed, slots, plan, runs, outs, counts, stream):
    """The ctypes call: per-output geometry and normalization as flat host
    arrays."""
    n = len(slots)
    geom, norm, first = [], [], 0
    for s, k, run in zip(slots, counts, runs):
        pad_h, pad_w = s.pad_hw
        geom += [pad_h, pad_w, first, k, -(-pad_w // plan.strip), -(-pad_h // run), run]
        norm += [*s.mean, *s.std, float(s.to_bgr255)]
        first += k
    return lib.oneshot_resize_normalize_pad(
        packed.pixels.data_ptr(), packed.meta.data_ptr(), n,
        (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
        (ctypes.c_int * len(geom))(*geom), (ctypes.c_float * len(norm))(*norm),
        (ctypes.c_int * 11)(*plan.fields()), plan.smem, stream)


def resize_normalize_pad_slots_cuda(packed: PackedImages,
                                    slots: Sequence[Slot]) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel once for every output; raises on any input it
    does not take."""
    global resize_launches
    dev = packed.pixels.device
    if dev.type != "cuda":
        raise ValueError("resize kernel: the packed sources must be on a CUDA device")
    slots = _check_slots(packed, slots)
    b = len(packed)
    px = packed.pixels
    if not (px.dtype == torch.uint8 and px.dim() == 1 and px.is_contiguous()
            and px.data_ptr() % 16 == 0
            and px.untyped_storage().nbytes() - px.storage_offset() >= _align16(px.numel())):
        raise ValueError("resize kernel: pixels must be contiguous uint8 (N,), 16-byte aligned, "
                         "in a buffer padded to a multiple of 16 bytes (pack_images)")
    if not (packed.meta.dtype == torch.int64 and packed.meta.shape == (b, META_FIELDS)
            and packed.meta.is_contiguous() and packed.meta.device == dev):
        raise ValueError(f"resize kernel: meta must be contiguous int64 ({b}, {META_FIELDS}) "
                         "on the pixels' device")
    if len(slots) > MAX_OUTPUTS:
        raise ValueError(f"resize kernel: {len(slots)} outputs (at most {MAX_OUTPUTS})")
    counts = [packed.outputs.count(o) for o in range(len(slots))]
    lib = _kernel()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        card = _cards.get(index)
        if card is None:
            limit = lib.oneshot_resize_init()
            if limit < 0:
                err = lib.oneshot_resize_error_string(-limit).decode()
                raise RuntimeError(f"resize kernel: init failed: {err} ({-limit})")
            card = _cards[index] = (limit, torch.cuda.get_device_properties(index)
                                    .multi_processor_count)
        plan = launch_plan(packed.shapes, card[0], packed.needs)
        runs = _runs(slots, counts, plan.strip, card[1])
        outs = tuple(torch.empty((k, *s.pad_hw, 3), dtype=torch.float32, device=dev)
                     for s, k in zip(slots, counts))
        rc = _launch(lib, packed, slots, plan, runs, outs, counts,
                     torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        err = lib.oneshot_resize_error_string(rc).decode()
        raise RuntimeError(f"resize kernel launch failed: {err} ({rc})")
    resize_launches += 1
    return outs


def resize_normalize_pad_cuda(packed: PackedImages, pad_hw, mean, std,
                              to_bgr255: bool = True) -> torch.Tensor:
    """The one-output launch: (B, pad_h, pad_w, 3) float32 on the card."""
    return resize_normalize_pad_slots_cuda(packed, (slot(pad_hw, mean, std, to_bgr255),))[0]


def resize_normalize_pad_slots(packed: PackedImages,
                               slots: Sequence[Slot]) -> Tuple[torch.Tensor, ...]:
    """Every image of ``packed`` resampled to its target, normalized and
    written into its zero-padded slot of its output: one (images, pad_h,
    pad_w, 3) float32 tensor per ``Slot`` on the sources' device, one launch
    on the card."""
    if packed.pixels.device.type == "cpu":
        return resize_normalize_pad_slots_plain(packed, slots)
    return resize_normalize_pad_slots_cuda(packed, slots)


def resize_normalize_pad(packed: PackedImages, pad_hw, mean, std,
                         to_bgr255: bool = True) -> torch.Tensor:
    """Every image of ``packed`` resampled to its target, normalized and
    written into its zero-padded (pad_h, pad_w) slot of one (B, pad_h,
    pad_w, 3) float32 tensor on the sources' device."""
    return resize_normalize_pad_slots(packed, (slot(pad_hw, mean, std, to_bgr255),))[0]
