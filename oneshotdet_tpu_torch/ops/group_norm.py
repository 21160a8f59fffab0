"""GroupNorm + activation: the plain PyTorch version, the CUDA kernels'
wrapper and an autograd function.

Counterpart of ``oneshotdet_tpu/ops/pallas_groupnorm.py`` (``group_norm_act``
and its Pallas kernels ``_moments_kernel`` / ``_make_normalize_kernel``,
driven by ``_gn_pallas``). Inputs are channels-last ``(B, ..., C)``;
statistics are taken per (image, group) over every non-batch axis in float32
with the one-pass formula ``var = max(E[x^2] - E[x]^2, 0)``, as the JAX
package does (two-pass or Welford statistics would be more accurate at a
large input mean, and would give another result). The output has the
input's dtype.

``GroupNormAct`` (and ``group_norm_act``) dispatches on the device of ``x``:
CPU tensors take ``group_norm_act_plain``; CUDA tensors launch the kernels of
``csrc/group_norm.cu`` or raise. The JAX package takes its Pallas kernel only
behind ``ONESHOT_PALLAS_GN=1`` and above a size threshold, a choice made for
the TPU; here a CUDA tensor always takes the kernel. The backward is the JAX
package's ``_gn_bwd`` in plain PyTorch (it is plain jnp there too).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

# Kernel launches since the count was last reset (set it to 0 to reset).
group_norm_launches = 0

_ACT_CODE = {None: 0, "relu": 1, "leaky": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 528      # blocks a launch aims for: 4 per SM of an H100
_THREADS = 256            # threads a block aims for
# rows each lane takes at least, where the map allows (2 measured faster than
# 4 at P6/P7 of the tower, where a map has few rows, and slower at P5)
_MIN_LANE_ROWS = 2
_MAX_BATCH = 65535        # the grid's second axis
# per (device index, stream handle): the int32 arrival counters, one per
# image up to _MAX_BATCH, zeroed at allocation and left at 0 by the kernels.
# Calls on one stream run in order, so they share them; they are never
# replaced. A call made while its stream is captured into a CUDA graph takes
# counters of its own from the graph's memory instead (_arrival_counters).
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_forward_fn = None


def _act(y: torch.Tensor, act: Optional[str], slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "leaky":
        return torch.where(y >= 0, y, y * slope)
    return y


def _check_args(x, gamma, beta, num_groups, act):
    c = x.shape[-1]
    if x.dim() < 2 or c % num_groups != 0:
        raise ValueError(f"group_norm_act: x {tuple(x.shape)} needs (B, ..., C) with C "
                         f"divisible by num_groups={num_groups}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"group_norm_act: gamma/beta must be ({c},)")
    if act not in _ACT_CODE:
        raise ValueError(f"group_norm_act: act {act!r} (None, 'relu' or 'leaky')")


def _bshape(x: torch.Tensor):
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


def channels_per_thread(channels: int) -> int:
    """Channels a kernel thread owns in a row: 8 where C allows (one 16-byte
    vector of bf16, two of f32), else 4 or 2. It depends on C alone, so the
    kernels sum bf16 and f32 inputs in the same order."""
    for cpt in (8, 4, 2):
        if channels % cpt == 0:
            return cpt
    return 1


@functools.lru_cache(maxsize=256)
def moments_layout(batch: int, spatial: int, channels: int):
    """How the kernels cut the rows: ``(splits, rows, lanes, cpt)``. A thread
    owns ``cpt`` channels (``channels_per_thread``), ``C / cpt`` threads
    cover a row and a block of about ``_THREADS`` threads reads ``lanes``
    rows at once. Each image's ``spatial`` rows are cut into ``splits`` runs
    of ``rows`` (about ``_TARGET_BLOCKS`` blocks in all, at least
    ``_MIN_LANE_ROWS`` rows a lane where the map has them); within a run,
    lane ``l`` takes the rows ``l, l + lanes, ...``."""
    cpt = channels_per_thread(channels)
    lanes = max(1, _THREADS // (channels // cpt))
    splits = max(1, min(math.ceil(_TARGET_BLOCKS / batch), spatial // (_MIN_LANE_ROWS * lanes)))
    rows = math.ceil(spatial / splits)
    return math.ceil(spatial / rows), rows, lanes, cpt


def _seq_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one add at a time, in increasing index order."""
    acc = torch.zeros_like(t.select(dim, 0))
    for i in range(t.shape[dim]):
        acc = acc + t.select(dim, i)
    return acc


def group_norm_act_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                         act: Optional[str] = None, slope: float = 0.2):
    """The plain PyTorch forward (``_stats`` + ``_gn_jnp``): returns
    ``(y, mean_c, inv_c)`` with per-(image, channel) float32 statistics.

    The sums run in the kernels' order (``moments_layout``: each lane's rows
    in turn, then the lanes of a run, then the runs in order as the image's
    last block adds them, then the group's channels), one add at a time in
    float32, and every division is a true one, so the kernels equal this
    version bit for bit."""
    _check_args(x, gamma, beta, num_groups, act)
    b, c = x.shape[0], x.shape[-1]
    cpg = c // num_groups
    xf = x.reshape(b, -1, c).to(torch.float32)
    spatial = xf.shape[1]
    splits, rows, lanes, _ = moments_layout(b, spatial, c)
    steps = -(-rows // lanes)
    # zero rows at the end of each run add nothing to its sums
    xr = torch.nn.functional.pad(xf, (0, 0, 0, splits * rows - spatial)).reshape(b, splits, rows, c)
    xr = torch.nn.functional.pad(xr, (0, 0, 0, steps * lanes - rows))
    xr = xr.reshape(b, splits, steps, lanes, c)
    s1 = torch.zeros((b, splits, lanes, c), dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s1)
    for i in range(steps):
        v = xr[:, :, i]
        s1 = s1 + v
        s2 = s2 + v * v
    s1 = _seq_sum(_seq_sum(s1, 2), 1)
    s2 = _seq_sum(_seq_sum(s2, 2), 1)
    count = torch.full((1,), float(spatial * cpg), dtype=torch.float32, device=x.device)
    g1 = _seq_sum(s1.reshape(b, num_groups, cpg), 2) / count
    g2 = _seq_sum(s2.reshape(b, num_groups, cpg), 2) / count
    eps_f = torch.full((1,), eps, dtype=torch.float32, device=x.device)
    # the float64 root rounded to float32 is the correctly rounded float32
    # root, as the kernel's sqrtf gives; torch's float32 sqrt on the CPU can
    # be one ulp off
    var = torch.clamp(g2 - g1 * g1, min=0.0) + eps_f
    inv = 1.0 / torch.sqrt(var.double()).float()
    mean_c = g1.repeat_interleave(cpg, dim=1)
    inv_c = inv.repeat_interleave(cpg, dim=1)
    shape = _bshape(x)
    y = (x.to(torch.float32) - mean_c.reshape(shape)) * inv_c.reshape(shape)
    y = y * gamma.to(torch.float32) + beta.to(torch.float32)
    return _act(y, act, slope).to(x.dtype), mean_c, inv_c


def bind(lib: ctypes.CDLL):
    """(forward, error_string) of a library built from csrc/group_norm.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.oneshot_group_norm_forward
    fn.argtypes = [p, i, i, ctypes.c_longlong, i, i, f, i, f, p, p, i, i, i, i,
                   p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.oneshot_group_norm_error_string.argtypes = [ctypes.c_int]
    lib.oneshot_group_norm_error_string.restype = ctypes.c_char_p
    return fn, lib.oneshot_group_norm_error_string


def _kernel():
    global _forward_fn
    if _forward_fn is None:
        from .. import csrc

        _forward_fn = bind(csrc.load("group_norm"))
    return _forward_fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"group_norm kernel: {msg}")


def kernel_plan(x, gamma, beta, num_groups: int = 32, act: Optional[str] = None):
    """The kernels' checks of their arguments other than the device, made
    before any launch: returns ``moments_layout`` for ``x`` or raises
    ValueError on an input the kernels do not take."""
    _check_args(x, gamma, beta, num_groups, act)
    _check(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(x.is_contiguous(), "x must be contiguous channels-last (B, ..., C)")
    b, c = x.shape[0], x.shape[-1]
    spatial = x.numel() // max(b * c, 1)
    _check(c % 2 == 0 and c <= 2048, f"channel count {c} must be even and <= 2048")
    _check(b >= 1 and spatial >= 1, "empty input")
    _check(b <= _MAX_BATCH, f"batch {b} above {_MAX_BATCH} (the grid's second axis)")
    _check(b * spatial * c < 2 ** 62, "input too large")
    layout = moments_layout(b, spatial, c)
    nbytes = min(16, layout[3] * x.element_size())
    _check(x.data_ptr() % nbytes == 0, f"x must be aligned to {nbytes} bytes (one load vector)")
    return layout


def _arrival_counters(dev: torch.device, stream: int, batch: int) -> torch.Tensor:
    """Zeroed arrival counters for a call on ``stream``: the stream's own
    (``_counters``), or, while the stream is being captured into a CUDA
    graph, ``batch`` new ones zeroed by the graph at each replay, so that
    no two graphs, nor a graph and the eager calls, share counters."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(batch, dtype=torch.int32, device=dev)
    key = (dev.index, stream)
    counters = _counters.get(key)
    if counters is None:
        counters = _counters[key] = torch.zeros(_MAX_BATCH, dtype=torch.int32, device=dev)
    return counters


def group_norm_act_cuda(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                        act: Optional[str] = None, slope: float = 0.2):
    """Launch the CUDA kernels (moments with the statistics, then
    normalize) on the current stream, with that stream's arrival counters;
    returns ``(y, mean_c, inv_c)``. Raises on any input they do not take."""
    global group_norm_launches
    dev = x.device
    _check(dev.type == "cuda", "x must be a CUDA tensor")
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return group_norm_act_cuda(x, gamma, beta, num_groups, eps, act, slope)
    splits, rows, lanes, cpt = kernel_plan(x, gamma, beta, num_groups, act)
    if gamma.dtype != torch.float32 or gamma.device != dev or not gamma.is_contiguous():
        gamma = gamma.to(device=dev, dtype=torch.float32).contiguous()
    if beta.dtype != torch.float32 or beta.device != dev or not beta.is_contiguous():
        beta = beta.to(device=dev, dtype=torch.float32).contiguous()
    b, c = x.shape[0], x.shape[-1]
    spatial = x.numel() // (b * c)
    stats = torch.empty((2, b, c), dtype=torch.float32, device=dev)   # mean_c, inv_c
    y = torch.empty_like(x)
    fn, error_string = _kernel()
    partial = torch.empty(b * splits * 2 * c, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    counters = _arrival_counters(dev, stream, b)
    rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], b, spatial, c, num_groups, float(eps),
            _ACT_CODE[act], float(slope), gamma.data_ptr(), beta.data_ptr(), cpt, splits, rows,
            lanes, partial.data_ptr(), counters.data_ptr(), stats.data_ptr(),
            stats.data_ptr() + 4 * b * c, y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"group_norm kernel launch failed: {error_string(rc).decode()} ({rc})")
    group_norm_launches += 1
    return y, stats[0], stats[1]


def group_norm_act_backward(x, gamma, beta, mean_c, inv_c, dy, num_groups, act, slope):
    """``_gn_bwd``: (dx, dgamma, dbeta) from the saved statistics."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // num_groups
    shape = _bshape(x)
    xhat = (x.to(torch.float32) - mean_c.reshape(shape)) * inv_c.reshape(shape)
    dyf = dy.to(torch.float32)
    if act is not None:
        pre_act = xhat * gamma.to(torch.float32) + beta.to(torch.float32)
        if act == "relu":
            dyf = dyf * (pre_act > 0)
        else:
            dyf = dyf * torch.where(pre_act >= 0, 1.0, slope)
    reduce_dims = tuple(range(x.dim() - 1))
    dgamma = (dyf * xhat).sum(dim=reduce_dims)
    dbeta = dyf.sum(dim=reduce_dims)
    dxh_g = (dyf * gamma.to(torch.float32)).reshape(b, -1, num_groups, cpg)
    xhat_g = xhat.reshape(b, -1, num_groups, cpg)
    m1 = dxh_g.mean(dim=(1, 3), keepdim=True)
    m2 = (dxh_g * xhat_g).mean(dim=(1, 3), keepdim=True)
    dx = (dxh_g - m1 - xhat_g * m2) * inv_c.reshape(b, 1, num_groups, cpg)
    return dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


class GroupNormAct(torch.autograd.Function):
    """GroupNorm + activation with the JAX package's custom VJP: the forward
    is the kernel on CUDA and the plain version on the CPU; the backward is
    ``_gn_bwd`` in plain PyTorch on the saved ``x, gamma, beta, mean_c,
    inv_c``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups=32, eps=1e-5, act=None, slope=0.2):
        fwd = group_norm_act_plain if x.device.type == "cpu" else group_norm_act_cuda
        y, mean_c, inv_c = fwd(x, gamma, beta, num_groups, eps, act, slope)
        ctx.save_for_backward(x, gamma, beta, mean_c, inv_c)
        ctx.cfg = (num_groups, act, slope)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean_c, inv_c = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_act_backward(x, gamma, beta, mean_c, inv_c, dy,
                                                    *ctx.cfg)
        return dx, dgamma, dbeta, None, None, None, None


def group_norm_act(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                   act: Optional[str] = None, slope: float = 0.2) -> torch.Tensor:
    """Fused GroupNorm + optional activation (None, 'relu', 'leaky') of a
    channels-last ``(B, ..., C)`` tensor; differentiable."""
    return GroupNormAct.apply(x, gamma, beta, num_groups, eps, act, slope)
