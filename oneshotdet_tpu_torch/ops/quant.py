"""Int8 inference for the conv stack and the heads, TPU.QUANT (counterpart
of ``oneshotdet_tpu/ops/quant.py``).

Two modes, eval only:

  - ``"int8"``: symmetric int8 with a static per-output-channel weight
    scale ``s_w[o] = max|W[o]| / 127 + 1e-12`` and a dynamic per-tensor
    activation scale ``s_a = max|x| / 127 + 1e-12`` (one reduction over the
    whole tensor, every image and every ROI of it); codes are
    ``clip(round_half_even(v / s), -127, 127)``; the product accumulates in
    int32 and is dequantized as ``y * (s_a * s_w)`` in float32, the bias
    added in float32, then cast to the activation dtype
    (``QuantConv2d``, ``QuantLinear``);
  - ``"int8_weight"``: weights stored as int8 codes with their per-channel
    scales (``quantize_weights_int8``, offline) or fake-quantized per call
    from float weights (the same numbers), dequantized into the activation
    dtype as ``codes * scale``; the conv or matmul and the bias add run in
    the activation dtype (``WeightQuantConv2d``, ``WeightQuantLinear``).

Layouts are the port's: conv weights OIHW, linear weights (out, in), so the
output channel is the first axis. Every scale divides by a tensor, never by
a Python number: CUDA turns a division by a scalar into a multiplication by
its reciprocal, which moves codes at rounding ties. The scales follow the
JAX package's op-by-op semantics (a true division); under ``jax.jit`` XLA
rewrites ``max / 127 + 1e-12`` into a fused multiply-add with 1/127, which
differs from it in the last bit for some maxima.

The int32 products are ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card,
the same call on the CPU): a 1x1 conv is one GEMM over the channels-last
rows (a strided one subsamples first), a kxk conv one GEMM over an int8
im2col whose columns are (ky, kx, c_in), taken a chunk of images at a time
to bound its memory. Operands are zero-padded to the GEMM's shape rules
(m > 16, k and n multiples of 8), which leaves the sums exact. No float
product stands in for an int8 one, on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# im2col bytes (int8 columns plus the int32 and float32 outputs) per chunk
IM2COL_CHUNK_BYTES = 1 << 29


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max|v| / 127 + 1e-12 in float32, divided by a tensor."""
    return absmax / torch.full_like(absmax, 127.0) + 1e-12


def _codes(vf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)


def fake_quant_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float weight whose first axis is the output channel -> (int8 codes
    of its shape, (out,) float32 scales)."""
    wf = w.detach().to(torch.float32)
    scale = _scale(wf.abs().amax(dim=tuple(range(1, w.dim()))))
    return _codes(wf, scale.reshape((-1,) + (1,) * (w.dim() - 1))), scale


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in, kh, kw) float -> (int8 weights, (out,) float32 scales)."""
    if w.dim() != 4:
        raise ValueError(f"quantize_weight_per_channel: an OIHW weight, got {tuple(w.shape)}")
    return fake_quant_weight(w)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic symmetric quantization: (int8 codes of x's shape,
    0-dim float32 scale)."""
    xf = x.to(torch.float32)
    scale = _scale(xf.abs().amax())
    return _codes(xf, scale), scale


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (n, k) int8 transposed -> (m, n) int32, exact.
    ``torch._int_mm`` with its operands zero-padded to m >= 32 and k, n
    multiples of 8 (its CUDA shape rules), the padding cut off after."""
    if a.dtype != torch.int8 or b_t.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8 operands, got {a.dtype} and {b_t.dtype}")
    m, k = a.shape
    n = b_t.shape[0]
    pk, pn, pm = -k % 8, -n % 8, max(0, 32 - m)
    if pk:
        a, b_t = F.pad(a, (0, pk)), F.pad(b_t, (0, pk))
    if pm:
        a = F.pad(a, (0, 0, 0, pm))
    if pn:
        b_t = F.pad(b_t, (0, 0, 0, pn))
    y = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return y[:m, :n] if pm or pn else y


def _dequant(acc: torch.Tensor, ascale: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """int32 accumulators (..., out) -> float32, the scales' product formed first."""
    return acc.to(torch.float32) * (ascale * wscale)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv_codes(xq: torch.Tensor, ascale: torch.Tensor, wq: torch.Tensor,
                    wscale: torch.Tensor, stride=1, padding=0, dilation=1,
                    bias: torch.Tensor = None, out_dtype=torch.float32) -> torch.Tensor:
    """The conv of int8 codes: ``xq`` (N, C, H, W) int8 (best channels-last),
    ``wq`` (O, C, kh, kw) int8, with their scales -> (N, O, Ho, Wo)
    channels-last ``out_dtype``: int32 sums, dequantized in float32, plus
    ``bias`` in float32, then cast."""
    n, cin, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = xq.permute(0, 2, 3, 1)                                     # NHWC
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    w_rows = wq.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)  # (ky, kx, c) columns
    per_image = ho * wo * (kh * kw * cin + 8 * cout)
    step = max(1, IM2COL_CHUNK_BYTES // max(per_image, 1))
    outs = []
    for i in range(0, n, step):
        xi = x[i:i + step]
        taps = [xi[:, ky * dh: ky * dh + (ho - 1) * sh + 1: sh,
                   kx * dw: kx * dw + (wo - 1) * sw + 1: sw]
                for ky in range(kh) for kx in range(kw)]
        cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
        y = _dequant(int_mm(cols.reshape(-1, kh * kw * cin), w_rows), ascale, wscale)
        if bias is not None:
            y = y + bias.to(torch.float32)
        outs.append(y.to(out_dtype).reshape(xi.shape[0], ho, wo, cout))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0,
              dilation=1) -> torch.Tensor:
    """Dynamic-activation int8 conv, NCHW float x and OIHW float weight ->
    float32 NCHW (channels-last), dequantized."""
    wq, wscale = quantize_weight_per_channel(weight)
    xq, ascale = quantize_activation(x)
    return int8_conv_codes(xq, ascale, wq, wscale, stride, padding, dilation)


def int8_dot(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., K) float, weight (F, K) float -> (..., F) float32: the
    per-tensor activation scale, per-row weight scales, int32 sums."""
    wq, wscale = fake_quant_weight(weight)
    xq, ascale = quantize_activation(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return _dequant(acc, ascale, wscale).reshape(x.shape[:-1] + (weight.shape[0],))


class QuantConv2d(nn.Conv2d):
    """A conv in dynamic-activation int8 (the JAX package's ``QuantConv8``):
    ``Conv2d``'s parameters, the float32 weight quantized per call."""

    def forward(self, x):
        if self.groups != 1 or self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise NotImplementedError("QuantConv2d: groups 1, explicit zero padding")
        wq, wscale = quantize_weight_per_channel(self.weight)
        xq, ascale = quantize_activation(x)
        return int8_conv_codes(xq, ascale, wq, wscale, self.stride, self.padding,
                               self.dilation, self.bias, x.dtype)


class QuantLinear(nn.Linear):
    """A linear layer in dynamic-activation int8 (``QuantDense8``)."""

    def forward(self, x):
        y = int8_dot(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.to(torch.float32)
        return y.to(x.dtype)


class _WeightQuant:
    """Int8 weight storage for ``WeightQuantConv2d`` / ``WeightQuantLinear``.

    ``weight`` is float32 (fake-quantized per call) or, after
    ``quantize_weights_int8``, the int8 codes with their (out,) float32
    scales in the buffer ``weight_scale`` (None while the weight is float,
    so it is not in the state dict). A state dict sets the storage: an int8
    ``weight`` with its ``weight_scale`` loads as codes, a float one as a
    float weight, both strictly."""

    def _init_weight_scale(self):
        self.register_buffer("weight_scale", None)

    def set_int8_weight(self, codes: torch.Tensor, scale: torch.Tensor) -> None:
        self.weight = nn.Parameter(codes.to(torch.int8), requires_grad=False)
        self.weight_scale = scale.to(torch.float32)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None:
            with torch.no_grad():
                dev = self.weight.device
                if w.dtype == torch.int8 and self.weight.dtype != torch.int8:
                    self.weight = nn.Parameter(torch.empty(self.weight.shape, dtype=torch.int8,
                                                           device=dev), requires_grad=False)
                    self.weight_scale = torch.empty((self.weight.shape[0],), device=dev)
                elif w.dtype != torch.int8 and self.weight.dtype == torch.int8:
                    self.weight = nn.Parameter(torch.empty(self.weight.shape, device=dev))
                    self.weight_scale = None
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def dequantized_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """codes * scale in ``dtype`` (each cast first, as the JAX package)."""
        if self.weight.dtype == torch.int8:
            codes, scale = self.weight, self.weight_scale
        else:
            codes, scale = fake_quant_weight(self.weight)
        shape = (-1,) + (1,) * (self.weight.dim() - 1)
        return codes.to(dtype) * scale.to(dtype).reshape(shape)


class WeightQuantConv2d(_WeightQuant, nn.Conv2d):
    """A conv with int8 weights and activations in their own dtype
    (``WeightQuantConv8``); the bias is added in the activation dtype."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_weight_scale()

    def forward(self, x):
        y = self._conv_forward(x, self.dequantized_weight(x.dtype), None)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]


class WeightQuantLinear(_WeightQuant, nn.Linear):
    """A linear layer with int8 weights (``WeightQuantDense8``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_weight_scale()

    def forward(self, x):
        y = F.linear(x, self.dequantized_weight(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def _check_mode(quant: str) -> str:
    if quant in ("", "none", None):
        return "none"
    if quant in ("int8", "int8_weight"):
        return quant
    raise ValueError(f"unknown TPU.QUANT mode: {quant!r}")


def make_conv(quant: str, *args, **kwargs) -> nn.Conv2d:
    """The port's ``Conv2d`` ('none'), ``QuantConv2d`` ('int8') or
    ``WeightQuantConv2d`` ('int8_weight'), built with ``Conv2d``'s
    arguments; ValueError for another mode."""
    from ..models.layers import Conv2d

    cls = {"none": Conv2d, "int8": QuantConv2d, "int8_weight": WeightQuantConv2d}
    return cls[_check_mode(quant)](*args, **kwargs)


def make_dense(quant: str, *args, **kwargs) -> nn.Linear:
    """The port's ``Linear``, ``QuantLinear`` or ``WeightQuantLinear`` by
    mode."""
    from ..models.layers import Linear

    cls = {"none": Linear, "int8": QuantLinear, "int8_weight": WeightQuantLinear}
    return cls[_check_mode(quant)](*args, **kwargs)


@torch.no_grad()
def quantize_weights_int8(model: nn.Module) -> nn.Module:
    """The offline weight-only transform of a TPU.QUANT='int8_weight' model:
    every ``WeightQuantConv2d`` / ``WeightQuantLinear`` whose weight is
    float takes its int8 codes and (out,) scales (``fake_quant_weight``, so
    its outputs do not change). Every other parameter stays as it is (the
    stem, the predictors, compress_0, whose query and support halves are
    fake-quantized apart). In place; returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, _WeightQuant) and mod.weight.dtype != torch.int8:
            mod.set_int8_weight(*fake_quant_weight(mod.weight))
    return model
