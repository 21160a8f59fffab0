"""The op boundary (``oneshotdet_tpu_torch/ops/library.py``) on the CPU: each
custom op's fake implementation gives the real one's output shapes and
dtypes, ``torch.library.opcheck`` passes (schema, fake tensor, autograd
registration, AOT dispatch), each op's CPU implementation is its plain
version, and the public wrappers (``multilevel_roi_align``,
``fused_roi_head``, ``nms_keep_mask``) call the ops. K1's registered
autograd against the plain gradient: ``test_torch_port_roi_align_grad.py``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from oneshotdet_tpu_torch.ops import library, nms
from oneshotdet_tpu_torch.ops import roi_align as ra
from oneshotdet_tpu_torch.ops import roi_head_fused as rf
from torch_port_common import relation_head_setup

SCALES = [0.125, 0.0625, 0.03125, 0.015625, 0.0078125]
LEVEL_HW = ((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))


def _roi_args(dtype=torch.float32, n=12, c=8, valid=True, out_hw=(7, 7), seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(2, h, w, c, generator=g).to(dtype) for h, w in LEVEL_HW]
    xy = torch.rand(n, 2, generator=g) * torch.tensor([140.0, 110.0])
    wh = torch.exp(torch.rand(n, 2, generator=g) * 4)
    b = torch.randint(0, 2, (n, 1), generator=g).float()
    rois = torch.cat([b, xy, xy + wh], 1)
    levels = ra.fpn_level_map(rois[:, 1:], 3, 7)
    v = (torch.rand(n, generator=g) > 0.3) if valid else None
    return feats, rois, levels, v, list(out_hw), SCALES, 2


def _head_args(dtype=torch.float32, per_image=8, b=2):
    params, head, roi, supp = relation_head_setup(b, per_image)
    ops = rf.kernel_operands(rf.pack_roi_head_params(head), dtype, tiles=False)
    operands, _ = library.head_operand_lists(ops)
    return (torch.from_numpy(roi).to(dtype), torch.from_numpy(supp).to(dtype), operands, [],
            ops["ncls"], per_image)


def _nms_args(k=40, batch=(2,), seed=0):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(*batch, k, 2, generator=g) * 60
    boxes = torch.cat([xy, xy + 4 + torch.rand(*batch, k, 2, generator=g) * 30], -1)
    return boxes, torch.rand(*batch, k, generator=g), torch.rand(*batch, k, generator=g) > 0.2, 0.5


def _fake_matches_real(op, args):
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                     [mode.from_tensor(x) for x in a] if isinstance(a, list) and a
                     and isinstance(a[0], torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert tuple(f.shape) == tuple(r.shape) and f.dtype == r.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["7x7 valid", "1x1 no valid"])
def test_roi_align_fake_matches_real(dtype, case):
    args = _roi_args(dtype, valid="no valid" not in case,
                     out_hw=(1, 1) if "1x1" in case else (7, 7))
    _fake_matches_real(library.roi_align, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_fake_matches_real(dtype):
    feats, rois, levels, valid, out_hw, scales, g = _roi_args(dtype)
    grad = torch.randn(rois.shape[0], *out_hw, feats[0].shape[-1]).to(dtype)
    shapes = [d for f in feats for d in f.shape]
    _fake_matches_real(library.roi_align_backward,
                       (grad, shapes, rois, levels, valid, out_hw, scales, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_head_fused_fake_matches_real(dtype):
    _fake_matches_real(library.roi_head_fused, _head_args(dtype))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one image", "three images"])
def test_nms_keep_mask_fake_matches_real(batch):
    _fake_matches_real(library.nms_keep_mask, _nms_args(batch=batch))


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "no valid"])
def test_opcheck_roi_align(valid):
    feats, rois, levels, v, out_hw, scales, g = _roi_args(valid=valid)
    feats = [f.requires_grad_() for f in feats]
    torch.library.opcheck(library.roi_align, (feats, rois, levels, v, out_hw, scales, g))


def test_opcheck_roi_align_backward():
    feats, rois, levels, valid, out_hw, scales, g = _roi_args()
    grad = torch.randn(rois.shape[0], *out_hw, feats[0].shape[-1])
    torch.library.opcheck(library.roi_align_backward,
                          (grad, [d for f in feats for d in f.shape], rois, levels, valid,
                           out_hw, scales, g))


def test_opcheck_roi_head_fused():
    torch.library.opcheck(library.roi_head_fused, _head_args())


def test_opcheck_nms_keep_mask():
    torch.library.opcheck(library.nms_keep_mask, _nms_args())


def test_ops_on_the_cpu_are_the_plain_versions():
    feats, rois, levels, valid, out_hw, scales, g = _roi_args()
    want = ra.multilevel_roi_align_plain(feats, rois, levels, tuple(out_hw), scales, g, valid)
    assert torch.equal(ra.multilevel_roi_align(feats, rois, levels, out_hw, scales, g, valid),
                       want)
    grad = torch.randn(rois.shape[0], *out_hw, feats[0].shape[-1])
    flat = library.roi_align_backward(grad, [d for f in feats for d in f.shape], rois, levels,
                                      valid, out_hw, scales, g)
    per_level = ra.multilevel_roi_align_backward_plain(grad, [f.shape for f in feats],
                                                       torch.float32, rois, levels,
                                                       tuple(out_hw), scales, g, valid)
    assert torch.equal(flat, torch.cat([p.reshape(-1) for p in per_level]))
    roi, supp, operands, tiles, ncls, per_image = _head_args()
    _, head, _, _ = relation_head_setup(2, per_image)
    w = rf.pack_roi_head_params(head)
    for a, b in zip(rf.fused_roi_head(roi, supp, w, per_image),
                    rf.fused_roi_head_plain(roi, supp, w, per_image)):
        assert torch.equal(a, b)
    boxes, scores, v, t = _nms_args()
    assert torch.equal(nms.nms_keep_mask(boxes, scores, v, t),
                       nms.nms_keep_mask_plain(boxes, scores, v, t))


def test_wrappers_call_the_ops(monkeypatch):
    """The public functions go through the registered ops (so that export
    traces them as ``oneshotdet::`` calls), counted by the dispatcher's
    Python implementations."""
    calls = []
    for name in ("roi_align", "roi_head_fused", "nms_keep_mask"):
        op = getattr(library, name)
        monkeypatch.setattr(library, name, lambda *a, _op=op, _n=name: (calls.append(_n),
                                                                       _op(*a))[1])
    feats, rois, levels, valid, out_hw, scales, g = _roi_args()
    ra.multilevel_roi_align(feats, rois, levels, out_hw, scales, g, valid)
    roi, supp, _, _, _, per_image = _head_args()
    _, head, _, _ = relation_head_setup(2, per_image)
    rf.fused_roi_head(roi, supp, rf.pack_roi_head_params(head), per_image)
    nms.nms_keep_mask(*_nms_args())
    assert calls == ["roi_align", "roi_head_fused", "nms_keep_mask"]


def test_cpu_tensors_never_launch():
    before = (ra.roi_align_launches, ra.roi_align_bwd_launches, rf.fused_roi_head_launches)
    feats, rois, levels, valid, out_hw, scales, g = _roi_args()
    feats = [f.requires_grad_() for f in feats]
    out = ra.multilevel_roi_align(feats, rois, levels, out_hw, scales, g, valid)
    out.sum().backward()
    roi, supp, operands, tiles, ncls, per_image = _head_args()
    library.roi_head_fused(roi, supp, operands, tiles, ncls, per_image)
    assert (ra.roi_align_launches, ra.roi_align_bwd_launches,
            rf.fused_roi_head_launches) == before
    assert np.isfinite(feats[0].grad.numpy()).all()
