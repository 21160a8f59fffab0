"""The port's fused relation head (ops/roi_head_fused.py) against the JAX
package's Pallas kernel ``pallas_roi_head`` (interpret mode on the CPU), in
float32 at C = 256: the packed operands, the plain version at two per-image
support layouts, the plain version against the port's unfused head, the
support swap, the gate, the packing cache, and the CPU/CUDA dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.ops.pallas_roi_head import _pick_t, pallas_roi_head, roi_head_params_from_module
from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead
from oneshotdet_tpu_torch.ops import roi_head_fused as rf
from torch_port_common import relation_head_setup as _setup, t

# Both sides run float32 chains (JAX at HIGHEST precision); only the order of
# the sums differs, on outputs of order 1.
ATOL = 1e-4


@pytest.fixture(scope="module")
def two_images():
    return _setup(2, 16)


def test_pack_matches_jax_params(two_images):
    params, head, _, _ = two_images
    ref = roi_head_params_from_module(params)
    got = rf.pack_roi_head_params(head)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == tuple(np.shape(ref[k])), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("b, p", [(2, 16), (4, 8)], ids=["B2xP16", "B4xP8"])
def test_plain_matches_jax_kernel(b, p):
    params, head, roi, supp = _setup(b, p, seed=b)
    ref_l, ref_d = pallas_roi_head(jnp.asarray(roi), jnp.asarray(supp),
                                   roi_head_params_from_module(params), per_image=p,
                                   interpret=True)
    got_l, got_d = rf.fused_roi_head_plain(t(roi), t(supp), rf.pack_roi_head_params(head), p)
    assert got_l.shape == (b * p, 2) and got_d.shape == (b * p, 8)
    assert got_l.dtype == got_d.dtype == torch.float32
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=ATOL, rtol=0)


def test_plain_matches_unfused_head_and_follows_supports(two_images):
    _, head, roi, supp = two_images
    w = rf.pack_roi_head_params(head)
    got_l, got_d = rf.fused_roi_head(t(roi), t(supp), w, 16)
    ref_l, ref_d = head(t(roi), t(supp))
    torch.testing.assert_close(got_l, ref_l, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_d, ref_d, atol=ATOL, rtol=0)
    # with use_fused the head takes the fused path, with the same result
    fused_l, _ = head(t(roi), t(supp), use_fused=True)
    torch.testing.assert_close(fused_l, got_l, atol=0, rtol=0)
    # each image's ROIs read their own support
    swp_l, _ = rf.fused_roi_head(t(roi), t(supp[::-1]), w, 16)
    assert float((swp_l - got_l).abs().max()) > 1e-3


@pytest.mark.parametrize("p", [2000, 16, 24, 28, 7, 4])
def test_gate_matches_jax_block_rule(p):
    assert rf.fused_head_applies(p) == (_pick_t(p) > 0)


def test_gate_falls_back_to_the_layers(two_images, monkeypatch):
    """Where JAX's gate takes its XLA module (per-ROI supports, or a
    per-image count with no block size), the port runs its layers."""
    _, head, roi, supp = two_images
    calls = []
    monkeypatch.setattr(rf, "fused_roi_head_plain", lambda *a: calls.append(a))
    x = t(roi[:28])
    ref = head(x, t(supp[:1]))
    out = head(x, t(supp[:1]), use_fused=True)            # P = 28: no block size
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    per_roi = t(np.repeat(supp[:1], 28, axis=0))
    head(x, per_roi, use_fused=True)                       # B == N: one support per ROI
    assert not calls


def test_packed_operands_follow_load_state_dict(two_images):
    _, head, roi, supp = two_images
    before, _ = head(t(roi), t(supp), use_fused=True)
    sd = {k: v * 1.5 if k.startswith("fc7") else v for k, v in head.state_dict().items()}
    head2 = ROIBoxHead()
    head2.load_state_dict(head.state_dict())
    head2(t(roi), t(supp), use_fused=True)                 # fills the cache
    head2.load_state_dict(sd)
    after, _ = head2(t(roi), t(supp), use_fused=True)
    ref, _ = head2(t(roi), t(supp))
    assert float((after - before).abs().max()) > 1e-3
    torch.testing.assert_close(after, ref, atol=ATOL, rtol=0)


def test_bf16_plain_rounds_the_products_inputs(two_images):
    """bf16: the same chain on bf16-rounded operands; its outputs stay near
    the float32 ones (intermediates round to the bf16 grid)."""
    _, head, roi, supp = two_images
    w = rf.pack_roi_head_params(head)
    ref_l, ref_d = rf.fused_roi_head(t(roi), t(supp), w, 16)
    got_l, got_d = rf.fused_roi_head(t(roi).bfloat16(), t(supp).bfloat16(), w, 16)
    assert got_l.dtype == torch.float32
    assert 0 < float((got_l - ref_l).abs().max()) < 5e-2
    assert 0 < float((got_d - ref_d).abs().max()) < 5e-2


def test_cpu_tensors_never_launch_and_kernel_wrapper_refuses_them(two_images):
    _, head, roi, supp = two_images
    w = rf.pack_roi_head_params(head)
    before = rf.fused_roi_head_launches
    rf.fused_roi_head(t(roi), t(supp), w, 16)
    head(t(roi), t(supp), use_fused=True)
    assert rf.fused_roi_head_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rf.fused_roi_head_cuda(t(roi), t(supp), w, 16)


@pytest.mark.parametrize("widths, ok", [((256, 128, 1024), True), ((256, 128, 512), True),
                                        ((128, 64, 1024), False), ((256, 128, 1000), False),
                                        ((256, 64, 1024), False)])
def test_kernel_width_check(widths, ok):
    """The rule both sites share: C = 256, a 3x3 output of 128, MLP_HEAD_DIM
    a multiple of the kernel's GEMM tile."""
    if ok:
        rf.check_kernel_widths(*widths)
    else:
        with pytest.raises(NotImplementedError, match="fused relation head"):
            rf.check_kernel_widths(*widths)


@pytest.mark.parametrize("overrides", [("MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 128),
                                       ("MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 1000)],
                         ids=["C128", "hidden1000"])
def test_fused_head_widths_refused_at_build_off_the_cpu(overrides, monkeypatch):
    """With the opt-in on, a model for the card whose widths the kernel does
    not take is refused when it is built, before any CUDA call; a CPU model
    and a model without the opt-in build."""
    from oneshotdet_tpu_torch.models import build_detection_model
    from torch_port_common import small_cfgs

    _, cfg = small_cfgs(*overrides)
    monkeypatch.setenv("ONESHOT_PALLAS_ROI_HEAD", "1")
    with pytest.raises(NotImplementedError, match="fused relation head"):
        build_detection_model(cfg, device="cuda")
    assert build_detection_model(cfg, device="cpu").config.fused_roi_head
    monkeypatch.delenv("ONESHOT_PALLAS_ROI_HEAD")
    assert not build_detection_model(cfg, device="meta").config.fused_roi_head


def test_fused_gate_refuses_other_widths_off_the_cpu():
    """ROIBoxHead's gate raises before any work on tensors off the CPU (here
    meta tensors) whose widths the kernel does not take; on the CPU the
    plain fused path runs at any width."""
    rng = np.random.RandomState(7)
    head = ROIBoxHead(in_channels=64, representation_size=256)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.05))
    roi, supp = t(rng.randn(16, 7, 7, 64).astype(np.float32)), t(rng.randn(2, 7, 7, 64).astype(np.float32))
    with pytest.raises(NotImplementedError, match="fused relation head"):
        head.to("meta")(roi.to("meta"), supp.to("meta"), use_fused=True)
    head = ROIBoxHead(in_channels=64, representation_size=256)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.05))
    fused, _ = head(roi, supp, use_fused=True)
    ref, _ = head(roi, supp)
    torch.testing.assert_close(fused, ref, atol=ATOL, rtol=0)
