"""The port's checkpoints (``oneshotdet_tpu_torch/utils/checkpoint.py``)
against the JAX package's ``Checkpointer`` on the CPU, at the flagship's
full widths with the seeded weights of ``torch_port_common``:

  - reference-layout ``.pth`` files, with DDP's ``module.`` prefix and
    ``num_batches_tracked``, and partial ones (the FSS stage-1 file), overlay
    onto the current weights to exactly the values JAX's ``Checkpointer.load``
    gives, compared through ``state_dict_from_flax``;
  - UNLOAD keywords keep the same parameters fresh as JAX's flax-path
    keywords (``rpn.head`` is JAX's ``fcos_head``, ``roi_heads`` its
    ``roi_head``): on a reference-layout file buffers always load, on each
    package's own saves (JAX's orbax tree, the port's ``.pth`` with its
    optimizer) buffers stay fresh too;
  - RESUME restores the iteration from each package's own saves only: a
    reference-layout file starts both at 0;
  - the FSS dual load (FSS_WEIGHT, then WEIGHT with ``rpn.head`` unloaded)
    equals JAX's;
  - the port's own saves read in JAX's ``load_torch_checkpoint`` with no
    unmatched key;
  - the ``last_checkpoint`` tag, ``prefer_tag``, ``resume`` and the
    optimizer and scheduler state (on a small module: the rules do not
    depend on the model).
"""

import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from oneshotdet_tpu.engine import create_train_state
from oneshotdet_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from oneshotdet_tpu.utils.torch_import import load_torch_checkpoint
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer
from oneshotdet_tpu_torch.utils.checkpoint import Checkpointer, merge_with_unload
from torch_port_common import make_setup, small_cfgs, state_dict_from_flax

# (port keyword, JAX keyword): the port matches state-dict names, JAX flax paths
UNLOAD = [("linz", "linz"), ("rpn.head", "fcos_head"), ("roi_heads", "roi_head")]


def _scaled(tree, scale, shift):
    if hasattr(tree, "items"):
        return {k: _scaled(v, scale, shift) for k, v in tree.items()}
    return (np.asarray(tree) * np.float32(scale) + np.float32(shift)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """Three weight sets in both layouts: A (fresh), B and C (files)."""
    a = make_setup()["variables"]
    sets = {"A": a, "B": _scaled(a, 1.5, 0.01), "C": _scaled(a, 0.5, -0.02)}
    _, pcfg = small_cfgs()
    return dict(flax=sets, sd={k: state_dict_from_flax(v) for k, v in sets.items()}, pcfg=pcfg)


def _port_model(weights, name="A"):
    model = build_detection_model(weights["pcfg"], device="cpu")
    model.load_state_dict(weights["sd"][name], strict=True)
    return model


def _jax_state(weights, name="A"):
    v = weights["flax"][name]
    return create_train_state(None, optax.sgd(0.1), {"params": v["params"],
                                                     "constants": v["constants"]})


def _jax_sd(state):
    return state_dict_from_flax({"params": jax.device_get(state.params),
                                 "constants": jax.device_get(state.constants)})


def _assert_equal_sd(model, want):
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _write(path, sd, prefix="", extra=True, keep=lambda k: True):
    state = {prefix + k: v for k, v in sd.items() if keep(k)}
    if extra:       # what a reference file saved under DDP also holds
        state[prefix + "backbone.body.stem.bn1.num_batches_tracked"] = torch.tensor(7)
        state[prefix + "roi_heads.box.no_such_layer.weight"] = torch.ones(3)
    torch.save({"model": state, "iteration": 11}, path)
    return str(path)


@pytest.mark.parametrize("kind", ["module-prefixed", "partial", "partial-module-prefixed"])
def test_pth_overlay_equals_jax(weights, tmp_path, kind):
    """The FSS stage-1 file holds the backbones and the FCOS head only."""
    keep = (lambda k: not k.startswith("roi_heads.")) if "partial" in kind else (lambda k: True)
    prefix = "module." if "module" in kind else ""
    path = _write(tmp_path / "ref.pth", weights["sd"]["B"], prefix, keep=keep)
    model = _port_model(weights)
    start = Checkpointer(str(tmp_path / "port")).load(model, f=path, resume=True)
    ref = JaxCheckpointer(str(tmp_path / "jax")).load(_jax_state(weights), f=path, resume=True)
    assert start == int(ref.step) == 0      # a reference file's iteration is not restored
    want = _jax_sd(ref)
    _assert_equal_sd(model, want)
    for k, v in want.items():
        src = weights["sd"]["B" if keep(k) else "A"][k]
        assert torch.equal(v, src), k


@pytest.mark.parametrize("port_kw,jax_kw", UNLOAD, ids=[u[0] for u in UNLOAD])
def test_unload_keyword_keeps_the_same_parameters_fresh_as_jax(weights, tmp_path, port_kw,
                                                               jax_kw):
    path = _write(tmp_path / "ref.pth", weights["sd"]["B"], extra=False)
    model = _port_model(weights)
    Checkpointer(str(tmp_path / "port")).load(model, f=path, unload_keywords=(port_kw,),
                                              resume=False)
    ref = JaxCheckpointer(str(tmp_path / "jax")).load(_jax_state(weights), f=path,
                                                      unload_keywords=(jax_kw,), resume=False)
    want = _jax_sd(ref)
    _assert_equal_sd(model, want)
    params = {n for n, _ in model.named_parameters()}
    fresh = {k for k in want if torch.equal(want[k], weights["sd"]["A"][k])}
    assert fresh == {k for k in params if port_kw in k}
    if port_kw != "linz":
        assert fresh


@pytest.mark.parametrize("port_kw", [u[0] for u in UNLOAD])
def test_merge_with_unload_on_names(port_kw):
    loaded = {"rpn.head.cls_logits.bias": 1, "roi_heads.box.fc6.weight": 2,
              "backbone.body.linz.weight": 3, "supp_backbone.fpn.fpn_inner3.weight": 4}
    fresh = {k: -v for k, v in loaded.items()}
    merged = merge_with_unload(loaded, fresh, (port_kw, ""))
    assert merged == {k: (fresh[k] if port_kw in k else v) for k, v in loaded.items()}


def test_fss_dual_load_equals_jax(weights, tmp_path):
    """FSS_WEIGHT (B, stage 1 only), then WEIGHT (C, whole) with the FCOS
    head kept as the first load left it."""
    fss = _write(tmp_path / "fss.pth", weights["sd"]["B"], "module.",
                 keep=lambda k: not k.startswith("roi_heads."))
    full = _write(tmp_path / "full.pth", weights["sd"]["C"], extra=False)
    model = _port_model(weights)
    port = Checkpointer(str(tmp_path / "port"))
    port.load(model, f=fss, resume=False)
    assert port.load(model, f=full, unload_keywords=("linz", "rpn.head"), resume=True) == 0
    jc = JaxCheckpointer(str(tmp_path / "jax"))
    state = jc.load(_jax_state(weights), f=fss, resume=False)
    state = jc.load(state, f=full, unload_keywords=("linz", "fcos_head"), resume=True)
    assert int(state.step) == 0
    want = _jax_sd(state)
    _assert_equal_sd(model, want)
    params = {n for n, _ in model.named_parameters()}
    for k, v in want.items():
        src = "B" if (k.startswith("rpn.head.") and k in params) else "C"
        assert torch.equal(v, weights["sd"][src][k]), k


def test_port_save_reads_in_jax(weights, tmp_path):
    model = _port_model(weights, "B")
    opt = make_optimizer(weights["pcfg"], model)
    sched = make_lr_scheduler(weights["pcfg"], opt)
    ckptr = Checkpointer(str(tmp_path))
    path = ckptr.save("model_0000004", model, opt, sched, 4)
    assert path == str(tmp_path / "model_0000004.pth")
    assert ckptr.get_checkpoint_file() == path
    converted, matched, unmatched = load_torch_checkpoint(path)
    assert unmatched == [] and len(matched) == len(model.state_dict())
    _assert_equal_sd(model, state_dict_from_flax(converted))
    ref = JaxCheckpointer(str(tmp_path / "jax")).load(_jax_state(weights), f=path, resume=False)
    _assert_equal_sd(model, _jax_sd(ref))


@pytest.mark.parametrize("port_kw,jax_kw", [("backbone", "backbone")] + UNLOAD[1:],
                         ids=["backbone"] + [u[0] for u in UNLOAD[1:]])
def test_unload_on_own_saves_keeps_buffers_fresh_as_jax(weights, tmp_path, port_kw, jax_kw):
    """Each package saves B at iteration 3 with its own ``Checkpointer.save``
    (the JAX package's orbax tree, the port's ``.pth`` with its optimizer)
    and loads it into A with an UNLOAD keyword under resume: parameters and
    FrozenBN buffers that hold the keyword stay A's in both, and both start
    at 3."""
    pcfg = weights["pcfg"]
    src = _port_model(weights, "B")
    opt = make_optimizer(pcfg, src)
    path = Checkpointer(str(tmp_path / "port")).save("model_0000003", src, opt,
                                                     make_lr_scheduler(pcfg, opt), 3)
    model = _port_model(weights)
    mopt = make_optimizer(pcfg, model)
    start = Checkpointer(str(tmp_path / "other")).load(
        model, mopt, make_lr_scheduler(pcfg, mopt), f=path, unload_keywords=(port_kw,),
        resume=True)
    jc = JaxCheckpointer(str(tmp_path / "jax"))
    jpath = jc.save("model_0000003", _jax_state(weights, "B").replace(step=jax.numpy.asarray(3)))
    ref = JaxCheckpointer(str(tmp_path / "jax_load")).load(
        _jax_state(weights), f=jpath, unload_keywords=(jax_kw,), resume=True)
    shutil.rmtree(tmp_path)           # two full-width saves
    assert start == int(ref.step) == 3
    want = _jax_sd(ref)
    _assert_equal_sd(model, want)
    fresh = {k for k in want if torch.equal(want[k], weights["sd"]["A"][k])}
    assert fresh == {k for k in want if port_kw in k}
    if port_kw == "backbone":
        assert any(k.endswith("running_var") for k in fresh)


@pytest.mark.parametrize("with_solver", [True, False], ids=["optimizer", "weights-only"])
def test_resume_from_a_reference_file_starts_at_zero_as_jax(weights, tmp_path, with_solver):
    """A reference-layout ``{"model", "iteration": 11}`` under RESUME: the
    JAX package keeps its fresh step, and the port restores no iteration
    where it restores no optimizer state."""
    path = _write(tmp_path / "ref.pth", weights["sd"]["B"], extra=False)
    model = _port_model(weights)
    solver = {}
    if with_solver:
        opt = make_optimizer(weights["pcfg"], model)
        solver = dict(optimizer=opt, scheduler=make_lr_scheduler(weights["pcfg"], opt))
    start = Checkpointer(str(tmp_path / "port")).load(model, f=path, resume=True, **solver)
    ref = JaxCheckpointer(str(tmp_path / "jax")).load(_jax_state(weights), f=path, resume=True)
    os.remove(path)
    assert start == int(ref.step) == 0
    _assert_equal_sd(model, _jax_sd(ref))


# -- the tag, resume and the solver state, on a small module ---------------------------

class Tiny(torch.nn.Module):
    def __init__(self, value):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 3, 1)
        self.register_buffer("running_mean", torch.full((3,), float(value)))
        with torch.no_grad():
            self.conv.weight.fill_(value)
            self.conv.bias.fill_(value)


def _tiny(value, cfg):
    model = Tiny(value)
    opt = make_optimizer(cfg, model)
    return model, opt, make_lr_scheduler(cfg, opt)


def _steps(model, opt, sched, n):
    for _ in range(n):
        model.conv.weight.grad = torch.ones_like(model.conv.weight)
        model.conv.bias.grad = torch.ones_like(model.conv.bias)
        opt.step()
        sched.step()


def test_tag_wins_unless_prefer_tag_false(tmp_path):
    _, cfg = small_cfgs()
    ckptr = Checkpointer(str(tmp_path))
    assert not ckptr.has_checkpoint() and ckptr.get_checkpoint_file() == ""
    m1 = ckptr.save("model_1", Tiny(1.0))
    ckptr.save("model_2", Tiny(2.0))
    assert ckptr.has_checkpoint() and ckptr.get_checkpoint_file() == str(tmp_path / "model_2.pth")
    model = Tiny(0.0)
    ckptr.load(model, f=m1)
    assert float(model.conv.weight.detach().flatten()[0]) == 2.0
    ckptr.load(model, f=m1, prefer_tag=False)
    assert float(model.conv.weight.detach().flatten()[0]) == 1.0 and float(model.running_mean[0]) == 1.0
    empty = Checkpointer(str(tmp_path / "empty"))
    assert empty.load(model) == 0 and float(model.conv.weight.detach().flatten()[0]) == 1.0


@pytest.mark.parametrize("resume", [True, False])
def test_resume_keeps_the_iteration_and_the_solver_state_loads_either_way(tmp_path, resume):
    """As the JAX package: the step only under resume, the optimizer state
    (SGD momentum, the schedule's count) always."""
    _, cfg = small_cfgs("SOLVER.WARMUP_METHOD", "linear")
    model, opt, sched = _tiny(1.0, cfg)
    _steps(model, opt, sched, 3)
    Checkpointer(str(tmp_path)).save("model_0000003", model, opt, sched, 3)
    fresh, fopt, fsched = _tiny(0.0, cfg)
    start = Checkpointer(str(tmp_path)).load(fresh, fopt, fsched, resume=resume)
    assert start == (3 if resume else 0)
    assert fsched.last_epoch == 3
    for a, b in zip(fopt.param_groups, opt.param_groups):
        assert a["lr"] == b["lr"]
    for p, q in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(fopt.state[p]["momentum_buffer"], opt.state[q]["momentum_buffer"])
    _steps(model, opt, sched, 1)
    _steps(fresh, fopt, fsched, 1)
    for p, q in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(p, q)


def test_solver_state_of_another_layout_is_left_out(tmp_path):
    """An optimizer of another group layout (the reference's has one group
    per parameter) is not the port's: the weights load, the solver state
    stays."""
    _, cfg = small_cfgs()
    model, opt, sched = _tiny(1.0, cfg)
    other = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    torch.save({"model": model.state_dict(), "optimizer": other.state_dict(), "iteration": 9},
               tmp_path / "ref.pth")
    fresh, fopt, fsched = _tiny(0.0, cfg)
    want = fopt.state_dict()
    assert Checkpointer(str(tmp_path / "o")).load(fresh, fopt, fsched,
                                                  f=str(tmp_path / "ref.pth")) == 0
    assert float(fresh.conv.weight.detach().flatten()[0]) == 1.0
    assert fopt.state_dict() == want and fsched.last_epoch == 0
