"""The port's train CLI and what it stands on, on the CPU at the small
capacities of ``torch_port_common``:

  - ``make_data_loader(start_iter=k)`` equals the JAX package's, batch for
    batch, at NUM_WORKERS 0; more than one replica raises;
  - a run of 4 ``do_train`` steps equals 2 steps, a save, a fresh model
    loaded with ``resume=True`` and 2 more steps, bit for bit: each step's
    sampling draws come from ``step_generator(it)`` alone;
  - after a ``RESUME False`` load the next learning rate equals optax's
    schedule at the count the JAX package restores from its own checkpoint;
  - ``python -m oneshotdet_tpu_torch.tools.train_net`` on a synthetic PPM
    dataset writes ``model_{iter:07d}.pth``, ``model_final.pth`` and the tag,
    resumes from the tag, and ``tools.test_net --seq_test`` evaluates its
    files; ``remove_solver_states`` keeps the weights; ``test_net`` loads a
    DDP-prefixed and a partial ``.pth``.
"""

import json
import logging
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oneshotdet_tpu.data import build as jax_build_data
from oneshotdet_tpu.engine import create_train_state
from oneshotdet_tpu.solver import make_optimizer as jax_make_optimizer
from oneshotdet_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from oneshotdet_tpu_torch.data import build
from oneshotdet_tpu_torch.engine import do_train, step_generator
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer
from oneshotdet_tpu_torch.tools import remove_solver_states, test_net, train_net
from oneshotdet_tpu_torch.utils.checkpoint import Checkpointer
from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch
from test_torch_port_data import _assert_same_batches
from torch_port_common import (DATA_OPTS, FLAGSHIP, SMALL, data_cfgs, make_setup,  # noqa: F401
                               one_torch_thread, small_cfgs, write_dataset)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, QUERY, SUPP, MAX_GT = 2, (64, 64), (32, 32), 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("train_cli"), num_images=8, seed=1)


@pytest.fixture
def custom_env(dataset, monkeypatch):
    monkeypatch.setenv("ONESHOT_CUSTOM_IMG_DIR", dataset[0])
    monkeypatch.setenv("ONESHOT_CUSTOM_ANN_FILE", dataset[1])
    return dataset


@pytest.fixture
def own_logger():
    """The CLIs' logger with no handler, as in a new process; the handlers
    it had before are put back after."""
    logger = logging.getLogger("oneshotdet_tpu_torch")
    before = list(logger.handlers)
    logger.handlers.clear()
    yield logger
    for h in logger.handlers:
        h.close()
    logger.handlers[:] = before


@pytest.mark.parametrize("start_iter", [1, 3])
def test_make_data_loader_start_iter_equals_jax(custom_env, start_iter):
    jcfg, pcfg = data_cfgs("SOLVER.MAX_ITER", 5)
    jl, _ = jax_build_data.make_data_loader(jcfg, is_train=True, start_iter=start_iter)
    pl, _ = build.make_data_loader(pcfg, is_train=True, start_iter=start_iter, device="cpu")
    port = list(pl)
    assert len(port) == 5 - start_iter
    _assert_same_batches(port, list(jl))


def test_make_data_loader_one_replica_only(custom_env):
    _, pcfg = data_cfgs()
    build.make_data_loader(pcfg, is_train=True, is_distributed=True, num_replicas=1, rank=0,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="replicas"):
        build.make_data_loader(pcfg, is_train=True, is_distributed=True, num_replicas=2,
                               rank=1, device="cpu")


def _trainer(state_dict, pcfg):
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    model.train()
    opt = make_optimizer(pcfg, model)
    return model, opt, make_lr_scheduler(pcfg, opt)


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    """Steps 0-3 in one run (saving after steps 2 and 4), against a fresh
    model and optimizer loaded from the save after step 2, and steps 2-3:
    parameters, momentum and learning rates equal bit for bit."""
    state_dict = make_setup()["state_dict"]
    _, pcfg = small_cfgs("SOLVER.MAX_ITER", 4, "SOLVER.CHECKPOINT_PERIOD", 2,
                         "SOLVER.WARMUP_METHOD", "linear", "SOLVER.WARMUP_ITERS", 3)
    batches = [make_episodic_batch(B, QUERY, SUPP, max_gt=MAX_GT, seed=20 + i) for i in range(4)]
    model, opt, sched = _trainer(state_dict, pcfg)
    ckptr = Checkpointer(str(tmp_path))
    assert do_train(pcfg, model, opt, sched, batches, log_period=4, checkpointer=ckptr) == 4
    assert ckptr.get_checkpoint_file() == str(tmp_path / "model_final.pth")
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "model_0000002.pth",
                                            "model_0000004.pth", "model_final.pth"]
    with open(ckptr.tag_file(), "w") as f:      # resume from step 2
        f.write(str(tmp_path / "model_0000002.pth"))
    resumed, ropt, rsched = _trainer(state_dict, pcfg)
    start = Checkpointer(str(tmp_path)).load(resumed, ropt, rsched, resume=True)
    assert start == 2 and rsched.last_epoch == 2
    assert do_train(pcfg, resumed, ropt, rsched, batches[2:], start_iter=start,
                    log_period=4) == 4
    moved = 0
    for (name, p), (_, r) in zip(model.named_parameters(), resumed.named_parameters()):
        assert torch.equal(p, r), name
        if p.requires_grad:
            assert torch.equal(opt.state[p]["momentum_buffer"], ropt.state[r]["momentum_buffer"])
            moved += not torch.equal(p, state_dict[name])
    assert moved > 150
    assert [g["lr"] for g in opt.param_groups] == [g["lr"] for g in ropt.param_groups]


def test_step_draws_depend_only_on_the_iteration():
    a = torch.rand(5, generator=step_generator(7, "cpu"))
    torch.rand(100, generator=step_generator(3, "cpu"))
    assert torch.equal(a, torch.rand(5, generator=step_generator(7, "cpu")))
    assert not torch.equal(a, torch.rand(5, generator=step_generator(8, "cpu")))


def _jax_counts(opt_state):
    return [int(s.count) for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)]


def test_lr_after_a_no_resume_load_equals_optax_at_the_restored_count(tmp_path):
    """JAX restores its optimizer state (and the schedule's count in it)
    whatever RESUME says, and keeps the step only under RESUME; so does the
    port with its optimizer and scheduler. rtol 1e-6: JAX computes the
    schedule in float32."""
    overrides = ("SOLVER.WARMUP_METHOD", "linear", "SOLVER.WARMUP_ITERS", 10)
    jcfg, pcfg = small_cfgs(*overrides)
    params = {"conv": {"kernel": jnp.ones((1, 1, 2, 3)), "bias": jnp.ones((3,))}}
    tx, schedule = jax_make_optimizer(jcfg, params)
    state = create_train_state(None, tx, {"params": params, "constants": {}})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    for _ in range(3):
        _, opt_state = tx.update(zeros, state.opt_state, state.params)
        state = state.replace(step=state.step + 1, opt_state=opt_state)
    jc = JaxCheckpointer(str(tmp_path / "jax"))
    jc.save("model_0000003", state)
    fresh = create_train_state(None, tx, {"params": params, "constants": {}})
    loaded = jc.load(fresh, resume=False)
    counts = _jax_counts(loaded.opt_state)
    assert int(loaded.step) == 0 and counts and set(counts) == {3}

    model = torch.nn.Conv2d(2, 3, 1)
    opt = make_optimizer(pcfg, model)
    sched = make_lr_scheduler(pcfg, opt)
    for _ in range(3):
        opt.step()
        sched.step()
    Checkpointer(str(tmp_path / "port")).save("model_0000003", model, opt, sched, 3)
    model2 = torch.nn.Conv2d(2, 3, 1)
    opt2 = make_optimizer(pcfg, model2)
    sched2 = make_lr_scheduler(pcfg, opt2)
    assert Checkpointer(str(tmp_path / "port")).load(model2, opt2, sched2, resume=False) == 0
    want = float(schedule(counts[0]))
    np.testing.assert_allclose(opt2.param_groups[0]["lr"], want, rtol=1e-6)
    np.testing.assert_allclose(opt2.param_groups[1]["lr"], want * pcfg.SOLVER.BIAS_LR_FACTOR,
                               rtol=1e-6)
    assert want != pcfg.SOLVER.BASE_LR * pcfg.SOLVER.WARMUP_FACTOR


# -- the CLIs ---------------------------------------------------------------------------

def _opts(out_dir, *extra):
    return [str(v) for v in SMALL + DATA_OPTS + ["OUTPUT_DIR", str(out_dir)] + list(extra)]


def _run(dataset, module, args):
    env = dict(os.environ, PYTHONPATH=REPO, ONESHOT_CUSTOM_IMG_DIR=dataset[0],
               ONESHOT_CUSTOM_ANN_FILE=dataset[1], OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.run([sys.executable, "-m", f"oneshotdet_tpu_torch.tools.{module}",
                           "--config-file", FLAGSHIP, "--device", "cpu", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    return out


def test_train_net_saves_resumes_and_test_net_evaluates(dataset, custom_env, own_logger,
                                                        tmp_path):
    out = tmp_path / "train"
    log = _run(dataset, "train_net",
               _opts(out, "SOLVER.MAX_ITER", 2, "SOLVER.CHECKPOINT_PERIOD", 1))
    assert sorted(os.listdir(out)) == ["last_checkpoint", "log.txt", "model_0000001.pth",
                                       "model_0000002.pth", "model_final.pth"]
    assert "No checkpoint found" in log and "start_iter: 0" in log
    assert re.findall(r"iter (\d)/2 loss (\S+)", log)[-1][0] == "2"
    final = torch.load(out / "model_final.pth", weights_only=True)
    assert final["iteration"] == 2 and {"model", "optimizer", "scheduler"} <= set(final)
    assert final["scheduler"]["last_epoch"] == 2

    # resume in-process: the tag (model_final) wins, the iteration is kept
    argv = ["--config-file", FLAGSHIP, "--device", "cpu"] + _opts(
        out, "SOLVER.MAX_ITER", 3, "SOLVER.CHECKPOINT_PERIOD", 1, "FEW_SHOT.RESUME", True)
    assert train_net.main(argv) == 0
    text = (out / "log.txt").read_text()
    assert f"Loading checkpoint from {out / 'model_final.pth'}" in text
    assert "start_iter: 2" in text and "iter 3/3" in text
    assert (out / "last_checkpoint").read_text() == str(out / "model_final.pth")
    third = torch.load(out / "model_0000003.pth", weights_only=True)
    assert third["iteration"] == 3 and third["scheduler"]["last_epoch"] == 3

    # a weights-only copy loads
    slim = tmp_path / "slim" / "model_0000003.pth"
    slim.parent.mkdir()
    assert remove_solver_states.main(["--in", str(out / "model_0000003.pth"),
                                      "--out", str(slim)]) == 0
    data = torch.load(slim, weights_only=True)
    assert set(data) == {"model", "iteration"}
    _, pcfg = data_cfgs()
    model = build_detection_model(pcfg, device="cpu")
    assert Checkpointer(str(tmp_path / "o")).load(model, f=str(slim), resume=False) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, third["model"][k]), k

    ev = tmp_path / "eval"
    log = _run(dataset, "test_net", ["--seq_test"] + _opts(
        ev, "FEW_SHOT.STOP_ITER", 1, "TEST.LOAD_DIR", out, "TEST.MIN_ITER", 2))
    loaded = re.findall(r"Loading checkpoint from (\S+)", log)
    assert [os.path.basename(p) for p in loaded] == ["model_0000002.pth", "model_0000003.pth"]
    assert sorted(p.name for p in ev.iterdir() if p.name.startswith("eval")) == \
        ["eval_0000002", "eval_0000003"]
    for d in ("eval_0000002", "eval_0000003"):
        assert json.loads((ev / d / "coco_results.json").read_text())


def test_test_net_loads_prefixed_and_partial_pth(custom_env, own_logger, tmp_path):
    """A reference file saved under DDP (``module.`` keys,
    ``num_batches_tracked``) evaluates as its plain copy; a partial file
    (no relation head) loads over the seeded weights."""
    sd = make_setup()["state_dict"]
    files = {"plain": {"model": sd},
             "ddp": {"model": {**{"module." + k: v for k, v in sd.items()},
                               "module.backbone.body.stem.bn1.num_batches_tracked":
                                   torch.tensor(3)}},
             "partial": {"model": {k: v for k, v in sd.items() if not k.startswith("roi_heads.")}}}
    results = {}
    for name, data in files.items():
        path = tmp_path / f"{name}.pth"
        torch.save(data, path)
        out = tmp_path / name
        argv = ["--config-file", FLAGSHIP, "--device", "cpu", "--ckpt", str(path)] + _opts(
            out, "FEW_SHOT.STOP_ITER", 1)
        assert test_net.main(argv) == 0
        for h in own_logger.handlers:
            h.close()
        own_logger.handlers.clear()
        results[name] = (out / "eval" / "coco_custom_result.json").read_text()
        matched = re.findall(r"checkpoint: (\d+) matched, (\d+) unmatched",
                             (out / "test_log.txt").read_text())
        n = len(data["model"])
        assert matched == [(str(n - (name == "ddp")), str(int(name == "ddp")))]
    assert results["ddp"] == results["plain"]


def test_tensorboard_logger_counts_from_start_iter(monkeypatch):
    from oneshotdet_tpu_torch.utils import TensorboardLogger

    scalars = []

    class Writer:
        def add_scalar(self, name, value, step):
            scalars.append((name, value, step))

    monkeypatch.setattr(TensorboardLogger, "_get_writer", staticmethod(lambda log_dir: Writer()))
    meters = TensorboardLogger("unused", start_iter=5)
    meters.update(loss=torch.tensor(2.0))
    meters.update(loss=1.0)
    assert scalars == [("loss", 2.0, 5), ("loss", 1.0, 6)]
    assert meters.loss.count == 2 and meters.iteration == 7


def test_train_net_builds_on_cuda_without_device(monkeypatch, own_logger, tmp_path):
    """No fallback: without --device the model is built for "cuda"."""
    from oneshotdet_tpu_torch import models

    devices = []

    def build(cfg, device=None, generator=None):
        devices.append(torch.device(device))
        raise RuntimeError("stop here")

    monkeypatch.setattr(models, "build_detection_model", build)
    with pytest.raises(RuntimeError, match="stop here"):
        train_net.main(["--config-file", FLAGSHIP, "OUTPUT_DIR", str(tmp_path)])
    assert devices == [torch.device("cuda")]
