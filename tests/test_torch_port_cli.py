"""The port's evaluation CLI (``python -m oneshotdet_tpu_torch.tools.test_net``)
on the CPU, at the small capacities of ``torch_port_common`` on a synthetic
PPM dataset, with a ``.pth`` of seeded flax weights converted by
``state_dict_from_flax``.

The CLI's COCO metrics equal the port's own ``inference`` on the same loader
and weights (that ``inference`` is held to JAX's by
``test_torch_port_engine.py``, the loader to JAX's by
``test_torch_port_data.py``). ``--seq_test`` evaluates exactly the
``model_*`` files inside ``[TEST.MIN_ITER, TEST.MAX_ITER]``, each loaded by
its own path into its own ``eval_{iter}`` folder.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from oneshotdet_tpu_torch.data import make_data_loader
from oneshotdet_tpu_torch.engine import inference
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.tools import test_net
from torch_port_common import (DATA_OPTS, FLAGSHIP, SMALL, data_cfgs, make_setup,  # noqa: F401
                               one_torch_thread, write_dataset)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    img_dir, ann_file = write_dataset(root, num_images=8, seed=1)
    state_dict = make_setup()["state_dict"]
    ckpt = root / "weights.pth"
    torch.save({"model": state_dict}, ckpt)
    return dict(root=root, img_dir=img_dir, ann_file=ann_file, ckpt=str(ckpt),
                state_dict=state_dict)


def _opts(out_dir, *extra):
    return [str(v) for v in SMALL + DATA_OPTS + ["OUTPUT_DIR", str(out_dir)] + list(extra)]


def _run_cli(setup, args, opts):
    env = dict(os.environ, PYTHONPATH=REPO, ONESHOT_CUSTOM_IMG_DIR=setup["img_dir"],
               ONESHOT_CUSTOM_ANN_FILE=setup["ann_file"],
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.run(
        [sys.executable, "-m", "oneshotdet_tpu_torch.tools.test_net", "--config-file", FLAGSHIP,
         "--device", "cpu", *args, *opts],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    return out


def test_cli_metrics_equal_inference(cli_setup, monkeypatch, tmp_path):
    out_dir = tmp_path / "cli"
    log = _run_cli(cli_setup, ["--ckpt", cli_setup["ckpt"]],
                   _opts(out_dir, "FEW_SHOT.STOP_ITER", 3))
    assert re.findall(r"Loading checkpoint from (\S+)", log) == [cli_setup["ckpt"]]
    got = json.loads((out_dir / "eval" / "coco_results.json").read_text())
    dets = json.loads((out_dir / "eval" / "coco_custom_result.json").read_text())
    assert dets and got["AP50"] >= 0.0

    monkeypatch.setenv("ONESHOT_CUSTOM_IMG_DIR", cli_setup["img_dir"])
    monkeypatch.setenv("ONESHOT_CUSTOM_ANN_FILE", cli_setup["ann_file"])
    _, pcfg = data_cfgs("FEW_SHOT.STOP_ITER", 3)
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(cli_setup["state_dict"], strict=True)
    loader, dataset = make_data_loader(pcfg, is_train=False, device="cpu")
    want = inference(pcfg, model, loader, dataset, str(tmp_path / "direct"), stop_iter=3)
    assert got == want
    assert (tmp_path / "direct" / "coco_custom_result.json").read_text() == \
        (out_dir / "eval" / "coco_custom_result.json").read_text()


def test_cli_seq_test_loads_each_checkpoint_in_range(cli_setup, tmp_path):
    load_dir = tmp_path / "ckpts"
    load_dir.mkdir()
    for name in ("model_0000001.pth", "model_0000002.pth", "model_0000003.pth",
                 "model_final.pth"):
        shutil.copy(cli_setup["ckpt"], load_dir / name)
    out_dir = tmp_path / "eval_out"
    log = _run_cli(cli_setup, ["--seq_test"],
                   _opts(out_dir, "FEW_SHOT.STOP_ITER", 1, "TEST.LOAD_DIR", load_dir,
                         "TEST.MIN_ITER", 2, "TEST.MAX_ITER", 3))
    for it in (2, 3):
        d = out_dir / f"eval_{it:07d}"
        assert (d / "coco_results.json").exists() and (d / "coco_custom_result.json").exists()
    assert sorted(p.name for p in out_dir.iterdir() if p.name.startswith("eval")) == \
        ["eval_0000002", "eval_0000003"]
    seq = re.findall(r"=== seq_test checkpoint (\S+) ===", log)
    loaded = re.findall(r"Loading checkpoint from (\S+)", log)
    assert [os.path.basename(p) for p in seq] == ["model_0000002.pth", "model_0000003.pth"]
    assert loaded == seq
    results = [json.loads((out_dir / f"eval_{it:07d}" / "coco_results.json").read_text())
               for it in (2, 3)]
    assert results[0] == results[1]         # two copies of one file


def test_cli_without_weights_uses_seeded_initial_weights(cli_setup, monkeypatch, tmp_path):
    monkeypatch.setenv("ONESHOT_CUSTOM_IMG_DIR", cli_setup["img_dir"])
    monkeypatch.setenv("ONESHOT_CUSTOM_ANN_FILE", cli_setup["ann_file"])
    out_dir = tmp_path / "seeded"
    argv = ["--config-file", FLAGSHIP, "--device", "cpu"] + _opts(out_dir, "FEW_SHOT.STOP_ITER", 1)
    assert test_net.main(argv) == 0
    assert (out_dir / "eval" / "coco_results.json").exists()
    assert "Loading checkpoint" not in (out_dir / "test_log.txt").read_text()
    with pytest.raises(NotImplementedError, match="catalog"):
        test_net.main(argv + ["MODEL.WEIGHT", "catalog://ImageNetPretrained/MSRA/R-50"])
