"""The port's serving CLIs in subprocesses on the CPU (``--device cpu``), at
the predictor tests' capacities with seeded weights in a ``.pth``:

  - ``tools.export_model --kind cached_support`` writes the pair that
    ``export_eval`` traces, and the pair equals the eager model with the
    file's weights bit for bit (``--ckpt`` loaded with ``prefer_tag=False``
    past a ``last_checkpoint`` tag that points elsewhere);
  - ``tools.export_model --serving --no-compile`` writes a bundle, and
    ``tools.oneshot_demo --artifact`` over it draws the same frames, pixel
    for pixel, as the demo on the model built from the cfg and the ``.pth``;
  - the demo refuses ``--spatial-devices`` above 1.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from oneshotdet_tpu_torch import export as oexport
from oneshotdet_tpu_torch.data.image_io import read_image_rgb
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.structures import ImageBatch
from oneshotdet_tpu_torch.tools import oneshot_demo
from test_torch_port_predictor import PRED_OVERRIDES
from torch_port_common import FLAGSHIP, SMALL, small_cfgs

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPTS = [str(v) for v in SMALL + list(PRED_OVERRIDES)]


def _cli(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", f"oneshotdet_tpu_torch.tools.{module}", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _ppm(path, rgb):
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(rgb).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A ``.pth`` of seeded weights (seed 3) in a folder whose
    ``last_checkpoint`` tag points at another file, and the model."""
    root = tmp_path_factory.mktemp("weights")
    _, pcfg = small_cfgs(*PRED_OVERRIDES)
    model = build_detection_model(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    path = root / "seed3.pth"
    torch.save({"model": model.state_dict()}, path)
    (root / "last_checkpoint").write_text(str(root / "missing.pth"))
    yield dict(path=str(path), model=model, cfg=pcfg)
    path.unlink()


def test_export_model_cli_writes_the_cached_support_pair(weights, tmp_path):
    out = str(tmp_path / "m")
    _cli("export_model", "--config-file", FLAGSHIP, "--ckpt", weights["path"], "--out", out,
         "--kind", "cached_support", "--batch", "1", "--device", "cpu", *OPTS)
    assert sorted(os.listdir(tmp_path)) == ["m.serve.detect", "m.serve.support"]
    support = oexport.load(out + ".serve.support").module()
    detect = oexport.load(out + ".serve.detect").module()
    for f in tmp_path.iterdir():      # 0.1-0.2 GB each: full-width weights
        f.unlink()
    c = weights["cfg"]
    g = torch.Generator().manual_seed(4)
    images = ImageBatch(torch.randn(1, *c.TPU.QUERY_BUCKETS[0], 3, generator=g) * 50,
                        torch.tensor([[90.0, 120.0]]))
    supps = ImageBatch(torch.randn(1, *c.TPU.SUPP_BUCKET, 3, generator=g) * 50,
                       torch.tensor([[48.0, 40.0]]))
    tids = torch.ones((1,), dtype=torch.int32)
    ref = weights["model"](images, supps, tids)
    with torch.inference_mode():
        pooled, supp_7x7 = support(supps.pixels, supps.sizes)
        got = detect(images.pixels, images.sizes, pooled, supp_7x7, tids)
    assert int(ref.valid.sum()) > 0
    for g_, w_ in zip(got, (ref.xyxy, ref.get_field("scores"), ref.valid)):
        assert torch.equal(g_, w_)


def test_export_model_cli_bundle_serves_the_demo_as_the_model_does(weights, tmp_path):
    bundle = str(tmp_path / "bundle")
    _cli("export_model", "--config-file", FLAGSHIP, "--ckpt", weights["path"], "--out", bundle,
         "--serving", "--no-compile", "--device", "cpu", *OPTS)
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("bundle")) == [
        "bundle.detect", "bundle.meta.json", "bundle.support"]
    rng = np.random.RandomState(5)
    frames = tmp_path / "frames"
    frames.mkdir()
    support = _ppm(tmp_path / "support.ppm", rng.randint(0, 255, (40, 52, 3), np.uint8))
    for i, hw in enumerate(((100, 150), (120, 90))):
        _ppm(frames / f"frame{i}.ppm", rng.randint(0, 255, hw + (3,), np.uint8))
    common = ["--support", support, "--images", str(frames), "--threshold", "0.0",
              "--device", "cpu"]
    _cli("oneshot_demo", "--artifact", bundle, "--out", str(tmp_path / "served"), *common)
    _cli("oneshot_demo", "--config-file", FLAGSHIP, "--ckpt", weights["path"],
         "--out", str(tmp_path / "model"), *common, *OPTS)
    for ext in (".support", ".detect"):     # 0.1-0.2 GB each
        os.remove(bundle + ext)
    names = sorted(os.listdir(frames))
    assert sorted(os.listdir(tmp_path / "served")) == sorted(os.listdir(tmp_path / "model")) == names
    for name in names:
        served = read_image_rgb(tmp_path / "served" / name)
        model = read_image_rgb(tmp_path / "model" / name)
        assert np.array_equal(served, model)
        assert not np.array_equal(served, read_image_rgb(frames / name))


def test_demo_refuses_spatial_devices():
    with pytest.raises(NotImplementedError, match="one card"):
        oneshot_demo.main(["--support", "s.ppm", "--images", "d", "--spatial-devices", "2"])
