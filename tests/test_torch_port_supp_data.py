"""The support-side data switches against the JAX package's data path on
the CPU: the colour jitter (PIL's ``ImageEnhance`` chain in JAX, numpy in
the port) byte for byte on the same factors, and episodes and batches with
FEW_SHOT.SUPP_AUG (the flip, and the jitter at NUM_SUPP_AUG 2; in the
random, selected and close pickers) and FEW_SHOT.MASK_SUPP (the support
image times its polygon mask before the crop; RLE or missing
segmentations left unmasked) against ``COCODataset.__getitem__`` and
``make_data_loader`` at ``DATALOADER.NUM_WORKERS=0``.

The JAX dataset draws the jitter's factors from the global ``np.random``;
the port draws them from the dataset's own stream, right after the support
pick (``COCODataset.plan``). The comparisons patch ``np.random.uniform``
to draw from the global ``random`` stream the JAX dataset copies from
its shuffle, at the same point of an episode, so both take the same factors
and every later draw (the transforms') stays in step. Pixels of batches
compare as in ``tests/test_torch_port_data.py`` (the JAX package's C++
resize rounds its ties otherwise).
"""

import json
import pickle
import random
import re

import numpy as np
import pytest
import torch
from PIL import Image

from oneshotdet_tpu.data import build as jax_build
from oneshotdet_tpu.data import transforms as jax_transforms
from oneshotdet_tpu.data.datasets.coco import COCODataset as JaxCOCODataset
from oneshotdet_tpu_torch.data import build, image_io
from oneshotdet_tpu_torch.data.datasets.coco import COCODataset
from oneshotdet_tpu_torch.data.transforms import (build_fused_transforms, color_jitter,
                                                  draw_jitter)
from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco
from test_torch_port_data import _assert_same_batches, _assert_same_items, _items
from torch_port_common import DATA_IMAGE_SIZES, data_cfgs, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

AUG1 = ["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", 1]
AUG2 = ["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", 2]
MASK = ["FEW_SHOT.MASK_SUPP", True]
NEAR_TWO = float(np.nextafter(2.0, 0.0))


@pytest.fixture
def jax_draws_from_random(monkeypatch):
    """JAX's jitter factors drawn from the global ``random`` stream."""
    monkeypatch.setattr(np.random, "uniform", lambda lo, hi: random.uniform(lo, hi))


# -- the colour jitter -----------------------------------------------------------

JITTER_SIZES = [(1, 1), (1, 7), (9, 1), (2, 2), (2, 5), (3, 3), (4, 3), (17, 23), (61, 40)]
FACTORS = [(0.1, 0.1, 0.1, 0.1), (1.0, 1.0, 1.0, 1.0), (NEAR_TWO,) * 4,
           (0.1, NEAR_TWO, 1.0, 0.55), (NEAR_TWO, 0.1, NEAR_TWO, 1.0)]


@pytest.mark.parametrize("hw", JITTER_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_color_jitter_equals_pil(hw, monkeypatch):
    """The port's jitter on the factors JAX's ``color_jitter`` is handed
    (its ``np.random.uniform`` patched to return them), on noise, flat and
    banded images: the same bytes."""
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8),
              np.full(hw + (3,), 200, np.uint8),
              (rng.randint(0, 4, hw + (3,)) * 85).astype(np.uint8)]
    factors = FACTORS + [tuple(rng.uniform(0.1, 2.0, 4)) for _ in range(4)]
    for arr in images:
        for f in factors:
            it = iter(f)
            monkeypatch.setattr(np.random, "uniform", lambda lo, hi: next(it))
            want = np.asarray(jax_transforms.color_jitter(Image.fromarray(arr)))
            got = color_jitter(arr, f)
            assert got.dtype == np.uint8 and got.shape == arr.shape
            np.testing.assert_array_equal(got, want, err_msg=str(f))


def test_draw_jitter_order():
    a, b = random.Random(3), random.Random(3)
    assert draw_jitter(a) == tuple(b.uniform(0.1, 2) for _ in range(4))
    assert a.getstate() == b.getstate()


# -- episodes and batches ------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    """The loader tests' synthetic dataset with polygon segmentations; one
    annotation in five holds an uncompressed RLE instead and one in seven
    none, which MASK_SUPP leaves unmasked."""
    root = tmp_path_factory.mktemp("coco_seg")
    img_dir, ann_file = write_synthetic_coco(root, num_images=16, sizes=DATA_IMAGE_SIZES,
                                             num_categories=3, box_side=(12.0, 40.0), seed=0,
                                             segmentation=True)
    data = json.load(open(ann_file))
    for k, ann in enumerate(data["annotations"]):
        if k % 5 == 4:
            ann["segmentation"] = {"size": [4, 4], "counts": [5, 6, 5]}
        elif k % 7 == 6:
            del ann["segmentation"]
    json.dump(data, open(ann_file, "w"))
    return img_dir, ann_file


@pytest.fixture
def custom_env(dataset_files, monkeypatch):
    img_dir, ann_file = dataset_files
    monkeypatch.setenv("ONESHOT_CUSTOM_IMG_DIR", img_dir)
    monkeypatch.setenv("ONESHOT_CUSTOM_ANN_FILE", ann_file)
    return dataset_files


def _datasets(dataset_files, is_train, *overrides):
    img_dir, ann_file = dataset_files
    jcfg, pcfg = data_cfgs(*overrides)
    port = COCODataset(pcfg, ann_file, img_dir, is_train, build_fused_transforms(pcfg, is_train))
    jax = JaxCOCODataset(jcfg, ann_file, img_dir, is_train,
                         jax_transforms.build_fused_transforms(jcfg, is_train))
    return jax, port


CONFIGS = {
    "supp_aug 1, eval": (False, AUG1),
    "supp_aug 2, eval": (False, AUG2),
    "supp_aug 2, train": (True, AUG2),
    "mask_supp, eval": (False, MASK),
    "mask_supp, train": (True, MASK),
    "supp_aug 2 and mask_supp, train": (True, AUG2 + MASK),
    "supp_aug 1 and mask_supp, two shots, eval": (False, AUG1 + MASK + ["FEW_SHOT.NUM_SHOT", 2]),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_episodes_equal_jax(dataset_files, jax_draws_from_random, case):
    is_train, overrides = CONFIGS[case]
    jax, port = _datasets(dataset_files, is_train, *overrides)
    jax_items = _items(jax)
    port_items = _items(port)
    assert port.actual_num_imgs == jax.actual_num_imgs
    assert all(len(it["img_supp"]) == port.actual_num_imgs for it in port_items)
    _assert_same_items(port_items, jax_items)


def test_mask_and_augmentation_change_the_supports(dataset_files):
    """The masked supports differ from the unmasked ones (zeros outside the
    polygon) where the support's annotation has polygons; each support is
    followed by its flip and its jitter."""
    img_dir, ann_file = dataset_files
    datasets = {}
    for name, overrides in (("plain", []), ("mask", MASK), ("aug", AUG2)):
        pcfg = data_cfgs(*overrides)[1]
        datasets[name] = COCODataset(pcfg, ann_file, img_dir, False,
                                     build_fused_transforms(pcfg, False))
    masked = [not np.array_equal(a["img_supp"][0]["u8"], b["img_supp"][0]["u8"])
              for a, b in zip(_items(datasets["plain"]), _items(datasets["mask"]))]
    assert any(masked) and not all(masked)
    ds = datasets["aug"]
    for idx in range(len(ds)):
        ep = ds.plan(idx)
        s, flip, jit = (im["u8"] for im in ds.load(ep)["img_supp"])
        assert len(ep.jitters) == 1 and len(ep.supp_draws) == 3
        np.testing.assert_array_equal(flip, s[:, ::-1])
        np.testing.assert_array_equal(jit, color_jitter(s, ep.jitters[0]))


@pytest.mark.parametrize("picker", ["selected", "close"])
def test_pickers_with_supp_aug_equal_jax(dataset_files, jax_draws_from_random, tmp_path,
                                         monkeypatch, picker):
    """The selected supports (class 1 from a file, the others falling back
    to a random pick) in eval and the CHOOSE_CLOSE ranking in training, with
    the flip, the jitter and the mask."""
    if picker == "selected":
        sel = tmp_path / "selected"
        sel.mkdir()
        arr = np.random.RandomState(5).randint(0, 256, (30, 20, 3)).astype(np.uint8)
        image_io.write_ppm(sel / "1_0.jpg", arr)
        monkeypatch.setenv("ONESHOT_SELECTED_SUPP_DIR", str(sel))
        is_train, overrides = False, ["FEW_SHOT.CHOOSE_SELECTED", True]
    else:
        img_dir, ann_file = dataset_files
        pcfg = data_cfgs()[1]
        plain = COCODataset(pcfg, ann_file, img_dir, True, build_fused_transforms(pcfg, True))
        close = {}
        for img_id, cat in zip(plain.ids[:6], plain.chosen_cats[:6]):
            scores = {a["id"]: float(a["id"]) for a in plain.coco.anns.values()
                      if a["category_id"] == cat and a["image_id"] != img_id}
            close.setdefault(cat, {})[img_id] = {cat: scores}
        pkl = tmp_path / "sim.pkl"
        pkl.write_bytes(pickle.dumps(close))
        monkeypatch.setenv("ONESHOT_SUPP_SIM_PKL", str(pkl))
        is_train, overrides = True, ["FEW_SHOT.CHOOSE_CLOSE", True]
    jax, port = _datasets(dataset_files, is_train, *overrides, *AUG2, *MASK)
    jax_items = _items(jax)
    _assert_same_items(_items(port), jax_items)


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_make_data_loader_equals_jax(custom_env, jax_draws_from_random, is_train):
    """Batches of 3 episodes: 9 supports a batch, shot-major, each
    support's variants consecutive; ``supp_sizes`` in the same order."""
    jcfg, pcfg = data_cfgs(*AUG2, *MASK)
    jax_batches = list(jax_build.make_data_loader(jcfg, is_train=is_train)[0])
    port_batches = list(build.make_data_loader(pcfg, is_train=is_train, device="cpu")[0])
    _assert_same_batches(port_batches, jax_batches)
    assert all(b["supp_pixels"].shape[0] == 3 * b["query_pixels"].shape[0]
               for b in port_batches)


def test_loader_workers_do_not_change_batches(custom_env):
    _, pcfg0 = data_cfgs(*AUG2, *MASK)
    _, pcfg4 = data_cfgs(*AUG2, *MASK, "DATALOADER.NUM_WORKERS", 4)
    b0 = list(build.make_data_loader(pcfg0, is_train=True, device="cpu")[0])
    b4 = list(build.make_data_loader(pcfg4, is_train=True, device="cpu")[0])
    assert len(b0) == len(b4) > 0
    for x, y in zip(b0, b4):
        for k in x:
            if isinstance(x[k], torch.Tensor):
                assert torch.equal(x[k], y[k]), k
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("num_aug", [0, 3])
def test_supp_aug_counts_that_disagree_raise(dataset_files, jax_draws_from_random, num_aug):
    """The augmentation makes 1 + 1 or 1 + 2 images a shot. JAX's dataset
    hands the model 2 or 3 where its own count (and the model's merge) says
    1 + NUM_SUPP_AUG; the port raises ValueError."""
    img_dir, ann_file = dataset_files
    jcfg, pcfg = data_cfgs(*AUG1[:3], num_aug)
    with pytest.raises(ValueError, match="NUM_SUPP_AUG"):
        COCODataset(pcfg, ann_file, img_dir, False, build_fused_transforms(pcfg, False))
    jax = JaxCOCODataset(jcfg, ann_file, img_dir, False,
                         jax_transforms.build_fused_transforms(jcfg, False))
    assert jax.actual_num_imgs == 1 + num_aug
    assert len(jax[0]["img_supp"]) == 2 + (num_aug > 1) != jax.actual_num_imgs


def test_synthetic_default_output_is_unchanged(tmp_path):
    """``write_synthetic_coco`` without segmentations writes the bytes it
    always has (SHA-256 of the PPMs by name and the JSON, defaults and the
    loader tests' arguments); with them, the same images."""
    import hashlib
    import os

    def digest(root, **kw):
        img_dir, ann = write_synthetic_coco(root, **kw)
        h, images = hashlib.sha256(), hashlib.sha256()
        for name in sorted(os.listdir(img_dir)):
            data = open(os.path.join(img_dir, name), "rb").read()
            for x in (h, images):
                x.update(name.encode())
                x.update(data)
        h.update(open(ann, "rb").read())
        return h.hexdigest(), images.hexdigest()

    small = dict(num_images=16, sizes=DATA_IMAGE_SIZES, num_categories=3, box_side=(12.0, 40.0))
    assert digest(tmp_path / "a")[0] == \
        "472dcba386ab44c4792ddd7994501bd68757731910e77655d47829da2f2c45dc"
    plain, plain_images = digest(tmp_path / "b", **small)
    assert plain == "a4f9da80fea46763a6c1b91f7767f74f81e819ede5cb7072b372a2ecba205902"
    seg, seg_images = digest(tmp_path / "c", segmentation=True, **small)
    assert seg != plain and seg_images == plain_images


# -- the CLIs with the switches -----------------------------------------------------

@pytest.fixture
def own_logger():
    """The CLIs' logger with no handler, as in a new process (restored after)."""
    import logging

    logger = logging.getLogger("oneshotdet_tpu_torch")
    before = list(logger.handlers)
    logger.handlers.clear()
    yield logger
    for h in logger.handlers:
        h.close()
    logger.handlers[:] = before


def test_clis_run_with_the_switches(custom_env, own_logger, tmp_path):
    """``tools.train_net`` for 2 steps and ``tools.test_net`` over 2 batches
    of its weights with SUPP_AUG (conv, 2 variants), MASK_SUPP and 4 dense
    points, in-process on the CPU: finite losses, the checkpoint holds
    ``supp_aug_conv.weight``, the COCO results are written."""
    from oneshotdet_tpu_torch.tools import test_net, train_net
    from torch_port_common import DATA_OPTS, FLAGSHIP, SMALL

    switches = [*AUG2, "FEW_SHOT.SUPP_AUG_METHOD", "conv", *MASK, "MODEL.FCOS.DENSE_POINTS", 4]
    opts = [str(v) for v in SMALL + DATA_OPTS + switches]
    out = tmp_path / "train"
    assert train_net.main(["--config-file", FLAGSHIP, "--device", "cpu", *opts,
                           "OUTPUT_DIR", str(out), "SOLVER.MAX_ITER", "2"]) == 0
    saved = torch.load(out / "model_final.pth", weights_only=True)["model"]
    assert saved["supp_aug_conv.weight"].shape == (256, 768, 3, 3)
    assert saved["rpn.head.bbox_pred.weight"].shape[0] == 16
    losses = [float(v) for v in re.findall(r"iter \d+/2 loss (\S+)", (out / "log.txt").read_text())]
    assert losses and all(np.isfinite(losses))
    for h in own_logger.handlers:
        h.close()
    own_logger.handlers.clear()
    ev = tmp_path / "eval"
    assert test_net.main(["--config-file", FLAGSHIP, "--device", "cpu", "--ckpt",
                          str(out / "model_final.pth"), *opts, "OUTPUT_DIR", str(ev),
                          "FEW_SHOT.STOP_ITER", "2"]) == 0
    results = json.loads((ev / "eval" / "coco_custom_result.json").read_text())
    assert results and all(np.isfinite(r["score"]) for r in results)
    (out / "model_final.pth").unlink()      # ~0.5 GB with the solver state
