"""The data and evaluation side of MODEL.MASK_ON / KEYPOINT_ON against the
JAX package on the CPU: episodes (the GT polygons carried through the
resize and the flip, cropped to their boxes and rasterized at
TPU.MASK_RASTER^2; the COCO keypoints through the same geometry) and
collated batches (``gt_masks``, ``gt_keypoints``) equal to JAX's
``COCODataset`` and ``make_data_loader`` at ``DATALOADER.NUM_WORKERS=0``;
``PersonKeypoints``; ``mask_iou`` and ``oks_iou``; the evaluator's segm and
keypoints results equal to JAX's on the same predictions (more than 100
detections in some episodes, of which both read the best 100); and the
engine and ``tools.test_net`` surfacing the masks and keypoints.
"""

import json
import logging

import numpy as np
import pytest
import torch

from oneshotdet_tpu.data import build as jax_build
from oneshotdet_tpu.data import transforms as jax_transforms
from oneshotdet_tpu.data.datasets.coco import COCODataset as JaxCOCODataset
from oneshotdet_tpu.data.evaluation import coco_metrics as jax_metrics
from oneshotdet_tpu.data.evaluation.coco_eval import do_coco_evaluation as jax_evaluate
from oneshotdet_tpu.structures.keypoint import PersonKeypoints as JaxPersonKeypoints
from oneshotdet_tpu_torch.data import build
from oneshotdet_tpu_torch.data.datasets.coco import COCODataset
from oneshotdet_tpu_torch.data.evaluation import coco_metrics
from oneshotdet_tpu_torch.data.evaluation.coco_eval import do_coco_evaluation
from oneshotdet_tpu_torch.data.transforms import build_fused_transforms
from oneshotdet_tpu_torch.engine.inference import compute_on_dataset
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.structures import ImageBatch
from oneshotdet_tpu_torch.structures.keypoint import PersonKeypoints
from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco
from test_torch_port_data import _assert_same_batches, _assert_same_items, _items
from torch_port_common import DATA_IMAGE_SIZES, data_cfgs, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MASK = ["MODEL.MASK_ON", True, "TPU.MASK_RASTER", 12]
KP = ["MODEL.KEYPOINT_ON", True]
HEADS = ["MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(16,)", "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", "(16,)"]


@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    """The loader tests' synthetic dataset with polygons and keypoints; one
    annotation in five holds an uncompressed RLE instead and one in seven
    no segmentation, one in six no keypoints."""
    root = tmp_path_factory.mktemp("coco_mk")
    img_dir, ann_file = write_synthetic_coco(root, num_images=16, sizes=DATA_IMAGE_SIZES,
                                             num_categories=3, box_side=(12.0, 40.0), seed=0,
                                             segmentation=True, keypoints=True)
    data = json.load(open(ann_file))
    for k, ann in enumerate(data["annotations"]):
        if k % 5 == 4:
            ann["segmentation"] = {"size": [4, 4], "counts": [5, 6, 5]}
        elif k % 7 == 6:
            del ann["segmentation"]
        if k % 6 == 5:
            del ann["keypoints"], ann["num_keypoints"]
    json.dump(data, open(ann_file, "w"))
    return img_dir, ann_file


@pytest.fixture
def custom_env(dataset_files, monkeypatch):
    img_dir, ann_file = dataset_files
    monkeypatch.setenv("ONESHOT_CUSTOM_IMG_DIR", img_dir)
    monkeypatch.setenv("ONESHOT_CUSTOM_ANN_FILE", ann_file)
    return dataset_files


@pytest.fixture
def cli_logger():
    """The CLIs' logger set up afresh for an in-process call (the call adds
    its handlers, with the file in its OUTPUT_DIR) and put back after."""
    logger = logging.getLogger("oneshotdet_tpu_torch")
    saved = list(logger.handlers)
    logger.handlers.clear()
    yield
    for h in logger.handlers:
        h.close()
    logger.handlers[:] = saved


def _datasets(dataset_files, is_train, *overrides):
    img_dir, ann_file = dataset_files
    jcfg, pcfg = data_cfgs(*overrides)
    port = COCODataset(pcfg, ann_file, img_dir, is_train, build_fused_transforms(pcfg, is_train))
    jax = JaxCOCODataset(jcfg, ann_file, img_dir, is_train,
                         jax_transforms.build_fused_transforms(jcfg, is_train))
    return jax, port


CONFIGS = {
    "masks, eval": (False, MASK),
    "masks, train (flips)": (True, MASK),
    "keypoints, train (flips)": (True, KP),
    "masks and keypoints, train (flips)": (True, MASK + KP),
    "masks and keypoints, eval": (False, MASK + KP),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_episodes_equal_jax(dataset_files, case):
    is_train, overrides = CONFIGS[case]
    jax, port = _datasets(dataset_files, is_train, *overrides)
    jax_items, port_items = _items(jax), _items(port)
    _assert_same_items(port_items, jax_items)
    for key in ("masks", "keypoints"):
        assert (key in port_items[0]) == (key in jax_items[0])
        if key not in jax_items[0]:
            continue
        for p, j in zip(port_items, jax_items):
            assert p[key].dtype == j[key].dtype == np.float32
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    if "masks" in port_items[0]:
        rasters = np.concatenate([it["masks"] for it in port_items])
        assert rasters.shape[1:] == (12, 12) and rasters.any() and not rasters.all()
    if is_train:
        flips = [port.plan(i).query_draw[1] for i in range(len(port))]
        assert any(flips) and not all(flips)


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_make_data_loader_equals_jax(custom_env, is_train):
    jcfg, pcfg = data_cfgs(*MASK, *KP)
    jax_batches = list(jax_build.make_data_loader(jcfg, is_train=is_train)[0])
    port_batches = list(build.make_data_loader(pcfg, is_train=is_train, device="cpu")[0])
    _assert_same_batches(port_batches, jax_batches)
    b = port_batches[0]
    assert b["gt_masks"].shape == (3, pcfg.TPU.MAX_GT_BOXES, 12, 12)
    assert b["gt_keypoints"].shape == (3, pcfg.TPU.MAX_GT_BOXES, 17, 3)


def test_person_keypoints_equal_jax():
    rng = np.random.RandomState(4)
    kp = np.concatenate([rng.uniform(0, 50, (3, 17, 2)), rng.randint(0, 3, (3, 17, 1))], -1)
    p, j = PersonKeypoints(kp, (60, 50)), JaxPersonKeypoints(kp, (60, 50))
    assert p.FLIP_INDS == j.FLIP_INDS and p.NAMES == j.NAMES
    for pp, jj in ((p.resize((90, 40)), j.resize((90, 40))), (p.transpose(0), j.transpose(0)),
                   (p.crop((5, 6, 40, 30)), j.crop((5, 6, 40, 30))), (p[1], j[1]),
                   (p[[0, 2]], j[[0, 2]]), (p.resize((33, 71)).transpose(0),
                                            j.resize((33, 71)).transpose(0))):
        assert pp.size == jj.size and len(pp) == len(jj)
        np.testing.assert_array_equal(pp.keypoints, jj.keypoints)
    with pytest.raises(NotImplementedError):
        p.transpose(1)


def test_mask_iou_and_oks_equal_jax():
    rng = np.random.RandomState(5)
    dts = [(rng.rand(20, 30) > t).astype(np.uint8) for t in (0.3, 0.5, 0.9, 1.0)]
    gts = [(rng.rand(20, 30) > t).astype(np.uint8) for t in (0.4, 0.7, 1.0)]
    crowd = np.array([0, 1, 0])
    np.testing.assert_array_equal(coco_metrics.mask_iou(dts, gts, crowd),
                                  jax_metrics.mask_iou(dts, gts, crowd))

    def kps(n_vis):
        v = np.zeros(17)
        v[:n_vis] = 2
        xy = rng.uniform(0, 100, (17, 2))
        return [float(a) for a in np.concatenate([xy, v[:, None]], 1).reshape(-1)]

    gt = [{"keypoints": kps(n), "bbox": [10.0, 5.0, 40.0, 60.0], "area": a}
          for n, a in ((17, 2400.0), (3, 900.0), (0, 1500.0))]
    dt = [{"keypoints": kps(17)} for _ in range(4)]
    dt.append({"keypoints": gt[0]["keypoints"]})
    np.testing.assert_array_equal(coco_metrics.oks_iou(dt, gt), jax_metrics.oks_iou(dt, gt))
    assert coco_metrics.oks_iou(dt, gt)[4, 0] == 1.0


def _predictions(dataset, rng):
    """Per episode: boxes around its GT (jittered) and elsewhere, random
    scores, smooth mask probabilities and keypoints near the GT's; two
    episodes with 130 detections (over the protocol's 100). Every episode
    has detections: JAX's evaluator fails on an episode with GT and none
    (the port's counts its GT as missed, ``coco_metrics._evaluate_img``)."""
    preds = []
    for i in range(len(dataset)):
        info, cat = dataset.get_img_info(i)
        w, h = info["width"], info["height"]
        anns = dataset.coco.loadAnns(dataset.coco.getAnnIds(
            imgIds=dataset.id_to_img_map[i], catIds=cat, iscrowd=False))
        n = 130 if i in (1, 4) else 7
        src = [a["bbox"] for a in anns] or [[0.0, 0.0, w / 2, h / 2]]
        base = np.array([src[k % len(src)] for k in range(n)], np.float64)
        xy = base[:, :2] + rng.uniform(-3, 3, (n, 2))
        wh = base[:, 2:] * rng.uniform(0.8, 1.2, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1)
        boxes[n // 2:] = np.sort(rng.uniform(0, min(w, h), (n - n // 2, 2, 2)), 1).reshape(-1, 4)
        scale = rng.uniform(0.8, 1.25)          # the network's input scale
        yy, xx = np.mgrid[0:28, 0:28] / 27.0
        probs = np.stack([1 / (1 + np.exp(-8 * (rng.uniform(0.3, 0.7) - (xx - 0.5) ** 2
                                                 - (yy - rng.uniform(0.3, 0.7)) ** 2)))
                          for _ in range(n)]).astype(np.float32)
        kp = rng.uniform(0, 1, (n, 17, 2)) * wh[:, None] + xy[:, None]
        for k, a in enumerate(anns):          # one detection near each GT's keypoints
            if "keypoints" in a and k < n:
                kp[k] = np.asarray(a["keypoints"], np.float64).reshape(17, 3)[:, :2] \
                    + rng.uniform(-1, 1, (17, 2))
        preds.append({"boxes": (boxes * scale).astype(np.float32),
                      "scores": rng.uniform(0, 1, n).astype(np.float32),
                      "input_size": (w * scale, h * scale),
                      "mask_probs": probs,
                      "keypoints_xy": (kp * scale).astype(np.float32),
                      "keypoints_scores": rng.uniform(0, 5, (n, 17)).astype(np.float32)})
    return preds


def test_segm_and_keypoint_results_equal_jax(dataset_files, tmp_path):
    jax, port = _datasets(dataset_files, False)
    preds = _predictions(port, np.random.RandomState(6))
    want = jax_evaluate(jax, preds, str(tmp_path / "jax"))
    got = do_coco_evaluation(port, preds, str(tmp_path / "port"))
    assert {k for k in got if k.startswith("segm_")} == {f"segm_{k}" for k in
                                                           ("AP", "AP50", "AP75", "APs", "APm",
                                                            "APl", "AR@1", "AR@10", "AR@100")}
    assert {k for k in got if k.startswith("keypoints_")} == {
        f"keypoints_{k}" for k in ("AP", "AP50", "AP75", "APm", "APl", "AR@20")}
    assert got == want
    assert got["segm_AP"] > 0 and got["keypoints_AR@20"] > 0
    assert json.load(open(tmp_path / "port" / "coco_results.json")) == got


def _mk_model():
    _, pcfg = data_cfgs(*MASK, *KP, *HEADS, "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8,
                        "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 16)
    return pcfg, build_detection_model(pcfg, device="cpu",
                                       generator=torch.Generator().manual_seed(3))


def test_engine_surfaces_masks_and_keypoints(custom_env):
    pcfg, model = _mk_model()
    loader, dataset = build.make_data_loader(pcfg, is_train=False, device="cpu")
    batch = next(iter(loader))
    results = compute_on_dataset(model, [batch])
    dets = model(ImageBatch(torch.as_tensor(batch["query_pixels"]),
                            torch.as_tensor(batch["query_sizes"])),
                 ImageBatch(torch.as_tensor(batch["supp_pixels"]),
                            torch.as_tensor(batch["supp_sizes"])),
                 target_ids=torch.as_tensor(batch["target_ids"]))
    for i, idx in enumerate(batch["idxs"]):
        r = results[int(idx)]
        v = dets.valid[i].numpy()
        n = int(v.sum())
        assert n > 0 and r["mask_probs"].shape == (n, 28, 28)
        assert r["keypoints_xy"].shape == (n, 17, 2) and r["keypoints_scores"].shape == (n, 17)
        np.testing.assert_array_equal(r["mask_probs"], dets.get_field("mask_probs")[i][v].numpy())
        np.testing.assert_array_equal(r["keypoints_xy"],
                                      dets.get_field("keypoints_xy")[i][v].numpy())


def test_test_net_reports_segm_and_keypoints(custom_env, cli_logger, tmp_path):
    from oneshotdet_tpu_torch.tools import test_net
    from torch_port_common import DATA_OPTS, FLAGSHIP, SMALL

    out = tmp_path / "out"
    args = ["--config-file", FLAGSHIP, "--device", "cpu"] + [
        str(x) for x in SMALL + DATA_OPTS + MASK + KP + HEADS
        + ["OUTPUT_DIR", str(out), "FEW_SHOT.STOP_ITER", 2,
           "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8]]
    assert test_net.main(args) == 0
    results = [json.load(open(p)) for p in out.rglob("coco_results.json")]
    assert len(results) == 1
    for k in ("AP", "segm_AP", "segm_AR@100", "keypoints_AP", "keypoints_AR@20"):
        assert k in results[0] and np.isfinite(results[0][k])


def test_checkpointer_overlays_the_heads(tmp_path):
    """A .pth with the heads under the reference's names (a 'module.'
    prefix, as a DDP save has) loads through ``Checkpointer``'s overlay."""
    from oneshotdet_tpu_torch.utils.checkpoint import Checkpointer

    _, src = _mk_model()
    _, dst = _mk_model()
    with torch.no_grad():
        for name, p in src.named_parameters():
            if name.startswith(("roi_heads.mask.", "roi_heads.keypoint.")):
                p.add_(1.0)
    path = tmp_path / "heads.pth"
    torch.save({"model": {"module." + k: v for k, v in src.state_dict().items()}}, path)
    Checkpointer(str(tmp_path / "out")).load(dst, f=str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    assert any(k.startswith("roi_heads.keypoint.predictor.") for k in dst.state_dict())


def test_train_net_reports_mask_and_keypoint_losses(custom_env, cli_logger, tmp_path):
    from oneshotdet_tpu_torch.tools import train_net
    from torch_port_common import DATA_OPTS, FLAGSHIP, SMALL

    out = tmp_path / "train"
    args = ["--config-file", FLAGSHIP, "--device", "cpu", "--skip-test"] + [
        str(x) for x in SMALL + DATA_OPTS + MASK + KP + HEADS
        + ["OUTPUT_DIR", str(out), "SOLVER.MAX_ITER", 2, "SOLVER.CHECKPOINT_PERIOD", 10]]
    assert train_net.main(args) == 0
    log = (out / "log.txt").read_text()
    for key in ("loss_mask", "loss_kp"):
        assert key in log
    assert "nan" not in log.lower().split("loss_mask")[1][:40]
