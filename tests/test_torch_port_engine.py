"""The oneshotdet_tpu_torch eval engine and COCO evaluator against the JAX
package's on the CPU, in float32 on the flagship config at test size: the
three step kinds, the fused-head forward, ``compute_on_dataset`` with and
without cached supports, ``do_coco_evaluation`` (detections and proposal
recall) and ``inference``. Both sides get the same seeded numpy weights and
the same numpy batch dicts.
"""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.config import cfg as jax_default_cfg
from oneshotdet_tpu.data.coco_api import LiteCOCO as JaxLiteCOCO
from oneshotdet_tpu.data.datasets.coco import COCODataset
from oneshotdet_tpu.data.evaluation import coco_eval as jax_coco_eval
from oneshotdet_tpu.engine import inference as jax_engine
from oneshotdet_tpu_torch import engine
from oneshotdet_tpu_torch.data import LiteCOCO
from oneshotdet_tpu_torch.data.evaluation import coco_eval
from oneshotdet_tpu_torch.ops import roi_head_fused as rf
from oneshotdet_tpu_torch.utils import Timer, comm
from torch_port_common import assert_same_detections, make_setup, port_model, small_cfgs
from torch_port_common import one_torch_thread  # noqa: F401  (the fixture)

# torch on one thread: the tier-1 run's six workers share the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def models(setup):
    return port_model(setup)


def _batches(n=2):
    """``n`` collator-style numpy batches of two episodes each; target id 2
    repeats, so cached supports are reused."""
    rng = np.random.RandomState(7)
    out = []
    for it in range(n):
        out.append({
            "query_pixels": rng.randn(2, 64, 64, 3).astype(np.float32),
            "query_sizes": np.array([[64.0, 64.0], [48.0 + 8 * it, 56.0]], np.float32),
            "supp_pixels": rng.randn(2, 32, 32, 3).astype(np.float32),
            "supp_sizes": np.array([[32.0, 32.0], [32.0, 24.0 + 4 * it]], np.float32),
            "target_ids": np.array([1 + 2 * it, 2], np.int32),
            "img_ids": np.array([10 + 2 * it, 11 + 2 * it], np.int64),
            "idxs": np.array([2 * it, 2 * it + 1], np.int64),
        })
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in ("img_ids", "idxs")}


def _dets(out):
    xyxy, scores, labels, valid = out[:4]
    return types.SimpleNamespace(xyxy=xyxy, valid=valid,
                                 fields={"scores": scores, "labels": labels})


def _assert_same_outputs(port, ref):
    assert tuple(port[0].shape) == tuple(np.shape(ref[0]))
    assert_same_detections(_dets(port), _dets(ref))
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))


def test_eval_step_matches_jax(setup, models):
    jm, pm = models
    batch = _batches()[0]
    ref = jax_engine.make_eval_step(jm)(setup["variables"], _jax_batch(batch))
    _assert_same_outputs(engine.make_eval_step(pm)(batch), ref)


def test_cached_support_steps_match_jax(setup, models):
    jm, pm = models
    batch = _batches()[1]
    j_support, j_query = jax_engine.make_cached_support_eval_steps(jm)
    p_support, p_query = engine.make_cached_support_eval_steps(pm)
    j = [j_support(setup["variables"], jnp.asarray(batch["supp_pixels"][i:i + 1]),
                   jnp.asarray(batch["supp_sizes"][i:i + 1])) for i in range(2)]
    p = [p_support(batch["supp_pixels"][i:i + 1], batch["supp_sizes"][i:i + 1])
         for i in range(2)]
    ref = j_query(setup["variables"], _jax_batch(batch),
                  [jnp.concatenate([x[0][lvl] for x in j]) for lvl in range(5)],
                  jnp.concatenate([x[1] for x in j]))
    out = p_query(batch, [torch.cat([x[0][lvl] for x in p]) for lvl in range(5)],
                  torch.cat([x[1] for x in p]))
    _assert_same_outputs(out, ref)


def test_multiclass_step_matches_jax(setup, models):
    """S = 2 class-level supports against one query pass; each class slice
    is that class's detections."""
    jm, pm = models
    batch = _batches()[0]
    j_support, _ = jax_engine.make_cached_support_eval_steps(jm)
    p_support, _ = engine.make_cached_support_eval_steps(pm)
    j = [j_support(setup["variables"], jnp.asarray(batch["supp_pixels"][i:i + 1]),
                   jnp.asarray(batch["supp_sizes"][i:i + 1])) for i in range(2)]
    p = [p_support(batch["supp_pixels"][i:i + 1], batch["supp_sizes"][i:i + 1])
         for i in range(2)]
    tids = np.array([4, 9], np.int32)
    ref = jax_engine.make_multiclass_eval_step(jm)(
        setup["variables"], _jax_batch(batch),
        [jnp.stack([x[0][lvl] for x in j]) for lvl in range(5)],
        jnp.stack([x[1] for x in j]), jnp.asarray(tids))
    out = engine.make_multiclass_eval_step(pm)(
        batch, [torch.stack([x[0][lvl] for x in p]) for lvl in range(5)],
        torch.stack([x[1] for x in p]), tids)
    assert out[0].shape[:2] == (2, 2)
    for s in range(2):
        _assert_same_outputs([o[s] for o in out], [np.asarray(r)[s] for r in ref])


@pytest.mark.parametrize("shots", [1, 2])
def test_fused_head_forward_matches_jax(setup, models, monkeypatch, shots):
    """``fused_roi_head=True``: every shot's head pass goes through the fused
    head (its plain version on the CPU), with the JAX forward's detections."""
    jm, pm = models
    calls = []
    plain = rf.fused_roi_head_plain
    monkeypatch.setattr(rf, "fused_roi_head_plain",
                        lambda *a: calls.append(a[3]) or plain(*a))
    monkeypatch.setattr(pm, "config", dataclasses.replace(pm.config, fused_roi_head=True))
    b = _batches()[0]
    if shots == 2:      # rows (image, shot): a second, different support per image
        s, ss = b["supp_pixels"], b["supp_sizes"]
        b = dict(b, supp_pixels=np.stack([s, -0.5 * s], axis=1).reshape(4, 32, 32, 3),
                 supp_sizes=np.stack([ss, ss], axis=1).reshape(4, 2))
    ref = jax_engine.make_eval_step(jm)(setup["variables"], _jax_batch(b))
    _assert_same_outputs(engine.make_eval_step(pm)(b), ref)
    assert calls == [32] * shots          # per-image ROI count: FPN_POST_NMS_TOP_N_TEST


@pytest.mark.parametrize("cache_supports", [False, True], ids=["per_batch", "cached"])
def test_compute_on_dataset_matches_jax(setup, models, cache_supports):
    jm, pm = models
    batches = _batches()
    ref = jax_engine.compute_on_dataset(jm, setup["variables"], batches,
                                        cache_supports=cache_supports)
    out = engine.compute_on_dataset(pm, batches, cache_supports=cache_supports)
    assert sorted(out) == sorted(ref) == [0, 1, 2, 3]
    for idx in ref:
        r, o = ref[idx], out[idx]
        assert o["input_size"] == r["input_size"]
        assert o["boxes"].shape == r["boxes"].shape
        valid = np.ones(len(r["boxes"]), bool)
        assert_same_detections(
            types.SimpleNamespace(xyxy=o["boxes"][None], valid=valid[None],
                                  fields={"scores": o["scores"][None]}),
            types.SimpleNamespace(xyxy=r["boxes"][None], valid=valid[None],
                                  fields={"scores": r["scores"][None]}))


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    """The COCO fixture pattern of tests/test_data.py (6 images, 2
    categories, a big and a small box each), as annotations only, and the
    JAX package's episodic eval dataset over it (both evaluators take it)."""
    root = tmp_path_factory.mktemp("coco")
    images, annotations = [], []
    for i in range(6):
        images.append({"id": i + 1, "file_name": f"{i:06d}.jpg", "width": 120 + 10 * i,
                       "height": 100})
        cat = (i % 2) + 1
        annotations.append({"id": 2 * i + 1, "image_id": i + 1, "category_id": cat,
                            "bbox": [10, 10, 90, 80], "area": 7200.0, "iscrowd": 0})
        annotations.append({"id": 2 * i + 2, "image_id": i + 1, "category_id": cat,
                            "bbox": [2, 2, 10, 10], "area": 100.0, "iscrowd": 0})
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": 1, "name": "widget"}, {"id": 2, "name": "gadget"}]}))
    c = jax_default_cfg.clone()
    c.FEW_SHOT.TEST_EXCL_CATS = []
    return str(ann_file), COCODataset(c, str(ann_file), str(root), is_train=False)


def _predictions(ds, empty_episode=None, seed=0):
    """Per episode: the GT boxes jittered, a near-miss and junk boxes, with
    seeded scores, at a network input scale of 0.5. Episode 3 gets one junk
    box that ranks last (score 0), or no detection at all when it is the
    ``empty_episode``."""
    rng = np.random.RandomState(seed)
    preds = []
    for ep in range(len(ds)):
        info, cat = ds.get_img_info(ep)
        anns = ds.coco.loadAnns(ds.coco.getAnnIds(imgIds=ds.id_to_img_map[ep], catIds=cat,
                                                  iscrowd=False))
        boxes = [[x + rng.uniform(-3, 3), y + rng.uniform(-3, 3), x + w - 1, y + h - 1]
                 for x, y, w, h in (a["bbox"] for a in anns)]
        boxes += [[30.0, 30.0, 70.0, 60.0], [0.0, 0.0, 5.0, 5.0]]
        scores = rng.rand(len(boxes))
        if ep == 3:
            boxes, scores = [[100.0, 80.0, 104.0, 84.0]], np.zeros(1)
        preds.append(None if ep == empty_episode else {
            "boxes": np.array(boxes, np.float64) * 0.5,
            "scores": scores,
            "input_size": (info["width"] * 0.5, info["height"] * 0.5)})
    return preds


@pytest.mark.parametrize("box_only", [False, True], ids=["detections", "proposal_recall"])
def test_coco_evaluation_matches_jax(synthetic_dataset, tmp_path, box_only):
    _, ds = synthetic_dataset
    preds = _predictions(ds)
    ref = jax_coco_eval.do_coco_evaluation(ds, preds, str(tmp_path / "jax"), box_only=box_only)
    out = coco_eval.do_coco_evaluation(ds, preds, str(tmp_path / "port"), box_only=box_only)
    assert out == ref
    assert 0.0 < out["AR@1000" if box_only else "AP50"] < 1.0
    for name in (("box_proposals.json",) if box_only else
                 ("coco_custom_gt.json", "coco_custom_result.json", "coco_ids.json",
                  "coco_results.json")):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_episode_without_detections_counts_as_missed(synthetic_dataset):
    """An episode with ground truth and no detection: its ground truth is
    missed, as with one detection that ranks below all others and matches
    nothing. (The JAX evaluator raises a TypeError on such an episode.)"""
    _, ds = synthetic_dataset
    ref = jax_coco_eval.do_coco_evaluation(ds, _predictions(ds))
    assert coco_eval.do_coco_evaluation(ds, _predictions(ds, empty_episode=3)) == ref


def test_lite_coco_matches_jax(synthetic_dataset):
    ann_file, _ = synthetic_dataset
    j, p = JaxLiteCOCO(ann_file), LiteCOCO(ann_file)
    assert p.getCatIds() == j.getCatIds() and p.getImgIds() == j.getImgIds()
    for cat in j.getCatIds():
        assert p.getImgIds(catIds=cat) == j.getImgIds(catIds=cat)
        for img in j.getImgIds():
            ids = j.getAnnIds(imgIds=img, catIds=cat, iscrowd=False)
            assert p.getAnnIds(imgIds=img, catIds=cat, iscrowd=False) == ids
            assert p.loadAnns(ids) == j.loadAnns(ids)
    assert p.loadImgs(3) == j.loadImgs(3) and p.loadCats([1, 2]) == j.loadCats([1, 2])


@pytest.mark.parametrize("stop_iter", [None, 1])
def test_inference_matches_jax(setup, models, synthetic_dataset, stop_iter):
    jm, pm = models
    _, ds = synthetic_dataset
    jcfg, pcfg = small_cfgs()
    batches = _batches(3)           # the dataset's 6 episodes
    ref = jax_engine.inference(jcfg, jm, setup["variables"], batches, ds, stop_iter=stop_iter)
    out = engine.inference(pcfg, pm, batches, ds, stop_iter=stop_iter)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-6), k


def test_single_card_and_host_rules(models):
    _, pm = models
    with pytest.raises(NotImplementedError, match="mesh"):
        engine.make_eval_step(pm, mesh=object())
    s2d = dict(_batches()[0], query_pixels=np.zeros((2, 32, 32, 12), np.float32))
    with pytest.raises(NotImplementedError, match="HOST_S2D"):
        engine.compute_on_dataset(pm, [s2d])
    assert comm.get_world_size() == 1 and comm.get_rank() == 0 and comm.is_main_process()
    timer = Timer()
    timer.tic()
    assert timer.toc() >= 0.0 and timer.calls == 1
