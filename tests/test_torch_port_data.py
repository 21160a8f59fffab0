"""The port's episodic data path against the JAX package's on the CPU:
image decoding and PIL's crop, ``COCODataset`` (episodes, class split,
supports, boxes, draws), the samplers, ``BatchCollator`` and
``make_data_loader`` batch for batch, ``to_image_batch``,
``compute_thresholds_for_classes`` and the switches that raise.

The JAX side runs at ``DATALOADER.NUM_WORKERS=0`` and ``TPU.HOST_S2D=False``
(the port ignores HOST_S2D). Its pixels come from its native C++ resize,
which the port's resize equals up to the rounding ties that
``tests/test_torch_port_resize.py`` bounds: a value may differ by exactly
one uint8 step, in at most 1e-3 of the values; everything else is equal.
"""

import ast
import pathlib
import pickle
import random

import numpy as np
import pytest
import torch
from PIL import Image

from oneshotdet_tpu.data import build as jax_build
from oneshotdet_tpu.data import samplers as jax_samplers
from oneshotdet_tpu.data.datasets.coco import COCODataset as JaxCOCODataset
from oneshotdet_tpu.data.evaluation.coco_eval import (
    compute_thresholds_for_classes as jax_thresholds)
from oneshotdet_tpu.data.paths_catalog import DatasetCatalog as JaxCatalog
from oneshotdet_tpu.data.transforms import build_fused_transforms as jax_transforms
from oneshotdet_tpu.structures.image_batch import round_up as jax_round_up
from oneshotdet_tpu.structures.image_batch import to_image_batch as jax_to_image_batch
from oneshotdet_tpu_torch.data import build, collate, image_io, samplers
from oneshotdet_tpu_torch.data.datasets.coco import COCODataset
from oneshotdet_tpu_torch.data.evaluation import compute_thresholds_for_classes
from oneshotdet_tpu_torch.data.paths_catalog import DatasetCatalog
from oneshotdet_tpu_torch.data.transforms import build_fused_transforms
from oneshotdet_tpu_torch.structures import round_up, to_image_batch
from torch_port_common import data_cfgs, one_torch_thread, write_dataset  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("coco"))


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
    jax = JaxCOCODataset(jcfg, ann_file, img_dir, is_train, jax_transforms(jcfg, is_train))
    return jax, port


def _port_dataset(dataset_files, is_train, *overrides):
    img_dir, ann_file = dataset_files
    pcfg = data_cfgs(*overrides)[1]
    return COCODataset(pcfg, ann_file, img_dir, is_train, build_fused_transforms(pcfg, is_train))


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _assert_same_image(p, j):
    assert p["out_hw"] == j["out_hw"]
    np.testing.assert_array_equal(p["u8"], j["u8"])
    np.testing.assert_array_equal(p["mean"], j["mean"])
    np.testing.assert_array_equal(p["std"], j["std"])
    assert p["to_bgr255"] == j["to_bgr255"]


def _assert_same_items(port_items, jax_items):
    assert len(port_items) == len(jax_items)
    for p, j in zip(port_items, jax_items):
        assert (p["idx"], p["target_id"], p["img_id"]) == (j["idx"], j["target_id"], j["img_id"])
        _assert_same_image(p["img"], j["img"])
        np.testing.assert_array_equal(p["boxes"], j["boxes"])
        assert p["boxes"].dtype == j["boxes"].dtype
        np.testing.assert_array_equal(p["labels"], j["labels"])
        assert len(p["img_supp"]) == len(j["img_supp"])
        for ps, js in zip(p["img_supp"], j["img_supp"]):
            _assert_same_image(ps, js)


def assert_pixels_match(port, jax, std):
    """Equal, or one uint8 step apart (BGR255, /std) in at most 1e-3 of the
    values: the rounding ties of the JAX package's contracted C++ pass."""
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    assert port.shape == jax.shape and port.dtype == jax.dtype == np.float32
    diff = port != jax
    assert diff.sum() <= 1e-3 * diff.size
    if diff.any():
        step = 1.0 / np.float32(std)
        np.testing.assert_allclose(np.abs(port - jax)[diff],
                                   np.broadcast_to(step, port.shape)[diff], rtol=1e-5)


def _assert_same_batches(port_batches, jax_batches, std=(1.0, 1.0, 1.0)):
    assert len(port_batches) == len(jax_batches) > 0
    for p, j in zip(port_batches, jax_batches):
        assert set(p) == set(j)
        for k in j:
            if k in ("query_pixels", "supp_pixels"):
                assert isinstance(p[k], torch.Tensor) and p[k].device.type == "cpu"
                assert_pixels_match(p[k], j[k], std)
            else:
                assert isinstance(p[k], np.ndarray) and p[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)


# -- image decoding and cropping ---------------------------------------------

@pytest.mark.parametrize("fmt", ["ppm", "png", "jpeg"])
def test_read_image_rgb_equals_pil(tmp_path, fmt):
    arr = np.random.RandomState(1).randint(0, 256, (23, 31, 3)).astype(np.uint8)
    path = tmp_path / f"im.{fmt}"
    Image.fromarray(arr).save(path, format=fmt.upper())
    got = image_io.read_image_rgb(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, want)


def test_ppm_header_comments_and_writer(tmp_path):
    arr = np.random.RandomState(2).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n7 # width\n5\n255\n" + arr.tobytes())
    np.testing.assert_array_equal(image_io.read_image_rgb(path), arr)
    image_io.write_ppm(tmp_path / "w.ppm", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.ppm")), arr)


def test_format_is_chosen_by_magic_bytes(tmp_path, monkeypatch):
    arr = np.random.RandomState(3).randint(0, 256, (6, 4, 3)).astype(np.uint8)
    disguised = tmp_path / "ppm_named.jpg"
    image_io.write_ppm(disguised, arr)
    png = tmp_path / "im.png"
    Image.fromarray(arr).save(png)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)   # PIL missing
    np.testing.assert_array_equal(image_io.read_image_rgb(disguised), arr)
    with pytest.raises(ImportError, match="im.png"):
        image_io.read_image_rgb(png)


BOXES = [(3.5, 2.5, 17.5, 11.5), (2.5, 4.5, 9.5, 12.5), (0.4, 0.6, 30.6, 22.4),
         (-4.5, -3.0, 10.0, 8.5), (20.5, 15.5, 40.0, 30.0), (-5, -5, 50, 50),
         (10.0, 5.0, 10.0, 9.0), (31.0, 0.0, 35.0, 4.0)]


@pytest.mark.parametrize("box", BOXES, ids=str)
def test_crop_equals_pil_crop(box):
    arr = np.random.RandomState(4).randint(0, 256, (23, 31, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(arr).crop(box))
    got = image_io.crop(arr, box)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_port_imports_pil_only_inside_functions():
    for path in sorted((ROOT / "oneshotdet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n == "PIL" or n.startswith("PIL.") for n in names), path


# -- the dataset ---------------------------------------------------------------

@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_dataset_equals_jax(dataset_files, is_train):
    jax, port = _datasets(dataset_files, is_train)
    jax_items = _items(jax)
    port_items = _items(port)
    assert port.ids == jax.ids and port.chosen_cats == jax.chosen_cats
    assert port.catalog == jax.catalog
    assert port.json_category_id_to_contiguous_id == jax.json_category_id_to_contiguous_id
    assert port.id_to_img_map == jax.id_to_img_map
    assert [port.get_img_info(i) for i in range(len(port))] == \
        [jax.get_img_info(i) for i in range(len(jax))]
    _assert_same_items(port_items, jax_items)
    # both image orientations, supports cropped across the image edge
    assert {it["img"]["out_hw"] for it in port_items} >= {(64, 85), (85, 64)}
    if is_train:    # the flip draws: some queries flipped, some not
        port2 = _port_dataset(dataset_files, True)
        flipped = [port2.plan(i).query_draw[1] for i in range(len(port2))]
        assert any(flipped) and not all(flipped)


def test_plan_then_load_equals_getitem(dataset_files):
    a = _port_dataset(dataset_files, True)
    b = _port_dataset(dataset_files, True)
    episodes = [b.plan(i) for i in range(len(b))]
    _assert_same_items([b.load(ep) for ep in reversed(episodes)][::-1], _items(a))


@pytest.mark.parametrize("overrides", [
    ("FEW_SHOT.TEST_EXCL_CATS", "[2]"),
    ("FEW_SHOT.TEST_SELECTED_CLS", 3),
    ("FEW_SHOT.NUM_SHOT", 2),
], ids=["test_excl_cats", "test_selected_cls", "two_shots"])
def test_dataset_class_split_equals_jax(dataset_files, overrides):
    jax, port = _datasets(dataset_files, False, *overrides)
    jax_items = _items(jax)
    assert port.ids == jax.ids and port.chosen_cats == jax.chosen_cats
    _assert_same_items(_items(port), jax_items)


def test_training_exclusions_equal_jax(dataset_files):
    jax, port = _datasets(dataset_files, True, "FEW_SHOT.TRAINING_EXCL_CATS", "[1, 3]")
    jax_items = _items(jax)
    assert set(port.chosen_cats) == {2}
    assert port.ids == jax.ids
    _assert_same_items(_items(port), jax_items)


def test_task1_split_equals_jax(dataset_files, tmp_path, monkeypatch):
    split = tmp_path / "task1.txt"
    split.write_text("".join(f"{i:06d}.ppm 0\n" for i in range(0, 16, 2)))
    monkeypatch.setenv("ONESHOT_TASK1_SPLIT", str(split))
    jax, port = _datasets(dataset_files, False, "FEW_SHOT.TASK", 1)
    jax_items = _items(jax)
    assert port.ids == jax.ids and set(port.ids) <= set(range(1, 17, 2))
    _assert_same_items(_items(port), jax_items)


def test_choose_selected_equals_jax(dataset_files, tmp_path, monkeypatch):
    sel = tmp_path / "selected"
    sel.mkdir()
    arr = np.random.RandomState(5).randint(0, 256, (30, 20, 3)).astype(np.uint8)
    image_io.write_ppm(sel / "1_0.jpg", arr)           # class 1 has a file; 2, 3 fall back
    monkeypatch.setenv("ONESHOT_SELECTED_SUPP_DIR", str(sel))
    jax, port = _datasets(dataset_files, False, "FEW_SHOT.CHOOSE_SELECTED", True,
                          "FEW_SHOT.CHOOSE_CLOSE", False)
    jax_items = _items(jax)
    port_items = _items(port)
    _assert_same_items(port_items, jax_items)
    fixed = [it for it in port_items if it["target_id"] == 1]
    assert fixed and all(it["img_supp"][0]["u8"].shape == (30, 20, 3) for it in fixed)


def test_choose_close_in_training_equals_jax(dataset_files, tmp_path, monkeypatch):
    port = _port_dataset(dataset_files, True)
    anns = port.coco.anns
    close = {}
    for img_id, cat in zip(port.ids[:6], port.chosen_cats[:6]):
        scores = {a["id"]: float(a["id"]) for a in anns.values()
                  if a["category_id"] == cat and a["image_id"] != img_id}
        close.setdefault(cat, {})[img_id] = {cat: scores}
    pkl = tmp_path / "sim.pkl"
    pkl.write_bytes(pickle.dumps(close))
    monkeypatch.setenv("ONESHOT_SUPP_SIM_PKL", str(pkl))
    jax, port = _datasets(dataset_files, True)
    assert port.close_dict is not None
    jax_items = _items(jax)
    _assert_same_items(_items(port), jax_items)


# -- samplers -----------------------------------------------------------------------

def test_samplers_equal_jax(dataset_files):
    port = _port_dataset(dataset_files, False)
    for kw in (dict(num_replicas=1, rank=0, shuffle=False),
               dict(num_replicas=3, rank=1, shuffle=True, seed=5)):
        ps, js = samplers.DistributedSampler(len(port), **kw), \
            jax_samplers.DistributedSampler(len(port), **kw)
        ps.set_epoch(2)
        js.set_epoch(2)
        assert list(ps) == list(js) and len(ps) == len(js)
    ps = samplers.DistributedSampler(len(port), shuffle=False)
    js = jax_samplers.DistributedSampler(len(port), shuffle=False)
    for drop_last in (True, False):
        assert list(samplers.iterate_batches(ps, 3, drop_last)) == \
            list(jax_samplers.iterate_batches(js, 3, drop_last))
        assert list(samplers.grouped_batches(port, ps, 3, drop_last)) == \
            list(jax_samplers.grouped_batches(port, js, 3, drop_last))
    assert list(samplers.iteration_based_batches(ps, 4, 9, 2)) == \
        list(jax_samplers.iteration_based_batches(js, 4, 9, 2))
    assert list(samplers.grouped_iteration_batches(port, ps, 3, 7, 1)) == \
        list(jax_samplers.grouped_iteration_batches(port, js, 3, 7, 1))
    assert samplers.group_indices_by_orientation(port, range(len(port))) == \
        jax_samplers.group_indices_by_orientation(port, range(len(port)))


# -- collator and loader --------------------------------------------------------------

def test_collator_equals_jax(dataset_files):
    jax, port = _datasets(dataset_files, False)
    jax_items, port_items = _items(jax), _items(port)
    jcfg, pcfg = data_cfgs()
    jcol = jax_build.BatchCollator(jcfg)
    pcol = collate.BatchCollator(pcfg, device="cpu")
    for lo, hi in ((0, 3), (3, 4), (4, 9)):
        _assert_same_batches([pcol(port_items[lo:hi])], [jcol(jax_items[lo:hi])])


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_make_data_loader_equals_jax(custom_env, is_train):
    jcfg, pcfg = data_cfgs()
    jl, _ = jax_build.make_data_loader(jcfg, is_train=is_train)
    jax_batches = list(jl)
    pl, pds = build.make_data_loader(pcfg, is_train=is_train, device="cpu")
    port_batches = list(pl)
    _assert_same_batches(port_batches, jax_batches)
    if not is_train:    # every episode once; both query buckets occur
        assert sorted(i for b in port_batches for i in b["idxs"]) == list(range(len(pds)))
        assert {tuple(b["query_pixels"].shape[1:3]) for b in port_batches} == \
            {(64, 96), (96, 64)}
    assert list(pl) and len(list(pl)) == len(port_batches)     # re-iterable


def test_loader_workers_do_not_change_batches(custom_env):
    _, pcfg0 = data_cfgs()
    _, pcfg4 = data_cfgs("DATALOADER.NUM_WORKERS", 4)
    for is_train in (False, True):
        b0 = list(build.make_data_loader(pcfg0, is_train=is_train, device="cpu")[0])
        b4 = list(build.make_data_loader(pcfg4, is_train=is_train, device="cpu")[0])
        assert len(b0) == len(b4)
        for x, y in zip(b0, b4):
            for k in x:
                if isinstance(x[k], torch.Tensor):
                    assert torch.equal(x[k], y[k]), k
                else:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_loader_stops_early_and_leaves_no_thread(custom_env):
    import threading

    _, pcfg = data_cfgs("DATALOADER.NUM_WORKERS", 3)
    loader, _ = build.make_data_loader(pcfg, is_train=False, device="cpu")
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_global_random_is_untouched(dataset_files, custom_env):
    state = random.getstate()
    _items(_port_dataset(dataset_files, True))
    list(build.make_data_loader(data_cfgs()[1], is_train=True, device="cpu")[0])
    assert random.getstate() == state


# -- catalog, structures, thresholds, switches ---------------------------------------

def test_dataset_catalog_equals_jax(monkeypatch, custom_env):
    monkeypatch.setenv("ONESHOT_DATA_DIR", JaxCatalog.DATA_DIR)
    for name in list(JaxCatalog.DATASETS) + ["custom"]:
        assert DatasetCatalog.get(name) == JaxCatalog.get(name)
    with pytest.raises(KeyError):
        DatasetCatalog.get("no_such_dataset")
    monkeypatch.setenv("ONESHOT_DATA_DIR", "/data")
    assert DatasetCatalog.get("coco_2017_val")["args"]["root"] == "/data/coco/val2017"


def test_to_image_batch_and_round_up_equal_jax():
    for x, d in ((1, 32), (32, 32), (33, 32), (100, 7), (0, 4)):
        assert round_up(x, d) == jax_round_up(x, d)
    rng = np.random.RandomState(6)
    images = [rng.randn(h, w, 3).astype(np.float32) for h, w in ((20, 30), (33, 17), (8, 8))]
    for bucket in (None, (64, 64)):
        got = to_image_batch(images, bucket, device="cpu")
        want = jax_to_image_batch(images, bucket)
        np.testing.assert_array_equal(got.pixels.numpy(), np.asarray(want.pixels))
        np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    with pytest.raises(ValueError, match="exceeds"):
        to_image_batch(images, (16, 16), device="cpu")


def test_compute_thresholds_for_classes_equals_jax():
    rng = np.random.RandomState(7)
    gt, dt = {}, {}
    for img in range(6):
        for cat in (1, 2, 3):
            boxes = rng.uniform(0, 80, (rng.randint(1, 4), 2))
            gt[(img, cat)] = [{"bbox": [float(x), float(y), 30.0, 20.0], "area": 600.0,
                               "iscrowd": 0} for x, y in boxes]
            dets = []
            for x, y in boxes:
                if rng.rand() < 0.8:
                    dets.append({"bbox": [float(x + rng.uniform(-4, 4)), float(y), 30.0, 20.0],
                                 "score": float(rng.rand())})
            dets += [{"bbox": [float(v) for v in rng.uniform(0, 80, 2)] + [25.0, 25.0],
                      "score": float(rng.rand())} for _ in range(rng.randint(0, 3))]
            dt[(img, cat)] = dets
    got = compute_thresholds_for_classes(gt, dt, [1, 2, 3], list(range(6)))
    want = jax_thresholds(gt, dt, [1, 2, 3], list(range(6)))
    assert got.shape == (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("switch", ["MODEL.MASK_ON", "MODEL.KEYPOINT_ON"])
def test_mask_keypoint_switches_carry_their_field(dataset_files, switch):
    """With MASK_ON or KEYPOINT_ON the dataset builds and its items carry
    the field (this dataset has no polygons or keypoints, so zeros;
    held to JAX in ``test_torch_port_mask_data.py``)."""
    img_dir, ann_file = dataset_files
    _, pcfg = data_cfgs(switch, True)
    ds = COCODataset(pcfg, ann_file, img_dir, False, build_fused_transforms(pcfg, False))
    item = ds[0]
    key = "masks" if switch == "MODEL.MASK_ON" else "keypoints"
    assert len(item[key]) == len(item["boxes"]) and not item[key].any()
