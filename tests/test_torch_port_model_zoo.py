"""The port's model zoo (``oneshotdet_tpu_torch/utils/model_zoo.py``,
``data/paths_catalog.py::ModelCatalog``) and Caffe2 import
(``utils/c2_import.py``) against the JAX package's, offline: the cases of
``tests/test_model_zoo.py`` (catalog URLs, ``file://`` caching, fragments,
Detectron ``model_final.pkl`` names, the hash check, a custom catalog) and
synthetic Detectron-style ResNet-50 blobs, converted into both Siamese
backbones, equal to JAX's conversion through ``state_dict_from_flax``
exactly; then loaded by ``Checkpointer`` from a ``catalog://`` name.
"""

import hashlib
import os
import pickle

import numpy as np
import pytest
import torch

from oneshotdet_tpu.data.paths_catalog import ModelCatalog as JaxModelCatalog
from oneshotdet_tpu.utils import c2_import as jax_c2
from oneshotdet_tpu.utils import model_zoo as jax_zoo
from oneshotdet_tpu_torch.data.paths_catalog import ModelCatalog
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.utils import c2_import, model_zoo
from oneshotdet_tpu_torch.utils.checkpoint import Checkpointer
from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_c2_resnet
from torch_port_common import make_setup, small_cfgs, state_dict_from_flax

NAMES = ([f"ImageNetPretrained/{k}" for k in JaxModelCatalog.C2_IMAGENET_MODELS]
         + [f"Caffe2Detectron/COCO/{k}" for k in JaxModelCatalog.C2_DETECTRON_MODELS])


@pytest.mark.parametrize("name", NAMES)
def test_catalog_urls_equal_jax(name):
    assert ModelCatalog.get(name) == JaxModelCatalog.get(name)


def test_catalog_unknown_name():
    with pytest.raises(RuntimeError, match="not present in the catalog"):
        ModelCatalog.get("NoSuchFamily/whatever")
    assert ModelCatalog.get("ImageNetPretrained/MSRA/R-50") == (
        "https://dl.fbaipublicfiles.com/detectron/ImageNetPretrained/MSRA/R-50.pkl")


def test_cache_url_file_scheme(tmp_path):
    src = tmp_path / "weights.pkl"
    src.write_bytes(b"payload")
    cached = model_zoo.cache_url(src.as_uri(), model_dir=str(tmp_path / "cache"))
    assert open(cached, "rb").read() == b"payload"
    assert cached == jax_zoo.cache_url(src.as_uri(), model_dir=str(tmp_path / "cache"))
    src.unlink()            # a cache hit needs no source
    assert model_zoo.cache_url(src.as_uri(), model_dir=str(tmp_path / "cache")) == cached


@pytest.mark.parametrize("suffix,name", [("#renamed.pkl", "renamed.pkl"), ("", "blob.bin")])
def test_cache_url_fragment_names_the_file(tmp_path, suffix, name):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"x")
    port = model_zoo.cache_url(src.as_uri() + suffix, model_dir=str(tmp_path / "p"))
    ref = jax_zoo.cache_url(src.as_uri() + suffix, model_dir=str(tmp_path / "j"))
    assert os.path.basename(port) == os.path.basename(ref) == name


def test_cache_url_model_final_named_by_path(tmp_path):
    d = tmp_path / "35857345" / "output"
    d.mkdir(parents=True)
    (d / "model_final.pkl").write_bytes(b"m")
    port = model_zoo.cache_url((d / "model_final.pkl").as_uri(), model_dir=str(tmp_path / "p"))
    ref = jax_zoo.cache_url((d / "model_final.pkl").as_uri(), model_dir=str(tmp_path / "j"))
    assert os.path.basename(port) == os.path.basename(ref)
    assert os.path.basename(port) != "model_final.pkl" and "35857345" in port


def test_cache_url_hash_check(tmp_path):
    src = tmp_path / "f.bin"
    src.write_bytes(b"data")
    good = hashlib.sha256(b"data").hexdigest()[:8]
    assert os.path.exists(model_zoo.cache_url(src.as_uri() + f"#w-{good}.pth",
                                              model_dir=str(tmp_path / "c1")))
    with pytest.raises(RuntimeError, match="invalid hash"):
        model_zoo.cache_url(src.as_uri() + "#w-deadbeef.pth", model_dir=str(tmp_path / "c2"))
    assert not os.listdir(tmp_path / "c2")
    # a short hex run is no hash (Caffe2 names): no check
    assert os.path.exists(model_zoo.cache_url(src.as_uri() + "#R-50.pkl",
                                              model_dir=str(tmp_path / "c3")))


def test_resolve_weight_path_passthrough_and_custom_catalog(tmp_path, monkeypatch):
    p = str(tmp_path / "local.pth")
    assert model_zoo.resolve_weight_path(p) == p
    src = tmp_path / "custom.pkl"
    src.write_bytes(b"custom")
    catalog_py = tmp_path / "my_catalog.py"
    catalog_py.write_text("class ModelCatalog:\n    @staticmethod\n    def get(name):\n"
                          f"        return {src.as_uri()!r}\n")

    class _Cfg:
        PATHS_CATALOG = str(catalog_py)

    monkeypatch.setenv("ONESHOT_MODEL_ZOO", str(tmp_path / "zoo"))
    assert model_zoo.default_cache_dir() == jax_zoo.default_cache_dir() == str(tmp_path / "zoo")
    resolved = model_zoo.resolve_weight_path("catalog://Anything/at-all", cfg=_Cfg())
    assert resolved == str(tmp_path / "zoo" / "custom.pkl")
    assert open(resolved, "rb").read() == b"custom"


# -- Caffe2 blobs ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def blobs_setup(tmp_path_factory):
    """Synthetic R-50 blobs for the flagship's body, JAX's conversion laid
    onto seeded weights, and the port's weights from the same seed."""
    setup = make_setup()
    _, pcfg = small_cfgs()
    model = build_detection_model(pcfg, device="cpu")
    body = {k[len("backbone.body."):]: tuple(v.shape) for k, v in model.state_dict().items()
            if k.startswith("backbone.body.")}
    path = str(tmp_path_factory.mktemp("c2") / "R-50.pkl")
    write_synthetic_c2_resnet(path, body, seed=3)
    blobs = jax_c2.load_c2_pickle(path)
    jbody, _, _ = jax_c2.convert_c2_resnet(blobs)
    want = state_dict_from_flax(jax_c2.attach_pretrained_backbone(setup["variables"], jbody))
    return dict(path=path, blobs=blobs, body=body, want=want, state_dict=setup["state_dict"],
                pcfg=pcfg)


def test_synthetic_blobs_are_detectron_style(blobs_setup):
    with open(blobs_setup["path"], "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    names = set(raw["blobs"])
    assert {"conv1_w", "res_conv1_bn_s", "res2_0_branch2a_w", "res2_0_branch1_bn_b",
            "res5_2_branch2c_bn_s", "fc1000_w", "conv1_w_momentum"} <= names
    assert set(c2_import.load_c2_pickle(blobs_setup["path"])) == set(blobs_setup["blobs"])


def test_c2_key_map_equals_jax(blobs_setup):
    body = {k: v for k, v in blobs_setup["want"].items() if k.startswith("backbone.body.")}
    for key in blobs_setup["blobs"]:
        port = c2_import.map_c2_resnet_key(key)
        ref = jax_c2.map_c2_resnet_key(key)
        assert (port is None) == (ref is None), key
        if port is not None:
            assert "backbone.body." + port in body, key


def test_convert_c2_resnet_equals_jax_in_both_backbones(blobs_setup):
    body, matched, unmatched = c2_import.convert_c2_resnet(blobs_setup["blobs"])
    _, jm, ju = jax_c2.convert_c2_resnet(blobs_setup["blobs"])
    assert sorted(matched) == sorted(jm) and sorted(unmatched) == sorted(ju) == ["fc1000_b",
                                                                                "fc1000_w"]
    assert set(body) == set(blobs_setup["body"])
    full = c2_import.backbone_state_dict(body)
    want = blobs_setup["want"]
    assert set(full) == {k for k in want if ".body." in k}
    for k, v in full.items():
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(v)), want[k]), k


def test_checkpointer_loads_catalog_blobs_into_both_backbones(blobs_setup, tmp_path,
                                                              monkeypatch):
    """catalog:// -> a custom PATHS_CATALOG's file:// URL -> the cache ->
    both bodies; everything else keeps its value."""
    catalog_py = tmp_path / "catalog.py"
    uri = "file://" + blobs_setup["path"]
    catalog_py.write_text("class ModelCatalog:\n    @staticmethod\n    def get(name):\n"
                          f"        assert name == 'ImageNetPretrained/MSRA/R-50'\n"
                          f"        return {uri!r}\n")
    _, pcfg = small_cfgs("PATHS_CATALOG", str(catalog_py))
    monkeypatch.setenv("ONESHOT_MODEL_ZOO", str(tmp_path / "zoo"))
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(blobs_setup["state_dict"], strict=True)
    start = Checkpointer(str(tmp_path / "out"), cfg=pcfg).load(
        model, f="catalog://ImageNetPretrained/MSRA/R-50", resume=True)
    assert start == 0 and os.listdir(tmp_path / "zoo") == ["R-50.pkl"]
    got = model.state_dict()
    for k, v in blobs_setup["want"].items():
        assert torch.equal(got[k], v), k
