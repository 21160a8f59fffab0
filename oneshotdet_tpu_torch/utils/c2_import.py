"""Caffe2/Detectron pickled ResNet weights (counterpart of
``oneshotdet_tpu/utils/c2_import.py``).

Reads the ImageNet blobs of files such as ``R-50.pkl`` (``conv1_w``,
``res_conv1_bn_s``, ``res2_0_branch2a_w``, ...) and names them as the port's
ResNet body does (``stem.conv1.weight``, ``layer1.0.bn1.weight``, ...).
Convolution weights stay OIHW. Caffe2's AffineChannel layers carry BN folded
into scale and bias, so every BN that gets them has running mean 0 and
variance 1.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

BODY_NETS = ("backbone", "supp_backbone")      # the Siamese query and support bodies

_CONV = {"2a": "conv1", "2b": "conv2", "2c": "conv3", "1": "downsample.0"}
_BN = {"2a": "bn1", "2b": "bn2", "2c": "bn3", "1": "downsample.1"}


def load_c2_pickle(path: str) -> Dict[str, np.ndarray]:
    """Blob name -> array, without the ``*_momentum`` blobs."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    return {k: np.asarray(v) for k, v in data.items() if not k.endswith("_momentum")}


def map_c2_resnet_key(key: str) -> Optional[str]:
    """A blob name -> its name in the port's ResNet body, or None (fc1000
    and other blobs with no counterpart)."""
    if key == "conv1_w":
        return "stem.conv1.weight"
    m = re.match(r"^(?:res_)?conv1_bn_(s|b)$", key)
    if m:
        return f"stem.bn1.{'weight' if m.group(1) == 's' else 'bias'}"
    m = re.match(r"^res(\d)_(\d+)_branch(1|2a|2b|2c)(?:_bn)?_(w|s|b)$", key)
    if m:
        stage, block, branch, leaf = m.groups()
        layer = f"layer{int(stage) - 1}.{block}"
        if leaf == "w" and "_bn_" not in key:
            return f"{layer}.{_CONV[branch]}.weight"
        if leaf in "sb":
            return f"{layer}.{_BN[branch]}.{'weight' if leaf == 's' else 'bias'}"
    return None


def convert_c2_resnet(blobs: Dict[str, np.ndarray]
                      ) -> Tuple[Dict[str, np.ndarray], List[str], List[str]]:
    """(body state dict, matched blob names, unmatched blob names); each BN
    given a scale and bias gets running mean 0 and variance 1."""
    body, matched, unmatched = {}, [], []
    for key, value in blobs.items():
        name = map_c2_resnet_key(key)
        if name is None:
            unmatched.append(key)
            continue
        body[name] = np.asarray(value)
        matched.append(key)
    for name in [n for n in body if re.search(r"(bn\d|downsample\.1)\.weight$", n)]:
        prefix, n = name[:-len("weight")], body[name].shape[0]
        body.setdefault(prefix + "running_mean", np.zeros(n, np.float32))
        body.setdefault(prefix + "running_var", np.ones(n, np.float32))
    return body, matched, unmatched


def backbone_state_dict(body: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A body state dict under each Siamese backbone (``<net>.body.<name>``),
    to overlay onto the model (``Checkpointer``'s ``.pkl`` branch)."""
    return {f"{net}.body.{k}": v for net in BODY_NETS for k, v in body.items()}
