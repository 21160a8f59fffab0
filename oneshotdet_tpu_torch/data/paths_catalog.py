"""Dataset and model names -> files and URLs (counterpart of
``oneshotdet_tpu/data/paths_catalog.py``).

``DatasetCatalog``: paths resolve under ``ONESHOT_DATA_DIR`` (default
``datasets``, read when a name is looked up) with the reference's directory
layout; the name ``custom`` takes its image directory and annotation file
from ``ONESHOT_CUSTOM_IMG_DIR`` and ``ONESHOT_CUSTOM_ANN_FILE``.
``ModelCatalog``: ``catalog://`` weight names -> download URLs (the
ImageNet-pretrained Caffe2 backbones and the Detectron 12_2017 COCO
baselines); ``utils.model_zoo`` resolves and caches them.
"""

from __future__ import annotations

import os


class DatasetCatalog:
    DATASETS = {
        "coco_2017_train": {
            "img_dir": "coco/train2017",
            "ann_file": "coco/annotations/instances_train2017.json",
        },
        "coco_2017_val": {
            "img_dir": "coco/val2017",
            "ann_file": "coco/annotations/instances_val2017.json",
        },
        "coco_2014_train": {
            "img_dir": "coco/train2014",
            "ann_file": "coco/annotations/instances_train2014.json",
        },
        "coco_2014_val": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_val2014.json",
        },
        "voc_2007_test_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_test2007.json",
        },
        "voc_2012_val_cocostyle": {
            "img_dir": "voc/VOC2012/JPEGImages",
            "ann_file": "voc/VOC2012/Annotations/pascal_val2012.json",
        },
    }

    @classmethod
    def get(cls, name: str) -> dict:
        """{"factory": "COCODataset", "args": {"root": ..., "ann_file": ...}}."""
        if name == "custom":
            return {
                "factory": "COCODataset",
                "args": {
                    "root": os.environ["ONESHOT_CUSTOM_IMG_DIR"],
                    "ann_file": os.environ["ONESHOT_CUSTOM_ANN_FILE"],
                },
            }
        if name not in cls.DATASETS:
            raise KeyError(f"unknown dataset {name}")
        data_dir = os.environ.get("ONESHOT_DATA_DIR", "datasets")
        attrs = cls.DATASETS[name]
        return {
            "factory": "COCODataset",
            "args": {
                "root": os.path.join(data_dir, attrs["img_dir"]),
                "ann_file": os.path.join(data_dir, attrs["ann_file"]),
            },
        }


class ModelCatalog:
    """catalog:// name -> URL. The Detectron baselines' checkpoints are all
    called model_final.pkl; ``model_zoo.cache_url`` names them by path."""

    S3_C2_DETECTRON_URL = "https://dl.fbaipublicfiles.com/detectron"
    C2_IMAGENET_MODELS = {
        "MSRA/R-50": "ImageNetPretrained/MSRA/R-50.pkl",
        "MSRA/R-50-GN": "ImageNetPretrained/47261647/R-50-GN.pkl",
        "MSRA/R-101": "ImageNetPretrained/MSRA/R-101.pkl",
        "MSRA/R-101-GN": "ImageNetPretrained/47592356/R-101-GN.pkl",
        "FAIR/20171220/X-101-32x8d": "ImageNetPretrained/20171220/X-101-32x8d.pkl",
        "FAIR/20171220/X-101-64x4d": "ImageNetPretrained/20171220/X-101-64x4d.pkl",
    }

    C2_DETECTRON_SUFFIX = (
        "output/train/{}coco_2014_train%3A{}coco_2014_valminusminival/"
        "generalized_rcnn/model_final.pkl"
    )
    C2_DETECTRON_MODELS = {
        "35857197/e2e_faster_rcnn_R-50-C4_1x": "01_33_49.iAX0mXvW",
        "35857345/e2e_faster_rcnn_R-50-FPN_1x": "01_36_30.cUF7QR7I",
        "35857890/e2e_faster_rcnn_R-101-FPN_1x": "01_38_50.sNxI7sX7",
        "36761737/e2e_faster_rcnn_X-101-32x8d-FPN_1x": "06_31_39.5MIHi1fZ",
        "35858791/e2e_mask_rcnn_R-50-C4_1x": "01_45_57.ZgkA7hPB",
        "35858933/e2e_mask_rcnn_R-50-FPN_1x": "01_48_14.DzEQe4wC",
        "35861795/e2e_mask_rcnn_R-101-FPN_1x": "02_31_37.KqyEK4tT",
        "36761843/e2e_mask_rcnn_X-101-32x8d-FPN_1x": "06_35_59.RZotkLKI",
        "37129812/e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x": "09_35_36.8pzTQKYK",
        "37697547/e2e_keypoint_rcnn_R-50-FPN_1x": "08_42_54.kdzV35ao",
    }

    @staticmethod
    def get(name: str) -> str:
        if name.startswith("Caffe2Detectron/COCO"):
            return ModelCatalog.get_c2_detectron_12_2017_baselines(name)
        if name.startswith("ImageNetPretrained"):
            return ModelCatalog.get_c2_imagenet_pretrained(name)
        raise RuntimeError(f"model not present in the catalog {name}")

    @staticmethod
    def get_c2_imagenet_pretrained(name: str) -> str:
        name = name[len("ImageNetPretrained/"):]
        return "/".join([ModelCatalog.S3_C2_DETECTRON_URL, ModelCatalog.C2_IMAGENET_MODELS[name]])

    @staticmethod
    def get_c2_detectron_12_2017_baselines(name: str) -> str:
        """prefix/<model_id>/12_2017_baselines/<model_name>.yaml.<signature>/<suffix>;
        keypoint models train on the keypoints_ datasets."""
        dataset_tag = "keypoints_" if "keypoint" in name else ""
        suffix = ModelCatalog.C2_DETECTRON_SUFFIX.format(dataset_tag, dataset_tag)
        name = name[len("Caffe2Detectron/COCO/"):]
        model_id, model_name = name.split("/")
        signature = ModelCatalog.C2_DETECTRON_MODELS[name]
        unique_name = ".".join([f"{model_name}.yaml", signature])
        return "/".join([ModelCatalog.S3_C2_DETECTRON_URL, model_id, "12_2017_baselines",
                         unique_name, suffix])
