"""Dataset name -> files (counterpart of ``DatasetCatalog`` in
``oneshotdet_tpu/data/paths_catalog.py``).

Paths resolve under ``ONESHOT_DATA_DIR`` (default ``datasets``, read when a
name is looked up) with the reference's directory layout; the name
``custom`` takes its image directory and annotation file from
``ONESHOT_CUSTOM_IMG_DIR`` and ``ONESHOT_CUSTOM_ANN_FILE``.
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
