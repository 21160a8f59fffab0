"""Minimal COCO annotation API (counterpart of ``oneshotdet_tpu/data/coco_api.py``).

The query surface the episodic dataset and the evaluator use: category,
image and annotation lookup and indexing by (image, category), over a
standard COCO instances JSON.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence


class LiteCOCO:
    def __init__(self, annotation_file: str):
        with open(annotation_file, "r") as f:
            dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {img["id"]: img for img in dataset.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in dataset.get("categories", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in dataset.get("annotations", [])}

        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_img_ids: Dict[int, set] = defaultdict(set)
        for a in dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
            self.cat_to_img_ids[a["category_id"]].add(a["image_id"])

    # -- pycocotools-compatible surface -----------------------------------
    def getCatIds(self) -> List[int]:
        return sorted(self.cats.keys())

    def getImgIds(self, catIds=None) -> List[int]:
        if not catIds:
            return sorted(self.imgs.keys())
        if isinstance(catIds, int):
            catIds = [catIds]
        ids = set(self.cat_to_img_ids[catIds[0]])
        for c in catIds[1:]:
            ids &= self.cat_to_img_ids[c]
        return sorted(ids)

    def getAnnIds(self, imgIds=None, catIds=None, iscrowd=None) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        if isinstance(catIds, int):
            catIds = [catIds]
        if imgIds is not None:
            anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if catIds is not None:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
        return [a["id"] for a in anns]

    def loadAnns(self, ids: Sequence[int]) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.cats[i] for i in ids]
