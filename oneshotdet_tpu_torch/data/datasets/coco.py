"""Episodic one-shot COCO dataset (counterpart of
``oneshotdet_tpu/data/datasets/coco.py``).

One entry per (query image, class) episode, shuffled with seed 6666; the
train/test class split by ``TRAINING_EXCL_CATS`` / ``TEST_EXCL_CATS``; the
``TASK=1`` split file; ``TEST_SELECTED_CLS``; support selection at random
(the largest annotation above ``SUPP_AREA_THRESHOLD`` of a shuffled
catalog, cropped to its box), from the ``CHOOSE_SELECTED`` directory, or by
the ``CHOOSE_CLOSE`` similarity pickle in training; boxes clipped to the
image with empty ones removed.

Differences from the JAX dataset:
  - every random draw of an episode comes from the dataset's own
    ``random.Random`` (seeded 6666 and used for the episodic shuffle, the
    stream the JAX dataset copies into the global one), in the JAX order:
    the support pick, then the query transform, then each support's. The
    JAX dataset draws from the global stream inside ``__getitem__``, so with
    loader threads or processes its picks depend on their order; the port's
    loader draws every episode in its main thread, in index order
    (``plan``), and decodes in its threads (``load``), so its episodes equal
    the JAX loader's at ``DATALOADER.NUM_WORKERS=0`` whatever its own
    worker count;
  - with ``FEW_SHOT.SUPP_AUG`` and ``NUM_SUPP_AUG`` 2, the jitter's four
    factors per support (Color, Brightness, Contrast, Sharpness) are drawn
    from that stream too, right after the support pick and before the query
    transform's draw: the JAX dataset draws them from the global
    ``np.random`` inside ``__getitem__``. The factors travel in the
    ``Episode``, so ``load`` draws nothing;
  - images are read by ``image_io.read_image_rgb`` (numpy for binary PPM,
    PIL for anything else) and cropped by ``image_io.crop`` (PIL's rounding
    and zero fill), the support mask of ``FEW_SHOT.MASK_SUPP`` is filled by
    ``structures.segmentation_mask`` and the jitter is
    ``transforms.color_jitter`` (both numpy, PIL's bytes), so no PIL is
    needed for a PPM dataset;
  - ``FEW_SHOT.SUPP_AUG`` with ``NUM_SUPP_AUG`` other than 1 or 2 raises
    ``ValueError``: the augmentation makes at most two variants of a support
    (the flip and the jitter), so any other count disagrees with the
    ``1 + NUM_SUPP_AUG`` images per shot the model merges;
  - ``MASK_ON`` and ``KEYPOINT_ON`` raise ``NotImplementedError``.

Support augmentation (``FEW_SHOT.SUPP_AUG``): each picked support becomes
[original, horizontally flipped, colour-jittered] (the jitter only with
``NUM_SUPP_AUG`` 2), consecutive per shot, each variant with its own
transform draw, in every picker, in eval as in training.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import random
from typing import List, Optional, Tuple

import numpy as np

from ...structures.segmentation_mask import PolygonInstance
from ..coco_api import LiteCOCO
from ..image_io import crop, read_image_rgb
from ..transforms import color_jitter, draw_jitter


def _has_valid_annotation(anno) -> bool:
    """An image counts if it has an annotation with both sides above 1."""
    if len(anno) == 0:
        return False
    if all(any(o <= 1 for o in obj["bbox"][2:]) for obj in anno):
        return False
    return True


def _not_ported(cfg) -> List[str]:
    checks = {
        "MODEL.MASK_ON": cfg.MODEL.MASK_ON,
        "MODEL.KEYPOINT_ON": cfg.MODEL.KEYPOINT_ON,
    }
    return [name for name, on in checks.items() if on]


@dataclasses.dataclass
class Episode:
    """An episode's random draws, made in index order: what ``load`` needs
    to build the item without drawing.

    supports: per support, ("ann", image id, annotation) for a crop of a
      dataset image, or ("file", path) for a selected support file.
    query_draw / supp_draws: the transforms' draws (``FusedPreprocess.draw``),
      one per support image after the augmentation.
    jitters: per support, the colour jitter's four factors (SUPP_AUG with
      NUM_SUPP_AUG 2), else empty.
    """

    idx: int
    img_id: int
    cat: int
    supports: List[tuple]
    query_draw: Optional[tuple]
    supp_draws: List[Optional[tuple]]
    jitters: List[tuple]


class COCODataset:
    def __init__(self, cfg, ann_file: str, root: str, is_train: bool, transforms=None,
                 remove_images_without_annotations: bool = True):
        missing = _not_ported(cfg)
        if missing:
            raise NotImplementedError(
                "not ported to oneshotdet_tpu_torch yet: " + ", ".join(missing))
        self.rng = random.Random(6666)
        self.cfg = cfg
        self.root = root
        self.coco = LiteCOCO(ann_file)
        self.is_train = is_train
        self.shot = cfg.FEW_SHOT.NUM_SHOT
        self.choose_close = cfg.FEW_SHOT.CHOOSE_CLOSE
        self.choose_selected = cfg.FEW_SHOT.CHOOSE_SELECTED
        self.selected_cls = cfg.FEW_SHOT.TEST_SELECTED_CLS
        self.selected_order = cfg.FEW_SHOT.TEST_SELECTED_SUPP
        self.mask_supp = cfg.FEW_SHOT.MASK_SUPP
        self.supp_aug = cfg.FEW_SHOT.SUPP_AUG
        # the variants after each support's original: the flip, then the jitter
        self.num_aug = cfg.FEW_SHOT.NUM_SUPP_AUG if self.supp_aug else 0
        if self.supp_aug and self.num_aug not in (1, 2):
            raise ValueError(
                f"FEW_SHOT.NUM_SUPP_AUG={self.num_aug}: the support augmentation makes 1 + 1 "
                "(the flip) or 1 + 2 (and the colour jitter) images per shot, so the model's "
                f"1 + {self.num_aug} per shot cannot be met")
        self.actual_num_imgs = self.shot * (1 + self.num_aug)

        if isinstance(transforms, (list, tuple)):
            self._transforms, self._supp_transforms = transforms[0], transforms[1]
        else:
            self._transforms = self._supp_transforms = transforms

        # contiguous 1..K <-> json category ids
        cat_ids = self.coco.getCatIds()
        self.all_json_category_id_to_contiguous_id = {v: i + 1 for i, v in enumerate(cat_ids)}
        self.all_contiguous_category_id_to_json_id = {
            v: k for k, v in self.all_json_category_id_to_contiguous_id.items()
        }
        excl_cont = (
            cfg.FEW_SHOT.TRAINING_EXCL_CATS if is_train else cfg.FEW_SHOT.TEST_EXCL_CATS
        )
        excl_json = {
            self.all_contiguous_category_id_to_json_id[c]
            for c in excl_cont
            if c in self.all_contiguous_category_id_to_json_id
        }
        self.json_cat_list = [c for c in cat_ids if c not in excl_json]
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(self.json_cat_list)
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }

        # TASK=1: eval images restricted to the task-1 split file
        task1_imgs = None
        if cfg.FEW_SHOT.TASK == 1 and not is_train:
            split_file = os.environ.get("ONESHOT_TASK1_SPLIT", "task1_test_split.txt")
            with open(split_file) as f:
                task1_imgs = {line.split(" ")[0].strip() for line in f if line.strip()}

        # per-category catalog of images
        self.catalog = {}
        for cat in self.json_cat_list:
            self.catalog[cat] = []
            img_ids = sorted(self.coco.getImgIds(catIds=cat))
            if task1_imgs is not None:
                img_ids = [i for i in img_ids
                           if self.coco.loadImgs(i)[0]["file_name"] in task1_imgs]
            for img_id in img_ids:
                anno = self.coco.loadAnns(
                    self.coco.getAnnIds(imgIds=img_id, catIds=cat, iscrowd=False))
                if not remove_images_without_annotations or _has_valid_annotation(anno):
                    self.catalog[cat].append(img_id)

        # episodic (image, class) pairs, shuffled
        self.ids: List[int] = []
        self.chosen_cats: List[int] = []
        for cat, ids in self.catalog.items():
            if self.selected_cls != -1 and cat != self.selected_cls:
                continue
            self.ids.extend(ids)
            self.chosen_cats.extend([cat] * len(ids))
        index_arr = list(range(len(self.ids)))
        self.rng.shuffle(index_arr)
        self.ids = [self.ids[i] for i in index_arr]
        self.chosen_cats = [self.chosen_cats[i] for i in index_arr]
        self.id_to_img_map = dict(enumerate(self.ids))

        # similarity pickle for CHOOSE_CLOSE, in training (the repo's own
        # fewshot_utils write it)
        self.close_dict = None
        if self.choose_close and is_train:
            pkl = os.environ.get("ONESHOT_SUPP_SIM_PKL", cfg.FEW_SHOT.SUPP_SIM_FILE)
            if os.path.exists(pkl):
                with open(pkl, "rb") as f:
                    self.close_dict = pickle.load(f)

    def __len__(self):
        return len(self.ids)

    # -- support selection (draws only; no pixels) ---------------------------
    def _anns(self, img_id: int, cat_id: int):
        return self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id, catIds=cat_id,
                                                      iscrowd=False))

    def random_supports(self, cat_id: int, exclude_img_id: int, shot: int = 1):
        """The largest annotation above SUPP_AREA_THRESHOLD of each image of a
        shuffled catalog, skipping the query image, until ``shot`` are
        found; fallbacks: the best available, then the query itself."""
        choices = self.catalog[cat_id].copy()
        self.rng.shuffle(choices)
        picked = []
        for img_id in choices:
            if img_id == exclude_img_id:
                continue
            anns = self._anns(img_id, cat_id)
            if not anns:
                continue
            chosen = max(anns, key=lambda a: a["area"])
            if chosen["area"] > self.cfg.INPUT.SUPP_AREA_THRESHOLD:
                picked.append(("ann", img_id, chosen))
            if len(picked) == shot:
                break
        if not picked:
            for img_id in choices:
                if img_id == exclude_img_id:
                    continue
                anns = self._anns(img_id, cat_id)
                if anns:
                    picked.append(("ann", img_id, max(anns, key=lambda a: a["area"])))
                    break
            if not picked:
                anns = self._anns(exclude_img_id, cat_id)
                picked.append(("ann", exclude_img_id, max(anns, key=lambda a: a["area"])))
        while len(picked) < shot:
            picked.append(picked[-1])
        return picked

    def selected_supports(self, cat_id: int, shot: int = 1):
        """The fixed support file <dir>/<contiguous class>_<order>.jpg
        (``ONESHOT_SELECTED_SUPP_DIR``, default ``supps_test_selected``),
        else a random pick."""
        d = os.environ.get("ONESHOT_SELECTED_SUPP_DIR", "supps_test_selected")
        cont = self.json_category_id_to_contiguous_id[cat_id]
        path = os.path.join(d, f"{cont}_{self.selected_order}.jpg")
        if os.path.exists(path):
            return [("file", path)]
        return self.random_supports(cat_id, exclude_img_id=-1, shot=shot)

    def close_supports(self, query_img_id: int, cat_id: int, shot: int = 1):
        """The supports most similar to the query by the CHOOSE_CLOSE pickle
        (training only), else a random pick."""
        if not self.is_train or self.close_dict is None:
            return self.random_supports(cat_id, query_img_id, shot=shot)
        try:
            ann_dict = self.close_dict[cat_id][query_img_id][cat_id]
        except (KeyError, TypeError):
            return self.random_supports(cat_id, query_img_id, shot=shot)
        ranked = sorted(ann_dict.items(), key=lambda kv: kv[1], reverse=True)
        picked = []
        for ann_id, _ in ranked[:shot]:
            ann = self.coco.anns.get(ann_id)
            if ann is not None:
                picked.append(("ann", ann["image_id"], ann))
        return picked or self.random_supports(cat_id, query_img_id, shot=shot)

    # -- episodic fetch ------------------------------------------------------
    def plan(self, idx: int) -> Episode:
        """Make episode ``idx``'s random draws, in the JAX dataset's order.
        Call in index order from one thread: each call advances the
        dataset's stream."""
        img_id = self.ids[idx]
        cat = self.chosen_cats[idx]
        if self.choose_close:
            supports = self.close_supports(img_id, cat, shot=self.shot)
        elif self.choose_selected:
            supports = self.selected_supports(cat, shot=self.shot)
        else:
            supports = self.random_supports(cat, img_id, shot=self.shot)
        jitters = [draw_jitter(self.rng) for _ in supports] if self.num_aug > 1 else []
        n_supp = len(supports) * (1 + self.num_aug)
        query_draw, supp_draws = None, [None] * n_supp
        if self._transforms is not None:
            query_draw = self._transforms.draw(self.rng)
            supp_draws = [self._supp_transforms.draw(self.rng) for _ in range(n_supp)]
        return Episode(idx, img_id, cat, supports, query_draw, supp_draws, jitters)

    def _image(self, img_id: int) -> np.ndarray:
        path = self.coco.loadImgs(img_id)[0]["file_name"]
        return read_image_rgb(os.path.join(self.root, path))

    def _support_pixels(self, support: tuple) -> np.ndarray:
        if support[0] == "file":
            return read_image_rgb(support[1])
        _, img_id, ann = support
        x, y, w, h = ann["bbox"]
        return crop(self._masked(self._image(img_id), ann), (x, y, x + w, y + h))

    def _masked(self, img: np.ndarray, ann: dict) -> np.ndarray:
        """FEW_SHOT.MASK_SUPP: the image times its annotation's polygon mask
        (before the crop); an RLE or missing segmentation leaves it as is."""
        seg = ann.get("segmentation")
        if not self.mask_supp or not isinstance(seg, list) or not seg:
            return img
        mask = PolygonInstance(seg, (img.shape[1], img.shape[0])).rasterize()
        return img * (mask[:, :, None] > 0)

    def _augmented(self, supports: List[np.ndarray], jitters) -> List[np.ndarray]:
        """SUPP_AUG: each support followed by its flip (and its jitter)."""
        if not self.supp_aug:
            return supports
        out = []
        for k, im in enumerate(supports):
            out += [im, im[:, ::-1]] + ([color_jitter(im, jitters[k])] if jitters else [])
        return out

    def load(self, ep: Episode) -> dict:
        """The item of a planned episode: decode, crop, transform. Draws
        nothing, so threads may run it in any order."""
        img = self._image(ep.img_id)
        anno = self.coco.loadAnns(self.coco.getAnnIds(imgIds=ep.img_id, iscrowd=False))
        anno = [o for o in anno if o.get("iscrowd", 0) == 0 and o["category_id"] == ep.cat]
        boxes_xywh = np.array([o["bbox"] for o in anno], np.float32).reshape(-1, 4)
        # xywh -> xyxy with the TO_REMOVE convention
        boxes = boxes_xywh.copy()
        boxes[:, 2] = boxes_xywh[:, 0] + np.maximum(boxes_xywh[:, 2] - 1, 0)
        boxes[:, 3] = boxes_xywh[:, 1] + np.maximum(boxes_xywh[:, 3] - 1, 0)
        labels = np.ones(len(anno), np.int64)
        # clip to the image, drop empty boxes
        h, w = img.shape[:2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, labels = boxes[keep], labels[keep]

        img_supp = self._augmented([self._support_pixels(s) for s in ep.supports],
                                   ep.jitters)
        if self._transforms is not None:
            img, boxes = self._transforms.apply(img, boxes, ep.query_draw)
            img_supp = [self._supp_transforms.apply(s, None, d)[0]
                        for s, d in zip(img_supp, ep.supp_draws)]
        return {
            "img": img,
            "img_supp": img_supp,
            "boxes": boxes,
            "labels": labels,
            "idx": ep.idx,
            "target_id": ep.cat,
            "img_id": ep.img_id,
        }

    def __getitem__(self, idx: int) -> dict:
        return self.load(self.plan(idx))

    def get_img_info(self, index) -> Tuple[dict, int]:
        img_id = self.id_to_img_map[index]
        return self.coco.imgs[img_id], self.chosen_cats[index]
