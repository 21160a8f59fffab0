"""Keypoint containers (counterpart of ``oneshotdet_tpu/structures/keypoint.py``).

Keypoints are (N, K, 3) float32 arrays of (x, y, visibility) in the
coordinates of an image of ``size`` (width, height). ``resize`` scales x and
y; ``transpose(FLIP_LEFT_RIGHT)`` mirrors x to ``w - x - 1``, swaps the
left/right keypoints (``FLIP_INDS``) and keeps invisible ones at x = 0.
"""

from __future__ import annotations

import numpy as np

FLIP_LEFT_RIGHT = 0


class Keypoints:
    FLIP_INDS: list = []   # a subclass gives its left/right swap

    def __init__(self, keypoints, size):
        kp = np.asarray(keypoints, np.float32)
        if kp.ndim == 2:
            kp = kp.reshape(kp.shape[0], -1, 3)
        self.keypoints = kp
        self.size = tuple(size)

    def resize(self, size) -> "Keypoints":
        rw = size[0] / self.size[0]
        rh = size[1] / self.size[1]
        kp = self.keypoints.copy()
        kp[..., 0] *= rw
        kp[..., 1] *= rh
        return type(self)(kp, size)

    def transpose(self, method: int) -> "Keypoints":
        if method != FLIP_LEFT_RIGHT:
            raise NotImplementedError("only FLIP_LEFT_RIGHT is supported")
        flip_inds = type(self).FLIP_INDS or list(range(self.keypoints.shape[1]))
        kp = self.keypoints[:, flip_inds].copy()
        kp[..., 0] = self.size[0] - kp[..., 0] - 1
        kp[..., 0] = np.where(kp[..., 2] == 0, 0.0, kp[..., 0])
        return type(self)(kp, self.size)

    def crop(self, box) -> "Keypoints":
        x1, y1 = float(box[0]), float(box[1])
        w = float(box[2]) - x1
        h = float(box[3]) - y1
        kp = self.keypoints.copy()
        kp[..., 0] = np.clip(kp[..., 0] - x1, 0, w)
        kp[..., 1] = np.clip(kp[..., 1] - y1, 0, h)
        return type(self)(kp, (w, h))

    def __len__(self):
        return len(self.keypoints)

    def __getitem__(self, idx) -> "Keypoints":
        if isinstance(idx, int):
            idx = [idx]
        return type(self)(self.keypoints[np.asarray(idx)], self.size)


PERSON_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)


def _person_flip_inds():
    out = []
    for name in PERSON_KEYPOINT_NAMES:
        for a, b in (("left_", "right_"), ("right_", "left_")):
            if name.startswith(a):
                name = b + name[len(a):]
                break
        out.append(PERSON_KEYPOINT_NAMES.index(name))
    return out


class PersonKeypoints(Keypoints):
    """The 17 COCO person keypoints."""

    NAMES = PERSON_KEYPOINT_NAMES
    FLIP_INDS = _person_flip_inds()
