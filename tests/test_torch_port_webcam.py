"""The webcam / video tool ``oneshotdet_tpu_torch.tools.webcam`` (the port's
``demo/webcam.py``) on the CPU: a 3-frame MJPG video written by
``cv2.VideoWriter`` through the tool, with ``cv2.imshow``, ``waitKey`` and
``destroyAllWindows`` replaced in-process, the flagship at test capacities
with 64 FPN channels and ``--ckpt`` weights of a seed; each frame's boxes
and scores equal ``OneShotPredictor.run_on_image`` on the same decoded
frames, and every frame is shown with its boxes drawn.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oneshotdet_tpu_torch.config import cfg as default_cfg
from oneshotdet_tpu_torch.data.image_io import read_image_rgb, write_ppm
from oneshotdet_tpu_torch.predictor import OneShotPredictor
from oneshotdet_tpu_torch.tools import webcam
from test_torch_port_predictor import PRED_OVERRIDES
from torch_port_common import FLAGSHIP, SMALL, one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = [str(v) for v in SMALL + list(PRED_OVERRIDES) + ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS",
                                                        64]]
FRAMES, FRAME_HW = 3, (96, 128)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A support crop (PPM), a 3-frame MJPG video and a .pth of seed-4
    weights."""
    root = tmp_path_factory.mktemp("webcam")
    rng = np.random.RandomState(3)
    write_ppm(str(root / "support.ppm"), rng.randint(0, 256, (40, 36, 3), dtype=np.uint8))
    h, w = FRAME_HW
    writer = cv2.VideoWriter(str(root / "video.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (w, h))
    assert writer.isOpened()
    for i in range(FRAMES):
        frame = np.full((h, w, 3), 40 * i, np.uint8)
        frame[10 + 8 * i:60 + 8 * i, 20:90] = rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)
        writer.write(frame)
    writer.release()
    c = cfg()
    from oneshotdet_tpu_torch.models import build_detection_model

    model = build_detection_model(c, device="cpu", generator=torch.Generator().manual_seed(4))
    torch.save({"model": model.state_dict()}, str(root / "weights.pth"))
    return root, model.state_dict()


def cfg():
    c = default_cfg.clone()
    c.merge_from_file(FLAGSHIP)
    c.merge_from_list(OPTS)
    return c


def test_tool_shows_each_frame_with_the_predictors_boxes(media, monkeypatch):
    root, state_dict = media
    shown, waits, results = [], [], []
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append((name, img.copy())))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: waits.append(ms) or -1)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    real = webcam.stream
    monkeypatch.setattr(webcam, "stream", lambda *a: results.extend(real(*a)) or results)
    argv = ["--config-file", FLAGSHIP, "--support", str(root / "support.ppm"), "--source",
            str(root / "video.avi"), "--threshold", "0.0", "--ckpt", str(root / "weights.pth"),
            "--device", "cpu", *OPTS]
    assert webcam.main(argv) == 0
    assert len(results) == len(shown) == len(waits) == FRAMES
    assert {name for name, _ in shown} == {webcam.WINDOW} and waits == [1] * FRAMES

    pred = OneShotPredictor(cfg(), state_dict, confidence_threshold=0.0, device="cpu")
    pred.set_support(read_image_rgb(str(root / "support.ppm")))
    cap = cv2.VideoCapture(str(root / "video.avi"))
    detected = 0
    for (boxes, scores, ms), (_, img) in zip(results, shown):
        ok, frame = cap.read()
        assert ok and ms > 0
        want_boxes, want_scores = pred.run_on_image(np.ascontiguousarray(frame[:, :, ::-1]))
        np.testing.assert_array_equal(boxes, want_boxes)
        np.testing.assert_array_equal(scores, want_scores)
        detected += len(scores)
        # the drawing: the annotated frame differs from the decoded one
        # exactly where the boxes, scores and ms were drawn
        drawn = frame.copy()
        webcam.draw(cv2, drawn, boxes, scores, ms)
        np.testing.assert_array_equal(img, drawn)
        assert not np.array_equal(img, frame)
    assert not cap.read()[0]
    assert detected > 0


def test_spatial_devices_above_one_raise():
    with pytest.raises(NotImplementedError, match="one card"):
        webcam.main(["--support", "x.ppm", "--spatial-devices", "2"])
