"""oneshotdet_tpu_torch: the one-shot detector of ``oneshotdet_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

    from oneshotdet_tpu_torch.config import cfg
    from oneshotdet_tpu_torch.models import build_detection_model
    from oneshotdet_tpu_torch.predictor import OneShotPredictor

Entry points run on "cuda" unless given ``device="cpu"``. On the card every
ROIAlign goes through ``csrc/roi_align.cu`` and, in training, its gradient
through ``csrc/roi_align_bwd.cu``; CPU tensors take the plain PyTorch
versions. The eval path and the one-shot train step
(``GeneralizedRCNN.forward_train``, ``solver``, ``engine.train_step``) are
ported.
"""

from . import config, models, predictor  # noqa: F401

__version__ = "0.1.0"
