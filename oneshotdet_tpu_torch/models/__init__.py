from .detector import (
    DetectorConfig,
    GeneralizedRCNN,
    build_detection_model,
    detector_config_from_cfg,
)

__all__ = [
    "DetectorConfig",
    "GeneralizedRCNN",
    "build_detection_model",
    "detector_config_from_cfg",
]
