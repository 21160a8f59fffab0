"""Stream + file logger (counterpart of ``oneshotdet_tpu/utils/logger.py``)."""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(name: str, save_dir: str = "", filename: str = "log.txt"):
    """A logger writing to stdout and, with ``save_dir``, to
    ``save_dir/filename``; a logger already set up is returned as it is."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
