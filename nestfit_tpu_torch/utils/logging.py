"""Structured logging (port of ``nestfit_tpu/utils/logging.py``): stdlib
logging under one package-level logger, ``nestfit_tpu_torch``."""

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "nestfit_tpu_torch") -> logging.Logger:
    """The logger ``name``; the first call gives the package's root logger
    a stderr handler and level INFO."""
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        root = logging.getLogger("nestfit_tpu_torch")
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logger
