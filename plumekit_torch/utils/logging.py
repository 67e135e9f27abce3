"""Logging setup: the format string of ``plumekit/utils/logging.py``."""

from __future__ import annotations

import logging

_FMT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        logging.basicConfig(level=logging.INFO, format=_FMT)
        _CONFIGURED = True
    return logging.getLogger(name)
