"""Logging helpers (counterpart of ``mxnet_tpu/log.py``):
``get_logger(name, filename, filemode, level)`` with the reference's
``%(asctime)s`` head format and a level-colored formatter on a tty."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]

_HEAD = "%(asctime)-15s %(message)s"


class _ColorFormatter(logging.Formatter):
    _COLORS = {logging.WARNING: "\x1b[0;33m", logging.ERROR: "\x1b[0;31m"}

    def format(self, record):
        msg = super().format(record)
        color = self._COLORS.get(record.levelno)
        return f"{color}{msg}\x1b[0m" if color else msg


def get_logger(name=None, filename=None, filemode=None,
               level=logging.WARNING) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_mxnet_tpu_torch_init", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(logging.Formatter(_HEAD))
    else:
        handler = logging.StreamHandler(sys.stderr)
        fmt = (_ColorFormatter(_HEAD)
               if getattr(sys.stderr, "isatty", lambda: False)()
               else logging.Formatter(_HEAD))
        handler.setFormatter(fmt)
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxnet_tpu_torch_init = True
    return logger
