"""Logging for the PyTorch port: a copy of ``parallax_tpu/utils/logging.py``.

Colored level prefixes, module-scoped loggers under ``parallax_tpu_torch``,
and a ``PARALLAX_TPU_LOG_LEVEL`` environment override (shared with the JAX
package so one knob serves both).
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"
_ROOT = "parallax_tpu_torch"


class _Formatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "") if sys.stderr.isatty() else ""
        reset = _RESET if color else ""
        record.levelprefix = f"{color}{record.levelname:<8}{reset}"
        return super().format(record)


_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        _Formatter("%(asctime)s %(levelprefix)s %(name)s: %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(os.environ.get("PARALLAX_TPU_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def set_log_level(level: str) -> None:
    _configure_root()
    logging.getLogger(_ROOT).setLevel(level.upper())
