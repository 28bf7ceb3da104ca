"""Dual-sink logging: a DEBUG file with file:line and colored console INFO
(the port's own copy of lunaris_orion_tpu/utils/logging.py; the
reference's setup_logging, train_hybrid.py:51-95)."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        msg = super().format(record)
        return f"{color}{msg}{_RESET}" if sys.stderr.isatty() else msg


def setup_logging(output_dir: str, *, name: str = "lunaris",
                  filename: str = "training.log") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(Path(output_dir) / filename)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s"))
    logger.addHandler(fh)

    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(_ColorFormatter("%(asctime)s %(levelname)s %(message)s",
                                    datefmt="%H:%M:%S"))
    logger.addHandler(ch)
    logger.propagate = False
    return logger
