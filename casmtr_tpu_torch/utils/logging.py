"""Logging of the port's commands (counterpart of ``get_logger`` in
casmtr_tpu/utils/logging.py).  The port runs one process on one card, which
is the main process, so every logger logs at INFO.  The TensorBoard writer
is not ported (it needs TensorFlow): the commands log to the console
alone."""

from __future__ import annotations

import logging
import sys

_configured = set()


def get_logger(name: str = "casmtr_tpu_torch") -> logging.Logger:
    """A logger to stderr at INFO, configured once per name."""
    lg = logging.getLogger(name)
    if name not in _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        _configured.add(name)
    return lg
