"""Logging of the port's commands (counterpart of ``get_logger`` in
casmtr_tpu/utils/logging.py): process 0 logs at INFO, the other processes
of a data-parallel group (``parallel.mesh``) at ERROR only.  The
TensorBoard writer is not ported (it needs TensorFlow): the commands log to
the console alone."""

from __future__ import annotations

import logging
import sys

from casmtr_tpu_torch.parallel import comm

_configured = set()


def get_logger(name: str = "casmtr_tpu_torch") -> logging.Logger:
    """A logger to stderr, configured once per name: at INFO in process 0,
    at ERROR in the others."""
    lg = logging.getLogger(name)
    if name not in _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        lg.addHandler(handler)
        lg.setLevel(logging.INFO if comm.is_main_process() else logging.ERROR)
        _configured.add(name)
    return lg
