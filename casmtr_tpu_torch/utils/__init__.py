"""Utilities of the port (counterpart of casmtr_tpu/utils/): for now the
loading of reference checkpoints, ``convert``."""
