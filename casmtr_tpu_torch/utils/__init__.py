"""Utilities of the port (counterpart of casmtr_tpu/utils/): the loading
of reference checkpoints (``convert``), the evaluation metrics
(``metrics``), region timers (``profiler``) and the commands' logger
(``logging``)."""
