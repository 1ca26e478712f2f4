"""Command-line entry points of the port (counterpart of casmtr_tpu/cli/):
``convert`` (a reference checkpoint into a port checkpoint directory) and,
in ``train``, the stage-aware ``resume_state`` that the training command
will call."""
