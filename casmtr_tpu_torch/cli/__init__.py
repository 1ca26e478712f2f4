"""Command-line entry points of the port (counterpart of casmtr_tpu/cli/):
``convert`` (a reference checkpoint into a port checkpoint directory);
in ``train``, the stage-aware ``resume_state`` that the training command
will call; in ``evaluate``, ``run_eval`` (a dataset of pairs into pose
AUC), whose command waits for the data layer."""
