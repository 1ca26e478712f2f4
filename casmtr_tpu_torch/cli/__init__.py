"""Command-line entry points of the port (counterpart of casmtr_tpu/cli/):
``convert`` (a reference checkpoint into a port checkpoint directory),
``evaluate`` (a test split read from disk into pose AUC; ``run_eval``
also takes a caller's dataset), ``match_pair`` (one pair of image files),
``reconstruct`` (a directory of frames into poses and points) and
``train`` (one card, with the stage-aware ``resume_state``).  Run each
as ``python -m casmtr_tpu_torch.cli.<name>``."""
