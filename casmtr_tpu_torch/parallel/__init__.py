"""Cross-process work of the port (counterpart of casmtr_tpu/parallel/):
``mesh``, the data-parallel process group and the collectives of the
global-batch step; ``comm``, the object and metric gathers; ``dryrun``,
one data-parallel step of each graph family against the one-process step."""
