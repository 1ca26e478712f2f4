"""Cross-process communication of the port (counterpart of
casmtr_tpu/parallel/): for now ``comm``, the object and metric gathers.
The device mesh (``mesh``) waits for the multi-GPU layer (ROADMAP queue A
item 6)."""
