"""Structure from motion in the port (counterpart of casmtr_tpu/sfm/): for
now the batched relative-pose solver of the evaluation, ``pose``."""
