"""Data in the port (counterpart of casmtr_tpu/data/): for now the numpy
batching ``loader``; image decoding and the datasets are not ported yet."""
