"""Data in the port (counterpart of casmtr_tpu/data/): file decoding without
cv2, PIL or h5py (``codecs`` over the ``host`` library), image, depth and
pose reading (``io``), the MegaDepth and ScanNet datasets, the sampler,
split and batching ``loader``, and the multi-scene ``module``."""
