"""CasMTR in PyTorch for NVIDIA Hopper: the port of the JAX package
``casmtr_tpu``, whose Pallas kernels become hand-written CUDA kernels
(``csrc/``).  Entry points run on the card unless the caller asks for the
CPU; see ``casmtr_tpu_torch.serving.Matcher``."""
