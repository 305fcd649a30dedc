"""Hand-written CUDA kernels: sources in ``convnet_tpu_torch/csrc``, built
with nvcc on first use (``_build``), each wrapper beside its plain PyTorch
version and a launch counter."""
