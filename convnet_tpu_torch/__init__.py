"""convnet_tpu_torch: the PyTorch + CUDA port of convnet_tpu for NVIDIA Hopper.

It keeps the JAX package's module layout and names, imports ``torch`` and
numpy only (never ``jax`` or ``convnet_tpu``), and replaces each Pallas TPU
kernel on a ported path with a CUDA kernel written for ``sm_90a``
(``csrc/``). The first ported path is serving: :class:`serve.Predictor`.
"""
