"""Dense layer op (counterpart of convnet_tpu/ops/linear.py).

The weight is (out, in), PyTorch's layout. The matmul runs in the
activations' dtype and the bias is added in float32, as in the JAX package.
"""

from __future__ import annotations

import torch.nn.functional as F


def linear(x, w, b=None):
    y = F.linear(x, w.to(x.dtype))
    if b is not None:
        y = (y.float() + b.float()).to(y.dtype)
    return y
