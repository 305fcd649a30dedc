"""Tensor functions on NHWC activations (counterpart of convnet_tpu/ops)."""

from convnet_tpu_torch.ops.activation import relu, relu6
from convnet_tpu_torch.ops.conv import conv2d
from convnet_tpu_torch.ops.linear import linear
from convnet_tpu_torch.ops.norm import (batch_norm_inference,
                                        batch_norm_train)
from convnet_tpu_torch.ops.pool import (avg_pool2d, global_avg_pool,
                                        max_pool2d)

__all__ = ["relu", "relu6", "conv2d", "linear", "batch_norm_inference",
           "batch_norm_train", "avg_pool2d", "global_avg_pool", "max_pool2d"]
