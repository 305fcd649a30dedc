"""NHWC convolution (counterpart of convnet_tpu/ops/conv.py:139-195).

The public layout is the JAX package's NHWC. Inside, the NHWC tensor is
viewed as an NCHW tensor in channels-last memory, which ``F.conv2d`` keeps,
so the view back to NHWC is free. The 1x1 stride-1 convs of the serving path
do not come here: ``ConvBN`` routes them to the fused kernel.
"""

from __future__ import annotations

import torch.nn.functional as F


def to_nchw(x):
    """NHWC tensor → NCHW view in channels-last memory (no copy)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW (channels-last) tensor → contiguous NHWC (no copy if it is)."""
    return x.permute(0, 2, 3, 1).contiguous()


def pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d(x, w, *, stride=1, padding=0, dilation=1, groups=1):
    """x: (B, H, W, Cin); w: OIHW (Cout, Cin/groups, kh, kw); ``padding`` an
    int or a per-axis pair (ph, pw), each padding both sides of its axis (an
    Inception (1, 7) kernel takes (0, 3)). The weight is cast to x's dtype;
    output in x's dtype."""
    y = F.conv2d(to_nchw(x), w.to(x.dtype), None, stride, pair(padding),
                 dilation, groups)
    return to_nhwc(y)
