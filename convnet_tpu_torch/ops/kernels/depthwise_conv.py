"""Depthwise k x k convolution on NHWC: MobileNet's 3x3.

Counterpart of ``convnet_tpu/ops/pallas/depthwise.py``
(``depthwise_conv_pallas``, ``_build_fwd.body``): y[b, i, j, c] = Σ over
(di, dj) of xpad[b, i s + di, j s + dj, c] · w[c, 0, di, dj], the taps added
di outer and dj inner in float32, y in x's type. The weight is the port's
OIHW depthwise weight (C, 1, kh, kw).

On a CUDA tensor :func:`depthwise_conv2d` launches the kernel of
``csrc/depthwise_conv.cu`` or raises; on a CPU tensor it runs
:func:`depthwise_conv2d_plain`, which is also the kernel's oracle in the
on-card checks. ``launches`` counts kernel launches only, forward and dx
alike.

The op is differentiable with the reference's backward (``depthwise.py``
:123-148): at stride 1 dx is the same kernel on dy with the spatially
flipped weight and padding k - 1 - p (a crop of dy where p > k - 1); at
stride 2 dx is the library's transposed conv, which XLA computes in the
reference; dw is the reference's per-tap Σ over (b, i, j) of x · dy in
float32, in plain torch ops.
"""

from __future__ import annotations

import functools
import types

import torch

from convnet_tpu_torch.ops.kernels import _build, _conv

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def supported(stride):
    """The reference's rule (``depthwise.py:162``): stride <= 2."""
    sh, sw = _conv.pair(stride)
    return sh <= 2 and sw <= 2


def _check(x, w):
    c = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:2]) != (c, 1):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: need a "
                         f"depthwise OIHW weight (C, 1, kh, kw)")


def depthwise_conv2d_plain(x, w, stride=1, padding=0):
    """The kernel's function in plain PyTorch: per tap, a strided slice of
    the zero-padded float32 x times the per-channel weight, added to the
    sum in tap order (di outer, dj inner); cast back to x's type."""
    _check(x, w)
    kernel, stride, padding, out_hw = _conv.geometry(
        x.shape, tuple(w.shape[2:]), stride, padding)
    xp = _conv.pad_hw(x.float(), padding)
    wf = w.to(x.dtype).float()
    acc = None
    for di, dj, rows, cols in _conv.taps(kernel, stride, out_hw):
        term = xp[:, rows, cols, :] * wf[:, 0, di, dj]
        acc = term if acc is None else acc + term
    return acc.to(x.dtype).contiguous()


@functools.cache
def _kernel():
    return _conv.bind(_build.library("depthwise_conv").ctt_depthwise_conv2d,
                      12)


def _forward(x, w, stride, padding, groups=None):
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w, stride, padding)
    y = _conv.launch(_kernel, "depthwise_conv2d", x,
                     kernel_weight(w.to(x.dtype)), tuple(w.shape[2:]),
                     stride, padding)
    launches += 1
    return y


def kernel_weight(w):
    """The kernel's weight layout: (C, 1, kh, kw) → (kh*kw, C)."""
    return w.reshape(w.shape[0], -1).t().contiguous()


def _weight_grad(x, dy, kernel, stride, padding, groups=None):
    """dw (C, 1, kh, kw), float32: per tap the Σ over (b, i, j) of the
    strided slice of the padded x times dy, in float32 (the reference's
    ``bwd``, ``depthwise.py:133-147``)."""
    xp = _conv.pad_hw(x, padding)
    dy32 = dy.float()
    out_hw = dy.shape[1:3]
    dw = torch.empty((dy.shape[-1], 1, *kernel), dtype=torch.float32,
                     device=dy.device)
    for di, dj, rows, cols in _conv.taps(kernel, stride, out_hw):
        dw[:, 0, di, dj] = (xp[:, rows, cols, :].float() * dy32).sum(
            dim=(0, 1, 2))
    return dw


_OP = types.SimpleNamespace(forward=_forward,
                            dx_weight=lambda w, groups: w.flip(-2, -1),
                            weight_grad=_weight_grad)


def depthwise_conv2d(x, w, stride=1, padding=0):
    """x (B, H, W, C); w (C, 1, kh, kw), cast to x's type; stride 1 or 2;
    padding >= 0. Returns y (B, Ho, Wo, C) in x's type. Differentiable."""
    return _conv.Conv.apply(_OP, x, w.to(x.dtype), stride, padding,
                            x.shape[-1])
