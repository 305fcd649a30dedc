"""Depthwise k x k convolution on NHWC: MobileNet's 3x3.

Counterpart of ``convnet_tpu/ops/pallas/depthwise.py``
(``depthwise_conv_pallas``, ``_build_fwd.body``): y[b, i, j, c] = Σ over
(di, dj) of xpad[b, i s + di, j s + dj, c] · w[c, 0, di, dj], the taps added
di outer and dj inner in float32, y in x's type. The weight is the port's
OIHW depthwise weight (C, 1, kh, kw).

On a CUDA tensor :func:`depthwise_conv2d` launches a kernel of
``csrc/depthwise_conv.cu`` or raises; on a CPU tensor it runs
:func:`depthwise_conv2d_plain`, which is also the kernels' oracle in the
on-card checks. ``launches`` counts kernel launches only, forward and dx
alike. Both kernels read the OIHW weight as it is, in x's type. The C
library picks the kernel by a shape rule (:func:`variant`): a 3x3 kernel
with one stride (1 or 2) both ways, C a multiple of the 16-byte vector (8
bf16 or 4 float32 channels) and 16-byte aligned x and w run the tiled
kernel (staged haloed tiles, a persistent grid); other shapes the
per-pixel kernel. Without autograd the weight's cast to x's type is made
once per weight version (``_prepared``).

The op is differentiable with the reference's backward (``depthwise.py``
:123-148): at stride 1 dx is the same kernel on dy with the spatially
flipped weight and padding k - 1 - p (a crop of dy where p > k - 1); at
stride 2 dx is the library's transposed conv, which XLA computes in the
reference; dw is the reference's per-tap Σ over (b, i, j) of x · dy in
float32, in plain torch ops. While ``torch.export`` traces, the inference
route is the registered op ``convnet_tpu_torch::depthwise_conv2d``, whose
implementation is the same launch (or the plain version on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from convnet_tpu_torch.ops.kernels import _build, _conv, _prepared

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
def _library():
    lib = _build.library("depthwise_conv")
    _conv.bind(lib.ctt_depthwise_conv2d, 12)
    fn = lib.ctt_depthwise_conv2d_variant
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return lib


def _kernel():
    return _library().ctt_depthwise_conv2d


def variant(x, w, stride):
    """The kernel that runs for x and w (CUDA, w in x's type) at
    ``stride``: "tiled" or "per_pixel", by the C library's shape rule."""
    (kh, kw), (sh, sw) = tuple(w.shape[2:]), _conv.pair(stride)
    tiled = _library().ctt_depthwise_conv2d_variant(
        x.shape[-1], kh, kw, sh, sw, _conv.DTYPES[x.dtype], x.data_ptr(),
        w.data_ptr())
    return "tiled" if tiled else "per_pixel"


def _forward(x, w, stride, padding, groups=None, cached=False):
    """The conv through a kernel (CUDA) or the plain version (CPU).
    ``cached``: w's cast to x's type comes from ``_prepared``, made once per
    version of ``w``; otherwise w is already in x's type."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w, stride, padding)
    if cached and (w.dtype != x.dtype or not w.is_contiguous()):
        w = _prepared.get(("depthwise_conv.weight", x.dtype), (w,),
                          lambda w: w.to(x.dtype).contiguous())
    y = _conv.launch(_kernel, "depthwise_conv2d", x, w.contiguous(),
                     tuple(w.shape[2:]), stride, padding)
    launches += 1
    return y


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


@torch.library.custom_op("convnet_tpu_torch::depthwise_conv2d",
                         mutates_args=())
def _op(x: torch.Tensor, w: torch.Tensor, stride: list[int],
        padding: list[int]) -> torch.Tensor:
    return _forward(x, w, stride, padding, cached=True)


@_op.register_fake
def _(x, w, stride, padding):
    _, _, _, (ho, wo) = _conv.geometry(x.shape, tuple(w.shape[2:]), stride,
                                       padding)
    return x.new_empty((x.shape[0], ho, wo, x.shape[3]))


def depthwise_conv2d(x, w, stride=1, padding=0):
    """x (B, H, W, C); w (C, 1, kh, kw), cast to x's type; stride 1 or 2;
    padding >= 0. Returns y (B, Ho, Wo, C) in x's type. Differentiable;
    without autograd the weight's cast is made once per weight version."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _conv.Conv.apply(_OP, x, w.to(x.dtype), stride, padding,
                                x.shape[-1])
    if torch.compiler.is_compiling():
        return _op(x, w, list(_conv.pair(stride)), list(_conv.pair(padding)))
    return _forward(x, w, stride, padding, cached=True)
