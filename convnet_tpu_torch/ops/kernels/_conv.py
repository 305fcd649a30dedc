"""What the grouped and the depthwise conv kernels share: the geometry of a
k x k NHWC convolution, its taps, the checked ctypes launch, and the
autograd function whose stride-1 input gradient is the forward conv of dy
(the reference's ``bwd`` in ``grouped.py`` and ``depthwise.py``)."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT32_LIMIT = 2 ** 31


def pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def geometry(x_shape, kernel, stride, padding):
    """Checks a conv's geometry; returns ((kh, kw), (sh, sw), (ph, pw),
    (Ho, Wo)), with Ho = (H + 2 ph - kh) // sh + 1. The kernels take
    strides 1 and 2 and any padding >= 0."""
    (kh, kw), (sh, sw), (ph, pw) = pair(kernel), pair(stride), pair(padding)
    if len(x_shape) != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x_shape)}")
    if not (kh > 0 and kw > 0 and sh in (1, 2) and sw in (1, 2)
            and ph >= 0 and pw >= 0):
        raise ValueError(f"unsupported conv: kernel {(kh, kw)}, stride "
                         f"{(sh, sw)}, padding {(ph, pw)} (need stride 1 or "
                         f"2 and padding >= 0)")
    ho = (x_shape[1] + 2 * ph - kh) // sh + 1
    wo = (x_shape[2] + 2 * pw - kw) // sw + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"kernel {(kh, kw)} is larger than the padded "
                         f"input {tuple(x_shape)}")
    return (kh, kw), (sh, sw), (ph, pw), (ho, wo)


def taps(kernel, stride, out_hw):
    """(di, dj, row slice, column slice) of every tap over the padded
    input, di outer and dj inner."""
    (kh, kw), (sh, sw), (ho, wo) = kernel, stride, out_hw
    for di in range(kh):
        for dj in range(kw):
            yield (di, dj, slice(di, di + (ho - 1) * sh + 1, sh),
                   slice(dj, dj + (wo - 1) * sw + 1, sw))


def pad_hw(x, padding):
    ph, pw = padding
    return F.pad(x, (0, 0, pw, pw, ph, ph)) if (ph or pw) else x


def dx_geometry(dy, kernel, padding):
    """The stride-1 input gradient is the forward conv of dy with the flipped
    weight at padding k - 1 - p. Where p > k - 1 that padding is negative:
    a crop of dy by p - (k - 1) on each side, then padding 0. Returns (dy,
    cropped where needed, and contiguous; the padding to use)."""
    (kh, kw), (ph, pw) = kernel, padding
    qh, qw = kh - 1 - ph, kw - 1 - pw
    eh, ew = max(-qh, 0), max(-qw, 0)
    if eh or ew:
        dy = dy[:, eh:dy.shape[1] - eh, ew:dy.shape[2] - ew, :]
    return dy.contiguous(), (max(qh, 0), max(qw, 0))


def check_cuda(name, t, dtype):
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.numel() >= INT32_LIMIT:
        raise ValueError(f"{name} has {t.numel()} elements: the kernel's "
                         f"32-bit offsets need fewer than 2^31")


def bind(fn, n_ints):
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(library_fn, name, x, wt, kernel, stride, padding, *extra):
    """Checks the arguments, then launches ``library_fn()`` (x, wt, y
    pointers; B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, ``extra`` ints;
    dtype code; stream) on the current stream of x's device. ``wt`` is the
    weight in the kernel's layout and x's type. Returns y (B, Ho, Wo, C) in
    x's type; raises on a device without a kernel or a CUDA error."""
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    (kh, kw), (sh, sw), (ph, pw), (ho, wo) = geometry(x.shape, kernel,
                                                     stride, padding)
    if x.dtype not in DTYPES:
        raise TypeError(f"no kernel for {x.dtype}: float32 or bfloat16 only")
    if wt.device != x.device:
        raise ValueError(f"w is on {wt.device}, x on {x.device}")
    check_cuda("x", x, x.dtype)
    check_cuda("w", wt, x.dtype)
    b, h, wd, c = x.shape
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    check_cuda("y", y, x.dtype)
    dims = (b, h, wd, c, ho, wo, kh, kw, sh, sw, ph, pw, *extra)
    fn = library_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wt.data_ptr(), y.data_ptr(), *dims,
                 DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(dims {dims}, {x.dtype})")
    return y


class Conv(torch.autograd.Function):
    """conv(x, w) through ``op``, with the reference's backward; the callers
    cast w to x's type first, so autograd rounds dw as the reference's cast
    does. ``op`` gives ``forward(x, w, stride, padding, groups)`` (the
    kernel on a CUDA tensor, the plain version on a CPU one),
    ``dx_weight(w, groups)`` and ``weight_grad(x, dy, kernel, stride,
    padding, groups)``. At stride 1 dx is ``op.forward`` on dy with
    ``dx_weight`` at padding k - 1 - p; at stride 2 it is the library's
    transposed conv, which XLA computes outside any kernel in the
    reference."""

    @staticmethod
    def forward(ctx, op, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (op, pair(stride), pair(padding), groups)
        return op.forward(x, w, stride, padding, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        op, stride, padding, groups = ctx.conf
        kernel = tuple(w.shape[2:])
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            if stride == (1, 1):
                dy_in, pad = dx_geometry(dy, kernel, padding)
                dx = op.forward(dy_in, op.dx_weight(w, groups), 1, pad,
                                groups)
            else:
                dx = torch.nn.grad.conv2d_input(
                    x.permute(0, 3, 1, 2).shape, w, dy.permute(0, 3, 1, 2),
                    stride, padding, 1, groups).permute(0, 2, 3, 1)
                dx = dx.contiguous()
        if ctx.needs_input_grad[2]:
            dw = op.weight_grad(x, dy, kernel, stride, padding,
                                groups).to(w.dtype)
        return None, dx, dw, None, None, None
