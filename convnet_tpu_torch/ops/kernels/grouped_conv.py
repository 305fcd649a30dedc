"""Grouped k x k convolution on NHWC with cin == cout: ResNeXt's 3x3.

Counterpart of ``convnet_tpu/ops/pallas/grouped.py`` (``grouped_conv_pallas``,
``_build_fwd.body``): y[b, i, j, g cg + o] = Σ over taps (di, dj), then over
c < cg, of xpad[b, i s + di, j s + dj, g cg + c] · w[g cg + o, c, di, dj],
with the grouped weight in the port's OIHW layout (C, cg, kh, kw), float32
accumulation, and y in x's type.

On a CUDA tensor :func:`grouped_conv2d` launches a kernel of
``csrc/grouped_conv.cu`` or raises; on a CPU tensor it runs
:func:`grouped_conv2d_plain`, which is also the kernels' oracle in the
on-card checks. ``launches`` counts kernel launches only. The C library
picks the kernel by a shape rule (:func:`variant`): bf16 with C % 64 == 0
and cg dividing 16 or cg in (32, 64, 128), every shape :func:`supported`
admits, runs on the tensor cores with the weight packed by
:func:`block_tiles`; float32 and the other shapes run on the CUDA cores
with the weight of :func:`transposed_weight`. Without autograd the packed
weight is made once per weight version (``_prepared``).

The op is differentiable with the reference's backward (``grouped.py``
:149-173): at stride 1 dx is the same kernel on dy, with the weight flipped
in space and transposed within each group and padding k - 1 - p (a crop of
dy where p > k - 1); at stride 2 dx is the library's transposed conv, and dw
is the library's grouped weight gradient at every stride, as the reference
leaves both to XLA. While ``torch.export`` traces, the inference route is
the registered op ``convnet_tpu_torch::grouped_conv2d``, whose
implementation is the same launch (or the plain version on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from convnet_tpu_torch.ops.kernels import _build, _conv, _prepared

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def supported(x_shape, w_shape, groups, stride, dilation=1):
    """The reference's structural rule (``grouped.py:189``, with
    ``ops/conv.py:_tiled_grouped_eligible``): a true grouped conv (not
    dense, not depthwise) with cin == cout, C % 128 == 0, 128 % cg == 0,
    dilation 1 and stride <= 2. ``w_shape`` is OIHW, (cout, cg, kh, kw)."""
    cout, cg = w_shape[0], w_shape[1]
    cin = x_shape[-1]
    sh, sw = _conv.pair(stride)
    return (groups > 1 and cg > 1 and cin == cout and cin % 128 == 0
            and 128 % cg == 0 and _conv.pair(dilation) == (1, 1)
            and sh <= 2 and sw <= 2)


def _check(x, w, groups):
    b, h, wd, c = x.shape
    if groups <= 0 or c % groups or w.dim() != 4 or \
            tuple(w.shape[:2]) != (c, c // groups):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} with "
                         f"groups={groups}: need cin == cout == C and an "
                         f"OIHW weight (C, C/groups, kh, kw)")


def grouped_conv2d_plain(x, w, stride=1, padding=0, groups=1):
    """The kernel's function in plain PyTorch: per tap, one float32 einsum
    over (B, Ho, Wo, G, cg) x (G, cg, cg), the taps added in order (di
    outer, dj inner); cast back to x's type."""
    _check(x, w, groups)
    kernel, stride, padding, out_hw = _conv.geometry(
        x.shape, tuple(w.shape[2:]), stride, padding)
    b, _, _, c = x.shape
    cg = c // groups
    xp = _conv.pad_hw(x.float(), padding)
    xp = xp.view(*xp.shape[:3], groups, cg)
    wf = w.to(x.dtype).float().view(groups, cg, cg, *kernel)  # (G, o, c, .)
    acc = None
    for di, dj, rows, cols in _conv.taps(kernel, stride, out_hw):
        term = torch.einsum("bhwgc,goc->bhwgo", xp[:, rows, cols],
                            wf[..., di, dj])
        acc = term if acc is None else acc + term
    return acc.reshape(b, *out_hw, c).to(x.dtype)


@functools.cache
def _library():
    lib = _build.library("grouped_conv")
    _conv.bind(lib.ctt_grouped_conv2d, 13)
    fn = lib.ctt_grouped_conv2d_variant
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _kernel():
    return _library().ctt_grouped_conv2d


def variant(x, groups):
    """The kernel that runs for x (CUDA) and ``groups``: "tensor_cores" or
    "cuda_cores", by the C library's shape rule."""
    c = x.shape[-1]
    tc = _library().ctt_grouped_conv2d_variant(
        c, c // groups, _conv.DTYPES[x.dtype], x.data_ptr())
    return "tensor_cores" if tc else "cuda_cores"


def _forward(x, w, stride, padding, groups, cached=False):
    """The conv through the kernel (CUDA) or the plain version (CPU).
    ``cached``: the weight's kernel layout comes from ``_prepared``, made
    once per version of ``w``."""
    global launches
    _check(x, w, groups)
    if x.device.type == "cpu":
        return grouped_conv2d_plain(x, w, stride, padding, groups)
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _conv.DTYPES:
        raise TypeError(f"no kernel for {x.dtype}: float32 or bfloat16 only")
    kind = variant(x, groups)
    if cached:
        wt = _prepared.get(("grouped_conv.weight", x.dtype, kind), (w,),
                           lambda w: kernel_weight(w, x, kind))
    else:
        wt = kernel_weight(w, x, kind)
    y = _conv.launch(_kernel, "grouped_conv2d", x, wt, tuple(w.shape[2:]),
                     stride, padding, x.shape[-1] // groups)
    launches += 1
    return y


def kernel_weight(w, x, kind=None):
    """w (C, cg, kh, kw) in x's type and the layout of the kernel that runs
    for x (``kind``, by default :func:`variant`)."""
    kind = kind or variant(x, x.shape[-1] // w.shape[1])
    w = w.to(x.dtype)
    return block_tiles(w) if kind == "tensor_cores" else transposed_weight(w)


def transposed_weight(w):
    """The CUDA-core kernel's layout: (C, cg, kh, kw) → (kh, kw, cg, C),
    in memory (kh*kw, cg, C), so a warp's 32 output channels read
    neighbouring weights."""
    return w.permute(2, 3, 1, 0).contiguous()


def block_tiles(w):
    """The tensor-core kernel's layout: (C, cg, kh, kw) → (kh*kw, C/WB, WB,
    WB), WB = max(16, cg); tile [t, b, o, i] is the weight from input
    channel b WB + i to output b WB + o at tap t = di kw + dj. Where cg < 16
    a tile holds 16/cg groups on its diagonal and zeros elsewhere; where
    cg >= 16 it is one group's dense cg x cg block."""
    c, cg, kh, kw = w.shape
    wb = max(16, cg)
    per = wb // cg                                  # groups a tile
    src = w.reshape(c // wb, per, cg, cg, kh * kw).permute(4, 0, 1, 2, 3)
    tiles = w.new_zeros(kh * kw, c // wb, wb, wb)
    for a in range(per):
        blk = slice(a * cg, (a + 1) * cg)
        tiles[:, :, blk, blk] = src[:, :, a]
    return tiles


def flip_transpose(w, groups):
    """The dx weight: w'[g cg + c, o, di, dj] = w[g cg + o, c, k-1-di,
    k-1-dj] (``_flip_transpose_tiles`` of the reference)."""
    c, cg, kh, kw = w.shape
    return (w.view(groups, cg, cg, kh, kw).transpose(1, 2)
            .flip(-2, -1).reshape(c, cg, kh, kw))


def _weight_grad(x, dy, kernel, stride, padding, groups):
    """The library's grouped weight gradient, as XLA's in the reference."""
    return torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2), (x.shape[-1], x.shape[-1] // groups, *kernel),
        dy.permute(0, 3, 1, 2), stride, padding, 1, groups)


_OP = types.SimpleNamespace(forward=_forward, dx_weight=flip_transpose,
                            weight_grad=_weight_grad)


@torch.library.custom_op("convnet_tpu_torch::grouped_conv2d", mutates_args=())
def _op(x: torch.Tensor, w: torch.Tensor, stride: list[int],
        padding: list[int], groups: int) -> torch.Tensor:
    return _forward(x, w, stride, padding, groups, cached=True)


@_op.register_fake
def _(x, w, stride, padding, groups):
    _, _, _, (ho, wo) = _conv.geometry(x.shape, tuple(w.shape[2:]), stride,
                                       padding)
    return x.new_empty((x.shape[0], ho, wo, x.shape[3]))


def grouped_conv2d(x, w, stride=1, padding=0, groups=1):
    """x (B, H, W, C); w (C, C/groups, kh, kw), cast to x's type; stride 1
    or 2; padding >= 0. Returns y (B, Ho, Wo, C) in x's type.
    Differentiable; without autograd the weight's kernel layout is made once
    per weight version."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _conv.Conv.apply(_OP, x, w.to(x.dtype), stride, padding,
                                groups)
    if torch.compiler.is_compiling():
        return _op(x, w, list(_conv.pair(stride)), list(_conv.pair(padding)),
                   groups)
    return _forward(x, w, stride, padding, groups, cached=True)
