"""Max pooling on NHWC: the forward with its winning-tap index, and its
backward.

Counterpart of ``convnet_tpu/ops/pallas/pool.py`` (``fwd_body``,
``bwd_body``) and ``convnet_tpu/ops/pallas/pool_bwd.py`` (``_bwd_kernel``),
with the semantics of ``_mp_fwd_argmax`` in ``convnet_tpu/ops/pool.py``:
taps are visited in the order ``t = di * kw + dj``, padding reads -inf and so
never wins, a later tap replaces the window's maximum only if it is strictly
greater (ties go to the first match), and the index is one uint8 per output
element. The backward adds each dy to the input pixel its index names.

On a CUDA tensor the wrappers launch the kernels of ``csrc/max_pool.cu`` or
raise; on a CPU tensor they run the plain versions below, which are also the
kernels' oracle in the on-card checks. ``fwd_launches`` and ``bwd_launches``
count kernel launches only.

The backward has two kernels, picked by a stated shape rule
(:func:`bwd_variant`): a 3x3 pool at stride 2 and padding 1 (the ResNet
stems) with C a multiple of the 16-byte vector (8 bf16 or 4 float32
channels) and aligned dy and index runs the tiled kernel, a residue-class
gather in output geometry (:func:`class_taps`, mirrored in plain PyTorch by
:func:`max_pool2d_bwd_classes`); every other pool the per-pixel kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from convnet_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0  # forward kernel launches since the last reset (set to 0)
bwd_launches = 0  # backward kernel launches since the last reset (set to 0)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _out_size(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _geometry(x_shape, kernel, stride, padding):
    """Checks a pool's geometry; returns ((kh, kw), (sh, sw), (ph, pw),
    (Ho, Wo)). The kernels take stride <= kernel and padding < kernel."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(padding)
    if len(x_shape) != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x_shape)}")
    if not (0 < sh <= kh and 0 < sw <= kw and 0 <= ph < kh and 0 <= pw < kw
            and kh * kw <= 255):
        raise ValueError(f"unsupported pool: kernel {(kh, kw)}, stride "
                         f"{(sh, sw)}, padding {(ph, pw)} (need 0 < stride "
                         f"<= kernel, 0 <= padding < kernel, kh*kw <= 255)")
    ho, wo = (_out_size(x_shape[1], kh, sh, ph),
              _out_size(x_shape[2], kw, sw, pw))
    if ho <= 0 or wo <= 0:
        raise ValueError(f"pool {(kh, kw)} is larger than the padded input "
                         f"{tuple(x_shape)}")
    return (kh, kw), (sh, sw), (ph, pw), (ho, wo)


def _taps(kernel, stride, out_hw):
    """(t, row slice, column slice) of every tap over the padded input."""
    (kh, kw), (sh, sw), (ho, wo) = kernel, stride, out_hw
    for di in range(kh):
        for dj in range(kw):
            yield (di * kw + dj, slice(di, di + (ho - 1) * sh + 1, sh),
                   slice(dj, dj + (wo - 1) * sw + 1, sw))


def max_pool2d_fwd_idx_plain(x, kernel, stride, padding):
    """The forward in plain PyTorch, the tap loop of ``_mp_fwd_argmax``.
    Returns (y in x's type, uint8 index)."""
    kernel, stride, (ph, pw), out_hw = _geometry(x.shape, kernel, stride,
                                                 padding)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph), value=float("-inf"))
    y = idx = None
    for t, rows, cols in _taps(kernel, stride, out_hw):
        patch = xp[:, rows, cols, :]
        if y is None:
            y = patch
            idx = torch.zeros(patch.shape, dtype=torch.uint8, device=x.device)
        else:
            better = patch > y
            y = torch.where(better, patch, y)
            idx = idx.masked_fill(better, t)
    return y.contiguous(), idx


def max_pool2d_bwd_plain(dy, idx, x_shape, kernel, stride, padding):
    """The backward in plain PyTorch: for each tap in ascending order, add
    the dy it won into a padded float32 dx at stride s; crop; cast to dy's
    type."""
    kernel, stride, (ph, pw), out_hw = _geometry(x_shape, kernel, stride,
                                                 padding)
    b, h, w, c = x_shape
    dxp = torch.zeros((b, h + 2 * ph, w + 2 * pw, c), dtype=torch.float32,
                      device=dy.device)
    dy32 = dy.float()
    zero = dy32.new_zeros(())
    for t, rows, cols in _taps(kernel, stride, out_hw):
        dxp[:, rows, cols, :] += torch.where(idx == t, dy32, zero)
    return dxp[:, ph:ph + h, pw:pw + w, :].to(dy.dtype).contiguous()


def class_taps(r, p, k, s):
    """The taps that feed residue class r of one axis: input coordinate
    i = s a + r is covered by window a + u through tap d for every d = r + p
    (mod s), u = (r + p - d) / s. Returns [(d, u), ...] in ascending d; the
    tiled kernel bakes this list in for (k, s, p) = (3, 2, 1):
    residue 0 [(1, 0)], residue 1 [(0, 1), (2, 0)]."""
    return [(d, (r + p - d) // s) for d in range(k) if (r + p - d) % s == 0]


def _shifted(m, du, dv, n_h, n_w):
    """out[:, a, b] = m[:, a + du, b + dv] for a < n_h, b < n_w; zero where
    that window lies outside m."""
    out = m.new_zeros((m.shape[0], n_h, n_w, m.shape[3]))
    h, w = m.shape[1], m.shape[2]
    a0, a1 = max(0, -du), min(n_h, h - du)
    b0, b1 = max(0, -dv), min(n_w, w - dv)
    if a0 < a1 and b0 < b1:
        out[:, a0:a1, b0:b1] = m[:, a0 + du:a1 + du, b0 + dv:b1 + dv]
    return out


def max_pool2d_bwd_classes(dy, idx, x_shape, kernel, stride, padding):
    """The backward as the tiled kernel computes it, in plain PyTorch: dx
    assembled class by class. Residue class (r_h, r_w) of dx, at window
    geometry (ceil(H/s_h), ceil(W/s_w)), is the float32 sum, in ascending
    tap order t = di kw + dj, of the masked dy of tap t shifted by the
    class's window shift (u, v); each class is placed at its strided pixels
    and dx cast to dy's type. Equal bit for bit to
    :func:`max_pool2d_bwd_plain`: the same float32 terms in the same order
    at every pixel."""
    (kh, kw), (sh, sw), (ph, pw), _ = _geometry(x_shape, kernel, stride,
                                                padding)
    b, h, w, c = x_shape
    n_h, n_w = -(-h // sh), -(-w // sw)
    dy32 = dy.float()
    zero = dy32.new_zeros(())
    dx = torch.empty((b, h, w, c), dtype=torch.float32, device=dy.device)
    for rh in range(sh):
        for rw in range(sw):
            plane = dy32.new_zeros((b, n_h, n_w, c))
            for di, u in class_taps(rh, ph, kh, sh):
                for dj, v in class_taps(rw, pw, kw, sw):
                    masked = torch.where(idx == di * kw + dj, dy32, zero)
                    plane += _shifted(masked, u, v, n_h, n_w)
            rows, cols = -(-(h - rh) // sh), -(-(w - rw) // sw)
            dx[:, rh::sh, rw::sw] = plane[:, :rows, :cols]
    return dx.to(dy.dtype)


def bwd_rule(c, kernel, stride, padding, dtype, dy_ptr, idx_ptr):
    """The backward kernel the shape rule names, "tiled" or "per_pixel":
    a 3x3 pool at stride 2 and padding 1 both ways, float32 or bf16, C a
    multiple of the 16-byte vector, dy 16-byte and idx vector aligned (the
    C library's ``bwd_tiled_ok``)."""
    pool = (*_pair(kernel), *_pair(stride), *_pair(padding))
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    tiled = (dtype in _DTYPES and pool == (3, 3, 2, 2, 1, 1) and c % vec == 0
             and dy_ptr % 16 == 0 and idx_ptr % vec == 0)
    return "tiled" if tiled else "per_pixel"


def bwd_variant(dy, idx, kernel, stride, padding):
    """The backward kernel that runs for dy and idx: on CUDA tensors the C
    library's answer, on CPU tensors (which run the plain version) the
    rule's for a CUDA tensor of the same shape, type and alignment."""
    if not dy.is_cuda:
        return bwd_rule(dy.shape[-1], kernel, stride, padding, dy.dtype,
                        dy.data_ptr(), idx.data_ptr())
    tiled = _library().ctt_max_pool2d_bwd_variant(
        dy.shape[-1], *_pair(kernel), *_pair(stride), *_pair(padding),
        _DTYPES.get(dy.dtype, -1), dy.data_ptr(), idx.data_ptr())
    return "tiled" if tiled else "per_pixel"


@functools.cache
def _library():
    lib = _build.library("max_pool")
    args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    for fn in (lib.ctt_max_pool2d_fwd_idx, lib.ctt_max_pool2d_bwd):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    fn = lib.ctt_max_pool2d_bwd_variant
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return lib


def _kernels():
    lib = _library()
    return lib.ctt_max_pool2d_fwd_idx, lib.ctt_max_pool2d_bwd


def _check_cuda(name, t, dtype=None):
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")


def _call(fn, name, ptrs, dims, dtype, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *dims, _DTYPES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw = "
                           f"{dims}, {dtype})")


def _launch_fwd(x, kernel, stride, padding, with_index):
    global fwd_launches
    (kh, kw), (sh, sw), (ph, pw), (ho, wo) = _geometry(x.shape, kernel,
                                                       stride, padding)
    if x.dtype not in _DTYPES:
        raise TypeError(f"no kernel for {x.dtype}: float32 or bfloat16 only")
    _check_cuda("x", x)
    b, h, w, c = x.shape
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    idx = (torch.empty((b, ho, wo, c), dtype=torch.uint8, device=x.device)
           if with_index else None)
    if y.numel() == 0:
        return y, idx
    _call(_kernels()[0], "max_pool2d_fwd_idx",
          (x.data_ptr(), y.data_ptr(), idx.data_ptr() if with_index else None),
          (b, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw), x.dtype, x.device)
    fwd_launches += 1
    return y, idx


def _launch_bwd(dy, idx, x_shape, kernel, stride, padding):
    global bwd_launches
    (kh, kw), (sh, sw), (ph, pw), (ho, wo) = _geometry(x_shape, kernel,
                                                       stride, padding)
    b, h, w, c = x_shape
    if dy.dtype not in _DTYPES:
        raise TypeError(f"no kernel for {dy.dtype}: float32 or bfloat16 only")
    if tuple(dy.shape) != (b, ho, wo, c) or idx.shape != dy.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and idx {tuple(idx.shape)} "
                         f"must be {(b, ho, wo, c)}")
    if idx.device != dy.device:
        raise ValueError(f"idx is on {idx.device}, dy on {dy.device}")
    _check_cuda("dy", dy)
    _check_cuda("idx", idx, torch.uint8)
    dx = torch.empty((b, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    _call(_kernels()[1], "max_pool2d_bwd",
          (dy.data_ptr(), idx.data_ptr(), dx.data_ptr()),
          (b, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw), dy.dtype, dy.device)
    bwd_launches += 1
    return dx


@torch.library.custom_op("convnet_tpu_torch::max_pool2d_fwd",
                         mutates_args=())
def _fwd_op(x: torch.Tensor, kernel: list[int], stride: list[int],
            padding: list[int]) -> torch.Tensor:
    return max_pool2d_fwd_idx(x, kernel, stride, padding, with_index=False)[0]


@_fwd_op.register_fake
def _(x, kernel, stride, padding):
    _, _, _, (ho, wo) = _geometry(x.shape, kernel, stride, padding)
    return x.new_empty((x.shape[0], ho, wo, x.shape[3]))


def max_pool2d_fwd_idx(x, kernel, stride, padding, with_index=True):
    """x (B, H, W, C) → (y (B, Ho, Wo, C) in x's type, uint8 winning-tap
    index of y's shape, or None when ``with_index`` is False). While
    ``torch.export`` traces, the forward without an index is the registered
    op ``convnet_tpu_torch::max_pool2d_fwd``, whose implementation is this
    function."""
    if not with_index and torch.compiler.is_compiling():
        return _fwd_op(x, list(_pair(kernel)), list(_pair(stride)),
                       list(_pair(padding))), None
    if x.is_cuda:
        return _launch_fwd(x, kernel, stride, padding, with_index)
    if x.device.type == "cpu":
        y, idx = max_pool2d_fwd_idx_plain(x, kernel, stride, padding)
        return y, (idx if with_index else None)
    raise ValueError(f"no kernel for device {x.device}")


def max_pool2d_bwd(dy, idx, x_shape, kernel, stride, padding):
    """dx (``x_shape``, dy's type) from dy and the forward's index."""
    if dy.is_cuda:
        return _launch_bwd(dy, idx, tuple(x_shape), kernel, stride, padding)
    if dy.device.type == "cpu":
        return max_pool2d_bwd_plain(dy, idx, tuple(x_shape), kernel, stride,
                                    padding)
    raise ValueError(f"no kernel for device {dy.device}")
