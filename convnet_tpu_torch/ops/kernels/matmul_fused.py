"""Fused matmul + per-column scale/shift + activation: the 1x1 conv kernel.

Counterpart of ``convnet_tpu/ops/pallas/matmul_fused.py``. A 1x1 conv (or a
Linear) followed by a folded BatchNorm and an activation is exactly
``act((X @ W) * scale + shift)`` with X = (N*H*W, Cin); the CUDA kernel in
``csrc/matmul_fused.cu`` computes it in one pass with float32 accumulation
and the epilogue in float32, writing the output once in X's type.

On a CUDA tensor the wrappers launch that kernel or raise; on a CPU tensor
they run :func:`matmul_scale_act_plain`, the same function in plain PyTorch,
which is also the kernel's oracle in the on-card checks. ``launches`` counts
kernel launches only. The C library picks one of three kernels by a shape
rule (:func:`variant`): bf16 with K and N multiples of 8 and 16-byte
aligned operands runs the TMA + wgmma kernel, other bf16 shapes the
mma.sync kernel, float32 the FMA kernel. Without autograd the weight's
(N, K) copy in x's type is made once per weight version (``_prepared``).

The op is differentiable, with the JAX package's custom VJP
(``matmul_fused.py:92-110``): dx, dw, dscale and dshift are plain matmuls
and sums, as they are there outside any Pallas kernel. While ``torch.export``
traces, the inference route calls the registered op
``convnet_tpu_torch::matmul_scale_act`` instead, whose implementation is the
same launch (or the plain version on the CPU), so an exported program runs
the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from convnet_tpu_torch.ops.kernels import _build, _prepared

ACTS = {"none": 0, "relu": 1, "relu6": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {2: "tma_wgmma", 1: "mma_sync", 0: "fma_float32"}

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def _act(y, act):
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    return y


def _check_args(x, w, scale, shift, act):
    if act not in ACTS:
        raise ValueError(f"act={act!r}: choose from {sorted(ACTS)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"do not form (M, K) @ (K, N)")
    n = w.shape[1]
    for name, v in (("scale", scale), ("shift", shift)):
        if v.shape != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")


def matmul_scale_act_plain(x, w, scale, shift, act="relu"):
    """The kernel's function in plain PyTorch (float32 math, cast back)."""
    y = (x.float() @ w.to(x.dtype).float()) * scale + shift
    return _act(y, act).to(x.dtype)


@functools.cache
def _library():
    lib = _build.library("matmul_fused")
    fn = lib.ctt_matmul_scale_act
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ctt_matmul_scale_act_variant
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return lib


def _kernel():
    return _library().ctt_matmul_scale_act


def variant(x, wt, out):
    """The kernel that runs for x (M, K), wt (N, K) and out (M, N) on the
    card, by the C library's shape rule: "tma_wgmma", "mma_sync" or
    "fma_float32"."""
    code = _library().ctt_matmul_scale_act_variant(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), x.shape[1], wt.shape[0],
        _DTYPES[x.dtype])
    return VARIANTS[code]


def kernel_weight(w, dtype):
    """The kernel's weight: w (K, N) as (N, K) row-major in ``dtype``, i.e.
    the OIHW weight as stored, cast to the compute type first as the TPU
    kernel's caller does."""
    return w.t().to(dtype).contiguous()


def _launch(x, w, scale, shift, act, cached=False):
    global launches
    if x.dtype not in _DTYPES:
        raise TypeError(f"no kernel for {x.dtype}: float32 or bfloat16 only")
    for name, v in (("w", w), ("scale", scale), ("shift", shift)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (M, K) row-major")
    m, k = x.shape
    n = w.shape[1]
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"M, K, N = {m}, {k}, {n}: each must be below 2^31")
    if cached:
        wt = _prepared.get(("matmul_fused.weight", x.dtype), (w,),
                           lambda w: kernel_weight(w, x.dtype))
    else:
        wt = kernel_weight(w, x.dtype)
    scale = scale.contiguous()
    shift = shift.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    _call(x, wt, scale, shift, out, act)
    launches += 1
    return out


def _call(x, wt, scale, shift, out, act):
    """One launch on the current stream of x's device, uncounted: x (M, K)
    and wt (N, K) contiguous in the compute type, scale and shift float32
    (N,), out (M, N) in x's type."""
    m, k = x.shape
    n = wt.shape[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), wt.data_ptr(), scale.data_ptr(),
                        shift.data_ptr(), out.data_ptr(), m, k, n, ACTS[act],
                        _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"matmul_scale_act kernel launch failed: CUDA error "
                           f"{err} (M={m}, K={k}, N={n}, {x.dtype})")


class _MatmulScaleAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, act):
        if x.is_cuda:
            y = _launch(x, w, scale, shift, act)
        elif x.device.type == "cpu":
            y = matmul_scale_act_plain(x, w, scale, shift, act)
        else:
            raise ValueError(f"no kernel for device {x.device}")
        ctx.save_for_backward(x, w, scale, y)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, scale, y = ctx.saved_tensors
        dy = dy.float()
        if ctx.act == "relu":
            dy = dy * (y > 0)
        elif ctx.act == "relu6":
            dy = dy * ((y > 0) & (y < 6))
        r = (dy * scale).to(x.dtype)                # d(acc)
        wc = w.to(x.dtype)
        dx = r @ wc.t()
        dw = (x.t() @ r).to(w.dtype)
        # dscale needs the pre-scale accumulator: recompute one matmul
        acc = (x @ wc).float()
        dscale = torch.sum(dy * acc, dim=0)
        dshift = torch.sum(dy, dim=0)
        return dx.to(x.dtype), dw, dscale, dshift, None


def _run(x, w, scale, shift, act):
    if x.is_cuda:
        return _launch(x, w, scale, shift, act, cached=True)
    if x.device.type == "cpu":
        return matmul_scale_act_plain(x, w, scale, shift, act)
    raise ValueError(f"no kernel for device {x.device}")


@torch.library.custom_op("convnet_tpu_torch::matmul_scale_act",
                         mutates_args=())
def _op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
        shift: torch.Tensor, act: str) -> torch.Tensor:
    return _run(x, w, scale, shift, act)


@_op.register_fake
def _(x, w, scale, shift, act):
    return x.new_empty((x.shape[0], w.shape[1]))


def matmul_scale_act(x, w, scale=None, shift=None, act="relu"):
    """``act((x @ w) * scale + shift)``: x (M, K), w (K, N), scale/shift (N,)
    float32, None meaning 1 and 0. Output in x's type. Differentiable;
    without autograd the kernel's weight is made once per weight version."""
    n = w.shape[-1]
    if scale is None:
        scale = torch.ones(n, dtype=torch.float32, device=w.device)
    if shift is None:
        shift = torch.zeros(n, dtype=torch.float32, device=w.device)
    _check_args(x, w, scale, shift, act)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, shift)):
        return _MatmulScaleAct.apply(x, w, scale, shift, act)
    if torch.compiler.is_compiling():
        return _op(x, w, scale, shift, act)
    return _run(x, w, scale, shift, act)


def conv1x1_bn_act(x, w, scale=None, shift=None, act="relu"):
    """Fused 1x1 conv + folded BN + activation on an NHWC input. ``w`` is
    the conv's OIHW weight, (Cout, Cin, 1, 1)."""
    b, h, wd, cin = x.shape
    w2 = w.reshape(w.shape[0], cin).t()  # (K, N) view of the (N, K) weight
    out = matmul_scale_act(x.reshape(-1, cin), w2, scale, shift, act)
    return out.view(b, h, wd, -1)
