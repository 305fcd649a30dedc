"""int8 1x1 conv: quantize, int8 product, dequantize, folded BN and activation.

No Pallas kernel stands behind it: the JAX package computes the int8 pointwise
conv of its serving path with ``lax.dot`` between a quantize and a dequantize
pass (``convnet_tpu/nn/quant.py:109-141``). Here the three are one CUDA
kernel (``csrc/matmul_int8.cu``): it quantizes x while loading it, runs the
int8 products on the tensor cores (``mma.sync`` s8, int32 sums) and applies
the dequantization, the folded BN (or a conv's bias) and the activation in
its epilogue, writing the output once in x's type.

:func:`quantize_weight_1x1`, :func:`quantize_act` and
:func:`matmul_int8_plain` are the reference's arithmetic, op by op:
per-output-channel weight scales ``max(|w|, 1e-12) / 127``; the activation
multiplied by the inverse of its static scale in x's own type (the inverse
rounded to that type first) and rounded half to even; the int32 sums as
float32 times ``eff_scale * sw``, rounded to x's type; then scale and shift
in float32, the activation, and x's type again. The kernel gives the same
int8 values; its epilogue skips the rounding to x's type before the scale
and shift, so a bf16 output may differ from the plain version's by an ulp
(a float32 output is equal).

On a CUDA tensor :func:`matmul_int8` launches the kernel or raises; on a CPU
tensor it runs :func:`matmul_int8_plain`, which is also the kernel's oracle
in the on-card checks. ``launches`` counts kernel launches only. The
quantized weight, zero-padded to whole 64-wide K slices, is made once per
weight version (``_prepared``). While ``torch.export`` traces, the wrapper
calls the registered op ``convnet_tpu_torch::matmul_int8`` instead, whose
implementation is the same launch (or the plain version on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from convnet_tpu_torch.ops.kernels import _build, _prepared

ACTS = {"none": 0, "relu": 1, "relu6": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {1: "vector", 0: "scalar"}
K_SLICE = 64    # the kernel's K slice: the weight is padded to whole slices

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def _act(y, act):
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    return y


def quantize_weight_1x1(w):
    """Per-output-channel symmetric int8 weights of a 1x1 conv: w (N, K) or
    OIHW (N, K, 1, 1), read row by row. Returns (wq int8 (N, K), sw float32
    (N,)) with ``wq * sw[:, None]`` about w."""
    wf = w.reshape(w.shape[0], -1).float()
    sw = torch.clamp_min(wf.abs().amax(dim=1), 1e-12) / 127.0
    wq = torch.clamp(torch.round(wf / sw[:, None]), -127, 127)
    return wq.to(torch.int8), sw


def inverse_scale(act_scale: float, dtype):
    """(inv, eff_scale): 1 / act_scale as a value of ``dtype`` (rounded
    through float32, as numpy rounds a Python float to bf16) and the scale
    that value stands for, 1 / inv."""
    inv = torch.tensor(1.0 / act_scale, dtype=torch.float32).to(dtype).item()
    return inv, 1.0 / inv


def quantize_act(x, act_scale: float):
    """x → int8 with a static per-tensor scale, computed in x's type. Returns
    (xq int8 of x's shape, eff_scale): the dequantization must use
    ``eff_scale``, the scale that 1/act_scale in x's type stands for."""
    inv, eff_scale = inverse_scale(act_scale, x.dtype)
    xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return xq, eff_scale


def dequantized(acc, eff_scale, sw, dtype):
    """int32 sums (M, N), exact in any type → float32 times ``eff_scale *
    sw``, rounded to ``dtype``."""
    deq = torch.tensor(eff_scale, dtype=torch.float32, device=sw.device) * sw
    return (acc.float() * deq).to(dtype)


def int8_sums(xq, wq):
    """Σ_k xq[m, k] wq[n, k] for int8 xq (M, K) and wq (N, K): exact, in
    float64 (integers below 2^53), so it runs on any device."""
    return xq.double() @ wq.double().t()


def matmul_int8_plain(x, w, act_scale, scale=None, shift=None, act="none"):
    """The kernel's function in plain PyTorch, the reference op by op: x (M,
    K) in its type, w the float (N, K) weight; the dequantized product
    rounded to x's type, then scale and shift in float32 (None: 1 and 0), the
    activation, x's type."""
    xq, eff_scale = quantize_act(x, act_scale)
    wq, sw = quantize_weight_1x1(w)
    y = dequantized(int8_sums(xq, wq), eff_scale, sw, x.dtype)
    if scale is None and shift is None:
        return _act(y, act)
    y = y.float()
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    return _act(y, act).to(x.dtype)


def kernel_weight(w):
    """The kernel's weight: (wq int8 (N, Kp), sw float32 (N,)), wq zero
    beyond K up to Kp, the next multiple of ``K_SLICE``."""
    wq, sw = quantize_weight_1x1(w)
    n, k = wq.shape
    kp = -(-k // K_SLICE) * K_SLICE
    padded = torch.zeros((n, kp), dtype=torch.int8, device=wq.device)
    padded[:, :k] = wq
    return padded, sw


@functools.cache
def _library():
    lib = _build.library("matmul_int8")
    fn = lib.ctt_matmul_int8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.ctt_matmul_int8_variant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return lib


def variant(x):
    """The kernel that runs for x (M, K) on the card, by the C library's
    shape rule: "vector" where K * x's element size is a multiple of 16 and
    x is 16-byte aligned, else "scalar"."""
    code = _library().ctt_matmul_int8_variant(x.data_ptr(), x.shape[1],
                                              _DTYPES[x.dtype])
    return VARIANTS[code]


def _check_args(x, w, scale, shift, act):
    if act not in ACTS:
        raise ValueError(f"act={act!r}: choose from {sorted(ACTS)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"do not form (M, K) @ (N, K)^T")
    n = w.shape[0]
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.shape != (n,) or v.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 of shape ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")


def _launch(x, w, act_scale, scale, shift, act):
    global launches
    if x.dtype not in _DTYPES:
        raise TypeError(f"no kernel for {x.dtype}: float32 or bfloat16 only")
    for name, v in (("w", w), ("scale", scale), ("shift", shift)):
        if v is not None and v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (M, K) row-major")
    m, k = x.shape
    n = w.shape[0]
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"M, K, N = {m}, {k}, {n}: each must be below 2^31")
    wq, sw = _prepared.get("matmul_int8.weight", (w,), kernel_weight)
    scale = None if scale is None else scale.contiguous()
    shift = None if shift is None else shift.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    inv, eff_scale = inverse_scale(act_scale, x.dtype)
    _call(x, wq, sw, scale, shift, out, k, inv, eff_scale, act)
    launches += 1
    return out


def _call(x, wq, sw, scale, shift, out, k, inv, eff_scale, act):
    """One launch on the current stream of x's device, uncounted: x (M, K)
    contiguous, wq (N, Kp) int8 and sw (N,) from :func:`kernel_weight`,
    scale and shift float32 (N,) or None, out (M, N) in x's type."""
    m = x.shape[0]
    n, kp = wq.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().ctt_matmul_int8(
            x.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), out.data_ptr(), m,
            k, kp, n, inv, eff_scale, ACTS[act], _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error "
                           f"{err} (M={m}, K={k}, N={n}, {x.dtype})")


def _run(x, w, act_scale, scale, shift, act):
    if x.is_cuda:
        return _launch(x, w, act_scale, scale, shift, act)
    if x.device.type == "cpu":
        return matmul_int8_plain(x, w, act_scale, scale, shift, act)
    raise ValueError(f"no kernel for device {x.device}")


@torch.library.custom_op("convnet_tpu_torch::matmul_int8", mutates_args=())
def _op(x: torch.Tensor, w: torch.Tensor, act_scale: float,
        scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
        act: str) -> torch.Tensor:
    return _run(x, w, act_scale, scale, shift, act)


@_op.register_fake
def _(x, w, act_scale, scale, shift, act):
    return x.new_empty((x.shape[0], w.shape[0]))


def matmul_int8(x, w, act_scale, scale=None, shift=None, act="none"):
    """``act(int8(x) @ int8(w)^T * dequant * scale + shift)``: x (M, K) in
    bf16 or float32, w the float (N, K) weight, ``act_scale`` the static
    activation scale, scale and shift float32 (N,) or None. Output in x's
    type. Inference only: nothing here records for autograd."""
    _check_args(x, w, scale, shift, act)
    if torch.compiler.is_compiling():
        return _op(x, w, float(act_scale), scale, shift, act)
    return _run(x, w, act_scale, scale, shift, act)


def conv1x1_int8_bn_act(x, w, act_scale, scale=None, shift=None,
                        act="none"):
    """The int8 1x1 conv of an NHWC input with the folded BN (or a conv's
    bias as ``shift``) and the activation. ``w`` is the conv's OIHW weight,
    (Cout, Cin, 1, 1)."""
    b, h, wd, cin = x.shape
    out = matmul_int8(x.reshape(-1, cin), w.reshape(w.shape[0], cin),
                      act_scale, scale, shift, act)
    return out.view(b, h, wd, -1)
