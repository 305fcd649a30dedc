"""int8 1x1 conv: quantize, int8 product, dequantize, folded BN and activation.

No Pallas kernel stands behind it: the JAX package computes the int8 pointwise
conv of its serving path with ``lax.dot`` between a quantize and a dequantize
pass (``convnet_tpu/nn/quant.py:109-141``). Here the three are one CUDA
kernel (``csrc/matmul_int8.cu``): it quantizes x on chip, runs the int8
products on the tensor cores (int32 sums) and applies the dequantization,
the folded BN (or a conv's bias) and the activation in its epilogue,
writing the output once in x's type.

The C library picks one of three instances by a shape rule
(:func:`variant`): "tma" (bf16 where TMA can describe x, wq and out: a
persistent TMA + ``wgmma`` kernel), "vector" and "scalar" (the first
design's ``mma.sync`` kernel with 16-byte or element loads of x). The "tma"
kernel takes its tile shape and its split of K from :func:`plan`, the one
definition of that rule; split K adds exact int32 sums through a zeroed
workspace a device and stream (:func:`_scratch`), of a fixed size
(:func:`scratch_bound`), which every launch leaves zero.

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
``launches_by_variant`` counts the same launches by instance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from convnet_tpu_torch.ops.kernels import _build, _prepared

ACTS = {"none": 0, "relu": 1, "relu6": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {2: "tma", 1: "vector", 0: "scalar"}   # the C library's codes
K_SLICE = 64    # the kernel's K slice: the weight is padded to whole slices
TILE_N = 128    # the widest "tma" tile: wgmma m64n128k32
STEP_K = 32     # K a wgmma step takes: 32 bytes of int8
MIN_SPLIT_STEPS = 4   # the fewest K steps a split range is given
LONG_K = 256    # from this K on, 64-row tiles

launches = 0  # kernel launches since the last reset (set it to 0 to reset)
# the same launches by instance (reset each to 0 with ``launches``)
launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)


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


@functools.lru_cache(maxsize=None)
def inverse_scale(act_scale: float, dtype):
    """(inv, eff_scale): 1 / act_scale as a value of ``dtype`` (rounded
    through float32, as numpy rounds a Python float to bf16) and the scale
    that value stands for, 1 / inv. Computed once per (act_scale, dtype): a
    served model's scales are fixed."""
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


class Plan(NamedTuple):
    """The "tma" kernel's work for (M, K, N): tiles of ``bm`` rows (64 or
    128) by ``bn`` columns (a multiple of 16 up to 128), and K in
    ``ksteps`` steps of 32 bytes cut into ``split`` ranges of ``per`` (even)
    steps, the last range what is left; a work unit is a tile and a range."""
    bm: int
    bn: int
    m_tiles: int
    n_tiles: int
    split: int
    per: int
    ksteps: int

    @property
    def units(self):
        return self.m_tiles * self.n_tiles * self.split


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, sms: int) -> Plan:
    """The "tma" kernel's tile shape and split of K, a pure function of the
    shape and the card's SM count:

    * N in ceil(N / 128) equal tiles, each rounded up to a wgmma width (a
      multiple of 16): N = 16, 24, 32 and 64 take one narrow tile, 144 and
      160 two of 80, 320 three of 112;
    * K in 32-byte steps (one step where K <= 32);
    * 128-row tiles where K is under LONG_K and they are at least one a
      SM, else 64-row tiles (measured on an H100: 64-row tiles, three
      blocks an SM, are faster where the K loop is long, 128-row ones where
      the epilogue dominates);
    * where even those are fewer than the SMs, K split into ranges of whole
      64-wide slices, as many as fill the SMs while each range keeps at
      least MIN_SPLIT_STEPS steps."""
    n_tiles = _cdiv(n, TILE_N)
    bn = 16 * _cdiv(_cdiv(n, n_tiles), 16)
    ksteps = _cdiv(k, STEP_K)
    bm = 128 if k < LONG_K and _cdiv(m, 128) * n_tiles >= sms else 64
    tiles = _cdiv(m, bm) * n_tiles
    split = 1
    if tiles < sms:
        split = max(1, min(_cdiv(sms, tiles), ksteps // MIN_SPLIT_STEPS))
    per = 2 * _cdiv(ksteps, 2 * split)
    return Plan(bm, bn, _cdiv(m, bm), n_tiles, _cdiv(ksteps, per), per,
                ksteps)


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch_bound(sms: int) -> tuple[int, int]:
    """The int32 elements of the split-K workspace and of its counters that
    any plan on a card of ``sms`` SMs needs: :func:`plan` splits K only
    where the tiles are fewer than the SMs, and then its tiles have 64
    rows, each at most 64 x TILE_N sums and one counter."""
    return (sms - 1) * 64 * TILE_N, sms - 1


_SCRATCH = {}   # (device index, stream) → (workspace, counters): int32, zero


def _scratch(device, stream):
    """The split-K workspace (a tile's int32 sums) and counters (a tile's
    finished ranges) for launches on ``stream`` of ``device``: made zero at
    :func:`scratch_bound`, once a stream, and left zero by every launch, so
    launches in one stream's order share them and two streams never do.
    Made during a CUDA graph's capture, the zeroing is part of the graph and
    runs before the kernel on every replay."""
    key = (device.index, stream)
    have = _SCRATCH.get(key)
    if have is None:
        have = tuple(torch.zeros(size, dtype=torch.int32, device=device)
                     for size in scratch_bound(_sm_count(device.index)))
        _SCRATCH[key] = have
    return have


def _bind(lib):
    """Sets the argument and result types of the library's two functions."""
    fn = lib.ctt_matmul_int8
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.ctt_matmul_int8_variant
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library():
    return _bind(_build.library("matmul_int8"))


def variant(x, n, out=None):
    """The kernel that runs for x (M, K) and N output columns on the card,
    by the C library's shape rule: "tma" for bf16 with K and N multiples of
    8 and x and out 16-byte aligned (``out`` None: a fresh output, which
    torch aligns), else "vector" where K * x's element size is a multiple of
    16 and x is 16-byte aligned, else "scalar"."""
    code = _library().ctt_matmul_int8_variant(
        x.data_ptr(), 0 if out is None else out.data_ptr(), x.shape[1], n,
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
    kind = _call(x, wq, sw, scale, shift, out, k, inv, eff_scale, act)
    launches += 1
    launches_by_variant[kind] += 1
    return out


def _call(x, wq, sw, scale, shift, out, k, inv, eff_scale, act):
    """One launch on the current stream of x's device, uncounted: x (M, K)
    contiguous, wq (N, Kp) int8 and sw (N,) from :func:`kernel_weight`,
    scale and shift float32 (N,) or None, out (M, N) in x's type. The C
    library picks the variant and returns it; the "tma" kernel reads the
    plan, the others ignore it. Returns the variant launched."""
    m = x.shape[0]
    n, kp = wq.shape
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _call(x, wq, sw, scale, shift, out, k, inv, eff_scale, act)
    stream = torch.cuda.current_stream().cuda_stream
    p = plan(m, k, n, _sm_count(x.device.index))
    ws = counters = None
    if p.split > 1 and x.dtype == torch.bfloat16:   # "tma" is bf16 only
        ws, counters = (t.data_ptr() for t in _scratch(x.device, stream))
    code = _library().ctt_matmul_int8(
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), out.data_ptr(), ws,
        counters, m, k, kp, n, inv, eff_scale, ACTS[act], _DTYPES[x.dtype],
        p.bm, p.bn, p.split, p.per, stream)
    if code < 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error "
                           f"{-code} (M={m}, K={k}, N={n}, {x.dtype})")
    return VARIANTS[code]


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
