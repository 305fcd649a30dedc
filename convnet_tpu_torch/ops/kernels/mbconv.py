"""The fused inverted residual (MBConv): MobileNet-V2's stride-1 block.

Counterpart of ``convnet_tpu/ops/pallas/mbconv.py``. Its three Pallas
kernels become the three modes of one CUDA template (``csrc/mbconv.cu``):

- :func:`mbconv_full` (``_build_full``): the whole block with folded BN,
  y = act_out((u2 @ wp) * s3 + t3 [+ x]);
- :func:`mbconv_stats` (``_build_stats``): the per-channel (Σ, Σ²) of the
  depthwise output d;
- :func:`mbconv_raw` (``_build_raw``): h3 = u2 @ wp and its (Σ, Σ²),
  taken from the float32 values before h3 is rounded to x's type;

with u1 = act_mid(x @ we * s1 + t1) zero outside the image (the mask comes
after the BN and the activation; without an expand stage u1 = x), d the
9-tap depthwise of u1 in float32, and u2 = act_mid(d * s2 + t2) rounded to
x's type. we and wp are cast to x's type, the depthwise weight ``wd9``
(9, Ch) and the scales and shifts are float32, as in the reference.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version below, which is also the kernel's oracle in the
on-card checks. ``full_launches``, ``stats_launches`` and ``raw_launches``
count kernel launches only. The C library picks the kernel by a shape rule
(:func:`variant`): bf16 with Cin and Cout multiples of 8 (Cout <= 320), Ch
a multiple of 4, an expand stage or Cin == Ch, and a 16-byte aligned x runs
the tensor-core
kernel, which takes the weights packed by :func:`pack_expand` and
:func:`pack_project` (made once per weight version, ``_prepared``), an
output tile of at most 8 x 8 (:func:`tc_tile`) and a split of the hidden
channels where the tiles alone cannot fill the card (:func:`plan`);
float32 and other shapes run the CUDA-core kernel (:func:`tile`).

Above the kernels, as in the reference: :func:`mbconv_infer`,
:func:`mbconv_train_forward` (the expand-BN moments from the Gram trick, the
stats pass, the raw pass, and the last BN in plain ops) and
:func:`mbconv_train`, differentiable, whose backward recomputes the unfused
composition :func:`_unfused` and differentiates it (``mbconv.py:468-528``);
its depthwise conv runs the port's ``depthwise_conv2d``, so on the card the
recompute and its stride-1 dx launch that kernel (two launches a block).
Only stride 1, a 3x3 depthwise and dilation 1 are fused (:func:`supported`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from convnet_tpu_torch import ops
from convnet_tpu_torch.ops.kernels import _build, _prepared
from convnet_tpu_torch.ops.kernels.depthwise_conv import depthwise_conv2d
from convnet_tpu_torch.parallel.mesh import group_mean, group_size

ACTS = {"none": 0, "relu": 1, "relu6": 2}
MODES = {"full": 0, "stats": 1, "raw": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA-core kernel's limits: a tile of at most MAX_Q output and MAX_P
# haloed pixels; each thread keeps 8 pixels x 10 groups of 32 output
# channels
MAX_Q, MAX_P, MAX_COUT = 64, 104, 320
CHUNK = 32
SMEM_LIMIT = 232448      # bytes of shared memory a block may have (H100)
# the tensor-core kernel's: output tiles of at most TC_TILE x TC_TILE, hidden
# chunks of TC_CHUNK, at most TC_MAX_SPLIT hidden slabs, Cout parts of one
# of TC_COUT_BLOCKS channels
TC_TILE, TC_CHUNK, TC_MAX_SPLIT = 8, 32, 8
TC_COUT_BLOCKS = (32, 64, 96, 160)

full_launches = 0   # Full kernel launches since the last reset (set to 0)
stats_launches = 0  # Stats kernel launches since the last reset
raw_launches = 0    # Raw kernel launches since the last reset


def supported(stride, kernel, dilation=1):
    """The reference's rule (``mbconv.py:549``): stride 1, 3x3, dilation 1."""
    def pair(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v)
    return (pair(stride) == (1, 1) and pair(kernel) == (3, 3)
            and pair(dilation) == (1, 1))


def _act(v, kind):
    if kind == "relu":
        return torch.clamp_min(v, 0.0)
    if kind == "relu6":
        return torch.clamp(v, 0.0, 6.0)
    return v


# ----------------------------------------------------------- plain versions

def _depthwise_out(x, we, s1, t1, wd9, act_mid):
    """d, the float32 depthwise output: u1 is zero-padded after the BN and
    the activation, and the 9 taps are added di outer, dj inner."""
    _, h, w, cin = x.shape
    if we is None:
        u1 = x.float()
    else:
        e = x.reshape(-1, cin).float() @ we.to(x.dtype).float()
        u1 = _act(e.view(*x.shape[:3], -1) * s1 + t1, act_mid)
    u1 = F.pad(u1, (0, 0, 1, 1, 1, 1))
    d = None
    for di in range(3):
        for dj in range(3):
            term = u1[:, di:di + h, dj:dj + w, :] * wd9[3 * di + dj]
            d = term if d is None else d + term
    return d


def _project(x, we, s1, t1, wd9, s2, t2, wp, act_mid):
    """u2 @ wp in float32, u2 rounded to x's type first."""
    d = _depthwise_out(x, we, s1, t1, wd9, act_mid)
    u2 = _act(d * s2 + t2, act_mid).to(x.dtype)
    ch = u2.shape[-1]
    return (u2.reshape(-1, ch).float() @ wp.to(x.dtype).float()).view(
        *x.shape[:3], -1)


def _sums(v):
    v = v.reshape(-1, v.shape[-1])
    return torch.stack([v.sum(0), (v * v).sum(0)])


def mbconv_full_plain(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, *, residual,
                      act_mid="relu6", act_out="none"):
    y = _project(x, we, s1, t1, wd9, s2, t2, wp, act_mid) * s3 + t3
    if residual:
        y = y + x.float()
    return _act(y, act_out).to(x.dtype)


def mbconv_stats_plain(x, we, s1, t1, wd9, *, act_mid="relu6"):
    return _sums(_depthwise_out(x, we, s1, t1, wd9, act_mid))


def mbconv_raw_plain(x, we, s1, t1, wd9, s2, t2, wp, *, act_mid="relu6"):
    h3 = _project(x, we, s1, t1, wd9, s2, t2, wp, act_mid)
    return h3.to(x.dtype), _sums(h3)


# ------------------------------------------------------------------ kernels

@functools.cache
def tile(h, w):
    """The CUDA-core kernel's output tile (TH, TW) for an H x W image: at
    most MAX_Q pixels and MAX_P haloed ones, the fewest haloed plus output
    pixels over the whole image (the expand runs on the halo, the rest on
    the tile)."""
    best = None
    for tw in range(1, min(w, 16) + 1):
        for th in range(1, min(h, MAX_Q // tw) + 1):
            if (th + 2) * (tw + 2) > MAX_P:
                break
            tiles = -(-h // th) * -(-w // tw)
            cost = (tiles * ((th + 2) * (tw + 2) + th * tw), -th * tw)
            if best is None or cost < best[0]:
                best = (cost, (th, tw))
    return best[1]


def smem_bytes(th, tw, cin, cout, expand, with_project):
    """The CUDA-core kernel's shared memory at this tile (``smem_bytes``
    in the .cu)."""
    p = (th + 2) * (tw + 2)
    cin_pad = -(-cin // 4) * 4
    floats = p * cin_pad + p * CHUNK + MAX_Q * CHUNK
    if expand:
        floats += cin_pad * CHUNK
    if with_project:
        floats += CHUNK * 32 * -(-cout // 32)
    return floats * 4


@functools.cache
def tc_tile(h, w):
    """The tensor-core kernel's output tile (TH, TW) for an H x W image: at
    most TC_TILE a side (a warp per column, four m16 tiles of output
    pixels), the fewest haloed plus output pixels over the whole image."""
    best = None
    for tw in range(1, min(w, TC_TILE) + 1):
        for th in range(1, min(h, TC_TILE) + 1):
            tiles = -(-h // th) * -(-w // tw)
            cost = (tiles * ((th + 2) * (tw + 2) + th * tw), -th * tw)
            if best is None or cost < best[0]:
                best = (cost, (th, tw))
    return best[1]


def cout_block(cout):
    """Output channels a part of the tensor-core kernel's project: the
    Cout class it is instantiated for (2, 4, 6 or 10 n8 fragments a warp,
    two warps across a part); Cout above 160 takes several parts."""
    return next((c for c in TC_COUT_BLOCKS if cout <= c), TC_COUT_BLOCKS[-1])


def tc_smem_bytes(th, tw, cin, cout, expand, mode):
    """The tensor-core kernel's shared memory at this tile (``tc_smem`` in
    the .cu): two staged x tiles (bf16 rows of Cin rounded up to 16, plus
    8), a chunk of each packed weight, u1 (float32), u2 (bf16), the
    sums' scratch and two chunks' per-channel vectors (13 rows of 32
    float32: s1, t1, s2, t2 and the 9 taps)."""
    p = (th + 2) * (tw + 2)
    row = -(-cin // 16) * 16 + 8
    hs = TC_CHUNK + 8
    cb = cout_block(cout) if mode != "stats" else 0
    n = 2 * p * row * 2 + p * hs * 4
    if expand:
        n += TC_CHUNK * row * 2
    if mode != "stats":
        n += cb * hs * 2 + 64 * hs * 2
    n += {"stats": 2 * 8 * TC_CHUNK * 4, "raw": 2 * 4 * cb * 4,
          "full": 0}[mode]
    return n + 2 * 13 * TC_CHUNK * 4


@functools.cache
def split(tiles, ch, cout, mode, sms):
    """Hidden slabs of the tensor-core kernel: as many as keep two blocks on
    every SM busy where the tiles (times the Cout parts) alone cannot, at
    most TC_MAX_SPLIT and one chunk each, whole chunks a slab and no slab
    empty."""
    chunks = -(-ch // TC_CHUNK)
    parts = 1 if mode == "stats" else -(-cout // cout_block(cout))
    n = max(1, min(TC_MAX_SPLIT, chunks, 2 * sms // (tiles * parts)))
    per = -(-chunks // n)
    return -(-chunks // per)


class Plan(NamedTuple):
    """How a call runs: the kernel, its output tile, the tiles over the
    batch (the rows of the partial sums) and the hidden slabs."""
    kind: str
    tile: tuple
    tiles: int
    split: int


def plan(mode, x_shape, ch, cout, kind, sms):
    """The launch's plan for x of ``x_shape`` on the kernel ``kind`` of a
    card with ``sms`` SMs."""
    b, h, w, _ = x_shape
    th, tw = tc_tile(h, w) if kind == "tensor_cores" else tile(h, w)
    tiles = b * -(-h // th) * -(-w // tw)
    slabs = split(tiles, ch, cout, mode, sms) if kind == "tensor_cores" \
        else 1
    return Plan(kind, (th, tw), tiles, slabs)


def pack_expand(we, dtype):
    """The tensor-core kernel's expand weight: (Cin, Ch) → (Ch, Cin) in
    ``dtype``, Ch rounded up to TC_CHUNK and Cin to 16 with zeros, so each
    chunk's rows are the mma's B operand with K contiguous."""
    cin, ch = we.shape
    out = we.new_zeros((-(-ch // TC_CHUNK) * TC_CHUNK, -(-cin // 16) * 16),
                       dtype=dtype)
    out[:ch, :cin] = we.t().to(dtype)
    return out


def pack_project(wp, dtype):
    """The tensor-core kernel's project weight: (Ch, Cout) → (Cout, Ch) in
    ``dtype``, Ch rounded up to TC_CHUNK with zeros."""
    ch, cout = wp.shape
    out = wp.new_zeros((cout, -(-ch // TC_CHUNK) * TC_CHUNK), dtype=dtype)
    out[:, :ch] = wp.t().to(dtype)
    return out


def _check(x, we, s1, t1, wd9, s2=None, t2=None, wp=None, s3=None, t3=None,
           *, residual=False, act_mid="relu6", act_out="none"):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    for name, kind in (("act_mid", act_mid), ("act_out", act_out)):
        if kind not in ACTS:
            raise ValueError(f"{name}={kind!r}: choose from {sorted(ACTS)}")
    cin = x.shape[-1]
    if wd9.dim() != 2 or wd9.shape[0] != 9:
        raise ValueError(f"wd9 must be (9, Ch), got {tuple(wd9.shape)}")
    ch = wd9.shape[1]
    if we is None:
        if cin != ch:
            raise ValueError(f"without an expand stage Cin ({cin}) must equal "
                             f"the hidden width ({ch})")
    elif tuple(we.shape) != (cin, ch):
        raise ValueError(f"we must be (Cin, Ch) = {(cin, ch)}, got "
                         f"{tuple(we.shape)}")
    vecs = [("s2", s2, ch), ("t2", t2, ch)]
    if we is not None:
        vecs += [("s1", s1, ch), ("t1", t1, ch)]
    if wp is not None:
        if wp.dim() != 2 or wp.shape[0] != ch:
            raise ValueError(f"wp must be (Ch, Cout) with Ch = {ch}, got "
                             f"{tuple(wp.shape)}")
        cout = wp.shape[1]
        vecs += [("s3", s3, cout), ("t3", t3, cout)]
        if residual and cout != cin:
            raise ValueError(f"a residual block needs Cin == Cout, got "
                             f"{cin} and {cout}")
    for name, v, n in vecs:
        if v is not None and v.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(v.shape)}")


@functools.cache
def _kernels():
    lib = _build.library("mbconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    full = lib.ctt_mbconv_full
    full.argtypes = [p] * 12 + [i] * 13 + [p]
    stats = lib.ctt_mbconv_stats
    stats.argtypes = [p] * 7 + [i] * 10 + [p]
    raw = lib.ctt_mbconv_raw
    raw.argtypes = [p] * 12 + [i] * 11 + [p]
    which = lib.ctt_mbconv_variant
    which.argtypes = [i] * 6 + [p]
    for fn in (full, stats, raw, which):
        fn.restype = ctypes.c_int
    return {"full": full, "stats": stats, "raw": raw, "variant": which}


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def variant(mode, x, ch, cout, expand):
    """The kernel that runs for x (CUDA) in ``mode``: "tensor_cores" or
    "cuda_cores", by the C library's shape rule."""
    tc = _kernels()["variant"](MODES[mode], x.shape[-1], ch, cout,
                               int(expand), _DTYPES[x.dtype], x.data_ptr())
    return "tensor_cores" if tc else "cuda_cores"


def _float32(v):
    """v as a contiguous float32 tensor on a 16-byte boundary (the
    tensor-core kernel copies its rows with 16-byte cp.async); a copy is
    made once per version."""
    if v is None or (v.dtype == torch.float32 and v.is_contiguous()
                     and v.data_ptr() % 16 == 0):
        return v
    return _prepared.get("mbconv.float32", (v,), lambda v: torch.empty(
        v.shape, dtype=torch.float32, device=v.device).copy_(v))


def kernel_args(x, we, s1, t1, wd9, s2=None, t2=None, wp=None, s3=None,
                t3=None, *, mode):
    """Checks that a kernel can take these tensors and returns them in its
    layouts: x contiguous; we and wp in x's type, packed for the
    tensor-core kernel (:func:`pack_expand`, :func:`pack_project`) or
    contiguous for the CUDA-core one; the rest float32. Also the launch's
    :class:`Plan`. Raises on a device without a kernel and on a shape
    beyond the kernels' limits, naming it."""
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"no kernel for {x.dtype}: float32 or bfloat16 only")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements: the kernel's 32-bit "
                         f"pixel offsets need fewer than 2^31")
    x = x.contiguous()
    b, h, w, cin = x.shape
    ch = wd9.shape[1]
    cout = wp.shape[1] if wp is not None else 0
    kind = variant(mode, x, ch, cout, we is not None)
    dt = x.dtype
    if kind == "tensor_cores":
        we_k = None if we is None else _prepared.get(
            ("mbconv.we", dt), (we,), lambda w: pack_expand(w, dt))
        wp_k = None if wp is None else _prepared.get(
            ("mbconv.wp", dt), (wp,), lambda w: pack_project(w, dt))
    else:
        if wp is not None and cout > MAX_COUT:
            raise ValueError(f"Cout = {cout}: the kernel takes at most "
                             f"{MAX_COUT} output channels")
        th, tw = tile(h, w)
        need = smem_bytes(th, tw, cin, cout, we is not None, mode != "stats")
        if need > SMEM_LIMIT:
            raise ValueError(f"Cin = {cin}, Cout = {cout}: the kernel needs "
                             f"{need} bytes of shared memory, above "
                             f"{SMEM_LIMIT}")
        we_k = None if we is None else we.to(dt).contiguous()
        wp_k = None if wp is None else wp.to(dt).contiguous()
    tensors = [x, we_k, *(_float32(v) for v in (s1, t1, wd9, s2, t2)), wp_k,
               *(_float32(v) for v in (s3, t3))]
    for v in tensors:
        if v is not None and v.device != x.device:
            raise ValueError(f"an argument is on {v.device}, x on {x.device}")
    sms = _sms(x.device.index if x.device.index is not None
               else torch.cuda.current_device())
    return tensors, plan(mode, x.shape, ch, cout, kind, sms)


def _ptr(t):
    return None if t is None else t.data_ptr()


def call(mode, tensors, run, outs, *, residual=False, act_mid="relu6",
         act_out="none"):
    """One launch on the current stream of x's device, uncounted.
    ``tensors`` and ``run`` (the :class:`Plan`) from :func:`kernel_args`;
    ``outs`` from :func:`outputs`: (y, part) for Full, (partials, sums)
    for Stats, (h3, part, partials, sums) for Raw. Cout is y's (or h3's)
    last dimension: the packed project weight is (Cout, Ch)."""
    x, we, s1, t1, wd9, s2, t2, wp, s3, t3 = tensors
    b, h, w, cin = x.shape
    ch = wd9.shape[1]
    (th, tw), slabs = run.tile, run.split
    fn = _kernels()[mode]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = [_ptr(v) for v in (x, we, s1, t1, wd9)]
        dt = _DTYPES[x.dtype]
        if mode == "full":
            err = fn(*head, _ptr(s2), _ptr(t2), _ptr(wp), _ptr(s3), _ptr(t3),
                     *(_ptr(o) for o in outs), b, h, w, cin, ch,
                     outs[0].shape[-1], th, tw, slabs, int(residual),
                     ACTS[act_mid], ACTS[act_out], dt, stream)
        elif mode == "stats":
            err = fn(*head, *(_ptr(o) for o in outs), b, h, w, cin, ch, th,
                     tw, slabs, ACTS[act_mid], dt, stream)
        else:
            err = fn(*head, _ptr(s2), _ptr(t2), _ptr(wp),
                     *(_ptr(o) for o in outs), b, h, w, cin, ch,
                     outs[0].shape[-1], th, tw, slabs, ACTS[act_mid], dt,
                     stream)
    if err != 0:
        raise RuntimeError(f"mbconv {mode} kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, Ch {ch}, {run}, "
                           f"{x.dtype})")


def outputs(mode, x, ch, cout, run):
    """The kernel's output and scratch tensors for ``call`` under the
    :class:`Plan` ``run``."""
    b, h, w, _ = x.shape
    c = ch if mode == "stats" else cout
    sums = [torch.empty((run.tiles, 2, c), dtype=torch.float32,
                        device=x.device),
            torch.empty((2, c), dtype=torch.float32, device=x.device)]
    if mode == "stats":
        return sums
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    part = None if run.split == 1 else torch.empty(
        (run.split, b * h * w, cout), dtype=torch.float32, device=x.device)
    return [y, part] + (sums if mode == "raw" else [])


def _on_cpu(x):
    if x.device.type == "cpu":
        return True
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    return False


def mbconv_full(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, *, residual,
                act_mid="relu6", act_out="none"):
    """The whole block with folded BN: x (B, H, W, Cin); we (Cin, Ch) or
    None; wd9 (9, Ch); wp (Ch, Cout); s*, t* float32. y in x's type. While
    ``torch.export`` traces, this is the registered op
    ``convnet_tpu_torch::mbconv_full``, whose implementation is the same
    launch (or the plain version on the CPU)."""
    _check(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, residual=residual,
           act_mid=act_mid, act_out=act_out)
    if torch.compiler.is_compiling():
        return _full_op(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, residual,
                        act_mid, act_out)
    return _full(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, residual, act_mid,
                 act_out)


@torch.library.custom_op("convnet_tpu_torch::mbconv_full", mutates_args=())
def _full_op(x: torch.Tensor, we: Optional[torch.Tensor],
             s1: Optional[torch.Tensor], t1: Optional[torch.Tensor],
             wd9: torch.Tensor, s2: torch.Tensor, t2: torch.Tensor,
             wp: torch.Tensor, s3: torch.Tensor, t3: torch.Tensor,
             residual: bool, act_mid: str, act_out: str) -> torch.Tensor:
    return _full(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, residual, act_mid,
                 act_out)


@_full_op.register_fake
def _(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, residual, act_mid, act_out):
    return x.new_empty((*x.shape[:3], wp.shape[1]))


def _full(x, we, s1, t1, wd9, s2, t2, wp, s3, t3, residual, act_mid,
          act_out):
    global full_launches
    if _on_cpu(x):
        return mbconv_full_plain(x, we, s1, t1, wd9, s2, t2, wp, s3, t3,
                                 residual=residual, act_mid=act_mid,
                                 act_out=act_out)
    tensors, run = kernel_args(x, we, s1, t1, wd9, s2, t2, wp, s3, t3,
                               mode="full")
    outs = outputs("full", x, wd9.shape[1], wp.shape[1], run)
    call("full", tensors, run, outs, residual=residual, act_mid=act_mid,
         act_out=act_out)
    full_launches += 1
    return outs[0]


def mbconv_stats(x, we, s1, t1, wd9, *, act_mid="relu6"):
    """(2, Ch) float32: Σ and Σ² over every pixel of the depthwise output."""
    global stats_launches
    _check(x, we, s1, t1, wd9, act_mid=act_mid)
    if _on_cpu(x):
        return mbconv_stats_plain(x, we, s1, t1, wd9, act_mid=act_mid)
    tensors, run = kernel_args(x, we, s1, t1, wd9, mode="stats")
    outs = outputs("stats", x, wd9.shape[1], 0, run)
    call("stats", tensors, run, outs, act_mid=act_mid)
    stats_launches += 1
    return outs[1]


def mbconv_raw(x, we, s1, t1, wd9, s2, t2, wp, *, act_mid="relu6"):
    """(h3 in x's type, (2, Cout) float32 Σ and Σ² of h3 before rounding)."""
    global raw_launches
    _check(x, we, s1, t1, wd9, s2, t2, wp, act_mid=act_mid)
    if _on_cpu(x):
        return mbconv_raw_plain(x, we, s1, t1, wd9, s2, t2, wp,
                                act_mid=act_mid)
    tensors, run = kernel_args(x, we, s1, t1, wd9, s2, t2, wp, mode="raw")
    outs = outputs("raw", x, wd9.shape[1], wp.shape[1], run)
    call("raw", tensors, run, outs, act_mid=act_mid)
    raw_launches += 1
    return outs[0], outs[3]


# ------------------------------------------------ the reference's wrappers

def _wd9(wd):
    """(3, 3, 1, Ch) HWIO or (9, Ch) → (9, Ch) float32."""
    return wd.reshape(9, wd.shape[-1]).float()


def mbconv_infer(x, we, s1, t1, wd, s2, t2, wpj, s3, t3, *, residual,
                 act_mid="relu6", act_out="none"):
    """Whole inverted-residual block with folded (inference) BN
    (``mbconv.py:334``). x (B, H, W, Cin) NHWC; we (Cin, Ch) or None; wd
    (3, 3, 1, Ch) or (9, Ch); wpj (Ch, Cout); s*/t* float32 per-channel
    scale and shift. Stride-1 3x3 depthwise only."""
    ch = wd.shape[-1]
    return mbconv_full(x, we, s1, t1, _wd9(wd), s2, t2,
                       wpj.reshape(ch, -1), s3, t3, residual=residual,
                       act_mid=act_mid, act_out=act_out)


def _finalize(sums, n):
    mean = sums[0] / n
    var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
    return mean, var


def _fold(gamma, beta, mean, var, eps):
    s = gamma.float() * torch.rsqrt(var + eps)
    t = beta.float() - mean * s
    return s, t


def _gram_stats(x, we):
    """Expand-BN batch moments without materializing h = x @ we:
    Σh = (Σx) @ we and Σh² = diag(weᵀ (XᵀX) we). X is cast to float32
    first: a bf16 product would round the Gram matrix to bf16."""
    n = x.numel() // x.shape[-1]
    xf = x.reshape(n, -1).float()
    we32 = we.float()
    sx = xf.sum(0)
    gram = xf.t() @ xf
    m = gram @ we32                      # (Cin, Ch)
    ex2 = (we32 * m).sum(0) / n          # diag(weᵀ G we) / N
    mean = (sx @ we32) / n
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    return mean, var


def mbconv_train_forward(x, we, g1, b1, wd, g2, b2, wpj, g3, b3, *,
                         eps=1e-5, residual=True, act_mid="relu6",
                         act_out="none", group=None):
    """Training-mode fused forward (``mbconv.py:386``). Returns (out,
    stats), stats = ((mean1, var1) or None without an expand stage,
    (mean2, var2), (mean3, var3)): the biased batch moments of the three
    BNs, for the running-statistics updates. Not differentiable: see
    :func:`mbconv_train`.

    ``group`` (sync-BN, the reference's ``axis_name``): the expand stage's
    Gram moments are averaged over the group, the Stats kernel's sums are
    summed over it before the Raw kernel is launched, and the Raw kernel's
    sums before the final fold, each over n · world values."""
    n = x.numel() // x.shape[-1]
    ch = wd.shape[-1]
    if we is not None:
        mean1, var1 = _gram_stats(x, we)
        if group is not None:
            mean1, ex2 = group_mean(torch.stack([mean1,
                                                 var1 + mean1 * mean1]),
                                    group).unbind()
            var1 = torch.clamp_min(ex2 - mean1 * mean1, 0.0)
        s1, t1 = _fold(g1, b1, mean1, var1, eps)
        stats1 = (mean1, var1)
    else:
        s1 = t1 = stats1 = None
    wd9 = _wd9(wd)
    sums2 = mbconv_stats(x, we, s1, t1, wd9, act_mid=act_mid)
    if group is not None:
        dist.all_reduce(sums2, group=group)
    n2 = n * group_size(group)
    mean2, var2 = _finalize(sums2, n2)
    s2, t2 = _fold(g2, b2, mean2, var2, eps)
    h3, sums3 = mbconv_raw(x, we, s1, t1, wd9, s2, t2, wpj.reshape(ch, -1),
                           act_mid=act_mid)
    if group is not None:
        dist.all_reduce(sums3, group=group)
    mean3, var3 = _finalize(sums3, n2)
    s3, t3 = _fold(g3, b3, mean3, var3, eps)
    y = h3.float() * s3 + t3
    if residual:
        y = y + x.float()
    y = _act(y, act_out)
    return y.to(x.dtype), (stats1, (mean2, var2), (mean3, var3))


# ------------------------------------------- the unfused composition, VJP

def _bn_train_apply(v, gamma, beta, eps, group=None):
    v32 = v.float()
    dims = tuple(range(v.dim() - 1))
    mean = v32.mean(dim=dims)
    ex2 = (v32 * v32).mean(dim=dims)
    if group is not None:
        mean, ex2 = group_mean(torch.stack([mean, ex2]), group).unbind()
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    s = gamma.float() * torch.rsqrt(var + eps)
    return (v32 - mean) * s + beta.float()


def _grad_act(v, kind):
    """The activations with the reference's gradients (``ops.relu6``)."""
    if kind == "relu6":
        return ops.relu6(v)
    if kind == "relu":
        return ops.relu(v)
    return v


def _unfused(x, we, g1, b1, wd, g2, b2, wpj, g3, b3, *, eps, residual,
             act_mid, act_out, group=None):
    """The block layer by layer with batch-statistics BN (``mbconv.py:468``),
    the rounding points of the reference: each product in float32 from
    operands in x's type, each BN in float32, the activations cast to x's
    type. The depthwise conv runs ``depthwise_conv2d`` in float32 on the
    x-typed values, which is the reference's ``preferred_element_type``.
    ``group``: each BN's moments averaged over it (sync-BN)."""
    ch = wd.shape[-1]
    v = x
    if we is not None:
        h1 = x.float() @ we.to(x.dtype).float()
        v = _grad_act(_bn_train_apply(h1, g1, b1, eps, group),
                      act_mid).to(x.dtype)
    w_dw = wd.reshape(9, ch).t().reshape(ch, 1, 3, 3).to(x.dtype).float()
    h2 = depthwise_conv2d(v.float(), w_dw, 1, 1)
    u2 = _grad_act(_bn_train_apply(h2, g2, b2, eps, group),
                   act_mid).to(x.dtype)
    h3 = u2.float() @ wpj.reshape(ch, -1).to(x.dtype).float()
    y = _bn_train_apply(h3, g3, b3, eps, group)
    if residual:
        y = y + x.float()
    return _grad_act(y, act_out).to(x.dtype)


class _MBConvTrain(torch.autograd.Function):
    """Forward: the kernels. Backward: the VJP of :func:`_unfused`, which
    recomputes the block from its inputs (only they are saved)."""

    @staticmethod
    def forward(ctx, conf, stats_out, x, we, g1, b1, wd, g2, b2, wpj, g3, b3):
        args = (x, we, g1, b1, wd, g2, b2, wpj, g3, b3)
        ctx.save_for_backward(*args)
        ctx.conf = conf
        y, stats = mbconv_train_forward(*args, **conf)
        stats_out.extend(stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [None if t is None else t.detach().requires_grad_(n)
                    for t, n in zip(saved, needs)]
            y = _unfused(*args, **ctx.conf)
            wanted = [a for a, n in zip(args, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, dy.to(y.dtype)))
        return (None, None, *(next(grads) if n else None for n in needs))


def mbconv_train(x, we, g1, b1, wd, g2, b2, wpj, g3, b3, *, eps=1e-5,
                 residual=True, act_mid="relu6", act_out="none", group=None):
    """Differentiable fused training block (``mbconv.py:531``): the forward
    runs the kernels, the backward recomputes through :func:`_unfused`
    (exact gradients of the block's definition). Without an expand stage
    pass ``we = g1 = b1 = None``. Returns (out, stats) as
    :func:`mbconv_train_forward`; the statistics carry no gradient.
    ``group``: sync-BN over that process group, in the forward's kernels'
    sums and in the recompute's moments alike."""
    stats = []
    conf = dict(eps=float(eps), residual=bool(residual), act_mid=act_mid,
                act_out=act_out, group=group)
    y = _MBConvTrain.apply(conf, stats, x, we, g1, b1, wd, g2, b2, wpj, g3,
                           b3)
    return y, tuple(stats)
