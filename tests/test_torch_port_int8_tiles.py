"""The int8 1x1's TMA + wgmma kernel (``csrc/matmul_int8.cu``, variant
"tma") on the CPU: its tile rule, its split of K and its arithmetic,
emulated in plain torch and numpy against the wrapper's plain version.

The kernel cannot run here. What it computes is held three ways:
- ``matmul_int8.plan``, the one definition of its tile shape and split of
  K, at every int8 path shape of ResNet-50 and MobileNet-V2 (read from the
  port's models, as ``chip_smoke.py`` reads them on the card) at batch 64
  and 1, and at ``chip_smoke.INT8_RAGGED``: each output element in one tile,
  K in whole 32-byte steps, each step in one range, and at M = 3,136 enough
  work units for 132 SMs;
- its quantizing prologue (bf16x2 product, clamp in bf16, half-to-even by
  the float32 add of 1.5 * 2^23, the low byte) bit-equal to
  ``quantize_act``, ties and saturation included;
- split K: int32 partial sums over the plan's ranges, added in any order,
  equal ``int8_sums``, and the epilogue over them equals
  ``matmul_int8_plain`` (bit for bit in float32; in bf16 within the
  kernel's tolerance, ``chip_smoke.INT8_TOL``: the kernel does not round the
  dequantized value to bf16 before the scale and shift).
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from convnet_tpu_torch import models
from convnet_tpu_torch.nn import Conv2d, quant
from convnet_tpu_torch.ops.kernels import _build
from convnet_tpu_torch.ops.kernels import matmul_int8 as mi

SMS = 132   # an H100's SMs
BATCH = chip_smoke.SERVE_BATCH
MODELS = {"resnet50": ("resnet", {"depth": 50}),
          "mobilenet_v2": ("mobilenet_v2", {})}


@pytest.fixture(scope="module")
def path_shapes():
    """(M, K, N, batch) of every eligible 1x1 of the two int8 models at
    224², at batch 64 and 1, read through ``Conv2d.int8_scale`` during
    calibration (one image: M scales with the batch)."""
    shapes = set()
    real = Conv2d.int8_scale

    def spy(self, x):
        if self.quant is not None and quant.conv_eligible(self, x.shape):
            shapes.add((x.numel() // x.shape[-1], x.shape[-1],
                        self.out_channels))
        return real(self, x)

    Conv2d.int8_scale = spy
    try:
        for name, config in MODELS.values():
            torch.manual_seed(0)
            model = models.build(name, **config).eval()
            quant.calibrate(model, [torch.zeros(1, 224, 224, 3)])
    finally:
        Conv2d.int8_scale = real
    return sorted((m * b, k, n, b) for m, k, n in shapes for b in (BATCH, 1))


def all_shapes(path_shapes):
    return [s[:3] for s in path_shapes] + [
        (m, k, n) for m, k, n, _ in chip_smoke.INT8_RAGGED]


def k_ranges(p):
    """The K steps of each split range, as the kernel walks them."""
    return [range(s * p.per, min((s + 1) * p.per, p.ksteps))
            for s in range(p.split)]


def test_the_paths_are_the_ones_served(path_shapes):
    """33 and 34 int8 launches a forward over 12 + 26 distinct shapes at
    batch 64, every one with K and N multiples of 8 (the TMA kernel's)."""
    at64 = [s for s in path_shapes if s[3] == BATCH]
    assert len(at64) >= 30
    assert all(k % 8 == 0 and n % 8 == 0 for _, k, n, _ in path_shapes)


def test_plan_covers_each_output_once(path_shapes):
    for m, k, n in all_shapes(path_shapes):
        p = mi.plan(m, k, n, SMS)
        assert p.bm in (64, 128) and p.bn % 16 == 0 and 16 <= p.bn <= 128
        assert (p.m_tiles - 1) * p.bm < m <= p.m_tiles * p.bm, (m, k, n)
        assert (p.n_tiles - 1) * p.bn < n <= p.n_tiles * p.bn, (m, k, n)
        assert p.n_tiles == -(-n // p.bn)   # the C library's count
        if n <= 64:
            assert p.bn == 16 * -(-n // 16)   # the narrow tile


def test_plan_covers_k_once_in_whole_steps(path_shapes):
    for m, k, n in all_shapes(path_shapes):
        p = mi.plan(m, k, n, SMS)
        assert (p.ksteps - 1) * mi.STEP_K < k <= p.ksteps * mi.STEP_K
        assert p.per % 2 == 0    # each range starts on a 64-wide slice
        steps = [s for r in k_ranges(p) for s in r]
        assert steps == list(range(p.ksteps)), (m, k, n, p)
        assert all(len(r) > 0 for r in k_ranges(p))
        if p.split > 1:
            assert all(len(r) >= mi.MIN_SPLIT_STEPS
                       for r in k_ranges(p)[:-1])
        if k <= 32:
            assert p.ksteps == 1    # one 32-byte step, not a half-zero slice


def test_plan_fills_the_sms_at_m_3136(path_shapes):
    """The 7x7 maps at batch 64 (M = 3,136): 128-row tiles would leave SMs
    idle, so 64-row tiles and, where still too few, split K."""
    small = [(m, k, n) for m, k, n, b in path_shapes
             if m == 3136 and b == BATCH]
    assert len(small) >= 6
    for m, k, n in small:
        p = mi.plan(m, k, n, SMS)
        assert p.units >= SMS, (m, k, n, p)
        if p.m_tiles * p.n_tiles < SMS:
            assert p.split > 1 and p.bm == 64


def test_plan_is_a_pure_function_of_shape_and_sms():
    assert mi.plan(3136, 576, 160, 132) == mi.plan(3136, 576, 160, 132)
    wide = mi.plan(3136, 576, 160, 132)
    assert (wide.bm, wide.bn, wide.split) == (64, 80, 2)
    assert mi.plan(200704, 64, 256, 132).bm == 128
    assert mi.plan(12544, 96, 576, 132).bm == 128     # K < LONG_K
    assert mi.plan(12544, 1024, 256, 132).bm == 64    # a long K loop
    assert mi.plan(3136, 576, 160, 8).split == 1    # few SMs: no split


@pytest.mark.parametrize("sms", [132, 114, 78, 16])
def test_split_k_fits_the_fixed_workspace(path_shapes, sms):
    """Every plan that splits K, at the path shapes and over a sweep of M,
    K and N, fits ``scratch_bound``: the workspace is made once a stream at
    that size and never grows. The sweep holds the largest split plans: N
    of one full 128-wide tile, M just under the SMs' 64-row tiles."""
    sweep = {(64 * t - r, k, n) for t in range(1, sms + 1) for r in (0, 63)
             for k in (256, 1024, 4096) for n in (16, 120, 128, 136, 512)}
    shapes = set(all_shapes(path_shapes)) | sweep
    sums, counters = mi.scratch_bound(sms)
    split, full = 0, 0
    for m, k, n in shapes:
        p = mi.plan(m, k, n, sms)
        if p.split == 1:
            continue
        split += 1
        tiles = p.m_tiles * p.n_tiles
        assert p.bm == 64 and tiles < sms, (m, k, n, p)
        assert tiles * p.bm * p.bn <= sums, (m, k, n, p)
        assert tiles * p.bm // 64 <= counters, (m, k, n, p)
        full += tiles * p.bm * p.bn == sums
    assert split > 100 and full > 0   # the bound is reached, not loose


def kernel_quantize(x, inv):
    """The kernel's prologue in torch: the product rounded to bf16, the
    clamp in bf16, 1.5 * 2^23 added in float32, the low byte."""
    p = torch.clamp(x * inv, -127, 127)
    bits = (p.float() + 12582912.0).view(torch.int32) & 0xFF
    return ((bits ^ 0x80) - 0x80).to(torch.int8)


@pytest.mark.parametrize("act_scale", [1 / 2, 1 / 3, 0.0137, 2.5])
def test_kernel_quantize_is_quantize_act_bit_for_bit(act_scale):
    rng = np.random.default_rng(7)
    inv, _ = mi.inverse_scale(act_scale, torch.bfloat16)
    ties = (np.arange(-260, 261) + 0.5) / inv       # products k + 1/2
    x = np.concatenate([rng.standard_normal(4096) * 130 / inv, ties,
                        [0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30]])
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    want, _ = mi.quantize_act(xb, act_scale)
    assert torch.equal(kernel_quantize(xb, inv), want)


def emulate(x, w, act_scale, scale, shift, act, k, p):
    """The kernel: int8 x and wq (zero beyond K, as TMA and the padded
    weight give them), int32 partial sums over the plan's K ranges added
    in reverse order, the float32 epilogue op by op, x's type."""
    xq, eff = mi.quantize_act(x, act_scale)
    wq, sw = mi.kernel_weight(w)
    width = p.ksteps * mi.STEP_K
    xq = torch.nn.functional.pad(xq, (0, width - k)).numpy().astype(np.int64)
    wq = wq[:, :width].numpy().astype(np.int64)
    acc = np.zeros((x.shape[0], w.shape[0]), np.int32)
    for r in reversed(k_ranges(p)):
        lo, hi = r.start * mi.STEP_K, r.stop * mi.STEP_K
        part = xq[:, lo:hi] @ wq[:, lo:hi].T
        assert np.abs(part).max(initial=0) < 2 ** 31
        acc += part.astype(np.int32)
    acc = torch.from_numpy(acc)
    deq = torch.tensor(eff, dtype=torch.float32) * sw
    y = acc.float() * deq
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    return acc, mi._act(y, act).to(x.dtype)


def split_cases(path_shapes):
    """The batch-1 path shapes whose plan splits K (small enough for numpy),
    and the ragged shapes."""
    split = [(m, k, n, "relu", True) for m, k, n, b in path_shapes
             if b == 1 and mi.plan(m, k, n, SMS).split > 1]
    ragged = [(m, k, n, act, bn) for m, k, n, act in chip_smoke.INT8_RAGGED
              for bn in (True, False)]
    return split + ragged


def test_split_k_sums_equal_int8_sums_and_outputs_the_plain_version(
        path_shapes):
    cases = split_cases(path_shapes)
    assert sum(mi.plan(m, k, n, SMS).split > 4 for m, k, n, *_ in cases) >= 5
    rng = np.random.default_rng(16)
    tol = chip_smoke.INT8_TOL["bf16"]
    for m, k, n, act, bn in cases:
        p = mi.plan(m, k, n, SMS)
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((n, k)) / k ** 0.5)
                             .astype(np.float32))
        scale = shift = None
        if bn:
            scale = torch.from_numpy(rng.uniform(0.5, 1.5, n)
                                     .astype(np.float32))
            shift = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32))
        act_scale = float(x.abs().max()) / 127 * 0.9
        acc, y = emulate(x, w, act_scale, scale, shift, act, k, p)
        xq, _ = mi.quantize_act(x, act_scale)
        wq, _ = mi.quantize_weight_1x1(w)
        assert torch.equal(acc.double(), mi.int8_sums(xq, wq)), (m, k, n)
        assert torch.equal(y, mi.matmul_int8_plain(x, w, act_scale, scale,
                                                   shift, act)), (m, k, n)
        xb = x.to(torch.bfloat16)
        _, yb = emulate(xb, w, act_scale, scale, shift, act, k, p)
        ref = mi.matmul_int8_plain(xb, w, act_scale, scale, shift, act)
        err = (yb.float() - ref.float()).abs()
        assert (err <= tol * (1 + ref.float().abs())).all(), (m, k, n)


def test_variant_names_map_one_to_one_to_the_c_codes():
    """``VARIANTS`` is the C library's own table: the codes and names that
    ``ctt_matmul_int8_variant`` documents, one name a code."""
    text = (_build.SOURCE_DIR / "matmul_int8.cu").read_text()
    doc = text[text.index("// Which kernel ctt_matmul_int8 runs"):
               text.index('extern "C" int ctt_matmul_int8_variant')]
    documented = {int(c): name for c, name in
                  re.findall(r'(\d) "(\w+)"', " ".join(doc.split()))}
    assert documented == mi.VARIANTS
    assert len(set(mi.VARIANTS.values())) == len(mi.VARIANTS)
    assert set(mi.launches_by_variant) == set(mi.VARIANTS.values())
