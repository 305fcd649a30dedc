"""The tensor-core MBConv kernel's plan and arithmetic (``csrc/mbconv.cu``,
``ops/kernels/mbconv.py``), on the CPU.

The kernel cannot run here, so what surrounds it is held instead:

- the Python mirrors of its tile, hidden-split and shared-memory rules, at
  every MobileNet-V2 path shape and every ragged case of ``chip_smoke.py``:
  each tile fits a block's 232,448 bytes (the path's fit two blocks an SM)
  and the tiles cover the image exactly once;
- a plain-torch emulation of its arithmetic (the packed weights, K padded
  with zeros, the hidden channels in chunks of 32 with a ragged last one,
  each slab's chunks added into its own float32 project sum and the slabs
  added in order) against the port's plain versions and against the
  Pallas kernels of ``convnet_tpu/ops/pallas/mbconv.py`` in interpret mode,
  in float32 and bf16, with ``chip_smoke.py``'s tolerances;
- the packed weights against the plain products, and their ``_prepared``
  entries, made once per weight version.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from convnet_tpu.ops.pallas import mbconv as jmb
from convnet_tpu_torch.ops.kernels import _prepared, mbconv

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

SMS = 132  # an H100 SXM
# two blocks an SM, the fewest the kernel is compiled for, fit the SM's
# 233,472 bytes of shared memory where each takes this much or less (1 KB of
# each block's is reserved)
TWO_BLOCKS_SMEM = 233472 // 2 - 1024
# MobileNet-V2's fused blocks at 224²: (H, W, Cin, hidden, Cout, expand,
# residual)
PATH = [(112, 112, 32, 32, 16, False, False),
        (56, 56, 24, 144, 24, True, True),
        (28, 28, 32, 192, 32, True, True),
        (14, 14, 64, 384, 64, True, True),
        (14, 14, 64, 384, 96, True, False),
        (14, 14, 96, 576, 96, True, True),
        (7, 7, 160, 960, 160, True, True),
        (7, 7, 160, 960, 320, True, False)]
RAGGED = [tuple(c[1:]) for c in chip_smoke.MBCONV_RAGGED]
MODES = ("full", "stats", "raw")


@pytest.mark.parametrize("shape", PATH + RAGGED)
def test_plan_fits_a_block_and_covers_the_image_once(shape):
    h, w, cin, ch, cout, expand, _ = shape
    for mode in MODES:
        for batch in (1, 64, 128):
            run = mbconv.plan(mode, (batch, h, w, cin), ch, cout,
                              "tensor_cores", SMS)
            th, tw = run.tile
            assert 1 <= th <= min(h, mbconv.TC_TILE)
            assert 1 <= tw <= min(w, mbconv.TC_TILE)
            cover = np.zeros((h, w), np.int64)
            for r0 in range(0, h, th):
                for q0 in range(0, w, tw):
                    cover[r0:r0 + th, q0:q0 + tw] += 1
            assert (cover == 1).all()
            assert run.tiles == batch * -(-h // th) * -(-w // tw)
            smem = mbconv.tc_smem_bytes(th, tw, cin, cout, expand, mode)
            assert smem <= mbconv.SMEM_LIMIT
            if shape in PATH:
                assert smem <= TWO_BLOCKS_SMEM
            # slabs of whole chunks, none empty, at most TC_MAX_SPLIT
            chunks = -(-ch // mbconv.TC_CHUNK)
            per = -(-chunks // run.split)
            assert 1 <= run.split <= min(mbconv.TC_MAX_SPLIT, chunks)
            assert (run.split - 1) * per < chunks <= run.split * per
            parts = 1 if mode == "stats" else \
                -(-cout // mbconv.cout_block(cout))
            if run.split > 1:   # split only where the tiles cannot fill
                assert run.tiles * parts * 2 <= 2 * SMS


def test_path_plans_split_only_the_small_images():
    """At batch 64 only the 7x7 blocks split their hidden channels (64
    tiles: 4 slabs of 8, 8, 8, 6 chunks; 2 where Cout = 320 takes two
    parts); at batch 1 every block splits as far as its chunks allow."""
    split = {s: mbconv.plan("full", (64, *s[:3]), s[3], s[4],
                            "tensor_cores", SMS).split for s in PATH}
    assert [split[s] for s in PATH] == [1, 1, 1, 1, 1, 1, 4, 2]
    one = [mbconv.plan("full", (1, *s[:3]), s[3], s[4], "tensor_cores",
                       SMS).split for s in PATH]
    assert one == [1, 5, 6, 6, 6, 6, 8, 8]
    assert [mbconv.tc_tile(s, s) for s in (112, 56, 28, 14, 7)] == \
        [(8, 8), (8, 8), (7, 7), (7, 7), (7, 7)]
    assert [mbconv.cout_block(c) for c in (8, 16, 24, 32, 40, 64, 96, 160,
                                           320)] == \
        [32, 32, 32, 32, 64, 64, 96, 160, 160]


def _act(v, kind):
    return mbconv._act(v, kind)


def _padded(v, n):
    return F.pad(v, (0, n - v.shape[0]))


def _emulate(mode, x, we, s1, t1, wd9, s2, t2, wp, s3, t3, *, residual,
             slabs, act_mid="relu6", act_out="none"):
    """The tensor-core kernel's arithmetic in plain torch. x and the packed
    weights in x's type (K padded with zeros to 16, hidden to a chunk);
    per chunk of TC_CHUNK hidden channels: the expand in float32, BN1, the
    activation and the mask; the 9 taps in order; BN2, the activation and
    the rounding to x's type; the project added into the slab's float32
    sum. The slabs' sums are added in slab order. Stats: the chunks' sums
    of d; Raw: h3 and its sums; Full: the epilogue."""
    dt = x.dtype
    b, h, w, cin = x.shape
    ch = wd9.shape[1]
    chunk = mbconv.TC_CHUNK
    chunks = -(-ch // chunk)
    ch_pad = chunks * chunk
    per = -(-chunks // slabs)
    assert -(-chunks // per) == slabs
    xk = F.pad(x.float(), (0, -(-cin // 16) * 16 - cin))
    we_k = None if we is None else mbconv.pack_expand(we, dt).float()
    wp_k = None if wp is None else mbconv.pack_project(wp, dt).float()
    vec = {k: None if v is None else _padded(v.float(), ch_pad)
           for k, v in (("s1", s1), ("t1", t1), ("s2", s2), ("t2", t2))}
    wd = F.pad(wd9.float(), (0, ch_pad - ch))
    sums_d, slab_sums = [], []
    for s in range(slabs):
        acc = None
        for kc in range(s * per, min((s + 1) * per, chunks)):
            cs = slice(kc * chunk, (kc + 1) * chunk)
            live = (torch.arange(kc * chunk, (kc + 1) * chunk) < ch).float()
            if we_k is not None:
                e = xk @ we_k[cs].t()
                u1 = _act(e * vec["s1"][cs] + vec["t1"][cs], act_mid) * live
            else:
                u1 = F.pad(x.float()[..., cs],
                           (0, chunk - x[..., cs].shape[-1]))
            u1 = F.pad(u1, (0, 0, 1, 1, 1, 1))  # zero outside the image
            d = None
            for di in range(3):
                for dj in range(3):
                    term = u1[:, di:di + h, dj:dj + w, :] * wd[3 * di + dj,
                                                               cs]
                    d = term if d is None else d + term
            if mode == "stats":
                sums_d.append(mbconv._sums(d)[:, :int(live.sum())])
                continue
            u2 = (_act(d * vec["s2"][cs] + vec["t2"][cs], act_mid) * live
                  ).to(dt).float()
            part = u2 @ wp_k[:, cs].t()
            acc = part if acc is None else acc + part
        slab_sums.append(acc)
    if mode == "stats":
        return torch.cat(sums_d, dim=1)
    total = slab_sums[0]
    for more in slab_sums[1:]:
        total = total + more
    if mode == "raw":
        return total.to(dt), mbconv._sums(total)
    y = total * s3 + t3
    if residual:
        y = y + x.float()
    return _act(y, act_out).to(dt)


def _inputs(b, h, w, cin, ch, cout, dtype, seed):
    """As ``chip_smoke.mbconv_inputs``: unit-scale products, scales near 1
    and shifts near 0.2, so that ReLU6 clips at both ends somewhere."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return (r(b, h, w, cin).to(dtype), r(cin, ch) / cin ** 0.5,
            r(ch) * 0.2 + 1.0, r(ch) * 0.2 + 0.2, r(9, ch) / 3,
            r(ch) * 0.2 + 1.0, r(ch) * 0.2 + 0.2, r(ch, cout) / ch ** 0.5,
            r(cout) * 0.2 + 1.0, r(cout) * 0.2)


def _pallas(mode, args, residual):
    """The JAX package's Pallas kernel in interpret mode, as its wrappers
    call it."""
    x, we, s1, t1, wd9, s2, t2, wp, s3, t3 = [
        None if v is None else jnp.asarray(v.float().numpy()) for v in args]
    dt = jnp.bfloat16 if args[0].dtype == torch.bfloat16 else jnp.float32
    x = x.astype(dt)
    b, h, w, cin = x.shape
    ch, cout = wd9.shape[1], wp.shape[1]
    if mode == "full":
        return jmb.mbconv_infer(x, we, s1, t1, wd9, s2, t2, wp, s3, t3,
                                residual=residual, interpret=True)
    xp = jmb._colpad(x)
    head = [xp, xp, xp]
    if we is not None:
        head += [we.astype(dt), jmb._row2(s1), jmb._row2(t1)]
    shape = (b, h, w + 2, cin)
    if mode == "stats":
        return jmb._build_stats(shape, ch, we is not None, "relu6",
                                str(x.dtype), True)(*head, wd9)
    return jmb._build_raw(shape, ch, cout, we is not None, "relu6",
                          str(x.dtype), True)(*head, wd9, jmb._row2(s2),
                                              jmb._row2(t2), wp.astype(dt))


def _np(v):
    return np.asarray(jnp.asarray(v, jnp.float32)) if not torch.is_tensor(v) \
        else v.float().numpy()


def _assert_close(mode, got, ref, n, dname):
    """chip_smoke.py's checks: y and h3 within MBCONV_TOL * (1 + |ref|);
    Σ within SUM_TOL of sqrt(n Σ²) and Σ² within SUM_TOL of itself."""
    tol = chip_smoke.MBCONV_TOL[dname]
    if mode != "stats":
        y, y_ref = (got, ref) if mode == "full" else (got[0], ref[0])
        y, y_ref = _np(y), _np(y_ref)
        assert y.shape == y_ref.shape
        assert (np.abs(y - y_ref) <= tol * (1 + np.abs(y_ref))).all(), \
            np.abs(y - y_ref).max()
    if mode != "full":
        sums, sums_ref = (got, ref) if mode == "stats" else (got[1], ref[1])
        sums, sums_ref = _np(sums), _np(sums_ref)
        scale = np.stack([np.sqrt(n * sums_ref[1]), sums_ref[1]])
        assert (np.abs(sums - sums_ref) <= chip_smoke.SUM_TOL * scale).all()


# (Cin, Ch, slabs): Cin = 24, K padded to 32, with one ragged chunk; two
# whole chunks and a ragged one, split in two (2 + 1 chunks) and in three
# (1 + 1 + 1); no expand stage (u1 = x, as MobileNet-V2's 112² block), Cin
# = Ch = 40, K padded to 48, one whole chunk and a ragged one in two slabs
@pytest.mark.parametrize("dname", ["float32", "bf16"])
@pytest.mark.parametrize("cin,ch,slabs", [(24, 24, 1), (24, 72, 2),
                                          (24, 72, 3), (40, 40, 2)])
@pytest.mark.parametrize("mode", MODES)
def test_emulated_kernel_matches_plain_and_pallas(mode, cin, ch, slabs,
                                                  dname):
    dtype = torch.bfloat16 if dname == "bf16" else torch.float32
    b, h, w = 2, 9, 7
    cout = 24 if mode == "full" else 16
    args = list(_inputs(b, h, w, cin, ch, cout, dtype, seed=ch + slabs))
    if cin == ch:                       # no expand stage
        args[1] = args[2] = args[3] = None
        cout = cin if mode == "full" else cout
        args[7:] = _inputs(b, h, w, cin, ch, cout, dtype, seed=1)[7:]
    residual = mode == "full"
    kw = {"residual": residual} if mode == "full" else {}
    n_args = {"full": 10, "stats": 5, "raw": 8}[mode]
    plain = {"full": mbconv.mbconv_full_plain,
             "stats": mbconv.mbconv_stats_plain,
             "raw": mbconv.mbconv_raw_plain}[mode](*args[:n_args], **kw)
    got = _emulate(mode, *args[:n_args], *[None] * (10 - n_args),
                   residual=residual, slabs=slabs)
    _assert_close(mode, got, plain, b * h * w, dname)
    _assert_close(mode, got, _pallas(mode, args, residual), b * h * w,
                  dname)


@pytest.mark.parametrize("cin,ch,cout", [(24, 144, 24), (8, 24, 8),
                                         (40, 100, 40)])
def test_packed_weights_compute_the_plain_products(cin, ch, cout):
    """x @ we and u @ wp through the packed layouts equal the plain
    products in bf16 (the same exact bf16 products, float32 sums in one
    order), and the padding is zero."""
    rng = np.random.default_rng(cin + ch)
    we = torch.from_numpy(rng.standard_normal((cin, ch)).astype(np.float32))
    wp = torch.from_numpy(rng.standard_normal((ch, cout)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((50, cin)).astype(
        np.float32)).bfloat16()
    u = torch.from_numpy(rng.standard_normal((50, ch)).astype(
        np.float32)).bfloat16()
    pe = mbconv.pack_expand(we, torch.bfloat16)
    pp = mbconv.pack_project(wp, torch.bfloat16)
    assert pe.dtype == pp.dtype == torch.bfloat16
    assert pe.shape == (-(-ch // 32) * 32, -(-cin // 16) * 16)
    assert pp.shape == (cout, -(-ch // 32) * 32)
    assert not pe[ch:].any() and not pe[:, cin:].any()
    assert not pp[:, ch:].any()
    xk = F.pad(x.float(), (0, pe.shape[1] - cin))
    uk = F.pad(u.float(), (0, pp.shape[1] - ch))
    torch.testing.assert_close((xk @ pe.float().t())[:, :ch],
                               x.float() @ we.bfloat16().float(),
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(uk @ pp.float().t(),
                               u.float() @ wp.bfloat16().float(),
                               rtol=1e-6, atol=1e-5)


def test_packed_weights_are_made_once_per_weight_version():
    """The layouts ``kernel_args`` asks ``_prepared`` for: the same tensor
    until the weight is changed in place, then a new one that packs the new
    values; with autograd recording through the weight, never cached."""
    _prepared.clear()
    w = torch.nn.Parameter(torch.randn(24, 144))   # (Cin, Ch)
    calls = []

    def make(v):
        calls.append(1)
        return mbconv.pack_expand(v, torch.bfloat16)

    tag = ("mbconv.we", torch.bfloat16)
    try:
        with torch.no_grad():
            first = _prepared.get(tag, (w,), make)
            assert _prepared.get(tag, (w,), make) is first
            w.add_(1)
            second = _prepared.get(tag, (w,), make)
        assert second is not first and len(calls) == 2
        torch.testing.assert_close(
            second, mbconv.pack_expand(w.detach(), torch.bfloat16),
            rtol=0, atol=0)
        recorded = _prepared.get(tag, (w,), make)
        assert recorded.grad_fn is not None and len(calls) == 3
    finally:
        _prepared.clear()
