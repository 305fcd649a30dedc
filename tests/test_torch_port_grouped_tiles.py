"""The grouped conv's packed weight (``grouped_conv.block_tiles``, the
tensor-core kernel's layout) against the plain version and the JAX
package's Pallas kernel, on the CPU.

The CUDA kernel multiplies, per tap, pixels x WB input channels by a WB x WB
tile, WB = max(16, cg): where cg < 16 the tile holds 16/cg groups on its
diagonal and zeros elsewhere. A plain einsum over the packed tiles, per tap,
is that product; it must equal ``grouped_conv2d_plain`` and the Pallas
kernel in interpret mode on the same numpy inputs. float32, 1e-4 (the
existing grouped test's tolerance: the same products added in other
orders). Every off-diagonal entry of a tile must be exactly zero, or the
kernel would mix groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.ops.pallas import grouped as jax_grouped
from convnet_tpu_torch.ops.kernels import _conv, grouped_conv


def _inputs(shape, cg, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, cg, c)) * 0.1).astype(np.float32)  # HWIO
    return x, w


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _tiles_conv(x, tiles, stride, padding):
    """Σ over taps of the staged input (pixels x C/WB x WB) times the tap's
    tiles, as the kernel computes it."""
    b, _, _, c = x.shape
    wb = tiles.shape[-1]
    kernel, stride, padding, out_hw = _conv.geometry(x.shape, (3, 3), stride,
                                                     padding)
    xp = _conv.pad_hw(x, padding)
    acc = 0
    for di, dj, rows, cols in _conv.taps(kernel, stride, out_hw):
        xs = xp[:, rows, cols].reshape(b, *out_hw, c // wb, wb)
        acc = acc + torch.einsum("bhwni,noi->bhwno", xs, tiles[di * 3 + dj])
    return acc.reshape(b, *out_hw, c)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", [2, 4, 8, 16, 32])
def test_packed_tiles_compute_the_grouped_conv(cg, stride):
    x, w_hwio = _inputs((2, 7, 6, 128), cg, seed=cg + stride)
    w = _oihw(w_hwio)
    groups = 128 // cg
    tiles = grouped_conv.block_tiles(w)
    wb = max(16, cg)
    assert tiles.shape == (9, 128 // wb, wb, wb)

    got = _tiles_conv(torch.from_numpy(x), tiles, stride, 1).numpy()
    plain = grouped_conv.grouped_conv2d_plain(torch.from_numpy(x), w, stride,
                                              1, groups).numpy()
    ref = jax_grouped.grouped_conv_pallas(
        jnp.asarray(x), jnp.asarray(w_hwio), stride=stride, padding=1,
        groups=groups, interpret=True)
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cg", [2, 4, 8, 16, 32, 64])
def test_tiles_are_block_diagonal_with_the_weight_on_the_diagonal(cg):
    c = 128
    w = torch.randn(c, cg, 3, 3) + 3.0          # no weight is zero
    tiles = grouped_conv.block_tiles(w)
    wb = max(16, cg)
    o = torch.arange(wb)
    same_group = (o[:, None] // cg) == (o[None, :] // cg)
    assert torch.all(tiles[..., ~same_group] == 0)
    assert torch.all(tiles[..., same_group] != 0)
    for t in range(9):
        di, dj = divmod(t, 3)
        for co in range(0, c, 7):
            blk, oo = divmod(co, wb)
            for ci in range(cg):
                ii = (oo // cg) * cg + ci        # the tile's input column
                assert tiles[t, blk, oo, ii] == w[co, ci, di, dj]


def test_tiles_keep_the_weights_type():
    w = torch.randn(128, 4, 3, 3).to(torch.bfloat16)
    tiles = grouped_conv.block_tiles(w)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()


def test_transposed_weight_is_the_cuda_core_layout():
    """(C, cg, kh, kw) → (kh, kw, cg, C), in memory (kh*kw, cg, C):
    wt[t, c, co] == w[co, c, di, dj]."""
    w = torch.randn(96, 3, 3, 3)
    wt = grouped_conv.transposed_weight(w)
    assert wt.shape == (3, 3, 3, 96) and wt.is_contiguous()
    wt = wt.reshape(9, 3, 96)
    for t in range(9):
        di, dj = divmod(t, 3)
        torch.testing.assert_close(wt[t], w[:, :, di, dj].t(), rtol=0, atol=0)


def test_dx_weight_packs_to_the_flipped_transposed_tiles():
    """The stride-1 dx runs the kernel on dy with ``flip_transpose``'s
    weight; its tiles hold w[g cg + o, c, 2 - di, 2 - dj] at [t, ., c, o]."""
    cg, c = 4, 64
    w = torch.randn(c, cg, 3, 3)
    tiles = grouped_conv.block_tiles(grouped_conv.flip_transpose(w, c // cg))
    for t in range(9):
        di, dj = divmod(t, 3)
        for co in range(c):
            g, o = divmod(co, cg)
            blk, off = divmod(g * cg, 16)
            for ci in range(cg):
                assert tiles[t, blk, off + ci, off + o] == \
                    w[co, ci, 2 - di, 2 - dj]
