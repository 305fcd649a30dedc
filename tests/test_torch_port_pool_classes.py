"""The pool backward's residue-class formulation, the one the tiled CUDA
kernel computes, against the plain version and the JAX package, on the CPU.

``max_pool.class_taps`` is the port's own copy of the reference's
``_class_taps`` (``convnet_tpu/ops/pool.py``): pixel s a + r of an axis is
fed by tap d through window a + u for every d = r + p (mod s), u = (r + p -
d) / s. ``max_pool2d_bwd_classes`` assembles dx class by class from shifted
masked dy planes in output geometry, adding the taps in ascending order in
float32 as the kernel does. It is held bit for bit to
``max_pool2d_bwd_plain`` (the kernels' oracle on the card) in float32 and
bf16: both add the same float32 terms in the same order at every pixel and
round once. Against the JAX package's ``max_pool2d_bwd_pallas`` (interpret
mode) it is held under the tolerances of ``test_torch_port_pool.py``:
exact with quarter-integer dy (sums exact in any order), exact in float32
with normal dy (the same ascending order), and in bf16 within 1e-2 of
(1 + the sum of the |dy| routed to the pixel), since the reference rounds
every partial sum to bf16.

The cases are ``test_torch_port_pool.py``'s and the tiled kernel's edges: a
2 x 2 input (one window), H even and W odd, Ho = 57 (not a multiple of the
tile's 8 window rows), and C = 136 (17 bf16 vectors: a partial run).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.ops.pallas.pool_bwd import max_pool2d_bwd_pallas
from convnet_tpu.ops.pool import _class_taps, _mp_fwd_argmax
from convnet_tpu_torch.ops.kernels import max_pool

CASES = [  # (x shape, kernel, stride, padding)
    ((2, 16, 16, 8), 3, 2, 1),    # the ResNet stem's pool, small
    ((2, 15, 13, 3), 3, 2, 1),    # odd H and W, C = 3
    ((2, 8, 8, 5), 2, 2, 0),      # non-overlapping windows
    ((2, 9, 9, 17), 3, 1, 1),     # stride 1: a shift of -1
    ((2, 2, 2, 8), 3, 2, 1),      # one window
    ((2, 16, 15, 8), 3, 2, 1),    # H even, W odd
    ((2, 114, 114, 8), 3, 2, 1),  # Ho = 57
    ((2, 16, 16, 136), 3, 2, 1),  # C = 136
]
IDS = ["stem", "odd", "k2s2", "s1", "2x2", "even_odd", "ho57", "c136"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, k, s, p, dtype, inputs, dy_kind):
    """x, the JAX index and dy (numpy float32, rounded to ``dtype``)."""
    rng = np.random.default_rng(sum(shape) + k)
    if inputs == "ties":
        x = rng.integers(-2, 3, shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, JNP[dtype])
    _, idx = _mp_fwd_argmax(xj, (k, k), (s, s), (p, p))
    if dy_kind == "quarters":
        dy = (rng.integers(-8, 9, idx.shape) / 4).astype(np.float32)
    else:
        dy = rng.standard_normal(idx.shape).astype(np.float32)
    dy = np.array(jnp.asarray(dy, JNP[dtype]).astype(jnp.float32))
    return xj, np.array(idx), dy


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (3, 1, 1), (2, 2, 0),
                                   (3, 2, 0), (5, 2, 2), (3, 3, 1)])
def test_class_taps_match_the_reference(k, s, p):
    for r in range(s):
        assert max_pool.class_taps(r, p, k, s) == _class_taps(r, p, k, s)


def test_class_taps_of_the_tiled_instance():
    # the list csrc/max_pool.cu's max_pool2d_bwd_tiled<T, 3, 2, 1> unrolls:
    # shifts 0 and 1 only, so a tile stages one more window row and column
    assert [max_pool.class_taps(r, 1, 3, 2) for r in range(2)] == [
        [(1, 0)], [(0, 1), (2, 0)]]


@pytest.mark.parametrize("inputs", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,s,p", CASES, ids=IDS)
def test_classes_bit_equal_to_plain(shape, k, s, p, dtype, inputs):
    _, idx, dy = _inputs(shape, k, s, p, dtype, inputs, "normal")
    dyt = torch.from_numpy(dy).to(TORCH[dtype])
    idxt = torch.from_numpy(idx)
    dx = max_pool.max_pool2d_bwd_classes(dyt, idxt, shape, k, s, p)
    ref = max_pool.max_pool2d_bwd_plain(dyt, idxt, shape, k, s, p)
    assert dx.dtype == TORCH[dtype] and dx.shape == shape
    assert torch.equal(dx.float().view(torch.int32),
                       ref.float().view(torch.int32))


@pytest.mark.parametrize("dy_kind", ["quarters", "normal"])
@pytest.mark.parametrize("inputs", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,s,p", CASES, ids=IDS)
def test_classes_match_jax(shape, k, s, p, dtype, inputs, dy_kind):
    _, idx, dy = _inputs(shape, k, s, p, dtype, inputs, dy_kind)
    ref = np.asarray(max_pool2d_bwd_pallas(
        (k, k), (s, s), (p, p), shape, dtype, jnp.asarray(idx),
        jnp.asarray(dy, JNP[dtype]), interpret=True).astype(jnp.float32))
    dx = max_pool.max_pool2d_bwd_classes(
        torch.from_numpy(dy).to(TORCH[dtype]), torch.from_numpy(idx), shape,
        k, s, p).float().numpy()
    if dy_kind == "quarters" or dtype == "float32":
        np.testing.assert_array_equal(dx, ref)
    else:
        routed = max_pool.max_pool2d_bwd_classes(
            torch.from_numpy(np.abs(dy)), torch.from_numpy(idx), shape, k, s,
            p).numpy()
        assert (np.abs(dx - ref) <= 1e-2 * (1 + routed)).all()


def _offset(t, elements):
    """A contiguous copy of t that starts ``elements`` into its buffer."""
    buf = torch.zeros(t.numel() + elements, dtype=t.dtype)
    buf[elements:] = t.reshape(-1)
    return buf[elements:].view(t.shape)


# dy's shape (one image: the rule reads C, the pool, the type and the
# pointers), the pool, dy's type, dy's offset in elements, the kernel
@pytest.mark.parametrize("shape,k,s,p,dtype,offset,want", [
    ((1, 56, 56, 64), 3, 2, 1, torch.bfloat16, 0, "tiled"),    # ResNet-50
    ((1, 56, 56, 128), 3, 2, 1, torch.bfloat16, 0, "tiled"),   # ResNeXt-50
    ((1, 56, 56, 64), 3, 2, 1, torch.float32, 0, "tiled"),
    ((1, 56, 56, 128), 3, 2, 1, torch.float32, 0, "tiled"),
    ((2, 8, 8, 136), 3, 2, 1, torch.bfloat16, 0, "tiled"),
    ((2, 8, 7, 3), 3, 2, 1, torch.bfloat16, 0, "per_pixel"),    # ragged C
    ((2, 8, 7, 6), 3, 2, 1, torch.float32, 0, "per_pixel"),
    ((2, 4, 4, 5), 2, 2, 0, torch.float32, 0, "per_pixel"),     # k = 2
    ((2, 9, 9, 16), 3, 1, 1, torch.bfloat16, 0, "per_pixel"),   # stride 1
    ((2, 8, 8, 64), 3, 2, 0, torch.bfloat16, 0, "per_pixel"),   # padding 0
    ((2, 8, 8, 64), 3, 2, 1, torch.bfloat16, 1, "per_pixel"),   # dy + 2 B
    ((2, 8, 8, 64), 3, 2, 1, torch.float32, 2, "per_pixel"),    # dy + 8 B
    ((2, 8, 8, 64), 3, 2, 1, torch.float16, 0, "per_pixel"),    # no kernel
])
def test_bwd_variant_rule(shape, k, s, p, dtype, offset, want):
    dy = _offset(torch.zeros(shape, dtype=dtype), offset)
    idx = torch.zeros(dy.shape, dtype=torch.uint8)
    assert dy.data_ptr() % 16 == (offset * dy.element_size()) % 16
    assert max_pool.bwd_variant(dy, idx, k, s, p) == want
    assert max_pool.bwd_rule(shape[-1], k, s, p, dtype, dy.data_ptr(),
                             idx.data_ptr()) == want


def test_bwd_variant_rule_reads_the_index_alignment():
    dy = torch.zeros((2, 4, 4, 64), dtype=torch.bfloat16)
    idx = _offset(torch.zeros(dy.shape, dtype=torch.uint8), 4)
    assert max_pool.bwd_variant(dy, idx, 3, 2, 1) == "per_pixel"
    idx = _offset(torch.zeros(dy.shape, dtype=torch.uint8), 8)
    assert max_pool.bwd_variant(dy, idx, 3, 2, 1) == "tiled"
