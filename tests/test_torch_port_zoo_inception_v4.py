"""Inception-v4 in the port against the JAX package, on the CPU: each block
type (Mixed3a, Mixed4a, Mixed5a, InceptionA–C, the reductions, the split
head) forward and backward in training mode at a small spatial size; the
whole model's eval forward with BN folded at 75x75, and its training
forward at 139x139 (at smaller sizes the training forward is chaotic; see
``test_torch_port_zoo_inception_v3.py``, whose helpers and tolerances this
file uses). Its branch average pools divide by their in-bounds taps
(``count_include_pad=False``): the 5x5 blocks put 16 of 25 outputs on the
border.
"""

import importlib

import pytest

import test_torch_port_zoo_inception_v3 as V3
from convnet_tpu_torch.nn import AvgPool2d

# the packages' ``models`` export factories of these modules' names
jax_v4 = importlib.import_module("convnet_tpu.models.inception_v4")
v4 = importlib.import_module("convnet_tpu_torch.models.inception_v4")

TRAIN_SIZE, TRAIN_TOL = 139, 1e-2

BLOCKS = {
    "mixed3a": ("Mixed3a", (), (2, 9, 9, 64)),
    "mixed4a": ("Mixed4a", (), (2, 9, 9, 160)),
    "mixed5a": ("Mixed5a", (), (2, 9, 9, 192)),
    "inception_a": ("InceptionA", (), (2, 5, 5, 384)),
    "reduction_a": ("ReductionA", (), (2, 9, 9, 384)),
    "inception_b": ("InceptionB", (), (2, 5, 5, 1024)),
    "reduction_b": ("ReductionB", (), (2, 7, 7, 1024)),
    "split_head": ("_SplitHead", (24,), (2, 4, 5, 24)),
    "inception_c": ("InceptionC", (), (2, 3, 3, 1536)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_backward_match_jax(block):
    cls, args, shape = BLOCKS[block]
    V3.block_matches(getattr(v4, cls)(*args), getattr(jax_v4, cls)(*args),
                     shape)


def test_model_forwards_match_jax():
    V3.model_forwards_match("inception_v4", {"num_classes": 10}, TRAIN_SIZE,
                            TRAIN_TOL)


def test_branch_pools_leave_out_the_padding():
    pools = [m for m in v4.InceptionV4(num_classes=10).modules()
             if isinstance(m, AvgPool2d)]
    assert len(pools) == 4 + 7 + 3
    assert all(not p.count_include_pad and (p.kernel_size, p.stride,
                                            p.padding) == (3, 1, 1)
               for p in pools)
