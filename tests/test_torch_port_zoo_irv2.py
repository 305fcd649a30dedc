"""Inception-ResNet-v2 in the port against the JAX package, on the CPU:
each block type (Mixed5b, Mixed6a, Mixed7a, Block35, Block17, Block8 and
the final Block8 with no ReLU) forward and backward in training mode at a
small spatial size, the biased ``up`` convs' gradients among them; the
whole model's eval forward with BN folded at 75x75 and its training forward
at 107x107 (helpers and tolerances of
``test_torch_port_zoo_inception_v3.py``).
"""

import importlib

import pytest
import torch

import test_torch_port_zoo_inception_v3 as V3
import test_torch_port_zoo_small as Z
from convnet_tpu_torch.nn import AvgPool2d, Conv2d
from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn

# the packages' ``models`` export factories of these modules' names
jax_irv2 = importlib.import_module("convnet_tpu.models.inception_resnet_v2")
irv2 = importlib.import_module(
    "convnet_tpu_torch.models.inception_resnet_v2")

TRAIN_SIZE, TRAIN_TOL = 107, 1e-4

BLOCKS = {
    "mixed5b": ("Mixed5b", (), (2, 5, 5, 192)),
    "mixed6a": ("Mixed6a", (), (2, 9, 9, 320)),
    "mixed7a": ("Mixed7a", (), (2, 7, 7, 1088)),
    "block35": ("Block35", (), (2, 5, 5, 320)),
    "block17": ("Block17", (), (2, 4, 5, 1088)),
    "block8": ("Block8", (), (2, 3, 3, 2080)),
    "block8_final": ("Block8", (True,), (2, 3, 3, 2080)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_backward_match_jax(block):
    cls, args, shape = BLOCKS[block]
    V3.block_matches(getattr(irv2, cls)(*args),
                     getattr(jax_irv2, cls)(*args), shape)


def test_model_forwards_match_jax():
    V3.model_forwards_match("inception_resnet_v2", {"num_classes": 10},
                            TRAIN_SIZE, TRAIN_TOL)


def test_final_block_has_no_relu_and_unit_scale():
    block = irv2.Block8(final=True).eval()
    assert block.scale == 1.0 and block.final
    assert irv2.Block8().scale == 0.2 and not irv2.Block8().final
    x = -torch.ones(1, 2, 2, 2080)
    with torch.no_grad():
        assert (block(x) < 0).any()
        assert (irv2.Block8().eval()(x) >= 0).all()


def test_up_convs_keep_their_bias_when_bn_is_folded():
    """The ``up`` convs have no BN sibling: folding leaves their biases,
    and the Mixed5b pool leaves out the padding."""
    model = irv2.InceptionResNetV2(num_classes=10)
    ups = [m for name, m in model.named_modules()
           if isinstance(m, Conv2d) and name.endswith(".up")]
    assert len(ups) == 10 + 20 + 10 and all(u.bias is not None for u in ups)
    before = [u.bias.detach().clone() for u in ups]
    search_absorb_bn(model.eval())
    assert all(torch.equal(u.bias, b) for u, b in zip(ups, before))
    pools = [m for m in model.modules() if isinstance(m, AvgPool2d)]
    assert len(pools) == 1 and not pools[0].count_include_pad
