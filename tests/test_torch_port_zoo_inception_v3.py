"""Inception v3 in the port against the JAX package, on the CPU: each block
type (A–E, the aux head) forward and backward in training mode at a small
spatial size; the whole model's eval forward with BN folded at 75x75, batch
2, about the smallest size that reaches the last reductions; and its
training forward with the aux head, whose loss is held against the JAX
trainer's ``_loss_fn`` (main and aux terms). The block and model helpers
serve ``test_torch_port_zoo_inception_v4.py`` and ``..._irv2.py`` too.

Weights come from the port's seeded draw (BN parameters and statistics
redrawn with numpy) and reach JAX through ``to_jax_params``, so JAX's slow
``init`` is skipped; inputs come from a numpy seed. The JAX functions are
jitted (a few seconds each here, against 10–20 s eager).

The training forward runs at a larger size: at 75x75, batch 2, training-mode
BatchNorm over 1x1 and 2x2 maps makes the forward chaotic (a 1e-7 relative
input change moves the logits by 44% of the largest in v3;
``scripts/port_numerics.py zoo``). At 107x107 the same change moves them by
1.5e-4, and float32 sits 1.2e-4 from float64 (v4 at 139x139: 1.8e-3 and
1.6e-3; Inception-ResNet-v2 at 107x107: 8.8e-6 and 1.6e-5).

Tolerances, float32 (sums in another order; training-mode BN over 2·4·5 to
2·9·9 values a channel): block outputs and new BN statistics 1e-4 of the
largest, block gradients (input and every parameter) 1e-3 of each tensor's
largest entry; eval logits 1e-4 of the largest. The training forward's
logits, loss (relative) and new BN statistics: about ten times the model's
float32 noise at its size, 1e-3 for v3, 1e-2 for v4, 1e-4 for
Inception-ResNet-v2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_zoo_small as Z
from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.models import inception as jax_v3
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.losses import CrossEntropyLoss as JaxCrossEntropy
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu_torch.models import inception as v3
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import to_jax_params

OUT_TOL, GRAD_TOL, LOGIT_TOL = 1e-4, 1e-3, 1e-4
SIZE, BATCH = 75, 2
TRAIN_SIZE, TRAIN_TOL = 107, 1e-3
V3_AUX = {"aux_classifiers": True, "num_classes": 10}


def block_matches(port_block, jax_block, shape, seed=0):
    """A training-mode forward of both blocks on one input, then the
    gradient of sum(y·w): the outputs, the new BN statistics, dx and every
    parameter's gradient against JAX's."""
    Z.init_weights(port_block, seed)
    params, state = to_jax_params(port_block.state_dict())
    x = Z.images(shape, seed + 1)

    def f(p, a):
        return jax_block(p, state, a, Context(train=True))

    @jax.jit
    def forward_backward(p, a, w):
        y, vjp, new_state = jax.vjp(f, p, a, has_aux=True)
        return y, vjp(w), new_state

    p = jax.tree_util.tree_map(jnp.asarray, params)
    out_shape = jax.eval_shape(f, p, jnp.asarray(x))[0].shape
    w = Z.images(out_shape, seed + 2)
    ref, (ref_dp, ref_dx), ref_state = forward_backward(p, jnp.asarray(x),
                                                        jnp.asarray(w))

    port_block.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_block(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert y.shape == ref.shape
    assert Z.rel(y.detach().numpy(), ref) <= OUT_TOL
    assert Z.rel(xt.grad.numpy(), ref_dx) <= GRAD_TOL
    grads = dict(port_block.state_dict())
    for name, p in port_block.named_parameters():
        grads[name] = p.grad
    got_dp, new_state = to_jax_params(grads)[0], to_jax_params(
        port_block.state_dict())[1]
    ref_dp = dict(Z.leaves(ref_dp))
    got_dp = dict(Z.leaves(got_dp))
    assert ref_dp.keys() == got_dp.keys()
    for k in ref_dp:
        assert Z.rel(got_dp[k], ref_dp[k]) <= GRAD_TOL, k
    # JAX returns only the BNs that ran; a block's every BN runs
    ref_s, got_s = dict(Z.leaves(ref_state)), dict(Z.leaves(new_state))
    assert ref_s.keys() == got_s.keys()
    for k in ref_s:
        assert Z.rel(got_s[k], ref_s[k]) <= OUT_TOL, k


def model_forwards_match(name, config, train_size, train_tol,
                         with_aux_loss=False, seed=0):
    """The whole model: the eval forward with BN folded at SIZE, batch
    BATCH, against JAX's; then a training forward at ``train_size``
    (dropout 0) through the port's ``Trainer`` loss against the JAX
    trainer's ``_loss_fn``: the logits, the loss (with the aux terms where
    the model has heads; the main term alone too) and the new BN statistics,
    within ``train_tol``."""
    assert Z.eval_match(name, config, (BATCH, SIZE, SIZE, 3),
                        seed) <= LOGIT_TOL
    model = Z.port_model(name, config, seed)
    Z.zero_dropout(port_module=model)
    params, state = Z.jax_trees(model)
    rng = np.random.default_rng(seed + 5)
    x = rng.standard_normal((BATCH, train_size, train_size, 3)).astype(
        np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    j_model = jax_models.build(name, **config)
    Z.zero_dropout(j_model)
    j_tr = JaxTrainer(j_model, jax_optim.OptimRegime(j_model.regime), 10,
                      JaxTrainerConfig(dtype="float32", print_freq=0))
    j_loss, (j_state, j_logits) = jax.jit(
        lambda p, s, a, b: j_tr._loss_fn(p, s, a, b, jax.random.PRNGKey(0),
                                         None))(
        params, state, jnp.asarray(x), jnp.asarray(y))
    j_main = float(JaxCrossEntropy()(j_logits, jnp.asarray(y)))
    tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu")
    model.train()
    labels = torch.from_numpy(y).long()
    with torch.no_grad():
        loss, logits = tr._loss(torch.from_numpy(x), labels)
        main = float(tr.criterion(logits, labels))
    assert Z.rel(logits.numpy(), j_logits) <= train_tol
    np.testing.assert_allclose(main, j_main, rtol=train_tol)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=train_tol)
    if with_aux_loss:
        assert float(loss) - main > 1e-3            # the heads' terms
        np.testing.assert_allclose(float(loss) - main,
                                   float(j_loss) - j_main, rtol=train_tol)
    else:
        assert float(loss) == main
    ref_s = dict(Z.leaves(j_state))
    got_s = dict(Z.leaves(to_jax_params(model.state_dict())[1]))
    assert ref_s.keys() == got_s.keys()
    for k in ref_s:
        assert Z.rel(got_s[k], ref_s[k]) <= train_tol, k


# (port block, JAX block, input shape): narrow inputs where the block
# takes any width, full widths where its plan fixes them
BLOCKS = {
    "A": (lambda: v3.InceptionA(16, 8), lambda: jax_v3.InceptionA(16, 8),
          (2, 5, 5, 16)),
    "B": (lambda: v3.InceptionB(16), lambda: jax_v3.InceptionB(16),
          (2, 9, 9, 16)),
    "C": (lambda: v3.InceptionC(24, 8), lambda: jax_v3.InceptionC(24, 8),
          (2, 7, 6, 24)),
    "D": (lambda: v3.InceptionD(16), lambda: jax_v3.InceptionD(16),
          (2, 9, 9, 16)),
    "E": (lambda: v3.InceptionE(16), lambda: jax_v3.InceptionE(16),
          (2, 4, 5, 16)),
    "aux": (lambda: v3.InceptionAux(16, 10),
            lambda: jax_v3.InceptionAux(16, 10), (2, 6, 6, 16)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_backward_match_jax(block):
    ours, ref, shape = BLOCKS[block]
    block_matches(ours(), ref(), shape)


def test_model_forwards_and_aux_loss_match_jax():
    model_forwards_match("inception_v3", V3_AUX, TRAIN_SIZE, TRAIN_TOL,
                         with_aux_loss=True)


def test_aux_head_runs_only_in_training_with_a_collector():
    model = v3.InceptionV3(num_classes=10, aux_classifiers=True)
    Z.zero_dropout(port_module=model)
    calls = []
    model.aux.register_forward_hook(lambda *_: calls.append(1))
    x = torch.from_numpy(Z.images((1, SIZE, SIZE, 3), 3))
    heads = []
    model.train()
    model(x, aux=heads)
    assert [w for w, _ in heads] == [0.4] and heads[0][1].shape == (1, 10)
    model(x)
    model.eval()
    model(x, aux=heads)
    assert len(calls) == 1 and len(heads) == 1


def test_eval_routes_40_fused_1x1_and_4_pools():
    model = v3.InceptionV3(num_classes=10, aux_classifiers=True).eval()
    from convnet_tpu_torch.models.resnet import ConvBN
    from convnet_tpu_torch.nn import MaxPool2d
    fused, pools = [], []
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(
                lambda mod, *_: fused.append(mod.uses_kernel()))
        elif isinstance(m, MaxPool2d):
            m.register_forward_hook(lambda *_: pools.append(1))
    with torch.no_grad():
        model(torch.from_numpy(Z.images((1, SIZE, SIZE, 3), 4)))
    assert sum(fused) == 40 and len(pools) == 4
