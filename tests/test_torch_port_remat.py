"""Remat (``nn.CheckpointModule``) in the port, on the CPU: against the JAX
package's ``CheckpointModule`` and against the port's own unwrapped model.

A recompute runs the same float32 ops on the same inputs, so the remat
model's outputs and gradients are held to the unwrapped model's within
``REMAT_TOL`` (1e-6 of their scale), and its BatchNorm running statistics
after a training step must be equal to them bit for bit: the recompute in
the backward must not move them a second time (the port's ``BatchNorm2d``
updates its buffers in place in the forward; ``jax.checkpoint`` returns
the new state once). Against the JAX package: the terms of
``tests/test_models.py::test_checkpoint_module_equivalence`` (value 1e-6,
gradients 1e-5 relative) and the eval logits at 1e-4 of the largest.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.models.resnet import ConvBN as JaxConvBN
from convnet_tpu.nn.checkpoint import CheckpointModule as JaxCheckpointModule
from convnet_tpu_torch import models
from convnet_tpu_torch.core.module import Sequential, init_parameters
from convnet_tpu_torch.models.resnet import ConvBN
from convnet_tpu_torch.nn import CheckpointModule, Conv2d, Dropout
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import from_jax_params

# the module (``models.resnet`` is the factory function)
resnet = importlib.import_module("convnet_tpu_torch.models.resnet")
NARROW = {"depth": 50, "width": [8, 16, 32, 64], "num_classes": 10}
SIZE = 32
REMAT_TOL = 1e-6


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(remat, seed=3):
    """The narrow ResNet-50 with ``remat`` and without, same weights."""
    plain = models.build("resnet", **NARROW)
    init_parameters(plain, torch.Generator().manual_seed(seed))
    wrapped = models.build("resnet", remat=remat, **NARROW)
    sd = plain.state_dict()
    keys = list(wrapped.state_dict())
    wrapped.load_state_dict(dict(zip(keys, sd.values())))
    assert [k.replace(".module", "") for k in keys] == list(sd)
    return plain, wrapped


def _wrapped_blocks(model):
    return [n for n, m in model.named_modules()
            if isinstance(m, CheckpointModule)]


def test_checkpoint_module_matches_jax():
    """The JAX package's remat test (tests/test_models.py), on the port: a
    wrapped ConvBN's value and parameter gradients in eval, and in training
    the value, the gradients and the new BN statistics."""
    blk = JaxConvBN(4, 4, 3, 1, 1)
    params, state = blk.init(jax.random.PRNGKey(0))
    wrapped = JaxCheckpointModule(blk)
    x = _x((2, 8, 8, 4))
    port = CheckpointModule(ConvBN(4, 4, 3, 1, 1))
    port.load_state_dict(from_jax_params(
        {"module": _numpy(params)}, {"module": _numpy(state)}))
    for train in (False, True):
        ctx = Context(train=train)

        def f(p):
            y, s = wrapped({"module": p}, {"module": state}, jnp.asarray(x),
                           ctx)
            return jnp.sum(y), s

        (ref, new_state), grads = jax.value_and_grad(f, has_aux=True)(params)
        port.train(train)
        for p in port.parameters():
            p.grad = None
        out = port(torch.from_numpy(x)).sum()
        out.backward()
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
        got = {k: p.grad for k, p in port.named_parameters()}
        for k, g in from_jax_params({"module": _numpy(grads)}).items():
            np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(g.abs().max()),
                                       err_msg=f"{train} {k}")
        if train:
            ref_s = from_jax_params({}, _numpy(new_state))
            for k, b in port.named_buffers():
                np.testing.assert_allclose(b.numpy(), ref_s[k].numpy(),
                                           rtol=1e-6, atol=1e-6)


def test_convbn_statistics_move_once():
    """The pitfall: a 4-channel ConvBN wrapped naively would end a step with
    its running mean moved twice by the momentum. Forward and backward in
    training leave the wrapped block's buffers equal to the unwrapped
    block's, bit for bit; and so does a forward without autograd."""
    torch.manual_seed(0)
    plain = ConvBN(4, 4, 3, 1, 1)
    wrapped = CheckpointModule(ConvBN(4, 4, 3, 1, 1))
    wrapped.module.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_x((2, 8, 8, 4))) + 1.0
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            ya, yb = plain(x), wrapped(x)
        if grad:
            ya.square().sum().backward()
            yb.square().sum().backward()
        for (k, a), b in zip(plain.named_buffers(), wrapped.buffers()):
            assert torch.equal(a, b), (grad, k)
        assert not torch.equal(plain.bn.running_mean, torch.zeros(4))
    for a, b in zip(plain.parameters(), wrapped.parameters()):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("remat", [True, ("layer1",)],
                         ids=["all", "layer1"])
def test_remat_matches_unwrapped(remat):
    """Outputs and gradients of a training forward within 1e-6 of the
    unwrapped model's; after one SGD step in the port's Trainer the weights
    and the BN statistics equal the unwrapped trainer's."""
    plain, wrapped = _pair(remat)
    blocks = _wrapped_blocks(wrapped)
    assert len(blocks) == (16 if remat is True else 3)
    x = torch.from_numpy(_x((4, SIZE, SIZE, 3)))
    outs, grads = [], []
    for model in (plain, wrapped):
        model.train()
        y = model(x)
        y.square().mean().backward()
        outs.append(y.detach())
        grads.append([p.grad for p in model.parameters()])
    scale = outs[0].abs().max()
    assert (outs[1] - outs[0]).abs().max() <= REMAT_TOL * scale
    for ga, gb in zip(*grads):
        assert (gb - ga).abs().max() <= REMAT_TOL * (ga.abs().max() + 1e-30)
    data = np.random.default_rng(5)
    xb = data.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    yb = data.integers(0, 10, 4)
    after = []
    for model in _pair(remat, seed=4):
        tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                     TrainerConfig(print_freq=0), device="cpu")
        tr.initialize(model.state_dict())
        tr.train_step(xb, yb)
        after.append(list(tr.model.state_dict().values()))
    for a, b in zip(*after):
        assert torch.equal(a, b)


def test_jax_remat_names_load_and_match():
    """A JAX remat model's tree (``.../0/module/cb1/...``) loads through
    ``from_jax_params`` into the port's remat model, whose eval logits match
    the JAX model's."""
    cfg = dict(NARROW, remat=("layer1", "layer3"))
    j_model = jax_models.build("resnet", **cfg)
    params, state = j_model.init(jax.random.PRNGKey(2))
    params, state = _numpy(params), _numpy(state)
    assert "module" in params["layers"]["layer1"]["0"]
    assert "module" not in params["layers"]["layer2"]["0"]
    model = models.build("resnet", **cfg)
    model.load_state_dict(from_jax_params(params, state))
    x = _x((2, SIZE, SIZE, 3))
    ref = np.asarray(j_model(params, state, jnp.asarray(x),
                             Context(train=False))[0])
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_cifar_remat_wraps_every_block_as_jax():
    """``ResNet_cifar`` takes a bool: any true value wraps every block, as
    in the JAX package; the parameter names are the JAX tree's."""
    for remat in (True, ("layer1",)):
        model = models.build("resnet", dataset="cifar10", depth=8,
                             remat=remat)
        assert len(_wrapped_blocks(model)) == 3
        params, state = jax_models.build("resnet", dataset="cifar10",
                                         depth=8, remat=remat).init(
            jax.random.PRNGKey(0))
        model.load_state_dict(from_jax_params(_numpy(params),
                                              _numpy(state)))


def test_remat_eval_takes_the_fused_route(monkeypatch):
    """In eval a remat model calls the block directly: the same 33 ConvBNs
    run the fused 1x1 route as without remat."""
    calls = []
    real = resnet.conv1x1_bn_act

    def counted(*a, **kw):
        calls.append(None)
        return real(*a, **kw)

    monkeypatch.setattr(resnet, "conv1x1_bn_act", counted)
    _, wrapped = _pair(True)
    wrapped.eval()
    assert sum(isinstance(m, ConvBN) and m.uses_kernel()
               for m in wrapped.modules()) == 33
    with torch.no_grad():
        wrapped(torch.from_numpy(_x((2, SIZE, SIZE, 3))))
    assert len(calls) == 33


def test_remat_dropout_draws_once():
    """A wrapped block with Dropout: the recompute reuses the first
    forward's masks (same output gradients as the unwrapped block) and the
    generator moves once."""
    def block():
        torch.manual_seed(0)
        return Sequential(Conv2d(4, 4, 3, 1, 1), Dropout(0.5))

    x = torch.from_numpy(_x((2, 6, 6, 4)))
    res = []
    for wrap in (False, True):
        b = block()
        gen = torch.Generator().manual_seed(9)
        b[1].generator = gen
        m = CheckpointModule(b) if wrap else b
        m.train()
        y = m(x)
        y.square().sum().backward()
        res.append((y.detach(), b[0].weight.grad, gen.get_state()))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
    assert torch.equal(res[0][2], res[1][2])


def test_remat_policy_raises():
    with pytest.raises(ValueError, match="policy"):
        CheckpointModule(ConvBN(4, 4, 1), policy="nothing_saveable")
