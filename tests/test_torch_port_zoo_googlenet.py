"""GoogLeNet with its auxiliary heads in the port against the JAX package,
on the CPU, at 64x64 (the JAX tests' size): the eval forward with BN folded
(with and without heads: eval never runs them); one float32 SGD step with
the heads (their losses in the gradient) against the JAX trainer's; the aux
terms of the training loss against the JAX trainer's ``_loss_fn``, head by
head; that the heads run only in a training forward given a collector, get
gradients, and that ``validate`` and ``calibrate_bn`` leave them alone; the
kernel routes of a forward; and ``torch_import`` of a torch GoogLeNet with
aux heads registered mid-trunk (the twin of ``tests/test_torch_import.py``)
against the JAX importer.

Helpers and the eval and step tolerances come from
``test_torch_port_zoo_small.py``, except the step's: GoogLeNet's first step
at batch 4 is 1.1% from the JAX trainer's in norm (2.4% in the worst
tensor), where the port's float32 is 1.2e-4 from its own float64
(``scripts/port_numerics.py zoo``): the reference's float32 BatchNorm
moments over 2x2 maps are the noisier side (ROADMAP.md §3). So the updates
are held at 5% in norm and 10% a tensor, as ``chip_smoke.py`` holds the
card's step to the CPU's, and BN statistics at 1e-3. The
training forward's terms (logits, each head's logits, the loss): 1e-3 of
the largest, relative for the loss; its float32 noise at batch 4 is 6.8e-5
of the largest logit (float32 against float64, the same script), and the two
packages' logits sat 1.8e-4 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_import as JTI
import test_torch_port_zoo_small as Z
from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.utils.torch_import import (
    import_torch_state_dict as jax_import)
from convnet_tpu_torch import models
from convnet_tpu_torch.models.resnet import ConvBN
from convnet_tpu_torch.nn import BatchNorm2d, MaxPool2d
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import to_jax_params
from convnet_tpu_torch.utils.torch_import import import_torch_state_dict

AUX = {"aux_classifiers": True, "num_classes": 10}
SIZE = 64
TERM_TOL = 1e-3


@pytest.mark.parametrize("config", [{"num_classes": 10}, AUX])
def test_eval_forward_matches_jax(config):
    assert Z.eval_match("googlenet", config, (2, SIZE, SIZE, 3)) \
        <= Z.LOGIT_TOL


def test_float32_step_with_aux_heads_matches_jax(monkeypatch):
    monkeypatch.setattr(Z, "UPDATE_NORM_TOL", 5e-2)
    monkeypatch.setattr(Z, "TENSOR_NORM_TOL", 1e-1)
    monkeypatch.setattr(Z, "STAT_TOL", 1e-3)
    Z.step_match("googlenet", AUX, (4, SIZE, SIZE, 3), 10)


def test_aux_terms_match_jax_loss_fn():
    """The training forward (dropout 0) at batch 4: the main logits and each
    head's (weight, logits) against the JAX model's ``Context.aux``, and the
    total loss against the JAX trainer's ``_loss_fn``."""
    model = Z.port_model("googlenet", AUX, seed=2)
    Z.zero_dropout(port_module=model)
    params, state = Z.jax_trees(model)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    j_model = jax_models.build("googlenet", **AUX)
    Z.zero_dropout(j_model)
    j_tr = Z.JaxTrainer(j_model, Z.jax_optim.OptimRegime(j_model.regime),
                        10, Z.JaxTrainerConfig(dtype="float32",
                                               print_freq=0))

    @jax.jit
    def reference(p, s, a, b):
        ctx = Context(train=True, rng=jax.random.PRNGKey(0), aux=[])
        logits, _ = j_model(p, s, a, ctx)
        loss = j_tr._loss_fn(p, s, a, b, jax.random.PRNGKey(0), None)[0]
        return logits, ctx.aux, loss

    j_logits, j_aux, j_loss = reference(params, state, jnp.asarray(x),
                                        jnp.asarray(y))
    tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu")
    model.train()
    heads = []
    with torch.no_grad():
        logits = model(torch.from_numpy(x), aux=heads)
        loss, _ = tr._loss(torch.from_numpy(x), torch.from_numpy(y).long())
    assert Z.rel(logits.numpy(), j_logits) <= TERM_TOL
    assert [w for w, _ in heads] == [w for w, _ in j_aux] == [0.3, 0.3]
    for (_, ours), (_, ref) in zip(heads, j_aux):
        assert Z.rel(ours.numpy(), ref) <= TERM_TOL
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=TERM_TOL)
    main = float(tr.criterion(logits, torch.from_numpy(y).long()))
    terms = sum(w * float(tr.criterion(a, torch.from_numpy(y).long()))
                for w, a in heads)
    np.testing.assert_allclose(float(loss), main + terms, rtol=1e-6)


def _trainer(seed=0):
    model = models.build("googlenet", **AUX)
    tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu",
                 seed=seed)
    tr.initialize()
    return tr


def _batch(n=4, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, 10, n))


def test_aux_heads_run_only_in_training_and_get_gradients():
    tr = _trainer()
    model = tr.model
    calls = []
    for head in (model.aux1, model.aux2):
        head.register_forward_hook(lambda *_: calls.append(1))
    x, y = _batch()
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x))              # no collector: no head
    assert not calls
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("aux1.", "aux2."))}
    tr.train_step(x, y)
    assert len(calls) == 2
    grads = [p.grad for n, p in model.named_parameters()
             if n.startswith(("aux1.classifier.fc2", "aux2.classifier.fc2"))]
    assert grads and all(g is not None and g.abs().max() > 0 for g in grads)
    moved = [n for n, p in model.named_parameters() if n in before
             and not torch.equal(p, before[n])]
    assert len(moved) == len(before)
    heads = []
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(x), aux=heads)
    assert not heads and len(calls) == 2


def test_every_loss_of_a_step_adds_the_heads():
    """A step in two chunks with mixup and the gradient-norm scale measured
    (``duplicates`` 2): both heads run in each chunk's forward and in the
    scale's extra pass, and their losses reach their last layers."""
    model = models.build("googlenet", **AUX)
    tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                 TrainerConfig(dtype="float32", print_freq=0, chunk_batch=2,
                               mixup_alpha=0.2, duplicates=2,
                               adapt_grad_norm=1), device="cpu")
    tr.initialize()
    calls = []
    for head in (model.aux1, model.aux2):
        head.register_forward_hook(lambda *_: calls.append(1))
    x, y = _batch(seed=7)
    m = tr.train_step(np.repeat(x[:2], 2, 0), np.repeat(y[:2], 2))
    assert np.isfinite(float(m["loss"])) and len(calls) == 2 * (2 + 1)
    assert all(p.grad.abs().max() > 0 for n, p in model.named_parameters()
               if n.startswith(("aux1.classifier.fc2",
                                "aux2.classifier.fc2")))


def test_validate_and_calibrate_bn_leave_the_heads_alone():
    tr = _trainer(seed=1)
    model = tr.model
    calls = []
    for head in (model.aux1, model.aux2):
        head.register_forward_hook(lambda *_: calls.append(1))
    x, y = _batch(seed=5)
    tr.validate([(x, y)])
    assert not calls
    bns = {n: (m.running_mean.clone(), m.running_var.clone())
           for n, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    assert tr.calibrate_bn([(x, y), _batch(seed=6)], num_steps=2) == 2
    assert not calls
    for n, m in model.named_modules():
        if not isinstance(m, BatchNorm2d):
            continue
        same = (torch.equal(m.running_mean, bns[n][0])
                and torch.equal(m.running_var, bns[n][1]))
        assert same == n.startswith(("aux1.", "aux2.")), n


def test_kernel_routes_of_a_forward():
    """Eval: 37 fused 1x1 ConvBNs (the heads' 1x1s do not run) and 13 max
    pools (the stem's two, the two between stages and one stride-1 pool in
    each of the nine blocks); training: the same 13 pools, no fused 1x1."""
    model = models.build("googlenet", **AUX)
    fused, pools = [], []
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(
                lambda mod, *_: fused.append(mod.uses_kernel()))
        elif isinstance(m, MaxPool2d):
            m.register_forward_hook(
                lambda mod, *_: pools.append((mod.kernel_size, mod.stride,
                                              mod.padding)))
    x = torch.from_numpy(_batch(2)[0])
    with torch.no_grad():
        model.eval()(x)
        assert sum(fused) == 37 and len(pools) == 13
        assert pools.count((3, 1, 1)) == 9 and pools.count((3, 2, 1)) == 4
        fused.clear()
        pools.clear()
        Z.zero_dropout(port_module=model)
        model.train()(x, aux=[])
        assert sum(fused) == 0 and len(pools) == 13


def _torch_twin(aux, seed):
    tm = JTI._TorchGoogLeNet(classes=13, aux=aux)
    JTI._randomize_bn_stats(tm, np.random.default_rng(seed))
    return tm.eval()


def test_torch_import_with_aux_heads_matches_jax_importer():
    """Torch registers the heads mid-trunk, both packages define them last:
    they pair by name. The imported weights equal the JAX importer's (its
    template: the port's own trees, so no JAX init), and the eval logits
    the torch twin's within 3e-4 (``tests/test_torch_import.py``'s
    tolerance for this net)."""
    tm = _torch_twin(True, 9)
    model = models.build("googlenet", num_classes=13, aux_classifiers=True)
    sd = import_torch_state_dict(tm.state_dict(), model)
    model.load_state_dict(sd)
    params, state = to_jax_params(model.state_dict())
    jp, js = jax_import(tm.state_dict(),
                        jax_models.build("googlenet", num_classes=13,
                                         aux_classifiers=True),
                        params, state)
    ours_p, ours_s = to_jax_params(sd)
    for ours, ref in ((ours_p, jp), (ours_s, js)):
        ref = dict(Z.leaves(ref))
        got = dict(Z.leaves(ours))
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    np.testing.assert_array_equal(
        model.aux1.conv.conv.weight.detach().numpy(),
        tm.aux1.conv.conv.weight.detach().numpy())
    x = np.random.default_rng(10).standard_normal(
        (2, 3, SIZE, SIZE)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
        out = model.eval()(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 2, 3, 1)))).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-4, atol=3e-4)


def test_torch_import_drops_heads_into_a_model_without_them():
    tm = _torch_twin(True, 11)
    model = models.build("googlenet", num_classes=13)
    with pytest.warns(UserWarning, match="aux"):
        model.load_state_dict(import_torch_state_dict(tm.state_dict(),
                                                      model))
    x = np.random.default_rng(12).standard_normal(
        (2, 3, SIZE, SIZE)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
        out = model.eval()(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 2, 3, 1)))).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-4, atol=3e-4)
