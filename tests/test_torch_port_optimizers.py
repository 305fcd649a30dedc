"""The port's optimizers and regularizers against the JAX package's, on the
CPU.

Adam, AdamW, LARS and LAMB each take two steps on the same tensors, with a
weight-decay mask and several hyper-parameter sets, in
``convnet_tpu_torch.regimes.optim`` and in ``convnet_tpu.regimes.optim``;
parameters and state slots agree to 1e-6 (the same float32 arithmetic in
another order: the port adds ``lr·d`` and the moments' terms in fused
foreach operations, and rounds its bias corrections once from float32 βs).
Then the regime side: the state slots ``init_state`` makes for a regime (the
union over every optimizer it names, so a switch finds its slots), the
BoundedWeightNorm norms and renormalisation (1e-6), the ``large_lars``
ResNet regime's hyper-parameters at several steps (equal), and a
``state_dict`` round trip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.regimes import regularization as jax_reg
from convnet_tpu_torch import models
from convnet_tpu_torch.regimes import optim, regularization

TOL = 1e-6
SHAPES = [(3, 4), (5,), (2, 2, 3), (4, 3)]
MASK = [True, False, True, True]


def _rng(seed):
    return np.random.default_rng(seed)


def _tensors(rng, scale=1.0):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _tree(arrays):
    return {str(i): jnp.asarray(a) for i, a in enumerate(arrays)}


def _close(ours, theirs, what):
    for i, t in enumerate(ours):
        np.testing.assert_allclose(t.numpy(), np.asarray(theirs[str(i)]),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} {i}")


# each optimizer's hyper-parameters (over HP_DEFAULTS): plain, with both
# kinds of weight decay, and with other momenta and moments
HP_SETS = {
    "Adam": [{"lr": 1e-3},
             {"lr": 2e-3, "weight_decay": 1e-2,
              "decoupled_weight_decay": 0.05},
             {"lr": 1e-2, "beta1": 0.8, "beta2": 0.99, "eps": 1e-6}],
    "LARS": [{"lr": 0.5, "momentum": 0.9},
             {"lr": 2.0, "momentum": 0.9, "weight_decay": 1e-4,
              "trust_coef": 0.001},
             {"lr": 0.1, "momentum": 0.5, "weight_decay": 5e-2,
              "trust_coef": 0.02}],
    "LAMB": [{"lr": 1e-2},
             {"lr": 5e-3, "weight_decay": 1e-2},
             {"lr": 2e-2, "beta1": 0.8, "beta2": 0.99, "eps": 1e-6,
              "weight_decay": 0.1}],
}
HP_SETS["AdamW"] = HP_SETS["Adam"]
CASES = [(name, i) for name in ("Adam", "AdamW", "LARS", "LAMB")
         for i in range(3)]


@pytest.mark.parametrize("name,variant", CASES)
def test_optimizer_two_steps_match_jax(name, variant):
    """Two steps from non-zero state slots; in the third variant one decayed
    tensor is all zeros, so LARS's and LAMB's zero-norm branch runs."""
    rng = _rng(10 + variant)
    params = _tensors(rng)
    if variant == 2:
        params[3][:] = 0.0
    _, _, slots = optim.OPTIMIZERS[name]
    state0 = {s: _tensors(rng, 0.1) for s in slots}
    if "v" in state0:
        state0["v"] = [np.abs(v) for v in state0["v"]]
    grads = [_tensors(rng) for _ in range(2)]
    hp = {**optim.HP_DEFAULTS, **HP_SETS[name][variant]}

    spec = jax_optim.OPTIMIZERS[name]
    assert tuple(spec["slots"]) == slots
    jp = _tree(params)
    jstate = {"step": jnp.int32(0), **{s: _tree(v) for s, v in state0.items()}}
    mask01 = {str(i): jnp.float32(m) for i, m in enumerate(MASK)}
    jhp = {k: jnp.float32(v) for k, v in hp.items()}

    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = {"step": 0, **{s: [torch.from_numpy(a.copy()) for a in v]
                            for s, v in state0.items()}}
    step = optim.optimizer_step(name)
    for g in grads:
        jp, jstate = spec["step"](jp, _tree(g), jstate, jhp, mask01=mask01,
                                  **spec["kwargs"])
        step(tp, [torch.from_numpy(a) for a in g], tstate, hp, mask=MASK)
    assert tstate["step"] == int(jstate["step"]) == 2
    _close(tp, jp, "param")
    for s in slots:
        _close(tstate[s], jstate[s], s)


def test_adamw_decays_twice_as_the_reference_does():
    """The reference's AdamW adds ``weight_decay`` to the gradient and to
    the decoupled decay; the port keeps that (ROADMAP.md §3). With zero
    gradients and moments, one step is then p·(1 − lr·wd) − lr·m̂/(√v̂+eps)
    where the moments come from wd·p alone."""
    p = torch.tensor([1.0, -2.0])
    hp = {**optim.HP_DEFAULTS, "lr": 0.1, "weight_decay": 0.5}
    state = {"step": 0, "m": [torch.zeros(2)], "v": [torch.zeros(2)]}
    optim.adam_step([p], [torch.zeros(2)], state, hp, adamw=True)
    coupled = torch.tensor([1.0, -2.0]) * 0.5     # g = wd·p: m̂/√v̂ = sign
    expected = torch.tensor([1.0, -2.0]) * (1 - 0.1 * 0.5) \
        - 0.1 * coupled / (coupled.abs() + 1e-8)
    torch.testing.assert_close(p, expected)


# ------------------------------------------------------- regime state slots

SGD = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9}
REGIMES = {
    "SGD": [{"epoch": 0, **SGD}],
    "RMSprop": [{"epoch": 0, "optimizer": "RMSprop", "lr": 0.01}],
    "SGD_to_RMSprop": [{"epoch": 0, **SGD},
                       {"epoch": 1, "optimizer": "RMSprop", "lr": 0.01}],
    "SGD_LARS_Adam": [{"epoch": 0, **SGD}, {"epoch": 1, "optimizer": "LARS"},
                      {"epoch": 2, "optimizer": "Adam", "lr": 1e-3}],
    "LAMB": [{"epoch": 0, "optimizer": "LAMB", "lr": 1e-3}],
    "LAMB_bounded": [{"epoch": 0, "optimizer": "LAMB", "lr": 1e-3,
                      "regularizer": {"name": "BoundedWeightNorm"}}],
}


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_init_state_slots_match_jax(name):
    ours = optim.OptimRegime(REGIMES[name])
    theirs = jax_optim.OptimRegime(REGIMES[name])
    assert ours.needed_slots == theirs.needed_slots
    assert ours.uses_bounded_norm == theirs.uses_bounded_norm
    params = [torch.zeros(s) for s in SHAPES]
    state = ours.init_state(params)
    j_state = theirs.init_state({"w": jnp.zeros((2, 3)),
                                 "b": jnp.zeros((3,))})
    assert set(state) == set(j_state)
    for slot in set(state) - {"step"}:
        assert len(state[slot]) == len(params)
        if slot != "norms":
            assert all(not t.any() and t.shape == p.shape
                       for t, p in zip(state[slot], params))
    # every optimizer the regime reaches finds its slots
    for entry in REGIMES[name]:
        assert set(optim.optimizer_slots(entry["optimizer"])) <= set(state)


def test_registry_matches_jax():
    assert set(optim.OPTIMIZERS) == set(jax_optim.OPTIMIZERS)
    for name, (_, _, slots) in optim.OPTIMIZERS.items():
        assert tuple(jax_optim.OPTIMIZERS[name]["slots"]) == slots, name
        assert optim.optimizer_slots(name) == slots


# --------------------------------------------------------- BoundedWeightNorm

def test_bounded_weight_norm_matches_jax():
    rng = _rng(20)
    params = _tensors(rng)
    params[2][:] = 0.0                       # a decayed tensor of norm 0
    moved = [p * 1.7 + 0.1 * q for p, q in zip(params, _tensors(rng))]
    tree = _tree(params)
    mask = {str(i): m for i, m in enumerate(MASK)}
    j_norms = jax_reg.init_norms(tree, mask)
    norms = regularization.init_norms(
        [torch.from_numpy(p) for p in params], MASK)
    _close(norms, j_norms, "norm")
    renormed = jax_reg.bounded_weight_norm(_tree(moved), j_norms, mask)
    ours = [torch.from_numpy(p.copy()) for p in moved]
    regularization.bounded_weight_norm(ours, norms, MASK)
    _close(ours, renormed, "renormed")
    assert regularization.spec_kind({"name": "BoundedWeightNorm"}) == \
        jax_reg.spec_kind({"name": "BoundedWeightNorm"}) == "BoundedWeightNorm"
    assert regularization.spec_kind(None) is None


@pytest.mark.parametrize("spec", [{"name": "BoundedWeightNorm"},
                                  {"name": "WeightDecay", "value": 5e-4},
                                  {"name": "L2Regularization", "value": 1e-3}])
def test_regularizer_hyperparams_match_jax(spec):
    regime = [{"epoch": 0, "optimizer": "SGD", "regularizer": spec}]
    assert (optim.OptimRegime(regime).hyperparams()
            == jax_optim.OptimRegime(regime).hyperparams())


# ------------------------------------------------------- LARS regime, state

@pytest.mark.parametrize("epoch,step", [(0, 0), (0, 1), (2, 700), (5, 1560),
                                        (40, 13000), (89, 28000)])
def test_large_lars_hyperparams_match_jax(epoch, step):
    ours = optim.OptimRegime(models.build(
        "resnet", depth=50, regime="large_lars", batch_size=4096).regime)
    theirs = jax_optim.OptimRegime(jax_models.build(
        "resnet", depth=50, regime="large_lars", batch_size=4096).regime)
    ours.update(epoch, step)
    theirs.update(epoch, step)
    assert ours.optimizer_name == theirs.optimizer_name == "LARS"
    assert ours.hyperparams() == theirs.hyperparams()
    if step < 1560:                      # the 5-epoch warm-up of 312 steps
        assert ours.hyperparams()["lr"] == pytest.approx(
            7.4 * (step + 1) / 1560)


def test_state_dict_round_trip_matches_jax():
    regime = models.build("resnet", depth=50, regime="normal").regime
    ours, theirs = optim.OptimRegime(regime), jax_optim.OptimRegime(regime)
    for r in (ours, theirs):
        r.update(35.5, 11000)
    assert ours.state_dict() == theirs.state_dict()
    back = optim.OptimRegime(regime)
    back.load_state_dict(ours.state_dict())
    assert back.hyperparams() == ours.hyperparams()
    assert back.hyperparams()["lr"] == pytest.approx(1e-2)
