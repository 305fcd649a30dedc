"""The port's npz checkpoint, serving from a checkpoint, ``utils/log.py``
and ``utils/misc.py``, against the JAX package's, on the CPU.

One archive format both ways: a checkpoint the port writes loads in the
JAX package's ``load_checkpoint`` and its model gives the port's logits; a
checkpoint the JAX trainer writes after two SGD steps loads in the port's
``Trainer``, whose next step matches the JAX trainer's next step (the terms
of ``test_torch_port_cifar_se.py``: loss ``LOSS_TOL``, BN statistics
``STAT_TOL``, updates in norm ``NORM_TOL``; ``scripts/port_numerics.py
cifar_se`` measures this net's steps 0.3% apart in norm). bfloat16 leaves
are read and written without ``ml_dtypes``, which the card's machine does
not have.
"""

import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_cifar_se as C
from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.serve import Predictor as JaxPredictor
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu.utils import checkpoint as jax_ckpt
from convnet_tpu.utils import log as jax_log
from convnet_tpu_torch import models
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.serve import Predictor
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils import checkpoint as ckpt_mod
from convnet_tpu_torch.utils import log as port_log
from convnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                peek_checkpoint_meta,
                                                save_checkpoint,
                                                wait_for_pending_save)
from convnet_tpu_torch.utils.from_jax import to_jax_params
from convnet_tpu_torch.utils.misc import set_global_seeds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SE_CIFAR = ("resnet_se", {"dataset": "cifar10", "depth": 8,
                          "se_reduction": 4})
RN20 = ("resnet", {"dataset": "cifar10", "depth": 20})
BATCH = 16


def _port_trainer(name, config, regime=None, seed=3, **cfg):
    model = models.build(name, **config)
    tr = Trainer(model, optim.OptimRegime(regime or model.regime),
                 model.fc.out_features, TrainerConfig(print_freq=0, **cfg),
                 device="cpu", seed=seed)
    tr.initialize()
    return tr


def _batches(n, classes=10, seed=7):
    return C.batches(n, BATCH, classes, seed=seed)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port trainer (SE ResNet-8 on CIFAR-10) after two SGD steps with
    momentum, saved with its model name and config."""
    name, config = SE_CIFAR
    tr = _port_trainer(name, config)
    for x, y in _batches(2):
        tr.train_step(x, y)
    path = str(tmp_path_factory.mktemp("port_ckpt"))
    save_checkpoint(tr.checkpoint_dict(model=name, config=config,
                                       best_prec1=12.5), True, path)
    return tr, path


def test_port_checkpoint_loads_in_jax(port_run):
    """The JAX package's ``load_checkpoint`` reads the port's archive: its
    model gives the port's eval logits from ``params`` and ``state``, and
    ``opt_state`` has the tree of the JAX trainer's own state."""
    tr, path = port_run
    name, config = SE_CIFAR
    ck = jax_ckpt.load_checkpoint(path)
    assert ck["model"] == name and ck["config"] == config
    assert ck["best_prec1"] == 12.5 and ck["training_steps"] == 2
    assert os.path.exists(os.path.join(path, "model_best.npz"))
    j_model = jax_models.build(name, **config)
    x = C.images(4, 1)
    ref = np.asarray(j_model(ck["params"], ck["state"], jnp.asarray(x),
                             Context(train=False))[0])
    with torch.no_grad():
        out = tr.model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= C.LOGIT_TOL * np.abs(ref).max()
    j_tr = JaxTrainer(j_model, jax_optim.OptimRegime(j_model.regime), 10,
                      JaxTrainerConfig(print_freq=0))
    params, state = j_model.init(jax.random.PRNGKey(0))
    _, _, template = j_tr.initialize(params, state)
    assert (jax.tree_util.tree_structure(ck["opt_state"])
            == jax.tree_util.tree_structure(template))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_equal(
        np.shape(a), np.shape(b)), ck["opt_state"], template)
    assert int(ck["opt_state"]["step"]) == 2


def test_port_checkpoint_roundtrip(port_run):
    """The port reads its own archive back: weights, BN statistics and
    momentum bit for bit; the meta blob alone through
    ``peek_checkpoint_meta``."""
    tr, path = port_run
    meta = peek_checkpoint_meta(path)
    assert meta["model"] == "resnet_se" and "params" not in meta
    fresh = _port_trainer(*SE_CIFAR, seed=11)
    fresh.load_checkpoint(load_checkpoint(path))
    for (k, a), b in zip(tr.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(tr.opt_state["mu"], fresh.opt_state["mu"]):
        assert torch.equal(a, b)
    assert fresh.opt_state["step"] == 2 and fresh.training_steps == 2


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX trainer's checkpoint after two SGD steps (the CLI's keys)
    loads in the port; the port's next step matches the JAX trainer's next
    step."""
    name, config = RN20
    params, state = C.jax_init(name, config, seed=3)
    j_model = jax_models.build(name, **config)
    j_tr = JaxTrainer(j_model, jax_optim.OptimRegime(j_model.regime), 10,
                      JaxTrainerConfig(dtype="float32", print_freq=0))
    params, state, opt = j_tr.initialize(params, state)
    j_tr.optim.update(0, 0)
    hp = j_tr._hp_device(j_tr.optim.hyperparams())
    step = j_tr._get_train_step()
    data = _batches(3)
    for x, y in data[:2]:
        params, state, opt, _ = step(params, state, opt, jnp.asarray(x),
                                     jnp.asarray(y), hp,
                                     jax.random.PRNGKey(0))
    jax_ckpt.save_checkpoint(
        {"epoch": 0, "batch_idx": 2, "model": name, "config": config,
         "params": params, "state": state, "opt_state": opt,
         "best_prec1": 0.0, "training_steps": 2,
         "rng": np.asarray(jax.random.PRNGKey(0)).tolist()},
        False, str(tmp_path))
    before = C._numpy((params, state, opt["mu"]))
    params, state, opt, m = step(params, state, opt,
                                 jnp.asarray(data[2][0]),
                                 jnp.asarray(data[2][1]), hp,
                                 jax.random.PRNGKey(0))
    tr = _port_trainer(name, config, seed=11)
    tr.load_checkpoint(load_checkpoint(str(tmp_path)))
    assert tr.training_steps == 2 and tr.opt_state["step"] == 2
    loss = float(tr.train_step(*data[2])["loss"])
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=C.LOSS_TOL)
    total, tensors, stats = C.step_errors(
        before, C._numpy((params, state)),
        to_jax_params(tr.model.state_dict()))
    assert total <= C.NORM_TOL["all"]
    assert max(tensors.values()) <= C.NORM_TOL["tensor"]
    assert stats <= C.STAT_TOL
    assert tr.opt_state["step"] == int(opt["step"]) == 3


_DECODE = """
import sys
sys.modules["ml_dtypes"] = None          # import ml_dtypes raises
import numpy as np, torch
from convnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)
ck = load_checkpoint(sys.argv[1])
w = ck["params"]["layer"]["w"]
assert w.dtype == torch.bfloat16, w.dtype
assert torch.equal(w.float(), torch.from_numpy(np.load(sys.argv[2])))
assert ck["params"]["layer"]["b"].dtype == np.float32
save_checkpoint({"params": {"layer": {"w": w * 2}}}, False, sys.argv[3])
print("ok", "ml_dtypes" in sys.modules and sys.modules["ml_dtypes"])
"""


def test_bf16_leaves_without_ml_dtypes(tmp_path):
    """A JAX checkpoint with bfloat16 leaves decodes in a process where
    ``import ml_dtypes`` fails; the port writes bfloat16 leaves that the JAX
    package reads back as bfloat16."""
    w = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_ckpt.save_checkpoint(
        {"params": {"layer": {"w": w, "b": jnp.ones(5)}}}, False,
        str(jax_dir))
    np.save(tmp_path / "w.npy", np.asarray(w.astype(jnp.float32)))
    proc = subprocess.run(
        [sys.executable, "-c", _DECODE, str(jax_dir), str(tmp_path / "w.npy"),
         str(port_dir)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok", "None"]
    back = jax_ckpt.load_checkpoint(str(port_dir))["params"]["layer"]["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back, np.float32),
                                  np.asarray(w * 2, np.float32))


def test_background_save_copies_first_and_raises_later(tmp_path):
    """``background=True`` copies the trees before it returns (an in-place
    update afterwards does not reach the file); a failed write raises at the
    next save, and the error is cleared once raised."""
    t = torch.arange(6, dtype=torch.float32)
    save_checkpoint({"params": {"w": t}, "epoch": 1}, False, str(tmp_path),
                    background=True)
    t.add_(100.0)
    wait_for_pending_save()
    np.testing.assert_array_equal(
        load_checkpoint(str(tmp_path))["params"]["w"], np.arange(6))
    bad = tmp_path / "bad"
    (bad / "checkpoint.npz.tmp").mkdir(parents=True)   # open() fails
    save_checkpoint({"params": {"w": t}}, False, str(bad), background=True)
    with pytest.raises(IsADirectoryError):
        save_checkpoint({"params": {"w": t}}, False, str(tmp_path))
    wait_for_pending_save()                            # nothing pending
    save_checkpoint({"params": {"w": t}, "epoch": 2}, False, str(tmp_path),
                    save_all=True)
    assert os.path.exists(tmp_path / "checkpoint_epoch_2.npz")


def test_adapt_opt_state_sgd_into_adam(tmp_path, caplog):
    """SGD's slots resumed into an Adam regime: ``mu`` is dropped, ``m`` and
    ``v`` start at zero, ``step`` carries over, as the JAX package's
    ``adapt_opt_state`` fits the same trees; then the Adam step runs."""
    tr = _port_trainer(*SE_CIFAR)
    x, y = _batches(1)[0]
    tr.train_step(x, y)
    save_checkpoint(tr.checkpoint_dict(), False, str(tmp_path))
    ck = load_checkpoint(str(tmp_path))
    adam = [{"epoch": 0, "optimizer": "Adam", "lr": 1e-3}]
    new = _port_trainer(*SE_CIFAR, regime=adam)
    template = {k: (ckpt_mod.slots_to_tree(new.model, v)
                    if isinstance(v, list) else np.int32(v))
                for k, v in new.opt_state.items()}
    ref = jax_ckpt.adapt_opt_state(ck["opt_state"], template)
    with caplog.at_level(logging.WARNING):
        new.load_checkpoint(ck)
    assert "dropping the checkpoint's opt_state slot 'mu'" in caplog.text
    assert sorted(new.opt_state) == sorted(ref) == ["m", "step", "v"]
    assert new.opt_state["step"] == int(ref["step"]) == 1
    for slot in ("m", "v"):
        assert all(not t.any() for t in new.opt_state[slot])
    new.train_step(x, y)
    assert new.opt_state["step"] == 2


def test_adapt_opt_state_flat_to_tree_matches_jax():
    """A slot the JAX package stored flat and padded (``--flat-optim``,
    ZeRO-1) is cut into the per-tensor tree in ``ravel_pytree`` order, as
    the JAX package's ``adapt_opt_state`` cuts it; missing slots keep the
    template's values and extra ones are dropped."""
    from jax.flatten_util import ravel_pytree
    tree = {"b": {"w": np.arange(6, dtype=np.float32).reshape(2, 3) + 10},
            "a": np.arange(4, dtype=np.float32)}
    flat, _ = ravel_pytree(tree)
    padded = np.pad(np.asarray(flat), (0, 6))
    template = {"mu": jax.tree_util.tree_map(np.zeros_like, tree),
                "v": {"a": np.ones(4), "b": {"w": np.ones((2, 3))}},
                "step": np.int32(0)}
    loaded = {"mu": padded, "step": np.int32(4), "legacy": np.ones(3)}
    ours = ckpt_mod.adapt_opt_state(loaded, template)
    ref = jax_ckpt.adapt_opt_state(loaded, template)
    assert sorted(ours) == sorted(ref) == ["mu", "step", "v"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, ours, ref)
    np.testing.assert_array_equal(ours["mu"]["b"]["w"], tree["b"]["w"])


def test_flatten_tree_roundtrip():
    tree = {"a": {"b": np.ones(3), "c": torch.zeros(2, 2)},
            "d": np.arange(4)}
    flat = ckpt_mod.flatten_tree(tree)
    assert set(flat) == set(jax_ckpt.flatten_tree(
        {"a": {"b": np.ones(3), "c": np.zeros((2, 2))}, "d": np.arange(4)}))
    assert isinstance(flat["a/c"], np.ndarray)
    back = ckpt_mod.unflatten_tree(flat)
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(back["d"], tree["d"])


@pytest.fixture(scope="module")
def served(port_run):
    """The port run's checkpoint served by both packages in float32."""
    _, path = port_run
    images = np.random.default_rng(4).integers(0, 256, (5, 32, 32, 3),
                                               np.uint8)
    ref = JaxPredictor(checkpoint=path, dtype="float32",
                       batch_size=4).predict_logits(images)
    port = Predictor.from_checkpoint(path, dtype="float32", batch_size=4,
                                     device="cpu")
    return images, ref, port


def test_predictor_from_checkpoint_matches_jax(served):
    """``Predictor.from_checkpoint`` rebuilds the model from the file alone,
    normalises with CIFAR-10's statistics and serves the JAX
    ``Predictor(checkpoint=...)``'s logits (5 images in batches of 4)."""
    images, ref, port = served
    assert port.input_size == 32
    np.testing.assert_allclose(port._mean.numpy(), [0.491, 0.482, 0.447])
    out = port(images)
    assert out.shape == ref.shape == (5, 10)
    assert np.abs(out - ref).max() <= C.LOGIT_TOL * np.abs(ref).max()
    np.testing.assert_array_equal(out, port.predict_logits(images))


def test_predictor_checkpoint_config_override(port_run):
    """``model_config`` entries override the checkpoint's; an explicit
    ``model_name`` builds that model from the checkpoint's weights."""
    _, path = port_run
    p = Predictor(checkpoint=path, model_config={"num_classes": 10},
                  dtype="float32", device="cpu")
    assert p.model.fc.out_features == 10
    p = Predictor("resnet_se", SE_CIFAR[1], checkpoint=path,
                  dtype="float32", device="cpu", normalize=None)
    assert p._mean is None


def test_predictor_refuses_torch_checkpoints(tmp_path):
    path = tmp_path / "model.pth"
    torch.save({"state_dict": {}}, path)
    with pytest.raises(ValueError, match="torch checkpoint"):
        Predictor("resnet", checkpoint=str(path), device="cpu")
    with pytest.raises(ValueError, match="model_name"):
        Predictor(device="cpu")


# ------------------------------------------------------ utils/log, misc

def test_results_log_matches_jax(tmp_path):
    """The port's ``ResultsLog`` (as tests/test_checkpoint.py tests the JAX
    one) writes the same CSV, JSON and HTML as the JAX package's."""
    out = {}
    for name, mod in (("jax", jax_log), ("port", port_log)):
        rl = mod.ResultsLog(str(tmp_path / name), title="t")
        for e in range(4):
            rl.add(epoch=e, train_loss=2.0 / (e + 1), val_loss=2.5 / (e + 1))
        rl.plot("epoch", ["train_loss", "val_loss"], "loss", "loss")
        rl.plot("epoch", ["train_loss", "val_loss"], "loss", "loss")
        rl.save()
        assert len(rl._plots) == 1
        out[name] = [open(p).read() for p in (rl.csv_path, rl.json_path,
                                              rl.html_path)]
        assert len(mod.ResultsLog(str(tmp_path / name)).load().rows) == 4
    assert out["port"] == out["jax"]
    assert "train_loss @ epoch=3" in out["port"][2]


def test_setup_logging_and_args(tmp_path):
    import argparse
    root = logging.getLogger()
    saved = list(root.handlers), root.level
    try:
        port_log.setup_logging(str(tmp_path / "log.txt"))
        logging.getLogger("x").info("hello")
        for h in root.handlers:
            h.flush()
        assert "hello" in open(tmp_path / "log.txt").read()
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            if h not in saved[0]:
                h.close()
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
    port_log.export_args_namespace(argparse.Namespace(lr=0.1, b=64),
                                   str(tmp_path / "a" / "args.json"))
    assert json.load(open(tmp_path / "a" / "args.json")) == {"lr": 0.1,
                                                             "b": 64}


def test_set_global_seeds():
    g = set_global_seeds(5)
    a = (np.random.rand(), torch.rand(1), torch.rand(1, generator=g))
    g = set_global_seeds(5)
    b = (np.random.rand(), torch.rand(1), torch.rand(1, generator=g))
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])
    assert g.device.type == "cpu"
