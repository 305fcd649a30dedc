"""The zoo's weights in and out of the port, on the CPU: ``torch_import`` of
AlexNet-BN (its (C, H, W) flatten permuted into the first linear layer) and
of the MNIST net (biased convs) against torch twins and the JAX importer;
the npz checkpoint of a zoo model across the packages (the port saves, JAX
loads and gives the port's logits; JAX saves, the port resumes); weights
round-tripped by name through ``from_jax_params`` for every new model;
``Predictor`` taking each model's input size (299 for the Inception family)
and MNIST's one-channel normalisation; and the CLI training GoogLeNet with
its aux heads and the MNIST net on synthetic data, two steps each.

Tolerances: logits against the torch twins 2e-4 of the largest (AlexNet:
``tests/test_torch_import.py``'s tolerance for it), 1e-5 for the MNIST net;
the imported weights equal the JAX importer's exactly; port against JAX
logits 1e-4 of the largest (float32, summation order); the resumed step's
loss 1e-4 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

import test_torch_port_cli as CLI
import test_torch_port_zoo_small as Z
from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.core.module import param_count as jax_param_count
from convnet_tpu.utils import checkpoint as jax_ckpt
from convnet_tpu.utils.torch_import import (
    import_torch_state_dict as jax_import)
from convnet_tpu_torch import models
from convnet_tpu_torch.cli.main import main as cli_main
from convnet_tpu_torch.core.module import param_count
from convnet_tpu_torch.data import data_regime
from convnet_tpu_torch.serve import Predictor
from convnet_tpu_torch.utils import checkpoint as ckpt_io
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params
from convnet_tpu_torch.utils.torch_import import (
    export_into_torch_state_dict, import_torch_state_dict)


class TorchAlexNetBN(tnn.Module):
    """``tests/test_torch_import.py``'s AlexNet-OWT-BN twin: biased convs
    (folded into the BNs' means on import) and torch's (C, H, W) flatten."""

    def __init__(self, classes=13):
        super().__init__()

        def cbr(cin, cout, k, s, p):
            return [tnn.Conv2d(cin, cout, k, s, p), tnn.BatchNorm2d(cout),
                    tnn.ReLU()]

        self.features = tnn.Sequential(
            *cbr(3, 64, 11, 4, 2), tnn.MaxPool2d(3, 2),
            *cbr(64, 192, 5, 1, 2), tnn.MaxPool2d(3, 2),
            *cbr(192, 384, 3, 1, 1), *cbr(384, 256, 3, 1, 1),
            *cbr(256, 256, 3, 1, 1), tnn.MaxPool2d(3, 2))
        self.classifier = tnn.Sequential(
            tnn.Dropout(0.5), tnn.Linear(256 * 6 * 6, 4096), tnn.ReLU(),
            tnn.Dropout(0.5), tnn.Linear(4096, 4096), tnn.ReLU(),
            tnn.Linear(4096, classes))

    def forward(self, x):
        return self.classifier(self.features(x).flatten(1))


class TorchMnist(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = tnn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = tnn.Linear(7 * 7 * 64, 1024)
        self.fc2 = tnn.Linear(1024, 10)

    def forward(self, x):
        x = tnn.functional.max_pool2d(torch.relu(self.conv1(x)), 2)
        x = tnn.functional.max_pool2d(torch.relu(self.conv2(x)), 2)
        return self.fc2(torch.relu(self.fc1(x.flatten(1))))


# the CLI replaces the root logger's handlers: restore them after the module
_root_logger = CLI._root_logger

TWINS = {"alexnet": (TorchAlexNetBN, ("alexnet", {"num_classes": 13}), 224,
                     3, 2e-4),
         "mnist": (TorchMnist, ("mnist", {}), 28, 1, 1e-5)}


def _twin(tag, seed=0):
    cls = TWINS[tag][0]
    torch.manual_seed(seed)
    tm = cls()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.tensor(
                    rng.normal(0, 0.1, m.num_features), dtype=torch.float32))
                m.running_var.copy_(torch.tensor(
                    1.0 + 0.2 * rng.random(m.num_features),
                    dtype=torch.float32))
    return tm.eval()


def _nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("tag", sorted(TWINS))
def test_torch_import_matches_the_twin_and_the_jax_importer(tag):
    _, (name, config), size, channels, tol = TWINS[tag]
    tm = _twin(tag)
    model = models.build(name, **config)
    sd = import_torch_state_dict(tm.state_dict(), model)
    model.load_state_dict(sd)
    x = np.random.default_rng(1).standard_normal(
        (2, channels, size, size)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
        out = model.eval()(_nhwc(x)).numpy()
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()
    params, state = to_jax_params(model.state_dict())
    jp, js = jax_import(tm.state_dict(), jax_models.build(name, **config),
                        params, state)
    ours_p, ours_s = to_jax_params(sd)
    for ours, want in ((ours_p, jp), (ours_s, js)):
        want, got = dict(Z.leaves(want)), dict(Z.leaves(ours))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_mnist_export_keeps_the_conv_biases():
    tm = _twin("mnist", seed=2)
    model = models.build("mnist")
    model.load_state_dict(import_torch_state_dict(tm.state_dict(), model))
    out = export_into_torch_state_dict(TorchMnist().state_dict(), model)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(out[k], v.numpy(), rtol=0, atol=0,
                                   err_msg=k)


# every new model's weights by name: port → JAX trees (the JAX model's own
# structure and shapes) → port, unchanged
ROUND_TRIP = [("mnist", {}), ("alexnet", {"num_classes": 10}),
              ("vgg", {"dataset": "cifar10", "depth": 11}),
              ("densenet", Z.DENSENET),
              ("googlenet", {"aux_classifiers": True, "num_classes": 10}),
              ("inception_v3", {"aux_classifiers": True, "num_classes": 10}),
              ("inception_v4", {"num_classes": 10}),
              ("inception_resnet_v2", {"num_classes": 10})]


@pytest.mark.parametrize("name,config", ROUND_TRIP)
def test_weights_carry_across_by_name(name, config):
    model = models.build(name, **config)
    params, state = to_jax_params(model.state_dict())
    shapes = jax.eval_shape(
        lambda: jax_models.build(name, **config).init(jax.random.PRNGKey(0)))
    for ours, ref in zip((params, state), shapes):
        ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
        assert ref.keys() == ours.keys()        # the MNIST net has no state
        for k in ref:
            assert tuple(ours[k].shape) == tuple(ref[k].shape), k
    assert param_count(model) == jax_param_count(params)
    back = from_jax_params(params, state)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_npz_checkpoint_across_the_packages(tmp_path):
    """The port's MNIST trainer saves after a step; the JAX package loads
    the archive and its model gives the port's logits. The JAX trainer's
    checkpoint of the same model resumes in the port, whose next step
    matches the JAX trainer's."""
    model = Z.port_model("mnist", {})
    x, y = Z.images((8, 28, 28, 1), 3), np.arange(8) % 10
    _, tr = Z.port_step(model, x, y, 10)
    ckpt_io.save_checkpoint(tr.checkpoint_dict(model="mnist", config={}),
                            False, str(tmp_path / "port"))
    ck = jax_ckpt.load_checkpoint(str(tmp_path / "port"))
    assert ck["model"] == "mnist" and ck["training_steps"] == 1
    assert set(ck["params"]["features"]["conv1"]) == {"w", "b"}
    x2 = Z.images((2, 28, 28, 1), 4)
    ref = jax_models.build("mnist")(ck["params"], ck.get("state", {}),
                                    jnp.asarray(x2), Context(train=False))[0]
    with torch.no_grad():
        out = tr.model.eval()(torch.from_numpy(x2)).numpy()
    assert Z.rel(out, ref) <= Z.LOGIT_TOL

    params, state = to_jax_params(Z.port_model("mnist", {}, 5).state_dict())
    j_loss0, jp, js = Z.jax_step("mnist", {}, params, state, x, y, 10)
    jax_ckpt.save_checkpoint(
        {"epoch": 0, "model": "mnist", "config": {}, "params": jp,
         "state": js, "opt_state": {"step": np.int32(1),
                                    "mu": jax.tree_util.tree_map(
                                        np.zeros_like, jp)},
         "training_steps": 1}, False, str(tmp_path / "jax"))
    j_loss, jp2, js2 = Z.jax_step("mnist", {}, jp, js, x2.repeat(4, 0),
                                  np.arange(8) % 10, 10)
    tr2 = Z.Trainer(models.build("mnist"),
                    Z.optim.OptimRegime(models.build("mnist").regime), 10,
                    Z.TrainerConfig(dtype="float32", print_freq=0),
                    device="cpu")
    Z.zero_dropout(port_module=tr2.model)
    tr2.load_checkpoint(ckpt_io.load_checkpoint(str(tmp_path / "jax")))
    assert tr2.training_steps == 1
    loss = float(tr2.train_step(x2.repeat(4, 0), np.arange(8) % 10)["loss"])
    np.testing.assert_allclose(loss, j_loss, rtol=Z.LOSS_TOL)


@pytest.mark.parametrize("name,size", [("inception_v3", 299),
                                       ("googlenet", 224), ("mnist", 28)])
def test_predictor_takes_the_models_input_size(name, size):
    pred = Predictor(name, {"num_classes": 10}, dtype="float32",
                     batch_size=1, device="cpu")
    assert pred.input_size == size


def test_predictor_serves_mnist_with_its_normalisation():
    pred = Predictor("mnist", dtype="float32", batch_size=4, device="cpu")
    images = np.random.default_rng(6).integers(0, 256, (3, 28, 28, 1),
                                               np.uint8)
    x = (images.astype(np.float32) / 255.0 - 0.1307) / 0.3081
    with torch.no_grad():
        ref = pred.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pred(images), ref, rtol=1e-5, atol=1e-6)


@pytest.fixture
def small_synthetic(monkeypatch):
    """Synthetic datasets of 32 images, in a dataset cache of this test's
    own, so a run is two steps at batch 16."""
    real = data_regime.get_dataset

    def small(name, split, data_dir=None, **kwargs):
        if name.startswith("synthetic"):
            kwargs.setdefault("size", 32)
        return real(name, split, data_dir, **kwargs)

    monkeypatch.setattr(data_regime, "get_dataset", small)
    monkeypatch.setattr(data_regime.DataRegime, "_dataset_cache", {})


@pytest.mark.parametrize("model,config,dataset,extra", [
    ("googlenet", "{'aux_classifiers': True}", "synthetic_imagenet",
     ["--input-size", "64"]),
    ("mnist", "{}", "synthetic", [])])
def test_cli_trains_a_zoo_model(tmp_path, small_synthetic, model, config,
                                dataset, extra):
    res = cli_main(["--device", "cpu", "--model", model, "--model-config",
                    config, "--dataset", dataset, "-b", "16", "-j", "2",
                    "--epochs", "1", "--print-freq", "0", "--results-dir",
                    str(tmp_path), "--save", "run", *extra])
    ckpt_io.wait_for_pending_save()
    rows = json.loads((tmp_path / "run" / "results.json").read_text())
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    assert np.isfinite(res["best_prec1"])
    ck = ckpt_io.load_checkpoint(str(tmp_path / "run"))
    assert ck["model"] == model and ck["training_steps"] == 2
    if model == "googlenet":
        assert {"aux1", "aux2"} <= set(ck["params"])
    else:
        assert ck["params"]["features"]["conv1"]["w"].shape == (5, 5, 1, 32)
