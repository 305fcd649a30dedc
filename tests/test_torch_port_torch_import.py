"""Importing convNet.pytorch checkpoints into the port
(``utils/torch_import.py``), on the CPU.

Torch twins with the reference's registration order and names (as
``tests/test_torch_import.py`` builds them: ResNet-18, whose residual
downsample is registered after the block's convs but runs first, and the
CIFAR ResNet-20) export their ``state_dict``; the port's model imports it
and must give their eval logits within 1e-5 of the largest. The imported
weights equal what the JAX package's importer makes of the same
``state_dict``. Mismatched shapes and unit counts raise; DataParallel's
``module.`` prefix is dropped; the export round-trips; ``Predictor`` serves
a ``.pth.tar`` straight away.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from convnet_tpu import models as jax_models
from convnet_tpu.utils.torch_import import (
    import_torch_state_dict as jax_import)
from convnet_tpu_torch import models
from convnet_tpu_torch.serve import Predictor
from convnet_tpu_torch.utils.from_jax import to_jax_params
from convnet_tpu_torch.utils.torch_import import (
    export_into_torch_state_dict, import_torch_state_dict,
    load_torch_checkpoint)

REL_TOL = 1e-5


def _basic_block(cin, cout, stride):
    class Block(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(cout)
            self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = tnn.Sequential(
                    tnn.Conv2d(cin, cout, 1, stride, bias=False),
                    tnn.BatchNorm2d(cout))

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            out = torch.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return torch.relu(out + idt)
    return Block()


class TorchResNet18(tnn.Module):
    def __init__(self, classes=21):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        widths = [64, 64, 128, 256, 512]
        for i in range(1, 5):
            setattr(self, f"layer{i}", tnn.Sequential(
                _basic_block(widths[i - 1], widths[i], 1 if i == 1 else 2),
                _basic_block(widths[i], widths[i], 1)))
        self.fc = tnn.Linear(512, classes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3)))


class TorchCifarResNet20(tnn.Module):
    def __init__(self, classes=10):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(16)
        widths = [16, 16, 32, 64]
        for i in range(1, 4):
            blocks = [_basic_block(widths[i - 1], widths[i],
                                   1 if i == 1 else 2)]
            blocks += [_basic_block(widths[i], widths[i], 1)
                       for _ in range(2)]
            setattr(self, f"layer{i}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(64, classes)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(x.mean(dim=(2, 3)))


TWINS = {
    "resnet18": (TorchResNet18, ("resnet", {"depth": 18, "num_classes": 21}),
                 64),
    "resnet20_cifar": (TorchCifarResNet20,
                       ("resnet", {"dataset": "cifar10", "depth": 20}), 32),
}


def _twin(tag, seed=0):
    cls, _, _ = TWINS[tag]
    torch.manual_seed(seed)
    tm = cls()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.weight.copy_(torch.tensor(
                    rng.uniform(0.5, 1.5, m.num_features), dtype=torch.float32))
                m.bias.copy_(torch.tensor(
                    rng.normal(0, 0.1, m.num_features), dtype=torch.float32))
                m.running_mean.copy_(torch.tensor(
                    rng.normal(0, 0.1, m.num_features), dtype=torch.float32))
                m.running_var.copy_(torch.tensor(
                    1.0 + 0.2 * rng.random(m.num_features),
                    dtype=torch.float32))
    return tm.eval()


def _images(size, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, 3, size, size)).astype(np.float32)


def _logits(model, x_nchw):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(
            np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1)))).numpy()


def _close(ours, ref):
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("tag", sorted(TWINS))
def test_import_logits_match_torch_and_weights_match_jax(tag):
    _, (name, config), size = TWINS[tag]
    tm = _twin(tag)
    model = models.build(name, **config)
    sd = import_torch_state_dict(tm.state_dict(), model)
    model.load_state_dict(sd)
    x = _images(size)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    _close(_logits(model, x), ref)
    # the JAX package's importer makes the same weights
    jmodel = jax_models.build(name, **config)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    jp, js = jax_import(tm.state_dict(), jmodel, params, state)
    ours_p, ours_s = to_jax_params(sd)
    for tree, want in ((ours_p, jp), (ours_s, js)):
        flat = jax.tree_util.tree_leaves_with_path(want)
        for path, leaf in flat:
            node = tree
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))


def test_import_rejects_shape_mismatch():
    tm = TorchResNet18(classes=7)
    model = models.build("resnet", depth=18, num_classes=21)
    with pytest.raises(ValueError, match="no torch unit matches linear"):
        import_torch_state_dict(tm.state_dict(), model)


def test_import_rejects_unit_count_mismatch():
    model = models.build("resnet", depth=34, num_classes=21)
    with pytest.raises(ValueError, match="unit count mismatch"):
        import_torch_state_dict(TorchResNet18().state_dict(), model)
    sd = TorchCifarResNet20().state_dict()
    sd["extra.weight"] = torch.ones(3, 3)
    with pytest.raises(ValueError, match="unit count mismatch"):
        import_torch_state_dict(sd, models.build("resnet", dataset="cifar10",
                                                 depth=20))


def test_conv_bias_folds_into_the_next_bn():
    """A torch conv bias (the port's convs have none) folds into the BN's
    running mean; a bias with no BN after it raises."""
    tm = _twin("resnet20_cifar")
    tm.conv1 = tnn.Conv2d(3, 16, 3, 1, 1, bias=True)
    with torch.no_grad():
        tm.conv1.bias.normal_()
    tm.eval()
    model = models.build("resnet", dataset="cifar10", depth=20)
    model.load_state_dict(import_torch_state_dict(tm.state_dict(), model))
    x = _images(32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    _close(_logits(model, x), ref)
    sd = dict(tm.state_dict())
    for k in [k for k in sd if k.startswith("bn1.")]:
        del sd[k]
    with pytest.raises(ValueError):
        import_torch_state_dict(sd, model)


def test_load_checkpoint_with_module_prefix(tmp_path):
    tm = _twin("resnet20_cifar", seed=3)
    path = tmp_path / "checkpoint.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in tm.state_dict().items()},
                "epoch": 7, "best_prec1": 91.5}, path)
    model = models.build("resnet", dataset="cifar10", depth=20)
    _, meta = load_torch_checkpoint(str(path), model)
    assert meta == {"epoch": 7, "best_prec1": 91.5}
    x = _images(32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    _close(_logits(model, x), ref)
    # a bare state_dict file too
    torch.save(tm.state_dict(), tmp_path / "bare.pth")
    model = models.build("resnet", dataset="cifar10", depth=20)
    _, meta = load_torch_checkpoint(str(tmp_path / "bare.pth"), model)
    assert meta == {}
    _close(_logits(model, x), ref)


def test_export_round_trip():
    """The port's weights exported into a torch template give the port's
    logits in torch, and import back to the same weights."""
    model = models.build("resnet", depth=18, num_classes=21)
    model.load_state_dict(import_torch_state_dict(_twin("resnet18", 4)
                                                  .state_dict(), model))
    template = TorchResNet18().state_dict()
    out = export_into_torch_state_dict(template, model)
    assert set(out) == set(template)
    tm = TorchResNet18()
    tm.load_state_dict({k: torch.tensor(v) for k, v in out.items()})
    tm.eval()
    x = _images(64, seed=5)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    _close(_logits(model, x), ref)
    back = import_torch_state_dict(tm.state_dict(), model)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_predictor_serves_a_torch_checkpoint(tmp_path):
    tm = _twin("resnet20_cifar", seed=6)
    path = tmp_path / "model_best.pth.tar"
    torch.save({"state_dict": tm.state_dict(), "epoch": 1}, path)
    pred = Predictor("resnet", {"dataset": "cifar10", "depth": 20},
                     checkpoint=str(path), dtype="float32", batch_size=4,
                     device="cpu")
    images = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3),
                                               np.uint8)
    stats = {"mean": [0.491, 0.482, 0.447], "std": [0.247, 0.243, 0.262]}
    x = (images.astype(np.float32) / 255.0 - stats["mean"]) / stats["std"]
    with torch.no_grad():
        ref = tm(torch.from_numpy(
            x.transpose(0, 3, 1, 2).astype(np.float32))).numpy()
    err = np.abs(pred(images) - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err   # the BN folded into the convs
    with pytest.raises(ValueError, match="model_name"):
        Predictor(checkpoint=str(path), device="cpu")
