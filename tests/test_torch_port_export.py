"""``Predictor.export`` / ``load_exported`` (``torch.export`` artifacts) and
multi-device serving (``devices=``) of the port, on the CPU.

The exported graph holds each kernel as a registered ``convnet_tpu_torch::``
op, whose CPU implementation is the plain version the eager forward runs, so
the artifact's logits equal the eager Predictor's exactly. Replicas on
several devices run the same forward on shards of the batch, so their
logits equal one device's exactly too.
"""

import numpy as np
import pytest
import torch

import test_torch_port_models as M
from convnet_tpu_torch.models.resnet import Bottleneck
from convnet_tpu_torch.serve import (ExportedPredictor, Predictor,
                                     load_exported)

NARROW = {"depth": 50, "width": [8, 16, 32, 64], "layers": [1, 1, 1, 1],
          "block": Bottleneck}
# model → (name, config, input size, ops its exported graph must hold)
CASES = {
    "resnet": ("resnet", NARROW, 32, {"matmul_scale_act", "max_pool2d_fwd"}),
    "resnext": ("resnext", dict(M.RESNEXT, num_classes=10), 32,
                {"matmul_scale_act", "max_pool2d_fwd", "grouped_conv2d"}),
    "mobilenet_v2": ("mobilenet_v2", {"width": 0.25, "num_classes": 10,
                                      "dropout": 0.0}, 64,
                     {"matmul_scale_act", "depthwise_conv2d",
                      "mbconv_full"}),
    "resnet_int8": ("resnet", NARROW, 32,
                    {"matmul_int8", "matmul_scale_act", "max_pool2d_fwd"}),
}
BATCH = 4


def _predictor(case, **kw):
    name, config, size, _ = CASES[case]
    kw.setdefault("device", None if "devices" in kw else "cpu")
    kw.setdefault("batch_size", BATCH)
    return Predictor(name, config, dtype="float32", input_size=size,
                     quantize="int8" if case.endswith("int8") else None, **kw)


def _images(size, n=6, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


def _graph_ops(exported):
    return {str(node.target).split(".")[1]
            for node in exported._program.graph.nodes
            if str(node.target).startswith("convnet_tpu_torch.")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_round_trip(case, tmp_path):
    """To a path and to bytes; the artifact pads and chunks 6 images to its
    batch of 4 and answers as the eager Predictor does, bit for bit."""
    p = _predictor(case)
    x = _images(p.input_size)
    ref = p.predict_logits(x)
    art = tmp_path / "model.pt2"
    data = p.export(str(art))
    assert art.exists() and art.stat().st_size == len(data)
    for src in (str(art), data):
        ep = load_exported(src)
        assert isinstance(ep, ExportedPredictor)
        assert ep.batch_size == BATCH and ep.input_size == p.input_size
        assert _graph_ops(ep) == CASES[case][3]
        np.testing.assert_array_equal(ep.predict_logits(x), ref)
    assert ep.predict(x).shape == (6,)
    np.testing.assert_array_equal(ep.predict(x, topk=3)[:, 0],
                                  ref.argmax(-1))


@pytest.mark.parametrize("case", ["resnet", "resnet_int8"])
def test_two_cpu_replicas_equal_one_device(case):
    """Each replica runs a shard of half the batch; one device serving
    batches of that size gives the same logits bit for bit (the CPU's convs
    pick their algorithm by batch, so a batch of 4 may round otherwise)."""
    one = _predictor(case, batch_size=BATCH // 2)
    two = _predictor(case, devices=["cpu", "cpu"])
    assert len(two._replicas) == 2
    assert two._replicas[1].model is not two._replicas[0].model
    if case.endswith("int8"):
        assert two.act_scales == one.act_scales
        second = two._replicas[1]
        assert second.state is not two._replicas[0].state
        assert all(m.quant is second.state for m in second.model.modules()
                   if hasattr(m, "quant"))
    x = _images(32, n=7)
    np.testing.assert_array_equal(two.predict_logits(x),
                                  one.predict_logits(x))


def test_devices_refusals():
    with pytest.raises(ValueError, match="divisible"):
        _predictor("resnet", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="single-device"):
        _predictor("resnet", devices=["cpu", "cpu"]).export()
    with pytest.raises(ValueError, match="empty"):
        _predictor("resnet", devices=[])
    name, config, size, _ = CASES["resnet"]
    with pytest.raises(ValueError, match="not both"):
        Predictor(name, config, batch_size=BATCH, device="cpu",
                  devices=["cpu"])


def test_devices_all_without_a_card_raises(monkeypatch):
    """``"all"`` and a device count name CUDA devices only: without a card
    they raise rather than serve on the CPU."""
    name, config, size, _ = CASES["resnet"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(name, config, batch_size=BATCH, devices="all")
    with pytest.raises(ValueError, match="CUDA devices"):
        Predictor(name, config, batch_size=BATCH, devices=1)
