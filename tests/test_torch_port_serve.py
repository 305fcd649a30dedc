"""The port's serving slice against the JAX package, on the CPU.

The JAX ``Predictor(impl="pallas")`` with ``CONVNET_TPU_PALLAS_FUSED=1``
sends every 1x1 stride-1 ConvBN through the Pallas kernel (interpret mode
here); the port's ``Predictor(device="cpu")`` takes the same route through
its kernel wrapper, which runs the plain version on CPU tensors. Weights and
randomised BatchNorm statistics are made once with numpy, saved as a JAX
checkpoint and carried into the port by ``from_jax_params``.
"""

import importlib

import numpy as np
import pytest
import torch
import jax

from convnet_tpu import models as jax_models
from convnet_tpu.core.module import param_count as jax_param_count
from convnet_tpu.data import preprocess as jax_preprocess
from convnet_tpu.models.resnet import Bottleneck as JaxBottleneck
from convnet_tpu.serve import Predictor as JaxPredictor
from convnet_tpu.utils.absorb_bn import search_absorb_bn as jax_absorb
from convnet_tpu.utils.checkpoint import save_checkpoint
from convnet_tpu_torch import models
from convnet_tpu_torch.core import initializers as init
from convnet_tpu_torch.core.dtypes import get_policy
from convnet_tpu_torch.core.module import param_count
from convnet_tpu_torch.data import preprocess
from convnet_tpu_torch.models.resnet import Bottleneck, ConvBN
from convnet_tpu_torch.ops.kernels import matmul_fused
from convnet_tpu_torch.serve import Predictor
from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn
from convnet_tpu_torch.utils.from_jax import from_jax_params

RESNET = importlib.import_module("convnet_tpu_torch.models.resnet")
NARROW = {"depth": 50, "width": [8, 16, 32, 64], "layers": [1, 1, 1, 1]}
SIZE, BATCH, REQUESTS = 32, 4, 3   # 3 requests padded to a batch of 4


def _randomised_weights(seed=0):
    """The JAX narrow net's init, with every BN's γ, β, mean and var redrawn
    with numpy so that folding is not the identity."""
    model = jax_models.build("resnet", block=JaxBottleneck, **NARROW)
    params, state = model.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    draw = {
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.2, s),
        "mean": lambda s: rng.normal(0.0, 0.2, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
    }

    def redraw(tree):
        return {k: redraw(v) if isinstance(v, dict) else
                (draw[k](v.shape) if k in draw else np.asarray(v)
                 ).astype(np.float32)
                for k, v in tree.items()}

    return redraw(params), redraw(state)


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    params, state = _randomised_weights()
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    save_checkpoint({"params": params, "state": state, "epoch": 0}, False,
                    str(ckpt))
    images = np.random.default_rng(1).integers(
        0, 256, (REQUESTS, SIZE, SIZE, 3), np.uint8)
    jax_logits = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CONVNET_TPU_PALLAS_FUSED", "1")
        for dtype in ("float32", "bf16"):
            jp = JaxPredictor("resnet", dict(NARROW,
                                             block=JaxBottleneck),
                              checkpoint=str(ckpt), dtype=dtype,
                              batch_size=BATCH, impl="pallas",
                              input_size=SIZE)
            jax_logits[dtype] = jp.predict_logits(images)
    return params, state, images, jax_logits


def _port(params, state, dtype):
    return Predictor("resnet", dict(NARROW, block=Bottleneck),
                     params=params, state=state, dtype=dtype,
                     batch_size=BATCH, input_size=SIZE, device="cpu")


def test_slice_float32_matches_jax(slice_case):
    """float32: tolerance 1e-4 relative to the logits' scale (the convs sum
    in another order in XLA and in PyTorch)."""
    params, state, images, ref = slice_case
    out = _port(params, state, "float32").predict_logits(images)
    assert out.shape == (REQUESTS, 1000) and out.dtype == np.float32
    scale = np.abs(ref["float32"]).max()
    np.testing.assert_allclose(out, ref["float32"], rtol=1e-4,
                               atol=1e-4 * scale)


def test_slice_bf16_matches_jax(slice_case):
    """bf16: the two frameworks round to bf16 at other places, so the
    tolerance is 5e-2 of the logits' scale, plus the same top-1 class.
    Parameters and BN statistics stay float32 under the bf16 policy."""
    params, state, images, ref = slice_case
    port = _port(params, state, "bf16")
    kept = dict(port.model.named_parameters(), **dict(
        port.model.named_buffers()))
    assert {t.dtype for t in kept.values()} == {torch.float32}
    out = port.predict_logits(images)
    scale = np.abs(ref["bf16"]).max()
    np.testing.assert_allclose(out, ref["bf16"], rtol=5e-2,
                               atol=5e-2 * scale)
    np.testing.assert_array_equal(out.argmax(-1), ref["bf16"].argmax(-1))


def test_padding_rows_do_not_change_answers(slice_case):
    params, state, images, _ = slice_case
    p = _port(params, state, "float32")
    one_by_one = np.concatenate([p.predict_logits(images[i:i + 1])
                                 for i in range(REQUESTS)])
    np.testing.assert_allclose(one_by_one, p.predict_logits(images),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(p.predict(images),
                                  p.predict_logits(images).argmax(-1))


def test_absorb_bn_matches_jax(slice_case):
    """The port's fold of its modules equals the JAX fold of the pytrees."""
    params, state, _, _ = slice_case
    model = models.build("resnet", block=Bottleneck, **NARROW)
    model.load_state_dict(from_jax_params(params, state))
    search_absorb_bn(model.eval())
    folded = from_jax_params(*jax_absorb(params, state))
    got = model.state_dict()
    assert set(got) == set(folded)
    for name, want in folded.items():
        torch.testing.assert_close(got[name], want, rtol=1e-6, atol=1e-6,
                                   msg=name)


def test_from_jax_params_names_and_layouts(slice_case):
    params, state, _, _ = slice_case
    sd = from_jax_params(params, state)
    model = models.build("resnet", block=Bottleneck, **NARROW)
    assert set(sd) == set(model.state_dict())
    w_hwio = params["stem"]["conv1"]["conv"]["w"]
    np.testing.assert_array_equal(sd["stem.conv1.conv.weight"].numpy(),
                                  w_hwio.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  params["fc"]["w"].T)
    np.testing.assert_array_equal(
        sd["layers.layer1.0.cb1.bn.running_var"].numpy(),
        state["layers"]["layer1"]["0"]["cb1"]["bn"]["var"])


def test_depth50_structure_matches_jax():
    """Depth 50: the JAX package's parameter count, and exactly 33 ConvBNs
    on the kernel route (cb1 and cb3 of 16 blocks, layer1's downsample)."""
    jax_model = jax_models.build("resnet", depth=50)
    shapes = jax.eval_shape(lambda k: jax_model.init(k)[0],
                            jax.random.PRNGKey(0))
    model = models.build("resnet", depth=50).eval()
    assert param_count(model) == jax_param_count(shapes) == 25_557_032
    routed = [m for m in model.modules()
              if isinstance(m, ConvBN) and m.uses_kernel()]
    assert len(routed) == 33
    assert not any(m.uses_kernel() for m in model.train().modules()
                   if isinstance(m, ConvBN))


def test_depth50_forward_calls_the_kernel_33_times(monkeypatch):
    calls = []
    real = RESNET.conv1x1_bn_act

    def spy(x, w, scale, shift, act):
        calls.append((tuple(x.shape), tuple(w.shape), act))
        return real(x, w, scale, shift, act)

    monkeypatch.setattr(RESNET, "conv1x1_bn_act", spy)
    p = Predictor("resnet", {"depth": 50, "width": [4, 8, 8, 8]},
                  dtype="float32", batch_size=1, device="cpu")
    logits = p.predict_logits(np.zeros((1, 32, 32, 3), np.uint8))
    assert np.isfinite(logits).all() and len(calls) == 33


def test_predictor_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor("resnet", {"depth": 18, "width": [4, 4, 4, 4]})


def test_seeded_init_is_reproducible():
    kw = dict(model_config={"depth": 18, "width": [4, 4, 4, 4]},
              dtype="float32", device="cpu", batch_size=2, seed=3)
    a, b = Predictor("resnet", **kw), Predictor("resnet", **kw)
    c = Predictor("resnet", **dict(kw, seed=4))
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(a.predict_logits(x), b.predict_logits(x))
    assert not np.array_equal(a.predict_logits(x), c.predict_logits(x))


def test_dataset_stats_copy_matches_jax():
    assert preprocess.DATASET_STATS == jax_preprocess.DATASET_STATS
    for name in ("imagenet", "cifar10", "stl10", "mnist", "svhn"):
        assert (preprocess.default_image_size(name)
                == jax_preprocess.default_image_size(name))


def test_initializer_scales():
    g = torch.Generator().manual_seed(0)
    w = init.kaiming_normal((256, 64, 3, 3), g)
    np.testing.assert_allclose(w.std().item(), np.sqrt(2.0 / (256 * 9)),
                               rtol=0.02)
    u = init.torch_linear_default((10, 400), g)
    assert u.abs().max().item() <= 1 / 20 and u.abs().max().item() > 0.049
    assert get_policy("bf16").compute_dtype == torch.bfloat16
    assert get_policy("float32").compute_dtype == torch.float32
