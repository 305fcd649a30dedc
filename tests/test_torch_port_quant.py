"""The port's int8 post-training quantization (``nn/quant.py``,
``ops/kernels/matmul_int8.py``, ``Predictor(quantize="int8")``) against the
JAX package's ``nn/quant.py`` and int8 ``Predictor``, on the CPU, where the
int8 kernel's wrapper runs its plain version.

Tolerances (``scripts/port_numerics.py int8``): the quantized values, the
weight scales and the plain int8 conv are the same arithmetic, so they are
held bit for bit. The calibrated scales are amaxes of float forwards that
sum in another order: float32 within 1e-5 (measured 5.5e-7). The int8
logits against the JAX int8 Predictor's, as a share of the largest: float32
1e-4 (measured 4.7e-7); bf16 5e-2 with the same top-1 (measured 3.5e-2: the
bf16 activations of the two packages round apart, and 13% of one layer's
int8 values then differ by up to 5, as the float bf16 slice differs).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import test_torch_port_models as M
import test_torch_port_serve as S
from convnet_tpu import models as jax_models
from convnet_tpu.models.resnet import Bottleneck as JaxBottleneck
from convnet_tpu.nn import quant as jax_quant
from convnet_tpu.nn.layers import Conv2d as JaxConv2d
from convnet_tpu.serve import Predictor as JaxPredictor
from convnet_tpu.utils.checkpoint import save_checkpoint
from convnet_tpu_torch import models
from convnet_tpu_torch.models.resnet import Bottleneck
from convnet_tpu_torch.nn import Conv2d, quant
from convnet_tpu_torch.ops.kernels import matmul_fused, matmul_int8, mbconv
from convnet_tpu_torch.serve import Predictor
from convnet_tpu_torch.utils.from_jax import from_jax_params

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SCALE_TOL = 1e-5
LOGIT_TOL = {"float32": 1e-4, "bf16": 5e-2}
NARROW_SIZE, NARROW_BATCH = 32, 4
NARROW_SCALES = 6   # layer 3's cb3 and layer 4's 1x1s see maps under 4x4
MOBILENET_SCALES = 11   # at 64x64 the last two pointwise convs see 2x2

# (in, out, kernel, stride, padding, groups, x NHWC): JAX's eligibility
CONVS = {
    "pointwise": (64, 128, 1, 1, 0, 1, (4, 14, 14, 64)),
    "pointwise_4x4": (64, 128, 1, 1, 0, 1, (4, 4, 4, 64)),
    "pointwise_3x5": (64, 128, 1, 1, 0, 1, (4, 3, 5, 64)),
    "se_pooled": (64, 16, 1, 1, 0, 1, (4, 1, 1, 64)),
    "stride2": (64, 128, 1, 2, 0, 1, (4, 14, 14, 64)),
    "3x3": (64, 128, 3, 1, 1, 1, (4, 14, 14, 64)),
    "depthwise": (64, 64, 1, 1, 0, 64, (4, 14, 14, 64)),
    "padded_1x1": (64, 128, 1, 1, 1, 1, (4, 14, 14, 64)),
    "pair_padding": (64, 128, 1, 1, (0, 0), 1, (4, 14, 14, 64)),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_eligible_matches_jax(case):
    cin, cout, k, stride, pad, groups, x_shape = CONVS[case]
    want = jax_quant.conv_eligible(
        JaxConv2d(cin, cout, k, stride=stride, padding=pad, groups=groups),
        x_shape)
    got = quant.conv_eligible(
        Conv2d(cin, cout, k, stride, pad, groups=groups), x_shape)
    assert got == want
    assert want == (case in ("pointwise", "pointwise_4x4", "pair_padding"))


def _tied_weight(rng):
    """(Cout, Cin) float32: random rows, and a row whose amax is 127 (so its
    scale is 1) holding exact .5 ties of both parities and signs."""
    w = rng.standard_normal((16, 24)).astype(np.float32)
    w[3] = 0.0
    w[3, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return w


def test_quantize_weight_matches_jax_bit_for_bit():
    w = _tied_weight(np.random.default_rng(0))
    jq, jsw = jax_quant.quantize_weight_1x1(jnp.asarray(w.T)[None, None])
    wq, sw = quant.quantize_weight_1x1(torch.from_numpy(w)[:, :, None, None])
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    assert list(wq[3, :8]) == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_act_matches_jax_bit_for_bit(dtype):
    """Random activations at a calibrated-like scale, and exact .5 ties at
    a scale whose inverse (2) is exact in either type."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((8, 5, 5, 24)) * 3).astype(np.float32)
    ties = (np.arange(-8, 8) + 0.25).astype(np.float32)   # x * 2 = k + .5
    for values, scale in ((x, float(np.abs(x).max()) / 127.0 * 0.9),
                          (ties, 0.5)):
        xj = jnp.asarray(values).astype(jdt)
        xt = torch.from_numpy(values).to(tdt)
        jq, jeff = jax_quant.quantize_act(xj, scale)
        tq, teff = quant.quantize_act(xt, scale)
        assert tq.dtype == torch.int8 and teff == jeff
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist() == [-16, -14, -12, -10, -8, -6, -4, -2, 0, 2, 4, 6, 8,
                           10, 12, 14]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_conv1x1_int8_matches_jax(dtype):
    """The same quantization, exact int32 sums, the same float32 dequant:
    equal bit for bit."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 7, 40)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    ref = jax_quant.conv1x1_int8(jnp.asarray(x).astype(jdt),
                                 jnp.asarray(w.T)[None, None], scale)
    out = quant.conv1x1_int8(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w)[:, :, None, None], scale)
    assert out.dtype == tdt and out.shape == (2, 6, 7, 48)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_kernel_plain_version_is_conv_then_bn_then_act():
    """matmul_int8_plain: the reference's conv rounded to x's type, then the
    folded BN (or a bias) in float32, the activation, x's type."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((30, 20)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((12, 20)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 12).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.5, 12).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        conv = quant.conv1x1_int8(xd[:, None, None, :], w, 0.02)[:, 0, 0]
        want = torch.clamp(conv.float() * scale + shift, 0, 6).to(dt)
        got = matmul_int8.matmul_int8_plain(xd, w, 0.02, scale, shift,
                                            "relu6")
        assert torch.equal(got, want)
        got = matmul_int8.matmul_int8_plain(xd, w, 0.02, shift=shift)
        assert torch.equal(got, (conv.float() + shift).to(dt))


def _jax_narrow():
    return jax_models.build("resnet", block=JaxBottleneck, **S.NARROW)


def _port_narrow(params, state):
    model = models.build("resnet", block=Bottleneck, **S.NARROW)
    model.load_state_dict(from_jax_params(params, state))
    return model.eval()


@pytest.mark.parametrize("name", ["resnet", "mobilenet"])
def test_calibrate_matches_jax(name):
    """The same scales, in the same order, from the float models on the same
    normalised inputs."""
    if name == "resnet":
        params, state = S._randomised_weights()
        jax_model, size = _jax_narrow(), NARROW_SIZE
        model = _port_narrow(params, state)
    else:
        params, state = M._jax_init("mobilenet", M.MOBILENET, seed=0,
                                    redraw_stats=True)
        jax_model, size = jax_models.build("mobilenet", **M.MOBILENET), 64
        model = M._port("mobilenet", M.MOBILENET, params, state).eval()
    rng = np.random.default_rng(4)
    batches = [rng.standard_normal((2, size, size, 3)).astype(np.float32)
               for _ in range(2)]
    want = jax_quant.calibrate(jax_model, params, state,
                               [jnp.asarray(b) for b in batches])
    got = quant.calibrate(model, [torch.from_numpy(b) for b in batches])
    assert len(got) == len(want) == (NARROW_SCALES if name == "resnet"
                                     else MOBILENET_SCALES)
    np.testing.assert_allclose(got, want, rtol=SCALE_TOL)
    assert all(c.quant is None for c in model.modules()
               if isinstance(c, Conv2d))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    params, state = S._randomised_weights()
    path = tmp_path_factory.mktemp("int8_ckpt")
    save_checkpoint({"params": params, "state": state, "epoch": 0}, False,
                    str(path))
    images = np.random.default_rng(1).integers(
        0, 256, (6, NARROW_SIZE, NARROW_SIZE, 3), np.uint8)
    return str(path), images


def _int8_port(path, dtype, **kw):
    return Predictor("resnet", dict(S.NARROW, block=Bottleneck),
                     checkpoint=path, dtype=dtype, batch_size=NARROW_BATCH,
                     input_size=NARROW_SIZE, quantize="int8", device="cpu",
                     **kw)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_predictor_matches_jax(jax_checkpoint, dtype):
    path, images = jax_checkpoint
    jp = JaxPredictor("resnet", dict(S.NARROW, block=JaxBottleneck),
                      checkpoint=path, dtype=dtype, batch_size=NARROW_BATCH,
                      input_size=NARROW_SIZE, quantize="int8")
    port = _int8_port(path, dtype)
    assert isinstance(port.act_scales, tuple)
    assert len(port.act_scales) == len(jp.act_scales) == NARROW_SCALES
    if dtype == "float32":
        np.testing.assert_allclose(port.act_scales, jp.act_scales,
                                   rtol=SCALE_TOL)
    ref = jp.predict_logits(images)
    out = port.predict_logits(images)
    assert out.shape == ref.shape == (6, 1000)
    top = np.abs(ref).max()
    assert np.abs(out - ref).max() <= LOGIT_TOL[dtype] * top
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_int8_routes_and_call_counts(jax_checkpoint, monkeypatch):
    """A forward quantizes exactly ``len(act_scales)`` convs, each one call
    of the int8 kernel's wrapper; the 1x1 ConvBNs on maps under 4x4 keep
    the fused 1x1 route."""
    path, images = jax_checkpoint
    port = _int8_port(path, "float32")
    int8 = _counting(monkeypatch, matmul_int8, "matmul_int8_plain")
    fused = _counting(monkeypatch, matmul_fused, "matmul_scale_act_plain")
    port.predict_logits(images[:NARROW_BATCH])
    assert len(int8) == len(port.act_scales) == NARROW_SCALES
    assert len(fused) == 9 - NARROW_SCALES


def test_mobilenet_v2_under_int8_takes_no_mbconv_route(monkeypatch):
    """Under int8 the fused inverted residual steps aside: its expand and
    project convs take the int8 route, its depthwise conv its own kernel."""
    from convnet_tpu_torch.ops.kernels import depthwise_conv
    config = {"width": 0.25, "num_classes": 10, "dropout": 0.0}
    kw = dict(dtype="float32", batch_size=2, input_size=64, device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3),
                                               np.uint8)
    base = Predictor("mobilenet_v2", config, **kw)
    q = Predictor("mobilenet_v2", config, quantize="int8", **kw)
    full = _counting(monkeypatch, mbconv, "mbconv_full_plain")
    int8 = _counting(monkeypatch, matmul_int8, "matmul_int8_plain")
    dw = _counting(monkeypatch, depthwise_conv, "depthwise_conv2d_plain")
    lq = q.predict_logits(images)
    assert not full and len(int8) == len(q.act_scales) > 20
    assert len(dw) == 17
    del full[:], dw[:]
    lb = base.predict_logits(images)
    assert len(full) == 13 and len(dw) == 4
    assert np.corrcoef(lb.ravel(), lq.ravel())[0, 1] > 0.99


def test_spare_or_missing_scale_raises(jax_checkpoint):
    path, images = jax_checkpoint
    port = _int8_port(path, "float32")
    state = port._replicas[0].state
    scales = list(state.scales)
    state.scales = scales + [0.1]
    with pytest.raises(ValueError, match="calibrated scales"):
        port.predict_logits(images)
    state.scales = scales[:-1]
    with pytest.raises(ValueError, match="more quantizable"):
        port.predict_logits(images)
    state.scales = scales
    assert np.isfinite(port.predict_logits(images)).all()


def test_only_int8_is_offered():
    with pytest.raises(ValueError, match="only 'int8'"):
        Predictor("resnet", {"dataset": "cifar10", "depth": 8},
                  dtype="float32", batch_size=2, device="cpu",
                  quantize="fp8")
