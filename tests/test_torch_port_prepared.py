"""Prepared weights (``ops/kernels/_prepared.py``), on the CPU.

A kernel-layout tensor (the fused 1x1's (N, K) weight in the compute type,
the grouped conv's packed tiles, ``ConvBN``'s folded BN) is made once per
weight version: the same tensor comes back until a source is changed in
place (an optimizer step, ``load_state_dict``, a running-statistics update),
replaced or freed. With autograd recording through a source nothing is
cached, and a ``ConvBN`` in training never asks. The values are the very
tensors the uncached path computes, so the eval layers still match the JAX
layers (float32, 1e-4, as ``test_layer_in_eval_matches_the_pallas_layer``).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.core.module import Context
from convnet_tpu.models.resnet import Bottleneck as JaxBottleneck
from convnet_tpu.models.resnet import ResNeXtBottleneck as JaxResNeXtBottleneck
from convnet_tpu_torch.models.resnet import (Bottleneck, ConvBN,
                                             ResNeXtBottleneck)
from convnet_tpu_torch.nn import BatchNorm2d
from convnet_tpu_torch.ops.kernels import _prepared, grouped_conv
from convnet_tpu_torch.ops.kernels import matmul_fused as mf
from convnet_tpu_torch.utils.from_jax import from_jax_params


def _fused_weight(w):
    """What the fused 1x1 wrapper asks for: the (K, N) view it takes of the
    OIHW weight on every call, in bf16 and (N, K)."""
    view = w.reshape(w.shape[0], -1).t()
    return _prepared.get(("matmul_fused.weight", torch.bfloat16), (view,),
                         lambda v: mf.kernel_weight(v, torch.bfloat16))


@pytest.fixture(autouse=True)
def _empty_cache():
    _prepared.clear()
    yield
    _prepared.clear()


def test_same_tensor_until_the_weight_changes_in_place():
    w = torch.nn.Parameter(torch.randn(256, 64, 1, 1))
    with torch.no_grad():
        first = _fused_weight(w)
        assert _fused_weight(w) is first      # a fresh view finds the entry
        torch.testing.assert_close(first, w.reshape(256, 64).bfloat16(),
                                   rtol=0, atol=0)
        w.add_(1)
        second = _fused_weight(w)
    assert second is not first
    torch.testing.assert_close(second, w.detach().reshape(256, 64).bfloat16(),
                               rtol=0, atol=0)


def test_inference_mode_values_are_plain_tensors():
    w = torch.nn.Parameter(torch.randn(8, 4, 1, 1))
    with torch.inference_mode():
        value = _fused_weight(w)
    assert not value.is_inference()
    with torch.no_grad():
        assert _fused_weight(w) is value


def test_the_grouped_tiles_are_made_once_per_version():
    w = torch.nn.Parameter(torch.randn(128, 4, 3, 3))
    calls = []

    def make(w):
        calls.append(1)
        return grouped_conv.block_tiles(w)

    with torch.no_grad():
        a = _prepared.get("tiles", (w,), make)
        b = _prepared.get("tiles", (w,), make)
        w.mul_(2)
        c = _prepared.get("tiles", (w,), make)
    assert a is b and c is not a and len(calls) == 2
    torch.testing.assert_close(c, grouped_conv.block_tiles(w.detach()),
                               rtol=0, atol=0)


def test_replaced_and_freed_sources_drop_their_entries():
    w = torch.randn(16, 8)
    with torch.no_grad():
        _prepared.get("t", (w,), lambda w: w * 2)
    assert len(_prepared._CACHE) == 1
    del w
    gc.collect()
    assert len(_prepared._CACHE) == 0


def test_recording_autograd_is_never_cached():
    w = torch.nn.Parameter(torch.randn(16, 8))
    a = _prepared.get("t", (w,), lambda w: w * 2)
    b = _prepared.get("t", (w,), lambda w: w * 2)
    assert a is not b and a.grad_fn is not None and not _prepared._CACHE


def _convbn_counting_folds(monkeypatch):
    calls = []
    folded = BatchNorm2d.folded

    def counting(self):
        calls.append(1)
        return folded(self)

    monkeypatch.setattr(BatchNorm2d, "folded", counting)
    return calls


def test_convbn_folds_once_per_version_of_its_bn(monkeypatch):
    calls = _convbn_counting_folds(monkeypatch)
    torch.manual_seed(0)
    m = ConvBN(16, 32, 1).eval()
    x = torch.randn(2, 5, 5, 16)
    with torch.no_grad():
        y0 = m(x)
        torch.testing.assert_close(m(x), y0, rtol=0, atol=0)
        assert len(calls) == 1
        m.bn.running_var.mul_(4.0)                # new statistics
        y1 = m(x)
        assert len(calls) == 2 and not torch.allclose(y1, y0)
        state = {k: v.clone() for k, v in m.state_dict().items()}
        state["bn.bias"] += 1.0
        m.load_state_dict(state)                  # copies in place
        y2 = m(x)
        assert len(calls) == 3
        m(x)
        assert len(calls) == 3
    scale, shift = m.bn.folded()
    ref = mf.matmul_scale_act_plain(x.reshape(-1, 16),
                                    m.conv.weight.reshape(32, 16).t(),
                                    scale, shift, "relu").view(2, 5, 5, 32)
    torch.testing.assert_close(y2, ref, rtol=0, atol=0)


def test_convbn_in_training_never_reads_the_cache(monkeypatch):
    asked = []
    real = _prepared.get

    def spy(*args, **kwargs):
        asked.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(_prepared, "get", spy)
    torch.manual_seed(0)
    block = Bottleneck(64, 16).train()
    x = torch.randn(2, 6, 6, 64, requires_grad=True)
    block(x).square().sum().backward()
    assert asked == [] and not _prepared._CACHE
    block.eval()
    with torch.no_grad():
        block(x)
    assert asked.count("batch_norm.folded") == 2     # cb1 and cb3


@pytest.mark.parametrize("port_cls,jax_cls,inplanes,planes,groups", [
    (Bottleneck, JaxBottleneck, 128, 32, 1),
    (ResNeXtBottleneck, JaxResNeXtBottleneck, 256, 128, 32),
])
def test_bottleneck_in_eval_matches_the_jax_layer(port_cls, jax_cls,
                                                  inplanes, planes, groups):
    """The port's eval bottleneck (fused 1x1s with the cached folded BN; in
    the ResNeXt one the grouped 3x3 route, cg 4) against the JAX layer with
    ``impl="pallas"`` (its fused 1x1 in interpret mode), float32, 1e-4;
    a second forward, from the cache, is bit-equal to the first."""
    ref = jax_cls(inplanes, planes, groups=groups)
    params, state = ref.init(jax.random.PRNGKey(groups))
    rng = np.random.default_rng(groups)
    # BN statistics and affine away from their initial values, so the
    # folding is exercised
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype), state)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                  a.dtype), params)
    x = rng.standard_normal((2, 7, 7, inplanes)).astype(np.float32)
    y_ref, _ = ref(params, state, jnp.asarray(x),
                   Context(train=False, impl="pallas"))
    port = port_cls(inplanes, planes, groups=groups).eval()
    port.load_state_dict(from_jax_params(params, state))
    assert port.cb2.conv.uses_grouped_kernel() == (groups > 1)
    with torch.no_grad():
        first = port(torch.from_numpy(x)).numpy()
        again = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(first, np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(again, first)
