"""Post-training int8 quantization for the serving path (counterpart of
convnet_tpu/nn/quant.py).

The JAX package's scheme: symmetric per-output-channel int8 weights, made
from the weights (nothing to calibrate), and symmetric per-tensor static
activation scales from a calibration pass over the float model. Only
stride-1, dense, unpadded 1x1 convs on maps of at least 16 pixels are
quantized (:func:`conv_eligible`); 3x3 convs, the classifier and stride-2
projections stay in the float type.

On the TPU the int8 path lost to bf16 because its quantize and dequantize
were separate passes over a bandwidth-bound model. Here each quantized conv
is one launch of the int8 kernel (``ops/kernels/matmul_int8.py``), which
quantizes x while loading it and dequantizes, with the folded BN (or the
conv's bias) and the activation, in its epilogue.

State. In place of the JAX package's trace-time cursor in its ``Context``,
a model carries a :class:`QuantState`, set on each of its ``Conv2d`` (and on
each module that must step aside under quantization, such as MobileNet-V2's
fused block) by :func:`attach`. In ``"calibrate"`` mode each eligible conv
records the range of its input and computes its float forward; in
``"int8"`` mode each eligible conv takes the next scale, in call order,
which is deterministic (module definition order), so calibration and
inference pair up. A forward that needs more scales than there are, or
leaves some unused, raises.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

from convnet_tpu_torch.ops.kernels.matmul_int8 import (
    dequantized, int8_sums, quantize_act, quantize_weight_1x1)


class QuantState:
    """A model's int8 state. ``mode="calibrate"``: ``observed`` collects each
    eligible conv's input amax (float32 tensors, call order). ``mode="int8"``:
    ``scales`` holds the activation scales (amax / 127), taken one a conv by
    each forward run under :meth:`forward`."""

    def __init__(self, mode: str, scales=()):
        if mode not in ("calibrate", "int8"):
            raise ValueError(f"mode={mode!r}: 'calibrate' or 'int8'")
        self.mode = mode
        self.scales = [float(s) for s in scales]
        self.observed: List[torch.Tensor] = []
        self.cursor = 0

    def take(self, x):
        """The activation scale of the eligible conv that reads x next, or
        None while calibrating (x's range is recorded)."""
        if self.mode == "calibrate":
            self.observed.append(x.detach().abs().amax().float())
            return None
        if self.cursor >= len(self.scales):
            raise ValueError(
                f"QuantState: the model has more quantizable convs than "
                f"calibrated scales ({len(self.scales)}): calibrate with the "
                f"same model, config and input size")
        s = self.scales[self.cursor]
        self.cursor += 1
        return s

    @contextlib.contextmanager
    def forward(self):
        """One forward: the cursor starts at the first scale, and every
        scale must have been taken when the forward returns."""
        self.cursor = 0
        self.observed = []
        yield self
        if self.mode == "int8" and self.cursor != len(self.scales):
            raise ValueError(
                f"QuantState: {len(self.scales)} calibrated scales but the "
                f"forward quantized {self.cursor} convs: calibrate with the "
                f"same model, config and input size")


def attach(model, state):
    """Sets ``state`` (a :class:`QuantState`, or None to detach) on every
    module of ``model`` that has a ``quant`` attribute."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = state
    return model


def conv_eligible(conv, x_shape) -> bool:
    """Stride-1, dense, unpadded 1x1 convs on maps of at least 16 pixels
    (``x_shape`` NHWC): the set the JAX package quantizes
    (``nn/quant.py:86-106``). Deterministic in (conv, x_shape)."""
    def flat(v):
        if isinstance(v, (tuple, list)):
            return [q for p in v for q in flat(p)]
        return [v]

    return (tuple(conv.kernel_size) == (1, 1) and conv.groups == 1
            and set(flat(conv.stride)) == {1}
            and set(flat(conv.padding)) == {0}
            and set(flat(conv.dilation)) == {1}
            and x_shape[1] * x_shape[2] >= 16)


def conv1x1_int8(x, w, act_scale: float):
    """The reference's int8 pointwise conv: x NHWC, w the OIHW (or (N, K))
    weight; quantize, int8 product, per-channel dequantize to x's type."""
    b, h, wd, c = x.shape
    xq, eff_scale = quantize_act(x.reshape(-1, c), act_scale)
    wq, sw = quantize_weight_1x1(w)
    y = dequantized(int8_sums(xq, wq), eff_scale, sw, x.dtype)
    return y.reshape(b, h, wd, -1)


@torch.no_grad()
def calibrate(model, batches) -> List[float]:
    """Runs the float model in eval over ``batches`` (NHWC tensors,
    normalized as the inference inputs are), recording every eligible conv's
    input amax; returns the activation scales, ``max(1e-8, max over batches
    of amax) / 127``, in call order."""
    state = QuantState("calibrate")
    attach(model, state)
    per_batch = []
    try:
        for x in batches:
            with state.forward():
                model(x)
            per_batch.append(torch.stack(state.observed).tolist()
                             if state.observed else [])
    finally:
        attach(model, None)
    if not per_batch:
        raise ValueError("calibrate: need at least one batch")
    n = len(per_batch[0])
    if any(len(b) != n for b in per_batch):
        raise ValueError("calibrate: inconsistent quantizable-conv count "
                         "across batches (batch shapes differ?)")
    return [max(1e-8, max(b[i] for b in per_batch)) / 127.0
            for i in range(n)]
