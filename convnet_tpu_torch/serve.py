"""Inference engine (counterpart of convnet_tpu/serve.py:49-269).

``Predictor``: weights (seeded init, or the JAX package's pytrees) →
BN folded into the convs → one batched eval forward in the compute dtype,
with requests padded to a fixed batch. On the card every 1x1 stride-1
``ConvBN`` runs the hand-written fused 1x1 kernel, and each stride-1
inverted residual of MobileNet-V2 the fused MBConv kernel.

Not ported yet: checkpoint loading (JAX or torch), ``quantize``, ``export``,
multi-device serving, ``predict_jpeg`` and the HTTP server.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from convnet_tpu_torch import models
from convnet_tpu_torch.core.device import resolve_device
from convnet_tpu_torch.core.dtypes import get_policy
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.data.preprocess import DATASET_STATS, default_image_size
from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn
from convnet_tpu_torch.utils.from_jax import from_jax_params


class Predictor:
    def __init__(self, model_name: str, model_config: Optional[dict] = None,
                 params=None, state=None, dtype: str = "bf16",
                 batch_size: int = 64, absorb_bn: bool = True,
                 normalize="auto", input_size: Optional[int] = None,
                 device=None, seed: int = 0):
        """``params``/``state``: the JAX package's pytrees (nested dicts of
        arrays) for this architecture; ``None`` draws the weights from a
        ``torch.Generator`` seeded with ``seed``.

        ``normalize``: dataset mean/std applied on the device after the /255
        scaling. ``"auto"`` takes the dataset from ``model_config`` (else the
        model name, else imagenet); pass a dataset name, a
        ``{"mean", "std"}`` dict, or ``None`` (inputs already normalized).

        ``device``: where the model runs; ``None`` is the CUDA card."""
        self.device = resolve_device(device)
        model_config = dict(model_config or {})
        self.model = models.build(model_name, **model_config)
        if params is not None:
            self.model.load_state_dict(from_jax_params(params, state))
        else:
            init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.model.eval()
        if absorb_bn:
            search_absorb_bn(self.model)
        self.model.to(self.device)
        self.policy = get_policy(dtype)
        self.batch_size = batch_size

        dataset = model_config.get("dataset") or (
            model_name if model_name.lower() in DATASET_STATS else "imagenet")
        dataset = str(dataset).lower()
        self.input_size = int(input_size or getattr(self.model, "input_size",
                                                    None)
                              or default_image_size(dataset))
        if normalize == "auto":
            normalize = DATASET_STATS.get(dataset, DATASET_STATS["imagenet"])
        elif isinstance(normalize, str):
            normalize = DATASET_STATS[normalize.lower()]
        if normalize is not None:
            self._mean = torch.tensor(normalize["mean"], dtype=torch.float32,
                                      device=self.device)
            self._std = torch.tensor(normalize["std"], dtype=torch.float32,
                                     device=self.device)
        else:
            self._mean = self._std = None

    def _prep(self, x):
        # uint8 travels to the device as 1 byte a pixel and is scaled there;
        # float inputs are expected in [0, 1]
        if x.dtype == torch.uint8:
            x = x.to(self.policy.compute_dtype) / 255.0
        if self._mean is not None:
            x = (x - self._mean.to(x.dtype)) / self._std.to(x.dtype)
        return self.policy.cast_to_compute(x)

    @torch.inference_mode()
    def _forward(self, x):
        return self.model(self._prep(x)).float()

    def predict_logits(self, x) -> np.ndarray:
        """x: (N, H, W, C) float or uint8; any N — padded to ``batch_size``
        batches internally."""
        x = np.asarray(x)
        n = x.shape[0]
        outs = []
        for i in range(0, n, self.batch_size):
            chunk = x[i:i + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            logits = self._forward(torch.from_numpy(chunk).to(self.device))
            outs.append(logits.cpu().numpy()[:self.batch_size - pad])
        return np.concatenate(outs)[:n]

    def predict(self, x, topk: int = 1):
        logits = self.predict_logits(x)
        idx = np.argsort(-logits, axis=-1)[:, :topk]
        return idx if topk > 1 else idx[:, 0]
