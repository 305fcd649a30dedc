"""Inference engine (counterpart of convnet_tpu/serve.py:49-280).

``Predictor``: weights (seeded init, the JAX package's pytrees, an npz
checkpoint of either package, or a convNet.pytorch torch checkpoint through
``utils/torch_import.py``) → BN folded into the convs → one batched eval
forward in the compute dtype, with requests padded to a fixed batch. On the
card every 1x1 stride-1 ``ConvBN`` runs the hand-written fused 1x1 kernel,
and each stride-1 inverted residual of MobileNet-V2 the fused MBConv kernel.
``predict_jpeg`` classifies raw JPEG bytes: the native decoder
(``data/native.py``) or PIL, then the same forward.

Not ported yet: ``quantize``, ``export``, multi-device serving and the HTTP
server.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

import numpy as np
import torch

from convnet_tpu_torch import models
from convnet_tpu_torch.core.device import resolve_device
from convnet_tpu_torch.core.dtypes import get_policy
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.data.preprocess import (DATASET_STATS,
                                               default_image_size,
                                               scale_crop_host)
from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn
from convnet_tpu_torch.utils.checkpoint import load_checkpoint
from convnet_tpu_torch.utils.from_jax import from_jax_params


def _is_npz(path) -> bool:
    """An npz archive (a zip of ``.npy`` members), by content: a torch
    checkpoint is a zip of pickles or a bare pickle."""
    path = str(path)
    if os.path.isdir(path):
        return True
    try:
        with zipfile.ZipFile(path) as zf:
            return any(n.endswith(".npy") for n in zf.namelist())
    except zipfile.BadZipFile:
        return path.endswith(".npz")


class Predictor:
    def __init__(self, model_name: Optional[str] = None,
                 model_config: Optional[dict] = None,
                 checkpoint: Optional[str] = None, params=None, state=None,
                 dtype: str = "bf16", batch_size: int = 64,
                 absorb_bn: bool = True, normalize="auto",
                 input_size: Optional[int] = None, device=None,
                 seed: int = 0):
        """``checkpoint``: an npz checkpoint (a file or a run directory)
        written by the port or by the JAX package. It records its model's
        name and config, so ``model_name`` may be left out; entries of
        ``model_config`` override the saved ones. Or a torch checkpoint of
        convNet.pytorch (told apart by content, not suffix), which records
        no model: it needs ``model_name``.

        ``params``/``state``: the JAX package's pytrees (nested dicts of
        arrays) for this architecture. With neither these nor a checkpoint,
        the weights are drawn from a ``torch.Generator`` seeded with
        ``seed``.

        ``normalize``: dataset mean/std applied on the device after the /255
        scaling. ``"auto"`` takes the dataset from ``model_config``, else
        the checkpoint's config, else the model name, else imagenet; pass a
        dataset name, a ``{"mean", "std"}`` dict, or ``None`` (inputs
        already normalized). ``input_size`` defaults to the checkpoint's,
        else the model's, else the dataset's.

        ``device``: where the model runs; ``None`` is the CUDA card."""
        self.device = resolve_device(device)
        ckpt = None
        torch_checkpoint = checkpoint is not None and not _is_npz(checkpoint)
        if torch_checkpoint and not model_name:
            raise ValueError(f"{checkpoint}: a torch checkpoint records no "
                             f"model: pass model_name")
        if checkpoint is not None and not torch_checkpoint:
            ckpt = load_checkpoint(checkpoint)
            params, state = ckpt["params"], ckpt.get("state")
            if not model_name:
                if not ckpt.get("model"):
                    raise ValueError(f"{checkpoint} records no model: pass "
                                     f"model_name")
                model_name = ckpt["model"]
                model_config = {**(ckpt.get("config") or {}),
                                **(model_config or {})}
        if not model_name:
            raise ValueError("model_name omitted: pass a checkpoint that "
                             "records its model")
        model_config = dict(model_config or {})
        self.model = models.build(model_name, **model_config)
        if torch_checkpoint:
            from convnet_tpu_torch.utils.torch_import import (
                load_torch_checkpoint)
            try:
                load_torch_checkpoint(checkpoint, self.model)
            except ValueError as e:
                raise ValueError(f"{checkpoint}: a torch checkpoint that "
                                 f"does not fit {model_name}: {e}") from e
        elif params is not None:
            self.model.load_state_dict(from_jax_params(params, state))
        else:
            init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.model.eval()
        if absorb_bn:
            search_absorb_bn(self.model)
        self.model.to(self.device)
        self.policy = get_policy(dtype)
        self.batch_size = batch_size

        dataset = (model_config.get("dataset")
                   or ((ckpt or {}).get("config") or {}).get("dataset")
                   or (model_name if model_name.lower() in DATASET_STATS
                       else "imagenet"))
        dataset = str(dataset).lower()
        self.input_size = int(input_size or (ckpt or {}).get("input_size")
                              or getattr(self.model, "input_size", None)
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

    @classmethod
    def from_checkpoint(cls, checkpoint: str, **kwargs) -> "Predictor":
        """Serving straight from a training run: the checkpoint's model name
        and config rebuild the architecture; ``checkpoint`` may be the run
        directory (its ``checkpoint.npz``)."""
        return cls(checkpoint=checkpoint, **kwargs)

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

    def __call__(self, x):
        return self.predict_logits(x)


def _decode_jpeg_pil(blob, out_size, scale_size=None):
    """One JPEG through the training pipeline's eval transform
    (``scale_crop_host``), so serving does not fork its geometry."""
    import io
    from PIL import Image
    img = Image.open(io.BytesIO(blob))
    return scale_crop_host(img, None, out_size=out_size,
                           scale_size=scale_size)


def predict_jpeg(predictor: Predictor, blobs, topk: int = 1,
                 input_size: Optional[int] = None, threads: int = 8):
    """Classify raw JPEG bytes end to end: the native decode + shorter-side
    scale + center crop (``csrc/jpegdec.cpp``, within 1 LSB of the PIL eval
    transform), then the predictor's uint8 path. ``blobs``: an iterable of
    bytes. PIL decodes every blob when the native library is unavailable,
    and each blob it fails on. ``input_size`` defaults to the predictor's."""
    from convnet_tpu_torch.data import native
    if input_size is None:
        input_size = predictor.input_size
    blobs = list(blobs)
    out = native.decode_blobs(blobs, train=False, out_size=input_size,
                              threads=threads)
    if out is None:
        batch = np.stack([_decode_jpeg_pil(b, input_size) for b in blobs])
    else:
        batch, fail = out
        for j in np.nonzero(fail)[0]:
            batch[j] = _decode_jpeg_pil(blobs[int(j)], input_size)
    return predictor.predict(batch, topk=topk)
