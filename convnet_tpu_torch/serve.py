"""Inference engine (counterpart of convnet_tpu/serve.py).

``Predictor``: weights (seeded init, the JAX package's pytrees, an npz
checkpoint of either package, or a convNet.pytorch torch checkpoint through
``utils/torch_import.py``) → BN folded into the convs → one batched eval
forward in the compute dtype, with requests padded to a fixed batch. On the
card every 1x1 stride-1 ``ConvBN`` runs the hand-written fused 1x1 kernel,
and each stride-1 inverted residual of MobileNet-V2 the fused MBConv kernel.

- ``quantize="int8"``: post-training int8 quantization (``nn/quant.py``):
  static activation scales from a calibration pass, then every eligible 1x1
  conv is one launch of the int8 kernel, which quantizes on load and
  dequantizes, with the folded BN and the activation, in its epilogue.
- ``devices=``: data-parallel serving, a replica of the folded model on each
  device and the padded batch split evenly over them.
- ``Predictor.export`` writes a ``torch.export`` artifact (weights,
  normalisation and int8 scales inside; every kernel a registered
  ``convnet_tpu_torch::`` op); ``load_exported`` serves it without the
  model's code or checkpoint.
- ``predict_jpeg`` classifies raw JPEG bytes: the native decoder
  (``data/native.py``) or PIL, then the same forward.

The HTTP server with request micro-batching is ``serve_http.py``.
The JAX package's ``export(platforms=)`` (StableHLO cross-lowering) has no
counterpart: an artifact runs on the kind of device it was exported on.
"""

from __future__ import annotations

import copy
import io
import os
import zipfile
from typing import Optional

import numpy as np
import torch
from torch import nn

from convnet_tpu_torch import models
from convnet_tpu_torch.core.device import resolve_device
from convnet_tpu_torch.core.dtypes import get_policy
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.data.preprocess import (DATASET_STATS,
                                               default_image_size,
                                               scale_crop_host)
from convnet_tpu_torch.nn import quant
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


def resolve_devices(devices) -> list:
    """``"all"``: every CUDA device (raises without one, never the CPU); an
    int N: the first N CUDA devices; else a list of devices."""
    if devices == "all":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("devices='all': no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, int) and not isinstance(devices, bool):
        n = torch.cuda.device_count()
        if not 0 < devices <= n:
            raise ValueError(f"devices={devices}: this host has {n} CUDA "
                             f"devices")
        return [torch.device("cuda", i) for i in range(devices)]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices: empty device list")
    return devs


class ServingModule(nn.Module):
    """One replica's serving function: uint8 (or [0, 1] float) NHWC images →
    float32 logits, with the /255 scaling, the normalisation and the cast
    to the compute type inside, and under int8 the model's ``QuantState``
    (every forward takes all its scales). What ``Predictor.export``
    traces."""

    def __init__(self, model, policy, mean, std, state=None):
        super().__init__()
        self.model = model
        self.policy = policy
        self.state = state
        if mean is not None:
            device = next(model.parameters()).device
            self.register_buffer("mean", mean.to(device))
            self.register_buffer("std", std.to(device))
        else:
            self.mean = self.std = None

    def prep(self, x):
        # uint8 travels to the device as 1 byte a pixel and is scaled there;
        # float inputs are expected in [0, 1]
        if x.dtype == torch.uint8:
            x = x.to(self.policy.compute_dtype) / 255.0
        if self.mean is not None:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        return self.policy.cast_to_compute(x)

    def forward(self, x):
        x = self.prep(x)
        if self.state is None:
            return self.model(x).float()
        with self.state.forward():
            return self.model(x).float()


class Predictor:
    def __init__(self, model_name: Optional[str] = None,
                 model_config: Optional[dict] = None,
                 checkpoint: Optional[str] = None, params=None, state=None,
                 dtype: str = "bf16", batch_size: int = 64,
                 absorb_bn: bool = True, normalize="auto",
                 quantize: Optional[str] = None, calibration=None,
                 input_size: Optional[int] = None, device=None, devices=None,
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

        ``quantize="int8"``: post-training int8 quantization of the eligible
        1x1 convs (``nn/quant.py``). ``calibration``: (N, H, W, C) uint8 or
        [0, 1] float images for the range observation pass, in batches of
        32; when omitted, 16 random uint8 images of ``input_size`` from
        ``np.random.default_rng(0)``, the JAX package's, so the two
        packages' ``act_scales`` (the activation scales, in call order) can
        be compared. Real images give tighter ranges.

        ``device``: where the model runs; ``None`` is the CUDA card.
        ``devices``: data-parallel serving: ``"all"`` (every CUDA device), an
        int (the first N CUDA devices) or a list of devices. Each holds a
        replica of the folded model; each padded batch is split evenly over
        them (``batch_size`` must divide), every shard's forward is launched
        before any result is read, and the logits are gathered in order.
        ``device`` and ``devices`` together raise: pass one."""
        if device is not None and devices is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = (resolve_devices(devices) if devices is not None
                        else [resolve_device(device)])
        self.device = self.devices[0]
        if batch_size % len(self.devices):
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{len(self.devices)} serving devices")
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
        mean = std = None
        if normalize is not None:
            mean = torch.tensor(normalize["mean"], dtype=torch.float32)
            std = torch.tensor(normalize["std"], dtype=torch.float32)
        serving = ServingModule(self.model, self.policy, mean, std)
        self._mean, self._std = serving.mean, serving.std

        self.act_scales = None
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"quantize={quantize!r}: only 'int8' is "
                                 f"supported")
            calib = calibration
            if calib is None:
                calib = np.random.default_rng(0).integers(
                    0, 256, (16, self.input_size, self.input_size, 3),
                    np.uint8)
            calib = np.asarray(calib)
            with torch.inference_mode():
                batches = [serving.prep(torch.from_numpy(
                    calib[i:i + 32]).to(self.device))
                    for i in range(0, len(calib), 32)]
                self.act_scales = tuple(quant.calibrate(self.model,
                                                        batches))
            serving.state = quant.QuantState("int8", self.act_scales)
            quant.attach(self.model, serving.state)
        # one replica a device; deepcopy gives each its own quant state,
        # which its convs share
        self._replicas = [serving] + [copy.deepcopy(serving).to(d)
                                      for d in self.devices[1:]]

    @classmethod
    def from_checkpoint(cls, checkpoint: str, **kwargs) -> "Predictor":
        """Serving straight from a training run: the checkpoint's model name
        and config rebuild the architecture; ``checkpoint`` may be the run
        directory (its ``checkpoint.npz``)."""
        return cls(checkpoint=checkpoint, **kwargs)

    @torch.inference_mode()
    def _forward(self, chunk):
        """Logits (on the host) of one padded batch, a numpy array: each
        replica's shard is moved and its forward launched before any result
        is read."""
        shards = np.split(chunk, len(self._replicas))
        outs = [replica(torch.from_numpy(shard).to(dev))
                for replica, dev, shard in zip(self._replicas, self.devices,
                                               shards)]
        return torch.cat([o.cpu() for o in outs]).numpy()

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
            outs.append(self._forward(chunk)[:self.batch_size - pad])
        return np.concatenate(outs)[:n]

    def predict(self, x, topk: int = 1):
        logits = self.predict_logits(x)
        idx = np.argsort(-logits, axis=-1)[:, :topk]
        return idx if topk > 1 else idx[:, 0]

    def __call__(self, x):
        return self.predict_logits(x)

    def export(self, path: Optional[str] = None) -> bytes:
        """The serving function as a ``torch.export`` artifact, saved with
        ``torch.export.save``: its input is uint8 NHWC ``(batch_size,
        input_size, input_size, 3)``, its output float32 logits; the /255
        scaling, the normalisation, the folded weights and the int8 scales
        are inside. Each kernel the forward launches is in the graph as a
        registered op (``convnet_tpu_torch::matmul_scale_act``,
        ``max_pool2d_fwd``, ``grouped_conv2d``, ``depthwise_conv2d``,
        ``mbconv_full``, ``matmul_int8``), whose implementation is the
        kernel on the card and the plain version on the CPU. The artifact
        runs on the kind of device it was exported on; load it with
        :func:`load_exported`, which registers the ops first. Writes the
        artifact to ``path`` when given; returns its bytes."""
        if len(self.devices) > 1:
            raise ValueError(
                "export requires a single-device Predictor (the artifact "
                "would pin the serving site to this device layout); build "
                "it with devices=None to export")
        spec = torch.zeros((self.batch_size, self.input_size,
                            self.input_size, 3), dtype=torch.uint8,
                           device=self.device)
        with torch.no_grad():
            program = torch.export.export(self._replicas[0], (spec,))
        buf = io.BytesIO()
        torch.export.save(program, buf)
        data = buf.getvalue()
        if path is not None:
            with open(path, "wb") as f:
                f.write(data)
        return data


class ExportedPredictor:
    """Serves a ``Predictor.export`` artifact: the checkpoint-free
    deployment endpoint. Pads and chunks requests of any size to the
    artifact's batch, as ``Predictor`` does, on the device the artifact was
    exported on. The artifact's kernel ops are registered by this module's
    imports (``models`` imports every kernel module)."""

    def __init__(self, path_or_bytes):
        data = path_or_bytes
        if not isinstance(data, (bytes, bytearray)):
            with open(data, "rb") as f:
                data = f.read()
        self._program = torch.export.load(io.BytesIO(bytes(data)))
        names = set(self._program.graph_signature.user_inputs)
        spec = next(node.meta["val"] for node in self._program.graph.nodes
                    if node.op == "placeholder" and node.name in names)
        self.batch_size = int(spec.shape[0])
        self.input_size = int(spec.shape[1])
        self.device = spec.device
        self._module = self._program.module()

    @torch.inference_mode()
    def predict_logits(self, x) -> np.ndarray:
        x = np.asarray(x, np.uint8)
        n = x.shape[0]
        outs = []
        for i in range(0, n, self.batch_size):
            chunk = x[i:i + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            logits = self._module(torch.from_numpy(chunk).to(self.device))
            outs.append(logits.cpu().numpy()[:self.batch_size - pad])
        return np.concatenate(outs)[:n]

    def predict(self, x, topk: int = 1):
        logits = self.predict_logits(x)
        idx = np.argsort(-logits, axis=-1)[:, :topk]
        return idx if topk > 1 else idx[:, 0]

    __call__ = predict_logits


def load_exported(path_or_bytes) -> ExportedPredictor:
    return ExportedPredictor(path_or_bytes)


def _decode_jpeg_pil(blob, out_size, scale_size=None):
    """One JPEG through the training pipeline's eval transform
    (``scale_crop_host``), so serving does not fork its geometry."""
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
