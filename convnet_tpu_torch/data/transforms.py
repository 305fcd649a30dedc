"""Batched NHWC augmentation on the device (counterpart of
convnet_tpu/data/transforms.py).

Every function takes ``x`` as an (N, H, W, C) tensor, float32 in [0, 1]
unless noted, on the device that runs it (the card in training). Each random
op is split in two: ``draw_<op>(generator, ...)`` draws its per-sample
values from an explicit ``torch.Generator`` on the batch's device, and the
application ``<op>(x, draws...)`` is deterministic, so a test can feed it
the JAX package's draws; ``random_<op>(generator, x, ...)`` is the two
together. A ``jax.random`` key cannot drive a ``torch.Generator``, so the
draws themselves follow the reference's distributions, not its stream.

``resize`` and ``resized_crop`` compute what ``jax.image.resize`` and
``jax.image.scale_and_translate`` compute with the bilinear (triangle)
kernel and ``antialias=True``: a separable weight matrix per sample and
axis, with half-pixel centres and the kernel widened by 1/scale when it
shrinks, applied as two batched matmuls. (``F.interpolate`` does not
antialias fractional boxes this way.)
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def to_float(x):
    """uint8 [0, 255] → float32 [0, 1] (no-op for float input)."""
    if x.is_floating_point():
        return x
    return x.float() / 255.0


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, made once: a tensor made from a
    list on the card for every batch is a blocking copy, which makes the
    host wait for the previous step."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _const(values, device):
    nested = tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                   for v in values)
    return _constant(nested, torch.device(device))


def normalize(x, mean: Sequence[float], std: Sequence[float]):
    return (x - _const(mean, x.device)) / _const(std, x.device)


def _uniform(generator, n, low=0.0, high=1.0):
    u = torch.rand((n,), generator=generator, device=generator.device)
    return low + (high - low) * u


def _randint(generator, shape, high):
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device)


# ------------------------------------------------------------- flip


def draw_hflip(generator, batch: int, p: float = 0.5):
    """(batch,) bool: which samples flip."""
    return _uniform(generator, batch) < p


def hflip(x, flip):
    return torch.where(flip.view(-1, 1, 1, 1).to(x.device), x.flip(2), x)


def random_hflip(generator, x, p: float = 0.5):
    return hflip(x, draw_hflip(generator, x.shape[0], p))


# ------------------------------------------------------------- crops


def draw_offsets(generator, batch: int, high_y: int, high_x: int):
    """(oy, ox), each (batch,) int64 in [0, high)."""
    return _randint(generator, (batch,), high_y), _randint(
        generator, (batch,), high_x)


def crop(x, size_y: int, size_x: int, oy, ox):
    """Per-sample crop of ``size_y`` × ``size_x`` at rows ``oy``, columns
    ``ox`` (a gather)."""
    b = x.shape[0]
    rows = oy.to(x.device).view(b, 1) + torch.arange(size_y, device=x.device)
    cols = ox.to(x.device).view(b, 1) + torch.arange(size_x, device=x.device)
    batch = torch.arange(b, device=x.device).view(b, 1, 1)
    return x[batch, rows.view(b, size_y, 1), cols.view(b, 1, size_x)]


def pad_crop(x, padding: int, oy, ox):
    """Zero-pad by ``padding`` then crop back to the original size at
    (oy, ox) of the padded image."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    return crop(xp, h, w, oy, ox)


def pad_random_crop(generator, x, padding: int):
    """CIFAR-style: zero-pad by ``padding`` then random-crop back to the
    original size, per sample."""
    oy, ox = draw_offsets(generator, x.shape[0], 2 * padding + 1,
                          2 * padding + 1)
    return pad_crop(x, padding, oy, ox)


def random_crop(generator, x, size: int):
    """Random crop to size×size (input must be ≥ size)."""
    b, h, w, _ = x.shape
    oy, ox = draw_offsets(generator, b, h - size + 1, w - size + 1)
    return crop(x, size, size, oy, ox)


def center_crop(x, size: int):
    _, h, w, _ = x.shape
    y0 = (h - size) // 2
    x0 = (w - size) // 2
    return x[:, y0:y0 + size, x0:x0 + size, :]


# ------------------------------------------------------------- cutout


def draw_cutout(generator, batch: int, h: int, w: int, count: int = 1):
    """Hole centres (cy, cx), each (batch, count) int64."""
    return (_randint(generator, (batch, count), h),
            _randint(generator, (batch, count), w))


def cutout(x, size: int, cy, cx):
    """Zeroes a size×size square per hole, rows [cy − size//2, cy + size −
    size//2) and the same for columns (holes clipped at the border)."""
    _, h, w, _ = x.shape
    cy, cx = cy.to(x.device), cx.to(x.device)
    rows = torch.arange(h, device=x.device).view(1, 1, h, 1)
    cols = torch.arange(w, device=x.device).view(1, 1, 1, w)
    lo_y = (cy - size // 2)[:, :, None, None]
    lo_x = (cx - size // 2)[:, :, None, None]
    hole = ((rows >= lo_y) & (rows < lo_y + size)
            & (cols >= lo_x) & (cols < lo_x + size))
    mask = 1.0 - hole.any(dim=1).to(x.dtype)
    return x * mask[..., None]


def random_cutout(generator, x, size: int, count: int = 1):
    b, h, w, _ = x.shape
    return cutout(x, size, *draw_cutout(generator, b, h, w, count))


# ------------------------------------------------------------- lighting


def draw_lighting(generator, batch: int, alphastd: float):
    """(batch, 3) float32: the PCA coefficients α ~ N(0, alphastd²)."""
    return alphastd * torch.randn((batch, 3), generator=generator,
                                  device=generator.device)


def lighting(x, alpha, eigval, eigvec):
    """AlexNet-style PCA colour noise: x + Σ_j eigvec[:, j]·α_j·eigval_j."""
    ev = _const(eigval, x.device)
    evec = _const(eigvec, x.device)
    delta = (evec * (alpha.to(x.device) * ev)[:, None, :]).sum(-1)
    return x + delta[:, None, None, :]


def random_lighting(generator, x, alphastd: float, eigval, eigvec):
    if alphastd == 0:
        return x
    return lighting(x, draw_lighting(generator, x.shape[0], alphastd),
                    eigval, eigvec)


# ------------------------------------------------------------- resampling


def _weights(in_size: int, out_size: int, scale, offset):
    """(B, out_size, in_size) float32: ``jax.image``'s antialiased triangle
    weights for output pixel i sampling the input at (i + 0.5)/scale +
    offset − 0.5, per sample (``scale``, ``offset``: (B,) tensors)."""
    dev = scale.device
    scale = scale.float().view(-1, 1, 1)
    offset = offset.float().view(-1, 1, 1)
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0)
    out_i = torch.arange(out_size, dtype=torch.float32, device=dev).view(
        1, -1, 1)
    in_j = torch.arange(in_size, dtype=torch.float32, device=dev).view(
        1, 1, -1)
    sample = (out_i + 0.5) * inv + offset - 0.5             # (B, out, 1)
    w = torch.clamp_min(1.0 - (sample - in_j).abs() / kernel_scale, 0.0)
    total = w.sum(-1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, w, 0.0)


def _resample(x, wy, wx):
    """x (B, H, W, C) float32; wy (B, Ho, H), wx (B, Wo, W) → (B, Ho, Wo,
    C), as two batched matmuls."""
    b, h, w, c = x.shape
    ho, wo = wy.shape[1], wx.shape[1]
    y = torch.bmm(wy, x.reshape(b, h, w * c)).view(b, ho, w, c)
    y = y.permute(0, 2, 1, 3).reshape(b, w, ho * c)
    z = torch.bmm(wx, y).view(b, wo, ho, c)
    return z.permute(0, 2, 1, 3).contiguous()


def draw_resized_crop_boxes(generator, batch: int, h: int, w: int,
                            scale: Tuple[float, float] = (0.08, 1.0),
                            ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """Per-sample boxes (bh, bw, oy, ox), float32 (batch,): an area share
    in ``scale`` and a log-uniform aspect in ``ratio``, the box clipped to
    [8, side], its corner uniform over the room left."""
    area = _uniform(generator, batch, scale[0], scale[1])
    r = torch.exp(_uniform(generator, batch, math.log(ratio[0]),
                           math.log(ratio[1])))
    bh = torch.sqrt(area * h * w / r)
    bw = bh * r
    bh = torch.clamp(bh, 8.0, float(h))
    bw = torch.clamp(bw, 8.0, float(w))
    oy = _uniform(generator, batch) * (h - bh)
    ox = _uniform(generator, batch) * (w - bw)
    return bh, bw, oy, ox


def resized_crop(x, out_size: int, bh, bw, oy, ox):
    """Each sample's (fractional) box [oy, oy + bh) × [ox, ox + bw)
    resampled to out_size × out_size, antialiased (``jax.image.
    scale_and_translate`` with the bilinear kernel)."""
    _, h, w, _ = x.shape
    dev = x.device
    wy = _weights(h, out_size, out_size / bh.to(dev).float(), oy.to(dev))
    wx = _weights(w, out_size, out_size / bw.to(dev).float(), ox.to(dev))
    return _resample(to_float(x).float(), wy, wx)


def random_resized_crop(generator, x, out_size: int,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """Inception-style random-resized-crop, entirely on the device."""
    b, h, w, _ = x.shape
    return resized_crop(x, out_size,
                        *draw_resized_crop_boxes(generator, b, h, w, scale,
                                                 ratio))


def resize(x, size: int):
    """Bilinear resize to size×size, antialiased when it shrinks
    (``jax.image.resize``); an axis already of that size is left alone."""
    b, h, w, _ = x.shape
    x = to_float(x).float()
    if h == size and w == size:
        return x
    dev = x.device

    def axis(n):
        if n == size:
            return torch.eye(size, device=dev).expand(b, size, size)
        return _weights(n, size, torch.full((b,), size / n, device=dev),
                        torch.zeros(b, device=dev))

    return _resample(x, axis(h), axis(w))
