"""ZeRO-1: optimizer state sharded over the data axis (counterpart of
convnet_tpu/parallel/zero.py).

Each rank keeps only its slice of the optimizer's moments, and the update is
distributed as in the JAX package:

  1. the gradients → ``dist.reduce_scatter_tensor`` (each rank receives the
     sum of its 1/n slice of the flat gradient; /n for the mean),
  2. each rank updates its slice of the flat parameter vector with its
     slice of the moments,
  3. ``dist.all_gather_into_tensor`` reassembles the parameters.

The flat vector is the float32 concatenation of the parameters padded with
zeros to a multiple of the data degree. Its order is the model's
``named_parameters`` order, each tensor in its own (torch) layout; a
checkpoint stores the moments in the JAX package's order instead
(``jax.flatten_util.ravel_pytree`` of the JAX parameter tree, padded the
same way), through :func:`jax_order_index`, so a ZeRO checkpoint moves
between the two packages. The elementwise optimizers run the port's own
step functions on views of the slice, tensor by tensor; LARS and LAMB need
each tensor's norm, which a slice cannot see: each rank sums its slice's
squares into one bucket a tensor and one small all-reduce gives the global
norms (:func:`segment_sq_sums`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from convnet_tpu_torch.regimes.optim import _bias_corrections

# torch >= 2.13 renames the two collectives (same arguments)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def flat_size(params, n_shards: int) -> int:
    """Padded flat length (a multiple of ``n_shards``)."""
    size = sum(p.numel() for p in params)
    return -(-size // n_shards) * n_shards


def flatten(tensors, padded: int):
    """The float32 concatenation of ``tensors``, zero-padded to
    ``padded``."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    return torch.nn.functional.pad(flat, (0, padded - flat.numel()))


def flat_mask01(params, mask, n_shards: int):
    """The flat 0/1 weight-decay mask (``mask``: one bool a tensor),
    padded."""
    flat = torch.cat([torch.full((p.numel(),), 1.0 if m else 0.0,
                                 device=p.device)
                      for p, m in zip(params, mask, strict=True)])
    return torch.nn.functional.pad(
        flat, (0, flat_size(params, n_shards) - flat.numel()))


def leaf_segment_ids(params, n_shards: int):
    """Flat index → tensor ordinal; the pad tail gets ``len(params)`` (a
    discard bucket)."""
    ids = torch.cat([torch.full((p.numel(),), i, dtype=torch.int64,
                                device=p.device)
                     for i, p in enumerate(params)])
    return torch.nn.functional.pad(
        ids, (0, flat_size(params, n_shards) - ids.numel()),
        value=len(params))


def leaf_mask01(params, mask):
    """One 0/1 weight-decay flag a tensor."""
    return torch.tensor([1.0 if m else 0.0 for m in mask],
                        device=params[0].device)


def shard_slice(flat, group):
    """This rank's slice of a padded flat vector."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    per = flat.shape[0] // n
    return flat[i * per:(i + 1) * per]


def reduce_scatter_mean(grads, padded: int, group):
    """The gradients → this rank's slice of their flat mean over the group
    (one reduce-scatter)."""
    flat = flatten(grads, padded)
    n = dist.get_world_size(group)
    out = flat.new_empty(padded // n)
    _reduce_scatter(out, flat, group=group)
    return out.div_(n)


def gather_flat(flat_slice, group):
    """The full padded vector from every rank's slice (one all-gather)."""
    n = dist.get_world_size(group)
    full = flat_slice.new_empty(flat_slice.numel() * n)
    _all_gather(full, flat_slice.contiguous(), group=group)
    return full


@torch.no_grad()
def gather_params(flat_slice, params, group):
    """All-gathers the updated slices and writes them into ``params`` in
    place."""
    full = gather_flat(flat_slice, group)
    offset = 0
    for p in params:
        p.copy_(full[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def slice_segments(params, n_shards: int, rank: int):
    """(tensor ordinal, start, end) of each tensor's piece inside rank
    ``rank``'s slice, in slice coordinates; the pad is in none."""
    per = flat_size(params, n_shards) // n_shards
    lo, hi = rank * per, (rank + 1) * per
    out, offset = [], 0
    for i, p in enumerate(params):
        a, b = max(offset, lo), min(offset + p.numel(), hi)
        if a < b:
            out.append((i, a - lo, b - lo))
        offset += p.numel()
    return out


@torch.no_grad()
def elementwise_step_sharded(step, p_slice, g_slice, opt_state, hp, *,
                             segments, mask):
    """An elementwise optimizer (``regimes.optim``'s SGD, Adam, AdamW,
    RMSprop step functions) on a ZeRO-1 slice, in place: the step runs on
    views of each tensor's piece, with that tensor's weight-decay flag, so
    its arithmetic is that of the replicated step."""
    view = {slot: v if slot == "step" else [v[a:b] for _, a, b in segments]
            for slot, v in opt_state.items()}
    step([p_slice[a:b] for _, a, b in segments],
         [g_slice[a:b] for _, a, b in segments], view, hp,
         mask=[mask[i] for i, _, _ in segments])
    opt_state["step"] = view["step"]


def segment_sq_sums(vec_slice, seg_slice, n_segments: int, group):
    """Global Σx² of each tensor of a sharded flat vector (one small
    all-reduce); with ``group=None`` the vector is whole and the local sums
    are the global ones."""
    local = vec_slice.new_zeros(n_segments).index_add_(
        0, seg_slice, vec_slice.square())
    if group is not None:
        dist.all_reduce(local, group=group)
    return local


@torch.no_grad()
def lars_step_sharded(p_slice, g_slice, opt_state, hp, *, mask01, seg_slice,
                      w_sq, n_leaves: int, group):
    """LARS on a ZeRO-1 slice, in place. ``w_sq`` is each tensor's Σw² over
    the full (replicated) parameters; the gradients' norms come from the
    slices' segment sums. The elementwise arithmetic is the JAX package's
    ``lars_step_sharded``."""
    g_sq = segment_sq_sums(g_slice, seg_slice, n_leaves + 1, group)[:n_leaves]
    w_norm, g_norm = torch.sqrt(w_sq), torch.sqrt(g_sq)
    eta, wd = hp["trust_coef"], hp["weight_decay"]
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + 1e-9), 1.0)
    trust_slice = torch.cat([trust, trust.new_ones(1)])[seg_slice]
    g2 = g_slice + (wd * mask01) * p_slice
    scale = torch.where(mask01 > 0, trust_slice, 1.0) * hp["lr"]
    mu = opt_state["mu"]
    mu.mul_(hp["momentum"]).add_(scale * g2)
    p_slice.sub_(mu)
    opt_state["step"] += 1


@torch.no_grad()
def lamb_step_sharded(p_slice, g_slice, opt_state, hp, *, mask01, seg_slice,
                      w_sq, leaf_mask, n_leaves: int, group):
    """LAMB on a ZeRO-1 slice, in place: Adam's bias-corrected moments, and
    the trust ratio ‖w‖ / ‖u‖ from segment sums (the JAX package's
    ``lamb_step_sharded``)."""
    step = opt_state["step"] + 1
    b1, b2 = hp["beta1"], hp["beta2"]
    m, v = opt_state["m"], opt_state["v"]
    m.mul_(b1).add_(g_slice, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g_slice, g_slice, value=1.0 - b2)
    c1, c2 = _bias_corrections(hp, step)
    u = (m / c1) / (torch.sqrt(v / c2) + hp["eps"])
    u = u + (hp["weight_decay"] * mask01) * p_slice
    u_sq = segment_sq_sums(u, seg_slice, n_leaves + 1, group)[:n_leaves]
    w_norm, u_norm = torch.sqrt(w_sq), torch.sqrt(u_sq)
    ratio = torch.where((leaf_mask > 0) & (w_norm > 0) & (u_norm > 0),
                        w_norm / (u_norm + 1e-9), 1.0)
    ratio_slice = torch.cat([ratio, ratio.new_ones(1)])[seg_slice]
    p_slice.sub_(hp["lr"] * ratio_slice * u)
    opt_state["step"] = step


def jax_order_index(model) -> np.ndarray:
    """``idx`` with ``jax_flat = port_flat[idx]``: where each element of the
    JAX package's flat layout (``ravel_pytree`` of its parameter tree: keys
    sorted, HWIO convs, (in, out) dense weights) sits in the port's
    (``named_parameters`` order, torch layouts)."""
    from convnet_tpu_torch.utils.checkpoint import (_sorted_leaves,
                                                    slots_to_tree)
    offset, pieces = 0, []
    for p in model.parameters():
        pieces.append(torch.arange(offset, offset + p.numel(),
                                   dtype=torch.int64).view(p.shape))
        offset += p.numel()
    tree = slots_to_tree(model, pieces)
    return np.concatenate([np.asarray(leaf).reshape(-1)
                           for _, leaf in _sorted_leaves(tree)])
