"""Carry weights between the JAX package and the port.

The JAX package keeps parameters and BatchNorm statistics as two nested
dicts (``params``, ``state``) keyed like the port's module tree.
``from_jax_params`` turns them, as numpy arrays, into the port's
``state_dict``: a mechanical rename plus a transpose of each weight;
``to_jax_params`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch

# (JAX leaf name, its array's ndim or None for any) → (port name, transpose)
_RENAME = {
    ("w", 4): ("weight", (3, 2, 0, 1)),   # conv HWIO → OIHW
    ("w", 2): ("weight", (1, 0)),         # linear (in, out) → (out, in)
    ("b", None): ("bias", None),
    ("scale", None): ("weight", None),    # BN γ
    ("bias", None): ("bias", None),       # BN β
    ("mean", None): ("running_mean", None),
    ("var", None): ("running_var", None),
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        elif isinstance(v, torch.Tensor):     # a bfloat16 leaf of a checkpoint
            yield prefix + (str(k),), v.detach().float().numpy()
        else:
            yield prefix + (str(k),), np.asarray(v)


def from_jax_params(params, state=None) -> dict:
    """``params``/``state``: the JAX package's pytrees (nested dicts of
    arrays). Returns a ``state_dict`` of float32 CPU tensors for the port's
    model of the same architecture."""
    out = {}
    for path, arr in [*_leaves(params), *_leaves(state or {})]:
        leaf = path[-1]
        key = (leaf, arr.ndim) if (leaf, arr.ndim) in _RENAME else (leaf, None)
        if key not in _RENAME:
            raise KeyError(f"no port name for JAX leaf {'.'.join(path)} "
                           f"of shape {arr.shape}")
        name, perm = _RENAME[key]
        if perm is not None:
            arr = arr.transpose(perm)
        out[".".join(path[:-1] + (name,))] = torch.tensor(arr,
                                                         dtype=torch.float32)
    return out


def bn_modules(state_dict):
    """The modules of ``state_dict`` that are BatchNorms (they hold a
    ``running_mean``)."""
    return {k.rsplit(".", 1)[0] for k in state_dict
            if k.endswith("running_mean")}


def jax_name(key, ndim, bns):
    """Where the port's ``state_dict`` entry ``key`` of ``ndim`` dimensions
    lives in the JAX package: (``"params"`` or ``"state"``, its path as a
    tuple, the transpose from the port's layout to JAX's or None). ``bns``:
    :func:`bn_modules` of the state dict; a ``bias`` beside a
    ``running_mean`` is a BatchNorm β (``bias``), any other a layer's bias
    (``b``)."""
    *path, leaf = key.split(".")
    tree, perm = "params", None
    if leaf == "running_mean":
        tree, leaf = "state", "mean"
    elif leaf == "running_var":
        tree, leaf = "state", "var"
    elif leaf == "weight" and ndim == 4:
        leaf, perm = "w", (2, 3, 1, 0)                 # OIHW → HWIO
    elif leaf == "weight" and ndim == 2:
        leaf, perm = "w", (1, 0)                       # (out, in) → (in, out)
    elif leaf == "weight":
        leaf = "scale"                                 # BN γ
    elif leaf == "bias" and ".".join(path) not in bns:
        leaf = "b"
    elif leaf != "bias":
        raise KeyError(f"no JAX name for port entry {key} of {ndim} "
                       f"dimensions")
    return tree, tuple(path) + (leaf,), perm


def to_jax_params(state_dict) -> tuple[dict, dict]:
    """The inverse of :func:`from_jax_params`: a port ``state_dict`` →
    (``params``, ``state``), nested dicts of float32 numpy arrays in the JAX
    package's names and layouts (:func:`jax_name`)."""
    trees = {"params": {}, "state": {}}
    bns = bn_modules(state_dict)
    for key, value in state_dict.items():
        arr = np.array(value.detach().cpu().float().numpy())  # a copy
        tree, path, perm = jax_name(key, arr.ndim, bns)
        if perm is not None:
            arr = arr.transpose(perm)
        node = trees[tree]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return trees["params"], trees["state"]
