"""Carry the JAX package's weights into the port.

The JAX package keeps parameters and BatchNorm statistics as two nested
dicts (``params``, ``state``) keyed like the port's module tree. This turns
them, as numpy arrays, into the port's ``state_dict``: a mechanical rename
plus a transpose of each weight.
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
