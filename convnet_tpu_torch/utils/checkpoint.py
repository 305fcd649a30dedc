"""Checkpoints as npz archives, readable by the port and by the JAX package
(counterpart of convnet_tpu/utils/checkpoint.py:35-280).

An archive holds ``params/...``, ``state/...`` and ``opt_state/...`` arrays
under the JAX package's names and layouts (HWIO convs, (in, out) dense
weights, ``scale``/``bias``/``mean``/``var``; the optimizer's slots keyed
and transposed like ``params``) and a ``__meta__`` member, the JSON of every
other entry (epoch, model name and config, ``training_steps``, ...). npz
stores no bfloat16: such a leaf is written as its bits (uint16) and its
type is named in ``__meta__["__extended_dtypes__"]``. The port reads and
writes those bits with numpy and ``torch.Tensor.view`` alone, with no
``ml_dtypes``; a bfloat16 leaf loads as a CPU torch tensor, every other as
a numpy array.

``Trainer.checkpoint_dict`` makes the dict that :func:`save_checkpoint`
writes, and ``Trainer.load_checkpoint`` takes what :func:`load_checkpoint`
returns.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from convnet_tpu_torch.utils.from_jax import bn_modules, jax_name

log = logging.getLogger(__name__)

_SEP = "/"

# at most one background write in flight; the next save, or the exit of the
# interpreter, joins it and raises its error
_pending_save: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None
_pending_lock = threading.Lock()


def wait_for_pending_save():
    """Joins the background checkpoint write in flight, if any, and raises
    its error. Every :func:`save_checkpoint` calls it first, and so does the
    interpreter at exit; call it before reading a checkpoint just saved in
    the background."""
    global _pending_save, _pending_error
    with _pending_lock:
        t, _pending_save = _pending_save, None
    if t is not None:
        t.join()
    with _pending_lock:
        err, _pending_error = _pending_error, None
    if err is not None:
        raise err


atexit.register(wait_for_pending_save)


def _host(x):
    """A host copy of a leaf: a numpy array, or a CPU torch tensor where it
    is bfloat16. Tensors are copied even on the CPU: the trainer updates its
    tensors in place while a background write runs."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.array(x)


def flatten_tree(tree, prefix="") -> Dict[str, Any]:
    """A nested dict → {``"a/b/leaf"``: host copy of the leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = _host(tree)
    return out


def unflatten_tree(flat: Dict[str, Any]):
    """The inverse of :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _from_bits(arr: np.ndarray, name: str) -> torch.Tensor:
    """A bfloat16 tensor from its bits as the JAX package stores them."""
    if name != "bfloat16":
        raise ValueError(f"checkpoint leaf of type {name!r}: the port reads "
                         f"bfloat16 only")
    return torch.from_numpy(np.array(arr).view(np.int16)).view(
        torch.bfloat16)


def save_checkpoint(ckpt: Dict[str, Any], is_best: bool, path: str = ".",
                    filename: str = "checkpoint.npz", save_all: bool = False,
                    background: bool = False):
    """Writes ``ckpt`` to ``path/filename`` (through a temporary file and an
    atomic rename): its ``params``, ``state`` and ``opt_state`` trees as
    arrays, every other entry into the JSON meta blob. ``is_best`` copies it
    to ``model_best.npz``; ``save_all`` to ``checkpoint_epoch_N.npz``.

    ``background=True``: the trees are copied to the host before this
    returns (the next step updates the same tensors in place), and the disk
    write runs in a thread. One write is in flight at most; the next save,
    :func:`wait_for_pending_save` or the interpreter's exit joins it and
    raises its error. Returns the file's path."""
    wait_for_pending_save()
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    extended: Dict[str, str] = {}
    for key, value in ckpt.items():
        if key in ("params", "state", "opt_state"):
            arrays.update(flatten_tree(value, f"{key}{_SEP}"))
        else:
            meta[key] = value
    for key, arr in list(arrays.items()):
        if isinstance(arr, torch.Tensor):          # bfloat16: its bits
            extended[key] = "bfloat16"
            arrays[key] = arr.view(torch.int16).numpy().view(np.uint16)
    meta["__extended_dtypes__"] = extended
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, default=str).encode(), dtype=np.uint8)
    target = os.path.join(path, filename)

    def write():
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, target)
        if is_best:
            shutil.copyfile(target, os.path.join(path, "model_best.npz"))
        if save_all and "epoch" in meta:
            shutil.copyfile(target, os.path.join(
                path, f"checkpoint_epoch_{meta['epoch']}.npz"))

    if not background:
        write()
        return target

    def guarded():
        global _pending_error
        try:
            write()
        except BaseException as e:       # raised at the next join
            with _pending_lock:
                _pending_error = e

    global _pending_save
    t = threading.Thread(target=guarded, daemon=True, name="ckpt-write")
    with _pending_lock:
        _pending_save = t
    t.start()
    return target


def _resolve(path: str) -> str:
    return (os.path.join(path, "checkpoint.npz") if os.path.isdir(path)
            else path)


def peek_checkpoint_meta(path: str) -> Dict[str, Any]:
    """The JSON meta blob alone (model name, config, epoch, ...), without
    reading any array; {} for an archive without one. ``path``: a file or a
    run directory (its ``checkpoint.npz``)."""
    with np.load(_resolve(path), allow_pickle=False) as data:
        if "__meta__" not in data:
            return {}
        meta = json.loads(bytes(data["__meta__"]).decode())
    meta.pop("__extended_dtypes__", None)
    return meta


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint at ``path`` (a file, or a run directory's
    ``checkpoint.npz``), written by the port or by the JAX package: the meta
    entries, and ``params``, ``state`` and ``opt_state`` as nested dicts of
    numpy arrays (CPU torch tensors for bfloat16 leaves)."""
    with np.load(_resolve(path), allow_pickle=False) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})
        extended = meta.pop("__extended_dtypes__", {})
        flat: Dict[str, Dict[str, Any]] = {}
        for key in data.files:
            if key == "__meta__":
                continue
            arr = data[key]
            if key in extended:
                arr = _from_bits(arr, extended[key])
            root, rest = key.split(_SEP, 1)
            flat.setdefault(root, {})[rest] = arr
    ckpt = dict(meta)
    for root, leaves in flat.items():
        ckpt[root] = unflatten_tree(leaves)
    return ckpt


def _sorted_leaves(tree, prefix=()):
    """(path, leaf) in the order ``jax.flatten_util.ravel_pytree`` ravels a
    dict: keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _sorted_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unravel(flat, template):
    """The flat vector ``flat`` cut into ``template``'s leaves, in
    :func:`_sorted_leaves` order (a padded tail is dropped)."""
    flat = np.asarray(flat)
    out: Dict[str, Any] = {}
    offset = 0
    for path, leaf in _sorted_leaves(template):
        shape = tuple(np.shape(leaf))
        size = int(np.prod(shape, dtype=np.int64))
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = flat[offset:offset + size].reshape(shape)
        offset += size
    return out


def _ravel(tree, length):
    """``tree``'s leaves raveled in :func:`_sorted_leaves` order (the JAX
    package's ``ravel_pytree``), float32, zero-padded to ``length``."""
    flat = np.concatenate([np.asarray(
        leaf.float() if isinstance(leaf, torch.Tensor) else leaf,
        np.float32).reshape(-1) for _, leaf in _sorted_leaves(tree)])
    out = np.zeros(length, np.float32)
    out[:flat.shape[0]] = flat
    return out


def adapt_opt_state(loaded, template):
    """Fits a loaded optimizer state (a tree of the JAX package's layout) to
    ``template``, the current run's: slots the template has and the
    checkpoint lacks (the optimizer changed across the resume: SGD's ``mu``
    resumed into a regime that also needs Adam's ``m`` and ``v``) keep the
    template's fresh values, slots of the checkpoint the template lacks are
    dropped, each with a warning. A slot stored as one flat vector (ZeRO-1
    or the JAX package's ``--flat-optim``, padded to a multiple of the data
    degree) and the template's layout may differ, as they do when a run
    resumes at another world size or with ZeRO toggled: flat → tree cuts
    the vector into the template's per-tensor tree in ``ravel_pytree``
    order, tree → flat ravels the tree in that order and pads it to the
    template's length, flat → flat of another length keeps the common
    prefix and pads with zeros (the pad is zero by construction). Parameter
    trees are not handled here: a model that does not match fails when its
    weights load."""
    def fit(cur, old):
        if isinstance(cur, dict) and isinstance(old, dict):
            return {k: fit(v, old[k]) if k in old else v
                    for k, v in cur.items()}
        cur_flat = not isinstance(cur, dict) and np.ndim(cur) == 1
        old_flat = not isinstance(old, dict) and np.ndim(old) == 1
        if isinstance(cur, dict) and old_flat:             # flat → tree
            return _unravel(old, cur)
        if isinstance(old, dict) and cur_flat:             # tree → flat
            return _ravel(old, int(np.shape(cur)[0]))
        if old_flat and cur_flat and np.shape(old) != np.shape(cur):
            out = np.zeros(int(np.shape(cur)[0]), np.float32)
            m = min(out.shape[0], int(np.shape(old)[0]))
            out[:m] = np.asarray(old, np.float32)[:m]
            return out
        return old

    out = {}
    for key, cur in template.items():
        if key in loaded:
            out[key] = fit(cur, loaded[key])
        else:
            log.warning("opt_state slot %r absent from the checkpoint (the "
                        "optimizer changed?): keeping its fresh values", key)
            out[key] = cur
    for key in loaded:
        if key not in template:
            log.warning("dropping the checkpoint's opt_state slot %r, which "
                        "the current optimizer does not use", key)
    return out


def _param_names(model):
    """(name, JAX path, transpose to JAX's layout) of each parameter of
    ``model``, in ``named_parameters`` order."""
    bns = bn_modules(model.state_dict())
    out = []
    for name, p in model.named_parameters():
        tree, path, perm = jax_name(name, p.dim(), bns)
        assert tree == "params", name
        out.append((name, path, perm))
    return out


def slots_to_tree(model, values):
    """A per-parameter list (an optimizer slot, in ``named_parameters``
    order) → a nested dict keyed and transposed like the JAX package's
    ``params``, of host copies. Scalars (BoundedWeightNorm's ``norms``)
    keep their shape."""
    tree: Dict[str, Any] = {}
    for (_, path, perm), v in zip(_param_names(model), values, strict=True):
        if perm is not None and v.dim() == len(perm):
            v = v.permute(perm)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _host(v.contiguous())
    return tree


def tree_to_slots(model, tree, device=None):
    """The inverse of :func:`slots_to_tree`: float32 tensors on ``device``
    (the parameters' device by default), in ``named_parameters`` order."""
    out = []
    params = dict(model.named_parameters())
    for name, path, perm in _param_names(model):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        t = (leaf.float() if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.array(leaf, np.float32)))
        if perm is not None and t.dim() == len(perm):
            t = t.permute(tuple(np.argsort(perm))).contiguous()
        out.append(t.to(device or params[name].device))
    return out
