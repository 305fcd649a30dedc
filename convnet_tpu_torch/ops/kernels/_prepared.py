"""Kernel-layout tensors made once per weight version.

A kernel wrapper that needs its weight in another layout or type (the
grouped conv's packed tiles, the fused 1x1's bf16 (N, K) weight) or a
module that folds parameters (``ConvBN``'s BatchNorm) asks :func:`get` for
it. The value is made once and handed back until one of its source tensors
is freed, replaced by another tensor, or changed in place (an optimizer
step, ``load_state_dict``, a running-statistics update: each bumps the
tensor's version counter). A view of a parameter is keyed by the parameter
itself and the view's geometry, so the view a wrapper takes afresh on every
call still finds the entry.

Where autograd is recording and a source requires grad, nothing is cached:
the value is made afresh, with its graph, as before. Cached values are made
outside inference mode and without grad, so they are plain tensors that any
later call may read. While ``torch.export`` traces, nothing is cached either:
the value is made in the traced graph from the tensors it traces.
"""

from __future__ import annotations

import functools
import weakref

import torch

_CACHE = {}   # key → (weak references to the sources' bases, versions, value)


def get(tag, sources, make):
    """``make(*sources)``, computed once per version of ``sources``. ``tag``
    names what is made (and anything else it depends on, such as a type)."""
    if torch.compiler.is_compiling():
        return make(*sources)
    grad = torch.is_grad_enabled()
    bases, key, versions = [], [tag], []
    for t in sources:
        if t.is_inference() or (grad and t.requires_grad):
            return make(*sources)
        b = t._base if t._base is not None else t
        bases.append(b)
        key.append((id(b), t.storage_offset(), t.shape, t.stride()))
        versions.append(t._version)
    key, versions = tuple(key), tuple(versions)
    hit = _CACHE.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is b for r, b in zip(hit[0], bases)):
        return hit[2]
    with torch.inference_mode(False), torch.no_grad():
        value = make(*sources)
    drop = functools.partial(_drop, key)
    _CACHE[key] = (tuple(weakref.ref(b, drop) for b in bases), versions,
                   value)
    return value


def _drop(key, ref):
    """A source was freed: its entry goes (unless the key now holds a newer
    entry, made for a tensor that took the freed one's id)."""
    hit = _CACHE.get(key)
    if hit is not None and any(r is ref for r in hit[0]):
        del _CACHE[key]


def clear():
    """Drops every cached value."""
    _CACHE.clear()
