"""Activation checkpointing (remat) of one block (counterpart of
convnet_tpu/nn/checkpoint.py:17-30).

``CheckpointModule(block)`` keeps only the block's input for the backward
and recomputes the block's forward there
(``torch.utils.checkpoint.checkpoint``, non-reentrant). The child is named
``module``, as in the JAX package's parameter tree
(``layers/layer1/0/module/cb1/...``), so ``from_jax_params`` carries remat
weights unchanged.

Two kinds of state must not see the recompute twice:

- BatchNorm running statistics. The port's ``BatchNorm2d`` updates them in
  place in its training forward; a recompute would move them by the
  momentum a second time. While the recompute runs, every ``BatchNorm2d``
  of the block has ``update_stats`` off, so the step ends with the buffers
  the first forward left (``jax.checkpoint`` returns the new state once).
- Explicit generators (``Dropout.generator``). The recompute draws from
  each generator's state at the first forward, then puts back the state it
  found, so its masks are the first forward's and the stream moves once.

In eval, or where autograd records nothing, the block runs directly, so an
eval remat model keeps its kernel routes (``ConvBN.uses_kernel``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from convnet_tpu_torch.nn.layers import BatchNorm2d


class CheckpointModule(nn.Module):
    def __init__(self, module: nn.Module, policy=None):
        """``policy``: the JAX package passes a ``jax.checkpoint`` policy
        (which intermediates to save). ``torch.utils.checkpoint`` has no
        such policy here, so anything but None raises."""
        super().__init__()
        if policy is not None:
            raise ValueError("CheckpointModule: remat policies are JAX's "
                             "jax.checkpoint_policies; the port recomputes "
                             "the whole block (policy=None)")
        self.module = module

    def _generators(self):
        gens = {}
        for m in self.module.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator):
                gens[id(g)] = g
        return list(gens.values())

    def forward(self, x):
        if not (self.training and torch.is_grad_enabled()):
            return self.module(x)
        gens = self._generators()
        first = [g.get_state() for g in gens]
        calls = []

        def run(x):
            calls.append(None)
            if len(calls) == 1:
                return self.module(x)
            return self._recompute(x, gens, first)

        return checkpoint(run, x, use_reentrant=False)

    def _recompute(self, x, gens, first):
        bns = [m for m in self.module.modules()
               if isinstance(m, BatchNorm2d)]
        found = [g.get_state() for g in gens]
        for bn in bns:
            bn.update_stats = False
        for g, s in zip(gens, first):
            g.set_state(s)
        try:
            return self.module(x)
        finally:
            for bn in bns:
                bn.update_stats = True
            for g, s in zip(gens, found):
                g.set_state(s)
