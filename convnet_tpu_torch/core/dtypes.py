"""Dtype policy for mixed precision (counterpart of convnet_tpu/core/dtypes.py).

``compute_dtype`` is the dtype activations and matmuls run in (bf16 for
serving). Parameters and BatchNorm running statistics are always float32,
whatever the policy. Each layer casts its parameters to the activations' dtype
at use, so the policy acts where the input enters the model
(``cast_to_compute``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x):
        return x.to(self.compute_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)

_NAMED = {
    "float32": DEFAULT_POLICY,
    "fp32": DEFAULT_POLICY,
    "bfloat16": BF16_POLICY,
    "bf16": BF16_POLICY,
    "half": BF16_POLICY,
}


def get_policy(name) -> Policy:
    """Resolve a policy by name, as the JAX package does (float16 has no
    kernel on the card yet, so it is not offered)."""
    if isinstance(name, Policy):
        return name
    try:
        return _NAMED[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown dtype policy {name!r}; choose from {sorted(_NAMED)}"
        ) from None
