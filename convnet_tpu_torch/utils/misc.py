"""Small utilities (counterpart of convnet_tpu/utils/misc.py).

``enable_compile_cache`` (XLA's persistent compilation cache) has no
counterpart here, and ``onehot`` lives in ``train/losses.py``.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_global_seeds(seed: int) -> torch.Generator:
    """Seeds Python's ``random``, numpy's global generator and torch's (CPU
    and every CUDA device); returns a CPU ``torch.Generator`` seeded with
    ``seed``, the counterpart of the JAX package's PRNG key. The port's own
    draws take explicit generators; the global seeds are for other code."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
