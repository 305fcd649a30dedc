#!/usr/bin/env python3
"""The int8 1x1 wrapper's host time a call, for one or more checkouts of the
repository, on one CUDA card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 scripts/int8_host_cost.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into an ignored directory). For each, in the
order given, a fresh Python process imports that checkout's
``convnet_tpu_torch`` (its int8 kernel is built into the checkout's own
``convnet_tpu_torch/_build/``) and times its ``matmul_int8`` wrapper with
``chip_smoke.int8_host_costs`` of this checkout: the host clock around 200
back-to-back calls at ResNet-50's last 1x1 of a batch-1 forward (49x512x2048
in bf16, a kernel shorter than the host's work), closed by a synchronise,
``REPEATS`` times. Give the roots as A B B A to compare two of them on the
same card. It prints a line a root and then one JSON line with every
repeat. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPEATS = 7


def one(root: Path) -> list[float]:
    """Times ``root``'s wrapper in this process: ``REPEATS`` values, µs."""
    sys.path.insert(0, str(root))
    import torch
    from convnet_tpu_torch.ops.kernels import matmul_int8 as mi
    if Path(mi.__file__).resolve().parents[3] != root:
        raise RuntimeError(f"imported {mi.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [smoke.int8_host_costs(torch, mi, gen)["wrapper_us"]
            for _ in range(REPEATS)]


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True, cwd=HERE)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        us = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root, "wrapper_us": us,
                     "median_us": statistics.median(us)})
        print(f"{root}: {statistics.median(us):.1f} us a call (median of "
              f"{len(us)}; {min(us):.1f}-{max(us):.1f})", flush=True)
    print(json.dumps({"int8_wrapper_host": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
