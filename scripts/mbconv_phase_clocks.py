#!/usr/bin/env python3
"""Where the tensor-core MBConv kernel's time goes, phase by phase, on the
card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 scripts/mbconv_phase_clocks.py

It copies ``convnet_tpu_torch/csrc/mbconv.cu``, adds ``clock64()`` marks at
the phase boundaries of ``mbconv_tc`` (thread 0 of each block: the time
since the last mark goes to the phase that ends there; the sums are added
to a device array when the block exits), builds the copy with the
package's nvcc flags into the ignored ``convnet_tpu_torch/_build/``, and
runs the bf16 Full and Stats modes at four MobileNet-V2 block shapes at
batch 64 through the port's own wrapper code (``ops/kernels/mbconv.py``,
its plan and packed weights). Per shape it prints the device ms of one call
(CUDA events over five) and the clock cycles a block spends per chunk of 32
hidden channels in each phase:

- project+epilogue: the project's mma and, at an item's end, the epilogue
  and the next item's start;
- S1 wait+barrier: waiting for the chunk's staged weights, and the block;
- expand+barrier: the expand (or the copy of x) into u1, and the block;
- stage issue: issuing the next chunk's and the next item's copies;
- depthwise: the 9 taps and BN2 into u2 (or the sums);
- S3 wait+barrier: waiting for the project's weights, and the block.

A block's phase time is its warps' instructions at the issue rate they get
from the SM's four schedulers, shared with the other resident block, plus
what they wait for. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from convnet_tpu_torch.ops.kernels import _build  # noqa: E402
from convnet_tpu_torch.ops.kernels import mbconv as mb  # noqa: E402

PHASES = ("project+epilogue", "S1 wait+barrier", "expand+barrier",
          "stage issue", "depthwise", "S3 wait+barrier")
# (B, H, W, Cin, hidden, Cout, expand, residual)
SHAPES = [(64, 112, 112, 32, 32, 16, False, False),
          (64, 56, 56, 24, 144, 24, True, True),
          (64, 14, 14, 96, 576, 96, True, True),
          (64, 7, 7, 160, 960, 160, True, True)]
# (text of mbconv_tc, what it becomes): the marks around each phase
MARKS = [
    ("  int u = blockIdx.x;\n  if (u < g.items) {\n",
     "  long long prof_acc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long prof_t = clock64();\n"
     "  int u = blockIdx.x;\n  if (u < g.items) {\n"),
    ("      if (kc == k0)\n        cp_async_wait<0>();",
     "      MARK(0);\n      if (kc == k0)\n        cp_async_wait<0>();"),
    ("      __syncthreads();  // ... and every warp is past the last project\n",
     "      __syncthreads();  // ... and every warp is past the last project\n"
     "      MARK(1);\n"),
    ("      __syncthreads();\n      {  // the next chunk's expand weights",
     "      __syncthreads();\n      MARK(2);\n"
     "      {  // the next chunk's expand weights"),
    ("      cp_async_commit();  // C\n",
     "      cp_async_commit();  // C\n      MARK(3);\n"),
    ("        cp_async_wait<2>();  // the project weights (A; B and C may fly "
     "on)\n        __syncthreads();\n",
     "        MARK(4);\n"
     "        cp_async_wait<2>();  // the project weights (A; B and C may fly "
     "on)\n        __syncthreads();\n        MARK(5);\n"),
    ("  cp_async_wait<0>();\n}\n",
     "  cp_async_wait<0>();\n  MARK(0);\n  if (threadIdx.x == 0)\n"
     "    for (int i = 0; i < 6; ++i)\n"
     "      atomicAdd(&g_clocks[i], (unsigned long long)prof_acc[i]);\n}\n"),
]


def instrumented_source():
    """csrc/mbconv.cu with the marks; fails if a marked text has moved."""
    src = (REPO / "convnet_tpu_torch/csrc/mbconv.cu").read_text()
    head = ("__device__ unsigned long long g_clocks[6];\n"
            "#define MARK(i) do { long long n_ = clock64(); "
            "prof_acc[i] += n_ - prof_t; prof_t = n_; } while (0)\n")
    src = src.replace("namespace {", head + "namespace {", 1)
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"not found once in mbconv.cu: {old!r}")
        src = src.replace(old, new)
    src += ("\nextern \"C\" int ctt_clocks(unsigned long long* out, "
            "int reset) {\n"
            "  if (reset) {\n    unsigned long long z[6] = {};\n"
            "    return (int)cudaMemcpyToSymbol(g_clocks, z, sizeof(z));\n  }\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_clocks, "
            "6 * sizeof(unsigned long long));\n}\n")
    return src


def build():
    """Builds the instrumented copy; returns the loaded library and the
    kernel table ``mbconv._kernels`` would return."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mbconv_phase_clocks.cu"
    lib_path = _build.BUILD_DIR / "libmbconv_phase_clocks.so"
    src.write_text(instrumented_source())
    nvcc = _build._nvcc()
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True,
                   timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    table = {"full": lib.ctt_mbconv_full, "stats": lib.ctt_mbconv_stats,
             "raw": lib.ctt_mbconv_raw, "variant": lib.ctt_mbconv_variant}
    table["full"].argtypes = [p] * 12 + [i] * 13 + [p]
    table["stats"].argtypes = [p] * 7 + [i] * 10 + [p]
    table["raw"].argtypes = [p] * 12 + [i] * 11 + [p]
    table["variant"].argtypes = [i] * 6 + [p]
    lib.ctt_clocks.argtypes = [p, i]
    for fn in (*table.values(), lib.ctt_clocks):
        fn.restype = ctypes.c_int
    return lib, table


def main():
    if not torch.cuda.is_available():
        print("mbconv_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    t = time.perf_counter()
    lib, table = build()
    print(f"built the instrumented copy in {time.perf_counter() - t:.1f}s",
          flush=True)
    mb._kernels = lambda: table
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    sums = (ctypes.c_ulonglong * 6)()
    calls = 5
    for shape in SHAPES:
        b, h, w, cin, ch, cout, expand, residual = shape
        args = chip_smoke.mbconv_inputs(torch, gen, b, h, w, cin, ch, cout,
                                        expand, torch.bfloat16)
        for mode in ("full", "stats"):
            head = args if mode == "full" else args[:5]
            kw = {"residual": residual} if mode == "full" else {}
            tensors, run = mb.kernel_args(*head, mode=mode)
            if run.kind != "tensor_cores":
                raise RuntimeError(f"{shape} {mode}: {run.kind}")
            outs = mb.outputs(mode, args[0], ch, cout, run)
            mb.call(mode, tensors, run, outs, **kw)
            torch.cuda.synchronize()
            lib.ctt_clocks(None, 1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                mb.call(mode, tensors, run, outs, **kw)
            end.record()
            end.synchronize()
            lib.ctt_clocks(ctypes.cast(sums, ctypes.c_void_p), 0)
            parts = 1 if mode == "stats" else -(-cout // mb.cout_block(cout))
            steps = run.tiles * -(-ch // mb.TC_CHUNK) * parts * calls
            per = {name: round(sums[k] / steps)
                   for k, name in enumerate(PHASES)}
            print(mode, shape, f"tile {run.tile} split {run.split}",
                  f"{start.elapsed_time(end) / calls:.4f} ms",
                  "clocks a block spends per chunk:", per,
                  "total", sum(per.values()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
