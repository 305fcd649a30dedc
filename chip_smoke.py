#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

Run from the repository root with one CUDA card, nvcc and nvidia-smi:

    python3 chip_smoke.py

Without a card, or without the ``convnet_tpu_torch`` package beside it, it
exits non-zero before printing any result. It imports nothing of JAX.

1. card: name and power limit; the CUDA kernels are built with nvcc.
2. kernels: every kernel is held against its plain PyTorch version on the
   card at each shape the ResNet-50 serving path gives it (batch 64 and 1,
   bf16 and float32) and at ragged shapes; kernel, plain version and the
   nearest library call are timed with CUDA events.
3. serve: ResNet-50 (full width, 224x224, bf16, weights drawn from a seed)
   answers requests of 64, 17 and 1 uint8 images. The launch counts are set
   to 0 just before and read just after; each kernel must have launched its
   share. The logits must be finite, unchanged by the padding rows, and agree
   with the port's plain float32 forward on the CPU. Then the card's
   serving throughput and batch-1 latency are timed.
4. summary: one ``{"kernels": [...]}`` line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero; a hang dumps every
thread's stack and exits after ``HANG_LIMIT_S``.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HANG_LIMIT_S = 240
SEED = 0
SERVE_BATCH = 64
REQUESTS = (64, 17, 1)            # images per request; each is one forward
RAGGED = [(49, 72, 40, "relu6"),  # N edge masked; K % 8 == 0: cp.async path
          (67, 60, 72, "relu"),   # K % 8 != 0: the scalar load path
          (130, 24, 136, "none")]
# H100 SXM (NVIDIA data sheet): HBM rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "float32": 67e12}  # float32: no tensor core
# kernel vs plain version, |err| <= tol * (1 + |ref|):
#   bf16: both sum the same exact bf16 products in float32 in another order;
#         the bf16 output may then round one ulp (2^-8 relative) apart.
#   float32: summation order only, over K <= 2048 unit-scale products.
KERNEL_TOL = {"bf16": 1e-2, "float32": 1e-4}
# served logits vs the port's float32 forward on the CPU, as a share of the
# reference's largest |logit|: bf16 rounds every layer's activations (about
# 2^-9 relative each, over 53 layers); the float32 forward on the card
# differs from the CPU's only in summation order (TF32 is off).
SERVE_TOL = {"bf16": 5e-2, "float32": 1e-3}
PAD_TOL = 1e-3  # the same rows in a batch of 64 padded or full

T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(m, k, n, dtype):
    """Least time (ms) for act(x @ w * scale + shift) at this shape: each
    input read once, the output written once, against the HBM rate; 2MKN
    operations against the dense peak. Returns (ms, "bytes" | "operations")."""
    e = 2 if dtype == "bf16" else 4
    bytes_ms = ((m * k + k * n + m * n) * e + 2 * n * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * k * n / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def path_shapes(torch, predictor, images):
    """(M, K, N, act) → launches per forward, for every ConvBN on the kernel
    route, read by hooks during one forward of ``images``."""
    from convnet_tpu_torch.models.resnet import ConvBN
    counts = {}

    def hook(mod, args):
        x = args[0]
        key = (x.numel() // x.shape[-1], x.shape[-1], mod.conv.out_channels,
               mod.act)
        counts[key] = counts.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook)
               for m in predictor.model.modules()
               if isinstance(m, ConvBN) and m.uses_kernel()]
    try:
        predictor.predict_logits(images)
    finally:
        for h in handles:
            h.remove()
    return counts


def check_matmul_fused(torch, shapes):
    """Phase 2 for conv1x1_bn_act: correctness at every path shape (batch
    64 and 1) and ragged shape, in bf16 and float32; times in bf16, the
    path's type. Returns per-forward totals at batch 64 for the summary."""
    from convnet_tpu_torch.ops.kernels import matmul_fused as mf
    dtypes = {"bf16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for (m, k, n, act), per_fwd in sorted(shapes.items()):
        per_image = m // SERVE_BATCH
        for batch in (SERVE_BATCH, 1):
            cases.append((per_image * batch, k, n, act, per_fwd, batch))
    cases += [(m, k, n, act, 0, None) for m, k, n, act in RAGGED]

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
             "bytes_bound_ms": 0.0, "max_abs_err": 0.0}
    failures = []
    for m, k, n, act, per_fwd, batch in cases:
        for dname, dtype in dtypes.items():
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(n, k, generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)         # (N, K): the OIHW weight
            scale = torch.rand(n, generator=gen, device="cuda") + 0.5
            shift = torch.randn(n, generator=gen, device="cuda") * 0.5
            out = mf.matmul_scale_act(x, w.t(), scale, shift, act)
            ref = mf.matmul_scale_act_plain(x, w.t(), scale, shift, act)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            tol = KERNEL_TOL[dname]
            ok = bool((diff <= tol * (1 + ref.float().abs())).all())
            rec = {"check": "conv1x1_bn_act", "dtype": dname, "batch": batch,
                   "M": m, "K": k, "N": n, "act": act,
                   "launches_per_forward": per_fwd, "max_abs_err": err,
                   "tol": tol, "ok": ok}
            if batch is not None:
                total["max_abs_err"] = max(total["max_abs_err"], err)
            if batch is not None and dname == "bf16":
                w_lib = (w.t().float() * scale).to(dtype)
                shift_lib = shift.to(dtype)
                rec["ms"] = cuda_ms(torch, lambda: mf.matmul_scale_act(
                    x, w.t(), scale, shift, act))
                rec["plain_ms"] = cuda_ms(
                    torch, lambda: mf.matmul_scale_act_plain(
                        x, w.t(), scale, shift, act))
                # the nearest single library call: no activation
                rec["library_ms"] = cuda_ms(
                    torch, lambda: torch.addmm(shift_lib, x, w_lib))
                rec["bound_ms"], rec["bound_by"] = bound(m, k, n, dname)
                if batch == SERVE_BATCH:
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        total[key] += per_fwd * rec[key]
                    if rec["bound_by"] == "bytes":
                        total["bytes_bound_ms"] += per_fwd * rec["bound_ms"]
            emit(rec)
            if not ok:
                failures.append(rec)
    if failures:
        raise RuntimeError(f"conv1x1_bn_act disagrees with its plain version "
                           f"in {len(failures)} case(s)")
    return total


def rel_err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def main():
    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from convnet_tpu_torch.ops.kernels import _build
    from convnet_tpu_torch.ops.kernels import matmul_fused as mf
    from convnet_tpu_torch.serve import Predictor
    # full float32 in matmuls and convs: the float32 checks compare exactly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and build
    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    lib, build_log = _build.build("matmul_fused")
    log(f"built {lib.name} in {time.perf_counter() - t:.1f}s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 2. the model, the path's shapes, and the kernel checks
    config = {"depth": 50}
    predictor = Predictor("resnet", config, dtype="bf16",
                          batch_size=SERVE_BATCH, seed=SEED)
    size = predictor.input_size
    images = np.random.default_rng(SEED).integers(
        0, 256, (SERVE_BATCH, size, size, 3), np.uint8)
    shapes = path_shapes(torch, predictor, images)
    per_forward = sum(shapes.values())
    log(f"ResNet-50 {size}x{size}: {per_forward} kernel-route ConvBNs per "
        f"forward over {len(shapes)} distinct (M, K, N, act)")
    if per_forward != 33:
        raise RuntimeError(f"expected 33 kernel-route ConvBNs, found "
                           f"{per_forward}")
    total = check_matmul_fused(torch, shapes)
    log("conv1x1_bn_act agrees with its plain version at every shape")

    # -- 3. serve: the main path, counted
    mf.launches = 0
    t = time.perf_counter()
    logits = [predictor.predict_logits(images[:n]) for n in REQUESTS]
    serve_s = time.perf_counter() - t
    launches = mf.launches
    expected = per_forward * len(REQUESTS)
    log(f"served {REQUESTS} images in {serve_s:.3f}s; conv1x1_bn_act "
        f"launched {launches} times (expected {expected})")
    if launches != expected:
        raise RuntimeError(f"conv1x1_bn_act launched {launches} times on the "
                           f"main path, expected {expected}")
    for n, out in zip(REQUESTS, logits):
        if out.shape != (n, 1000) or not np.isfinite(out).all():
            raise RuntimeError(f"bad logits for a request of {n}: shape "
                               f"{out.shape}, finite {np.isfinite(out).all()}")
    for n, out in zip(REQUESTS[1:], logits[1:]):
        diff = float(np.abs(out - logits[0][:n]).max())
        log(f"request of {n}: max |padded - full-batch| logit diff {diff:.3g}")
        if diff > PAD_TOL:
            raise RuntimeError(f"padding changed the answers: {diff}")

    ref_n = 2
    cpu_ref = Predictor("resnet", config, dtype="float32", batch_size=ref_n,
                        device="cpu", seed=SEED).predict_logits(images[:ref_n])
    card_f32 = Predictor("resnet", config, dtype="float32", batch_size=ref_n,
                         seed=SEED).predict_logits(images[:ref_n])
    for dname, out in (("bf16", logits[0][:ref_n]), ("float32", card_f32)):
        err = rel_err(out, cpu_ref)
        log(f"card {dname} logits vs CPU float32 forward: max |diff| / "
            f"max |ref| = {err:.3g} (tolerance {SERVE_TOL[dname]})")
        if err > SERVE_TOL[dname]:
            raise RuntimeError(f"{dname} logits disagree with the CPU "
                               f"reference: {err}")

    times = []
    for _ in range(20):
        t = time.perf_counter()
        predictor.predict_logits(images)
        times.append(time.perf_counter() - t)
    p50 = statistics.median(times)
    single = Predictor("resnet", config, dtype="bf16", batch_size=1,
                       seed=SEED)
    one = images[:1]
    for _ in range(3):
        single.predict_logits(one)
    lat = []
    for _ in range(50):
        t = time.perf_counter()
        single.predict_logits(one)
        lat.append(time.perf_counter() - t)
    emit({"serve": "resnet50_bf16_224", "card": card,
          "batch64_p50_ms": p50 * 1e3,
          "images_per_s": SERVE_BATCH / p50,
          "batch1_p50_ms": statistics.median(lat) * 1e3,
          "note": "host clock around predict_logits, H2D and D2H included"})

    # -- 4. summary
    emit({"kernels": [{
        "name": "conv1x1_bn_act",
        "route": "cuda",
        "source": "convnet_tpu_torch/csrc/matmul_fused.cu",
        "replaces": "convnet_tpu/ops/pallas/matmul_fused.py:50",
        "launches": launches,
        "max_abs_err": total["max_abs_err"],
        "ms": total["ms"],
        "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_bound_ms"] * 2 >= total["bound_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
        "library_call": "torch.addmm(shift, x, w * scale), no activation",
        "times_are": f"sum over the {per_forward} launches of one batch-"
                     f"{SERVE_BATCH} bf16 forward",
    }]})
    faulthandler.cancel_dump_traceback_later()
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
