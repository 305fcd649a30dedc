#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check its kernels.

Run from the repository root with one CUDA card, nvcc and nvidia-smi:

    python3 chip_smoke.py

Without a card, or without the ``convnet_tpu_torch`` package beside it, it
exits non-zero before printing any result. It imports nothing of JAX.

1. card: name and power limit; the CUDA kernels are built with nvcc, one
   process per source, all started together.
2. kernels: every kernel is held against its plain PyTorch version on the
   card at each shape the ResNet-50 paths give it (serving: batch 64 and 1;
   the stem pool: batch 128 and 1; bf16 and float32) and at ragged shapes,
   with inputs drawn from a handful of values so that the pool's ties are
   common; kernel, plain version and the nearest library call are timed
   with CUDA events.
3. serve: ResNet-50 (full width, 224x224, bf16, weights drawn from a seed)
   answers requests of 64, 17 and 1 uint8 images. The launch counts are set
   to 0 just before and read just after; each kernel must have launched its
   share. The logits must be finite, unchanged by the padding rows, and agree
   with the port's plain float32 forward on the CPU. Then the card's
   serving throughput and batch-1 latency are timed.
4. train: the same ResNet-50 in the port's ``Trainer`` with its "normal"
   regime. One float32 step on the card (TF32 off) against the same step on
   the CPU; then 20 bf16 steps at batch 128 on one random batch, counted
   and timed; two more under torch.profiler, whose device time is broken
   down by kernel; and one ``validate``, counted.
5. summary: one ``{"kernels": [...]}`` line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero; a hang dumps every
thread's stack and exits after ``HANG_LIMIT_S``.
"""

from __future__ import annotations

import concurrent.futures
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
KERNELS = ("matmul_fused", "max_pool")   # csrc/<name>.cu
TRAIN_BATCH = 128     # bf16 steps; BN keeps float32 copies for its backward
TRAIN_STEPS = 20
CHECK_BATCH = 4       # the float32 step held against the CPU
STEM_POOL = ((112, 112, 64), 3, 2, 1)    # (H, W, C), kernel, stride, padding
POOL_RAGGED = [((2, 15, 13, 3), 3, 2, 1),   # odd H, W; C = 3: scalar path
               ((2, 8, 8, 5), 2, 2, 0),     # non-overlapping windows
               ((2, 9, 9, 17), 3, 1, 1)]    # stride 1: 9 windows a pixel
# pool kernels vs plain versions: index and y exact (both pick the same
# element); dx exact in float32 (the same float32 additions in the same
# order), and in bf16 within 1e-2 relative-plus-absolute
POOL_DX_TOL = {"bf16": 1e-2, "float32": 0.0}
# the float32 step on the card vs the CPU (TF32 off): cuDNN and the CPU sum
# convolutions in other orders. The loss and the BN statistics come from the
# forward and agree closely. The updates do not: at initialisation the
# float32 gradient of the deep layers is itself uncertain at the percent
# level (the CPU's float32 step against the same step in float64: updates
# 2.2% apart in norm overall, 2.6% in the worst tensor), so the updates are
# held in norm, overall and per tensor, at about twice that.
STEP_TOL = {"loss": 1e-4, "stats": 1e-4, "update_norm": 5e-2,
            "update_norm_per_tensor": 1e-1}

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


def pool_bound(shape, k, s, p, dname, idx):
    """Least time (ms) of the pool forward and backward at this shape, each
    (ms, "bytes" | "operations"). Forward: read x, write y and the uint8
    index; k*k compares per output. Backward: read dy and the index, write
    dx; k*k index compares per output and one add per routed dy (this
    run's ``idx`` routes every dy once)."""
    b, h, w, c = shape
    e = 2 if dname == "bf16" else 4
    n_x = b * h * w * c
    n_y = idx.numel()
    fwd = ((n_x * e + n_y * e + n_y) / HBM_BYTES_PER_S * 1e3,
           n_y * k * k / PEAK_OPS_PER_S["float32"] * 1e3)
    bwd = ((n_y + n_y * e + n_x * e) / HBM_BYTES_PER_S * 1e3,
           (n_y * k * k + n_y) / PEAK_OPS_PER_S["float32"] * 1e3)
    return [(max(t), "bytes" if t[0] >= t[1] else "operations")
            for t in (fwd, bwd)]


def check_max_pool(torch):
    """Phase 2 for the pool kernels: correctness at the stem's shape (batch
    128 and 1) and the ragged shapes, bf16 and float32, normal and tie-heavy
    inputs; times at the stem at batch 128 in bf16, the training step's
    shape and type. Returns {kernel name: summary}."""
    import torch.nn.functional as F
    from convnet_tpu_torch.ops.kernels import max_pool as mp
    dtypes = {"bf16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    (h, w, c), k, s, p = STEM_POOL
    cases = [((b, h, w, c), k, s, p, b) for b in (TRAIN_BATCH, 1)]
    cases += [(shape, k_, s_, p_, None) for shape, k_, s_, p_ in POOL_RAGGED]
    out = {name: {"max_abs_err": 0.0} for name in ("max_pool2d_fwd_idx",
                                                   "max_pool2d_bwd")}
    failures = []
    for shape, k_, s_, p_, batch in cases:
        for dname, dtype in dtypes.items():
            for inputs in ("normal", "ties"):
                if inputs == "ties":
                    x = torch.randint(-3, 4, shape, generator=gen,
                                      device="cuda").to(dtype)
                else:
                    x = torch.randn(shape, generator=gen,
                                    device="cuda").to(dtype)
                y, idx = mp.max_pool2d_fwd_idx(x, k_, s_, p_)
                y_eval, no_idx = mp.max_pool2d_fwd_idx(x, k_, s_, p_,
                                                       with_index=False)
                y_ref, idx_ref = mp.max_pool2d_fwd_idx_plain(x, k_, s_, p_)
                dy = torch.randn(y.shape, generator=gen,
                                 device="cuda").to(dtype)
                dx = mp.max_pool2d_bwd(dy, idx, shape, k_, s_, p_)
                dx_ref = mp.max_pool2d_bwd_plain(dy, idx_ref, shape, k_, s_,
                                                 p_)
                torch.cuda.synchronize()
                y_err = (y.float() - y_ref.float()).abs().max().item()
                diff = (dx.float() - dx_ref.float()).abs()
                dx_err = diff.max().item()
                tol = POOL_DX_TOL[dname]
                rec = {"check": "max_pool", "dtype": dname, "batch": batch,
                       "shape": list(shape), "k": k_, "s": s_, "p": p_,
                       "inputs": inputs,
                       "idx_equal": bool(torch.equal(idx, idx_ref)),
                       "y_equal": bool(torch.equal(y, y_ref)
                                       and torch.equal(y_eval, y_ref)
                                       and no_idx is None),
                       "dx_max_abs_err": dx_err, "dx_tol": tol,
                       "dx_ok": bool((diff <= tol * (1 + dx_ref.float()
                                                     .abs())).all())}
                if batch is not None:
                    fwd, bwd = out["max_pool2d_fwd_idx"], out["max_pool2d_bwd"]
                    fwd["max_abs_err"] = max(fwd["max_abs_err"], y_err)
                    bwd["max_abs_err"] = max(bwd["max_abs_err"], dx_err)
                if batch == TRAIN_BATCH and dname == "bf16" \
                        and inputs == "normal":
                    rec.update(time_pool(torch, F, mp, x, dy, idx, k_, s_,
                                         p_))
                    for name, (ms, by) in zip(
                            ("max_pool2d_fwd_idx", "max_pool2d_bwd"),
                            pool_bound(shape, k_, s_, p_, dname, idx)):
                        out[name].update(ms=rec[f"{name}_ms"],
                                         plain_ms=rec[f"{name}_plain_ms"],
                                         library_ms=rec[f"{name}_library_ms"],
                                         bound_ms=ms, bound_by=by)
                emit(rec)
                if not (rec["idx_equal"] and rec["y_equal"] and rec["dx_ok"]):
                    failures.append(rec)
    if failures:
        raise RuntimeError(f"the pool kernels disagree with their plain "
                           f"versions in {len(failures)} case(s)")
    return out


def time_pool(torch, F, mp, x, dy, idx, k, s, p):
    """Device ms per call of each pool kernel, its plain version and the
    library's channels-last max pool (timed only, never used by the port)."""
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, lib_idx = F.max_pool2d(x_nchw, k, s, p, return_indices=True)
    lib_bwd = torch.ops.aten.max_pool2d_with_indices_backward
    return {
        "max_pool2d_fwd_idx_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_fwd_idx(x, k, s, p)),
        "max_pool2d_fwd_idx_plain_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_fwd_idx_plain(x, k, s, p)),
        "max_pool2d_fwd_idx_library_ms": cuda_ms(
            torch, lambda: F.max_pool2d(x_nchw, k, s, p,
                                        return_indices=True)),
        "max_pool2d_bwd_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_bwd(dy, idx, x.shape, k, s, p)),
        "max_pool2d_bwd_plain_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_bwd_plain(dy, idx, x.shape, k, s,
                                                   p)),
        "max_pool2d_bwd_library_ms": cuda_ms(
            torch, lambda: lib_bwd(dy_nchw, x_nchw, [k, k], [s, s], [p, p],
                                   [1, 1], False, lib_idx)),
    }


def reset_counts(mf, mp):
    mf.launches = mp.fwd_launches = mp.bwd_launches = 0


def counts(mf, mp):
    return {"conv1x1_bn_act": mf.launches,
            "max_pool2d_fwd_idx": mp.fwd_launches,
            "max_pool2d_bwd": mp.bwd_launches}


def expect_counts(what, got, want):
    log(f"{what}: launches {got}")
    if got != want:
        raise RuntimeError(f"{what}: kernel launches {got}, expected {want}")


def make_trainer(torch, dtype, device):
    from convnet_tpu_torch import models
    from convnet_tpu_torch.regimes.optim import OptimRegime
    from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
    model = models.build("resnet", depth=50)
    tr = Trainer(model, OptimRegime(model.regime), 1000,
                 TrainerConfig(dtype=dtype), device=device, seed=SEED)
    tr.initialize()
    return tr


def check_step_against_cpu(torch):
    """Phase 4a: one float32 step on the card and on the CPU from the same
    weights (seed) and batch."""
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((CHECK_BATCH, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, CHECK_BATCH)
    res = {}
    for where in ("cpu", None):
        tr = make_trainer(torch, "float32", where)
        p0 = {n: q.detach().cpu().clone()
              for n, q in tr.model.named_parameters()}
        loss = float(tr.train_step(x, y)["loss"])
        upd = {n: q.detach().cpu() - p0[n]
               for n, q in tr.model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in tr.model.named_buffers()}
        res[where or "cuda"] = (loss, upd, stats, p0)
        del tr
    (l_cpu, u_cpu, s_cpu, p0_cpu), (l_gpu, u_gpu, s_gpu, p0_gpu) = (
        res["cpu"], res["cuda"])
    if any(not torch.equal(p0_cpu[n], p0_gpu[n]) for n in p0_cpu):
        raise RuntimeError("the card and the CPU drew different weights")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    per_tensor = {n: ((u_gpu[n] - u_cpu[n]).norm()
                      / (u_cpu[n].norm() + 1e-30)).item() for n in u_cpu}
    total = (sum((u_gpu[n] - u_cpu[n]).square().sum() for n in u_cpu)
             / sum(u_cpu[n].square().sum() for n in u_cpu)).sqrt().item()
    # reported, not checked: the largest element error over its tensor's
    # largest update
    elem = max((u_gpu[n] - u_cpu[n]).abs().max().item()
               / (u_cpu[n].abs().max().item() + 1e-30) for n in u_cpu)
    worst = max(per_tensor, key=per_tensor.get)
    stat_err = max(((s_gpu[n] - s_cpu[n]).abs()
                    / (1 + s_cpu[n].abs())).max().item() for n in s_cpu)
    rec = {"check": "train_step_card_vs_cpu", "dtype": "float32",
           "batch": CHECK_BATCH, "loss_cpu": l_cpu, "loss_card": l_gpu,
           "loss_rel_err": loss_err, "update_norm_rel_err": total,
           "update_worst_tensor": worst,
           "update_worst_tensor_norm_rel_err": per_tensor[worst],
           "update_max_elem_err_over_max": elem,
           "stats_max_err": stat_err, "tol": STEP_TOL}
    emit(rec)
    if (loss_err > STEP_TOL["loss"] or stat_err > STEP_TOL["stats"]
            or total > STEP_TOL["update_norm"]
            or per_tensor[worst] > STEP_TOL["update_norm_per_tensor"]):
        raise RuntimeError("the float32 step on the card disagrees with the "
                           "CPU's")


# kernel name → share of the step, first match wins
KERNEL_GROUPS = (("pool kernels", ("max_pool2d_",)),
                 ("convolutions", ("conv", "xmma", "gemm", "cutlass", "sm90",
                                   "dgrad", "wgrad", "cudnn")),
                 ("reductions", ("reduce_kernel",)),
                 ("copies and casts", ("copy", "Memcpy", "Memset")),
                 ("other elementwise", ("",)))


def profile_step(torch, tr, x, y, card, step_ms, steps=2):
    """Phase 4f: device time of a bf16 training step by kernel, from
    torch.profiler (CUDA activity only) over ``steps`` steps; the idle
    share is against ``step_ms``, the unprofiled step's p50 (the profiler's
    own start-up would swamp the profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            float(tr.train_step(x, y)["loss"])
    kernels = [(e.key, e.self_device_time_total / steps / 1e3,
                e.count / steps) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    for key, ms, _ in kernels:
        for name, needles in KERNEL_GROUPS:
            if any(n in key for n in needles):
                groups[name] += ms
                break
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit({"profile": "resnet50_bf16_224_train_step", "card": card,
          "batch": TRAIN_BATCH, "step_p50_ms": step_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / step_ms),
          "kernel_launches": sum(c for _, _, c in kernels),
          "ms_by_group": groups,
          "top_kernels": [{"name": k[:120], "ms": ms, "launches": c}
                          for k, ms, c in top]})


def train(torch, card, mf, mp):
    """Phase 4b-e: bf16 steps at TRAIN_BATCH, counted and timed; validate,
    counted. Returns the path's launch counts."""
    tr = make_trainer(torch, "bf16", None)
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counts(mf, mp)
    for i in range(TRAIN_STEPS):
        before = counts(mf, mp)
        t = time.perf_counter()
        m = tr.train_step(x, y)
        loss = float(m["loss"])          # waits for the step
        times.append(time.perf_counter() - t)
        losses.append(loss)
        step_counts = {k: v - before[k] for k, v in counts(mf, mp).items()}
        if i == 0:
            expect_counts("one bf16 training step", step_counts,
                          {"conv1x1_bn_act": 0, "max_pool2d_fwd_idx": 1,
                           "max_pool2d_bwd": 1})
        if step_counts != {"conv1x1_bn_act": 0, "max_pool2d_fwd_idx": 1,
                           "max_pool2d_bwd": 1}:
            raise RuntimeError(f"step {i}: launches {step_counts}")
    peak = torch.cuda.max_memory_allocated()
    train_counts = counts(mf, mp)
    log(f"bf16 losses over {TRAIN_STEPS} steps at batch {TRAIN_BATCH}: "
        + " ".join(f"{v:.4f}" for v in losses))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    # At the "normal" regime's lr 0.1 and momentum 0.9 the loss on one batch
    # falls for a few steps and then swings (the JAX trainer does the same on
    # a full-width ResNet-50 at 96x96 and batch 32 on the CPU); so the check
    # is that it falls below the first step's somewhere, and the mean of the
    # last five is reported beside it.
    if not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"the loss never fell below the first step's "
                           f"{losses[0]}: {losses}")
    p50 = statistics.median(times[1:])
    emit({"train": "resnet50_bf16_224", "card": card, "batch": TRAIN_BATCH,
          "steps": TRAIN_STEPS, "losses": losses,
          "last5_mean_loss": float(np.mean(losses[-5:])),
          "step_p50_ms": p50 * 1e3, "images_per_s": TRAIN_BATCH / p50,
          "max_memory_allocated_bytes": peak,
          "note": "host clock around train_step, which ends with a read of "
                  "the loss; p50 over steps 2-20"})

    profile_step(torch, tr, x, y, card, p50 * 1e3)

    reset_counts(mf, mp)
    val = tr.validate([(x, y)])
    val_counts = counts(mf, mp)
    expect_counts("validate, one batch", val_counts,
                  {"conv1x1_bn_act": 33, "max_pool2d_fwd_idx": 1,
                   "max_pool2d_bwd": 0})
    if not np.isfinite(val["loss"]):
        raise RuntimeError(f"validate loss is not finite: {val}")
    log(f"validate: {val}")
    return {k: train_counts[k] + val_counts[k] for k in train_counts}


def main():
    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from convnet_tpu_torch.ops.kernels import _build
    from convnet_tpu_torch.ops.kernels import matmul_fused as mf
    from convnet_tpu_torch.ops.kernels import max_pool as mp
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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = {name: pool.submit(_build.build, name) for name in KERNELS}
    for name, job in builds.items():
        lib, build_log = job.result()
        log(f"built {lib.name}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"built {len(KERNELS)} libraries in {time.perf_counter() - t:.1f}s")

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
    pool = check_max_pool(torch)
    log("the pool kernels agree with their plain versions at every shape")

    # -- 3. serve: the main path, counted
    reset_counts(mf, mp)
    t = time.perf_counter()
    logits = [predictor.predict_logits(images[:n]) for n in REQUESTS]
    serve_s = time.perf_counter() - t
    serve_counts = counts(mf, mp)
    log(f"served {REQUESTS} images in {serve_s:.3f}s")
    expect_counts("serving", serve_counts,
                  {"conv1x1_bn_act": per_forward * len(REQUESTS),
                   "max_pool2d_fwd_idx": len(REQUESTS),
                   "max_pool2d_bwd": 0})
    launches = serve_counts["conv1x1_bn_act"]
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

    del predictor, single

    # -- 4. train: the second path, counted
    check_step_against_cpu(torch)
    train_counts = train(torch, card, mf, mp)
    torch.cuda.synchronize()

    # -- 5. summary
    pool_rows = [{
        "name": name,
        "route": "cuda",
        "source": "convnet_tpu_torch/csrc/max_pool.cu",
        "replaces": replaces,
        "launches": train_counts[name],
        "launches_by_path": {"serve": serve_counts[name],
                             "train": train_counts[name]},
        "max_abs_err": pool[name]["max_abs_err"],
        "ms": pool[name]["ms"],
        "plain_ms": pool[name]["plain_ms"],
        "bound_ms": pool[name]["bound_ms"],
        "bound_by": pool[name]["bound_by"],
        "library_ms": pool[name]["library_ms"],
        "library_call": library,
        "times_are": f"one call at the ResNet-50 stem, batch {TRAIN_BATCH}, "
                     f"bf16",
        "also_replaces": also,
    } for name, replaces, also, library in (
        ("max_pool2d_fwd_idx", "convnet_tpu/ops/pallas/pool.py:169", [],
         "F.max_pool2d(..., return_indices=True), channels-last"),
        ("max_pool2d_bwd", "convnet_tpu/ops/pallas/pool.py:272",
         ["convnet_tpu/ops/pallas/pool_bwd.py:120"],
         "aten.max_pool2d_with_indices_backward, channels-last"))]
    emit({"kernels": [{
        "name": "conv1x1_bn_act",
        "route": "cuda",
        "source": "convnet_tpu_torch/csrc/matmul_fused.cu",
        "replaces": "convnet_tpu/ops/pallas/matmul_fused.py:50",
        "launches": launches,
        "launches_by_path": {"serve": launches,
                             "train": train_counts["conv1x1_bn_act"]},
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
    }, *pool_rows]})
    faulthandler.cancel_dump_traceback_later()
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
