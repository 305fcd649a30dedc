#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check its kernels.

Run from the repository root with one CUDA card, nvcc and nvidia-smi:

    python3 chip_smoke.py

Without a card, or without the ``convnet_tpu_torch`` package beside it, it
exits non-zero before printing any result. It imports nothing of JAX.

Five models, each at full width, 224x224, weights drawn from a seed:
ResNet-50, SE-ResNet-50, ResNeXt-50 32x4d, MobileNet v1 and MobileNet-V2;
four more training paths of ResNet-50 (large-batch LARS, batch
augmentation, remat of every stage and of the first); and the CIFAR
ResNets (ResNet-20, WRN-26-4) through a checkpoint, a mid-epoch resume
and serving from the checkpoint; and the port's command-line trainer
(``python -m convnet_tpu_torch.cli.main``, called in process) on datasets:
ResNet-50 from synthetic ImageNet and from JPEG files, ResNet-20 from a
CIFAR-shaped one.

1. card: name and power limit; the CUDA kernels are built with nvcc, one
   process per source, all started together, and the input pipeline's host
   libraries with g++ beside them (``dataio``, which must build, and
   ``jpegdec``, which needs libjpeg: without it the loader takes PIL).
2. kernels: every kernel is held against its plain PyTorch version on the
   card at each shape the four models' paths give it (serving: batch 64
   and 1; the stem pools: batch 128 and 1; the grouped conv at ResNeXt-50's
   stride-1 shapes and the depthwise conv at MobileNet v1's nine shapes,
   each at batch 64, 128 (training and ``validate``) and 1; the MBConv
   kernels at MobileNet-V2's 13 fused blocks, Full at batch 64 and 1,
   Stats and Raw at 128; bf16 and float32), at ragged shapes, and for the
   convs' stride-1 input gradients, which run the same kernels; the fused
   1x1 kernel also at M above 2^23 rows; the Stats and Raw sums of two runs
   must be bit-equal. Each fused 1x1, grouped, depthwise, MBConv and pool
   backward record names the kernel its C library picked (``variant``) and
   fails unless it is the one the shape rule names: every bf16 shape the grouped route
   admits runs on the tensor cores, every bf16 fused 1x1 shape with K and N
   multiples of 8 on the TMA + wgmma kernel, every 3x3 depthwise conv with
   whole 16-byte channel vectors on the tiled kernel, every bf16 MBConv
   block with Cin and Cout multiples of 8 on the tensor-core kernel, every
   3x3/s2/p1 pool backward with whole 16-byte channel vectors and aligned
   dy on the tiled kernel.
   Kernel, plain version and the nearest library call (for MBConv the
   unfused chain of library calls) are timed with CUDA
   events, and the kernel alone (its launches replayed from a CUDA graph)
   with CUDA events too.
3. serve: each model answers requests of 64, 17 and 1 uint8 images. The
   launch counts are set to 0 just before and read just after; each kernel
   must have launched its share. The logits must be finite, unchanged by
   the padding rows, and agree with the port's plain float32 forward on the
   CPU. Then the card's serving throughput and batch-1 latency are timed,
   and the CUDA kernels of one batch-1 forward are counted (torch.profiler),
   on its first call and on a later one.
4. train: each model in the port's ``Trainer`` with its "normal" regime
   (SGD; RMSprop for MobileNet-V2). ResNet-50, SE-ResNet-50, MobileNet v1
   and MobileNet-V2 (dropout 0): one float32 step on the card (TF32 off)
   against the same step on the CPU. bf16 steps at batch 128 on one random
   batch (20 for ResNet-50, 10 for the others), counted and timed; two more
   under torch.profiler, whose device time is broken down by kernel; and
   one ``validate``, counted, then timed twice. The float32 step against
   the CPU also for the two paths below (ResNet-50 at CHECK_BATCH under
   ``large_lars`` in 2 chunks; CHECK_BATCH images in 4 copies each with
   mixup and the gradient-norm scale measured).
   4g. large-batch LARS: ResNet-50's "large_lars" regime at batch 4096 in
   32 chunks of 128, bf16, 3 steps: the lr each step used, 32 pool launches
   each way a step, the peak memory against a batch-128 step's.
   4h. batch augmentation: ResNet-50, 64 images in 4 copies each, mixup,
   the gradient-norm scale, the weights' EMA, bf16, 4 steps; ``validate``
   with averaged outputs, ``calibrate_bn`` on the EMA weights, ``validate``.
   4i. remat: ResNet-50 with every stage and with ``layer1`` alone wrapped
   in ``CheckpointModule``. A float32 step of each at CHECK_BATCH against
   the unwrapped model's CPU step, and its BN statistics against the
   unwrapped model's card step (1e-6: the recompute must not update them
   again); then 5 bf16 steps at batch 128 of the plain model and of each
   variant in one run: step p50 (host clock and CUDA events), peak memory,
   one pool launch each way a step.
   4j. CIFAR: ResNet-20 on CIFAR-10 and WRN-26-4 at 32x32, bf16, batch
   128, the model's regime, cuDNN deterministic: an epoch of 20 fixed
   random batches with a watcher; again with a checkpoint saved after
   batch 10; a fresh Trainer loads it and resumes at batch 10. The end
   state must equal the uninterrupted run's bit for bit; the watcher files
   hold 20 and 10 lines. ``Predictor.from_checkpoint`` of the final
   checkpoint answers requests of 64, 17 and 1 within the bf16 serving
   tolerance of the trainer's model. No kernel runs on this path.
   4k. the CLI, in process, cuDNN deterministic. ResNet-50 on
   synthetic_imagenet (2048 train and 2048 val images of 224² uint8 from the
   seed, on the threaded loader with PIL's RandomResizedCrop, batches staged
   in pinned memory), bf16, batch 128, one epoch of 16 steps and a validate
   of 16 batches, ``--save-freq 8``: one pool launch each way a step, 33
   fused 1x1 launches and one pool forward a validate forward; the step p50
   (host clock and CUDA events), img/s and data_time's share beside phase
   4b's step. A second run ``--resume``s from the checkpoint saved after
   batch 8 and must end bit-equal to the first; ``--evaluate`` of the final
   checkpoint must give the run's last validation loss within the bf16
   serving tolerance. ResNet-50 on an ImageFolder of 256 + 128 JPEGs at
   256x320 in 4 classes, written by the phase, batch 64: the decoder the
   loader took and why; where the native decoder built, its eval decode
   within 1 LSB of PIL's; ``predict_jpeg`` on 17 files gives the top-1 of
   ``Predictor.__call__`` on the same decoded batch. ResNet-20 on
   ``synthetic`` (the card-resident ArrayBatcher, the device flip and
   pad-crop), bf16, batch 128: no kernel.
5. summary: one ``{"kernels": [...]}`` line (each kernel's launches by path,
   the CLI's among them), the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero; a hang dumps every
thread's stack and exits after ``HANG_LIMIT_S``.
"""

from __future__ import annotations

import concurrent.futures
import faulthandler
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HANG_LIMIT_S = 240
SEED = 0
SERVE_BATCH = 64
REQUESTS = (64, 17, 1)            # images per request; each is one forward
RAGGED = [(49, 72, 40, "relu6"),  # N edge masked; K % 8 == 0: the TMA kernel
          (67, 60, 72, "relu"),   # K % 8 != 0: mma.sync with scalar loads
          (130, 24, 136, "none")]  # K under one 64-wide slice: TMA zero-fills
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
KERNELS = ("matmul_fused", "max_pool", "grouped_conv",
           "depthwise_conv", "mbconv")           # csrc/<name>.cu
TRAIN_BATCH = 128     # bf16 steps; BN keeps float32 copies for its backward
CHECK_BATCH = 4       # the float32 step held against the CPU
# the stem pools of ResNet-50 and ResNeXt-50: (H, W, C), kernel, stride, pad
STEM_POOLS = [((112, 112, 64), 3, 2, 1), ((112, 112, 128), 3, 2, 1)]
# fault 3.1: the fused 1x1 kernel at M above gridDim.y's 65,535 tiles
# (M, K, N, act, dtype); x alone is 1.08 GB in either
LARGE_M = [(8_400_000, 64, 64, "relu", "bf16"),
           (4_200_000, 64, 64, "relu", "float32")]
# ResNeXt-50's stride-1 grouped 3x3s: (H, W, C), cg, launches per forward
GROUPED_PATH = [((56, 56, 128), 4, 3), ((28, 28, 256), 8, 3),
                ((14, 14, 512), 16, 5), ((7, 7, 1024), 32, 2)]
# off the path: the stride-2 shape (first block of stage 2) and ragged
# cases: (B, H, W, C), cg, stride, padding
GROUPED_MORE = [((64, 56, 56, 256), 8, 2, 1), ((2, 9, 9, 64), 4, 2, 1),
                ((2, 7, 5, 96), 3, 1, 1), ((2, 8, 8, 64), 4, 1, 2)]
# MobileNet v1's depthwise 3x3s at batch 64: (H = W, C, stride), launches
# per forward
DEPTHWISE_PATH = [((112, 32, 1), 1), ((112, 64, 2), 1), ((56, 128, 1), 1),
                  ((56, 128, 2), 1), ((28, 256, 1), 1), ((28, 256, 2), 1),
                  ((14, 512, 1), 5), ((14, 512, 2), 1), ((7, 1024, 1), 1)]
DEPTHWISE_MORE = [((2, 15, 13, 3), 2, 1), ((2, 9, 9, 17), 1, 1),
                  ((2, 8, 8, 40), 2, 1)]
# the convs vs their plain versions, |err| <= tol * (1 + |ref|):
#   float32: both add float32 products in a stated order (the depthwise
#            kernel in exactly the plain version's order, the grouped one
#            tap by tap as the plain version's einsums do, each einsum in
#            its own order);
#   bf16: the same float32 sums, rounded to bf16, may land one ulp (2^-8
#         relative) apart.
CONV_TOL = {"bf16": 1e-2, "float32": 1e-5}
# MBConv off MobileNet-V2's path: (B, H, W, Cin, hidden, Cout, expand,
# residual): ragged H and W, W odd, C % 8 != 0, no expand, a 1x1 image
MBCONV_RAGGED = [(2, 15, 13, 5, 17, 5, True, True),
                 (2, 9, 9, 12, 12, 7, False, False),
                 (1, 7, 5, 40, 100, 40, True, True),
                 (3, 1, 1, 8, 24, 8, True, False)]
# MBConv kernels vs plain versions: y and h3 |err| <= tol * (1 + |ref|), as
# the fused 1x1 (float32: summation order of the two products; bf16: u2 and
# the output may round one ulp apart). Σ within SUM_TOL of sqrt(n Σ²) and Σ²
# within SUM_TOL of itself: float32 sums over up to 1.6M pixels in another
# order, of depthwise outputs that differ in the last bits.
MBCONV_TOL = {"bf16": 1e-2, "float32": 1e-4}
SUM_TOL = 5e-5
KERNEL_NAMES = ("conv1x1_bn_act", "max_pool2d_fwd_idx", "max_pool2d_bwd",
                "grouped_conv2d", "depthwise_conv2d", "mbconv_full",
                "mbconv_stats", "mbconv_raw")


def launches(conv1x1=0, pool_fwd=0, pool_bwd=0, grouped=0, depthwise=0,
             mb_full=0, mb_stats=0, mb_raw=0):
    return dict(zip(KERNEL_NAMES, (conv1x1, pool_fwd, pool_bwd, grouped,
                                   depthwise, mb_full, mb_stats, mb_raw)))


# tag → (models.build name, config, launches per serving or validate
# forward, launches per training step, bf16 training steps)
MODELS = {
    "resnet50": ("resnet", {"depth": 50}, launches(33, 1),
                 launches(0, 1, 1), 20),
    # SE after each bottleneck's last ConvBN, in plain ops: ResNet-50's
    # kernel routes and shapes
    "resnet_se50": ("resnet_se", {"depth": 50}, launches(33, 1),
                    launches(0, 1, 1), 10),
    "resnext50_32x4d": ("resnext", {}, launches(33, 1, grouped=13),
                        launches(0, 1, 1), 10),
    "mobilenet_v1": ("mobilenet", {}, launches(13, depthwise=13),
                     # 13 forwards and the 9 stride-1 input gradients
                     launches(depthwise=13 + 9), 10),
    # eval: 13 fused blocks; the 4 stride-2 blocks' expand and project and
    # the last 1x1 on the fused 1x1, their depthwise convs on theirs. A step:
    # each fused block a Stats and a Raw pass; the depthwise kernel for the
    # 4 stride-2 forwards, and in each fused block's backward its recompute
    # and its stride-1 dx (13 + 13)
    "mobilenet_v2": ("mobilenet_v2", {}, launches(9, depthwise=4, mb_full=13),
                     launches(depthwise=4 + 13 + 13, mb_stats=13, mb_raw=13),
                     10),
}
# off the stems' path: (B, H, W, C), kernel, stride, padding, whether dy
# starts at an unaligned offset
POOL_RAGGED = [((2, 15, 13, 3), 3, 2, 1, False),   # odd H, W; C = 3: scalar
               ((2, 8, 8, 5), 2, 2, 0, False),     # non-overlapping windows
               ((2, 9, 9, 17), 3, 1, 1, False),    # stride 1: 9 windows a pixel
               # the tiled backward's edges: odd H and W (the last residue
               # row and column masked), Ho = 57 (not a multiple of the
               # tile's rows), batch 1, C = 136 (17 bf16 or 34 float32
               # vectors: an odd slab, two slabs), H = W = 2 (one window)
               ((2, 15, 13, 64), 3, 2, 1, False),
               ((2, 114, 114, 8), 3, 2, 1, False),
               ((1, 9, 7, 16), 3, 2, 1, False),
               ((2, 16, 16, 136), 3, 2, 1, False),
               ((3, 2, 2, 8), 3, 2, 1, False),
               ((2, 16, 16, 64), 3, 2, 1, True)]   # unaligned dy: per pixel
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
# held in norm, overall and per tensor, at about twice that. A tensor's error
# is over its update's norm plus 1e-4 of all updates' norm: in MobileNet-V2
# the shift of a project BN that feeds the next block's expand BN has a zero
# gradient, so its update is rounding noise.
STEP_TOL = {"loss": 1e-4, "stats": 1e-4, "update_norm": 5e-2,
            "update_norm_per_tensor": 1e-1, "tensor_floor": 1e-4}
# phase 4g: ResNet-50's "large_lars" regime (BASELINE.json's 4k-batch
# config) in chunks of 128, the batch-128 step of phase 4b; a step's peak
# memory less the batch's two copies must stay within this factor of that
# step's (an unchunked 4096 step would need about 32 times its activations)
LARGE_BATCH, LARGE_BATCH_CHUNKS, LARGE_BATCH_STEPS = 4096, 32, 3
LARGE_BATCH_PEAK_TOL = 1.25
# phase 4h: the README's batch-augmentation run (-b 64 --duplicates 4
# --mixup 0.2 --label-smoothing 0.1, averaged outputs) with the weights' EMA,
# and the gradient-norm scale measured every 2 steps (the README's 100 would
# not measure twice in BATCH_AUG_STEPS)
BATCH_AUG = {"duplicates": 4, "adapt_grad_norm": 2, "mixup_alpha": 0.2,
             "label_smoothing": 0.1, "average_output": True,
             "model_ema": 0.999}
BATCH_AUG_IMAGES, BATCH_AUG_STEPS = 64, 4
# phase 4i: remat of ResNet-50, every stage and the first alone, against the
# plain model, bf16 at TRAIN_BATCH; the BN statistics of a float32 remat
# step on the card against the plain model's step there, relative (the
# recompute must not move them a second time: that would be a momentum's
# share, 1e-1)
REMAT = {"all": True, "layer1": ("layer1",)}
REMAT_STEPS = 8
REMAT_STATS_TOL = 1e-6
# phase 4j: BASELINE.json's first config (ResNet-20 on CIFAR-10, batch 128,
# SGD with momentum) and the wide ResNet at its defaults (WRN-26-4), bf16;
# one epoch of CIFAR_BATCHES fixed random batches, then the same epoch
# saved after batch CIFAR_SAVE_AT and resumed by a fresh Trainer
# (the configs name the dataset, as the JAX package's CLI records it: serving
# takes its normalisation from there)
CIFAR_MODELS = {"resnet20_cifar10": ("resnet", {"dataset": "cifar10",
                                                "depth": 20}),
                "wide_resnet_26_4": ("wide_resnet", {"dataset": "cifar10"})}
CIFAR_BATCHES, CIFAR_SAVE_AT, CIFAR_BATCH = 20, 10, 128
# phase 4j's served logits against the trainer's model in eval in float32,
# as a share of its largest |logit|: bf16 (BN folded) within
# SERVE_TOL["bf16"], float32 within SERVE_TOL["float32"]
WATCH_KEYS = {"epoch", "step", "loss", "grad_norm", "lr", "step_time",
              "data_time"}
# phase 4k: the port's CLI, in process. ResNet-50 on synthetic_imagenet (2048
# train and 2048 val images of 224² uint8 from the seed: 16 steps and a
# validate of 16 batches at batch 128), resumed from the checkpoint saved
# after CLI_SAVE_AT batches; ResNet-50 on an ImageFolder of JPEGs the phase
# writes (CLI_FOLDER: images a split, classes, height, width); ResNet-20 on
# synthetic (CIFAR-shaped: the card-resident ArrayBatcher)
CLI_BATCH, CLI_SAVE_AT, CLI_STEPS = 128, 8, 16
CLI_FOLDER = {"train": 256, "val": 128, "classes": 4, "h": 256, "w": 320}
CLI_FOLDER_BATCH, CLI_PREDICT = 64, 17
# native eval decode against PIL's (tests/test_native_jpeg.py): at most 1
# LSB apart, and most pixels equal
LSB_SHARE = 0.8
# STEP_P50_MS: phase 4b's bf16 step p50 (host clock) by model, for 4k
STEP_P50_MS = {}

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


def kernel_alone_ms(torch, launch, calls=10, replays=5):
    """Device ms per call of ``launch``, which launches one kernel and
    nothing else (no weight cast or copy, no count): ``calls`` launches
    captured in a CUDA graph, the graph replayed ``replays`` times between
    CUDA events. So neither the wrapper's host work nor its other launches
    are in the time, as they are in ``cuda_ms`` of back-to-back wrapper
    calls."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


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


def check_matmul_fused(torch, path):
    """Phase 2 for conv1x1_bn_act: correctness at every shape of every
    model's path (batch 64 and 1) and at the ragged shapes, in bf16 and
    float32; times in bf16, the path's type. ``path``: model tag → (M, K, N,
    act) at batch 64 → launches per forward. Returns the per-forward totals
    at batch 64 of each model, and the largest error."""
    from convnet_tpu_torch.ops.kernels import matmul_fused as mf
    dtypes = {"bf16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    distinct = sorted({key for shapes in path.values() for key in shapes})
    cases = []
    for m, k, n, act in distinct:
        per_image = m // SERVE_BATCH
        for batch in (SERVE_BATCH, 1):
            cases.append((per_image * batch, k, n, act, batch))
    cases += [(m, k, n, act, None) for m, k, n, act in RAGGED]

    timed = {}
    max_err = 0.0
    variants = {}
    failures = []
    for m, k, n, act, batch in cases:
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
            kind = mf.variant(x, w, out)
            ok = bool((diff <= tol * (1 + ref.float().abs())).all()) \
                and kind == fused_variant_expected(k, n, dname)
            rec = {"check": "conv1x1_bn_act", "dtype": dname, "batch": batch,
                   "M": m, "K": k, "N": n, "act": act, "variant": kind,
                   "launches_per_forward": {
                       tag: shapes.get((m * SERVE_BATCH // (batch or 1), k,
                                        n, act), 0)
                       for tag, shapes in path.items()} if batch else None,
                   "max_abs_err": err, "tol": tol, "ok": ok}
            if batch is not None:
                max_err = max(max_err, err)
                variants.setdefault(dname, set()).add(kind)
            if batch == SERVE_BATCH and dname == "bf16":
                w_lib = (w.t().float() * scale).to(dtype)
                shift_lib = shift.to(dtype)
                rec["ms"] = cuda_ms(torch, lambda: mf.matmul_scale_act(
                    x, w.t(), scale, shift, act))
                y = torch.empty((m, n), dtype=dtype, device="cuda")
                rec["kernel_ms"] = kernel_alone_ms(
                    torch, lambda: mf._call(x, w, scale, shift, y, act))
                rec["plain_ms"] = cuda_ms(
                    torch, lambda: mf.matmul_scale_act_plain(
                        x, w.t(), scale, shift, act))
                # the nearest single library call: no activation
                rec["library_ms"] = cuda_ms(
                    torch, lambda: torch.addmm(shift_lib, x, w_lib))
                rec["bound_ms"], rec["bound_by"] = bound(m, k, n, dname)
                timed[(m, k, n, act)] = rec
            emit(rec)
            if not ok:
                failures.append(rec)
    failures += check_large_m(torch, mf, gen)
    if failures:
        raise RuntimeError(f"conv1x1_bn_act disagrees with its plain version "
                           f"in {len(failures)} case(s)")
    totals = {}
    for tag, shapes in path.items():
        total = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
                 "library_ms": 0.0, "bound_ms": 0.0, "bytes_bound_ms": 0.0}
        for key, per_fwd in shapes.items():
            rec = timed[key]
            for name in ("ms", "kernel_ms", "plain_ms", "library_ms",
                         "bound_ms"):
                total[name] += per_fwd * rec[name]
            if rec["bound_by"] == "bytes":
                total["bytes_bound_ms"] += per_fwd * rec["bound_ms"]
        total["bound_by"] = ("bytes" if total["bytes_bound_ms"] * 2
                             >= total["bound_ms"] else "operations")
        totals[tag] = total
    return totals, max_err, {d: sorted(v) for d, v in variants.items()}


def fused_variant_expected(k, n, dname):
    """The fused 1x1's shape rule for a fresh, aligned x, w and out: bf16
    with K and N multiples of 8 takes the TMA + wgmma kernel, other bf16
    shapes the mma.sync kernel, float32 the FMA kernel."""
    if dname == "float32":
        return "fma_float32"
    return "tma_wgmma" if k % 8 == 0 and n % 8 == 0 else "mma_sync"


def check_large_m(torch, mf, gen):
    """Fault 3.1: one launch at M above 2^23 rows in bf16 and above 2^22 in
    float32 (gridDim.y's limit before the output tiles moved to gridDim.x),
    against the plain version. Returns the failed records."""
    failures = []
    for m, k, n, act, dname in LARGE_M:
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(k, n, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        scale = torch.rand(n, generator=gen, device="cuda") + 0.5
        shift = torch.randn(n, generator=gen, device="cuda") * 0.5
        out = mf.matmul_scale_act(x, w, scale, shift, act)
        ref = mf.matmul_scale_act_plain(x, w, scale, shift, act)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        tol = KERNEL_TOL[dname]
        kind = mf.variant(x, w.t(), out)
        rec = {"check": "conv1x1_bn_act_large_m", "dtype": dname, "M": m,
               "K": k, "N": n, "act": act, "variant": kind,
               "x_bytes": x.numel() * x.element_size(),
               "max_abs_err": diff.max().item(), "tol": tol,
               "ok": bool((diff <= tol * (1 + ref.float().abs())).all())
               and kind == fused_variant_expected(k, n, dname)}
        emit(rec)
        if not rec["ok"]:
            failures.append(rec)
        del x, out, ref, diff
    torch.cuda.empty_cache()
    return failures


def conv_bound(b, ho, wo, c, x_numel, w_numel, ops_per_out, dname):
    """Least time (ms) of a conv: x and w read once and y written once
    against the HBM rate; 2 * ``ops_per_out`` operations an output element
    against the type's dense peak. Returns (ms, "bytes" | "operations")."""
    e = 2 if dname == "bf16" else 4
    y_numel = b * ho * wo * c
    bytes_ms = (x_numel + w_numel + y_numel) * e / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * ops_per_out * y_numel / PEAK_OPS_PER_S[dname] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def check_conv(torch, name, module, cases, make_w, dx_weight, library):
    """Phase 2 for a conv kernel: at each case ((B, H, W, C), groups,
    stride, padding, launches per forward (0 off the path), timed) in bf16
    and float32, the kernel against its plain version (and
    ``module.variant``'s kernel that ran against the one its rule names),
    and at stride 1 the autograd input
    gradient (the same kernel on dy) against the plain version on the
    prepared dy. Times the timed cases in bf16. Returns the summary: the
    per-forward sums of the timed cases and the largest error."""
    from convnet_tpu_torch.ops.kernels import _conv
    dtypes = {"bf16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bytes_bound_ms": 0.0, "max_abs_err": 0.0,
           "shapes": [], "variants": {}}
    failures = []
    for shape, groups, stride, pad, per_fwd, timed in cases:
        c = shape[-1]
        for dname, dtype in dtypes.items():
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = make_w(c, groups, gen).to(dtype)
            y = module.apply(x, w, stride, pad, groups)
            ref = module.plain(x, w, stride, pad, groups)
            torch.cuda.synchronize()
            diff = (y.float() - ref.float()).abs()
            tol = CONV_TOL[dname]
            kind = module.variant(x, w, groups, stride)
            rec = {"check": name, "dtype": dname, "shape": list(shape),
                   "groups": groups, "stride": stride, "padding": pad,
                   "launches_per_forward": per_fwd, "variant": kind[0],
                   "max_abs_err": diff.max().item(), "tol": tol,
                   "ok": bool((diff <= tol * (1 + ref.float().abs())).all())
                   and kind[0] == kind[1]}
            if stride == 1:
                xg = x.detach().requires_grad_()
                dy = torch.randn(ref.shape, generator=gen,
                                 device="cuda").to(dtype)
                (dx,) = torch.autograd.grad(
                    module.apply(xg, w, stride, pad, groups), xg, dy)
                dy_in, dpad = _conv.dx_geometry(dy, (3, 3), (pad, pad))
                dx_ref = module.plain(dy_in, dx_weight(w, groups), 1, dpad,
                                      groups)
                torch.cuda.synchronize()
                ddiff = (dx.float() - dx_ref.float()).abs()
                rec["dx_max_abs_err"] = ddiff.max().item()
                rec["dx_ok"] = bool((ddiff <= tol * (1 + dx_ref.float()
                                                     .abs())).all())
                rec["ok"] = rec["ok"] and rec["dx_ok"]
            if per_fwd:
                out["max_abs_err"] = max(out["max_abs_err"],
                                         rec["max_abs_err"])
                out["variants"].setdefault(dname, set()).add(kind[0])
            if timed and dname == "bf16":
                rec["ms"] = cuda_ms(torch, lambda: module.apply(
                    x, w, stride, pad, groups))
                rec["plain_ms"] = cuda_ms(torch, lambda: module.plain(
                    x, w, stride, pad, groups))
                rec["library_ms"] = cuda_ms(torch, lambda: library(
                    x, w, stride, pad, groups))
                rec["kernel_ms"] = kernel_alone_ms(
                    torch, module.launch(x, w, stride, pad, groups))
                b, h, wd, _ = shape
                ho, wo = (h + 2 * pad - 3) // stride + 1, \
                    (wd + 2 * pad - 3) // stride + 1
                rec["bound_ms"], rec["bound_by"] = conv_bound(
                    b, ho, wo, c, x.numel(), w.numel(),
                    9 * (c // groups), dname)
                for key in ("ms", "kernel_ms", "plain_ms", "library_ms",
                            "bound_ms"):
                    out[key] += per_fwd * rec[key]
                if rec["bound_by"] == "bytes":
                    out["bytes_bound_ms"] += per_fwd * rec["bound_ms"]
                out["shapes"].append({k: rec[k] for k in (
                    "shape", "groups", "stride", "launches_per_forward",
                    "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")})
            emit(rec)
            if not rec["ok"]:
                failures.append(rec)
    if failures:
        raise RuntimeError(f"{name} disagrees with its plain version in "
                           f"{len(failures)} case(s)")
    out["bound_by"] = ("bytes" if out["bytes_bound_ms"] * 2 >= out["bound_ms"]
                       else "operations")
    out["variants"] = {d: sorted(v) for d, v in out["variants"].items()}
    return out


def check_grouped(torch):
    """Kernel A at ResNeXt-50's stride-1 shapes (batch 64, timed; 128, as
    ``validate`` runs it; and 1), the stride-2 shape and the ragged
    cases."""
    import types
    import torch.nn.functional as F
    from convnet_tpu_torch.ops.kernels import _conv
    from convnet_tpu_torch.ops.kernels import grouped_conv as gc
    cases = []
    for (h, w, c), cg, per_fwd in GROUPED_PATH:
        for batch in (SERVE_BATCH, TRAIN_BATCH, 1):
            cases.append(((batch, h, w, c), c // cg, 1, 1, per_fwd,
                          batch == SERVE_BATCH))
    cases += [(shape, shape[-1] // cg, s, p, 0, False)
              for shape, cg, s, p in GROUPED_MORE]
    def variant(x, w, groups, stride):
        """(the kernel that ran, the one the rule names): every shape that
        ``supported`` admits takes the tensor cores in bf16."""
        cg = x.shape[-1] // groups
        want = "tensor_cores" if x.dtype == torch.bfloat16 and (
            gc.supported(x.shape, w.shape, groups, stride)
            or (x.shape[-1] % 64 == 0 and (16 % cg == 0 or cg in (32, 64,
                                                                   128)))) \
            else "cuda_cores"
        return gc.variant(x, groups), want

    module = types.SimpleNamespace(
        apply=gc.grouped_conv2d, plain=gc.grouped_conv2d_plain,
        variant=variant,
        launch=lambda x, w, s, p, g: functools.partial(
            _conv.launch, gc._kernel, "grouped_conv2d", x,
            gc.kernel_weight(w, x), (3, 3), s, p, x.shape[-1] // g))

    def make_w(c, groups, gen):
        cg = c // groups
        return torch.randn(c, cg, 3, 3, generator=gen,
                           device="cuda") / (9 * cg) ** 0.5

    def library(x, w, s, p, groups):   # cuDNN on the channels-last view
        return F.conv2d(x.permute(0, 3, 1, 2), w, None, s, p, 1, groups)

    return check_conv(torch, "grouped_conv2d", module, cases, make_w,
                      gc.flip_transpose, library)


def check_depthwise(torch):
    """Kernel B at MobileNet v1's nine shapes (batch 64, timed; 128, as
    training and ``validate`` run it; and 1) and the ragged cases."""
    import types
    import torch.nn.functional as F
    from convnet_tpu_torch.ops.kernels import _conv
    from convnet_tpu_torch.ops.kernels import depthwise_conv as dc
    cases = [((batch, h, h, c), c, s, 1, per_fwd, batch == SERVE_BATCH)
             for (h, c, s), per_fwd in DEPTHWISE_PATH
             for batch in (SERVE_BATCH, TRAIN_BATCH, 1)]
    cases += [(shape, shape[-1], s, p, 0, False)
              for shape, s, p in DEPTHWISE_MORE]
    module = types.SimpleNamespace(
        apply=lambda x, w, s, p, g: dc.depthwise_conv2d(x, w, s, p),
        plain=lambda x, w, s, p, g: dc.depthwise_conv2d_plain(x, w, s, p),
        variant=lambda x, w, g, s: (dc.variant(x, w, s),
                                    depthwise_variant_expected(x, s)),
        launch=lambda x, w, s, p, g: functools.partial(
            _conv.launch, dc._kernel, "depthwise_conv2d", x, w, (3, 3), s,
            p))

    def make_w(c, groups, gen):
        return torch.randn(c, 1, 3, 3, generator=gen, device="cuda") / 3

    def library(x, w, s, p, groups):   # cuDNN on the channels-last view
        return F.conv2d(x.permute(0, 3, 1, 2), w, None, s, p, 1, groups)

    return check_conv(torch, "depthwise_conv2d", module, cases, make_w,
                      lambda w, g: w.flip(-2, -1), library)


def depthwise_variant_expected(x, stride):
    """The depthwise conv's shape rule for a fresh, aligned x and w (3x3,
    the same stride both ways): whole 16-byte channel vectors (8 bf16 or 4
    float32 channels) take the tiled kernel, other C the per-pixel one."""
    vec = 16 // x.element_size()
    return "tiled" if x.shape[-1] % vec == 0 and stride in (1, 2) \
        else "per_pixel"


def mbconv_variant_expected(mode, cin, ch, cout, expand, dname):
    """The MBConv shape rule for a fresh, aligned x: bf16 with Cin a
    multiple of 8, Ch of 4, Cout of 8 up to 320 (Full, Raw), an expand
    stage or Cin == Ch, takes the tensor-core kernel (the staging of the
    narrow shapes here fits a block); the rest the CUDA-core kernel."""
    ok = (dname == "bf16" and cin % 8 == 0 and ch % 4 == 0
          and (expand or cin == ch)
          and (mode == "stats" or (cout % 8 == 0 and cout <= 320)))
    return "tensor_cores" if ok else "cuda_cores"


def mbconv_shapes(torch, predictor, images):
    """(H, W, Cin, hidden, Cout, expand, residual) → launches per forward,
    for every inverted residual on the fused route, read by hooks during
    one forward of ``images``."""
    from convnet_tpu_torch.models.mobilenet_v2 import InvertedResidual
    counts = {}

    def hook(mod, args):
        _, h, w, cin = args[0].shape
        block = list(mod.block)
        key = (h, w, cin, mod.hidden, block[-1].conv.out_channels,
               mod.has_expand, mod.use_res)
        counts[key] = counts.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook)
               for m in predictor.model.modules()
               if isinstance(m, InvertedResidual) and m.uses_kernel()]
    try:
        predictor.predict_logits(images)
    finally:
        for h in handles:
            h.remove()
    return counts


def mbconv_work(b, h, w, cin, ch, cout, expand, mode, dname):
    """(bytes, operations) a call must move and do: x, the weights and the
    per-channel vectors read once, the outputs written once; 2 operations a
    multiply-add of the expand, the 9 taps and (Full, Raw) the project."""
    e = 2 if dname == "bf16" else 4
    n = b * h * w
    read = n * cin * e + 9 * ch * 4 + 4 * ch * 4
    macs = 9 * ch
    if expand:
        read += cin * ch * e
        macs += cin * ch
    if mode == "stats":
        written = 2 * ch * 4
    else:
        read += ch * cout * e + 2 * cout * 4
        macs += ch * cout
        written = n * cout * e + (2 * cout * 4 if mode == "raw" else 0)
    return read + written, 2 * n * macs


def mbconv_inputs(torch, gen, b, h, w, cin, ch, cout, expand, dtype):
    """x, we, s1, t1, wd9, s2, t2, wp, s3, t3 on the card: x and the weights
    at unit-scale products, the scales near 1 and the shifts near 0.2 so
    that ReLU6 clips at both ends somewhere."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = r(b, h, w, cin).to(dtype)
    we = r(cin, ch) / cin ** 0.5 if expand else None
    vec = [r(ch) * 0.2 + 1.0, r(ch) * 0.2 + 0.2]
    return (x, we, *vec, r(9, ch) / 3, r(ch) * 0.2 + 1.0, r(ch) * 0.2 + 0.2,
            r(ch, cout) / ch ** 0.5, r(cout) * 0.2 + 1.0, r(cout) * 0.2)


def mbconv_library(torch, F, mode, x, we, s1, t1, wd9, s2, t2, wp, s3, t3,
                   residual):
    """The same function as a chain of library calls in x's type (timed
    only, never used by the port): addmm for the expand with s1 folded into
    the weight, clamp, cuDNN's depthwise conv on the channels-last view,
    the BN affine and clamp, addmm for the project (+ x), or the sums."""
    b, h, w, cin = x.shape
    ch = wd9.shape[1]
    v = x.reshape(-1, cin)
    if we is not None:
        v = torch.addmm(t1.to(x.dtype), v, (we * s1).to(x.dtype)).clamp_(0, 6)
    d = F.conv2d(v.view(b, h, w, ch).permute(0, 3, 1, 2),
                 wd9.t().reshape(ch, 1, 3, 3).to(x.dtype), None, 1, 1, 1, ch)
    d = d.permute(0, 2, 3, 1).reshape(-1, ch)
    if mode == "stats":
        d = d.float()
        return torch.stack([d.sum(0), (d * d).sum(0)])
    u2 = (d * s2.to(x.dtype) + t2.to(x.dtype)).clamp_(0, 6)
    if mode == "raw":
        h3 = u2 @ wp.to(x.dtype)
        h32 = h3.float()
        return h3, torch.stack([h32.sum(0), (h32 * h32).sum(0)])
    y = torch.addmm(t3.to(x.dtype), u2, (wp * s3).to(x.dtype))
    return y + x.reshape(-1, cin) if residual else y


def check_mbconv(torch, path):
    """Phase 2 for the MBConv kernels: at every fused block of MobileNet-V2's
    path (``path``: (H, W, Cin, hidden, Cout, expand, residual) → launches
    per forward), Full at batch 64 and 1, Stats and Raw at batch 128, and at
    the ragged cases, in bf16 and float32, each mode against its plain
    version, and the kernel that ran against the one the shape rule names;
    the sums of two Stats and two Raw runs bit-equal. Times in bf16 at batch
    64 (Full) and 128 (Stats, Raw), the paths' types and batches. Returns
    {mode: summary} with per-forward (Full) or per-step sums."""
    import torch.nn.functional as F
    from convnet_tpu_torch.ops.kernels import mbconv as mb
    dtypes = {"bf16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for key, per_fwd in sorted(path.items()):
        h, w, cin, ch, cout, expand, residual = key
        for mode, batches in (("full", (SERVE_BATCH, 1)),
                              ("stats", (TRAIN_BATCH,)),
                              ("raw", (TRAIN_BATCH,))):
            for b in batches:
                cases.append((mode, (b, h, w, cin, ch, cout, expand,
                                     residual), per_fwd,
                              b in (SERVE_BATCH, TRAIN_BATCH)))
    cases += [(mode, shape, 0, False) for shape in MBCONV_RAGGED
              for mode in ("full", "stats", "raw")]
    names = {"full": "mbconv_full", "stats": "mbconv_stats",
             "raw": "mbconv_raw"}
    out = {mode: {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bound_ms": 0.0, "bytes_bound_ms": 0.0,
                  "tensor_core_floor_ms": 0.0, "max_abs_err": 0.0,
                  "shapes": [], "variants": {}} for mode in names}
    failures = []
    for mode, shape, per_fwd, timed in cases:
        b, h, w, cin, ch, cout, expand, residual = shape
        for dname, dtype in dtypes.items():
            args = mbconv_inputs(torch, gen, b, h, w, cin, ch, cout, expand,
                                 dtype)
            x, we, s1, t1, wd9, s2, t2, wp, s3, t3 = args
            kw = {"residual": residual} if mode == "full" else {}
            fn, plain, head = {
                "full": (mb.mbconv_full, mb.mbconv_full_plain, args),
                "stats": (mb.mbconv_stats, mb.mbconv_stats_plain, args[:5]),
                "raw": (mb.mbconv_raw, mb.mbconv_raw_plain, args[:8]),
            }[mode]
            got, ref = fn(*head, **kw), plain(*head, **kw)
            again = fn(*head) if mode != "full" else None
            torch.cuda.synchronize()
            tol = MBCONV_TOL[dname]
            kind = mb.variant(mode, x, ch, cout if mode != "stats" else 0,
                              expand)
            want = mbconv_variant_expected(mode, cin, ch, cout, expand, dname)
            _, run = mb.kernel_args(*head, mode=mode)
            rec = {"check": names[mode], "dtype": dname, "shape": list(shape),
                   "launches_per_forward": per_fwd, "variant": kind,
                   "tile": list(run.tile), "split": run.split, "tol": tol,
                   "sum_tol": SUM_TOL}
            ok = kind == want
            if mode != "stats":
                y, y_ref = (got, ref) if mode == "full" else (got[0], ref[0])
                diff = (y.float() - y_ref.float()).abs()
                rec["max_abs_err"] = diff.max().item()
                ok = bool((diff <= tol * (1 + y_ref.float().abs())).all())
            if mode != "full":
                sums, sums_ref = (got, ref) if mode == "stats" else \
                    (got[1], ref[1])
                again_sums = again if mode == "stats" else again[1]
                n = b * h * w
                scale = torch.stack([(n * sums_ref[1]).sqrt(), sums_ref[1]])
                sdiff = (sums - sums_ref).abs()
                rec["sums_max_err_over_scale"] = (
                    sdiff / scale.clamp_min(1e-30)).max().item()
                rec["sums_bit_equal_across_runs"] = bool(
                    torch.equal(sums, again_sums))
                ok = ok and bool((sdiff <= SUM_TOL * scale).all()) \
                    and rec["sums_bit_equal_across_runs"]
                rec.setdefault("max_abs_err", sdiff.max().item())
            rec["ok"] = ok
            if per_fwd:
                out[mode]["max_abs_err"] = max(out[mode]["max_abs_err"],
                                               rec["max_abs_err"])
                out[mode]["variants"].setdefault(dname, set()).add(kind)
            if timed and dname == "bf16":
                rec.update(time_mbconv(torch, F, mb, mode, args, residual,
                                       fn, plain, head, kw))
                nbytes, ops = mbconv_work(b, h, w, cin, ch, cout, expand,
                                          mode, dname)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops / PEAK_OPS_PER_S[dname] * 1e3
                rec["bound_ms"] = max(bytes_ms, ops_ms)
                rec["bound_by"] = "bytes" if bytes_ms >= ops_ms \
                    else "operations"
                # the products alone at the bf16 tensor-core peak
                rec["tensor_core_floor_ms"] = \
                    ops / PEAK_OPS_PER_S["bf16"] * 1e3
                summary = out[mode]
                for key in ("ms", "kernel_ms", "plain_ms", "library_ms",
                            "bound_ms", "tensor_core_floor_ms"):
                    summary[key] += per_fwd * rec[key]
                if rec["bound_by"] == "bytes":
                    summary["bytes_bound_ms"] += per_fwd * rec["bound_ms"]
                summary["shapes"].append({k: rec[k] for k in (
                    "shape", "launches_per_forward", "variant", "tile",
                    "split", "ms", "kernel_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "tensor_core_floor_ms")})
            emit(rec)
            if not ok:
                failures.append(rec)
            del args, got, again, ref
    if failures:
        raise RuntimeError(f"the MBConv kernels disagree with their plain "
                           f"versions in {len(failures)} case(s)")
    for summary in out.values():
        summary["bound_by"] = ("bytes" if summary["bytes_bound_ms"] * 2
                               >= summary["bound_ms"] else "operations")
        summary["variants"] = {d: sorted(v)
                               for d, v in summary["variants"].items()}
    torch.cuda.empty_cache()
    return out


def time_mbconv(torch, F, mb, mode, args, residual, fn, plain, head, kw):
    """Device ms per call of the wrapper, the kernel alone (bare launches
    of the prepared arguments from a CUDA graph), the plain version and the
    library chain."""
    x = args[0]
    tensors, run = mb.kernel_args(*head, mode=mode)
    outs = mb.outputs(mode, x, args[4].shape[1], args[7].shape[1], run)
    return {
        "ms": cuda_ms(torch, lambda: fn(*head, **kw)),
        "kernel_ms": kernel_alone_ms(torch, lambda: mb.call(
            mode, tensors, run, outs, **kw)),
        "plain_ms": cuda_ms(torch, lambda: plain(*head, **kw)),
        "library_ms": cuda_ms(torch, lambda: mbconv_library(
            torch, F, mode, *args, residual)),
    }


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


def pool_bwd_variant_expected(shape, k, s, p, dname, unaligned):
    """The pool backward's shape rule for a fresh index: a 3x3 pool at
    stride 2 and padding 1 with whole 16-byte channel vectors (8 bf16 or 4
    float32 channels) and an aligned dy takes the tiled kernel, any other
    the per-pixel one."""
    vec = 8 if dname == "bf16" else 4
    return "tiled" if (k, s, p) == (3, 2, 1) and shape[-1] % vec == 0 \
        and not unaligned else "per_pixel"


def check_max_pool(torch):
    """Phase 2 for the pool kernels: correctness at the stems' shapes
    (batch 128 and 1) and the ragged shapes, bf16 and float32, normal and
    tie-heavy inputs, and the backward's kernel against its rule; times at
    both stems at batch 128 in bf16, the training step's shape and type.
    Returns {kernel name: summary}, with ResNet-50's stem as the summary's
    times and both stems under "shapes"."""
    import torch.nn.functional as F
    from convnet_tpu_torch.ops.kernels import max_pool as mp
    dtypes = {"bf16": torch.bfloat16, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((b, h, w, c), k, s, p, False, b)
             for (h, w, c), k, s, p in STEM_POOLS for b in (TRAIN_BATCH, 1)]
    cases += [(shape, k_, s_, p_, unaligned, None)
              for shape, k_, s_, p_, unaligned in POOL_RAGGED]
    out = {name: {"max_abs_err": 0.0, "shapes": [], "variants": {}}
           for name in ("max_pool2d_fwd_idx", "max_pool2d_bwd")}
    failures = []
    for shape, k_, s_, p_, unaligned, batch in cases:
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
                if unaligned:   # the same values one element into a buffer
                    buf = torch.empty(dy.numel() + 1, dtype=dtype,
                                      device="cuda")
                    buf[1:].copy_(dy.reshape(-1))
                    dy = buf[1:].view(dy.shape)
                dx = mp.max_pool2d_bwd(dy, idx, shape, k_, s_, p_)
                dx_ref = mp.max_pool2d_bwd_plain(dy, idx_ref, shape, k_, s_,
                                                 p_)
                torch.cuda.synchronize()
                y_err = (y.float() - y_ref.float()).abs().max().item()
                diff = (dx.float() - dx_ref.float()).abs()
                dx_err = diff.max().item()
                tol = POOL_DX_TOL[dname]
                kind = mp.bwd_variant(dy, idx, k_, s_, p_)
                want = pool_bwd_variant_expected(shape, k_, s_, p_, dname,
                                                 unaligned)
                rec = {"check": "max_pool", "dtype": dname, "batch": batch,
                       "shape": list(shape), "k": k_, "s": s_, "p": p_,
                       "inputs": inputs, "dy_unaligned": unaligned,
                       "bwd_variant": kind, "bwd_variant_expected": want,
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
                    bwd["variants"].setdefault(dname, set()).add(kind)
                if batch == TRAIN_BATCH and dname == "bf16" \
                        and inputs == "normal":
                    rec.update(time_pool(torch, F, mp, x, dy, idx, k_, s_,
                                         p_))
                    for name, (ms, by) in zip(
                            ("max_pool2d_fwd_idx", "max_pool2d_bwd"),
                            pool_bound(shape, k_, s_, p_, dname, idx)):
                        timed = {"shape": list(shape),
                                 "ms": rec[f"{name}_ms"],
                                 "kernel_ms": rec[f"{name}_kernel_ms"],
                                 "plain_ms": rec[f"{name}_plain_ms"],
                                 "library_ms": rec[f"{name}_library_ms"],
                                 "bound_ms": ms, "bound_by": by}
                        out[name]["shapes"].append(timed)
                        if shape[1:] == STEM_POOLS[0][0]:
                            out[name].update(
                                {key: v for key, v in timed.items()
                                 if key != "shape"})
                emit(rec)
                if not (rec["idx_equal"] and rec["y_equal"] and rec["dx_ok"]
                        and kind == want):
                    failures.append(rec)
    if failures:
        raise RuntimeError(f"the pool kernels disagree with their plain "
                           f"versions or their rule in {len(failures)} "
                           f"case(s)")
    out["max_pool2d_bwd"]["variants"] = {
        d: sorted(v) for d, v in out["max_pool2d_bwd"]["variants"].items()}
    return out


def time_pool(torch, F, mp, x, dy, idx, k, s, p):
    """Device ms per call of each pool kernel, its plain version and the
    library's channels-last max pool (timed only, never used by the port)."""
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, lib_idx = F.max_pool2d(x_nchw, k, s, p, return_indices=True)
    lib_bwd = torch.ops.aten.max_pool2d_with_indices_backward
    fwd_fn, bwd_fn = mp._kernels()
    dims = (*x.shape, *idx.shape[1:3], k, k, s, s, p, p)
    y_out, idx_out, dx_out = (torch.empty_like(dy), torch.empty_like(idx),
                              torch.empty_like(x))
    return {
        "max_pool2d_fwd_idx_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_fwd_idx(x, k, s, p)),
        "max_pool2d_fwd_idx_kernel_ms": kernel_alone_ms(
            torch, lambda: mp._call(
                fwd_fn, "max_pool2d_fwd_idx", (x.data_ptr(), y_out.data_ptr(),
                                               idx_out.data_ptr()),
                dims, x.dtype, x.device)),
        "max_pool2d_fwd_idx_plain_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_fwd_idx_plain(x, k, s, p)),
        "max_pool2d_fwd_idx_library_ms": cuda_ms(
            torch, lambda: F.max_pool2d(x_nchw, k, s, p,
                                        return_indices=True)),
        "max_pool2d_bwd_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_bwd(dy, idx, x.shape, k, s, p)),
        "max_pool2d_bwd_kernel_ms": kernel_alone_ms(
            torch, lambda: mp._call(
                bwd_fn, "max_pool2d_bwd", (dy.data_ptr(), idx.data_ptr(),
                                           dx_out.data_ptr()),
                dims, dy.dtype, dy.device)),
        "max_pool2d_bwd_plain_ms": cuda_ms(
            torch, lambda: mp.max_pool2d_bwd_plain(dy, idx, x.shape, k, s,
                                                   p)),
        "max_pool2d_bwd_library_ms": cuda_ms(
            torch, lambda: lib_bwd(dy_nchw, x_nchw, [k, k], [s, s], [p, p],
                                   [1, 1], False, lib_idx)),
    }


def reset_counts(k):
    k.mf.launches = k.mp.fwd_launches = k.mp.bwd_launches = 0
    k.gc.launches = k.dc.launches = 0
    k.mb.full_launches = k.mb.stats_launches = k.mb.raw_launches = 0


def counts(k):
    return dict(zip(KERNEL_NAMES, (k.mf.launches, k.mp.fwd_launches,
                                   k.mp.bwd_launches, k.gc.launches,
                                   k.dc.launches, k.mb.full_launches,
                                   k.mb.stats_launches, k.mb.raw_launches)))


def add_counts(a, b):
    return {name: a[name] + b[name] for name in KERNEL_NAMES}


def expect_counts(what, got, want):
    log(f"{what}: launches {got}")
    if got != want:
        raise RuntimeError(f"{what}: kernel launches {got}, expected {want}")


def make_trainer(torch, tag, dtype, device, features=None, **overrides):
    """The port's Trainer for model ``tag`` with weights from SEED;
    ``features`` are more ``TrainerConfig`` fields, ``overrides`` change the
    model's config (its regime, for instance)."""
    from convnet_tpu_torch import models
    from convnet_tpu_torch.regimes.optim import OptimRegime
    from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
    name, config = MODELS[tag][:2]
    model = models.build(name, **config, **overrides)
    tr = Trainer(model, OptimRegime(model.regime), 1000,
                 TrainerConfig(dtype=dtype, **(features or {})),
                 device=device, seed=SEED)
    tr.initialize()
    return tr


def augmented_copies(x, duplicates):
    """Each image of ``x`` (NHWC) repeated ``duplicates`` times
    contiguously, as the JAX package's loaders pack batch augmentation's
    copies, and every second copy flipped left to right, as the loader's
    random flip would: so the copies differ."""
    x = np.repeat(x, duplicates, 0)
    x[1::2] = x[1::2, :, ::-1]
    return x


def _plain_name(name):
    """A remat model's parameter or buffer name as the unwrapped model's."""
    return name.replace(".module.", ".")


# phase 4a's float32 steps held against the CPU: (tag, TrainerConfig
# fields, duplicates, model overrides); their CPU halves run while the
# kernels build (``cpu_step``)
CPU_CHECKS = (("resnet50", None, 1, {}), ("resnet_se50", None, 1, {}),
              ("mobilenet_v1", None, 1, {}),
              ("mobilenet_v2", None, 1, {"dropout": 0.0}),
              ("resnet50", {"chunk_batch": 2}, 1,
               {"regime": "large_lars", "batch_size": LARGE_BATCH}),
              ("resnet50", {**BATCH_AUG, "adapt_grad_norm": 1},
               BATCH_AUG["duplicates"], {}))


def _check_batch(duplicates):
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((CHECK_BATCH, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, CHECK_BATCH)
    if duplicates > 1:
        x, y = augmented_copies(x, duplicates), np.repeat(y, duplicates)
    return x, y


def _one_step(torch, tag, where, x, y, features, overrides):
    """(loss, updates, BN statistics, initial weights) of one float32 step
    of model ``tag`` on ``where`` (None: the card), by the unwrapped
    model's names."""
    tr = make_trainer(torch, tag, "float32", where, features, **overrides)
    p0 = {_plain_name(n): q.detach().cpu().clone()
          for n, q in tr.model.named_parameters()}
    loss = float(tr.train_step(x, y)["loss"])
    upd = {_plain_name(n): q.detach().cpu() - p0[_plain_name(n)]
           for n, q in tr.model.named_parameters()}
    stats = {_plain_name(n): b.detach().cpu()
             for n, b in tr.model.named_buffers()}
    return loss, upd, stats, p0


def cpu_step(torch, cpu_steps, tag, features=None, duplicates=1,
             **overrides):
    """The CPU half of ``check_step_against_cpu``, kept in ``cpu_steps``."""
    key = repr((tag, features, duplicates, sorted(overrides.items())))
    if key not in cpu_steps:
        x, y = _check_batch(duplicates)
        cpu_steps[key] = _one_step(torch, tag, "cpu", x, y, features,
                                   overrides)
    return cpu_steps[key]


def check_step_against_cpu(torch, tag, features=None, duplicates=1,
                           card_model=None, cpu_steps=None, **overrides):
    """Phase 4a: one float32 step on the card and on the CPU from the same
    weights (seed) and batch; ``features`` are ``TrainerConfig`` fields
    (mixup draws its λ on the host from the seed, so both devices mix
    alike), ``duplicates`` packs that many copies of each of the
    ``CHECK_BATCH`` images, ``overrides`` change the model's config and
    ``card_model`` the card's model alone (remat: the CPU runs the unwrapped
    model). ``cpu_steps``: a dict that keeps the CPU's steps for a later
    call with the same arguments. Returns the card's BN statistics after
    the step, by the unwrapped model's names."""
    x, y = _check_batch(duplicates)
    cpu_steps = {} if cpu_steps is None else cpu_steps
    (l_cpu, u_cpu, s_cpu, p0_cpu) = cpu_step(torch, cpu_steps, tag, features,
                                             duplicates, **overrides)
    (l_gpu, u_gpu, s_gpu, p0_gpu) = _one_step(
        torch, tag, None, x, y, features, {**overrides, **(card_model or {})})
    if p0_cpu.keys() != p0_gpu.keys() or any(
            not torch.equal(p0_cpu[n], p0_gpu[n]) for n in p0_cpu):
        raise RuntimeError("the card and the CPU drew different weights")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    all_norm = sum(u_cpu[n].square().sum() for n in u_cpu).sqrt()
    floor = STEP_TOL["tensor_floor"] * all_norm
    per_tensor = {n: ((u_gpu[n] - u_cpu[n]).norm()
                      / (u_cpu[n].norm() + floor)).item() for n in u_cpu}
    total = (sum((u_gpu[n] - u_cpu[n]).square().sum() for n in u_cpu)
             .sqrt() / all_norm).item()
    # reported, not checked: the largest element error over its tensor's
    # largest update
    elem = max((u_gpu[n] - u_cpu[n]).abs().max().item()
               / (u_cpu[n].abs().max().item() + 1e-30) for n in u_cpu)
    worst = max(per_tensor, key=per_tensor.get)
    stat_err = max(((s_gpu[n] - s_cpu[n]).abs()
                    / (1 + s_cpu[n].abs())).max().item() for n in s_cpu)
    rec = {"check": "train_step_card_vs_cpu", "model": tag,
           "features": features or {}, "model_overrides": overrides,
           "card_model": card_model or {},
           "dtype": "float32", "batch": len(x), "loss_cpu": l_cpu,
           "loss_card": l_gpu, "loss_rel_err": loss_err,
           "update_norm_rel_err": total, "update_worst_tensor": worst,
           "update_worst_tensor_norm_rel_err": per_tensor[worst],
           "update_max_elem_err_over_max": elem,
           "stats_max_err": stat_err, "tol": STEP_TOL}
    emit(rec)
    if (loss_err > STEP_TOL["loss"] or stat_err > STEP_TOL["stats"]
            or total > STEP_TOL["update_norm"]
            or per_tensor[worst] > STEP_TOL["update_norm_per_tensor"]):
        raise RuntimeError(f"{tag}: the float32 step on the card disagrees "
                           f"with the CPU's")
    return s_gpu


# kernel name → share of the step, first match wins
KERNEL_GROUPS = (("pool kernels", ("max_pool2d_",)),
                 ("mbconv kernels", ("mbconv_",)),
                 ("depthwise kernel", ("depthwise_conv2d_kernel",
                                       "depthwise_tiled")),
                 ("convolutions", ("conv", "xmma", "gemm", "cutlass", "sm90",
                                   "dgrad", "wgrad", "cudnn")),
                 ("reductions", ("reduce_kernel",)),
                 ("copies and casts", ("copy", "Memcpy", "Memset")),
                 ("other elementwise", ("",)))


def profile_step(torch, tag, tr, x, y, card, step_ms, steps=2):
    """Phase 4f: device time of a bf16 training step by kernel, from
    torch.profiler (CUDA activity only) over ``steps`` steps; the idle
    share is against ``step_ms``, the unprofiled step's p50 (the profiler's
    own start-up would swamp the profiled wall time). The profiler's CUPTI
    tracing now and then records nothing: it is tried twice, and then the
    breakdown is reported as not measured."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                float(tr.train_step(x, y)["loss"])
        kernels = [(e.key, e.self_device_time_total / steps / 1e3,
                    e.count / steps) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(ms for _, ms, _ in kernels)
        if busy_ms > 0:
            break
    else:
        log(f"{tag}: torch.profiler recorded no device time")
        emit({"profile": f"{tag}_bf16_224_train_step", "card": card,
              "step_p50_ms": step_ms, "device_busy_ms": None,
              "note": "torch.profiler recorded no device time: not measured"})
        return
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    for key, ms, _ in kernels:
        for name, needles in KERNEL_GROUPS:
            if any(n in key for n in needles):
                groups[name] += ms
                break
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit({"profile": f"{tag}_bf16_224_train_step", "card": card,
          "batch": TRAIN_BATCH, "step_p50_ms": step_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / step_ms),
          "kernel_launches": sum(c for _, _, c in kernels),
          "ms_by_group": groups,
          "top_kernels": [{"name": k[:120], "ms": ms, "launches": c}
                          for k, ms, c in top]})


def train(torch, card, k, tag):
    """Phase 4b-e: bf16 steps at TRAIN_BATCH, counted and timed; the
    profile; validate, counted. Returns the path's launch counts."""
    _, _, per_forward, per_step, steps = MODELS[tag]
    tr = make_trainer(torch, tag, "bf16", None)
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counts(k)
    for i in range(steps):
        before = counts(k)
        t = time.perf_counter()
        m = tr.train_step(x, y)
        loss = float(m["loss"])          # waits for the step
        times.append(time.perf_counter() - t)
        losses.append(loss)
        step_counts = {n: v - before[n] for n, v in counts(k).items()}
        if i == 0:
            expect_counts(f"{tag}: one bf16 training step", step_counts,
                          per_step)
        if step_counts != per_step:
            raise RuntimeError(f"{tag} step {i}: launches {step_counts}")
    peak = torch.cuda.max_memory_allocated()
    train_counts = counts(k)
    log(f"{tag} bf16 losses over {steps} steps at batch {TRAIN_BATCH}: "
        + " ".join(f"{v:.4f}" for v in losses))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag}: non-finite training loss: {losses}")
    # At the "normal" regime's lr 0.1 and momentum 0.9 the loss on one batch
    # falls for a few steps and then swings (the JAX trainer does the same on
    # a full-width ResNet-50 at 96x96 and batch 32 on the CPU); so the check
    # is that it falls below the first step's somewhere, and the mean of the
    # last five is reported beside it.
    if not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"{tag}: the loss never fell below the first "
                           f"step's {losses[0]}: {losses}")
    p50 = statistics.median(times[1:])
    STEP_P50_MS[tag] = p50 * 1e3
    emit({"train": f"{tag}_bf16_224", "card": card, "batch": TRAIN_BATCH,
          "steps": steps, "losses": losses,
          "last5_mean_loss": float(np.mean(losses[-5:])),
          "step_p50_ms": p50 * 1e3, "images_per_s": TRAIN_BATCH / p50,
          "max_memory_allocated_bytes": peak,
          "note": f"host clock around train_step, which ends with a read of "
                  f"the loss; p50 over steps 2-{steps}"})

    profile_step(torch, tag, tr, x, y, card, p50 * 1e3)

    reset_counts(k)
    t = time.perf_counter()
    val = tr.validate([(x, y)])
    val_s = time.perf_counter() - t
    val_counts = counts(k)
    expect_counts(f"{tag}: validate, one batch", val_counts, per_forward)
    if not np.isfinite(val["loss"]):
        raise RuntimeError(f"{tag}: validate loss is not finite: {val}")
    # a second pass reuses the weights' kernel layouts and folded BNs
    t = time.perf_counter()
    tr.validate([(x, y)])
    emit({"validate": f"{tag}_bf16_224", "card": card, "batch": TRAIN_BATCH,
          "first_ms": val_s * 1e3,
          "second_ms": (time.perf_counter() - t) * 1e3,
          "note": "host clock around Trainer.validate of one batch already "
                  "on the card"})
    log(f"{tag} validate: {val}")
    del tr
    torch.cuda.empty_cache()
    return add_counts(train_counts, val_counts), peak


def step_timed(torch, tr, x, y):
    """One training step, its metrics, its host-clock seconds (closed by the
    read of the loss) and its device ms (CUDA events recorded before and
    after it on the current stream)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    m = tr.train_step(x, y)
    end.record()
    m["loss"] = float(m["loss"])
    host_s = time.perf_counter() - t
    end.synchronize()
    m["device_ms"] = start.elapsed_time(end)
    return m, host_s


def train_large_lars(torch, card, k, peak_128):
    """Phase 4g: ResNet-50's "large_lars" regime (LARS, its polynomial lr
    with a 5-epoch warm-up) at batch 4096 in 32 chunks of 128, bf16, on one
    fixed random batch made on the card. Checks: finite losses; each step's
    lr is the regime's; 32 pool forwards and backwards a step; the peak
    memory less the batch's two copies (float32 and bf16) within
    LARGE_BATCH_PEAK_TOL of a batch-128 step's peak (``peak_128``). Returns
    the launch counts."""
    from convnet_tpu_torch.regimes import schedules
    per_step = {n: v * LARGE_BATCH_CHUNKS
                for n, v in MODELS["resnet50"][3].items()}
    tr = make_trainer(torch, "resnet50", "bf16", None,
                      {"chunk_batch": LARGE_BATCH_CHUNKS,
                       "label_smoothing": 0.1},
                      regime="large_lars", batch_size=LARGE_BATCH)
    steps_per_epoch = 1281167 // LARGE_BATCH
    lr_at = schedules.polynomial_lr(7.4 * LARGE_BATCH / 4096,
                                    90 * steps_per_epoch, power=2.0,
                                    warmup_steps=5 * steps_per_epoch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((LARGE_BATCH, 224, 224, 3), generator=gen,
                    device="cuda")
    y = torch.randint(0, 1000, (LARGE_BATCH,), generator=gen, device="cuda")
    batch_bytes = x.numel() * (4 + 2)        # float32 and its bf16 copy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(k)
    losses, lrs, times, device_ms = [], [], [], []
    for i in range(LARGE_BATCH_STEPS):
        tr.optim.update(tr.training_steps / steps_per_epoch,
                        tr.training_steps)
        before = counts(k)
        m, dt = step_timed(torch, tr, x, y)
        step_counts = {n: v - before[n] for n, v in counts(k).items()}
        expect_counts(f"resnet50 large_lars step {i}", step_counts, per_step)
        losses.append(m["loss"])
        lrs.append(m["lr"])
        times.append(dt)
        device_ms.append(m["device_ms"])
        if m["lr"] != lr_at(0, i) or abs(m["lr"] - 7.4 * (i + 1) / 1560) \
                > 1e-12:
            raise RuntimeError(f"large_lars step {i}: lr {m['lr']}, the "
                               f"regime's {lr_at(0, i)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"resnet50 large_lars losses {losses}, lr {lrs}, peak {peak}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"large_lars: non-finite loss: {losses}")
    if peak - batch_bytes > LARGE_BATCH_PEAK_TOL * peak_128:
        raise RuntimeError(f"large_lars: peak {peak} B less the batch's "
                           f"{batch_bytes} B is over {LARGE_BATCH_PEAK_TOL}"
                           f" x a batch-128 step's {peak_128} B")
    p50 = statistics.median(times[1:])
    emit({"train": "resnet50_large_lars_bf16_224", "card": card,
          "batch": LARGE_BATCH, "chunk_batch": LARGE_BATCH_CHUNKS,
          "steps": LARGE_BATCH_STEPS, "losses": losses, "lr": lrs,
          "step_ms": [t * 1e3 for t in times], "step_p50_ms": p50 * 1e3,
          "images_per_s": LARGE_BATCH / p50, "device_ms": device_ms,
          "max_memory_allocated_bytes": peak, "batch_bytes": batch_bytes,
          "batch128_step_peak_bytes": peak_128,
          "peak_less_batch_over_batch128_peak": (peak - batch_bytes)
          / peak_128,
          "note": "host clock around train_step, closed by a read of the "
                  f"loss; p50 over steps 2-{LARGE_BATCH_STEPS}; device_ms: "
                  "CUDA events before and after each step"})
    counted = counts(k)
    del tr, x, y
    torch.cuda.empty_cache()
    return counted


def train_batch_augmentation(torch, card, k):
    """Phase 4h: batch augmentation on ResNet-50 ("normal" regime, bf16):
    64 images a step, each in BATCH_AUG["duplicates"] copies
    (``augmented_copies``),
    mixup, label smoothing, the gradient-norm scale measured every
    BATCH_AUG["adapt_grad_norm"] steps, the weights' EMA; then ``validate``
    with the copies' logits averaged, ``calibrate_bn`` over 2 batches on the
    EMA weights and ``validate`` again. Checks: finite losses; the scale
    finite, positive and changed only at measuring steps; the BN statistics
    after a measuring step equal those right after its main forward (the
    measuring forward's update undone); launch counts; finite validate
    losses. Returns the launch counts."""
    per_step = MODELS["resnet50"][3]
    per_forward = MODELS["resnet50"][2]
    d = BATCH_AUG["duplicates"]
    tr = make_trainer(torch, "resnet50", "bf16", None, BATCH_AUG)
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(augmented_copies(rng.standard_normal(
        (BATCH_AUG_IMAGES, 224, 224, 3)).astype(np.float32), d)).cuda()
    y = torch.from_numpy(np.repeat(rng.integers(0, 1000, BATCH_AUG_IMAGES),
                                   d)).cuda()
    buffers = [b for _, b in tr.model.named_buffers()]
    after_forward = []
    hook = tr.model.register_forward_hook(
        lambda *_: after_forward.append([b.clone() for b in buffers]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(k)
    losses, scales, times, device_ms = [], [], [], []
    for i in range(BATCH_AUG_STEPS):
        measuring = tr.opt_state["step"] % BATCH_AUG["adapt_grad_norm"] == 0
        scale_before = float(tr.opt_state["agn_scale"])
        after_forward.clear()
        before = counts(k)
        m, dt = step_timed(torch, tr, x, y)
        step_counts = {n: v - before[n] for n, v in counts(k).items()}
        want = {n: v * (2 if measuring else 1) for n, v in per_step.items()}
        expect_counts(f"resnet50 batch augmentation step {i} (measuring: "
                      f"{measuring})", step_counts, want)
        scale = float(tr.opt_state["agn_scale"])
        losses.append(m["loss"])
        scales.append(scale)
        times.append(dt)
        device_ms.append(m["device_ms"])
        if not (np.isfinite(scale) and scale > 0):
            raise RuntimeError(f"batch augmentation step {i}: scale {scale}")
        if not measuring and scale != scale_before:
            raise RuntimeError(f"batch augmentation step {i}: the scale "
                               f"moved from {scale_before} to {scale} at a "
                               f"step that does not measure it")
        if measuring:
            main, extra = after_forward
            moved = any(not torch.equal(a, b) for a, b in zip(main, extra))
            kept = all(torch.equal(a, b) for a, b in zip(main, buffers))
            if not (moved and kept):
                raise RuntimeError(f"batch augmentation step {i}: the "
                                   f"measuring forward moved the BN "
                                   f"statistics: {moved}, and they were "
                                   f"restored: {kept}")
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    log(f"resnet50 batch augmentation losses {losses}, scales {scales}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"batch augmentation: non-finite loss: {losses}")
    train_counts = counts(k)

    reset_counts(k)
    val = tr.validate([(x, y)])
    tr.model.load_state_dict(tr.ema_state_dict())
    used = tr.calibrate_bn([(x, y), (x.flip(0), y)], num_steps=2)
    val_ema = tr.validate([(x, y)])
    want = {n: 2 * v for n, v in per_forward.items()}
    want["max_pool2d_fwd_idx"] += 2     # calibrate_bn's training forwards
    expect_counts("resnet50 validate, calibrate_bn (2 batches), validate",
                  counts(k), want)
    log(f"resnet50 batch augmentation validate {val}; after calibrate_bn "
        f"({used} batches) on the EMA weights {val_ema}")
    if used != 2 or not (np.isfinite(val["loss"])
                         and np.isfinite(val_ema["loss"])):
        raise RuntimeError(f"batch augmentation: validate {val}, "
                           f"{val_ema}, calibrate_bn used {used} batches")
    p50 = statistics.median(times[1:])
    emit({"train": "resnet50_batch_augmentation_bf16_224", "card": card,
          "images": BATCH_AUG_IMAGES, "batch": len(x), "features": BATCH_AUG,
          "steps": BATCH_AUG_STEPS, "losses": losses, "agn_scale": scales,
          "step_ms": [t * 1e3 for t in times], "step_p50_ms": p50 * 1e3,
          "images_per_s": len(x) / p50, "device_ms": device_ms,
          "max_memory_allocated_bytes": peak,
          "validate": val, "validate_ema_calibrated": val_ema,
          "note": "host clock around train_step, closed by a read of the "
                  f"loss; p50 over steps 2-{BATCH_AUG_STEPS}, measuring and "
                  "cached steps alike; device_ms: CUDA events before and "
                  "after each step"})
    counted = add_counts(train_counts, counts(k))
    del tr, x, y
    torch.cuda.empty_cache()
    return counted


def check_remat_steps(torch, stats_plain, cpu_steps):
    """Phase 4i, float32: each remat variant's step at CHECK_BATCH on the
    card against the unwrapped model's step on the CPU from the same
    weights (STEP_TOL), and its BN statistics against the unwrapped model's
    step on the card (``stats_plain``, from phase 4a) within
    REMAT_STATS_TOL of each tensor's largest value. ``cpu_steps`` holds
    phase 4a's CPU step of the unwrapped ResNet-50."""
    for variant, remat in REMAT.items():
        stats = check_step_against_cpu(torch, "resnet50",
                                       card_model={"remat": remat},
                                       cpu_steps=cpu_steps)
        err = max(((stats[n] - b).abs().max()
                   / b.abs().max().clamp_min(1e-30)).item()
                  for n, b in stats_plain.items())
        emit({"check": "remat_bn_statistics_card", "remat": variant,
              "dtype": "float32", "batch": CHECK_BATCH,
              "max_rel_err_vs_unwrapped": err, "tol": REMAT_STATS_TOL})
        if err > REMAT_STATS_TOL:
            raise RuntimeError(f"remat {variant}: BN statistics {err} from "
                               f"the unwrapped step's: updated twice?")


def train_remat(torch, card, k):
    """Phase 4i: ResNet-50 in bf16 at TRAIN_BATCH on phase 4b's batch,
    REMAT_STEPS steps each of the plain model, remat of every stage and of
    ``layer1`` alone, in one run: step p50 (host clock and CUDA events) and
    peak memory. Checks finite losses and one pool launch each way a step.
    Returns the remat variants' launch counts."""
    per_step = MODELS["resnet50"][3]
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda()
    counted = launches()
    res = {}
    for variant in ("plain", *REMAT):
        overrides = {} if variant == "plain" else {"remat": REMAT[variant]}
        tr = make_trainer(torch, "resnet50", "bf16", None, **overrides)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(k)
        losses, times, device_ms = [], [], []
        for i in range(REMAT_STEPS):
            before = counts(k)
            m, dt = step_timed(torch, tr, x, y)
            step_counts = {n: v - before[n] for n, v in counts(k).items()}
            expect_counts(f"resnet50 remat {variant} step {i}", step_counts,
                          per_step)
            losses.append(m["loss"])
            times.append(dt)
            device_ms.append(m["device_ms"])
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"remat {variant}: non-finite loss: {losses}")
        if variant != "plain":
            counted = add_counts(counted, counts(k))
        res[variant] = {"losses": losses,
                        "step_ms": [t * 1e3 for t in times],
                        "step_p50_ms": statistics.median(times[1:]) * 1e3,
                        "device_ms": device_ms,
                        "device_p50_ms": statistics.median(device_ms[1:]),
                        "max_memory_allocated_bytes": peak}
        log(f"resnet50 remat {variant}: p50 {res[variant]['step_p50_ms']:.2f}"
            f" ms, device {res[variant]['device_p50_ms']:.2f} ms, peak "
            f"{peak / 1e9:.2f} GB")
        del tr
        torch.cuda.empty_cache()
    base = res["plain"]
    for variant in REMAT:
        r = res[variant]
        r["step_over_plain"] = r["step_p50_ms"] / base["step_p50_ms"]
        r["device_over_plain"] = r["device_p50_ms"] / base["device_p50_ms"]
        r["peak_over_plain"] = (r["max_memory_allocated_bytes"]
                                / base["max_memory_allocated_bytes"])
    emit({"train": "resnet50_remat_bf16_224", "card": card,
          "batch": TRAIN_BATCH, "steps": REMAT_STEPS, **res,
          "note": "host clock around train_step, closed by a read of the "
                  f"loss; p50 over steps 2-{REMAT_STEPS}; device_ms: CUDA "
                  "events before and after each step; the three models in "
                  "one run"})
    del x, y
    return counted


def _trainer_tensors(tr):
    """A trainer's weights, BN statistics and optimizer slots, in order."""
    out = list(tr.model.state_dict().values())
    for slot, v in tr.opt_state.items():
        if isinstance(v, list):
            out += v
    return out


def _distance(a, b):
    """The norm of (a − b) over the norm of a, over every tensor."""
    num = sum((x.double() - y.double()).square().sum() for x, y in zip(a, b))
    den = sum(x.double().square().sum() for x in a)
    return float((num / den).sqrt())


def cifar_resume(torch, card, tag, name, config, tmp):
    """Phase 4j for one CIFAR model: an epoch of CIFAR_BATCHES fixed random
    batches (bf16, the model's regime, a watcher); the same epoch with a
    checkpoint saved in the background after batch CIFAR_SAVE_AT (that run
    is a second uninterrupted run); a fresh Trainer that loads it and runs
    ``train_epoch(start_batch=CIFAR_SAVE_AT)``. The resumed run's weights,
    BN statistics and optimizer state must equal the first run's bit for
    bit; should the second uninterrupted run differ from the first (an op
    without a deterministic form), the resumed run may differ by no more
    than it. The watcher files hold CIFAR_BATCHES and CIFAR_BATCHES −
    CIFAR_SAVE_AT lines with the reference's keys. Then
    ``Predictor.from_checkpoint`` of the first run's final checkpoint
    answers requests of 64, 17 and 1 in bf16, and in float32 a request of
    64, against the trainer's model in eval in float32 on the same images
    (tolerances: the comment above WATCH_KEYS); the trainer's own bf16
    eval forward's distance from it is reported beside them."""
    from convnet_tpu_torch import models
    from convnet_tpu_torch.data.preprocess import DATASET_STATS
    from convnet_tpu_torch.regimes.optim import OptimRegime
    from convnet_tpu_torch.serve import Predictor
    from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
    from convnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                    save_checkpoint,
                                                    wait_for_pending_save)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    loader = [(torch.randn((CIFAR_BATCH, 32, 32, 3), generator=gen,
                           device="cuda"),
               torch.randint(0, 10, (CIFAR_BATCH,), generator=gen,
                             device="cuda"))
              for _ in range(CIFAR_BATCHES)]

    def trainer():
        model = models.build(name, **config)
        tr = Trainer(model, OptimRegime(model.regime), model.fc.out_features,
                     TrainerConfig(dtype="bf16", print_freq=0), seed=SEED)
        tr.initialize()
        return tr

    ckdir = os.path.join(tmp, tag)
    saves = []

    def hook(tr, batch_idx):
        if batch_idx == CIFAR_SAVE_AT:
            t = time.perf_counter()
            save_checkpoint(tr.checkpoint_dict(batch_idx=batch_idx,
                                               model=name, config=config),
                            False, ckdir, background=True)
            saves.append(time.perf_counter() - t)

    runs, results, watch = [], [], []
    for i, kw in enumerate(({}, {"step_hook": hook},
                            {"start_batch": CIFAR_SAVE_AT})):
        tr = trainer()
        if "start_batch" in kw:
            wait_for_pending_save()
            tr.load_checkpoint(load_checkpoint(ckdir))
        path = os.path.join(tmp, f"{tag}_{i}.jsonl")
        tr.set_watcher(path)
        results.append(tr.train_epoch(loader, 0, **kw))
        tr.set_watcher(None)
        with open(path) as f:
            watch.append([json.loads(line) for line in f])
        runs.append(tr)
    first, second, resumed = (_trainer_tensors(t) for t in runs)
    exact = all(torch.equal(a, b) for a, b in zip(first, resumed))
    repeat_exact = all(torch.equal(a, b) for a, b in zip(first, second))
    d_resumed, d_repeat = _distance(first, resumed), _distance(first, second)
    want_steps = [list(range(1, CIFAR_BATCHES + 1)), None,
                  list(range(CIFAR_SAVE_AT + 1, CIFAR_BATCHES + 1))]
    for lines, steps in zip(watch, want_steps):
        if steps and ([line["step"] for line in lines] != steps
                      or any(set(line) != WATCH_KEYS for line in lines)):
            raise RuntimeError(f"{tag}: watcher lines {lines[:2]}..., "
                               f"{len(lines)} of them")
    losses = [line["loss"] for line in watch[0]]
    if not (all(np.isfinite(losses)) and runs[2].training_steps
            == runs[0].training_steps == CIFAR_BATCHES):
        raise RuntimeError(f"{tag}: losses {losses}, steps "
                           f"{[t.training_steps for t in runs]}")
    if not exact and (repeat_exact or d_resumed > d_repeat):
        raise RuntimeError(f"{tag}: the resumed run is {d_resumed} from the "
                           f"uninterrupted one; a second uninterrupted run "
                           f"{d_repeat}")

    final = os.path.join(tmp, f"{tag}_final")
    save_checkpoint(runs[0].checkpoint_dict(model=name, config=config),
                    False, final)
    pred = Predictor.from_checkpoint(final, batch_size=SERVE_BATCH)
    images = np.random.default_rng(SEED + 6).integers(
        0, 256, (SERVE_BATCH, 32, 32, 3), np.uint8)
    logits = [pred(images[:n]) for n in REQUESTS]
    pred32 = Predictor.from_checkpoint(final, batch_size=SERVE_BATCH,
                                       dtype="float32")(images)
    stats = DATASET_STATS["cifar10"]
    model = runs[0].model.eval()
    with torch.no_grad():
        xf = torch.from_numpy(images).cuda().float() / 255.0
        xf = ((xf - torch.tensor(stats["mean"], device="cuda"))
              / torch.tensor(stats["std"], device="cuda"))
        ref = model(xf).float().cpu().numpy()
        ref_bf16 = model(xf.bfloat16()).float().cpu().numpy()
    errs = {"served_bf16": rel_err(logits[0], ref),
            "served_float32": rel_err(pred32, ref),
            "trainer_bf16_eval": rel_err(ref_bf16, ref)}
    pad = max(float(np.abs(out - logits[0][:n]).max())
              for n, out in zip(REQUESTS[1:], logits[1:]))
    shapes_ok = all(out.shape == (n, 10) and np.isfinite(out).all()
                    for n, out in zip(REQUESTS, logits))
    probe = loader[0]
    step_kernels = kernel_launches(
        torch, lambda: float(runs[0].train_step(*probe)["loss"]))
    rec = {"train": f"{tag}_bf16_32_resume", "card": card,
           "model": [name, config], "batch": CIFAR_BATCH,
           "batches": CIFAR_BATCHES, "saved_after": CIFAR_SAVE_AT,
           "resume_bit_exact": exact, "repeat_bit_exact": repeat_exact,
           "resumed_distance": d_resumed, "repeat_distance": d_repeat,
           "watcher_lines": [len(w) for w in watch],
           "losses": losses,
           "step_p50_ms": results[0]["step_time_p50"] * 1e3,
           "images_per_s": CIFAR_BATCH / results[0]["step_time_p50"],
           "data_time_ms": results[0]["data_time"] * 1e3,
           "resumed_step_p50_ms": results[2]["step_time_p50"] * 1e3,
           "step_cuda_kernels": step_kernels,
           "background_save_ms": [t * 1e3 for t in saves],
           "logits_rel_err_vs_trainer_float32": errs,
           "tol": SERVE_TOL, "served_padding_max_diff": pad,
           "note": "step times: host clock around each step (optimizer "
                   "update, train_step, step hook); the metrics are read two "
                   "steps late, so a step's time is mostly its launches; "
                   "step_cuda_kernels: torch.profiler over one more step"}
    emit(rec)
    if (not shapes_ok or errs["served_bf16"] > SERVE_TOL["bf16"]
            or errs["served_float32"] > SERVE_TOL["float32"]
            or pad > PAD_TOL):
        raise RuntimeError(f"{tag}: serving from the checkpoint: errors "
                           f"{errs}, padding {pad}, shapes ok {shapes_ok}")
    log(f"{tag}: resume bit-exact {exact} (a repeat {repeat_exact}); "
        f"served from the checkpoint: {errs}")


def train_cifar_resume(torch, card, k):
    """Phase 4j for both CIFAR models, with cuDNN deterministic and its
    autotuner off for the phase. The CIFAR ResNets reach no kernel (no max
    pool, no stride-1 1x1 ConvBN): their launch counts must stay 0.
    Returns them."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    reset_counts(k)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for tag, (name, config) in CIFAR_MODELS.items():
                cifar_resume(torch, card, tag, name, config, tmp)
                torch.cuda.empty_cache()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    expect_counts("the CIFAR models: training, resume and serving",
                  counts(k), launches())
    return counts(k)


class CliProbe:
    """For in-process CLI runs: CUDA events around each
    ``Trainer.train_step`` (wrapped for the runs, then put back), each
    ``train_epoch``'s results, the data loaders' log lines (the decoder
    each took), and the batch-``CLI_SAVE_AT`` checkpoint copied aside as
    ``keep``."""

    def __init__(self, torch, keep=None):
        from convnet_tpu_torch.train.trainer import Trainer
        from convnet_tpu_torch.utils import checkpoint as ckpt_io
        self.torch, self.cls, self.ckpt_io, self.keep = (torch, Trainer,
                                                         ckpt_io, keep)
        self.events, self.epochs, self.messages = [], [], []

    def __enter__(self):
        import logging
        torch, probe = self.torch, self
        step, epoch = self.cls.train_step, self.cls.train_epoch
        save = self.ckpt_io.save_checkpoint

        def train_step(tr, x, y):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(tr, x, y)
            end.record()
            probe.events.append((start, end))
            return m

        def train_epoch(tr, *a, **kw):
            probe.epochs.append(epoch(tr, *a, **kw))
            return probe.epochs[-1]

        def save_checkpoint(ckpt, *a, **kw):
            out = save(ckpt, *a, **kw)
            if probe.keep and ckpt.get("batch_idx") == CLI_SAVE_AT:
                probe.ckpt_io.wait_for_pending_save()
                os.makedirs(os.path.dirname(probe.keep), exist_ok=True)
                import shutil
                shutil.copyfile(out, probe.keep)
            return out

        handler = logging.Handler()
        handler.emit = lambda record: probe.messages.append(
            record.getMessage())
        self.handler = handler
        self.saved = step, epoch, save
        logging.getLogger("convnet_tpu_torch.data.loader").addHandler(handler)
        self.cls.train_step, self.cls.train_epoch = train_step, train_epoch
        self.ckpt_io.save_checkpoint = save_checkpoint
        return self

    def __exit__(self, *exc):
        import logging
        self.cls.train_step, self.cls.train_epoch = self.saved[:2]
        self.ckpt_io.save_checkpoint = self.saved[2]
        logging.getLogger("convnet_tpu_torch.data.loader").removeHandler(
            self.handler)

    def device_ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _cli_rows(save_dir):
    with open(os.path.join(save_dir, "results.json")) as f:
        return json.load(f)


def _same_checkpoints(ckpt_io, a, b):
    """Whether two checkpoints' weights, BN statistics and optimizer state
    are bit-equal, and the largest difference."""
    ca, cb = ckpt_io.load_checkpoint(a), ckpt_io.load_checkpoint(b)
    worst, same = 0.0, True
    for tree in ("params", "state", "opt_state"):
        fa = ckpt_io.flatten_tree(ca[tree])
        fb = ckpt_io.flatten_tree(cb[tree])
        if fa.keys() != fb.keys():
            return False, float("inf")
        for key in fa:
            x = np.asarray(fa[key], np.float64)
            y = np.asarray(fb[key], np.float64)
            same = same and np.array_equal(x, y)
            if x.size:
                worst = max(worst, float(np.abs(x - y).max()))
    return same, worst


def write_image_folder(root):
    """CLI_FOLDER's JPEG ImageFolder: smooth seeded images plus noise,
    PIL-encoded (quality 90) by a thread pool, in train/ and val/ with a
    folder a class."""
    from PIL import Image
    rng = np.random.default_rng(SEED + 7)
    h, w, classes = CLI_FOLDER["h"], CLI_FOLDER["w"], CLI_FOLDER["classes"]
    files, images = {}, []
    for split in ("train", "val"):
        files[split] = []
        for i in range(CLI_FOLDER[split]):
            c = i % classes
            low = rng.integers(0, 256, (8, 10, 3)).astype(np.int16)
            img = np.kron(low, np.ones((h // 8, w // 10, 1), np.int16))
            img += rng.integers(-24, 25, img.shape, dtype=np.int16)
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            files[split].append(os.path.join(d, f"im{i:04d}.jpg"))
            images.append(np.clip(img, 0, 255).astype(np.uint8))
    paths = files["train"] + files["val"]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda a: Image.fromarray(a[1]).save(a[0], quality=90),
                      zip(paths, images)))
    return files


def train_cli(torch, card, k):
    """Phase 4k: ``convnet_tpu_torch.cli.main.main`` in process, cuDNN
    deterministic. (1) ResNet-50 on synthetic_imagenet, bf16, batch
    CLI_BATCH, one epoch of CLI_STEPS steps and a validate of 16 batches,
    ``--save-freq CLI_SAVE_AT``: one pool launch each way a step, 33 fused
    1x1 launches and one pool forward a validate forward; step p50 (host
    clock and CUDA events), img/s, data_time's share, beside phase 4b's
    step. A second run ``--resume``s from the batch-8 checkpoint: its final
    weights, BN statistics and optimizer state must equal the first run's
    bit for bit. ``--evaluate`` of the final checkpoint: its loss within
    the bf16 serving tolerance of the run's last validation. (2) ResNet-50
    on an ImageFolder of JPEGs: the decoder the loader took, the native
    eval decode against PIL's (1 LSB), and ``predict_jpeg`` on CLI_PREDICT
    files against ``Predictor.__call__`` on the same decoded batch. (3)
    ResNet-20 on synthetic (the card-resident ArrayBatcher, the device
    flip and pad-crop; no kernel). Returns the phase's launch counts."""
    from convnet_tpu_torch.cli.main import main as cli_main
    from convnet_tpu_torch.data import native
    from convnet_tpu_torch.data.data_regime import DataRegime
    from convnet_tpu_torch.data.preprocess import scale_crop_host
    from convnet_tpu_torch.serve import Predictor, predict_jpeg
    from convnet_tpu_torch.utils import checkpoint as ckpt_io
    from PIL import Image
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    total = launches()
    seconds = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")

    def run(tag, argv, want, keep=None):
        reset_counts(k)
        t = time.perf_counter()
        with CliProbe(torch, keep) as probe:
            out = cli_main(argv + ["--results-dir", tmp, "--save", tag,
                                   "--print-freq", "0",
                                   "--seed", str(SEED)])
        seconds[tag] = time.perf_counter() - t
        expect_counts(f"cli {tag}", counts(k), want)
        torch.cuda.empty_cache()
        return out, probe

    rn50 = ["--model", "resnet", "--model-config", "{'depth': 50}",
            "--dtype", "bf16", "--epochs", "1"]
    try:
        # (1) ResNet-50 on synthetic_imagenet, saved, resumed, evaluated
        imagenet = rn50 + ["--dataset", "synthetic_imagenet",
                           "-b", str(CLI_BATCH)]
        mid = os.path.join(tmp, "mid", "checkpoint.npz")
        val_batches = 2048 // CLI_BATCH
        _, probe = run("full", imagenet + ["--save-freq", str(CLI_SAVE_AT),
                                           "--tensorwatch"],
                       launches(33 * val_batches, CLI_STEPS + val_batches,
                                CLI_STEPS), keep=mid)
        res = probe.epochs[0]
        device_ms = probe.device_ms()
        rows = _cli_rows(os.path.join(tmp, "full"))
        with open(os.path.join(tmp, "full", "watch.jsonl")) as f:
            data_ms = [json.loads(line)["data_time"] * 1e3 for line in f]
        left = CLI_STEPS - CLI_SAVE_AT
        run("resumed", imagenet + ["--resume", mid],
            launches(33 * val_batches, left + val_batches, left))
        exact, worst = _same_checkpoints(
            ckpt_io, os.path.join(tmp, "full", "checkpoint.npz"),
            os.path.join(tmp, "resumed", "checkpoint.npz"))
        resumed_rows = _cli_rows(os.path.join(tmp, "resumed"))
        ev, _ = run("evaluate", imagenet + [
            "--evaluate", os.path.join(tmp, "full", "checkpoint.npz")],
            launches(33 * val_batches, val_batches))
        total = add_counts(total, launches(
            3 * 33 * val_batches, CLI_STEPS + left + 3 * val_batches,
            CLI_STEPS + left))
        val_loss = rows[-1]["val_loss"]
        share = res["data_time"] / (res["data_time"] + res["step_time"])
        rec = {"train": "cli_resnet50_synthetic_imagenet_bf16", "card": card,
               "batch": CLI_BATCH, "steps": CLI_STEPS,
               "step_p50_ms": res["step_time_p50"] * 1e3,
               "step_device_p50_ms": statistics.median(device_ms[1:]),
               "phase_4b_step_p50_ms": STEP_P50_MS.get("resnet50"),
               "images_per_s": res["img_per_sec"],
               "data_time_ms": res["data_time"] * 1e3,
               "data_time_share": share,
               "data_time_first_ms": data_ms[0],
               "data_time_p50_ms": statistics.median(data_ms[1:]),
               "data_time_max_ms": max(data_ms[1:]),
               "train_loss": rows[-1]["train_loss"], "val_loss": val_loss,
               "val_prec1": rows[-1]["val_prec1"],
               "resumed_val_loss": resumed_rows[-1]["val_loss"],
               "resume_bit_exact": exact, "resume_max_abs_diff": worst,
               "evaluate_loss": ev["loss"],
               "note": "step times: train_epoch's host clock around each "
                       "step (the metrics are read two steps late) and CUDA "
                       "events around each train_step, p50 over steps "
                       f"2-{CLI_STEPS}; data_time: the host time from one "
                       "step's end to the next's start (the loader's); its "
                       "share: data_time / (data_time + step_time), means "
                       "over the epoch; the watcher's per-step data_time: "
                       "the first step's, and p50 and max over the rest"}
        emit(rec)
        if not (np.isfinite(val_loss) and np.isfinite(rows[-1]["train_loss"])
                and np.isfinite(ev["loss"])):
            raise RuntimeError(f"cli: non-finite losses {rec}")
        if not exact:
            raise RuntimeError(f"cli: the resumed run ends {worst} from the "
                               f"uninterrupted one, not bit-equal")
        if abs(ev["loss"] - val_loss) > SERVE_TOL["bf16"] * abs(val_loss):
            raise RuntimeError(f"cli: --evaluate loss {ev['loss']} against "
                               f"the run's last validation {val_loss}")
        log(f"cli ResNet-50: step p50 {rec['step_p50_ms']:.2f} ms host, "
            f"{rec['step_device_p50_ms']:.2f} ms device (phase 4b "
            f"{rec['phase_4b_step_p50_ms']}), {res['img_per_sec']:.1f} "
            f"img/s, data_time share {share:.3f} (p50 "
            f"{rec['data_time_p50_ms']:.2f} ms, first {data_ms[0]:.1f} ms); "
            f"resume bit-exact {exact}")
        DataRegime._dataset_cache.clear()

        # (2) ResNet-50 on an ImageFolder of JPEGs
        t = time.perf_counter()
        files = write_image_folder(os.path.join(tmp, "folder"))
        seconds["write_folder"] = time.perf_counter() - t
        steps = CLI_FOLDER["train"] // CLI_FOLDER_BATCH
        val_b = CLI_FOLDER["val"] // CLI_FOLDER_BATCH
        _, probe = run("folder", rn50 + [
            "--dataset", "imagenet", "--datasets-dir",
            os.path.join(tmp, "folder"), "-b", str(CLI_FOLDER_BATCH)],
            launches(33 * val_b, steps + val_b, steps))
        total = add_counts(total, launches(33 * val_b, steps + val_b, steps))
        decoders = sorted({m for m in probe.messages
                           if m.startswith("data loader:")})
        status = native.jpeg_status()
        log(f"cli ImageFolder: {decoders}; the JPEG decoder: {status}")
        blobs = []
        for path in files["val"]:
            with open(path, "rb") as f:
                blobs.append(f.read())
        pil = np.stack([scale_crop_host(Image.open(p), None, out_size=224)
                        for p in files["val"]])
        lsb = None
        decoded = pil
        if status == "native":
            out, fail = native.decode_blobs(blobs, train=False, out_size=224)
            diff = np.abs(out.astype(np.int16) - pil.astype(np.int16))
            lsb = {"max": int(diff.max()), "equal_share":
                   float((diff == 0).mean()), "failed": int(fail.sum())}
            if fail.any() or diff.max() > 1 or lsb["equal_share"] < LSB_SHARE:
                raise RuntimeError(f"cli: native eval decode against PIL: "
                                   f"{lsb}")
            decoded = out
        reset_counts(k)
        pred = Predictor.from_checkpoint(os.path.join(tmp, "folder"),
                                         batch_size=SERVE_BATCH)
        top = predict_jpeg(pred, blobs[:CLI_PREDICT])
        want = pred(decoded[:CLI_PREDICT]).argmax(-1)
        expect_counts("cli predict_jpeg and __call__", counts(k),
                      launches(66, 2))
        total = add_counts(total, launches(66, 2))
        emit({"cli_folder": "resnet50_imagefolder_bf16", "card": card,
              "files": {s: len(v) for s, v in files.items()},
              "image_hw": [CLI_FOLDER["h"], CLI_FOLDER["w"]],
              "loader_decoders": decoders, "jpeg_decoder": status,
              "native_vs_pil_eval_decode": lsb,
              "predict_jpeg_top1": top.tolist(),
              "predict_jpeg_matches_call": bool((top == want).all())})
        if not (top == want).all():
            raise RuntimeError(f"cli: predict_jpeg {top} against "
                               f"Predictor.__call__ {want}")
        del pred

        # (3) ResNet-20 on synthetic: no kernel
        run("cifar", ["--dataset", "synthetic", "--model", "resnet",
                      "--model-config", "{'depth': 20}", "--dtype", "bf16",
                      "--epochs", "1", "-b", str(CLI_BATCH)], launches())
        rows = _cli_rows(os.path.join(tmp, "cifar"))
        emit({"cli_cifar": "resnet20_synthetic_bf16", "card": card,
              "results": rows[-1]})
        if not np.isfinite(rows[-1]["val_loss"]):
            raise RuntimeError(f"cli: ResNet-20 {rows}")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        DataRegime._dataset_cache.clear()
        import logging
        import shutil
        for h in list(logging.getLogger().handlers):
            logging.getLogger().removeHandler(h)
            h.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"cli_seconds": seconds})
    return total


def kernel_launches(torch, fn):
    """CUDA kernels (not copies or sets) that one call of ``fn`` launches,
    counted by torch.profiler; None where it recorded no device event (not
    measured: its CUPTI tracing now and then records nothing)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    return n or None


def serve(torch, card, k, tag, predictor, images):
    """Phase 3 for one model: requests of 64, 17 and 1 images, counted and
    checked; logits against the CPU's float32 forward; timings. Returns the
    launch counts of the requests."""
    from convnet_tpu_torch.serve import Predictor
    name, config, per_forward = MODELS[tag][:3]
    reset_counts(k)
    t = time.perf_counter()
    logits = [predictor.predict_logits(images[:n]) for n in REQUESTS]
    serve_s = time.perf_counter() - t
    serve_counts = counts(k)
    log(f"{tag}: served {REQUESTS} images in {serve_s:.3f}s")
    expect_counts(f"{tag} serving", serve_counts,
                  {n: v * len(REQUESTS) for n, v in per_forward.items()})
    for n, out in zip(REQUESTS, logits):
        if out.shape != (n, 1000) or not np.isfinite(out).all():
            raise RuntimeError(f"{tag}: bad logits for a request of {n}: "
                               f"shape {out.shape}, finite "
                               f"{np.isfinite(out).all()}")
    for n, out in zip(REQUESTS[1:], logits[1:]):
        diff = float(np.abs(out - logits[0][:n]).max())
        log(f"{tag}: request of {n}: max |padded - full-batch| logit diff "
            f"{diff:.3g}")
        if diff > PAD_TOL:
            raise RuntimeError(f"{tag}: padding changed the answers: {diff}")

    ref_n = 2
    cpu_ref = Predictor(name, config, dtype="float32", batch_size=ref_n,
                        device="cpu", seed=SEED).predict_logits(images[:ref_n])
    card_f32 = Predictor(name, config, dtype="float32", batch_size=ref_n,
                         seed=SEED).predict_logits(images[:ref_n])
    errs = {}
    for dname, out in (("bf16", logits[0][:ref_n]), ("float32", card_f32)):
        errs[dname] = rel_err(out, cpu_ref)
        log(f"{tag}: card {dname} logits vs CPU float32 forward: max |diff| "
            f"/ max |ref| = {errs[dname]:.3g} (tolerance {SERVE_TOL[dname]})")
        if errs[dname] > SERVE_TOL[dname]:
            raise RuntimeError(f"{tag}: {dname} logits disagree with the CPU "
                               f"reference: {errs[dname]}")

    times = []
    for _ in range(20):
        t = time.perf_counter()
        predictor.predict_logits(images)
        times.append(time.perf_counter() - t)
    p50 = statistics.median(times)
    single = Predictor(name, config, dtype="bf16", batch_size=1, seed=SEED)
    one = images[:1]
    # CUDA kernels per batch-1 forward: the first call makes the weights'
    # kernel layouts and the folded BNs, later calls reuse them
    kernels_1 = {when: kernel_launches(torch, lambda: single.predict_logits(
        one)) for when in ("first", "later")}
    log(f"{tag}: CUDA kernels a batch-1 forward launches, first call / "
        f"later: {kernels_1['first']} / {kernels_1['later']}")
    for _ in range(3):
        single.predict_logits(one)
    lat = []
    for _ in range(50):
        t = time.perf_counter()
        single.predict_logits(one)
        lat.append(time.perf_counter() - t)
    emit({"serve": f"{tag}_bf16_224", "card": card,
          "batch64_p50_ms": p50 * 1e3,
          "images_per_s": SERVE_BATCH / p50,
          "batch1_p50_ms": statistics.median(lat) * 1e3,
          "batch1_cuda_kernels": kernels_1,
          "logits_rel_err_vs_cpu_float32": errs,
          "note": "host clock around predict_logits, H2D and D2H included"})
    return serve_counts


def main():
    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    import types
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from convnet_tpu_torch.ops.kernels import _build
    from convnet_tpu_torch.ops.kernels import depthwise_conv as dc
    from convnet_tpu_torch.ops.kernels import grouped_conv as gc
    from convnet_tpu_torch.ops.kernels import matmul_fused as mf
    from convnet_tpu_torch.ops.kernels import max_pool as mp
    from convnet_tpu_torch.ops.kernels import mbconv as mb
    from convnet_tpu_torch.serve import Predictor
    k = types.SimpleNamespace(mf=mf, mp=mp, gc=gc, dc=dc, mb=mb)
    # full float32 in matmuls and convs: the float32 checks compare exactly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    # -- 1. card and build
    t0 = t = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # the CPU halves of phase 4a's float32 steps run on the host's cores
    # while nvcc builds; phase 4a waits for them
    cpu_steps = {}
    cpu_pool = concurrent.futures.ThreadPoolExecutor(1)
    cpu_job = cpu_pool.submit(lambda: [
        cpu_step(torch, cpu_steps, tag, features, duplicates, **overrides)
        for tag, features, duplicates, overrides in CPU_CHECKS])
    cpu_pool.shutdown(wait=False)
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 2) as pool:
        builds = {name: pool.submit(_build.build, name) for name in KERNELS}
        # the input pipeline's host libraries (g++): dataio must build;
        # jpegdec needs libjpeg, and without it the loader takes PIL
        hosts = {name: pool.submit(_build.build_host, name)
                 for name in _build.HOST_LINK}
    for name, job in builds.items():
        lib, build_log = job.result()
        log(f"built {lib.name}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    for name, job in hosts.items():
        try:
            lib, _ = job.result()
            log(f"built {lib.name} (host, g++)")
        except RuntimeError as e:
            if name == "dataio":
                raise
            log(f"host library {name} not built, the loader decodes with "
                f"PIL: " + " | ".join(str(e).splitlines()[:4]))
    log(f"built {len(KERNELS)} libraries in {time.perf_counter() - t:.1f}s")
    seconds["build"] = time.perf_counter() - t

    # -- 2. the models, their paths' shapes, and the kernel checks
    t = time.perf_counter()
    predictors, path = {}, {}
    images = None
    for tag, (name, config, per_forward, _, _) in MODELS.items():
        predictors[tag] = Predictor(name, config, dtype="bf16",
                                    batch_size=SERVE_BATCH, seed=SEED)
        size = predictors[tag].input_size
        if images is None:
            images = np.random.default_rng(SEED).integers(
                0, 256, (SERVE_BATCH, size, size, 3), np.uint8)
        path[tag] = path_shapes(torch, predictors[tag], images)
        found = sum(path[tag].values())
        log(f"{tag} {size}x{size}: {found} fused-route ConvBNs per forward "
            f"over {len(path[tag])} distinct (M, K, N, act)")
        if found != per_forward["conv1x1_bn_act"]:
            raise RuntimeError(f"{tag}: expected "
                               f"{per_forward['conv1x1_bn_act']} fused-route "
                               f"ConvBNs, found {found}")
    fused, fused_err, fused_variants = check_matmul_fused(torch, path)
    log("conv1x1_bn_act agrees with its plain version at every shape")
    pool = check_max_pool(torch)
    log("the pool kernels agree with their plain versions at every shape")
    grouped = check_grouped(torch)
    log("grouped_conv2d agrees with its plain version at every shape")
    depthwise = check_depthwise(torch)
    log("depthwise_conv2d agrees with its plain version at every shape")
    mb_path = mbconv_shapes(torch, predictors["mobilenet_v2"], images)
    if sum(mb_path.values()) != MODELS["mobilenet_v2"][2]["mbconv_full"]:
        raise RuntimeError(f"mobilenet_v2: fused blocks per forward "
                           f"{mb_path}, expected 13")
    mbconv = check_mbconv(torch, mb_path)
    log("the MBConv kernels agree with their plain versions at every shape")
    seconds["kernels"] = time.perf_counter() - t

    # -- 3. serve: the main path, counted, model by model
    t = time.perf_counter()
    serve_counts = launches()
    for tag in MODELS:
        serve_counts = add_counts(serve_counts, serve(
            torch, card, k, tag, predictors.pop(tag), images))
        torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t

    # -- 4. train: the second path, counted, model by model
    t = time.perf_counter()
    cpu_job.result()
    stats = [check_step_against_cpu(torch, tag, features, duplicates,
                                     cpu_steps=cpu_steps, **overrides)
             for tag, features, duplicates, overrides in CPU_CHECKS]
    stats_plain = stats[0]
    train_counts = launches()
    peaks = {}
    for tag in MODELS:
        counted, peaks[tag] = train(torch, card, k, tag)
        train_counts = add_counts(train_counts, counted)
    torch.cuda.synchronize()
    seconds["train"] = time.perf_counter() - t

    # -- 4g, 4h. the large-batch LARS and batch-augmentation paths
    t = time.perf_counter()
    path_counts = {"large_batch_lars": train_large_lars(
        torch, card, k, peaks["resnet50"])}
    seconds["large_batch_lars"] = time.perf_counter() - t
    t = time.perf_counter()
    path_counts["batch_augmentation"] = train_batch_augmentation(
        torch, card, k)
    seconds["batch_augmentation"] = time.perf_counter() - t

    # -- 4i, 4j. remat; the CIFAR ResNets, resume and serving from a
    # checkpoint
    t = time.perf_counter()
    check_remat_steps(torch, stats_plain, cpu_steps)
    path_counts["remat"] = train_remat(torch, card, k)
    seconds["remat"] = time.perf_counter() - t
    t = time.perf_counter()
    path_counts["cifar_resume"] = train_cifar_resume(torch, card, k)
    seconds["cifar_resume"] = time.perf_counter() - t

    # -- 4k. the CLI: datasets, loaders, checkpoints, resume, JPEGs
    t = time.perf_counter()
    path_counts["cli"] = train_cli(torch, card, k)
    seconds["cli"] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    emit({"seconds_by_phase": seconds})

    # -- 5. summary
    # every row: ms, back-to-back wrapper calls timed with CUDA events (the
    # wrapper's weight casts and copies included); kernel_ms, the kernel
    # alone (its launches replayed from a CUDA graph); launches, the serving,
    # the training, the large-batch LARS, the batch-augmentation, the remat,
    # the CIFAR and the CLI runs together
    by_path = {"serve": serve_counts, "train": train_counts, **path_counts}

    def row(name, source, replaces, ms, kernel_ms, plain_ms, bound_ms,
            bound_by, library_ms, library_call, max_err, times_are, **more):
        return {"name": name, "route": "cuda",
                "source": f"convnet_tpu_torch/csrc/{source}",
                "replaces": f"convnet_tpu/ops/pallas/{replaces}",
                "launches": sum(c[name] for c in by_path.values()),
                "launches_by_path": {path: c[name]
                                     for path, c in by_path.items()},
                "max_abs_err": max_err, "ms": ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_call": library_call,
                "times_are": times_are, **more}

    rn = fused["resnet50"]
    rows = [row("conv1x1_bn_act", "matmul_fused.cu", "matmul_fused.py:50",
                rn["ms"], rn["kernel_ms"], rn["plain_ms"], rn["bound_ms"],
                rn["bound_by"], rn["library_ms"],
                "torch.addmm(shift, x, w * scale), no activation", fused_err,
                f"sum over the 33 launches of one batch-{SERVE_BATCH} bf16 "
                f"ResNet-50 forward",
                variants_at_path_shapes=fused_variants,
                per_forward_by_model={
                    tag: {key: v[key] for key in ("ms", "kernel_ms",
                                                  "plain_ms", "library_ms",
                                                  "bound_ms")}
                    for tag, v in fused.items()})]
    for name, replaces, also, library in (
            ("max_pool2d_fwd_idx", "pool.py:169", [],
             "F.max_pool2d(..., return_indices=True), channels-last"),
            ("max_pool2d_bwd", "pool.py:272",
             ["convnet_tpu/ops/pallas/pool_bwd.py:120"],
             "aten.max_pool2d_with_indices_backward, channels-last")):
        pr = pool[name]
        more = ({"variants_at_path_shapes": pr["variants"]}
                if name == "max_pool2d_bwd" else {})
        rows.append(row(name, "max_pool.cu", replaces, pr["ms"],
                        pr["kernel_ms"], pr["plain_ms"], pr["bound_ms"],
                        pr["bound_by"], pr["library_ms"], library,
                        pr["max_abs_err"],
                        f"one call at the ResNet-50 stem, batch "
                        f"{TRAIN_BATCH}, bf16; both stems under shapes",
                        also_replaces=also, shapes=pr["shapes"], **more))
    for name, source, replaces, res, model in (
            ("grouped_conv2d", "grouped_conv.cu", "grouped.py:83", grouped,
             "ResNeXt-50 32x4d"),
            ("depthwise_conv2d", "depthwise_conv.cu", "depthwise.py:62",
             depthwise, "MobileNet v1")):
        rows.append(row(name, source, replaces, res["ms"], res["kernel_ms"],
                        res["plain_ms"], res["bound_ms"], res["bound_by"],
                        res["library_ms"],
                        "F.conv2d(..., groups=) on the channels-last view",
                        res["max_abs_err"],
                        f"sum over the launches of one batch-{SERVE_BATCH} "
                        f"bf16 {model} forward", shapes=res["shapes"],
                        variants_at_path_shapes=res["variants"]))
    for mode, batch, what in (("full", SERVE_BATCH, "forward"),
                              ("stats", TRAIN_BATCH, "training step"),
                              ("raw", TRAIN_BATCH, "training step")):
        res = mbconv[mode]
        rows.append(row(
            f"mbconv_{mode}", "mbconv.cu",
            {"full": "mbconv.py:180", "stats": "mbconv.py:310",
             "raw": "mbconv.py:246"}[mode],
            res["ms"], res["kernel_ms"], res["plain_ms"], res["bound_ms"],
            res["bound_by"], res["library_ms"],
            "the unfused chain: addmm, clamp, F.conv2d(groups=C) on the "
            "channels-last view, scale and shift, clamp, then "
            + ("addmm (+ x)" if mode == "full" else
               "the sums" if mode == "stats" else "matmul and the sums"),
            res["max_abs_err"],
            f"sum over the 13 launches of one batch-{batch} bf16 "
            f"MobileNet-V2 {what}", shapes=res["shapes"],
            variants_at_path_shapes=res["variants"],
            tensor_core_floor_ms=res["tensor_core_floor_ms"]))
    emit({"kernels": rows})
    faulthandler.cancel_dump_traceback_later()
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
