"""The command-line trainer (counterpart of convnet_tpu/cli/main.py):

    python -m convnet_tpu_torch.cli.main --model resnet --dataset imagenet \\
        --model-config "{'depth': 50}" -b 128 --dtype bf16

The same flags, names and defaults as the JAX package's ``main.py``, plus
``--device {cuda,cpu}`` (default ``cuda``; without a card it raises, and it
never drops to the CPU by itself). The flow: parse → seeds → the model (its
config restored from a checkpoint's meta) with its embedded regime →
``OptimRegime`` with the flags' overrides → ``Trainer`` → train and eval
``DataRegime`` → the epoch loop with checkpoints, mid-epoch saves
(``--save-freq``) and resume, validation and the results log. The
``Trainer`` holds the weights, BN statistics and optimizer state wherever
the JAX CLI threads ``params, state, opt_state``.

Data parallelism as in the JAX CLI: ``--num-devices`` (default: every
local card; 1 with ``--device cpu``) is the number of local ranks. At one
rank the run stays in this process, as on one device; above, one process
a card is spawned (``torch.multiprocessing``, each on its card, NCCL; with
``--device cpu`` that many CPU processes over gloo). Multi-host:
``--dist-init tcp://host:port`` (the rendezvous), ``--dist-rank`` (this
host's index) and ``--dist-world-size`` (the number of hosts); every host
runs the command with its own ``--dist-rank``, and the global rank is
``host · local ranks + local rank`` (``parallel/mesh.py``). ``-b`` is the
batch of one host (the JAX package's process), split over its local ranks:
on one host the global batch; each rank loads ``b / local ranks`` samples
a step from its share of the epoch's order (``perm[rank::world]``, the JAX
multi-host layout with one device a process): the union of a step's samples
is the global batch a single-host JAX mesh takes, but under per-replica BN
the samples that share a BN are those of the multi-host grouping, not the
single-host mesh's contiguous split. Validation scores every sample once
whatever the world: the evaluation loaders pad the shorter shares with
rows labelled -100 (``data/loader.py``). ``--sync-bn``,
``--shard-opt-state`` and ``--allreduce-dtype`` reach ``TrainerConfig``;
at one rank, as in the JAX CLI, there is no mesh and they change nothing.
Only rank 0 logs to the run's files and writes ``results`` and the
checkpoints; every rank takes part in the collectives of saving,
validation and BN calibration.

Flags of what the port does not have yet raise ``NotImplementedError``:
``--spatial`` > 1 (ROADMAP.md §1 item 10) and float16 compute (``--dtype
float16``/``fp16``; item 11). ``--impl``, ``--flat-optim`` and
``--compile-cache`` are XLA knobs: parsed, logged, and without effect here
(on the card every kernel of the path runs by its shape rule).
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import shutil
import tempfile
from datetime import datetime

import torch

log = logging.getLogger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description="convnet_tpu_torch training")
    # data
    p.add_argument("--dataset", default="imagenet")
    p.add_argument("--datasets-dir", default=os.environ.get(
        "CONVNET_TPU_DATA", os.path.expanduser("~/datasets")))
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--autoaugment", action="store_true")
    p.add_argument("--no-augment", action="store_true",
                   help="disable training-time augmentation")
    p.add_argument("--cutout", action="store_true")
    p.add_argument("--duplicates", type=int, default=1,
                   help="batch augmentation: times each sample appears")
    p.add_argument("--multicrop", action="store_true",
                   help="deterministic multi-crop TTA at eval "
                        "(use with --duplicates 5 or 10)")
    # model
    p.add_argument("--model", default=None,
                   help="model factory name (default resnet; with "
                        "--resume/--evaluate and no explicit --model, "
                        "restored from the checkpoint's recorded "
                        "model + config)")
    p.add_argument("--model-config", default="",
                   help="python-literal dict merged into model factory kwargs")
    # training
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--eval-batch-size", type=int, default=-1)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--optimizer", default=None,
                   help="override the model regime's optimizer in EVERY "
                        "phase (the embedded schedule never reverts it)")
    p.add_argument("--lr", type=float, default=None,
                   help="rescale the model regime's WHOLE lr schedule "
                        "multiplicatively so the base (epoch-0) lr "
                        "becomes this value")
    p.add_argument("--momentum", type=float, default=None,
                   help="override the model regime's momentum in EVERY "
                        "phase")
    p.add_argument("--weight-decay", type=float, default=None,
                   help="override the model regime's (decoupled) weight "
                        "decay value in EVERY phase")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--mixup", type=float, default=0.0, help="mixup alpha")
    p.add_argument("--cutmix", type=float, default=0.0, help="cutmix alpha")
    p.add_argument("--chunk-batch", type=int, default=1,
                   help="micro-batches per step (gradient accumulation)")
    p.add_argument("--grad-clip", type=float, default=-1.0)
    p.add_argument("--adapt-grad-norm", type=int, default=None)
    p.add_argument("--dtype", default="float32",
                   help="compute dtype policy: float32|bf16|half "
                        "(float16 is not ported yet)")
    p.add_argument("--loss-scale", type=float, default=1.0)
    p.add_argument("--model-ema", type=float, default=0.0,
                   help="EMA decay for averaged weights (e.g. 0.999); "
                        "validation uses the EMA copy")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train: the CUDA card (default; raises "
                        "without one) or the CPU")
    # parallelism
    p.add_argument("--num-devices", type=int, default=None,
                   help="local data-parallel ranks (default: all local "
                        "cards; 1 with --device cpu)")
    p.add_argument("--sync-bn", action="store_true",
                   help="cross-replica BatchNorm statistics")
    p.add_argument("--shard-opt-state", action="store_true",
                   help="ZeRO-1: shard optimizer moments over the data "
                        "axis (reduce-scatter grads, all-gather params)")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial-partitioning degree (not ported)")
    p.add_argument("--allreduce-dtype", default=None,
                   choices=["bf16", "fp16"],
                   help="cast gradients for the all-reduce (grads are "
                        "re-cast after)")
    p.add_argument("--flat-optim", action="store_true",
                   help="an XLA knob of the JAX package; no effect here")
    p.add_argument("--dist-init", default=None,
                   help="multi-host rendezvous address tcp://host:port")
    p.add_argument("--dist-rank", type=int, default=0)
    p.add_argument("--dist-world-size", type=int, default=1)
    p.add_argument("--impl", default="xla", choices=["xla", "pallas"],
                   help="the JAX package's kernel switch; no effect here "
                        "(the card runs every kernel of the path)")
    # bookkeeping
    p.add_argument("--results-dir", default="./results")
    p.add_argument("--save", default="",
                   help="experiment save name (default: timestamp)")
    p.add_argument("--resume", default="", help="checkpoint path to resume")
    p.add_argument("--evaluate", default="",
                   help="evaluate checkpoint path and exit")
    p.add_argument("--import-torch", default="", metavar="PATH",
                   help="initialize weights from a PyTorch reference "
                        "checkpoint (.pth/.pth.tar state_dict)")
    p.add_argument("--calibrate-bn", action="store_true")
    p.add_argument("--absorb-bn", action="store_true",
                   help="fold BN into convs before evaluation")
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--save-all", action="store_true")
    p.add_argument("--save-freq", type=int, default=0, metavar="N",
                   help="also checkpoint every N training steps (resume "
                        "continues mid-epoch, bit-exact)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first epoch "
                        "to <save>/profile")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd anomaly detection (debug runs)")
    p.add_argument("--tensorwatch", action="store_true",
                   help="stream per-step telemetry to results/<save>/watch.jsonl")
    p.add_argument("--compile-cache", default=os.environ.get(
                       "CONVNET_TPU_COMPILE_CACHE", ""), metavar="DIR",
                   help="the JAX package's XLA compilation cache; no effect "
                        "here")
    return p


def _refuse_unported(args):
    """NotImplementedError for a flag of what the port lacks."""
    if args.spatial > 1:
        raise NotImplementedError(
            f"--spatial {args.spatial}: spatial partitioning is not ported "
            f"yet (ROADMAP.md §1 item 10); the port is data-parallel only")
    if str(args.dtype).lower() in ("float16", "fp16"):
        raise NotImplementedError(
            f"--dtype {args.dtype}: float16 compute is not ported yet "
            f"(ROADMAP.md §1 item 11); use bf16 or float32")


def _resolve_device(name):
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    return torch.device(name)


def _local_ranks(args):
    """The number of local ranks: ``--num-devices``, by default every local
    card (one CPU process with ``--device cpu``). More than the visible
    cards raises."""
    if args.device == "cpu":
        n = args.num_devices or 1
    else:
        visible = torch.cuda.device_count()
        n = args.num_devices or visible
        if n > visible:
            raise ValueError(f"--num-devices {n}: {visible} visible cards")
    if n < 1:
        raise ValueError(f"--num-devices {n}")
    return n


def main(argv=None):
    """Parses ``argv`` and trains (or evaluates); returns the results,
    which every rank shares."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = _resolve_device(args.device)
    local = _local_ranks(args)
    if not 0 <= args.dist_rank < args.dist_world_size:
        raise ValueError(f"--dist-rank {args.dist_rank} of "
                         f"--dist-world-size {args.dist_world_size}")
    if args.dist_world_size > 1 and not args.dist_init:
        raise ValueError("--dist-world-size > 1 needs --dist-init")
    if local == 1 and not args.dist_init:
        return _train(args, device, None, 0)
    init, tmp = args.dist_init, None
    if init is None:
        # one host: a rendezvous file in a directory of its own
        tmp = tempfile.mkdtemp(prefix="convnet_tpu_torch_dist_")
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
    try:
        if local == 1:
            return _run_rank(0, args, init, 1, None)
        import torch.multiprocessing as mp
        results = mp.get_context("spawn").SimpleQueue()
        mp.start_processes(_run_rank, args=(args, init, local, results),
                           nprocs=local, join=True, start_method="spawn")
        return results.get()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _run_rank(local_rank, args, init, local, results):
    """One rank: joins the process group, trains on the mesh (none at a
    world of one, as in the JAX CLI), leaves the group; the host's local
    rank 0 puts its results on ``results``, which the host's launcher
    reads."""
    import torch.distributed as dist

    from convnet_tpu_torch.parallel import init_distributed, make_mesh
    if args.device == "cpu" and local > 1:
        # the local ranks share the threads one process would take
        torch.set_num_threads(max(1, torch.get_num_threads() // local))
    rank, world = init_distributed(
        init, device_type=args.device, host=args.dist_rank,
        hosts=args.dist_world_size, local_rank=local_rank, local_world=local)
    try:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if args.device == "cuda" else torch.device("cpu"))
        mesh = make_mesh(world, args.device) if world > 1 else None
        res = _train(args, device, mesh, rank)
        if local_rank == 0 and results is not None:
            results.put(res)
        return res
    finally:
        dist.destroy_process_group()


def _train(args, device, mesh, rank):
    """The run on this rank: ``mesh`` None for one device."""
    from convnet_tpu_torch import models
    from convnet_tpu_torch.core.module import param_count
    from convnet_tpu_torch.data.data_regime import DataRegime
    from convnet_tpu_torch.parallel import local_batch_size
    from convnet_tpu_torch.regimes.optim import OptimRegime
    from convnet_tpu_torch.regimes.regime import (rescale_regime_lr,
                                                  replace_regime_key)
    from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
    from convnet_tpu_torch.utils import checkpoint as ckpt_io
    from convnet_tpu_torch.utils.log import (ResultsLog,
                                             export_args_namespace,
                                             setup_logging)
    from convnet_tpu_torch.utils.misc import set_global_seeds

    world = 1 if mesh is None else mesh.size()
    main_rank = rank == 0
    save_name = args.save or datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    save_path = os.path.join(args.results_dir, save_name)
    if main_rank:
        os.makedirs(save_path, exist_ok=True)
        setup_logging(os.path.join(save_path, "log.txt"),
                      resume=bool(args.resume))
        export_args_namespace(args, os.path.join(save_path, "args.json"))
        log.info("saving to %s", save_path)
    for flag, value, default in (("--impl", args.impl, "xla"),
                                 ("--flat-optim", args.flat_optim, False),
                                 ("--compile-cache", args.compile_cache, "")):
        if value != default:
            log.info("%s %s: an XLA knob of the JAX package, no effect on "
                     "the port", flag, value)

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    set_global_seeds(args.seed)

    # ---- model (embedded regime) ------------------------------------
    model_config = ast.literal_eval(args.model_config) if args.model_config else {}
    if args.resume or args.evaluate:
        # checkpoints are self-describing: adopt the recorded model, config
        # and input size unless the flags name them
        try:
            meta = ckpt_io.peek_checkpoint_meta(args.resume or args.evaluate)
        except Exception:
            meta = {}  # torch / missing file: surfaced at load time
        if args.input_size is None and meta.get("input_size"):
            args.input_size = int(meta["input_size"])
            log.info("input size restored from checkpoint: %d",
                     args.input_size)
        if meta.get("model"):
            if args.model is None or args.model == meta["model"]:
                if args.model is None:
                    args.model = meta["model"]
                merged = dict(meta.get("config") or {})
                merged.update(model_config)  # explicit entries win
                model_config = merged
                log.info("model restored from checkpoint: %s %s",
                         args.model, model_config)
            else:
                log.warning("--model %s != checkpoint's recorded model "
                            "%s — the load will fail unless the "
                            "architectures match", args.model,
                            meta["model"])
    args.model = args.model or "resnet"
    model_config.setdefault("dataset", args.dataset)
    if args.dataset.startswith("synthetic") and "dataset" in model_config:
        model_config["dataset"] = ("cifar10" if "imagenet" not in args.dataset
                                   else "imagenet")
    model = models.build(args.model, **model_config)
    log.info("created model %s (%s), config %s", args.model,
             type(model).__name__, model_config)

    regime = list(getattr(model, "regime", [{"epoch": 0, "optimizer": "SGD",
                                             "lr": 0.1, "momentum": 0.9}]))
    if args.lr is not None:
        regime = rescale_regime_lr(regime, args.lr)
    flat = {}
    if args.optimizer:
        flat["optimizer"] = args.optimizer
    if args.momentum is not None:
        flat["momentum"] = args.momentum
    if args.weight_decay is not None:
        flat["regularizer"] = {"name": "WeightDecay",
                               "value": args.weight_decay}
    for key, value in flat.items():
        regime = replace_regime_key(regime, key, value)
    optim = OptimRegime(regime)

    num_classes = {"cifar10": 10, "cifar100": 100, "mnist": 10,
                   "imagenet": 1000}.get(args.dataset, None)
    if num_classes is None:
        num_classes = model_config.get("num_classes", 10 if "imagenet" not in
                                       args.dataset else 1000)

    # ---- trainer ----------------------------------------------------
    log.info("device: %s%s, %d rank(s)%s", device,
             f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "", world,
             f" over {torch.distributed.get_backend()}" if mesh else "")
    cfg = TrainerConfig(
        dtype=args.dtype, mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
        label_smoothing=args.label_smoothing, grad_clip=args.grad_clip,
        loss_scale=args.loss_scale, chunk_batch=args.chunk_batch,
        duplicates=args.duplicates, adapt_grad_norm=args.adapt_grad_norm,
        model_ema=args.model_ema, average_output=args.duplicates > 1,
        sync_bn=args.sync_bn, shard_opt_state=args.shard_opt_state,
        allreduce_dtype=args.allreduce_dtype, print_freq=args.print_freq)
    trainer = Trainer(model, optim, num_classes, cfg, device=device,
                      seed=args.seed, mesh=mesh)
    if args.model_ema > 0:
        log.info("model EMA enabled (decay %.4g): validation and "
                 "model_best use the averaged weights", args.model_ema)
    if args.tensorwatch and main_rank:
        trainer.set_watcher(os.path.join(save_path, "watch.jsonl"))

    if args.import_torch:
        from convnet_tpu_torch.utils.torch_import import (
            import_torch_state_dict, read_torch_checkpoint)
        sd, meta = read_torch_checkpoint(args.import_torch)
        trainer.initialize(import_torch_state_dict(sd, trainer.model))
        log.info("imported torch checkpoint '%s' (epoch %s, best_prec1 %s)",
                 args.import_torch, meta.get("epoch"),
                 meta.get("best_prec1"))
    else:
        trainer.initialize()
    log.info("number of parameters: %d", param_count(trainer.model))

    best_prec1 = 0.0
    start_epoch = args.start_epoch
    start_batch = 0
    if args.resume or args.evaluate:
        ckpt_path = args.resume or args.evaluate
        ckpt = ckpt_io.load_checkpoint(ckpt_path)
        trainer.load_checkpoint(ckpt)
        if args.resume and not ckpt.get("streams"):
            log.info("the checkpoint carries no generator states of the "
                     "port (a JAX package checkpoint): dropout and mixup "
                     "draw from --seed %d", args.seed)
        best_prec1 = float(ckpt.get("best_prec1", 0.0))
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        # a --save-freq checkpoint carries batch_idx: resume INSIDE that
        # epoch (the loaders are epoch-seeded, so the skipped batches
        # replay identically)
        batch_idx = int(ckpt.get("batch_idx", 0) or 0)
        if args.resume and batch_idx:
            start_epoch = int(ckpt["epoch"])
            start_batch = batch_idx
        log.info("loaded checkpoint '%s' (epoch %s%s)", ckpt_path,
                 ckpt.get("epoch"),
                 f", batch {batch_idx}" if batch_idx else "")

    # ---- data regimes (the model may author its own) ------------------
    def rank_batch(b):
        # -b is one host's batch: the mesh's is that of every host
        if mesh is None:
            return b
        return local_batch_size(b * args.dist_world_size, mesh)

    defaults = {
        "name": args.dataset, "split": "train",
        "batch_size": rank_batch(args.batch_size),
        "num_workers": args.workers,
        "data_dir": args.datasets_dir, "duplicates": args.duplicates,
        "autoaugment": args.autoaugment,
        "cutout": {"length": 8} if args.cutout else None,
    }
    if args.no_augment:
        defaults["augment"] = False
    if args.input_size:
        defaults["input_size"] = args.input_size
    in_channels = getattr(model, "in_channels", 3)
    if args.dataset.startswith("synthetic") and in_channels != 3:
        # a model of other than 3 input channels (the MNIST net's 1) gets a
        # synthetic dataset of its channels at its input size
        defaults["dataset_kwargs"] = {"channels": in_channels,
                                      "image_size": model.input_size}
    train_data = DataRegime(getattr(model, "data_regime", None),
                            defaults=defaults, seed=args.seed, device=device,
                            process_index=rank, process_count=world)
    eval_bs = args.eval_batch_size if args.eval_batch_size > 0 else args.batch_size
    eval_defaults = {**defaults, "split": "val", "augment": False,
                     "batch_size": rank_batch(eval_bs),
                     "multicrop": args.multicrop,
                     "duplicates":
                     args.duplicates if cfg.average_output else 1}
    val_data = DataRegime(getattr(model, "data_eval_regime", None),
                          defaults=eval_defaults, seed=args.seed,
                          device=device, process_index=rank,
                          process_count=world)

    # ---- BN folding / evaluate-only ---------------------------------
    if args.absorb_bn:
        from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn
        search_absorb_bn(trainer.model)
        log.info("folded BatchNorm into conv weights")

    if args.evaluate:
        if args.calibrate_bn:
            trainer.calibrate_bn(train_data.get_loader())
        results = trainer.validate(val_data.get_loader())
        log.info("evaluate: loss %.4f prec1 %.3f prec5 %.3f",
                 results["loss"], results["prec1"], results["prec5"])
        return results

    # ---- the epoch loop ---------------------------------------------
    results = (ResultsLog(save_path, title=f"{args.model} on {args.dataset}")
               if main_rank else None)
    if args.resume and main_rank:
        # a resumed run appends to the previous curves, without the rows of
        # epochs it trains again
        results.load()
        results.rows = [r for r in results.rows
                        if int(r.get("epoch", -1)) < start_epoch]

    def meta(**more):
        return {"model": args.model, "config": model_config,
                "input_size": args.input_size, "best_prec1": best_prec1,
                **more}

    for epoch in range(start_epoch, args.epochs):
        train_data.set_epoch(epoch, trainer.training_steps)
        profiler = None
        if args.profile and epoch == start_epoch and main_rank:
            profiler = _start_profile()
        step_hook = None
        if args.save_freq:
            def step_hook(tr, batch_idx, _epoch=epoch):
                if batch_idx % args.save_freq:
                    return
                # a collective on a mesh: every rank gathers, rank 0 writes
                ckpt = tr.checkpoint_dict(**meta(epoch=_epoch,
                                                 batch_idx=batch_idx))
                if main_rank:
                    ckpt_io.save_checkpoint(ckpt, False, save_path,
                                            background=True)
        train_res = trainer.train_epoch(
            train_data.get_loader(), epoch,
            start_batch=start_batch if epoch == start_epoch else 0,
            step_hook=step_hook)
        if profiler is not None:
            _stop_profile(profiler, os.path.join(save_path, "profile"))

        val_data.set_epoch(epoch)
        # with --model-ema, validation (and model_best) use the averaged
        # weights: the copy that would be served
        val_res = _validate(trainer, val_data.get_loader())

        is_best = val_res["prec1"] > best_prec1
        best_prec1 = max(val_res["prec1"], best_prec1)
        ckpt = trainer.checkpoint_dict(**meta(epoch=epoch))
        if not main_rank:
            continue
        ckpt_io.save_checkpoint(ckpt, is_best, save_path,
                                save_all=args.save_all, background=True)

        log.info("epoch %d: train loss %.4f prec1 %.2f | val loss %.4f "
                 "prec1 %.2f prec5 %.2f | best %.2f | step p50 %.1f ms",
                 epoch, train_res["loss"], train_res["prec1"],
                 val_res["loss"], val_res["prec1"], val_res["prec5"],
                 best_prec1, 1e3 * train_res["step_time_p50"])
        results.add(epoch=epoch,
                    train_loss=train_res["loss"], val_loss=val_res["loss"],
                    train_prec1=train_res["prec1"], val_prec1=val_res["prec1"],
                    train_prec5=train_res["prec5"], val_prec5=val_res["prec5"],
                    step_time_p50=train_res["step_time_p50"],
                    data_time=train_res["data_time"],
                    epoch_time=train_res["epoch_time"],
                    img_per_sec=train_res["img_per_sec"],
                    lr=optim.hyperparams()["lr"])
        results.plot("epoch", ["train_loss", "val_loss"], "loss", "loss")
        results.plot("epoch", ["train_prec1", "val_prec1"], "top-1", "%")
        results.save()
    trainer.set_watcher(None)
    ckpt_io.wait_for_pending_save()
    return {"best_prec1": best_prec1}


def _validate(trainer, loader):
    """``trainer.validate``; under ``model_ema`` on the averaged weights,
    the trained ones put back after."""
    ema = trainer.ema_state_dict()
    if ema is None:
        return trainer.validate(loader)
    trained = {k: v.detach().clone()
               for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(ema)
    try:
        return trainer.validate(loader)
    finally:
        trainer.model.load_state_dict(trained)


def _start_profile():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.start()
        return prof
    except Exception as e:       # tracing may be unsupported
        log.warning("profiler unavailable: %s", e)
        return None


def _stop_profile(prof, out_dir):
    try:
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profile of the first epoch: %s", path)
    except Exception as e:
        log.warning("profiler stop failed: %s", e)


if __name__ == "__main__":
    main()
