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

Flags of what the port does not have yet raise ``NotImplementedError``
when given a non-default value: multi-device and multi-host training
(``--num-devices`` > 1, ``--sync-bn``, ``--shard-opt-state``, ``--spatial``
> 1, ``--allreduce-dtype``, ``--dist-*``; ROADMAP.md §1 item 10) and
float16 compute (``--dtype float16``/``fp16``; item 11). ``--impl``,
``--flat-optim`` and ``--compile-cache`` are XLA knobs: parsed, logged, and
without effect here (on the card every kernel of the path runs by its
shape rule).
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
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
    # parallelism (not ported yet: non-default values raise)
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel degree (one card only so far)")
    p.add_argument("--sync-bn", action="store_true",
                   help="cross-replica BatchNorm statistics (not ported)")
    p.add_argument("--shard-opt-state", action="store_true",
                   help="ZeRO-1 optimizer-state sharding (not ported)")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial-partitioning degree (not ported)")
    p.add_argument("--allreduce-dtype", default=None,
                   choices=["bf16", "fp16"],
                   help="gradient all-reduce dtype (not ported)")
    p.add_argument("--flat-optim", action="store_true",
                   help="an XLA knob of the JAX package; no effect here")
    p.add_argument("--dist-init", default=None,
                   help="multi-host coordinator address (not ported)")
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
    multi = {"--num-devices": (args.num_devices or 1) > 1,
             "--sync-bn": args.sync_bn,
             "--shard-opt-state": args.shard_opt_state,
             "--spatial": args.spatial > 1,
             "--allreduce-dtype": args.allreduce_dtype is not None,
             "--dist-init": args.dist_init is not None,
             "--dist-rank": args.dist_rank != 0,
             "--dist-world-size": args.dist_world_size != 1}
    given = [flag for flag, on in multi.items() if on]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: multi-device training is not ported yet "
            f"(ROADMAP.md §1 item 10); the port trains on one card")
    if str(args.dtype).lower() in ("float16", "fp16"):
        raise NotImplementedError(
            f"--dtype {args.dtype}: float16 compute is not ported yet "
            f"(ROADMAP.md §1 item 11); use bf16 or float32")


def _resolve_device(name):
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    return torch.device(name)


def main(argv=None):
    from convnet_tpu_torch import models
    from convnet_tpu_torch.core.module import param_count
    from convnet_tpu_torch.data.data_regime import DataRegime
    from convnet_tpu_torch.regimes.optim import OptimRegime
    from convnet_tpu_torch.regimes.regime import (rescale_regime_lr,
                                                  replace_regime_key)
    from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
    from convnet_tpu_torch.utils import checkpoint as ckpt_io
    from convnet_tpu_torch.utils.log import (ResultsLog,
                                             export_args_namespace,
                                             setup_logging)
    from convnet_tpu_torch.utils.misc import set_global_seeds

    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = _resolve_device(args.device)

    save_name = args.save or datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    save_path = os.path.join(args.results_dir, save_name)
    os.makedirs(save_path, exist_ok=True)
    setup_logging(os.path.join(save_path, "log.txt"), resume=bool(args.resume))
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
    log.info("device: %s%s", device,
             f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
    cfg = TrainerConfig(
        dtype=args.dtype, mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
        label_smoothing=args.label_smoothing, grad_clip=args.grad_clip,
        loss_scale=args.loss_scale, chunk_batch=args.chunk_batch,
        duplicates=args.duplicates, adapt_grad_norm=args.adapt_grad_norm,
        model_ema=args.model_ema, average_output=args.duplicates > 1,
        print_freq=args.print_freq)
    trainer = Trainer(model, optim, num_classes, cfg, device=device,
                      seed=args.seed)
    if args.model_ema > 0:
        log.info("model EMA enabled (decay %.4g): validation and "
                 "model_best use the averaged weights", args.model_ema)
    if args.tensorwatch:
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
    defaults = {
        "name": args.dataset, "split": "train",
        "batch_size": args.batch_size, "num_workers": args.workers,
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
                            defaults=defaults, seed=args.seed, device=device)
    eval_bs = args.eval_batch_size if args.eval_batch_size > 0 else args.batch_size
    eval_defaults = {**defaults, "split": "val", "augment": False,
                     "batch_size": eval_bs, "multicrop": args.multicrop,
                     "duplicates":
                     args.duplicates if cfg.average_output else 1}
    val_data = DataRegime(getattr(model, "data_eval_regime", None),
                          defaults=eval_defaults, seed=args.seed,
                          device=device)

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
    results = ResultsLog(save_path, title=f"{args.model} on {args.dataset}")
    if args.resume:
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
        if args.profile and epoch == start_epoch:
            profiler = _start_profile()
        step_hook = None
        if args.save_freq:
            def step_hook(tr, batch_idx, _epoch=epoch):
                if batch_idx % args.save_freq:
                    return
                ckpt_io.save_checkpoint(
                    tr.checkpoint_dict(**meta(epoch=_epoch,
                                              batch_idx=batch_idx)),
                    False, save_path, background=True)
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
        ckpt_io.save_checkpoint(
            trainer.checkpoint_dict(**meta(epoch=epoch)), is_best, save_path,
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
