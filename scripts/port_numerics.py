"""How closely float32 (and bf16) can hold the port's ResNet-50 training step
to the JAX package's, on the CPU.

Prints the figures that set the tolerances of tests/test_torch_port_train.py
and of the float32 card-against-CPU check in chip_smoke.py:

  sensitivity   narrow ResNet-50 (width 8..64, batch 4, 32x32, train mode):
                how far a 1e-7 relative change of the input moves the logits,
                and the third free-running step's loss (the port alone)
  jax           the same net under the JAX Trainer (Pallas pool, interpret
                mode) and the port's Trainer, each port step started from the
                JAX state: loss, update and BN-statistics differences
  bf16_step     one bf16 step of both trainers from the same weights
  bf16          the bf16 forward and backward of three blocks, port against
                JAX (op by op), and each against the port's float32 block
  float64       full-width ResNet-50, batch 4, 224x224: the port's float32
                step against the same step in float64 (with the JAX
                package's variance formula and with a two-pass one)
  oscillation   full-width ResNet-50, batch 32, 96x96, bf16, "normal" regime:
                20 steps on one batch under both trainers
  resnext       the narrow ResNeXt of tests/test_torch_port_models.py
                (width 64..512, 16 groups) at 32x32 with batch 4 and 8:
                how far a 1e-7 input change moves the train-mode logits,
                the port's float32 step against its float64 step, and the
                port's three steps against the JAX trainer's (each from the
                JAX state): loss, updates in norm (all, worst tensor), worst
                element over its tensor's largest update, BN statistics
  mobilenet     MobileNet v1 at width 0.25, 32x32, batch 2, 4 and 8: one
                float32 step's loss, the port's float32 against its float64,
                and the port's against the JAX trainer's
  mobilenet_v2  the narrow MobileNet-V2 of tests/test_torch_port_mobilenet_v2
                (width 0.25, dropout 0, RMSprop) at 64x64 with batch 4, 8
                and 16: one float32 step, the port's against its float64 step
                and against the JAX trainer's: loss, updates in norm (all;
                worst tensor, each tensor's error over its update's norm plus
                1e-4 of all updates' norm, since some BN shifts feed a BN
                and have a zero gradient), BN statistics
  trainer_features
                the cases of tests/test_torch_port_trainer_features.py (the
                narrow ResNet-50 under chunk_batch, the large_lars regime,
                duplicates with adapt_grad_norm, model_ema, mixup, cutmix,
                the SGD-to-RMSprop regime), each step from the JAX trainer's
                state: the port's float32 step against its float64 step and
                against the JAX step: loss, updates in norm (all; worst
                tensor over its update's norm plus 1e-4 of all updates'
                norm), worst element over its tensor's largest update, BN
                statistics, the gradient-norm scale
  trainer_features_float64
                the chunked and the mixup step at 64x64, batch 8, where the
                port's float32 is within 1e-4 of its float64 but the JAX
                step is not: the JAX trainer under a float64 policy with its
                BatchNorm in float64 too, against the port's float64 step
                and the JAX float32 step (run this part alone: it turns on
                JAX's 64-bit mode for the rest of the process)
  cifar_se      the nets of tests/test_torch_port_cifar_se.py (ResNet-20 on
                CIFAR-10 and CIFAR-100, a narrow SE-ResNet-50 and an SE
                ResNet-20, 32x32) at batch 8 and 16: each port step from the
                JAX trainer's state against its float64 step and against the
                JAX step (loss, updates in norm: all, worst tensor over its
                update's norm plus 1e-4 of all updates' norm; BN statistics);
                the eval logits; the SE blocks alone in float32 and bf16
  zoo           the zoo's training-step cases of
                tests/test_torch_port_zoo_small.py and
                tests/test_torch_port_zoo_googlenet.py (the MNIST net, VGG-11
                on CIFAR, the narrow DenseNet at batch 8; GoogLeNet with its
                aux heads at 64x64, batch 4 and 8; dropout 0): the port's
                float32 step against the JAX trainer's and against its own
                float64 step (loss, updates in norm, worst tensor over its
                update's norm plus 1e-4 of all updates' norm, BN statistics);
                then the three Inception models' training forward (dropout
                0, batch 2) at 75, 107 and 139 pixels: how far a 1e-7
                relative input change, and float32 against float64, move
                the logits (a share of the largest), the conditioning that
                sets tests/test_torch_port_zoo_inception*.py's training size
  mobilenet_v2_float64
                the same net's loss gradient at batch 8, the JAX model under
                a float64 policy (64-bit JAX; and once more with its
                BatchNorm, which casts to float32 whatever the policy, in
                float64 too) against the port in float64, and each against
                its float32 run: where the two packages part when rounding
                is taken away (run this part alone: it turns on JAX's
                64-bit mode for the rest of the process)

  int8          post-training int8 serving (tests/test_torch_port_quant.py):
                the narrow ResNet-50 of tests/test_torch_port_serve.py
                (32x32, batch 4) and MobileNet v1 at width 0.25 (64x64,
                batch 8), the port's Predictor(quantize="int8") against the
                JAX package's from the same weights, in float32 and bf16:
                the calibrated scales, the logits (a share of the largest,
                and top-1 agreement), with the port's own scales and with
                the JAX scales set in; how often one activation's int8 value
                differs between the packages (each quantized conv's input as
                each package computed it, quantized with the same scale);
                and the int8 kernel's epilogue, which skips the plain
                version's rounding to bf16 before the folded BN, emulated
                on the CPU at ResNet-50's shapes: the difference in bf16
                ulps of the output and over 1 + |output|

Run from the repository root (minutes; the float64 and oscillation parts
take the most):

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python scripts/port_numerics.py \
        [sensitivity jax bf16_step bf16 float64 oscillation resnext
         mobilenet mobilenet_v2 trainer_features trainer_features_float64
         mobilenet_v2_float64 cifar_se zoo int8]
"""

import copy
import os
import sys

import conftest  # noqa: F401  (pins JAX to the CPU before it starts)
import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_port_train as T
from convnet_tpu import models as jax_models
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu_torch import models, ops
from convnet_tpu_torch.regimes.optim import OptimRegime
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import to_jax_params


def norm_err(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def sensitivity():
    tr = T._port_trainer("float32")
    tr.model.train()
    x = torch.from_numpy(T._batches(1)[0][0])
    noise = 1 + 1e-7 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(x.shape).astype(np.float32))
    with torch.no_grad():
        a, b = tr.model(x), tr.model(x * noise)
    print("narrow net, logits moved by a 1e-7 input change (max / max|logit|)"
          f": {float((a - b).abs().max() / a.abs().max()):.3g}")
    losses = []
    for scale in (None, noise):
        tr = T._port_trainer("float32")
        run = []
        for x, y in T._batches(T.STEPS):
            x = torch.from_numpy(x)
            run.append(float(tr.train_step(x if scale is None
                                           else x * scale, y)["loss"]))
        losses.append(run)
    print("narrow net, free-running step losses "
          f"{losses[0]} and with the input change {losses[1]}: relative "
          f"moves {[abs(a - b) / a for a, b in zip(*losses)]}")


def jax_steps():
    params, state = to_jax_params(T._port_trainer("float32")
                                  .model.state_dict())
    os.environ["CONVNET_TPU_PALLAS_POOL"] = "1"
    os.environ["CONVNET_TPU_PALLAS_FUSED"] = "1"
    steps, ours, j_val, val = T.trajectory.__wrapped__((params, state))
    for i, ((before, j_loss, (j_p, j_s)), (loss, (p, s))) in enumerate(
            zip(steps, ours)):
        p0 = dict(T._leaves(before[0]))
        ref = T._updates(p0, dict(T._leaves(j_p)))
        got = T._updates(p0, dict(T._leaves(p)))
        worst = max(ref, key=lambda k: np.abs(got[k] - ref[k]).max()
                    / np.abs(ref[k]).max())
        rs, gs = dict(T._leaves(j_s)), dict(T._leaves(s))
        total = norm_err(np.concatenate([got[k].ravel() for k in ref]),
                         np.concatenate([ref[k].ravel() for k in ref]))
        tensor = (np.abs(got[worst] - ref[worst]).max()
                  / np.abs(ref[worst]).max())
        stats = max(float((np.abs(gs[k] - rs[k]) / (1 + np.abs(rs[k]))).max())
                    for k in rs)
        print(f"step {i + 1}: loss {abs(loss - j_loss) / j_loss:.3g} apart; "
              f"updates in norm {total:.3g}, worst tensor {worst} "
              f"{tensor:.3g} of its largest update; BN statistics "
              f"{stats:.3g}")
    print(f"validate: JAX {j_val}, port {val}")


def bf16_step():
    params, state = to_jax_params(T._port_trainer("float32")
                                  .model.state_dict())
    os.environ["CONVNET_TPU_PALLAS_POOL"] = "1"
    batches = T._batches(1)
    steps, _, _ = T._jax_trajectory("bf16", batches, params, state)
    tr = T._port_trainer("bf16")
    loss = float(tr.train_step(*batches[0])["loss"])
    print(f"one bf16 step from the same weights: JAX loss {steps[0][1]:.4f},"
          f" port {loss:.4f}, {abs(loss - steps[0][1]) / steps[0][1]:.3g} "
          "apart")


def bf16_blocks():
    params, state = to_jax_params(T._port_trainer("float32")
                                  .model.state_dict())
    j_model = jax_models.build("resnet", **T.NARROW)
    port = models.build("resnet", **T.NARROW)
    port.load_state_dict(T.from_jax_params(params, state))
    port.train()
    ctx = T.Context(train=True)
    h = torch.from_numpy(T._batches(1)[0][0]).to(torch.bfloat16)
    worst = {"port vs JAX": 0.0, "port vs float32": 0.0,
             "JAX vs float32": 0.0}
    for name, j_block, p_block, p, s in T._blocks(j_model, port, params,
                                                   state):
        if name in ("stem", "layer1.0", "layer4.0"):
            hj = jnp.asarray(h.float().numpy(), jnp.bfloat16)
            out, vjp = jax.vjp(lambda a, b: j_block(a, s, b, ctx)[0], p, hj)
            dy = T._rng(len(name)).standard_normal(out.shape).astype(
                np.float32)
            j_gp, j_gh = vjp(jnp.asarray(dy, jnp.bfloat16))
            theirs = {"out": out, "dx": j_gh, **dict(T._leaves(j_gp))}
            ours = {}
            for dtype in (torch.bfloat16, torch.float32):
                saved = {k: v.clone() for k, v in p_block.state_dict().items()}
                ht = h.detach().to(dtype).clone().requires_grad_()
                o = p_block(ht)
                o.backward(torch.from_numpy(dy).to(dtype))
                p_block.load_state_dict(saved)
                grads = {n: q.grad for n, q in p_block.named_parameters()}
                for q in p_block.parameters():
                    q.grad = None
                g, _ = to_jax_params({**grads,
                                      **dict(p_block.named_buffers())})
                ours[dtype] = {"out": o.detach().float().numpy(),
                               "dx": ht.grad.float().numpy(),
                               **dict(T._leaves(g))}
            for k, ref in ours[torch.float32].items():
                j = np.asarray(theirs[k], np.float32)
                b = ours[torch.bfloat16][k]
                for what, e in (("port vs JAX", norm_err(b, j)),
                                ("port vs float32", norm_err(b, ref)),
                                ("JAX vs float32", norm_err(j, ref))):
                    worst[what] = max(worst[what], e)
        with torch.no_grad():
            h = p_block(h)
    print(f"bf16 blocks, largest norm error of any output or gradient: "
          f"{worst}")


def _float64_step(double, two_pass):
    """The update (p1 - p0) of one float32 or float64 step, full width."""
    bn = ops.batch_norm_train
    if two_pass:
        def bn(x, scale, bias, rm, rv, *, momentum=0.1, eps=1e-5):
            x32 = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dims)
            var = (x32 - mean).square().mean(dims)
            y = ((x32 - mean) * torch.rsqrt(var + eps) * scale.float()
                 + bias.float()).to(x.dtype)
            n = x.numel() // x.shape[-1]
            return (y, (1 - momentum) * rm + momentum * mean.detach(),
                    (1 - momentum) * rv
                    + momentum * var.detach() * n / (n - 1))
    layers = sys.modules["convnet_tpu_torch.nn.layers"]
    saved_bn, saved_float = layers.ops.batch_norm_train, torch.Tensor.float
    layers.ops.batch_norm_train = bn
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, 4)
    model = models.build("resnet", depth=50)
    tr = Trainer(model, OptimRegime(model.regime), 1000, TrainerConfig(),
                 device="cpu", seed=0)
    tr.initialize()
    p0 = {k: v.detach().double().clone()
          for k, v in model.named_parameters()}
    try:
        if double:   # every float32 cast of the port becomes a no-op
            torch.Tensor.float = (lambda t: t if t.dtype == torch.float64
                                  else saved_float(t))
            model.double()
            tr._params = list(model.parameters())
            tr.opt_state = tr.optim.init_state(tr._params)
            tr.policy = type(tr.policy)(compute_dtype=torch.float64)
        tr.train_step(x, y)
    finally:
        torch.Tensor.float = saved_float
        layers.ops.batch_norm_train = saved_bn
    return {k: v.detach().double() - p0[k]
            for k, v in model.named_parameters()}


def float64():
    for two_pass in (False, True):
        u32 = _float64_step(False, two_pass)
        u64 = _float64_step(True, two_pass)
        total = float((sum(((u32[k] - u64[k]) ** 2).sum() for k in u64)
                       / sum((u64[k] ** 2).sum() for k in u64)).sqrt())
        worst = max(float((u32[k] - u64[k]).norm() / u64[k].norm())
                    for k in u64)
        print(f"full width, batch 4, 224x224, "
              f"{'two-pass' if two_pass else 'E[x^2]-E[x]^2'} variance: "
              f"float32 updates {total:.3g} from float64 in norm, worst "
              f"tensor {worst:.3g}")


def oscillation():
    cfg = {"depth": 50, "num_classes": 1000}
    model = models.build("resnet", **cfg)
    tr = Trainer(model, OptimRegime(model.regime), 1000,
                 TrainerConfig(dtype="bf16"), device="cpu", seed=0)
    tr.initialize()
    params, state = to_jax_params(model.state_dict())
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 96, 96, 3)).astype(np.float32)
    y = rng.integers(0, 1000, 32).astype(np.int32)
    j_model = jax_models.build("resnet", **cfg)
    jt = JaxTrainer(j_model, jax_optim.OptimRegime(j_model.regime), 1000,
                    JaxTrainerConfig(dtype="bf16", print_freq=0))
    p, s, o = jt.initialize(params, state)
    hp = jt._hp_device(jt.optim.hyperparams())
    step = jt._get_train_step()
    j_losses = []
    for _ in range(20):
        p, s, o, m = step(p, s, o, jnp.asarray(x), jnp.asarray(y), hp,
                          jax.random.PRNGKey(0))
        j_losses.append(round(float(m["loss"]), 3))
    losses = [round(float(tr.train_step(x, y)["loss"]), 3)
              for _ in range(20)]
    print(f"20 bf16 steps on one batch: JAX {j_losses}\n"
          f"                            port {losses}")


def _port_update(name, config, params, state, x, y, double):
    """Loss and update (p1 - p0, float64) of one port step from the JAX
    weights, in float32 or with every float32 cast made float64."""
    import test_torch_port_models as M
    tr = M._port_trainer(name, config, params, state)
    model = tr.model
    p0 = {k: v.detach().double().clone()
          for k, v in model.named_parameters()}
    saved_float = torch.Tensor.float
    try:
        if double:
            torch.Tensor.float = (lambda t: t if t.dtype == torch.float64
                                  else saved_float(t))
            model.double()
            tr._params = list(model.parameters())
            tr.opt_state = tr.optim.init_state(tr._params)
            tr.policy = type(tr.policy)(compute_dtype=torch.float64)
        loss = float(tr.train_step(x, y)["loss"])
    finally:
        torch.Tensor.float = saved_float
    return loss, {k: v.detach().double() - p0[k]
                  for k, v in model.named_parameters()}


def _update_errs(got, ref, floor=0.0):
    """(all updates in norm, worst tensor in norm, worst element over its
    tensor's largest update) of ``got`` against ``ref`` (name → array). A
    tensor's error is over its update's norm plus ``floor`` times the norm
    of all updates."""
    all_ref = np.concatenate([np.ravel(ref[k]) for k in ref])
    flat = norm_err(np.concatenate([np.ravel(got[k]) for k in ref]), all_ref)
    scale = floor * float(np.linalg.norm(all_ref))
    tensor = max(float(np.linalg.norm(np.asarray(got[k]) - np.asarray(ref[k]))
                       / (np.linalg.norm(np.asarray(ref[k])) + scale))
                 for k in ref)
    elem = max(float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max()
                     / np.abs(np.asarray(ref[k])).max()) for k in ref)
    return flat, tensor, elem


def resnext():
    import test_torch_port_models as M
    cfg = M.RESNEXT
    for batch in (4, 8):
        params, state = M._jax_init("resnext", cfg, seed=3)
        batches = M._batches(M.STEPS, batch, cfg["num_classes"])
        x, y = batches[0]
        model = M._port("resnext", cfg, params, state).train()
        noise = 1 + 1e-7 * np.random.default_rng(0).standard_normal(
            x.shape).astype(np.float32)
        with torch.no_grad():
            a = model(torch.from_numpy(x))
            b = model(torch.from_numpy(x * noise))
        print(f"batch {batch}: logits moved by a 1e-7 input change "
              f"{float((a - b).abs().max() / a.abs().max()):.3g} of the "
              f"largest")
        l32, u32 = _port_update("resnext", cfg, params, state, x, y, False)
        l64, u64 = _port_update("resnext", cfg, params, state, x, y, True)
        errs = _update_errs({k: v.numpy() for k, v in u32.items()},
                            {k: v.numpy() for k, v in u64.items()})
        print(f"batch {batch}: port float32 step against float64: loss "
              f"{abs(l32 - l64) / l64:.3g}, updates in norm {errs[0]:.3g}, "
              f"worst tensor {errs[1]:.3g}, worst element {errs[2]:.3g}")
        j_tr = M._jax_trainer("resnext", cfg)
        steps, _, _ = M._jax_steps(j_tr, batches, params, state)
        tr = M._port_trainer("resnext", cfg, params, state)
        for i, ((before, j_loss, (j_p, j_s)), (x, y)) in enumerate(
                zip(steps, batches)):
            M._load(tr, *before)
            loss = float(tr.train_step(x, y)["loss"])
            p, s = to_jax_params(tr.model.state_dict())
            p0 = dict(T._leaves(before[0]))
            ref = {k: v - p0[k] for k, v in T._leaves(j_p)}
            got = {k: v - p0[k] for k, v in T._leaves(p)}
            errs = _update_errs(got, ref)
            rs, gs = dict(T._leaves(j_s)), dict(T._leaves(s))
            stats = max(float((np.abs(gs[k] - rs[k])
                               / (1 + np.abs(rs[k]))).max()) for k in rs)
            print(f"batch {batch}, step {i + 1}, port against JAX: loss "
                  f"{abs(loss - j_loss) / j_loss:.3g}, updates in norm "
                  f"{errs[0]:.3g}, worst tensor {errs[1]:.3g}, worst "
                  f"element {errs[2]:.3g}, BN statistics {stats:.3g}")


def mobilenet():
    import test_torch_port_models as M
    cfg = M.MOBILENET
    params, state = M._jax_init("mobilenet", cfg, seed=2)
    for batch in (2, 4, 8):
        x, y = M._batches(1, batch, cfg["num_classes"], seed=9)[0]
        l32, _ = _port_update("mobilenet", cfg, params, state, x, y, False)
        l64, _ = _port_update("mobilenet", cfg, params, state, x, y, True)
        steps, _, _ = M._jax_steps(M._jax_trainer("mobilenet", cfg),
                                   [(x, y)], params, state)
        print(f"batch {batch}: step loss, port float32 against float64 "
              f"{abs(l32 - l64) / l64:.3g}, port against JAX "
              f"{abs(l32 - steps[0][1]) / steps[0][1]:.3g}")


def mobilenet_v2():
    import test_torch_port_mobilenet_v2 as V
    params, state = V.jax_init(seed=2)
    for batch in (4, 8, 16):
        x, y = V.batch(batch)
        l32, u32 = _port_update("mobilenet_v2", V.CONFIG, params, state, x, y,
                                False)
        l64, u64 = _port_update("mobilenet_v2", V.CONFIG, params, state, x, y,
                                True)
        errs = _update_errs({k: v.numpy() for k, v in u32.items()},
                            {k: v.numpy() for k, v in u64.items()}, 1e-4)
        print(f"batch {batch}: port float32 step against float64: loss "
              f"{abs(l32 - l64) / l64:.3g}, updates in norm {errs[0]:.3g}, "
              f"worst tensor {errs[1]:.3g}")
        j_loss, j_p, j_s = V.jax_step(params, state, x, y)
        tr = V.port_trainer(params, state)
        loss = float(tr.train_step(x, y)["loss"])
        p, s = to_jax_params(tr.model.state_dict())
        p0 = dict(T._leaves(params))
        errs = _update_errs({k: v - p0[k] for k, v in T._leaves(p)},
                            {k: v - p0[k] for k, v in T._leaves(j_p)}, 1e-4)
        rs, gs = dict(T._leaves(j_s)), dict(T._leaves(s))
        stats = max(float((np.abs(gs[k] - rs[k])
                           / (1 + np.abs(rs[k]))).max()) for k in rs)
        print(f"batch {batch}: port against JAX: loss "
              f"{abs(loss - j_loss) / j_loss:.3g}, updates in norm "
              f"{errs[0]:.3g}, worst tensor {errs[1]:.3g}, BN statistics "
              f"{stats:.3g}")


def mobilenet_v2_float64():
    import test_torch_port_mobilenet_v2 as V
    from convnet_tpu.core.dtypes import Policy
    from convnet_tpu.core.module import Context
    from convnet_tpu_torch.utils.from_jax import from_jax_params
    jax.config.update("jax_enable_x64", True)
    params, state = V.jax_init(seed=2)
    x, y = V.batch(8)
    model = jax_models.build("mobilenet_v2", **V.CONFIG)

    def jax_grads(dt):
        policy = Policy(param_dtype=dt, compute_dtype=dt, stat_dtype=dt)
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, dt), t)
        st = cast(state)

        def loss(p):
            out, _ = model(p, st, jnp.asarray(x, dt),
                           Context(train=True, rng=jax.random.PRNGKey(0),
                                   policy=policy))
            return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(len(y)), y])

        g = jax.grad(loss)(cast(params))
        return from_jax_params(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), g))

    def port_grads(double):
        saved_float = torch.Tensor.float
        try:
            if double:
                torch.Tensor.float = (lambda t: t if t.dtype == torch.float64
                                      else saved_float(t))
            m = models.build("mobilenet_v2", **V.CONFIG)
            m.load_state_dict(from_jax_params(params, state))
            m.train()
            xt = torch.from_numpy(x)
            if double:
                m.double()
                xt = xt.double()
            torch.nn.functional.cross_entropy(
                m(xt), torch.from_numpy(y).long()).backward()
        finally:
            torch.Tensor.float = saved_float
        return {k: p.grad.double().numpy() for k, p in m.named_parameters()}

    j32, j64 = jax_grads(jnp.float32), jax_grads(jnp.float64)
    p32, p64 = port_grads(False), port_grads(True)
    # the JAX BatchNorm casts to float32 whatever the policy: once more with
    # its float32 read as float64 (this process only; no file changes)
    import convnet_tpu.ops.norm as jax_norm

    class Float64Numpy:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    jax_norm.jnp = Float64Numpy()
    try:
        j64bn = jax_grads(jnp.float64)
    finally:
        jax_norm.jnp = jnp

    def flat(g):
        return np.concatenate([np.ravel(g[k]) for k in sorted(g)])

    for name, a, b in (("JAX float32 against JAX float64 policy", j32, j64),
                       ("port float32 against port float64", p32, p64),
                       ("port float64 against JAX float64 policy", p64, j64),
                       ("port float64 against JAX float64 policy and "
                        "float64 BatchNorm", p64, j64bn),
                       ("port float32 against JAX float32", p32, j32)):
        print(f"batch 8 gradients, {name}: {norm_err(flat(a), flat(b)):.3g}"
              f" in norm")


def _double_step(tr, x, y):
    """``tr``'s next step with every float32 cast made float64: its model,
    optimizer state and compute dtype in float64."""
    saved_float = torch.Tensor.float
    try:
        torch.Tensor.float = (lambda t: t if t.dtype == torch.float64
                              else saved_float(t))
        tr.model.double()
        tr._params = list(tr.model.parameters())
        for slot, v in tr.opt_state.items():
            if isinstance(v, list):
                tr.opt_state[slot] = [t.double() for t in v]
        tr.policy = type(tr.policy)(compute_dtype=torch.float64)
        return float(tr.train_step(x, y)["loss"])
    finally:
        torch.Tensor.float = saved_float


def trainer_features():
    import test_torch_port_trainer_features as F
    os.environ.update(F.PALLAS_ENV)
    weights = F.weights.__wrapped__()
    cases = list(F.CASES.items())
    # the batches the tests do not use, and why
    for name, batch in (("chunk_batch", 8), ("chunk_batch", 16),
                        ("large_lars", 8)):
        cfg, model_kw, regime, dup, _, epochs = F.CASES[name]
        cases.append((name, (cfg, model_kw, regime, dup, batch, epochs)))
    for name, case in cases:
        F.CASES[f"{name} (batch {case[4]})"] = case
        _feature_case(F, weights, f"{name} (batch {case[4]})")


def _feature_case(F, weights, name):
    """One case of ``F.CASES``: each step of the port against its float64
    step and against the JAX step."""
    cfg, model_kw, regime = F.CASES[name][:3]
    _, steps, _, ours, j_batches = F.run_case(name, weights)
    plain = {k: v for k, v in cfg.items()
             if k not in ("mixup_alpha", "cutmix_alpha")}
    for i, ((epoch, before, j_loss, (j_p, j_s, j_opt)), (x, y)) in \
            enumerate(zip(steps, j_batches)):
        t = F._port_trainer(plain, model_kw, regime)
        F._load(t, *before)
        t.optim.update(epoch, i)
        p0 = {k: v.detach().double().clone()
              for k, v in t.model.named_parameters()}
        l64 = _double_step(t, x, y)
        u64 = {k: (v.detach().double() - p0[k]).numpy()
               for k, v in t.model.named_parameters()}
        loss, (p, s), opt = ours[i]
        w0 = F.from_jax_params(before[0])
        u32 = {k: (v.double() - w0[k].double()).numpy()
               for k, v in F.from_jax_params(p).items()}
        ref = {k: (v.double() - w0[k].double()).numpy()
               for k, v in F.from_jax_params(j_p).items()}
        rs = {k: v.numpy() for k, v in F.from_jax_params({}, j_s).items()}
        gs = {k: v.numpy() for k, v in F.from_jax_params({}, s).items()}
        stats = max(float((np.abs(gs[k] - rs[k]) / (1 + np.abs(rs[k])))
                          .max()) for k in rs)
        for what, other, other_loss in (("its float64", u64, l64),
                                        ("JAX", ref, j_loss)):
            errs = _update_errs(u32, other, floor=1e-4)
            print(f"{name}, step {i + 1}: the port's "
                  f"float32 against {what}: loss "
                  f"{abs(loss - other_loss) / other_loss:.3g}, updates "
                  f"in norm {errs[0]:.3g}, worst tensor {errs[1]:.3g}, "
                  f"worst element {errs[2]:.3g}"
                  + (f", BN statistics {stats:.3g}" if what == "JAX"
                     else ""), flush=True)
        if "agn_scale" in j_opt:
            print(f"{name}, step {i + 1}: gradient-norm scale "
                  f"{float(opt['agn_scale']):.6g}, JAX "
                  f"{float(j_opt['agn_scale']):.6g}", flush=True)


def trainer_features_float64():
    """Where the port's float32 step is within 1e-4 of its float64 step but
    several percent from the JAX trainer's (the chunked and the mixup step
    at 64x64, batch 8): one step of the JAX trainer under a float64 policy
    with its BatchNorm in float64 too (``impl="xla"``), against the port's
    float64 step and the JAX float32 step."""
    import test_torch_port_trainer_features as F
    import convnet_tpu.ops.norm as jax_norm
    from convnet_tpu.core.dtypes import Policy
    F.SIZE = 64
    weights = F.weights.__wrapped__()
    cases = [("chunk_batch=2", {"chunk_batch": 2}),
             ("mixup", {"label_smoothing": 0.1, "mixup_alpha": 0.2})]
    results = {}
    for name, cfg in cases:
        x, y = F._batches(1, 8, seed=7)[0]
        tr = F._port_trainer(cfg)
        if tr.mix is not None:
            x, y = (t.numpy() for t in tr.mix(torch.from_numpy(x),
                                              torch.from_numpy(y)))
        j_cfg = {k: v for k, v in cfg.items() if k != "mixup_alpha"}
        p0 = F.from_jax_params(weights[0])
        upd = {}
        for double in (False, True):
            t = F._port_trainer(j_cfg)
            F._load(t, *weights, {"step": 0, "mu": jax.tree_util.tree_map(
                np.zeros_like, weights[0])})
            if double:
                _double_step(t, x, y)
            else:
                t.train_step(x, y)
            upd[f"port {'float64' if double else 'float32'}"] = {
                k: (v.detach().double() - p0[k].double()).numpy()
                for k, v in t.model.named_parameters()}
        results[name] = (cfg, j_cfg, x, y, upd)

    def jax_update(j_cfg, x, y, dt):
        policy = Policy(param_dtype=dt, compute_dtype=dt, stat_dtype=dt)
        model = jax_models.build("resnet", **F.NARROW)
        tr = JaxTrainer(model, jax_optim.OptimRegime(model.regime),
                        F.NARROW["num_classes"],
                        JaxTrainerConfig(dtype=policy, print_freq=0, **j_cfg))
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, dt), t)
        params, state, opt = tr.initialize(cast(weights[0]),
                                           cast(weights[1]))
        tr.optim.update(0, 0)
        hp = {k: jnp.asarray(v, dt) for k, v in tr.optim.hyperparams().items()}
        new, _, _, _ = tr._get_train_step()(
            params, state, opt, jnp.asarray(x, dt),
            jnp.asarray(y) if y.dtype.kind == "i" else jnp.asarray(y, dt),
            hp, jax.random.PRNGKey(0))
        after = F.from_jax_params(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), new))
        before = F.from_jax_params(weights[0])
        return {k: (after[k].double() - before[k].double()).numpy()
                for k in after}

    for name, (cfg, j_cfg, x, y, upd) in results.items():
        upd["JAX float32"] = jax_update(j_cfg, x, y, jnp.float32)
    jax.config.update("jax_enable_x64", True)

    class Float64Numpy:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    jax_norm.jnp = Float64Numpy()
    try:
        for name, (cfg, j_cfg, x, y, upd) in results.items():
            upd["JAX float64"] = jax_update(j_cfg, x, y, jnp.float64)
    finally:
        jax_norm.jnp = jnp

    for name, (_, _, _, _, upd) in results.items():
        for a, b in (("port float32", "port float64"),
                     ("JAX float32", "JAX float64"),
                     ("port float64", "JAX float64"),
                     ("port float32", "JAX float32")):
            errs = _update_errs(upd[a], upd[b], floor=1e-4)
            print(f"{name}, 64x64, batch 8, first step: {a} against {b}: "
                  f"updates in norm {errs[0]:.3g}, worst tensor "
                  f"{errs[1]:.3g}, worst element {errs[2]:.3g}", flush=True)


def cifar_se():
    import test_torch_port_cifar_se as C
    for kind, (jax_cls, cls) in (("relu", (C.JaxSEBlock, C.SEBlock)),
                                 ("swish", (C.JaxSESwishBlock,
                                            C.SESwishBlock))):
        blk = jax_cls(64, 16)
        params, _ = blk.init(jax.random.PRNGKey(1))
        x = np.random.default_rng(2).standard_normal(
            (3, 6, 5, 64)).astype(np.float32)
        mod = cls(64, 16)
        mod.load_state_dict(C.from_jax_params(C._numpy(params)))
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            ref = np.asarray(blk(params, {}, jnp.asarray(x, jdt),
                                 C.Context(train=False))[0]
                             .astype(jnp.float32))
            with torch.no_grad():
                out = mod(torch.from_numpy(x).to(tdt)).float().numpy()
            print(f"SE {kind} {tdt}: max |port - JAX| / max |JAX| "
                  f"{np.abs(out - ref).max() / np.abs(ref).max():.3g}")
    nets = dict(C.STEP_NETS, wide_resnet_10_2=C.WIDE)
    for net, (name, config) in nets.items():
        params, state = C.jax_init(name, config, redraw_stats=True)
        ref, out = C.eval_logits(name, config, params, state, C.images(4, 1))
        print(f"{net}: eval logits {np.abs(out - ref).max() / np.abs(ref).max():.3g}"
              " of the largest")
    for net, (name, config) in C.STEP_NETS.items():
        for batch in (8, 16):
            for i, (before, j_loss, j_after, loss, p_after) in enumerate(
                    C.run_steps(name, config, batch=batch)):
                total, tensors, stats = C.step_errors(before, j_after,
                                                      p_after)
                worst = max(tensors, key=tensors.get)
                model = models.build(name, **config)
                tr = Trainer(model, OptimRegime(model.regime),
                             C.num_classes(name, config),
                             TrainerConfig(print_freq=0), device="cpu")
                tr.initialize(C.from_jax_params(before[0], before[1]))
                mu = C.from_jax_params(before[2])
                tr.opt_state["mu"] = [mu[k].clone() for k, _ in
                                      tr.model.named_parameters()]
                x, y = C.batches(C.STEPS, batch,
                                 C.num_classes(name, config))[i]
                p0 = {k: v.detach().double().clone()
                      for k, v in tr.model.named_parameters()}
                l64 = _double_step(tr, x, y)
                u64 = {k: (v.detach().double() - p0[k]).numpy()
                       for k, v in tr.model.named_parameters()}
                w0 = C.from_jax_params(before[0])
                u32 = {k: (v.double() - w0[k].double()).numpy()
                       for k, v in C.from_jax_params(p_after[0]).items()}
                e64 = _update_errs(u32, u64, floor=1e-4)
                print(f"{net}, batch {batch}, step {i + 1}: against JAX: "
                      f"loss {abs(loss - j_loss) / j_loss:.3g}, updates in "
                      f"norm {total:.3g}, worst tensor {worst} "
                      f"{tensors[worst]:.3g}, BN statistics {stats:.3g}; "
                      f"the port's float32 against its float64: loss "
                      f"{abs(loss - l64) / l64:.3g}, updates in norm "
                      f"{e64[0]:.3g}, worst tensor {e64[1]:.3g}",
                      flush=True)


def zoo():
    import test_torch_port_zoo_small as Z
    cases = [("mnist", {}, (8, 28, 28, 1)),
             ("vgg", Z.VGG11_CIFAR, (8, 32, 32, 3)),
             ("densenet", Z.DENSENET, (8, 32, 32, 3))]
    cases += [("googlenet", {"aux_classifiers": True, "num_classes": 10},
               (batch, 64, 64, 3)) for batch in (4, 8)]
    for name, config, shape in cases:
        model = Z.port_model(name, config)
        params, state = to_jax_params(model.state_dict())
        rng = np.random.default_rng(1)
        x = rng.standard_normal(shape).astype(np.float32)
        y = rng.integers(0, 10, shape[0]).astype(np.int32)
        j_loss, j_params, j_state = Z.jax_step(name, config, params, state,
                                               x, y, 10)
        loss, tr = Z.port_step(model, x, y, 10)
        after = to_jax_params(tr.model.state_dict())
        p0 = dict(Z.leaves(params))
        ref = {k: v - p0[k] for k, v in Z.leaves(j_params)}
        got = {k: v - p0[k] for k, v in Z.leaves(after[0])}
        j_errs = _update_errs(got, ref, floor=1e-4)
        ref_s, got_s = dict(Z.leaves(j_state)), dict(Z.leaves(after[1]))
        stats = max([0.0] + [float(np.abs(got_s[k] - ref_s[k]).max()
                                   / (1 + np.abs(ref_s[k]).max()))
                             for k in ref_s])
        model = Z.port_model(name, config)
        Z.zero_dropout(port_module=model)
        tr = Trainer(model, OptimRegime(model.regime), 10,
                     TrainerConfig(dtype="float32", print_freq=0),
                     device="cpu")
        tr.initialize(Z.from_jax_params(params, state))
        w0 = {k: v.detach().double().clone()
              for k, v in tr.model.named_parameters()}
        l64 = _double_step(tr, x, y)
        u64 = {k: (v.detach().double() - w0[k]).numpy()
               for k, v in tr.model.named_parameters()}
        w32 = Z.from_jax_params(after[0])
        u32 = {k: (w32[k].double() - w0[k]).numpy() for k in u64}
        e64 = _update_errs(u32, u64, floor=1e-4)
        print(f"{name} {config} batch {shape[0]}: against JAX: loss "
              f"{abs(loss - j_loss) / abs(j_loss):.3g}, updates in norm "
              f"{j_errs[0]:.3g}, worst tensor {j_errs[1]:.3g}, BN "
              f"statistics {stats:.3g}; the port's float32 against its "
              f"float64: loss {abs(loss - l64) / abs(l64):.3g}, updates in "
              f"norm {e64[0]:.3g}, worst tensor {e64[1]:.3g}", flush=True)
    sizes = [(name, size, 2) for name in ("inception_v3", "inception_v4",
                                          "inception_resnet_v2")
             for size in (75, 107, 139)] + [("googlenet", 64, 4)]
    for name, size, batch in sizes:
        model = Z.port_model(name, {"num_classes": 10})
        Z.zero_dropout(port_module=model)
        model.train()
        x = Z.images((batch, size, size, 3), 5)
        noise = 1 + 1e-7 * np.random.default_rng(0).standard_normal(
            x.shape).astype(np.float32)
        saved_float = torch.Tensor.float
        with torch.no_grad():
            a = model(torch.from_numpy(x))
            b = model(torch.from_numpy(x * noise))
            try:
                torch.Tensor.float = (
                    lambda t: t if t.dtype == torch.float64
                    else saved_float(t))
                c = model.double()(torch.from_numpy(x).double())
            finally:
                torch.Tensor.float = saved_float
        top = float(c.abs().max())
        print(f"{name} training forward at {size}x{size}, batch {batch}: "
              f"a 1e-7 input change moves the logits by "
              f"{float((a - b).abs().max()) / top:.3g} of the largest, "
              f"float32 against float64 "
              f"{float((a.double() - c).abs().max()) / top:.3g}",
              flush=True)


def _int8_case(name):
    """(JAX Predictor kwargs, port Predictor kwargs, images) of the int8
    comparisons, float32; both from one JAX checkpoint."""
    import tempfile
    from convnet_tpu.utils.checkpoint import save_checkpoint
    import test_torch_port_serve as S
    if name == "resnet":
        from convnet_tpu.models.resnet import Bottleneck as JaxBottleneck
        from convnet_tpu_torch.models.resnet import Bottleneck
        params, state = S._randomised_weights()
        jax_kw = dict(model_name="resnet",
                      model_config=dict(S.NARROW, block=JaxBottleneck))
        port_kw = dict(model_name="resnet",
                       model_config=dict(S.NARROW, block=Bottleneck))
        size, batch = 32, 4
    else:
        import test_torch_port_models as M
        params, state = M._jax_init("mobilenet", M.MOBILENET, seed=0,
                                    redraw_stats=True)
        jax_kw = port_kw = dict(model_name="mobilenet",
                                model_config=dict(M.MOBILENET))
        size, batch = 64, 8
    path = tempfile.mkdtemp(prefix="int8_numerics_")
    save_checkpoint({"params": params, "state": state, "epoch": 0}, False,
                    path)
    common = dict(checkpoint=path, batch_size=batch, input_size=size,
                  quantize="int8")
    images = np.random.default_rng(1).integers(0, 256, (batch, size, size, 3),
                                               np.uint8)
    return dict(jax_kw, **common), dict(port_kw, **common), images


def int8():
    from convnet_tpu.nn import quant as jax_quant
    from convnet_tpu.serve import Predictor as JaxPredictor
    from convnet_tpu_torch.ops.kernels import matmul_int8 as mi
    from convnet_tpu_torch.serve import Predictor
    for name in ("resnet", "mobilenet"):
        jax_kw, port_kw, images = _int8_case(name)
        for dtype in ("float32", "bf16"):
            jp = JaxPredictor(**jax_kw, dtype=dtype)
            pp = Predictor(**port_kw, dtype=dtype, device="cpu")
            js, ps = np.array(jp.act_scales), np.array(pp.act_scales)
            ref = jp.predict_logits(images)
            top = np.abs(ref).max()
            own = pp.predict_logits(images)
            pp._replicas[0].state.scales = list(jp.act_scales)
            with_jax = pp.predict_logits(images)
            print(f"int8 {name} {dtype}: {len(ps)} scales (JAX {len(js)}), "
                  f"largest relative difference "
                  f"{np.abs(ps - js).max() / js.min():.3g}; logits against "
                  f"JAX's, a share of the largest: own scales "
                  f"{np.abs(own - ref).max() / top:.3g} (top-1 agreement "
                  f"{np.mean(own.argmax(-1) == ref.argmax(-1)):.3g}), JAX's "
                  f"scales {np.abs(with_jax - ref).max() / top:.3g} (top-1 "
                  f"{np.mean(with_jax.argmax(-1) == ref.argmax(-1)):.3g})",
                  flush=True)
            # each quantized conv's input, as each package computed it
            seen = {"jax": [], "port": []}
            jax_conv, port_plain = jax_quant.conv1x1_int8, mi.matmul_int8_plain

            def jax_record(x, w, s):
                seen["jax"].append((np.asarray(x.astype(jnp.float32)), s))
                return jax_conv(x, w, s)

            def port_record(x, w, s, *args, **kw):
                seen["port"].append(x.float().numpy())
                return port_plain(x, w, s, *args, **kw)

            jax_quant.conv1x1_int8, mi.matmul_int8_plain = (jax_record,
                                                            port_record)
            try:
                with jax.disable_jit():
                    jp.predict_logits(images)
                pp.predict_logits(images)
            finally:
                jax_quant.conv1x1_int8, mi.matmul_int8_plain = (jax_conv,
                                                                port_plain)
            jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
            differ, total, worst = 0, 0, 0
            for (xj, s), xp in zip(seen["jax"], seen["port"]):
                qj = np.asarray(jax_quant.quantize_act(
                    jnp.asarray(xj, jdt), s)[0], np.int32)
                qp = mi.quantize_act(torch.from_numpy(xp).to(
                    pp.policy.compute_dtype), s)[0].numpy().astype(np.int32)
                qp = qp.reshape(qj.shape)
                differ += int((qj != qp).sum())
                total += qj.size
                worst = max(worst, int(np.abs(qj - qp).max()))
            print(f"  int8 activations that differ between the packages "
                  f"(same scales, each package's own input): {differ} of "
                  f"{total} ({differ / max(total, 1):.3g}), at most {worst} "
                  f"apart, over {len(seen['port'])} convs", flush=True)
    # the kernel's epilogue against the plain version's, in bf16
    rng = np.random.default_rng(2)
    worst_ulps, worst_rel = 0.0, 0.0
    for m, k, n in ((3136, 64, 256), (784, 512, 128), (49, 2048, 512)):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).bfloat16()
        w = torch.from_numpy((rng.standard_normal((n, k)) / k ** 0.5).astype(
            np.float32))
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
        shift = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32))
        s = float(x.float().abs().max()) / 127
        plain = mi.matmul_int8_plain(x, w, s, scale, shift, "relu").float()
        xq, eff = mi.quantize_act(x, s)
        wq, sw = mi.quantize_weight_1x1(w)
        fused = mi.int8_sums(xq, wq).float() * (
            torch.tensor(eff, dtype=torch.float32) * sw)
        fused = torch.clamp_min(fused * scale + shift, 0).bfloat16().float()
        d = (fused - plain).abs()
        # ulps where the output is at least 1 (where the shift cancels the
        # product, the rounding of the pre-BN value is many ulps of a small
        # output, and the share of 1 + |out| is the measure)
        big = plain.abs() >= 1
        ulp = 2.0 ** (torch.floor(torch.log2(plain.abs().clamp_min(1))) - 7)
        ulps = float((d / ulp)[big].max())
        rel = float((d / (1 + plain.abs())).max())
        worst_ulps, worst_rel = max(worst_ulps, ulps), max(worst_rel, rel)
        print(f"int8 epilogue, bf16, M {m} K {k} N {n}: fused against "
              f"plain differ in {float((d > 0).float().mean()):.3g} of the "
              f"outputs; at most {ulps:.3g} ulps where |out| >= 1, "
              f"{rel:.3g} of 1 + |out| anywhere", flush=True)
    print(f"int8 epilogue, bf16: at most {worst_ulps:.3g} ulps where "
          f"|out| >= 1, {worst_rel:.3g} of 1 + |out|", flush=True)


PARTS = {"sensitivity": sensitivity, "jax": jax_steps, "bf16_step": bf16_step,
         "bf16": bf16_blocks, "float64": float64, "oscillation": oscillation,
         "resnext": resnext, "mobilenet": mobilenet,
         "mobilenet_v2": mobilenet_v2, "trainer_features": trainer_features,
         "trainer_features_float64": trainer_features_float64,
         "mobilenet_v2_float64": mobilenet_v2_float64, "cifar_se": cifar_se,
         "zoo": zoo, "int8": int8}

if __name__ == "__main__":
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    for part in sys.argv[1:] or PARTS:
        PARTS[part]()
