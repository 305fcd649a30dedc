"""The ranks of the port's data-parallel tests: each runs in a process of its
own, spawned by :func:`launch`, on the CPU over gloo. This module imports
torch, numpy and the port only (never JAX, which the test files import), so
a spawned rank starts in seconds.

A job is a function ``job(rank, world, payload) -> result`` of this module;
``payload`` (numpy arrays and plain values) is pickled by the parent, each
rank's result pickled back. Batches are global: each rank takes its
contiguous part (``parallel.process_batch_slice``), as a single-host JAX mesh
shards a batch.
"""

import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 240      # seconds for a whole job
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def launch(job: str, world: int, folder, payload):
    """Runs ``job`` on ``world`` spawned ranks, rendezvous through a file in
    ``folder`` (no port, so parallel test workers never collide). Returns
    the ranks' results in rank order; raises with a rank's traceback."""
    import multiprocessing as mp
    folder = str(folder)
    with open(os.path.join(folder, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    init = "file://" + os.path.join(folder, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, init, job, folder))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    errors = []
    for rank, p in enumerate(procs):
        if p.is_alive():
            p.terminate()
            p.join()
            errors.append(f"rank {rank} timed out")
        elif p.exitcode != 0:
            path = os.path.join(folder, f"error{rank}.txt")
            errors.append(open(path).read() if os.path.exists(path)
                          else f"rank {rank} exit code {p.exitcode}")
    if errors:
        raise RuntimeError("\n".join(errors))
    out = []
    for rank in range(world):
        with open(os.path.join(folder, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, init, job, folder):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        with open(os.path.join(folder, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        result = globals()[job](rank, world, payload)
        with open(os.path.join(folder, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(folder, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def part(a, rank, world):
    """This rank's contiguous part of a global batch (``np.array_split``:
    the first ranks take one row more where it does not divide)."""
    return np.array_split(np.asarray(a), world)[rank]


def _np(t):
    """A host copy (the trainer updates its tensors in place later)."""
    return t.detach().float().cpu().numpy().copy()


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


# ------------------------------------------------------------- ops jobs

def ops(rank, world, payload):
    """Sync-BN, the fused MBConv training block under sync-BN, the ZeRO-1
    functions and the mesh helpers, on this rank's part of the inputs."""
    from convnet_tpu_torch import ops as port_ops
    from convnet_tpu_torch.ops.kernels import mbconv
    from convnet_tpu_torch.parallel import mesh, zero
    group = dist.group.WORLD
    out = {}

    bn = payload["bn"]
    x = torch.from_numpy(part(bn["x"], rank, world)).requires_grad_()
    scale = torch.from_numpy(bn["scale"]).requires_grad_()
    bias = torch.from_numpy(bn["bias"]).requires_grad_()
    y, m, v = port_ops.batch_norm_train(
        x, scale, bias, torch.from_numpy(bn["mean"]),
        torch.from_numpy(bn["var"]), momentum=0.1, group=group)
    y.backward(torch.from_numpy(part(bn["dy"], rank, world)))
    out["bn"] = {"y": _np(y), "mean": _np(m), "var": _np(v),
                 "dx": _np(x.grad), "dscale": _np(scale.grad),
                 "dbias": _np(bias.grad)}

    out["mbconv"] = {}
    for name, case in payload["mbconv"].items():
        args = [None if a is None else torch.from_numpy(a).requires_grad_()
                for a in case["args"]]
        xs = torch.from_numpy(part(case["args"][0], rank, world))
        args[0] = xs.requires_grad_()
        y, stats = mbconv.mbconv_train(*args, residual=case["residual"],
                                       group=group)
        y.backward(torch.from_numpy(part(case["dy"], rank, world)))
        out["mbconv"][name] = {
            "y": _np(y),
            "stats": [None if s is None else [_np(t) for t in s]
                      for s in stats],
            "grads": [None if a is None else _np(a.grad) for a in args]}

    z = payload["zero"]
    params = [torch.from_numpy(p) for p in z["params"]]
    grads = [torch.from_numpy(g) for g in z["grads"][rank]]
    padded = zero.flat_size(params, world)
    g_slice = zero.reduce_scatter_mean(grads, padded, group)
    p_flat = zero.flatten(params, padded)
    seg = zero.leaf_segment_ids(params, world)
    mask01 = zero.flat_mask01(params, z["mask"], world)
    kw = dict(mask01=zero.shard_slice(mask01, group),
              seg_slice=zero.shard_slice(seg, group),
              w_sq=torch.stack([p.square().sum() for p in params]),
              n_leaves=len(params), group=group)
    lars_p = zero.shard_slice(p_flat, group).clone()
    lars_state = {"step": 0, "mu": torch.zeros_like(lars_p)}
    zero.lars_step_sharded(lars_p, g_slice, lars_state, z["hp"], **kw)
    lamb_p = zero.shard_slice(p_flat, group).clone()
    lamb_state = {"step": 0, "m": torch.zeros_like(lamb_p),
                  "v": torch.zeros_like(lamb_p)}
    zero.lamb_step_sharded(lamb_p, g_slice, lamb_state, z["hp"],
                           leaf_mask=zero.leaf_mask01(params, z["mask"]),
                           **kw)
    gathered = [torch.zeros_like(p) for p in params]
    zero.gather_params(lars_p, gathered, group)
    out["zero"] = {
        "padded": padded, "mask01": _np(mask01), "seg": seg.numpy(),
        "g_slice": _np(g_slice),
        "g_sq": _np(zero.segment_sq_sums(g_slice, kw["seg_slice"],
                                         len(params) + 1, group)),
        "lars": (_np(lars_p), _np(lars_state["mu"])),
        "lamb": (_np(lamb_p), _np(lamb_state["m"]), _np(lamb_state["v"])),
        "gathered": [_np(p) for p in gathered]}

    grp = mesh.make_mesh(world, "cpu")
    out["mesh"] = {"local": mesh.local_batch_size(16, grp),
                   "slice": mesh.process_batch_slice(16),
                   "size": grp.size()}
    return out


# --------------------------------------------------------- trainer jobs

def _trainer(run, world):
    from convnet_tpu_torch import models
    from convnet_tpu_torch.parallel import make_mesh
    from convnet_tpu_torch.regimes.optim import OptimRegime
    from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
    name, config = run["model"]
    model = models.build(name, **config)
    regime = run.get("regime") or model.regime
    mesh = make_mesh(world, "cpu") if run.get("mesh", True) else None
    tr = Trainer(model, OptimRegime(regime), run["classes"],
                 TrainerConfig(print_freq=0, **run.get("cfg", {})),
                 device="cpu", seed=0, mesh=mesh)
    tr.initialize({k: torch.from_numpy(v) for k, v in run["init"].items()})
    return tr


def _state(tr):
    from convnet_tpu_torch.utils.from_jax import to_jax_params
    params, state = to_jax_params(tr.model.state_dict())
    return {"params": _copy(params), "state": _copy(state)}


def _step(tr, x, y, rank, world):
    m = tr.train_step(part(x, rank, world), part(y, rank, world))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "correct1": float(m["correct1"]), **_state(tr)}


def eval_loader(images, labels, batch, rank=0, world=1):
    """The evaluation loader (no row dropped) of the in-memory set
    (``images`` uint8 NHWC, ``labels``) on this rank: ``batch`` rows a
    step of its share."""
    from convnet_tpu_torch.data import datasets, loader, preprocess
    return loader.ArrayBatcher(
        datasets.ArrayDataset(images, labels, 10),
        preprocess.get_transform("cifar10", augment=False), batch,
        shuffle=False, drop_last=False, process_index=rank,
        process_count=world, device="cpu")


def trainer(rank, world, payload):
    """Each run of ``payload["runs"]``: a trainer on the mesh from the given
    weights, its steps on the global batches (or ``validate`` or
    ``calibrate_bn``), and what they leave."""
    from convnet_tpu_torch.utils import checkpoint as ckpt_io
    out = {}
    for key, run in payload["runs"].items():
        tr = _trainer(run, world)
        kind = run.get("kind", "train")
        if kind == "train":
            out[key] = [_step(tr, x, y, rank, world)
                        for x, y in run["batches"]]
        elif kind == "validate":
            out[key] = tr.validate([(part(x, rank, world),
                                     part(y, rank, world))
                                    for x, y in run["batches"]])
        elif kind == "validate_set":
            out[key] = tr.validate(eval_loader(*run["set"], run["batch"],
                                               rank, world))
        elif kind == "calibrate":
            n = tr.calibrate_bn([(part(x, rank, world), None)
                                 for x, _ in run["batches"]])
            out[key] = {"count": n, **_state(tr)}
        elif kind == "resume":
            # two steps; the state after the first saved (rank 0 writes),
            # a fresh trainer resumed from it takes the second again
            (x1, y1), (x2, y2) = run["batches"]
            first = _step(tr, x1, y1, rank, world)
            ckpt = tr.checkpoint_dict(epoch=0, batch_idx=1)
            slices = {k: _np(v) for k, v in tr.opt_state.items()
                      if k != "step"}
            if rank == 0:
                ckpt_io.save_checkpoint(ckpt, False, run["dir"])
            dist.barrier()
            second = _step(tr, x2, y2, rank, world)
            fresh = _trainer(run, world)
            fresh.load_checkpoint(ckpt_io.load_checkpoint(run["dir"]))
            again = _step(fresh, x2, y2, rank, world)
            out[key] = {"first": first, "second": second, "again": again,
                        "opt_state": ckpt["opt_state"], "slice": slices}
        elif kind == "load":
            # a checkpoint of the JAX package loaded on the mesh: each
            # rank's slices, gathered back into the stored layout
            tr.load_checkpoint(ckpt_io.load_checkpoint(run["path"]))
            out[key] = {"opt_state": tr.checkpoint_dict()["opt_state"],
                        "step": tr.opt_state["step"]}
    return out
