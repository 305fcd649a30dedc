"""The port's data-parallel ``Trainer`` (``mesh=``) at a world of two ranks,
against the JAX package's ``Trainer`` on a ``make_mesh(2)`` of the
conftest's virtual CPU devices, and against its own replicated and
single-device steps.

The net is the CIFAR ResNet-8 (``depth=8``, widths 16/32/64) at 16x16, a
global batch of 16 (8 a rank), float32, from the same weights (drawn by
the JAX package). The port's ranks are two spawned processes over gloo
(``torch_port_ranks.py``, which imports no JAX), each on its contiguous
half of every batch, as the JAX mesh shards it; one spawn runs every case.

Held: the ghost-BN step (per-replica statistics, the running statistics
averaged over the ranks) against the JAX mesh step; the sync-BN step
against the JAX single-device step on the whole batch (the equivalence of
``tests/test_distributed.py``); ZeRO-1 with SGD, LARS and LAMB against the
JAX ``shard_opt_state`` step and against the port's replicated step; the
bf16 all-reduce against the float32 one within the JAX package's own
bounds (``tests/test_distributed.py``: the gradient norm 5e-2 relative, the
weights 5e-2 relative plus 5e-3); ``chunk_batch`` with ``adapt_grad_norm``
on the mesh; ``validate`` with a 13-sample remainder batch, and over the
evaluation loaders of a set the world does not divide; ``calibrate_bn``;
a ZeRO checkpoint saved at world 2 and resumed bit-exact at world 2, resumed
at world 1, and a JAX ZeRO checkpoint loaded by the port.

Tolerances of one step against the JAX package's are the CIFAR nets' (the
terms of ``test_torch_port_cifar_se``): the loss 1e-4 relative, all updates
5e-2 in norm, each tensor 1e-1 of its update's norm plus 1e-4 of all
updates', the BN statistics 1e-3. The port's ZeRO step runs its replicated
step's arithmetic on slices: SGD 1e-6 from it, LARS and LAMB 1e-5 (their
trust ratios sum the squares in another order).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_cifar_se as C
import torch_port_ranks as ranks
from convnet_tpu import models as jax_models
from convnet_tpu.parallel.mesh import make_mesh, shard_batch
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu.utils import checkpoint as jax_ckpt
from convnet_tpu_torch import models
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils import checkpoint as ckpt_io
from convnet_tpu_torch.utils.from_jax import from_jax_params

WORLD, SIZE, BATCH, CLASSES = 2, 16, 16, 10
NET = ("resnet", {"dataset": "cifar10", "depth": 8})
LOSS_TOL, STAT_TOL = 1e-4, 1e-3
NORM_TOL = {"all": 5e-2, "tensor": 1e-1}
ZERO_TOL = {"SGD": 1e-6, "LARS": 1e-5, "LAMB": 1e-5}
BF16 = {"grad_norm": 5e-2, "rtol": 5e-2, "atol": 5e-3}
REGIMES = {
    "SGD": None,     # the model's own (SGD, momentum 0.9, weight decay)
    "LARS": [{"epoch": 0, "optimizer": "LARS", "lr": 0.1, "momentum": 0.9,
              "weight_decay": 1e-4}],
    "LAMB": [{"epoch": 0, "optimizer": "LAMB", "lr": 1e-2,
              "weight_decay": 1e-4}],
}


def _batches(n, seed, rows=BATCH, duplicates=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((rows // duplicates, SIZE, SIZE, 3))
        y = rng.integers(0, CLASSES, rows // duplicates)
        out.append((np.repeat(x, duplicates, 0).astype(np.float32),
                    np.repeat(y, duplicates).astype(np.int32)))
    return out


BATCHES = _batches(2, seed=7)
DUPLICATED = _batches(1, seed=8, duplicates=2)
VALIDATION = _batches(1, seed=9) + _batches(1, seed=10, rows=13)
# 33 uint8 images and their labels: 17 + 16 rows a rank in batches of 8 (a
# loader that sized every share at 33 // 2 rows would drop rank 0's 17th)
EVAL_SET = (np.random.default_rng(11).integers(0, 256, (33, SIZE, SIZE, 3),
                                               dtype=np.uint8),
            np.random.default_rng(12).integers(0, CLASSES, 33))


def _jax_trainer(cfg=None, mesh=None, regime=None):
    model = jax_models.build(*NET[:1], **NET[1])
    tr = JaxTrainer(model, jax_optim.OptimRegime(regime or model.regime),
                    CLASSES, JaxTrainerConfig(print_freq=0, **(cfg or {})),
                    mesh=mesh, seed=0)
    p, s, o = tr.initialize(*INIT)
    tr.optim.update(0, 0)
    return tr, p, s, o


def _jax_steps(cfg=None, mesh=None, regime=None, batches=BATCHES[:1]):
    """The JAX trainer's steps from INIT: [(loss, grad norm, (params,
    state))], and its last optimizer state."""
    tr, p, s, o = _jax_trainer(cfg, mesh, regime)
    hp = tr._hp_device(tr.optim.hyperparams())
    step = tr._get_train_step()
    out = []
    for x, y in batches:
        bx, by = jnp.asarray(x), jnp.asarray(y)
        if mesh is not None:
            bx, by = shard_batch((bx, by), mesh)
        p, s, o, m = step(p, s, o, bx, by, hp, jax.random.PRNGKey(0))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    C._numpy((p, s))))
    return out, o


INIT = C.jax_init(*NET, seed=0)


def _port_init():
    return {k: v.numpy() for k, v in from_jax_params(*INIT).items()}


def _run(cfg=None, regime=None, batches=BATCHES[:1], **more):
    return {"model": NET, "classes": CLASSES, "init": _port_init(),
            "cfg": cfg or {}, "regime": regime, "batches": batches, **more}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every case on the port's two ranks, in one spawn; the JAX ZeRO
    checkpoint it loads is written first."""
    folder = tmp_path_factory.mktemp("dp")
    jax_zero, jax_opt = _jax_steps({"shard_opt_state": True},
                                   make_mesh(WORLD))
    p, s = jax_zero[-1][2]
    jax_ckpt.save_checkpoint({"epoch": 0, "training_steps": 1, "params": p,
                              "state": s, "opt_state": jax_opt}, False,
                             str(folder / "jax"))
    runs = {"ghost": _run(), "sync": _run({"sync_bn": True}),
            "bf16": _run({"sync_bn": True, "allreduce_dtype": "bf16"}),
            "chunks": _run({"chunk_batch": 2, "duplicates": 2,
                            "adapt_grad_norm": 1}, batches=DUPLICATED),
            "validate": _run(kind="validate", batches=VALIDATION),
            "validate_set": _run(kind="validate_set", set=EVAL_SET,
                                 batch=BATCH // WORLD),
            "calibrate": _run(kind="calibrate", batches=BATCHES),
            "resume": _run({"shard_opt_state": True}, kind="resume",
                           batches=BATCHES, dir=str(folder / "zero")),
            "load": _run({"shard_opt_state": True}, kind="load",
                         path=str(folder / "jax"))}
    for name, regime in REGIMES.items():
        runs[f"zero_{name}"] = _run({"shard_opt_state": True}, regime)
        if regime is not None:
            runs[f"replicated_{name}"] = _run(regime=regime)
    out = ranks.launch("trainer", WORLD, folder, {"runs": runs})
    return {"out": out, "folder": folder, "jax_zero": jax_zero,
            "jax_opt": jax_opt}


def _check_step(port, ref, net):
    """One port step (rank results) against a JAX step (loss, grad norm,
    (params, state)) from INIT; both ranks hold the same weights and BN
    statistics."""
    for key in ("params", "state"):
        for (_, a), (_, b) in zip(C._leaves(port[0][key]),
                                  C._leaves(port[1][key])):
            np.testing.assert_array_equal(a, b, err_msg=(net, key))
    np.testing.assert_allclose(port[0]["loss"], ref[0], rtol=LOSS_TOL)
    np.testing.assert_allclose(port[0]["grad_norm"], ref[1], rtol=LOSS_TOL)
    total, tensors, stats = C.step_errors(
        INIT, ref[2], (port[0]["params"], port[0]["state"]))
    worst = max(tensors, key=tensors.get)
    assert total <= NORM_TOL["all"], (net, total)
    assert tensors[worst] <= NORM_TOL["tensor"], (net, worst, tensors[worst])
    assert stats <= STAT_TOL, (net, stats)


def _steps(world2, key):
    return [r[key][0] for r in world2["out"]]


def test_ghost_bn_step_matches_jax_mesh(world2):
    ref, _ = _jax_steps(mesh=make_mesh(WORLD))
    _check_step(_steps(world2, "ghost"), ref[0], "ghost")


def test_sync_bn_step_matches_jax_single_device(world2):
    ref, _ = _jax_steps()
    _check_step(_steps(world2, "sync"), ref[0], "sync")


def test_ghost_and_sync_bn_differ(world2):
    a, b = _steps(world2, "ghost")[0], _steps(world2, "sync")[0]
    assert not np.isclose(a["loss"], b["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_zero_step_matches_jax_shard_opt_state(world2, name):
    ref = (world2["jax_zero"] if name == "SGD" else _jax_steps(
        {"shard_opt_state": True}, make_mesh(WORLD), REGIMES[name])[0])
    _check_step(_steps(world2, f"zero_{name}"), ref[0], f"zero_{name}")


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_zero_step_matches_the_replicated_step(world2, name):
    zero = _steps(world2, f"zero_{name}")[0]
    rep = _steps(world2, "ghost" if name == "SGD"
                 else f"replicated_{name}")[0]
    for (path, a), (_, b) in zip(C._leaves(zero["params"]),
                                 C._leaves(rep["params"])):
        np.testing.assert_allclose(a, b, rtol=ZERO_TOL[name],
                                   atol=ZERO_TOL[name], err_msg=str(path))
    np.testing.assert_allclose(zero["grad_norm"], rep["grad_norm"],
                               rtol=1e-6)


def test_bf16_allreduce_tracks_float32(world2):
    bf16, fp32 = _steps(world2, "bf16")[0], _steps(world2, "sync")[0]
    assert bf16["grad_norm"] == pytest.approx(fp32["grad_norm"],
                                              rel=BF16["grad_norm"])
    for (path, a), (_, b) in zip(C._leaves(bf16["params"]),
                                 C._leaves(fp32["params"])):
        np.testing.assert_allclose(a, b, rtol=BF16["rtol"],
                                   atol=BF16["atol"], err_msg=str(path))
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in zip(
        C._leaves(bf16["params"]), C._leaves(fp32["params"])))


def test_chunks_and_adapt_grad_norm_match_jax_mesh(world2):
    ref, _ = _jax_steps({"chunk_batch": 2, "duplicates": 2,
                         "adapt_grad_norm": 1}, make_mesh(WORLD),
                        batches=DUPLICATED)
    _check_step(_steps(world2, "chunks"), ref[0], "chunks")


def test_validate_with_a_remainder_batch(world2):
    """16 + 13 samples: the ranks score 8 + 7 and 8 + 6 rows and sum; the
    result is the single device's and the JAX mesh's (which pads 13 to 14
    and masks the pad)."""
    tr = Trainer(models.build(*NET[:1], **NET[1]),
                 optim.OptimRegime([{"epoch": 0, "optimizer": "SGD"}]),
                 CLASSES, TrainerConfig(print_freq=0), device="cpu")
    tr.initialize({k: torch.from_numpy(v) for k, v in _port_init().items()})
    one = tr.validate(VALIDATION)
    jtr, p, s, _ = _jax_trainer(mesh=make_mesh(WORLD))
    ref = jtr.validate(VALIDATION, p, s)
    for r in world2["out"]:
        got = r["validate"]
        for want in (one, ref):
            assert got["prec1"] == pytest.approx(want["prec1"], abs=1e-6)
            assert got["prec5"] == pytest.approx(want["prec5"], abs=1e-6)
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)


def test_validate_covers_a_set_the_world_does_not_divide(world2):
    """The evaluation loaders of 33 samples at two ranks: every sample
    scored once, the result the single device's over the whole set."""
    tr = Trainer(models.build(*NET[:1], **NET[1]),
                 optim.OptimRegime([{"epoch": 0, "optimizer": "SGD"}]),
                 CLASSES, TrainerConfig(print_freq=0), device="cpu")
    tr.initialize({k: torch.from_numpy(v) for k, v in _port_init().items()})
    one = tr.validate(ranks.eval_loader(*EVAL_SET, BATCH))
    for r in world2["out"]:
        got = r["validate_set"]
        assert got["prec1"] == pytest.approx(one["prec1"], abs=1e-6)
        assert got["prec5"] == pytest.approx(one["prec5"], abs=1e-6)
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-4)


@pytest.mark.parametrize("loader_kind", ["ArrayBatcher", "DataLoader"])
@pytest.mark.parametrize("n,world,batch", [(33, 2, 8), (34, 3, 4)])
def test_evaluation_shards_cover_the_set(loader_kind, n, world, batch):
    """Without ``drop_last`` every rank takes as many batches as the others
    and the ranks' real rows (labels >= 0) are the whole set, each once; a
    rank's rows past its share are labelled -100. With ``drop_last``
    (training) a rank takes ``n // world // batch`` batches of real rows."""
    from convnet_tpu_torch.data import datasets, loader, preprocess
    ds = datasets.ArrayDataset(
        np.zeros((n, 4, 4, 3), np.uint8), np.arange(n), n)
    tf = preprocess.get_transform("cifar10", augment=False)

    def labels(rank, drop_last):
        kw = dict(shuffle=True, drop_last=drop_last, seed=3,
                  process_index=rank, process_count=world)
        if loader_kind == "ArrayBatcher":
            ld = loader.ArrayBatcher(ds, tf, batch, device="cpu", **kw)
        else:
            ld = loader.DataLoader(ds, tf, batch, num_workers=1,
                                   device_transform=False, **kw)
        ys = [np.asarray(y) for _, y in ld]
        assert len(ys) == len(ld)
        return np.concatenate(ys) if ys else np.zeros(0, np.int64)

    evals = [labels(r, False) for r in range(world)]
    assert len({len(y) for y in evals}) == 1
    real = np.concatenate([y[y >= 0] for y in evals])
    np.testing.assert_array_equal(np.sort(real), np.arange(n))
    assert set(np.concatenate(evals)[np.concatenate(evals) < 0]) <= {-100}
    for r in range(world):
        train = labels(r, True)
        assert len(train) == n // world // batch * batch
        assert (train >= 0).all()


def test_calibrate_bn_matches_jax_mesh(world2):
    """Cross-replica moments whatever sync_bn says: the JAX mesh's
    calibration of the same two batches."""
    jtr, p, s, _ = _jax_trainer(mesh=make_mesh(WORLD))
    ref = dict(C._leaves(C._numpy(jtr.calibrate_bn(BATCHES, p, s))))
    for r in world2["out"]:
        assert r["calibrate"]["count"] == 2
        got = dict(C._leaves(r["calibrate"]["state"]))
        assert got.keys() == ref.keys()
        for path, a in got.items():
            np.testing.assert_allclose(a, ref[path], rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=str(path))


def test_zero_checkpoint_resumes_bit_exact_at_world_2(world2):
    for r in world2["out"]:
        res = r["resume"]
        assert res["again"]["loss"] == res["second"]["loss"]
        for key in ("params", "state"):
            for (path, a), (_, b) in zip(C._leaves(res["again"][key]),
                                         C._leaves(res["second"][key])):
                np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_zero_checkpoint_stores_the_jax_flat_layout(world2):
    """The stored moments: the full padded vector in ravel_pytree order,
    each rank's slice a part of it (through the port's own order)."""
    res = [r["resume"] for r in world2["out"]]
    stored = res[0]["opt_state"]["mu"]
    np.testing.assert_array_equal(stored, res[1]["opt_state"]["mu"])
    size = sum(v.size for _, v in C._leaves(INIT[0]))
    assert stored.shape == (-(-size // WORLD) * WORLD,)
    trees = ckpt_io.load_checkpoint(str(world2["folder"] / "zero"))
    np.testing.assert_array_equal(trees["opt_state"]["mu"], stored)
    # the slices, concatenated in the port's order, hold the same values
    port = np.concatenate([r["slice"]["mu"] for r in res])
    np.testing.assert_array_equal(np.sort(port), np.sort(stored))


def test_zero_checkpoint_resumes_at_world_1(world2):
    """flat → tree: a trainer without a mesh takes the stored vector as its
    per-tensor momentum, and the weights and statistics of the first
    step."""
    ckpt = ckpt_io.load_checkpoint(str(world2["folder"] / "zero"))
    model = models.build(*NET[:1], **NET[1])
    tr = Trainer(model, optim.OptimRegime(model.regime), CLASSES,
                 TrainerConfig(print_freq=0, shard_opt_state=True),
                 device="cpu")
    assert not tr.cfg.shard_opt_state   # no mesh: ZeRO turns itself off
    tr.load_checkpoint(ckpt)
    mu = tr.checkpoint_dict()["opt_state"]["mu"]
    flat = np.concatenate([np.ravel(v) for _, v in
                           ckpt_io._sorted_leaves(mu)])
    np.testing.assert_array_equal(flat, ckpt["opt_state"]["mu"][:flat.size])
    first = world2["out"][0]["resume"]["first"]
    got = tr.checkpoint_dict()
    for key in ("params", "state"):
        for (path, a), (_, b) in zip(C._leaves(got[key]),
                                     C._leaves(first[key])):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert np.isfinite(float(tr.train_step(*BATCHES[1])["loss"]))


def test_jax_zero_checkpoint_loads_on_the_mesh_and_alone(world2):
    """The JAX mesh's ZeRO checkpoint: at world 2 each rank takes its slice
    (gathered back, the stored vector exactly); at world 1 the tree of it."""
    stored = np.asarray(jax.device_get(world2["jax_opt"]["mu"]))
    for r in world2["out"]:
        np.testing.assert_array_equal(r["load"]["opt_state"]["mu"], stored)
        assert r["load"]["step"] == 1
    model = models.build(*NET[:1], **NET[1])
    tr = Trainer(model, optim.OptimRegime(model.regime), CLASSES,
                 TrainerConfig(print_freq=0), device="cpu")
    tr.load_checkpoint(ckpt_io.load_checkpoint(str(world2["folder"]
                                                   / "jax")))
    mu = tr.checkpoint_dict()["opt_state"]["mu"]
    flat = np.concatenate([np.ravel(v) for _, v in
                           ckpt_io._sorted_leaves(mu)])
    np.testing.assert_array_equal(flat, stored[:flat.size])


@pytest.mark.parametrize("old,new", [(6, 8), (8, 6), (7, 7)])
def test_adapt_opt_state_repads_a_flat_vector(old, new):
    """flat → flat of another padded length (a resume at another world
    size): the common prefix kept, the rest zero."""
    vec = np.arange(1, old + 1, dtype=np.float32)
    out = ckpt_io.adapt_opt_state({"mu": vec, "step": np.int32(3)},
                                  {"mu": np.zeros(new, np.float32),
                                   "step": 0})
    m = min(old, new)
    np.testing.assert_array_equal(out["mu"][:m], vec[:m])
    assert out["mu"].shape == (new,) and not out["mu"][m:].any()
    assert int(out["step"]) == 3
