"""The port's command-line trainer (``convnet_tpu_torch/cli/main.py``) on
the CPU (``--device cpu``), against the JAX package's parser, artifacts,
checkpoints and forward. The JAX CLI itself is not run (its tests are
marked slow): its artifacts are the names ``tests/test_cli.py`` checks.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_port_cifar_se as C
import test_torch_port_torch_import as TI
from convnet_tpu import models as jax_models
from convnet_tpu.cli.main import build_parser as jax_build_parser
from convnet_tpu.core.module import Context
from convnet_tpu.data import datasets as jax_datasets
from convnet_tpu.data import loader as jax_loader
from convnet_tpu.data import preprocess as jax_pre
from convnet_tpu.utils import checkpoint as jax_ckpt
from convnet_tpu_torch.cli.main import build_parser, main
from convnet_tpu_torch.utils import checkpoint as ckpt_io
from convnet_tpu_torch.utils import torch_import

# tests/test_cli.py::test_train_produces_artifacts, plus model_best
ARTIFACTS = ("checkpoint.npz", "model_best.npz", "args.json", "log.txt",
             "results.csv", "results.json")
DEPTH8 = ("resnet", {"depth": 8, "dataset": "cifar10"})
LOSS_TOL = 1e-4     # float32 eval forwards, port vs JAX, relative
ABSORB_TOL = 1e-4   # --absorb-bn folds the BN: a different rounding


@pytest.fixture(scope="module", autouse=True)
def _root_logger():
    """The CLI's ``setup_logging`` replaces the root logger's handlers:
    put back what the module found, closing the CLI's last files."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


@pytest.fixture
def one_thread(monkeypatch):
    """One torch thread for the CLI runs of a test and for the processes
    they start (``OMP_NUM_THREADS``): the suite's parallel workers share the
    host's cores, and a CLI run on a thread a core stalls beside them."""
    threads = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(tmp_path, save, *extra, batch=128):
    res = main(["--dataset", "synthetic", "--model", "resnet",
                "--model-config", "{'depth': 8}", "-b", str(batch),
                "--epochs", "1", "--print-freq", "0", "--device", "cpu",
                "--results-dir", str(tmp_path), "--save", save, *extra])
    ckpt_io.wait_for_pending_save()
    return res


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_has_every_flag_of_the_jax_cli():
    ours, ref = _flags(build_parser()), _flags(jax_build_parser())
    assert set(ours) - set(ref) == {"device"}
    assert ours["device"] == (("--device",), "cuda")
    for dest, (options, default) in ref.items():
        assert ours[dest] == (options, default), dest


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli")
    res = _run(path, "t", "--tensorwatch", "--mixup", "0.2")
    return path, res


def test_one_epoch_writes_the_artifacts(trained):
    path, res = trained
    d = path / "t"
    for name in ARTIFACTS:
        assert (d / name).exists(), name
    rows = json.loads((d / "results.json").read_text())
    assert rows[0]["epoch"] == 0 and np.isfinite(rows[0]["train_loss"])
    assert res["best_prec1"] == max(r["val_prec1"] for r in rows)
    assert len((d / "watch.jsonl").read_text().splitlines()) == 8
    # the JAX package reads the port's checkpoint and its meta
    meta = jax_ckpt.peek_checkpoint_meta(str(d))
    assert meta["model"] == "resnet" and meta["config"] == DEPTH8[1]
    assert meta["epoch"] == 0 and "batch_idx" not in meta
    ckpt = jax_ckpt.load_checkpoint(str(d / "model_best.npz"))
    assert set(ckpt["params"]) == {"stem", "layers", "fc"}


def test_save_freq_then_resume_is_bit_exact(tmp_path, monkeypatch,
                                            one_thread):
    """A run preempted right after its batch-3 save, resumed, ends bit-equal
    to the uninterrupted run (mixup's sampler, the loader's epoch seed)."""
    cfg = ("--mixup", "0.2", "--seed", "7")
    _run(tmp_path, "full", *cfg, batch=64)
    ref = ckpt_io.load_checkpoint(str(tmp_path / "full"))

    class Preempted(Exception):
        pass

    real_save = ckpt_io.save_checkpoint

    def dying_save(ckpt, *a, **kw):
        real_save(ckpt, *a, **kw)
        if ckpt.get("batch_idx"):
            raise Preempted()

    monkeypatch.setattr(ckpt_io, "save_checkpoint", dying_save)
    with pytest.raises(Preempted):
        _run(tmp_path, "pre", *cfg, "--save-freq", "3", batch=64)
    monkeypatch.setattr(ckpt_io, "save_checkpoint", real_save)
    ckpt_io.wait_for_pending_save()
    mid = ckpt_io.load_checkpoint(str(tmp_path / "pre"))
    assert mid["batch_idx"] == 3 and mid["streams"]["mix"]
    _run(tmp_path, "pre", *cfg, "--resume", str(tmp_path / "pre"), batch=64)
    res = ckpt_io.load_checkpoint(str(tmp_path / "pre"))
    assert "batch_idx" not in res
    assert res["training_steps"] == ref["training_steps"] == 16
    for tree in ("params", "state", "opt_state"):
        flat, want = (ckpt_io.flatten_tree(res[tree]),
                      ckpt_io.flatten_tree(ref[tree]))
        assert flat.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def _jax_eval(params, state, batch):
    """Loss and top-1 (%) of the JAX package's eval forward over the
    synthetic val split, as the CLI's eval loader batches it."""
    model = jax_models.build(*DEPTH8[:1], **DEPTH8[1])
    fwd = jax.jit(lambda p, s, x: model(p, s, x, Context(train=False))[0])
    ds = jax_datasets.get_dataset("synthetic", "val")
    tf = jax_pre.get_transform("cifar10", augment=False)
    loss = correct = n = 0.0
    for x, y in jax_loader.ArrayBatcher(ds, tf, batch, shuffle=False,
                                        drop_last=False):
        logits = np.asarray(fwd(params, state, x), np.float64)
        y = np.asarray(y)
        logp = logits - logits.max(-1, keepdims=True)
        logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
        loss -= logp[np.arange(len(y)), y].sum()
        correct += (logits.argmax(-1) == y).sum()
        n += len(y)
    return loss / n, 100.0 * correct / n, n


def test_evaluate_a_jax_checkpoint_matches_the_jax_forward(tmp_path):
    params, state = C.jax_init(*DEPTH8, seed=4, redraw_stats=True)
    jax_ckpt.save_checkpoint(
        {"epoch": 2, "model": DEPTH8[0], "config": DEPTH8[1],
         "params": params, "state": state, "best_prec1": 11.0},
        False, str(tmp_path / "jax"))
    jax_ckpt.wait_for_pending_save()
    res = main(["--evaluate", str(tmp_path / "jax"), "--dataset",
                "synthetic", "-b", "100", "--device", "cpu",
                "--results-dir", str(tmp_path), "--save", "ev"])
    loss, prec1, n = _jax_eval(params, state, 100)
    assert abs(res["loss"] - loss) <= LOSS_TOL * abs(loss), (res, loss)
    assert abs(res["prec1"] - prec1) <= 100.0 / n + 1e-9, (res, prec1)


def test_absorb_bn_evaluate_within_tolerance(trained):
    path, _ = trained
    ck = str(path / "t" / "checkpoint.npz")
    common = ["--dataset", "synthetic", "-b", "128", "--device", "cpu",
              "--results-dir", str(path)]
    plain = main(["--evaluate", ck, "--save", "e1", *common])
    folded = main(["--evaluate", ck, "--absorb-bn", "--save", "e2", *common])
    assert abs(plain["loss"] - folded["loss"]) <= ABSORB_TOL * plain["loss"]
    assert abs(plain["prec1"] - folded["prec1"]) <= 100.0 / 1024


class TorchCifarResNet8(TI.tnn.Module):
    """The reference's CIFAR ResNet at depth 8: one block a stage."""

    def __init__(self, classes=10):
        super().__init__()
        self.conv1 = TI.tnn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.bn1 = TI.tnn.BatchNorm2d(16)
        widths = [16, 16, 32, 64]
        for i in range(1, 4):
            setattr(self, f"layer{i}", TI.tnn.Sequential(TI._basic_block(
                widths[i - 1], widths[i], 1 if i == 1 else 2)))
        self.fc = TI.tnn.Linear(64, classes)


def test_import_torch_initialises_the_run(tmp_path, monkeypatch):
    tm = TorchCifarResNet8()
    path = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": tm.state_dict(), "epoch": 3}, path)
    imported = []
    real = torch_import.import_torch_state_dict

    def spy(sd, model):
        imported.append(real(sd, model))
        return imported[-1]

    monkeypatch.setattr(torch_import, "import_torch_state_dict", spy)
    res = _run(tmp_path, "imp", "--import-torch", str(path))
    assert np.isfinite(res["best_prec1"]) and len(imported) == 1
    sd = imported[0]
    assert torch.equal(sd["stem.conv.weight"], tm.conv1.weight.detach())
    assert torch.equal(sd["fc.weight"], tm.fc.weight.detach())
    assert "imported torch checkpoint" in (tmp_path / "imp" /
                                           "log.txt").read_text()


@pytest.mark.parametrize("flags", [
    ["--spatial", "2"], ["--dtype", "float16"], ["--dtype", "fp16"]])
def test_unported_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _run(tmp_path, "x", *flags)
    assert not os.path.exists(tmp_path / "x")


def _other_host(tmp_path, save, *flags):
    """The CLI as the other host of a two-host run, in a process of its own
    (it imports the port only)."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    return subprocess.Popen(
        [sys.executable, "-m", "convnet_tpu_torch.cli.main", "--dataset",
         "synthetic", "--model", "resnet", "--model-config", "{'depth': 8}",
         "-b", "128", "--epochs", "1", "--print-freq", "0", "--device", "cpu",
         "--results-dir", str(tmp_path), "--save", save, *flags],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.mark.parametrize("flags", [
    ["--num-devices", "2"], ["--sync-bn"], ["--shard-opt-state"],
    ["--allreduce-dtype", "bf16"], ["--dist-init"], ["--dist-rank", "1"],
    ["--dist-world-size", "2"]])
def test_parallel_flags_are_accepted(tmp_path, flags, one_thread):
    """``--num-devices 2`` trains over gloo in two spawned CPU ranks;
    ``--sync-bn``, ``--shard-opt-state`` and ``--allreduce-dtype`` at one
    rank run as in the JAX CLI (no mesh); ``--dist-init`` joins a group of
    one host; ``--dist-rank 1`` and ``--dist-world-size 2`` each run a
    two-host job with the other host in a process of its own."""
    init = ["--dist-init", f"file://{tmp_path / 'rendezvous'}"]
    other = None
    if flags[0] == "--dist-init":
        flags = init
    elif flags[0] in ("--dist-rank", "--dist-world-size"):
        mine = 1 if flags[0] == "--dist-rank" else 0
        two = [*init, "--dist-world-size", "2"]
        other = _other_host(tmp_path, "x", *two, "--dist-rank",
                            str(1 - mine))
        flags = [*two, "--dist-rank", str(mine)]
    try:
        res = _run(tmp_path, "x", *flags)
    finally:
        if other is not None:
            log_other = other.communicate(timeout=300)[0]
    if other is not None:
        assert other.returncode == 0, log_other
    assert np.isfinite(res["best_prec1"])
    assert (tmp_path / "x" / "checkpoint.npz").exists()
    ranks = ("2 rank(s) over gloo" if "--num-devices" in flags
             or "--dist-world-size" in flags else "1 rank(s)")
    assert ranks in (tmp_path / "x" / "log.txt").read_text()


def test_two_hosts_of_two_ranks_each_return(tmp_path, one_thread):
    """``--dist-world-size 2 --num-devices 2``: two hosts of two CPU ranks
    each, host 0 here and host 1 in a process of its own. Both launchers
    return with the results (host 1's from its own local rank 0) and host 0
    alone writes."""
    flags = ["--dist-init", f"file://{tmp_path / 'rendezvous'}",
             "--dist-world-size", "2", "--num-devices", "2"]
    other = _other_host(tmp_path, "x", *flags, "--dist-rank", "1")
    try:
        res = _run(tmp_path, "x", *flags, "--dist-rank", "0")
        log_other = other.communicate(timeout=300)[0]
    finally:
        if other.poll() is None:
            other.kill()
            other.communicate()
    assert other.returncode == 0, log_other
    assert np.isfinite(res["best_prec1"])
    assert (tmp_path / "x" / "checkpoint.npz").exists()
    assert "4 rank(s) over gloo" in (tmp_path / "x" / "log.txt").read_text()


def test_two_ranks_train_an_epoch_and_rank_0_writes(tmp_path, one_thread):
    """``--num-devices 2 --device cpu``: ResNet-20 on synthetic CIFAR-10,
    one epoch over gloo; rank 0 alone logs, writes ``results`` and the
    checkpoint (its steps count the whole batch of 64, 32 a rank)."""
    res = main(["--dataset", "synthetic_cifar10", "--model", "resnet",
                "--model-config", "{'depth': 20}", "-b", "64", "--epochs",
                "1", "--print-freq", "0", "--device", "cpu",
                "--num-devices", "2", "--results-dir", str(tmp_path),
                "--save", "dp"])
    ckpt_io.wait_for_pending_save()
    d = tmp_path / "dp"
    for name in ARTIFACTS:
        assert (d / name).exists(), name
    rows = json.loads((d / "results.json").read_text())
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    assert res["best_prec1"] == rows[0]["val_prec1"]
    log_text = (d / "log.txt").read_text()
    assert log_text.count("epoch 0:") == 1
    assert "2 rank(s) over gloo" in log_text
    ckpt = ckpt_io.load_checkpoint(str(d))
    assert ckpt["training_steps"] == 1024 // 64
    assert len(ckpt["rank_streams"]) == 2


def test_the_card_is_the_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--dataset", "synthetic", "--results-dir", str(tmp_path)])
    # the XLA knobs are accepted and have no effect
    res = _run(tmp_path, "knobs", "--impl", "pallas", "--flat-optim",
               "--compile-cache", str(tmp_path / "cc"))
    assert np.isfinite(res["best_prec1"])
    assert "no effect on the port" in (tmp_path / "knobs" /
                                       "log.txt").read_text()

