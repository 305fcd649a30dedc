"""The port's HTTP server (``convnet_tpu_torch/serve_http.py``): the seven
tests of tests/test_serve_http.py against a live threaded server on an
ephemeral port, over a CPU Predictor (CIFAR ResNet-8, 32x32, batch 4) and
over an exported artifact. The replies' logits come from the same Predictor
in the same process, so they are held at 1e-4, as there."""

import io
import json
import threading
import urllib.request
import urllib.error

import numpy as np
import pytest

from convnet_tpu_torch.serve import Predictor
from convnet_tpu_torch.serve_http import PredictionServer


def _predictor():
    return Predictor("resnet", {"dataset": "cifar10", "depth": 8},
                     dtype="float32", batch_size=4, input_size=32,
                     device="cpu")


@pytest.fixture(scope="module")
def server():
    p = _predictor()
    s = PredictionServer(p, port=0, max_wait_ms=10).start()
    yield s, p
    s.stop()


def _post(port, body, ctype, path="/predict?topk=3"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_healthz(server):
    s, p = server
    with urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/healthz", timeout=10) as resp:
        data = json.loads(resp.read())
    assert data == {"status": "ok", "batch_size": 4, "input_size": 32}


def test_predict_npy_single_matches_predictor(server):
    s, p = server
    x = np.random.default_rng(0).integers(0, 256, (32, 32, 3), np.uint8)
    out = _post(s.port, _npy_bytes(x), "application/x-npy")
    ref = p.predict_logits(x[None])[0]
    top3 = np.argsort(-ref)[:3]
    assert [c for c, _ in out["topk"]] == [int(i) for i in top3]
    np.testing.assert_allclose([v for _, v in out["topk"]], ref[top3],
                               rtol=1e-4, atol=1e-4)


def test_predict_npy_batch(server):
    s, p = server
    x = np.random.default_rng(1).integers(0, 256, (6, 32, 32, 3), np.uint8)
    out = _post(s.port, _npy_bytes(x), "application/x-npy")
    assert len(out["topk"]) == 6
    ref_top1 = np.argmax(p.predict_logits(x), axis=-1)
    assert [r[0][0] for r in out["topk"]] == [int(i) for i in ref_top1]


def test_predict_image_bytes(server):
    s, p = server
    from PIL import Image
    img = Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (48, 48, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    out = _post(s.port, buf.getvalue(), "image/jpeg")
    assert len(out["topk"]) == 3 and isinstance(out["topk"][0][0], int)
    assert out["decoder"] in ("native", "pil")


def test_concurrent_requests_batched(server):
    """8 concurrent single-image requests against batch_size=4 —
    everyone gets a correct answer (the batcher coalesces + chunks)."""
    s, p = server
    xs = np.random.default_rng(3).integers(0, 256, (8, 32, 32, 3), np.uint8)
    ref_top1 = np.argmax(p.predict_logits(xs), axis=-1)
    results = [None] * 8

    def hit(i):
        results[i] = _post(s.port, _npy_bytes(xs[i]), "application/x-npy",
                           path="/predict?topk=1")

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r is not None for r in results)
    assert [r["topk"][0][0] for r in results] == [int(i) for i in ref_top1]
    assert s.batcher.batches >= 2   # 8 images need two batches of 4


def test_listen_backlog_takes_concurrent_clients(server):
    """The reference's backlog of 5 connects drops those of more concurrent
    clients (retried a second later, or reset); the port listens for 128."""
    s, _ = server
    assert s._httpd.request_queue_size == 128
    assert s._httpd.daemon_threads


def test_bad_request_and_unknown_path(server):
    s, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(s.port, b"not an image", "image/jpeg")
    assert e.value.code == 400
    # npy of the wrong spatial size must be rejected, not batched
    wrong = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(s.port, _npy_bytes(wrong), "application/x-npy")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(s.port, b"{}", "application/json", path="/nope")
    assert e.value.code == 404


def test_server_over_exported_artifact(tmp_path):
    """PredictionServer serves a ``Predictor.export`` artifact: the
    checkpoint-free deployment (``--exported`` in ``_main``)."""
    from convnet_tpu_torch.serve import load_exported
    p = _predictor()
    art = tmp_path / "m.pt2"
    p.export(str(art))
    ep = load_exported(str(art))
    s = PredictionServer(ep, port=0, max_wait_ms=5).start()
    try:
        x = np.random.default_rng(5).integers(0, 256, (32, 32, 3), np.uint8)
        out = _post(s.port, _npy_bytes(x), "application/x-npy",
                    path="/predict?topk=1")
        ref = int(np.argmax(p.predict_logits(x[None])[0]))
        assert out["topk"][0][0] == ref
    finally:
        s.stop()


def test_devices_flag_validated_in_parser(capsys):
    """--devices accepts 'all' or a positive int; anything else must
    die with a clear argparse error, not an int() traceback."""
    import pytest
    from convnet_tpu_torch.serve_http import _main
    for bad in ("cuda:0", "0", "-2", "1,2"):
        with pytest.raises(SystemExit) as e:
            _main(["--model", "resnet", "--devices", bad])
        assert e.value.code == 2  # argparse usage error
        err = capsys.readouterr().err
        assert "--devices" in err
