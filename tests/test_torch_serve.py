"""The port's micro-batched detection server (`serve.py`) on the CPU: the
JAX package's serving test (`tests/test_multiclass_viewer.py`
`TestServing`) on the port's `build_server`, with every answer held to
`InferenceContext.inference` of its cloud alone, the per-request error
replies and the batcher's statistics.

The server runs the tiny sparse pipeline with random weights
(`init_weights_`, seed 1: varied scores, finite boxes)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu_torch.models.build import init_weights_
from second_tpu_torch.serve import MicroBatcher, build_server

from test_torch_inference_ctx import clouds
from test_torch_temporal import one_thread

# an answer against `inference` of its cloud alone: the server rounds to 4
# decimals (5e-5), and the CPU's sums of a batch may run in another order
# than those of one cloud
ANSWER_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """The port's side on one thread: beside the other test workers its
    small ops gain nothing from threads (`test_torch_temporal.one_thread`)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg_path = tmp_path_factory.mktemp("serve") / "tiny.config"
    cfg_path.write_text(TINY_SPARSE_PIPELINE)
    srv, batcher = build_server(cfg_path, None, port=0, max_batch=4,
                                window_ms=500.0, max_points=3000,
                                device="cpu")
    init_weights_(batcher.ctx.module, 1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1], batcher
    srv.shutdown()
    batcher.close()
    assert not batcher._thread.is_alive()


def _request(port, path, data=None, ctype="application/json"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": ctype} if data is not None else {})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _json_body(points):
    return json.dumps({"points": points.round(3).tolist()}).encode()


def _assert_answer(out, det):
    assert out["status"] == "ok"
    assert out["num_detections"] == len(det["scores"]) > 0
    assert out["class_names"] == det["class_names"]
    np.testing.assert_allclose(out["boxes"], det["boxes"], rtol=0,
                               atol=ANSWER_TOL)
    np.testing.assert_allclose(out["scores"], det["scores"], rtol=0,
                               atol=ANSWER_TOL)


def test_microbatch_server_end_to_end(server):
    """Three concurrent JSON requests of distinct clouds micro-batch into
    one forward, then one octet-stream request: each answer is
    `ctx.inference` of its own cloud; /healthz reports the model, /stats
    the requests, a batch of more than one and p50/p90/p99."""
    port, batcher = server
    pcs = [p.round(3) for p in clouds(11, n=3)]
    results = [None] * 3
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, _request(port, "/v1/detect", _json_body(pcs[i]))))
        for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for (code, out), p in zip(results, pcs):
        assert code == 200
        _assert_answer(out, batcher.ctx.inference(p))

    binary = clouds(12, n=1)[0]
    code, out = _request(port, "/v1/detect", binary.tobytes(),
                         "application/octet-stream")
    assert code == 200
    _assert_answer(out, batcher.ctx.inference(binary))

    code, health = _request(port, "/healthz")
    assert code == 200 and health["status"] == "ok"
    assert health["classes"] == ["Car"] and health["max_batch"] == 4
    code, stats = _request(port, "/stats")
    assert stats["requests"] >= 4
    assert set(stats["latency_ms"]) == {"p50", "p90", "p99"}
    assert any(int(k) > 1 for k in stats["batch_hist"])
    assert sum(int(k) * v for k, v in stats["batch_hist"].items()) == \
        stats["requests"]


@pytest.mark.parametrize("body,ctype,error", [
    (b"\x00" * 10, "application/octet-stream", "ValueError"),
    (json.dumps({"points": [1.0, 2.0]}).encode(), "application/json",
     "points must be"),
    (b"{not json", "application/json", "JSONDecodeError"),
    # passes the handler's checks, fails in the forward on the worker
    # thread: the VFE takes 4 features a point
    (json.dumps({"points": [[1.0, 2.0, 0.0]] * 8}).encode(),
     "application/json", "RuntimeError"),
])
def test_malformed_requests_get_an_error_reply(server, body, ctype, error):
    """A malformed request is answered 400 with the error's type and
    message, and the server goes on answering."""
    port, batcher = server
    code, out = _request(port, "/v1/detect", body, ctype)
    assert code == 400 and out["status"] == "error"
    assert error in out["error"]
    p = clouds(13, n=1)[0].round(3)
    code, out = _request(port, "/v1/detect", _json_body(p))
    assert code == 200
    _assert_answer(out, batcher.ctx.inference(p))


def test_unknown_paths_are_404(server):
    port, _ = server
    assert _request(port, "/nope")[0] == 404
    assert _request(port, "/v2/detect", b"{}")[0] == 404


class _Echo:
    """A context stand-in that records its batches."""

    def __init__(self):
        self.batches = []

    def inference_batch(self, clouds_):
        self.batches.append(len(clouds_))
        return [{"n": len(c)} for c in clouds_]


def test_batcher_runs_each_batch_as_it_is():
    """No padding: five requests inside one window run as a batch of 4 and
    one of 1 (max_batch 4), each request answered by its own cloud; the
    histogram counts the real batch sizes; close() stops the worker."""
    ctx = _Echo()
    b = MicroBatcher(ctx, max_batch=4, window_ms=1000.0)
    out = [None] * 5
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, b.submit(np.zeros((i + 1, 4), np.float32)))) for i in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    b.close()
    assert [o["n"] for o in out] == [1, 2, 3, 4, 5]
    assert sorted(ctx.batches) == [1, 4]
    s = b.summary()
    assert s["requests"] == 5 and s["batches"] == 2
    assert s["batch_hist"] == {4: 1, 1: 1}
    assert not b._thread.is_alive()
