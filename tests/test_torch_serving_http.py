"""The port's HTTP front end (``nvae_torch/serving_http.py``): the cases of
``tests/test_serving_http.py`` (routing, batching across connections,
formats, reload, drain, keep-alive, bursts, multi-shape and artifact
serving), over a stand-in sampler whose rows encode their temperature and
dispatch seed, and over the port's CPU sampler at debug size.  This file
imports no JAX."""

import argparse
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch import serving_http
from nvae_torch.serving import Sampler, export_sampler
from nvae_torch.serving_http import drain_on_signals, serve
from nvae_torch.serving_runtime import PAD_TEMPERATURE, dispatch_seed

TINY = dict(n_encoder_channels=8, n_decoder_channels=8,
            n_groups_per_scale=(1, 1), n_latent_per_group=2)


def _fake_sampler(batch):
    """Row i encodes its temperature and the dispatch seed."""

    def call(seed, t_vec):
        assert tuple(t_vec.shape) == (batch,)
        k = np.float32(seed % 1000) * np.float32(1e-6)
        rows = np.asarray(t_vec, np.float32) + k
        return torch.from_numpy(np.tile(rows[:, None, None, None],
                                        (1, 4, 4, 1)))

    return call


def _expected(batch, dispatch_idx, temps, seed=0):
    t_vec = np.asarray(temps + [PAD_TEMPERATURE] * (batch - len(temps)),
                       np.float32)
    return _fake_sampler(batch)(dispatch_seed(seed, dispatch_idx),
                                torch.from_numpy(t_vec)).numpy()


@pytest.fixture()
def server():
    httpd = serve(_fake_sampler(4), 4, port=0, max_delay_ms=20.0, block=False)
    yield httpd
    httpd.shutdown_and_close()


def _url(httpd, path):
    host, port = httpd.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(httpd, body, path="/sample"):
    req = urllib.request.Request(
        _url(httpd, path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get(httpd, path):
    with urllib.request.urlopen(_url(httpd, path), timeout=10) as r:
        return json.loads(r.read())


def test_healthz_and_stats(server):
    assert _get(server, "/healthz") == {"status": "ok", "batch_size": 4,
                                        "max_delay_ms": 20.0}
    stats = _get(server, "/stats")
    assert stats["dispatches"] == 0 and stats["requests"] == 0


def test_npy_roundtrip_matches_dispatch_replay(server):
    status, ctype, body = _post(server, {"n": 3, "temperature": 0.7})
    assert status == 200 and ctype == "application/octet-stream"
    out = np.load(io.BytesIO(body))
    assert out.shape == (3, 4, 4, 1)
    np.testing.assert_array_equal(out, _expected(4, 0, [0.7] * 3)[:3])


def test_concurrent_requests_share_a_dispatch(server):
    results = {}

    def post(name, n, t):
        results[name] = _post(server, {"n": n, "temperature": t})

    threads = [threading.Thread(target=post, args=("a", 2, 0.6)),
               threading.Thread(target=post, args=("b", 2, 0.9))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    a = np.load(io.BytesIO(results["a"][2]))
    b = np.load(io.BytesIO(results["b"][2]))
    stats = _get(server, "/stats")
    assert stats["requests"] == 2 and stats["dispatches"] in (1, 2)
    if stats["dispatches"] == 1:
        assert stats["rows_padded"] == 0 and stats["occupancy"] == 1.0
        ab = _expected(4, 0, [0.6, 0.6, 0.9, 0.9])
        ba = _expected(4, 0, [0.9, 0.9, 0.6, 0.6])
        assert ((np.array_equal(a, ab[:2]) and np.array_equal(b, ab[2:]))
                or (np.array_equal(b, ba[:2]) and np.array_equal(a, ba[2:])))


def test_png_format(server):
    from PIL import Image

    status, ctype, body = _post(
        server, {"n": 4, "temperature": 1.0, "format": "png"})
    assert status == 200 and ctype == "image/png"
    img = Image.open(io.BytesIO(body))
    assert img.size == (8, 8)  # a 2x2 grid of 4x4 tiles


@pytest.mark.parametrize("body,frag", [
    ({"n": 0}, "n must be"),
    ({"n": "four"}, "n must be"),
    ({"n": 10**9}, "n must be"),
    ({"temperature": -1.0}, "temperature"),
    ({"format": "jpeg"}, "format"),
])
def test_bad_requests_rejected(server, body, frag):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, body)
    assert ei.value.code == 400
    assert frag in json.loads(ei.value.read())["error"]


def test_unknown_paths_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, {}, path="/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(server, "/nope"), timeout=10)
    assert ei.value.code == 404


def test_reload_without_source_is_501(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, {}, path="/reload")
    assert ei.value.code == 501


def test_drain_on_signal_resolves_queued_requests():
    httpd = serve(_fake_sampler(4), 4, port=0, max_delay_ms=0.0, block=False)
    fut = httpd.sampler.submit(2, 0.9)
    assert not fut.done()  # 2 < 4 rows and no delay timer: stays queued
    drain_on_signals(httpd, signals=())()
    np.testing.assert_array_equal(fut.result(timeout=30),
                                  _expected(4, 0, [0.9] * 2)[:2])
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(_url(httpd, "/healthz"), timeout=5)


def test_keepalive_connection_reused():
    import http.client

    httpd = serve(_fake_sampler(4), 4, port=0, max_delay_ms=2.0, block=False)
    conn = http.client.HTTPConnection(*httpd.server_address[:2], timeout=30)
    try:
        for _ in range(3):
            conn.request("POST", "/sample", body=json.dumps(
                {"n": 2, "temperature": 0.8}).encode())
            r = conn.getresponse()
            assert r.version == 11
            assert r.getheader("Connection", "keep-alive") != "close"
            assert np.load(io.BytesIO(r.read())).shape == (2, 4, 4, 1)
        conn.request("GET", "/stats")
        assert json.loads(conn.getresponse().read())["requests"] == 3
    finally:
        conn.close()
        httpd.shutdown_and_close()


def test_reload_endpoint_swaps_sampler():
    base = _fake_sampler(4)

    class _Reloadable:
        def __init__(self):
            self.offset = 0.0
            self.info = {"step": -1, "generation": 0}

        def __call__(self, seed, t_vec):
            return base(seed, t_vec) + self.offset

    call = _Reloadable()

    def reloader_factory(sampler):
        def reload(req):
            step = req.get("step", 99)
            if not isinstance(step, int):
                raise ValueError("step must be an int")
            call.offset = float(step)
            call.info = {"step": step,
                         "generation": call.info["generation"] + 1}
            return dict(call.info)

        return reload

    httpd = serve(call, 4, port=0, max_delay_ms=2.0, block=False,
                  reloader_factory=reloader_factory)
    try:
        r0 = np.load(io.BytesIO(_post(httpd, {"n": 2, "temperature": 0.5})[2]))
        status, _, body = _post(httpd, {"step": 100}, path="/reload")
        assert status == 200
        assert json.loads(body) == {"step": 100, "generation": 1}
        r1 = np.load(io.BytesIO(_post(httpd, {"n": 2, "temperature": 0.5})[2]))
        assert float((r1 - r0).mean()) == pytest.approx(100.0, abs=1e-3)
        assert _get(httpd, "/stats")["weights"]["step"] == 100
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(httpd, {"step": "latest"}, path="/reload")
        assert ei.value.code == 400
        serving_http.reload_on_sighup(httpd)(None, None)
        deadline = time.monotonic() + 5
        while call.info["generation"] != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert call.info == {"step": 99, "generation": 2}
    finally:
        httpd.shutdown_and_close()


def test_follower_polls_and_stops_on_shutdown():
    calls = []

    def reloader_factory(sampler):
        def reload(req):
            calls.append(dict(req))
            return {"skipped": True}

        return reload

    httpd = serve(_fake_sampler(4), 4, port=0, max_delay_ms=2.0, block=False,
                  reloader_factory=reloader_factory, follow_seconds=0.05)
    try:
        deadline = time.monotonic() + 5
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(calls) >= 3
        assert all(c == {"if_newer": True} for c in calls)
    finally:
        httpd.shutdown_and_close()
    n = len(calls)
    time.sleep(0.3)
    assert len(calls) == n


def test_idle_keepalive_connection_reaped(monkeypatch):
    import http.client
    import socket

    monkeypatch.setattr(serving_http._Handler, "timeout", 0.5)
    httpd = serve(_fake_sampler(4), 4, port=0, max_delay_ms=2.0, block=False)
    host, port = httpd.server_address[:2]
    try:
        s = socket.create_connection((host, port), timeout=10)
        s.settimeout(10)
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        first = b""
        while b'"max_delay_ms"' not in first:
            chunk = s.recv(65536)
            assert chunk, f"closed mid-response: {first!r}"
            first += chunk
        assert b"200" in first
        assert s.recv(65536) == b""  # the server closed the idle line
        s.close()
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.close()
    finally:
        httpd.shutdown_and_close()


def test_error_response_closes_connection():
    import http.client

    httpd = serve(_fake_sampler(4), 4, port=0, max_delay_ms=2.0, block=False)
    conn = http.client.HTTPConnection(*httpd.server_address[:2], timeout=10)
    try:
        conn.request("POST", "/sample", body=json.dumps({"n": 0}).encode())
        r = conn.getresponse()
        assert r.status == 400 and r.getheader("Connection") == "close"
        r.read()
    finally:
        conn.close()
        httpd.shutdown_and_close()


def test_connection_burst_not_reset():
    n_clients = 64
    httpd = serve(_fake_sampler(8), 8, port=0, max_delay_ms=5.0, block=False)
    barrier = threading.Barrier(n_clients)
    errors, ok = [], []

    def client():
        body = json.dumps({"n": 1, "temperature": 0.8}).encode()
        barrier.wait()
        try:
            with urllib.request.urlopen(_url(httpd, "/sample"), data=body,
                                        timeout=60) as r:
                ok.append(r.status)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        httpd.shutdown_and_close()
    assert not errors, errors[:3]
    assert len(ok) == n_clients


def test_npy_response_preserves_sampler_dtype():
    def u8_call(seed, t_vec):
        rng = np.random.default_rng(int(t_vec.shape[0]))
        return torch.from_numpy(rng.integers(0, 256, (4, 8, 8, 1),
                                             dtype=np.uint8))

    httpd = serve(u8_call, 4, port=0, max_delay_ms=2.0, block=False)
    try:
        status, _, payload = _post(httpd, {"n": 3})
        arr = np.load(io.BytesIO(payload))
        assert status == 200 and arr.dtype == np.uint8
        assert arr.shape == (3, 8, 8, 1)
        status, _, png = _post(httpd, {"n": 3, "format": "png"})
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        httpd.shutdown_and_close()


def test_multi_shape_http_serving():
    def call(seed, t_vec):
        return torch.full((int(t_vec.shape[0]), 2, 2, 1), 0.5)

    httpd = serve(call, [4, 8], port=0, max_delay_ms=3.0, block=False)
    try:
        health = _get(httpd, "/healthz")
        assert health["batch_size"] == 8 and health["batch_sizes"] == [4, 8]
        assert np.load(io.BytesIO(_post(httpd, {"n": 2})[2])).shape == (
            2, 2, 2, 1)
        assert _post(httpd, {"n": 8})[0] == 200
        assert _get(httpd, "/stats")["dispatch_shapes"] == {"4": 1, "8": 1}
    finally:
        httpd.shutdown_and_close()


# ---- over the port's CPU sampler ---------------------------------------------


@pytest.fixture(scope="module")
def cpu_sampler():
    cfg = tcfg.debug_config(use_pallas_kernels=True, **TINY)
    return Sampler(cfg, n_samples=4, device="cpu", init_seed=3)


def test_cpu_sampler_served_bitwise_and_stats_during_a_dispatch(
        cpu_sampler, monkeypatch):
    """Served rows are bitwise a direct call at the dispatch's seed, and
    ``/stats`` (the sampler's ``info``) answers while a dispatch is held
    inside the model."""
    from nvae_torch.models.nvae import NVAE

    direct = cpu_sampler(dispatch_seed(0, 0), torch.full((4,), 0.8)).numpy()
    entered, release = threading.Event(), threading.Event()
    real = NVAE.sample

    def held(model, *args, **kwargs):
        entered.set()
        assert release.wait(30)
        return real(model, *args, **kwargs)

    monkeypatch.setattr(NVAE, "sample", held)
    httpd = serve(cpu_sampler, 4, port=0, max_delay_ms=2.0, block=False)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        r=_post(httpd, {"n": 4, "temperature": 0.8})))
    try:
        t.start()
        assert entered.wait(30)
        t0 = time.monotonic()
        stats = _get(httpd, "/stats")
        assert time.monotonic() - t0 < 0.5
        assert stats["weights"]["serve_dtype"] == "float32"
        assert "r" not in out  # the dispatch is still held
    finally:
        release.set()
        t.join(30)
        httpd.shutdown_and_close()
    np.testing.assert_array_equal(np.load(io.BytesIO(out["r"][2])), direct)


def _artifact(tmp_path, name, batch, per_sample=True):
    cfg = tcfg.debug_config(**TINY)
    from nvae_torch.models.nvae import NVAE

    sd = NVAE(cfg, device="cpu", seed=0).state_dict()
    path = str(tmp_path / name)
    export_sampler(path, cfg, sd, batch, per_sample_temperature=per_sample,
                   serve_dtype="int8")
    return path, cfg, sd


def test_artifact_batch_inferred_and_served(tmp_path):
    path, cfg, sd = _artifact(tmp_path, "s.pt", 4)
    call, batch = serving_http._build_call_from_artifact(path, "cpu")
    assert batch == 4
    t = torch.linspace(0.6, 1.0, 4)
    live = Sampler(cfg, sd, 4, serve_dtype="int8", device="cpu")
    assert torch.equal(call(3, t), live(3, t))
    httpd = serve(call, batch, port=0, max_delay_ms=0.0, block=False)
    try:
        status, _, body = _post(httpd, {"n": 4, "temperature": 0.8})
        assert status == 200
        assert np.load(io.BytesIO(body)).shape == (4, 32, 32, 1)
        assert _get(httpd, "/stats")["weights"]["serve_dtype"] == "int8"
    finally:
        httpd.shutdown_and_close()
    scalar, _, _ = _artifact(tmp_path, "scalar.pt", 4, per_sample=False)
    with pytest.raises(SystemExit, match="per_sample_temperature"):
        serving_http._build_call_from_artifact(scalar, "cpu")


def test_multi_artifact_serving_and_reload(tmp_path):
    a2, _, _ = _artifact(tmp_path, "s2.pt", 2)
    a6, _, _ = _artifact(tmp_path, "s6.pt", 6)
    call, batches = serving_http._build_calls_from_artifacts([a6, a2], "cpu")
    assert batches == [2, 6]
    httpd = serve(call, batches, port=0, max_delay_ms=3.0, block=False,
                  reloader_factory=serving_http._artifact_reloader_factory(
                      [a6, a2], "cpu"))
    try:
        assert np.load(io.BytesIO(_post(
            httpd, {"n": 2, "temperature": 0.8})[2])).shape[0] == 2
        assert np.load(io.BytesIO(_post(
            httpd, {"n": 5, "temperature": 0.8})[2])).shape[0] == 5
        assert _get(httpd, "/stats")["dispatch_shapes"] == {"2": 1, "6": 1}
        status, _, body = _post(httpd, {}, path="/reload")
        assert status == 200 and json.loads(body)["batch"] == [2, 6]
        assert httpd.sampler.call_fn is not call
    finally:
        httpd.shutdown_and_close()


def test_live_server_reloads_its_checkpoint(tmp_path):
    """``_build_call`` with ``--ckpt``: the restored step serves, and
    ``POST /reload`` swaps the latest checkpoint in."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.state import create_train_state

    cfg = tcfg.debug_config()
    _, state, _ = create_train_state(cfg, TrainConfig(), 4, device="cpu")
    d = str(tmp_path / "models")
    state.step = 3
    ckpt.save_checkpoint(d, 3, state)
    ns = argparse.Namespace(**dict(
        preset="", ckpt=d, compute_dtype="", bn_apply_dtype="",
        postprocess_depthwise=False, use_pallas=True, serve_dtype="bfloat16",
        output_dtype="uint8", use_ema=False, batch=2))
    call, factory = serving_http._build_call(ns, "cpu")
    assert call.info["step"] == 3 and call.info["serve_dtype"] == "bfloat16"
    httpd = serve(call, 2, port=0, max_delay_ms=1.0, block=False,
                  reloader_factory=factory)
    try:
        arr = np.load(io.BytesIO(_post(httpd, {"n": 2})[2]))
        assert arr.dtype == np.uint8 and arr.shape == (2, 32, 32, 1)
        state.step = 5
        ckpt.save_checkpoint(d, 5, state)
        status, _, body = _post(httpd, {}, path="/reload")
        info = json.loads(body)
        assert status == 200 and info["step"] == 5 and info["generation"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(httpd, {"step": 4}, path="/reload")
        assert ei.value.code == 404
    finally:
        httpd.shutdown_and_close()
