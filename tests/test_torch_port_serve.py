"""xgan_torch's HTTP server: the cases of tests/test_serve.py on the
port's server (``python -m xgan_torch.cli.serve --cpu``, port 0).

Responses are held against the live port model: a generator's PNG
bitwise (each request's latent is ``xgan_torch.cli.serve.latent(seed)``,
a recorded deviation from the JAX server's threefry draw), a
classifier's probability within 1e-5 (f32 at other batch sizes). The
batcher, the heartbeat and ``_Metrics`` are tested in-process;
``_Metrics.render()`` must be byte-equal to src/serve.py's for the same
observations."""
import concurrent.futures
import importlib.util
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from xgan_torch.cli import serve
from xgan_torch.data.pipeline import tanh_to_u8
from xgan_torch.io_ import export
from xgan_torch.models import cgan, dcgan
from xgan_torch.models.resnet import ResNet50
from xgan_torch.native.png import decode_png_bytes, encode_png

torch.set_num_threads(1)

LATENT, FG, SIZE = 16, 8, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _export(kind, model, path, meta=None):
    ep = export.export_program(
        export.build_program(kind, model.eval()),
        export.example_inputs(kind, image_size=SIZE, latent_dim=LATENT,
                              device="cpu"))
    export.save_exported(path, ep, meta)
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    g = dcgan.Generator(LATENT, 3, FG, SIZE,
                        generator=torch.Generator().manual_seed(1))
    cg = cgan.Generator(LATENT, num_classes=3, feature_maps=FG,
                        image_size=SIZE,
                        generator=torch.Generator().manual_seed(2))
    clf = ResNet50(2, stage_sizes=(1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(3))
    torch.save(clf.state_dict(), d / "clf.pth")
    return {
        "g": g.eval(), "cg": cg.eval(), "clf": clf.eval(),
        "g_path": _export("gan", g, str(d / "gen.pt2")),
        "cg_path": _export("cgan", cg, str(d / "cgen.pt2"),
                           {"kind": "cgan", "conditional": True,
                            "latent_dim": LATENT, "num_classes": 3}),
        "clf_path": _export("classifier", clf, str(d / "clf.pt2")),
        "clf_pth": str(d / "clf.pth")}


def _start(model_path, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "xgan_torch.cli.serve", "--cpu",
         "--model-path", model_path, "--port", "0", "--image-size",
         str(SIZE), "--resnet-stages", "1,1,1,1", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    q = queue.Queue()
    threading.Thread(target=lambda: [q.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.time() + 300
    while time.time() < deadline:
        try:
            line = q.get(timeout=5)
        except queue.Empty:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"server died: stderr={proc.stderr.read()[-2000:]}")
            continue
        if "Serving" in line:
            return proc, int(line.rsplit(":", 1)[-1].strip())
    proc.kill()
    raise RuntimeError("server did not print its Serving line in 300s")


def _stop(proc):
    proc.terminate()
    assert proc.wait(timeout=30) == 0


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.headers, r.read()


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _generate(port, body):
    status, headers, out = _post(port, "/generate", body)
    assert status == 200 and headers["Content-Type"] == "image/png", out
    return decode_png_bytes(out)


def _want_image(model, seed, label=None):
    z = serve.latent(seed, LATENT)[None]
    with torch.no_grad():
        out = model(z) if label is None else model(
            z, torch.tensor([label]))
    return tanh_to_u8(out)[0].numpy()


@pytest.fixture(scope="module")
def gen_server(models):
    """A generator server with --max-batch 4 and a 0.2 s heartbeat."""
    proc, port = _start(models["g_path"], "--max-batch", "4",
                        "--heartbeat", "0.2")
    yield port
    _stop(proc)


def test_serve_generator_artifact(models, gen_server):
    """A generator .pt2 serves POST /generate: the PNG equals the live
    model's for the request's latent; the error envelope; a junk label
    is ignored by an unconditional generator."""
    port = gen_server
    health = json.loads(_get(port, "/healthz")[1])
    assert health["kind"] == "generator" and health["max_batch"] == 4
    assert health["latent_dim"] == LATENT and not health["conditional"]
    assert health["image_size"] == SIZE
    # the server runs every generator dispatch at --max-batch rows: the
    # live model at 4 rows, this seed's first
    z = torch.stack([serve.latent(3, LATENT)] * 4)
    with torch.no_grad():
        want = tanh_to_u8(models["g"](z))[0].numpy()
    np.testing.assert_array_equal(
        _generate(port, json.dumps({"seed": 3}).encode()), want)
    status, _, out = _post(port, "/predict", b"{}")
    assert status == 404 and "generators" in json.loads(out)["error"]
    for bad in (b"5", b"null", b'"x"', b"[1]"):
        status, _, out = _post(port, "/generate", bad)
        assert status == 400 and "error" in json.loads(out), bad
    status, _, out = _post(port, "/generate",
                           json.dumps({"seed": 2 ** 64}).encode())
    assert status == 400 and "seed" in json.loads(out)["error"]
    assert _generate(port, b"").shape == (SIZE, SIZE, 3)  # seed 0
    np.testing.assert_array_equal(_generate(port, json.dumps(
        {"seed": 3, "label": "positive"}).encode()), want)


def test_serve_generate_concurrent_batching(models, gen_server):
    """8 concurrent /generate requests (distinct seeds) through the
    --max-batch 4 server each get their own seed's image, bitwise the
    live model's and a later unbatched request's."""
    port = gen_server
    seeds = list(range(8))
    z = torch.stack([serve.latent(s, LATENT) for s in seeds])
    with torch.no_grad():
        want = tanh_to_u8(models["g"](z)).numpy()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda s: _generate(port, json.dumps(
            {"seed": s}).encode()), seeds))
    for i, img in enumerate(got):
        np.testing.assert_array_equal(img, want[i], err_msg=str(i))
    np.testing.assert_array_equal(
        _generate(port, json.dumps({"seed": 5}).encode()), want[5])


def test_serve_healthz_heartbeat_fields(gen_server):
    port = gen_server
    deadline = time.time() + 60
    while time.time() < deadline:
        health = json.loads(_get(port, "/healthz")[1])
        if "heartbeat_latency_s" in health:
            break
        time.sleep(0.2)
    assert health["ok"] and health["device_ok"]
    assert health["heartbeat_latency_s"] >= 0
    assert health["heartbeat_age_s"] < 60


def _counter(text, line):
    for ln in text.splitlines():
        if ln.startswith(line + " "):
            return int(ln.rsplit(" ", 1)[1])
    return 0


def test_serve_metrics_endpoint(gen_server):
    """GET /metrics reflects the traffic served (2 good /generate, one
    structured 400, a healthz scrape); heartbeat probes stay out of the
    batcher's rows."""
    port = gen_server
    before = _get(port, "/metrics")[1].decode()
    for seed in (1, 2):
        _generate(port, json.dumps({"seed": seed}).encode())
    assert _post(port, "/generate", b"[1,2]")[0] == 400
    _get(port, "/healthz")
    headers, body = _get(port, "/metrics")
    assert headers["Content-Type"].startswith("text/plain")
    after = body.decode()
    for line, n in (
            ('xgan_requests_total{endpoint="/generate",code="200"}', 2),
            ('xgan_requests_total{endpoint="/generate",code="400"}', 1),
            ('xgan_requests_total{endpoint="/healthz",code="200"}', 1),
            ('xgan_request_latency_seconds_count{endpoint="/generate"}', 3),
            ("xgan_batch_rows_total", 2),
            ("xgan_batch_padded_rows_total", 6)):
        assert _counter(after, line) - _counter(before, line) == n, line


def test_serve_conditional_generator_label_contract(models):
    """The class count comes from the envelope (3), not --num-classes;
    out-of-range labels are a structured 400."""
    proc, port = _start(models["cg_path"])
    try:
        health = json.loads(_get(port, "/healthz")[1])
        assert health["conditional"] and health["num_classes"] == 3
        np.testing.assert_array_equal(
            _generate(port, json.dumps({"seed": 5, "label": 2}).encode()),
            _want_image(models["cg"], 5, 2))
        for bad in (3, 7, -1):
            status, _, out = _post(port, "/generate", json.dumps(
                {"seed": 0, "label": bad}).encode())
            assert status == 400 and "label" in json.loads(out)["error"]
    finally:
        _stop(proc)


def _png_bodies(n, seed):
    imgs = np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3),
                                                np.uint8)
    return imgs, [encode_png(img) for img in imgs]


def _want_probs(model, imgs):
    with torch.no_grad():
        return export.make_classifier_infer(model)(
            torch.from_numpy(imgs))[1].numpy()


def test_serve_predict_concurrent_batching(models):
    """12 concurrent /predict requests through --max-batch 4 each get
    their own image's probability (within 1e-5 of the live model)."""
    imgs, bodies = _png_bodies(12, 7)
    want = _want_probs(models["clf"], imgs)
    proc, port = _start(models["clf_path"], "--max-batch", "4")
    try:
        assert json.loads(_get(port, "/healthz")[1])["max_batch"] == 4
        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            results = list(pool.map(lambda b: _post(port, "/predict", b),
                                    bodies))
        for i, (status, _, out) in enumerate(results):
            assert status == 200, out
            assert abs(json.loads(out)["prob_positive"] - want[i]) < 1e-5
    finally:
        _stop(proc)


@pytest.mark.parametrize("fmt", ["pt2", "pth"])
def test_serve_predict_parity(models, fmt):
    """A classifier artifact or checkpoint serves /predict like the port's
    predict program; an undecodable body is a structured 400 and the
    server lives on."""
    imgs, bodies = _png_bodies(1, 0)
    want = float(_want_probs(models["clf"], imgs)[0])
    proc, port = _start(models[f"clf_{'path' if fmt == 'pt2' else 'pth'}"])
    try:
        health = json.loads(_get(port, "/healthz")[1])
        assert health["ok"] and health["image_size"] == SIZE
        status, _, out = _post(port, "/predict", bodies[0])
        assert status == 200
        out = json.loads(out)
        assert out["label"] in (0, 1)
        assert abs(out["prob_positive"] - want) < 1e-5
        status, _, out = _post(port, "/predict", b"not a png")
        assert status == 400 and "error" in json.loads(out)
        assert _post(port, "/predict", bodies[0])[0] == 200
    finally:
        _stop(proc)


def test_serve_graceful_drain(models):
    """SIGTERM: the in-flight request gets its 200, new POSTs a 503, and
    /healthz a 503 with draining: true; then the process exits 0."""
    proc, port = _start(models["g_path"])
    try:
        body = json.dumps({"seed": 3}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                  b"Connection: close\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode()
                  + body[:1])
        time.sleep(1.0)  # the handler thread is in its body read
        proc.send_signal(signal.SIGTERM)
        drained = None
        deadline = time.time() + 20
        while time.time() < deadline:
            try:
                _get(port, "/healthz")
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    drained = json.loads(e.read())
                    break
            time.sleep(0.05)
        assert drained is not None and drained.get("draining") is True
        status, _, out = _post(port, "/generate", json.dumps(
            {"seed": 1}).encode())
        assert status == 503 and "draining" in json.loads(out)["error"]
        s.sendall(body[1:])
        s.settimeout(60)
        buf = b""
        while chunk := s.recv(65536):
            buf += chunk
        s.close()
        head, _, payload = buf.partition(b"\r\n\r\n")
        assert b"200" in head.split(b"\r\n", 1)[0]
        assert payload.startswith(b"\x89PNG")
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_without_a_card_refuses(models, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks CUDA-less hosts")
    with pytest.raises(SystemExit) as e:
        serve.main(["--model-path", models["g_path"]])
    assert e.value.code == 1
    assert capsys.readouterr().out.startswith("Error: ")


# ---- in-process units --------------------------------------------------

def test_batcher_timeout_and_error_paths():
    gate = threading.Event()

    def hanging_run(items, bucket):
        gate.wait(30)
        return [(0, 0.0)] * len(items)

    b = serve._Batcher(hanging_run, max_batch=4)
    img = np.zeros((8, 8, 3), np.uint8)
    t0 = time.time()
    with pytest.raises(TimeoutError):
        b.submit(img, timeout=0.5)
    assert time.time() - t0 < 5
    def abandoned():  # queued, then given up on
        with pytest.raises(TimeoutError):
            b.submit(img, timeout=0.2)

    threading.Thread(target=abandoned, daemon=True).start()
    time.sleep(0.6)
    with b.cond:
        assert not b.queue
    gate.set()

    def raising_run(items, bucket):
        raise RuntimeError("device fell over")

    b2 = serve._Batcher(raising_run, max_batch=4)
    results = []

    def client():
        try:
            b2.submit(img, timeout=10)
        except RuntimeError as e:
            results.append(str(e))

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert not any(t.is_alive() for t in threads)
    assert results == ["device fell over"] * 3
    b2.run_bucket = lambda items, bucket: [(1, 0.5)] * len(items)
    assert b2.submit(img, timeout=10) == (1, 0.5)


def test_batcher_buckets():
    """Powers of 2 up to max_batch by default; given buckets otherwise
    (a generator server's one: --max-batch)."""
    assert serve._Batcher(lambda i, b: i, max_batch=8).buckets == [1, 2, 4, 8]
    assert serve._Batcher(lambda i, b: i, max_batch=6).buckets == [1, 2, 4, 6]
    seen = []
    b = serve._Batcher(lambda items, bucket: seen.append(bucket) or items,
                       max_batch=8, buckets=[8])
    assert b.submit("x", timeout=10) == "x" and seen == [8]


def test_heartbeat_tracks_latency_and_staleness():
    broken = threading.Event()

    def beat():
        if broken.is_set():
            raise RuntimeError("tunnel wedged")

    hb = serve._Heartbeat(beat, interval=0.05, stale_after=0.5)
    deadline = time.time() + 10
    while hb.beats < 2 and time.time() < deadline:
        time.sleep(0.02)
    ok, s = hb.status()
    assert ok and s["device_ok"] and s["heartbeat_latency_s"] >= 0
    assert "heartbeat_error" not in s
    broken.set()
    deadline = time.time() + 10
    while time.time() < deadline:
        ok, s = hb.status()
        if not ok:
            break
        time.sleep(0.05)
    assert not ok and not s["device_ok"]
    assert "wedged" in s["heartbeat_error"]
    broken.clear()
    deadline = time.time() + 10
    while time.time() < deadline:
        ok, s = hb.status()
        if ok:
            break
        time.sleep(0.05)
    assert ok and "heartbeat_error" not in s


def test_heartbeat_startup_grace():
    gate = threading.Event()
    hb = serve._Heartbeat(lambda: gate.wait(30), interval=0.05,
                          stale_after=5.0)
    ok, s = hb.status()
    assert ok and s["device_ok"]
    gate.set()


def _jax_serve_module():
    spec = importlib.util.spec_from_file_location(
        "jax_serve", os.path.join(ROOT, "src", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metrics_render_is_byte_equal_to_jax():
    ours, theirs = serve._Metrics(), _jax_serve_module()._Metrics()
    for m in (ours, theirs):
        m.observe_request("/predict", 200, 0.05)
        m.observe_request("/predict", 200, 0.3)
        m.observe_request("/predict", 400, 0.001)
        m.observe_request("/generate", 503, 12.5)
        m.observe_request("other", 404, 0.0)
        m.observe_batch(3, 4, 0.02)
        m.observe_batch(4, 4, 0.02)
        m.observe_batch(1, 8, 3.0)
        m.observe_rejected()
    text = ours.render()
    assert text == theirs.render()
    lines = text.splitlines()
    assert 'xgan_requests_total{endpoint="/predict",code="200"} 2' in lines
    assert ('xgan_request_latency_seconds_bucket{endpoint="/predict",'
            'le="+Inf"} 3') in lines
    assert "xgan_batch_padded_rows_total 8" in lines
    assert "xgan_batch_rejected_total 1" in lines
    assert serve._Metrics().render() == _jax_serve_module()._Metrics().render()


def test_batcher_probe_submissions_excluded_from_metrics():
    m = serve._Metrics()
    b = serve._Batcher(lambda items, bucket: list(range(len(items))),
                       max_batch=4, metrics=m)
    for _ in range(5):
        b.submit("probe", probe=True)
    assert m.batches == 0 and m.rows == 0 and m.padded == 0
    assert m.batch_size == {} and m.device[1] == 0
    b.submit("real")
    assert m.batches == 1 and m.rows == 1 and m.device[1] == 1


def test_batcher_backpressure_overload():
    entered, release = threading.Event(), threading.Event()

    def blocking_run(items, bucket):
        entered.set()
        release.wait(30)
        return ["ok"] * len(items)

    metrics = serve._Metrics()
    b = serve._Batcher(blocking_run, max_batch=1, metrics=metrics,
                       max_queue=2)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(b.submit("p", timeout=30)),
        daemon=True) for _ in range(3)]
    threads[0].start()
    assert entered.wait(10)
    threads[1].start()
    threads[2].start()
    deadline = time.time() + 10
    while time.time() < deadline:
        with b.cond:
            if len(b.queue) == 2:
                break
        time.sleep(0.01)
    with b.cond:
        assert len(b.queue) == 2
    t0 = time.time()
    with pytest.raises(serve.Overloaded):
        b.submit("p4", timeout=30)
    assert time.time() - t0 < 1.0
    probe_res = []
    pt = threading.Thread(target=lambda: probe_res.append(
        b.submit("probe", timeout=30, probe=True)), daemon=True)
    pt.start()
    release.set()
    for t in threads:
        t.join(timeout=15)
    pt.join(timeout=15)
    assert results == ["ok"] * 3 and probe_res == ["ok"]
    assert metrics.rejected == 1
    assert "xgan_batch_rejected_total 1" in metrics.render()


def test_latent_is_the_seeded_generator():
    """Each request's latent: the first normals of its own seeded
    torch.Generator, so a batched row equals the unbatched one."""
    for s in (0, 5, -5, 2 ** 40, 2 ** 63 - 1, -2 ** 63):
        torch.testing.assert_close(
            serve.latent(s, LATENT),
            torch.randn((LATENT,), generator=torch.Generator().manual_seed(s)),
            rtol=0, atol=0)
    assert not torch.equal(serve.latent(1, LATENT), serve.latent(2, LATENT))
