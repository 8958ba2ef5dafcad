"""Minimal HTTP model server (flags, endpoints and metrics as
src/serve.py).

    python -m xgan_torch.cli.serve --model-path M.{pt2,msgpack,pth} \
        [--port 8000] [--max-batch 0] [--heartbeat N] [--cpu] ...

Serves either model family:

    classifier  POST /predict   body = PNG bytes
                                -> {"label": 0|1, "prob_positive": float}
    generator   POST /generate  body = {"seed": int[, "label": 0|1]}
                                -> PNG bytes (one synthetic image)
    both        GET  /healthz   -> {"ok": true, "kind": ..., ...}
                GET  /metrics   -> Prometheus text

``--model-path`` takes a ``.pt2`` artifact of ``xgan_torch.cli.export_model``
(its kind, input size and latent size come from its signature, its class
count from its envelope) or a classifier checkpoint (``.msgpack`` of the
JAX package or a reference-layout ``.pth``, built with ``--image-size``).
Concurrent requests coalesce into one device dispatch (:class:`_Batcher`),
up to ``--max-batch`` (0: 8 on the card, 1 with ``--cpu``), and every
dispatch size is run once before the server reports ready (the kernels'
build, cuDNN's choices). ``/predict`` decodes with the port's PNG decoder
and resizes with the store's resize; ``/generate`` encodes with the port's
PNG encoder.

Each ``/generate`` request's latent is drawn on the host from its own
``torch.Generator().manual_seed(seed)`` (the JAX server uses
``jax.random.key(seed)``, whose threefry bits the port does not
reproduce: a recorded deviation, as the samplers' draws). A generator
dispatch always runs at ``--max-batch`` rows, so a batched response is
bitwise the unbatched one: a batch of one row would otherwise run the
first layer's product on another kernel (a matrix-vector one) than a
batch of several.

``--heartbeat N`` probes the device every N seconds through the serving
path and turns ``/healthz`` into a readiness check; ``--max-queue``
bounds the wait queue (503 + Retry-After beyond it); SIGTERM drains:
in-flight requests finish within ``--drain-grace`` seconds, new ones get
503, then the server exits 0. Runs on the CUDA device unless ``--cpu`` is
given; without a CUDA device it exits 1 with a structured ``Error:``
line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from xgan_torch import config


def build_parser():
    p = argparse.ArgumentParser(
        description="Serve a trained xgan model over HTTP (PyTorch/CUDA)")
    p.add_argument("--model-path", type=str, required=True,
                   help=".pt2 artifact (xgan_torch.cli.export_model; "
                        "classifier or generator) or classifier checkpoint "
                        "(.msgpack/.pth)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--image-size", type=int, default=224,
                   help="checkpoint inputs only; artifacts carry their "
                        "own input signature")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--max-batch", type=int, default=0,
                   help="dynamic micro-batching cap (/predict images, "
                        "/generate seeds): concurrent requests coalesce "
                        "into one device batch (power-of-2 bucket "
                        "padding, every bucket run before traffic). 0 = "
                        "auto: 8 on the card (launch overhead dominates a "
                        "b=1 forward), 1 on the CPU")
    p.add_argument("--max-queue", type=int, default=0,
                   help="overload backpressure: reject a request with "
                        "503 + Retry-After the moment this many are "
                        "already waiting for the device. 0 = auto: "
                        "max(32, 4*max_batch); negative = unbounded")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="seconds to let in-flight requests finish after "
                        "SIGTERM/SIGINT before the server stops; during "
                        "the drain /healthz turns 503 (draining: true) "
                        "and new POSTs get 503 + Retry-After")
    p.add_argument("--heartbeat", type=float, default=0.0,
                   help="device-liveness heartbeat period in seconds "
                        "(0 = off): a background thread runs the real "
                        "inference program through the serving path and "
                        "/healthz reports device_ok + latency, going 503 "
                        "when the last success is stale")
    config.add_device_arg(p)
    config.add_compute_dtype_arg(p)  # checkpoints only; artifacts baked
    config.add_resnet_stages_arg(p)  # theirs at export
    return p


class _Metrics:
    """Prometheus-text-exposition counters behind GET /metrics (the JAX
    server's names, buckets and text). Everything is guarded by one lock;
    the scrape renders a consistent snapshot."""

    LAT_BUCKETS = (0.005, 0.025, 0.1, 0.5, 2.5, 10.0)  # seconds

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = {}      # (endpoint, code) -> count
        self.lat = {}           # endpoint -> [sum, count, per-le counts]
        self.batches = 0        # batcher dispatches
        self.rows = 0           # real rows inferred through the batcher
        self.padded = 0         # pad rows dispatched (bucket - occupancy)
        self.batch_size = {}    # dispatch occupancy n -> count
        self.rejected = 0       # submits refused at --max-queue depth
        self.device = [0.0, 0, [0] * (len(self.LAT_BUCKETS) + 1)]

    def observe_rejected(self):
        with self.lock:
            self.rejected += 1

    def _observe(self, holder, seconds):
        holder[0] += seconds
        holder[1] += 1
        for i, le in enumerate(self.LAT_BUCKETS):
            if seconds <= le:
                holder[2][i] += 1
        holder[2][-1] += 1  # +Inf

    def observe_request(self, endpoint, code, seconds):
        with self.lock:
            key = (endpoint, int(code))
            self.requests[key] = self.requests.get(key, 0) + 1
            h = self.lat.setdefault(
                endpoint, [0.0, 0, [0] * (len(self.LAT_BUCKETS) + 1)])
            self._observe(h, seconds)

    def observe_batch(self, n, bucket, seconds):
        with self.lock:
            self.batches += 1
            self.rows += n
            self.padded += bucket - n
            self.batch_size[n] = self.batch_size.get(n, 0) + 1
            self._observe(self.device, seconds)

    def _hist_lines(self, out, name, labels, holder):
        for le, c in zip(self.LAT_BUCKETS, holder[2]):
            out.append(f'{name}_bucket{{{labels}le="{le}"}} {c}')
        out.append(f'{name}_bucket{{{labels}le="+Inf"}} {holder[2][-1]}')
        out.append(f'{name}_sum{{{labels[:-1]}}} {holder[0]:.6f}'
                   if labels else f'{name}_sum {holder[0]:.6f}')
        out.append(f'{name}_count{{{labels[:-1]}}} {holder[1]}'
                   if labels else f'{name}_count {holder[1]}')

    def render(self) -> str:
        with self.lock:
            out = ["# TYPE xgan_requests_total counter"]
            for (ep, code), c in sorted(self.requests.items()):
                out.append(f'xgan_requests_total{{endpoint="{ep}",'
                           f'code="{code}"}} {c}')
            out.append("# TYPE xgan_request_latency_seconds histogram")
            for ep, h in sorted(self.lat.items()):
                self._hist_lines(out, "xgan_request_latency_seconds",
                                 f'endpoint="{ep}",', h)
            out.append("# TYPE xgan_batch_dispatches_total counter")
            out.append(f"xgan_batch_dispatches_total {self.batches}")
            out.append("# TYPE xgan_batch_rows_total counter")
            out.append(f"xgan_batch_rows_total {self.rows}")
            out.append("# TYPE xgan_batch_padded_rows_total counter")
            out.append(f"xgan_batch_padded_rows_total {self.padded}")
            out.append("# TYPE xgan_batch_rejected_total counter")
            out.append(f"xgan_batch_rejected_total {self.rejected}")
            out.append("# TYPE xgan_batch_occupancy counter")
            for n, c in sorted(self.batch_size.items()):
                out.append(f'xgan_batch_occupancy{{rows="{n}"}} {c}')
            out.append("# TYPE xgan_device_dispatch_seconds histogram")
            self._hist_lines(out, "xgan_device_dispatch_seconds", "",
                             self.device)
            return "\n".join(out) + "\n"


class Overloaded(Exception):
    """Raised by _Batcher.submit when the wait queue is at --max-queue:
    an immediate 503 + Retry-After instead of another parked handler
    thread holding its decoded payload."""


class _Batcher:
    """Dynamic micro-batching: requests that arrive while the device is
    busy run together in the next dispatch (up to ``max_batch``); an idle
    server dispatches at once. Each dispatch is padded to the next of
    ``buckets`` (default the powers of 2 up to ``max_batch``), so a
    handful of shapes serve every load. Rows are independent for both
    model kinds, so pad rows cannot perturb real ones.

    ``run_bucket(items, bucket)`` receives the queued payloads (n <=
    bucket) and the bucket, runs one padded device dispatch, and returns
    one result per item."""

    def __init__(self, run_bucket, max_batch: int, metrics=None,
                 max_queue: int = 0, buckets=None):
        self.run_bucket = run_bucket
        self.max_batch = max_batch
        self.max_queue = max_queue  # 0 = unbounded
        self.metrics = metrics
        if buckets is None:
            buckets, b = [], 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = list(buckets)
        self.cond = threading.Condition()
        self.queue = []  # (payload, slot dict) pairs
        threading.Thread(target=self._worker, daemon=True).start()

    def submit(self, payload, timeout: float = 300.0,
               probe: bool = False):
        """Queue ``payload`` and wait for its result. ``probe`` (the
        heartbeat) rides the real path but stays out of the batcher
        metrics and past the ``max_queue`` bound."""
        slot = {"event": threading.Event(), "probe": probe}
        item = (payload, slot)
        with self.cond:
            if (self.max_queue and not probe
                    and len(self.queue) >= self.max_queue):
                if self.metrics is not None:
                    self.metrics.observe_rejected()
                raise Overloaded(
                    f"inference queue full ({self.max_queue} waiting)")
            self.queue.append(item)
            self.cond.notify()
        # bounded wait: a hung device call must not park every later
        # request's handler thread forever while /healthz stays ok
        if not slot["event"].wait(timeout):
            with self.cond:  # drop it if still queued (by identity)
                self.queue = [it for it in self.queue if it is not item]
            raise TimeoutError(f"inference did not complete in "
                               f"{timeout:.0f}s")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _worker(self):
        while True:
            with self.cond:
                while not self.queue:
                    self.cond.wait()
                batch = self.queue[:self.max_batch]
                del self.queue[:self.max_batch]
            n = len(batch)
            bucket = next(b for b in self.buckets if b >= n)
            try:
                t0 = time.time()
                results = self.run_bucket([p for p, _ in batch], bucket)
                # probe rows count as pad; a pure-probe dispatch is
                # unrecorded
                n_real = sum(1 for _, s in batch if not s.get("probe"))
                if self.metrics is not None and n_real:
                    self.metrics.observe_batch(n_real, bucket,
                                               time.time() - t0)
                for (_, slot), res in zip(batch, results):
                    slot["result"] = res
                    slot["event"].set()
            except Exception as e:  # wake waiters; surface as HTTP 500
                for _, slot in batch:
                    slot["error"] = e
                    slot["event"].set()


class _Heartbeat:
    """Background device-liveness prober backing /healthz readiness: runs
    ``beat_fn`` (the real inference path) every ``interval`` seconds and
    records latency and outcome; :meth:`status` turns unhealthy once the
    last success is older than ``stale_after``. A beat that hangs blocks
    the prober, and the growing age is the signal. Start-up counts as a
    success (the server just ran every dispatch size). :meth:`stop` ends
    the prober after its current beat, so that no beat runs on the
    device while the process exits."""

    def __init__(self, beat_fn, interval: float, stale_after=None):
        self._time = time.time
        self.beat_fn = beat_fn
        self.interval = interval
        self.stale_after = (stale_after if stale_after is not None
                            else max(3.0 * interval, interval + 60.0))
        self.last_ok = self._time()
        self.latency = None
        self.error = None
        self.beats = 0
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 60.0) -> None:
        self._stopped.set()
        self._thread.join(timeout)

    def _loop(self):
        while not self._stopped.is_set():
            t0 = self._time()
            try:
                self.beat_fn()
                self.latency = self._time() - t0
                self.last_ok = self._time()
                self.error = None
            except Exception as e:  # noqa: BLE001 — any failure is the
                self.error = str(e)  # signal, not a crash
            self.beats += 1
            self._stopped.wait(self.interval)

    def status(self):
        age = self._time() - self.last_ok
        ok = age < self.stale_after
        s = {"device_ok": ok, "heartbeat_age_s": round(age, 1)}
        if self.latency is not None:
            s["heartbeat_latency_s"] = round(self.latency, 4)
        if self.error is not None:
            s["heartbeat_error"] = self.error
        return ok, s


def latent(seed: int, latent_dim: int):
    """A request's latent: ``latent_dim`` normals from its own
    ``torch.Generator().manual_seed(seed)`` on the host."""
    import torch
    return torch.randn((latent_dim,),
                       generator=torch.Generator().manual_seed(seed))


def make_model(args, device):
    """Returns a descriptor dict: kind 'classifier' (infer_batch,
    image_size) or kind 'generator' (generate_batch, latent_dim,
    conditional, num_classes). Raises ValueError for what it cannot
    serve."""
    import torch

    from xgan_torch.io_.export import EXT, load_exported_with_meta
    if args.model_path.endswith(".stablehlo"):
        raise ValueError(f"{args.model_path}: .stablehlo needs JAX; export "
                         "a .pt2 with python -m xgan_torch.cli.export_model")
    if args.model_path.endswith(EXT):
        art, meta = load_exported_with_meta(args.model_path, device)
        meta = meta or {}
        ins = art.inputs
        if len(ins) == 1 and len(ins[0][0]) == 4 \
                and ins[0][1] == torch.uint8:
            return {"kind": "classifier", "infer_batch": art.call,
                    "image_size": int(ins[0][0][1])}
        if len(ins) in (1, 2) and len(ins[0][0]) == 2 \
                and ins[0][1] == torch.float32:
            return {"kind": "generator", "generate_batch": art.call,
                    "latent_dim": int(ins[0][0][1]),
                    "conditional": len(ins) == 2,
                    "num_classes": meta.get("num_classes",
                                            args.num_classes)}
        raise ValueError(
            f"{args.model_path}: unrecognized artifact signature {ins}; "
            "expected a classifier (one uint8 (b,s,s,3) input) or "
            "generator (float32 (b,latent) [+ int32 labels]) export from "
            "xgan_torch.cli.export_model")
    from xgan_torch.io_.checkpoint import load_classifier_variables
    from xgan_torch.io_.export import make_classifier_infer
    from xgan_torch.models.resnet import ResNet50
    model = ResNet50(args.num_classes, stage_sizes=args.resnet_stages,
                     dtype=config.resolve_dtype(args.compute_dtype, device),
                     device=device)
    load_classifier_variables(args.model_path, model)
    infer = make_classifier_infer(model.eval())

    def infer_batch(x):
        with torch.no_grad():
            return infer(x)
    return {"kind": "classifier", "infer_batch": infer_batch,
            "image_size": args.image_size}


def make_batcher(desc, device, mb: int, metrics, mq: int):
    """The batcher of ``desc``'s kind, with every dispatch size run once.
    A generator dispatch always runs at ``mb`` rows (see the module
    docstring)."""
    import numpy as np
    import torch

    if desc["kind"] == "classifier":
        size = desc["image_size"]

        def run_bucket(items, bucket):
            imgs = np.stack(items)
            if imgs.shape[0] < bucket:  # pad rows: repeat the last
                imgs = np.concatenate(
                    [imgs, np.repeat(imgs[-1:], bucket - imgs.shape[0], 0)])
            labels, probs = desc["infer_batch"](
                torch.from_numpy(imgs).to(device))
            labels, probs = labels.cpu(), probs.float().cpu()
            return [(int(labels[i]), float(probs[i]))
                    for i in range(len(items))]

        batcher = _Batcher(run_bucket, mb, metrics=metrics, max_queue=mq)
        for b in batcher.buckets:
            run_bucket([np.zeros((size, size, 3), np.uint8)] * b, b)
        return batcher

    conditional = desc["conditional"]

    def run_bucket(items, bucket):
        # items: (latent (L,), label int) per request
        z = torch.stack([zi for zi, _ in items])
        labs = torch.tensor([lb for _, lb in items], dtype=torch.int32)
        pad = bucket - len(items)
        if pad:
            z = torch.cat([z, z[-1:].expand(pad, -1)])
            labs = torch.cat([labs, labs[-1:].expand(pad)])
        z, labs = z.to(device), labs.to(device)
        imgs = (desc["generate_batch"](z, labs) if conditional
                else desc["generate_batch"](z))
        imgs = imgs.cpu().numpy()
        return [imgs[i] for i in range(len(items))]

    batcher = _Batcher(run_bucket, mb, metrics=metrics, max_queue=mq,
                       buckets=[mb])
    img = run_bucket([(latent(0, desc["latent_dim"]), 0)] * mb, mb)[0]
    desc["image_size"] = int(img.shape[0])
    return batcher


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        device = config.resolve_device(args.cpu)
    except RuntimeError as e:
        print(f"Error: {e}")
        sys.exit(1)

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from xgan_torch.data.store import resize_u8
    from xgan_torch.native.png import decode_png_bytes, encode_png

    if not os.path.exists(args.model_path):
        print(f"Error: model not found at {args.model_path}")
        sys.exit(1)
    metrics = _Metrics()
    mb = max(1, args.max_batch or (1 if device.type == "cpu" else 8))
    # deep enough that a healthy device never trips it, shallow enough
    # that a wedged one rejects in seconds, not in the submit timeout
    mq = (args.max_queue if args.max_queue > 0
          else (0 if args.max_queue < 0 else max(32, 4 * mb)))
    try:
        desc = make_model(args, device)
        batcher = make_batcher(desc, device, mb, metrics, mq)
    except Exception as e:  # noqa: BLE001 — structured CLI error contract
        print(f"Error loading model: {e}")
        sys.exit(1)
    model_name = os.path.basename(args.model_path)
    kind = desc["kind"]
    size = desc["image_size"]
    compiled = device.type == "cuda"  # the compiled PNG unfilter
    health = {"ok": True, "model": model_name, "kind": kind,
              "image_size": size, "max_batch": batcher.max_batch}
    if kind == "generator":
        health.update(latent_dim=desc["latent_dim"],
                      conditional=desc["conditional"])
        if desc["conditional"]:
            health.update(num_classes=desc["num_classes"])

    heartbeat = None
    if args.heartbeat > 0:
        probe = (np.zeros((size, size, 3), np.uint8)
                 if kind == "classifier"
                 else (latent(0, desc["latent_dim"]), 0))
        beat_timeout = max(2.0 * args.heartbeat, 30.0)

        def beat():
            batcher.submit(probe, timeout=beat_timeout, probe=True)
        heartbeat = _Heartbeat(beat, args.heartbeat)

    # graceful drain (SIGTERM/SIGINT): finish what is in flight, refuse
    # new work with a structured 503, turn /healthz to draining, exit 0;
    # a second signal stops at once
    draining = threading.Event()
    active = [0]                 # in-flight POST bodies
    active_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        # a client that under-delivers Content-Length must not pin a
        # handler thread forever
        timeout = 120

        def _json(self, code, obj, retry_after=None):
            self._code = code
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        def _observed(self, inner):
            """Run a handler body and record endpoint/code/latency;
            unknown paths collapse to one 'other' label."""
            t0 = time.time()
            self._code = 0  # 0 = no response written (client gone)
            try:
                inner()
            finally:
                path = (self.path if self.path in
                        ("/predict", "/generate", "/healthz", "/metrics")
                        else "other")
                metrics.observe_request(path, self._code,
                                        time.time() - t0)

        def do_GET(self):
            self._observed(self._get)

        def _get(self):
            if self.path == "/healthz":
                payload = dict(health)
                code = 200
                if heartbeat is not None:
                    ok, hs = heartbeat.status()
                    payload.update(hs)
                    if not ok:  # readiness: pull the replica
                        code = 503
                if draining.is_set():
                    payload["draining"] = True
                    code = 503
                self._json(code, payload)
            elif self.path == "/metrics":
                self._code = 200
                body = metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def _read_body(self, limit, allow_empty=False):
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                n = -1
            if n < 0 or (n == 0 and not allow_empty) or n > limit:
                self._json(400, {"error": "bad Content-Length"})
                return None
            return self.rfile.read(n)

        def do_POST(self):
            # counted before the body read: a client mid-upload is work
            # in flight the drain waits for
            with active_lock:
                active[0] += 1
            try:
                self._observed(self._post)
            except OSError:
                pass  # client went away mid-request/response
            finally:
                with active_lock:
                    active[0] -= 1

        def _submit(self, payload, what):
            """``batcher.submit`` with the error envelope; None after an
            error response."""
            try:
                return batcher.submit(payload)
            except Overloaded as e:  # backpressure: tell the client
                self._json(503, {"error": str(e)}, retry_after=1)
            except TimeoutError as e:  # before OSError: a subclass
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep serving
                self._json(500, {"error": f"{what} failed: {e}"})
            return None

        def _post(self):
            if draining.is_set():
                self._json(503, {"error": "server draining"},
                           retry_after=1)
                return
            if self.path == "/predict" and kind == "classifier":
                body = self._read_body(64 * 1024 * 1024)
                if body is None:
                    return
                try:
                    u8 = resize_u8(decode_png_bytes(
                        body, grey16="clip", compiled=compiled), size)
                except ValueError as e:  # corrupt/unsupported image
                    self._json(400,
                               {"error": f"could not decode image: {e}"})
                    return
                out = self._submit(u8, "inference")
                if out is not None:
                    self._json(200, {"label": out[0],
                                     "prob_positive": out[1]})
                return
            if self.path == "/generate" and kind == "generator":
                body = self._read_body(1 << 16, allow_empty=True)
                if body is None:
                    return
                try:
                    req = json.loads(body or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                    seed = int(req.get("seed", 0))
                    if not -2**63 <= seed < 2**63:
                        raise ValueError("seed out of int64 range")
                    label = req.get("label")
                    if not desc["conditional"] or label is None:
                        # an unconditional generator ignores the label;
                        # a junk one must not enter the shared batch
                        label = 0
                    else:
                        label = int(label)
                        if not 0 <= label < desc["num_classes"]:
                            raise ValueError(
                                f"label must be in "
                                f"[0, {desc['num_classes']})")
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request body: {e}"})
                    return
                img = self._submit((latent(seed, desc["latent_dim"]),
                                    label), "generation")
                if img is None:
                    return
                png = encode_png(img)
                self._code = 200
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
                return
            self._json(404, {"error": f"unknown path for a {kind} model "
                                      "(classifiers serve /predict, "
                                      "generators /generate)"})

        def log_message(self, fmt, *a):  # quiet access log
            pass

    class Server(ThreadingHTTPServer):
        # a deeper listen backlog than socketserver's 5: concurrent
        # clients queue instead of being reset
        request_queue_size = 128

    srv = Server((args.host, args.port), Handler)

    import signal
    sig_count = [0]

    def _drainer():
        deadline = time.time() + max(0.0, args.drain_grace)
        while time.time() < deadline:
            with active_lock:
                if active[0] == 0:
                    break
            time.sleep(0.05)
        srv.shutdown()

    def _on_signal(signum, frame):  # on the serve_forever thread: only
        sig_count[0] += 1           # set flags and start threads here
        if sig_count[0] == 1:
            draining.set()
            print("Draining: refusing new requests; waiting up to "
                  f"{args.drain_grace:.0f}s for in-flight ones "
                  "(signal again to stop now)", flush=True)
            threading.Thread(target=_drainer, daemon=True).start()
        else:
            threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    except ValueError:
        pass  # not the main thread (an in-process test)

    print(f"Serving {model_name} ({kind}, image_size={size}) on "
          f"http://{args.host}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    srv.server_close()
    if heartbeat is not None:
        heartbeat.stop()
    if draining.is_set():
        print("Drained; exiting.", flush=True)


if __name__ == "__main__":
    main()
