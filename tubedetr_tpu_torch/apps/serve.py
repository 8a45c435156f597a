"""The HTTP server of the port (counterpart of ``tubedetr_tpu/apps/serve.py``).

A dependency-free ``http.server`` app over ``GroundingPipeline``:

* ``GET /`` lists the videos under the root (names HTML-escaped);
* ``GET /stvg?video=...&question=...&start=...&end=...`` grounds a caption
  in a video: an HTML page around the rendered tube when ffmpeg wrote one,
  else the JSON result; ``&format=json`` forces JSON;
* ``GET/POST /reload[?ckpt=path]`` swaps in a ``.pth``, the port's own
  checkpoint (its embedded int8 scales included) or a reference one;
* ``GET /media/<name>`` serves rendered artifacts from the output dir;
* ``GET /healthz`` answers without model work; ``GET /stats`` gives the
  request and error counts, latency quantiles over a sliding window, the
  queue depth, artifacts issued and uptime.

With ``serve_max_batch > 1`` concurrent ``/stvg`` requests are coalesced
into one batched forward (``ground_many``) after a window of
``serve_batch_window_ms``. SIGTERM/SIGINT drain: new inference requests
get 503 (``/healthz`` turns 503 ``draining``), admitted ones finish (up to
``SERVE_DRAIN_TIMEOUT_S``, default 30 s), then the listener stops. Video
paths must lie inside the configured root.

    python -m tubedetr_tpu_torch.apps.serve --vidstg_vid_path videos/ --port 8080
    python -m tubedetr_tpu_torch.apps.serve --device cpu ...
"""

from __future__ import annotations

import collections
import glob
import html
import json
import os
import signal
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tubedetr_tpu_torch.apps.cli import config_from_args
from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline

INDEX_HTML = """<!doctype html>
<html><head><title>TubeDETR STVG demo</title></head>
<body><h2>Spatio-Temporal Video Grounding</h2>
<form action="/stvg">
  video path: <input name="video" size="60"><br>
  question: <input name="question" size="60"><br>
  start (s): <input name="start" value="-1"> end (s): <input name="end" value="-1"><br>
  <input type="submit" value="Ground it">
</form>
<p>Videos under the configured root:</p><ul>{videos}</ul>
</body></html>"""

RESULT_HTML = """<!doctype html>
<html><head><title>TubeDETR result</title></head>
<body><h2>Grounded tube</h2>
<p>question: {question}</p>
<p>predicted segment: frames [{s}, {e})</p>
<video controls autoplay loop width="480" src="/media/{video}"></video>
<p><a href="/">back</a></p>
</body></html>"""


class Draining(RuntimeError):
    """New inference requests rejected: the server is draining for
    shutdown (mapped to HTTP 503 so a load balancer retries elsewhere)."""


class Server:
    """The grounding pipeline behind the HTTP handler: request admission,
    coalescing, drain, reload and counters. Runs on ``device``, by default
    ``cfg.device`` (the card; without one it raises)."""

    def __init__(self, cfg, video_root: str = "", device=None):
        self.cfg = cfg
        self.video_root = os.path.realpath(video_root or os.getcwd())
        self.out_dir = os.path.realpath(cfg.output_dir or "serve_out")
        self.lock = threading.Lock()
        # coalescing (serve_max_batch > 1): one dispatcher thread drains the
        # FIFO, so no request can be stranded and no waiter contends for the
        # inference lock
        self._batch_lock = threading.Lock()
        self._batch_cond = threading.Condition(self._batch_lock)
        self._pending = []
        self._seq = 0  # monotonic artifact id (never recycled)
        # graceful shutdown: reject new work, finish admitted work
        self._draining = False
        self._inflight = 0  # requests inside ground(), not yet answered
        # GET /stats: counters and a sliding latency window
        self._t0 = time.monotonic()
        self._stats_lock = threading.Lock()
        self._n_ok = 0
        self._n_err = 0
        self._lat_s = collections.deque(maxlen=256)
        # built once; every request reuses the model on the device
        self.pipeline = GroundingPipeline(cfg, device=cfg.device if device is None else device)
        if cfg.serve_max_batch > 1:
            threading.Thread(
                target=self._dispatch_loop, daemon=True, name="stvg-batch-dispatcher",
            ).start()

    def list_videos(self):
        exts = (".mp4", ".avi", ".mkv", ".npy", ".npz")
        out = []
        for root, _, files in os.walk(self.video_root):
            for f in files:
                if f.endswith(exts):
                    out.append(os.path.relpath(os.path.join(root, f), self.video_root))
            if len(out) > 200:
                break
        return sorted(out)[:200]

    def _resolve(self, rel: str, root: str) -> str:
        """Join ``rel`` onto ``root`` and reject targets escaping it."""
        path = os.path.realpath(os.path.join(root, rel))
        if path != root and not path.startswith(root + os.sep):
            raise PermissionError(f"path escapes the configured root: {rel}")
        return path

    def ground(self, video: str, question: str, start: float, end: float):
        with self._batch_cond:
            if self._draining:
                raise Draining("server is draining for shutdown")
            self._inflight += 1  # admitted: drain() now waits for us
        t0 = time.monotonic()
        try:
            try:
                result = self._ground_inner(video, question, start, end)
            except Exception:
                with self._stats_lock:
                    self._n_err += 1
                raise
            with self._stats_lock:
                self._n_ok += 1
                self._lat_s.append(time.monotonic() - t0)
            return result
        finally:
            with self._batch_cond:
                self._inflight -= 1
                self._batch_cond.notify_all()  # wake drain() waiters

    def _ground_inner(self, video, question, start, end):
        path = self._resolve(video, self.video_root)
        if self.cfg.serve_max_batch <= 1:
            with self.lock:  # one inference at a time (one card)
                return self.pipeline.ground(
                    path, question, start, end, out_dir=self.out_dir
                )
        return self._ground_batched(path, question, start, end)

    def stats(self) -> dict:
        """Operational counters for GET /stats (queue depth, error rate,
        end-to-end request-latency quantiles over the last 256 requests)."""
        with self._batch_lock:
            depth = len(self._pending)
            artifacts = self._seq
        with self._stats_lock:
            lat = sorted(self._lat_s)
            ok, err = self._n_ok, self._n_err

        def q(p):
            return (
                round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 1)
                if lat
                else None
            )

        return {
            "status": "ok",
            "uptime_s": round(time.monotonic() - self._t0, 1),
            "requests_ok": ok,
            "requests_failed": err,
            "queue_depth": depth,
            "artifacts_issued": artifacts,
            "latency_ms": {
                "window": len(lat), "p50": q(0.50), "p95": q(0.95),
                "max": round(lat[-1] * 1e3, 1) if lat else None,
            },
            "model": {
                "backbone": self.cfg.backbone,
                "backbone_quant": self.cfg.backbone_quant,
                "resolution": self.cfg.resolution,
                "serve_max_batch": self.cfg.serve_max_batch,
            },
        }

    # hang protection only: long enough for the first batch's int8
    # calibration, short enough that a wedged dispatcher surfaces as 503s
    # instead of clients waiting forever
    WAIT_TIMEOUT_S = 1800.0
    KEEP_ARTIFACTS = 64  # rendered tubes retained before cleanup

    def _ground_batched(self, path, question, start, end):
        """Request coalescing (``--serve_max_batch N``): enqueue and wait.

        The dispatcher thread (``_dispatch_loop``) drains the FIFO in
        batches of up to N, each ONE ``ground_many`` forward. Errors stay
        with their request: a failing request raises alone while its
        batchmates complete, as if each had been served on its own.
        """
        item = {
            "req": (path, question, start, end),
            "evt": threading.Event(),
            "result": None,
            "err": None,
        }
        with self._batch_cond:
            self._pending.append(item)
            self._batch_cond.notify()
        if not item["evt"].wait(timeout=self.WAIT_TIMEOUT_S):
            raise TimeoutError(
                "inference dispatcher unresponsive "
                f"(no result within {self.WAIT_TIMEOUT_S:.0f}s)"
            )
        if item["err"] is not None:
            raise item["err"]
        return item["result"]

    def _next_tags(self, n: int):
        """Monotonic artifact tags (``tube-r{seq}.mp4``), so a later batch
        never overwrites an artifact an earlier client has not fetched yet.
        Artifacts older than the last KEEP_ARTIFACTS are removed."""
        with self._batch_lock:
            seqs = list(range(self._seq, self._seq + n))
            self._seq += n
        cutoff = seqs[0] - self.KEEP_ARTIFACTS
        if cutoff > 0:
            for pat in ("tube-r*.mp4", "tube_frames-r*.npy"):
                for f in glob.glob(os.path.join(self.out_dir, pat)):
                    try:
                        num = int(
                            os.path.basename(f).split("-r")[1].split(".")[0]
                        )
                        if num < cutoff:
                            os.remove(f)
                    except (ValueError, OSError):
                        pass
        return [f"-r{s}" for s in seqs]

    def _dispatch_loop(self):
        """Single consumer: wait for work, coalesce, run, wake waiters.

        The straggler window (``--serve_batch_window_ms``) is slept only
        when the queue is not already full — a lone request pays it once, a
        saturated queue never does. Every taken item is ALWAYS woken (the
        try/finally), even if the dispatch body dies — no waiter can hang
        on a crashed consumer. ``forward`` runs under
        ``torch.inference_mode``, which is thread-local, on this thread.
        """
        window_s = max(self.cfg.serve_batch_window_ms, 0.0) / 1000.0
        while True:
            with self._batch_cond:
                while not self._pending:
                    self._batch_cond.wait()
            take = []
            try:
                with self.lock:  # serialize vs /reload + serialized ground()
                    with self._batch_lock:
                        full = (
                            len(self._pending) >= self.cfg.serve_max_batch
                        )
                    if not full and window_s > 0:
                        time.sleep(window_s)  # let concurrent arrivals join
                    with self._batch_lock:
                        take = self._pending[: self.cfg.serve_max_batch]
                        del self._pending[: len(take)]
                    if not take:
                        continue
                    results = self.pipeline.ground_many(
                        [it["req"] for it in take],
                        out_dir=self.out_dir,
                        tags=self._next_tags(len(take)),
                        return_exceptions=True,
                    )
                    for it, r in zip(take, results):
                        if isinstance(r, Exception):
                            it["err"] = r
                        else:
                            it["result"] = r
            except Exception as e:  # noqa: BLE001
                for it in take:
                    it["err"] = e
            finally:
                for it in take:
                    if it["result"] is None and it["err"] is None:
                        it["err"] = RuntimeError(
                            "dispatcher failed before producing a result"
                        )
                    it["evt"].set()

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, phase 1: stop admitting inference work
        (``ground()`` raises :class:`Draining` → HTTP 503; ``/healthz``
        flips to ``draining`` so load balancers eject this replica) and
        wait up to ``timeout`` seconds for already-admitted requests to
        finish. Returns True when the server went quiescent in time."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._batch_cond:
            self._draining = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._batch_cond.wait(timeout=left)
        return True

    def reload(self, ckpt: str = "") -> dict:
        """Swap in a reference ``.pth`` under the inference lock. Paths
        resolve against the output dir (then the working directory), never
        outside either."""
        if ckpt:
            try:
                ckpt = self._resolve(ckpt, self.out_dir)
            except (PermissionError, OSError):
                ckpt = self._resolve(ckpt, os.path.realpath(os.getcwd()))
        with self.lock:
            if not (ckpt or self.cfg.load):
                return {"reloaded": None, "detail": "no checkpoint configured"}
            path = self.pipeline.reload(ckpt or None)
            return {"reloaded": path}

    def media(self, name: str) -> bytes:
        path = self._resolve(name, self.out_dir)
        with open(path, "rb") as f:
            return f.read()


def make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("[serve]", fmt % args)

        def _send(self, code: int, body: bytes, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _do_reload(self, query: str):
            q = urllib.parse.parse_qs(query)
            try:
                out = server.reload(q.get("ckpt", [""])[0])
                self._send(200, json.dumps(out).encode(), "application/json")
            except Exception as e:  # noqa: BLE001
                self._send(500, f"error: {e}".encode(), "text/plain")

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/reload":
                self._do_reload(url.query)
            else:
                self._send(404, b"not found")

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path in ("/", "/index"):
                videos = "".join(
                    f"<li>{html.escape(v)}</li>" for v in server.list_videos()
                )
                self._send(200, INDEX_HTML.format(videos=videos).encode())
            elif url.path == "/stvg":
                q = urllib.parse.parse_qs(url.query)
                question = q.get("question", [""])[0]
                try:
                    result = server.ground(
                        q.get("video", [""])[0],
                        question,
                        float(q.get("start", ["-1"])[0]),
                        float(q.get("end", ["-1"])[0]),
                    )
                except PermissionError as e:
                    self._send(403, f"error: {e}".encode(), "text/plain")
                    return
                except (TimeoutError, Draining) as e:
                    self._send(503, f"error: {e}".encode(), "text/plain")
                    return
                except Exception as e:  # noqa: BLE001
                    self._send(500, f"error: {e}".encode(), "text/plain")
                    return
                want_json = q.get("format", [""])[0] == "json"
                if "tube_video" in result and not want_json:
                    page = RESULT_HTML.format(
                        question=html.escape(question),
                        s=result["sted"][0],
                        e=result["sted"][1],
                        video=html.escape(
                            os.path.basename(result["tube_video"])
                        ),
                    )
                    self._send(200, page.encode())
                else:
                    result.pop("tube_video", None)
                    self._send(
                        200, json.dumps(result).encode(), "application/json"
                    )
            elif url.path.startswith("/media/"):
                try:
                    body = server.media(url.path[len("/media/"):])
                    self._send(200, body, "video/mp4")
                except PermissionError as e:
                    self._send(403, f"error: {e}".encode(), "text/plain")
                except OSError:
                    self._send(404, b"not found")
            elif url.path == "/reload":
                self._do_reload(url.query)
            elif url.path == "/healthz":
                # liveness only — never touches the model or the lock;
                # 503 "draining" ejects this replica from load balancing
                if server._draining:
                    self._send(
                        503, b'{"status": "draining"}', "application/json"
                    )
                else:
                    self._send(
                        200, b'{"status": "ok"}', "application/json"
                    )
            elif url.path == "/stats":
                self._send(
                    200,
                    json.dumps(server.stats()).encode(),
                    "application/json",
                )
            else:
                self._send(404, b"not found")

    return Handler


def main(argv=None):
    cfg = config_from_args(argv)
    server = Server(cfg, cfg.vidstg_vid_path or cfg.hcstvg_vid_path)
    httpd = ThreadingHTTPServer(("0.0.0.0", cfg.port), make_handler(server))

    drain_started = threading.Event()

    def _graceful(signum, frame):  # noqa: ARG001
        # drain and shutdown off the main thread: httpd.shutdown() blocks
        # until serve_forever() (running right here on the main thread)
        # returns, so calling it inline from the handler would deadlock.
        # One drain only: a second SIGTERM/SIGINT must not spawn a
        # duplicate worker racing httpd.shutdown().
        if drain_started.is_set():
            return
        drain_started.set()

        def _worker():
            try:
                timeout = float(
                    os.environ.get("SERVE_DRAIN_TIMEOUT_S", "30")
                )
            except ValueError:
                timeout = 30.0
            print(f"[serve] signal {signum}: draining (≤{timeout:.0f}s)")
            try:
                ok = server.drain(timeout=timeout)
                print("[serve] drain", "complete" if ok else "timed out")
            finally:
                # shutdown must run even if drain raises, or the process
                # wedges with the listener still accepting connections
                httpd.shutdown()

        threading.Thread(target=_worker, daemon=True, name="drain").start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    print(f"serving on :{cfg.port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    print("[serve] shutdown complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
