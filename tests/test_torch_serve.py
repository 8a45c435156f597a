"""The port's HTTP server (``tubedetr_tpu_torch.apps.serve``) on the CPU.

The cases of ``tests/test_serve.py`` against the port's ``Server`` with
``device="cpu"`` on an ephemeral port: index and HTML escaping, ``/healthz``
and ``/stats``, path containment, 404, ``/reload`` with and without a
``.pth``, two concurrent requests coalesced into one forward, a poisoned
request isolated from its batchmate, a small soak, drain, and a wedged
dispatcher answering 503 within its timeout. Then the serving path as a whole: the
server's JSON tube for a tiny clip, with the JAX weights moved in, against
the JAX ``GroundingPipeline`` on the same clip; ``config_from_args`` against
the JAX parser; and the demo's ``main`` writing its tube.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu_torch.apps.serve import Server, make_handler
from tubedetr_tpu_torch.config import TubeDETRConfig

TINY = dict(
    backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
    dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
    resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
    text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
    fast=True, guided_attn=False, sted=True, aux_loss=False, dropout=0.0,
)


def _cfg(tmp_path, **over):
    return TubeDETRConfig(**{**TINY, "output_dir": str(tmp_path / "out"), **over})


def _start(server):
    """The server behind a ThreadingHTTPServer on an ephemeral port."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url, timeout=120):
    """(status, body) of a GET, HTTP errors included."""
    try:
        resp = urllib.request.urlopen(url, timeout=timeout)
        return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _stvg(url, video, question="a red square", fmt="json"):
    q = urllib.parse.urlencode({"video": video, "question": question, "format": fmt})
    return _get(f"{url}/stvg?{q}")


def _hold_until_queued(server, n):
    """With ``server.lock`` held by the caller: wait until n requests queue."""
    deadline = time.time() + 60
    while time.time() < deadline:
        with server._batch_lock:
            if len(server._pending) == n:
                return
        time.sleep(0.01)
    raise AssertionError("requests never enqueued")


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("serve")
    clip = np.random.RandomState(0).randint(0, 255, (6, 48, 64, 3), dtype=np.uint8)
    np.save(tmp_path / "clip.npy", clip)
    server = Server(_cfg(tmp_path), video_root=str(tmp_path), device="cpu")
    httpd, url = _start(server)
    yield server, url
    httpd.shutdown()


def test_index_lists_videos_and_escapes_html(live):
    server, url = live
    evil = os.path.join(server.video_root, "<script>.npy")
    np.save(evil, np.zeros((1, 4, 4, 3), np.uint8))
    try:
        code, body = _get(f"{url}/")
    finally:
        os.remove(evil)
    html = body.decode()
    assert code == 200 and "clip.npy" in html and "Spatio-Temporal Video Grounding" in html
    assert "<script>" not in html and "&lt;script&gt;" in html


def test_stvg_grounds_a_clip(live):
    _, url = live
    code, body = _stvg(url, "clip.npy")
    out = json.loads(body)
    assert code == 200
    s, e = out["sted"]
    assert 0 <= s < e <= 6 and np.asarray(out["boxes"]).shape == (6, 4)
    code, body = _stvg(url, "clip.npy", fmt="")  # HTML around the tube, or JSON without ffmpeg
    assert code == 200
    assert b"<video" in body or json.loads(body)["sted"] == out["sted"]


def test_healthz_and_stats(live):
    server, url = live
    assert _get(f"{url}/healthz") == (200, b'{"status": "ok"}')
    before = json.loads(_get(f"{url}/stats")[1])
    assert before["status"] == "ok" and before["model"]["backbone"] == "resnet14"
    assert _stvg(url, "clip.npy")[0] == 200
    assert _stvg(url, "../nope.npy")[0] == 403  # escapes the video root
    after = json.loads(_get(f"{url}/stats")[1])
    assert after["requests_ok"] == before["requests_ok"] + 1
    assert after["requests_failed"] == before["requests_failed"] + 1
    lat = after["latency_ms"]
    assert lat["window"] == after["requests_ok"] and 0 < lat["p50"] <= lat["max"]


def test_path_traversal_rejected(live, tmp_path):
    _, url = live
    outside = tmp_path / "outside.npy"
    np.save(outside, np.zeros((2, 8, 8, 3), np.uint8))
    for vid in ("../outside.npy", str(outside)):
        assert _stvg(url, vid)[0] == 403, vid
    assert _get(f"{url}/media/../../etc/passwd")[0] in (403, 404)


def test_unknown_path_404(live):
    assert _get(f"{live[1]}/nope")[0] == 404


def test_reload_without_and_with_a_checkpoint(live):
    """``/reload`` with nothing configured is an honest no-op; POST
    ``/reload?ckpt=...`` with a reference ``.pth`` replaces the live weights."""
    server, url = live
    assert json.loads(_get(f"{url}/reload")[1]) == {"reloaded": None,
                                                    "detail": "no checkpoint configured"}
    model = server.pipeline.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    os.makedirs(server.out_dir, exist_ok=True)
    torch.save({"model": {k: v * 0.5 for k, v in before.items()}},
               os.path.join(server.out_dir, "swap.pth"))
    req = urllib.request.Request(f"{url}/reload?ckpt=swap.pth", method="POST")
    out = json.loads(urllib.request.urlopen(req, timeout=120).read())
    assert out["reloaded"].endswith("swap.pth")
    name = "transformer.decoder.layers.0.linear1.weight"
    torch.testing.assert_close(model.state_dict()[name], before[name] * 0.5)
    model.load_state_dict(before)


def test_batched_serving_coalesces_requests(tmp_path):
    """``serve_max_batch=2``: two concurrent requests run as ONE forward."""
    np.save(tmp_path / "clip.npy",
            np.random.RandomState(1).randint(0, 255, (6, 48, 64, 3), dtype=np.uint8))
    server = Server(_cfg(tmp_path, serve_max_batch=2), video_root=str(tmp_path), device="cpu")
    httpd, url = _start(server)
    results = {}
    with server.lock:  # the dispatcher cannot run until both are queued
        threads = [threading.Thread(target=lambda n=n, q=q: results.update(
            {n: _stvg(url, "clip.npy", q)})) for n, q in (("a", "a red square"),
                                                          ("b", "a blue circle"))]
        for th in threads:
            th.start()
        _hold_until_queued(server, 2)
    for th in threads:
        th.join(timeout=300)
    httpd.shutdown()
    assert server.pipeline.forwards == 1
    for code, body in results.values():
        assert code == 200 and np.asarray(json.loads(body)["boxes"]).shape == (6, 4)


def test_batched_serving_isolates_poisoned_request(tmp_path):
    """A request whose video does not load fails alone (500) while its
    batchmate answers; a later batch gets new artifact names."""
    np.save(tmp_path / "clip.npy",
            np.random.RandomState(2).randint(0, 255, (6, 48, 64, 3), dtype=np.uint8))
    (tmp_path / "bad.npy").write_bytes(b"not a numpy file at all")
    server = Server(_cfg(tmp_path, serve_max_batch=2), video_root=str(tmp_path), device="cpu")
    httpd, url = _start(server)
    codes = {}
    with server.lock:
        threads = [threading.Thread(target=lambda n=n: codes.update({n: _stvg(url, f"{n}.npy")}))
                   for n in ("clip", "bad")]
        for th in threads:
            th.start()
        _hold_until_queued(server, 2)
    for th in threads:
        th.join(timeout=300)
    assert codes["bad"][0] == 500 and codes["clip"][0] == 200
    assert len(json.loads(codes["clip"][1])["boxes"]) == 6
    assert _stvg(url, "clip.npy")[0] == 200
    artifacts = [f for f in os.listdir(server.out_dir) if f.startswith("tube_frames-r")]
    assert len(artifacts) == 2
    httpd.shutdown()


def test_serving_soak_concurrent_mixed_requests(tmp_path):
    """Seven staggered requests (two poisoned) across batch windows: each
    good one gets its own video's tube (frame counts differ per clip), each
    poisoned one 500s alone, tags are monotonic, and some batch coalesced."""
    frames = {f"clip{i}.npy": 3 + i for i in range(5)}
    for name, t in frames.items():
        np.save(tmp_path / name, np.full((t, 48, 64, 3), 10 * t, np.uint8))
    (tmp_path / "bad.npy").write_bytes(b"this is not a numpy file")
    server = Server(_cfg(tmp_path, serve_max_batch=4, serve_batch_window_ms=50.0),
                    video_root=str(tmp_path), device="cpu")
    tags = []
    orig = server.pipeline.ground_many
    server.pipeline.ground_many = lambda reqs, **kw: (tags.append(list(kw["tags"])),
                                                      orig(reqs, **kw))[1]
    httpd, url = _start(server)
    jobs = ["clip0.npy", "bad.npy", "clip1.npy", "clip2.npy", "bad.npy", "clip3.npy", "clip4.npy"]
    out = {}

    def fire(k, video):
        time.sleep(0.02 * k)
        out[k] = _stvg(url, video)

    threads = [threading.Thread(target=fire, args=kv) for kv in enumerate(jobs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    httpd.shutdown()
    for k, video in enumerate(jobs):
        code, body = out[k]
        if video == "bad.npy":
            assert code == 500
        else:
            assert code == 200 and len(json.loads(body)["boxes"]) == frames[video]
    seqs = [int(t.split("-r")[1]) for batch in tags for t in batch]
    assert seqs == sorted(seqs) == list(range(len(jobs)))
    assert any(len(batch) > 1 for batch in tags) and server.pipeline.forwards == len(tags)


def test_graceful_drain(tmp_path):
    """While a request is admitted but not served, drain() times out (False),
    new requests get 503 and /healthz 503 draining; once the wedge lifts the
    admitted request answers 200 and a drain waiter returns True."""
    np.save(tmp_path / "clip.npy", np.full((4, 48, 64, 3), 9, np.uint8))
    server = Server(_cfg(tmp_path, serve_max_batch=2), video_root=str(tmp_path), device="cpu")
    httpd, url = _start(server)
    codes, done = {}, {}
    with server.lock:
        t_infl = threading.Thread(target=lambda: codes.update(inflight=_stvg(url, "clip.npy")[0]))
        t_infl.start()
        deadline = time.time() + 30
        while server._inflight != 1 and time.time() < deadline:
            time.sleep(0.01)
        assert server.drain(timeout=0.3) is False
        assert _stvg(url, "clip.npy")[0] == 503
        assert _get(f"{url}/healthz") == (503, b'{"status": "draining"}')
        t_drain = threading.Thread(target=lambda: done.update(ok=server.drain(timeout=60)))
        t_drain.start()
        time.sleep(0.2)
        assert t_drain.is_alive()
    t_infl.join(timeout=300)
    t_drain.join(timeout=300)
    httpd.shutdown()
    assert codes["inflight"] == 200 and done["ok"] is True and server._inflight == 0


def test_wedged_dispatcher_returns_503_within_timeout(tmp_path):
    np.save(tmp_path / "clip.npy", np.full((4, 48, 64, 3), 7, np.uint8))
    server = Server(_cfg(tmp_path, serve_max_batch=2), video_root=str(tmp_path), device="cpu")
    server.WAIT_TIMEOUT_S = 2.0  # an instance override; the class keeps its default
    httpd, url = _start(server)
    with server.lock:  # the dispatcher can take the request but never run it
        t0 = time.time()
        code = _stvg(url, "clip.npy")[0]
        elapsed = time.time() - t0
    httpd.shutdown()
    assert code == 503 and elapsed < 30
    assert Server.WAIT_TIMEOUT_S == 1800.0


def test_server_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(_cfg(tmp_path), video_root=str(tmp_path))


def test_server_tube_matches_the_jax_pipeline(tmp_path):
    """The serving path end to end: the port's server answers ``/stvg?format=json``
    with the JAX weights moved in; the segment equals the JAX pipeline's and
    the boxes, divided by the frame size, agree to atol 1e-4."""
    import jax

    from tests.test_torch_model import random_variables
    from tubedetr_tpu.apps.pipeline import GroundingPipeline as JaxPipeline
    from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
    from tubedetr_tpu_torch.interop.from_jax import params_from_jax

    t, h, w = 7, 48, 64
    clip = np.random.RandomState(8).randint(0, 256, (t, h, w, 3), dtype=np.uint8)
    np.save(tmp_path / "clip.npy", clip)
    jp = JaxPipeline(JaxConfig(**TINY))
    variables = random_variables(jp.model, jp._example_batch(), seed=5)
    jp.variables = jax.device_put(variables)
    ref = jp.ground(str(tmp_path / "clip.npy"), "a man in a red shirt", render=False)

    cfg = _cfg(tmp_path)
    server = Server(cfg, video_root=str(tmp_path), device="cpu")
    server.pipeline.model.load_state_dict(params_from_jax(variables, cfg))
    httpd, url = _start(server)
    code, body = _stvg(url, "clip.npy", "a man in a red shirt")
    httpd.shutdown()
    out = json.loads(body)
    assert code == 200 and out["sted"] == ref["sted"]
    size = np.array([w, h, w, h], np.float64)
    np.testing.assert_allclose(np.asarray(out["boxes"]) / size,
                               np.asarray(ref["boxes"]) / size, atol=1e-4)


ARGVS = {
    "defaults": [],
    "serving": ["--backbone_quant", "int8_static", "--serve_max_batch", "4",
                "--serve_batch_window_ms", "20", "--port", "9000", "--qscales_dir", "",
                "--compute_dtype", "bfloat16", "--resolution", "352", "--stride", "4"],
    "variants": ["--fast_mode", "transformer", "--num_queries", "3", "--nq_select", "objectness",
                 "--nq_match", "video", "--no_aux_loss", "--no_guided_attn", "--dilation"],
    "datasets": ["--combine_datasets", "vidstg", "hcstvg", "--v2", "--output-dir", "out",
                 "--eval", "--world-size", "2", "--lr", "1e-4", "--no_tmp_crop", "--no_fast"],
}


@pytest.mark.parametrize("case", list(ARGVS))
def test_config_from_args_matches_the_jax_parser(tmp_path, case):
    from tubedetr_tpu.apps.cli import config_from_args as jax_config_from_args
    from tubedetr_tpu_torch.apps.cli import config_from_args

    argv = ARGVS[case]
    if case == "datasets":  # the JSON overlay too
        overlay = tmp_path / "overlay.json"
        overlay.write_text(json.dumps({"video_max_len": 100, "eval": False}))
        argv = argv + ["--dataset_config", str(overlay)]
    got = dataclasses.asdict(config_from_args(argv))
    ref = dataclasses.asdict(jax_config_from_args(argv))
    assert (got.pop("device"), ref.pop("device")) == ("cuda", "tpu")
    assert got == ref
    assert config_from_args(argv + ["--device", "cpu"]).device == "cpu"


def test_demo_main_writes_its_tube(tmp_path):
    from tubedetr_tpu_torch.apps import demo

    np.save(tmp_path / "clip.npy",
            np.random.RandomState(9).randint(0, 256, (5, 48, 64, 3), dtype=np.uint8))
    flags = [x for k, v in TINY.items() if k not in ("fast", "text_max_positions")
             and not isinstance(v, bool) for x in (f"--{k}", str(v))]
    argv = flags + ["--no_guided_attn", "--no_aux_loss", "--device", "cpu",
                    "--video_example", str(tmp_path / "clip.npy"),
                    "--caption_example", "a red square", "--output-dir", str(tmp_path / "out")]
    assert demo.main(argv) == 0
    tube = np.load(tmp_path / "out" / "tube_frames.npy")
    assert tube.shape == (5, 48, 64, 3) and tube.dtype == np.uint8
    assert demo.main(["--device", "cpu"]) == 1  # no video or caption
