"""The port's profiler hooks write traces (counterpart of ``tests/test_profiler.py``).

``maybe_profile`` traces a whole block and ``ProfileWindow`` a bounded
window of steps inside the train epoch loop (``train/engine.py``), both on
``torch.profiler``, here with CPU activities; the card's CUDA kernel events
are ``tests/test_torch_cuda.py``'s. The five cases of the JAX package's
test: a trace is written, no directory is a no-op, the window's bounds, a
short epoch closes its window, ``enabled=False``.
"""

import json
import os

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu_torch.utils.misc import ProfileWindow, maybe_profile


def _traces(trace_dir):
    out = []
    for root, _dirs, files in os.walk(trace_dir):
        out += [os.path.join(root, f) for f in files if f.endswith(".pt.trace.json")]
    return out


def _work():
    x = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
    return float((x @ x.T).sum())


def test_maybe_profile_writes_trace(tmp_path):
    trace_dir = str(tmp_path / "trace")
    with maybe_profile(trace_dir):
        _work()
    (path,) = _traces(trace_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_maybe_profile_disabled_is_noop(tmp_path, monkeypatch):
    monkeypatch.delenv("TUBEDETR_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_profile():
        _work()  # no env, no argument: no profiler, no file
    assert not os.listdir(tmp_path)


def test_profile_window_step_bounds(tmp_path, monkeypatch):
    trace_dir = str(tmp_path / "wtrace")
    monkeypatch.setenv("TUBEDETR_PROFILE_DIR", trace_dir)
    monkeypatch.setenv("TUBEDETR_PROFILE_START", "1")
    monkeypatch.setenv("TUBEDETR_PROFILE_STEPS", "2")
    w = ProfileWindow()
    for i in range(5):
        w.step(i)
        if i == 0:
            assert not w._active  # start=1 skips the warm-up step
        if i in (1, 2):
            assert w._active
        if i >= 3:
            assert w._done and not w._active
        _work()
    w.close()
    assert len(_traces(trace_dir)) == 1, "the window wrote no trace, or more than one"


def test_profile_window_short_epoch_closes(tmp_path, monkeypatch):
    trace_dir = str(tmp_path / "short")
    monkeypatch.setenv("TUBEDETR_PROFILE_DIR", trace_dir)
    monkeypatch.setenv("TUBEDETR_PROFILE_STEPS", "100")
    w = ProfileWindow()
    w.step(1)
    _work()
    w.close()  # the epoch ended before the window filled
    assert not w._active
    assert _traces(trace_dir)


def test_profile_window_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("TUBEDETR_PROFILE_DIR", str(tmp_path / "never"))
    w = ProfileWindow(enabled=False)
    assert w.trace_dir == ""
    w.step(1)  # no-op
    w.close()
    assert not (tmp_path / "never").exists()

    monkeypatch.setenv("TUBEDETR_PROFILE_START", "zzz")  # malformed env
    w2 = ProfileWindow(enabled=True)
    assert (w2.start, w2.steps) == (1, 3)


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_one_epoch_traces_its_first_epoch_only(tmp_path, monkeypatch, epoch):
    """``train_one_epoch`` opens the window in epoch 0 alone and closes it
    when the loop ends."""
    from tubedetr_tpu_torch.config import TubeDETRConfig
    from tubedetr_tpu_torch.train import engine

    trace_dir = tmp_path / "epoch"
    monkeypatch.setenv("TUBEDETR_PROFILE_DIR", str(trace_dir))
    monkeypatch.setenv("TUBEDETR_PROFILE_START", "0")
    cfg = TubeDETRConfig(aux_loss=False, sted=False, guided_attn=False)

    def step(state, batch, lrs, seed):
        _work()
        return state, {"loss_total": torch.tensor(1.0), "loss_bbox": torch.tensor(0.5),
                       "loss_giou": torch.tensor(0.5)}

    pairs = [({}, {}) for _ in range(2)]
    engine.train_one_epoch(cfg, step, None, pairs, epoch, 4)
    assert bool(_traces(str(trace_dir))) == (epoch == 0)
