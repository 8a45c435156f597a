"""The port's train/eval CLI, its checkpoints and the pipeline's reload.

The CLI runs on the CPU at a tiny config (resnet14, hidden 32, text hidden
32, one encoder and one decoder layer, 10-frame 60x80 clips at resolution
128) over a VidSTG-layout directory of four train and two val videos
written by ``data/synthetic.py:write_vidstg_dir``.

* Against the JAX CLI: both load the JAX CLI's init weights, written as a
  reference ``.pth`` through ``params_from_jax``, with dropout 0 and the
  dropout-free train step, for one epoch of two steps (batch 2). The epoch's train losses in ``log.txt``
  agree within rtol 1e-4 (a float32 forward and backward of the same model
  summed in another order, then one AdamW step); the vIoU summaries have the
  same keys and agree within atol 1e-3 (boxes of the EMA model from both
  sides; tIoU is discrete).
* Resume: two epochs straight equal one epoch plus ``--resume`` for the
  second, dropout on, bit for bit: parameters, EMA, optimizer moments and
  step counts, and the second epoch's ``log.txt`` line. Every run takes
  its epoch in two ``--epoch_chunks`` (the step count a step reads is the
  JAX package's ``epoch * len(chunk loader) + i``) and writes its
  checkpoints with ``--async_checkpoint``. The runs use
  ``torch.use_deterministic_algorithms``: without it two identical runs on
  several CPU threads already differ by about 2e-7 (a backward reduction
  summed in thread order), with it they and the resumed run are equal.
* The checkpoint format, the atomic rename, the async writer, ``--load``
  with the surgery and ``--rd_init_tsa``, and the refusal of a JAX
  checkpoint; the flags that reach the loader, and the settings
  ``validate()`` refuses.
* ``GroundingPipeline.reload`` of the CLI's checkpoint serves the tube of
  the model trained in process, and an int8_static reload of a checkpoint
  carrying its scales runs no calibration.
* The int8 weight caches against the EMA weights: an ``ema=True`` eval
  step after a forward of the raw weights equals a model holding the EMA
  weights, exactly.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.apps import train as jax_train
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel import train_step as jax_train_step
from tubedetr_tpu.train import checkpoint as jax_checkpoint
from tubedetr_tpu_torch.apps import train
from tubedetr_tpu_torch.apps.cli import config_from_args
from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.data import loader
from tubedetr_tpu_torch.data.collate import collate
from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample, write_vidstg_dir
from tubedetr_tpu_torch.interop.from_jax import fabricate_state_dict, params_from_jax
from tubedetr_tpu_torch.models import quantize
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.parallel import train_step
from tubedetr_tpu_torch.parallel.train_step import (
    TrainState,
    ema_weights,
    make_eval_step,
    model_inputs,
)
from tubedetr_tpu_torch.train import checkpoint

T = 10
MODEL_ARGS = [
    "--backbone", "resnet14", "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
    "--dec_layers", "1", "--dim_feedforward", "64", "--video_max_len", str(T),
    "--video_max_len_train", str(T), "--stride", "2", "--resolution", "128",
    "--max_text_len", "12", "--text_vocab_size", "128", "--text_hidden_size", "32",
    "--text_layers", "1", "--text_heads", "4", "--text_ffn", "64",
]
LOSS_RTOL = 1e-4
VIOU_ATOL = 1e-3


def cli_args(data, out, *extra):
    return ["--combine_datasets", "vidstg", "--combine_datasets_val", "vidstg",
            "--vidstg_ann_path", str(data), "--vidstg_vid_path", str(data), *MODEL_ARGS,
            "--batch_size", "2", "--ema", "--output-dir", str(out), *extra]


def log_lines(out):
    return [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_vidstg_dir(str(tmp_path_factory.mktemp("vidstg")), 4, 2, t=T, h=60, w=80, seed=0,
                            video_max_len_train=T)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data):
    """Two epochs straight (A, the final state kept), one epoch (B), and
    B's checkpoint resumed for the second epoch (C); dropout on, the
    threaded loader, the prefetcher, two chunks an epoch and the async
    writer in every run."""
    root = tmp_path_factory.mktemp("runs")
    feed = ["--device", "cpu", "--num_workers", "2", "--device_prefetch", "2", "--eval_skip", "2",
            "--epoch_chunks", "2", "--async_checkpoint"]
    stats = train.RunStats()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert train.main(cli_args(data, root / "a", "--epochs", "2", *feed), stats) == 0
        assert train.main(cli_args(data, root / "b", "--epochs", "1", *feed)) == 0
        assert train.main(cli_args(data, root / "c", "--epochs", "2", "--resume",
                                   str(root / "b" / "checkpoint.pth"), *feed)) == 0
    finally:
        torch.use_deterministic_algorithms(was)
    return root, stats


def _assert_tree_equal(a, b, path=""):
    if torch.is_tensor(a):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_resume_equals_an_uninterrupted_run(runs):
    root, stats = runs
    a = checkpoint.load_checkpoint(str(root / "a" / "checkpoint.pth"))
    c = checkpoint.load_checkpoint(str(root / "c" / "checkpoint.pth"))
    assert a["epoch"] == c["epoch"] == 1 and a["step"] == c["step"] == 4
    for key in ("model", "model_ema", "optimizer"):
        _assert_tree_equal(a[key], c[key], key)
    assert any(not torch.equal(a["model"][k], a["model_ema"][k]) for k in a["model_ema"])
    la, lc = log_lines(root / "a"), log_lines(root / "c")
    assert [r["epoch"] for r in la] == [0, 1] and [r["epoch"] for r in lc] == [1]
    assert la[1] == lc[0]
    assert "test_vidstg_declarative_viou" in la[1]
    # the numbered checkpoints of vidstg: one an epoch
    assert sorted(p.name for p in (root / "a").glob("checkpoint0*.pth")) == [
        "checkpoint0000.pth", "checkpoint0001.pth"]
    assert len(stats.steps) == 4 and all(s["step_s"] > 0 for s in stats.steps)
    assert [(c["path"], c["async"]) for c in stats.checkpoint_s] == [
        ("checkpoint.pth", True), ("checkpoint0000.pth", True), ("checkpoint.pth", True),
        ("checkpoint0001.pth", True)]
    assert not list((root / "a").glob("*.tmp"))


def jax_init_pth(path, cfg_kw):
    """The JAX CLI's init (``model.init`` under ``jit`` from the seed's key)
    written as a reference ``.pth`` through ``params_from_jax``."""
    jcfg = JaxConfig(**cfg_kw)
    model = jax_build_model(jcfg)
    t, tc, hw = jcfg.video_max_len_train, jcfg.n_clips, 64  # shapes do not depend on H, W
    dummy = dict(
        frames_slow=np.zeros((1, tc, hw, hw, 3), np.float32),
        slow_pad_mask=np.zeros((1, tc, hw, hw), bool),
        tokens=np.zeros((1, jcfg.max_text_len), np.int32),
        text_pad_mask=np.zeros((1, jcfg.max_text_len), bool),
        durations=np.full((1,), t, np.int32),
        frames_fast=np.zeros((1, t, hw, hw, 3), np.float32),
        fast_pad_mask=np.zeros((1, t, hw, hw), bool),
    )
    variables = jax.jit(model.init)(jax.random.PRNGKey(jcfg.seed), **dummy)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = params_from_jax(variables, TubeDETRConfig(**cfg_kw))
    torch.save({"model": sd}, path)


def test_cli_matches_jax_cli(tmp_path, data, monkeypatch):
    """One epoch of both CLIs from the same ``.pth``, dropout 0. RoBERTa's
    own dropout (0.1, as the reference's text encoder has it) does not
    follow ``--dropout``, and the two packages' masks cannot agree, so both
    CLIs run their dropout-free train step (``deterministic=True``), as the
    step parity tests do."""
    for module in (jax_train_step, train_step):
        monkeypatch.setattr(module, "make_train_step",
                            functools.partial(module.make_train_step, deterministic=True))
    args = cli_args(data, tmp_path / "port", "--epochs", "1", "--dropout", "0", "--device", "cpu",
                    "--load", str(tmp_path / "init.pth"), "--num_workers", "0")
    cfg_kw = {k: v for k, v in vars(config_from_args(args)).items()
              if k not in ("device", "load", "output_dir")}
    jax_init_pth(tmp_path / "init.pth", cfg_kw)
    assert train.main(args) == 0
    jargs = [a for a in args if a not in ("--device", "cpu")]
    jargs[jargs.index(str(tmp_path / "port"))] = str(tmp_path / "jax")
    assert jax_train.main(jargs) == 0
    (got,), (want,) = log_lines(tmp_path / "port"), log_lines(tmp_path / "jax")
    assert set(got) == set(want)
    losses = [k for k in want if k.startswith("train_loss")]
    assert len(losses) >= 5
    for k in losses:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    for k in ("train_lr", "train_lr_backbone", "train_lr_text_encoder", "epoch", "n_parameters"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    viou = [k for k in want if k.startswith("test_")]
    assert len(viou) == 7
    for k in viou:
        assert got[k] == pytest.approx(want[k], abs=VIOU_ATOL), k


def _pipeline_cfg(**kw):
    return config_from_args(MODEL_ARGS).replace(device="cpu", **kw)


def test_reload_serves_the_trained_model(runs, data):
    root, stats = runs
    clip = f"{data}/val0.npy"
    pipe = GroundingPipeline(_pipeline_cfg(), device="cpu")
    pipe.reload(str(root / "a" / "checkpoint.pth"))
    got = pipe.ground(clip, "the red square moving on the left", render=False)
    ref = GroundingPipeline(_pipeline_cfg(), device="cpu")
    ref.model = stats.state.model
    with ema_weights(stats.state):
        want = ref.ground(clip, "the red square moving on the left", render=False)
    assert got["sted"] == want["sted"]
    np.testing.assert_array_equal(np.asarray(got["boxes"]), np.asarray(want["boxes"]))


def test_int8_reload_with_embedded_scales_skips_calibration(runs, data, tmp_path, monkeypatch):
    root, _ = runs
    clip = f"{data}/val0.npy"
    cfg = _pipeline_cfg(backbone_quant="int8_static", compute_dtype="float32")
    calibrated = GroundingPipeline(cfg, device="cpu")
    calibrated.reload(str(root / "a" / "checkpoint.pth"))
    assert calibrated._needs_calibration
    want = calibrated.ground(clip, "a caption", render=False)
    assert calibrated.qscales_source == "calibrated"
    ck = checkpoint.load_checkpoint(str(root / "a" / "checkpoint.pth"))
    ck["qscales"] = {k: torch.tensor(v) for k, v in quantize.model_qscales(calibrated.model).items()}
    checkpoint.save_checkpoint(str(tmp_path / "with_scales.pth"), ck)

    def no_calibration(*a, **k):
        raise AssertionError("calibrated although the checkpoint carries scales")

    monkeypatch.setattr(quantize, "calibrate_qscales", no_calibration)
    pipe = GroundingPipeline(cfg, device="cpu")
    pipe.reload(str(tmp_path / "with_scales.pth"))
    assert not pipe._needs_calibration and pipe.qscales_source == "checkpoint"
    got = pipe.ground(clip, "a caption", render=False)
    assert got["sted"] == want["sted"]
    np.testing.assert_array_equal(np.asarray(got["boxes"]), np.asarray(want["boxes"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)
        self.register_buffer("stat", torch.arange(2.0))


def _state():
    torch.manual_seed(0)
    model = _Net()
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model.lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    ema = {n: p.detach().clone() * 0.5 for n, p in model.named_parameters()}
    return TrainState(model, opt, {}, ema, step=7)


def test_checkpoint_round_trip(tmp_path):
    state = _state()
    cfg = TubeDETRConfig(epochs=3)
    path = str(tmp_path / "ck.pth")
    checkpoint.save_checkpoint(path, checkpoint.checkpoint_payload(state, 4, cfg,
                                                                   qscales={"a": np.float32(2.5)}))
    ck = checkpoint.load_checkpoint(path)
    assert set(ck) == {"model", "model_ema", "optimizer", "epoch", "args", "step", "qscales"}
    assert ck["args"]["epochs"] == 3 and ck["qscales"]["a"].item() == 2.5
    assert torch.equal(ck["model_ema"]["stat"], state.model.stat)  # buffers ride along
    fresh = _state()
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.zero_()
    fresh.optimizer = torch.optim.AdamW(fresh.model.parameters(), lr=0.1)
    assert checkpoint.resume_state(fresh, ck) == 5
    assert fresh.step == 7
    _assert_tree_equal(fresh.model.state_dict(), state.model.state_dict())
    _assert_tree_equal(fresh.ema_params, state.ema_params)
    _assert_tree_equal(fresh.optimizer.state_dict(), state.optimizer.state_dict())


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that dies half way leaves the old checkpoint whole and the
    torn bytes in ``.tmp``."""
    path = str(tmp_path / "ck.pth")
    checkpoint.save_checkpoint(path, {"epoch": 1})

    def torn(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04 torn")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, {"epoch": 2})
    monkeypatch.undo()
    assert checkpoint.load_checkpoint(path)["epoch"] == 1
    assert (tmp_path / "ck.pth.tmp").read_bytes().endswith(b"torn")


def test_async_writer_snapshot_order_and_errors(tmp_path):
    """The snapshot is taken before ``save`` returns: an in-place step
    right after does not reach the file. Saves land in order, and a failed
    write re-raises on the next ``wait`` and leaves the writer usable."""
    state = _state()
    w = checkpoint.AsyncCheckpointWriter()
    path = str(tmp_path / "ck.pth")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    w.save(path, checkpoint.checkpoint_payload(state, 0, TubeDETRConfig()))
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(100.0)  # what optimizer.step() does to the live tensors
    w.wait()
    _assert_tree_equal(checkpoint.load_checkpoint(path)["model"], before)
    for epoch in range(3):
        w.save(path, {"epoch": epoch, "w": torch.full((2,), float(epoch))})
    w.wait()
    assert checkpoint.load_checkpoint(path)["epoch"] == 2
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file")
    w.save(str(blocker / "x.pth"), {"epoch": 0})
    with pytest.raises(OSError):
        w.wait()
    w.save(path, {"epoch": 9})
    w.wait()
    assert checkpoint.load_checkpoint(path)["epoch"] == 9


def test_load_surgery_and_rd_init_tsa(tmp_path):
    """``--load``: EMA preferred, queries cut, the sine buffer dropped, and
    with ``--rd_init_tsa`` the decoder's temporal self-attention kept at
    init; the rest loaded."""
    cfg = config_from_args(MODEL_ARGS).replace(device="cpu")
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    ema = fabricate_state_dict(model, seed=1)
    ema["query_embed.weight"] = torch.randn(3, ema["query_embed.weight"].shape[1])
    ema["transformer.time_embed.te"] = torch.zeros(1)
    torch.save({"model": fabricate_state_dict(model, seed=2), "model_ema": ema, "args": None},
               tmp_path / "ref.pth")
    missing, unexpected = checkpoint.load_pretrained(model, str(tmp_path / "ref.pth"),
                                                     rd_init_tsa=True)
    assert not unexpected
    tsa = [k for k in init if checkpoint.TSA_KEYS.match(k)]
    assert tsa and sorted(missing) == sorted(tsa)
    sd = model.state_dict()
    for k in sd:
        want = init[k] if k in tsa else ema[k][:1] if k == "query_embed.weight" else ema[k]
        assert torch.equal(sd[k], want), k


def test_jax_checkpoint_is_refused(tmp_path):
    path = str(tmp_path / "checkpoint.ckpt")
    jax_checkpoint.save_checkpoint(path, params={"w": np.zeros(2, np.float32)}, buffers={}, epoch=0)
    for p in (path, str(tmp_path)):
        with pytest.raises(ValueError, match="params_from_jax"):
            checkpoint.load_checkpoint(p)


# ---------------------------------------------------------------------------
# flags and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [["--mesh_data", "2"], ["--mesh_time", "2"], ["--mesh_model", "2"],
                                  ["--shard_optimizer_state"],
                                  ["--shard_params"]], ids=lambda f: f[0].lstrip("-"))
def test_mesh_and_sharding_flags_are_refused(flag):
    """The data, time and model axes and the sharded states are taken
    (``tests/test_torch_dist.py`` and ``tests/test_torch_tp.py`` run them);
    in one process a mesh wider than 1 x 1 x 1 is refused, since each rank
    drives one card."""
    from tubedetr_tpu_torch.parallel.mesh import mesh_shape

    cfg = config_from_args(flag)
    if cfg.mesh_data * cfg.mesh_time * cfg.mesh_model > 1:
        with pytest.raises(ValueError, match="torchrun"):
            mesh_shape(cfg, 1)
    else:
        assert (cfg.shard_optimizer_state or cfg.shard_params) and mesh_shape(cfg, 1) == (1, 1, 1)


@pytest.mark.parametrize("flag", ["--log_quant_drift", "--recalibrate_each_epoch"])
def test_quant_drift_flags_are_refused(flag):
    """The drift log and the per-epoch recalibration act on quantized
    training passes the port does not run yet: refused, not ignored."""
    with pytest.raises(NotImplementedError, match="Secondary features"):
        config_from_args([flag])


def test_feed_flags_reach_the_loader(data, tmp_path, monkeypatch):
    """``--frames_dtype``, ``--num_workers``, ``--device_prefetch`` and
    ``--compact_pad_masks`` reach the loaders and the feed: an eval run's
    batches arrive in bf16 through a two-batch prefetcher, from loaders
    with two worker threads. Training an int8 backbone is refused."""
    seen = {"loaders": [], "dtypes": []}

    class Loader(loader.DataLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["loaders"].append(kw)

    class Prefetcher(loader.DevicePrefetcher):
        def __init__(self, feed, size=2, device="cuda"):
            super().__init__(feed, size, device)
            seen["size"] = size

        def __iter__(self):
            for batch, meta in super().__iter__():
                seen["dtypes"].append(batch["frames_slow"].dtype)
                assert "slow_valid_hw" in batch and "slow_pad_mask" not in batch
                yield batch, meta

    monkeypatch.setattr(loader, "DataLoader", Loader)
    monkeypatch.setattr(loader, "DevicePrefetcher", Prefetcher)
    args = cli_args(data, tmp_path, "--eval", "--device", "cpu", "--frames_dtype", "bfloat16",
                    "--num_workers", "2", "--device_prefetch", "2", "--compact_pad_masks")
    assert train.main(args) == 0
    assert seen["loaders"] and all(kw["num_workers"] == 2 and kw["frames_dtype"] == "bfloat16"
                                   and kw["compact_pad_masks"] for kw in seen["loaders"])
    assert seen["size"] == 2 and seen["dtypes"] and set(seen["dtypes"]) == {torch.bfloat16}
    assert set(json.loads((tmp_path / "log_stats.json").read_text())) >= {
        "vidstg_declarative_viou", "vidstg_declarative_tiou"}
    with pytest.raises(NotImplementedError, match="trains nothing"):
        train.main(cli_args(data, tmp_path, "--backbone_quant", "int8_static", "--device", "cpu"))
    with pytest.raises(ValueError, match="frames_dtype"):
        TubeDETRConfig(frames_dtype="float16").validate()


# ---------------------------------------------------------------------------
# the int8 caches against the EMA weights
# ---------------------------------------------------------------------------


def test_int8_ema_eval_runs_on_the_ema_weights():
    """An int8_static + K2 (plain version on the CPU) eval step with
    ``ema=True``, after a forward of the raw weights filled the int8 weight
    and fold caches, equals a model that holds the EMA weights; and a raw
    forward afterwards equals the first one (the EMA's caches do not serve
    the raw weights either)."""
    cfg = config_from_args(MODEL_ARGS).replace(
        device="cpu", backbone="resnet26", backbone_quant="int8_static", fused_bottleneck=True,
        video_max_len=4, video_max_len_train=4, stride=2, ema=True)
    samples = [make_synthetic_sample(i, t=4, h=48, w=48, vocab=128) for i in range(2)]
    batch = collate(samples, 4, 2, cfg.max_text_len)
    inputs = model_inputs(batch)
    model = build_model(cfg, "cpu")
    model.load_state_dict(fabricate_state_dict(model, seed=0))
    quantize.calibrate_qscales(cfg, model, inputs)
    scales = quantize.model_qscales(model)
    gen = torch.Generator().manual_seed(1)  # EMA weights that differ in the trunk only
    ema = {n: p.detach() + (0.02 * torch.randn(p.shape, generator=gen) if n.startswith("backbone")
                            else 0.0) for n, p in model.named_parameters()}
    state = TrainState(model, None, {}, ema)
    with torch.no_grad():
        raw = model(**inputs)
        got, _ = make_eval_step(cfg, ema=True)(state, batch)
        ref = build_model(cfg, "cpu")
        ref.load_state_dict({**model.state_dict(), **ema})
        quantize.set_model_qscales(ref, scales)
        want = ref(**inputs)
        again = model(**inputs)
    for k in ("pred_boxes", "pred_sted"):
        assert not torch.equal(raw[k], want[k]), k  # the EMA weights make a difference
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(again[k], raw[k]), k
