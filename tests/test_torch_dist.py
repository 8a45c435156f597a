"""Multi-process training and evaluation of the port on the CPU (gloo), held to one process and to the JAX package.

The tiny config of ``tests/torch_dist_ranks.py`` (resnet14, hidden 32, one
encoder and one decoder layer, RoBERTa of one layer of 32, T=8 at stride 2,
fast branch, aux, sted and guided attention, AdamW, clip 0.1, EMA 0.9) from
seeded JAX variables (``params_from_jax``). The ranks are spawned processes
in one gloo group (``torch_dist_ranks.spawn``: a file store in the test's
directory, a deadline, every process joined); one spawn serves several
checks. Dropout is off on both sides (the dropout-free step).

* The data axis: 2 ranks, each on its half of a global batch of 4 videos
  whose halves hold different numbers of annotated frames (the global
  ``num_boxes``): DDP, DDP with ``grad_accum=2``, ZeRO-1 and FSDP against
  one process on the whole batch: every loss term (rtol 1e-5), the
  pre-clip ``grad_norm`` (rtol 1e-5), every gradient leaf by leaf (atol
  1e-6, rtol 1e-5: the same sums split over two processes), and the
  post-step parameters and EMA within the AdamW first-step bound of
  ``tests/test_torch_train.py`` (``adamw_atol``: 2e-5 plus what the two
  gradients' own difference explains through ``g / (|g| + 1e-8)``). Both
  ranks end with the same parameters, bit for bit.
* The JAX package's ``data=2`` step with ``shard_opt_state_along_data``
  over 2 of the 8 host devices: the loss terms (rtol 1e-5), ``grad_norm``
  (rtol 1e-4), and the parameters and EMA within the AdamW bound of the
  port's gradients and the JAX step's (its first moment over ``1 - b1``).
* ZeRO-1 holds about half of the moments and the EMA a rank; FSDP shards
  the transformer and RoBERTa and not the trunk.
* The time axis: 2 ranks splitting the frames (``mesh_time=2``): the step
  against one process, the trunk's gradients included (the gather's
  backward scale); the time-sharded inference in float against the JAX
  package's ``(1, 2)`` mesh (atol 1e-5) and in int8_static with
  ``fused_bottleneck`` (K2's plain version), with the port's one-process
  calibration: bit for bit the port's one process, and against the JAX
  ``(1, 2)`` mesh with those scales within the bound the JAX package holds
  its own time-sharded int8 inference to (max 0.05, mean 5e-3).
* Checkpoints: the 2-rank ZeRO and FSDP runs' checkpoints (rank 0 writes
  them, gathered) load in one process with ``resume_state`` and in
  ``GroundingPipeline.reload`` with the runs' tensors exactly; a
  one-process checkpoint resumes on 2 ranks under ZeRO and FSDP, and the
  next step equals the one process's second step.
* The evaluation of an FSDP state (gathered) over 5 videos on 2 ranks
  (uneven shares, a padded tail) merges to one process's vIoU summary
  (1e-6), and the synced meters equal one process's (rtol 1e-6).
* The CLI: ``python -m tubedetr_tpu_torch.apps.train`` in two processes
  with the ``torchrun`` variables, ``--shard_optimizer_state --ema``:
  rank 0 alone writes the checkpoint and ``log.txt``, the losses are
  finite, and an ``--eval`` of the checkpoint in two processes gives one
  process's vIoU (1e-6).
* The build race, the launcher's environment and the config's mesh fields.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests import torch_dist_ranks as R
from tests.torch_dist_ranks import adamw_atol, assert_close, assert_step_matches, labels_of
from tests.test_torch_model import random_variables
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.data.collate import collate as jax_collate
from tubedetr_tpu.data.synthetic import make_synthetic_sample as jax_sample
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tubedetr_tpu.parallel.mesh import replicate, shard_batch, shard_opt_state_along_data
from tubedetr_tpu.parallel.train_step import create_train_state as jax_create_state
from tubedetr_tpu.parallel.train_step import make_train_step as jax_make_train_step
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax, qscales_to_flax
from tubedetr_tpu_torch.parallel import dist as tdist
from tubedetr_tpu_torch.parallel.mesh import mesh_shape
from tubedetr_tpu_torch.parallel.train_step import model_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = R.LOSS_RTOL


def jax_inputs(batch):
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in jax_model_inputs(batch).items()}


def jax_batch(videos=R.VIDEOS):
    samples = [jax_sample(s, t=d, vocab=R.KW["text_vocab_size"]) for s, d in videos]
    return jax_collate(samples, R.T, R.STRIDE, R.KW["max_text_len"])[0]


# ---------------------------------------------------------------------------
# fixtures: the weights, one process, the spawns
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX variables, the port's weights file): seeded random JAX
    variables of the tiny config, moved by ``params_from_jax``."""
    tmp = tmp_path_factory.mktemp("dist")
    model = jax_build_model(JaxConfig(**R.KW))
    variables = random_variables(model, jax_inputs(jax_batch()), seed=2)
    path = str(tmp / "weights.pt")
    torch.save(params_from_jax(variables, R.cfg_of()), path)
    return variables, path, tmp


@pytest.fixture(scope="module")
def one_process(weights):
    """One process on the whole batch: one step, its checkpoint, a second
    step; and the int8_static + fused calibration and forward of the
    time-axis inputs (on a rank's threads)."""
    from tubedetr_tpu_torch.models.quantize import calibrate_qscales, model_qscales
    from tubedetr_tpu_torch.train.checkpoint import checkpoint_payload, save_checkpoint

    _, path, tmp = weights
    cfg = R.cfg_of()
    ref = R.run_steps(cfg, path, R.batch_of())
    save_checkpoint(str(tmp / "ckpt1.pth"), checkpoint_payload(ref["state"], 0, cfg))
    step2 = R.RecordingStep(cfg)(ref["state"], R.batch_of())[1]
    ref = R._strip(ref)
    ref["metrics"].append({k: float(v) for k, v in step2.items()})
    inputs = model_inputs(R.batch_of(((5, 8),)))
    qcfg = R.cfg_of(backbone_quant="int8_static", fused_bottleneck=True)
    qmodel = R.model_from(path, qcfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(R.THREADS)
    try:
        calibrate_qscales(qcfg, qmodel, inputs)
        with torch.inference_mode():
            out = qmodel(**inputs)
    finally:
        torch.set_num_threads(threads)
    qscales = {k: np.asarray(v) for k, v in model_qscales(qmodel).items()}
    int8 = {k: out[k].numpy() for k in ("pred_boxes", "pred_sted")}
    return ref, {k: v.numpy() for k, v in inputs.items()}, qscales, int8


@pytest.fixture(scope="module")
def ranks(weights, one_process):
    """Each rank's results of ``torch_dist_ranks.all_ranks``, one spawn."""
    _, path, tmp = weights
    _, inputs, qscales, _ = one_process
    return R.spawn(R.all_ranks, 2, tmp, path, str(tmp), qscales, inputs)


@pytest.fixture(scope="module")
def data_axis(weights, one_process, ranks):
    return R.cfg_of(), one_process[0], [r["data"] for r in ranks], weights[2]


def test_recalibration_holds_the_maximum_over_the_ranks(ranks):
    """Two ranks whose videos give different activation maxima: after
    ``recalibrate`` both hold the elementwise maximum of what they observed
    (written after the max-reduce, so no rank's larger maximum is lost)."""
    a, b = (r["recalibrate"] for r in ranks)
    assert set(a["observed"]) == set(b["observed"]) == set(a["held"])
    assert any(a["observed"][k] != b["observed"][k] for k in a["observed"])
    want = {k: max(a["observed"][k], b["observed"][k]) for k in a["observed"]}
    assert a["held"] == b["held"] == want


@pytest.mark.parametrize("name", ["ddp", "accum", "zero", "fsdp"])
def test_data_parallel_step_matches_one_process(data_axis, name):
    cfg, ref, ranks, _ = data_axis
    for res in ranks:
        assert_step_matches(res[name], ref, labels_of(cfg))
    for n, p in ranks[0][name]["params"].items():  # the replicas agree bit for bit
        assert np.array_equal(p, ranks[1][name]["params"][n]), n


def test_the_ranks_hold_different_numbers_of_annotated_frames(data_axis):
    """The global ``num_boxes``: the halves' counts differ, so a rank's own
    count would give another loss and gradient (the DDP case above)."""
    from tubedetr_tpu_torch.core.masking import inter_positive_map

    counts = []
    for half in (R.VIDEOS[:2], R.VIDEOS[2:]):
        b = R.batch_of(half)
        counts.append(int((inter_positive_map(torch.as_tensor(b["inter_idx"]), R.T)
                           & torch.as_tensor(b["time_mask"])).sum()))
    assert counts[0] != counts[1], counts


def test_zero_holds_half_the_moments_and_ema(data_axis):
    _, _, ranks, _ = data_axis
    for key in ("local_moment_elems", "local_ema_elems"):
        full = ranks[0]["ddp"][key]
        shares = [r["zero"][key] for r in ranks]
        assert sum(shares) == full, (key, shares, full)
        assert all(0.4 * full <= s <= 0.6 * full for s in shares), (key, shares, full)


def test_fsdp_shards_the_transformer_and_text_encoder_not_the_trunk(data_axis):
    cfg, ref, ranks, _ = data_axis
    sharded = set(ranks[0]["fsdp"]["sharded"])
    assert not any(n.startswith("backbone.") for n in sharded)
    for prefix in ("transformer.encoder.", "transformer.decoder.", "transformer.text_encoder.",
                   "input_proj.", "bbox_embed."):
        names = [n for n in ref["params"] if n.startswith(prefix)]
        assert names and set(names) <= sharded, prefix
    assert not ranks[0]["ddp"]["sharded"] and not ranks[0]["zero"]["sharded"]


@pytest.mark.parametrize("name", ["zero", "fsdp"])
def test_sharded_checkpoint_loads_in_one_process(data_axis, name):
    """Rank 0's gathered checkpoint: one process's format, the run's
    parameters, EMA and moments; it resumes in one process and reloads in
    ``GroundingPipeline``."""
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.parallel.train_step import create_train_state
    from tubedetr_tpu_torch.train.checkpoint import load_checkpoint, resume_state

    cfg, _, ranks, tmp = data_axis
    res = ranks[0][name]
    path = str(tmp / f"ckpt_{name}.pth")
    ckpt = load_checkpoint(path)
    state = create_train_state(cfg, R.model_from(str(tmp / "weights.pt"), cfg))
    assert resume_state(state, ckpt) == 1 and state.step == 1
    params = dict(state.model.named_parameters())
    for n, p in res["params"].items():
        assert np.array_equal(params[n].detach().numpy(), p), n
    for n, e in res["ema"].items():
        assert np.array_equal(state.ema_params[n].numpy(), e), n
    ddp = ranks[0]["ddp"]["opt"]  # the replicated run's optimizer, one process's layout
    assert [g["params"] for g in ckpt["optimizer"]["param_groups"]] == \
        [g["params"] for g in ddp["param_groups"]]
    for i, st in ddp["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(ckpt["optimizer"]["state"][i][k].numpy(), st[k].numpy(),
                                       rtol=1e-5, atol=1e-12, err_msg=f"{i} {k}")
    pipe = GroundingPipeline(cfg, device="cpu")
    pipe.reload(path)
    live = dict(pipe.model.named_parameters())
    for n, e in res["ema"].items():
        assert np.array_equal(live[n].detach().numpy(), e), n


@pytest.mark.parametrize("name", ["zero", "fsdp"])
def test_one_process_checkpoint_resumes_on_two_ranks(data_axis, name):
    cfg, ref, ranks, _ = data_axis
    for res in ranks:
        m = res[f"resume_{name}"]["metrics"][0]
        for k, v in ref["metrics"][1].items():
            np.testing.assert_allclose(m[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_data_parallel_step_matches_jax_zero_step(weights, data_axis):
    """The JAX package's step on a ``data=2`` mesh with ZeRO-1 over 2 host
    devices, from the same variables, on the same four videos."""
    variables = weights[0]
    cfg, _, ranks, _ = data_axis
    jcfg = JaxConfig(**R.KW)
    model = jax_build_model(jcfg)
    state, tx, labels = jax_create_state(jcfg, variables)
    mesh = jax_make_mesh(data=2, time=1, devices=jax.devices()[:2])
    with mesh:
        state, shardings = shard_opt_state_along_data(state, mesh)
        step = jax_make_train_step(jcfg, model, tx, labels, donate=False, deterministic=True,
                                   state_shardings=shardings)
        state, metrics = step(state, shard_batch(jax_batch(), mesh),
                              {k: np.float32(v) for k, v in R.LRS.items()}, np.int32(0))
    metrics = {k: float(v) for k, v in metrics.items()}
    res = ranks[0]["zero"]
    for k, v in metrics.items():
        rtol = 1e-4 if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(res["metrics"][0][k], v, rtol=rtol, err_msg=k)

    def port_names(tree):
        return {k: v.numpy() for k, v in params_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, tree), "buffers": variables["buffers"]},
            cfg).items()}

    # the JAX step's clipped gradients, for the bound: AdamW's first moment
    # after one step is (1 - b1) g
    mus = []
    jax.tree_util.tree_map(lambda x: mus.append(x.mu), state.opt_state,
                           is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
    mu = jax.tree_util.tree_map(  # each leaf from its label's state; a frozen one has none
        lambda p, *xs: next((x for x in xs if hasattr(x, "shape")), np.zeros_like(p)),
        variables["params"], *mus)
    scale = min(1.0, R.KW["clip_max_norm"] / res["metrics"][0]["grad_norm"])
    jgrads = {n: g / 0.1 / scale for n, g in port_names(mu).items()}
    atol = adamw_atol(labels_of(cfg), res["grads"], jgrads, res["metrics"][0]["grad_norm"],
                      R.KW["clip_max_norm"])
    assert_close(res["params"], port_names(state.params), atol, "param")
    assert_close(res["ema"], port_names(state.ema_params), atol, "ema")


# ---------------------------------------------------------------------------
# the time axis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def time_axis(weights, one_process, ranks, jax_k2_reference_module):
    """The JAX package's ``(1, 2)``-mesh inference in float and in
    int8_static + fused with the port's scales (its fused tails through its
    plain emulation of K2), beside the ranks' time-axis runs."""
    variables = weights[0]
    ref, _, qscales, int8 = one_process
    inputs = jax_inputs(jax_batch(((5, 8),)))
    mesh = jax_make_mesh(data=1, time=2, devices=jax.devices()[:2])
    jax_out = {}
    for name, extra in (("float", {}),
                        ("int8", {"backbone_quant": "int8_static", "fused_bottleneck": True})):
        jcfg = JaxConfig(**{**R.KW, **extra})
        model = jax_build_model(jcfg)
        v = variables if name == "float" else {
            **variables, "qscales": qscales_to_flax(qscales, jcfg.scan_backbone_blocks)}
        fwd = jax.jit(lambda v, b, model=model: {k: model.apply(v, **b)[k]
                                                 for k in ("pred_boxes", "pred_sted")})
        with mesh:
            out = fwd(replicate(v, mesh), shard_batch(inputs, mesh))
        jax_out[name] = {k: np.asarray(x) for k, x in out.items()}
    return ref, jax_out, [r["time"] for r in ranks], int8


@pytest.fixture(scope="module")
def jax_k2_reference_module():
    """``tests/test_torch_int8.py``'s ``jax_k2_reference``, for a module."""
    from tubedetr_tpu.ops import fused_bottleneck as jfb

    orig = jfb.fused_bottleneck_block

    def reference(xq, sx, kernels, norms, act_max2, act_max3, out_max, dilation=1, **_):
        return jfb.fused_bottleneck_reference(xq, sx, kernels, norms, act_max2, act_max3,
                                              out_max, dilation=dilation)

    jfb.fused_bottleneck_block = reference
    yield
    jfb.fused_bottleneck_block = orig


def test_time_axis_step_matches_one_process(time_axis):
    """The trunk's gradients included: each time rank's covers its frames,
    and the gather's backward scale makes DDP's mean their sum."""
    ref, _, ranks, _ = time_axis
    labels = labels_of(R.cfg_of())
    for res in ranks:
        assert_step_matches(res["step"], ref, labels)
    trunk = [n for n in ref["grads"] if n.startswith("backbone.")]
    assert trunk


def test_time_sharded_float_inference_matches_jax(time_axis):
    _, jax_out, ranks, _ = time_axis
    for res in ranks:
        for k in ("pred_boxes", "pred_sted"):
            np.testing.assert_allclose(res["float"][k], jax_out["float"][k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_time_sharded_int8_inference_matches_one_process_and_jax(time_axis):
    """int8_static + fused: the trunk is per frame, so a share of the frames
    gives its frames' outputs bit for bit against the port's one process.
    Against the JAX package's jitted ``(1, 2)`` mesh the bound is the one
    its own ``test_time_sharded_int8_inference_matches_single_device``
    holds its mesh to (max 0.05, mean 5e-3: under ``jit`` XLA contracts
    float ops, and an ulp at a rounding boundary flips an int8 step; the
    op-by-op comparison at 1e-4 is ``tests/test_torch_int8.py``'s)."""
    _, jax_out, ranks, one = time_axis
    for res in ranks:
        for k in ("pred_boxes", "pred_sted"):
            assert np.array_equal(res["int8"][k], one[k]), k
            err = np.abs(res["int8"][k] - jax_out["int8"][k])
            assert err.max() < 0.05 and err.mean() < 5e-3, (k, err.max(), err.mean())


# ---------------------------------------------------------------------------
# evaluation and meters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [2, 1])
def test_sharded_eval_merges_to_one_process(data_axis, batch_size):
    """The 2 data ranks' shares (3 and 2 videos; in batches of 2 a padded
    tail) of an FSDP state's evaluation: the merged vIoU summary equals one
    process's; in batches of 1 (the one process's batches) so do the synced
    loss meters."""
    from tubedetr_tpu_torch.parallel.train_step import create_train_state

    cfg, _, ranks, tmp = data_axis
    state = create_train_state(cfg, R.model_from(str(tmp / "weights.pt"), cfg))
    want, want_stats = R.evaluate_videos(cfg, state, batch_size)
    assert want
    for res in ranks:
        got, stats = res["eval"][batch_size]
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, k
        if batch_size == 1:
            assert set(stats) == set(want_stats) and stats
            for k in want_stats:
                np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI on two processes
# ---------------------------------------------------------------------------

CLI_FLAGS = [
    "--combine_datasets", "vidstg", "--combine_datasets_val", "vidstg", "--backbone", "resnet14",
    "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1", "--dec_layers", "1",
    "--dim_feedforward", "64", "--video_max_len", "8", "--video_max_len_train", "8",
    "--stride", "2", "--resolution", "128", "--max_text_len", "8", "--text_vocab_size", "128",
    "--text_hidden_size", "32", "--text_layers", "1", "--text_heads", "4", "--text_ffn", "64",
    "--num_workers", "0", "--device", "cpu", "--ema", "--epochs", "1", "--batch_size", "1",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args, out_dir, rank=None, world=None, port=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, "-m", "tubedetr_tpu_torch.apps.train", *args,
                             "--output-dir", str(out_dir)], env=env, cwd=str(out_dir.parent),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_two_process_cli_trains_and_evaluates_as_one(tmp_path):
    """``torchrun``'s variables, two processes, ``--shard_optimizer_state
    --ema``: one epoch over four videos (each rank two), rank 0 alone
    writes ``checkpoint.pth`` and ``log.txt``, the losses are finite; then
    the checkpoint's ``--eval`` on three videos, in two processes and in
    one at once: the same vIoU (1e-6)."""
    from tubedetr_tpu_torch.data.synthetic import write_vidstg_dir

    data = write_vidstg_dir(str(tmp_path / "vidstg"), 4, 3, t=8, h=48, w=64,
                            video_max_len_train=8)
    flags = [*CLI_FLAGS, "--vidstg_ann_path", data, "--vidstg_vid_path", data]
    train_dir = tmp_path / "train"
    port = _free_port()
    outs = _wait([_cli([*flags, "--shard_optimizer_state", "--eval_skip", "2"], train_dir, r, 2,
                       port) for r in range(2)])
    assert "[zero] optimizer state + EMA sharded over data axis (2-way)" in outs[0]
    assert all("distributed: 2 processes" in o for o in outs)
    assert "number of params" in outs[0] and "number of params" not in outs[1]
    assert sorted(os.listdir(train_dir)) == ["checkpoint.pth", "checkpoint0000.pth", "log.txt"]
    (line,) = [json.loads(x) for x in open(train_dir / "log.txt")]
    assert line["epoch"] == 0 and np.isfinite(line["train_loss"])
    ckpt = str(train_dir / "checkpoint.pth")
    port = _free_port()
    evals = {"two": tmp_path / "eval2", "one": tmp_path / "eval1"}
    _wait([_cli([*flags, "--eval", "--load", ckpt], evals["two"], r, 2, port) for r in range(2)]
          + [_cli([*flags, "--eval", "--load", ckpt], evals["one"])])
    got, want = ({k: v for k, v in json.load(open(evals[n] / "log_stats.json")).items()}
                 for n in ("two", "one"))
    assert want and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


# ---------------------------------------------------------------------------
# the build race, the launcher's environment, the config
# ---------------------------------------------------------------------------

BUILD_RACE = """
import sys
sys.path.insert(0, {root!r})
from tubedetr_tpu_torch.data import native
native.SO_PATH = {so!r}
native.get_lib()
import numpy as np
frames = np.random.RandomState(0).randint(0, 256, (2, 6, 8, 3), dtype=np.uint8)
eye = np.eye(6, dtype=np.float32), np.eye(8, dtype=np.float32)
assert np.allclose(native.resize_normalize_clip(frames, *eye),
                   native.resize_normalize_clip(frames, *eye, plain=True), atol=1e-5)
print("LOADED")
"""


def test_two_processes_build_the_staging_library_once(tmp_path):
    """Two processes start at once on an empty build directory: both load a
    working library, there is one ``.so`` and no temporary left."""
    build = tmp_path / "build"
    code = BUILD_RACE.format(root=ROOT, so=str(build / "libstaging.so"))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = _wait(procs, timeout=120)
    assert all("LOADED" in o for o in outs)
    assert sorted(os.listdir(build)) == [".build.lock", "libstaging.so"]


def test_kernel_builds_take_the_lock_and_write_the_log_whole(tmp_path, monkeypatch):
    """``build_all`` holds the build directory's lock while it compiles
    (a second holder waits), and the log arrives whole through a rename."""
    import threading

    from tubedetr_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(_cuda_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(_cuda_build, "_stale", lambda name: True)
    order = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[-2]

        def communicate(self):
            order.append("compile")
            with open(self.out, "w") as f:
                f.write("so")
            return "ptxas info    : Used 40 registers\n" * 1000, None

    monkeypatch.setattr(_cuda_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_cuda_build, "_nvcc", lambda: "nvcc")
    held = threading.Event()

    def other():
        with _cuda_build.build_lock(str(tmp_path)):
            held.set()
            order.append("other")

    with _cuda_build.build_lock(str(tmp_path)):
        t = threading.Thread(target=other)
        t.start()
        assert not held.wait(0.3)  # waits for the holder
    t.join(timeout=10)
    assert not t.is_alive() and order == ["other"]
    logs = _cuda_build.build_all(["k"])
    assert order == ["other", "compile"] and logs["k"].count("Used 40 registers") == 1000
    assert _cuda_build.build_log("k") == logs["k"]
    assert sorted(os.listdir(tmp_path)) == [".build.lock", "libk.log", "libk.so"]


@pytest.mark.parametrize("env,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "n0", "MASTER_PORT": "7"},
     (3, 4, 1, "n0", "7")),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
      "SLURM_JOB_NODELIST": "gpu[03-04,07]", "SLURM_JOB_ID": "12"}, (5, 8, 1, "gpu03", "15012")),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, None),
    ({}, None),
], ids=["torchrun", "slurm", "slurm-one-task", "none"])
def test_launch_environment(env, want):
    got = tdist.launch_env(env)
    assert (None if got is None else (got.rank, got.world, got.local_rank, got.master_addr,
                                       got.master_port)) == want
    if want is None:
        assert tdist.init_distributed_mode("cpu", env) is False
        assert not tdist.is_dist_initialized() and tdist.get_world_size() == 1


def test_print_is_rank_zero_only_unless_forced(capsys):
    try:
        tdist.setup_print_for_distributed(False)
        print("hidden")
        print("shown", force=True)
    finally:
        tdist.restore_print()
    assert capsys.readouterr().out == "shown\n"


def test_config_takes_the_data_and_time_axes():
    """And the model axis: ``validate()`` takes ``mesh_model > 1``, and
    ``mesh_shape`` refuses a world size that ``mesh_time * mesh_model`` does
    not divide."""
    cfg = TubeDETRConfig(mesh_data=4, mesh_time=2, shard_optimizer_state=True,
                         shard_params=True).validate()
    assert mesh_shape(cfg, 8) == (4, 2, 1) and mesh_shape(cfg.replace(mesh_data=1), 8) == (4, 2, 1)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_shape(cfg, 7)
    with pytest.raises(ValueError, match="torchrun"):
        mesh_shape(cfg, 1)
    tp = TubeDETRConfig(mesh_model=2, mesh_time=2).validate()
    assert mesh_shape(tp, 8) == (2, 2, 2) and mesh_shape(tp.replace(mesh_time=1), 8) == (4, 1, 2)
    for world in (6, 2):
        with pytest.raises(ValueError, match="does not divide"):
            mesh_shape(tp, world)
    with pytest.raises(ValueError, match="torchrun"):
        mesh_shape(tp, 1)
    with pytest.raises(ValueError, match="mesh_model"):
        TubeDETRConfig(mesh_model=0).validate()
    with pytest.raises(ValueError, match="mesh_time"):
        TubeDETRConfig(mesh_time=0).validate()


def test_data_ranks_read_a_partition_of_the_shuffled_samples():
    """The CLI's loaders shuffle with the seed itself, shared by the data
    ranks, and each rank takes its strided share: an epoch's shares are
    disjoint and cover the dataset, and the two ranks' batches hold the
    one process's samples of a global batch twice the size; 13 samples
    give both ranks 3 batches (a rank with a batch more would wait alone in
    its step's all-reduce). (The JAX CLI shuffles with ``seed + process
    index``, so its ranks' shares overlap; ``ROADMAP.md`` queue 3.)"""
    from tubedetr_tpu_torch.data.loader import DataLoader

    ds = list(range(13))

    def loader(rank, world, bs):
        return DataLoader(ds, batch_size=bs, t=R.T, stride=R.STRIDE, max_text_len=8,
                          shuffle=True, drop_last=True, seed=42, process_index=rank,
                          process_count=world)

    for epoch in (0, 3):
        shares = []
        for r in range(2):
            ld = loader(r, 2, 2)
            ld.set_epoch(epoch)
            shares.append(ld._batches())
        one = loader(0, 1, 4)
        one.set_epoch(epoch)
        flat = [i for share in shares for b in share for i in b]
        assert len(flat) == len(set(flat)) == 12 and [len(x) for x in shares] == [3, 3]
        for (a, b), whole in zip(zip(*shares), one._batches()):
            assert sorted(a + b) == sorted(whole)
