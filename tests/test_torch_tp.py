"""Tensor parallelism (the ``model`` axis) of the port on the CPU (gloo), held to one process and to the JAX package.

The tiny config of ``tests/torch_dist_ranks.py`` from seeded JAX variables
(``params_from_jax``), dropout off (the dropout-free step). The ranks are
spawned once a world size (``torch_dist_ranks.tp_ranks``): 2 ranks for
model=2, 4 ranks for data=2 x model=2, model=4 and time=2 x model=2.

* The rules: ``tp_split`` against the JAX package's ``tp_param_pspecs``
  leaf by leaf through ``params_from_jax`` (each JAX leaf filled with the
  model block each element lies in, -1 where it is replicated, then moved
  by the name map: every slice a port rank keeps must hold its own block),
  at model=2, and at model=3, where the 4 heads do not divide;
  ``count_tp_sharded`` equal to the JAX count.
* The train step on 2 ranks (model=2) and on 4 (data=2 x model=2 under
  DDP, ZeRO-1 and FSDP; time=2 x model=2; model=4) against one process on
  the four videos:
  the loss terms and ``grad_norm`` (rtol 1e-5), every gradient leaf
  gathered back whole (atol 5e-5, rtol 5e-4), the parameters and EMA
  within AdamW's first-step bound (``adamw_atol``). Its loss against the
  JAX ``make_mesh(data=2, time=1, model=2)`` step with
  ``shard_train_state`` (rtol 1e-5).
* Inference: model=4 against one process and against the JAX
  ``place_variables_tp`` forward on a ``(1, 1, 4)`` mesh (boxes atol 2e-5,
  rtol 1e-4; sted atol 2e-4, rtol 1e-3); int8_static + fused
  (K2's plain version) against one process's int8 forward; 2 heads on
  model=4 (the attention stays whole, the FFN is cut) and time=2 x model=2
  against one process.
* Checkpoints: a checkpoint written under TP (DDP and FSDP) loads in one
  process exactly and in ``GroundingPipeline.reload``; a one-process
  checkpoint resumes under TP + ZeRO-1 and its next step is one process's
  second step.
* The CLI: ``python -m tubedetr_tpu_torch.apps.train --mesh_model 2``
  trains and evaluates in two processes.

A step past the first is not compared: AdamW's first update is ``lr *
g / (|g| + 1e-8)``, so gradient elements of about 1e-8 take either sign's
full step on float noise, and the tiny model's second step moves by
several per cent with them (one process run on the TP step's parameters
gives the TP step's second ``grad_norm``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests import torch_dist_ranks as R
from tests.test_torch_dist import CLI_FLAGS, _cli, _free_port, _wait, jax_batch, jax_inputs
from tests.test_torch_model import random_variables
from tests.torch_dist_ranks import adamw_atol, assert_close, labels_of
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tubedetr_tpu.parallel.mesh import shard_batch
from tubedetr_tpu.parallel.tp import place_variables_tp as jax_place_variables_tp
from tubedetr_tpu.parallel.tp import shard_train_state as jax_shard_train_state
from tubedetr_tpu.parallel.tp import tp_param_pspecs
from tubedetr_tpu.parallel.train_step import create_train_state as jax_create_state
from tubedetr_tpu.parallel.train_step import make_train_step as jax_make_train_step
from tubedetr_tpu_torch.interop.from_jax import params_from_jax
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.parallel.tp import Split, count_tp_sharded, cut, join, tp_split

LOSS_RTOL = R.LOSS_RTOL
TP_GRAD_ATOL, TP_GRAD_RTOL = 5e-5, 5e-4
BOX_TOL, STED_TOL = dict(atol=2e-5, rtol=1e-4), dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    model = jax_build_model(JaxConfig(**R.KW))
    variables = random_variables(model, jax_inputs(jax_batch()), seed=2)
    path = str(tmp / "weights.pt")
    torch.save(params_from_jax(variables, R.cfg_of()), path)
    return variables, path, tmp


def _forward(path, cfg, inputs, qscales=None):
    from tubedetr_tpu_torch.models.quantize import set_model_qscales

    model = R.model_from(path, cfg)
    if qscales is not None:
        set_model_qscales(model, qscales)
    threads = torch.get_num_threads()
    torch.set_num_threads(R.THREADS)
    try:
        with torch.inference_mode():
            o = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    finally:
        torch.set_num_threads(threads)
    return {k: o[k].float().numpy() for k in ("pred_boxes", "pred_sted")}


@pytest.fixture(scope="module")
def one_process(weights):
    """One process: a step on the four videos, its checkpoint and a second
    step; the inference forwards of one video (float, int8_static + fused
    with the port's calibration, 2 heads)."""
    from tubedetr_tpu_torch.models.quantize import calibrate_qscales, model_qscales
    from tubedetr_tpu_torch.parallel.train_step import model_inputs
    from tubedetr_tpu_torch.train.checkpoint import checkpoint_payload, save_checkpoint

    _, path, tmp = weights
    cfg = R.cfg_of()
    threads = torch.get_num_threads()
    torch.set_num_threads(R.THREADS)
    try:
        ref = R.run_steps(cfg, path, R.batch_of())
        save_checkpoint(str(tmp / "ckpt1.pth"), checkpoint_payload(ref["state"], 0, cfg))
        step2 = R.RecordingStep(cfg)(ref["state"], R.batch_of())[1]
        inputs = {k: v.numpy() for k, v in model_inputs(R.batch_of(((5, 8), (1, 7)))).items()}
        qcfg = R.cfg_of(backbone_quant="int8_static", fused_bottleneck=True)
        qmodel = R.model_from(path, qcfg)
        calibrate_qscales(qcfg, qmodel, {k: torch.from_numpy(v) for k, v in inputs.items()})
    finally:
        torch.set_num_threads(threads)
    ref = R._strip(ref)
    ref["metrics"].append({k: float(v) for k, v in step2.items()})
    qscales = {k: np.asarray(v) for k, v in model_qscales(qmodel).items()}
    fwd = {"float": _forward(path, cfg, inputs), "int8": _forward(path, qcfg, inputs, qscales),
           "heads2": _forward(path, R.cfg_of(nheads=2, text_heads=2), inputs)}
    return ref, inputs, qscales, fwd


@pytest.fixture(scope="module")
def ranks4(weights, one_process):
    _, path, tmp = weights
    _, inputs, qscales, _ = one_process
    return R.spawn(R.tp_ranks, 4, tmp, path, str(tmp), inputs, qscales, threads=1)


@pytest.fixture(scope="module")
def ranks2(weights, one_process):
    _, path, tmp = weights
    _, inputs, qscales, _ = one_process
    return R.spawn(R.tp_ranks, 2, tmp, path, str(tmp), inputs, qscales, threads=1)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _block_tree(params, specs, model):
    """Each JAX leaf filled with the model block of each element along its
    ``model``-sharded axis; -1 where the leaf is replicated."""
    from jax.sharding import PartitionSpec as P

    def fill(x, spec):
        x = np.asarray(x)
        out = np.full(x.shape, -1.0, np.float32)
        for axis, name in enumerate(spec):
            if name == "model":
                block = np.repeat(np.arange(model, dtype=np.float32), x.shape[axis] // model)
                shape = [1] * x.ndim
                shape[axis] = x.shape[axis]
                out = np.broadcast_to(block.reshape(shape), x.shape).copy()
        return out

    return jax.tree_util.tree_map(fill, params, specs, is_leaf=lambda s: isinstance(s, P))


@pytest.mark.parametrize("model", [2, 3])
def test_split_rules_match_jax_leaf_by_leaf(weights, model):
    """At model=3 the 4 heads do not divide: every attention projection
    stays whole (the FFN's 64 units do not divide either)."""
    from jax.sharding import PartitionSpec as P

    variables = weights[0]
    cfg = R.cfg_of()
    specs = tp_param_pspecs(variables["params"], model=model, nheads=cfg.nheads,
                            text_heads=cfg.text_heads)
    blocks = params_from_jax({"params": _block_tree(variables["params"], specs, model),
                              "buffers": variables["buffers"]}, cfg)
    port = build_model(cfg, device="cpu")
    names = dict(port.named_parameters())
    n_split = 0
    for n, t in blocks.items():
        if n not in names:
            continue  # a buffer
        s = tp_split(n, tuple(t.shape), model, cfg.nheads, cfg.text_heads)
        if s is None:
            assert (t == -1).all(), f"{n}: JAX shards it, the port keeps it whole"
            continue
        n_split += 1
        for r in range(model):
            assert (cut(t, s, model, r) == r).all(), f"{n} {s}: rank {r}'s slice is not JAX's"
        assert torch.equal(join([cut(t, s, model, r) for r in range(model)], s), t)
    jax_count = sum(1 for s in jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(s, P))
                    if any(e is not None for e in s))
    assert count_tp_sharded(port, model, cfg.nheads, cfg.text_heads) == jax_count
    if model == 3:
        assert n_split == 0 and jax_count == 0
    else:
        assert n_split > 0 and jax_count == 40


def test_split_rules_at_the_published_widths():
    """ResNet-101 / RoBERTa-base / 8 heads / 6+6 layers / 2048: the leaves
    cut at model=2 and 4 (both divide 8 and 12 heads), with 3 heads none of
    the attention."""
    from tubedetr_tpu_torch.config import TubeDETRConfig

    from tubedetr_tpu_torch.models.tubedetr import TubeDETR

    cfg = TubeDETRConfig(device="cpu").validate()
    with torch.device("meta"):  # shapes only, no storage
        model = TubeDETR(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}

    # a layer: 7 attention leaves a MHA (q, k, v kernels and biases, out_proj),
    # 3 FFN leaves; RoBERTa 7 + 3 a layer, 3 embedding tables
    want = 6 * (7 + 3) + 6 * (2 * 7 + 3) + 12 * (7 + 3) + 3
    for m in (2, 4):
        assert count_tp_sharded(model, m, cfg.nheads, cfg.text_heads) == want
    attn = [n for n in shapes if tp_split(n, shapes[n], 3, cfg.nheads, cfg.text_heads)
            and ("attn" in n or "attention" in n)]
    assert attn == [n for n in attn if "attention.self" in n or "attention.output" in n]
    assert Split(0, True) == tp_split("transformer.encoder.layers.0.self_attn.in_proj_weight",
                                      (768, 256), 4, 8, 12)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _assert_tp_step(res, ref, cfg):
    m, rm = res["metrics"][0], ref["metrics"][0]
    assert set(m) == set(rm)
    for k in rm:
        np.testing.assert_allclose(m[k], rm[k], rtol=LOSS_RTOL, err_msg=k)
    assert set(res["grads"]) == set(ref["grads"])
    for n, g in ref["grads"].items():
        np.testing.assert_allclose(res["grads"][n], g, rtol=TP_GRAD_RTOL, atol=TP_GRAD_ATOL,
                                   err_msg=f"grad {n}")
    atol = adamw_atol(labels_of(cfg), res["grads"], ref["grads"], rm["grad_norm"],
                      R.KW["clip_max_norm"])
    atol.update({n: np.float32(0.0) for n in ref["params"] if n not in atol})  # frozen
    assert_close(res["params"], ref["params"], atol, "param")
    assert_close(res["ema"], ref["ema"], atol, "ema")


def test_tp_step_on_two_ranks_matches_one_process(one_process, ranks2):
    ref = one_process[0]
    for res in ranks2:
        assert res["tp2"]["tp_split"]
        _assert_tp_step(res["tp2"], ref, R.cfg_of())


@pytest.mark.parametrize("name", ["tp", "tp_zero", "tp_fsdp", "tp_time", "tp4"])
def test_tp_step_on_four_ranks_matches_one_process(one_process, ranks4, name):
    """data=2 x model=2 (DDP, ZeRO-1, FSDP over the slices), time=2 x
    model=2 (the trunk's gradients included) and model=4."""
    ref = one_process[0]
    extra = {"tp_zero": {"shard_optimizer_state": True}, "tp_fsdp": {"shard_params": True}}
    for res in ranks4:
        _assert_tp_step(res[name], ref, R.cfg_of(**extra.get(name, {})))
    if name == "tp_fsdp":  # FSDP shards the slices again, never the trunk
        assert ranks4[0][name]["sharded"]
        assert not any(n.startswith("backbone.") for n in ranks4[0][name]["sharded"])
    if name == "tp_zero":  # each data rank (ranks 0 and 2 of model rank 0) about half
        shares = [ranks4[r][name]["local_moment_elems"] for r in (0, 2)]
        whole = ranks4[0]["tp"]["local_moment_elems"]
        assert sum(shares) == whole and all(0.4 * whole <= s <= 0.6 * whole for s in shares)
    # the replicated parameters agree bit for bit over the model ranks
    for n, p in ranks4[0][name]["params"].items():
        assert np.array_equal(p, ranks4[1][name]["params"][n]), n


def test_tp_step_matches_jax_tp_mesh(weights, ranks4):
    """The JAX package's step on ``make_mesh(data=2, time=1, model=2)``
    with ``shard_train_state``, from the same variables, on the four videos."""
    variables = weights[0]
    jcfg = JaxConfig(**R.KW)
    model = jax_build_model(jcfg)
    state, tx, labels = jax_create_state(jcfg, variables)
    mesh = jax_make_mesh(data=2, time=1, model=2, devices=jax.devices()[:4])
    with mesh:
        state, shardings = jax_shard_train_state(state, mesh, nheads=jcfg.nheads,
                                                 text_heads=jcfg.text_heads)
        step = jax_make_train_step(jcfg, model, tx, labels, donate=False, deterministic=True,
                                   state_shardings=shardings)
        _, metrics = step(state, shard_batch(jax_batch(), mesh),
                          {k: np.float32(v) for k, v in R.LRS.items()}, np.int32(0))
    for k, v in metrics.items():
        rtol = 1e-4 if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(ranks4[0]["tp"]["metrics"][0][k], float(v), rtol=rtol,
                                   err_msg=k)


def test_one_process_checkpoint_resumes_under_tp(one_process, ranks4):
    ref = one_process[0]
    for res in ranks4:
        for k, v in ref["metrics"][1].items():
            np.testing.assert_allclose(res["resume_tp"]["metrics"][0][k], v, rtol=LOSS_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["tp", "tp_fsdp"])
def test_tp_checkpoint_loads_in_one_process(weights, ranks4, name):
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.parallel.train_step import create_train_state
    from tubedetr_tpu_torch.train.checkpoint import load_checkpoint, resume_state

    _, path, tmp = weights
    cfg = R.cfg_of()
    res = ranks4[0][name]
    ckpt_path = str(tmp / f"ckpt_{name}.pth")
    ckpt = load_checkpoint(ckpt_path)
    state = create_train_state(cfg, R.model_from(path, cfg))
    assert resume_state(state, ckpt) == 1 and state.step == 1
    params = dict(state.model.named_parameters())
    for n, p in res["params"].items():
        assert np.array_equal(params[n].detach().numpy(), p), n
    for n, e in res["ema"].items():
        assert np.array_equal(state.ema_params[n].numpy(), e), n
    for i, st in res["opt"]["state"].items() if name == "tp" else ():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ckpt["optimizer"]["state"][i][k], st[k]), (i, k)
    pipe = GroundingPipeline(cfg, device="cpu")
    pipe.reload(ckpt_path)
    live = dict(pipe.model.named_parameters())
    for n, e in res["ema"].items():
        assert np.array_equal(live[n].detach().numpy(), e), n


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


def _assert_outputs(out, ref, what):
    np.testing.assert_allclose(out["pred_boxes"], ref["pred_boxes"], err_msg=what, **BOX_TOL)
    np.testing.assert_allclose(out["pred_sted"], ref["pred_sted"], err_msg=what, **STED_TOL)


@pytest.mark.parametrize("name,ref_name", [("infer4", "float"), ("int8_4", "int8"),
                                           ("heads2", "heads2"), ("time2_model2", "float")])
def test_tp_inference_matches_one_process(one_process, ranks4, name, ref_name):
    fwd = one_process[3]
    for res in ranks4:
        _assert_outputs(res[name], fwd[ref_name], name)
    whole = ranks4[0][name]["whole_attention"]
    if name == "heads2":  # 2 heads over 4 ranks: every attention whole, the FFNs cut
        assert len(whole) == R.KW["enc_layers"] + 2 * R.KW["dec_layers"] + R.KW["text_layers"]
    else:
        assert not whole, whole


def test_tp_fsdp_state_evaluates_on_its_gathered_slices(weights, one_process, ranks4):
    """``gather_state`` of a TP + FSDP state: an unsharded copy cut over the
    model axis, whose forward equals one process's with the step's
    parameters."""
    _, path, _ = weights
    res = ranks4[0]["tp_fsdp"]
    sd = torch.load(path)
    sd.update({n: torch.from_numpy(p) for n, p in res["params"].items()})
    model = build_model(R.cfg_of(), device="cpu")
    model.load_state_dict(sd)
    with torch.inference_mode():
        o = model(**{k: torch.from_numpy(v) for k, v in one_process[1].items()})
    for r in ranks4:
        _assert_outputs(r["tp_fsdp"]["eval_forward"],
                        {k: o[k].float().numpy() for k in ("pred_boxes", "pred_sted")}, "eval")


def test_tp_inference_matches_jax_place_variables_tp(weights, one_process, ranks4):
    variables = weights[0]
    inputs = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in one_process[1].items()}
    jcfg = JaxConfig(**R.KW)
    model = jax_build_model(jcfg)
    mesh = jax_make_mesh(data=1, time=1, model=4, devices=jax.devices()[:4])
    fwd = jax.jit(lambda v, b: {k: model.apply(v, **b)[k] for k in ("pred_boxes", "pred_sted")})
    with mesh:
        placed = jax_place_variables_tp(variables, mesh, nheads=jcfg.nheads,
                                        text_heads=jcfg.text_heads)
        out = fwd(placed, shard_batch(inputs, mesh))
    _assert_outputs(ranks4[0]["infer4"], {k: np.asarray(v) for k, v in out.items()}, "jax")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_trains_and_evaluates_with_mesh_model_2(tmp_path):
    """``--mesh_model 2`` in two processes: the JAX CLI's ``tp`` line, one
    epoch, rank 0's checkpoint (whole), then ``--eval`` of it in two
    processes on the slices and in one: the same vIoU (1e-6)."""
    from tubedetr_tpu_torch.apps.cli import config_from_args
    from tubedetr_tpu_torch.data.synthetic import write_vidstg_dir
    from tubedetr_tpu_torch.train.checkpoint import load_checkpoint

    data = write_vidstg_dir(str(tmp_path / "vidstg"), 2, 3, t=8, h=48, w=64,
                            video_max_len_train=8)
    flags = [*CLI_FLAGS, "--vidstg_ann_path", data, "--vidstg_vid_path", data,
             "--mesh_model", "2"]
    train_dir = tmp_path / "train"
    port = _free_port()
    outs = _wait([_cli([*flags, "--eval_skip", "2"], train_dir, r, 2, port) for r in range(2)])
    assert "[shard] tp: 40 param leaves over model (2-way)" in outs[0]
    (line,) = [json.loads(x) for x in open(train_dir / "log.txt")]
    assert line["epoch"] == 0 and np.isfinite(line["train_loss"])
    ckpt = str(train_dir / "checkpoint.pth")
    whole = build_model(config_from_args(flags[:-2]), device="cpu").state_dict()
    saved = load_checkpoint(ckpt)["model"]
    assert set(saved) == set(whole) and all(v.shape == whole[k].shape for k, v in saved.items())
    port = _free_port()
    evals = {"two": tmp_path / "eval2", "one": tmp_path / "eval1"}
    outs = _wait([_cli([*flags, "--eval", "--load", ckpt], evals["two"], r, 2, port)
                  for r in range(2)]
                 + [_cli([*flags[:-2], "--eval", "--load", ckpt], evals["one"])])
    assert "[shard] tp: 40 param leaves over model (2-way)" in outs[0]
    got, want = (json.load(open(evals[n] / "log_stats.json")) for n in ("two", "one"))
    assert want and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
