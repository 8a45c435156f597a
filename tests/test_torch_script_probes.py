"""The port's measuring entry points (``tubedetr_tpu_torch/probes``: the
counterparts of ``scripts/profile_backbone.py``, ``bench_fused_block.py``,
``bench_int8_conv.py``, ``probe_dilated_int8.py``, ``profile_train_step.py``,
``check_int8_accuracy.py``, ``probe_preprocess.py`` and ``bench_staging.py``)
on the CPU, at tiny sizes, held to the JAX package where they compute what
it computes:

* ``fused_block``: its unfused route (float32) and its K2 route (the plain
  version on the CPU) against the JAX unfused int8_static ``Bottleneck``
  (at most one step apart, over 99% equal: ``tests/test_fused_bottleneck.py``'s
  bound), and the K2 route against ``fused_bottleneck_reference`` on the
  port's own folds (equal; ``tests/test_fused_bottleneck.py`` holds the
  interpreted Pallas kernel equal to it);
* ``int8_conv``: the four-parity space-to-batch conv equals the dilated
  int8 conv and ``jax.lax.conv_general_dilated`` on s8 with an s32 result;
* ``train_step``: ``opt``'s first iteration against the JAX optimizer chain
  (``tx.update``, then ``scale_updates_by_lr``) on the same fixed gradients
  (``tests/test_torch_optim.py``'s rtol 1e-5, atol 1e-7), and
  ``fwdbwd_xf``'s gradients equal to ``fwdbwd``'s outside the trunk;
* ``int8_accuracy``: the script's weight rule applied to a JAX tree and
  carried over; the port's float outputs held to the JAX float model's at
  ``tests/test_torch_model.py``'s atol 2e-4, its int8_static ones (on the
  JAX scales, K2's plain version against the JAX emulation) to the JAX int8
  model's at ``tests/test_torch_int8.py``'s atol 1e-4; and the port's own
  rule gives each kind of leaf its constant;
* ``preprocess``: the einsum routes against the script's JAX routes, the
  float32 one at ``tests/test_torch_preprocess.py``'s atol 1e-4;
* ``backbone_stages`` and ``staging`` run end to end at tiny sizes;
* every entry point raises without a card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_int8 import (  # noqa: F401 - jax_k2_reference is a fixture
    assert_steps,
    exact_bn,
    jax_k2_reference,
)
from tests.test_torch_model import TINY, random_variables
from tests.test_torch_train import jax_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models.resnet import Bottleneck as JaxBottleneck
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.ops import fused_bottleneck as jfb
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu.train import optim as jax_optim
from tubedetr_tpu_torch.interop.from_jax import _bottleneck, params_from_jax, qscales_from_jax
from tubedetr_tpu_torch.models import quantize as tq
from tubedetr_tpu_torch.models.resnet import Bottleneck
from tubedetr_tpu_torch.probes import backbone_stages, fused_block, int8_accuracy, int8_conv
from tubedetr_tpu_torch.probes import preprocess, staging, train_step

ENTRY_POINTS = ("backbone_stages", "fused_block", "int8_conv", "train_step", "int8_accuracy",
                "preprocess", "staging")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"tubedetr_tpu_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main() if name != "fused_block" else module.main([])


def test_backbone_stages_runs_every_cut(capsys):
    rec = backbone_stages.profile("timm_resnet14", t=2, res=64, dtype="f32", quant="int8_static",
                                  fused=True, iters=1, device="cpu")
    assert rec["names"] == dict(enumerate(["stem+pool", "layer1", "layer2", "layer3", "layer4"]))
    assert [s[-1] for s in rec["out_shape"].values()] == [64, 256, 512, 1024, 2048]
    assert rec["out_shape"][3][1:3] == rec["out_shape"][4][1:3]  # DC5, as the script builds it
    assert rec["launches"] == {n: 0 for n in range(5)}  # CPU tensors: K2's plain version
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[prof] stages=") for line in lines) == 5
    assert [line.split()[0] for line in lines[-5:]] == list(rec["names"].values())
    b0 = backbone_stages.profile("efficientnet_b0", t=1, res=32, dtype="f32", quant="int8_static",
                                 stages=[0, 7], iters=1, device="cpu")
    assert b0["launches"] == {0: 0, 7: 0} and b0["out_shape"][7][-1] == 320


# ---------------------------------------------------------------------------
# fused_block


def test_fused_block_routes_match_jax(capsys):
    planes, n, h, w = 8, 2, 6, 7
    rng = np.random.RandomState(1)
    xq = rng.randint(-127, 128, (n, h, w, planes * 4)).astype(np.int8)
    sx = np.float32(0.031)
    jx = (jnp.asarray(xq), jnp.float32(sx))
    jblock = JaxBottleneck(planes=planes, quant="int8", qin=True, qout=True, dtype=jnp.float32)
    variables = exact_bn(random_variables(jblock, {"x": jx}, seed=2))
    pb = {k: variables[k] for k in ("params", "buffers")}
    with jax.disable_jit():
        _, upd = jblock.apply(pb, jx, mutable=["qscales"])
        qs = jax.tree_util.tree_map(np.asarray, upd["qscales"])
        want_q, want_s = jblock.clone(quant="int8_static").apply({**pb, "qscales": qs}, jx)

    block = Bottleneck(planes * 4, planes, observers=True, fused=True).eval()
    sd = {k.lstrip("."): v for k, v in _bottleneck(pb["params"], pb["buffers"], "").items()}
    block.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    xt, st = torch.from_numpy(xq), torch.tensor(sx)
    fused_block.calibrate(block, xt, st, torch.float32)  # the probe's own calibration
    bufs = dict(block.named_buffers())
    for name, v in (("conv2.act_max", qs["conv2"]["act_max"]),
                    ("conv3.act_max", qs["conv3"]["act_max"]), ("out_max", qs["out_max"])):
        np.testing.assert_allclose(float(bufs[name]), float(v), rtol=1e-4, err_msg=name)
        bufs[name].fill_(float(v))
    block._fold = None
    fns = fused_block.routes(block, xt, st, torch.float32)
    (un_q, un_s), (k2_q, k2_s) = fns["unfused"](), fns["k2"]()
    for got, s in ((un_q, un_s), (k2_q, k2_s)):
        np.testing.assert_allclose(float(s), float(want_s), rtol=1e-6)
        assert_steps(got.numpy(), want_q, max_step=1, min_equal=0.99)
    # the K2 route on the port's own folds, equal to the JAX emulation and kernel
    args = (jx[0], jx[1],
            {f"conv{i}": jnp.asarray(getattr(block, f"conv{i}").weight.detach().permute(2, 3, 1, 0).numpy())
             for i in (1, 2, 3)},
            {f"bn{i}": tuple(jnp.asarray(t.numpy()) for t in getattr(block, f"bn{i}").fold())
             for i in (1, 2, 3)},
            *(jnp.float32(float(bufs[k])) for k in ("conv2.act_max", "conv3.act_max", "out_max")))
    ref_q, ref_s = jfb.fused_bottleneck_reference(*args)
    np.testing.assert_array_equal(k2_q.numpy(), np.asarray(ref_q))
    assert float(k2_s) == float(ref_s)
    agree, maxd = fused_block.agreement(un_q, k2_q, frames=n)
    assert maxd <= 1 and agree > 0.99
    rec = fused_block.run_stage("layer4", n=2, device="cpu", shape=(8, 6, 7, 2))
    assert rec["max_diff_f32_all"] <= 1 and rec["agree_f32_all"] > 0.99
    assert rec["k2_launches"] == 0 and "agree" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# int8_conv


def test_space_to_batch_conv_is_the_dilated_conv():
    rng = np.random.RandomState(5)
    x = rng.randint(-127, 128, (2, 6, 8, 16)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 16, 8)).astype(np.int8)
    xt, wq = torch.from_numpy(x), int8_conv.flat_weight(torch.from_numpy(w))
    direct = int8_conv.conv2d_int8(xt, wq, 3, 1, 2)
    s2b = int8_conv.space_to_batch_conv(xt, wq)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(1, 1), padding=[(2, 2)] * 2,
        rhs_dilation=(2, 2), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert s2b.dtype == direct.dtype == torch.int32
    np.testing.assert_array_equal(s2b.numpy(), direct.numpy())
    np.testing.assert_array_equal(s2b.numpy(), np.asarray(ref))
    # the probe's loop at tiny shapes (it checks the same equality itself)
    shapes = [(label, 2, 6, 6, 16, 8, k, s, d) for label, _, _, _, _, _, k, s, d in int8_conv.SHAPES]
    recs = int8_conv.run("cpu", shapes, [("d2", 2, 6, 8, 16, 8, 2), ("d1", 2, 6, 8, 16, 8, 1)],
                         ceiling=32, out=lambda line: None)
    assert len(recs) == 2 + 2 * len(shapes) + 2 * 2 + 3


# ---------------------------------------------------------------------------
# train_step

# the tiny model's widths under the probe's config (float32 compute on the CPU)
TRAIN_KW = {k: v for k, v in TINY.items() if k not in (
    "guided_attn", "aux_loss", "stride", "resolution", "video_max_len", "video_max_len_train")}


def test_opt_first_iteration_matches_the_jax_chain():
    cfg = train_step.make_config(t=TINY["video_max_len"], res=TINY["resolution"],
                                 stride=TINY["stride"], quant_fast="none", quant_frozen="none",
                                 **TRAIN_KW)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jmodel = jax_build_model(jcfg)
    inputs = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in jax_model_inputs(jax_batch(TINY)).items()}
    variables = random_variables(jmodel, inputs, seed=3)
    model = train_step.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    state = train_step.create_train_state(cfg, model)
    step = train_step.TrainStep(cfg, deterministic=True)
    train_step.variants(state, step, {}, train_step.LRS, k=1)["opt"]()

    tx, labels = jax_optim.build_optimizer(jcfg, variables["params"])

    @jax.jit
    def chain(params):  # the script's v_opt, one iteration
        grads = jax_optim.mask_frozen_grads(
            jax.tree_util.tree_map(lambda p: p * jnp.float32(train_step.GRAD_SCALE), params),
            labels)
        updates, _ = tx.update(grads, tx.init(params), params)
        updates = jax_optim.scale_updates_by_lr(
            updates, labels, {k: jnp.float32(v) for k, v in train_step.LRS.items()})
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    want = params_from_jax({"params": chain(variables["params"]),
                            "buffers": variables["buffers"]}, cfg)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        moved += p.requires_grad
    assert moved and state.step == 1


def test_fwdbwd_xf_skips_the_trunk_and_keeps_the_other_gradients():
    cfg = train_step.make_config(t=4, res=64, stride=2, **TRAIN_KW)
    state, step, batch = train_step.prepare(cfg, b=1, device="cpu", seed=0)
    fns = train_step.variants(state, step, batch, train_step.LRS, k=1)
    trunk = set(map(id, train_step.trunk_params(state)))

    def grads():
        return {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}

    fns["fwdbwd"]()
    full = grads()
    fns["fwdbwd_xf"]()
    rest = grads()
    names = {n for n, p in state.model.named_parameters() if id(p) not in trunk and p.requires_grad}
    assert set(rest) == names and set(full) - set(rest)  # the trunk's took no gradient
    assert all(state.model.get_parameter(n).requires_grad for n in full)  # restored
    for n in names:
        torch.testing.assert_close(rest[n], full[n], rtol=0, atol=0, msg=n)
    assert train_step.attribution({"fwd": 1.0, "fwdbwd": 4.0, "fwdbwd_xf": 2.5, "opt": 0.5,
                                   "full": 5.0}) == {
        "forward+losses": 1.0, "backbone_bwd": 1.5, "transformer+text+heads_bwd": 1.5,
        "optimizer+apply": 1.0, "optimizer_isolated": 0.5}


# ---------------------------------------------------------------------------
# int8_accuracy


def script_rule(shapes):
    """The JAX script's fabrication (``check_int8_accuracy.py:fab``), float32
    leaves rounded to bf16 and kept in float32."""
    import ml_dtypes

    rng = np.random.RandomState(0)

    def fab(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("act_max", "out_max"):
            return np.zeros(leaf.shape, np.float32)
        if name == "running_var" or name == "scale" or (name == "weight" and len(leaf.shape) == 1):
            return np.ones(leaf.shape, np.float32)
        if name in ("running_mean", "bias"):
            return np.zeros(leaf.shape, np.float32)
        return np.asarray(rng.randn(*leaf.shape) * 0.02, ml_dtypes.bfloat16).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fab, shapes)


def test_int8_accuracy_matches_jax(jax_k2_reference):
    """The JAX side runs jitted, one compile a pass: under ``jit`` XLA turns
    a quantizer's ``x / s`` into ``x * (1 / s)``, which moves its own
    calibrated maxima by up to 2% (``tests/test_torch_int8.py`` holds the two
    calibrations op by op), so the port's int8 model runs on the JAX scales.
    With the script's weights the heads move by under 2e-5 between the float
    and the int8 trunk: this holds the probe's weights, inputs and readings;
    the int8 trunk itself is held in ``tests/test_torch_int8.py`` and
    ``tests/test_torch_resnet_stages.py``."""
    kw = {**TRAIN_KW, "backbone": "resnet26", "scan_backbone_blocks": False, "stride": 2}
    cfg = int8_accuracy.make_config(t=4, res=64, **kw)
    cfg_q = cfg.replace(backbone_quant="int8_static", fused_bottleneck=True)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jq_model = jax_build_model(jcfg.replace(backbone_quant="int8_static", fused_bottleneck=True))
    inputs = {k: (v.float() if v.is_floating_point() else v)
              for k, v in int8_accuracy.make_batch(cfg, np.random.RandomState(0)).items()}
    batch = {k: (v.numpy().astype(np.int32) if v.dtype == torch.int64 else v.numpy())
             for k, v in inputs.items()}
    variables = script_rule(jax.eval_shape(jq_model.init, jax.random.PRNGKey(0), **batch))
    pb = {k: variables[k] for k in ("params", "buffers")}
    calib = jax_build_model(jcfg.replace(backbone_quant="int8"))
    _, upd = jax.jit(lambda v, b: calib.apply(v, **b, mutable=["qscales"]))(pb, batch)
    qs = jax.tree_util.tree_map(np.asarray, upd["qscales"])
    ref_q = jax.jit(lambda v, b: jq_model.apply(v, **b))({**pb, "qscales": qs}, batch)
    ref_f = jax.jit(lambda v, b: jax_build_model(jcfg).apply(v, **b))(pb, batch)

    model_f = int8_accuracy.build_model(cfg, device="cpu")
    model_q = int8_accuracy.build_model(cfg_q, device="cpu")
    for m in (model_f, model_q):
        m.load_state_dict(params_from_jax(pb, cfg))
    tq.set_model_qscales(model_q, qscales_from_jax(qs))
    out_f, out_q, launches = int8_accuracy.compare(model_f, model_q, inputs)
    assert launches == 0  # CPU tensors: K2's plain version
    for k in ("pred_boxes", "pred_sted"):
        np.testing.assert_allclose(out_f[k].numpy(), np.asarray(ref_f[k]), atol=2e-4, err_msg=k)
        np.testing.assert_allclose(out_q[k].numpy(), np.asarray(ref_q[k]), atol=1e-4, err_msg=k)
    rec = int8_accuracy.deviations(out_f, out_q)
    assert rec["boxes_corr"] > 0.999 and rec["sted_max_dev"] < 1e-3
    assert len(rec["argmax_f32"]) == len(rec["argmax_int8"]) == 2


def test_int8_accuracy_rule_gives_each_leaf_its_constant():
    cfg = int8_accuracy.make_config(t=4, res=64, **TRAIN_KW)
    model = int8_accuracy.build_model(cfg, device="cpu")
    sd = int8_accuracy.fabricate(model)
    assert set(sd) == set(model.state_dict())
    drawn = []
    for name, v in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var" or (leaf == "weight" and v.dim() == 1):
            assert torch.equal(v, torch.ones_like(v)), name
        elif leaf == "running_mean" or leaf.endswith("bias"):
            assert torch.equal(v, torch.zeros_like(v)), name
        else:
            assert torch.equal(v, v.bfloat16().float()), name  # rounded to bf16
            drawn.append(v.ravel())
    drawn = torch.cat(drawn)
    assert abs(float(drawn.std()) - 0.02) < 1e-3 and abs(float(drawn.mean())) < 1e-3


# ---------------------------------------------------------------------------
# preprocess


def test_einsum_routes_match_the_scripts():
    from tubedetr_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from tubedetr_tpu.ops.preprocess import _interp_matrix as jax_interp_matrix

    frames = preprocess.make_frames(np.random.RandomState(2), t=2, device="cpu")
    oh = ow = 40
    ih, iw = frames.shape[1:3]
    mean, std = jnp.asarray(IMAGENET_MEAN, jnp.float32), jnp.asarray(IMAGENET_STD, jnp.float32)

    def jax_route(f, precision, dt):  # the script's einsum_path, before its bf16 cast
        x = (f.astype(jnp.float32) / 255.0 - mean) / std
        x = x.astype(dt)
        x = jnp.einsum("oh,nhwc->nowc", jnp.asarray(jax_interp_matrix(ih, oh)).astype(dt), x,
                       precision=precision)
        return jnp.einsum("pw,nowc->nopc", jnp.asarray(jax_interp_matrix(iw, ow)).astype(dt), x,
                          precision=precision)

    ref = np.asarray(jax_route(jnp.asarray(frames.numpy()), jax.lax.Precision.HIGHEST,
                               jnp.float32))
    mats = [torch.from_numpy(preprocess._interp_matrix(i, o)) for i, o in ((ih, oh), (iw, ow))]
    stats = [torch.tensor(v) for v in (preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD)]
    got = preprocess.einsum_route(frames, *mats, *stats, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    recs = preprocess.run(t=2, res=oh, device="cpu", out=lambda line: None)
    assert set(recs) == {"k1_bf16", "einsum_bf16", "einsum_f32h"}
    assert recs["k1_bf16"]["max_abs_diff_from_k1"] == 0
    assert recs["einsum_f32h"]["max_abs_diff_from_k1"] < 0.05  # within a bf16 step of |x| <= 3


def test_staging_reports_both_rates():
    lines = []
    rec = staging.run(t=3, ih=36, iw=64, res=32, iters=1, demand={"a reading": 0.5},
                      out=lines.append)
    assert rec["native"]["frames_per_s"] > 0 and rec["plain"]["frames_per_s"] > 0
    assert set(rec["cores_to_overlap"]) == {"a reading"} and len(lines) == 3
