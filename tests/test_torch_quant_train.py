"""The quantized training passes against the JAX package, on the CPU.

``int8_qat`` (fake-quant with straight-through gradients), the int8 fast
pass (``backbone_quant_fast`` in ``int8_static`` and dynamic ``int8``), the
int8 frozen prefix (``backbone_quant_frozen``), the two together with a QAT
rest, the GroupNorm trunk under ``int8_static`` and ``int8_qat``, the drift
probe and the bfloat16 QAT trunk. The tiny model and batch are
``tests/test_torch_train.py``'s (resnet14, T=6, stride 2, two videos), its
JAX variables with every FrozenBN ``running_var + eps`` equal to 1 in
float32 (``unit_bn``: both packages then fold the same BN scale; XLA's
``rsqrt`` is not correctly rounded), the scales calibrated by the port and
handed to the JAX step.

An int8 rounding that sits on a boundary flips on one ulp of float noise,
and a flip moves what follows it. The integer convs of the int8 passes sum
exactly, but XLA reorders and contracts the float ops around them under
``jit``, and turns each quantizer's ``x / s`` into ``x * (1 / s)`` (with
that rewrite in the port, the bfloat16 QAT trunk below equals the jitted
JAX one to the bit; without it, the JAX one run op by op); QAT's convs are
float convs, and XLA and oneDNN sum them in other orders. The port divides,
as the JAX source does. So the bounds are these:

* the observer trees, the calibration and the drift probe's maxima: equal
  key sets and layouts, values to rtol 1e-4 (``tests/test_torch_int8.py``'s
  calibration bound, the JAX side op by op);
* a block (GroupNorm, ``int8_static`` and ``int8_qat``): at most 1 int8
  step of its output scale apart and at least 99% of the elements equal
  (``tests/test_torch_int8.py``'s block bound); measured: equal;
* a trunk: at most 3 steps of its last output scale and correlation above
  0.999 (``tests/test_torch_int8.py``'s trunk bound), and the QAT gradients
  leaf by leaf to atol 1e-4 of the leaf's largest |g| plus 1e-6
  (``tests/test_torch_train.py``'s gradient bound); measured: the outputs
  equal, the gradients within 2e-6 of the largest;
* a train step of each pass against the jitted JAX ``make_train_step``
  (``STEP_*`` below): the loss terms to rtol 1e-3 and ``grad_norm`` to
  rtol 2e-2, at least 98% of the post-step parameters within
  ``tests/test_torch_train.py``'s atol 2e-5 and every one within the
  largest AdamW step, 2 lr of its group (measured worst: loss terms
  2.8e-4, ``grad_norm`` 3.3e-3);
* QAT against the port's own ``int8_static`` forward: ``pred_boxes``
  within 5e-3 (``tests/test_qat.py``'s bound);
* the bfloat16 QAT trunk: at least 90% of its outputs equal to the JAX
  trunk's to the bit and within half the JAX trunk's bfloat16-vs-float32
  distance (``tests/test_torch_mixed_precision.py``'s trunk criterion).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_int8 import assert_steps, assert_trees_close, exact_bn
from tests.test_torch_model import random_variables
from tests.test_torch_train import (
    KW,
    LRS,
    GROUP_LR,
    PARAM_ATOL,
    jax_batch,
    jax_variables,
    port_batch,
    port_model,
    to_port_names,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models import quantize as jq
from tubedetr_tpu.models.resnet import Bottleneck as JaxBottleneck
from tubedetr_tpu.models.resnet import ResNet as JaxResNet
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.train_step import create_train_state as jax_create_state
from tubedetr_tpu.parallel.train_step import make_train_step as jax_make_train_step
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import (
    _bottleneck,
    qscales_from_jax,
    qscales_to_flax,
    resnet_from_jax,
    resnet_qscales_from_jax,
    resnet_qscales_to_flax,
)
from tubedetr_tpu_torch.models import quantize as tq
from tubedetr_tpu_torch.models.resnet import Bottleneck, ResNet
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    model_inputs,
    to_device,
)

PASSES = {
    "int8_qat": dict(backbone_quant="int8_qat"),
    "fast-int8_static": dict(backbone_quant_fast="int8_static"),
    "fast-int8": dict(backbone_quant_fast="int8"),
    "frozen-int8_static": dict(backbone_quant_frozen="int8_static"),
    "frozen-int8_static+qat": dict(backbone_quant="int8_qat", backbone_quant_frozen="int8_static"),
}
TREES = {**PASSES, "fast+frozen-int8_static": dict(backbone_quant_fast="int8_static",
                                                    backbone_quant_frozen="int8_static"),
         "int8_qat-unrolled": dict(backbone_quant="int8_qat", scan_backbone_blocks=False)}
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_PARAM_SHARE = 1e-3, 2e-2, 0.98
STEP_RTOL, TRUNK_STEPS, GRAD_ATOL = 1e-4, 3, 1e-4
QAT_VS_STATIC_ATOL, BF16_FRACTION = 5e-3, 0.5


def unit_bn(variables):
    """``variables`` with every ``running_var`` at ``1 - 1e-5``, whose sum
    with eps is 1 in float32: both packages fold the BN scale to the weight
    itself."""
    one = np.float32(1.0) - np.float32(1e-5)
    assert one + np.float32(1e-5) == np.float32(1.0)

    def fix(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        return np.full(np.shape(leaf), one, np.float32) if name == "running_var" else leaf

    return jax.tree_util.tree_map_with_path(fix, variables)


@pytest.fixture(scope="module")
def variables():
    return unit_bn(jax_variables(KW)[1])


def port_inputs(kw):
    return model_inputs(to_device(port_batch(kw), torch.device("cpu")))


def calibrated(kw, variables):
    """(cfg, port model, JAX qscales tree): int8_static scales calibrated
    by the port on the batch; a dynamic int8 pass reads no scale (zeros)."""
    cfg, model = port_model(kw, variables)
    if "int8_static" in (kw.get("backbone_quant_fast"), kw.get("backbone_quant_frozen")) or \
            kw.get("backbone_quant") == "int8_qat":
        qs = tq.calibrate_qscales(cfg, model, port_inputs(kw))
    else:
        qs = qscales_to_flax(tq.model_qscales(model), cfg.scan_backbone_blocks)
    return cfg, model, qs


# ---------------------------------------------------------------------------
# the observer trees


@pytest.mark.parametrize("case", list(TREES))
def test_observer_trees_match_jax(case, variables):
    """The trunk's observers are the JAX calibration model's ``qscales``
    tree for each config: the same leaves through ``resnet_qscales_from_jax``
    (which ``load_qscales`` takes, key set checked) and the same tree back
    through ``resnet_qscales_to_flax``."""
    kw = {**KW, **TREES[case]}
    jcfg = JaxConfig(**kw)
    calib = jax_build_model(jq.calibration_cfg(jcfg))
    inputs = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in jax_model_inputs(jax_batch(kw)).items()}
    _, upd = jax.eval_shape(
        lambda v, b: calib.apply(v, **b, deterministic=True, mutable=["qscales"]),
        {k: variables[k] for k in ("params", "buffers")}, inputs)
    want = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, np.float32), upd["qscales"])
    model = build_model(TubeDETRConfig(**kw), device="cpu")
    flat = qscales_from_jax(want)
    assert set(flat) == set(tq.model_qscales(model))
    tq.set_model_qscales(model, flat)
    got = qscales_to_flax(tq.model_qscales(model), kw.get("scan_backbone_blocks", True))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert_trees_close(got, want, rtol=0)
    if case.startswith("frozen-int8_static") and "qat" not in case:
        assert set(want["backbone"]) == {"stem_act_max", "layer1_0"}


# ---------------------------------------------------------------------------
# a train step of each pass


@pytest.mark.parametrize("case", list(PASSES))
def test_train_step_matches_jax(case, variables):
    kw = {**KW, **PASSES[case]}
    cfg, model, qs = calibrated(kw, variables)
    jcfg = JaxConfig(**kw)
    state, tx, labels = jax_create_state(jcfg, variables)
    step = jax_make_train_step(jcfg, jax_build_model(jcfg), tx, labels, donate=False,
                               deterministic=True, extra_vars={"qscales": qs})
    jstate, jmetrics = step(state, jax_batch(kw), {k: np.float32(v) for k, v in LRS.items()},
                            np.int32(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pstate = create_train_state(cfg, model)
    pstate, metrics = make_train_step(cfg, deterministic=True)(pstate, port_batch(kw), LRS, 0)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        rtol = STEP_NORM_RTOL if k == "grad_norm" else STEP_LOSS_RTOL
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol, err_msg=k)
    params = dict(model.named_parameters())
    ref = to_port_names(jstate.params, variables, cfg)
    close, total = 0, 0
    for n, p in params.items():
        diff = np.abs(p.detach().numpy() - ref[n].numpy())
        assert diff.max() <= 2 * GROUP_LR[pstate.labels[n]] + PARAM_ATOL, n
        close += int((diff <= PARAM_ATOL).sum())
        total += diff.size
    assert close >= STEP_PARAM_SHARE * total, close / total
    # the frozen stem and layer1 and the scales stayed, layer2 trained
    for n in ("backbone.0.body.conv1.weight", "backbone.0.body.layer1.0.conv1.weight"):
        assert torch.equal(params[n].detach(), before[n]), n
    assert not torch.equal(params["backbone.0.body.layer2.0.conv1.weight"].detach(),
                           before["backbone.0.body.layer2.0.conv1.weight"])
    assert_trees_close(qscales_to_flax(tq.model_qscales(model), True), qs, rtol=0)


# ---------------------------------------------------------------------------
# trunks and blocks


TRUNKS = {  # arch, input side, exact BN folds
    "resnet26-qat": ("resnet26", 32, True),
    "resnet14-gn-qat": ("resnet14-gn", 64, False),
}


@pytest.mark.parametrize("case", list(TRUNKS))
def test_qat_trunk_forward_and_gradients_match_jax(case):
    """The QAT trunk with the port's calibrated scales on both sides: the
    output in steps of its last scale, the gradients of a random projection
    of it leaf by leaf (the straight-through estimator on activations and
    weights); the frozen stem and layer1 get none."""
    arch, side, exact = TRUNKS[case]
    x = np.random.RandomState(3).randn(2, side, side, 3).astype(np.float32) * 0.5
    jm = JaxResNet(arch=arch, quant="int8_qat")
    variables = random_variables(jm, {"x": x}, seed=4)
    variables = exact_bn(variables) if exact else variables
    pb = {k: variables[k] for k in ("params", "buffers") if k in variables}
    tm = ResNet(arch, quant="int8_qat")
    tm.load_state_dict(resnet_from_jax(variables["params"], variables.get("buffers", {})))
    with torch.inference_mode(), tm.calibrating():
        tm(torch.from_numpy(x))
    qs = resnet_qscales_to_flax({k: v.numpy() for k, v in tm.qscales().items()}, scanned=True)
    ct = np.random.RandomState(5).randn(2, 1, 1, 2048).astype(np.float32)

    def f(params):
        out = jm.apply({**pb, "params": params, "qscales": qs}, x)
        return jnp.sum(out * ct), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(pb["params"])
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(ct)).sum().backward()
    got, want = out.detach().numpy(), np.asarray(want)
    last = (qs["layer4_rest"]["block"]["out_max"][-1] if "layer4_rest" in qs
            else qs["layer4_0"]["out_max"])
    step = float(last) / 127.0
    assert np.abs(got - want).max() <= TRUNK_STEPS * step + 1e-6
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    ref = resnet_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), variables.get("buffers", {}))
    for n, p in tm.named_parameters():
        if n.startswith(("conv1.", "bn1.", "layer1.")):
            assert p.grad is None, n
            continue
        r = ref[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=GRAD_ATOL * float(np.abs(r).max()) + 1e-6, err_msg=n)


GN_BLOCKS = {  # (in channels, planes, stride, downsample): GroupNorm(32) needs planes >= 32
    "tail": (128, 32, 1, False),
    "head-s2": (64, 32, 2, True),
}


@pytest.mark.parametrize("mode", ["int8_static", "int8_qat"])
@pytest.mark.parametrize("case", list(GN_BLOCKS))
def test_groupnorm_block_matches_jax(case, mode):
    """A GroupNorm bottleneck under int8_static (on the int8 stream; its
    dynamic observer twin records the JAX block's maxima) and int8_qat (on
    its float carrier), the JAX scales calibrated on the same input; the
    GroupNorm block never takes K2."""
    cin, planes, stride, downsample = GN_BLOCKS[case]
    rng = np.random.RandomState(7)
    xq = rng.randint(-127, 128, (2, 6, 10, cin)).astype(np.int8)
    sx = np.float32(0.029)
    jblock = JaxBottleneck(planes=planes, stride=stride, downsample=downsample, norm="gn",
                           quant="int8", qin=True, qout=True)
    jx = (jnp.asarray(xq), jnp.float32(sx))
    variables = random_variables(jblock, {"x": jx}, seed=2)
    (_, _), upd = jblock.apply(variables, jx, mutable=["qscales"])
    qs = jax.tree_util.tree_map(np.asarray, upd["qscales"])
    tb = Bottleneck(cin, planes, stride, 1, downsample, observers=True, fused=True,
                    norm="gn").eval()
    assert not tb.fused
    sd = {k.lstrip("."): v for k, v in _bottleneck(variables["params"], {}, "").items()}
    tb.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    bufs = dict(tb.named_buffers())
    with torch.no_grad():
        for k, v in {"conv2.act_max": qs["conv2"]["act_max"],
                     "conv3.act_max": qs["conv3"]["act_max"], "out_max": qs["out_max"]}.items():
            bufs[k].fill_(float(v))
        if mode == "int8_static":
            tb.forward_int8(torch.from_numpy(xq), torch.tensor(sx), torch.float32, "int8",
                            observe=True)  # the observers record the JAX block's maxima
            for k, v in {"conv2.act_max": qs["conv2"]["act_max"],
                         "conv3.act_max": qs["conv3"]["act_max"], "out_max": qs["out_max"]}.items():
                np.testing.assert_allclose(float(bufs[k]), float(v), rtol=STEP_RTOL, err_msg=k)
            want_q, want_s = jblock.clone(quant=mode).apply({**variables, "qscales": qs}, jx)
            got_q, got_s = tb.forward_int8(torch.from_numpy(xq), torch.tensor(sx),
                                           torch.float32, mode)
            np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-5)
            assert_steps(got_q.numpy(), want_q)
        else:
            xf = xq.astype(np.float32) * sx
            want = np.asarray(jblock.clone(quant=mode).apply({**variables, "qscales": qs},
                                                             jnp.asarray(xf)))
            got = tb.forward_qat(torch.from_numpy(xf).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            so = float(qs["out_max"]) / 127.0
            assert_steps(np.round(got.numpy() / so), np.round(want / so))


def test_groupnorm_int8_static_trunk_matches_jax():
    """``resnet14-gn`` under int8_static (``fused_blocks`` asked, K2 not
    taken), with the port's calibrated scales on both sides: within the
    trunk bound of the JAX one. Measured: equal."""
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32) * 0.5
    jm = JaxResNet(arch="resnet14-gn", quant="int8_static")
    variables = random_variables(jm, {"x": x}, seed=4)
    tm = ResNet("resnet14-gn", quant="int8_static", fused_blocks=True)
    tm.load_state_dict(resnet_from_jax(variables["params"], {}))
    with torch.inference_mode():
        with tm.calibrating():
            tm(torch.from_numpy(x))
        got = tm(torch.from_numpy(x)).numpy()
    qs = resnet_qscales_to_flax({k: v.numpy() for k, v in tm.qscales().items()}, scanned=True)
    want = np.asarray(jax.jit(lambda v: jm.apply(v, x))({**variables, "qscales": qs}))
    step = float(qs["layer4_0"]["out_max"]) / 127.0
    assert np.abs(got - want).max() <= TRUNK_STEPS * step + 1e-6
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


# ---------------------------------------------------------------------------
# QAT against int8_static, drift, bfloat16


def test_qat_forward_is_close_to_int8_static(variables):
    """The QAT forward and the int8_static one on the same weights and
    scales: the same rounding grid, one in float convs, one in s8 x s8."""
    cfg_q, model_q, _ = calibrated({**KW, "backbone_quant": "int8_qat"}, variables)
    _, model_s = port_model({**KW, "backbone_quant": "int8_static"}, variables)
    tq.set_model_qscales(model_s, tq.model_qscales(model_q))
    inputs = port_inputs(KW)
    with torch.no_grad():
        out_q, out_s = model_q(**inputs), model_s(**inputs)
    assert np.abs(out_q["pred_boxes"].numpy() - out_s["pred_boxes"].numpy()).max() < \
        QAT_VS_STATIC_ATOL


def test_drift_checker_matches_jax(variables):
    """After the trainable trunk moved (layer2-4 weights scaled by 1.1), the
    drift probe's worst ratio, its leaf and every observed maximum equal the
    JAX package's (op by op); the observers hold the baked scales after. The
    config quantizes the fast pass and the frozen prefix, so the observer
    forward is ``calibration_cfg``'s two-pass one (the JAX calibration's
    forward: this also holds the port's calibration of those passes)."""
    kw = {**KW, **TREES["fast+frozen-int8_static"]}
    cfg, model, baked = calibrated(kw, variables)
    moved = jax.tree_util.tree_map_with_path(
        lambda p, v: v * np.float32(1.1) if any(str(getattr(k, "key", k)).startswith(
            ("layer2", "layer3", "layer4")) for k in p) else v, variables["params"])
    drifted = {**variables, "params": moved}
    _, model = port_model(kw, drifted)
    tq.set_model_qscales(model, qscales_from_jax(baked))
    ratio, leaf, observed = tq.make_drift_checker(cfg)(model, port_inputs(kw))
    assert {k: float(v) for k, v in tq.model_qscales(model).items()} == \
        {k: float(v) for k, v in qscales_from_jax(baked).items()}
    jb = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in jax_model_inputs(jax_batch(kw)).items()}
    with jax.disable_jit():
        jratio, jleaf, jobserved = jq.make_drift_checker(JaxConfig(**kw))(drifted, jb, baked)
    assert ratio > 1.0 and leaf == jleaf
    np.testing.assert_allclose(ratio, jratio, rtol=STEP_RTOL)
    assert_trees_close(qscales_to_flax({k: v.numpy() for k, v in observed.items()}, True),
                       jobserved, rtol=STEP_RTOL)


def test_qat_trunk_bf16_matches_jax():
    """The bfloat16 QAT trunk (float32 weights and scales): at least 90% of
    its outputs equal to the JAX trunk's (op by op) to the bit, all within
    half the JAX trunk's bfloat16-vs-float32 distance. Measured: every
    output equal."""
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32) * 0.5
    jm = JaxResNet(arch="resnet14", quant="int8_qat", dtype=jnp.bfloat16)
    variables = unit_bn(random_variables(jm, {"x": x}, seed=4))
    tm = ResNet("resnet14", quant="int8_qat", dtype=torch.bfloat16)
    tm.load_state_dict(resnet_from_jax(variables["params"], variables["buffers"]))
    with torch.no_grad():
        with tm.calibrating():
            tm(torch.from_numpy(x).float())
        ours = tm(torch.from_numpy(x)).float().numpy()
    qs = resnet_qscales_to_flax({k: v.numpy() for k, v in tm.qscales().items()}, scanned=True)
    with jax.disable_jit():  # under jit, x / s becomes x * (1 / s)
        jb = np.asarray(jm.apply({**variables, "qscales": qs}, x).astype(jnp.float32))
    j32 = np.asarray(jax.jit(lambda v: jm.clone(dtype=jnp.float32).apply(v, x))(
        {**variables, "qscales": qs}))

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    assert (ours == jb).mean() >= 0.9
    assert rms(ours - jb) <= BF16_FRACTION * rms(jb - j32)
