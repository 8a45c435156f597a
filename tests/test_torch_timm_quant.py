"""The timm trunks' int8 paths against the JAX package, on the CPU.

* G1's plain version (``ops/int8_conv.py:grouped_conv2d_int8_plain``, which
  the wrapper runs for a CPU tensor): its int32 conv equals XLA's grouped
  int8 ``conv_general_dilated`` bit for bit (depthwise k3/k5 at stride 1
  and 2, groups of 8 and 16 channels, odd spatial sizes), and with its fold
  an int8_static grouped conv equals the JAX ``BottleneckConv`` bit for
  bit, in bfloat16 and float32;
* calibration (``int8``, dynamic + observe) and the ``int8_static`` trunk on
  the calibrated scales (EfficientNet, RegNetX, RegNetY, ConvNeXt), and ``int8_qat``
  on the JAX scales. The JAX side runs op by op
  (``jax.disable_jit``: under ``jit`` XLA turns each quantizer's ``x / s``
  into ``x * (1 / s)`` and flips int8 roundings, ``tests/test_torch_int8.py``)
  with exact FrozenBN folds (``exact_bn``). One JAX pass serves both: the
  dynamic forward on the calibration input reads the maxima it records, so
  its output is the static forward's. The float ops between the int8 convs
  (the squeeze-excite gates, ConvNeXt's LayerNorms and float convs) sum in
  another order than XLA's, a quantized input one ulp from a rounding
  boundary then flips an int8 step, and the flip moves what follows it. So
  every maximum is held to rtol 5e-2 (the JAX package's own jitted and
  op-by-op calibrations differ by up to 3%) and at least half of them, those
  before any flip, to rtol 1e-4; the outputs to ``tests/test_torch_int8.py``'s
  trunk bound, at most 3 int8 steps of their own scale and correlation above
  0.999 (EfficientNet measured exact). ConvNeXt's random layer
  scales (about N(0, 1)) carry a flip through all 18 blocks: its first stage
  is held as above, its whole trunk's maxima to rtol 5e-2 alone and its
  output by correlation above 0.99 (measured 0.9991); the QAT trunks are held
  as the int8 ones (measured 5e-5 steps on EfficientNet and RegNetX;
  RegNetY through its first two stages, ``QAT_STAGES``);
* the qscales sidecar: the port's tree has the JAX package's structure and
  the same cache key, a sidecar written by either package loads in the
  other;
* a whole ``int8_static`` model (EfficientNet: G1 in every block), on a
  batch whose trunk pass is the trunk tests' two frames: the port's
  ``calibrate_qscales`` tree as above and the outputs to atol 1e-4;
* the STE gradients of ``int8_qat`` reach every quantized conv, the
  depthwise and grouped ones included;
* the training fast pass in ``int8_static``: the trunk's float weights and
  the int8_static trunk's features, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_int8 import exact_bn
from tests.test_torch_model import TINY, make_batch, random_variables
from tests.test_torch_timm import TRUNKS, X, jax_model_variables, jax_trunk, run
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models import quantize as jq
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import (
    params_from_jax,
    qscales_from_jax,
    qscales_to_flax,
    timm_qscales_from_jax,
    trunk_from_jax,
)
from tubedetr_tpu_torch.models import quantize as tq
from tubedetr_tpu_torch.models.resnet import QConv, QLinear
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.ops.int8_conv import (
    grouped_conv2d_int8,
    grouped_conv2d_int8_plain,
    grouped_conv2d_int32,
)

MAXIMA_RTOL, MAXIMA_EXACT_RTOL = 5e-2, 1e-4  # the module docstring says why

# (N, H, W, C, O, k, stride, groups)
G1_CASES = {
    "dw-k3-s1": (2, 9, 11, 24, 24, 3, 1, 24),
    "dw-k3-s2": (2, 9, 11, 24, 24, 3, 2, 24),
    "dw-k5-s1": (1, 13, 7, 40, 40, 5, 1, 40),
    "dw-k5-s2": (1, 13, 7, 40, 40, 5, 2, 40),
    "g8-k3-s1": (2, 7, 10, 32, 32, 3, 1, 4),
    "g16-k3-s2": (1, 11, 9, 48, 48, 3, 2, 3),
    "g16-k3-s1-odd": (1, 5, 3, 64, 64, 3, 1, 4),
}


@pytest.mark.parametrize("case", list(G1_CASES))
def test_grouped_plain_matches_xla_bit_for_bit(case):
    """The exact int32 conv under G1's plain version equals XLA's grouped
    int8 conv; so does the wrapper (on a CPU tensor, the plain version) folded
    by a unit scale into float32, which holds every such sum exactly."""
    n, h, w, c, o, k, stride, groups = G1_CASES[case]
    rng = np.random.RandomState(3)
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    hwio = rng.randint(-127, 128, (k, k, c // groups, o)).astype(np.int8)
    ref = jax.lax.conv_general_dilated(
        xq, hwio, (stride, stride), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
        feature_group_count=groups)
    wq = torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 0, 1, 2).reshape(o, -1)))
    got = grouped_conv2d_int32(torch.from_numpy(xq), wq, k, stride, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    before = grouped_conv2d_int8.launches
    folded = grouped_conv2d_int8(torch.from_numpy(xq), wq, k, stride, groups, torch.ones(o),
                                 torch.float32)
    assert grouped_conv2d_int8.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_array_equal(folded.numpy(), np.asarray(ref).astype(np.float32))


def test_grouped_wrapper_refuses_what_g1_cannot_take():
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w8 = torch.zeros((8, 9), dtype=torch.int8)
    one, f32 = torch.ones(8), torch.float32
    for args, match in (((torch.zeros((8, 9), dtype=torch.int8), 3, 1, 3, one, f32), "groups"),
                        ((torch.zeros((8, 16), dtype=torch.int8), 4, 1, 8, one, f32), "odd"),
                        ((w8, 3, 3, 8, one, f32), "stride"),
                        ((torch.zeros((8, 10), dtype=torch.int8), 3, 1, 8, one, f32), "taps"),
                        ((torch.zeros((8, 9)), 3, 1, 8, one, f32), "int8"),
                        ((w8, 3, 1, 8, one, torch.float16), "bfloat16 or float32"),
                        ((w8, 3, 1, 8, one.double(), f32), "float32 \\(8,\\) scale"),
                        ((w8, 3, 1, 8, torch.ones(4), f32), "float32 \\(8,\\) scale"),
                        ((w8, 3, 1, 8, torch.ones(1, 8), f32), "float32 \\(8,\\) scale")):
        with pytest.raises(ValueError, match=match):
            grouped_conv2d_int8(xq, *args)
        if match != "int8":
            with pytest.raises(ValueError, match=match):
                grouped_conv2d_int8_plain(xq, *args)


# (N, H, W, C, k, stride, groups): EfficientNet's depthwise k5 s2 and a
# 16-wide RegNet group, tiny
FOLD_CASES = {"dw-k5-s2": (1, 9, 7, 24, 5, 2, 24), "g16-k3-s1": (2, 5, 6, 32, 3, 1, 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_folded_grouped_conv_matches_jax_int8_static(case, dtype):
    """An int8_static grouped ``QConv`` (its quantize, then G1's folded plain
    version) equals the JAX ``BottleneckConv`` bit for bit, op by op."""
    from tubedetr_tpu.models.resnet import BottleneckConv

    n, h, w, c, k, stride, groups = FOLD_CASES[case]
    rng = np.random.RandomState(11)
    x = rng.randn(n, h, w, c).astype(np.float32)
    kernel = (rng.randn(k, k, c // groups, c) * 0.2).astype(np.float32)
    act_max = np.float32(np.abs(x).max() * 0.8)  # some inputs clip
    jm = BottleneckConv(c, kernel_size=k, stride=stride, groups=groups, quant="int8_static",
                        dtype=getattr(jnp, dtype))
    with jax.disable_jit():
        ref = np.asarray(jm.apply({"params": {"kernel": kernel},
                                   "qscales": {"act_max": jnp.asarray(act_max)}}, x))
    conv = QConv(c, c, k, stride, groups, observer=True, dtype=getattr(torch, dtype))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        conv.act_max.fill_(float(act_max))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), "int8_static").permute(0, 2, 3, 1)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


def jax_int8(arch, dtype=jnp.float32, stages=None):
    """(variables, the JAX qscales tree, the JAX int8 output) of one op-by-op
    dynamic-observer forward of ``arch``'s trunk on ``X`` (FrozenBN folds
    exact, ``exact_bn``)."""
    kw = {} if stages is None else {"stages": stages}
    jm = jax_trunk(arch, quant="int8", dtype=dtype, **kw)
    variables = exact_bn(random_variables(jm, {"x": X}, seed=1))
    base = {k: v for k, v in variables.items() if k != "qscales"}
    with jax.disable_jit():
        out, upd = jm.apply(base, X, mutable=["qscales"])
    return base, jax.tree_util.tree_map(np.asarray, upd["qscales"]), np.asarray(out)


def port_trunk_q(arch, variables, quant, dtype=torch.float32, stages=None):
    kw = {} if stages is None else {"stages": stages}
    tm = TRUNKS[arch][1](arch, quant=quant, dtype=dtype, **kw).eval()
    tm.load_state_dict(trunk_from_jax(variables["params"], variables.get("buffers", {})),
                       strict=stages is None)
    return tm


def port_calibrated(arch, variables, dtype=torch.float32, stages=None):
    tm = port_trunk_q(arch, variables, "int8_static", dtype, stages)
    with torch.no_grad(), tm.calibrating("int8"):
        run(tm)
    return tm


def assert_maxima(got: dict, want: dict, half_exact: bool = True):
    """Every maximum within ``MAXIMA_RTOL`` and, with ``half_exact``, at
    least half within ``MAXIMA_EXACT_RTOL`` (``got`` may hold more: a
    truncated trunk's)."""
    assert want and set(want) <= set(got)
    rel = np.array([abs(float(got[k]) / float(want[k]) - 1) for k in want])
    assert rel.max() <= MAXIMA_RTOL, rel.max()
    assert not half_exact or np.median(rel) <= MAXIMA_EXACT_RTOL, np.median(rel)


def assert_steps(got, want, steps=3, corr=0.999):
    """At most ``steps`` int8 steps of the output's own scale (max |want| /
    127) apart, correlation above ``corr``: ``tests/test_torch_int8.py``'s
    trunk bound."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= steps * np.abs(want).max() / 127, np.abs(got - want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > corr


def check_qat(arch, variables, qs, ref_stages=None):
    """The port's int8_qat trunk on the JAX scales against the JAX one (op
    by op), and its STE gradients on every quantized conv."""
    kw = {} if ref_stages is None else {"stages": ref_stages}
    with jax.disable_jit():
        ref = np.asarray(jax_trunk(arch, quant="int8_qat", **kw).apply({**variables, "qscales": qs}, X))
    tm = port_trunk_q(arch, variables, "int8_qat", stages=ref_stages)
    tm.load_qscales({**tm.qscales(), **timm_qscales_from_jax(qs)})
    quantized = tm.int8_convs()
    assert quantized == [m for m in tm.modules() if isinstance(m, (QConv, QLinear))
                         and hasattr(m, "act_max")]
    ran = []  # the convs the (truncated) trunk runs
    hooks = [m.register_forward_hook(lambda mod, *_: ran.append(mod)) for m in quantized]
    out = tm(torch.from_numpy(X))
    for h in hooks:
        h.remove()
    assert_steps(out.detach().numpy(), ref)
    out.square().sum().backward()
    assert ran and len(set(ran)) == len(ran) and set(ran) <= set(quantized)
    assert ref_stages is not None or len(ran) == len(quantized)
    for m in ran:
        assert m.weight.grad is not None and float(m.weight.grad.abs().max()) > 0
    return [m for m in ran if isinstance(m, QConv) and m.groups > 1]


# the stages a QAT trunk is held through (all by default): in RegNetY-004's
# third stage one input of s3.b1.conv2 lies 7e-6 of a step from a rounding
# boundary, float32 noise (2e-7 relative on every conv output before it)
# flips it, and the flip moves the trunk's output by up to 4.1 steps
# (correlation 0.99933); its first two stages agree to 2e-5 steps
QAT_STAGES = {"regnety_004": 2}


@pytest.mark.parametrize("arch", ["efficientnet_b0", "regnetx_002", "regnety_004"])
def test_int8_and_qat_trunks_match_jax(arch, tmp_path):
    """Calibration and the int8_static trunk, the QAT trunk, the sidecar
    both ways, on one set of variables; the JAX side op by op (its
    primitives compile once)."""
    variables, qs, ref = jax_int8(arch)
    tm = port_calibrated(arch, variables)
    assert len(tm.qscales()) == len(timm_qscales_from_jax(qs)) == len(tm.int8_convs())
    assert_maxima(tm.qscales(), timm_qscales_from_jax(qs))
    assert_steps(run(tm).numpy(), ref)
    # grouped convs among those trained
    assert check_qat(arch, variables, qs, ref_stages=QAT_STAGES.get(arch))
    check_sidecars(arch, qs, tmp_path)


def test_convnext_int8_and_qat_match_jax(tmp_path):
    """ConvNeXt (``mlp.fc1``/``fc2`` alone quantized): the first stage at
    the tight bounds, the whole trunk at the loose ones (module docstring)."""
    arch = "convnext_tiny"
    v1, qs1, ref1 = jax_int8(arch, stages=1)
    tm1 = port_calibrated(arch, v1, stages=1)
    assert_maxima(tm1.qscales(), timm_qscales_from_jax(qs1))
    assert_steps(run(tm1).numpy(), ref1)
    assert not check_qat(arch, v1, qs1, ref_stages=1)  # no grouped conv is quantized
    variables, qs, ref = jax_int8(arch)
    tm = port_calibrated(arch, variables)
    assert_maxima(tm.qscales(), timm_qscales_from_jax(qs), half_exact=False)
    assert np.corrcoef(run(tm).numpy().ravel(), ref.ravel())[0, 1] > 0.99
    check_sidecars(arch, qs, tmp_path)


def check_sidecars(arch, qs, tmp_path):
    """The port's tree is the JAX tree (structure and values), the cache
    keys are one string, and a sidecar written by either package loads in
    the other."""
    flat = qscales_from_jax({"backbone": qs})
    tree = qscales_to_flax(flat, scanned=True)
    assert jax.tree_util.tree_structure(tree["backbone"]) == jax.tree_util.tree_structure(qs)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree["backbone"], qs)
    kw = dict(TINY, backbone=f"timm_{arch}", backbone_quant="int8_static")
    assert tq.qscales_cache_key(TubeDETRConfig(**kw), "w") == jq.qscales_cache_key(
        JaxConfig(**kw), "w")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jq.save_qscales(jpath, {"backbone": qs})
    model = build_model(TubeDETRConfig(**kw), device="cpu")
    tq.set_model_qscales(model, qscales_from_jax(tq.load_qscales(jpath)))
    got = tq.model_qscales(model)
    assert set(got) == set(flat) and all(float(got[k]) == float(flat[k]) for k in flat)
    tq.save_qscales(tpath, qscales_to_flax(got, scanned=False))
    jax.tree_util.tree_map(np.testing.assert_array_equal, jq.load_qscales(tpath)["backbone"], qs)


# B=1, T=2, stride 2: the shared trunk pass runs the trunk tests' 2 frames of 64x64
SMALL = dict(TINY, video_max_len=2, video_max_len_train=2, stride=2)


@pytest.mark.parametrize("arch", ["efficientnet_b0"])
def test_int8_static_whole_model_matches_jax(arch):
    """The port calibrates a whole int8_static model (``calibrate_qscales``)
    and serves from its scales; the JAX model's dynamic-observer forward on
    the same batch gives its scales and, reading the maxima it records,
    the static outputs."""
    kw = dict(SMALL, backbone=f"timm_{arch}", backbone_quant="int8_static")
    batch = make_batch(kw, [2])
    jmodel, jb, variables = jax_model_variables(dict(kw, backbone_quant="int8"), batch)
    base = exact_bn({k: v for k, v in variables.items() if k != "qscales"})
    with jax.disable_jit():
        ref, upd = jmodel.apply(base, **jb, mutable=["qscales"])
    cfg = TubeDETRConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(base, cfg))
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    tree = tq.calibrate_qscales(cfg, model, inputs)
    want = jax.tree_util.tree_map(np.asarray, upd["qscales"])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    assert_maxima(qscales_from_jax(tree), qscales_from_jax(want))
    with torch.no_grad():
        out = model(**inputs)
    for k in ("pred_boxes", "pred_sted"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


def test_fast_pass_int8_static_equals_the_static_trunk():
    """A float EfficientNet model with ``backbone_quant_fast="int8_static"``:
    its fast pass is the int8_static trunk on the same weights and scales,
    bit for bit, and the slow pass stays float."""
    arch = "efficientnet_b0"
    kw = dict(TINY, backbone=f"timm_{arch}", backbone_quant_fast="int8_static")
    cfg = TubeDETRConfig(**kw)
    model = build_model(cfg, device="cpu")
    body = model.backbone[0].body
    assert body.observers == "all" and body.quant == "none"
    static = TRUNKS[arch][1](arch, quant="int8_static").eval()
    sd = {k[len("backbone.0.body."):]: v for k, v in model.state_dict().items()
          if k.startswith("backbone.0.body.")}
    static.load_state_dict(sd)
    with torch.no_grad(), static.calibrating("int8"):
        run(static)
    body.load_qscales(static.qscales())
    frames = torch.from_numpy(X)
    with torch.no_grad():
        fast = model.backbone_feats(frames, **model.pass_modes(True))
        slow = model.backbone_feats(frames, **model.pass_modes(False))
        assert torch.equal(fast, static(frames))
        assert torch.equal(slow, body(frames, quant="none"))
    assert not torch.equal(fast, slow)
