"""The port's int8 backbone path against the JAX package, on the CPU.

Same seeded numpy weights and inputs on both sides (JAX variables moved with
``params_from_jax`` / ``resnet_from_jax``, calibrated maxima with
``qscales_from_jax``):

* unfused int8 ``Bottleneck`` blocks on the (int8, scale) stream, in the
  ``int8`` (dynamic + observe) and ``int8_static`` modes, with and without
  downsample, stride 1 and 2, in float32 and bfloat16: at most 1 int8 step
  apart and at least 99% of the elements equal, the bound of
  ``tests/test_fused_bottleneck.py`` (XLA may keep a bf16 rounding fused in
  f32 where PyTorch rounds, so a value on a quantization boundary can flip);
* whole int8_static ResNets (resnet14, resnet26 DC5), fused and unfused,
  from the scanned and the unrolled JAX layouts: at most 3 steps of the last
  block's output scale and correlation above 0.999;
* calibration: every recorded maximum to rtol 1e-4;
* qscales sidecars: written by one package, read by the other; the cache key
  is the same string;
* the full ``TubeDETR`` forward and the ``GroundingPipeline``, int8_static +
  fused: boxes and sted logits to atol 1e-4, the segment identical.

An int8 network amplifies one-ulp float differences: a value one ulp from a
rounding boundary flips a whole int8 step, and the flip moves what follows
it, maxima included. So where a comparison is tight, both sides compute the
same float operations: the BN folds are made exact (``exact_bn``), the JAX
side runs op by op (``jax.disable_jit``: under ``jit`` XLA contracts and
reorders float ops, and its own jitted calibration differed from its
op-by-op one by up to 3% on a late maximum) and its fused tails go through
the package's plain emulation of K2 (``jax_k2_reference``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import make_batch, random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models import quantize as jq
from tubedetr_tpu.models.resnet import Bottleneck as JaxBottleneck
from tubedetr_tpu.models.resnet import ResNet as JaxResNet
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import (
    _bottleneck,
    params_from_jax,
    qscales_from_jax,
    qscales_to_flax,
    resnet_from_jax,
    resnet_qscales_from_jax,
    resnet_qscales_to_flax,
)
from tubedetr_tpu_torch.models import quantize as tq
from tubedetr_tpu_torch.models.resnet import Bottleneck, ResNet
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def exact_bn(variables, seed=9):
    """``variables`` with every FrozenBN ``running_var`` set so that
    ``running_var + 1e-5`` is 1/4, 1 or 4 in f32: then both packages fold
    the same BN scale. XLA's ``rsqrt`` is not correctly rounded and differs
    from ``torch.rsqrt`` by one ulp on about a third of inputs; a one-ulp
    scale flips int8 roundings that sit on a boundary, and each flip moves
    the activation maxima downstream."""
    eps = np.float32(1e-5)
    exact = np.array([0.25, 1.0, 4.0], np.float32)
    choices = exact - eps
    assert ((choices + eps) == exact).all()
    rng = np.random.RandomState(seed)

    def fix(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name != "running_var":
            return leaf
        return rng.choice(choices, size=np.shape(leaf)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fix, variables)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(leaves(v, key) if isinstance(v, dict) else {key: np.asarray(v, np.float32)})
    return out


def assert_trees_close(got, want, rtol):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def assert_steps(got_q, want_q, max_step=1, min_equal=0.99):
    diff = np.abs(np.asarray(got_q, np.int32) - np.asarray(want_q, np.int32))
    assert diff.max() <= max_step, diff.max()
    assert (diff == 0).mean() >= min_equal, (diff == 0).mean()


# ---------------------------------------------------------------------------
# unfused blocks on the int8 stream

BLOCKS = {  # (in channels, planes, stride, downsample)
    "tail": (64, 16, 1, False),
    "head-s1": (32, 16, 1, True),
    "head-s2": (32, 16, 2, True),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_unfused_block_matches_jax(case, mode, dtype):
    cin, planes, stride, downsample = BLOCKS[case]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(7)
    xq = rng.randint(-127, 128, (2, 6, 10, cin)).astype(np.int8)
    sx = np.float32(0.029)
    jblock = JaxBottleneck(planes=planes, stride=stride, downsample=downsample,
                           quant="int8", qin=True, qout=True, dtype=jdt)
    jx = (jnp.asarray(xq), jnp.float32(sx))
    variables = random_variables(jblock, {"x": jx}, seed=2)
    (_, _), upd = jblock.apply(
        {k: variables[k] for k in ("params", "buffers")}, jx, mutable=["qscales"]
    )  # calibrate on the same input
    qs = jax.tree_util.tree_map(np.asarray, upd["qscales"])
    if mode == "int8_static":
        jblock = jblock.clone(quant="int8_static")
        want_q, want_s = jblock.apply({**variables, "qscales": qs}, jx)
    else:
        (want_q, want_s), _ = jblock.apply(
            {k: variables[k] for k in ("params", "buffers")}, jx, mutable=["qscales"]
        )

    tb = Bottleneck(cin, planes, stride, 1, downsample, quant=mode).eval()
    sd = {k.lstrip("."): v for k, v in _bottleneck(variables["params"], variables["buffers"], "").items()}
    tb.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    names = {"conv2.act_max": qs["conv2"]["act_max"], "conv3.act_max": qs["conv3"]["act_max"],
             "out_max": qs["out_max"]}
    bufs = dict(tb.named_buffers())
    with torch.no_grad():
        if mode == "int8_static":
            for k, v in names.items():
                bufs[k].copy_(torch.tensor(float(v)))
        got_q, got_s = tb.forward_int8(torch.from_numpy(xq), torch.tensor(sx), tdt, mode,
                                       observe=mode == "int8")
    assert got_q.dtype == torch.int8 and got_q.shape == want_q.shape
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-5)
    assert_steps(got_q.numpy(), want_q)
    if mode == "int8":  # the observers recorded what the JAX ones did
        for k, v in names.items():
            np.testing.assert_allclose(float(bufs[k]), float(v), rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# whole int8_static trunks

TRUNKS = {  # (arch, DC5, scanned JAX layout, fused tails)
    "resnet14-scanned": ("resnet14", False, True, False),
    "resnet26-dc5-scanned-unfused": ("resnet26", True, True, False),
    "resnet26-dc5-unrolled-unfused": ("resnet26", True, False, False),
    "resnet26-dc5-scanned-fused": ("resnet26", True, True, True),
    "resnet26-dc5-unrolled-fused": ("resnet26", True, False, True),
}


@pytest.mark.parametrize("case", list(TRUNKS))
def test_int8_static_trunk_matches_jax(case):
    """Port calibration equals the JAX calibration (rtol 1e-4 on every
    leaf, both run op by op with the same BN folds, see ``exact_bn``); with
    the JAX scales mapped in, the static trunk is within 3 steps of the last
    ``out_max / 127`` of the JAX trunk (fused tails on both sides where
    ``fused``; the JAX Pallas kernel in interpret mode). The input is the
    shape of the JAX package's own fused-trunk test. In the scanned layout
    XLA compiles the scan body, K2's scale fold included, and may rewrite
    its f32 divisions: on a 32x48 input that alone put the JAX fused trunk
    4 steps from its own unfused twin, while the port's fused and unfused
    trunks and the JAX unfused one agreed exactly."""
    arch, dc5, scan, fused = TRUNKS[case]
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32) * 0.5
    jm = JaxResNet(arch=arch, dilation=dc5, quant="int8_static", scan_blocks=scan,
                   fused_blocks=fused)
    variables = exact_bn(random_variables(jm, {"x": x}, seed=4))
    pb = {k: variables[k] for k in ("params", "buffers")}
    _, upd = jm.clone(quant="int8").apply(pb, x, mutable=["qscales"])
    qs = jax.tree_util.tree_map(np.asarray, upd["qscales"])
    want = np.asarray(jm.apply({**pb, "qscales": qs}, x))

    tm = ResNet(arch, dilation=dc5, quant="int8_static", fused_blocks=fused).eval()
    tm.load_state_dict(resnet_from_jax(variables["params"], variables["buffers"]))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        with tm.calibrating():
            tm(xt)
        assert_trees_close(resnet_qscales_to_flax(
            {k: v.numpy() for k, v in tm.qscales().items()}, scanned=scan), qs, rtol=1e-4)
        tm.load_qscales(resnet_qscales_from_jax(qs))
        got = tm(xt).numpy()
    assert got.shape == want.shape == (2, *ResNet.feature_hw(32, 32, dc5), 2048)
    last = qs["layer4_rest"]["block"]["out_max"][-1] if "layer4_rest" in qs else (
        qs[max(k for k in qs if k.startswith("layer4_"))]["out_max"])
    step = float(last) / 127.0
    assert np.abs(got - want).max() <= 3 * step + 1e-6
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_float_trunk_has_no_observers_and_reference_keys():
    """The observers are non-persistent: the int8 trunk's ``state_dict`` has
    the float trunk's keys, so reference checkpoints load the same way."""
    f = ResNet("resnet26")
    q = ResNet("resnet26", quant="int8_static", fused_blocks=True)
    assert set(f.state_dict()) == set(q.state_dict())
    assert f.qscales() == {} and len(q.qscales()) == 1 + 8 * 3
    with pytest.raises(ValueError, match="observers"):
        with f.calibrating():
            pass


# ---------------------------------------------------------------------------
# full model, calibration, sidecars, pipeline


@pytest.fixture
def jax_k2_reference(monkeypatch):
    """The JAX fused tails through ``fused_bottleneck_reference``, the
    package's plain emulation of K2, in place of the interpreted Pallas
    kernel: XLA compiles the interpreted kernel body and contracts its
    ``acc * a + b`` epilogues into FMAs, which put 10 of the 2.6M int8
    outputs of a resnet26 stage-1 tail at 128x160 one step from the
    emulation (the port equals the emulation there;
    ``test_torch_fused_bottleneck.py``)."""
    from tubedetr_tpu.ops import fused_bottleneck as jfb

    def reference(xq, sx, kernels, norms, act_max2, act_max3, out_max, dilation=1, **_):
        return jfb.fused_bottleneck_reference(xq, sx, kernels, norms, act_max2, act_max3,
                                              out_max, dilation=dilation)

    monkeypatch.setattr(jfb, "fused_bottleneck_block", reference)


TINY = dict(
    backbone="resnet26", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
    dim_feedforward=64, video_max_len=6, video_max_len_train=6, stride=2,
    resolution=128, max_text_len=12, text_vocab_size=64, text_hidden_size=48,
    text_layers=1, text_heads=4, text_ffn=64, text_max_positions=20,
    guided_attn=False, sted=True, aux_loss=False, dropout=0.0,
    compute_dtype="float32", backbone_quant="int8_static", fused_bottleneck=True,
)
MODEL_ATOL = 1e-4


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_full_model_and_calibration_match_jax(scan, jax_k2_reference):
    """The port's ``calibrate_qscales`` on the full model equals the JAX
    package's to rtol 1e-4 (the sidecar layout per ``scan_backbone_blocks``);
    with the JAX scales, boxes, sted logits and attention weights agree to
    atol 1e-4 (measured: 3e-6)."""
    kw = {**TINY, "scan_backbone_blocks": scan}
    batch = make_batch(kw, [6, 4])
    jb = {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}
    jcfg = JaxConfig(**kw)
    jmodel = jax_build_model(jcfg)
    variables = exact_bn(random_variables(jmodel, jb, seed=6))
    with jax.disable_jit():
        qs = jq.calibrate_qscales(jcfg, variables, jb)
        ref = jmodel.apply({**variables, "qscales": qs}, **jb)

    cfg = TubeDETRConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert_trees_close(tq.calibrate_qscales(cfg, model, inputs), qs, rtol=1e-4)
    tq.set_model_qscales(model, qscales_from_jax(qs))
    before = fused_bottleneck_block.launches
    with torch.inference_mode():
        out = model(**inputs)
    assert fused_bottleneck_block.launches == before  # CPU: the plain version
    for k in ("pred_boxes", "pred_sted", "weights"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=MODEL_ATOL, err_msg=k)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_sidecars_interchange(tmp_path, scan):
    """A sidecar the JAX package writes loads into the port and the other
    way round; ``qscales_cache_key`` is the same string for the same
    config and tags."""
    for extra, tag, data in ((dict(), "fabricate-seed0", ""),
                             (dict(fused_bottleneck=False, dilation=True), "/ck.pth:1:2", "vidstg"),
                             (dict(compute_dtype="bfloat16", resolution=352), "", "")):
        kw = {**TINY, "scan_backbone_blocks": scan, **extra}
        assert tq.qscales_cache_key(TubeDETRConfig(**kw), tag, data) == \
            jq.qscales_cache_key(JaxConfig(**kw), tag, data)
        assert tq.weights_tag_for(TubeDETRConfig(**kw, load="x.pth")) == \
            jq.weights_tag_for(JaxConfig(**kw, load="x.pth"))

    cfg = TubeDETRConfig(**{**TINY, "scan_backbone_blocks": scan})
    model = build_model(cfg, device="cpu")
    own = {k: np.float32(i + 0.5) for i, k in enumerate(sorted(tq.model_qscales(model)))}
    tree = qscales_to_flax(own, scanned=scan)
    assert ("layer1_rest" in tree["backbone"]) == scan

    jpath = str(tmp_path / "from_jax.npz")
    jq.save_qscales(jpath, tree)
    tq.set_model_qscales(model, qscales_from_jax(tq.load_qscales(jpath)))
    assert {k: float(v) for k, v in tq.model_qscales(model).items()} == \
        {k: float(v) for k, v in own.items()}

    tpath = str(tmp_path / "from_port.npz")
    tq.save_qscales(tpath, qscales_to_flax(tq.model_qscales(model), scanned=scan))
    assert_trees_close(jq.load_qscales(tpath), tree, rtol=0)


def test_get_or_calibrate_writes_then_reads_the_sidecar(tmp_path):
    cfg = TubeDETRConfig(**{**TINY, "video_max_len": 4, "video_max_len_train": 4})
    model = build_model(cfg, device="cpu")
    batch = make_batch({**TINY, "video_max_len": 4}, [4])
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    qs, source = tq.get_or_calibrate_qscales(cfg, model, inputs, str(tmp_path), "w")
    assert source == "calibrated"
    assert (tmp_path / f"qscales-{tq.qscales_cache_key(cfg, 'w')}.npz").exists()
    with torch.no_grad():
        for buf in model.backbone[0].body.qscales().values():
            buf.zero_()
    qs2, source = tq.get_or_calibrate_qscales(cfg, model, inputs, str(tmp_path), "w")
    assert source == "cache"
    assert_trees_close(qs2, qs, rtol=0)
    assert_trees_close(qscales_to_flax(tq.model_qscales(model), scanned=True), qs, rtol=0)
    _, source = tq.get_or_calibrate_qscales(cfg, model, inputs, str(tmp_path), "w", force=True)
    assert source == "calibrated"


def test_config_accepts_the_int8_backbone():
    for kw in (dict(backbone_quant="int8_static", fused_bottleneck=True),
               dict(backbone_quant="int8"), dict(backbone_quant="int8_static")):
        TubeDETRConfig(**kw).validate()
    with pytest.raises(ValueError, match="fused_bottleneck"):
        TubeDETRConfig(fused_bottleneck=True).validate()
    with pytest.raises(ValueError, match="backbone_quant"):
        TubeDETRConfig(backbone_quant="int4").validate()


PIPE_KW = dict(
    backbone="resnet26", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
    dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
    resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
    text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
    fast=True, guided_attn=False, sted=True, aux_loss=False, dropout=0.0,
    backbone_quant="int8_static", fused_bottleneck=True, scan_backbone_blocks=False,
)


def test_pipeline_int8_matches_jax(tmp_path, jax_k2_reference):
    """Both pipelines calibrate on the first request (K1 in bf16 for a
    quantized backbone, on both sides), then serve it: the scales agree to
    rtol 1e-4, the segment is the same and the boxes, normalized by the frame
    size, agree to atol 1e-4 (measured: 1.3e-6). The clip is 128x160, which
    resolution 128 keeps: the resize is the identity, so both sides get the
    same bf16 frames (two f32 resize contractions summed in other orders
    round a few frames' pixels to neighbouring bf16 values, and the int8
    backbone turns those into flipped steps)."""
    from tubedetr_tpu.apps.pipeline import GroundingPipeline as JaxPipeline
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize

    jp = JaxPipeline(JaxConfig(**PIPE_KW))
    variables = exact_bn(random_variables(jp.model, jp._example_batch(), seed=5))
    jp.variables = jax.device_put(variables)
    cfg = TubeDETRConfig(**PIPE_KW)
    tp = GroundingPipeline(cfg, device="cpu")
    tp.model.load_state_dict(params_from_jax(variables, cfg))
    assert tp.frames_dtype == torch.bfloat16 and tp._needs_calibration

    t, h, w = 7, 128, 160
    path = str(tmp_path / "clip.npy")
    np.save(path, np.random.RandomState(t).randint(0, 256, (t, h, w, 3), dtype=np.uint8))
    with jax.disable_jit():  # op by op, as the port runs (see the full-model test)
        ref = jp.ground(path, "a man in a red shirt", render=False)
    sample, _ = tp.prepare(path, "x", -1, -1, "v")
    assert sample.frames.dtype == torch.bfloat16
    out = tp.ground(path, "a man in a red shirt", render=False)
    assert not tp._needs_calibration
    assert_trees_close(qscales_to_flax(tq.model_qscales(tp.model), scanned=False),
                       jp.variables["qscales"], rtol=1e-4)
    assert out["sted"] == ref["sted"]
    size = np.array([w, h, w, h], np.float64)
    np.testing.assert_allclose(np.asarray(out["boxes"]) / size,
                               np.asarray(ref["boxes"]) / size, atol=1e-4)
    assert resize_normalize.launches == 0  # CPU frames: K1's plain version


def test_pipeline_loads_sidecar_and_recalibrates_on_reload(tmp_path, monkeypatch):
    """With ``qscales_dir`` the first request writes the sidecar; a new
    pipeline on the same config and weights serves its first request from
    it without calibrating; ``reload`` of a checkpoint recalibrates on the
    next request."""
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline

    cfg = TubeDETRConfig(**{**PIPE_KW, "backbone": "resnet14", "qscales_dir": str(tmp_path / "q")})
    path = str(tmp_path / "clip.npy")
    np.save(path, np.random.RandomState(1).randint(0, 256, (5, 48, 64, 3), dtype=np.uint8))
    a = GroundingPipeline(cfg, device="cpu")
    first = a.ground(path, "a dog", render=False)
    assert not a._needs_calibration and len(list((tmp_path / "q").iterdir())) == 1
    b = GroundingPipeline(cfg, device="cpu")
    calibrate = tq.calibrate_qscales

    def refuse(*args):
        raise AssertionError("calibrated although the sidecar was there")

    monkeypatch.setattr(tq, "calibrate_qscales", refuse)
    assert b.ground(path, "a dog", render=False) == first
    assert not b._needs_calibration
    monkeypatch.setattr(tq, "calibrate_qscales", calibrate)

    ck = str(tmp_path / "checkpoint.pth")
    torch.save({"model": b.model.state_dict()}, ck)
    b.reload(ck)
    assert b._needs_calibration
    b.ground(path, "a dog", render=False)
    assert not b._needs_calibration and len(list((tmp_path / "q").iterdir())) == 2
