"""The port's timm trunks (EfficientNet, RegNet, ConvNeXt) against the JAX package, float paths.

Same numpy-seeded variables on both sides (``random_variables``: every leaf
random, the FrozenBN statistics and ConvNeXt's layer scale included),
moved with ``params_from_jax``; 64x64 frames, N = 2, the archs of the JAX
package's own timm tests (``efficientnet_b0``, ``regnetx_002``,
``regnety_004``, ``convnext_tiny``).

* the arch tables: ``arch_config``, ``stage_plan``, ``feature_channels`` of
  every name in the three tables;
* each trunk in float32 at atol 1e-4 (``tests/test_torch_resnet.py``'s);
* each trunk in bfloat16. EfficientNet and RegNet compute their float convs
  in float32 in the JAX package (flax ``nn.Conv`` without ``dtype`` promotes
  the bfloat16 input to its float32 kernel; only the frames and the FrozenBN
  folds are rounded), so they are held at the float32 atol. ConvNeXt's
  LayerNorms round their outputs to bfloat16, and a float32 value one ulp
  apart on the two sides can round to neighbouring bfloat16 values; the
  depthwise 7x7 convs spread each flip over its neighbours and the random
  layer scales (about N(0, 1)) carry it through 18 blocks. ConvNeXt is held
  to a fraction of the JAX package's own bfloat16-vs-float32 distance on the
  same input: 0.5 after its first stage (measured 0.29), 0.9 for the whole
  trunk (measured 0.79);
* ``stages=N`` truncation: the shapes of the JAX trunk's;
* the round trip JAX -> ``params_from_jax`` -> the JAX package's
  ``convert_tubedetr`` equals the JAX variables exactly;
* each trunk loads the JAX tests' timm-named torch twins (``_TorchEffNet``,
  ``_TorchRegNet``, ``_TorchConvNeXt``; the BatchNorms' ``num_batches_tracked``
  dropped, as the reference's ``replace_bn`` does) with ``strict=True`` and
  equals their output at the twins' atol 2e-4;
* a whole ``TubeDETR`` with each family at the tiny config, forward at
  ``tests/test_torch_model.py``'s atol 2e-4;
* ``validate()`` accepts and refuses what the JAX package does, and the
  trainable set equals the non-``frozen`` leaves of JAX ``label_params``;
* one dropout-free train step per family against the JAX step (SGD, no
  clip, every LR 1, EMA: the first update is the gradient, so one compile
  of the JAX step gives its gradients leaf by leaf), with
  ``tests/test_torch_train.py``'s loss and gradient bounds;
* ``load_pretrained`` takes a timm checkpoint and refuses one of another
  trunk family; the train CLI trains, resumes, evaluates int8_static and
  reloads a RegNetX model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import TINY, make_batch, random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.interop.torch_convert import convert_tubedetr
from tubedetr_tpu.models import convnext as jconvnext
from tubedetr_tpu.models import efficientnet as jeffnet
from tubedetr_tpu.models import regnet as jregnet
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.train.optim import label_params as jax_label_params
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax, trunk_from_jax
from tubedetr_tpu_torch.models import convnext, efficientnet, regnet
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.train.optim import label_params

X = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
ATOL = 1e-4
# arch -> (JAX trunk class, port trunk class)
TRUNKS = {
    "efficientnet_b0": (jeffnet.EfficientNet, efficientnet.EfficientNet),
    "regnetx_002": (jregnet.RegNet, regnet.RegNet),
    "regnety_004": (jregnet.RegNet, regnet.RegNet),
    "convnext_tiny": (jconvnext.ConvNeXt, convnext.ConvNeXt),
}
# one arch a family, for the whole-model cases
FAMILIES = {"efficientnet": "efficientnet_b0", "regnet": "regnetx_002",
            "convnext": "convnext_tiny"}
ALL_NAMES = (sorted(efficientnet.VARIANTS) + sorted(regnet.REGNET_CFGS)
             + sorted(convnext.CONVNEXT_CFGS))


def jax_trunk(arch, **kw):
    return TRUNKS[arch][0](arch=arch, **kw)


def port_trunk(arch, variables, **kw):
    """The port's trunk of ``arch`` holding the JAX ``variables``."""
    tm = TRUNKS[arch][1](arch, **kw).eval()
    tm.load_state_dict(trunk_from_jax(variables["params"], variables.get("buffers", {})),
                       strict=kw.get("stages") is None)
    return tm


def run(tm, x=X):
    with torch.no_grad():
        return tm(torch.from_numpy(x))


def test_arch_tables_equal_jax():
    for name in jeffnet._VARIANTS:
        assert efficientnet.arch_config(name) == jeffnet.arch_config(name), name
        assert efficientnet.feature_channels(name) == jeffnet.feature_channels(name), name
    for name in jregnet._REGNET_CFGS:
        assert regnet.stage_plan(name) == jregnet.stage_plan(name), name
        assert regnet.feature_channels(name) == jregnet.feature_channels(name), name
    for name in jconvnext._CONVNEXT_CFGS:
        assert convnext.arch_config(name) == jconvnext.arch_config(name), name
        assert convnext.feature_channels(name) == jconvnext.feature_channels(name), name
    assert len(ALL_NAMES) == 19
    assert set(ALL_NAMES) == set(jeffnet._VARIANTS) | set(jregnet._REGNET_CFGS) | set(
        jconvnext._CONVNEXT_CFGS)


@pytest.mark.parametrize("arch", list(TRUNKS))
def test_trunk_matches_jax_f32_and_bf16(arch):
    jm = jax_trunk(arch)
    variables = random_variables(jm, {"x": X}, seed=1)
    ref = np.asarray(jax.jit(jm.apply)(variables, X))
    out = run(port_trunk(arch, variables))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    ref16 = jax.jit(jax_trunk(arch, dtype=jnp.bfloat16).apply)(variables, X)
    out16 = run(port_trunk(arch, variables, dtype=torch.bfloat16))
    assert ref16.dtype == jnp.float32 and out16.dtype == torch.float32  # float32 convs last
    ref16 = np.asarray(ref16)
    diff = np.abs(out16.numpy() - ref16).max()
    if arch.startswith("convnext"):
        assert diff <= 0.9 * np.abs(ref16 - ref).max(), diff
        jm1 = jax_trunk(arch, dtype=jnp.bfloat16, stages=1)
        ref1 = np.asarray(jax.jit(jm1.apply)(variables, X), np.float32)
        ref1_32 = np.asarray(jax.jit(jax_trunk(arch, stages=1).apply)(variables, X))
        out1 = run(port_trunk(arch, variables, dtype=torch.bfloat16, stages=1)).float().numpy()
        assert np.abs(out1 - ref1).max() <= 0.5 * np.abs(ref1 - ref1_32).max()
    else:
        assert diff <= ATOL, diff


@pytest.mark.parametrize("arch", list(TRUNKS))
def test_stage_truncation_shapes_equal_jax(arch):
    for n in (0, 1, 2):
        want = jax.eval_shape(lambda x, m=jax_trunk(arch, stages=n): m.init_with_output(
            jax.random.PRNGKey(0), x)[0], jnp.zeros((1, 64, 64, 3)))
        got = run(TRUNKS[arch][1](arch, stages=n), np.zeros((1, 64, 64, 3), np.float32))
        assert tuple(got.shape) == want.shape, (n, got.shape, want.shape)


def tiny_kw(family, **kw):
    return dict(TINY, backbone=f"timm_{FAMILIES[family]}", **kw)


def jax_model_variables(kw, batch):
    model = jax_build_model(JaxConfig(**kw))
    jb = {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}
    return model, jb, random_variables(model, jb, seed=2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_round_trip_through_the_port_is_exact(family):
    kw = tiny_kw(family)
    _, _, variables = jax_model_variables(kw, make_batch(kw, [TINY["video_max_len"]]))
    sd = params_from_jax(variables, TubeDETRConfig(**kw))
    params, buffers = convert_tubedetr({k: v.numpy() for k, v in sd.items()}, JaxConfig(**kw))
    want = {"params": variables["params"], "buffers": variables.get("buffers", {})}
    got = {"params": params, "buffers": buffers if family != "convnext" else {}}
    if family == "convnext":
        assert buffers == {"backbone": {}} and "buffers" not in variables
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def twin(family):
    """A timm-named torch twin of the JAX tests with its seeded weights."""
    torch.manual_seed(0)
    if family == "efficientnet":
        from tests.test_efficientnet import _TorchEffNet as Twin
    elif family == "regnet":
        from tests.test_regnet import _TorchRegNet as Twin
    else:
        from tests.test_convnext import _TorchConvNeXt as Twin
    return Twin(FAMILIES[family]).eval()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_loads_the_timm_named_twin_strictly(family):
    ref = twin(family)
    sd = {k: v for k, v in ref.state_dict().items() if not k.endswith("num_batches_tracked")}
    arch = FAMILIES[family]
    tm = TRUNKS[arch][1](arch).eval()
    tm.load_state_dict(sd, strict=True)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)) * 0.5
    with torch.no_grad():
        want = ref(x).permute(0, 2, 3, 1)
        got = tm(x.permute(0, 2, 3, 1).contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_whole_model_matches_jax(family):
    kw = tiny_kw(family)
    batch = make_batch(kw, [6, 5], valid_hw=[(64, 64), (48, 56)])
    model, jb, variables = jax_model_variables(kw, batch)
    ref = jax.jit(model.apply)(variables, **jb)
    cfg = TubeDETRConfig(**kw)
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(variables, cfg))
    assert pm.input_proj.weight.shape[1] == pm.backbone[0].body.out_channels
    with torch.no_grad():
        out = pm(**{k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("pred_boxes", "pred_sted", "weights", "aux_pred_boxes"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-4, err_msg=k)


def test_validate_accepts_and_refuses_as_jax():
    for name in ALL_NAMES:
        backbone = f"timm_{name}"
        for extra in ({}, {"backbone_quant": "int8"}, {"backbone_quant": "int8_static"},
                      {"backbone_quant": "int8_qat"}, {"backbone_quant_fast": "int8"},
                      {"backbone_quant_fast": "int8_static", "compute_dtype": "bfloat16"},
                      {"backbone_quant": "int8_static", "fused_bottleneck": True}):
            JaxConfig(backbone=backbone, **extra).validate()
            TubeDETRConfig(backbone=backbone, **extra).validate()
        for frozen in ("int8", "int8_static"):
            for cfg in (JaxConfig, TubeDETRConfig):
                with pytest.raises(NotImplementedError, match="resnet family only"):
                    cfg(backbone=backbone, backbone_quant_frozen=frozen).validate()
    # a timm name of no family: the JAX model raises when it is built
    kw = dict(TINY, backbone="timm_resnet50")
    batch = make_batch(kw, [6])
    with pytest.raises(NotImplementedError, match="not available") as jax_err:
        jax_model_variables(kw, batch)
    with pytest.raises(NotImplementedError, match="not available") as port_err:
        TubeDETRConfig(**kw).validate()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trainable_set_equals_jax_labels(family):
    """Every trunk parameter trains (no frozen prefix: the JAX package's
    ``conv1``/``bn1``/``layer1_`` prefixes match no timm leaf), or none
    with ``lr_backbone = 0``."""
    kw = tiny_kw(family)
    _, _, variables = jax_model_variables(kw, make_batch(kw, [6]))
    for extra in ({}, {"lr_backbone": 0.0}):
        labels = jax_label_params(variables["params"], JaxConfig(**kw, **extra))
        mask = jax.tree_util.tree_map(
            lambda lab, p: np.full(np.shape(p), lab != "frozen", np.float32),
            labels, variables["params"])
        cfg = TubeDETRConfig(**kw, **extra)
        sd = params_from_jax({"params": mask, "buffers": variables.get("buffers", {})}, cfg)
        port = label_params(build_model(cfg, device="cpu"))
        for name, lab in port.items():
            assert (lab != "frozen") == bool(sd[name].min()), name
        trunk = {lab for n, lab in port.items() if n.startswith("backbone.")}
        assert trunk == ({"frozen"} if extra else {"backbone"})


# one dropout-free step: SGD (momentum 0.9, whose first update is the
# gradient), no clip, every LR 1: the post-step parameters are ``p - g``, so
# the JAX step's gives its gradients leaf by leaf from one compile
STEP_LRS = {"lr": 1.0, "lr_backbone": 1.0, "lr_text_encoder": 1.0}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_jax(family):
    """Loss terms (rtol 1e-5), ``grad_norm`` (rtol 1e-4), each leaf's
    gradient (``p - p'``) and post-step parameter and EMA (atol 1e-4 of the
    leaf's largest gradient plus 1e-6, ``tests/test_torch_train.py``'s
    gradient bound, plus 2 ulps of the parameter), the FrozenBN buffers
    unchanged; every trunk parameter moves, the stem's and the LayerNorms'
    included."""
    from tests import test_torch_train as tt
    from tubedetr_tpu.parallel.train_step import create_train_state as jax_create_state
    from tubedetr_tpu.parallel.train_step import make_train_step as jax_make_train_step
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, make_train_step

    kw = dict(tt.KW, backbone=f"timm_{FAMILIES[family]}", optimizer="sgd", clip_max_norm=0.0)
    jmodel, variables = tt.jax_variables(kw)
    jcfg = JaxConfig(**kw)
    jstate, tx, labels = jax_create_state(jcfg, variables)
    step = jax_make_train_step(jcfg, jmodel, tx, labels, donate=False, deterministic=True)
    jnew, jmetrics = step(jstate, tt.jax_batch(kw), {k: np.float32(v) for k, v in STEP_LRS.items()},
                          np.int32(0))
    cfg, model = tt.port_model(kw, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    state, metrics = make_train_step(cfg, deterministic=True)(state, tt.port_batch(kw), STEP_LRS, 0)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   err_msg=k)
    buffers = variables.get("buffers", {})  # a ConvNeXt model has none
    want = params_from_jax({"params": jnew.params, "buffers": buffers}, cfg)
    want_ema = params_from_jax({"params": jnew.ema_params, "buffers": buffers}, cfg)
    for name, p in state.model.named_parameters():
        p0 = before[name].numpy()
        g = p0 - want[name].numpy()
        tol = 1e-4 * np.abs(g).max() + 1e-6 + 2 * np.spacing(np.abs(p0))
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[name].numpy()), tol + 1e-12,
                                     err_msg=name)
        np.testing.assert_array_less(np.abs(state.ema_params[name].numpy() - want_ema[name].numpy()),
                                     tol + 1e-12, err_msg=name)
        if name.startswith("backbone."):
            assert p.requires_grad and not torch.equal(p.detach(), before[name]), name
    for name, buf in state.model.named_buffers():
        if name.startswith("backbone.") and name in before:
            assert torch.equal(buf, before[name]), name


def test_load_pretrained_takes_a_timm_checkpoint_and_refuses_another_family():
    """A reference-named timm checkpoint (``backbone.0.body.<timm keys>``)
    loads as it is; a checkpoint of another trunk family is refused both
    ways (EfficientNet's ``bn1`` is a FrozenBN, so the norm check alone
    would pass a ResNet checkpoint)."""
    from tubedetr_tpu_torch.train.checkpoint import load_pretrained

    models = {b: build_model(TubeDETRConfig(**dict(TINY, backbone=b)), device="cpu")
              for b in ("timm_efficientnet_b0", "timm_convnext_tiny", "resnet14")}
    sd = {k: v.clone() for k, v in models["timm_efficientnet_b0"].state_dict().items()}
    fresh = build_model(TubeDETRConfig(**dict(TINY, backbone="timm_efficientnet_b0")),
                        device="cpu")
    missing, unexpected = load_pretrained(fresh, {"model": sd})
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    for a, b in (("timm_efficientnet_b0", "resnet14"), ("resnet14", "timm_efficientnet_b0"),
                 ("timm_convnext_tiny", "timm_efficientnet_b0")):
        with pytest.raises(ValueError, match="trunk"):
            load_pretrained(models[b], {"model": models[a].state_dict()})


def test_cli_trains_resumes_evaluates_and_reloads_a_timm_model(tmp_path):
    """``apps/train.py`` with ``--backbone timm_regnetx_002``: an epoch, a
    ``--resume`` for the second, an int8_static ``--eval --load`` of the
    checkpoint (calibrated inside, G1 on the grouped convs), and
    ``GroundingPipeline.reload`` of it."""
    from tubedetr_tpu_torch.apps import train
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.data.synthetic import write_vidstg_dir

    data = write_vidstg_dir(str(tmp_path / "vidstg"), 2, 1, t=6, h=48, w=64,
                            video_max_len_train=6)
    model = ["--backbone", "timm_regnetx_002", "--hidden_dim", "32", "--nheads", "4",
             "--enc_layers", "1", "--dec_layers", "1", "--dim_feedforward", "64",
             "--video_max_len", "6", "--video_max_len_train", "6", "--stride", "2",
             "--resolution", "128", "--max_text_len", "8", "--text_vocab_size", "128",
             "--text_hidden_size", "32", "--text_layers", "1", "--text_heads", "4",
             "--text_ffn", "64", "--device", "cpu", "--num_workers", "0"]
    common = ["--combine_datasets", "vidstg", "--combine_datasets_val", "vidstg",
              "--vidstg_ann_path", data, "--vidstg_vid_path", data, *model, "--ema"]
    out = tmp_path / "out"
    assert train.main([*common, "--epochs", "1", "--output-dir", str(out)]) == 0
    ckpt = str(out / "checkpoint.pth")
    assert train.main([*common, "--epochs", "2", "--resume", ckpt,
                       "--output-dir", str(tmp_path / "resumed")]) == 0
    assert train.main([*common, "--eval", "--load", ckpt, "--backbone_quant", "int8_static",
                       "--output-dir", str(tmp_path / "eval")]) == 0
    from tubedetr_tpu_torch.apps.cli import config_from_args

    pipe = GroundingPipeline(config_from_args(model), device="cpu")
    pipe.reload(ckpt)
    got = pipe.ground(f"{data}/val0.npy", "a red square", render=False)
    assert len(got["boxes"]) == 6
