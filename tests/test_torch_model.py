"""The port's full TubeDETR inference forward against the JAX model.

Same weights (JAX variables moved with ``params_from_jax``) and the same
numpy inputs go through ``tubedetr_tpu.models.tubedetr.TubeDETR`` and
``tubedetr_tpu_torch.models.tubedetr.TubeDETR`` on the CPU, in float32, on
the cases of ``tests/test_full_model_parity.py`` this slice covers: fast on
and off, a ragged ``dur % stride != 0`` tail clip, DC5, and spatial pad
masks. Tolerance: atol 2e-4, the JAX package's own full-model bound (fp32
accumulated over a 14-layer conv trunk and the transformer).
"""

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax
from tubedetr_tpu_torch.models.tubedetr import build_model

T, STRIDE, RES = 6, 2, 64
ATOL = 2e-4

TINY = dict(
    backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2,
    dim_feedforward=64, video_max_len=T, video_max_len_train=T, stride=STRIDE,
    resolution=128, max_text_len=12, text_vocab_size=64, text_hidden_size=48,
    text_layers=1, text_heads=4, text_ffn=64, text_max_positions=20,
    guided_attn=True, sted=True, aux_loss=True, dropout=0.0,
    compute_dtype="float32",
)


def random_variables(model, inputs, seed=0):
    """JAX variables for ``model`` filled from a numpy seed (no ``init``
    run: its eager trace is slow on the CPU). Every leaf is random, norm
    scales, biases, FrozenBN statistics and the zero-init fast residual
    included, so the mapping of each one is exercised."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), **inputs)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "running_var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale" or (name == "weight" and len(shape) == 1):
            return (1 + rng.randn(*shape) * 0.1).astype(np.float32)
        if name in ("bias", "running_mean"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(shape[-4:-1] if len(shape) >= 4 else shape[:-1])) or 1
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_batch(cfg_kw, durations, valid_hw=None, seed=3):
    """Numpy model inputs: frames from a seed, temporal padding past each
    duration and, with ``valid_hw``, spatial padding per video."""
    b, t = len(durations), cfg_kw["video_max_len"]
    tc = -(-t // cfg_kw["stride"])
    rng = np.random.RandomState(seed)
    frames = rng.randn(b, t, RES, RES, 3).astype(np.float32) * 0.5
    fast_pad = np.ones((b, t, RES, RES), bool)
    slow_pad = np.ones((b, tc, RES, RES), bool)
    tokens = np.ones((b, cfg_kw["max_text_len"]), np.int64)
    text_pad = np.ones((b, cfg_kw["max_text_len"]), bool)
    for i, dur in enumerate(durations):
        vh, vw = (valid_hw or [(RES, RES)] * b)[i]
        frames[i, dur:] = 0
        frames[i, :, vh:] = 0
        frames[i, :, :, vw:] = 0
        fast_pad[i, :dur, :vh, :vw] = False
        slow_pad[i, : -(-dur // cfg_kw["stride"]), :vh, :vw] = False
        n_tok = 4 + i
        tokens[i, :n_tok] = rng.randint(4, cfg_kw["text_vocab_size"], n_tok)
        text_pad[i, :n_tok] = False
    batch = dict(
        frames_slow=frames[:, ::cfg_kw["stride"]].copy(),
        slow_pad_mask=slow_pad,
        tokens=tokens,
        text_pad_mask=text_pad,
        durations=np.asarray(durations, np.int64),
    )
    if cfg_kw.get("fast", True):
        batch["frames_fast"] = frames
        batch["fast_pad_mask"] = fast_pad
    return batch


def jax_forward(cfg_kw, batch, seed=0):
    """(JAX outputs as numpy, perturbed JAX variables)."""
    model = jax_build_model(JaxConfig(**cfg_kw))
    jb = {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}
    variables = random_variables(model, jb, seed)
    out = jax.jit(model.apply)(variables, **jb)
    return {k: np.asarray(v) for k, v in out.items() if k != "n_visual_tokens"}, variables


def port_model(cfg_kw, variables):
    cfg = TubeDETRConfig(**cfg_kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    return model


def port_forward(model, batch):
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: v.numpy() for k, v in out.items()}


CASES = {
    "fast-ragged-tailclip": (dict(fast=True), [5], None),
    "noslow-ragged": (dict(fast=False), [5], None),
    "fast-full": (dict(fast=True), [T], None),
    "fast-dc5": (dict(fast=True, dilation=True), [T], None),
    "fast-unshared-backbone": (dict(fast=True, share_backbone_inference=False), [5], None),
    "fast-spatial-pad-b2": (dict(fast=True), [T, 4], [(RES, RES), (40, 56)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_forward_matches_jax(case):
    extra, durations, valid_hw = CASES[case]
    kw = {**TINY, **extra}
    batch = make_batch(kw, durations, valid_hw)
    ref, variables = jax_forward(kw, batch)
    out = port_forward(port_model(kw, variables), batch)
    for k in ("pred_boxes", "pred_sted", "weights", "ca_weights",
              "aux_pred_boxes", "aux_pred_sted", "aux_weights"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], atol=ATOL, err_msg=k)


def test_state_dict_round_trips_through_convert_tubedetr():
    """Port ``state_dict`` -> the JAX package's ``convert_tubedetr`` (the
    reader of reference ``.pth`` names) -> ``params_from_jax`` gives back
    every tensor unchanged: a reference checkpoint's names load into the
    port. resnet26 puts stacked tail blocks in the scanned layout."""
    from tubedetr_tpu.interop.torch_convert import convert_tubedetr

    kw = {**TINY, "backbone": "resnet26"}
    cfg = TubeDETRConfig(**kw)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    sd = {k: v + torch.randn_like(v) * 0.1 for k, v in model.state_dict().items()}
    params, buffers = convert_tubedetr(sd, JaxConfig(**kw))
    back = params_from_jax({"params": params, "buffers": buffers}, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_load_reference_pth_prefers_ema_and_truncates_queries(tmp_path):
    """``train/checkpoint.py:load_pretrained``: EMA weights over ``model``, extra queries
    dropped, the sine time-embedding buffer ignored, non-strict."""
    from tubedetr_tpu_torch.train.checkpoint import load_pretrained

    cfg = TubeDETRConfig(**TINY)
    model = build_model(cfg, device="cpu")
    sd = {k: torch.randn_like(v) for k, v in model.state_dict().items()}
    sd["query_embed.weight"] = torch.randn(3, TINY["hidden_dim"])
    sd["transformer.time_embed.te"] = torch.zeros(1)
    del sd["bbox_embed.layers.0.bias"]
    path = str(tmp_path / "checkpoint.pth")
    torch.save({"model": {k: v + 1 for k, v in sd.items()}, "model_ema": sd}, path)
    missing, unexpected = load_pretrained(model, path)
    assert missing == ["bbox_embed.layers.0.bias"] and unexpected == []
    got = model.state_dict()
    torch.testing.assert_close(got["query_embed.weight"], sd["query_embed.weight"][:1])
    torch.testing.assert_close(got["input_proj.weight"], sd["input_proj.weight"])


def test_config_rejects_what_the_port_does_not_run():
    for kw in (dict(backbone_quant="int8_qat"), dict(backbone_quant_fast="int8_static"),
               dict(backbone_quant_frozen="int8_static"), dict(log_quant_drift=True),
               dict(recalibrate_each_epoch=True), dict(backbone="timm_efficientnet_b3"),
               dict(backbone="resnet101-gn", backbone_quant="int8_static")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TubeDETRConfig(**kw).validate()
    # the JAX package's own refusals
    with pytest.raises(ValueError, match="no_tsa"):
        TubeDETRConfig(num_queries=2, no_tsa=True).validate()
    with pytest.raises(ValueError, match="remat_policy"):
        TubeDETRConfig(remat_policy="save_all").validate()
    # the fast_mode variants, num_queries > 1, the model flags, the GroupNorm
    # trunks, the remat policies and bfloat16 training run
    for kw in (dict(fast_mode="gating"), dict(fast_mode="noslow"), dict(num_queries=2),
               dict(position_embedding="learned"), dict(position_embedding="v2"),
               dict(position_embedding="v3"), dict(no_tsa=True), dict(learn_time_embed=True),
               dict(no_time_embed=True), dict(remat_policy="save_mid"),
               dict(remat_policy="save_acts"), dict(remat_policy="")):
        TubeDETRConfig(**kw).validate()
    for arch in ("resnet50-gn", "resnet101-gn", "resnet152-gn"):
        for dtype in ("float32", "bfloat16"):
            TubeDETRConfig(backbone=arch, compute_dtype=dtype).validate_training()
    TubeDETRConfig(compute_dtype="bfloat16").validate_training()
