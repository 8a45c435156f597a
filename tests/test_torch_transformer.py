"""The port's attention, RoBERTa and TubeDETRTransformer against JAX.

Same numpy weights (moved with ``interop/from_jax.py``) and inputs on both
sides, float32 on the CPU. Tolerances: 1e-5 for one attention layer, 1e-4
for the stacks.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.models.layers import MultiHeadAttention as JaxMHA
from tubedetr_tpu.models.roberta import RobertaConfig as JaxRobertaConfig
from tubedetr_tpu.models.roberta import RobertaModel as JaxRoberta
from tubedetr_tpu.models.transformer import TubeDETRTransformer as JaxTransformer
from tubedetr_tpu_torch.interop.from_jax import mha_from_jax, roberta_from_jax, transformer_from_jax
from tubedetr_tpu_torch.models.layers import NEG_INF, MultiHeadAttention, masked_softmax
from tubedetr_tpu_torch.models.roberta import RobertaConfig, RobertaModel, roberta_position_ids
from tubedetr_tpu_torch.models.transformer import TubeDETRTransformer

D, HEADS, FFN, TEXT_DIM = 32, 4, 64, 48
ROBERTA = dict(vocab_size=64, hidden_size=TEXT_DIM, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64, max_position_embeddings=20)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_masked_softmax_fully_masked_row_is_zero():
    logits = torch.tensor([[0.5, 1.0, -2.0], [NEG_INF, NEG_INF, NEG_INF]])
    w = masked_softmax(logits)
    torch.testing.assert_close(w[0], torch.softmax(logits[0], -1))
    assert torch.equal(w[1], torch.zeros(3))


def test_multihead_attention_matches_jax():
    """Outputs and head-averaged weights, with one batch row whose keys are
    all padding (the NaN guard yields zero weights there)."""
    rng = np.random.RandomState(0)
    q = rng.randn(3, 5, D).astype(np.float32)
    kv = rng.randn(3, 7, D).astype(np.float32)
    mask = rng.rand(3, 7) > 0.6
    mask[0, 0] = False
    mask[1] = True  # fully padded key row
    jm = JaxMHA(D, HEADS)
    variables = random_variables(jm, dict(query=q, key=kv, value=kv, key_pad_mask=mask))
    ref_out, ref_w = jax.jit(jm.apply)(variables, q, kv, kv, mask)

    tm = MultiHeadAttention(D, HEADS)
    tm.load_state_dict(mha_from_jax(variables["params"]))
    with torch.no_grad():
        out, w = tm(_t(q), _t(kv), _t(kv), _t(mask))
    assert w.shape == (3, 5, 7)
    assert torch.all(w[1] == 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-5)


def test_roberta_matches_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(4, ROBERTA["vocab_size"], (2, 9)).astype(np.int32)
    pad = np.zeros((2, 9), bool)
    pad[0, 6:] = True
    ids[0, 6:] = 1
    jm = JaxRoberta(JaxRobertaConfig(**ROBERTA))
    variables = random_variables(jm, dict(input_ids=ids, pad_mask=pad), seed=2)
    ref = np.asarray(jax.jit(jm.apply)(variables, ids, pad))

    tm = RobertaModel(RobertaConfig(**ROBERTA)).eval()
    tm.load_state_dict(roberta_from_jax(variables["params"]))
    with torch.no_grad():
        out = tm(_t(ids).long(), _t(pad)).numpy()
    np.testing.assert_allclose(out[~pad], ref[~pad], atol=1e-4)


def test_roberta_position_ids():
    ids = torch.tensor([[0, 5, 6, 2, 1, 1]])
    assert roberta_position_ids(ids, 1).tolist() == [[2, 3, 4, 5, 1, 1]]


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow-only"])
def test_tubedetr_transformer_matches_jax(fast):
    """Encoder + fast branch + temporal replication + decoder: every layer's
    normed output, TSA weights and cross-attention weights."""
    b, t, stride, hw, l = 2, 6, 2, 4, 5
    tc = -(-t // stride)
    rng = np.random.RandomState(3)
    durations = np.array([t, 3], np.int32)
    inputs = dict(
        src=rng.randn(b, tc, hw, D).astype(np.float32),
        src_pad_mask=rng.rand(b, tc, hw) > 0.7,
        pos_embed=rng.randn(b, tc, hw, D).astype(np.float32) * 0.3,
        text_memory=rng.randn(b, l, TEXT_DIM).astype(np.float32),
        text_pad_mask=np.array([[False] * 5, [False] * 3 + [True] * 2]),
        query_embed=rng.randn(1, D).astype(np.float32),
        durations=durations,
        frame_pad_mask=rng.rand(b, t, hw) > 0.7,
        fast_src=rng.randn(b, t, hw, D).astype(np.float32) if fast else None,
    )
    inputs["src_pad_mask"][:, :, 0] = False
    jm = JaxTransformer(d_model=D, nheads=HEADS, enc_layers=2, dec_layers=2,
                       dim_feedforward=FFN, dropout=0.0, video_max_len=t,
                       stride=stride, fast=fast, text_dim=TEXT_DIM)
    params = random_variables(jm, {k: v for k, v in inputs.items() if v is not None}, seed=4)
    ref = jax.jit(jm.apply)(params, **{k: v for k, v in inputs.items() if v is not None})

    tm = TubeDETRTransformer(d_model=D, nheads=HEADS, enc_layers=2, dec_layers=2,
                             dim_feedforward=FFN, video_max_len=t, stride=stride,
                             fast=fast, text_cfg=RobertaConfig(**ROBERTA)).eval()
    result = tm.load_state_dict(transformer_from_jax(params["params"]), strict=False)
    assert all(k.startswith("text_encoder.") for k in result.missing_keys)
    assert not result.unexpected_keys
    with torch.no_grad():
        out = tm(**{k: (None if v is None else _t(v)) for k, v in inputs.items()})
    for k in ("hs", "tsa_weights", "cross_weights"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
