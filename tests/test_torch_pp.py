"""The port's GPipe pipeline (``parallel/pp.py``) on 4 gloo ranks, held to the sequential stack and to the JAX package's pipeline.

``tests/test_pipeline.py``'s cases against the port: the toy stack of 4
layers (``y + tanh(y @ w + b + aux)``) pipelined at (stages, microbatches)
of (2, 4), (4, 4), (4, 2) and (1, 2) (the ranks past ``stages`` form a data
axis, which must not change the numbers) against the sequential stack
(atol 1e-6) and against the JAX ``pipeline_apply`` on as many host devices
(atol 1e-6); the gradients of every layer's parameters (each on its own
stage) and of the input through pipe=2 x data=2 against the sequential
stack's (atol 1e-6) and ``jax.grad`` of the JAX pipeline; the space-text
encoder stack (4 layers, clips as units) and the decoder stack (videos as
units, every layer's output, TSA and cross weights collected) against the
port's ``Encoder`` and ``Decoder`` and against the JAX ones from the same
variables (atol 2e-5); a preplaced stack (this stage's layers alone) gives
the same numbers exactly; ``L % P != 0`` is refused. One spawn serves every
case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist_ranks as R
from tubedetr_tpu_torch.interop.from_jax import _encoder_layer, _layernorm, _linear, _mha, _tensors

L = 4
CASES = ((2, 4), (4, 4), (4, 2), (1, 2))


def _stack(d, seed):
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(d, d) * 0.3).astype(np.float32) for _ in range(L)]
    bs = [(rng.randn(d) * 0.1).astype(np.float32) for _ in range(L)]
    return ws, bs


def _sequential(ws, bs, x, aux):
    y = torch.from_numpy(x)
    for w, b in zip(ws, bs):
        y = y + torch.tanh(y @ torch.from_numpy(w) + torch.from_numpy(b) + torch.from_numpy(aux))
    return y


def _jax_pipeline(ws, bs, x, aux, stages, micro):
    from tubedetr_tpu.parallel.pp import make_pipe_mesh, pipeline_apply, stack_layer_params

    stacked = stack_layer_params([{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)])
    return pipeline_apply(lambda p, y, a: y + jnp.tanh(y @ p["w"] + p["b"] + a), stacked,
                          jnp.asarray(x), jnp.asarray(aux), mesh=make_pipe_mesh(pipe=stages),
                          microbatches=micro)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    toy = {}
    for stages, micro in CASES:
        ws, bs = _stack(8, 0)
        toy[(stages, micro)] = (ws, bs, rng.randn(8, 3, 8).astype(np.float32),
                                (rng.randn(8, 3, 8) * 0.2).astype(np.float32))
    ws, bs = _stack(6, 3)
    rng = np.random.RandomState(4)
    grad_case = (ws, bs, rng.randn(4, 6).astype(np.float32),
                 (rng.randn(4, 6) * 0.1).astype(np.float32), rng.randn(4, 6).astype(np.float32))
    return toy, grad_case, _encoder_case(), _decoder_case()


def _encoder_case():
    from tubedetr_tpu.models.transformer import Encoder

    d, heads, ffn, layers = 32, 4, 64, 4
    n, s = 8, 10
    rng = np.random.RandomState(5)
    x = rng.randn(n, s, d).astype(np.float32)
    pos = (rng.randn(n, s, d) * 0.3).astype(np.float32)
    mask = rng.rand(n, s) > 0.8
    mask[:, 0] = False
    enc = Encoder(layers, d, heads, ffn, dropout=0.1)
    variables = enc.init(jax.random.PRNGKey(0), x, pos, mask)
    ref = np.asarray(enc.apply(variables, x, pos, mask))
    sd = {}
    for i in range(layers):
        sd.update(_encoder_layer(variables["params"][f"layer_{i}"], f"layers.{i}"))
    sd = {k: v.numpy() for k, v in _tensors(sd).items()}
    return (d, heads, ffn, layers), sd, (x, pos, mask), ref, variables


def _decoder_case():
    from tubedetr_tpu.models.transformer import Decoder

    d, heads, ffn, layers = 32, 4, 64, 4
    b, t, s = 8, 6, 10
    rng = np.random.RandomState(8)
    tgt = np.zeros((b, t, d), np.float32)
    qpos = (rng.randn(b, t, d) * 0.3).astype(np.float32)
    mem = rng.randn(b, t, s, d).astype(np.float32)
    mpos = (rng.randn(b, t, s, d) * 0.3).astype(np.float32)
    mmask = rng.rand(b, t, s) > 0.8
    mmask[:, :, 0] = False
    qpad = rng.rand(b, t) > 0.8
    qpad[:, 0] = False
    dec = Decoder(layers, d, heads, ffn, dropout=0.1)
    args = (tgt, qpos, mem, mpos, mmask, qpad)
    variables = dec.init(jax.random.PRNGKey(0), *args)
    ref = [np.asarray(a) for a in dec.apply(variables, *args)]
    p = variables["params"]
    sd = {}
    for i in range(layers):
        lp, name = p[f"layer_{i}"], f"layers.{i}"
        for k in ("self_attn", "cross_attn_image"):
            sd.update(_mha(lp[k], f"{name}.{k}"))
        for k in ("linear1", "linear2"):
            sd.update(_linear(lp[k], f"{name}.{k}"))
        for k in ("norm1", "norm3", "norm4"):
            sd.update(_layernorm(lp[k], f"{name}.{k}"))
    sd.update(_layernorm(p["norm"], "norm"))
    sd = {k: v.numpy() for k, v in _tensors(sd).items()}
    return (d, heads, ffn, layers), sd, args, ref, variables


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    toy, grad_case, enc, dec = inputs
    return R.spawn(R.pp_ranks, 4, tmp_path_factory.mktemp("pp"), toy, grad_case, enc[:3],
                   dec[:3], threads=1)


@pytest.mark.parametrize("stages,micro", CASES)
def test_pipeline_matches_sequential_and_jax(inputs, ranks, stages, micro):
    ws, bs, x, aux = inputs[0][(stages, micro)]
    ref = _sequential(ws, bs, x, aux).numpy()
    jax_out = np.asarray(_jax_pipeline(ws, bs, x, aux, stages, micro))
    for r in ranks:  # every stage and every data rank holds the result
        out = r["toy"][(stages, micro)]
        np.testing.assert_allclose(out, ref, atol=1e-6)
        np.testing.assert_allclose(out, jax_out, atol=1e-6)


def test_pipeline_gradients_match_sequential_and_jax(inputs, ranks):
    ws, bs, x, aux, tgt = inputs[1]
    params = [torch.from_numpy(a).clone().requires_grad_(True) for a in ws + bs]
    xt = torch.from_numpy(x).clone().requires_grad_(True)
    y = xt
    for w, b in zip(params[:L], params[L:]):
        y = y + torch.tanh(y @ w + b + torch.from_numpy(aux))
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()

    def jax_loss(stacked, x):
        from tubedetr_tpu.parallel.pp import make_pipe_mesh, pipeline_apply

        y = pipeline_apply(lambda p, y, a: y + jnp.tanh(y @ p["w"] + p["b"] + a), stacked, x,
                           jnp.asarray(aux), mesh=make_pipe_mesh(pipe=2), microbatches=2)
        return jnp.mean((y - tgt) ** 2)

    stacked = {"w": jnp.asarray(np.stack(ws)), "b": jnp.asarray(np.stack(bs))}
    jg, jx = jax.grad(jax_loss, argnums=(0, 1))(stacked, jnp.asarray(x))
    seen = set()
    for r in ranks:
        g = r["grad"]
        np.testing.assert_allclose(g["x"], xt.grad.numpy(), atol=1e-6)
        np.testing.assert_allclose(g["x"], np.asarray(jx), atol=1e-6)
        assert g["others_none"]  # a stage's gradients land on its own layers only
        for i, (gw, gb) in g["layers"].items():
            np.testing.assert_allclose(gw, params[i].grad.numpy(), atol=1e-6, err_msg=f"w{i}")
            np.testing.assert_allclose(gb, params[L + i].grad.numpy(), atol=1e-6, err_msg=f"b{i}")
            np.testing.assert_allclose(gw, np.asarray(jg["w"][i]), atol=1e-6)
            np.testing.assert_allclose(gb, np.asarray(jg["b"][i]), atol=1e-6)
            seen.add(i)
    assert seen == set(range(L))


def test_pipelined_encoder_matches_model_and_jax(inputs, ranks):
    from tubedetr_tpu.parallel.pp import make_pipe_mesh, pipelined_encoder_apply, stack_layer_params

    (d, heads, ffn, layers), _, (x, pos, mask), ref, variables = inputs[2]
    stacked = stack_layer_params([variables["params"][f"layer_{i}"] for i in range(layers)])
    for stages, micro in ((2, 4), (4, 2)):
        jax_out = np.asarray(pipelined_encoder_apply(
            stacked, x, pos, mask, mesh=make_pipe_mesh(pipe=stages), microbatches=micro,
            d_model=d, nheads=heads, dim_feedforward=ffn))
        for r in ranks:
            out = r["enc"][(stages, micro)]
            np.testing.assert_allclose(out, ref, atol=2e-5)
            np.testing.assert_allclose(out, jax_out, atol=2e-5)


def test_pipelined_decoder_matches_model(inputs, ranks):
    """Every layer's shared-norm output, TSA weights and cross weights."""
    ref = inputs[3][3]
    for r in ranks:
        for got, want, what in zip(r["dec"], ref, ("hs", "tsa", "cross")):
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=what)


def test_pipeline_accepts_preplaced_params(ranks):
    for r in ranks:
        whole, placed = r["placed"]
        assert np.array_equal(whole, placed) and r["placed_layers"] == 1


def test_stack_layout_and_refusal():
    """The stack is the layers in order, a stage holds a contiguous group,
    and 6 layers over 4 stages are refused (as ``_to_stage_major``)."""
    from tubedetr_tpu_torch.parallel.pp import (
        PipeMesh,
        _stage_range,
        encoder_stack_params,
        place_stacked_params,
        stack_layer_params,
    )
    from tubedetr_tpu_torch.models.tubedetr import build_model

    model = build_model(R.cfg_of(enc_layers=2), device="cpu")
    stack = encoder_stack_params(model)
    assert list(stack) == list(model.transformer.encoder.layers)
    assert stack_layer_params(list(stack))[1] is model.transformer.encoder.layers[1]
    assert [list(_stage_range(6, 3, s)) for s in range(3)] == [[0, 1], [2, 3], [4, 5]]
    placed = place_stacked_params(stack, PipeMesh(pipe=2, stage=1))
    assert list(placed.layers) == [stack[1]] and placed.n_layers == 2
    with pytest.raises(ValueError, match="do not split"):
        _stage_range(6, 4, 0)
