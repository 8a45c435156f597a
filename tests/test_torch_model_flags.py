"""The model flags and the GroupNorm trunk against the JAX model.

One parametrised case per setting: the learned 50x50 position grid
(``learned``, ``v3``), the sine one under its other name (``v2``),
``no_tsa``, ``learn_time_embed``, ``no_time_embed`` and the ``resnet26-gn``
trunk. Each builds the tiny model of ``tests/test_torch_train.py`` (one
encoder layer here), fills the JAX variables from a numpy seed, carries
them into the port with ``params_from_jax`` and runs the same synthetic
batch through one dropout-free training forward and backward on both
sides (one JAX compile a case): the outputs (atol 2e-4, the JAX package's
full-model bound), every loss term (rtol 1e-5) and every trainable
parameter's gradient (atol 1e-4 of the leaf's largest |g| plus 1e-6, the
bound of ``tests/test_torch_train.py``). The GroupNorm trunk's gradients
are the exception: the JAX package's float32 ones sit up to 1.24e-2 of
the leaf's largest |g| from the same model's float64 gradients (layer4's
last conv; 5e-4 to 1e-3 on layer2), the port's float32 ones at 1.6e-6, so
there both packages are held to the port's float64 run, the port at 1e-5
and the JAX package at ``GN_JAX_RTOL``. The port's ``state_dict`` then
round-trips through the JAX package's ``convert_tubedetr`` and
``params_from_jax`` unchanged (the JAX converter has no entry for the
learned grid, which the reference keeps under ``backbone.1.``: the round
trip carries it by hand, and ``load_pretrained`` takes those names).

Besides: the GroupNorm model's optimizer labels equal the JAX package's
(its stem and layer1 norms frozen, layer2-4 at ``lr_backbone``); the
tensor-parallel split shards as many JAX leaves as ``tp_param_pspecs`` for
``no_tsa`` and ``learned``; and the pipelined decoder stack with ``no_tsa``
layers equals the sequential stack.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import random_variables
from tests.test_torch_train import KW, jax_batch, port_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.losses.criterion import SetCriterion as JaxCriterion
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax
from tubedetr_tpu_torch.losses.criterion import SetCriterion
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.parallel.train_step import model_inputs, to_device

BASE = dict(KW, enc_layers=1)
CASES = {
    "learned": dict(position_embedding="learned"),
    "v2": dict(position_embedding="v2"),
    "v3": dict(position_embedding="v3"),
    "no_tsa": dict(no_tsa=True),
    "learn_time_embed": dict(learn_time_embed=True),
    "no_time_embed": dict(no_time_embed=True),
    "resnet26-gn": dict(backbone="resnet26-gn"),
}
OUTPUTS = ("pred_boxes", "pred_sted", "weights", "ca_weights", "aux_pred_boxes",
           "aux_pred_sted", "aux_weights")
ATOL, LOSS_RTOL = 2e-4, 1e-5
GN_JAX_RTOL = 2e-2  # the JAX GroupNorm trunk's float32 gradients against float64


def jax_inputs(kw):
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in jax_model_inputs(jax_batch(kw)).items()}


def jax_variables(kw):
    return random_variables(jax_build_model(JaxConfig(**kw)), jax_inputs(kw))


def jax_train_pass(kw, variables):
    """(outputs, loss terms, grads) of the JAX training forward and backward."""
    model, crit = jax_build_model(JaxConfig(**kw)), JaxCriterion(JaxConfig(**kw))
    batch = jax.tree_util.tree_map(jnp.asarray, jax_batch(kw))

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, **jax_model_inputs(batch),
                          deterministic=True, train=True)
        losses = crit(out, batch["target_boxes"], batch["inter_idx"], batch["time_mask"])
        return crit.total(losses), (out, losses)

    (_, (out, losses)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return ({k: np.asarray(v) for k, v in out.items() if k in OUTPUTS},
            {k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.asarray, grads))


def port_model(kw, variables):
    cfg = TubeDETRConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    return cfg, model


def float64_grads(kw, variables, batch):
    """The port model's gradients in float64, {name: array}."""
    cfg, model = port_model(kw, variables)
    model = model.double()
    batch = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
             for k, v in batch.items()}
    crit = SetCriterion(cfg)
    out = model(**model_inputs(batch), train=True)
    crit.total(crit(out, batch["target_boxes"], batch["inter_idx"], batch["time_mask"])).backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("case", list(CASES))
def test_flag_matches_jax(case):
    kw = {**BASE, **CASES[case]}
    variables = jax_variables(kw)
    ref_out, ref_losses, ref_grads = jax_train_pass(kw, variables)
    cfg, model = port_model(kw, variables)
    batch = to_device(port_batch(kw), torch.device("cpu"))
    out = model(**model_inputs(batch), train=True)
    crit = SetCriterion(cfg)
    losses = crit(out, batch["target_boxes"], batch["inter_idx"], batch["time_mask"])
    crit.total(losses).backward()
    # the forward
    for k in OUTPUTS:
        assert out[k].shape == ref_out[k].shape, k
        np.testing.assert_allclose(out[k].detach().numpy(), ref_out[k], atol=ATOL, err_msg=k)
    if cfg.no_tsa:
        assert out["weights"].shape[-1] == 1
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=LOSS_RTOL, err_msg=k)
    # the backward, leaf by leaf through params_from_jax
    ref = params_from_jax({**variables, "params": ref_grads}, cfg)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    exact = float64_grads(kw, variables, batch) if cfg.backbone.endswith("-gn") else None
    for n in trainable:
        g, r = model.get_parameter(n).grad.numpy(), ref[n].numpy()
        if exact is not None and n.startswith("backbone."):
            e = exact[n]
            scale = float(np.abs(e).max())
            np.testing.assert_allclose(g, e, rtol=0, atol=1e-5 * scale + 1e-9, err_msg=f"grad {n}")
            np.testing.assert_allclose(r, e, rtol=0, atol=GN_JAX_RTOL * scale, err_msg=f"jax {n}")
            continue
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * float(np.abs(r).max()) + 1e-6,
                                   err_msg=f"grad {n}")
    # the flag's own leaves exist and train
    new = {"learned": ["row_embed.weight", "col_embed.weight"],
           "v3": ["row_embed.weight", "col_embed.weight"],
           "learn_time_embed": ["transformer.time_embed.time_embed.weight"],
           "resnet26-gn": ["backbone.0.body.layer2.0.bn1.weight"]}.get(case, [])
    assert all(n in trainable for n in new), new
    # the weights round-trip through the JAX converter
    from tubedetr_tpu.interop.torch_convert import convert_tubedetr

    sd = {k: v + torch.randn_like(v) * 0.1 for k, v in model.state_dict().items()}
    params, buffers = convert_tubedetr(sd, JaxConfig(**kw))
    for grid in ("row_embed", "col_embed"):  # no reference name in convert_tubedetr
        if f"{grid}.weight" in sd:
            params[grid] = sd[f"{grid}.weight"].numpy()
    back = params_from_jax({"params": params, "buffers": buffers}, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    if "row_embed.weight" in sd:  # the reference's names for the grid load too
        from tubedetr_tpu_torch.train.checkpoint import load_pretrained

        ref_names = {(f"backbone.1.{k}" if k.split(".")[0] in ("row_embed", "col_embed") else k): v
                     for k, v in sd.items()}
        assert load_pretrained(model, {"model": ref_names}) == ([], [])
        assert torch.equal(model.row_embed.weight.detach(), sd["row_embed.weight"])


def test_groupnorm_labels_match_jax():
    """The GroupNorm trunk's optimizer labels are the JAX package's, leaf by
    leaf: the stem and layer1 (convs and norms) frozen, layer2-4 at
    ``lr_backbone``; a ``-gn`` checkpoint loads into it, a FrozenBN one is
    refused."""
    from tubedetr_tpu.train.optim import label_params as jax_labels
    from tubedetr_tpu_torch.train.checkpoint import load_pretrained
    from tubedetr_tpu_torch.train.optim import label_params

    kw = {**BASE, "backbone": "resnet26-gn"}
    variables = jax_variables(kw)
    codes = {"main": 1.0, "backbone": 2.0, "text": 3.0, "frozen": 4.0}
    labels = jax_labels(variables["params"], JaxConfig(**kw))
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), codes[lab], np.float32),
                                   labels, variables["params"])
    want = params_from_jax({**variables, "params": coded}, TubeDETRConfig(**kw))
    cfg, model = port_model(kw, variables)
    got = label_params(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for n, lab in got.items():
        assert float(want[n].reshape(-1)[0]) == codes[lab], (n, lab)
    assert got["backbone.0.body.bn1.weight"] == got["backbone.0.body.layer1.0.bn1.weight"] == "frozen"
    assert got["backbone.0.body.layer2.0.bn1.weight"] == "backbone"
    frozen_bn = build_model(TubeDETRConfig(**BASE), device="cpu").state_dict()
    with pytest.raises(ValueError, match="norms"):
        load_pretrained(model, {"model": frozen_bn})
    missing, _ = load_pretrained(model, {"model": model.state_dict()})
    assert missing == []


@pytest.mark.parametrize("flags", [dict(no_tsa=True), dict(position_embedding="learned")],
                         ids=["no_tsa", "learned"])
def test_tp_split_counts_jax_leaves(flags):
    from tubedetr_tpu.parallel.tp import tp_param_pspecs
    from tubedetr_tpu_torch.parallel.tp import count_tp_sharded

    kw = {**BASE, **flags}
    variables = jax_variables(kw)
    specs = tp_param_pspecs(variables["params"], 2, kw["nheads"], kw["text_heads"])
    want = sum(any(a is not None for a in s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    _, model = port_model(kw, variables)
    assert want > 0
    assert count_tp_sharded(model, 2, kw["nheads"], kw["text_heads"]) == want


def test_pipelined_no_tsa_decoder_matches_sequential():
    """``parallel/pp.py``'s decoder stack over no-TSA layers, on one process
    in two microbatches, in both compute dtypes: the sequential stack's
    outputs and (B, T, 1) TSA weights to the bit."""
    from tubedetr_tpu_torch.models.transformer import Decoder
    from tubedetr_tpu_torch.parallel.pp import PipeMesh, pipelined_decoder_apply

    torch.manual_seed(0)
    dec = Decoder(2, 32, 4, 64, 0.0, no_tsa=True).eval()
    b, t, s, d = 2, 6, 5, 32
    tgt, qp = torch.randn(b, t, d), torch.randn(b, t, d)
    mem, mpos = torch.randn(b, t, s, d), torch.randn(b, t, s, d)
    mmask, qmask = torch.rand(b, t, s) > 0.7, torch.zeros(b, t, dtype=torch.bool)
    mmask[..., 0] = False
    for dtype in (None, torch.bfloat16):
        hs, tsa, cross = pipelined_decoder_apply(dec.layers, tgt, qp, mem, mpos, mmask, qmask,
                                                 mesh=PipeMesh(), microbatches=2, dtype=dtype)
        assert tsa.shape == (2, b, t, 1)
        from tubedetr_tpu_torch.models.layers import computing_in

        with computing_in(dec, dtype), torch.no_grad():
            y, want = tgt, []
            for layer in dec.layers:
                y, w, cw = layer(y, qp, mem, mpos, mmask, qmask)
                want.append((y, w, cw))
        for got, ref in zip((hs, tsa, cross), zip(*want)):
            assert got.dtype == ref[0].dtype == (dtype or torch.float32)
            assert torch.equal(got.detach(), torch.stack(ref))
