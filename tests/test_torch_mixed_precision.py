"""bfloat16 compute with float32 state: the port's mixed precision against the JAX package's.

The tiny full model and batch of ``tests/test_torch_train.py`` (resnet14,
text hidden 48, 2+2 layers, T=6, stride 2, two videos), dropout off on both
sides, ``compute_dtype="bfloat16"``. Every distance below is a root mean
square over the elements compared, and each bound is a fraction of the
JAX package's own bfloat16-vs-float32 distance on the same inputs (``D``):
``BF16_FRACTION = 0.5`` of it. A port that computed in float32 would sit
about ``D`` from the JAX bfloat16 step, so each test also checks that the
port's own bfloat16 step is farther than the bound from its float32 step.

The trunk's output is handed over. The JAX bfloat16 model is sensitive
enough that nudging one input pixel by one bfloat16 ulp moves its outputs
by 0.27-0.68 of ``D``, and XLA and oneDNN sum a convolution's float32
products in different orders, which rounds 16 of the 196608 stem outputs
of this batch to the neighbouring bfloat16 value. So the comparison of the
step feeds the port's model the JAX trunk's output (``backbone_feats``, the
same bits as inside the JAX step) in place of its own, with the gradient
passed through to the port's own trunk: the trunk still runs and its
gradients are compared. The trunk alone is held in
``test_trunk_bf16_matches_jax``: most outputs equal to the bit, the rest
within ``BF16_FRACTION * D``.

Where XLA rounds: every op rounds to bfloat16, except where a float32
consumer reads it (``models/layers.py`` says where); with the trunk handed
over, the forward's outputs and loss terms are equal to the JAX step's to
the bit. The backward rounds in other places than XLA's, which the
gradient bound takes (measured: the gradient 0.16 of ``D``, ``grad_norm``
0.22, the post-step parameters and EMA 0.42). The JAX package's bfloat16
backward is itself less exact than the port's in places: with one encoder
layer instead of two, its ``input_proj`` weight gradient sits 3.5% above
the float32 one (the port's within 0.003%), which puts the port's
``grad_norm`` 2.5 ``D`` from it.

Remat: the four ``remat_policy`` settings (``full``, ``save_mid``,
``save_acts`` and remat off) give gradients equal to the bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train import (
    KW,
    LRS,
    jax_batch,
    jax_step,
    jax_variables,
    port_batch,
    port_model,
    to_port_names,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.losses.criterion import SetCriterion as JaxCriterion
from tubedetr_tpu.models.tubedetr import TubeDETR as JaxTubeDETR
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.train_step import create_train_state as jax_create_state
from tubedetr_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu_torch.parallel.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    to_device,
)

BF16_FRACTION = 0.5
KWB = dict(KW, compute_dtype="bfloat16")
CPU = torch.device("cpu")


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def flat(tree: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(tree[n], np.float64).ravel() for n in names])


class _Handover(torch.autograd.Function):
    """``given`` in the forward; the gradient to ``own`` in the backward."""

    @staticmethod
    def forward(ctx, own, given):
        return given.to(own.dtype).clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def hand_over(model, feats):
    """Each call of ``model.backbone_feats`` returns the next of ``feats``."""
    own, queue = type(model).backbone_feats, list(feats)
    model.backbone_feats = lambda frames: _Handover.apply(own(model, frames), queue.pop(0))
    return model


def jax_grads(kw, variables, batch):
    model = jax_build_model(JaxConfig(**kw))
    crit = JaxCriterion(JaxConfig(**kw))

    def loss_fn(params):
        out = model.apply({"params": params, "buffers": variables["buffers"]},
                          **jax_model_inputs(batch), deterministic=True, train=True)
        return crit.total(crit(out, batch["target_boxes"], batch["inter_idx"],
                               batch["time_mask"]))

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"]))


def jax_trunk(kw, variables, frames, chunk: int) -> torch.Tensor:
    """The JAX trunk's output for flat (N, H, W, 3) frames, as float32, in
    chunks of ``chunk`` frames (one compile for every call of a dtype; the
    trunk treats each frame alone)."""
    fn = _trunk_fns.get(kw["compute_dtype"])
    if fn is None:
        model = jax_build_model(JaxConfig(**kw))
        fn = _trunk_fns[kw["compute_dtype"]] = jax.jit(
            lambda v, f: model.apply(v, f, method=JaxTubeDETR.backbone_feats))
    parts = [np.asarray(fn(variables, frames[i:i + chunk]), np.float32)
             for i in range(0, frames.shape[0], chunk)]
    return torch.from_numpy(np.concatenate(parts))


_trunk_fns = {}


@pytest.fixture(scope="module")
def reference():
    """The JAX steps and gradients in both dtypes, and the JAX trunk's
    outputs of the training step (slow frames, then the fast pass's other
    frames) and of the inference forward (every fast frame)."""
    _, variables = jax_variables(KW)
    batch = jax.tree_util.tree_map(jnp.asarray, jax_batch(KW))
    steps = {k: jax_step(kw)[1:] for k, kw in (("bf16", KWB), ("f32", KW))}
    grads = {k: jax_grads(kw, variables, batch) for k, kw in (("bf16", KWB), ("f32", KW))}
    mi = jax_model_inputs(batch)
    b, tc = mi["frames_slow"].shape[:2]
    k, ff = KW["stride"], mi["frames_fast"]
    t = ff.shape[1]
    ff_pad = jnp.pad(ff, ((0, 0), (0, tc * k - t)) + ((0, 0),) * 3)
    rest = ff_pad.reshape((b, tc, k) + ff.shape[2:])[:, :, 1:].reshape((-1,) + ff.shape[2:])
    slow = mi["frames_slow"].reshape((-1,) + ff.shape[2:])
    n = slow.shape[0]  # the trunk's values do not depend on stop_gradient or the batch
    train_feats = [jax_trunk(KWB, variables, slow, n), jax_trunk(KWB, variables, rest, n)]
    eval_feats = [jax_trunk(KWB, variables, ff.reshape((-1,) + ff.shape[2:]), n)]
    return variables, steps, grads, train_feats, eval_feats


def port_step(kw, variables, feats=None):
    """(state, metrics, grads) of one dropout-free port step."""
    cfg, model = port_model(kw, variables)
    if feats is not None:
        hand_over(model, feats)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, deterministic=True)
    total, _ = step.forward_loss(state, to_device(port_batch(kw), CPU))
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    state.optimizer.zero_grad(set_to_none=True)
    if feats is not None:
        hand_over(model, feats)
    state, metrics = step(state, port_batch(kw), LRS, 0)
    return cfg, state, {k: float(v) for k, v in metrics.items()}, grads


def test_train_step_bf16_matches_jax(reference):
    variables, steps, jgrads, train_feats, _ = reference
    cfg, state, metrics, grads = port_step(KWB, variables, train_feats)
    (jb_state, jb_metrics), (j32_state, j32_metrics) = steps["bf16"], steps["f32"]
    # every loss term and the total; grad_norm
    assert set(metrics) == set(jb_metrics)
    for k in jb_metrics:
        d = abs(float(jb_metrics[k]) - float(j32_metrics[k]))
        assert abs(metrics[k] - float(jb_metrics[k])) <= BF16_FRACTION * d, (k, metrics[k], d)
    # the gradient, all leaves as one vector, through params_from_jax
    names = sorted(grads)
    gb, g32 = (to_port_names(jgrads[k], variables, cfg) for k in ("bf16", "f32"))
    d = rms(flat(gb, names) - flat(g32, names))
    assert rms(flat(grads, names) - flat(gb, names)) <= BF16_FRACTION * d
    # the post-step parameters and EMA
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    for what, ours, ref, ref32 in (("param", params, jb_state.params, j32_state.params),
                                   ("ema", state.ema_params, jb_state.ema_params,
                                    j32_state.ema_params)):
        ref, ref32 = to_port_names(ref, variables, cfg), to_port_names(ref32, variables, cfg)
        d = rms(flat(ref, names) - flat(ref32, names))
        assert rms(flat(ours, names) - flat(ref, names)) <= BF16_FRACTION * d, what
    # float32 state: parameters, gradients, AdamW moments, EMA
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(g.dtype == torch.float32 for g in grads.values())
    moments = [v for st in state.optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert all(v.dtype == torch.float32 for v in state.ema_params.values())
    # the port's bfloat16 gradient is farther from its float32 one than the bound
    _, _, _, own32 = port_step(KW, variables)
    assert rms(flat(grads, names) - flat(own32, names)) > BF16_FRACTION * d


def test_eval_forward_bf16_matches_jax(reference):
    """``make_eval_step`` in bfloat16 (one trunk pass shared by the slow and
    fast streams), the trunk handed over: each output within
    ``BF16_FRACTION`` of its bfloat16-vs-float32 distance, and the port's
    own bfloat16 outputs farther than that from its float32 ones."""
    variables, _, _, _, eval_feats = reference
    outs = {}
    for name, kw in (("bf16", KWB), ("f32", KW)):
        jcfg = JaxConfig(**kw)
        jstate = jax_create_state(jcfg, variables)[0]
        jout, _ = jax_make_eval_step(jcfg, jax_build_model(jcfg))(jstate, jax_batch(kw))
        cfg, model = port_model(kw, variables)
        if name == "bf16":
            hand_over(model, eval_feats)
        pout, _ = make_eval_step(cfg)(create_train_state(cfg, model), port_batch(kw))
        outs[name] = ({k: np.asarray(v, np.float32) for k, v in jout.items()},
                      {k: v.numpy() for k, v in pout.items()})
    (jb, pb), (j32, p32) = outs["bf16"], outs["f32"]
    assert set(pb) == set(jb)
    for k in jb:
        d = rms(jb[k] - j32[k])
        assert rms(pb[k] - jb[k]) <= BF16_FRACTION * d, k
        assert rms(pb[k] - p32[k]) > BF16_FRACTION * d, k


def test_trunk_bf16_matches_jax(reference):
    """The port's own bfloat16 trunk on the batch's slow frames: at least
    90% of its outputs equal to the JAX trunk's to the bit (the rest differ
    by the convolutions' summation order), and within ``BF16_FRACTION`` of
    the trunk's bfloat16-vs-float32 distance."""
    variables, _, _, train_feats, _ = reference
    frames = np.asarray(jax_model_inputs(jax_batch(KW))["frames_slow"])
    frames = frames.reshape((-1,) + frames.shape[2:])
    _, model = port_model(KWB, variables)
    with torch.no_grad():
        ours = model.backbone_feats(torch.from_numpy(frames)).float().numpy()
    jb, j32 = train_feats[0].numpy(), jax_trunk(KW, variables, frames, frames.shape[0]).numpy()
    assert (ours == jb).mean() >= 0.9
    assert rms(ours - jb) <= BF16_FRACTION * rms(jb - j32)


def test_cast_compute_changes_no_bit(reference):
    """Serving's ``cast_compute`` (the cast-at-use weights stored in
    bfloat16) gives the forward of the float32-parameter model to the bit."""
    variables = reference[0]
    outs = []
    for cast in (False, True):
        cfg, model = port_model(KWB, variables)
        if cast:
            model.cast_compute()
            assert model.input_proj.weight.dtype == torch.bfloat16
            assert model.query_embed.weight.dtype == torch.float32
            assert model.transformer.decoder.norm.weight.dtype == torch.float32
        outs.append(make_eval_step(cfg)(create_train_state(cfg, model), port_batch(KWB))[0])
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


@pytest.fixture(scope="module")
def remat_full(reference):
    return port_step(dict(KWB, remat_policy="full"), reference[0])[3]


@pytest.mark.parametrize("policy", ["full", "save_mid", "save_acts", "off"])
def test_remat_policies_give_equal_gradients(reference, remat_full, policy):
    """What each policy keeps changes no gradient: bit-equal to ``full``
    (in bfloat16, where the trunk's blocks are recomputed in the backward)."""
    kw = dict(KWB, remat_backbone=False) if policy == "off" else dict(KWB, remat_policy=policy)
    grads = port_step(kw, reference[0])[3]
    assert sorted(grads) == sorted(remat_full)
    assert any(n.startswith("backbone.0.body.layer2") for n in grads)
    for n, g in grads.items():
        assert torch.equal(g, remat_full[n]), n
