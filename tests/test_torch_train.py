"""The port's training step, dropout, epoch loop and evaluation against the JAX package.

The tiny full model of ``tests/test_torch_model.py`` (resnet14, text hidden
48, 2+2 layers, T=6, stride 2) with the fast branch, aux, sted and
guided-attention losses, on two synthetic videos of 6 and 5 frames (a
``dur % stride != 0`` tail clip), batch 2. The same JAX variables go into
both packages (``params_from_jax``) and both collate the same synthetic
samples. Dropout is off on both sides (the JAX step's ``deterministic=True``,
the port's dropout-free step): the two RNGs cannot give the same masks.

Held against ``make_train_step(deterministic=True)`` and a jitted
``jax.grad`` of the same loss: every scaled loss term (rtol 1e-5, the
float32 sums of a tiny model in another order), every trainable
parameter's gradient leaf by leaf through ``params_from_jax`` (its
transposes, splits and unstacking are linear, so it carries gradients as it
carries weights), the pre-clip ``grad_norm`` (rtol 1e-4), and the post-step
parameters and EMA parameters.

The gradient bound is atol 1e-4 of the leaf's largest |g| (the float32
backward of a 14-layer conv trunk and the transformer, summed in another
order; the worst leaf measured 7e-6 of it) plus 1e-6: two leaves have an
exact gradient of zero (RoBERTa's key bias and the sted head's last bias,
each under a softmax that a constant shift leaves unchanged), and both
packages give float32 noise of up to 3e-7 there.

The parameter bound is atol 2e-5, the JAX package's own bound for this step
(``tests/test_grad_accum.py``), plus what the two steps' gradients' own
difference explains: AdamW's first step moves a parameter by ``lr * u(g)``
with ``u(g) = g / (|g| + 1e-8)`` of the clipped gradient, so an element whose
clipped gradient is near 1e-8 or below, where ``u`` is about ``g / 1e-8``,
steps by ``lr * |u(g_port) - u(g_jax)|`` more or less on one side. Each
``g`` is the step's own clipped gradient, read back from its AdamW first
moment (``m = (1 - beta1) * g`` after one step): a gradient from another
program (a separate ``jax.grad``, or the port's backward on another thread
count) sums near-zero elements in another order, and on one ``input_proj``
element whose clipped gradient is about 3e-10 that alone moved the step by
1.4e-5 (gradients of 9.7e-8 and 1.44e-7 against the JAX step's own, of the
other sign). The test checks that the second term widens the bound for
under 1% of the elements. The frozen-text-encoder step runs SGD (an update
linear in the gradient), held to atol 1e-7 plus rtol 1e-6 (a few float32
ulps: the momentum, update and EMA summed in another order). Every test
runs on one torch thread (``tests/torch_threads.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_model import TINY, random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.data.collate import collate as jax_collate
from tubedetr_tpu.data.collate import split_video_into_clips as jax_split
from tubedetr_tpu.data.synthetic import annotation_for_sample as jax_annotation
from tubedetr_tpu.data.synthetic import make_synthetic_sample as jax_sample
from tubedetr_tpu.eval.viou import VIoUEvaluator as JaxVIoU
from tubedetr_tpu.losses.criterion import SetCriterion as JaxCriterion
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.train_step import create_train_state as jax_create_state
from tubedetr_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from tubedetr_tpu.parallel.train_step import make_train_step as jax_make_train_step
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu.train import engine as jax_engine
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.data.collate import collate, collate_pairs, model_inputs
from tubedetr_tpu_torch.data.synthetic import SyntheticDataset, make_synthetic_sample
from tubedetr_tpu_torch.eval.viou import VIoUEvaluator
from tubedetr_tpu_torch.interop.from_jax import params_from_jax
from tubedetr_tpu_torch.models.layers import Dropout
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.parallel.train_step import (
    create_train_state,
    expand_pad_masks,
    make_eval_step,
    make_train_step,
    to_device,
)
from tubedetr_tpu_torch.train import engine

T, STRIDE, DURATIONS = 6, 2, (6, 5)
LRS = {"lr": 1e-3, "lr_backbone": 1e-4, "lr_text_encoder": 1e-3}
KW = dict(TINY, batch_size=2, ema=True, ema_decay=0.9, clip_max_norm=0.1, weight_decay=1e-4,
          lr=LRS["lr"], lr_backbone=LRS["lr_backbone"], text_encoder_lr=LRS["lr_text_encoder"])
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5
GROUP_LR = {"main": LRS["lr"], "backbone": LRS["lr_backbone"], "text": LRS["lr_text_encoder"],
            "frozen": 0.0}
BETA1 = 0.9  # AdamW's, in both packages


def jax_batch(kw):
    samples = [jax_sample(i, t=d, vocab=kw["text_vocab_size"]) for i, d in enumerate(DURATIONS)]
    return jax_collate(samples, T, STRIDE, kw["max_text_len"])[0]


def port_batch(kw):
    samples = [make_synthetic_sample(i, t=d, vocab=kw["text_vocab_size"])
               for i, d in enumerate(DURATIONS)]
    return collate(samples, T, STRIDE, kw["max_text_len"])


def jax_variables(kw):
    model = jax_build_model(JaxConfig(**kw))
    inputs = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in jax_model_inputs(jax_batch(kw)).items()}
    return model, random_variables(model, inputs)


def port_model(kw, variables):
    cfg = TubeDETRConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    return cfg, model


def to_port_names(tree, variables, cfg):
    """A tree shaped as the JAX params (grads, new params, EMA) under the
    port's parameter names."""
    return params_from_jax({"params": tree, "buffers": variables["buffers"]}, cfg)


def jax_step(kw):
    """(variables, JAX state after one dropout-free step, its metrics)."""
    model, variables = jax_variables(kw)
    cfg = JaxConfig(**kw)
    state, tx, labels = jax_create_state(cfg, variables)
    step = jax_make_train_step(cfg, model, tx, labels, donate=False, deterministic=True)
    new_state, metrics = step(state, jax_batch(kw), {k: np.float32(v) for k, v in LRS.items()},
                              np.int32(0))
    return variables, new_state, {k: np.asarray(v) for k, v in metrics.items()}


def port_step(kw, variables, **extra):
    cfg, model = port_model({**kw, **extra}, variables)
    state = create_train_state(cfg, model)
    state, metrics = make_train_step(cfg, deterministic=True)(state, port_batch(kw), LRS, 0)
    return cfg, state, {k: float(v) for k, v in metrics.items()}


def port_grads(kw, variables, **extra):
    """(loss terms, {name: grad}) of one dropout-free forward and backward."""
    cfg, model = port_model({**kw, **extra}, variables)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, deterministic=True)
    total, losses = step.forward_loss(state, to_device(port_batch(kw), torch.device("cpu")))
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return {k: float(v.detach()) for k, v in losses.items()}, float(total.detach()), grads


@pytest.fixture(scope="module")
def reference():
    """The JAX step (AdamW, clip 0.1, EMA 0.9) and the JAX gradients of the
    same loss, from one set of variables: two compiles for the module."""
    variables, state, metrics = jax_step(KW)
    model = jax_build_model(JaxConfig(**KW))
    criterion = JaxCriterion(JaxConfig(**KW))
    batch = jax.tree_util.tree_map(jax.numpy.asarray, jax_batch(KW))

    def loss_fn(params):
        out = model.apply({"params": params, "buffers": variables["buffers"]},
                          **jax_model_inputs(batch), deterministic=True, train=True)
        losses = criterion(out, batch["target_boxes"], batch["inter_idx"], batch["time_mask"])
        return criterion.total(losses), losses

    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
    return variables, state, metrics, jax.tree_util.tree_map(np.asarray, grads)


def jax_first_moments(jstate, variables):
    """The JAX step's AdamW first moments as one params-shaped tree (zeros
    for the frozen leaves, which have no state)."""
    from optax.transforms import _masking

    masked = lambda x: isinstance(x, _masking.MaskedNode)  # noqa: E731
    tree = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    for group, inner in jstate.opt_state[1].inner_states.items():
        if group == "frozen":
            continue
        mu = inner.inner_state[0].mu
        tree = jax.tree_util.tree_map(lambda t, m: t if masked(m) else np.asarray(m), tree, mu,
                                      is_leaf=masked)
    return tree


def adamw_atol(state, jmoments):
    """{name: per-element atol} of the post-step parameters: ``PARAM_ATOL``
    plus ``lr * |u(g) - u(g_jax)|`` of the two steps' own clipped gradients
    (each AdamW first moment over ``1 - beta1``; ``jmoments`` the JAX
    step's, under the port's names). Checks that the second term exceeds
    ``PARAM_ATOL`` on under 1% of the elements."""

    def u(m):
        g = m.numpy() / np.float32(1 - BETA1)
        return g / (np.abs(g) + 1e-8)

    atol, loose, total = {}, 0, 0
    for n, p in state.model.named_parameters():
        t = np.full(p.shape, PARAM_ATOL, np.float32)
        if p.requires_grad:
            extra = GROUP_LR[state.labels[n]] * np.abs(
                u(state.optimizer.state[p]["exp_avg"]) - u(jmoments[n]))
            t = t + extra
            loose += int((extra > PARAM_ATOL).sum())
        total += p.numel()
        atol[n] = t
    assert loose < 0.01 * total, (loose, total)
    return atol


def assert_leaves_close(ours: dict, ref: dict, atol: dict, what: str, rtol: float = 0.0):
    for n, tol in atol.items():
        diff = np.abs(ours[n].detach().numpy() - ref[n].numpy())
        tol = tol + rtol * np.abs(ref[n].numpy())
        assert (diff <= tol).all(), f"{what} {n}: max |diff| {diff.max()}, over by {(diff - tol).max()}"


def test_train_step_matches_jax(reference):
    variables, jstate, jmetrics, _ = reference
    cfg, state, metrics = port_step(KW, variables)
    # every loss term and the total
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        rtol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(metrics[k], float(v), rtol=rtol, err_msg=k)
    assert metrics["grad_norm"] > cfg.clip_max_norm  # the clipped regime
    # post-step params and EMA params, leaf by leaf, frozen ones included
    params = dict(state.model.named_parameters())
    atol = adamw_atol(state, to_port_names(jax_first_moments(jstate, variables), variables, cfg))
    assert_leaves_close(params, to_port_names(jstate.params, variables, cfg), atol, "param")
    assert_leaves_close(state.ema_params, to_port_names(jstate.ema_params, variables, cfg),
                        atol, "ema")
    # the frozen stem and layer1 did not move, bit for bit; layer2 did
    before = params_from_jax(variables, cfg)
    for n in ("backbone.0.body.conv1.weight", "backbone.0.body.layer1.0.conv1.weight"):
        assert torch.equal(params[n].detach(), before[n]), n
    assert not torch.equal(params["backbone.0.body.layer2.0.conv1.weight"].detach(),
                           before["backbone.0.body.layer2.0.conv1.weight"])


def test_gradients_match_jax_leaf_by_leaf(reference):
    variables, _, jmetrics, jgrads = reference
    cfg = TubeDETRConfig(**KW)
    losses, total, grads = port_grads(KW, variables)
    np.testing.assert_allclose(total, float(jmetrics["loss_total"]), rtol=LOSS_RTOL)
    ref = to_port_names(jgrads, variables, cfg)
    trainable = [n for n, p in build_model(cfg, device="cpu").named_parameters() if p.requires_grad]
    assert sorted(grads) == sorted(trainable)  # the frozen stem and layer1 have no .grad
    for n in trainable:
        g, r = grads[n].numpy(), ref[n].numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * float(np.abs(r).max()) + 1e-6,
                                   err_msg=f"grad {n}")
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(norm, float(jmetrics["grad_norm"]), rtol=NORM_RTOL)


def test_frozen_text_encoder_step_matches_jax():
    """``freeze_text_encoder``: the text encoder runs in eval mode without a
    graph; its parameters get no gradient, stay put and leave the clip
    norm, as the JAX step's ``frozen`` label arranges. SGD with momentum,
    clipped: the update is linear in the gradient."""
    kw = {**KW, "freeze_text_encoder": True, "optimizer": "sgd"}
    variables, jstate, jmetrics = jax_step(kw)
    cfg, state, metrics = port_step(kw, variables)
    for k, v in jmetrics.items():
        rtol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(metrics[k], float(v), rtol=rtol, err_msg=k)
    params = dict(state.model.named_parameters())
    atol = {n: 1e-7 for n in params}
    assert_leaves_close(params, to_port_names(jstate.params, variables, cfg), atol, "param", 1e-6)
    assert_leaves_close(state.ema_params, to_port_names(jstate.ema_params, variables, cfg), atol,
                        "ema", 1e-6)
    text = [n for n in params if n.startswith("transformer.text_encoder.")]
    assert text and all(params[n].grad is None for n in text)


def test_share_backbone_train_equals_two_full_passes(reference):
    """The fast pass reusing the slow features of every k-th frame gives the
    unshared two-pass step's loss and gradients."""
    variables = reference[0]
    losses_on, total_on, grads_on = port_grads(KW, variables, share_backbone_train=True)
    losses_off, total_off, grads_off = port_grads(KW, variables, share_backbone_train=False)
    assert losses_on == pytest.approx(losses_off, rel=1e-6, abs=0)
    for n, g in grads_on.items():
        np.testing.assert_allclose(g.numpy(), grads_off[n].numpy(), rtol=1e-5, atol=1e-9, err_msg=n)


def test_remat_and_compact_masks_change_nothing(reference):
    """``remat_backbone`` off (the blocks' activations kept) and
    ``compact_pad_masks`` (the pad masks rebuilt from valid extents by
    ``expand_pad_masks``) give the default step's loss and gradients."""
    variables = reference[0]
    losses, total, grads = port_grads(KW, variables)
    assert TubeDETRConfig(**KW).remat_backbone
    runs = {"remat-off": port_grads(KW, variables, remat_backbone=False)}
    cfg, model = port_model(KW, variables)
    state = create_train_state(cfg, model)
    samples = [make_synthetic_sample(i, t=d, vocab=KW["text_vocab_size"])
               for i, d in enumerate(DURATIONS)]
    compact = collate(samples, T, STRIDE, KW["max_text_len"], compact_pad_masks=True)
    dense = port_batch(KW)
    assert "fast_pad_mask" not in compact and compact["fast_valid_hw"].shape == (2, T, 2)
    for stream in ("fast", "slow"):
        frames = compact[f"frames_{stream}"]
        assert torch.equal(expand_pad_masks(compact[f"{stream}_valid_hw"], *frames.shape[2:4]),
                           dense[f"{stream}_pad_mask"])
    c_total, c_losses = make_train_step(cfg, deterministic=True).forward_loss(
        state, to_device(compact, torch.device("cpu")))
    c_total.backward()
    runs["compact"] = ({k: float(v.detach()) for k, v in c_losses.items()}, float(c_total.detach()),
                       {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    for name, (l2, t2, g2) in runs.items():
        assert l2 == losses and t2 == total, name
        assert all(torch.equal(g2[n], g) for n, g in grads.items()), name


def test_grad_accum_two_equals_one_batch_of_two(reference):
    """Two microbatches of one video equal the batch of two: the loss terms
    (global ``num_boxes``, batch means scaled by 1/2) and, with SGD and no
    clip (an update linear in the gradient), the post-step parameters."""
    variables = reference[0]
    kw = {**KW, "optimizer": "sgd", "clip_max_norm": 0.0}
    out = {a: port_step(kw, variables, grad_accum=a) for a in (1, 2)}
    (_, s1, m1), (_, s2, m2) = out[1], out[2]
    assert set(m1) == set(m2)
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=2e-5, atol=1e-7, err_msg=k)
    p2 = dict(s2.model.named_parameters())
    for n, p in s1.model.named_parameters():
        np.testing.assert_allclose(p2[n].detach().numpy(), p.detach().numpy(), rtol=0, atol=1e-7,
                                   err_msg=n)


# ---- dropout ---------------------------------------------------------------

def count_jax_dropout_sites(kw):
    import flax.linen as nn

    model, variables = jax_variables(kw)
    calls = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            if context.module.rate > 0:
                calls.append(context.module.rate)
        return next_fun(*args, **kwargs)

    batch = jax.tree_util.tree_map(jax.numpy.asarray, jax_batch(kw))
    with nn.intercept_methods(interceptor):
        jax.eval_shape(lambda v: model.apply(v, **jax_model_inputs(batch), deterministic=False,
                                             train=True, rngs={"dropout": jax.random.PRNGKey(0)}),
                       variables)
    return sorted(calls)


def count_port_dropout_sites(model, batch):
    calls = []
    hooks = [m.register_forward_hook(lambda m, i, o: calls.append(m.p)) for m in model.modules()
             if isinstance(m, Dropout) and m.p > 0]
    model.train()
    with torch.no_grad():
        model(**model_inputs(batch), train=True)
    for h in hooks:
        h.remove()
    return sorted(calls)


@pytest.mark.parametrize("extra", [dict(), dict(fast_mode="transformer")],
                         ids=["default", "fast-transformer"])
def test_dropout_sites_match_jax(extra):
    kw = {**TINY, "dropout": 0.1, **extra}
    _, variables = jax_variables(kw)
    _, model = port_model(kw, variables)
    assert count_port_dropout_sites(model, port_batch(kw)) == count_jax_dropout_sites(kw)


def test_dropout_only_in_train_mode_and_seeded(reference):
    variables = reference[0]
    kw = {**KW, "dropout": 0.1}
    batch = port_batch(kw)

    def run(deterministic, seed):
        cfg, model = port_model(kw, variables)
        state = create_train_state(cfg, model)
        return make_train_step(cfg, deterministic)(state, batch, LRS, seed)

    a = run(False, 0)
    b = run(False, 0)
    c = run(False, 1)
    d = run(True, 0)
    pa, pb = dict(a[0].model.named_parameters()), dict(b[0].model.named_parameters())
    assert all(torch.equal(pa[n], pb[n]) for n in pa)  # one seed reproduces the step
    assert a[1]["loss_total"] == b[1]["loss_total"]
    assert a[1]["loss_total"] != c[1]["loss_total"]  # another seed draws other masks
    assert a[1]["loss_total"] != d[1]["loss_total"]  # dropout was on in the step
    # after the step the model is in eval mode: the inference forward has no dropout
    model = a[0].model
    assert not model.training
    with torch.no_grad():
        o1, o2 = model(**model_inputs(batch)), model(**model_inputs(batch))
    assert torch.equal(o1["pred_boxes"], o2["pred_boxes"])


# ---- the epoch loop and evaluation ----------------------------------------

def f32(lrs):
    """The LRs as the JAX loop hands them to its step, in float32."""
    return {k: np.float32(v) for k, v in lrs.items()}


class Recorder:
    """A train step that records the LRs it is given and returns ``loss``."""

    def __init__(self, loss=1.0):
        self.lrs, self.loss = [], loss

    def __call__(self, state, batch, lrs, seed):
        self.lrs.append(f32(lrs))
        return state, {"loss_total": np.float32(self.loss), "loss_bbox": np.float32(self.loss)}


@pytest.mark.parametrize("schedule", ["linear_with_warmup", "all_linear_with_warmup"])
def test_train_one_epoch_logs_the_jax_lr_sequence(reference, schedule):
    """Two epochs of three steps: step 0 at the base LRs, every later step
    at the schedule of the step before (across the epoch boundary too). The
    port's real step runs epoch 0 and logs its LRs."""
    variables = reference[0]
    kw = {**KW, "schedule": schedule, "fraction_warmup_steps": 0.5, "epochs": 2, "lr_drop": 1}
    pairs = collate_pairs([make_synthetic_sample(i, t=T, vocab=kw["text_vocab_size"])
                           for i in range(6)], 2, T, STRIDE, kw["max_text_len"])
    jcfg, cfg = JaxConfig(**kw), TubeDETRConfig(**kw)
    ours, ref = Recorder(), Recorder()
    for epoch in (0, 1):
        jax_engine.train_one_epoch(jcfg, ref, None, pairs, epoch, 6)
        engine.train_one_epoch(cfg, ours, None, pairs, epoch, 6)
    assert ours.lrs == ref.lrs and len(ref.lrs) == 6
    _, model = port_model(kw, variables)
    state = create_train_state(cfg, model)
    seen = []
    step = make_train_step(cfg)
    _, stats = engine.train_one_epoch(
        cfg, lambda s, b, lrs, seed: (seen.append(lrs), step(s, b, lrs, seed))[1], state, pairs, 0, 6)
    assert [f32(lrs) for lrs in seen] == ref.lrs[:3]
    assert state.step == 3 and math.isfinite(stats["loss"])


def test_train_one_epoch_exits_1_on_a_nan_loss():
    cfg = TubeDETRConfig(**KW)
    with pytest.raises(SystemExit) as exc:
        engine.train_one_epoch(cfg, Recorder(float("nan")), None, [({}, {})] * 2, 0, 2)
    assert exc.value.code == 1


def test_evaluate_matches_jax_viou(reference):
    """``evaluate`` with the EMA parameters (the JAX step's, moved by
    ``params_from_jax``) over a synthetic val set of 12-frame videos split
    into 6-frame clips (``div_vid``): the JAX ``evaluate``'s vIoU summary
    within 1e-5 an entry (the boxes agree within the forward's 2e-4; the
    segments are argmaxes and must be equal)."""
    variables, jstate = reference[0], reference[1]
    kw = KW
    jcfg = JaxConfig(**kw)
    jmodel = jax_build_model(jcfg)
    jsamples = [jax_sample(10 + i, t=12, vocab=kw["text_vocab_size"]) for i in range(3)]
    jpairs = []
    for i in range(0, 3, 2):
        clips = [c for s in jsamples[i:i + 2] for c in jax_split(s, T)]
        jpairs.append(jax_collate(clips, T, STRIDE, kw["max_text_len"]))
    ds = SyntheticDataset(n=3, t=12, seed=10, vocab=kw["text_vocab_size"], text_len=6)
    jev = JaxVIoU([jax_annotation(s) for s in jsamples])
    jax_engine.evaluate(jcfg, jax_make_eval_step(jcfg, jmodel, ema=True), jstate, jpairs, jev)
    ref = jev.summarize()

    cfg, model = port_model(kw, variables)
    state = create_train_state(cfg, model)
    state.ema_params = to_port_names(jstate.ema_params, variables, cfg)
    ev = VIoUEvaluator(ds.annotations)
    pairs = collate_pairs(ds.samples, 2, T, STRIDE, kw["max_text_len"], div_vid=T)
    stats = engine.evaluate(cfg, make_eval_step(cfg, ema=True), state, pairs, ev)
    ours = ev.summarize()
    assert set(ours) == set(ref) and stats
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-5), k
