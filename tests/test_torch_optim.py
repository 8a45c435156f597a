"""The port's LR schedules, parameter groups, clip, optimizers and EMA against ``tubedetr_tpu.train.optim``.

* ``schedule_gammas`` / ``current_lrs`` equal the JAX ones at every step of
  two epochs, for all four schedules.
* ``label_params`` on the tiny model equals the JAX label tree, carried to
  the port's names by ``params_from_jax`` (a label is a constant leaf, which
  its transposes and splits keep), by default and under
  ``freeze_text_encoder``, ``lr_backbone=0`` and ``freeze_backbone``.
* Three steps of clip + AdamW (or SGD) + EMA on a small tree with all four
  groups against the JAX chain (``build_optimizer``, ``mask_frozen_grads``,
  ``scale_updates_by_lr``, ``ema_update``), with the clip active and not:
  parameters and EMA within rtol 1e-5 / atol 1e-7 (float32, the same update
  in another order), the pre-clip norm within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_model import TINY, random_variables
from tests.test_torch_train import jax_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.models.tubedetr import build_model as jax_build_model
from tubedetr_tpu.parallel.train_step import model_inputs as jax_model_inputs
from tubedetr_tpu.train import optim as jax_optim
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.train import optim

SCHEDULES = ["step", "multistep", "linear_with_warmup", "all_linear_with_warmup"]
CODES = {"main": 0.0, "backbone": 1.0, "text": 2.0, "frozen": 3.0}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_jax(schedule):
    kw = dict(schedule=schedule, epochs=120, lr_drop=1, fraction_warmup_steps=0.1)
    n_steps, per_epoch = 40, 20
    jcfg, cfg = JaxConfig(**kw), TubeDETRConfig(**kw)
    for epoch in (0, 1, 60):
        for i in range(per_epoch):
            step = epoch * per_epoch + i
            assert optim.schedule_gammas(cfg, epoch, step, n_steps) == \
                tuple(jax_optim.schedule_gammas(jcfg, epoch, step, n_steps))
            assert optim.current_lrs(cfg, epoch, step, n_steps) == \
                jax_optim.current_lrs(jcfg, epoch, step, n_steps)


@pytest.mark.parametrize("extra", [dict(), dict(freeze_text_encoder=True), dict(lr_backbone=0.0),
                                   dict(freeze_backbone=True)],
                         ids=["default", "freeze-text", "lr-backbone-0", "freeze-backbone"])
def test_label_params_matches_jax(extra):
    kw = {**TINY, **extra}
    model = jax_build_model(JaxConfig(**kw))
    inputs = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in jax_model_inputs(jax_batch(kw)).items()}
    variables = random_variables(model, inputs)
    labels = jax_optim.label_params(variables["params"], JaxConfig(**kw))
    codes = jax.tree_util.tree_map(lambda p, lab: np.full(p.shape, CODES[lab], np.float32),
                                   variables["params"], labels)
    cfg = TubeDETRConfig(**kw)
    want = params_from_jax({"params": codes, "buffers": variables["buffers"]}, cfg)
    ours = optim.label_params(build_model(cfg, device="cpu"))
    assert set(ours) <= set(want)
    for name, label in ours.items():
        vals = np.unique(want[name].numpy())
        assert vals.tolist() == [CODES[label]], (name, label, vals)


class Small(nn.Module):
    """One parameter a group, named as the model names them."""

    def __init__(self, rng):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.from_numpy(rng.randn(*shape).astype(np.float32)))

        self.backbone = nn.ParameterDict({"conv1": p(3, 4), "layer2": p(4, 5)})
        self.backbone["conv1"].requires_grad_(False)  # the always-frozen stem
        self.transformer = nn.Module()
        self.transformer.text_encoder = nn.ParameterDict({"w": p(6)})
        self.head = nn.ParameterDict({"w": p(5, 2), "b": p(2)})


PORT_TO_JAX = {"backbone.conv1": ("backbone", "conv1", "kernel"),
               "backbone.layer2": ("backbone", "layer2_0", "kernel"),
               "transformer.text_encoder.w": ("text_encoder", "w"),
               "head.w": ("head", "w"), "head.b": ("head", "b")}


def jax_tree(flat):
    tree = {}
    for name, arr in flat.items():
        *path, leaf = PORT_TO_JAX[name]
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def jax_flat(tree):
    out = {}
    for name, path in PORT_TO_JAX.items():
        node = tree
        for k in path:
            node = node[k]
        out[name] = np.asarray(node)
    return out


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clipped", "unclipped"])
def test_clip_optimizer_ema_steps_match_jax(optimizer, grad_scale):
    kw = dict(optimizer=optimizer, clip_max_norm=0.1, weight_decay=1e-2, ema=True, ema_decay=0.9)
    cfg, jcfg = TubeDETRConfig(**kw), JaxConfig(**kw)
    rng = np.random.RandomState(0)
    model = Small(rng)
    params0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt, labels = optim.build_optimizer(cfg, model)
    assert labels == {"backbone.conv1": "frozen", "backbone.layer2": "backbone",
                      "transformer.text_encoder.w": "text", "head.w": "main", "head.b": "main"}
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}

    jparams = jax_tree(params0)
    tx, jlabels = jax_optim.build_optimizer(jcfg, jparams)
    jstate, jema = tx.init(jparams), jparams
    for step in range(3):
        lrs = {"lr": 1e-3 * (step + 1), "lr_backbone": 2e-4, "lr_text_encoder": 5e-4 / (step + 1)}
        grads = {n: (rng.randn(*p.shape) * grad_scale).astype(np.float32) for n, p in params0.items()}
        # the port: frozen parameters carry no gradient
        for n, p in model.named_parameters():
            p.grad = torch.tensor(grads[n]) if p.requires_grad else None
        trainable = [p for p in model.parameters() if p.requires_grad]
        norm = optim.clip_grad_norm(trainable, cfg.clip_max_norm)
        optim.set_lrs(opt, lrs)
        opt.step()
        optim.ema_update(ema, dict(model.named_parameters()), cfg.ema_decay)
        # JAX: every leaf has a gradient; the frozen ones are masked first
        g = jax_optim.mask_frozen_grads(jax_tree(grads), jlabels)
        jnorm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g))))
        updates, jstate = tx.update(g, jstate, jparams)
        updates = jax_optim.scale_updates_by_lr(
            updates, jlabels, {k: jnp.float32(v) for k, v in lrs.items()})
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        jema = jax_optim.ema_update(jema, jparams, jcfg.ema_decay)

        assert (float(norm) >= 0.1) == (grad_scale > 1)
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-6)
        for name, ref in jax_flat(jparams).items():
            np.testing.assert_allclose(dict(model.named_parameters())[name].detach().numpy(), ref,
                                       rtol=1e-5, atol=1e-7, err_msg=f"step {step} {name}")
        for name, ref in jax_flat(jema).items():
            np.testing.assert_allclose(ema[name].numpy(), ref, rtol=1e-5, atol=1e-7,
                                       err_msg=f"ema step {step} {name}")
    assert np.array_equal(model.backbone["conv1"].detach().numpy(), params0["backbone.conv1"])
