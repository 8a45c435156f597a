"""The port's losses and matcher against ``tubedetr_tpu.losses``, with no model.

Random output dicts from a numpy seed (sigmoid boxes, softmax TSA rows,
normal logits) go through the JAX functions and the port's on the same
targets: ragged ``time_mask``, aux decoder layers, an empty intersection
(``inter_idx = [-100, -100]``), ``num_queries = 3`` under ``nq_match``
frame and video with the objectness loss, and the gradient accumulation
overrides (``num_boxes``, ``mean_scale``). Each loss term within rtol 1e-5
(float32, the same formulas summed in another order), and the gradient of
the weighted total with respect to every prediction within atol 1e-6 of its
largest entry. ``hungarian`` is held to brute force, as
``tests/test_matcher.py`` holds the JAX one.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.losses import criterion as jax_criterion
from tubedetr_tpu.losses import matcher as jax_matcher
from tubedetr_tpu_torch.config import TubeDETRConfig, loss_weight_dict
from tubedetr_tpu_torch.losses import criterion, matcher

B, T, N_AUX = 3, 7, 2
RTOL, GRAD_ATOL = 1e-5, 1e-6
KW = dict(dec_layers=N_AUX + 1, aux_loss=True, sted=True, guided_attn=True, sigma=1)


def outputs(nq: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)

    def boxes(*shape):
        return (1 / (1 + np.exp(-rng.randn(*shape, 4)))).astype(np.float32)

    def tsa(*shape):
        x = np.exp(rng.randn(*shape, T, T))
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    out = {
        "pred_boxes": boxes(B, T), "aux_pred_boxes": boxes(N_AUX, B, T),
        "pred_sted": rng.randn(B, T, 2).astype(np.float32),
        "aux_pred_sted": rng.randn(N_AUX, B, T, 2).astype(np.float32),
        "weights": tsa(B), "aux_weights": tsa(N_AUX, B),
    }
    if nq > 1:
        out.update({
            "pred_boxes_queries": boxes(B, T, nq), "aux_pred_boxes_queries": boxes(N_AUX, B, T, nq),
            "pred_sted_queries": rng.randn(B, T, nq, 2).astype(np.float32),
            "aux_pred_sted_queries": rng.randn(N_AUX, B, T, nq, 2).astype(np.float32),
            "pred_obj_queries": rng.randn(B, T, nq).astype(np.float32),
            "aux_pred_obj_queries": rng.randn(N_AUX, B, T, nq).astype(np.float32),
        })
    return out


def targets(empty: bool, seed: int = 1):
    rng = np.random.RandomState(seed)
    durations = np.array([T, T - 2, T - 3])
    time_mask = np.arange(T)[None] < durations[:, None]
    inter = np.array([[1, 4], [0, 2], [2, 3]], np.int64)
    if empty:
        inter[1] = -100
    boxes = (1 / (1 + np.exp(-rng.randn(B, T, 4)))).astype(np.float32)
    return boxes, inter, time_mask


CASES = {
    "aux-ragged": (dict(), False, {}),
    "empty-intersection": (dict(), True, {}),
    "nq3-frame": (dict(num_queries=3, nq_match="frame"), False, {}),
    "nq3-video": (dict(num_queries=3, nq_match="video"), True, {}),
    "accum-overrides": (dict(), False, dict(num_boxes=9.0, mean_scale=0.5)),
}


def jax_total(kw, out, tgt, over):
    crit = jax_criterion.SetCriterion(JaxConfig(**kw))
    boxes, inter, mask = tgt
    kwargs = {k: (jnp.float32(v) if k == "num_boxes" else v) for k, v in over.items()}

    def fn(o):
        losses = crit(o, jnp.asarray(boxes), jnp.asarray(inter.astype(np.int32)),
                      jnp.asarray(mask), **kwargs)
        return crit.total(losses), losses

    (total, losses), grads = jax.value_and_grad(fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    return float(total), {k: float(v) for k, v in losses.items()}, grads


def port_total(kw, out, tgt, over):
    crit = criterion.SetCriterion(TubeDETRConfig(**kw))
    boxes, inter, mask = tgt
    o = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    kwargs = {k: (torch.tensor(v) if k == "num_boxes" else v) for k, v in over.items()}
    losses = crit(o, torch.from_numpy(boxes), torch.from_numpy(inter), torch.from_numpy(mask),
                  **kwargs)
    total = crit.total(losses)
    total.backward()
    return (float(total.detach()), {k: float(v.detach()) for k, v in losses.items()},
            {k: v.grad for k, v in o.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_set_criterion_matches_jax(case):
    extra, empty, over = CASES[case]
    kw = {**KW, **extra}
    out, tgt = outputs(kw.get("num_queries", 1)), targets(empty)
    ref_total, ref, ref_grads = jax_total(kw, out, tgt, over)
    total, losses, grads = port_total(kw, out, tgt, over)
    assert set(losses) == set(ref)
    assert set(loss_weight_dict(TubeDETRConfig(**kw))) == set(ref)  # every term is weighted
    for k in ref:
        np.testing.assert_allclose(losses[k], ref[k], rtol=RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(total, ref_total, rtol=RTOL)
    for k, g in grads.items():
        r = np.asarray(ref_grads[k])
        got = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(got, r, rtol=0, atol=GRAD_ATOL * max(1.0, np.abs(r).max()),
                                   err_msg=f"d total / d {k}")


@pytest.mark.parametrize("name", ["loss_boxes", "loss_sted", "loss_guided_attn"])
def test_single_losses_match_jax(name):
    out = outputs(1)
    boxes, inter, mask = targets(empty=True)
    positive = (np.arange(T)[None] >= inter[:, :1]) & (np.arange(T)[None] <= inter[:, 1:]) \
        & (inter[:, :1] >= 0) & mask
    args = {
        "loss_boxes": (out["pred_boxes"], boxes, positive, np.float32(positive.sum())),
        "loss_sted": (out["pred_sted"], inter, mask, 1.0),
        "loss_guided_attn": (out["weights"], positive, mask),
    }[name]

    def conv(a, to):
        return to(a) if isinstance(a, np.ndarray) else a

    ref = getattr(jax_criterion, name)(*(conv(a, jnp.asarray) for a in args))
    ours = getattr(criterion, name)(*(conv(a, torch.from_numpy) for a in args))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=RTOL, err_msg=k)


def brute_force(cost):
    n, m = cost.shape
    if n > m:
        return brute_force(cost.T)
    return min(cost[range(n), list(cols)].sum() for cols in itertools.permutations(range(m), n))


@pytest.mark.parametrize("shape", [(3, 3), (2, 5), (5, 2), (1, 4), (4, 4)])
def test_hungarian_matches_brute_force_and_jax(shape):
    rng = np.random.RandomState(sum(shape))
    for _ in range(5):
        cost = rng.rand(*shape)
        rows, cols = matcher.hungarian(cost)
        assert len(rows) == min(shape) and len(set(cols)) == len(cols)
        np.testing.assert_allclose(cost[rows, cols].sum(), brute_force(cost), rtol=1e-12)
        jr, jc = jax_matcher.hungarian(cost)
        assert rows.tolist() == jr.tolist() and cols.tolist() == jc.tolist()


def test_match_cost_and_single_target_match_jax():
    """The box cost against the JAX one; for one target per frame the
    argmin is the Hungarian optimum of the (nq x 1) cost column."""
    out = outputs(3)
    boxes = targets(empty=False)[0]
    ref = np.asarray(jax_matcher.box_match_cost(jnp.asarray(out["pred_boxes_queries"]),
                                                jnp.asarray(boxes)))
    cost = matcher.box_match_cost(torch.from_numpy(out["pred_boxes_queries"]), torch.from_numpy(boxes))
    np.testing.assert_allclose(cost.numpy(), ref, rtol=1e-5, atol=1e-6)
    qi = matcher.match_single_target(cost).numpy()
    np.testing.assert_array_equal(qi, np.asarray(jax_matcher.match_single_target(jnp.asarray(ref))))
    for b, t in itertools.product(range(B), range(T)):
        rows, _ = matcher.hungarian(cost[b, t].numpy()[:, None])
        assert rows.tolist() == [qi[b, t]]
