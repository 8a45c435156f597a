"""The port's other inference configurations against the JAX model.

Each ``fast_mode`` (gating, transformer, pool, noslow) and ``num_queries=3``
run through ``tubedetr_tpu.models.tubedetr.TubeDETR`` and the port's
``TubeDETR`` on the CPU in float32 with the same weights (the JAX variables
moved with ``params_from_jax``) and the same numpy inputs; every output key,
``*_queries`` and ``pred_obj_queries`` included, agrees to the atol of
``tests/test_torch_model.py``. The variants' weight names round-trip through
the JAX package's ``convert_tubedetr`` and load with ``load_pretrained``,
and ``validate()`` accepts and refuses what the JAX one does.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_model import ATOL, T, TINY, jax_forward, make_batch, port_forward, port_model
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax
from tubedetr_tpu_torch.train.checkpoint import load_pretrained
from tubedetr_tpu_torch.models.postprocess import (
    select_query_by_objectness,
    select_query_by_sted,
)
from tubedetr_tpu_torch.models.tubedetr import build_model

SMALL = {**TINY, "enc_layers": 1}
VARIANTS = {
    "gating": dict(fast_mode="gating"),
    "transformer": dict(fast_mode="transformer"),
    "pool": dict(fast_mode="pool"),
    "noslow": dict(fast_mode="noslow"),
    "nq3": dict(num_queries=3),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_matches_jax(name):
    """B=2 with a ragged duration and a spatially padded video, so the pool
    mask, the time padding and the per-frame query blocks all bite."""
    kw = {**SMALL, **VARIANTS[name]}
    batch = make_batch(kw, [T, 5], [(64, 64), (40, 56)])
    ref, variables = jax_forward(kw, batch)
    out = port_forward(port_model(kw, variables), batch)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], atol=ATOL, err_msg=k)
    if name == "nq3":
        np.testing.assert_array_equal(out["pred_boxes"], out["pred_boxes_queries"][..., 0, :])
        np.testing.assert_array_equal(out["pred_sted"], out["pred_sted_queries"][..., 0, :])
        time_mask = np.arange(T)[None] < np.array([T, 5])[:, None]
        np.testing.assert_array_equal(
            select_query_by_sted(out["pred_sted_queries"], time_mask, ["a", "b"]),
            select_query_by_sted(ref["pred_sted_queries"], time_mask, ["a", "b"]),
        )
        np.testing.assert_array_equal(
            select_query_by_objectness(out["pred_obj_queries"], time_mask),
            select_query_by_objectness(ref["pred_obj_queries"], time_mask),
        )


def _objectness_by_hand(sd):
    """``convert_tubedetr`` has no ``objectness_embed`` entry (the reference
    has no such head): the JAX tree's form of it, mapped by hand."""
    return {f"layers_{i}": {"kernel": sd[f"objectness_embed.layers.{i}.weight"].numpy().T,
                            "bias": sd[f"objectness_embed.layers.{i}.bias"].numpy()}
            for i in range(2)}


@pytest.mark.parametrize("name", ["gating", "transformer", "noslow", "pool", "nq3"])
def test_variant_state_dict_round_trips_and_loads(tmp_path, name):
    """Port ``state_dict`` -> ``convert_tubedetr`` -> ``params_from_jax``
    gives every tensor back; the same names load through
    ``load_pretrained`` with none missing; variables of another variant
    are refused."""
    from tubedetr_tpu.interop.torch_convert import convert_tubedetr

    kw = {**SMALL, **VARIANTS[name]}
    cfg = TubeDETRConfig(**kw)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    sd = {k: v + torch.randn_like(v) * 0.1 for k, v in model.state_dict().items()}
    params, buffers = convert_tubedetr(sd, JaxConfig(**kw))
    if cfg.num_queries > 1:
        params["objectness_embed"] = _objectness_by_hand(sd)
    back = params_from_jax({"params": params, "buffers": buffers}, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)

    path = str(tmp_path / "checkpoint.pth")
    torch.save({"model": sd}, path)
    fresh = build_model(cfg, device="cpu")
    missing, unexpected = load_pretrained(fresh, path)
    assert missing == [] and unexpected == []
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)

    other = "transformer" if name == "gating" else "gating"
    with pytest.raises(ValueError, match="config wants"):
        params_from_jax({"params": params, "buffers": buffers}, cfg.replace(fast_mode=other))


VALIDATE_CASES = {
    "gating": dict(fast_mode="gating"),
    "transformer": dict(fast_mode="transformer"),
    "pool": dict(fast_mode="pool"),
    "noslow": dict(fast_mode="noslow"),
    "unknown-mode": dict(fast_mode="conv"),
    "mode-without-fast": dict(fast_mode="pool", fast=False),
    "nq3": dict(num_queries=3),
    "nq0": dict(num_queries=0),
    "nq3-select-sted": dict(num_queries=3, nq_select="sted"),
    "nq3-select-objectness-video": dict(num_queries=3, nq_select="objectness", nq_match="video"),
    "select-sted-without-sted": dict(num_queries=3, nq_select="sted", sted=False),
    "unknown-select": dict(nq_select="best"),
    "unknown-match": dict(nq_match="clip"),
}


def _refuses(cfg) -> bool:
    try:
        cfg.validate()
    except (AssertionError, ValueError, NotImplementedError):
        return True
    return False


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_accepts_and_refuses_as_jax(case):
    kw = VALIDATE_CASES[case]
    assert _refuses(TubeDETRConfig(**kw)) == _refuses(JaxConfig(**kw)), kw
