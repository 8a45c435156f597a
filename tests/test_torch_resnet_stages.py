"""The port's ``ResNet(stages=N)`` against the JAX ``ResNet(stages=N)``.

The JAX trunk's ``stages`` runs the first N stage groups only (0 gives the
stem after the max pool); its parameters for a truncation are the whole
trunk's (flax ignores the unused sub-trees). The port builds only the
groups it runs, and the whole trunk's ``state_dict`` loads into it with
``strict=False``. Same seeded numpy weights and inputs on both sides.

* float32, resnet26 (a tail block in every stage) with DC5, N = 0..4: the
  shape, and the values at ``tests/test_torch_resnet.py``'s atol 1e-4;
* int8_static at N = 2, the cut inside the int8 carrier (dequantized once
  at the cut), unfused and with ``fused_blocks`` (K2's plain version on the
  CPU, the JAX package's emulation of K2 on its side): the calibrated
  maxima to rtol 1e-4 and the output within 3 steps of the last block's
  ``out_max / 127`` with correlation above 0.999, the bound of
  ``tests/test_torch_int8.py``'s whole trunks. Both sides run op by op with
  exact BN folds (``tests/test_torch_int8.py:exact_bn``).
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_int8 import assert_trees_close, exact_bn, jax_k2_reference  # noqa: F401
from tests.test_torch_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.models.resnet import ResNet as JaxResNet
from tubedetr_tpu_torch.interop.from_jax import (
    resnet_from_jax,
    resnet_qscales_from_jax,
    resnet_qscales_to_flax,
)
from tubedetr_tpu_torch.models.resnet import ResNet

CHANNELS = (64, 256, 512, 1024, 2048)


@pytest.fixture(scope="module")
def float_trunk():
    """The whole resnet26 DC5 trunk's JAX variables and the input."""
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    jm = JaxResNet(arch="resnet26", dilation=True, scan_blocks=False)
    return x, random_variables(jm, {"x": x}, seed=1)


@pytest.mark.parametrize("stages", range(5))
def test_truncated_trunk_matches_jax(float_trunk, stages):
    x, variables = float_trunk
    ref = np.asarray(JaxResNet(arch="resnet26", dilation=True, scan_blocks=False,
                               stages=stages).apply(variables, x))
    tm = ResNet("resnet26", dilation=True, stages=stages).eval()
    whole = resnet_from_jax(variables["params"], variables["buffers"])
    missing, unexpected = tm.load_state_dict(whole, strict=False)
    assert not missing
    assert sorted({k.split(".")[0] for k in unexpected}) == [f"layer{i}" for i in
                                                             range(stages + 1, 5)]
    assert [n for n, _ in tm.named_children() if n.startswith("layer")] == \
        [f"layer{i}" for i in range(1, stages + 1)]
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.shape[-1] == CHANNELS[stages] == tm.out_channels
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_int8_static_cut_at_layer2_matches_jax(fused, jax_k2_reference):
    stages = 2
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32) * 0.5
    jm = JaxResNet(arch="resnet26", quant="int8_static", scan_blocks=False, fused_blocks=fused,
                   stages=stages)
    variables = exact_bn(random_variables(jm, {"x": x}, seed=4))
    pb = {k: variables[k] for k in ("params", "buffers")}
    with jax.disable_jit():
        _, upd = jm.clone(quant="int8").apply(pb, x, mutable=["qscales"])
        qs = jax.tree_util.tree_map(np.asarray, upd["qscales"])
        want = np.asarray(jm.apply({**pb, "qscales": qs}, x))
    assert set(qs) == {"stem_act_max", "layer1_0", "layer1_1", "layer2_0", "layer2_1"}

    tm = ResNet("resnet26", quant="int8_static", fused_blocks=fused, stages=stages).eval()
    tm.load_state_dict(resnet_from_jax(variables["params"], variables["buffers"]))
    assert sum(b.fused for b in tm.blocks()) == (2 if fused else 0)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        with tm.calibrating():
            tm(xt)
        assert_trees_close(resnet_qscales_to_flax(
            {k: v.numpy() for k, v in tm.qscales().items()}, scanned=False), qs, rtol=1e-4)
        tm.load_qscales(resnet_qscales_from_jax(qs))
        got = tm(xt)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 4, 4, 512)
    got = got.numpy()
    step = float(qs["layer2_1"]["out_max"]) / 127.0
    assert np.abs(got - want).max() <= 3 * step + 1e-6
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
