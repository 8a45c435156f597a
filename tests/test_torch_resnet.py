"""The port's float ResNet trunk against the JAX ``ResNet`` at ``quant="none"``.

resnet26 (two blocks per stage) so every stage has a tail block: the JAX
parameters come in the scanned layout (``layer{i}_rest/block``, stacked on
axis 0) and in the unrolled one (``layer{i}_{j}``), with and without DC5
``dilation``. Same numpy weights and inputs on both sides; NHWC in and out.
Tolerance: f32 atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.models.resnet import ResNet as JaxResNet
from tubedetr_tpu_torch.interop.from_jax import resnet_from_jax
from tubedetr_tpu_torch.models.resnet import FrozenBatchNorm2d, ResNet


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("dilation", [False, True], ids=["c5", "dc5"])
def test_trunk_matches_jax(scan, dilation):
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    jm = JaxResNet(arch="resnet26", dilation=dilation, scan_blocks=scan)
    variables = random_variables(jm, {"x": x}, seed=1)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))

    tm = ResNet("resnet26", dilation=dilation).eval()
    tm.load_state_dict(resnet_from_jax(variables["params"], variables["buffers"]))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, *ResNet.feature_hw(64, 96, dilation), 2048)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_frozen_bn_eps_inside_rsqrt():
    """scale = weight * rsqrt(var + 1e-5): at var = 0 the eps alone sets it."""
    bn = FrozenBatchNorm2d(2)
    bn.running_var.zero_()
    bn.running_mean.fill_(1.0)
    x = torch.full((1, 2, 1, 1), 3.0)
    torch.testing.assert_close(bn(x), torch.full_like(x, 2.0 / np.sqrt(1e-5)))


@pytest.mark.parametrize("arch", ["resnet50", "resnet101", "resnet152"])
def test_stage_depths(arch):
    """Block counts per stage follow torchvision (the reference's names)."""
    from tubedetr_tpu.models.resnet import STAGE_BLOCKS

    model = ResNet(arch)
    assert tuple(len(getattr(model, f"layer{i}")) for i in (1, 2, 3, 4)) == STAGE_BLOCKS[arch]
