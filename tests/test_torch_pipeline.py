"""The port's GroundingPipeline against the JAX package's, on the CPU.

One uint8 ``.npy`` clip goes through both pipelines with the same weights
(the JAX variables moved with ``params_from_jax``). The tube must match: the
boxes, normalized by the frame size, to atol 1e-4, and the segment exactly.
The JAX side reaches its float32 preprocess (``ops/preprocess.py``), the
port's side K1's plain version.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.apps.pipeline import GroundingPipeline as JaxPipeline
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.interop.from_jax import params_from_jax

KW = dict(
    backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
    dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
    resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
    text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
    fast=True, guided_attn=False, sted=True, aux_loss=False, dropout=0.0,
)


def _clip(tmp_path, name, t, h, w, seed):
    clip = np.random.RandomState(seed).randint(0, 256, (t, h, w, 3), dtype=np.uint8)
    path = str(tmp_path / name)
    np.save(path, clip)
    return path


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline on the CPU) with the same random weights."""
    jp = JaxPipeline(JaxConfig(**KW))
    variables = random_variables(jp.model, jp._example_batch(), seed=5)
    jp.variables = jax.device_put(variables)
    cfg = TubeDETRConfig(**KW)
    tp = GroundingPipeline(cfg, device="cpu")
    tp.model.load_state_dict(params_from_jax(variables, cfg))
    return jp, tp


@pytest.mark.parametrize("t,h,w", [(7, 48, 64), (8, 72, 40)], ids=["ragged-wide", "full-tall"])
def test_pipeline_tube_matches_jax(tmp_path, pipelines, t, h, w):
    jp, tp = pipelines
    path = _clip(tmp_path, "clip.npy", t, h, w, seed=t)
    ref = jp.ground(path, "a man in a red shirt", render=False)
    out = tp.ground(path, "a man in a red shirt", render=False)
    assert out["sted"] == ref["sted"]
    size = np.array([w, h, w, h], np.float64)
    np.testing.assert_allclose(
        np.asarray(out["boxes"]) / size, np.asarray(ref["boxes"]) / size, atol=1e-4
    )


def test_ground_many_batches_and_isolates_errors(tmp_path, pipelines):
    """B=2 coalescing gives each request the tube it gets alone, and a
    request that fails in decode returns its error without hurting the
    other."""
    _, tp = pipelines
    a = _clip(tmp_path, "a.npy", 7, 48, 64, seed=1)
    b = _clip(tmp_path, "b.npy", 5, 48, 64, seed=2)
    alone = tp.ground(a, "a dog", render=False)
    both = tp.ground_many([(a, "a dog", -1, -1), (b, "a cat", -1, -1)], render=False)
    assert both[0]["sted"] == alone["sted"]
    np.testing.assert_allclose(both[0]["boxes"], alone["boxes"], atol=1e-4)
    assert 0 <= both[1]["sted"][0] < both[1]["sted"][1] <= 5
    res = tp.ground_many(
        [(a, "a dog", -1, -1), (str(tmp_path / "missing.npy"), "x", -1, -1)],
        render=False, return_exceptions=True,
    )
    assert isinstance(res[1], Exception) and res[0]["sted"] == alone["sted"]


def test_render_writes_tube_frames(tmp_path, pipelines):
    _, tp = pipelines
    path = _clip(tmp_path, "clip.npy", 6, 48, 64, seed=3)
    out = tp.ground(path, "a red square", out_dir=str(tmp_path / "out"))
    frames = np.load(tmp_path / "out" / "tube_frames.npy")
    assert frames.shape == (6, 48, 64, 3) and frames.dtype == np.uint8
    assert len(out["boxes"]) == 6


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GroundingPipeline(TubeDETRConfig(**KW))
