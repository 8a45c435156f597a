"""The port's own copies of the JAX package's small helpers, held to them.

Boxes, masks and sine embeddings (``core/``), the eval transform and size
buckets (``data/transforms.py``), collation (``data/collate.py``), the
tokenizers (``models/tokenizer.py``) and the numpy postprocess
(``models/postprocess.py``). Same numpy inputs on both sides. The host-side
copies must agree exactly; the float ones to atol 1e-5 (sin/cos and
cumulative sums of float32 in two frameworks).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.core import boxes as jax_boxes
from tubedetr_tpu.core import embeddings as jax_emb
from tubedetr_tpu.core import masking as jax_masking
from tubedetr_tpu.data import collate as jax_collate
from tubedetr_tpu.data import transforms as jax_transforms
from tubedetr_tpu.models import postprocess as jax_post
from tubedetr_tpu.models import tokenizer as jax_tok
from tubedetr_tpu_torch.core import boxes, embeddings, masking
from tubedetr_tpu_torch.data import collate, transforms
from tubedetr_tpu_torch.models import postprocess, tokenizer


def test_box_cxcywh_to_xyxy_matches_jax():
    x = np.random.RandomState(0).rand(5, 7, 4).astype(np.float32)
    np.testing.assert_allclose(
        boxes.box_cxcywh_to_xyxy(torch.from_numpy(x)).numpy(),
        np.asarray(jax_boxes.box_cxcywh_to_xyxy(jnp.asarray(x))), atol=1e-6,
    )


@pytest.mark.parametrize("valid_hw", [(12, 20), (7, 13)], ids=["unpadded", "padded"])
def test_position_embedding_sine_matches_jax(valid_hw):
    mask = np.ones((2, 12, 20), bool)
    mask[:, : valid_hw[0], : valid_hw[1]] = False
    ref = jax_emb.position_embedding_sine(jnp.asarray(mask), num_pos_feats=16)
    got = embeddings.position_embedding_sine(torch.from_numpy(mask), num_pos_feats=16)
    assert got.shape == (2, 12, 20, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_time_embedding_sine_matches_jax():
    np.testing.assert_allclose(
        embeddings.time_embedding_sine(200, 256).numpy(),
        np.asarray(jax_emb.time_embedding_sine(200, 256)), atol=1e-5,
    )


@pytest.mark.parametrize(
    "in_hw,out_hw", [((64, 96), (2, 3)), ((352, 608), (11, 19)), ((330, 586), (21, 37))]
)
def test_downsample_pad_mask_matches_jax(in_hw, out_hw):
    mask = np.random.RandomState(1).rand(3, *in_hw) > 0.5
    np.testing.assert_array_equal(
        masking.downsample_pad_mask(torch.from_numpy(mask), *out_hw).numpy(),
        np.asarray(jax_masking.downsample_pad_mask(jnp.asarray(mask), *out_hw)),
    )


@pytest.mark.parametrize("stride", [0, 1, 4, 5])
def test_frame_to_clip_matches_jax(stride):
    np.testing.assert_array_equal(
        masking.frame_to_clip(23, stride).numpy(),
        np.asarray(jax_masking.frame_to_clip(23, stride)),
    )


@pytest.mark.parametrize(
    "h,w,res", [(360, 640, 352), (480, 360, 224), (100, 1000, 128), (352, 352, 352)]
)
def test_eval_transform_and_bucket_match_jax(h, w, res):
    box = np.array([[10.0, 20.0, 50.0, 80.0]])
    got = transforms.make_eval_transform(h, w, box, res)
    ref = jax_transforms.make_eval_transform(h, w, box, res)
    assert (got.out_h, got.out_w) == (ref.out_h, ref.out_w)
    np.testing.assert_array_equal(got.boxes_xyxy, ref.boxes_xyxy)
    for x in (got.out_h, got.out_w, 1, 32, 33):
        assert transforms.bucket(x) == jax_transforms.bucket(x)
    assert transforms.RESOLUTION_TABLES == jax_transforms.RESOLUTION_TABLES


def test_collate_masks_and_tokens_match_jax():
    """Two ragged videos of different valid sizes: every mask, token row and
    duration equals the JAX package's; the frames stay torch tensors."""
    rng = np.random.RandomState(2)
    shapes = [(5, 64, 96, (60, 90)), (8, 96, 64, (96, 50))]
    port, ref = [], []
    for i, (t, h, w, vhw) in enumerate(shapes):
        frames = rng.randn(t, h, w, 3).astype(np.float32)
        toks = rng.randint(4, 50, 3 + 2 * i)
        common = dict(valid_hw=vhw, frames_id=list(range(t)), video_id=i,
                      caption="c", tokens=toks)
        port.append(collate.VideoSample(frames=torch.from_numpy(frames), **common))
        ref.append(jax_collate.VideoSample(frames=frames, boxes_cxcywh=np.zeros((t, 4)),
                                           inter_idx=(-100, -100), **common))
    got = collate.collate(port, 8, 3, 6)
    want, _ = jax_collate.collate(ref, 8, 3, 6)
    for k in ("slow_pad_mask", "fast_pad_mask", "tokens", "text_pad_mask", "durations"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got["time_mask"], want["time_mask"])
    for k in ("frames_slow", "frames_fast"):
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(collate.model_inputs(got)) == set(collate.MODEL_INPUTS)


def test_tokenizers_match_jax(tmp_path):
    """The hash stand-in and the byte-level BPE encode identically, the BPE
    from the same small vocab/merges assets."""
    text = "A man in a red shirt rides a horse, 2 times; isn't it?"
    for size in (128, 50265):
        assert tokenizer.HashTokenizer(size).encode(text) == jax_tok.HashTokenizer(size).encode(text)
    byte = tokenizer.bytes_to_unicode()
    merges = [("Ġ", "a"), ("r", "e"), ("Ġ", "re"), ("Ġre", "d"), ("h", "o")]
    vocab = {s: i + 4 for i, s in enumerate(sorted(set(byte.values()) | {a + b for a, b in merges}))}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    got = tokenizer.build_tokenizer(str(tmp_path)).encode(text)
    assert isinstance(tokenizer.build_tokenizer(str(tmp_path)), tokenizer.BPETokenizer)
    assert got == jax_tok.build_tokenizer(str(tmp_path)).encode(text)
    assert vocab["Ġred"] in got


def test_postprocess_matches_jax():
    """Pixel boxes, and segments over a batch whose first two rows are clips
    of one video (concatenated before the argmax) and whose last is padded."""
    rng = np.random.RandomState(3)
    pred_boxes = rng.rand(3, 6, 4)
    sizes = np.array([[360, 640], [360, 640], [96, 160]])
    np.testing.assert_array_equal(
        postprocess.postprocess_boxes(pred_boxes, sizes[:, None]),
        jax_post.postprocess_boxes(pred_boxes, sizes[:, None]),
    )
    pred_sted = rng.randn(3, 6, 2)
    frames_id = [list(range(6)), list(range(6, 12)), [0, 2, 4, 6]]
    video_ids = ["a", "a", "b"]
    time_mask = np.ones((3, 6), bool)
    time_mask[2, 4:] = False
    got = postprocess.postprocess_sted(pred_sted, frames_id, video_ids, time_mask)
    assert got == jax_post.postprocess_sted(pred_sted, frames_id, video_ids, time_mask)
    assert len(got) == 2
    with pytest.raises(ValueError, match="batch-adjacent"):
        postprocess.postprocess_sted(pred_sted, frames_id, ["a", "b", "a"], time_mask)
