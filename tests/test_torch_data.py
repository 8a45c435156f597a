"""The port's data pipeline against the JAX package's.

Transforms, the staging library, the VidSTG and HC-STVG datasets, the
loader, collate and the device feed, on tiny clips (20 frames of 60x80 for
VidSTG, 99 of 32x40 for HC-STVG) written into a temporary directory in the
published annotation layouts. Every sample draw comes from the same numpy
generators on both sides, so the samples must agree: the frames within
atol 1e-6 (both packages resize them with the same C++ code; the bound
only allows for float32 rounding in another order, and in practice they
are equal), boxes within atol 1e-6, and every id, index and token equal.
The plain numpy versions of the staging functions agree with the library
within atol 1e-5 (float32 sums in another order).
"""

import json
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.config import TubeDETRConfig as JaxConfig
from tubedetr_tpu.data import collate as jax_collate
from tubedetr_tpu.data import datasets as jax_datasets
from tubedetr_tpu.data import loader as jax_loader
from tubedetr_tpu.data import native as jax_native
from tubedetr_tpu.data import synthetic as jax_synthetic
from tubedetr_tpu.data import transforms as jax_transforms
from tubedetr_tpu.models.tokenizer import build_tokenizer as jax_tokenizer
from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.data import collate, datasets, loader, native, synthetic, transforms
from tubedetr_tpu_torch.models.tokenizer import build_tokenizer

FRAMES_ATOL = BOXES_ATOL = 1e-6
PLAIN_ATOL = 1e-5
VOCAB = 128


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _train_transforms(module, res, seed, h, w, boxes, allow_hflip):
    rng = np.random.default_rng(seed)
    return [module.sample_train_transform(rng, h, w, boxes, res, allow_hflip=allow_hflip)
            for _ in range(4)]


@pytest.mark.parametrize("res", sorted(jax_transforms.RESOLUTION_TABLES))
def test_train_transform_matches_jax(res):
    """From equal generator states, four draws in a row (the crop's retries
    included) give the same operators, boxes, out sizes and flips."""
    assert transforms.RESOLUTION_TABLES[res] == jax_transforms.RESOLUTION_TABLES[res]
    for seed, (h, w) in enumerate([(360, 640), (480, 360), (720, 1280)]):
        boxes = np.array([[40.0, 30.0, 120.0, 200.0], [0.0, 0.0, w * 0.9, h * 0.95]])
        for allow_hflip in (False, True):
            got = _train_transforms(transforms, res, seed, h, w, boxes, allow_hflip)
            want = _train_transforms(jax_transforms, res, seed, h, w, boxes, allow_hflip)
            for g, r in zip(got, want):
                assert (g.out_h, g.out_w, g.hflip) == (r.out_h, r.out_w, r.hflip)
                np.testing.assert_allclose(g.a_h, r.a_h, atol=1e-6)
                np.testing.assert_allclose(g.a_w, r.a_w, atol=1e-6)
                np.testing.assert_allclose(g.boxes_xyxy, r.boxes_xyxy, atol=1e-6)
                pg, pr = g.padded(transforms.bucket(g.out_h), transforms.bucket(g.out_w)), \
                    r.padded(jax_transforms.bucket(r.out_h), jax_transforms.bucket(r.out_w))
                np.testing.assert_allclose(pg.a_h, pr.a_h, atol=1e-6)
                np.testing.assert_allclose(pg.a_w, pr.a_w, atol=1e-6)


def test_eval_transform_boxes_and_caption_match_jax():
    boxes = np.array([[10.0, 20.0, 50.0, 80.0]])
    for h, w, res in [(360, 640, 224), (480, 360, 352), (100, 1000, 128)]:
        g, r = transforms.make_eval_transform(h, w, boxes, res), \
            jax_transforms.make_eval_transform(h, w, boxes, res)
        assert (g.out_h, g.out_w, g.hflip) == (r.out_h, r.out_w, r.hflip)
        np.testing.assert_array_equal(g.a_h, r.a_h)
        np.testing.assert_array_equal(g.a_w, r.a_w)
        np.testing.assert_array_equal(g.boxes_xyxy, r.boxes_xyxy)
    raw = np.array([[5.0, -3.0, 100.0, 40.0], [70.0, 50.0, 30.0, 30.0]])
    np.testing.assert_array_equal(transforms.prepare_boxes(raw, 60, 80),
                                  jax_transforms.prepare_boxes(raw, 60, 80))
    np.testing.assert_array_equal(
        transforms.normalize_boxes_cxcywh(raw, 60, 80),
        jax_transforms.normalize_boxes_cxcywh(raw, 60, 80))
    for cap in ("the man on the left, then right.", "left! right? leftover", ""):
        assert transforms.hflip_caption(cap) == jax_transforms.hflip_caption(cap)


# ---------------------------------------------------------------------------
# the staging library
# ---------------------------------------------------------------------------


def _clip(seed=0, t=5, h=37, w=53):
    return np.random.RandomState(seed).randint(0, 256, (t, h, w, 3), dtype=np.uint8)


def test_staging_library_equals_jax_bit_for_bit():
    """The port builds its own copy of ``staging.cc`` with the JAX flags:
    every function's output equals the JAX library's, bit for bit."""
    assert jax_native.get_lib() is not None
    frames = _clip()
    ct = transforms.sample_train_transform(np.random.default_rng(3), 37, 53,
                                           np.array([[5.0, 5.0, 30.0, 20.0]]), 128)
    for normalize in (True, False):
        np.testing.assert_array_equal(
            native.resize_normalize_clip(frames, ct.a_h, ct.a_w, normalize),
            jax_native.resize_normalize_clip(frames, ct.a_h, ct.a_w, normalize))
    np.testing.assert_array_equal(native.stage_clip(frames, 64, 64),
                                  jax_native.stage_clip(frames, 64, 64))
    clip = np.random.RandomState(1).randn(7, 4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(native.gather_strided(clip, 3), jax_native.gather_strided(clip, 3))
    assert native.SO_PATH.endswith(("tubedetr_tpu_torch/build/libstaging.so"))


def test_staging_plain_versions_agree():
    frames = _clip(2)
    ct = transforms.make_eval_transform(37, 53, np.zeros((0, 4)), 128).padded(160, 192)
    np.testing.assert_allclose(
        native.resize_normalize_clip(frames, ct.a_h, ct.a_w, plain=True),
        native.resize_normalize_clip(frames, ct.a_h, ct.a_w), atol=PLAIN_ATOL)
    np.testing.assert_allclose(native.stage_clip(frames, 40, 64, plain=True),
                               native.stage_clip(frames, 40, 64), atol=PLAIN_ATOL)
    clip = np.random.RandomState(1).randn(7, 4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(native.gather_strided(clip, 2, plain=True),
                                  native.gather_strided(clip, 2))


def test_staging_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output,
    and the staging functions raise with it: nothing falls back to numpy."""
    bad = tmp_path / "staging.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building"):
        native.build(str(bad), str(tmp_path / "lib.so"))
    assert not (tmp_path / "lib.so").exists()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC_PATH", str(bad))
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "build" / "libstaging.so"))
    with pytest.raises(RuntimeError, match="building"):
        native.resize_normalize_clip(_clip(), np.eye(37, dtype=np.float32),
                                     np.eye(53, dtype=np.float32))


def test_staging_pool_takes_concurrent_calls():
    """Eight threads (more than the cores a test worker gets) call the one
    pool at once with a short switch interval: every result equals the
    same call made alone."""
    clips = [_clip(s, t=6) for s in range(8)]
    ct = transforms.make_eval_transform(37, 53, np.zeros((0, 4)), 128)
    want = [native.resize_normalize_clip(c, ct.a_h, ct.a_w) for c in clips]
    got = [None] * len(clips)

    def work(i):
        for _ in range(5):
            got[i] = native.resize_normalize_clip(clips[i], ct.a_h, ct.a_w)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(clips))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def write_hcstvg(root, v2: bool, split: str):
    frame_count = 100  # fps 5 over 20 s: 99 frames sampled
    rng = np.random.RandomState(7 + v2)
    clip = rng.randint(0, 255, (frame_count - 1, 32, 40, 3), dtype=np.uint8)
    np.save(root / f"person{int(v2)}.npy", clip)
    ann = [{
        "video_id": f"hc{int(v2)}", "frame_count": frame_count, "tube_start_frame": 20,
        "tube_end_frame": 60, "trajectory": [[5.0 + 0.1 * i, 6.0, 12.0, 10.0] for i in range(40)],
        "caption": "the man walks to the left", "video_path": f"person{int(v2)}.npy",
        "width": 40, "height": 32,
    }]
    (root / (f"{split}_v2.json" if v2 else f"{split}.json")).write_text(json.dumps(ann))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("stvg")
    synthetic.write_vidstg_dir(str(root), 3, 2, t=20, h=60, w=80, seed=0, video_max_len_train=8)
    for v2, split in ((False, "train"), (False, "test"), (True, "val")):
        write_hcstvg(root, v2, split)
    return root


def _cfgs(root, **kw):
    base = dict(vidstg_ann_path=str(root), vidstg_vid_path=str(root), hcstvg_ann_path=str(root),
                hcstvg_vid_path=str(root), resolution=128, video_max_len=200,
                video_max_len_train=8, stride=2, fps=5, text_vocab_size=VOCAB, seed=3)
    base.update(kw)
    return TubeDETRConfig(**base), JaxConfig(**base)


DATASETS = [("vidstg", "train", {}), ("vidstg", "val", {}), ("hcstvg", "train", {}),
            ("hcstvg", "test", {}), ("hcstvg", "val", {"v2": True})]


def assert_samples_equal(got, want):
    np.testing.assert_allclose(got.frames, want.frames, atol=FRAMES_ATOL)
    np.testing.assert_allclose(got.boxes_cxcywh, want.boxes_cxcywh, atol=BOXES_ATOL)
    assert got.frames.dtype == np.float32
    assert list(got.frames_id) == list(want.frames_id)
    assert tuple(got.inter_idx) == tuple(want.inter_idx)
    assert tuple(got.valid_hw) == tuple(want.valid_hw)
    assert tuple(got.orig_size) == tuple(want.orig_size)
    assert (got.video_id, got.caption, got.qtype) == (want.video_id, want.caption, want.qtype)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("name,image_set,extra", DATASETS,
                         ids=[f"{n}-{s}{'-v2' if e else ''}" for n, s, e in DATASETS])
def test_dataset_matches_jax(data_dir, name, image_set, extra):
    """The same samples at several (epoch, idx): with ``video_max_len_train``
    8 and ``tmp_crop`` on, the train samples go through the temporal crop
    and the dense window (checked to have fired)."""
    cfg, jcfg = _cfgs(data_dir, **extra)
    ds = datasets.build_dataset(name, image_set, cfg, build_tokenizer("", VOCAB))
    jds = jax_datasets.build_dataset(name, image_set, jcfg, jax_tokenizer("", VOCAB))
    assert len(ds) == len(jds) > 0
    lengths = set()
    for epoch in range(3):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for idx in range(len(ds)):
            got, want = ds[idx], jds[idx]
            assert_samples_equal(got, want)
            lengths.add(len(got.frames_id))
    if image_set == "train":
        assert max(lengths) <= 8  # the dense window cut every long clip
    else:
        assert lengths == {len(ds.annotations[0].frame_ids)}


# ---------------------------------------------------------------------------
# the loader, collate and the device feed
# ---------------------------------------------------------------------------


def _synthetic_pair(n, t=8, seed=0):
    return (synthetic.SyntheticDataset(n=n, t=t, seed=seed, vocab=VOCAB),
            jax_synthetic.SyntheticDataset(n=n, t=t, seed=seed, vocab=VOCAB))


def _assert_batches_equal(got, want):
    """A port ``(batch, meta)`` against a JAX one: every field equal."""
    (batch, meta), (jbatch, jmeta) = got, want
    assert meta == jmeta
    assert set(batch) == set(jbatch)
    for k, v in jbatch.items():
        g = batch[k]
        g = g.float().numpy() if torch.is_tensor(g) and g.dtype == torch.bfloat16 else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(v, dtype=g.dtype), err_msg=k)


LOADERS = {
    "shuffle-drop_last": dict(batch_size=2, shuffle=True, drop_last=True),
    "process-shard": dict(batch_size=2, shuffle=True, process_index=1, process_count=2),
    "div_vid": dict(batch_size=2, t=4, div_vid=4),
    "bf16-compact": dict(batch_size=3, frames_dtype="bfloat16", compact_pad_masks=True),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_matches_jax(case):
    """The same batches in the same order over two epochs (the shuffle
    reseeds a epoch), every field equal; bf16 frames equal as bits."""
    kw = dict(t=8, stride=2, max_text_len=6, seed=5)
    kw.update(LOADERS[case])
    ds, jds = _synthetic_pair(7)
    dl, jdl = loader.DataLoader(ds, **kw), jax_loader.DataLoader(jds, **kw)
    for epoch in range(2):
        dl.set_epoch(epoch)
        jdl.set_epoch(epoch)
        got, want = list(dl), list(jdl)
        assert len(got) == len(want) == len(dl) == len(jdl)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
            if kw.get("frames_dtype") == "bfloat16":
                assert g[0]["frames_slow"].dtype == torch.bfloat16
                assert w[0]["frames_slow"].dtype == ml_dtypes.bfloat16


def test_concat_and_epoch_chunks_match_jax():
    a, ja = _synthetic_pair(3, seed=0)
    b, jb = _synthetic_pair(4, seed=50)
    cat, jcat = loader.ConcatDataset([a, b]), jax_loader.ConcatDataset([ja, jb])
    assert len(cat) == len(jcat) == 7
    for c in range(3):
        ch, jch = loader.EpochChunkView(cat, 3, c, seed=1), jax_loader.EpochChunkView(jcat, 3, c, seed=1)
        np.testing.assert_array_equal(ch.indices, jch.indices)
        kw = dict(batch_size=2, t=8, stride=2, max_text_len=6, shuffle=True, seed=2)
        for g, w in zip(loader.DataLoader(ch, **kw), jax_loader.DataLoader(jch, **kw)):
            _assert_batches_equal(g, w)


def test_threaded_loader_equals_synchronous(data_dir):
    """Three worker threads over the VidSTG train set give the batches of
    the synchronous loader, bit for bit (each item draws from its own
    generator, not from one the threads share)."""
    cfg, _ = _cfgs(data_dir)
    ds = datasets.build_dataset("vidstg", "train", cfg, build_tokenizer("", VOCAB))
    ds.set_epoch(1)
    kw = dict(batch_size=1, t=8, stride=2, max_text_len=12, shuffle=True, seed=4)
    sync = list(loader.DataLoader(ds, **kw))
    threaded = list(loader.DataLoader(ds, num_workers=3, prefetch=1, **kw))
    assert len(sync) == len(threaded) == 3
    for (b1, m1), (b2, m2) in zip(sync, threaded):
        assert m1 == m2
        for k in b1:
            np.testing.assert_array_equal(np.asarray(b1[k]), np.asarray(b2[k]), err_msg=k)


class _Failing:
    def __init__(self, ds, bad):
        self.ds, self.bad = ds, bad

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError("decode failed")
        return self.ds[i]


def test_device_feed_on_cpu_equals_synchronous_and_reraises(capsys):
    """On the CPU the prefetcher only moves the batch (and says so): the
    batches equal the synchronous ones with every array a tensor. An error
    of the dataset, in a loader thread, re-raises in the consumer, through
    the prefetcher and through the same-thread feed."""
    ds, _ = _synthetic_pair(5)
    kw = dict(batch_size=2, t=8, stride=2, max_text_len=6)
    sync = list(loader.DataLoader(ds, **kw))
    for feed in (loader.DevicePrefetcher(loader.DataLoader(ds, num_workers=2, **kw), size=2,
                                         device="cpu"),
                 loader.prefetch_to_device(iter(loader.DataLoader(ds, **kw)), "cpu")):
        got = list(feed)
        assert len(got) == len(sync)
        for (b, m), (sb, sm) in zip(got, sync):
            assert m == sm
            for k, v in sb.items():
                assert torch.is_tensor(b[k])
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(v), err_msg=k)
    assert "only moved" in capsys.readouterr().out
    bad = _Failing(ds, 3)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(loader.DevicePrefetcher(loader.DataLoader(bad, num_workers=2, **kw), device="cpu"))
    with pytest.raises(RuntimeError, match="decode failed"):
        list(loader.DataLoader(bad, num_workers=2, **kw))
    with pytest.raises(RuntimeError, match="decode failed"):
        list(loader.prefetch_to_device(iter(loader.DataLoader(bad, **kw)), "cpu"))


def test_collate_numpy_frames_and_tokenizer():
    """Numpy frames collate into CPU tensors of ``frames_dtype``; a sample
    without tokens is encoded and truncated as the JAX collate does it."""
    samples = [jax_synthetic.make_synthetic_sample(i, t=6, vocab=VOCAB) for i in range(2)]
    for s in samples:
        s.tokens = None
        s.caption = "a very long caption " * 4
    port = [collate.VideoSample(frames=s.frames, valid_hw=s.valid_hw, frames_id=s.frames_id,
                                video_id=s.video_id, caption=s.caption, orig_size=s.orig_size,
                                boxes_cxcywh=s.boxes_cxcywh, inter_idx=s.inter_idx) for s in samples]
    batch = collate.collate(port, 6, 2, 8, frames_dtype="bfloat16", tokenizer=build_tokenizer("", VOCAB))
    jbatch, _ = jax_collate.collate(samples, 6, 2, 8, tokenizer=jax_tokenizer("", VOCAB),
                                    frames_dtype="bfloat16")
    assert batch["frames_fast"].dtype == torch.bfloat16
    np.testing.assert_array_equal(batch["frames_fast"].float().numpy(),
                                  np.asarray(jbatch["frames_fast"], np.float32))
    np.testing.assert_array_equal(batch["tokens"].numpy(), jbatch["tokens"])
    np.testing.assert_array_equal(batch["text_pad_mask"].numpy(), jbatch["text_pad_mask"])
    assert collate.resolve_frames_dtype("bf16") is torch.bfloat16
    with pytest.raises(ValueError):
        collate.resolve_frames_dtype("float16")


def test_synthetic_samples_and_dataset_match_jax():
    """``make_synthetic_batch_samples`` and ``build_dataset("synthetic")``
    (sized from the ``synthetic_*`` fields) give the JAX package's samples."""
    got = synthetic.make_synthetic_batch_samples(3, seed0=4, t=6, vocab=VOCAB)
    want = jax_synthetic.make_synthetic_batch_samples(3, seed0=4, t=6, vocab=VOCAB)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.frames.numpy(), w.frames)
        np.testing.assert_array_equal(g.boxes_cxcywh, w.boxes_cxcywh)
        assert (g.inter_idx, list(g.frames_id), g.video_id) == (w.inter_idx, w.frames_id, w.video_id)
        np.testing.assert_array_equal(g.tokens, w.tokens)
    for split in ("train", "val"):
        kw = dict(synthetic_train_size=5, synthetic_val_size=3, synthetic_t=6, synthetic_res=48,
                  text_vocab_size=VOCAB, seed=2)
        ds = datasets.build_dataset("synthetic", split, TubeDETRConfig(**kw))
        jds = jax_datasets.build_dataset("synthetic", split, JaxConfig(**kw))
        assert len(ds) == len(jds) == (5 if split == "train" else 3)
        for i in range(len(ds)):
            np.testing.assert_array_equal(ds[i].frames.numpy(), jds[i].frames)
            assert ds[i].video_id == jds[i].video_id and ds[i].frames.shape[1:3] == (48, 48)


def test_preproc_converters_write_the_jax_files(tmp_path):
    """The annotation converters, run on small raw VidOR/VidSTG and
    HC-STVG files in two directories, write the JAX package's files, byte
    for byte."""
    from tubedetr_tpu.data import preproc as jax_preproc
    from tubedetr_tpu_torch.data import preproc

    def raw(root):
        vid = {"video_id": "v0", "video_path": "0000/v0.mp4", "frame_count": 10, "fps": 5.0,
               "width": 80, "height": 60, "subject/objects": [{"tid": 0, "category": "dog"}],
               "trajectories": [[{"tid": 0, "bbox": {"xmin": 1, "ymin": 2, "xmax": 30, "ymax": 40},
                                  "generated": 0, "tracker": "none"}] for _ in range(10)]}
        for split in ("training", "validation"):
            (root / "vidor" / split / "0000").mkdir(parents=True)
            (root / "vidor" / split / "0000" / "v0.json").write_text(json.dumps(vid))
        ann = [{"vid": "v0", "frame_count": 10, "fps": 5.0, "width": 80, "height": 60,
                "used_segment": {"begin_fid": 0, "end_fid": 10},
                "temporal_gt": {"begin_fid": 2, "end_fid": 8},
                "questions": [{"description": "what runs?", "type": "sub", "target_id": 0}],
                "captions": [{"description": "a dog runs", "type": "sub", "target_id": 0}]}]
        for name in ("train", "val", "test"):
            (root / f"{name}_annotations.json").write_text(json.dumps(ann))
        hc = {"clip.mp4": {"bbox": [[1, 2, 3, 4]] * 5, "st_frame": 3, "img_num": 20,
                           "img_size": [60, 80], "English": "the man walks"}}
        for name in ("train", "test", "val"):
            (root / f"{name}_raw.json").write_text(json.dumps(hc))

    for module, root in ((preproc, tmp_path / "port"), (jax_preproc, tmp_path / "jax")):
        root.mkdir()
        raw(root)
        module.main(["vidor", "--vidor_path", str(root / "vidor"), "--ann_path", str(root)])
        module.main(["vidstg", "--ann_path", str(root)])
        module.main(["hcstvg", "--ann_path", str(root)])
        module.main(["hcstvg", "--ann_path", str(root), "--v2"])
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.json") if "raw" not in p.name
                   and "annotations" not in p.name)
    assert names == ["test.json", "train.json", "train_v2.json", "val.json", "val_v2.json",
                     "vidor_training.json", "vidor_validation.json"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
