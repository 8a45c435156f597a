"""The port's evaluation pieces against the JAX package's, on seeded inputs.

Boxes (``np_box_iou`` and the paired IoU/GIoU), the VidSTG and HC-STVG
annotation loaders, the ``div_vid`` clip split, ``VIoUEvaluator`` (VidSTG
question types, HC-STVG, ``tmp_loc`` on and off, the two-shard merge) and
the two multi-query selectors: each case runs the same inputs through both
packages.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.core import boxes as jboxes
from tubedetr_tpu.data import annotations as jann
from tubedetr_tpu.data.collate import VideoSample as JaxSample
from tubedetr_tpu.data.collate import split_video_into_clips as jax_split
from tubedetr_tpu.eval.viou import VIoUEvaluator as JaxEvaluator
from tubedetr_tpu.models import postprocess as jpost
from tubedetr_tpu_torch.core import boxes
from tubedetr_tpu_torch.data import annotations as ann
from tubedetr_tpu_torch.data.collate import VideoSample, split_video_into_clips
from tubedetr_tpu_torch.eval.viou import VIoUEvaluator
from tubedetr_tpu_torch.models import postprocess as post


def _xyxy(rng, n):
    lo = rng.uniform(0, 50, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(1, 40, (n, 2))], axis=1)


@pytest.mark.parametrize("fn", ["np_box_iou", "paired_box_iou", "paired_generalized_box_iou"])
def test_box_iou_matches_jax(fn):
    rng = np.random.RandomState(0)
    a, b = _xyxy(rng, 12), _xyxy(rng, 12)
    if fn == "np_box_iou":
        got, ref = boxes.np_box_iou(a, b[:7]), jboxes.np_box_iou(a, b[:7])
    else:
        got = getattr(boxes, fn)(torch.from_numpy(a), torch.from_numpy(b))
        ref = getattr(jboxes, fn)(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
        if fn == "paired_box_iou":  # (iou, union)
            got, ref = torch.stack(got), np.stack([np.asarray(r) for r in ref])
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


def _write_vidstg(path):
    rng = np.random.RandomState(1)
    videos, traj = [], {}
    for i in range(3):
        start, end = 10 * i, 10 * i + 90
        t0, t1 = start + 20, start + 60
        videos.append({"video_id": i, "original_video_id": f"o{i}", "target_id": 1,
                       "fps": 30.0 - 5 * i, "start_frame": start, "end_frame": end,
                       "tube_start_frame": t0, "tube_end_frame": t1, "caption": f"c{i}",
                       "qtype": ["declarative", "interrogative"][i % 2], "width": 640,
                       "height": 360})
        traj[f"o{i}"] = {"1": {str(f): {"bbox": rng.uniform(0, 100, 4).tolist()}
                               for f in range(t0, t1)}}
    path.write_text(json.dumps({"videos": videos, "trajectories": traj}))


def _write_hcstvg(path):
    rng = np.random.RandomState(2)
    anns = [{"video_id": i, "frame_count": 300 + 37 * i, "tube_start_frame": 40 + i,
             "tube_end_frame": 200 + 3 * i, "caption": f"h{i}",
             "trajectory": rng.uniform(0, 100, (150, 4)).tolist()} for i in range(3)]
    path.write_text(json.dumps(anns))


LOADERS = {
    "vidstg": ("load_vidstg", "test.json", _write_vidstg, dict(fps=5, video_max_len=12)),
    "vidstg-no-tmp-loc": ("load_vidstg", "test.json", _write_vidstg,
                          dict(fps=5, video_max_len=200, tmp_loc=False)),
    "hcstvg": ("load_hcstvg", "test_proc.json", _write_hcstvg, dict(fps=5, video_max_len=40)),
    "hcstvg-v2": ("load_hcstvg", "testv2_proc.json", _write_hcstvg, dict(v2=True)),
}


@pytest.mark.parametrize("case", list(LOADERS))
def test_annotation_loaders_match_jax(tmp_path, case):
    fn, name, write, kw = LOADERS[case]
    write(tmp_path / name)
    got = getattr(ann, fn)(str(tmp_path), "test", **kw)
    ref = getattr(jann, fn)(str(tmp_path), "test", **kw)
    assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a) for a in ref]
    assert all(a.inter_frames for a in got)


@pytest.mark.parametrize("inter", [(3, 9), (0, 4), (11, 12), (-100, -100)])
def test_split_video_into_clips_matches_jax(inter):
    t = 13
    frames = np.arange(t * 2 * 2 * 3, dtype=np.float32).reshape(t, 2, 2, 3)
    kw = dict(valid_hw=(2, 2), frames_id=list(range(100, 100 + t)), video_id="v",
              caption="c", tokens=np.arange(4), orig_size=(8, 8),
              boxes_cxcywh=np.random.RandomState(0).rand(t, 4).astype(np.float32),
              inter_idx=inter, qtype="interrogative")
    got = split_video_into_clips(VideoSample(frames=torch.from_numpy(frames), **kw), 5)
    ref = jax_split(JaxSample(frames=frames, **kw), 5)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.frames.numpy(), r.frames)
        np.testing.assert_array_equal(g.boxes_cxcywh, r.boxes_cxcywh)
        assert (g.inter_idx, g.frames_id, g.video_id, g.qtype) == (
            r.inter_idx, r.frames_id, r.video_id, r.qtype)


def _annotations(n, hcstvg):
    """Seeded annotations: 20 sampled frames, a GT tube inside them."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(n):
        frame_ids = list(range(0, 40, 2))
        t0 = int(rng.randint(0, 20)) * 2
        t1 = min(t0 + 2 * int(rng.randint(2, 10)), 40)
        inter = [f for f in frame_ids if t0 <= f < t1]
        out.append(dict(
            video_id=f"v{i}", frame_ids=frame_ids, inter_frames=inter,
            tube_start_frame=t0, tube_end_frame=t1,
            boxes_xywh={f: rng.uniform(0, 50, 4).tolist() for f in inter},
            caption="c", qtype="declarative" if hcstvg or i % 2 else "interrogative",
            video_path="", start_seconds=0.0, duration_seconds=8.0,
        ))
    return out


def _feed(evaluator, anns, seed):
    rng = np.random.RandomState(seed)
    for a in anns:
        evaluator.update({f"{a['video_id']}_{f}": {"boxes": _xyxy(rng, 1).tolist()}
                          for f in a["frame_ids"]})
        s = int(rng.randint(0, 19)) * 2
        evaluator.video_update({a["video_id"]: {"sted": [s, s + 2 * int(rng.randint(1, 10))],
                                                "qtype": a["qtype"]}})


@pytest.mark.parametrize("hcstvg,tmp_loc", [(False, True), (False, False), (True, True)],
                         ids=["vidstg", "vidstg-no-tmp-loc", "hcstvg"])
def test_viou_summary_matches_jax(hcstvg, tmp_loc):
    anns = _annotations(9, hcstvg)
    got_ev = VIoUEvaluator([ann.VideoAnnotation(**a) for a in anns], tmp_loc=tmp_loc)
    ref_ev = JaxEvaluator([jann.VideoAnnotation(**a) for a in anns], tmp_loc=tmp_loc)
    for ev in (got_ev, ref_ev):
        _feed(ev, anns, seed=4)
    got, ref = got_ev.summarize(), ref_ev.summarize()
    assert set(got) == set(ref)
    assert any(k.startswith("interrogative") for k in got) != hcstvg
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, k


def test_two_shard_merge_matches_jax(tmp_path):
    """Each shard holds half the videos; the second writes its shard from
    inside the first's barrier. Both merge to the JAX evaluator's summary
    over all the videos."""
    anns = _annotations(6, False)
    port_anns = [ann.VideoAnnotation(**a) for a in anns]
    shards = [VIoUEvaluator(port_anns, save_pred=True) for _ in range(2)]
    _feed(shards[0], anns[:3], seed=5)
    _feed(shards[1], anns[3:], seed=6)
    ref = JaxEvaluator([jann.VideoAnnotation(**a) for a in anns])
    _feed(ref, anns[:3], seed=5)
    _feed(ref, anns[3:], seed=6)
    sync = str(tmp_path / "sync")

    def barrier_writing_other():
        shards[1].synchronize_between_processes(sync, 1, 2, barrier=lambda: None)

    shards[0].synchronize_between_processes(sync, 0, 2, barrier=barrier_writing_other)
    want = ref.summarize()
    for ev in shards:
        assert set(ev.video_predictions) == {a["video_id"] for a in anns}
        got = ev.summarize()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, k
    with pytest.raises(ValueError, match="process_index"):
        shards[0].synchronize_between_processes(sync, process_count=2)
    shards[0].synchronize_between_processes()  # one process: a no-op


def test_query_selectors_match_jax():
    rng = np.random.RandomState(7)
    b, t, nq = 5, 8, 3
    sted = rng.randn(b, t, nq, 2) * 2
    obj = rng.randn(b, t, nq)
    time_mask = np.arange(t)[None] < np.array([8, 8, 5, 3, 6])[:, None]
    video_ids = ["a", "a", "b", "c", "c"]  # clips of one video are adjacent
    np.testing.assert_array_equal(post.select_query_by_sted(sted, time_mask, video_ids),
                                  jpost.select_query_by_sted(sted, time_mask, video_ids))
    np.testing.assert_array_equal(post.select_query_by_objectness(obj, time_mask),
                                  jpost.select_query_by_objectness(obj, time_mask))
    assert set(post.build_postprocessors("vidstg")) == set(jpost.build_postprocessors("vidstg"))
