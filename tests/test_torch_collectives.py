"""The collective inventory of the port's steps (``parallel/collectives.py``) on 4 gloo ranks.

``tests/test_collectives.py``'s sets for the port's own design, each leg's
one step recorded on every rank (``torch_dist_ranks.collective_ranks``):

* the time-split inference (data=2 x time=2) crosses ``time`` only: the
  trunk's frame gather;
* a ZeRO-1 train step (data=2 x time=2): DDP's all-reduce over the replica
  group (``data x time``), the all-reduces of ``num_boxes`` and the
  metrics over ``data``, the frame gather over ``time``, and the owners'
  broadcasts of their parameters over ``data``. The port's ZeRO-1
  broadcasts each owner's parameters where the JAX package all-gathers
  the updated shards: the same bytes, whole parameters an owner;
* TP + FSDP (data=2 x model=2): the row-parallel all-reduces over
  ``model`` and FSDP's weight all-gathers over ``data``;
* the pipeline (pipe=4): point-to-point hops over ``pipe`` and the
  result's broadcast, no weight gathered;
* each collective is recorded once (the profiler's count of collective
  operators equals the records), and every one is classified by axis.
"""

import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as R
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.parallel.collectives import Collective, summarize
from tubedetr_tpu_torch.parallel.train_step import model_inputs


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("colls")
    torch.manual_seed(3)
    path = str(tmp / "weights.pt")
    torch.save(build_model(R.cfg_of(), device="cpu").state_dict(), path)
    inputs = {k: v.numpy() for k, v in model_inputs(R.batch_of(((5, 8),))).items()}
    ranks = R.spawn(R.collective_ranks, 4, tmp, path, inputs, threads=1)

    def colls(d):
        return [Collective(c["name"], c["kind"], tuple(c["axes"]), c["shapes"], c["result_bytes"],
                           c["group_size"]) for c in d["colls"]]

    return [{leg: (colls(d), d["profiler_events"]) for leg, d in r.items()} for r in ranks]


@pytest.mark.parametrize("leg", ["infer", "zero", "tp_fsdp", "pipe"])
def test_each_collective_counted_once_and_classified(legs, leg):
    for r in legs:
        colls, events = r[leg]
        assert colls and len(colls) == events, (len(colls), events)
        for c in colls:
            assert c.axes and "?" not in c.axes, c


def test_inference_collectives_cross_time_only(legs):
    for r in legs:
        colls, _ = r["infer"]
        assert {c.axes for c in colls} == {("time",)}
        assert {c.kind for c in colls} == {"all-gather"}  # the trunk's frames
        # one video's 8 frames of the trunk's features: a few hundred KB at
        # most; a blow-up means an activation started crossing ranks
        assert sum(c.rank_bytes for c in colls) < 1 << 20


def test_train_zero1_collective_set(legs):
    for r in legs:
        colls, _ = r["zero"]
        got = set(summarize(colls))
        assert {("all-reduce", ("data", "time")), ("all-reduce", ("data",)),
                ("broadcast", ("data",)), ("all-gather", ("time",))} == got, got


def test_train_tp_fsdp_collective_set(legs):
    for r in legs:
        colls, _ = r["tp_fsdp"]
        got = set(summarize(colls))
        assert ("all-reduce", ("model",)) in got and ("all-gather", ("data",)) in got, got
        assert {a for _, a in got} <= {("model",), ("data",), ("data", "time")}, got
        assert {k for k, _ in got} <= {"all-reduce", "all-gather", "reduce-scatter"}, got


def test_pipeline_collectives_are_hops_and_the_result(legs):
    for stage, r in enumerate(legs):
        colls, _ = r["pipe"]
        kinds = {c.kind for c in colls}
        assert kinds <= {"send", "recv", "broadcast"}, kinds
        assert all(c.axes == ("pipe",) for c in colls)
        assert ("send" in kinds) == (stage < 3) and ("recv" in kinds) == (stage > 0)
        for c in colls:  # a hop is one microbatch, the broadcast the (8, 8) result
            assert c.result_bytes == (2 * 8 * 4 if c.kind in ("send", "recv") else 8 * 8 * 4), c
