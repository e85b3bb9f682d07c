"""The port's spans and counters (``utils/trace.py``) on the CPU: nothing is
recorded with tracing off; under a CPU ``torch.profiler`` a pipelined pair
of training steps (step 2 dispatched before step 1 is converted) records
the detector's span tree, one request id per step shared by its dispatch
and its convert, the uploaded bytes and the served detections; the
recorder's stamps agree with kineto's events for its ``mdt.`` ranges; and
the results are bit-equal with tracing on and off."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)
MODELS = ["retina_unet", "mrcnn", "detection_unet"]
# each span's parents in one training step and its convert, on the CPU (no
# host copy to wait for there; Mask R-CNN's RoI levels and detection targets
# copy a constant to the device from pageable memory)
_STEP = {"dispatch": {None}, "upload": {"dispatch"}, "forward": {"dispatch"}, "losses": {"dispatch"},
         "backward": {"dispatch"}, "update": {"dispatch"}, "host_copies": {"dispatch"}, "convert": {None},
         "assemble": {"convert"}}
TREE = {
    "retina_unet": dict(_STEP, refine={"dispatch"}),
    "mrcnn": dict(_STEP, refine={"dispatch"}, proposals={"dispatch"}, classify_all={"dispatch"}, targets={"losses"},
                  wait={"classify_all", "targets", "losses"}),
    "detection_unet": _STEP,
}
# float32 constant vectors of 2 * dim a step uploads besides its batch: the
# refinement's scale, std and window; Mask R-CNN's loss scale, proposal
# layer (3) and detection targets' std besides
CONSTANTS = {"retina_unet": 3, "mrcnn": 8, "detection_unet": 0}


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def _net_and_batches(model):
    cf = make_config(model=model, dim=3, patch_size=[32, 32, 8], retina_scales=model != "mrcnn")
    net = build_model(cf, _Log(), device="cpu")
    net.initialize(seed=4)
    return net, [make_batch(cf, seed=40 + i) for i in range(2)]


def _batch_bytes(model, cf, batch):
    """Bytes of a training batch as it goes up: float32 image, padded GT
    boxes (float32 coordinates, int32 ids, bool flags), int32 seg labels or
    Mask R-CNN's uint8 GT masks in ``max_gt_boxes`` slots."""
    n, voxels = batch["data"].shape[0], batch["data"][0, 0].size
    image, gt = n * voxels * 4, n * cf.max_gt_boxes * (6 * 4 + 4 + 1)
    return {"retina_unet": image + gt + n * voxels * 4, "mrcnn": image + gt + n * cf.max_gt_boxes * voxels,
            "detection_unet": image + n * voxels * 4}[model]


def _pipelined_pair(net, batches):
    """Step 2 dispatched before step 1 is converted, and converted without
    the full-volume seg copy, as exec's trainer runs them."""
    h1 = net.train_forward_dispatch(batches[0])
    h2 = net.train_forward_dispatch(batches[1])
    return [net.train_forward_convert(h, b, need_seg_preds=False) for h, b in zip((h1, h2), batches)], (h1, h2)


@pytest.mark.parametrize("model", MODELS)
def test_nothing_recorded_with_tracing_off(model):
    net, batches = _net_and_batches(model)
    trace.enable()
    trace.count("earlier", 1)
    trace.disable()
    before = trace.summary()
    assert trace.span("dispatch") is trace.span("wait", what="x")  # one shared no-op
    net.train_forward(batches[0])
    net.test_forward(batches[1])
    assert trace.summary() == before


@pytest.mark.parametrize("model", MODELS)
def test_profiled_pipelined_steps_record_the_span_tree(model):
    net, batches = _net_and_batches(model)
    net.train_forward(batches[1])  # a warm-up step with tracing off ends any earlier recording
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results, handles = _pipelined_pair(net, batches)
    recs = trace.records()
    by_id = {r["id"]: r for r in recs}
    parents = {}
    for r in recs:
        parents.setdefault(r["name"], set()).add(None if r["parent"] is None else by_id[r["parent"]]["name"])
    assert parents == TREE[model]
    assert all(r["attrs"] == {"kind": "train"} for r in recs if r["name"] == "dispatch")

    # one request id per step: its dispatch, its convert and every span under them
    rids = [h.rid for h in handles]
    assert rids[0] != rids[1]
    for rid in rids:
        assert sorted(r["name"] for r in recs if r["rid"] == rid and r["parent"] is None) == ["convert", "dispatch"]
    assert {r["rid"] for r in recs} == set(rids)

    s = trace.summary()
    assert s["spans"]["dispatch"]["count"] == 2 and all(v["device_ms"] is None for v in s["spans"].values())
    dispatch = s["spans"]["dispatch"]
    assert dispatch["self_ms"] < dispatch["host_ms"]
    counters = s["counters"]
    batch_bytes = sum(_batch_bytes(model, net.cf, b) for b in batches)
    assert counters["upload.bytes"] == batch_bytes + 2 * CONSTANTS[model] * 6 * 4
    served = sum(box["box_type"] == "det" for res in results for boxes in res["boxes"] for box in boxes)
    assert counters["detections"] == served
    if model == "mrcnn":
        assert counters["k2.slots"] == 2 * net.cf.batch_size * net.cf.post_nms_rois_training
        assert counters["k1.lanes"] == 2 * (net.cf.batch_size + net.cf.batch_size * (net.cf.head_classes - 1))
        assert 0 < counters["proposals"] <= 2 * net.cf.batch_size * net.cf.post_nms_rois_training

    # the recorder's stamps and kineto's events for the same mdt. ranges
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            kineto.setdefault(e.name()[len(trace.PREFIX):], []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in TREE[model]:
        ours = sorted((r["start_ns"], r["end_ns"]) for r in recs if r["name"] == name)
        theirs = sorted(kineto[name])
        assert len(ours) == len(theirs), name
        for (s0, e0), (s1, e1) in zip(ours, theirs):
            assert abs(s0 - s1) < 1e6 and abs(e0 - e1) < 1e6, (name, s0 - s1, e0 - e1)


@pytest.mark.parametrize("model", MODELS)
def test_results_bit_equal_with_tracing_on_and_off(model):
    outs = {}
    for on in (False, True):
        net, batches = _net_and_batches(model)
        if on:
            trace.enable()
        try:
            results, _ = _pipelined_pair(net, batches)
            grads = [p.grad.clone() for p in net.module.parameters()]
            served = net.test_forward(batches[0])
        finally:
            trace.disable()
        outs[on] = (results, grads, served)
    assert trace.summary()["spans"]["dispatch"]["count"] == 3
    (r0, g0, t0), (r1, g1, t1) = outs[False], outs[True]
    assert [r["loss"] for r in r0] == [r["loss"] for r in r1]
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    for a, b in zip(r0 + [t0], r1 + [t1]):
        np.testing.assert_array_equal(a["seg_preds"], b["seg_preds"])
        for boxes_a, boxes_b in zip(a["boxes"], b["boxes"]):
            assert len(boxes_a) == len(boxes_b)
            for x, y in zip(boxes_a, boxes_b):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])


def test_span_totals_self_time_and_accumulator():
    times = {"forward": 0.0}
    with trace.span("predictor.forward", into=times):  # tracing off: only the accumulator
        pass
    assert times["forward"] > 0.0
    trace.enable()
    try:
        with trace.span("outer", rid=7, kind="x"):
            with trace.span("inner"):
                sum(range(10000))
            trace.count("things", 3)
            trace.count("things", 2)
    finally:
        trace.disable()
    trace.count("things", 100)  # off: not counted
    s = trace.summary()
    outer, inner = s["spans"]["outer"], s["spans"]["inner"]
    assert outer["self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"], abs=1e-9)
    assert s["counters"] == {"things": 5}
    assert [(r["name"], r["rid"]) for r in trace.records()] == [("inner", 7), ("outer", 7)]
    trace.enable()  # a new recording starts empty
    trace.disable()
    assert trace.summary()["spans"] == {} and trace.records() == []
