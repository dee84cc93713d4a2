"""The port's recorder of its own spans and counters
(``vln_ver_tpu_torch/utils/profiling.py``): off without a profiler, on
under one; the spans and counters the model, the train step and the dump
emit; and the benchmark's reading of them (``verbench.program_spans``,
``verbench.trace``)."""

import dataclasses
import math
import os
import threading
import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from test_torch_checkpoint import CFG, _batch
from verbench import program_spans
from verbench.trace import _events
from vln_ver_tpu_torch import geometry
from vln_ver_tpu_torch.matching import _CHECK_EVERY, _auction
from vln_ver_tpu_torch.models.detector import build_model
from vln_ver_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_train_step)
from vln_ver_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")

MODEL_SPANS = {"ver#forward", "ver#encoder", "ver#decoder", "ver#branches",
               "ver#occupancy", "ver#upsampler"}
TRAIN_SPANS = {"train#step", "train#forward", "train#losses",
               "train#match", "train#backward", "train#optimizer"}
DUMP_SPANS = {"ver_writer#dump", "ver_writer#next", "ver_writer#prep",
              "ver_writer#wait_prep", "ver_writer#dispatch",
              "ver_writer#fetch", "ver_writer#enqueue", "ver_writer#drain",
              "ver_writer#write"}


def _profiled(fn):
    """``fn()`` under a CPU profiler; (its result, the profiler, the
    recording read after the session)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, tprof.recorded()


def _names(rec):
    return {s["name"] for s in rec["spans"]}


class _Ops(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(func)
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_and_makes_no_range_event_or_tensor_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    latest = tprof._RECORDER.latest
    before = None if latest is None else len(latest.spans)
    t = torch.tensor(3)
    lazy = mock.Mock(return_value=5)
    with mock.patch.object(tprof, "record_function") as rf, \
            mock.patch.object(torch.cuda, "Event") as ev, \
            mock.patch.object(torch.cuda, "is_initialized",
                              return_value=True), _Ops() as ops:
        with tprof.span("test#off"):
            with tprof.span("test#inner", device=False):
                pass
        tprof.count("test#n", 2)
        tprof.count("test#t", t)
        tprof.count("test#lazy", lazy)
    assert not rf.called and not ev.called and not lazy.called
    assert ops.calls == []
    assert tprof._RECORDER.latest is latest
    if latest is not None:
        assert len(latest.spans) == before


def test_spans_nest_by_thread_and_counters_sum():
    def other():
        with tprof.span("test#thread", device=False):
            tprof.count("test#n", 1)

    def work():
        with tprof.span("test#outer"):
            with tprof.span("test#inner"):
                torch.ones(8) * 2
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
            tprof.count("test#n", 2)
            tprof.count("test#t", torch.tensor(4))
            tprof.count("test#t", torch.tensor(5))
            tprof.count("test#lazy", lambda: torch.tensor(2.5))

    _, _, rec = _profiled(work)
    spans = {s["name"]: s for s in rec["spans"]}
    assert set(spans) == {"test#outer", "test#inner", "test#thread"}
    names = [s["name"] for s in rec["spans"]]
    assert spans["test#outer"]["parent"] is None
    assert names[spans["test#inner"]["parent"]] == "test#outer"
    # a span opened on another thread has no parent there
    assert spans["test#thread"]["parent"] is None
    assert spans["test#thread"]["thread"] != spans["test#outer"]["thread"]
    assert spans["test#outer"]["thread"] == threading.get_native_id()
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] is None       # no CUDA here
    assert rec["counters"] == {"test#n": 3.0, "test#t": 9.0,
                               "test#lazy": 2.5}


def test_span_holds_its_ops_on_the_profilers_clock():
    def work():
        with tprof.span("test#mm"):
            return torch.ones(64, 64) @ torch.ones(64, 64)

    _, prof, rec = _profiled(work)
    (s,) = rec["spans"]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() in ("aten::mm", "aten::matmul", "aten::ones")]
    assert len(ops) >= 2
    for e in ops:
        assert s["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s["end_ns"]
    # the range the span opens is in the trace under the span's name
    assert any(e.name() == "test#mm"
               for e in prof.profiler.kineto_results.events())


def test_a_new_session_drops_the_previous_recording():
    def one(name):
        with tprof.span(name):
            pass

    _, _, first = _profiled(lambda: one("test#first"))
    assert _names(first) == {"test#first"}
    assert tprof.recorded() is first        # read again after the session
    _, _, second = _profiled(lambda: one("test#second"))
    assert _names(second) == {"test#second"}


def _tiny(cap=24):
    return dataclasses.replace(CFG, sca_query_capacity=cap)


def test_model_forward_emits_the_model_spans_and_lift_counters():
    cfg = _tiny()
    model = build_model(cfg, "cpu", seed=0).eval()
    b = _batch(0)
    args = (b["features"], b["world2pixel"], b["origin_shift"])
    with torch.inference_mode():
        _, _, rec = _profiled(lambda: model(*args))
    assert _names(rec) == MODEL_SPANS
    spans = rec["spans"]
    by = {s["name"]: i for i, s in enumerate(spans)}
    parent = {s["name"]: (None if s["parent"] is None
                          else spans[s["parent"]]["name"]) for s in spans}
    assert parent == {"ver#forward": None, "ver#encoder": "ver#forward",
                      "ver#decoder": "ver#forward",
                      "ver#branches": "ver#forward",
                      "ver#occupancy": "ver#forward",
                      "ver#upsampler": "ver#occupancy"}
    assert len(by) == len(spans)            # each once a forward
    # the visible (camera, query) pairs, each camera capped, counted
    # from the projection alone
    ref = geometry.voxel_reference_points(cfg.bev_z, cfg.bev_h, cfg.bev_w)
    _, mask = geometry.project_reference_points(
        ref, b["world2pixel"], b["origin_shift"], pc_range=cfg.pc_range)
    per_cam = mask.numpy().reshape(*mask.shape[:2], -1).sum(-1)
    want = np.minimum(per_cam, cfg.sca_query_capacity).sum()
    assert 0 < want < per_cam.size * cfg.sca_query_capacity
    assert rec["counters"]["lift#visible_queries"] == float(want)
    assert rec["counters"]["lift#query_slots"] == float(
        per_cam.size * cfg.sca_query_capacity)


def test_dense_lift_counts_nothing():
    model = build_model(_tiny(cap=0), "cpu", seed=0).eval()
    b = _batch(0)
    with torch.inference_mode():
        _, _, rec = _profiled(lambda: model(
            b["features"], b["world2pixel"], b["origin_shift"]))
    assert "lift#visible_queries" not in rec["counters"]


def test_train_step_emits_the_step_spans_and_auction_counters():
    cfg = _tiny()
    state = create_train_state(build_model(cfg, "cpu", seed=0),
                               TrainConfig(warmup_steps=1, total_steps=10))
    assert state.tc.matcher == "auction"
    step = make_train_step(cfg, state.tc)
    _, _, rec = _profiled(lambda: step(state, _batch(1), seed=0))
    assert _names(rec) == TRAIN_SPANS | MODEL_SPANS
    spans = rec["spans"]
    parent = {s["name"]: (None if s["parent"] is None
                          else spans[s["parent"]]["name"]) for s in spans}
    assert parent["train#step"] is None
    for name in ("train#forward", "train#losses", "train#backward",
                 "train#optimizer"):
        assert parent[name] == "train#step"
    assert parent["train#match"] == "train#losses"
    assert parent["ver#forward"] == "train#forward"
    its = rec["counters"]["match#auction_iterations"]
    assert its >= 1
    assert rec["counters"]["match#auction_syncs"] >= its / _CHECK_EVERY


def test_auction_iterations_counter_matches_the_loop():
    rng = np.random.default_rng(5)
    cost = torch.from_numpy(rng.uniform(0, 10, (3, 12, 5)).astype(
        np.float32))
    _, _, rec = _profiled(lambda: _auction(cost, 500, 1e-3))
    # the loop's iterations, from the loop itself cut short: the fewest
    # iterations after which every column holds a row, rounded up to the
    # checks made every _CHECK_EVERY iterations
    done = next(k for k in range(1, 501)
                if bool((_auction(cost, k, 1e-3) >= 0).all()))
    checks = math.ceil(done / _CHECK_EVERY)
    assert rec["counters"]["match#auction_iterations"] == float(
        min(500, checks * _CHECK_EVERY))
    assert rec["counters"]["match#auction_syncs"] == float(checks)


def test_dump_emits_the_writer_spans_on_their_threads(tmp_path):
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import MP3DDataset, make_synthetic_dataset
    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.ver_writer import dump_volumes

    ver = build_ver_config(load_config(CONFIG))
    root = str(tmp_path / "data")
    ann = make_synthetic_dataset(root, num_scans=1, viewpoints_per_scan=3,
                                 num_cams=ver.num_cams, feat_hw=ver.feat_h,
                                 feat_dim=ver.in_channels)
    dataset = MP3DDataset(ann, root, num_cams=ver.num_cams,
                          feat_hw=ver.feat_h)
    bev_only = make_bev_only(build_model(ver, "cpu", seed=0))
    res, _, rec = _profiled(lambda: dump_volumes(
        bev_only, dataset, ver, str(tmp_path / "ver.h5"), batch_size=2,
        device="cpu"))
    dataset.close()
    assert res["written"] == 3
    assert _names(rec) == DUMP_SPANS | {"ver#forward", "ver#encoder"}
    spans = rec["spans"]
    main = threading.get_native_id()
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s["name"], set()).add(s["thread"])
    (writer,) = by_thread["ver_writer#write"]
    (transfer,) = by_thread["ver_writer#prep"]
    assert len({main, writer, transfer}) == 3
    for name in DUMP_SPANS - {"ver_writer#write", "ver_writer#prep"}:
        assert by_thread[name] == {main}, name
    assert sum(s["name"] == "ver_writer#write" for s in spans) == 3
    dump = next(i for i, s in enumerate(spans)
                if s["name"] == "ver_writer#dump")
    assert all(s["parent"] == dump for s in spans
               if s["name"] in ("ver_writer#drain", "ver_writer#dispatch"))
    assert program_spans.calling_thread(rec) == main


def _run(dev, window_s):
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        _dev=dev, window_s=window_s))


def _span(name, parent, thread, start_ms, end_ms):
    return {"name": name, "parent": parent, "thread": thread,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "device_ms": None}


def test_idle_goes_to_the_innermost_span_open_on_the_calling_thread(
        monkeypatch):
    # busy 0-100, 300-400, 600-650, 900-950 ms of a 1 s window: gaps
    # 100-300, 400-600 and 650-900 ms, 50 ms idle at the end
    dev = [(int(a * 1e6), int(b * 1e6), "k")
           for a, b in ((0, 100), (300, 400), (600, 650), (900, 950))]
    rec = {"spans": [
        _span("ver_writer#dump", None, 1, 50, 700),
        _span("ver_writer#drain", 0, 1, 350, 700),
        _span("test#nested", 1, 1, 390, 420),
        # another thread's spans take no idle time
        _span("ver_writer#write", None, 2, 0, 1000),
    ], "counters": {}}
    monkeypatch.setattr(program_spans, "recording", lambda: rec)
    run = _run(dev, 1.0)
    got = program_spans.idle_by_span(run)
    # 100-300 in the dump; 400-420 nested, 420-600 and 650-700 in the
    # drain; 700-900 and the last 50 ms outside any span
    assert got == pytest.approx({"ver_writer#dump": 20.0,
                                 "test#nested": 2.0,
                                 "ver_writer#drain": 23.0, "outside": 25.0})
    # the shares add up to the device's idle share
    assert sum(got.values()) == pytest.approx(100.0 - 30.0)
    assert program_spans.idle_in(run, "ver_writer#drain") == \
        pytest.approx(25.0)
    assert program_spans.idle_in(run, "ver_writer#dump") == \
        pytest.approx(45.0)
    assert program_spans.idle_in(run, "ver_writer#write") == 0.0


def test_idle_with_no_span_open_goes_outside(monkeypatch):
    dev = [(0, int(1e8), "k"), (int(5e8), int(6e8), "k")]
    rec = {"spans": [_span("ver#forward", None, 7, 700, 800)],
           "counters": {}}
    monkeypatch.setattr(program_spans, "recording", lambda: rec)
    got = program_spans.idle_by_span(_run(dev, 1.0))
    assert got == pytest.approx({"outside": 80.0})


def test_readers_read_nothing_without_a_recording(monkeypatch):
    monkeypatch.setattr(program_spans, "recording", lambda: None)
    run = _run([(0, 1, "k")], 1.0)
    assert program_spans.idle_in(run, "ver#decoder") is None
    assert program_spans.idle_by_span(run) is None
    assert program_spans.device_ms("ver#encoder") is None
    assert program_spans.host_ms("ver_writer#write") is None
    assert program_spans.counter("lift#query_slots") is None


def test_readers_normalise_by_their_spans(monkeypatch):
    spans = [_span("train#step", None, 1, 0, 10),
             _span("train#match", 0, 1, 1, 2),
             _span("train#match", 0, 1, 3, 5),
             _span("train#step", None, 1, 10, 20),
             _span("ver_writer#write", None, 2, 0, 4)]
    spans[1]["device_ms"], spans[2]["device_ms"] = 1.5, 2.5
    rec = {"spans": spans, "counters": {"match#auction_iterations": 32.0}}
    monkeypatch.setattr(program_spans, "recording", lambda: rec)
    assert program_spans.device_ms("train#match", per="train#step") == 2.0
    assert program_spans.device_ms("train#match") == 2.0
    assert program_spans.device_ms("train#step") is None
    assert program_spans.host_ms("ver_writer#write") == pytest.approx(4.0)
    assert program_spans.counter("match#auction_iterations",
                                 per="train#step") == 16.0


def test_trace_reduction_drops_the_programs_ranges():
    def work():
        with tprof.span("ver_writer#write", device=False):
            with tprof.span("ver#encoder"):
                torch.ones(16) + 1

    _, prof, rec = _profiled(work)
    assert _names(rec) == {"ver_writer#write", "ver#encoder"}
    traced = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"ver_writer#write", "ver#encoder"} <= traced
    _, host = _events(prof)
    names = {n for _, _, n in host}
    assert "aten::add" in names
    assert not names & {"ver_writer#write", "ver#encoder"}


def test_span_stats_count_and_average_each_name():
    spans = [_span("ver#forward", None, 1, 0, 10),
             _span("ver#forward", None, 1, 10, 14),
             _span("ver_writer#write", None, 2, 0, 3)]
    spans[0]["device_ms"], spans[1]["device_ms"] = 9.0, 5.0
    got = program_spans.span_stats({"spans": spans, "counters": {}})
    assert got["ver#forward"] == {"n": 2, "host_ms": pytest.approx(7.0),
                                  "device_ms": 7.0}
    assert got["ver_writer#write"] == {"n": 1, "host_ms": pytest.approx(3.0),
                                       "device_ms": None}


def test_clock_pairs_each_span_with_its_own_range_in_the_trace():
    def work():
        with tprof.span("ver#forward"):
            with tprof.span("ver#encoder"):
                torch.ones(32, 32) @ torch.ones(32, 32)
        writer = threading.Thread(target=lambda: tprof.span(
            "ver_writer#write", device=False).__call__(lambda: None)())
        writer.start()
        writer.join()

    def twice():
        work()
        work()

    _, prof, rec = _profiled(twice)
    got = program_spans.clock(rec, prof.profiler.kineto_results.events())
    host = got["host"]
    # the ranges of a thread the profiler did not start on may be missing
    # from the trace; every span of the profiler's own thread is paired
    assert host["outside"] == 0
    assert host["lead"]["n"] == host["tail"]["n"] >= 4
    assert host["lead"]["n"] + host["unpaired_spans"] == 6
    low, high = host["offset_us"]
    assert low <= 0.0 <= high
    assert got["device"] is None


class _Event:
    """A kineto event as ``clock`` reads one."""

    def __init__(self, name, start_ns, end_ns, device="CPU",
                 annotation=False, correlation=0):
        self._row = (name, start_ns, end_ns, device, annotation, correlation)

    def name(self):
        return self._row[0]

    def start_ns(self):
        return self._row[1]

    def duration_ns(self):
        return self._row[2] - self._row[1]

    def device_type(self):
        return f"DeviceType.{self._row[3]}"

    def is_user_annotation(self):
        return self._row[4]

    def correlation_id(self):
        return self._row[5]


def test_clock_bounds_the_device_offset_by_launches_and_syncs():
    us = 1000
    rec = {"spans": [_span("ver#forward", None, 1, 0, 1),
                     _span("ver#encoder", 0, 1, 0, 0.5)],
           "counters": {}}
    events = [
        _Event("ver#forward", 10 * us, 990 * us, annotation=True,
               correlation=1),
        _Event("ver#encoder", 20 * us, 480 * us, annotation=True,
               correlation=2),
        # an op of the host whose own id is a launch's
        _Event("aten::mm", 90 * us, 110 * us, correlation=8),
        # three launches of the lift's kernel, then a sync
        _Event("cudaLaunchKernel", 100 * us, 105 * us,
               correlation=7),
        _Event("cudaLaunchKernel", 200 * us, 205 * us,
               correlation=8),
        _Event("cudaLaunchKernel", 300 * us, 305 * us,
               correlation=9),
        _Event("cudaDeviceSynchronize", 400 * us, 700 * us,
               correlation=10),
        _Event("deform_attn_2d_kernel", 110 * us, 180 * us, "CUDA",
               correlation=7),
        _Event("deform_attn_2d_kernel", 206 * us, 300 * us, "CUDA",
               correlation=8),
        _Event("deform_attn_2d_kernel", 320 * us, 650 * us, "CUDA",
               correlation=9),
        # the profiler's range on the device's timeline is no device row
        _Event("ver#encoder", 110 * us, 650 * us, "CUDA", annotation=True,
               correlation=2),
    ]
    got = program_spans.clock(rec, events)
    assert got["host"]["offset_us"] == pytest.approx([-10.0, 10.0])
    assert got["host"]["outside"] == 0
    dev = got["device"]
    assert dev["launch_lag"]["least_us"] == pytest.approx(6.0)
    assert dev["sync_slack"]["least_us"] == pytest.approx(50.0)
    assert dev["offset_us"] == pytest.approx([-50.0, 6.0])
    assert dev["outside"] == 0
    assert got["lift"]["n"] == 3 and got["lift"]["outside"] == 0
    assert got["lift"]["least_us"] == pytest.approx(110.0)
