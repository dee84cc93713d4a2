"""What the program's own spans and counters say about a traced run.

The program records them itself (``vln_ver_tpu_torch.utils.profiling``)
exactly while a torch profiler runs, so in a ``--trace 1`` run they are
those of the profiled phase, the phase whose trace ``run.trace`` holds.
Spans and the trace share a clock (``time.time_ns()``, the profiler's),
so the device's idle time is put down to spans:

* the trace's device rows are merged into busy intervals;
* each stretch of a gap between two busy intervals goes to the innermost
  span open during it on the calling thread, the thread that opened the
  cell's root span (the first of ``ROOTS`` that opened outside any other
  span), so that a gap the host spends partly in one span and partly in
  the next is split between them;
* idle time with no span open goes to ``outside`` (the benchmark's own
  loop), as does the window's idle time before the first and after the
  last busy interval.

Shares are of the trace's window, as ``device_idle`` is, so the shares
of every span and ``outside`` add up to ``device_idle``.  Each function
returns None where the program recorded nothing (a program without the
recorder reads as one that recorded nothing).

A span's device ms is the time between its CUDA event pair on the
stream: the stream's wall time through the span, idle stretches
included, and not the device's busy time.  Since the spans are read in
the profiled phase, whose host launches the profiler slows, a
host-bound span reads longer here than the same boundary does without
the profiler.

Run as a module, it reports one profiled window of a cell as a
``--trace 1`` run has it, one JSON line on standard output: the
device's idle time by span (``idle_by_span``), each span's count and
mean host and device ms, the counters, and the check of the shared
clock (``clock``)::

    python -m verbench.program_spans --workload ver36-dump-b8 --seed 7 \
        [--seconds S] [--out FILE]
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

ROOTS = ("ver_writer#dump", "train#step", "ver#forward")
OUTSIDE = "outside"


def recording() -> Optional[dict]:
    """The program's latest recording (``spans``, ``counters``), or None."""
    try:
        from vln_ver_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    if not rec or not (rec["spans"] or rec["counters"]):
        return None
    return rec


def _named(rec, name):
    return [s for s in rec["spans"] if s["name"] == name]


def device_ms(name: str, per: str = None) -> Optional[float]:
    """Device ms of the spans ``name``, summed, over the number of spans
    ``per`` (by default, of ``name``)."""
    rec = recording()
    if rec is None:
        return None
    times = [s["device_ms"] for s in _named(rec, name)
             if s["device_ms"] is not None]
    n = len(_named(rec, per)) if per else len(times)
    return sum(times) / n if times and n else None


def host_ms(name: str) -> Optional[float]:
    """Host ms of a span ``name``, the mean over the closed ones."""
    rec = recording()
    if rec is None:
        return None
    times = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in _named(rec, name)
             if s["end_ns"] is not None]
    return sum(times) / len(times) if times else None


def counter(name: str, per: str = None) -> Optional[float]:
    """A counter, over the number of spans ``per`` where one is named."""
    rec = recording()
    if rec is None or name not in rec["counters"]:
        return None
    n = len(_named(rec, per)) if per else 1
    return rec["counters"][name] / n if n else None


def calling_thread(rec) -> Optional[int]:
    for root in ROOTS:
        for s in rec["spans"]:
            if s["name"] == root and s["parent"] is None:
                return s["thread"]
    return None


def _gaps(dev):
    """(start ns, ns) of each gap between the busy intervals of the device
    rows ``dev`` (sorted by start), and the busy ns."""
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(merged[i][1], merged[i + 1][0] - merged[i][1])
            for i in range(len(merged) - 1)]
    return gaps, sum(e - s for s, e in merged)


def _innermost(rec, thread):
    """[(t, span index or ``OUTSIDE``)]: from each time t on, until the
    next, the innermost span open on ``thread``."""
    spans = rec["spans"]
    bounds = []
    for i, s in enumerate(spans):
        if s["thread"] == thread and s["end_ns"] is not None:
            bounds += [(s["start_ns"], 1, i), (s["end_ns"], 0, i)]
    # at one time, ends before starts, and an outer span (opened first,
    # so a lower index) before the spans inside it
    bounds.sort()
    steps, stack = [], []
    for t, opens, i in bounds:
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        steps.append((t, stack[-1] if stack else OUTSIDE))
    return steps


def attribute(rec, dev, window_s: float) -> Dict[object, float]:
    """Seconds of idle device time by span index (``OUTSIDE`` for none),
    by the rule of the module docstring."""
    steps = _innermost(rec, calling_thread(rec))
    gaps, busy_ns = _gaps(dev)
    out: Dict[object, float] = collections.defaultdict(float)
    k, label = 0, OUTSIDE
    for at, ns in gaps:
        while k < len(steps) and steps[k][0] <= at:
            label = steps[k][1]
            k += 1
        t, end = at, at + ns
        while k < len(steps) and steps[k][0] < end:
            out[label] += (steps[k][0] - t) / 1e9
            t, label = steps[k]
            k += 1
        out[label] += (end - t) / 1e9
    edges = window_s - busy_ns / 1e9 - sum(ns for _, ns in gaps) / 1e9
    out[OUTSIDE] += max(edges, 0.0)
    return out


def _attributed(run):
    """``attribute`` of the run's recording and trace, once a run."""
    if run.trace is None:
        return None
    cached = getattr(run, "_idle_by_span_index", None)
    if cached is None:
        rec = recording()
        if rec is None or calling_thread(rec) is None:
            return None
        cached = (rec, attribute(rec, run.trace._dev, run.trace.window_s))
        run._idle_by_span_index = cached
    return cached


def _within(rec, i, name) -> bool:
    """Whether span ``i`` is a span ``name`` or opened inside one."""
    spans = rec["spans"]
    while i is not None:
        if spans[i]["name"] == name:
            return True
        i = spans[i]["parent"]
    return False


def idle_in(run, name: str) -> Optional[float]:
    """The share (%) of the traced window that the device sat idle while
    the calling thread was in a span ``name`` (or one opened inside it)."""
    got = _attributed(run)
    if got is None:
        return None
    rec, secs = got
    total = sum(s for i, s in secs.items()
                if i != OUTSIDE and _within(rec, i, name))
    return 100.0 * total / run.trace.window_s


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """The share (%) of the traced window that the device sat idle, by the
    innermost span open on the calling thread (``outside`` for none)."""
    got = _attributed(run)
    if got is None:
        return None
    rec, secs = got
    out: Dict[str, float] = collections.defaultdict(float)
    for i, s in secs.items():
        name = OUTSIDE if i == OUTSIDE else rec["spans"][i]["name"]
        out[name] += 100.0 * s / run.trace.window_s
    return dict(out)


def span_stats(rec) -> Dict[str, dict]:
    """Each span name's count, mean host ms and mean device ms (None
    without event pairs)."""
    out: Dict[str, dict] = {}
    for s in rec["spans"]:
        st = out.setdefault(s["name"], {"n": 0, "host": [], "device": []})
        st["n"] += 1
        if s["end_ns"] is not None:
            st["host"].append((s["end_ns"] - s["start_ns"]) / 1e6)
        if s["device_ms"] is not None:
            st["device"].append(s["device_ms"])
    return {k: {"n": v["n"],
                "host_ms": sum(v["host"]) / len(v["host"]) if v["host"]
                else None,
                "device_ms": sum(v["device"]) / len(v["device"])
                if v["device"] else None}
            for k, v in out.items()}


def _rows(events):
    """Kineto's events as rows (start_ns, end_ns, name, correlation id):
    the host's (the program's ranges among them), the device's (without
    the ranges the profiler draws on the device's timeline) and the CUDA
    runtime and driver calls (``cuda*``, ``cu*``), by correlation id."""
    from .trace import _RANGE

    host, dev, calls = [], [], {}
    for e in events:
        start = int(e.start_ns())
        name = e.name()
        row = (start, start + int(e.duration_ns()), name,
               int(e.correlation_id()))
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            if not (e.is_user_annotation() or _RANGE.match(name)):
                dev.append(row)
        elif kind.endswith("CPU"):
            host.append(row)
            if name.startswith("cu") and row[3]:
                calls[row[3]] = row
    return host, dev, calls


def _summary(values):
    if not values:
        return None
    values = sorted(values)
    return {"n": len(values), "least_us": values[0] / 1e3,
            "median_us": values[len(values) // 2] / 1e3,
            "most_us": values[-1] / 1e3}


def clock(rec, events) -> dict:
    """Whether the spans' clock (``time.time_ns()``) is the trace's.

    ``host``: each span's own ``record_function`` range in the trace,
    paired with the span by name and order of start, opens ``lead`` after
    the span's recorded start and closes ``tail`` before its recorded
    end.  Were the trace's host clock ahead of the spans' by d, every
    lead would read at least d, and every tail at least -d: d lies in
    [-least tail, least lead].  ``device``: a kernel or copy starts
    ``launch_lag`` after the host call that launched it (paired by
    correlation id) and ends ``sync_slack`` before a
    ``cudaDeviceSynchronize`` that began after that launch returns;
    the device's clock is ahead of the host's trace by at most the least
    lag and behind it by at most the least slack.  ``lift``: the k-th row
    of the lift's kernel starts ``lag`` after the host start of the
    ⌈k/3⌉-th ``ver#encoder`` span on the calling thread (three launches a
    forward at the benchmark's shapes)."""
    host, dev, calls = _rows(events)
    out: dict = {}
    by_name = collections.defaultdict(list)
    for row in host:
        by_name[row[2]].append(row)
    lead, tail, unpaired = [], [], 0
    spans = collections.defaultdict(list)
    for s in rec["spans"]:
        if s["end_ns"] is not None:
            spans[s["name"]].append(s)
    for name, ours in spans.items():
        theirs = sorted(by_name.get(name, []))
        if len(theirs) != len(ours):
            unpaired += len(ours)
            continue
        ours.sort(key=lambda s: s["start_ns"])
        for s, r in zip(ours, theirs):
            lead.append(r[0] - s["start_ns"])
            tail.append(s["end_ns"] - r[1])
    out["host"] = {"lead": _summary(lead), "tail": _summary(tail),
                   "unpaired_spans": unpaired,
                   "outside": sum(x < 0 for x in lead + tail)}
    if lead:
        out["host"]["offset_us"] = [-min(tail) / 1e3, min(lead) / 1e3]
    if not dev:
        out["device"] = None
        return out
    lags, launched = [], []
    for r in dev:
        call = calls.get(r[3])
        if call is not None:
            lags.append(r[0] - call[0])
            launched.append((call[1], r[1]))
    launched.sort()
    slack, k, last = [], 0, None
    for s, e, name, _ in sorted(r for r in host
                                if r[2] == "cudaDeviceSynchronize"):
        while k < len(launched) and launched[k][0] <= s:
            end = launched[k][1]
            last = end if last is None else max(last, end)
            k += 1
        if last is not None:
            slack.append(e - last)
    out["device"] = {"launch_lag": _summary(lags),
                     "sync_slack": _summary(slack),
                     "outside": sum(x < 0 for x in lags + slack)}
    if lags and slack:
        out["device"]["offset_us"] = [-min(slack) / 1e3, min(lags) / 1e3]
    thread = calling_thread(rec)
    enc = sorted(s["start_ns"] for s in rec["spans"]
                 if s["name"] == "ver#encoder" and s["thread"] == thread)
    kern = sorted(r[0] for r in dev if "deform_attn_2d_kernel" in r[2])
    n = min(len(kern), 3 * len(enc))
    lift = [kern[k] - enc[k // 3] for k in range(n)]
    out["lift"] = dict(_summary(lift) or {},
                       outside=sum(x < 0 for x in lift)) if lift else None
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import types
    from pathlib import Path

    p = argparse.ArgumentParser(prog="python -m verbench.program_spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="the profiled window (default: the cell's "
                        "trace_seconds, as a --trace 1 run has it)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None, help="also append the line here")
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from .bench import Cell, env_for_caches
    from .trace import TraceSummary

    root = Path.cwd()
    env_for_caches(root)
    cell = Cell(root, args.workload)
    seconds = args.seconds or float(cell.traffic.get("trace_seconds", 30))
    driver = cell.driver(args.seed, args.device)
    driver.setup()
    activities = [ProfilerActivity.CPU]
    if driver.on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        driver.run_window(seconds)
    events = list(prof.profiler.kineto_results.events())
    summary = TraceSummary(prof, driver.window_s)
    del prof
    rec = recording()
    out = {"workload": args.workload, "seed": args.seed,
           "window_s": driver.window_s, "units": driver.units,
           "device_idle": 100.0 * (1.0 - summary.busy_s / summary.window_s)}
    if rec is not None:
        idle = idle_by_span(types.SimpleNamespace(trace=summary))
        out.update(idle_by_span=idle,
                   idle_sum=sum(idle.values()) if idle else None,
                   spans=span_stats(rec), counters=rec["counters"],
                   clock=clock(rec, events))
    driver.release()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
