"""Reduction of a torch.profiler chrome trace to what the per-layer
metrics read: the traced window, the device's busy time in it (the union
of kernel, memcpy and memset intervals), kernel launches, the device time
of kernels launched inside the benchmark's query spans, the device
operations that took most time, and the idle gaps labelled by the host
operation in flight."""

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
WINDOW = "perfbench::traced_window"
QUERY = "perfbench::mesh_query"
CAPTURE = "perfbench::capture"


def _spans(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def _inside(t, spans):
    """Whether t lies in one of the sorted, disjoint spans."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][1] < t:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(spans) and spans[lo][0] <= t <= spans[lo][1]


def merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events):
    """{window_s, busy_s, launches, query_kernel_s, kernels_unmatched,
    device_ops, idle_gaps} of one traced window (times in seconds)."""
    win = _spans(events, WINDOW)
    if not win:
        raise ValueError(f"no {WINDOW} span in the trace")
    w0, w1 = win[0][0], win[-1][1]
    queries = _spans(events, QUERY)
    captures = _spans(events, CAPTURE)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    corr_ts = {}
    for e in host:
        if e["cat"] in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                corr_ts[c] = e["ts"]
    launches = sum(1 for e in host if e["name"] in LAUNCHES
                   and not _inside(e["ts"], captures))
    op_time = defaultdict(float)
    query_us = 0.0
    unmatched = 0
    intervals = []
    for e in dev:
        c = e.get("args", {}).get("correlation")
        t_launch = corr_ts.get(c)
        if t_launch is None:
            unmatched += 1
        elif _inside(t_launch, captures):
            continue
        elif _inside(t_launch, queries):
            query_us += e["dur"]
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        intervals.append((a, b))
        op_time[e["name"]] += b - a
    busy = merge(intervals)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    idle = _label_gaps(gaps, [e for e in host
                              if e["cat"] in ("cpu_op", "user_annotation",
                                              "cuda_runtime", "cuda_driver")
                              and e["name"] != WINDOW])
    top = lambda d: [[k, v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "launches": launches, "query_kernel_s": query_us * 1e-6,
            "kernels_unmatched": unmatched, "device_ops": top(op_time),
            "idle_gaps": top(idle)}


def _label_gaps(gaps, host):
    """Idle seconds by the innermost host operation in flight over each
    part of each gap (host operations of one thread nest)."""
    by_tid = defaultdict(list)
    for e in host:
        by_tid[e.get("tid")].append((e["ts"], -e["dur"], e["ts"] + e["dur"],
                                     e["name"]))
    # the thread that issued the most host events: the one that launches
    tid = max(by_tid, key=lambda t: len(by_tid[t])) if by_tid else None
    segments = []            # (start, end, innermost label or None)
    stack = []
    t_prev = float("-inf")

    def emit(t, label):
        nonlocal t_prev
        if t > t_prev:
            segments.append((t_prev, t, label))
        t_prev = max(t_prev, t)

    for ts, _neg, end, name in sorted(by_tid.get(tid, [])):
        while stack and stack[-1][0] <= ts:
            top_end, top_name = stack.pop()
            emit(top_end, top_name)
        emit(ts, stack[-1][1] if stack else None)
        stack.append((end, name))
    while stack:
        top_end, top_name = stack.pop()
        emit(top_end, top_name)
    segments.append((t_prev, float("inf"), None))
    out = defaultdict(float)
    k = 0
    for g0, g1 in sorted(gaps):
        while segments[k][1] <= g0:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < g1:
            a, b, label = segments[j]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                out[label or "(no host operation traced)"] += part
            j += 1
    return out


def reduce_file(path):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce_events(events)
