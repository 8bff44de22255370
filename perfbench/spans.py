"""Reduction of a torch.profiler chrome trace by the port's own spans: the
``ert::`` user annotations of ``eradiate_kernel_tpu_torch/utils/runtime.py::
scoped_phase`` (``ert::render`` down to ``ert::rng``, PERF.md "Tracing").

Over the traced window, as ``devtrace.reduce_events`` takes it (the same
window, the same device operations, the benchmark's ray copies left out):

- ``span_device_s``: for each span name, the device seconds of the
  kernels, memcpys and memsets whose launch (matched by correlation id)
  lies inside a span of that name on the launching thread; inclusive, so
  an operation counts under every name that encloses its launch, once a
  name. Every span name of the window is a key, 0.0 where it launched
  nothing;
- ``span_idle_s``: the device's idle seconds of the window by the
  innermost span in flight on the launching thread (``devtrace``'s gap
  labelling over the spans alone), ``"(none)"`` outside every span;
- ``span_count``: the spans of each name that overlap the window."""

from collections import defaultdict

from . import devtrace

PREFIX = "ert::"
NONE = "(none)"


def _window(events):
    wins = devtrace._spans(events, devtrace.WINDOW)
    if not wins:
        raise ValueError(f"no {devtrace.WINDOW} span in the trace")
    w0, w1 = wins[0][0], wins[-1][1]
    inside = lambda e: ("dur" in e and e["ts"] < w1
                        and e["ts"] + e["dur"] > w0)
    dev = [e for e in events if e.get("cat") in devtrace.DEVICE_CATS
           and inside(e)]
    host = [e for e in events if e.get("cat") in devtrace.HOST_CATS
            and inside(e)]
    return w0, w1, dev, host


def _attributed(events):
    """(w0, w1, spans, [(device event, clipped start, clipped end, names of
    the spans enclosing its launch, innermost first)])."""
    w0, w1, dev, host = _window(events)
    captures = devtrace._spans(events, devtrace.CAPTURE)
    launch = {}
    for e in host:
        if e["cat"] in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e["ts"], e.get("tid"))
    spans = [e for e in host if e["cat"] == "user_annotation"
             and e["name"].startswith(PREFIX)]
    by_tid = defaultdict(list)
    for e in spans:
        by_tid[e.get("tid")].append((e["ts"], -e["dur"], e["ts"] + e["dur"],
                                     e["name"]))
    launches = defaultdict(list)     # tid -> [(launch ts, device event)]
    ops = []
    for e in dev:
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None and devtrace._inside(t[0], captures):
            continue
        if t is not None:
            launches[t[1]].append((t[0], len(ops)))
        ops.append([e, max(e["ts"], w0), min(e["ts"] + e["dur"], w1), ()])
    for tid, ls in launches.items():
        # the spans of one thread nest: sweep them and the launches in order
        opened = sorted(by_tid.get(tid, []))
        stack, k = [], 0
        for ts, i in sorted(ls):
            while k < len(opened) and opened[k][0] <= ts:
                while stack and stack[-1][0] < opened[k][0]:
                    stack.pop()
                stack.append((opened[k][2], opened[k][3]))
                k += 1
            while stack and stack[-1][0] < ts:
                stack.pop()
            ops[i][3] = tuple(name for _end, name in reversed(stack))
    return w0, w1, spans, ops


def reduce_events(events):
    """{span_device_s, span_idle_s, span_count} of one traced window
    (times in seconds)."""
    w0, w1, spans, ops = _attributed(events)
    count = defaultdict(int)
    for e in spans:
        count[e["name"]] += 1
    device_us = dict.fromkeys(count, 0.0)
    for _e, a, b, names in ops:
        for name in set(names):
            device_us[name] += b - a
    edge, gaps = w0, []
    for a, b in devtrace.merge((a, b) for _e, a, b, _n in ops):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    idle = devtrace._label_gaps(gaps, spans)
    return {"span_device_s": {k: v * 1e-6 for k, v in device_us.items()},
            "span_idle_s": {(k if k.startswith(PREFIX) else NONE): v * 1e-6
                            for k, v in idle.items()},
            "span_count": dict(count)}


def kernels_inside(events, *names):
    """{device operation name: seconds} of the operations launched inside
    a span of each of ``names`` at once."""
    out = defaultdict(float)
    for e, a, b, within in _attributed(events)[3]:
        if all(n in within for n in names):
            out[e["name"]] += (b - a) * 1e-6
    return dict(out)


def innermost_kernels(events):
    """{innermost span name or "(none)": {device operation name: seconds}}:
    every device operation of the window once, under the innermost span in
    flight at its launch."""
    out = defaultdict(lambda: defaultdict(float))
    for e, a, b, names in _attributed(events)[3]:
        out[names[0] if names else NONE][e["name"]] += (b - a) * 1e-6
    return {k: dict(v) for k, v in out.items()}


def log_line(summary):
    """One line: per span name, the count, the device seconds and the
    innermost idle seconds, by device seconds."""
    dev, idle = summary["span_device_s"], summary["span_idle_s"]
    names = sorted(summary["span_count"], key=lambda k: -dev.get(k, 0.0))
    parts = [f"{k} n={summary['span_count'][k]} device {dev.get(k, 0.0):.6f}"
             f" s idle {idle.get(k, 0.0):.6f} s" for k in names]
    parts.append(f"{NONE} idle {idle.get(NONE, 0.0):.6f} s")
    return "# spans: " + "; ".join(parts)
