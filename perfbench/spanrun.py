#!/usr/bin/env python3
"""A traced run of one cell with the port's spans read from its trace:

    python3 perfbench/spanrun.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. It is ``run.py --trace 1`` unchanged (the same
films, trace, metrics, comparison and result line), and besides, from the
same trace, ``spans.reduce_events``' keys: a ``# spans:`` line and a
``# span kernels`` line (each device operation under the innermost span
that launched it) on standard error before run.py's ``# trace:`` line,
and, after run.py's result line, one JSON object on standard output with
the span keys and the span metrics of ``metrics/`` (``SPAN_METRICS``),
the last line. The benchmark's own traced runs print neither until
``devtrace.reduce_events`` carries the span keys (PERF.md, Open
questions)."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout's root, as run.py sets it

from perfbench import devtrace, spans  # noqa: E402

SPAN_METRICS = ("query_device_ms_per_msample.render",
                "volume_device_ms_per_msample.render",
                "rng_device_ms_per_msample.render",
                "driver_idle_ms_per_msample.render")


def with_spans(seen, log):
    """A ``devtrace.reduce_file`` that also puts the trace's span keys into
    ``seen`` and logs their line."""
    def reduce_file(path):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        seen.update(spans.reduce_events(events))
        log(spans.log_line(seen))
        inner = spans.innermost_kernels(events)
        seen["innermost_device_s"] = {k: sum(v.values())
                                      for k, v in inner.items()}
        log("# span kernels (innermost span, top 3 by device s): " + "; ".join(
            f"{k} " + ", ".join(f"{n[:60]} {t:.6f}" for n, t in sorted(
                v.items(), key=lambda kv: -kv[1])[:3])
            for k, v in sorted(inner.items(), key=lambda kv: -sum(
                kv[1].values()))))
        return devtrace.reduce_events(events)
    return reduce_file


def span_metrics(workload, seen):
    """{metric: value or None} of SPAN_METRICS over the traced films."""
    from perfbench import bench

    _spec, _cell, _cfg, mix, _lim = bench.resolve(workload)
    ctx = {"trace": seen, "samples": int(mix["trace_films"]) * mix["width"]
           * mix["height"] * mix["spp"]}
    return {m: bench.metric_reader(m)(ctx) for m in SPAN_METRICS}


def main(argv=None):
    from perfbench import run  # sets the run's environment before torch

    argv = list(sys.argv[1:] if argv is None else argv)
    workload = argv[argv.index("--workload") + 1]
    seen = {}
    devtrace.reduce_file = with_spans(
        seen, lambda msg: print(msg, file=sys.stderr, flush=True))
    rc = run.main(argv + ["--trace", "1"])
    if rc or not seen:
        return rc or 1
    print(json.dumps({"workload": workload,
                      "span_metrics": span_metrics(workload, seen), **seen}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
