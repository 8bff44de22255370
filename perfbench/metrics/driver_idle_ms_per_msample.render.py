"""The device's idle ms a million samples in the traced films while the
render driver's own code was the innermost span in flight (``ert::render``,
``ert::pass``, ``ert::pool.iteration``, ``ert::pool.harvest``,
``ert::pool.refill``, ``ert::film``), from perfbench/spans.py's
``span_idle_s``. Nothing to read where none of those spans ran."""

DRIVER = ("ert::render", "ert::pass", "ert::pool.iteration",
          "ert::pool.harvest", "ert::pool.refill", "ert::film")


def read(ctx):
    t = ctx["trace"]
    ran = [k for k in DRIVER if k in t.get("span_count", {})]
    if not ran or not ctx["samples"]:
        return None
    idle = sum(t["span_idle_s"].get(k, 0.0) for k in ran)
    return 1e3 * idle / (ctx["samples"] / 1e6)
