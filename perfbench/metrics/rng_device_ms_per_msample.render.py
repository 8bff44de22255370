"""Device ms a million samples in the traced films of the kernels launched
inside the port's ``ert::rng`` spans (core/rng.py::threefry2x32: every
draw, sampler or seeding), from perfbench/spans.py's ``span_device_s``.
Nothing to read where no draw ran."""


def read(ctx):
    s = ctx["trace"].get("span_device_s", {}).get("ert::rng")
    if s is None or not ctx["samples"]:
        return None
    return 1e3 * s / (ctx["samples"] / 1e6)
