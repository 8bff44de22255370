"""Device ms a million samples in the traced films of the kernels launched
inside the port's ``ert::query`` spans (render/geometry.py::
ray_intersect_preliminary: closest hits and shadow rays, every accel route
and the analytic shapes), from perfbench/spans.py's ``span_device_s``.
Nothing to read where no query span ran."""


def read(ctx):
    s = ctx["trace"].get("span_device_s", {}).get("ert::query")
    if s is None or not ctx["samples"]:
        return None
    return 1e3 * s / (ctx["samples"] / 1e6)
