"""Device ms a million samples in the traced films of the kernels launched
inside the port's ``ert::volume_eval`` spans (textures/volumes.py::
volume_eval: the einsum and ``grid_gather`` lookups alike, in free flights
and NEE walks), from perfbench/spans.py's ``span_device_s``. Nothing to
read where no volume lookup ran."""


def read(ctx):
    s = ctx["trace"].get("span_device_s", {}).get("ert::volume_eval")
    if s is None or not ctx["samples"]:
        return None
    return 1e3 * s / (ctx["samples"] / 1e6)
