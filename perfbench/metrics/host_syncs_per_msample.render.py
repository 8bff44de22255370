"""Host syncs a million samples in the traced films: the integrators'
any_lane gates and the lane pool's own syncs, as the port counts them
(integrators/common.py::counters)."""


def read(ctx):
    c = ctx["counters"]
    if not ctx["samples"]:
        return None
    return (c["host_syncs"] + c["pool_syncs"]) / (ctx["samples"] / 1e6)
