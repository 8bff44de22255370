"""Kernel launches a million samples in the traced films, counted from the
profiler's runtime and driver launch calls (the benchmark's own copies of
query rays left out)."""


def read(ctx):
    launches = ctx["trace"]["launches"]
    if not launches or not ctx["samples"]:
        return None
    return launches / (ctx["samples"] / 1e6)
