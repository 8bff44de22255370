"""Spans and counters read from outside the port, in the traced films only:
each closest-hit mesh query runs inside a ``perfbench::mesh_query`` span
(and, when asked, its rays are copied aside inside a
``perfbench::capture`` span, which the trace reduction leaves out); the
integrators' host-sync counters are zeroed on entry and read on exit."""

import contextlib

import torch
from torch.profiler import record_function


@contextlib.contextmanager
def instrument(capture=False):
    """Yields ``read()`` -> {"host_syncs", "pool_syncs", "queries",
    "rays": [(N, 8) tensors, one a query, when ``capture``]}."""
    from eradiate_kernel_tpu_torch.integrators import common
    from eradiate_kernel_tpu_torch.render import geometry

    seen = {"queries": 0, "rays": []}
    query = geometry._QUERIES["tiles"]

    def wrapped(tiles, ray):
        seen["queries"] += 1
        if capture:
            with record_function("perfbench::capture"):
                seen["rays"].append(torch.cat(
                    [ray.o, ray.d, _col(ray.mint, ray.o), _col(ray.maxt, ray.o)],
                    -1).to(torch.float32))
        with record_function("perfbench::mesh_query"):
            return query(tiles, ray)

    def read():
        return {**common.counters, **seen}

    geometry._QUERIES["tiles"] = wrapped
    common.counters.update(host_syncs=0, pool_syncs=0)
    try:
        yield read
    finally:
        geometry._QUERIES["tiles"] = query


def _col(v, o):
    return torch.broadcast_to(torch.as_tensor(v, device=o.device),
                              o.shape[:1])[:, None].to(o.dtype)
