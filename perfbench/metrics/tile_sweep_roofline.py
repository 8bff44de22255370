"""Share of its roofline that the closest-hit mesh queries reach: the least
time the card could take for the queries' work (perfbench/roofline.py,
from the rays and the scene's triangles alone) over the device time of
every kernel launched inside the queries (pre-passes, sort and tile_sweep
alike), in %. Nothing to read where no query ran a kernel."""


def read(ctx):
    work = ctx["work"]
    spent = ctx["trace"]["query_kernel_s"]
    if work is None or work.queries == 0 or spent <= 0:
        return None
    return 100.0 * work.bound()[0] / spent
