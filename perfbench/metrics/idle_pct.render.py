"""The device's idle share of the traced window, in %: 1 - (the union of
kernel, memcpy and memset intervals) / (the window's length)."""


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
