"""The device's idle share over the profiled window: 1 - busy / wall,
busy the union of the trace's device activities."""

UNIT, LAYER, MOVES = "%", "device", "latency_p65_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
