"""The linear layers' share of their roofline: the least time of the
profiled steps' linears (from the configuration's shapes at the peak of
the type they compute in, or their weights and activations once at the
memory rate) over the device time, in the denoise spans, of every kernel
the map assigns to linears (the library's GEMMs, C, #13, E, #10, #11,
#16, their GEMVs, and the quantizers A', D and #4 that feed them)."""

import yardstick

UNIT, LAYER, MOVES = "%", "kernels (ops, csrc)", "images_per_min"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["markers_seen"] != tr["markers_sent"]:
        return None
    dev = tr["span_device_s"].get("denoise.linear", 0.0)
    if dev <= 0:
        return None
    steps = tr["iterations"] * ctx["cell"]["steps_run"]
    return 100.0 * yardstick.cell_step(ctx)["linears"] * steps / dev
