"""The joint attention's share of its roofline: the least time of the
profiled steps' joint attention (its operations at the bf16 peak, or q, k,
v and o once at the memory rate) over the device time of the attention
kernels in the denoise spans (the d = 512 VAE kernels apart)."""

import yardstick

UNIT, LAYER, MOVES = "%", "kernels (ops, csrc)", "images_per_min"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["markers_seen"] != tr["markers_sent"]:
        return None
    dev = tr["span_device_s"].get("denoise.attention", 0.0)
    if dev <= 0:
        return None
    steps = tr["iterations"] * ctx["cell"]["steps_run"]
    return 100.0 * yardstick.cell_step(ctx)["attention"] * steps / dev
