"""The denoise step's share of the card's peak: the step's least time,
the frozen ``mmdit_step_flops`` with the blocks' linears at the peak of
the type they compute in, the float embedders and the joint attention at
the bf16 peak, over the measured denoise time a step."""

import yardstick

UNIT, LAYER, MOVES = "%", "denoiser (models/mmdit.py)", "images_per_min"


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not sp["iterations"] or sp["denoise"] <= 0:
        return None
    cfg = ctx["config"]
    t = ctx["cell"]["traffic"]
    f = yardstick.mmdit_step_flops(cfg["mmdit"], (t["height"] // 8, t["width"] // 8),
                                   cfg["txt_tokens"],
                                   ctx["cell"].get("model_batch", t.get("batch", 1)),
                                   t["cfg"] > 1)
    least = (f["block_linears"] / yardstick.PEAK[cfg["linear_peak"]]
             + (f["io_linears"] + f["attention"]) / yardstick.PEAK["bf16"])
    step = sp["denoise"] / (sp["iterations"] * sp["steps_per_iteration"])
    return 100.0 * least / step
