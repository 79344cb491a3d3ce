"""The denoise spans' device time over their steps: from the last text
encoder's end to the VAE decoder's start (less a VAE encode between), by
CUDA events in the hooks, over the iterations after the profiled ones."""

UNIT, LAYER, MOVES = "ms", "pipeline and graph (pipeline.py, graphs.py)", "images_per_min"


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not sp["iterations"] or sp["denoise"] <= 0:
        return None
    return 1e3 * sp["denoise"] / (sp["iterations"] * sp["steps_per_iteration"])
