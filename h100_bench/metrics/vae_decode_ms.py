"""VAE decoder time an image: the decoder's forward spans by CUDA events
over the images decoded."""

UNIT, LAYER, MOVES = "ms", "VAE (models/vae.py)", "images_per_min"


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not sp["decode_calls"]:
        return None
    t = ctx["cell"]["traffic"]
    images = sp["iterations"] * t.get("batch", 1)
    return 1e3 * sp["decode"] / images
