"""The fp32 VAE encoder's time a request (img2img), by CUDA events."""

UNIT, LAYER, MOVES = "ms", "VAE (models/vae.py)", "images_per_min"


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not sp["vae_encode_calls"]:
        return None
    return 1e3 * sp["vae_encode"] / sp["vae_encode_calls"]
