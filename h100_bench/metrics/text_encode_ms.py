"""Text-encoder time a prompt: the encoders' forward spans (CLIP-L/G, or
CLIP-L and the w8a8 T5) by CUDA events, over the prompts encoded."""

UNIT, LAYER, MOVES = ("ms", "text encoders (models/clip.py, models/t5.py, ops/smoothquant.py)",
                      "images_per_min")


def read(ctx):
    sp, cfg = ctx.get("spans"), ctx["config"]
    if not sp or not sp["text_calls"]:
        return None
    per_prompt = sum(k in cfg for k in ("clip_l", "clip_g", "t5"))
    return 1e3 * sp["text"] / (sp["text_calls"] / per_prompt)
