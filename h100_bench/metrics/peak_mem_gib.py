"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in GiB."""

UNIT, LAYER, MOVES = "GiB", "device", "images_per_min"


def read(ctx):
    b = ctx.get("peak_bytes")
    return None if not b else b / 2**30
