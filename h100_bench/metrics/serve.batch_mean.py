"""Images a denoise batch in the window: the server's ``served`` over its
``batches``, both counted by ``GenerationServer.metrics()``."""

UNIT, LAYER, MOVES = "images/batch", "serving (serve.py)", "latency_p65_s"


def read(ctx):
    s = ctx.get("server")
    if not s or not s["batches"]:
        return None
    return s["served"] / s["batches"]
