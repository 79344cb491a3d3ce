"""Jobs a bucket: the server's ``batch_occupancy`` (images run over the
power-of-two bucket they were padded to), as a share."""

UNIT, LAYER, MOVES = "%", "serving (serve.py)", "latency_p65_s"


def read(ctx):
    s = ctx.get("server")
    if not s or s["batch_occupancy"] is None:
        return None
    return 100.0 * s["batch_occupancy"]
