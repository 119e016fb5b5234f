"""The run's peak device bytes, set-up included, less the harness's own
buffers, per record of the configuration: the resident index plus the
copies that copy-on-write inserts, replays and publishes hold at once."""


def read(ctx):
    m = ctx.memory
    if not m or m["peak"] <= 0:
        return None
    return (m["peak"] - m["harness"]) / m["records"]
