"""The run's peak device bytes, less the harness's own buffers, per record
of the configuration, in a read run: set while set-up loads the records,
the full index plus the copies that copy-on-write inserts, replays and
publishes (on shards, the stacked view's clones) hold at once."""


def read(ctx):
    m = ctx.memory
    if not m or m["peak"] <= 0:
        return None
    return (m["peak"] - m["harness"]) / m["records"]
