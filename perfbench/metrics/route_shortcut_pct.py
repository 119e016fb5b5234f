"""Share (%) of the window's routed lookups that the gates sent to the
shortcut: the program's route counters, summed over shards."""


def read(ctx):
    sc = ctx.counters.get("routed_shortcut", 0)
    total = sc + ctx.counters.get("routed_traditional", 0)
    return 100.0 * sc / total if total else None
