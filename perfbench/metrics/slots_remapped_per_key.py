"""View slots the mapper rewired (``MaintenanceStats.slots_remapped``,
summed over the window's indexes and shards) per key inserted."""


def read(ctx):
    n = ctx.counters.get("keys_inserted", 0)
    return ctx.counters.get("slots_remapped", 0) / n if n else None
