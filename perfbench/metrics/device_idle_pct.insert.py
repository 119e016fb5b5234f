"""Share (%) of the traced stretch of the insert window in which no operation
ran on the device: 1 - (union of the device operations' intervals) / the
stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
