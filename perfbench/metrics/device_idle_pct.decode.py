"""Share (%) of the traced requests' decode in which no operation ran on
the device: from the first ``bench.decode_step`` span's start to the end
of the traced stretch (the last request's tokens read), 1 - (union of the
device operations' intervals there) / its length."""

STEP = "bench.decode_step"


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    starts = [s for n, c, s, e in t.host
              if c == "user_annotation" and n == STEP]
    if not starts or min(starts) >= t.t1:
        return None
    a, b = min(starts), t.t1
    busy = sum(max(0.0, min(e, b) - max(s, a))
               for s, e in t.busy_intervals())
    return 100.0 * (1.0 - busy / (b - a))
