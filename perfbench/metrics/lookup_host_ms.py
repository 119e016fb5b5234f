"""Median host time (ms) of one lookup call, from its entry to its return:
the ``bench.lookup_call`` spans of the traced stretch."""
import statistics


def read(ctx):
    spans = ctx.trace.spans("bench.lookup_call") if ctx.trace else []
    return statistics.median(spans) * 1e3 if spans else None
