"""Median host time (ms) of one insert call, from its entry to its return:
the ``bench.insert_call`` spans of the traced stretch."""
import statistics


def read(ctx):
    spans = ctx.trace.spans("bench.insert_call") if ctx.trace else []
    return statistics.median(spans) * 1e3 if spans else None
