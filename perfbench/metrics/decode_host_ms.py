"""Median host time (ms) of one decode step, from the serving step's entry
to its return: the ``bench.decode_step`` spans of the traced requests."""
import statistics


def read(ctx):
    spans = ctx.trace.spans("bench.decode_step") if ctx.trace else []
    return statistics.median(spans) * 1e3 if spans else None
