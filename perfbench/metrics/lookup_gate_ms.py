"""Median host time (ms) that one lookup call spends in the index's gates:
the program's ``eh.gate`` spans (``repro_torch/runtime/spans.py``: the flat
index's version and fan-in gate, the sharded index's gates of all shards)
summed inside each ``bench.lookup_call`` span of the traced stretch."""
import bisect
import statistics

CALL = "bench.lookup_call"
GATE = "eh.gate"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    spans = [(n, s, e) for n, c, s, e in t.host
             if c == "user_annotation" and n in (CALL, GATE)]
    gates = sorted((s, e) for n, s, e in spans if n == GATE)
    if not gates:
        return None
    starts = [s for s, _ in gates]
    per_call = []
    for n, s, e in spans:
        if n != CALL:
            continue
        total = 0.0
        i = bisect.bisect_left(starts, s)
        while i < len(gates) and gates[i][0] < e:
            if gates[i][1] <= e:
                total += gates[i][1] - gates[i][0]
            i += 1
        per_call.append(total)
    return statistics.median(per_call) * 1e-3 if per_call else None
