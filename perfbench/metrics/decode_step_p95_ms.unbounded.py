"""``decode_step_p95_ms`` read per layer, for a cell that has it with no
bound: the 95th percentile over the window's untraced decode steps, each
timed by CUDA events from the previous token to its own."""
import numpy as np


def read(ctx):
    steps = ctx.counters.get("step_ms")
    return float(np.percentile(steps, 95)) if steps else None
