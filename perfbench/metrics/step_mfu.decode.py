"""Model FLOPs utilization (%) of the decode steps: the model FLOPs
(``model_cost.decode_flops``) of the window's untraced decode steps over
their summed CUDA-event times (each from the previous token to the
step's own), over 989 TFLOP/s.  The traced request is left out: the
profiler slows its steps."""
from perfbench.peaks import BF16_FLOPS_PER_S


def read(ctx):
    c = ctx.counters
    if not c.get("decode_ms"):
        return None
    return 100.0 * c["decode_flops"] / (c["decode_ms"] * 1e-3) \
        / BF16_FLOPS_PER_S
