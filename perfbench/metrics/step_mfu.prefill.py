"""Model FLOPs utilization (%) of the prefills: the model FLOPs
(``model_cost.prefill_flops``) of the window's untraced prefills over
their summed CUDA-event times (each from the prefill's issue to its first
tokens), over 989 TFLOP/s.  The traced request is left out: the profiler
slows it."""
from perfbench.peaks import BF16_FLOPS_PER_S


def read(ctx):
    c = ctx.counters
    if not c.get("prefill_ms"):
        return None
    return 100.0 * c["prefill_flops"] / (c["prefill_ms"] * 1e-3) \
        / BF16_FLOPS_PER_S
