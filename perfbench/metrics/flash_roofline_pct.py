"""Share (%) of the bfloat16 tensor-core peak that the prefill attention
kernel reaches: the traced prefills' causal (and, on local layers,
windowed) attention FLOPs (``model_cost.flash_flops``) over 989 TFLOP/s,
over the device time of the flash kernels launched within
``bench.prefill``."""
from perfbench import model_cost
from perfbench.peaks import BF16_FLOPS_PER_S

PREFILL = "bench.prefill"
KERNELS = ("flash_tc_kernel", "flash_tf32x3_kernel", "flash_kernel")


def is_flash_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(ctx):
    t = ctx.trace
    traced = ctx.counters.get("traced_requests", [])
    if t is None or ctx.config is None or not traced:
        return None
    secs = t.launched_seconds(PREFILL, match=is_flash_kernel)
    if secs <= 0:
        return None
    flops = sum(model_cost.flash_flops(ctx.config["model"], B, S)
                for B, S, _ in traced)
    return 100.0 * flops / BF16_FLOPS_PER_S / secs
