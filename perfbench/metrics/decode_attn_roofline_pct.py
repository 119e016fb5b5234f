"""Share (%) of the HBM roofline that the decode attention kernels reach:
the bytes the traced decode steps' attention needs
(``model_cost.decode_attn_bytes``: each visible K and V row, q, the
output, the lengths), over the published bandwidth, over the device time
of ``split_kernel`` and ``combine_kernel`` launched within
``bench.decode_step``."""
from perfbench import model_cost
from perfbench.peaks import HBM_BYTES_PER_S

STEP = "bench.decode_step"
KERNELS = ("split_kernel", "combine_kernel")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def is_decode_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(ctx):
    t = ctx.trace
    traced = ctx.counters.get("traced_requests", [])
    if t is None or ctx.config is None or not any(n for _, _, n in traced):
        return None
    secs = t.launched_seconds(STEP, match=is_decode_kernel)
    if secs <= 0:
        return None
    m, size = ctx.config["model"], ITEMSIZE[ctx.traffic["dtype"]]
    nbytes = sum(model_cost.decode_attn_bytes(m, B, S + i, size)
                 for B, S, n in traced for i in range(n))
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
