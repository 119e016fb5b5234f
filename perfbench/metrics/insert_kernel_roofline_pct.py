"""Share (%) of the HBM roofline that the insert kernel reaches: 8 bytes
read and 8 written for each key inserted in the traced stretch, over the
published bandwidth, over the device time of ``eh_insert_kernel`` there."""
from perfbench.peaks import HBM_BYTES_PER_S

KERNEL = "eh_insert_kernel"
BYTES_PER_KEY = 16


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.counters.get("keys_inserted_traced", 0)
    kernel_s = ctx.trace.device_seconds(lambda name: KERNEL in name)
    if n <= 0 or kernel_s <= 0:
        return None
    return 100.0 * BYTES_PER_KEY * n / HBM_BYTES_PER_S / kernel_s
