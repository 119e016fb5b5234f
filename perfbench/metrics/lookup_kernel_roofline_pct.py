"""Share (%) of the HBM roofline that the lookup kernels reach: the bytes
the traced requests' lookups need, over the published bandwidth, over the
device time of the lookup kernels in the traced stretch.

The bytes do not depend on the index, its route or its structure: 4 for
each probe key read, 4 for each result written, and 8 for the stored pair
of each distinct present key of the request.
"""
import torch

from perfbench.peaks import HBM_BYTES_PER_S

#: the program's EH lookup kernels (``kernels/csrc/eh_lookup.cu``)
KERNELS = ("eh_lookup_kernel", "stacked_lookup_kernel",
           "routed_lookup_kernel")


def lookup_bytes(probes: torch.Tensor, present=None) -> int:
    """Bytes a lookup of ``probes`` needs; ``present`` marks the probes
    whose key is stored (None: all are)."""
    stored = probes if present is None else probes[present]
    return 8 * probes.numel() + 8 * torch.unique(stored).numel()


def is_lookup_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.trace is None or not ctx.traced_probes:
        return None
    kernel_s = ctx.trace.device_seconds(is_lookup_kernel)
    if kernel_s <= 0:
        return None
    memo, total = {}, 0
    for probes, present in ctx.traced_probes:
        key = (probes.data_ptr(), probes.numel(), present is None)
        if key not in memo:
            memo[key] = lookup_bytes(probes, present)
        total += memo[key]
    return 100.0 * total / HBM_BYTES_PER_S / kernel_s
