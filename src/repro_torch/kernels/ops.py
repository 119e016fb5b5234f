"""Entry points of the index kernels in the layouts the core uses (twin of
the index part of ``repro/kernels/ops.py``).  The attention adapters come
with their kernels in later slices."""
from __future__ import annotations

import torch

from repro_torch.kernels.eh_lookup import eh_lookup, shortcut_lookup
from repro_torch.kernels.ragged_copy import ragged_copy


def eh_lookup_op(keys, st, *, tile: int = 256) -> torch.Tensor:
    """Traditional fused lookup against an ``EHState``."""
    D = 1 << int(st.max_global_depth)
    return eh_lookup(keys, st.directory[:D], st.bucket_keys,
                     st.bucket_vals, st.global_depth, tile=tile)


def shortcut_lookup_op(keys, view_keys, view_vals, global_depth, *,
                       tile: int = 256) -> torch.Tensor:
    """Shortcut fused lookup against a composed view."""
    return shortcut_lookup(keys, view_keys, view_vals, global_depth,
                           tile=tile)


def remap_rows(view, pool, slots, offsets) -> torch.Tensor:
    """Maintenance replay: ``view[slots] = pool[offsets]`` in place (last
    wins); returns ``view``."""
    return ragged_copy(view, pool, slots, offsets)
