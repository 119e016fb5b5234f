"""AdamW (optionally factored), learning-rate schedules, int8 gradient
compression."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw_init, adamw_update)
from repro_torch.optim.schedule import wsd_schedule  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_int8, decompress_int8)
