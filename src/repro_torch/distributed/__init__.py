"""The logical-axis sharding rules over an abstract mesh shape."""
from repro_torch.distributed.sharding import (  # noqa: F401
    batch_spec, logical_spec, param_specs, shardings_for, ShardingRules)
