"""The partitioned index: ``repro_torch``'s ``ShardedShortcutEH`` with
``num_shards`` shards on one card, looked up through ``lookup_batched``
(per-shard gates, then one fused launch over the keys in their input
order, each key finding its shard inside the kernel)."""
from __future__ import annotations

from repro_torch.core.sharded_eh import ShardedShortcutEH


class Index:
    def __init__(self, config: dict, device):
        self.ix = ShardedShortcutEH(
            config["max_global_depth"], config["bucket_slots"],
            config["capacity"], num_shards=int(config["num_shards"]),
            fan_in_threshold=float(config["fan_in_threshold"]),
            poll_interval=float(config["poll_interval"]),
            async_mapper=bool(config["async_mapper"]), device=device)

    def insert(self, keys, values) -> None:
        self.ix.insert(keys, values)

    def lookup(self, keys):
        return self.ix.lookup_batched(keys)

    def wait_in_sync(self, timeout: float) -> bool:
        return self.ix.wait_in_sync(timeout)

    def counters(self) -> dict:
        return {"routed_shortcut": self.ix.routed_shortcut,
                "routed_traditional": self.ix.routed_traditional,
                "slots_remapped": self.ix.stats.slots_remapped}

    def route_traditional(self) -> None:
        """Make every shard's gate refuse the shortcut."""
        for s in self.ix.shards:
            s.fan_in_threshold = -1.0

    def close(self) -> None:
        self.ix.close()


def build(config: dict, device) -> Index:
    return Index(config, device)
