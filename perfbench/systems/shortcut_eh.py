"""The flat index: one ``repro_torch`` ``ShortcutEH``, looked up through
``ShortcutEH.lookup`` (the gate picks the route per call)."""
from __future__ import annotations

from repro_torch.core.shortcut_eh import ShortcutEH


class Index:
    def __init__(self, config: dict, device):
        self.ix = ShortcutEH(
            config["max_global_depth"], config["bucket_slots"],
            config["capacity"],
            fan_in_threshold=float(config["fan_in_threshold"]),
            poll_interval=float(config["poll_interval"]),
            async_mapper=bool(config["async_mapper"]), device=device)

    def insert(self, keys, values) -> None:
        self.ix.insert(keys, values)

    def lookup(self, keys):
        return self.ix.lookup(keys)

    def wait_in_sync(self, timeout: float) -> bool:
        return self.ix.wait_in_sync(timeout)

    def counters(self) -> dict:
        return {"routed_shortcut": self.ix.routed_shortcut,
                "routed_traditional": self.ix.routed_traditional,
                "slots_remapped": self.ix.stats.slots_remapped}

    def route_traditional(self) -> None:
        """Make every later gate refuse the shortcut (no fan-in is below
        zero), so lookups read the traditional directory and buckets."""
        self.ix.fan_in_threshold = -1.0

    def close(self) -> None:
        self.ix.close()


def build(config: dict, device) -> Index:
    return Index(config, device)
