"""The shortcut-maintenance runtime."""
from repro_torch.runtime.mapper import (  # noqa: F401
    GLOBAL_VIEW, FanInRouting, FragmentationRouting, HysteresisRouting,
    MaintenanceStats, Request, ShortcutMapper)
