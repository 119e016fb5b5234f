"""The architecture registry (a copy of ``repro/configs``)."""
from repro_torch.configs.base import ArchConfig, get, list_archs, register, ASSIGNED  # noqa: F401
