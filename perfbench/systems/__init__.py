"""Adapters of the program's indexes, one file each: ``build(config,
device)`` returns an object with ``insert``, ``lookup``, ``wait_in_sync``,
``counters``, ``route_traditional`` and ``close``."""
