"""Profiler spans at the layer boundaries of the program.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
runs, so the span lands in the profiler's trace on the clock its device
operations are aligned to, on whichever thread opened it.  With no profiler
running it is one shared no-op context manager, so a span costs one flag
test (a ``record_function`` costs microseconds even when nothing records).

Names carry their layer as a prefix: ``eh.`` for the index API on the
caller's thread, ``mapper.`` for the maintenance runtime on the mapper
threads (or a ``pump()`` caller).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``with`` target that records ``name`` while a profiler runs."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
