"""What the traffic generators hand back to the harness."""
from __future__ import annotations

import gc
import hashlib
import weakref
from dataclasses import dataclass, field


def seed_for(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose, derived from the run's ``--seed``."""
    h = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def closed(ix) -> weakref.ref:
    """Close the index adapter ``ix``; a weak reference to the program's
    index behind it (``ix.ix``) for :func:`collect`."""
    ix.close()
    return weakref.ref(getattr(ix, "ix", ix))


def collect(program: weakref.ref) -> None:
    """Free a closed index's device memory once the caller has dropped its
    last reference.  The program's index and its mapper refer to each
    other, so an index that outlives its last reference is freed only by
    the cycle collector: without a collection every episode's index would
    stay on the card."""
    if program() is not None:
        gc.collect()


@dataclass
class Window:
    attempted: int                 # requests (lookup calls, insert batches)
    failed: int
    end_to_end: dict               # metric name -> value
    counters: dict = field(default_factory=dict)
    trace: object = None           # trace_read.TraceView of the traced stretch
    #: (probe keys, present mask or None: all present) per traced request
    traced_probes: list = field(default_factory=list)
