"""Op-level cost accounting of one eager step on one card: the counterpart
of ``repro/launch/hlo_cost.py`` (flops and bytes with loop multipliers,
read from optimized HLO text) and of the cost half of
``repro/launch/hlo_analysis.py`` (the roofline terms).

There is no HLO here.  :class:`OpCounter` is a ``TorchDispatchMode``: it
runs the step and charges every aten op it sees.

  * **flops**: ``2 * M * N * K`` for each matrix product (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``; an ``einsum``
    reaches the counter as its ``bmm``), and the convolutions';
  * **bytes**: the operands plus the result of each materializing op,
    each distinct operand once; views, ``expand``, ``select``, ``unbind``,
    ``detach``, allocations (``empty``) and metadata ops are free;
  * **slices** are charged their window, not the whole buffer, as the
    reference charges a dynamic-slice, a dynamic-update-slice, a gather and
    a scatter (``hlo_cost.py:_instr_bytes``): a gather (``index``,
    ``index_select``, ``gather``, ``embedding``) reads its indices and the
    rows and writes the result; ``copy_`` into a view moves the source and
    the view; ``index_put_`` / ``index_copy_`` / ``scatter_`` read their
    indices and values and write the indexed rows (``index_add_`` and
    ``scatter_add_`` also read them).  The decode step's view writes
    (``runtime/serve.py:_write_row``) are such writes.

The reference needs loop multipliers because XLA counts a ``while`` body
once; an eager loop runs every iteration through the counter.  The backward
pass is counted too: the autograd engine carries the dispatch mode to the
threads that run its nodes, and ``torch.utils.checkpoint``'s recompute runs
inside them.

The port's own kernels are not aten ops.  Each attention wrapper
(``kernels/flash_attention.py``, ``kernels/_decode.py``) hands the counter
its call's flops and bytes through ``kernels/_build.record_cost``: on CUDA
beside its launch, on the meta device instead of it (returning an empty
output).  A step run on meta tensors therefore reckons what the card runs,
kernels included, without touching device memory: the dry run
(``launch/dryrun.py``) does that.

:func:`analyze` also tracks memory under the eager schedule: every storage
the step allocates is counted once, while any tensor still refers to it;
the peak of the live bytes, with the arguments, the outputs and the
temporaries apart.

Not imitated: ``hlo_analysis.collective_stats`` and the ICI term (one card
has no collectives), and ``cost_numbers`` / ``memory_numbers``, which read
XLA's compiled objects.
"""
from __future__ import annotations

import math
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.kernels import _build

#: NVIDIA H100 SXM data sheet (dense, no sparsity, 700 W): bf16 tensor-core
#: FLOP/s, HBM3 bytes/s, and the memory the dry run's ``fits`` holds to
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80 * 2 ** 30
DEVICE = ("NVIDIA H100 SXM 80GB, data sheet: 989 TFLOP/s bf16 dense, "
          "3.35 TB/s HBM3")

_FREE = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "is_same_size", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "resize_", "set_",
         "_record_function_enter_new", "_record_function_exit"}


#: reads of indexed rows: charged the rows, not the source
_GATHERS = {"index", "index_select", "gather", "embedding"}


def _name(func) -> str:
    return func._schema.name.split("::")[-1]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The distinct tensors (by identity) of nested lists, tuples and
    dictionaries, in order."""
    seen, out, stack = set(), [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _matmul_flops(name: str, args) -> int:
    """2 x (result elements) x (contracted length) of a matrix product."""
    if name in ("mm", "bmm", "mv", "dot"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm", "addmv"):
        a, b = args[1], args[2]
    else:
        return 0
    n = b.shape[-1] if name in ("mm", "bmm", "addmm", "baddbmm") else 1
    return 2 * math.prod(a.shape[:-1]) * n * a.shape[-1]


def _conv_flops(args, out) -> int:
    w = args[1]
    return 2 * out.numel() * math.prod(w.shape[1:])


def _index_window(self_: torch.Tensor, indices, values) -> int:
    """Elements an ``index_put_`` writes: the indexed shape of ``self_``."""
    idx = list(indices)
    if any(i is not None and i.dtype == torch.bool for i in idx):
        return values.numel()
    shapes = [i.shape for i in idx if i is not None]
    n = math.prod(torch.broadcast_shapes(*shapes)) if shapes else 1
    rest = [d for d, i in zip(self_.shape, idx) if i is None]
    return n * math.prod(rest) * math.prod(self_.shape[len(idx):])


def _op_bytes(name: str, args, kwargs, out) -> int:
    """Bytes an op moves: the slice-write rules, else operands + result."""
    if name == "copy_":
        return _nbytes(args[0]) + _nbytes(args[1])
    if name in ("fill_", "zero_"):
        return _nbytes(args[0])
    if name in _GATHERS:
        idx = args[1] if name in ("index", "embedding") else args[2]
        idx = sum(_nbytes(t) for t in _tensors(idx))
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + idx
    if name == "index_put_":
        self_, indices, values = args[0], args[1], args[2]
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate")
        window = _index_window(self_, indices, values) \
            * self_.element_size()
        idx = sum(_nbytes(i) for i in indices if i is not None)
        return idx + _nbytes(values) + window * (2 if accumulate else 1)
    if name in ("index_copy_", "index_add_"):
        index, source = args[2], args[3]
        window = source.numel() * args[0].element_size()
        return _nbytes(index) + _nbytes(source) \
            + window * (2 if name == "index_add_" else 1)
    if name in ("scatter_", "scatter_add_", "scatter_reduce_"):
        index = args[2]
        src = args[3] if isinstance(args[3], torch.Tensor) else None
        window = index.numel() * args[0].element_size()
        return _nbytes(index) + (_nbytes(src) if src is not None else 0) \
            + window * (1 if name == "scatter_" else 2)
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in _tensors(out)))


@dataclass
class OpCost:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


@dataclass
class CostTotals:
    """What :func:`analyze` counted: ``flops`` and ``bytes`` in all,
    ``by_op`` per aten op name (``"kernel:<name>"`` for a kernel of the
    port), and ``memory`` (bytes: ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``total_bytes`` the peak of the live bytes)."""
    flops: float = 0.0
    bytes: float = 0.0
    by_op: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)

    def breakdown(self, top: int = 25) -> dict:
        """The ``top`` ops by flops and by bytes: ``(total, calls, op)``
        rows, largest first (the reference's ``hlo_cost.breakdown``)."""
        def rows(attr):
            r = [(getattr(c, attr), c.calls, n)
                 for n, c in self.by_op.items() if getattr(c, attr)]
            return sorted(r, reverse=True)[:top]
        return {"flops": rows("flops"), "bytes": rows("bytes")}


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


class OpCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten op run under it, the port's
    kernels through ``_build.record_cost``, and the live storages.
    ``args`` are the step's arguments, which are live throughout."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.totals = CostTotals()
        self._lock = threading.Lock()
        self._args = {}
        for t in _tensors(args):
            key, n = _storage(t)
            self._args[key] = n
        self._refs: dict = {}         # storage -> [bytes, live tensors]
        self._tracked: set = set()    # ids of tensors with a finalizer
        self._live = sum(self._args.values())
        self._peak = self._live

    def __enter__(self):
        _build.set_cost_sink(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.set_cost_sink(None)
        return super().__exit__(*exc)

    def _charge(self, name: str, flops: float, nbytes: float) -> None:
        with self._lock:
            c = self.totals.by_op.setdefault(name, OpCost())
            c.calls += 1
            c.flops += flops
            c.bytes += nbytes
            self.totals.flops += flops
            self.totals.bytes += nbytes

    def _kernel(self, name: str, cost: Callable) -> None:
        with _disable_current_modes():
            flops, nbytes = cost()
        self._charge("kernel:" + name, flops, nbytes)

    def _track(self, t: torch.Tensor) -> None:
        # a host scalar (a Python number wrapped for an op) holds no
        # device memory
        if id(t) in self._tracked or t.device.type == "cpu" and t.dim() == 0:
            return
        key, n = _storage(t)
        if key in self._args:
            return
        with self._lock:
            ref = self._refs.get(key)
            if ref is None:
                ref = self._refs[key] = [n, 0]
                self._live += n
                self._peak = max(self._peak, self._live)
            ref[1] += 1
            self._tracked.add(id(t))
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key, tid) -> None:
        with self._lock:
            self._tracked.discard(tid)
            ref = self._refs[key]
            ref[1] -= 1
            if ref[1] == 0:
                self._live -= ref[0]
                del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        for t in _tensors(out):
            self._track(t)
        if func.is_view or name in _FREE:
            return out
        flops = _matmul_flops(name, args)
        if name == "convolution":
            flops = _conv_flops(args, out)
        elif name == "convolution_backward":
            flops = 2 * _conv_flops(args[1:], args[0])
        self._charge(name, flops, _op_bytes(name, args, kwargs, out))
        return out

    def finish(self, out) -> CostTotals:
        """Close the memory account with the step's output ``out``."""
        args = sum(self._args.values())
        outs = {}
        for t in _tensors(out):
            key, n = _storage(t)
            if key not in self._args:
                outs[key] = n
        with self._lock:
            peak = max(self._peak, self._live)
        output = sum(outs.values())
        self.totals.memory = {
            "argument_bytes": args, "output_bytes": output,
            "temp_bytes": max(peak - args - output, 0), "total_bytes": peak}
        return self.totals


def tensor_bytes(tree) -> int:
    """Bytes of the distinct tensors of nested lists, tuples (NamedTuples
    too) and dictionaries."""
    return sum(_nbytes(t) for t in _tensors(tree))


def analyze(fn: Callable, *args, **kwargs) -> CostTotals:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter` and return
    what it counted."""
    counter = OpCounter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return counter.finish(out)


def roofline_terms(flops: float, nbytes: float) -> dict:
    """The one-card roofline terms in seconds against the data sheet's
    peaks (no collective term: one card)."""
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW}
    terms["dominant"] = max(terms, key=terms.get)
    terms["step_s_lower_bound"] = max(terms["compute_s"], terms["memory_s"])
    return terms
