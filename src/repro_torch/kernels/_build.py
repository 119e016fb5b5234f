"""Builds the CUDA sources under ``csrc/`` at first use and counts launches.

Plain ``nvcc`` plus ``ctypes``: each source exports ``extern "C"`` launchers
that take raw device pointers, sizes and the ``cudaStream_t`` of PyTorch's
current stream, and return ``cudaGetLastError()``; :func:`check` raises on
anything but 0.  Libraries go to ``build/repro_torch/`` at the root of the
checkout, named with a hash of every file in ``csrc/`` and of the flags, so
an edited source rebuilds.  The attention wrappers also hand each call's
flops and bytes to the active cost counter (:func:`record_cost`).
Nothing here runs at import, and nothing falls back: a kernel that does
not build or launch raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("eh_lookup", "ragged_copy", "eh_insert", "decode_attention",
           "flash_attention", "baselines_insert", "baselines_lookup")
# compute_90a, not plain -arch=sm_90a (whose PTX targets compute_90):
# wgmma exists only for the "a" target.  --split-compile=0 optimizes a
# source's kernels in parallel on every core (decode_attention.cu holds 40
# instantiations)
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_lock = threading.Lock()
_libs: dict = {}
_count_lock = threading.Lock()
#: kernel name -> ``__global__`` launches since the last :func:`reset_launches`
LAUNCHES: collections.Counter = collections.Counter()
#: the active cost counter (``launch/op_cost.OpCounter``), or None
_cost_sink = None


def count_launch(name: str, kernels: int = 1) -> None:
    """Count a wrapper call that launched ``kernels`` ``__global__``
    kernels on the card."""
    with _count_lock:
        LAUNCHES[name] += kernels


def set_cost_sink(sink) -> None:
    """Make ``sink(name, cost)`` the active cost counter, which
    :func:`record_cost` calls for every kernel call until it is set to
    None (``launch/op_cost``'s counter).  One counter at a time: setting a
    second while one is active raises ``RuntimeError``."""
    global _cost_sink
    with _count_lock:
        if sink is not None and _cost_sink is not None:
            raise RuntimeError("a cost counter is already active")
        _cost_sink = sink


def record_cost(name: str, cost, *args) -> None:
    """Hand a kernel call to the active cost counter, if there is one:
    ``cost(*args)`` returns its (flops, bytes) and is called only then."""
    sink = _cost_sink
    if sink is not None:
        sink(name, functools.partial(cost, *args))


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()


def launches() -> dict:
    with _count_lock:
        return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names=SOURCES) -> dict:
    """Compile those of ``names`` that are not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: (seconds, nvcc
    output)}`` for the sources it compiled; raises if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        report[name] = (time.perf_counter() - t0, log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` (``{function: [ctypes types]}``;
    every launcher returns a C ``int``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on, each contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{kernel}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
    return dev
