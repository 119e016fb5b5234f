"""Fault-tolerant checkpointing: atomic, asynchronous (twin of
``repro/checkpoint/checkpointer.py``, with its manifest and files).

  * **Atomicity** -- writes go to ``step_<N>.tmp/`` and are ``os.rename``d
    to ``step_<N>/`` only after every array file and the manifest are
    fsynced.  A crash mid-write leaves a ``.tmp`` directory that restore
    ignores and the next save garbage-collects.
  * **Asynchrony** -- ``save_async`` copies the tensors to host memory (the
    only synchronous part) and hands the file I/O to a writer thread, so the
    train loop overlaps checkpoint I/O with the next step.
  * **Retention** -- the ``keep`` newest steps are kept, the rest removed.

Each tensor is saved whole as a ``.npy`` file with its path, shape and dtype
in ``MANIFEST.json``.  numpy has no bfloat16: a bfloat16 tensor is saved as
its uint16 bit pattern, with ``"bfloat16"`` as its manifest dtype, and
restores bit for bit.  ``restore(step, like)`` places each tensor on the
device and in the dtype of its counterpart in ``like``.  The reference's
``shardings`` argument (re-sharding onto another mesh) has no meaning on
one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """Flatten nested dict/NamedTuple/list trees to {path: leaf}."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): tree}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _to_host(t) -> tuple:
    """(numpy array, manifest dtype) of a tensor (or array or number)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        t = t.numpy()
    arr = np.asarray(t)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "MANIFEST.json"))]
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any) -> str:
        """Synchronous atomic save.  Returns the final directory."""
        return self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Any) -> None:
        """Device->host snapshot now; file I/O on the writer thread."""
        self.wait()  # one outstanding save (bounds host memory)
        host = self._snapshot(tree)

        def run():
            try:
                self._write(step, host)
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._writer = threading.Thread(target=run, daemon=True,
                                        name=f"ckpt-{step}")
        self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _snapshot(tree) -> dict:
        return {k: _to_host(v) for k, v in _flatten(tree).items()}

    def _write(self, step: int, host: dict) -> str:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "arrays": {}}
        for i, (path, (arr, dtype)) in enumerate(sorted(host.items())):
            fname = f"arr_{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["arrays"][path] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        mpath = os.path.join(tmp, "MANIFEST.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic commit point
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(
            (int(d.split("_")[1]) for d in os.listdir(self.directory)
             if d.startswith("step_") and not d.endswith(".tmp")),
            reverse=True)
        for s in steps[self.keep:]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
        for d in os.listdir(self.directory):  # crashed writes
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors), each
        tensor new, on its counterpart's device and in its dtype."""
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        loaded = {}
        for path, ref in _flatten(like).items():
            meta = manifest["arrays"].get(path)
            if meta is None:
                raise KeyError(f"checkpoint missing array: {path}")
            arr = np.load(os.path.join(d, meta["file"]))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"{path}: checkpoint shape {arr.shape} != "
                    f"{tuple(ref.shape)}")
            loaded[path] = _from_host(arr, meta["dtype"]).to(
                device=ref.device, dtype=ref.dtype)
        return _unflatten_like(like, loaded)


def _unflatten_like(like: Any, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if hasattr(like, "_asdict"):
        vals = {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like._asdict().items()}
        return type(like)(**vals)
    if isinstance(like, (list, tuple)):
        return type(like)(
            _unflatten_like(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(like))
    return flat[prefix.rstrip("/")]
