"""Shortcut-EH in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``: the same index, view and
maintenance runtime, held bit for bit against it by the tests.  It imports
``torch``, numpy and the standard library only.  Every constructor takes
``device=`` (default ``"cuda"``); kernels dispatch on the device of their
tensors (a CUDA tensor launches the hand-written kernel, a CPU tensor runs
the plain PyTorch version in ``kernels/ref.py``).
"""
from repro_torch.device import resolve_device  # noqa: F401
