"""The harness's only contact with the card: name, count, clocks, memory.

``Cuda`` refuses to exist without a card: a run that finds none fails and
prints no result.  Tests drive the rest of a run through a stand-in with
the same methods.
"""
from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    pass


class Cuda:
    platform = "gpu"

    def __init__(self, torch, chips: int):
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell asks "
                         f"for {chips}")
        self.torch = torch
        self.count = chips
        self.device = torch.device("cuda", 0)
        torch.cuda.set_device(self.device)

    def name(self) -> str:
        return self.torch.cuda.get_device_name(0)

    def synchronize(self) -> None:
        self.torch.cuda.synchronize()

    def memory_allocated(self) -> int:
        return self.torch.cuda.memory_allocated(0)

    def max_memory_allocated(self) -> int:
        return self.torch.cuda.max_memory_allocated(0)

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats(0)

    def event(self):
        """An event whose ``elapsed_time`` to another is device time, ms."""
        return self.torch.cuda.Event(enable_timing=True)

    def power_limit(self) -> str:
        """``nvidia-smi``'s name and power limit of the card, or why not."""
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"nvidia-smi: {e}"
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()[:200]}"
