"""A CPU stand-in for the harness's card (``perfbench/device.py``), and a
temporary copy of the benchmark at a size a test run holds.

The harness refuses to run without a card; the tests skip that look and
drive the rest of a run on the CPU, with the program's plain versions
(``device="cpu"``) and this stand-in's host-clock events.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: a configuration of each system at test size (the bucket geometry cut)
TINY_CONFIGS = {
    "shortcut_eh": dict(records=3000, bucket_slots=16, capacity=1024,
                        max_global_depth=12, num_shards=1),
    "sharded_shortcut_eh": dict(records=3000, bucket_slots=16, capacity=512,
                                max_global_depth=12, num_shards=4),
}
#: a served model at test size: the program's own ``reduced()`` widths of
#: the configuration's model at ``TINY_DEPTH`` layers (the first and the
#: last global where the model has global layers), ``TINY_WIDTH`` and
#: ``TINY_VOCAB`` (at 2 layers, width 64 and 256 ids the best logit stands so
#: far above the next that a float8 reference moves it on few seeds), and,
#: with experts, a capacity factor under which the prompt drops pairs.
#: ``TINY_LIMITS`` holds its check, set from its own readings (PERF.md §2)
TINY_DEPTH, TINY_WIDTH, TINY_VOCAB = 4, 128, 8192
TINY_CAPACITY_FACTOR = 1.0
TINY_LIMITS = {"token_gap_sd": 0.001, "token_gap_mean_sd": 0.00001}
TINY_TRAFFIC = {
    "read": dict(load_batches=4, request_keys=256, pool_requests=3,
                 retain_requests=2, catch_up_timeout_s=30,
                 trace_seconds=0.2),
    "ingest": dict(episode_batches=4, absent_check_keys=256,
                   catch_up_timeout_s=30),
    "serve": dict(prompt_tokens={"median": 48, "sigma": 0.3},
                  output_tokens={"median": 16, "sigma": 0.4}, classes=4,
                  prompt_round=16, prompt_offset=1, output_offset=3,
                  dtype="float32", judged_sequences=8, trace_requests=1),
}
#: sequences a served model's request holds at test size
TINY_BATCH = 4


def tiny_model(config: dict) -> dict:
    """``config["model"]`` at the test size above."""
    import dataclasses

    from perfbench.systems import serve
    cfg = serve.arch(config).reduced()
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    m.update(num_layers=TINY_DEPTH, d_model=TINY_WIDTH, vocab_size=TINY_VOCAB,
             global_layers=[0, TINY_DEPTH - 1] if m["global_layers"] else [])
    if m["num_experts"]:
        m["capacity_factor"] = TINY_CAPACITY_FACTOR
    return m


class HostEvent:
    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class CpuStandIn:
    platform = "cpu-stand-in"
    count = 1

    def name(self) -> str:
        return "cpu"

    def synchronize(self) -> None:
        pass

    def memory_allocated(self) -> int:
        return 0

    def max_memory_allocated(self) -> int:
        return 0

    def reset_peak(self) -> None:
        pass

    def event(self):
        return HostEvent()

    def power_limit(self) -> str:
        return "none (CPU)"


def tiny_copy(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``perfbench/`` copied to ``dst``, each
    configuration and traffic file cut to test size.  Returns ``dst``."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dst / "perfbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        if c["system"] == "serve":
            c.update(model=tiny_model(c), limits=TINY_LIMITS,
                     batch=TINY_BATCH)
        else:
            c.update(TINY_CONFIGS[c["system"]], poll_interval=0.002)
        f.write_text(json.dumps(c))
    for f in (dst / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(TINY_TRAFFIC[t["kind"]])
        f.write_text(json.dumps(t))
    return dst


def run(root: Path, workload: str, *, seed: int = 7, seconds: float = 0.5,
        trace: int = 0, system=None):
    """``harness.main`` on the CPU; (exit code, result dict or None).

    The look for JAX in ``sys.modules`` is left out: other tests load JAX
    into the same process (``test_perfbench_imports.py`` holds the
    benchmark to it in a fresh interpreter)."""
    import contextlib
    import io
    from unittest import mock

    import torch

    from perfbench import harness
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            mock.patch.object(harness, "forbidden_modules", lambda: []):
        rc = harness.main(
            ["--workload", workload, "--seed", str(seed), "--seconds",
             str(seconds), "--trace", str(trace)],
            root=root, t_start=time.perf_counter(), dev=CpuStandIn(),
            device=torch.device("cpu"), system=system)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)
