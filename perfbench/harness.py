"""Runs one cell once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Order of a run: the traffic's data and the harness's own buffers
(``prepare``), their bytes read; the index built, loaded and warmed
(``start``), a read cell's resident bytes read once caught up: set-up
ends; the window; the peak device memory read; the per-layer readers
(``--trace 1``); the check against the plain reference, after the
program's state is freed, each number held to its limit (the traffic
kind's ``LIMITS``, or the configuration's ``limits`` where it states
one; a check that compares nothing is not correct); the look for JAX in
``sys.modules``.
The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error too.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from perfbench import spec as specmod
from perfbench.device import Cuda, NoCard

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Env:
    """What a traffic generator gets from the harness."""
    torch: object
    device: object              # torch.device the data and index live on
    dev: object                 # device.Cuda or a stand-in
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    system: object
    reference: object
    clock: object = time.perf_counter

    def build_index(self):
        return self.system.build(self.config, self.device)

    def span(self, name: str):
        return self.torch.profiler.record_function(name)

    def tracer(self):
        from perfbench.trace_read import Tracer
        return Tracer(self.torch, device_activity=self.device.type == "cuda")


@dataclass
class ReadCtx:
    """What a per-layer reader gets: the traced stretch, the counters of
    the window, the probes of each traced lookup request, the run's device
    bytes (``peak``, ``harness``: the harness's own buffers, and
    ``records`` where the configuration has records), and the cell's
    configuration and traffic."""
    trace: object
    counters: dict
    traced_probes: list
    memory: dict
    config: dict = None
    traffic: dict = None


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, args, *, dev, device, t_start: float,
             system=None) -> tuple:
    """(the result line's dict, the number of answers compared)."""
    import torch
    env = Env(torch=torch, device=device, dev=dev, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace),
              config=cell.config, traffic=cell.traffic,
              system=system or cell.system, reference=cell.reference)
    kind = cell.kind
    st = kind.prepare(env)
    dev.synchronize()
    peak_before = dev.max_memory_allocated()
    harness_bytes = dev.memory_allocated()
    dev.reset_peak()
    kind.start(env, st)
    dev.synchronize()
    setup_s = env.clock() - t_start
    w = kind.window(env, st)
    dev.synchronize()
    peak = dev.max_memory_allocated()
    device_info = {"platform": dev.platform, "kind": dev.name(),
                   "count": dev.count,
                   "memory_peak_bytes": max(peak, peak_before),
                   "power_limit": dev.power_limit()}
    metrics, breakdown = {}, None
    if args.trace:
        memory = {"peak": peak, "harness": harness_bytes}
        if "records" in cell.config:
            memory["records"] = cell.config["records"]
        ctx = ReadCtx(trace=w.trace, counters=w.counters,
                      traced_probes=w.traced_probes, memory=memory,
                      config=cell.config, traffic=cell.traffic)
        for m, reader in cell.per_layer:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if w.trace is not None:
            device_info["busy_s"] = w.trace.busy_s()
            device_info["window_s"] = w.trace.window_s
            breakdown = {"device_ops": w.trace.top_device_ops(),
                         "idle_gaps": w.trace.top_gaps()}
    else:
        values = dict(w.end_to_end, setup_s=setup_s)
        if "resident_bytes" in st:
            values["bytes_per_record"] = ((st["resident_bytes"]
                                           - harness_bytes)
                                          / cell.config["records"])
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"{cell.name} lists {m['name']}, which "
                               f"traffic kind {cell.traffic['kind']!r} "
                               "does not measure")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    t_check = env.clock()
    numbers, compared = kind.check(env, st)
    log(f"check: {env.clock() - t_check:.1f} s")
    limits = {**kind.LIMITS, **cell.config.get("limits", {})}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
    # a check that compared nothing proves nothing
    correct = w.failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, compared


def main(argv, *, root: Path, t_start: float, dev=None, device=None,
         system=None) -> int:
    """Exit codes: 0 a result printed; 2 a bad argument or benchmark file;
    3 no card; 4 JAX or the JAX package loaded; 1 anything else."""
    args = parse_args(argv)
    try:
        cell = specmod.resolve(specmod.load_spec(root), args.workload,
                               root / "perfbench")
    except (OSError, KeyError, ValueError, ImportError) as e:
        log(f"perfbench: {e!r}")
        return 2
    import torch
    if dev is None:
        try:
            dev = Cuda(torch, int(cell.workload["chips"]))
        except NoCard as e:
            log(f"perfbench: no card: {e}")
            return 3
        device = dev.device
    try:
        result, compared = run_cell(cell, args, dev=dev, device=device,
                                    t_start=t_start, system=system)
    except Exception:
        log(traceback.format_exc())
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"perfbench: loaded after the window: {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)
    log(f"compared {compared} answers with the plain reference")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return 0
