"""The control of the check: the plain reference put in the program's place
with one of the configuration's guarantees broken, run through the rest of
a benchmark run, whose ``correct`` has to come out false.

The guarantee broken is read-your-writes: the stand-in answers from a map
that never takes in the newest insert batch, as a shortcut view served
without its version gate would after a replay was dropped.  Everything
else is the reference's own exact answer.  The benchmark's runs never use
this; it runs as

    python3 perfbench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

which prints one result line per seed (the numbers compared under
``checks``) and exits 0 only if every seed's ``correct`` is false.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [os.path.join(ROOT, "src"), ROOT]


class StaleMap:
    """Answers from every insert batch but the newest."""

    def __init__(self, reference):
        self.reference = reference
        self.batches = []
        self.map = None

    def insert(self, keys, values) -> None:
        self.batches.append((keys, values))
        self.map = None

    def lookup(self, keys):
        import torch
        if self.map is None:
            old = self.batches[:-1]
            empty = keys[:0]
            self.map = self.reference.KVMap(
                torch.cat([k for k, _ in old]) if old else empty,
                torch.cat([v for _, v in old]) if old else empty)
        return self.map.lookup(keys).view(torch.uint32)

    def wait_in_sync(self, timeout: float) -> bool:
        return True

    def counters(self) -> dict:
        return {"routed_shortcut": 0, "routed_traditional": 0,
                "slots_remapped": 0}

    def route_traditional(self) -> None:
        pass

    def close(self) -> None:
        self.batches, self.map = [], None


class StaleSystem:
    """A ``systems/<name>.py`` stand-in: ``build`` makes a ``StaleMap``."""

    def __init__(self, reference):
        self.reference = reference

    def build(self, config: dict, device) -> StaleMap:
        return StaleMap(self.reference)


def main(argv) -> int:
    import argparse
    import io
    import contextlib
    import json
    from pathlib import Path

    from perfbench import harness, spec
    p = argparse.ArgumentParser(description="run the check's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", default="5")
    p.add_argument("--seeds", nargs="+", required=True)
    args = p.parse_args(argv)
    root = Path(ROOT)
    cell = spec.resolve(spec.load_spec(root), args.workload,
                        root / "perfbench")
    failed_all = True
    for seed in args.seeds:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = harness.main(
                ["--workload", args.workload, "--seed", seed, "--seconds",
                 args.seconds, "--trace", "0"], root=root,
                t_start=time.perf_counter(),
                system=StaleSystem(cell.reference))
        lines = out.getvalue().strip().splitlines()
        res = json.loads(lines[-1]) if rc == 0 and lines else None
        print(json.dumps({"workload": args.workload, "seed": seed, "rc": rc,
                          "correct": None if res is None else res["correct"],
                          "checks": None if res is None else res["checks"]}),
              flush=True)
        failed_all &= res is None or not res["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
