"""``BENCHMARK.json`` and the files it names, found by name.

A workload ``<config>.<traffic>`` resolves to

  * ``perfbench/configs/<config>.json`` (the configuration's sizes, the
    program's adapter under ``"system"`` and the reference under
    ``"reference"``),
  * ``perfbench/traffic/<traffic>.json`` (the mix's parameters, its
    generator under ``"kind"``),
  * ``perfbench/systems/<system>.py``, ``perfbench/references/<ref>.py``,
    ``perfbench/kinds/<kind>.py``,
  * ``perfbench/metrics/<metric>.py`` for each per-layer metric whose
    ``workloads`` list the cell.

Adding a configuration, a mix or a metric adds files and entries and edits
none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    system: object          # module: build(config, device) -> index
    reference: object       # module of the plain reference
    kind: object            # module: the traffic's generator and window
    end_to_end: list        # metric entries this cell reports
    per_layer: list         # (entry, reader module) this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(pkg: Path, sub: str, name: str):
    """``perfbench/<sub>/<name>.py``, imported by its path (names may hold
    dots, as ``device_idle_pct.lookup`` does)."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad {sub} name {name!r}")
    path = pkg / sub / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{sub} {name!r}: no file {path}")
    modname = f"perfbench_{sub}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(spec: dict, name: str, pkg: Path = PKG) -> Cell:
    """The ``Cell`` of workload ``name``; raises if anything is missing."""
    wl = [w for w in spec["workloads"] if w["name"] == name]
    if len(wl) != 1:
        raise KeyError(f"workload {name!r}: {len(wl)} entries in "
                       "BENCHMARK.json")
    w = wl[0]
    cfgs = [c for c in spec["configs"] if c["name"] == w["config"]]
    if len(cfgs) != 1:
        raise KeyError(f"config {w['config']!r}: {len(cfgs)} entries")
    config = load_json(pkg.parent / cfgs[0]["file"])
    traffic = load_json(pkg / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [(m, _module(pkg, "metrics", m["name"]))
                 for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                system=_module(pkg, "systems", config["system"]),
                reference=_module(pkg, "references", config["reference"]),
                kind=_module(pkg, "kinds", traffic["kind"]),
                end_to_end=e2e, per_layer=per_layer)
