"""``BENCHMARK.json`` against the benchmark's contract, and the harness
driven by data: every workload resolves to its files, a new configuration,
traffic mix and metric are taken with no existing file edited, and the
result line holds only the keys the contract names."""
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness, spec
from perfbench.tests import stand_in

REPO = stand_in.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = spec.NAME_RE
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert (REPO / p).is_dir() and ".." not in p and not p.startswith("/")
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and all(_line(c) for c in cmd)
    assert cmd[1].startswith(BENCH["paths"][0] + "/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    cfgs = BENCH["configs"]
    assert 1 <= len(cfgs) <= 24
    names = [c["name"] for c in cfgs]
    assert len(set(names)) == len(names)
    files = [c["file"] for c in cfgs]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    wls = BENCH["workloads"]
    assert 1 <= len(wls) <= 24
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in wls]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in wls)
    assert four <= max(1, len(wls) // 4)
    for w in wls:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e, pl = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names)
    by = {m["name"]: m for m in e2e}
    assert by["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        by["setup_s"]
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in pl:
        # the harness reads a per-layer metric in the cells it lists only
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in by
        assert _line(m["layer"])
        layers.add(m["layer"])
        for c in m["workloads"]:
            mv = by[m["moves"]]
            assert c in CELLS and c in mv.get("workloads", CELLS)
    for m in e2e + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for c in m.get("workloads", []):
            assert c in CELLS
    # every cell: setup_s, another end-to-end metric, a per-layer metric
    for c in CELLS:
        mine = [m["name"] for m in e2e if c in m.get("workloads", CELLS)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(c in m["workloads"] for m in pl)


SERVE_CELLS = ["qwen2_moe_a2_7b.azure_code", "hymba_1_5b.azure_code"]


@pytest.mark.parametrize("name, unit, better, source, moves, cells", [
    ("serve_tokens_per_s", "tokens/s", "higher", "host_clock", None,
     SERVE_CELLS[1:]),
    ("decode_step_p95_ms", "ms", "lower", "device_trace", None,
     SERVE_CELLS[1:]),
    ("ttft_ms_per_1k_prompt_tokens", "ms/ktok", "lower", "device_trace",
     None, SERVE_CELLS),
    ("decode_host_ms", "ms", "lower", "program_span", "decode_step_p95_ms",
     SERVE_CELLS[1:]),
    ("decode_host_ms.unbounded", "ms", "lower", "program_span",
     "ttft_ms_per_1k_prompt_tokens", SERVE_CELLS[:1]),
    ("serve_tokens_per_s.unbounded", "tokens/s", "higher", "device_trace",
     "ttft_ms_per_1k_prompt_tokens", SERVE_CELLS[:1]),
    ("decode_step_p95_ms.unbounded", "ms", "lower", "device_trace",
     "ttft_ms_per_1k_prompt_tokens", SERVE_CELLS[:1]),
    ("device_idle_pct.decode", "%", "lower", "device_trace",
     "serve_tokens_per_s", SERVE_CELLS[1:]),
    ("moe_device_pct.decode", "%", "lower", "device_trace",
     "ttft_ms_per_1k_prompt_tokens", SERVE_CELLS[:1]),
    ("ssm_device_pct.decode", "%", "lower", "device_trace",
     "decode_step_p95_ms", SERVE_CELLS[1:]),
    ("decode_attn_roofline_pct", "%", "higher", "device_trace",
     "decode_step_p95_ms", SERVE_CELLS[1:]),
    ("flash_roofline_pct", "%", "higher", "device_trace",
     "ttft_ms_per_1k_prompt_tokens", SERVE_CELLS),
    ("step_mfu.decode", "%", "higher", "device_trace", "decode_step_p95_ms",
     SERVE_CELLS[1:]),
    ("step_mfu.prefill", "%", "higher", "device_trace",
     "ttft_ms_per_1k_prompt_tokens", SERVE_CELLS)])
def test_serving_metrics(name, unit, better, source, moves, cells):
    """The serving cells' metrics: each end-to-end one bounded within the
    contract's range and listed for the serving cells alone, each
    per-layer one moving a serving metric in the cells that read it.  The
    decode's rate and tail are end to end where they are steady (hymba),
    and per layer (``*.unbounded``) in qwen2_moe, whose host-bound decode
    spreads past the contract's largest bound between runs."""
    m = {x["name"]: x for x in BENCH["end_to_end"] + BENCH["per_layer"]}[name]
    assert (m["unit"], m["better"], m["source"]) == (unit, better, source)
    assert m["workloads"] == cells
    if moves is None:
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] == moves


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_every_served_cell_compares_the_mean_gap(cell):
    """Whatever a served model's configuration says, its check compares the
    mean gap of the served tokens (the kind's ``COMPARED``), and the
    configuration gives each compared number a limit."""
    c = spec.resolve(BENCH, cell, REPO / "perfbench")
    assert "token_gap_mean_sd" in c.kind.COMPARED
    assert set(c.kind.COMPARED) <= set(c.config["limits"])
    assert all(0 < v for v in c.config["limits"].values())
    assert isinstance(c.config["batch"], int) and c.config["batch"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_every_workload_resolves_to_its_files(cell):
    c = spec.resolve(BENCH, cell, REPO / "perfbench")
    w = c.workload
    assert (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
    # an index cell's reference is a map, a served model's its logits
    assert hasattr(c.system, "build") and hasattr(
        c.reference, "logits" if c.traffic["kind"] == "serve" else "KVMap")
    for fn in ("prepare", "start", "window", "check"):
        assert hasattr(c.kind, fn)
    assert {m["name"] for m, _ in c.per_layer} == {
        m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    for m, reader in c.per_layer:
        assert callable(reader.read)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return stand_in.tiny_copy(tmp_path_factory.mktemp("tiny"))


def _check_line(res: dict, cell: str, trace: int) -> None:
    keys = list(res)
    assert keys[:5] == RESULT_KEYS
    rest = keys[5:]
    assert rest == (["breakdown", "checks"] if trace and "breakdown" in res
                    else ["checks"])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    mine = [m for m in (BENCH["per_layer"] if trace else BENCH["end_to_end"])
            if cell in m.get("workloads", CELLS)]
    units = {m["name"]: m["unit"] for m in mine}
    assert set(res["metrics"]) <= set(units)
    if not trace:
        assert set(res["metrics"]) == set(units)
    for k, v in res["metrics"].items():
        assert set(v) == {"value", "unit"} and v["unit"] == units[k]
        assert math.isfinite(v["value"])
    d = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    if trace:
        assert {"busy_s", "window_s"} <= set(d)
        for lst in res["breakdown"].values():
            assert len(lst) <= 10
    for k, c in res["checks"].items():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_holds_only_the_contract_keys(tiny, cell, trace):
    rc, res = stand_in.run(tiny, cell, seed=2**33 + 1, seconds=0.3,
                           trace=trace)
    assert rc == 0
    _check_line(res, cell, trace)


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_taken_by_name(tiny, tmp_path):
    root = tmp_path
    shutil.copy(tiny / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(tiny / "perfbench", root / "perfbench")
    before = _digests(root / "perfbench")
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "fig7_100m.json").read_text())
    cfg.update(name="fig7_small", bucket_slots=32, capacity=256)
    (pb / "configs" / "fig7_small.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "read_uniform.json").read_text())
    mix.update(request_keys=64, pool_requests=2)
    (pb / "traffic" / "read_tiny.json").write_text(json.dumps(mix))
    (pb / "metrics" / "requests_per_s.x.py").write_text(
        "def read(ctx):\n    return len(ctx.traced_probes) / "
        "ctx.trace.window_s\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "fig7_small", "source": cfg["source"],
                         "file": "perfbench/configs/fig7_small.json",
                         "reduced": [], "why": "a test's"})
    b["workloads"].append({"name": "fig7_small.read_tiny",
                           "config": "fig7_small", "traffic": "read_tiny",
                           "chips": 1, "why": "a test's"})
    for m in b["end_to_end"]:
        if m["name"].startswith("lookup_"):
            m["workloads"].append("fig7_small.read_tiny")
    b["per_layer"].append({"name": "requests_per_s.x", "unit": "1/s",
                           "better": "higher", "source": "program_span",
                           "layer": "index API", "moves": "lookup_rate",
                           "workloads": ["fig7_small.read_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.resolve(b, "fig7_small.read_tiny", pb)
    assert cell.config["bucket_slots"] == 32
    assert cell.traffic["request_keys"] == 64
    rc, res = stand_in.run(root, "fig7_small.read_tiny", trace=1,
                           seconds=0.3)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["requests_per_s.x"]["value"] > 0
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the refusal without one")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1"], root=REPO, t_start=0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_bare_directory_fails_without_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's paths (no
    program) exits non-zero and prints nothing on standard output."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
