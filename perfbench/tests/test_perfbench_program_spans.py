"""The reader of the program's own spans on a made-up trace:
``lookup_gate_ms`` sums the ``eh.gate`` spans inside each lookup call and
takes the median over the calls, and reads nothing where the program has
no such span."""
import importlib.util

import pytest

from perfbench import trace_read
from perfbench.harness import ReadCtx
from perfbench.tests import stand_in


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, stand_in.REPO / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(host):
    return ReadCtx(trace=trace_read.TraceView(0.0, 1000.0, host=host),
                   counters={}, traced_probes=[], memory={})


def test_lookup_gate_ms_on_a_made_up_trace():
    read = _reader("lookup_gate_ms").read
    call, span = "bench.lookup_call", "user_annotation"
    host = [(call, span, 0, 100), ("eh.lookup", span, 1, 99),
            ("eh.gate", span, 10, 30), ("eh.gate", span, 40, 45),
            ("aten::item", "cpu_op", 11, 29),
            (call, span, 200, 300), ("eh.gate", span, 210, 250),
            (call, span, 400, 500), ("eh.gate", span, 410, 420),
            ("eh.gate", span, 600, 700)]          # outside every call
    # per call 25, 40 and 10 us: the median 25 us
    assert read(_ctx(host)) == pytest.approx(0.025)
    # the parent's program opens no gate span: nothing to read
    assert read(_ctx([h for h in host if h[0] != "eh.gate"])) is None
