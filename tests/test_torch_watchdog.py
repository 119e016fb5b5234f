"""The port's fault-tolerance runtime (``repro_torch.runtime.watchdog``, a
copy of the reference's): the twins of tests/test_watchdog.py."""
import time

import pytest

from repro_torch.runtime.watchdog import (Heartbeat, StragglerMonitor,
                                          Watchdog, run_restartable)


def test_watchdog_fires_on_stale_heartbeat():
    hb = [Heartbeat(0), Heartbeat(1)]
    dead: list = []
    with Watchdog(hb, deadline_s=0.15, on_dead=dead.extend, poll_s=0.02):
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.5:
            hb[0].beat(1)          # worker 0 stays alive
            time.sleep(0.02)
    assert dead == [1]


def test_watchdog_quiet_when_all_beat():
    hb = [Heartbeat(0)]
    dead: list = []
    with Watchdog(hb, deadline_s=0.2, on_dead=dead.extend, poll_s=0.02):
        for _ in range(10):
            hb[0].beat(1)
            time.sleep(0.02)
    assert dead == []
    assert hb[0].step == 1


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0)
    for _ in range(10):
        assert not mon.record(0.1)
    assert mon.record(1.0)          # 10x the median
    assert mon.flagged == 1
    assert mon.median() == pytest.approx(0.1)


def test_run_restartable_recovers():
    state = {"restores": 0, "attempts": 0}

    def restore():
        state["restores"] += 1
        return state["restores"] * 10   # checkpointed step advances

    def body(start):
        state["attempts"] += 1
        if state["attempts"] < 3:
            raise RuntimeError("simulated node failure")
        return start + 5

    final = run_restartable(body, restore=restore, max_restarts=3)
    assert final == 35                  # third restore -> start 30 -> +5
    assert state["restores"] == 3


def test_run_restartable_exhausts():
    def body(start):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        run_restartable(body, restore=lambda: 0, max_restarts=2)
