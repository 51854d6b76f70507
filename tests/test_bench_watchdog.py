"""bench.py's SIGALRM watchdog (with_alarm) — the guard that makes the
JSON artifact print even when a leg hangs. Pure-host, no devices."""
import signal
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import LegTimeout, with_alarm  # noqa: E402


def test_fires_on_hang():
    t0 = time.monotonic()
    try:
        with_alarm(lambda: time.sleep(10), 1)
    except LegTimeout:
        pass
    else:
        raise AssertionError("watchdog did not fire")
    assert time.monotonic() - t0 < 5
    assert signal.alarm(0) == 0, "alarm leaked past with_alarm"


def test_returns_value_and_disarms():
    assert with_alarm(lambda: 42, 30) == 42
    assert signal.alarm(0) == 0, "alarm leaked past a completed phase"


def test_propagates_inner_errors():
    def boom():
        raise ValueError("leg error")

    try:
        with_alarm(boom, 30)
    except ValueError:
        pass
    else:
        raise AssertionError("inner exception swallowed")
    assert signal.alarm(0) == 0


def test_nested_inner_completes_outer_still_fires():
    def outer():
        assert with_alarm(lambda: 7, 2) == 7  # inner done well in time
        time.sleep(10)  # outer budget (re-armed remainder) must fire

    t0 = time.monotonic()
    try:
        with_alarm(outer, 3)
    except LegTimeout:
        pass
    else:
        raise AssertionError("outer watchdog lost its arm to the inner")
    assert time.monotonic() - t0 < 8
    assert signal.alarm(0) == 0


def test_zero_budget_disables():
    assert with_alarm(lambda: "ok", 0) == "ok"
