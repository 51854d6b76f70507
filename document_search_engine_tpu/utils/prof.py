"""Tracing/profiling + structured metrics (SURVEY.md §5).

- `phase(name)`: wall-clock phase timer accumulating into a global registry
  (emit with `metrics_json()` — the per-run structured JSON record).
- `trace(path)`: jax.profiler trace context (Perfetto-compatible) when the
  profiler is available; no-op otherwise.
- `sync(x)`: force completion of the device work feeding `x` before a
  timer reads the clock (JAX returns before the device finishes).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import numpy as np

_PHASES: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)


def sync(x) -> None:
    """Force completion of device work feeding `x` (D2H of one element)."""
    try:
        leaf = x[0] if isinstance(x, (tuple, list)) else x
        np.asarray(leaf).ravel()[:1]
    except Exception:
        pass


@contextlib.contextmanager
def phase(name: str, sync_on=None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_on is not None:
            sync(sync_on)
        _PHASES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def metrics_json(**extra) -> str:
    rec = {
        "phases_s": {k: round(v, 4) for k, v in _PHASES.items()},
        "counts": dict(_COUNTS),
    }
    rec.update(extra)
    return json.dumps(rec, sort_keys=True)


def reset() -> None:
    _PHASES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(path: str = "/tmp/jax-trace"):
    """jax.profiler trace (view with Perfetto / tensorboard)."""
    import jax

    try:
        jax.profiler.start_trace(path)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
