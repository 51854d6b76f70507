"""Test env: CPU backend with 8 virtual devices (SURVEY.md §4).

Must run before any jax import. The backend comes from JAX_PLATFORMS
when it is set and is the CPU otherwise; the tests marked `chip` run on
a GPU (`JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/`) and skip
elsewhere — each decides inside its `gpu` fixture, never at import.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
