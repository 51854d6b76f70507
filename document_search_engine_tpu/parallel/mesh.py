"""Device mesh helpers: one 1-D `docs` axis (DESIGN.md §6).

Document sharding is the only model-parallel axis a lexical index needs
(SURVEY.md §2b): the CSR term-document matrix is partitioned by contiguous
global doc-id ranges, queries are replicated, and the single collective is
the per-batch all-gather of top-k candidates.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DOCS_AXIS = "docs"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (DOCS_AXIS,))


def shard_leading(mesh: Mesh):
    """NamedSharding that splits axis 0 over the docs axis."""
    return NamedSharding(mesh, P(DOCS_AXIS))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
