"""Dense reference scorer: jit slot-scan over the CSR index.

The bit-exact reference the production packed pipeline (ops/packed.py) is
cross-tested against: for each query slot (= unique
query term), gather the term's CSR postings row, quantize each contribution
to int32 fixed-point (DESIGN.md §2), and scatter-add into dense per-query
scores. Within a slot each (query, doc) pair receives at most one
contribution, and across slots sums are *integer*, so every execution order
gives bit-identical scores — the property the BASELINE.json:5 parity gate
rests on.

Device ops used: gather, IEEE f32 multiply (exactly rounded on every backend),
round-half-even, int32 scatter-add — all bit-reproducible vs numpy.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def row_cap(indptr: np.ndarray, rows: np.ndarray) -> int:
    """Static gather capacity for a batch: max row length, pow-2 bucketed
    (bounds jit recompiles to O(log max_df) variants)."""
    if rows.size == 0:
        return 8
    lens = indptr[rows + 1] - indptr[rows]
    m = int(lens.max()) if lens.size else 0
    return max(8, 1 << int(np.ceil(np.log2(max(m, 1)))))


@partial(jax.jit, static_argnames=("cap", "n_docs_pad"))
def score_exact(
    indptr: jnp.ndarray,
    post_doc: jnp.ndarray,
    post_val: jnp.ndarray,
    rows: jnp.ndarray,  # (nq, S) int32 — CSR row per slot (0 if missing)
    coeff: jnp.ndarray,  # (nq, S) f32 — A_s per slot (0 if missing)
    scale: jnp.ndarray,  # f32 scalar: 2^scale_bits
    clip: jnp.ndarray,  # f32 scalar: per-contribution clip
    cap: int,
    n_docs_pad: int,
) -> jnp.ndarray:
    """Dense int32 scores (nq, n_docs_pad)."""
    nq = rows.shape[0]
    qids = jnp.arange(nq, dtype=jnp.int32)[:, None]  # (nq, 1)
    offs = jnp.arange(cap, dtype=jnp.int32)[None, :]  # (1, cap)

    def slot_body(scores, slot):
        r, a = slot  # (nq,), (nq,)
        start = indptr[r]  # (nq,)
        length = indptr[r + 1] - start
        mask = offs < length[:, None]  # (nq, cap)
        idx = start[:, None] + jnp.where(mask, offs, 0)
        d = post_doc[idx]  # (nq, cap)
        v = post_val[idx]
        c = a[:, None] * v  # defined nesting: A_s * val
        ci_f = jnp.round(c * scale)  # round-half-even, f32
        ci = jnp.clip(ci_f, 0.0, clip).astype(jnp.int32)
        ci = jnp.where(mask, ci, 0)
        d = jnp.where(mask, d, n_docs_pad - 1)  # junk -> last pad slot
        scores = scores.at[qids, d].add(ci, mode="drop")
        return scores, None

    # `+ indptr[0] * 0` transfers the input's varying-manual-axes
    # annotation to the scan carry (required under shard_map's vma check;
    # a no-op otherwise — XLA folds the zero).
    scores0 = jnp.zeros((nq, n_docs_pad), jnp.int32) + indptr[0] * 0
    scores, _ = jax.lax.scan(
        slot_body, scores0, (rows.T, coeff.T)
    )
    return scores
