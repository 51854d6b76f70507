"""Top-k ranking and candidate merge (DESIGN.md §5).

Ranking order is (score desc, doc id asc) — implemented as a two-key
lexicographic `lax.sort` on (-score, id), which is exact on every backend
(plain `lax.top_k` tie order is not guaranteed on all backends). This
module is the dense reference ranker and the candidate-merge step; the
production hot path ranks inside ops/fused_cuda.py / ops/packed.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _pad_k(vals, gids, k):
    nq, kk = vals.shape
    if kk < k:
        vals = jnp.concatenate(
            [vals, jnp.full((nq, k - kk), -1, vals.dtype)], axis=1
        )
        gids = jnp.concatenate(
            [gids, jnp.full((nq, k - kk), -1, gids.dtype)], axis=1
        )
    return vals, gids


@partial(jax.jit, static_argnames=("k",))
def topk_ranked(
    scores: jnp.ndarray,  # (nq, D) int32
    alive: jnp.ndarray,  # (D,) bool
    doc_ids: jnp.ndarray,  # (D,) int32 — global ids of the columns,
    #                        MUST be ascending (id order == column order)
    k: int,
):
    """Per-shard/segment top-k: (vals (nq,k) int32, gids (nq,k) int32).

    Uses `lax.top_k`, which is tie-stable (lower index first) on the CPU
    and GPU backends — pinned by test_topk.py::test_topk_tie_stability
    and chip_smoke.py check_topk_ties — so with ascending doc_ids the
    result is exactly (score desc, id asc). Dead/padded docs score -1 and
    their gid is masked to -1.
    """
    nq, d = scores.shape
    masked = jnp.where(alive[None, :], scores, -1)
    kk = min(k, d)
    vals, idx = jax.lax.top_k(masked, kk)
    gids = doc_ids[idx]
    # matching docs only (DESIGN.md §2): score <= 0 excluded
    gids = jnp.where(vals <= 0, -1, gids)
    vals = jnp.where(vals <= 0, -1, vals)
    return _pad_k(vals, gids, k)


@partial(jax.jit, static_argnames=("k",))
def topk_ranked_sort(
    scores: jnp.ndarray,
    alive: jnp.ndarray,
    doc_ids: jnp.ndarray,
    k: int,
):
    """Reference implementation via a two-key lexicographic sort; must
    produce identical output to topk_ranked (tested)."""
    nq, d = scores.shape
    masked = jnp.where(alive[None, :], scores, -1)
    neg = -masked
    ids_b = jnp.broadcast_to(doc_ids[None, :], (nq, d))
    neg_sorted, ids_sorted = jax.lax.sort(
        (neg, ids_b), dimension=1, num_keys=2
    )
    kk = min(k, d)
    vals = -neg_sorted[:, :kk]
    gids = jnp.where(vals <= 0, -1, ids_sorted[:, :kk])
    vals = jnp.where(vals <= 0, -1, vals)
    return _pad_k(vals, gids, k)


@partial(jax.jit, static_argnames=("k",))
def merge_candidates(vals: jnp.ndarray, gids: jnp.ndarray, k: int):
    """Merge (nq, n_candidates) ranked candidates from several shards or
    segments into one global top-k, same (score desc, id asc) order.

    This is the host-visible half of the all-gather merge across devices
    (BASELINE.json:5); inputs are the concatenated per-shard candidates.
    """
    neg = -vals
    # Dead candidates (val -1, gid -1) sort last on -val=1; keep gid order
    # stable by sorting ids as the secondary key.
    neg_sorted, ids_sorted = jax.lax.sort(
        (neg, gids), dimension=1, num_keys=2
    )
    kk = min(k, vals.shape[1])
    out_v = -neg_sorted[:, :kk]
    out_g = jnp.where(out_v <= 0, -1, ids_sorted[:, :kk])
    out_v = jnp.where(out_v <= 0, -1, out_v)
    return out_v, out_g
