"""Packed sort-based scorer+ranker: the XLA search step.

`search_packed_tables` is the XLA twin of the CUDA fused kernel
(ops/fused_cuda.py): it consumes the very same plan tables
(ops/plan.py), serves every bucket the kernel does not take, and is the
scorer on backends without CUDA. The functions here replace the dense
(nq, n_docs) score buffer + scatter-add + giant top-k (which scale with
corpus size) with a pipeline whose cost depends only on the postings
actually touched:

1. pack     — address exactly the CSR postings of each query's slots into a
              (nq, C) buffer, C = pow-2 budget of the batch's max total
              postings per query (computed on host from indptr). Slot
              bookkeeping uses masked sums over the S slots, not gathers.
2. quantize — fixed-point int32 contributions (DESIGN.md §2);
3. sort     — per-row `lax.sort` by doc id (co-permuting contributions);
4. reduce   — a doc can appear at most once per slot, so after the sort
              its contributions occupy <= S adjacent positions: run-sums
              are S-1 shifted compare-add windows — no cumsum, no scans;
5. rank     — `lax.top_k` over run-end candidates; rows are doc-ascending,
              so tie-stability-by-index == tie-break-by-doc-id.

Every arithmetic step is order-free integer math on identically-quantized
f32 products, so results are bit-identical to the dense reference path
(ops/exact.py + ops/topk.py) and to the CPU oracle — tested both ways.
Work is O(nq * C * (S + log C)) independent of corpus size: an 8M-doc
shard costs the same as an 80k-doc shard for the same query load.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def total_cap(indptr: np.ndarray, rows: np.ndarray, found: np.ndarray) -> int:
    """Static packed-budget C for a batch: max per-query total postings,
    pow-2 bucketed (bounds recompiles)."""
    if len(indptr) < 2 or rows.size == 0:  # empty segment or no queries
        return 16
    lens = (indptr[rows + 1] - indptr[rows]) * found
    m = int(lens.sum(axis=1).max())
    return max(16, 1 << int(np.ceil(np.log2(max(m, 1)))))


@partial(jax.jit, static_argnames=("c_total", "k", "n_docs"))
def search_packed(
    indptr: jnp.ndarray,  # (T+1,) int32
    post_doc: jnp.ndarray,  # (nnz_pad,) int32
    post_val: jnp.ndarray,  # (nnz_pad,) f32 — 0 for tombstoned docs
    rows: jnp.ndarray,  # (nq, S) int32 (0 where missing)
    coeff: jnp.ndarray,  # (nq, S) f32 (0 where missing)
    scale: jnp.ndarray,  # f32 scalar 2^scale_bits
    clip: jnp.ndarray,  # f32 scalar per-contribution clip
    doc_base: jnp.ndarray,  # int32 scalar — global id of local doc 0
    c_total: int,
    k: int,
    n_docs: int,  # local doc-id sentinel for padding (> any real doc)
    row_start: jnp.ndarray | None = None,  # (T,) aligned starts (else
    #                                        rows are indptr-contiguous)
):
    """(vals (nq,k) int32, gids (nq,k) int32), ranked (score desc, gid asc),
    matching (score>0) alive docs only; empty slots are (-1, -1)."""
    nq, s = rows.shape
    starts = (indptr if row_start is None else row_start)[rows]
    lens = indptr[rows + 1] - indptr[rows]
    lens = jnp.where(coeff > 0, lens, 0)  # missing slots pack nothing
    cum = jnp.concatenate(
        [jnp.zeros((nq, 1), lens.dtype), jnp.cumsum(lens, axis=1)], axis=1
    )  # (nq, S+1)
    total = cum[:, -1:]  # (nq, 1)

    p = jnp.arange(c_total, dtype=jnp.int32)[None, :]  # (1, C)
    valid = p < total  # (nq, C)
    # per-position slot attributes via masked sums over the S slots
    idx = jnp.zeros((nq, c_total), jnp.int32)
    a = jnp.zeros((nq, c_total), jnp.float32)
    for j in range(s):
        in_j = (p >= cum[:, j : j + 1]) & (p < cum[:, j + 1 : j + 2])
        idx = idx + jnp.where(
            in_j, starts[:, j : j + 1] + (p - cum[:, j : j + 1]), 0
        )
        a = a + jnp.where(in_j, coeff[:, j : j + 1], 0.0)
    idx = jnp.where(valid, idx, 0)

    d = post_doc[idx]  # (nq, C) local doc ids — the two big gathers
    v = post_val[idx]
    # fixed-point quantization (DESIGN.md §2): identical to oracle/spec.py
    ci_f = jnp.round((a * v) * scale)
    ci = jnp.clip(ci_f, 0.0, clip).astype(jnp.int32)
    ci = jnp.where(valid, ci, 0)
    d_key = jnp.where(valid, d, n_docs)  # padding sorts last
    return rank_candidates(d_key, ci, doc_base, s, k, n_docs)


def rank_candidates(d_key, ci, doc_base, s: int, k: int, n_docs: int):
    """Shared tail of the packed scorers: sort by doc, window run-sums,
    ranked top-k (see module docstring, stages 3-5)."""
    nq, c_total = d_key.shape
    d_s, ci_s = jax.lax.sort((d_key, ci), dimension=1, num_keys=1)

    # run-sums via shifted windows: a doc occupies <= S adjacent positions
    next_d = jnp.concatenate(
        [d_s[:, 1:], jnp.full((nq, 1), -2, d_s.dtype)], axis=1
    )
    last = d_s != next_d
    run_sum = ci_s
    for j in range(1, s):
        d_shift = jnp.concatenate(
            [jnp.full((nq, j), -1, d_s.dtype), d_s[:, : c_total - j]], axis=1
        )
        ci_shift = jnp.concatenate(
            [jnp.zeros((nq, j), ci_s.dtype), ci_s[:, : c_total - j]], axis=1
        )
        run_sum = run_sum + jnp.where(d_shift == d_s, ci_shift, 0)

    cand = jnp.where(last & (d_s < n_docs) & (run_sum > 0), run_sum, -1)
    kk = min(k, c_total)
    vals, sel = jax.lax.top_k(cand, kk)  # doc-ascending rows: ties by id
    gids = jnp.take_along_axis(d_s, sel, axis=1) + doc_base
    gids = jnp.where(vals > 0, gids, -1)
    vals = jnp.where(vals > 0, vals, -1)
    if kk < k:
        vals = jnp.concatenate(
            [vals, jnp.full((nq, k - kk), -1, vals.dtype)], axis=1
        )
        gids = jnp.concatenate(
            [gids, jnp.full((nq, k - kk), -1, gids.dtype)], axis=1
        )
    return vals, gids


@partial(
    jax.jit,
    static_argnames=(
        "n_blocks",
        "block",
        "s",
        "k",
        "n_docs",
    ),
)
def search_packed_tables(
    post_doc2: jnp.ndarray,  # (X, 128) i32 aligned doc plane
    post_val2: jnp.ndarray,  # (X, 128) i32 aligned bitcast-f32 vals
    srcrow: jnp.ndarray,  # (nq, 1, NB) i32 plan (ops/plan.py)
    rem: jnp.ndarray,  # (nq, 1, NB) i32
    abits: jnp.ndarray,  # (nq, 1, NB) i32 bitcast-f32 slot coefficients
    scale: jnp.ndarray,
    clip: jnp.ndarray,
    doc_base: jnp.ndarray,
    n_blocks: int,
    block: int,
    s: int,  # query slot count (bounds per-doc occurrences per row)
    k: int,
    n_docs: int,
    dlim: jnp.ndarray | None = None,  # (nq, 1, 2) i32 [d_lo, d_hi)
):
    """XLA twin of the CUDA fused kernel: consumes the exact same
    per-(query, block) plan tables (ops/plan.py plan_tables) so the
    serving paths stage once and pick the scorer per bucket.
    Bit-identical to the kernel and to search_packed (tested).

    dlim (doc-range splitting): per plan row, postings with doc outside
    [d_lo, d_hi) are masked like rem-tail padding — as in the kernel."""
    from ..index.csr import NNZ_SLICE_MARGIN

    assert block <= NNZ_SLICE_MARGIN, (
        f"block={block} exceeds the builder's slice margin "
        f"({NNZ_SLICE_MARGIN}); tail blocks would read clamped sources"
    )
    nq = srcrow.shape[0]
    srcrow2 = srcrow.reshape(nq, n_blocks)
    rem2 = rem.reshape(nq, n_blocks)
    a_b = jax.lax.bitcast_convert_type(
        abits.reshape(nq, n_blocks), jnp.float32
    )
    src = jnp.maximum(srcrow2, 0).astype(jnp.int32) * 128
    doc_flat = post_doc2.reshape(-1)
    val_flat = post_val2.reshape(-1)
    slice_one = jax.vmap(
        jax.vmap(
            lambda s0: (
                jax.lax.dynamic_slice(doc_flat, (s0,), (block,)),
                jax.lax.dynamic_slice(val_flat, (s0,), (block,)),
            )
        )
    )
    d_b, v_b = slice_one(src)  # (nq, NB, block)
    v = jax.lax.bitcast_convert_type(v_b, jnp.float32)
    lane = jnp.arange(block, dtype=jnp.int32)[None, None, :]
    valid = (lane < rem2[:, :, None]) & (srcrow2[:, :, None] >= 0)
    if dlim is not None:
        valid = (
            valid
            & (d_b >= dlim[:, :, 0:1])
            & (d_b < dlim[:, :, 1:2])
        )
    a = jnp.broadcast_to(a_b[:, :, None], (nq, n_blocks, block))
    ci_f = jnp.round((a * v) * scale)
    ci = jnp.clip(ci_f, 0.0, clip).astype(jnp.int32)
    ci = jnp.where(valid, ci, 0).reshape(nq, n_blocks * block)
    d_key = jnp.where(valid, d_b, n_docs).reshape(nq, n_blocks * block)
    return rank_candidates(d_key, ci, doc_base, s, k, n_docs)


def _src_table(starts, lens, n_blocks: int, block: int, nnz_pad: int):
    """(nq, n_blocks) int32 flat source offsets (-1 = skip), plus the
    block-aligned per-slot cum offsets (nq, S+1) for downstream masking.
    Pure elementwise XLA over (nq, S) and (nq, n_blocks): cheap."""
    nq, s = starts.shape
    nblk = -(-lens // block)  # (nq, S)
    blk_cum = jnp.concatenate(
        [jnp.zeros((nq, 1), nblk.dtype), jnp.cumsum(nblk, axis=1)], axis=1
    )
    j = jnp.arange(n_blocks, dtype=jnp.int32)[None, :]  # (1, NB)
    src = jnp.full((nq, n_blocks), -1, jnp.int32)
    for t in range(s):
        in_t = (j >= blk_cum[:, t : t + 1]) & (j < blk_cum[:, t + 1 : t + 2])
        off = (j - blk_cum[:, t : t + 1]) * block
        src_t = starts[:, t : t + 1] + off
        src = jnp.where(in_t, src_t, src)
    # clamp so src+block stays in bounds (tail blocks read past the row;
    # those lanes are masked downstream)
    src = jnp.where(src >= 0, jnp.minimum(src, nnz_pad - block), src)
    return src, blk_cum


@partial(
    jax.jit,
    static_argnames=(
        "n_blocks",
        "k",
        "n_docs",
        "block",
    ),
)
def search_packed_ds(
    post_doc2: jnp.ndarray,  # (X, 128) int32 aligned doc plane
    post_val2: jnp.ndarray,  # (X, 128) int32 aligned bitcast-f32 vals;
    #                          0 for tombstoned docs
    indptr: jnp.ndarray,  # (T+1,) int32 — true cumulative lengths
    row_start: jnp.ndarray,  # (T,) int32 — aligned flat row starts
    rows: jnp.ndarray,  # (nq, S) int32
    coeff: jnp.ndarray,  # (nq, S) f32
    scale: jnp.ndarray,
    clip: jnp.ndarray,
    doc_base: jnp.ndarray,
    n_blocks: int,
    k: int,
    n_docs: int,
    block: int = 512,
):
    """search_packed with the packing stage as vmapped `dynamic_slice`
    block copies over the aligned posting planes. Destination regions
    are block-aligned per slot; the builder's NNZ_SLICE_MARGIN tail keeps
    block reads past a row's end in bounds. Bit-identical to
    search_packed (tested).
    """
    from ..index.csr import NNZ_SLICE_MARGIN

    # Builders pad the planes by NNZ_SLICE_MARGIN; a bigger block would
    # make _src_table clamp tail-block sources, silently misaligning that
    # block while its lanes stay marked valid. Fail loudly instead.
    assert block <= NNZ_SLICE_MARGIN, (
        f"block={block} exceeds the builder's nnz slice margin "
        f"({NNZ_SLICE_MARGIN}); tail blocks would read clamped sources"
    )
    nq, s = rows.shape
    starts = row_start[rows]
    lens = indptr[rows + 1] - indptr[rows]
    lens = jnp.where(coeff > 0, lens, 0)
    nnz_pad = int(post_doc2.shape[0]) * int(post_doc2.shape[1])
    src, blk_cum = _src_table(starts, lens, n_blocks, block, nnz_pad)
    src_c = jnp.maximum(src, 0)

    doc_flat = post_doc2.reshape(-1)
    val_flat = post_val2.reshape(-1)
    slice_one = jax.vmap(
        jax.vmap(
            lambda s0: (
                jax.lax.dynamic_slice(doc_flat, (s0,), (block,)),
                jax.lax.dynamic_slice(val_flat, (s0,), (block,)),
            )
        )
    )
    d_b, v_b = slice_one(src_c)  # (nq, NB, block) each
    d = d_b.reshape(nq, n_blocks * block)
    v = jax.lax.bitcast_convert_type(v_b, jnp.float32).reshape(
        nq, n_blocks * block
    )

    # per-block slot attribution (block-aligned regions)
    blk = jnp.arange(n_blocks, dtype=jnp.int32)[None, :]
    a_b = jnp.zeros((nq, n_blocks), jnp.float32)
    rem_b = jnp.zeros((nq, n_blocks), jnp.int32)
    for t in range(s):
        in_t = (blk >= blk_cum[:, t : t + 1]) & (
            blk < blk_cum[:, t + 1 : t + 2]
        )
        off_t = (blk - blk_cum[:, t : t + 1]) * block
        a_b = a_b + jnp.where(in_t, coeff[:, t : t + 1], 0.0)
        rem_b = rem_b + jnp.where(in_t, lens[:, t : t + 1] - off_t, 0)
    lane = jnp.arange(block, dtype=jnp.int32)[None, None, :]
    valid = (lane < rem_b[:, :, None]).reshape(nq, n_blocks * block)
    a = jnp.broadcast_to(
        a_b[:, :, None], (nq, n_blocks, block)
    ).reshape(nq, n_blocks * block)

    ci_f = jnp.round((a * v) * scale)
    ci = jnp.clip(ci_f, 0.0, clip).astype(jnp.int32)
    ci = jnp.where(valid, ci, 0)
    d_key = jnp.where(valid, d, n_docs)
    return rank_candidates(d_key, ci, doc_base, s, k, n_docs)
