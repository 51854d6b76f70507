"""Batch scheduling: bucket queries by packed-block need.

The packed search step's cost is nq * n_blocks, but n_blocks is set by the
*largest* query in the batch (static shapes under jit). With Zipf term
statistics the max query routinely needs 4-8x the average, so running one
kernel at the max budget wastes most of the work. Instead queries are
grouped into pow-2 n_blocks buckets and each bucket runs at its own
budget; per-bucket shapes are pow-2 so the jit cache stays small.
Results are scattered back to original positions — rankings are unchanged
(scores are order-free integers, and each query is self-contained).
"""
from __future__ import annotations

import numpy as np


def block_plan(
    indptr: np.ndarray,
    rows: np.ndarray,
    found: np.ndarray,
    block: int = 512,
) -> int:
    """Static n_blocks for a batch: max per-query sum of ceil(len/block),
    pow-2 bucketed (bounds recompiles)."""
    if len(indptr) < 2 or rows.size == 0:
        return 1
    lens = (indptr[rows + 1] - indptr[rows]) * found
    nblk = -(-lens // block)  # ceil
    m = int(nblk.sum(axis=1).max())
    return max(1, 1 << int(np.ceil(np.log2(max(m, 1)))))


def blocks_per_query(
    indptr: np.ndarray, rows: np.ndarray, found: np.ndarray, block: int
) -> np.ndarray:
    """(nq,) int: sum over slots of ceil(len/block)."""
    if len(indptr) < 2 or rows.size == 0:
        return np.zeros(rows.shape[0] if rows.ndim else 0, np.int64)
    lens = (indptr[rows + 1] - indptr[rows]) * found
    return (-(-lens // block)).sum(axis=1)


# (threshold, block): queries whose total postings are <= threshold use
# that block size. The XLA twin sorts every lane of its uncompacted
# n_blocks * block buffer, so light queries take fine blocks (less
# ceil padding) and heavy ones coarse blocks (fewer slices). The values
# have not been tuned on the GPU.
DEFAULT_FAMILIES = ((8192, 256), (None, 1024))

# The CUDA kernel compacts each block's real postings, so block padding
# costs it nothing past the read: one family of the largest legal block
# (NNZ_SLICE_MARGIN) keeps the plan tables short.
FUSED_FAMILIES = ((None, 4096),)


def compact_rows_per_query(lens: np.ndarray, block: int) -> np.ndarray:
    """(..., ) compacted candidate-buffer rows per query (summed over the
    slot axis, the last one): per slot, full blocks contribute block/128
    rows each and the tail block its real rows rounded up — exactly
    the space the CUDA kernel's dstrow compaction uses."""
    full = lens // block
    tail = lens - full * block
    rows = full * (block // 128) + (-(-tail // 128))
    return rows.sum(axis=-1)


def bucket_rows(rc: np.ndarray, cap: int, min_rows: int = 8):
    """Group query indices by pow-2 compacted-buffer budget in
    [min_rows, cap]. Returns [(indices, r_c)]."""
    r = np.clip(rc, 1, cap)
    exp = np.ceil(np.log2(np.maximum(r, 1))).astype(np.int64)
    exp = np.clip(
        exp, int(np.log2(min_rows)), int(np.log2(cap))
    )
    out = []
    for e in np.unique(exp):
        idx = np.nonzero(exp == e)[0]
        out.append((idx, 1 << int(e)))
    return out


def split_pieces(
    lens: np.ndarray,  # (nq, S) per-slot postings lengths (0 = missing)
    rows: np.ndarray,  # (nq, S) term rows
    offs: np.ndarray,  # (T, P+1) host doc-quantile table (builder)
    threshold_rows: int,  # split queries needing more compacted rows
    block: int,
    p: int,  # quantile columns (builder.SPLIT_QUANTILES)
):
    """Doc-range split plan for heavy queries: a query whose compacted
    candidate need exceeds `threshold_rows` becomes m = 2^ceil(log2(
    need/threshold)) pieces (capped at p), piece i covering quantile
    columns [p*i/m, p*(i+1)/m) — doc-DISJOINT ranges, so every doc's
    integer score is complete within one piece and the per-query merge
    of piece top-ks equals the unsplit ranking exactly (the same
    argument as the doc-sharded segment merge). Light queries stay one
    piece with columns (0, p).

    Returns (qidx (np_,), pno (np_,), cols (np_, 2), lens_p (np_, S)):
    the piece->query map, each piece's index within its query, its
    quantile columns, and its per-slot DMA lengths (from the 128-aligned
    piece range starts — what the kernel will actually stream).

    Rationale: ranking cost grows superlinearly with the candidate
    buffer (a sort), and a split heavy query can fit the kernel's
    shared memory where the whole query would not."""
    need = compact_rows_per_query(lens, block)  # (nq,)
    qidx, pno, cols = _piece_structure(need, threshold_rows, p)
    lens_p = _piece_lens(lens, rows, offs, qidx, cols)
    return qidx, pno, cols, lens_p


def _piece_structure(need: np.ndarray, threshold_rows: int, p: int):
    """(qidx, pno, cols) piece table from per-query compacted need: a
    query needing more than `threshold_rows` becomes m = 2^ceil(log2(
    need/threshold)) pieces (capped at p), piece i covering quantile
    columns [p*i/m, p*(i+1)/m)."""
    nq = len(need)
    m = np.ones(nq, np.int64)
    heavy = need > threshold_rows
    if heavy.any():
        ratio = -(-need[heavy] // threshold_rows)
        mm = 1 << np.ceil(np.log2(ratio)).astype(np.int64)
        m[heavy] = np.minimum(mm, p)
    starts = np.zeros(nq + 1, np.int64)
    np.cumsum(m, out=starts[1:])
    total = int(starts[-1])
    qidx = np.repeat(np.arange(nq, dtype=np.int64), m)
    pno = (np.arange(total, dtype=np.int64) - starts[qidx]).astype(
        np.int32
    )
    mq = m[qidx]
    c0 = ((pno * p) // mq).astype(np.int32)
    c1 = (((pno + 1) * p) // mq).astype(np.int32)
    return qidx, pno, np.stack([c0, c1], axis=1)


def _piece_lens(lens, rows, offs, qidx, cols):
    """Per-slot DMA lengths of each piece from a quantile table: the
    128-aligned piece range [align128(offs[r, c0]), offs[r, c1])."""
    rows_p = rows[qidx]
    lo = offs[rows_p, cols[:, 0:1]].astype(np.int64)
    hi = offs[rows_p, cols[:, 1:2]].astype(np.int64)
    start_al = lo - (lo % 128)
    return np.where(lens[qidx] > 0, hi - start_al, 0)


def split_pieces_sharded(
    lens_sh: np.ndarray,  # (n_shards, nq, S) per-slot lengths
    rows: np.ndarray,  # (nq, S) GLOBAL term rows
    offs_sh: np.ndarray,  # (n_shards, T_pad, P+1) per-shard quantile
    #                       tables in the global row space
    threshold_rows: int,
    block: int,
    p: int,
):
    """split_pieces for the SPMD engine: the piece STRUCTURE (how many
    pieces per query, which quantile columns) must be fleet-uniform —
    it is part of the replicated plan — so it is decided from the
    max-over-shards compacted need, while each shard's piece lengths
    come from its own quantile table (per-shard record ranges expand on
    device from the resident tables; the host only needs the lengths
    for the max-over-shards block budgets).

    Returns (qidx, pno, cols, lens_p_sh (n_shards, np_, S))."""
    need = compact_rows_per_query(lens_sh, block).max(axis=0)  # (nq,)
    qidx, pno, cols = _piece_structure(need, threshold_rows, p)
    lens_p_sh = np.stack(
        [
            _piece_lens(lens_sh[i], rows, offs_sh[i], qidx, cols)
            for i in range(lens_sh.shape[0])
        ]
    )
    return qidx, pno, cols, lens_p_sh


def plan_batch(
    indptr: np.ndarray,
    rows: np.ndarray,
    found: np.ndarray,
    families=DEFAULT_FAMILIES,
    min_blocks: int = 4,
    compact: bool = False,
    lens: np.ndarray | None = None,
):
    """Mixed-block schedule: light queries use fine blocks (less per-slot
    ceil padding — the dominant population under Zipf), heavy queries use
    coarse blocks (fewer slices). Families are (total-postings threshold,
    block size), last threshold None = rest.

    Returns [(query_indices, n_blocks, block_size, r_c)] covering every
    query exactly once. r_c is the bucket's compacted candidate-buffer
    rows: with compact=True (the CUDA kernel) queries are sub-bucketed
    by their real granule-rounded postings need, which the kernel's
    sort/run-sum/top-k cost scales with; otherwise r_c is the
    uncompacted n_blocks * block / 128.

    lens (doc-range splitting): precomputed per-slot DMA lengths (e.g.
    split_pieces' piece lengths) override the indptr-derived ones; rows
    then index pieces, not queries.
    """
    nq = rows.shape[0]
    if len(indptr) < 2 or rows.size == 0:
        blk0 = families[0][1]
        return (
            [(np.arange(nq), 1, blk0, blk0 // 128)] if nq else []
        )
    if lens is None:
        lens = (indptr[rows + 1] - indptr[rows]) * found
    totals = lens.sum(axis=1)
    plans = []
    assigned = np.zeros(nq, bool)
    for threshold, blk in families:
        if threshold is None:
            fam = ~assigned
        else:
            fam = (totals <= threshold) & ~assigned
        assigned |= fam
        idx_f = np.nonzero(fam)[0]
        if not len(idx_f):
            continue
        nblk = (-(-lens[idx_f] // blk)).sum(axis=1)
        rcq = compact_rows_per_query(lens[idx_f], blk) if compact else None
        for sub, nb in bucket_queries(nblk, min_blocks=min_blocks):
            cap = nb * blk // 128
            if not compact:
                plans.append((idx_f[sub], nb, blk, cap))
                continue
            for sub2, rc in bucket_rows(rcq[sub], cap=cap):
                plans.append((idx_f[sub][sub2], nb, blk, rc))
    return plans


def plan_batch_sharded(
    lens_sh: np.ndarray,
    families=DEFAULT_FAMILIES,
    min_blocks: int = 4,
    compact: bool = False,
):
    """Mixed-block schedule for the sharded engine: same family logic as
    plan_batch, but budgets are max-over-shards (SPMD programs need
    uniform shapes across the mesh). lens_sh is (n_shards, nq, S)
    per-slot postings lengths (0 where missing).

    Returns [(query_indices, n_blocks, block_size, r_c)] covering every
    query exactly once; n_blocks and r_c are max over shards of that
    bucket's need (every shard compacts into its own dstrow layout, but
    the SPMD program's buffer bound must be fleet-uniform).
    """
    n_shards, nq, s = lens_sh.shape
    totals = lens_sh.sum(axis=2).max(axis=0)  # (nq,)
    plans = []
    assigned = np.zeros(nq, bool)
    for threshold, blk in families:
        if threshold is None:
            fam = ~assigned
        else:
            fam = (totals <= threshold) & ~assigned
        assigned |= fam
        idx_f = np.nonzero(fam)[0]
        if not len(idx_f):
            continue
        nblk = (-(-lens_sh[:, idx_f] // blk)).sum(axis=2).max(axis=0)
        rcq = (
            compact_rows_per_query(lens_sh[:, idx_f], blk).max(axis=0)
            if compact
            else None
        )
        for sub, nb in bucket_queries(nblk, min_blocks=min_blocks):
            cap = nb * blk // 128
            if not compact:
                plans.append((idx_f[sub], nb, blk, cap))
                continue
            for sub2, rc in bucket_rows(rcq[sub], cap=cap):
                plans.append((idx_f[sub][sub2], nb, blk, rc))
    return plans


def bucket_queries(nblk: np.ndarray, min_blocks: int = 4):
    """Group query indices by pow-2 block budget.

    Returns [(indices ndarray, n_blocks int)], ascending budgets; every
    query appears exactly once. Queries needing 0 blocks join the smallest
    bucket (they produce empty results anyway).
    """
    nq = len(nblk)
    if nq == 0:
        return []
    budget = np.maximum(nblk, 1)
    exp = np.ceil(np.log2(budget)).astype(np.int64)
    exp = np.maximum(exp, int(np.log2(min_blocks)))
    out = []
    for e in np.unique(exp):
        idx = np.nonzero(exp == e)[0]
        out.append((idx, 1 << int(e)))
    return out
