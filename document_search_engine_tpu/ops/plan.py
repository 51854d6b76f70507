"""Per-(query, block) plan tables shared by both device scorers.

A plan row (a query, or a doc-range piece of one) reads the CSR rows of
its S slots as fixed-size blocks of the (X, 128) posting planes. For
every block the tables hold:

- `srcrow`: the block's first plane row (-1 = skip);
- `rem`: postings remaining at block start (masks the block's tail);
- `abits`: the slot coefficient, as bitcast f32;
- `dstrow`: the block's offset, in 128-record granule rows, in the
  COMPACTED candidate buffer — the exclusive running sum of each block's
  granule-rounded real rows, so block padding never reaches the ranking.

The XLA twin (ops/packed.py search_packed_tables) reads srcrow/rem/abits;
the CUDA kernel (ops/fused_cuda.py) also stores at dstrow. The host
planner (`plan_tables`) and the device expansion (`expand_plan_tables`,
which runs inside the serving dispatch from the shipped (nq, S)
rows/coefficient bits) are bit-identical (tests/test_plan_fuzz.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..index.csr import LANES, NNZ_SLICE_MARGIN


def compact_rows(rem, block: int):
    """Per-block compacted row count from a rem table: real postings in
    the block, rounded up to whole 128-record rows (numpy or jnp)."""
    np_ = np if isinstance(rem, np.ndarray) else jnp
    valid = np_.clip(rem, 0, block)
    return (-(-valid // LANES)).astype(np.int32)


def _check_block(block: int) -> None:
    # tail blocks read up to block-128 records past a row's aligned end;
    # the builders guarantee NNZ_SLICE_MARGIN of in-bounds tail
    assert block <= NNZ_SLICE_MARGIN, (
        f"block={block} exceeds the builder's slice margin "
        f"({NNZ_SLICE_MARGIN}); tail blocks would read out of bounds"
    )


def plan_tables(
    row_start: np.ndarray,  # (T,) aligned flat record offsets per row
    indptr: np.ndarray,  # (T+1,) true cumulative lengths
    rows: np.ndarray,  # (nq, S) term rows per slot
    coeff: np.ndarray,  # (nq, S) f32 slot coefficients (0 = missing)
    n_blocks: int,
    block: int,
    lo: np.ndarray | None = None,  # (nq, S) piece record-range start
    hi: np.ndarray | None = None,  # (nq, S) piece record-range end
):
    """Host-side plan: (srcrow, rem, abits, dstrow), each (nq, 1,
    n_blocks) int32. Pure vectorized numpy.

    lo/hi (doc-range splitting, ops/schedule.py split_pieces): per slot,
    only records [lo, hi) of the row are this plan row's piece. Reads
    stay 128-aligned by starting at floor128(lo); the sub-granule head
    overlap is masked by the scorers' doc-range limits (dlim), not here —
    rem masks only the [*, hi) tail."""
    _check_block(block)
    nq, s = rows.shape
    b128 = block // LANES
    if len(indptr) < 2:  # empty segment/shard: every block skipped
        z = np.zeros((nq, 1, n_blocks), np.int32)
        return (
            np.full((nq, 1, n_blocks), -1, np.int32), z, z.copy(),
            z.copy(),
        )
    if lo is not None:
        start_al = (lo - (lo % LANES)).astype(np.int64)
        lens = hi.astype(np.int64) - start_al
    else:
        start_al = np.zeros(rows.shape, np.int64)
        lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    lens = np.where(coeff > 0, lens, 0)
    nblk = -(-lens // block)
    blk_cum = np.concatenate(
        [np.zeros((nq, 1), np.int64), np.cumsum(nblk, axis=1)], axis=1
    )
    jj = np.arange(n_blocks, dtype=np.int64)[None, :]
    srcrow = np.full((nq, n_blocks), -1, np.int32)
    rem = np.zeros((nq, n_blocks), np.int32)
    abits = np.zeros((nq, n_blocks), np.int32)
    cbits = coeff.astype(np.float32).view(np.int32)
    starts128 = (
        (row_start[rows] + start_al) // LANES
    ).astype(np.int64)  # (nq, S); start_al is 128-aligned
    for t in range(s):
        in_t = (jj >= blk_cum[:, t : t + 1]) & (
            jj < blk_cum[:, t + 1 : t + 2]
        )
        off_b = jj - blk_cum[:, t : t + 1]
        srcrow = np.where(
            in_t, starts128[:, t : t + 1] + off_b * b128, srcrow
        ).astype(np.int32)
        rem = np.where(
            in_t, lens[:, t : t + 1] - off_b * block, rem
        ).astype(np.int32)
        abits = np.where(in_t, cbits[:, t : t + 1], abits)
    crows = compact_rows(rem, block)
    dstrow = np.zeros((nq, n_blocks), np.int32)
    np.cumsum(crows[:, :-1], axis=1, out=dstrow[:, 1:])
    return (
        srcrow.reshape(nq, 1, n_blocks),
        rem.reshape(nq, 1, n_blocks),
        abits.reshape(nq, 1, n_blocks),
        dstrow.reshape(nq, 1, n_blocks),
    )


def expand_plan_tables(
    row_start: jnp.ndarray,  # (T,) i32 aligned flat record offsets
    indptr: jnp.ndarray,  # (T+1,) i32 true cumulative lengths
    rows: jnp.ndarray,  # (nq, S) i32 term rows per slot
    cbits: jnp.ndarray,  # (nq, S) i32 bitcast-f32 slot coefficients
    n_blocks: int,
    block: int,
    offs_dev: jnp.ndarray | None = None,  # (T, P+1) doc-quantile offs
    cols: jnp.ndarray | None = None,  # (nq, 2) piece quantile columns
):
    """Device-side twin of plan_tables, traced inside the serving
    dispatch: pure elementwise int32 XLA over (nq, NB). Per batch the
    host ships only the (nq, S) rows and coefficient bits.

    offs_dev/cols (doc-range splitting): each plan row is a PIECE of a
    query covering quantile columns [cols[q,0], cols[q,1]) — per slot the
    record range [offs_dev[row, c0], offs_dev[row, c1]), with the read
    start rounded down to the 128 boundary (the head overlap is masked
    by the scorers' doc-range limits)."""
    _check_block(block)
    nq, s = rows.shape
    b128 = block // LANES
    if int(row_start.shape[0]) == 0:  # empty segment: every block skipped
        z = jnp.zeros((nq, 1, n_blocks), jnp.int32)
        return jnp.full((nq, 1, n_blocks), -1, jnp.int32), z, z, z
    coeff = jax.lax.bitcast_convert_type(cbits, jnp.float32)
    if cols is not None:
        lo = offs_dev[rows, cols[:, 0:1]]  # (nq, S)
        hi = offs_dev[rows, cols[:, 1:2]]
        start_al = lo - (lo % LANES)
        lens = hi - start_al
    else:
        start_al = jnp.zeros(rows.shape, jnp.int32)
        lens = indptr[rows + 1] - indptr[rows]
    lens = jnp.where(coeff > 0, lens, 0)
    nblk = -(-lens // block)
    blk_cum = jnp.concatenate(
        [jnp.zeros((nq, 1), jnp.int32), jnp.cumsum(nblk, axis=1)], axis=1
    )
    jj = jnp.arange(n_blocks, dtype=jnp.int32)[None, :]
    starts128 = (
        row_start[rows] + start_al
    ) // LANES  # (nq, S), rows and start_al are 128-aligned
    srcrow = jnp.full((nq, n_blocks), -1, jnp.int32)
    rem = jnp.zeros((nq, n_blocks), jnp.int32)
    abits = jnp.zeros((nq, n_blocks), jnp.int32)
    for t in range(s):
        in_t = (jj >= blk_cum[:, t : t + 1]) & (
            jj < blk_cum[:, t + 1 : t + 2]
        )
        off_b = jj - blk_cum[:, t : t + 1]
        srcrow = jnp.where(in_t, starts128[:, t : t + 1] + off_b * b128, srcrow)
        rem = jnp.where(in_t, lens[:, t : t + 1] - off_b * block, rem)
        abits = jnp.where(in_t, cbits[:, t : t + 1], abits)
    crows = compact_rows(rem, block)
    dstrow = jnp.cumsum(crows, axis=1) - crows  # exclusive
    return (
        srcrow.reshape(nq, 1, n_blocks),
        rem.reshape(nq, 1, n_blocks),
        abits.reshape(nq, 1, n_blocks),
        dstrow.reshape(nq, 1, n_blocks),
    )
