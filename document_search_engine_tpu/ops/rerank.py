"""Hybrid retrieval: dense-embedding rerank of lexical candidates
(BASELINE.json:11 "BM25 candidate gen + dense-embedding rerank").

Embeddings are deterministic feature-hash projections of each doc's
materialized impact profile: posting (term t, doc d, val v) contributes
`rne(v * 2^EMB_QBITS) * sign(t)` to column `col(t) = (hash(t) >> 8) %
dim`, with `sign(t) = +-1` from hash bit 40 — no training. Cells are
integer sums (order-free, so the HOST and the DEVICE builders agree
bit-for-bit), clipped to int8 range. Doc embeddings build ON DEVICE from
the resident aligned posting planes with a jit scatter-add, live in HBM
as int8 (4x smaller than f32 — an 8M-doc dim-256 table is 2 GB), and
candidates are gathered and scored on device.

Exactness scheme (DESIGN.md §2 spirit): every DEVICE-side number is an
exact integer — embedding cells (int8), squared norms (int32 sums of
squares), and candidate dot products (int8 x int8 accumulated in
int32; |cell| <= EMB_CLIP keeps every dot far inside int32). The only
approximate math — cosine = dot / sqrt(ssq_q * ssq_d) and its
quantization — runs on HOST in float64 from those exact integers, so
rankings are deterministic across backends and identical to the pure-
host reference (tested).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

F32 = np.float32

EMB_QBITS = 5  # contribution quantization: rne(val * 2^5)
EMB_CLIP = 63  # |cell| bound; dots <= dim * 63^2 stay exact (< 2^24)


def term_projection(term_hash: np.ndarray, dim: int):
    """(col int32, sign int32 +-1) per vocab term from its 64-bit hash."""
    col = ((term_hash >> np.uint64(8)) % np.uint64(dim)).astype(np.int32)
    sign = np.where(
        (term_hash >> np.uint64(40)) & np.uint64(1), -1, 1
    ).astype(np.int32)
    return col, sign


def doc_embeddings_int(
    term_hash: np.ndarray,
    indptr: np.ndarray,
    post_doc: np.ndarray,  # (nnz,) contiguous
    post_val: np.ndarray,  # (nnz,) f32 contiguous
    n_docs: int,
    dim: int,
):
    """HOST reference builder: (emb int8 (n_docs, dim), ssq int32
    (n_docs,)). Bit-identical to device_doc_embeddings_int (tested)."""
    col, sign = term_projection(term_hash, dim)
    nnz = int(indptr[-1])
    row_of = np.repeat(
        np.arange(len(term_hash), dtype=np.int64),
        np.diff(indptr).astype(np.int64),
    )
    ci = np.rint(
        post_val[:nnz].astype(F32) * F32(2.0**EMB_QBITS)
    ).astype(np.int64) * sign[row_of]
    emb = np.zeros((n_docs, dim), dtype=np.int64)
    np.add.at(emb, (post_doc[:nnz].astype(np.int64), col[row_of]), ci)
    emb = np.clip(emb, -EMB_CLIP, EMB_CLIP).astype(np.int8)
    ssq = (emb.astype(np.int32) ** 2).sum(axis=1).astype(np.int32)
    return emb, ssq


@partial(jax.jit, static_argnames=("n_docs", "dim"))
def device_doc_embeddings_int(
    post_doc2: jnp.ndarray,  # (X, 128) i32 aligned doc plane
    post_val2: jnp.ndarray,  # (X, 128) i32 aligned bitcast-f32 vals
    row_start: jnp.ndarray,  # (T,) i32 aligned row starts
    term_col: jnp.ndarray,  # (T,) i32 projection columns
    term_sign: jnp.ndarray,  # (T,) i32 +-1
    n_docs: int,
    dim: int,
):
    """DEVICE builder: jit scatter-add over the resident posting planes
    (the O(nnz) postings never leave HBM). Returns (emb int8, ssq int32)
    — exact integers, bit-identical to the host reference."""
    x_rows = post_doc2.shape[0]
    # each 128-record plane row belongs to exactly one term (rows are
    # 128-aligned); among equal starts the last duplicate is the only
    # one with nonzero length, which searchsorted(side='right') picks
    plane_start = jnp.arange(x_rows, dtype=jnp.int32) * 128
    term_of = (
        jnp.searchsorted(row_start, plane_start, side="right") - 1
    ).astype(jnp.int32)
    term_of = jnp.clip(term_of, 0, row_start.shape[0] - 1)
    col = term_col[term_of][:, None]  # (X, 1)
    sign = term_sign[term_of][:, None]
    val = jax.lax.bitcast_convert_type(post_val2, jnp.float32)
    ci = (
        jnp.round(val * jnp.float32(2.0**EMB_QBITS)).astype(jnp.int32)
        * sign
    )
    doc = jnp.minimum(post_doc2, n_docs)  # sentinel rows -> slot n_docs
    emb = jnp.zeros((n_docs + 1, dim), jnp.int32)
    emb = emb.at[
        doc.reshape(-1), jnp.broadcast_to(col, post_doc2.shape).reshape(-1)
    ].add(ci.reshape(-1))
    emb = jnp.clip(emb[:n_docs], -EMB_CLIP, EMB_CLIP).astype(jnp.int8)
    ssq = (emb.astype(jnp.int32) ** 2).sum(axis=1)
    return emb, ssq


def query_embeddings_int(
    slot_h: np.ndarray, coeff: np.ndarray, dim: int
):
    """(emb int8 (nq, dim), ssq int64 (nq,)) query projections — host
    math (queries are host-resident), scaled so the largest |cell| uses
    the full int8 range."""
    nq = slot_h.shape[0]
    emb = np.zeros((nq, dim), dtype=np.float64)
    col, sign = term_projection(slot_h.reshape(-1), dim)
    col = col.reshape(slot_h.shape)
    sign = sign.reshape(slot_h.shape)
    for s in range(slot_h.shape[1]):
        np.add.at(
            emb,
            (np.arange(nq), col[:, s]),
            coeff[:, s].astype(np.float64) * sign[:, s],
        )
    peak = np.abs(emb).max(axis=1)
    peak = np.where(peak == 0, 1.0, peak)
    q = np.rint(emb / peak[:, None] * EMB_CLIP).astype(np.int8)
    ssq = (q.astype(np.int64) ** 2).sum(axis=1)
    return q, ssq


@jax.jit
def rerank_dots(qemb: jnp.ndarray, cand_emb: jnp.ndarray) -> jnp.ndarray:
    """(nq, K) int32 exact candidate dots: int8 operands accumulated in
    int32 (|dot| <= dim * EMB_CLIP^2, far inside int32), so every backend
    returns the same integers."""
    return jax.lax.dot_general(
        qemb,
        cand_emb,
        dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )


def rerank_dots_ref(qemb: jnp.ndarray, cand_emb: jnp.ndarray) -> jnp.ndarray:
    """jnp f32 reference of the exact integer dots (tested equal):
    integer-valued products and sums stay exact in f32 below 2^24, given
    full f32 precision (HIGHEST — a GPU's default f32 matmul is TF32)."""
    return jnp.einsum(
        "qe,qke->qk",
        qemb.astype(jnp.float32),
        cand_emb.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)


@jax.jit
def gather_and_dot(
    emb: jnp.ndarray,  # (n_docs, dim) int8 device-resident
    ssq: jnp.ndarray,  # (n_docs,) int32
    qemb: jnp.ndarray,  # (nq, dim) int8
    gids: jnp.ndarray,  # (nq, K) int32 candidate doc ids (-1 = dead)
):
    """Device-side candidate gather + exact dots: (dots (nq, K) i32,
    cand_ssq (nq, K) i32). Dead candidates read row 0 (masked by the
    host ordering via lex <= 0)."""
    safe = jnp.maximum(gids, 0)
    cand = emb[safe]  # (nq, K, dim) row gather
    return rerank_dots(qemb, cand), ssq[safe]


def rerank_order_int(
    dots: np.ndarray,  # (nq, K) int32 exact dots
    ssq_q: np.ndarray,  # (nq,) int64
    ssq_d: np.ndarray,  # (nq, K) int32
    lex_vals: np.ndarray,  # (nq, K) int lexical scores (-1 = dead)
    gids: np.ndarray,  # (nq, K) int
    k: int,
    scale_bits: int = 20,
):
    """Final ranked (ids, rerank_int, lex) by (rerank desc, lex desc,
    gid asc); dead candidates sink. cosine = dot / sqrt(ssq_q*ssq_d) is
    computed in HOST float64 from the exact device integers, then
    quantized — deterministic on every backend."""
    denom = np.sqrt(
        ssq_q[:, None].astype(np.float64) * ssq_d.astype(np.float64)
    )
    denom = np.where(denom == 0, 1.0, denom)
    cos = dots.astype(np.float64) / denom
    ri = np.rint(cos * float(2.0**scale_bits)).astype(np.int64)
    ri = np.where(lex_vals > 0, ri, np.int64(-(2**40)))
    order = np.lexsort(
        (gids, -np.asarray(lex_vals, np.int64), -ri), axis=-1
    )[:, :k]
    out_ids = np.take_along_axis(gids, order, axis=1)
    out_ri = np.take_along_axis(ri, order, axis=1)
    out_lex = np.take_along_axis(
        np.asarray(lex_vals, np.int64), order, axis=1
    )
    dead = out_lex <= 0
    out_ids = np.where(dead, -1, out_ids)
    out_ri = np.where(dead, -1, out_ri)
    out_lex = np.where(dead, -1, out_lex)
    return out_ids, out_ri, out_lex
