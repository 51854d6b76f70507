"""Index build: host analyze frontend + jit-compiled CSR packing.

"Index build (tokenize, df/idf stats, CSR packing) is itself a jit-compiled
batch job" (BASELINE.json:5). String work (tokenize/hash) is inherently
host-side; everything array-shaped — sorting triples into CSR, df/dl
segment-sums — has a jit device path (`device_pack`) used by the sharded
build, plus a numpy path (`host_pack`) that produces identical arrays
(tested equal). Weight materialization follows oracle/spec.py exactly so
the parity gate holds bit-for-bit (DESIGN.md §2-§3). Materializing
per-posting impact values at build time ("eager sparse scoring") follows
the BM25S approach (PAPERS.md, arxiv 2407.03618): query time then needs
only multiplies and integer sums — which is also what makes the
fixed-point determinism possible.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..analyze.hashing import TermHasher
from ..analyze.tokenizer import Tokenizer
from ..config import IndexConfig
from ..oracle import spec
from .csr import (
    NNZ_SLICE_MARGIN,
    GlobalStats,
    SegmentDevice,
    SegmentHost,
    lookup_sorted,
    round_up,
)

F32 = np.float32


@dataclass
class AnalyzedDocs:
    """Host batch of analyzed docs: per-doc sorted (hash, tf) runs."""

    hashes: np.ndarray  # (nnz,) uint64, sorted ascending within each doc
    tfs: np.ndarray  # (nnz,) int32
    doc_ptr: np.ndarray  # (n_docs+1,) int64
    dl: np.ndarray  # (n_docs,) int32 — token counts

    @property
    def n_docs(self) -> int:
        return len(self.dl)


def analyze_texts(texts, config: IndexConfig) -> AnalyzedDocs:
    tokenizer = Tokenizer(config.analyzer)
    hasher = TermHasher()
    all_hashes, all_tfs, ptr, dls = [], [], [0], []
    for text in texts:
        toks = tokenizer(text)
        h = hasher.hash_tokens(toks)
        uh, tf = np.unique(h, return_counts=True)  # sorted ascending
        all_hashes.append(uh)
        all_tfs.append(tf.astype(np.int32))
        ptr.append(ptr[-1] + len(uh))
        dls.append(len(toks))
    return AnalyzedDocs(
        hashes=(
            np.concatenate(all_hashes)
            if all_hashes
            else np.zeros(0, np.uint64)
        ),
        tfs=np.concatenate(all_tfs) if all_tfs else np.zeros(0, np.int32),
        doc_ptr=np.array(ptr, dtype=np.int64),
        dl=np.array(dls, dtype=np.int32),
    )


def analyze_texts_fast(texts, config: IndexConfig) -> AnalyzedDocs:
    """analyze_texts with the native C analyzer on the hot path.

    ASCII docs run through native/analyzer.cpp (bit-identical contract for
    the default AnalyzerConfig); non-ASCII docs fall back to the Python
    tokenizer per doc (unicode lowering like 'K'->'k' must match exactly).
    Per-doc (hash, tf) assembly is one vectorized lexsort instead of a
    Python loop. Output equals analyze_texts exactly (tested)."""
    from ..analyze import native

    texts = list(texts)
    if not native.available() or not native.config_supported(config.analyzer):
        return analyze_texts(texts, config)
    n = len(texts)
    # ONE C-speed pass over the concatenated bytes: the per-string
    # genexpr cost ~3.2 ms of a 14 ms 8192-query analysis (profiled)
    ascii_all = ("".join(texts)).isascii() if texts else True
    if ascii_all:
        hashes, tfs, doc_ptr, dl = native.analyze_batch_ascii(
            texts, config.analyzer
        )
        return AnalyzedDocs(
            hashes=hashes, tfs=tfs, doc_ptr=doc_ptr, dl=dl.astype(np.int32)
        )
    # mixed: native for the ASCII docs, Python reference for the rest
    # (unicode lowering like 'K'->'k' must match str.lower() exactly),
    # reassembled in original doc order.
    ascii_ids = [i for i, t in enumerate(texts) if t.isascii()]
    h_a, tf_a, ptr_a, dl_a = native.analyze_batch_ascii(
        [texts[i] for i in ascii_ids], config.analyzer
    )
    pos_of = {g: i for i, g in enumerate(ascii_ids)}
    tokenizer = Tokenizer(config.analyzer)
    hasher = TermHasher()
    parts_h, parts_tf, ptr, dls = [], [], [0], []
    for g in range(n):
        if g in pos_of:
            i = pos_of[g]
            s, e = ptr_a[i], ptr_a[i + 1]
            parts_h.append(h_a[s:e])
            parts_tf.append(tf_a[s:e])
            ptr.append(ptr[-1] + (e - s))
            dls.append(int(dl_a[i]))
        else:
            toks = tokenizer(texts[g])
            hh = hasher.hash_tokens(toks)
            uh, tf = np.unique(hh, return_counts=True)
            parts_h.append(uh)
            parts_tf.append(tf.astype(np.int32))
            ptr.append(ptr[-1] + len(uh))
            dls.append(len(toks))
    return AnalyzedDocs(
        hashes=(
            np.concatenate(parts_h) if parts_h else np.zeros(0, np.uint64)
        ),
        tfs=(
            np.concatenate(parts_tf) if parts_tf else np.zeros(0, np.int32)
        ),
        doc_ptr=np.array(ptr, dtype=np.int64),
        dl=np.array(dls, dtype=np.int32),
    )


def segment_vocab(analyzed: AnalyzedDocs):
    """(vocab uint64 sorted, rows int32 per posting, df int32 per term).

    The hash-table unique (analyze/native.unique_inverse) replaces
    numpy's argsort-based np.unique(return_inverse) on the build hot
    path — O(n) hash passes instead of O(n log n) over the postings
    hashes (~30% of 60k-doc host build time profiled). Identical output
    (tested): same sorted vocab, same rows."""
    from ..analyze import native

    if len(analyzed.hashes) >= 65536 and native.hash_lookup_available():
        vocab, rows, df = native.unique_inverse(
            analyzed.hashes, counts=True
        )
    else:
        vocab, rows64 = np.unique(analyzed.hashes, return_inverse=True)
        rows = rows64.astype(np.int32)
        df = np.bincount(rows, minlength=len(vocab)).astype(np.int32)
    return vocab, rows, df


def host_pack(rows, docs, tfs, n_terms, n_docs):
    """numpy CSR pack: sort triples by (row, doc), build indptr/df/dl."""
    order = np.lexsort((docs, rows))
    r, d, t = rows[order], docs[order], tfs[order]
    indptr = np.searchsorted(r, np.arange(n_terms + 1)).astype(np.int32)
    return r, d.astype(np.int32), t.astype(np.int32), indptr


@partial(jax.jit, static_argnames=("n_terms", "n_docs"))
def device_pack(rows, docs, tfs, n_terms: int, n_docs: int):
    """jit CSR pack: lax.sort by (row, doc) + searchsorted indptr.

    Same output as host_pack; this is the path that scales with chips —
    triples are device-resident and never round-trip to host.
    """
    r, d, t = jax.lax.sort((rows, docs, tfs), num_keys=2)
    indptr = jnp.searchsorted(r, jnp.arange(n_terms + 1)).astype(jnp.int32)
    df = jnp.zeros(n_terms, jnp.int32).at[r].add(1)
    dl = jnp.zeros(n_docs, jnp.int32).at[d].add(t)
    return r, d, t, indptr, df, dl


def exact_div(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Correctly-rounded f32 division for backends whose hardware divide
    is not IEEE-exact. XLA's f32 divide on the GPU differs from numpy's
    rne(a/b) by 1 ulp on about a quarter of structured bm25 quotients
    (PERF.md), which would break the bm25 bit-parity gate of the
    on-device value materialization.

    One residual-correction step: r = a - b*q0 computed exactly via a
    Veltkamp split / Dekker two-product (12-bit halves multiply exactly
    in f32), then q = q0 + r/b rounds to the true quotient. Verified
    against numpy over millions of structured samples on the GPU
    (chip_smoke.py check_exact_div) and a no-op where division is already
    exact (q0 right => r ~ 0)."""
    q0 = a / b
    c = jnp.float32(4097.0)  # Veltkamp split point (2^12 + 1)

    def split(x):
        t = x * c
        hi = t - (t - x)
        return hi, x - hi

    bh, bl = split(b)
    qh, ql = split(q0)
    p = b * q0
    e = ((bh * qh - p) + bh * ql + bl * qh) + bl * ql
    r = (a - p) - e
    return q0 + r / b


@partial(jax.jit, static_argnames=("kind",))
def device_materialize_vals(
    post_doc: jnp.ndarray,  # (X, 128) i32 — sentinel n_docs in padding
    post_tf: jnp.ndarray,  # (X, 128) i32 — 0 in padding
    k_doc: jnp.ndarray,  # (d_pad,) f32 — bm25 per-doc K(dl) = c0 + c1*dl,
    #                      computed ON HOST in spec order (see below)
    inv_norm: jnp.ndarray,  # (d_pad,) f32 (tfidf; ignored for bm25)
    alive: jnp.ndarray,  # (d_pad,) bool
    k1p1: jnp.ndarray,  # f32 scalar — bm25 numerator factor (k1 + 1)
    kind: str,
):
    """jit re-materialization of the bitcast-f32 posting value plane from
    device-resident inputs — the O(delta) refresh path: after df/N/avgdl
    change, only the small per-doc arrays (k_doc/inv_norm/alive) move
    host->device; the O(nnz) postings never do.

    Bit-parity note: K(dl) = c0 + c1*dl is deliberately computed on HOST
    (numpy, exactly-rounded f32 mul then add). XLA compiles with excess
    precision allowed and contracts an on-device c0 + c1*dl into an FMA
    (even across jax.lax.optimization_barrier — the contraction happens
    in the backend below HLO), drifting 1 ulp off oracle/spec.py's
    val_bm25 and breaking the bit-parity gate. The remaining device ops
    (gather, add, mul, div) have no mul->add pair to contract and are
    exactly rounded — tested equal in tests/test_build.py.
    """
    tff = post_tf.astype(jnp.float32)
    if kind == "tfidf":
        val = tff * inv_norm[post_doc]
    else:  # bm25: val = (tf*(k1+1)) / (tf + K[doc]), exactly rounded
        val = exact_div(tff * k1p1, tff + k_doc[post_doc])
    # explicit select, not `val * alive`: padding postings (tf=0,
    # k_doc=0) make exact_div produce 0/0=NaN, and NaN*0 is NaN — the
    # stored padding bits must be +0.0 regardless of backend
    # simplifications (round-2 ADVICE.md)
    val = jnp.where(alive[post_doc], val, jnp.float32(0.0))
    return jax.lax.bitcast_convert_type(val, jnp.int32)


@partial(jax.jit, static_argnames=("x_rows", "n_docs"))
def device_align_planes(
    r: jnp.ndarray,  # (nnz,) sorted term rows
    d: jnp.ndarray,  # (nnz,) doc ids (sorted within rows)
    t: jnp.ndarray,  # (nnz,) tfs
    indptr: jnp.ndarray,  # (T+1,) true cumulative lengths
    row_start: jnp.ndarray,  # (T,) aligned flat starts
    x_rows: int,
    n_docs: int,
):
    """jit scatter of sorted postings into the aligned (X, 128) doc/tf
    planes (device-build path; the value plane follows from
    device_materialize_vals)."""
    from .csr import LANES

    nnz = d.shape[0]
    i = jnp.arange(nnz, dtype=jnp.int32)
    pos = row_start[r] + (i - indptr[r])
    doc2 = jnp.full(x_rows * LANES, n_docs, jnp.int32).at[pos].set(d)
    tf2 = jnp.zeros(x_rows * LANES, jnp.int32).at[pos].set(t)
    return doc2.reshape(x_rows, LANES), tf2.reshape(x_rows, LANES)


# Doc-range split quantiles (ops/schedule.py split_heavy_queries): each
# term row's postings are doc-ascending, so a (T, P+1) table of "count
# of postings with doc < j*n_docs/P" lets the planner cut any row into
# P doc-disjoint ranges with exact lengths. P=8 bounds the table at
# T x 9 int32 and gives heavy queries up to 8-way splits.
SPLIT_QUANTILES = 8


def quantile_doc_bounds(p: int, n_docs: int) -> np.ndarray:
    """(p+1,) int64 doc thresholds D_j = floor(j * n_docs / p); piece j
    covers docs [D_j, D_{j+1})."""
    return (np.arange(p + 1, dtype=np.int64) * n_docs) // p


def host_row_doc_quantiles(
    indptr: np.ndarray,  # (T+1,) true cumulative lengths
    post_doc: np.ndarray,  # (nnz,) packed postings, doc-ascending per row
    p: int,
    n_docs: int,
) -> np.ndarray:
    """(T, p+1) int32: offs[t, j] = count of row t's postings with
    doc < D_j (quantile_doc_bounds); offs[:, 0] = 0, offs[:, p] = row
    length. Vectorized: one cumsum of (doc < D) per interior threshold."""
    t_n = len(indptr) - 1
    offs = np.zeros((t_n, p + 1), np.int32)
    if t_n == 0:
        return offs
    bounds = quantile_doc_bounds(p, n_docs)
    lens = (indptr[1:] - indptr[:-1]).astype(np.int64)
    for j in range(1, p):
        cum = np.zeros(len(post_doc) + 1, np.int64)
        np.cumsum(post_doc < bounds[j], out=cum[1:])
        offs[:, j] = (cum[indptr[1:]] - cum[indptr[:-1]]).astype(np.int32)
    offs[:, p] = lens.astype(np.int32)
    return offs


@partial(jax.jit, static_argnames=("p", "n_docs"))
def device_row_doc_quantiles(
    post_doc2: jnp.ndarray,  # (X, 128) aligned doc plane
    indptr: jnp.ndarray,  # (T+1,) i32 true cumulative lengths
    row_start: jnp.ndarray,  # (T,) i32 aligned flat record starts
    p: int,
    n_docs: int,
):
    """Device twin of host_row_doc_quantiles over the ALIGNED plane (the
    device-built path keeps no host postings): per (row, threshold) a
    branch-free binary search on the row's doc-ascending records.
    Sentinel padding (doc = n_docs) sorts past every threshold, so reads
    past a short row's end are harmless. Bit-identical to the host twin
    (tested)."""
    bounds = jnp.asarray(
        quantile_doc_bounds(p, n_docs)[1:p].astype(np.int32)
    )  # (p-1,) interior thresholds
    return device_row_doc_quantiles_b(
        post_doc2, indptr, row_start, bounds
    )


def device_row_doc_quantiles_b(
    post_doc2: jnp.ndarray,  # (X, 128) aligned doc plane
    indptr: jnp.ndarray,  # (T+1,) i32 true cumulative lengths
    row_start: jnp.ndarray,  # (T,) i32 aligned flat record starts
    bounds: jnp.ndarray,  # (p-1,) i32 INTERIOR thresholds (traced — the
    #                       sharded path's per-shard local doc counts)
):
    """device_row_doc_quantiles with traced thresholds; jit-safe inside
    shard_map (each shard searches against its own local-doc bounds)."""
    flat = post_doc2.reshape(-1)
    lens = indptr[1:] - indptr[:-1]

    def search(start, length, d_thr):
        def body(_, lh):
            lo, hi = lh
            mid = (lo + hi) // 2
            v = flat[start + mid]
            right = v < d_thr
            return jnp.where(right, mid + 1, lo), jnp.where(right, hi, mid)

        # lo starts as 0*length (not a literal 0) so the carry shares
        # length's varying-manual-axes type under shard_map
        lo, _hi = jax.lax.fori_loop(
            0, 32, body, (jnp.zeros_like(length), length)
        )
        # zero-length rows: lo==hi==0 from the start, so the probe reads
        # a NEIGHBOR row's record and can push lo to 1 — clamp to the
        # row length (global-row tables in the sharded engine carry a
        # zero-length row for every term a shard lacks)
        return jnp.minimum(lo, length)

    inner = jax.vmap(search, in_axes=(None, None, 0))
    mids = jax.vmap(inner, in_axes=(0, 0, None))(
        row_start, lens, bounds
    )  # (T, p-1)
    t_n = row_start.shape[0]
    return jnp.concatenate(
        [
            jnp.zeros((t_n, 1), jnp.int32),
            mids.astype(jnp.int32),
            lens.reshape(t_n, 1).astype(jnp.int32),
        ],
        axis=1,
    )


def aligned_geometry(indptr: np.ndarray, pad_to: int):
    """(row_start (T,) i64, X): 128-aligned flat start offset per term
    row in the (X, 128) posting planes, and the plane row count (includes
    the NNZ_SLICE_MARGIN tail, rounded to pad_to records)."""
    from .csr import LANES

    lens = np.diff(indptr).astype(np.int64)
    al_lens = -(-lens // LANES) * LANES
    row_start = np.zeros(len(lens), np.int64)
    np.cumsum(al_lens[:-1], out=row_start[1:])
    total = int(al_lens.sum())
    records = max(
        round_up(total + NNZ_SLICE_MARGIN, max(pad_to, LANES)), LANES
    )
    return row_start, records // LANES


def _aligned_positions(indptr: np.ndarray, row_start: np.ndarray):
    """(nnz,) flat aligned position of each posting (host)."""
    lens = np.diff(indptr).astype(np.int64)
    off = np.arange(int(indptr[-1]), dtype=np.int64) - np.repeat(
        indptr[:-1].astype(np.int64), lens
    )
    return np.repeat(row_start, lens) + off


def _host_planes(
    post_doc: np.ndarray,
    vals: np.ndarray,
    post_tf: np.ndarray,
    indptr: np.ndarray,
    row_start: np.ndarray,
    x_rows: int,
    n_docs: int,
):
    """Host assembly of the aligned (X, 128) doc/val/tf planes."""
    from .csr import LANES

    pos = _aligned_positions(indptr, row_start)
    d = np.full(x_rows * LANES, n_docs, np.int32)
    v = np.zeros(x_rows * LANES, np.int32)
    t = np.zeros(x_rows * LANES, np.int32)
    d[pos] = post_doc
    if len(vals):
        v[pos] = np.asarray(vals, np.float32).view(np.int32)
    t[pos] = post_tf
    return (
        d.reshape(x_rows, LANES),
        v.reshape(x_rows, LANES),
        t.reshape(x_rows, LANES),
    )


def host_k_doc(dl: np.ndarray, config: IndexConfig, stats: GlobalStats):
    """(n_docs,) f32 bm25 K(dl) = c0 + c1*dl in spec op order (the same
    f32 values spec.val_bm25 derives per posting)."""
    # no alive docs, or only empty ones (avgdl 0): K is never used —
    # such segments carry no postings, and vals fold to 0 anyway
    if stats.n_alive == 0 or stats.total_len_alive == 0:
        return np.zeros(len(dl), F32)
    avgdl = spec.avgdl_of(stats.total_len_alive, stats.n_alive)
    c0, c1 = spec.bm25_len_coeffs(
        config.scoring.k1, config.scoring.b, avgdl
    )
    return (c0 + c1 * dl.astype(F32)).astype(F32)


def _stats_key(stats: GlobalStats):
    """Cheap fingerprint of the inv-norm inputs (n_alive, vocab, df)."""
    import zlib

    return (
        stats.n_alive,
        len(stats.vocab),
        zlib.crc32(np.ascontiguousarray(stats.df).tobytes()),
        zlib.crc32(np.ascontiguousarray(stats.vocab).tobytes()),
    )


def refresh_inputs(
    host: SegmentHost, config: IndexConfig, stats: GlobalStats
):
    """The small per-doc host arrays a device val refresh needs:
    (k_doc, inv_norm, alive), each (n_docs,) — O(docs) H2D, never
    O(nnz). tfidf inv-norms are memoized per segment on the global-stats
    fingerprint: a refresh with unchanged (n_alive, vocab, df) does zero
    norm work (see doc_inv_norms for why a *partial* recompute is
    impossible under the spec)."""
    kind = config.scoring.kind
    if kind == "tfidf":
        key = _stats_key(stats)
        cached = getattr(host, "_inv_norm_cache", None)
        if cached is not None and cached[0] == key:
            inv_norm = cached[1]
        else:
            analyzed = AnalyzedDocs(
                hashes=host.doc_hashes,
                tfs=host.doc_tfs,
                doc_ptr=host.doc_ptr,
                dl=host.dl,
            )
            inv_norm = doc_inv_norms(analyzed, stats, kind)
            host._inv_norm_cache = (key, inv_norm)
    else:
        inv_norm = np.zeros(host.n_docs, dtype=F32)
    return host_k_doc(host.dl, config, stats), inv_norm, host.alive


def doc_inv_norms(
    analyzed: AnalyzedDocs, stats: GlobalStats, kind: str, chunk: int = 4096
) -> np.ndarray:
    """Per-doc inverse norms for tfidf (spec order: hash-ascending seq f32).

    Fully vectorized: ragged doc weights scatter into a padded (chunk,
    Lmax) matrix in one fancy-index assignment, then spec.seq_sumsq runs
    sequentially across term slots — matching the spec exactly. Trailing
    zero-padding is exact (acc + 0*0 == acc in f32).

    Spec constraint (round-2 VERDICT #6): an O(df-affected-docs)
    incremental refresh is IMPOSSIBLE under this spec — idf = ln(N/df)
    (oracle/spec.py idf_of) couples every term's idf, hence every doc's
    norm, to N = n_alive, and N changes on every add/delete. The levers
    that remain are this vectorization (the per-doc Python loop was the
    real cost) and the same-stats memo in refresh_inputs.
    """
    n = analyzed.n_docs
    out = np.zeros(n, dtype=F32)
    idf_g = spec.idf_of(kind, stats.n_alive, stats.df)
    rows_g = stats.lookup(analyzed.hashes)  # native-accelerated search
    w_all = spec.doc_weights_tfidf(analyzed.tfs, idf_g[rows_g])
    ptr = analyzed.doc_ptr
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        lens = (ptr[c0 + 1 : c1 + 1] - ptr[c0:c1]).astype(np.int64)
        lmax = int(lens.max()) if len(lens) else 0
        mat = np.zeros((c1 - c0, max(lmax, 1)), dtype=F32)
        starts = (ptr[c0:c1] - ptr[c0]).astype(np.int64)
        ridx = np.repeat(np.arange(c1 - c0, dtype=np.int64), lens)
        cidx = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            starts, lens
        )
        mat[ridx, cidx] = w_all[ptr[c0] : ptr[c1]]
        sumsq = spec.seq_sumsq(mat, axis=1)
        out[c0:c1] = spec.inv_norm_from_sumsq(sumsq)
    return out


def materialize_vals(
    post_doc: np.ndarray,
    post_tf: np.ndarray,
    dl: np.ndarray,
    inv_norm: np.ndarray,
    config: IndexConfig,
    stats: GlobalStats,
) -> np.ndarray:
    """Materialized posting impact values (DESIGN.md §4), host f32.

    tfidf: val = tf * inv_norm[doc]      (doc idf lives in A_s)
    bm25:  val = tf*(k1+1)/(tf + c0 + c1*dl[doc])  (the one division)
    """
    sc = config.scoring
    if sc.kind == "tfidf":
        return spec.val_tfidf(post_tf, inv_norm[post_doc])
    avgdl = spec.avgdl_of(stats.total_len_alive, stats.n_alive)
    return spec.val_bm25(post_tf, dl[post_doc].astype(F32), sc.k1, sc.b, avgdl)


def build_segment(
    analyzed: AnalyzedDocs,
    config: IndexConfig,
    doc_base: int = 0,
    stats: GlobalStats | None = None,
    materialize: bool = True,
) -> tuple:
    """Build one (SegmentHost, SegmentDevice) from analyzed docs.

    `stats` defaults to this segment's own vocabulary/df (single-segment
    build). Multi-segment/incremental callers pass merged global stats —
    or pass materialize=False and refresh vals afterwards
    (`refresh_segment_vals`), avoiding a throwaway materialization.
    """
    host = build_host_segment(analyzed, doc_base)
    if stats is None:
        stats = GlobalStats(
            vocab=host.term_hash,
            df=host.df.copy(),
            n_alive=host.n_docs,
            total_len_alive=int(analyzed.dl.sum()),
        )
    device = pack_device_segment(
        host, config, stats, materialize=materialize
    )
    return host, device


def build_host_segment(analyzed: AnalyzedDocs, doc_base: int) -> SegmentHost:
    """Host-side segment assembly: vocab/df + CSR pack, one code path
    shared by the single-process and sharded builders."""
    n_docs = analyzed.n_docs
    vocab, rows, df = segment_vocab(analyzed)
    docs = np.repeat(
        np.arange(n_docs, dtype=np.int32),
        np.diff(analyzed.doc_ptr).astype(np.int64),
    )
    _r, d, t, indptr = host_pack(
        rows, docs, analyzed.tfs, len(vocab), n_docs
    )
    return SegmentHost(
        term_hash=vocab,
        df=df,
        doc_base=doc_base,
        n_docs=n_docs,
        dl=analyzed.dl.copy(),
        alive=np.ones(n_docs, dtype=bool),
        doc_hashes=analyzed.hashes,
        doc_tfs=analyzed.tfs,
        doc_ptr=analyzed.doc_ptr,
        indptr=indptr,
        post_doc=d,
        post_tf=t,
    )


def recompute_alive_df(host: SegmentHost) -> None:
    """Recount host.df over alive docs only (after alive flags change out
    of band, e.g. the sharded add path rebuilding a shard)."""
    doc_of = np.repeat(
        np.arange(host.n_docs, dtype=np.int64),
        np.diff(host.doc_ptr).astype(np.int64),
    )
    mask = host.alive[doc_of]
    rows = lookup_sorted(host.term_hash, host.doc_hashes[mask])
    host.df = np.bincount(
        rows, minlength=host.n_terms
    ).astype(np.int32)


def segment_vals(
    host: SegmentHost, config: IndexConfig, stats: GlobalStats
):
    """(vals, inv_norm) per current host stats/alive flags, spec-exact.
    Tombstoned docs' values fold to 0 (DESIGN.md §4: the scorer needs no
    per-posting alive gather)."""
    kind = config.scoring.kind
    if kind == "tfidf":
        analyzed = AnalyzedDocs(
            hashes=host.doc_hashes,
            tfs=host.doc_tfs,
            doc_ptr=host.doc_ptr,
            dl=host.dl,
        )
        inv_norm = doc_inv_norms(analyzed, stats, kind)
    else:
        inv_norm = np.zeros(host.n_docs, dtype=F32)
    vals = materialize_vals(
        host.post_doc,
        host.post_tf.astype(F32),
        host.dl.astype(F32),
        inv_norm,
        config,
        stats,
    )
    vals = vals * host.alive[host.post_doc].astype(F32)
    return vals, inv_norm


def refresh_segment_vals(
    host: SegmentHost,
    device: SegmentDevice,
    config: IndexConfig,
    stats: GlobalStats,
) -> SegmentDevice:
    """Re-materialize idf/avgdl-dependent device values after df/N change
    (incremental add/delete, DESIGN.md §4). Postings (doc, tf) and CSR
    structure are immutable; only inv_norm/post_val/alive are rebuilt —
    so an incrementally updated index scores identically to a fresh
    rebuild.

    Production path is O(delta) in host<->device traffic: the value
    plane is recomputed ON DEVICE from the resident doc/tf planes
    (device_materialize_vals); only the small per-doc
    alive/inv_norm/K(dl) arrays move.
    """
    d_pad = device.n_docs_pad
    kind = config.scoring.kind
    k_host, inv_norm, alive = refresh_inputs(host, config, stats)
    inv_d = jnp.asarray(_pad(inv_norm, d_pad, 0, np.float32))
    alive_d = jnp.asarray(_pad(alive, d_pad, False, bool))
    k_doc = jnp.asarray(_pad(k_host, d_pad, 0, np.float32))
    post_val = device_materialize_vals(
        device.post_doc,
        device.post_tf,
        k_doc,
        inv_d,
        alive_d,
        jnp.float32(F32(config.scoring.k1 + 1.0)),
        kind=kind,
    )
    return SegmentDevice(
        indptr=device.indptr,
        row_start=device.row_start,
        post_doc=device.post_doc,
        post_val=post_val,
        post_tf=device.post_tf,
        dl=device.dl,
        alive=alive_d,
        inv_norm=inv_d,
    )


def _pad(a, size, fill, dtype):
    out = np.full(size, fill, dtype=dtype)
    out[: len(a)] = a
    return out


def shape_bucket(n: int, granule: int = 256) -> int:
    """Round n up to a jit-stable bucketed size: the next multiple of
    max(granule, 2^(floor(log2 n) - 4)) — ≤ ~6.25% padding, ~16 buckets
    per octave. Streaming/incremental device builds pad their triple,
    vocab and plane shapes to these buckets so similar-sized batches
    reuse ONE compiled program instead of compiling per exact shape
    (each distinct shape is a full XLA program, so a 10-batch
    streaming build would otherwise compile 10x per job)."""
    n = max(int(n), 1)
    step = max(granule, 1 << max(int(np.log2(n)) - 4, 0))
    return ((n + step - 1) // step) * step


def pack_device_segment(
    host: SegmentHost,
    config: IndexConfig,
    stats: GlobalStats,
    materialize: bool = True,
) -> SegmentDevice:
    """Ship a host segment's CSR to the device in the aligned-plane
    layout. With materialize=False the impact values are left zero —
    callers that immediately run refresh_segment_vals (every incremental
    path) skip the double materialization."""
    n_docs = host.n_docs
    d_pad = round_up(n_docs + 1, config.docs_pad_to)
    row_start, x_rows = aligned_geometry(host.indptr, config.nnz_pad_to)
    host.row_start = row_start

    if materialize:
        vals, inv_norm = segment_vals(host, config, stats)
    else:
        vals = np.zeros(0, dtype=F32)
        inv_norm = np.zeros(n_docs, dtype=F32)

    d2, v2, t2 = _host_planes(
        host.post_doc, vals, host.post_tf, host.indptr, row_start,
        x_rows, n_docs,
    )
    return SegmentDevice(
        indptr=jnp.asarray(host.indptr),
        row_start=jnp.asarray(row_start.astype(np.int32)),
        post_doc=jnp.asarray(d2),
        post_val=jnp.asarray(v2),
        post_tf=jnp.asarray(t2),
        dl=jnp.asarray(_pad(host.dl.astype(F32), d_pad, 0, np.float32)),
        alive=jnp.asarray(_pad(host.alive, d_pad, False, bool)),
        inv_norm=jnp.asarray(_pad(inv_norm, d_pad, 0, np.float32)),
    )


def build_segment_device(
    analyzed: AnalyzedDocs,
    config: IndexConfig,
    doc_base: int = 0,
) -> tuple:
    """Device-side segment build (BASELINE.json:5 "Index build ... is
    itself a jit-compiled batch job"): the analyzed (row, doc, tf)
    triples ship to HBM once and the CSR pack — sort by (term row, doc),
    indptr, df, dl — runs under jit (device_pack), followed by on-device
    value materialization. The host keeps only the vocabulary, stats and
    per-doc analyzed terms; the O(nnz) postings never come back
    (SegmentHost.post_doc/post_tf are None). Same data volume shipped as
    the host build (triples vs packed records), no host lexsort.

    Values are materialized for this segment's own stats; multi-segment
    callers run refresh_segment_vals afterwards (device-side, O(delta)).
    Produces bit-identical results to build_segment, and plane/table
    contents whose true prefix is bit-identical (shapes are bucketed —
    see shape_bucket — so streaming and incremental builds reuse one
    compiled program per size bucket instead of one per batch; tested).
    """
    n_docs = analyzed.n_docs
    vocab, rows, df = segment_vocab(analyzed)
    docs = np.repeat(
        np.arange(n_docs, dtype=np.int32),
        np.diff(analyzed.doc_ptr).astype(np.int64),
    )
    d_pad = round_up(n_docs + 1, config.docs_pad_to)
    # jit-stable shape buckets (shape_bucket): triples, vocab and plane
    # rows pad up ≤ ~6.25% so every similar-sized streaming/incremental
    # batch reuses ONE compiled pack/align/materialize program. Padding
    # is sentinel-valued and provably inert: sentinel rows (t_cap) sort
    # last, fall outside indptr's true prefix, and their plane scatters
    # land at OOB positions (dropped by XLA scatter semantics) — the
    # packed prefix is bit-identical to the unbucketed build (tested).
    nnz = len(rows)
    t_cap = shape_bucket(len(vocab) + 1)  # strictly > true vocab: the
    # sentinel row's row_start gather must hit a padded (OOB) slot
    nnz_cap = shape_bucket(max(nnz, 1))
    rows_p = _pad(rows, nnz_cap, t_cap, np.int32)
    docs_p = _pad(docs, nnz_cap, d_pad, np.int32)
    tfs_p = _pad(analyzed.tfs, nnz_cap, 0, np.int32)
    # one H2D of the triples, then everything array-shaped is jit
    r_d, d_d, t_d, indptr_d, _df_d, _dl_d = device_pack(
        jnp.asarray(rows_p),
        jnp.asarray(docs_p),
        jnp.asarray(tfs_p),
        n_terms=t_cap,
        n_docs=d_pad,
    )
    # small D2H: planning needs the true-prefix indptr (indptr[t] for
    # t <= vocab counts only real postings — sentinels sort after)
    indptr = np.asarray(indptr_d)[: len(vocab) + 1]
    row_start, x_rows = aligned_geometry(indptr, config.nnz_pad_to)
    x_cap = shape_bucket(max(x_rows, 1))
    # padded row_start entries point one-past-the-plane so sentinel
    # postings scatter out of bounds (dropped); real rows unaffected
    row_start_d = jnp.asarray(
        _pad(row_start, t_cap, x_cap * 128, np.int64).astype(np.int32)
    )
    doc2, tf2 = device_align_planes(
        r_d, d_d, t_d, indptr_d, row_start_d, x_rows=x_cap,
        n_docs=n_docs,
    )
    host = SegmentHost(
        term_hash=vocab,
        df=df,
        doc_base=doc_base,
        n_docs=n_docs,
        dl=analyzed.dl.copy(),
        alive=np.ones(n_docs, dtype=bool),
        doc_hashes=analyzed.hashes,
        doc_tfs=analyzed.tfs,
        doc_ptr=analyzed.doc_ptr,
        indptr=indptr,
        row_start=row_start,
        post_doc=None,
        post_tf=None,
    )
    stats = GlobalStats(
        vocab=vocab,
        df=df.copy(),
        n_alive=n_docs,
        total_len_alive=int(analyzed.dl.sum()),
    )
    kind = config.scoring.kind
    if kind == "tfidf":
        inv_norm = doc_inv_norms(analyzed, stats, kind)
    else:
        inv_norm = np.zeros(n_docs, dtype=F32)
    inv_d = jnp.asarray(_pad(inv_norm, d_pad, 0, np.float32))
    alive_d = jnp.asarray(_pad(host.alive, d_pad, False, bool))
    dl_dev = jnp.asarray(_pad(host.dl.astype(F32), d_pad, 0, np.float32))
    k_doc = jnp.asarray(
        _pad(host_k_doc(host.dl, config, stats), d_pad, 0, np.float32)
    )
    val2 = device_materialize_vals(
        doc2,
        tf2,
        k_doc,
        inv_d,
        alive_d,
        jnp.float32(F32(config.scoring.k1 + 1.0)),
        kind=kind,
    )
    device = SegmentDevice(
        indptr=indptr_d,
        row_start=row_start_d,
        post_doc=doc2,
        post_val=val2,
        post_tf=tf2,
        dl=dl_dev,
        alive=alive_d,
        inv_norm=inv_d,
    )
    return host, device
