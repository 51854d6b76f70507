"""CSR index segment structures (DESIGN.md §4).

"postings lists compile into a document-sharded CSR term–document matrix in
HBM" (BASELINE.json:5): each segment is a CSR matrix with rows = terms of
the segment vocabulary (sorted uint64 hashes, host-resident) and columns =
local doc ids. Device arrays are jax arrays (sharded over the `docs` mesh
axis in the multi-chip path); host metadata stays in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


# Records per plane row: postings live in (X, LANES) int32 planes and
# every term row starts at a LANES-aligned flat offset (SegmentDevice).
LANES = 128

# Builders pad the posting planes to aligned_nnz + NNZ_SLICE_MARGIN so
# block-aligned reads (ops/packed.py dynamic slices, the CUDA kernel of
# ops/fused_cuda.py) can cover whole blocks past a row's end without
# clamping. Any packing block size must be <= this margin — asserted at
# the plan and scorer entry points.
NNZ_SLICE_MARGIN = 4096


def lookup_sorted(haystack: np.ndarray, values: np.ndarray) -> np.ndarray:
    """np.searchsorted(haystack, values), but the needles are visited in
    sorted order — identical results, ~4x faster on large CACHE-COLD
    vocabularies (adjacent needles share binary-search leaf cache lines;
    duplicate needles — e.g. the empty-slot hash 0 — become free). Below
    the crossover the haystack is cache-resident and the needle argsort
    only adds overhead (measured: a 200k-term vocab lookup is ~2 ms
    plain but ~10 ms sorted; a 1.6M-term one is ~25 ms plain, ~8 ms
    sorted), so small lookups short-circuit."""
    flat = np.ascontiguousarray(values).reshape(-1)
    if len(haystack) < 500_000 or len(flat) < 4096:
        return np.searchsorted(haystack, values)
    order = np.argsort(flat, kind="stable")
    idx = np.empty(flat.shape[0], np.int64)
    idx[order] = np.searchsorted(haystack, flat[order])
    return idx.reshape(values.shape)


def ragged_positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat positions of a batch of ragged ranges: concat of
    [starts[i], starts[i]+lens[i]) for every i — one vectorized repeat
    instead of a per-range Python loop (the delete-path hot helper)."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return np.repeat(starts.astype(np.int64), lens) + off


@dataclass
class SegmentHost:
    """Host-resident segment metadata."""

    term_hash: np.ndarray  # (T,) uint64 sorted — segment vocabulary
    df: np.ndarray  # (T,) int32 — segment-local df over alive docs
    doc_base: int  # global doc id of local doc 0
    n_docs: int  # docs in segment (unpadded; includes tombstoned)
    dl: np.ndarray  # (n_docs,) int32 doc lengths
    alive: np.ndarray  # (n_docs,) bool
    # per-doc analyzed terms, needed for exact df updates on delete and
    # for inv_norm refresh: (concat sorted hashes, concat tfs, ptr)
    doc_hashes: np.ndarray = field(repr=False, default=None)
    doc_tfs: np.ndarray = field(repr=False, default=None)
    doc_ptr: np.ndarray = field(repr=False, default=None)
    # host copies of the CSR arrays: indptr for static capacity sizing,
    # row_start (128-aligned flat offset of each term row in the device
    # planes) for query planning, post_doc/post_tf so host-path value
    # materialization never re-sorts (None for device-built segments)
    indptr: np.ndarray = field(repr=False, default=None)
    row_start: np.ndarray = field(repr=False, default=None)
    post_doc: np.ndarray = field(repr=False, default=None)
    post_tf: np.ndarray = field(repr=False, default=None)

    @property
    def n_terms(self) -> int:
        return len(self.term_hash)

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def total_len_alive(self) -> int:
        return int(self.dl[self.alive].sum())


@dataclass
class SegmentDevice:
    """Device-resident CSR arrays (HBM). Padded to static shapes for jit.

    Postings are sorted by (term row, local doc id) and stored as
    128-record-ALIGNED (X, 128) int32 planes: each term row starts at a
    128-aligned flat offset (`row_start`, flat index = r*128 + l), with
    sentinel-doc/zero-val padding between rows and a NNZ_SLICE_MARGIN
    tail. Plan tables address the planes in whole 128-record rows
    (ops/plan.py); padding entries carry sentinel doc + val 0, so reads
    past a row's end are inert.
    """

    indptr: jnp.ndarray  # (T+1,) int32 — TRUE cumulative row lengths
    row_start: jnp.ndarray  # (T,) int32 — aligned flat start per row
    post_doc: jnp.ndarray  # (X, 128) int32 — doc ids, sentinel padding
    post_val: jnp.ndarray  # (X, 128) int32 — bitcast f32 impact vals
    # raw term frequencies in the same geometry: lets the O(delta)
    # refresh re-materialize vals ON DEVICE after df/N/avgdl change —
    # the O(nnz) postings never round-trip to host
    # (builder.device_materialize_vals)
    post_tf: jnp.ndarray  # (X, 128) int32
    dl: jnp.ndarray  # (D_pad,) float32
    alive: jnp.ndarray  # (D_pad,) bool
    inv_norm: jnp.ndarray  # (D_pad,) float32 (tfidf; zeros for bm25)

    @property
    def n_docs_pad(self) -> int:
        return int(self.alive.shape[0])


@dataclass
class GlobalStats:
    """Corpus-global term statistics (merged over segments and shards).

    df must be corpus-global for idf (SURVEY.md §3b); merged on host from
    per-segment vocabularies (hash-space distributed reduce at extreme
    scale — out of scope, SURVEY.md §5).
    """

    vocab: np.ndarray  # (Tg,) uint64 sorted
    df: np.ndarray  # (Tg,) int32 — alive-doc df
    n_alive: int
    total_len_alive: int

    def lookup(self, hashes: np.ndarray) -> np.ndarray:
        """np.searchsorted(self.vocab, hashes) — the query-serving hot
        lookup. Uses the native prefix-table binary search when the
        analyzer library is built (~10x over numpy at production vocab
        sizes; stats objects are recreated on every refresh, so the
        per-instance prefix table can never go stale). Identical
        results to numpy's searchsorted (tested)."""
        from ..analyze import native

        n = len(self.vocab)
        if n < 4096 or len(hashes) < 512 or not native.lookup_available():
            return lookup_sorted(self.vocab, hashes)
        vocab_c, starts, bits = self.prefix_table()
        flat = np.ascontiguousarray(hashes).reshape(-1)
        out = native.lookup_sorted_prefixed(vocab_c, starts, bits, flat)
        return out.reshape(np.shape(hashes))

    def prefix_table(self):
        """(contiguous vocab, prefix_start, bits) for the native
        binary-search kernels; built once per stats object (stats are
        recreated on every refresh, so the cache can never go stale)."""
        tbl = getattr(self, "_prefix_tbl", None)
        if tbl is None:
            n = len(self.vocab)
            bits = max(10, min(18, int(np.ceil(np.log2(max(n, 2))))))
            bounds = np.arange(1 << bits, dtype=np.uint64) << (64 - bits)
            starts = np.empty((1 << bits) + 1, np.int64)
            starts[:-1] = np.searchsorted(self.vocab, bounds)
            starts[-1] = n
            vocab_c = np.ascontiguousarray(self.vocab, dtype=np.uint64)
            tbl = (vocab_c, starts, bits)
            object.__setattr__(self, "_prefix_tbl", tbl)
        return tbl

    def hash_table(self, kind: str):
        """(table, log2n) flat open-addressing vocab table holding
        (hash, row, idf-of-kind) in one 16-byte entry per term
        (native.hash_build) — the serving frontend's one-miss-per-token
        lookup. Cached per stats object per kind (stats are recreated
        on every refresh, so the cache can never go stale)."""
        from ..analyze import native

        cache = getattr(self, "_hash_tbl", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_hash_tbl", cache)
        t = cache.get(kind)
        if t is None:
            t = cache[kind] = native.hash_build(
                self.vocab, self.idf_by_row(kind)
            )
        return t

    def idf_by_row(self, kind: str) -> np.ndarray:
        """f32 idf per vocab row — spec.idf_of over the full df array,
        precomputed in NUMPY (np.log's f32 SIMD need not match libm
        logf bit-for-bit, so the native frontend only gathers from this
        table) and cached per stats object."""
        from ..oracle import spec

        cache = getattr(self, "_idf_by_row", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_idf_by_row", cache)
        t = cache.get(kind)
        if t is None:
            t = cache[kind] = np.ascontiguousarray(
                spec.idf_of(kind, self.n_alive, self.df)
            )
        return t

    def df_of(self, hashes: np.ndarray) -> np.ndarray:
        """df per query hash; 0 for unknown terms."""
        if len(self.vocab) == 0:
            return np.zeros(len(hashes), dtype=np.int32)
        idx = self.lookup(hashes)
        idx_c = np.minimum(idx, max(len(self.vocab) - 1, 0))
        found = self.vocab[idx_c] == hashes
        return np.where(found, self.df[idx_c], 0).astype(np.int32)


def merge_stats(segments) -> GlobalStats:
    """Merge per-segment vocab/df into corpus-global stats (host)."""
    vocabs = [s.term_hash for s in segments]
    if not vocabs:
        return GlobalStats(
            np.zeros(0, np.uint64), np.zeros(0, np.int32), 0, 0
        )
    allv = np.concatenate(vocabs)
    alld = np.concatenate([s.df for s in segments]).astype(np.int64)
    from ..analyze import native

    if len(allv) >= 65536 and native.hash_lookup_available():
        vocab, inv = native.unique_inverse(allv)  # == np.unique (tested)
    else:
        vocab, inv = np.unique(allv, return_inverse=True)
    # weighted bincount beats np.add.at ~10x; f64 weights are exact for
    # df magnitudes (integers < 2^53)
    df = np.bincount(
        inv, weights=alld.astype(np.float64), minlength=len(vocab)
    ).astype(np.int64)
    return GlobalStats(
        vocab=vocab,
        df=df.astype(np.int32),
        n_alive=sum(s.n_alive for s in segments),
        total_len_alive=sum(s.total_len_alive for s in segments),
    )
